"""Wall-clock simulation: per-client work-item durations drive the async
rounds' arrival masks (counterpart of `repro/core/clock.py`, its
event-driven ticks).

Every client holds an in-flight work item finishing at simulated time
``busy_until[i]``. Each round the server wakes at the earliest finish,
``now' = max(now, min_i busy_until)``, so at least one client arrives;
the arrival mask is ``busy_until <= now'``; arrivals start a new item,
``busy_until[i] = now' + d_i``. ``now'`` is the round's ``sim_time``.
The state starts at ``busy_until = now = 0``, so round 0 syncs everyone.

The ticks run on the host in float32 CPU tensors, as the engine draws its
participation masks: a clock's state never depends on a round's output,
so the engine draws a chunk's masks and times before its replay. For the
constant and trace clocks `max`, `min`, `<=`, `where` and `+` are exact
IEEE float32 operations, so masks and times are the reference's device
ticks bit for bit. `LognormalClock` draws its jitter from the
reference's threefry key chain (`core/prng.py`): the same normal draws
up to a few ulps of `log1p`, so the same arrivals on the tested seeds
(tests/test_torch_wallclock.py states the tolerance on the durations).
`tick` never changes its argument, so the engine can put back the state
of any round (the eq. (35) stop).

The byte-accurate clock (`bandwidth_bps`): the engine installs the
codec's exact per-client wire size (`with_wire`, `core/compress.py`),
and a work item pays ``(compute + comm_s) + (bytes_up + bytes_down) /
bandwidth_bps``, the reference's float32 operations in its order, so
the durations are its own bit for bit. Without `bandwidth_bps` no byte
term is ever made, and the times are those of the plain clock. The
deadline clock (`deadline_s`) cuts each round `deadline_s` simulated
seconds after the last, whoever has finished: a round may see no
arrival, which the engine's quorum turns into a recorded no-op.

The overlapped rounds' pricing (`with_overlap`, which the engine
installs under `run_rounds(overlap="scatter")`): a work item pays
``max(compute, comm)`` instead of ``compute + comm``, the wire hidden
behind the local compute between the split collective's two halves.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import copy

import numpy as np
import torch

from repro_torch.core import prng

# (mask, sim_time_now, advanced clock state), what `tick` returns
TickResult = Tuple[torch.Tensor, torch.Tensor, Any]

def _per_client(x, m: int, name: str) -> torch.Tensor:
    """Broadcast a scalar or validate an (m,) array of per-client seconds,
    as float32 on the CPU."""
    arr = torch.as_tensor(np.asarray(x, np.float32))
    if arr.dim() == 0:
        arr = torch.full((m,), float(arr), dtype=torch.float32)
    if tuple(arr.shape) != (m,):
        raise ValueError(f"{name} must be scalar or (m={m},), got "
                         f"{tuple(arr.shape)}")
    return arr


class ComputeClock:
    """Constant per-client durations: ``compute_s + comm_s`` seconds a
    work item (each strictly positive: a zero-duration client would arrive
    every round without advancing simulated time), plus the wire's byte
    time under ``bandwidth_bps`` (scalar or per-client bytes a second)."""

    name = "constant"

    def __init__(self, m: int, compute_s=1.0, comm_s=0.0,
                 bandwidth_bps=None, deadline_s=None):
        if m < 1:
            raise ValueError("need at least one client")
        if deadline_s is not None and not float(deadline_s) > 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.m = m
        self.compute_s = _per_client(compute_s, m, "compute_s")
        self.comm_s = _per_client(comm_s, m, "comm_s")
        total = self.compute_s + self.comm_s
        if not bool((total > 0).all()):
            raise ValueError(f"work-item durations must be > 0, got "
                             f"{total.tolist()}")
        self.bandwidth_bps = None
        if bandwidth_bps is not None:
            self.bandwidth_bps = _per_client(bandwidth_bps, m,
                                             "bandwidth_bps")
            if not bool((self.bandwidth_bps > 0).all()):
                raise ValueError(
                    f"bandwidth_bps must be > 0, got {bandwidth_bps}")
        self.bytes_up = 0
        self.bytes_down = 0
        self.overlap = False
        self._recompute_durations()

    def _combine(self, compute: torch.Tensor) -> torch.Tensor:
        """A work item's duration from its compute time: compute, then
        communication, in series, as ``(compute + comm_s) + wire_s``
        (the barrier rounds' association, so their times stay bit for
        bit), or, for overlapped rounds, ``max(compute, comm_s +
        wire_s)``."""
        if self.overlap:
            comm = (self.comm_s if self.wire_s is None
                    else self.comm_s + self.wire_s)
            return torch.maximum(compute, comm)
        d = compute + self.comm_s
        if self.wire_s is not None:
            d = d + self.wire_s
        return d

    def _recompute_durations(self):
        self.wire_s = None  # no byte term without a bandwidth
        if self.bandwidth_bps is not None:
            self.wire_s = (torch.tensor(self.bytes_up + self.bytes_down,
                                        dtype=torch.float32)
                           / self.bandwidth_bps)
        self.durations_s = self._combine(self.compute_s)

    def with_wire(self, bytes_up: int, bytes_down: int) -> "ComputeClock":
        """A copy of this clock whose work items pay the byte time of
        ``bytes_up + bytes_down`` at ``bandwidth_bps``; the engine calls
        it once a run with the codec's wire size, and the caller's clock
        is left as it was."""
        if self.bandwidth_bps is None:
            raise ValueError(
                "with_wire needs bandwidth_bps — construct the clock "
                "with bandwidth_bps= to enable byte-accurate comm time")
        clone = copy.copy(self)
        clone.bytes_up = int(bytes_up)
        clone.bytes_down = int(bytes_down)
        clone._recompute_durations()
        return clone

    def with_overlap(self) -> "ComputeClock":
        """A copy of this clock pricing overlapped rounds: each work item
        pays ``max(compute, comm)`` instead of ``compute + comm``, the
        communication hidden behind the local compute between the split
        collective's two halves. Composes with `with_wire` (the byte time
        folds into the comm term before the max); the caller's clock is
        left as it was."""
        clone = copy.copy(self)
        clone.overlap = True
        clone._recompute_durations()
        return clone

    def init(self) -> Dict[str, Any]:
        """``busy_until = now = 0``: round 0 syncs every client."""
        return {"busy_until": torch.zeros((self.m,), dtype=torch.float32),
                "now": torch.zeros((), dtype=torch.float32)}

    def _draw(self, cstate, round_idx: int):
        """Durations of the work started this round, and the sampler's
        advanced state."""
        return self.durations_s, cstate

    def tick(self, cstate, round_idx: int) -> TickResult:
        """One server event: simulated time advances to the earliest
        client finish (or, under `deadline_s`, by the deadline), the
        arrival mask is who has finished by then, and the arrived clients
        start a new work item. Returns ``(mask, now, cstate')``: the (m,)
        bool mask (at least one True without a deadline), the round's
        simulated time and the next state."""
        busy = cstate["busy_until"]
        if self.deadline_s is None:
            now = torch.maximum(cstate["now"], torch.min(busy))
        else:
            now = cstate["now"] + torch.tensor(self.deadline_s,
                                               dtype=torch.float32)
        mask = busy <= now
        d, cstate = self._draw(cstate, round_idx)
        cs2 = dict(cstate)
        cs2.update(busy_until=torch.where(mask, now + d, busy), now=now)
        return mask, now, cs2


class LognormalClock(ComputeClock):
    """Lognormal compute-time jitter: a work item's compute time is
    ``compute_s[i] * exp(sigma * N(0, 1))`` (median `compute_s`), its
    communication constant. The threefry key (`prng_key(seed)`) rides in
    the clock state and splits once a tick, as the reference's: the
    durations are a function of the seed alone, the same in both
    drivers."""

    name = "lognormal"

    def __init__(self, m: int, compute_s=1.0, comm_s=0.0, sigma: float = 0.5,
                 seed: int = 0, bandwidth_bps=None, deadline_s=None):
        super().__init__(m, compute_s, comm_s, bandwidth_bps,
                         deadline_s=deadline_s)
        if sigma < 0:
            raise ValueError(f"sigma must be >= 0, got {sigma}")
        self.sigma = float(sigma)
        self.seed = seed

    def init(self):
        cs = super().init()
        cs["key"] = prng.prng_key(self.seed)
        return cs

    def _draw(self, cstate, round_idx):
        key, sub = prng.split(cstate["key"])
        z = torch.from_numpy(prng.normal(sub, self.m))
        jitter = torch.exp(self.sigma * z)
        cs2 = dict(cstate)
        cs2["key"] = key
        return self._combine(self.compute_s * jitter), cs2


class TraceClock(ComputeClock):
    """Trace-driven durations: a (T, m) table of per-work-item seconds;
    work started at round t takes row ``t mod T``."""

    name = "trace"

    def __init__(self, m: int, trace, bandwidth_bps=None, deadline_s=None):
        tr = np.asarray(trace, np.float32)
        if tr.ndim != 2 or tr.shape[1] != m:
            raise ValueError(f"trace must be (T, m={m}), got {tr.shape}")
        if not (tr > 0).all():
            raise ValueError("trace durations must be > 0")
        super().__init__(m, compute_s=tr[0], comm_s=0.0,
                         bandwidth_bps=bandwidth_bps, deadline_s=deadline_s)
        self.trace = torch.from_numpy(tr)

    def _draw(self, cstate, round_idx):
        row = self.trace[int(round_idx) % self.trace.shape[0]]
        return self._combine(row), cstate


CLOCKS = ("constant", "lognormal", "trace")


def default_speeds(m: int) -> np.ndarray:
    """Per-client compute seconds cycling 1..4: the wall-clock twin of the
    periodic policy's default periods."""
    return 1.0 + (np.arange(m) % 4).astype(np.float32)


def make_clock(kind: str, m: int, *, compute_s=None, comm_s=0.0,
               sigma: float = 0.5, seed: int = 0, trace=None,
               bandwidth_bps=None,
               deadline_s=None) -> Optional[ComputeClock]:
    """CLI-level factory (`--clock`, `--client-speeds`, `--clock-sigma`,
    `--bandwidth-bps`, `--deadline-s`). ``kind="none"`` returns None: the
    rounds stay policy-driven. ``compute_s`` defaults to
    `default_speeds`."""
    if kind == "none":
        return None
    if compute_s is None:
        compute_s = default_speeds(m)
    if kind == "constant":
        return ComputeClock(m, compute_s, comm_s, bandwidth_bps=bandwidth_bps,
                            deadline_s=deadline_s)
    if kind == "lognormal":
        return LognormalClock(m, compute_s, comm_s, sigma=sigma, seed=seed,
                              bandwidth_bps=bandwidth_bps,
                              deadline_s=deadline_s)
    if kind == "trace":
        if trace is None:
            raise ValueError("trace clock needs a (T, m) duration table")
        return TraceClock(m, trace, bandwidth_bps=bandwidth_bps,
                          deadline_s=deadline_s)
    raise KeyError(f"unknown clock {kind!r}: {CLOCKS} or 'none'")


class ClockArrivals:
    """A clock seen as a participation policy (`init`, `mask`,
    `active_capacity`), so the engine's drivers draw its masks where they
    draw a policy's. The round's simulated time is the new state's
    ``"now"``."""

    name = "clock"

    def __init__(self, clock: ComputeClock):
        self.clock = clock
        self.m = clock.m
        self.active_capacity = clock.m

    def init(self):
        return self.clock.init()

    def mask(self, cstate, round_idx: int):
        mask, _, cs2 = self.clock.tick(cstate, round_idx)
        return mask, cs2

    def wire(self, mask: torch.Tensor):
        """The round's wire totals under a byte-accurate clock, each
        arrival one upload (the codec's wire) and one fp32 download:
        ``{"bytes_up": ..., "bytes_down": ...}`` as float32 (the
        reference's ``n_arrived * float32(bytes)``); empty without a
        bandwidth, so a plain clock's history keeps its keys."""
        if self.clock.bandwidth_bps is None:
            return {}
        n = torch.sum(mask.to(torch.float32))
        return {k: n * torch.tensor(getattr(self.clock, k),
                                    dtype=torch.float32)
                for k in ("bytes_up", "bytes_down")}
