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

Only the event-driven ticks are ported: the byte-accurate clock
(`bandwidth_bps`, `with_wire`), the overlapped round's pricing
(`with_overlap`) and the deadline clock (`deadline_s`) raise
`NotImplementedError`.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

# (mask, sim_time_now, advanced clock state), what `tick` returns
TickResult = Tuple[torch.Tensor, torch.Tensor, Any]

_NOT_PORTED = {
    "bandwidth_bps": "the byte-accurate clock waits for the codecs "
                     "(ROADMAP queue 1, item 6)",
    "deadline_s": "the deadline clock waits for the quorum rounds "
                  "(ROADMAP queue 1, item 6)",
    "with_wire": "the byte-accurate clock waits for the codecs "
                 "(ROADMAP queue 1, item 6)",
    "with_overlap": "the overlapped round's pricing waits for the "
                    "multi-device client axis (ROADMAP queue 1, item 9)",
}


def _not_ported(what: str):
    raise NotImplementedError(f"{what} is not ported: {_NOT_PORTED[what]}")


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
    every round without advancing simulated time)."""

    name = "constant"

    def __init__(self, m: int, compute_s=1.0, comm_s=0.0,
                 bandwidth_bps=None, deadline_s=None):
        if m < 1:
            raise ValueError("need at least one client")
        if bandwidth_bps is not None:
            _not_ported("bandwidth_bps")
        if deadline_s is not None:
            _not_ported("deadline_s")
        self.m = m
        self.compute_s = _per_client(compute_s, m, "compute_s")
        self.comm_s = _per_client(comm_s, m, "comm_s")
        self.durations_s = self._combine(self.compute_s)
        if not bool((self.durations_s > 0).all()):
            raise ValueError(f"work-item durations must be > 0, got "
                             f"{self.durations_s.tolist()}")

    def _combine(self, compute: torch.Tensor) -> torch.Tensor:
        """A work item's duration from its compute time: compute, then
        communication, in series."""
        return compute + self.comm_s

    def with_wire(self, bytes_up: int, bytes_down: int):
        _not_ported("with_wire")

    def with_overlap(self):
        _not_ported("with_overlap")

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
        client finish, the arrival mask is who has finished by then, and
        the arrived clients start a new work item. Returns ``(mask, now,
        cstate')``: the (m,) bool mask (at least one True), the round's
        simulated time and the next state."""
        busy = cstate["busy_until"]
        now = torch.maximum(cstate["now"], torch.min(busy))
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
    """CLI-level factory (`--clock`, `--client-speeds`, `--clock-sigma`).
    ``kind="none"`` returns None: the rounds stay policy-driven.
    ``compute_s`` defaults to `default_speeds`."""
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
