"""Round driver (counterpart of the single-device, flat, dense path of
`repro/core/engine.py::run_rounds`).

The state is raveled ONCE at entry into lane-padded flat buffers
(`flatten_state`) and the dict layout is rebuilt at return
(`unflatten_state`). Two drivers run the rounds, both with the stop rule
of eq. (35): stop after the first round whose metric is < tol, and that
round counts.

* Chunked (`scan=True`, the default; the reference's scan driver). The
  rounds run in chunks on static buffers: where the rounds take a mask
  (a participation policy, or FedGiA's own ADMM/GD split) the host draws
  a chunk's masks before it, and it reads one flag and one round counter
  after it. On a CUDA device each chunk length is captured once, before
  the timed window, as a CUDA graph of that many rounds, and a chunk is
  one replay. With tol > 0 each round of a chunk is the body of a
  conditional graph node (`graphs.skip_if`) that runs only while the
  stop has not held, so the rounds after it launch nothing and leave the
  state as it was (the reference's `lax.cond` freeze). On the CPU the
  same chunk program runs eagerly.
* Legacy (`scan=False`): one Python loop of `algo.round_flat`, which
  reads the stop metric back to the host every round when tol > 0.

Any of the five algorithms runs through either driver. Without a
participation policy the baselines take no mask (the paper's full
participation): neither driver draws for them, and their key is never
split. With a policy (`core/selection.py`), both drivers draw one mask a
round from the policy, from its `init()` state, with the rounds of the
call counted from 0, and pass it to every algorithm: FedGiA's ADMM/GD
split, the baselines' participants. FedGiA's own threefry key splits
every round either way, as the reference's does; without a policy its
second half, folded with the state's round counter, draws the split.

`store` picks where the per-client state lives and how a round touches
it (the reference's `store=`): "dense" runs every round on the (m, N)
client buffers; "active" packs each round down to its participants (a
`utils.pytree.ActiveSet` built from the policy's mask: the ids are
packed on the host beside the mask and uploaded with it, so a captured
round builds the set without a sync), gathers their (capacity, N) tile,
runs `algo.round_flat_active` on it and scatters the per-client state
back, in either driver; "offload" keeps the resident client buffers in
host memory (`_run_offload_loop`). `aggregate="packed"` sums the tile
directly in eq. (11) instead of scattering it back to the dense layout.

Async rounds (`async_rounds=True`, the reference's stale-x̄ engine): the
round's mask is the ARRIVAL process, and each client computes against the
x̄ it last downloaded, at most `max_staleness` rounds old
(`api.StaleXbar`, whose buffers every round updates in place: static
buffers of a captured chunk). `clock=` (`core/clock.py`) derives the
arrival mask from simulated per-client finish times instead of a policy:
the clock ticks on the host where a policy draws, and each round's
simulated time joins the history as `sim_time`. `staleness` ((m,) a
round) and `staleness_max` join it in every async run.

`chunk_size="auto"` tunes the chunk length on the live run, as the
reference does: the first chunks run the lengths of
`AUTO_CHUNK_CANDIDATES` in turn (each clipped to the rounds left), each
is timed, and the fastest per round drives the rest. The rounds executed
do not depend on the timings, so with tol <= 0 the final state is the
fixed-chunk run's, bit for bit.

The uplink (`compression=`, `faults=`, `screening=`): each round's
contribution goes through the codec of `core/compress.py` and the fault
injection and screening of `core/faults.py` before eq. (11), inside the
round, on the device; the engine makes the codec's error-feedback
residual ``ef`` and the replay buffer ``fault_prev`` as (m, N) client
buffers. The stochastic codecs' key is the round's key before its split:
the chunked driver, which keeps the key on the host, computes a chunk's
keys there and uploads them beside its masks.

The guard (`quorum=`, `watchdog=`, the reference's `_make_guard`): after
each round, `torch.where` merges put back the state before the round (a
quorum no-op, ``degraded``) or the watchdog's best snapshot
(``rollback``); the key and the round counter always advance. The merges
read nothing back, so a captured chunk replays them as the legacy loop
runs them.

Checkpoints (`checkpoint_every=`, `checkpoint_dir=`, `resume=`): the
chunked driver cuts its chunks at the checkpoint rounds and saves its
whole carry there (the state, the host key, the policy or clock state,
the stale-x̄ buffers, the watchdog slot, the stop flag and the history
so far) with a fingerprint of the run's configuration; the offload loop
saves its own. A resumed run's history and state are the uninterrupted
run's bit for bit.

`flat=False` (`--no-flat`) runs the per-leaf rounds (`algo.round`) on a
copy of the state's dicts in both drivers, with the policies, async
rounds, the clocks, the stop, the guard and the checkpoints; the client
stores, the codecs, the faults, the screening and `use_kernel=True` need
the flat buffers and are refused, with the reference's messages. On the
CPU the two paths give the same history and state bit for bit; the
per-leaf round launches no kernel.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import checkpoint as ckpt_io
from repro_torch.core import api, compress, graphs, selection
from repro_torch.core.clock import ClockArrivals
from repro_torch.kernels import launch_counters
from repro_torch.utils import pytree as pt
from repro_torch.utils.pytree import ravel_spec


@dataclasses.dataclass
class RoundResult:
    """Outcome of `run_rounds`: final state + stacked per-round metrics."""

    state: Any
    history: Dict[str, np.ndarray]  # each (rounds_run,), trimmed at early stop
    rounds_run: int
    stopped_early: bool
    wall_s: float
    # warm-up and CUDA-graph capture of the chunked driver, kept out of
    # wall_s (the reference compiles its chunks before its timed window)
    capture_s: float = 0.0
    # rounds a chunk of the chunked driver (the fastest candidate under
    # chunk_size="auto"); 0 for the legacy loop
    chunk_size: int = 0
    # host time spent drawing the participation masks, part of wall_s
    draw_s: float = 0.0
    # the participation policy's state after the last round that ran
    # (None without a policy)
    policy_state: Any = None
    # the clock's state after the last round that ran, and the async
    # rounds' stale-x̄ state (None without a clock / async rounds)
    clock_state: Any = None
    stale: Any = None
    # store="offload": host_resident_bytes, device_peak_bytes (None off
    # the card) and copy_s; empty for the dense and active stores
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)


def flatten_state(algo, state, spec):
    """Ravel the state's model-shaped entries: `algo.flat_global_keys` ->
    (N,) vectors, `algo.flat_client_keys` -> one (m, N) buffer each. Each
    ravel allocates a new buffer, so in-place rounds on the result never
    write the tensors of `state`. `spec=None` (the per-leaf rounds)
    copies every tensor instead (`pt.tree_clone`)."""
    if spec is None:
        return pt.tree_clone(state)
    out = dict(state)
    for k in algo.flat_global_keys:
        if k in out:
            out[k] = spec.ravel(out[k])
    for k in algo.flat_client_keys:
        if k in out:
            out[k] = spec.ravel_stacked(out[k])
    return out


def unflatten_state(algo, state, spec):
    """Inverse of `flatten_state`: callers see the dict layout (the
    per-leaf rounds' state, `spec=None`, has it already)."""
    out = dict(state)
    if spec is None:
        return out
    for k in (*algo.flat_global_keys, *algo.flat_client_keys):
        if k in out:
            out[k] = spec.unravel(out[k])
    return out


def _device_of(state) -> torch.device:
    """The device of a state's x̄ (a flat buffer or a dict)."""
    return pt.tree_leaves(state["x"])[0].device


def _stack(values):
    if torch.is_tensor(values[0]):
        return torch.stack(values).cpu().numpy()
    return np.asarray(values, np.float32)


def _concat(saved, history):
    """A resumed run's history: the checkpoint's rows, then this call's."""
    if not saved:
        return history
    if not history:
        return dict(saved)
    return {k: np.concatenate([saved[k], history[k]]) for k in saved}


AUTO_CHUNK_CANDIDATES = (8, 32, 128)


def run_rounds(algo, state, batch, num_rounds: int, *, tol: float = 0.0,
               tol_metric: str = "grad_sq_norm", scan: bool = True,
               chunk_size=0, participation=None, store: str = "dense",
               aggregate: str = "dense", async_rounds: bool = False,
               max_staleness: int = 0, clock=None,
               stale_weighting: str = "uniform",
               stale_decay: float = 1.0, compression=None,
               error_feedback: bool = False, topk_frac: float = 0.1,
               faults=None, screening=None, quorum: int = 0,
               watchdog: bool = False, watchdog_patience: int = 3,
               watchdog_factor: float = 2.0, checkpoint_every: int = 0,
               checkpoint_dir=None, resume: bool = False,
               flat: bool = True) -> RoundResult:
    """Run up to `num_rounds` communication rounds of `algo`.

    tol > 0 enables the paper's stopping rule (eq. 35). `scan=True` runs
    the chunked driver with chunks of `chunk_size` rounds (0: the whole
    run when tol <= 0, else min(num_rounds, 32), as the reference;
    "auto": timed on the live run, see the module docstring);
    `scan=False` the legacy per-round loop. Both give the same state
    (its key too), history, `rounds_run` and policy state.

    `participation`: a `core.selection.ParticipationPolicy` whose mask
    every round takes (None: no mask; FedGiA draws its own split).

    `store`: "dense" (default), "active" or "offload" (see the module
    docstring); the last two need a participation policy or a clock,
    whose `active_capacity` sizes the tile (m under a clock). The states
    are bitwise equal
    between stores, and so are `selected`, `cr` and `local_grad_evals`;
    `f_xbar` and `grad_sq_norm` become PARTICIPANT means (the server never
    contacts the others), except for FedGiA (`active_tile =
    "population"`: its active round is its dense round). "offload" runs
    its own host-driven loop whatever `scan` says, is bitwise "active",
    and fills `RoundResult.extras`. `aggregate`: "dense" (default) or
    "packed" (active and offload only: eq. (11) sums the participant
    tile directly, at fp tolerance).

    `async_rounds`: stale-x̄ rounds (module docstring); they need an
    arrival process, a policy or a clock. `max_staleness=0` is bitwise
    the synchronous masked run. `clock`: a `core.clock.ComputeClock`
    (implies async rounds, excludes a policy, models `algo`'s m
    clients). `stale_weighting` ("uniform", "poly" or "exp", with
    `stale_decay` > 0) turns eq. (11) into the staleness-weighted mean;
    anything but "uniform" needs async rounds.

    `compression` ("none", "bf16", "int8", "topk" or a
    `compress.Compressor`), `error_feedback`, `topk_frac`: the uplink
    codec (module docstring). "none" without error feedback is no codec
    at all, so that run is the uncompressed one bit for bit; a clock with
    `bandwidth_bps` prices the codec's wire (`ComputeClock.with_wire`) and
    the history gains `bytes_up` and `bytes_down`. `faults` (a
    `faults.FaultModel`) and `screening` (a `faults.Screening`) corrupt
    and screen the uploads on the device; the history gains `screened`.

    `quorum`: a round whose accepted uploads (`screened`, else
    `selected`) fall below it is a recorded no-op (`degraded`): every
    state entry but the key and the round counter, and the stale-x̄
    state, go back to the round's start. It needs a source of
    non-arrival, and >= 1 under a deadline clock. `watchdog`: after
    `watchdog_patience` committed rounds in a row with f̄ above
    `watchdog_factor` times the best seen (NaN counts), the state rolls
    back to the best round's (`rollback`); not with store="offload".

    `checkpoint_every`, `checkpoint_dir`, `resume`: the module
    docstring's checkpoints, in the chunked driver (a fixed chunk_size)
    and the offload loop. `resume=True` goes on from the newest
    checkpoint under `checkpoint_dir` (a fresh start where there is
    none) and raises where it was written under another configuration;
    `num_rounds` may differ.

    `flat`: True runs `algo.round_flat` on the state raveled once into
    flat buffers; False the per-leaf `algo.round` on the state's dicts
    (module docstring), which the stores, the codecs, the faults and the
    screening refuse, as does `use_kernel=True`. A checkpoint records
    which: a run resumes only a checkpoint of its own kind.

    The caller's `state` is left as it was: its tensors are copied into
    fresh flat buffers at entry and its key is copied, so every
    round can run the in-place (donated) kernel, as the reference donates
    off the CPU backend; on the CPU the donated plain version writes in
    place too.
    """
    auto = isinstance(chunk_size, str)
    if auto and chunk_size != "auto":
        raise ValueError(
            f"chunk_size must be an int or 'auto', got {chunk_size!r}")
    if auto and not scan:
        raise ValueError("chunk_size='auto' tunes the chunk length — the "
                         "legacy per-round loop (scan=False) has no chunks")
    m = algo.fed.num_clients
    async_rounds = _check_async(m, participation, async_rounds,
                                max_staleness, clock, stale_weighting)
    cap = _check_store(algo, store, aggregate,
                       participation if clock is None else ClockArrivals(
                           clock), auto, flat)
    packed = aggregate == "packed"
    compressor, wire_comp = _check_uplink(
        algo, participation, clock, store, scan, auto, compression,
        error_feedback, topk_frac, faults, screening, quorum, watchdog,
        watchdog_patience, watchdog_factor, checkpoint_every,
        checkpoint_dir, resume)
    _check_flat(algo, flat, compressor, faults, screening)
    spec = ravel_spec(state["x"])
    if clock is not None and clock.bandwidth_bps is not None:
        # the logical model size: the wire never carries the padding
        clock = clock.with_wire(compress.uplink_bytes(wire_comp, spec.size),
                                compress.downlink_bytes(spec.size))
    arrivals = participation if clock is None else ClockArrivals(clock)
    ckpt = None
    if checkpoint_every > 0 or resume:
        ckpt = _Checkpoints(checkpoint_dir, checkpoint_every, resume,
                            _config_fingerprint(
            algo=getattr(algo, "name", type(algo).__name__),
            num_clients=m, tol=tol, tol_metric=tol_metric, flat=bool(flat),
            store=store, aggregate=aggregate, overlap="off",
            async_rounds=bool(async_rounds), max_staleness=max_staleness,
            stale_weighting=stale_weighting, stale_decay=stale_decay,
            participation=participation, clock=clock, compression=wire_comp,
            error_feedback=bool(error_feedback), topk_frac=topk_frac,
            faults=faults, screening=screening, quorum=quorum,
            watchdog=bool(watchdog), watchdog_patience=watchdog_patience,
            watchdog_factor=watchdog_factor))
    if not flat:  # the per-leaf rounds: the drivers' spec is None
        spec = None
    flat = flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    if compressor is not None and compressor.error_feedback \
            and "ef" not in flat:
        flat["ef"] = torch.zeros((m, spec.padded_size), dtype=spec.dtype,
                                 device=_device_of(flat))
    if faults is not None and faults.needs_prev and "fault_prev" not in flat:
        # the replay fault's last honest upload, made like "ef"
        flat["fault_prev"] = torch.zeros((m, spec.padded_size),
                                         dtype=spec.dtype,
                                         device=_device_of(flat))
    uplink = Uplink(compressor, faults, screening,
                    _Guard.make(quorum, watchdog, watchdog_patience,
                                watchdog_factor), ckpt)
    stale = None
    if async_rounds:
        stale = api.init_stale_xbar(flat["x"], m, max_staleness,
                                    stale_weighting, stale_decay,
                                    resident=store != "offload")
    if num_rounds <= 0:
        astate = arrivals.init() if arrivals is not None else None
        return _with_clock(RoundResult(
            unflatten_state(algo, flat, spec), {}, 0, False, 0.0,
            policy_state=astate, stale=stale), clock)
    if store == "offload":
        return _with_clock(_run_offload_loop(
            algo, flat, batch, spec, num_rounds, tol, tol_metric, arrivals,
            cap, packed, stale, uplink), clock)
    if not scan:
        return _with_clock(_run_legacy_loop(
            algo, flat, batch, spec, num_rounds, tol, tol_metric, arrivals,
            cap, packed, stale, uplink), clock)
    plan = []
    if auto:
        rest = num_rounds
        for cand in AUTO_CHUNK_CANDIDATES:
            if rest <= 0:
                break
            plan.append(min(cand, rest))
            rest -= plan[-1]
        lengths = set(plan)
        if tol <= 0 and rest > 0:
            # whichever candidate wins, the rest runs whole chunks of it
            # and one partial chunk
            for cand in set(plan):
                lengths.add(min(cand, rest))
                if rest % cand:
                    lengths.add(rest % cand)
        chunk = plan[0]
    else:
        if chunk_size <= 0:
            chunk_size = num_rounds if tol <= 0 else min(num_rounds, 32)
        chunk = min(chunk_size, num_rounds)
        lengths = {chunk}
        if tol <= 0 and num_rounds % chunk:
            # with tol > 0 a converging run may never reach the remainder:
            # it is captured on use
            lengths.add(num_rounds % chunk)
    return _with_clock(_Chunked(
        algo, flat, batch, spec, tol, tol_metric, max(lengths), arrivals,
        cap, packed, stale, uplink).run(num_rounds, chunk, plan, lengths),
        clock)


def _check_async(m, participation, async_rounds, max_staleness, clock,
                 stale_weighting):
    """The reference's checks of the async and clock arguments, with its
    messages. Returns whether the rounds are async (a clock implies
    it)."""
    if clock is not None:
        if participation is not None:
            raise ValueError(
                "clock= and participation= are mutually exclusive: the "
                "clock DERIVES the arrival mask from simulated finish "
                "times (core/clock.py), a policy samples it")
        if clock.m != m:
            raise ValueError(
                f"clock models {clock.m} clients, algorithm has {m}")
        async_rounds = True  # a clock IS an arrival process
    if stale_weighting not in api.STALE_WEIGHTINGS:
        raise ValueError(
            f"unknown stale_weighting {stale_weighting!r}: "
            f"{api.STALE_WEIGHTINGS}")
    if stale_weighting != "uniform" and not async_rounds:
        raise ValueError(
            "stale_weighting only applies to async rounds — pass "
            "async_rounds=True (with a participation policy) or clock=")
    if async_rounds:
        if participation is None and clock is None:
            raise ValueError(
                "async_rounds requires an arrival process — a participation "
                "policy (e.g. selection.AvailabilityParticipation) or a "
                "clock (core.clock.ComputeClock)")
        if max_staleness < 0:
            raise ValueError(
                f"max_staleness must be >= 0, got {max_staleness}")
    return async_rounds


def _with_clock(res, clock):
    """Under a clock the arrival state the drivers return is the clock's."""
    if clock is not None:
        res.clock_state, res.policy_state = res.policy_state, None
    return res


def _check_store(algo, store, aggregate, participation, auto, flat=True):
    """The reference's checks of `store` and `aggregate`, with its
    messages. `participation` is the round's arrival process (a policy,
    or a clock as `ClockArrivals`). Returns the tile's capacity (None for
    the dense store)."""
    if store not in ("dense", "active", "offload"):
        raise ValueError(
            f"unknown store {store!r}: ('dense', 'active', 'offload')")
    cap = None
    if store in ("active", "offload"):
        if not flat:
            raise ValueError(
                f"store={store!r} packs the flat (m, N) client buffers — it "
                "requires the flat round path (flat=True on an algorithm "
                "providing round_flat; drop --no-flat)")
        if participation is None:
            raise ValueError(
                f"store={store!r} needs a per-round participant set to pack "
                "the tile from — pass participation= (core.selection) or "
                "clock= (core.clock)")
        if not hasattr(algo, "round_flat_active"):
            raise ValueError(
                f"algorithm {getattr(algo, 'name', algo)!r} does not "
                "implement round_flat_active")
        cap = participation.active_capacity
    if store == "offload" and auto:
        raise ValueError(
            "chunk_size='auto' tunes the scan chunk length — the "
            "host-driven offload loop (store='offload') has no chunks")
    if aggregate not in ("dense", "packed"):
        raise ValueError(
            f"unknown aggregate {aggregate!r}: ('dense', 'packed')")
    if aggregate == "packed" and store == "dense":
        raise ValueError(
            "aggregate='packed' sums the packed participant tile — it "
            "requires store='active' or store='offload'")
    return cap


def _check_uplink(algo, participation, clock, store, scan, auto,
                  compression, error_feedback, topk_frac, faults, screening,
                  quorum, watchdog, watchdog_patience, watchdog_factor,
                  checkpoint_every, checkpoint_dir, resume):
    """The reference's checks of the codec, fault, guard and checkpoint
    arguments, with its messages. Returns (the round's compressor, None
    for the identity codec without error feedback; the codec whose wire
    the byte clock prices)."""
    m = algo.fed.num_clients
    masked = participation is not None or clock is not None
    compressor = compress.as_compressor(
        compression, error_feedback=error_feedback, topk_frac=topk_frac)
    wire_comp = compressor
    if compressor is not None and compressor.identity \
            and not compressor.error_feedback:
        # the identity codec without error feedback IS the uncompressed
        # round: no codec runs at all
        compressor = None
    if faults is not None and faults.num_clients != m:
        raise ValueError(
            f"fault model covers {faults.num_clients} clients, algorithm "
            f"has {m}")
    if quorum:
        if not 0 < quorum <= m:
            raise ValueError(f"quorum must be in [0, m={m}], got {quorum}")
        if not masked and faults is None and screening is None:
            raise ValueError(
                "quorum needs a source of non-arrival to guard against — "
                "pass participation=, clock=, faults= or screening=")
    if clock is not None and clock.deadline_s is not None and quorum < 1:
        raise ValueError(
            "a deadline clock (ComputeClock(deadline_s=)) can cut rounds "
            "with ZERO arrivals — pass quorum >= 1 so they degrade to "
            "recorded no-ops instead of a 0-client mean")
    if watchdog:
        if watchdog_patience < 1:
            raise ValueError(
                f"watchdog_patience must be >= 1, got {watchdog_patience}")
        if watchdog_factor <= 1.0:
            raise ValueError(
                "watchdog_factor must be > 1 (a divergence threshold "
                f"RELATIVE to the best f̄ seen), got {watchdog_factor}")
        if store == "offload":
            raise ValueError(
                "the watchdog keeps a full state snapshot in the carry — "
                "under store='offload' that would double the host-resident "
                "buffers; run the watchdog with store='dense'/'active'")
    if checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}")
    if checkpoint_every > 0 or resume:
        if checkpoint_dir is None:
            raise ValueError(
                "checkpoint_every/resume need a checkpoint_dir= to write "
                "to / restore from")
        if auto:
            raise ValueError(
                "chunk_size='auto' picks chunk boundaries from wall-clock "
                "timings — pass a fixed chunk_size when checkpointing so "
                "the save points are deterministic")
        if not scan and store != "offload":
            raise ValueError(
                "checkpointing rides the chunked scan driver (or the "
                "host-driven offload loop) — drop scan=False")
    return compressor, wire_comp


def _check_flat(algo, flat, compressor, faults, screening):
    """The per-leaf rounds' refusals, with the reference's messages: the
    codecs, the faults and the screening work on the flat (m, N) comm
    buffer, and `use_kernel=True` asks for the fused kernel, which only
    the flat round runs."""
    if flat:
        return
    if compressor is not None:
        raise ValueError(
            "compression operates on the flat (m, N) comm buffer — it "
            "requires the flat round path (flat=True on an algorithm "
            "providing round_flat; drop --no-flat)")
    if faults is not None or screening is not None:
        raise ValueError(
            "faults/screening operate on the flat (m, N) comm buffer — "
            "they require the flat round path (flat=True on an algorithm "
            "providing round_flat; drop --no-flat)")
    if getattr(algo.fed, "use_kernel", None):
        raise ValueError(
            "use_kernel=True (--kernel on) requires the flat round path "
            "(drop --no-flat)")


@dataclasses.dataclass
class Uplink:
    """What a run adds to its rounds beyond the policy and the store: the
    codec, the fault model and the screening (passed to every round), the
    guard and the checkpoints."""

    compressor: Any = None
    faults: Any = None
    screening: Any = None
    guard: Any = None
    ckpt: Any = None

    @property
    def round_kw(self):
        return {"compressor": self.compressor, "faults": self.faults,
                "screening": self.screening}

    @property
    def needs_key(self) -> bool:
        """Whether a round needs the codec's key (a stochastic codec)."""
        return self.compressor is not None and self.compressor.stochastic


_KEEP = ("rng", "round")  # the entries a guard never puts back


def _where(flag, new, old):
    return {k: pt.tree_map(lambda a, b: torch.where(flag, a, b), v, old[k])
            if k in old else v for k, v in new.items()}


def _copies(st):
    """Copies of the state's tensor entries (flat buffers or dicts of
    them) but the key and the round counter."""
    return {k: pt.tree_clone(v) for k, v in st.items()
            if (torch.is_tensor(v) or isinstance(v, dict))
            and k not in _KEEP}


class _Guard:
    """The reference's post-round quorum and watchdog (`_make_guard`) as
    `torch.where` merges on the device, so a captured chunk replays them.

    * quorum: a round whose accepted uploads (`screened` where the uplink
      screened, else `selected`) fall below `quorum` puts back every
      state entry but the key and the round counter, and the stale-x̄
      state; its row records `degraded`. The rounds write some buffers
      in place (the donated kernel, the active store's scatters, the
      stale views), so `before` copies the state first.
    * watchdog: the slot holds the best f̄, the count of diverged
      committed rounds and a snapshot of the state at the best round;
      after `patience` in a row above `factor` times the best (NaN
      counts) the state rolls back to the snapshot and the row records
      `rollback`. A degraded round leaves the count alone. The slot's
      tensors are updated in place (static buffers of a captured chunk).
    """

    def __init__(self, quorum, watchdog, patience, factor):
        self.quorum, self.watchdog = int(quorum), bool(watchdog)
        self.patience, self.factor = int(patience), float(factor)

    @classmethod
    def make(cls, quorum, watchdog, patience, factor):
        if not quorum and not watchdog:
            return None
        return cls(quorum, watchdog, patience, factor)

    def slot(self, st):
        """The watchdog's initial slot (copies of the state), or None."""
        if not self.watchdog:
            return None
        dev = _device_of(st)
        return {"best": torch.full((), float("inf"), dtype=torch.float32,
                                   device=dev),
                "bad": torch.zeros((), dtype=torch.int32, device=dev),
                "snap": _copies(st)}

    def before(self, st, stale):
        """What a quorum no-op puts back: copies of the state's tensors
        and of the stale-x̄ state (None without a quorum)."""
        if not self.quorum:
            return None
        old = _copies(st)
        sl = None
        if stale is not None:
            sl = {"age": stale.age.clone(),
                  "last_used": stale.last_used.clone()}
            if not stale.always_fresh:
                sl["anchor"] = pt.tree_clone(stale.anchor)
        return old, sl

    def after(self, saved, st, stale, ws, met):
        """The guarded round's state and metrics; `ws` and `stale`
        advance in place."""
        met = dict(met)
        ok = None
        if self.quorum:
            old, sl = saved
            n_eff = met.get("screened", met["selected"])
            ok = n_eff >= self.quorum
            st = _where(ok, st, old)
            if sl is not None:
                for k, v in sl.items():
                    pt.tree_map(lambda a, b: a.copy_(torch.where(ok, a, b)),
                                getattr(stale, k), v)
            met["degraded"] = torch.logical_not(ok)
        if self.watchdog:
            f = met["f_xbar"]
            best, bad, snap = ws["best"], ws["bad"], ws["snap"]
            improved = f < best if ok is None else torch.logical_and(
                ok, f < best)
            best2 = torch.where(improved, f, best)
            snap2 = _where(improved, {k: st[k] for k in snap}, snap)
            # NaN fails the <= and counts as diverged
            diverged = torch.logical_not(f <= self.factor * best2)
            if ok is not None:
                diverged = torch.logical_and(ok, diverged)
            bad2 = torch.where(diverged, bad + 1, 0).to(bad.dtype)
            if ok is not None:
                bad2 = torch.where(ok, bad2, bad)
            roll = bad2 >= self.patience
            st = dict(st, **_where(torch.logical_not(roll),
                                   {k: st[k] for k in snap}, snap2))
            best.copy_(best2)
            bad.copy_(torch.where(roll, 0, bad2))
            for k, v in snap2.items():
                _copy_into(snap[k], v)
            met["rollback"] = roll
        return st, met


def _config_fingerprint(**knobs) -> str:
    """The reference's round-semantics fingerprint of a checkpointing run
    (`num_rounds` left out: extending a run is what resuming is for).
    Dataclass knobs (the fault model, the screening) hash by repr,
    objects (the policy, the clock, the codec) by type, name and
    deadline."""
    def desc(v):
        if v is None or isinstance(v, (bool, int, float, str)):
            return v
        if dataclasses.is_dataclass(v):
            return repr(v)
        return [type(v).__name__, getattr(v, "name", None),
                getattr(v, "deadline_s", None)]

    payload = {k: desc(v) for k, v in knobs.items()}
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True).encode()).hexdigest()


class _Checkpoints:
    """A run's checkpoint directory, period and fingerprint."""

    def __init__(self, directory, every, resume, fingerprint):
        self.dir, self.every = directory, int(every)
        self.resume, self.fp = bool(resume), fingerprint

    def latest(self):
        """The step to resume from (None: a fresh start). Vets the
        fingerprint from the json alone, before any tree is read: another
        configuration's carry may not even have this one's structure."""
        if not self.resume:
            return None
        step = ckpt_io.latest_step(self.dir)
        if step is not None and \
                ckpt_io.load_extra(self.dir, step).get("fingerprint") \
                != self.fp:
            raise ValueError(
                f"resume: checkpoint ckpt_{step:08d} under {self.dir!r} "
                "was written by a run with a different configuration "
                "(fingerprint mismatch) — resuming it would not continue "
                "the run it started")
        return step

    def history_like(self, step):
        """Empty arrays of the saved history's keys and dtypes (its json
        lists them), the placeholders its load needs."""
        dtypes = ckpt_io.load_extra(self.dir, step)["history"]
        return {k: np.zeros((0,), np.dtype(d)) for k, d in dtypes.items()}

    def load(self, step, like):
        return ckpt_io.load_checkpoint(self.dir, step, like)[0]

    def save(self, step, tree):
        """Save a carry whose "history" is a dict of numpy arrays."""
        ckpt_io.save_checkpoint(self.dir, step, tree, extra={
            "fingerprint": self.fp,
            "history": {k: str(v.dtype) for k, v in tree["history"].items()}})


def _copy_into(dst, src):
    """Copy a tensor, or each leaf of a dict, into `dst`'s buffers, where
    they are not `src`'s own (an entry a round updated in place)."""
    if isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif src.data_ptr() != dst.data_ptr():
        dst.copy_(src)


def _restore(live, saved):
    """Copy a loaded tree's tensors into the live static ones."""
    if torch.is_tensor(live):
        live.copy_(saved)
    elif isinstance(live, dict):
        for k in live:
            _restore(live[k], saved[k])


def _round(algo, st, batch, spec, mask, slots, cap, packed, stale=None,
           uplink=None, ws=None, key=None):
    """One round of the dense store (`cap` None) or, on the round's
    `ActiveSet` of (mask, slots), of the active store; an async round
    when `stale` is given (it advances in place, and the metrics gain
    the staleness). `uplink` carries the codec, faults and screening to
    the round and guards it (with the watchdog slot `ws`); `key` is the
    codec's key where the state holds none (the chunked driver)."""
    uplink = uplink or Uplink()
    guard = uplink.guard
    saved = guard.before(st, stale) if guard is not None else None
    st_in = st if key is None else dict(st, codec_key=key)
    if spec is None:  # the per-leaf round (flat=False)
        st, met = algo.round(st_in, batch, mask=mask, stale=stale)
    elif cap is None:
        st, met = algo.round_flat(st_in, batch, spec, mask=mask, stale=stale,
                                  donate_kernel=True, **uplink.round_kw)
    else:
        st, met = algo.round_flat_active(
            st_in, batch, spec, pt.active_set(mask, slots, cap,
                                              packed=packed),
            stale=stale, donate_kernel=True, **uplink.round_kw)
    if key is not None:
        st = {k: v for k, v in st.items() if k != "codec_key"}
    if stale is not None:
        met = _with_staleness_metrics(met, stale)
    if guard is not None:
        st, met = guard.after(saved, st, stale, ws, met)
    return st, met


def _with_staleness_metrics(met, stale):
    """The async diagnostics of a round: `staleness`, the (m,) age of the
    anchor each client used (a copy: the stale state advances in place),
    and its max."""
    met = dict(met)
    met["staleness"] = stale.last_used.clone()
    met["staleness_max"] = torch.max(stale.last_used)
    return met


def _host_metrics(arrivals, astate, mask):
    """A round's metrics that the host knows from its draw: under a clock
    the simulated time (`sim_time`, the tick's new `now`) and, with a
    bandwidth, the wire's totals (`bytes_up`, `bytes_down`)."""
    if not isinstance(arrivals, ClockArrivals):
        return {}
    return {"sim_time": astate["now"], **arrivals.wire(mask)}


def _history(hist, extras):
    """Stack the per-round metrics and the host's (`_host_metrics`)."""
    history = {k: _stack([h[k] for h in hist]) for k in hist[0]}
    for k in (extras[0] if extras else ()):
        history[k] = _stack([e[k] for e in extras])
    return history


def _counters_on(flat, device, guard):
    """Under a guard the legacy loop carries its integer counters but the
    round as 0-d tensors, which a quorum or rollback puts back on the
    device. Returns their names."""
    if guard is None:
        return ()
    names = tuple(k for k, v in flat.items()
                  if isinstance(v, int) and k not in _KEEP)
    for k in names:
        flat[k] = torch.tensor(flat[k], device=device)
    return names


def _run_legacy_loop(algo, flat, batch, spec, num_rounds, tol, tol_metric,
                     participation, cap, packed, stale=None, uplink=None):
    device = _device_of(flat)
    uplink = uplink or Uplink()
    counters = _counters_on(flat, device, uplink.guard)
    ws = uplink.guard.slot(flat) if uplink.guard is not None else None
    pstate = participation.init() if participation is not None else None
    hist, extras = [], []
    stopped = False
    draw = 0.0
    t0 = time.perf_counter()
    for i in range(num_rounds):
        mask = slots = None
        if participation is not None:
            td = time.perf_counter()
            mask, pstate = participation.mask(pstate, i)
            if cap is not None:
                slots = pt.pack_slots(mask, cap).to(device)
            draw += time.perf_counter() - td
            extras.append(_host_metrics(participation, pstate, mask))
            mask = mask.to(device)
        new, met = _round(algo, flat, batch, spec, mask, slots, cap, packed,
                          stale, uplink, ws)
        # advance the state in the dict the caller holds too, so the last
        # round's buffers are freed (at a model's width, gigabytes each)
        if new is not flat:
            flat.clear()
            flat.update(new)
        hist.append(met)
        if tol > 0 and float(met[tol_metric]) < tol:
            stopped = True
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    for k in counters:
        flat[k] = int(flat[k])
    return RoundResult(unflatten_state(algo, flat, spec),
                       _history(hist, extras), len(hist), stopped, wall,
                       draw_s=draw, policy_state=pstate, stale=stale)


def _counts():
    return [dict(c) for c in launch_counters()]


def _set_counts(counts):
    for live, saved in zip(launch_counters(), counts):
        live.update(saved)


def _diff(after, before):
    return [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]


def _add_counts(deltas):
    for live, d in zip(launch_counters(), deltas):
        for k, v in d.items():
            live[k] += v


class _Chunked:
    """The chunked driver: static buffers that every chunk reads and
    writes in place (the state, the chunk's selection masks and codec
    keys, the per-round history, the watchdog slot and, with tol > 0, the
    stop flag and the count of rounds run), and one chunk program per
    chunk length, captured as a CUDA graph on the card.

    Every integer counter of the state (`round`; the baselines' `step`,
    which their learning-rate schedule reads) is carried on the device,
    a 0-d int64 tensor inside and an int outside, so the counters, the
    `cr` metric and the learning rates advance inside a replayed graph
    as in the legacy loop (an int would be baked into the capture).

    Masks are drawn and uploaded for every algorithm under a
    participation policy, and otherwise only for an algorithm that
    selects in the round (`algo.selects_in_round`, from its own key);
    the others get `mask=None`. The key stays on the host: the driver
    splits it a chunk ahead, once a round, where the algorithm selects,
    and, under a stochastic codec, folds each round's key before its
    split with the round counter (`compress.round_key`) and uploads the
    chunk's (rounds, 2) codec keys beside its masks.

    Launch counts: a capture makes no launch, so the counts that the
    wrappers add while a chunk is captured are taken back, and each
    replay adds the launches recorded by the rounds that ran in it.

    Async rounds: the `api.StaleXbar` buffers are static buffers of the
    chunk too (every round writes them in place). A clock ticks on the
    host beside the mask draws, and its simulated times (and wire bytes)
    stay there.

    Checkpoints (`uplink.ckpt`): the chunks are cut at multiples of
    `checkpoint_every`, and the whole carry is saved there (`_carry`);
    a resume restores it into the static buffers before the capture.
    """

    def __init__(self, algo, flat, batch, spec, tol, tol_metric, longest,
                 participation, cap=None, packed=False, stale=None,
                 uplink=None):
        """`longest`: the most rounds a chunk of this run can have, which
        sizes the static mask and history buffers. `participation`: the
        arrival process (a policy, or a clock as `ClockArrivals`). `cap`:
        the active store's tile capacity (None: the dense store); the
        chunk's packed ids (`ActiveSet.slots`) then ride beside its
        masks. `stale`: the async rounds' state. `uplink`: the codec,
        faults, screening, guard and checkpoints."""
        self.algo, self.batch, self.spec = algo, batch, spec
        self.cap, self.packed, self.stale = cap, packed, stale
        self.uplink = uplink or Uplink()
        self.tol, self.tol_metric, self.longest = tol, tol_metric, longest
        self.key = flat["rng"]
        self.round0 = flat["round"]
        self.splits = getattr(algo, "selects_in_round", False)
        self.policy = participation
        self.pstate = (participation.init() if participation is not None
                       else None)
        self.st = {k: v for k, v in flat.items() if k != "rng"}
        dev = self.device = _device_of(self.st)
        self.cuda = dev.type == "cuda"
        self.counters = tuple(k for k, v in flat.items()
                              if isinstance(v, int))
        for k in self.counters:
            self.st[k] = torch.tensor(flat[k], device=dev)
        guard = self.uplink.guard
        self.ws = guard.slot(self.st) if guard is not None else None
        self.selects = (participation is not None
                        or getattr(algo, "selects_in_round", False))
        self.keyed = self.uplink.needs_key
        if self.selects:
            m = algo.fed.num_clients
            self.masks = torch.ones((longest, m), dtype=torch.bool,
                                    device=dev)
            self.host_masks = torch.ones((longest, m), dtype=torch.bool,
                                         pin_memory=self.cuda)
            if cap is not None:
                self.slots = torch.zeros((longest, cap), dtype=torch.int64,
                                         device=dev)
                self.host_slots = torch.zeros((longest, cap),
                                              dtype=torch.int64,
                                              pin_memory=self.cuda)
        if self.keyed:
            self.keys = torch.zeros((longest, 2), dtype=torch.int64,
                                    device=dev)
            self.host_keys = torch.zeros((longest, 2), dtype=torch.int64,
                                         pin_memory=self.cuda)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.hist = {}
        self.graphs = {}  # chunk length -> (graph, per-round launch counts)
        if self.cuda:
            self.capture_stream = torch.cuda.Stream(dev)
            self.body = graphs.Body(dev)
            self.uploaded = torch.cuda.Event()

    # ---------------------------------------------------------- the chunk
    def _round(self, st, i):
        mask = self.masks[i] if self.selects else None
        slots = self.slots[i] if self.cap is not None else None
        key = self.keys[i] if self.keyed else None
        st, met = _round(self.algo, st, self.batch, self.spec, mask, slots,
                         self.cap, self.packed, self.stale, self.uplink,
                         self.ws, key)
        for k, v in met.items():
            if torch.is_tensor(v):
                self.hist[k][i].copy_(v)
            else:
                self.hist[k][i].fill_(v)
        return st, met

    def _commit(self, st):
        """Copy a round's new state into the static buffers (an entry the
        round updated in place, such as the donated π, is already there)."""
        for k, v in st.items():
            _copy_into(self.st[k], v)

    def _program(self, length, unless_done):
        """Enqueue (or, on the CPU, run) `length` rounds on the static
        buffers. `unless_done` wraps each round when tol > 0. Returns the
        launch counts that each round added."""
        per_round = []
        if self.tol <= 0:  # every round runs: the state flows round to
            st = dict(self.st)  # round and is stored once, at the end
            for i in range(length):
                before = _counts()
                st, _ = self._round(st, i)
                per_round.append(_diff(_counts(), before))
            self._commit(st)
            return per_round
        for v in self.hist.values():
            v.zero_()  # a frozen round reports zeros, as the reference's
        for i in range(length):
            before = _counts()
            with unless_done() as live:
                if live:
                    st, met = self._round(self.st, i)
                    self._commit(st)
                    self.done.copy_(met[self.tol_metric].double() < self.tol)
                    self.count.add_(1)
            per_round.append(_diff(_counts(), before))
        return per_round

    @contextlib.contextmanager
    def _eager_unless_done(self):
        yield not bool(self.done)

    @contextlib.contextmanager
    def _captured_unless_done(self):
        with graphs.skip_if(self.done, self.body):
            yield True

    # ---------------------------------------------------------- the card
    def _on_capture_streams(self, fn):
        """Run `fn` eagerly on each stream that captures will use."""
        streams = [self.capture_stream]
        if self.tol > 0:
            streams.append(self.body.stream)
        for s in streams:
            s.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(s):
                out = fn()
            torch.cuda.current_stream(self.device).wait_stream(s)
        return out

    def _warm_up(self):
        """One round on copies of the state, eagerly, with every client
        selected (no draw) where the algorithm selects (the first
        `cap` under the active store): it sizes the
        history buffers from the metrics and, on the card, runs on the
        capture streams before any capture (cuBLAS handles and
        workspaces, the kernel libraries), outside the timed window and
        the launch counts."""
        counts = _counts()

        def warm():
            copies = pt.tree_clone(self.st)
            stale = None if self.stale is None else self.stale.clone()
            ws = None if self.ws is None else pt.tree_clone(self.ws)
            mask = slots = None
            if self.cap is not None:
                slots = torch.arange(self.cap, device=self.device)
                mask = torch.zeros_like(self.masks[0]).index_fill_(
                    0, slots, True)
            elif self.selects:
                mask = torch.ones_like(self.masks[0])
            key = self.keys[0] if self.keyed else None
            return _round(self.algo, copies, self.batch, self.spec, mask,
                          slots, self.cap, self.packed, stale, self.uplink,
                          ws, key)[1]

        met = self._on_capture_streams(warm) if self.cuda else warm()
        _set_counts(counts)
        for k, v in met.items():
            dt, shape = torch.float32, ()
            if torch.is_tensor(v):
                dt, shape = v.dtype, tuple(v.shape)
            self.hist[k] = torch.zeros((self.longest,) + shape, dtype=dt,
                                       device=self.device)

    def _graph(self, length):
        if length not in self.graphs:
            counts = _counts()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g, stream=self.capture_stream):
                per_round = self._program(length, self._captured_unless_done)
            _set_counts(counts)
            self.graphs[length] = (g, per_round)
        return self.graphs[length]

    # ---------------------------------------------------------- the run
    def _upload(self, length, first_round):
        """Draw the chunk's masks, from the policy (its rounds counted from
        `first_round`) or else from the algorithm's key chain
        (`selection.round_split`, which splits the key every round even
        under a policy), pack each into its `ActiveSet.slots` under the
        active store, make each round's codec key from the key before its
        split, and send them to the static buffers. Returns the (key,
        policy state) before each round and after the last, so a stop can
        put back the state at it, the host seconds the draws and packs
        took, and the rounds' host metrics (`_host_metrics`)."""
        if self.cuda:
            self.uploaded.synchronize()  # the last upload has left
        m, alpha = self.algo.fed.num_clients, self.algo.fed.alpha
        t0 = time.perf_counter()
        states, extras = [], []
        for i in range(length):
            states.append((self.key, self.pstate))
            r = self.round0 + first_round + i
            if self.keyed:
                self.host_keys[i] = torch.from_numpy(
                    compress.round_key(self.key, r).astype(np.int64))
            if not self.selects:
                continue
            if self.splits:
                self.key, mask = selection.round_split(
                    self.key, r, m, alpha, draw=self.policy is None)
            if self.policy is None:
                self.host_masks[i] = mask
            else:
                self.host_masks[i], self.pstate = self.policy.mask(
                    self.pstate, first_round + i)
                extras.append(_host_metrics(self.policy, self.pstate,
                                            self.host_masks[i]))
            if self.cap is not None:
                self.host_slots[i] = pt.pack_slots(self.host_masks[i],
                                                   self.cap)
        states.append((self.key, self.pstate))
        draw = time.perf_counter() - t0
        if self.selects:
            self.masks[:length].copy_(self.host_masks[:length],
                                      non_blocking=self.cuda)
        if self.cap is not None:
            self.slots[:length].copy_(self.host_slots[:length],
                                      non_blocking=self.cuda)
        if self.keyed:
            self.keys[:length].copy_(self.host_keys[:length],
                                     non_blocking=self.cuda)
        if self.cuda:
            self.uploaded.record()
        return states, draw, extras

    def _carry(self, rounds_run, history):
        """The whole carry that a checkpoint holds."""
        stale = None
        if self.stale is not None:
            stale = {"age": self.stale.age,
                     "last_used": self.stale.last_used,
                     "anchor": (None if self.stale.always_fresh
                                else self.stale.anchor)}
        return {"state": self.st, "key": self.key, "pstate": self.pstate,
                "stale": stale, "watchdog": self.ws, "done": self.done,
                "count": self.count, "rounds_run": rounds_run,
                "history": history}

    def _resume(self):
        """Restore the newest checkpoint into the static buffers. Returns
        (its step, the rounds run, the history so far), or None."""
        ckpt = self.uplink.ckpt
        step = ckpt.latest() if ckpt is not None else None
        if step is None:
            return None
        like = self._carry(0, ckpt.history_like(step))
        saved = ckpt.load(step, like)
        for name in ("state", "watchdog", "done", "count"):
            _restore(like[name], saved[name])
        if self.stale is not None:
            _restore(like["stale"], saved["stale"])
        self.key, self.pstate = saved["key"], saved["pstate"]
        return step, saved["rounds_run"], saved["history"]

    def run(self, num_rounds, chunk, plan, lengths):
        """Run the rounds in chunks of `chunk`, after the timed chunks of
        `plan` (chunk_size="auto": the fastest per round among them then
        sets `chunk`). On the card each length of `lengths` is captured
        before the timed window. Under checkpoints the chunks end at
        every multiple of `checkpoint_every`, where the carry is saved."""
        t0 = time.perf_counter()
        self._warm_up()
        resumed = self._resume()
        if self.cuda:
            # the warm-up's copies of the state stay cached in the default
            # pool, where a capture's private pool cannot reuse them; at a
            # model's width they are tens of gigabytes
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            for length in lengths:  # others (a remainder that tol > 0 may
                self._graph(length)  # never reach) are captured on use
            torch.cuda.synchronize(self.device)
        capture = time.perf_counter() - t0

        plan, timings = list(plan), []
        chunks, extras, rounds_run, stopped, draw = [], [], 0, False, 0.0
        executed, saved = 0, {}
        if resumed is not None:
            executed, rounds_run, saved = resumed
            stopped = self.tol > 0 and bool(self.done)
        ckpt = self.uplink.ckpt
        every = ckpt.every if ckpt is not None else 0
        t0 = time.perf_counter()
        while executed < num_rounds and not stopped:
            timed = bool(plan)
            length = plan.pop(0) if timed else min(chunk,
                                                   num_rounds - executed)
            if every:  # cut the chunk at the next checkpoint round
                length = min(length, (executed // every + 1) * every
                             - executed)
            tc = time.perf_counter()
            chunk_extras = []
            if self.selects or self.keyed:
                states, dt, chunk_extras = self._upload(length, executed)
                draw += dt
            if self.cuda:
                tg = time.perf_counter()
                fresh = length not in self.graphs
                graph, per_round = self._graph(length)
                if fresh:
                    torch.cuda.synchronize(self.device)
                    capture += time.perf_counter() - tg
                    t0 += time.perf_counter() - tg
                graph.replay()
            else:
                per_round = self._program(length, self._eager_unless_done)
            live = length
            if self.tol > 0:  # the chunk's one read back to the host
                live = int(self.count) - rounds_run
                stopped = bool(self.done)
            if timed:
                if self.cuda:
                    torch.cuda.synchronize(self.device)
                timings.append(((time.perf_counter() - tc) / length, length))
                chunk = min(timings)[1]
            if self.cuda:
                for d in per_round[:live]:
                    _add_counts(d)
            chunks.append({k: v[:live].clone() for k, v in self.hist.items()})
            extras += chunk_extras[:live]
            rounds_run += live
            executed += length
            if stopped and self.selects:
                self.key, self.pstate = states[live]
            if every and executed % every == 0:
                self.uplink.ckpt.save(executed, self._carry(
                    rounds_run, _concat(saved, self._history(chunks,
                                                             extras))))
        if self.cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        history = _concat(saved, self._history(chunks, extras))
        flat = dict(self.st, rng=self.key)
        for k in self.counters:
            flat[k] = int(self.st[k])
        return RoundResult(unflatten_state(self.algo, flat, self.spec),
                           history, rounds_run, stopped, wall, capture,
                           chunk_size=chunk, draw_s=draw,
                           policy_state=self.pstate, stale=self.stale)

    def _history(self, chunks, extras):
        """The chunks' device metrics and the host's, as numpy."""
        if not chunks:
            return {}
        history = {k: torch.cat([c[k] for c in chunks]).cpu().numpy()
                   for k in self.hist}
        for k in (extras[0] if extras else ()):
            history[k] = _stack([e[k] for e in extras])
        return history


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if torch.is_tensor(t))


class _Staged:
    """One round's inputs that the host prepares ahead of it: the mask,
    the packed ids and (for a participant tile) the batch tile, each in a
    host buffer (pinned on the card) and its device twin."""

    def __init__(self, m, cap, batch_h, device, pinned):
        def pair(shape, dtype):
            return (torch.empty(shape, dtype=dtype, pin_memory=pinned),
                    torch.empty(shape, dtype=dtype, device=device))

        self.mask = pair((m,), torch.bool)
        self.slots = pair((cap,), torch.int64)
        self.batch = {k: pair((cap,) + tuple(v.shape[1:]), v.dtype)
                      for k, v in (batch_h or {}).items()}
        self.uploaded = torch.cuda.Event() if device.type == "cuda" else None


def _run_offload_loop(algo, flat, batch, spec, num_rounds, tol, tol_metric,
                      participation, cap, packed, stale=None, uplink=None):
    """Host-driven round loop of ``run_rounds(store="offload")``
    (counterpart of the reference's `_run_offload_loop`).

    The resident `flat_client_keys` buffers and, for a participant tile,
    the per-client batch live in host memory (`pt.OffloadStore`, pinned
    on the card); the device keeps the globals (x, counters, σ, FedGiA's
    gram factors). Each round:

      1. the host draws the mask from the policy and packs its ids
         (`pt.pack_slots`), as the other drivers do, so the masks agree;
      2. the host gathers the participants' (capacity, N) state tiles
         from the store into pinned staging buffers (the ActiveSet's clip
         reads) and copies them to the card, `non_blocking`, on a side
         stream that the round's stream waits for;
      3. the round runs `algo.round_flat_active` with a tile-mode
         `ActiveSet` (`tile_state=True`: the state accessors are the
         identity on the gathered tiles, while idx, slots and mask keep
         their resident rows for the aggregation);
      4. the updated tiles come back on the side stream into pinned
         buffers, and the host scatters them into the store (the
         ActiveSet's dropped padding writes).

    Async rounds (`stale`, built with ``resident=False``): the (m, N)
    stale anchor lives in host memory beside the store, and the (m,) ages
    on the card. The participants' anchor rows ride with the state tiles
    (FedGiA's population round takes the whole buffer and writes it back
    as it does z, π and h); after a participant-tile round the host
    applies the refresh write, ``anchor[refresh] = x̄`` with the rows
    ``mask | (age > max_staleness)`` of the round's entry and the fresh
    x̄ that `api.stale_xbar_view_active` hands back: the same row select
    as the active store's, so the loop stays bitwise "active".

    Quorum (`uplink.guard`; the watchdog is refused for this store): the
    round's accepted-upload count comes back to the host before the
    write-back, one read a round, and a degraded round writes nothing
    back: the store, the stale anchor and ages and the globals but the
    key and the round counter keep their values. Checkpoints
    (`uplink.ckpt`): after the stop check of every `checkpoint_every`-th
    round the loop saves the globals, the store, the stale state, the
    policy state after the round's draw and the history.

    Steps 1-2 are DOUBLE-BUFFERED for what does not depend on the round:
    the next round's mask, ids and batch tile are drawn, gathered and
    copied while the current round runs on the card; the state tiles wait
    for the current round's write-back. Gather and scatter are pure data
    movement, so the loop is BITWISE ``store="active"``. FedGiA's
    population tile (`active_tile = "population"`) moves the whole
    client buffers each way instead, and its batch stays on the card.

    `RoundResult.extras`: `host_resident_bytes` (the store, the host
    batch and the stale anchor), `device_peak_bytes` (on the card: the
    most bytes allocated above the loop's start,
    `torch.cuda.max_memory_allocated` after `reset_peak_memory_stats`,
    plus the device-resident state the rounds read; None on the CPU) and `copy_s` (host seconds gathering, copying
    back and scattering the tiles, the wait for the round excluded).
    """
    device = flat["x"].device
    cuda = device.type == "cuda"
    m = algo.fed.num_clients
    uplink = uplink or Uplink()
    quorum = uplink.guard.quorum if uplink.guard is not None else 0
    population = getattr(algo, "active_tile", "participants") == "population"
    keys = [k for k in algo.flat_client_keys if k in flat]
    store = pt.OffloadStore({k: flat.pop(k) for k in keys}, pinned=cuda)
    gstate = flat
    batch_h = None if population else {
        k: pt.host_put(v, cuda) for k, v in batch.items()}
    anchor_h = None  # the async rounds' (m, N) stale anchor, on the host
    if stale is not None and not stale.always_fresh:
        anchor_h = pt.host_put(stale.anchor, cuda)
    host_bytes = store.nbytes + _nbytes(
        (*(batch_h or {}).values(), anchor_h))

    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        resident = _nbytes(gstate.values()) + (
            _nbytes(batch.values()) if population else 0)
        side = torch.cuda.Stream(device)
        main = torch.cuda.current_stream(device)
        on_side = lambda: torch.cuda.stream(side)  # noqa: E731
    else:
        on_side = contextlib.nullcontext
    staged = [_Staged(m, cap, batch_h, device, cuda) for _ in range(2)]
    # the buffers that move to the card and back each round: the state
    # tiles, with the stale anchor's rows as "anchor"
    moving = dict(store.buffers)
    if anchor_h is not None:
        moving["anchor"] = anchor_h
    if population:
        host_tiles = moving
        dev_tiles = {k: torch.empty_like(b, device=device)
                     for k, b in moving.items()}
    else:
        host_tiles = {k: torch.empty((cap,) + tuple(b.shape[1:]),
                                     dtype=b.dtype, pin_memory=cuda)
                      for k, b in moving.items()}
        dev_tiles = {k: torch.empty_like(t, device=device)
                     for k, t in host_tiles.items()}
        back = {k: torch.empty(t.shape, dtype=t.dtype, pin_memory=cuda)
                for k, t in host_tiles.items() if k != "anchor"}
    if anchor_h is not None and population:
        stale.view = torch.empty_like(dev_tiles["anchor"])

    pstate = participation.init()
    draw = copy = 0.0

    def stage(i, s):
        """Draw round i's mask, pack its ids, gather its batch tile and
        start their copies to the card into staging set `s`. Returns the
        round's host ActiveSet."""
        nonlocal pstate, draw, copy
        st = staged[s]
        td = time.perf_counter()
        mask, pstate = participation.mask(pstate, i)
        st.host_metrics = _host_metrics(participation, pstate, mask)
        st.mask[0].copy_(mask)
        st.slots[0].copy_(pt.pack_slots(mask, cap))
        aset = pt.active_set(st.mask[0], st.slots[0], cap)
        tc = time.perf_counter()
        draw += tc - td
        for k, (h, _) in st.batch.items():
            aset.gather(batch_h[k], out=h)
        copy += time.perf_counter() - tc
        with on_side():
            for h, d in (st.mask, st.slots, *st.batch.values()):
                d.copy_(h, non_blocking=cuda)
            if cuda:
                st.uploaded.record()
        return aset

    def carry(history):
        """What a checkpoint of the loop holds."""
        sl = None
        if stale is not None:
            sl = {"age": stale.age, "last_used": stale.last_used,
                  "anchor": anchor_h}
        return {"gstate": gstate, "store": store.buffers, "stale": sl,
                "pstate": pstate, "history": history}

    hist, host_mets, stopped, pstate_run = [], [], False, None
    ckpt, start, saved = uplink.ckpt, 0, {}
    step = ckpt.latest() if ckpt is not None else None
    if step is not None:
        snap = ckpt.load(step, carry(ckpt.history_like(step)))
        _restore(store.buffers, snap["store"])
        _restore(carry({})["stale"], snap["stale"])
        gstate, pstate, saved = snap["gstate"], snap["pstate"], \
            snap["history"]
        start = step
    t0 = time.perf_counter()
    if start < num_rounds:
        aset_h = stage(start, start % 2)
    for i in range(start, num_rounds):
        st = staged[i % 2]
        tc = time.perf_counter()
        if not population:
            store.gather_tiles(aset_h, out=host_tiles)
            if anchor_h is not None:
                aset_h.gather(anchor_h, out=host_tiles["anchor"])
        copy += time.perf_counter() - tc
        with on_side():
            for k, h in host_tiles.items():
                dev_tiles[k].copy_(h, non_blocking=cuda)
            if cuda:
                st.uploaded.record()
        if cuda:
            main.wait_event(st.uploaded)
        aset = pt.active_set(st.mask[1], st.slots[1], cap,
                             tile_state=not population, packed=packed)
        round_batch = batch if population else {
            k: d for k, (_, d) in st.batch.items()}
        state_tiles = {k: dev_tiles[k] for k in keys}
        refresh = None
        if anchor_h is not None:
            stale.anchor = dev_tiles["anchor"]
            if not population:  # the rows the host write refreshes
                refresh = torch.logical_or(
                    aset.mask, stale.age > stale.max_staleness)
        ages = None
        if quorum and stale is not None:
            ages = (stale.age.clone(), stale.last_used.clone())
        out, met = algo.round_flat_active(dict(gstate, **state_tiles),
                                          round_batch, spec, aset,
                                          stale=stale, donate_kernel=True,
                                          **uplink.round_kw)
        if stale is not None:
            met = _with_staleness_metrics(met, stale)
        tiles = {k: out.pop(k) for k in keys}
        if anchor_h is not None and population:
            tiles["anchor"] = stale.anchor
        degraded = False
        if quorum:
            # the commit waits on the round's count: one read a round
            n_eff = met.get("screened", met["selected"])
            degraded = bool(n_eff < quorum)
            met = dict(met, degraded=torch.tensor(degraded, device=device))
        if degraded:  # a recorded no-op: only the key and round advance
            gstate = {k: (out[k] if k in _KEEP else gstate[k]) for k in out}
            if ages is not None:
                stale.age.copy_(ages[0])
                stale.last_used.copy_(ages[1])
            tiles, refresh = {}, None
        else:
            gstate = out
        pstate_run = pstate
        host_mets.append(st.host_metrics)
        if cuda:
            done = torch.cuda.Event()
            done.record()
        if i + 1 < num_rounds:  # the next round's draw and batch tile
            next_h = stage(i + 1, (i + 1) % 2)  # overlap this round
        if cuda:
            done.synchronize()
        tc = time.perf_counter()
        dest = moving if population else back
        with on_side():
            for k, t in tiles.items():
                dest[k].copy_(t, non_blocking=cuda)
        if cuda:
            side.synchronize()
        if not population and not degraded:
            store.scatter_tiles(aset_h, back)
            if refresh is not None:
                # the active store's row select, on the host copy
                anchor_h[refresh.cpu()] = stale.anchor.cpu()
        copy += time.perf_counter() - tc
        hist.append(met)
        if tol > 0 and float(met[tol_metric]) < tol:
            stopped = True
            break
        if ckpt is not None and ckpt.every and (i + 1) % ckpt.every == 0:
            # after the stop check: a run that stops at a checkpoint
            # round saves nothing there, so its resume stops there again
            ckpt.save(i + 1, dict(carry(_concat(saved, _history(
                hist, host_mets))), pstate=pstate_run))
        if i + 1 < num_rounds:
            aset_h = next_h
    if cuda:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    extras = {"host_resident_bytes": int(host_bytes),
              "device_peak_bytes": None, "copy_s": copy}
    if cuda:
        extras["device_peak_bytes"] = int(
            torch.cuda.max_memory_allocated(device) - base + resident)
    state = dict(gstate)
    for k, b in store.buffers.items():
        state[k] = b.to(device)
    if anchor_h is not None:
        stale.anchor, stale.view = anchor_h.to(device), None
    history = _concat(saved, _history(hist, host_mets) if hist else {})
    rounds = start + len(hist)
    return RoundResult(unflatten_state(algo, state, spec), history, rounds,
                       stopped, wall, draw_s=draw,
                       policy_state=pstate_run if hist else pstate,
                       extras=extras, stale=stale)
