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
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core import api, graphs, selection
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
    write the tensors of `state`."""
    out = dict(state)
    for k in algo.flat_global_keys:
        if k in out:
            out[k] = spec.ravel(out[k])
    for k in algo.flat_client_keys:
        if k in out:
            out[k] = spec.ravel_stacked(out[k])
    return out


def unflatten_state(algo, state, spec):
    """Inverse of `flatten_state`: callers see the dict layout."""
    out = dict(state)
    for k in (*algo.flat_global_keys, *algo.flat_client_keys):
        if k in out:
            out[k] = spec.unravel(out[k])
    return out


def _stack(values):
    if torch.is_tensor(values[0]):
        return torch.stack(values).cpu().numpy()
    return np.asarray(values, np.float32)


AUTO_CHUNK_CANDIDATES = (8, 32, 128)


def run_rounds(algo, state, batch, num_rounds: int, *, tol: float = 0.0,
               tol_metric: str = "grad_sq_norm", scan: bool = True,
               chunk_size=0, participation=None, store: str = "dense",
               aggregate: str = "dense", async_rounds: bool = False,
               max_staleness: int = 0, clock=None,
               stale_weighting: str = "uniform",
               stale_decay: float = 1.0) -> RoundResult:
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
    arrivals = participation if clock is None else ClockArrivals(clock)
    cap = _check_store(algo, store, aggregate, arrivals, auto)
    packed = aggregate == "packed"
    spec = ravel_spec(state["x"])
    flat = flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
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
            cap, packed, stale), clock)
    if not scan:
        return _with_clock(_run_legacy_loop(
            algo, flat, batch, spec, num_rounds, tol, tol_metric, arrivals,
            cap, packed, stale), clock)
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
        cap, packed, stale).run(num_rounds, chunk, plan, lengths), clock)


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


def _check_store(algo, store, aggregate, participation, auto):
    """The reference's checks of `store` and `aggregate`, with its
    messages. `participation` is the round's arrival process (a policy,
    or a clock as `ClockArrivals`). Returns the tile's capacity (None for
    the dense store)."""
    if store not in ("dense", "active", "offload"):
        raise ValueError(
            f"unknown store {store!r}: ('dense', 'active', 'offload')")
    cap = None
    if store in ("active", "offload"):
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


def _round(algo, st, batch, spec, mask, slots, cap, packed, stale=None):
    """One round of the dense store (`cap` None) or, on the round's
    `ActiveSet` of (mask, slots), of the active store; an async round
    when `stale` is given (it advances in place, and the metrics gain
    the staleness)."""
    if cap is None:
        st, met = algo.round_flat(st, batch, spec, mask=mask, stale=stale,
                                  donate_kernel=True)
    else:
        st, met = algo.round_flat_active(
            st, batch, spec, pt.active_set(mask, slots, cap, packed=packed),
            stale=stale, donate_kernel=True)
    if stale is None:
        return st, met
    return st, _with_staleness_metrics(met, stale)


def _with_staleness_metrics(met, stale):
    """The async diagnostics of a round: `staleness`, the (m,) age of the
    anchor each client used (a copy: the stale state advances in place),
    and its max."""
    met = dict(met)
    met["staleness"] = stale.last_used.clone()
    met["staleness_max"] = torch.max(stale.last_used)
    return met


def _sim_time(arrivals, astate):
    """The round's simulated time under a clock (the tick's new `now`),
    else None."""
    return astate["now"] if isinstance(arrivals, ClockArrivals) else None


def _history(hist, sims):
    """Stack the per-round metrics, with the clock's times as
    `sim_time`."""
    history = {k: _stack([h[k] for h in hist]) for k in hist[0]}
    if sims:
        history["sim_time"] = _stack(sims)
    return history


def _run_legacy_loop(algo, flat, batch, spec, num_rounds, tol, tol_metric,
                     participation, cap, packed, stale=None):
    device = flat["x"].device
    pstate = participation.init() if participation is not None else None
    hist, sims = [], []
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
            mask = mask.to(device)
            now = _sim_time(participation, pstate)
            if now is not None:
                sims.append(now)
        flat, met = _round(algo, flat, batch, spec, mask, slots, cap, packed,
                           stale)
        hist.append(met)
        if tol > 0 and float(met[tol_metric]) < tol:
            stopped = True
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    return RoundResult(unflatten_state(algo, flat, spec),
                       _history(hist, sims), len(hist), stopped, wall,
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
    writes in place (the state, the chunk's selection masks, the per-round
    history and, with tol > 0, the stop flag and the count of rounds run),
    and one chunk program per chunk length, captured as a CUDA graph on
    the card.

    Every integer counter of the state (`round`; the baselines' `step`,
    which their learning-rate schedule reads) is carried on the device,
    a 0-d int64 tensor inside and an int outside, so the counters, the
    `cr` metric and the learning rates advance inside a replayed graph
    as in the legacy loop (an int would be baked into the capture).

    Masks are drawn and uploaded for every algorithm under a
    participation policy, and otherwise only for an algorithm that
    selects in the round (`algo.selects_in_round`, from its own key);
    the others get `mask=None`. The key stays on the host: the driver
    splits it a chunk ahead, once a round, where the algorithm selects.

    Launch counts: a capture makes no launch, so the counts that the
    wrappers add while a chunk is captured are taken back, and each
    replay adds the launches recorded by the rounds that ran in it.

    Async rounds: the `api.StaleXbar` buffers are static buffers of the
    chunk too (every round writes them in place). A clock ticks on the
    host beside the mask draws, and its simulated times stay there.
    """

    def __init__(self, algo, flat, batch, spec, tol, tol_metric, longest,
                 participation, cap=None, packed=False, stale=None):
        """`longest`: the most rounds a chunk of this run can have, which
        sizes the static mask and history buffers. `participation`: the
        arrival process (a policy, or a clock as `ClockArrivals`). `cap`:
        the active store's tile capacity (None: the dense store); the
        chunk's packed ids (`ActiveSet.slots`) then ride beside its
        masks. `stale`: the async rounds' state."""
        self.algo, self.batch, self.spec = algo, batch, spec
        self.cap, self.packed, self.stale = cap, packed, stale
        self.tol, self.tol_metric, self.longest = tol, tol_metric, longest
        self.key = flat["rng"]
        self.round0 = flat["round"]
        self.splits = getattr(algo, "selects_in_round", False)
        self.policy = participation
        self.pstate = (participation.init() if participation is not None
                       else None)
        self.st = {k: v for k, v in flat.items() if k != "rng"}
        dev = self.device = self.st["x"].device
        self.cuda = dev.type == "cuda"
        self.counters = tuple(k for k, v in flat.items()
                              if isinstance(v, int))
        for k in self.counters:
            self.st[k] = torch.tensor(flat[k], device=dev)
        self.selects = (participation is not None
                        or getattr(algo, "selects_in_round", False))
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
        st, met = _round(self.algo, st, self.batch, self.spec, mask, slots,
                         self.cap, self.packed, self.stale)
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
            if v.data_ptr() != self.st[k].data_ptr():
                self.st[k].copy_(v)

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
            copies = {k: v.clone() for k, v in self.st.items()}
            stale = None if self.stale is None else self.stale.clone()
            mask = slots = None
            if self.cap is not None:
                slots = torch.arange(self.cap, device=self.device)
                mask = torch.zeros_like(self.masks[0]).index_fill_(
                    0, slots, True)
            elif self.selects:
                mask = torch.ones_like(self.masks[0])
            return _round(self.algo, copies, self.batch, self.spec, mask,
                          slots, self.cap, self.packed, stale)[1]

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
    def _upload_masks(self, length, first_round):
        """Draw the chunk's masks, from the policy (its rounds counted from
        `first_round`) or else from the algorithm's key chain
        (`selection.round_split`, which splits the key every round even
        under a policy), pack each into its `ActiveSet.slots` under the
        active store, and send them to the static buffers. Returns the
        (key, policy state) before each round and after the last, so a
        stop can put back the state at it, the host seconds the draws and
        packs took, and, under a clock, the rounds' simulated times."""
        if self.cuda:
            self.uploaded.synchronize()  # the last upload has left
        m, alpha = self.masks.shape[1], self.algo.fed.alpha
        t0 = time.perf_counter()
        states, sims = [], []
        for i in range(length):
            states.append((self.key, self.pstate))
            if self.splits:
                self.key, mask = selection.round_split(
                    self.key, self.round0 + first_round + i, m, alpha,
                    draw=self.policy is None)
            if self.policy is None:
                self.host_masks[i] = mask
            else:
                self.host_masks[i], self.pstate = self.policy.mask(
                    self.pstate, first_round + i)
                now = _sim_time(self.policy, self.pstate)
                if now is not None:
                    sims.append(now)
            if self.cap is not None:
                self.host_slots[i] = pt.pack_slots(self.host_masks[i],
                                                   self.cap)
        states.append((self.key, self.pstate))
        draw = time.perf_counter() - t0
        self.masks[:length].copy_(self.host_masks[:length],
                                  non_blocking=self.cuda)
        if self.cap is not None:
            self.slots[:length].copy_(self.host_slots[:length],
                                      non_blocking=self.cuda)
        if self.cuda:
            self.uploaded.record()
        return states, draw, sims

    def run(self, num_rounds, chunk, plan, lengths):
        """Run the rounds in chunks of `chunk`, after the timed chunks of
        `plan` (chunk_size="auto": the fastest per round among them then
        sets `chunk`). On the card each length of `lengths` is captured
        before the timed window."""
        t0 = time.perf_counter()
        self._warm_up()
        if self.cuda:
            for length in lengths:  # others (a remainder that tol > 0 may
                self._graph(length)  # never reach) are captured on use
            torch.cuda.synchronize(self.device)
        capture = time.perf_counter() - t0

        plan, timings = list(plan), []
        chunks, sims, rounds_run, stopped, draw = [], [], 0, False, 0.0
        t0 = time.perf_counter()
        while rounds_run < num_rounds and not stopped:
            timed = bool(plan)
            length = plan.pop(0) if timed else min(chunk,
                                                   num_rounds - rounds_run)
            tc = time.perf_counter()
            if self.selects:
                states, dt, chunk_sims = self._upload_masks(length,
                                                            rounds_run)
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
            if self.selects:
                sims += chunk_sims[:live]
            rounds_run += live
            if stopped and self.selects:
                self.key, self.pstate = states[live]
        if self.cuda:
            torch.cuda.synchronize(self.device)
        wall = time.perf_counter() - t0

        history = {k: torch.cat([c[k] for c in chunks]).cpu().numpy()
                   for k in self.hist}
        if sims:
            history["sim_time"] = _stack(sims)
        flat = dict(self.st, rng=self.key)
        for k in self.counters:
            flat[k] = int(self.st[k])
        return RoundResult(unflatten_state(self.algo, flat, self.spec),
                           history, rounds_run, stopped, wall, capture,
                           chunk_size=chunk, draw_s=draw,
                           policy_state=self.pstate, stale=self.stale)


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
                      participation, cap, packed, stale=None):
    """Host-driven round loop of ``run_rounds(store="offload")``
    (counterpart of the reference's `_run_offload_loop`, without its
    quorum and checkpoint branches).

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

    hist, sims, stopped, pstate_run = [], [], False, None
    t0 = time.perf_counter()
    aset_h = stage(0, 0)
    for i in range(num_rounds):
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
        out, met = algo.round_flat_active(dict(gstate, **state_tiles),
                                          round_batch, spec, aset,
                                          stale=stale, donate_kernel=True)
        if stale is not None:
            met = _with_staleness_metrics(met, stale)
        tiles = {k: out.pop(k) for k in keys}
        if anchor_h is not None and population:
            tiles["anchor"] = stale.anchor
        gstate = out
        pstate_run = pstate
        now = _sim_time(participation, pstate)
        if now is not None:
            sims.append(now)
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
        if not population:
            store.scatter_tiles(aset_h, back)
            if refresh is not None:
                # the active store's row select, on the host copy
                anchor_h[refresh.cpu()] = stale.anchor.cpu()
        copy += time.perf_counter() - tc
        hist.append(met)
        if tol > 0 and float(met[tol_metric]) < tol:
            stopped = True
            break
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
    return RoundResult(unflatten_state(algo, state, spec),
                       _history(hist, sims), len(hist), stopped, wall,
                       draw_s=draw, policy_state=pstate_run, extras=extras,
                       stale=stale)
