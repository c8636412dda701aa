"""Async (stale-x̄) rounds on the port (mirrors tests/test_async.py, and
the async tests of tests/test_store.py; the sharded test is in
tests/test_torch_sharded_async.py).

Within the port:
  * `max_staleness=0` is BITWISE the synchronous masked run, for all five
    algorithms, in the chunked driver and the legacy loop;
  * the per-round `staleness` never exceeds the bound, reaches it under a
    slow arrival process, and follows the hand-computed pattern;
  * chunked and legacy async runs agree BIT FOR BIT, also to an eq. (35)
    stop, where both return the policy's and the stale state at the stop;
  * under the active store the state and the staleness history are
    bitwise the dense store's, and the offload store's bitwise the active
    store's (the host applies the anchor refresh);
  * the views write the static stale buffers in place, and the FedGiA
    round hands its per-client (m, N) anchor to the fused update.

Against the reference, on the same arrival masks (the periodic trace,
which both packages draw bit for bit): `staleness`, `staleness_max`,
`selected` and `cr` exactly; `f_xbar`, `grad_sq_norm` and the final
state at rtol 1e-5, atol 1e-6 (XLA:CPU fuses a*b+c into one FMA, the
port rounds the two apart: ROADMAP queue 3 item f).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core import selection as jax_selection
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.benchmarks import async_bench
from repro_torch.config import FedConfig
from repro_torch.core import api
from repro_torch.core import fedgia as fedgia_mod
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    UniformParticipation,
    make_policy,
)
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt

M, N, D, ROUNDS, CHUNK = 8, 20, 400, 12, 5
RTOL, ATOL = 1e-5, 1e-6

# tests/test_async.py's set-ups
ALGO_SETUPS = {
    "fedgia": dict(algorithm="fedgia", sigma_t=0.2, h_policy="scalar",
                   alpha=1.0),
    "fedgia_diag": dict(algorithm="fedgia", sigma_t=0.2, h_policy="diag_ema",
                        alpha=1.0),
    "fedavg": dict(algorithm="fedavg", lr=0.01),
    "fedprox": dict(algorithm="fedprox", lr=0.002, prox_mu=1e-4,
                    inner_steps=3),
    "fedpd": dict(algorithm="fedpd", lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(algorithm="scaffold", lr=0.01),
}
# the metrics that agree between stores for every algorithm (f_xbar and
# grad_sq_norm are participant means under the active store)
COMPARABLE = ("selected", "cr", "local_grad_evals", "staleness",
              "staleness_max", "sim_time")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the problems are tiny, and the suite's other
    workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _make(raw, key):
    model = LeastSquares(N)
    fed = FedConfig(num_clients=M, k0=3, **ALGO_SETUPS[key])
    algo = make_algorithm(fed, model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _bounded(res):
    """last_used <= max_staleness in every round of an async run."""
    if res.stale is not None:
        assert (res.history["staleness"] <= res.stale.max_staleness).all()


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _arrival_policy(horizon=ROUNDS, periods=None):
    if periods is None:
        periods = 1 + (np.arange(M) % 3)  # speeds 1, 2, 3 rounds
    return AvailabilityParticipation.from_periods(M, periods, horizon=horizon)


def _assert_bitwise(res, ref, what, keys=None):
    """Bitwise state and history (`keys`: only those of the history; the
    res side may carry more, the staleness of an async run)."""
    _bounded(res)
    assert res.rounds_run == ref.rounds_run, what
    assert res.stopped_early == ref.stopped_early, what
    for k in (ref.history if keys is None else keys):
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=f"{what}/{k}")
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{what}: state[{k}]"


# ---------------------------------------------------------- within the port
@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
def test_zero_staleness_is_bitwise_identical(raw, algo_key, scan):
    """async max_staleness=0 == the synchronous masked run, bit for bit."""
    algo, state, batch = _make(raw, algo_key)
    pol = UniformParticipation(M, 0.5, seed=7)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     participation=pol)
    res = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     participation=pol, async_rounds=True, max_staleness=0)
    assert set(res.history) == set(ref.history) | {"staleness",
                                                   "staleness_max"}
    _assert_bitwise(res, ref, algo_key)
    np.testing.assert_array_equal(res.history["staleness"], 0)
    np.testing.assert_array_equal(res.history["staleness_max"], 0)


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("max_staleness", [1, 3])
def test_bounded_staleness_invariant(raw, algo_key, max_staleness):
    """s <= max_staleness for every client and round; the bound is hit
    when the arrivals are slower than it (the force-sync path runs)."""
    algo, state, batch = _make(raw, algo_key)
    periods = np.full(M, 6)
    periods[0] = 1  # one client every round: no empty arrival row
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=_arrival_policy(periods=periods),
                     async_rounds=True, max_staleness=max_staleness)
    st = res.history["staleness"]
    assert st.shape == (ROUNDS, M) and st.dtype == np.int32
    assert (st <= max_staleness).all(), f"{algo_key}: bound broken"
    assert st.max() == max_staleness, "bound never reached"
    np.testing.assert_array_equal(res.history["staleness_max"],
                                  st.max(axis=1))
    assert (res.stale.last_used.numpy() <= max_staleness).all()


def test_arrival_staleness_sequence(raw):
    """Periodic arrivals give the hand-computed pattern: round 0
    force-syncs everyone (s = 0), then a period-p client cycles
    s = ((t - 1) mod p) + 1."""
    algo, state, batch = _make(raw, "fedavg")
    periods = np.array([1, 2, 4, 1, 2, 4, 1, 2])
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=_arrival_policy(periods=periods),
                     async_rounds=True, max_staleness=8)
    st = res.history["staleness"]
    t = np.arange(ROUNDS)
    for i, p in enumerate(periods):
        np.testing.assert_array_equal(
            st[:, i], np.where(t == 0, 0, ((t - 1) % p) + 1),
            err_msg=f"client {i} (period {p})")


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_async_chunked_matches_legacy_loop_bitwise(raw, algo_key):
    """Nonzero staleness: the same stale state threads both drivers, bit
    for bit (the reference holds its two at rtol 1e-5)."""
    algo, state, batch = _make(raw, algo_key)
    pol = _arrival_policy()
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=pol, async_rounds=True, max_staleness=2)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=False,
                     participation=pol, async_rounds=True, max_staleness=2)
    assert res.rounds_run == ROUNDS
    assert set(res.history) == set(ref.history)
    _assert_bitwise(res, ref, algo_key)
    for f in ("anchor", "age", "last_used"):
        assert torch.equal(getattr(res.stale, f), getattr(ref.stale, f)), f
    assert res.history["staleness_max"].max() == 2


def test_async_requires_arrival_process(raw):
    algo, state, batch = _make(raw, "fedgia")
    with pytest.raises(ValueError, match="participation"):
        run_rounds(algo, state, batch, 2, async_rounds=True, max_staleness=1)
    with pytest.raises(ValueError, match="max_staleness"):
        run_rounds(algo, state, batch, 2, participation=_arrival_policy(),
                   async_rounds=True, max_staleness=-1)


def test_async_early_stop_agrees(raw):
    """The eq. (35) stop composes with the stale state: both drivers stop
    at the same round, bit for bit, with the stale state of the stop."""
    algo, state, batch = _make(raw, "fedgia")
    pol = _arrival_policy(horizon=300)
    ref = run_rounds(algo, state, batch, 300, tol=1e-7, scan=False,
                     participation=pol, async_rounds=True, max_staleness=2)
    res = run_rounds(algo, state, batch, 300, tol=1e-7, chunk_size=13,
                     participation=pol, async_rounds=True, max_staleness=2)
    assert ref.stopped_early and res.stopped_early
    assert res.rounds_run % 13 != 0
    assert len(res.history["staleness"]) == res.rounds_run
    _assert_bitwise(res, ref, "stop")
    for f in ("anchor", "age", "last_used"):
        assert torch.equal(getattr(res.stale, f), getattr(ref.stale, f)), f
    np.testing.assert_array_equal(res.stale.last_used.numpy(),
                                  res.history["staleness"][-1])


def test_views_write_the_static_buffers_in_place():
    """The dense view writes the round's anchors into `view` and the
    refreshed views into `anchor`, the scalars in place, and allocates
    no (m, N) tensor that the state keeps; at max_staleness 0 it selects
    nothing and returns the stride-0 broadcast."""
    m, n = 4, 8
    x0, x1 = torch.zeros(n), torch.ones(n)
    st = api.init_stale_xbar(x0, m, 2)
    ptrs = (st.anchor.data_ptr(), st.view.data_ptr(), st.age.data_ptr(),
            st.last_used.data_ptr())
    view, st2 = api.stale_xbar_view(st, x0, torch.ones(m, dtype=torch.bool))
    assert st2 is st and view.data_ptr() == ptrs[1]
    mask = torch.tensor([True, False, False, True])
    view, _ = api.stale_xbar_view(st, x1, mask)
    assert (st.anchor.data_ptr(), st.view.data_ptr(), st.age.data_ptr(),
            st.last_used.data_ptr()) == ptrs
    np.testing.assert_array_equal(st.last_used.numpy(), [1, 1, 1, 1])
    assert torch.equal(view, torch.zeros(m, n))  # round 1 ran on x̄⁰
    np.testing.assert_array_equal(st.age.numpy(), [1, 2, 2, 1])
    np.testing.assert_array_equal(st.anchor[:, 0].numpy(), [1, 0, 0, 1])
    fresh = api.init_stale_xbar(x0, m, 0)
    view, _ = api.stale_xbar_view(fresh, x1, mask)
    assert view.stride() == (0, 1) and fresh.view is None
    np.testing.assert_array_equal(fresh.age.numpy(), 1)


def test_active_view_hands_back_fresh_xbar_under_offload():
    """Under the offloaded store the view gathers nothing (the tile is
    the engine's) and returns the fresh x̄ as the anchor, for the host
    to write into the refreshed rows."""
    m, n, cap = 6, 8, 3
    mask = torch.tensor([False, True, False, True, True, False])
    st = api.init_stale_xbar(torch.zeros(n), m, 1, resident=False)
    st.age.copy_(torch.tensor([1, 1, 2, 2, 1, 1], dtype=torch.int32))
    tile = torch.arange(cap * n, dtype=torch.float32).reshape(cap, n)
    st.anchor = tile
    aset = pt.make_active_set(mask, cap, tile_state=True)
    xbar = torch.full((n,), -1.0)
    anchor_t, st = api.stale_xbar_view_active(st, xbar, aset)
    assert st.anchor is xbar
    # client 3 (tile row 1) is past the bound: force-synced to x̄
    assert torch.equal(anchor_t[0], tile[0]) and torch.equal(anchor_t[2],
                                                              tile[2])
    assert torch.equal(anchor_t[1], xbar)
    np.testing.assert_array_equal(st.last_used.numpy(), [1, 1, 0, 0, 1, 1])
    np.testing.assert_array_equal(st.age.numpy(), [2, 1, 1, 1, 1, 2])


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
def test_fedgia_hands_the_per_client_anchor_to_the_update(raw, h_policy,
                                                          monkeypatch):
    """An async FedGiA round with max_staleness > 0 runs the fused update
    on the (m, N) stale anchor (the kernel's per-client form on the
    card), and at max_staleness 0 on the (N,) x̄."""
    seen = []
    real = fedgia_mod.fedgia_update_flat

    def spy(xbar, *args, **kwargs):
        seen.append(tuple(xbar.shape))
        return real(xbar, *args, **kwargs)

    monkeypatch.setattr(fedgia_mod, "fedgia_update_flat", spy)
    algo, state, batch = _make(raw, "fedgia" if h_policy == "scalar"
                               else "fedgia_diag")
    for ms, want in ((2, (M, 128)), (0, (128,))):
        seen.clear()
        run_rounds(algo, state, batch, 3, scan=False,
                   participation=_arrival_policy(), async_rounds=True,
                   max_staleness=ms)
        assert seen == [want] * 3, (ms, seen)


# ------------------------------------------------------------- the stores
def _store_equiv(res, ref, algo, what):
    """Active or offload (res) against dense or active (ref): bitwise
    state and comparable metrics; all of FedGiA's history."""
    full = getattr(algo, "active_tile", "participants") == "population"
    keys = ref.history if full else [k for k in ref.history
                                     if k in COMPARABLE]
    assert set(res.history) == set(ref.history), what
    _assert_bitwise(res, ref, what, keys)


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("kind", ["periodic", "uniform"])
def test_active_matches_dense_async(raw, algo_key, kind):
    """The ages stay dense, the anchor tile is gathered with the force
    refresh, and the resident anchor takes one row select a round:
    bitwise the dense async run, staleness history included (uniform:
    a tile of 4 of the 8 clients)."""
    algo, state, batch = _make(raw, algo_key)
    pol = make_policy(kind, M, 0.5, seed=3, horizon=ROUNDS)
    kw = dict(participation=pol, async_rounds=True, max_staleness=2,
              chunk_size=CHUNK)
    ref = run_rounds(algo, state, batch, ROUNDS, store="dense", **kw)
    res = run_rounds(algo, state, batch, ROUNDS, store="active", **kw)
    _store_equiv(res, ref, algo, f"{algo_key}/{kind}")
    assert torch.equal(res.stale.anchor, ref.stale.anchor)


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_offload_matches_active_async(raw, algo_key):
    """The stale anchor in host memory, the refresh write applied by the
    host: bitwise the active async run, and the final anchor too."""
    algo, state, batch = _make(raw, algo_key)
    kw = dict(participation=make_policy("uniform", M, 0.5, seed=3),
              async_rounds=True, max_staleness=2)
    ref = run_rounds(algo, state, batch, ROUNDS, store="active", **kw)
    res = run_rounds(algo, state, batch, ROUNDS, store="offload", **kw)
    _assert_bitwise(res, ref, algo_key)
    assert torch.equal(res.stale.anchor, ref.stale.anchor)
    m, n = ref.stale.anchor.shape
    assert res.extras["host_resident_bytes"] >= m * n * 4


@pytest.mark.parametrize("store", ["active", "offload"])
def test_stores_zero_staleness(raw, store):
    """max_staleness 0: no anchor is read or written, still bitwise."""
    algo, state, batch = _make(raw, "fedpd")
    kw = dict(participation=make_policy("periodic", M), async_rounds=True,
              max_staleness=0)
    ref = run_rounds(algo, state, batch, ROUNDS,
                     store="dense" if store == "active" else "active", **kw)
    res = run_rounds(algo, state, batch, ROUNDS, store=store, **kw)
    _store_equiv(res, ref, algo, store)


@pytest.mark.parametrize("algo_key", ["fedavg", "scaffold"])
@pytest.mark.parametrize("store", ["active", "offload"])
def test_stores_clocked_weighted(raw, algo_key, store):
    """Clock arrivals (a tile of m) with poly weights: the dense weights
    enter eq. (11) as the same masked (m,) vector, bitwise."""
    algo, state, batch = _make(raw, algo_key)
    kw = dict(clock=ComputeClock(M, 1.0 + (np.arange(M) % 3)),
              max_staleness=3, stale_weighting="poly", stale_decay=0.5)
    ref = run_rounds(algo, state, batch, ROUNDS,
                     store="dense" if store == "active" else "active", **kw)
    res = run_rounds(algo, state, batch, ROUNDS, store=store, **kw)
    _store_equiv(res, ref, algo, store)
    assert res.clock_state is not None and res.policy_state is None


def test_packed_weighted_matches_dense_fp(raw):
    """The weighted packed sum gathers the dense weights by row id:
    fp-equal to the dense-layout weighted aggregate."""
    algo, state, batch = _make(raw, "fedavg")
    kw = dict(store="active", max_staleness=3, stale_weighting="poly",
              stale_decay=0.5)
    clk = ComputeClock(M, 1.0 + (np.arange(M) % 3))
    ref = run_rounds(algo, state, batch, ROUNDS, clock=clk, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, clock=clk,
                     aggregate="packed", **kw)
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)


# -------------------------------------------------- against the reference
@pytest.fixture(scope="module")
def reference(raw):
    """One reference run per (algorithm, max_staleness) under the
    periodic arrivals (periods 1, 2, 3), in its legacy loop (one compiled
    round; its chunked driver agrees with it at rtol 1e-5)."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    cache = {}

    def get(algo_key, max_staleness):
        if (algo_key, max_staleness) not in cache:
            jmodel = JaxLeastSquares(N)
            jalgo = jax_make_algorithm(
                JaxFedConfig(num_clients=M, k0=3, **ALGO_SETUPS[algo_key]),
                jmodel.loss, model=jmodel)
            jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                                jax.random.PRNGKey(1), init_batch=jb)
            cache[algo_key, max_staleness] = jax_run_rounds(
                jalgo, jstate, jb, ROUNDS, scan=False,
                participation=jax_selection.AvailabilityParticipation
                .from_periods(M, 1 + (np.arange(M) % 3), horizon=ROUNDS),
                async_rounds=True, max_staleness=max_staleness)
        return cache[algo_key, max_staleness]

    return get


def assert_matches_reference(got, want, what):
    """The parity rule: counts and staleness exact, the rest rtol 1e-5."""
    _bounded(got)
    assert got.rounds_run == want.rounds_run, what
    assert set(got.history) == set(want.history), what
    for k in ("staleness", "staleness_max", "selected", "cr", "sim_time"):
        if k in want.history:
            np.testing.assert_array_equal(got.history[k], want.history[k],
                                          err_msg=f"{what}/{k}")
    for k in ("f_xbar", "grad_sq_norm"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}/{k}")
    for key, leaf in _leaves(got.state):
        k = key.split(".")[0]
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(want.state[k]["x"]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: state[{key}]")


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("max_staleness", [0, 2])
def test_reference_parity(raw, reference, algo_key, max_staleness):
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=_arrival_policy(), async_rounds=True,
                     max_staleness=max_staleness)
    assert_matches_reference(got, reference(algo_key, max_staleness),
                             f"{algo_key}/s{max_staleness}")


def test_async_bench_rows_match_reference(monkeypatch):
    """`async_bench.run` on the CPU against the reference's, on a cut
    sweep (FedGiA_D at bound 2, 40 rounds): the same row, CR and
    staleness equal, Obj at rel 1e-3."""
    from benchmarks import async_bench as jax_async_bench

    for mod in (async_bench, jax_async_bench):
        monkeypatch.setattr(mod, "STALENESS", [2])
        monkeypatch.setattr(mod, "MAX_ROUNDS", 40)
        monkeypatch.setattr(mod, "ALGOS", {"fedgia_d": mod.ALGOS["fedgia_d"]})
    got, want = async_bench.run("cpu"), jax_async_bench.run()
    async_bench.check(got)
    assert len(got) == len(want) == 1 and got[0]["converged"]
    for g, w in zip(got, want):
        for k in ("algo", "max_staleness", "staleness_seen", "cr",
                  "converged"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=1e-3)


def test_engine_bench_async_row_runs_small():
    """engine_bench's async row (`run_async`) on the CPU, cut to 16
    rounds, one run a path: the bound holds and the row carries both
    paths' walls."""
    from repro_torch.benchmarks import engine_bench

    row = engine_bench.run_async("cpu", 16, 1)
    assert row["staleness_seen"] == 2
    assert row["rounds"] == 16
    assert row["device"] == "cpu" and np.isfinite(row["f_xbar"])
    assert row["wall_s"] > 0 and row["sync_wall_s"] > 0
