"""Overlapped eq. (11) collectives on the port (`run_rounds(overlap=
"scatter")`; mirrors tests/test_overlap.py).

The overlapped round splits eq. (11) across the round boundary: the
round takes its consensus from the carry slot ``state["ovl_shard"]`` at
its top (an all-gather under a mesh) and ends by reducing its
contributions into the next slot (a reduce-scatter by columns).

In one process (the reference's single-device tests), within the port:
  * overlap="off" is the default run bit for bit, for all five
    algorithms;
  * overlap="scatter" is the barrier run BIT FOR BIT unsharded (the
    slot holds the mean the barrier round would form), for all five
    algorithms × sync / masked / async, chunked and legacy, also under
    random chunk sizes and straggler masks (hypothesis); the reference
    holds its own at rtol 1e-4 (two XLA programs), and the port's
    overlapped async runs are held to the reference's at rtol 1e-4,
    atol 1e-6;
  * the slot contract on two clients against a per-client loop.

On 8 gloo ranks against the reference's runs on 8 fake devices
(`torch_sharded.run_both`):
  * the overlapped sharded round issues ZERO model-size all-reduces, one
    reduce-scatter and one all-gather, five algorithms × sync / stale,
    counted from `torch.profiler`'s c10d events;
  * the overlapped sharded runs of the five algorithms, sync and async,
    match the reference's at rtol 1e-4, atol 1e-6;
  * a (pod 2, data 4) client axis is BITWISE the data=8 one, with and
    without overlap, and keeps the overlap budget.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import make_policy as jax_make_policy
from repro.core import run_rounds as jax_run_rounds
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.baselines.common import lr_schedule
from repro_torch.core.engine import flatten_state, run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt
from torch_sharded import assert_run_close, counts, run_both

M, N, D = 8, 20, 400
ROUNDS = 10

ALGO_SETUPS = {
    "fedgia_diag": dict(sigma_t=0.2, h_policy="diag_ema", alpha=0.5),
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002, prox_mu=1e-4, inner_steps=3),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(lr=0.01),
}
FIVE = list(ALGO_SETUPS)
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _kw(key):
    name = "fedgia" if key.startswith("fedgia") else key
    return dict(algorithm=name, num_clients=M, k0=3, **ALGO_SETUPS[key])


def _make(raw, key):
    model = LeastSquares(N)
    algo = make_algorithm(FedConfig(**_kw(key)), model.loss, model=model)
    batch = to_torch(raw, "cpu")
    return algo, algo.init(model.init("cpu"), prng_key(1),
                           init_batch=batch), batch


def _jax_make(raw, key):
    model = JaxLeastSquares(N)
    algo = jax_make_algorithm(JaxFedConfig(**_kw(key)), model.loss,
                              model=model)
    batch = {k: jnp.asarray(v) for k, v in raw.items()}
    return algo, algo.init(model.init(jax.random.PRNGKey(0)),
                           jax.random.PRNGKey(1), init_batch=batch), batch


def _mode_kwargs(mode, make=make_policy):
    if mode == "sync":
        return {}
    pol = make("straggler", M, 0.5, seed=0, drop_prob=0.3, horizon=ROUNDS)
    if mode == "masked":
        return dict(participation=pol)
    return dict(participation=pol, async_rounds=True, max_staleness=2)


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, what=""):
    assert res.rounds_run == ref.rounds_run
    assert set(res.history) == set(ref.history)
    for k in ref.history:
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=f"{what}/{k}")
    assert [k for k, _ in _leaves(res.state)] == [
        k for k, _ in _leaves(ref.state)]
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{what}: state[{k}]"


# ------------------------------------------------- in one process (unsharded)
@pytest.mark.parametrize("key", FIVE)
def test_overlap_off_bitwise_identical(raw, key):
    """overlap="off" is the run that never names overlap, bit for bit."""
    algo, state, batch = _make(raw, key)
    ref = run_rounds(algo, state, batch, ROUNDS)
    _assert_bitwise(run_rounds(algo, state, batch, ROUNDS, overlap="off"),
                    ref, key)


def test_overlap_validation(raw):
    """The reference's refusals, with its messages; the active store and
    the codecs overlap (tests/test_torch_sharded_uplink.py holds them)."""
    algo, state, batch = _make(raw, "fedgia_diag")
    with pytest.raises(ValueError, match="overlap"):
        run_rounds(algo, state, batch, 2, overlap="bogus")
    with pytest.raises(ValueError, match="overlap"):
        run_rounds(algo, state, batch, 2, overlap="scatter", flat=False)
    pol = make_policy("uniform", M, 0.5, seed=0)
    with pytest.raises(ValueError, match="offload"):
        run_rounds(algo, state, batch, 2, overlap="scatter",
                   participation=pol, store="offload")
    for kw in (dict(participation=pol, store="active"),
               dict(compression="int8")):
        res = run_rounds(algo, state, batch, 2, overlap="scatter", **kw)
        assert res.rounds_run == 2 and "ovl_shard" not in res.state


@pytest.mark.parametrize("mode", ["sync", "masked", "async"])
@pytest.mark.parametrize("key", FIVE)
def test_overlap_scatter_matches_barrier(raw, key, mode):
    """The overlapped run is the barrier run bit for bit, history and
    state, and the slot never leaks into the state; in the async mode
    (masks and stale anchors too) the port's overlapped run is held to
    the reference's at rtol 1e-4, atol 1e-6."""
    algo, state, batch = _make(raw, key)
    kw = _mode_kwargs(mode)
    ref = run_rounds(algo, state, batch, ROUNDS, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, overlap="scatter",
                     **_mode_kwargs(mode))
    assert "ovl_shard" not in res.state
    _assert_bitwise(res, ref, f"{key}/{mode}")
    if mode != "async":  # the barrier runs' parity is the other files'
        return
    jalgo, jstate, jbatch = _jax_make(raw, key)
    jres = jax_run_rounds(jalgo, jstate, jbatch, ROUNDS, overlap="scatter",
                          **_mode_kwargs(mode, jax_make_policy))
    for k in jres.history:
        np.testing.assert_allclose(res.history[k], jres.history[k],
                                   err_msg=k, **TOL)
    for a, b in zip(jax.tree.leaves(jres.state["x"]),
                    res.state["x"].values()):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("key", ["fedgia_diag", "scaffold"])
def test_overlap_scatter_legacy_loop(raw, key):
    """The legacy loop threads and folds the slot as the chunked driver
    does: bitwise the barrier loop."""
    algo, state, batch = _make(raw, key)
    ref = run_rounds(algo, state, batch, 6, scan=False)
    res = run_rounds(algo, state, batch, 6, scan=False, overlap="scatter")
    assert "ovl_shard" not in res.state
    _assert_bitwise(res, ref, key)


def test_overlap_slot_semantics_two_clients():
    """The slot contract on two FedAvg clients against a per-client loop
    of `torch.func.grad`: the round's anchor is the slot passed in (last
    round's consensus), the returned x IS that consensus (x lags a
    round), the new slot row is the mean of this round's trajectories,
    and f_xbar the mean loss at the consensus."""
    m, n, d = 2, 12, 64
    model = LeastSquares(n)
    batch = to_torch(linreg_noniid(3, d, n, m), "cpu")
    fed = FedConfig(algorithm="fedavg", num_clients=m, k0=2, lr=0.05)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    spec = pt.ravel_spec(state["x"])
    sf = flatten_state(algo, state, spec)
    tail = (torch.arange(spec.padded_size) < spec.size).float()
    consensus = torch.from_numpy(np.random.default_rng(7).standard_normal(
        spec.padded_size).astype(np.float32)) * tail
    sf["ovl_shard"] = consensus[None].clone()

    new_state, metrics = algo.round_flat(sf, batch, spec)
    assert torch.equal(new_state["x"], consensus)

    def client_loss(xv, i):
        cb = {k: v[i] for k, v in batch.items()}
        return model.loss(spec.unravel(xv), cb)[0]

    trajs, losses = [], []
    for i in range(m):
        xv = consensus
        losses.append(float(client_loss(xv, i)))
        for j in range(fed.k0):
            g = torch.func.grad(client_loss)(xv, i)
            xv = xv - lr_schedule(fed.lr, j) * g
        trajs.append(xv.numpy())
    np.testing.assert_allclose(new_state["ovl_shard"][0].numpy(),
                               np.mean(trajs, axis=0), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(metrics["f_xbar"]), np.mean(losses),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("key,chunk,seed,drop", [
    ("fedgia_diag", 1, 3, 0.6),
    ("scaffold", 3, 1, 0.3),
    ("fedpd", 5, 2, 0.0),
])
def test_overlap_tracks_barrier_fixed_draws(raw, key, chunk, seed, drop):
    """Chunk sizes and straggler mask patterns: bitwise the barrier."""
    algo, state, batch = _make(raw, key)
    pol = make_policy("straggler", M, 0.5, seed=seed, drop_prob=drop,
                      horizon=6)
    kw = dict(chunk_size=chunk, participation=pol)
    ref = run_rounds(algo, state, batch, 6, **kw)
    res = run_rounds(algo, state, batch, 6, overlap="scatter", **kw)
    assert "ovl_shard" not in res.state
    _assert_bitwise(res, ref, key)


def test_overlap_property_random_algo_chunk_mask(raw):
    """Property: for any (algorithm, chunk size, straggler mask) draw the
    overlapped run is the barrier run bit for bit."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    @settings(max_examples=15, deadline=None)
    @given(key=st.sampled_from(FIVE), chunk=st.sampled_from([0, 1, 3, 5]),
           seed=st.integers(min_value=0, max_value=4),
           drop=st.sampled_from([0.0, 0.3, 0.6]))
    def inner(key, chunk, seed, drop):
        algo, state, batch = _make(raw, key)
        pol = make_policy("straggler", M, 0.5, seed=seed, drop_prob=drop,
                          horizon=6)
        kw = dict(chunk_size=chunk, participation=pol)
        ref = run_rounds(algo, state, batch, 6, **kw)
        res = run_rounds(algo, state, batch, 6, overlap="scatter", **kw)
        _assert_bitwise(res, ref, f"{key}/{chunk}/{seed}/{drop}")

    inner()


# ------------------------------------------------------ on 8 gloo ranks
_JAX = '''
mesh8 = make_host_mesh(data=8)
meshp = make_host_mesh(pod=2, data=4)
for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
    algo, s0, batch = setup(name, k0=3, alpha=1.0, sigma_t=0.3,
                            h_policy="diag_ema", lr=0.01)
    put("ovl_sync_" + name, run_rounds(algo, s0, batch, 10, mesh=mesh8,
                                       overlap="scatter"))
    pol = make_policy("straggler", 8, 0.5, seed=0, drop_prob=0.3,
                      horizon=10)
    put("ovl_async_" + name, run_rounds(
        algo, s0, batch, 10, mesh=mesh8, overlap="scatter",
        participation=pol, async_rounds=True, max_staleness=2))
algo, s0, batch = setup("fedgia", k0=3, alpha=1.0, sigma_t=0.3,
                        h_policy="diag_ema")
put("pod_r8", run_rounds(algo, s0, batch, 10, mesh=mesh8))
put("pod_o8", run_rounds(algo, s0, batch, 10, mesh=mesh8, overlap="scatter"))
'''

_PORT = '''
def rank_fn(OUT):
    mesh8 = mesh_mod.make_host_mesh(data=8)
    for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
        algo, s0, batch = setup(name, k0=3, alpha=1.0, sigma_t=0.3,
                                h_policy="diag_ema", lr=0.01)
        spec = pt.ravel_spec(s0["x"])
        s0f = flatten_state(algo, s0, spec)
        rows = int(getattr(algo, "overlap_slot_rows", 1))
        s0f["ovl_shard"] = torch.zeros((rows, spec.padded_size))
        for stale in (False, True):
            rf = make_round_fn(algo, mesh8, masked=True, stale=stale,
                               flat_spec=spec, overlap="scatter")
            st, b = shard_inputs(algo, s0f, batch, mesh8)
            args = (st, b, torch.ones(8, dtype=torch.bool))
            if stale:
                args = args + (api.init_stale_xbar(s0f["x"], 1, 2),)
            OUT["budget/%s/%s" % (name, stale)] = budget(
                lambda: rf(*args), spec.padded_size)
        res = run_rounds(algo, s0, batch, 10, mesh=mesh8, overlap="scatter")
        put(OUT, "ovl_sync_" + name, res)
        replicated(OUT, "ovl_sync_" + name, res)
        pol = make_policy("straggler", 8, 0.5, seed=0, drop_prob=0.3,
                          horizon=10)
        res = run_rounds(algo, s0, batch, 10, mesh=mesh8, overlap="scatter",
                         participation=pol, async_rounds=True,
                         max_staleness=2)
        put(OUT, "ovl_async_" + name, res)
        replicated(OUT, "ovl_async_" + name, res)

    meshp = mesh_mod.make_host_mesh(pod=2, data=4)
    algo, s0, batch = setup("fedgia", k0=3, alpha=1.0, sigma_t=0.3,
                            h_policy="diag_ema")
    for tag, ov in (("r", "off"), ("o", "scatter")):
        put(OUT, "pod_%s8" % tag, run_rounds(algo, s0, batch, 10, mesh=mesh8,
                                             overlap=ov))
        put(OUT, "pod_%sp" % tag, run_rounds(
            algo, s0, batch, 10, mesh=meshp, client_axis=("pod", "data"),
            overlap=ov))
    spec = pt.ravel_spec(s0["x"])
    s0f = flatten_state(algo, s0, spec)
    s0f["ovl_shard"] = torch.zeros((1, spec.padded_size))
    rf = make_round_fn(algo, meshp, client_axis=("pod", "data"), masked=True,
                       flat_spec=spec, overlap="scatter")
    st, b = shard_inputs(algo, s0f, batch, meshp, ("pod", "data"))
    OUT["budget/pod"] = budget(
        lambda: rf(st, b, torch.ones(8, dtype=torch.bool)),
        spec.padded_size)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("overlap")), _JAX, _PORT,
                    world=8)


def _assert_overlap_budget(c):
    assert c["all_reduce_model"] == 0, c
    assert c["reduce_scatter"] == c["reduce_scatter_model"] == 1, c
    assert c["all_gather"] == c["all_gather_model"] == 1, c


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("name", ["fedgia", "fedavg", "fedprox", "fedpd",
                                  "scaffold"])
def test_overlap_matrix_collective_budget(runs, name, stale):
    """The overlapped sharded round: zero model-size all-reduces, one
    reduce-scatter, one all-gather (the matrix's active and int8 columns:
    tests/test_torch_sharded_uplink.py)."""
    _assert_overlap_budget(counts(runs[1][f"budget/{name}/{stale}"]))


@pytest.mark.parametrize("mode", ["sync", "async"])
@pytest.mark.parametrize("name", ["fedgia", "fedavg", "fedprox", "fedpd",
                                  "scaffold"])
def test_overlap_sharded_matches_reference(runs, name, mode):
    """The overlapped run on data=8 against the reference's on 8 fake
    devices at the reference's overlap tolerance (rtol 1e-4, atol 1e-6:
    SCAFFOLD's variates divide a cancelling difference by k0·lr, which
    lifts the reassociated sums' ulps past 1e-5), every rank alike."""
    ref, port = runs
    assert_run_close(port, ref, f"ovl_{mode}_{name}", **TOL)
    assert bool(port[f"ovl_{mode}_{name}/replicated"])


def test_pod_axis_bitwise_and_overlap_budget(runs):
    """A (pod 2, data 4) client axis is a re-layout of data=8: the same
    ranks in the same order, so the runs are bitwise, with and without
    overlap; the overlapped round keeps its budget over the compound
    axis; and the data=8 runs match the reference's."""
    ref, port = runs
    for tag in ("r", "o"):
        keys = [k for k in port if k.startswith(f"pod_{tag}8/")]
        assert keys
        for k in keys:
            np.testing.assert_array_equal(
                port[k.replace(f"pod_{tag}8/", f"pod_{tag}p/")], port[k],
                err_msg=k)
        assert_run_close(port, ref, f"pod_{tag}8", rtol=1e-5, atol=1e-6)
    _assert_overlap_budget(counts(port["budget/pod"]))
