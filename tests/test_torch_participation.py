"""In-engine participation on the port (mirrors tests/test_participation.py,
with its client-sharded test in tests/test_torch_sharded_async.py).

  * alpha = 1: a policy's all-True mask is bitwise the run without one,
    for all five algorithms, in the chunked driver and the legacy loop;
  * alpha < 1: the chunked driver and the legacy loop draw the same masks
    from the policy and agree BIT FOR BIT (state, history, the policy's
    final state), also to an eq. (35) stop, where the chunked driver puts
    the policy's state back to the stop's;
  * masked-out clients keep their per-client state and their data is not
    read by the aggregate;
  * against the reference: each package draws its own uniform masks
    from the same seed (the port's threefry chain, `core/prng.py`, gives
    the reference's masks bit for bit), and the reference's masks
    stacked into a (T, m) trace are run by BOTH packages under
    `AvailabilityParticipation(m, trace)`; every
    round's metrics and the final state are held at the port's per-round
    tolerances (rtol 1e-5, atol 1e-6: XLA:CPU's fused multiply-adds,
    ROADMAP queue 3 item f).
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
from repro.data import linreg_noniid
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core import prng
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    CyclicParticipation,
    UniformParticipation,
    make_policy,
)
from repro_torch.data import to_torch
from repro_torch.models import LeastSquares

M, N, D, ROUNDS, CHUNK = 8, 20, 400, 12, 5
RTOL, ATOL = 1e-5, 1e-6

# tests/test_participation.py's set-ups: FedGiA at alpha = 1, so the run
# without a policy IS full participation
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


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, what):
    assert res.rounds_run == ref.rounds_run, what
    assert res.stopped_early == ref.stopped_early, what
    assert set(res.history) == set(ref.history), what
    for k, v in ref.history.items():
        np.testing.assert_array_equal(res.history[k], v,
                                      err_msg=f"{what}/{k}")
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{what}: state[{k}]"
    assert np.array_equal(res.state["rng"], ref.state["rng"]), what


def _same_key(a, b):
    return np.array_equal(a["key"], b["key"])


def _split_times(key, n):
    for _ in range(n):
        key = prng.split(key)[0]
    return key


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
def test_alpha1_policy_is_bitwise_no_policy(raw, algo_key, scan):
    algo, state, batch = _make(raw, algo_key)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK)
    res = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     participation=UniformParticipation(M, 1.0, seed=9))
    _assert_bitwise(res, ref, algo_key)
    np.testing.assert_array_equal(res.history["selected"], float(M))


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_masked_chunked_matches_legacy_loop_bitwise(raw, algo_key):
    """alpha = 0.5: the same policy masks in both drivers, bit for bit,
    every algorithm (the baselines get masks only from the policy).
    FedGiA's own key splits once a round under the policy too, as the
    reference's; the baselines' is left alone."""
    algo, state, batch = _make(raw, algo_key)
    pol = UniformParticipation(M, 0.5, seed=3)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=pol)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=False,
                     participation=pol)
    assert res.rounds_run == ROUNDS
    _assert_bitwise(res, ref, algo_key)
    np.testing.assert_array_equal(res.history["selected"], 4.0)
    assert _same_key(res.policy_state, ref.policy_state)
    splits = ROUNDS if algo_key.startswith("fedgia") else 0
    assert np.array_equal(res.state["rng"],
                          _split_times(state["rng"], splits))
    assert res.draw_s > 0 and ref.draw_s > 0


def test_policy_masks_reach_every_round(raw, monkeypatch):
    """Round t of a call takes the policy's mask for t, counted from 0 in
    every call, in both drivers; the warm-up draws nothing."""
    algo, state, batch = _make(raw, "fedavg")
    pol = CyclicParticipation(M, 0.25)
    for scan in (True, False):
        seen = []
        real = algo.round_flat

        def spy(*args, **kwargs):
            seen.append(kwargs["mask"].clone())
            return real(*args, **kwargs)

        monkeypatch.setattr(algo, "round_flat", spy)
        run_rounds(algo, state, batch, 6, scan=scan, chunk_size=4,
                   participation=pol)
        monkeypatch.undo()
        if scan:
            assert seen[0].all()  # the warm-up's every-client round
            seen = seen[1:]
        want = [pol.mask((), t)[0] for t in range(6)]
        assert len(seen) == 6
        for got, w in zip(seen, want):
            assert torch.equal(got, w)


@pytest.mark.parametrize("algo_key,state_key",
                         [("scaffold", "ci"), ("fedpd", "lam")])
def test_frozen_clients_keep_local_state(raw, algo_key, state_key):
    algo, state, batch = _make(raw, algo_key)
    pol = UniformParticipation(M, 0.25, seed=1)
    mask0 = pol.mask(pol.init(), 0)[0].numpy()
    assert mask0.sum() == 2
    res = run_rounds(algo, state, batch, 1, scan=False, participation=pol)
    before = state[state_key]["x"].numpy()
    after = res.state[state_key]["x"].numpy()
    np.testing.assert_array_equal(after[~mask0], before[~mask0])
    assert not np.allclose(after[mask0], before[mask0])


def test_server_state_ignores_frozen_clients(raw):
    algo, state, batch = _make(raw, "fedavg")
    pol = CyclicParticipation(M, 0.5)  # round 0 freezes clients 4..7
    res = run_rounds(algo, state, batch, 1, scan=False, participation=pol)
    poisoned = {k: v.clone() for k, v in batch.items()}
    for v in poisoned.values():
        v[M // 2:] *= 100.0
    res2 = run_rounds(algo, state, poisoned, 1, scan=False, participation=pol)
    assert torch.equal(res.state["x"]["x"], res2.state["x"]["x"])


@pytest.mark.parametrize("kind", ["uniform", "straggler"])
def test_masked_early_stop_agrees(raw, kind):
    """The eq. (35) stop under a policy: the chunked driver (chunks of 13,
    rounds after the stop frozen) and the legacy loop stop at the same
    round, bit for bit, and return the policy's state at the stop."""
    algo, state, batch = _make(raw, "fedgia")
    pol = make_policy(kind, M, 0.5, seed=0, horizon=300)
    ref = run_rounds(algo, state, batch, 300, tol=1e-7, scan=False,
                     participation=pol)
    res = run_rounds(algo, state, batch, 300, tol=1e-7, chunk_size=13,
                     participation=pol)
    assert ref.stopped_early and res.stopped_early
    assert res.rounds_run % 13 != 0
    assert len(res.history["grad_sq_norm"]) == res.rounds_run
    _assert_bitwise(res, ref, kind)
    if kind == "uniform":
        want = pol.init()
        for t in range(ref.rounds_run):
            want = pol.mask(want, t)[1]
        assert _same_key(res.policy_state, want)
        assert _same_key(ref.policy_state, want)


@pytest.fixture(scope="module")
def reference_trace():
    """The reference's UniformParticipation(M, 0.5, seed=2) masks of
    ROUNDS rounds, drawn in JAX, as a (ROUNDS, M) trace."""
    pol = jax_selection.UniformParticipation(M, 0.5, seed=2)
    ps, rows = pol.init(), []
    for r in range(ROUNDS):
        mask, ps = pol.mask(ps, jnp.int32(r))
        rows.append(np.asarray(mask))
    trace = np.stack(rows)
    assert (trace.sum(axis=1) == 4).all()
    return trace


def _reference_run(raw, algo_key, participation):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(num_clients=M, k0=3, **ALGO_SETUPS[algo_key]),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    return jax_run_rounds(jalgo, jstate, jb, ROUNDS, chunk_size=CHUNK,
                          participation=participation)


def _hold_per_round(got, want, algo_key):
    assert got.rounds_run == want.rounds_run == ROUNDS
    for k in ("f_xbar", "grad_sq_norm", "selected", "cr"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{algo_key}/{k}")
    for key, leaf in _leaves(got.state):
        k = key.split(".")[0]
        np.testing.assert_allclose(
            leaf.numpy(), np.asarray(want.state[k]["x"]), rtol=RTOL,
            atol=ATOL, err_msg=f"{algo_key}: state[{key}]")
    np.testing.assert_array_equal(got.state["rng"],
                                  np.asarray(want.state["rng"]))


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_own_uniform_draws_match_reference(raw, algo_key):
    """No injected masks: each package draws UniformParticipation(M, 0.5,
    seed=2) itself. The masks are the same bit for bit (`selected` is
    compared too), so every round is held at the per-round tolerances,
    and the final policy state is the reference's key."""
    want = _reference_run(raw, algo_key,
                          jax_selection.UniformParticipation(M, 0.5, seed=2))
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=UniformParticipation(M, 0.5, seed=2))
    np.testing.assert_array_equal(got.history["selected"], 4.0)
    _hold_per_round(got, want, algo_key)
    ref_key = jax.random.PRNGKey(2)
    for _ in range(ROUNDS):
        ref_key = jax.random.split(ref_key)[0]
    np.testing.assert_array_equal(got.policy_state["key"],
                                  np.asarray(ref_key))


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_reference_trace_parity(raw, reference_trace, algo_key):
    """Both packages under AvailabilityParticipation(M, reference trace):
    the same masks on both sides, every round's metrics and the final
    state held at the per-round tolerances."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(num_clients=M, k0=3, **ALGO_SETUPS[algo_key]),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    want = jax_run_rounds(
        jalgo, jstate, jb, ROUNDS, chunk_size=CHUNK,
        participation=jax_selection.AvailabilityParticipation(
            M, reference_trace))
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=AvailabilityParticipation(
                         M, reference_trace))
    assert got.rounds_run == want.rounds_run == ROUNDS
    np.testing.assert_array_equal(got.history["selected"], 4.0)
    for k in ("f_xbar", "grad_sq_norm", "selected", "cr"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{algo_key}/{k}")
    for key, leaf in _leaves(got.state):
        k = key.split(".")[0]
        np.testing.assert_allclose(
            leaf.numpy(), np.asarray(want.state[k]["x"]), rtol=RTOL,
            atol=ATOL, err_msg=f"{algo_key}: state[{key}]")
