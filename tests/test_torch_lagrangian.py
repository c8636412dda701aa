"""L(Zᵏ) of eq. (7) on the port (`FedGiA.lagrangian`) and the paper's
results stated with it (mirrors tests/test_fedgia_convergence.py's
Lemma IV.1 and Theorem IV.3 tests and tests/test_property.py's
Lagrangian property).

* `lagrangian` against the reference's on the same states (the
  reference's rounds, carried across with `state_from_numpy`): rtol 1e-5
  (float32 losses and dots summed in another order).
* Lemma IV.1 on the port's own per-leaf rounds: with sigma >= 6 r / m
  and H = r I, L(Zᵏ) never increases, within 1e-6.
* Theorem IV.3's rate bound min_j ||∇f(x̄ʲ)||² <= 100 m sigma k0
  (L(Z⁰) - f*) / k, with f* from the centralised least-squares optimum.
* The hypothesis property of tests/test_property.py (random problems, any
  k0 and alpha): L never increases by more than 1e-5 relative, on 4
  examples (the reference runs 15; each is a few eager rounds here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, make_client_batches, to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils.convert import state_from_numpy

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

M, N, D = 8, 30, 640  # tests/test_fedgia_convergence.py's problem
LAG_RTOL = 1e-5
DESCENT_ATOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(3, D, N, M)


def centralized_optimum(raw, m):
    """The minimiser of f = (1/m) Σ f_i and its value (numpy float64)."""
    A, b, msk = raw["A"], raw["b"], raw["mask"]
    rows, w, bs = [], [], []
    for i in range(m):
        di = msk[i].sum()
        rows.append(A[i][msk[i] > 0])
        bs.append(b[i][msk[i] > 0])
        w.append(np.full(int(di), 1.0 / (m * di)))
    A_, w_, b_ = np.concatenate(rows), np.concatenate(w), np.concatenate(bs)
    H = (A_ * w_[:, None]).T @ A_
    x = np.linalg.solve(H, (A_ * w_[:, None]).T @ b_)
    return x, 0.5 * float(np.sum(w_ * (A_ @ x - b_) ** 2))


def _algo(raw, seed=7, **kw):
    fed = dict(algorithm="fedgia", num_clients=M, k0=5, alpha=0.5,
               sigma_t=6.0, h_policy="scalar", collapsed=True)
    fed.update(kw)
    model = LeastSquares(N)
    algo = make_algorithm(FedConfig(**fed), model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(seed), init_batch=batch)
    return algo, state, batch


def test_lagrangian_matches_reference(raw):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(algorithm="fedgia", num_clients=M, k0=5, alpha=0.5,
                     sigma_t=6.0, h_policy="scalar"), jmodel.loss,
        model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(7), init_batch=jb)
    algo, _, batch = _algo(raw)
    rnd = jax.jit(jalgo.round)
    for t in range(8):
        if t in (0, 1, 3, 7):
            want = float(jalgo.lagrangian(jstate, jb))
            state = state_from_numpy(jax.device_get(jstate), "cpu")
            got = float(algo.lagrangian(state, batch))
            np.testing.assert_allclose(got, want, rtol=LAG_RTOL,
                                       err_msg=f"round {t}")
        jstate, _ = rnd(jstate, jb)


def test_lagrangian_descent(raw):
    """Lemma IV.1: sigma >= 6 r / m and H = r I: L(Zᵏ) non-increasing."""
    algo, state, batch = _algo(raw)
    prev = float(algo.lagrangian(state, batch))
    for _ in range(30):
        state, _ = algo.round(state, batch)
        cur = float(algo.lagrangian(state, batch))
        assert cur <= prev + DESCENT_ATOL, f"L increased: {prev} -> {cur}"
        prev = cur


def test_lagrangian_descent_through_the_engine(raw):
    """The same descent over the engine's per-leaf rounds, one call a
    round (the chunked driver and the key it carries)."""
    algo, state, batch = _algo(raw)
    prev = float(algo.lagrangian(state, batch))
    for _ in range(10):
        state = run_rounds(algo, state, batch, 1, flat=False).state
        cur = float(algo.lagrangian(state, batch))
        assert cur <= prev + DESCENT_ATOL, f"L increased: {prev} -> {cur}"
        prev = cur


def test_theorem_iv3_rate_bound(raw):
    """min_j |grad f(x^tau_j)|^2 <= 100 m sigma k0 (L(Z^0) - f*) / k."""
    _, f_star = centralized_optimum(raw, M)
    k0 = 5
    algo, state, batch = _algo(raw, k0=k0)
    L0 = float(algo.lagrangian(state, batch))
    sigma = float(state["sigma"])
    best = np.inf
    for t in range(40):
        state, met = algo.round(state, batch)
        best = min(best, float(met["grad_sq_norm"]))
        k = (t + 1) * k0
        bound = 100 * M * sigma * k0 * max(L0 - f_star, 0.0) / k
        assert best <= bound + 1e-8, f"rate bound violated at k={k}"


def _problem(seed, m=6, n=12, d=120):
    r = np.random.default_rng(seed)
    A = r.standard_normal((d, n)).astype(np.float32)
    x_star = r.standard_normal(n).astype(np.float32)
    b = (A @ x_star + 0.05 * r.standard_normal(d)).astype(np.float32)
    batch = make_client_batches({"A": A, "b": b}, [d // m] * m)
    return LeastSquares(n), to_torch(batch, "cpu")


@given(seed=st.integers(0, 2**16), k0=st.integers(1, 8),
       alpha=st.sampled_from([0.25, 0.5, 1.0]))
@settings(max_examples=4, deadline=None)
def test_lagrangian_never_increases(seed, k0, alpha):
    """Lemma IV.1 for random problems, any k0 and selection fraction."""
    model, batch = _problem(seed)
    fed = FedConfig(algorithm="fedgia", num_clients=6, k0=k0, alpha=alpha,
                    sigma_t=6.0, h_policy="scalar")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init("cpu"), prng_key(seed), init_batch=batch)
    prev = float(algo.lagrangian(state, batch))
    for _ in range(6):
        state, _ = algo.round(state, batch)
        cur = float(algo.lagrangian(state, batch))
        assert cur <= prev + 1e-5 * max(1.0, abs(prev))
        prev = cur
