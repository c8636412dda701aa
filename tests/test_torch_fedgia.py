"""The port's FedGiA round and its primitives against the JAX package's.

Both sides start from the same state (`utils.convert.state_from_numpy` of
the JAX state) and take the same branch masks, drawn with numpy and fed
through `round_flat(..., mask=)`: JAX's threefry stream has no torch
counterpart (hazard a).

Hazard c: with the collapsed closed form and a diagonal H the port runs
the kernel's form, so it is held to the JAX round with the Pallas kernel
in interpret mode (`use_kernel=True, kernel_interpret=True`); the gram and
unrolled rounds are held to the JAX jnp round. Tolerance rtol 1e-5 / atol
1e-6 per round: float32 gradients reduced in another order and XLA:CPU's
FMA contraction (see test_torch_fedgia_update.py), a few ulps each.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import hparams as jax_hparams
from repro.core import make_algorithm
from repro.core import selection as jax_selection
from repro.core.engine import flatten_state as jax_flatten
from repro.data import linreg_noniid
from repro.models import LeastSquares as JaxLeastSquares
from repro.utils import pytree as jpt
from repro_torch.config import FedConfig
from repro_torch.core import api, hparams, selection
from repro_torch.core.prng import prng_key
from repro_torch.core.engine import flatten_state
from repro_torch.core.fedgia import FedGiA
from repro_torch.data import to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt
from repro_torch.utils.convert import params_from_numpy, state_from_numpy

M, N, D = 8, 20, 400
RTOL, ATOL = 1e-5, 1e-6
POLICIES = {
    "scalar": dict(h_policy="scalar", collapsed=True),
    "diag_ema": dict(h_policy="diag_ema", collapsed=True),
    "gram": dict(h_policy="gram", collapsed=False),
    "unrolled": dict(h_policy="diag_ema", collapsed=False),
}


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _pair(raw, k0=3, sigma_t=0.2, alpha=0.5, **kw):
    """(jax algo, jax state, port algo, port state) from one JAX init."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jfed = JaxFedConfig(algorithm="fedgia", num_clients=M, k0=k0,
                        alpha=alpha, sigma_t=sigma_t, use_kernel=True,
                        kernel_interpret=True, **kw)
    jalgo = make_algorithm(jfed, jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    model = LeastSquares(N)
    fed = FedConfig(num_clients=M, k0=k0, alpha=alpha, sigma_t=sigma_t, **kw)
    algo = FedGiA(fed, model.loss, model=model)
    state = state_from_numpy(jax.device_get(jstate), "cpu")
    return jalgo, jstate, jb, algo, state, to_torch(raw, "cpu")


def _masks(rounds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        s = rng.uniform(size=M) < 0.5
        s[rng.integers(M)] = True
        out.append(s)
    return out


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


# ------------------------------------------------------------- primitives
def test_sigma_and_diag_h_match_reference():
    rng = np.random.default_rng(0)
    h = rng.uniform(0.0, 2.0, (M, 128)).astype(np.float32)
    g = (rng.standard_normal((M, 128)) * 0.1).astype(np.float32)
    r = np.float32(1.7)
    want = jax_hparams.update_diag_h(jnp.asarray(h), jnp.asarray(g),
                                     jnp.asarray(r), M)
    got = hparams.update_diag_h(torch.from_numpy(h), torch.from_numpy(g),
                                torch.tensor(r), M)
    _close(got, want, "update_diag_h", rtol=1e-6, atol=1e-7)
    assert float(hparams.sigma_from(0.15, torch.tensor(r), M)) == \
        float(jnp.float32(jax_hparams.sigma_from(0.15, jnp.asarray(r), M)))


@pytest.mark.parametrize("m", [1, 7, 16, 100])
@pytest.mark.parametrize("alpha", [1e-9, 0.1, 0.5, 0.99, 1.0])
def test_selection_counts_match_reference(m, alpha):
    assert selection.num_selected(m, alpha) == jax_selection.num_selected(m, alpha)
    mask = selection.selection_mask(prng_key(0), m, alpha)
    assert mask.dtype == torch.bool and mask.shape == (m,)
    assert int(mask.sum()) == selection.num_selected(m, alpha)


def test_selection_stream_is_seeded_and_full_selection_draws_nothing():
    """The split is a function of the key and the round alone; the key
    splits every round, with every client selected too, as the
    reference's (fedgia.py:323-328)."""
    a = [selection.round_split(prng_key(3), 0, 64, 0.5) for _ in range(2)]
    assert np.array_equal(a[0][0], a[1][0]) and torch.equal(a[0][1],
                                                            a[1][1])
    key, m1 = selection.round_split(prng_key(3), 0, 64, 0.5)
    _, m2 = selection.round_split(key, 1, 64, 0.5)
    assert not torch.equal(m1, m2)  # the key advances per round
    key_all, m_all = selection.round_split(prng_key(3), 0, 64, 1.0)
    assert bool(m_all.all()) and np.array_equal(key_all, key)
    assert selection.round_split(prng_key(3), 0, 64, 0.5,
                                 draw=False)[1] is None


def test_api_primitives_match_reference():
    from repro.core import api as japi

    rng = np.random.default_rng(1)
    x = rng.standard_normal((M, 256)).astype(np.float32)
    y = rng.standard_normal((M, 256)).astype(np.float32)
    mask = rng.uniform(size=M) < 0.5
    tx, ty, tm = torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(mask)
    _close(api.client_mean(tx), japi.client_mean(jnp.asarray(x)), "mean",
           rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(
        api.masked_update(tm, tx, ty).numpy(),
        np.asarray(japi.masked_update(jnp.asarray(mask), jnp.asarray(x),
                                      jnp.asarray(y))))
    b = api.broadcast_clients(torch.from_numpy(x[0]), M)
    assert b.shape == (M, 256) and b.stride(0) == 0
    spec = pt.ravel_spec({"x": torch.zeros(200)})
    jspec = jpt.ravel_spec({"x": jnp.zeros(200)})
    g = np.pad(x[:, :200], ((0, 0), (0, 56)))
    _close(api.flat_grad_sq_norm(torch.from_numpy(g), spec),
           japi.flat_grad_sq_norm(jnp.asarray(g), jspec), "grad_sq_norm",
           rtol=1e-5, atol=0.0)


def test_params_and_state_from_numpy(raw):
    _, jstate, _, _, state, _ = _pair(raw, h_policy="diag_ema")
    host = jax.device_get(jstate)
    assert state["rng"].dtype == np.uint32
    np.testing.assert_array_equal(state["rng"], np.asarray(host["rng"]))
    assert state["round"] == 0 and isinstance(state["round"], int)
    for k in ("x", "z", "pi", "h"):
        np.testing.assert_array_equal(state[k]["x"].numpy(), host[k]["x"])
    # a copy, not a view of the numpy buffers
    arr = np.ones(3, np.float32)
    p = params_from_numpy({"a": {"b": arr}}, "cpu")
    arr[...] = 7.0
    assert torch.equal(p["a"]["b"], torch.ones(3))


# -------------------------------------------------------------------- init
@pytest.mark.parametrize("policy", ["scalar", "diag_ema", "gram"])
def test_init_matches_reference(raw, policy):
    _, jstate, _, algo, _, batch = _pair(raw, **POLICIES[policy])
    state = algo.init(LeastSquares(N).init("cpu"),
                      prng_key(1), init_batch=batch)
    _close(state["r"], jstate["r"], "r")
    _close(state["sigma"], jstate["sigma"], "sigma")
    for k in ("x", "z", "pi"):
        np.testing.assert_array_equal(state[k]["x"].numpy(),
                                      np.asarray(jstate[k]["x"]))
    if policy == "diag_ema":
        _close(state["h"]["x"], jstate["h"]["x"], "h")
    if policy == "gram":
        _close(state["gram_chol"], jstate["gram_chol"], "gram_chol",
               rtol=1e-5, atol=1e-5)
    assert state["z"]["x"].data_ptr() != state["pi"]["x"].data_ptr()


def test_auto_lipschitz_matches_reference(raw):
    """`auto_lipschitz` was refused until `hparams.estimate_lipschitz` was
    ported; it now probes each client from split(rng, m) and keeps the
    max, as the reference: r and sigma at rtol 1e-4 (the reference's
    float32 vdots lose ~1e-5, tests/test_torch_train_arch.py). Without an
    init batch there is nothing to probe, and the model's own r stays
    out too, as in the reference."""
    fed = FedConfig(num_clients=M, auto_lipschitz=True)
    algo = FedGiA(fed, LeastSquares(N).loss, model=LeastSquares(N))
    batch = to_torch(raw, "cpu")
    state = algo.init(LeastSquares(N).init("cpu"), prng_key(1),
                      init_batch=batch)
    jmodel = JaxLeastSquares(N)
    jstate = make_algorithm(JaxFedConfig(num_clients=M, auto_lipschitz=True),
                            jmodel.loss, model=jmodel).init(
        jmodel.init(jax.random.PRNGKey(0)), jax.random.PRNGKey(1),
        init_batch={k: jnp.asarray(v) for k, v in raw.items()})
    for k in ("r", "sigma"):
        np.testing.assert_allclose(float(state[k]), float(jstate[k]),
                                   rtol=1e-4, err_msg=k)
    assert float(algo.init(LeastSquares(N).init("cpu"),
                           prng_key(1))["r"]) == fed.lipschitz


# ------------------------------------------------------------- round_flat
def _run_pair(raw, rounds, donate=False, **kw):
    jalgo, jstate, jb, algo, state, batch = _pair(raw, **kw)
    jspec = jpt.ravel_spec(jstate["x"])
    spec = pt.ravel_spec(state["x"])
    js = jax_flatten(jalgo, jstate, jspec)
    ts = flatten_state(algo, state, spec)
    for mask in _masks(rounds):
        js, jmet = jalgo.round_flat(js, jb, jspec, mask=jnp.asarray(mask))
        ts, tmet = algo.round_flat(ts, batch, spec, mask=torch.from_numpy(mask),
                                   donate_kernel=donate)
    return js, jmet, ts, tmet


@pytest.mark.parametrize("policy", list(POLICIES))
def test_round_flat_matches_reference(raw, policy):
    js, jmet, ts, tmet = _run_pair(raw, 3, **POLICIES[policy])
    keys = ["x", "z", "pi"] + (["h"] if "h" in js else [])
    for k in keys:
        _close(ts[k], js[k], f"{policy}: state[{k!r}]")
    assert ts["round"] == int(js["round"]) == 3
    for k in ("f_xbar", "grad_sq_norm", "cr", "local_grad_evals", "selected"):
        _close(float(tmet[k]), float(jmet[k]), f"{policy}: {k}")
    # the key splits every round, with an engine mask too
    np.testing.assert_array_equal(ts["rng"], np.asarray(js["rng"]))


@pytest.mark.parametrize("policy", list(POLICIES))
def test_round_flat_own_split_matches_reference(raw, policy):
    """No mask injected: each side draws FedGiA's α = 0.5 split from its
    own key chain (split, then fold_in of the round), the same clients
    bit for bit, so the state follows the reference's at the per-round
    tolerance."""
    jalgo, jstate, jb, algo, state, batch = _pair(raw, **POLICIES[policy])
    jspec = jpt.ravel_spec(jstate["x"])
    spec = pt.ravel_spec(state["x"])
    js = jax_flatten(jalgo, jstate, jspec)
    ts = flatten_state(algo, state, spec)
    for r in range(3):
        _, sel_key = jax.random.split(js["rng"])
        want = jax_selection.selection_mask(
            jax.random.fold_in(sel_key, js["round"]), M, 0.5)
        _, got = selection.round_split(ts["rng"], ts["round"], M, 0.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        js, jmet = jalgo.round_flat(js, jb, jspec)
        ts, tmet = algo.round_flat(ts, batch, spec)
        assert float(tmet["selected"]) == float(jmet["selected"]) == M // 2
        np.testing.assert_array_equal(ts["rng"], np.asarray(js["rng"]))
        for k in ["x", "z", "pi"] + (["h"] if "h" in js else []):
            _close(ts[k], js[k], f"{policy} round {r}: state[{k!r}]")


@pytest.mark.parametrize("policy", ["scalar", "diag_ema"])
def test_round_flat_donated_matches_reference(raw, policy):
    """The donation trap: under diag_ema the H refresh reads ḡ after the
    update. A donated ḡ would hold z' by then (the CPU plain version of
    the donated wrapper writes into its inputs, as the kernel does), and
    h would drift from the reference."""
    js, _, ts, _ = _run_pair(raw, 3, donate=True, **POLICIES[policy])
    for k in ["z", "pi"] + (["h"] if policy == "diag_ema" else []):
        _close(ts[k], js[k], f"donated {policy}: state[{k!r}]")


def test_donated_round_consumes_the_input_pi(raw):
    _, _, _, algo, state, batch = _pair(raw, **POLICIES["scalar"])
    spec = pt.ravel_spec(state["x"])
    ts = flatten_state(algo, state, spec)
    pi_in = ts["pi"]
    new, _ = algo.round_flat(ts, batch, spec, donate_kernel=True)
    assert new["pi"].data_ptr() == pi_in.data_ptr()
    assert torch.equal(pi_in, new["pi"])


@pytest.mark.parametrize("policy", ["scalar", "diag_ema"])
def test_kernel_args_are_what_round_flat_updates_with(raw, policy):
    """`round_inputs` + `kernel_args` hand out the fused update's
    arguments for the next round (the kernel check on the card takes its
    inputs from them): the update on them is round_flat's, bitwise. ḡ and
    π are contiguous (m, N) float32; the anchor is the round's (N,) x̄,
    not a broadcast copy; h is the (m, N) buffer under diag_ema and the
    0-d r under the scalar policy; round_flat asks for no x'."""
    from repro_torch.kernels.fedgia_update import fedgia_update_flat

    _, _, _, algo, state, batch = _pair(raw, **POLICIES[policy])
    spec = pt.ravel_spec(state["x"])
    ts = flatten_state(algo, state, spec)
    probe = dict(ts, rng=state["rng"].copy())
    xbar, sel, _, _, gbar = algo.round_inputs(probe, batch, spec)
    *args, k0 = algo.kernel_args(probe, xbar, gbar, sel)
    assert k0 == algo.fed.k0 and args[6] == M
    N = spec.padded_size
    h_shape = (M, N) if policy == "diag_ema" else ()
    for t, shape in zip(args[:4], ((N,), (M, N), (M, N), h_shape)):
        assert t.shape == shape and t.is_contiguous()
        assert t.dtype == torch.float32
    assert args[0] is xbar and sel.dtype == torch.bool
    x_new, pi_new, z_new = fedgia_update_flat(*args, k0=k0, want_x=False)
    assert x_new is None
    new, _ = algo.round_flat(dict(ts, rng=state["rng"].copy()), batch,
                             spec)
    assert torch.equal(new["pi"], pi_new) and torch.equal(new["z"], z_new)


# ------------------------------------------------- algorithm invariants
def _flat_port(raw, **kw):
    model = LeastSquares(N)
    algo = FedGiA(FedConfig(num_clients=M, **kw), model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1),
                      init_batch=batch)
    spec = pt.ravel_spec(state["x"])
    return algo, flatten_state(algo, state, spec), batch, spec


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
@pytest.mark.parametrize("sigma_t", [0.15, 6.0])
@pytest.mark.parametrize("k0", [1, 2, 7])
def test_collapsed_equals_unrolled(raw, k0, sigma_t, h_policy):
    """The closed-form round is the k0-step iteration (mirrors
    tests/test_fedgia_math.py, same tolerances)."""
    kw = dict(k0=k0, sigma_t=sigma_t, h_policy=h_policy, alpha=0.5)
    algo_c, s_c, batch, spec = _flat_port(raw, collapsed=True, **kw)
    algo_u, s_u, _, _ = _flat_port(raw, collapsed=False, **kw)
    for mask in _masks(3, seed=k0):
        s_c, met_c = algo_c.round_flat(s_c, batch, spec, mask=torch.from_numpy(mask))
        s_u, met_u = algo_u.round_flat(s_u, batch, spec, mask=torch.from_numpy(mask))
    for k in ["z", "pi", "x"] + (["h"] if h_policy == "diag_ema" else []):
        _close(s_c[k], s_u[k], k, rtol=1e-5, atol=1e-6)
    _close(float(met_c["f_xbar"]), float(met_u["f_xbar"]), "f", rtol=1e-6,
           atol=0.0)


def test_gd_branch_equations_and_client_params(raw):
    """eqs (15)-(17): non-selected clients get pi = -ḡ, z = x̄ - ḡ/σ; and
    x_i = z_i - pi_i/σ inverts eq. (14)."""
    algo, s, batch, spec = _flat_port(raw, h_policy="scalar", alpha=0.5)
    xbar = s["z"].mean(0)
    _, grads = algo._vg(spec.unravel(xbar), batch)
    gbar = spec.ravel_stacked(grads) * (1.0 / M)
    mask = torch.zeros(M, dtype=torch.bool)
    mask[0] = True
    new, met = algo.round_flat(s, batch, spec, mask=mask)
    sigma = s["sigma"]
    torch.testing.assert_close(new["pi"][1:], -gbar[1:])
    torch.testing.assert_close(new["z"][1:], xbar - gbar[1:] / sigma,
                               rtol=1e-5, atol=1e-7)
    assert int(met["selected"]) == 1 and met["cr"] == 2.0
    xc = algo.client_params(new)
    torch.testing.assert_close((1.0 / sigma) * new["pi"] + xc, new["z"],
                               rtol=1e-5, atol=1e-6)
