"""The port's comparison baselines (FedAvg, FedProx, FedPD, SCAFFOLD)
against the JAX package's, at the sizes of tests/test_baselines.py.

Both sides start from the same state (zeros: x̄, FedPD's duals,
SCAFFOLD's variates) on the same numpy data, and take the same masks,
drawn with numpy where a test injects them.

Tolerances. Port and reference are not bitwise (ROADMAP queue 3, item
f): XLA:CPU contracts `x - lr*g` into one FMA, `log2` of the
learning-rate schedule may round apart, and the batched gradient sums in
another order. One round is held at rtol 1e-5 / atol 1e-6, as FedGiA's
(tests/test_torch_fedgia.py). A whole run is held to the same
`rounds_run` and f at rel 1e-5, at a tol that the stop metric crosses
steeply (it falls 2-130 % a round there, far more than port and
reference differ in it). The chunked driver is held to the legacy loop
bit for bit.
"""
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import api as jax_api
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core.engine import flatten_state as jax_flatten
from repro.data import linreg_noniid
from repro.models import LeastSquares as JaxLeastSquares
from repro.utils import pytree as jpt
from repro_torch.config import FedConfig
from repro_torch.core import api
from repro_torch.core.baselines.common import lr_schedule
from repro_torch.core.engine import flatten_state, run_rounds
from repro_torch.core.fedgia import FedGiA
from repro_torch.core.prng import prng_key
from repro_torch.data import to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
M, N, D = 8, 20, 400
RTOL, ATOL = 1e-5, 1e-6
# tests/test_baselines.py's hyper-parameters
HP = {
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0),
    "scaffold": dict(lr=0.01),
}
BASELINES = list(HP)
# whole runs to the eq. (35) stop: (hyper-parameters, tol, rounds it takes)
STOPS = {
    "fedavg": (dict(lr=0.01), 1e-3, 398),
    "fedprox": (dict(lr=0.01), 1e-4, 74),
    "fedpd": (dict(lr=0.01), 1e-2, 34),
    "scaffold": (dict(lr=0.01), 1e-3, 396),
}
STATE_KEYS = {"fedavg": ("x",), "fedprox": ("x",), "fedpd": ("x", "lam"),
              "scaffold": ("x", "c", "ci")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its problems are small (tens
    of clients of ~100 rows), where more threads only spin, and the
    suite's other workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _jax(raw, name, **kw):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(algorithm=name, num_clients=M, k0=5, alpha=1.0, **kw),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    return jalgo, jstate, jb


def _port(raw, name, **kw):
    model = LeastSquares(N)
    algo = api.make_algorithm(
        FedConfig(algorithm=name, num_clients=M, k0=5, alpha=1.0, **kw),
        model.loss, model=model)
    batch = to_torch(raw, "cpu")
    return algo, algo.init(model.init("cpu"), prng_key(1)), batch


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    if torch.is_tensor(got):
        got = got.numpy()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


def _masks(rounds, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(rounds):
        s = rng.uniform(size=M) < 0.5
        s[rng.integers(M)] = True
        out.append(s)
    return out


# ------------------------------------------------------------- one round
@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
@pytest.mark.parametrize("name", BASELINES)
def test_round_flat_matches_reference(raw, name, masked):
    """Three rounds on each side, state carried across, each round's state
    and metrics held to the reference's."""
    jalgo, jstate, jb = _jax(raw, name, **HP[name])
    algo, state, batch = _port(raw, name, **HP[name])
    jspec, spec = jpt.ravel_spec(jstate["x"]), pt.ravel_spec(state["x"])
    js = jax_flatten(jalgo, jstate, jspec)
    ts = flatten_state(algo, state, spec)
    masks = _masks(3) if masked else [None] * 3
    for r, mask in enumerate(masks):
        js, jmet = jalgo.round_flat(
            js, jb, jspec, mask=None if mask is None else jnp.asarray(mask))
        ts, tmet = algo.round_flat(
            ts, batch, spec,
            mask=None if mask is None else torch.from_numpy(mask))
        for k in STATE_KEYS[name]:
            _close(ts[k], js[k], f"{name} round {r}: state[{k!r}]")
        for k in ("f_xbar", "grad_sq_norm", "selected", "cr",
                  "local_grad_evals"):
            _close(float(tmet[k]), float(jmet[k]), f"{name} round {r}: {k}")
        assert ts["round"] == int(js["round"]) == r + 1
        assert ts["step"] == int(js["step"]) == 5 * (r + 1)


@pytest.mark.parametrize("name", BASELINES)
def test_masked_out_clients_are_frozen_and_left_out(raw, name):
    """A mask freezes a client's duals / variates and drops its upload:
    the round with only client 0 aggregates client 0's trajectory."""
    algo, state, batch = _port(raw, name, **HP[name])
    spec = pt.ravel_spec(state["x"])
    ts = flatten_state(algo, state, spec)
    mask = torch.zeros(M, dtype=torch.bool)
    mask[0] = True
    new, met = algo.round_flat(ts, batch, spec, mask=mask)
    full, _ = algo.round_flat(ts, batch, spec)
    assert float(met["selected"]) == 1.0
    assert not torch.equal(new["x"], full["x"])
    for key in set(STATE_KEYS[name]) - {"x", "c"}:
        assert torch.equal(new[key][1:], ts[key][1:])
        assert not torch.equal(new[key][0], ts[key][0])


# ------------------------------------------------------------- whole runs
@pytest.mark.parametrize("name", BASELINES)
def test_run_rounds_matches_reference_to_the_stop(raw, name):
    hp, tol, rounds = STOPS[name]
    jalgo, jstate, jb = _jax(raw, name, **hp)
    want = jax_run_rounds(jalgo, jstate, jb, 500, tol=tol)
    algo, state, batch = _port(raw, name, **hp)
    got = run_rounds(algo, state, batch, 500, tol=tol)
    assert want.stopped_early and got.stopped_early
    assert got.rounds_run == want.rounds_run == rounds
    np.testing.assert_allclose(got.history["f_xbar"][-1],
                               want.history["f_xbar"][-1], rtol=1e-5)
    assert got.history["grad_sq_norm"][-1] < tol
    _close(got.state["x"]["x"], want.state["x"]["x"], f"{name}: x",
           rtol=1e-4, atol=1e-5)
    assert got.state["step"] == int(want.state["step"]) == 5 * rounds
    assert isinstance(got.state["step"], int)


@pytest.fixture(scope="module")
def legacy(raw):
    """Each baseline's legacy run of 10 rounds with tol 0, and the tol
    that stops it after 7: halfway between round 7's |grad|^2 and the
    smallest of the 6 before it."""
    out = {}
    for name in BASELINES:
        algo, state, batch = _port(raw, name, **HP[name])
        res = run_rounds(algo, state, batch, 10, scan=False)
        g = res.history["grad_sq_norm"]
        assert g[6] < g[:6].min()
        out[name] = res, 0.5 * (g[6] + g[:6].min())
    return out


def _assert_bitwise(res, ref, name):
    assert res.rounds_run == ref.rounds_run
    assert res.stopped_early == ref.stopped_early
    assert set(res.history) == set(ref.history)
    for k, v in ref.history.items():
        assert res.history[k].dtype == v.dtype, k
        np.testing.assert_array_equal(res.history[k], v, err_msg=k)
    for k in STATE_KEYS[name]:
        assert torch.equal(res.state[k]["x"], ref.state[k]["x"]), k
    for k in ("round", "step"):
        assert res.state[k] == ref.state[k] and isinstance(res.state[k], int)
    assert np.array_equal(res.state["rng"],
                          ref.state["rng"])


@pytest.mark.parametrize("stop", [False, True], ids=["tol0", "tol"])
@pytest.mark.parametrize("name", BASELINES)
def test_chunked_matches_legacy_loop_bitwise(raw, legacy, name, stop):
    """Three chunks of 4 (the last one short, or frozen after the stop):
    the learning rates read the device counter `step`, so a chunk that
    reused its first round's rates would drift here."""
    algo, state, batch = _port(raw, name, **HP[name])
    ref, tol = legacy[name]
    if stop:
        ref = run_rounds(algo, state, batch, 10, tol=tol, scan=False)
        assert ref.stopped_early and ref.rounds_run == 7
    res = run_rounds(algo, state, batch, 10, tol=tol if stop else 0.0,
                     chunk_size=4)
    _assert_bitwise(res, ref, name)
    # the baselines draw nothing: the run's generator is the caller's
    assert np.array_equal(res.state["rng"],
                          state["rng"])


def test_chunked_driver_passes_no_mask_to_the_baselines(raw, monkeypatch):
    """Only an algorithm that selects in the round gets masks; the
    baselines' rounds see mask=None (full participation) at any alpha."""
    algo, state, batch = _port(raw, "fedavg", **HP["fedavg"])
    algo.fed = FedConfig(algorithm="fedavg", num_clients=M, alpha=0.5)
    seen = []
    real = algo.round_flat

    def spy(*args, **kwargs):
        seen.append(kwargs.get("mask"))
        return real(*args, **kwargs)

    monkeypatch.setattr(algo, "round_flat", spy)
    res = run_rounds(algo, state, batch, 5, chunk_size=2)
    assert seen and all(m is None for m in seen)
    assert (res.history["selected"] == M).all()
    assert FedGiA.selects_in_round and not hasattr(algo, "selects_in_round")


# ------------------------------------------------------------- primitives
def test_lr_schedule_matches_reference():
    for k in (0, 1, 5, 37, 4999):
        want = float(jnp.float32(0.05) / jnp.log2(jnp.float32(k) + 2.0))
        for arg in (k, torch.tensor(k)):
            got = lr_schedule(0.05, arg)
            assert got.dtype == torch.float32 and got.dim() == 0
            np.testing.assert_allclose(float(got), want, rtol=1.2e-7)


def test_client_mean_masked_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((M, 2 * pt.LANES)).astype(np.float32)
    mask = _masks(1, seed=3)[0]
    got = api.client_mean(torch.from_numpy(x), mask=torch.from_numpy(mask))
    want = jax_api.client_mean(jnp.asarray(x), mask=jnp.asarray(mask))
    _close(got, want, "masked mean", rtol=1e-6, atol=1e-7)
    everyone = api.client_mean(torch.from_numpy(x),
                               mask=torch.ones(M, dtype=torch.bool))
    _close(everyone, api.client_mean(torch.from_numpy(x)), "all-True mask",
           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("masked", [False, True], ids=["full", "masked"])
def test_flat_round_aggregate_matches_reference(masked):
    rng = np.random.default_rng(4)
    tree = {"a": np.zeros((3, 5), np.float32), "b": np.zeros((7,), np.float32)}
    jspec = jpt.ravel_spec({k: jnp.asarray(v) for k, v in tree.items()})
    spec = pt.ravel_spec({k: torch.from_numpy(v) for k, v in tree.items()})
    n = spec.padded_size
    contrib, grads, extra = (rng.standard_normal((M, n)).astype(np.float32)
                             for _ in range(3))
    grads[:, spec.size:] = 0.0
    losses = rng.uniform(size=M).astype(np.float32)
    mask = _masks(1, seed=4)[0] if masked else None
    sel = (mask if masked else np.ones(M, bool)).astype(np.float32)
    got = api.flat_round_aggregate(
        *(torch.from_numpy(a) for a in (contrib, grads, losses, sel)), spec,
        mask=None if mask is None else torch.from_numpy(mask),
        extra_mean=torch.from_numpy(extra))
    want = jax_api.flat_round_aggregate(
        *(jnp.asarray(a) for a in (contrib, grads, losses, sel)), jspec,
        mask=None if mask is None else jnp.asarray(mask),
        extra_mean=jnp.asarray(extra))
    assert len(got) == len(want) == 5
    for what, g, w in zip(("agg", "gsq", "f_mean", "n_sel", "extra"), got,
                          want):
        _close(g, w, what, rtol=1e-6, atol=1e-6)


def test_stacked_gradient_agrees_with_shared_on_a_broadcast_anchor(raw):
    """On a broadcast anchor the per-client-params form agrees
    with the shared one to float32 rounding (rtol 1e-6, atol 1e-5 at
    gradients of ~20), not bit for bit: `A @ x` becomes a batched product."""
    model = LeastSquares(N)
    batch = to_torch(raw, "cpu")
    x = {"x": torch.from_numpy(
        np.random.default_rng(5).standard_normal(N).astype(np.float32))}
    l1, g1 = api.per_client_value_and_grad(model.loss)(x, batch)
    l2, g2 = api.per_client_value_and_grad_stacked(model.loss)(
        api.broadcast_clients(x, M), batch)
    assert g2["x"].shape == (M, N)
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(g2["x"], g1["x"], rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name", ["fedgia"] + BASELINES)
def test_make_algorithm_dispatches(name):
    model = LeastSquares(N)
    algo = api.make_algorithm(FedConfig(algorithm=name, num_clients=M),
                              model.loss, model=model)
    assert algo.name == name and algo.fed.algorithm == name
    assert type(algo).__module__.startswith("repro_torch.core.")


def test_unknown_algorithm_is_refused():
    with pytest.raises(ValueError, match="unknown algorithm"):
        FedConfig(algorithm="fedsgd")
    with pytest.raises(KeyError, match="fedsgd"):
        api.make_algorithm(types.SimpleNamespace(algorithm="fedsgd"),
                           LeastSquares(N).loss)


# ----------------------------------- mirrors of tests/test_baselines.py
def rounds_to_tol(raw, name, tol=1e-6, max_rounds=1500, **kw):
    """The port's counterpart of tests/test_baselines.py::rounds_to_tol:
    (rounds, first f, (last f, last |grad|^2)), through the legacy loop."""
    model = LeastSquares(N)
    algo = api.make_algorithm(
        FedConfig(algorithm=name, num_clients=M, k0=5, alpha=1.0, **kw),
        model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    res = run_rounds(algo, state, batch, max_rounds, tol=tol, scan=False)
    h = res.history
    return (res.rounds_run, float(h["f_xbar"][0]),
            (float(h["f_xbar"][-1]), float(h["grad_sq_norm"][-1])))


@pytest.mark.parametrize("name", BASELINES)
def test_baseline_decreases_objective(raw, name):
    rounds, first, last = rounds_to_tol(raw, name, tol=1e-6, max_rounds=400,
                                        **HP[name])
    assert last[0] < first, f"{name}: no objective decrease {first} -> {last[0]}"
    assert last[1] < 1e-1, f"{name}: gradient did not shrink: {last}"


@pytest.fixture(scope="module")
def fedavg_to_1e9(raw):
    """FedAvg (lr 0.01) to |grad|^2 < 1e-9 or 1500 rounds, shared by the two
    tests below: the legacy loop is deterministic, so the run to 1e-8 is
    this run's prefix."""
    model = LeastSquares(N)
    algo = api.make_algorithm(
        FedConfig(algorithm="fedavg", num_clients=M, k0=5, lr=0.01),
        model.loss, model=model)
    batch = to_torch(raw, "cpu")
    return run_rounds(algo, algo.init(model.init("cpu"), prng_key(1)),
                      batch, 1500, tol=1e-9, scan=False).history


def test_fedgia_fewer_rounds_than_fedavg(raw, fedavg_to_1e9):
    """Paper Table IV: FedGiA's CR are an order of magnitude below FedAvg's."""
    r_gia, _, l_gia = rounds_to_tol(raw, "fedgia", tol=1e-8, sigma_t=0.2,
                                    h_policy="scalar")
    below = np.flatnonzero(fedavg_to_1e9["grad_sq_norm"] < 1e-8)
    r_avg = int(below[0]) + 1 if len(below) else 1500
    assert l_gia[1] < 1e-8
    assert r_gia * 5 < r_avg, f"FedGiA {r_gia} rounds vs FedAvg {r_avg}"


def test_all_algorithms_agree_on_optimum(raw, fedavg_to_1e9):
    """Every algorithm drives f to the same value (paper: identical Obj.)."""
    finals = {"fedavg": float(fedavg_to_1e9["f_xbar"][-1])}
    for name, kw in [("fedgia", dict(sigma_t=0.2)),
                     ("scaffold", dict(lr=0.01))]:
        _, _, last = rounds_to_tol(raw, name, tol=1e-9, max_rounds=1500, **kw)
        finals[name] = last[0]
    vals = list(finals.values())
    assert max(vals) - min(vals) < 1e-4, finals


# ------------------------------------------------------------- the CLI
@pytest.mark.parametrize("name", BASELINES)
def test_cli_matches_reference_cli(name):
    """`--algo X --device cpu`: the reference CLI's `done:` rounds, and its
    final f at rel 1e-5 (the CLI's lr is 0.01 for every baseline)."""
    from repro.launch import train as jax_train

    _, tol, rounds = STOPS[name]
    argv = ["--algo", name, "--clients", "8", "--dim", "20", "--samples",
            "400", "--rounds", "500", "--tol", str(tol)]
    want = jax_train.train(jax_train.build_parser().parse_args(argv))
    got = train_mod.main(argv + ["--device", "cpu"])
    assert got["algo"] == name and got["stopped_early"]
    assert got["rounds"] == want["rounds"] == rounds
    assert got["cr"] == want["cr"]
    np.testing.assert_allclose(got["final_f"], want["final_f"], rtol=1e-5)


def test_cli_runs_a_baseline_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--algo", "scaffold", "--lr", "0.02", "--clients", "8", "--dim",
         "20", "--samples", "400", "--rounds", "5", "--tol", "0"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "done: 5 rounds (CR=10)" in out.stderr
