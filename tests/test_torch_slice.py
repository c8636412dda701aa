"""The port's whole slice: run_rounds, the CLI and the package rules.

Whole-run parity runs at alpha = 1, where the branch split is all ones on
both sides, and at the paper's alpha = 0.5, where each side draws its own
split from the same threefry key chain (`core/prng.py`, the same clients
bit for bit), with the eq. (35) stop on. The
JAX side is `run_rounds` with `use_kernel=False` (its default on the
CPU). Both stop at the same round. The final f and x̄ agree at rtol 1e-4
(float32 noise accumulated over the run). The final |grad|^2 agrees at
rtol 1e-2: by the stop it is ~1e-9 of its first value, a sum of nearly
cancelling float32 terms, so its own relative error is ~1e-3.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.data import linreg_noniid
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch import device as device_mod
from repro_torch.config import FedConfig
from repro_torch.core.engine import flatten_state, run_rounds, unflatten_state
from repro_torch.core.fedgia import FedGiA
from repro_torch.core.prng import prng_key
from repro_torch.data import to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares
from repro_torch.utils.pytree import ravel_spec

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
M, N, D = 8, 20, 400
TOL = 1e-7


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _port(raw, alpha=1.0, **kw):
    model = LeastSquares(N)
    algo = FedGiA(FedConfig(num_clients=M, k0=5, alpha=alpha, sigma_t=0.2,
                            **kw), model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _reference_run(raw, alpha, h_policy):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = make_algorithm(
        JaxFedConfig(algorithm="fedgia", num_clients=M, k0=5, alpha=alpha,
                     sigma_t=0.2,
                     h_policy=h_policy, use_kernel=False),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    return jax_run_rounds(jalgo, jstate, jb, 300, tol=TOL)


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
def test_own_split_run_matches_reference_every_round(raw, h_policy, scan):
    """alpha = 0.5, no injected masks: the same clients every round, so
    the whole run is held to the alpha = 1 runs' tolerances (below) at
    EVERY round, not just the last, and the final key is the
    reference's."""
    want = _reference_run(raw, 0.5, h_policy)
    algo, state, batch = _port(raw, alpha=0.5, h_policy=h_policy)
    got = run_rounds(algo, state, batch, 300, tol=TOL, scan=scan)
    assert want.stopped_early and got.stopped_early
    assert got.rounds_run == want.rounds_run
    np.testing.assert_array_equal(got.history["selected"], M // 2)
    for k, rtol in (("f_xbar", 1e-4), ("grad_sq_norm", 1e-2)):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got.state["x"]["x"].numpy(),
                               np.asarray(want.state["x"]["x"]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.state["rng"],
                                  np.asarray(want.state["rng"]))


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
def test_run_rounds_matches_reference_with_stop(raw, h_policy):
    want = _reference_run(raw, 1.0, h_policy)
    algo, state, batch = _port(raw, h_policy=h_policy)
    got = run_rounds(algo, state, batch, 300, tol=TOL)
    assert want.stopped_early and got.stopped_early
    assert got.rounds_run == want.rounds_run
    for k, rtol in (("f_xbar", 1e-4), ("grad_sq_norm", 1e-2)):
        assert got.history[k].shape == (got.rounds_run,)
        np.testing.assert_allclose(got.history[k][-1], want.history[k][-1],
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got.state["x"]["x"].numpy(),
                               np.asarray(want.state["x"]["x"]),
                               rtol=1e-4, atol=1e-5)


def test_run_rounds_leaves_the_callers_state_alone(raw):
    """Rounds run the donated kernel, which writes its buffers in place;
    run_rounds copies the state at entry, so the caller's tensors and
    generator are unchanged."""
    algo, state, batch = _port(raw, h_policy="scalar")
    algo.fed = FedConfig(num_clients=M, k0=5, alpha=0.5, sigma_t=0.2,
                         h_policy="scalar")
    before = {k: state[k]["x"].clone() for k in ("x", "z", "pi")}
    key = state["rng"].copy()
    res = run_rounds(algo, state, batch, 4)
    assert res.rounds_run == 4 and not res.stopped_early
    for k, v in before.items():
        assert torch.equal(state[k]["x"], v), k
    assert np.array_equal(state["rng"], key)
    assert not np.array_equal(res.state["rng"], key)
    # the same rounds without donation give the same result, bitwise
    spec = ravel_spec(state["x"])
    flat = flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    for _ in range(4):
        flat, _ = algo.round_flat(flat, batch, spec, donate_kernel=False)
    again = unflatten_state(algo, flat, spec)
    for k in ("x", "z", "pi"):
        assert torch.equal(again[k]["x"], res.state[k]["x"]), k
    assert list(res.history["cr"]) == [2.0, 4.0, 6.0, 8.0]


def test_cli_matches_reference_cli_at_full_selection(caplog):
    from repro.launch import train as jax_train

    argv = ["--clients", "8", "--dim", "20", "--samples", "400",
            "--alpha", "1.0", "--rounds", "200", "--tol", "1e-7"]
    want = jax_train.train(jax_train.build_parser().parse_args(argv))
    got = train_mod.main(argv + ["--device", "cpu"])
    assert got["device"] == "cpu" and got["stopped_early"]
    assert got["rounds"] == want["rounds"]
    np.testing.assert_allclose(got["final_f"], want["final_f"], rtol=1e-5)


def _run(code):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_neither_jax_nor_repro():
    out = _run(
        "import sys, repro_torch.launch.train, repro_torch.utils.convert\n"
        "import repro_torch.launch.dryrun, repro_torch.sharding\n"
        "import repro_torch.benchmarks.roofline\n"
        "import repro_torch.benchmarks.fill_experiments\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    assert out.returncode == 0, out.stdout + out.stderr


def test_cli_runs_on_cpu_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--clients", "8", "--dim", "20", "--samples", "400",
         "--rounds", "5", "--tol", "0"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "done: 5 rounds (CR=10)" in out.stderr


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        device_mod.resolve_device()  # the default is the card
    with pytest.raises(ValueError):
        device_mod.resolve_device("mps")
    assert device_mod.resolve_device("cpu").type == "cpu"
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
