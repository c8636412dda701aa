"""The port's chunked round driver against its legacy loop and against the
reference's scan driver (mirrors tests/test_engine.py).

On the CPU the chunked driver runs the same chunk program that the card
captures as a CUDA graph, eagerly: the same masks drawn ahead of each
chunk, the same eq. (35) freeze and the same launch bookkeeping. Against
the port's own legacy loop it must agree BIT FOR BIT (the same ops in the
same order): state, history, `rounds_run` and the generator state it
returns. Against the reference's `run_rounds(scan=True)` it runs at
alpha = 1 (no draws on either side) and must stop at the same round with
f within the tolerances of tests/test_torch_slice.py.
"""
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
from repro_torch.config import FedConfig
from repro_torch.core import fedgia as fedgia_mod
from repro_torch.core import graphs
from repro_torch.core.engine import run_rounds
from repro_torch.core.fedgia import FedGiA
from repro_torch.core.prng import prng_key
from repro_torch.data import to_torch
from repro_torch.kernels.fedgia_update import ops
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares

M, N, D = 8, 20, 400
TOL = 1e-7


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _port(raw, alpha=0.5, h_policy="scalar"):
    model = LeastSquares(N)
    algo = FedGiA(FedConfig(num_clients=M, k0=5, alpha=alpha, sigma_t=0.2,
                            h_policy=h_policy), model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _assert_bitwise(res, ref):
    assert res.rounds_run == ref.rounds_run
    assert res.stopped_early == ref.stopped_early
    assert set(res.history) == set(ref.history)
    for k, v in ref.history.items():
        assert res.history[k].dtype == v.dtype, k
        np.testing.assert_array_equal(res.history[k], v, err_msg=k)
    for k in ("x", "z", "pi", "h"):
        if k in ref.state:
            assert torch.equal(res.state[k]["x"], ref.state[k]["x"]), k
    assert res.state["round"] == ref.state["round"]
    assert isinstance(res.state["round"], int)
    assert np.array_equal(res.state["rng"],
                          ref.state["rng"])


@pytest.fixture(scope="module")
def legacy(raw):
    """The legacy loop's result for each (H policy, tol), computed once."""
    out = {}
    for h_policy in ("scalar", "diag_ema"):
        algo, state, batch = _port(raw, h_policy=h_policy)
        for tol, rounds in ((TOL, 300), (0.0, 24)):
            out[h_policy, tol] = run_rounds(algo, state, batch, rounds,
                                            tol=tol, scan=False)
    return out


@pytest.mark.parametrize("chunk", [1, 5, 13])
@pytest.mark.parametrize("tol,rounds", [(TOL, 300), (0.0, 24)])
@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
def test_chunked_matches_legacy_loop_bitwise(raw, legacy, h_policy, tol,
                                             rounds, chunk):
    """Chunk sizes that do / do not divide the run and the stop round
    (scalar H stops after 13 rounds, diag_ema after 27), with the eq. (35)
    stop on and off."""
    algo, state, batch = _port(raw, h_policy=h_policy)
    ref = legacy[h_policy, tol]
    res = run_rounds(algo, state, batch, rounds, tol=tol, chunk_size=chunk)
    if tol > 0:
        assert ref.stopped_early and 0 < ref.rounds_run < rounds
        assert float(res.history["grad_sq_norm"][-1]) < tol
    else:
        assert ref.rounds_run == rounds
    assert len(res.history["grad_sq_norm"]) == res.rounds_run
    _assert_bitwise(res, ref)


def test_default_chunking_is_the_references(raw, legacy):
    """chunk_size=0: the whole run when tol <= 0, else min(rounds, 32)."""
    algo, state, batch = _port(raw)
    for tol, rounds in ((TOL, 300), (0.0, 24)):
        res = run_rounds(algo, state, batch, rounds, tol=tol)
        _assert_bitwise(res, legacy["scalar", tol])


def test_no_early_stop_when_tol_unreachable(raw):
    algo, state, batch = _port(raw)
    ref = run_rounds(algo, state, batch, 10, tol=1e-30, scan=False)
    res = run_rounds(algo, state, batch, 10, tol=1e-30, chunk_size=4)
    assert res.rounds_run == 10 and not res.stopped_early
    _assert_bitwise(res, ref)


def test_zero_rounds(raw):
    algo, state, batch = _port(raw)
    for scan in (True, False):
        res = run_rounds(algo, state, batch, 0, scan=scan)
        assert res.rounds_run == 0 and res.history == {}
        assert not res.stopped_early and res.state["round"] == 0


def test_metrics_are_stacked_per_round(raw):
    algo, state, batch = _port(raw)
    res = run_rounds(algo, state, batch, 6, chunk_size=4)
    for k, v in res.history.items():
        assert v.shape == (6,), k
    # cr counts 2 communications per round, in order, across the chunks
    np.testing.assert_array_equal(res.history["cr"],
                                  2.0 * np.arange(1, 7, dtype=np.float32))
    assert res.history["selected"].dtype == np.int64
    assert (res.history["selected"] == M // 2).all()


def test_state_and_generator_of_the_caller_are_left_alone(raw):
    algo, state, batch = _port(raw)
    before = {k: state[k]["x"].clone() for k in ("x", "z", "pi")}
    key = state["rng"].copy()
    res = run_rounds(algo, state, batch, 7, chunk_size=3)
    for k, v in before.items():
        assert torch.equal(state[k]["x"], v), k
    assert np.array_equal(state["rng"], key)
    assert res.state["round"] == 7


def test_launch_counts_follow_the_rounds_that_ran(raw, monkeypatch):
    """The chunk program counts a round's launches only when the round
    runs: past the stop, the frozen rounds of the chunk add none. The
    plain version launches nothing, so a stand-in counts one launch a
    call where the card would."""
    real = fedgia_mod.fedgia_update_flat

    def counted(*args, **kwargs):
        ops.launches["fedgia_update_batched_donated"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fedgia_mod, "fedgia_update_flat", counted)
    algo, state, batch = _port(raw)
    ops.reset_launches()
    res = run_rounds(algo, state, batch, 300, tol=TOL, chunk_size=32)
    counts = dict(ops.launches)
    ops.reset_launches()
    assert res.stopped_early and res.rounds_run < 32
    # the warm-up round's launch is taken back: only the run's rounds
    assert counts["fedgia_update_batched_donated"] == res.rounds_run


def test_skip_if_refuses_a_flag_off_the_card():
    """The conditional graph node exists only inside a capture on the
    card: a CPU flag is refused, nothing runs its body eagerly instead."""
    flag = torch.zeros((), dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        with graphs.skip_if(flag, None):
            pass


@pytest.mark.parametrize("h_policy,chunk", [("scalar", 5),
                                            ("diag_ema", 13)])
def test_chunked_matches_reference_scan_driver(raw, h_policy, chunk):
    """alpha = 1: both sides select every client, so the port's chunked
    driver and the reference's scan driver run the same rounds and stop
    at the same one (tolerances of tests/test_torch_slice.py)."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = make_algorithm(
        JaxFedConfig(algorithm="fedgia", num_clients=M, k0=5, alpha=1.0,
                     sigma_t=0.2, h_policy=h_policy, use_kernel=False),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    want = jax_run_rounds(jalgo, jstate, jb, 300, tol=TOL, scan=True,
                          chunk_size=chunk)
    algo, state, batch = _port(raw, alpha=1.0, h_policy=h_policy)
    got = run_rounds(algo, state, batch, 300, tol=TOL, chunk_size=chunk)
    assert want.stopped_early and got.stopped_early
    assert got.rounds_run == want.rounds_run
    for k, rtol in (("f_xbar", 1e-4), ("grad_sq_norm", 1e-2)):
        assert got.history[k].shape == (got.rounds_run,)
        np.testing.assert_allclose(got.history[k][-1], want.history[k][-1],
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(got.state["x"]["x"].numpy(),
                               np.asarray(want.state["x"]["x"]),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("argv,scan,chunk", [
    ([], True, 0),
    (["--chunk", "7"], True, 7),
    (["--no-scan"], False, 0),
])
def test_cli_flags_reach_the_drivers(monkeypatch, argv, scan, chunk):
    """`--no-scan` and `--chunk N` pick the driver and the chunk length;
    the default is the chunked driver, as in the reference's CLI."""
    seen = {}
    real = train_mod.run_rounds

    def spy(*args, **kwargs):
        seen.update(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(train_mod, "run_rounds", spy)
    out = train_mod.main(["--device", "cpu", "--clients", "8", "--dim", "20",
                          "--samples", "400", "--rounds", "9"] + argv)
    assert seen["scan"] is scan and seen["chunk_size"] == chunk
    assert out["rounds"] == 9 and out["capture_s"] >= 0.0
