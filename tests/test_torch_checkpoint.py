"""Checkpoints and bitwise resume on the port (mirrors
tests/test_data_optim_ckpt.py::test_checkpoint_roundtrip and the resume
tests of tests/test_faults.py).

  * a tree of tensors (bf16 through its int16 bits), numpy arrays and
    numbers comes back in its structure, dtypes and devices, values
    equal, with its `extra`, written atomically under ``ckpt_{step:08d}``;
  * a run cut at round 6 of 12 (checkpoints every 4) and resumed to 12
    gives the uninterrupted run's history and final state BIT FOR BIT:
    all five algorithms in the chunked driver under faults, screening
    and the stochastic int8 codec with error feedback (its residual, the
    replay buffer, the policy's key and the codec keys all cross the
    cut); FedGiA and SCAFFOLD under a stop (tol > 0), a quorum and the
    watchdog, and under async rounds with a lognormal clock and a byte
    clock; the offload loop under a quorum;
  * a checkpoint of another configuration is refused (its fingerprint),
    a longer `num_rounds` is not, and a resume with no checkpoint is a
    fresh start;
  * the CLI: `--checkpoint-every` then `--resume` with more `--rounds`
    prints the uninterrupted run's `done:` numbers;
  * `utils.convert.state_from_numpy` carries the reference's ``ef`` and
    ``fault_prev`` across bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import make_faults as jax_make_faults
from repro.core import run_rounds as jax_run_rounds
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.checkpoint import (
    latest_step,
    load_checkpoint,
    load_extra,
    save_checkpoint,
)
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock, LognormalClock
from repro_torch.core.engine import run_rounds
from repro_torch.core.faults import Screening, make_faults
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares
from repro_torch.utils.convert import state_from_numpy

M, N, D = 8, 20, 400

ALGO_SETUPS = {
    "fedgia": dict(sigma_t=0.2, h_policy="diag_ema", alpha=0.5),
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002, prox_mu=1e-4, inner_steps=3),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(lr=0.01),
}
FIVE = sorted(ALGO_SETUPS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _make(raw, key):
    model = LeastSquares(N)
    fed = FedConfig(algorithm=key, num_clients=M, k0=3, **ALGO_SETUPS[key])
    algo = make_algorithm(fed, model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]
        else:
            yield k, v


def _assert_bitwise(res, ref):
    assert res.rounds_run == ref.rounds_run
    assert res.stopped_early == ref.stopped_early
    assert set(res.history) == set(ref.history)
    for k in ref.history:
        assert res.history[k].dtype == ref.history[k].dtype, k
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=k)
    assert set(res.state) == set(ref.state)
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        if torch.is_tensor(a):
            assert torch.equal(a, b), f"state[{k}] diverged"
        else:
            np.testing.assert_array_equal(a, b, err_msg=k)


def _cut_and_resume(algo, state, batch, tmp_path, rounds=12, cut=6,
                    every=4, **kw):
    ref = run_rounds(algo, state, batch, rounds, **kw)
    d = str(tmp_path / "ckpt")
    first = run_rounds(algo, state, batch, cut, checkpoint_every=every,
                       checkpoint_dir=d, **kw)
    assert first.rounds_run == cut
    assert latest_step(d) == (cut // every) * every
    res = run_rounds(algo, state, batch, rounds, checkpoint_every=every,
                     checkpoint_dir=d, resume=True, **kw)
    return res, ref


# --------------------------------------------------------------- the files
def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "nested": {"b": torch.ones(4, dtype=torch.bfloat16), "c": 3,
                       "key": np.array([7, 2**32 - 1], np.uint32)},
            "none": None, "flag": torch.tensor(True),
            "seq": [torch.tensor(2.5), 1.5]}
    d = str(tmp_path / "ckpt")
    save_checkpoint(d, 7, tree, extra={"note": "x"})
    assert latest_step(d) == 7
    assert load_extra(d, 7) == {"note": "x"}
    restored, extra = load_checkpoint(d, 7, tree)
    assert extra["note"] == "x"
    assert restored["none"] is None
    assert restored["nested"]["c"] == 3 and isinstance(
        restored["nested"]["c"], int)
    assert restored["seq"][1] == 1.5
    np.testing.assert_array_equal(restored["nested"]["key"],
                                  tree["nested"]["key"])
    assert restored["nested"]["key"].dtype == np.uint32
    for k in ("a", "flag"):
        assert restored[k].dtype == tree[k].dtype
        assert torch.equal(restored[k], tree[k])
    b = restored["nested"]["b"]
    assert b.dtype == torch.bfloat16 and torch.equal(b, tree["nested"]["b"])
    assert torch.equal(restored["seq"][0], tree["seq"][0])
    # a later step wins, and a step's second save replaces the first
    save_checkpoint(d, 12, tree)
    save_checkpoint(d, 12, tree, extra={"note": "y"})
    assert latest_step(d) == 12 and load_extra(d, 12) == {"note": "y"}
    with pytest.raises(AssertionError, match="leaves"):
        load_checkpoint(d, 7, {"a": tree["a"]})


def test_latest_step_of_a_missing_directory(tmp_path):
    assert latest_step(str(tmp_path / "none")) is None


# ------------------------------------------------------ resume, bit for bit
@pytest.mark.parametrize("algo_key", FIVE)
def test_checkpoint_resume_bitwise_scan(raw, algo_key, tmp_path):
    """Cut at round 6 of 12 (checkpoints every 4), resume to 12: the
    uninterrupted run's history and state, with faults, screening and
    the stochastic int8 codec on, so the stateless draws, the replay
    buffer, the residual and the policy's key line up across the cut."""
    algo, state, batch = _make(raw, algo_key)
    res, ref = _cut_and_resume(
        algo, state, batch, tmp_path, chunk_size=5,
        participation=make_policy("uniform", M, 0.5, seed=3),
        faults=make_faults(["crash", "explode", "replay"], [0.2],
                           num_clients=M, seed=9),
        screening=Screening(clip_norm=1e3), compression="int8",
        error_feedback=True)
    _assert_bitwise(res, ref)
    assert "ef" in res.state and "fault_prev" in res.state


@pytest.mark.parametrize("algo_key", ["fedgia", "scaffold"])
def test_resume_bitwise_under_stop_quorum_and_watchdog(raw, algo_key,
                                                       tmp_path):
    """tol > 0 (the stop flag and round count in the carry), a quorum and
    the watchdog's slot across the cut; the cut at round 10 of 40 with
    checkpoints every 4 (chunks of 3 cut at 4 and 8)."""
    algo, state, batch = _make(raw, algo_key)
    fedgia = algo_key == "fedgia"
    kw = dict(chunk_size=3, tol=3e-4 if fedgia else 125.0,
              participation=make_policy("uniform", M, 0.75, seed=3),
              faults=make_faults(["crash"], [0.2], num_clients=M, seed=2),
              screening=Screening(), quorum=7 if fedgia else 5,
              watchdog=True, watchdog_patience=2)
    res, ref = _cut_and_resume(algo, state, batch, tmp_path, rounds=40,
                               cut=10, **kw)
    _assert_bitwise(res, ref)
    # the stop falls after the cut, past a checkpoint of the resumed run
    assert ref.stopped_early and 12 < ref.rounds_run < 40
    assert ref.history["degraded"].any()


@pytest.mark.parametrize("clock", ["lognormal", "bytes"])
def test_resume_bitwise_async_clocked(raw, clock, tmp_path):
    """Async rounds under a clock: the stale anchor and ages and the
    clock's state (its threefry key) cross the cut; with a bandwidth the
    wire bytes join the history."""
    algo, state, batch = _make(raw, "fedgia")
    clk = (LognormalClock(M, 1.0 + np.arange(M) % 3, sigma=0.5, seed=4)
           if clock == "lognormal" else
           ComputeClock(M, 1.0 + np.arange(M) % 3, bandwidth_bps=1e4))
    res, ref = _cut_and_resume(algo, state, batch, tmp_path, chunk_size=5,
                               clock=clk, max_staleness=2,
                               compression="bf16")
    _assert_bitwise(res, ref)
    assert torch.equal(res.stale.anchor, ref.stale.anchor)
    np.testing.assert_array_equal(res.clock_state["busy_until"],
                                  ref.clock_state["busy_until"])


@pytest.mark.parametrize("algo_key", ["fedgia", "scaffold"])
def test_checkpoint_resume_bitwise_offload(raw, algo_key, tmp_path):
    algo, state, batch = _make(raw, algo_key)
    res, ref = _cut_and_resume(
        algo, state, batch, tmp_path,
        participation=make_policy("uniform", M, 0.5, seed=3),
        store="offload", quorum=7 if algo_key == "fedgia" else 1,
        faults=make_faults(["crash"], [0.3], num_clients=M, seed=9),
        screening=Screening(), compression="int8", error_feedback=True)
    _assert_bitwise(res, ref)


def test_resume_rejects_fingerprint_mismatch(raw, tmp_path):
    algo, state, batch = _make(raw, "fedavg")
    pol = make_policy("uniform", M, 0.5, seed=3)
    d = str(tmp_path / "fp")
    run_rounds(algo, state, batch, 4, participation=pol, checkpoint_every=2,
               checkpoint_dir=d)
    with pytest.raises(ValueError, match="fingerprint mismatch"):
        run_rounds(algo, state, batch, 8, participation=pol, quorum=2,
                   checkpoint_every=2, checkpoint_dir=d, resume=True)
    res = run_rounds(algo, state, batch, 8, participation=pol,
                     checkpoint_every=2, checkpoint_dir=d, resume=True)
    assert res.rounds_run == 8


def test_resume_without_checkpoint_is_fresh_start(raw, tmp_path):
    algo, state, batch = _make(raw, "fedavg")
    pol = make_policy("uniform", M, 0.5, seed=3)
    ref = run_rounds(algo, state, batch, 8, participation=pol)
    res = run_rounds(algo, state, batch, 8, participation=pol,
                     checkpoint_every=4, resume=True,
                     checkpoint_dir=str(tmp_path / "empty"))
    _assert_bitwise(res, ref)


def test_cli_resume_continues_bit_for_bit(tmp_path):
    """`--checkpoint-every 4` for 6 rounds, then `--resume` to 12: the
    12-round run's numbers."""
    base = ["--device", "cpu", "--clients", "16", "--dim", "20",
            "--samples", "400", "--tol", "0", "--chunk", "2",
            "--compression", "int8", "--error-feedback", "--faults",
            "crash,nan", "--fault-rate", "0.1", "--screening", "--quorum",
            "8"]
    ref = train_mod.main(base + ["--rounds", "12"])
    d = str(tmp_path / "cli")
    ck = ["--checkpoint-every", "4", "--checkpoint-dir", d]
    train_mod.main(base + ck + ["--rounds", "6"])
    got = train_mod.main(base + ck + ["--rounds", "12", "--resume"])
    for k in ("rounds", "final_f", "final_err", "screened_min",
              "degraded_rounds"):
        assert got[k] == ref[k], k
    assert [h["f"] for h in got["history"]] == [h["f"] for h in
                                                 ref["history"]]


def test_cli_checkpoint_dir_alone_saves_the_final_state(tmp_path):
    """`--checkpoint-dir` without `--checkpoint-every`/`--resume`: the
    final state is saved there, as the reference's CLI saves it."""
    d = str(tmp_path / "final")
    got = train_mod.main(["--device", "cpu", "--clients", "8", "--dim", "20",
                          "--samples", "400", "--rounds", "3", "--tol", "0",
                          "--checkpoint-dir", d])
    assert latest_step(d) == 3 and load_extra(d, 3) == {"algo": "fedgia"}
    state, _ = load_checkpoint(d, 3, got["state"])
    assert torch.equal(state["z"]["x"], got["state"]["z"]["x"])


def test_state_from_numpy_carries_ef_and_fault_prev():
    """The reference's state after an EF codec and replay faults: its
    residual and replay buffer cross into the port's state bit for
    bit."""
    raw = linreg_noniid(0, D, N, M)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(algorithm="fedgia", num_clients=M, k0=3,
                     **ALGO_SETUPS["fedgia"]), jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    want = jax_run_rounds(jalgo, jstate, jb, 3, scan=False,
                          compression="bf16", error_feedback=True,
                          faults=jax_make_faults(["replay"], [0.5],
                                                 num_clients=M)).state
    got = state_from_numpy(jax.device_get(want), "cpu")
    for k in ("ef", "fault_prev"):
        np.testing.assert_array_equal(got[k]["x"].numpy(),
                                      np.asarray(want[k]["x"]))
        assert got[k]["x"].abs().sum() > 0
    np.testing.assert_array_equal(got["rng"], np.asarray(want["rng"]))
    assert got["round"] == 3
