"""Fault injection, screening, quorum, deadline and watchdog on the port
(mirrors tests/test_faults.py, but for its two XLA donation tests, its
pinned-host retry test and its sharded test; its resume tests are in
tests/test_torch_checkpoint.py) and against the JAX package.

Within the port:
  * a rate-0 fault model leaves history and state BITWISE unchanged in
    both drivers and all three stores, and fault runs agree bit for bit
    between the chunked driver and the legacy loop (the guard's
    `torch.where` merges run inside a round);
  * screening benign uploads changes no count, and the trajectory by
    nothing (the port's screening adds no reordering: bitwise);
  * NaN injection with screening converges, without it the run records
    the NaN; under-quorum rounds are recorded no-ops; the watchdog rolls
    back exploding runs and never fires on a quiet one; a deadline clock
    advances `sim_time` by the deadline.

Against the reference:
  * the fault draws (`FaultModel.draw`) bit for bit, for every kind, seed
    and round tested, on the device forms of the threefry chains;
  * `FaultModel.apply` on the same upload, mask and replay buffer bit for
    bit (selects and one float32 product);
  * `screen_rows`: the screened mask exact, the clipped rows at rtol 1e-6
    (the row norm sums in torch's order, not XLA's);
  * whole runs of all five algorithms under crash, nan, replay and
    explode faults with screening, a clip and a quorum, and under the
    watchdog: `cr`, `selected`, `screened`, `degraded` and `rollback`
    equal, f at rtol 1e-5 / atol 1e-6 (XLA:CPU's FMAs, ROADMAP queue 3
    f), |grad|^2 and the state at the whole-run rule of
    tests/test_torch_baselines.py, rtol 1e-4 / atol 1e-5;
  * a deadline clock's run: `sim_time` and `selected` equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import Screening as JaxScreening
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import make_clock as jax_make_clock
from repro.core import make_faults as jax_make_faults
from repro.core import run_rounds as jax_run_rounds
from repro.core.faults import screen_rows as jax_screen_rows
from repro.launch import train as jax_train
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import make_clock
from repro_torch.core.engine import run_rounds
from repro_torch.core.faults import (
    FaultModel,
    FaultSpec,
    Screening,
    make_faults,
    screen_rows,
)
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares

M, N, D = 8, 20, 400
ROUNDS = 8
RTOL, ATOL = 1e-5, 1e-6
RUN_RTOL, RUN_ATOL = 1e-4, 1e-5

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


def _reference(raw, key, rounds, **kw):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(algorithm=key, num_clients=M, k0=3,
                     **ALGO_SETUPS[key]), jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    return jax_run_rounds(jalgo, jstate, jb, rounds, scan=False, **kw)


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, *, ignore=("screened",)):
    """res must be bitwise ref, modulo metrics only res records."""
    assert res.rounds_run == ref.rounds_run
    assert set(res.history) - set(ref.history) <= set(ignore)
    for k in ref.history:
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=k)
    assert set(res.state) == set(ref.state)
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"state[{k}] diverged"


def _hold(got, want, what):
    assert got.rounds_run == want.rounds_run, what
    assert set(got.history) == set(want.history), what
    for k in ("selected", "cr", "screened", "degraded", "rollback",
              "sim_time"):
        if k in want.history:
            np.testing.assert_array_equal(got.history[k],
                                          np.asarray(want.history[k]),
                                          err_msg=f"{what}/{k}")
    np.testing.assert_allclose(got.history["f_xbar"], want.history["f_xbar"],
                               rtol=RTOL, atol=ATOL, err_msg=f"{what}/f")
    np.testing.assert_allclose(got.history["grad_sq_norm"],
                               want.history["grad_sq_norm"], rtol=RUN_RTOL,
                               atol=RUN_ATOL, err_msg=f"{what}/gsq")
    for key, leaf in _leaves(got.state):
        k, name = key.split(".")
        np.testing.assert_allclose(
            leaf.numpy(), np.asarray(want.state[k][name]), rtol=RUN_RTOL,
            atol=RUN_ATOL, err_msg=f"{what}: state[{key}]")


# ------------------------------------------------ fault model unit layer
def test_fault_model_draw_is_stateless_and_rate_bounded():
    fm = make_faults(["crash"], [0.5], num_clients=64, seed=3)
    rows = torch.arange(64)
    d0, d1 = fm.draw(7, rows), fm.draw(torch.tensor(7), rows)
    assert torch.equal(d0["crash"], d1["crash"])
    assert not torch.equal(d0["crash"], fm.draw(8, rows)["crash"])


def test_fault_model_row_split_matches_global_draw():
    """Per-client keys fold in GLOBAL row ids, so a slice of rows draws
    the full draw's slice: the same faults in every store."""
    fm = make_faults(["crash", "nan"], [0.3], num_clients=32, seed=1)
    rows = torch.arange(32)
    full, part = fm.draw(4, rows), fm.draw(4, rows[10:20])
    for kind in ("crash", "nan"):
        assert torch.equal(full[kind][10:20], part[kind])


@pytest.mark.parametrize("seed", [0, 1, 9, 2**31 + 5])
@pytest.mark.parametrize("round_idx", [0, 1, 7, 1000])
def test_fault_draw_is_the_references_bitwise(seed, round_idx):
    kinds = ["crash", "nan", "inf", "explode", "replay"]
    rates = [0.02, 0.1, 0.3, 0.5, 0.9]
    fm = make_faults(kinds, rates, num_clients=257, seed=seed)
    jfm = jax_make_faults(kinds, rates, num_clients=257, seed=seed)
    got = fm.draw(torch.tensor(round_idx), torch.arange(257))
    want = jfm.draw(jnp.int32(round_idx), jnp.arange(257))
    for kind in kinds:
        np.testing.assert_array_equal(got[kind].numpy(),
                                      np.asarray(want[kind]), err_msg=kind)


def test_fault_apply_is_the_references_bitwise():
    kinds = ["replay", "explode", "nan", "inf", "crash"]
    fm = make_faults(kinds, [0.3], num_clients=16, seed=4, scale=1e3)
    jfm = jax_make_faults(kinds, [0.3], num_clients=16, seed=4, scale=1e3)
    r = np.random.default_rng(0)
    contrib = r.normal(size=(16, 24)).astype(np.float32)
    prev = r.normal(size=(16, 24)).astype(np.float32)
    mask = r.random(16) < 0.7
    out, arrive, prev2 = fm.apply(
        torch.from_numpy(contrib), torch.from_numpy(mask),
        torch.from_numpy(prev), 3, torch.arange(16), payload_cols=20)
    jout, jarrive, jprev2 = jfm.apply(
        jnp.asarray(contrib), jnp.asarray(mask), jnp.asarray(prev),
        jnp.int32(3), jnp.arange(16, dtype=jnp.uint32), payload_cols=20)
    np.testing.assert_array_equal(out.numpy().view(np.int32),
                                  np.asarray(jout).view(np.int32))
    np.testing.assert_array_equal(arrive.numpy(), np.asarray(jarrive))
    np.testing.assert_array_equal(prev2.numpy(), np.asarray(jprev2))


def test_make_faults_surface():
    assert make_faults([], [0.1], num_clients=4) is None
    fm = make_faults(["crash", "nan"], [0.1], num_clients=4)
    assert len(fm.specs) == 2 and all(s.rate == 0.1 for s in fm.specs)
    with pytest.raises(ValueError, match="--fault-rate"):
        make_faults(["crash", "nan", "inf"], [0.1, 0.2], num_clients=4)
    with pytest.raises(ValueError):
        FaultSpec("meteor", 0.1)
    with pytest.raises(ValueError):
        Screening(clip_norm=-1.0)
    assert FaultModel(num_clients=4,
                      specs=(FaultSpec("replay", 0.1),)).needs_prev


def test_screen_rows_drops_nonfinite_and_clips():
    nan, inf = float("nan"), float("inf")
    contrib = torch.tensor([[1.0, 2.0], [nan, 0.0], [30.0, 40.0], [inf, 1.0]])
    mask = torch.tensor([True, True, True, False])
    out, smask = screen_rows(contrib, mask, Screening(clip_norm=5.0))
    assert smask.tolist() == [True, False, True, False]
    assert torch.isfinite(out).all()
    assert (out[1] == 0).all()
    np.testing.assert_allclose(np.linalg.norm(out[2].numpy()), 5.0,
                               rtol=1e-6)
    assert out[0].tolist() == [1.0, 2.0]


@pytest.mark.parametrize("clip", [None, 3.0, 50.0])
def test_screen_rows_matches_reference(clip):
    """The mask exact; the clipped rows at rtol 1e-6 (the norm's sum runs
    in torch's order)."""
    r = np.random.default_rng(2)
    contrib = (r.normal(size=(32, 40)) * 5).astype(np.float32)
    contrib[3, 7], contrib[9, 0], contrib[20, 39] = np.nan, np.inf, -np.inf
    mask = r.random(32) < 0.8
    out, smask = screen_rows(torch.from_numpy(contrib),
                             torch.from_numpy(mask), Screening(clip))
    jout, jsmask = jax_screen_rows(jnp.asarray(contrib), jnp.asarray(mask),
                                   JaxScreening(clip))
    np.testing.assert_array_equal(smask.numpy(), np.asarray(jsmask))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=0)


# ------------------------------- structure is free: rate-0 faults bitwise
@pytest.mark.parametrize("algo_key", FIVE)
def test_fault_free_rounds_bitwise_all_paths(raw, algo_key):
    """A rate-0 fault model leaves history and state bitwise unchanged in
    the chunked driver, the legacy loop and the active and offload
    stores."""
    algo, state, batch = _make(raw, algo_key)
    hard = dict(faults=make_faults(["crash", "nan"], [0.0], num_clients=M,
                                   seed=5))
    for kw in (dict(), dict(scan=False), dict(store="active"),
               dict(store="offload")):
        kw = dict(kw, participation=make_policy("uniform", M, 0.5, seed=3))
        ref = run_rounds(algo, state, batch, ROUNDS, **kw)
        res = run_rounds(algo, state, batch, ROUNDS, **kw, **hard)
        _assert_bitwise(res, ref)


@pytest.mark.parametrize("algo_key", FIVE)
def test_screening_benign_data_is_a_near_noop(raw, algo_key):
    """Screening benign uploads: every count as the unscreened run's, and
    the whole run bit for bit (the port's finite check moves no sum)."""
    algo, state, batch = _make(raw, algo_key)
    pol = make_policy("uniform", M, 0.5, seed=3)
    ref = run_rounds(algo, state, batch, ROUNDS, participation=pol)
    res = run_rounds(algo, state, batch, ROUNDS, participation=pol,
                     screening=Screening())
    _assert_bitwise(res, ref)
    expect = (np.full(ROUNDS, float(M)) if algo_key == "fedgia"
              else ref.history["selected"])
    np.testing.assert_array_equal(res.history["screened"], expect)


@pytest.mark.parametrize("algo_key", FIVE)
def test_fault_runs_chunked_match_legacy(raw, algo_key):
    """Faults, screening, quorum and the watchdog: the chunked driver is
    the legacy loop bit for bit (the replay buffer and the guard's
    merges included)."""
    algo, state, batch = _make(raw, algo_key)
    kw = dict(participation=make_policy("uniform", M, 0.75, seed=3),
              faults=make_faults(["replay", "crash", "explode"], [0.3],
                                 num_clients=M, seed=7, scale=1e3),
              screening=Screening(clip_norm=50.0),
              # FedGiA's quorum counts all m uploads, the baselines' the
              # round's 6 participants
              quorum=7 if algo_key == "fedgia" else 4, watchdog=True,
              watchdog_patience=2)
    ref = run_rounds(algo, state, batch, 12, chunk_size=5, **kw)
    res = run_rounds(algo, state, batch, 12, scan=False, **kw)
    _assert_bitwise(res, ref, ignore=())
    assert ref.history["degraded"].any()


# ------------------------------------------------- defense & degradation
def test_nan_injection_converges_with_screening(raw):
    algo, state, batch = _make(raw, "fedgia")
    res = run_rounds(algo, state, batch, 20,
                     participation=make_policy("uniform", M, 0.5, seed=3),
                     faults=make_faults(["nan", "inf"], [0.2],
                                        num_clients=M, seed=11),
                     screening=Screening())
    f = res.history["f_xbar"]
    assert np.all(np.isfinite(f))
    assert f[-1] < f[0]
    assert (res.history["screened"] < res.history["selected"]).any()


def test_nan_injection_recorded_honestly_without_screening(raw):
    algo, state, batch = _make(raw, "fedavg")
    res = run_rounds(algo, state, batch, 12,
                     participation=make_policy("uniform", M, 0.5, seed=3),
                     faults=make_faults(["nan"], [0.5], num_clients=M,
                                        seed=11))
    assert not np.all(np.isfinite(res.history["f_xbar"]))


def test_quorum_degrades_rounds_to_recorded_noops(raw):
    algo, state, batch = _make(raw, "scaffold")
    res = run_rounds(algo, state, batch, 16,
                     participation=make_policy("uniform", M, 0.5, seed=3),
                     faults=make_faults(["crash"], [0.5], num_clients=M,
                                        seed=2),
                     screening=Screening(), quorum=2)
    deg = res.history["degraded"]
    assert deg.dtype == bool and deg.any() and not deg.all()
    assert np.all(np.isfinite(res.history["f_xbar"]))
    assert res.rounds_run == 16


@pytest.mark.parametrize("algo_key", ["fedgia", "scaffold", "fedpd"])
def test_quorum_offload_async_matches_active(raw, algo_key):
    """The offload loop's quorum branch under async clocked rounds: a
    degraded round writes back neither the tiles nor the stale anchor
    and ages, bitwise the active store's `torch.where` merges."""
    from repro_torch.core.clock import ComputeClock

    algo, state, batch = _make(raw, algo_key)
    kw = dict(clock=ComputeClock(M, 1.0 + np.arange(M) % 3),
              max_staleness=2, screening=Screening(),
              faults=make_faults(["crash", "replay"], [0.3], num_clients=M,
                                 seed=1),
              quorum=6 if algo_key == "fedgia" else 2, compression="int8",
              error_feedback=True)
    ref = run_rounds(algo, state, batch, 12, store="active", chunk_size=5,
                     **kw)
    res = run_rounds(algo, state, batch, 12, store="offload", **kw)
    _assert_bitwise(res, ref, ignore=())
    assert torch.equal(res.stale.anchor, ref.stale.anchor)
    if algo_key == "fedgia":
        assert ref.history["degraded"].any()


def test_watchdog_rolls_back_under_explosions(raw):
    algo, state, batch = _make(raw, "fedavg")
    res = run_rounds(algo, state, batch, 24,
                     participation=make_policy("uniform", M, 0.5, seed=3),
                     faults=make_faults(["explode"], [0.3], num_clients=M,
                                        seed=4),
                     watchdog=True, watchdog_patience=2)
    assert res.history["rollback"].sum() >= 1
    assert torch.isfinite(res.state["x"]["x"]).all()


def test_watchdog_quiet_run_never_fires(raw):
    algo, state, batch = _make(raw, "fedgia")
    kw = dict(participation=make_policy("uniform", M, 0.5, seed=3))
    ref = run_rounds(algo, state, batch, ROUNDS, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, watchdog=True, **kw)
    assert res.history["rollback"].sum() == 0
    _assert_bitwise(res, ref, ignore=("rollback",))


def test_deadline_clock_rounds_advance_by_deadline(raw):
    algo, state, batch = _make(raw, "fedavg")
    speeds = [1.0 + (i % 4) for i in range(M)]
    clock = make_clock("constant", M, compute_s=speeds, deadline_s=2.5)
    res = run_rounds(algo, state, batch, ROUNDS, clock=clock, quorum=1)
    np.testing.assert_allclose(res.history["sim_time"],
                               2.5 * np.arange(1, ROUNDS + 1), rtol=1e-6)
    assert (res.history["selected"] < M).any()
    assert res.history["selected"].min() >= 1
    with pytest.raises(ValueError, match="quorum >= 1"):
        run_rounds(algo, state, batch, 2, clock=clock)
    want = _reference(raw, "fedavg", ROUNDS, quorum=1, clock=jax_make_clock(
        "constant", M, compute_s=speeds, deadline_s=2.5))
    _hold(res, want, "deadline clock")


# ----------------------------------------------- engine validation layer
def test_engine_rejections(raw, tmp_path):
    algo, state, batch = _make(raw, "fedavg")
    pol = make_policy("uniform", M, 0.5, seed=3)
    with pytest.raises(ValueError, match="non-arrival"):
        run_rounds(algo, state, batch, 2, quorum=2)
    with pytest.raises(ValueError, match="quorum must be in"):
        run_rounds(algo, state, batch, 2, participation=pol, quorum=M + 1)
    with pytest.raises(ValueError, match="watchdog_patience"):
        run_rounds(algo, state, batch, 2, watchdog=True,
                   watchdog_patience=0)
    with pytest.raises(ValueError, match="watchdog_factor"):
        run_rounds(algo, state, batch, 2, watchdog=True,
                   watchdog_factor=1.0)
    with pytest.raises(ValueError, match="host-resident"):
        run_rounds(algo, state, batch, 2, participation=pol,
                   store="offload", watchdog=True)
    with pytest.raises(ValueError, match="checkpoint_dir"):
        run_rounds(algo, state, batch, 2, checkpoint_every=1)
    with pytest.raises(ValueError, match="chunk"):
        run_rounds(algo, state, batch, 2, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path), chunk_size="auto")
    with pytest.raises(ValueError, match="scan driver"):
        run_rounds(algo, state, batch, 2, scan=False, checkpoint_every=1,
                   checkpoint_dir=str(tmp_path))
    with pytest.raises(ValueError, match="clients"):
        run_rounds(algo, state, batch, 2,
                   faults=make_faults(["crash"], [0.1], num_clients=M + 1))


# ------------------------------------------------ whole runs vs the reference
def _campaign(mod, screening):
    return dict(faults=mod(["crash", "nan", "replay", "explode"], [0.15],
                           num_clients=M, seed=9, scale=1e3),
                screening=screening(clip_norm=50.0), quorum=4)


@pytest.mark.parametrize("algo_key", FIVE)
def test_fault_runs_match_reference(raw, algo_key):
    """Faults with screening, a clip and a quorum under uniform 0.75:
    the reference's faults hit the same clients, the same rounds degrade,
    and the runs agree to the stated tolerances."""
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, 12, chunk_size=5,
                     participation=make_policy("uniform", M, 0.75, seed=3),
                     **_campaign(make_faults, Screening))
    from repro.core import make_policy as jax_make_policy
    want = _reference(raw, algo_key, 12,
                      participation=jax_make_policy("uniform", M, 0.75,
                                                    seed=3),
                      **_campaign(jax_make_faults, JaxScreening))
    _hold(got, want, algo_key)
    assert (got.history["screened"] < M).any()


@pytest.mark.parametrize("algo_key", FIVE)
def test_watchdog_runs_match_reference(raw, algo_key):
    algo, state, batch = _make(raw, algo_key)
    kw = dict(watchdog=True, watchdog_patience=2, watchdog_factor=1.5)
    got = run_rounds(algo, state, batch, 12, chunk_size=5,
                     faults=make_faults(["explode"], [0.3], num_clients=M,
                                        seed=4, scale=1e3), **kw)
    want = _reference(raw, algo_key, 12,
                      faults=jax_make_faults(["explode"], [0.3],
                                             num_clients=M, seed=4,
                                             scale=1e3), **kw)
    _hold(got, want, algo_key)


# ------------------------------------------------------------------ the CLI
_ARGV = ["--clients", "16", "--dim", "20", "--samples", "400", "--rounds",
         "12", "--tol", "0", "--compression", "int8", "--error-feedback",
         "--faults", "crash,nan", "--fault-rate", "0.1", "--screening",
         "--quorum", "8"]


def test_cli_matches_reference_done_line():
    """The CLI's run under the uplink flags (int8 with error feedback,
    crash and nan faults, screening, a quorum): the reference CLI's
    rounds, screened minimum and degraded count, and every round's f at
    rtol 1e-5 (no int8 level flips at this size; at the CLI's default
    size they flip, and the final f differs by a few 1e-3)."""
    got = train_mod.main(_ARGV + ["--device", "cpu"])
    want = jax_train.train(jax_train.build_parser().parse_args(
        _ARGV + ["--no-scan"]))
    for k in ("rounds", "cr", "screened_min", "degraded_rounds"):
        assert got[k] == want[k], k
    np.testing.assert_allclose([h["f"] for h in got["history"]],
                               [h["f"] for h in want["history"]],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("argv,match", [
    (["--error-feedback"], "lossy"),
    (["--compression", "bf16", "--topk-frac", "0.2"], "--compression topk"),
    (["--compression", "topk", "--topk-frac", "1.5"], "must be in"),
    (["--bandwidth-bps", "100"], "requires --clock"),
    (["--clock", "constant", "--bandwidth-bps", "-1"], "must be > 0"),
    (["--faults", "meteor"], "unknown kind"),
    (["--fault-rate", "0.1"], "--faults crash"),
    (["--faults", "crash,nan", "--fault-rate", "0.1,0.2,0.3"], "1 or 2"),
    (["--faults", "crash", "--fault-rate", "1.5"], r"\[0, 1\]"),
    (["--clip-norm", "5"], "--screening"),
    (["--screening", "--clip-norm", "-5"], "must be > 0"),
    (["--quorum", "4"], "non-arrival"),
    (["--screening", "--quorum", "999"], "must be in"),
    (["--deadline-s", "2"], "requires --clock"),
    (["--clock", "constant", "--deadline-s", "2"], "--quorum"),
    (["--watchdog-patience", "2"], "--watchdog"),
    (["--watchdog", "--watchdog-patience", "0"], ">= 1"),
    (["--watchdog", "--watchdog-factor", "1"], "must be > 1"),
    (["--watchdog", "--participation", "uniform", "--store", "offload"],
     "offload"),
    (["--checkpoint-every", "2"], "--checkpoint-dir"),
    (["--checkpoint-every", "2", "--checkpoint-dir", "d", "--chunk",
      "auto"], "fixed --chunk"),
    (["--resume", "--checkpoint-dir", "d", "--no-scan"], "drop --no-scan"),
])
def test_cli_rejections_are_the_references(argv, match):
    """Each rejection of the port's CLI is the reference's, message and
    all."""
    args = train_mod.build_parser().parse_args(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit, match=match) as got:
        train_mod.validate_flags(args)
    jargs = jax_train.build_parser().parse_args(argv)
    with pytest.raises(SystemExit) as want:
        jax_train.validate_flags(jargs)
    assert str(got.value) == str(want.value)
