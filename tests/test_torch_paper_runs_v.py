"""The rest of the paper's §V runs on the port, on the CPU, against the
reference: Fig. 3, the partial-participation sweep, Table IV's logistic
rows, the training CLI's participation, `--unrolled` and `--chunk auto`
flags, and the kernels_bench and paper_experiments runners.

How rows are held:

* Fig. 3 and participation_bench rows use each side's own uniform draw,
  which is now the same threefry stream (`core/prng.py`): the same
  clients every round, so each row is held to the same CR and the final
  objective at rel 1e-5, beside `converged` and the runner's 3·min CR
  assert.
* Table IV's logistic rows stop at tol (5/6400)·1e-6 ≈ 7.8e-10. The rule
  for them, stated before the test: the port and the reference run the
  same rounds, and both converge (or both do not). Where the stop metric
  at the reference's stop round lies within fp32 noise of tol (1 % of
  tol: port and reference differ by a few ulps a round, queue 3 item
  f), the two may stop one round apart. FedAvg's row is the port's own
  (no draw). The FedGiA rows select half the clients a round from the
  state's key, the reference's clients: the port's own row is held by
  the same rule, and so is the port under the reference's masks (its
  keys recomputed in JAX and replayed through an availability policy).
* Runs whose masks are the same on both sides (cyclic, straggler and
  periodic CLI runs, `--unrolled`) are held as the CLI's baseline runs
  are: the same rounds and the final f at rel 1e-5.
* `--chunk auto` runs the same rounds as a fixed chunk, so on the CPU
  its result is the fixed chunk's, bit for bit.
"""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common, fig3_alpha, kernels_bench
from repro_torch.benchmarks import participation_bench, table4
from repro_torch.config import FedConfig
from repro_torch.core import fedgia as fedgia_mod
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import AUTO_CHUNK_CANDIDATES, run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    UniformParticipation,
)
from repro_torch.examples import paper_experiments
from repro_torch.launch import train as train_mod

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
SMALL = ["--clients", "8", "--dim", "20", "--samples", "400"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module: its problems are small, where
    more threads only spin, and the suite's other workers need the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jax_bench():
    """The reference's runners (the top-level `benchmarks` package)."""
    from benchmarks import common as jax_common
    from benchmarks import fig3_alpha as jax_fig3
    from benchmarks import participation_bench as jax_part

    return jax_common, jax_fig3, jax_part


def hold_rounds(got_rounds, got_err, want_rounds, want_err, tol, what):
    """The stated rule: the same rounds, or one apart where the stop
    metric at the earlier stop round lies within 1 % of tol on the side
    that ran on. `*_err` are the per-round stop metrics."""
    if got_rounds == want_rounds:
        return
    assert abs(got_rounds - want_rounds) == 1, (what, got_rounds,
                                                  want_rounds)
    short = min(got_rounds, want_rounds)
    err_at = (got_err if got_rounds > short else want_err)[short - 1]
    assert abs(err_at - tol) <= 1e-2 * tol, (what, err_at, tol)


# ------------------------------------------------------------ Fig. 3
def test_fig3_rows_match_reference(jax_bench):
    _, jax_fig3, _ = jax_bench
    want = jax_fig3.run()
    got = fig3_alpha.run(device="cpu")
    assert [r["alpha"] for r in got] == [r["alpha"] for r in want] \
        == fig3_alpha.ALPHAS
    for g, w in zip(got, want):
        assert g["converged"] and w["cr"] < 2 * fig3_alpha.MAX_ROUNDS
        assert g["cr"] == 2 * g["rounds"] and g["time_s"] > 0
        assert g["cr"] == w["cr"], f"alpha {g['alpha']}"
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=1e-5,
                                   err_msg=f"alpha {g['alpha']}")
    fig3_alpha.check(got)


def test_fig3_prints_its_rows_as_csv(monkeypatch, capsys):
    monkeypatch.setattr(fig3_alpha, "ALPHAS", [0.25, 1.0])
    rows = fig3_alpha.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "alpha,CR,time_s,obj"
    assert [line.split(",")[:2] for line in lines[1:]] == [
        [str(r["alpha"]), str(r["cr"])] for r in rows]


# ------------------------------------------------- participation_bench
def test_participation_bench_fedgia_rows_match_reference(jax_bench,
                                                          monkeypatch):
    _, _, jax_part = jax_bench
    for mod in (jax_part, participation_bench):
        monkeypatch.setattr(mod, "ALGOS",
                            {"fedgia_d": mod.ALGOS["fedgia_d"]})
    want = jax_part.run()
    got = participation_bench.run(device="cpu")
    assert len(got) == len(want) == len(participation_bench.ALPHAS)
    for g, w in zip(got, want):
        assert (g["algo"], g["alpha"], g["selected"]) == \
            (w["algo"], w["alpha"], w["selected"])
        assert g["converged"] and w["converged"]
        assert g["cr"] == w["cr"], g["alpha"]
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=1e-5)
    participation_bench.check(got)


def test_participation_bench_prints_the_selected_column(monkeypatch,
                                                         capsys):
    """Both algorithms' rows (SCAFFOLD cut to 20 rounds: it needs ~400 to
    converge, tens of seconds here)."""
    monkeypatch.setattr(participation_bench, "ALPHAS", [0.25, 1.0])
    monkeypatch.setattr(participation_bench, "MAX_ROUNDS", 20)
    rows = participation_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "algo,alpha,selected,CR,time_s,obj,converged"
    assert [line.split(",")[:3] for line in lines[1:]] == [
        ["fedgia_d", "0.25", "16"], ["fedgia_d", "1.0", "64"],
        ["scaffold", "0.25", "16"], ["scaffold", "1.0", "64"]]
    assert [r["converged"] for r in rows] == [True, True, False, False]


# ---------------------------------------------- Table IV, logistic rows
def _reference_masks(seed, rounds, m, alpha):
    """The masks the reference's FedGiA round draws from its state's key
    (`core/fedgia.py:323-327`): split the key a round, fold the round
    into the second half."""
    from repro.core import selection as jax_selection

    key, rows = jax.random.PRNGKey(seed + 1), []
    for t in range(rounds):
        key, sel_key = jax.random.split(key)
        rows.append(np.asarray(jax_selection.selection_mask(
            jax.random.fold_in(sel_key, t), m, alpha)))
    return np.stack(rows)


def _port_row_under(algo_key, problem, k0, trace):
    """The port's Table IV cell with the engine's masks taken from `trace`
    (FedGiA's split, as the reference draws it)."""
    model, batch, tol = common.make_problem(problem, 0, "cpu")
    hp = dict(common.ALGO_HPARAMS[algo_key])
    fed = FedConfig(algorithm="fedgia", num_clients=common.M_CLIENTS, k0=k0,
                    **hp)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return run_rounds(algo, state, batch, common.MAX_ROUNDS, tol=tol,
                      participation=AvailabilityParticipation(
                          common.M_CLIENTS, trace))


@pytest.mark.parametrize("algo", ["fedgia_d", "fedgia_g", "fedavg"])
@pytest.mark.parametrize("problem", ["logreg", "ncvx_logreg"])
def test_logistic_table4_row_matches_reference(jax_bench, problem, algo):
    jax_common, _, _ = jax_bench
    tol = common.make_problem(problem, 0, "cpu")[2]
    assert tol == (5.0 / common.D_SAMPLES) * 1e-6
    want = jax_common.run_algorithm(algo, problem, 5, collect_history=True)
    got = common.run_algorithm(algo, problem, 5, collect_history=True,
                               device="cpu")
    want_err = [e for _, e in want["history"]]
    if algo == "fedavg":
        hold_rounds(got["rounds"], [e for _, e in got["history"]],
                    want["rounds"], want_err, tol, algo)
        assert got["converged"] == want["converged"]
        np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-5)
        return
    # the port's own row: its own draws, the reference's clients
    hold_rounds(got["rounds"], [e for _, e in got["history"]],
                want["rounds"], want_err, tol, algo)
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-5)
    # under the reference's masks: the rule
    alpha = common.ALGO_HPARAMS[algo]["alpha"]
    trace = _reference_masks(0, common.MAX_ROUNDS, common.M_CLIENTS, alpha)
    res = _port_row_under(algo, problem, 5, trace)
    hold_rounds(res.rounds_run, res.history["grad_sq_norm"], want["rounds"],
                want_err, tol, algo)
    assert res.stopped_early == want["converged"]
    np.testing.assert_allclose(res.history["f_xbar"][-1], want["obj"],
                               rtol=1e-5)


def test_table4_takes_the_logistic_problems(monkeypatch, capsys):
    monkeypatch.setattr(table4, "ALGOS", ["fedgia_d", "fedgia_g"])
    rows = table4.main(["--device", "cpu", "--problems", "logreg",
                        "ncvx_logreg", "--k0s", "5", "--trials", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(",")[:3] for line in lines[1:]] == [
        [p, a, "5"] for p in ("logreg", "ncvx_logreg")
        for a in ("fedgia_d", "fedgia_g")]
    assert all(r["conv_frac"] == 1.0 for r in rows)


# -------------------------------------------------------------- the CLI
@pytest.mark.parametrize("argv,message", [
    (["--chunk", "x"], "--chunk must be an integer or 'auto'"),
    (["--chunk", "auto", "--no-scan"], "cannot be combined with --no-scan"),
    (["--client-weights", "1,2,3,4,5,6,7,8"],
     "--client-weights requires --participation weighted"),
    (["--arrival-periods", "1,2,3,4,1,2,3,4", "--participation", "uniform"],
     "--arrival-periods requires --participation periodic"),
    (["--participation", "weighted", "--client-weights", "1,2"],
     "--client-weights needs 8 values, got 2"),
    (["--participation", "periodic", "--arrival-periods", "1,x"],
     "--arrival-periods: invalid literal"),
])
def test_cli_flag_errors_are_the_references(argv, message):
    from repro.launch import train as jax_train

    full = SMALL + ["--device", "cpu"] + argv
    with pytest.raises(SystemExit, match=message):
        train_mod.main(full)
    with pytest.raises(SystemExit, match=message):
        jax_train.validate_flags(jax_train.build_parser().parse_args(
            SMALL + argv))


@pytest.mark.parametrize("argv", [
    ["--participation", "cyclic", "--alpha", "0.25"],
    ["--participation", "straggler", "--drop-prob", "0.3"],
    ["--participation", "periodic", "--arrival-periods", "1,2,3,4,1,2,3,5"],
    ["--participation", "cyclic", "--alpha", "0.5", "--algo", "scaffold"],
    ["--unrolled", "--alpha", "1.0"],
], ids=["cyclic", "straggler", "periodic", "scaffold-cyclic", "unrolled"])
def test_cli_run_matches_reference_cli(argv):
    """Runs whose masks are the same on both sides: the reference CLI's
    rounds, and its final f at rel 1e-5."""
    from repro.launch import train as jax_train

    full = SMALL + ["--rounds", "300", "--tol", "1e-7"] + argv
    want = jax_train.train(jax_train.build_parser().parse_args(full))
    got = train_mod.main(full + ["--device", "cpu"])
    assert got["rounds"] == want["rounds"] and got["cr"] == want["cr"]
    np.testing.assert_allclose(got["final_f"], want["final_f"], rtol=1e-5)


def test_cli_logs_the_policy_and_its_draws(caplog):
    caplog.set_level("INFO", logger="repro_torch.train")
    train_mod.log.propagate = True
    try:
        train_mod.main(SMALL + ["--device", "cpu", "--participation",
                                "weighted", "--client-weights",
                                "1,1,1,1,1,1,1,20", "--alpha", "0.25",
                                "--rounds", "4", "--tol", "0"])
        train_mod.main(SMALL + ["--device", "cpu", "--participation",
                                "straggler", "--rounds", "4", "--tol", "0"])
    finally:
        train_mod.log.propagate = False
    text = caplog.text
    assert "participation: weighted policy, alpha=0.25 (|C|=2 of m=8)" in text
    assert "participation: straggler policy (per-round varying |C|), m=8" \
        in text
    assert "mask draws on the host" in text


def test_unrolled_runs_no_kernel_and_matches_collapsed(monkeypatch):
    """`--unrolled` takes the k0-step loop: the update wrapper is never
    called, and the run agrees with the collapsed one (same rounds, f at
    rel 1e-5)."""
    calls = []
    real = fedgia_mod.fedgia_update_flat

    def spy(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(fedgia_mod, "fedgia_update_flat", spy)
    argv = SMALL + ["--device", "cpu", "--rounds", "300"]
    unrolled = train_mod.main(argv + ["--unrolled"])
    assert not calls
    collapsed = train_mod.main(argv)
    assert len(calls) == collapsed["rounds"] + 1  # + the chunk's warm-up
    assert unrolled["rounds"] == collapsed["rounds"]
    np.testing.assert_allclose(unrolled["final_f"], collapsed["final_f"],
                               rtol=1e-5)
    assert not unrolled["algorithm"].fed.collapsed


# ---------------------------------------------------------- chunk auto
def _fedgia(alpha=0.5):
    model, batch, _ = common.make_problem("linreg", 0, "cpu")
    fed = FedConfig(algorithm="fedgia", num_clients=common.M_CLIENTS, k0=5,
                    alpha=alpha, sigma_t=0.15, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    return algo, algo.init(model.init("cpu"), prng_key(1),
                           init_batch=batch), batch


def _assert_same(res, ref):
    assert res.rounds_run == ref.rounds_run
    assert res.stopped_early == ref.stopped_early
    for k, v in ref.history.items():
        np.testing.assert_array_equal(res.history[k], v, err_msg=k)
    for k in ("x", "z", "pi", "h"):
        assert torch.equal(res.state[k]["x"], ref.state[k]["x"]), k
    assert np.array_equal(res.state["rng"],
                          ref.state["rng"])


@pytest.mark.parametrize("rounds", [5, 60, 300])
def test_chunk_auto_is_bitwise_a_fixed_chunk(rounds):
    """tol 0: the candidates 8, 32, 128 in turn (clipped to the rounds
    left), then the fastest for the rest; the rounds are the same whatever
    wins, so the result is a fixed chunk's bit for bit, with and without
    a policy."""
    algo, state, batch = _fedgia()
    for pol in (None, UniformParticipation(common.M_CLIENTS, 0.25, seed=4)):
        ref = run_rounds(algo, state, batch, rounds, chunk_size=7,
                         participation=pol)
        res = run_rounds(algo, state, batch, rounds, chunk_size="auto",
                         participation=pol)
        _assert_same(res, ref)
        assert res.rounds_run == rounds
        plan, rest = [], rounds  # the timed lengths, clipped to the rest
        for cand in AUTO_CHUNK_CANDIDATES:
            if rest > 0:
                plan.append(min(cand, rest))
                rest -= plan[-1]
        assert res.chunk_size in plan
        if pol is not None:
            assert np.array_equal(res.policy_state["key"],
                                  ref.policy_state["key"])


def test_chunk_auto_stops_where_the_legacy_loop_stops():
    algo, state, batch = _fedgia()
    ref = run_rounds(algo, state, batch, 500, tol=1e-7, scan=False)
    res = run_rounds(algo, state, batch, 500, tol=1e-7, chunk_size="auto")
    assert ref.stopped_early and 8 < ref.rounds_run < 40
    _assert_same(res, ref)


def test_chunk_auto_errors():
    algo, state, batch = _fedgia()
    with pytest.raises(ValueError, match="an int or 'auto'"):
        run_rounds(algo, state, batch, 4, chunk_size="fast")
    with pytest.raises(ValueError, match="legacy per-round loop"):
        run_rounds(algo, state, batch, 4, chunk_size="auto", scan=False)


def test_cli_chunk_auto_matches_fixed_chunk():
    argv = SMALL + ["--device", "cpu", "--rounds", "50", "--tol", "0",
                    "--participation", "uniform"]
    auto = train_mod.main(argv + ["--chunk", "auto"])
    fixed = train_mod.main(argv + ["--chunk", "9"])
    assert auto["history"] == fixed["history"]
    assert auto["chunk_size"] in (8, 32, 10) and fixed["chunk_size"] == 9
    for k in ("z", "pi"):
        assert torch.equal(auto["state"][k]["x"], fixed["state"][k]["x"])


# ------------------------------------------------------------ runners
def test_kernels_bench_labels_its_times(capsys):
    out = kernels_bench.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us,clock"
    assert [line.split(",")[0] for line in lines[1:]] == [
        "fedgia_round_collapsed_k020", "fedgia_round_unrolled_k020",
        "fedgia_round_k010", "fedavg_round_k010"]
    assert all(line.endswith(",host clock (cpu)") for line in lines[1:])
    assert out["clock"] == "host clock (cpu)"
    assert all(us > 0 for us in out["micro"].values())


def test_paper_experiments_runs_every_section(monkeypatch, capsys):
    """Table IV (with --full, all three problems), Figs. 1, 2 and 3, at a
    cut size: the sections and their rows, not the numbers."""
    from repro_torch.benchmarks import fig1_convergence, fig2_k0

    monkeypatch.setattr(table4, "ALGOS", ["fedgia_d"])
    monkeypatch.setattr(fig1_convergence, "K0S", [5])
    monkeypatch.setattr(fig2_k0, "VARIANTS", ("fedgia_d",))
    monkeypatch.setattr(fig2_k0, "K0S", [5])
    monkeypatch.setattr(fig2_k0, "TRIALS", 1)
    monkeypatch.setattr(fig3_alpha, "ALPHAS", [0.5])
    paper_experiments.main(["--full", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    heads = [line for line in out if line.startswith("==")]
    assert heads == ["== Table IV (Obj / CR / time) ==",
                     "== Fig. 1: k0 vs iterations to converge ==",
                     "== Fig. 2: k0 vs CR / time ==",
                     "== Fig. 3: alpha vs CR / time =="]
    table = out[1:out.index(heads[1])]
    assert [line.split()[0] for line in table] == [
        p for p in ("linreg", "logreg", "ncvx_logreg") for _ in table4.K0S]
    assert any(line.strip().startswith("alpha=0.50") for line in out)


def test_new_runners_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (fig3_alpha.main, participation_bench.main,
                 kernels_bench.main, paper_experiments.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def test_new_modules_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.core.selection, repro_torch.core.engine, "
        "repro_torch.launch.train, repro_torch.benchmarks.fig3_alpha, "
        "repro_torch.benchmarks.participation_bench, "
        "repro_torch.benchmarks.kernels_bench, "
        "repro_torch.examples.paper_experiments\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro', 'benchmarks')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
