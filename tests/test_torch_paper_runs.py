"""The port's paper runners (`repro_torch.benchmarks`, the quickstart)
against the reference's `benchmarks/` at the reference's constants
(M_CLIENTS=64, N_DIM=100, D_SAMPLES=6400, MAX_ROUNDS=500), on the CPU.

Baseline rows run with every client (no draw on either side): the same
rounds and `converged`, obj at rel 1e-5 (float32 rounding, not
bitwise). FedGiA rows select half the clients each round from a torch
generator where the reference draws from threefry (ROADMAP queue 3,
hazard a), so their rounds may differ: they are held to `converged` and
to the reference's final objective at rel 1e-3.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import common, fig1_convergence, fig2_k0, table4
from repro_torch.examples import quickstart

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
BASELINES = ["fedavg", "fedprox", "fedpd", "scaffold"]


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
def jax_common():
    """The reference's harness (the top-level `benchmarks` package, found
    from the repository root as tests/test_compress.py finds it)."""
    from benchmarks import common as jax_common

    return jax_common


def test_constants_are_the_references(jax_common):
    for k in ("M_CLIENTS", "N_DIM", "D_SAMPLES", "MAX_ROUNDS", "ALGO_HPARAMS"):
        assert getattr(common, k) == getattr(jax_common, k), k


@pytest.mark.parametrize("algo", BASELINES)
def test_baseline_row_matches_reference(jax_common, algo):
    want = jax_common.run_algorithm(algo, "linreg", 5)
    got = common.run_algorithm(algo, "linreg", 5, device="cpu")
    assert got["rounds"] == want["rounds"] and got["cr"] == want["cr"]
    assert got["converged"] == want["converged"]
    np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-5)
    assert got["time_s"] > 0 and got["k0"] == 5 and got["problem"] == "linreg"


@pytest.mark.parametrize("algo", ["fedgia_d", "fedgia_g"])
def test_fedgia_row_matches_reference_objective(jax_common, algo):
    want = jax_common.run_algorithm(algo, "linreg", 5)
    got = common.run_algorithm(algo, "linreg", 5, device="cpu")
    assert want["converged"] and got["converged"]
    assert got["err"] < 1e-7
    np.testing.assert_allclose(got["obj"], want["obj"], rtol=1e-3)


def test_fig1_asserts_hold_on_the_port():
    rows = fig1_convergence.run(device="cpu")
    assert [r["k0"] for r in rows] == fig1_convergence.K0S
    for r in rows:
        assert r["iterations"] == r["rounds"] * r["k0"]
        assert r["final_err"] < 1e-7
    fig1_convergence.check(rows)


def test_fig2_asserts_hold_on_the_port():
    rows = fig2_k0.run(device="cpu")
    assert len(rows) == len(fig2_k0.VARIANTS) * len(fig2_k0.K0S)
    fig2_k0.check(rows)


def test_table4_prints_its_rows_as_csv(monkeypatch, capsys):
    monkeypatch.setattr(table4, "ALGOS", ["scaffold", "fedgia_d"])
    rows = table4.main(["--device", "cpu", "--problems", "linreg", "--k0s",
                        "1", "--trials", "1"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "problem,algo,k0,obj,CR,time_s,converged_frac"
    assert [line.split(",")[:3] for line in lines[1:]] == [
        ["linreg", "scaffold", "1"], ["linreg", "fedgia_d", "1"]]
    assert [r["algo"] for r in rows] == ["scaffold", "fedgia_d"]
    assert rows[1]["conv_frac"] == 1.0


def test_quickstart_prints_both_lines(monkeypatch, capsys):
    """The quickstart's two lines, at a small size (the module's own is
    the paper's m=128, d=12800; at m=8 diag_ema at sigma_t 0.15 with half
    the clients selected diverges, as the reference's does at alpha 1,
    ROADMAP queue 3 item g)."""
    monkeypatch.setattr(quickstart, "M", 32)
    monkeypatch.setattr(quickstart, "N", 20)
    monkeypatch.setattr(quickstart, "D", 1600)
    results = quickstart.main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split(":")[0].strip() for line in lines] == ["fedgia",
                                                               "fedavg"]
    for line, res in zip(lines, results):
        assert f"CR={2 * res.rounds_run} (k0=5, m=32," in line
    assert results[0].stopped_early
    assert results[0].rounds_run * 5 < results[1].rounds_run


def test_runners_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        common.run_algorithm("fedavg", "linreg", 5)
    with pytest.raises(RuntimeError, match="CUDA"):
        table4.main(["--problems", "linreg", "--k0s", "5", "--trials", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        quickstart.main([])


def test_runners_import_neither_jax_nor_the_reference():
    code = (
        "import sys\n"
        "import repro_torch.benchmarks.table4, "
        "repro_torch.benchmarks.fig1_convergence, "
        "repro_torch.benchmarks.fig2_k0, repro_torch.examples.quickstart\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'repro', 'benchmarks')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
