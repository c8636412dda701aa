"""The port's single-device benchmark suite, small, on the CPU (mirrors
tests/test_check_bench.py and the engine/kernels rows of the reference's
`benchmarks/run.py`).

* `engine_bench.run`: every path the port has (legacy, scan,
  scan_pytree, async, active_1m, offload_1m) with the reference's keys,
  the multi-device rows listed as absent, flat and per-leaf histories
  bit for bit, reused million rows not run again;
* `kernels_bench` part 3 (the update alone: fused flat, per-leaf,
  unrolled) at a small n;
* `run.py --json` writes the sections it ran, and the wallclock rows'
  JSON reads back through the gate;
* `check_bench`: the reference's four `--update-baseline` tests against
  the port module, a slowdown and a dropped path that fail, a row that
  stops converging, and the committed port baselines carrying their
  `_meta` (the command, the card, its power limit, the PR).

The timings here are the CPU's and are not asserted: the speedup checks
of `engine_bench.check` are the card's (chip_smoke.py phase 2h).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import check_bench as cb
from repro_torch.benchmarks import engine_bench, kernels_bench
from repro_torch.benchmarks import run as bench_run
from repro_torch.benchmarks import wallclock_bench

PATHS = {"legacy", "scan", "scan_pytree", "async", "active_1m",
         "offload_1m"}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_engine_run_small():
    r = engine_bench.run("cpu", rounds=8, repeats=1, clients_1m=20000,
                         rounds_1m=2)
    assert set(r["paths"]) == PATHS
    assert set(r["absent"]) == {"sharded", "scan_overlap"}
    for name, p in r["paths"].items():
        assert p["wall_s"] > 0 and p["rounds_per_s"] > 0, name
    assert r["rounds"] == 8 and r["clients"] == 64
    assert r["flat_vs_pytree_bitwise"] is True
    for k in ("speedup_scan_vs_legacy", "speedup_flat_vs_pytree",
              "speedup_flat_vs_pytree_wall", "overhead_async_vs_scan"):
        assert r[k] > 0, k
    assert r["paths"]["async"]["staleness_seen"] <= 2
    assert r["paths"]["active_1m"]["participants_per_round"] == 2


def test_engine_run_reuses_million_rows(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a million row ran again")

    monkeypatch.setattr(engine_bench, "run_active_1m", refuse)
    monkeypatch.setattr(engine_bench, "run_offload_1m", refuse)
    rows = {"active_1m": {"wall_s": 1.0, "rounds_per_s": 3.0},
            "offload_1m": {"wall_s": 2.0, "rounds_per_s": 1.5}}
    r = engine_bench.run("cpu", rounds=4, repeats=1, million=rows)
    assert r["paths"]["active_1m"] is rows["active_1m"]
    assert r["paths"]["offload_1m"] is rows["offload_1m"]


def test_engine_check_asserts_the_references_speedups():
    ok = {"speedup_scan_vs_legacy": 1.5, "speedup_flat_vs_pytree": 0.99}
    engine_bench.check(ok)
    with pytest.raises(AssertionError, match="per-round loop"):
        engine_bench.check(dict(ok, speedup_scan_vs_legacy=0.9))
    with pytest.raises(AssertionError, match="per-leaf"):
        engine_bench.check(dict(ok, speedup_flat_vs_pytree=0.97))


def test_kernels_bench_part3_small(capsys, monkeypatch):
    monkeypatch.setattr(kernels_bench, "UPDATE_N", 3000)
    out = kernels_bench.main(["--device", "cpu", "--parts", "3"])
    names = ["fedgia_update_flat_fused_m16_n3000",
             "fedgia_update_pytree_10leaf_m16_n3000",
             "fedgia_update_unrolled_ref_k020"]
    assert list(out["micro"]) == names
    assert all(us > 0 for us in out["micro"].values())
    assert out["ran"][names[0]] == "its plain version (cpu)"
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "name,us,clock"
    assert [line.split(",")[0] for line in lines[1:]] == names


def test_part3_rows_compute_the_same_update():
    """The fused flat pass and the per-leaf pass are one arithmetic, bit
    for bit on the CPU; the unrolled oracle agrees at rtol 1e-5."""
    from repro_torch.kernels.fedgia_update import ops, ref

    rng = np.random.default_rng(0)
    m, n, k0 = 4, 300, 6
    xb, g, p = (torch.from_numpy(rng.standard_normal((m, n)).astype(
        np.float32)) for _ in range(3))
    h = torch.from_numpy(rng.uniform(0.1, 2.0, (m, n)).astype(np.float32))
    sel = torch.tensor([True, False, True, True])
    sigma = torch.tensor(0.4)
    fused = ops.fedgia_update_flat(xb, g, p, h, sel, sigma, m, k0=k0)
    cols = np.array_split(np.arange(n), 3)
    parts = [ref.fedgia_update_collapsed(
        xb[:, c], g[:, c], p[:, c], h[:, c], sel[:, None], sigma,
        float(1.0 / m), k0=k0) for c in cols]
    for i in range(3):
        assert torch.equal(fused[i], torch.cat([q[i] for q in parts], 1))
    oracle = ref.fedgia_update_ref(xb, g, p, h, sel[:, None], sigma, m,
                                   k0=k0)
    for a, b in zip(fused, oracle):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_run_writes_the_sections_it_ran(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(engine_bench, "ROUNDS", 4)
    monkeypatch.setattr(engine_bench, "REPEATS", 1)
    monkeypatch.setattr(engine_bench, "M_1M", 20000)
    monkeypatch.setattr(engine_bench, "ROUNDS_1M", 2)
    monkeypatch.setattr(kernels_bench, "UPDATE_N", 2000)
    checked = []
    monkeypatch.setattr(engine_bench, "check", checked.append)
    path = tmp_path / "BENCH_engine.json"
    bench_run.main(["--only", "engine", "--only", "kernels", "--device",
                    "cpu", "--json", str(path)])
    data = json.loads(path.read_text())
    assert set(data) == {"engine", "kernels"}
    assert set(data["engine"]["paths"]) == PATHS
    assert checked and set(checked[0]["paths"]) == PATHS
    assert "fedgia_update_pytree_10leaf_m16_n2000" in data["kernels"]["micro"]
    assert "fedgia_round_collapsed_k020" in data["kernels"]["micro"]
    # the gate reads the dump, and passes it against itself
    assert cb.check(cb.load_engine_section(path),
                    cb.load_engine_section(path), 2.5, 1.5) == 0
    assert f"wrote {path}" in capsys.readouterr().out


def test_run_lists_the_absent_section():
    assert set(bench_run.SECTIONS) == {
        "table4", "fig1", "fig2", "fig3", "engine", "participation",
        "async", "wallclock", "kernels"}
    assert set(bench_run.ABSENT) == {"roofline"}
    with pytest.raises(SystemExit, match="roofline"):
        bench_run.run(["roofline"], "cpu", "")


def test_run_coerces_what_json_cannot_hold():
    assert bench_run._coerce(np.float32(1.5)) == 1.5
    assert bench_run._coerce(torch.device("cpu")) == "cpu"


def test_wallclock_json_reads_back_through_the_gate(tmp_path):
    rows = [
        {"algo": "fedgia_d", "spread": 4.0, "weighting": "uniform",
         "cr": 40, "sim_time_s": 80.0, "staleness_seen": 2, "obj": 0.1,
         "converged": True, "time_s": 0.5, "history": [(1, 2, 3, 4)]},
        {"algo": "fedgia_d_bw", "spread": 1.0, "weighting": "uniform",
         "codec": "int8", "cr": 50, "sim_time_s": 10.0,
         "staleness_seen": 1, "obj": 0.2, "converged": True,
         "time_s": 0.4},
    ]
    path = tmp_path / "BENCH_wallclock.json"
    out = wallclock_bench.write_json(rows, path, max_rounds=40)
    assert out["max_rounds"] == 40 and "history" not in out["rows"][0]
    loaded = cb.load_wallclock_rows(path)
    assert set(loaded) == {("fedgia_d", 4.0, "uniform", "none"),
                           ("fedgia_d_bw", 1.0, "uniform", "int8")}
    assert cb.check_wallclock(loaded, loaded, 2.5, 1.5) == 0


# ---------------------------------------------------------------- the gate
def test_update_baseline_preserves_meta(tmp_path, capsys):
    baseline = tmp_path / "baseline.json"
    current = tmp_path / "current.json"
    meta = {"generated_with": "repro_torch.benchmarks.run",
            "note": "hand-written"}
    baseline.write_text(json.dumps(
        {"_meta": meta, "engine": {"paths": {"scan": {"rounds_per_s": 10.0}}}}))
    current.write_text(json.dumps(
        {"engine": {"paths": {"scan": {"rounds_per_s": 12.0}}}}))
    cb.update_baseline(current, baseline)
    out = json.loads(baseline.read_text())
    assert out["_meta"] == meta
    assert out["engine"]["paths"]["scan"]["rounds_per_s"] == 12.0
    assert list(out)[0] == "_meta"  # meta stays on top for readers
    assert "kept _meta" in capsys.readouterr().out


def test_update_baseline_fresh_meta_wins(tmp_path):
    baseline = tmp_path / "baseline.json"
    current = tmp_path / "current.json"
    baseline.write_text(json.dumps({"_meta": {"note": "old"}, "engine": {}}))
    current.write_text(json.dumps({"_meta": {"note": "new"}, "engine": {}}))
    cb.update_baseline(current, baseline)
    assert json.loads(baseline.read_text())["_meta"] == {"note": "new"}


def test_update_baseline_without_existing_baseline(tmp_path):
    baseline = tmp_path / "baseline.json"
    current = tmp_path / "current.json"
    current.write_text(json.dumps({"engine": {"paths": {}}}))
    cb.update_baseline(current, baseline)
    assert json.loads(baseline.read_text()) == {"engine": {"paths": {}}}


def test_committed_baselines_carry_meta():
    """Both port baselines (never the reference's) keep their _meta: the
    command that made them, the card and its power limit, the PR."""
    assert cb.BASELINE.parent == Path(cb.__file__).resolve().parent / \
        "baselines"
    for path in (cb.BASELINE, cb.WALLCLOCK_BASELINE):
        data = json.loads(path.read_text())
        meta = data["_meta"]
        for k in ("generated_with", "note", "card", "pr"):
            assert k in meta, (path.name, k)
        assert meta["card"].startswith("NVIDIA H100"), path.name
        assert " W" in meta["card"], path.name  # the power limit
    engine = cb.load_engine_section(cb.BASELINE)
    assert set(engine["paths"]) == PATHS
    assert cb.load_wallclock_rows(cb.WALLCLOCK_BASELINE)


def _paths(**rps):
    return {"paths": {k: {"rounds_per_s": v} for k, v in rps.items()}}


def test_gate_fails_a_slowdown_and_warns_below_it(capsys):
    base = _paths(scan=100.0, legacy=10.0)
    assert cb.check(_paths(scan=39.0, legacy=10.0), base, 2.5, 1.5) == 1
    assert "FAIL (> 2.5x)" in capsys.readouterr().out
    assert cb.check(_paths(scan=60.0, legacy=10.0), base, 2.5, 1.5) == 0
    assert "WARN (> 1.5x)" in capsys.readouterr().out
    # a speed-up is fine, a new path is reported
    assert cb.check(_paths(scan=300.0, legacy=10.0, extra=1.0), base, 2.5,
                    1.5) == 0
    assert "new (not in baseline)" in capsys.readouterr().out


def test_gate_fails_a_dropped_path(capsys):
    base = _paths(scan=100.0, scan_pytree=90.0)
    assert cb.check(_paths(scan=100.0), base, 2.5, 1.5) == 1
    assert "FAIL (path dropped)" in capsys.readouterr().out


def test_wallclock_gate_fails_a_row_that_stops_converging(capsys):
    key = ("fedgia_d", 4.0, "uniform", "none")
    base = {key: {"converged": True, "sim_time_s": 10.0}}
    assert cb.check_wallclock({key: {"converged": False, "sim_time_s": 1.0}},
                              base, 2.5, 1.5) == 1
    assert "no longer converges" in capsys.readouterr().out
    assert cb.check_wallclock({}, base, 2.5, 1.5) == 1
    assert cb.check_wallclock({key: {"converged": True,
                                     "sim_time_s": 30.0}}, base, 2.5,
                              1.5) == 1
    never = {key: {"converged": False, "sim_time_s": 10.0}}
    assert cb.check_wallclock({key: {"converged": False,
                                     "sim_time_s": 99.0}}, never, 2.5,
                              1.5) == 0
