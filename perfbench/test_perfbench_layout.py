"""The benchmark finds every configuration, cell and metric by its name
in BENCHMARK.json, and keeps to the manifest's contract."""
import json
import re
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(ROOT / "src"))

from pbench import harness  # noqa: E402

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["command"] == ["python3", "perfbench/run.py"]
    assert MAN["paths"] == ["perfbench"]
    names = CELLS + METRICS + [c["name"] for c in MAN["configs"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in MAN["workloads"]]:
        assert NAME.match(n), n
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry, cfg, wl = harness.cell_files(cell, MAN)
    assert entry["chips"] == 1
    assert cfg["name"] == entry["config"]
    assert harness.system_for(cfg).__module__.endswith(cfg["system"])
    assert set(wl["limits"]) == {"loss_gap", "gsq_gap", "grad_gap",
                                 "step_gap", "r_gap"} or wl["limits"]
    assert all(v > 0 for v in wl["limits"].values())
    reported = {m["name"] for m in harness.metrics_for(cell, MAN, False)}
    assert "setup_s" in reported and len(reported) >= 2
    assert harness.metrics_for(cell, MAN, True)


@pytest.mark.parametrize("metric", METRICS)
def test_metric_reader_found_by_name(metric):
    assert callable(harness.reader(metric))


def test_per_layer_metrics_move_what_their_cells_report():
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.metrics_for(cell, MAN,
                                                               False)}
            assert m["moves"] in reported, (m["name"], cell)
    layers = {}
    for m in MAN["per_layer"]:
        layers.setdefault(m["layer"], m["layer"])
        assert 1 <= len(m["layer"]) <= 200


def test_config_files_under_paths_and_distinct():
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith("perfbench/") and (ROOT / f).is_file()
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
