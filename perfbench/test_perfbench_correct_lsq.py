"""`correct` comes out false where it must, for the fedgia_lsq cells:
the harness run on the CPU at a small size of the configuration (its
look for a card skipped), held to the cell's own limits, with the
reference in lower precision put in the program's place (the control),
and with the timed path broken underneath (a round that returns its
state unchanged; a round that leaves half of each client's batch out).
A sound run comes out true."""
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from pbench.small_runs import break_round, cells, run, small_root  # noqa: E402

CELLS = cells("fedgia_lsq")


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tmp_path, cell):
    out = run(small_root(tmp_path, cell), cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    out = run(small_root(tmp_path, cell), cell, reference_in_place="control")
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
@pytest.mark.parametrize("cell", CELLS)
def test_broken_round_is_not_correct(tmp_path, monkeypatch, cell, fault):
    break_round(monkeypatch, fault)
    out = run(small_root(tmp_path, cell), cell)
    assert not out["correct"], out["checks"]
