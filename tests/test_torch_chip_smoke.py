"""`chip_smoke.py` on the CPU: it imports without running anything, its
round-split predicate (phases 2g and 6) calls a split whole only where
every step the round runs has time > 0, and with no CUDA device the
script exits non-zero and prints no result line."""
import importlib.util
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_cpu", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _split(**over):
    split = {"gradient": 1144.7, "eq. (11)": 108.4, "update kernel": 89.4,
             "H refresh": 0.0, "metrics": 69.8, "copies": 0.0, "other": 0.0}
    split.update(over)
    return split


def test_whole_split_has_every_step(smoke):
    """A scalar-H round: H refresh, copies and other may read 0."""
    assert smoke.split_is_whole(_split())


@pytest.mark.parametrize("lost", ["gradient", "eq. (11)", "update kernel",
                                  "metrics"])
def test_split_with_a_lost_step_is_not_whole(smoke, lost):
    """A full-width split that read eq. (11) = 0.0 once passed as a
    device split: any step of the round at 0 (or missing) is none."""
    assert not smoke.split_is_whole(_split(**{lost: 0.0}))
    split = _split()
    del split[lost]
    assert not smoke.split_is_whole(split)


def test_steps_are_the_round_labels(smoke):
    """The predicate's steps are labels the splits report."""
    assert set(smoke.ROUND_STEPS) <= set(smoke.LABELS)


def test_no_card_exits_nonzero_without_a_result(tmp_path):
    """Without CUDA the script exits non-zero before any result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, SCRIPT], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
