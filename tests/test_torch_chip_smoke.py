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


def test_dryrun_phase_comparisons_hold_on_the_cpu(smoke):
    """Phase 2j's comparisons at a reduced size on the CPU: the dry run's
    traced FLOPs equal FlopCounterMode's count of an eager donated round
    on a live flat state (exactly: the same aten products), its argument
    bytes equal the bytes that round reads less the flat buffers'
    padding and the int64 tokens' extra width (exactly), and its
    argument + output + temp bytes equal the round's peak as torch's own
    `MemTracker` reads it (the bytes of the storages the round allocates
    at its peak) plus the round's inputs, within 0.1 % (measured 0.003 %:
    the tokens' int64 width and the flat padding, which the dry run's plan
    counts as int32 and unpadded). A batch of 4 x 256 a client puts the
    peak in the backward's activations: at 2 x 32 it is the update's, whose
    plain version holds (2, N) temporaries that the card's kernel does
    not, and which the dry run leaves out as the kernel does."""
    import torch
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import FedConfig, ShapeConfig
    from repro_torch.configs import get_config
    from repro_torch.core import engine
    from repro_torch.core.api import make_algorithm
    from repro_torch.core.prng import prng_key
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh
    from repro_torch.models.transformer import Transformer, init_params
    from repro_torch.utils import pytree as pt

    cfg = get_config("tinyllama-1.1b").reduced()
    model = Transformer(cfg, "cpu")
    fed = FedConfig(num_clients=2, k0=5, alpha=0.5, h_policy="scalar")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(init_params(cfg, prng_key(0), "cpu"), prng_key(1))
    gen = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 4, 257),
                                     generator=gen)}
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    rec = dryrun.dryrun_one(cfg, ShapeConfig("t", 256, 8, "train"),
                            num_clients=2, state_dtype="float32",
                            mesh=AbstractMesh(("data", "model"), (1, 1)),
                            verbose=False)
    read = smoke.tensor_bytes(flat) + smoke.tensor_bytes(batch)
    gap = smoke.layout_gap(flat, spec, batch)
    assert gap == (3 * (spec.padded_size - spec.size) * 4
                   + batch["tokens"].numel() * 4)
    tracker = MemTracker()
    with FlopCounterMode(display=False) as fc, tracker:
        out = algo.round_flat(dict(flat), batch, spec, donate_kernel=True)
    del out
    counted = float(fc.get_total_flops())
    peak = (tracker.get_tracker_snapshot("peak")[torch.device("cpu")]["Total"]
            + smoke.storage_bytes(flat, batch))
    pd = rec["per_device"]
    fit = pd["argument_bytes"] + pd["output_bytes"] + pd["temp_bytes"]
    lines, bad = smoke.dryrun_checks(rec, counted, read, gap, peak)
    assert not bad, lines
    assert pd["flops"] == counted
    assert abs(fit - peak) / peak < 1e-3, (fit, peak)
    # each check fails where it should
    _, bad = smoke.dryrun_checks(rec, counted * 1.01, read + 1, gap,
                                 peak * 1.2)
    assert len(bad) == 3
