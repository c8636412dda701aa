"""The port's roofline analysis (`repro_torch/benchmarks/roofline.py`,
`fill_experiments.py`) and the planning config it reads
(`INPUT_SHAPES`, `ModelConfig.active_param_count`) against the JAX
package's (`benchmarks/roofline.py`, `repro/config/base.py`).

Tolerance: none. The shapes, the parameter counts and MODEL_FLOPS are
integers or products of integers and must be equal; `analyse` on the
same records must give the reference's rows, field for field.
"""
import json

import pytest

from benchmarks import roofline as jroof
from repro.config import INPUT_SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro_torch.benchmarks import fill_experiments, roofline
from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import get_config, list_architectures

ARCHS = list_architectures()


def test_input_shapes_equal_the_reference():
    assert set(INPUT_SHAPES) == set(JSHAPES)
    for name, s in JSHAPES.items():
        p = INPUT_SHAPES[name]
        assert (p.name, p.seq_len, p.global_batch, p.kind) == (
            s.name, s.seq_len, s.global_batch, s.kind)


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_model_flops_equal_the_reference(arch):
    cfg, jcfg = get_config(arch), jget(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    for shape in INPUT_SHAPES:
        for m in (16, 32):
            assert roofline.model_flops(arch, shape, m) == jroof.model_flops(
                arch, shape, m)


def _record(arch, shape, mesh, flops, **kw):
    """A dry-run record with the keys that `analyse` reads."""
    rec = {"arch": arch, "shape": shape, "mesh": mesh, "algo": "fedgia",
           "collapsed": True, "num_clients": 16, "fsdp": False,
           "replicate_params": False,
           "per_device": {"argument_bytes": 3 * 2**30,
                          "output_bytes": 2**29, "temp_bytes": 2**28,
                          "flops": flops, "hbm_bytes": 1e9},
           "roofline": {"t_compute_s": flops / 989e12,
                        "t_memory_s": 1e9 / 3.35e12,
                        "t_collective_s": 2e-3, "bottleneck": "collective"}}
    rec.update(kw)
    return rec


RECORDS = [_record("tinyllama-1.1b", "train_4k", "16x16", 3.4e13),
           _record("deepseek-v3-671b", "decode_32k", "2x16x16", 1e11,
                   algo="serve", num_clients=0)]


def test_analyse_gives_the_reference_rows():
    assert roofline.analyse(RECORDS) == jroof.analyse(RECORDS)
    row = roofline.analyse(RECORDS)[0]
    assert row["fit_gib"] == pytest.approx(3.75)
    assert row["useful_ratio"] == pytest.approx(
        jroof.model_flops("tinyllama-1.1b", "train_4k", 16) / 256 / 3.4e13)


def test_main_prints_the_hint_or_the_rows(tmp_path, capsys):
    assert roofline.main(["--dir", str(tmp_path)]) == []
    assert "python -m repro_torch.launch.dryrun --all" in capsys.readouterr().out
    for i, r in enumerate(RECORDS + [dict(RECORDS[0], fsdp=True)]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    rows = roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert len(rows) == 2  # the fsdp variant is a rerun, left out
    assert "tinyllama-1.1b,train_4k,16x16,fedgia," in out
    assert "deepseek-v3-671b,decode_32k,2x16x16,serve," in out


def test_fill_experiments_renders_both_tables(tmp_path):
    # the first record's 3.75 GiB against the card's 79.18 and a copy
    # of it at 100 GiB of temps, over the budget
    big = dict(RECORDS[0], arch="qwen1.5-0.5b", per_device=dict(
        RECORDS[0]["per_device"], temp_bytes=100 * 2**30))
    for i, r in enumerate(RECORDS + [big]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    target = tmp_path / "EXPERIMENTS.md"
    target.write_text("# x\n" + fill_experiments.MARK_DRY + "\n\n"
                      + fill_experiments.MARK_ROOF + "\n")
    fill_experiments.main([str(target), "--dir", str(tmp_path)])
    text = target.read_text()
    assert fill_experiments.MARK_DRY not in text
    assert "Traced OK: 2/40 single-pod, 1/40 multi-pod." in text
    assert ("NVIDIA H100 80GB HBM3, 700.00 W budget is 79.18 GiB"
            in text)
    assert "| tinyllama-1.1b | 3.8 | — | — | — |" in text
    assert "| qwen1.5-0.5b | 103.5 ⚠ | — | — | — |" in text
    assert "| deepseek-v3-671b | decode_32k | 2x16x16 |" in text
