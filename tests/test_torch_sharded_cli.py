"""The port's CLI and launcher for client-sharded and overlapped runs
(`--shard-clients`, `--pod`, `--overlap`; mirrors the reference's flag
checks in repro/launch/train.py and its engine's refusals under a mesh).

  * `python -m repro_torch.launch.train --device cpu --shard-clients 4
    [--pod 2] [--overlap scatter]` runs 4 gloo ranks and prints the
    unsharded run's `done:` line: the same rounds and CR, f and err equal
    to the line's printed resolution (the runs agree at fp tolerance);
  * every reference refusal of the flags, and of `run_rounds` under a
    mesh, raises with its message;
  * a CUDA job with more ranks than devices raises with the device
    count, and a rank's exception makes the CLI exit non-zero.
"""
import argparse
import os
import re
import subprocess
import sys

import pytest
import torch

from conftest import SRC
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares

BASE = ["--device", "cpu", "--clients", "32", "--rounds", "30"]
RUNS = {
    "unsharded": [],
    "shard4": ["--shard-clients", "4"],
    "pod2": ["--shard-clients", "4", "--pod", "2"],
    "overlap": ["--overlap", "scatter"],
    "shard4_overlap": ["--shard-clients", "4", "--overlap", "scatter"],
    "pod2_overlap": ["--shard-clients", "4", "--pod", "2", "--overlap",
                     "scatter"],
    "shard4_fedpd_async": ["--shard-clients", "4", "--algo", "fedpd",
                           "--lr", "0.05", "--participation", "straggler",
                           "--async", "--max-staleness", "2"],
    "fedpd_async": ["--algo", "fedpd", "--lr", "0.05", "--participation",
                    "straggler", "--async", "--max-staleness", "2"],
}
# CLI processes at a time (a sharded one spawns 4 ranks)
CONCURRENT = 4
DONE = re.compile(r"done: (\d+) rounds \(CR=(\d+)\) in [\d.]+s  "
                  r"f=([-\d.]+) err=([-\d.e+]+)")


def _cli(extra):
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE, *extra],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def lines():
    """Every CLI run of RUNS, at most CONCURRENT at a time: name -> its
    `done:` fields."""
    out, running = {}, []

    def finish(k, p):
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{k}:\n{log[-4000:]}"
        found = DONE.findall(log)
        assert len(found) == 1, f"{k}: one done: line from rank 0\n{log}"
        out[k] = found[0]

    for k, v in RUNS.items():
        if len(running) == CONCURRENT:
            finish(*running.pop(0))
        running.append((k, _cli(v)))
    for k, p in running:
        finish(k, p)
    return out


def _same_line(a, b):
    assert a[:2] == b[:2]  # rounds, CR
    assert abs(float(a[2]) - float(b[2])) <= 2e-6  # f, printed %.6f
    assert float(a[3]) == pytest.approx(float(b[3]), rel=1e-2)  # %.2e


@pytest.mark.parametrize("run", ["shard4", "pod2", "overlap",
                                 "shard4_overlap", "pod2_overlap"])
def test_cli_sharded_done_line_matches_unsharded(lines, run):
    """FedGiA (the CLI's defaults, to its eq. (35) stop) on 4 gloo ranks,
    as a (pod 2, data 2) mesh and overlapped: the unsharded line."""
    _same_line(lines[run], lines["unsharded"])


def test_cli_sharded_async_baseline(lines):
    """FedPD's straggler async rounds on 4 ranks: the unsharded line."""
    _same_line(lines["shard4_fedpd_async"], lines["fedpd_async"])


@pytest.mark.parametrize("flags,match", [
    (["--pod", "2"], "requires --shard-clients"),
    (["--shard-clients", "4", "--pod", "3"], "divisible by --pod"),
    (["--shard-clients", "4", "--chunk", "auto"], "fixed --chunk"),
    (["--shard-clients", "4", "--participation", "uniform", "--store",
      "offload"], "single-device host/device split"),
    (["--overlap", "scatter", "--participation", "uniform", "--store",
      "offload"], "does not ride it"),
    (["--overlap", "scatter", "--no-flat"], "requires the flat round path"),
    (["--shard-clients", "4", "--checkpoint-every", "2",
      "--checkpoint-dir", "ck"], "runs unsharded"),
    (["--shard-clients", "5"], "divisible by --shard-clients"),
    (["--shard-clients", "4", "--participation", "uniform", "--store",
      "offload", "--compression", "int8"],
     "single-device host/device split"),
    (["--shard-clients", "4", "--compression", "int8", "--resume",
      "--checkpoint-dir", "ck"], "runs unsharded"),
    (["--overlap", "scatter", "--faults", "nan", "--participation",
      "uniform", "--store", "offload"], "does not ride it"),
])
def test_cli_refusals(flags, match):
    args = train_mod.build_parser().parse_args(BASE + flags)
    with pytest.raises(SystemExit, match=match):
        train_mod.validate_flags(args)


def _small():
    model = LeastSquares(24)
    batch = to_torch(linreg_noniid(0, 320, 24, 8), "cpu")
    algo = make_algorithm(FedConfig(algorithm="fedgia", num_clients=8),
                          model.loss, model=model)
    return algo, algo.init(model.init("cpu"), prng_key(1),
                           init_batch=batch), batch


# a mesh object: the refusals raise before any process group is used
_MESH = mesh_mod.Mesh(("data", "model"), (4, 1), 0, torch.device("cpu"))


@pytest.mark.parametrize("kw,exc,match", [
    (dict(chunk_size="auto"), ValueError, "fixed chunk_size under a mesh"),
    (dict(participation="uniform", store="offload"), ValueError,
     "single-device host/device split"),
    (dict(checkpoint_every=2, checkpoint_dir="ck"), ValueError,
     "not supported under a mesh"),
    (dict(participation="uniform", store="offload", compression="bf16"),
     ValueError, "single-device host/device split"),
    (dict(resume=True, checkpoint_dir="ck", compression="bf16"), ValueError,
     "not supported under a mesh"),
    (dict(client_axis="pod"), ValueError, "mesh has no axis"),
])
def test_engine_refusals_under_a_mesh(kw, exc, match):
    algo, state, batch = _small()
    if kw.get("participation") == "uniform":
        kw = dict(kw, participation=make_policy("uniform", 8, 0.5, seed=0))
    with pytest.raises(exc, match=match):
        run_rounds(algo, state, batch, 2, mesh=_MESH, **kw)


def test_launch_needs_a_device_a_rank():
    """NCCL takes one device a rank: with fewer the launcher raises with
    the count, and no gloo run on the card takes its place."""
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match=f"this machine has {count}"):
        mesh_mod.check_devices(count + 1, "cuda")
    mesh_mod.check_devices(8, "cpu")


def test_rank_exception_exits_nonzero():
    """An error inside the ranks (the overlap's padded buffer, 128 lanes,
    does not divide over 3 shards) makes the CLI exit non-zero with the
    rank's message."""
    p = _cli(["--clients", "33", "--shard-clients", "3", "--overlap",
              "scatter", "--rounds", "2"])
    log, _ = p.communicate(timeout=300)
    assert p.returncode != 0
    assert "must divide over 3 client shards" in log


def test_parser_defaults():
    """The flags default to the unsharded barrier run."""
    args = train_mod.build_parser().parse_args([])
    assert (args.shard_clients, args.pod, args.overlap) == (0, 0, "off")
    assert isinstance(argparse.Namespace(**vars(args)), argparse.Namespace)
