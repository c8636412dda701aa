"""Roofline analysis over the dry-run records (counterpart of
`benchmarks/roofline.py`).

Reads results/dryrun/*.json (written by `repro_torch.launch.dryrun`, or
by the reference's dry run: the keys are the same), derives per
(arch x shape x mesh):
  - the three roofline terms (compute / memory / collective, seconds/card)
  - the dominant bottleneck
  - MODEL_FLOPS = 6 N D (dense) or 6 N_active D (MoE) per train round /
    2 N D per generated/prefilled token for serving
  - MODEL_FLOPS / traced FLOPs (useful-compute ratio; catches waste such
    as the plain attention's masked score blocks)

    PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--dir D]
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from repro_torch.config import INPUT_SHAPES
from repro_torch.configs import get_config

CHIPS = {"16x16": 256, "2x16x16": 512}


def model_flops(arch: str, shape_name: str, num_clients: int,
                k0: int = 5) -> float:
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        # one FedGiA round: ONE fwd+bwd over the global batch (C2: the k0
        # ADMM iterations are gradient-free) => 6 * N_active * tokens
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per request
    return 2.0 * n_active * shape.global_batch


def load_records(path: str = "results/dryrun"):
    recs = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def analyse(recs, chips_map=None):
    chips_map = chips_map or CHIPS
    rows = []
    for r in recs:
        chips = chips_map[r["mesh"]]
        mf_total = model_flops(r["arch"], r["shape"], r.get("num_clients", 16))
        mf_per_chip = mf_total / chips
        hlo = r["per_device"]["flops"]
        rows.append({
            "arch": r["arch"],
            "shape": r["shape"],
            "mesh": r["mesh"],
            "algo": r["algo"],
            "collapsed": r.get("collapsed", True),
            "t_compute_ms": r["roofline"]["t_compute_s"] * 1e3,
            "t_memory_ms": r["roofline"]["t_memory_s"] * 1e3,
            "t_collective_ms": r["roofline"]["t_collective_s"] * 1e3,
            "bottleneck": r["roofline"]["bottleneck"],
            "model_flops_per_chip": mf_per_chip,
            "hlo_flops_per_chip": hlo,
            "useful_ratio": (mf_per_chip / hlo) if hlo else 0.0,
            "fit_gib": (r["per_device"]["argument_bytes"]
                        + r["per_device"]["output_bytes"]
                        + r["per_device"]["temp_bytes"]) / 2**30,
        })
    return rows


HINT = ("no dry-run records found — run: "
        "python -m repro_torch.launch.dryrun --all")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.roofline")
    ap.add_argument("--dir", default="results/dryrun",
                    help="the dry run's records")
    args = ap.parse_args(argv)
    recs = load_records(args.dir)
    if not recs:
        print(HINT)
        return []
    # baseline records only (the perf variants are reruns)
    base, seen = [], set()
    for r in recs:
        if (r.get("fsdp") or r.get("replicate_params")
                or not r.get("collapsed", True)):
            continue
        key = (r["arch"], r["shape"], r["mesh"])
        if key in seen:
            continue
        seen.add(key)
        base.append(r)
    rows = analyse(base)
    print("arch,shape,mesh,algo,t_compute_ms,t_memory_ms,t_collective_ms,"
          "bottleneck,useful_ratio,fit_GiB")
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        print(f"{r['arch']},{r['shape']},{r['mesh']},{r['algo']},"
              f"{r['t_compute_ms']:.3f},{r['t_memory_ms']:.3f},"
              f"{r['t_collective_ms']:.3f},{r['bottleneck']},"
              f"{r['useful_ratio']:.3f},{r['fit_gib']:.2f}")
    return rows


if __name__ == "__main__":
    main()
