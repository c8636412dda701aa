"""Render the dry-run summary and the roofline table from the dry run's
records into a Markdown file (counterpart of
`benchmarks/fill_experiments.py`): each marker line in the target is
replaced by its table.

    PYTHONPATH=src python -m repro_torch.benchmarks.fill_experiments \
        TARGET.md [--dir results/dryrun]

The per-card budget is an H100's, as `chip_smoke.py` phase 2j prints it:
`torch.cuda.get_device_properties(0).total_memory` of an NVIDIA H100
80GB HBM3 at 700.00 W (`CARD`, as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives it) is 85,017,493,504 bytes, 79.18 GiB
(`CARD_GIB`).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.roofline import analyse, load_records
from repro_torch.configs import list_architectures

MARK_DRY = "<!-- DRYRUN_SUMMARY -->"
MARK_ROOF = "<!-- ROOFLINE_TABLE -->"
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
CARD_GIB = 85_017_493_504 / 2**30  # total_memory, H100 80GB HBM3, 700 W
CARD = "NVIDIA H100 80GB HBM3, 700.00 W"


def render(recs):
    base = [r for r in recs if r["algo"] in ("fedgia", "serve")
            and r.get("collapsed", True) and not r.get("fsdp")
            and not r.get("replicate_params")]
    rows = analyse(base)

    # ---- dry-run summary: trace matrix + memory fit
    n1 = sum(1 for r in base if r["mesh"] == "16x16")
    n2 = sum(1 for r in base if r["mesh"] == "2x16x16")
    lines = [f"Traced OK: {n1}/40 single-pod, {n2}/40 multi-pod.", ""]
    lines.append("Per-card memory (args+outputs+temps, GiB) from the dry "
                 "run's fake-tensor trace of the port's step — the "
                 f"{CARD} budget is {CARD_GIB:.2f} GiB "
                 "(`torch.cuda.get_device_properties(0).total_memory`):")
    lines.append("")
    lines.append("| arch | " + " | ".join(SHAPES) + " |")
    lines.append("|---|---|---|---|---|")
    fit = {(r["arch"], r["shape"], r["mesh"]): r for r in rows}
    for arch in list_architectures():
        cells = []
        for shape in SHAPES:
            r = fit.get((arch, shape, "16x16"))
            if r is None:
                cells.append("—")
                continue
            g = r["fit_gib"]
            cells.append(f"{g:.1f}" + (" ⚠" if g > CARD_GIB else ""))
        lines.append(f"| {arch} | " + " | ".join(cells) + " |")
    lines.append("")
    lines.append(f"⚠ = exceeds one card's {CARD_GIB:.2f} GiB as configured "
                 "(the port holds no remat: every layer's activations are "
                 "live for the backward; unfused bytes are an upper bound).")
    dry = "\n".join(lines)

    # ---- roofline table
    rl = ["| arch | shape | mesh | compute ms | memory ms | collective ms |"
          " bottleneck | useful ratio |",
          "|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"], x["mesh"])):
        rl.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} |"
            f" {r['t_compute_ms']:.1f} | {r['t_memory_ms']:.1f} |"
            f" {r['t_collective_ms']:.1f} | {r['bottleneck']} |"
            f" {r['useful_ratio']:.2f} |"
        )
    rl.append("")
    rl.append("`useful ratio` = MODEL_FLOPS / traced FLOPs per card, where "
              "MODEL_FLOPS = 6·N_active·tokens (train round; FedGiA computes "
              "ONE gradient per round) or 2·N_active·tokens (serving). "
              "Ratios < 1 expose non-model compute: the quadratic attention "
              "term (dominant at 32k prefill), MoE dispatch overhead "
              "(capacity factor 1.25), and the masked score blocks that the "
              "plain attention computes and the flash kernel skips.")
    roof = "\n".join(rl)
    return dry, roof


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.fill_experiments")
    ap.add_argument("target", help="the Markdown file holding the markers")
    ap.add_argument("--dir", default="results/dryrun")
    args = ap.parse_args(argv)
    dry, roof = render(load_records(args.dir))
    with open(args.target) as f:
        s = f.read()
    s = s.replace(MARK_DRY, dry).replace(MARK_ROOF, roof)
    with open(args.target, "w") as f:
        f.write(s)
    print(f"{args.target} updated")


if __name__ == "__main__":
    main()
