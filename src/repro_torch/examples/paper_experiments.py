"""Reproduce the paper's §V experiments end to end on the port (compact
settings; counterpart of `examples/paper_experiments.py`).

    PYTHONPATH=src python -m repro_torch.examples.paper_experiments \
        [--full] [--device cpu]

Covers Table IV (algorithm comparison), Fig. 1 (k0 vs iterations),
Fig. 2 (k0 vs CR / time) and Fig. 3 (alpha effect). `--full` runs Table
IV on all three problems (default: linreg only).
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks import (
    fig1_convergence,
    fig2_k0,
    fig3_alpha,
    table4,
)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.paper_experiments")
    ap.add_argument("--full", action="store_true",
                    help="all three problems (default: linreg only)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    print("== Table IV (Obj / CR / time) ==")
    problems = table4.PROBLEMS if args.full else ["linreg"]
    rows = table4.run(problems=problems, trials=1, device=args.device)
    for r in rows:
        print(f"  {r['problem']:12s} {r['algo']:9s} k0={r['k0']:<3d}"
              f" obj={r['obj']:.4f} CR={r['cr']:7.1f} t={r['time_s']:.2f}s")

    print("== Fig. 1: k0 vs iterations to converge ==")
    for r in fig1_convergence.run(args.device):
        print(f"  k0={r['k0']:<3d} iterations={r['iterations']:<6d}"
              f" rounds={r['rounds']:<5d} f={r['final_obj']:.6f}")

    print("== Fig. 2: k0 vs CR / time ==")
    for r in fig2_k0.run(args.device):
        print(f"  {r['variant']:9s} k0={r['k0']:<3d} CR={r['cr']:7.1f}"
              f" t={r['time_s']:.2f}s")

    print("== Fig. 3: alpha vs CR / time ==")
    for r in fig3_alpha.run(args.device):
        print(f"  alpha={r['alpha']:<5.2f} CR={r['cr']:<6d}"
              f" t={r['time_s']:.2f}s obj={r['obj']:.6f}")
    return rows


if __name__ == "__main__":
    main()
