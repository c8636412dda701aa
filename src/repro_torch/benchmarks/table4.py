"""Paper Table IV on the port: FedAvg / FedProx / FedPD / FedGiA_D /
FedGiA_G across k0 in {1, 5, 10}, Obj, CR (2 per round) and wall time,
plus SCAFFOLD (Table I comparison set). Counterpart of
`benchmarks/table4.py`, same rows.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4 \
        [--device cpu] [--problems linreg] [--k0s 5] [--trials 1]

`--problems`, `--k0s` and `--trials` pick the table's cells (all of them
take tens of minutes on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import run_algorithm

ALGOS = ["fedavg", "fedprox", "fedpd", "scaffold", "fedgia_d", "fedgia_g"]
PROBLEMS = ["linreg", "logreg", "ncvx_logreg"]
K0S = [1, 5, 10]
TRIALS = 3


def run(problems=PROBLEMS, trials: int = TRIALS, k0s=K0S, device="cuda"):
    rows = []
    for problem in problems:
        for algo in ALGOS:
            for k0 in k0s:
                rs = [run_algorithm(algo, problem, k0, seed=s, device=device)
                      for s in range(trials)]
                rows.append({
                    "problem": problem, "algo": algo, "k0": k0,
                    "obj": float(np.mean([r["obj"] for r in rs])),
                    "cr": float(np.mean([r["cr"] for r in rs])),
                    "time_s": float(np.mean([r["time_s"] for r in rs])),
                    "conv_frac": float(np.mean([r["converged"] for r in rs])),
                })
    return rows


def csv_lines(rows):
    yield "problem,algo,k0,obj,CR,time_s,converged_frac"
    for r in rows:
        yield (f"{r['problem']},{r['algo']},{r['k0']},{r['obj']:.4f},"
               f"{r['cr']:.1f},{r['time_s']:.3f},{r['conv_frac']:.2f}")


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.table4")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--problems", nargs="+", default=PROBLEMS,
                    choices=PROBLEMS)
    ap.add_argument("--k0s", nargs="+", type=int, default=K0S)
    ap.add_argument("--trials", type=int, default=TRIALS)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    rows = run(args.problems, args.trials, args.k0s, args.device)
    for line in csv_lines(rows):
        print(line)
    return rows


if __name__ == "__main__":
    main()
