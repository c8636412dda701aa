"""Paper Fig. 1 on the port: FedGiA objective/error vs ITERATIONS
(k = rounds * k0) for k0 in {1,5,10,15,20}. All curves must reach the
same objective; bigger k0 needs more iterations (rate O(k0/k), Thm IV.3).
Counterpart of `benchmarks/fig1_convergence.py`, same rows and assert.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig1_convergence \
        [--device cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import run_algorithm

K0S = [1, 5, 10, 15, 20]


def run(device="cuda"):
    rows = []
    for k0 in K0S:
        r = run_algorithm("fedgia_d", "linreg", k0, collect_history=True,
                          max_rounds=400, device=device)
        rows.append({
            "k0": k0,
            "iterations": r["rounds"] * k0,
            "rounds": r["rounds"],
            "final_obj": r["obj"],
            "final_err": r["err"],
        })
    return rows


def check(rows):
    objs = [r["final_obj"] for r in rows]
    assert max(objs) - min(objs) < 1e-3, "curves should reach the same objective"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.fig1_convergence")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    print("k0,iterations,rounds,final_obj,final_err")
    for r in rows:
        print(f"{r['k0']},{r['iterations']},{r['rounds']},"
              f"{r['final_obj']:.6f},{r['final_err']:.3e}")
    check(rows)
    return rows


if __name__ == "__main__":
    main()
