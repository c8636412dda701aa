"""Paper Fig. 2 on the port: effect of k0 on CR and wall time. CR
declines then stabilises as k0 rises; time grows with k0 (FedGiA_G more
than FedGiA_D). Counterpart of `benchmarks/fig2_k0.py`, same rows and
assert.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig2_k0 [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import run_algorithm

VARIANTS = ("fedgia_d", "fedgia_g")
K0S = [1, 2, 4, 6, 8, 10, 14, 20]
TRIALS = 2


def run(device="cuda"):
    rows = []
    for variant in VARIANTS:
        for k0 in K0S:
            rs = [run_algorithm(variant, "linreg", k0, seed=s, device=device)
                  for s in range(TRIALS)]
            rows.append({
                "variant": variant, "k0": k0,
                "cr": float(np.mean([r["cr"] for r in rs])),
                "time_s": float(np.mean([r["time_s"] for r in rs])),
            })
    return rows


def check(rows):
    for variant in VARIANTS:
        crs = [r["cr"] for r in rows if r["variant"] == variant]
        assert crs[0] >= crs[-1], f"{variant}: CR should decline with k0"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.fig2_k0")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    print("variant,k0,CR,time_s")
    for r in rows:
        print(f"{r['variant']},{r['k0']},{r['cr']:.1f},{r['time_s']:.3f}")
    check(rows)
    return rows


if __name__ == "__main__":
    main()
