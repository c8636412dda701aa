"""Quickstart: FedGiA on the paper's Example V.1 (counterpart of
`examples/quickstart.py`).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Solves a 128-client non-iid federated least-squares problem to the
paper's tolerance (eq. 35) and contrasts the communication rounds with
FedAvg. Rounds run through the chunked driver (core/engine.py): on the
card each chunk is a replayed CUDA graph and the stop is checked on the
device, so the host reads one flag a chunk.
"""
from __future__ import annotations

import argparse

from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import LeastSquares

M, N, D = 128, 100, 12800
K0 = 5
TOL = 1e-7
MAX_ROUNDS = 600
RUNS = [
    ("fedgia", dict(sigma_t=0.15, h_policy="diag_ema", alpha=0.5)),
    ("fedavg", dict(lr=0.01, alpha=1.0)),
]


def run(device="cuda"):
    """One line per algorithm; returns (lines, the runs' RoundResults)."""
    device = resolve_device(device)
    batch = to_torch(linreg_noniid(0, D, N, M), device)
    model = LeastSquares(N)
    lines, results = [], []
    for algo_name, hp in RUNS:
        fed = FedConfig(algorithm=algo_name, num_clients=M, k0=K0, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(device), prng_key(1),
                          init_batch=batch)
        res = run_rounds(algo, state, batch, MAX_ROUNDS, tol=TOL)
        lines.append(
            f"{algo_name:8s}: f={float(res.history['f_xbar'][-1]):.6f} "
            f"|grad f|^2={float(res.history['grad_sq_norm'][-1]):.2e} "
            f"CR={2 * res.rounds_run} (k0={K0}, m={M}, {res.wall_s:.2f}s)")
        results.append(res)
    return lines, results


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.examples.quickstart")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    lines, results = run(ap.parse_args(argv).device)
    for line in lines:
        print(line)
    return results


if __name__ == "__main__":
    main()
