"""Async (stale-x̄) rounds: CR and objective against the staleness bound
(counterpart of part 1 of `benchmarks/async_bench.py`, same rows and
asserts).

    PYTHONPATH=src python -m repro_torch.benchmarks.async_bench [--device cpu]

Sweeps `max_staleness` under a deterministic heterogeneous arrival
process (client i communicates every p_i rounds, p cycling 1..4) and
reports, per algorithm, the communication rounds to the paper's stopping
rule, the final objective and the staleness actually used: how much CR a
bounded-staleness x̄ costs against the synchronous masked run
(max_staleness = 0, which is that run bit for bit). The reference's part
2, the sharded round's all-reduce count, waits for the port's
multi-device client axis.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import AvailabilityParticipation
from repro_torch.device import resolve_device

STALENESS = [0, 1, 2, 4]
K0 = 10
MAX_ROUNDS = 500
ALGOS = {
    "fedgia_d": dict(algorithm="fedgia", sigma_t=0.15, h_policy="diag_ema",
                     alpha=1.0),  # branch split = the arrival mask
    "scaffold": dict(algorithm="scaffold", lr=0.01),
}


def _arrival(m: int, horizon: int) -> AvailabilityParticipation:
    # heterogeneous speeds 1..4 rounds, deterministic (variance-free sweep)
    return AvailabilityParticipation.from_periods(
        m, 1 + (np.arange(m) % 4), horizon=horizon)


def run(device="cuda", collect_history=False):
    """One row per (algorithm, max_staleness); `collect_history` adds
    each run's per-round (f, |grad|^2, staleness max) as `history`."""
    device = resolve_device(device)
    rows = []
    model, batch, tol = make_problem("linreg", 0, device)
    for algo_key, hp in ALGOS.items():
        fed = FedConfig(num_clients=M_CLIENTS, k0=K0, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(device), prng_key(1),
                          init_batch=batch)
        pol = _arrival(M_CLIENTS, MAX_ROUNDS)
        for s in STALENESS:
            res = run_rounds(algo, state, batch, MAX_ROUNDS, tol=tol,
                             participation=pol, async_rounds=True,
                             max_staleness=s)
            rows.append({
                "algo": algo_key,
                "max_staleness": s,
                "staleness_seen": int(res.history["staleness_max"].max()),
                "cr": 2 * res.rounds_run,
                "time_s": res.wall_s,
                "obj": float(res.history["f_xbar"][-1]),
                "converged": res.stopped_early,
            })
            if collect_history:
                rows[-1]["history"] = list(zip(
                    res.history["f_xbar"].tolist(),
                    res.history["grad_sq_norm"].tolist(),
                    res.history["staleness_max"].tolist()))
    return rows


def check(rows):
    """The reference's asserts: bounded staleness stays bounded, and
    staleness does not blow FedGiA's CR beyond 5x its best."""
    for r in rows:
        assert r["staleness_seen"] <= r["max_staleness"], r
    crs = [r["cr"] for r in rows if r["algo"] == "fedgia_d" and r["converged"]]
    if len(crs) >= 2:
        assert max(crs) <= 5 * min(crs), (
            f"staleness blew up FedGiA CR beyond the expected band: {crs}")


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.async_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    print("algo,max_staleness,staleness_seen,CR,time_s,obj,converged")
    for r in rows:
        print(f"{r['algo']},{r['max_staleness']},{r['staleness_seen']},"
              f"{r['cr']},{r['time_s']:.3f},{r['obj']:.6f},{r['converged']}")
    check(rows)
    return rows


if __name__ == "__main__":
    main()
