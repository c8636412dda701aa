"""Wall-clock rounds: simulated time to the paper's stopping rule against
straggler severity (counterpart of `benchmarks/wallclock_bench.py::run`,
same rows, and its asserts on them).

    PYTHONPATH=src python -m repro_torch.benchmarks.wallclock_bench \
        [--device cpu] [--max-rounds 400]

Per (algorithm, spread, weighting) the sweep runs clock-driven async
rounds: constant per-client speeds geometrically spaced from 1 s to
`spread` s, staleness bounded at MAX_STALENESS, eq. (11) uniform or
"poly"-weighted. Each row reports the rounds to target (CR), the
simulated seconds to target (`sim_time` at the stopping round) and the
staleness used. spread = 1 is the homogeneous fleet: every client
arrives every round. The sweep is deterministic (simulated time, no
random draw), so CR and sim_time are the same on any device.

The reference's compression, overlap and fault rows wait for the port's
codecs, faults and multi-device client axis.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.device import resolve_device

MAX_ROUNDS = 400
K0 = 10
MAX_STALENESS = 4
SPREADS = [1.0, 4.0, 16.0]
WEIGHTINGS = ["uniform", "poly"]
ALGOS = {
    "fedgia_d": dict(algorithm="fedgia", sigma_t=0.15, h_policy="diag_ema",
                     alpha=1.0),  # branch split = the arrival mask
    "scaffold": dict(algorithm="scaffold", lr=0.01),
    "fedavg": dict(algorithm="fedavg", lr=0.01),
}


def straggler_speeds(m: int, spread: float) -> np.ndarray:
    """Per-client compute seconds geometrically spaced in [1, spread]:
    the severity knob is the slow/fast ratio."""
    if spread <= 1.0:
        return np.ones(m, np.float32)
    return spread ** (np.arange(m, dtype=np.float32) / (m - 1))


def run(device="cuda", max_rounds: int = MAX_ROUNDS, collect_history=False):
    """One row per (algorithm, spread, weighting); `collect_history` adds
    each run's per-round (f, |grad|^2, staleness max, sim_time) as
    `history`."""
    device = resolve_device(device)
    rows = []
    model, batch, tol = make_problem("linreg", 0, device)
    for algo_key, hp in ALGOS.items():
        fed = FedConfig(num_clients=M_CLIENTS, k0=K0, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(device), prng_key(1),
                          init_batch=batch)
        for spread in SPREADS:
            clk = ComputeClock(M_CLIENTS, straggler_speeds(M_CLIENTS, spread))
            for weighting in WEIGHTINGS:
                res = run_rounds(algo, state, batch, max_rounds, tol=tol,
                                 clock=clk, max_staleness=MAX_STALENESS,
                                 stale_weighting=weighting)
                rows.append({
                    "algo": algo_key,
                    "spread": spread,
                    "weighting": weighting,
                    "cr": 2 * res.rounds_run,
                    "sim_time_s": float(res.history["sim_time"][-1]),
                    "staleness_seen": int(res.history["staleness_max"].max()),
                    "obj": float(res.history["f_xbar"][-1]),
                    "converged": res.stopped_early,
                    "time_s": res.wall_s,
                })
                if collect_history:
                    rows[-1]["history"] = list(zip(
                        res.history["f_xbar"].tolist(),
                        res.history["grad_sq_norm"].tolist(),
                        res.history["staleness_max"].tolist(),
                        res.history["sim_time"].tolist()))
    return rows


def check(rows, max_rounds: int = MAX_ROUNDS):
    """The reference's asserts on these rows: bounded staleness, the
    homogeneous fleet carries only the one-round pipeline delay, and at
    the full round budget FedGiA under uniform weighting reaches the
    stopping rule at every spread."""
    for r in rows:
        assert r["staleness_seen"] <= MAX_STALENESS, r
    by_key = {(r["algo"], r["spread"], r["weighting"]): r for r in rows}
    for algo_key in ALGOS:
        u = by_key[(algo_key, 1.0, "uniform")]
        assert u["staleness_seen"] <= 1, u
    if max_rounds >= 400:
        for spread in SPREADS:
            r = by_key[("fedgia_d", spread, "uniform")]
            assert r["converged"], r


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.wallclock_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--max-rounds", type=int, default=MAX_ROUNDS)
    args = ap.parse_args(argv)
    rows = run(args.device, args.max_rounds)
    print("algo,spread,weighting,CR,sim_time_s,staleness_seen,obj,"
          "converged")
    for r in rows:
        print(f"{r['algo']},{r['spread']:g},{r['weighting']},{r['cr']},"
              f"{r['sim_time_s']:.2f},{r['staleness_seen']},"
              f"{r['obj']:.6f},{r['converged']}")
    check(rows, args.max_rounds)
    return rows


if __name__ == "__main__":
    main()
