"""Partial-participation benchmark on the port (paper Fig. 3's mechanism,
in the engine): the selection fraction alpha swept with the engine's
uniform participation policy, for FedGiA_D and SCAFFOLD, to the paper's
stopping rule; CR, wall time, final objective and the participants a
round. Counterpart of the single-device part of
`benchmarks/participation_bench.py`, same rows and assert.

    PYTHONPATH=src python -m repro_torch.benchmarks.participation_bench \
        [--device cpu]

The reference's second part, the same sweep on a client axis sharded
over 8 devices, needs the port's multi-device client axis, which it does
not have yet.
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import UniformParticipation
from repro_torch.device import resolve_device

ALPHAS = [0.1, 0.25, 0.5, 1.0]
K0 = 10
MAX_ROUNDS = 500
ALGOS = {
    "fedgia_d": dict(algorithm="fedgia", sigma_t=0.15, h_policy="diag_ema",
                     alpha=1.0),  # the branch split is the engine's mask
    "scaffold": dict(algorithm="scaffold", lr=0.01),
}


def run(device="cuda"):
    device = resolve_device(device)
    model, batch, tol = make_problem("linreg", 0, device)
    rows = []
    for algo_key, hp in ALGOS.items():
        fed = FedConfig(num_clients=M_CLIENTS, k0=K0, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(device), prng_key(1),
                          init_batch=batch)
        for alpha in ALPHAS:
            pol = UniformParticipation(M_CLIENTS, alpha, seed=0)
            res = run_rounds(algo, state, batch, MAX_ROUNDS, tol=tol,
                             participation=pol)
            rows.append({
                "algo": algo_key,
                "alpha": alpha,
                "selected": int(res.history["selected"][0]),
                "cr": 2 * res.rounds_run,
                "time_s": res.wall_s,
                "obj": float(res.history["f_xbar"][-1]),
                "converged": res.stopped_early,
            })
    return rows


def check(rows):
    """Paper Fig. 3: at k0 = 10 the CR FedGiA needs to converge depends
    only weakly on alpha."""
    crs = [r["cr"] for r in rows if r["algo"] == "fedgia_d" and r["converged"]]
    if len(crs) >= 2:
        assert max(crs) <= 3 * min(crs), \
            f"alpha swung FedGiA CR too much: {crs}"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.participation_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    print("algo,alpha,selected,CR,time_s,obj,converged")
    for r in rows:
        print(f"{r['algo']},{r['alpha']},{r['selected']},{r['cr']},"
              f"{r['time_s']:.3f},{r['obj']:.6f},{r['converged']}")
    check(rows)
    return rows


if __name__ == "__main__":
    main()
