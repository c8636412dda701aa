"""Paper Fig. 3 on the port: effect of the selection fraction alpha — little
CR impact at k0 = 10, FedGiA_D time roughly flat in alpha. Counterpart of
`benchmarks/fig3_alpha.py`, same rows and assert.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig3_alpha [--device cpu]

alpha is applied through the ENGINE's uniform participation policy
(`core/selection.py`), the mechanism every algorithm shares: FedGiA runs
with alpha = 1.0 in its config, so the engine's mask is its ADMM/GD
split and its own draw is bypassed. The masks come from the policy's
threefry key (`core/prng.py`), so the card, the CPU and the reference
run the same ones.
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

ALPHAS = [0.1, 0.25, 0.5, 0.75, 1.0]
K0 = 10
MAX_ROUNDS = 500


def run(device="cuda", collect_history=False):
    """One row per alpha; `collect_history` adds each run's per-round
    (f, |grad|^2) as `history`, as `common.run_algorithm` does."""
    device = resolve_device(device)
    model, batch, tol = make_problem("linreg", 0, device)
    fed = FedConfig(algorithm="fedgia", num_clients=M_CLIENTS, k0=K0,
                    alpha=1.0, sigma_t=0.15, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1),
                      init_batch=batch)
    rows = []
    for alpha in ALPHAS:
        res = run_rounds(algo, state, batch, MAX_ROUNDS, tol=tol,
                         participation=UniformParticipation(M_CLIENTS, alpha))
        rows.append({"alpha": alpha, "rounds": res.rounds_run,
                     "cr": 2 * res.rounds_run, "time_s": res.wall_s,
                     "obj": float(res.history["f_xbar"][-1]),
                     "converged": res.stopped_early})
        if collect_history:
            rows[-1]["history"] = list(zip(
                res.history["f_xbar"].tolist(),
                res.history["grad_sq_norm"].tolist()))
    return rows


def check(rows):
    crs = [r["cr"] for r in rows]
    assert max(crs) <= 3 * min(crs), \
        "alpha should not affect CR strongly at k0=10"


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.fig3_alpha")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    rows = run(ap.parse_args(argv).device)
    print("alpha,CR,time_s,obj")
    for r in rows:
        print(f"{r['alpha']},{r['cr']},{r['time_s']:.3f},{r['obj']:.6f}")
    check(rows)
    return rows


if __name__ == "__main__":
    main()
