"""Shared harness of the port's paper runners: runs a federated algorithm
to the paper's stopping rule (eq. 35) and reports Obj / CR / wall time
like Table IV (counterpart of `benchmarks/common.py`, same constants,
hyper-parameters and rows).

Every run goes through `core/engine.py::run_rounds` with its default
chunked driver: on the card each chunk is a replayed CUDA graph, the
stop is checked on the device, and the warm-up and capture are kept out
of `time_s` (the reference compiles its chunks before its timed window).
Runs take `device="cuda"` unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, logreg_data, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
)

# CPU-budget problem sizes (paper: m=128, n in {100, 1024, 200}, d up to 2e5)
M_CLIENTS = 64
N_DIM = 100
D_SAMPLES = 6400
MAX_ROUNDS = 500

ALGO_HPARAMS = {
    # paper §V.D settings adapted to the synthetic stand-in data
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002, prox_mu=1e-4, inner_steps=5),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0, inner_steps=5),
    "scaffold": dict(lr=0.01),
    "fedgia_d": dict(sigma_t=0.15, h_policy="diag_ema", alpha=0.5),
    "fedgia_g": dict(sigma_t=0.15, h_policy="gram", alpha=0.5, collapsed=False),
    "fedgia": dict(sigma_t=0.15, h_policy="scalar", alpha=0.5),
}


def make_problem(name: str, seed: int, device="cuda"):
    """(model, client batch on `device`, eq. (35) tolerance) of one of the
    paper's three problems at the runners' sizes."""
    if name == "linreg":
        model = LeastSquares(N_DIM)
        raw = linreg_noniid(seed, D_SAMPLES, N_DIM, M_CLIENTS)
        tol = 1e-7
    elif name == "logreg":
        model = LogisticRegression(N_DIM)
        raw = logreg_data(seed, D_SAMPLES, N_DIM, M_CLIENTS)
        tol = (5.0 / D_SAMPLES) * 1e-6
    elif name == "ncvx_logreg":
        model = NonConvexLogistic(N_DIM)
        raw = logreg_data(seed, D_SAMPLES, N_DIM, M_CLIENTS)
        tol = (5.0 / D_SAMPLES) * 1e-6
    else:
        raise KeyError(name)
    return model, to_torch(raw, device), tol


def run_algorithm(algo_key: str, problem: str, k0: int, seed: int = 0,
                  max_rounds: int = MAX_ROUNDS, collect_history: bool = False,
                  scan: bool = True, device="cuda"):
    """One Table IV cell: `algo_key` of `ALGO_HPARAMS` on `problem` with
    local steps k0, run to the eq. (35) stop or `max_rounds`."""
    device = resolve_device(device)
    model, batch, tol = make_problem(problem, seed, device)
    hp = dict(ALGO_HPARAMS[algo_key])
    name = "fedgia" if algo_key.startswith("fedgia") else algo_key
    alpha = hp.pop("alpha", 1.0)  # baselines: full participation (paper §V.D)
    fed = FedConfig(algorithm=name, num_clients=M_CLIENTS, k0=k0, alpha=alpha,
                    **hp)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(seed + 1),
                      init_batch=batch)
    res = run_rounds(algo, state, batch, max_rounds, tol=tol, scan=scan)
    hist = (
        list(zip(res.history["f_xbar"].tolist(),
                 res.history["grad_sq_norm"].tolist()))
        if collect_history else []
    )
    return {
        "algo": algo_key,
        "problem": problem,
        "k0": k0,
        "obj": float(res.history["f_xbar"][-1]),
        "err": float(res.history["grad_sq_norm"][-1]),
        "rounds": res.rounds_run,
        "cr": 2 * res.rounds_run,
        "time_s": res.wall_s,
        "converged": res.stopped_early,
        "history": hist,
    }
