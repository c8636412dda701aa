"""Federated training driver for the port: FedGiA and the paper's four
comparison baselines on the paper's problems.

  PYTHONPATH=src python -m repro_torch.launch.train --problem linreg \
      --algo fedgia --clients 128 --k0 5 --rounds 200 --tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.train --algo fedprox --lr 0.002

Runs on the CUDA device unless `--device cpu` is given, in which case the
plain PyTorch versions stand in for the CUDA kernels. Same flags and
defaults as the main-path subset of `repro.launch.train`, and the same
closing `done:` line. `--alpha` is FedGiA's ADMM/GD split; the baselines
run with every client, as the reference's do without a participation
policy.

Rounds run in chunks (`core/engine.py`): on the card each chunk length is
captured once as a CUDA graph and replayed, with the eq. (35) stop
checked on the device and read by the host once a chunk. `--chunk N`
sets the rounds a chunk (0: the reference's sizing); `--no-scan` runs the
legacy per-round loop instead.
"""
from __future__ import annotations

import argparse
import logging
import sys

from repro_torch.config import ALGORITHMS, FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.selection import make_generator
from repro_torch.data import linreg_noniid, logreg_data, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
)

LOG_EVERY = 10


def get_logger(name: str = "train") -> logging.Logger:
    logger = logging.getLogger(f"repro_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname).1s {name}] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


log = get_logger("train")


def build_problem(args, device):
    n = args.dim
    if args.problem == "linreg":
        model = LeastSquares(n)
        raw = linreg_noniid(args.seed, args.samples, n, args.clients)
    elif args.problem == "logreg":
        model = LogisticRegression(n)
        raw = logreg_data(args.seed, args.samples, n, args.clients)
    else:
        model = NonConvexLogistic(n)
        raw = logreg_data(args.seed, args.samples, n, args.clients)
    return model, model.loss, model.init(device), to_torch(raw, device)


def train(args) -> dict:
    """Run one training job. Returns the summary, plus the run's algorithm
    object, client batch and final state (`algorithm`, `batch`, `state`)
    for callers that go on from it."""
    device = resolve_device(args.device)
    model, loss_fn, params0, batch = build_problem(args, device)
    fed = FedConfig(algorithm=args.algo, num_clients=args.clients, k0=args.k0,
                    alpha=args.alpha, sigma_t=args.sigma_t,
                    h_policy=args.h_policy, lr=args.lr)
    algo = make_algorithm(fed, loss_fn, model=model)
    state = algo.init(params0, make_generator(args.seed + 1),
                      init_batch=batch)
    res = run_rounds(algo, state, batch, args.rounds, tol=args.tol,
                     scan=not args.no_scan, chunk_size=args.chunk)
    history = [
        {"round": r, "f": float(res.history["f_xbar"][r]),
         "err": float(res.history["grad_sq_norm"][r])}
        for r in range(res.rounds_run)
    ]
    for h in history:
        if h["round"] % LOG_EVERY == 0 or h["round"] == res.rounds_run - 1:
            log.info("round %4d  f=%.6f  |grad|^2=%.3e",
                     h["round"], h["f"], h["err"])
    if res.stopped_early:
        log.info("tolerance reached at round %d", res.rounds_run - 1)
    result = {
        "algo": args.algo,
        "device": str(device),
        "rounds": res.rounds_run,
        "cr": 2 * res.rounds_run,
        "stopped_early": res.stopped_early,
        "final_f": history[-1]["f"],
        "final_err": history[-1]["err"],
        "wall_s": res.wall_s,
        "capture_s": res.capture_s,
        "history": history,
        "algorithm": algo,
        "batch": batch,
        "state": res.state,
    }
    if not args.no_scan:
        log.info("chunked driver: warm-up and capture %.3fs (outside the "
                 "rounds' time)", res.capture_s)
    log.info(
        "done: %d rounds (CR=%d) in %.2fs  f=%.6f err=%.2e",
        result["rounds"], result["cr"], res.wall_s, result["final_f"],
        result["final_err"],
    )
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--problem", default="linreg",
                    choices=["linreg", "logreg", "ncvx_logreg"])
    ap.add_argument("--algo", default="fedgia", choices=list(ALGORITHMS))
    ap.add_argument("--clients", type=int, default=128)
    ap.add_argument("--k0", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sigma-t", type=float, default=0.15)
    ap.add_argument("--h-policy", default="scalar",
                    choices=["scalar", "diag_ema", "gram"])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--samples", type=int, default=12800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.01,
                    help="the baselines' learning rate a (gamma_k = "
                         "a / log2(k + 2))")
    ap.add_argument("--no-scan", action="store_true",
                    help="legacy per-round loop (one host read a round "
                         "when --tol > 0)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="rounds a chunk, one CUDA-graph replay each on "
                         "the card (0 = the whole run when --tol <= 0, "
                         "else 32)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
