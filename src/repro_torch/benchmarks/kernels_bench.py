"""Round micro-benchmarks on the port (counterpart of parts 1 and 2 of
`benchmarks/kernels_bench.py`):

  1. the collapsed FedGiA round (the closed form, one fused update: the
     CUDA `fedgia_update` kernel on the card) against the unrolled one
     (the k0-step ADMM loop in torch);
  2. FedGiA against FedAvg per round (paper Table I: one gradient a
     round against k0).

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench \
        [--device cpu]

Each time is the mean of ITERS eager `round_flat` calls after a warm-up
call, in microseconds, and says where it was taken: CUDA events on the
card (named), the host clock on the CPU, which says nothing of the card.
The reference's part 3 (the flat update against its per-leaf pytree
twin) needs the port's pytree rounds, which it does not have yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import flatten_state
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import LeastSquares
from repro_torch.utils.pytree import ravel_spec

ITERS = 20


def clock_name(device) -> str:
    if device.type == "cuda":
        return f"cuda events on {torch.cuda.get_device_name(device)}"
    return "host clock (cpu)"


def _time_us(fn, device, iters=ITERS):
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters * 1e3


def _round_fn(fed, samples, device):
    """One eager round of `fed` on the flat state, as a thunk that leaves
    the state as it was (the undonated update)."""
    model = LeastSquares(100)
    batch = to_torch(linreg_noniid(0, samples, 100, fed.num_clients), device)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1), init_batch=batch)
    spec = ravel_spec(state["x"])
    flat = flatten_state(algo, state, spec)
    return lambda: algo.round_flat(flat, batch, spec)


def bench_collapsed_vs_unrolled(device, m=16, k0=20):
    rows = []
    for collapsed in (True, False):
        fed = FedConfig(algorithm="fedgia", num_clients=m, k0=k0,
                        collapsed=collapsed, sigma_t=0.2, h_policy="diag_ema")
        form = "collapsed" if collapsed else "unrolled"
        rows.append((f"fedgia_round_{form}_k0{k0}",
                     _time_us(_round_fn(fed, 3200, device), device)))
    return rows


def bench_fedgia_vs_fedavg(device, m=16, k0=10):
    rows = []
    for name in ("fedgia", "fedavg"):
        fed = FedConfig(algorithm=name, num_clients=m, k0=k0, sigma_t=0.2,
                        lr=0.01, h_policy="scalar")
        rows.append((f"{name}_round_k0{k0}",
                     _time_us(_round_fn(fed, 6400, device), device)))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.kernels_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    device = resolve_device(ap.parse_args(argv).device)
    rows = bench_collapsed_vs_unrolled(device) + bench_fedgia_vs_fedavg(device)
    clock = clock_name(device)
    print("name,us,clock")
    for name, us in rows:
        print(f"{name},{us:.1f},{clock}")
    return {"unit": "us", "clock": clock,
            "micro": {name: us for name, us in rows}}


if __name__ == "__main__":
    main()
