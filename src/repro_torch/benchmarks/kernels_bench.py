"""Round micro-benchmarks on the port (counterpart of
`benchmarks/kernels_bench.py`):

  1. the collapsed FedGiA round (the closed form, one fused update: the
     CUDA `fedgia_update` kernel on the card) against the unrolled one
     (the k0-step ADMM loop in torch);
  2. FedGiA against FedAvg per round (paper Table I: one gradient a
     round against k0);
  3. the round's update alone at model scale (m 16, n 200000, k0 20):
     the fused flat pass (`ops.fedgia_update_flat`, the CUDA kernel on
     the card, its plain version on the CPU) against the same arithmetic
     over a 10-leaf pytree in eager torch (what the per-leaf round runs)
     and against the k0-step unrolled oracle (`ref.fedgia_update_ref`,
     the reference's `use_kernel=False` row). The flat operands are
     lane-padded once, outside the timing, as the engine's buffers are.

    PYTHONPATH=src python -m repro_torch.benchmarks.kernels_bench \
        [--device cpu] [--parts 1,2,3]

Parts 1 and 2 run by default; `--parts 1,2,3` adds part 3, as
`benchmarks/run.py`'s kernels section does (on the CPU its unrolled
oracle alone takes seconds at the full n).

Each time is the mean of ITERS eager calls after a warm-up call, in
microseconds, and says where it was taken: CUDA events on the card
(named), the host clock on the CPU, which says nothing of the card.
`main` returns the rows, which `benchmarks/run.py` writes under the
"kernels" section of BENCH_engine.json.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import flatten_state
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.device import resolve_device
from repro_torch.kernels.fedgia_update import ops as update_ops
from repro_torch.kernels.fedgia_update import ref as update_ref
from repro_torch.models import LeastSquares
from repro_torch.utils.pytree import ravel_spec

ITERS = 20
UPDATE_N = 200_000  # part 3: the update's columns a client


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


def bench_flat_update(device, n=200_000, m=16, k0=20, leaves=10):
    """Part 3 (module docstring): (name, us, what ran) rows of the fused
    flat update, its per-leaf twin and the unrolled oracle, on the same
    operands (numpy, seed 0)."""
    rng = np.random.default_rng(0)

    def arr(a):
        return torch.from_numpy(a.astype(np.float32)).to(device)

    xbar_c, g, pi = (arr(rng.standard_normal((m, n))) for _ in range(3))
    h = arr(rng.uniform(0.1, 2.0, (m, n)))
    sel = torch.from_numpy(rng.random(m) < 0.5).to(device)
    sigma = torch.tensor(0.4, dtype=torch.float32, device=device)
    pad = -n % update_ops.LANES
    padded = [torch.nn.functional.pad(t, (0, pad))
              for t in (xbar_c, g, pi, h)]
    cols = [torch.from_numpy(c).to(device)
            for c in np.array_split(np.arange(n), leaves)]
    per_leaf = [[t.index_select(1, c) for t in (xbar_c, g, pi, h)]
                for c in cols]
    pick = sel[:, None]

    def fused():
        return update_ops.fedgia_update_flat(*padded, sel, sigma, m, k0=k0)

    def leafwise():
        return [update_ref.fedgia_update_collapsed(
            x, gg, p, hh, pick, sigma, float(1.0 / m), k0=k0)
            for x, gg, p, hh in per_leaf]

    def unrolled():
        return update_ref.fedgia_update_ref(xbar_c, g, pi, h, pick, sigma,
                                            m, k0=k0)

    fused_by = ("the CUDA kernel (fedgia_update_batched)"
                if device.type == "cuda" else "its plain version (cpu)")
    return [
        (f"fedgia_update_flat_fused_m{m}_n{n}", _time_us(fused, device),
         fused_by),
        (f"fedgia_update_pytree_{leaves}leaf_m{m}_n{n}",
         _time_us(leafwise, device), "eager torch, leaf by leaf"),
        (f"fedgia_update_unrolled_ref_k0{k0}", _time_us(unrolled, device),
         "eager torch, k0 iterations"),
    ]


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.kernels_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--parts", default="1,2",
                    help="comma-separated parts to run (3: the update "
                         "alone, flat against per-leaf)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    parts = {int(p) for p in args.parts.split(",")}
    rows = []
    if 1 in parts:
        rows += bench_collapsed_vs_unrolled(device)
    if 2 in parts:
        rows += bench_fedgia_vs_fedavg(device)
    update = bench_flat_update(device, n=UPDATE_N) if 3 in parts else []
    clock = clock_name(device)
    print("name,us,clock")
    for name, us in rows:
        print(f"{name},{us:.1f},{clock}")
    for name, us, what in update:
        print(f"{name},{us:.1f},{clock} ({what})")
    out = {"unit": "us", "clock": clock,
           "micro": {name: us for name, us in rows}}
    for name, us, what in update:
        out["micro"][name] = us
        out.setdefault("ran", {})[name] = what
    return out


if __name__ == "__main__":
    main()
