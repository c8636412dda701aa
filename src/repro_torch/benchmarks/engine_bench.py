"""Million-client rounds of the client stores and the async round
(counterpart of the `active_1m`, `offload_1m` and `async` rows of
`benchmarks/engine_bench.py`, at the reference's own sizes).

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench
  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench \
      --device cpu --clients 20000      # a small run on the CPU

`active_1m` is the active-set store where the dense store cannot go:
m = 10^6 clients, alpha = 10^-4 (100 participants a round), FedAvg at lr
0.01, `LeastSquares` with n = 32 (a flat row of N = 128) on one sample a
client, 3 rounds. A round's trajectories and gradients are (100, N)
tiles; what stays O(m) a round is the host's mask draw and the one
(m, N) eq. (11) reduction of the dense-layout aggregate.

`offload_1m` is the host-offloaded store at the same size on FedPD (lr
0.05, eta 1), whose duals are a resident (m, N) buffer: 512 MB in fp32.
`store="offload"` keeps it and the batch in host memory and moves
(100, N) tiles; with `aggregate="packed"` nothing O(m·N) is on the card,
and the row checks that the tile round's device peak stays below the
dense store's λ buffer that it moved off the card.

`async` is the stale-x̄ engine on the paper's linreg problem at the
runners' size (m = 64, n = 100): FedGiA_D (k0 5, alpha 0.5), 200 rounds
of the chunked driver under periodic arrivals (periods cycling 1..4) with
`max_staleness=2`, against the same rounds synchronous; each path's
median of 3 runs. The async round adds the per-client anchor selects and
takes its gradients at the per-client anchors. It is a library entry,
`run_async`, that the CLI does not run.

The batch of the million-client rows is built directly with numpy from
seed 0, as the reference builds it (its heterogeneous splitter is O(m²)
at this size). Each row runs one warm-up round first (kernel libraries,
the CUDA-graph capture of the chunked driver), then its timed rounds;
rounds/s is over those, on the host clock around work that ends in a
device synchronise.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    make_policy,
)
from repro_torch.device import resolve_device
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt

M_1M = 1_000_000
ALPHA_1M = 1e-4
ROUNDS_1M = 3
N_FEATURES = 32
ROUNDS_ASYNC = 200
REPEATS_ASYNC = 3


def million_client_problem(m: int, device):
    """(model, batch) of the reference's million-client rows: one sample
    of n = 32 features a client, b = A x* + 0.1 noise (numpy, seed 0)."""
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, 1, N_FEATURES)).astype(np.float32)
    x_star = rng.standard_normal(N_FEATURES).astype(np.float32)
    b = (A @ x_star + 0.1 * rng.standard_normal((m, 1))).astype(np.float32)
    batch = {"A": torch.from_numpy(A).to(device),
             "b": torch.from_numpy(b).to(device),
             "mask": torch.ones((m, 1), dtype=torch.float32, device=device)}
    return LeastSquares(N_FEATURES), batch


def _run(algo_name, hparams, store, aggregate, device, clients, rounds):
    model, batch = million_client_problem(clients, device)
    fed = FedConfig(algorithm=algo_name, num_clients=clients, k0=5,
                    **hparams)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1),
                      init_batch=batch)
    pol = make_policy("uniform", clients, ALPHA_1M, seed=0)
    kw = dict(participation=pol, store=store, aggregate=aggregate)
    run_rounds(algo, state, batch, 1, **kw)  # the warm-up round
    res = run_rounds(algo, state, batch, rounds, **kw)
    if res.rounds_run != rounds:
        raise RuntimeError(f"{algo_name}: {res.rounds_run} of {rounds} "
                           f"rounds ran")
    if not np.all(res.history["selected"] == pol.n_selected):
        raise RuntimeError(f"{algo_name}: selected "
                           f"{res.history['selected']}, want "
                           f"{pol.n_selected} a round")
    f = res.history["f_xbar"]
    if not np.isfinite(f).all():
        raise RuntimeError(f"{algo_name}: non-finite f {f}")
    row = {
        "wall_s": res.wall_s,
        "rounds_per_s": rounds / res.wall_s,
        "draw_s": res.draw_s,
        "clients": clients,
        "alpha": ALPHA_1M,
        "participants_per_round": pol.n_selected,
        "rounds": rounds,
        "f_xbar": f.tolist(),
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
    }
    return row, res, state


def run_active_1m(device="cuda", clients: int = M_1M,
                  rounds: int = ROUNDS_1M) -> dict:
    """Million-client active-store rounds: FedAvg, alpha = 1e-4."""
    device = resolve_device(device)
    row, _, _ = _run("fedavg", dict(lr=0.01), "active", "dense", device,
                     clients, rounds)
    row["note"] = "active-set store, FedAvg: (|C|, N) tile rounds at m=1e6"
    return row


def run_offload_1m(device="cuda", clients: int = M_1M,
                   rounds: int = ROUNDS_1M) -> dict:
    """Million-client host-offloaded rounds: FedPD, alpha = 1e-4,
    store="offload" + aggregate="packed", with the device peak of the
    tile round against the dense store's resident λ buffer."""
    device = resolve_device(device)
    row, res, state = _run("fedpd", dict(lr=0.05, fedpd_eta=1.0),
                           "offload", "packed", device, clients, rounds)
    spec = pt.ravel_spec(state["x"])
    dense_resident = clients * spec.padded_size * spec.dtype.itemsize
    peak = res.extras["device_peak_bytes"]
    # the fixed per-round bytes (mask, ids, metrics) amortise only at the
    # real size: no footprint check on a small run
    if peak is not None and clients >= 100_000 and peak >= dense_resident:
        raise RuntimeError(
            f"the offload tile round peaks at {peak} B on the card, not "
            f"below the {dense_resident} B dense-store λ buffer it moved "
            f"off")
    row.update(peak_device_bytes=peak,
               host_resident_bytes=res.extras["host_resident_bytes"],
               dense_resident_bytes=dense_resident,
               copy_s=res.extras["copy_s"],
               note="host-offloaded store + packed eq. (11), FedPD: "
                    "resident (m, N) duals in host memory, (|C|, N) tiles "
                    "on the card")
    return row


def run_async(device="cuda", rounds: int = ROUNDS_ASYNC,
              repeats: int = REPEATS_ASYNC) -> dict:
    """The async row: FedGiA_D's stale-x̄ rounds (periodic arrivals,
    max_staleness 2) against its synchronous rounds, median wall of
    `repeats` runs each, run in turns."""
    device = resolve_device(device)
    model, batch, _ = make_problem("linreg", 0, device)
    fed = FedConfig(algorithm="fedgia", num_clients=M_CLIENTS, k0=5,
                    alpha=0.5, sigma_t=0.15, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1),
                      init_batch=batch)
    pol = AvailabilityParticipation.from_periods(
        M_CLIENTS, 1 + (np.arange(M_CLIENTS) % 4), horizon=rounds)
    sync_walls, async_walls = [], []
    for _ in range(repeats):
        sync_walls.append(run_rounds(algo, state, batch, rounds).wall_s)
        res = run_rounds(algo, state, batch, rounds, participation=pol,
                         async_rounds=True, max_staleness=2)
        async_walls.append(res.wall_s)
    seen = int(res.history["staleness_max"].max())
    if seen > 2:
        raise RuntimeError(f"async: staleness {seen} above the bound 2")
    sync_s, async_s = (float(np.median(w)) for w in (sync_walls,
                                                    async_walls))
    return {"wall_s": async_s, "rounds_per_s": rounds / async_s,
            "max_staleness": 2, "staleness_seen": seen,
            "sync_wall_s": sync_s, "overhead_async_vs_scan": async_s / sync_s,
            "rounds": rounds, "clients": M_CLIENTS,
            "f_xbar": float(res.history["f_xbar"][-1]),
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu")}


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.engine_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--clients", type=int, default=M_1M)
    ap.add_argument("--rounds", type=int, default=ROUNDS_1M)
    args = ap.parse_args(argv)
    rows = {}
    for name, fn in (("active_1m", run_active_1m),
                     ("offload_1m", run_offload_1m)):
        rows[name] = fn(args.device, args.clients, args.rounds)
        print(json.dumps({name: rows[name]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
