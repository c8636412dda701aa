"""Async (stale-x̄) rounds: CR and objective against the staleness bound
(counterpart of part 1 of `benchmarks/async_bench.py`, same rows and
asserts).

    PYTHONPATH=src python -m repro_torch.benchmarks.async_bench [--device cpu]

Sweeps `max_staleness` under a deterministic heterogeneous arrival
process (client i communicates every p_i rounds, p cycling 1..4) and
reports, per algorithm, the communication rounds to the paper's stopping
rule, the final objective and the staleness actually used: how much CR a
bounded-staleness x̄ costs against the synchronous masked run
(max_staleness = 0, which is that run bit for bit).

`run_sharded` is the reference's part 2 on 8 gloo ranks of the host's
CPU (its 8 fake CPU devices): the sharded async round issues as many
model-size all-reduces as the synchronous masked one (counted from
`torch.profiler`'s c10d events): the stale anchors are per-client rows
beside z, so eq. (11) stays the round's one all-reduce.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core import api
from repro_torch.core.engine import (
    flatten_state,
    make_round_fn,
    run_rounds,
    shard_inputs,
)
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt
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


def _sharded_rank(ranks):
    """The reference's sharded script on one gloo rank: FedGiA_D with
    m = 8 clients on a data mesh of `ranks`, sync and async rounds'
    model-size all-reduces."""
    m, n, d = 8, 24, 320
    batch = to_torch(linreg_noniid(0, d, n, m), "cpu")
    model = LeastSquares(n)
    mesh = mesh_mod.make_host_mesh(data=ranks)
    fed = FedConfig(algorithm="fedgia", num_clients=m, k0=5, alpha=1.0,
                    sigma_t=0.3, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    s0 = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    spec = pt.ravel_spec(s0["x"])
    s0f = flatten_state(algo, s0, spec)

    def model_size_all_reduces(stale):
        rf = make_round_fn(algo, mesh, masked=True, stale=stale,
                           flat_spec=spec)
        st, b = shard_inputs(algo, s0f, batch, mesh)
        args = (st, b, torch.ones(m, dtype=torch.bool))
        if stale:
            args = args + (api.init_stale_xbar(s0f["x"], m // ranks, 2),)
        return mesh_mod.profile_collectives(
            lambda: rf(*args), spec.padded_size)[1]["all_reduce_model"]

    sync, asyn = model_size_all_reduces(False), model_size_all_reduces(True)
    assert asyn == sync, (
        f"async round changed the model-size all-reduce count: "
        f"{sync} -> {asyn}")
    return f"ASYNC_SHARDED_OK model_size_all_reduces={asyn}"


def run_sharded(ranks: int = 8) -> str:
    """The sharded async round's all-reduce count on `ranks` gloo ranks of
    the host's CPU; returns its report (raises where the check fails)."""
    return mesh_mod.launch(_sharded_rank, ranks, ranks)


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
