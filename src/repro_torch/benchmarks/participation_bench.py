"""Partial-participation benchmark on the port (paper Fig. 3's mechanism,
in the engine): the selection fraction alpha swept with the engine's
uniform participation policy, for FedGiA_D and SCAFFOLD, to the paper's
stopping rule; CR, wall time, final objective and the participants a
round. Counterpart of the single-device part of
`benchmarks/participation_bench.py`, same rows and assert.

    PYTHONPATH=src python -m repro_torch.benchmarks.participation_bench \
        [--device cpu]

`run_sharded` is the reference's second part on 8 gloo ranks of the
host's CPU (its 8 fake CPU devices), whatever the device: the masked
round issues as many model-size all-reduces as the unmasked one (counted
from `torch.profiler`'s c10d events; the participant count rides eq.
(11)'s buffer), and FedGiA_D's sweep at alpha 0.25, 0.5 and 1.0 with the
client axis sharded matches the unsharded run at rtol 1e-5, atol 1e-6.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
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


def _sharded_rank(ranks):
    """The reference's sharded script on one gloo rank: m = 8 clients on
    a data mesh of `ranks`."""
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

    def model_size_all_reduces(masked):
        rf = make_round_fn(algo, mesh, masked=masked, flat_spec=spec)
        st, b = shard_inputs(algo, s0f, batch, mesh)
        args = (st, b) + ((torch.ones(m, dtype=torch.bool),) if masked
                          else ())
        return mesh_mod.profile_collectives(
            lambda: rf(*args), spec.padded_size)[1]["all_reduce_model"]

    plain, masked = model_size_all_reduces(False), model_size_all_reduces(True)
    assert masked == plain, (
        f"masked round changed the model-size all-reduce count: "
        f"{plain} -> {masked}")
    lines = ["alpha,selected,rounds,sharded_obj,single_dev_obj"]
    for alpha in (0.25, 0.5, 1.0):
        pol = UniformParticipation(m, alpha, seed=2)
        ref = run_rounds(algo, s0, batch, 20, chunk_size=10,
                         participation=pol)
        res = run_rounds(algo, s0, batch, 20, chunk_size=10,
                         participation=pol, mesh=mesh)
        for k in ref.history:
            np.testing.assert_allclose(res.history[k], ref.history[k],
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        lines.append(f"{alpha},{int(res.history['selected'][0])},"
                     f"{res.rounds_run},{float(res.history['f_xbar'][-1]):.6f},"
                     f"{float(ref.history['f_xbar'][-1]):.6f}")
    lines.append(f"PARTICIPATION_SHARDED_OK model_size_all_reduces={masked}")
    return "\n".join(lines)


def run_sharded(ranks: int = 8) -> str:
    """The sharded sweep and all-reduce count on `ranks` gloo ranks of the
    host's CPU; returns its report (raises where a check fails)."""
    return mesh_mod.launch(_sharded_rank, ranks, ranks)


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
