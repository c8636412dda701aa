"""The round engine's paths on the paper's linreg problem, and the
million-client rows of the client stores (counterpart of
`benchmarks/engine_bench.py`, at the reference's own sizes).

  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench --all
  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench
  PYTHONPATH=src python -m repro_torch.benchmarks.engine_bench \
      --device cpu --clients 20000      # the million rows, small, CPU

`run()` (`--all`, and `benchmarks/run.py`'s engine section) times
FedGiA_D (k0 5, alpha 0.5, sigma_t 0.15, diag_ema H) at the runners'
size (m = 64, `make_problem("linreg", 0)`), `rounds` rounds (200) with
no stop, each path the median of `repeats` (3) runs:

  * `legacy`: the eager per-round loop (`scan=False`, `--no-scan`);
  * `scan`: the chunked driver on the flat buffers (one CUDA-graph replay
    of the whole run on the card);
  * `scan_pytree`: the same driver on the per-leaf rounds (`flat=False`,
    `--no-flat`), its runs interleaved with `scan`'s so that drift hits
    both. `speedup_flat_vs_pytree` is the ratio of the two paths' median
    round time, each run's wall less its host mask draws (`draw_s`): the
    draws are the same work on both layouts (one key chain), and on the
    card they are most of the wall and vary from run to run by more
    than the rounds differ. The reference's ratio of the whole walls is
    `speedup_flat_vs_pytree_wall`, reported and not asserted;
  * `async`: the stale-x̄ rounds under periodic arrivals (periods 1..4,
    `max_staleness=2`; `run_async`, which also times the synchronous
    rounds it is held against);
  * `active_1m`, `offload_1m`: the million-client rows below;
  * `sharded`, `scan_overlap` (in a CPU run of the section only): the
    chunked driver on a client axis split over 8 gloo ranks of the
    host's CPU (`run_sharded`, the reference's 8 fake CPU devices),
    barrier and overlapped rounds, labelled `device: cpu`. A card run of
    the section times the card and leaves them out (a CPU time is not a
    card number); `check_bench` keeps such rows out of the card's
    baseline and its gate wherever they come from.

It checks the reference's claims: the chunked and legacy histories agree
at rtol 1e-5 (atol 1e-6); flat and per-leaf histories are bitwise equal
(on the CPU; on the card the row says whether they were, and they are
held at rtol 1e-5 otherwise); the staleness used stays within 2. `--all`
then asserts `speedup_scan_vs_legacy > 1.0` and
`speedup_flat_vs_pytree >= 0.98`, as the reference's `main` does.

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

`async` alone is also the library entry `run_async`: FedGiA_D's stale-x̄
rounds against the same rounds synchronous, each path's median of 3
runs. The async round adds the per-client anchor selects and takes its
gradients at the per-client anchors.

The batch of the million-client rows is built directly with numpy from
seed 0, as the reference builds it (its heterogeneous splitter is O(m²)
at this size). Each million row runs one warm-up round first (kernel
libraries, the CUDA-graph capture of the chunked driver), then its timed
rounds. Every time is on the host clock around work that ends in a
device synchronise; the chunked driver's warm-up and capture stay out of
`wall_s`, as the reference compiles before its timed window.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from repro_torch.launch import mesh as mesh_mod

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
ROUNDS = 200  # run(): the FedGiA_D paths' rounds and repeats
REPEATS = 3
SHARDED_RANKS = 8  # the reference's 8 fake CPU devices


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


def _fedgia_d(device):
    """FedGiA_D at the runners' size: (algorithm, state, batch)."""
    model, batch, _ = make_problem("linreg", 0, device)
    fed = FedConfig(algorithm="fedgia", num_clients=M_CLIENTS, k0=5,
                    alpha=0.5, sigma_t=0.15, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1), init_batch=batch)
    return algo, state, batch


def run_async(device="cuda", rounds: int = ROUNDS_ASYNC,
              repeats: int = REPEATS_ASYNC) -> dict:
    """The async row: FedGiA_D's stale-x̄ rounds (periodic arrivals,
    max_staleness 2) against its synchronous rounds, median wall of
    `repeats` runs each, run in turns."""
    device = resolve_device(device)
    algo, state, batch = _fedgia_d(device)
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


def run(device="cuda", rounds: int = ROUNDS, repeats: int = REPEATS,
        clients_1m: int = M_1M, rounds_1m: int = ROUNDS_1M,
        million=None) -> dict:
    """The engine section: every path's row (module docstring) and the
    speedups, as a dict with the reference's keys. `million` (a dict
    with the `active_1m` and `offload_1m` rows) reuses rows already run
    instead of running them again."""
    device = resolve_device(device)
    algo, state, batch = _fedgia_d(device)

    def timed(**kw):
        return run_rounds(algo, state, batch, rounds, **kw)

    loops = [timed(scan=False) for _ in range(repeats)]
    flat_runs, tree_runs = [], []
    for _ in range(repeats):  # interleaved: drift hits both paths
        flat_runs.append(timed())
        tree_runs.append(timed(flat=False))
    loop_s, scan_s, pytree_s = (float(np.median([r.wall_s for r in runs]))
                                for runs in (loops, flat_runs, tree_runs))
    # the rounds' own time: the host's mask draws before each chunk are
    # the same work on both layouts (one key chain), and their time
    # varies run to run by more than the rounds differ
    scan_rounds_s, pytree_rounds_s = (
        float(np.median([r.wall_s - r.draw_s for r in runs]))
        for runs in (flat_runs, tree_runs))
    res_loop, res_scan, res_tree = loops[-1], flat_runs[-1], tree_runs[-1]
    bitwise = True
    for k in ("f_xbar", "grad_sq_norm"):
        np.testing.assert_allclose(res_scan.history[k], res_loop.history[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
        same = np.array_equal(res_scan.history[k], res_tree.history[k])
        bitwise = bitwise and same
        if device.type == "cpu" and not same:
            raise AssertionError(f"flat and per-leaf {k} histories differ")
        np.testing.assert_allclose(res_tree.history[k], res_scan.history[k],
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    asyn = run_async(device, rounds, repeats)
    sharded = _sharded_rows(rounds) if device.type == "cpu" else {}
    if asyn["staleness_seen"] > 2:
        raise AssertionError(f"async staleness {asyn['staleness_seen']}")
    if million is None:
        million = {"active_1m": run_active_1m(device, clients_1m, rounds_1m),
                   "offload_1m": run_offload_1m(device, clients_1m,
                                                rounds_1m)}
    note = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    return {
        "rounds": rounds,
        "clients": M_CLIENTS,
        "repeats": repeats,
        "device": note,
        "paths": {
            "legacy": {"wall_s": loop_s, "rounds_per_s": rounds / loop_s,
                       "note": "eager per-round loop (--no-scan)"},
            "scan": {"wall_s": scan_s, "rounds_per_s": rounds / scan_s,
                     "draw_s": float(np.median([r.draw_s
                                                for r in flat_runs])),
                     "walls": [r.wall_s for r in flat_runs],
                     "draws": [r.draw_s for r in flat_runs],
                     "note": "flat-buffer rounds (the default path)"},
            "scan_pytree": {"wall_s": pytree_s,
                            "rounds_per_s": rounds / pytree_s,
                            "draw_s": float(np.median([r.draw_s
                                                       for r in tree_runs])),
                            "walls": [r.wall_s for r in tree_runs],
                            "draws": [r.draw_s for r in tree_runs],
                            "note": "per-leaf pytree rounds (--no-flat)"},
            "async": asyn,
            "active_1m": million["active_1m"],
            "offload_1m": million["offload_1m"],
            **({"sharded": sharded["off"], "scan_overlap": sharded["scatter"]}
               if sharded else {}),
        },
        "flat_vs_pytree_bitwise": bitwise,
        "speedup_scan_vs_legacy": loop_s / scan_s,
        # on the rounds' own time (wall less the host's mask draws)
        "speedup_flat_vs_pytree": pytree_rounds_s / scan_rounds_s,
        # the reference's ratio, of the whole walls
        "speedup_flat_vs_pytree_wall": pytree_s / scan_s,
        "overhead_async_vs_scan": asyn["wall_s"] / scan_s,
    }


def _sharded_rank(rounds, overlaps):
    """One gloo rank of the sharded rows: FedGiA_D at the runners' size
    on a data mesh over every rank, one run a value of `overlaps`."""
    model, batch, _ = make_problem("linreg", 0, "cpu")
    fed = FedConfig(algorithm="fedgia", num_clients=M_CLIENTS, k0=5,
                    alpha=0.5, sigma_t=0.15, h_policy="diag_ema")
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    import torch.distributed as dist
    mesh = mesh_mod.make_host_mesh(data=dist.get_world_size())
    return {ov: run_rounds(algo, state, batch, rounds, mesh=mesh,
                           overlap=ov).wall_s for ov in overlaps}


def _sharded_rows(rounds=ROUNDS, ranks=SHARDED_RANKS,
                  overlaps=("off", "scatter")) -> dict:
    """The sharded rows of `overlaps`, from one launch of `ranks` gloo
    ranks: {overlap: row}."""
    walls = mesh_mod.launch(_sharded_rank, ranks, rounds, overlaps)
    note = {"off": f"{ranks} gloo CPU ranks on one host (eq. (11) one "
                   f"all-reduce a round)",
            "scatter": f"{ranks} gloo CPU ranks, overlap='scatter' (a "
                       f"reduce-scatter at the round's end, the consensus "
                       f"all-gathered at the next round's top)"}
    return {ov: {"wall_s": w, "rounds_per_s": rounds / w, "device": "cpu",
                 "ranks": ranks, "note": note[ov]}
            for ov, w in walls.items()}


def run_sharded(overlap: str = "off", rounds: int = ROUNDS,
                ranks: int = SHARDED_RANKS) -> dict:
    """The `sharded` (overlap "off") or `scan_overlap` ("scatter") row:
    FedGiA_D at the runners' size, `rounds` rounds in the chunked driver,
    its client axis over `ranks` gloo ranks on the host's CPU (the
    reference's 8 fake CPU devices). A CPU time, labelled so."""
    return _sharded_rows(rounds, ranks, (overlap,))[overlap]


def check(r: dict) -> None:
    """The reference's `main` asserts: the chunked driver beats the eager
    loop, and the flat rounds do not lose to the per-leaf ones (2 %
    grace for noise between the interleaved medians)."""
    assert r["speedup_scan_vs_legacy"] > 1.0, (
        f"chunked driver slower than the per-round loop: {r}")
    assert r["speedup_flat_vs_pytree"] >= 0.98, (
        f"flat rounds slower than per-leaf rounds: {r}")


def print_paths(r: dict) -> None:
    print("path,wall_s,rounds_per_s")
    for name, p in r["paths"].items():
        print(f"{name},{p['wall_s']!r},{p['rounds_per_s']!r}")
    print(f"speedup scan vs legacy: {r['speedup_scan_vs_legacy']!r}x, "
          f"flat vs pytree: {r['speedup_flat_vs_pytree']!r}x on the "
          f"rounds' time ({r['speedup_flat_vs_pytree_wall']!r}x on the "
          f"walls, host mask draws included) "
          f"(histories bitwise: {r['flat_vs_pytree_bitwise']}), async "
          f"overhead vs scan: {r['overhead_async_vs_scan']!r}x, on "
          f"{r['device']}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.engine_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--clients", type=int, default=M_1M,
                    help="clients of the million-client rows")
    ap.add_argument("--rounds", type=int, default=ROUNDS_1M,
                    help="rounds of the million-client rows")
    ap.add_argument("--all", action="store_true",
                    help="run every path (`run`), print the table and "
                         "assert the speedups; returns the section's dict")
    ap.add_argument("--path-rounds", type=int, default=ROUNDS,
                    help="--all: rounds of the FedGiA_D paths")
    ap.add_argument("--repeats", type=int, default=REPEATS,
                    help="--all: runs a path, whose median is kept")
    args = ap.parse_args(argv)
    if args.all:
        r = run(args.device, args.path_rounds, args.repeats, args.clients,
                args.rounds)
        print_paths(r)
        check(r)
        return r
    rows = {}
    for name, fn in (("active_1m", run_active_1m),
                     ("offload_1m", run_offload_1m)):
        rows[name] = fn(args.device, args.clients, args.rounds)
        print(json.dumps({name: rows[name]}), flush=True)
    return rows


if __name__ == "__main__":
    main()
