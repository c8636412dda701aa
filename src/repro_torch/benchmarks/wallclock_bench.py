"""Wall-clock rounds: simulated time to the paper's stopping rule against
straggler severity (counterpart of `benchmarks/wallclock_bench.py`'s
`run`, `run_compression` and `run_faults`, same rows, and its asserts on
them).

    PYTHONPATH=src python -m repro_torch.benchmarks.wallclock_bench \
        [--device cpu] [--max-rounds 400]

Per (algorithm, spread, weighting) the sweep runs clock-driven async
rounds: constant per-client speeds geometrically spaced from 1 s to
`spread` s, staleness bounded at MAX_STALENESS, eq. (11) uniform or
"poly"-weighted. Each row reports the rounds to target (CR), the
simulated seconds to target (`sim_time` at the stopping round) and the
staleness used. spread = 1 is the homogeneous fleet: every client
arrives every round. The sweep is deterministic (simulated time, no
random draw), so CR and sim_time are the same on any device.

`run_compression`: with the wire priced in bytes (the byte-accurate
clock, uplink through the codec, fp32 downlink) on a link-bound fleet,
does compressing eq. (11)'s uplink buy time to a loss target, not only
fewer bits? FedGiA_D under each codec (none, bf16, int8 with error
feedback, top-k 0.25 with error feedback); rows `fedgia_d_bw`.

`run_faults`: the spread-4 straggler fleet under a crash+nan campaign,
screened, with a quorum floor, against the same clock without faults
(`fedgia_d_faulty` against `fedgia_d_faultref`): the simulated time the
campaign costs to the loss target.

`write_json` writes the rows in the layout of the reference's
BENCH_wallclock.json (`main --json PATH`, and `benchmarks/run.py`'s
wallclock section), which `benchmarks/check_bench.py --wallclock` gates
on simulated time to target. The reference's overlap rows
(`run_overlap`) wait for the port's multi-device client axis.
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock
from repro_torch.core.engine import run_rounds
from repro_torch.core.faults import Screening, make_faults
from repro_torch.core.prng import prng_key
from repro_torch.device import resolve_device

MAX_ROUNDS = 400
K0 = 10
MAX_STALENESS = 4
SPREADS = [1.0, 4.0, 16.0]
WEIGHTINGS = ["uniform", "poly"]
ALGOS = {
    "fedgia_d": dict(algorithm="fedgia", sigma_t=0.15, h_policy="diag_ema",
                     alpha=1.0),  # branch split = the arrival mask
    "scaffold": dict(algorithm="scaffold", lr=0.01),
    "fedavg": dict(algorithm="fedavg", lr=0.01),
}


# the compression rows: a wire-bound fleet. At n = 100 the raw fp32 round
# moves 408 B up and 408 B down a client, ~0.2 s at BANDWIDTH_BPS against
# 0.05 s of compute. The target is a loss level: the lossy codecs orbit a
# quantization floor above eq. (35)'s tol (int8 + EF at ~0.00515), while
# f(x̄) reaches the converged objective (~0.00492) within a few percent
COMPRESS_COMPUTE_S = 0.05
BANDWIDTH_BPS = 4000.0  # bytes/s per client link
COMPRESS_TARGET_F = 0.0052
CODECS = [
    ("none", dict(compression="none")),
    ("bf16", dict(compression="bf16")),
    ("int8", dict(compression="int8", error_feedback=True)),
    ("topk", dict(compression="topk", topk_frac=0.25, error_feedback=True)),
]

# the fault rows: per-kind rate of the crash+nan campaign, the screening
# clip, the quorum and the fleet's spread
FAULT_KINDS = ["crash", "nan"]
FAULT_RATE = 0.1
FAULT_CLIP = 100.0
FAULT_QUORUM = 2
FAULT_SPREAD = 4.0


def straggler_speeds(m: int, spread: float) -> np.ndarray:
    """Per-client compute seconds geometrically spaced in [1, spread]:
    the severity knob is the slow/fast ratio."""
    if spread <= 1.0:
        return np.ones(m, np.float32)
    return spread ** (np.arange(m, dtype=np.float32) / (m - 1))


def run(device="cuda", max_rounds: int = MAX_ROUNDS, collect_history=False):
    """One row per (algorithm, spread, weighting); `collect_history` adds
    each run's per-round (f, |grad|^2, staleness max, sim_time) as
    `history`."""
    device = resolve_device(device)
    rows = []
    model, batch, tol = make_problem("linreg", 0, device)
    for algo_key, hp in ALGOS.items():
        fed = FedConfig(num_clients=M_CLIENTS, k0=K0, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(device), prng_key(1),
                          init_batch=batch)
        for spread in SPREADS:
            clk = ComputeClock(M_CLIENTS, straggler_speeds(M_CLIENTS, spread))
            for weighting in WEIGHTINGS:
                res = run_rounds(algo, state, batch, max_rounds, tol=tol,
                                 clock=clk, max_staleness=MAX_STALENESS,
                                 stale_weighting=weighting)
                rows.append({
                    "algo": algo_key,
                    "spread": spread,
                    "weighting": weighting,
                    "cr": 2 * res.rounds_run,
                    "sim_time_s": float(res.history["sim_time"][-1]),
                    "staleness_seen": int(res.history["staleness_max"].max()),
                    "obj": float(res.history["f_xbar"][-1]),
                    "converged": res.stopped_early,
                    "time_s": res.wall_s,
                })
                if collect_history:
                    rows[-1]["history"] = list(zip(
                        res.history["f_xbar"].tolist(),
                        res.history["grad_sq_norm"].tolist(),
                        res.history["staleness_max"].tolist(),
                        res.history["sim_time"].tolist()))
    return rows


def _fedgia_d(device):
    model, batch, _ = make_problem("linreg", 0, device)
    fed = FedConfig(num_clients=M_CLIENTS, k0=K0, **ALGOS["fedgia_d"])
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(device), prng_key(1), init_batch=batch)
    return algo, state, batch


def _row(res, collect_history, **fields):
    row = dict(fields, cr=2 * res.rounds_run,
               sim_time_s=float(res.history["sim_time"][-1]),
               staleness_seen=int(res.history["staleness_max"].max()),
               obj=float(res.history["f_xbar"][-1]),
               converged=res.stopped_early, time_s=res.wall_s)
    if collect_history:
        row["history"] = list(zip(
            res.history["f_xbar"].tolist(),
            res.history["f_xbar"].tolist(),  # the stop metric of the rows
            res.history["staleness_max"].tolist(),
            res.history["sim_time"].tolist()))
    return row


def run_compression(device="cuda", max_rounds: int = MAX_ROUNDS,
                    collect_history=False):
    """Time to f(x̄) <= COMPRESS_TARGET_F a codec under the byte-accurate
    clock. `collect_history` adds each run's per-round (f, f, staleness
    max, sim_time) as `history` (f is the stop metric here)."""
    device = resolve_device(device)
    algo, state, batch = _fedgia_d(device)
    rows = []
    for codec, kw in CODECS:
        clk = ComputeClock(M_CLIENTS, compute_s=COMPRESS_COMPUTE_S,
                           bandwidth_bps=BANDWIDTH_BPS)
        res = run_rounds(algo, state, batch, max_rounds,
                         tol=COMPRESS_TARGET_F, tol_metric="f_xbar",
                         clock=clk, max_staleness=MAX_STALENESS,
                         stale_weighting="uniform", **kw)
        rows.append(_row(
            res, collect_history, algo="fedgia_d_bw", spread=1.0,
            weighting="uniform", codec=codec,
            bytes_up_total=float(np.sum(res.history["bytes_up"])),
            bytes_down_total=float(np.sum(res.history["bytes_down"]))))
    return rows


def run_faults(device="cuda", max_rounds: int = MAX_ROUNDS,
               collect_history=False):
    """Time to f(x̄) <= COMPRESS_TARGET_F in the spread-FAULT_SPREAD fleet
    under the crash+nan campaign with screening and a quorum, and the
    same clock without faults. The target is a loss level: the campaign
    injects fresh non-arrival every round, so the gradient rule's metric
    orbits an injection floor long after f has converged."""
    device = resolve_device(device)
    algo, state, batch = _fedgia_d(device)
    campaign = dict(faults=make_faults(FAULT_KINDS, [FAULT_RATE],
                                       num_clients=M_CLIENTS, seed=0),
                    screening=Screening(clip_norm=FAULT_CLIP),
                    quorum=FAULT_QUORUM)
    rows = []
    for algo_key, kw in (("fedgia_d_faultref", {}),
                         ("fedgia_d_faulty", campaign)):
        clk = ComputeClock(M_CLIENTS,
                           straggler_speeds(M_CLIENTS, FAULT_SPREAD))
        res = run_rounds(algo, state, batch, max_rounds,
                         tol=COMPRESS_TARGET_F, tol_metric="f_xbar",
                         clock=clk, max_staleness=MAX_STALENESS,
                         stale_weighting="uniform", **kw)
        row = _row(res, collect_history, algo=algo_key, spread=FAULT_SPREAD,
                   weighting="uniform", codec="none")
        if kw:
            row.update(faults=",".join(FAULT_KINDS), fault_rate=FAULT_RATE,
                       screened_min=int(res.history["screened"].min()),
                       degraded_rounds=int(res.history["degraded"].sum()))
        rows.append(row)
    return rows


def check(rows, max_rounds: int = MAX_ROUNDS):
    """The reference's asserts on these rows: bounded staleness, the
    homogeneous fleet carries only the one-round pipeline delay, and at
    the full round budget FedGiA under uniform weighting reaches the
    stopping rule at every spread."""
    for r in rows:
        assert r["staleness_seen"] <= MAX_STALENESS, r
    by_key = {(r["algo"], r["spread"], r["weighting"]): r for r in rows}
    for algo_key in ALGOS:
        u = by_key[(algo_key, 1.0, "uniform")]
        assert u["staleness_seen"] <= 1, u
    if max_rounds >= 400:
        for spread in SPREADS:
            r = by_key[("fedgia_d", spread, "uniform")]
            assert r["converged"], r


def check_uplink(rows, max_rounds: int = MAX_ROUNDS):
    """The reference's asserts on the compression and fault rows: at the
    full round budget a lossy codec reaches the target in less simulated
    time than the raw uplink, and the screened campaign converges with
    its quorum always met, later than the clean row."""
    by_key = {(r["algo"], r["codec"]): r for r in rows}
    for r in rows:
        assert r["staleness_seen"] <= MAX_STALENESS, r
    if max_rounds < 400:
        return
    raw = by_key[("fedgia_d_bw", "none")]
    assert raw["converged"], raw
    lossy = [by_key[("fedgia_d_bw", c)] for c, _ in CODECS if c != "none"]
    assert any(r["converged"] and r["sim_time_s"] < raw["sim_time_s"]
               for r in lossy), (raw, lossy)
    faulty = by_key[("fedgia_d_faulty", "none")]
    clean = by_key[("fedgia_d_faultref", "none")]
    assert faulty["converged"] and clean["converged"], (faulty, clean)
    assert faulty["screened_min"] >= FAULT_QUORUM, faulty
    assert faulty["degraded_rounds"] == 0, faulty
    assert faulty["sim_time_s"] > clean["sim_time_s"], (faulty, clean)


def write_json(rows, path, max_rounds: int = MAX_ROUNDS) -> dict:
    """Write `rows` (of `run`, `run_compression`, `run_faults`) to `path`
    as the reference's BENCH_wallclock.json: the sweep's settings and the
    rows, each without its per-round `history`. Returns what it wrote."""
    out = {"max_rounds": max_rounds, "clients": M_CLIENTS, "k0": K0,
           "max_staleness": MAX_STALENESS,
           "rows": [{k: v for k, v in r.items() if k != "history"}
                    for r in rows]}
    with open(path, "w") as f:
        json.dump(out, f, indent=2, sort_keys=True)
    print(f"wrote {path} ({len(rows)} rows)")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.wallclock_bench")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--max-rounds", type=int, default=MAX_ROUNDS)
    ap.add_argument("--json", default="",
                    help="also write the rows here (BENCH_wallclock.json's "
                         "layout)")
    args = ap.parse_args(argv)
    rows = run(args.device, args.max_rounds)
    uplink = (run_compression(args.device, args.max_rounds)
              + run_faults(args.device, args.max_rounds))
    print("algo,spread,weighting,codec,CR,sim_time_s,staleness_seen,obj,"
          "converged")
    for r in rows + uplink:
        print(f"{r['algo']},{r['spread']:g},{r['weighting']},"
              f"{r.get('codec', 'none')},{r['cr']},"
              f"{r['sim_time_s']:.2f},{r['staleness_seen']},"
              f"{r['obj']:.6f},{r['converged']}")
    check(rows, args.max_rounds)
    check_uplink(uplink, args.max_rounds)
    if args.json:
        write_json(rows + uplink, args.json, args.max_rounds)
    return rows + uplink


if __name__ == "__main__":
    main()
