"""Gate on benchmark regressions (counterpart of `tools/check_bench.py`,
against the port's own baselines).

Engine gate: compares a fresh BENCH_engine.json (`python -m
repro_torch.benchmarks.run --only engine --only kernels`) against the
committed port baseline `src/repro_torch/benchmarks/baselines/
engine.h100.json`, path by path (legacy, scan, scan_pytree, async,
active_1m, offload_1m), on rounds per second:

  * FAIL (exit 1) on a slowdown beyond --max-slowdown (2.5x): generous,
    to catch a host sync put back into the round loop, not jitter;
  * WARN beyond --warn-slowdown (1.5x);
  * FAIL on a path of the baseline that the fresh run lacks (a dropped
    benchmark is a regression too); paths only in the fresh run are
    reported as new;
  * a path whose row says ``"device": "cpu"`` (the `sharded` and
    `scan_overlap` rows, gloo ranks on the host) is neither gated nor
    written into the card's baseline.

Wall-clock gate (--wallclock): compares a fresh BENCH_wallclock.json
(`wallclock_bench.write_json`) against `baselines/wallclock.h100.json`,
row by row ((algo, spread, weighting, codec)), on simulated time to
target (`sim_time_s`), with the same thresholds. Simulated time is
deterministic, so a breach is an algorithmic change, not noise (except
the rows of a stochastic codec, whose levels flip on ulps: the
baseline's `_meta` names them); a row that converged in the baseline and
no longer converges fails, and a row that never converged is skipped.

The baselines are the port's own, from a run on an NVIDIA H100: never
the reference's (its FedGiA_D wallclock row no longer reproduces,
ROADMAP queue 3 e). Refresh them from a chip run with

    python -m repro_torch.benchmarks.run --only engine --only kernels \
        --json BENCH_engine.json
    python -m repro_torch.benchmarks.check_bench --update-baseline
    python -m repro_torch.benchmarks.check_bench --wallclock \
        --current BENCH_wallclock.json --update-baseline

`--update-baseline` keeps the baseline's hand-written top-level `_*` keys
(`_meta`: the command, the card and its power limit, the PR).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

BASELINES = Path(__file__).resolve().parent / "baselines"
BASELINE = BASELINES / "engine.h100.json"
WALLCLOCK_BASELINE = BASELINES / "wallclock.h100.json"


def load_engine_section(path: Path) -> dict:
    """Accept either the whole `run.py` dump ({"engine": {...}})
    or a bare engine-section dict."""
    with open(path) as f:
        data = json.load(f)
    section = data.get("engine", data)
    if "paths" not in section:
        raise SystemExit(f"{path}: no engine benchmark section found")
    return section


def _cpu_row(row) -> bool:
    """A row timed on the host's CPU (gloo ranks), not on the card."""
    return isinstance(row, dict) and row.get("device") == "cpu"


def check(current: dict, baseline: dict, max_slowdown: float,
          warn_slowdown: float) -> int:
    failures = warnings = 0
    cur_paths = current["paths"]
    base_paths = baseline["paths"]
    print(f"{'path':<12} {'baseline r/s':>14} {'current r/s':>14} "
          f"{'slowdown':>10}  verdict")
    for name, base in sorted(base_paths.items()):
        if name not in cur_paths:
            print(f"{name:<12} {base['rounds_per_s']:>14.2f} "
                  f"{'MISSING':>14} {'-':>10}  FAIL (path dropped)")
            failures += 1
            continue
        base_rps = float(base["rounds_per_s"])
        cur_rps = float(cur_paths[name]["rounds_per_s"])
        slowdown = base_rps / cur_rps if cur_rps > 0 else float("inf")
        if slowdown > max_slowdown:
            verdict = f"FAIL (> {max_slowdown:g}x)"
            failures += 1
        elif slowdown > warn_slowdown:
            verdict = f"WARN (> {warn_slowdown:g}x)"
            warnings += 1
        else:
            verdict = "ok"
        print(f"{name:<12} {base_rps:>14.2f} {cur_rps:>14.2f} "
              f"{slowdown:>9.2f}x  {verdict}")
    for name in sorted(set(cur_paths) - set(base_paths)):
        what = ("the host's CPU, not gated" if _cpu_row(cur_paths[name])
                else "new (not in baseline)")
        print(f"{name:<12} {'-':>14} "
              f"{float(cur_paths[name]['rounds_per_s']):>14.2f} "
              f"{'-':>10}  {what}")
    if failures:
        print(f"\n{failures} path(s) regressed beyond {max_slowdown:g}x — "
              f"if intentional, refresh the baseline "
              f"(check_bench --update-baseline)", file=sys.stderr)
        return 1
    if warnings:
        print(f"\n{warnings} path(s) slower than {warn_slowdown:g}x baseline "
              f"(within tolerance — watch the artifact trajectory)")
    else:
        print("\nall engine paths within tolerance")
    return 0


def load_wallclock_rows(path: Path) -> dict:
    """Index a BENCH_wallclock.json dump by (algo, spread, weighting,
    codec). Pre-compression dumps have no codec field — they key as
    "none", so old baselines stay comparable."""
    with open(path) as f:
        data = json.load(f)
    rows = data.get("rows")
    if rows is None:
        raise SystemExit(f"{path}: no wall-clock benchmark rows found")
    return {(r["algo"], float(r["spread"]), r["weighting"],
             r.get("codec", "none")): r for r in rows}


def check_wallclock(current: dict, baseline: dict, max_slowdown: float,
                    warn_slowdown: float) -> int:
    """Gate simulated time-to-target per (algo, spread, weighting) row."""
    failures = warnings = 0
    print(f"{'algo':<12} {'spread':>6} {'weighting':>9} {'codec':>5} "
          f"{'base t2t':>10} {'cur t2t':>10} {'slowdown':>10}  verdict")
    for key, base in sorted(baseline.items()):
        algo, spread, weighting, codec = key
        label = f"{algo:<12} {spread:>6g} {weighting:>9} {codec:>5}"
        cur = current.get(key)
        if cur is None:
            print(f"{label} {'-':>10} {'MISSING':>10} {'-':>10}  "
                  f"FAIL (row dropped)")
            failures += 1
            continue
        if not base["converged"]:
            print(f"{label} {'-':>10} {'-':>10} {'-':>10}  skip "
                  f"(baseline never reached target)")
            continue
        if not cur["converged"]:
            print(f"{label} {base['sim_time_s']:>10.2f} {'DNF':>10} "
                  f"{'-':>10}  FAIL (no longer converges)")
            failures += 1
            continue
        slowdown = cur["sim_time_s"] / base["sim_time_s"]
        if slowdown > max_slowdown:
            verdict = f"FAIL (> {max_slowdown:g}x)"
            failures += 1
        elif slowdown > warn_slowdown:
            verdict = f"WARN (> {warn_slowdown:g}x)"
            warnings += 1
        else:
            verdict = "ok"
        print(f"{label} {base['sim_time_s']:>10.2f} "
              f"{cur['sim_time_s']:>10.2f} {slowdown:>9.2f}x  {verdict}")
    for key in sorted(set(current) - set(baseline)):
        print(f"{key[0]:<12} {key[1]:>6g} {key[2]:>9} {key[3]:>5} "
              f"new (not in baseline)")
    if failures:
        print(f"\n{failures} wall-clock row(s) regressed — sim_time is "
              f"deterministic, so this is an algorithmic change; if "
              f"intentional, refresh the baseline "
              f"(check_bench --wallclock --update-baseline)",
              file=sys.stderr)
        return 1
    if warnings:
        print(f"\n{warnings} row(s) slower than {warn_slowdown:g}x baseline "
              f"(within tolerance)")
    else:
        print("\nall wall-clock rows within tolerance")
    return 0


def update_baseline(current: Path, baseline: Path) -> None:
    """Refresh the committed baseline from a fresh dump, KEEPING the
    baseline's curation keys. Benchmark dumps carry raw numbers only;
    the committed baselines additionally hold hand-written top-level
    `_*` keys (`_meta`: how to regenerate, what the numbers mean). A
    plain file copy silently drops those — every top-level key of the
    old baseline that starts with `_` and is absent from the fresh dump
    is carried over, `_meta` first so the file still reads top-down."""
    with open(current) as f:
        fresh = json.load(f)
    paths = fresh.get("engine", fresh).get("paths", {})
    for name in [k for k, v in paths.items() if _cpu_row(v)]:
        del paths[name]  # a CPU time is not a card number
    carried = []
    if baseline.exists():
        with open(baseline) as f:
            old = json.load(f)
        carried = [k for k in old if k.startswith("_") and k not in fresh]
        fresh = {**{k: old[k] for k in carried}, **fresh}
    with open(baseline, "w") as f:
        json.dump(fresh, f, indent=2, sort_keys=True)
        f.write("\n")
    kept = f" (kept {', '.join(carried)})" if carried else ""
    print(f"baseline refreshed from {current} -> {baseline}{kept}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.check_bench")
    ap.add_argument("--current", default="BENCH_engine.json",
                    help="freshly produced benchmark json")
    ap.add_argument("--baseline", default=str(BASELINE))
    ap.add_argument("--wallclock", action="store_true",
                    help="gate BENCH_wallclock.json time-to-target instead "
                         "of the engine round/s")
    ap.add_argument("--max-slowdown", type=float, default=2.5,
                    help="fail beyond this rounds/s slowdown factor")
    ap.add_argument("--warn-slowdown", type=float, default=1.5,
                    help="warn beyond this rounds/s slowdown factor")
    ap.add_argument("--update-baseline", action="store_true",
                    help="refresh --baseline from --current instead of "
                         "checking, preserving the baseline's hand-written "
                         "top-level _meta keys")
    args = ap.parse_args(argv)
    if args.wallclock:
        if args.current == "BENCH_engine.json":
            args.current = "BENCH_wallclock.json"
        if args.baseline == str(BASELINE):
            args.baseline = str(WALLCLOCK_BASELINE)
    if args.update_baseline:
        update_baseline(Path(args.current), Path(args.baseline))
        return 0
    if args.wallclock:
        return check_wallclock(load_wallclock_rows(Path(args.current)),
                               load_wallclock_rows(Path(args.baseline)),
                               args.max_slowdown, args.warn_slowdown)
    current = load_engine_section(Path(args.current))
    baseline = load_engine_section(Path(args.baseline))
    return check(current, baseline, args.max_slowdown, args.warn_slowdown)


if __name__ == "__main__":
    sys.exit(main())
