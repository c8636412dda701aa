"""Benchmark entry point of the port (counterpart of `benchmarks/run.py`):
one section a paper table or figure, the round engine and the kernels.

  table4         paper Table IV (algorithms x k0 x problems)
  fig1           paper Fig. 1 (k0 against rounds to converge)
  fig2           paper Fig. 2 (k0 against CR and time)
  fig3           paper Fig. 3 (the selection fraction alpha)
  engine         the round engine's paths (`engine_bench.run`: legacy,
                 scan, scan_pytree, async, active_1m, offload_1m, and
                 sharded and scan_overlap on 8 gloo CPU ranks)
  participation  the engine's alpha sweep under each policy, then its
                 sharded sweep on 8 gloo CPU ranks
  async          CR and f against max_staleness (stale-x̄ rounds), then
                 the sharded round's all-reduce count on 8 gloo CPU ranks
  wallclock      simulated time to target against straggler severity,
                 the codecs, the overlap and the faults (also writes
                 --wallclock-json)
  kernels        the round micro-benchmarks, parts 1-3 of kernels_bench
  roofline       the roofline table from the dry run's records
                 (results/dryrun/*.json, `repro_torch.launch.dryrun`)

    PYTHONPATH=src python -m repro_torch.benchmarks.run
    PYTHONPATH=src python -m repro_torch.benchmarks.run --only engine \
        --only kernels [--device cpu] [--json BENCH_engine.json]

The sections whose main returns data are written, machine-readable, to
`--json` under their names (a value JSON cannot hold is coerced to float,
else str, as the reference coerces it); `check_bench.py` gates the
engine section's rounds/s and the wallclock rows' simulated time against
the port's committed baselines. Every section runs on the card unless
`--device cpu` is given, but `roofline`, which reads the dry run's
records and runs nothing; `ABSENT` lists the reference's sections that
the port has not (none).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.benchmarks import (
    async_bench,
    engine_bench,
    fig1_convergence,
    fig2_k0,
    fig3_alpha,
    kernels_bench,
    participation_bench,
    roofline,
    table4,
    wallclock_bench,
)

ABSENT: dict = {}


def _engine(device, ctx):
    r = engine_bench.run(device, engine_bench.ROUNDS, engine_bench.REPEATS,
                         engine_bench.M_1M, engine_bench.ROUNDS_1M,
                         million=ctx.get("engine_rows"))
    engine_bench.print_paths(r)
    engine_bench.check(r)
    return r


def _with_sharded(bench, device):
    """A runner's rows (`main`), then its sharded part on 8 gloo CPU
    ranks (`run_sharded`), as the reference's `main` runs both."""
    rows = bench.main(["--device", device])
    print("\n-- sharded (8 gloo CPU ranks) --")
    print(bench.run_sharded())
    return rows


def _wallclock(device, ctx):
    rows = wallclock_bench.main(["--device", device])
    if ctx.get("wallclock_json"):
        wallclock_bench.write_json(rows, ctx["wallclock_json"])
    return rows


SECTIONS = {
    "table4": lambda d, ctx: table4.main(["--device", d]),
    "fig1": lambda d, ctx: fig1_convergence.main(["--device", d]),
    "fig2": lambda d, ctx: fig2_k0.main(["--device", d]),
    "fig3": lambda d, ctx: fig3_alpha.main(["--device", d]),
    "engine": _engine,
    "participation": lambda d, ctx: _with_sharded(participation_bench, d),
    "async": lambda d, ctx: _with_sharded(async_bench, d),
    "wallclock": _wallclock,
    "kernels": lambda d, ctx: kernels_bench.main(["--device", d, "--parts",
                                                  "1,2,3"]),
    "roofline": lambda d, ctx: roofline.main(
        ["--dir", ctx.get("dryrun_dir") or "results/dryrun"]),
}


def _coerce(o):
    return float(o) if hasattr(o, "__float__") else str(o)


def run(names, device="cuda", json_path="BENCH_engine.json",
        wallclock_json="BENCH_wallclock.json", engine_rows=None,
        dryrun_dir="results/dryrun") -> dict:
    """Run the sections `names` on `device` and write the ones that return
    data to `json_path` (none where it is empty). `engine_rows`: the
    `active_1m` and `offload_1m` rows, already run, for the engine
    section to reuse; `dryrun_dir`: the roofline section's records.
    Returns {section: its data}."""
    unknown = sorted(set(names) - set(SECTIONS))
    if unknown:
        raise SystemExit(f"unknown section(s) {unknown}; absent in the "
                         f"port: {ABSENT}")
    ctx = {"engine_rows": engine_rows, "wallclock_json": wallclock_json,
           "dryrun_dir": dryrun_dir}
    results = {}
    for name in names:
        print(f"\n===== {name} =====", flush=True)
        t0 = time.perf_counter()
        out = SECTIONS[name](device, ctx)
        if out is not None:
            results[name] = out
        print(f"----- {name} done in {time.perf_counter() - t0:.1f}s -----",
              flush=True)
    if results and json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2, sort_keys=True, default=_coerce)
        print(f"\nwrote {json_path} ({', '.join(sorted(results))})")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--only", choices=sorted(SECTIONS), default=None,
                    action="append",
                    help="run only the named section(s); repeatable "
                         "(e.g. --only engine --only kernels)")
    ap.add_argument("--json", default="BENCH_engine.json",
                    help="where the sections' data are written")
    ap.add_argument("--wallclock-json", default="BENCH_wallclock.json",
                    help="where the wallclock section writes its rows")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dryrun-dir", default="results/dryrun",
                    help="the roofline section's dry-run records")
    args = ap.parse_args(argv)
    names = args.only if args.only else list(SECTIONS)
    return run(names, args.device, args.json, args.wallclock_json,
               dryrun_dir=args.dryrun_dir)


if __name__ == "__main__":
    main()
