"""Readings that set a cell's limits, on the card at the cell's own size:
the program's sound first rounds against the reference on many seeds
(the lower reading of each number), and on a few seeds the control (the
reference in the next lower precision put in the program's place) and
the planted fault "half the batch left out" (the upper readings). The
benchmark's own runs do not run this.

  python3 perfbench/control.py --workload <cell> --seeds 1 2 ... \
      [--control-seeds 1 2 3] [--out control.jsonl]

Prints one JSON line a reading: {"cell", "seed", "kind", numbers}."""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "perfbench"))


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from pbench import compare, harness
    from pbench.systems.fedgia import release

    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    device = torch.device("cuda", 0)
    _, cfg, wl = harness.cell_files(args.workload, harness.manifest())
    system = harness.system_for(cfg)
    with open(args.out or os.devnull, "a") as sink:
        def emit(seed, kind, numbers):
            line = json.dumps({"cell": args.workload, "seed": seed,
                               "kind": kind, **numbers})
            print(line, flush=True)
            sink.write(line + "\n")
            sink.flush()

        for seed in args.seeds:
            t0 = time.time()
            sut = system(cfg, wl, seed, device)
            prog, state, res = sut.first_steps(log)
            del state, res
            sut.free()
            release(device)
            ref = sut.reference("ref")
            emit(seed, "program", compare.gaps(prog, ref))
            log(f"seed {seed}: {time.time() - t0!r} s")
            del sut
            release(device)
        for seed in args.control_seeds:
            # the inputs and masks only: nothing of the program runs
            sut = system.for_reference(cfg, wl, seed, device)
            ref = sut.reference("ref")
            emit(seed, "control", compare.gaps(sut.reference("control"),
                                               ref))
            emit(seed, "half_batch", compare.gaps(
                sut.reference("ref", half=True), ref))
            del sut
            release(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
