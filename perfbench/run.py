"""Run one benchmark cell once and print its result as the last line.

  python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
      --trace <0|1>

Set-up (the inputs from the seed, the port's algorithm and state, the
first three rounds, which the reference follows, and the window's warm-up
and capture) runs from process start to the window; the window is one
call of the port's round driver, sized from the set-up's rate to last
about --seconds. --trace 1 reads the per-layer metrics in a run of its
own: one eager round split by step, then a traced window. After the
window the reference recomputes the first rounds and `correct` says
whether the program stayed within each limit. Needs a CUDA device; run
from the repository root."""
from __future__ import annotations

import os
import sys
import time


def _process_start() -> float:
    """The wall-clock time this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "perfbench"))
# every build and kernel cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def card_line() -> str:
    import torch
    name = torch.cuda.get_device_name(0)
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().splitlines()
        return f"{name}; nvidia-smi: {out[0] if out else 'no reply'}"
    except (OSError, subprocess.SubprocessError):
        return f"{name}; nvidia-smi: not available"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from pbench import harness

    cell, _, _ = harness.cell_files(args.workload, harness.manifest())
    if not torch.cuda.is_available():
        log("no CUDA device: this benchmark measures the card")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"cell {args.workload} needs {cell['chips']} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    log(f"card: {card_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    out = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), device, T_START, log)
    found = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
    if found:
        log(f"the run loaded {found}: the benchmark runs the PyTorch port "
            f"alone")
        return 3
    log(f"correct: {out['correct']}; the numbers compared and their "
        f"limits:")
    for name, c in out["checks"].items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
