#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. Build: compile every CUDA source of the port with nvcc (in parallel)
   and print the card's name and power limit.
2. Main path, through `repro_torch.launch.train`, with the kernels'
   launch counts set to 0 just before each run and read just after:
   * the paper run at the CLI defaults (linreg, m=128, n=100, d=12800,
     k0=5, alpha=0.5, scalar H, tol 1e-7, up to 500 rounds) on the card,
     then again on the CPU with the plain versions: both must stop early
     at the same round (or one apart when the metric lies within fp noise
     of tol) with the same final f (rel 1e-5);
   * the population run (m=16384, n=1024, d=262144, diag_ema H, 20
     rounds): every (m, N) fp32 buffer is 64 MiB, above the 50 MB L2;
   * a one-client run (m=1, n=1024, sigma_t=6), which takes the
     single-client launch.
3. Kernels: each wrapper of the `fedgia_update` kernel against its
   plain version on the card (max abs error, expected bitwise), on the
   next round's inputs of the run that launched it, as `round_flat`
   builds them (batched: population run, (16384, 1024); donated: paper
   run, (128, 128), and also the population inputs; single: one-client
   run, (1, 1024)); then CUDA-event times (median of 25 launches after
   warm-up) of kernel and plain version beside the bound.
4. Print one `{"kernels": [...]}` line, the card line again, and last
   `{"ok": true, "device": {...}}`.

It imports nothing of JAX or of the JAX package `repro`. There is no
fallback: without a CUDA device, or without `src/repro_torch` beside this
file, it exits non-zero before printing any result.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
# kernel vs plain version: the same IEEE operations in the same order
# (the kernel is built with --fmad=false), so bitwise is expected; the
# check allows 2 float32 ulps
RTOL = 2.4e-7
REPS, WARMUP = 25, 3

PAPER = ["--rounds", "500"]
POPULATION = ["--clients", "16384", "--dim", "1024", "--samples", "262144",
              "--rounds", "20", "--tol", "0", "--h-policy", "diag_ema"]
# sigma_t = 6 is the theory's guaranteed regime (sigma >= 6 r / m, Lemma
# IV.1); at the default 0.15 a lone client diverges
ONE_CLIENT = ["--clients", "1", "--dim", "1024", "--samples", "4096",
              "--sigma-t", "6", "--rounds", "5", "--tol", "0"]

TPU_KERNELS = {
    "fedgia_update_batched":
        "src/repro/kernels/fedgia_update/kernel.py:133",
    "fedgia_update_batched_donated":
        "src/repro/kernels/fedgia_update/kernel.py:150",
    "fedgia_update_single":
        "src/repro/kernels/fedgia_update/kernel.py:166",
}
SOURCE = "src/repro_torch/kernels/fedgia_update/csrc/fedgia_update.cu"


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def done_line(tag, res):
    return (f"{tag}: done: {res['rounds']} rounds (CR={res['cr']}) in "
            f"{res['wall_s']:.2f}s  f={res['final_f']:.6f} "
            f"err={res['final_err']:.2e}")


def run_main_path(train, ops, argv):
    """One CLI run on the card, launch counts reset before, read after."""
    ops.reset_launches()
    res = train.main(argv)
    return res, dict(ops.launches)


def round_inputs(res, engine, selection, pt):
    """The kernel's arguments for the round after a run's last one, as
    `FedGiA.round_flat` builds them: (x̄_c, ḡ, π, h, sel, σ, m, k0)."""
    algo, batch, state = res["algorithm"], res["batch"], res["state"]
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = selection.copy_generator(state["rng"])
    xbar, sel, _, _, gbar = algo.round_inputs(flat, batch, spec)
    return algo.kernel_args(flat, xbar, gbar, sel)


def median_ms(fn, prep=None):
    """Median CUDA-event time of `fn` over REPS launches after WARMUP.
    A long sleep is queued first so that every launch is enqueued before
    the card reaches it: the events then time the device, not the host."""
    for _ in range(WARMUP):
        if prep:
            prep()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        if prep:
            prep()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(xbar):
    """Least time for the update on an H100 SXM: 4 reads and 3 writes of
    every element, plus sel and σ, over the HBM rate. The operations are
    no bound: about 20 fp32 operations per element (a^(k0-1) by
    square-and-multiply) against 28 bytes, below one per byte, where the
    card's fp32 rate over its HBM rate is about 20 per byte."""
    m, n = xbar.shape
    nbytes = 28 * m * n + 4 * m + 4
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def plain(ref, xbar, gbar, pi, h, sel, sigma, m, k0):
    return ref.fedgia_update_collapsed(
        xbar, gbar, pi, h,
        sel.reshape(sel.shape + (1,) * (xbar.dim() - sel.dim())), sigma,
        float(1.0 / m), k0=k0)


def hold_and_time(name, args, ops, ref):
    """Hold one wrapper against its plain version on `args`, the
    arguments `round_flat` passes (x̄_c, ḡ, π, h, sel, σ, m, k0), then
    time both. Returns the wrapper's entry of the kernels line."""
    xbar, gbar, pi, h, sel, sigma, m, k0 = args
    want = plain(ref, *args)
    prep = None
    if name == "fedgia_update_single":  # the (N,) form of the m = 1 launch
        ins = [t[0] for t in (xbar, gbar, pi, h, sel)]
        want = [w[0] for w in want]
    elif name == "fedgia_update_batched_donated":
        # writes x' into x̄_c, π' into π, z' into ḡ: run on copies, and
        # restore them before every timed launch
        ins = [t.clone() for t in (xbar, gbar, pi)] + [h, sel]

        def prep():
            for buf, src in zip(ins, (xbar, gbar, pi)):
                buf.copy_(src)
    else:
        ins = [xbar, gbar, pi, h, sel]
    wrapper = getattr(ops, name)

    def call():
        return wrapper(*ins, sigma, m, k0=k0)

    out = call()
    if prep and [t.data_ptr() for t in out] != \
            [ins[i].data_ptr() for i in (0, 2, 1)]:
        raise SystemExit(f"{name} did not write into its inputs")
    err = max(float((a - b).abs().max()) for a, b in zip(out, want))
    diff = sum(int((a != b).sum()) for a, b in zip(out, want))
    for a, b, part in zip(out, want, ("x", "pi", "z")):
        if not torch.isfinite(a).all():
            raise SystemExit(f"{name}: non-finite {part}'")
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0.0,
                                   msg=lambda msg: f"{name} {part}': {msg}")
    shape = list(xbar.shape)
    say(f"  {name} {shape}: max_abs_err={err!r} differing_elements={diff} "
        f"(tolerance rtol {RTOL}, bitwise expected)")
    ms = median_ms(call, prep)
    plain_ms = median_ms(lambda: plain(ref, *args))
    bound_ms, nbytes = bound(xbar)
    return {"name": name, "route": "cuda", "source": SOURCE,
            "replaces": TPU_KERNELS[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
            "shape": shape, "nbytes": nbytes}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found")
    sys.path.insert(0, str(SRC))
    from repro_torch.core import engine, selection
    from repro_torch.kernels import _build
    from repro_torch.kernels.fedgia_update import ops, ref
    from repro_torch.launch import train
    from repro_torch.utils import pytree as pt

    # 1. build -----------------------------------------------------------
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    say(card)
    for name, path in _build.build().items():
        say(f"built {name}: {path.relative_to(ROOT)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                say("  " + line.strip())

    # 2. main path -------------------------------------------------------
    launches = {k: 0 for k in ops.launches}
    paper, n = run_main_path(train, ops, PAPER)
    say(done_line("paper run (cuda)", paper))
    say(f"  launches: {n}")
    if not paper["stopped_early"]:
        raise SystemExit("paper run did not stop early")
    if n["fedgia_update_batched_donated"] != paper["rounds"] or \
            sum(n.values()) != paper["rounds"]:
        raise SystemExit(f"paper run: launches {n} != {paper['rounds']} rounds")
    for k in launches:
        launches[k] += n[k]

    pop, n = run_main_path(train, ops, POPULATION)
    say(done_line("population run (cuda)", pop))
    say(f"  launches: {n}")
    if n["fedgia_update_batched"] != 20 or sum(n.values()) != 20:
        raise SystemExit(f"population run: launches {n} != 20 rounds")
    if not all(math.isfinite(h["f"]) for h in pop["history"]):
        raise SystemExit("population run: non-finite f")
    for k in launches:
        launches[k] += n[k]

    one, n = run_main_path(train, ops, ONE_CLIENT)
    say(done_line("one-client run (cuda)", one))
    say(f"  launches: {n}")
    if n["fedgia_update_single"] != 5 or sum(n.values()) != 5:
        raise SystemExit(f"one-client run: launches {n} != 5 rounds")
    for k in launches:
        launches[k] += n[k]
    say(f"main-path launches: {launches}")

    cpu = train.main(PAPER + ["--device", "cpu"])
    say(done_line("paper run (cpu, plain versions)", cpu))
    r_gpu, r_cpu = paper["rounds"], cpu["rounds"]
    if r_gpu != r_cpu:
        short, long_ = (paper, cpu) if r_gpu < r_cpu else (cpu, paper)
        err_at = long_["history"][short["rounds"] - 1]["err"]
        tol = 1e-7
        if abs(r_gpu - r_cpu) > 1 or abs(err_at - tol) > 1e-2 * tol:
            raise SystemExit(f"paper run: {r_gpu} rounds on the card, "
                             f"{r_cpu} on the CPU")
    r = min(r_gpu, r_cpu) - 1
    f_gpu, f_cpu = paper["history"][r]["f"], cpu["history"][r]["f"]
    if abs(f_gpu - f_cpu) > 1e-5 * abs(f_cpu):
        raise SystemExit(f"paper run: f {f_gpu!r} (cuda) vs {f_cpu!r} (cpu)")
    say(f"paper run parity: rounds {r_gpu} (cuda) vs {r_cpu} (cpu), "
        f"f {f_gpu!r} vs {f_cpu!r}")

    # 3. kernels against their plain versions, then times ----------------
    # each wrapper on the round inputs of the run that launched it, so at
    # its main-path shape; the donated wrapper also at the population
    # shape, which no driven run gives it (diag_ema does not donate)
    paper_in, pop_in, one_in = (round_inputs(res, engine, selection, pt)
                                for res in (paper, pop, one))
    cases = [("fedgia_update_batched", pop_in, True),
             ("fedgia_update_batched_donated", paper_in, True),
             ("fedgia_update_batched_donated", pop_in, False),
             ("fedgia_update_single", one_in, True)]
    for res in (paper, pop, one, cpu):
        del res["batch"], res["state"]

    ops.reset_launches()
    say(f"kernel vs plain version on one round's inputs, then times on "
        f"{card} (median of {REPS} launches, CUDA events):")
    kernels = []
    for name, args, on_path in cases:
        k = hold_and_time(name, args, ops, ref)
        where = "main path" if on_path else "not a main-path shape"
        say(f"  {name} {k['shape']} ({where}): kernel_us={k['ms'] * 1e3:.2f} "
            f"plain_us={k['plain_ms'] * 1e3:.2f} "
            f"bound_us={k['bound_ms'] * 1e3:.2f} (bytes) "
            f"achieved={k.pop('nbytes') / (k['ms'] * 1e-3) / 1e9:.1f} GB/s "
            f"library_us=none (no single PyTorch call computes this fused "
            f"update)")
        if on_path:
            k["launches"] = launches[name]
            if k["launches"] < 1:
                raise SystemExit(f"{name} was not launched on the main path")
            kernels.append(k)

    # 4. result ------------------------------------------------------------
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
