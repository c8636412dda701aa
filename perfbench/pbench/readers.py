"""The arithmetic behind the metric files under `metrics/`: each takes
the run's context (`harness.run_cell`) and returns a number, or None
where the run gave it nothing to read (no trace, a split that lost a
step, no launch of the kernel)."""
from __future__ import annotations

import statistics

from pbench import trace, yardstick

GIB = 2 ** 30


def per_round_s(ctx) -> float:
    """Host-clock seconds a round of the window (draws included)."""
    return ctx.window["wall_s"] / ctx.window["rounds"]


def split_us(ctx, step: str):
    if ctx.split is None or ctx.split.get(step, 0.0) <= 0:
        return None
    return ctx.split[step]


def update_roofline(ctx):
    """% of its byte bound that the fused update reached: the bytes its
    launch must move at 3.35 TB/s over the mean duration of
    `fedgia_update_kernel` in the traced window."""
    if ctx.trace is None:
        return None
    durs = [d for name, ds in ctx.trace["kernels"].items()
            if trace.UPDATE_KERNEL in name for d in ds]
    if not durs:
        return None
    bound_s = ctx.sut.update_bytes() / yardstick.PEAK_HBM_BYTES
    return 100.0 * bound_s / (statistics.fmean(durs) * 1e-6)


def idle_share(ctx):
    """% of the traced replayed window in which no device operation ran."""
    if ctx.trace is None or ctx.trace["window_us"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_us"] / ctx.trace["window_us"])


def mfu(ctx, peak_flops: float):
    """% of the card's peak: the least time a round needs at the
    published peaks (the larger of FLOPs at `peak_flops` and bytes at
    3.35 TB/s) over the traced window's time a round."""
    if ctx.trace is None:
        return None
    flops, nbytes = ctx.sut.round_cost()
    least, _ = yardstick.least_time_s(flops, nbytes, peak_flops)
    return 100.0 * least / per_round_s(ctx)
