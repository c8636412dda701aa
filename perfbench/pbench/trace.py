"""Reading the device from `torch.profiler`: the split of one eager round
by step (profiler ranges put around the port's functions from outside),
whether a split is whole, and the busy intervals, idle gaps and top
operations of a traced replayed window."""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

UPDATE_KERNEL = "fedgia_update_kernel"
COPY_OPS = ("aten::copy_", "aten::cat", "aten::clone",
            "aten::constant_pad_nd")
# host work of the chunked driver, named in the traced window so that an
# idle gap of the device reads as what the host was doing
HOST_RANGES = ("host: draw and upload", "host: graph replay",
               "host: synchronize")


NAME_CHARS = 160  # a kernel's name as reported, cut to this


def _acts():
    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


@contextlib.contextmanager
def labelled(targets):
    """Within the block each `(obj, attr, label)` of `targets` runs inside
    a profiler range `label`; the originals are put back after."""
    undo = []
    try:
        for obj, name, label in targets:
            real = getattr(obj, name)

            def wrapped(*args, _real=real, _label=label, **kwargs):
                with torch.profiler.record_function(_label):
                    return _real(*args, **kwargs)

            setattr(obj, name, wrapped)
            undo.append((obj, name, real))
        yield
    finally:
        for obj, name, real in reversed(undo):
            setattr(obj, name, real)


def device_split(prof, labels):
    """Device microseconds of a profiled eager round by label: a kernel
    that a PyTorch op launched goes under the outermost of `labels`
    around the op, the autograd engine's ops under "gradient", other
    copies under "copies", the rest under "other"; the fused update,
    launched through ctypes under no op, by its kernel's name."""
    split = dict.fromkeys(tuple(labels) + ("copies", "other"), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            if UPDATE_KERNEL in e.name:
                split["update kernel"] = (split.get("update kernel", 0.0)
                                          + e.time_range.elapsed_us())
            continue
        kernels = [k for k in e.kernels if UPDATE_KERNEL not in k.name]
        if not kernels:
            continue
        label, p = None, e
        while p is not None:
            if p.name in labels:
                label = p.name
            elif label is None and p.name.startswith("autograd::engine"):
                label = "gradient"
            p = p.cpu_parent
        if label is None:
            label = "copies" if e.name in COPY_OPS or all(
                k.name.startswith(("Memcpy", "Memset"))
                for k in kernels) else "other"
        split[label] += sum(k.duration for k in kernels)
    return split


def split_is_whole(split, steps):
    """Whether every step of `steps` read device time above 0: a profiler
    session that lost a step's kernels reads 0 there, and such a split is
    not reported."""
    return all(split.get(k, 0.0) > 0 for k in steps)


def profile_round(fn, targets):
    """`fn()` (one eager round that ends in a synchronise) under the
    profiler, with the ranges of `targets` (see `labelled`). Returns the
    profile."""
    with labelled(targets), torch.profiler.profile(activities=_acts()) as p:
        fn()
        torch.cuda.synchronize()
    return p


def profile_window(fn, host_targets):
    """`fn()` (the traced window's driver call) under the profiler, with
    the driver's host work in ranges. Returns (fn's result, the
    profile)."""
    with labelled(host_targets), torch.profiler.profile(
            activities=_acts()) as p:
        out = fn()
        torch.cuda.synchronize()
    return out, p


def _union(intervals):
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def window_reading(prof):
    """The replayed window of a traced driver call: from the first
    `cudaGraphLaunch` to the end of the last device operation. Returns a
    dict with window_us, busy_us (the union of device operation
    intervals in it), the device operations by total time
    [[name, seconds]], the idle gaps by the host range they fell in
    [[name, seconds]], and each kernel's durations (name -> [us])."""
    events = prof.events()
    starts = [e.time_range.start for e in events
              if e.name == "cudaGraphLaunch"]
    if not starts:
        return None
    t0 = min(starts)
    # a profiler range is mirrored on the device as an annotation that
    # spans its kernels: not an operation
    dev = [(e.time_range.start, e.time_range.end, e.name[:NAME_CHARS])
           for e in events
           if e.device_type != torch.autograd.DeviceType.CPU
           and not getattr(e, "is_user_annotation", False)
           and e.name not in HOST_RANGES and e.time_range.end > t0]
    if not dev:
        return None
    t1 = max(e for _, e, _ in dev)
    spans = [(max(s, t0), e) for s, e, _ in dev]
    by_op, kernels = defaultdict(float), defaultdict(list)
    for s, e, name in dev:
        by_op[name] += (e - max(s, t0)) * 1e-6
        kernels[name].append(e - s)
    host = sorted((e.time_range.start, e.time_range.end, e.name)
                  for e in events if e.name in HOST_RANGES)
    gaps, end, i = defaultdict(float), t0, 0
    for s, e in sorted(spans):
        if s > end:
            # the driver's host ranges run one after another: skip those
            # that ended before the gap
            while i < len(host) and host[i][1] <= end:
                i += 1
            gaps[_host_at(host, i, end, s)] += (s - end) * 1e-6
        end = max(end, e)
    top = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                           key=lambda kv: -kv[1])[:10]
    return {"window_us": t1 - t0, "busy_us": _union(spans),
            "device_ops": top(by_op), "idle_gaps": top(gaps),
            "kernels": dict(kernels)}


def _host_at(host, i, s, e):
    """The host range from index `i` on that covers most of the gap
    [s, e]."""
    best, cover = "host: other", 0.0
    for j in range(i, len(host)):
        hs, he, name = host[j]
        if hs >= e:
            break
        c = min(he, e) - max(hs, s)
        if c > cover:
            best, cover = name, c
    return best
