"""Learning-rate schedules (counterpart of `repro/optim/schedules.py`).
`paper_lr` is the paper's gamma_k(a) (§V.D). Each takes the optimizer's
0-d int32 step count (a tensor, or an int) and returns the rate."""
from __future__ import annotations

import math

import torch


def _f32(count):
    return torch.as_tensor(count).to(torch.float32)


def paper_lr(a: float):
    """gamma_k(a) = a / log2(k+2)."""

    def fn(count):
        return a / torch.log2(_f32(count) + 2.0)

    return fn


def constant(a: float):
    return lambda count: a


def cosine(a: float, total: int, warmup: int = 0):
    def fn(count):
        c = _f32(count)
        warm = torch.clamp_max(c / max(warmup, 1), 1.0)
        prog = torch.clamp((c - warmup) / max(total - warmup, 1), 0.0, 1.0)
        return a * warm * 0.5 * (1.0 + torch.cos(math.pi * prog))

    return fn
