"""Minimal optimizer library: SGD(+momentum) and Adam on dicts of
tensors (counterpart of `repro/optim/optimizers.py`).

The API mirrors the reference's (and optax's): `init(params) -> state`;
`update(grads, state, params) -> (updates, state)`;
`apply_updates(params, updates)`. States are new dicts; nothing is
updated in place. `count` is a 0-d int32 tensor, which a schedule reads.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def _count0(params):
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr, momentum: float = 0.0):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        mu = ({k: torch.zeros_like(v) for k, v in params.items()}
              if momentum else None)
        return {"mu": mu, "count": _count0(params)}

    def update(grads, state, params=None):
        step_lr = lr_fn(state["count"])
        if momentum:
            mu = {k: momentum * m + grads[k].to(m.dtype)
                  for k, m in state["mu"].items()}
            upd = {k: -step_lr * m for k, m in mu.items()}
        else:
            mu, upd = None, {k: -step_lr * g for k, g in grads.items()}
        return upd, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        z = {k: torch.zeros(v.shape, dtype=torch.float32, device=v.device)
             for k, v in params.items()}
        return {"m": z, "v": {k: t.clone() for k, t in z.items()},
                "count": _count0(params)}

    def update(grads, state, params=None):
        c = state["count"] + 1
        g32 = {k: g.float() for k, g in grads.items()}
        m = {k: b1 * mm + (1 - b1) * g32[k] for k, mm in state["m"].items()}
        v = {k: b2 * vv + (1 - b2) * torch.square(g32[k])
             for k, vv in state["v"].items()}
        cf = c.float()
        mhat = {k: mm / (1 - b1 ** cf) for k, mm in m.items()}
        vhat = {k: vv / (1 - b2 ** cf) for k, vv in v.items()}
        step_lr = lr_fn(c)
        upd = {k: -step_lr * mhat[k] / (torch.sqrt(vhat[k]) + eps)
               for k in mhat}
        return upd, {"m": m, "v": v, "count": c}

    return Optimizer(init, update)


def apply_updates(params, updates):
    return {k: p + updates[k].to(p.dtype) for k, p in params.items()}
