"""Round primitives on the unsharded client axis (counterpart of the
single-device subset of `repro/core/api.py`).

Client-stacked tensors carry the client index on axis 0. The reference's
sharded reductions (psum over a mesh axis) have no counterpart here yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, dict]]


def client_mean(x: torch.Tensor) -> torch.Tensor:
    """Eq. (11): the mean over the leading client axis."""
    return torch.mean(x, dim=0)


def client_scalar_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of a per-client (m,) scalar array over all clients."""
    return torch.mean(x)


def client_scalar_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a per-client scalar array over all clients."""
    return torch.sum(x)


def client_scalar_max(x: torch.Tensor) -> torch.Tensor:
    """Max of a scalar over all client shards (no-op unsharded)."""
    return x


def broadcast_clients(tree, m: int):
    """m copies of a tensor (or dict of tensors) along a new leading
    client axis, as a stride-0 view: a caller that needs its own buffer
    materialises it with `.contiguous()`."""
    if isinstance(tree, dict):
        return {k: broadcast_clients(v, m) for k, v in tree.items()}
    return tree.unsqueeze(0).expand((m,) + tuple(tree.shape))


def masked_update(mask: torch.Tensor, new: torch.Tensor,
                  old: torch.Tensor) -> torch.Tensor:
    """Row-wise select over the client axis: mask True takes `new`."""
    return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)


def flat_grad_sq_norm(grads_flat: torch.Tensor, spec) -> torch.Tensor:
    """The `grad_sq_norm` diagnostic ||(1/m) Σ_i ∇f_i||² over the flat
    (m, N) gradient buffer: leaf by leaf over the unraveled mean, as the
    reference accumulates it."""
    leaves = spec.unravel(client_mean(grads_flat))
    total = torch.zeros((), dtype=torch.float32, device=grads_flat.device)
    for k in spec.keys:
        v = leaves[k].reshape(-1)
        total = total + torch.dot(v, v)
    return total


def per_client_value_and_grad(loss_fn: LossFn):
    """(params, stacked batch) -> (losses (m,), grads dict of (m, ...)):
    `torch.func.vmap` of `grad_and_value` over the client axis of the
    batch, params shared. `A @ x` inside the loss stays a torch matmul."""
    gv = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])
    vg = torch.func.vmap(gv, in_dims=(None, 0))

    def value_and_grad(params, batch):
        grads, losses = vg(params, batch)
        return losses, grads

    return value_and_grad
