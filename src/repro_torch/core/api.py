"""Round primitives on the unsharded client axis (counterpart of the
single-device subset of `repro/core/api.py`).

Client-stacked tensors carry the client index on axis 0. The reference's
sharded reductions (psum over a mesh axis) have no counterpart here yet.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, dict]]


def client_mean(x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Eq. (11): the mean over the leading client axis. With `mask` ((m,)
    bool, at least one True) the mean over the masked-in clients only:
    their sum over their count."""
    if mask is None:
        return torch.mean(x, dim=0)
    keep = mask.reshape((-1,) + (1,) * (x.dim() - 1))
    num = torch.sum(torch.where(keep, x, 0.0), dim=0)
    return num / torch.sum(mask.to(torch.float32)).to(num.dtype)


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


def flat_round_aggregate(contrib: torch.Tensor, grads: torch.Tensor,
                         losses: torch.Tensor, sel_vec: torch.Tensor, spec,
                         mask: Optional[torch.Tensor] = None,
                         extra_mean: Optional[torch.Tensor] = None):
    """Eq. (11) and the round's diagnostics over the flat client buffers
    (the baselines' rounds; unsharded, so no collective): the (masked)
    mean of the (m, N) `contrib`, `flat_grad_sq_norm` of the (m, N) raw
    gradients, the mean of the (m,) losses and the sum of the (m,)
    participation indicator `sel_vec`. `extra_mean` is one more (m, N)
    buffer whose plain all-client column mean is returned too
    (SCAFFOLD's control-variate delta). Returns
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``."""
    out = (client_mean(contrib, mask=mask), flat_grad_sq_norm(grads, spec),
           torch.mean(losses), torch.sum(sel_vec))
    if extra_mean is not None:
        out = out + (torch.mean(extra_mean, dim=0),)
    return out


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


def per_client_value_and_grad_stacked(loss_fn: LossFn):
    """(stacked params, stacked batch) -> (losses (m,), grads dict of
    (m, ...)): as `per_client_value_and_grad`, but every client has its
    own params (`in_dims=(0, 0)`), so `A @ x` becomes a batched product.
    On a broadcast anchor it agrees with the shared form to float32
    rounding (tests/test_torch_baselines.py), not bit for bit."""
    gv = torch.func.grad_and_value(lambda p, b: loss_fn(p, b)[0])
    vg = torch.func.vmap(gv, in_dims=(0, 0))

    def value_and_grad(params, batch):
        grads, losses = vg(params, batch)
        return losses, grads

    return value_and_grad


def make_algorithm(fed, loss_fn: LossFn, model=None):
    """The algorithm object that `fed.algorithm` names."""
    from repro_torch.core.baselines.fedavg import FedAvg
    from repro_torch.core.baselines.fedpd import FedPD
    from repro_torch.core.baselines.fedprox import FedProx
    from repro_torch.core.baselines.scaffold import Scaffold
    from repro_torch.core.fedgia import FedGiA

    algos = {
        "fedgia": FedGiA,
        "fedavg": FedAvg,
        "fedprox": FedProx,
        "fedpd": FedPD,
        "scaffold": Scaffold,
    }
    if fed.algorithm not in algos:
        raise KeyError(f"unknown algorithm {fed.algorithm!r}: {sorted(algos)}")
    return algos[fed.algorithm](fed, loss_fn, model=model)
