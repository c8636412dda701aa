"""Round primitives on the unsharded client axis (counterpart of the
single-device subset of `repro/core/api.py`).

Client-stacked tensors carry the client index on axis 0. The reference's
sharded reductions (psum over a mesh axis) have no counterpart here yet.
The `_active` twins reduce a round's packed participant tile
(`store="active"` / `"offload"`, `utils.pytree.ActiveSet`).
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


def _flat_sq_norm(vec: torch.Tensor, spec) -> torch.Tensor:
    """||v||² of a flat (N,) vector, leaf by leaf over its unraveled
    dict, as the reference accumulates it."""
    leaves = spec.unravel(vec)
    total = torch.zeros((), dtype=torch.float32, device=vec.device)
    for k in spec.keys:
        v = leaves[k].reshape(-1)
        total = total + torch.dot(v, v)
    return total


def flat_grad_sq_norm(grads_flat: torch.Tensor, spec) -> torch.Tensor:
    """The `grad_sq_norm` diagnostic ||(1/m) Σ_i ∇f_i||² over the flat
    (m, N) gradient buffer."""
    return _flat_sq_norm(client_mean(grads_flat), spec)


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


def flat_grad_sq_norm_active(grads_tile: torch.Tensor, active,
                             spec) -> torch.Tensor:
    """The participant-gradient diagnostic ||(1/|C|) Σ_{i∈C} ∇f_i||² over
    the packed (capacity, N) gradient tile (`utils.pytree.ActiveSet`).
    This is the active store's `grad_sq_norm`: the server never contacted
    the frozen clients this round, so the eq. (35) stop gates on the
    participants' mean gradient. Padding rows are zeroed."""
    g = active.zero_invalid(grads_tile)
    return _flat_sq_norm(torch.sum(g, dim=0) / active.count.to(g.dtype),
                         spec)


def flat_round_aggregate_active(contrib_tile: torch.Tensor,
                                grads_tile: torch.Tensor,
                                losses_tile: torch.Tensor, active, spec,
                                extra_mean_tile: Optional[torch.Tensor] = None):
    """Eq. (11) and the diagnostics over the PACKED participant tile, the
    active-store twin of :func:`flat_round_aggregate` (every tile
    (capacity, ...) in `active.idx` row order).

    By default the tile is first SCATTERED back into a zero (m, N)
    buffer, and the dense masked expression (`client_mean(mask=...)`)
    runs on it: the same input bits through the same reduction, so the
    aggregate and the `extra` rider are BITWISE the dense store's. The
    active store's saving is then the per-client work (trajectories and
    gradients over capacity rows, not m), not the one (m, N) reduction.
    With `active.packed` (`run_rounds(aggregate="packed")`) the tile is
    summed directly, O(capacity·N) with no (m, N) buffer, at fp
    tolerance (another order of the sum).

    The diagnostics are participant means by construction: `f_mean` the
    participants' loss mean, `grad_sq_norm` their gradient's
    (:func:`flat_grad_sq_norm_active`). `extra_mean_tile` is a plain
    all-client mean (SCAFFOLD's control-variate delta, exact zeros on
    frozen clients): its sum over m. Returns
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``."""
    gsq = flat_grad_sq_norm_active(grads_tile, active, spec)
    n_sel = active.count
    f_mean = torch.sum(active.zero_invalid(losses_tile)) / n_sel
    m = active.num_clients
    if active.packed:
        agg = (torch.sum(active.zero_invalid(contrib_tile), dim=0)
               / n_sel.to(contrib_tile.dtype))
        out = (agg, gsq, f_mean, n_sel)
        if extra_mean_tile is not None:
            out = out + (torch.sum(active.zero_invalid(extra_mean_tile),
                                   dim=0) / m,)
        return out
    dense = contrib_tile.new_zeros((m,) + tuple(contrib_tile.shape[1:]))
    out = (client_mean(active.scatter(dense, contrib_tile), mask=active.mask),
           gsq, f_mean, n_sel)
    if extra_mean_tile is not None:
        extra = torch.zeros_like(dense)
        out = out + (torch.mean(active.scatter(extra, extra_mean_tile),
                                dim=0),)
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
