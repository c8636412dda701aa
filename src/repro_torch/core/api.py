"""Round primitives over the client axis (counterpart of
`repro/core/api.py`).

Client-stacked tensors carry the client index on axis 0. Unsharded (the
default) every reduction is a plain torch op. Inside `client_sharding`
(the engine's sharded rounds, `run_rounds(mesh=...)`) the client rows are
split over a `torch.distributed` group (`ClientAxis`, made by
`launch/mesh.py`) and each cross-client reduction becomes a collective
over it: eq. (11) is the round's ONE model-size `all_reduce`, its
scalar riders packed into the same buffer (`torch.distributed` has no
tuple psum); the `grad_sq_norm` diagnostic a reduce-scatter and a
scalar all-reduce; the overlapped round (`run_rounds(overlap=
"scatter")`) a reduce-scatter at the round's end and an all-gather at
the next round's top, and no model-size all-reduce. Every rank issues
the same collectives in the same order: no rank-local branch comes
before one.

`client_mean`, `masked_update`, `broadcast_clients` and the stale-x̄
views take the flat buffers or trees of leaves (the per-leaf rounds of
`run_rounds(flat=False)`).
The `_active` twins reduce a round's packed participant tile
(`store="active"` / `"offload"`, `utils.pytree.ActiveSet`); under a
client mesh each shard packs its own rows and the tile's sums ride the
same collectives as the dense round's. The uplink stages (the codec of
`core/compress.py`, the faults and screening of `core/faults.py`) run
between a round's local work and its eq. (11), shard-local and keyed on
GLOBAL client row ids, so a client draws the same noise and faults
sharded or not. The stale-x̄ state of the async rounds (`StaleXbar`)
and its views close the module.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.core import compress, prng
from repro_torch.core import faults as faults_mod
from repro_torch.utils import pytree as pt

LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, dict]]


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (m,) vector shaped to broadcast against a client-stacked tensor."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


# --------------------------------------------------------------------------
# The client axis. Unsharded (`_CLIENT_AXIS` None) every helper below is a
# plain torch op on the whole (m, ...) axis. Inside `client_sharding` the
# rows are this rank's (m_local, ...) block and the cross-client
# reductions are collectives over the axis's process group.
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ClientAxis:
    """A sharded client axis: the `torch.distributed` group of the ranks
    that split the client rows, their count `shards`, and this rank's
    shard `index` (its rows are ``[index·m_local, (index+1)·m_local)``).
    `launch/mesh.py::Mesh.client_axis` makes it."""

    group: Any
    shards: int
    index: int


_CLIENT_AXIS: Optional[ClientAxis] = None


@contextlib.contextmanager
def client_sharding(axis: ClientAxis):
    """Run rounds with their cross-client reductions as collectives over
    `axis` (the reference's `client_sharding(axis_name, num_shards)`)."""
    global _CLIENT_AXIS
    prev = _CLIENT_AXIS
    _CLIENT_AXIS = axis
    try:
        yield axis
    finally:
        _CLIENT_AXIS = prev


def client_axis() -> Optional[ClientAxis]:
    """The sharded client axis of the rounds running now (None:
    unsharded)."""
    return _CLIENT_AXIS


def local_client_count(m: int) -> int:
    """Clients held by THIS shard (m unsharded)."""
    if _CLIENT_AXIS is None:
        return m
    if m % _CLIENT_AXIS.shards:
        raise ValueError(f"num_clients={m} not divisible by "
                         f"{_CLIENT_AXIS.shards} shards")
    return m // _CLIENT_AXIS.shards


def local_client_slice(arr):
    """This shard's rows of a globally computed (m, ...) array (the
    round's mask: every rank draws the whole mask from the same key and
    keeps its own block)."""
    if _CLIENT_AXIS is None:
        return arr
    m_local = arr.shape[0] // _CLIENT_AXIS.shards
    lo = _CLIENT_AXIS.index * m_local
    return arr[lo:lo + m_local]


def gather_clients(t: torch.Tensor) -> torch.Tensor:
    """The whole (m, ...) client axis from this shard's (m_local, ...)
    rows, on every rank of the axis (one all-gather; the engine calls it
    once after the last round, outside any round). Unsharded: `t`."""
    if _CLIENT_AXIS is None:
        return t
    src = t.contiguous()
    if src.dtype == torch.bool:
        return gather_clients(src.to(torch.uint8)).to(torch.bool)
    out = src.new_empty((_CLIENT_AXIS.shards * src.shape[0],)
                        + tuple(src.shape[1:]))
    _all_gather(out, src)
    return out


def _all_gather(out: torch.Tensor, src: torch.Tensor) -> None:
    """Concatenate the shards' `src` along dim 0 into `out` (the
    `all_gather_single` of newer torch, `all_gather_into_tensor` of
    older)."""
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, src, group=_CLIENT_AXIS.group)


def _reduce_scatter(out: torch.Tensor, src: torch.Tensor) -> None:
    """Sum `src` over the shards and keep this shard's dim-0 block of it
    in `out` (`reduce_scatter_single`, or `reduce_scatter_tensor`)."""
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, src, group=_CLIENT_AXIS.group)


def _all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(t, op=op, group=_CLIENT_AXIS.group)
    return t


def _psum_packed(vec: torch.Tensor, scalars):
    """All-reduce a (n,) vector and 0-d scalars over the client axis: ONE
    collective, the scalars riding at the buffer's end, where the vector
    is float32 (the reference's tuple psum), else the vector and the
    stacked float32 scalars apart. Returns (vector, float32 scalars)."""
    scal = torch.stack([torch.as_tensor(v).to(torch.float32)
                        for v in scalars])
    if vec.dtype != torch.float32:
        return _all_reduce(vec.contiguous()), _all_reduce(scal)
    buf = _all_reduce(torch.cat([vec, scal]))
    return buf[:vec.shape[0]], buf[vec.shape[0]:]


def _local_sums(x: torch.Tensor, mask, weights):
    """This shard's eq. (11) numerator over its rows (weighted, masked or
    plain) and its denominator (None for the plain mean, whose count is
    the static m)."""
    if weights is not None:
        w = weights.to(torch.float32)
        if mask is not None:
            w = torch.where(mask, w, 0.0)
        return torch.sum(_rows(w, x).to(x.dtype) * x, dim=0), torch.sum(w)
    if mask is not None:
        return (torch.sum(torch.where(_rows(mask, x), x, 0.0), dim=0),
                torch.sum(mask.to(torch.float32)))
    return torch.sum(x, dim=0), None


def _sharded_mean(x: torch.Tensor, mask, weights) -> torch.Tensor:
    """`client_mean` of a client-stacked tensor over a sharded axis: the
    sum of the shards' local sums (not a mean of means), over the global
    count or the summed weights, in one all-reduce."""
    num, den = _local_sums(x, mask, weights)
    shape = num.shape
    if den is None:
        m = x.shape[0] * _CLIENT_AXIS.shards
        return _all_reduce(num.reshape(-1)).reshape(shape) / m
    vec, red = _psum_packed(num.reshape(-1), [den])
    return vec.reshape(shape) / red[0].to(vec.dtype)


def client_mean(x, mask: Optional[torch.Tensor] = None,
                weights: Optional[torch.Tensor] = None):
    """Eq. (11): the mean over the leading client axis. With `mask` ((m,)
    bool, at least one True) the mean over the masked-in clients only:
    their sum over their count. With `weights` ((m,), e.g.
    `stale_weights`) the weighted mean Σ w_i x_i / Σ w_i, masked-out
    clients weighing 0; `weights=None` keeps the unweighted paths bit for
    bit (uniform staleness weighting passes None).

    `x` is one (m, ...) tensor (the flat (m, N) buffer) or a tree of them
    (a dict, the per-leaf rounds). A leaf is reduced as the flat buffer
    reduces its lanes (`_as_lanes`), so a tree's mean is the flat
    buffer's, element for element. Under `client_sharding` `x` holds this
    shard's rows and the mean is one all-reduce of the local sums (a
    leaf's, for a tree), the count or weight sum riding in it."""
    if isinstance(x, dict):
        return pt.tree_map(lambda v: _leaf_mean(v, mask, weights), x)
    if _CLIENT_AXIS is not None:
        return _sharded_mean(x, mask, weights)
    if weights is None:
        if mask is None:
            return torch.mean(x, dim=0)
        num = torch.sum(torch.where(_rows(mask, x), x, 0.0), dim=0)
        return num / torch.sum(mask.to(torch.float32)).to(num.dtype)
    w = weights.to(torch.float32)
    if mask is not None:
        w = torch.where(mask, w, 0.0)
    num = torch.sum(_rows(w, x).to(x.dtype) * x, dim=0)
    return num / torch.sum(w).to(num.dtype)


def _as_lanes(leaf: torch.Tensor) -> torch.Tensor:
    """A client-stacked leaf as (m, k) rows zero-padded to whole rows of
    `pt.LANES` lanes, the flat buffer's layout. A reduction over the
    client axis orders its sums by the row width on the CPU (the tail of
    a row that is no whole vector is summed apart), so a leaf summed as
    (m, ...) can differ in the last bit from the same lanes of the flat
    buffer; padded, each column is summed as the flat buffer's."""
    rows = leaf.reshape(leaf.shape[0], -1)
    pad = -rows.shape[1] % pt.LANES
    return torch.nn.functional.pad(rows, (0, pad)) if pad else rows


def _leaf_mean(leaf, mask, weights):
    """`client_mean` of one client-stacked leaf, on its `_as_lanes` rows."""
    k = math.prod(leaf.shape[1:])
    return client_mean(_as_lanes(leaf), mask, weights)[:k].reshape(
        leaf.shape[1:])


def client_scalar_mean(x: torch.Tensor) -> torch.Tensor:
    """Mean of a per-client (m,) scalar array over all clients."""
    if _CLIENT_AXIS is None:
        return torch.mean(x)
    m = x.shape[0] * _CLIENT_AXIS.shards
    return _all_reduce(torch.sum(x)) / m


def client_scalar_sum(x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of a per-client scalar array over all clients (with `mask`,
    over the masked-in clients only)."""
    local = torch.sum(x if mask is None else torch.where(mask, x, 0))
    return local if _CLIENT_AXIS is None else _all_reduce(local)


def client_scalar_max(x: torch.Tensor) -> torch.Tensor:
    """Max of a scalar over all client shards (no-op unsharded)."""
    if _CLIENT_AXIS is None:
        return x
    return _all_reduce(x.clone(), dist.ReduceOp.MAX)


def broadcast_clients(tree, m: int):
    """m copies of a tensor (or dict of tensors) along a new leading
    client axis, as a stride-0 view: a caller that needs its own buffer
    materialises it with `.contiguous()`."""
    if isinstance(tree, dict):
        return {k: broadcast_clients(v, m) for k, v in tree.items()}
    return tree.unsqueeze(0).expand((m,) + tuple(tree.shape))


def masked_update(mask: torch.Tensor, new, old):
    """Row-wise select over the client axis: mask True takes `new`. `new`
    and `old` are (m, ...) tensors or trees of them."""
    return pt.tree_map(
        lambda n, o: torch.where(mask.reshape((-1,) + (1,) * (n.dim() - 1)),
                                 n, o), new, old)


def _flat_sq_norm(vec: torch.Tensor, spec) -> torch.Tensor:
    """||v||² of a flat (N,) vector, leaf by leaf over its unraveled
    dict, as the reference accumulates it."""
    leaves = spec.unravel(vec)
    total = torch.zeros((), dtype=torch.float32, device=vec.device)
    for k in spec.keys:
        v = leaves[k].reshape(-1)
        total = total + torch.dot(v, v)
    return total


def _sharded_sum_sq(g_sum: torch.Tensor, riders=()):
    """||Σ over all shards of g_sum||² without the replicated sum: one
    reduce-scatter hands each shard a column chunk of the sum, and a
    scalar all-reduce adds the chunks' squared norms and the 0-d
    `riders` (a whole-buffer all-reduce, the riders at its end, where the
    columns do not divide over the shards). Returns (||Σ||², the summed
    riders as a float32 vector)."""
    ax = _CLIENT_AXIS
    n = g_sum.shape[0]
    if n % ax.shards:
        if not riders:
            total = _all_reduce(g_sum.contiguous())
            return torch.dot(total, total), None
        total, red = _psum_packed(g_sum, riders)
        return torch.dot(total, total), red
    chunk = g_sum.new_empty((n // ax.shards,))
    _reduce_scatter(chunk, g_sum.contiguous())
    if not riders:
        return _all_reduce(torch.dot(chunk, chunk)), None
    red = _all_reduce(torch.stack(
        [torch.dot(chunk, chunk).to(torch.float32)]
        + [torch.as_tensor(v).to(torch.float32) for v in riders]))
    return red[0], red[1:]


def flat_grad_sq_norm(grads_flat: torch.Tensor, spec) -> torch.Tensor:
    """The `grad_sq_norm` diagnostic ||(1/m) Σ_i ∇f_i||² over the flat
    (m, N) gradient buffer. Under `client_sharding` the metric needs only
    the scalar norm: a reduce-scatter of the local gradient sums and a
    scalar all-reduce, no second model-size all-reduce."""
    if _CLIENT_AXIS is None:
        return _flat_sq_norm(client_mean(grads_flat), spec)
    m = grads_flat.shape[0] * _CLIENT_AXIS.shards
    return _sharded_sum_sq(torch.sum(grads_flat, dim=0))[0] / float(m) ** 2


def flat_round_aggregate(contrib: torch.Tensor, grads: torch.Tensor,
                         losses: torch.Tensor, sel_vec: torch.Tensor, spec,
                         mask: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None,
                         extra_mean: Optional[torch.Tensor] = None,
                         gsq: Optional[torch.Tensor] = None):
    """Eq. (11) and the round's diagnostics over the flat client buffers
    (the baselines' rounds): the (masked, `weights`-weighted) mean of the
    (m, N) `contrib`, `flat_grad_sq_norm` of the (m, N) raw gradients
    (or the given `gsq`), the mean of the (m,) losses and the sum of the
    (m,) participation indicator `sel_vec`. `extra_mean` is one more
    (m, N) buffer whose plain all-client column mean is returned too
    (SCAFFOLD's control-variate delta). Returns
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``.

    Under `client_sharding` the numerator, the `extra_mean` rider, the
    loss and participant sums and the weight sum ride ONE all-reduce
    (one buffer: eq. (11) as one contiguous communication), and the
    gradient norm goes through `flat_grad_sq_norm`'s reduce-scatter. The
    sum of local sums matches the unsharded mean to fp tolerance."""
    if gsq is None:
        gsq = flat_grad_sq_norm(grads, spec)
    if _CLIENT_AXIS is None:
        out = (client_mean(contrib, mask=mask, weights=weights), gsq,
               torch.mean(losses), torch.sum(sel_vec))
        if extra_mean is not None:
            out = out + (torch.mean(extra_mean, dim=0),)
        return out
    m = contrib.shape[0] * _CLIENT_AXIS.shards
    num, den = _local_sums(contrib, mask, weights)
    n_buf = num.shape[0]
    if extra_mean is not None:
        num = torch.cat([num, torch.sum(extra_mean, dim=0).to(num.dtype)])
    scalars = [torch.sum(losses), torch.sum(sel_vec)]
    if den is not None:
        scalars.append(den)
    num, red = _psum_packed(num, scalars)  # the round's ONE all-reduce
    agg = num[:n_buf] / (red[2].to(num.dtype) if den is not None else m)
    out = (agg, gsq, red[0] / m, red[1])
    if extra_mean is not None:
        out = out + (num[n_buf:] / m,)
    return out


def flat_overlap_consensus(slot: torch.Tensor) -> torch.Tensor:
    """The consensus from the overlapped round's carry slot
    (``state["ovl_shard"]``, `run_rounds(overlap="scatter")`): the
    deferred half of eq. (11). The slot holds the previous round's
    normalised (rows, N) means (row 0 x̄, further rows an algorithm's
    riders). Unsharded it is the whole buffer, returned as it is. Under
    `client_sharding` each shard holds its (rows, N/shards) column chunk
    and this is the round's one model-size all-gather, at its top."""
    if _CLIENT_AXIS is None:
        return slot
    shards = _CLIENT_AXIS.shards
    rows, cols = slot.shape
    out = slot.new_empty((shards * rows, cols))
    _all_gather(out, slot.contiguous())
    return out.view(shards, rows, cols).transpose(0, 1).reshape(
        rows, shards * cols)


def flat_overlap_aggregate(contrib: torch.Tensor, grads, losses, sel_vec,
                           spec, mask=None, weights=None, extra_mean=None,
                           gsq=None, grad_sum=None):
    """Eq. (11) as the early half of the split collective: this round's
    contributions reduced into the next round's carry slot
    (`run_rounds(overlap="scatter")`). The arguments are
    `flat_round_aggregate`'s; returns ``(slot', grad_sq_norm, f_mean,
    n_sel)`` where ``slot'`` stacks the normalised contribution mean and
    the `extra_mean` rows.

    Unsharded this is `flat_round_aggregate` with its outputs stacked, so
    the overlapped run is the barrier run bit for bit. Under
    `client_sharding` the local numerator, riders and gradient sum
    (`grad_sum`, else the sum of `grads`) are stacked into one (rows, N)
    buffer and reduce-scattered by columns (the round's ONE model-size
    collective, at its end); the chunk's gradient norm, the loss and
    participant sums and the weight sum ride one scalar all-reduce. The
    slot is then each shard's (rows, N/shards) column chunk."""
    if _CLIENT_AXIS is None:
        out = flat_round_aggregate(contrib, grads, losses, sel_vec, spec,
                                   mask=mask, weights=weights,
                                   extra_mean=extra_mean, gsq=gsq)
        rows = [out[0]] if extra_mean is None else [out[0], out[4]]
        return torch.stack(rows), out[1], out[2], out[3]
    shards = _CLIENT_AXIS.shards
    m = contrib.shape[0] * shards
    n = contrib.shape[-1]
    if n % shards:
        raise ValueError(f"overlap reduce-scatter needs padded_size {n} "
                         f"divisible by {shards} shards")
    num, den = _local_sums(contrib, mask, weights)
    rows = [num]
    if extra_mean is not None:
        rows.append(torch.sum(extra_mean, dim=0).to(num.dtype))
    if grad_sum is None:
        grad_sum = torch.sum(grads, dim=0)
    rows.append(grad_sum.to(num.dtype))
    chunks = _scatter_columns(rows)
    g = chunks[-1]
    scalars = [torch.dot(g, g), torch.sum(losses), torch.sum(sel_vec)]
    if den is not None:
        scalars.append(den)
    red = _all_reduce(torch.stack([torch.as_tensor(v).to(torch.float32)
                                   for v in scalars]))
    slot = [chunks[0] / (red[3].to(chunks.dtype) if den is not None
                         else m)]
    if extra_mean is not None:
        slot.append(chunks[1] / m)
    return torch.stack(slot), red[0] / float(m) ** 2, red[1] / m, red[2]


def _scatter_columns(rows):
    """Sum the stacked (rows, N) buffer over the shards and keep this
    shard's (rows, N/shards) column chunk: ONE reduce-scatter (dim 0
    only, so each shard's columns go through a (shards, rows, N/shards)
    transpose)."""
    shards = _CLIENT_AXIS.shards
    r, cols = len(rows), rows[0].shape[0] // shards
    stacked = torch.stack(rows).view(r, shards, cols).transpose(0, 1)
    chunks = rows[0].new_empty((r, cols))
    _reduce_scatter(chunks, stacked.reshape(shards * r, cols))
    return chunks


def _active_sums(contrib_tile: torch.Tensor, active, weights):
    """The packed O(capacity) eq. (11) numerator of a tile (padding and
    screened rows zeroed; with the DENSE (m,) `weights`, each row's
    weight gathered) and its denominator: the participant count, or the
    weight sum."""
    contrib_z = active.zero_invalid(contrib_tile)
    if weights is None:
        return torch.sum(contrib_z, dim=0), active.count
    w_t = torch.where(active.valid, active.gather(
        torch.where(active.mask, weights, 0.0)).to(torch.float32), 0.0)
    return (torch.sum(_rows(w_t, contrib_z).to(contrib_z.dtype) * contrib_z,
                      dim=0), torch.sum(w_t))


def flat_grad_sq_norm_active(grads_tile: torch.Tensor, active,
                             spec) -> torch.Tensor:
    """The participant-gradient diagnostic ||(1/|C|) Σ_{i∈C} ∇f_i||² over
    the packed (capacity, N) gradient tile (`utils.pytree.ActiveSet`).
    This is the active store's `grad_sq_norm`: the server never contacted
    the frozen clients this round, so the eq. (35) stop gates on the
    participants' mean gradient. Padding rows are zeroed. Under
    `client_sharding` the tile's gradient sum is reduce-scattered and
    the chunk's squared norm and the participant count ride one scalar
    all-reduce (both in one all-reduce where the columns do not divide
    over the shards)."""
    g = active.zero_invalid(grads_tile)
    if _CLIENT_AXIS is None:
        return _flat_sq_norm(torch.sum(g, dim=0) / active.count.to(g.dtype),
                             spec)
    sq, red = _sharded_sum_sq(torch.sum(g, dim=0), [active.count])
    return sq / red[0] ** 2


def flat_round_aggregate_active(contrib_tile: torch.Tensor,
                                grads_tile: torch.Tensor,
                                losses_tile: torch.Tensor, active, spec,
                                weights: Optional[torch.Tensor] = None,
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
    (:func:`flat_grad_sq_norm_active`). `weights` are the DENSE (m,)
    staleness weights (:func:`stale_weights`). `extra_mean_tile` is a
    plain all-client mean (SCAFFOLD's control-variate delta, exact zeros
    on frozen clients): its sum over m. Returns
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``.

    Under `client_sharding` the tile is this shard's, packed from its own
    rows: the packed sums (the `packed` arithmetic, whatever the flag),
    SCAFFOLD's rider concatenated onto the numerator, and the loss sum,
    the participant count and the weight sum ride ONE all-reduce; the
    rider is divided by the global m."""
    gsq = flat_grad_sq_norm_active(grads_tile, active, spec)
    if _CLIENT_AXIS is not None:
        return _sharded_aggregate_active(contrib_tile, losses_tile, active,
                                         weights, extra_mean_tile, gsq)
    n_sel = active.count
    f_mean = torch.sum(active.zero_invalid(losses_tile)) / n_sel
    m = active.num_clients
    if active.packed:
        num, den = _active_sums(contrib_tile, active, weights)
        out = (num / den.to(num.dtype), gsq, f_mean, n_sel)
        if extra_mean_tile is not None:
            out = out + (torch.sum(active.zero_invalid(extra_mean_tile),
                                   dim=0) / m,)
        return out
    dense = contrib_tile.new_zeros((m,) + tuple(contrib_tile.shape[1:]))
    out = (client_mean(active.scatter(dense, contrib_tile), mask=active.mask,
                       weights=weights),
           gsq, f_mean, n_sel)
    if extra_mean_tile is not None:
        extra = torch.zeros_like(dense)
        out = out + (torch.mean(active.scatter(extra, extra_mean_tile),
                                dim=0),)
    return out


def _sharded_aggregate_active(contrib_tile, losses_tile, active, weights,
                              extra_mean_tile, gsq):
    """`flat_round_aggregate_active` on a sharded axis: the round's ONE
    model-size all-reduce."""
    m = active.num_clients * _CLIENT_AXIS.shards
    num, den = _active_sums(contrib_tile, active, weights)
    n_buf = num.shape[0]
    if extra_mean_tile is not None:
        num = torch.cat([num, torch.sum(active.zero_invalid(extra_mean_tile),
                                        dim=0).to(num.dtype)])
    num, red = _psum_packed(num, [
        torch.sum(active.zero_invalid(losses_tile)), active.count, den])
    out = (num[:n_buf] / red[2].to(num.dtype), gsq, red[0] / red[1], red[1])
    if extra_mean_tile is not None:
        out = out + (num[n_buf:] / m,)
    return out


def flat_overlap_aggregate_active(contrib_tile: torch.Tensor,
                                  grads_tile: torch.Tensor,
                                  losses_tile: torch.Tensor, active, spec,
                                  weights: Optional[torch.Tensor] = None,
                                  extra_mean_tile: Optional[
                                      torch.Tensor] = None):
    """Active-store twin of :func:`flat_overlap_aggregate`: the packed
    participant tile reduced into the next round's carry slot. The
    arguments are :func:`flat_round_aggregate_active`'s; returns
    ``(slot', grad_sq_norm, f_mean, n_sel)`` with the active store's
    participant diagnostics.

    Unsharded it is :func:`flat_round_aggregate_active` with its outputs
    stacked, so the overlapped active run is the barrier one bit for bit.
    Under `client_sharding` the zeroed tile's numerator, the rider and
    the gradient sum are stacked into one column-wise reduce-scatter (the
    round's ONE model-size collective, laid out as the dense overlap's),
    and the chunk's squared norm, the loss sum, the participant count and
    the weight sum ride one scalar all-reduce."""
    if _CLIENT_AXIS is None:
        out = flat_round_aggregate_active(contrib_tile, grads_tile,
                                          losses_tile, active, spec,
                                          weights=weights,
                                          extra_mean_tile=extra_mean_tile)
        rows = [out[0]] if extra_mean_tile is None else [out[0], out[4]]
        return torch.stack(rows), out[1], out[2], out[3]
    shards = _CLIENT_AXIS.shards
    m = active.num_clients * shards
    n = contrib_tile.shape[-1]
    if n % shards:
        raise ValueError(f"overlap reduce-scatter needs padded_size {n} "
                         f"divisible by {shards} shards")
    num, den = _active_sums(contrib_tile, active, weights)
    rows = [num]
    if extra_mean_tile is not None:
        rows.append(torch.sum(active.zero_invalid(extra_mean_tile),
                              dim=0).to(num.dtype))
    rows.append(torch.sum(active.zero_invalid(grads_tile),
                          dim=0).to(num.dtype))
    chunks = _scatter_columns(rows)
    g = chunks[-1]
    scalars = (torch.dot(g, g), torch.sum(active.zero_invalid(losses_tile)),
               active.count, den)
    red = _all_reduce(torch.stack([v.to(torch.float32) for v in scalars]))
    slot = [chunks[0] / red[3].to(chunks.dtype)]
    if extra_mean_tile is not None:
        slot.append(chunks[1] / m)
    return torch.stack(slot), red[0] / red[2] ** 2, red[1] / red[2], red[2]


# --------------------------------------------------------------------------
# The uplink: codec (core/compress.py), then faults and screening
# (core/faults.py), between a round's local work and eq. (11).
# --------------------------------------------------------------------------
def codec_key(state, device) -> torch.Tensor:
    """The round's codec base key (`compress.round_key`) as a (2,) int64
    tensor on `device`: the chunked driver's upload
    (``state["codec_key"]``, computed on the host a chunk ahead, since it
    keeps the key there), else the fold of the state's host key with its
    round counter, before the round's split."""
    if "codec_key" in state:
        return state["codec_key"]
    return prng.key_t(compress.round_key(state["rng"], state["round"]),
                      device)


def next_codec_key(state, rng, device) -> torch.Tensor:
    """The codec base key of the round AFTER this one, as `codec_key`
    makes it: the overlapped FedGiA round uploads at its end what the
    next round aggregates, under the key that barrier round would draw.
    The chunked driver's upload (``state["codec_key_next"]``), else the
    fold of `rng` (the key after this round's split) with round + 1."""
    if "codec_key_next" in state:
        return state["codec_key_next"]
    return prng.key_t(compress.round_key(rng, state["round"] + 1), device)


def _global_ids(ids: torch.Tensor, m_local: int) -> torch.Tensor:
    """This shard's row ids (in [0, m_local)) as GLOBAL client ids: the
    shard's offset ``index · m_local`` added under `client_sharding`, so
    client i's codec noise and fault draws are the same sharded or not
    (without it every shard would draw shard 0's)."""
    if _CLIENT_AXIS is None:
        return ids
    return ids + _CLIENT_AXIS.index * m_local


def _compress_row_ids(m: int, device) -> torch.Tensor:
    """GLOBAL client row ids of this shard's (m,) rows: client i's codec
    and fault keys fold in i, in every store."""
    return _global_ids(torch.arange(m, dtype=torch.int64, device=device), m)


def compress_upload(compressor, contrib: torch.Tensor,
                    ef: Optional[torch.Tensor], spec, *,
                    key: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None,
                    row_ids: Optional[torch.Tensor] = None):
    """The round's uplink through a codec. Returns ``(decoded, ef')``:
    the server-visible fp32 decode of each client's upload and the
    advanced error-feedback residual (None when ``ef`` is None).

    Per client i the upload is u_i = contrib_i + e_i, the server sees
    C(u_i) and the residual becomes u_i - C(u_i), so the decoded uploads
    and the final residual telescope to the raw uploads. With ``mask``,
    masked-out clients did not upload: their residual stays. The decode
    of the lane-padded tail is forced back to zero. ``key`` (stochastic
    codecs): the round's base key (`codec_key`); client keys fold in the
    GLOBAL row ids (``row_ids``: the active store's resident ids)."""
    u = contrib if ef is None else contrib + ef
    keys = None
    if compressor.stochastic:
        assert key is not None, (
            f"{compressor.name} uses stochastic rounding and needs the "
            "round key (compress.round_key)")
        ids = row_ids if row_ids is not None else _compress_row_ids(
            u.shape[0], u.device)
        keys = prng.fold_in_t(key[None], ids)
    dec = compressor.encode_decode(u, keys=keys, n=spec.size)
    if spec.padded_size != spec.size:
        lane = torch.arange(u.shape[-1], device=u.device) < spec.size
        dec = torch.where(lane, dec, 0.0)
    if ef is None:
        return dec, None
    ef_new = u - dec
    if mask is not None:
        ef_new = masked_update(mask, ef_new, ef)
    return dec, ef_new


def compress_upload_active(compressor, contrib_tile: torch.Tensor,
                           ef: Optional[torch.Tensor], active, spec, *,
                           key: Optional[torch.Tensor] = None):
    """Active-store twin of :func:`compress_upload`: the codec runs on the
    packed (capacity, N) participant tile, the participants' residual
    rows are gathered from the resident ``ef``, advanced and scattered
    back (padding rows dropped, frozen clients untouched), and the
    stochastic keys come from the tile's resident row ids, so tile and
    dense rounds quantize each client alike. Returns ``(decoded_tile,
    ef')``: the whole resident residual, or under the offloaded store
    (``active.tile_state``) the residual tile, which its engine writes
    back."""
    ef_t = None if ef is None else active.gather_state(ef)
    dec_t, ef_new_t = compress_upload(
        compressor, contrib_tile, ef_t, spec, key=key,
        row_ids=_global_ids(active.idx, active.num_clients))
    if ef is None:
        return dec_t, None
    return dec_t, active.scatter_state(ef, ef_new_t)


def harden_upload(contrib: torch.Tensor, mask: Optional[torch.Tensor], spec,
                  *, faults=None, screening=None,
                  fault_prev: Optional[torch.Tensor] = None, round_idx=None):
    """The round's fault injection and screening, between the codec's
    decode and eq. (11): the `FaultModel` corrupts the (m, N) upload
    (crashed rows leave the mask; the replay buffer advances), then the
    `Screening` finite check and clip. Returns ``(contrib', mask',
    prev', n_screened)``: every row finite and non-arriving rows zero,
    the screened mask (within ``mask``), the advanced replay buffer
    (None without one) and the count of rows that survived (float32),
    over every shard (a scalar all-reduce under `client_sharding`)."""
    row_ids = _compress_row_ids(contrib.shape[0], contrib.device)
    prev_new = None
    if faults is not None:
        contrib, mask, prev_new = faults.apply(
            contrib, mask, fault_prev, round_idx, row_ids,
            payload_cols=spec.size)
    if screening is not None:
        contrib, mask = faults_mod.screen_rows(contrib, mask, screening)
    ones = torch.ones(contrib.shape[0], dtype=torch.float32,
                      device=contrib.device)
    return contrib, mask, prev_new, client_scalar_sum(ones, mask=mask)


def harden_upload_active(contrib_tile: torch.Tensor, active, spec, *,
                         faults=None, screening=None,
                         fault_prev: Optional[torch.Tensor] = None,
                         round_idx=None):
    """Active-store twin of :func:`harden_upload` on the packed tile,
    keyed on its resident row ids (the dense round's faults). The rows
    screened out leave the `ActiveSet` itself: ``valid``, ``count`` and
    the dense ``mask`` shrink to the survivors, so the unchanged
    `flat_round_aggregate_active` sums exactly the screened set (and
    SCAFFOLD's rider with it). The replay buffer goes through
    ``gather_state``/``scatter_state`` like the EF residual. Returns
    ``(tile', active', prev', n_screened)``."""
    ok = active.valid
    prev_new = None
    if faults is not None:
        prev_t = (active.gather_state(fault_prev)
                  if fault_prev is not None else None)
        contrib_tile, ok, prev_t_new = faults.apply(
            contrib_tile, ok, prev_t, round_idx,
            _global_ids(active.idx, active.num_clients),
            payload_cols=spec.size)
        if prev_t_new is not None:
            prev_new = active.scatter_state(fault_prev, prev_t_new)
    if screening is not None:
        contrib_tile, ok = faults_mod.screen_rows(contrib_tile, ok,
                                                  screening)
    dense_ok = active.scatter(
        torch.zeros(active.num_clients, dtype=torch.bool,
                    device=ok.device), ok)
    count = torch.sum(ok.to(torch.float32))
    active2 = dataclasses.replace(
        active, valid=ok, count=count,
        mask=torch.logical_and(active.mask, dense_ok))
    return contrib_tile, active2, prev_new, client_scalar_sum(
        ok.to(torch.float32))


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


# --------------------------------------------------------------------------
# Stale-x̄ state of the async rounds. The server still aggregates every
# round (eq. (11)), but each client anchors its local branch on the x̄ it
# last DOWNLOADED, at most `max_staleness` rounds old. The round's mask is
# the arrival process: True means the client uploads this round (its
# contribution was computed against its stale view) and then downloads
# the fresh x̄.
# --------------------------------------------------------------------------
@dataclasses.dataclass
class StaleXbar:
    """Per-client stale view of the global anchor x̄ (counterpart of
    `repro/core/api.py::StaleXbar`, a plain dataclass here).

    * ``anchor``: (m, N) flat buffer, client i's last-downloaded x̄ (in
      the per-leaf rounds a tree of (m, ...) leaves, as the reference's
      per-leaf anchors). Under ``max_staleness == 0`` it is never read
      and stays the stride-0 broadcast of the initial x̄.
    * ``age``: (m,) int32, rounds since client i's last download, as seen
      entering a round; `init_stale_xbar` sets ``max_staleness + 1`` so
      that round 0 force-syncs every client.
    * ``last_used``: (m,) int32, the staleness s of the anchor client i
      used in the round just run (its branch ran against x̄^(t-s)); the
      engine reports it as the round's ``staleness``. Always
      ``last_used <= max_staleness``.
    * ``max_staleness``, ``weighting``, ``decay``: static Python values
      (the bound, and the `stale_weights` schedule).
    * ``view``: the (m, N) buffer (or tree) the round's per-client
      anchors are written into (None under ``max_staleness == 0``).

    The views below update the tensors IN PLACE and hand back the same
    object, so a round captured in a CUDA graph writes the static buffers
    and allocates no (m, N) tensor.
    """

    anchor: torch.Tensor
    age: torch.Tensor
    last_used: torch.Tensor
    max_staleness: int = 0
    weighting: str = "uniform"
    decay: float = 1.0
    view: Optional[torch.Tensor] = None

    @property
    def always_fresh(self) -> bool:
        """True when max_staleness == 0: every client refreshes every
        round, so the algorithms keep their synchronous (shared-anchor)
        path, bit for bit."""
        return self.max_staleness == 0

    def clone(self) -> "StaleXbar":
        """A copy with buffers of its own (the chunked driver's warm-up
        round runs on one)."""
        return dataclasses.replace(
            self, anchor=(self.anchor if self.always_fresh
                          else pt.tree_map(torch.clone, self.anchor)),
            age=self.age.clone(), last_used=self.last_used.clone(),
            view=(None if self.view is None
                  else pt.tree_map(torch.empty_like, self.view)))


STALE_WEIGHTINGS = ("uniform", "poly", "exp")


def init_stale_xbar(anchor, m: int, max_staleness: int,
                    weighting: str = "uniform", decay: float = 1.0,
                    resident: bool = True) -> StaleXbar:
    """The engine's initial staleness state from the (N,) flat x̄⁰ (or
    the per-leaf rounds' x̄⁰ tree, which gives per-leaf anchors): every
    client's view is x̄⁰ and `age` starts past the bound, so round 0
    force-syncs every client. `weighting`/`decay` select the aggregation
    schedule (`stale_weights`). `resident=False` (the host-offloaded
    store, which keeps the (m, N) anchor in host memory) leaves `anchor`
    the stride-0 broadcast and `view` None."""
    if weighting not in STALE_WEIGHTINGS:
        raise ValueError(
            f"unknown stale weighting {weighting!r}: {STALE_WEIGHTINGS}")
    if weighting != "uniform" and decay <= 0:
        # a negative decay would silently UPweight the stalest anchors
        raise ValueError(f"stale weighting decay must be > 0, got {decay}")
    buf = broadcast_clients(anchor, m)
    view = None
    if max_staleness > 0 and resident:
        # a copy of its own, also where one row of a stride-0 view
        # counts as contiguous (m = 1 on a shard)
        buf = pt.tree_map(
            lambda t: t.clone(memory_format=torch.contiguous_format), buf)
        view = pt.tree_map(torch.empty_like, buf)
    dev = pt.tree_leaves(anchor)[0].device
    return StaleXbar(
        anchor=buf,
        age=torch.full((m,), max_staleness + 1, dtype=torch.int32,
                       device=dev),
        last_used=torch.zeros((m,), dtype=torch.int32, device=dev),
        max_staleness=int(max_staleness), weighting=weighting,
        decay=float(decay), view=view)


def stale_weights(stale: Optional[StaleXbar]) -> Optional[torch.Tensor]:
    """Per-client weights of the staleness-aware eq. (11), from the age s
    of the anchor each client's contribution was computed against
    (``stale.last_used``): "uniform" gives None (`client_mean`'s
    unweighted path, bit for bit), "poly" (1 + s)^(-decay), "exp"
    exp(-decay · s)."""
    if stale is None or stale.weighting == "uniform":
        return None
    s = stale.last_used.to(torch.float32)
    if stale.weighting == "poly":
        return (1.0 + s) ** (-stale.decay)
    if stale.weighting == "exp":
        return torch.exp(-stale.decay * s)
    raise ValueError(
        f"unknown stale weighting {stale.weighting!r}: {STALE_WEIGHTINGS}")


def _advance(stale: StaleXbar, force: torch.Tensor,
             refresh: torch.Tensor) -> None:
    """The per-client scalars, in place: the staleness used this round
    (0 where forced, else the age) and the next round's age (1 where the
    client downloads, else one more)."""
    stale.last_used.copy_(stale.age).masked_fill_(force, 0)
    torch.add(stale.last_used, 1, out=stale.age)
    stale.age.masked_fill_(refresh, 1)


def _fresh(stale: StaleXbar) -> None:
    stale.age.fill_(1)
    stale.last_used.zero_()


def stale_xbar_view(stale: StaleXbar, xbar: torch.Tensor,
                    mask: torch.Tensor):
    """The round's per-client anchors, and the advanced stale state.

    Per client i at round t (after x̄ᵗ exists):
      1. force-sync: where ``age_i > max_staleness`` the client downloads
         x̄ᵗ before computing (the server blocks on it);
      2. the round runs against ``anchor_i`` (staleness 0 if forced, else
         ``age_i``);
      3. arrivals (``mask_i``) upload and then download x̄ᵗ: their view
         re-anchors and their age resets to 1; the others age by one.

    With ``max_staleness == 0`` the (m, N) anchors are the stride-0
    broadcast of x̄ and no select runs. Otherwise the anchors are written
    into ``stale.view`` and the refreshed views into ``stale.anchor``,
    both in place: the round reads ``stale.view``, which stays unchanged
    until the next round's view. `xbar` and the buffers are tensors or
    trees, leaf by leaf. Returns ``(anchors, stale)``.
    """
    m = stale.age.shape[0]
    if stale.always_fresh:
        _fresh(stale)
        return broadcast_clients(xbar, m), stale
    force = stale.age > stale.max_staleness
    refresh = torch.logical_or(mask, force)
    view = pt.tree_map(
        lambda a, x, v: torch.where(_rows(force, a), x, a, out=v),
        stale.anchor, xbar, stale.view)
    pt.tree_map(lambda v, x, a: torch.where(_rows(refresh, v), x, v, out=a),
                view, xbar, stale.anchor)
    _advance(stale, force, refresh)
    return view, stale


def stale_xbar_view_active(stale: StaleXbar, xbar: torch.Tensor, active):
    """Active-store twin of :func:`stale_xbar_view`: the anchors of the
    packed tile only, (capacity, N), gathered from the resident (m, N)
    view (padding rows carry a clamped duplicate, masked downstream like
    any tile row). `age` and `last_used` stay dense (m,) and advance as
    the dense store's; the resident anchor takes one in-place row select.

    Under the host-offloaded store (``active.tile_state``) ``stale.anchor``
    arrives as the gathered (capacity, N) tile and the resident anchor is
    in host memory: the refresh write is the engine's, so ``stale.anchor``
    comes back as the fresh (N,) x̄, whose exact bits the engine writes
    into the refreshed host rows. Under `client_sharding` the tile, the
    resident anchor, `age` and `last_used` are the shard's rows, and the
    view issues no collective. Returns ``(anchor_tile, stale)``."""
    if stale.always_fresh:
        _fresh(stale)
        return broadcast_clients(xbar, active.capacity), stale
    force = stale.age > stale.max_staleness
    refresh = torch.logical_or(active.mask, force)
    tile = active.gather_state(stale.anchor)
    anchor_t = torch.where(_rows(active.gather(force), tile), xbar, tile)
    if active.tile_state:
        stale.anchor = xbar
    else:
        torch.where(_rows(refresh, stale.anchor), xbar, stale.anchor,
                    out=stale.anchor)
    _advance(stale, force, refresh)
    return anchor_t, stale


def stale_anchor(stale: Optional[StaleXbar], xbar: torch.Tensor):
    """The anchor of the round whose view has just run: x̄ itself without
    stale state or under ``always_fresh``, else the (m, N) per-client
    view that `stale_xbar_view` wrote into ``stale.view``."""
    if stale is None or stale.always_fresh:
        return xbar
    return stale.view


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
