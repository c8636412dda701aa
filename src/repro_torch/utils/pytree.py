"""Flat-buffer layout for a dict of tensors (counterpart of the
`RavelSpec` family in `repro/utils/pytree.py`).

A model's parameter dict is raveled ONCE per `run_rounds` call into a
single lane-padded (N,) vector (client state: one (m, N) buffer), every
round's elementwise math runs on that contiguous buffer, and the dict is
rebuilt only at the gradient/metric/return boundaries. Leaves are laid
out in the order in which JAX flattens a nested dict, sorted keys at
every level: a key "a/b/c" (a transformer's training tree,
`models/transformer.py`) sorts as the path ("a", "b", "c"), so both
packages produce the same buffer from the same parameters.

The tree arithmetic of the per-leaf rounds (`run_rounds(flat=False)`)
follows: `tree_map` over plain, nested or "/"-keyed dicts, and the
reductions (`tree_dot`, `tree_sq_norm`) sum their leaves onto a float32
zero in that same leaf order, as the flat path's metric sums the leaves
of its buffer, so a per-leaf metric can equal the flat one bit for bit.

The last part is the client store of `run_rounds(store="active" |
"offload")`: `ActiveSet`, the packed participant tile of a round, and
`OffloadStore`, the resident client buffers in host memory.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Tuple

import torch

LANES = 128  # the flat buffer is padded to a multiple of this, with a zero
# tail, so the round kernel never re-pads on the hot path


@dataclasses.dataclass(frozen=True)
class RavelSpec:
    """Flatten layout of a dict of tensors: per-key shapes, dtypes and
    offsets into one 1-D buffer of ``size`` elements, lane-padded to
    ``padded_size`` with zeros. The buffer dtype is the promotion of the
    leaf dtypes, so an unravel->ravel round trip is exact."""

    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    size: int
    padded_size: int
    dtype: torch.dtype

    def ravel(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict -> contiguous (padded_size,) vector (zero-padded tail)."""
        return self.ravel_stacked({k: v[None] for k, v in tree.items()})[0]

    def ravel_stacked(self, tree: Dict[str, torch.Tensor],
                      out: torch.Tensor = None, leaf_fn=None) -> torch.Tensor:
        """Client-stacked dict (leading axis m on every leaf) -> one
        contiguous (m, padded_size) buffer, `out` where given (it may
        hold anything: every lane is written), of `leaf_fn(leaf)` where
        given. Each leaf is copied (and cast) straight into its lanes,
        one at a time, so no temporary of the buffer's size is made: at
        a model's width a buffer is gigabytes."""
        first = tree[self.keys[0]]
        m = first.shape[0]
        if out is None:
            out = torch.empty((m, self.padded_size), dtype=self.dtype,
                              device=first.device)
        for k, o, s in zip(self.keys, self.offsets, self.shapes):
            leaf = tree[k] if leaf_fn is None else leaf_fn(tree[k])
            out[:, o:o + math.prod(s)].view((m,) + s).copy_(leaf)
        out[:, self.size:].zero_()
        return out

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(..., padded_size) buffer -> dict (inverse of :meth:`ravel`).
        The leaves are views of `flat` where no cast is needed."""
        return {
            k: flat[..., o:o + math.prod(s)].reshape(flat.shape[:-1] + s).to(d)
            for k, o, s, d in zip(self.keys, self.offsets, self.shapes,
                                  self.dtypes)
        }

    def unravel_stacked(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(m, padded_size) buffer -> client-stacked dict."""
        return self.unravel(flat)


def ravel_spec(tree: Dict[str, torch.Tensor]) -> RavelSpec:
    """The :class:`RavelSpec` of `tree`'s layout (keys in the order of
    their "/"-separated paths, JAX's order for the nested tree)."""
    keys = tuple(sorted(tree, key=lambda k: k.split("/")))
    shapes = tuple(tuple(tree[k].shape) for k in keys)
    dtypes = tuple(tree[k].dtype for k in keys)
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += math.prod(s)
    dtype = dtypes[0] if dtypes else torch.float32
    for d in dtypes[1:]:
        dtype = torch.promote_types(dtype, d)
    return RavelSpec(keys=keys, shapes=shapes, dtypes=dtypes,
                     offsets=tuple(offsets), size=off,
                     padded_size=-(-off // LANES) * LANES, dtype=dtype)


# --------------------------------------------------------------------------
# Tree arithmetic (counterpart of `repro/utils/pytree.py`'s tree_* helpers).
# A tree is a tensor or a dict of trees; leaves go in `ravel_spec`'s order.
# --------------------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of `tree` in `ravel_spec`'s order: sorted keys at every
    level, a "/"-separated key sorting as its path."""
    if not isinstance(tree, dict):
        return [tree]
    out = []
    for k in sorted(tree, key=lambda k: k.split("/")):
        out += tree_leaves(tree[k])
    return out


def tree_map(fn: Callable, tree, *rest):
    """`fn` applied leaf by leaf to trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_add(a, b):
    return tree_map(torch.add, a, b)


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_mul(a, b):
    return tree_map(torch.mul, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha*x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def tree_ones_like(a):
    return tree_map(torch.ones_like, a)


def tree_dot(a, b) -> torch.Tensor:
    """Σ over leaves of <a_leaf, b_leaf>, each leaf's dot taken whole and
    added in leaf order onto a float32 zero."""
    la, lb = tree_leaves(a), tree_leaves(b)
    total = torch.zeros((), dtype=torch.float32, device=la[0].device)
    for x, y in zip(la, lb):
        total = total + torch.dot(x.reshape(-1), y.reshape(-1))
    return total


def tree_sq_norm(a) -> torch.Tensor:
    return tree_dot(a, a)


def tree_norm(a) -> torch.Tensor:
    return torch.sqrt(tree_sq_norm(a))


def tree_size(a) -> int:
    return sum(x.numel() for x in tree_leaves(a))


def tree_bytes(a) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(a))


def tree_cast(a, dtype):
    return tree_map(lambda x: x.to(dtype), a)


def tree_where(pred, a, b):
    """Leaf-wise select; `pred` broadcasts against every leaf."""
    return tree_map(lambda x, y: torch.where(pred, x, y), a, b)


def tree_mean_over_axis(a, axis: int = 0):
    return tree_map(lambda x: torch.mean(x, dim=axis), a)


def tree_stack(trees, axis: int = 0):
    return tree_map(lambda *xs: torch.stack(xs, dim=axis), *trees)


def tree_unstack(tree, axis: int = 0):
    n = tree_leaves(tree)[0].shape[axis]
    return [tree_map(lambda x: x.select(axis, i), tree) for i in range(n)]


def tree_allclose(a, b, rtol=1e-5, atol=1e-6) -> bool:
    return all(bool(torch.allclose(x, y, rtol=rtol, atol=atol))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def tree_clone(a):
    """A copy of `a` with buffers of its own, each leaf in its own strides
    where they are dense (a transposed factor stays transposed, which a
    solve reads differently) and contiguous where they overlap (a
    stride-0 broadcast becomes m real rows). Leaves that are no tensor
    are kept."""
    return tree_map(lambda x: x.clone() if torch.is_tensor(x) else x, a)


# --------------------------------------------------------------------------
# Active-set client store: a round touches only the packed tile of the
# clients the participation mask selected, gathered from / scattered back
# to the resident (m, padded_size) flat buffers at the round's boundaries.
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ActiveSet:
    """The round's packed participant tile, derived from a dense mask
    (counterpart of `repro/utils/pytree.py::ActiveSet`).

    ``idx`` holds the ascending resident-store row ids of the round's
    participants, padded to the static ``capacity`` with the sentinel
    ``num_clients`` (one past the last row). Padding rows gather a
    clamped duplicate of the last resident row (finite, never NaN), are
    zeroed out of every reduction via ``valid``, and are dropped on
    scatter. Because ``idx`` is ascending and zero rows are exact
    identities of a sum, the default aggregation, which scatters the tile
    back to the dense layout, is BITWISE the dense masked one.

    ``slots`` is how the drop is made on the device without a host sync:
    the same ids, but each padding slot holds a distinct NON-participant
    row (the first ones, ascending). A scatter writes all ``capacity``
    slots with one `index_copy_` (no out-of-range index, no duplicate),
    and a padding slot writes back the value its row already holds, so
    the write is dropped. The engine packs ``slots`` on the host, where
    it draws the mask (`pack_slots`); `active_set` builds the rest on the
    device, so a captured round can build it too.

    ``tile_state`` marks the HOST-OFFLOADED round
    (``run_rounds(store="offload")``): the per-client state buffers the
    round receives are already the gathered (capacity, N) tiles, so
    :meth:`gather_state` / :meth:`scatter_state` are the identity and the
    engine writes the tiles back on the host. ``idx`` / ``slots`` /
    ``valid`` / ``count`` / ``mask`` keep their resident meaning in both
    modes.

    ``packed`` opts the round's eq. (11) into the fp-tolerance PACKED
    aggregation (``run_rounds(aggregate="packed")``): it sums the
    (capacity, N) tile directly instead of scattering it back to the
    dense (m, N) layout first.
    """

    idx: torch.Tensor  # (capacity,) int64 rows, the sentinel m on padding
    slots: torch.Tensor  # (capacity,) int64 distinct rows the scatter writes
    valid: torch.Tensor  # (capacity,) bool, False on padding rows
    count: torch.Tensor  # () float32, the number of participants
    mask: torch.Tensor  # (m,) bool, the round's dense mask
    capacity: int
    num_clients: int
    tile_state: bool = False
    packed: bool = False

    def gather(self, buf: torch.Tensor, out=None) -> torch.Tensor:
        """Resident (m, ...) buffer -> packed (capacity, ...) tile (into
        `out` where given)."""
        return gather_rows(buf, self.idx, out=out)

    def scatter(self, buf: torch.Tensor, tile: torch.Tensor) -> torch.Tensor:
        """Write the packed tile back into its resident rows of `buf`, IN
        PLACE, and return `buf`; padding rows are dropped."""
        return scatter_rows(buf, self.slots, self.valid, tile)

    def gather_state(self, buf: torch.Tensor) -> torch.Tensor:
        """Per-client STATE accessor: resident (m, ...) buffer -> packed
        tile, or the identity under ``tile_state`` (the engine already
        gathered the tile from the host store). Algorithms route their
        `flat_client_keys` reads through this."""
        return buf if self.tile_state else self.gather(buf)

    def scatter_state(self, buf: torch.Tensor,
                      tile: torch.Tensor) -> torch.Tensor:
        """Write-back twin of :meth:`gather_state`: under ``tile_state``
        the updated tile is returned as it is (the engine writes it into
        the host rows), else the in-place resident-row scatter."""
        return tile if self.tile_state else self.scatter(buf, tile)

    def gather_tree(self, tree):
        """Gather every leaf's active rows (the per-client batch), through
        :meth:`gather_state`: the offloaded engine gathers the batch tile
        with the state tiles."""
        return {k: self.gather_state(v) for k, v in tree.items()}

    def zero_invalid(self, tile: torch.Tensor) -> torch.Tensor:
        """Zero the padding rows of a (capacity, ...) tile, so that sums
        over the tile match the dense masked sums bit for bit."""
        v = self.valid.reshape(self.valid.shape + (1,) * (tile.dim() - 1))
        return torch.where(v, tile, torch.zeros_like(tile))


def pack_slots(mask: torch.Tensor, capacity: int) -> torch.Tensor:
    """The (capacity,) int64 `ActiveSet.slots` of a dense (m,) mask: the
    participants' rows ascending, then the first non-participant rows.
    Reads the mask's count (a host sync on a CUDA mask: the engine packs
    on the host). Raises where the mask selects more than `capacity`
    clients, which would drop participants."""
    m = mask.shape[0]
    if not 0 < capacity <= m:
        raise ValueError(f"capacity must be in [1, m={m}], got {capacity}")
    sel = torch.nonzero(mask).reshape(-1)
    if sel.shape[0] > capacity:
        raise ValueError(f"the mask selects {sel.shape[0]} clients, more "
                         f"than the tile's capacity {capacity}")
    rest = torch.nonzero(~mask).reshape(-1)[:capacity - sel.shape[0]]
    return torch.cat([sel, rest])


def active_set(mask: torch.Tensor, slots: torch.Tensor, capacity: int, *,
               tile_state: bool = False, packed: bool = False) -> ActiveSet:
    """The :class:`ActiveSet` of a dense (m,) mask and its packed `slots`
    (`pack_slots`), built on their device without a host sync, so a
    captured CUDA graph can build it."""
    m = mask.shape[0]
    n_sel = torch.sum(mask.to(torch.int64))
    valid = torch.arange(capacity, device=mask.device) < n_sel
    return ActiveSet(
        idx=torch.where(valid, slots, m),
        slots=slots,
        valid=valid,
        count=torch.sum(mask.to(torch.float32)),
        mask=mask,
        capacity=capacity,
        num_clients=m,
        tile_state=tile_state,
        packed=packed,
    )


def make_active_set(mask: torch.Tensor, capacity: int, *,
                    tile_state: bool = False,
                    packed: bool = False) -> ActiveSet:
    """Pack a dense (m,) participation mask into an :class:`ActiveSet`
    (`pack_slots`, then `active_set`). ``capacity`` must bound the
    mask's count (the engine takes the policy's `active_capacity`)."""
    return active_set(mask, pack_slots(mask, capacity), capacity,
                      tile_state=tile_state, packed=packed)


def gather_rows(buf: torch.Tensor, idx: torch.Tensor,
                out=None) -> torch.Tensor:
    """Row gather with clamped out-of-range indices: padding rows read a
    duplicate of the last resident row (finite, deterministic) and are
    masked or dropped downstream."""
    return torch.index_select(buf, 0, idx.clamp(max=buf.shape[0] - 1),
                              out=out)


def scatter_rows(buf: torch.Tensor, slots: torch.Tensor, valid: torch.Tensor,
                 rows: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`gather_rows`, in place: write the valid `rows`
    into their resident rows of `buf` and return `buf`. Every slot is
    written (`slots` distinct and in range), a padding slot with the value
    its row holds already, so its write is dropped."""
    keep = valid.reshape(valid.shape + (1,) * (rows.dim() - 1))
    rows = torch.where(keep, rows.to(buf.dtype),
                       torch.index_select(buf, 0, slots))
    return buf.index_copy_(0, slots, rows)


# --- host-resident placement for run_rounds(store="offload") -----------


def host_put(x: torch.Tensor, pinned: bool) -> torch.Tensor:
    """A host copy of `x`: in page-locked memory when `pinned` (the card's
    runs, so that the tiles' copies to and from the card are DMA and can
    be asynchronous), else plain CPU memory. A failed pin or copy raises:
    the store has no other placement to fall back to."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=pinned)
    return out.copy_(x)


class OffloadStore:
    """Host-resident flat client buffers for ``run_rounds(store="offload")``
    (counterpart of `repro/utils/pytree.py::OffloadStore`).

    Holds the per-client ``flat_client_keys`` buffers (z/π/h, λ, cᵢ) in
    host memory, pinned on the card's runs (`host_put`). Gather and
    scatter are an :class:`ActiveSet`'s own (clip reads, dropped padding
    writes) on the host copies: pure data movement, so the round's tiles
    carry the bits of ``store="active"``."""

    def __init__(self, buffers: Dict[str, torch.Tensor], pinned: bool):
        self.buffers = {k: host_put(v, pinned) for k, v in buffers.items()}

    def gather_tiles(self, active: ActiveSet, out=None):
        """{key: (capacity, ...) tile} of the host rows `active` names,
        written into `out`'s buffers where given (the pinned staging)."""
        return {k: active.gather(b, None if out is None else out[k])
                for k, b in self.buffers.items()}

    def scatter_tiles(self, active: ActiveSet,
                      tiles: Dict[str, torch.Tensor]) -> None:
        """Write the round's updated tiles back into the resident rows."""
        for k, rows in tiles.items():
            active.scatter(self.buffers[k], rows)

    @property
    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size()
                   for b in self.buffers.values())
