"""Round primitives on the unsharded client axis (counterpart of the
single-device subset of `repro/core/api.py`).

Client-stacked tensors carry the client index on axis 0. The reference's
sharded reductions (psum over a mesh axis) have no counterpart here yet.
`client_mean`, `masked_update`, `broadcast_clients` and the stale-x̄
views take the flat buffers or trees of leaves (the per-leaf rounds of
`run_rounds(flat=False)`).
The `_active` twins reduce a round's packed participant tile
(`store="active"` / `"offload"`, `utils.pytree.ActiveSet`). The uplink
stages (the codec of `core/compress.py`, the faults and screening of
`core/faults.py`) run between a round's local work and its eq. (11).
The stale-x̄ state of the async rounds (`StaleXbar`) and its views close
the module.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import compress, prng
from repro_torch.core import faults as faults_mod
from repro_torch.utils import pytree as pt

LossFn = Callable[[Dict[str, torch.Tensor], Dict[str, torch.Tensor]],
                  Tuple[torch.Tensor, dict]]


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (m,) vector shaped to broadcast against a client-stacked tensor."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


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
    buffer's, element for element."""
    if isinstance(x, dict):
        return pt.tree_map(lambda v: _leaf_mean(v, mask, weights), x)
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
    return torch.mean(x)


def client_scalar_sum(x: torch.Tensor,
                      mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sum of a per-client scalar array over all clients (with `mask`,
    over the masked-in clients only)."""
    return torch.sum(x if mask is None else torch.where(mask, x, 0))


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


def flat_grad_sq_norm(grads_flat: torch.Tensor, spec) -> torch.Tensor:
    """The `grad_sq_norm` diagnostic ||(1/m) Σ_i ∇f_i||² over the flat
    (m, N) gradient buffer."""
    return _flat_sq_norm(client_mean(grads_flat), spec)


def flat_round_aggregate(contrib: torch.Tensor, grads: torch.Tensor,
                         losses: torch.Tensor, sel_vec: torch.Tensor, spec,
                         mask: Optional[torch.Tensor] = None,
                         weights: Optional[torch.Tensor] = None,
                         extra_mean: Optional[torch.Tensor] = None):
    """Eq. (11) and the round's diagnostics over the flat client buffers
    (the baselines' rounds; unsharded, so no collective): the (masked,
    `weights`-weighted) mean of the (m, N) `contrib`, `flat_grad_sq_norm`
    of the (m, N) raw gradients, the mean of the (m,) losses and the sum
    of the (m,) participation indicator `sel_vec`. `extra_mean` is one
    more (m, N) buffer whose plain all-client column mean is returned too
    (SCAFFOLD's control-variate delta). Returns
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``."""
    out = (client_mean(contrib, mask=mask, weights=weights),
           flat_grad_sq_norm(grads, spec),
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
    ``(agg, grad_sq_norm, f_mean, n_sel[, extra])``."""
    gsq = flat_grad_sq_norm_active(grads_tile, active, spec)
    n_sel = active.count
    f_mean = torch.sum(active.zero_invalid(losses_tile)) / n_sel
    m = active.num_clients
    if active.packed:
        contrib_z = active.zero_invalid(contrib_tile)
        if weights is None:
            num, den = torch.sum(contrib_z, dim=0), n_sel
        else:
            w_t = torch.where(active.valid, active.gather(
                torch.where(active.mask, weights, 0.0)).to(torch.float32),
                0.0)
            num = torch.sum(_rows(w_t, contrib_z).to(contrib_z.dtype)
                            * contrib_z, dim=0)
            den = torch.sum(w_t)
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


def _compress_row_ids(m: int, device) -> torch.Tensor:
    """GLOBAL client row ids of the (m,) client axis: client i's codec
    and fault keys fold in i, in every store."""
    return torch.arange(m, dtype=torch.int64, device=device)


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
    dec_t, ef_new_t = compress_upload(compressor, contrib_tile, ef_t, spec,
                                      key=key, row_ids=active.idx)
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
    (None without one) and the count of rows that survived (float32)."""
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
            contrib_tile, ok, prev_t, round_idx, active.idx,
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
        buf = pt.tree_map(torch.Tensor.contiguous, buf)
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
    into the refreshed host rows. Returns ``(anchor_tile, stale)``."""
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
