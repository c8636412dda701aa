"""Shared pieces for the paper's comparison baselines (§V.D).

Counterpart of `repro/core/baselines/common.py`. All baselines use the
paper's learning-rate schedule
    gamma_k(a) = a / log2(k + 2)
with k the GLOBAL inner-iteration counter `state["step"]`. The paper's
comparison protocol is full participation (`mask=None`: every client
updates every round); with a per-round (m,) mask only masked-in clients
are aggregated, and the per-client state of the others is frozen.

`step` and `round` are Python ints in the state a caller sees and 0-d
integer tensors on the run's device inside the chunked driver
(`core/engine.py`), so that a replayed CUDA graph reads each round's
own counter; every function here takes either.

The uplink (`compressor=`, `faults=`, `screening=` of each round) runs
between a round's local work and eq. (11): `FlatBaseline.upload` and
`upload_active` put the round's contribution through the codec
(`compress_contrib`, with the error-feedback residual ``ef``) and then
the fault injection and screening, whose mask replaces the round's for
the aggregation only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import api


class FlatBaseline:
    """What the four baselines share: the flat state layout (x̄ an (N,)
    buffer; per-client state, where there is any, one (m, N) buffer
    each), the stacked per-client gradient, the initial state and the
    end of a round. A subclass adds its `round_flat`."""

    # the engine's codec residual and fault replay buffer, where it makes
    # them: (m, N) flat client buffers like the algorithms' own
    flat_client_keys = ("ef", "fault_prev")
    flat_global_keys = ("x",)
    # store="active": frozen clients are never read or written, so a
    # round runs on the participants' packed tile (`round_flat_active`)
    active_tile = "participants"

    def __init__(self, fed, loss_fn: api.LossFn, model=None):
        self.fed = fed
        self.loss_fn = loss_fn
        self.model = model
        self._vg_stacked = api.per_client_value_and_grad_stacked(loss_fn)

    def init(self, params0, rng, init_batch=None):
        """x̄ = params0 in the state dtype, both counters 0, and the run's
        threefry key (which no baseline splits)."""
        sdt = getattr(torch, self.fed.state_dtype)
        return {"x": {k: v.to(sdt) for k, v in params0.items()},
                "round": 0, "step": 0, "rng": np.array(rng, np.uint32)}

    def _anchors(self, state, rows: int, mask=None, stale=None,
                 active=None):
        """The (rows, N) starting points of the round's local work: the
        stride-0 broadcast of x̄, or, in an async round (`stale`), each
        client's last-downloaded x̄ (`api.stale_xbar_view`, or its
        `_active` twin on the packed tile when `active` is given). Returns
        anchors; the stale state advances in place."""
        if stale is None:
            return api.broadcast_clients(state["x"], rows)
        if active is None:
            return api.stale_xbar_view(stale, state["x"], mask)[0]
        return api.stale_xbar_view_active(stale, state["x"], active)[0]

    def upload(self, state, contrib, spec, mask, compressor=None,
               faults=None, screening=None):
        """The dense round's uplink: the (m, N) contribution through the
        codec (masked-out clients keep their residual), then the faults
        and screening. Returns (the aggregated buffer, the aggregation's
        mask, the uplink's state updates, n_screened or None)."""
        up, ef_new = compress_contrib(compressor, state, contrib, spec,
                                      mask=mask)
        updates = {} if ef_new is None else {"ef": ef_new}
        n_scr = None
        if faults is not None or screening is not None:
            up, mask, fprev_new, n_scr = api.harden_upload(
                up, mask, spec, faults=faults, screening=screening,
                fault_prev=state.get("fault_prev"),
                round_idx=state["round"])
            if fprev_new is not None:
                updates["fault_prev"] = fprev_new
        return up, mask, updates, n_scr

    def upload_active(self, state, contrib_tile, spec, active,
                      compressor=None, faults=None, screening=None):
        """`upload` on the packed participant tile: the codec and the
        faults key on the tile's resident row ids, and the screened rows
        leave the returned `ActiveSet`. Returns (the aggregated tile, the
        aggregation's ActiveSet, the state updates, n_screened or
        None)."""
        up, ef_new = compress_contrib_active(compressor, state,
                                             contrib_tile, spec, active)
        updates = {} if ef_new is None else {"ef": ef_new}
        n_scr = None
        if faults is not None or screening is not None:
            up, active, fprev_new, n_scr = api.harden_upload_active(
                up, active, spec, faults=faults, screening=screening,
                fault_prev=state.get("fault_prev"),
                round_idx=state["round"])
            if fprev_new is not None:
                updates["fault_prev"] = fprev_new
        return up, active, updates, n_scr

    def _result(self, state, aggregate, grad_evals, n_scr=None, **updates):
        """(new state, metrics) of a round from the outputs of
        `api.flat_round_aggregate` or its `_active` twin (x̄', |grad|^2,
        f, participants): both
        counters advanced (`step` by the k0 local steps), `updates` (the
        per-client state) stored, `grad_evals` gradients a client, and
        `screened` where the uplink screened (`n_scr`)."""
        x_new, gsq, f_mean, n_sel = aggregate
        new_state = dict(state, x=x_new, round=state["round"] + 1,
                         step=state["step"] + self.fed.k0, **updates)
        metrics = round_metrics_flat(gsq, f_mean, n_sel, state["round"])
        metrics["local_grad_evals"] = float(grad_evals)
        if n_scr is not None:
            metrics["screened"] = n_scr
        return new_state, metrics


def zeros_stacked(x, m: int):
    """(m, ...) zeros for every leaf of `x` (per-client duals, variates)."""
    return {k: v.new_zeros((m,) + tuple(v.shape)) for k, v in x.items()}


def lr_schedule(a: float, k, device=None) -> torch.Tensor:
    """gamma_k(a) = a / log2(k + 2) as a 0-d float32 tensor; `k` is an int
    (made on `device`) or a 0-d integer tensor."""
    if torch.is_tensor(k):
        kf = k.to(torch.float32)
    else:
        kf = torch.full((), float(k), dtype=torch.float32, device=device)
    return torch.full_like(kf, a) / torch.log2(kf + 2.0)


def flat_value_and_grad(vg_stacked, spec):
    """Route a stacked value-and-grad through the flat (m, N) view: each
    gradient evaluation unravels the buffer, evaluates, and ravels the
    gradients back (the only dict boundary of the local loops)."""

    def fvg(x_flat, batch):
        losses, grads = vg_stacked(spec.unravel_stacked(x_flat), batch)
        return losses, spec.ravel_stacked(grads)

    return fvg


def participation_vec(losses: torch.Tensor, mask=None) -> torch.Tensor:
    """The (m,) `selected`-metric indicator: 1 for participants, 0 for
    masked-out clients."""
    ones = torch.ones_like(losses)
    return ones if mask is None else torch.where(mask, ones, 0.0)


def compress_contrib(compressor, state, contrib, spec, mask=None):
    """The baselines' codec hook: the (m, N) contribution through
    `compressor` just before eq. (11). Returns ``(decoded, ef')``;
    ``(contrib, None)`` uncompressed. The residual comes from and
    advances ``state["ef"]``; the stochastic key is the round's key
    folded with the round counter (`api.codec_key`), which does not
    advance the key. With ``mask``, frozen clients keep their
    residual."""
    if compressor is None:
        return contrib, None
    ef = state.get("ef") if compressor.error_feedback else None
    key = (api.codec_key(state, contrib.device) if compressor.stochastic
           else None)
    return api.compress_upload(compressor, contrib, ef, spec, key=key,
                               mask=mask)


def compress_contrib_active(compressor, state, contrib_tile, spec, active):
    """Active-store twin of `compress_contrib` on the packed tile
    (`api.compress_upload_active`): ``ef'`` is the whole resident
    residual, non-participant rows untouched."""
    if compressor is None:
        return contrib_tile, None
    ef = state.get("ef") if compressor.error_feedback else None
    key = (api.codec_key(state, contrib_tile.device)
           if compressor.stochastic else None)
    return api.compress_upload_active(compressor, contrib_tile, ef, active,
                                      spec, key=key)


def round_metrics_flat(gsq, f_mean, n_sel, round_idx):
    """The round's metrics from the outputs of `api.flat_round_aggregate`:
    f and |grad|^2 are all-client diagnostics whatever the participation,
    `selected` the participant count, `cr` two communications a round."""
    return {
        "f_xbar": f_mean,
        "grad_sq_norm": gsq,
        "selected": n_sel,
        "cr": 2.0 * (round_idx + 1),
    }
