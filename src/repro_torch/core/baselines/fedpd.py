"""FedPD [Zhang et al. 2021], oracle choice I / option I per paper §V.D:
primal-dual with inexact local solves.

Counterpart of `repro/core/baselines/fedpd.py`: the dense round and the
active-set round on the flat buffers, and the per-leaf round. Each local step, every client
approximately solves
    x_i ≈ argmin f_i(x) + <lam_i, x − x̄_i> + 1/(2 eta) ||x − x̄_i||²
with `inner_steps` GD iterations (lr = gamma_k), then
    lam_i += (x_i − x̄_i)/eta ;   x̄_i ← x_i + eta*lam_i.
Aggregation every k0 steps: x̄ = mean_i x̄_i. The duals `lam` are one
(m, N) buffer in the flat state.
"""
from __future__ import annotations

from repro_torch.core import api
from repro_torch.utils import pytree as pt
from repro_torch.core.baselines.common import (
    FlatBaseline,
    flat_value_and_grad,
    lr_schedule,
    participation_vec,
    zeros_stacked,
)


class FedPD(FlatBaseline):
    name = "fedpd"
    flat_client_keys = ("lam", "ef", "fault_prev")
    client_state_keys = ("lam", "ef", "fault_prev")

    def init(self, params0, rng, init_batch=None):
        state = super().init(params0, rng)
        state["lam"] = zeros_stacked(state["x"], self.fed.num_clients)
        return state

    def _local(self, state, batch, spec, anchor, lam):
        """k0 primal-dual steps of the clients' rows from their anchors
        and duals. Returns the final anchors and duals and the first
        inner iteration's losses and gradients."""
        fed = self.fed
        eta = fed.fedpd_eta
        fvg = flat_value_and_grad(self._vg_stacked, spec)
        for j in range(fed.k0):
            lr = lr_schedule(fed.lr, state["step"] + j, anchor.device)
            xi = anchor
            for t in range(fed.inner_steps):
                losses, grads = fvg(xi, batch)
                if j == 0 and t == 0:
                    losses0, grads0 = losses, grads
                g = grads + lam + (xi - anchor) / eta
                xi = xi - lr * g.to(xi.dtype)
            lam = lam + (xi - anchor) / eta
            anchor = xi + eta * lam
        return anchor, lam, losses0, grads0

    def round_flat(self, state, batch, spec, mask=None, stale=None, compressor=None, donate_kernel=False,
                   faults=None, screening=None):
        """One round on the flat state (`lam` an (m, N) buffer): k0
        primal-dual steps per client from the broadcast x̄, then eq. (11)
        over the clients' anchors. Under `mask`, a masked-out client keeps
        its duals and is not aggregated. In an async round (`stale`) each
        client's primal-dual anchor resets to its last-downloaded x̄, not
        the fresh one; in an overlapped round every anchor resets to the
        slot's consensus. The metrics read the first inner iteration of
        the first step (see `FedAvg.round_flat`)."""
        fed = self.fed
        x_used, _, m_local = self.start(state)
        xc = self._anchors(state, m_local, mask, stale, x=x_used)
        anchor, lam, losses0, grads0 = self._local(state, batch, spec, xc,
                                                   state["lam"])
        if mask is not None:
            lam = api.masked_update(mask, lam, state["lam"])
        # the faults and screening shrink the aggregation's mask only: a
        # client whose upload was lost still advanced its duals
        anchor, mask, updates, n_scr = self.upload(
            state, anchor, spec, mask, compressor, faults, screening)
        agg, _, ovl = self.aggregate(state, x_used, anchor, grads0, losses0,
                                     spec, mask, stale)
        return self._result(state, agg, fed.k0 * fed.inner_steps, n_scr,
                            lam=lam, **updates, **ovl)

    def round_flat_active(self, state, batch, spec, active, stale=None, compressor=None,
                          donate_kernel=False, faults=None,
                          screening=None):
        """`round_flat` on the packed participant tile (store="active"):
        the participants' duals are GATHERED from the resident (m, N)
        `lam`, advanced on the (capacity, N) tile and SCATTERED back in
        place; frozen clients' rows are never touched (the dense round's
        `masked_update`, row for row), and the padding rows' writes are
        dropped. An overlapped round resets the anchors to the slot's
        consensus and reduces into the next slot."""
        fed = self.fed
        x_used, _, _ = self.start(state)
        xc = self._anchors(state, active.capacity, stale=stale,
                           active=active, x=x_used)
        anchor, lam_t, losses0, grads0 = self._local(
            state, active.gather_tree(batch), spec, xc,
            active.gather_state(state["lam"]))
        lam = active.scatter_state(state["lam"], lam_t)
        anchor, active, updates, n_scr = self.upload_active(
            state, anchor, spec, active, compressor, faults, screening)
        agg, _, ovl = self.aggregate_active(state, x_used, anchor, grads0,
                                            losses0, spec, active, stale)
        return self._result(state, agg, fed.k0 * fed.inner_steps, n_scr,
                            lam=lam, **updates, **ovl)

    def round(self, state, batch, mask=None, stale=None):
        """`round_flat` on the state's dicts (`run_rounds(flat=False)`):
        the primal-dual steps leaf by leaf, the frozen clients' duals
        kept, then eq. (11) over the anchors and the metrics
        (`tree_result`)."""
        fed = self.fed
        eta = fed.fedpd_eta
        anchor = self._anchors(state, api.local_client_count(fed.num_clients),
                               mask, stale)
        lam = state["lam"]
        for j in range(fed.k0):
            lr = lr_schedule(fed.lr, state["step"] + j, self._device(state))
            xi = anchor
            for t in range(fed.inner_steps):
                losses, grads = self._vg_stacked(xi, batch)
                if j == 0 and t == 0:
                    losses0, grads0 = losses, grads
                g = pt.tree_map(lambda gg, x, ll, a: gg + ll + (x - a) / eta,
                                grads, xi, lam, anchor)
                xi = pt.tree_map(lambda p, d: p - lr * d.to(p.dtype), xi, g)
            lam = pt.tree_map(lambda ll, x, a: ll + (x - a) / eta, lam, xi,
                              anchor)
            anchor = pt.tree_map(lambda x, ll: x + eta * ll, xi, lam)
        if mask is not None:
            lam = api.masked_update(mask, lam, state["lam"])
        return self.tree_result(state, anchor, losses0, grads0, mask, stale,
                                fed.k0 * fed.inner_steps, lam=lam)
