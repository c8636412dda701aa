"""SCAFFOLD [Karimireddy et al. 2020]: controlled averaging with client
and server control variates (paper Table I comparison set).

Counterpart of `repro/core/baselines/scaffold.py`: the dense round and
the active-set round on the flat buffers, and the per-leaf round:
  local:   y ← y − lr_j (∇f_i(y) − c_i + c), k0 steps;
  control: c_i⁺ = c_i − c + (x̄ − y)/(k0·lr)   (option II);
  server:  x̄ = mean(y);  c += mean(c_i⁺ − c_i).
The client variates `ci` are one (m, N) buffer, the server's `c` one
(N,) vector, in the flat state.
"""
from __future__ import annotations

import torch

from repro_torch.core import api
from repro_torch.utils import pytree as pt
from repro_torch.core.baselines.common import (
    FlatBaseline,
    flat_value_and_grad,
    lr_schedule,
    participation_vec,
    zeros_stacked,
)


class Scaffold(FlatBaseline):
    name = "scaffold"
    flat_client_keys = ("ci", "ef", "fault_prev")
    flat_global_keys = ("x", "c")
    client_state_keys = ("ci", "ef", "fault_prev")
    # an overlapped round defers two means across the round boundary, the
    # server model's and the variates' delta: two rows of the slot
    overlap_slot_rows = 2

    def init(self, params0, rng, init_batch=None):
        state = super().init(params0, rng)
        state["c"] = {k: torch.zeros_like(v) for k, v in state["x"].items()}
        state["ci"] = zeros_stacked(state["x"], self.fed.num_clients)
        return state

    def _local(self, state, batch, spec, xc, ci, c=None):
        """k0 corrected GD steps of the clients' rows from `xc` with their
        variates `ci` and the server's `c` (default the state's), then the
        option-II control update with denom = k0 · lr_schedule(step).
        Returns the final rows, the new variates and the first step's
        losses and gradients."""
        fed = self.fed
        c = state["c"] if c is None else c
        fvg = flat_value_and_grad(self._vg_stacked, spec)
        lr = lr_schedule(fed.lr, state["step"], xc.device)
        y = xc
        for j in range(fed.k0):
            losses, grads = fvg(y, batch)
            if j == 0:
                losses0, grads0 = losses, grads
            lr_j = lr_schedule(fed.lr, state["step"] + j, y.device)
            y = y - lr_j * (grads + c[None] - ci).to(y.dtype)
        denom = fed.k0 * lr
        return y, ci - c[None] + (xc - y) / denom, losses0, grads0

    def round_flat(self, state, batch, spec, mask=None, stale=None, compressor=None, donate_kernel=False,
                   faults=None, screening=None):
        """One round on the flat state: the local steps and control update
        from the broadcast x̄ (`_local`), then eq. (11) over the
        trajectories with the variates' delta mean riding the same
        aggregate (`extra_mean`). Under `mask`, a masked-out client keeps
        its variate (a zero delta: c moves by |S|/m of the participants'
        mean) and is not aggregated. In an async round (`stale`) the
        steps start from, and the option-II control reads, each client's
        stale anchor. Metrics as `FedAvg.round_flat`.

        In an overlapped round the slot's two consensus rows are x̄ and
        the last round's variate delta mean, so the round's server variate
        is c + that delta (the barrier round's c); the state keeps it and
        x̄ (both lag a round) and eq. (11) reduces both means into the
        next slot (`overlap_finalize` folds the last one in)."""
        ci = state["ci"]
        x_used, cons, m_local = self.start(state)
        c_used = state["c"] if cons is None else state["c"] + cons[1]
        xc = self._anchors(state, m_local, mask, stale, x=x_used)
        y, ci_new, losses0, grads0 = self._local(state, batch, spec, xc, ci,
                                                 c_used)
        if mask is not None:
            ci_new = api.masked_update(mask, ci_new, ci)
        dmean = ci_new - ci
        y, mask, updates, n_scr = self.upload(state, y, spec, mask,
                                              compressor, faults, screening)
        if n_scr is not None:
            # a lost or rejected upload takes the client's variate delta
            # with it (the client still advanced its ci)
            dmean = torch.where(mask[:, None], dmean, 0.0)
        agg, dci, ovl = self.aggregate(state, x_used, y, grads0, losses0,
                                       spec, mask, stale, extra_mean=dmean)
        c_new = c_used if dci is None else state["c"] + dci
        return self._result(state, agg, self.fed.k0, n_scr, c=c_new,
                            ci=ci_new, **updates, **ovl)

    def overlap_finalize(self, state, slot):
        """The engine's hook closing an overlapped run: the last slot's
        row 0 is the final server model and row 1 the last round's
        variate delta mean, folded into c."""
        state["x"] = slot[0]
        state["c"] = state["c"] + slot[1]
        return state

    def round_flat_active(self, state, batch, spec, active, stale=None, compressor=None,
                          donate_kernel=False, faults=None,
                          screening=None):
        """`round_flat` on the packed participant tile (store="active"):
        the participants' variates are GATHERED from the resident (m, N)
        `ci`, advanced on the (capacity, N) tile and SCATTERED back in
        place (frozen rows untouched). The server variate keeps the
        all-client 1/m: frozen clients' deltas are exact zeros, so the
        tile's delta summed over m (`extra_mean_tile`) is the dense
        round's mean, bit for bit. An overlapped round takes x̄ and the
        server variate from the slot, as `round_flat`'s does."""
        x_used, cons, _ = self.start(state)
        c_used = state["c"] if cons is None else state["c"] + cons[1]
        xc = self._anchors(state, active.capacity, stale=stale,
                           active=active, x=x_used)
        ci_t = active.gather_state(state["ci"])
        y, ci_new_t, losses0, grads0 = self._local(
            state, active.gather_tree(batch), spec, xc, ci_t, c_used)
        ci = active.scatter_state(state["ci"], ci_new_t)
        # the screened ActiveSet's `valid` zeroes the screened rows out of
        # the variate rider too
        y, active, updates, n_scr = self.upload_active(
            state, y, spec, active, compressor, faults, screening)
        agg, dci, ovl = self.aggregate_active(
            state, x_used, y, grads0, losses0, spec, active, stale,
            extra_mean_tile=ci_new_t - ci_t)
        c_new = c_used if dci is None else state["c"] + dci
        return self._result(state, agg, self.fed.k0, n_scr, c=c_new, ci=ci,
                            **updates, **ovl)

    def round(self, state, batch, mask=None, stale=None):
        """`round_flat` on the state's dicts (`run_rounds(flat=False)`):
        the corrected steps and the option-II control update leaf by leaf,
        the frozen clients' variates kept, then eq. (11), the variates'
        delta mean into c, and the metrics (`tree_result`)."""
        fed = self.fed
        c, ci = state["c"], state["ci"]
        xc = self._anchors(state, api.local_client_count(fed.num_clients),
                           mask, stale)
        lr = lr_schedule(fed.lr, state["step"], self._device(state))
        y = xc
        for j in range(fed.k0):
            losses, grads = self._vg_stacked(y, batch)
            if j == 0:
                losses0, grads0 = losses, grads
            lr_j = lr_schedule(fed.lr, state["step"] + j, self._device(state))
            y = pt.tree_map(
                lambda p, g, cc, cci: p - lr_j * (g + cc[None] - cci).to(
                    p.dtype), y, grads, c, ci)
        denom = fed.k0 * lr
        ci_new = pt.tree_map(lambda cci, cc, a, yy: cci - cc[None]
                             + (a - yy) / denom, ci, c, xc, y)
        if mask is not None:
            ci_new = api.masked_update(mask, ci_new, ci)
        dci = api.client_mean(pt.tree_sub(ci_new, ci))
        return self.tree_result(state, y, losses0, grads0, mask, stale,
                                fed.k0, c=pt.tree_add(c, dci), ci=ci_new)
