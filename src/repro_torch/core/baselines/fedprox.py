"""FedProx [Li et al. 2020], per paper §V.D: each client descends the
proximal objective  f_i(x) + (mu/2)||x − x̄||²  with GD, k0 steps between
aggregations and `inner_steps` GD iterations a step.

Counterpart of `repro/core/baselines/fedprox.py`: the dense round and the
active-set round on the flat buffers, and the per-leaf round.
"""
from __future__ import annotations

from repro_torch.core import api
from repro_torch.utils import pytree as pt
from repro_torch.core.baselines.common import (
    FlatBaseline,
    flat_value_and_grad,
    lr_schedule,
    participation_vec,
)


class FedProx(FlatBaseline):
    name = "fedprox"

    def _local(self, state, batch, spec, xc):
        """k0 steps of `inner_steps` proximal GD iterations from and
        toward the clients' rows `xc`. Returns the final rows and the
        first iteration's losses and gradients."""
        fed = self.fed
        fvg = flat_value_and_grad(self._vg_stacked, spec)
        x = xc
        for j in range(fed.k0):
            lr = lr_schedule(fed.lr, state["step"] + j, x.device)
            for t in range(fed.inner_steps):
                losses, grads = fvg(x, batch)
                if j == 0 and t == 0:
                    losses0, grads0 = losses, grads
                g = grads + fed.prox_mu * (x - xc)
                x = x - lr * g.to(x.dtype)
        return x, losses0, grads0

    def round_flat(self, state, batch, spec, mask=None, stale=None, compressor=None, donate_kernel=False,
                   faults=None, screening=None):
        """One round on the flat state: k0 steps of `inner_steps` proximal
        GD iterations toward the broadcast x̄, then eq. (11) and the
        diagnostics (see `FedAvg.round_flat`). The metrics read the first
        iteration's losses and gradients. In an async round (`stale`) a
        straggler starts from, and proxes toward, its stale anchor."""
        xc = self._anchors(state, self.fed.num_clients, mask, stale)
        x, losses0, grads0 = self._local(state, batch, spec, xc)
        x, mask, updates, n_scr = self.upload(state, x, spec, mask,
                                              compressor, faults, screening)
        agg = api.flat_round_aggregate(
            x, grads0, losses0, participation_vec(losses0, mask), spec,
            mask=mask, weights=api.stale_weights(stale))
        return self._result(state, agg,
                            self.fed.k0 * self.fed.inner_steps, n_scr,
                            **updates)

    def round_flat_active(self, state, batch, spec, active, stale=None, compressor=None,
                          donate_kernel=False, faults=None,
                          screening=None):
        """`round_flat` on the packed participant tile (store="active"):
        the proximal trajectories exist only for the gathered clients.
        See `FedAvg.round_flat_active`."""
        xc = self._anchors(state, active.capacity, stale=stale,
                           active=active)
        x, losses0, grads0 = self._local(state, active.gather_tree(batch),
                                         spec, xc)
        x, active, updates, n_scr = self.upload_active(
            state, x, spec, active, compressor, faults, screening)
        agg = api.flat_round_aggregate_active(
            x, grads0, losses0, active, spec,
            weights=api.stale_weights(stale))
        return self._result(state, agg,
                            self.fed.k0 * self.fed.inner_steps, n_scr,
                            **updates)

    def round(self, state, batch, mask=None, stale=None):
        """`round_flat` on the state's dicts (`run_rounds(flat=False)`):
        the proximal GD iterations leaf by leaf, then eq. (11) and the
        metrics (`tree_result`)."""
        fed = self.fed
        xc = self._anchors(state, fed.num_clients, mask, stale)
        x = xc
        for j in range(fed.k0):
            lr = lr_schedule(fed.lr, state["step"] + j, self._device(state))
            for t in range(fed.inner_steps):
                losses, grads = self._vg_stacked(x, batch)
                if j == 0 and t == 0:
                    losses0, grads0 = losses, grads
                g = pt.tree_map(lambda gg, p, a: gg + fed.prox_mu * (p - a),
                                grads, x, xc)
                x = pt.tree_map(lambda p, gg: p - lr * gg.to(p.dtype), x, g)
        return self.tree_result(state, x, losses0, grads0, mask, stale,
                                fed.k0 * fed.inner_steps)
