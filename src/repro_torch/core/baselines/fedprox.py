"""FedProx [Li et al. 2020], per paper §V.D: each client descends the
proximal objective  f_i(x) + (mu/2)||x − x̄||²  with GD, k0 steps between
aggregations and `inner_steps` GD iterations a step.

Counterpart of `repro/core/baselines/fedprox.py`, flat dense path.
"""
from __future__ import annotations

from repro_torch.core import api
from repro_torch.core.baselines.common import (
    FlatBaseline,
    flat_value_and_grad,
    lr_schedule,
    participation_vec,
)


class FedProx(FlatBaseline):
    name = "fedprox"

    def round_flat(self, state, batch, spec, mask=None, donate_kernel=False):
        """One round on the flat state: k0 steps of `inner_steps` proximal
        GD iterations toward the broadcast x̄, then eq. (11) and the
        diagnostics (see `FedAvg.round_flat`). The metrics read the first
        iteration's losses and gradients."""
        fed = self.fed
        xc = api.broadcast_clients(state["x"], fed.num_clients)
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
        agg = api.flat_round_aggregate(
            x, grads0, losses0, participation_vec(losses0, mask), spec,
            mask=mask)
        return self._result(state, agg, fed.k0 * fed.inner_steps)
