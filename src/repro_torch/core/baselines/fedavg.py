"""FedAvg [McMahan et al. 2017], the paper's §V.D non-stochastic version:
every client runs k0 full-batch GD steps between aggregations.

Counterpart of `repro/core/baselines/fedavg.py`, flat dense path. Per
round, k0 gradient evaluations per client (FedGiA's: one), the
computational comparison of paper Table I. No hand-written kernel: the
local steps are the gradients' batched products (cuBLAS) and elementwise
updates, as the reference's plain XLA ops.
"""
from __future__ import annotations

from repro_torch.core import api
from repro_torch.core.baselines.common import (
    FlatBaseline,
    flat_value_and_grad,
    lr_schedule,
    participation_vec,
)


class FedAvg(FlatBaseline):
    name = "fedavg"

    def round_flat(self, state, batch, spec, mask=None, donate_kernel=False):
        """One round on the flat state (`state["x"]` an (N,) buffer): k0 GD
        steps from the broadcast x̄ on the (m, N) trajectory buffer, then
        eq. (11) and the diagnostics in `api.flat_round_aggregate`. The
        metrics read the first step's losses and gradients (at x̄).
        `donate_kernel` is accepted for uniformity and ignored."""
        fed = self.fed
        x = api.broadcast_clients(state["x"], fed.num_clients)
        fvg = flat_value_and_grad(self._vg_stacked, spec)
        for j in range(fed.k0):
            losses, grads = fvg(x, batch)
            if j == 0:
                losses0, grads0 = losses, grads
            lr = lr_schedule(fed.lr, state["step"] + j, x.device)
            x = x - lr * grads.to(x.dtype)
        agg = api.flat_round_aggregate(
            x, grads0, losses0, participation_vec(losses0, mask), spec,
            mask=mask)
        return self._result(state, agg, fed.k0)
