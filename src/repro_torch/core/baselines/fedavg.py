"""FedAvg [McMahan et al. 2017], the paper's §V.D non-stochastic version:
every client runs k0 full-batch GD steps between aggregations.

Counterpart of `repro/core/baselines/fedavg.py`: the dense round and the
active-set round on the flat buffers, and the per-leaf round. Per round, k0 gradient evaluations per
client (FedGiA's: one), the computational comparison of paper Table I.
No hand-written kernel: the local steps are the gradients' batched
products (cuBLAS) and elementwise updates, as the reference's plain XLA
ops.
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


class FedAvg(FlatBaseline):
    name = "fedavg"

    def _local(self, state, batch, spec, x):
        """k0 GD steps from the clients' rows `x`. Returns the final rows
        and the first step's losses and gradients (at x̄)."""
        fvg = flat_value_and_grad(self._vg_stacked, spec)
        for j in range(self.fed.k0):
            losses, grads = fvg(x, batch)
            if j == 0:
                losses0, grads0 = losses, grads
            lr = lr_schedule(self.fed.lr, state["step"] + j, x.device)
            x = x - lr * grads.to(x.dtype)
        return x, losses0, grads0

    def round_flat(self, state, batch, spec, mask=None, stale=None, compressor=None, donate_kernel=False,
                   faults=None, screening=None):
        """One round on the flat state (`state["x"]` an (N,) buffer): k0 GD
        steps from the broadcast x̄ on the (m, N) trajectory buffer, then
        eq. (11) and the diagnostics in `api.flat_round_aggregate`. The
        metrics read the first step's losses and gradients (at x̄).
        With `stale` (async rounds) the steps start from each client's
        stale anchor and eq. (11) takes the staleness weights; `stale`
        advances in place. The trajectories go up through `upload` (codec,
        faults, screening). `donate_kernel` is accepted for uniformity and
        ignored."""
        xc = self._anchors(state, self.fed.num_clients, mask, stale)
        x, losses0, grads0 = self._local(state, batch, spec, xc)
        x, mask, updates, n_scr = self.upload(state, x, spec, mask,
                                              compressor, faults, screening)
        agg = api.flat_round_aggregate(
            x, grads0, losses0, participation_vec(losses0, mask), spec,
            mask=mask, weights=api.stale_weights(stale))
        return self._result(state, agg, self.fed.k0, n_scr, **updates)

    def round_flat_active(self, state, batch, spec, active, stale=None, compressor=None,
                          donate_kernel=False, faults=None,
                          screening=None):
        """`round_flat` on the packed participant tile (store="active"):
        the k0 trajectories exist only for the (capacity,) gathered
        clients. FedAvg has no per-client state, so nothing is scattered
        back. The state is bitwise the dense masked round's; the loss and
        gradient diagnostics are participant means."""
        xc = self._anchors(state, active.capacity, stale=stale,
                           active=active)
        x, losses0, grads0 = self._local(state, active.gather_tree(batch),
                                         spec, xc)
        x, active, updates, n_scr = self.upload_active(
            state, x, spec, active, compressor, faults, screening)
        agg = api.flat_round_aggregate_active(
            x, grads0, losses0, active, spec,
            weights=api.stale_weights(stale))
        return self._result(state, agg, self.fed.k0, n_scr, **updates)

    def round(self, state, batch, mask=None, stale=None):
        """`round_flat` on the state's dicts (`run_rounds(flat=False)`):
        the k0 GD steps leaf by leaf, then eq. (11) and the metrics
        (`tree_result`)."""
        fed = self.fed
        x = self._anchors(state, fed.num_clients, mask, stale)
        for j in range(fed.k0):
            losses, grads = self._vg_stacked(x, batch)
            if j == 0:
                losses0, grads0 = losses, grads
            lr = lr_schedule(fed.lr, state["step"] + j, self._device(state))
            x = pt.tree_map(lambda p, g: p - lr * g.to(p.dtype), x, grads)
        return self.tree_result(state, x, losses0, grads0, mask, stale,
                                fed.k0)
