"""FedGiA — the paper's Algorithm 1 on the flat client-state buffer.

Counterpart of `repro/core/fedgia.py`, single-device flat path, barrier
rounds (the overlapped round waits for the multi-device client axis);
its active-set round is the dense round on the round's mask. One round:

  1. aggregate   x̄ = (1/m) Σ z_i              (eq. 11)
  2. grads       ḡ_i = (1/m) ∇f_i(x̄)          (computed ONCE per round)
  3. split       C ~ alpha·m clients            (selection.py, or `mask=`)
  4. ADMM branch (i ∈ C):  k0 iterations of eqs (12)-(14)
     GD   branch (i ∉ C):  eqs (15)-(17), once
  5. state carries (z_i, π_i) per client; x_i = z_i − π_i/σ is derived.

With `collapsed=True` and a diagonal H (scalar or diag_ema) the k0-step
recursion runs in closed form as one fused pass: the CUDA `fedgia_update`
kernel on the card, its plain version on the CPU. Otherwise (gram H, or
`collapsed=False`) the paper-faithful k0-step loop runs in torch.

Uplink (`compressor=`, `faults=`, `screening=`): eq. (11) averages what
the server receives, the whole population's z through the codec
(`api.compress_upload`, with the error-feedback residual ``ef``) and
then the fault injection and screening (`api.harden_upload`, with the
replay buffer ``fault_prev``), over the rows that arrive finite.

Async rounds (`stale=`, an `api.StaleXbar`): eq. (11) takes the
staleness weights, and each client's gradient and branch run against its
own last-downloaded x̄, an (m, N) anchor that the kernel reads row by
row. Under `max_staleness == 0` the round is the synchronous masked one.

`round` is the per-leaf twin of `round_flat` (`run_rounds(flat=False)`,
`--no-flat`): the same steps on the state's dicts, leaf by leaf, with no
kernel. Its collapsed branch is the fused update's plain version
(`ref.fedgia_update_collapsed`) on each leaf, the arithmetic of the flat
round's update, and its means reduce each leaf as the flat buffer's
lanes, so on the CPU the two rounds agree bit for bit. `lagrangian` is
L(Zᵏ) of eq. (7), the quantity Lemma IV.1 says never increases.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.config import FedConfig
from repro_torch.core import api, hparams, prng, selection
from repro_torch.kernels.fedgia_update import fedgia_update_flat
from repro_torch.kernels.fedgia_update.ref import fedgia_update_collapsed
from repro_torch.utils import pytree as pt

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16, "float64": torch.float64}


class FedGiA:
    name = "fedgia"
    # the ADMM/GD split is drawn every round (`round_flat(mask=...)`)
    selects_in_round = True
    # model-shaped state the engine ravels into (m, N) / (N,) buffers
    # (gram_chol is client-stacked but not model-shaped); "ef" and
    # "fault_prev" are the engine's codec residual and replay buffer
    flat_client_keys = ("z", "pi", "h", "ef", "fault_prev")
    flat_global_keys = ("x",)
    # store="active": the GD branch rewrites every client every round
    active_tile = "population"

    def __init__(self, fed: FedConfig, loss_fn: api.LossFn, model=None):
        self.fed = fed
        self.loss_fn = loss_fn
        self.model = model
        self._vg = api.per_client_value_and_grad(loss_fn)
        self._vg_stacked = api.per_client_value_and_grad_stacked(loss_fn)

    # ------------------------------------------------------------------ init
    def init(self, params0: Dict[str, torch.Tensor], rng,
             init_batch=None) -> Dict[str, Any]:
        """Round-0 state. `rng` is the run's threefry key
        (`prng.prng_key(seed + 1)`, as the reference's CLI and runners
        pass it); every round splits it."""
        fed = self.fed
        m = fed.num_clients
        sdt = _DTYPES[fed.state_dtype]
        device = next(iter(params0.values())).device
        r = torch.tensor(fed.lipschitz, dtype=torch.float32, device=device)
        if fed.auto_lipschitz and init_batch is not None:
            # the reference vmaps the probe over (client batch, key of
            # split(rng, m)) and keeps the max, which a loop gives exactly
            keys = prng.split(np.asarray(rng, np.uint32), m)
            r = torch.stack([hparams.estimate_lipschitz(
                self.loss_fn, params0, {k: v[i] for k, v in init_batch.items()},
                keys[i]) for i in range(m)]).max()
        elif (self.model is not None and hasattr(self.model, "lipschitz")
                and init_batch is not None):
            r = self.model.lipschitz(init_batch).max().float()

        # paper §V.B: x_i^0 = pi_i^0 = 0; start from params0 instead (the
        # paper's setting is params0 = zeros). The client-stacked entries
        # are stride-0 views (m copies of x, of 0, of r) that take no
        # memory; `engine.flatten_state` copies them into the round's own
        # (m, N) buffers
        x = {k: v.to(sdt) for k, v in params0.items()}
        z = api.broadcast_clients(x, m)  # z = x + pi/sigma with pi = 0
        zero = torch.zeros((), dtype=sdt, device=device)
        sigma = hparams.sigma_from(fed.sigma_t, r, m).float()
        state: Dict[str, Any] = {
            "x": x,
            "z": z,
            "pi": {k: zero.expand(v.shape) for k, v in z.items()},
            "sigma": sigma,
            "r": r,
            "round": 0,
            "rng": np.array(rng, np.uint32),
        }
        if fed.h_policy == "diag_ema":
            state["h"] = {k: r.expand(v.shape) for k, v in z.items()}
        elif fed.h_policy == "gram":
            if self.model is None or not hasattr(self.model, "gram"):
                raise ValueError("gram H policy requires a model exposing "
                                 ".gram(batch) (linear models, Table III)")
            if init_batch is None:
                raise ValueError("gram H policy needs init_batch")
            H = self.model.gram(init_batch)  # (m, n, n)
            eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
            # upper factor, as the reference's jsl.cho_factor stores it
            state["gram_chol"] = torch.linalg.cholesky(H / m + sigma * eye,
                                                       upper=True)
        return state

    # ------------------------------------------------------------- internals
    def _apply_Dinv_flat(self, state, v, spec):
        """v -> (H/m + sigma I)^{-1} v on the (m, N) buffer."""
        m, sigma = self.fed.num_clients, state["sigma"]
        if self.fed.h_policy == "gram":
            n = spec.size  # gram is restricted to single-leaf linear models
            # cho_solve as its two triangular solves: on the card they are
            # cuBLAS's batched trsm, which a CUDA graph can capture, where
            # torch.cholesky_solve calls MAGMA, which a capture refuses
            # (on the CPU both are LAPACK's trsm, bit for bit the same)
            u = state["gram_chol"]
            y = torch.linalg.solve_triangular(u.transpose(-1, -2),
                                              v[:, :n, None], upper=False)
            out = torch.linalg.solve_triangular(u, y, upper=True)[..., 0]
            pad = v.shape[1] - n
            return torch.nn.functional.pad(out, (0, pad)) if pad else out
        h = state.get("h")
        if h is None:  # scalar policy: H = r I
            return v / (state["r"] / m + sigma)
        return v / (h / m + sigma)

    def _admm_branch_unrolled(self, state, xbar_c, gbar, spec):
        """k0 iterations of eqs (12)-(14) for ALL clients (masked later)."""
        sigma = state["sigma"]
        pi_after = state["pi"]
        for _ in range(self.fed.k0 - 1):
            x = xbar_c - self._apply_Dinv_flat(state, gbar + pi_after, spec)
            pi_after = sigma * (x - xbar_c) + pi_after
        x_new = xbar_c - self._apply_Dinv_flat(state, gbar + pi_after, spec)
        pi_new = sigma * (x_new - xbar_c) + pi_after
        z_new = (1.0 / sigma) * pi_new + x_new
        return pi_new, z_new

    # ------------------------------------------------------------ flat round
    def upload(self, state, spec, stale=None, compressor=None, faults=None,
               screening=None):
        """Eq. (11) over what the server receives: the population's z
        through the codec, then the faults and screening, averaged over
        the rows that arrive finite (with the staleness weights). Returns
        (xbar, ef', fault_prev', n_screened), the last three None where
        their stage is off."""
        z_up, sc_mask = state["z"], None
        ef_new = fprev_new = n_scr = None
        if compressor is not None:
            ef = state.get("ef") if compressor.error_feedback else None
            key = (api.codec_key(state, z_up.device) if compressor.stochastic
                   else None)
            z_up, ef_new = api.compress_upload(compressor, z_up, ef, spec,
                                               key=key)
        if faults is not None or screening is not None:
            z_up, sc_mask, fprev_new, n_scr = api.harden_upload(
                z_up, None, spec, faults=faults, screening=screening,
                fault_prev=state.get("fault_prev"),
                round_idx=state["round"])
        xbar = api.client_mean(z_up, mask=sc_mask,
                               weights=api.stale_weights(stale))
        return xbar, ef_new, fprev_new, n_scr

    def round_inputs(self, state, batch, spec, mask=None, stale=None,
                     xbar=None):
        """Steps (1)-(3) of a round on the flat `state`: x̄ (eq. 11; given
        as `xbar` where `upload` made it), the (m,) branch select, and the
        per-client losses, the `grad_sq_norm` metric and ḡ. `mask=None`
        draws the select from `state["rng"]` and the round index
        (`selection.round_split`). Returns (xbar, sel, losses,
        grad_sq_norm, gbar).

        A model with a `dtype` (the transformer) takes its gradients at
        x̄ cast to it, and ḡ_i = (1/m)∇f_i is scaled in that dtype, then
        cast to the state's, as the reference orders it. The raveled
        gradients and ḡ share one (m, N) buffer: the metric is read off
        the first before ḡ is written over it.

        With `stale` (async rounds; `mask` is then the arrival mask) x̄
        is the staleness-weighted mean and the stale state advances in
        place (`api.stale_xbar_view`). The gradients are taken at the
        round's anchor, `api.stale_anchor(stale, xbar)`: x̄ itself without
        `stale` or under `stale.always_fresh`, else the (m, N) per-client
        view."""
        m = self.fed.num_clients
        if xbar is None:  # (1) eq. (11)
            xbar = api.client_mean(state["z"],
                                   weights=api.stale_weights(stale))
        if mask is None:  # (3) client selection
            if stale is not None:
                raise ValueError("stale-x̄ rounds need the engine's "
                                 "arrival mask")
            _, mask = selection.round_split(state["rng"], state["round"], m,
                                            self.fed.alpha)
            mask = mask.to(xbar.device)
        # (2) per-client gradient: the one boundary that unravels
        if stale is not None:
            api.stale_xbar_view(stale, xbar, mask)
        anchor = api.stale_anchor(stale, xbar)
        dtype = getattr(self.model, "dtype", None)
        cast = ((lambda t: {k: v.to(dtype) for k, v in t.items()})
                if isinstance(dtype, torch.dtype) else (lambda t: t))
        if anchor is xbar:
            losses, grads = self._vg(cast(spec.unravel(xbar)), batch)
        else:
            losses, grads = self._vg_stacked(
                cast(spec.unravel_stacked(anchor)), batch)
        buf = spec.ravel_stacked(grads)
        gsq = api.flat_grad_sq_norm(buf, spec)
        sdt = _DTYPES[self.fed.state_dtype]
        gbar = spec.ravel_stacked(grads, out=buf,
                                  leaf_fn=lambda g: (g * (1.0 / m)).to(sdt))
        return xbar, mask, losses, gsq, gbar

    def kernel_args(self, state, xbar, gbar, sel):
        """The fused update's arguments, as `round_flat` passes them to
        `fedgia_update_flat`: (xbar, gbar, pi, h, sel, sigma, m, k0). The
        kernel reads an (N,) x̄ for every client row (an async round's
        (m, N) anchor row by row) and, under the scalar policy, the 0-d
        h = r once, so neither is copied to (m, N)."""
        h = state.get("h")
        if h is None:  # scalar policy: H = r I
            h = state["r"].to(gbar.dtype)
        return (xbar, gbar, state["pi"], h, sel, state["sigma"],
                self.fed.num_clients, self.fed.k0)

    def round_flat(self, state, batch, spec, mask=None, stale=None,
                   compressor=None, donate_kernel: bool = False,
                   faults=None, screening=None):
        """One communication round on the FLAT client-state buffer:
        `state["z"]`, `state["pi"]`, `state["h"]` are (m, N) buffers and
        `state["x"]` is (N,) (`engine.flatten_state`). Returns
        (new_state, metrics).

        `mask` is the (m,) ADMM/GD branch split; None draws it from
        `state["rng"]` (`selection.round_split`). The state's key splits
        every round, with a mask or without, as the reference's does; a
        state without one (the chunked driver's, which keeps the key on
        the host) needs the mask. With `stale` (an
        `api.StaleXbar`, async rounds) `mask` is the arrival mask and the
        branches run against each client's anchor (`round_inputs`); the
        stale state advances in place.

        `compressor`, `faults`, `screening`: the uplink stages of
        `upload`; the new state carries the advanced ``ef`` and
        ``fault_prev``, and the metrics gain ``screened`` (the rows that
        arrived finite) where faults or screening are on. The codec's key
        is the round's key before its split (`api.codec_key`).

        `donate_kernel=True` runs the in-place kernel: π' is written into
        the buffer of `state["pi"]` and z' into this round's own ḡ, so
        the caller must treat the input state's `pi` as consumed. Under
        diag_ema the H refresh reads ḡ after the update, as the reference
        orders it, so ḡ is not donated there and the undonated kernel
        runs: it writes z' into the buffer of `state["z"]` (read only by
        eq. (11), before it), and the H refresh writes `state["h"]` in
        place, so the caller must treat the input state's `z` and `h` as
        consumed. At a model's width this keeps the round within two
        (m, N) buffers of its state. The kernel never writes x' here, nor
        the anchor: x̄ is the new state's x. `fed.use_kernel=False` runs
        the kernel's plain version in its place, on any device.
        """
        fed = self.fed
        m = fed.num_clients
        sigma = state["sigma"]
        if stale is not None and mask is None:
            raise ValueError("stale-x̄ rounds need the engine's arrival mask")
        xbar, ef_new, fprev_new, n_scr = self.upload(
            state, spec, stale, compressor, faults, screening)
        rng = state.get("rng")
        if rng is not None:  # (3) the round's key chain, on the host
            rng, drawn = selection.round_split(rng, state["round"], m,
                                               fed.alpha, draw=mask is None)
            if mask is None:
                mask = drawn.to(state["z"].device)
        xbar, sel, losses, gsq, gbar = self.round_inputs(
            state, batch, spec, mask, stale, xbar=xbar)
        anchor = api.stale_anchor(stale, xbar)
        diag = fed.h_policy == "diag_ema"

        # (4) both branches + masked combine
        if fed.collapsed and fed.h_policy != "gram":
            *args, k0 = self.kernel_args(state, anchor, gbar, sel)
            # under diag_ema the H refresh reads ḡ after the update, so
            # the undonated kernel runs; with the state donated it writes
            # z' into the state's z, which nothing reads after eq. (11)
            _, pi_new, z_new = fedgia_update_flat(
                *args, k0=k0, donate=donate_kernel and not diag,
                want_x=False, use_kernel=fed.use_kernel,
                z_out=state["z"] if donate_kernel and diag else None)
        else:
            xbar_c = (api.broadcast_clients(xbar, m) if anchor is xbar
                      else anchor)  # stride-0 view, or the stale anchors
            pia, za = self._admm_branch_unrolled(state, xbar_c, gbar, spec)
            pig = gbar * -1.0  # eq. (16)
            zg = (-1.0 / sigma) * gbar + xbar_c  # eq. (17)
            pi_new = api.masked_update(sel, pia, pig)
            z_new = api.masked_update(sel, za, zg)

        new_state = dict(state)
        new_state.update(x=xbar, z=z_new, pi=pi_new, round=state["round"] + 1)
        if rng is not None:
            new_state["rng"] = rng
        if ef_new is not None:
            new_state["ef"] = ef_new
        if fprev_new is not None:
            new_state["fault_prev"] = fprev_new
        if diag:  # in place when the state is donated
            new_state["h"] = hparams.update_diag_h(
                state["h"], gbar, state["r"], m,
                out=state["h"] if donate_kernel else None)
        metrics = {
            "f_xbar": api.client_scalar_mean(losses),
            "grad_sq_norm": gsq,
            "selected": api.client_scalar_sum(sel),
            "cr": 2.0 * (state["round"] + 1),
            "local_grad_evals": 1.0,  # per client per round (C2)
        }
        if n_scr is not None:
            metrics["screened"] = n_scr
        return new_state, metrics

    def round_flat_active(self, state, batch, spec, active, stale=None,
                          compressor=None, donate_kernel: bool = False,
                          faults=None, screening=None):
        """Active-store round (``run_rounds(store="active" | "offload")``).
        FedGiA cannot shrink the round's working set: the GD branch (eqs.
        15-17) recomputes EVERY non-selected client's (z, π, h) from its
        fresh gradient each round, so every client is read and written
        whatever the draw (`active_tile = "population"`). The round is
        therefore the dense round on `active.mask`, bitwise by
        construction, with the same one `fedgia_update` launch; the codec
        and the faults run on all m rows, as the dense upload's."""
        return self.round_flat(state, batch, spec, mask=active.mask,
                               stale=stale, compressor=compressor,
                               donate_kernel=donate_kernel, faults=faults,
                               screening=screening)

    # ---------------------------------------------------------- pytree round
    def _apply_Dinv(self, state, v):
        """v -> (H/m + sigma I)^{-1} v on the client-stacked dict `v`,
        leaf by leaf (`_apply_Dinv_flat`'s steps)."""
        m, sigma = self.fed.num_clients, state["sigma"]
        if self.fed.h_policy == "gram":
            # single-leaf linear models; the two triangular solves, as the
            # flat form solves them
            u = state["gram_chol"]
            (k, leaf), = v.items()
            y = torch.linalg.solve_triangular(u.transpose(-1, -2),
                                              leaf[..., None], upper=False)
            return {k: torch.linalg.solve_triangular(u, y, upper=True)[..., 0]}
        h = state.get("h")
        if h is None:  # scalar policy: H = r I
            return pt.tree_map(lambda g: g / (state["r"] / m + sigma), v)
        return pt.tree_map(lambda g, hh: g / (hh / m + sigma), v, h)

    def _admm_branch(self, state, xbar_c, gbar, sel):
        """Both branches and the masked combine on the dicts: the ADMM
        branch (eqs. 12-14, k0 iterations) for the selected clients and
        the GD branch (eqs. 15-17) for the others. `xbar_c` holds the
        (m, ...) anchors (the stride-0 broadcast of x̄, or the stale
        ones). Returns (π', z')."""
        fed, m, sigma = self.fed, self.fed.num_clients, state["sigma"]
        if fed.collapsed and fed.h_policy != "gram":
            # the fused update's plain version on each leaf
            h = state.get("h")
            if h is None:  # scalar policy: the 0-d r for every leaf
                h = pt.tree_map(lambda g: state["r"].to(g.dtype), gbar)
            pick = lambda g: sel.reshape(  # noqa: E731
                sel.shape + (1,) * (g.dim() - 1))
            out = pt.tree_map(
                lambda x, g, p, hh: fedgia_update_collapsed(
                    x, g, p, hh, pick(g), sigma, float(1.0 / m),
                    k0=fed.k0)[1:],
                xbar_c, gbar, state["pi"], h)
            return (pt.tree_map(lambda t: t[0], out),
                    pt.tree_map(lambda t: t[1], out))
        pi_after = state["pi"]
        for _ in range(fed.k0 - 1):
            x = pt.tree_sub(xbar_c, self._apply_Dinv(
                state, pt.tree_add(gbar, pi_after)))
            pi_after = pt.tree_axpy(sigma, pt.tree_sub(x, xbar_c), pi_after)
        x_new = pt.tree_sub(xbar_c, self._apply_Dinv(
            state, pt.tree_add(gbar, pi_after)))
        pia = pt.tree_axpy(sigma, pt.tree_sub(x_new, xbar_c), pi_after)
        za = pt.tree_axpy(1.0 / sigma, pia, x_new)
        pig = pt.tree_scale(gbar, -1.0)  # eq. (16)
        zg = pt.tree_axpy(-1.0 / sigma, gbar, xbar_c)  # eq. (17)
        return api.masked_update(sel, pia, pig), api.masked_update(sel, za, zg)

    def round(self, state, batch, mask=None, stale=None):
        """One communication round on the state's dicts (Algorithm 1,
        steps (1)-(5)), leaf by leaf: the per-leaf twin of `round_flat`,
        which `run_rounds(flat=False)` runs. Returns (new_state,
        metrics), the metrics `round_flat`'s.

        `mask` is the ADMM/GD split; None draws it from `state["rng"]`
        and the round index, as `round_flat` draws it, so flat and
        per-leaf runs select the same clients every round. The key splits
        every round where the state holds one. With `stale` (async
        rounds; `mask` is then the arrival mask) eq. (11) takes the
        staleness weights and the gradients and branches run against each
        client's per-leaf anchor; the stale state advances in place. No
        kernel is launched."""
        fed = self.fed
        m = fed.num_clients
        if stale is not None and mask is None:
            raise ValueError("stale-x̄ rounds need the engine's arrival mask")
        # (1) eq. (11)
        xbar = api.client_mean(state["z"], weights=api.stale_weights(stale))
        device = pt.tree_leaves(xbar)[0].device
        # (3) client selection, the flat round's key chain
        rng = state.get("rng")
        if rng is not None:
            rng, drawn = selection.round_split(rng, state["round"], m,
                                               fed.alpha, draw=mask is None)
            if mask is None:
                mask = drawn.to(device)
        elif mask is None:
            raise ValueError("a state without a key needs the round's mask")
        # (2) per-client gradient at the round's anchor
        if stale is not None:
            api.stale_xbar_view(stale, xbar, mask)
        anchor = api.stale_anchor(stale, xbar)
        dtype = getattr(self.model, "dtype", None)
        cast = ((lambda t: pt.tree_cast(t, dtype))
                if isinstance(dtype, torch.dtype) else (lambda t: t))
        if anchor is xbar:
            losses, grads = self._vg(cast(xbar), batch)
        else:
            losses, grads = self._vg_stacked(cast(anchor), batch)
        sdt = _DTYPES[fed.state_dtype]
        # the metric over gradients in the state's dtype, as the flat
        # round's raveled buffer holds them
        gsq = pt.tree_sq_norm(api.client_mean(pt.tree_cast(grads, sdt)))
        gbar = pt.tree_map(lambda g: (g * (1.0 / m)).to(sdt), grads)
        del grads
        # (4) both branches, masked combine
        xbar_c = (api.broadcast_clients(xbar, m) if anchor is xbar
                  else anchor)  # stride-0 views, or the stale anchors
        pi_new, z_new = self._admm_branch(state, xbar_c, gbar, mask)

        new_state = dict(state)
        new_state.update(x=xbar, z=z_new, pi=pi_new, round=state["round"] + 1)
        if rng is not None:
            new_state["rng"] = rng
        if fed.h_policy == "diag_ema":
            new_state["h"] = hparams.update_diag_h(state["h"], gbar,
                                                   state["r"], m)
        metrics = {
            "f_xbar": api.client_scalar_mean(losses),
            "grad_sq_norm": gsq,
            "selected": api.client_scalar_sum(mask),
            "cr": 2.0 * (state["round"] + 1),
            "local_grad_evals": 1.0,  # per client per round (C2)
        }
        return new_state, metrics

    # ------------------------------------------------------------ diagnostics
    def client_params(self, state):
        """x_i = z_i − π_i/σ (derived; never stored), on a dict or flat
        state."""
        a = -1.0 / state["sigma"]
        return pt.tree_axpy(a, state["pi"], state["z"])

    def lagrangian(self, state, batch):
        """L(Zᵏ) of eq. (7) at a round boundary k = t·k0, on the dict
        state: (1/m) Σ f_i(x_i) + Σ <x_i − x̄, π_i> + (σ/2) Σ ||x_i − x̄||²,
        the monotone quantity of Lemma IV.1. The anchor is mean(z) (the
        next round's aggregation comes first; the lemma's e1 term accounts
        for its decrease), not the previous round's x̄."""
        m = self.fed.num_clients
        sigma = state["sigma"]
        xc = self.client_params(state)
        losses = self._vg_values(xc, batch)
        xbar_c = api.broadcast_clients(
            pt.tree_mean_over_axis(state["z"], axis=0), m)
        diff = pt.tree_sub(xc, xbar_c)
        inner = pt.tree_dot(diff, state["pi"])
        quad = 0.5 * sigma * pt.tree_sq_norm(diff)
        return torch.sum(losses) / m + inner + quad

    def _vg_values(self, xc_stacked, batch):
        """The (m,) losses f_i(x_i) at per-client parameters."""
        return torch.func.vmap(lambda p, b: self.loss_fn(p, b)[0])(
            xc_stacked, batch)
