"""Plain FedGiA (arXiv:2205.01438, Algorithm 1), the reference the port's
rounds are held to. It imports nothing of the port.

One round on client-stacked leaves (z, π and, under diag_ema, h: (m,
*leaf)):
  x̄ = (1/m) Σ z_i                                   eq. (11)
  ḡ_i = (1/m) ∇f_i(x̄)
  selected i, k0 times: x = x̄ − D⁻¹(ḡ_i + π), π ← σ(x − x̄) + π,
    then z_i = x + π/σ                              eqs. (12)-(14)
  the others: π_i = −ḡ_i, z_i = x̄ − ḡ_i/σ            eqs. (15)-(17)
with D = H_i/m + σ I, H_i = r I (scalar) or the clipped EMA of the squared
gradients (diag_ema, Remark IV.1), refreshed after the update from the
round's ḡ: h ← clip(β h + (1 − β) r (mḡ)² / max (mḡ)², 0, r), β = 0.9.
σ = σ_t r / m. The reported f is the clients' mean loss at x̄ and ‖g‖² the
squared norm of the mean gradient there.
"""
from __future__ import annotations

import torch

EMA_BETA = 0.9


def _norms(tree):
    """{leaf: (m,) float64 row norms} of client-stacked leaves."""
    return {k: torch.linalg.vector_norm(v.flatten(1), dim=1,
                                        dtype=torch.float64).cpu()
            for k, v in tree.items()}


def rounds(grad_fn, x0: dict, m: int, masks, *, sigma_t: float, r, k0: int,
           h_policy: str, dtype=torch.float64):
    """Three (len(masks)) rounds from x_i⁰ = z_i⁰ = x0, π⁰ = 0, h⁰ = r.

    `grad_fn(xbar)` -> (losses (m,), {leaf: (m, *leaf) gradients}) at the
    dict x̄; `masks`: one (m,) bool tensor a round (True: ADMM branch).
    Returns the readings the harness compares: per round f and ‖g‖²;
    after the first round the row norms of ḡ a leaf ("gbar"); after the
    last the norm a leaf of x̄ⁿ⁺¹ − x⁰ ("step", x̄ⁿ⁺¹ the mean of the
    final z), and r."""
    r = torch.as_tensor(r, dtype=dtype)
    sigma = sigma_t * r / m
    x0 = {k: v.to(dtype) for k, v in x0.items()}
    z = {k: v.expand((m,) + v.shape).clone() for k, v in x0.items()}
    pi = {k: torch.zeros_like(v) for k, v in z.items()}
    h = ({k: torch.full_like(v, float(r)) for k, v in z.items()}
         if h_policy == "diag_ema" else None)
    out = {"f": [], "gsq": [], "r": float(r)}
    for t, mask in enumerate(masks):
        xbar = {k: v.mean(0) for k, v in z.items()}
        losses, grads = grad_fn(xbar)
        out["f"].append(float(losses.double().mean()))
        out["gsq"].append(float(sum(
            torch.sum(g.to(torch.float64).mean(0) ** 2)
            for g in grads.values())))
        gbar = {k: (g.to(dtype) / m) for k, g in grads.items()}
        del grads
        if t == 0:
            out["gbar"] = _norms(gbar)
        if h is not None:
            g2max = max(float((g * m).square().max()) for g in gbar.values())
            g2max = max(g2max, 1e-30)
        for k in z:
            sel = mask.reshape((m,) + (1,) * (z[k].dim() - 1)).to(
                z[k].device)
            D = (h[k] / m + sigma) if h is not None else (r / m + sigma)
            p = pi[k]
            for _ in range(k0):
                x = xbar[k] - (gbar[k] + p) / D
                p = sigma * (x - xbar[k]) + p
            za = x + p / sigma
            zg = xbar[k] - gbar[k] / sigma
            pi[k] = torch.where(sel, p, -gbar[k])
            z[k] = torch.where(sel, za, zg)
            del x, p, za, zg
            if h is not None:
                g2 = (gbar[k] * m).square_()
                h[k] = torch.clamp(EMA_BETA * h[k] + (1 - EMA_BETA) * r * g2
                                   / g2max, min=0.0, max=float(r))
            gbar[k] = None
    out["step"] = {k: float(torch.linalg.vector_norm(
        v.mean(0) - x0[k], dtype=torch.float64)) for k, v in z.items()}
    return out
