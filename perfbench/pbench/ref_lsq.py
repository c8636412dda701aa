"""Plain least squares (paper Example V.1), the reference's loss:
f_i(x) = 1/(2 d_i) Σ_j mask_ij (a_ij·x − b_ij)², with its gradient
A_iᵀ(mask_i ∘ (A_i x − b_i)) / d_i and its curvature bound
r = max_i ‖A_i‖₂² / d_i (the largest eigenvalue of A_i A_iᵀ over d_i).
It imports nothing of the port.

`precision`: "fp64" (the reference), or "tf32" (the control: every
product's operands rounded to TF32's 10-bit mantissa, sums in float32).
`half=True` is the planted fault "half the batch left out": each client's
loss and gradient over the first half of its rows (rounded up), the mean
over those."""
from __future__ import annotations

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 `x` to TF32 (10 mantissa bits), to nearest even."""
    bits = x.float().contiguous().view(torch.int32)
    low = bits & 0x1FFF
    keep = bits - low
    up = (low > 0x1000) | ((low == 0x1000) & ((bits & 0x2000) != 0))
    return torch.where(up, keep + 0x2000, keep).view(torch.float32)


def setup(batch: dict, precision: str = "fp64", half: bool = False):
    """(grad_fn for `ref_fedgia.rounds`, r) on the client batch
    {"A": (m, rows, n), "b": (m, rows), "mask": (m, rows)}."""
    dt = torch.float64 if precision == "fp64" else torch.float32
    rnd = tf32 if precision == "tf32" else (lambda t: t)
    A, b, mask = (batch[k].to(dt) for k in ("A", "b", "mask"))
    if half:
        keep = torch.ceil(mask.sum(1, keepdim=True) / 2)
        mask = mask * (torch.arange(mask.shape[1], device=mask.device)
                       < keep).to(dt)
    d = torch.clamp_min(mask.sum(1), 1.0)
    Ar = rnd(A)

    def grad_fn(xbar):
        x = rnd(xbar["x"].to(dt))
        res = (torch.einsum("mrn,n->mr", Ar, x) - b) * mask
        losses = 0.5 * res.square().sum(1) / d
        g = torch.einsum("mrn,mr->mn", Ar, rnd(res)) / d[:, None]
        return losses, {"x": g}

    Am = Ar * mask[..., None]
    gram = Am @ Am.transpose(1, 2)
    r = (torch.linalg.eigvalsh(gram)[:, -1] / d).max()
    return grad_fn, float(r)
