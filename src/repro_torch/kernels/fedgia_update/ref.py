"""Plain PyTorch versions of the fused FedGiA update.

`fedgia_update_ref` is the paper-faithful UNROLLED oracle, eqs (12)-(14)
iterated k0 times plus the GD branch (15)-(17) (counterpart of
`repro/kernels/fedgia_update/ref.py`). `fedgia_update_collapsed` is the
closed form that the CUDA kernel computes, with the kernel's operation
order: it multiplies h by the float32 1/m and divides π' by σ, as the
Pallas kernel does, and raises a to k0-1 by the same square-and-multiply
sequence as the kernel (and as JAX's `lax.integer_pow`). On the CPU the
wrappers in `ops.py` run it in place of the kernel; on the card it is
what the kernel is held against.
"""
from __future__ import annotations

import torch


def int_pow(a: torch.Tensor, k: int) -> torch.Tensor:
    """a**k for an integer k >= 0 by binary exponentiation, in the kernel's
    multiplication order (the first multiply is by 1, which is exact)."""
    acc = torch.ones_like(a)
    while k > 0:
        if k & 1:
            acc = acc * a
        k >>= 1
        if k > 0:
            a = a * a
    return acc


def fedgia_update_collapsed(xbar, gbar, pi, h, sel, sigma, inv_m, *, k0: int):
    """The kernel's closed form. Every operand broadcasts against the
    (…, N) ḡ, which gives the kernel's forms: an (N,) anchor `xbar` read
    for every row, a 0-d `h` (scalar H), and `sel` (bool). The results
    are those of the materialised (…, N) operands bit for bit: each
    element takes the same operations on the same values. `inv_m` is the
    float32 1/m as a Python float."""
    xbar32, g = xbar.float(), gbar.float()
    d = torch.reciprocal(h.float() * inv_m + sigma)
    a = 1.0 - sigma * d
    base = pi.float() + g
    ak1 = int_pow(a, k0 - 1)
    pi_admm = ak1 * a * base - g
    x_admm = xbar32 - d * ak1 * base
    x_new = torch.where(sel, x_admm, xbar32)
    pi_new = torch.where(sel, pi_admm, -g)
    z_new = x_new + pi_new / sigma
    dt = xbar.dtype
    return x_new.to(dt), pi_new.to(dt), z_new.to(dt)


def fedgia_update_ref(xbar, gbar, pi, h, sel, sigma, m, *, k0: int):
    """Same signature as the reference oracle; iterates the ADMM update
    k0 times."""
    xbar32, g = xbar.float(), gbar.float()
    pi_c = pi.float()
    d = 1.0 / (h.float() / m + sigma)
    for _ in range(k0):
        x = xbar32 - d * (g + pi_c)  # eq. (12)
        pi_c = pi_c + sigma * (x - xbar32)  # eq. (13)
    z_k = x + pi_c / sigma  # eq. (14)

    x_gd = xbar32  # eq. (15)
    pi_gd = -g  # eq. (16)
    z_gd = xbar32 - g / sigma  # eq. (17)

    dt = xbar.dtype
    return (torch.where(sel, x, x_gd).to(dt),
            torch.where(sel, pi_c, pi_gd).to(dt),
            torch.where(sel, z_k, z_gd).to(dt))
