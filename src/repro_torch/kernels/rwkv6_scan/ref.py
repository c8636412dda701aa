"""Plain version of the RWKV-6 scan kernel: the per-step recurrence from a
zero state, in the kernel's layout, in the form of the reference's oracle
(`repro/models/rwkv.py::wkv6_scan`, reached through
`repro/kernels/rwkv6_scan/ref.py`):

  y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ

The wrapper runs it for CPU tensors; `chip_smoke.py` holds the CUDA
kernel to it on the card."""
from __future__ import annotations

import torch


def rwkv6_scan_ref(r, k, v, w, u):
    """r,k,v,w: (B,H,T,hd); u: (H,hd). Returns (y (B,H,T,hd) in r's dtype,
    final state (B,H,hd,hd) float32, laid out [key, value])."""
    B, H, T, hd = r.shape
    S = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    u = u.float()[..., None]  # (H, hd, 1)
    ys = []
    for t in range(T):
        rt, kt, vt, wt = (a[:, :, t].float() for a in (r, k, v, w))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhj,bhji->bhi", rt, S + u * kv))
        S = wt[..., None] * S + kv
    y = torch.stack(ys, dim=2) if ys else torch.zeros_like(r, dtype=torch.float32)
    return y.to(r.dtype), S
