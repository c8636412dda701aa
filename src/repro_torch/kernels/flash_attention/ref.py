"""Plain version of the flash attention kernel: the full softmax over the
materialised (S, T) scores, as `repro/kernels/flash_attention/ref.py`
computes it. The wrapper runs it for CPU tensors; `chip_smoke.py` holds
the CUDA kernel to it on the card."""
from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """q: (B,H,S,hd); k,v: (B,Kv,T,hd). Returns (B,H,S,hd) in q's dtype."""
    B, H, S, hd = q.shape
    Kv, T = k.shape[1], k.shape[2]
    G = H // Kv
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) / (hd ** 0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= qpos - kpos < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)
