"""Shared NN building blocks: norms and rotary embeddings.

Counterpart of `repro/models/layers.py`; its initializers are drawn on
the reference's threefry stream in `models/transformer.py`.
"""
from __future__ import annotations

import torch


# ----------------------------------------------------------------- RMSNorm
def rmsnorm(params, x, eps: float = 1e-5):
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def rmsnorm_nohead(x, eps: float = 1e-5):
    """Scale-free RMS norm (used for per-head RWKV group norm)."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype)


# -------------------------------------------------------------------- RoPE
def rope_freqs(head_dim: int, theta: float, device=None):
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # (head_dim//2,)


def apply_rope(x, positions, theta: float):
    """x: (..., S, H, hd); positions: broadcastable to (..., S). Split
    halves (x1 | x2), not interleaved pairs."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)
    angles = positions[..., None].float() * freqs  # (..., S, hd//2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd//2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)
