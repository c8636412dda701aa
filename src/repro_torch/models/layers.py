"""Shared NN building blocks: norms, initializers, rotary embeddings, and
the module that holds a parameter tree.

Counterpart of `repro/models/layers.py`. Initializers draw from an
explicit `torch.Generator` on the parameters' device; on the `meta`
device (generator None) they only shape the tensors.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def _normal(gen, shape, device):
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device)


def he_init(gen, shape, fan_in=None, dtype=torch.float32, device=None):
    fan_in = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    return (_normal(gen, shape, device) * scale).to(dtype)


def embed_init(gen, shape, dtype=torch.float32, device=None):
    return (_normal(gen, shape, device) * 0.02).to(dtype)


class ParamTree(nn.Module):
    """A nested dict of tensors as a module: each leaf becomes a frozen
    parameter under its key, each dict a child module, each list an
    `nn.ModuleList`, so `named_parameters()` gives the dict's key paths
    ("groups.dense.0.attn.wq"). `tree["key"]` reads like the dict."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            elif isinstance(v, list):
                self.add_module(k, nn.ModuleList(ParamTree(x) for x in v))
            else:
                self.register_parameter(
                    k, nn.Parameter(v, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)


# ----------------------------------------------------------------- RMSNorm
def rmsnorm_init(d: int, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


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
