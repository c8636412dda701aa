"""RWKV-6 ("Finch") block: time-mix with data-dependent decay + channel-mix.

Counterpart of `repro/models/rwkv.py`. Attention-free: the sequence mixer
is a linear recurrence over a per-head (head_dim x head_dim) fp32 state.
Prefill, which starts from a zero state, runs the scan kernel's wrapper
(`kernels/rwkv6_scan`). Train (from the zero state) and a decode step
(from the carried state) run `wkv6_scan`, the model's own plain
recurrence built from `wkv6_step`, as the reference trains and decodes
with its `lax.scan`: the TPU kernel takes no starting state, and the CUDA
kernel has no backward.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels import run_plain
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.models.layers import rmsnorm_nohead, silu

DECAY_LORA = 64


def _token_shift(x, shift_state):
    """x: (B,T,d); shift_state: (B,d) = last token of the previous chunk."""
    return torch.cat([shift_state[:, None, :], x[:, :-1, :]], dim=1)


def wkv6_step(r, k, v, w, u, S):
    """One step of the RWKV-6 recurrence. r,k,v,w: (B,H,hd); u: (H,hd);
    S: (B,H,hd,hd) [key_dim, value_dim].
      y = r . (S + diag(u) k v^T),   S' = diag(w) S + k v^T
    Returns (y (B,H,hd), S')."""
    kv = k[..., :, None] * v[..., None, :]
    y = torch.einsum("bhj,bhji->bhi", r, S + u[..., None] * kv)
    return y, w[..., None] * S + kv


def wkv6_scan(r, k, v, w, u, state0):
    """The recurrence from `state0`, step by step. r,k,v,w: (B,T,H,hd);
    u: (H,hd); state0: (B,H,hd,hd). Returns y (B,T,H,hd), final state."""
    S, ys = state0, []
    for t in range(r.shape[1]):
        y, S = wkv6_step(r[:, t], k[:, t], v[:, t], w[:, t], u, S)
        ys.append(y)
    return torch.stack(ys, dim=1), S


def time_mix_apply(params, cfg: ModelConfig, x, tm_state):
    """tm_state: {"shift": (B,d), "wkv": (B,H,hdk,hdv) or None}; None is a
    zero state, for which the scan kernel runs (prefill). Returns (out, new
    state)."""
    B, T, d = x.shape
    H, hd = cfg.num_heads, cfg.rwkv_head_size
    prev = _token_shift(x, tm_state["shift"])
    mu = params["mu"]
    xr, xk, xv, xw, xg = [x + mu[i] * (prev - x) for i in range(5)]
    r = (xr @ params["wr"]).reshape(B, T, H, hd)
    k = (xk @ params["wk"]).reshape(B, T, H, hd)
    v = (xv @ params["wv"]).reshape(B, T, H, hd)
    g = silu(xg @ params["wg"]).reshape(B, T, H, hd)
    # data-dependent decay (the Finch signature)
    decay = params["decay_bias"] + (
        (torch.tanh(xw) @ params["decay_w1"]) @ params["decay_w2"])
    w = torch.exp(-torch.exp(decay.float())).reshape(B, T, H, hd)

    r, k, v = r.float(), k.float(), v.float()
    u = params["bonus_u"].float()
    if tm_state["wkv"] is None:
        y, wkv_new = scan_ops.rwkv6_scan(
            r.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            w.transpose(1, 2), u)
        y = y.transpose(1, 2)
    else:
        y, wkv_new = run_plain("wkv6_scan", wkv6_scan, r, k, v, w, u,
                               tm_state["wkv"])
    y = rmsnorm_nohead(y, eps=1e-5).to(x.dtype)  # per-head group norm
    y = (y * g).reshape(B, T, H * hd)
    out = y @ params["wo"]
    return out, {"shift": x[:, -1, :], "wkv": wkv_new}


def channel_mix_apply(params, x, cm_shift):
    prev = _token_shift(x, cm_shift)
    xk = x + params["mu_k"] * (prev - x)
    xr = x + params["mu_r"] * (prev - x)
    k = torch.square(torch.relu(xk @ params["wk"]))
    kv = k @ params["wv"]
    out = torch.sigmoid(xr @ params["wr"]) * kv
    return out, x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device=None):
    H, hd = cfg.num_heads, cfg.rwkv_head_size
    return {
        "shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                             device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32,
                           device=device),
        "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
    }
