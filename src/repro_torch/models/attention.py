"""Attention: GQA (llama-style, optional QKV bias / sliding window) and MLA
(DeepSeek-V3 latent attention, absorbed decode path).

Counterpart of `repro/models/attention.py`. GQA's prefill attends over
the fresh K/V through the flash attention kernel's wrapper
(`kernels/flash_attention`). Train and decode attend with
`blocked_attention`, the model's own streaming softmax in plain PyTorch,
as the reference trains and decodes with it: the reference trains
through no kernel, and the CUDA kernel has no backward. MLA attends with
`blocked_attention` in every mode, as the reference does: its prefill
has q/k depth nope + rope = 192 and v depth 128, which neither the
Pallas kernel (one head_dim for q, k and v) nor its port takes.

The KV cache (MLA's: the compressed latent) is updated in place (the
reference returns a new one): the tensors of `cache` are written and the
same dict is returned, with no host value read, so a decode step can be
captured in a CUDA graph (`core/graphs.py::scan_steps`). The cache may
be float8 (the reference's `cache_dtype`): values are cast by the
reference's rule and read back block by block, upcast to float32.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models.layers import apply_rope, rmsnorm

NEG_INF = -1e30

# ml_dtypes (the reference's cast) makes a value that rounds past
# float8_e4m3fn's largest finite 448 NaN (the type has no inf), where
# torch's cast saturates at 448: magnitudes above 464, the midpoint to
# the next step, and ±inf, become NaN (bits 0x7F) here too. float8_e5m2
# casts the same way in both (to ±inf).
_NAN_ABOVE = {torch.float8_e4m3fn: 464.0}
_FP8_NAN_BITS = 0x7F


def _is_fp8(t) -> bool:
    return t.dtype in (torch.float8_e4m3fn, torch.float8_e5m2)


def _bits(t):
    """A float8 tensor as its uint8 bits (indexed writes and pads, which
    PyTorch does not offer for float8 on every device), else itself."""
    return t.view(torch.uint8) if _is_fp8(t) else t


def cast_to_cache(x, dtype):
    """x cast to the cache's dtype by the reference's rule (above)."""
    out = x.to(dtype)
    limit = _NAN_ABOVE.get(dtype)
    if limit is not None:
        over = ~(x.float().abs() <= limit)  # NaN-safe: inf, NaN are over
        out.view(torch.uint8).masked_fill_(over, _FP8_NAN_BITS)
    return out


def _pad_tokens(x, pad):
    """Zero-pad the token axis (dim 1) of a (B, T, Kv, d) tensor."""
    out = F.pad(_bits(x), (0, 0, 0, 0, 0, pad))
    return out.view(x.dtype) if _is_fp8(x) else out


@dataclasses.dataclass(frozen=True)
class AttnMode:
    kind: str = "train"  # train | prefill | decode
    window: Optional[int] = None  # sliding-window mask width (None = full)
    block_k: int = 512


# ============================================================ blocked softmax
def blocked_attention(q, k, v, q_positions, kv_positions, *, window=None,
                      block_k=512, scale=None):
    """Streaming-softmax attention.

    q: (B, S, H, dqk); k: (B, T, Kv, dqk); v: (B, T, Kv, dv)
    q_positions: (S,) absolute positions of queries
    kv_positions: (T,) absolute positions of keys (-1 = invalid slot)
    Causal: key visible iff 0 <= kv_pos <= q_pos (and q_pos - kv_pos < window).
    k and v may be float8 (a quantized cache): each block is upcast to
    float32 as it is read, as the reference reads it.
    Returns (B, S, H, dv).
    """
    B, S, H, dqk = q.shape
    T, Kv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    G = H // Kv
    scale = scale if scale is not None else 1.0 / (dqk ** 0.5)

    qr = q.reshape(B, S, Kv, G, dqk).permute(0, 2, 3, 1, 4)  # B,Kv,G,S,dqk
    qr = (qr * scale).to(q.dtype).float()

    block_k = min(block_k, T)
    nb = -(-T // block_k)
    pad = nb * block_k - T
    if pad:
        k = _pad_tokens(k, pad)
        v = _pad_tokens(v, pad)
        kv_positions = F.pad(kv_positions, (0, pad), value=-1)
    kb = k.reshape(B, nb, block_k, Kv, dqk).permute(1, 0, 3, 2, 4)  # nb,B,Kv,bk,d
    vb = v.reshape(B, nb, block_k, Kv, dv).permute(1, 0, 3, 2, 4)
    pb = kv_positions.reshape(nb, block_k)

    m = torch.full((B, Kv, G, S), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((B, Kv, G, S), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, Kv, G, S, dv), dtype=torch.float32, device=q.device)
    for i in range(nb):
        s = torch.einsum("bkgsd,bktd->bkgst", qr, kb[i].float())
        pos = pb[i][None, :]
        valid = (pos <= q_positions[:, None]) & (pos >= 0)
        if window is not None:
            valid &= q_positions[:, None] - pos < window
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgst,bktd->bkgsd", p, vb[i].float())
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H, dv)
    return out.to(q.dtype)


# ===================================================================== GQA
def init_gqa_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device=None):
    Kv, hd = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, cache_len, Kv, hd), dtype=dtype,
                         device=device),
        "v": torch.zeros((batch, cache_len, Kv, hd), dtype=dtype,
                         device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _write_entries(cache, new: dict, positions):
    """Ring-buffer write, in place: the entries of each `new[name]` (B, S,
    ...) land in `cache[name]` at position % W. positions: (S,), on the
    device (a decode step's comes from a 0-d tensor, so nothing here reads
    a host value). When S > W only the LAST W entries are written (unique
    slots, as in the reference's GQA write; its MLA write leaves S > W
    undefined). A float8 cache takes `cast_to_cache`'s values, written as
    bits."""
    W = cache["slot_pos"].shape[0]
    if positions.shape[0] > W:
        new = {k: v[:, -W:] for k, v in new.items()}
        positions = positions[-W:]
    idx = positions % W
    for name, t in new.items():
        buf = cache[name]
        _bits(buf)[:, idx] = _bits(cast_to_cache(t, buf.dtype))
    cache["slot_pos"][idx] = positions.to(torch.int32)
    cache["pos"].copy_(positions[-1] + 1)
    return cache


def _write_cache(cache, k_new, v_new, positions):
    """GQA's write (`_write_entries` of k and v)."""
    return _write_entries(cache, {"k": k_new, "v": v_new}, positions)


def gqa_apply(params, cfg: ModelConfig, x, positions, cache, mode: AttnMode):
    """x: (B,S,d); positions: (S,). Returns (out, cache).

    Prefill takes positions 0..S-1 (what `Transformer.prefill` gives it):
    the flash kernel masks by index. Train masks by the positions it is
    given, as the reference."""
    B, S, d = x.shape
    H, Kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, Kv, hd)
    v = v.reshape(B, S, Kv, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if mode.kind == "train":
        out = blocked_attention(q, k, v, positions, positions,
                                window=mode.window, block_k=mode.block_k)
    elif mode.kind == "prefill":
        # prefill attends over the FRESH K/V (window-masked), independent of
        # ring-buffer wrap-around; the cache write keeps only the last W.
        out = flash_ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=True, window=mode.window).transpose(1, 2)
        _write_cache(cache, k, v, positions)
    else:
        _write_cache(cache, k, v, positions)
        out = blocked_attention(
            q, cache["k"], cache["v"], positions, cache["slot_pos"],
            window=mode.window, block_k=mode.block_k)
    out = out.reshape(B, S, H * hd)
    return out @ params["wo"], cache


# ===================================================================== MLA
def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int, dtype,
                   device=None):
    """MLA caches the COMPRESSED latent (kv_lora + rope) — its memory win."""
    return {
        "ckv": torch.zeros((batch, cache_len, cfg.kv_lora_rank), dtype=dtype,
                           device=device),
        "krope": torch.zeros((batch, cache_len, cfg.qk_rope_dim),
                             dtype=dtype, device=device),
        "slot_pos": torch.full((cache_len,), -1, dtype=torch.int32,
                               device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }


def _mla_qkv(params, cfg: ModelConfig, x, positions):
    """The query's no-rope and rope parts (B,S,H,nope), (B,S,H,rope), the
    normed latent (B,S,kv_lora) and the shared rope key (B,S,rope). The
    latents' norms take the reference's default eps, not cfg.norm_eps."""
    B, S, _ = x.shape
    H, nope, rope = cfg.num_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    q_lat = rmsnorm(params["q_norm"], x @ params["wq_a"])
    q = (q_lat @ params["wq_b"]).reshape(B, S, H, nope + rope)
    q_nope = q[..., :nope]
    q_rope = apply_rope(q[..., nope:], positions, cfg.rope_theta)
    kv_a = x @ params["wkv_a"]
    ckv = rmsnorm(params["kv_norm"], kv_a[..., :cfg.kv_lora_rank])
    k_rope = apply_rope(kv_a[..., cfg.kv_lora_rank:][:, :, None, :],
                        positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, ckv, k_rope


def _cat_last(a, b):
    """torch.cat on the last axis, float8 as bits."""
    out = torch.cat([_bits(a), _bits(b)], dim=-1)
    return out.view(a.dtype) if _is_fp8(a) else out


def mla_apply(params, cfg: ModelConfig, x, positions, cache, mode: AttnMode):
    """x: (B,S,d); positions: (S,). Returns (out, cache).

    Train and prefill take the naive path: the latents expanded to
    per-head K (nope + rope) and V, attended over the FRESH tokens (the
    prefill writes only the latent cache). Decode takes the absorbed
    path: q_nope·wk_b into latent space, then one KV head of depth
    kv_lora + rope against the cached latents, v depth kv_lora, and wv_b
    after."""
    B, S, _ = x.shape
    H = cfg.num_heads
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    kvr = cfg.kv_lora_rank
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, cfg, x, positions)
    scale = 1.0 / ((nope + rope) ** 0.5)

    if mode.kind in ("train", "prefill"):
        if mode.kind == "prefill":
            _write_entries(cache, {"ckv": ckv, "krope": k_rope}, positions)
        k_nope = (ckv @ params["wk_b"]).reshape(B, S, H, nope)
        val = (ckv @ params["wv_b"]).reshape(B, S, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      dim=-1)
        q = torch.cat([q_nope, q_rope], dim=-1)
        out = blocked_attention(q, k, val, positions, positions,
                                window=mode.window, block_k=mode.block_k,
                                scale=scale)
    else:
        _write_entries(cache, {"ckv": ckv, "krope": k_rope}, positions)
        wk_b = params["wk_b"].reshape(kvr, H, nope)
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope, wk_b)
        q_full = torch.cat([q_lat, q_rope], dim=-1)  # (B,S,H,kvr+rope)
        k_full = _cat_last(cache["ckv"], cache["krope"])  # (B,T,kvr+rope)
        out_lat = blocked_attention(
            q_full, k_full[:, :, None, :], cache["ckv"][:, :, None, :],
            positions, cache["slot_pos"], window=mode.window,
            block_k=mode.block_k, scale=scale)  # (B,S,H,kvr)
        wv_b = params["wv_b"].reshape(kvr, H, dv)
        out = torch.einsum("bshr,rhv->bshv", out_lat, wv_b)
    out = out.reshape(B, S, H * dv)
    return out @ params["wo"], cache
