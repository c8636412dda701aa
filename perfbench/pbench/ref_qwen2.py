"""Plain decoder-only transformer of the Qwen1.5 / Qwen2 family
(hf:Qwen/Qwen1.5-0.5B), the reference's loss: token embedding; per layer
RMSNorm, multi-head attention with a bias on q, k and v, rotary position
embedding on q and k (halves rotated, base `rope_theta`), causal softmax
scaled by 1/sqrt(head_dim), output projection, residual; RMSNorm, SwiGLU
MLP (silu(x W1) ∘ (x W3)) W2, residual; final RMSNorm; the output head
tied to the embedding; mean cross-entropy of each next token. Float32,
no kernels, no cache, one sequence batch at a time. It imports nothing
of the port.

Weights are read by their names in the benchmark's layout
(`systems.fedgia_lm.layout`): stacked layer leaves
"groups/dense/<part>/<w>" of shape (layers, ...), matrices (in, out).

`precision`: "fp32" (the reference) or "fp8" (the control: every matrix
product, forward and backward, on operands rounded to float8 — e4m3 with
a per-tensor scale forward, e5m2 for the gradients backward — and
accumulated in float32). `half=True` is the planted fault "half the
batch left out": the loss over the first half of the positions."""
from __future__ import annotations

import math

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0


def _q8(x, dtype, top):
    s = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / top
    return (x.float() / s).to(dtype).float() * s


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = (_q8(t, torch.float8_e4m3fn, E4M3_MAX) for t in (a, b))
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, torch.float8_e5m2, E5M2_MAX)
        return qg @ qb.transpose(-1, -2), qa.transpose(-1, -2) @ qg


def matmul_for(precision: str):
    if precision == "fp32":
        return torch.matmul
    if precision == "fp8":
        return _Fp8Matmul.apply
    raise ValueError(f"unknown precision {precision!r}")


def _rmsnorm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x: (B, S, H, hd); positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, device=x.device,
                                        dtype=torch.float32) / hd))
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def loss(params: dict, tokens: torch.Tensor, cfg: dict, mm=torch.matmul,
         half: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of `tokens` (B, S+1) under `params`
    (float32 leaves), `cfg` the configuration's published keys."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    hd = d // H
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    g = "groups/dense/"
    inputs, labels = tokens[:, :-1].long(), tokens[:, 1:].long()
    B, S = inputs.shape
    x = params["embed"][inputs]
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    for i in range(L):
        p = {k[len(g):]: v[i] for k, v in params.items() if k.startswith(g)}
        h = _rmsnorm(x, p["norm1/scale"], eps)
        q = (mm(h, p["attn/wq"]) + p["attn/bq"]).view(B, S, H, hd)
        k = (mm(h, p["attn/wk"]) + p["attn/bk"]).view(B, S, H, hd)
        v = (mm(h, p["attn/wv"]) + p["attn/bv"]).view(B, S, H, hd)
        q, k = _rope(q, theta), _rope(k, theta)
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # B, H, S, hd
        s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        s = s.masked_fill(~causal, float("-inf"))
        o = mm(torch.softmax(s, dim=-1), v).transpose(1, 2).reshape(B, S, d)
        x = x + mm(o, p["attn/wo"])
        h = _rmsnorm(x, p["norm2/scale"], eps)
        a = mm(h, p["mlp/w1"])
        x = x + mm(a * torch.sigmoid(a) * mm(h, p["mlp/w3"]), p["mlp/w2"])
    x = _rmsnorm(x, params["final_norm/scale"], eps)
    logits = mm(x, params["embed"].transpose(0, 1))
    if half:
        logits, labels = logits[:, :S // 2], labels[:, :S // 2]
    return torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))


def value_and_grad(params: dict, tokens: torch.Tensor, cfg: dict,
                   mm=torch.matmul, half: bool = False):
    """(loss, {leaf: gradient}) at `params` (float32, not modified)."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    val = loss(leaves, tokens, cfg, mm=mm, half=half)
    grads = torch.autograd.grad(val, list(leaves.values()))
    return val.detach(), dict(zip(leaves, grads))


def flops_per_token(cfg: dict, seq_len: int) -> float:
    """Model FLOPs a trained token (forward and backward, no
    recomputation): 6 x the matrix parameters (the tied head included,
    the embedding lookup not) plus attention's score and value products
    over the causal half, 6 x seq_len x hidden a layer."""
    L, d = cfg["num_hidden_layers"], cfg["hidden_size"]
    f, V = cfg["intermediate_size"], cfg["vocab_size"]
    matrices = L * (4 * d * d + 3 * d * f) + V * d
    return 6.0 * matrices + 6.0 * L * seq_len * d
