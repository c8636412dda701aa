"""Mixture-of-Experts layer: top-k routing, capacity-based dispatch
("dropping" MoE, the expert FFN over every slot), optional shared experts
(DeepSeek-V3); the dense residual branch (Arctic) is the block's, in
`models/transformer.py`.

Counterpart of `repro/models/moe.py`, with its routing and its slots:

* the router runs in float32 (its weight is a float32 leaf): softmax,
  top-k over the probabilities, the k gates renormalised to sum 1;
* the Switch load-balance loss over the whole batch;
* capacity competition is scoped PER SEQUENCE POSITION: the B tokens at
  position s share one (E, C) slot budget, the group that a decode step
  routes together, so prefill + decode give the train forward's drops;
* a group's slots come from a stable argsort of its B·k expert choices
  and `searchsorted` of each expert's first entry; a choice past its
  expert's C slots goes to the sentinel slot E·C, which is dropped
  (PyTorch has no `mode="drop"`: the buffers have E·C + 1 slots and the
  last is cut off);
* the expert FFN runs as batched matmuls over E on the (E, C) slots of
  every position, and the combine is a scatter-add in float32 in slot
  space, each slot's output times its gate added to its token.

Every step is a gather, a scatter or a batched product on tensors, with
no host read, so a decode step runs under CUDA-graph capture and
`torch.func.vmap(grad)` takes the layer over clients. Position groups
are processed DISPATCH_BYTES at a time: at DeepSeek-V3's width a
position's float32 slot buffer is 2048 slots x 7168 (59 MB), so a
256-token prompt at once would hold 15 GB; each chunk computes the same
function on its own groups.
"""
from __future__ import annotations

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import silu
from repro_torch.models.mlp import mlp_apply

CAPACITY_FACTOR = 1.25
# bytes of one chunk's float32 combine buffer (positions x E·C slots x d)
DISPATCH_BYTES = 1 << 30


def expert_capacity(num_tokens: int, num_experts: int, k: int) -> int:
    cap = int(CAPACITY_FACTOR * num_tokens * k / num_experts)
    return max(8, -(-cap // 8) * 8)  # round up to 8


def route(params, cfg: ModelConfig, x):
    """The router on x (B, S, d): (probs (T, E) float32, gates (T, k)
    renormalised, expert_idx (T, k)), T = B·S tokens in (b, s) order."""
    d = x.shape[-1]
    logits = x.reshape(-1, d).float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, cfg.experts_per_token, dim=-1)
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return probs, gate_vals, expert_idx


def slots(expert_idx, gate_vals, B: int, S: int, E: int, C: int):
    """Each position group's (E·C) slots: (tok_of_slot (S, E·C), the
    token b in 0..B-1 a slot holds or B for an empty slot;
    gate_of_slot (S, E·C), its gate, 0 where empty). Entry i of a group
    is token i // k's (i % k)-th choice; it takes slot e·C + its rank
    among the group's entries for expert e (a stable sort keeps token
    order), dropped when the rank is C or more."""
    k = expert_idx.shape[-1]
    dev = expert_idx.device
    eg = expert_idx.reshape(B, S, k).transpose(0, 1).reshape(S, B * k)
    gg = gate_vals.reshape(B, S, k).transpose(0, 1).reshape(S, B * k)
    order = torch.argsort(eg, dim=-1, stable=True)
    sorted_e = eg.gather(-1, order)
    experts = torch.arange(E, device=dev).repeat(S, 1)
    starts = torch.searchsorted(sorted_e, experts)  # (S, E)
    rank_sorted = (torch.arange(B * k, device=dev)
                   - starts.gather(-1, sorted_e))
    rank = torch.empty_like(rank_sorted).scatter(-1, order, rank_sorted)
    slot = torch.where(rank < C, eg * C + rank, E * C)  # E·C: dropped
    token_of = torch.arange(B * k, device=dev) // k  # entry i: token i // k
    tok_of_slot = torch.full((S, E * C + 1), B, dtype=torch.long,
                             device=dev).scatter(
        -1, slot, token_of.expand(S, B * k))[:, :-1]
    gate_of_slot = torch.zeros((S, E * C + 1), dtype=torch.float32,
                               device=dev).scatter(-1, slot, gg)[:, :-1]
    return tok_of_slot, gate_of_slot


def _experts(w, buf, E: int, C: int):
    """The E expert FFNs on buf (Sc, E·C, d), as batched matmuls over E:
    returns (Sc, E·C, d) in buf's dtype."""
    Sc, _, d = buf.shape
    xe = buf.reshape(Sc, E, C, d)
    h = silu(torch.einsum("secd,edf->secf", xe, w["w1"])) * torch.einsum(
        "secd,edf->secf", xe, w["w3"])
    return torch.einsum("secf,efd->secd", h, w["w2"]).reshape(Sc, E * C, d)


def moe_apply(params, cfg: ModelConfig, x):
    """x: (B, S, d). Returns (out (B, S, d), aux loss (0-d float32))."""
    B, S, d = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    T = B * S
    probs, gate_vals, expert_idx = route(params, cfg, x)

    # load-balance auxiliary loss (Switch-style, whole batch)
    me = probs.mean(0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).scatter_add(
        0, expert_idx.reshape(-1),
        torch.ones((T * k,), dtype=torch.float32, device=x.device)) / (T * k)
    aux = E * torch.sum(me * ce)

    C = expert_capacity(B, E, k)
    tok_of_slot, gate_of_slot = slots(expert_idx, gate_vals, B, S, E, C)
    # position groups, each with a zero row B that empty slots read
    xz = torch.cat([x.transpose(0, 1),
                    x.new_zeros((S, 1, d))], dim=1).reshape(S * (B + 1), d)
    step = max(1, DISPATCH_BYTES // (E * C * d * 4))
    parts = []
    for s0 in range(0, S, step):
        s1 = min(S, s0 + step)
        rows = (tok_of_slot[s0:s1]
                + (torch.arange(s0, s1, device=x.device) * (B + 1))[:, None])
        buf = xz.index_select(0, rows.reshape(-1)).reshape(s1 - s0, E * C, d)
        out_buf = _experts(params["experts"], buf, E, C)
        del buf
        # combine in slot space: each slot's output times its gate added
        # to its token's row, in float32; empty slots add 0 to row B
        contrib = out_buf.float() * gate_of_slot[s0:s1, :, None]
        del out_buf
        local = rows - s0 * (B + 1)
        parts.append(torch.zeros(((s1 - s0) * (B + 1), d),
                                 dtype=torch.float32, device=x.device)
                     .index_add(0, local.reshape(-1), contrib.reshape(-1, d))
                     .reshape(s1 - s0, B + 1, d)[:, :B])
        del contrib
    combined = parts[0] if len(parts) == 1 else torch.cat(parts)
    out = combined.transpose(0, 1).to(x.dtype)
    if "shared" in params:
        out = out + mlp_apply(params["shared"], x)
    return out, aux * cfg.router_aux_coef


def moe_ref_dense(params, cfg: ModelConfig, x):
    """Oracle: every token through its top-k experts by dense per-expert
    masking (exact, no capacity drops). O(E·T·d·f): tests and
    chip_smoke.py only."""
    B, S, d = x.shape
    _, gate_vals, expert_idx = route(params, cfg, x)
    xt = x.reshape(-1, d)
    w = params["experts"]
    out = torch.zeros_like(xt)
    for e in range(cfg.num_experts):
        y = (silu(xt @ w["w1"][e]) * (xt @ w["w3"][e])) @ w["w2"][e]
        gate_e = ((expert_idx == e) * gate_vals).sum(-1)  # (T,)
        out = out + y * gate_e[:, None].to(y.dtype)
    res = out.reshape(B, S, d)
    if "shared" in params:
        res = res + mlp_apply(params["shared"], x)
    return res
