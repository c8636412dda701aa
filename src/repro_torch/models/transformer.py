"""Decoder-only transformer for the serving path: dense GQA and RWKV-6.

Counterpart of `repro/models/transformer.py`. The parameters live in the
module itself (a `ParamTree`) under the reference pytree's key paths;
each group's layers, which the reference stacks on a leading axis, are
entries of a list ("groups.dense.0.attn.wq" is layer 0 of the reference's
`groups/dense/attn/wq`). Layers run in a Python loop. The cache keeps the
reference's layout, each group's tensors stacked on a leading layer axis,
and is updated in place. A decode step reads no host value (its position
is a 0-d tensor on the device), so `launch/serve.py` captures it once as
a CUDA graph and replays it for every token.

Modes:
  train    — full causal attention, no cache
  prefill  — causal attention, writes the cache, returns the last logits
  decode   — ONE new token against the cache (ring buffer when the
             sliding-window long-context variant is on)

MoE, MLA, the hybrid SSM, the loss and the MTP head are still to port.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import (
    ParamTree,
    embed_init,
    he_init,
    rmsnorm,
    rmsnorm_init,
)
from repro_torch.models.mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    name: str
    count: int
    kind: str  # dense | rwkv


def _layer_groups(cfg: ModelConfig):
    if cfg.attention_type == "rwkv":
        return [LayerGroup("rwkv", cfg.num_layers, "rwkv")]
    if cfg.moe or cfg.attention_type != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: MoE, MLA and hybrid layers are not ported yet "
            "(ROADMAP queue 1 item 14); the port runs dense GQA and RWKV-6")
    return [LayerGroup("dense", cfg.num_layers, "dense")]


def _block_init(cfg: ModelConfig, kind: str, gen, dtype, device):
    d = cfg.d_model
    if kind == "rwkv":
        return {
            "norm1": rmsnorm_init(d, dtype, device),
            "time_mix": rwkv_lib.time_mix_init(gen, cfg, dtype, device),
            "norm2": rmsnorm_init(d, dtype, device),
            "channel_mix": rwkv_lib.channel_mix_init(gen, cfg, dtype, device),
        }
    return {
        "norm1": rmsnorm_init(d, dtype, device),
        "attn": attn_lib.gqa_init(gen, cfg, dtype, device),
        "norm2": rmsnorm_init(d, dtype, device),
        "mlp": mlp_init(gen, d, cfg.d_ff, dtype, device),
    }


def _init_tree(cfg: ModelConfig, groups, gen, dtype, device) -> dict:
    tree = {
        "embed": embed_init(gen, (cfg.vocab_size, cfg.d_model), dtype, device),
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = he_init(gen, (cfg.d_model, cfg.vocab_size),
                                  cfg.d_model, dtype, device)
    tree["groups"] = {
        g.name: [_block_init(cfg, g.kind, gen, dtype, device)
                 for _ in range(g.count)]
        for g in groups
    }
    return tree


class Transformer(ParamTree):
    """The model and its parameters. `Transformer(cfg, device)` shapes the
    parameters without storage; `init(gen)` draws them on `device` from a
    generator there, or `load_params(state)` takes them from a state dict
    (for instance `utils.convert.transformer_state_from_numpy` of the
    reference's parameters)."""

    def __init__(self, cfg: ModelConfig, device=None):
        layer_groups = _layer_groups(cfg)
        dtype = getattr(torch, cfg.dtype)
        super().__init__(_init_tree(cfg, layer_groups, None, dtype, "meta"))
        self.cfg = cfg
        self.layer_groups = layer_groups
        self.dtype = dtype
        self.device = resolve_device(device)

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> "Transformer":
        """Draw every parameter from `gen`, which lies on `self.device`."""
        tree = _init_tree(self.cfg, self.layer_groups, gen, self.dtype,
                          self.device)
        return self.load_params(ParamTree(tree).state_dict())

    def load_params(self, state: dict) -> "Transformer":
        """Take every parameter from `state` ({key path: tensor}, the keys
        of `state_dict()`), moved to `self.device`. Shapes and dtypes must
        match."""
        own = self.state_dict()
        if set(state) != set(own):
            raise KeyError(f"parameter keys differ: missing "
                           f"{sorted(set(own) - set(state))}, unexpected "
                           f"{sorted(set(state) - set(own))}")
        for k, t in state.items():
            if t.shape != own[k].shape or t.dtype != own[k].dtype:
                raise ValueError(f"{k}: want {own[k].dtype} "
                                 f"{tuple(own[k].shape)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        self.load_state_dict({k: t.to(self.device) for k, t in state.items()},
                             assign=True)
        return self

    # ----------------------------------------------------------------- cache
    def _block_cache(self, kind: str, batch: int, cache_len: int, dtype):
        if kind == "rwkv":
            return rwkv_lib.init_rwkv_state(self.cfg, batch, dtype,
                                            self.device)
        return attn_lib.init_gqa_cache(self.cfg, batch, cache_len, dtype,
                                       self.device)

    def init_cache(self, batch: int, cache_len: int, dtype=None):
        """{group: {name: tensor stacked over the group's layers}}. `dtype`
        (default: the model's) is the K/V cache's, e.g.
        `torch.float8_e4m3fn` for a quantized cache, as the reference's."""
        dtype = dtype or self.dtype
        out = {}
        for g in self.layer_groups:
            single = self._block_cache(g.kind, batch, cache_len, dtype)
            out[g.name] = {k: a[None].repeat((g.count,) + (1,) * a.dim())
                           for k, a in single.items()}
        return out

    # ----------------------------------------------------------------- apply
    def _block_apply(self, kind: str, params, x, cache, positions,
                     mode: AttnMode):
        """One layer; `cache` (this layer's views of the stacked cache, or
        None) is updated in place."""
        cfg = self.cfg
        if kind == "rwkv":
            state = (cache if cache
                     else rwkv_lib.init_rwkv_state(cfg, x.shape[0], x.dtype,
                                                   x.device))
            # train and prefill start from the zero state (`prefill` makes
            # a fresh cache): the scan kernel, which assumes it, runs them
            wkv = state["wkv"] if mode.kind == "decode" else None
            h, tm_new = rwkv_lib.time_mix_apply(
                params["time_mix"], cfg,
                rmsnorm(params["norm1"], x, cfg.norm_eps),
                {"shift": state["shift"], "wkv": wkv})
            x = x + h
            h, cm_new = rwkv_lib.channel_mix_apply(
                params["channel_mix"],
                rmsnorm(params["norm2"], x, cfg.norm_eps), state["cm_shift"])
            x = x + h
            if cache:
                cache["shift"].copy_(tm_new["shift"])
                cache["wkv"].copy_(tm_new["wkv"])
                cache["cm_shift"].copy_(cm_new)
            return x

        xn = rmsnorm(params["norm1"], x, cfg.norm_eps)
        h, _ = attn_lib.gqa_apply(params["attn"], cfg, xn, positions, cache,
                                  mode)
        x = x + h
        h = mlp_apply(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps))
        return x + h

    def _run_group(self, group: LayerGroup, params, x, cache, positions,
                   mode):
        for i in range(group.count):
            c_i = {k: a[i] for k, a in cache.items()} if cache else None
            x = self._block_apply(group.kind, params[i], x, c_i, positions,
                                  mode)
        return x

    def _hidden(self, tokens, cache, positions, mode):
        x = self["embed"][tokens]
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        for g in self.layer_groups:
            x = self._run_group(g, self["groups"][g.name], x,
                                cache[g.name] if cache else None, positions,
                                mode)
        return x

    def _logits(self, x):
        x = rmsnorm(self["final_norm"], x, self.cfg.norm_eps)
        head = (self["embed"].T if self.cfg.tie_embeddings
                else self["lm_head"])
        return x @ head

    def forward(self, tokens, *, mode: AttnMode = AttnMode("train")):
        """Train-mode pass without a cache. tokens: (B,S) int. Returns the
        logits (B,S,V)."""
        return self._logits(self._hidden(tokens, None, None, mode))

    # ------------------------------------------------------------- serving
    def prefill(self, tokens, *, cache_len: int,
                window: Optional[int] = None, cache_dtype=None):
        """Returns (logits of the last position (B,V), cache). Only the
        last position goes through the head: the reference takes
        `logits[:, -1]` of the full product, the same values.
        `cache_dtype`: see `init_cache`."""
        cache = self.init_cache(tokens.shape[0], cache_len, cache_dtype)
        mode = AttnMode("prefill", window=window)
        x = self._hidden(tokens, cache, None, mode)
        return self._logits(x[:, -1]), cache

    def decode_step(self, cache, tokens, pos,
                    window: Optional[int] = None):
        """tokens: (B,1) int; pos: the new token's absolute position, a
        0-d integer tensor on the model's device (the reference's traced
        int32: a captured step reads it at replay) or an int."""
        if torch.is_tensor(pos):
            positions = pos.reshape(1).to(torch.long)
        else:  # a fill on the device: torch.tensor([pos]) would copy
            # from pageable host memory, which waits for the card
            positions = torch.full((1,), pos, dtype=torch.long,
                                   device=tokens.device)
        mode = AttnMode("decode", window=window)
        x = self._hidden(tokens, cache, positions, mode)
        return self._logits(x)[:, -1], cache
