"""Decoder-only transformer: dense GQA, RWKV-6, the MoE/MLA families
(DeepSeek-V3, Arctic) and the hybrid attention + SSM block (Hymba),
over token inputs, embeddings (MusicGen's audio frames) or both (LLaVA's
patch prefix, then text), served and trained.

Counterpart of `repro/models/transformer.py`. The parameters are a
training tree (`init_params`): a flat dict with one tensor per leaf of
the reference's tree, keyed by its path joined with "/"
("groups/dense/attn/wq", the group's layers stacked on axis 0).
`utils.pytree.ravel_spec` walks it in the reference's leaf order, so
FedGiA's flat (m, N) buffers are the reference's lane for lane, and
`torch.func` takes gradients of the loss over it. The serving module
holds one such tree (`Transformer.params`); a forward unbinds each
stacked leaf into its layers once.

Layers are stacked into homogeneous groups (DeepSeek-V3: its leading
dense layers, then its MoE layers) and run in a Python loop. The cache
keeps the reference's layout, each group's tensors stacked on a leading
layer axis, and is updated in place.
A decode step reads no host value (its position is a 0-d tensor on the
device), so `launch/serve.py` captures it once as a CUDA graph and
replays it for every token.

Modes:
  train    — full causal attention, no cache: the plain blocked softmax
             and WKV recurrence, as the reference trains (autograd and
             `torch.func` go through them; the CUDA kernels have no
             backward, and neither have the reference's Pallas kernels)
  prefill  — causal attention, writes the cache, returns the last logits:
             the flash attention and WKV scan kernels
  decode   — ONE new token against the cache (ring buffer when the
             sliding-window long-context variant is on)

MLA layers attend with the plain blocked softmax in every mode (its
q/k depth differs from its v depth, which no kernel takes), as the
reference does. A hybrid layer runs its attention and its SSM branch
(`models/ssm.py`, plain PyTorch as the reference's `lax.scan`) on the
same normed input and mixes them; its SSM starts from the zero state in
train and prefill and carries on from the cache's in decode.

Inputs: `tokens` (B, S), `embeds` (B, P, d) (cast to the model's dtype),
or both, the embeddings first, at positions 0..P+S-1.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.attention import AttnMode
from repro_torch.models.layers import rmsnorm
from repro_torch.models.mlp import mlp_apply

IGNORE_LABEL = -1
MTP_WEIGHT = 0.3


@dataclasses.dataclass(frozen=True)
class LayerGroup:
    name: str
    count: int
    kind: str  # dense | moe | rwkv | hybrid


def _layer_groups(cfg: ModelConfig):
    if cfg.attention_type == "rwkv":
        return [LayerGroup("rwkv", cfg.num_layers, "rwkv")]
    if cfg.attention_type == "hybrid":
        return [LayerGroup("hybrid", cfg.num_layers, "hybrid")]
    if cfg.moe:
        groups = []
        if cfg.first_dense_layers:
            groups.append(LayerGroup("dense", cfg.first_dense_layers,
                                     "dense"))
        groups.append(LayerGroup("moe", cfg.num_layers
                                 - cfg.first_dense_layers, "moe"))
        return groups
    return [LayerGroup("dense", cfg.num_layers, "dense")]


class Transformer:
    """The model and its parameters. `Transformer(cfg, device)` holds none
    yet; `init(key)` draws them on `device` from the reference's threefry
    key (`init_params`), or `load_params(params)` takes a training tree
    (for instance `utils.convert.training_tree_from_numpy` of the
    reference's parameters, or a trained one)."""

    def __init__(self, cfg: ModelConfig, device=None):
        self.layer_groups = _layer_groups(cfg)
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        self.params: Optional[dict] = None

    # ------------------------------------------------------------------ init
    def init(self, key) -> "Transformer":
        """Draw every parameter from `key` (`prng.prng_key(seed)`), as the
        reference's `Transformer.init(PRNGKey(seed))` does."""
        self.params = init_params(self.cfg, key, self.device)
        return self

    def load_params(self, params: dict) -> "Transformer":
        """Take every parameter from the training tree `params` (the keys,
        shapes and dtypes of `init_params`'), moved to `self.device`."""
        own = _draw(self.cfg, prng.prng_key(0),
                    _Draws(self.dtype, torch.device("meta")))
        if set(params) != set(own):
            raise KeyError(f"parameter keys differ: missing "
                           f"{sorted(set(own) - set(params))}, unexpected "
                           f"{sorted(set(params) - set(own))}")
        for k, t in params.items():
            if t.shape != own[k].shape or t.dtype != own[k].dtype:
                raise ValueError(f"{k}: want {own[k].dtype} "
                                 f"{tuple(own[k].shape)}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
        self.params = {k: t.to(self.device) for k, t in params.items()}
        return self

    # ----------------------------------------------------------------- cache
    def _block_cache(self, kind: str, batch: int, cache_len: int, dtype):
        if kind == "rwkv":
            return rwkv_lib.init_rwkv_state(self.cfg, batch, dtype,
                                            self.device)
        if self.cfg.attention_type == "mla":
            return attn_lib.init_mla_cache(self.cfg, batch, cache_len, dtype,
                                           self.device)
        c = attn_lib.init_gqa_cache(self.cfg, batch, cache_len, dtype,
                                    self.device)
        if kind == "hybrid":
            c = {"attn": c, "ssm_state": ssm_lib.init_ssm_state(
                self.cfg, batch, self.device)}
        return c

    def init_cache(self, batch: int, cache_len: int, dtype=None):
        """{group: {name: tensor stacked over the group's layers}}, a
        hybrid group's {"attn": {...}, "ssm_state": (L, B, d, st) float32}
        (the reference's layout). `dtype` (default: the model's) is the
        K/V cache's, e.g. `torch.float8_e4m3fn` for a quantized cache, as
        the reference's."""
        dtype = dtype or self.dtype
        return {g.name: _stack_layers(
            self._block_cache(g.kind, batch, cache_len, dtype), g.count)
            for g in self.layer_groups}

    # ----------------------------------------------------------------- apply
    def _block_apply(self, kind: str, params, x, cache, positions,
                     mode: AttnMode):
        """One layer; `cache` (this layer's views of the stacked cache, or
        None) is updated in place. Returns (x, the MoE layer's aux loss,
        None for the other kinds)."""
        cfg = self.cfg
        if kind == "rwkv":
            state = (cache if cache
                     else rwkv_lib.init_rwkv_state(cfg, x.shape[0], x.dtype,
                                                   x.device))
            # prefill starts from the zero state (`prefill` makes a fresh
            # cache): the scan kernel, which assumes it, runs it. Train
            # carries the zero state through the plain recurrence, which
            # autograd can go through
            wkv = None if mode.kind == "prefill" else state["wkv"]
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
            return x, None

        xn = rmsnorm(params["norm1"], x, cfg.norm_eps)
        attend = (attn_lib.mla_apply if cfg.attention_type == "mla"
                  else attn_lib.gqa_apply)
        hybrid = kind == "hybrid"
        h, _ = attend(params["attn"], cfg, xn, positions,
                      cache["attn"] if cache and hybrid else cache, mode)
        if hybrid:
            state = (cache["ssm_state"] if cache and mode.kind == "decode"
                     else ssm_lib.init_ssm_state(cfg, x.shape[0], x.device))
            h_ssm, state = ssm_lib.ssm_apply(params["ssm"], cfg, xn, state)
            if cache:  # in place, so a captured decode step replays it
                cache["ssm_state"].copy_(state)
            h = params["mix_attn"] * h + params["mix_ssm"] * h_ssm
        x = x + h
        xn = rmsnorm(params["norm2"], x, cfg.norm_eps)
        aux = None
        if kind == "moe":
            h, aux = moe_lib.moe_apply(params["moe"], cfg, xn)
            if cfg.dense_residual:
                h = h + mlp_apply(params["mlp"], xn)
        else:
            h = mlp_apply(params["mlp"], xn)
        return x + h, aux

    def _hidden(self, tree, tokens, cache, positions, mode, embeds=None):
        """The layers over `tree` (`_nest` of a training tree), each
        group's stacked leaves unbound into its layers once, on the
        embeddings (cast to the model's dtype) and then the tokens'. Returns
        (the hidden state before the final norm, the MoE layers' summed
        aux loss, a 0-d float32)."""
        parts = []
        if embeds is not None:
            parts.append(embeds.to(self.dtype))
        if tokens is not None:
            parts.append(tree["embed"][tokens])
        if not parts:
            raise ValueError("the model takes tokens, embeds or both")
        x = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)
        elif mode.kind == "prefill" and not torch.equal(
                positions.cpu().long(), torch.arange(x.shape[1])):
            # the flash kernel masks by index (ROADMAP queue 3 i)
            raise ValueError("prefill takes positions 0..S-1")
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for g in self.layer_groups:
            layers = _unstack(tree["groups"][g.name], g.count)
            group_cache = cache[g.name] if cache else None
            for i in range(g.count):
                c_i = _layer_views(group_cache, i) if group_cache else None
                x, a = self._block_apply(g.kind, layers[i], x, c_i,
                                         positions, mode)
                if a is not None:
                    aux = aux + a
        return x, aux

    def _logits(self, tree, x):
        x = rmsnorm(tree["final_norm"], x, self.cfg.norm_eps)
        head = (tree["embed"].T if self.cfg.tie_embeddings
                else tree["lm_head"])
        return x @ head

    def forward(self, tokens=None, *, embeds=None, cache=None,
                positions=None, mode: AttnMode = AttnMode("train"),
                params=None):
        """tokens: (B,S) int; embeds: (B,P,d), before the tokens. Returns
        the logits (B,P+S,V).

        `params`: a training tree (`init_params`) to run instead of the
        module's own. `positions`: the inputs' absolute positions, (P+S,)
        (default 0..P+S-1; prefill takes only those). `cache`
        (`init_cache`) is written in place in prefill and decode modes."""
        tree = _nest(self.params if params is None else params)
        x, _ = self._hidden(tree, tokens, cache, positions, mode, embeds)
        return self._logits(tree, x)

    # ------------------------------------------------------------------ loss
    def loss(self, params, batch, mode: AttnMode = AttnMode("train")):
        """The reference's `Transformer.loss` on a training tree. batch:
        {"tokens": (B, S+1)}, which predicts tokens[:, 1:] from
        tokens[:, :-1]; {"embeds": (B, S, d), "labels": (B, S)} (audio);
        or {"embeds": (B, P, d), "tokens": (B, St+1)} (VLM: the patch
        prefix, then the text, no loss on the prefix). Returns (loss,
        {"ce", "moe_aux", "acc", "loss"}, and "mtp" where the config has
        the MTP head and the batch tokens): ce + moe_aux (0 for the kinds
        without MoE) + MTP_WEIGHT · mtp. A pure function of its arguments
        (no host read, no write to them), so `torch.func.vmap(
        grad_and_value)` takes it over clients."""
        embeds, tokens = batch.get("embeds"), batch.get("tokens")
        if tokens is not None:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        else:
            inputs, labels = None, batch["labels"]
        tree = _nest(params)
        hidden, aux = self._hidden(tree, inputs, None, None, mode, embeds)
        if embeds is not None and tokens is not None:
            # no loss on the embedding prefix
            prefix = labels.new_full((labels.shape[0], embeds.shape[1]),
                                     IGNORE_LABEL)
            labels = torch.cat([prefix, labels], dim=1)
        ce, acc = _masked_ce(self._logits(tree, hidden), labels)
        total = ce + aux
        metrics = {"ce": ce, "moe_aux": aux, "acc": acc}
        if self.cfg.mtp and tokens is not None:
            mtp = self._mtp_loss(tree, hidden, inputs, labels)
            total = total + MTP_WEIGHT * mtp
            metrics["mtp"] = mtp
        metrics["loss"] = total
        return total, metrics

    def _mtp_loss(self, tree, hidden, inputs, labels):
        """DeepSeek-V3's multi-token prediction: predict token t+2 from
        [h_t; emb_{t+1}] through the MTP head's projection, its dense
        block and norm, and the model's output head."""
        cfg = self.cfg
        emb = tree["embed"][inputs]
        z = torch.cat([hidden[:, :-1], emb[:, 1:]], dim=-1)
        z = z @ tree["mtp"]["proj"]
        pos = torch.arange(z.shape[1], device=z.device)
        z, _ = self._block_apply("dense", tree["mtp"]["block"], z, None, pos,
                                 AttnMode("train"))
        z = rmsnorm(tree["mtp"]["norm"], z, cfg.norm_eps)
        head = tree["embed"].T if cfg.tie_embeddings else tree["lm_head"]
        ce, _ = _masked_ce(z @ head, labels[:, 1:])
        return ce

    # ------------------------------------------------------------- serving
    def prefill(self, tokens=None, *, embeds=None, cache_len: int,
                window: Optional[int] = None, cache_dtype=None):
        """Prefill `embeds` (B,P,d) and then `tokens` (B,S) (either may be
        None) at positions 0..P+S-1. Returns (logits of the last position
        (B,V), cache). Only the last position goes through the head: the
        reference takes `logits[:, -1]` of the full product, the same
        values. `cache_dtype`: see `init_cache`."""
        batch = (tokens if tokens is not None else embeds).shape[0]
        cache = self.init_cache(batch, cache_len, cache_dtype)
        mode = AttnMode("prefill", window=window)
        tree = _nest(self.params)
        x, _ = self._hidden(tree, tokens, cache, None, mode, embeds)
        return self._logits(tree, x[:, -1]), cache

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
        tree = _nest(self.params)
        x, _ = self._hidden(tree, tokens, cache, positions, mode)
        return self._logits(tree, x)[:, -1], cache


def _masked_ce(logits, labels):
    """Mean cross-entropy over the labels that are not IGNORE_LABEL, the
    log-softmax in float32, and the argmax accuracy over the same."""
    mask = labels != IGNORE_LABEL
    safe = torch.where(mask, labels, 0)
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(logp, -1, safe[..., None])[..., 0]
    denom = torch.clamp_min(mask.sum(), 1)
    ce = -(ll * mask).sum() / denom
    acc = ((logits.argmax(-1) == safe) & mask).sum() / denom
    return ce, acc


def _nest(params: dict) -> dict:
    """A training tree ({"a/b/c": tensor}) as the nested dict the layers
    read (tree["a"]["b"]["c"]); the tensors are not copied."""
    root: dict = {}
    for key, v in params.items():
        *parents, leaf = key.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


def _stack_layers(tree, count):
    """A layer's cache (nested dict of tensors) stacked `count` times on a
    new leading axis."""
    if isinstance(tree, dict):
        return {k: _stack_layers(v, count) for k, v in tree.items()}
    return tree[None].repeat((count,) + (1,) * tree.dim())


def _layer_views(tree, i):
    """Layer i's views of a stacked cache (nested dict of tensors)."""
    if isinstance(tree, dict):
        return {k: _layer_views(v, i) for k, v in tree.items()}
    return tree[i]


def _unstack(tree, count):
    """A nested dict of stacked tensors as `count` per-layer dicts of
    views, one `unbind` a leaf: its backward stacks the layers' gradients
    into one buffer, where indexing each layer would add a zero-filled
    stacked-size gradient a layer (at TinyLlama's width, 22 x 4 GiB a
    gradient)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v, count) for k, v in tree.items()}
        return [{k: p[i] for k, p in parts.items()} for i in range(count)]
    return tree.unbind(0)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ------------------------------------------------- weights from the key
# words of one on-card draw: a leaf is drawn this many at a time, each
# tile from its own offset into the leaf's flat counter range (the int64
# lanes of the device threefry take ~40 bytes a word while a tile is drawn)
DRAW_TILE = 1 << 26


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf of the reference's init, not yet drawn: normal(key,
    shape)·scale cast to `dtype`, or a constant `value` where `key` is
    None."""
    shape: tuple
    dtype: torch.dtype
    key: Optional[np.ndarray] = None
    scale: float = 1.0
    value: float = 0.0


class _Draws:
    """The reference's initializers on the reference's threefry stream
    (`core/prng.py`): `he`, `normal` and `full` describe a leaf (`_Leaf`),
    `fill` draws it into a tensor: the numpy forms on the CPU, the torch
    forms on the card (a tile of DRAW_TILE words at a time, so a leaf of
    billions of weights needs no float32 copy of itself)."""

    def __init__(self, dtype, device):
        self.dtype, self.device = dtype, device

    def normal(self, key, shape, scale):
        return _Leaf(tuple(shape), self.dtype, key, float(scale))

    def he(self, key, shape, fan_in, dtype=None):
        """The reference's `layers.he_init`: normal · (1/sqrt(fan_in)),
        both in float32, cast to `dtype` (default the model's)."""
        scale = np.float32(1.0) / np.sqrt(np.float32(max(fan_in, 1)))
        return _Leaf(tuple(shape), dtype or self.dtype, key, float(scale))

    def full(self, shape, value, dtype=None):
        return _Leaf(tuple(shape), dtype or self.dtype, value=float(value))

    def empty(self, shape, dtype):
        return torch.empty(shape, dtype=dtype, device=self.device)

    def fill(self, leaf: _Leaf, out: torch.Tensor) -> None:
        """Write `leaf`'s values into `out` (its shape and dtype)."""
        if self.device.type == "meta":  # shapes only (`load_params`)
            return
        if leaf.key is None:
            out.fill_(leaf.value)
        elif self.device.type == "cpu":
            out.copy_(torch.from_numpy(prng.normal(leaf.key, leaf.shape))
                      * leaf.scale)
        else:
            key = prng.key_t(leaf.key, self.device)
            flat = out.view(-1)
            for o in range(0, flat.numel(), DRAW_TILE):
                n = min(DRAW_TILE, flat.numel() - o)
                flat[o:o + n] = prng.normal_t(key, n, offset=o) * leaf.scale

    def make(self, leaf: _Leaf) -> torch.Tensor:
        out = self.empty(leaf.shape, leaf.dtype)
        self.fill(leaf, out)
        return out


def _gqa_init(dr: _Draws, key, cfg: ModelConfig):
    d, H, Kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    ks = prng.split(key, 4)
    p = {"wq": dr.he(ks[0], (d, H * hd), d),
         "wk": dr.he(ks[1], (d, Kv * hd), d),
         "wv": dr.he(ks[2], (d, Kv * hd), d),
         "wo": dr.he(ks[3], (H * hd, d), H * hd)}
    if cfg.qkv_bias:
        p["bq"] = dr.full((H * hd,), 0.0)
        p["bk"] = dr.full((Kv * hd,), 0.0)
        p["bv"] = dr.full((Kv * hd,), 0.0)
    return p


def _mla_init(dr: _Draws, key, cfg: ModelConfig):
    """The reference's `attention.mla_init`."""
    d, H = cfg.d_model, cfg.num_heads
    qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
    nope, rope, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ks = prng.split(key, 6)
    return {"wq_a": dr.he(ks[0], (d, qr), d),
            "q_norm": {"scale": dr.full((qr,), 1.0)},
            "wq_b": dr.he(ks[1], (qr, H * (nope + rope)), qr),
            "wkv_a": dr.he(ks[2], (d, kvr + rope), d),
            "kv_norm": {"scale": dr.full((kvr,), 1.0)},
            "wk_b": dr.he(ks[3], (kvr, H * nope), kvr),
            "wv_b": dr.he(ks[4], (kvr, H * dv), kvr),
            "wo": dr.he(ks[5], (H * dv, d), H * dv)}


def _mlp_init(dr: _Draws, key, d, f):
    ks = prng.split(key, 3)
    return {"w1": dr.he(ks[0], (d, f), d), "w3": dr.he(ks[1], (d, f), d),
            "w2": dr.he(ks[2], (f, d), f)}


def _moe_init(dr: _Draws, key, cfg: ModelConfig):
    """The reference's `moe.moe_init`: the router in float32, the experts
    stacked on a leading E axis, the shared experts one wide MLP."""
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    ks = prng.split(key, 5)
    p = {"router": dr.he(ks[0], (d, E), d, torch.float32),
         "experts": {"w1": dr.he(ks[1], (E, d, f), d),
                     "w3": dr.he(ks[2], (E, d, f), d),
                     "w2": dr.he(ks[3], (E, f, d), f)}}
    if cfg.num_shared_experts:
        p["shared"] = _mlp_init(dr, ks[4], d, f * cfg.num_shared_experts)
    return p


def _ssm_init(dr: _Draws, key, cfg: ModelConfig):
    """The reference's `ssm.ssm_init`: A_log in float32 (zeros), the
    rest in the model's dtype."""
    d, st = cfg.d_model, cfg.ssm_state
    ks = prng.split(key, 6)
    return {"in_x": dr.he(ks[0], (d, d), d),
            "in_z": dr.he(ks[1], (d, d), d),
            "w_dt": dr.he(ks[2], (d, d), d),
            "dt_bias": dr.full((d,), -2.0),
            "w_B": dr.he(ks[3], (d, st), d),
            "w_C": dr.he(ks[4], (d, st), d),
            "A_log": dr.full((d, st), 0.0, torch.float32),
            "D": dr.full((d,), 1.0),
            "out": dr.he(ks[5], (d, d), d)}


def _rwkv_init(dr: _Draws, ks, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    H, hd = cfg.num_heads, cfg.rwkv_head_size
    lora = rwkv_lib.DECAY_LORA
    tk = prng.split(ks[0], 8)
    ck = prng.split(ks[1], 3)
    return {
        "time_mix": {
            "mu": dr.full((5, d), 0.5),
            "wr": dr.he(tk[0], (d, H * hd), d),
            "wk": dr.he(tk[1], (d, H * hd), d),
            "wv": dr.he(tk[2], (d, H * hd), d),
            "wg": dr.he(tk[3], (d, H * hd), d),
            "wo": dr.he(tk[4], (H * hd, d), H * hd),
            "decay_w1": dr.he(tk[5], (d, lora), d),
            "decay_w2": dr.he(tk[6], (lora, d), lora),
            "decay_bias": dr.full((d,), -4.0),
            "bonus_u": dr.he(tk[7], (H, hd), hd),
        },
        "channel_mix": {
            "mu_k": dr.full((d,), 0.5),
            "mu_r": dr.full((d,), 0.5),
            "wk": dr.he(ck[0], (d, f), d),
            "wv": dr.he(ck[1], (f, d), f),
            "wr": dr.he(ck[2], (d, d), d),
        },
    }


def _block_from_key(dr: _Draws, cfg: ModelConfig, kind: str, key):
    """The reference's `Transformer._block_init(kind, key)`, as leaves."""
    d = cfg.d_model
    ks = prng.split(key, 6)
    norm = lambda: {"scale": dr.full((d,), 1.0)}  # noqa: E731
    if kind == "rwkv":
        p = _rwkv_init(dr, ks, cfg)
        return {"norm1": norm(), "time_mix": p["time_mix"], "norm2": norm(),
                "channel_mix": p["channel_mix"]}
    attn = (_mla_init if cfg.attention_type == "mla" else _gqa_init)
    p = {"norm1": norm(), "attn": attn(dr, ks[0], cfg), "norm2": norm()}
    if kind == "hybrid":  # the SSM from ks[1], so the MLP from ks[2]
        p["ssm"] = _ssm_init(dr, ks[1], cfg)
        p["mix_attn"] = dr.full((d,), 0.5)
        p["mix_ssm"] = dr.full((d,), 0.5)
        p["mlp"] = _mlp_init(dr, ks[2], d, cfg.d_ff)
    elif kind == "moe":
        p["moe"] = _moe_init(dr, ks[1], cfg)
        if cfg.dense_residual:
            p["mlp"] = _mlp_init(dr, ks[2], d, cfg.d_ff)
    else:
        p["mlp"] = _mlp_init(dr, ks[1], d, cfg.d_ff)
    return p


def init_params(cfg: ModelConfig, key, device=None) -> dict:
    """The training tree that the reference's `Transformer(cfg).init(key)`
    draws, from the same threefry key (`prng.prng_key(seed)` for
    `jax.random.PRNGKey(seed)`): the split into len(groups) + 4 keys, the
    embedding's 0.02·normal, He-scaled normals for the matrices (the MoE
    router's in float32), and per layer the reference's `vmap` over
    split(k, count), one key a layer, each split again as `gqa_init`,
    `mla_init`, `mlp_init`, `moe_init`, `ssm_init` and the RWKV inits
    split theirs; zero biases, unit norms and the SSM's constants (A_log
    0 in float32); the MTP head from key len(groups) + 2.
    Drawn with the numpy forms on the CPU and the torch forms on the
    card, layer by layer straight into each stacked leaf. The integer
    stream is the reference's bit for bit; a normal sits within 4
    float32 ulps of the reference's (numpy's `log1p` against XLA's), so
    the bfloat16 weights are the reference's bit for bit except where
    those ulps cross a rounding boundary (tests/test_torch_train_arch.py
    states the share)."""
    device = resolve_device(device)
    return _draw(cfg, key, _Draws(getattr(torch, cfg.dtype), device))


def _draw(cfg: ModelConfig, key, dr: _Draws) -> dict:
    groups = _layer_groups(cfg)
    d = cfg.d_model
    ks = prng.split(np.asarray(key, np.uint32), len(groups) + 4)
    tree = {
        "embed": dr.normal(ks[0], (cfg.vocab_size, d), 0.02),
        "final_norm": {"scale": dr.full((d,), 1.0)},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = dr.he(ks[1], (d, cfg.vocab_size), d)
    if cfg.mtp:
        km = prng.split(ks[len(groups) + 2], 2)
        tree["mtp"] = {"proj": dr.he(km[0], (2 * d, d), 2 * d),
                       "block": _block_from_key(dr, cfg, "dense", km[1]),
                       "norm": {"scale": dr.full((d,), 1.0)}}
    out = {k: dr.make(leaf) for k, leaf in _flatten(tree).items()}
    for g, k in zip(groups, ks[2:]):
        layers = [_flatten(_block_from_key(dr, cfg, g.kind, lk))
                  for lk in prng.split(k, g.count)]
        for name, first in layers[0].items():
            # each layer drawn straight into its slice of the stacked leaf
            buf = dr.empty((g.count,) + first.shape, first.dtype)
            for i, layer in enumerate(layers):
                dr.fill(layer[name], buf[i])
            out[f"groups/{g.name}/{name}"] = buf
    return out
