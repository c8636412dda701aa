"""Placement factories for every tree the planning dry run lays out
(counterpart of `repro/sharding/specs.py`, the same rules on the port's
trees).

Conventions (Megatron-style tensor parallelism over the `model` axis):
  * projections INTO heads/ff/experts shard their OUTPUT dim over `model`;
    projections back to d_model shard their INPUT dim over `model`;
  * MoE expert stacks shard the EXPERT dim over `model` (expert parallelism);
  * embedding / lm_head shard the vocab-adjacent dim over `model`;
  * federated client states carry a leading client axis sharded over
    `FedConfig.client_axes`; remaining dims follow the parameter rule;
  * activations/batches shard batch over the data-ish axes.

Specs are derived from leaf PATH NAMES, so they stay correct for every
architecture family without per-arch spec tables. A path is the leaf's
keys from the root, with the port's "/"-joined keys split into their
parts: the training tree's "groups/dense/attn/wq" is the reference's
params["groups"]["dense"]["attn"]["wq"], a state's z leaf under that key
is state["z"]["groups/dense/attn/wq"]. A factory returns a tree of the
input's structure with a `P` at each leaf.

torch has no PartitionSpec: `P` is a tuple with one entry a dim, each
None (replicated), an axis name or a tuple of axis names (the product
of those axes), as `jax.sharding.PartitionSpec` holds them. The port
runs no tensor parallelism (its client meshes replicate over `model`):
only `launch/dryrun.py` reads these specs, to lay out memory and to
model the `model` axis.
"""
from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.config import FedConfig, ModelConfig


class P(tuple):
    """A placement: one entry a dim (None, an axis name or a tuple of
    axis names); P() replicates."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


# rules: leaf name -> (spec WITHOUT the stacked-layer L dim)
# "out_model": shard last dim over model; "in_model": shard first dim;
# None: replicate.
_RULES = {
    # gqa attention
    "wq": "out_model", "wk": "out_model", "wv": "out_model", "wo": "in_model",
    "bq": "vec_model", "bk": "vec_model", "bv": "vec_model",
    # mla
    "wq_a": None, "wq_b": "out_model", "wkv_a": None,
    "wk_b": "out_model", "wv_b": "out_model",
    # mlp
    "w1": "out_model", "w3": "out_model", "w2": "in_model",
    # moe (leading expert dim)
    "router": None,
    # rwkv
    "wr": "out_model", "wg": "out_model",
    "decay_w1": None, "decay_w2": None, "decay_bias": None,
    "mu": None, "mu_k": None, "mu_r": None, "bonus_u": "head_model",
    # ssm
    "in_x": "out_model", "in_z": "out_model", "w_dt": "out_model",
    "dt_bias": "vec_model", "w_B": None, "w_C": None,
    "A_log": "in_model", "D": "vec_model",
    "mix_attn": None, "mix_ssm": None,
    # norms / misc
    "scale": None, "proj": None,
}


def _keys(path) -> list:
    """A path's keys with each "/"-joined key split into its parts."""
    out = []
    for k in path:
        out += str(k).split("/")
    return out


def leaf_rule(keys) -> Optional[str]:
    """The rule of the leaf at `keys` (`_keys` of its path)."""
    name = keys[-1]
    if name == "embed":
        return "emb"
    if name == "lm_head":
        return "out_model"
    if "experts" in keys:
        return "expert"
    return _RULES.get(name)


def spec_for(rule: Optional[str], ndim: int, model_axis: str) -> P:
    if rule is None:
        return P()
    if rule == "emb":
        return P(None, model_axis) if ndim == 2 else P()
    if rule in ("out_model", "vec_model"):
        return P(*([None] * (ndim - 1) + [model_axis]))
    if rule in ("in_model", "head_model", "expert"):
        return P(*([model_axis] + [None] * (ndim - 1)))
    raise ValueError(rule)


def _ndim(leaf) -> int:
    return len(getattr(leaf, "shape", ()))


def tree_map_with_path(fn, tree, path=()):
    """`fn(path, leaf)` at every leaf of a nested dict; the result has
    the input's structure (its keys, "/"-joined ones kept whole)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ModelConfig, params_shape, model_axis: str = "model"):
    """Specs of a training tree (`models/transformer.py::init_params`:
    the stacked group leaves carry a leading L dim). `params_shape`: the
    tree, or any tree of leaves with a `.shape`."""

    def assign(path, leaf):
        keys = _keys(path)
        rule = leaf_rule(keys)
        ndim = _ndim(leaf)
        if "groups" in keys:  # leading L dim of the stacked layers
            return P(None, *spec_for(rule, ndim - 1, model_axis))
        return spec_for(rule, ndim, model_axis)

    return tree_map_with_path(assign, params_shape)


def _used_axes(dims) -> set:
    used = set()
    for e in dims:
        for a in (e if isinstance(e, tuple) else (e,)):
            if a:
                used.add(a)
    return used


def axis_entry(axes):
    """A spec entry for `axes`: the one name, or the tuple of several."""
    return tuple(axes) if len(axes) > 1 else axes[0]


def fed_state_specs(fed: FedConfig, cfg: Optional[ModelConfig], state_shape,
                    model_axis: str = "model"):
    """Specs for a federated algorithm state: client-stacked leaves get the
    client axes on dim 0; server params follow param rules; scalars and
    the host-held counters and keys replicate.

    fed.fsdp_axes: client-state inner dims additionally sharded over these
    axes (first unassigned dim gets them) — FedGiA's per-client (z, pi)
    copies are the memory floor for giant archs, FSDP is how they fit.
    fed.replicate_params: drop the model-axis assignment entirely (pure DP
    within the client; gradient all-reduce once per round)."""
    client = axis_entry(fed.client_axes)

    def assign(path, leaf):
        keys = _keys(path)
        top = keys[0]
        ndim = _ndim(leaf)
        if top in ("sigma", "r", "round", "step", "rng"):
            return P()
        if top in ("gram_chol",):
            return P(client, *([None] * (ndim - 1)))
        param_keys = keys[1:]
        rule = leaf_rule(param_keys) if param_keys else None
        if fed.replicate_params and (not param_keys
                                     or param_keys[-1] != "lm_head"):
            # replicate the trunk, but KEEP the lm_head vocab-sharded:
            # unsharded logits (B*S x vocab per client) dominate memory
            # otherwise. The embed table IS replicated (the reference
            # measured a 5x FLOPs blow-up from a vocab-sharded gather)
            rule = None
        stacked_client = top in ("z", "pi", "h", "lam", "ci", "xc")
        stacked_layers = "groups" in keys
        core_ndim = ndim - int(stacked_client) - int(stacked_layers)
        dims = list(spec_for(rule, core_ndim, model_axis))
        if stacked_client and fed.fsdp_axes and core_ndim >= 1:
            # shard the first unassigned inner dim over whichever fsdp axes
            # this leaf does not already use
            free = tuple(a for a in fed.fsdp_axes if a not in _used_axes(dims))
            if free:
                for i, e in enumerate(dims):
                    if e is None:
                        dims[i] = axis_entry(free)
                        break
        if stacked_layers:
            dims = [None] + dims
        if stacked_client:
            dims = [client] + dims
        return P(*dims)

    return tree_map_with_path(assign, state_shape)


def train_batch_specs(fed: FedConfig, batch_shape, mesh_axes: Tuple[str, ...]):
    """Stacked client batches: client axis over client_axes, per-client batch
    dim over any remaining data-ish axes."""
    client = axis_entry(fed.client_axes)
    leftover = [a for a in mesh_axes if a not in fed.client_axes
                and (a != "model" or fed.replicate_params)]
    bdim = axis_entry(leftover) if leftover else None

    def assign(path, leaf):
        ndim = _ndim(leaf)
        dims = [client] + [None] * (ndim - 1)
        if ndim >= 2 and bdim is not None:
            dims[1] = bdim
        return P(*dims)

    return tree_map_with_path(assign, batch_shape)


def _batch_axis(batch: int, data_axes: Tuple[str, ...]):
    return axis_entry(data_axes) if batch > 1 else None


def serve_token_specs(batch: int, data_axes: Tuple[str, ...],
                      shape_ndim: int = 2):
    """Token batches for serving: batch over data axes (replicated if B=1)."""
    return P(_batch_axis(batch, data_axes), *([None] * (shape_ndim - 1)))


def cache_specs(cfg: ModelConfig, cache_shape, batch: int,
                data_axes: Tuple[str, ...], model_axis: str = "model",
                model_size: int = 16):
    """KV/recurrent caches: (L, B, ...) leaves — batch over data axes (if
    B > 1), head-ish dims over model (falling back to the head_dim axis when
    the head count does not divide the model-axis size)."""
    baxis = _batch_axis(batch, data_axes)

    def head_or_dim(nheads: int, hdim: int):
        """(head_spec, dim_spec) — shard whichever divides the model axis."""
        if nheads % model_size == 0:
            return model_axis, None
        if hdim % model_size == 0:
            return None, model_axis
        return None, None

    def assign(path, leaf):
        name = _keys(path)[-1]
        ndim = _ndim(leaf)
        if name in ("k", "v"):  # (L,B,W,Kv,hd)
            hs, ds = head_or_dim(cfg.num_kv_heads, cfg.head_dim)
            return P(None, baxis, None, hs, ds)
        if name in ("ckv", "krope"):  # (L,B,W,r): the latent, all heads
            return P(None, baxis, None, None)
        if name == "wkv":  # (L,B,H,hdk,hdv)
            hs, ds = head_or_dim(cfg.num_heads, cfg.rwkv_head_size)
            return P(None, baxis, hs, ds, None)
        if name in ("shift", "cm_shift"):  # (L,B,d)
            return P(None, baxis,
                     model_axis if cfg.d_model % model_size == 0 else None)
        if name == "ssm_state":  # (L,B,di,st)
            return P(None, baxis,
                     model_axis if cfg.d_model % model_size == 0 else None,
                     None)
        return P(*([None] * ndim))  # pos, slot_pos and anything else

    return tree_map_with_path(assign, cache_shape)


def axis_sizes(mesh) -> dict:
    """{axis name: size} of `mesh`: anything with `axis_names` and either
    `shape` (the port's meshes) or `devices.shape` (the reference's)."""
    shape = getattr(mesh, "shape", None)
    if shape is None or isinstance(shape, dict):
        shape = mesh.devices.shape
    return dict(zip(mesh.axis_names, tuple(shape)))


def sanitize_specs(specs, shapes, mesh):
    """Drop any spec axis whose mesh extent does not divide the array dim
    (an uneven split would leave shards of unequal size)."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        shape = tuple(getattr(leaf, "shape", ()))
        dims = list(spec) + [None] * (len(shape) - len(spec))
        out = []
        for i, e in enumerate(dims):
            if e is None:
                out.append(None)
                continue
            prod = 1
            for a in (e if isinstance(e, tuple) else (e,)):
                prod *= sizes[a]
            out.append(e if shape[i] % prod == 0 else None)
        return P(*out)

    return _zip_map(fix, specs, shapes)


def _zip_map(fn, specs, shapes):
    if isinstance(specs, dict):
        return {k: _zip_map(fn, v, shapes[k]) for k, v in specs.items()}
    return fn(specs, shapes)


def shard_shape(spec, shape, mesh) -> tuple:
    """The per-device shape of an array of `shape` under `spec` (a
    sanitized one: every named axis divides its dim)."""
    sizes = axis_sizes(mesh)
    dims = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for n, e in zip(shape, dims):
        div = 1
        for a in (() if e is None else e if isinstance(e, tuple) else (e,)):
            div *= sizes[a]
        out.append(n // div)
    return tuple(out)
