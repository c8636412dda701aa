"""Multi-pod dry run: check that a distribution config holds together for
every (architecture x input shape x mesh) by tracing the step on fake
tensors, with nothing allocated and nothing computed (counterpart of
`repro/launch/dryrun.py`).

  train_4k     -> one FedGiA communication round (the paper's algorithm),
                  the flat round the engine runs, or a baseline's via --algo
  prefill_32k  -> Transformer.prefill (builds the KV cache)
  decode_32k   -> Transformer.decode_step: ONE token against a 32k cache
  long_500k    -> decode with 512k context: recurrent state (ssm/hybrid) or
                  sliding-window ring cache (all attention archs)

The reference lowers and compiles the step for XLA and reads its memory
and cost analyses. Here every tensor is a fake CPU tensor
(`torch._subclasses.fake_tensor.FakeTensorMode`; the parameters' shapes
come from the meta device, as `Transformer.load_params` takes them), the
mesh's `torch.distributed` group is fake (`launch/mesh.py::
fake_process_group`), and the step runs once under two dispatch modes:
`torch.utils.flop_counter.FlopCounterMode` and `Accountant` (below). The
kernels' wrappers send CPU tensors to their plain versions, the
reference's jnp computations, which its dry run costed too; they and the
models' recurrences run through `kernels.run_plain`, whose hook the
trace sets (`_plain_hook`).

A record holds, per device:
  argument_bytes  the step's inputs laid out by `sharding/specs.py` on the
                  mesh: each leaf's shard shape x its dtype's size (not its
                  storage: the port's initial π is a stride-0 view), the
                  reference's memory plan;
  output_bytes    the outputs that do not alias an input, laid out the
                  same way (a decode step writes its cache in place);
  temp_bytes      the traced step's peak of live intermediates, less what
                  it returns; a kernel's plain version holds none of its
                  own (the card's kernel keeps them on chip, and the
                  update writes into its wrapper's outputs);
  flops           FlopCounterMode's count (products: mm/bmm/... , as the
                  reference's cost analysis counts them);
  hbm_bytes       every aten op's input and output bytes: an upper bound
                  that assumes no fusion;
and the collectives by kind (`launch/cost_analysis.py`) and the three
roofline terms.

Costs are those of ONE client shard's step: under `client_axes` its
m_local clients, each client's batch split over the leftover data axes.
As in the reference, the step is traced at 1 and 2 layers a layer group
and extrapolated over the groups' depths; the memory terms with them.
The client axis's collectives are the ones the port's sharded round
issues on the fake group. The port runs no tensor parallelism: across
`model` its meshes replicate. Where the mesh's model axis is larger than
1, the record's "model_axis" is "modelled": the work that the specs
shard over `model` is divided by its size (every op on a model-sharded
weight or on an activation derived from one; the client states' flat
buffers by the specs' shard fraction), an all-reduce is added for each
product that contracts a model-sharded dim, and two all-to-alls each
way around each expert layer whose experts are model-sharded. Where the
per-client batch is split over leftover data axes, one all-reduce of the
gradients over them is added. FSDP's gathers are not modelled.

The recurrences (RWKV-6's WKV, the hybrid SSM scan) loop over time in
Python in their plain versions: the trace runs their first `T_PROBE`
steps and adds the rest with the reference's per-step formulas
(`_recurrence_correction`, "recurrence": "analytic"); at T <= T_PROBE
the trace holds every step ("traced").

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \
      --shape train_4k [--multi-pod] [--algo fedgia|fedavg] [--unrolled]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
import weakref
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.config import (
    FedConfig, INPUT_SHAPES, ModelConfig, ShapeConfig)
from repro_torch.configs import get_config, list_architectures
from repro_torch.core import api, engine
from repro_torch.core.api import make_algorithm
from repro_torch.core.prng import prng_key
from repro_torch.kernels import plain_hook
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch.mesh import (
    AbstractMesh, fake_process_group, make_production_mesh)
from repro_torch.models.transformer import (
    Transformer, _Draws, _draw, _layer_groups)
from repro_torch.sharding import specs as sp
from repro_torch.utils import pytree as pt

# steps of a recurrence that the trace runs; the rest are added
# analytically (`_recurrence_correction`)
T_PROBE = 16


class Shaped(NamedTuple):
    """A stand-in for an input: its shape and dtype, nothing allocated."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# --------------------------------------------------------------- input specs
def input_specs(cfg: ModelConfig, shape: ShapeConfig, num_clients: int = 0):
    """`Shaped` stand-ins for every model input (no allocation), the
    reference's shapes and dtypes (int32 tokens, bf16 embeddings)."""
    B, S = shape.global_batch, shape.seq_len
    tok, emb = torch.int32, torch.bfloat16
    if shape.kind == "train":
        m = num_clients
        bc = max(B // m, 1)
        if cfg.input_mode == "tokens":
            return {"tokens": Shaped((m, bc, S + 1), tok)}
        if cfg.input_mode == "embeds":
            return {"embeds": Shaped((m, bc, S, cfg.d_model), emb),
                    "labels": Shaped((m, bc, S), tok)}
        P_img = cfg.embed_prefix_len
        return {"embeds": Shaped((m, bc, P_img, cfg.d_model), emb),
                "tokens": Shaped((m, bc, S - P_img + 1), tok)}
    if shape.kind == "prefill":
        if cfg.input_mode == "embeds":
            return {"embeds": Shaped((B, S, cfg.d_model), emb)}
        if cfg.input_mode == "tokens+embeds":
            P_img = cfg.embed_prefix_len
            return {"embeds": Shaped((B, P_img, cfg.d_model), emb),
                    "tokens": Shaped((B, S - P_img), tok)}
        return {"tokens": Shaped((B, S), tok)}
    # decode: ONE new token; the cache IS the context
    return {"tokens": Shaped((B, 1), tok)}


def _cache_len(cfg: ModelConfig, shape: ShapeConfig):
    if shape.name == "long_500k":
        return min(cfg.sliding_window, shape.seq_len)
    return shape.seq_len


def _decode_window(cfg: ModelConfig, shape: ShapeConfig):
    return cfg.sliding_window if shape.name == "long_500k" else None


# ------------------------------------------------------------- accounting
_PRODUCTS = {"mm", "addmm", "bmm", "baddbmm"}
_COPIES = {"clone", "_to_copy"}
# ops that move no bytes: allocations and metadata
_FREE = {"empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "detach", "alias",
         "lift_fresh", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_local_scalar_dense"}
# the c10d ops the port's rounds issue (`core/api.py`), by kind
_C10D = {"allreduce_": "all-reduce", "_reduce_scatter_base_": "reduce-scatter",
         "_allgather_base_": "all-gather", "allgather_": "all-gather",
         "barrier": None}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class _Weight(NamedTuple):
    start: int  # storage offsets [start, end) of the leaf
    end: int
    stride: int  # stride and size of its model-sharded dim
    size: int
    key: str


class Accountant(TorchDispatchMode):
    """Counts a traced step's costs op by op: HBM bytes (every op's
    tensor inputs and outputs, views and allocations excluded), the
    peak of live bytes the step allocated (a storage counts from the op
    that makes it until it is freed), the collectives it issues on a
    fake group.

    With `model_size` M > 1 it models tensor parallelism over `model`
    (see the module docstring): weights whose sanitized spec names
    `model` are registered (`register_weight`) with the stride and size
    of that dim; an op on such a weight, or on an
    activation made from one ("tainted"), counts 1/M of its FLOPs and
    bytes and makes tainted outputs, except a product that contracts the
    weight's sharded dim: that one's output is all-reduced over `model`
    (a record) and replicated again. `flat` = (padded size, fraction):
    a tensor whose last dim is the flat buffer's counts that fraction of
    its bytes (the specs' shard fraction of the parameters)."""

    def __init__(self, model_size: int = 1, flat=None, client_axes=(),
                 d_model: int = 0):
        super().__init__()
        self.M = model_size
        self.flat = flat
        self.client_axes = tuple(client_axes)
        self.d_model = d_model
        self.flops_scale = 0.0  # what FlopCounterMode's total loses
        self.bytes = 0.0
        self.live = 0.0
        self.peak = 0.0
        self.collectives = []
        self._fused = 0
        # keyed by id(storage), each entry dropped when its storage dies
        self._tracked: Dict[int, float] = {}
        self._weights: Dict[int, list] = {}
        self._taint: Dict[int, bool] = {}

    # ---------------------------------------------------------- registries
    def _sid(self, t) -> Optional[int]:
        try:
            return id(t.untyped_storage())
        except (RuntimeError, NotImplementedError):
            return None

    def _keep(self, table, t, value):
        """table[id(storage)] = value until the storage dies."""
        st = t.untyped_storage()
        sid = id(st)
        if sid not in table:
            weakref.finalize(st, table.pop, sid, None)
        table[sid] = value

    def register_weight(self, t: torch.Tensor, dim: int, key: str) -> None:
        """`t` (a whole leaf) is model-sharded on its dim `dim`."""
        w = _Weight(t.storage_offset(), t.storage_offset() + t.numel(),
                    t.stride(dim), t.shape[dim], key)
        sid = self._sid(t)
        entries = [e for e in self._weights.get(sid, [])
                   if e.end <= w.start or e.start >= w.end]
        self._keep(self._weights, t, entries + [w])

    def _weight_of(self, t) -> Optional[_Weight]:
        entries = self._weights.get(self._sid(t))
        if not entries:
            return None
        off = t.storage_offset()
        for e in entries:
            if e.start <= off < e.end:
                return e
        return None

    def _tainted(self, t) -> bool:
        return self._sid(t) in self._taint

    def _sharded_dim(self, t, w: _Weight) -> Optional[int]:
        for i, (n, s) in enumerate(zip(t.shape, t.stride())):
            if n == w.size and s == w.stride and n > 1:
                return i
        return None

    # ------------------------------------------------------------- memory
    def _scale(self, t, sharded: bool) -> float:
        if sharded:
            return 1.0 / self.M
        if self.flat is not None and t.dim() and t.shape[-1] == self.flat[0]:
            return self.flat[1]
        return 1.0

    def _track(self, t, scale: float) -> None:
        st = t.untyped_storage()
        sid = id(st)
        if sid in self._tracked:
            return
        n = st.nbytes() * scale
        self._tracked[sid] = n
        weakref.finalize(st, self._free, sid)
        self.live += n
        if not self._fused:
            self.peak = max(self.peak, self.live)

    def _free(self, sid) -> None:
        self.live -= self._tracked.pop(sid, 0.0)

    @contextlib.contextmanager
    def fused(self):
        """A kernel's plain version: its ops are costed, but its
        intermediates are not held against the peak (the kernel keeps
        them on chip); what it returns is."""
        self._fused += 1
        try:
            yield
        finally:
            self._fused -= 1
            if not self._fused:
                self.peak = max(self.peak, self.live)

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._overloadpacket.__name__
        if ns == "c10d":
            self._collective(name, args, out)
            return out
        if ns == "prim":
            return out
        if name in _FREE:
            self._track_outputs(func, out, False)
            return out
        if func.is_view:
            return out
        ins = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        weight, tainted = None, False
        if self.M > 1:
            for t in ins:
                w = self._weight_of(t)
                if w is not None and weight is None:
                    weight = (t, w)
                tainted = tainted or self._tainted(t)
        sharded = weight is not None or tainted
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            if sharded:
                self.flops_scale += f * (1.0 - 1.0 / self.M)
        self.bytes += sum(_nbytes(t) * self._scale(t, sharded)
                          for t in ins + outs)
        taint_out = sharded
        if weight is not None and name in _COPIES:
            t, w = weight
            dim = self._sharded_dim(t, w)
            for o in outs:
                if dim is not None and o.shape == t.shape:
                    self.register_weight(o, dim, w.key)
            taint_out = False
        elif weight is not None and name in _PRODUCTS:
            taint_out = not self._product(name, args, out, weight)
        if taint_out:
            for o in outs:
                if o.numel() > 1:
                    self._keep(self._taint, o, True)
        self._track_outputs(func, out, sharded)
        return out

    def _track_outputs(self, func, out, sharded):
        returns = func._schema.returns
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for r, o in zip(returns, outs):
            if r.alias_info is not None:  # in place or a view
                continue
            for t in tree_leaves(o):
                if isinstance(t, torch.Tensor):
                    self._track(t, self._scale(t, sharded))

    def _product(self, name, args, out, weight) -> bool:
        """Record the collectives a product on a model-sharded weight
        implies; returns whether its output is replicated again (the
        sharded dim was contracted, so an all-reduce sums the parts)."""
        t, w = weight
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm") else args[:2]
        dim = self._sharded_dim(t, w)
        contracted = dim is not None and (
            (t is b and dim == b.dim() - 2) or (t is a and dim == a.dim() - 1))
        if contracted:
            self.collectives.append(("all-reduce", out.dtype,
                                     tuple(out.shape), "model"))
        keys = w.key.split("/")
        if "experts" in keys and keys[-1] == "w1":
            act = a if t is b else b
            moved = act if act.shape[-1] == self.d_model else out
            for _ in range(2):  # dispatch and combine
                self.collectives.append(("all-to-all", moved.dtype,
                                         tuple(moved.shape), "model"))
        return contracted

    def _collective(self, name, args, out):
        if name not in _C10D:
            raise NotImplementedError(f"collective c10d.{name} is not costed")
        kind = _C10D[name]
        if kind is None:
            return
        first = args[0]
        tensors = [first] if isinstance(first, torch.Tensor) else list(
            tree_leaves(first))
        for t in tensors:
            self.collectives.append((kind, t.dtype, tuple(t.shape),
                                     self.client_axes))


# the kernels' plain versions, costed as their kernels: the update's
# results land in its wrapper's outputs, attention and the scan keep
# their intermediates on chip
_FUSED = ("fedgia_update", "flash_attention", "rwkv6_scan")
# the recurrences' time dim: (r, k, v, w) or (u, dt, B, C) vary along it
_PROBED = {"rwkv6_scan": 2, "wkv6_scan": 1, "ssm_scan": 1}


def _probed(fn, tdim):
    """`fn` on its first T_PROBE steps, the rest of its output zeros."""
    def run(*a):
        T = a[0].shape[tdim]
        if T <= T_PROBE:
            return fn(*a)
        a = [x.narrow(tdim, 0, T_PROBE) if i < 4 else x
             for i, x in enumerate(a)]
        y, state = fn(*a)
        rest = list(y.shape)
        rest[tdim] = T - T_PROBE
        return torch.cat([y, y.new_zeros(rest)], dim=tdim), state
    return run


def _plain_hook(acct: Accountant):
    """The `kernels.run_plain` hook of a trace: each kernel's plain
    version under `acct.fused()`, each recurrence probed."""
    def hook(name, fn, args, kwargs):
        if name in _PROBED:
            fn = _probed(fn, _PROBED[name])
        if name not in _FUSED:
            return fn(*args, **kwargs)
        with acct.fused():
            return fn(*args, **kwargs)
    return hook


class _TaggingSpec:
    """A `RavelSpec` whose `unravel` registers each leaf view of the flat
    buffer with the accountant (the train step's parameters are views of
    x̄, cast to the model's dtype)."""

    def __init__(self, spec, acct: Accountant, dims: Dict[str, int]):
        self._spec, self._acct, self._dims = spec, acct, dims

    def __getattr__(self, name):
        return getattr(self._spec, name)

    def unravel(self, flat):
        """The leaves as views of `flat`: (N,) x̄, or an (m, N) buffer of
        per-client parameters (a baseline's), whose leaves lead with m."""
        out = self._spec.unravel(flat)
        lead = flat.dim() - 1
        for k, v in out.items():
            if k in self._dims:
                self._acct.register_weight(v, self._dims[k] + lead, k)
        return out


# --------------------------------------------------------------- builders
def _model_dims(specs) -> Dict[str, int]:
    """{leaf key: the dim a sanitized spec puts `model` on}."""
    out = {}
    for k, s in specs.items():
        for i, e in enumerate(s):
            if e == "model" or (isinstance(e, tuple) and "model" in e):
                out[k] = i
    return out


def _shard_bytes(tree, specs, mesh) -> int:
    """Per-device bytes of `tree` (tensors, `Shaped` or host values,
    which hold none on the device) laid out by `specs` on `mesh`."""
    if isinstance(tree, dict):
        return sum(_shard_bytes(v, specs[k], mesh) for k, v in tree.items())
    if not hasattr(tree, "dtype") or not isinstance(tree.dtype, torch.dtype):
        return 0  # an int round counter, a numpy key: kept on the host
    shape = sp.shard_shape(specs, tuple(tree.shape), mesh)
    return math.prod(shape) * tree.dtype.itemsize


def _fake(x):
    """A fake tensor for a `Shaped` (inside the fake mode)."""
    return torch.empty(x.shape, dtype=x.dtype)


def fake_params(cfg: ModelConfig) -> dict:
    """The training tree's leaves as fake tensors (inside the fake mode):
    the shapes and dtypes from the meta device, nothing drawn."""
    meta = _draw(cfg, prng_key(0), _Draws(getattr(torch, cfg.dtype),
                                          torch.device("meta")))
    return {k: torch.empty(t.shape, dtype=t.dtype) for k, t in meta.items()}


def _tokens_long(batch):
    """The port's models index with int64: the reference's int32 inputs
    are widened inside the step."""
    return {k: v.long() if not v.is_floating_point() else v
            for k, v in batch.items()}


@dataclasses.dataclass
class Step:
    """A traced step: `run()` (under the fake mode and the accountant)
    returns its outputs; `argument_bytes` and `output_bytes` are the
    memory plan of its full-size inputs and outputs on the mesh."""
    run: object
    argument_bytes: int
    output_bytes: object  # callable(outputs of run) -> int
    register: object  # callable(acct): registers the weights
    flat: Optional[Tuple[int, float]] = None
    batch_local: int = 1  # sequences a device's step runs


def build_train(cfg, shape, fed: FedConfig, mesh, algo_name="fedgia",
                fmesh=None) -> Step:
    """One round of `algo_name` (the flat round `engine` runs, with the
    donated update) on one client shard's rows and batch."""
    model = Transformer(cfg, "cpu")
    fed = dataclasses.replace(fed, algorithm=algo_name)
    algo = make_algorithm(fed, model.loss, model=model)
    params = fake_params(cfg)
    state = algo.init(params, prng_key(1))
    batch_sds = input_specs(cfg, shape, fed.num_clients)
    names = tuple(mesh.axis_names)

    state_specs = sp.sanitize_specs(sp.fed_state_specs(fed, cfg, state),
                                    state, mesh)
    batch_specs = sp.sanitize_specs(
        sp.train_batch_specs(fed, batch_sds, names), batch_sds, mesh)
    arg_bytes = (_shard_bytes(state, state_specs, mesh)
                 + _shard_bytes(batch_sds, batch_specs, mesh))

    sizes = sp.axis_sizes(mesh)
    shards = math.prod(sizes[a] for a in fed.client_axes)
    m_local = fed.num_clients // shards
    axis = (fmesh.client_axis(sp.axis_entry(fed.client_axes))
            if fmesh is not None and shards > 1 else None)
    batch = _local(batch_sds, batch_specs, mesh)
    local = state
    if axis is not None:
        local, _ = engine.shard_inputs(algo, state, {}, fmesh,
                                       sp.axis_entry(fed.client_axes))
    spec = pt.ravel_spec(local["x"])
    flat_state = engine.flatten_state(algo, local, spec)
    xspecs = state_specs["x"]  # the param rules, or none replicated
    dims = _model_dims(xspecs)
    full = sum(math.prod(s) for s in spec.shapes)
    shard = sum(math.prod(sp.shard_shape(xspecs[k], s, mesh))
                for k, s in zip(spec.keys, spec.shapes))
    # the axes a client's batch is split over (dim 1 of its leaves)
    split = sorted({a for s in batch_specs.values() if len(s) > 1
                    and s[1] is not None
                    for a in (s[1] if isinstance(s[1], tuple) else (s[1],))},
                   key=names.index)
    holder = {}

    def register(acct):
        holder["acct"] = acct
        holder["spec"] = _TaggingSpec(spec, acct, dims)
        # a baseline's per-client parameters are views of its (m, N) buffer
        holder["spec"].unravel_stacked = holder["spec"].unravel

    def run():
        st = {k: v for k, v in flat_state.items()}
        ctx = (api.client_sharding(axis) if axis is not None
               else contextlib.nullcontext())
        with ctx:
            new, met = algo.round_flat(st, _tokens_long(batch),
                                       holder["spec"], donate_kernel=True)
        if split:
            # data parallelism within a client: its gradients are summed
            # over the axes its batch is split over
            holder["acct"].collectives.append((
                "all-reduce", model.dtype, (m_local, shard), tuple(split)))
        return (st, new, met)

    def output_bytes(outs):
        st_in, new, met = outs
        aliased = {k for k, v in new.items() if torch.is_tensor(v)
                   and k in st_in and torch.is_tensor(st_in[k])
                   and v.untyped_storage() is st_in[k].untyped_storage()}
        total = sum(_shard_bytes(state[k], state_specs[k], mesh)
                    for k in new if k in state and k not in aliased)
        return total + sum(_nbytes(v) for v in tree_leaves(met)
                           if torch.is_tensor(v))

    return Step(run, arg_bytes, output_bytes, register,
                flat=(spec.padded_size, shard / full),
                batch_local=m_local * next(iter(batch.values())).shape[1])


def _serve_params(cfg, mesh):
    model = Transformer(cfg, "cpu")
    params = fake_params(cfg)
    model.params = params
    pspecs = sp.sanitize_specs(sp.param_specs(cfg, params), params, mesh)
    dims = _model_dims(pspecs)

    def register(acct):
        for k, d in dims.items():
            acct.register_weight(params[k], d, k)

    return model, params, pspecs, register


def _data_axes(mesh):
    return tuple(a for a in mesh.axis_names if a != "model")


def _batch_spec(batch_sds, B, data_axes, mesh):
    specs = {k: sp.serve_token_specs(B, data_axes, len(v.shape))
             for k, v in batch_sds.items()}
    return sp.sanitize_specs(specs, batch_sds, mesh)


def _cache_plan(cfg, model, B, W, cache_dtype, mesh):
    """The full cache (fake) and its sanitized specs."""
    cache = model.init_cache(B, W, cache_dtype)
    msize = sp.axis_sizes(mesh)["model"]
    cspec = sp.sanitize_specs(
        sp.cache_specs(cfg, cache, B, _data_axes(mesh), model_size=msize),
        cache, mesh)
    return cache, cspec


def _logit_bytes(logits, B, mesh):
    spec = sp.sanitize_specs(sp.serve_token_specs(B, _data_axes(mesh)),
                             logits, mesh)
    return _shard_bytes(logits, spec, mesh)


def _local(tree, specs, mesh):
    """Fake tensors of `tree`'s per-device shapes under `specs`."""
    if isinstance(tree, dict):
        return {k: _local(v, specs[k], mesh) for k, v in tree.items()}
    return _fake(Shaped(sp.shard_shape(specs, tuple(tree.shape), mesh),
                        tree.dtype))


def _off_model(specs):
    """`specs` without the `model` axis: the trace runs the model at full
    width (its `model` axis is modelled), so a cache keeps its heads."""
    return sp.tree_map_with_path(
        lambda _, s: sp.P(*(None if e == "model" else e for e in s)), specs)


def build_prefill(cfg, shape, mesh) -> Step:
    model, params, pspecs, register = _serve_params(cfg, mesh)
    W = _cache_len(cfg, shape)
    B = shape.global_batch
    batch_sds = input_specs(cfg, shape)
    bspec = _batch_spec(batch_sds, B, _data_axes(mesh), mesh)
    arg_bytes = (_shard_bytes(params, pspecs, mesh)
                 + _shard_bytes(batch_sds, bspec, mesh))
    batch = _local(batch_sds, bspec, mesh)
    B_local = next(iter(batch.values())).shape[0]
    cache, cspec = _cache_plan(cfg, model, B, W, None, mesh)
    logits = Shaped((B, cfg.vocab_size), model.dtype)

    def run():
        b = _tokens_long(batch)
        return model.prefill(b.get("tokens"), embeds=b.get("embeds"),
                             cache_len=W)

    def output_bytes(outs):
        return (_logit_bytes(logits, B, mesh)
                + _shard_bytes(cache, cspec, mesh))

    return Step(run, arg_bytes, output_bytes, register, batch_local=B_local)


def build_decode(cfg, shape, mesh, cache_dtype=torch.bfloat16) -> Step:
    model, params, pspecs, register = _serve_params(cfg, mesh)
    W = _cache_len(cfg, shape)
    B = shape.global_batch
    window = _decode_window(cfg, shape)
    cache_full, cspec = _cache_plan(cfg, model, B, W, cache_dtype, mesh)
    tok = Shaped((B, 1), torch.int32)
    pos = Shaped((), torch.int32)
    tspec = sp.sanitize_specs(sp.serve_token_specs(B, _data_axes(mesh)),
                              tok, mesh)
    arg_bytes = (_shard_bytes(params, pspecs, mesh)
                 + _shard_bytes(cache_full, cspec, mesh)
                 + _shard_bytes(tok, tspec, mesh)
                 + _shard_bytes(pos, sp.P(), mesh))
    cache = _local(cache_full, _off_model(cspec), mesh)
    tokens = _local(tok, tspec, mesh)
    p = _fake(pos)
    logits = Shaped((B, cfg.vocab_size), model.dtype)

    def run():
        return model.decode_step(cache, tokens.long(), p, window=window)

    def output_bytes(outs):  # the cache is written in place
        return _logit_bytes(logits, B, mesh)

    return Step(run, arg_bytes, output_bytes, register,
                batch_local=tokens.shape[0])


# ----------------------------------------------------- cost extrapolation
# The cost pass traces small variants with 1 and 2 layers per group and
# extrapolates: total = f(base) + sum_g (L_g - 1) * [f(base + e_g) - f(base)]
# (the reference's scheme, there because XLA counts a lax.scan body once;
# here because tracing every layer of the largest models costs minutes).
def _group_counts(cfg):
    return {g.name: g.count for g in _layer_groups(cfg)}


def _small_cfg(cfg, counts):
    total = sum(counts.values())
    changes = dict(num_layers=total)
    if cfg.moe and cfg.first_dense_layers:
        changes["first_dense_layers"] = counts.get("dense", 0)
    return dataclasses.replace(cfg, **changes)


def _build(cfg, shape, fed, mesh, algo_name, cache_dtype, fmesh):
    if shape.kind == "train":
        return build_train(cfg, shape, fed, mesh, algo_name, fmesh)
    if shape.kind == "prefill":
        return build_prefill(cfg, shape, mesh)
    return build_decode(cfg, shape, mesh, cache_dtype)


def _trace_costs(cfg, shape, fed, mesh, algo_name, cache_dtype,
                 fmesh) -> dict:
    """Trace one step of `cfg` on fake tensors; its costs per device."""
    msize = sp.axis_sizes(mesh).get("model", 1)
    mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode:
        step = _build(cfg, shape, fed, mesh, algo_name, cache_dtype, fmesh)
        acct = Accountant(msize, step.flat, fed.client_axes, cfg.d_model)
        step.register(acct)
        with plain_hook(_plain_hook(acct)), \
                FlopCounterMode(display=False) as fc, acct:
            outs = step.run()
        out_bytes = step.output_bytes(outs)
        live_end = acct.live
        del outs
    coll = ca.collective_bytes(acct.collectives)
    return {
        "flops": float(fc.get_total_flops()) - acct.flops_scale,
        "bytes": acct.bytes,
        "coll_total": coll["total"],
        "coll_wire": coll["wire_bytes"],
        "coll": {k: coll[k] for k in ca.COLLECTIVES},
        "coll_counts": {k: float(sum(1 for r in acct.collectives
                                     if r[0] == k)) for k in ca.COLLECTIVES},
        "wire_by_axis": coll["wire_by_axis"],
        "peak": acct.peak,
        "live_end": live_end,
        "argument_bytes": step.argument_bytes,
        "output_bytes": out_bytes,
        "batch_local": step.batch_local,
    }


def _recurrence_correction(cfg, shape, batch_local, model_size=1):
    """Per-device analytic cost of the recurrence steps the trace did not
    run (all but the first T_PROBE a layer), the reference's per-step
    formulas on this device's `batch_local` sequences."""
    if cfg.attention_type not in ("rwkv", "hybrid") or shape.kind == "decode":
        return {}
    T = shape.seq_len
    if T <= T_PROBE:
        return {}
    bwd_factor = 3.0 if shape.kind == "train" else 1.0  # fwd + ~2x bwd
    B = batch_local
    if cfg.attention_type == "rwkv":
        hd = cfg.rwkv_head_size
        step_flops = 10.0 * B * cfg.num_heads * hd * hd
        step_bytes = 4.0 * B * cfg.num_heads * hd * hd * 4  # state r/w fp32
    else:  # hybrid mamba branch
        step_flops = 8.0 * B * cfg.d_model * cfg.ssm_state
        step_bytes = 4.0 * B * cfg.d_model * cfg.ssm_state * 4
    n = cfg.num_layers * (T - T_PROBE) * bwd_factor / model_size
    return {"flops": n * step_flops, "bytes": n * step_bytes}


_LINEAR = ("flops", "bytes", "coll_total", "coll_wire", "peak", "live_end",
           "output_bytes")
_BY_KEY = ("coll", "coll_counts", "wire_by_axis")


def extrapolated_costs(cfg, shape, fed, mesh, algo_name,
                       cache_dtype=torch.bfloat16, fmesh=None,
                       with_costs=True):
    """The step's per-device costs at full depth: traced at 1 layer a
    group and, with `with_costs`, at 2 layers in each group in turn,
    extrapolated over the groups' depths; plus the recurrences' untraced
    steps. Without `with_costs` every group counts one layer (as the
    reference's scan-lowered costs count one). The argument bytes are of
    the full-depth config."""
    counts_full = _group_counts(cfg)
    base = {name: 1 for name in counts_full}
    args = (shape, fed, mesh, algo_name, cache_dtype, fmesh)
    f_base = _trace_costs(_small_cfg(cfg, base), *args)
    totals = dict(f_base)
    for key in _BY_KEY:
        totals[key] = dict(f_base[key])
    for name, L in counts_full.items():
        if L <= 1 or not with_costs:
            continue
        plus = dict(base)
        plus[name] += 1
        f_plus = _trace_costs(_small_cfg(cfg, plus), *args)
        for k in _LINEAR:
            totals[k] += (L - 1) * max(f_plus[k] - f_base[k], 0.0)
        for key in _BY_KEY:
            for a in set(f_plus[key]) | set(f_base[key]):
                d = f_plus[key].get(a, 0.0) - f_base[key].get(a, 0.0)
                totals[key][a] = (totals[key].get(a, 0.0)
                                  + (L - 1) * max(d, 0.0))
    msize = sp.axis_sizes(mesh).get("model", 1)
    corr = _recurrence_correction(cfg, shape, f_base["batch_local"], msize)
    for k, v in corr.items():
        totals[k] += v
    totals["recurrence"] = ("analytic" if corr else "traced") if (
        cfg.attention_type in ("rwkv", "hybrid")) else None
    totals["argument_bytes"] = _argument_bytes(cfg, *args)
    return totals


def _argument_bytes(cfg, shape, fed, mesh, algo_name, cache_dtype, fmesh):
    """The full-depth config's argument bytes (its memory plan; nothing
    is traced)."""
    with FakeTensorMode():
        return _build(cfg, shape, fed, mesh, algo_name, cache_dtype,
                      fmesh).argument_bytes


# ------------------------------------------------------------------- dry run
def _fed_for(mesh, algo, collapsed, num_clients, client_axes, fsdp,
             replicate_params, state_dtype):
    if num_clients == 0:
        sizes = sp.axis_sizes(mesh)
        num_clients = math.prod(sizes[a] for a in client_axes)
    # FSDP shards client states over the leftover data axes; with
    # replicate_params (no TP) the model axis is free for state sharding
    # too — the elementwise FedGiA update is sharding-agnostic.
    fsdp_axes = tuple(
        a for a in mesh.axis_names
        if a not in client_axes and (a != "model" or replicate_params)
    ) if fsdp else ()
    return FedConfig(
        algorithm=algo, num_clients=num_clients, k0=5, alpha=0.5,
        collapsed=collapsed, h_policy="scalar",
        client_axes=tuple(client_axes), fsdp_axes=fsdp_axes,
        replicate_params=replicate_params, state_dtype=state_dtype)


def dryrun_one(arch, shape_name, *, multi_pod: bool = False,
               algo: str = "fedgia", collapsed: bool = True,
               num_clients: int = 0, verbose: bool = True,
               with_costs: bool = True, client_axes=None,
               fsdp: bool = False, replicate_params: bool = False,
               cache_dtype="bfloat16", mesh: Optional[AbstractMesh] = None,
               state_dtype: str = "bfloat16"):
    """The record of one (architecture, input shape, mesh). `arch`: a
    name or a `ModelConfig`; `shape_name`: a name of `INPUT_SHAPES` or a
    `ShapeConfig`; `mesh`: default the production mesh (`multi_pod`).
    `state_dtype` is the FedGiA state's (the reference's dry run keeps it
    in bfloat16)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = (INPUT_SHAPES[shape_name] if isinstance(shape_name, str)
             else shape_name)
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    if client_axes is None:
        client_axes = tuple(a for a in mesh.axis_names if a != "model")
    fed = _fed_for(mesh, algo, collapsed, num_clients, client_axes, fsdp,
                   replicate_params, state_dtype)
    num_clients = fed.num_clients
    cdt = getattr(torch, cache_dtype) if isinstance(cache_dtype, str) \
        else cache_dtype
    msize = sp.axis_sizes(mesh).get("model", 1)

    t0 = time.time()
    with (fake_process_group(mesh) if mesh.size > 1
          else contextlib.nullcontext()) as fmesh:
        ext = extrapolated_costs(cfg, shape, fed, mesh, algo,
                                 cache_dtype=cdt, fmesh=fmesh,
                                 with_costs=with_costs)
    t_trace = time.time() - t0
    coll = dict(ext["coll"])
    coll["total"] = ext["coll_total"]
    coll["wire_bytes"] = ext["coll_wire"]
    coll["wire_by_axis"] = ext["wire_by_axis"]
    coll["counts"] = {k: int(round(v)) for k, v in ext["coll_counts"].items()}
    cost = {"flops": ext["flops"], "bytes accessed": ext["bytes"]}
    terms = ca.roofline_terms(cost, coll, ca.axis_bandwidth(mesh))
    temp = max(ext["peak"] - ext["live_end"], 0.0)

    rec = {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": mesh.tag,
        "algo": algo if shape.kind == "train" else "serve",
        "collapsed": collapsed,
        "client_axes": list(client_axes),
        "fsdp": fsdp,
        "replicate_params": replicate_params,
        "num_clients": num_clients if shape.kind == "train" else 0,
        "t_trace_s": round(t_trace, 2),
        "model_axis": "modelled" if msize > 1 else "none",
        "recurrence": ext["recurrence"],
        "per_device": {
            "argument_bytes": int(ext["argument_bytes"]),
            "output_bytes": int(ext["output_bytes"]),
            "temp_bytes": int(temp),
            "flops": terms["hlo_flops"],
            "hbm_bytes": terms["hlo_bytes"],
        },
        "collectives": coll,
        "roofline": {
            k: terms[k]
            for k in ("t_compute_s", "t_memory_s", "t_collective_s",
                      "bottleneck")
        },
    }
    if verbose:
        pd = rec["per_device"]
        fit_gb = (pd["argument_bytes"] + pd["output_bytes"]
                  + pd["temp_bytes"]) / 2**30
        print(f"[dryrun] {cfg.name} {shape.name} mesh={rec['mesh']} "
              f"algo={rec['algo']} trace={t_trace:.1f}s "
              f"model_axis={rec['model_axis']}")
        print(f"  per-card: args+out+temp={fit_gb:.2f} GiB"
              f" flops={terms['hlo_flops']:.3e} hbm={terms['hlo_bytes']:.3e}"
              f" coll={coll['total']:.3e}B")
        print(f"  roofline: compute={terms['t_compute_s']*1e3:.3f}ms"
              f" memory={terms['t_memory_s']*1e3:.3f}ms"
              f" collective={terms['t_collective_s']*1e3:.3f}ms"
              f" -> {terms['bottleneck']}-bound")
    return rec


def record_path(out, arch, shape, multi_pod, algo, unrolled, tag=""):
    name = f"{arch}_{shape}_{'2pod' if multi_pod else '1pod'}_{algo}" + (
        "_unrolled" if unrolled else "") + (f"_{tag}" if tag else "")
    return os.path.join(out, name + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", choices=list_architectures())
    ap.add_argument("--shape", choices=sorted(INPUT_SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--algo", default="fedgia")
    ap.add_argument("--unrolled", action="store_true",
                    help="paper-faithful unrolled k0-step ADMM (vs collapsed)")
    ap.add_argument("--num-clients", type=int, default=0)
    ap.add_argument("--no-costs", action="store_true",
                    help="skip the 2-layer traces: costs count one layer "
                         "a group")
    ap.add_argument("--client-axes", default="",
                    help="comma-sep mesh axes enumerating clients (e.g. pod)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard client states over the leftover data axes")
    ap.add_argument("--replicate-params", action="store_true",
                    help="pure DP within clients (no tensor parallelism)")
    ap.add_argument("--cache-dtype", default="bfloat16",
                    help="KV-cache dtype for decode shapes "
                         "(e.g. float8_e4m3fn)")
    ap.add_argument("--tag", default="", help="suffix for the output file")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    os.makedirs(args.out, exist_ok=True)
    combos = ([(a, s) for a in list_architectures() for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = []
    t0 = time.time()
    for arch, shape in combos:
        path = record_path(args.out, arch, shape, args.multi_pod, args.algo,
                           args.unrolled, args.tag)
        try:
            rec = dryrun_one(
                arch, shape, multi_pod=args.multi_pod, algo=args.algo,
                collapsed=not args.unrolled, num_clients=args.num_clients,
                with_costs=not args.no_costs,
                client_axes=(tuple(args.client_axes.split(","))
                             if args.client_axes else None),
                fsdp=args.fsdp, replicate_params=args.replicate_params,
                cache_dtype=args.cache_dtype,
            )
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures.append((arch, shape, repr(e)))
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall {len(combos)} dry runs traced OK "
          f"({time.time() - t0:.1f}s on the host)")


if __name__ == "__main__":
    main()
