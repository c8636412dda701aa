"""The port's placement factories (`repro_torch/sharding/specs.py`)
against the JAX package's (`repro/sharding/specs.py`), leaf by leaf, at
full width and shapes only: the reference's trees come from
`jax.eval_shape`, the port's from the meta device as fake tensors
(`launch/dryrun.py::fake_params`); nothing is drawn or allocated. The
reference's `sanitize_specs` takes its tests' `FakeMesh`, the port's the
production meshes of `launch/mesh.py`.

Tolerance: none. A spec is a tuple of axis names, None or tuples of
names, and every one must equal the reference's exactly; so must the
set of leaves, but for the host-held entries each side names.
"""
import os

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.config import FedConfig as JFedConfig
from repro.configs import ARCHITECTURES as JARCHS
from repro.core import make_algorithm as jax_make_algorithm
from repro.models import Transformer as JTransformer
from repro import sharding as jsh
from repro_torch.config import FedConfig
from repro_torch.configs import get_config, list_architectures
from repro_torch.core.api import make_algorithm
from repro_torch.core.prng import prng_key
from repro_torch.launch.dryrun import fake_params
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import Transformer
from repro_torch import sharding as sh
from repro_torch.sharding.specs import P

ARCHS = list_architectures()
MESHES = {"16x16": False, "2x16x16": True}


class FakeMesh:
    """The reference tests' stand-in for a jax mesh."""

    def __init__(self, names, shape):
        self.axis_names = names

        class devices:
            pass

        devices.shape = shape
        self.devices = devices


def _jax_flat(specs):
    """{"a/b/c": tuple(spec)} of a reference spec tree."""
    leaves, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, JP))
    return {"/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path): tuple(spec) for path, spec in leaves}


def _port_flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_port_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v)
    return out


def _assert_same(port, ref, only_port=(), only_ref=()):
    p, r = _port_flat(port), _jax_flat(ref)
    assert set(p) - set(r) == set(only_port)
    assert set(r) - set(p) == set(only_ref)
    diff = {k: (p[k], r[k]) for k in set(p) & set(r) if p[k] != r[k]}
    assert not diff, diff


@pytest.fixture(scope="module")
def trees():
    """{arch: (the port's fake training tree, the reference's
    ShapeDtypeStruct tree)} at full width."""
    mode = FakeTensorMode()
    out = {}
    with mode:
        for a in ARCHS:
            out[a] = (fake_params(get_config(a)),
                      jax.eval_shape(JTransformer(JARCHS[a]).init,
                                     jax.random.PRNGKey(0)))
    return out, mode


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(trees, arch):
    port, ref = trees[0][arch]
    _assert_same(sh.param_specs(get_config(arch), port),
                 jsh.param_specs(JARCHS[arch], ref))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_sanitized_param_specs_match_on_the_production_meshes(trees, arch,
                                                              mesh):
    port, ref = trees[0][arch]
    pm = make_production_mesh(multi_pod=MESHES[mesh])
    jm = FakeMesh(pm.axis_names, pm.shape)
    _assert_same(
        sh.sanitize_specs(sh.param_specs(get_config(arch), port), port, pm),
        jsh.sanitize_specs(jsh.param_specs(JARCHS[arch], ref), ref, jm))


def _states(trees, arch, algo, fsdp_axes, replicate):
    port_params, ref_params = trees[0][arch]
    kw = dict(algorithm=algo, num_clients=16, h_policy="diag_ema",
              client_axes=("data",), fsdp_axes=fsdp_axes,
              replicate_params=replicate)
    fed, jfed = FedConfig(**kw), JFedConfig(**kw)
    with trees[1]:
        model = Transformer(get_config(arch), "cpu")
        pstate = make_algorithm(fed, model.loss, model=model).init(
            port_params, prng_key(1))
    jm = JTransformer(JARCHS[arch])
    jalgo = jax_make_algorithm(jfed, jm.loss, model=jm)
    jstate = jax.eval_shape(jalgo.init, ref_params,
                            jax.eval_shape(lambda: jax.random.PRNGKey(1)))
    return fed, jfed, pstate, jstate


@pytest.mark.parametrize("replicate", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("algo", ["fedgia", "fedavg", "scaffold"])
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "deepseek-v3-671b"])
def test_fed_state_specs_match_the_reference(trees, arch, algo, fsdp,
                                             replicate):
    fsdp_axes = (("model",) if replicate else ("pod",)) if fsdp else ()
    fed, jfed, pstate, jstate = _states(trees, arch, algo, fsdp_axes,
                                        replicate)
    cfg = get_config(arch)
    port = sh.fed_state_specs(fed, cfg, pstate)
    ref = jsh.fed_state_specs(jfed, JARCHS[arch], jstate)
    # the same entries: the port's round counter (an int) and key (numpy)
    # replicate as the reference's scalars do
    _assert_same(port, ref)
    pm = make_production_mesh(multi_pod=True)
    _assert_same(sh.sanitize_specs(port, pstate, pm),
                 jsh.sanitize_specs(ref, jstate,
                                    FakeMesh(pm.axis_names, pm.shape)))


def _jax_dryrun():
    """The reference's dry-run module, imported without keeping the
    512-device XLA_FLAGS it sets at import (a later subprocess of this
    worker would inherit them)."""
    saved = os.environ.get("XLA_FLAGS")
    from repro.launch import dryrun as jdr
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    return jdr


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_and_token_specs_match_the_reference(arch, mesh):
    from repro.config import INPUT_SHAPES as JSHAPES
    from repro_torch.config import INPUT_SHAPES
    from repro_torch.launch import dryrun as dr

    jdr = _jax_dryrun()
    pm = make_production_mesh(multi_pod=MESHES[mesh])
    client_axes = tuple(a for a in pm.axis_names if a != "model")[:1]
    for replicate in (False, True):
        kw = dict(num_clients=16, client_axes=client_axes,
                  replicate_params=replicate)
        pb = dr.input_specs(get_config(arch), INPUT_SHAPES["train_4k"], 16)
        jb = jdr.input_specs(JARCHS[arch], JSHAPES["train_4k"], 16)
        _assert_same(sh.train_batch_specs(FedConfig(**kw), pb, pm.axis_names),
                     jsh.train_batch_specs(JFedConfig(**kw), jb,
                                           pm.axis_names))
    data_axes = tuple(a for a in pm.axis_names if a != "model")
    for B in (1, 32):
        for nd in (1, 2, 3):
            assert (tuple(sh.serve_token_specs(B, data_axes, nd))
                    == tuple(jsh.serve_token_specs(B, data_axes, nd)))


@pytest.mark.parametrize("model_size", [16, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, model_size):
    cfg, jcfg = get_config(arch), JARCHS[arch]
    B, W = 4, 16
    with FakeTensorMode():
        cache = Transformer(cfg, "cpu").init_cache(B, W)
    jcache = jax.eval_shape(
        lambda: JTransformer(jcfg).init_cache(B, W, jnp.bfloat16))
    for axes in (("data",), ("pod", "data")):
        _assert_same(sh.cache_specs(cfg, cache, B, axes,
                                    model_size=model_size),
                     jsh.cache_specs(jcfg, jcache, B, axes,
                                     model_size=model_size))
        pm = FakeMesh(("data", "model"), (2, model_size))
        _assert_same(
            sh.sanitize_specs(sh.cache_specs(cfg, cache, B, ("data",),
                                             model_size=model_size),
                              cache, pm),
            jsh.sanitize_specs(jsh.cache_specs(jcfg, jcache, B, ("data",),
                                               model_size=model_size),
                               jcache, pm))


def test_sanitize_drops_nondivisible_axes():
    """The port's version of tests/test_sharding_multidevice.py's."""
    specs = {"a": P(None, "model"), "b": P("model")}
    with FakeTensorMode():
        shapes = {"a": torch.empty(4, 40), "b": torch.empty(7)}
    fixed = sh.sanitize_specs(specs, shapes, FakeMesh(("model",), (16,)))
    assert fixed["a"] == P(None, None)  # 40 % 16 != 0 -> dropped
    assert fixed["b"] == P(None)


def test_param_specs_shard_big_leaves(trees):
    """The port's version of tests/test_sharding_multidevice.py's: big
    matmul weights get a model-axis assignment."""
    params = trees[0]["tinyllama-1.1b"][0]
    specs = sh.param_specs(get_config("tinyllama-1.1b"), params)
    assert "model" in specs["groups/dense/attn/wq"]
    assert specs["groups/dense/mlp/w2"][1] == "model"  # stacked L dim first
    assert specs["final_norm/scale"] == P()


def test_shard_shape_divides_the_named_axes():
    pm = make_production_mesh(multi_pod=True)
    assert sh.shard_shape(P(("pod", "data"), None, "model"), (64, 3, 32),
                          pm) == (2, 3, 2)
    assert sh.shard_shape(P(), (5, 7), pm) == (5, 7)


def test_fed_config_checks_the_placement_knobs():
    with pytest.raises(ValueError, match="share"):
        FedConfig(client_axes=("data",), fsdp_axes=("data",))
    with pytest.raises(ValueError, match="repeats"):
        FedConfig(fsdp_axes=("model", "model"))
    assert FedConfig().fsdp_axes == () and not FedConfig().replicate_params
