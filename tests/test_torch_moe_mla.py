"""The port's MoE layer, MLA attention and MTP head against the JAX
package's, at reduced size (deepseek-v3-671b and arctic-480b), and the
threefry draw's 64-bit counters that their full-width expert leaves need.

Tolerances:

* `moe_apply` in float32: output and aux at rtol 1e-5 (atol 1e-6 for
  outputs near 0); the routing itself (`expert_idx`) and the slots
  (`tok_of_slot`) equal, the gates of the slots (`gate_of_slot`) at
  rtol 1e-5 (the router's float32 logits sum d products in another
  order, then softmax and the renormalisation: measured 15 ulps). The
  reference's own MoE tests (tests/test_models_units.py) are mirrored
  with their tolerances (rtol = atol = 1e-4 against the dense oracle).
* MLA in float32: train, prefill and absorbed decode outputs and the
  latent cache at rtol 1e-5, atol 1e-5 (sums in other orders through
  the latent projections); the reference's `test_mla_absorbed_equals_
  naive_fp32` mirrored at its 1e-4.
* `init_params`: the bfloat16 leaves bit for bit; the float32 router
  within 4 ulps, at most 2 % of its weights off at all
  (tests/test_torch_train_arch.py's rule for float32 draws).
* the flat buffer: lane for lane the reference's, in float32 (the
  router's float32 leaf promotes the bf16 tree, as `jax.flatten_util`
  does).
* loss, cross-entropy, moe_aux and mtp in float32 at rtol 1e-5; the
  vmapped per-client gradients per leaf at rtol 1e-5 plus an atol of
  1e-5 times the leaf's largest |g|.
* prefill + decode against the train forward: the reference's
  tests/test_serve.py bounds (2e-2 for the prefill's logits, rtol 4e-2
  and atol 8e-2 for each decode step, bfloat16).
* the threefry counters across 2**32: bit for bit against JAX's hash.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import api as jax_api
from repro.models import Transformer as JaxTransformer
from repro.models import attention as jax_attn
from repro.models import moe as jax_moe
from repro.models.attention import AttnMode as JaxAttnMode
from repro.utils import pytree as jax_pt
from repro_torch.configs import get_config
from repro_torch.core import api, prng
from repro_torch.models import Transformer
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models.attention import AttnMode
from repro_torch.models.transformer import _nest, init_params
from repro_torch.utils.convert import (params_from_numpy,
                                       training_tree_from_numpy)
from repro_torch.utils.pytree import ravel_spec

ARCHS = ["deepseek-v3-671b", "arctic-480b"]
M, B, S = 2, 2, 12
RTOL = 1e-5
GRAD_ATOL_SHARE = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, dtype="float32", **changes):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype,
                                **changes),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype,
                                **changes))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


# --------------------------------------------------------------------- MoE
def _reference_moe(jparams, jcfg, x):
    """The reference's `moe_apply` on x, with what its routing chose: the
    top-k indices and the first `vmap`'s (dispatch's) slot tables."""
    seen = {}
    real_top_k, real_vmap = jax.lax.top_k, jax.vmap

    def top_k(a, k):
        out = real_top_k(a, k)
        seen.setdefault("expert_idx", np.asarray(out[1]))
        return out

    def vmap(fn, *args, **kwargs):
        mapped = real_vmap(fn, *args, **kwargs)

        def call(*a, **k):
            out = mapped(*a, **k)
            seen.setdefault("dispatch", jax.device_get(out))
            return out
        return call

    jax.lax.top_k, jax.vmap = top_k, vmap
    try:
        out, aux = jax_moe.moe_apply(jparams, jcfg, jnp.asarray(x))
    finally:
        jax.lax.top_k, jax.vmap = real_top_k, real_vmap
    _, tok_of_slot, gate_of_slot = seen["dispatch"]
    return (np.asarray(out), float(aux), seen["expert_idx"],
            np.asarray(tok_of_slot), np.asarray(gate_of_slot))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("batch,seq,capacity_factor", [
    (4, 16, None),  # the default capacity: C = 8 >= B, nothing drops
    (16, 8, 0.5),  # C = 8 < 16 tokens a group: drops
])
def test_moe_apply_matches_reference(arch, batch, seq, capacity_factor,
                                     monkeypatch):
    jcfg, cfg = _configs(arch)
    if capacity_factor is not None:
        monkeypatch.setattr(jax_moe, "CAPACITY_FACTOR", capacity_factor)
        monkeypatch.setattr(moe, "CAPACITY_FACTOR", capacity_factor)
    jparams = jax.device_get(jax_moe.moe_init(jax.random.PRNGKey(0), jcfg,
                                              jnp.float32))
    params = params_from_numpy(jparams, "cpu")
    x = np.random.default_rng(1).standard_normal(
        (batch, seq, cfg.d_model)).astype(np.float32)
    C = moe.expert_capacity(batch, cfg.num_experts, cfg.experts_per_token)
    assert C == jax_moe.expert_capacity(batch, jcfg.num_experts,
                                        jcfg.experts_per_token)
    want, jaux, jidx, jtok, jgate = _reference_moe(jparams, jcfg, x)
    out, aux = moe.moe_apply(params, cfg, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(aux), jaux, rtol=RTOL)

    _, gates, idx = moe.route(params, cfg, torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), jidx)
    tok, gate = moe.slots(idx, gates, batch, seq, cfg.num_experts, C)
    np.testing.assert_array_equal(tok.numpy(), jtok)
    np.testing.assert_allclose(gate.numpy(), jgate, rtol=RTOL, atol=0)
    kept = int((tok < batch).sum())
    total = batch * seq * cfg.experts_per_token
    assert (kept < total) == (capacity_factor is not None), (kept, total)


def _moe_layer(params):
    """The first MoE layer's `moe` subtree of a training tree, nested."""
    return _nest({k: v[0] for k, v in params.items()
                  if k.startswith("groups/moe/moe/")})["groups"]["moe"]["moe"]


def test_moe_capacity_matches_dense_oracle(monkeypatch):
    """The reference's test: capacity dispatch == per-expert dense
    masking when no tokens are dropped (generous capacity)."""
    _, cfg = _configs("deepseek-v3-671b", num_experts=4,
                      experts_per_token=2)
    monkeypatch.setattr(moe, "CAPACITY_FACTOR", 8.0)  # no drops
    params = init_params(cfg, prng.prng_key(0), "cpu")
    p = _moe_layer(params)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 9, cfg.d_model)).astype(np.float32))
    out, aux = moe.moe_apply(p, cfg, x)
    ref = moe.moe_ref_dense(p, cfg, x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4)
    assert float(aux) >= 0.0


def test_moe_capacity_drops_are_bounded():
    """The reference's test: with tight capacity some tokens drop; the
    output stays finite."""
    _, cfg = _configs("arctic-480b", num_experts=4, experts_per_token=2,
                      dense_residual=False)
    params = init_params(cfg, prng.prng_key(0), "cpu")
    p = _moe_layer(params)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, 16, cfg.d_model)).astype(np.float32))
    out, _ = moe.moe_apply(p, cfg, x)
    assert torch.isfinite(out).all()


def test_moe_chunks_of_position_groups_compute_the_same_function(
        monkeypatch):
    """DISPATCH_BYTES cuts the position groups into chunks (one position a
    chunk here); the output is the one-chunk output bit for bit."""
    _, cfg = _configs("arctic-480b")
    params = init_params(cfg, prng.prng_key(0), "cpu")
    p = _moe_layer(params)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (3, 5, cfg.d_model)).astype(np.float32))
    whole, aux = moe.moe_apply(p, cfg, x)
    monkeypatch.setattr(moe, "DISPATCH_BYTES", 1)
    chunked, aux1 = moe.moe_apply(p, cfg, x)
    assert torch.equal(whole, chunked) and torch.equal(aux, aux1)


# --------------------------------------------------------------------- MLA
@pytest.fixture(scope="module")
def mla_pair():
    jcfg, cfg = _configs("deepseek-v3-671b")
    jparams = jax.device_get(jax_attn.mla_init(jax.random.PRNGKey(0), jcfg,
                                               jnp.float32))
    x = np.random.default_rng(3).standard_normal(
        (B, 10, cfg.d_model)).astype(np.float32)
    return jcfg, cfg, jparams, params_from_numpy(jparams, "cpu"), x


def test_mla_matches_reference(mla_pair):
    """Train, prefill of 5 tokens (its latent cache) and 5 absorbed decode
    steps against the reference's."""
    jcfg, cfg, jparams, params, x = mla_pair
    T = x.shape[1]
    tol = dict(rtol=RTOL, atol=1e-5)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    jpos, pos = jnp.arange(T, dtype=jnp.int32), torch.arange(T)
    mla_apply = jax.jit(jax_attn.mla_apply, static_argnums=(1, 5))
    want, _ = mla_apply(jparams, jcfg, jx, jpos, None, JaxAttnMode("train"))
    got, _ = attn.mla_apply(params, cfg, tx, pos, None, AttnMode("train"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)

    jcache = jax_attn.init_mla_cache(jcfg, B, T, jnp.float32)
    cache = attn.init_mla_cache(cfg, B, T, torch.float32)
    assert set(cache) == set(jcache)
    want, jcache = mla_apply(jparams, jcfg, jx[:, :5], jpos[:5], jcache,
                             JaxAttnMode("prefill"))
    got, cache = attn.mla_apply(params, cfg, tx[:, :5], pos[:5], cache,
                                AttnMode("prefill"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for t in range(5, T):
        want, jcache = mla_apply(jparams, jcfg, jx[:, t:t + 1],
                                 jpos[t:t + 1], jcache, JaxAttnMode("decode"))
        got, cache = attn.mla_apply(
            params, cfg, tx[:, t:t + 1], torch.tensor([t]), cache,
            AttnMode("decode"))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=f"decode step {t}", **tol)
    for k in ("ckv", "krope"):
        np.testing.assert_allclose(cache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **tol)
    for k in ("slot_pos", "pos"):
        np.testing.assert_array_equal(cache[k].numpy(),
                                      np.asarray(jcache[k]), err_msg=k)


def test_mla_absorbed_equals_naive_fp32(mla_pair):
    """The reference's test: the absorbed decode path is algebraically
    exact in float32."""
    _, cfg, _, params, x = mla_pair
    T = x.shape[1]
    tx, pos = torch.from_numpy(x), torch.arange(T)
    out_train, _ = attn.mla_apply(params, cfg, tx, pos, None,
                                  AttnMode("train"))
    cache = attn.init_mla_cache(cfg, B, T, torch.float32)
    attn.mla_apply(params, cfg, tx[:, :5], pos[:5], cache,
                   AttnMode("prefill"))
    for t in range(5, T):
        o, cache = attn.mla_apply(params, cfg, tx[:, t:t + 1], pos[t:t + 1],
                                  cache, AttnMode("decode"))
        np.testing.assert_allclose(o[:, 0].numpy(), out_train[:, t].numpy(),
                                   rtol=1e-4, atol=1e-4)


def test_mla_cache_takes_float8():
    """A float8_e4m3fn latent cache (the reference's cache_dtype): the
    latents land cast by `cast_to_cache`, and the absorbed decode reads
    them back upcast."""
    _, cfg = _configs("deepseek-v3-671b")
    params = init_params(cfg, prng.prng_key(0), "cpu")
    model = Transformer(cfg, "cpu").load_params(params)
    toks = torch.randint(0, cfg.vocab_size, (B, 9),
                         generator=torch.Generator().manual_seed(4))
    _, c8 = model.prefill(toks[:, :8], cache_len=9,
                          cache_dtype=torch.float8_e4m3fn)
    last8, c8 = model.decode_step(c8, toks[:, 8:9], 8)
    _, c32 = model.prefill(toks[:, :8], cache_len=9)
    last, c32 = model.decode_step(c32, toks[:, 8:9], 8)
    for g in c8:  # the prefill's latents (the decode's depend on the
        # cache a layer below)
        assert c8[g]["ckv"].dtype == torch.float8_e4m3fn
        assert torch.equal(c8[g]["ckv"][:, :, :8].float(), attn.cast_to_cache(
            c32[g]["ckv"][:, :, :8], torch.float8_e4m3fn).float())
    # tests/test_serve.py's fp8 bound
    assert float((last8 - last).abs().max()) < \
        0.15 * float(last.abs().max()) + 0.5


# --------------------------------------------------------- the whole model
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both models on the reference's float32 parameters."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    jmodel = JaxTransformer(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = training_tree_from_numpy(jax.device_get(jparams), "cpu")
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (M, B, S + 1)).astype(np.int32)
    return dict(arch=arch, jmodel=jmodel, jparams=jparams,
                model=Transformer(cfg, "cpu").load_params(params),
                params=params, toks=toks)


_BF16_INITS = {}


def _bf16_init(arch):
    """The reference's bf16 `Transformer.init(PRNGKey(7))`, as numpy, once
    an arch: eager, as tests/test_torch_train_arch.py (a jitted init
    fuses the draw's float ops and rounds some bf16 weights apart)."""
    if arch not in _BF16_INITS:
        jcfg, _ = _configs(arch, "bfloat16")
        _BF16_INITS[arch] = jax.device_get(
            JaxTransformer(jcfg).init(jax.random.PRNGKey(7)))
    return _BF16_INITS[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_references_weights(arch):
    _, cfg = _configs(arch, "bfloat16")
    want = training_tree_from_numpy(_bf16_init(arch), "cpu")
    got = init_params(cfg, prng.prng_key(7), "cpu")
    assert set(got) == set(want)
    assert want["groups/moe/moe/router"].dtype == torch.float32
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if v.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(got[k]), _bits(v),
                                          err_msg=k)
        else:  # the float32 router
            np.testing.assert_array_max_ulp(got[k].numpy(), v.numpy(),
                                            maxulp=4)
            assert int((got[k] != v).sum()) <= 0.02 * v.numel(), k


@pytest.mark.parametrize("arch", ARCHS)
def test_flat_buffer_is_the_references_in_float32(arch):
    """The bf16 tree with its float32 router ravels to a float32 buffer,
    lane for lane the reference's (`jax.flatten_util` promotes alike)."""
    jparams = _bf16_init(arch)
    params = training_tree_from_numpy(jparams, "cpu")
    jspec, spec = jax_pt.ravel_spec(jparams), ravel_spec(params)
    assert spec.dtype == torch.float32
    assert str(jspec.ravel(jparams).dtype) == "float32"
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert list(spec.keys) == ["/".join(k.key for k in path)
                               for path, _ in leaves]
    np.testing.assert_array_equal(_bits(spec.ravel(params)),
                                  np.asarray(jspec.ravel(jparams)).view(
                                      np.int32))
    back = spec.unravel(spec.ravel(params))
    for k, v in params.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_loss_and_gradients_match_reference_float32(pair):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params, toks = pair["model"], pair["params"], pair["toks"]
    jloss, jmet = jax.jit(jmodel.loss)(jparams,
                                       {"tokens": jnp.asarray(toks[0])})
    loss, met = model.loss(params, {"tokens": torch.from_numpy(toks[0])})
    want_keys = {"ce", "moe_aux", "acc", "loss"}
    if model.cfg.mtp:
        want_keys.add("mtp")
    assert set(met) == set(jmet) == want_keys
    assert float(met["moe_aux"]) > 0
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jlosses, jgrads = jax.jit(jax_api.per_client_value_and_grad(
        jmodel.loss))(jparams, {"tokens": jnp.asarray(toks)})
    losses, grads = api.per_client_value_and_grad(model.loss)(
        params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL)
    jgrads = training_tree_from_numpy(jax.device_get(jgrads), "cpu")
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        w = w.numpy()
        np.testing.assert_allclose(
            grads[k].numpy(), w, rtol=RTOL,
            atol=GRAD_ATOL_SHARE * np.abs(w).max(), err_msg=k)


def test_prefill_and_decode_match_reference(pair):
    """The serving path: prefill of 8 tokens and 4 decode steps, logits
    and the stacked caches, against the reference's, float32 at 1e-4
    (tests/test_torch_transformer.py's)."""
    jmodel, jparams, model = pair["jmodel"], pair["jparams"], pair["model"]
    toks = pair["toks"][0]
    jt = jnp.asarray(toks)
    prefill = jax.jit(lambda p, t: jmodel.prefill(p, tokens=t, cache_len=S))
    decode = jax.jit(jmodel.decode_step)
    jlast, jcache = prefill(jparams, jt[:, :8])
    last, cache = model.prefill(torch.from_numpy(toks[:, :8]), cache_len=S)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast), rtol=1e-4,
                               atol=1e-4)
    for t in range(8, S):
        jlast, jcache = decode(jparams, jcache, jt[:, t:t + 1],
                               jnp.asarray(t, jnp.int32))
        last, cache = model.decode_step(
            cache, torch.from_numpy(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"decode step {t}")
    jcache = jax.device_get(jcache)
    assert set(cache) == set(jcache)
    for g in cache:
        assert set(cache[g]) == set(jcache[g]), g
        for k, v in cache[g].items():
            np.testing.assert_allclose(v.float().numpy(),
                                       np.asarray(jcache[g][k], np.float32),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"{g}/{k}")


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's tests/test_serve.py case (bfloat16): logits from
    [prefill(t<8) + decode steps 8..11] == full forward; the MoE routes
    capacity per position group, so the decode's drops are the
    forward's."""
    _, cfg = _configs(arch, "bfloat16")
    model = Transformer(cfg, "cpu").init(prng.prng_key(0))
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full = model.forward(toks)
    last, cache = model.prefill(toks[:, :8], cache_len=S)
    np.testing.assert_allclose(last.float().numpy(),
                               full[:, 7].float().numpy(), rtol=2e-2,
                               atol=2e-2)
    for t in range(8, S):
        last, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(
            last.float().numpy(), full[:, t].float().numpy(), rtol=4e-2,
            atol=8e-2, err_msg=f"{arch}: decode step {t} diverges")


def test_layer_groups_follow_the_reference():
    for arch in ARCHS:
        jcfg, cfg = _configs(arch)
        want = [(g.name, g.count, g.kind)
                for g in JaxTransformer(jcfg).groups]
        got = [(g.name, g.count, g.kind)
               for g in Transformer(cfg, "cpu").layer_groups]
        assert got == want, arch
    cut = dataclasses.replace(get_config("deepseek-v3-671b"), num_layers=4)
    assert [(g.name, g.count) for g in Transformer(cut, "cpu").layer_groups
            ] == [("dense", 3), ("moe", 1)]


# --------------------------------------------------- threefry past 2**32
def test_random_bits_cross_2_32_counters():
    """Words 2**32 - 8 .. 2**32 + 8 of a draw (Arctic's (128, 7168, 4864)
    expert leaf has 4.46e9 words): the numpy and torch forms bit for bit
    JAX's threefry of the (hi, lo) counter halves."""
    from jax._src import prng as jax_prng

    key = prng.split(prng.prng_key(11), 3)[2]
    offset, n = 2**32 - 8, 17
    count = np.arange(offset, offset + n, dtype=np.uint64)
    hi, lo = (count >> np.uint64(32)).astype(np.uint32), \
        count.astype(np.uint32)
    a, b = jax_prng.threefry2x32_p.bind(
        jnp.uint32(key[0]), jnp.uint32(key[1]), jnp.asarray(hi),
        jnp.asarray(lo))
    want = np.asarray(a) ^ np.asarray(b)
    np.testing.assert_array_equal(prng.random_bits(key, n, offset), want)
    got = prng.random_bits_t(prng.key_t(key)[None], n, offset)[0]
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_tiles_of_a_draw_are_the_whole_draw():
    """`normal_t` and `uniform_t` from an offset give the same words as
    the whole draw (the card draws a large leaf tile by tile)."""
    key = prng.key_t(prng.prng_key(3))
    whole = prng.normal_t(key, 1000)
    parts = torch.cat([prng.normal_t(key, n, offset=o)
                       for o, n in ((0, 300), (300, 512), (812, 188))])
    assert torch.equal(whole, parts)
    u = prng.uniform_t(key[None], 64)[0]
    assert torch.equal(u[40:], prng.uniform_t(key[None], 24, offset=40)[0])
