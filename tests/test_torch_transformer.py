"""The port's serving model against the JAX package's, and on its own.

Reduced tinyllama-1.1b (dense GQA), qwen1.5-0.5b (QKV bias, tied
embeddings) and rwkv6-3b, in float32 and in bfloat16. The JAX package's
`Transformer.init` parameters are carried across with
`utils.convert.training_tree_from_numpy`, the tokens are made with
numpy from a seed, and both packages run forward (train mode), prefill
of 8 tokens and 4 decode steps. Tolerances (elementwise rtol and atol):

* float32: 1e-4. Logits are O(1-5); the two sides sum in other orders
  (XLA:CPU's dot vs PyTorch's, the flash kernel's plain version vs the
  reference's blocked softmax), a few ulps through two layers;
* bfloat16: rtol 4e-2, atol 8e-2, the reference's own bf16 tolerance
  for two computations of the same logits (tests/test_serve.py): every
  matmul output and elementwise op rounds to bf16, at places where
  XLA:CPU and PyTorch differ (XLA fuses elementwise chains in fp32), a
  few bf16 ulps of O(1-5) values;
* RWKV-6 in bfloat16: rtol 4e-2, atol 1.5e-1, for the logits and the
  fp32 state alike. Its state sums k vᵀ products of bf16 r, k, v over
  the steps, so one bf16 ulp (2^-8) of difference in an input reaches
  the state and every later token; measured, one logit in 12288 is
  0.093 off (float32 runs of the same model agree to 2e-5, so the math
  is the same and the difference is where bf16 rounds).

The port on its own then passes the three checks of tests/test_serve.py,
with its tolerances: decode matches forward, the sliding-window ring
buffer, and a prefill that wraps the ring.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.core.prng import prng_key
from repro_torch.models import Transformer
from repro_torch.models.attention import AttnMode
from repro_torch.utils.convert import _tensor, training_tree_from_numpy

ARCHS = ["tinyllama-1.1b", "qwen1.5-0.5b", "rwkv6-3b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=4e-2, atol=8e-2)}
RWKV_BF16_TOL = dict(rtol=4e-2, atol=1.5e-1)


def _tol(pair):
    if pair["arch"] == "rwkv6-3b" and pair["dtype"] == "bfloat16":
        return RWKV_BF16_TOL
    return TOL[pair["dtype"]]
B, T, P = 2, 12, 8


def _np(a):
    return np.asarray(a, np.float32) if not isinstance(a, torch.Tensor) \
        else a.float().numpy()


@pytest.fixture(scope="module",
                params=[(a, d) for a in ARCHS for d in TOL],
                ids=lambda p: f"{p[0]}-{p[1]}")
def pair(request):
    """Both models on the same parameters, and the JAX package's outputs."""
    arch, dtype = request.param
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = Transformer(cfg, "cpu").load_params(
        training_tree_from_numpy(jparams, "cpu"))
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, T))
    jt = jnp.asarray(toks, jnp.int32)
    want = {"forward": jmodel.forward(jparams, tokens=jt)[0]}
    last, cache = jmodel.prefill(jparams, tokens=jt[:, :P], cache_len=T)
    want["prefill"], want["prefill_cache"] = last, jax.device_get(cache)
    want["decode"] = []
    for t in range(P, T):
        last, cache = jmodel.decode_step(jparams, cache, jt[:, t:t + 1],
                                         jnp.asarray(t, jnp.int32))
        want["decode"].append(last)
    want["decode_cache"] = jax.device_get(cache)
    return dict(arch=arch, dtype=dtype, jcfg=jcfg, jparams=jparams,
                model=model, toks=torch.from_numpy(toks), want=want)


def _jax_key_paths(tree, prefix=()):
    """{port key path: (shape, dtype)} of a JAX parameter pytree: its
    path joined with "/", each group's layers stacked on axis 0."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(_jax_key_paths(v, path))
        else:
            out["/".join(path)] = (tuple(v.shape), str(v.dtype))
    return out


def _close_cache(got, want, tol, what):
    for g in want:
        for k in want[g]:
            exact = k in ("slot_pos", "pos")
            np.testing.assert_allclose(
                _np(got[g][k]), _np(want[g][k]), err_msg=f"{what} {g}/{k}",
                **(dict(rtol=0, atol=0) if exact else tol))


def test_parameter_tree_matches_reference(pair):
    model, jparams = pair["model"], pair["jparams"]
    want = _jax_key_paths(jparams)
    got = {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
           for k, t in model.params.items()}
    assert got == want
    assert model.cfg.param_count() == pair["jcfg"].param_count()
    assert sum(t.numel() for t in model.params.values()) == sum(
        a.size for a in jax.tree.leaves(jparams))
    # the tree a run draws itself has the same paths, shapes and dtypes
    drawn = Transformer(model.cfg, "cpu").init(prng_key(0))
    assert {k: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for k, t in drawn.params.items()} == want


def test_forward_matches_reference(pair):
    logits = pair["model"].forward(pair["toks"])
    np.testing.assert_allclose(_np(logits), _np(pair["want"]["forward"]),
                               **_tol(pair))


def test_prefill_and_decode_match_reference(pair):
    model, toks, want, tol = pair["model"], pair["toks"], pair["want"], _tol(pair)
    last, cache = model.prefill(toks[:, :P], cache_len=T)
    np.testing.assert_allclose(_np(last), _np(want["prefill"]), **tol)
    _close_cache(cache, want["prefill_cache"], tol, "prefill cache")
    for t, w in zip(range(P, T), want["decode"]):
        last, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(_np(last), _np(w), err_msg=f"step {t}",
                                   **tol)
    _close_cache(cache, want["decode_cache"], tol, "decode cache")


def test_bf16_arrays_carry_across_bit_for_bit():
    a = np.random.default_rng(5).standard_normal((3, 7)).astype(np.float32)
    a[0, :3] = [np.inf, -0.0, 1e-40]  # inf, signed zero, a subnormal
    j = np.asarray(jnp.asarray(a, jnp.bfloat16))
    t = _tensor(j, "cpu")
    assert t.dtype == torch.bfloat16 and tuple(t.shape) == (3, 7)
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  j.view(np.int16))
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))


# ------------------------------------------------ the port on its own
def _port(arch, seed=0):
    cfg = get_config(arch).reduced()
    return cfg, Transformer(cfg, "cpu").init(prng_key(seed))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """logits from [prefill(t<8) + decode steps 8..11] == full forward."""
    cfg, model = _port(arch)
    toks = torch.randint(0, cfg.vocab_size, (B, T),
                         generator=torch.Generator().manual_seed(1))
    full = model.forward(toks)
    last, cache = model.prefill(toks[:, :8], cache_len=T)
    np.testing.assert_allclose(_np(last), _np(full[:, 7]), rtol=2e-2,
                               atol=2e-2)
    for t in range(8, T):
        last, cache = model.decode_step(cache, toks[:, t:t + 1], t)
        np.testing.assert_allclose(
            _np(last), _np(full[:, t]), rtol=4e-2, atol=8e-2,
            err_msg=f"{arch}: decode step {t} diverges from forward")


def test_sliding_window_ring_buffer():
    """Ring-buffer decode (cache_len=W < T) == full-cache decode with the
    same window mask."""
    cfg, model = _port("tinyllama-1.1b")
    W = cfg.sliding_window  # 64 in the reduced config
    n = W + 24  # force wrap-around
    toks = torch.randint(0, cfg.vocab_size, (B, n),
                         generator=torch.Generator().manual_seed(1))
    _, cache_full = model.prefill(toks[:, :W], cache_len=n, window=W)
    _, cache_ring = model.prefill(toks[:, :W], cache_len=W, window=W)
    for t in range(W, n):
        tok = toks[:, t:t + 1]
        lf, cache_full = model.decode_step(cache_full, tok, t, window=W)
        lr, cache_ring = model.decode_step(cache_ring, tok, t, window=W)
        np.testing.assert_allclose(
            _np(lr), _np(lf), rtol=4e-2, atol=8e-2,
            err_msg=f"ring buffer diverges at t={t}")


def test_prefill_wrap_ring_buffer():
    """Prefilling more tokens than the ring size keeps only the last W,
    and the last logits equal the windowed full forward's."""
    cfg, model = _port("tinyllama-1.1b")
    W = cfg.sliding_window
    n = W + 16
    toks = torch.randint(0, cfg.vocab_size, (B, n),
                         generator=torch.Generator().manual_seed(2))
    last_wrap, cache = model.prefill(toks, cache_len=W, window=W)
    full = model.forward(toks, mode=AttnMode("train", window=W))
    np.testing.assert_allclose(_np(last_wrap), _np(full[:, -1]), rtol=2e-2,
                               atol=2e-2)
    slot = cache["dense"]["slot_pos"][0]
    assert sorted(slot.tolist()) == list(range(n - W, n))
    assert cache["dense"]["pos"].tolist() == [n] * cfg.num_layers

