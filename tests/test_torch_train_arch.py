"""The port's transformer training pieces against the JAX package's, at
reduced size: the training tree's flat buffer, the weights drawn from
the reference's key, the loss and its gradients, the Lipschitz probe,
and the kernels' absence from the training path.

Tolerances:

* the flat (N,) and (m, N) buffers of the same parameters: bit for bit
  (the same leaf order, `utils.pytree.ravel_spec`);
* `init_params` against `Transformer.init(PRNGKey(seed))`: bit for bit in
  bfloat16 (every registered config's dtype). In float32 each weight
  within 4 float32 ulps of the reference's, at most 2 % of them off at
  all: the integer stream is the reference's bit for bit, and numpy's
  `log1p` in the normal draw's erfinv sits a few ulps from XLA:CPU's
  (about 1.3 % of the draws; tests/test_torch_prng.py);
* float32 loss, cross-entropy and accuracy: rtol 1e-5; gradients per
  leaf at rtol 1e-5 plus an atol of GRAD_ATOL times the leaf's largest
  |g| (the dense kinds; 1e-5 of it): the two sides sum the same
  products in other orders (XLA:CPU's dots against PyTorch's). RWKV-6
  takes 1e-4 of it: the recurrence's backward carries a 16-step sum of
  outer products per head, whose order differs;
* bfloat16 (the registered configs' dtype, in which `--arch` runs take
  their gradients): the loss at rtol BF16_LOSS_RTOL (2e-3; measured at
  most 1.2e-3, RWKV-6). Every matmul output and elementwise op rounds to
  bf16, where XLA:CPU fuses chains in fp32 and PyTorch rounds op by op,
  so the gradients are held normwise against a float32 witness at the
  same parameters (the port no farther from it than BF16_WITNESS_RATIO,
  1.25, times the reference) and, for the dense kinds, to each other at
  BF16_GRAD_NORM_RTOL (5e-2);
* `estimate_lipschitz` on the reference's own normal draws: rtol
  PROBE_F32_RTOL (5e-5) in float32, not 1e-5: the reference's float32
  vdots (XLA:CPU) lose 2.7e-5 of ||d|| on this tree against its float64
  sum, where the port's is within 4e-8 of it (and its ||g1 - g0|| within
  1.2e-7), measured; on the port's own draws (a few ulps apart) rtol
  1e-4 in float32 and PROBE_BF16_RTOL (5e-2) in bfloat16, whose probe
  takes bf16 gradients (measured 3.1e-3 apart).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import api as jax_api
from repro.core import hparams as jax_hparams
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.models import Transformer as JaxTransformer
from repro.utils import pytree as jax_pt
from repro_torch.config import FedConfig
from repro_torch.configs import get_config
from repro_torch.core import api, hparams, prng
from repro_torch.core.api import make_algorithm
from repro_torch.data import synthetic_batch_for, to_torch
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.rwkv6_scan import ops as scan_ops
from repro_torch.models import Transformer
from repro_torch.models.attention import AttnMode
from repro_torch.models.transformer import init_params
from repro_torch.utils.convert import training_tree_from_numpy
from repro_torch.utils.pytree import ravel_spec

DENSE = ["tinyllama-1.1b", "qwen1.5-0.5b", "stablelm-12b", "deepseek-67b"]
ARCHS = DENSE + ["rwkv6-3b"]
M, B, S = 2, 2, 16
GRAD_ATOL = {"rwkv6-3b": 1e-4}
BF16_LOSS_RTOL = 2e-3
BF16_GRAD_NORM_RTOL = 5e-2
BF16_WITNESS_RATIO = 1.25
PROBE_BF16_RTOL = 5e-2
PROBE_F32_RTOL = 5e-5


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, dtype="bfloat16"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.name == "bfloat16" else np.int32)


def _pair(arch, dtype, seed=0):
    """Both models on the reference's parameters, and one client batch
    stack of M clients."""
    jcfg, cfg = _configs(arch, dtype)
    jmodel = JaxTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    params = training_tree_from_numpy(jax.device_get(jparams), "cpu")
    raw = jax_batch_for(jcfg, M, B, S, seed=seed)
    return (jmodel, jparams, jax.tree.map(jnp.asarray, raw),
            Transformer(cfg, "cpu"), params,
            to_torch(synthetic_batch_for(cfg, M, B, S, seed=seed), "cpu"))


# ------------------------------------------------------------ the buffer
@pytest.mark.parametrize("arch", ARCHS)
def test_flat_buffers_are_the_references_bit_for_bit(arch):
    jcfg, cfg = _configs(arch)
    jparams = jax.device_get(JaxTransformer(jcfg).init(jax.random.PRNGKey(0)))
    params = training_tree_from_numpy(jparams, "cpu")
    jspec, spec = jax_pt.ravel_spec(jparams), ravel_spec(params)
    leaves = jax.tree_util.tree_flatten_with_path(jparams)[0]
    assert list(spec.keys) == ["/".join(k.key for k in path)
                               for path, _ in leaves]
    assert (spec.size, spec.padded_size) == (jspec.size, jspec.padded_size)
    np.testing.assert_array_equal(_bits(spec.ravel(params)),
                                  _jbits(jspec.ravel(jparams)))
    # the client-stacked (m, N) buffer of FedGiA's state
    stacked = jax.tree.map(lambda a: np.stack([a, a * 2, -a]), jparams)
    np.testing.assert_array_equal(
        _bits(spec.ravel_stacked(training_tree_from_numpy(stacked, "cpu"))),
        _jbits(jspec.ravel_stacked(stacked)))
    # and back
    back = spec.unravel(spec.ravel(params))
    for k, v in params.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_the_references_weights(arch):
    jcfg, cfg = _configs(arch)
    want = jax.device_get(JaxTransformer(jcfg).init(jax.random.PRNGKey(7)))
    got = init_params(cfg, prng.prng_key(7), "cpu")
    want = training_tree_from_numpy(want, "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)


def test_init_params_float32_within_ulps():
    jcfg, cfg = _configs("tinyllama-1.1b", "float32")
    want = training_tree_from_numpy(jax.device_get(
        JaxTransformer(jcfg).init(jax.random.PRNGKey(7))), "cpu")
    got = init_params(cfg, prng.prng_key(7), "cpu")
    off = total = 0
    for k, v in want.items():
        np.testing.assert_array_max_ulp(got[k].numpy(), v.numpy(), maxulp=4)
        off += int((got[k] != v).sum())
        total += v.numel()
    print(f"float32 init: {off} of {total} weights off by 1-4 ulps")
    assert off <= 0.02 * total


# ------------------------------------------------------ loss and gradient
@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen1.5-0.5b",
                                  "rwkv6-3b"])
def test_loss_and_gradients_match_reference_float32(arch):
    jmodel, jparams, jbatch, model, params, batch = _pair(arch, "float32")
    one = {"tokens": jbatch["tokens"][0]}
    jloss, jmet = jmodel.loss(jparams, one)
    loss, met = model.loss(params, {"tokens": batch["tokens"][0]})
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert set(met) == {"ce", "moe_aux", "acc", "loss"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=1e-5,
                                   err_msg=k)
    # every client's value and gradient, vmapped over the client axis
    jlosses, jgrads = jax_api.per_client_value_and_grad(jmodel.loss)(
        jparams, jbatch)
    losses, grads = api.per_client_value_and_grad(model.loss)(params, batch)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    jgrads = training_tree_from_numpy(jax.device_get(jgrads), "cpu")
    atol_share = GRAD_ATOL.get(arch, 1e-5)
    for k, w in jgrads.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=1e-5,
                                   atol=atol_share * np.abs(w).max(),
                                   err_msg=k)


def _normwise(got, want):
    num = sum(float(torch.sum((got[k].float() - w.float()) ** 2))
              for k, w in want.items())
    return (num / sum(float(torch.sum(w.float() ** 2))
                      for w in want.values())) ** 0.5


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_loss_and_gradients_match_reference_bfloat16(arch):
    """bf16 gradients, each side against the float32 gradient at the same
    (bf16-valued) parameters, the witness of what bf16 rounding alone
    moves: the port no farther from it than BF16_WITNESS_RATIO times the
    reference (measured: 0.014 against 0.013 for tinyllama; RWKV-6, whose
    recurrence amplifies bf16 rounding (ROADMAP queue 3 j), 0.12 against
    0.19, the two sides 0.27 apart), and, for the dense kinds, the two
    sides within BF16_GRAD_NORM_RTOL of each other."""
    jmodel, jparams, jbatch, model, params, batch = _pair(arch, "bfloat16")
    jlosses, jgrads = jax_api.per_client_value_and_grad(jmodel.loss)(
        jparams, jbatch)
    losses, grads = api.per_client_value_and_grad(model.loss)(params, batch)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=BF16_LOSS_RTOL)
    jgrads = training_tree_from_numpy(jax.device_get(jgrads), "cpu")
    wit = api.per_client_value_and_grad(Transformer(
        dataclasses.replace(model.cfg, dtype="float32"), "cpu").loss)(
        {k: v.float() for k, v in params.items()}, batch)[1]
    port, ref = _normwise(grads, wit), _normwise(jgrads, wit)
    apart = _normwise(grads, jgrads)
    print(f"{arch} bf16 gradients normwise: port {port!r} and reference "
          f"{ref!r} from the float32 witness, {apart!r} apart")
    assert port <= BF16_WITNESS_RATIO * ref
    if arch != "rwkv6-3b":
        assert apart <= BF16_GRAD_NORM_RTOL


# -------------------------------------------------------- Lipschitz probe
_REFERENCE_PROBES = {}


def _probes(dtype, monkeypatch=None):
    """The port's r̂ and the reference's (computed once a dtype: an eager
    JAX probe takes seconds) on client 0 of tinyllama's reduced config,
    with the key FedGiA.init gives client 0."""
    jmodel, jparams, jbatch, model, params, batch = _pair("tinyllama-1.1b",
                                                          dtype)
    key = prng.split(prng.prng_key(1), M)[0]
    if dtype not in _REFERENCE_PROBES:
        one = jax.tree.map(lambda a: a[0], jbatch)
        _REFERENCE_PROBES[dtype] = float(jax_hparams.estimate_lipschitz(
            jmodel.loss, jparams, one, jnp.asarray(key, jnp.uint32)))
    if monkeypatch is not None:  # the reference's own normal draws
        monkeypatch.setattr(hparams.prng, "normal", lambda k, shape: np.asarray(
            jax.random.normal(jnp.asarray(k, jnp.uint32), shape)))
    got = float(hparams.estimate_lipschitz(
        model.loss, params, {k: v[0] for k, v in batch.items()}, key))
    return got, _REFERENCE_PROBES[dtype]


def test_estimate_lipschitz_on_the_references_draws(monkeypatch):
    got, want = _probes("float32", monkeypatch)
    np.testing.assert_allclose(got, want, rtol=PROBE_F32_RTOL)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4),
                                        ("bfloat16", PROBE_BF16_RTOL)])
def test_estimate_lipschitz_matches_reference(dtype, rtol):
    got, want = _probes(dtype)
    print(f"r_hat {dtype}: port {got!r} reference {want!r}")
    np.testing.assert_allclose(got, want, rtol=rtol)


def test_fedgia_init_probes_every_client_and_keeps_the_max():
    """`auto_lipschitz`: split(rng, m) gives a key a client, r is the max
    of their probes, sigma = t r / m, and diag_ema's h starts at r (the
    reference's state at the same point: tests/test_torch_train_engine.py)."""
    _, _, _, model, params, batch = _pair("tinyllama-1.1b", "float32")
    kw = dict(num_clients=M, k0=3, sigma_t=30.0, h_policy="diag_ema",
              auto_lipschitz=True)
    state = make_algorithm(FedConfig(**kw), model.loss, model=model).init(
        params, prng.prng_key(1), init_batch=batch)
    keys = prng.split(prng.prng_key(1), M)
    r = max(float(hparams.estimate_lipschitz(
        model.loss, params, {k: v[i] for k, v in batch.items()}, keys[i]))
        for i in range(M))
    assert float(state["r"]) == r
    assert float(state["sigma"]) == float(np.float32(30.0 * np.float32(r)
                                                     / M))
    assert float(state["h"]["embed"][0, 0, 0]) == r


# ------------------------------------------------ the training path itself
def _refuse(*args, **kwargs):
    raise AssertionError("a CUDA kernel's wrapper was called in train mode")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_train_mode_calls_neither_kernel(arch, monkeypatch):
    """Train-mode forward and gradient go through the plain blocked
    softmax and WKV recurrence (the reference's training path); prefill
    still calls each kernel's wrapper once a layer."""
    _, cfg = _configs(arch, "float32")
    model = Transformer(cfg, "cpu")
    params = init_params(cfg, prng.prng_key(0), "cpu")
    batch = to_torch(synthetic_batch_for(cfg, M, B, S), "cpu")
    monkeypatch.setattr(flash_ops, "flash_attention", _refuse)
    monkeypatch.setattr(scan_ops, "rwkv6_scan", _refuse)
    losses, grads = api.per_client_value_and_grad(model.loss)(params, batch)
    assert torch.isfinite(losses).all()
    assert all(torch.isfinite(g).all() for g in grads.values())
    monkeypatch.undo()
    calls = []
    name, mod = (("rwkv6_scan", scan_ops) if arch == "rwkv6-3b"
                 else ("flash_attention", flash_ops))
    real = getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model.load_params(params)
    model.prefill(batch["tokens"][0, :, :8], cache_len=16)
    assert len(calls) == cfg.num_layers


def test_serving_module_loads_a_trained_tree():
    _, cfg = _configs("qwen1.5-0.5b", "float32")
    params = init_params(cfg, prng.prng_key(3), "cpu")
    model = Transformer(cfg, "cpu").load_params(params)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(0))
    assert torch.equal(model.forward(toks), model.forward(toks, params=params))
    assert set(model.params) == set(params)
    for k, v in params.items():
        assert torch.equal(model.params[k], v), k
    assert torch.equal(
        Transformer(cfg, "cpu").init(prng.prng_key(3)).forward(toks),
        model.forward(toks))
    wrong = dict(params, embed=params["embed"][:-1])
    with pytest.raises(ValueError, match="embed"):
        Transformer(cfg, "cpu").load_params(wrong)
    with pytest.raises(KeyError, match="lm_head"):
        Transformer(cfg, "cpu").load_params(dict(params, lm_head=params[
            "embed"]))


def test_forward_with_positions_matches_reference():
    """Train mode masks and rotates by the positions it is given, as the
    reference does; prefill takes 0..S-1 only (the flash kernel masks by
    index)."""
    jmodel, jparams, _, model, params, _ = _pair("tinyllama-1.1b", "float32")
    toks = np.random.default_rng(2).integers(0, 512, (B, S))
    pos = np.arange(S) + 5
    want = jmodel.forward(jparams, tokens=jnp.asarray(toks, jnp.int32),
                          positions=jnp.asarray(pos, jnp.int32))[0]
    got = model.forward(torch.from_numpy(toks), params=params,
                        positions=torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    model.load_params(params)
    cache = model.init_cache(B, S)
    with pytest.raises(ValueError, match="positions 0..S-1"):
        model.forward(torch.from_numpy(toks), cache=cache,
                      positions=torch.from_numpy(pos),
                      mode=AttnMode("prefill"))


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_train_step(arch):
    """The reference's smoke step (tests/test_models_smoke.py) for the
    ported kinds: loss, gradient, an SGD update, a finite loss after."""
    _, cfg = _configs(arch)
    assert cfg.num_layers == 2 and cfg.d_model <= 512
    model = Transformer(cfg, "cpu")
    params = init_params(cfg, prng.prng_key(0), "cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 9), generator=g)}
    grads, (loss, _) = torch.func.grad_and_value(
        model.loss, has_aux=True)(params, batch)
    assert torch.isfinite(loss), f"{arch}: non-finite loss"
    gn = sum(torch.sum(torch.square(v.float())) for v in grads.values())
    assert torch.isfinite(gn) and gn > 0, f"{arch}: bad grads"
    new = {k: p - 1e-3 * grads[k].to(p.dtype) for k, p in params.items()}
    assert torch.isfinite(model.loss(new, batch)[0])

