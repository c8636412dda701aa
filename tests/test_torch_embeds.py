"""The port's embeds input modes against the JAX package's, at reduced
size: musicgen-large (audio frame embeddings, labels) and
llava-next-mistral-7b (a patch-embedding prefix, then text tokens), and
`data/tokens.py::synthetic_batch_for` in every input mode.

Tolerances:

* `synthetic_batch_for`: bit for bit (the same numpy generators, drawn
  in the same order).
* `init_params` against `Transformer.init(PRNGKey(7))`: bit for bit in
  bfloat16, and the flat buffer lane for lane
  (tests/test_torch_train_arch.py's rules).
* float32 forward, loss, its metrics and the vmapped per-client
  gradients: rtol 1e-5 (the forward's logits and the gradients plus an
  atol of 1e-5 times the largest |value|: sums in other orders).
* bfloat16 loss: BF16_LOSS_RTOL (2e-3, tests/test_torch_train_arch.py's:
  every matmul output rounds to bf16 at places where XLA:CPU fuses).
* prefill (the embeddings, then tokens) and decode against the
  reference in float32: logits and K/V at rtol 1e-4, atol 1e-4
  (tests/test_torch_transformer.py's float32 bound); slot positions
  equal.
* decode against the train forward in bfloat16: the reference's
  tests/test_serve.py bounds (2e-2 for the prefill's logits, rtol 4e-2,
  atol 8e-2 for each decode step).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import api as jax_api
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.models import Transformer as JaxTransformer
from repro.utils import pytree as jax_pt
from repro_torch.configs import get_config
from repro_torch.core import api, prng
from repro_torch.data import synthetic_batch_for, to_torch
from repro_torch.launch import serve
from repro_torch.models import Transformer
from repro_torch.models.transformer import init_params
from repro_torch.utils.convert import training_tree_from_numpy
from repro_torch.utils.pytree import ravel_spec

ARCHS = ["musicgen-large", "llava-next-mistral-7b"]
M, B, S = 2, 2, 10
RTOL = 1e-5
BF16_LOSS_RTOL = 2e-3
SERVE_F32_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_get_config(arch).reduced(), dtype=dtype),
            dataclasses.replace(get_config(arch).reduced(), dtype=dtype))


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16
                  else torch.int32).numpy()


def _embeds(cfg, n, seed=6):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, n, cfg.d_model)).astype(np.float32)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("arch,mode", [
    ("tinyllama-1.1b", "tokens"), ("hymba-1.5b", "tokens"),
    ("musicgen-large", "embeds"), ("llava-next-mistral-7b", "tokens+embeds")])
@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_batch_for_matches_reference_bit_for_bit(arch, mode, seed):
    jcfg, cfg = _configs(arch)
    assert cfg.input_mode == mode
    want = jax_batch_for(jcfg, 3, 2, 12, seed=seed)
    got = synthetic_batch_for(cfg, 3, 2, 12, seed=seed)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    keys = {"tokens": {"tokens"}, "embeds": {"embeds", "labels"},
            "tokens+embeds": {"embeds", "tokens"}}[mode]
    assert set(got) == keys
    if mode == "tokens+embeds":
        assert got["embeds"].shape == (3, 2, cfg.embed_prefix_len,
                                       cfg.d_model)
        assert got["tokens"].shape == (3, 2, 13)
    if mode == "embeds":
        assert got["embeds"].shape == (3, 2, 12, cfg.d_model)
        np.testing.assert_array_equal(
            got["labels"], jax_batch_for(
                dataclasses.replace(jcfg, input_mode="tokens"), 3, 2, 12,
                seed=seed)["tokens"][..., :12])


# ---------------------------------------------------- weights and buffer
@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_and_flat_buffer_are_the_references(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    jparams = jax.device_get(JaxTransformer(jcfg).init(jax.random.PRNGKey(7)))
    want = training_tree_from_numpy(jparams, "cpu")
    got = init_params(cfg, prng.prng_key(7), "cpu")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        np.testing.assert_array_equal(_bits(got[k]), _bits(v), err_msg=k)
    jspec, spec = jax_pt.ravel_spec(jparams), ravel_spec(want)
    np.testing.assert_array_equal(
        _bits(spec.ravel(want)),
        np.asarray(jspec.ravel(jparams)).view(np.int16))


# ------------------------------------------------------ the float32 pair
@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """Both models on the reference's float32 parameters, and one stacked
    batch of M clients in the config's input mode."""
    arch = request.param
    jcfg, cfg = _configs(arch)
    jmodel = JaxTransformer(jcfg)
    jparams = jax.jit(jmodel.init)(jax.random.PRNGKey(0))
    params = training_tree_from_numpy(jax.device_get(jparams), "cpu")
    raw = jax_batch_for(jcfg, M, B, S, seed=4)
    return dict(arch=arch, cfg=cfg, jmodel=jmodel, jparams=jparams,
                params=params, raw=raw,
                model=Transformer(cfg, "cpu").load_params(params))


def test_forward_with_embeds_matches_reference(pair):
    """The train forward on embeds alone, and on embeds then tokens."""
    jmodel, jparams, model, cfg = (pair["jmodel"], pair["jparams"],
                                   pair["model"], pair["cfg"])
    emb = _embeds(cfg, 5)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (B, 4))
    fwd = jax.jit(lambda p, t, e: jmodel.forward(p, tokens=t, embeds=e)[0])
    for t in (None, toks):
        want = np.asarray(fwd(jparams, None if t is None else
                              jnp.asarray(t, jnp.int32), jnp.asarray(emb)))
        got = model.forward(None if t is None else torch.from_numpy(t),
                            embeds=torch.from_numpy(emb))
        assert got.shape == (B, 5 + (0 if t is None else 4), cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())


def test_loss_and_gradients_match_reference_float32(pair):
    jmodel, jparams = pair["jmodel"], pair["jparams"]
    model, params, raw = pair["model"], pair["params"], pair["raw"]
    one = {k: v[0] for k, v in raw.items()}
    jloss, jmet = jax.jit(jmodel.loss)(jparams, jax.tree.map(jnp.asarray,
                                                             one))
    loss, met = model.loss(params, to_torch(one, "cpu"))
    assert set(met) == set(jmet) == {"ce", "moe_aux", "acc", "loss"}
    for k in met:
        np.testing.assert_allclose(float(met[k]), float(jmet[k]), rtol=RTOL,
                                   err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=RTOL)
    jlosses, jgrads = jax.jit(jax_api.per_client_value_and_grad(
        jmodel.loss))(jparams, jax.tree.map(jnp.asarray, raw))
    losses, grads = api.per_client_value_and_grad(model.loss)(
        params, to_torch(raw, "cpu"))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=RTOL)
    jgrads = training_tree_from_numpy(jax.device_get(jgrads), "cpu")
    assert set(grads) == set(jgrads)
    for k, w in jgrads.items():
        w = w.numpy()
        np.testing.assert_allclose(grads[k].numpy(), w, rtol=RTOL,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)


def test_prefill_with_embeds_and_decode_match_reference(pair):
    """Prefill of 6 embeddings (and 3 tokens for the VLM), then 4 decode
    steps from position P + S: logits and the caches against the
    reference's."""
    jmodel, jparams, model, cfg = (pair["jmodel"], pair["jparams"],
                                   pair["model"], pair["cfg"])
    emb = _embeds(cfg, 6)
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size,
                                             (B, 7)).astype(np.int32)
    vlm = cfg.input_mode == "tokens+embeds"
    prompt = toks[:, :3] if vlm else None
    P = 6 + (3 if vlm else 0)
    n = P + 4
    prefill = jax.jit(lambda p, t, e: jmodel.prefill(p, tokens=t, embeds=e,
                                                     cache_len=n))
    decode = jax.jit(jmodel.decode_step)
    jlast, jcache = prefill(jparams, None if prompt is None else
                            jnp.asarray(prompt), jnp.asarray(emb))
    last, cache = model.prefill(
        None if prompt is None else torch.from_numpy(prompt),
        embeds=torch.from_numpy(emb), cache_len=n)
    np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                               **SERVE_F32_TOL)
    assert cache["dense"]["pos"].tolist() == [P] * cfg.num_layers
    for i, t in enumerate(range(P, n)):
        tok = toks[:, 3 + i:4 + i]
        jlast, jcache = decode(jparams, jcache, jnp.asarray(tok),
                               jnp.asarray(t, jnp.int32))
        last, cache = model.decode_step(cache, torch.from_numpy(tok), t)
        np.testing.assert_allclose(last.numpy(), np.asarray(jlast),
                                   err_msg=f"decode step {t}",
                                   **SERVE_F32_TOL)
    jcache = jax.device_get(jcache)
    for k, v in cache["dense"].items():
        want = np.asarray(jcache["dense"][k])
        if k in ("slot_pos", "pos"):
            np.testing.assert_array_equal(v.numpy(), want, err_msg=k)
        else:
            np.testing.assert_allclose(v.numpy(), want, err_msg=k,
                                       **SERVE_F32_TOL)


def _jax_generate(jmodel, jparams, prompts, embeds, gen):
    """The reference's prefill + greedy `decode_step` loop over embeds
    (and tokens), decoding from position P + S."""
    P = embeds.shape[1] + (0 if prompts is None else prompts.shape[1])
    last, cache = jmodel.prefill(jparams, tokens=prompts, embeds=embeds,
                                 cache_len=P + gen)
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        last, cache = jmodel.decode_step(jparams, cache, tok,
                                         jnp.asarray(P + i, jnp.int32))
        tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


def test_generate_with_embeds_gives_the_references_tokens(pair):
    """`serve.generate(embeds=...)`, captured through `scan_steps` and one
    eager step a token: the reference's tokens, and the same logits."""
    cfg = pair["cfg"]
    emb = _embeds(cfg, 7, seed=11)
    vlm = cfg.input_mode == "tokens+embeds"
    prompts = (np.random.default_rng(12).integers(
        0, cfg.vocab_size, (B, 4)).astype(np.int32) if vlm else None)
    want = _jax_generate(pair["jmodel"], pair["jparams"],
                         None if prompts is None else jnp.asarray(prompts),
                         jnp.asarray(emb), 5)
    tp = None if prompts is None else torch.from_numpy(prompts)
    a = serve.generate(pair["model"], tp, 5, embeds=torch.from_numpy(emb))
    b = serve.generate(pair["model"], tp, 5, embeds=torch.from_numpy(emb),
                       scan=False)
    np.testing.assert_array_equal(a["tokens"].numpy(), want)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])


# --------------------------------------------------------------- bf16
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_reference_bfloat16(arch):
    jcfg, cfg = _configs(arch, "bfloat16")
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    params = training_tree_from_numpy(jparams, "cpu")
    raw = jax_batch_for(jcfg, M, B, S, seed=2)
    jlosses, _ = jax.jit(jax_api.per_client_value_and_grad(jmodel.loss))(
        jparams, jax.tree.map(jnp.asarray, raw))
    losses, grads = api.per_client_value_and_grad(
        Transformer(cfg, "cpu").loss)(params, to_torch(raw, "cpu"))
    print(f"{arch} bf16 losses: port {losses.tolist()} reference "
          f"{np.asarray(jlosses).tolist()}")
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=BF16_LOSS_RTOL)
    assert all(torch.isfinite(g.float()).all() for g in grads.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """The reference's tests/test_serve.py case (bfloat16), over an
    embedding prefix: logits from [prefill(embeds, t<8) + decode steps
    8..11] == the train forward's over the same inputs."""
    _, cfg = _configs(arch, "bfloat16")
    model = Transformer(cfg, "cpu").init(prng.prng_key(0))
    emb = torch.from_numpy(_embeds(cfg, 5, seed=13))
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(1))
    full = model.forward(toks, embeds=emb)
    last, cache = model.prefill(toks[:, :8], embeds=emb, cache_len=5 + S)
    np.testing.assert_allclose(last.float().numpy(),
                               full[:, 5 + 7].float().numpy(), rtol=2e-2,
                               atol=2e-2)
    for t in range(8, S):
        last, cache = model.decode_step(cache, toks[:, t:t + 1], 5 + t)
        np.testing.assert_allclose(
            last.float().numpy(), full[:, 5 + t].float().numpy(), rtol=4e-2,
            atol=8e-2, err_msg=f"{arch}: decode step {t} diverges")


def test_vlm_loss_leaves_the_prefix_out():
    """The VLM loss is the cross-entropy of the text positions alone (the
    prefix's labels are IGNORE_LABEL)."""
    _, cfg = _configs("llava-next-mistral-7b")
    model = Transformer(cfg, "cpu").init(prng.prng_key(1))
    batch = to_torch({k: v[0] for k, v in synthetic_batch_for(
        cfg, 1, B, 6, seed=5).items()}, "cpu")
    loss, met = model.loss(model.params, batch)
    P = batch["embeds"].shape[1]
    logits = model.forward(batch["tokens"][:, :-1], embeds=batch["embeds"])
    logp = torch.log_softmax(logits[:, P:].float(), dim=-1)
    ce = -torch.gather(logp, -1, batch["tokens"][:, 1:, None].long()).mean()
    np.testing.assert_allclose(float(loss), float(ce), rtol=1e-6)


def test_inputs_must_be_tokens_embeds_or_both():
    _, cfg = _configs("musicgen-large")
    model = Transformer(cfg, "cpu").init(prng.prng_key(0))
    with pytest.raises(ValueError, match="tokens, embeds or both"):
        model.forward(None)
