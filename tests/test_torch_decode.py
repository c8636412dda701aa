"""The port's captured decode (`core/graphs.py::scan_steps` in
`launch/serve.py`) against the reference's serving loop.

On the CPU `scan_steps` runs the step function that the card captures,
eagerly: the same `decode_step` with a 0-d tensor position, the cache,
the token and the position updated in place. Each side gets the same
inputs: the reference's own parameters and prompts (`jax.random` of the
CLI's seed, carried across with `utils.convert`), in float32 (the
reduced configs' dtype replaced, as tests/test_torch_serve.py does), so
the argmax is far from a tie:

  * `serve` gives the reference's tokens, for its default (`scan_steps`)
    and for `--no-scan`, and the port's two modes agree with each other
    bit for bit, logits included;
  * the ring buffer wraps under `--long-context`;
  * a 0-d tensor position is the int position, bit for bit;
  * the fp8 cache: the reference test's bound against the bf16 cache
    (tests/test_serve.py), port against reference within 2e-2 of the
    logits' scale, and the reference's cast of an entry above 464 to NaN;
  * `examples/serve_requests.py`: every request's tokens.
"""
import dataclasses
import importlib.util
import io
import os
import types
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve
from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.core.graphs import scan_steps
from repro_torch.core.prng import prng_key
from repro_torch.examples import serve_requests
from repro_torch.launch import serve as serve_mod
from repro_torch.models import Transformer
from repro_torch.models.attention import _write_cache, cast_to_cache
from repro_torch.utils.convert import training_tree_from_numpy

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _args(arch, prompt_len, gen, long_context, no_scan, seed=0):
    return types.SimpleNamespace(
        arch=arch, reduced=True, batch=2, prompt_len=prompt_len, gen=gen,
        long_context=long_context, no_scan=no_scan, seed=seed, device="cpu")


def _reference_inputs(arch, args):
    """The parameters and prompts the reference's `serve` draws."""
    jcfg = _f32(jax_get_config(arch).reduced())
    rng = jax.random.PRNGKey(args.seed)
    params = jax.device_get(JaxTransformer(jcfg).init(rng))
    prompts = np.asarray(jax.random.randint(
        rng, (args.batch, args.prompt_len), 0, jcfg.vocab_size,
        dtype=jnp.int32))
    return params, prompts


@pytest.mark.parametrize("arch,prompt_len,gen,long_context", [
    ("tinyllama-1.1b", 12, 6, False),
    ("qwen1.5-0.5b", 12, 6, False),
    ("rwkv6-3b", 12, 6, False),
    # prompt past the window (64), and decode wraps the ring buffer again
    ("tinyllama-1.1b", 70, 8, True),
])
def test_serve_matches_reference_scan_and_no_scan(monkeypatch, arch,
                                                  prompt_len, gen,
                                                  long_context):
    monkeypatch.setattr(jax_serve, "get_config",
                        lambda name: _f32(jax_get_config(name)))
    monkeypatch.setattr(serve_mod, "get_config",
                        lambda name: _f32(get_config(name)))
    params, prompts = _reference_inputs(
        arch, _args(arch, prompt_len, gen, long_context, False))
    torch_params = training_tree_from_numpy(params, "cpu")
    got = {}
    for no_scan in (False, True):
        args = _args(arch, prompt_len, gen, long_context, no_scan)
        want = jax_serve.serve(args)
        got[no_scan] = serve_mod.serve(args, params=torch_params,
                                       prompts=prompts)
        np.testing.assert_array_equal(got[no_scan], want,
                                      err_msg=f"no_scan={no_scan}")
    np.testing.assert_array_equal(got[False], got[True])


def _model(arch, seed=0, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype=dtype)
    return Transformer(cfg, "cpu").init(prng_key(seed))


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_captured_step_is_the_eager_loop_bitwise(arch):
    """`generate`'s two modes: the same tokens and the same logits, bit
    for bit, and the logits each token was taken from."""
    model = _model(arch)
    prompts = torch.randint(0, model.cfg.vocab_size, (3, 9),
                            generator=torch.Generator().manual_seed(1))
    a = serve_mod.generate(model, prompts, 7, scan=True)
    b = serve_mod.generate(model, prompts, 7, scan=False)
    assert torch.equal(a["tokens"], b["tokens"])
    assert torch.equal(a["logits"], b["logits"])
    assert tuple(a["logits"].shape) == (7, 3, model.cfg.vocab_size)
    assert torch.equal(a["tokens"].T, a["logits"].argmax(-1))
    assert a["capture_s"] == 0.0 and b["capture_s"] == 0.0


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_tensor_position_is_the_int_position(arch):
    model = _model(arch)
    prompts = torch.randint(0, model.cfg.vocab_size, (2, 10),
                            generator=torch.Generator().manual_seed(2))
    _, c_int = model.prefill(prompts, cache_len=16)
    _, c_t = model.prefill(prompts, cache_len=16)
    tok = torch.tensor([[3], [5]])
    for p in range(10, 14):
        l_int, c_int = model.decode_step(c_int, tok, p)
        l_t, c_t = model.decode_step(c_t, tok,
                                     torch.tensor(p, dtype=torch.int32))
        assert torch.equal(l_int, l_t), p
        tok = l_int.argmax(-1)[:, None]
    for g in c_int:
        for k in c_int[g]:
            assert torch.equal(c_int[g][k], c_t[g][k]), (g, k)


def test_scan_steps_stacks_outputs_and_advances_the_carry():
    def step(carry, inc):
        x, n = carry
        return (x * 2 + inc, n + 1), (x.clone(), n)

    x, n = torch.ones(3), torch.zeros((), dtype=torch.int64)
    run = scan_steps(step, 4)
    (x2, n2), (xs, ns) = run((x, n), 1.0)
    assert x2 is x and n2 is n  # the caller's buffers, advanced in place
    assert torch.equal(xs[:, 0], torch.tensor([1.0, 3.0, 7.0, 15.0]))
    assert torch.equal(ns, torch.arange(4))
    assert float(x[0]) == 31.0 and int(n) == 4
    with pytest.raises(ValueError, match="num_steps"):
        scan_steps(step, 0)


# -------------------------------------------------------------- fp8 cache
FP8 = torch.float8_e4m3fn


def _fp8_runs(jparams, jmodel, model, toks):
    """Prefill 8 tokens, then 8 decode steps, with a bf16 and an fp8
    cache, on both packages. Returns per step (port bf16, port fp8,
    reference fp8) logits."""
    _, c16 = model.prefill(toks[:, :8], cache_len=16)
    _, c8 = model.prefill(toks[:, :8], cache_len=16, cache_dtype=FP8)
    jt = jnp.asarray(toks.numpy())
    _, j8 = jmodel.prefill(jparams, tokens=jt[:, :8], cache_len=16,
                           cache_dtype=jnp.float8_e4m3fn)
    assert c8["dense"]["k"].dtype == FP8
    out = []
    for t in range(8, 16):
        tok = toks[:, t:t + 1]
        pos = torch.tensor(t, dtype=torch.int32)
        l16, c16 = model.decode_step(c16, tok, pos)
        l8, c8 = model.decode_step(c8, tok, pos)
        lj, j8 = jmodel.decode_step(jparams, j8, jt[:, t:t + 1],
                                    jnp.asarray(t, jnp.int32))
        out.append((l16.float(), l8.float(),
                    torch.from_numpy(np.asarray(lj, np.float32))))
    return out


def test_fp8_cache_close_to_bf16_and_to_reference():
    """The reference test's bound (err < 0.15·max|logit| + 0.5 against
    the bf16 cache) on the port, and the port's fp8 logits within
    2e-2·max|logit| of the reference's: both read the same fp8 cache
    values, which differ only where a bf16 K/V entry lies within a
    rounding of an fp8 tie."""
    jcfg = jax_get_config("tinyllama-1.1b").reduced()
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(0)))
    model = Transformer(get_config("tinyllama-1.1b").reduced(), "cpu")
    model.load_params(training_tree_from_numpy(jparams, "cpu"))
    toks = torch.from_numpy(np.asarray(jax.random.randint(
        jax.random.PRNGKey(3), (2, 16), 0, jcfg.vocab_size))).long()
    for t, (l16, l8, lj) in enumerate(_fp8_runs(jparams, jmodel, model,
                                                toks)):
        scale = float(l16.abs().max())
        assert float((l8 - l16).abs().max()) < 0.15 * scale + 0.5, t
        assert float((l8 - lj).abs().max()) < 2e-2 * scale, t


def test_fp8_cast_is_the_references():
    """Every bf16 value's fp8 bits as the reference's cast gives them:
    NaN above 464 and for ±inf (torch alone would saturate at 448)."""
    x = np.array([0.0, -0.0, 1.0, 447, 448, 455, 456, 464, 465, 480, 500,
                  -464, -465, 1e4, np.inf, -np.inf, np.nan, 3.3e-3, 1e-9],
                 np.float32)
    bits = np.arange(1 << 16, dtype=np.uint32) << 16  # every bf16 value
    allbf = np.concatenate([x, bits.view(np.float32)])
    want = np.asarray(jnp.asarray(allbf, jnp.bfloat16).astype(
        jnp.float8_e4m3fn)).view(np.uint8)
    got = cast_to_cache(torch.from_numpy(allbf).bfloat16(), FP8)
    got = got.view(torch.uint8).numpy()
    nan_w = np.isnan(want.view(jnp.float8_e4m3fn).astype(np.float32))
    nan_g = np.isnan(got.view(jnp.float8_e4m3fn).astype(np.float32))
    np.testing.assert_array_equal(nan_g, nan_w)
    np.testing.assert_array_equal(got[~nan_w], want[~nan_w])
    # 465 rounds to bf16's 464 (ties to even), the last value kept
    assert nan_g[list(x).index(480)] and not nan_g[list(x).index(465)]


def test_fp8_cache_entry_above_464_is_nan_as_in_the_reference():
    """A K entry that rounds past 448 becomes NaN in both caches, so the
    step's logits are NaN on both sides."""
    model = _model("tinyllama-1.1b")
    toks = torch.tensor([[1, 2, 3, 4]])
    _, cache = model.prefill(toks, cache_len=8, cache_dtype=FP8)
    k = cache["dense"]["k"]
    big = torch.full_like(k[0, :, :1], 465.0, dtype=torch.float32)
    layer0 = {n: t[0] for n, t in cache["dense"].items()}
    _write_cache(layer0, big, big, torch.tensor([4]))
    assert torch.isnan(cache["dense"]["k"][0, :, 4].float()).all()
    want = np.asarray(jnp.asarray(465.0, jnp.float32).astype(
        jnp.float8_e4m3fn).astype(jnp.float32))
    assert np.isnan(want)


# --------------------------------------------------------- serve_requests
def _reference_serve_requests(monkeypatch, argv):
    spec = importlib.util.spec_from_file_location(
        "reference_serve_requests",
        os.path.join(ROOT, "examples", "serve_requests.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "get_config",
                        lambda name: _f32(jax_get_config(name)))
    monkeypatch.setattr("sys.argv", ["serve_requests.py"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "rwkv6-3b"])
def test_serve_requests_matches_reference(monkeypatch, arch):
    argv = ["--arch", arch, "--requests", "3", "--max-prompt", "10",
            "--gen", "5"]
    want = _reference_serve_requests(monkeypatch, argv)
    jcfg = _f32(jax_get_config(arch).reduced())
    jparams = jax.device_get(JaxTransformer(jcfg).init(
        jax.random.PRNGKey(0)))
    monkeypatch.setattr(serve_requests, "get_config",
                        lambda name: _f32(get_config(name)))
    for no_scan in (False, True):
        args = serve_requests.build_parser().parse_args(
            argv + ["--device", "cpu"] + (["--no-scan"] if no_scan else []))
        buf = io.StringIO()
        with redirect_stdout(buf):
            serve_requests.run(args, params=training_tree_from_numpy(
                jparams, "cpu"))
        got = buf.getvalue()
        for line in want.splitlines():  # the lens line and every request's
            if line.startswith(("arch=", "  req")):
                assert line in got, (no_scan, line)
