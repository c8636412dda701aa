"""The port's serving driver against the JAX package's serving loop.

`repro_torch.launch.serve.serve(..., device cpu)` is given the JAX
package's parameters (carried across with `utils.convert`) and prompts
(made with numpy from a seed; `jax.random.randint`'s stream cannot be
reproduced), and must generate the same tokens as the reference's
`prefill` + greedy `decode_step` loop, the loop `repro.launch.serve`
runs. In float32 (the reduced configs' dtype replaced): there, both
packages' logits agree to ~1e-5 (tests/test_torch_transformer.py), far
inside the gaps between the top two logits, so the argmax is the same.
"""
import dataclasses
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import Transformer as JaxTransformer
from repro_torch.configs import get_config
from repro_torch.core.prng import prng_key
from repro_torch.launch import serve as serve_mod
from repro_torch.utils.convert import training_tree_from_numpy

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")


def _jax_generate(model, params, prompts, gen, window):
    last, cache = model.prefill(params, tokens=prompts,
                                cache_len=prompts.shape[1] + gen,
                                window=window)
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    out = [tok]
    for i in range(gen - 1):
        pos = jnp.asarray(prompts.shape[1] + i, jnp.int32)
        last, cache = model.decode_step(params, cache, tok, pos,
                                        window=window)
        tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        out.append(tok)
    return np.asarray(jnp.concatenate(out, axis=1))


@pytest.mark.parametrize("arch,prompt_len,long_context", [
    ("tinyllama-1.1b", 16, False),
    ("tinyllama-1.1b", 72, True),  # the window (64) cuts the prompt
    ("qwen1.5-0.5b", 16, False),
    ("rwkv6-3b", 16, False),
])
def test_serve_generates_the_reference_tokens(monkeypatch, arch, prompt_len,
                                              long_context):
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, prompt_len)).astype(np.int32)
    gen = 6
    want = _jax_generate(jmodel, jparams, jnp.asarray(prompts), gen,
                         jcfg.sliding_window if long_context else None)

    monkeypatch.setattr(serve_mod, "get_config", lambda name: dataclasses.
                        replace(get_config(name), dtype="float32"))
    args = serve_mod.build_parser().parse_args(
        ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len",
         str(prompt_len), "--gen", str(gen), "--device", "cpu"]
        + (["--long-context"] if long_context else []))
    got = serve_mod.serve(args, params=training_tree_from_numpy(
        jparams, "cpu"), prompts=prompts)
    np.testing.assert_array_equal(got, want)


def test_generate_returns_tokens_and_their_logits():
    cfg = get_config("rwkv6-3b").reduced()
    model = serve_mod.Transformer(cfg, "cpu").init(prng_key(0))
    prompts = torch.randint(0, cfg.vocab_size, (3, 5),
                            generator=torch.Generator().manual_seed(1))
    res = serve_mod.generate(model, prompts, 4)
    assert tuple(res["tokens"].shape) == (3, 4)
    assert tuple(res["logits"].shape) == (4, 3, cfg.vocab_size)
    assert torch.equal(res["tokens"].T, res["logits"].argmax(-1))
    assert res["prefill_s"] > 0 and res["decode_s"] > 0


def test_cli_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve_mod.main(["--arch", "tinyllama-1.1b", "--reduced"])


def test_cli_runs_on_cpu_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "tinyllama-1.1b", "--reduced", "--batch", "2",
         "--prompt-len", "8", "--gen", "4"],
        env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
        timeout=120)
    assert out.returncode == 0, out.stderr
    assert "prefill" in out.stderr and "tok/s/req" in out.stderr
    assert "generated[0,:16] = [" in out.stderr


def test_serving_path_imports_neither_jax_nor_repro():
    code = (
        "import sys, repro_torch.launch.serve, repro_torch.configs\n"
        "import repro_torch.kernels.flash_attention, "
        "repro_torch.kernels.rwkv6_scan, repro_torch.utils.convert\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.core.prng, repro_torch.core.graphs, "
        "repro_torch.examples.serve_requests\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code],
                         env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_registry_holds_the_ported_architectures():
    from repro.configs import ARCHITECTURES as JAX_ARCHS
    from repro_torch.configs import ARCHITECTURES, list_architectures

    assert list_architectures() == sorted(JAX_ARCHS) == [
        "arctic-480b", "deepseek-67b", "deepseek-v3-671b", "hymba-1.5b",
        "llava-next-mistral-7b", "musicgen-large", "qwen1.5-0.5b",
        "rwkv6-3b", "stablelm-12b", "tinyllama-1.1b"]
    for name, cfg in ARCHITECTURES.items():
        want = JAX_ARCHS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
        assert dataclasses.asdict(cfg.reduced()) == dataclasses.asdict(
            want.reduced())
        assert cfg.param_count() == want.param_count()
        assert get_config(name) is cfg
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("mamba-2.8b")


def test_every_kernel_source_is_built():
    """The build compiles the serving path's two kernels beside slice 1's
    and the round driver's conditional graph nodes (all in parallel, at
    first use), each into a library named by its source."""
    from repro_torch.kernels import _build

    assert set(_build.SOURCES) == {"fedgia_update", "flash_attention",
                                   "rwkv6_scan", "graph_if"}
    for name, src in _build.SOURCES.items():
        assert src.is_file() and src.suffix == ".cu"
        assert _build.library_path(name).name.startswith(name + "-")


@pytest.mark.parametrize("name", ["fedgia_update", "flash_attention",
                                  "rwkv6_scan"])
def test_each_kernel_builds_with_its_own_flags(name, monkeypatch):
    """nvcc flags are per source and part of each library's hash: a change
    of one kernel's flags renames (so rebuilds) that library alone. The
    bitwise kernels keep --fmad=false."""
    from repro_torch.kernels import _build

    flags = _build.nvcc_flags(name)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert ("--fmad=false" in flags) == (name != "flash_attention")
    before = {n: _build.library_path(n) for n in _build.SOURCES}
    monkeypatch.setitem(_build.SOURCE_FLAGS, name,
                        _build.SOURCE_FLAGS[name] + ("-lineinfo",))
    after = {n: _build.library_path(n) for n in _build.SOURCES}
    assert {n for n in before if before[n] != after[n]} == {name}
