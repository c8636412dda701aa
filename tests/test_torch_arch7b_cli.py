"""The port's serving and training CLIs on the reduced hymba-1.5b,
musicgen-large and llava-next-mistral-7b against the JAX package's, in
float32.

Serving: `repro_torch.launch.serve.serve(..., device cpu)` is given the
reference's parameters and numpy prompts and must generate the tokens of
the reference's prefill + greedy `decode_step` loop (the loop
`repro.launch.serve` runs); both CLIs serve token prompts for every
architecture, the embeds configs included. The logits agree to ~1e-5
(tests/test_torch_hybrid_ssm.py, tests/test_torch_embeds.py), far inside
the gaps between the top two logits.

Training: `train --arch X --reduced --device cpu` against the
reference's CLI (its `--no-scan` loop; the port's default chunked
driver), both reading the config through a `get_config` that makes it
float32 (neither CLI has a dtype flag). The same rounds; every round's
f at rtol 1e-5. Both CLIs take the port's Lipschitz probe (the
reference's through a host callback on its own arrays): f after round 0
moves with sigma = t r_hat / m, and on these models the reference's
jitted float32 probe lies 2.8e-4 (musicgen), 1.0e-3 (llava) and 2.4e-3
(hymba) from a float64 witness of the same probe, where the port's lies
within 3.4e-7 of it (measured; `test_probe_is_near_its_float64_witness`
holds the port to PROBE_WITNESS_RTOL and prints the reference's gap).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.core import hparams as jax_hparams
from repro.launch import train as jax_train
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.models import Transformer as JaxTransformer
import repro_torch.configs as port_configs
from repro_torch.core import hparams, prng
from repro_torch.data import to_torch
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train
from repro_torch.models import Transformer
from repro_torch.utils.convert import training_tree_from_numpy

ARCHS = ["hymba-1.5b", "musicgen-large", "llava-next-mistral-7b"]
ARGV = ["--reduced", "--clients", "2", "--k0", "3", "--alpha", "1.0",
        "--sigma-t", "30", "--rounds", "3", "--tol", "0", "--batch", "2",
        "--seq-len", "16"]
PROBE_WITNESS_RTOL = 1e-6


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _float32(get_config):
    return lambda name: dataclasses.replace(get_config(name),
                                            dtype="float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generates_the_reference_tokens(arch, monkeypatch):
    jcfg = dataclasses.replace(jax_configs.get_config(arch).reduced(),
                               dtype="float32")
    jmodel = JaxTransformer(jcfg)
    jparams = jax.device_get(jmodel.init(jax.random.PRNGKey(3)))
    prompts = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (2, 12)).astype(np.int32)
    gen = 6
    last, cache = jmodel.prefill(jparams, tokens=jnp.asarray(prompts),
                                 cache_len=12 + gen)
    tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
    want = [tok]
    for i in range(gen - 1):
        last, cache = jmodel.decode_step(jparams, cache, tok,
                                         jnp.asarray(12 + i, jnp.int32))
        tok = jnp.argmax(last, axis=-1)[:, None].astype(jnp.int32)
        want.append(tok)
    want = np.asarray(jnp.concatenate(want, axis=1))

    monkeypatch.setattr(serve_mod, "get_config",
                        _float32(port_configs.get_config))
    args = serve_mod.build_parser().parse_args(
        ["--arch", arch, "--reduced", "--batch", "2", "--prompt-len", "12",
         "--gen", str(gen), "--device", "cpu"])
    got = serve_mod.serve(args, params=training_tree_from_numpy(
        jparams, "cpu"), prompts=prompts)
    np.testing.assert_array_equal(got, want)


def _port_probe(arch):
    """The reference's `estimate_lipschitz` replaced by the port's on the
    same arrays (a host callback, a client at a time under the FedGiA
    init's vmap)."""
    model = Transformer(_float32(port_configs.get_config)(arch).reduced(),
                        "cpu")

    def host(params, batch, key, kw):
        r = hparams.estimate_lipschitz(
            model.loss, training_tree_from_numpy(params, "cpu"),
            to_torch(batch, "cpu"), np.asarray(key, np.uint32), **kw)
        return np.float32(r)

    def probe(loss_fn, params, batch, key, **kw):
        return jax.pure_callback(
            functools.partial(host, kw=kw),
            jax.ShapeDtypeStruct((), jnp.float32), params, batch, key,
            vmap_method="sequential")
    return probe


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_rounds_match_reference_float32(arch, monkeypatch):
    monkeypatch.setattr(jax_train, "get_config",
                        _float32(jax_configs.get_config))
    monkeypatch.setattr(train, "get_config",
                        _float32(port_configs.get_config))
    monkeypatch.setattr(jax_hparams, "estimate_lipschitz", _port_probe(arch))
    argv = ["--arch", arch] + ARGV
    want = jax_train.train(jax_train.build_parser().parse_args(
        argv + ["--no-scan"]))
    got = train.main(argv + ["--device", "cpu"])
    assert got["rounds"] == want["rounds"] == 3
    f = np.array([h["f"] for h in got["history"]])
    w = np.array([h["f"] for h in want["history"]])
    print(f"{arch}: f {f.tolist()} reference {w.tolist()}")
    np.testing.assert_allclose(f, w, rtol=1e-5)
    assert f[-1] < f[0]
    assert {v.dtype for v in got["state"]["x"].values()} == {torch.float32}


@pytest.mark.parametrize("arch", ARCHS)
def test_probe_is_near_its_float64_witness(arch):
    """Client 0's probe, as the CLIs take it (FedGiA's key split, the
    CLI's batch), against the same probe in float64 (A_log stays float32,
    as the SSM scans in float32): the port within PROBE_WITNESS_RTOL; the
    reference's jitted float32 probe's gap printed."""
    jcfg = _float32(jax_configs.get_config)(arch).reduced()
    cfg = _float32(port_configs.get_config)(arch).reduced()
    jmodel = JaxTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    params = training_tree_from_numpy(jax.device_get(jparams), "cpu")
    raw = jax_batch_for(jcfg, 2, 2, 16, seed=0)
    key = prng.split(prng.prng_key(1), 2)[0]
    batch = {k: v[0] for k, v in to_torch(raw, "cpu").items()}
    got = float(hparams.estimate_lipschitz(Transformer(cfg, "cpu").loss,
                                           params, batch, key))
    wide = {k: v if k.endswith("A_log") else v.double()
            for k, v in params.items()}
    witness = float(hparams.estimate_lipschitz(
        Transformer(dataclasses.replace(cfg, dtype="float64"), "cpu").loss,
        wide, {k: v.double() if v.is_floating_point() else v
               for k, v in batch.items()}, key))
    ref = float(jax.jit(lambda p, b, k: jax_hparams.estimate_lipschitz(
        jmodel.loss, p, b, k))(jparams, jax.tree.map(
            lambda a: jnp.asarray(a[0]), raw), jnp.asarray(key, jnp.uint32)))
    print(f"{arch} r_hat: port {got!r}, reference (jitted) {ref!r}, float64 "
          f"witness {witness!r}: port {(got - witness) / witness!r}, "
          f"reference {(ref - witness) / witness!r} from it")
    np.testing.assert_allclose(got, witness, rtol=PROBE_WITNESS_RTOL)
