"""The port's training CLI on the reduced MoE/MLA architectures
(`--arch deepseek-v3-671b --reduced`, `--arch arctic-480b --reduced`)
against the JAX package's CLI, in float32.

Neither CLI has a dtype flag, so both read the config through a
`get_config` that replaces its dtype with float32. The reference's
Lipschitz probe runs jitted (`jax.jit` of its own `estimate_lipschitz`):
eagerly, under the FedGiA init's `vmap`, it compiles op by op and takes
over a minute for DeepSeek-V3's reduced config; the function is the
same. Its runs stay `--no-scan` (the reference's drivers give the same
rounds), the port's take the default chunked driver.

Tolerance: the same rounds; every round's f at rtol 1e-5 (measured:
8.6e-7 for DeepSeek-V3, 4.1e-6 for Arctic, both by the third round; f
after round 0 moves with sigma = t r_hat / m, so it holds the probe
too). The port's state is float32, as the reference's. sigma_t is 30,
as `examples/fl_transformer.py`: at 3 these models' f falls 85 % in
four rounds and the two sides' float32 differences grow about fourfold
a round.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jax_configs
from repro.core import hparams as jax_hparams
from repro.launch import train as jax_train
import repro_torch.configs as port_configs
from repro_torch.launch import train

ARGV = ["--reduced", "--clients", "2", "--k0", "3", "--alpha", "1.0",
        "--sigma-t", "30", "--rounds", "3", "--tol", "0", "--batch", "2",
        "--seq-len", "16"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "arctic-480b"])
def test_cli_rounds_match_reference_float32(arch, monkeypatch):
    monkeypatch.setattr(jax_train, "get_config", lambda n: dataclasses.replace(
        jax_configs.get_config(n), dtype="float32"))
    monkeypatch.setattr(train, "get_config", lambda n: dataclasses.replace(
        port_configs.get_config(n), dtype="float32"))
    probe = jax_hparams.estimate_lipschitz
    monkeypatch.setattr(
        jax_hparams, "estimate_lipschitz",
        lambda f, p, b, k, **kw: jax.jit(functools.partial(probe, f, **kw))(
            p, b, k))
    argv = ["--arch", arch] + ARGV
    want = jax_train.train(jax_train.build_parser().parse_args(
        argv + ["--no-scan"]))
    got = train.main(argv + ["--device", "cpu"])
    assert got["rounds"] == want["rounds"] == 3
    f = np.array([h["f"] for h in got["history"]])
    w = np.array([h["f"] for h in want["history"]])
    np.testing.assert_allclose(f, w, rtol=1e-5)
    assert f[-1] < f[0]
    spec_dtypes = {v.dtype for v in got["state"]["x"].values()}
    assert spec_dtypes == {torch.float32}
