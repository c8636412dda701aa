"""The port's `--arch` training CLI and the fl_transformer example against
the JAX package's, on reduced configs in bfloat16 (the registered
configs' dtype, in which both CLIs take their gradients).

* `test_train_driver_transformer_loss_improves`: the reference's test
  (tests/test_system.py) with the same Namespace (plus `device="cpu"`):
  the loss falls, the checkpoint is written, and the port's per-round f
  follows the reference's within rtol CLI_RTOL (1e-2) plus an atol of
  CLI_ATOL_SHARE (2e-4) times the first round's f, and over the last
  CLI_TAIL rounds (10) within rtol CLI_TAIL_RTOL (1e-2) of each round's
  own f, with no atol, so that a wrong late trajectory fails. Not 1e-5:
  each side rounds its bf16 activations and gradients where the other
  does not (XLA:CPU fuses elementwise chains in fp32,
  tests/test_torch_train_arch.py), and r_hat comes from a bf16 probe
  too, so the trajectories part at bf16 resolution. Measured: f falls
  from 6.80 to 0.0060 over the 30 rounds; the largest gap is 8.8e-4
  absolute, 3.8e-2 relative, at round 10; over the last 10 rounds at
  most 3.8e-3 relative; the last round 1.5e-4. The same rounds in
  float32 agree at rtol 1e-5 (tests/test_torch_train_engine.py).
* `--h-policy diag_ema`: the chunked driver and `--no-scan` bit for bit,
  and against the reference CLI at the same tolerance.
* `--kernel`: auto/on/off resolve to `FedConfig.use_kernel`, interpret
  is rejected, `use_kernel=True` raises on the CPU, off runs the same
  plain version as auto there (bit for bit).
* the fl_transformer example's own check at a small width.
"""
import argparse

import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step
from repro.launch import train as jax_train
from repro_torch.config import FedConfig, ModelConfig
from repro_torch.examples import fl_transformer
from repro_torch.launch import train

CLI_RTOL = 1e-2
CLI_ATOL_SHARE = 2e-4
CLI_TAIL, CLI_TAIL_RTOL = 10, 1e-2


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _f(result):
    return np.array([h["f"] for h in result["history"]])


def _hold(got, want):
    f, w = _f(got), _f(want)
    assert len(f) == len(w)
    np.testing.assert_allclose(f, w, rtol=CLI_RTOL,
                               atol=CLI_ATOL_SHARE * abs(w[0]))
    np.testing.assert_allclose(f[-CLI_TAIL:], w[-CLI_TAIL:],
                               rtol=CLI_TAIL_RTOL, atol=0.0)


def test_train_driver_transformer_loss_improves(tmp_path):
    """Federated LM training on a reduced arch: loss must go DOWN."""
    common = dict(
        problem="linreg", arch="tinyllama-1.1b", reduced=True, algo="fedgia",
        clients=4, k0=3, alpha=1.0, sigma_t=0.3, h_policy="scalar",
        unrolled=False, lr=0.01, rounds=30, tol=0.0, dim=0, samples=0,
        batch=2, seq_len=32, seed=0, log_every=10,
    )
    result = train.train(argparse.Namespace(
        **common, checkpoint_dir=str(tmp_path / "ck"), device="cpu"))
    hist = result["history"]
    assert hist[-1]["f"] < hist[0]["f"], (
        f"loss did not improve: {hist[0]['f']} -> {hist[-1]['f']}")
    assert np.isfinite(hist[-1]["f"])
    # checkpoint was written and is reloadable
    from repro_torch.checkpoint import latest_step as port_latest_step

    assert port_latest_step(str(tmp_path / "ck")) == len(hist)
    want = jax_train.train(argparse.Namespace(
        **common, checkpoint_dir=str(tmp_path / "jck")))
    assert latest_step(str(tmp_path / "jck")) == len(hist)
    print(f"f: port {_f(result).tolist()}\n   reference {_f(want).tolist()}")
    _hold(result, want)


DIAG = ["--arch", "tinyllama-1.1b", "--reduced", "--algo", "fedgia",
        "--clients", "2", "--k0", "3", "--sigma-t", "30", "--rounds", "4",
        "--tol", "0", "--seq-len", "16", "--h-policy", "diag_ema"]


def test_cli_diag_ema_both_drivers_match_reference():
    chunked = train.main(DIAG + ["--device", "cpu"])
    eager = train.main(DIAG + ["--device", "cpu", "--no-scan"])
    assert [h["f"] for h in chunked["history"]] == \
        [h["f"] for h in eager["history"]]
    for k in ("x", "z", "pi", "h"):
        for leaf, v in chunked["state"][k].items():
            assert torch.equal(v, eager["state"][k][leaf]), (k, leaf)
    want = jax_train.train(jax_train.build_parser().parse_args(DIAG))
    _hold(chunked, want)
    assert _f(chunked)[-1] < _f(chunked)[0]


def _args(*argv):
    return train.build_parser().parse_args(list(argv))


def test_kernel_flag_resolved():
    """The kernel half of the reference's
    `test_flat_and_kernel_knobs_resolved`; interpret is rejected."""
    assert train.validate_flags(_args())["use_kernel"] is None
    assert train.validate_flags(_args("--kernel", "off"))["use_kernel"] \
        is False
    assert train.validate_flags(_args("--kernel", "on"))["use_kernel"] is True
    with pytest.raises(SystemExit, match="interpret"):
        train.validate_flags(_args("--kernel", "interpret"))
    with pytest.raises(ValueError, match="interpret"):
        FedConfig(kernel_interpret=True)


def test_kernel_on_raises_on_the_cpu_and_off_is_auto():
    small = ["--device", "cpu", "--clients", "8", "--dim", "16",
             "--samples", "320", "--rounds", "4", "--tol", "0"]
    with pytest.raises(ValueError, match="CPU has no fedgia_update"):
        train.main(small + ["--kernel", "on"])
    auto, off = (train.main(small + ["--kernel", k]) for k in ("auto", "off"))
    assert [h["f"] for h in auto["history"]] == \
        [h["f"] for h in off["history"]]
    for k in ("x", "z", "pi"):
        assert torch.equal(auto["state"][k]["x"], off["state"][k]["x"])


def test_fl_transformer_example_improves():
    """The example at a small width (2 layers, d_model 64): 12 rounds in
    chunks of 10 and 2, f finite every round and falling."""
    cfg = ModelConfig(name="fl-lm-tiny", family="dense", num_layers=2,
                      d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
                      vocab_size=256, dtype="float32")
    args = fl_transformer.build_parser().parse_args(
        ["--rounds", "12", "--seq-len", "16", "--device", "cpu"])
    out = fl_transformer.run(args, cfg, say=lambda *a: None)
    assert len(out["f"]) == 12 and all(np.isfinite(out["f"]))
    assert out["f"][-1] < out["f"][0]
    assert out["sigma"] == pytest.approx(30.0 * out["r_hat"] / 4, rel=1e-6)
