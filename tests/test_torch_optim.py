"""The port's token data and optimizers against the JAX package's
(mirrors of tests/test_data_optim_ckpt.py's `test_synthetic_batch_modes`,
in every registered architecture's input mode, `test_paper_lr_schedule`
and `test_sgd_adam_reduce_quadratic`).

* tokens, labels and embeddings: bit for bit (both are numpy with the
  same generators);
* SGD (with momentum) and Adam on the same gradients: every step's
  parameters at rtol 1e-6 (float32, the same operations; JAX's Adam
  rounds `b ** count` and the bias corrections through XLA:CPU's pow);
* the schedules at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHITECTURES as JAX_ARCHS
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.optim import adam as jax_adam
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import cosine as jax_cosine
from repro.optim import paper_lr as jax_paper_lr
from repro.optim import sgd as jax_sgd
from repro_torch.configs import ARCHITECTURES
from repro_torch.data import synthetic_batch_for, synthetic_lm_batches
from repro_torch.optim import adam, apply_updates, cosine, paper_lr, sgd


@pytest.mark.parametrize("arch", sorted(ARCHITECTURES))
def test_tokens_are_the_references_bit_for_bit(arch):
    cfg = ARCHITECTURES[arch].reduced()
    got = synthetic_batch_for(cfg, m=3, batch_per_client=2, seq_len=8,
                              seed=5)
    want = jax_batch_for(JAX_ARCHS[arch].reduced(), m=3, batch_per_client=2,
                         seq_len=8, seed=5)
    assert set(got) == set(want) == {
        "tokens": {"tokens"}, "embeds": {"embeds", "labels"},
        "tokens+embeds": {"embeds", "tokens"}}[cfg.input_mode]
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    toks = got["tokens"] if "tokens" in got else got["labels"]
    assert toks.dtype == np.int32
    assert toks.shape[:2] == (3, 2)  # test_synthetic_batch_modes


def test_lm_stream_has_the_planted_bigram():
    toks = synthetic_lm_batches(0, 64, 2, 4, 32)
    assert toks.shape == (2, 4, 33) and toks.min() >= 0 and toks.max() < 64
    for i in range(2):  # half the steps follow t + shift
        steps = (toks[i, :, 1:] - toks[i, :, :-1]) % 64
        assert np.bincount(steps.ravel()).max() >= 0.4 * steps.size


def test_paper_lr_schedule():
    lr = paper_lr(0.5)
    assert abs(float(lr(torch.tensor(0))) - 0.5) < 1e-6  # log2(2) = 1
    assert float(lr(torch.tensor(100))) < 0.08
    for c in (0, 1, 7, 100):
        np.testing.assert_allclose(
            float(lr(torch.tensor(c, dtype=torch.int32))),
            float(jax_paper_lr(0.5)(jnp.asarray(c, jnp.int32))), rtol=1e-6)
        np.testing.assert_allclose(
            float(cosine(0.3, 50, 5)(torch.tensor(c, dtype=torch.int32))),
            float(jax_cosine(0.3, 50, 5)(jnp.asarray(c, jnp.int32))),
            rtol=1e-6, atol=1e-7)


def test_sgd_adam_reduce_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    for opt in (sgd(0.1), adam(0.2)):
        p = params
        state = opt.init(p)
        for _ in range(200):
            g = torch.func.grad(lambda q: torch.sum(q["w"] ** 2))(p)
            upd, state = opt.update(g, state, p)
            p = apply_updates(p, upd)
        assert float(p["w"].abs().max()) < 1e-2


@pytest.mark.parametrize("which", ["sgd", "sgd_momentum", "adam"])
def test_optimizer_steps_match_reference(which):
    make = {"sgd": (lambda: sgd(0.05), lambda: jax_sgd(0.05)),
            "sgd_momentum": (lambda: sgd(paper_lr(0.1), momentum=0.9),
                             lambda: jax_sgd(jax_paper_lr(0.1),
                                             momentum=0.9)),
            "adam": (lambda: adam(0.01), lambda: jax_adam(0.01))}[which]
    opt, jopt = make[0](), make[1]()
    w0 = np.random.default_rng(0).standard_normal((3, 4)).astype(np.float32)
    p, jp = {"w": torch.from_numpy(w0.copy())}, {"w": jnp.asarray(w0)}
    st, jst = opt.init(p), jopt.init(jp)
    for step in range(6):
        g = np.sin(w0 * (step + 1)).astype(np.float32)
        upd, st = opt.update({"w": torch.from_numpy(g)}, st, p)
        jupd, jst = jopt.update({"w": jnp.asarray(g)}, jst, jp)
        p, jp = apply_updates(p, upd), jax_apply_updates(jp, jupd)
        np.testing.assert_allclose(p["w"].numpy(), np.asarray(jp["w"]),
                                   rtol=1e-6, atol=1e-7,
                                   err_msg=f"step {step}")
    assert int(st["count"]) == int(jst["count"]) == 6
