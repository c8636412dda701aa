"""The yardstick's arithmetic: the fused update's byte bound, the model
FLOP formula against PyTorch's FLOP counter on the plain model, and the
threefry copy against the port's key chains."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from pbench import ref_qwen2, threefry, traffic, yardstick  # noqa: E402
from pbench.systems.fedgia_lm import layout  # noqa: E402


def test_update_bytes_match_the_port_record():
    # (16384, 1024) at alpha 0.5 with h (m, N); (2, 1.1e9) donated, 0-d h
    assert yardstick.fedgia_update_bytes(16384, 1024, 8192,
                                         scalar_h=False) == 268_455_940
    assert yardstick.fedgia_update_bytes(2, 1_100_048_384, 1,
                                         scalar_h=True) == 35_201_548_298


def test_lsq_round_bytes_bind():
    flops, nbytes = yardstick.lsq_round(262144, 1024, 16384, 24, 0.5, 5,
                                        True)
    _, bound = yardstick.least_time_s(flops, nbytes,
                                      yardstick.PEAK_FP32_FLOPS)
    assert bound == "bytes"
    assert 1.3e9 < nbytes < 1.6e9


@pytest.mark.parametrize("seq", [8, 16])
def test_flop_formula_against_the_counter(seq):
    hf = {"hidden_size": 32, "intermediate_size": 48,
          "num_hidden_layers": 2, "num_attention_heads": 4,
          "vocab_size": 64, "rope_theta": 1e6, "rms_norm_eps": 1e-6}
    params = {k: v.float() for k, v in traffic.weights(
        layout(hf), 3, "cpu").items()}
    tokens = traffic.token_stream(3, 64, 1, 2, seq, "cpu")[0]
    with FlopCounterMode(display=False) as fc:
        ref_qwen2.value_and_grad(params, tokens, hf)
    n_tok = 2 * seq
    # the plain model computes the whole S x S score and value products;
    # the formula counts their causal half
    full_attention = 6.0 * hf["num_hidden_layers"] * seq * hf["hidden_size"]
    expect = n_tok * (ref_qwen2.flops_per_token(hf, seq) + full_attention)
    assert fc.get_total_flops() == expect


def test_threefry_copy_is_the_port_chain():
    from repro_torch.core import prng, selection
    key = threefry.prng_key(2 ** 31 + 977)
    assert np.array_equal(key, prng.prng_key(2 ** 31 + 977))
    assert np.array_equal(threefry.split(key, 5), prng.split(key, 5))
    assert np.array_equal(threefry.fold_in(key, 7), prng.fold_in(key, 7))
    assert np.array_equal(threefry.permutation(key, 300),
                          prng.permutation(key, 300))
    k1, mask = threefry.fedgia_split(key, 3, 64, 0.5)
    k2, mask2 = selection.round_split(key, 3, 64, 0.5)
    assert np.array_equal(k1, k2) and np.array_equal(mask, mask2.numpy())
    a = threefry.normal_t(key, (3, 50), "cpu")
    b = prng.normal_t(prng.key_t(key, "cpu"), (3, 50))
    assert torch.equal(a, b)
