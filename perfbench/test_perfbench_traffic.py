"""The generators' contract, at a small size on the CPU: one seed gives
the same tensors, another seed others; the client split keeps its
bounds."""
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))

from pbench import traffic  # noqa: E402
from pbench.systems.fedgia_lm import layout  # noqa: E402

SEEDS = (5, 2 ** 31 + 11)
HF = {"hidden_size": 16, "intermediate_size": 24, "num_hidden_layers": 2,
      "num_attention_heads": 2, "vocab_size": 40}


def _lsq(seed):
    return traffic.lsq_mixture(seed, 600, 8, 40, 24, "cpu")


def _lm(seed):
    return {**traffic.weights(layout(HF), seed, "cpu"),
            "tokens": traffic.token_stream(seed, 40, 3, 2, 12, "cpu")}


@pytest.mark.parametrize("make", [_lsq, _lm], ids=["lsq", "lm"])
def test_same_seed_same_tensors_other_seed_others(make):
    a, b, c = make(SEEDS[0]), make(SEEDS[0]), make(SEEDS[1])
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(not torch.equal(a[k], c[k]) for k in a
               if a[k].float().std() > 0)


@pytest.mark.parametrize("seed", SEEDS)
def test_client_split(seed):
    sizes = traffic.client_sizes(seed, 600, 40, 22)
    assert sizes.sum() == 600 and sizes.min() >= 7 and sizes.max() <= 22
    batch = _lsq(seed)
    d = batch["mask"].sum(1)
    assert int(d.sum()) == 600
    padded = batch["A"] * (1 - batch["mask"])[..., None]
    assert torch.count_nonzero(padded) == 0


def test_token_stream_plants_the_bigram():
    toks = traffic.token_stream(1, 1000, 2, 4, 200, "cpu").long()
    step = (toks[..., 1:] - toks[..., :-1]) % 1000
    for i in range(2):
        share = (step[i] == step[i].flatten().mode().values).float().mean()
        assert 0.4 < float(share) < 0.6
