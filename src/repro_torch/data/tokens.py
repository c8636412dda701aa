"""Synthetic LM data: deterministic pseudo-token streams for the
transformer architectures (markov-ish structure, so the loss can
improve). A copy of `repro/data/tokens.py` (pure numpy with the same
generator, so both packages draw the same tokens bit for bit), for the
token input mode; `to_torch` moves a batch to its device."""
from __future__ import annotations

import numpy as np

from repro_torch.config import ModelConfig


def synthetic_lm_batches(
    seed: int, vocab: int, m: int, batch_per_client: int, seq_len: int
):
    """(m, B, S+1) int32 token stream with a planted bigram structure."""
    rng = np.random.default_rng(seed)
    # per-client bigram transition bias -> non-iid clients
    out = np.empty((m, batch_per_client, seq_len + 1), np.int32)
    for i in range(m):
        shift = rng.integers(1, max(vocab // 2, 2))
        toks = rng.integers(0, vocab, size=(batch_per_client, seq_len + 1))
        # half the positions follow t_{j+1} = (t_j + shift) % vocab
        follow = rng.uniform(size=(batch_per_client, seq_len)) < 0.5
        for j in range(seq_len):
            nxt = (toks[:, j] + shift) % vocab
            toks[:, j + 1] = np.where(follow[:, j], nxt, toks[:, j + 1])
        out[i] = toks
    return out


def synthetic_batch_for(
    cfg: ModelConfig, m: int, batch_per_client: int, seq_len: int,
    seed: int = 0
):
    """A stacked federated batch (leading client axis): {"tokens": (m, B,
    S+1) int32}. The embeds and VLM input modes are ROADMAP queue 1 item
    7b."""
    if cfg.input_mode != "tokens":
        raise NotImplementedError(
            f"{cfg.name}: input_mode {cfg.input_mode!r} is not ported "
            "(ROADMAP queue 1 item 7b); the port trains on tokens")
    return {"tokens": synthetic_lm_batches(seed, cfg.vocab_size, m,
                                           batch_per_client, seq_len)}
