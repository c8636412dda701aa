"""Synthetic LM data: deterministic pseudo-token streams for the
transformer architectures (markov-ish structure, so the loss can
improve), and the embeddings of the audio and VLM input modes. A copy
of `repro/data/tokens.py` (pure numpy with the same generators, so both
packages draw the same batches bit for bit); `to_torch` moves a batch
to its device."""
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
    """A stacked federated batch (leading client axis) for any input_mode:
    {"tokens": (m, B, S+1) int32}; embeds (audio): {"embeds": (m, B, S,
    d) float32, "labels": (m, B, S) int32}; tokens+embeds (VLM): {"embeds":
    (m, B, P, d) float32 patch embeddings, "tokens": (m, B, S+1)}. The
    embeddings are standard normals from `default_rng(seed)`, drawn after
    the token stream (which has its own generator), as the reference
    draws them."""
    rng = np.random.default_rng(seed)
    tokens = synthetic_lm_batches(seed, cfg.vocab_size, m, batch_per_client,
                                  seq_len)
    if cfg.input_mode == "tokens":
        return {"tokens": tokens}
    if cfg.input_mode == "embeds":
        emb = rng.standard_normal(
            (m, batch_per_client, seq_len, cfg.d_model)).astype(np.float32)
        return {"embeds": emb, "labels": tokens[..., :seq_len]}
    # tokens+embeds (vlm): patch-embedding prefix + text tokens
    P = cfg.embed_prefix_len
    emb = rng.standard_normal((m, batch_per_client, P, cfg.d_model)).astype(
        np.float32)
    return {"embeds": emb, "tokens": tokens}
