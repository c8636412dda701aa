"""Synthetic datasets reproducing the paper's experiments.

Example V.1 (linear regression, non-i.i.d.): d samples drawn from a MIXTURE
of three distributions — standard normal, Student's t (df=5), uniform on
[-5, 5] — shuffled and split into m parts with heterogeneous sizes
d_i ~ uniform{0.5 d/m .. 1.5 d/m} (here: random split, padded + masked so
the stacked client axis is rectangular).

Examples V.2/V.3 (logistic regression): the paper uses the qot/sct real
datasets; offline we generate a synthetic classification set of matching
dimensions (n features, d samples) with a planted separator — documented
substitution, see EXPERIMENTS.md.

A copy of `repro/data/synthetic.py` (pure numpy, so both packages draw
bitwise-equal arrays from one seed), plus `to_torch` for the boundary.
"""
from __future__ import annotations

import numpy as np
import torch


def _mixture_features(rng: np.random.Generator, d: int, n: int) -> np.ndarray:
    thirds = [d // 3, d // 3, d - 2 * (d // 3)]
    parts = [
        rng.standard_normal((thirds[0], n)),
        rng.standard_t(df=5, size=(thirds[1], n)),
        rng.uniform(-5.0, 5.0, size=(thirds[2], n)),
    ]
    A = np.concatenate(parts, axis=0)
    rng.shuffle(A, axis=0)
    return A.astype(np.float32)


def linreg_noniid(seed: int, d: int, n: int, m: int):
    """Paper Example V.1. Returns stacked client batches
    {"A": (m, dmax, n), "b": (m, dmax), "mask": (m, dmax)}."""
    rng = np.random.default_rng(seed)
    A = _mixture_features(rng, d, n)
    x_star = rng.standard_normal(n).astype(np.float32)
    b = A @ x_star + 0.1 * rng.standard_normal(d).astype(np.float32)
    sizes = _heterogeneous_sizes(rng, d, m)
    return make_client_batches({"A": A, "b": b}, sizes)


def logreg_data(seed: int, d: int, n: int, m: int):
    """Synthetic stand-in for qot/sct: planted-separator classification."""
    rng = np.random.default_rng(seed)
    A = _mixture_features(rng, d, n)
    w = rng.standard_normal(n).astype(np.float32) / np.sqrt(n)
    p = 1.0 / (1.0 + np.exp(-(A @ w + 0.3 * rng.standard_normal(d))))
    b = (rng.uniform(size=d) < p).astype(np.float32)
    sizes = _heterogeneous_sizes(rng, d, m)
    return make_client_batches({"A": A, "b": b}, sizes)


def _heterogeneous_sizes(rng, d: int, m: int):
    """d_i ~ uniform{floor(0.5 d/m) .. ceil(1.5 d/m)}, summing to d."""
    base = d / m
    lo, hi = max(1, int(0.5 * base)), max(2, int(1.5 * base))
    sizes = rng.integers(lo, hi + 1, size=m)
    # rescale to sum d while keeping every d_i within [lo, hi]
    while sizes.sum() > d:
        cand = np.flatnonzero(sizes > lo)
        sizes[rng.choice(cand if len(cand) else np.arange(m))] -= 1
    while sizes.sum() < d:
        cand = np.flatnonzero(sizes < hi)
        sizes[rng.choice(cand if len(cand) else np.arange(m))] += 1
    sizes = np.maximum(sizes, 1)
    return sizes.tolist()


def make_client_batches(data: dict, sizes):
    """Split row-wise into len(sizes) clients, pad to max size, add mask."""
    m = len(sizes)
    dmax = max(sizes)
    out = {k: [] for k in data}
    masks = []
    start = 0
    for s in sizes:
        for k, v in data.items():
            chunk = v[start : start + s]
            pad = [(0, dmax - s)] + [(0, 0)] * (chunk.ndim - 1)
            out[k].append(np.pad(chunk, pad))
        mask = np.zeros(dmax, np.float32)
        mask[:s] = 1.0
        masks.append(mask)
        start += s
    batch = {k: np.stack(v) for k, v in out.items()}
    batch["mask"] = np.stack(masks)
    return batch


def to_torch(batch: dict, device) -> dict:
    """numpy client batches -> tensors on `device` (the one boundary
    where the generated data leaves numpy)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
