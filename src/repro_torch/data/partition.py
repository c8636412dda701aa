"""Federated data partitioners: how client heterogeneity is made
(counterpart of `repro/data/partition.py`, numpy, bit for bit its
draws)."""
from __future__ import annotations

import numpy as np


def equal_partition(num_items: int, m: int):
    """`m` client sizes summing to `num_items`, the first
    `num_items % m` one larger."""
    base = num_items // m
    sizes = [base] * m
    for i in range(num_items - base * m):
        sizes[i] += 1
    return sizes


def dirichlet_partition(labels: np.ndarray, m: int, alpha: float, seed: int = 0):
    """Label-skew non-i.i.d. partition (a Dirichlet prior over the clients'
    shares of each class). Returns a list of index arrays, one a client."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    client_idx = [[] for _ in range(m)]
    for c in classes:
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        shares = rng.dirichlet(alpha * np.ones(m))
        cuts = (np.cumsum(shares)[:-1] * len(idx)).astype(int)
        for i, part in enumerate(np.split(idx, cuts)):
            client_idx[i].extend(part.tolist())
    return [np.array(sorted(ix)) for ix in client_idx]
