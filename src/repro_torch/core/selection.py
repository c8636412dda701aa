"""Client selection: which clients take the inexact-ADMM branch each round.

Counterpart of `num_selected` / `selection_mask` in
`repro/core/selection.py`. The paper draws |C| = alpha*m clients uniformly
without replacement each round (§V.B). JAX's threefry stream cannot be
reproduced in torch, so the draw comes from a CPU `torch.Generator`
seeded by the run's seed: the card and the CPU pick the same clients
every round, and the mask is moved to the run's device once per round.
"""
from __future__ import annotations

import torch


def make_generator(seed: int) -> torch.Generator:
    """The selection generator of a run (CPU, so every device draws the
    same masks from the same seed)."""
    return torch.Generator().manual_seed(seed)


def copy_generator(gen: torch.Generator) -> torch.Generator:
    out = torch.Generator()
    out.set_state(gen.get_state())
    return out


def num_selected(m: int, alpha: float) -> int:
    """|C| = alpha*m, clamped to [1, m] (at least one client every round)."""
    return max(1, min(m, int(round(alpha * m))))


def selection_mask(gen: torch.Generator, m: int, alpha: float,
                   device=None) -> torch.Tensor:
    """(m,) bool — True = client runs the inexact-ADMM branch this round.
    Draws nothing from `gen` when every client is selected."""
    n_sel = num_selected(m, alpha)
    if n_sel == m:
        return torch.ones((m,), dtype=torch.bool, device=device)
    ranks = torch.randperm(m, generator=gen)
    return (ranks < n_sel).to(device)
