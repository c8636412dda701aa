"""Client participation: who runs which branch each communication round.

Counterpart of `repro/core/selection.py`. The paper draws |C| = alpha*m
clients uniformly without replacement each round (§V.B). Draws follow
the reference's threefry key chains (`core/prng.py`, on the host), so
the port, on the card or the CPU, picks the reference's clients for the
same seed: the uniform policy and FedGiA's own split bit for bit, the
weighted policy up to the ulps of `log` in its Gumbel keys.

Two sources of masks:

* `round_split`: FedGiA's own ADMM/GD split. The state's key splits
  every round, and the round index folded into the second half draws
  the split when the engine passes no mask.
* A `ParticipationPolicy`, passed to `core/engine.py::run_rounds`: the
  engine draws a fresh (m,) mask on the host every round and hands it to
  every algorithm's `round_flat(mask=...)` (FedGiA's split; the
  baselines freeze masked-out clients). `init()` gives the policy's
  state and `mask(state, round_idx)` the round's mask and the next
  state; `mask` never changes its argument, so the engine can put back
  the state of any round (the eq. (35) stop). Cyclic and availability
  policies are pure functions of `round_idx`; the straggler and periodic
  traces are the reference's bit for bit (numpy draws).
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.utils import pytree as pt

MaskAndState = Tuple[torch.Tensor, Any]


def num_selected(m: int, alpha: float) -> int:
    """|C| = alpha*m, clamped to [1, m] (at least one client every round)."""
    return max(1, min(m, int(round(alpha * m))))


def selection_mask(key, m: int, alpha: float) -> torch.Tensor:
    """(m,) bool on the CPU — True = client runs the inexact-ADMM branch
    this round: the clients whose rank in `prng.permutation(key, m)` is
    below |C|. Draws nothing when every client is selected."""
    n_sel = num_selected(m, alpha)
    if n_sel == m:
        return torch.ones((m,), dtype=torch.bool)
    return torch.from_numpy(prng.permutation(key, m) < n_sel)


def round_split(key, round_idx: int, m: int, alpha: float, draw=True):
    """FedGiA's key chain for one round (reference `fedgia.py:323-328`):
    the state's key splits into the next state's key and a selection key;
    with `draw`, the selection key folded with the round index draws the
    ADMM/GD split. Returns (next key, mask or None)."""
    key, sel_key = prng.split(key)
    if not draw:
        return key, None
    return key, selection_mask(prng.fold_in(sel_key, round_idx), m, alpha)


class ParticipationPolicy:
    """Base: full participation (a mask of ones), stateless. Masks are
    (m,) bool CPU tensors."""

    name = "full"

    def __init__(self, m: int, alpha: float = 1.0):
        if m < 1:
            raise ValueError("need at least one client")
        self.m = m
        self.alpha = alpha

    @property
    def n_selected(self) -> int:
        return num_selected(self.m, self.alpha)

    @property
    def active_capacity(self) -> int:
        """Static upper bound on a round's participant count: n_selected
        for the fixed-cardinality policies (uniform, weighted, cyclic), m
        for the others."""
        return self.m

    def init(self) -> Any:
        return ()

    def mask(self, pstate, round_idx: int) -> MaskAndState:
        return torch.ones((self.m,), dtype=torch.bool), pstate

    def indices(self, pstate, round_idx: int,
                capacity: Optional[int] = None):
        """Active-set form of :meth:`mask`: the round's participants as a
        packed, padded `pytree.ActiveSet` (on the CPU) instead of a dense
        (m,) mask. Derived from the SAME mask draw, so the participant
        sequence is the same for the dense and active stores."""
        mask, pstate = self.mask(pstate, round_idx)
        cap = self.active_capacity if capacity is None else capacity
        return pt.make_active_set(mask, cap), pstate


class UniformParticipation(ParticipationPolicy):
    """Paper §V.B: alpha*m clients uniformly without replacement a round.
    The state is a threefry key (`{"key": prng_key(seed)}`) that each
    round splits, so the mask sequence is a function of `seed` alone: the
    reference's, bit for bit."""

    name = "uniform"

    def __init__(self, m: int, alpha: float, seed: int = 0):
        super().__init__(m, alpha)
        self.seed = seed

    @property
    def active_capacity(self) -> int:
        return self.n_selected

    def init(self):
        return {"key": prng.prng_key(self.seed)}

    def mask(self, pstate, round_idx):
        key, sub = prng.split(pstate["key"])
        return selection_mask(sub, self.m, self.alpha), {"key": key}


class WeightedParticipation(ParticipationPolicy):
    """Weighted sampling without replacement (Gumbel top-k): Gumbel noise
    on the log-weights, the top |C| kept. `weights` are per-client
    sampling weights (e.g. local sample counts). The state is a threefry
    key, split each round as the uniform policy's."""

    name = "weighted"

    def __init__(self, m: int, alpha: float, weights, seed: int = 0):
        super().__init__(m, alpha)
        w = torch.as_tensor(np.asarray(weights, np.float32))
        if w.shape != (m,):
            raise ValueError(f"weights must be (m,)={m}, got "
                             f"{tuple(w.shape)}")
        self.log_w = torch.log(torch.clamp_min(w, 1e-30))
        self.seed = seed

    @property
    def active_capacity(self) -> int:
        return self.n_selected

    def init(self):
        return {"key": prng.prng_key(self.seed)}

    def gumbel_keys(self, sub) -> torch.Tensor:
        """The round's Gumbel keys, log-weights plus `prng.gumbel(sub)`."""
        return self.log_w + torch.from_numpy(prng.gumbel(sub, self.m))

    def mask(self, pstate, round_idx):
        key, sub = prng.split(pstate["key"])
        n_sel = self.n_selected
        if n_sel == self.m:
            return torch.ones((self.m,), dtype=torch.bool), {"key": key}
        z = self.gumbel_keys(sub)
        # the n_sel-th largest key (the reference's top_k(z, n_sel)[0][-1]);
        # kthvalue finds it a few times faster than a top-k sort
        kth = torch.kthvalue(z, self.m - n_sel + 1).values
        return z >= kth, {"key": key}


class CyclicParticipation(ParticipationPolicy):
    """Round-robin blocks of |C| clients: round t selects clients
    [t*|C|, t*|C| + |C|) mod m, so every client runs once a
    ceil(m/|C|)-round cycle (up to the wrap-around overlap)."""

    name = "cyclic"

    @property
    def active_capacity(self) -> int:
        return self.n_selected

    def mask(self, pstate, round_idx):
        n_sel, m = self.n_selected, self.m
        start = (int(round_idx) * n_sel) % m
        mask = torch.zeros((m,), dtype=torch.bool)
        mask[start:start + n_sel] = True
        mask[:max(0, start + n_sel - m)] = True  # the wrap-around
        return mask, pstate


class AvailabilityParticipation(ParticipationPolicy):
    """Replay a (T, m) bool availability trace: round t uses row t mod T.
    A row with no client falls back to every client, so the aggregation
    never divides by zero. `alpha` is not used."""

    name = "availability"

    def __init__(self, m: int, trace):
        super().__init__(m, alpha=1.0)
        tr = torch.as_tensor(np.asarray(trace, bool))
        if tr.dim() != 2 or tr.shape[1] != m:
            raise ValueError(f"trace must be (T, m={m}), got "
                             f"{tuple(tr.shape)}")
        self.trace = tr

    @classmethod
    def from_dropout(cls, m: int, drop_prob: float, horizon: int,
                     seed: int = 0) -> "AvailabilityParticipation":
        """i.i.d. stragglers: each client unavailable with probability
        `drop_prob` each round, frozen into a trace (the reference's numpy
        draw, so the same trace)."""
        rng = np.random.default_rng(seed)
        return cls(m, rng.random((horizon, m)) >= drop_prob)

    @classmethod
    def from_periods(cls, m: int, periods, horizon: int = 256
                     ) -> "AvailabilityParticipation":
        """Deterministic heterogeneous-speed arrivals: client i takes part
        every `periods[i]` rounds, first at round 0. `horizon` must cover
        the run (the trace replays modulo its length)."""
        p = np.asarray(periods, np.int64)
        if p.shape != (m,):
            raise ValueError(f"periods must be (m={m},), got {p.shape}")
        if not (p >= 1).all():
            raise ValueError(f"periods must be >= 1, got {p}")
        t = np.arange(horizon)[:, None]
        return cls(m, (t % p[None, :]) == 0)

    def mask(self, pstate, round_idx):
        row = self.trace[int(round_idx) % self.trace.shape[0]]
        if not bool(row.any()):
            row = torch.ones_like(row)
        return row.clone(), pstate


POLICIES = ("full", "uniform", "weighted", "cyclic", "straggler", "periodic")


def make_policy(kind: str, m: int, alpha: float = 1.0, *, seed: int = 0,
                weights=None, drop_prob: float = 0.2, horizon: int = 256,
                periods=None) -> Optional[ParticipationPolicy]:
    """CLI-level factory. `kind="full"` returns None: the engine then
    passes no mask (FedGiA draws its own split, the baselines run every
    client). `weighted` defaults to equal weights, `periodic` to periods
    cycling 1..4 over the clients."""
    if kind == "full":
        return None
    if kind == "uniform":
        return UniformParticipation(m, alpha, seed=seed)
    if kind == "weighted":
        if weights is None:
            weights = np.ones((m,), np.float32)
        return WeightedParticipation(m, alpha, weights, seed=seed)
    if kind == "cyclic":
        return CyclicParticipation(m, alpha)
    if kind == "straggler":
        return AvailabilityParticipation.from_dropout(m, drop_prob, horizon,
                                                      seed=seed)
    if kind == "periodic":
        if periods is None:
            periods = 1 + (np.arange(m) % 4)
        return AvailabilityParticipation.from_periods(m, periods, horizon)
    raise KeyError(f"unknown participation policy {kind!r}: {POLICIES}")
