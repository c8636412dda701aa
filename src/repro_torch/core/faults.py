"""Client fault injection and server-side screening on the device
(counterpart of `repro/core/faults.py`).

A keyed `FaultModel` corrupts the decoded (rows, N) upload just before
eq. (11)'s aggregation, and `Screening` folds a per-row finite check and
an optional norm clip into the round's participation mask, so the
server aggregates only what survives.

Fault kinds (``FAULT_KINDS``):

* ``crash``: the client never uploads; its row leaves the mask and is
  zeroed, so the weighted sums never see its bits.
* ``nan`` / ``inf``: the row's payload columns become non-finite.
* ``explode``: the row is scaled by ``FaultSpec.scale`` (finite, so only
  the clip catches it).
* ``replay``: the client re-sends its previous successful upload (the
  ``fault_prev`` buffer, made by the engine like the EF residual and
  carried as a flat client buffer).

The draw is stateless: a round's base key is ``fold_in(PRNGKey(seed),
round)``, kind j's is its fold with j, and each client folds in its
GLOBAL row id, then draws one uniform float. Every step runs on the
device from the round counter (a 0-d tensor in the chunked driver), so
a captured chunk draws the faults itself, and the same clients fault in
the same rounds in both drivers, every store and across a resume. The
words are the reference's bit for bit (`prng`'s device forms).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import prng


def _f32(x) -> float:
    """A Python float holding the float32 value of `x`: a scalar operand
    that rounds no differently in float32 and float64 arithmetic, and that
    a captured graph takes without a copy from the host."""
    return float(np.float32(x))


FAULT_KINDS = ("crash", "nan", "inf", "explode", "replay")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault process: ``kind`` with per-client per-round probability
    ``rate``; ``scale`` multiplies ``explode`` rows."""

    kind: str
    rate: float
    scale: float = 1e6

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; pick from {FAULT_KINDS}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"fault rate must be in [0, 1], got {self.rate}")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """A composite per-client fault process, drawn on the device each
    round from ``(seed, round, row id)`` alone; the only state it needs
    is the replay buffer ``fault_prev``, which the engine carries."""

    num_clients: int
    specs: Tuple[FaultSpec, ...]
    seed: int = 0

    def __post_init__(self):
        kinds = [s.kind for s in self.specs]
        if len(set(kinds)) != len(kinds):
            raise ValueError(f"duplicate fault kinds in {kinds}")

    @property
    def needs_prev(self) -> bool:
        """True when the model replays: the engine then makes the (m, N)
        ``fault_prev`` buffer."""
        return any(s.kind == "replay" for s in self.specs)

    def draw(self, round_idx, row_ids: torch.Tensor) -> dict:
        """This round's fault indicators, {kind: (rows,) bool}, for the
        GLOBAL client ids `row_ids`. `round_idx` is an int or a 0-d
        integer tensor."""
        dev = row_ids.device
        seed = prng.key_t(prng.prng_key(self.seed), dev)
        if torch.is_tensor(round_idx):
            round_idx = round_idx.to(dev)
        base = prng.fold_in_t(seed, round_idx)
        hits = {}
        for j, s in enumerate(self.specs):
            keys = prng.fold_in_t(prng.fold_in_t(base, j)[None], row_ids)
            u = prng.uniform_t(keys, 1)[:, 0]
            hits[s.kind] = u < _f32(s.rate)
        return hits

    def apply(self, contrib: torch.Tensor, mask: Optional[torch.Tensor],
              prev: Optional[torch.Tensor], round_idx, row_ids: torch.Tensor,
              *, payload_cols: Optional[int] = None):
        """Corrupt the decoded (rows, N) upload just before aggregation, in
        the order replay, explode, nan, inf, crash: a crashed row leaves
        the arrival mask and is zeroed. ``payload_cols`` bounds the
        nan/inf overwrite to the model's columns, so the zero padding tail
        survives. Returns ``(corrupt, arrive, prev')``: the post-crash
        mask and the advanced replay buffer (each arriving row's HONEST
        upload; None without a replay buffer)."""
        hits = self.draw(round_idx, row_ids)
        honest = out = contrib
        if prev is not None and "replay" in hits:
            out = torch.where(hits["replay"][:, None], prev.to(out.dtype),
                              out)
        if "explode" in hits:
            scale = next(s.scale for s in self.specs if s.kind == "explode")
            out = torch.where(hits["explode"][:, None], out * _f32(scale),
                              out)
        cols = contrib.shape[-1] if payload_cols is None else payload_cols
        col_ok = torch.arange(contrib.shape[-1], device=out.device) < cols
        for kind, val in (("nan", float("nan")), ("inf", float("inf"))):
            if kind in hits:
                bad = torch.logical_and(hits[kind][:, None], col_ok[None, :])
                out = torch.where(bad, val, out)
        crash = hits.get("crash")
        if crash is None:
            arrive = (torch.ones(contrib.shape[0], dtype=torch.bool,
                                 device=out.device) if mask is None else mask)
        else:
            arrive = (~crash if mask is None
                      else torch.logical_and(mask, ~crash))
        out = torch.where(arrive[:, None], out, 0.0)
        prev_new = None
        if prev is not None:
            prev_new = torch.where(arrive[:, None], honest.to(prev.dtype),
                                   prev)
        return out, arrive, prev_new


@dataclasses.dataclass(frozen=True)
class Screening:
    """Server-side upload screening: rows with a non-finite entry leave
    the aggregation mask (and are zeroed); finite rows whose l2 norm
    exceeds ``clip_norm`` are scaled onto the clip ball."""

    clip_norm: Optional[float] = None

    def __post_init__(self):
        if self.clip_norm is not None and self.clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {self.clip_norm}")


def screen_rows(contrib: torch.Tensor, mask: Optional[torch.Tensor],
                screening: Screening):
    """Apply `Screening` to a (rows, N) buffer. Returns ``(contrib',
    smask)``, ``smask`` within ``mask`` and every row of ``contrib'``
    finite: screened-out rows are exact zeros, clipped rows scaled by
    clip/||row||. The norm sums in torch's order, not XLA's, so a clipped
    row is the reference's to a few float32 ulps; the mask is exact."""
    finite = torch.all(torch.isfinite(contrib), dim=-1)
    smask = finite if mask is None else torch.logical_and(mask, finite)
    out = torch.where(smask[:, None], contrib, 0.0)
    if screening.clip_norm is not None:
        nrm = torch.sqrt(torch.sum((out * out).to(torch.float32), dim=-1))
        c = _f32(screening.clip_norm)
        # c as a tensor numerator: a Python scalar over a tensor is its
        # reciprocal times the scalar, which rounds apart from c / nrm
        scale = torch.where(nrm > c, torch.full_like(nrm, c)
                            / torch.clamp(nrm, min=1e-30), 1.0)
        out = out * scale[:, None].to(out.dtype)
    return out, smask


def make_faults(kinds: Sequence[str], rates: Sequence[float], *,
                num_clients: int, seed: int = 0,
                scale: float = 1e6) -> Optional[FaultModel]:
    """A `FaultModel` from parallel kind/rate lists (the CLI's ``--faults
    crash,nan --fault-rate 0.1,0.01``). One rate covers every kind; no
    kind gives None (fault-free rounds)."""
    kinds = [k for k in kinds if k]
    if not kinds:
        return None
    rates = list(rates)
    if len(rates) == 1 and len(kinds) > 1:
        rates = rates * len(kinds)
    if len(rates) != len(kinds):
        raise ValueError(
            f"--fault-rate needs 1 or {len(kinds)} values, got {len(rates)}")
    specs = tuple(FaultSpec(k, float(r), scale) for k, r in zip(kinds, rates))
    return FaultModel(num_clients=num_clients, specs=specs, seed=seed)
