"""Flat-buffer layout for a dict of tensors (counterpart of the
`RavelSpec` family in `repro/utils/pytree.py`).

A model's parameter dict is raveled ONCE per `run_rounds` call into a
single lane-padded (N,) vector (client state: one (m, N) buffer), every
round's elementwise math runs on that contiguous buffer, and the dict is
rebuilt only at the gradient/metric/return boundaries. Leaves are laid
out in sorted-key order, which is the order in which JAX flattens a
dict, so both packages produce the same buffer from the same
parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

LANES = 128  # the flat buffer is padded to a multiple of this, with a zero
# tail, so the round kernel never re-pads on the hot path


@dataclasses.dataclass(frozen=True)
class RavelSpec:
    """Flatten layout of a dict of tensors: per-key shapes, dtypes and
    offsets into one 1-D buffer of ``size`` elements, lane-padded to
    ``padded_size`` with zeros. The buffer dtype is the promotion of the
    leaf dtypes, so an unravel->ravel round trip is exact."""

    keys: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    dtypes: Tuple[torch.dtype, ...]
    offsets: Tuple[int, ...]
    size: int
    padded_size: int
    dtype: torch.dtype

    def _pad(self, flat: torch.Tensor) -> torch.Tensor:
        pad = self.padded_size - self.size
        return F.pad(flat, (0, pad)) if pad else flat

    def ravel(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Dict -> contiguous (padded_size,) vector (zero-padded tail)."""
        flat = torch.cat([tree[k].to(self.dtype).reshape(-1) for k in self.keys])
        return self._pad(flat)

    def ravel_stacked(self, tree: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Client-stacked dict (leading axis m on every leaf) -> one
        contiguous (m, padded_size) buffer."""
        m = tree[self.keys[0]].shape[0]
        flat = torch.cat(
            [tree[k].to(self.dtype).reshape(m, -1) for k in self.keys], dim=1)
        return self._pad(flat)

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(..., padded_size) buffer -> dict (inverse of :meth:`ravel`).
        The leaves are views of `flat` where no cast is needed."""
        return {
            k: flat[..., o:o + math.prod(s)].reshape(flat.shape[:-1] + s).to(d)
            for k, o, s, d in zip(self.keys, self.offsets, self.shapes,
                                  self.dtypes)
        }

    def unravel_stacked(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(m, padded_size) buffer -> client-stacked dict."""
        return self.unravel(flat)


def ravel_spec(tree: Dict[str, torch.Tensor]) -> RavelSpec:
    """The :class:`RavelSpec` of `tree`'s layout (keys in sorted order)."""
    keys = tuple(sorted(tree))
    shapes = tuple(tuple(tree[k].shape) for k in keys)
    dtypes = tuple(tree[k].dtype for k in keys)
    offsets, off = [], 0
    for s in shapes:
        offsets.append(off)
        off += math.prod(s)
    dtype = dtypes[0] if dtypes else torch.float32
    for d in dtypes[1:]:
        dtype = torch.promote_types(dtype, d)
    return RavelSpec(keys=keys, shapes=shapes, dtypes=dtypes,
                     offsets=tuple(offsets), size=off,
                     padded_size=-(-off // LANES) * LANES, dtype=dtype)
