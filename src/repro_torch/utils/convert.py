"""Carry parameters and state across from the JAX package.

The inputs are numpy trees: a JAX pytree after `jax.device_get`. Nothing
here imports JAX. This is how tests give both packages the same
starting point.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.selection import make_generator


def _tensor(v, device) -> torch.Tensor:
    return torch.from_numpy(np.array(v, copy=True)).to(device)


def params_from_numpy(tree, device):
    """Nested dict of ndarrays -> the same dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def state_from_numpy(state: dict, device, seed: int) -> dict:
    """A JAX `FedGiA` state as numpy -> the port's state. The JAX `rng`
    key has no torch counterpart: it is dropped and the port's selection
    generator is seeded with `seed` instead. `round` becomes an int."""
    out = {}
    for k, v in state.items():
        if k == "rng":
            continue
        out[k] = int(v) if k == "round" else params_from_numpy(v, device)
    out["rng"] = make_generator(seed)
    return out
