"""Carry parameters and state across from the JAX package.

The inputs are numpy trees: a JAX pytree after `jax.device_get`. Nothing
here imports JAX. This is how tests give both packages the same
starting point.
"""
from __future__ import annotations

import numpy as np
import torch


def _tensor(v, device) -> torch.Tensor:
    """One array as a tensor, bit for bit. numpy has no bfloat16 of its
    own: a JAX bf16 array comes as an `ml_dtypes.bfloat16` array, which
    `torch.from_numpy` refuses, so its bits go across as int16."""
    a = np.asarray(v)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device):
    """Nested dict of ndarrays -> the same dict of tensors on `device`."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def training_tree_from_numpy(tree, device) -> dict:
    """A JAX `Transformer.init` pytree as numpy -> the port's training tree
    (`models.transformer.init_params`): one tensor a leaf, bit for bit,
    keyed by its path joined with "/", each group's layers stacked on
    axis 0 as in the reference. Every leaf keeps its dtype: the bf16
    weights, and the MoE router's float32 (whose leaf makes the flat
    buffer float32, `utils.pytree.ravel_spec`)."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            out["/".join(path)] = _tensor(node, device)

    walk(tree, ())
    return out


def state_from_numpy(state: dict, device) -> dict:
    """A JAX `FedGiA` state as numpy -> the port's state. The threefry
    key `rng` goes across as its (2,) uint32 words (the port draws from
    the same key chain, `core/prng.py`); `round` becomes an int."""
    out = {}
    for k, v in state.items():
        if k == "rng":
            out[k] = np.array(v, np.uint32)
        else:
            out[k] = int(v) if k == "round" else params_from_numpy(v, device)
    return out
