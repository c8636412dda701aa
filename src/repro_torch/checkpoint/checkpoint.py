"""Tree checkpoints: one npz of leaves and a json of names and metadata
(counterpart of `repro/checkpoint/checkpoint.py`).

A tree is nested dicts, lists and tuples whose leaves are tensors, numpy
arrays or Python numbers (None is an empty subtree, as in a JAX pytree);
dict keys go in sorted order. A checkpoint is written atomically (a
temporary directory inside `directory`, then a rename) and named
``ckpt_{step:08d}``. `load_checkpoint` rebuilds the structure of a
`tree_like` and gives every leaf the like's kind: a tensor comes back on
the like's device in its dtype (bf16 through its int16 bits, which npz
can store), a numpy array in its dtype, a number as its type. Shapes come
from the file, so a like may hold empty placeholders.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

_META = "meta.json"


def _leaves(tree, path=""):
    """(name, leaf) pairs in the tree's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(tree, it):
    """`tree`'s structure with its leaves taken from the iterator `it`."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], it) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, it) for v in tree)
    return next(it)


def _to_numpy(leaf):
    """A leaf as (numpy array, dtype name)."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:  # npz has no bf16: its bits
            return t.view(torch.int16).numpy(), str(leaf.dtype)
        return t.numpy(), str(leaf.dtype)
    arr = np.asarray(leaf)
    return arr, (type(leaf).__name__ if isinstance(leaf, (bool, int, float))
                 else str(arr.dtype))


def _from_numpy(arr: np.ndarray, like):
    """`arr` as a leaf of `like`'s kind."""
    if torch.is_tensor(like):
        if like.dtype == torch.bfloat16:
            t = torch.from_numpy(np.array(arr, np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))
        return t.to(device=like.device, dtype=like.dtype)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, int):
        return int(arr)
    if isinstance(like, float):
        return float(arr)
    if isinstance(like, np.ndarray) or np.isscalar(like):
        return np.asarray(arr, dtype=np.asarray(like).dtype)
    return arr


def save_checkpoint(directory: str, step: int, tree,
                    extra: Optional[Dict] = None) -> str:
    """Write `tree` as ``ckpt_{step:08d}`` under `directory`, with the
    json-serialisable `extra`. Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    names, arrays, dtypes = [], {}, []
    for i, (name, leaf) in enumerate(_leaves(tree)):
        arr, dtype = _to_numpy(leaf)
        names.append(name)
        dtypes.append(dtype)
        arrays[f"leaf_{i}"] = arr
    tmp = tempfile.mkdtemp(dir=directory)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "names": names, "dtypes": dtypes,
            "extra": extra or {}}
    with open(os.path.join(tmp, _META), "w") as f:
        json.dump(meta, f)
    final = os.path.join(directory, f"ckpt_{step:08d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(directory: str) -> Optional[int]:
    """The newest checkpoint's step under `directory` (None: none)."""
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for f in os.listdir(directory)
             if (m := re.fullmatch(r"ckpt_(\d+)", f))]
    return max(steps) if steps else None


def load_extra(directory: str, step: int) -> Dict:
    """The checkpoint's `extra` alone (the json, no npz read), so a caller
    can vet a configuration fingerprint before it reads a tree whose
    structure may not match its own."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(path, _META)) as f:
        return json.load(f)["extra"]


def load_checkpoint(directory: str, step: int,
                    tree_like) -> Tuple[Any, Dict]:
    """The tree of ``ckpt_{step:08d}`` in `tree_like`'s structure and
    leaf kinds (its values are ignored), and its `extra`."""
    path = os.path.join(directory, f"ckpt_{step:08d}")
    with open(os.path.join(path, _META)) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = [data[f"leaf_{i}"] for i in range(len(meta["names"]))]
    likes = [leaf for _, leaf in _leaves(tree_like)]
    assert len(likes) == len(arrays), (
        f"checkpoint has {len(arrays)} leaves, target structure has "
        f"{len(likes)}")
    restored = iter([_from_numpy(a, like) for a, like in zip(arrays, likes)])
    return _rebuild(tree_like, restored), meta["extra"]
