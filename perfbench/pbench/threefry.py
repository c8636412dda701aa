"""Threefry-2x32 key chains (Salmon et al., SC'11, as `jax.random` uses
them in its partitionable form), the yardstick's own copy.

The port draws FedGiA's ADMM/GD split and the transformer's Lipschitz
probe directions from these chains. The reference works both out again
from the seed with this module, which imports nothing of the port.
Keys are (2,) uint32 numpy arrays; the torch forms hold uint32 words in
int64 lanes."""
from __future__ import annotations

import math

import numpy as np
import torch

_U32 = np.uint32
_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# XLA's float32 erfinv (M. Giles), coefficients from the highest power
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def threefry2x32(key, x0, x1):
    """The hash of counter pairs (x0, x1) under `key`: 20 rounds in five
    groups of four, a key injection after each group. Returns uint32
    arrays (computed in uint64 lanes, masked after every add and shift)."""
    m32 = np.uint64(_M32)
    k0, k1 = (np.uint64(k) for k in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ np.uint64(_PARITY))
    a = (np.asarray(x0, np.uint64) + ks[0]) & m32
    b = (np.asarray(x1, np.uint64) + ks[1]) & m32
    for group in range(5):
        for rot in _ROT[group % 2]:
            a = (a + b) & m32
            b = (((b << np.uint64(rot)) & m32)
                 | (b >> np.uint64(32 - rot))) ^ a
        a = (a + ks[(group + 1) % 3]) & m32
        b = (b + ks[(group + 2) % 3] + np.uint64(group + 1)) & m32
    return a.astype(_U32), b.astype(_U32)


def _counters(n, offset=0):
    c = np.arange(offset, offset + n, dtype=np.uint64)
    return c >> np.uint64(32), c & np.uint64(_M32)


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` in 32-bit mode: (0, seed mod 2**32)."""
    return np.array([0, int(seed) & _M32], dtype=_U32)


def split(key, num: int = 2) -> np.ndarray:
    a, b = threefry2x32(key, *_counters(num))
    return np.stack([a, b], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    a, b = threefry2x32(key, np.zeros(1, np.uint64),
                        np.array([int(data) & _M32], np.uint64))
    return np.concatenate([a, b])


def random_bits(key, n: int) -> np.ndarray:
    a, b = threefry2x32(key, *_counters(n))
    return a ^ b


def permutation(key, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: a stable sort of arange(n) by
    fresh 32-bit words, ceil(3 ln n / ln(2**32 - 1)) times."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2.0 ** 32 - 1)))
    key = np.asarray(key, _U32)
    for _ in range(rounds):
        key, sub = split(key)
        order = np.argsort(random_bits(sub, n), kind="stable")
        x = x[order]
    return x


def fedgia_split(key, round_idx: int, m: int, alpha: float):
    """FedGiA's round key chain (paper §V.B): the key splits into the
    next key and a selection key; the selection key folded with the
    round index ranks the clients, and the first round(α·m) of the rank
    (at least 1, at most m) run the ADMM branch. Returns (next key, (m,)
    bool numpy mask)."""
    key, sel_key = split(key)
    n_sel = max(1, min(m, int(round(alpha * m))))
    if n_sel == m:
        return key, np.ones(m, bool)
    return key, permutation(fold_in(sel_key, round_idx), m) < n_sel


# ------------------------------------------------------------ torch forms
def _i32(v: int) -> int:
    """The int32 with the bits of the uint32 word `v`."""
    v &= _M32
    return v - (1 << 32) if v >= 1 << 31 else v


def _hash_i32(k0: int, k1: int, a, b):
    """`threefry2x32` on int32 tensors holding uint32 words: adds wrap as
    uint32 adds do, and each right shift is masked to a logical one."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a, b = a + _i32(ks[0]), b + _i32(ks[1])
    for group in range(5):
        for rot in _ROT[group % 2]:
            a = a + b
            b = ((b << rot) | ((b >> (32 - rot)) & ((1 << rot) - 1))) ^ a
        a = a + _i32(ks[(group + 1) % 3])
        b = b + _i32(ks[(group + 2) % 3] + group + 1)
    return a, b


def normal_t(key, shape, device) -> torch.Tensor:
    """`jax.random.normal(key, shape)` in float32 on `device`:
    sqrt(2)·erfinv(u), u uniform on (nextafter(-1, 0), 1) from the 23
    high bits of each word (the hash of the element's 64-bit index)."""
    f32 = np.float32
    n = math.prod(shape)
    k0, k1 = (int(k) for k in np.asarray(key, _U32))
    i = torch.arange(n, device=device, dtype=torch.int64)
    hi = (i >> 32).to(torch.int32)
    lo = (i & _M32).to(torch.int32)  # wraps to the word's int32 bits
    del i
    a, b = _hash_i32(k0, k1, hi, lo)
    del hi, lo
    bits = (((a ^ b) >> 9) & 0x7FFFFF) | 0x3F800000
    del a, b
    floats = bits.view(torch.float32) - 1.0
    del bits
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = torch.clamp_min(
        (floats.double() * float(f32(1.0) - lo) + float(lo)).float(),
        float(lo))
    del floats
    w = -torch.log1p(-u * u)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, float(f32(_ERFINV_SMALL[0])),
                    float(f32(_ERFINV_LARGE[0]))).float()
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, float(f32(cs)), float(f32(cl)))
        p = (p.double() * w + c.double()).float()
    out = torch.where(u.abs() == 1.0, u * math.inf, p * u)
    return (out * float(f32(math.sqrt(2)))).reshape(shape)
