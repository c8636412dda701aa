"""Threefry-2x32 key chains on the host: the reference's random stream.

The reference draws every participation mask, clock duration and (later)
fault or codec sample from `jax.random`'s threefry2x32 keys. This module
is the port's own copy of those algorithms, in numpy with exact uint32
arithmetic, so the port draws the same clients for the same seed:

* `threefry2x32`: the Threefry-2x32 block cipher with 20 rounds
  (Salmon et al., SC'11), as `jax._src.prng._threefry2x32_lowering`;
* `prng_key(seed)`: `jax.random.PRNGKey` (`threefry_seed`);
* `split`, `fold_in`, `random_bits`: the key operations;
* `permutation`: `jax.random.permutation(key, n)` (`random._shuffle`);
* `uniform`, `gumbel`, `normal`: the float32 samplers (`normal` of any
  shape, as the reference's parameter initializers draw).

Which stream. JAX has two forms of `split` and `random_bits`, chosen by
the flag `jax_threefry_partitionable`. Its default became True in JAX
0.5.0; the reference is tested with JAX 0.9.0, where it is True, so this
module follows the partitionable forms: the i-th key of a split and the
i-th word of `random_bits` both hash the 64-bit counter i, split into
(hi, lo) 32-bit halves. (JAX 0.4.37, which `requirements-dev.txt` pins,
defaulted to the other form and so draws other masks.) Seeds follow
JAX's default 32-bit mode (`jax_enable_x64` off): a Python int seed is
cast to int32 by dropping its high bits, so the key is
`(0, seed mod 2**32)` for any seed, 64-bit ones included.

Keys are (2,) uint32 numpy arrays. Every function returns new arrays and
never changes its arguments, so a key stored in a state is copied with
`key.copy()`.

Integers (keys, bits, permutations, uniform floats) are the reference's
bit for bit, and so is `erfinv` on the same input. `gumbel` and `normal`
apply `log` and `log1p`, which numpy and XLA:CPU compute with their own
approximations, a few float32 ulps apart (tests/test_torch_prng.py
states the bounds).

Device forms. The codecs draw an (m, N) block a round and the fault
model a draw a client, keyed per row, inside a round that the chunked
driver captures as a CUDA graph. `threefry2x32_t`, `fold_in_t`,
`split_t`, `random_bits_t`, `uniform_t`, `randint_u32_t` and `normal_t`
are the same
chains as plain torch functions on (..., 2) key tensors on any device:
uint32 words held in int64 lanes and masked with `& 0xFFFFFFFF` after
every add and shift (torch's uint32 has no arithmetic). They read
nothing back to the host, so a captured round can run them, and give
the numpy forms' words bit for bit (tests/test_torch_prng.py).
`normal_t` draws the initial weights and the Lipschitz probe's
directions on the card: its integers and uniform floats are the numpy
form's bit for bit, but its `log1p` is PyTorch's (on the CPU within 4
float32 ulps of the numpy form's normals, tests/test_torch_prng.py; on
the card CUDA's, measured by chip_smoke.py).
"""
from __future__ import annotations

import math

import numpy as np
import torch

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = _U32(0x1BD11BDA)


_M32 = 0xFFFFFFFF
# up to this many counter pairs (the key operations' one or two) the hash
# runs on Python ints: ~20 µs a call where numpy's per-op overhead costs
# ~0.2 ms, most of a small round's draw
_SCALAR_PAIRS = 8


def _threefry_ints(k0: int, k1: int, a: int, b: int):
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    a, b = (a + k0) & _M32, (b + k1) & _M32
    for group in range(5):
        for rot in _ROTATIONS[group % 2]:
            a = (a + b) & _M32
            b = (((b << rot) | (b >> (32 - rot))) & _M32) ^ a
        a = (a + ks[(group + 1) % 3]) & _M32
        b = (b + ks[(group + 2) % 3] + group + 1) & _M32
    return a, b


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0[i], x1[i]) under
    `key`: 20 rounds in five groups of four, a key injection after each
    group. Returns the two output words, uint32 arrays of x0's shape,
    computed in place on two fresh buffers (on Python ints for a few
    pairs)."""
    x0, x1 = np.asarray(x0, _U32), np.asarray(x1, _U32)
    if x0.size <= _SCALAR_PAIRS:
        k0, k1 = (int(k) for k in np.asarray(key, _U32))
        out = [_threefry_ints(k0, k1, int(p), int(q))
               for p, q in zip(x0.ravel(), x1.ravel())]
        return (np.array([o[0] for o in out], _U32).reshape(x0.shape),
                np.array([o[1] for o in out], _U32).reshape(x0.shape))
    k0, k1 = (_U32(k) for k in np.asarray(key, _U32))
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    a = np.add(x0, ks[0], dtype=_U32)
    b = np.add(x1, ks[1], dtype=_U32)
    tmp = np.empty_like(b)
    for group in range(5):
        for rot in _ROTATIONS[group % 2]:
            np.add(a, b, out=a)  # then b = rotl(b, rot) ^ a
            np.left_shift(b, _U32(rot), out=tmp)
            np.right_shift(b, _U32(32 - rot), out=b)
            np.bitwise_or(b, tmp, out=b)
            np.bitwise_xor(b, a, out=b)
        np.add(a, ks[(group + 1) % 3], out=a)
        np.add(b, ks[(group + 2) % 3], out=b)  # array adds wrap mod 2**32
        np.add(b, _U32(group + 1), out=b)
    return a, b


def _counters(n: int, offset: int = 0):
    """The 64-bit counters offset..offset+n-1 as (hi, lo) uint32 halves
    (`prng.iota_2x32_shape`, whose counter is an element's flat index)."""
    c = np.arange(offset, offset + n, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(_U32), c.astype(_U32)


def prng_key(seed: int) -> np.ndarray:
    """`jax.random.PRNGKey(seed)` in JAX's default 32-bit mode: the seed
    is cast to int32 (its low 32 bits kept), whose logical shift by 32 is
    0, so the key is (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], dtype=_U32)


def split(key, num: int = 2) -> np.ndarray:
    """`jax.random.split(key, num)`, partitionable form: key i is the hash
    of counter i. Returns (num, 2) uint32."""
    a, b = threefry2x32(key, *_counters(num))
    return np.stack([a, b], axis=1)


def fold_in(key, data: int) -> np.ndarray:
    """`jax.random.fold_in(key, data)`: the hash of the pair
    (0, data mod 2**32)."""
    a, b = threefry2x32(key, np.zeros((1,), _U32),
                        np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.concatenate([a, b])


def random_bits(key, n: int, offset: int = 0) -> np.ndarray:
    """`jax.random.bits(key, (n,))` (32-bit words), partitionable form:
    word i is the XOR of the two halves of the hash of the 64-bit counter
    i. With `offset`, words offset..offset+n-1 of a longer draw."""
    a, b = threefry2x32(key, *_counters(n, offset))
    return a ^ b


def permutation(key, n: int) -> np.ndarray:
    """`jax.random.permutation(key, n)`: arange(n) sorted by fresh random
    32-bit keys, ceil(3 ln n / ln(2**32 - 1)) times, each time from a key
    split off the last. The sort is stable (`lax.sort_key_val`'s default),
    which decides the order of colliding keys. Returns int64."""
    x = np.arange(n, dtype=np.int64)
    rounds = int(np.ceil(3 * np.log(max(1, n))
                         / np.log(np.iinfo(np.uint32).max)))
    pos = np.arange(n, dtype=np.uint64)
    key = np.asarray(key, _U32)
    for _ in range(rounds):
        key, sub = split(key)
        # the stable sort as one plain sort of (bits << 32 | position):
        # equal bits keep their order (~10x faster than a stable argsort)
        packed = random_bits(sub, n).astype(np.uint64) << np.uint64(32)
        packed |= pos
        packed.sort()
        x = x[(packed & np.uint64(0xFFFFFFFF)).astype(np.int64)]
    return x


def uniform(key, n: int, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """`jax.random.uniform(key, (n,), float32, minval, maxval)`: 23 random
    mantissa bits under exponent 0 give a float in [1, 2); minus 1,
    scaled and shifted, and held at or above `minval`."""
    f32 = np.float32
    bits = (random_bits(key, n) >> _U32(32 - 23)) | _U32(0x3F800000)
    floats = bits.view(f32) - f32(1.0)
    lo, hi = f32(minval), f32(maxval)
    # floats·(hi − lo) + lo rounded once, as XLA:CPU contracts it into an
    # FMA (the float64 product of two float32 values is exact)
    scaled = (floats.astype(np.float64) * np.float64(hi - lo)
              + np.float64(lo)).astype(f32)
    return np.maximum(lo, scaled)


def gumbel(key, n: int) -> np.ndarray:
    """`jax.random.gumbel(key, (n,))` (mode "low"): -log(-log(u)) with u
    uniform on [tiny, 1)."""
    u = uniform(key, n, np.finfo(np.float32).tiny, 1.0)
    return -np.log(-np.log(u))


# XLA's float32 erfinv (M. Giles, "Approximating the erfinv function"):
# a degree-8 polynomial in w - 2.5 for w = -log1p(-x²) < 5, else in
# sqrt(w) - 3; the coefficients from the highest power down.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """float32 erfinv as XLA computes it (Giles' polynomial), ±inf at ±1."""
    f32 = np.float32
    x = np.asarray(x, f32)
    with np.errstate(divide="ignore", invalid="ignore"):  # at |x| = 1
        w = -np.log1p(-x * x)
        small = w < f32(5.0)
        w = np.where(small, w - f32(2.5), np.sqrt(w) - f32(3.0))
        p = np.where(small, f32(_ERFINV_SMALL[0]), f32(_ERFINV_LARGE[0]))
        w64 = w.astype(np.float64)
        for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
            # c + p·w rounded once, as XLA:CPU contracts it into an FMA
            # (the float64 product of two float32 values is exact)
            c = np.where(small, cs, cl).astype(f32).astype(np.float64)
            p = (p * w64 + c).astype(f32)
        return np.where(np.abs(x) == f32(1.0), x * f32(np.inf), p * x)


def normal(key, shape) -> np.ndarray:
    """`jax.random.normal(key, shape)` (float32): sqrt(2)·erfinv(u) with u
    uniform on (nextafter(-1, 0), 1). `shape` is an int or a tuple: the
    words of an N-D draw are those of the flat one, in row-major order."""
    f32 = np.float32
    shape = _shape(shape)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    u = uniform(key, math.prod(shape), lo, 1.0)
    return (f32(math.sqrt(2)) * erfinv(u)).reshape(shape)


def _shape(shape):
    return (int(shape),) if np.ndim(shape) == 0 else tuple(int(s)
                                                           for s in shape)


# ----------------------------------------------------------- device forms
def _key_words(keys: torch.Tensor):
    """A (..., 2) key tensor as its two uint32 words in int64 lanes."""
    keys = keys.to(torch.int64) & _M32
    return keys[..., 0], keys[..., 1]


def threefry2x32_t(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                   x1: torch.Tensor):
    """`threefry2x32` on int64 tensors holding uint32 words: the keys'
    words `k0`, `k1` broadcast against the counters `x0`, `x1`. Returns
    the two output words (int64, in [0, 2**32))."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    a = (x0 + ks[0]) & _M32
    b = (x1 + ks[1]) & _M32
    for group in range(5):
        for rot in _ROTATIONS[group % 2]:
            a = (a + b) & _M32
            b = (((b << rot) & _M32) | (b >> (32 - rot))) ^ a
        a = (a + ks[(group + 1) % 3]) & _M32
        b = (b + ks[(group + 2) % 3] + (group + 1)) & _M32
    return a, b


def _word(value: int, device) -> torch.Tensor:
    """A 0-d int64 tensor made by a fill on `device`, not a copy from the
    host (a copy from pageable memory cannot be captured in a graph)."""
    return torch.full((), int(value) & _M32, dtype=torch.int64,
                      device=device)


def key_t(key, device=None) -> torch.Tensor:
    """A host (2,) uint32 key as a (2,) int64 tensor on `device`."""
    k = np.asarray(key, _U32)
    return torch.stack([_word(k[0], device), _word(k[1], device)])


def fold_in_t(keys: torch.Tensor, data) -> torch.Tensor:
    """`fold_in` of every key of (..., 2) `keys` with its `data` (an int
    or an int tensor broadcasting against the keys' leading shape,
    reduced mod 2**32): the hash of the pair (0, data). Returns
    (..., 2) int64."""
    k0, k1 = _key_words(keys)
    if not torch.is_tensor(data):
        data = _word(data, keys.device)
    lo = data.to(torch.int64) & _M32
    a, b = threefry2x32_t(k0, k1, torch.zeros_like(lo), lo)
    return torch.stack(torch.broadcast_tensors(a, b), dim=-1)


def split_t(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """`split` of every key of (rows, 2) `keys`: (rows, num, 2)."""
    k0, k1 = _key_words(keys)
    i = torch.arange(num, device=keys.device)
    a, b = threefry2x32_t(k0[:, None], k1[:, None], torch.zeros_like(i), i)
    return torch.stack([a, b], dim=-1)


def random_bits_t(keys: torch.Tensor, n: int,
                  offset: int = 0) -> torch.Tensor:
    """`random_bits(key, n, offset)` for every key of (rows, 2) `keys`:
    (rows, n) int64 words in [0, 2**32), the hash of the 64-bit counters
    offset..offset+n-1 split into (hi, lo) halves, as the reference's
    `iota_2x32_shape` splits them (a leaf of more than 2**32 words, such
    as Arctic's expert leaf, has counters with a high half above 0)."""
    k0, k1 = _key_words(keys)
    i = torch.arange(offset, offset + n, device=keys.device)
    a, b = threefry2x32_t(k0[:, None], k1[:, None], i >> 32, i & _M32)
    return a ^ b


def uniform_t(keys: torch.Tensor, n: int, offset: int = 0) -> torch.Tensor:
    """`uniform(key, n)` on [0, 1) for every key of (rows, 2) `keys`:
    (rows, n) float32, the 23 high bits of each word under exponent 0,
    minus 1 (the scale by 1 - 0 and shift by 0 are exact). With `offset`,
    words offset..offset+n-1 of a longer draw."""
    bits = (random_bits_t(keys, n, offset) >> (32 - 23)) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def randint_u32_t(keys: torch.Tensor, n: int, lo: int,
                  hi: int) -> torch.Tensor:
    """`jax.random.randint(key, (n,), lo, hi, jnp.uint32)` for every key
    of (rows, 2) `keys` (0 <= lo < hi < 2**31: JAX takes the bounds as int32), as JAX 0.9.0's
    `_randint` draws it: the key splits in two, each half draws a block
    of words, and the high block times (2**16 mod span)**2 mod span plus
    the low block, all mod span (in uint32 arithmetic, so the product
    wraps), is the offset from `lo`. Returns (rows, n) int64."""
    span = hi - lo
    mult = ((pow(1 << 16, 1, span) ** 2) & _M32) % span  # uint32 square
    halves = split_t(keys)
    higher = random_bits_t(halves[:, 0], n)
    lower = random_bits_t(halves[:, 1], n)
    off = (((higher % span) * mult) & _M32) + (lower % span)
    return lo + (off & _M32) % span


def _erfinv_t(x: torch.Tensor) -> torch.Tensor:
    """`erfinv` on a float32 tensor: the same polynomial, each c + p·w
    rounded once through float64 (the FMA that XLA:CPU contracts)."""
    w = -torch.log1p(-x * x)
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(small, float(np.float32(_ERFINV_SMALL[0])),
                    float(np.float32(_ERFINV_LARGE[0]))).float()
    for cs, cl in zip(_ERFINV_SMALL[1:], _ERFINV_LARGE[1:]):
        c = torch.where(small, float(np.float32(cs)), float(np.float32(cl)))
        p = (p.double() * w + c.double()).float()
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal_t(key: torch.Tensor, shape, offset: int = 0) -> torch.Tensor:
    """`normal(key, shape)` on the key's device: `key` is a (2,) int64
    key tensor (`key_t`). Returns float32 of `shape`. With `offset`, the
    words offset.. of a longer flat draw: a large leaf is drawn a tile at
    a time (`offset` the tile's first flat index), each tile bit for bit
    the same words of the whole draw."""
    f32 = np.float32
    shape = _shape(shape)
    n = math.prod(shape)
    lo = np.nextafter(f32(-1.0), f32(0.0))
    bits = (random_bits_t(key.reshape(1, 2), n, offset)[0] >> (32 - 23)) \
        | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    del bits
    # floats·(hi − lo) + lo rounded once, as `uniform`
    scaled = (floats.double() * float(f32(1.0) - lo) + float(lo)).float()
    u = torch.clamp_min(scaled, float(lo))
    return (_erfinv_t(u) * float(f32(math.sqrt(2)))).reshape(shape)
