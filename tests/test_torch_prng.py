"""The port's threefry key chains (`repro_torch.core.prng`) against
`jax.random`, the reference's stream (JAX 0.9.0, partitionable threefry,
32-bit mode).

Integers bit for bit: keys from `prng_key`, `split` and `fold_in`,
`random_bits`, `permutation` (a stable sort, which a draw with colliding
32-bit keys decides) and the `uniform` floats built from them; `erfinv`
on the same input bit for bit (XLA's polynomial with its fused
multiply-adds). Over a grid of seeds, floats within stated bounds:
`gumbel` within 2**-19 absolute (two float32 ulps at the largest Gumbel
value of a draw, |g| < 16; numpy's `log` rounds apart from XLA:CPU's, and
-log(-log(u)) cancels near 0, so no relative bound holds there) and
`normal` within 4 float32 ulps (numpy's `log1p` against XLA:CPU's), of
any shape (the flat draw reshaped); `normal_t` within 4 ulps of both.

The device forms (`threefry2x32_t`, `fold_in_t`, `split_t`,
`random_bits_t`, `uniform_t`, `randint_u32_t`, on (rows, 2) int64 key
tensors) bit for bit against the numpy forms and against `jax.random`
vmapped over the same per-row keys (`randint` as JAX 0.9.0's `_randint`
draws it, spans up to 2**31), and they read nothing back to the host.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 42, 2**31 - 1, 2**31, 2**32 - 1]
SIZES = [1, 2, 3, 128, 1000, 16384]
# seeds whose first permutation round at n = 16384 draws colliding keys
COLLIDING_SEEDS = [38, 79]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS + [2**32, 2**40 + 5, -1, -5,
                                          2**63 - 1])
def test_prng_key_is_the_references(seed):
    """32-bit mode: the seed's low 32 bits, 64-bit seeds included."""
    got = prng.prng_key(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(_jkey(seed)))


@pytest.mark.parametrize("pairs", [1, 2, prng._SCALAR_PAIRS,
                                   prng._SCALAR_PAIRS + 1, 32])
def test_threefry2x32_is_jax_hash(pairs):
    """Both forms of the hash: Python ints up to `_SCALAR_PAIRS` counter
    pairs, numpy arrays above."""
    from jax._src import prng as jax_prng

    rng = np.random.default_rng(pairs)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    count = rng.integers(0, 2**32, 2 * pairs, dtype=np.uint32)
    want = np.asarray(jax_prng.threefry_2x32(jnp.asarray(key),
                                              jnp.asarray(count)))
    a, b = prng.threefry2x32(key, count[:pairs], count[pairs:])
    assert a.dtype == b.dtype == np.uint32 and a.shape == (pairs,)
    np.testing.assert_array_equal(np.concatenate([a, b]), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("num", [2, 3, 5])
def test_split_is_the_references(seed, num):
    got = prng.split(prng.prng_key(seed), num)
    np.testing.assert_array_equal(got, np.asarray(jax.random.split(
        _jkey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("data", [0, 1, 5, 127, 2**31 + 3, 2**32 - 1])
def test_fold_in_is_the_references(seed, data):
    got = prng.fold_in(prng.prng_key(seed), data)
    np.testing.assert_array_equal(got, np.asarray(jax.random.fold_in(
        _jkey(seed), data)))


def test_key_chain_is_the_references():
    """FedGiA's chain (split, then fold_in of the round), ten rounds."""
    key, jkey = prng.prng_key(1), _jkey(1)
    for t in range(10):
        key, sel = prng.split(key)
        jkey, jsel = jax.random.split(jkey)
        np.testing.assert_array_equal(prng.fold_in(sel, t),
                                      np.asarray(jax.random.fold_in(jsel, t)))
    np.testing.assert_array_equal(key, np.asarray(jkey))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", SIZES)
def test_random_bits_are_the_references(seed, n):
    got = prng.random_bits(prng.prng_key(seed), n)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(jax.random.bits(
        _jkey(seed), (n,))))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 2, 128, 16384])
def test_permutation_is_the_references(seed, n):
    got = prng.permutation(prng.prng_key(seed), n)
    np.testing.assert_array_equal(got, np.asarray(jax.random.permutation(
        _jkey(seed), n)))
    np.testing.assert_array_equal(np.sort(got), np.arange(n))


@pytest.mark.parametrize("seed", COLLIDING_SEEDS)
def test_permutation_with_colliding_keys_is_stable(seed):
    """Equal 32-bit sort keys keep their order, as `lax.sort_key_val`'s
    stable sort keeps them: any other tie order is another permutation."""
    _, sub = prng.split(prng.prng_key(seed))
    bits = prng.random_bits(sub, 16384)
    assert len(np.unique(bits)) < 16384  # the draw collides
    got = prng.permutation(prng.prng_key(seed), 16384)
    np.testing.assert_array_equal(got, np.asarray(jax.random.permutation(
        _jkey(seed), 16384)))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-2.5, 3.0),
                                   (float(np.finfo(np.float32).tiny), 1.0)])
def test_uniform_is_the_references_bitwise(seed, n, lo, hi):
    got = prng.uniform(prng.prng_key(seed), n, lo, hi)
    want = np.asarray(jax.random.uniform(_jkey(seed), (n,), minval=lo,
                                         maxval=hi))
    assert got.dtype == np.float32
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [128, 16384])
def test_gumbel_within_bound(seed, n):
    got = prng.gumbel(prng.prng_key(seed), n)
    want = np.asarray(jax.random.gumbel(_jkey(seed), (n,)))
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -19)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n", [128, 16384])
def test_normal_within_ulps(seed, n):
    got = prng.normal(prng.prng_key(seed), n)
    want = np.asarray(jax.random.normal(_jkey(seed), (n,)))
    assert got.dtype == np.float32
    np.testing.assert_array_max_ulp(got, want, maxulp=4)


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 1, 129), (7,)])
def test_normal_of_a_shape_is_the_flat_draw_reshaped(shape):
    """An N-D draw (the initializers' `normal(key, shape)`) takes the flat
    draw's words in row-major order, as JAX's partitionable stream."""
    key = prng.prng_key(11)
    got = prng.normal(key, shape)
    assert got.shape == shape
    np.testing.assert_array_equal(got, prng.normal(key, int(np.prod(shape)))
                                  .reshape(shape))
    np.testing.assert_array_max_ulp(
        got, np.asarray(jax.random.normal(_jkey(11), shape)), maxulp=4)


@pytest.mark.parametrize("seed", [0, 7, 2**32 - 1])
@pytest.mark.parametrize("shape", [(1000,), (16, 33, 5)])
def test_normal_t_within_ulps_of_numpy(seed, shape):
    """`normal_t` (the torch form the card draws weights and probe
    directions with) against the numpy form: within 4 float32 ulps (the
    C library's log1p against PyTorch's; the integers and the uniform
    floats are the same)."""
    key = prng.prng_key(seed)
    got = prng.normal_t(prng.key_t(key), shape)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_max_ulp(got.numpy(), prng.normal(key, shape),
                                    maxulp=4)
    np.testing.assert_array_max_ulp(
        got.numpy(), np.asarray(jax.random.normal(_jkey(seed), shape)),
        maxulp=4)


def test_erfinv_is_xla_bitwise_on_the_same_input():
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    u = prng.uniform(prng.prng_key(3), 16384, lo, 1.0)
    u = np.concatenate([u, np.float32([0.0, -0.0, 0.5, -0.999, 0.9999999])])
    want = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    # the polynomial's FMAs match; only log1p may round apart, so compare
    # where both sides see the same w = -log1p(-u²)
    same_w = (np.asarray(-jnp.log1p(-jnp.asarray(u) * jnp.asarray(u)))
              == -np.log1p(-u * u))
    got = prng.erfinv(u)
    assert same_w.mean() > 0.5
    np.testing.assert_array_equal(got[same_w], want[same_w])
    assert np.isposinf(prng.erfinv(np.float32([1.0]))[0])
    assert np.isneginf(prng.erfinv(np.float32([-1.0]))[0])


def test_functions_leave_their_key_alone():
    key = prng.prng_key(9)
    copy = key.copy()
    for fn in (lambda k: prng.split(k), lambda k: prng.fold_in(k, 3),
               lambda k: prng.permutation(k, 64),
               lambda k: prng.uniform(k, 8), lambda k: prng.normal(k, 8)):
        fn(key)
        np.testing.assert_array_equal(key, copy)


# ------------------------------------------------------------ device forms
def _row_keys(seed, rows):
    """(rows, 2) keys: `prng_key(seed)` folded with each row id, as the
    codecs and the fault model key their clients; the device form, the
    numpy form and JAX's."""
    base = prng.prng_key(seed)
    keys = prng.fold_in_t(prng.key_t(base)[None], torch.arange(rows))
    host = np.stack([prng.fold_in(base, i) for i in range(rows)])
    jkeys = jax.vmap(lambda i: jax.random.fold_in(_jkey(seed), i))(
        jnp.arange(rows, dtype=jnp.uint32))
    np.testing.assert_array_equal(keys.numpy(), host.astype(np.int64))
    np.testing.assert_array_equal(host, np.asarray(jkeys))
    return keys, host, jkeys


@pytest.mark.parametrize("pairs", [1, 7, 1000])
def test_threefry2x32_t_is_the_numpy_hash(pairs):
    rng = np.random.default_rng(pairs)
    key = rng.integers(0, 2**32, 2, dtype=np.uint32)
    x0, x1 = rng.integers(0, 2**32, (2, pairs), dtype=np.uint32)
    a, b = prng.threefry2x32_t(*(torch.tensor(int(k)) for k in key),
                               torch.from_numpy(x0.astype(np.int64)),
                               torch.from_numpy(x1.astype(np.int64)))
    wa, wb = prng.threefry2x32(key, x0, x1)
    np.testing.assert_array_equal(a.numpy(), wa.astype(np.int64))
    np.testing.assert_array_equal(b.numpy(), wb.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_t_and_split_t_are_the_references(seed):
    keys, host, jkeys = _row_keys(seed, 33)
    got = prng.split_t(keys, 3).numpy()
    for i in (0, 1, 32):
        np.testing.assert_array_equal(got[i], prng.split(host[i], 3))
        np.testing.assert_array_equal(got[i], np.asarray(
            jax.random.split(jkeys[i], 3)))
    # a 0-d device counter folds as the int does (the fault draws)
    one = prng.fold_in_t(prng.key_t(host[3]), torch.tensor(2**32 + 9))
    np.testing.assert_array_equal(one.numpy(), prng.fold_in(host[3], 9))


@pytest.mark.parametrize("seed", SEEDS[:4])
@pytest.mark.parametrize("n", [1, 3, 128, 1000])
def test_random_bits_t_and_uniform_t_are_the_references(seed, n):
    keys, host, jkeys = _row_keys(seed, 5)
    bits = prng.random_bits_t(keys, n).numpy()
    uni = prng.uniform_t(keys, n).numpy()
    jbits = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (n,)))(jkeys))
    juni = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (n,)))(jkeys))
    for i in range(5):
        np.testing.assert_array_equal(bits[i], prng.random_bits(host[i], n))
        assert uni[i].tobytes() == prng.uniform(host[i], n).tobytes()
    np.testing.assert_array_equal(bits, jbits.astype(np.int64))
    assert uni.dtype == np.float32 and uni.tobytes() == juni.tobytes()
    # a scalar draw, `uniform(key, ())`, is a row's first word
    jscalar = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(jkeys))
    assert uni[:, 0].tobytes() == jscalar.tobytes()


@pytest.mark.parametrize("lo,hi", [(0, 1 << 16), (0, 255), (3, 1000),
                                   (0, 1 << 20), (7, 2**31 - 1)])
def test_randint_u32_t_is_the_references(lo, hi):
    """JAX 0.9.0's `_randint`: two bit blocks from the split key, the high
    one times (2**16 mod span)**2 mod span in uint32 arithmetic."""
    keys, _, jkeys = _row_keys(11, 6)
    got = prng.randint_u32_t(keys, 300, lo, hi).numpy()
    want = np.asarray(jax.vmap(lambda k: jax.random.randint(
        k, (300,), lo, hi, jnp.uint32))(jkeys))
    np.testing.assert_array_equal(got, want.astype(np.int64))
    assert got.min() >= lo and got.max() < hi


def test_device_forms_read_nothing_back():
    """The draws run on meta tensors, which hold no data: no step reads a
    value back to the host, so a captured chunk can run them."""
    keys = torch.zeros((4, 2), dtype=torch.int64, device="meta")
    assert prng.random_bits_t(keys, 16).shape == (4, 16)
    assert prng.uniform_t(keys, 16).dtype == torch.float32
    assert prng.randint_u32_t(keys, 16, 0, 1 << 16).shape == (4, 16)
    assert prng.fold_in_t(keys[0], torch.arange(
        3, device="meta")).shape == (3, 2)
    assert prng.key_t(prng.prng_key(1), "meta").device.type == "meta"
