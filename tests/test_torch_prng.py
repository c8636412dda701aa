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
`normal` within 4 float32 ulps (numpy's `log1p` against XLA:CPU's).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
