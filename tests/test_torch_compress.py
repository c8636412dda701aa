"""Compressed uplinks on the port (mirrors tests/test_compress.py, but
for its red wallclock-baseline test and its sharded test) and against
the JAX package.

Within the port:
  * codec units: bf16 exact on representable values, int8's error within
    its row grid and unbiased under stochastic rounding, top-k keeping
    exactly k lanes, the wire-byte model exact;
  * error feedback telescopes (float64 sums at rtol = atol = 1e-5),
    masked clients keep their residual;
  * `compression="none"` is BITWISE the uncompressed run for all five
    algorithms in both drivers and all three stores;
  * the chunked driver and the legacy loop agree bit for bit under a
    codec and a byte clock, and so do the dense, active and offload
    stores (state and, for FedGiA, history);
  * the byte clock's totals and times are the hand-computed goldens.

Against the reference, on the same inputs and keys:
  * bf16 (nearest and stochastic) decodes and int8's levels q bit for
    bit; int8's decode lo + q*scale within one float32 ulp (XLA:CPU
    fuses it into an FMA, ROADMAP queue 3 f); top-k's kept set equal,
    ties (±1 rows) and rows with fewer than k nonzeros included;
  * `compress_upload` (residual, mask, padded tail, stochastic row keys)
    the same, with the int8 residual within one ulp of the decode;
  * whole runs of the five algorithms under bf16 and top-k with error
    feedback: `cr`/`selected` equal, f at rtol 1e-5, atol 1e-6 (XLA:CPU's
    FMAs), |grad|^2 and the state at the whole-run rule of
    tests/test_torch_baselines.py, rtol 1e-4, atol 1e-5 (SCAFFOLD's
    variate divides the trajectory's ulps by k0·lr), the residual ``ef``
    = u - C(u) at atol 1e-4 times max|x̄| (it cancels the upload u, whose
    ulps it keeps). Under the stochastic int8
    codec a last-ulp difference in u can move t + U across a grid point
    and flip one q, which error feedback then carries: the test counts
    the flips (residual lanes a grid step apart) and prints them. With
    none the run is held as above; with some, f is held to the largest
    relative gap between the port's float32 run and its float64 witness
    over the same rounds (what float32 rounding alone moves it);
  * the byte clock's `bytes_up`, `bytes_down` and `sim_time` bit for bit,
    and `wallclock_bench.run_compression`'s rows: CR, sim_time and bytes
    equal for the deterministic codecs and Obj at rtol 1e-3 (the runner
    rows' rule of chip_smoke.py: at m = 128 a bf16 rounding of u can fall
    on the other side of a midpoint too); the int8 row converges on both
    sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import api as jax_api
from repro.core import compress as jax_compress
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core.clock import ComputeClock as JaxComputeClock
from repro.models import LeastSquares as JaxLeastSquares
from repro.utils import pytree as jax_pt
from repro_torch.benchmarks import wallclock_bench
from repro_torch.config import FedConfig
from repro_torch.core import api, compress, prng
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock
from repro_torch.core.compress import (
    HEADER_BYTES,
    Bf16Compressor,
    Int8Compressor,
    NoneCompressor,
    TopKCompressor,
    downlink_bytes,
    make_compressor,
    uplink_bytes,
)
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt

M, N, D = 8, 20, 400
ROUNDS = 12
CHUNK = 5
RTOL, ATOL = 1e-5, 1e-6
# a whole run's state and |grad|^2 against the reference
# (tests/test_torch_baselines.py's rule for whole runs)
RUN_RTOL, RUN_ATOL = 1e-4, 1e-5
# a runner row's Obj against the reference (chip_smoke.py's ROW_OBJ_RTOL)
ROW_OBJ_RTOL = 1e-3

ALGO_SETUPS = {
    "fedgia_diag": dict(algorithm="fedgia", sigma_t=0.2, h_policy="diag_ema",
                        alpha=0.5),
    "fedavg": dict(algorithm="fedavg", lr=0.01),
    "fedprox": dict(algorithm="fedprox", lr=0.002, prox_mu=1e-4,
                    inner_steps=3),
    "fedpd": dict(algorithm="fedpd", lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(algorithm="scaffold", lr=0.01),
}
FIVE = sorted(ALGO_SETUPS)
LOSSY = {"bf16": dict(compression="bf16"),
         "int8+ef": dict(compression="int8", error_feedback=True),
         "topk+ef": dict(compression="topk", topk_frac=0.25,
                         error_feedback=True)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _make(raw, key, state_dtype="float32"):
    model = LeastSquares(N)
    fed = FedConfig(num_clients=M, k0=3, state_dtype=state_dtype,
                    **ALGO_SETUPS[key])
    algo = make_algorithm(fed, model.loss, model=model)
    batch = to_torch(raw, "cpu")
    params = model.init("cpu")
    if state_dtype == "float64":  # the float64 witness
        batch = {k: v.double() if v.is_floating_point() else v
                 for k, v in batch.items()}
        params = {k: v.double() for k, v in params.items()}
    state = algo.init(params, prng_key(1), init_batch=batch)
    return algo, state, batch


def _reference(raw, key, rounds=ROUNDS, **kw):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(num_clients=M, k0=3, **ALGO_SETUPS[key]), jmodel.loss,
        model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    # its legacy loop: one compiled round
    return jax_run_rounds(jalgo, jstate, jb, rounds, scan=False, **kw)


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, label="", hist=True):
    assert res.rounds_run == ref.rounds_run, label
    if hist:
        assert set(res.history) == set(ref.history), label
        for k in ref.history:
            np.testing.assert_array_equal(res.history[k], ref.history[k],
                                          err_msg=f"{label}/{k}")
    assert set(res.state) == set(ref.state), label
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{label}: state[{k}]"


def _u(shape, seed, scale=1.0):
    return np.asarray(np.random.default_rng(seed).normal(size=shape) * scale,
                      np.float32)


def _keys(rows, seed=0):
    """Per-row keys of the round-key convention, for both packages: the
    port's (rows, 2) int64 keys and JAX's (rows, 2) uint32 keys."""
    base = prng.fold_in(prng_key(seed), 7)
    keys = prng.fold_in_t(prng.key_t(base)[None], torch.arange(rows))
    jkeys = jax.vmap(lambda i: jax.random.fold_in(jnp.asarray(base), i))(
        jnp.arange(rows, dtype=jnp.uint32))
    np.testing.assert_array_equal(keys.numpy(),
                                  np.asarray(jkeys).astype(np.int64))
    return keys, jkeys


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


# ---------------------------------------------------------------- codec units
def test_none_codec_is_identity():
    comp = NoneCompressor()
    assert comp.identity and not comp.stochastic
    u = torch.from_numpy(_u((3, 16), 0))
    assert comp.encode_decode(u) is u


def test_bf16_nearest_exact_on_representable_values():
    """Values with <= 8 significant mantissa bits (zeros too) come back
    bitwise; the rest within half a bf16 ulp, and bit for bit XLA's
    round-to-nearest-even cast."""
    comp = Bf16Compressor()
    exact = torch.tensor([[0.0, 1.0, -2.5, 0.375, 1024.0, 3.140625]])
    assert torch.equal(comp.encode_decode(exact), exact)
    u = _u((4, 64), 1, 37.1)
    dec = comp.encode_decode(torch.from_numpy(u)).numpy()
    assert (np.abs(dec - u) <= 2.0 ** -8 * np.abs(u) + 1e-30).all()
    want = jax_compress.Bf16Compressor().encode_decode(jnp.asarray(u))
    np.testing.assert_array_equal(_bits(dec), _bits(want))


def test_bf16_stochastic_exact_on_lattice_and_bounded():
    """Stochastic rounding leaves bf16 lattice values alone and stays
    within one bf16 ulp; its decode is the reference's bit for bit on
    the same keys."""
    comp = Bf16Compressor(rounding="stochastic")
    assert comp.stochastic
    keys, jkeys = _keys(4)
    lattice = torch.tensor([0.0, 1.0, -2.5, 1024.0]).expand(4, 4)
    assert torch.equal(comp.encode_decode(lattice, keys=keys), lattice)
    u = _u((4, 64), 2, 5.3)
    dec = comp.encode_decode(torch.from_numpy(u), keys=keys).numpy()
    assert (np.abs(dec - u) <= 2.0 ** -7 * np.abs(u) + 1e-30).all()
    want = jax_compress.Bf16Compressor(rounding="stochastic").encode_decode(
        jnp.asarray(u), keys=jkeys)
    np.testing.assert_array_equal(_bits(dec), _bits(want))


@pytest.mark.parametrize("rounding,bound", [("nearest", 0.5),
                                            ("stochastic", 1.0)])
def test_int8_error_bounded_by_row_grid(rounding, bound):
    """|u - C(u)| <= bound * scale, scale = (max - min)/255 a row; a
    constant row decodes exactly."""
    comp = Int8Compressor(rounding=rounding)
    u = _u((5, 96), 3, 11.0)
    keys = _keys(5, 1)[0] if comp.stochastic else None
    dec = comp.encode_decode(torch.from_numpy(u), keys=keys).numpy()
    scale = (u.max(-1, keepdims=True) - u.min(-1, keepdims=True)) / 255.0
    assert (np.abs(dec - u) <= bound * scale * (1 + 1e-5)).all()
    const = torch.full((2, 16), -3.75)
    keys2 = _keys(2, 2)[0] if comp.stochastic else None
    assert torch.equal(comp.encode_decode(const, keys=keys2), const)


def test_int8_stochastic_rounding_is_unbiased():
    """E[C(u)] = u: the mean decode of one row under many keys converges
    to the row."""
    comp = Int8Compressor(rounding="stochastic")
    row = _u((16,), 4)
    reps = 512
    keys = _keys(reps, 3)[0]
    dec = comp.encode_decode(torch.from_numpy(row).expand(reps, 16),
                             keys=keys).numpy()
    scale = (row.max() - row.min()) / 255.0
    assert np.abs(dec.mean(0) - row).max() < 5 * scale / np.sqrt(reps)


def test_topk_keeps_exactly_k_largest_lanes():
    comp = TopKCompressor(frac=0.25)
    u = torch.tensor([[0.0, 5.0, -3.0, 1.0, 0.5, -0.25, 8.0, 0.0]])
    assert comp.k_for(8) == 2
    dec = comp.encode_decode(u, n=8)[0]
    expect = torch.zeros(8)
    expect[1], expect[6] = 5.0, 8.0
    assert torch.equal(dec, expect)
    assert TopKCompressor(frac=1e-6).k_for(400) == 1
    assert TopKCompressor(frac=1.0).k_for(400) == 400


def test_codec_wire_byte_model_exact():
    n = 400
    assert NoneCompressor().wire_bytes(n) == HEADER_BYTES + 4 * n == 1608
    assert Bf16Compressor().wire_bytes(n) == HEADER_BYTES + 2 * n == 808
    assert Int8Compressor().wire_bytes(n) == HEADER_BYTES + 8 + n == 416
    assert TopKCompressor(0.25).wire_bytes(n) == HEADER_BYTES + 8 * 100 == 808
    assert downlink_bytes(n) == HEADER_BYTES + 4 * n
    assert uplink_bytes(None, n) == NoneCompressor().wire_bytes(n)
    assert uplink_bytes(Int8Compressor(), n) == 416


def test_round_key_is_pure_and_round_dependent():
    """`round_key` folds the round into the key without advancing it: the
    reference's `fold_in`, bit for bit."""
    rng = prng_key(9)
    k3 = compress.round_key(rng, 3)
    np.testing.assert_array_equal(k3, compress.round_key(rng, 3))
    assert not np.array_equal(k3, compress.round_key(rng, 4))
    np.testing.assert_array_equal(rng, prng_key(9))
    np.testing.assert_array_equal(k3, np.asarray(jax_compress.round_key(
        jax.random.PRNGKey(9), jnp.int32(3))))


def test_factory_validation():
    with pytest.raises(ValueError, match="identity"):
        make_compressor("none", error_feedback=True)
    with pytest.raises(KeyError, match="gzip"):
        make_compressor("gzip")
    with pytest.raises(ValueError, match="rounding"):
        make_compressor("int8", rounding="truncate")
    with pytest.raises(ValueError, match="frac"):
        make_compressor("topk", topk_frac=0.0)
    with pytest.raises(ValueError, match="lossy"):
        compress.as_compressor(None, error_feedback=True)
    inst = Int8Compressor(error_feedback=True)
    assert compress.as_compressor(inst) is inst
    assert compress.as_compressor(None) is None


# ------------------------------------------------- the codecs vs the reference
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
@pytest.mark.parametrize("scale", [1.0, 37.1, 1e-3])
def test_int8_levels_bitwise_and_decode_within_an_ulp(rounding, scale):
    """The levels q = clip(floor(t + U)) (or round(t)) are the
    reference's bit for bit (t and the noise are); the decode lo +
    q*scale within one float32 ulp of its FMA, and bitwise our own two
    roundings done in float64 then rounded."""
    comp = Int8Compressor(rounding=rounding)
    u = _u((6, 256), 8, scale)
    keys, jkeys = _keys(6, 4) if comp.stochastic else (None, None)
    q, lo, sc = comp.quantize(torch.from_numpy(u), keys)
    # the reference's q, by its own decode: q = (dec - lo) / scale
    f = jnp.asarray(u)
    jlo, jhi = jnp.min(f, -1, keepdims=True), jnp.max(f, -1, keepdims=True)
    jsc = (jhi - jlo) / 255.0
    jt = (f - jlo) / jnp.where(jsc > 0, jsc, 1.0)
    jnoise = (jax.vmap(lambda k: jax.random.uniform(k, (256,)))(jkeys)
              if comp.stochastic else None)
    jq = jnp.clip(jnp.floor(jt + jnoise) if comp.stochastic
                  else jnp.round(jt), 0.0, 255.0)
    np.testing.assert_array_equal(_bits(q), _bits(jq))
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    np.testing.assert_array_equal(_bits(sc), _bits(jsc))
    dec = comp.encode_decode(torch.from_numpy(u), keys=keys).numpy()
    want = np.asarray(jax_compress.Int8Compressor(rounding=rounding)
                      .encode_decode(f, keys=jkeys))
    ulp = np.spacing(np.abs(want).astype(np.float32))
    assert (np.abs(dec - want) <= ulp).all()


def _topk_rows():
    """Rows with ties (±1 patterns, equal magnitudes across the kept
    boundary), rows with fewer than k nonzeros, a zero row and a random
    row."""
    rows = np.zeros((6, 128), np.float32)
    rows[0, ::2] = 1.0
    rows[0, 1::2] = -1.0
    rows[1, :] = np.where(np.arange(128) % 3 == 0, -2.0, 2.0)
    rows[2, [5, 90]] = [3.0, -1.0]  # two nonzeros, k = 32
    rows[3, 10:40] = 1.5  # 30 equal, two zeros complete the k
    rows[5] = _u((128,), 9)
    return rows


@pytest.mark.parametrize("frac", [0.25, 0.5, 1e-6, 1.0])
def test_topk_kept_set_is_the_references_ties_included(frac):
    """The kept set and decode are `jax.lax.top_k`'s: equal magnitudes go
    to the lower lane; k counts the logical lanes only."""
    rows = _topk_rows()
    n = 120  # a padded tail of 8 zero lanes
    rows[:, n:] = 0.0
    comp = TopKCompressor(frac)
    k = comp.k_for(n)
    got = comp.kept(torch.from_numpy(rows), n).numpy()
    _, want = jax.lax.top_k(jnp.abs(jnp.asarray(rows)), k)
    np.testing.assert_array_equal(np.sort(got, -1), np.sort(np.asarray(want),
                                                            -1))
    dec = comp.encode_decode(torch.from_numpy(rows), n=n).numpy()
    jdec = jax_compress.TopKCompressor(frac).encode_decode(jnp.asarray(rows),
                                                            n=n)
    np.testing.assert_array_equal(_bits(dec), _bits(jdec))


# ------------------------------------------------------- upload + EF residual
def _padded_spec():
    spec = pt.ravel_spec({"w": torch.zeros(9)})
    assert spec.padded_size > spec.size  # lane-padded
    return spec


def test_compress_upload_re_zeros_padded_tail():
    """Affine int8 decodes 0 to lo + q*scale != 0; the upload hook forces
    the padded tail back to zero."""
    spec = _padded_spec()
    contrib = np.zeros((4, spec.padded_size), np.float32)
    contrib[:, :spec.size] = _u((4, spec.size), 5) + 2.0
    dec, ef = api.compress_upload(Int8Compressor(rounding="nearest"),
                                  torch.from_numpy(contrib), None, spec)
    assert ef is None
    dec = dec.numpy()
    assert (dec[:, spec.size:] == 0.0).all()
    assert np.abs(dec[:, :spec.size] - contrib[:, :spec.size]).max() < 0.1


@pytest.mark.parametrize("codec", [
    Bf16Compressor(error_feedback=True),
    Int8Compressor(error_feedback=True),
    TopKCompressor(0.25, error_feedback=True),
], ids=["bf16", "int8", "topk"])
def test_error_feedback_telescopes(codec):
    """Σ_r C(u_r) + e_R == Σ_r contrib_r: each round's codec error is
    carried, not lost."""
    spec = _padded_spec()
    r = np.random.default_rng(6)
    ef = torch.zeros((4, spec.padded_size))
    total_dec = np.zeros((4, spec.padded_size), np.float64)
    total_raw = np.zeros((4, spec.padded_size), np.float64)
    for rnd in range(6):
        c = np.zeros((4, spec.padded_size), np.float32)
        c[:, :spec.size] = r.normal(size=(4, spec.size))
        dec, ef = api.compress_upload(
            codec, torch.from_numpy(c), ef, spec,
            key=prng.key_t(compress.round_key(prng_key(11), rnd)))
        total_dec += dec.numpy().astype(np.float64)
        total_raw += c.astype(np.float64)
    np.testing.assert_allclose(total_dec + ef.numpy().astype(np.float64),
                               total_raw, rtol=1e-5, atol=1e-5)
    assert (ef.numpy()[:, spec.size:] == 0.0).all()


def test_error_feedback_freezes_masked_clients():
    spec = _padded_spec()
    ef0 = np.zeros((4, spec.padded_size), np.float32)
    ef0[:, :spec.size] = _u((4, spec.size), 7)
    c = np.zeros((4, spec.padded_size), np.float32)
    c[:, :spec.size] = _u((4, spec.size), 8)
    mask = torch.tensor([True, False, True, False])
    _, ef1 = api.compress_upload(
        TopKCompressor(0.25, error_feedback=True), torch.from_numpy(c),
        torch.from_numpy(ef0), spec, mask=mask)
    ef1 = ef1.numpy()
    np.testing.assert_array_equal(ef1[1], ef0[1])
    np.testing.assert_array_equal(ef1[3], ef0[3])
    assert not np.array_equal(ef1[0], ef0[0])


@pytest.mark.parametrize("codec", ["bf16s", "int8", "topk"])
def test_compress_upload_matches_reference(codec):
    """One upload with a residual, a mask and a padded tail, keyed as the
    rounds key it: decode and residual the reference's (bf16 and top-k
    bit for bit, int8 within an ulp of its FMA'd decode)."""
    make = {"bf16s": lambda m: m.Bf16Compressor(True, "stochastic"),
            "int8": lambda m: m.Int8Compressor(True),
            "topk": lambda m: m.TopKCompressor(0.25, True)}[codec]
    spec = _padded_spec()
    jspec = jax_pt.ravel_spec({"w": jnp.zeros((9,), jnp.float32)})
    c = np.zeros((M, spec.padded_size), np.float32)
    ef = np.zeros((M, spec.padded_size), np.float32)
    c[:, :spec.size] = _u((M, spec.size), 10, 3.0)
    ef[:, :spec.size] = _u((M, spec.size), 11, 0.1)
    mask = np.arange(M) % 3 != 1
    key = compress.round_key(prng_key(5), 4)
    dec, ef1 = api.compress_upload(
        make(compress), torch.from_numpy(c), torch.from_numpy(ef), spec,
        key=prng.key_t(key), mask=torch.from_numpy(mask))
    jdec, jef1 = jax_api.compress_upload(
        make(jax_compress), jnp.asarray(c), jnp.asarray(ef), jspec,
        key=jax_compress.round_key(jax.random.PRNGKey(5), jnp.int32(4)),
        mask=jnp.asarray(mask))
    jdec, jef1 = np.asarray(jdec), np.asarray(jef1)
    if codec == "int8":
        ulp = np.spacing(np.abs(jdec))
        assert (np.abs(dec.numpy() - jdec) <= ulp).all()
        assert (np.abs(ef1.numpy() - jef1) <= 2 * ulp).all()
    else:
        np.testing.assert_array_equal(_bits(dec), _bits(jdec))
        np.testing.assert_array_equal(_bits(ef1), _bits(jef1))


# --------------------------------------- compression="none" == plain, bitwise
@pytest.mark.parametrize("algo_key", FIVE)
@pytest.mark.parametrize("scan", [True, False], ids=["scan", "legacy"])
def test_none_bitwise_identical_dense(raw, algo_key, scan):
    """The engine resolves the identity codec (no EF) to no compressor:
    history and state bitwise the uncompressed run's."""
    algo, state, batch = _make(raw, algo_key)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK)
    res = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     compression="none")
    _assert_bitwise(res, ref, algo_key)


@pytest.mark.parametrize("algo_key", FIVE)
@pytest.mark.parametrize("store", ["active", "offload"])
def test_none_bitwise_identical_active_store(raw, algo_key, store):
    algo, state, batch = _make(raw, algo_key)
    kw = dict(participation=make_policy("uniform", M, 0.5, seed=3),
              store=store)
    ref = run_rounds(algo, state, batch, ROUNDS, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, compression="none", **kw)
    _assert_bitwise(res, ref, f"{algo_key}/{store}")


# ------------------------------------------------------- compressed runs
@pytest.mark.parametrize("kw", list(LOSSY.values()), ids=list(LOSSY))
def test_compressed_run_engages_codec(raw, kw):
    """A lossy codec changes the trajectory, stays finite, and the state
    carries the EF residual exactly when it is on."""
    algo, state, batch = _make(raw, "fedgia_diag")
    ref = run_rounds(algo, state, batch, ROUNDS)
    res = run_rounds(algo, state, batch, ROUNDS, **kw)
    assert np.isfinite(res.history["f_xbar"]).all()
    assert not np.array_equal(res.history["f_xbar"], ref.history["f_xbar"])
    assert ("ef" in res.state) == bool(kw.get("error_feedback"))


@pytest.mark.parametrize("algo_key", ["fedavg", "fedgia_diag"])
def test_compressed_legacy_matches_scan(raw, algo_key):
    algo, state, batch = _make(raw, algo_key)
    for codec in ("topk", "int8"):
        kw = dict(compression=codec, topk_frac=0.25, error_feedback=True,
                  clock=ComputeClock(M, 1.0 + (np.arange(M) % 3),
                                     bandwidth_bps=1e4),
                  max_staleness=2)
        ref = run_rounds(algo, state, batch, ROUNDS, scan=True,
                         chunk_size=CHUNK, **kw)
        res = run_rounds(algo, state, batch, ROUNDS, scan=False, **kw)
        _assert_bitwise(res, ref, f"{algo_key}/{codec}")


@pytest.mark.parametrize("algo_key", ["fedgia_diag", "scaffold"])
@pytest.mark.parametrize("store", ["active", "offload"])
def test_compressed_active_matches_dense(raw, algo_key, store):
    """Stochastic keys come from RESIDENT row ids, so the packed tile
    quantizes each client as the dense round does; the EF gather/scatter
    is the dense mask freeze row for row, and the offload loop is the
    active store's."""
    algo, state, batch = _make(raw, algo_key)
    kw = dict(participation=make_policy("uniform", M, 0.5, seed=3),
              compression="int8", error_feedback=True)
    ref = run_rounds(algo, state, batch, ROUNDS, store="dense", **kw)
    res = run_rounds(algo, state, batch, ROUNDS, store=store, **kw)
    full = algo.active_tile == "population"
    _assert_bitwise(res, ref, algo_key, hist=full)
    for k in ("selected", "cr", "local_grad_evals"):
        np.testing.assert_array_equal(res.history[k], ref.history[k])


def test_engine_compression_validation(raw):
    algo, state, batch = _make(raw, "fedavg")
    with pytest.raises(ValueError, match="identity"):
        run_rounds(algo, state, batch, 2, compression="none",
                   error_feedback=True)
    with pytest.raises(ValueError, match="lossy"):
        run_rounds(algo, state, batch, 2, error_feedback=True)
    with pytest.raises(KeyError, match="gzip"):
        run_rounds(algo, state, batch, 2, compression="gzip")


# -------------------------------------------------------- byte-accurate clock
def test_clock_bandwidth_validation():
    with pytest.raises(ValueError, match="bandwidth"):
        ComputeClock(4, bandwidth_bps=-1.0)
    with pytest.raises(ValueError, match="bandwidth"):
        ComputeClock(4).with_wire(10, 10)


def test_byte_clock_goldens(raw):
    """An equal-speed fleet: every client arrives every round, so a
    round's bytes are M times a client's wire, and rounds fire every
    compute_s + (up + down)/bandwidth simulated seconds."""
    bw, n = 1.0e4, N
    for name, kw, wire_up in [
        ("none", dict(compression="none"), HEADER_BYTES + 4 * n),
        ("bf16", dict(compression="bf16"), HEADER_BYTES + 2 * n),
        ("int8", dict(compression="int8", error_feedback=True),
         HEADER_BYTES + 8 + n),
        ("topk", dict(compression="topk", topk_frac=0.25,
                      error_feedback=True), HEADER_BYTES + 8 * 5),
    ]:
        algo, state, batch = _make(raw, "fedgia_diag")
        res = run_rounds(algo, state, batch, 6,
                         clock=ComputeClock(M, compute_s=1.0,
                                            bandwidth_bps=bw),
                         max_staleness=2, **kw)
        wire_down = HEADER_BYTES + 4 * n
        np.testing.assert_array_equal(
            res.history["bytes_up"], np.full(6, M * wire_up, np.float32),
            err_msg=name)
        np.testing.assert_array_equal(
            res.history["bytes_down"], np.full(6, M * wire_down, np.float32),
            err_msg=name)
        dur = 1.0 + (wire_up + wire_down) / bw
        np.testing.assert_allclose(res.history["sim_time"],
                                   dur * np.arange(6), rtol=1e-6,
                                   err_msg=name)


def test_byte_metrics_follow_arrivals(raw):
    """Heterogeneous speeds: a round's bytes are its arrivals times the
    wire, and the clock is the reference's bit for bit."""
    algo, state, batch = _make(raw, "fedgia_diag")
    speeds = np.where(np.arange(M) % 2 == 0, 1.0, 3.0)
    kw = dict(max_staleness=8, compression="int8", error_feedback=True)
    res = run_rounds(algo, state, batch, ROUNDS,
                     clock=ComputeClock(M, compute_s=speeds,
                                        bandwidth_bps=1.0e4), **kw)
    up, down = HEADER_BYTES + 8 + N, HEADER_BYTES + 4 * N
    np.testing.assert_array_equal(res.history["bytes_up"],
                                  res.history["selected"] * up)
    np.testing.assert_array_equal(res.history["bytes_down"],
                                  res.history["selected"] * down)
    want = _reference(raw, "fedgia_diag", clock=JaxComputeClock(
        M, compute_s=speeds, bandwidth_bps=1.0e4), **kw)
    for k in ("bytes_up", "bytes_down", "sim_time", "selected"):
        np.testing.assert_array_equal(res.history[k],
                                      np.asarray(want.history[k]), err_msg=k)


def test_no_bandwidth_means_no_byte_metrics_and_bitwise_clock(raw):
    """Without `bandwidth_bps` no byte keys appear, and the run is bitwise
    the run without a codec argument."""
    algo, state, batch = _make(raw, "fedavg")
    clk = lambda: ComputeClock(M, compute_s=1.0 + (np.arange(M) % 3))  # noqa
    ref = run_rounds(algo, state, batch, ROUNDS, clock=clk(), max_staleness=2)
    res = run_rounds(algo, state, batch, ROUNDS, clock=clk(), max_staleness=2,
                     compression="none")
    assert "bytes_up" not in ref.history and "bytes_up" not in res.history
    _assert_bitwise(res, ref)


# ------------------------------------------------ whole runs vs the reference
def _state_array(state, key):
    rows = M if key != "x" else 1
    return np.concatenate([np.asarray(v).reshape(rows, -1) for _, v in
                           sorted(state[key].items())], axis=1)


def _flips(got, want):
    """Residual lanes a grid step apart: a flipped q, which error
    feedback carries (a row's step is its residual's own range, at most
    one int8 step of its upload)."""
    e1, e2 = _state_array(got.state, "ef"), _state_array(want.state, "ef")
    step = np.maximum(np.abs(e2).max(-1, keepdims=True), 1e-30)
    return int((np.abs(e1 - e2) > 0.25 * step).sum())


def _hold(got, want, what, f_rtol=RTOL):
    assert got.rounds_run == want.rounds_run, what
    assert set(got.history) == set(want.history), what
    for k in ("selected", "cr", "screened", "degraded", "rollback"):
        if k in want.history:
            np.testing.assert_array_equal(got.history[k],
                                          np.asarray(want.history[k]),
                                          err_msg=f"{what}/{k}")
    np.testing.assert_allclose(got.history["f_xbar"], want.history["f_xbar"],
                               rtol=f_rtol, atol=ATOL, err_msg=f"{what}/f")
    if f_rtol == RTOL:
        np.testing.assert_allclose(got.history["grad_sq_norm"],
                                   want.history["grad_sq_norm"],
                                   rtol=RUN_RTOL, atol=RUN_ATOL,
                                   err_msg=f"{what}/gsq")
        # the residual u - C(u) cancels the upload u, so its ulps are
        # u's: it is held at RUN_RTOL of the uploads' size (that of x̄)
        ef_atol = RUN_RTOL * float(np.abs(_state_array(want.state,
                                                       "x")).max())
        for key, leaf in _leaves(got.state):
            k, name = key.split(".")
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(want.state[k][name]),
                rtol=RUN_RTOL, atol=ef_atol if k == "ef" else RUN_ATOL,
                err_msg=f"{what}: state[{key}]")


@pytest.mark.parametrize("codec", list(LOSSY))
@pytest.mark.parametrize("algo_key", FIVE)
def test_compressed_runs_match_reference(raw, algo_key, codec):
    kw = LOSSY[codec]
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK, **kw)
    want = _reference(raw, algo_key, **kw)
    if codec != "int8+ef":
        _hold(got, want, f"{algo_key}/{codec}")
        return
    flips = _flips(got, want)
    print(f"{algo_key}/{codec}: {flips} flipped q across {ROUNDS} rounds")
    if flips == 0:
        _hold(got, want, f"{algo_key}/{codec}")
        return
    # the float64 witness: how far float32 rounding alone moves f
    w_algo, w_state, w_batch = _make(raw, algo_key, "float64")
    wit = run_rounds(w_algo, w_state, w_batch, ROUNDS, chunk_size=CHUNK,
                     **kw)
    f32, f64 = got.history["f_xbar"], wit.history["f_xbar"]
    bound = max(RTOL, float(np.max(np.abs(f32 - f64) / np.abs(f64))))
    print(f"  float64 witness bound on f: {bound!r}")
    _hold(got, want, f"{algo_key}/{codec}", f_rtol=bound)


def test_wallclock_compression_rows_match_reference(monkeypatch):
    """`wallclock_bench.run_compression`'s rows at 60 rounds against the
    reference's: the deterministic codecs' CR, sim_time and wire bytes
    equal and Obj at ROW_OBJ_RTOL; the int8 row (stochastic, with error
    feedback) converged on both sides."""
    import benchmarks.wallclock_bench as jax_wallclock

    monkeypatch.setattr(jax_wallclock, "MAX_ROUNDS", 60)
    want = jax_wallclock.run_compression()
    got = wallclock_bench.run_compression("cpu", max_rounds=60)
    assert [r["codec"] for r in got] == [r["codec"] for r in want]
    for g, w in zip(got, want):
        if g["codec"] == "int8":
            assert g["converged"] and w["converged"], (g, w)
            assert g["obj"] <= wallclock_bench.COMPRESS_TARGET_F
            continue
        for k in ("cr", "sim_time_s", "bytes_up_total", "bytes_down_total",
                  "staleness_seen", "converged"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=ROW_OBJ_RTOL)
