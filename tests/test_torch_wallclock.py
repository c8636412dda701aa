"""Wall-clock rounds and staleness-weighted aggregation on the port
(mirrors tests/test_wallclock.py; its sharded one-psum test is in
tests/test_torch_sharded_async.py).

Within the port:
  * `stale_weighting="uniform"` is BITWISE the unweighted async run, and a
    constant clock with equal speeds BITWISE the async run under full
    arrivals, for all five algorithms in both drivers;
  * integer speeds give the periodic policy's masks, a trace of constant
    rows the constant clock, and `sim_time` is the hand-computed event
    sequence;
  * weighted chunked and legacy runs agree bit for bit;
  * the engine's and the CLI's checks raise with the reference's
    messages; the overlapped rounds' clock (`with_overlap`) prices
    ``max(compute, comm)``, its durations and ticks bit for bit the
    reference's.

Against the reference: the constant and trace clocks tick on the host in
float32, so their masks and times are the reference's device ticks BIT
FOR BIT; runs under them (the trace carrying the reference's own
lognormal durations, recomputed in JAX here) hold `sim_time`,
`staleness`, `selected` and `cr` exactly and the rest at rtol 1e-5,
atol 1e-6 (XLA:CPU's fused multiply-adds, queue 3 item f). The port's
own lognormal clock draws from the reference's threefry chain
(`core/prng.py`): its durations are the reference's within 8 float32
ulps (numpy's `log1p` and `exp` against XLA:CPU's), the arrival masks
and staleness are equal on the tested seeds, and `sim_time`, a running
sum of durations, is held at rtol 1e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core import clock as jax_clock
from repro.launch import train as jax_train
from repro.models import LeastSquares as JaxLeastSquares
from repro_torch.benchmarks import wallclock_bench
from repro_torch.config import FedConfig
from repro_torch.core import api
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import (
    ComputeClock,
    LognormalClock,
    TraceClock,
    make_clock,
)
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    ParticipationPolicy,
)
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares

M, N, D, ROUNDS, CHUNK = 8, 20, 400, 12, 5
RTOL, ATOL = 1e-5, 1e-6

# tests/test_wallclock.py's set-ups
ALGO_SETUPS = {
    "fedgia": dict(algorithm="fedgia", sigma_t=0.2, h_policy="scalar",
                   alpha=1.0),
    "fedgia_diag": dict(algorithm="fedgia", sigma_t=0.2, h_policy="diag_ema",
                        alpha=1.0),
    "fedavg": dict(algorithm="fedavg", lr=0.01),
    "fedprox": dict(algorithm="fedprox", lr=0.002, prox_mu=1e-4,
                    inner_steps=3),
    "fedpd": dict(algorithm="fedpd", lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(algorithm="scaffold", lr=0.01),
}
SPEEDS = 1.0 + (np.arange(M) % 4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _make(raw, key):
    model = LeastSquares(N)
    fed = FedConfig(num_clients=M, k0=3, **ALGO_SETUPS[key])
    algo = make_algorithm(fed, model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _bounded(res):
    """last_used <= max_staleness in every round of an async run."""
    if res.stale is not None:
        assert (res.history["staleness"] <= res.stale.max_staleness).all()


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, label):
    _bounded(res)
    assert res.rounds_run == ref.rounds_run
    for k in ref.history:  # a clock run adds sim_time on top
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=f"{label}/{k}")
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{label}: state[{k}]"


# ------------------------------------------------------- bitwise identities
@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
def test_uniform_weighting_bitwise_identical(raw, algo_key, scan):
    """"uniform" passes no weights: the unweighted async run, bit for
    bit, whatever the decay."""
    algo, state, batch = _make(raw, algo_key)
    pol = AvailabilityParticipation.from_periods(M, 1 + (np.arange(M) % 3),
                                                 horizon=ROUNDS)
    kw = dict(scan=scan, chunk_size=CHUNK, participation=pol,
              async_rounds=True, max_staleness=2)
    ref = run_rounds(algo, state, batch, ROUNDS, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, stale_weighting="uniform",
                     stale_decay=3.0, **kw)
    _assert_bitwise(res, ref, algo_key)


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
def test_equal_speed_clock_bitwise_identical_to_async(raw, algo_key, scan):
    """Equal speeds: every client arrives every round, so the clock run
    is bitwise the async run under full arrivals."""
    algo, state, batch = _make(raw, algo_key)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     participation=ParticipationPolicy(M), async_rounds=True,
                     max_staleness=2)
    res = run_rounds(algo, state, batch, ROUNDS, scan=scan, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=2.5), max_staleness=2,
                     stale_weighting="uniform")
    _assert_bitwise(res, ref, algo_key)
    np.testing.assert_array_equal(res.history["sim_time"],
                                  2.5 * np.arange(ROUNDS, dtype=np.float32))


@pytest.mark.parametrize("algo_key", ["fedgia", "scaffold"])
def test_integer_speed_clock_matches_periodic_policy(raw, algo_key):
    """Constant integer speeds (a unit-speed client present) give the
    from_periods trace's masks, hence the same run."""
    algo, state, batch = _make(raw, algo_key)
    periods = np.array([1, 2, 4, 1, 2, 4, 1, 2])
    ref = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     participation=AvailabilityParticipation.from_periods(
                         M, periods, horizon=ROUNDS),
                     async_rounds=True, max_staleness=8)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=periods.astype(float)),
                     max_staleness=8)
    _assert_bitwise(res, ref, algo_key)


def test_trace_clock_constant_rows_match_constant_clock(raw):
    algo, state, batch = _make(raw, "fedavg")
    ref = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=SPEEDS), max_staleness=4)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=TraceClock(M, np.tile(SPEEDS, (5, 1))),
                     max_staleness=4)
    _assert_bitwise(res, ref, "trace")
    np.testing.assert_array_equal(res.history["sim_time"],
                                  ref.history["sim_time"])


# ------------------------------------------------------- event-driven time
def test_sim_time_and_staleness_are_event_driven(raw):
    """Speeds alternating 1 and 3: the server wakes at every fast finish
    (t = 0, 1, 2, ...), and a slow client's staleness cycles 1, 2, 3."""
    algo, state, batch = _make(raw, "fedavg")
    speeds = np.where(np.arange(M) % 2 == 0, 1.0, 3.0)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=speeds), max_staleness=8)
    np.testing.assert_array_equal(res.history["sim_time"],
                                  np.arange(ROUNDS, dtype=np.float32))
    st = res.history["staleness"]
    t = np.arange(ROUNDS)
    for i in range(M):
        p = int(speeds[i])
        np.testing.assert_array_equal(st[:, i],
                                      np.where(t == 0, 0, ((t - 1) % p) + 1),
                                      err_msg=f"client {i} (speed {p})")


def test_lognormal_clock_chunked_matches_legacy(raw):
    """The jitter generator's state rides in the clock state: the same
    durations in both drivers, bit for bit, and a function of the seed."""
    algo, state, batch = _make(raw, "fedgia")
    clk = LognormalClock(M, compute_s=1.0 + (np.arange(M) % 3), sigma=0.6,
                         seed=4)
    kw = dict(clock=clk, max_staleness=3, stale_weighting="exp",
              stale_decay=0.5)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK, **kw)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=False, **kw)
    assert set(res.history) == set(ref.history)
    _assert_bitwise(res, ref, "lognormal")
    assert (res.history["staleness"] <= 3).all()
    sim = res.history["sim_time"]
    assert (np.diff(sim) >= 0).all() and sim[0] == 0.0
    for k, v in res.clock_state.items():
        assert np.array_equal(np.asarray(v),
                              np.asarray(ref.clock_state[k])), k


def test_clock_stop_puts_back_the_clock_state(raw):
    """At an eq. (35) stop inside a chunk, the chunked driver returns the
    clock's state after the stop round, as the legacy loop does."""
    algo, state, batch = _make(raw, "fedgia")
    clk = ComputeClock(M, compute_s=SPEEDS)
    kw = dict(clock=clk, max_staleness=2, tol=1e-7)
    ref = run_rounds(algo, state, batch, 300, scan=False, **kw)
    res = run_rounds(algo, state, batch, 300, chunk_size=13, **kw)
    assert ref.stopped_early and res.stopped_early
    assert res.rounds_run == ref.rounds_run and res.rounds_run % 13
    _assert_bitwise(res, ref, "stop")
    cs = clk.init()
    for t in range(ref.rounds_run):
        cs = clk.tick(cs, t)[2]
    for k in cs:
        assert torch.equal(res.clock_state[k], cs[k]), k
        assert torch.equal(ref.clock_state[k], cs[k]), k
    assert float(res.history["sim_time"][-1]) == float(cs["now"])


# --------------------------------------------------- weighted aggregation
def test_stale_weights_schedules():
    ages = torch.tensor([0, 1, 3, 7], dtype=torch.int32)

    def mk(w, d):
        return api.StaleXbar(anchor=None, age=ages, last_used=ages,
                             max_staleness=8, weighting=w, decay=d)

    assert api.stale_weights(None) is None
    assert api.stale_weights(mk("uniform", 2.0)) is None
    np.testing.assert_allclose(api.stale_weights(mk("poly", 1.0)),
                               1.0 / (1.0 + np.array([0, 1, 3, 7])))
    np.testing.assert_allclose(api.stale_weights(mk("exp", 0.5)),
                               np.exp(-0.5 * np.array([0, 1, 3, 7])),
                               rtol=1e-6)


def test_client_mean_weights_numpy_reference(rng):
    x = torch.as_tensor(rng.normal(size=(M, 5)), dtype=torch.float32)
    w = torch.as_tensor(rng.uniform(0.1, 1.0, size=M), dtype=torch.float32)
    mask = torch.tensor([True, False] * (M // 2))
    xn, wn = x.numpy(), w.numpy()
    np.testing.assert_allclose(api.client_mean(x, weights=w),
                               (wn[:, None] * xn).sum(0) / wn.sum(),
                               rtol=1e-6)
    wm = np.where(mask.numpy(), wn, 0.0)
    np.testing.assert_allclose(api.client_mean(x, mask=mask, weights=w),
                               (wm[:, None] * xn).sum(0) / wm.sum(),
                               rtol=1e-6)


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_weighted_chunked_matches_legacy(raw, algo_key):
    """poly weights: the same weights and staleness in both drivers, bit
    for bit (the reference holds its two at rtol 1e-5)."""
    algo, state, batch = _make(raw, algo_key)
    pol = AvailabilityParticipation.from_periods(M, 1 + (np.arange(M) % 3),
                                                 horizon=ROUNDS)
    kw = dict(participation=pol, async_rounds=True, max_staleness=2,
              stale_weighting="poly", stale_decay=1.0)
    res = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK, **kw)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=False, **kw)
    assert res.rounds_run == ref.rounds_run == ROUNDS
    _assert_bitwise(res, ref, algo_key)


def test_weighted_run_differs_from_uniform(raw):
    algo, state, batch = _make(raw, "fedgia")
    clk = ComputeClock(M, compute_s=SPEEDS)
    uni = run_rounds(algo, state, batch, ROUNDS, clock=clk, max_staleness=4)
    wtd = run_rounds(algo, state, batch, ROUNDS, clock=clk, max_staleness=4,
                     stale_weighting="poly", stale_decay=2.0)
    assert not np.allclose(uni.history["f_xbar"], wtd.history["f_xbar"])


# ----------------------------------------------------------- engine guards
def test_clock_excludes_participation(raw):
    algo, state, batch = _make(raw, "fedgia")
    with pytest.raises(ValueError, match="mutually exclusive"):
        run_rounds(algo, state, batch, 2, clock=ComputeClock(M),
                   participation=ParticipationPolicy(M))


def test_clock_client_count_must_match(raw):
    algo, state, batch = _make(raw, "fedgia")
    with pytest.raises(ValueError, match="clients"):
        run_rounds(algo, state, batch, 2, clock=ComputeClock(M + 1))


def test_stale_weighting_requires_async(raw):
    algo, state, batch = _make(raw, "fedgia")
    with pytest.raises(ValueError, match="async"):
        run_rounds(algo, state, batch, 2, stale_weighting="poly")
    with pytest.raises(ValueError, match="stale_weighting"):
        run_rounds(algo, state, batch, 2, clock=ComputeClock(M),
                   stale_weighting="typo")


def test_stale_decay_must_be_positive(raw):
    algo, state, batch = _make(raw, "fedgia")
    with pytest.raises(ValueError, match="decay"):
        run_rounds(algo, state, batch, 2, clock=ComputeClock(M),
                   stale_weighting="poly", stale_decay=-1.0)
    # the decay is not read (nor checked) under uniform weighting
    run_rounds(algo, state, batch, 2, clock=ComputeClock(M),
               stale_weighting="uniform", stale_decay=-1.0)


@pytest.mark.parametrize("what", ["bandwidth_bps", "deadline_s", "with_wire"])
def test_unported_clock_options_raise(what):
    """The byte-accurate and deadline clocks are ported
    (tests/test_torch_compress.py, tests/test_torch_faults.py): each
    raises where the reference's does, with its message."""
    if what == "with_wire":
        with pytest.raises(ValueError, match="with_wire needs bandwidth_bps"):
            ComputeClock(M).with_wire(100, 100)
    else:
        with pytest.raises(ValueError, match=f"{what} must be > 0"):
            make_clock("lognormal", M, **{what: -1.0})
        make_clock("lognormal", M, **{what: 1.0})  # ported: it builds


def test_clock_validation():
    with pytest.raises(ValueError, match="> 0"):
        ComputeClock(M, compute_s=0.0)
    with pytest.raises(ValueError, match="sigma"):
        LognormalClock(M, sigma=-1.0)
    with pytest.raises(ValueError, match="trace"):
        TraceClock(M, np.ones((3, M + 1)))
    with pytest.raises(ValueError, match="compute_s"):
        ComputeClock(M, compute_s=np.ones(M + 1))
    assert make_clock("none", M) is None
    np.testing.assert_array_equal(make_clock("constant", M).durations_s,
                                  SPEEDS.astype(np.float32))


# -------------------------------------------------- against the reference
def _reference(raw, algo_key, **kw):
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(num_clients=M, k0=3, **ALGO_SETUPS[algo_key]),
        jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    # its legacy loop: one compiled round (its chunked driver agrees with
    # it at rtol 1e-5)
    return jax_run_rounds(jalgo, jstate, jb, ROUNDS, scan=False, **kw)


def assert_matches_reference(got, want, what):
    """Counts, staleness and simulated time exact; the rest rtol 1e-5."""
    _bounded(got)
    assert got.rounds_run == want.rounds_run, what
    assert set(got.history) == set(want.history), what
    for k in ("staleness", "staleness_max", "selected", "cr", "sim_time"):
        if k in want.history:
            np.testing.assert_array_equal(got.history[k], want.history[k],
                                          err_msg=f"{what}/{k}")
    for k in ("f_xbar", "grad_sq_norm"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}/{k}")
    for key, leaf in _leaves(got.state):
        k = key.split(".")[0]
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(want.state[k]["x"]),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what}: state[{key}]")


def _lognormal_trace(speeds, sigma, seed, rounds):
    """The reference LognormalClock's durations of rounds 0..rounds-1, as
    its ticks draw them (threefry), stacked into a (rounds, m) table."""
    clk = jax_clock.LognormalClock(M, compute_s=speeds, sigma=sigma,
                                   seed=seed)
    cs, rows = clk.init(), []
    for t in range(rounds):
        d, cs = clk._draw(cs, t)
        rows.append(np.asarray(d))
    return np.stack(rows)


def test_ticks_are_the_reference_ticks_bitwise():
    """The host's float32 ticks of the constant and trace clocks are the
    reference's device ticks bit for bit, mask and time, tick by tick."""
    trace = _lognormal_trace(SPEEDS, 0.6, 4, 7)
    pairs = [(ComputeClock(M, compute_s=SPEEDS, comm_s=0.25),
              jax_clock.ComputeClock(M, compute_s=SPEEDS, comm_s=0.25)),
             (TraceClock(M, trace), jax_clock.TraceClock(M, trace))]
    for ours, theirs in pairs:
        cs, jcs = ours.init(), theirs.init()
        for t in range(30):
            mask, now, cs2 = ours.tick(cs, t)
            jmask, jnow, jcs = theirs.tick(jcs, jnp.int32(t))
            assert cs["now"] is not cs2["now"]  # tick keeps its argument
            cs = cs2
            np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
            assert now.numpy().tobytes() == np.asarray(jnow).tobytes()
            np.testing.assert_array_equal(cs["busy_until"].numpy(),
                                          np.asarray(jcs["busy_until"]))


@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_constant_clock_reference_parity(raw, algo_key):
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=SPEEDS), max_staleness=3)
    want = _reference(raw, algo_key,
                      clock=jax_clock.ComputeClock(M, compute_s=SPEEDS),
                      max_staleness=3)
    assert_matches_reference(got, want, algo_key)


@pytest.mark.parametrize("algo_key", ["fedgia_diag", "scaffold"])
@pytest.mark.parametrize("weighting", ["poly", "exp"])
def test_weighted_reference_parity(raw, algo_key, weighting):
    algo, state, batch = _make(raw, algo_key)
    kw = dict(max_staleness=3, stale_weighting=weighting, stale_decay=0.7)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=ComputeClock(M, compute_s=SPEEDS), **kw)
    want = _reference(raw, algo_key,
                      clock=jax_clock.ComputeClock(M, compute_s=SPEEDS), **kw)
    assert_matches_reference(got, want, f"{algo_key}/{weighting}")


@pytest.mark.parametrize("seed", [0, 4, 11])
def test_lognormal_ticks_match_reference(seed):
    """The port's lognormal clock, tick by tick, against the reference's:
    the key word for word, the durations within 8 ulps, the arrival masks
    equal and the simulated time at rtol 1e-6."""
    ours = LognormalClock(M, compute_s=SPEEDS, sigma=0.6, seed=seed)
    theirs = jax_clock.LognormalClock(M, compute_s=SPEEDS, sigma=0.6,
                                      seed=seed)
    cs, jcs = ours.init(), theirs.init()
    for t in range(30):
        d, _ = ours._draw(cs, t)
        jd, _ = theirs._draw(jcs, jnp.int32(t))
        np.testing.assert_array_max_ulp(d.numpy(), np.asarray(jd), maxulp=8)
        mask, now, cs = ours.tick(cs, t)
        jmask, jnow, jcs = theirs.tick(jcs, jnp.int32(t))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
        np.testing.assert_allclose(float(now), float(jnow), rtol=1e-6)
        np.testing.assert_array_equal(cs["key"], np.asarray(jcs["key"]))


@pytest.mark.parametrize("algo_key", ["fedgia", "fedavg"])
def test_lognormal_clock_run_matches_reference(raw, algo_key):
    """Each package's own lognormal clock (no trace injected): the same
    arrivals, so staleness, selected and cr exactly, sim_time at rtol
    1e-6 and the rest at the per-round tolerances."""
    speeds = 1.0 + (np.arange(M) % 3)
    kw = dict(max_staleness=3, stale_weighting="exp", stale_decay=0.5)
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=LognormalClock(M, compute_s=speeds, sigma=0.6,
                                          seed=4), **kw)
    want = _reference(raw, algo_key, clock=jax_clock.LognormalClock(
        M, compute_s=speeds, sigma=0.6, seed=4), **kw)
    np.testing.assert_allclose(got.history["sim_time"],
                               want.history["sim_time"], rtol=1e-6)
    got.history["sim_time"] = want.history["sim_time"]
    assert_matches_reference(got, want, algo_key)


@pytest.mark.parametrize("algo_key", ["fedgia", "fedavg"])
def test_lognormal_durations_through_trace_clock(raw, algo_key):
    """The reference's lognormal run against the port's trace clock
    carrying the same durations: the same masks and times, bit for bit."""
    speeds = 1.0 + (np.arange(M) % 3)
    kw = dict(max_staleness=3, stale_weighting="exp", stale_decay=0.5)
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, chunk_size=CHUNK,
                     clock=TraceClock(M, _lognormal_trace(speeds, 0.6, 4,
                                                          ROUNDS)), **kw)
    want = _reference(raw, algo_key, clock=jax_clock.LognormalClock(
        M, compute_s=speeds, sigma=0.6, seed=4), **kw)
    assert_matches_reference(got, want, algo_key)


# ------------------------------------------------------------------ the CLI
BASE = ["--clients", "8", "--dim", "20", "--samples", "400", "--rounds",
        "12", "--tol", "0", "--k0", "3", "--device", "cpu"]


@pytest.mark.parametrize("argv,match", [
    (["--max-staleness", "2"], "--max-staleness requires --async"),
    (["--stale-weighting", "poly"], "--stale-weighting requires --async"),
    (["--async"], "--async needs an arrival process"),
    (["--clock", "constant", "--participation", "uniform"],
     "cannot be combined with --participation"),
    (["--clock", "trace"], "library-level"),
    (["--clock", "constant", "--stale-weighting", "exp", "--stale-decay",
      "0"], "--stale-decay must be > 0"),
    (["--client-speeds", "1,2,3,4,1,2,3,4"], "--client-speeds requires"),
    (["--clock", "constant", "--client-speeds", "1,2"], "needs 8 values"),
    (["--store", "active"], "or --clock"),
])
def test_cli_rejects(argv, match):
    with pytest.raises(SystemExit, match=match):
        train_mod.main(BASE + argv)


@pytest.mark.parametrize("extra", [
    ["--async", "--participation", "periodic", "--max-staleness", "2"],
    ["--clock", "constant", "--max-staleness", "3", "--stale-weighting",
     "poly", "--algo", "scaffold"],
], ids=["async", "clock"])
def test_cli_runs_match_reference(extra):
    """The CLI's async and clocked runs against the reference CLI's: the
    same rounds, staleness and simulated time, f at rtol 1e-5."""
    got = train_mod.main(BASE + extra)
    want = jax_train.train(jax_train.build_parser().parse_args(
        [a for a in BASE + extra if a not in ("--device", "cpu")]))
    assert got["rounds"] == want["rounds"]
    assert got["staleness_max_seen"] == want["staleness_max_seen"]
    assert got.get("sim_time_s") == want.get("sim_time_s")
    np.testing.assert_allclose([h["f"] for h in got["history"]],
                               [h["f"] for h in want["history"]], rtol=RTOL)


def test_wallclock_bench_rows_match_reference(monkeypatch):
    """`wallclock_bench.run` on the CPU against the reference's, on a cut
    sweep (FedGiA_D, spreads 1 and 4, 60 rounds): the same rows, CR,
    sim_time and staleness equal, Obj at rel 1e-3."""
    from benchmarks import wallclock_bench as jax_wallclock_bench

    for mod in (wallclock_bench, jax_wallclock_bench):
        monkeypatch.setattr(mod, "SPREADS", [1.0, 4.0])
        monkeypatch.setattr(mod, "WEIGHTINGS", ["uniform"])
        monkeypatch.setattr(mod, "ALGOS", {"fedgia_d": mod.ALGOS["fedgia_d"]})
    monkeypatch.setattr(jax_wallclock_bench, "MAX_ROUNDS", 60)
    got = wallclock_bench.run("cpu", max_rounds=60)
    want = jax_wallclock_bench.run()
    wallclock_bench.check(got, max_rounds=60)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for k in ("algo", "spread", "weighting", "cr", "sim_time_s",
                  "staleness_seen", "converged"):
            assert g[k] == w[k], (k, g, w)
        np.testing.assert_allclose(g["obj"], w["obj"], rtol=1e-3)


@pytest.mark.parametrize("kind,kw", [
    ("constant", dict(comm_s=0.75)),
    ("constant", dict(comm_s=0.5, bandwidth_bps=4096.0)),
    ("lognormal", dict(comm_s=1.5, sigma=0.5, seed=3)),
])
def test_with_overlap_matches_reference_clock(kind, kw):
    """The overlapped rounds' clock (`with_overlap`, after `with_wire`
    where the clock has a bandwidth, as the engine installs them): every
    work item pays max(compute, comm). The constant clock's durations and
    eight ticks (masks and sim_time) are the reference's bit for bit; the
    lognormal one's within its usual 8 ulps (its jitter draws). The
    caller's clock is left as it was."""
    speeds = (1.0 + (np.arange(M) % 4)).astype(np.float32)
    port = make_clock(kind, M, compute_s=speeds, **kw)
    ref = jax_clock.make_clock(kind, M, compute_s=speeds, **kw)
    if "bandwidth_bps" in kw:
        port, ref = port.with_wire(400, 800), ref.with_wire(400, 800)
    before = port.durations_s.clone()
    port_o, ref_o = port.with_overlap(), ref.with_overlap()
    np.testing.assert_array_equal(port.durations_s.numpy(), before.numpy())
    exact = kind == "constant"
    if exact:
        np.testing.assert_array_equal(port_o.durations_s.numpy(),
                                      np.asarray(ref_o.durations_s))
        assert not np.array_equal(port_o.durations_s.numpy(),
                                  before.numpy())
    ps, rs = port_o.init(), ref_o.init()
    for t in range(8):
        pm, pnow, ps = port_o.tick(ps, t)
        rm, rnow, rs = ref_o.tick(rs, jnp.int32(t))
        np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))
        if exact:
            assert float(pnow) == float(rnow)
        else:
            np.testing.assert_allclose(float(pnow), float(rnow), rtol=1e-6)
