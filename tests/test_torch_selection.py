"""The port's participation policies (`repro_torch.core.selection`) against
the reference's `repro.core.selection` (mirrors tests/test_selection.py).

Every policy is held to the reference's masks: cyclic (a function of
the round index), straggler (the reference's numpy trace) and periodic
bit for bit, and the sampled ones through the port's threefry key chains
(`core/prng.py`): uniform bit for bit, weighted mask for mask on the
tested seeds, its Gumbel keys within 2**-19 of the reference's (two
float32 ulps at the largest key of a draw, |z| < 16: numpy's `log` and
XLA:CPU's round apart). The reference's frequency statistics
(tests/test_selection.py) hold as well.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import selection as jax_selection
from repro_torch.core import prng, selection
from repro_torch.core.selection import (
    AvailabilityParticipation,
    CyclicParticipation,
    ParticipationPolicy,
    UniformParticipation,
    WeightedParticipation,
    make_policy,
    num_selected,
)


def _roll(policy, rounds):
    """`rounds` masks drawn the way the engine draws them."""
    ps = policy.init()
    masks = []
    for r in range(rounds):
        mask, ps = policy.mask(ps, r)
        assert mask.dtype == torch.bool and mask.shape == (policy.m,)
        masks.append(mask.numpy())
    return np.stack(masks)


def _jax_roll(policy, rounds):
    ps = policy.init()
    masks = []
    for r in range(rounds):
        mask, ps = policy.mask(ps, jnp.int32(r))
        masks.append(np.asarray(mask))
    return np.stack(masks)


@pytest.mark.parametrize("m,alpha", [(8, 0.0), (8, 1.0), (8, 2.0), (1, 0.0),
                                     (128, 0.1), (10, 0.25), (7, 0.4)])
def test_num_selected_is_the_references(m, alpha):
    assert num_selected(m, alpha) == jax_selection.num_selected(m, alpha)


def test_base_policy_is_full_participation():
    pol = ParticipationPolicy(6)
    np.testing.assert_array_equal(_roll(pol, 3), np.ones((3, 6), bool))
    assert pol.n_selected == 6 and pol.active_capacity == 6


@pytest.mark.parametrize("m,alpha", [(8, 0.25), (6, 4 / 6), (7, 0.4),
                                     (128, 0.1)])
def test_cyclic_is_the_references_bitwise(m, alpha):
    got = _roll(CyclicParticipation(m, alpha), 2 * m + 3)
    want = _jax_roll(jax_selection.CyclicParticipation(m, alpha), 2 * m + 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got.sum(axis=1), num_selected(m, alpha))


def test_cyclic_blocks_and_coverage():
    masks = _roll(CyclicParticipation(8, 0.25), 8)  # |C| = 2, 4-round cycle
    np.testing.assert_array_equal(np.nonzero(masks[0])[0], [0, 1])
    np.testing.assert_array_equal(np.nonzero(masks[1])[0], [2, 3])
    np.testing.assert_array_equal(masks[:4].sum(axis=0), np.ones(8))
    np.testing.assert_array_equal(masks[4:].sum(axis=0), np.ones(8))
    np.testing.assert_array_equal(
        CyclicParticipation(8, 0.25).mask((), 1)[0].numpy(), masks[1])


@pytest.mark.parametrize("m,drop,horizon,seed", [(8, 0.3, 32, 5),
                                                 (16, 0.2, 20, 0),
                                                 (5, 0.9, 40, 3)])
def test_straggler_trace_is_the_references_bitwise(m, drop, horizon, seed):
    """The same numpy trace, and the same masks (dead rows of the
    high-dropout case fall back to every client on both sides), beyond
    the horizon too (the trace wraps)."""
    pol = make_policy("straggler", m, drop_prob=drop, horizon=horizon,
                      seed=seed)
    ref = jax_selection.make_policy("straggler", m, drop_prob=drop,
                                    horizon=horizon, seed=seed)
    np.testing.assert_array_equal(pol.trace.numpy(), np.asarray(ref.trace))
    np.testing.assert_array_equal(_roll(pol, horizon + 7),
                                  _jax_roll(ref, horizon + 7))
    assert not _roll(pol, horizon).all(axis=1).all()


@pytest.mark.parametrize("periods", [None, [1, 2, 3, 4, 1, 2, 3, 5]])
def test_periodic_is_the_references_bitwise(periods):
    pol = make_policy("periodic", 8, periods=periods, horizon=24)
    ref = jax_selection.make_policy("periodic", 8, periods=periods,
                                    horizon=24)
    np.testing.assert_array_equal(_roll(pol, 30), _jax_roll(ref, 30))
    np.testing.assert_array_equal(_roll(pol, 1)[0], np.ones(8, bool))


def test_availability_replays_trace_and_wraps():
    trace = np.array([[1, 0, 1], [0, 1, 0]], bool)
    masks = _roll(AvailabilityParticipation(3, trace), 4)
    np.testing.assert_array_equal(masks, np.concatenate([trace, trace]))


def test_availability_dead_round_falls_back_to_full():
    trace = np.array([[0, 0, 0], [1, 0, 0]], bool)
    masks = _roll(AvailabilityParticipation(3, trace), 2)
    np.testing.assert_array_equal(masks[0], np.ones(3, bool))
    np.testing.assert_array_equal(masks[1], trace[1])
    # the policy hands out copies: a caller writing a mask leaves the trace
    pol = AvailabilityParticipation(3, trace)
    pol.mask((), 1)[0].fill_(True)
    np.testing.assert_array_equal(pol.trace.numpy(), trace)


def test_uniform_cardinality_and_determinism():
    masks = _roll(UniformParticipation(8, 0.5, seed=3), 12)
    np.testing.assert_array_equal(masks.sum(axis=1), 4)
    np.testing.assert_array_equal(
        masks, _roll(UniformParticipation(8, 0.5, seed=3), 12))
    assert any(not np.array_equal(masks[0], mk) for mk in masks[1:])
    assert not np.array_equal(masks,
                              _roll(UniformParticipation(8, 0.5, seed=4), 12))


def test_uniform_state_is_not_changed_by_a_draw():
    """`mask` leaves its argument alone, so a state can be drawn from
    again (the engine puts back the state at the eq. (35) stop)."""
    pol = UniformParticipation(16, 0.25, seed=7)
    s0 = pol.init()
    copy = s0["key"].copy()
    a, s1 = pol.mask(s0, 0)
    assert np.array_equal(s0["key"], copy)
    b, _ = pol.mask(s0, 0)
    assert torch.equal(a, b)
    assert not np.array_equal(s1["key"], s0["key"])


@pytest.mark.parametrize("m,alpha,seed", [(8, 0.5, 3), (128, 0.5, 1),
                                          (100, 0.1, 0), (1000, 0.25, 9),
                                          (16384, 0.5, 0), (16, 1.0, 2)])
def test_uniform_is_the_references_bitwise(m, alpha, seed):
    """The same threefry chain: the key split once a round, the mask the
    ranks of `permutation(sub, m)` below |C|, for every round; the state
    is the reference's key word for word."""
    pol = UniformParticipation(m, alpha, seed=seed)
    ref = jax_selection.UniformParticipation(m, alpha, seed=seed)
    ps, rs = pol.init(), ref.init()
    for r in range(4):
        mask, ps = pol.mask(ps, r)
        want, rs = ref.mask(rs, jnp.int32(r))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ps["key"], np.asarray(rs["key"]))


@pytest.mark.parametrize("m,alpha,seed", [(8, 0.25, 0), (128, 0.5, 1),
                                          (1000, 0.1, 4), (16384, 0.5, 0)])
def test_weighted_is_the_references(m, alpha, seed):
    """The same keys and masks as the reference, with unequal weights;
    the Gumbel keys z within 2**-19."""
    w = np.random.default_rng(seed).uniform(0.1, 10.0, m).astype(np.float32)
    pol = WeightedParticipation(m, alpha, w, seed=seed)
    ref = jax_selection.WeightedParticipation(m, alpha, w, seed=seed)
    ps, rs = pol.init(), ref.init()
    for r in range(4):
        _, sub = prng.split(ps["key"])
        z = pol.gumbel_keys(sub).numpy()
        z_ref = np.asarray(ref.log_w + jax.random.gumbel(
            jax.random.split(rs["key"])[1], (m,)))
        np.testing.assert_allclose(z, z_ref, rtol=0, atol=2.0 ** -19)
        mask, ps = pol.mask(ps, r)
        want, rs = ref.mask(rs, jnp.int32(r))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ps["key"], np.asarray(rs["key"]))


def test_uniform_is_uniform_over_clients():
    """The reference's statistic, on the port's and the reference's
    draws alike."""
    for masks in (_roll(UniformParticipation(8, 0.25, seed=0), 400),
                  _jax_roll(jax_selection.UniformParticipation(8, 0.25), 400)):
        np.testing.assert_allclose(masks.mean(axis=0), 0.25, atol=0.08)


def test_weighted_cardinality_and_bias():
    weights = np.array([1, 1, 1, 1, 1, 1, 1, 20.0])
    for masks in (
            _roll(WeightedParticipation(8, 0.25, weights, seed=0), 300),
            _jax_roll(jax_selection.WeightedParticipation(8, 0.25, weights),
                      300)):
        np.testing.assert_array_equal(masks.sum(axis=1), 2)
        freq = masks.mean(axis=0)
        assert freq[-1] > 0.9
        assert freq[:-1].max() < 0.5
    np.testing.assert_array_equal(
        _roll(WeightedParticipation(8, 0.25, weights, seed=0), 50),
        _roll(WeightedParticipation(8, 0.25, weights, seed=0), 50))


def test_weighted_is_gumbel_top_k():
    """The mask is the reference's rule on the round's draw: Gumbel keys
    on the log-weights from the split-off key, every key >= the n_sel-th
    largest kept (ties kept too, as the reference's `z >= kth`)."""
    weights = np.arange(1.0, 33.0)
    pol = WeightedParticipation(32, 0.25, weights, seed=5)
    state = pol.init()
    for r in range(20):
        mask, nxt = pol.mask(state, r)
        key, sub = prng.split(state["key"])
        z = torch.log(torch.tensor(weights, dtype=torch.float32)) \
            + torch.from_numpy(prng.gumbel(sub, 32))
        assert torch.equal(mask, z >= torch.topk(z, 8).values[-1])
        assert np.array_equal(nxt["key"], key)
        state = nxt


def test_weighted_alpha_one_selects_all():
    masks = _roll(WeightedParticipation(4, 1.0, np.arange(1.0, 5.0)), 3)
    np.testing.assert_array_equal(masks, np.ones((3, 4), bool))


def test_weighted_zero_weight_is_never_drawn_and_u_zero_is_finite(
        monkeypatch):
    """Log-weights clamped at 1e-30, as the reference's: a zero weight is
    a finite, far smaller key. A uniform draw of exactly 0 is kept off
    the Gumbel transform (its key would be infinite)."""
    pol = WeightedParticipation(4, 0.5, [0.0, 1.0, 1.0, 1.0], seed=1)
    assert torch.isfinite(pol.log_w).all()
    assert not _roll(pol, 200)[:, 0].any()
    monkeypatch.setattr(prng, "random_bits",
                        lambda key, n: np.zeros((n,), np.uint32))
    assert np.isfinite(prng.gumbel(prng.prng_key(0), 4)).all()
    mask, _ = pol.mask(pol.init(), 0)
    assert int(mask.sum()) >= 2


def test_make_policy_kinds():
    assert make_policy("full", 8) is None
    assert isinstance(make_policy("uniform", 8, 0.5), UniformParticipation)
    assert isinstance(make_policy("weighted", 8, 0.5), WeightedParticipation)
    assert isinstance(make_policy("cyclic", 8, 0.5), CyclicParticipation)
    assert isinstance(make_policy("straggler", 8, drop_prob=0.1, horizon=16),
                      AvailabilityParticipation)
    assert isinstance(
        make_policy("periodic", 8, periods=[1, 2, 3, 4, 1, 2, 3, 4],
                    horizon=16), AvailabilityParticipation)
    assert selection.POLICIES == jax_selection.POLICIES
    for kind, cap in (("uniform", 4), ("weighted", 4), ("cyclic", 4),
                      ("straggler", 8), ("periodic", 8)):
        pol = make_policy(kind, 8, 0.5, horizon=4)
        ref = jax_selection.make_policy(kind, 8, 0.5, horizon=4)
        assert pol.active_capacity == ref.active_capacity == cap, kind
        assert pol.n_selected == ref.n_selected, kind
        assert pol.name == ref.name, kind


def test_make_policy_errors():
    with pytest.raises(KeyError, match="unknown participation policy"):
        make_policy("nope", 8)
    with pytest.raises(ValueError, match="weights"):
        make_policy("weighted", 8, 0.5, weights=[1.0, 2.0])
    with pytest.raises(ValueError, match="periods"):
        make_policy("periodic", 8, periods=[1, 2])
    with pytest.raises(ValueError, match="periods must be >= 1"):
        make_policy("periodic", 2, periods=[0, 1])
    with pytest.raises(ValueError, match="trace"):
        AvailabilityParticipation(3, np.ones((4, 2), bool))
    with pytest.raises(ValueError, match="at least one client"):
        ParticipationPolicy(0)
