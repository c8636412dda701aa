"""The port's client-sharded rounds under engine masks, async stale-x̄
arrivals and the weighted clock (mirrors tests/test_participation.py::
test_masked_sharded_matches_single_device, tests/test_async.py::
test_async_sharded_matches_single_device and tests/test_wallclock.py::
test_weighted_sharded_one_psum_and_parity).

Each port run on gloo ranks is held to the JAX package's run of the same
configuration on 8 fake devices (`torch_sharded.run_both`) at the
reference's tolerance for these rounds, rtol 1e-4 / atol 1e-6; the
integer metrics (`selected`, `staleness`) exactly. Every rank's x̄ and
history are bitwise alike, and the staleness-weighted round keeps the
uniform round's count of model-size all-reduces (the weight sum rides
eq. (11)'s buffer).
"""
import numpy as np
import pytest

from torch_sharded import assert_run_close, counts, run_both

CASES = ("fedgia", "scaffold")

_JAX = '''
from repro.core.clock import ComputeClock
from repro.core.selection import AvailabilityParticipation, UniformParticipation
for algo_name, kw, mesh in (
    ("fedgia", dict(sigma_t=0.3, h_policy="diag_ema", alpha=1.0),
     make_host_mesh(data=8)),
    ("scaffold", dict(lr=0.01), make_host_mesh(model=2, data=4)),
):
    algo, s0, batch = setup(algo_name, k0=5, **kw)
    pol = UniformParticipation(8, 0.5, seed=2)
    put("masked_" + algo_name, run_rounds(
        algo, s0, batch, 10, scan=True, chunk_size=5, participation=pol,
        mesh=mesh))
    pol = AvailabilityParticipation.from_periods(
        8, 1 + (np.arange(8) % 3), horizon=10)
    put("async_" + algo_name, run_rounds(
        algo, s0, batch, 10, scan=True, chunk_size=5, participation=pol,
        async_rounds=True, max_staleness=2, mesh=mesh))

algo, s0, batch = setup("fedgia", k0=5, alpha=1.0, sigma_t=0.3,
                        h_policy="diag_ema")
clk = ComputeClock(8, compute_s=1.0 + (np.arange(8) % 3))
put("weighted", run_rounds(algo, s0, batch, 10, scan=True, chunk_size=5,
                           clock=clk, max_staleness=2,
                           stale_weighting="poly",
                           mesh=make_host_mesh(data=8)))
'''

_PORT = '''
def rank_fn(OUT):
    mesh8 = mesh_mod.make_host_mesh(data=8)
    mesh42 = mesh_mod.make_host_mesh(model=2, data=4)
    for algo_name, kw, mesh in (
        ("fedgia", dict(sigma_t=0.3, h_policy="diag_ema", alpha=1.0),
         mesh8),
        ("scaffold", dict(lr=0.01), mesh42),
    ):
        algo, s0, batch = setup(algo_name, k0=5, **kw)
        pol = UniformParticipation(8, 0.5, seed=2)
        res = run_rounds(algo, s0, batch, 10, scan=True, chunk_size=5,
                         participation=pol, mesh=mesh)
        put(OUT, "masked_" + algo_name, res)
        replicated(OUT, "masked_" + algo_name, res)
        pol = AvailabilityParticipation.from_periods(
            8, 1 + (np.arange(8) % 3), horizon=10)
        res = run_rounds(algo, s0, batch, 10, scan=True, chunk_size=5,
                         participation=pol, async_rounds=True,
                         max_staleness=2, mesh=mesh)
        put(OUT, "async_" + algo_name, res)
        replicated(OUT, "async_" + algo_name, res)
        # the legacy loop: the same rounds, bit for bit the chunked ones
        leg = run_rounds(algo, s0, batch, 10, scan=False,
                         participation=pol, async_rounds=True,
                         max_staleness=2, mesh=mesh)
        put(OUT, "async_legacy_" + algo_name, leg)

    algo, s0, batch = setup("fedgia", k0=5, alpha=1.0, sigma_t=0.3,
                            h_policy="diag_ema")
    clk = ComputeClock(8, compute_s=1.0 + (np.arange(8) % 3))
    res = run_rounds(algo, s0, batch, 10, scan=True, chunk_size=5,
                     clock=clk, max_staleness=2, stale_weighting="poly",
                     mesh=mesh8)
    put(OUT, "weighted", res)
    replicated(OUT, "weighted", res)
    # eq. (11)'s model-size all-reduces, uniform against weighted
    spec = pt.ravel_spec(s0["x"])
    s0f = flatten_state(algo, s0, spec)
    for weighting in ("uniform", "poly"):
        rf = make_round_fn(algo, mesh8, masked=True, stale=True,
                           flat_spec=spec)
        st, b = shard_inputs(algo, s0f, batch, mesh8)
        sl = api.init_stale_xbar(s0f["x"], 1, 2, weighting=weighting,
                                 decay=1.0)
        OUT["budget/" + weighting] = budget(
            lambda: rf(st, b, torch.ones(8, dtype=torch.bool), sl),
            spec.padded_size)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("sharded_async")), _JAX,
                    _PORT, world=8)


@pytest.mark.parametrize("name", CASES)
def test_masked_sharded_matches_single_device(runs, name):
    """Uniform participation (alpha 0.5): FedGiA_D on data=8, SCAFFOLD on
    (data 4, model 2), chunk 5, against the reference's sharded runs;
    four participants every round."""
    ref, port = runs
    assert_run_close(port, ref, f"masked_{name}", rtol=1e-4, atol=1e-6)
    assert list(port[f"masked_{name}/hist/selected"]) == [4.0] * 10
    assert bool(port[f"masked_{name}/replicated"])


@pytest.mark.parametrize("name", CASES)
def test_async_sharded_matches_single_device(runs, name):
    """Periodic arrivals (periods 1..3), max_staleness 2: the history and
    every state entry against the reference's sharded async run, the
    staleness exactly (its bound reached), and the legacy loop bit for
    bit the chunked driver."""
    ref, port = runs
    assert_run_close(port, ref, f"async_{name}", rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(port[f"async_{name}/hist/staleness"],
                                  ref[f"async_{name}/hist/staleness"])
    assert port[f"async_{name}/hist/staleness"].max() == 2
    assert bool(port[f"async_{name}/replicated"])
    for k in port:
        if k.startswith(f"async_legacy_{name}/"):
            np.testing.assert_array_equal(
                port[k], port[k.replace("async_legacy_", "async_")],
                err_msg=k)


def test_weighted_sharded_one_psum_and_parity(runs):
    """Eq. (11) with staleness weights keeps the round's one model-size
    all-reduce (the uniform round's count), and the poly-weighted
    clocked run on data=8 matches the reference's (sim_time exactly)."""
    ref, port = runs
    uni, wtd = counts(port["budget/uniform"]), counts(port["budget/poly"])
    assert wtd["all_reduce_model"] == uni["all_reduce_model"] == 1, (uni,
                                                                     wtd)
    assert_run_close(port, ref, "weighted", rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(port["weighted/hist/sim_time"],
                                  ref["weighted/hist/sim_time"])
    assert bool(port["weighted/replicated"])
