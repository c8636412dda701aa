"""The port's client-sharded flat rounds on gloo ranks (mirrors
tests/test_flat.py::test_flat_sharded_one_all_reduce_and_parity and
tests/test_sharding_multidevice.py's two parity tests).

Every port run here is held to the JAX package's run of the same
configuration on 8 fake devices (`torch_sharded.run_both`, once for the
file), at the reference's tolerances: rtol 1e-5 / atol 1e-6 for the sync
rounds, 1e-4 / 1e-6 for the async ones. Never bitwise: XLA's all-reduce
and gloo's ring sum in other orders. Within the port:

  * the flat sharded round issues exactly ONE model-size all-reduce (eq.
    (11) with its riders in one buffer), at most one reduce-scatter (the
    gradient-norm diagnostic) and no all-gather, for all five algorithms,
    sync and stale, counted from `torch.profiler`'s c10d events on a rank
    (`launch.mesh.profile_collectives`);
  * x̄ and the history are bitwise the same on every rank.
"""
import numpy as np
import pytest

from torch_sharded import assert_run_close, counts, run_both

FIVE = ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold")

_JAX = '''
mesh8 = make_host_mesh(data=8)
for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
    algo, s0, batch = setup(name, k0=3, alpha=1.0, sigma_t=0.3,
                            h_policy="diag_ema", lr=0.01)
    pol = make_policy("straggler", 8, 0.5, seed=0, drop_prob=0.3,
                      horizon=10)
    put("flat_" + name, run_rounds(algo, s0, batch, 10, mesh=mesh8,
                                   participation=pol, async_rounds=True,
                                   max_staleness=2))

# tests/test_sharding_multidevice.py: the per-leaf round on (data 4,
# model 2), against its single-device steps
from jax.sharding import NamedSharding
from repro.sharding import fed_state_specs, train_batch_specs, sanitize_specs
algo, s0, batch = setup("fedgia", m=4, k0=5, alpha=1.0, sigma_t=0.3,
                        h_policy="scalar", client_axes=("data",))
mesh = make_host_mesh(model=2, data=4)
shapes = jax.eval_shape(lambda: s0)
sspec = sanitize_specs(fed_state_specs(algo.fed, None, shapes), shapes, mesh)
bshapes = jax.eval_shape(lambda: batch)
bspec = sanitize_specs(train_batch_specs(algo.fed, bshapes, mesh.axis_names),
                       bshapes, mesh)
shard = lambda sp: jax.tree.map(lambda s: NamedSharding(mesh, s), sp)
state = jax.device_put(s0, shard(sspec))
b = jax.device_put(batch, shard(bspec))
step = jax.jit(algo.round, in_shardings=(shard(sspec), shard(bspec)),
               out_shardings=None)
for _ in range(5):
    state, met = step(state, b)
OUT["leaf/x"] = np.asarray(state["x"]["x"])
OUT["leaf/f_xbar"] = np.asarray(met["f_xbar"])

for h_policy, mesh in (("scalar", make_host_mesh(data=8)),
                       ("diag_ema", make_host_mesh(model=2, data=4))):
    algo, s0, batch = setup("fedgia", k0=5, alpha=0.5, sigma_t=0.3,
                            h_policy=h_policy)
    put("engine_" + h_policy, run_rounds(algo, s0, batch, 10, scan=True,
                                         chunk_size=5, mesh=mesh))
'''

_PORT = '''
def rank_fn(OUT):
    mesh8 = mesh_mod.make_host_mesh(data=8)
    for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
        algo, s0, batch = setup(name, k0=3, alpha=1.0, sigma_t=0.3,
                                h_policy="diag_ema", lr=0.01)
        spec = pt.ravel_spec(s0["x"])
        s0f = flatten_state(algo, s0, spec)
        for stale in (False, True):
            rf = make_round_fn(algo, mesh8, masked=True, stale=stale,
                               flat_spec=spec)
            st, b = shard_inputs(algo, s0f, batch, mesh8)
            args = (st, b, torch.ones(8, dtype=torch.bool))
            if stale:
                args = args + (api.init_stale_xbar(s0f["x"], 1, 2),)
            OUT["budget/%s/%s" % (name, stale)] = budget(
                lambda: rf(*args), spec.padded_size)
        pol = make_policy("straggler", 8, 0.5, seed=0, drop_prob=0.3,
                          horizon=10)
        res = run_rounds(algo, s0, batch, 10, mesh=mesh8,
                         participation=pol, async_rounds=True,
                         max_staleness=2)
        put(OUT, "flat_" + name, res)
        replicated(OUT, "flat_" + name, res)

    # the per-leaf round on (data 4, model 2): five legacy rounds
    mesh = mesh_mod.make_host_mesh(model=2, data=4)
    algo, s0, batch = setup("fedgia", m=4, k0=5, alpha=1.0, sigma_t=0.3,
                            h_policy="scalar", client_axes=("data",))
    res = run_rounds(algo, s0, batch, 5, scan=False, flat=False, mesh=mesh)
    OUT["leaf/x"] = res.state["x"]["x"].numpy()
    OUT["leaf/f_xbar"] = np.asarray(res.history["f_xbar"][-1])
    replicated(OUT, "leaf", res)

    for h_policy, mesh in (("scalar", mesh8),
                           ("diag_ema", mesh_mod.make_host_mesh(model=2,
                                                                data=4))):
        algo, s0, batch = setup("fedgia", k0=5, alpha=0.5, sigma_t=0.3,
                                h_policy=h_policy)
        res = run_rounds(algo, s0, batch, 10, scan=True, chunk_size=5,
                         mesh=mesh)
        put(OUT, "engine_" + h_policy, res)
        replicated(OUT, "engine_" + h_policy, res)
'''


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("sharded_flat")), _JAX,
                    _PORT, world=8)


@pytest.mark.parametrize("stale", [False, True])
@pytest.mark.parametrize("name", FIVE)
def test_flat_sharded_one_all_reduce(runs, name, stale):
    """The barrier round's budget: one model-size all-reduce, at most one
    (model-size) reduce-scatter, no all-gather."""
    c = counts(runs[1][f"budget/{name}/{stale}"])
    assert c["all_reduce_model"] == 1, c
    assert c["reduce_scatter"] <= 1 and c["all_gather"] == 0, c


@pytest.mark.parametrize("name", FIVE)
def test_flat_sharded_one_all_reduce_and_parity(runs, name):
    """The straggler async run on data=8 against the reference's on 8
    fake devices (rtol 1e-4, atol 1e-6), every rank's x̄ and history
    bitwise alike."""
    ref, port = runs
    assert_run_close(port, ref, f"flat_{name}", rtol=1e-4, atol=1e-6)
    assert bool(port[f"flat_{name}/replicated"])
    np.testing.assert_array_equal(port[f"flat_{name}/hist/staleness"],
                                  ref[f"flat_{name}/hist/staleness"])


def test_sharded_round_matches_single_device(runs):
    """The per-leaf round (`flat=False`) with m = 4 clients on (data 4,
    model 2): five rounds, x and f at rtol 1e-5 of the reference's
    GSPMD-sharded rounds; the model replicas agree bit for bit."""
    ref, port = runs
    np.testing.assert_allclose(port["leaf/x"], ref["leaf/x"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(port["leaf/f_xbar"], ref["leaf/f_xbar"],
                               rtol=1e-5)
    assert bool(port["leaf/replicated"])


@pytest.mark.parametrize("h_policy", ["scalar", "diag_ema"])
def test_engine_client_sharded_matches_single_device(runs, h_policy):
    """FedGiA's chunked driver (chunk 5, 10 rounds, alpha 0.5): scalar H
    on data=8, diag_ema on (data 4, model 2); x, z, π and the history at
    rtol 1e-5, atol 1e-6 of the reference's sharded engine."""
    ref, port = runs
    assert_run_close(port, ref, f"engine_{h_policy}", rtol=1e-5, atol=1e-6,
                     state_keys=("x", "z", "pi"))
    assert bool(port[f"engine_{h_policy}/replicated"])
