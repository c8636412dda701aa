"""The per-leaf pytree rounds of the port (`run_rounds(flat=False)`,
`--no-flat`), against its flat rounds and against the reference's own
per-leaf rounds (mirrors tests/test_flat.py and the `--no-flat` rows of
tests/test_train_flags.py).

* Tree arithmetic (`utils/pytree.py`) against the reference's tree_*
  helpers at rtol 1e-6 (the same float32 operations; sums in another
  order), and `data/partition.py` bit for bit (the same numpy draws).
* Flat against per-leaf, within the port: history and final state BIT
  FOR BIT for the eight set-ups of tests/test_flat.py, in the chunked
  driver and the legacy loop, under a straggler mask, async, a clock
  with "poly" weighting, and to an eq. (35) stop.
* The port's per-leaf rounds against the reference's per-leaf rounds on
  the same inputs: counts exact, f, |grad|^2 and the state at rtol 1e-5,
  atol 1e-6, diag_ema's h at rtol 2e-5 (XLA:CPU contracts a*b+c into one
  FMA where the port rounds twice, ROADMAP queue 3 f, so never bit for
  bit).
* The refusals, the guard and the checkpoints' flat fingerprint.
* A reduced tinyllama-1.1b in float32 under `--no-flat` against the
  reference's per-leaf run (f at rtol 1e-5) and the port's flat run (bit
  for bit).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.configs import get_config as jax_get_config
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import make_policy as jax_make_policy
from repro.core import run_rounds as jax_run_rounds
from repro.core.clock import ComputeClock as JaxComputeClock
from repro.data import dirichlet_partition as jax_dirichlet
from repro.data import equal_partition as jax_equal
from repro.data.tokens import synthetic_batch_for as jax_batch_for
from repro.models import LeastSquares as JaxLeastSquares
from repro.models import Transformer as JaxTransformer
from repro.utils import pytree as jpt
from repro_torch.config import FedConfig
from repro_torch.configs import get_config
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import ComputeClock
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import (
    dirichlet_partition,
    equal_partition,
    linreg_noniid,
    synthetic_batch_for,
    to_torch,
)
from repro_torch.launch.train import build_parser, train, validate_flags
from repro_torch.models import LeastSquares, Transformer
from repro_torch.utils import pytree as pt
from repro_torch.utils.convert import training_tree_from_numpy

M, N, D = 8, 20, 400
ROUNDS = 12
CHUNK = 5  # full and partial chunks
RTOL, ATOL = 1e-5, 1e-6
# diag_ema's h after 12 rounds: 1.02e-5 from the reference's on one of 160
# elements, the same for the port's flat rounds against the reference's
# flat rounds (measured): the EMA divides by the round's largest squared
# gradient, whose rounding it passes on to every element
H_RTOL = 2e-5

# tests/test_flat.py's set-ups
ALGO_SETUPS = {
    "fedgia": dict(sigma_t=0.2, h_policy="scalar", alpha=0.5),
    "fedgia_diag": dict(sigma_t=0.2, h_policy="diag_ema", alpha=0.5),
    "fedgia_unrolled": dict(sigma_t=0.2, h_policy="diag_ema", alpha=0.5,
                            collapsed=False),
    "fedgia_gram": dict(sigma_t=0.2, h_policy="gram", alpha=0.5,
                        collapsed=False),
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002, prox_mu=1e-4, inner_steps=3),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(lr=0.01),
}


def _policy(package_policy):
    return package_policy("straggler", M, 0.5, seed=0, drop_prob=0.3,
                          horizon=ROUNDS)


def _clock(package_clock):
    return package_clock(M, 1.0 + (np.arange(M) % 3))


# every mode of tests/test_flat.py: run_rounds' keywords in each package
MODES = {
    "scan": lambda p, c: dict(chunk_size=CHUNK),
    "legacy": lambda p, c: dict(scan=False),
    "masked": lambda p, c: dict(participation=_policy(p)),
    "async": lambda p, c: dict(participation=_policy(p), async_rounds=True,
                               max_staleness=2),
    "clocked": lambda p, c: dict(clock=_clock(c), max_staleness=2,
                                 stale_weighting="poly"),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _config(key, **overrides):
    name = "fedgia" if key.startswith("fedgia") else key
    kw = dict(algorithm=name, num_clients=M, k0=3, **ALGO_SETUPS[key])
    kw.update(overrides)
    return kw


def _make(raw, key, **overrides):
    model = LeastSquares(N)
    algo = make_algorithm(FedConfig(**_config(key, **overrides)), model.loss,
                          model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_bitwise(res, ref, what):
    assert res.rounds_run == ref.rounds_run, what
    assert res.stopped_early == ref.stopped_early, what
    assert set(res.history) == set(ref.history), what
    for k in ref.history:
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=f"{what}/{k}")
    got, want = dict(_leaves(res.state)), dict(_leaves(ref.state))
    assert set(got) == set(want), what
    for k in want:
        assert torch.equal(got[k], want[k]), f"{what}: state[{k}]"
    assert res.state["round"] == ref.state["round"], what
    np.testing.assert_array_equal(res.state["rng"], ref.state["rng"])


# ---------------------------------------------------------- tree arithmetic
def test_tree_ops_match_reference():
    rng = np.random.default_rng(0)
    a_np = {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32),
            "blk/q": rng.standard_normal((2, 2)).astype(np.float32)}
    b_np = {k: rng.standard_normal(v.shape).astype(np.float32)
            for k, v in a_np.items()}
    ta, tb = ({k: torch.from_numpy(v) for k, v in t.items()}
              for t in (a_np, b_np))
    ja, jb = ({k: jnp.asarray(v) for k, v in t.items()}
              for t in (a_np, b_np))

    def same(got, want, rtol=1e-6):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_allclose(got[k].numpy(),
                                           np.asarray(want[k]), rtol=rtol,
                                           err_msg=k)
        else:
            np.testing.assert_allclose(float(got), float(want), rtol=rtol)

    for name in ("tree_add", "tree_sub", "tree_mul", "tree_dot"):
        same(getattr(pt, name)(ta, tb), getattr(jpt, name)(ja, jb))
    same(pt.tree_scale(ta, 0.5), jpt.tree_scale(ja, 0.5))
    same(pt.tree_axpy(-2.0, ta, tb), jpt.tree_axpy(-2.0, ja, jb))
    for name in ("tree_sq_norm", "tree_norm", "tree_zeros_like",
                 "tree_ones_like"):
        same(getattr(pt, name)(ta), getattr(jpt, name)(ja))
    assert pt.tree_size(ta) == jpt.tree_size(ja) == 21
    assert pt.tree_bytes(ta) == jpt.tree_bytes(ja) == 84
    assert pt.tree_cast(ta, torch.bfloat16)["w"].dtype == torch.bfloat16
    same(pt.tree_where(torch.tensor(False), ta, tb),
         jpt.tree_where(jnp.asarray(False), ja, jb))
    stacked = pt.tree_stack([ta, tb])
    same(stacked, jpt.tree_stack([ja, jb]))
    same(pt.tree_mean_over_axis(stacked), jpt.tree_mean_over_axis(
        jpt.tree_stack([ja, jb])))
    back = pt.tree_unstack(stacked)
    assert len(back) == 2
    same(back[1], tb)
    assert pt.tree_allclose(ta, back[0])
    assert not pt.tree_allclose(ta, tb)
    # the leaf order is ravel_spec's, so the reductions sum as the flat
    # path's metric does
    assert [x.shape for x in pt.tree_leaves(ta)] == [
        tuple(s) for s in pt.ravel_spec(ta).shapes]


def test_partition_is_the_references_bit_for_bit():
    for n, m in ((100, 7), (12, 12), (5, 8)):
        assert equal_partition(n, m) == jax_equal(n, m)
    labels = np.random.default_rng(3).integers(0, 10, 500)
    for alpha, seed in ((0.1, 0), (1.0, 5)):
        got = dirichlet_partition(labels, 6, alpha, seed=seed)
        want = jax_dirichlet(labels, 6, alpha, seed=seed)
        assert len(got) == len(want) == 6
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_client_mean_of_a_tree_is_the_flat_buffers():
    """A tree's eq. (11) reduces each leaf as the flat buffer reduces its
    lanes, so the mean, the masked mean and the weighted mean are the
    flat buffer's bit for bit (a leaf reduced as (m, ...) is not, on the
    CPU)."""
    from repro_torch.core import api

    rng = np.random.default_rng(1)
    tree = {k: torch.from_numpy(rng.standard_normal(
        (64,) + s).astype(np.float32))
        for k, s in (("a", (5,)), ("b", (7, 3)), ("c", (33,)))}
    spec = pt.ravel_spec({k: v[0] for k, v in tree.items()})
    flat = spec.ravel_stacked(tree)
    mask = torch.from_numpy(rng.random(64) < 0.5)
    w = torch.from_numpy(rng.uniform(0.1, 1.0, 64).astype(np.float32))
    for kw in ({}, {"mask": mask}, {"weights": w},
               {"mask": mask, "weights": w}):
        got = api.client_mean(tree, **kw)
        want = spec.unravel(api.client_mean(flat, **kw))
        for k in tree:
            assert torch.equal(got[k], want[k]), (k, kw)


# ---------------------------------------------- flat == per-leaf, port
@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("algo_key", sorted(ALGO_SETUPS))
def test_flat_matches_pytree(raw, algo_key, mode):
    algo, state, batch = _make(raw, algo_key)
    kw = MODES[mode](make_policy, ComputeClock)
    ref = run_rounds(algo, state, batch, ROUNDS, flat=True, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, flat=False, **kw)
    _assert_bitwise(res, ref, f"{algo_key}/{mode}")


def test_flat_early_stop_matches(raw):
    algo, state, batch = _make(raw, "fedgia", k0=5)
    ref = run_rounds(algo, state, batch, 300, tol=1e-7, chunk_size=13)
    res = run_rounds(algo, state, batch, 300, tol=1e-7, chunk_size=13,
                     flat=False)
    assert ref.stopped_early and res.rounds_run % 13 != 0
    _assert_bitwise(res, ref, "stop")
    eager = run_rounds(algo, state, batch, 300, tol=1e-7, scan=False,
                       flat=False)
    _assert_bitwise(eager, ref, "stop, legacy")


def test_pytree_run_leaves_the_callers_state(raw):
    algo, state, batch = _make(raw, "scaffold")
    before = {k: v.clone() for k, v in _leaves(state)}
    res = run_rounds(algo, state, batch, 4, flat=False)
    for k, v in _leaves(state):
        assert torch.equal(v, before[k]), k
    assert res.state["x"]["x"].shape == (N,)
    assert res.state["ci"]["x"].shape == (M, N)


# ------------------------------------------- per-leaf, port vs reference
@pytest.fixture(scope="module")
def reference(raw):
    """One reference run per (set-up, mode) with `flat=False`, in its
    legacy loop (one compiled round)."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    cache = {}

    def get(algo_key, mode):
        if (algo_key, mode) not in cache:
            jmodel = JaxLeastSquares(N)
            jalgo = jax_make_algorithm(JaxFedConfig(**_config(algo_key)),
                                       jmodel.loss, model=jmodel)
            jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                                jax.random.PRNGKey(1), init_batch=jb)
            kw = MODES[mode](jax_make_policy, JaxComputeClock)
            kw["scan"] = False
            kw.pop("chunk_size", None)
            cache[algo_key, mode] = jax_run_rounds(
                jalgo, jstate, jb, ROUNDS, flat=False, **kw)
        return cache[algo_key, mode]

    return get


@pytest.mark.parametrize("algo_key,mode", (
    [(k, "scan") for k in sorted(ALGO_SETUPS)]
    + [(k, "async") for k in ("fedgia_diag", "fedavg", "scaffold")]
    + [("fedgia_diag", "clocked"), ("fedpd", "masked")]))
def test_pytree_matches_reference_pytree(raw, reference, algo_key, mode):
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, flat=False,
                     **MODES[mode](make_policy, ComputeClock))
    want = reference(algo_key, mode)
    assert got.rounds_run == want.rounds_run
    assert set(got.history) == set(want.history)
    for k in got.history:
        if k in ("f_xbar", "grad_sq_norm"):
            np.testing.assert_allclose(got.history[k], want.history[k],
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        else:
            np.testing.assert_array_equal(got.history[k], want.history[k],
                                          err_msg=k)
    for key, leaf in _leaves(got.state):
        k, name = key.split(".")
        np.testing.assert_allclose(leaf.numpy(),
                                   np.asarray(want.state[k][name]),
                                   rtol=H_RTOL if k == "h" else RTOL,
                                   atol=ATOL, err_msg=key)


# ----------------------------------------------------------- refusals
@pytest.mark.parametrize("kw,match", [
    (dict(participation="uniform", store="active"),
     "store='active' packs the flat"),
    (dict(participation="uniform", store="offload"),
     "store='offload' packs the flat"),
    (dict(compression="int8"), "compression operates on the flat"),
    (dict(screening="on"), "faults/screening operate on the flat"),
    (dict(faults="crash"), "faults/screening operate on the flat"),
])
def test_engine_refuses_what_needs_the_flat_buffers(raw, kw, match):
    from repro_torch.core.faults import Screening, make_faults

    algo, state, batch = _make(raw, "fedavg")
    kw = dict(kw)
    if kw.get("participation") == "uniform":
        kw["participation"] = make_policy("uniform", M, 0.5, seed=0)
    if kw.get("screening") == "on":
        kw["screening"] = Screening()
    if kw.get("faults") == "crash":
        kw["faults"] = make_faults(["crash"], [0.1], num_clients=M, seed=0)
    with pytest.raises(ValueError, match=match):
        run_rounds(algo, state, batch, 2, flat=False, **kw)
    # the identity codec without error feedback is no codec at all
    if kw.get("compression") == "int8":
        run_rounds(algo, state, batch, 2, flat=False, compression="none")


def test_engine_refuses_the_kernel_without_flat_buffers(raw):
    algo, state, batch = _make(raw, "fedgia", use_kernel=True)
    with pytest.raises(ValueError, match="requires the flat round path"):
        run_rounds(algo, state, batch, 2, flat=False)


BASE = ["--problem", "linreg", "--clients", "8", "--rounds", "4"]


@pytest.mark.parametrize("argv,match", [
    # tests/test_train_flags.py's --no-flat rows that the port's CLI has
    # (its --overlap and --kernel interpret rows: the port has no overlap
    # flag, and refuses interpret whatever --no-flat says)
    (["--kernel", "on", "--no-flat"], "requires the flat round path"),
    (["--store", "active", "--no-flat"], "--store active packs the flat"),
    (["--store", "offload", "--no-flat"], "--store offload packs the flat"),
    (["--compression", "int8", "--no-flat"],
     "--compression runs on the flat"),
    (["--faults", "crash", "--no-flat"], "--faults corrupts the flat"),
    (["--screening", "--no-flat"], "--screening filters the flat"),
])
def test_cli_refuses_no_flat_where_the_reference_does(argv, match):
    with pytest.raises(SystemExit, match=match):
        validate_flags(build_parser().parse_args(BASE + argv))


def test_cli_no_flat_runs_and_matches_flat():
    assert validate_flags(build_parser().parse_args(BASE))["flat"]
    args = BASE + ["--device", "cpu", "--clients", "16", "--samples",
                   "1600", "--rounds", "20", "--tol", "0"]
    out = {}
    for extra in ([], ["--no-flat"], ["--no-flat", "--no-scan"],
                  ["--no-flat", "--participation", "uniform", "--alpha",
                   "0.25", "--algo", "scaffold"],
                  ["--participation", "uniform", "--alpha", "0.25",
                   "--algo", "scaffold"]):
        res = train(build_parser().parse_args(args + extra))
        out[tuple(extra)] = [(h["f"], h["err"]) for h in res["history"]]
    assert out[()] == out[("--no-flat",)] == out[("--no-flat", "--no-scan")]
    assert out[tuple(["--no-flat", "--participation", "uniform", "--alpha",
                      "0.25", "--algo", "scaffold"])] == out[tuple(
                          ["--participation", "uniform", "--alpha", "0.25",
                           "--algo", "scaffold"])]


# ----------------------------------------------- guard and checkpoints
def test_guard_under_pytree_rounds_matches_flat(raw):
    algo, state, batch = _make(raw, "fedgia_diag")
    pol = make_policy("straggler", M, 0.5, seed=0, drop_prob=0.6,
                      horizon=ROUNDS)
    kw = dict(participation=pol, quorum=4, watchdog=True, chunk_size=CHUNK)
    ref = run_rounds(algo, state, batch, ROUNDS, **kw)
    res = run_rounds(algo, state, batch, ROUNDS, flat=False, **kw)
    assert ref.history["degraded"].any()
    _assert_bitwise(res, ref, "guard")


def test_checkpoint_resume_and_flat_fingerprint(raw, tmp_path):
    algo, state, batch = _make(raw, "fedgia_diag")
    pol = make_policy("uniform", M, 0.5, seed=0)
    kw = dict(participation=pol, async_rounds=True, max_staleness=2,
              chunk_size=2, flat=False)
    whole = run_rounds(algo, state, batch, 8, **kw)
    d = str(tmp_path / "run")
    run_rounds(algo, state, batch, 4, checkpoint_every=2, checkpoint_dir=d,
               **kw)
    resumed = run_rounds(algo, state, batch, 8, checkpoint_every=2,
                         checkpoint_dir=d, resume=True, **kw)
    _assert_bitwise(resumed, whole, "resume")
    assert torch.equal(resumed.stale.anchor["x"], whole.stale.anchor["x"])
    # a flat run must not resume the per-leaf run's carry
    with pytest.raises(ValueError, match="fingerprint"):
        run_rounds(algo, state, batch, 8, checkpoint_every=2,
                   checkpoint_dir=d, resume=True,
                   **dict(kw, flat=True))


# ------------------------------------------------- a transformer's tree
def test_reduced_tinyllama_no_flat_matches_reference():
    """`--arch tinyllama-1.1b --reduced --no-flat` in float32: the port's
    per-leaf rounds on the multi-leaf training tree against the
    reference's `flat=False` rounds (f at rtol 1e-5, x̄ normwise at
    1e-5), and against the port's own flat rounds, bit for bit (r from
    `FedConfig.lipschitz`: the probe's float32 norms are held apart, in
    tests/test_torch_train_engine.py)."""
    arch, m, b, s, rounds = "tinyllama-1.1b", 4, 2, 16, 4
    jcfg = dataclasses.replace(jax_get_config(arch).reduced(),
                               dtype="float32")
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    kw = dict(algorithm="fedgia", num_clients=m, k0=3, alpha=0.5,
              sigma_t=30.0, h_policy="diag_ema")
    jmodel = JaxTransformer(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(0))
    jbatch = jax.tree.map(jnp.asarray, jax_batch_for(jcfg, m, b, s))
    jalgo = jax_make_algorithm(JaxFedConfig(**kw), jmodel.loss, model=jmodel)
    jstate = jalgo.init(jparams, jax.random.PRNGKey(1), init_batch=jbatch)
    want = jax_run_rounds(jalgo, jstate, jbatch, rounds, flat=False,
                          scan=False)

    model = Transformer(cfg, "cpu")
    algo = make_algorithm(FedConfig(**kw), model.loss, model=model)
    batch = to_torch(synthetic_batch_for(cfg, m, b, s), "cpu")
    state = algo.init(training_tree_from_numpy(jax.device_get(jparams),
                                               "cpu"),
                      prng_key(1), init_batch=batch)
    got = run_rounds(algo, state, batch, rounds, flat=False)
    assert len(got.state["x"]) > 10  # a multi-leaf tree
    np.testing.assert_allclose(got.history["f_xbar"],
                               np.asarray(want.history["f_xbar"]),
                               rtol=1e-5)
    np.testing.assert_array_equal(got.history["selected"],
                                  np.asarray(want.history["selected"]))
    spec = pt.ravel_spec(got.state["x"])
    x = spec.ravel(got.state["x"])
    wx = spec.ravel(training_tree_from_numpy(
        jax.device_get(want.state["x"]), "cpu"))
    assert float((x - wx).norm() / wx.norm()) <= 1e-5
    flat = run_rounds(algo, state, batch, rounds)
    _assert_bitwise(got, flat, "tinyllama")
