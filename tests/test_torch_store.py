"""The port's client stores (mirrors tests/test_store.py).

`run_rounds(store="active")` runs each round on the packed (capacity, N)
tile of its participants (`utils.pytree.ActiveSet`), gathered from the
resident (m, N) buffers and scattered back; `store="offload"` keeps
those buffers in host memory and moves the tiles each round. Within the
port:

  * the STATE of an active run is bitwise the dense store's under the
    same masks, for all five algorithms, in the chunked driver and the
    legacy loop, under every policy; so are `selected`, `cr` and
    `local_grad_evals`, while `f_xbar` and `grad_sq_norm` become
    participant means by design (FedGiA's whole history stays bitwise:
    its active round is its dense round);
  * an offload run is bitwise the active run, history included, with or
    without `aggregate="packed"`, which holds to the dense layout at
    rtol 1e-5.

Against the reference: the row store's packing, gather, scatter and host
store on the same masks, bit for bit; and whole runs under
`store="active"` with the reference's own uniform masks replayed on both
sides through `AvailabilityParticipation` (ROADMAP queue 3 item a), every
round at rtol 1e-5.

Not mirrored (their engine paths are not ported): the async, clocked,
error-feedback, sharded, HLO and debug-tail tests, and the reference's
red `test_packed_sharded_one_all_reduce`.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core import selection as jax_selection
from repro.data import linreg_noniid
from repro.launch import train as jax_train
from repro.models import LeastSquares as JaxLeastSquares
from repro.utils import pytree as jax_pt
from repro_torch.config import FedConfig
from repro_torch.core import fedgia as fedgia_mod
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import flatten_state, run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import (
    AvailabilityParticipation,
    make_policy,
)
from repro_torch.data import to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares
from repro_torch.utils import pytree as pt

M, N, D = 8, 20, 400
ROUNDS = 10
RTOL, ATOL = 1e-5, 1e-6

# tests/test_store.py's set-ups
ALGO_SETUPS = {
    "fedgia": dict(sigma_t=0.2, h_policy="diag_ema", alpha=0.5),
    "fedavg": dict(lr=0.01),
    "fedprox": dict(lr=0.002, prox_mu=1e-4, inner_steps=3),
    "fedpd": dict(lr=0.05, fedpd_eta=1.0, inner_steps=3),
    "scaffold": dict(lr=0.01),
}
FIVE = sorted(ALGO_SETUPS)
POLICIES = ("uniform", "weighted", "cyclic", "straggler", "periodic")
# the metrics that are bitwise between stores for every algorithm
COMPARABLE = ("selected", "cr", "local_grad_evals")

MASKS = [
    [0, 1, 0, 1, 1, 0, 0, 1],  # row m-1 selected, two padding rows
    [1, 0, 0, 0, 0, 0, 0, 0],  # one participant, five padding rows
    [1, 1, 1, 1, 1, 1, 1, 1],  # every client, no padding
    [0, 0, 0, 0, 0, 0, 1, 1],  # the last two rows
]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the problems are tiny, and the suite's other
    workers need the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def raw():
    return linreg_noniid(0, D, N, M)


def _make(raw, key, **overrides):
    model = LeastSquares(N)
    kwargs = dict(algorithm=key, num_clients=M, k0=3)
    kwargs.update(ALGO_SETUPS[key])
    kwargs.update(overrides)
    fed = FedConfig(**kwargs)
    algo = make_algorithm(fed, model.loss, model=model)
    batch = to_torch(raw, "cpu")
    state = algo.init(model.init("cpu"), prng_key(1), init_batch=batch)
    return algo, state, batch


def _policy(kind):
    return make_policy(kind, M, 0.5, seed=3, drop_prob=0.3, horizon=ROUNDS)


def _leaves(state):
    for k, v in sorted(state.items()):
        if isinstance(v, dict):
            for leaf in sorted(v):
                yield f"{k}.{leaf}", v[leaf]


def _assert_state_bitwise(res, ref, what):
    assert res.rounds_run == ref.rounds_run, what
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        assert torch.equal(a, b), f"{what}: state[{k}]"


def _assert_store_equiv(res, ref, algo, what):
    """Active (res) against dense (ref): bitwise state and comparable
    metrics; the whole history for a population-tile algorithm."""
    _assert_state_bitwise(res, ref, what)
    assert set(res.history) == set(ref.history), what
    full = algo.active_tile == "population"
    for k in ref.history:
        if full or k in COMPARABLE:
            np.testing.assert_array_equal(res.history[k], ref.history[k],
                                          err_msg=f"{what}/{k}")


def _assert_offload_equiv(res, ref, what):
    """Offload (res) against active (ref): bitwise state and history."""
    _assert_state_bitwise(res, ref, what)
    assert res.stopped_early == ref.stopped_early, what
    assert set(res.history) == set(ref.history), what
    for k in ref.history:
        np.testing.assert_array_equal(res.history[k], ref.history[k],
                                      err_msg=f"{what}/{k}")


# ------------------------------------------- the row store vs the reference
@pytest.mark.parametrize("bits", MASKS)
@pytest.mark.parametrize("capacity", [6, 8])
def test_make_active_set_matches_reference(bits, capacity):
    if sum(bits) > capacity:
        capacity = M
    want = jax_pt.make_active_set(jnp.asarray(bits, bool), capacity)
    got = pt.make_active_set(torch.tensor(bits, dtype=torch.bool), capacity)
    np.testing.assert_array_equal(got.idx.numpy(), np.asarray(want.idx))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.count.dtype == torch.float32
    assert float(got.count) == float(want.count)
    assert got.capacity == want.capacity and got.num_clients == M
    # the slots: the participants, then distinct non-participant rows
    slots = got.slots.numpy()
    assert len(set(slots)) == capacity and slots.max() < M
    np.testing.assert_array_equal(slots[got.valid.numpy()],
                                  np.flatnonzero(bits))
    assert not np.asarray(bits, bool)[slots[~got.valid.numpy()]].any()


def test_make_active_set_rejects_overflow():
    with pytest.raises(ValueError, match="more than the tile's capacity"):
        pt.make_active_set(torch.ones(M, dtype=torch.bool), 4)


@pytest.mark.parametrize("bits", MASKS)
def test_gather_scatter_match_reference(bits):
    """Gather (clip reads) and scatter (padding writes dropped, row m-1
    kept where it is selected) bit for bit against the reference's
    `gather_rows` / `scatter_rows`, and `zero_invalid`."""
    rng = np.random.default_rng(7)
    buf = rng.standard_normal((M, 5)).astype(np.float32)
    tile = rng.standard_normal((6 if sum(bits) <= 6 else M, 5)).astype(
        np.float32)
    cap = tile.shape[0]
    want = jax_pt.make_active_set(jnp.asarray(bits, bool), cap)
    got = pt.make_active_set(torch.tensor(bits, dtype=torch.bool), cap)
    np.testing.assert_array_equal(
        got.gather(torch.from_numpy(buf)).numpy(),
        np.asarray(jax_pt.gather_rows(jnp.asarray(buf), want.idx)))
    t_buf = torch.from_numpy(buf.copy())
    out = got.scatter(t_buf, torch.from_numpy(tile))
    assert out is t_buf  # in place
    np.testing.assert_array_equal(
        out.numpy(), np.asarray(jax_pt.scatter_rows(
            jnp.asarray(buf), want.idx, jnp.asarray(tile))))
    np.testing.assert_array_equal(
        got.zero_invalid(torch.from_numpy(tile)).numpy(),
        np.asarray(want.zero_invalid(jnp.asarray(tile))))


def test_tile_state_accessors_are_identity():
    """tile_state=True: gather_state/scatter_state pass the gathered
    tiles through; gather keeps the resident row meaning."""
    aset = pt.make_active_set(torch.tensor([0, 1, 0, 1], dtype=torch.bool),
                              2, tile_state=True)
    tile = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    assert aset.gather_state(tile) is tile
    new = tile * 2
    assert aset.scatter_state(tile, new) is new
    assert aset.gather_tree({"A": tile})["A"] is tile
    dense = torch.arange(4, dtype=torch.float32)
    assert aset.gather(dense).tolist() == [1.0, 3.0]
    rset = pt.make_active_set(aset.mask, 2)
    buf = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    assert torch.equal(rset.gather_state(buf), rset.gather(buf))


def test_offload_store_roundtrip_matches_reference():
    """OffloadStore's gather and scatter against the reference's, bit for
    bit: a plain CPU copy here (pinned on the card), with the sentinel
    row dropped."""
    buf = np.arange(20, dtype=np.float32).reshape(5, 4)
    mask = [0, 1, 0, 1, 0]
    want_set = jax_pt.make_active_set(jnp.asarray(mask, bool), 3)
    jstore = jax_pt.OffloadStore({"z": jnp.asarray(buf)})
    jtiles = jstore.gather_tiles(want_set.idx)
    jstore.scatter_tiles(want_set.idx, {"z": jtiles["z"] * -1.0})

    src = torch.from_numpy(buf.copy())
    store = pt.OffloadStore({"z": src}, pinned=False)
    assert store.buffers["z"].data_ptr() != src.data_ptr()
    assert not store.buffers["z"].is_pinned()
    aset = pt.make_active_set(torch.tensor(mask, dtype=torch.bool), 3)
    tiles = store.gather_tiles(aset)
    np.testing.assert_array_equal(tiles["z"].numpy(),
                                  np.asarray(jtiles["z"]))
    out = {"z": torch.empty_like(tiles["z"])}
    assert store.gather_tiles(aset, out=out)["z"] is out["z"]
    assert torch.equal(out["z"], tiles["z"])
    store.scatter_tiles(aset, {"z": tiles["z"] * -1.0})
    np.testing.assert_array_equal(store.buffers["z"].numpy(),
                                  np.asarray(jstore.buffers["z"]))
    assert store.nbytes == buf.nbytes == jstore.nbytes
    np.testing.assert_array_equal(src.numpy(), buf)  # the source untouched


@pytest.mark.parametrize("kind", POLICIES)
def test_policy_capacity_and_indices_match_reference(kind):
    """`active_capacity` as the reference's policy gives it, and
    `indices()` is the packed form of the same round's `mask()`."""
    jpol = jax_selection.make_policy(kind, M, 0.5, seed=3, drop_prob=0.3,
                                     horizon=ROUNDS)
    pol = _policy(kind)
    assert pol.active_capacity == jpol.active_capacity
    ps = pol.init()
    for t in range(3):
        aset, ps_next = pol.indices(ps, t)
        mask, ps_mask = pol.mask(ps, t)
        assert aset.capacity == pol.active_capacity
        assert torch.equal(aset.mask, mask)
        assert torch.equal(aset.idx[aset.valid], torch.nonzero(mask)[:, 0])
        if torch.is_tensor(ps_next):
            assert torch.equal(ps_next, ps_mask)
        ps = ps_next
    if kind in ("uniform", "weighted", "cyclic"):
        assert bool(aset.valid.all())  # a fixed count fills the tile


# ------------------------------------------------ active == dense, bitwise
@pytest.mark.parametrize("kind", POLICIES)
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
@pytest.mark.parametrize("algo_key", FIVE)
def test_active_matches_dense(raw, algo_key, scan, kind):
    algo, state, batch = _make(raw, algo_key)
    kw = dict(scan=scan, chunk_size=4)
    ref = run_rounds(algo, state, batch, ROUNDS, participation=_policy(kind),
                     **kw)
    res = run_rounds(algo, state, batch, ROUNDS, participation=_policy(kind),
                     store="active", **kw)
    _assert_store_equiv(res, ref, algo, f"{algo_key}/{kind}")
    assert res.extras == {} and ref.extras == {}
    if kind == "uniform":
        assert np.array_equal(res.policy_state["key"],
                              ref.policy_state["key"])


def test_active_reports_participant_means(raw):
    """The baselines' f and |grad|^2 are the participants' under the
    active store: round 0 of FedAvg from x̄ = 0 is the mean of the
    participants' own losses at 0."""
    algo, state, batch = _make(raw, "fedavg")
    pol = _policy("cyclic")  # round 0: clients 0..3
    res = run_rounds(algo, state, batch, 1, participation=pol,
                     store="active")
    losses, _ = algo._vg_stacked(
        {"x": torch.zeros((M, N))}, batch)
    np.testing.assert_allclose(res.history["f_xbar"][0],
                               float(losses[:M // 2].mean()), rtol=1e-6)


@pytest.mark.parametrize("store", ["active", "offload"])
def test_fedgia_updates_once_a_round(raw, monkeypatch, store):
    """FedGiA's active round is its dense round: one fused update a round
    under either store (its plain version on the CPU, a launch of the
    kernel on the card), the undonated form under diag_ema."""
    algo, state, batch = _make(raw, "fedgia")
    calls = []
    real = fedgia_mod.fedgia_update_flat

    def spy(*args, **kwargs):
        calls.append(kwargs["donate"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fedgia_mod, "fedgia_update_flat", spy)
    run_rounds(algo, state, batch, ROUNDS, scan=False,
               participation=_policy("uniform"), store=store)
    assert calls == [False] * ROUNDS


def test_active_chunk_auto_matches_fixed(raw):
    """`chunk_size="auto"` composes with the active store: bitwise the
    fixed-chunk active run."""
    algo, state, batch = _make(raw, "fedavg")
    ref = run_rounds(algo, state, batch, 60, chunk_size=7,
                     participation=_policy("uniform"), store="active")
    res = run_rounds(algo, state, batch, 60, chunk_size="auto",
                     participation=_policy("uniform"), store="active")
    assert res.rounds_run == ref.rounds_run == 60
    _assert_offload_equiv(res, ref, "auto")


def test_active_early_stop_chunked_matches_legacy(raw):
    """The eq. (35) stop gates on the PARTICIPANT gradient norm under the
    active store; the chunked driver and the legacy loop stop at the same
    round with the same state and policy state."""
    algo, state, batch = _make(raw, "fedgia", k0=5)
    kw = dict(tol=1e-9, store="active")
    ref = run_rounds(algo, state, batch, 300, scan=False,
                     participation=_policy("uniform"), **kw)
    res = run_rounds(algo, state, batch, 300, chunk_size=13,
                     participation=_policy("uniform"), **kw)
    assert ref.stopped_early and res.stopped_early
    assert res.rounds_run % 13 != 0
    _assert_offload_equiv(res, ref, "early stop")
    assert np.array_equal(res.policy_state["key"],
                          ref.policy_state["key"])


def test_round_flat_active_keeps_zero_tail(raw):
    """After active rounds every resident flat buffer of SCAFFOLD still
    has an exactly zero lane-padding tail."""
    algo, state, batch = _make(raw, "scaffold")
    res = run_rounds(algo, state, batch, ROUNDS, store="active",
                     participation=_policy("uniform"))
    spec = pt.ravel_spec(state["x"])
    flat = flatten_state(algo, res.state, spec)
    assert spec.padded_size > spec.size
    for k in ("x", "c"):
        assert float(flat[k][spec.size:].abs().max()) == 0.0, k
    assert float(flat["ci"][:, spec.size:].abs().max()) == 0.0


# ------------------------------------------------ offload == active, bitwise
@pytest.mark.parametrize("scan", [True, False], ids=["chunked", "legacy"])
@pytest.mark.parametrize("algo_key", FIVE)
def test_offload_matches_active(raw, algo_key, scan):
    """The host-resident tiles replay the active store bit for bit (the
    offload loop is the same whatever `scan` says; the active run takes
    either driver). FedGiA's population tile moves the whole buffers."""
    algo, state, batch = _make(raw, algo_key)
    ref = run_rounds(algo, state, batch, ROUNDS, scan=scan,
                     participation=_policy("uniform"), store="active")
    res = run_rounds(algo, state, batch, ROUNDS, scan=scan,
                     participation=_policy("uniform"), store="offload")
    _assert_offload_equiv(res, ref, algo_key)
    assert np.array_equal(res.policy_state["key"],
                          ref.policy_state["key"])
    for k in algo.flat_client_keys:  # handed back on the run's device
        if k in res.state:  # "ef" and "fault_prev" only where made
            assert not res.state[k]["x"].is_pinned()


def test_offload_packed_matches_active_packed(raw):
    """Offload and packed compose: offload + packed is bitwise active +
    packed."""
    algo, state, batch = _make(raw, "scaffold")
    ref = run_rounds(algo, state, batch, ROUNDS, store="active",
                     aggregate="packed", participation=_policy("uniform"))
    res = run_rounds(algo, state, batch, ROUNDS, store="offload",
                     aggregate="packed", participation=_policy("uniform"))
    _assert_offload_equiv(res, ref, "packed")


def test_offload_early_stop_matches_active(raw):
    algo, state, batch = _make(raw, "fedgia", k0=5)
    kw = dict(tol=1e-9)
    ref = run_rounds(algo, state, batch, 300, scan=False, store="active",
                     participation=_policy("uniform"), **kw)
    res = run_rounds(algo, state, batch, 300, store="offload",
                     participation=_policy("uniform"), **kw)
    assert ref.stopped_early and res.stopped_early
    _assert_offload_equiv(res, ref, "early stop")
    assert np.array_equal(res.policy_state["key"],
                          ref.policy_state["key"])


def test_offload_reports_memory_extras(raw):
    """RoundResult.extras carries the offload footprint: the host-resident
    bytes (FedPD's (m, N) duals and the batch) and, on the CPU, no device
    peak; the dense and active stores report none."""
    algo, state, batch = _make(raw, "fedpd")
    res = run_rounds(algo, state, batch, 3, store="offload",
                     participation=_policy("uniform"))
    spec = pt.ravel_spec(state["x"])
    lam = M * spec.padded_size * 4
    data = sum(v.numel() * v.element_size() for v in batch.values())
    assert res.extras["host_resident_bytes"] == lam + data
    assert res.extras["device_peak_bytes"] is None
    assert res.extras["copy_s"] >= 0.0
    ref = run_rounds(algo, state, batch, 3, store="active",
                     participation=_policy("uniform"))
    assert ref.extras == {}


# ------------------------------------------------------ packed at fp tol
@pytest.mark.parametrize("algo_key", ["fedavg", "scaffold"])
def test_packed_matches_dense_fp(raw, algo_key):
    """aggregate="packed" sums the tile directly: rtol 1e-5 against the
    bitwise dense layout. SCAFFOLD exercises the extra_mean rider."""
    algo, state, batch = _make(raw, algo_key)
    ref = run_rounds(algo, state, batch, ROUNDS, store="active",
                     participation=_policy("uniform"))
    res = run_rounds(algo, state, batch, ROUNDS, store="active",
                     aggregate="packed", participation=_policy("uniform"))
    assert res.rounds_run == ref.rounds_run
    for (k, a), (_, b) in zip(_leaves(res.state), _leaves(ref.state)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(res.history["f_xbar"],
                               ref.history["f_xbar"], rtol=1e-5)


# ------------------------------------------------------------ validation
def test_store_validation(raw):
    algo, state, batch = _make(raw, "fedavg")
    pol = _policy("uniform")
    with pytest.raises(ValueError, match="unknown store"):
        run_rounds(algo, state, batch, 2, store="sparse", participation=pol)
    for store in ("active", "offload"):
        with pytest.raises(ValueError, match="participant"):
            run_rounds(algo, state, batch, 2, store=store)
    with pytest.raises(ValueError, match="no chunks"):
        run_rounds(algo, state, batch, 2, store="offload",
                   participation=pol, chunk_size="auto")
    with pytest.raises(ValueError, match="unknown aggregate"):
        run_rounds(algo, state, batch, 2, store="active",
                   participation=pol, aggregate="sparse")
    with pytest.raises(ValueError, match="packed"):
        run_rounds(algo, state, batch, 2, store="dense",
                   participation=pol, aggregate="packed")


SMALL = ["--clients", "8", "--dim", "20", "--samples", "400", "--rounds",
         "3"]


@pytest.mark.parametrize("argv,message", [
    (["--store", "active"], "needs a per-round participant set"),
    (["--store", "offload"], "needs a per-round participant set"),
    (["--store", "offload", "--participation", "uniform", "--chunk",
      "auto"], "has no chunks"),
    (["--aggregate", "packed", "--participation", "uniform"],
     "--aggregate packed sums the packed participant tile"),
])
def test_cli_store_errors_are_the_references(argv, message):
    with pytest.raises(SystemExit, match=message):
        train_mod.main(SMALL + ["--device", "cpu"] + argv)
    with pytest.raises(SystemExit, match=message):
        jax_train.validate_flags(jax_train.build_parser().parse_args(
            SMALL + argv))


@pytest.mark.parametrize("store,aggregate", [
    ("active", "dense"), ("offload", "dense"), ("offload", "packed")])
def test_cli_store_flags_reach_the_engine(store, aggregate):
    """`--store` and `--aggregate` reach `run_rounds`; the state is the
    dense run's under the same masks."""
    argv = SMALL + ["--device", "cpu", "--algo", "scaffold", "--tol", "0",
                    "--participation", "uniform", "--alpha", "0.25"]
    ref = train_mod.main(argv)
    got = train_mod.main(argv + ["--store", store, "--aggregate", aggregate])
    assert got["store"] == store and got["aggregate"] == aggregate
    assert got["rounds"] == ref["rounds"] == 3
    assert ("host_resident_bytes" in got["extras"]) == (store == "offload")
    for (k, a), (_, b) in zip(_leaves(got["state"]), _leaves(ref["state"])):
        if aggregate == "dense":
            assert torch.equal(a, b), k
        else:
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


# ----------------------------------------------- against the reference
@pytest.fixture(scope="module")
def reference_trace():
    """The reference's UniformParticipation(M, 0.5, seed=2) masks of
    ROUNDS rounds, drawn in JAX, as a (ROUNDS, M) trace."""
    pol = jax_selection.UniformParticipation(M, 0.5, seed=2)
    ps, rows = pol.init(), []
    for r in range(ROUNDS):
        mask, ps = pol.mask(ps, jnp.int32(r))
        rows.append(np.asarray(mask))
    return np.stack(rows)


@pytest.mark.parametrize("algo_key", FIVE)
def test_reference_parity_active(raw, reference_trace, algo_key):
    """Both packages under `store="active"` and
    AvailabilityParticipation(M, reference trace) (capacity m: four
    participants and four padding rows a round): every round's
    participant-mean f_xbar and grad_sq_norm, `selected`, and the final
    state at rtol 1e-5."""
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel = JaxLeastSquares(N)
    jalgo = jax_make_algorithm(
        JaxFedConfig(algorithm=algo_key, num_clients=M, k0=3,
                     **ALGO_SETUPS[algo_key]), jmodel.loss, model=jmodel)
    jstate = jalgo.init(jmodel.init(jax.random.PRNGKey(0)),
                        jax.random.PRNGKey(1), init_batch=jb)
    want = jax_run_rounds(
        jalgo, jstate, jb, ROUNDS, store="active",
        participation=jax_selection.AvailabilityParticipation(
            M, reference_trace))
    algo, state, batch = _make(raw, algo_key)
    got = run_rounds(algo, state, batch, ROUNDS, store="active",
                     participation=AvailabilityParticipation(
                         M, reference_trace))
    assert got.rounds_run == want.rounds_run == ROUNDS
    np.testing.assert_array_equal(got.history["selected"], 4.0)
    for k in ("f_xbar", "grad_sq_norm", "selected", "cr"):
        np.testing.assert_allclose(got.history[k], want.history[k],
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{algo_key}/{k}")
    for key, leaf in _leaves(got.state):
        k = key.split(".")[0]
        np.testing.assert_allclose(
            leaf.numpy(), np.asarray(want.state[k]["x"]), rtol=RTOL,
            atol=ATOL, err_msg=f"{algo_key}: state[{key}]")


def test_engine_bench_rows_run_small():
    """The port's million-client rows at a small m on the CPU: every round
    runs with |C| = alpha·m participants, f stays finite, and the offload
    row reports its host-resident bytes (the card's device peak is None
    here)."""
    from repro_torch.benchmarks import engine_bench

    rows = engine_bench.main(["--device", "cpu", "--clients", "30000",
                              "--rounds", "2"])
    for row in rows.values():
        assert row["participants_per_round"] == 3 and row["rounds"] == 2
        assert row["device"] == "cpu" and np.isfinite(row["f_xbar"]).all()
    off = rows["offload_1m"]
    assert off["peak_device_bytes"] is None
    assert off["dense_resident_bytes"] == 30000 * 128 * 4
    assert off["host_resident_bytes"] > off["dense_resident_bytes"]
