"""The sharded and overlapped active store, uplink codecs, faults and
screening on the port (mirrors tests/test_store.py::
test_active_sharded_one_all_reduce_and_parity, tests/test_compress.py::
test_compressed_sharded_one_all_reduce_and_parity, tests/test_faults.py::
test_sharded_screening_keeps_one_collective and the active and int8
columns of tests/test_overlap.py::test_overlap_matrix_collective_budget).

On 8 gloo ranks, against the reference's runs on 8 fake devices
(`torch_sharded.run_both`, once for the file), counting collectives from
`torch.profiler`'s c10d events (on gloo a reduce-scatter runs as a
whole-buffer all-reduce underneath, so only counts by kind compare):

  * a sharded active round, an int8 + EF round and a faults + screening
    round issue ONE model-size all-reduce, at most one reduce-scatter and
    no all-gather, for all five algorithms; the overlapped FedGiA round
    with faults and screening zero model-size all-reduces, one
    reduce-scatter and one all-gather;
  * the overlap matrix's 30 variants beyond tests/test_torch_overlap.py's
    10 (five algorithms × sync / async × dense / active × none / int8,
    less dense and uncompressed): zero model-size all-reduces, one
    reduce-scatter, one all-gather;
  * SCAFFOLD's sharded active run matches the unsharded active run and
    the reference's sharded active run (rtol 1e-4, atol 1e-6); FedGiA's
    int8 + EF run sharded matches unsharded (rtol 1e-4, atol 1e-6);
  * a rank's decoded rows of `compress_upload` (stochastic int8, bf16)
    and of `compress_upload_active`'s tile, and the rows a fault hits,
    are bitwise the unsharded ones at the same GLOBAL row ids; the
    sharded faults run's `screened` history is the unsharded one's.

In one process, with no ranks: `overlap="scatter"` with the active store
is the active barrier run bit for bit, and with int8 + EF + faults +
screening the uplink runs at the round's end as the reference's does;
both are held to the reference's unsharded overlapped runs (rtol 1e-4,
atol 1e-6).

The CLI: rank 0's `done:` line of `--shard-clients 4 --store active` and
of `--shard-clients 4 --overlap scatter --compression int8
--error-feedback --faults crash,nan --screening` against the unsharded
CLI's; the refusals that stay keep the reference's messages.
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from conftest import SRC
from repro_torch.config import FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.engine import run_rounds
from repro_torch.core.faults import Screening, make_faults
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import make_policy
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import train as train_mod
from repro_torch.models import LeastSquares
from torch_sharded import assert_run_close, counts, run_both

FIVE = ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold")
TOL = dict(rtol=1e-4, atol=1e-6)
# the residual `ef` = u - C(u) cancels the upload u and keeps its ulps:
# held at this times max|x̄| (tests/test_torch_compress.py's rule)
EF_ATOL = 1e-4
M, N, D = 8, 24, 320
ROUNDS = 10
# the reference's settings of its sharded active, codec and fault scripts
HP = dict(k0=3, alpha=0.5, sigma_t=0.3, h_policy="diag_ema", lr=0.01)

_JAX = '''
from repro.core import Screening, make_faults
mesh8 = make_host_mesh(data=8)
hp = dict(k0=3, alpha=0.5, sigma_t=0.3, h_policy="diag_ema", lr=0.01)
algo, s0, batch = setup("scaffold", k0=3, lr=0.01)
put("act_scaffold", run_rounds(
    algo, s0, batch, 10, mesh=mesh8, store="active",
    participation=make_policy("uniform", 8, 0.5, seed=3)))
for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
    algo, s0, batch = setup(name, **hp)
    put("ovl_active_" + name, run_rounds(
        algo, s0, batch, 10, overlap="scatter", store="active",
        participation=make_policy("uniform", 8, 0.5, seed=3)))
    put("ovl_uplink_" + name, run_rounds(
        algo, s0, batch, 10, overlap="scatter", compression="int8",
        error_feedback=True, screening=Screening(clip_norm=100.0),
        faults=make_faults(["crash", "nan"], [0.1], num_clients=8, seed=1)))
'''

_PORT = '''
from repro_torch.core import compress, prng
from repro_torch.core.faults import Screening, make_faults

HP = dict(k0=3, alpha=0.5, sigma_t=0.3, h_policy="diag_ema", lr=0.01)


def hard():
    return dict(faults=make_faults(["crash", "nan"], [0.1], num_clients=8,
                                   seed=1),
                screening=Screening(clip_norm=100.0))


def round_call(mesh, name, hp=HP, overlap="off", stale=False, ef=False,
               **kw):
    """One sharded round as a call, the (8,) mask all True, and the
    padded model size."""
    algo, s0, batch = setup(name, **hp)
    spec = pt.ravel_spec(s0["x"])
    s0f = flatten_state(algo, s0, spec)
    if ef:
        s0f["ef"] = torch.zeros((8, spec.padded_size))
    if overlap == "scatter":
        rows = int(getattr(algo, "overlap_slot_rows", 1))
        s0f["ovl_shard"] = torch.zeros((rows, spec.padded_size))
    rf = make_round_fn(algo, mesh, masked=True, stale=stale, flat_spec=spec,
                       overlap=overlap, **kw)
    st, b = shard_inputs(algo, s0f, batch, mesh)
    args = (st, b, torch.ones(8, dtype=torch.bool))
    if stale:
        args = args + (api.init_stale_xbar(s0f["x"], 1, 2),)
    return (lambda: rf(*args)), spec.padded_size


def budgets(OUT, calls):
    """The collectives of each call of `calls` ({key: round_call}), all
    in ONE profiler session (a session costs ~1.4 s a rank here): each
    call in a range of its own, and its events those that start inside
    the range, counted by `mesh.collective_counts`. The session's raw
    events are read as they are (building `prof.events()`' tree took
    15 s a rank for these 46 rounds): a c10d all-reduce's size is then
    its backend event's, the first one after it in time."""
    from types import SimpleNamespace as NS
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        for key, (fn, _) in calls.items():
            with record_function("budget::" + key):
                fn()
    # the ranges, the collectives and the backends' events, by start
    evs = sorted((NS(name=e.name(), input_shapes=e.shapes(), cpu_children=[],
                     time_range=NS(start=e.start_ns(), end=e.end_ns()))
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith(("budget::", "c10d::", "gloo:",
                                          "nccl:"))),
                 key=lambda e: e.time_range.start)
    for key, (_, n_model) in calls.items():
        mark = [e for e in evs if e.name == "budget::" + key][0]
        lo, hi = mark.time_range.start, mark.time_range.end
        c = mesh_mod.collective_counts(
            [e for e in evs if lo <= e.time_range.start <= hi], n_model)
        OUT[key] = np.array([c[k] for k in KINDS])


def every_rank(flag):
    """Whether `flag` holds on every rank (all ranks call)."""
    t = torch.tensor([float(bool(flag))])
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return np.array(bool(t.item()))


def rows_of(whole, ax, m_local):
    return whole[ax.index * m_local:(ax.index + 1) * m_local]


def rank_fn(OUT):
    mesh8 = mesh_mod.make_host_mesh(data=8)
    ax = mesh8.client_axis("data")
    cap = make_policy("uniform", 8, 0.5).active_capacity
    int8_ef = compress.make_compressor("int8", error_feedback=True)
    calls = {}
    for name in ("fedgia", "fedavg", "fedprox", "fedpd", "scaffold"):
        calls["budget/active/" + name] = round_call(
            mesh8, name, active_capacity=cap)
        calls["budget/int8ef/" + name] = round_call(
            mesh8, name, hp=dict(HP, alpha=1.0), ef=True,
            compressor=int8_ef)
        calls["budget/faults/" + name] = round_call(mesh8, name, **hard())
        for stale in (False, True):
            for active in (False, True):
                for codec in (None, "int8"):
                    if not active and codec is None:
                        continue  # tests/test_torch_overlap.py's ten
                    kw = {}
                    if active:
                        kw["active_capacity"] = cap
                    if codec:
                        kw["compressor"] = compress.make_compressor(codec)
                    calls["matrix/%s/%s/%s/%s" % (name, stale, active,
                                                  codec)] = round_call(
                        mesh8, name, hp=dict(HP, alpha=1.0),
                        overlap="scatter", stale=stale, **kw)
    calls["budget/faults_overlap"] = round_call(mesh8, "fedgia",
                                                overlap="scatter", **hard())
    budgets(OUT, calls)

    # SCAFFOLD's active run, sharded and not (uniform 0.5, 10 rounds)
    algo, s0, batch = setup("scaffold", k0=3, lr=0.01)
    for tag, mesh in (("act_scaffold", mesh8), ("act_scaffold_1", None)):
        res = run_rounds(algo, s0, batch, 10, mesh=mesh, store="active",
                         participation=make_policy("uniform", 8, 0.5,
                                                   seed=3))
        put(OUT, tag, res)
        if mesh is not None:
            replicated(OUT, tag, res)
    # FedGiA int8 + EF, sharded and not (alpha 1, 10 rounds)
    algo, s0, batch = setup("fedgia", k0=3, alpha=1.0, sigma_t=0.3,
                            h_policy="diag_ema")
    for tag, mesh in (("int8", mesh8), ("int8_1", None)):
        put(OUT, tag, run_rounds(algo, s0, batch, 10, mesh=mesh,
                                 compression="int8", error_feedback=True))
    # faults + screening, sharded and not, barrier and overlapped
    algo, s0, batch = setup("fedgia", **HP)
    for ov in ("off", "scatter"):
        for tag, mesh in (("faults_" + ov, mesh8), ("faults1_" + ov, None)):
            put(OUT, tag, run_rounds(algo, s0, batch, 10, mesh=mesh,
                                     overlap=ov, **hard()))

    # decoded rows and fault hits by GLOBAL row id (m = 32, 4 rows a rank)
    m, m_local = 32, 4
    spec = pt.ravel_spec({"x": torch.zeros(300)})
    u = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (m, spec.padded_size)).astype(np.float32))
    key = prng.key_t(compress.round_key(prng_key(1), 3), "cpu")
    mask = torch.from_numpy(np.random.default_rng(1).random(m) < 0.5)
    for codec in ("int8", "bf16"):
        comp = compress.make_compressor(codec)
        whole = api.compress_upload(comp, u, None, spec, key=key)[0]
        with api.client_sharding(ax):
            loc = api.compress_upload(comp, rows_of(u, ax, m_local), None,
                                      spec, key=key)[0]
            aset = pt.make_active_set(rows_of(mask, ax, m_local), m_local)
            tile = api.compress_upload_active(
                comp, aset.gather(rows_of(u, ax, m_local)), None, aset,
                spec, key=key)[0]
        ids = aset.idx[aset.valid]
        OUT["decode/" + codec] = every_rank(
            torch.equal(loc, rows_of(whole, ax, m_local))
            and torch.equal(tile[aset.valid],
                            whole[ids + ax.index * m_local]))
    fm = make_faults(["crash", "nan"], [0.3], num_clients=m, seed=1)
    same = True
    for r in range(10):
        up, ok, _, n_ok = api.harden_upload(u, None, spec, faults=fm,
                                            round_idx=r)
        with api.client_sharding(ax):
            up_s, ok_s, _, n_s = api.harden_upload(
                rows_of(u, ax, m_local), None, spec, faults=fm,
                round_idx=r)
        same = same and torch.equal(ok_s, rows_of(ok, ax, m_local)) \\
            and torch.equal(torch.isnan(up_s),
                            rows_of(torch.isnan(up), ax, m_local)) \\
            and float(n_s) == float(n_ok)
    OUT["fault_hits"] = every_rank(same)
'''


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_both(str(tmp_path_factory.mktemp("uplink")), _JAX, _PORT,
                    world=8)


def _assert_barrier_budget(c):
    assert c["all_reduce_model"] == 1, c
    assert c["reduce_scatter"] <= 1 and c["all_gather"] == 0, c


def _assert_overlap_budget(c):
    assert c["all_reduce_model"] == 0, c
    assert c["reduce_scatter"] == c["reduce_scatter_model"] == 1, c
    assert c["all_gather"] == c["all_gather_model"] == 1, c


# ------------------------------------------------------- on 8 gloo ranks
@pytest.mark.parametrize("stage", ["active", "int8ef", "faults"])
@pytest.mark.parametrize("name", FIVE)
def test_sharded_round_keeps_one_all_reduce(runs, name, stage):
    """A sharded active round (each shard's tile packed from its rows),
    an int8 + EF round and a faults + screening round: one model-size
    all-reduce (the screened count and the participant count ride as
    scalars), at most one reduce-scatter, no all-gather."""
    _assert_barrier_budget(counts(runs[1][f"budget/{stage}/{name}"]))


def test_sharded_overlap_faults_budget(runs):
    """The overlapped FedGiA round with faults and screening at its end:
    zero model-size all-reduces, one reduce-scatter, one all-gather."""
    _assert_overlap_budget(counts(runs[1]["budget/faults_overlap"]))


# the matrix's variants but the dense uncompressed ones, which
# tests/test_torch_overlap.py holds
MATRIX = [(name, stale, active, codec) for name in FIVE
          for stale in (False, True) for active in (False, True)
          for codec in (None, "int8") if active or codec]


@pytest.mark.parametrize("name,stale,active,codec", MATRIX)
def test_overlap_matrix_active_and_int8(runs, name, stale, active, codec):
    """The overlap matrix beyond the dense uncompressed column: the
    overlapped sharded round keeps zero model-size all-reduces, one
    reduce-scatter and one all-gather under the active store and int8."""
    _assert_overlap_budget(counts(
        runs[1][f"matrix/{name}/{stale}/{active}/{codec}"]))


def test_active_sharded_matches_unsharded_and_reference(runs):
    """SCAFFOLD under uniform 0.5, store="active", 10 rounds on data=8:
    the unsharded active run's history and state, and the reference's
    sharded active run's, at rtol 1e-4, atol 1e-6; x̄ and the history
    bitwise alike on every rank."""
    ref, port = runs
    one = {k.replace("act_scaffold_1/", "act_scaffold/"): v
           for k, v in port.items() if k.startswith("act_scaffold_1/")}
    assert_run_close(port, one, "act_scaffold", **TOL)
    assert_run_close(port, ref, "act_scaffold", **TOL)
    assert bool(port["act_scaffold/replicated"])


def test_int8_sharded_matches_unsharded(runs):
    """FedGiA (diag_ema, alpha 1, sigma_t 0.3) with int8 + EF on data=8
    against the unsharded run, the history and x, z, π, h at rtol 1e-4,
    atol 1e-6, the residual at `_assert_ef_close`'s rule: each client's
    stochastic rounding keys on its global row id, so the runs part only
    by the reassociated sums."""
    port = runs[1]
    one = {k.replace("int8_1/", "int8/"): v for k, v in port.items()
           if k.startswith("int8_1/")}
    assert_run_close(port, one, "int8", state_keys=("x", "z", "pi", "h"),
                     **TOL)
    _assert_ef_close(port, one, "int8")


@pytest.mark.parametrize("codec", ["int8", "bf16"])
def test_decoded_rows_bitwise_by_global_id(runs, codec):
    """Every rank's decode of its rows, and of its packed active tile,
    is bitwise the unsharded decode's rows at the same global ids."""
    assert bool(runs[1][f"decode/{codec}"])


def test_fault_hits_bitwise_by_global_id(runs):
    """crash,nan at 0.3 over 10 rounds: the rows a fault hits on a rank
    are the unsharded draw's rows at the same global ids, and the count
    of arrivals is the same."""
    assert bool(runs[1]["fault_hits"])


@pytest.mark.parametrize("overlap", ["off", "scatter"])
def test_sharded_screened_history_equals_unsharded(runs, overlap):
    """FedGiA with crash,nan 0.1 + screening on data=8: the `screened`
    history equals the unsharded run's, the rest at rtol 1e-4."""
    port = runs[1]
    one = {k.replace(f"faults1_{overlap}/", f"faults_{overlap}/"): v
           for k, v in port.items() if k.startswith(f"faults1_{overlap}/")}
    np.testing.assert_array_equal(
        port[f"faults_{overlap}/hist/screened"],
        one[f"faults_{overlap}/hist/screened"])
    assert_run_close(port, one, f"faults_{overlap}", **TOL)


# ------------------------------------------- in one process (unsharded)
def _make(name):
    model = LeastSquares(N)
    batch = to_torch(linreg_noniid(0, D, N, M), "cpu")
    algo = make_algorithm(FedConfig(algorithm=name, num_clients=M, **HP),
                          model.loss, model=model)
    return algo, algo.init(model.init("cpu"), prng_key(1),
                           init_batch=batch), batch


def _uplink_kw():
    return dict(compression="int8", error_feedback=True,
                screening=Screening(clip_norm=100.0),
                faults=make_faults(["crash", "nan"], [0.1], num_clients=M,
                                   seed=1))


def _saved(res):
    out = {}
    for k, v in res.history.items():
        out["run/hist/" + k] = np.asarray(v)
    for k, v in res.state.items():
        if isinstance(v, dict):
            for kk, vv in v.items():
                out["run/state/" + k + "/" + kk] = vv.numpy()
    return out


def _assert_ef_close(got, want, prefix):
    """The residual at atol EF_ATOL · max|x̄| (no rtol: it is a
    difference of two near-equal uploads)."""
    scale = max(float(np.abs(v).max()) for k, v in want.items()
                if k.startswith(prefix + "/state/x/"))
    keys = [k for k in want if k.startswith(prefix + "/state/ef/")]
    assert keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=0,
                                   atol=EF_ATOL * scale, err_msg=k)


def _prefixed(ref, prefix):
    return {k.replace(prefix + "/", "run/"): v for k, v in ref.items()
            if k.startswith(prefix + "/")}


@pytest.mark.parametrize("name", FIVE)
def test_overlap_active_unsharded(runs, name):
    """overlap="scatter" with the active store (uniform 0.5): the active
    barrier run bit for bit, both drivers alike, and the reference's
    overlapped active run at rtol 1e-4, atol 1e-6."""
    algo, state, batch = _make(name)
    pol = lambda: make_policy("uniform", M, 0.5, seed=3)  # noqa: E731
    bar = run_rounds(algo, state, batch, ROUNDS, participation=pol(),
                     store="active")
    for scan in (True, False):
        res = run_rounds(algo, state, batch, ROUNDS, participation=pol(),
                         store="active", overlap="scatter", scan=scan)
        assert "ovl_shard" not in res.state
        got, want = _saved(res), _saved(bar)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_run_close(got, _prefixed(runs[0], f"ovl_active_{name}"), "run",
                     **TOL)


@pytest.mark.parametrize("name", FIVE)
def test_overlap_uplink_unsharded(runs, name):
    """overlap="scatter" with int8 + EF + crash,nan 0.1 + screening: the
    chunked and the --no-scan drivers bit for bit, and the reference's
    overlapped run at rtol 1e-4, atol 1e-6, its residual at
    `_assert_ef_close`'s rule (FedGiA's uplink at the round's end under
    round + 1's key and fault draws, the baselines' where the barrier
    round runs it)."""
    algo, state, batch = _make(name)
    res = run_rounds(algo, state, batch, ROUNDS, overlap="scatter",
                     **_uplink_kw())
    leg = run_rounds(algo, state, batch, ROUNDS, overlap="scatter",
                     scan=False, **_uplink_kw())
    got = _saved(res)
    for k, v in _saved(leg).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    want = _prefixed(runs[0], f"ovl_uplink_{name}")
    keys = {k.split("/")[2] for k in want if k.startswith("run/state/")}
    assert_run_close(got, want, "run", state_keys=keys - {"ef"}, **TOL)
    _assert_ef_close(got, want, "run")


# ---------------------------------------------------------------- the CLI
BASE = ["--device", "cpu", "--clients", "32", "--rounds", "30"]
ACTIVE = ["--store", "active", "--participation", "uniform", "--alpha",
          "0.25", "--algo", "scaffold", "--lr", "0.01"]
UPLINK = ["--overlap", "scatter", "--error-feedback", "--faults",
          "crash,nan", "--fault-rate", "0.05", "--screening"]
CLI_RUNS = {
    "active": ACTIVE,
    "active_shard4": ["--shard-clients", "4"] + ACTIVE,
    "int8": UPLINK + ["--compression", "int8"],
    "int8_shard4": ["--shard-clients", "4", "--compression", "int8"]
    + UPLINK,
}
# the int8 lines: a stochastic level flips where an ulp of the
# reassociated eq. (11) sums moves t + U across a grid point, and error
# feedback carries the flip on (tests/test_torch_compress.py); over the
# CLI's 30 rounds at m = 32 the sharded f parts from the unsharded by
# 0.4-1.2 % (with bf16's deterministic rounding in its place the lines
# agree to their printed digits)
INT8_F_RTOL = 3e-2
INT8_ERR_RTOL = 1e-1
DONE = re.compile(r"done: (\d+) rounds \(CR=(\d+)\) in [\d.]+s  "
                  r"f=([-\d.]+) err=([-\d.e+]+)")


@pytest.fixture(scope="module")
def lines():
    """Every CLI run of CLI_RUNS, all at once: name -> its `done:`
    fields (rank 0's for a sharded run)."""
    procs = {k: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *BASE, *v],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for k, v in CLI_RUNS.items()}
    out = {}
    for k, p in procs.items():
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, f"{k}:\n{log[-4000:]}"
        found = DONE.findall(log)
        assert len(found) == 1, f"{k}: one done: line from rank 0\n{log}"
        out[k] = found[0]
    return out


@pytest.mark.parametrize("run", ["active", "int8"])
def test_cli_sharded_uplink_done_line(lines, run):
    """`--shard-clients 4` with SCAFFOLD's active store, and with the
    overlapped int8 + EF + faults + screening round: rank 0's `done:`
    line is the unsharded CLI's (rounds and CR equal, f to its printed
    resolution, err to 1 %; int8 at INT8_F_RTOL and INT8_ERR_RTOL, its
    level flips)."""
    a, b = lines[f"{run}_shard4"], lines[run]
    assert a[:2] == b[:2]
    if run == "int8":
        assert float(a[2]) == pytest.approx(float(b[2]), rel=INT8_F_RTOL)
        assert float(a[3]) == pytest.approx(float(b[3]), rel=INT8_ERR_RTOL)
        return
    assert abs(float(a[2]) - float(b[2])) <= 2e-6
    assert float(a[3]) == pytest.approx(float(b[3]), rel=1e-2)


@pytest.mark.parametrize("flags,match", [
    (["--shard-clients", "4", "--participation", "uniform", "--store",
      "offload"], "single-device host/device split"),
    (["--overlap", "scatter", "--participation", "uniform", "--store",
      "offload"], "does not ride it"),
    (["--shard-clients", "4", "--chunk", "auto"], "fixed --chunk"),
    (["--shard-clients", "4", "--checkpoint-every", "2",
      "--checkpoint-dir", "ck"], "runs unsharded"),
])
def test_cli_refusals_that_stay(flags, match):
    """The reference's refusals under a mesh and overlap keep its
    messages, with the uplink flags on too."""
    args = train_mod.build_parser().parse_args(
        BASE + ["--compression", "int8", "--screening"] + flags)
    with pytest.raises(SystemExit, match=match):
        train_mod.validate_flags(args)


@pytest.mark.parametrize("flags", [
    ["--shard-clients", "4", "--participation", "uniform", "--store",
     "active"],
    ["--shard-clients", "4", "--compression", "int8"],
    ["--overlap", "scatter", "--faults", "nan"],
    ["--shard-clients", "4", "--overlap", "scatter", "--participation",
     "uniform", "--store", "active", "--compression", "int8",
     "--error-feedback", "--faults", "crash,nan", "--screening",
     "--quorum", "4", "--watchdog"],
])
def test_cli_accepts_sharded_uplink(flags):
    """What the reference's `validate_flags` accepts passes the port's."""
    args = train_mod.build_parser().parse_args(BASE + flags)
    train_mod.validate_flags(args)
