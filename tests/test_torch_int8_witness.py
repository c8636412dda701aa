"""ROADMAP queue 3 o: under the stochastic int8 codec with error feedback
the port's float32 run and the reference's part (at the CLI's size the
port ended at f = 0.004985 and the reference at 0.005007; in
`wallclock_bench`'s int8 row they reached the target at CR 48 and 44).
Which side is nearer to the same run in float64?

The witness is the port's engine in float64 (data, state and codec
arithmetic; the same threefry words draw the same noise), so the gap of
either float32 run from it is what float32 rounding moves: a last-ulp
difference in an upload moves t + U across a grid point and flips one
int8 level, and error feedback carries the flip. Both sides are held to
the witness by the mean relative gap of f over the run's rounds (the
final round alone is one sample of that noise):

* `wallclock_bench`'s int8 + EF row (m = 64, the byte clock, the same
  60 rounds without the stop): measured, port 2.9e-3 and reference
  3.4e-3, stop rounds 24 and 22 against the witness's 31;
* the CLI acceptance run (`--compression int8 --error-feedback --faults
  crash,nan --fault-rate 0.05 --screening --quorum 32`, 100 rounds, m =
  128): port 3.20e-3 and reference 3.36e-3 (final f 0.0049851 and
  0.0050067 against the witness's 0.0050054).

Each side's mean gap is asserted below MEAN_GAP, and the port's at most
PORT_RATIO times the reference's: the port is as near as the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import benchmarks.common as jax_common
import benchmarks.wallclock_bench as jax_wallclock
from repro.config import FedConfig as JaxFedConfig
from repro.core import make_algorithm as jax_make_algorithm
from repro.core import run_rounds as jax_run_rounds
from repro.core.clock import ComputeClock as JaxComputeClock
from repro.launch import train as jax_train
from repro_torch.benchmarks import wallclock_bench
from repro_torch.benchmarks.common import M_CLIENTS, make_problem
from repro_torch.config import FedConfig
from repro_torch.core import api, engine, prng
from repro_torch.core.clock import ComputeClock
from repro_torch.core.faults import Screening, make_faults
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.launch import train
from repro_torch.models import LeastSquares

MEAN_GAP = 5e-3
PORT_RATIO = 1.2
ROW_ROUNDS = 60
CLI = ["--compression", "int8", "--error-feedback", "--faults", "crash,nan",
       "--fault-rate", "0.05", "--screening", "--quorum", "32"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _float64(batch, params):
    return ({k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()},
            {k: v.double() for k, v in params.items()})


def _gaps(port, ref, witness, what):
    port, ref, witness = (np.asarray(a, np.float64)
                          for a in (port, ref, witness))
    gap_port = float(np.mean(np.abs(port - witness) / witness))
    gap_ref = float(np.mean(np.abs(ref - witness) / witness))
    print(f"{what}: mean relative gap from the float64 witness: port "
          f"{gap_port!r}, reference {gap_ref!r}; final f {port[-1]!r}, "
          f"{ref[-1]!r}, witness {witness[-1]!r}")
    assert gap_port <= MEAN_GAP and gap_ref <= MEAN_GAP
    assert gap_port <= PORT_RATIO * gap_ref
    return gap_port, gap_ref


def _row_port(dtype):
    model, batch, _ = make_problem("linreg", 0, "cpu")
    params = model.init("cpu")
    if dtype == "float64":
        batch, params = _float64(batch, params)
    fed = FedConfig(num_clients=M_CLIENTS, k0=wallclock_bench.K0,
                    state_dtype=dtype, **wallclock_bench.ALGOS["fedgia_d"])
    algo = api.make_algorithm(fed, model.loss, model=model)
    state = algo.init(params, prng.prng_key(1), init_batch=batch)
    clock = ComputeClock(M_CLIENTS,
                         compute_s=wallclock_bench.COMPRESS_COMPUTE_S,
                         bandwidth_bps=wallclock_bench.BANDWIDTH_BPS)
    return engine.run_rounds(
        algo, state, batch, ROW_ROUNDS, tol=0.0, clock=clock,
        max_staleness=wallclock_bench.MAX_STALENESS, compression="int8",
        error_feedback=True).history["f_xbar"]


def test_wallclock_int8_row_against_float64_witness():
    model, batch, _ = jax_common.make_problem("linreg", 0)
    fed = JaxFedConfig(num_clients=M_CLIENTS, k0=jax_wallclock.K0,
                       **jax_wallclock.ALGOS["fedgia_d"])
    algo = jax_make_algorithm(fed, model.loss, model=model)
    state = algo.init(model.init(jax.random.PRNGKey(0)),
                      jax.random.PRNGKey(1), init_batch=batch)
    clock = JaxComputeClock(M_CLIENTS,
                            compute_s=jax_wallclock.COMPRESS_COMPUTE_S,
                            bandwidth_bps=jax_wallclock.BANDWIDTH_BPS)
    ref = jax_run_rounds(algo, state, batch, ROW_ROUNDS, tol=0.0,
                         clock=clock,
                         max_staleness=jax_wallclock.MAX_STALENESS,
                         stale_weighting="uniform", compression="int8",
                         error_feedback=True).history["f_xbar"]
    _gaps(_row_port("float32"), ref, _row_port("float64"),
          "wallclock_bench int8 + EF row")


def test_cli_int8_faults_run_against_float64_witness():
    port = [h["f"] for h in train.main(CLI + ["--device", "cpu"])["history"]]
    ref = [h["f"] for h in jax_train.train(
        jax_train.build_parser().parse_args(CLI))["history"]]
    model = LeastSquares(100)
    batch, params = _float64(to_torch(linreg_noniid(0, 12800, 100, 128),
                                      "cpu"), model.init("cpu"))
    fed = FedConfig(num_clients=128, k0=5, alpha=0.5, sigma_t=0.15,
                    h_policy="scalar", state_dtype="float64")
    algo = api.make_algorithm(fed, model.loss, model=model)
    state = algo.init(params, prng.prng_key(1), init_batch=batch)
    witness = engine.run_rounds(
        algo, state, batch, 100, tol=1e-7, compression="int8",
        error_feedback=True,
        faults=make_faults(["crash", "nan"], [0.05], num_clients=128,
                           seed=0, scale=1e6),
        screening=Screening(clip_norm=None), quorum=32).history["f_xbar"]
    assert len(port) == len(ref) == len(witness) == 100
    _gaps(port, ref, witness, "CLI int8 + EF + faults run")
