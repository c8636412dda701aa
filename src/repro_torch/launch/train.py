"""Federated training driver for the port: FedGiA and the paper's four
comparison baselines on the paper's problems.

  PYTHONPATH=src python -m repro_torch.launch.train --problem linreg \
      --algo fedgia --clients 128 --k0 5 --rounds 200 --tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.train --algo fedprox --lr 0.002

Runs on the CUDA device unless `--device cpu` is given, in which case the
plain PyTorch versions stand in for the CUDA kernels. Same flags and
defaults as the main-path subset of `repro.launch.train`, and the same
closing `done:` line. `--alpha` is FedGiA's ADMM/GD split; the baselines
run with every client, as the reference's do without a participation
policy.

Rounds run in chunks (`core/engine.py`): on the card each chunk length is
captured once as a CUDA graph and replayed, with the eq. (35) stop
checked on the device and read by the host once a chunk. `--chunk N`
sets the rounds a chunk (0: the reference's sizing; `auto` times the
candidate lengths 8, 32 and 128 on the live run and keeps the fastest);
`--no-scan` runs the legacy per-round loop instead.

`--participation` moves client selection into the engine: a policy of
`core/selection.py` draws a mask every round on the host and every
algorithm takes it (FedGiA as its ADMM/GD split, the baselines as the
round's participants). `--unrolled` runs FedGiA's k0-step ADMM loop
instead of the closed form, and so launches no kernel.

`--store active` swaps the dense (m, N) round working set for a packed
tile of each round's participants (it needs `--participation`; uniform,
weighted and cyclic give a tile of |C| rows, the others of m): the state
is bitwise the dense store's, and f and |grad|^2 become participant
means. `--store offload` keeps the client buffers in host memory and
moves the tiles each round. `--aggregate packed` sums the tile directly
in eq. (11) (fp tolerance against the dense layout).

`--async` makes the participation mask the ARRIVAL process of stale-x̄
rounds: a client works against the x̄ it last downloaded, at most
`--max-staleness` rounds old (0: bitwise the synchronous run). `--clock
constant|lognormal` derives the arrival mask from simulated per-client
work times (`--client-speeds`, `--clock-sigma`; implies `--async`) and
reports the simulated seconds beside CR. `--stale-weighting poly|exp`
downweights stale contributions in eq. (11) (`--stale-decay`).

  PYTHONPATH=src python -m repro_torch.launch.train --clients 64 \
      --clock constant --max-staleness 4 --stale-weighting poly
"""
from __future__ import annotations

import argparse
import logging
import sys

from repro_torch.config import ALGORITHMS, FedConfig
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import CLOCKS, make_clock
from repro_torch.core.engine import run_rounds
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import POLICIES, make_policy
from repro_torch.data import linreg_noniid, logreg_data, to_torch
from repro_torch.device import resolve_device
from repro_torch.models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
)

LOG_EVERY = 10


def get_logger(name: str = "train") -> logging.Logger:
    logger = logging.getLogger(f"repro_torch.{name}")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter(
            f"%(asctime)s %(levelname).1s {name}] %(message)s",
            datefmt="%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


log = get_logger("train")


def build_problem(args, device):
    n = args.dim
    if args.problem == "linreg":
        model = LeastSquares(n)
        raw = linreg_noniid(args.seed, args.samples, n, args.clients)
    elif args.problem == "logreg":
        model = LogisticRegression(n)
        raw = logreg_data(args.seed, args.samples, n, args.clients)
    else:
        model = NonConvexLogistic(n)
        raw = logreg_data(args.seed, args.samples, n, args.clients)
    return model, model.loss, model.init(device), to_torch(raw, device)


def _parse_csv(value: str, n: int, flag: str, cast):
    try:
        items = [cast(v) for v in value.split(",")]
    except ValueError as e:
        raise SystemExit(f"{flag}: {e}")
    if len(items) != n:
        raise SystemExit(f"{flag} needs {n} values, got {len(items)}")
    return items


def validate_flags(args) -> dict:
    """Cross-flag checks of the engine flags, with the reference's errors
    (SystemExit): a `--chunk` that is neither an int nor "auto", `--chunk
    auto` with `--no-scan` or `--store offload`, `--store active|offload`
    without a policy or a clock, `--aggregate packed` with `--store
    dense`, `--client-weights` without `--participation
    weighted`, `--arrival-periods` without `--participation periodic`,
    `--clock` with a `--participation` policy, `--clock trace`
    (library-level), a non-positive `--stale-decay` with a decaying
    weighting, `--max-staleness` or `--stale-weighting` without `--async`
    or `--clock`, `--async` without an arrival process,
    `--client-speeds` without `--clock`, and a per-client list whose
    length is not `--clients`. Returns the chunk size (int or "auto"),
    whether the rounds are async, and the parsed lists (or None)."""
    chunk = args.chunk
    if chunk != "auto":
        try:
            chunk = int(chunk)
        except ValueError:
            raise SystemExit(
                f"--chunk must be an integer or 'auto', got {chunk!r}")
    elif args.no_scan:
        raise SystemExit("--chunk auto tunes the scan chunk length and "
                         "cannot be combined with --no-scan")
    kind, clock_kind = args.participation, args.clock
    async_rounds = args.async_rounds or clock_kind != "none"
    store = args.store
    if store in ("active", "offload") and kind == "full" and \
            clock_kind == "none":
        raise SystemExit(
            f"--store {store} needs a per-round participant set to pack the "
            "tile from: pass --participation (uniform/weighted/cyclic give "
            "the fixed-size tile; others bound it by m) or --clock")
    if store == "offload" and chunk == "auto":
        raise SystemExit(
            "--chunk auto tunes the scan chunk length — the host-driven "
            "offload loop (--store offload) has no chunks")
    if args.aggregate == "packed" and store == "dense":
        raise SystemExit(
            "--aggregate packed sums the packed participant tile — it "
            "requires --store active or --store offload")
    if clock_kind != "none" and kind != "full":
        raise SystemExit(
            "--clock derives the arrival mask from simulated finish times "
            "and cannot be combined with --participation")
    if clock_kind == "trace":
        raise SystemExit(
            "--clock trace is library-level (it needs a (T, m) duration "
            "table): build core.clock.TraceClock and pass it to "
            "run_rounds(clock=...) programmatically")
    if args.stale_weighting != "uniform" and args.stale_decay <= 0:
        raise SystemExit("--stale-decay must be > 0")
    if args.max_staleness and not async_rounds:
        raise SystemExit("--max-staleness requires --async (or --clock)")
    if args.stale_weighting != "uniform" and not async_rounds:
        raise SystemExit("--stale-weighting requires --async (or --clock)")
    if async_rounds and kind == "full" and clock_kind == "none":
        raise SystemExit(
            "--async needs an arrival process: pass --participation "
            "straggler/periodic/... (the mask is who communicates) or "
            "--clock (event-driven wall-clock arrivals)")
    weights = periods = speeds = None
    if args.client_weights:
        if args.participation != "weighted":
            raise SystemExit(
                "--client-weights requires --participation weighted")
        weights = _parse_csv(args.client_weights, args.clients,
                             "--client-weights", float)
    if args.arrival_periods:
        if args.participation != "periodic":
            raise SystemExit(
                "--arrival-periods requires --participation periodic")
        periods = _parse_csv(args.arrival_periods, args.clients,
                             "--arrival-periods", int)
    if args.client_speeds:
        if clock_kind == "none":
            raise SystemExit("--client-speeds requires --clock")
        speeds = _parse_csv(args.client_speeds, args.clients,
                            "--client-speeds", float)
    return {"chunk": chunk, "async_rounds": async_rounds, "weights": weights,
            "periods": periods, "speeds": speeds}


def train(args) -> dict:
    """Run one training job. Returns the summary, plus the run's algorithm
    object, client batch and final state (`algorithm`, `batch`, `state`)
    for callers that go on from it."""
    parsed = validate_flags(args)
    device = resolve_device(args.device)
    model, loss_fn, params0, batch = build_problem(args, device)
    fed = FedConfig(algorithm=args.algo, num_clients=args.clients, k0=args.k0,
                    alpha=args.alpha, sigma_t=args.sigma_t,
                    h_policy=args.h_policy, collapsed=not args.unrolled,
                    lr=args.lr)
    algo = make_algorithm(fed, loss_fn, model=model)
    state = algo.init(params0, prng_key(args.seed + 1),
                      init_batch=batch)
    if args.unrolled and args.algo == "fedgia":
        log.info("unrolled FedGiA round: the k0-step ADMM loop in torch "
                 "(no fused update kernel)")
    policy = make_policy(args.participation, args.clients, args.alpha,
                         seed=args.seed, weights=parsed["weights"],
                         drop_prob=args.drop_prob,
                         horizon=max(args.rounds, 1),
                         periods=parsed["periods"])
    if policy is not None:
        if args.participation in ("straggler", "periodic"):
            log.info("participation: %s policy (per-round varying |C|), "
                     "m=%d", args.participation, args.clients)
        else:
            log.info("participation: %s policy, alpha=%.2f (|C|=%d of "
                     "m=%d)", args.participation, args.alpha,
                     policy.n_selected, args.clients)
    # the wall-clock simulation derives the arrival mask from simulated
    # finish times and implies async rounds
    clock = make_clock(args.clock, args.clients, compute_s=parsed["speeds"],
                       sigma=args.clock_sigma, seed=args.seed)
    async_rounds = parsed["async_rounds"]
    if async_rounds:
        log.info("async rounds: stale-x̄ engine, max_staleness=%d, "
                 "weighting=%s", args.max_staleness, args.stale_weighting)
    if clock is not None:
        log.info("wall-clock rounds: %s clock, m=%d", clock.name,
                 args.clients)
    cap = args.clients if clock is not None else (
        policy.active_capacity if policy is not None else None)
    if args.store == "active":
        log.info("active-set store: (%d, N) participant tile gathered/"
                 "scattered per round (m=%d resident)", cap, args.clients)
    elif args.store == "offload":
        log.info("host-offloaded store: resident client buffers in host "
                 "memory, (%d, N) tiles shuttled per round (m=%d)", cap,
                 args.clients)
    if args.aggregate == "packed":
        log.info("packed aggregation: eq. (11) sums the participant tile "
                 "directly (fp tolerance vs the bitwise dense layout)")
    res = run_rounds(algo, state, batch, args.rounds, tol=args.tol,
                     scan=not args.no_scan, chunk_size=parsed["chunk"],
                     participation=policy, store=args.store,
                     aggregate=args.aggregate, async_rounds=async_rounds,
                     max_staleness=args.max_staleness, clock=clock,
                     stale_weighting=args.stale_weighting,
                     stale_decay=args.stale_decay)
    history = [
        {"round": r, "f": float(res.history["f_xbar"][r]),
         "err": float(res.history["grad_sq_norm"][r])}
        for r in range(res.rounds_run)
    ]
    for h in history:
        if h["round"] % LOG_EVERY == 0 or h["round"] == res.rounds_run - 1:
            log.info("round %4d  f=%.6f  |grad|^2=%.3e",
                     h["round"], h["f"], h["err"])
    if res.stopped_early:
        log.info("tolerance reached at round %d", res.rounds_run - 1)
    result = {
        "algo": args.algo,
        "device": str(device),
        "rounds": res.rounds_run,
        "cr": 2 * res.rounds_run,
        "stopped_early": res.stopped_early,
        "final_f": history[-1]["f"],
        "final_err": history[-1]["err"],
        "wall_s": res.wall_s,
        "capture_s": res.capture_s,
        "chunk_size": res.chunk_size,
        "draw_s": res.draw_s,
        "store": args.store,
        "aggregate": args.aggregate,
        "extras": res.extras,
        "history": history,
        "algorithm": algo,
        "batch": batch,
        "state": res.state,
    }
    if async_rounds:
        result["max_staleness"] = args.max_staleness
        result["stale_weighting"] = args.stale_weighting
        result["staleness_max_seen"] = int(
            res.history["staleness_max"].max())
        log.info("async: max staleness actually used = %d (bound %d)",
                 result["staleness_max_seen"], args.max_staleness)
    if clock is not None:
        result["clock"] = clock.name
        result["sim_time_s"] = float(res.history["sim_time"][-1])
        log.info("simulated wall-clock: %.3f s to round %d "
                 "(time-to-target when the tolerance stopped the run)",
                 result["sim_time_s"], res.rounds_run - 1)
    if args.store == "offload":
        log.info("host-offloaded store: %d host-resident bytes, device peak "
                 "%s bytes, tile copies %.3fs on the host",
                 res.extras["host_resident_bytes"],
                 res.extras["device_peak_bytes"], res.extras["copy_s"])
    elif not args.no_scan:
        log.info("chunked driver: %d rounds a chunk%s; warm-up and capture "
                 "%.3fs (outside the rounds' time)", res.chunk_size,
                 " (auto)" if parsed["chunk"] == "auto" else "",
                 res.capture_s)
    if policy is not None:
        log.info("mask draws%s on the host: %.3fs of the rounds' time",
                 "" if args.store == "dense" else " and packs", res.draw_s)
    log.info(
        "done: %d rounds (CR=%d) in %.2fs  f=%.6f err=%.2e",
        result["rounds"], result["cr"], res.wall_s, result["final_f"],
        result["final_err"],
    )
    return result


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--problem", default="linreg",
                    choices=["linreg", "logreg", "ncvx_logreg"])
    ap.add_argument("--algo", default="fedgia", choices=list(ALGORITHMS))
    ap.add_argument("--clients", type=int, default=128)
    ap.add_argument("--k0", type=int, default=5)
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--sigma-t", type=float, default=0.15)
    ap.add_argument("--h-policy", default="scalar",
                    choices=["scalar", "diag_ema", "gram"])
    ap.add_argument("--rounds", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-7)
    ap.add_argument("--dim", type=int, default=100)
    ap.add_argument("--samples", type=int, default=12800)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.01,
                    help="the baselines' learning rate a (gamma_k = "
                         "a / log2(k + 2))")
    ap.add_argument("--no-scan", action="store_true",
                    help="legacy per-round loop (one host read a round "
                         "when --tol > 0)")
    ap.add_argument("--chunk", default="0",
                    help="rounds a chunk, one CUDA-graph replay each on "
                         "the card (0 = the whole run when --tol <= 0, "
                         "else 32), or 'auto' to time the candidate "
                         "lengths (8/32/128) on the live run and keep the "
                         "fastest")
    ap.add_argument("--unrolled", action="store_true",
                    help="FedGiA's k0-step ADMM loop instead of the "
                         "closed-form round (no kernel)")
    ap.add_argument("--participation", default="full", choices=POLICIES,
                    help="engine-level participation policy (full = no "
                         "engine mask: FedGiA draws its own split, the "
                         "baselines run every client)")
    ap.add_argument("--client-weights", default="",
                    help="comma-separated per-client sampling weights "
                         "(--participation weighted)")
    ap.add_argument("--drop-prob", type=float, default=0.2,
                    help="per-round dropout probability "
                         "(--participation straggler)")
    ap.add_argument("--arrival-periods", default="",
                    help="comma-separated per-client arrival periods in "
                         "rounds (--participation periodic)")
    ap.add_argument("--store", default="dense",
                    choices=["dense", "active", "offload"],
                    help="client-state store: dense (m, N) rounds, the "
                         "active participant tile, or the tile with the "
                         "client buffers in host memory")
    ap.add_argument("--aggregate", default="dense",
                    choices=["dense", "packed"],
                    help="eq. (11) over the tile scattered back to the "
                         "dense layout (bitwise) or summed directly "
                         "(--store active/offload)")
    ap.add_argument("--async", dest="async_rounds", action="store_true",
                    help="stale-x̄ rounds: the participation mask becomes "
                         "the arrival process and stragglers work against "
                         "their last-downloaded x̄")
    ap.add_argument("--max-staleness", type=int, default=0,
                    help="bound on the stale-x̄ age in rounds (--async); "
                         "0 = bitwise the synchronous run")
    ap.add_argument("--clock", default="none", choices=("none",) + CLOCKS,
                    help="wall-clock simulation (implies --async): derive "
                         "the arrival mask from per-client work times — "
                         "constant (fixed speeds), lognormal (jittered); "
                         "trace is library-level. Reports simulated "
                         "seconds beside CR")
    ap.add_argument("--client-speeds", default="",
                    help="comma-separated per-client compute seconds for "
                         "--clock (default: cycling 1..4)")
    ap.add_argument("--clock-sigma", type=float, default=0.5,
                    help="lognormal compute-time jitter (--clock "
                         "lognormal)")
    ap.add_argument("--stale-weighting", default="uniform",
                    choices=["uniform", "poly", "exp"],
                    help="staleness-aware eq. (11) (--async/--clock): "
                         "uniform (unweighted, bitwise), poly "
                         "((1+s)^-decay), exp (e^(-decay*s))")
    ap.add_argument("--stale-decay", type=float, default=1.0,
                    help="decay rate of --stale-weighting poly/exp")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
