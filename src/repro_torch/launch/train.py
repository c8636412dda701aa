"""Federated training driver for the port: FedGiA and the paper's four
comparison baselines on the paper's problems and on the dense
transformers.

  PYTHONPATH=src python -m repro_torch.launch.train --problem linreg \
      --algo fedgia --clients 128 --k0 5 --rounds 200 --tol 1e-7
  PYTHONPATH=src python -m repro_torch.launch.train --algo fedprox --lr 0.002
  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \
      --reduced --algo fedgia --clients 4 --rounds 20 --seq-len 64 \
      --batch 2

`--arch X [--reduced]` trains a registered dense GQA or RWKV-6
architecture (`repro_torch.configs`) on the synthetic bigram token
stream (`data/tokens.py`, `--batch` sequences of `--seq-len` tokens a
client), from the weights the reference draws from `--seed`
(`models.transformer.init_params`), with r_hat probed at the start
(`hparams.estimate_lipschitz`, as the reference's `auto_lipschitz`).
The gradients are taken in the config's dtype and the round state is
float32. `--kernel auto|on|off` picks the round's fused update: auto the
CUDA kernel on the card and its plain version on the CPU, on the kernel
(which the CPU lacks), off the plain version anywhere (an A/B of the
kernel); the reference's `interpret` has no CUDA meaning and is
rejected. `--log-every N` logs every N-th round.

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
`--no-scan` runs the legacy per-round loop instead. `--no-flat` runs
the per-leaf rounds (`run_rounds(flat=False)`) in place of the flat
buffers' rounds, in either driver, with the reference's refusals: the
stores, the codecs, the faults, the screening and `--kernel on` need the
flat buffers. The two give the same `done:` line (bitwise on the CPU).

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

`--compression bf16|int8|topk` puts each round's upload through a codec
(`core/compress.py`; `--topk-frac`, `--error-feedback`), and
`--bandwidth-bps` prices its wire in the clock's simulated time.
`--faults crash,nan,inf,explode,replay` (`--fault-rate`,
`--fault-scale`) corrupts uploads on the device, `--screening`
(`--clip-norm`) drops the non-finite ones and clips the rest, `--quorum`
turns a round with too few accepted uploads into a recorded no-op,
`--deadline-s` cuts clocked rounds at a deadline and `--watchdog`
(`--watchdog-patience`, `--watchdog-factor`) rolls a diverging run back
to its best round. `--checkpoint-every N --checkpoint-dir D` saves the
run's whole carry every N rounds, and `--resume` goes on from the newest
checkpoint, bit for bit the run that was not cut.

  PYTHONPATH=src python -m repro_torch.launch.train --compression int8 \
      --error-feedback --faults crash,nan --fault-rate 0.05 --screening \
      --quorum 32
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.config import ALGORITHMS, FedConfig
from repro_torch.configs import get_config, list_architectures
from repro_torch.core.api import make_algorithm
from repro_torch.core.clock import CLOCKS, make_clock
from repro_torch.core.engine import run_rounds
from repro_torch.core.faults import FAULT_KINDS, Screening, make_faults
from repro_torch.core.prng import prng_key
from repro_torch.core.selection import POLICIES, make_policy
from repro_torch.data import (
    linreg_noniid,
    logreg_data,
    synthetic_batch_for,
    to_torch,
)
from repro_torch.device import resolve_device
from repro_torch.models import (
    LeastSquares,
    LogisticRegression,
    NonConvexLogistic,
    Transformer,
)
from repro_torch.models.transformer import init_params
from repro_torch.utils import get_logger

log = get_logger("repro_torch.train")


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_problem(args, device):
    if args.arch:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = Transformer(cfg, device)
        batch = to_torch(synthetic_batch_for(cfg, args.clients, args.batch,
                                             args.seq_len, seed=args.seed),
                         device)
        params0 = init_params(cfg, prng_key(args.seed), device)
        return model, model.loss, params0, batch
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
    `--client-speeds` without `--clock`, a per-client list whose length
    is not `--clients`; the uplink's: `--error-feedback` without a lossy
    `--compression`, `--topk-frac` without `--compression topk` or
    outside (0, 1], `--bandwidth-bps` without `--clock` or negative, an
    unknown `--faults` kind, `--fault-rate` without `--faults`, outside
    [0, 1] or of a length neither 1 nor the kinds', `--clip-norm`
    without `--screening` or negative, `--quorum` outside [1, m] or
    without a source of non-arrival, `--deadline-s` without `--clock` or
    `--quorum`, `--watchdog-patience`/`--watchdog-factor` without
    `--watchdog`, a patience < 1 or a factor <= 1, `--watchdog` with
    `--store offload`, and `--checkpoint-every`/`--resume` without
    `--checkpoint-dir`, with `--chunk auto` or with `--no-scan` on a
    store other than offload, `--kernel interpret` (the reference's
    Pallas interpret mode, which has no CUDA meaning), and with
    `--no-flat` `--kernel on`, `--store active|offload`, a
    `--compression`, `--faults` and `--screening` (each needs the flat
    buffers). Returns the chunk size (int or "auto"), whether the rounds
    are async and flat, the parsed lists (or None),
    `FedConfig.use_kernel` and the uplink's settings."""
    if args.kernel == "interpret":
        raise SystemExit(
            "--kernel interpret is the reference's Pallas interpret mode, "
            "which has no CUDA meaning: --kernel auto runs the kernel's "
            "plain version on the CPU, --kernel off runs it anywhere")
    use_kernel = {"auto": None, "on": True, "off": False}[args.kernel]
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
    if args.kernel == "on" and args.no_flat:
        raise SystemExit(
            "--kernel on/interpret requires the flat round path "
            "(drop --no-flat)")
    kind, clock_kind = args.participation, args.clock
    async_rounds = args.async_rounds or clock_kind != "none"
    store = args.store
    if store in ("active", "offload") and args.no_flat:
        raise SystemExit(
            f"--store {store} packs the flat (m, N) client buffers and "
            "requires the flat round path (drop --no-flat)")
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
    out = {"chunk": chunk, "async_rounds": async_rounds, "weights": weights,
           "periods": periods, "speeds": speeds, "use_kernel": use_kernel,
           "flat": not args.no_flat}
    out.update(_validate_uplink(args, chunk, clock_kind, kind, store))
    return out


def _validate_uplink(args, chunk, clock_kind, kind, store) -> dict:
    """`validate_flags`' checks of the codec, fault, guard and checkpoint
    flags, with the reference's messages."""
    compression, error_feedback = args.compression, args.error_feedback
    topk_frac, bandwidth = args.topk_frac, args.bandwidth_bps
    if compression != "none" and args.no_flat:
        raise SystemExit(
            "--compression runs on the flat (m, N) comm buffer and "
            "requires the flat round path (drop --no-flat)")
    if error_feedback and compression == "none":
        raise SystemExit(
            "--error-feedback carries the codec residual — it needs a "
            "lossy --compression (bf16/int8/topk)")
    if topk_frac is not None:
        if compression != "topk":
            raise SystemExit("--topk-frac requires --compression topk")
        if not (0.0 < topk_frac <= 1.0):
            raise SystemExit(
                f"--topk-frac must be in (0, 1], got {topk_frac}")
    if bandwidth:
        if bandwidth < 0:
            raise SystemExit(
                f"--bandwidth-bps must be > 0, got {bandwidth}")
        if clock_kind == "none":
            raise SystemExit(
                "--bandwidth-bps prices the wire inside the wall-clock "
                "simulation — it requires --clock")
    fault_kinds = [k for k in args.faults.split(",") if k]
    bad = sorted(set(fault_kinds) - set(FAULT_KINDS))
    if bad:
        raise SystemExit(
            f"--faults: unknown kind(s) {','.join(bad)} "
            f"(choose from {','.join(FAULT_KINDS)})")
    if fault_kinds and args.no_flat:
        raise SystemExit(
            "--faults corrupts the flat (m, N) comm buffer and "
            "requires the flat round path (drop --no-flat)")
    rate_arg = args.fault_rate
    if rate_arg and not fault_kinds:
        raise SystemExit(
            "--fault-rate is the injection probability of --faults — "
            "pass --faults crash,nan,...")
    fault_rates = [0.05]
    if rate_arg:
        try:
            fault_rates = [float(v) for v in rate_arg.split(",")]
        except ValueError as e:
            raise SystemExit(f"--fault-rate: {e}")
        if len(fault_rates) not in (1, len(fault_kinds)):
            raise SystemExit(
                f"--fault-rate needs 1 or {len(fault_kinds)} values, "
                f"got {len(fault_rates)}")
        if any(not 0.0 <= r <= 1.0 for r in fault_rates):
            raise SystemExit(
                f"--fault-rate values must be in [0, 1], got {rate_arg}")
    screening, clip_norm = args.screening, args.clip_norm
    if screening and args.no_flat:
        raise SystemExit(
            "--screening filters the flat (m, N) comm buffer and "
            "requires the flat round path (drop --no-flat)")
    if clip_norm:
        if clip_norm < 0:
            raise SystemExit(f"--clip-norm must be > 0, got {clip_norm}")
        if not screening:
            raise SystemExit(
                "--clip-norm is the screening stage's norm clip — "
                "pass --screening")
    quorum = args.quorum
    if quorum:
        if not 0 < quorum <= args.clients:
            raise SystemExit(
                f"--quorum must be in [1, m={args.clients}], got {quorum}")
        if kind == "full" and clock_kind == "none" and not fault_kinds \
                and not screening:
            raise SystemExit(
                "--quorum needs a source of non-arrival to guard against "
                "— pass --participation, --clock, --faults or --screening")
    deadline_s = args.deadline_s
    if deadline_s:
        if deadline_s < 0:
            raise SystemExit(f"--deadline-s must be > 0, got {deadline_s}")
        if clock_kind == "none":
            raise SystemExit(
                "--deadline-s cuts simulated rounds at a wall-clock "
                "deadline — it requires --clock")
        if quorum < 1:
            raise SystemExit(
                "--deadline-s can close rounds with ZERO arrivals — pass "
                "--quorum (>= 1) so they degrade to recorded no-ops "
                "instead of aggregating nothing")
    watchdog = args.watchdog
    patience, factor = args.watchdog_patience, args.watchdog_factor
    if not watchdog and (patience is not None or factor is not None):
        raise SystemExit(
            "--watchdog-patience/--watchdog-factor tune the divergence "
            "watchdog — pass --watchdog")
    patience = 3 if patience is None else patience
    factor = 2.0 if factor is None else factor
    if watchdog:
        if patience < 1:
            raise SystemExit(
                f"--watchdog-patience must be >= 1, got {patience}")
        if factor <= 1.0:
            raise SystemExit(
                "--watchdog-factor is a divergence threshold RELATIVE to "
                f"the best f̄ seen and must be > 1, got {factor}")
        if store == "offload":
            raise SystemExit(
                "--watchdog keeps a full state snapshot in the carry — "
                "with --store offload that would double the host-resident "
                "buffers; use --store dense/active")
    ckpt_every, resume = args.checkpoint_every, args.resume
    if ckpt_every < 0:
        raise SystemExit(
            f"--checkpoint-every must be >= 0, got {ckpt_every}")
    if ckpt_every or resume:
        if not args.checkpoint_dir:
            raise SystemExit(
                "--checkpoint-every/--resume need --checkpoint-dir to "
                "write/read the round-carry snapshots")
        if chunk == "auto":
            raise SystemExit(
                "--chunk auto re-times candidate chunk lengths — "
                "checkpoint boundaries need a fixed --chunk")
        if args.no_scan and store != "offload":
            raise SystemExit(
                "--checkpoint-every/--resume ride the chunked scan "
                "driver (or the offload loop) — drop --no-scan")
    return {"compression": None if compression == "none" else compression,
            "error_feedback": error_feedback,
            "topk_frac": 0.1 if topk_frac is None else topk_frac,
            "bandwidth_bps": bandwidth if bandwidth else None,
            "fault_kinds": fault_kinds, "fault_rates": fault_rates,
            "screening": screening,
            "clip_norm": clip_norm if clip_norm else None,
            "quorum": quorum,
            "deadline_s": deadline_s if deadline_s else None,
            "watchdog": watchdog, "watchdog_patience": patience,
            "watchdog_factor": factor, "checkpoint_every": ckpt_every,
            "resume": resume}


def train(args) -> dict:
    """Run one training job. Returns the summary, plus the run's algorithm
    object, client batch and final state (`algorithm`, `batch`, `state`)
    for callers that go on from it. `args` may be a bare Namespace with
    only some of the flags (the reference's tests pass such ones): the
    parser's defaults fill in the rest."""
    args = argparse.Namespace(**{**vars(build_parser().parse_args([])),
                                 **vars(args)})
    parsed = validate_flags(args)
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    model, loss_fn, params0, batch = build_problem(args, device)
    _sync(device)
    t1 = time.perf_counter()
    fed = FedConfig(algorithm=args.algo, num_clients=args.clients, k0=args.k0,
                    alpha=args.alpha, sigma_t=args.sigma_t,
                    h_policy=args.h_policy, collapsed=not args.unrolled,
                    lr=args.lr, auto_lipschitz=args.arch is not None,
                    use_kernel=parsed["use_kernel"])
    algo = make_algorithm(fed, loss_fn, model=model)
    state = algo.init(params0, prng_key(args.seed + 1),
                      init_batch=batch)
    _sync(device)
    init_s, probe_s = t1 - t0, time.perf_counter() - t1
    del params0  # the state holds its own copy (float32)
    if args.arch:
        cfg = model.cfg
        log.info("model: %s, %d layers x d_model %d, %d parameters (%s), "
                 "batch %d x %d tokens a client", cfg.name, cfg.num_layers,
                 cfg.d_model, sum(v.numel() for v in state["x"].values()),
                 cfg.dtype, args.batch, args.seq_len)
        log.info("weights drawn in %.3fs", init_s)
        if args.algo == "fedgia":
            log.info("sigma=%.6g r_hat=%.6g (probed in %.3fs)",
                     float(state["sigma"]), float(state["r"]), probe_s)
    if not parsed["flat"]:
        log.info("per-leaf pytree rounds (--no-flat): the state's dicts "
                 "leaf by leaf, no fused update kernel")
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
                       sigma=args.clock_sigma, seed=args.seed,
                       bandwidth_bps=parsed["bandwidth_bps"],
                       deadline_s=parsed["deadline_s"])
    faults = make_faults(parsed["fault_kinds"], parsed["fault_rates"],
                         num_clients=args.clients, seed=args.seed,
                         scale=args.fault_scale)
    screening = (Screening(clip_norm=parsed["clip_norm"])
                 if parsed["screening"] else None)
    _log_uplink(parsed, faults, screening, args)
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
                     stale_decay=args.stale_decay,
                     compression=parsed["compression"],
                     error_feedback=parsed["error_feedback"],
                     topk_frac=parsed["topk_frac"], faults=faults,
                     screening=screening, quorum=parsed["quorum"],
                     watchdog=parsed["watchdog"],
                     watchdog_patience=parsed["watchdog_patience"],
                     watchdog_factor=parsed["watchdog_factor"],
                     checkpoint_every=parsed["checkpoint_every"],
                     checkpoint_dir=(args.checkpoint_dir or None)
                     if (parsed["checkpoint_every"] or parsed["resume"])
                     else None,
                     resume=parsed["resume"], flat=parsed["flat"])
    history = [
        {"round": r, "f": float(res.history["f_xbar"][r]),
         "err": float(res.history["grad_sq_norm"][r])}
        for r in range(res.rounds_run)
    ]
    for h in history:
        if h["round"] % args.log_every == 0 or \
                h["round"] == res.rounds_run - 1:
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
        # the problem's set-up (data, weights) and the algorithm's state
        # (with --arch, the Lipschitz probe), outside wall_s
        "init_s": init_s,
        "probe_s": probe_s,
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
    if parsed["compression"] is not None:
        result["compression"] = parsed["compression"]
        result["error_feedback"] = parsed["error_feedback"]
    if clock is not None:
        result["clock"] = clock.name
        result["sim_time_s"] = float(res.history["sim_time"][-1])
        log.info("simulated wall-clock: %.3f s to round %d "
                 "(time-to-target when the tolerance stopped the run)",
                 result["sim_time_s"], res.rounds_run - 1)
        if parsed["bandwidth_bps"] is not None:
            result["bytes_up"] = float(res.history["bytes_up"].sum())
            result["bytes_down"] = float(res.history["bytes_down"].sum())
            log.info("wire totals: %.0f B up / %.0f B down over %d rounds",
                     result["bytes_up"], result["bytes_down"],
                     res.rounds_run)
    if "screened" in res.history:
        result["screened_min"] = int(res.history["screened"].min())
    if "degraded" in res.history:
        result["degraded_rounds"] = int(res.history["degraded"].sum())
        if result["degraded_rounds"]:
            log.info("%d round(s) missed the quorum and degraded to "
                     "no-ops", result["degraded_rounds"])
    if "rollback" in res.history:
        result["rollbacks"] = int(res.history["rollback"].sum())
        if result["rollbacks"]:
            log.info("watchdog rolled the state back %d time(s)",
                     result["rollbacks"])
    if args.checkpoint_dir and not (parsed["checkpoint_every"]
                                    or parsed["resume"]):
        # the final state alone; with --checkpoint-every/--resume the
        # engine owns the directory and has saved the whole carry there
        save_checkpoint(args.checkpoint_dir, res.rounds_run, res.state,
                        extra={"algo": args.algo})
        log.info("checkpoint written to %s", args.checkpoint_dir)
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


def _log_uplink(parsed, faults, screening, args):
    if faults is not None:
        log.info("fault injection: %s at rate(s) %s (on the device, "
                 "stateless per-round keys)",
                 ",".join(parsed["fault_kinds"]),
                 ",".join("%g" % r for r in parsed["fault_rates"]))
    if screening is not None:
        log.info("upload screening: finite check%s before eq. (11)",
                 (" + norm clip at %g" % parsed["clip_norm"])
                 if parsed["clip_norm"] else "")
    if parsed["quorum"]:
        log.info("quorum: rounds with < %d accepted uploads degrade to "
                 "recorded no-ops", parsed["quorum"])
    if parsed["deadline_s"] is not None:
        log.info("round deadline: %.3g simulated seconds (late clients "
                 "re-arrive next round)", parsed["deadline_s"])
    if parsed["watchdog"]:
        log.info("divergence watchdog: rollback after %d rounds above "
                 "%.2gx the best f̄", parsed["watchdog_patience"],
                 parsed["watchdog_factor"])
    if parsed["checkpoint_every"]:
        log.info("checkpointing the round carry every %d rounds to %s%s",
                 parsed["checkpoint_every"], args.checkpoint_dir,
                 " (resuming)" if parsed["resume"] else "")
    if parsed["compression"] is not None:
        log.info("uplink compression: %s codec%s%s", parsed["compression"],
                 " + error feedback" if parsed["error_feedback"] else "",
                 (" (frac=%.2f)" % parsed["topk_frac"])
                 if parsed["compression"] == "topk" else "")
    if parsed["bandwidth_bps"] is not None:
        log.info("byte-accurate comm clock: %.3g bytes/s per client",
                 parsed["bandwidth_bps"])


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
    ap.add_argument("--no-flat", action="store_true",
                    help="run the per-leaf pytree rounds instead of the "
                         "flat-buffer rounds (ravel-once (m, N) client "
                         "state, one fused update); the same results, bit "
                         "for bit on the CPU")
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
    ap.add_argument("--compression", default="none",
                    choices=["none", "bf16", "int8", "topk"],
                    help="uplink codec on the flat comm buffer: none (the "
                         "uncompressed round, bit for bit), bf16 (2 "
                         "B/lane), int8 (per-client affine, stochastic "
                         "rounding), topk (the --topk-frac largest-|.| "
                         "lanes)")
    ap.add_argument("--topk-frac", type=float, default=None,
                    help="fraction of lanes --compression topk keeps "
                         "(default 0.1)")
    ap.add_argument("--error-feedback", action="store_true",
                    help="carry each client's codec residual into its next "
                         "upload (one more (m, N) buffer); needs a lossy "
                         "--compression")
    ap.add_argument("--bandwidth-bps", type=float, default=0.0,
                    help="per-client link bytes/s for --clock: the codec's "
                         "exact wire prices the simulated time, and the "
                         "run reports bytes_up/bytes_down")
    ap.add_argument("--faults", default="",
                    help="comma-separated fault kinds injected into the "
                         "uploads on the device: crash, nan, inf, explode "
                         "(scale by --fault-scale), replay")
    ap.add_argument("--fault-rate", default="",
                    help="per-client per-round probability of --faults: one "
                         "value, or one a kind; default 0.05")
    ap.add_argument("--fault-scale", type=float, default=1e6,
                    help="the explode fault's multiplier")
    ap.add_argument("--screening", action="store_true",
                    help="drop uploads with a non-finite entry before "
                         "eq. (11)")
    ap.add_argument("--clip-norm", type=float, default=0.0,
                    help="screening's norm clip: finite uploads above this "
                         "l2 norm are scaled onto it (needs --screening)")
    ap.add_argument("--quorum", type=int, default=0,
                    help="accepted uploads a round needs to commit; below "
                         "it the round is a recorded no-op (degraded)")
    ap.add_argument("--deadline-s", type=float, default=0.0,
                    help="--clock rounds close this many simulated seconds "
                         "apart, whoever finished (needs --quorum)")
    ap.add_argument("--watchdog", action="store_true",
                    help="roll the state back to its best round after "
                         "--watchdog-patience rounds above "
                         "--watchdog-factor times the best f")
    ap.add_argument("--watchdog-patience", type=int, default=None,
                    help="diverged rounds before a rollback (default 3)")
    ap.add_argument("--watchdog-factor", type=float, default=None,
                    help="divergence threshold relative to the best f "
                         "(default 2.0, > 1)")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save the run's whole carry to --checkpoint-dir "
                         "every this many rounds (a fixed --chunk; the "
                         "chunked driver or --store offload)")
    ap.add_argument("--resume", action="store_true",
                    help="go on from the newest checkpoint under "
                         "--checkpoint-dir (a fresh start where none)")
    ap.add_argument("--checkpoint-dir", default="",
                    help="where --checkpoint-every and --resume write and "
                         "read; alone, the final state is saved there")
    ap.add_argument("--arch", choices=list_architectures(),
                    help="train this transformer instead of --problem")
    ap.add_argument("--reduced", action="store_true",
                    help="the architecture's reduced config (2 layers, "
                         "d_model <= 256)")
    ap.add_argument("--batch", type=int, default=2,
                    help="--arch: sequences a client")
    ap.add_argument("--seq-len", type=int, default=64,
                    help="--arch: tokens a sequence")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--kernel", default="auto",
                    choices=("auto", "on", "off", "interpret"),
                    help="the round's fused update: auto (the CUDA kernel "
                         "on the card, its plain version on the CPU), on, "
                         "off (the plain version anywhere); interpret is "
                         "rejected")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
