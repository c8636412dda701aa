#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits non-zero) on failure:

1. Build: compile every CUDA source of the port with nvcc (in parallel)
   and print the card's name and power limit.
1b. The threefry stream on the host (`core/prng.py`): the paper run's
   first three FedGiA splits (m = 128, alpha = 0.5, `prng_key(1)`) must
   select the clients that the reference selects (constants below,
   computed once from the JAX package).
2. FedGiA main path, through `repro_torch.launch.train`, with every
   kernel's launch count set to 0 just before each run and read just
   after. Each run takes the default driver, the chunked one, which
   replays each chunk of rounds as a CUDA graph (eq. (35) checked on the
   card, rounds after the stop skipped by conditional graph nodes):
   * the paper run at the CLI defaults (linreg, m=128, n=100, d=12800,
     k0=5, alpha=0.5, scalar H, tol 1e-7, up to 500 rounds) on the card;
     again with the eager `--no-scan` loop on the card (the same rounds,
     a final state bitwise equal); and on the CPU with the plain versions:
     card and CPU stop early at the same round (or one apart when the
     metric lies within fp noise of tol) with the same final f (rel
     1e-5);
   * the population run (m=16384, n=1024, d=262144, diag_ema H, 20
     rounds), replayed and eager, held to each other the same way: every
     (m, N) fp32 buffer is 64 MiB, above the 50 MB L2;
   * a one-client run (m=1, n=1024, sigma_t=6), which takes the
     single-client launch.
   Launches under replay are those the card executed: the donated kernel
   once a paper round, the batched one 20 times, the single one 5 times.
   Per-round times, replayed and eager, and the capture time apart.
2b. The paper's comparison baselines (FedAvg, FedProx, FedPD, SCAFFOLD),
   with counts reset just before each run and read just after:
   * each at the paper run's size (`--algo X --lr a` with a from the
     runners' ALGO_HPARAMS, tol 1e-7), replayed against eager
     `--no-scan` over BASELINE_PAIR's 100 rounds (the same rounds, a
     final state bitwise equal) and on the card against the CPU over up
     to 500 rounds (FedProx and FedPD over BASELINE_PAIR's 100:
     CPU_PAIR_ONLY) (the same rounds under the rule above, f at rel
     1e-5); no hand-written kernel is launched;
   * each at the population size (20 rounds, tol 0, on the population
     run's own data, through `engine.run_rounds`), replayed against
     eager, the bit patterns of the final states compared (a value that
     is not finite is reported, not hidden); beside phase 2's FedGiA run,
     the device cost of k0 or k0*inner_steps gradients a round against
     FedGiA's one (paper Table I);
   * Table IV's linreg rows at k0 = 5 (six algorithms, one trial) through
     `repro_torch.benchmarks.table4`, printed as CSV, and the quickstart's
     two lines (`repro_torch.examples.quickstart`): the FedGiA_D rows
     launch `fedgia_update_batched` once a round that ran, and nothing
     else launches a kernel.
   Per-round times, replayed and eager, and the phase's own time.
2c. The rest of the paper's §V, counts reset just before each run and
   read just after:
   * Fig. 3 (`repro_torch.benchmarks.fig3_alpha`: FedGiA_D, k0 = 10, the
     engine's uniform policy at alpha 0.1-1.0) on the card and on the
     CPU, which draw the same masks: the same rounds under the rule
     above, f at rel 1e-5, `fedgia_update_batched` once a round that
     ran, and the runner's max CR <= 3·min CR;
   * the paper run under `--participation uniform --alpha 0.25` (the
     donated kernel once a round), card against CPU;
   * FedGiA_D at the population size (20 rounds, tol 0, on the
     population run's own data) under the uniform (0.1), weighted
     (weights 1 + i mod 4), cyclic (0.25), straggler (0.2) and periodic
     policies, and SCAFFOLD under uniform 0.25: each replayed against
     eager, final states bitwise equal, 20 launches for FedGiA and none
     for SCAFFOLD; the replayed time a round with the host's mask draws
     apart;
   * the population run with `chunk_size="auto"`: the chosen length, and
     a final state bitwise equal to the one-chunk run's, with the peak
     device memory of each;
   * Table IV's logreg and ncvx_logreg rows at k0 in {1, 5, 10}, one
     trial, as CSV (FedGiA_D launches once a round), and the FedGiA_D
     and FedGiA_G rows at k0 = 5 held against the CPU;
   * the paper run with `--unrolled`: no launch, and the collapsed run's
     rounds and f (rel 1e-5);
   * `repro_torch.benchmarks.kernels_bench` (CUDA-event times).
2d. The client stores, counts reset just before each run and read just
   after:
   * all five algorithms at the population size (20 rounds, tol 0, on the
     population run's own data) under uniform alpha 0.1 (a 1638-row
     tile), FedPD at lr 0.001 (it diverges at 0.05 there):
     `store="active"` against `store="dense"` in the chunked driver,
     final states compared by bit pattern (held to STATE_RTOL where cuBLAS
     picks another algorithm for the tile's batch, and said so); FedGiA
     launches `fedgia_update_batched` once a round under each store;
     `store="offload"` for FedPD, SCAFFOLD and FedGiA, bitwise the active
     run, with its host copy time and extras; `aggregate="packed"`
     against the dense aggregate for FedAvg and SCAFFOLD (normwise
     PACKED_RTOL: another order of the sum);
     the ms a round of each store with the host's draws and packs apart;
   * the paper run under `--participation uniform --alpha 0.25 --store
     active` for FedGiA (the donated kernel once a round) and SCAFFOLD,
     card against CPU;
   * `repro_torch.benchmarks.engine_bench` at m = 10^6, alpha = 10^-4:
     FedAvg active and FedPD offload + packed rounds/s, and the offload
     tile round's device peak below the 512 MB (m, N) lambda buffer.
2e. Async and clocked rounds, counts reset just before each run and
   read just after:
   * `repro_torch.benchmarks.async_bench` (m = 64, k0 = 10, periodic
     arrivals, max_staleness 0, 1, 2, 4; FedGiA_D and SCAFFOLD) on the
     card and on the CPU: the same CR and staleness every round, Obj at
     rel 1e-3, staleness within its bound; FedGiA_D launches
     `fedgia_update_batched` once a round that ran, with an (m, N)
     anchor wherever max_staleness > 0;
   * `repro_torch.benchmarks.wallclock_bench` (spreads 1, 4, 16; uniform
     and poly weights; FedGiA_D, SCAFFOLD, FedAvg; up to WALLCLOCK_ROUNDS
     rounds) on the card and on the
     CPU: the same CR, staleness and simulated time every round, Obj at
     rel 1e-3 (in both runners a row may stop one round apart where the
     longer run's stop metric lies within ROW_STOP_RTOL of tol; such a
     row is re-run in float64 on the CPU and its metrics printed);
     engine_bench's async row (FedGiA_D, m = 64, 200 rounds, against
     the same rounds synchronous);
   * FedGiA_D on the population run's data under a straggler clock
     (compute seconds spread 1..16), max_staleness 4, poly weights, 20
     rounds, replayed against eager (bitwise, staleness and simulated
     time included): 20 launches of `fedgia_update_batched`, each with an
     (m, N) anchor; that form held against its plain version on the next
     round's own operands and timed against its bound; ms a round and
     the host's draws. Then 6 rounds of the same data under uniform
     arrivals at alpha 0.5 (a mixed round: half the rows on the ADMM
     branch, the rest on anchors up to 4 rounds old), and the launch held
     and timed again on the 7th round's operands;
   * SCAFFOLD under uniform alpha 0.1, `--async --max-staleness 2`,
     active against dense, and FedPD (lr 0.001) offloaded against
     active, each bitwise, with the offload row's device peak and
     host-resident bytes.
2f. Uplink codecs, faults, the guard and checkpoints on the population
   run's data (FedGiA_D, 20 rounds, tol 0), counts reset just before
   each run and read just after:
   * the device threefry (`core/prng.py`'s torch forms): rows 0, 1,
     8191 and 16383 of a (16384, 1024) draw of `random_bits`, `uniform`
     and `randint` 2^16 bit for bit the numpy forms, each draw timed;
   * `compression="none"` bitwise the run without it; bf16, int8
     (stochastic, error feedback) and top-k 0.1 (error feedback),
     replayed against eager (bitwise), ms a round against uncompressed;
     on round 5's operands the card's bf16 decode, int8 levels q and
     top-k kept lanes equal the CPU's;
   * crash, nan, replay and explode at 0.02 with screening (clip 100), a
     quorum of m/4 and the watchdog, for FedGiA_D and FedAvg under
     uniform alpha 0.5: every round's fault hits on the card equal the
     numpy chains' draw, each round's `screened` count is that draw's
     survivors, and `screened`, `degraded`, `rollback` and the state are
     equal between the chunked driver and `--no-scan`;
   * the int8 + EF run checkpointed every 8 rounds and resumed from 16:
     history and state bitwise the uninterrupted run's;
   * `wallclock_bench.run_compression`, `run_overlap` (barrier against
     overlapped rounds) and `run_faults` on the card and
     on the CPU, held row by row as phase 2e's rows (the int8 row,
     stochastic, to both reaching the target; a row that reaches it on
     neither side, top-k, by its rounds, times and bytes).
2g. Federated training of the dense transformers (`--arch`), counts
   reset just before each run and read just after, each run's peak
   device memory, f every round (finite), r_hat and sigma printed:
   * tinyllama-1.1b at full width and depth (22 layers, d_model 2048,
     N = 1,100,048,384), m = 2, 5 rounds, sigma_t 30, the CLI's other
     defaults (scalar H, bf16 gradients, fp32 state), in the chunked
     driver (one captured chunk) and with `--no-scan`: the donated
     kernel once a round, the same f every round and final states bit
     for bit; the split of one eager round (torch.profiler, at most
     FULL_WIDTH_ATTEMPTS sessions), whole only where every step the
     round runs timed > 0 (`split_is_whole`), else timed by CUDA events and
     printed as flagged spans; then the round after the last one's
     `fedgia_update` at
     (2, N) in three forms (undonated with the 0-d h, donated with it,
     undonated with h (m, N)), each launched once and held to its plain
     version on every 16M-column tile (bitwise expected), the donated
     and the h (m, N) forms timed against their bounds, the plain
     version timed in tiles;
   * phase 2j, the planning dry run held against the card on that
     model's live state, between the split and the update's forms:
     `repro_torch.launch.dryrun.dryrun_one` at phase 2g's shapes (m = 2,
     batch 2 x 64, bf16 gradients, fp32 state, scalar H) on a 1 x 1
     mesh (nothing modelled), traced on fake CPU tensors, against one
     more eager donated round on the state under FlopCounterMode, its
     peak device memory reset before it: the traced FLOPs equal the
     counted ones (rel DRYRUN_FLOPS_RTOL), the argument bytes equal the
     bytes the round reads less the flat buffers' padding and the
     tokens' int64 (the dry run takes the reference's int32), and
     argument + output + temp within DRYRUN_MEMORY_RTOL of the round's
     peak less the device memory it does not read (the raw peak printed
     beside); the roofline terms beside a timed eager round; then the
     full-width production record (tinyllama-1.1b train_4k on 16 x 16,
     its tensor parallelism modelled) with its host trace time;
   * the same model under `--h-policy diag_ema`, 3 rounds, `--no-scan`
     (the chunked driver's warm-up copies would not fit): the batched
     kernel once a round; this run and the `--no-scan` one take the
     first run's r_hat probe (`memo_probe`: the same weights, batch and
     keys, so the same value; a cut of 31 s, PERF.md §4);
   * reduced tinyllama-1.1b, qwen1.5-0.5b and rwkv6-3b `--arch` runs
     (bf16, 8 rounds) on the card and on the CPU: f every round within
     TRAIN_CPU_RTOL, r_hat within PROBE_CPU_RTOL, f falling;
   * the paper run with `--kernel on` and `--kernel off` (the update's
     plain version on the card): no launch with off, the same f every
     round and a bitwise final state;
   * `repro_torch.examples.fl_transformer` at its defaults (fl-lm-134m,
     float32, m = 4, diag_ema, 40 rounds in chunks of 10): its own
     check that f falls, and 40 batched launches.
   Phase 3 then re-checks that the serving prefill still launches flash
   22 times and the scan 32 times.
2h. The per-leaf pytree rounds (`--no-flat`) and the benchmark suite,
   counts reset just before each run and read just after:
   * the paper run with `--no-flat`, replayed and `--no-scan` (the same
     rounds, a final state bitwise equal), against the flat run of phase
     2 (the same rounds and key, so the same split every round; the
     history's largest difference and whether it is bitwise printed)
     and against the CPU's `--no-flat` run (`hold_card_to_cpu`);
   * FedGiA_D at the population size, flat and `--no-flat`, replayed,
     in this process (ms a round of each);
   * reduced tinyllama-1.1b in float32 with `--no-flat` (a multi-leaf
     tree; `engine.run_rounds`, the CLI has no dtype flag) on the card and
     on the CPU (f every round within TRAIN_CPU_RTOL), and its flat run's
     ms a round;
   * Lemma IV.1 on the card (LEMMA: tests/test_fedgia_convergence.py's
     setting): L(Z^k) printed each round, never rising by more than
     LEMMA_ATOL;
   every per-leaf run launching no kernel. Then `benchmarks.run --only
   engine --only kernels` writes BENCH_engine.json into a temporary
   directory (the million-client rows of phase 2d reused, not run
   again), which asserts `speedup_scan_vs_legacy > 1.0` and
   `speedup_flat_vs_pytree >= 0.98`, and `check_bench` gates it against
   the committed port baseline; the wallclock rows of phases 2e and 2f
   are written out and gated the same way (`check_bench --wallclock`).
   (The section's `sharded` and `scan_overlap` rows are CPU rows: a card
   run of the section leaves them out.)
2i. (Run last: once a child process has run these rounds on the card,
   this process's torch.profiler sessions record no device time.) The
   client-sharded round (`run_rounds(mesh=...)`,
   `launch/mesh.py`) in a child process started by the port's launcher
   at world size 1
   over NCCL on cuda:0 (no process group outlives the phase), on the
   population run's data passed to it (m=16384, n=1024, d=262144, 20
   rounds, FedProx and FedPD 10, tol 0): FedGiA_D, FedGiA with scalar H and the four baselines
   (at SHARDED_LR, their population lr), each barrier and overlapped
   (`overlap="scatter"`), in the chunked driver (5-round chunks, the
   NCCL collectives captured with the rounds) and `--no-scan`, every run held to the
   unsharded chunked run at STATE_RTOL / STATE_ATOL (history and every
   model-shaped state entry) and its ms a round printed beside the
   unsharded one; the FedGiA runs launch `fedgia_update_batched` (or
   its donated form) once a round, which joins the main path's count;
   one eager round of each profiled: one model-size all-reduce, at most
   one reduce-scatter and no all-gather barrier, zero model-size
   all-reduces, one reduce-scatter and one all-gather overlapped (c10d
   events, `launch/mesh.py::profile_collectives`); FedGiA_D chunked with
   tol SHARDED_TOL, each round and its collectives inside a conditional
   graph node; eq. (11)'s all-reduce alone timed with CUDA events. The
   sharded active store and uplink: FedGiA_D and SCAFFOLD under
   uniform alpha 0.1 with store="active" (capacity 1638, each shard's
   tile packed from its own rows), held to the unsharded
   aggregate="packed" run, and under int8 + EF + crash,nan at 0.05 +
   screening, held to the unsharded run of the same overlap, each
   barrier and overlapped, chunked and --no-scan, with one eager round
   of each profiled against the same budgets; their fedgia_update
   launches join the count. Then `--shard-clients 2` on this one-card
   machine must raise with the device count. NCCL across several cards
   is not exercised: one card.
3. Serving path, through `repro_torch.launch.serve` at full width with
   parameters drawn on the card from --seed, counts reset just before
   and read just after each run (after one short warm-up run each), each
   model served twice: with the default captured decode (one decode step
   captured as a CUDA graph, `core/graphs.py::scan_steps`, replayed a
   token) and with `--no-scan` (the same step eagerly):
   * tinyllama-1.1b, batch 4, prompt 2048, gen 32: exactly 22 flash
     attention launches (one per layer's prefill; the decode launches
     none);
   * rwkv6-3b, batch 4, prompt 1024, gen 32: exactly 32 WKV-scan
     launches.
   The two modes generate the same tokens and, expected, the same
   logits bit for bit (else held to CAPTURED_LOGIT_RTOL, and said so);
   prefill_s, capture_s, decode_s and tok/s/req of both are printed with
   the card. The first launch of each kernel in the captured runs
   (layer 0's prefill) is recorded, so that phase 5 checks and times the
   kernel on its own main-path inputs. Then the captured tinyllama decode
   with a float8_e4m3fn KV cache, fed the bf16 run's tokens: every
   step's logits within tests/test_serve.py's bound of the bf16 run's
   (err < 0.15·max|logit| + 0.5); and `repro_torch.examples.
   serve_requests` (reduced, bfloat16), captured and `--no-scan`, the
   same tokens.
3b. The head_dim-160 flash form and the MoE/MLA families, each model's
   weights drawn on the card from prng_key(0) (init_s timed), a warm-up
   `serve.generate` (gen 2), then the measured captured run with counts
   reset just before and read just after; prefill_s, decode tok/s/req,
   init_s, the peak device memory and the decode step's bound (weights
   read a step at 3.35 TB/s) printed with the card:
   * stablelm-12b at full width and depth (head_dim 160), batch 4,
     prompt 2048, gen 32: exactly 40 flash launches, the captured decode
     against --no-scan (tokens equal, logits bit for bit or within
     CAPTURED_LOGIT_RTOL); its layer-0 flash call held to the plain
     version at the bf16 tolerance and timed beside its bound and SDPA;
   * deepseek-v3-671b at full width, its 3 dense layers, 1 MoE layer and
     the MTP head (batch 4, prompt 256, gen 16; no flash launch: MLA
     attends with the plain blocked softmax) and arctic-480b at full
     width, 1 layer (the same sizes; 1 flash launch at H 56, Kv 8): the
     prefill's and each decode step's logits against the train forward
     over the same tokens at the reference's rtol 4e-2 / atol 8e-2;
     DeepSeek-V3's MoE layer on 64 tokens with nothing dropped against
     `moe_ref_dense`;
   * the reduced deepseek-v3-671b and arctic-480b `--arch` rounds in
     float32 (the CLI's config dtype replaced), card against CPU at
     TRAIN_CPU_RTOL.
3c. The hybrid SSM block and the embeds inputs at full width and depth,
   each model's weights drawn on the card from prng_key(0) (init_s
   timed), a warm-up (gen 2), then the measured runs with counts reset
   just before and read just after; prefill_s, capture_s, decode
   tok/s/req, the peak device memory and the decode step's bound printed
   with the card:
   * hymba-1.5b (32 layers; attention and SSM heads in parallel) through
     the serve CLI, batch 4, prompt 1024, gen 32, captured and
     `--no-scan`: exactly 32 flash launches each (GQA group 5 over 25
     heads), tokens equal and logits bit for bit or within
     CAPTURED_LOGIT_RTOL, and the SSM branch's share of a prefill (CUDA
     events around each layer's `ssm_apply`);
   * llava-next-mistral-7b, batch 4, 2880 patch embeddings and 128 text
     tokens a request (a 3008-position prompt), and musicgen-large,
     batch 4, 1500 frame embeddings, each gen 32 through
     `serve.generate(embeds=...)`: exactly 32 and 48 flash launches;
   * for each, the prefill's and every decode step's logits against the
     train forward over the same inputs: in bf16 the gap printed (at 32
     and 48 layers it nears or passes the reference's rtol 4e-2 / atol
     8e-2, in the reference too: tests/test_torch_hybrid_ssm.py), and a
     float32 copy of the weights, served captured, held at DECODE_RTOL /
     DECODE_ATOL;
   * each model's layer-0 flash call held to the plain version at the
     bf16 tolerance and timed beside its bound and SDPA;
   * the reduced float32 `--arch` rounds of the three, card against CPU
     at TRAIN_CPU_RTOL.
4. Card against CPU: the reduced tinyllama-1.1b and rwkv6-3b in float32,
   parameters made on the CPU and copied to the card, prefill of 64
   tokens and 8 decode steps on both, the card's decode captured, the
   CPU's eager: the same tokens, logits within 1e-4.
5. Kernels against their plain versions on the card: each
   `fedgia_update` form that a round launches (an (N,) anchor, a 0-d h
   under scalar H, no x') bitwise on the next round's inputs of the run
   that launched it, then timed eagerly and inside a replayed CUDA graph
   of 25 launches, beside the same kernel through the TPU kernels'
   interface (materialised (m, N) anchor and h, x' written); flash
   attention and the WKV scan on the prefill's layer-0 inputs and at
   edge cases (window, ragged length, MQA at head_dim 128, a single
   query, one whole tile and a ragged one, a GQA group of 8 at head_dim
   128 with a window, phase 3c's group of 5 over 25 heads, ragged 3008 at
   head_dim 128 and group 1 over 32 heads at 1500, float32 and bfloat16;
   the scan at one step and at head_dim 32), held to the tolerances of
   tests/test_kernels.py. Then
   CUDA-event times (median of 25 launches after warm-up) of each kernel
   at its main-path shape, of its plain version and, for flash
   attention, of PyTorch's `scaled_dot_product_attention` on the same
   inputs, beside the bound, with each kernel's rate and share of its
   bound.
6. (Run right after phase 2, before any other torch.profiler session:
   later in the script the profiler has lost the eager round's kernels,
   all of them in one run.) A `torch.profiler` split of one eager paper
   round and one eager population round (gradient, eq. (11), update
   kernel, H refresh, metrics, copies, other; idle against the
   unprofiled round time), and the device's busy share in the replayed
   runs; a session that lost the round's kernels is run again, at most
   three times, each printed. Where no session recorded device time, the
   round's steps are timed by CUDA events instead (spans, host launch
   time included), and said so.
7. Print one `{"kernels": [...]}` line, the card line again, and last
   `{"ok": true, "device": {...}}`.

It imports nothing of JAX or of the JAX package `repro`. There is no
fallback: without a CUDA device, or without `src/repro_torch` beside this
file, it exits non-zero before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
BF16_TENSOR_FLOPS = 989e12  # dense bf16 tensor-core peak, H100 SXM
FP32_FLOPS = 67e12  # fp32 peak outside the tensor cores, H100 SXM
# kernel vs plain version: the same IEEE operations in the same order
# (the kernel is built with --fmad=false), so bitwise is expected; the
# check allows 2 float32 ulps
RTOL = 2.4e-7
REPS, WARMUP = 25, 3
ATTEMPTS = 3  # profiler sessions for one split or busy time, at most
# a cut of depth for the script's time (PERF.md §4): phase 2g's
# full-width split takes one profiler session before its CUDA-event
# spans (in earlier proof runs every full-width session lost eq. (11))
FULL_WIDTH_ATTEMPTS = 1
# replayed vs eager rounds on the card: the same kernels in the same
# order, so bitwise is expected; were cuBLAS to pick another algorithm
# inside a graph, the states would be held to the port's per-round fp32
# parity tolerance instead (tests/test_torch_fedgia.py), and say so
STATE_RTOL, STATE_ATOL = 1e-5, 1e-6

PAPER = ["--rounds", "500"]
PAPER_TOL = 1e-7  # the CLI's default --tol
# a cut of depth for the script's time (PERF.md §4): phase 2b's baselines
# hold replayed against eager (bitwise, so at any length) over this many
# rounds of the paper run, and card against CPU over PAPER's 500 (their
# eager runs took 60-100 s of a slow host's 212 s phase)
BASELINE_PAIR = ["--rounds", "100"]
# a cut of depth for the script's time (PERF.md §4): the baselines that
# take k0·inner_steps = 25 gradients a round hold card against CPU over
# BASELINE_PAIR's rounds (their CPU runs over PAPER's 500 took 20.5 s
# each); FedAvg and SCAFFOLD still over 500 (SCAFFOLD's f parts by 1.8e-5
# at 250 rounds)
CPU_PAIR_ONLY = ("fedprox", "fedpd")
# a cut of depth for the script's time (PERF.md §4): phase 2e's
# wallclock_bench rows run to 100 rounds on the card and on the CPU (the
# reference's 400: its rows that converge do so by round 56, and the
# others never converge; their CPU side took 80 s of the phase at 200)
WALLCLOCK_ROUNDS = 100
BASELINES = ("fedavg", "fedprox", "fedpd", "scaffold")
POPULATION = ["--clients", "16384", "--dim", "1024", "--samples", "262144",
              "--rounds", "20", "--tol", "0", "--h-policy", "diag_ema"]
# sigma_t = 6 is the theory's guaranteed regime (sigma >= 6 r / m, Lemma
# IV.1); at the default 0.15 a lone client diverges
ONE_CLIENT = ["--clients", "1", "--dim", "1024", "--samples", "4096",
              "--sigma-t", "6", "--rounds", "5", "--tol", "0"]

# phase 2d: the client stores at the population size under uniform alpha
# 0.1 (1638 of 16384 clients a round). FedPD's lr: its population run
# diverges at the runners' 0.05 (ROADMAP queue 3 k: lr·L_max must stay
# below 2, and the clients' L reach about 1250), so it takes 0.001 here
STORE_ALPHA = 0.1
STORE_FEDPD_LR = 0.001
# packed against dense aggregate: the sum of 1638 rows in another order,
# about sqrt(1638)·eps = 5e-6 a round, over 20 rounds
PACKED_RTOL = 1e-4

# phase 2e: the population data under a straggler clock (wallclock_bench's
# worst spread, its staleness bound), and the stores' async rows
ASYNC_SPREAD = 16.0
ASYNC_MAX_STALENESS = 4
ASYNC_STORE_STALENESS = 2
# the mixed round's arrivals and the rounds run before it
ASYNC_MIXED_ALPHA = 0.5
ASYNC_MIXED_ROUNDS = 6
# a runner row's Obj, card against CPU (the paper runs' rule for whole
# runs)
ROW_OBJ_RTOL = 1e-3
# a runner row's card and CPU runs may stop one round apart where the
# longer run's stop metric at the shorter's last round lies within this
# share of tol (the paper runs' rule, `hold_card_to_cpu`, whose 1 % the
# runners' rows outgrow): |mean gradient|^2 near 1e-7 is a difference of
# gradients a thousand times larger. async_bench's SCAFFOLD at bound 0
# stops a round earlier on an NVIDIA H100 80GB HBM3 (700.00 W) than on
# the CPU, whose metric there is +1.6 % of tol off it (the card's -1.0
# %); the same row in float64 on the CPU (`fp64_witness`) is -8.1 % of
# tol there, so float32 alone moves the metric 7-10 % of tol, and card
# against CPU 2.6 %.
ROW_STOP_RTOL = 3e-2
ROW_KEYS = ("algo", "max_staleness", "spread", "weighting")

# phase 2g: federated training of tinyllama-1.1b at full width and depth
# (22 layers, d_model 2048, N ~ 1.1e9), m = 2, the CLI's other defaults
# (k0 5, alpha 0.5, scalar H, batch 2, seq 64); sigma_t = 30 as
# examples/fl_transformer.py (t < 1 diverges for transformers)
TRAIN_FULL = ["--arch", "tinyllama-1.1b", "--algo", "fedgia", "--clients",
              "2", "--rounds", "5", "--tol", "0", "--sigma-t", "30",
              "--log-every", "1"]
# diag_ema at full width runs in the eager loop: the chunked driver's
# warm-up round on copies of the (x, z, pi, h) state would need about 92
# GiB of the card's 80 GB (PERF.md §5), so it is not run, and said so
TRAIN_DIAG = ["--arch", "tinyllama-1.1b", "--algo", "fedgia", "--clients",
              "2", "--rounds", "3", "--tol", "0", "--sigma-t", "30",
              "--h-policy", "diag_ema", "--no-scan", "--log-every", "1"]
# reduced --arch runs, card against CPU: tests/test_torch_train_cli.py's
# acceptance settings at 8 rounds, but sigma_t = 3: at 0.3 the reduced
# qwen1.5 diverges from round 3 (on the CPU too)
TRAIN_REDUCED = ["--reduced", "--algo", "fedgia", "--clients", "4", "--k0",
                 "3", "--alpha", "1.0", "--sigma-t", "3", "--rounds", "8",
                 "--tol", "0", "--batch", "2", "--seq-len", "32"]
# card against CPU in bfloat16: every matmul rounds its output to bf16
# after another order of sums (cuBLAS against the CPU's GEMMs), and the
# runs part at bf16 resolution, as the port and the reference do on the
# CPU (tests/test_torch_train_cli.py); here every round's f within rtol
# 5e-2 of the CPU's value for that round, no atol (measured on the H100:
# at most 2.2e-2, RWKV-6), and r_hat (a bf16 probe) at 5e-2
TRAIN_CPU_RTOL, PROBE_CPU_RTOL = 5e-2, 5e-2
# normal_t on the card against the numpy form: the same integers and
# uniform floats, CUDA's log1pf against the C library's; a draw further
# than NORMAL_MAX_ULPS (the CPU's bound is 4) would be a fault, not ulps
NORMAL_SEED, NORMAL_WORDS, NORMAL_MAX_ULPS = 5, 1 << 22, 64
# the full-width update held against its plain version a column tile at a
# time (the plain version's temporaries at (2, N) would not fit)
TILE_COLUMNS = 1 << 24
# phase 2j: the dry run's traced FLOPs against FlopCounterMode on the
# eager round (the same aten products at the same shapes: equal
# expected) and its argument + output + temp against the round's peak
DRYRUN_FLOPS_RTOL, DRYRUN_MEMORY_RTOL = 1e-3, 0.10

# phase 2h: the per-leaf rounds (--no-flat) and the benchmark suite.
# Lemma IV.1 in tests/test_fedgia_convergence.py's setting: m 8, n 30,
# d 640 (linreg seed 3), k0 5, alpha 0.5, sigma_t 6 (sigma >= 6 r / m),
# scalar H, the state's key prng_key(7); L(Z^k) may rise by LEMMA_ATOL
LEMMA = dict(m=8, n=30, d=640, seed=3, key=7, rounds=30)
LEMMA_ATOL = 1e-6
# the reduced tinyllama-1.1b in float32 (phase 2g's reduced settings):
# card against CPU per round at phase 2g's TRAIN_CPU_RTOL
TREE_ARCH = dict(arch="tinyllama-1.1b", m=4, k0=3, alpha=1.0, sigma_t=3.0,
                 rounds=8, batch=2, seq=32)

# full width; the warm-up run before each takes the same prefill, gen 2
TINYLLAMA = ["--arch", "tinyllama-1.1b", "--batch", "4", "--prompt-len",
             "2048", "--gen", "32", "--seed", "0"]
RWKV6 = ["--arch", "rwkv6-3b", "--batch", "4", "--prompt-len", "1024",
         "--gen", "32", "--seed", "0"]
# card vs CPU at reduced size, float32: the logits differ by the order of
# fp32 sums (cuBLAS vs CPU GEMMs, the kernels vs their plain versions)
PARITY_TOL = 1e-4
PARITY_PROMPT, PARITY_GEN = 64, 9  # the prefill's token, then 8 decode steps
# captured decode against --no-scan at full width: the same kernels on the
# same inputs, so bit for bit is expected; were cuBLAS to pick another GEMM
# algorithm inside the capture, the bf16 logits would be held to this
# share of the largest logit instead (and the script says so)
CAPTURED_LOGIT_RTOL = 2e-2
# the paper run's first three FedGiA splits (m = 128, alpha = 0.5, the
# state's key prng_key(1)): the clients the reference's threefry chain
# selects (split, then fold_in of the round), computed once in JAX 0.9.0
PRNG_KNOWN_M, PRNG_KNOWN_ALPHA, PRNG_KNOWN_SEED = 128, 0.5, 1
PRNG_KNOWN_IDS = (
    [0, 1, 2, 3, 7, 9, 12, 13, 14, 16, 18, 19, 20, 21, 23, 24, 27, 28, 31,
     32, 36, 39, 40, 43, 44, 46, 48, 49, 51, 57, 58, 59, 60, 61, 63, 64, 65,
     66, 73, 74, 78, 85, 88, 90, 92, 93, 98, 99, 101, 103, 104, 105, 107,
     108, 109, 110, 111, 112, 113, 115, 118, 121, 123, 127],
    [0, 3, 4, 8, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 23, 24, 25, 26, 27,
     28, 33, 34, 37, 41, 43, 47, 49, 50, 53, 56, 57, 58, 61, 62, 63, 65, 67,
     68, 70, 71, 73, 75, 79, 81, 83, 84, 85, 88, 89, 90, 92, 94, 95, 101,
     102, 105, 112, 114, 116, 118, 120, 123, 124, 125],
    [0, 1, 2, 6, 7, 10, 12, 13, 14, 15, 17, 21, 26, 27, 28, 31, 33, 34, 36,
     41, 44, 49, 50, 51, 52, 57, 58, 61, 64, 65, 66, 70, 73, 74, 78, 79, 80,
     82, 84, 85, 86, 87, 88, 89, 93, 95, 98, 99, 102, 103, 105, 106, 107,
     109, 113, 114, 119, 121, 122, 123, 124, 125, 126, 127],
)
# phase 3b: the hd-160 flash form, the MoE/MLA families. StableLM-2-12B
# at full width and depth (40 layers, head_dim 5120 / 32 = 160); the two
# MoE models at full width with their depth cut to fit one 80 GB card:
# DeepSeek-V3's 3 dense layers and 1 MoE layer (with its MTP head, which
# serving does not read), Arctic's 1 layer. The warm-up call before each
# takes the same prefill, gen 2
STABLELM = dict(arch="stablelm-12b", layers=40, batch=4, prompt=2048,
                gen=32)
MOE_MODELS = (dict(arch="deepseek-v3-671b", layers=4, batch=4, prompt=256,
                   gen=16),
              dict(arch="arctic-480b", layers=1, batch=4, prompt=256,
                   gen=16))
# phase 3c: the hybrid SSM block and the embeds inputs at full width and
# depth. Hymba-1.5B (32 layers, 25 heads over 5 KV heads, head_dim 64)
# through the serve CLI, captured and --no-scan, on weights drawn once
# from prng_key(0); LLaVA-NeXT on Mistral-7B with a 2880-patch anyres
# prefix (5 tiles of 576) and 128 text tokens (a 3008-position prompt at
# head_dim 128); MusicGen-large with 1500 EnCodec frame embeddings (30 s
# at 50 Hz; 32 heads, group 1). The embeddings are float32 standard
# normals from numpy's default_rng(0), as `synthetic_batch_for` draws
# them. The warm-up call before each takes the same prefill, gen 2
HYMBA = ["--arch", "hymba-1.5b", "--batch", "4", "--prompt-len", "1024",
         "--gen", "32", "--seed", "0"]
EMBEDS_MODELS = (dict(arch="llava-next-mistral-7b", batch=4, frames=2880,
                      prompt=128, gen=32),
                 dict(arch="musicgen-large", batch=4, frames=1500, prompt=0,
                      gen=32))
SLICE14_ARCHS = ("hymba-1.5b", "llava-next-mistral-7b", "musicgen-large")
# prefill + decode against the train forward: the reference's own bounds
# for two computations of the same bf16 logits (tests/test_serve.py,
# test_decode_matches_forward)
DECODE_RTOL, DECODE_ATOL = 4e-2, 8e-2
# the router's logits (log-probabilities less their mean, spread ~1 at
# init) of the two computations: bf16 GEMMs of other shapes below the
# MoE layer move them by ulps of their inputs; a decode reading the wrong
# position or cache slot would move them by O(1)
ROUTER_DRIFT = 0.1
# the no-drop MoE layer (4 x 16 = 64 tokens) against the dense oracle,
# both in bf16 on the same weights: the same bound (the two sum the k
# experts' outputs in other orders and roundings, fp32 slot space against
# the oracle's bf16 running sum); CAPACITY_FACTOR raised so that C >= B k
MOE_DENSE_SHAPE = (4, 16)
# kernel vs plain version: the tolerances of tests/test_kernels.py
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2.5e-2}
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
SCAN_STATE_TOL = dict(rtol=1e-4, atol=1e-3)

TPU_KERNELS = {
    "fedgia_update_batched":
        "src/repro/kernels/fedgia_update/kernel.py:133",
    "fedgia_update_batched_donated":
        "src/repro/kernels/fedgia_update/kernel.py:150",
    "fedgia_update_single":
        "src/repro/kernels/fedgia_update/kernel.py:166",
    "flash_attention": "src/repro/kernels/flash_attention/kernel.py:99",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan/kernel.py:65",
}
_FEDGIA_SOURCE = "src/repro_torch/kernels/fedgia_update/csrc/fedgia_update.cu"
SOURCES = {
    "fedgia_update_batched": _FEDGIA_SOURCE,
    "fedgia_update_batched_donated": _FEDGIA_SOURCE,
    "fedgia_update_single": _FEDGIA_SOURCE,
    "flash_attention":
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
    "rwkv6_scan": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
}


def say(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def done_line(tag, res):
    return (f"{tag}: done: {res['rounds']} rounds (CR={res['cr']}) in "
            f"{res['wall_s']:.2f}s  f={res['final_f']:.6f} "
            f"err={res['final_err']:.2e}")


def reset_counts(counters):
    for mod in counters:
        mod.reset_launches()


def read_counts(counters):
    return {k: v for mod in counters for k, v in mod.launches.items()}


def run_main_path(train, counters, argv):
    """One CLI run on the card, launch counts reset before, read after."""
    reset_counts(counters)
    res = train.main(argv)
    return res, read_counts(counters)


class LogRecords(logging.Handler):
    """Keeps the records of a logger, to read the numbers of its lines."""

    def __init__(self):
        super().__init__()
        self.records = []

    def emit(self, record):
        self.records.append(record)


def record_first_call(mod, name, store):
    """Replace `mod.name` by a function that records a copy of the
    arguments of its first call into `store` and calls the original.
    Returns the function that puts the original back."""
    real = getattr(mod, name)

    def wrapped(*args, **kwargs):
        if not store:
            store.append(([a.clone() for a in args], dict(kwargs)))
        return real(*args, **kwargs)

    setattr(mod, name, wrapped)
    return lambda: setattr(mod, name, real)


def serve_main_path(serve, counters, argv, mod, name, params=None,
                    prompts=None):
    """A warm-up serve run, then the measured one: counts reset before and
    read after, the first call of `mod.name` recorded, the prefill and
    decode times read from serve's log lines (and the capture's, when the
    decode was captured), the logits that `generate` returned kept.
    `params` and `prompts` go to `serve.serve` (None: the CLI draws them
    from --seed). Returns (tokens, counts, times, the recorded call,
    logits)."""
    def run(args):
        return serve.serve(serve.build_parser().parse_args(args), params,
                           prompts)

    warm = list(argv)
    warm[warm.index("--gen") + 1] = "2"
    run(warm)
    logs = LogRecords()
    serve.log.addHandler(logs)
    store, seen = [], []
    restore = record_first_call(mod, name, store)
    generate = serve.generate

    def keep(*args, **kwargs):
        res = generate(*args, **kwargs)
        seen.append(res["logits"])
        return res

    serve.generate = keep
    try:
        reset_counts(counters)
        tokens = run(argv)
        counts = read_counts(counters)
    finally:
        serve.generate = generate
        restore()
        serve.log.removeHandler(logs)
    t_prefill, n_tok, t_decode, tok_s = next(
        r.args for r in logs.records if r.msg.startswith("prefill"))
    times = {"prefill_s": t_prefill, "prefill_tokens": n_tok,
             "decode_s": t_decode, "decode_tok_s_req": tok_s,
             "capture_s": next((r.args[0] for r in logs.records
                                if r.msg.startswith("capture_s")), None)}
    return tokens, counts, times, (store[0] if store else None), seen[0]


def fp8_cache_run(serve, graphs, Transformer, get_config, argv, logits16,
                  tokens16, card):
    """The captured tinyllama decode with a float8_e4m3fn KV cache, fed
    the bf16 run's own tokens (teacher forcing, as tests/test_serve.py's
    fp8 test feeds both caches the same tokens), on the same parameters
    and prompts (`serve` draws both from --seed on the card). Each step's
    logits are held to that test's bound against the bf16 run's:
    err < 0.15·max|logit| + 0.5."""
    arch, seed = argv[1], int(argv[argv.index("--seed") + 1])
    batch = int(argv[argv.index("--batch") + 1])
    P = int(argv[argv.index("--prompt-len") + 1])
    gen = int(argv[argv.index("--gen") + 1])
    cfg = get_config(arch)
    from repro_torch.core.prng import prng_key

    model = Transformer(cfg, "cuda").init(prng_key(seed))
    rng = torch.Generator(device="cuda").manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab_size, (batch, P), generator=rng,
                            device="cuda")
    fp8 = torch.float8_e4m3fn
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first, cache = model.prefill(prompts, cache_len=P + gen, cache_dtype=fp8)
    feed = tokens16.cuda().T[:gen - 1, :, None].contiguous()  # (gen-1, B, 1)

    def step(carry):
        c, i, pos = carry
        tok = feed.index_select(0, i.view(1))[0]
        lg, c = model.decode_step(c, tok, pos)
        return (c, i + 1, pos + 1), lg

    run = graphs.scan_steps(step, gen - 1)
    carry = (cache, torch.zeros((), dtype=torch.long, device="cuda"),
             torch.tensor(P, dtype=torch.int32, device="cuda"))
    _, lg8 = run(carry)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if cache["dense"]["k"].dtype != fp8:
        raise SystemExit("fp8 run: the cache is not float8_e4m3fn")
    lg8 = torch.cat([first[None], lg8]).float()
    ref = logits16.float()
    worst = 0.0
    for t in range(gen):
        err = float((lg8[t] - ref[t]).abs().max())
        limit = 0.15 * float(ref[t].abs().max()) + 0.5
        if not err < limit:
            raise SystemExit(f"fp8 cache, step {t}: err {err!r} >= bound "
                             f"{limit!r}")
        worst = max(worst, err / limit)
    same = float((lg8.argmax(-1) == ref.argmax(-1)).float().mean())
    say(f"serve {arch} with a float8_e4m3fn KV cache (captured decode, the "
        f"bf16 run's tokens fed): every step within tests/test_serve.py's "
        f"bound (err < 0.15*max|logit| + 0.5), worst err/bound "
        f"{worst!r}; argmax agrees with bf16 at {same!r} of positions; "
        f"prefill + capture + {gen - 1} steps {wall!r} s "
        f"(capture_s={run.capture_s!r}) on {card}")
    del model, cache, lg8


def serve_requests_run(serve_requests, counters, card):
    """`repro_torch.examples.serve_requests` on the card (reduced,
    bfloat16), captured and `--no-scan`: the same tokens."""
    out = {}
    for extra in ([], ["--no-scan"]):
        reset_counts(counters)
        t0 = time.perf_counter()
        out[bool(extra)] = serve_requests.main(["--device", "cuda"] + extra)
        n = read_counts(counters)
        say(f"  serve_requests {' '.join(extra) or '(captured)'}: "
            f"{time.perf_counter() - t0!r} s, launches {n} on {card}")
    if not (out[False] == out[True]).all():
        raise SystemExit(f"serve_requests: captured {out[False].tolist()} "
                         f"!= --no-scan {out[True].tolist()}")


def round_inputs(res, engine, pt):
    """The kernel's arguments for the round after a run's last one, as
    `FedGiA.round_flat` builds them: (x̄, ḡ, π, h, sel, σ, m, k0), with
    the (N,) anchor, and h 0-d under scalar H."""
    algo, batch, state = res["algorithm"], res["batch"], res["state"]
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    xbar, sel, _, _, gbar = algo.round_inputs(flat, batch, spec)
    return algo.kernel_args(flat, xbar, gbar, sel)


def median_ms(fn, prep=None):
    """Median CUDA-event time of `fn` over REPS launches after WARMUP.
    A long sleep is queued first so that every launch is enqueued before
    the card reaches it: the events then time the device, not the host."""
    for _ in range(WARMUP):
        if prep:
            prep()
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
    torch.cuda._sleep(200_000_000)
    for start, end in events:
        if prep:
            prep()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def graph_ms(fn):
    """Per-launch time of `fn` inside a CUDA graph of REPS calls: the
    median CUDA-event time of 5 replays over REPS. At a launch-bound
    shape this is the card's own cost of a launch in a replayed graph.
    A donated call runs on its own outputs from one call to the next."""
    fn()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return statistics.median(times)


def fedgia_bytes(xbar, gbar, h, sel, want_x):
    """Bytes the update must move on these inputs: ḡ read and π', z'
    written for every row; π, and h unless it is one scalar, read for
    the selected rows only (the GD arm needs neither); the anchor (one
    (N,) vector or (m, N)), x' when written, sel (a byte a row) and σ."""
    m, n = gbar.shape
    n_sel = int(sel.sum())
    row_bytes = 4 * n
    nbytes = m * row_bytes * 3 + n_sel * row_bytes
    nbytes += 4 if h.dim() == 0 else n_sel * row_bytes
    nbytes += xbar.numel() * 4 + (m * row_bytes if want_x else 0) + m + 4
    return nbytes


def bound(nbytes):
    """Least time on an H100 SXM: the bytes over the HBM rate. The
    operations are no bound: about 20 fp32 operations an element (a^(k0-1)
    by square-and-multiply) against 12-28 bytes, below one per byte, where
    the card's fp32 rate over its HBM rate is about 20 per byte."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def plain(ref, xbar, gbar, pi, h, sel, sigma, m, k0):
    return ref.fedgia_update_collapsed(
        xbar, gbar, pi, h,
        sel.reshape(sel.shape + (1,) * (gbar.dim() - sel.dim())), sigma,
        float(1.0 / m), k0=k0)


def materialised(args):
    """The same inputs through the TPU kernels' interface: the anchor and
    a scalar h copied to (m, N)."""
    xbar, gbar, pi, h, sel, sigma, m, k0 = args
    full = lambda t: t.expand(gbar.shape).contiguous()  # noqa: E731
    return (full(xbar), gbar, pi, full(h), sel, sigma, m, k0)


def hold_and_time(name, args, ops, ref, *, round_form):
    """Hold one form of the kernel against its plain version on `args`
    (x̄, ḡ, π, h, sel, σ, m, k0), then time both. `round_form`: the call
    `round_flat` makes (`fedgia_update_flat`, no x'), else the TPU
    wrapper `name` on materialised inputs. Returns the entry of the
    kernels line."""
    if not round_form:
        args = materialised(args)
    xbar, gbar, pi, h, sel, sigma, m, k0 = args
    want = plain(ref, *args)
    # the round's one-client launch donates too (π' into π, z' into ḡ),
    # as the one-client round calls it
    donated = name == "fedgia_update_batched_donated" or (
        name == "fedgia_update_single" and round_form)
    prep = None
    if donated:
        # writes π' into π and z' into ḡ (and x' into a materialised
        # anchor): run on copies, restored before every timed launch
        ins = [t.clone() for t in (xbar, gbar, pi)] + [h, sel]

        def prep():
            for buf, src in zip(ins, (xbar, gbar, pi)):
                buf.copy_(src)
    elif name == "fedgia_update_single" and not round_form:
        ins = [t[0] for t in (xbar, gbar, pi, h, sel)]  # the (N,) form
        want = [w[0] for w in want]
    else:
        ins = [xbar, gbar, pi, h, sel]
    if round_form:
        def call():
            return ops.fedgia_update_flat(*ins, sigma, m, k0=k0,
                                          donate=donated, want_x=False)
    else:
        wrapper = getattr(ops, name)

        def call():
            return wrapper(*ins, sigma, m, k0=k0)

    before = ops.launches[name]
    out = call()
    if ops.launches[name] != before + 1:
        raise SystemExit(f"{name}: the call did not launch its kernel once")
    if donated and [t.data_ptr() for t in out[1:]] != \
            [ins[i].data_ptr() for i in (2, 1)]:
        raise SystemExit(f"{name} did not write into its inputs")
    pairs = [(a, b, part) for a, b, part in zip(out, want, ("x", "pi", "z"))
             if a is not None]
    if round_form and out[0] is not None:
        raise SystemExit(f"{name}: the round's form wrote x'")
    err = max(float((a - b).abs().max()) for a, b, _ in pairs)
    diff = sum(int((a != b).sum()) for a, b, _ in pairs)
    for a, b, part in pairs:
        if not torch.isfinite(a).all():
            raise SystemExit(f"{name}: non-finite {part}'")
        torch.testing.assert_close(a, b, rtol=RTOL, atol=0.0,
                                   msg=lambda msg: f"{name} {part}': {msg}")
    form = (f"round form: {'(N,)' if xbar.dim() == 1 else '(m, N)'} "
            f"anchor, h {'0-d' if h.dim() == 0 else '(m, N)'}, no x'"
            if round_form else "TPU interface: (m, N) anchor and h, x'")
    shape = list(gbar.shape)
    say(f"  {name} {shape} [{form}]: max_abs_err={err!r} "
        f"differing_elements={diff} (tolerance rtol {RTOL}, bitwise "
        f"expected)")
    ms = median_ms(call, prep)
    plain_ms = median_ms(lambda: plain(ref, *args))
    nbytes = fedgia_bytes(xbar, gbar, h, sel, want_x=not round_form)
    return {"name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": TPU_KERNELS[name], "launches": None,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound(nbytes), "bound_by": "bytes",
            "library_ms": None, "graph_ms": graph_ms(call) if round_form
            else None, "shape": shape, "nbytes": nbytes, "form": form}


def hold_card_to_cpu(gpu, cpu, tol, what, sides=("cuda", "cpu"),
                     f_rtol=1e-5, stop_rtol=1e-2):
    """The same run on the card and on the CPU (or two runs that `sides`
    names), each a per-round list of (f, stop metric, *exact): the same
    rounds (or one apart where the longer run's stop metric at the
    shorter run's last round lies within `stop_rtol` of tol, float32
    noise in the eq. (35) test), the entries after the stop metric (a
    round's staleness, its simulated time) equal in every round both ran,
    and f at rel `f_rtol` at the last round both ran."""
    r_gpu, r_cpu = len(gpu), len(cpu)
    if r_gpu != r_cpu:
        long_ = cpu if r_gpu < r_cpu else gpu
        err_at = long_[min(r_gpu, r_cpu) - 1][1]
        if abs(r_gpu - r_cpu) > 1 or abs(err_at - tol) > stop_rtol * tol:
            raise SystemExit(f"{what}: {r_gpu} rounds ({sides[0]}), "
                             f"{r_cpu} ({sides[1]}); the longer run's stop "
                             f"metric {err_at!r} at the shorter's last round")
    for i, (a, b) in enumerate(zip(gpu, cpu)):
        if tuple(a[2:]) != tuple(b[2:]):
            raise SystemExit(f"{what}: round {i}: {a[2:]} ({sides[0]}) vs "
                             f"{b[2:]} ({sides[1]})")
    r = min(r_gpu, r_cpu) - 1
    f_gpu, f_cpu = gpu[r][0], cpu[r][0]
    if abs(f_gpu - f_cpu) > f_rtol * abs(f_cpu):
        raise SystemExit(f"{what}: f {f_gpu!r} ({sides[0]}) vs {f_cpu!r} "
                         f"({sides[1]})")
    say(f"{what} parity: rounds {r_gpu} ({sides[0]}) vs {r_cpu} "
        f"({sides[1]}), f {f_gpu!r} vs {f_cpu!r}")


def cli_history(res):
    return [(h["f"], h["err"]) for h in res["history"]]


def card_vs_cpu_run(gpu, cpu, what, tol=PAPER_TOL):
    """The same CLI run on the card and on the CPU, held as
    `hold_card_to_cpu` holds runs."""
    hold_card_to_cpu(cli_history(gpu), cli_history(cpu), tol, what)


def per_round_ms(res):
    return res["wall_s"] / res["rounds"] * 1e3


def hold_replayed_to_eager(a, b, what, bitwise_only=False,
                           label="replayed vs eager"):
    """Hold the final state of a replayed run to the eager run's (or of
    the two runs that `label` names): every model-shaped entry, compared
    by bit pattern (so that a NaN or an inf is compared too); bitwise is
    expected, and otherwise the states are held to STATE_RTOL /
    STATE_ATOL, or fail with `bitwise_only`."""
    diffs, finite = {}, True
    for k, tree in a.items():
        if not isinstance(tree, dict):
            continue
        for leaf in tree:
            x, y = tree[leaf], b[k][leaf]
            diffs[f"{k}.{leaf}"] = int(
                (x.view(torch.int32) != y.view(torch.int32)).sum())
            finite = finite and bool(torch.isfinite(x).all())
            torch.testing.assert_close(
                x, y, rtol=STATE_RTOL, atol=STATE_ATOL, equal_nan=True,
                msg=lambda m: f"{what}: {label} {k}: {m}")
    bitwise = not any(diffs.values())
    say(f"  {label} final state: "
        f"{'bitwise equal' if bitwise else 'NOT bitwise'} (differing bit "
        f"patterns {diffs}; held to rtol {STATE_RTOL}, atol {STATE_ATOL} "
        f"otherwise); every value finite: {finite}")
    if bitwise_only and not bitwise:
        raise SystemExit(f"{what}: final states not bitwise equal: {diffs}")


def run_pair(train, counters, argv, what):
    """The run `argv` with the default (CUDA-graph chunk) driver, then with
    the eager `--no-scan` loop, launch counts of each read apart: the same
    rounds and a final state bitwise equal. Returns (replayed, its
    launches, eager, its launches)."""
    graph_res, n_graph = run_main_path(train, counters, argv)
    say(done_line(f"{what} (cuda, CUDA-graph chunks)", graph_res))
    say(f"  launches: {n_graph}; warm-up and capture "
        f"{graph_res['capture_s']!r} s (not in the rounds' time)")
    eager_res, n_eager = run_main_path(train, counters, argv + ["--no-scan"])
    say(done_line(f"{what} (cuda, eager --no-scan)", eager_res))
    say(f"  launches: {n_eager}")
    if graph_res["rounds"] != eager_res["rounds"] or n_graph != n_eager:
        raise SystemExit(f"{what}: {graph_res['rounds']} rounds, launches "
                         f"{n_graph} replayed; {eager_res['rounds']} rounds, "
                         f"launches {n_eager} eager")
    hold_replayed_to_eager(graph_res["state"], eager_res["state"], what)
    for tag, res in (("replayed", graph_res), ("eager", eager_res)):
        say(f"  per-round time {tag}: {res['wall_s'] / res['rounds'] * 1e3!r}"
            f" ms ({res['rounds']} rounds in {res['wall_s']!r} s)")
    say(f"  of the replayed run's time, the host's mask draws before its "
        f"chunks: {graph_res['draw_s']!r} s")
    return graph_res, n_graph, eager_res, n_eager


def engine_pair(engine, counters, algo, state, batch, rounds, what, **kw):
    """`engine.run_rounds` replayed (CUDA-graph chunks) and eager
    (`scan=False`), launch counts of each read apart: every round run, the
    same launches, final states bitwise equal. Returns (replayed result,
    its launches, eager result)."""
    out = {}
    for tag, scan in (("replayed", True), ("eager", False)):
        reset_counts(counters)
        res = engine.run_rounds(algo, state, batch, rounds, scan=scan, **kw)
        n = read_counts(counters)
        say(f"  {what} ({tag}): {res.rounds_run} rounds, "
            f"{res.wall_s / res.rounds_run * 1e3!r} ms a round "
            f"(capture {res.capture_s!r} s apart), mask draws "
            f"{res.draw_s!r} s on the host, f="
            f"{float(res.history['f_xbar'][-1])!r}; launches {n}")
        if res.rounds_run != rounds:
            raise SystemExit(f"{what} ({tag}): {res.rounds_run} rounds")
        out[tag] = res, n
    (graph_res, n_graph), (eager_res, n_eager) = out["replayed"], out["eager"]
    if n_graph != n_eager:
        raise SystemExit(f"{what}: launches {n_graph} replayed, {n_eager} "
                         f"eager")
    hold_replayed_to_eager(graph_res.state, eager_res.state, what,
                           bitwise_only=True)
    return graph_res, n_graph, eager_res


LABELS = ("gradient", "eq. (11)", "update kernel", "H refresh", "metrics")
# the steps every FedGiA round runs (H refresh: diag_ema rounds only)
ROUND_STEPS = ("gradient", "eq. (11)", "update kernel", "metrics")


def split_is_whole(split, steps=ROUND_STEPS):
    """Whether a round's split timed every step of `steps` that the round
    runs: time > 0 for each. A torch.profiler session that lost a step's
    kernels reads 0 there; such a split is not a device split."""
    return all(split.get(k, 0.0) > 0 for k in steps)
COPY_OPS = ("aten::copy_", "aten::cat", "aten::clone", "aten::constant_pad_nd")
UPDATE_KERNEL = "fedgia_update_kernel"


def labelled(obj, name, label, undo):
    """Wrap `obj.name` in a profiler range `label`; `undo` collects the
    functions that put the originals back."""
    real = getattr(obj, name)

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(label):
            return real(*args, **kwargs)

    setattr(obj, name, wrapped)
    undo.append(lambda: setattr(obj, name, real))


def device_split(prof):
    """Device time (us) of one profiled round by step. A kernel or copy
    that a PyTorch op launched goes under the outermost of LABELS around
    the op; the ops of the autograd engine's worker thread (the backward
    of the gradient, the round's only autograd work) under "gradient";
    other copies under "copies". The fused update, launched through
    ctypes and so under no op, is found by its kernel's name."""
    split = dict.fromkeys(LABELS + ("copies", "other"), 0.0)
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CPU:
            if UPDATE_KERNEL in e.name:
                split["update kernel"] += e.time_range.elapsed_us()
            continue
        kernels = [k for k in e.kernels if UPDATE_KERNEL not in k.name]
        if not kernels:
            continue
        label, p = None, e
        while p is not None:
            if p.name in LABELS:
                label = p.name
            elif label is None and p.name.startswith("autograd::engine"):
                label = "gradient"
            p = p.cpu_parent
        if label is None:
            label = "copies" if e.name in COPY_OPS or all(
                k.name.startswith(("Memcpy", "Memset"))
                for k in kernels) else "other"
        split[label] += sum(k.duration for k in kernels)
    return split


def profile_round(res, modules, engine, selection, pt):
    """One eager round after the run's last, under torch.profiler, with
    its steps in ranges: device time per step. Also the median host-clock
    time of 5 unprofiled eager rounds. Returns (split, wall_us)."""
    fedgia_mod, hparams_mod, api_mod = modules
    algo, batch, state = res["algorithm"], res["batch"], res["state"]
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    walls = []
    for _ in range(6):  # undonated: flat is left as it was
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.round_flat(dict(flat), batch, spec)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    undo = []
    labelled(algo, "_vg", "gradient", undo)
    labelled(api_mod, "client_mean", "eq. (11)", undo)
    labelled(fedgia_mod, "fedgia_update_flat", "update kernel", undo)
    labelled(hparams_mod, "update_diag_h", "H refresh", undo)
    for name in ("client_scalar_mean", "flat_grad_sq_norm",
                 "client_scalar_sum"):
        labelled(api_mod, name, "metrics", undo)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            algo.round_flat(dict(flat), batch, spec)
            torch.cuda.synchronize()
    finally:
        for fn in reversed(undo):
            fn()
    return device_split(prof), statistics.median(walls[1:])


def baseline_gradient_ms(algo, state, batch, engine, pt, baselines_common):
    """CUDA-event time (median of REPS) of one stacked gradient evaluation
    of a baseline's local step, on the (m, N) trajectory buffer of its
    first round (x̄ broadcast, materialised as the later steps' is)."""
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    x = flat["x"].expand((algo.fed.num_clients,) + flat["x"].shape)
    x = x.contiguous()
    fvg = baselines_common.flat_value_and_grad(algo._vg_stacked, spec)
    return median_ms(lambda: fvg(x, batch))


def replay_busy(run):
    """Device busy time (us) from the first CUDA-graph launch of `run()`
    on, under torch.profiler (the warm-up before it is left out). Returns
    (busy_us, the run's RoundResult)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        res = run()
        torch.cuda.synchronize()
    events = prof.events()
    starts = [e.time_range.start for e in events
              if e.name == "cudaGraphLaunch"]
    if not starts:
        raise SystemExit("profiled replay: no cudaGraphLaunch was traced")
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type != torch.autograd.DeviceType.CPU
               and e.time_range.start >= min(starts))
    return busy, res


def replayed_busy_us(res, argv, engine, prng):
    """Device busy time a round (us, profiled) of the CLI run `argv` again
    through `engine.run_rounds`, replayed, from the state a fresh run
    starts from. Returns (busy us a round, rounds run)."""
    algo, batch = res["algorithm"], res["batch"]
    state = algo.init(algo.model.init(batch["A"].device),
                      prng.prng_key(1), init_batch=batch)
    rounds = int(argv[argv.index("--rounds") + 1])
    tol = float(argv[argv.index("--tol") + 1]) if "--tol" in argv else 1e-7
    busy, rr = replay_busy(lambda: engine.run_rounds(algo, state, batch,
                                                     rounds, tol=tol))
    return busy / rr.rounds_run, rr.rounds_run


def event_split(res, modules, engine, pt):
    """`event_split_flat` of one eager round after the run's last."""
    algo, batch, state = res["algorithm"], res["batch"], res["state"]
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    return event_split_flat(algo, batch, flat, spec, modules)


def event_split_flat(algo, batch, flat, spec, modules):
    """The split of one eager undonated round on the flat state (left as
    it was) by CUDA events, for a round whose torch.profiler sessions
    lost steps: the span on the stream of each outermost labelled step
    (an event before and after its call, the stream drained before
    each), host launch time within the step included, and the rest of the
    round under "other". Returns (split, wall_us), wall_us the whole
    round's span."""
    fedgia_mod, hparams_mod, api_mod = modules
    spans, depth, undo = [], [0], []

    def timed(obj, name, label):
        real = getattr(obj, name)

        def wrapped(*args, **kwargs):
            if depth[0]:
                return real(*args, **kwargs)
            torch.cuda.synchronize()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            depth[0] += 1
            ev[0].record()
            try:
                return real(*args, **kwargs)
            finally:
                ev[1].record()
                depth[0] -= 1
                spans.append((label, ev))

        setattr(obj, name, wrapped)
        undo.append(lambda: setattr(obj, name, real))

    timed(algo, "_vg", "gradient")
    timed(api_mod, "client_mean", "eq. (11)")
    timed(fedgia_mod, "fedgia_update_flat", "update kernel")
    timed(hparams_mod, "update_diag_h", "H refresh")
    for name in ("client_scalar_mean", "flat_grad_sq_norm",
                 "client_scalar_sum"):
        timed(api_mod, name, "metrics")
    whole = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    try:
        torch.cuda.synchronize()
        whole[0].record()
        algo.round_flat(dict(flat), batch, spec)
        whole[1].record()
        torch.cuda.synchronize()
    finally:
        for fn in reversed(undo):
            fn()
    split = dict.fromkeys(LABELS + ("copies", "other"), 0.0)
    for label, (a, b) in spans:
        split[label] += a.elapsed_time(b) * 1e3
    wall_us = whole[0].elapsed_time(whole[1]) * 1e3
    split["other"] = max(wall_us - sum(split.values()), 0.0)
    return split, wall_us


def round_split_phase(profiled, modules, engine, selection, pt, prng, card):
    """Phase 6: the split of one eager round after each run's last and
    the device's busy share in the replayed run, under torch.profiler. A
    split that lost a step of the round (`split_is_whole`), or a replayed
    busy time under half the eager round's device work, is profiled
    again, at most ATTEMPTS times, every attempt printed. Where no session
    timed every step the round is split by CUDA events instead
    (`event_split`), flagged as spans; it raises if those miss a step."""
    say(f"split of one eager round after each run's last (torch.profiler, "
        f"device us per step) and the device's busy share in a replayed "
        f"run, on {card}:")
    for what, (res, argv, replayed_us) in profiled.items():
        for attempt in range(1, ATTEMPTS + 1):
            split, wall_us = profile_round(res, modules, engine, selection,
                                           pt)
            busy = sum(split.values())
            whole = split_is_whole(split)
            say(f"  {what} round, eager (session {attempt}): " + " ".join(
                f"{k}={v:.1f}" for k, v in split.items()) +
                f" busy={busy:.1f} wall={wall_us:.1f} (unprofiled, median "
                f"of 5) idle_share={1 - busy / wall_us:.4f}"
                + ("" if whole else " [kernels lost by the profiler]"))
            if whole:
                break
        if not whole:
            split, span_us = event_split(res, modules, engine, pt)
            busy = sum(v for k, v in split.items() if k != "other")
            say(f"  {what} round, eager: no profiler session timed every "
                f"step; [CUDA-event spans, not a device split] (us, each "
                f"step's host launches included, not busy time): " +
                " ".join(f"{k}={v:.1f}" for k, v in split.items())
                + f" round={span_us:.1f}")
            if not split_is_whole(split):
                raise SystemExit(f"{what}: neither the profiler nor CUDA "
                                 f"events timed every step of the round")
        for attempt in range(1, ATTEMPTS + 1):
            per_round, rr = replayed_busy_us(res, argv, engine, prng)
            whole = per_round >= 0.5 * busy
            say(f"  {what} run, replayed (session {attempt}): {rr} rounds, "
                f"device busy {per_round:.1f} us a round (profiled), against "
                f"{replayed_us:.1f} us a round unprofiled (phase 2): "
                f"busy_share={per_round / replayed_us:.4f}"
                + ("" if whole else " [kernels lost by the profiler]"))
            if whole:
                break


def visible_pairs(S, causal=True, window=None):
    """Number of (query, key) pairs that the masks leave visible."""
    i = torch.arange(S, dtype=torch.int64)
    lo = torch.zeros_like(i) if window is None else (i - window + 1).clamp_min(0)
    hi = i if causal else torch.full_like(i, S - 1)
    return int((hi - lo + 1).sum())


def flash_bound(q, k, window=None):
    """Least time for flash attention on an H100 SXM: the larger of 4 hd
    operations per visible (query, key) pair and head over the tensor-core
    peak of the input type, and q, k, v read once and the output written
    once over the HBM rate. Returns (ms, bound_by, flops, bytes)."""
    B, H, S, hd = q.shape
    flops = 4 * hd * visible_pairs(S, True, window) * B * H
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    peak = BF16_TENSOR_FLOPS if q.dtype == torch.bfloat16 else FP32_FLOPS
    return bound_of(flops / peak, nbytes / HBM_BYTES_PER_S) + (flops, nbytes)


def scan_bound(r, w, u):
    """Least time for the WKV scan on an H100 SXM: r, k, v, w, u read once,
    y and the final state written once, over the HBM rate; against 5 fp32
    operations per state element a step (r S: 2, w S + k v^T: 3; the u
    term is O(hd)) over the fp32 peak. Returns (ms, bound_by, flops,
    bytes)."""
    B, H, T, hd = r.shape
    flops = 5 * B * H * T * hd * hd
    nbytes = (4 * r.numel() * r.element_size() + w.numel() * 4
              + u.numel() * 4 + B * H * hd * hd * 4)
    return bound_of(flops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S) + (
        flops, nbytes)


def flash_tile_flops(flash_ops, q, window=None):
    """Flops of the (query, key) tiles that the kernel computes for q's
    shape, causal: visible pairs and the masked part of the tiles that
    the masks cut (the diagonal, the ragged edge)."""
    B, H, S, hd = q.shape
    bq, bk = flash_ops.TILES[(q.dtype, hd)]
    pairs = 0
    for qt in range(-(-S // bq)):
        lo, hi = flash_ops.kv_tiles(qt, S, bq, bk, True, window)
        pairs += min(bq, S - qt * bq) * (min(hi * bk, S) - lo * bk)
    return 4 * hd * pairs * B * H


def bound_of(t_ops, t_bytes):
    if t_ops >= t_bytes:
        return t_ops * 1e3, "operations"
    return t_bytes * 1e3, "bytes"


def check_flash(flash_ops, flash_ref, q, k, v, window, what):
    """Hold the flash kernel to its plain version on (q, k, v)."""
    out = flash_ops.flash_attention(q, k, v, window=window)
    want = flash_ref.flash_attention_ref(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[q.dtype]
    if out.dtype != q.dtype or not torch.isfinite(out).all():
        raise SystemExit(f"flash_attention {what}: bad output")
    err = float((out.float() - want.float()).abs().max())
    torch.testing.assert_close(
        out.float(), want.float(), rtol=tol, atol=tol,
        msg=lambda m: f"flash_attention {what}: {m}")
    say(f"  flash_attention {what}: q {list(q.shape)} k {list(k.shape)} "
        f"{str(q.dtype)[6:]} window={window}: max_abs_err={err!r} "
        f"(tolerance rtol=atol={tol})")
    return err


def check_scan(scan_ops, scan_ref, r, k, v, w, u, what):
    """Hold the WKV-scan kernel to its plain version."""
    y, s = scan_ops.rwkv6_scan(r, k, v, w, u)
    yr, sr = scan_ref.rwkv6_scan_ref(r, k, v, w, u)
    torch.cuda.synchronize()
    tol = SCAN_TOL[r.dtype]
    if not (torch.isfinite(y).all() and torch.isfinite(s).all()):
        raise SystemExit(f"rwkv6_scan {what}: non-finite output")
    err = float((y.float() - yr.float()).abs().max())
    serr = float((s - sr).abs().max())
    torch.testing.assert_close(y.float(), yr.float(), rtol=tol, atol=tol,
                               msg=lambda m: f"rwkv6_scan {what} y: {m}")
    torch.testing.assert_close(s, sr, **SCAN_STATE_TOL,
                               msg=lambda m: f"rwkv6_scan {what} S: {m}")
    say(f"  rwkv6_scan {what}: r {list(r.shape)} {str(r.dtype)[6:]}: "
        f"y max_abs_err={err!r} (tolerance rtol=atol={tol}), state "
        f"max_abs_err={serr!r} (tolerance {SCAN_STATE_TOL})")
    return err


def randn(gen, shape, dtype=torch.float32, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda")
            * scale).to(dtype)


def sdpa(q, k, v):
    """PyTorch's fused attention on the same function, as a yardstick
    (the port never calls it), on contiguous copies made outside the
    timed call."""
    q, k, v = (t.contiguous() for t in (q, k, v))
    return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)


def card_vs_cpu(serve, Transformer, get_config, arch, counters):
    """The reduced float32 model on the CPU and, with the same parameters,
    on the card: the same tokens, logits within PARITY_TOL."""
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    from repro_torch.core.prng import prng_key

    cpu = Transformer(cfg, "cpu").init(prng_key(0))
    gpu = Transformer(cfg, "cuda").load_params(cpu.params)
    prompts = torch.randint(0, cfg.vocab_size, (2, PARITY_PROMPT),
                            generator=torch.Generator().manual_seed(1))
    want = serve.generate(cpu, prompts, PARITY_GEN, scan=False)
    reset_counts(counters)
    got = serve.generate(gpu, prompts.cuda(), PARITY_GEN, scan=True)
    n = read_counts(counters)
    if not got["capture_s"] > 0:
        raise SystemExit(f"{arch}: the card's decode was not captured")
    if not torch.equal(got["tokens"].cpu(), want["tokens"]):
        raise SystemExit(f"{arch}: the card generated {got['tokens'].tolist()}"
                         f", the CPU {want['tokens'].tolist()}")
    err = float((got["logits"].cpu() - want["logits"]).abs().max())
    torch.testing.assert_close(got["logits"].cpu(), want["logits"],
                               rtol=PARITY_TOL, atol=PARITY_TOL,
                               msg=lambda m: f"{arch} card vs cpu: {m}")
    say(f"  {cfg.name} fp32: tokens equal ({want['tokens'][0].tolist()}), "
        f"logits max_abs_err={err!r} (tolerance rtol=atol={PARITY_TOL}); "
        f"card launches {n}")


def float32_cli(train):
    """Make `train`'s `--arch` configs float32 (the CLI has no dtype flag);
    returns the function that puts the registry's back."""
    real = train.get_config
    train.get_config = lambda name: dataclasses.replace(real(name),
                                                        dtype="float32")
    return lambda: setattr(train, "get_config", real)


def tensors_of(tree):
    """The tensors of a nested dict (a cache: a hybrid group nests its
    attention's under "attn")."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tensors_of(v)
        else:
            yield v


def decode_bound_ms(model, cache):
    """Least time of a decode step on an H100 SXM: every weight it reads
    (all but the embedding, of which a step reads B rows, and the MTP
    head) and the cache read once, over the HBM rate."""
    nbytes = sum(t.numel() * t.element_size()
                 for k, t in model.params.items()
                 if k != "embed" and not k.startswith("mtp/"))
    nbytes += sum(t.numel() * t.element_size() for t in tensors_of(cache))
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def frame_embeds(cfg, run):
    """`run["frames"]` embeddings a request ((batch, frames, d_model), on
    the card in the model's dtype), float32 standard normals from numpy's
    default_rng(0), as `synthetic_batch_for` draws a client's; None
    without frames."""
    if not run.get("frames"):
        return None
    import numpy as np

    emb = np.random.default_rng(0).standard_normal(
        (run["batch"], run["frames"], cfg.d_model)).astype(np.float32)
    return torch.from_numpy(emb).cuda()


def serve_full_width(serve, Transformer, cfg, run, counters, card, mod,
                     name, eager=False):
    """`cfg` served on the card from `prng_key(0)`: `Transformer.init`
    timed (init_s), a warm-up `serve.generate` (gen 2), then the measured
    captured run (counts reset just before and read just after, the first
    call of `mod.name` recorded) and, with `eager`, the `--no-scan` run on
    the same prompts. `run["frames"]` embeddings (`frame_embeds`) are
    prefilled before the `run["prompt"]` tokens (none: no prompt tokens).
    Prints prefill_s, decode tok/s/req, init_s, the peak device memory
    and the decode step's bound. Returns (model, prompts, captured
    result, eager result or None, counts, recorded call, embeds)."""
    from repro_torch.core.prng import prng_key

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, "cuda").init(prng_key(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.params.values())
    rng = torch.Generator(device="cuda").manual_seed(0)
    prompts = (torch.randint(0, cfg.vocab_size, (run["batch"],
                                                 run["prompt"]),
                             generator=rng, device="cuda")
               if run["prompt"] else None)
    embeds = frame_embeds(cfg, run)
    serve.generate(model, prompts, 2, embeds=embeds)
    store = []
    restore = record_first_call(mod, name, store)
    try:
        reset_counts(counters)
        res = serve.generate(model, prompts, run["gen"], embeds=embeds)
        n = read_counts(counters)
    finally:
        restore()
    res_eager = (serve.generate(model, prompts, run["gen"], scan=False,
                                embeds=embeds) if eager else None)
    peak = torch.cuda.max_memory_allocated()
    cache = model.init_cache(run["batch"], run.get("frames", 0)
                             + run["prompt"] + run["gen"])
    bound, nbytes = decode_bound_ms(model, cache)
    del cache
    step_ms = res["decode_s"] / (run["gen"] - 1) * 1e3
    say(f"serve {cfg.name} captured (cuda, full width, {cfg.num_layers} "
        f"layers, {n_params} parameters, batch {run['batch']}, "
        f"{run.get('frames', 0)} embeddings and {run['prompt']} prompt "
        f"tokens a request, gen {run['gen']}): init_s={init_s!r} "
        f"prefill_s={res['prefill_s']!r} capture_s={res['capture_s']!r} "
        f"decode_s={res['decode_s']!r} decode_tok_s_req="
        f"{(run['gen'] - 1) / res['decode_s']!r} ({step_ms!r} ms a step; "
        f"bound {bound!r} ms: {nbytes} bytes of weights and cache at 3.35 "
        f"TB/s) peak device memory {peak} bytes ({gib(peak):.2f} GiB) on "
        f"{card}")
    say(f"  generated[0,:16] = {res['tokens'][0, :16].tolist()}; launches "
        f"{n}")
    if res_eager is not None:
        say(f"  --no-scan: prefill_s={res_eager['prefill_s']!r} decode_s="
            f"{res_eager['decode_s']!r} decode_tok_s_req="
            f"{(run['gen'] - 1) / res_eager['decode_s']!r}")
    tokens = res["tokens"]
    if tokens.shape != (run["batch"], run["gen"]) or tokens.min() < 0 or \
            tokens.max() >= cfg.vocab_size or \
            not torch.isfinite(res["logits"].float()).all():
        raise SystemExit(f"serve {cfg.name}: bad tokens or logits")
    if not res["capture_s"] > 0:
        raise SystemExit(f"serve {cfg.name}: the decode was not captured")
    return (model, prompts, res, res_eager, n,
            (store[0] if store else None), embeds)


def record_routing(moe, store):
    """Replace `moe.route` by a function that appends each call's
    (expert_idx, probs) to `store`; returns the function that puts it
    back."""
    real = moe.route

    def route(*args, **kwargs):
        out = real(*args, **kwargs)
        store.append((out[2].detach().clone(), out[0].detach().clone()))
        return out

    moe.route = route
    return lambda: setattr(moe, "route", real)


def hold_decode_to_forward(serve, moe, model, prompts, res, what):
    """The captured run's logits (the prefill's last, then each decode
    step's) against the train-mode forward over the prompt and the
    generated tokens, at DECODE_RTOL / DECODE_ATOL, row by row (a row: one
    request at one position). The cut models have one MoE layer, their
    last, so a position's routing reaches its own row only. The two
    computations run the layers below it as GEMMs of other shapes (S = 1
    a step against the whole sequence), which move the router's bf16
    inputs by ulps, and among 256 experts the k-th and (k+1)-th
    probabilities can lie that close: such a row routes to another expert
    set in the two. Routing is read from an eager (`--no-scan`) decode of
    the same prompts, whose tokens must be the captured run's: the
    router's logits of the two (log-probabilities less their mean over
    the experts) must agree within ROUTER_DRIFT at every row, which a
    wrong decode path (another position, another cache slot) would not
    meet; a row whose expert set differs is counted, its swapped experts'
    probability gap printed, and left out; every other row is held to the
    bound."""
    P, gen = prompts.shape[1], res["tokens"].shape[1]
    B = prompts.shape[0]
    seq = torch.cat([prompts, res["tokens"][:, :gen - 1]], dim=1)
    fwd, dec = [], []
    restore = record_routing(moe, fwd)
    try:
        with torch.no_grad():
            full = model.forward(seq)[:, P - 1:].transpose(0, 1)  # gen,B,V
    finally:
        restore()
    restore = record_routing(moe, dec)
    try:
        eager = serve.generate(model, prompts, gen, scan=False)
    finally:
        restore()
    if not torch.equal(eager["tokens"], res["tokens"]):
        raise SystemExit(f"{what}: --no-scan tokens {eager['tokens'].tolist()}"
                         f" != captured {res['tokens'].tolist()}")
    if len(fwd) != 1 or len(dec) != gen:
        raise SystemExit(f"{what}: {len(fwd)} and {len(dec)} router calls, "
                         f"want 1 and {gen} (one MoE layer)")
    def rows(calls, n0):  # (B, gen, ...) at positions P-1 .. P+gen-2
        return torch.cat([calls[0].reshape(B, n0, -1)[:, -1:]]
                         + [c.reshape(B, 1, -1) for c in calls[1:]], dim=1)

    f_idx = fwd[0][0].reshape(B, P + gen - 1, -1)[:, P - 1:]
    f_probs = fwd[0][1].reshape(B, P + gen - 1, -1)[:, P - 1:]
    d_idx = rows([d for d, _ in dec], P)
    d_probs = rows([pr for _, pr in dec], P)

    def centred(pr):
        lp = pr.log()
        return lp - lp.mean(-1, keepdim=True)

    drift = float((centred(f_probs) - centred(d_probs)).abs().max())
    flipped = (f_idx.sort(-1).values != d_idx.sort(-1).values).any(-1).T
    got, want = res["logits"].float(), full.float()  # (gen, B, V)
    rows = ~flipped
    err = float((got[rows] - want[rows]).abs().max())
    torch.testing.assert_close(got[rows], want[rows], rtol=DECODE_RTOL,
                               atol=DECODE_ATOL,
                               msg=lambda m: f"{what} decode vs forward: {m}")
    gaps = []
    for t, b in flipped.nonzero().tolist():
        a, d = set(f_idx[b, t].tolist()), set(d_idx[b, t].tolist())
        pr = f_probs[b, t]
        gaps.append(max(abs(float(pr[i] - pr[j]))
                        for i in a - d for j in d - a))
    n_flip = int(flipped.sum())
    worst = float((got - want).abs().max())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    say(f"  prefill + captured decode vs the train forward over the same "
        f"{P + gen - 1} tokens: router logits within {drift!r} of each "
        f"other (bound {ROUTER_DRIFT}); {gen * B - n_flip} of {gen * B} "
        f"rows route alike, max_abs_err={err!r} there (rtol {DECODE_RTOL}, "
        f"atol {DECODE_ATOL}); {n_flip} rows route to another expert set "
        f"(forward probability gaps of the swapped experts {gaps}), "
        f"max_abs_err over all rows {worst!r}; argmax equal at {same!r}")
    if not drift <= ROUTER_DRIFT:
        raise SystemExit(f"{what}: router logits {drift!r} apart")


def moe_dense_check(moe, model, card):
    """DeepSeek-V3's MoE layer at full width on 64 tokens, CAPACITY_FACTOR
    raised so that nothing drops, against the dense oracle."""
    cfg = model.cfg
    B, S = MOE_DENSE_SHAPE
    from repro_torch.models.transformer import _nest

    layer = {k: v[0] for k, v in model.params.items()
             if k.startswith("groups/moe/moe/")}
    params = _nest(layer)["groups"]["moe"]["moe"]
    g = torch.Generator(device="cuda").manual_seed(3)
    x = torch.randn((B, S, cfg.d_model), generator=g,
                    device="cuda").to(model.dtype)
    real = moe.CAPACITY_FACTOR
    moe.CAPACITY_FACTOR = float(cfg.num_experts)  # C >= B k
    try:
        C = moe.expert_capacity(B, cfg.num_experts, cfg.experts_per_token)
        _, gates, idx = moe.route(params, cfg, x)
        tok, _ = moe.slots(idx, gates, B, S, cfg.num_experts, C)
        kept = int((tok < B).sum())
        with torch.no_grad():
            out, aux = moe.moe_apply(params, cfg, x)
            want = moe.moe_ref_dense(params, cfg, x)
        torch.cuda.synchronize()
    finally:
        moe.CAPACITY_FACTOR = real
    if kept != B * S * cfg.experts_per_token:
        raise SystemExit(f"MoE no-drop check: {kept} of "
                         f"{B * S * cfg.experts_per_token} choices kept")
    err = float((out.float() - want.float()).abs().max())
    torch.testing.assert_close(out.float(), want.float(), rtol=DECODE_RTOL,
                               atol=DECODE_ATOL,
                               msg=lambda m: f"MoE vs moe_ref_dense: {m}")
    say(f"  {cfg.name}'s MoE layer ({cfg.num_experts} experts, top "
        f"{cfg.experts_per_token}, 1 shared) on {B}x{S} tokens, C={C}, "
        f"every choice kept ({kept}): vs moe_ref_dense max_abs_err={err!r} "
        f"(rtol {DECODE_RTOL}, atol {DECODE_ATOL}; max|out| "
        f"{float(want.float().abs().max())!r}), aux={float(aux)!r} on {card}")


def flash_main_path(flash_ops, flash_ref, call, what, card, launches):
    """A flash call recorded on a main path ((q, k, v), kwargs: causal, no
    window) held to the plain version at FLASH_TOL, then timed (median of
    REPS launches, CUDA events) beside the plain version, SDPA and its
    bound. Returns the numbers for the kernels line."""
    (q, k, v), kw = call
    if kw.get("window") is not None or not kw.get("causal", True):
        raise SystemExit(f"flash {what}: unexpected main-path options {kw}")
    err = check_flash(flash_ops, flash_ref, q, k, v, None, what)
    ms = median_ms(lambda: flash_ops.flash_attention(q, k, v))
    plain_ms = median_ms(lambda: flash_ref.flash_attention_ref(q, k, v))
    library_ms = median_ms(sdpa(q, k, v))
    bound_ms, bound_by, flops, nbytes = flash_bound(q, k)
    say(f"  flash_attention q {list(q.shape)} k {list(k.shape)} bf16 causal "
        f"(median of {REPS} launches, CUDA events): kernel_us="
        f"{ms * 1e3:.2f} plain_us={plain_ms * 1e3:.2f} library_us="
        f"{library_ms * 1e3:.2f} (scaled_dot_product_attention) bound_us="
        f"{bound_ms * 1e3:.2f} ({bound_by}; {flops} flop, {nbytes} bytes) "
        f"achieved={flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"share_of_bound={bound_ms / ms:.4f} on {card}")
    return {"shape": list(q.shape), "kv_shape": list(k.shape),
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def moe_mla_phase(serve, train, Transformer, get_config, moe, counters,
                  launches, card, flash_ops, flash_ref):
    """Phase 3b: the head_dim-160 flash form, StableLM-2-12B served at full
    width and depth, DeepSeek-V3 and Arctic served at full width with
    their depth cut, DeepSeek-V3's MoE layer against the dense oracle,
    and reduced float32 `--arch` rounds of both against the CPU. Adds the
    main-path launches to `launches`; returns the hd-160 form's numbers
    for the flash entry of the kernels line."""
    t_phase = time.perf_counter()
    run = STABLELM
    cfg = get_config(run["arch"])
    say(f"phase 3b: {run['arch']} at full width and depth, then the MoE/MLA "
        f"models at full width, on {card}:")
    model, prompts, res, res_eager, n, call, _ = serve_full_width(
        serve, Transformer, cfg, run, counters, card, flash_ops,
        "flash_attention", eager=True)
    if n["flash_attention"] != run["layers"] or sum(n.values()) != \
            run["layers"]:
        raise SystemExit(f"serve {cfg.name}: launches {n}, want "
                         f"{run['layers']} flash_attention launches")
    launches["flash_attention"] += n["flash_attention"]
    hold_captured_to_eager(f"serve {cfg.name}",
                           (res["tokens"], res["logits"]),
                           (res_eager["tokens"], res_eager["logits"]))
    del model, prompts, res, res_eager
    torch.cuda.empty_cache()

    if call[0][0].shape[-1] != 160:
        raise SystemExit(f"flash hd-160: main-path call "
                         f"{list(call[0][0].shape)}")
    hd160 = flash_main_path(flash_ops, flash_ref, call,
                            "head_dim 160 (stablelm-12b layer 0)", card,
                            n["flash_attention"])
    del call
    moe_models(serve, train, Transformer, get_config, moe, counters,
               launches, card, flash_ops)
    say(f"phase 3b took {time.perf_counter() - t_phase!r} s")
    return hd160


def moe_models(serve, train, Transformer, get_config, moe, counters,
               launches, card, flash_ops):
    """Phase 3b's MoE/MLA half: each of MOE_MODELS served at full width
    with its depth cut, decode held to the train forward, DeepSeek-V3's
    MoE layer to the dense oracle; then the reduced float32 `--arch`
    rounds against the CPU. Adds the main-path launches to `launches`."""
    for run in MOE_MODELS:
        cfg = dataclasses.replace(get_config(run["arch"]),
                                  num_layers=run["layers"])
        model, prompts, res, _, n, call, _ = serve_full_width(
            serve, Transformer, cfg, run, counters, card, flash_ops,
            "flash_attention")
        # MLA attends with the plain blocked softmax (q/k depth 192, v
        # depth 128); Arctic's GQA prefill runs the flash kernel a layer
        want = 0 if cfg.attention_type == "mla" else run["layers"]
        if n["flash_attention"] != want or sum(n.values()) != want:
            raise SystemExit(f"serve {cfg.name}: launches {n}, want {want} "
                             "flash_attention launches")
        launches["flash_attention"] += n["flash_attention"]
        if call is not None:
            (q, k, _), _ = call
            say(f"  the prefill's flash launch: q {list(q.shape)} k "
                f"{list(k.shape)} {str(q.dtype)[6:]}")
            del q, k, call
        hold_decode_to_forward(serve, moe, model, prompts, res, cfg.name)
        if cfg.num_shared_experts:
            moe_dense_check(moe, model, card)
        del model, prompts, res
        torch.cuda.empty_cache()

    say("reduced --arch runs in float32, card vs CPU:")
    restore = float32_cli(train)
    try:
        for run in MOE_MODELS:
            reset_counts(counters)
            train_vs_cpu(train, run["arch"], "float32")
            n = read_counts(counters)
            if n["fedgia_update_batched_donated"] != 8 or sum(n.values()) != 8:
                raise SystemExit(f"{run['arch']} reduced: launches {n}")
            for k_ in launches:
                launches[k_] += n[k_]
    finally:
        restore()


def hold_captured_to_eager(what, cap, eager):
    """The captured decode's tokens and logits against the `--no-scan`
    run's: tokens equal; logits bit for bit, expected, else within
    CAPTURED_LOGIT_RTOL of the largest logit (cuBLAS may pick another GEMM
    algorithm inside a capture), and said so. `cap`, `eager`: (tokens,
    logits)."""
    (t_cap, l_cap), (t_eager, l_eager) = cap, eager
    if not torch.equal(torch.as_tensor(t_cap), torch.as_tensor(t_eager)):
        raise SystemExit(f"{what}: captured tokens {t_cap.tolist()} != "
                         f"--no-scan {t_eager.tolist()}")
    if torch.equal(l_cap, l_eager):
        say("  captured vs --no-scan: tokens equal, logits bit for bit")
        return
    err = float((l_cap.float() - l_eager.float()).abs().max())
    scale = float(l_eager.float().abs().max())
    say(f"  captured vs --no-scan: tokens equal, logits NOT bit for bit: "
        f"max_abs_err={err!r} against max|logit| {scale!r} (held to "
        f"{CAPTURED_LOGIT_RTOL} of it)")
    if not err <= CAPTURED_LOGIT_RTOL * scale:
        raise SystemExit(f"{what}: captured logits off by {err!r}")


def decode_vs_forward(model, prompts, embeds, tokens, logits, what,
                      hold=True):
    """A run's logits (the prefill's last, then each decode step's; (gen,
    B, V)) against the train-mode forward over the same inputs (the
    embeddings, the prompt and the generated tokens but the last): held
    at DECODE_RTOL / DECODE_ATOL, or, without `hold`, the gap printed."""
    gen = tokens.shape[1]
    seq = (tokens[:, :gen - 1] if prompts is None
           else torch.cat([prompts, tokens[:, :gen - 1]], dim=1))
    P = seq.shape[1] - (gen - 1) + (0 if embeds is None else embeds.shape[1])
    with torch.no_grad():
        full = model.forward(seq, embeds=embeds)[:, P - 1:].transpose(0, 1)
    got, want = logits.float(), full.float()
    err = float((got - want).abs().max())
    over = float(((got - want).abs() - DECODE_ATOL
                  - DECODE_RTOL * want.abs()).max())
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    if hold:
        torch.testing.assert_close(
            got, want, rtol=DECODE_RTOL, atol=DECODE_ATOL,
            msg=lambda m: f"{what} decode vs forward: {m}")
    say(f"  {what}: prefill + decode vs the train forward over the same "
        f"{P + gen - 1} positions: max_abs_err={err!r}, largest excess over"
        f" rtol {DECODE_RTOL} / atol {DECODE_ATOL} {over!r} "
        f"({'held' if hold else 'printed, not held'}; max|logit| "
        f"{float(want.abs().max())!r}); argmax equal at {same!r}")


def hold_float32_to_forward(serve, Transformer, model, prompts, embeds,
                            gen, what):
    """The decode path held to the train forward at full width and depth
    in float32: a float32 copy of `model`'s weights serves `prompts`
    (after `embeds`) through `serve.generate` (captured, its own tokens),
    and its logits are held to the float32 forward at DECODE_RTOL /
    DECODE_ATOL. In bfloat16 the two part by more at depth, in the
    reference too (tests/test_torch_hybrid_ssm.py), so there the gap is
    printed."""
    wide = Transformer(dataclasses.replace(model.cfg, dtype="float32"),
                       "cuda").load_params({k: v.float() for k, v in
                                            model.params.items()})
    res = serve.generate(wide, prompts, gen, embeds=embeds)
    decode_vs_forward(wide, prompts, embeds, res["tokens"], res["logits"],
                      f"{what} float32 copy")
    del wide, res
    torch.cuda.empty_cache()


def ssm_prefill_share(model, ssm, prompts, cache_len, card):
    """One more prefill of `prompts` with CUDA events around each layer's
    `ssm_apply`: the SSM branch's device time (which, the scan being one
    launch a step, is the host's enqueue time) against the prefill's wall
    time, printed. Returns (ssm seconds, prefill seconds)."""
    events = []
    real = ssm.ssm_apply

    def timed(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    ssm.ssm_apply = timed
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.prefill(prompts, cache_len=cache_len)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ssm.ssm_apply = real
    ms = [s.elapsed_time(e) for s, e in events]
    if len(ms) != model.cfg.num_layers:
        raise SystemExit(f"ssm share: {len(ms)} ssm_apply calls")
    say(f"  the SSM branch in a prefill of {list(prompts.shape)}: "
        f"{sum(ms)!r} ms of {wall * 1e3!r} ms (share {sum(ms) / 1e3 / wall!r}"
        f"; layer 0 {ms[0]!r} ms, median layer {statistics.median(ms)!r} ms;"
        f" CUDA events, plain PyTorch scan, one launch a step) on {card}")
    return sum(ms) / 1e3, wall


def hymba_serve(serve, Transformer, get_config, ssm, counters, launches,
                card, flash_ops):
    """Hymba-1.5B at full width and depth through the serve CLI
    (`serve.serve` given the weights drawn once from prng_key(0), timed,
    and the CLI's own prompts), captured and `--no-scan`: 32 flash
    launches each, the two runs' tokens and logits held to each other,
    decode against the train forward (the bf16 gap printed, a float32
    copy held), the SSM branch's share of a prefill. Returns the recorded
    layer-0 flash call."""
    from repro_torch.core.prng import prng_key

    argv = HYMBA
    cfg = get_config(argv[1])
    batch, P, gen = (int(argv[argv.index(f) + 1])
                     for f in ("--batch", "--prompt-len", "--gen"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model = Transformer(cfg, "cuda").init(prng_key(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in model.params.values())
    # the CLI's prompts: a generator on the card seeded with --seed
    rng = torch.Generator(device="cuda").manual_seed(0)
    prompts = torch.randint(0, cfg.vocab_size, (batch, P), generator=rng,
                            device="cuda")
    runs, call = {}, None
    for mode, extra in (("captured", []), ("--no-scan", ["--no-scan"])):
        tokens, n, times, rec, logits = serve_main_path(
            serve, counters, argv + extra, flash_ops, "flash_attention",
            params=model.params, prompts=prompts)
        tokens = torch.as_tensor(tokens)
        capture = ("" if times["capture_s"] is None
                   else f"capture_s={times['capture_s']!r} ")
        say(f"serve {cfg.name} {mode} (cuda, full width and depth, "
            f"{cfg.num_layers} layers, {n_params} parameters, batch {batch},"
            f" prompt {P}, gen {gen}): init_s={init_s!r} "
            f"prefill_s={times['prefill_s']!r} {capture}"
            f"decode_s={times['decode_s']!r} "
            f"decode_tok_s_req={times['decode_tok_s_req']!r} on {card}")
        say(f"  generated[0,:16] = {tokens[0, :16].tolist()}; launches {n}")
        if n["flash_attention"] != cfg.num_layers or \
                sum(n.values()) != cfg.num_layers:
            raise SystemExit(f"serve {cfg.name} {mode}: launches {n}, want "
                             f"{cfg.num_layers} flash_attention launches")
        if tokens.shape != (batch, gen) or tokens.min() < 0 or \
                tokens.max() >= cfg.vocab_size or \
                not torch.isfinite(logits.float()).all():
            raise SystemExit(f"serve {cfg.name}: bad tokens or logits")
        if mode == "captured":
            if not times["capture_s"]:
                raise SystemExit(f"serve {cfg.name}: no capture logged")
            launches["flash_attention"] += n["flash_attention"]
            call, step_ms = rec, times["decode_s"] / (gen - 1) * 1e3
        runs[mode] = tokens, logits
    peak = torch.cuda.max_memory_allocated()
    cache = model.init_cache(batch, P + gen)
    bound, nbytes = decode_bound_ms(model, cache)
    del cache
    say(f"  captured decode {step_ms!r} ms a step against its bound "
        f"{bound!r} ms ({nbytes} bytes of weights and cache at 3.35 TB/s);"
        f" peak device memory {peak} bytes ({gib(peak):.2f} GiB) on {card}")
    hold_captured_to_eager(f"serve {cfg.name}", runs["captured"],
                           runs["--no-scan"])
    tokens, logits = runs["captured"]
    decode_vs_forward(model, prompts, None, tokens.cuda(), logits,
                      f"{cfg.name} bf16", hold=False)
    hold_float32_to_forward(serve, Transformer, model, prompts, None, gen,
                            cfg.name)
    ssm_prefill_share(model, ssm, prompts, P + gen, card)
    del model, runs
    torch.cuda.empty_cache()
    return call


def hybrid_embeds_phase(serve, train, Transformer, get_config, ssm,
                        counters, launches, card, flash_ops, flash_ref):
    """Phase 3c: Hymba-1.5B (`hymba_serve`), LLaVA-NeXT and MusicGen-large
    served at full width and depth (`serve_full_width` with their
    embeddings; decode against the train forward as Hymba's), each
    model's layer-0 flash call held to the plain version and timed beside
    its bound and SDPA, then the reduced float32 `--arch` rounds of the
    three against the CPU. Adds the main-path launches to `launches`;
    returns the flash numbers a model for the kernels line."""
    t_phase = time.perf_counter()
    say(f"phase 3c: the hybrid SSM block and the embeds inputs at full width "
        f"and depth, on {card}:")
    calls = {"hymba-1.5b": hymba_serve(serve, Transformer, get_config, ssm,
                                       counters, launches, card, flash_ops)}
    for run in EMBEDS_MODELS:
        cfg = get_config(run["arch"])
        model, prompts, res, _, n, call, embeds = serve_full_width(
            serve, Transformer, cfg, run, counters, card, flash_ops,
            "flash_attention")
        if n["flash_attention"] != cfg.num_layers or \
                sum(n.values()) != cfg.num_layers:
            raise SystemExit(f"serve {cfg.name}: launches {n}, want "
                             f"{cfg.num_layers} flash_attention launches")
        launches["flash_attention"] += n["flash_attention"]
        decode_vs_forward(model, prompts, embeds, res["tokens"],
                          res["logits"], f"{cfg.name} bf16", hold=False)
        hold_float32_to_forward(serve, Transformer, model, prompts, embeds,
                                run["gen"], cfg.name)
        calls[run["arch"]] = call
        del model, prompts, res, embeds
        torch.cuda.empty_cache()

    flash = {}
    for arch in SLICE14_ARCHS:
        cfg = get_config(arch)
        flash[arch] = flash_main_path(
            flash_ops, flash_ref, calls.pop(arch),
            f"{arch} layer 0 (H {cfg.num_heads}, Kv {cfg.num_kv_heads})",
            card, cfg.num_layers)
        torch.cuda.empty_cache()

    say("reduced --arch runs in float32, card vs CPU:")
    restore = float32_cli(train)
    try:
        for arch in SLICE14_ARCHS:
            reset_counts(counters)
            train_vs_cpu(train, arch, "float32")
            n = read_counts(counters)
            if n["fedgia_update_batched_donated"] != 8 or sum(n.values()) != 8:
                raise SystemExit(f"{arch} reduced: launches {n}")
            for k_ in launches:
                launches[k_] += n[k_]
    finally:
        restore()
    say(f"phase 3c took {time.perf_counter() - t_phase!r} s")
    return flash


def client_store_phase(pop, train, counters, launches, card):
    """Phase 2d: the client stores at the population size on the
    population run's data (`pop`), the paper run under `--store active`
    against the CPU, and engine_bench's million-client rows. Adds the
    launches of its runs to `launches`; returns the million-client rows
    (phase 2h's engine section reuses them)."""
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import engine_bench
    from repro_torch.config import FedConfig
    from repro_torch.core import api as api_mod
    from repro_torch.core import engine, prng, selection

    t_phase = time.perf_counter()
    m = pop["batch"]["A"].shape[0]
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    model, batch = pop["algorithm"].model, pop["batch"]
    say(f"client stores at the population size (m={m}), uniform alpha "
        f"{STORE_ALPHA}, {rounds} rounds, tol 0, replayed (offload: its "
        f"host loop), on {card}; FedPD at lr {STORE_FEDPD_LR}:")
    per_round = {}
    for name in ("fedgia",) + BASELINES:
        if name == "fedgia":
            algo = pop["algorithm"]  # diag_ema H
        else:
            hp = dict(bench_common.ALGO_HPARAMS[name])
            if name == "fedpd":
                hp["lr"] = STORE_FEDPD_LR
            algo = api_mod.make_algorithm(
                FedConfig(algorithm=name, num_clients=m, **hp), model.loss,
                model=model)
        state = algo.init(model.init(batch["A"].device),
                          prng.prng_key(1), init_batch=batch)
        cap = selection.make_policy("uniform", m, STORE_ALPHA).active_capacity
        stores = ["dense", "active"]
        if name in ("fedgia", "fedpd", "scaffold"):
            stores.append("offload")
        out = {}
        for store in stores:
            reset_counts(counters)
            res = engine.run_rounds(
                algo, state, batch, rounds, store=store,
                participation=selection.make_policy("uniform", m,
                                                    STORE_ALPHA))
            n = read_counts(counters)
            extra = ""
            if store == "offload":
                extra = (f"; tile copies on the host {res.extras['copy_s']!r}"
                         f" s, extras {res.extras}")
            say(f"  {name} store={store}: {res.rounds_run} rounds, "
                f"{res.wall_s / rounds * 1e3!r} ms a round (capture "
                f"{res.capture_s!r} s apart), of which the host's mask "
                f"draws{'' if store == 'dense' else ' and packs'} "
                f"{res.draw_s / rounds * 1e3!r} ms; f="
                f"{float(res.history['f_xbar'][-1])!r}; launches {n}{extra}")
            want = rounds if name == "fedgia" else 0
            if res.rounds_run != rounds or sum(n.values()) != want or (
                    want and n["fedgia_update_batched"] != want):
                raise SystemExit(f"{name} store={store}: {res.rounds_run} "
                                 f"rounds, launches {n}, want {want}")
            launches["fedgia_update_batched"] += n["fedgia_update_batched"]
            out[store] = res
        sel = out["active"].history["selected"]
        if not (sel == cap).all():
            raise SystemExit(f"{name}: selected {sel}, want {cap} a round")
        # cuBLAS may pick another algorithm for a (capacity, ...) batch
        # than for an (m, ...) one: then the states are held to
        # STATE_RTOL, and the line says so
        hold_replayed_to_eager(out["active"].state, out["dense"].state,
                               f"{name} active vs dense",
                               label="active vs dense")
        if "offload" in out:
            hold_replayed_to_eager(out["offload"].state, out["active"].state,
                                   f"{name} offload vs active",
                                   bitwise_only=True,
                                   label="offload vs active")
        per_round[name] = [out[k].wall_s / rounds * 1e3 for k in stores]
        if name in ("fedavg", "scaffold"):
            packed = engine.run_rounds(
                algo, state, batch, rounds, store="active",
                aggregate="packed",
                participation=selection.make_policy("uniform", m,
                                                    STORE_ALPHA))
            # another order of the eq. (11) sum, and the server variate's
            # mean cancels: each final state is held normwise
            errs = {}
            for k, tree in out["active"].state.items():
                if isinstance(tree, dict):
                    for leaf, want in tree.items():
                        d = packed.state[k][leaf] - want
                        rel = float(d.norm() / want.norm().clamp_min(1e-30))
                        errs[f"{k}.{leaf}"] = (rel, float(d.abs().max()))
                        if not rel <= PACKED_RTOL:
                            raise SystemExit(
                                f"{name} packed vs dense aggregate "
                                f"{k}.{leaf}: normwise {rel!r} > "
                                f"{PACKED_RTOL}")
            say(f"  {name} aggregate=packed: "
                f"{packed.wall_s / rounds * 1e3!r} ms a round; final state "
                f"against the dense aggregate's, (normwise relative, "
                f"largest absolute) difference {errs}, held to normwise "
                f"{PACKED_RTOL}")
            del packed
        del out, state
    say("  ms a round (dense, active[, offload]): " + ", ".join(
        f"{k} " + " / ".join(repr(t) for t in v)
        for k, v in per_round.items()))

    for name in ("fedgia", "scaffold"):
        argv = PAPER + ["--participation", "uniform", "--alpha", "0.25",
                        "--store", "active"]
        if name == "scaffold":
            argv += ["--algo", "scaffold", "--lr",
                     str(bench_common.ALGO_HPARAMS["scaffold"]["lr"])]
        got, n = run_main_path(train, counters, argv)
        say(done_line(f"{name} paper run, uniform 0.25, --store active "
                      f"(cuda)", got))
        say(f"  launches: {n}; mask draws and packs {got['draw_s']!r} s on "
            f"the host")
        want = got["rounds"] if name == "fedgia" else 0
        if sum(n.values()) != want or (
                want and n["fedgia_update_batched_donated"] != want):
            raise SystemExit(f"{name} paper run, --store active: launches "
                             f"{n}, want {want}")
        launches["fedgia_update_batched_donated"] += \
            n["fedgia_update_batched_donated"]
        cpu = train.main(argv + ["--device", "cpu"])
        card_vs_cpu_run(got, cpu, f"{name} paper run under --store active")
        del got, cpu

    say(f"engine_bench at m = {engine_bench.M_1M}, alpha "
        f"{engine_bench.ALPHA_1M}, n = {engine_bench.N_FEATURES}, "
        f"{engine_bench.ROUNDS_1M} rounds, on {card}:")
    reset_counts(counters)
    rows = {"active_1m": engine_bench.run_active_1m("cuda"),
            "offload_1m": engine_bench.run_offload_1m("cuda")}
    n = read_counts(counters)
    for key, row in rows.items():
        say(f"  {key}: {json.dumps(row)}")
    if sum(n.values()):
        raise SystemExit(f"engine_bench launched kernels: {n}")
    off = rows["offload_1m"]
    say(f"  offload_1m: {off['rounds_per_s']!r} rounds/s; the tile round's "
        f"device peak {off['peak_device_bytes']} bytes, below the "
        f"{off['dense_resident_bytes']} bytes of the dense store's lambda "
        f"buffer; {off['host_resident_bytes']} bytes in host memory")
    say(f"phase 2d took {time.perf_counter() - t_phase!r} s")
    return rows


def fp64_witness(row, rounds):
    """The stop metric a round of a runner's row (`async_bench` or
    `wallclock_bench`, its compression, overlap and fault rows) re-run on
    the CPU in float64, tol 0, for `rounds` rounds: how far float32
    arithmetic moves it near the stop."""
    from repro_torch.benchmarks import async_bench, wallclock_bench
    from repro_torch.benchmarks.common import M_CLIENTS, make_problem
    from repro_torch.config import FedConfig
    from repro_torch.core import api, clock, engine, prng, selection

    m = M_CLIENTS
    algo_key, metric = row["algo"], "grad_sq_norm"
    if "codec" in row:  # the compression and fault rows: stop on f
        from repro_torch.core import faults

        bench, algo_key, metric = wallclock_bench, "fedgia_d", "f_xbar"
        if row["algo"] in ("fedgia_d_bw", "fedgia_d_ovl_off",
                           "fedgia_d_ovl_on"):
            kw = dict(clock=clock.ComputeClock(
                m, compute_s=bench.COMPRESS_COMPUTE_S,
                bandwidth_bps=bench.BANDWIDTH_BPS),
                overlap=row.get("overlap", "off"),
                **dict(bench.CODECS)[row["codec"]])
        else:
            kw = dict(clock=clock.ComputeClock(
                m, bench.straggler_speeds(m, bench.FAULT_SPREAD)))
            if row["algo"] == "fedgia_d_faulty":
                kw.update(faults=faults.make_faults(
                    bench.FAULT_KINDS, [bench.FAULT_RATE], num_clients=m),
                    screening=faults.Screening(bench.FAULT_CLIP),
                    quorum=bench.FAULT_QUORUM)
        kw.update(max_staleness=bench.MAX_STALENESS)
    elif "spread" in row:
        bench = wallclock_bench
        kw = dict(clock=clock.ComputeClock(
            m, wallclock_bench.straggler_speeds(m, row["spread"])),
            max_staleness=bench.MAX_STALENESS,
            stale_weighting=row["weighting"])
    else:
        bench = async_bench
        kw = dict(participation=async_bench._arrival(m, bench.MAX_ROUNDS),
                  async_rounds=True, max_staleness=row["max_staleness"])
    model, batch, _ = make_problem("linreg", 0, "cpu")
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in batch.items()}
    fed = FedConfig(num_clients=m, k0=bench.K0, state_dtype="float64",
                    **bench.ALGOS[algo_key])
    algo = api.make_algorithm(fed, model.loss, model=model)
    params = {k: v.double() for k, v in model.init("cpu").items()}
    state = algo.init(params, prng.prng_key(1), init_batch=batch)
    res = engine.run_rounds(algo, state, batch, rounds, scan=False, **kw)
    return res.history[metric].tolist()


def hold_rows(gpu, cpu, exact, what, tol=PAPER_TOL):
    """A runner's rows on the card against the CPU's, each row's
    per-round `history` of (f, stop metric, staleness max[, sim_time])
    held as `hold_card_to_cpu` holds runs, Obj at ROW_OBJ_RTOL and the
    stop band at ROW_STOP_RTOL; the keys `exact` equal, but for those
    that move with the rounds where the two runs stopped one round apart.
    Such a row is re-run on the CPU in float64 (`fp64_witness`) and its
    stop metrics printed beside the float32 runs'."""
    if len(gpu) != len(cpu):
        raise SystemExit(f"{what}: {len(gpu)} rows (cuda), {len(cpu)} (cpu)")
    apart = 0
    for g, c in zip(gpu, cpu):
        label = f"{what} " + " ".join(
            f"{k}={g[k]}" for k in exact if k in ROW_KEYS)
        hg, hc = g["history"], c["history"]
        hold_card_to_cpu(hg, hc, tol, label, f_rtol=ROW_OBJ_RTOL,
                         stop_rtol=ROW_STOP_RTOL)
        keys = exact if len(hg) == len(hc) else [
            k for k in exact if k not in ("cr", "staleness_seen",
                                          "sim_time_s")]
        bad = [k for k in keys if g[k] != c[k]]
        if bad:
            row = lambda r: {k: v for k, v in r.items()  # noqa: E731
                             if k != "history"}
            raise SystemExit(f"{label}: {bad} differ, cuda {row(g)} cpu "
                             f"{row(c)}")
        if len(hg) != len(hc):
            apart += 1
            r = min(len(hg), len(hc)) - 1
            w = fp64_witness(g, max(len(hg), len(hc)))
            first = next((i for i, e in enumerate(w) if e < tol), None)
            say(f"  {label}: stopped one round apart, cr {g['cr']} (cuda) "
                f"{c['cr']} (cpu); stop metric at round {r}: {hg[r][1]!r} "
                f"(cuda) {hc[r][1]!r} (cpu) {w[r]!r} (float64, CPU), off "
                f"tol by {hg[r][1] / tol - 1:+.6f}, {hc[r][1] / tol - 1:+.6f}"
                f", {w[r] / tol - 1:+.6f} of it; float64 first below tol at "
                f"round {first}")
    say(f"  {what}: {len(gpu)} rows, card against CPU: {', '.join(exact)} "
        f"equal, staleness and sim_time equal every round, obj within rel "
        f"{ROW_OBJ_RTOL}; {apart} rows stopped one round apart, within "
        f"{ROW_STOP_RTOL} of tol")


def print_rows(rows, keys, tag):
    say(f"  [{tag}] " + ",".join(keys))
    for r in rows:
        say(f"  [{tag}] " + ",".join(repr(r[k]) for k in keys))


def async_phase(pop, counters, launches, card, ops, ref, kept):
    """Phase 2e: the async and clocked rounds. Adds the launches of its
    runs to `launches` and wallclock_bench's spread rows to
    `kept["wallclock"]` (phase 2h writes them out); returns the kernels
    line's entry for the (m, N) anchor form of `fedgia_update_batched`."""
    from repro_torch.benchmarks import async_bench
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import engine_bench, wallclock_bench
    from repro_torch.config import FedConfig
    from repro_torch.core import api as api_mod
    from repro_torch.core import clock as clock_mod
    from repro_torch.core import engine, prng, selection
    from repro_torch.utils import pytree as pt

    t_phase = time.perf_counter()
    per_client = 0  # launches with an (m, N) anchor on this phase's runs

    def gia_launches(rows, n, forms, what):
        """FedGiA_D launches the batched kernel once a round that ran,
        with an (m, N) anchor where the bound is above 0; no other run
        launches a kernel."""
        gia = [r for r in rows if r["algo"] == "fedgia_d"]
        want = sum(r["cr"] // 2 for r in gia)
        want_mn = sum(r["cr"] // 2 for r in gia
                      if r.get("max_staleness", ASYNC_MAX_STALENESS) > 0)
        say(f"  {what} launches: {n}, by anchor form {forms}")
        if n["fedgia_update_batched"] != want or sum(n.values()) != want \
                or forms["(mb, N)"] != want_mn:
            raise SystemExit(f"{what}: launches {n} {forms}, want {want} "
                             f"fedgia_update_batched, {want_mn} of them "
                             f"with an (m, N) anchor")
        launches["fedgia_update_batched"] += want
        return want_mn

    say(f"async_bench (m={bench_common.M_CLIENTS}, k0={async_bench.K0}, "
        f"periodic arrivals, max_staleness {async_bench.STALENESS}) on "
        f"{card} and on the CPU:")
    reset_counts(counters)
    gpu = async_bench.run("cuda", collect_history=True)
    n, forms = read_counts(counters), dict(ops.anchor_forms)
    cpu = async_bench.run("cpu", collect_history=True)
    keys = ("algo", "max_staleness", "staleness_seen", "cr", "time_s", "obj",
            "converged")
    print_rows(gpu, keys, "cuda")
    print_rows(cpu, keys, "cpu")
    async_bench.check(gpu)
    hold_rows(gpu, cpu, ("algo", "max_staleness", "staleness_seen", "cr",
                         "converged"), "async_bench")
    per_client += gia_launches(gpu, n, forms, "async_bench")

    say(f"wallclock_bench (m={bench_common.M_CLIENTS}, k0="
        f"{wallclock_bench.K0}, up to {WALLCLOCK_ROUNDS} rounds, spreads "
        f"{wallclock_bench.SPREADS}, "
        f"weightings {wallclock_bench.WEIGHTINGS}, max_staleness "
        f"{wallclock_bench.MAX_STALENESS}) on {card} and on the CPU:")
    reset_counts(counters)
    gpu = wallclock_bench.run("cuda", WALLCLOCK_ROUNDS, collect_history=True)
    n, forms = read_counts(counters), dict(ops.anchor_forms)
    cpu = wallclock_bench.run("cpu", WALLCLOCK_ROUNDS, collect_history=True)
    keys = ("algo", "spread", "weighting", "cr", "sim_time_s",
            "staleness_seen", "time_s", "obj", "converged")
    print_rows(gpu, keys, "cuda")
    print_rows(cpu, keys, "cpu")
    wallclock_bench.check(gpu)
    hold_rows(gpu, cpu, ("algo", "spread", "weighting", "cr", "sim_time_s",
                         "staleness_seen", "converged"), "wallclock_bench")
    per_client += gia_launches(gpu, n, forms, "wallclock_bench")
    kept["wallclock"] = [dict(r) for r in gpu]
    del gpu, cpu

    reset_counts(counters)
    row = engine_bench.run_async("cuda")
    n, forms = read_counts(counters), dict(ops.anchor_forms)
    say(f"engine_bench's async row on {card}: {json.dumps(row)}; launches "
        f"{n}, by anchor form {forms}")
    want = 2 * engine_bench.REPEATS_ASYNC * row["rounds"]
    if n["fedgia_update_batched"] != want or sum(n.values()) != want or \
            forms["(mb, N)"] != want // 2:
        raise SystemExit(f"engine_bench async row: launches {n} {forms}, "
                         f"want {want}, half with an (m, N) anchor")
    launches["fedgia_update_batched"] += want
    per_client += want // 2

    algo, batch = pop["algorithm"], pop["batch"]
    model, dev = algo.model, batch["A"].device
    m = batch["A"].shape[0]
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    clk = clock_mod.ComputeClock(
        m, wallclock_bench.straggler_speeds(m, ASYNC_SPREAD))
    kw = dict(clock=clk, max_staleness=ASYNC_MAX_STALENESS,
              stale_weighting="poly")
    state = algo.init(model.init(dev), prng.prng_key(1),
                      init_batch=batch)
    what = (f"FedGiA_D async population run (m={m}, straggler clock spread "
            f"{ASYNC_SPREAD}, max_staleness {ASYNC_MAX_STALENESS}, poly)")
    say(f"{what}, {rounds} rounds, tol 0, on {card}:")
    out = {}
    for tag, scan in (("replayed", True), ("eager", False)):
        reset_counts(counters)
        res = engine.run_rounds(algo, state, batch, rounds, scan=scan, **kw)
        n, forms = read_counts(counters), dict(ops.anchor_forms)
        st = res.history["staleness"]
        say(f"  {tag}: {res.rounds_run} rounds, "
            f"{res.wall_s / res.rounds_run * 1e3!r} ms a round (capture "
            f"{res.capture_s!r} s apart), of which the host's clock ticks "
            f"{res.draw_s / res.rounds_run * 1e3!r} ms; f="
            f"{float(res.history['f_xbar'][-1])!r}; sim_time "
            f"{float(res.history['sim_time'][-1])!r}; arrivals a round "
            f"{res.history['selected'].tolist()}; staleness max a round "
            f"{res.history['staleness_max'].tolist()}; launches {n}, by "
            f"anchor form {forms}")
        if res.rounds_run != rounds or n["fedgia_update_batched"] != rounds \
                or sum(n.values()) != rounds or forms["(mb, N)"] != rounds:
            raise SystemExit(f"{what} ({tag}): {res.rounds_run} rounds, "
                             f"launches {n} {forms}, want {rounds} with an "
                             f"(m, N) anchor")
        if st.max() > ASYNC_MAX_STALENESS or st.shape != (rounds, m):
            raise SystemExit(f"{what} ({tag}): staleness {st.max()} above "
                             f"the bound or shape {st.shape}")
        out[tag] = res
    graph_res, eager_res = out["replayed"], out["eager"]
    hold_replayed_to_eager(graph_res.state, eager_res.state, what,
                           bitwise_only=True)
    for k, v in graph_res.history.items():
        if not (v == eager_res.history[k]).all():
            raise SystemExit(f"{what}: history {k} replayed != eager")
    say("  replayed vs eager history (staleness, sim_time, f, |grad|^2): "
        "bitwise equal")
    launches["fedgia_update_batched"] += rounds
    per_client += rounds

    def anchor_launch(res, mask, tag):
        """The (m, N)-anchor launch held against its plain version on the
        operands of the round after `res` (arrival mask `mask`) and
        timed; its entry of the kernels line."""
        spec = pt.ravel_spec(res.state["x"])
        flat = engine.flatten_state(algo, res.state, spec)
        stale = res.stale.clone()
        xbar, sel, _, _, gbar = algo.round_inputs(flat, batch, spec,
                                                  mask.to(dev), stale)
        anchor = api_mod.stale_anchor(stale, xbar)
        args = algo.kernel_args(flat, anchor, gbar, sel)
        k = hold_and_time("fedgia_update_batched", args, ops, ref,
                          round_form=True)
        nbytes = k.pop("nbytes")
        all_rows = 6 * m * spec.padded_size * 4 + m  # 4 reads, 2 writes, sel
        say(f"  fedgia_update_batched {k['shape']} [{k.pop('form')}], "
            f"{tag}: kernel_us={k['ms'] * 1e3:.3f} in_graph_us="
            f"{k['graph_ms'] * 1e3:.3f} plain_us={k['plain_ms'] * 1e3:.2f} "
            f"bound_us={k['bound_ms'] * 1e3:.3f} (bytes this round's "
            f"{int(sel.sum())} arrivals need: {nbytes}) share_of_bound="
            f"{k['bound_ms'] / k['ms']:.4f}; every row's pi and h read: "
            f"{all_rows} bytes, bound_us={bound(all_rows) * 1e3:.3f}, "
            f"share={bound(all_rows) / k['ms']:.4f}; anchors' ages "
            f"{torch.bincount(stale.last_used.cpu()).tolist()}")
        return {"shape": k["shape"], "arrivals": int(sel.sum()),
                "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                "graph_ms": k["graph_ms"], "plain_ms": k["plain_ms"],
                "bound_ms": k["bound_ms"], "bound_by": "bytes",
                "all_rows_bound_ms": bound(all_rows)}

    anchor_entry = anchor_launch(
        graph_res, clk.tick(graph_res.clock_state, rounds)[0],
        "the clocked run's next round")
    del graph_res, eager_res, out

    # a mixed round: uniform arrivals, so the ADMM branch runs on half
    # the rows and the others carry anchors of every age up to the bound
    pol = selection.make_policy("uniform", m, ASYNC_MIXED_ALPHA)
    what = (f"FedGiA_D async population run (m={m}, uniform alpha "
            f"{ASYNC_MIXED_ALPHA}, max_staleness {ASYNC_MAX_STALENESS}, "
            f"poly)")
    reset_counts(counters)
    mixed = engine.run_rounds(algo, state, batch, ASYNC_MIXED_ROUNDS,
                              participation=pol, async_rounds=True,
                              max_staleness=ASYNC_MAX_STALENESS,
                              stale_weighting="poly")
    n, forms = read_counts(counters), dict(ops.anchor_forms)
    say(f"{what}, {ASYNC_MIXED_ROUNDS} rounds, tol 0, on {card}: "
        f"{mixed.wall_s / mixed.rounds_run * 1e3!r} ms a round (capture "
        f"{mixed.capture_s!r} s apart), of which the host's draws "
        f"{mixed.draw_s / mixed.rounds_run * 1e3!r} ms; arrivals a round "
        f"{mixed.history['selected'].tolist()}; staleness max a round "
        f"{mixed.history['staleness_max'].tolist()}; launches {n}, by "
        f"anchor form {forms}")
    if mixed.rounds_run != ASYNC_MIXED_ROUNDS or \
            n["fedgia_update_batched"] != ASYNC_MIXED_ROUNDS or \
            sum(n.values()) != ASYNC_MIXED_ROUNDS or \
            forms["(mb, N)"] != ASYNC_MIXED_ROUNDS or \
            mixed.history["staleness_max"].max() > ASYNC_MAX_STALENESS:
        raise SystemExit(f"{what}: {mixed.rounds_run} rounds, launches {n} "
                         f"{forms}, staleness max "
                         f"{mixed.history['staleness_max'].tolist()}")
    launches["fedgia_update_batched"] += ASYNC_MIXED_ROUNDS
    per_client += ASYNC_MIXED_ROUNDS
    anchor_entry["mixed_round"] = anchor_launch(
        mixed, pol.mask(mixed.policy_state, ASYNC_MIXED_ROUNDS)[0],
        f"round {ASYNC_MIXED_ROUNDS} of that run")
    anchor_entry["launches"] = per_client
    del mixed

    say(f"async stores at the population size, uniform alpha {STORE_ALPHA},"
        f" max_staleness {ASYNC_STORE_STALENESS}, {rounds} rounds, on "
        f"{card}; FedPD at lr {STORE_FEDPD_LR}:")
    kw = dict(async_rounds=True, max_staleness=ASYNC_STORE_STALENESS)
    for name, stores in (("scaffold", ("dense", "active")),
                         ("fedpd", ("active", "offload"))):
        hp = dict(bench_common.ALGO_HPARAMS[name])
        if name == "fedpd":
            hp["lr"] = STORE_FEDPD_LR
        algo = api_mod.make_algorithm(
            FedConfig(algorithm=name, num_clients=m, **hp), model.loss,
            model=model)
        state = algo.init(model.init(dev), prng.prng_key(1),
                          init_batch=batch)
        res = {}
        for store in stores:
            reset_counts(counters)
            r = engine.run_rounds(
                algo, state, batch, rounds, store=store,
                participation=selection.make_policy("uniform", m,
                                                    STORE_ALPHA), **kw)
            n = read_counts(counters)
            extra = (f"; extras {r.extras}" if store == "offload" else "")
            say(f"  {name} store={store}: {r.rounds_run} rounds, "
                f"{r.wall_s / rounds * 1e3!r} ms a round, of which the "
                f"host's draws{'' if store == 'dense' else ' and packs'} "
                f"{r.draw_s / rounds * 1e3!r} ms; f="
                f"{float(r.history['f_xbar'][-1])!r}; staleness max "
                f"{int(r.history['staleness_max'].max())}; launches {n}"
                f"{extra}")
            if r.rounds_run != rounds or sum(n.values()) or \
                    r.history["staleness_max"].max() > ASYNC_STORE_STALENESS:
                raise SystemExit(f"{name} async store={store}: "
                                 f"{r.rounds_run} rounds, launches {n}")
            res[store] = r
        a, b = (res[s] for s in stores)
        hold_replayed_to_eager(b.state, a.state, f"{name} async",
                               bitwise_only=True,
                               label=f"{stores[1]} vs {stores[0]}")
        for key in ("staleness", "selected"):
            if not (a.history[key] == b.history[key]).all():
                raise SystemExit(f"{name} async: {key} differs between "
                                 f"stores")
        if not torch.equal(a.stale.anchor, b.stale.anchor):
            raise SystemExit(f"{name} async: final stale anchors differ")
        if "offload" in res:
            ext = res["offload"].extras
            say(f"  {name} offload: device peak {ext['device_peak_bytes']} "
                f"bytes, host-resident {ext['host_resident_bytes']} bytes "
                f"(the (m, N) stale anchor among them), tile copies "
                f"{ext['copy_s']!r} s on the host")
        del res, a, b, state
    say(f"phase 2e took {time.perf_counter() - t_phase!r} s")
    return anchor_entry


def numpy_fault_hits(fm, round_idx, m, prng):
    """The fault model's hits of round `round_idx` for rows 0..m-1 from
    the numpy forms of the threefry chains (the per-row keys hashed at
    once: the numpy hash takes a (2, m) key)."""
    import numpy as np

    base = prng.fold_in(prng.prng_key(fm.seed), round_idx)
    hits = {}
    rows = np.arange(m, dtype=np.uint32)
    zeros = np.zeros(m, np.uint32)
    for j, s in enumerate(fm.specs):
        kkey = prng.fold_in(base, j)
        a, b = prng.threefry2x32(kkey, zeros, rows)  # fold_in of each row
        w0, w1 = prng.threefry2x32(np.stack([a, b]), zeros, zeros)
        bits = ((w0 ^ w1) >> np.uint32(9)) | np.uint32(0x3F800000)
        u = bits.view(np.float32) - np.float32(1.0)
        hits[s.kind] = u < np.float32(s.rate)
    return hits


def numpy_randint16(prng, key, n):
    """`randint(key, (n,), 0, 1 << 16, uint32)` from the numpy forms: the
    low 16 bits of the split key's second block (the span's multiplier
    (2**16 mod 2**16)**2 is 0)."""
    import numpy as np

    _, k2 = prng.split(key)
    return (prng.random_bits(k2, n) & np.uint32(0xFFFF)).astype(np.int64)


def uplink_phase(pop, counters, launches, card, kept):
    """Phase 2f: the device threefry, the codecs, the faults, the guard
    and checkpoint-resume at the population size, and wallclock_bench's
    compression and fault rows against the CPU. Adds the launches of its
    runs to `launches` and the wallclock rows to `kept["wallclock"]`."""
    import numpy as np

    from repro_torch.benchmarks import wallclock_bench
    from repro_torch.config import FedConfig
    from repro_torch.core import api as api_mod
    from repro_torch.core import compress, engine, faults, prng, selection
    from repro_torch.utils import pytree as pt

    t_phase = time.perf_counter()
    algo, batch = pop["algorithm"], pop["batch"]
    model, dev = algo.model, batch["A"].device
    m, n = batch["A"].shape[0], model.n
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    state0 = algo.init(model.init(dev), prng.prng_key(1), init_batch=batch)

    def gia_run(what, want_rounds=rounds, **kw):
        """A FedGiA_D population run, its launches read apart: one
        fedgia_update_batched a round, nothing else."""
        reset_counts(counters)
        res = engine.run_rounds(algo, state0, batch, want_rounds, **kw)
        got = read_counts(counters)
        if res.rounds_run != want_rounds or \
                got["fedgia_update_batched"] != want_rounds or \
                sum(got.values()) != want_rounds:
            raise SystemExit(f"{what}: {res.rounds_run} rounds, launches "
                             f"{got}, want {want_rounds}")
        launches["fedgia_update_batched"] += want_rounds
        if not np.isfinite(res.history["f_xbar"]).all():
            raise SystemExit(f"{what}: non-finite f")
        return res

    def same(a, b, what):
        """Two runs' histories and final states, bit for bit."""
        if a.rounds_run != b.rounds_run or set(a.history) != set(b.history):
            raise SystemExit(f"{what}: rounds {a.rounds_run} vs "
                             f"{b.rounds_run}, keys {sorted(a.history)} vs "
                             f"{sorted(b.history)}")
        for k in a.history:
            if not np.array_equal(a.history[k], b.history[k],
                                  equal_nan=True):
                raise SystemExit(f"{what}: history {k} differs")
        hold_replayed_to_eager(a.state, b.state, what, bitwise_only=True,
                               label=what)

    # device threefry -------------------------------------------------------
    base = compress.round_key(prng.prng_key(2), 5)
    keys = prng.fold_in_t(prng.key_t(base, dev)[None],
                          torch.arange(m, device=dev))
    draws = {"random_bits": prng.random_bits_t(keys, n),
             "uniform": prng.uniform_t(keys, n),
             "randint 2^16": prng.randint_u32_t(keys, n, 0, 1 << 16)}
    for row in (0, 1, m // 2 - 1, m - 1):
        key = prng.fold_in(base, row)
        if not np.array_equal(keys[row].cpu().numpy(),
                              key.astype(np.int64)):
            raise SystemExit(f"threefry: row {row}'s key differs")
        want = {"random_bits": prng.random_bits(key, n).astype(np.int64),
                "uniform": prng.uniform(key, n),
                "randint 2^16": numpy_randint16(prng, key, n)}
        for name, got in draws.items():
            g = got[row].cpu().numpy()
            if g.tobytes() != want[name].tobytes():
                raise SystemExit(f"threefry {name}: row {row} differs from "
                                 f"the numpy form")
    times = {name: median_ms(lambda fn=fn: fn())
             for name, fn in (
                 ("fold_in", lambda: prng.fold_in_t(
                     prng.key_t(base, dev)[None],
                     torch.arange(m, device=dev))),
                 ("random_bits", lambda: prng.random_bits_t(keys, n)),
                 ("uniform", lambda: prng.uniform_t(keys, n)),
                 ("randint 2^16", lambda: prng.randint_u32_t(
                     keys, n, 0, 1 << 16)))}
    words = m * n
    say(f"device threefry ({m}, {n}) on {card}: rows 0, 1, {m // 2 - 1}, "
        f"{m - 1} of random_bits, uniform and randint 2^16 bit for bit the "
        f"numpy forms; ms a draw (CUDA events, median of {REPS}): "
        + ", ".join(f"{k} {v!r}" for k, v in times.items())
        + f"; a kernel's bound: {words * 4} bytes of words written = "
        f"{bound(words * 4)!r} ms (uniform, bits), randint's two blocks "
        f"{bound(words * 4)!r} ms of writes as well")
    del draws, keys

    # codecs ----------------------------------------------------------------
    say(f"codecs on the FedGiA_D population run (m={m}, N={n}, diag_ema, "
        f"alpha 0.5), {rounds} rounds, tol 0, on {card}:")
    plain_res = gia_run("uncompressed")
    none_res = gia_run("compression none", compression="none")
    same(none_res, plain_res, "compression='none' vs no codec")
    ms_plain = plain_res.wall_s / rounds * 1e3
    say(f"  uncompressed: {ms_plain!r} ms a replayed round; "
        f"compression='none': {none_res.wall_s / rounds * 1e3!r} ms, bitwise "
        f"the run without it")
    per = {}
    for codec, kw in (("bf16", dict(compression="bf16")),
                      ("int8", dict(compression="int8", error_feedback=True)),
                      ("topk", dict(compression="topk", topk_frac=0.1,
                                    error_feedback=True))):
        res = gia_run(codec, **kw)
        eager = gia_run(f"{codec} eager", scan=False, **kw)
        same(res, eager, f"{codec}: replayed vs eager")
        per[codec] = res.wall_s / rounds * 1e3
        say(f"  {codec}: {per[codec]!r} ms a replayed round ("
            f"{eager.wall_s / rounds * 1e3!r} eager), against "
            f"{ms_plain!r} uncompressed; f={float(res.history['f_xbar'][-1])!r}")
        # the 5th round's operands: u = z (+ ef) after 4 rounds
        four = gia_run(f"{codec} to round 4", want_rounds=4, **kw)
        spec = pt.ravel_spec(four.state["x"])
        flat = engine.flatten_state(algo, four.state, spec)
        comp = compress.as_compressor(kw["compression"],
                                      error_feedback=kw.get("error_feedback",
                                                            False),
                                      topk_frac=kw.get("topk_frac", 0.1))
        u = flat["z"] + flat["ef"] if comp.error_feedback else flat["z"]
        ck = prng.key_t(compress.round_key(flat["rng"], flat["round"]), dev)
        rkeys = prng.fold_in_t(ck[None], torch.arange(m, device=dev))
        if codec == "bf16":
            got = comp.encode_decode(u)
            want = comp.encode_decode(u.cpu())
            diff = int((got.cpu().view(torch.int32)
                        != want.view(torch.int32)).sum())
            what = "decode"
        elif codec == "int8":
            got = comp.quantize(u, rkeys)[0]
            want = comp.quantize(u.cpu(), rkeys.cpu())[0]
            diff = int((got.cpu() != want).sum())
            what = "levels q"
        else:
            got = torch.sort(comp.kept(u, spec.size), -1).values
            want = torch.sort(comp.kept(u.cpu(), spec.size), -1).values
            diff = int((got.cpu() != want).sum())
            what = "kept lanes"
        say(f"  {codec} on round 5's operands ({tuple(u.shape)}): card vs "
            f"CPU {what}: {diff} differing (0 required)")
        if diff:
            raise SystemExit(f"{codec}: the card's {what} differ from the "
                             f"CPU's on {diff} elements")
        del four, flat, u, rkeys, got, want, res, eager

    # faults, screening, quorum, watchdog -------------------------------------
    quorum = m // 4
    kinds = ["crash", "nan", "replay", "explode"]
    say(f"faults at the population size: {','.join(kinds)} at rate 0.02, "
        f"screening with clip 100, quorum {quorum}, the watchdog; uniform "
        f"alpha 0.5; {rounds} rounds, chunked against --no-scan, on {card}:")
    fm = faults.make_faults(kinds, [0.02], num_clients=m, seed=3)
    rows = torch.arange(m, device=dev)
    for t in range(rounds):
        got = fm.draw(torch.tensor(t, device=dev), rows)
        want = numpy_fault_hits(fm, t, m, prng)
        for kind in kinds:
            if not np.array_equal(got[kind].cpu().numpy(), want[kind]):
                raise SystemExit(f"faults: round {t} {kind} hits differ "
                                 f"from the numpy draw")
    say(f"  the card's fault draws of rounds 0..{rounds - 1} are the numpy "
        f"chains' for every row and kind")
    pol = selection.make_policy("uniform", m, 0.5)
    kw = dict(participation=pol, faults=fm,
              screening=faults.Screening(clip_norm=100.0), quorum=quorum,
              watchdog=True)
    fedavg = api_mod.make_algorithm(
        FedConfig(algorithm="fedavg", num_clients=m, lr=0.01), model.loss,
        model=model)
    for name, run_algo in (("fedgia", algo), ("fedavg", fedavg)):
        st = (state0 if run_algo is algo else run_algo.init(
            model.init(dev), prng.prng_key(1), init_batch=batch))
        out = {}
        for tag, scan in (("chunked", True), ("--no-scan", False)):
            reset_counts(counters)
            res = engine.run_rounds(run_algo, st, batch, rounds, scan=scan,
                                    **kw)
            got = read_counts(counters)
            want = rounds if name == "fedgia" else 0
            if res.rounds_run != rounds or sum(got.values()) != want:
                raise SystemExit(f"{name} faults ({tag}): {res.rounds_run} "
                                 f"rounds, launches {got}")
            launches["fedgia_update_batched"] += want
            out[tag] = res
            say(f"  {name} {tag}: {res.wall_s / rounds * 1e3!r} ms a round "
                f"(draws {res.draw_s / rounds * 1e3!r}); screened "
                f"{res.history['screened'].astype(int).tolist()}; degraded "
                f"{int(res.history['degraded'].sum())}; rollback "
                f"{int(res.history['rollback'].sum())}; f="
                f"{float(res.history['f_xbar'][-1])!r}")
        a, b = out["chunked"], out["--no-scan"]
        for k in ("screened", "degraded", "rollback", "selected"):
            if not np.array_equal(a.history[k], b.history[k]):
                raise SystemExit(f"{name} faults: {k} differs between the "
                                 f"chunked driver and --no-scan")
        same(a, b, f"{name} faults: chunked vs --no-scan")
        # the screened counts are the numpy draws' survivors
        pstate = pol.init()
        for t in range(rounds):
            hits = numpy_fault_hits(fm, t, m, prng)
            up = np.ones(m, bool)
            if name == "fedavg":
                mask, pstate = pol.mask(pstate, t)
                up = mask.numpy()
            arrive = up & ~hits["crash"] & ~hits["nan"]
            if int(a.history["screened"][t]) != int(arrive.sum()):
                raise SystemExit(f"{name} faults: round {t} screened "
                                 f"{a.history['screened'][t]}, the numpy "
                                 f"draws leave {int(arrive.sum())}")
        say(f"  {name}: screened, degraded, rollback and the state equal "
            f"between the drivers; each round's screened count is the "
            f"numpy draws' survivors")
        del out, a, b

    # checkpoint and resume ---------------------------------------------------
    d = ROOT / "build" / "chip_smoke_ckpt"
    if d.exists():
        shutil.rmtree(d)
    kw = dict(compression="int8", error_feedback=True, chunk_size=8)
    ref_run = gia_run("int8+EF uninterrupted", **kw)
    cut = gia_run("int8+EF with checkpoints", checkpoint_every=8,
                  checkpoint_dir=str(d), **kw)
    same(cut, ref_run, "checkpointed run vs uninterrupted")
    from repro_torch.checkpoint import latest_step
    if latest_step(str(d)) != 16:
        raise SystemExit(f"checkpoints: latest step {latest_step(str(d))}")
    reset_counts(counters)
    t0 = time.perf_counter()
    res = engine.run_rounds(algo, state0, batch, rounds, checkpoint_every=8,
                            checkpoint_dir=str(d), resume=True, **kw)
    resume_s = time.perf_counter() - t0
    got = read_counts(counters)
    if got["fedgia_update_batched"] != rounds - 16 or \
            sum(got.values()) != rounds - 16:
        raise SystemExit(f"resume: launches {got}, want {rounds - 16}")
    launches["fedgia_update_batched"] += rounds - 16
    same(res, ref_run, "resumed from step 16 vs uninterrupted")
    size = sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
    say(f"  int8+EF population run, checkpoints every 8 rounds ({size} "
        f"bytes on disk for two), resumed from step 16 in {resume_s!r} s: "
        f"history and final state bitwise the uninterrupted run's")
    shutil.rmtree(d)
    del ref_run, cut, res

    # wallclock_bench's compression and fault rows ---------------------------
    say(f"wallclock_bench's compression, overlap and fault rows (m="
        f"{wallclock_bench.M_CLIENTS}) on {card} and on the CPU:")
    reset_counts(counters)
    gpu = (wallclock_bench.run_compression("cuda", collect_history=True)
           + wallclock_bench.run_overlap("cuda", collect_history=True)
           + wallclock_bench.run_faults("cuda", collect_history=True))
    got = read_counts(counters)
    cpu = (wallclock_bench.run_compression("cpu", collect_history=True)
           + wallclock_bench.run_overlap("cpu", collect_history=True)
           + wallclock_bench.run_faults("cpu", collect_history=True))
    keys = ("algo", "codec", "cr", "sim_time_s", "staleness_seen", "time_s",
            "obj", "converged")
    print_rows(gpu, keys, "cuda")
    print_rows(cpu, keys, "cpu")
    wallclock_bench.check_uplink(gpu)
    want = sum(r["cr"] // 2 for r in gpu)
    if got["fedgia_update_batched"] != want or sum(got.values()) != want:
        raise SystemExit(f"wallclock uplink rows: launches {got}, want {want}")
    launches["fedgia_update_batched"] += want
    # the stochastic int8 row: a last-ulp difference in an upload flips a
    # level, which error feedback carries, so card and CPU are held to
    # both reaching the target (tests/test_torch_compress.py bounds it);
    # a row that reaches it on neither side (top-k, which diverges in the
    # reference too) is held by its rounds, simulated time and bytes, and
    # its f after hundreds of diverging rounds printed
    held = []
    for g, c in zip(gpu, cpu):
        if g["codec"] == "int8":
            say(f"  int8 row: CR {g['cr']} (cuda) vs {c['cr']} (cpu), Obj "
                f"{g['obj']!r} vs {c['obj']!r}, both converged: "
                f"{g['converged'] and c['converged']}")
            if not (g["converged"] and c["converged"]):
                raise SystemExit(f"wallclock int8 row did not converge: "
                                 f"{g} {c}")
        elif not (g["converged"] or c["converged"]):
            keys = ("cr", "sim_time_s", "staleness_seen", "bytes_up_total",
                    "bytes_down_total")
            same_rounds = [a[2:] for a in g["history"]] == \
                [b[2:] for b in c["history"]]
            apart = next((i for i, (a, b) in enumerate(
                zip(g["history"], c["history"]))
                if abs(a[0] - b[0]) > ROW_OBJ_RTOL * abs(b[0])), None)
            say(f"  {g['codec']} row (no convergence on either side): "
                f"{', '.join(keys)} equal: "
                f"{all(g[k] == c[k] for k in keys)}; staleness and sim_time "
                f"equal every round: {same_rounds}; f apart by more than "
                f"{ROW_OBJ_RTOL} from round {apart}; last f {g['obj']!r} "
                f"(cuda) vs {c['obj']!r} (cpu)")
            if not (same_rounds and all(g[k] == c[k] for k in keys)):
                raise SystemExit(f"wallclock {g['codec']} row: {g} {c}")
        else:
            held.append((g, c))
    exact = ("algo", "codec", "cr", "sim_time_s", "staleness_seen",
             "converged")
    hold_rows([g for g, _ in held], [c for _, c in held], exact,
              "wallclock uplink rows", tol=wallclock_bench.COMPRESS_TARGET_F)
    kept["wallclock"] += [dict(r) for r in gpu]
    say(f"phase 2f took {time.perf_counter() - t_phase!r} s")
    return {"threefry_ms": times, "codec_ms": per, "uncompressed_ms": ms_plain}


def gib(nbytes):
    return nbytes / 2**30


def host_state(state):
    """The model-shaped entries of a run's state, copied to host memory."""
    return {k: {leaf: v.cpu() for leaf, v in tree.items()}
            for k, tree in state.items() if isinstance(tree, dict)}


def train_run(train, counters, argv, what):
    """One `--arch` CLI run on the card, counts reset before and read
    after, the peak device memory apart. Returns (result, launches)."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res, n = run_main_path(train, counters, argv)
    peak = torch.cuda.max_memory_allocated()
    fs = [h["f"] for h in res["history"]]
    say(done_line(f"{what} (cuda)", res))
    say(f"  f each round: {fs}")
    say(f"  r_hat={float(res['state']['r'])!r} "
        f"sigma={float(res['state']['sigma'])!r}; the weights drawn in "
        f"{res['init_s']!r} s, r_hat probed in {res['probe_s']!r} s; "
        f"launches {n} peak device "
        f"memory {peak} bytes ({gib(peak):.2f} GiB); "
        f"{per_round_ms(res)!r} ms a round, warm-up and capture "
        f"{res['capture_s']!r} s apart")
    if not all(math.isfinite(f) for f in fs):
        raise SystemExit(f"{what}: non-finite f {fs}")
    return res, n


def plain_tiles(ref, args, outs=None):
    """The plain version over the (m, N) operands a column tile at a time;
    with `outs` (π', z' of the kernel) held to them, bitwise expected.
    Returns (max_abs_err, differing elements)."""
    xbar, gbar, pi, h, sel, sigma, m, k0 = args
    err, diff = 0.0, 0
    for c0 in range(0, gbar.shape[1], TILE_COLUMNS):
        c1 = min(gbar.shape[1], c0 + TILE_COLUMNS)
        _, p, z = plain(ref, xbar[c0:c1], gbar[:, c0:c1], pi[:, c0:c1],
                        h if h.dim() == 0 else h[:, c0:c1], sel, sigma, m,
                        k0)
        if outs is None:
            continue
        for a, b, part in ((outs[0][:, c0:c1], p, "pi"),
                           (outs[1][:, c0:c1], z, "z")):
            if not torch.isfinite(a).all():
                raise SystemExit(f"full-width update: non-finite {part}'")
            torch.testing.assert_close(
                a, b, rtol=RTOL, atol=0.0,
                msg=lambda msg: f"full-width update {part}' at columns "
                f"{c0}:{c1}: {msg}")
            err = max(err, float((a - b).abs().max()))
            diff += int((a.view(torch.int32) != b.view(torch.int32)).sum())
    return err, diff


def full_width_flat(res, engine, pt):
    """A full-width run's final state as the flat buffers a round reads,
    the run's own copy dropped. Returns (algo, batch, flat, spec)."""
    algo, batch, state = res.pop("algorithm"), res.pop("batch"), \
        res.pop("state")
    spec = pt.ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    del state
    torch.cuda.empty_cache()
    return algo, batch, flat, spec


def full_width_split(algo, batch, flat, spec, modules):
    """`profile_round`'s split of one eager undonated round on the flat
    full-width state (which it leaves as it was), after two unprofiled
    ones whose host-clock time is returned."""
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        algo.round_flat(dict(flat), batch, spec)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    fedgia_mod, hparams_mod, api_mod = modules
    undo = []
    labelled(algo, "_vg", "gradient", undo)
    labelled(api_mod, "client_mean", "eq. (11)", undo)
    labelled(fedgia_mod, "fedgia_update_flat", "update kernel", undo)
    for name in ("client_scalar_mean", "flat_grad_sq_norm",
                 "client_scalar_sum"):
        labelled(api_mod, name, "metrics", undo)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    try:
        with torch.profiler.profile(activities=acts) as prof:
            algo.round_flat(dict(flat), batch, spec)
            torch.cuda.synchronize()
    finally:
        for fn in reversed(undo):
            fn()
    return device_split(prof), min(walls)


def full_width_update(algo, batch, flat, spec, ops, ref, card):
    """The round after a full-width run's last, as `FedGiA.round_flat`
    builds it (x̄, ḡ, π, the 0-d h of scalar H, the draw's select), in
    three forms of the kernel: undonated with the 0-d h, donated with it
    (the scalar round's), and undonated with h materialised to (m, N)
    (the diag_ema round's). Each form is launched once outside its
    timing and its own π', z' held to the plain version on column
    tiles; the two round forms are timed against their bounds, and the
    plain version in tiles. Consumes `flat`. Returns {kernel name: its
    numbers at this shape}."""
    xbar, sel, _, _, gbar = algo.round_inputs(flat, batch, spec)
    args = algo.kernel_args(flat, xbar, gbar, sel)
    flat.clear()
    xbar, gbar, pi, h, sel, sigma, m, k0 = args
    shape = list(gbar.shape)

    def once(counter, call):
        before = ops.launches[counter]
        out = call()
        if ops.launches[counter] != before + 1:
            raise SystemExit(f"full-width update {counter}: not one launch")
        return out

    def held(name, run, outs):
        err, diff = plain_tiles(ref, run, outs)
        say(f"  {name} at the model's width {shape} (N {spec.size}), h "
            f"{'0-d' if run[3].dim() == 0 else '(m, N)'}, {int(sel.sum())} "
            f"of {m} rows selected: held to its plain version on "
            f"{-(-shape[1] // TILE_COLUMNS)} column tiles of {TILE_COLUMNS}: "
            f"max_abs_err={err!r} differing_elements={diff} (rtol {RTOL}, "
            "bitwise expected)")
        return err, diff

    _, p1, z1 = once("fedgia_update_batched", lambda: ops.fedgia_update_flat(
        xbar, gbar, pi, h, sel, sigma, m, k0=k0, want_x=False))
    held("fedgia_update_batched", args, (p1, z1))
    del p1, z1
    saved = (gbar.clone(), pi.clone())

    def prep():
        gbar.copy_(saved[0])
        pi.copy_(saved[1])

    def donated():
        return ops.fedgia_update_flat(xbar, gbar, pi, h, sel, sigma, m,
                                      k0=k0, donate=True, want_x=False)

    ms = median_ms(donated, prep)
    prep()
    _, p2, z2 = once("fedgia_update_batched_donated", donated)
    if p2.data_ptr() != pi.data_ptr() or z2.data_ptr() != gbar.data_ptr():
        raise SystemExit("full-width donated update: not written in place")
    # π', z' sit in π, ḡ now: held to the plain version on the saved inputs
    forms = {"fedgia_update_batched_donated": (h, ms, held(
        "fedgia_update_batched_donated",
        (xbar, saved[0], saved[1], h, sel, sigma, m, k0), (p2, z2)))}
    del p2, z2
    prep()
    del saved
    h_full = h.expand(gbar.shape).contiguous()

    def batched():
        return ops.fedgia_update_flat(xbar, gbar, pi, h_full, sel, sigma, m,
                                      k0=k0, want_x=False)

    ms = median_ms(batched)
    _, p3, z3 = once("fedgia_update_batched", batched)
    forms["fedgia_update_batched"] = (h_full, ms, held(
        "fedgia_update_batched", (xbar, gbar, pi, h_full, sel, sigma, m, k0),
        (p3, z3)))
    del p3, z3
    numbers = {}
    for name, (hh, ms, (err, diff)) in forms.items():
        run = (xbar, gbar, pi, hh, sel, sigma, m, k0)
        nbytes = fedgia_bytes(xbar, gbar, hh, sel, want_x=False)
        times = []
        for _ in range(3):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            plain_tiles(ref, run)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        plain_ms = statistics.median(times)
        numbers[name] = {"shape": shape, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound(nbytes), "nbytes": nbytes,
                         "max_abs_err": err, "differing_elements": diff,
                         "h": "0-d" if hh.dim() == 0 else "(m, N)"}
        say(f"  {name} {shape}, h {numbers[name]['h']}: kernel_ms={ms!r} "
            f"plain_ms={plain_ms!r} (the plain version in {TILE_COLUMNS}"
            f"-column tiles, median of 3) bound_ms={bound(nbytes)!r} "
            f"(bytes: {nbytes}) achieved={nbytes / (ms * 1e-3) / 1e9:.1f} "
            f"GB/s share_of_bound={bound(nbytes) / ms:.4f} on {card}")
    return numbers


def tensor_bytes(tree) -> int:
    """numel x element size of every tensor in a dict (nested) or list."""
    if isinstance(tree, dict):
        return sum(tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(v) for v in tree)
    return tree.numel() * tree.element_size() if torch.is_tensor(tree) else 0


def storage_bytes(*trees) -> int:
    """Bytes of the distinct storages under the tensors of `trees`."""
    seen = {}

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif torch.is_tensor(t):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()

    for tree in trees:
        walk(tree)
    return sum(seen.values())


def layout_gap(flat, spec, batch, token_bytes=4) -> int:
    """What the round reads beyond the dry run's argument bytes: the flat
    buffers' zero padding past the spec's size (the dry run lays the
    state out leaf by leaf) and the tokens' width past `token_bytes` (the
    dry run takes the reference's int32)."""
    gap = 0
    for t in flat.values():
        if torch.is_tensor(t) and t.dim() and t.shape[-1] == spec.padded_size:
            gap += (spec.padded_size - spec.size) * (t.numel() // t.shape[-1]
                                                     ) * t.element_size()
    for t in batch.values():
        if not t.is_floating_point():
            gap += t.numel() * (t.element_size() - token_bytes)
    return gap


def dryrun_checks(rec, counted_flops, read_bytes, gap, peak_net):
    """Phase 2j's three comparisons of a dry-run record with the eager
    round. Returns (lines to print, failures)."""
    pd = rec["per_device"]
    lines, bad = [], []
    traced = pd["flops"]
    rel = abs(traced - counted_flops) / max(counted_flops, 1.0)
    lines.append(f"  FLOPs: traced {traced!r} against counted "
                 f"{counted_flops!r} on the card (rel {rel!r})")
    if rel > DRYRUN_FLOPS_RTOL:
        bad.append(f"traced FLOPs {traced} vs counted {counted_flops}")
    args = pd["argument_bytes"]
    lines.append(f"  argument bytes: {args} against the {read_bytes} bytes "
                 f"the round reads, {read_bytes - args} apart (the flat "
                 f"buffers' padding and the int64 tokens: {gap})")
    if read_bytes - args != gap:
        bad.append(f"argument bytes {args} + {gap} != {read_bytes}")
    fit = args + pd["output_bytes"] + pd["temp_bytes"]
    rel = (fit - peak_net) / peak_net
    lines.append(f"  memory: argument + output + temp {fit} bytes "
                 f"({gib(fit):.2f} GiB) against the round's peak {peak_net} "
                 f"bytes ({gib(peak_net):.2f} GiB) less the memory it does "
                 f"not read: {100 * rel:+.2f} %")
    if abs(rel) > DRYRUN_MEMORY_RTOL:
        bad.append(f"memory {fit} vs peak {peak_net} ({100 * rel:+.2f} %)")
    return lines, bad


def dryrun_phase(algo, batch, flat, spec, card):
    """Phase 2j: the planning dry run at phase 2g's shapes on a 1 x 1
    mesh against one more eager donated round on the live full-width
    state (`flat`, whose π the round overwrites in place), then the
    full-width production record. Raises on a mismatch."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.config import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    t_phase = time.perf_counter()
    m, bc, s1 = batch["tokens"].shape
    shape = ShapeConfig("phase_2g", s1 - 1, m * bc, "train")
    state_dtype = str(flat["z"].dtype).replace("torch.", "")
    rec = dryrun.dryrun_one("tinyllama-1.1b", shape, num_clients=m,
                            mesh=AbstractMesh(("data", "model"), (1, 1)),
                            state_dtype=state_dtype, verbose=False)
    total = torch.cuda.get_device_properties(0).total_memory
    say(f"phase 2j: the card's total_memory {total} bytes ({gib(total)!r} "
        f"GiB; fill_experiments' per-card budget), {card}")
    say(f"phase 2j: the dry run at phase 2g's shapes (m={m}, batch {bc} x "
        f"{s1 - 1}, {state_dtype} state, scalar H, mesh 1x1, model axis "
        f"{rec['model_axis']}) traced on the host in {rec['t_trace_s']!r} "
        f"s, against one eager donated round on the live state, on {card}:")
    read = tensor_bytes(flat) + tensor_bytes(batch)
    gap = layout_gap(flat, spec, batch)
    torch.cuda.synchronize()
    other = torch.cuda.memory_allocated() - storage_bytes(flat, batch)
    torch.cuda.reset_peak_memory_stats()
    with FlopCounterMode(display=False) as fc:
        out = algo.round_flat(dict(flat), batch, spec, donate_kernel=True)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = algo.round_flat(dict(flat), batch, spec, donate_kernel=True)
    end.record()
    torch.cuda.synchronize()
    round_ms = start.elapsed_time(end)
    del out
    lines, bad = dryrun_checks(rec, float(fc.get_total_flops()), read, gap,
                               peak - other)
    for line in lines:
        say(line)
    say(f"  (the round's raw peak {peak} bytes, {gib(peak):.2f} GiB; live "
        f"device memory the round does not read {other} bytes)")
    r = rec["roofline"]
    say(f"  roofline terms: compute {r['t_compute_s'] * 1e3!r} ms, memory "
        f"{r['t_memory_s'] * 1e3!r} ms (unfused bytes), collective "
        f"{r['t_collective_s'] * 1e3!r} ms -> {r['bottleneck']}-bound; the "
        f"eager donated round measured {round_ms!r} ms (CUDA events)")
    if bad:
        raise SystemExit("phase 2j: " + "; ".join(bad))
    prod = dryrun.dryrun_one("tinyllama-1.1b", "train_4k", verbose=False)
    pd, r = prod["per_device"], prod["roofline"]
    fit = pd["argument_bytes"] + pd["output_bytes"] + pd["temp_bytes"]
    say(f"  production record tinyllama-1.1b train_4k on {prod['mesh']} "
        f"(model axis {prod['model_axis']}): traced on the host in "
        f"{prod['t_trace_s']!r} s; per card args+out+temp {gib(fit):.2f} "
        f"GiB, flops {pd['flops']!r}, hbm {pd['hbm_bytes']!r}, collectives "
        f"{prod['collectives']['total']!r} B; roofline compute "
        f"{r['t_compute_s'] * 1e3!r} ms, memory {r['t_memory_s'] * 1e3!r} "
        f"ms, collective {r['t_collective_s'] * 1e3!r} ms -> "
        f"{r['bottleneck']}-bound")
    say(f"phase 2j took {time.perf_counter() - t_phase!r} s")


def train_vs_cpu(train, arch, dtype="bf16"):
    """A reduced `--arch` run on the card and on the CPU: the same rounds,
    f each round within TRAIN_CPU_RTOL of that round's f on the CPU,
    r_hat within PROBE_CPU_RTOL. The card's run goes first, so that a
    caller's launch counts are the card's."""
    argv = ["--arch", arch] + TRAIN_REDUCED
    runs = {dev: train.main(argv + ["--device", dev])
            for dev in ("cuda", "cpu")}
    f = {dev: [h["f"] for h in r["history"]] for dev, r in runs.items()}
    r_hat = {dev: float(r["state"]["r"]) for dev, r in runs.items()}
    gap = max(abs(a - b) / abs(b) for a, b in zip(f["cuda"], f["cpu"]))
    say(f"  {arch} reduced ({dtype}), card vs CPU: f {f['cuda']} vs "
        f"{f['cpu']} (largest relative gap {gap!r}); r_hat "
        f"{r_hat['cuda']!r} vs {r_hat['cpu']!r}")
    if len(f["cuda"]) != len(f["cpu"]) or not all(
            math.isfinite(v) for v in f["cuda"]):
        raise SystemExit(f"{arch}: card rounds {f['cuda']}")
    for i, (a, b) in enumerate(zip(f["cuda"], f["cpu"])):
        if abs(a - b) > TRAIN_CPU_RTOL * abs(b):
            raise SystemExit(f"{arch}: round {i}: f {a!r} (cuda) vs {b!r} "
                             "(cpu)")
    if abs(r_hat["cuda"] - r_hat["cpu"]) > PROBE_CPU_RTOL * r_hat["cpu"]:
        raise SystemExit(f"{arch}: r_hat {r_hat}")
    if not f["cuda"][-1] < f["cuda"][0]:
        raise SystemExit(f"{arch}: f did not fall on the card")


def memo_probe(hparams_mod):
    """Memoise `hparams.estimate_lipschitz` on the model, the client's key
    and its batch: a cut of phase 2g's time (PERF.md §4). Its three
    full-width runs probe the same weights (prng_key(0)) on the same
    batch with the same keys, so the second and third take the first's
    r_hat (15.6 s a probe, PR 22 run 3: the same value in all three).
    Returns the function that puts the probe back."""
    real = hparams_mod.estimate_lipschitz
    seen = {}

    def probe(loss_fn, params, batch, key, **kw):
        tokens = batch["tokens"]
        memo = (getattr(loss_fn, "__self__", None).cfg.name,
                tuple(int(x) for x in key), tuple(tokens.shape),
                int(tokens.long().sum()), tuple(sorted(kw.items())))
        if memo not in seen:
            seen[memo] = real(loss_fn, params, batch, key, **kw)
        return seen[memo].clone()

    hparams_mod.estimate_lipschitz = probe
    return lambda: setattr(hparams_mod, "estimate_lipschitz", real)


def training_phase(train, fl_transformer, counters, launches, card, ops,
                   ref, engine, pt, modules, prng):
    """Phase 2g: `--arch` training of the dense transformers. Returns the
    fedgia_update numbers at the model's width."""
    t_phase = time.perf_counter()
    key = prng.prng_key(NORMAL_SEED)
    got = prng.normal_t(prng.key_t(key, "cuda"), NORMAL_WORDS).cpu()
    want = torch.from_numpy(prng.normal(key, NORMAL_WORDS))
    ulps = (got.view(torch.int32).long() - want.view(torch.int32).long()
            ).abs()
    say(f"normal_t on the card vs the numpy form, {NORMAL_WORDS} words: "
        f"{int((ulps > 0).sum())} differ, at most {int(ulps.max())} float32 "
        f"ulps (the CPU's bound: 4)")
    if int(ulps.max()) > NORMAL_MAX_ULPS:
        raise SystemExit(f"normal_t: {int(ulps.max())} ulps from numpy")
    say(f"phase 2g: FedGiA on tinyllama-1.1b at full width "
        f"({' '.join(TRAIN_FULL)}), on {card}; the --no-scan and diag_ema "
        f"runs take the first run's r_hat probes (memo_probe):")
    unmemo = memo_probe(modules[1])
    chunked, n = train_run(train, counters, TRAIN_FULL,
                           "tinyllama-1.1b full width, CUDA-graph chunk")
    rounds = chunked["rounds"]
    if n["fedgia_update_batched_donated"] != rounds or \
            sum(n.values()) != rounds:
        raise SystemExit(f"full-width run: launches {n} != {rounds} rounds")
    for k in launches:
        launches[k] += n[k]
    kept = host_state(chunked.pop("state"))
    del chunked["batch"], chunked["algorithm"]
    eager, n_eager = train_run(train, counters, TRAIN_FULL + ["--no-scan"],
                               "tinyllama-1.1b full width, --no-scan")
    if n_eager != n or eager["rounds"] != rounds:
        raise SystemExit(f"full-width --no-scan: launches {n_eager}")
    if [h["f"] for h in eager["history"]] != \
            [h["f"] for h in chunked["history"]]:
        raise SystemExit("full-width: chunked and --no-scan f differ")
    diffs = {}
    for k, tree in kept.items():
        for leaf, v in tree.items():
            diffs[f"{k}.{leaf}"] = int(
                (v.view(torch.int32) !=
                 eager["state"][k][leaf].cpu().view(torch.int32)).sum())
    del kept
    if any(diffs.values()):
        raise SystemExit(f"full-width: chunked and --no-scan final states "
                         f"differ: {diffs}")
    say(f"  chunked vs --no-scan: the same f every round and final states "
        f"bitwise equal ({len(diffs)} leaves of x, z, pi)")
    algo, batch, flat, spec = full_width_flat(eager, engine, pt)
    for attempt in range(1, FULL_WIDTH_ATTEMPTS + 1):
        split, wall_us = full_width_split(algo, batch, flat, spec, modules)
        busy = sum(split.values())
        whole = split_is_whole(split)
        say(f"  split of one eager undonated round at full width "
            f"(torch.profiler, device us; session {attempt}): " + " ".join(
                f"{k}={v:.1f}" for k, v in split.items())
            + f" busy={busy:.1f} wall={wall_us:.1f} (unprofiled, the "
            f"faster of 2) idle_share={1 - busy / wall_us:.4f}"
            if whole else
            f"  full-width profiler session {attempt} lost a step (" +
            " ".join(f"{k}={v:.1f}" for k, v in split.items()) +
            "): [kernels lost by the profiler, not a device split]")
        if whole:
            break
    if not whole:
        split, span_us = event_split_flat(algo, batch, flat, spec, modules)
        say(f"  split of one eager undonated round at full width: "
            f"[CUDA-event spans, not a device split] (us, each step's host "
            f"launches included, not busy time): " + " ".join(
                f"{k}={v:.1f}" for k, v in split.items())
            + f" round={span_us:.1f}")
        if not split_is_whole(split):
            raise SystemExit("full-width split: neither the profiler nor "
                             "CUDA events timed every step of the round")
    dryrun_phase(algo, batch, flat, spec, card)
    numbers = full_width_update(algo, batch, flat, spec, ops, ref, card)
    numbers["fedgia_update_batched_donated"]["launches"] = n[
        "fedgia_update_batched_donated"]
    del eager, flat

    diag, n = train_run(train, counters, TRAIN_DIAG,
                        "tinyllama-1.1b full width, diag_ema, --no-scan")
    if n["fedgia_update_batched"] != diag["rounds"] or \
            sum(n.values()) != diag["rounds"]:
        raise SystemExit(f"full-width diag_ema: launches {n}")
    for k in launches:
        launches[k] += n[k]
    numbers["fedgia_update_batched"]["launches"] = n["fedgia_update_batched"]
    del diag
    unmemo()
    say("  (diag_ema at full width runs in the eager loop only: the chunked "
        "driver's warm-up copies of its state would not fit, PERF.md §5)")
    torch.cuda.empty_cache()

    # --kernel off: the plain version on the card, an A/B of the kernel
    runs = {}
    for flag in ("on", "off"):
        reset_counts(counters)
        res = train.main(PAPER + ["--kernel", flag])
        runs[flag] = res, read_counts(counters)
        say(done_line(f"paper run --kernel {flag} (cuda)", res) +
            f"; launches {runs[flag][1]}")
    (on, n_on), (off, n_off) = runs["on"], runs["off"]
    if sum(n_off.values()) or n_on["fedgia_update_batched_donated"] != \
            on["rounds"]:
        raise SystemExit(f"--kernel on/off: launches {n_on} / {n_off}")
    hold_replayed_to_eager(on["state"], off["state"], "--kernel off",
                           bitwise_only=True, label="--kernel on vs off")
    if [h["f"] for h in on["history"]] != [h["f"] for h in off["history"]]:
        raise SystemExit("--kernel on/off: f differs")
    del runs, on, off

    say("reduced --arch runs, card vs CPU (bf16):")
    for arch in ("tinyllama-1.1b", "qwen1.5-0.5b", "rwkv6-3b"):
        train_vs_cpu(train, arch)

    say(f"examples/fl_transformer.py (fl-lm-134m, float32, m=4, 40 rounds, "
        f"diag_ema, chunks of 10) on {card}:")
    reset_counts(counters)
    torch.cuda.reset_peak_memory_stats()
    out = fl_transformer.main([])
    n = read_counts(counters)
    peak = torch.cuda.max_memory_allocated()
    say(f"  f {out['f'][0]!r} -> {out['f'][-1]!r}, sigma={out['sigma']!r} "
        f"r_hat={out['r_hat']!r}, {out['wall_s'] / len(out['f']) * 1e3!r} ms "
        f"a round, launches {n}, peak device memory {gib(peak):.2f} GiB")
    if n["fedgia_update_batched"] != len(out["f"]) or \
            sum(n.values()) != len(out["f"]):
        raise SystemExit(f"fl_transformer: launches {n}")
    for k in launches:
        launches[k] += n[k]
    del out
    torch.cuda.empty_cache()
    say(f"phase 2g took {time.perf_counter() - t_phase!r} s")
    return numbers


def history_gap(a, b):
    """(largest absolute difference, bitwise) of two runs' per-round
    (f, |grad|^2) over the rounds both ran."""
    ha, hb = cli_history(a), cli_history(b)
    gap = max((abs(x - y) for p, q in zip(ha, hb) for x, y in zip(p, q)),
              default=0.0)
    return gap, ha == hb


def states_bitwise(a, b):
    """The differing bit patterns of two states' model-shaped entries."""
    return {f"{k}.{leaf}": int((tree[leaf].view(torch.int32) != b[k][leaf]
                                .view(torch.int32)).sum())
            for k, tree in a.items() if isinstance(tree, dict)
            for leaf in tree}


def tree_arch_run(engine, device, flat):
    """The reduced tinyllama-1.1b in float32 (TREE_ARCH), through
    `engine.run_rounds` (the CLI has no dtype flag): the weights from
    prng_key(0), r_hat probed, chunked driver. Returns the result."""
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core.api import make_algorithm
    from repro_torch.core.prng import prng_key
    from repro_torch.data import synthetic_batch_for, to_torch
    from repro_torch.models import Transformer
    from repro_torch.models.transformer import init_params

    t = TREE_ARCH
    cfg = dataclasses.replace(get_config(t["arch"]).reduced(),
                              dtype="float32")
    model = Transformer(cfg, device)
    batch = to_torch(synthetic_batch_for(cfg, t["m"], t["batch"], t["seq"],
                                         seed=0), device)
    fed = FedConfig(algorithm="fedgia", num_clients=t["m"], k0=t["k0"],
                    alpha=t["alpha"], sigma_t=t["sigma_t"],
                    auto_lipschitz=True)
    algo = make_algorithm(fed, model.loss, model=model)
    state = algo.init(init_params(cfg, prng_key(0), device), prng_key(1),
                      init_batch=batch)
    return engine.run_rounds(algo, state, batch, t["rounds"], flat=flat)


def pytree_phase(train, counters, launches, card, engine, paper, pop,
                 million, kept):
    """Phase 2h: the per-leaf rounds (`--no-flat`), Lemma IV.1 on the card
    and the benchmark suite (`benchmarks.run` with the engine and kernels
    sections, `check_bench` against the committed port baselines). Adds
    the suite's launches to `launches`."""
    import tempfile

    import numpy as np

    from repro_torch.benchmarks import check_bench, wallclock_bench
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.config import FedConfig
    from repro_torch.core.api import make_algorithm
    from repro_torch.core.prng import prng_key
    from repro_torch.data import linreg_noniid, to_torch
    from repro_torch.models import LeastSquares

    t_phase = time.perf_counter()
    say(f"phase 2h: the per-leaf rounds (--no-flat), on {card}:")
    tree, n, tree_eager, n_eager = run_pair(
        train, counters, PAPER + ["--no-flat"], "paper run --no-flat")
    diffs = states_bitwise(tree["state"], tree_eager["state"])
    if sum(n.values()) or sum(n_eager.values()) or any(diffs.values()):
        raise SystemExit(f"paper run --no-flat: launches {n} / {n_eager}, "
                         f"replayed vs eager differing bits {diffs}")
    gap, same = history_gap(paper, tree)
    keys_equal = bool(np.array_equal(paper["state"]["rng"],
                                     tree["state"]["rng"]))
    diffs = states_bitwise(paper["state"], tree["state"])
    say(f"  flat vs --no-flat: rounds {paper['rounds']} vs {tree['rounds']}"
        f", the same key after the run (so the same split every round): "
        f"{keys_equal}; history largest difference {gap!r}, bitwise "
        f"{same}; final states' differing bits {diffs}")
    if tree["rounds"] != paper["rounds"] or not keys_equal:
        raise SystemExit("paper run: flat and --no-flat rounds or keys "
                         "differ")
    say(f"  per-round time replayed: flat {per_round_ms(paper)!r} ms, "
        f"--no-flat {per_round_ms(tree)!r} ms; eager --no-flat "
        f"{per_round_ms(tree_eager)!r} ms")
    cpu = train.main(PAPER + ["--no-flat", "--device", "cpu"])
    say(done_line("paper run --no-flat (cpu)", cpu))
    card_vs_cpu_run(tree, cpu, "paper run --no-flat")
    del tree, tree_eager, cpu

    # the population size, both layouts in this process, replayed
    algo, batch = pop["algorithm"], pop["batch"]
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    state = algo.init(algo.model.init("cuda"), prng_key(1),
                      init_batch=batch)
    runs = {}
    for flat in (True, False):
        reset_counts(counters)
        res = engine.run_rounds(algo, state, batch, rounds, flat=flat)
        runs[flat] = res, read_counts(counters)
        say(f"  population FedGiA_D (m={algo.fed.num_clients}, "
            f"{'flat' if flat else '--no-flat'}, replayed): "
            f"{res.wall_s / rounds * 1e3!r} ms a round (capture "
            f"{res.capture_s!r} s apart), f="
            f"{float(res.history['f_xbar'][-1])!r}, launches "
            f"{runs[flat][1]}")
    (a, n_flat), (b, n_tree) = runs[True], runs[False]
    if sum(n_tree.values()) or n_flat["fedgia_update_batched"] != rounds:
        raise SystemExit(f"population: launches {n_flat} / {n_tree}")
    launches["fedgia_update_batched"] += rounds
    same = all(np.array_equal(a.history[k], b.history[k])
               for k in a.history)
    say(f"  population flat vs --no-flat: history bitwise {same}, final "
        f"states' differing bits {states_bitwise(a.state, b.state)}")
    del runs, a, b, state

    # a multi-leaf tree: reduced tinyllama-1.1b in float32
    reset_counts(counters)
    tree = tree_arch_run(engine, "cuda", False)
    n = read_counts(counters)
    flat = tree_arch_run(engine, "cuda", True)
    cpu = tree_arch_run(engine, "cpu", False)
    f_card, f_cpu = (list(r.history["f_xbar"]) for r in (tree, cpu))
    rel = max(abs(x - y) / abs(y) for x, y in zip(f_card, f_cpu))
    say(f"  {TREE_ARCH['arch']} reduced float32 --no-flat ({len(tree.state['x'])} "
        f"leaves): f {f_card} (cuda) vs {f_cpu} (cpu), largest relative "
        f"gap {rel!r}; launches {n}; {tree.wall_s / tree.rounds_run * 1e3!r}"
        f" ms a round replayed, flat {flat.wall_s / flat.rounds_run * 1e3!r}"
        f" ms; flat vs --no-flat f bitwise "
        f"{bool(np.array_equal(tree.history['f_xbar'], flat.history['f_xbar']))}")
    if sum(n.values()) or len(f_card) != len(f_cpu) or \
            rel > TRAIN_CPU_RTOL or not f_card[-1] < f_card[0]:
        raise SystemExit(f"reduced --no-flat: launches {n}, f {f_card} vs "
                         f"{f_cpu}")
    del tree, flat, cpu

    # Lemma IV.1 on the card
    lm = LEMMA
    model = LeastSquares(lm["n"])
    batch = to_torch(linreg_noniid(lm["seed"], lm["d"], lm["n"], lm["m"]),
                     "cuda")
    algo = make_algorithm(FedConfig(
        algorithm="fedgia", num_clients=lm["m"], k0=5, alpha=0.5,
        sigma_t=6.0, h_policy="scalar"), model.loss, model=model)
    state = algo.init(model.init("cuda"), prng_key(lm["key"]),
                      init_batch=batch)
    reset_counts(counters)
    lag = [float(algo.lagrangian(state, batch))]
    for _ in range(lm["rounds"]):
        state, _ = algo.round(state, batch)
        lag.append(float(algo.lagrangian(state, batch)))
    rise = max(b - a for a, b in zip(lag, lag[1:]))
    say(f"  Lemma IV.1 (m={lm['m']}, sigma_t=6, scalar H, per-leaf rounds on "
        f"the card): L(Z^k) = {lag}; largest rise {rise!r} (allowed "
        f"{LEMMA_ATOL}); launches {read_counts(counters)}")
    if rise > LEMMA_ATOL or sum(read_counts(counters).values()):
        raise SystemExit("Lemma IV.1: L(Z^k) increased on the card")

    # the suite: engine and kernels sections, then the gates
    say(f"benchmarks.run --only engine --only kernels on {card} (the "
        f"million-client rows of phase 2d reused):")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "BENCH_engine.json")
        reset_counts(counters)
        out = bench_run.run(["engine", "kernels"], "cuda", path,
                            wallclock_json="", engine_rows=million)
        n = read_counts(counters)
        eng = out["engine"]
        for name in ("legacy", "scan", "scan_pytree", "async"):
            say(f"  {name}: {json.dumps(eng['paths'][name])}")
        say(f"  launches {n}; speedup_scan_vs_legacy="
            f"{eng['speedup_scan_vs_legacy']!r} speedup_flat_vs_pytree="
            f"{eng['speedup_flat_vs_pytree']!r} (the walls' ratio, the host "
            f"draws in it: {eng['speedup_flat_vs_pytree_wall']!r}; flat and "
            f"per-leaf histories bitwise: {eng['flat_vs_pytree_bitwise']})")
        want = eng["rounds"] * eng["repeats"] * 4  # legacy, scan, 2 async
        if n["fedgia_update_batched"] < want or \
                sum(n.values()) != n["fedgia_update_batched"]:
            raise SystemExit(f"engine section: launches {n}, want at least "
                             f"{want} fedgia_update_batched")
        launches["fedgia_update_batched"] += n["fedgia_update_batched"]
        say(f"check_bench against {check_bench.BASELINE.relative_to(ROOT)}:")
        if check_bench.main(["--current", path]):
            raise SystemExit("check_bench: the engine gate failed")
        wall = str(Path(tmp) / "BENCH_wallclock.json")
        wallclock_bench.write_json(kept["wallclock"], wall)
        say(f"check_bench --wallclock (phases 2e-2f's rows) against "
            f"{check_bench.WALLCLOCK_BASELINE.relative_to(ROOT)}:")
        if check_bench.main(["--wallclock", "--current", wall]):
            raise SystemExit("check_bench: the wallclock gate failed")
    say(f"phase 2h took {time.perf_counter() - t_phase!r} s")


# phase 2i: the client-sharded round at world size 1 over NCCL. FedGiA
# with both diagonal H policies and the four baselines at one population
# lr (ROADMAP queue 3 k: lr·L_max < 2 with the clients' L up to about
# 1250, as phase 2d's FedPD)
SHARDED_LR = 0.001
SHARDED_ALGOS = (
    ("fedgia_d", "fedgia", dict(sigma_t=0.15, h_policy="diag_ema",
                                alpha=0.5)),
    ("fedgia", "fedgia", dict(sigma_t=0.15, h_policy="scalar", alpha=0.5)),
    ("fedavg", "fedavg", dict(lr=SHARDED_LR)),
    ("fedprox", "fedprox", dict(lr=SHARDED_LR, prox_mu=1e-4, inner_steps=5)),
    ("fedpd", "fedpd", dict(lr=SHARDED_LR, fedpd_eta=1.0, inner_steps=5)),
    ("scaffold", "scaffold", dict(lr=SHARDED_LR)))
SHARDED_ROUNDS = 20
# a cut of depth for the phase's time (PERF.md §4): the two
# baselines that take k0·inner_steps = 25 gradients a round run this
# many rounds in phase 2i (their rows took 9.9 and 11.3 of its s at 20)
SHARDED_SLOW = ("fedprox", "fedpd")
SHARDED_SLOW_ROUNDS = 10
# the chunked runs of phase 2i (sharded and their unsharded twins, tol 0)
# replay one 5-round graph per chunk: a capture costs about its rounds'
# kernel count, the 20-round captures of the int8 rounds ~1.5 s each on
# an H100 (PERF.md §6); the rounds are the same bit for bit at any chunk
# size
SHARDED_CHUNK = 5
# tol > 0 puts each round (and its collectives) in a conditional graph
# node; a tolerance no round meets keeps all of them live
SHARDED_TOL = 1e-30
# the sharded active store and uplink: these two of SHARDED_ALGOS
# under uniform STORE_ALPHA with store="active" (capacity 1638), and
# under int8 + EF + crash,nan at SHARDED_FAULT_RATE + screening (phase
# 2f's clip)
SHARDED_STAGE_ALGOS = ("fedgia_d", "scaffold")
SHARDED_FAULT_RATE = 0.05
SHARDED_CLIP = 100.0


def _stage_kw(stage, m, packed=False):
    """run_rounds' arguments of a phase 2i stage ("active" or "uplink");
    `packed`: the active store's packed eq. (11) (the unsharded twin)."""
    from repro_torch.core.faults import Screening, make_faults
    from repro_torch.core.selection import make_policy

    if stage == "active":
        return dict(participation=make_policy("uniform", m, STORE_ALPHA,
                                              seed=0),
                    store="active", aggregate="packed" if packed else "dense")
    return dict(compression="int8", error_feedback=True,
                faults=make_faults(["crash", "nan"], [SHARDED_FAULT_RATE],
                                   num_clients=m, seed=0),
                screening=Screening(clip_norm=SHARDED_CLIP))


def _max_rel(a, b):
    """max |a - b| / max(|b|, 1e-6) over two arrays (numpy or tensors)."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(((a - b).abs() / b.abs().clamp_min(1e-6)).max())


def _sharded_rank(batch):
    """Phase 2i on one rank (world size 1, NCCL on cuda:0): the population
    rounds of each SHARDED_ALGOS entry through `run_rounds(mesh=...)`,
    barrier and overlapped, chunked (NCCL captured with the rounds) and
    --no-scan, each held to the unsharded chunked run at the sync
    tolerance; one eager round of each profiled for its collectives; the
    eq. (11) all-reduce timed alone. Returns the rows the parent prints
    and checks."""
    from repro_torch.config import FedConfig
    from repro_torch.core import api, compress
    from repro_torch.core.api import make_algorithm
    from repro_torch.core.engine import (
        flatten_state, make_round_fn, run_rounds, shard_inputs)
    from repro_torch.core.prng import prng_key
    from repro_torch.data import linreg_noniid, to_torch
    from repro_torch.kernels.fedgia_update import ops
    from repro_torch.launch.mesh import make_host_mesh, profile_collectives
    from repro_torch.models import LeastSquares
    from repro_torch.utils import pytree as pt

    t0 = time.perf_counter()
    dev = torch.device("cuda", 0)
    mesh = make_host_mesh(data=1)
    axis = mesh.client_axis("data")
    with api.client_sharding(axis):  # the communicator, before any capture
        api.client_scalar_sum(torch.ones(1, device=dev))
    torch.cuda.synchronize(dev)
    if batch is None:
        argv = dict(zip(POPULATION[::2], POPULATION[1::2]))
        batch = to_torch(linreg_noniid(0, int(argv["--samples"]),
                                       int(argv["--dim"]),
                                       int(argv["--clients"])), dev)
    m, n = batch["A"].shape[0], batch["A"].shape[-1]
    model = LeastSquares(n)
    rows, budgets, seconds = [], {}, {}
    for label, name, hp in SHARDED_ALGOS:
        t_algo = time.perf_counter()
        fed = FedConfig(algorithm=name, num_clients=m, k0=5, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        s0 = algo.init(model.init(dev), prng_key(1), init_batch=batch)
        rounds = (SHARDED_SLOW_ROUNDS if label in SHARDED_SLOW
                  else SHARDED_ROUNDS)
        ref = run_rounds(algo, s0, batch, rounds, chunk_size=SHARDED_CHUNK)
        ref_ms = ref.wall_s / ref.rounds_run * 1e3
        for overlap in ("off", "scatter"):
            for scan in (True, False):
                ops.reset_launches()
                res = run_rounds(algo, s0, batch, rounds, scan=scan,
                                 chunk_size=SHARDED_CHUNK, mesh=mesh,
                                 overlap=overlap)
                rows.append(_sharded_row(label, overlap, scan, res, ref,
                                         ref_ms, dict(ops.launches)))
        spec = pt.ravel_spec(s0["x"])
        s0f = flatten_state(algo, s0, spec)
        mask = torch.ones(m, dtype=torch.bool, device=dev)
        for overlap in ("off", "scatter"):
            budgets[f"{label}/{overlap}"] = _profiled_round(
                algo, s0f, batch, spec, mesh, mask, overlap, dev,
                make_round_fn, shard_inputs, profile_collectives)
        seconds[label] = time.perf_counter() - t_algo
    # the sharded active store and uplink, each run held to its unsharded
    # twin: the packed active run (the sharded branch's arithmetic; its
    # overlapped form is the barrier run bit for bit), the uplink run of
    # the same overlap (FedGiA's overlapped uplink runs at the round's
    # end, under the next round's key and fault draws)
    for label, name, hp in SHARDED_ALGOS:
        if label not in SHARDED_STAGE_ALGOS:
            continue
        fed = FedConfig(algorithm=name, num_clients=m, k0=5, **hp)
        algo = make_algorithm(fed, model.loss, model=model)
        s0 = algo.init(model.init(dev), prng_key(1), init_batch=batch)
        spec = pt.ravel_spec(s0["x"])
        for stage in ("active", "uplink"):
            t_algo = time.perf_counter()
            tag = f"{label} {stage}"
            twins = {}
            for overlap in ("off", "scatter"):
                if overlap == "scatter" and (stage == "active"
                                             or name != "fedgia"):
                    # the baselines' uplink runs where the barrier round
                    # runs it: their unsharded overlapped run is the
                    # barrier run bit for bit (tests/test_torch_sharded_
                    # uplink.py), as the active store's is
                    twins[overlap] = twins["off"]
                    continue
                twins[overlap] = run_rounds(
                    algo, s0, batch, SHARDED_ROUNDS, overlap=overlap,
                    chunk_size=SHARDED_CHUNK,
                    **_stage_kw(stage, m, packed=True))
            for overlap in ("off", "scatter"):
                ref = twins[overlap]
                for scan in (True, False):
                    ops.reset_launches()
                    res = run_rounds(algo, s0, batch, SHARDED_ROUNDS,
                                     scan=scan, chunk_size=SHARDED_CHUNK,
                                     mesh=mesh, overlap=overlap,
                                     **_stage_kw(stage, m))
                    rows.append(_sharded_row(
                        tag, overlap, scan, res, ref,
                        ref.wall_s / ref.rounds_run * 1e3,
                        dict(ops.launches)))
            kw = _stage_kw(stage, m)
            s0f = flatten_state(algo, s0, spec)
            if stage == "active":
                pol = kw["participation"]
                mask = pol.mask(pol.init(), 0)[0].to(dev)
                rkw = dict(active_capacity=pol.active_capacity)
            else:
                mask = torch.ones(m, dtype=torch.bool, device=dev)
                s0f["ef"] = torch.zeros((m, spec.padded_size), device=dev)
                rkw = dict(compressor=compress.make_compressor(
                    "int8", error_feedback=True), faults=kw["faults"],
                    screening=kw["screening"])
            for overlap in ("off", "scatter"):
                budgets[f"{tag}/{overlap}"] = _profiled_round(
                    algo, s0f, batch, spec, mesh, mask, overlap, dev,
                    make_round_fn, shard_inputs, profile_collectives, **rkw)
            seconds[tag] = time.perf_counter() - t_algo
    # the chunked driver with tol > 0: each round in a conditional node
    fed = FedConfig(algorithm="fedgia", num_clients=m, k0=5,
                    **SHARDED_ALGOS[0][2])
    algo = make_algorithm(fed, model.loss, model=model)
    s0 = algo.init(model.init(dev), prng_key(1), init_batch=batch)
    ref = run_rounds(algo, s0, batch, SHARDED_ROUNDS, tol=SHARDED_TOL)
    cond = {}
    try:
        ops.reset_launches()
        res = run_rounds(algo, s0, batch, SHARDED_ROUNDS, tol=SHARDED_TOL,
                         mesh=mesh)
        cond = _sharded_row("fedgia_d tol>0", "off", True, res, ref,
                            ref.wall_s / ref.rounds_run * 1e3,
                            dict(ops.launches))
    except Exception as e:  # reported and failed by the parent
        cond = {"error": f"{type(e).__name__}: {e}"}
    # eq. (11)'s all-reduce alone: the FedGiA_D numerator and its riders
    buf = torch.ones(n + 3, device=dev)
    ar_ms = median_ms(lambda: torch.distributed.all_reduce(
        buf, group=axis.group))
    return {"rows": rows, "budgets": budgets, "cond": cond,
            "allreduce_ms": ar_ms, "allreduce_numel": n + 3,
            "seconds": time.perf_counter() - t0, "algo_seconds": seconds}


def _profiled_round(algo, s0f, batch, spec, mesh, mask, overlap, dev,
                    make_round_fn, shard_inputs, profile_collectives, **kw):
    """The collectives of one eager sharded round on the flat state `s0f`
    (the overlapped one with the slot seeded), after a warm-up round
    outside the profile; `kw` go to `make_round_fn` (the active
    capacity, the uplink)."""
    st = dict(s0f)
    if overlap == "scatter":
        slot = torch.zeros((int(getattr(algo, "overlap_slot_rows", 1)),
                            spec.padded_size), device=dev)
        slot[0] = st["x"]
        st["ovl_shard"] = slot
    st, b = shard_inputs(algo, st, batch, mesh)
    rf = make_round_fn(algo, mesh, masked=True, flat_spec=spec,
                       overlap=overlap, **kw)
    rf(dict(st), b, mask)  # warm-up, outside the profile
    torch.cuda.synchronize(dev)
    return profile_collectives(
        lambda: (rf(dict(st), b, mask), torch.cuda.synchronize(dev)),
        spec.padded_size)[1]


def _sharded_row(label, overlap, scan, res, ref, ref_ms, launches):
    """One sharded run against the unsharded one: rounds, the worst
    relative gap of each history entry and of each model-shaped state
    entry, whether they are within the sync tolerance, which are not
    bitwise, its replayed (or eager) ms a round beside the unsharded
    replayed one, and its launches."""
    import numpy as np

    ok = res.rounds_run == ref.rounds_run
    gaps, apart = {}, []
    for k in ref.history:
        a, b = np.asarray(res.history[k]), np.asarray(ref.history[k])
        ok = ok and a.shape == b.shape and bool(np.allclose(
            a, b, rtol=STATE_RTOL, atol=STATE_ATOL))
        gaps[k] = _max_rel(a, b) if a.shape == b.shape else float("inf")
        if a.shape != b.shape or not np.array_equal(a, b):
            apart.append(k)
    for k, tree in ref.state.items():
        if not isinstance(tree, dict):
            continue
        for leaf, want in tree.items():
            got = res.state[k][leaf]
            ok = ok and bool(torch.allclose(got, want, rtol=STATE_RTOL,
                                            atol=STATE_ATOL))
            gaps[f"{k}.{leaf}"] = _max_rel(got, want)
            if not torch.equal(got, want):
                apart.append(f"{k}.{leaf}")
    return {"label": label, "overlap": overlap,
            "driver": "chunked" if scan else "--no-scan",
            "rounds": res.rounds_run, "want_rounds": ref.rounds_run,
            "ok": ok, "max_rel": gaps,
            "not_bitwise": apart,
            "ms": res.wall_s / res.rounds_run * 1e3, "unsharded_ms": ref_ms,
            "launches": launches}


def sharded_phase(train, launch, card, batch):
    """Phase 2i in a child process (`launch` at world size 1 over NCCL,
    so no process group outlives the phase): the rows of `_sharded_rank`
    checked and printed. Then `--shard-clients 2` on this one-card
    machine must raise with the device count. Returns the FedGiA runs'
    launches by kernel form, which join the main path's."""
    launches = {"fedgia_update_batched": 0,
                "fedgia_update_batched_donated": 0}
    t_phase = time.perf_counter()
    say(f"client-sharded rounds at world size 1 over NCCL (population "
        f"data, {SHARDED_ROUNDS} rounds ({SHARDED_SLOW_ROUNDS} for "
        f"{', '.join(SHARDED_SLOW)}), tol 0; baselines at lr "
        f"{SHARDED_LR}), each against the unsharded chunked run at rtol "
        f"{STATE_RTOL}, atol {STATE_ATOL} (a history entry whose sharded "
        f"formula differs, the gradient norm's reduce-scattered sum of "
        f"squares, is expected not bitwise; the states are), on {card}; "
        f"the 'active' rows under uniform {STORE_ALPHA} with "
        f"store='active' against the unsharded aggregate='packed' run, "
        f"the 'uplink' rows under int8 + EF + crash,nan at "
        f"{SHARDED_FAULT_RATE} + screening (clip {SHARDED_CLIP}) against "
        f"the unsharded run of the same overlap:")
    out = launch(_sharded_rank, 1, batch, device="cuda")
    bad = []
    for r in out["rows"]:
        worst = max(r["max_rel"].values())
        say(f"  {r['label']} overlap={r['overlap']} {r['driver']}: "
            f"{r['rounds']} rounds, {r['ms']!r} ms a round against "
            f"{r['unsharded_ms']!r} unsharded (replayed), worst relative "
            f"gap {worst!r} ({'within' if r['ok'] else 'OUTSIDE'} the "
            f"tolerance); not bitwise: {r['not_bitwise'] or 'none'}; "
            f"launches {r['launches']}")
        want = (SHARDED_SLOW_ROUNDS if r["label"] in SHARDED_SLOW
                else SHARDED_ROUNDS)
        if not r["ok"] or r["rounds"] != want or r["want_rounds"] != want:
            bad.append(f"{r['label']}/{r['overlap']}/{r['driver']}")
        if r["label"].startswith("fedgia"):
            # diag_ema's H refresh reads ḡ after the update: the undonated
            # form; scalar H the donated one
            kern = ("fedgia_update_batched"
                    if r["label"].startswith("fedgia_d")
                    else "fedgia_update_batched_donated")
            if r["launches"][kern] != SHARDED_ROUNDS:
                bad.append(f"{r['label']}/{r['overlap']}/{r['driver']}: "
                           f"launches {r['launches']}")
            launches[kern] += r["launches"][kern]
        elif sum(r["launches"].values()):
            bad.append(f"{r['label']}: launched {r['launches']}")
    for key, c in out["budgets"].items():
        barrier = key.endswith("/off")
        ok = (c["all_reduce_model"] == 1 and c["reduce_scatter"] <= 1
              and c["all_gather"] == 0) if barrier else (
            c["all_reduce_model"] == 0 and c["reduce_scatter"] == 1
            and c["all_gather"] == 1)
        say(f"  one eager {key} round's collectives (c10d events): {c}"
            f"{'' if ok else ' OUTSIDE the budget'}")
        if not ok:
            bad.append(f"budget {key}: {c}")
    cond = out["cond"]
    if "error" in cond:
        bad.append(f"tol > 0 under a mesh: {cond['error']}")
        say(f"  chunked driver with tol > 0 (NCCL inside conditional graph "
            f"nodes): {cond['error']}")
    else:
        say(f"  chunked driver with tol {SHARDED_TOL} (each round and its "
            f"NCCL collectives in a conditional graph node): "
            f"{cond['rounds']} rounds, {cond['ms']!r} ms a round against "
            f"{cond['unsharded_ms']!r} unsharded, worst relative gap "
            f"{max(cond['max_rel'].values())!r}; launches "
            f"{cond['launches']}")
        if not cond["ok"]:
            bad.append("tol > 0 under a mesh: outside the tolerance")
    say(f"  eq. (11)'s all-reduce alone ({out['allreduce_numel']} float32, "
        f"world size 1, NCCL): {out['allreduce_ms'] * 1e3!r} us (median of "
        f"{REPS}, CUDA events) on {card}; the child process took "
        f"{out['seconds']!r} s, of which each algorithm's runs "
        f"{out['algo_seconds']}")
    try:
        train.main(["--shard-clients", "2", "--rounds", "1"])
    except RuntimeError as e:
        count = torch.cuda.device_count()
        if f"this machine has {count}" not in str(e):
            bad.append(f"--shard-clients 2 raised another error: {e}")
        say(f"  --shard-clients 2 on this machine: RuntimeError: {e}")
    else:
        bad.append("--shard-clients 2 ran on a machine with "
                   f"{torch.cuda.device_count()} card(s)")
    if bad:
        raise SystemExit("phase 2i: " + "; ".join(bad))
    say(f"  the FedGiA runs' launches: {launches}")
    say(f"phase 2i took {time.perf_counter() - t_phase!r} s")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    if not (SRC / "repro_torch").is_dir():
        raise SystemExit(f"chip_smoke: {SRC / 'repro_torch'} not found")
    sys.path.insert(0, str(SRC))
    from repro_torch.benchmarks import common as bench_common
    from repro_torch.benchmarks import fig3_alpha, kernels_bench, table4
    from repro_torch.config import FedConfig
    from repro_torch.configs import get_config
    from repro_torch.core import api as api_mod
    from repro_torch.core import engine, prng, selection
    from repro_torch.core import fedgia as fedgia_mod
    from repro_torch.core import hparams as hparams_mod
    from repro_torch.core.baselines import common as baselines_common
    from repro_torch.examples import fl_transformer, quickstart
    from repro_torch.kernels import _build
    from repro_torch.kernels.fedgia_update import ops, ref
    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.flash_attention import ref as flash_ref
    from repro_torch.kernels.rwkv6_scan import ops as scan_ops
    from repro_torch.kernels.rwkv6_scan import ref as scan_ref
    from repro_torch.core import graphs
    from repro_torch.examples import serve_requests
    from repro_torch.launch import serve, train
    from repro_torch.launch.mesh import launch
    from repro_torch.models import Transformer
    from repro_torch.models import moe as moe_mod
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.utils import pytree as pt

    counters = (ops, flash_ops, scan_ops)

    # 1. build -----------------------------------------------------------
    say(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    card = card_line()
    say(card)
    for name, path in _build.build().items():
        say(f"built {name}: {path.relative_to(ROOT)}")
        for line in _build.build_logs.get(name, "").splitlines():
            if ("registers" in line or "spill" in line
                    or "Compiling entry function" in line):
                say("  " + line.strip())

    # 1b. the threefry stream on the card's host --------------------------
    key = prng.prng_key(PRNG_KNOWN_SEED)
    for t, want in enumerate(PRNG_KNOWN_IDS):
        key, mask = selection.round_split(key, t, PRNG_KNOWN_M,
                                          PRNG_KNOWN_ALPHA)
        got = torch.nonzero(mask).flatten().tolist()
        if got != want:
            raise SystemExit(f"prng: round {t} selected {got}, the "
                             f"reference {want}")
    say(f"prng: the paper run's first {len(PRNG_KNOWN_IDS)} FedGiA splits "
        f"(m={PRNG_KNOWN_M}, alpha={PRNG_KNOWN_ALPHA}, "
        f"prng_key({PRNG_KNOWN_SEED})) are the reference's, client for "
        "client")

    # 2. FedGiA main path ----------------------------------------------------
    # the default driver replays CUDA-graph chunks; each run is also made
    # with the eager --no-scan loop, launches read apart from the main path
    launches = {k: 0 for k in read_counts(counters)}
    paper, n, paper_eager, _ = run_pair(train, counters, PAPER, "paper run")
    if not paper["stopped_early"]:
        raise SystemExit("paper run did not stop early")
    if n["fedgia_update_batched_donated"] != paper["rounds"] or \
            sum(n.values()) != paper["rounds"]:
        raise SystemExit(f"paper run: launches {n} != {paper['rounds']} rounds")
    for k in launches:
        launches[k] += n[k]

    pop, n, pop_eager, _ = run_pair(train, counters, POPULATION,
                                    "population run")
    if n["fedgia_update_batched"] != 20 or sum(n.values()) != 20:
        raise SystemExit(f"population run: launches {n} != 20 rounds")
    if not all(math.isfinite(h["f"]) for h in pop["history"]):
        raise SystemExit("population run: non-finite f")
    for k in launches:
        launches[k] += n[k]
    for res in (paper_eager, pop_eager):
        del res["batch"], res["state"]

    one, n = run_main_path(train, counters, ONE_CLIENT)
    say(done_line("one-client run (cuda, CUDA-graph chunks)", one))
    say(f"  launches: {n}")
    if n["fedgia_update_single"] != 5 or sum(n.values()) != 5:
        raise SystemExit(f"one-client run: launches {n} != 5 rounds")
    for k in launches:
        launches[k] += n[k]

    cpu = train.main(PAPER + ["--device", "cpu"])
    say(done_line("paper run (cpu, plain versions)", cpu))
    card_vs_cpu_run(paper, cpu, "paper run")
    paper_in, pop_in, one_in = (round_inputs(res, engine, pt)
                                for res in (paper, pop, one))
    # the split of a round (phase 6) goes on from these runs' states
    profiled = {what: (res, argv, res["wall_s"] / res["rounds"] * 1e6)
                for what, res, argv in (("paper", paper, PAPER),
                                        ("population", pop, POPULATION))}
    for res in (one, cpu):
        del res["batch"], res["state"]

    # 6. where a round's time goes, while the process's profiler is fresh
    round_split_phase(profiled, (fedgia_mod, hparams_mod, api_mod), engine,
                      selection, pt, prng, card)

    # 2b. the paper's comparison baselines -------------------------------
    t_phase = time.perf_counter()
    say(f"baselines at the paper size, replayed, eager and on the CPU, on "
        f"{card}:")
    per_round = {}
    for name in BASELINES:
        argv = ["--algo", name, "--lr",
                str(bench_common.ALGO_HPARAMS[name]["lr"])]
        short, n, eager, _ = run_pair(train, counters, argv + BASELINE_PAIR,
                                      f"{name} paper run, "
                                      f"{BASELINE_PAIR[1]} rounds")
        got, n_full = run_main_path(train, counters, argv + PAPER)
        say(done_line(f"{name} paper run (cuda, CUDA-graph chunks)", got))
        if sum(n.values()) or sum(n_full.values()):
            raise SystemExit(f"{name} paper run launched kernels: {n}, "
                             f"{n_full}")
        if name in CPU_PAIR_ONLY:  # the CPU over the pair's rounds
            cpu = train.main(argv + BASELINE_PAIR + ["--device", "cpu"])
            say(done_line(f"{name} paper run, {BASELINE_PAIR[1]} rounds "
                          f"(cpu)", cpu))
            card_vs_cpu_run(short, cpu, f"{name} paper run, "
                                        f"{BASELINE_PAIR[1]} rounds")
        else:
            cpu = train.main(argv + PAPER + ["--device", "cpu"])
            say(done_line(f"{name} paper run (cpu)", cpu))
            card_vs_cpu_run(got, cpu, f"{name} paper run")
        per_round[name] = [per_round_ms(got), per_round_ms(eager)]
        for res in (short, got, eager, cpu):
            del res["batch"], res["state"]
    per_round["fedgia"] = [per_round_ms(paper), per_round_ms(paper_eager)]
    say("  paper size, ms a round (replayed, eager): " + ", ".join(
        f"{k} {v[0]!r} / {v[1]!r}" for k, v in per_round.items()))

    say(f"all five algorithms at the population size, replayed against "
        f"eager, on {card} (paper Table I: gradients a round):")
    per_round = {"fedgia": [per_round_ms(pop), per_round_ms(pop_eager), 1]}
    # the population run's own client data and model, not made again
    model, batch = pop["algorithm"].model, pop["batch"]
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    for name in BASELINES:
        fed = FedConfig(algorithm=name, num_clients=batch["A"].shape[0],
                        **bench_common.ALGO_HPARAMS[name])
        algo = api_mod.make_algorithm(fed, model.loss, model=model)
        state = algo.init(model.init(batch["A"].device),
                          prng.prng_key(1), init_batch=batch)
        out = {}
        for tag, scan in (("replayed", True), ("eager", False)):
            reset_counts(counters)
            res = engine.run_rounds(algo, state, batch, rounds, scan=scan)
            n = read_counts(counters)
            f = float(res.history["f_xbar"][-1])
            say(f"{name} population run ({tag}): {res.rounds_run} rounds "
                f"in {res.wall_s!r} s, {res.wall_s / res.rounds_run * 1e3!r}"
                f" ms a round (capture {res.capture_s!r} s apart), f={f!r}; "
                f"launches {n}")
            if res.rounds_run != rounds or sum(n.values()):
                raise SystemExit(f"{name} population run ({tag}): "
                                 f"{res.rounds_run} rounds, launches {n}")
            out[tag] = res
        hold_replayed_to_eager(out["replayed"].state, out["eager"].state,
                               f"{name} population run")
        grads = int(fed.k0 * (fed.inner_steps if name in ("fedprox", "fedpd")
                              else 1))
        per_round[name] = [r.wall_s / r.rounds_run * 1e3
                           for r in out.values()] + [grads]
        t_grad = baseline_gradient_ms(algo, state, batch, engine, pt,
                                      baselines_common)
        say(f"  {name}: one gradient evaluation {t_grad!r} ms (CUDA events, "
            f"median of {REPS}); {grads} a round = {grads * t_grad!r} ms of "
            f"the replayed round's {per_round[name][0]!r} ms, the rest "
            f"{per_round[name][0] - grads * t_grad!r} ms")
        del out, state
    say("  population size, ms a round (replayed, eager; gradients a "
        "round): " + ", ".join(f"{k} {v[0]!r} / {v[1]!r} ({v[2]})"
                               for k, v in per_round.items()))

    say(f"Table IV, linreg, k0 = 5, one trial, on {card} (CSV):")
    reset_counts(counters)
    rows = table4.run(problems=["linreg"], trials=1, k0s=[5],
                      device="cuda")
    n = read_counts(counters)
    for line in table4.csv_lines(rows):
        say(line)
    d_rounds = int(next(r["cr"] for r in rows if r["algo"] == "fedgia_d")
                   // 2)
    say(f"  launches: {n} (FedGiA_D ran {d_rounds} rounds)")
    if n["fedgia_update_batched"] != d_rounds or sum(n.values()) != d_rounds:
        raise SystemExit(f"Table IV: launches {n}, want {d_rounds} "
                         f"fedgia_update_batched launches and no other")
    for r in rows:
        if not math.isfinite(r["obj"]) or (
                r["algo"].startswith("fedgia") and r["conv_frac"] != 1.0):
            raise SystemExit(f"Table IV: bad row {r}")
    launches["fedgia_update_batched"] += n["fedgia_update_batched"]

    say(f"quickstart (m={quickstart.M}, n={quickstart.N}, "
        f"d={quickstart.D}, k0={quickstart.K0}) on {card}:")
    reset_counts(counters)
    lines, results = quickstart.run("cuda")
    n = read_counts(counters)
    for line in lines:
        say(line)
    say(f"  launches: {n}")
    gia = results[0]
    if not gia.stopped_early or n["fedgia_update_batched"] != \
            gia.rounds_run or sum(n.values()) != gia.rounds_run:
        raise SystemExit(f"quickstart: FedGiA ran {gia.rounds_run} rounds "
                         f"(stopped {gia.stopped_early}), launches {n}")
    launches["fedgia_update_batched"] += n["fedgia_update_batched"]
    del lines, results, gia
    say(f"phase 2b took {time.perf_counter() - t_phase!r} s")

    # 2c. the rest of §V ---------------------------------------------------
    t_phase = time.perf_counter()
    say(f"Fig. 3 (FedGiA_D, k0 = {fig3_alpha.K0}, the engine's uniform "
        f"policy, m={bench_common.M_CLIENTS}), on {card} and on the CPU "
        f"(the same masks):")
    reset_counts(counters)
    rows = fig3_alpha.run("cuda", collect_history=True)
    n = read_counts(counters)
    cpu_rows = fig3_alpha.run("cpu", collect_history=True)
    _, _, fig3_tol = bench_common.make_problem("linreg", 0, "cpu")
    say("alpha,CR,time_s,obj,CR_cpu,obj_cpu")
    for r, c in zip(rows, cpu_rows):
        say(f"{r['alpha']},{r['cr']},{r['time_s']!r},{r['obj']!r},"
            f"{c['cr']},{c['obj']!r}")
        hold_card_to_cpu(r["history"], c["history"], fig3_tol,
                         f"Fig. 3 alpha {r['alpha']}")
        if not r["converged"]:
            raise SystemExit(f"Fig. 3: alpha {r['alpha']} did not converge")
    ran = sum(r["rounds"] for r in rows)
    say(f"  launches: {n} ({ran} rounds ran)")
    if n["fedgia_update_batched"] != ran or sum(n.values()) != ran:
        raise SystemExit(f"Fig. 3: launches {n}, want {ran} "
                         f"fedgia_update_batched launches and no other")
    fig3_alpha.check(rows)
    launches["fedgia_update_batched"] += n["fedgia_update_batched"]
    del rows, cpu_rows

    argv = PAPER + ["--participation", "uniform", "--alpha", "0.25"]
    got, n = run_main_path(train, counters, argv)
    say(done_line("paper run, uniform policy alpha 0.25 (cuda)", got))
    say(f"  launches: {n}; mask draws {got['draw_s']!r} s on the host")
    if n["fedgia_update_batched_donated"] != got["rounds"] or \
            sum(n.values()) != got["rounds"]:
        raise SystemExit(f"paper run under a policy: launches {n} != "
                         f"{got['rounds']} rounds")
    launches["fedgia_update_batched_donated"] += got["rounds"]
    cpu = train.main(argv + ["--device", "cpu"])
    card_vs_cpu_run(got, cpu, "paper run under the uniform policy")
    del got, cpu

    m = pop["batch"]["A"].shape[0]
    rounds = int(POPULATION[POPULATION.index("--rounds") + 1])
    say(f"FedGiA_D at the population size (m={m}) under each policy, "
        f"{rounds} rounds, tol 0, replayed against eager, on {card}:")
    model, batch, algo = pop["algorithm"].model, pop["batch"], \
        pop["algorithm"]
    state = algo.init(model.init(batch["A"].device),
                      prng.prng_key(1), init_batch=batch)
    policies = {
        "uniform 0.1": selection.make_policy("uniform", m, 0.1),
        "weighted 0.5": selection.make_policy(
            "weighted", m, 0.5, weights=1 + torch.arange(m) % 4),
        "cyclic 0.25": selection.make_policy("cyclic", m, 0.25),
        "straggler 0.2": selection.make_policy("straggler", m,
                                               drop_prob=0.2,
                                               horizon=rounds),
        "periodic": selection.make_policy("periodic", m, horizon=rounds),
    }
    for what, pol in policies.items():
        got, n, _ = engine_pair(engine, counters, algo, state, batch, rounds,
                                f"{what} policy", participation=pol)
        if n["fedgia_update_batched"] != rounds or sum(n.values()) != rounds:
            raise SystemExit(f"{what} policy: launches {n} != {rounds}")
        sel = got.history["selected"]
        say(f"  {what}: selected a round {int(sel.min())}..{int(sel.max())}; "
            f"replayed {got.wall_s / rounds * 1e3!r} ms a round, of which "
            f"the host's mask draws {got.draw_s / rounds * 1e3!r} ms "
            f"({got.draw_s!r} s for the one {got.chunk_size}-round chunk)")
        launches["fedgia_update_batched"] += rounds

    fed = FedConfig(algorithm="scaffold", num_clients=m,
                    **bench_common.ALGO_HPARAMS["scaffold"])
    scaffold = api_mod.make_algorithm(fed, model.loss, model=model)
    s_state = scaffold.init(model.init(batch["A"].device),
                            prng.prng_key(1), init_batch=batch)
    got, n, _ = engine_pair(
        engine, counters, scaffold, s_state, batch, rounds,
        "SCAFFOLD, uniform policy 0.25",
        participation=selection.make_policy("uniform", m, 0.25))
    if sum(n.values()):
        raise SystemExit(f"SCAFFOLD under a policy launched kernels: {n}")
    del got, s_state, scaffold

    def peak_above_start(run):
        """(result, peak device bytes allocated above those at the start)"""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        res = run()
        return res, torch.cuda.max_memory_allocated() - start

    reset_counts(counters)
    auto, peak_auto = peak_above_start(lambda: engine.run_rounds(
        algo, state, batch, rounds, chunk_size="auto"))
    n = read_counts(counters)
    fixed, peak_fixed = peak_above_start(lambda: engine.run_rounds(
        algo, state, batch, rounds))
    say(f"population run, --chunk auto: chose {auto.chunk_size} rounds a "
        f"chunk; {auto.wall_s / rounds * 1e3!r} ms a round (capture "
        f"{auto.capture_s!r} s apart) against {fixed.wall_s / rounds * 1e3!r}"
        f" ms with one {fixed.chunk_size}-round chunk; peak device memory "
        f"above the run's start {peak_auto} against {peak_fixed} bytes; "
        f"launches {n}")
    if n["fedgia_update_batched"] != rounds or sum(n.values()) != rounds:
        raise SystemExit(f"--chunk auto: launches {n} != {rounds}")
    hold_replayed_to_eager(auto.state, fixed.state, "--chunk auto against "
                           "a fixed chunk", bitwise_only=True)
    launches["fedgia_update_batched"] += rounds
    del auto, fixed, state

    say(f"Table IV, logreg and ncvx_logreg, k0 in {{1, 5, 10}}, one trial, "
        f"on {card} (CSV):")
    reset_counts(counters)
    rows = table4.run(problems=["logreg", "ncvx_logreg"], trials=1,
                      k0s=[1, 5, 10], device="cuda")
    n = read_counts(counters)
    for line in table4.csv_lines(rows):
        say(line)
    d_rounds = int(sum(r["cr"] for r in rows if r["algo"] == "fedgia_d")
                   // 2)
    say(f"  launches: {n} (the FedGiA_D rows ran {d_rounds} rounds)")
    if n["fedgia_update_batched"] != d_rounds or sum(n.values()) != d_rounds:
        raise SystemExit(f"Table IV logistic: launches {n}, want {d_rounds} "
                         f"fedgia_update_batched launches and no other")
    for r in rows:
        if not math.isfinite(r["obj"]) or (
                r["algo"].startswith("fedgia") and r["conv_frac"] != 1.0):
            raise SystemExit(f"Table IV logistic: bad row {r}")
    launches["fedgia_update_batched"] += n["fedgia_update_batched"]
    for problem in ("logreg", "ncvx_logreg"):
        _, _, tol = bench_common.make_problem(problem, 0, "cpu")
        for algo_key in ("fedgia_d", "fedgia_g"):
            got, want = (bench_common.run_algorithm(
                algo_key, problem, 5, collect_history=True, device=dev)
                for dev in ("cuda", "cpu"))
            hold_card_to_cpu(got["history"], want["history"], tol,
                             f"Table IV {problem} {algo_key} k0=5")
    del rows

    got, n = run_main_path(train, counters, PAPER + ["--unrolled"])
    say(done_line("paper run, --unrolled (cuda)", got))
    say(f"  launches: {n}; {per_round_ms(got)!r} ms a replayed round "
        f"against the collapsed run's {per_round_ms(paper)!r}")
    if sum(n.values()):
        raise SystemExit(f"--unrolled launched kernels: {n}")
    hold_card_to_cpu(cli_history(got), cli_history(paper), PAPER_TOL,
                     "paper run on the card", sides=("unrolled", "collapsed"))
    del got

    say(f"kernels_bench (parts 1-2) on {card}:")
    kernels_bench.main([])
    say(f"phase 2c took {time.perf_counter() - t_phase!r} s")

    # 2d. client stores ---------------------------------------------------
    million = client_store_phase(pop, train, counters, launches, card)

    # 2e. async and clocked rounds ------------------------------------------
    kept = {}  # wallclock_bench's rows, which phase 2h writes out
    per_client_anchor = async_phase(pop, counters, launches, card, ops, ref,
                                    kept)

    # 2f. uplink codecs, faults, guard, checkpoints ---------------------------
    uplink_phase(pop, counters, launches, card, kept)

    # 2g. federated training of the dense transformers -----------------------
    at_width = training_phase(train, fl_transformer, counters, launches,
                              card, ops, ref, engine, pt,
                              (fedgia_mod, hparams_mod, api_mod), prng)

    # 2h. the per-leaf rounds and the benchmark suite ---------------------------
    pytree_phase(train, counters, launches, card, engine, paper, pop, million,
                 kept)
    del million, kept
    # phase 2i's data, kept past the drop of phase 6's runs
    pop_batch = pop["batch"]

    # 3. serving path, full width -------------------------------------------
    # the default decode is one captured CUDA-graph step replayed a token;
    # --no-scan runs the same step eagerly, a dispatch per op
    served, logits16 = {}, {}
    for argv, mod, name, layers in (
            (TINYLLAMA, flash_ops, "flash_attention", 22),
            (RWKV6, scan_ops, "rwkv6_scan", 32)):
        arch = argv[1]
        cfg = get_config(arch)
        batch, gen = int(argv[3]), int(argv[7])
        runs = {}
        for mode, extra in (("captured", []), ("--no-scan", ["--no-scan"])):
            tokens, n, times, call, logits = serve_main_path(
                serve, counters, argv + extra, mod, name)
            runs[mode] = tokens, logits
            capture = ("" if times["capture_s"] is None
                       else f"capture_s={times['capture_s']!r} ")
            say(f"serve {arch} {mode} (cuda, full width, batch {batch}, "
                f"prompt {argv[5]}, gen {gen}): "
                f"prefill_s={times['prefill_s']!r} "
                f"({times['prefill_tokens']} tokens) {capture}"
                f"decode_s={times['decode_s']!r} "
                f"decode_tok_s_req={times['decode_tok_s_req']!r} on {card}")
            say(f"  generated[0,:16] = {tokens[0, :16].tolist()}")
            say(f"  launches: {n}")
            # the prefill launches the kernel once a layer; the decode,
            # captured or eager, launches none
            if n[name] != layers or sum(n.values()) != layers:
                raise SystemExit(f"serve {arch} {mode}: launches {n}, want "
                                 f"{layers} {name} launches and no other")
            if tokens.shape != (batch, gen) or tokens.min() < 0 or \
                    tokens.max() >= cfg.vocab_size:
                raise SystemExit(f"serve {arch}: bad tokens {tokens.shape}")
            if mode == "captured":
                if not times["capture_s"]:
                    raise SystemExit(f"serve {arch}: no capture logged")
                launches[name] += n[name]
                served[name] = call
        hold_captured_to_eager(f"serve {arch}", runs["captured"],
                               runs["--no-scan"])
        t_cap, l_cap = runs["captured"]
        logits16[arch] = (l_cap, t_cap)
    say(f"main-path launches: {launches}")

    l16, t16 = logits16.pop("tinyllama-1.1b")
    fp8_cache_run(serve, graphs, Transformer, get_config, TINYLLAMA, l16,
                  torch.as_tensor(t16), card)
    del l16, logits16
    say("serve_requests (reduced, bfloat16):")
    serve_requests_run(serve_requests, counters, card)

    # 3b. head_dim 160, MLA, MoE and MTP at full width ------------------------
    hd160 = moe_mla_phase(serve, train, Transformer, get_config, moe_mod,
                          counters, launches, card, flash_ops, flash_ref)
    say(f"main-path launches after phase 3b: {launches}")

    # 3c. the hybrid SSM block and the embeds inputs at full width -----------
    slice14 = hybrid_embeds_phase(serve, train, Transformer, get_config,
                                  ssm_mod, counters, launches, card,
                                  flash_ops, flash_ref)
    say(f"main-path launches after phase 3c: {launches}")

    # 4. card against CPU, reduced, float32 ------------------------------------
    say("card vs cpu, reduced float32 models (prefill "
        f"{PARITY_PROMPT} tokens, {PARITY_GEN - 1} decode steps; the card's "
        "captured, the CPU's eager):")
    for arch in ("tinyllama-1.1b", "rwkv6-3b"):
        card_vs_cpu(serve, Transformer, get_config, arch, counters)

    # 5. kernels against their plain versions, then times --------------------
    # each fedgia_update form on the round inputs of the run that launched
    # it, so at its main-path shape; then the same kernel through the TPU
    # kernels' interface (the form timed before the redesign), with the
    # donated one also at the population shape, which no run gives it
    say(f"fedgia_update vs plain version on one round's inputs, then times "
        f"on {card} (median of {REPS} launches, CUDA events; in a graph: "
        f"one replay of {REPS} launches):")
    kernels = []
    for name, args, round_form in (
            ("fedgia_update_batched", pop_in, True),
            ("fedgia_update_batched_donated", paper_in, True),
            ("fedgia_update_single", one_in, True),
            ("fedgia_update_batched", pop_in, False),
            ("fedgia_update_batched_donated", paper_in, False),
            ("fedgia_update_batched_donated", pop_in, False),
            ("fedgia_update_single", one_in, False)):
        k = hold_and_time(name, args, ops, ref, round_form=round_form)
        nbytes = k.pop("nbytes")
        in_graph = ("" if k["graph_ms"] is None else
                    f"in_graph_us={k['graph_ms'] * 1e3:.3f} ")
        say(f"  {name} {k['shape']} [{k.pop('form')}]: "
            f"kernel_us={k['ms'] * 1e3:.3f} {in_graph}"
            f"plain_us={k['plain_ms'] * 1e3:.2f} "
            f"bound_us={k['bound_ms'] * 1e3:.3f} (bytes: {nbytes}) "
            f"achieved={nbytes / (k['ms'] * 1e-3) / 1e9:.1f} GB/s "
            f"share_of_bound={k['bound_ms'] / k['ms']:.4f} library_us=none "
            f"(no single PyTorch call computes this fused update)")
        if round_form:
            k["launches"] = launches[name]
            if k["launches"] < 1:
                raise SystemExit(f"{name} was not launched on the main path")
            if name == "fedgia_update_batched":
                # the async rounds' form: an (m, N) anchor (phase 2e)
                k["per_client_anchor"] = per_client_anchor
            # the same kernel at tinyllama-1.1b's width (phase 2g)
            k["at_model_width"] = at_width[name] if name in at_width \
                else None
            kernels.append(k)

    g = torch.Generator(device="cuda").manual_seed(0)
    say("flash_attention vs plain version (layer 0 of the tinyllama "
        "prefill, then edge cases):")
    (q, k, v), kw = served["flash_attention"]
    if kw.get("window") is not None or not kw.get("causal", True):
        raise SystemExit(f"flash_attention: unexpected main-path options {kw}")
    flash_err = check_flash(flash_ops, flash_ref, q, k, v, None, "main path")
    check_flash(flash_ops, flash_ref, q.float(), k.float(), v.float(), None,
                "main path in float32")
    for dt in (torch.float32, torch.bfloat16):
        for B, H, Kv, S, hd, window, what in (
                (1, 8, 2, 1024, 64, 256, "causal + window 256"),
                (2, 8, 2, 1000, 64, None, "ragged S 1000"),
                (2, 4, 1, 512, 128, None, "MQA, head_dim 128"),
                # the tensor-core form's edges: one query, one whole
                # 128-query tile and a ragged one, and at head_dim 128
                # (64-key tiles, two TMA boxes a row) a GQA group of 8
                # with the window's edge tile
                (2, 8, 2, 1, 64, None, "S 1"),
                (2, 8, 2, 130, 64, None, "S 130 (128 + ragged 2)"),
                (1, 16, 2, 1024, 128, 256,
                 "GQA group 8, head_dim 128, window 256"),
                # phase 3c's main-path shapes: an odd group of 5 over 25
                # heads, a ragged last query tile at head_dim 128 (3008 =
                # 23 x 128 + 64), and group 1 over 32 heads, ragged
                (1, 25, 5, 1024, 64, None, "GQA group 5, H 25 (hymba)"),
                (1, 32, 8, 3008, 128, None,
                 "S 3008, head_dim 128, group 4 (llava)"),
                (1, 32, 32, 1500, 64, None, "MHA group 1, S 1500 (musicgen)")):
            qs, ks, vs = (randn(g, (B, S, n, hd), dt).transpose(1, 2)
                          for n in (H, Kv, Kv))
            check_flash(flash_ops, flash_ref, qs, ks, vs, window, what)

    say("rwkv6_scan vs plain version (layer 0 of the rwkv6 prefill, then "
        "edge cases):")
    (r, kk, vv, w, u), _ = served["rwkv6_scan"]
    scan_err = check_scan(scan_ops, scan_ref, r, kk, vv, w, u, "main path")
    for B, H, T, hd, dt, what in ((2, 4, 1000, 64, torch.float32,
                                   "ragged T 1000"),
                                  (2, 4, 200, 64, torch.bfloat16, "bf16 r k v"),
                                  (2, 3, 64, 32, torch.float32, "head_dim 32"),
                                  # one step: a single ragged chunk
                                  (2, 4, 1, 64, torch.float32, "T 1"),
                                  # one 32-column group holds the whole
                                  # head, 2 state rows a thread
                                  (1, 2, 17, 32, torch.bfloat16,
                                   "head_dim 32, bf16, ragged T 17")):
        rs, ks, vs = (randn(g, (B, T, H, hd), dt, 0.5).transpose(1, 2)
                      for _ in range(3))
        ws = (0.85 + 0.149 * torch.rand((B, T, H, hd), generator=g,
                                        device="cuda")).transpose(1, 2)
        check_scan(scan_ops, scan_ref, rs, ks, vs, ws,
                   randn(g, (H, hd), scale=0.5), what)

    say(f"times at the main-path shapes on {card} (median of {REPS} "
        f"launches, CUDA events):")
    ms = median_ms(lambda: flash_ops.flash_attention(q, k, v))
    plain_ms = median_ms(lambda: flash_ref.flash_attention_ref(q, k, v))
    library_ms = median_ms(sdpa(q, k, v))
    bound_ms, bound_by, flops, nbytes = flash_bound(q, k)
    done = flash_tile_flops(flash_ops, q)
    say(f"  flash_attention q {list(q.shape)} k {list(k.shape)} bf16 causal: "
        f"kernel_us={ms * 1e3:.2f} plain_us={plain_ms * 1e3:.2f} "
        f"library_us={library_ms * 1e3:.2f} (scaled_dot_product_attention) "
        f"bound_us={bound_ms * 1e3:.2f} ({bound_by}; {flops} flop, "
        f"{nbytes} bytes) achieved={flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"share_of_bound={bound_ms / ms:.4f}; the tiles computed hold "
        f"{done} flop, {done / flops:.4f}x the visible pairs' "
        f"({done / (ms * 1e-3) / 1e12:.2f} TFLOP/s issued)")
    kernels.append({
        "name": "flash_attention", "route": "cuda",
        "source": SOURCES["flash_attention"],
        "replaces": TPU_KERNELS["flash_attention"],
        "launches": launches["flash_attention"], "max_abs_err": flash_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": library_ms,
        # the head_dim-160 form at stablelm-12b's prefill (phase 3b)
        "hd160": hd160,
        # phase 3c's models' prefills (layer 0 each)
        "slice14": slice14})

    ms = median_ms(lambda: scan_ops.rwkv6_scan(r, kk, vv, w, u))
    plain_ms = median_ms(lambda: scan_ref.rwkv6_scan_ref(r, kk, vv, w, u))
    bound_ms, bound_by, flops, nbytes = scan_bound(r, w, u)
    split = scan_ops.column_split(r.shape[3])
    say(f"  rwkv6_scan r {list(r.shape)} fp32: kernel_us={ms * 1e3:.2f} "
        f"plain_us={plain_ms * 1e3:.2f} library_us=none (no PyTorch call "
        f"computes this recurrence) bound_us={bound_ms * 1e3:.2f} "
        f"({bound_by}; {flops} flop, {nbytes} bytes) "
        f"achieved={nbytes / (ms * 1e-3) / 1e9:.1f} GB/s "
        f"share_of_bound={bound_ms / ms:.4f}; "
        f"{split.warps(r.shape[0], r.shape[1])} warps in "
        f"{split.groups * r.shape[0] * r.shape[1]} blocks")
    kernels.append({
        "name": "rwkv6_scan", "route": "cuda", "source": SOURCES["rwkv6_scan"],
        "replaces": TPU_KERNELS["rwkv6_scan"],
        "launches": launches["rwkv6_scan"], "max_abs_err": scan_err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None})

    for res, _, _ in profiled.values():  # phase 6's runs, kept for 2h
        del res["batch"], res["state"]

    # 2i. the client-sharded round over NCCL, world size 1 ------------------
    # last: once a child process has run these rounds on the card, this
    # process's torch.profiler sessions record no device time
    sharded = sharded_phase(train, launch, card, pop_batch)
    del pop_batch
    for k in kernels:
        k["launches"] += sharded.get(k["name"], 0)

    # 7. result ------------------------------------------------------------
    say(json.dumps({"kernels": kernels}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
