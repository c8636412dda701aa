"""One run of one cell: set-up, the first rounds, the measured window,
the traced readings, the comparison with the reference, and the result.

Everything that belongs to one configuration, cell or metric is found by
name: `BENCHMARK.json` names the cell's configuration file, the cell's
parameters are `workloads/<cell>.json`, the configuration's "system"
names `pbench/systems/<system>.py`, and each metric is read by
`metrics/<metric>.py` (its `read(ctx)` returns the value, or None where
it finds nothing to read)."""
from __future__ import annotations

import importlib
import importlib.util
import json
import time
import types
from pathlib import Path

import numpy as np
import torch

from pbench import compare, trace
from pbench.systems.fedgia import FIRST_CALLS, release

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_files(name: str, man: dict, root: Path = ROOT):
    """(cell entry, configuration dict, workload dict) of cell `name`."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg = json.loads((root / configs[cell["config"]]["file"]).read_text())
    wl = json.loads((root / "perfbench" / "workloads"
                     / f"{name}.json").read_text())
    return cell, cfg, wl


def metrics_for(name: str, man: dict, traced: bool):
    """The manifest's metric entries that cell `name` reports: with
    `traced` the per-layer ones (listed for it, or without a list those
    whose end-to-end metric it reports), else the end-to-end ones."""
    e2e = [m for m in man["end_to_end"]
           if name in m.get("workloads", [name])]
    if not traced:
        return e2e
    mine = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in mine)]


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "pbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def system_for(cfg: dict):
    return importlib.import_module(f"pbench.systems.{cfg['system']}").System


def step_split(sut, state, log):
    """Device µs by step of one eager round on a copy of `state`
    (donated, as the driver runs it), in the run's first profiler
    session. None where the session lost a step."""
    from repro_torch.core import api, engine, hparams
    from repro_torch.core import fedgia as fedgia_mod
    from repro_torch.utils.pytree import ravel_spec

    algo = sut.algo
    spec = ravel_spec(state["x"])
    flat = engine.flatten_state(algo, state, spec)
    flat["rng"] = state["rng"].copy()
    mask = None
    if sut.policy is not None:
        mask = sut.policy.mask(sut.policy.init(), 0)[0].to(sut.device)
    targets = [(algo, "_vg", "gradient"), (api, "client_mean", "eq. (11)"),
               (fedgia_mod, "fedgia_update_flat", "update kernel"),
               (hparams, "update_diag_h", "H refresh")]
    targets += [(api, n, "metrics") for n in (
        "client_scalar_mean", "flat_grad_sq_norm", "client_scalar_sum")]
    labels = ("gradient", "eq. (11)", "update kernel", "H refresh",
              "metrics")
    prof = trace.profile_round(
        lambda: algo.round_flat(flat, sut.batch, spec, mask=mask,
                                donate_kernel=True), targets)
    del flat
    split = trace.device_split(prof, labels)
    steps = [s for s in labels
             if s != "H refresh" or sut.fed["h_policy"] == "diag_ema"]
    log("step split (device us, one eager round): "
        + ", ".join(f"{k} {v!r}" for k, v in split.items()))
    if not trace.split_is_whole(split, steps):
        log("step split lost a step: not reported")
        return None
    return split


def traced_window(sut, state, rounds):
    """The driver call of `rounds` rounds under the profiler, its host
    work in ranges. Returns (RoundResult, `trace.window_reading`)."""
    from repro_torch.core import engine
    targets = [(engine._Chunked, "_upload", "host: draw and upload"),
               (torch.cuda.CUDAGraph, "replay", "host: graph replay"),
               (torch.cuda, "synchronize", "host: synchronize")]
    res, prof = trace.profile_window(lambda: sut.run(state, rounds), targets)
    return res, trace.window_reading(prof)


def run_cell(name: str, seed: int, seconds: float, traced: bool, device,
             t_start: float, log, root: Path = ROOT,
             reference_in_place: str = None):
    """One run of cell `name`. Returns the result's dict (the last line's
    keys). `reference_in_place` ("control" or "half_batch") replaces the
    program's readings by the reference's at that setting: the checks
    that `correct` can fail."""
    man = manifest(root)
    cell, cfg, wl = cell_files(name, man, root)
    t0 = time.time()
    sut = system_for(cfg)(cfg, wl, seed, device)
    _sync(device)
    log(f"inputs, algorithm and state: {time.time() - t0!r} s ("
        + ", ".join(f"{k} {v!r} s" for k, v in sut.timings.items())
        + f"); r={float(sut.state0['r'])!r}")
    prog, state, res3 = sut.first_steps(log)
    if reference_in_place is not None:
        prog = sut.reference("control" if reference_in_place == "control"
                             else "ref",
                             half=reference_in_place == "half_batch")
    chunk = sut.chunk
    rate = FIRST_CALLS[1] / max(res3.wall_s, 1e-9)
    del res3
    split = step_split(sut, state, log) if traced else None
    if traced:
        rounds = chunk * wl["trace_chunks"]
    else:
        if wl.get("calibrate_chunks", 0):
            # rounds too short for the first calls' rate: time whole
            # chunks of the window's length, and go on from their state
            release(device)
            res = sut.run(state, chunk * wl["calibrate_chunks"])
            rate = res.rounds_run / max(res.wall_s, 1e-9)
            state = res.state
            del res
        rounds = chunk * max(1, round(seconds * rate / chunk))
    log(f"window size: {rounds} rounds at {rate!r} rounds/s")
    release(device)
    t_call = time.time()
    if traced:
        res, reading = traced_window(sut, state, rounds)
    else:
        res, reading = sut.run(state, rounds), None
    setup_s = t_call - t_start + res.capture_s
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    hist = res.history
    failed = int(np.sum(~(np.isfinite(hist["f_xbar"])
                          & np.isfinite(hist["grad_sq_norm"]))))
    window = {"wall_s": res.wall_s, "rounds": res.rounds_run,
              "draw_s": res.draw_s, "capture_s": res.capture_s}
    log(f"window: {res.rounds_run} rounds in {res.wall_s!r} s (capture "
        f"{res.capture_s!r} s apart, host draws {res.draw_s!r} s); set-up "
        f"{setup_s!r} s; peak {peak} bytes")
    del res, state
    sut.free()
    release(device)
    t_ref = time.time()
    ref = sut.reference("ref")
    numbers = compare.gaps(prog, ref)
    correct, checks = compare.judge(numbers, wl["limits"])
    log(f"reference: {time.time() - t_ref!r} s; readings "
        f"{json.dumps(numbers)}")
    ctx = types.SimpleNamespace(
        cell=name, cfg=cfg, wl=wl, sut=sut, window=window, setup_s=setup_s,
        peak_bytes=peak, split=split, trace=reading)
    metrics = {}
    for m in metrics_for(name, man, traced):
        value = reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": bool(correct) and failed == 0,
           "attempted": window["rounds"], "failed": failed,
           "metrics": metrics,
           "device": device_info(device, cell["chips"], peak)}
    if reading is not None:
        out["device"]["busy_s"] = reading["busy_us"] * 1e-6
        out["device"]["window_s"] = reading["window_us"] * 1e-6
        out["breakdown"] = {"device_ops": reading["device_ops"],
                            "idle_gaps": reading["idle_gaps"]}
    out["checks"] = checks
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_info(device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(peak)}
