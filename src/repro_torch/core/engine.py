"""Round driver (counterpart of the single-device, flat, dense path of
`repro/core/engine.py::run_rounds`).

The state is raveled ONCE at entry into lane-padded flat buffers
(`flatten_state`), the rounds run `algo.round_flat` on them in one Python
loop, and the dict layout is rebuilt at return (`unflatten_state`). The
stop rule is the reference's legacy loop's (eq. 35): stop after the first
round whose metric is < tol, and that round counts. With tol > 0 this
reads one scalar per round back to the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.selection import copy_generator
from repro_torch.utils.pytree import ravel_spec


@dataclasses.dataclass
class RoundResult:
    """Outcome of `run_rounds`: final state + stacked per-round metrics."""

    state: Any
    history: Dict[str, np.ndarray]  # each (rounds_run,), trimmed at early stop
    rounds_run: int
    stopped_early: bool
    wall_s: float


def flatten_state(algo, state, spec):
    """Ravel the state's model-shaped entries: `algo.flat_global_keys` ->
    (N,) vectors, `algo.flat_client_keys` -> one (m, N) buffer each. Each
    ravel allocates a new buffer, so in-place rounds on the result never
    write the tensors of `state`."""
    out = dict(state)
    for k in algo.flat_global_keys:
        if k in out:
            out[k] = spec.ravel(out[k])
    for k in algo.flat_client_keys:
        if k in out:
            out[k] = spec.ravel_stacked(out[k])
    return out


def unflatten_state(algo, state, spec):
    """Inverse of `flatten_state`: callers see the dict layout."""
    out = dict(state)
    for k in (*algo.flat_global_keys, *algo.flat_client_keys):
        if k in out:
            out[k] = spec.unravel(out[k])
    return out


def _stack(values):
    if torch.is_tensor(values[0]):
        return torch.stack(values).cpu().numpy()
    return np.asarray(values, np.float32)


def run_rounds(algo, state, batch, num_rounds: int, *, tol: float = 0.0,
               tol_metric: str = "grad_sq_norm") -> RoundResult:
    """Run up to `num_rounds` communication rounds of `algo`.

    tol > 0 enables the paper's stopping rule (eq. 35). The caller's
    `state` is left as it was: its tensors are copied into fresh flat
    buffers at entry and its generator is copied, so every round can
    run the in-place (donated) kernel, as the reference donates off the
    CPU backend; on the CPU the donated plain version writes in place too.
    """
    spec = ravel_spec(state["x"])
    flat = flatten_state(algo, state, spec)
    flat["rng"] = copy_generator(state["rng"])
    device = flat["x"].device
    hist = []
    stopped = False
    t0 = time.perf_counter()
    for _ in range(num_rounds):
        flat, met = algo.round_flat(flat, batch, spec, donate_kernel=True)
        hist.append(met)
        if tol > 0 and float(met[tol_metric]) < tol:
            stopped = True
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0
    history = ({k: _stack([h[k] for h in hist]) for k in hist[0]}
               if hist else {})
    return RoundResult(unflatten_state(algo, flat, spec), history, len(hist),
                       stopped, wall)
