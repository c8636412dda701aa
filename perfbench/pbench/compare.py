"""The comparison that decides `correct`: the program's readings of the
first three rounds against the reference's.

Numbers compared (each against the limit its cell's workload file
states):
  loss_gap  the largest relative gap of a round's reported f(x̄);
  gsq_gap   the same of its reported ‖g‖²;
  grad_gap  the worst leaf's gap between the norms of the first round's
            ḡ (the program's worked out from its π¹), over the larger of
            that leaf's reference norm and the median leaf's;
  step_gap  the same of x̄ after the third round less x⁰, over the
            leaves whose first-round reference gradient is at least a
            thousandth of the median leaf's (below it a leaf moves by
            round-off alone, as a key's bias under softmax);
  r_gap     the relative gap of r, the curvature bound that sets σ."""
from __future__ import annotations

import math
import statistics
import sys

import numpy as np

FLOOR = 1e-3  # of the median leaf's gradient: leaves below leave the step


def _leafnorm(rows):
    return float(np.sqrt(np.sum(np.square(np.asarray(rows, np.float64)))))


def _worst(prog: dict, ref: dict, keep=None):
    keys = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-300)
               for k in keys)


def gaps(prog: dict, ref: dict) -> dict:
    """{number: value} from two readings (`systems.fedgia` layout)."""
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-300)  # noqa: E731
    g_ref = {k: _leafnorm(v) for k, v in ref["gbar"].items()}
    g_prog = {k: _leafnorm(v) for k, v in prog["gbar"].items()}
    med = statistics.median(g_ref.values())
    keep = {k for k, v in g_ref.items() if v >= FLOOR * med}
    out = {
        "loss_gap": max(rel(a, b) for a, b in zip(prog["f"], ref["f"])),
        "gsq_gap": max(rel(a, b) for a, b in zip(prog["gsq"], ref["gsq"])),
        "grad_gap": _worst(g_prog, g_ref),
        "step_gap": _worst(prog["step"], ref["step"], keep),
        "r_gap": rel(prog["r"], ref["r"]),
    }
    # a reading that is not a number fails, and stays valid JSON
    return {k: (v if math.isfinite(v) else sys.float_info.max)
            for k, v in out.items()}


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when every number
    that has a limit is finite and at most its limit."""
    checks = {k: {"value": numbers[k], "limit": lim}
              for k, lim in limits.items()}
    ok = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
             for c in checks.values())
    return ok, checks
