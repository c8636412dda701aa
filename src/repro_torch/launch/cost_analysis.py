"""Roofline terms from the dry run's traced costs (counterpart of
`repro/launch/hlo_analysis.py`).

The reference reads XLA's `compiled.cost_analysis()` for per-device
FLOPs and bytes and parses the per-device HLO text for its collectives.
The port has no HLO: `launch/dryrun.py` traces a step on fake tensors
and hands over its collectives as records ``(kind, dtype, shape)`` or
``(kind, dtype, shape, axis)``: a torch dtype, and the mesh axis (or
tuple of axes) the collective runs over. `collective_bytes` sums their
result sizes, weighting an all-reduce 2x (ring reduce-scatter +
all-gather wire cost), as the reference weights them; `roofline_terms`
keeps the reference's keys (``hlo_flops`` and ``hlo_bytes`` included) so
that the roofline code reads both packages' records. The reference's
`count_hlo_ops` has no counterpart: nothing in either package calls it.

Hardware model: the NVIDIA H100 SXM's datasheet figures, not
measurements: 989e12 bf16 FLOP/s dense and 3.35e12 B/s of HBM3 a card;
a collective's wire rate is that of its mesh axis, 450e9 B/s each way
over NVLink where the axis's ranks lie within one 8-card node, 50e9 B/s
(one 400 Gb/s NIC a card) where the axis crosses nodes.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

PEAK_FLOPS = 989e12  # bf16 dense, a card
HBM_BW = 3.35e12  # bytes/s, a card
NVLINK_BW = 450e9  # bytes/s each way, a card, within a node
NIC_BW = 50e9  # bytes/s, a card, across nodes (400 Gb/s)
NODE_SIZE = 8  # cards a node

COLLECTIVES = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# wire-cost multiplier per result byte (ring algorithms)
_WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def _axis_key(axis) -> str:
    if axis is None:
        return ""
    return ",".join(axis) if isinstance(axis, (tuple, list)) else str(axis)


def collective_bytes(records: Iterable) -> Dict[str, object]:
    """Sum the result sizes of collective records ``(kind, dtype, shape
    [, axis])``: `kind` one of `COLLECTIVES`, or its async ``-start`` /
    ``-done`` pair, which counts once (the ``-start``). Returns
    {kind: bytes, "total": bytes, "wire_bytes": weighted,
    "wire_by_axis": {axis: weighted}} (axes joined by "," ; "" for a
    record without one)."""
    out: Dict[str, object] = {k: 0.0 for k in COLLECTIVES}
    wire, by_axis = 0.0, {}
    for rec in records:
        kind, dtype, shape = rec[:3]
        axis = _axis_key(rec[3] if len(rec) > 3 else None)
        if kind.endswith("-done"):
            continue
        base = kind[:-6] if kind.endswith("-start") else kind
        if base not in COLLECTIVES:
            raise ValueError(f"unknown collective {kind!r}: {COLLECTIVES}")
        nbytes = math.prod(shape) * dtype.itemsize
        out[base] += nbytes
        w = nbytes * _WIRE_FACTOR[base]
        wire += w
        by_axis[axis] = by_axis.get(axis, 0.0) + w
    out["total"] = sum(out[k] for k in COLLECTIVES)
    out["wire_bytes"] = wire
    out["wire_by_axis"] = by_axis
    return out


def axis_bandwidth(mesh, node_size: int = NODE_SIZE) -> Dict[str, float]:
    """{axis: wire rate in B/s} of a row-major mesh (`axis_names`,
    `shape`). The ranks of one group of an axis (or of consecutive axes)
    lie in an aligned block of prod(sizes from that axis on) ranks: it
    runs over NVLink where that block fits in one `node_size`-card node,
    over the NICs otherwise. Consecutive axes are keyed by their names
    joined with "," (a compound client axis)."""
    names, shape = tuple(mesh.axis_names), tuple(mesh.shape)

    def rate(first):
        block = math.prod(shape[first:])
        return (NVLINK_BW if block <= node_size and node_size % block == 0
                else NIC_BW)

    out = {}
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            out[",".join(names[i:j])] = rate(i)
    return out


def roofline_terms(cost: dict, coll: Dict[str, object],
                   axis_bw: Optional[Dict[str, float]] = None
                   ) -> Dict[str, object]:
    """Three roofline terms (seconds, per card) + dominance. `cost`:
    {"flops", "bytes accessed"}; `coll`: `collective_bytes`' result.
    Each axis's wire bytes go at its rate in `axis_bw`
    (`axis_bandwidth`); bytes of no known axis at the NIC rate."""
    flops = float(cost.get("flops", 0.0))
    bytes_hbm = float(cost.get("bytes accessed", 0.0))
    axis_bw = axis_bw or {}
    by_axis = coll.get("wire_by_axis") or {"": coll["wire_bytes"]}
    t_coll = sum(w / axis_bw.get(a, NIC_BW) for a, w in by_axis.items())
    terms = {
        "t_compute_s": flops / PEAK_FLOPS,
        "t_memory_s": bytes_hbm / HBM_BW,
        "t_collective_s": t_coll,
    }
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = {
        "t_compute_s": "compute",
        "t_memory_s": "memory",
        "t_collective_s": "collective",
    }[dom]
    terms["hlo_flops"] = flops
    terms["hlo_bytes"] = bytes_hbm
    terms["collective_bytes"] = coll["total"]
    terms["wire_bytes"] = coll["wire_bytes"]
    return terms

