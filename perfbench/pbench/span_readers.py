"""The arithmetic of the metrics read from the port's own spans, marks and
anchor (`repro_torch/utils/spans.py`), which a `--trace 1` run records
because its profiler sessions turn them on.

A recording is `spans.recorded()`: {"spans": [Span(name, parent, call,
t0_ns, t1_ns)], "marks": [Mark(name, span, call, host_ns,
at_ns)], "anchors": {call: host_ns}, ...}, every time on the host's
`perf_counter_ns` clock; a mark's `at_ns` is when the device reached it,
put on that clock by its driver call's anchor. Each reader returns None
where the recording holds nothing to read, and `recording()` is None for
a program that records no spans."""
from __future__ import annotations


def recording():
    """The port's recording, or None: nothing recorded, or a program
    without `repro_torch.utils.spans`."""
    try:
        from repro_torch.utils import spans
    except ImportError:
        return None
    rec = spans.recorded()
    return rec if rec["spans"] else None


def last_call(rec):
    """The id of the last `driver.call` (the traced window's), or None."""
    calls = [s.call for s in rec["spans"] if s.name == "driver.call"]
    return calls[-1] if calls else None


def boundary_gaps(rec):
    """[(start_ns, end_ns)] on the host clock in which no chunk of the
    last driver call ran on the device: from each chunk's last mark to
    the next chunk's first. The time before the first chunk's first mark
    (its draw, paid once a call) is not a boundary. None without an
    anchor or a resolved chunk mark."""
    if rec is None:
        return None
    call = last_call(rec)
    if call is None or call not in rec["anchors"]:
        return None
    by_chunk = {}
    for m in rec["marks"]:
        if (m.call == call and m.span is not None
                and rec["spans"][m.span].name == "driver.chunk"):
            if m.at_ns is None:
                return None
            by_chunk.setdefault(m.span, []).append(m.at_ns)
    if not by_chunk:
        return None
    gaps, end = [], None
    for i in sorted(by_chunk):
        first, last = by_chunk[i][0], by_chunk[i][-1]
        if end is not None:
            gaps.append((end, max(end, first)))
            last = max(end, last)
        end = last
    return gaps


def boundary_idle_ms(rec, rounds: int):
    """Device ms a round with no chunk running (`boundary_gaps`)."""
    gaps = boundary_gaps(rec)
    if gaps is None or rounds <= 0:
        return None
    return sum(b - a for a, b in gaps) * 1e-6 / rounds


def draw_stall_ms(rec, rounds: int):
    """Device ms a round of the boundary gaps that fall inside the host's
    `driver.draw` spans of the same call: the device waiting on the
    draws."""
    gaps = boundary_gaps(rec)
    if gaps is None or rounds <= 0:
        return None
    call = last_call(rec)
    draws = [(s.t0_ns, s.t1_ns) for s in rec["spans"]
             if s.name == "driver.draw" and s.call == call]
    stall = sum(max(0, min(b, d1) - max(a, d0))
                for a, b in gaps for d0, d1 in draws)
    return stall * 1e-6 / rounds

