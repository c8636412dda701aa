"""Spans, device marks and counters of the round driver and the round.

The port's own timeline: named host spans at the boundaries of the
chunked driver (`core/engine.py::_Chunked`) and of FedGiA's flat round
(`core/fedgia.py`), CUDA events ("marks") that put the driver's chunks on
the device's clock, and a counter of the graphs the driver captures
inside its timed loop.

Everything here is on only while a `torch.profiler` session is active:
there is no switch of its own. Off, `span` and `call` test one flag and
return a shared no-op context (no `record_function`, no clock read, no
allocation), and `mark`, `anchor`, `record` and `count` test it and
return. On:

* `span(name)` enters `torch.profiler.record_function(name)`, so the span
  sits in the profiler's trace on the device trace's clock beside the
  kernels, and appends (name, parent, call id, t0_ns, t1_ns) on
  `time.perf_counter_ns()` to a bounded recorder. The parent is the
  innermost open span; `call(name)` opens a span that starts a new call
  id, which every span and mark inside it shares.
* `record(name, t0_ns, t1_ns)` appends a span whose host times the caller
  read itself (the driver's draws, which `RoundResult.draw_s` sums from
  the same two reads).
* `mark(name)` records a timing `torch.cuda.Event` on the current stream,
  on the card and only while that stream is not capturing a graph (an
  event recorded inside a capture would be part of the graph).
* `anchor()`, recorded right after a synchronise while the stream is
  idle, ties the marks of its call to the host clock: a mark then reads
  `at_ns`, the host-clock time at which the device reached it, within the
  latency of launching the anchor's event.
* `count(name, n=1, key=None)` adds `n` to the counter `name` under `key`.

`recorded()` returns what was recorded, the marks resolved (read it
after a synchronise: a mark the device has not reached reads None);
`reset()` empties the recorder.
There is no exporter: a file of the timeline is the profiler's own
`export_chrome_trace`.
"""
from __future__ import annotations

import contextlib
import itertools
import time
from typing import NamedTuple, Optional

import torch

# spans and marks the recorder keeps; later ones are dropped and counted
LIMIT = 1 << 16

_profiler = torch.autograd.profiler


def _cuda() -> bool:
    return torch.cuda.is_initialized()


class Span(NamedTuple):
    name: str
    parent: Optional[int]  # index of the innermost open span at entry
    call: Optional[int]  # the driver call's id; None outside any call
    t0_ns: int
    t1_ns: Optional[int]  # None while open


class Mark(NamedTuple):
    name: str
    span: Optional[int]  # index of the innermost open span
    call: Optional[int]
    host_ns: int  # when the host recorded it
    at_ns: Optional[float]  # when the device reached it, on the host clock


class Recorder:
    """What the spans, marks and counters recorded, up to `limit` spans
    and `limit` marks."""

    def __init__(self, limit: int = LIMIT):
        self.limit = limit
        self.reset()

    def reset(self):
        self.spans = []  # [name, parent, call, t0, t1]
        self.marks = []  # [name, span, call, host_ns, event]
        self.anchors = {}  # call id -> (host_ns, event)
        self.counters = {}  # name -> {key: n}
        self.dropped = 0
        self.open = []  # indices of the open spans, innermost last
        self.call = None
        self.calls = itertools.count(1)

    def _parent(self):
        return self.open[-1] if self.open else None

    def enter(self, name: str):
        if len(self.spans) >= self.limit:
            self.dropped += 1
            self.open.append(None)
            return
        parent = self._parent()
        self.open.append(len(self.spans))
        self.spans.append([name, parent, self.call, time.perf_counter_ns(),
                           None])

    def exit(self):
        i = self.open.pop()
        if i is not None:
            self.spans[i][4] = time.perf_counter_ns()

    def record(self, name: str, t0_ns: int, t1_ns: int):
        if len(self.spans) >= self.limit:
            self.dropped += 1
            return
        self.spans.append([name, self._parent(), self.call, t0_ns, t1_ns])

    def mark(self, name: str):
        ev = _event()
        if ev is None:
            return
        if len(self.marks) >= self.limit:
            self.dropped += 1
            return
        self.marks.append([name, self._parent(), self.call,
                           time.perf_counter_ns(), ev])

    def anchor(self):
        ev = _event()
        if ev is not None:
            self.anchors[self.call] = (time.perf_counter_ns(), ev)

    def count(self, name: str, n: int, key):
        by_key = self.counters.setdefault(name, {})
        by_key[key] = by_key.get(key, 0) + n

    def snapshot(self) -> dict:
        """The recording, marks resolved: {"spans": [Span], "marks":
        [Mark], "anchors": {call: host_ns}, "counters": {name: {key: n}},
        "dropped": n}."""
        spans = [Span(*s) for s in self.spans]
        marks = []
        for n, s, c, host, ev in self.marks:
            at = None
            if c in self.anchors:
                a_host, a_ev = self.anchors[c]
                d = _elapsed_ns(a_ev, ev)
                at = None if d is None else a_host + d
            marks.append(Mark(n, s, c, host, at))
        return {"spans": spans, "marks": marks,
                "anchors": {c: h for c, (h, _) in self.anchors.items()},
                "counters": {k: dict(v) for k, v in self.counters.items()},
                "dropped": self.dropped}


def _event():
    """A timing event recorded on the current stream, or None off the card
    or inside a capture."""
    if not _cuda() or torch.cuda.is_current_stream_capturing():
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _elapsed_ns(e0, e1):
    if not (e0.query() and e1.query()):
        return None
    return e0.elapsed_time(e1) * 1e6


_REC = Recorder()


class _On:
    """A span while the profiler is on: a profiler range and an entry of
    the recorder."""

    __slots__ = ("name", "new_call", "range", "saved_call")

    def __init__(self, name: str, new_call: bool):
        self.name, self.new_call = name, new_call

    def __enter__(self):
        self.range = _profiler.record_function(self.name)
        self.range.__enter__()
        if self.new_call:
            self.saved_call = _REC.call
            _REC.call = next(_REC.calls)
        _REC.enter(self.name)
        return self

    def __exit__(self, *exc):
        _REC.exit()
        if self.new_call:
            _REC.call = self.saved_call
        self.range.__exit__(*exc)
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the span `name` while the profiler is on; a
    shared no-op off."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, False)


def call(name: str):
    """`span(name)` that starts a new call id (a driver call)."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _On(name, True)


def record(name: str, t0_ns: int, t1_ns: int):
    """Record a finished span whose `perf_counter_ns` times the caller
    read."""
    if _profiler._is_profiler_enabled:
        _REC.record(name, t0_ns, t1_ns)


def mark(name: str):
    """A timing event on the current stream, on the card, not capturing."""
    if _profiler._is_profiler_enabled:
        _REC.mark(name)


def anchor():
    """Tie this call's marks to the host clock: record right after a
    synchronise."""
    if _profiler._is_profiler_enabled:
        _REC.anchor()


def count(name: str, n: int = 1, key=None):
    """Add `n` to the counter `name` under `key`."""
    if _profiler._is_profiler_enabled:
        _REC.count(name, n, key)


def recorded() -> dict:
    """What was recorded since the last `reset` (`Recorder.snapshot`)."""
    return _REC.snapshot()


def reset():
    _REC.reset()
