"""The port's spans, marks and counters (`repro_torch/utils/spans.py`) in
the chunked driver and FedGiA's flat round, on the CPU.

Off (no profiler session) nothing is recorded and no profiler range is
entered; on (inside a CPU `torch.profiler` session) the driver's spans
nest as documented, its draw spans sum to `RoundResult.draw_s`, its
counter counts, and the run's state and history are the untraced run's
bit for bit. The device marks are checked with a stand-in event, since
there is no card here: none is recorded while a capture is reported.
"""
import ast
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.config import FedConfig
from repro_torch.core.engine import run_rounds
from repro_torch.core.fedgia import FedGiA
from repro_torch.core.prng import prng_key
from repro_torch.data import linreg_noniid, to_torch
from repro_torch.models import LeastSquares
from repro_torch.utils import spans

ROOT = Path(__file__).resolve().parents[1]
M, N, D = 8, 12, 160
ROUNDS, CHUNK = 10, 4  # chunks of 4, 4 and 2 rounds
DRIVER_SPANS = {"driver.call", "driver.chunk", "driver.draw",
                "driver.replay"}
ROUND_SPANS = {"round.eq11", "round.ravel", "round.gradient",
               "round.h_refresh"}


@pytest.fixture(autouse=True)
def _empty_recorder():
    spans.reset()
    yield
    spans.reset()


def _problem():
    """A small FedGiA_D (diag_ema H) least-squares run's inputs."""
    model = LeastSquares(N)
    algo = FedGiA(FedConfig(num_clients=M, k0=3, alpha=0.5, sigma_t=0.2,
                            h_policy="diag_ema"), model.loss, model=model)
    batch = to_torch(linreg_noniid(0, D, N, M), "cpu")
    state = algo.init(model.init("cpu"), prng_key(3), init_batch=batch)
    return algo, state, batch


def _run(tol=0.0):
    algo, state, batch = _problem()
    return run_rounds(algo, state, batch, ROUNDS, tol=tol, chunk_size=CHUNK)


def _traced(tol=0.0):
    """The run inside a CPU profiler session: (RoundResult, recording)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = _run(tol)
    return res, spans.recorded()


class _Ranges:
    """Stands in for `record_function`, counting the ranges entered."""

    entered = 0

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        type(self).entered += 1
        return self

    def __exit__(self, *exc):
        return False


class _Event:
    """Stands in for `torch.cuda.Event`: records the host clock."""

    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        type(self).made += 1
        self.t = None

    def record(self):
        self.t = time.perf_counter_ns()

    def query(self):
        return self.t is not None

    def elapsed_time(self, other):  # ms, as CUDA's
        return (other.t - self.t) / 1e6


@pytest.fixture
def fake_card(monkeypatch):
    """Marks as on the card, with stand-in events; `capturing` (a list of
    one bool) is what `is_current_stream_capturing` reports."""
    capturing = [False]
    _Event.made = 0
    monkeypatch.setattr(spans, "_cuda", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: capturing[0])
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    return capturing


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    _Ranges.entered = 0
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Ranges)
    res = _run()
    assert res.rounds_run == ROUNDS and res.draw_s > 0
    assert _Ranges.entered == 0
    rec = spans.recorded()
    assert rec["spans"] == [] and rec["marks"] == []
    assert rec["counters"] == {} and rec["anchors"] == {}
    assert spans.span("driver.chunk") is spans.span("round.gradient")
    # the stand-in does count the ranges a span enters while on
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("driver.chunk"):
            pass
    assert _Ranges.entered == 1


def test_tracing_leaves_state_and_history_bitwise():
    off = _run()
    on, rec = _traced()
    assert rec["spans"]
    assert on.rounds_run == off.rounds_run
    for k, v in off.history.items():
        np.testing.assert_array_equal(on.history[k], v, err_msg=k)
    for k in ("x", "z", "pi", "h"):
        for leaf, t in off.state[k].items():
            assert torch.equal(on.state[k][leaf], t), (k, leaf)
    assert np.array_equal(on.state["rng"], off.state["rng"])


def test_span_tree_of_the_chunked_driver():
    res, rec = _traced()
    got = rec["spans"]
    assert {s.name for s in got} == DRIVER_SPANS | ROUND_SPANS
    calls = [i for i, s in enumerate(got) if s.name == "driver.call"]
    assert calls == [0] and got[0].parent is None
    assert {s.call for s in got} == {got[0].call}
    for s in got:
        assert s.t1_ns is not None and s.t1_ns >= s.t0_ns
    chunks = [i for i, s in enumerate(got) if s.name == "driver.chunk"]
    assert len(chunks) == 3
    assert all(got[i].parent == 0 for i in chunks)
    for name in ("driver.draw", "driver.replay"):
        kids = [s.parent for s in got if s.name == name]
        assert kids == chunks, name
    replays = {i for i, s in enumerate(got) if s.name == "driver.replay"}
    # the warm-up's round runs in the call, each chunk's in its replay
    grads = [s.parent for s in got if s.name == "round.gradient"]
    assert grads[0] == 0 and set(grads[1:]) <= replays
    assert len(grads) == 1 + ROUNDS
    for name in ROUND_SPANS:
        assert all(got[s.parent].name in ("driver.call", "driver.replay")
                   for s in got if s.name == name)
    assert sum(s.name == "round.ravel" for s in got) == 3 * (1 + ROUNDS)


def test_draw_spans_sum_to_draw_s():
    res, rec = _traced()
    draws = [s.t1_ns - s.t0_ns for s in rec["spans"]
             if s.name == "driver.draw"]
    assert len(draws) == 3
    assert sum(draws) * 1e-9 == res.draw_s


@pytest.mark.parametrize("tol", [0.0, 1e-30])
def test_driver_counters(tol):
    """Off the card no graph is captured, in the timed loop or before it,
    whether the run may stop early or not: the counter stays empty."""
    res, rec = _traced(tol)
    assert res.rounds_run == ROUNDS
    assert rec["counters"] == {}


def test_counters_count_only_while_on():
    spans.count("driver.graph_captures", key=12)
    assert spans.recorded()["counters"] == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.count("driver.graph_captures", key=12)
        spans.count("driver.graph_captures", key=12)
        spans.count("driver.graph_captures", n=3, key=2)
    assert spans.recorded()["counters"] == {
        "driver.graph_captures": {12: 2, 2: 3}}


def test_recorder_stays_within_its_bound(monkeypatch, fake_card):
    monkeypatch.setattr(spans, "_REC", spans.Recorder(limit=8))
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        res = _run()
        for _ in range(20):
            spans.mark("driver.chunk_end")
    rec = spans.recorded()
    assert res.rounds_run == ROUNDS
    assert len(rec["spans"]) == 8 and len(rec["marks"]) == 8
    assert rec["dropped"] > 12
    assert not spans._REC.open  # every span closed, the dropped ones too


def test_mark_records_nothing_while_capturing(fake_card):
    fake_card[0] = True
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        spans.anchor()
        spans.mark("driver.replay_start")
        with spans.span("round.gradient"):
            pass
    rec = spans.recorded()
    assert _Event.made == 0
    assert rec["marks"] == [] and rec["anchors"] == {}
    assert [s.name for s in rec["spans"]] == ["round.gradient"]
    # not capturing, the anchor and the mark record an event each, and a
    # span none
    fake_card[0] = False
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.call("driver.call"):
            spans.anchor()
            spans.mark("driver.replay_start")
            with spans.span("round.gradient"):
                pass
    rec = spans.recorded()
    assert _Event.made == 2
    (m,) = rec["marks"]
    call = rec["spans"][0].call
    assert m.call == call and m.span == 0
    # the stand-in's device is the host clock: the anchor puts the mark
    # at its own host time
    assert m.at_ns == pytest.approx(m.host_ns, abs=1e5)
    assert rec["anchors"][call] <= m.host_ns


def test_marks_of_a_run_on_the_card_resolve(monkeypatch, fake_card):
    """With stand-in events the driver's marks fall in the places
    documented, two a chunk off the card (no replay), and the round's
    spans record none."""
    res, rec = _traced()
    chunk_ids = [i for i, s in enumerate(rec["spans"])
                 if s.name == "driver.chunk"]
    marks = rec["marks"]
    assert [m.name for m in marks] == [
        "driver.upload_start", "driver.chunk_end"] * 3
    assert [m.span for m in marks] == [i for i in chunk_ids for _ in (0, 1)]
    # the CPU run has no anchor (the synchronise is the card's) and no
    # replay mark
    assert all(m.at_ns is None for m in marks)
    assert _Event.made == len(marks)


def _harness_labels():
    """The labels that perfbench's step split and traced window put
    around the port's functions from outside."""
    bench = ROOT / "perfbench"
    tree = ast.parse((bench / "pbench" / "harness.py").read_text())
    labels = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            labels.add(node.value)
    sys.path.insert(0, str(bench))
    try:
        from pbench.trace import HOST_RANGES
    finally:
        sys.path.remove(str(bench))
    assert {"gradient", "eq. (11)", "update kernel", "H refresh",
            "metrics"} <= labels
    return labels | set(HOST_RANGES)


def test_no_span_name_is_a_harness_label():
    src = ROOT / "src" / "repro_torch" / "core"
    names = set()
    for f in ("engine.py", "fedgia.py"):
        tree = ast.parse((src / f).read_text())
        for node in ast.walk(tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "spans"
                    and node.func.attr in ("span", "call", "record", "mark",
                                           "count")):
                names.add(node.args[0].value)
    assert names == DRIVER_SPANS | ROUND_SPANS | {
        "driver.upload_wait", "driver.upload_start", "driver.replay_start",
        "driver.chunk_end", "driver.graph_captures"}
    assert not names & _harness_labels()
