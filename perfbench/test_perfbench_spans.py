"""The metrics read from the port's spans and marks (`pbench/span_readers.py`
and their files under `metrics/`), on recordings built by hand with known
gaps and draws; and None where nothing was recorded."""
import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(BENCH.parent / "src"))

from pbench import harness, span_readers  # noqa: E402
from repro_torch.utils.spans import Mark, Span  # noqa: E402

ROUNDS = 4


def _recording():
    """An earlier driver call (id 1), the step split's eager round outside
    any call, then the window's call (id 2) of two chunks.

    Window, host-clock ns from its anchor at 100_000: chunk 1 draws
    101_000-105_000 and its marks land at 106_000, 106_500, 125_000;
    chunk 2 draws 120_000-126_000 and its marks land at 127_000, 127_100,
    150_000. The one boundary gap: 125_000-127_000 (2000 ns, 1000 of them
    in the second draw); chunk 1's draw comes before the first chunk's
    first mark, no boundary."""
    s = [Span("driver.call", None, 1, 0, 50_000),                  # 0
         Span("driver.chunk", 0, 1, 10, 40_000),                   # 1
         Span("driver.draw", 1, 1, 20, 30),                        # 2
         Span("round.eq11", None, None, 0, 1),                     # 3
         Span("round.gradient", None, None, 2, 3),                 # 4
         Span("driver.call", None, 2, 99_000, 160_000),            # 5
         Span("round.gradient", 5, 2, 99_100, 99_200),             # 6
         Span("driver.chunk", 5, 2, 100_500, 126_000),             # 7
         Span("driver.draw", 7, 2, 101_000, 105_000),              # 8
         Span("driver.replay", 7, 2, 106_400, 106_600),            # 9
         Span("driver.chunk", 5, 2, 119_000, 151_000),             # 10
         Span("driver.draw", 10, 2, 120_000, 126_000)]             # 11
    m = [Mark("driver.upload_start", 1, 1, 35, 60.0),
         Mark("driver.chunk_end", 1, 1, 36, 39_000.0),
         Mark("driver.upload_start", 7, 2, 105_100, 106_000.0),
         Mark("driver.replay_start", 7, 2, 105_200, 106_500.0),
         Mark("driver.chunk_end", 7, 2, 106_700, 125_000.0),
         Mark("driver.upload_start", 10, 2, 126_100, 127_000.0),
         Mark("driver.replay_start", 10, 2, 126_200, 127_100.0),
         Mark("driver.chunk_end", 10, 2, 126_300, 150_000.0)]
    return {"spans": s, "marks": m, "anchors": {1: 0, 2: 100_000},
            "counters": {}, "dropped": 0}


EXPECTED = {
    "boundary_idle_ms.population": 2000 * 1e-6 / ROUNDS,
    "boundary_idle_ms.train": 2000 * 1e-6 / ROUNDS,
    "draw_stall_ms.population": 1000 * 1e-6 / ROUNDS,
}


def _ctx():
    return types.SimpleNamespace(window={"rounds": ROUNDS, "wall_s": 1.0})


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_a_recording_built_by_hand(metric, monkeypatch):
    monkeypatch.setattr(span_readers, "recording", _recording)
    assert harness.reader(metric)(_ctx()) == pytest.approx(
        EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", sorted(EXPECTED))
def test_reader_on_an_empty_recording(metric, monkeypatch):
    monkeypatch.setattr(span_readers, "recording", lambda: None)
    assert harness.reader(metric)(_ctx()) is None
    empty = {"spans": [], "marks": [], "anchors": {}, "counters": {},
             "dropped": 0}
    for fn in (span_readers.boundary_idle_ms, span_readers.draw_stall_ms):
        assert fn(empty, ROUNDS) is None


def test_a_program_without_spans_gives_no_recording(monkeypatch):
    import torch

    import repro_torch.utils
    from repro_torch.utils import spans
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with spans.span("driver.chunk"):
            pass
    assert [s.name for s in span_readers.recording()["spans"]] == [
        "driver.chunk"]
    # the parent tree's program: no `repro_torch.utils.spans` to import
    monkeypatch.delattr(repro_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    assert span_readers.recording() is None
    monkeypatch.undo()
    spans.reset()


def test_an_unresolved_mark_reads_nothing():
    rec = _recording()
    rec["marks"][-1] = rec["marks"][-1]._replace(at_ns=None)
    assert span_readers.boundary_idle_ms(rec, ROUNDS) is None
    assert span_readers.draw_stall_ms(rec, ROUNDS) is None


def test_the_window_is_the_last_driver_call():
    rec = _recording()
    assert span_readers.last_call(rec) == 2
    assert span_readers.boundary_gaps(rec) == [(125_000.0, 127_000.0)]
    # the earlier call's draw overlaps no gap of the window
    rec["spans"][2] = rec["spans"][2]._replace(t0_ns=125_000, t1_ns=127_000)
    assert span_readers.draw_stall_ms(rec, ROUNDS) == pytest.approx(
        EXPECTED["draw_stall_ms.population"], rel=1e-12)
    del rec["anchors"][2]
    assert span_readers.boundary_gaps(rec) is None


def test_one_chunk_has_no_boundary():
    rec = _recording()
    rec["marks"] = [m for m in rec["marks"] if m.span != 10]
    assert span_readers.boundary_gaps(rec) == []
    assert span_readers.boundary_idle_ms(rec, ROUNDS) == 0.0
    assert span_readers.draw_stall_ms(rec, ROUNDS) == 0.0


def test_spans_of_the_program_after_a_reset_read_nothing():
    from repro_torch.utils import spans
    spans.reset()
    assert span_readers.recording() is None
