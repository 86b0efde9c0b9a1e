"""The program's spans read beside the benchmark's (``program_spans``), on
the CPU: idle gaps put to the innermost program span with the call-level
total kept, the span metrics' readers on canned records, the host reads
noted per span with the per-call total kept, and the tracer left off in a
run that does not ask for it."""
import sys
import warnings
from pathlib import Path

import pytest
import torch

from portbench import harness, program_spans as ps, tracing
from portbench.tests import tiny
from slam_eds_tpu_torch.telemetry import TRACE, Span

ROOT = Path(__file__).resolve().parents[2]
BASE = 1_700_000_000_000_000_000


def _ns(us):
    return BASE + int(us * 1000)


def _trace():
    """Two calls (a keyframe frame 0-100 us, a packet 100-200 us), three
    device activities, and the program's spans: the frame's (from 2 us)
    holding ``keyframe`` holding ``keyframe.ba``, the packet's holding
    ``packet.read``."""
    calls = [("frame.0", _ns(0), _ns(100)), ("packet.0", _ns(100),
                                             _ns(200))]
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 20.0,
               "dur": 10.0},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 45.0,
               "dur": 5.0},
              {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 120.0,
               "dur": 10.0}]
    spans = [Span("frame", -1, 0, _ns(2), _ns(100)),
             Span("keyframe", 0, 0, _ns(10), _ns(90)),
             Span("keyframe.ba", 1, 0, _ns(40), _ns(60)),
             Span("packet", -1, 3, _ns(100), _ns(200)),
             Span("packet.read", 3, 3, _ns(150), _ns(190))]
    return calls, events, spans


LABELS = {"frame.0": "keyframe_frame"}


def test_idle_gaps_go_to_the_innermost_program_span():
    calls, events, spans = _trace()
    plain = tracing.Stretch()
    plain.spans = list(calls)
    plain._read(events, BASE, LABELS)
    st = ps.ProgramStretch()
    st.spans = list(calls)
    st._read(events, BASE, LABELS, spans)
    got = dict(st.idle_gaps)
    want = {"keyframe_frame": 2e-6, "keyframe_frame/frame": 18e-6,
            "keyframe_frame/keyframe": 50e-6,
            "keyframe_frame/keyframe.ba": 15e-6,
            "packet/packet": 50e-6, "packet/packet.read": 40e-6}
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k] == pytest.approx(v), k
    assert sum(got.values()) == pytest.approx(
        sum(v for _, v in plain.idle_gaps))
    assert st.idle_gaps_by_call == plain.idle_gaps
    assert st.busy_s == plain.busy_s and st.program_spans_laid == 5


def test_without_program_spans_the_stretch_reads_as_before():
    calls, events, _ = _trace()
    plain = tracing.Stretch()
    plain.spans = list(calls)
    plain._read(events, BASE, LABELS)
    st = ps.ProgramStretch()
    st.spans = list(calls)
    st._read(events, BASE, LABELS, [])
    assert st.idle_gaps == plain.idle_gaps == st.idle_gaps_by_call
    assert dict(st.idle_gaps) == {
        "keyframe_frame": pytest.approx(85e-6),
        "packet": pytest.approx(90e-6)}


def test_a_gap_between_calls_keeps_its_label():
    calls, events, spans = _trace()
    calls = [calls[0], ("packet.0", _ns(110), _ns(200))]
    st = ps.ProgramStretch()
    st.spans = calls
    st._read(events, BASE, LABELS, spans)
    got = dict(st.idle_gaps)
    assert got["between_calls"] == pytest.approx(10e-6)
    # the program's packet span covers the gap, the benchmark's call not
    assert "packet/packet" in got and got["packet/packet"] == \
        pytest.approx(40e-6)


def _canned():
    spans = [Span("frame", -1, 0, 0, 10_000_000),          # 10 ms
             Span("track", 0, 0, 0, 4_000_000),
             Span("keyframe", 0, 0, 4_000_000, 10_000_000),
             Span("keyframe.ba", 2, 0, 5_000_000, 8_000_000),
             Span("replay.ba", 3, 0, 5_000_000, 7_000_000),
             Span("frame", -1, 5, 20_000_000, 23_000_000),
             Span("track", 5, 5, 20_000_000, 22_000_000),
             Span("packet", -1, 7, 30_000_000, 80_000_000),
             Span("replay.event_packet", 7, 7, 30_000_000, 79_000_000),
             Span("frame", -1, 9, 90_000_000, 99_000_000),
             Span("keyframe", 9, 9, 92_000_000, 99_000_000),
             Span("replay.ba", 10, 9, 93_000_000, 94_000_000)]
    return {"spans": spans,
            "replays": [(4, 1.5), (8, 45.0), (11, 0.5)],
            # reads: 3 in the first keyframe (one in its BA), 2 tracking,
            # 4 in the second keyframe, which was not counted
            "span_reads": {2: 2, 3: 1, 1: 1, 6: 1, 10: 4},
            "counted_calls": [0, 5]}


def test_span_readers_on_canned_records():
    rec = _canned()
    want = {"keyframe_ms_p50": 6.5, "track_ms_p50": 3.0,
            "ba_device_ms_p50": 1.0, "packet_device_ms_p50": 45.0,
            "keyframe_reads_per_kf": 3.0}
    for name, value in want.items():
        assert harness.load_reader(name)(rec) == pytest.approx(value), name


def test_span_readers_find_nothing_without_program_spans():
    from portbench.tests.test_portbench_harness import _canned as bench_canned
    rec = bench_canned()
    for name in ("keyframe_ms_p50", "track_ms_p50", "ba_device_ms_p50",
                 "packet_device_ms_p50", "keyframe_reads_per_kf"):
        assert harness.load_reader(name)(rec) is None, name
        assert harness.load_reader(name)(dict(rec, spans=[])) is None, name
    rec = dict(_canned(), counted_calls=[])
    assert harness.load_reader("keyframe_reads_per_kf")(rec) is None
    rec = dict(_canned(), replays=[])
    assert harness.load_reader("ba_device_ms_p50")(rec) is None


def test_span_table_self_time_and_reads():
    rec = _canned()
    t = ps.span_table(rec["spans"], rec["replays"], rec["span_reads"])
    assert t["frame"]["n"] == 3
    assert t["frame"]["ms"] == pytest.approx(22.0)
    # frame 1: 10 - 4 - 6; frame 2: 3 - 2; frame 3: 9 - 7
    assert t["frame"]["self_ms"] == pytest.approx(3.0)
    assert t["keyframe"]["self_ms"] == pytest.approx(3.0 + 6.0)
    assert t["keyframe"]["reads"] == 6 and t["keyframe.ba"]["reads"] == 1
    assert t["replay.ba"]["device_ms"] == pytest.approx(2.0)


class _Trace:
    def __init__(self):
        self.spans, self.open = [], []

    def current(self):
        return self.open[-1] if self.open else None


def test_reads_per_span_keep_the_call_total(monkeypatch):
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.update(now=m))
    tr = _Trace()

    def call():
        tr.spans.append("frame")
        tr.open.append(0)
        warnings.warn("called a synchronizing CUDA operation")
        tr.spans.append("keyframe")
        tr.open.append(1)
        for _ in range(3):
            warnings.warn("called a synchronizing CUDA operation")
        warnings.warn("something else")
        tr.open.pop()
        tr.open.pop()
        warnings.warn("called a synchronizing CUDA operation")
        return 7

    _, want = tracing.counted_syncs(call)
    tr.spans.clear()
    reads = ps.SpanReads(tr)
    out, got = reads.counted(call)
    assert (out, got, want) == (7, 5, 5)
    assert reads.by_span == {0: 1, 1: 3, None: 1}
    assert reads.calls == [0] and mode["now"] == 0


def test_an_untraced_run_leaves_the_tracer_off():
    """``--trace 0`` and ``--trace 1`` as the harness runs them: the
    program's tracer stays off and records nothing."""
    TRACE.clear()
    for trace in (False, True):
        res = harness.run(tiny.cell(events=True), 20260917, 2.0,
                          trace=trace, device="cpu", log=lambda *a: None)
        assert res["attempted"] > 0
        assert not TRACE.on and TRACE.spans == [] and TRACE.pending == []


def test_trace_pieces_runs_a_cell_with_the_tracer_on():
    sys.path.insert(0, str(ROOT / "tools"))
    import trace_pieces
    keep = (harness.Window.run, harness.Stretch, harness.counted_syncs,
            harness.load_reader)
    res, table = trace_pieces.run_cell(tiny.cell(events=True), 20260917,
                                       4.0, trace=True, program_trace=True,
                                       device="cpu")
    m = res["metrics"]
    # a span metric is read where its span ran in the window (a slow
    # machine's window may hold no keyframe)
    for metric, span in (("keyframe_ms_p50", "keyframe"),
                         ("track_ms_p50", "track")):
        assert (metric in m) == (span in table), (metric, sorted(table))
        if span in table:
            assert m[metric]["value"] > 0
    # on the CPU nothing is replayed and no read is counted
    for name in ("ba_device_ms_p50", "packet_device_ms_p50",
                 "keyframe_reads_per_kf"):
        assert name not in m
    assert {"frames_per_s", "frame_ms_p95"} <= set(m)
    # one root span per call of the window
    calls = table["frame"]["n"] + table.get("packet", {"n": 0})["n"]
    assert calls == res["attempted"]
    assert res["span_count"] > 0 and not TRACE.on and TRACE.spans == []
    assert (harness.Window.run, harness.Stretch, harness.counted_syncs,
            harness.load_reader) == keep
