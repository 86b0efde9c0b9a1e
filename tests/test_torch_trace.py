"""The port's tracer (``telemetry.TRACE``) on the CPU: off, it records
nothing and makes no device event; on, a frame-only run at 128x96 gives
the spans of each frame call nested as the pipeline nests its pieces;
``collect`` pairs each replay's events with its span; and ``enable`` /
``disable`` / ``clear`` carry nothing from one run to the next."""
import numpy as np
import pytest
import torch

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.io.dataset import SyntheticSequence
from slam_eds_tpu_torch.models.pipeline import FrameOnlyPipeline
from slam_eds_tpu_torch.telemetry import TRACE, Span, traced
from slam_eds_tpu_torch.utils.cameras import Pinhole

torch.set_num_threads(1)

W, H = 128, 96
CAM = Pinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
CFG = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
}
FRAMES = 8
KEYFRAME_PIECES = {"keyframe.insert", "keyframe.spawn", "keyframe.trace",
                   "keyframe.activate", "keyframe.ba",
                   "keyframe.marginalize", "keyframe.template"}


class StubEvent:
    """A device event on the CPU: ``record`` reads a fake device clock."""
    clock = [0.0]
    made = []

    def __init__(self):
        StubEvent.made.append(self)
        self.t = None

    def record(self, stream=None):
        StubEvent.clock[0] += 1.5
        self.t = StubEvent.clock[0]

    def elapsed_time(self, end):
        return end.t - self.t


@pytest.fixture
def stub_events():
    keep = TRACE.new_event
    StubEvent.made.clear()
    TRACE.new_event = StubEvent
    try:
        yield StubEvent
    finally:
        TRACE.new_event = keep
        TRACE.disable()
        TRACE.clear()


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(CAM, num_frames=FRAMES, seed=7,
                            motion_scale=0.35, device="cpu")
    return [(float(seq.times[k]), seq.frame(k)[1]) for k in range(FRAMES)]


def _run(frames):
    pipe = FrameOnlyPipeline(CAM, load_config(CFG), device="cpu")
    for t, img in frames:
        pipe.process_frame(img, t)
    return pipe


@pytest.fixture(scope="module")
def traced_run(frames):
    TRACE.enable()
    try:
        pipe = _run(frames)
    finally:
        TRACE.disable()
    spans = list(TRACE.spans)
    TRACE.clear()
    return pipe, spans


def test_off_records_nothing_and_makes_no_event(frames, stub_events):
    TRACE.clear()
    assert not TRACE.on
    pipe = _run(frames)
    assert pipe.window.next_id >= 3       # the run made keyframes
    assert TRACE.spans == [] and TRACE.pending == []
    assert TRACE.current() is None and stub_events.made == []


def test_on_nests_each_frame_call(traced_run):
    pipe, spans = traced_run
    assert all(isinstance(s, Span) for s in spans)
    roots = [i for i, s in enumerate(spans) if s.parent == -1]
    # one root per entry call, every span of a call under its root
    assert [spans[i].name for i in roots] == ["frame"] * FRAMES
    for i, s in enumerate(spans):
        assert s.t1_ns >= s.t0_ns >= 0, s
        if s.parent >= 0:
            p = spans[s.parent]
            assert s.parent < i and s.call == p.call
            assert p.t0_ns <= s.t0_ns and s.t1_ns <= p.t1_ns, (p, s)
        else:
            assert s.call == i
    names = {s.name for s in spans}
    assert {"bootstrap", "track", "track.hypothesis", "keyframe"} <= names
    assert KEYFRAME_PIECES <= names
    for s in spans:
        parent = spans[s.parent].name if s.parent >= 0 else None
        if s.name == "track":
            assert parent == "frame"
        elif s.name == "track.hypothesis":
            assert parent == "track"
        elif s.name == "keyframe":
            assert parent == "frame"
        elif s.name == "keyframe.spawn":
            assert parent == "keyframe.insert"
        elif s.name in KEYFRAME_PIECES:
            assert parent in ("keyframe", "bootstrap"), s
    hyps = sum(s.name == "track.hypothesis" for s in spans)
    assert hyps == pipe.telemetry.counters["track_hypotheses"]
    kfs = sum(s.name == "keyframe" for s in spans)
    assert kfs == pipe.telemetry.counters["ba_runs"] >= 2


def test_traced_run_computes_the_untraced_run(frames, traced_run):
    pipe, _ = traced_run
    plain = _run(frames)
    np.testing.assert_array_equal(np.stack(pipe.trajectory),
                                  np.stack(plain.trajectory))
    assert dict(pipe.telemetry.counters) == dict(plain.telemetry.counters)


def test_collect_pairs_each_replay_with_its_span(stub_events):
    TRACE.enable()
    with TRACE.span("frame"):
        with TRACE.span("replay.track_frame"):
            TRACE.time_replay(TRACE.device_event(), TRACE.device_event())
        with TRACE.span("keyframe"):
            with TRACE.span("replay.ba"):
                a = TRACE.device_event()
                TRACE.device_event()            # an event of something else
                TRACE.time_replay(a, TRACE.device_event())
    TRACE.disable()
    got = TRACE.collect()
    names = [TRACE.spans[r.span].name for r in got]
    assert names == ["replay.track_frame", "replay.ba"]
    assert [r.ms for r in got] == [1.5, 3.0]
    assert TRACE.pending == [] and TRACE.collect() == []


def test_enable_disable_clear_keep_nothing_between_runs(stub_events):
    @traced("piece")
    def piece(x):
        return x + 1

    TRACE.enable()
    with TRACE.span("frame"):
        assert piece(1) == 2
        TRACE.time_replay(TRACE.device_event(), TRACE.device_event())
        assert TRACE.spans[TRACE.current()].name == "frame"
    TRACE.disable()
    assert [s.name for s in TRACE.spans] == ["frame", "piece"]
    with TRACE.span("after"):             # off: the shared no-op
        assert piece(2) == 3
    assert len(TRACE.spans) == 2 and len(TRACE.pending) == 1
    assert TRACE.span("a") is TRACE.span("b")
    TRACE.enable()
    assert TRACE.spans == [] and TRACE.pending == []
    with TRACE.span("frame"):
        pass
    assert TRACE.spans[0].call == 0 and TRACE.spans[0].parent == -1
    TRACE.disable()
    TRACE.clear()
    assert TRACE.spans == [] and TRACE.pending == []
    assert TRACE.current() is None and not TRACE.on


def test_a_raising_piece_closes_its_span(stub_events):
    @traced("piece")
    def piece():
        raise ValueError("in a piece")

    TRACE.enable()
    with pytest.raises(ValueError):
        with TRACE.span("frame"):
            piece()
    TRACE.disable()
    assert [s.name for s in TRACE.spans] == ["frame", "piece"]
    assert all(s.t1_ns >= s.t0_ns for s in TRACE.spans)
    assert TRACE.current() is None


def test_event_pipeline_spans_one_root_per_call():
    """``EDSPipeline``: its frame call is one ``frame`` span around the
    frame pipeline's work and the event keyframe; each packet call one
    ``packet`` span around its upload, its one read and the adoption."""
    from slam_eds_tpu_torch.models.pipeline import EDSPipeline
    cfg = load_config(dict(CFG, event_frame={"num_levels": 2,
                                             "events_per_frame": 8192},
                           tracker={"max_iterations": [15, 10]}))
    seq = SyntheticSequence(CAM, num_frames=6, events_per_packet=8192,
                            seed=7, motion_scale=0.35, device="cpu")
    pipe = EDSPipeline(CAM, cfg, device="cpu")
    TRACE.enable()
    try:
        for k in range(6):
            t, img, _ = seq.frame(k)
            pipe.process_frame(img, t)
            if k + 1 < 6:
                pipe.process_events(seq.events_between(k, k + 1))
    finally:
        TRACE.disable()
    spans = list(TRACE.spans)
    TRACE.clear()
    roots = [s.name for s in spans if s.parent == -1]
    assert roots == ["frame", "packet"] * 5 + ["frame"]
    children = {}
    for s in spans:
        if s.parent >= 0:
            children.setdefault(spans[s.parent].name, set()).add(s.name)
    assert "event_keyframe" in children["frame"]
    assert children["packet"] == {"packet.upload", "packet.read",
                                  "packet.adopt"}
    adopted = sum(s.name == "packet.adopt" for s in spans)
    assert adopted == pipe.telemetry.counters["event_solves"] >= 1
    assert sum(s.name == "packet.read" for s in spans) == \
        pipe.telemetry.counters["event_scalar_host_reads"]
