"""The harness's rules, on the CPU: names and units, cells resolved by name,
no JAX anywhere, no run without a card, each metric reader on canned
records, and a new cell added by files and entries alone."""
import ast
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness, tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def bench():
    return harness.load_benchmark(ROOT)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_names_units_and_keys(bench):
    assert set(bench) == KEYS["top"]
    assert 1 <= bench["run_seconds"] <= 51
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
        for e in bench[kind]:
            assert set(e) - {"workloads"} == KEYS[kind], e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and kind in ("configs", "workloads", "per_layer"):
                    assert _line(e[k]), (k, e[k])
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    assert all(_line(w) for w in bench["command"])
    assert len(json.dumps(bench)) <= 64 * 1024


def test_every_cell_resolves(bench):
    for w in bench["workloads"]:
        cell = harness.resolve_cell(bench, w["name"], ROOT)
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                        "frames_per_s"}
        assert cell.per_layer
        for m in cell.end_to_end + cell.per_layer:
            assert callable(harness.load_reader(m["name"]))


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_jax_and_a_reference_free_of_the_program():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & set(harness.FORBIDDEN), path
    # the yardstick imports nothing of the program
    for name in ("reference.py", "generator.py", "roofline.py",
                 "checks.py"):
        tops = {m.split(".")[0] for m in _imports(BENCH / name)}
        assert harness.PORT not in tops, name
    assert harness.forbidden_modules() == [] or "jax" not in sys.modules


def test_run_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "eds_640x480.frames", "--seed", "3000000019", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=ROOT,
        timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "cuda" in proc.stderr.lower()


class _Stretch:
    window_s, busy_s = 2.0, 0.5
    ledger_runs = {"rasterize_bilinear": 1, "pattern_sample": 7}

    def kernel_times(self, sub):
        return {"pattern_sample_kernel": [1e-5, 3e-5],
                "raster_cluster_kernel": [4e-6]}.get(sub, [])


def _canned():
    from portbench.generator import Camera
    frames = [{"ms": ms, "kf": kf, "syncs": s, "lost": ms == 12,
               "failed": False}
              for ms, kf, s in [(10, False, 2), (30, True, 20),
                                (12, False, 2), (50, True, 30),
                                (14, False, 2)]]
    return {"window_s": 2.5, "setup_s": 33.0, "frames": frames,
            "packets": [{"ms": float(m), "rejected": m % 4 == 0,
                         "failed": False} for m in range(1, 21)],
            "counters": {"event_packets": 20, "event_retries": 5,
                         "event_solves": 16, "event_iters": 48},
            "ledger": {"pass_tail": {"slots": 900, "run": 250}},
            "camera": Camera(400, 400, 319.5, 239.5, 640, 480),
            "events_per_packet": 65536, "stretch": _Stretch()}


def test_readers_on_canned_records():
    rec = _canned()
    from portbench import roofline as rf
    rb = rf.bound_s(*rf.raster_launch(65536, 480, 640))
    want = {
        "frames_per_s": 2.0, "frame_ms_p95": 46.0, "packet_ms_p95": 19.05,
        "setup_s": 33.0, "host_reads_per_frame": 11.2,
        "kf_frame_ms_p50": 40.0, "track_frame_ms_p50": 12.0,
        "rungs_per_packet": 1.25, "lm_iters_per_packet": 3.0,
        "lost_frame_share": 20.0, "rejected_packet_share": 25.0,
        "loop_passes_per_frame": 50.0,
        "rasterize_roofline": 100 * rb / 4e-6}
    for name, value in want.items():
        assert harness.load_reader(name)(rec) == pytest.approx(value), name


def test_readers_find_nothing_in_an_untraced_run():
    rec = dict(_canned(), stretch=None, ledger=None, packets=[],
               counters={})
    rec["frames"] = [dict(f, syncs=None) for f in rec["frames"]]
    for name in ("packet_ms_p95", "host_reads_per_frame",
                 "rungs_per_packet", "lm_iters_per_packet",
                 "rejected_packet_share", "loop_passes_per_frame",
                 "rasterize_roofline"):
        assert harness.load_reader(name)(rec) is None, name


def test_roofline_reads_nothing_where_the_trace_missed_launches():
    """A raster launch that the ledger counted and the profiler did not
    record leaves the raster's roofline unread."""
    st = _Stretch()
    st.ledger_runs = {"rasterize_bilinear": 2}
    assert harness.load_reader("rasterize_roofline")(
        dict(_canned(), stretch=st)) is None


def test_a_changed_port_layout_stops_the_run():
    """The check's reads of the port are named in ``taps.LAYOUT``; a port
    without one of them is refused before a run, not checked against
    nothing."""
    from typing import NamedTuple

    from portbench import taps
    from slam_eds_tpu_torch.models.window import WindowManager

    class Result(NamedTuple):
        pose: int

    class Window(WindowManager):
        def run_ba(self, x, kw, extra=None):
            return super().run_ba(x, kw)
    types = {n: type(n, (), {"_fields": f})
             for n, f in taps.LAYOUT.items() if "." not in n}
    types["WindowManager"] = WindowManager
    taps.check_layout(types)
    with pytest.raises(RuntimeError, match="TrackResult.aff"):
        taps.check_layout(dict(types, TrackResult=Result))
    with pytest.raises(RuntimeError, match="run_ba"):
        taps.check_layout(dict(types, WindowManager=Window))


def test_a_new_cell_is_files_and_entries(tmp_path, bench):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    new = json.loads(json.dumps(bench))
    cfg = json.loads((BENCH / "configs" / "eds_640x480.json").read_text())
    cfg["settings"]["bundles"] = {"window_size": 5}
    (root / "portbench/configs/eds_w5_640x480.json").write_text(
        json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "frames.json").read_text())
    traffic["frames_per_sequence"] = 24
    (root / "portbench/traffic/frames24.json").write_text(
        json.dumps(traffic))
    (root / "portbench/metrics/frames_total.py").write_text(
        "def read(rec):\n    return len(rec['frames'])\n")
    new["configs"].append({"name": "eds_w5_640x480", "source": "test",
                           "file": "portbench/configs/eds_w5_640x480.json",
                           "reduced": [], "why": "test"})
    new["workloads"].append({"name": "eds_w5_640x480.frames24",
                             "config": "eds_w5_640x480",
                             "traffic": "frames24", "chips": 1,
                             "why": "test"})
    new["per_layer"].append({
        "name": "frames_total", "unit": "frames", "better": "higher",
        "source": "host_clock", "layer": "pipeline entry (models/pipeline)",
        "moves": "frames_per_s", "workloads": ["eds_w5_640x480.frames24"]})
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    cell = harness.resolve_cell(new, "eds_w5_640x480.frames24", root,
                                root / "portbench")
    assert cell.config["settings"]["bundles"] == {"window_size": 5}
    assert cell.traffic["frames_per_sequence"] == 24
    assert "frames_total" in [m["name"] for m in cell.per_layer]
    read = harness.load_reader("frames_total", root / "portbench")
    assert read(_canned()) == 5
    # the files that were there are unchanged
    for path in BENCH.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts \
                and ".cache" not in path.parts:
            assert (root / "portbench" / path.relative_to(BENCH)
                    ).read_bytes() == path.read_bytes()


def test_stretch_reads_a_chrome_trace():
    st = tracing.Stretch()
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.frame.0",
         "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "portbench.packet.0",
         "ts": 100, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "pattern_sample_kernel",
         "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "raster_cluster_kernel",
         "ts": 120, "dur": 30},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH",
         "ts": 25, "dur": 10},
    ]
    st._read(events, 0, {"frame.0": "keyframe_frame"})
    assert st.busy_s == pytest.approx(55e-6)
    assert st.kernel_times("raster") == [pytest.approx(30e-6)]
    gaps = dict(st.idle_gaps)
    assert gaps["keyframe_frame"] == pytest.approx(75e-6)
    assert gaps["packet"] == pytest.approx(70e-6)


def test_stretch_lays_host_spans_on_the_trace_base():
    st = tracing.Stretch()
    base = 1_700_000_000_000_000_000
    st.spans = [("frame.3", base + 5_000, base + 105_000),
                ("construct.0", base - 50_000, base - 1_000)]
    events = [{"ph": "X", "cat": "kernel", "name": "k", "ts": 0.0,
               "dur": 40.0},
              {"ph": "X", "cat": "kernel", "name": "k", "ts": 100.0,
               "dur": 20.0}]
    st._read(events, base, {"frame.3": "tracking_frame"})
    assert st.spans_laid == 1
    assert dict(st.idle_gaps) == {"tracking_frame": pytest.approx(60e-6)}
