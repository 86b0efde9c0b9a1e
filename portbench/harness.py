"""The benchmark of the PyTorch and CUDA port (``slam_eds_tpu_torch``): one
run of one cell.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<config>.json``: the camera and the settings the pipeline is
built with) and a traffic mix (``traffic/<traffic>.json``: the sequences'
shape, whether events follow each frame, the pool's size, the check's
draw and the traced stretch). Every metric is a reader of its own,
``metrics/<name>.py``, with ``read(rec)`` over the run's records; a reader
that finds nothing to read returns None and the metric is left out. So a
cell, a configuration, a mix or a metric is added by adding files and
entries.

A run: set-up (the port imported, its kernel libraries built or loaded,
the pool of sequences rendered on the card from ``--seed``, one warm-up
pass over the pool that captures the cell's programs), then the window:
sequence after sequence of the pool, each through a fresh pipeline, every
frame (and, with events, the packet up to the next frame) handed to the
public entry point as soon as the call before it returned, each call
timed on the host clock to its ``torch.cuda.synchronize()``; then the
check (``checks``) and the result line.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from . import checks
from . import generator as gen
from . import reference as ref
from .taps import Taps, check_layout
from .tracing import Stretch, counted_syncs

HERE = Path(__file__).resolve().parent
PORT = "slam_eds_tpu_torch"
# top-level module names that must not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "slam_eds_tpu")
# the port's hand-written kernels, by the name of their device function
KERNELS = ("pattern_sample_kernel", "raster_cluster_kernel",
           "small_solve_kernel", "set_condition", "pass_tail")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve_cell(bench: dict, name: str, root: Path,
                 bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` with its configuration, traffic and metrics, each
    found by name; raises where a file is missing."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(bench_dir / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    per_layer = [m for m in bench["per_layer"] if _applies(m, name)]
    for m in e2e + per_layer:
        reader_path(m["name"], bench_dir)
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer)


def reader_path(metric: str, bench_dir: Path = HERE) -> Path:
    path = bench_dir / "metrics" / f"{metric}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path}")
    return path


def load_reader(metric: str, bench_dir: Path = HERE):
    """``read(rec)`` of ``metrics/<metric>.py``."""
    path = reader_path(metric, bench_dir)
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({k.split(".")[0] for k in list(sys.modules)
                   if k.split(".")[0] in FORBIDDEN})


def process_age_s() -> float | None:
    """Seconds since this process started (Linux ``/proc``)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


# ---------------------------------------------------------------------------
# the pool of sequences
# ---------------------------------------------------------------------------

@dataclass
class SeqData:
    seed: int
    frames: list       # [(time, image [H, W] on the device)]
    packets: list      # [Packet] (host arrays, as the entry point takes)
    gt: np.ndarray     # [N, 3] camera positions


def camera(config: dict) -> gen.Camera:
    c = config["camera"]
    return gen.Camera(float(c["fx"]), float(c["fy"]), float(c["cx"]),
                      float(c["cy"]), int(c["width"]), int(c["height"]))


def sequence_seeds(traffic: dict, seed: int):
    """The pool's sequences: the mix's fixed set (``sequences``, the
    generator's seeds), in an order drawn from ``seed``. Every run does the
    same work; the seed orders it (and draws the check's steps)."""
    fixed = [int(s) for s in traffic["sequences"]]
    order = np.random.default_rng(seed).permutation(len(fixed))
    return [fixed[i] for i in order]


def make_pool(traffic: dict, cam: gen.Camera, seed: int, device):
    events = traffic["events"]
    pool = []
    for s in sequence_seeds(traffic, seed):
        seq = gen.Sequence(cam, traffic["frames_per_sequence"],
                           traffic.get("events_per_packet", 1), seed=s,
                           contrast_threshold=traffic["contrast_threshold"],
                           micro_steps=traffic["micro_steps"],
                           motion_scale=traffic["motion_scale"],
                           device=device)
        n = seq.num_frames
        frames = [seq.frame(k) for k in range(n)]
        packets = ([seq.events_between(k, k + 1) for k in range(n - 1)]
                   if events else [])
        pool.append(SeqData(s, frames, packets, seq.gt_positions()))
    return pool


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------

class Port:
    """The system under test: the port's pipelines, configuration and
    captured-program cache, imported at set-up."""

    def __init__(self):
        from slam_eds_tpu_torch import graphs
        from slam_eds_tpu_torch.config import load_config
        from slam_eds_tpu_torch.models.ba_state import BAState
        from slam_eds_tpu_torch.models.keyframe import KeyFrame
        from slam_eds_tpu_torch.models.pipeline import (EDSPipeline,
                                                        FrameOnlyPipeline)
        from slam_eds_tpu_torch.models.window import WindowManager
        from slam_eds_tpu_torch.ops.coarse_tracker import TrackResult
        from slam_eds_tpu_torch.ops.energy import Linearization
        from slam_eds_tpu_torch.ops.event_tracker import TrackerState
        from slam_eds_tpu_torch.utils.cameras import Pinhole
        self.graphs = graphs
        self.load_config = load_config
        self.EDSPipeline = EDSPipeline
        self.FrameOnlyPipeline = FrameOnlyPipeline
        self.WindowManager = WindowManager
        self.Pinhole = Pinhole
        check_layout({"WindowManager": WindowManager, "BAState": BAState,
                      "KeyFrame": KeyFrame, "TrackResult": TrackResult,
                      "Linearization": Linearization,
                      "TrackerState": TrackerState})

    def build_libraries(self):
        """Build (first run in a checkout) or load the port's kernel
        libraries, all at once; returns the seconds the builds took."""
        from slam_eds_tpu_torch.ops.kernels import lu_solve, pattern_sample
        from slam_eds_tpu_torch.ops.kernels import rasterize
        with ThreadPoolExecutor(4) as ex:
            jobs = [ex.submit(f) for f in (pattern_sample.load,
                                           rasterize.load, lu_solve.load,
                                           self.graphs._cond_lib)]
            return sum(getattr(j.result(), "build_seconds", 0.0)
                       for j in jobs)


class Window:
    """Runs sequences through fresh pipelines and keeps each call's host
    latency and what it did."""

    def __init__(self, port: Port, config: dict, traffic: dict, device,
                 taps: Taps, sync=lambda: None):
        self.port = port
        self.cam = camera(config)
        self.pinhole = port.Pinhole(*self.cam)
        self.cfg = port.load_config(config["settings"])
        self.events = bool(traffic["events"])
        ev, tr = self.cfg.event_frame, self.cfg.tracker
        # the packet step's options that the reference follows
        self.packet_options = {"interpolation": ev.interpolation,
                               "refinement": tr.track_refinement,
                               "time_weighted": ev.time_weighted,
                               "blur_ksize": ev.gaussian_blur_ksize}
        self.device = device
        self.taps = taps
        self.sync = sync
        self.frames, self.packets, self.constructs = [], [], []
        self.counters = {}
        self.trajectories = []
        self.count_syncs = False
        self.stretch = None
        self.labels = {}

    def _new(self):
        if self.events:
            return self.port.EDSPipeline(self.pinhole, self.cfg,
                                         device=self.device)
        return self.port.FrameOnlyPipeline(self.pinhole, self.cfg,
                                           device=self.device)

    def _frame_pipe(self, pipe):
        return pipe.frame_pipe if self.events else pipe

    def _timed(self, fn, count=False):
        t0 = time.perf_counter()
        if count and self.count_syncs and self.stretch is None:
            out, syncs = counted_syncs(fn)
        else:
            out, syncs = fn(), None
        self.sync()
        return out, time.perf_counter() - t0, syncs

    def _span(self, name):
        if self.stretch is None or self.stretch.prof is None:
            return contextlib.nullcontext()
        return self.stretch.span(name)

    def _collect(self, pipe):
        fp = self._frame_pipe(pipe)
        for tel in ([fp.telemetry.counters, pipe.telemetry.counters]
                    if self.events else [fp.telemetry.counters]):
            for k, v in dict(tel).items():
                if isinstance(v, (int, float)):
                    self.counters[k] = self.counters.get(k, 0) + v

    def run(self, pool, deadline=None, sequences=None, on_frame=None):
        """Sequences of ``pool`` in turn until ``deadline`` (a
        ``perf_counter`` time, checked after every call) or until
        ``sequences`` have run. ``on_frame(window, seq_index, k)`` is
        called before each frame."""
        i = 0
        while True:
            if sequences is not None and i >= sequences:
                return
            si = i % len(pool)
            seq = pool[si]
            n_c = len(self.constructs)
            with self._span(f"construct.{n_c}"):
                pipe, dt, _ = self._timed(self._new)
            self.constructs.append(dt)
            fp = self._frame_pipe(pipe)
            done = False
            for k, (t, img) in enumerate(seq.frames):
                if on_frame is not None:
                    on_frame(self, si, k)
                c = fp.telemetry.counters
                before = (c.get("track_lost", 0), c.get("full_resets", 0))
                win = fp.window
                ids = win.next_id
                self.taps.ctx = {"seq": si, "frame": k}
                n_f = len(self.frames)
                with self._span(f"frame.{n_f}"):
                    _, dt, syncs = self._timed(
                        lambda: pipe.process_frame(img, t), count=True)
                self.taps.discard_failed_tracks(self.taps.ctx)
                # a keyframe was inserted: the window's keyframe counter
                # moved (or a window put in place of the old one has one)
                kf = (fp.window.next_id != ids if fp.window is win
                      else fp.window.next_id > 0)
                self.labels[f"frame.{n_f}"] = ("keyframe_frame" if kf
                                               else "tracking_frame")
                # lost: the tracker kept the last pose (or reset); failed:
                # the pose the call recorded is not a number
                self.frames.append({
                    "ms": dt * 1e3, "kf": kf, "syncs": syncs, "k": k,
                    "lost": (c.get("track_lost", 0), c.get(
                        "full_resets", 0)) != before,
                    "failed": bool(fp.trajectory) and not bool(
                        np.isfinite(fp.trajectory[-1]).all())})
                if deadline is not None and time.perf_counter() >= deadline:
                    done = True
                    break
                if self.events and k + 1 < len(seq.frames):
                    pk = seq.packets[k]
                    self.taps.ctx = {"seq": si, "packet": k}
                    live = pipe.kf is not None
                    pending = self.taps.packet_before(pipe)
                    n_p = len(self.packets)
                    with self._span(f"packet.{n_p}"):
                        pose, dt, _ = self._timed(
                            lambda: pipe.process_events(pk))
                    self.taps.packet_after(pending, pipe, pose,
                                           self.packet_options)
                    # rejected: the gate turned the solve down (no pose,
                    # by design); failed: an accepted pose is not a number
                    accepted = pose is not None
                    self.packets.append({
                        "ms": dt * 1e3, "rejected": live and not accepted,
                        "failed": accepted and not bool(
                            np.isfinite(pipe.event_poses[-1]).all())})
                    if deadline is not None and \
                            time.perf_counter() >= deadline:
                        done = True
                        break
            self._collect(pipe)
            self.trajectories.append((si, list(fp.times),
                                      [p.copy() for p in fp.trajectory]))
            del pipe, fp
            i += 1
            if done:
                return


def ate(est: np.ndarray, gt: np.ndarray) -> float:
    """Sim(3)-aligned (Umeyama) RMSE of positions est against gt [N, 3]."""
    mu_e, mu_g = est.mean(0), gt.mean(0)
    e, g = est - mu_e, gt - mu_g
    U, D, Vt = np.linalg.svd(g.T @ e / len(est))
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var = (e * e).sum() / len(est)
    s = np.trace(np.diag(D) @ S) / var if var > 0 else 1.0
    aligned = s * e @ R.T + mu_g
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def percentile(values, q: float):
    """The q-th percentile (linear between order statistics)."""
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def load_limits():
    with open(HERE / "limits.json") as f:
        return json.load(f)


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------

def run(cell: Cell, seed: int, seconds: float, trace: bool, device="cuda",
        control: bool = False, log=None):
    """One run of ``cell``. Returns the result dict (the last line's
    object). ``device`` is "cuda" in every benchmark run; the tests pass
    "cpu" at a small size. With ``control`` the control (the reference in
    TF32) stands in the program's place for the check: ``correct`` and
    ``checks`` are its verdict and readings, the program's are kept under
    ``program_correct`` and ``program_checks``."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    clock0 = time.perf_counter()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    setup = {}

    t = time.perf_counter()
    port = Port()
    setup["import_s"] = time.perf_counter() - t
    t = time.perf_counter()
    setup["build_s"] = port.build_libraries() if cuda else 0.0
    setup["load_s"] = time.perf_counter() - t

    cam = camera(cell.config)
    t = time.perf_counter()
    pool = make_pool(cell.traffic, cam, seed, device)
    sync()
    setup["pool_s"] = time.perf_counter() - t

    taps = Taps(port.WindowManager, seed, cell.traffic["check"])
    taps.install()
    try:
        window = Window(port, cell.config, cell.traffic, device, taps, sync)
        cache = port.graphs.CACHE
        t = time.perf_counter()
        capture0 = cache.capture_s
        # warm-up: every sequence of the pool through the cell's pipeline,
        # so that the window (which replays the pool) captures nothing
        window.run(pool, sequences=len(pool))
        sync()
        setup["warmup_s"] = time.perf_counter() - t
        setup["warmup_capture_s"] = cache.capture_s - capture0
        programs0 = len(cache.programs)
        capture_in = cache.capture_s

        measured = Window(port, cell.config, cell.traffic, device, taps,
                          sync)
        measured.count_syncs = trace and cuda
        stretch = (Stretch(port.graphs.launch_ledger) if trace and cuda
                   else None)
        prof_cfg = cell.traffic["profile"]
        state = {"on": False, "done": False}

        def on_frame(w, si, k):
            # the profiled stretch: from the first sequence's
            # ``start_frame``, at least ``min_frames`` frames and one
            # keyframe frame, at most ``max_frames``
            if stretch is None or state["done"]:
                return
            if not state["on"] and k == prof_cfg["start_frame"]:
                measured.stretch = stretch
                stretch.start()
                state["on"] = True
                state["first"] = len(w.frames)
                return
            if state["on"]:
                made = w.frames[state["first"]:]
                kf = any(f["kf"] for f in made)
                if (len(made) >= prof_cfg["min_frames"] and kf) or \
                        len(made) >= prof_cfg["max_frames"]:
                    stretch.stop(w.labels)
                    measured.stretch = None
                    state.update(on=False, done=True)

        ledger0 = port.graphs.launch_ledger() if trace and cuda else None
        taps.active = True
        age = process_age_s()
        setup_s = age if age is not None else time.perf_counter() - clock0
        t_start = time.perf_counter()
        measured.run(pool, deadline=t_start + seconds, on_frame=on_frame)
        t_end = time.perf_counter()
        taps.active = False
        if stretch is not None and state["on"]:
            stretch.stop(measured.labels)
            measured.stretch = None
        ledger = (port.graphs.ledger_delta(ledger0,
                                           port.graphs.launch_ledger())
                  if ledger0 is not None else None)
        memory_peak = (int(torch.cuda.max_memory_allocated())
                       if cuda else 0)
        setup["captures_in_window"] = len(cache.programs) - programs0
        setup["capture_s_in_window"] = cache.capture_s - capture_in
    finally:
        taps.uninstall()
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"forbidden modules loaded: {found}")
    window_s = t_end - t_start

    # the check, with the program's state freed
    limits = load_limits()
    t = time.perf_counter()
    readings, counts, info = checks.readings(taps.records, pool, cam,
                                             window.events)
    info["check_s"] = time.perf_counter() - t
    ates = []
    for si, times, traj in measured.trajectories:
        n = len(pool[si].frames)
        idx = [int(round(t * (n - 1))) for t in times[:len(traj)]]
        if len(idx) >= 8:
            ates.append(ate(np.stack(traj[:len(idx)]), pool[si].gt[idx]))
    correct, check_lines = checks.verdict(readings, limits)
    for name, line in check_lines.items():
        line["steps"] = counts[name]
    program = None
    if control:
        program = (correct, check_lines)
        ctl, ctl_counts, ctl_info = checks.readings(
            taps.records, pool, cam, window.events, ref.CONTROL)
        log(json.dumps({"control_info": ctl_info}))
        correct, check_lines = checks.verdict(ctl, limits)
        for name, line in check_lines.items():
            line["steps"] = ctl_counts[name]

    # the records the readers take
    rec = {
        "window_s": window_s, "setup_s": setup_s, "setup": setup,
        "frames": measured.frames, "packets": measured.packets,
        "constructs": measured.constructs, "counters": measured.counters,
        "ledger": ledger, "camera": cam,
        "events_per_packet": cell.traffic.get("events_per_packet"),
        "stretch": stretch,
    }
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    frames_failed = sum(f["failed"] for f in measured.frames)
    packets_failed = sum(p["failed"] for p in measured.packets)
    result = {
        "correct": correct,
        "attempted": len(measured.frames) + len(measured.packets),
        "failed": frames_failed + packets_failed,
        "metrics": metrics,
        "device": device_info(cell.chips, memory_peak, cuda),
    }
    if stretch is not None:
        log(json.dumps({"stretch": {"window_s": stretch.window_s,
                                    "busy_s": stretch.busy_s,
                                    "spans": len(stretch.spans),
                                    "spans_on_trace": stretch.spans_laid,
                                    "launches_run": stretch.ledger_runs,
                                    "launches_traced": {
                                        k: len(stretch.kernel_times(k))
                                        for k in KERNELS}}}))
        result["device"]["busy_s"] = stretch.busy_s
        result["device"]["window_s"] = stretch.window_s
        result["breakdown"] = {"device_ops": stretch.device_ops,
                               "idle_gaps": stretch.idle_gaps}
    frame_ms = [f["ms"] for f in measured.frames]
    packet_ms = [p["ms"] for p in measured.packets]
    f95, p95 = percentile(frame_ms, 95), percentile(packet_ms, 95)
    log(json.dumps({
        "setup": setup, "setup_s": setup_s, "window_s": window_s,
        "card": power_limit() if cuda else None,
        "frames": len(measured.frames), "packets": len(measured.packets),
        "sequences": len(measured.constructs),
        "keyframe_frames": sum(f["kf"] for f in measured.frames),
        "frames_failed": frames_failed, "packets_failed": packets_failed,
        "frames_lost": sum(f["lost"] for f in measured.frames),
        "packets_rejected": sum(p["rejected"] for p in measured.packets),
        "frames_beyond_p95": sum(x > f95 for x in frame_ms),
        "beyond_p95_kinds": {
            "bootstrap": sum(f["ms"] > f95 and f["k"] < 2
                             for f in measured.frames),
            "keyframe": sum(f["ms"] > f95 and f["kf"] and f["k"] >= 2
                            for f in measured.frames),
            "lost": sum(f["ms"] > f95 and f["lost"]
                        for f in measured.frames),
            "tracking": sum(f["ms"] > f95 and not f["kf"]
                            and not f["lost"] for f in measured.frames)},
        "packets_beyond_p95": sum(x > p95 for x in packet_ms),
        "ate_per_sequence": ates, "check_info": info,
        "draws": taps.calls}))
    if program is not None:
        result["program_correct"], result["program_checks"] = program
        log(json.dumps({"program": program[1],
                        "program_correct": program[0]}))
    # the numbers compared, each beside its limit: last
    who = "control" if control else "check"
    for name, line in check_lines.items():
        log(f"{who} {name}: {line['value']} (limit {line['limit']}, "
            f"{line['steps']} steps)")
    result["checks"] = check_lines
    return result


def power_limit() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` reads them (the
    published peaks assume 700 W)."""
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def device_info(chips: int, memory_peak: int, cuda: bool) -> dict:
    return {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": chips, "memory_peak_bytes": memory_peak}
