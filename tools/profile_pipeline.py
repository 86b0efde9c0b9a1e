#!/usr/bin/env python3
"""Where the time goes on the GPU: per-stage host time of the port's frame
path and ``torch.profiler`` device sums of a BA call and of steady pipeline
frames, on the operating points of ``chip_smoke.py`` (BA world: F=8,
P=2048, 640x480; pipeline: the smoke's 640x480 ``SyntheticSequence`` with
the default ``EDSConfig``).

Without arguments, three runs of the frame path, one JSON line each (plus
the card's name and power limit):

* ``ba_3_calls``      -- three 6-iteration ``ba_iterate`` calls under the
                         profiler (CUDA activity): wall, device busy time,
                         device idle share, event count, top device items;
* ``stages``          -- one pipeline run (``capture=False``: the eager
                         functions, where a captured replay has no stages
                         to time) with ``torch.cuda.synchronize()``
                         around every ``WindowManager`` stage: seconds and
                         calls per stage, every frame's wall time, counters;
* ``pipeline_steady`` -- a second pipeline run, 8 frames after the smoke's
                         warm-up frames under the profiler (CUDA activity
                         only; recording CPU ops as well takes far longer).

With ``--eds``, two runs of the event path (``EDSPipeline`` on phase 8's
32-frame sequence of ``chip_smoke.py``, 65,536-event packets):

* ``eds_stages``  -- every packet step (``capture=False``, as above)
                     with ``torch.cuda.synchronize()``
                     around each stage: raster (``scatter_accumulate``),
                     blur and levels (the rest of ``build_event_frame``),
                     the LM per pyramid level (first solve), the retry
                     solves of the gate's ladder, the track refinement
                     (``--refinement klt|klt_pyr|model_klt|epiline``; its
                     splats included), the depth filter, and the rest of
                     the step; mean ms per steady packet (after the
                     smoke's warm-up frames) and host reads per packet;
* ``eds_steady``  -- 8 steady packets, each under the profiler (CUDA
                     activity): wall, device busy time and idle share, top
                     device items.

Needs a CUDA device; imports no JAX.

    python3 tools/profile_pipeline.py [--eds [--refinement MODE]]
        [--out profile.json]
"""
import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from slam_eds_tpu_torch.config import EDSConfig  # noqa: E402
from slam_eds_tpu_torch.device import set_numerics  # noqa: E402
from slam_eds_tpu_torch.io.dataset import SyntheticSequence  # noqa: E402
from slam_eds_tpu_torch.models import window as wmod  # noqa: E402
from slam_eds_tpu_torch.models.pipeline import (  # noqa: E402
    EDSPipeline, FrameOnlyPipeline)
from slam_eds_tpu_torch.ops import depth_filter as dfmod  # noqa: E402
from slam_eds_tpu_torch.ops import energy  # noqa: E402
from slam_eds_tpu_torch.ops import event_tracker as etmod  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import rasterize as rz  # noqa: E402
from slam_eds_tpu_torch.utils import events as evmod  # noqa: E402
from slam_eds_tpu_torch.ops.kernels import pattern_sample as ps  # noqa: E402
from slam_eds_tpu_torch.utils.cameras import Pinhole  # noqa: E402

STAGES = ("track_frame", "insert_frame", "trace_all", "activate_points",
          "optimize", "flag_and_marginalize", "rebuild_coarse_template")
STEADY_FRAMES = 8


def summarize(prof, wall_s, top=12):
    ev = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in ev)
    rows = sorted(ev, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_s": wall_s, "device_busy_s": dev_us / 1e6,
            "device_idle_share": 1 - dev_us / 1e6 / wall_s,
            "device_events": sum(e.count for e in ev),
            "top_device_items": [(e.key[:70], e.count,
                                  e.self_device_time_total) for e in rows]}


def profile_ba(dev):
    st, imgs, H, W = cs.build_ba_problem(dev)
    for _ in range(2):
        energy.ba_iterate(st, imgs, H, W, iterations=6, final_linearize=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for _ in range(3):
            energy.ba_iterate(st, imgs, H, W, iterations=6,
                              final_linearize=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return summarize(p, wall)


def profile_stages(cam, frames, dev):
    stage_s, stage_n = defaultdict(float), defaultdict(int)
    orig = {n: getattr(wmod.WindowManager, n) for n in STAGES}

    def timed(name, fn):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            stage_s[name] += time.perf_counter() - t0
            stage_n[name] += 1
            return r
        return wrapper

    for n in STAGES:
        setattr(wmod.WindowManager, n, timed(n, orig[n]))
    try:
        # eagerly: a captured program's replay runs no Python to time
        pipe = FrameOnlyPipeline(cam, EDSConfig(), device=dev, capture=False)
        walls = []
        for t, img in frames:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pipe.process_frame(img, t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    finally:
        for n in STAGES:
            setattr(wmod.WindowManager, n, orig[n])
    return {"stages": {n: {"s": stage_s[n], "calls": stage_n[n]}
                       for n in STAGES},
            "frame_walls_s": walls, "frame_walls_sum_s": sum(walls),
            "counters": dict(pipe.telemetry.counters)}


def profile_steady(cam, frames, dev):
    pipe = FrameOnlyPipeline(cam, EDSConfig(), device=dev)
    for t, img in frames[:cs.PIPE_WARMUP]:
        pipe.process_frame(img, t)
    torch.cuda.synchronize()
    steady = frames[cs.PIPE_WARMUP:cs.PIPE_WARMUP + STEADY_FRAMES]
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        for t, img in steady:
            pipe.process_frame(img, t)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    out = summarize(p, wall)
    out["frames"] = len(steady)
    out["first_frame"] = cs.PIPE_WARMUP
    return out


class _StageClock:
    """Synchronized wall time per named stage of the current packet."""

    def __init__(self):
        self.now = defaultdict(float)

    def wrap(self, name, fn, name_of=None):
        def wrapper(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = fn(*a, **k)
            torch.cuda.synchronize()
            self.now[name_of(a) if name_of else name] += \
                time.perf_counter() - t0
            return r
        return wrapper


def _run_eds(pipe, frames, packets, on_packet=None):
    """Feed every frame, then its packet while the pipeline has a keyframe
    (bench.py's bench_e2e loop); ``on_packet(k, step)`` wraps each packet."""
    for k, (t, img) in enumerate(frames):
        pipe.process_frame(img, t)
        if k + 1 < len(frames) and pipe.kf is not None:
            def step(k=k):
                return pipe.process_events(packets[k])
            on_packet(k, step) if on_packet else step()
    torch.cuda.synchronize()


def profile_eds_stages(cam, frames, packets, dev, cfg):
    clock = _StageClock()
    n_levels = cfg.event_frame.num_levels
    solves = []         # _pyramid_fused calls in the current packet

    def lm_level(args):
        # _pyramid_fused runs the levels coarse to fine: the i-th _lm_solve
        # call of a solve is level n_levels - 1 - i
        return f"lm_level_{n_levels - 1 - (solves[-1] % n_levels)}"

    orig_lm, orig_pyr = etmod._lm_solve, etmod._pyramid_fused
    timed_lm = clock.wrap(None, orig_lm, lm_level)

    def counted_lm(*a, **k):
        r = timed_lm(*a, **k)
        solves[-1] += 1
        return r

    def pyramid(*a, **k):
        if solves and solves[-1] >= n_levels:
            # a retry of the gate's ladder: its levels go to "retries"
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            etmod._lm_solve = orig_lm
            try:
                r = orig_pyr(*a, **k)
            finally:
                etmod._lm_solve = counted_lm
            torch.cuda.synchronize()
            clock.now["retries"] += time.perf_counter() - t0
            return r
        return orig_pyr(*a, **k)

    patches = [(evmod, "scatter_accumulate",
                clock.wrap("raster", evmod.scatter_accumulate)),
               (evmod, "build_event_frame",
                clock.wrap("event_frame", evmod.build_event_frame)),
               (etmod, "_lm_solve", counted_lm),
               (etmod, "_pyramid_fused", pyramid),
               (dfmod, "update", clock.wrap("depth_filter", dfmod.update))]
    patches += [(etmod, n, clock.wrap("refinement", getattr(etmod, n)))
                for n in ("refine_tracks_klt", "refine_tracks_model_klt",
                          "refine_tracks_epiline")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    per_packet = []

    def on_packet(k, step):
        clock.now.clear()
        solves.clear()
        solves.append(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        total = time.perf_counter() - t0
        st = dict(clock.now)
        st["blur_and_levels"] = st.pop("event_frame", 0.0) - st.get(
            "raster", 0.0)
        st["other"] = total - sum(st.values())
        st["total"] = total
        per_packet.append((k, st))

    for m, n, fn in patches:
        setattr(m, n, fn)
    try:
        # eagerly: a captured program's replay runs no Python to time
        pipe = EDSPipeline(cam, cfg, device=dev, capture=False)
        _run_eds(pipe, frames, packets, on_packet)
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    steady = [st for k, st in per_packet if k >= cs.PIPE_WARMUP]
    names = sorted({n for st in steady for n in st})
    c = pipe.telemetry.counters
    n_pk = max(c["event_packets"], 1)
    return {"packets": len(steady), "first_packet": cs.PIPE_WARMUP,
            "ms_per_packet": {n: 1e3 * sum(st.get(n, 0.0) for st in steady)
                              / max(len(steady), 1) for n in names},
            "host_reads_per_packet": {
                k: c[f"event_{k}_host_reads"] / n_pk
                for k in ("lm", "scalar")},
            "event_counters": dict(c)}


def profile_eds_steady(cam, frames, packets, dev, cfg):
    pipe = EDSPipeline(cam, cfg, device=dev)
    busy, wall, items, n = 0.0, 0.0, defaultdict(float), 0

    def on_packet(k, step):
        nonlocal busy, wall, n
        if k < cs.PIPE_WARMUP or n >= STEADY_FRAMES:
            step()
            return
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as p:
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
        for e in p.key_averages():
            busy += e.self_device_time_total / 1e6
            items[e.key[:70]] += e.self_device_time_total
        n += 1

    _run_eds(pipe, frames, packets, on_packet)
    top = sorted(items.items(), key=lambda kv: -kv[1])[:12]
    return {"packets": n, "wall_s": wall, "device_busy_s": busy,
            "device_idle_share": 1 - busy / wall if wall else None,
            "top_device_items_us": top}


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--eds", action="store_true",
                    help="profile the event path instead of the frame path")
    ap.add_argument("--refinement", default="none",
                    choices=("none", "klt", "klt_pyr", "model_klt", "epiline"),
                    help="tracker.track_refinement of the --eds runs")
    ap.add_argument("--out", help="also write every result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("profile_pipeline: needs a CUDA device")
    dev = torch.device("cuda:0")
    set_numerics()
    ps.load()
    rz.load()
    out = {"gpu": cs.gpu_name_and_power_limit()}
    print(json.dumps({"gpu": out["gpu"]}), flush=True)

    if args.eds:
        cam, _, frames, packets = cs.eds_inputs(dev)
        cfg = cs.tracker_config(track_refinement=args.refinement)
        runs = (("eds_stages",
                 lambda: profile_eds_stages(cam, frames, packets, dev, cfg)),
                ("eds_steady",
                 lambda: profile_eds_steady(cam, frames, packets, dev, cfg)))
    else:
        cam = Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
        seq = SyntheticSequence(cam, num_frames=cs.PIPE_FRAMES,
                                motion_scale=0.22, micro_steps=2, device=dev)
        frames = [seq.frame(k)[:2] for k in range(cs.PIPE_FRAMES)]
        runs = (("ba_3_calls", lambda: profile_ba(dev)),
                ("stages", lambda: profile_stages(cam, frames, dev)),
                ("pipeline_steady",
                 lambda: profile_steady(cam, frames, dev)))
    for key, run in runs:
        out[key] = run()
        print(json.dumps({key: out[key]}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
