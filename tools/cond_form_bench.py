#!/usr/bin/env python3
"""Chained against flat IF nodes in the captured loops, on one card.

``graphs.while_loop`` puts every pass's IF node in the loop's own graph,
one after the other (flat: every pass after the stop still runs its
condition kernel and its node). The other form captures pass ``i + 1`` as
an IF node inside pass ``i``'s body (chained: the first false condition
ends the loop, one skipped node). This script runs the frame cell (640x480,
``SyntheticSequence`` seed 7, motion_scale 0.22, micro_steps 2, default
``EDSConfig``) for ``--frames`` frames, then, at the final window state,
captures the frame track (``track_frame_program``) and the window BA
(``ba_program``, ``opt_break_tol``) in each form into fresh caches, and
the same for the event cell's packet step (``gate_ladder``, 65,536-event
packets, the last packet's inputs), in the order chained, flat, flat,
chained, and times their replays with CUDA events (with ``--profile``
also their device busy time and top kernels under the profiler). Prints
one JSON line: ms per replay and capture seconds of each form, the card's
name and power limit.

    python3 tools/cond_form_bench.py [--frames 16] [--reps 30]
"""
import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from slam_eds_tpu_torch import graphs  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402


def chained_while_loop(cond_fn, body_fn, carry, n):
    """``graphs.while_loop`` with each pass's IF node nested in the body of
    the pass before."""
    if n <= 0 or not graphs.capturing(tree_leaves(carry)[0]):
        for i in range(n):
            carry = body_fn(i, carry)
        return carry
    carry = graphs._buffers(carry)
    with contextlib.ExitStack() as nest:
        for i in range(n):
            nest.enter_context(graphs._if_body(cond_fn(carry)))
            graphs._write(carry, body_fn(i, carry))
    return carry


def time_form(form, programs, reps, profiled=True):
    """(ms per replay, capture s, device busy ms per replay and its top
    kernels) of each program in ``form``."""
    from torch.profiler import ProfilerActivity, profile
    flat = graphs.while_loop
    graphs.while_loop = {"chained": chained_while_loop, "flat": flat}[form]
    out = {}
    try:
        for name, (fn, x) in programs.items():
            cache = graphs.GraphCache()
            cache.run((name, form), fn, x)
            ms = cs.cuda_time_ms(lambda: cache.run((name, form), fn, x),
                                 reps)
            out[name] = {"ms": ms, "capture_s": cache.capture_s}
            if not profiled:
                continue
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    cache.run((name, form), fn, x)
                torch.cuda.synchronize()
            ka = sorted(prof.key_averages(),
                        key=lambda e: -e.self_device_time_total)
            out[name]["device_busy_ms"] = sum(
                e.self_device_time_total for e in ka) / 5e3
            out[name]["top_kernels"] = [
                (e.key[:60], e.count // 5,
                 round(e.self_device_time_total / 5e3, 4)) for e in ka[:6]]
    finally:
        graphs.while_loop = flat
    return out


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--forms", default="chained,flat,flat,chained")
    ap.add_argument("--programs", default="track_frame,window_ba,packet")
    ap.add_argument("--profile", action="store_true",
                    help="also profile 5 replays of each (device busy ms, "
                    "top kernels)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("cond_form_bench: needs a CUDA card")
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.device import set_numerics
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.models.pipeline import (EDSPipeline,
                                                    FrameOnlyPipeline,
                                                    gate_ladder)
    from slam_eds_tpu_torch.models.window import (ba_program,
                                                  track_frame_program)
    set_numerics()
    dev = torch.device("cuda:0")
    cam = cs.smoke_camera()
    seq = SyntheticSequence(cam, num_frames=args.frames, motion_scale=0.22,
                            micro_steps=2, device=dev)
    pipe = FrameOnlyPipeline(cam, EDSConfig(), device=dev)
    t0 = time.perf_counter()
    for k in range(args.frames):
        t, img = seq.frame(k)[:2]
        pipe.process_frame(img, t)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    win = pipe.window
    x, static = win.track_inputs(img, pipe._last_pose)
    xb, kw = win.ba_inputs()
    cam_e, _, frames, packets = cs.eds_inputs(dev)
    eds = EDSPipeline(cam_e, cs.eds_config(), device=dev)
    for k in range(args.frames):
        eds.process_frame(frames[k][1], frames[k][0])
        if eds.kf is not None and k + 1 < args.frames:
            eds.process_events(packets[k])
    lim, iters, statics = eds._packet_step_args()
    xp = eds.packet_inputs(packets[args.frames - 1])
    programs = {
        "track_frame": (lambda x: track_frame_program(x, **static), x),
        "window_ba": (lambda x: ba_program(x, **kw), xb),
        "packet": (lambda x: gate_ladder(x, cam_e, iters, lim, statics),
                   xp)}
    runs = []
    programs = {k: v for k, v in programs.items()
                if k in args.programs.split(",")}
    forms = args.forms.split(",")
    for form in forms:
        runs.append({"form": form, **time_form(form, programs, args.reps,
                                               args.profile)})
    summary = {}
    for form in sorted(set(forms)):
        for name in programs:
            v = [r[name]["ms"] for r in runs if r["form"] == form]
            summary[f"{name}_{form}_ms"] = float(np.mean(v))
    print(json.dumps({"bench": "cond_form", "frames": args.frames,
                      "frame_cell_s": run_s, "runs": runs, **summary,
                      "card": cs.gpu_name_and_power_limit()}))


if __name__ == "__main__":
    main()
