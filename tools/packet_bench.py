#!/usr/bin/env python3
"""The event cell's packet step, or the frame cell's frame step, of one
tree of the port, on one card.

``--cell event`` (the default) runs ``EDSPipeline`` over the event cell
(640x480, ``SyntheticSequence`` seed 7, motion_scale 0.22, micro_steps 2,
65,536-event packets, default config) for ``--frames`` frames with the
package imported from ``--tree`` (a checkout of this repository, the
current one by default), timing every ``process_events`` and
``process_frame`` call on the host; then runs a second pipeline over the
same frames in the same process, its programs all captured already, with
every ``process_events`` call under ``torch.profiler`` (a session of its
own): its device busy time. ``--cell frame`` does the same with
``FrameOnlyPipeline`` over the frame cell and profiles every
``process_frame`` call. Both runs go through the public API (the first
also times every ``graphs.CapturedProgram`` call), so two trees that give
the same bits run the same steps through the same branches. Prints one
JSON line: the median wall ms of the step over steps 4 on (first run),
the median and mean device ms per step and the device idle share over the
same steps (second run: 1 - busy / wall, busy by the profiler, which may
drop the records of kernels in WHILE bodies), the median and mean device
ms of the step's graph replays (CUDA events around each
``CapturedProgram`` call of the first run), their share of its wall and
the steps whose replays' spans add up to more than the step's wall (a
span that cannot be device time: where this count is not 0, the replay
numbers are not to be read),
the seconds the first run spent capturing programs, usable solves (event
cell), the frame path's full resets and BA runs, and the card's name and
power limit. Compare two trees only on one card within one command, in
turns:

    python3 tools/packet_bench.py --tree <parent checkout>; \\
    python3 tools/packet_bench.py; python3 tools/packet_bench.py; \\
    python3 tools/packet_bench.py --tree <parent checkout>
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--cell", choices=("event", "frame"), default="event")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("packet_bench: needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.device import set_numerics
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch import graphs
    from slam_eds_tpu_torch.models.pipeline import EDSPipeline, \
        FrameOnlyPipeline
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    import dataclasses
    set_numerics()
    dev = torch.device("cuda:0")
    cam = Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
    frame_cell = args.cell == "frame"
    seq = SyntheticSequence(cam, num_frames=args.frames, motion_scale=0.22,
                            micro_steps=2, device=dev,
                            **({} if frame_cell
                               else {"events_per_packet": 65536}))
    cfg = EDSConfig()
    if not frame_cell:
        cfg = dataclasses.replace(
            cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
            event_frame=dataclasses.replace(cfg.event_frame,
                                            events_per_frame=65536))
    from torch.profiler import ProfilerActivity, profile

    # the device time of every graph replay, from CUDA events around it
    # (a replay's kernels run back to back, so its span is its device
    # time); counted in the first run, which no profiler slows
    spans = []
    replay = graphs.CapturedProgram.__call__

    def timed_replay(self, inputs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = replay(self, inputs)
        b.record()
        spans.append((a, b))
        return out

    def timed(profiled, fn):
        """(``fn()``, host s, device ms: the profiler's busy time where
        ``profiled``, else the step's replays' spans)."""
        torch.cuda.synchronize()
        spans.clear()
        with (profile(activities=[ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if prof is None:
            return out, wall, sum(a.elapsed_time(b) for a, b in spans)
        return out, wall, sum(e.self_device_time_total
                              for e in prof.key_averages()) / 1e3

    def run(profiled):
        """(step index, host s, device ms as ``timed`` gives it) per step
        (the packets, or the frames of the frame cell), the same per frame,
        the usable solves and the frame path's counters, of one pipeline
        over the frames."""
        pipe = (FrameOnlyPipeline if frame_cell else EDSPipeline)(
            cam, cfg, device=dev)
        out, frames, usable = [], [], 0
        for k in range(args.frames):
            t, img = seq.frame(k)[:2]
            _, wall, busy = timed(profiled and frame_cell,
                                  lambda: pipe.process_frame(img, t))
            frames.append((k, wall, busy))
            if frame_cell:
                continue
            if k + 1 < args.frames and pipe.kf is not None:
                pk = seq.events_between(k, k + 1)
                T, wall, busy = timed(profiled,
                                      lambda: pipe.process_events(pk))
                out.append((k, wall, busy))
                usable += T is not None
        counters = dict((pipe if frame_cell else pipe.frame_pipe)
                        .telemetry.counters)
        return (frames if frame_cell else out), frames, usable, counters

    with torch.inference_mode():
        graphs.CapturedProgram.__call__ = timed_replay
        walls, frames, usable, counters = run(False)
        graphs.CapturedProgram.__call__ = replay
        capture_s = graphs.CACHE.capture_s
        busy, _, usable_2, _ = run(True)
    if usable_2 != usable:
        sys.exit(f"packet_bench: the runs disagree ({usable}, {usable_2} "
                 f"usable)")
    steady = [b for k, _, b in busy if k >= 4]
    steady_wall = [w for k, w, _ in busy if k >= 4]
    replays = [b for k, _, b in walls if k >= 4]
    replay_wall = [w for k, w, _ in walls if k >= 4]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    step = "frame" if args.cell == "frame" else "packet"
    print(json.dumps({"bench": args.cell, "tree": os.path.basename(tree),
                      f"{step}_ms_median": 1e3 * float(np.median(
                          [s for k, s, _ in walls if k >= 4])),
                      "frame_ms_median": 1e3 * float(np.median(
                          [s for k, s, _ in frames if k >= 4])),
                      f"{step}_device_ms_median": float(np.median(steady)),
                      f"{step}_device_ms_mean": float(np.mean(steady)),
                      "device_idle_share": 1.0 - sum(steady)
                      / (1e3 * sum(steady_wall)),
                      f"{step}_replay_ms_median": float(np.median(replays)),
                      f"{step}_replay_ms_mean": float(np.mean(replays)),
                      "replay_share_of_wall": sum(replays)
                      / (1e3 * sum(replay_wall)),
                      "steps_replays_over_wall": sum(
                          b > 1e3 * w for b, w in zip(replays, replay_wall)),
                      "capture_s": capture_s,
                      "usable": usable, "steps": len(walls),
                      "full_resets": counters.get("full_resets", 0),
                      "ba_runs": counters.get("ba_runs", 0),
                      "card": card}))


if __name__ == "__main__":
    main()
