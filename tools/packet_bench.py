#!/usr/bin/env python3
"""The event cell's packet step of one tree of the port, on one card.

Runs ``EDSPipeline`` over the event cell (640x480, ``SyntheticSequence``
seed 7, motion_scale 0.22, micro_steps 2, 65,536-event packets, default
config) for ``--frames`` frames with the package imported from ``--tree``
(a checkout of this repository, the current one by default), timing every
``process_events`` call on the host; then runs a second pipeline over the
same frames in the same process, its programs all captured already, with
every ``process_events`` call under ``torch.profiler`` (a session of its
own): its device busy time. Both runs go through the public API only, so
two trees that give the same bits run the same packets through the same
rungs. Prints one JSON line: the median wall ms of ``process_events`` over
packets 4 on (first run), the median and mean device ms per packet over
the same packets (second run), usable solves and the card's name and power
limit. Compare two trees only on one card within one command, in turns:

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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("packet_bench: needs a CUDA card")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.device import set_numerics
    from slam_eds_tpu_torch.io.dataset import SyntheticSequence
    from slam_eds_tpu_torch.models.pipeline import EDSPipeline
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    import dataclasses
    set_numerics()
    dev = torch.device("cuda:0")
    cam = Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
    seq = SyntheticSequence(cam, num_frames=args.frames, motion_scale=0.22,
                            micro_steps=2, events_per_packet=65536,
                            device=dev)
    cfg = EDSConfig()
    cfg = dataclasses.replace(
        cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
        event_frame=dataclasses.replace(cfg.event_frame,
                                        events_per_frame=65536))
    from torch.profiler import ProfilerActivity, profile

    def run(profiled):
        """(packet index, host s, device busy ms or None) per packet, and
        the usable solves, of one pipeline over the frames."""
        pipe = EDSPipeline(cam, cfg, device=dev)
        out, usable = [], 0
        for k in range(args.frames):
            t, img = seq.frame(k)[:2]
            pipe.process_frame(img, t)
            if k + 1 < args.frames and pipe.kf is not None:
                pk = seq.events_between(k, k + 1)
                torch.cuda.synchronize()
                with (profile(activities=[ProfilerActivity.CUDA])
                      if profiled else contextlib.nullcontext()) as prof:
                    t0 = time.perf_counter()
                    T = pipe.process_events(pk)
                    torch.cuda.synchronize()
                    wall = time.perf_counter() - t0
                busy = None if prof is None else sum(
                    e.self_device_time_total
                    for e in prof.key_averages()) / 1e3
                out.append((k, wall, busy))
                usable += T is not None
        return out, usable

    with torch.inference_mode():
        walls, usable = run(False)
        busy, usable_2 = run(True)
    if usable_2 != usable:
        sys.exit(f"packet_bench: the runs disagree ({usable}, {usable_2} "
                 f"usable)")
    steady = [b for k, _, b in busy if k >= 4]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(json.dumps({"bench": "packet", "tree": os.path.basename(tree),
                      "packet_ms_median": 1e3 * float(np.median(
                          [s for k, s, _ in walls if k >= 4])),
                      "packet_device_ms_median": float(np.median(steady)),
                      "packet_device_ms_mean": float(np.mean(steady)),
                      "usable": usable, "packets": len(walls),
                      "card": card}))


if __name__ == "__main__":
    main()
