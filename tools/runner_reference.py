#!/usr/bin/env python3
"""Reference numbers of the smoke's cells, on the CPU, from one package.

``--cell runner`` (the default):

Writes the event cell's sequence (``Pinhole(400, 400, 319.5, 239.5, 640,
480)``, 32 frames, 65,536-event packets, motion 0.22, 2 micro-steps, seed
7) with that package's ``write_dataset``, switches ``calib.yaml`` to a
zero-coefficient radtan block, and runs that package's ``run_sequence`` with
the default config at 65,536 events per packet and the recorder on. Prints
one JSON line: the result dict (positions left out), the number of lines in
poses.txt, and the largest |R R^T - I| of the frame poses' rotations per
frame (how far they are from SO(3)).

The other cells run in memory on the same 640x480 sequence with the default
config, and print one JSON line of counts and ATE each:

* ``--cell refine``: ``EDSPipeline`` over 32 frames with 65,536-event
  packets and ``track_refinement="model_klt"``;
* ``--cell dso``: ``FrameOnlyPipeline`` with ``bootstrap="dso"`` over 24
  frames: the frames at which the initializer snaps and the pipeline
  initializes, seconds in ``set_first`` and per later initializer frame;
* ``--cell midas``: ``FrameOnlyPipeline`` with ``bootstrap="midas"`` over 16
  frames, fed frame 0's true depth as a dense map.

``chip_smoke.py``'s ``JAX_CPU_RUNNER``, ``JAX_CPU_REFINE``, ``JAX_CPU_DSO``
and ``JAX_CPU_MIDAS`` are this script's output with ``--package jax``. Only
one package is imported per run.

    python3 tools/runner_reference.py --package jax --out /tmp/runner_ref
    python3 tools/runner_reference.py --package jax --cell dso
    python3 tools/runner_reference.py --package port --out /tmp/runner_ref
"""
import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RADTAN_ZERO_CALIB = ("cam0:\n  intrinsics: [400.0, 400.0, 319.5, 239.5]\n"
                     "  resolution: [640, 480]\n  distortion_model: radtan\n"
                     "  distortion_coeffs: [0, 0, 0, 0]\n")


def _package(name):
    """(config, dataset, pipeline, runner modules, Pinhole, the device
    keyword the port's entry points take)."""
    sys.path.insert(0, ROOT)
    if name == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        import jax.numpy as jnp
        from slam_eds_tpu import config, runner
        from slam_eds_tpu.io import dataset
        from slam_eds_tpu.models import pipeline
        from slam_eds_tpu.utils.cameras import Pinhole
        cam = Pinhole(jnp.float32(400.0), jnp.float32(400.0),
                      jnp.float32(319.5), jnp.float32(239.5), 640, 480)
        return config, dataset, pipeline, runner, cam, {}
    from slam_eds_tpu_torch import config, runner
    from slam_eds_tpu_torch.io import dataset
    from slam_eds_tpu_torch.models import pipeline
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    cam = Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
    return config, dataset, pipeline, runner, cam, {"device": "cpu"}


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _ate(package, est, gt):
    if package == "jax":
        from slam_eds_tpu.utils.alignment import ate_rmse
        import jax.numpy as jnp
        return float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    from slam_eds_tpu_torch.utils.alignment import ate_rmse
    return float(ate_rmse(est, gt))


def _tracker_cfg(config, **change):
    cfg = config.EDSConfig()
    return dataclasses.replace(
        cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
        event_frame=dataclasses.replace(cfg.event_frame,
                                        events_per_frame=65536),
        tracker=dataclasses.replace(cfg.tracker, **change))


def cell_refine(package, config, dataset, pipeline, cam, kw):
    n = 32
    seq = dataset.SyntheticSequence(cam, num_frames=n, motion_scale=0.22,
                                    micro_steps=2, events_per_packet=65536,
                                    **kw)
    pipe = pipeline.EDSPipeline(
        cam, _tracker_cfg(config, track_refinement="model_klt"), **kw)
    ev_pos, ev_gt, usable = [], [], []
    for k in range(n):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, float(t))
        if k + 1 < n and pipe.kf is not None:
            T = pipe.process_events(seq.events_between(k, k + 1))
            usable.append(T is not None)
            if T is not None:
                ev_pos.append(_host(T.inverse().t))
                ev_gt.append(_host(seq.pose_at(k + 0.5).inverse().t))
    fp = pipe.frame_pipe
    est = fp.positions()
    return {"ate": _ate(package, est, seq.gt_positions()[:len(est)]),
            "event_ate": _ate(package, np.stack(ev_pos), np.stack(ev_gt)),
            "packets_fed": len(usable), "event_solves": int(sum(usable)),
            "usable_by_packet": "".join("u" if u else "x" for u in usable),
            "event_kfs": pipe.num_event_kfs, "keyframes": fp.window.next_id,
            "ba_runs": fp.telemetry.counters.get("ba_runs", 0),
            "marginalized": fp.window.marg_count, "resets": fp._resets}


def cell_bootstrap(package, config, dataset, pipeline, cam, kw, name, n):
    seq = dataset.SyntheticSequence(cam, num_frames=n, motion_scale=0.22,
                                    micro_steps=2, **kw)
    pipe = pipeline.FrameOnlyPipeline(
        cam, _tracker_cfg(config, bootstrap=name), **kw)
    snap_at = init_at = None
    seconds = []
    for k in range(n):
        t, img, depth = seq.frame(k)
        t0 = time.perf_counter()
        pipe.process_frame(img, float(t), depth_map=(
            depth if name == "midas" and k == 0 else None))
        seconds.append(time.perf_counter() - t0)
        st = getattr(pipe, "_init_state", None)
        if snap_at is None and st is not None and bool(st.snapped):
            snap_at = k
        if init_at is None and pipe._initialized:
            init_at = k
    est = pipe.positions()
    active = int((_host(pipe.window.state.p_status) == 1).sum())
    out = {"ate": _ate(package, est, seq.gt_positions()[:len(est)]),
           "frames": n, "trajectory": len(est), "init_frame": init_at,
           "keyframes": pipe.window.next_id,
           "ba_runs": pipe.telemetry.counters.get("ba_runs", 0),
           "marginalized": pipe.window.marg_count, "resets": pipe._resets,
           "active_points": active}
    if name == "dso":
        out.update(snap_frame=snap_at, set_first_s=seconds[0],
                   track_frame_s=(float(np.median(seconds[1:init_at]))
                                  if init_at and init_at > 1 else None))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--cell", choices=("runner", "refine", "dso", "midas"),
                    default="runner")
    ap.add_argument("--out", help="a directory to write into (runner cell)")
    args = ap.parse_args()
    config, dataset, pipeline, runner, cam, kw = _package(args.package)
    if args.cell == "refine":
        print(json.dumps(cell_refine(args.package, config, dataset, pipeline,
                                     cam, kw)))
        return
    if args.cell in ("dso", "midas"):
        print(json.dumps(cell_bootstrap(
            args.package, config, dataset, pipeline, cam, kw, args.cell,
            24 if args.cell == "dso" else 16)))
        return
    if not args.out:
        ap.error("--cell runner needs --out")
    d = os.path.join(args.out, f"{args.package}_seq")
    rec = os.path.join(args.out, f"{args.package}_out")
    dataset.SyntheticSequence(cam, num_frames=32, events_per_packet=65536,
                              motion_scale=0.22, micro_steps=2, seed=7,
                              **kw).write_dataset(d)
    with open(os.path.join(d, "calib.yaml"), "w") as f:
        f.write(RADTAN_ZERO_CALIB)
    cfg = config.EDSConfig()
    cfg = dataclasses.replace(
        cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
        event_frame=dataclasses.replace(cfg.event_frame,
                                        events_per_frame=65536),
        recorder=dataclasses.replace(cfg.recorder, enabled=True,
                                     output_folder=rec))
    seen = {}
    process_frame = pipeline.EDSPipeline.process_frame

    def keep(self, *args, **kwargs):
        seen["pipe"] = self
        return process_frame(self, *args, **kwargs)
    pipeline.EDSPipeline.process_frame = keep
    res = runner.run_sequence(d, cfg, verbose=False, **kw)
    res = {k: v for k, v in res.items() if k != "positions"}
    with open(os.path.join(rec, "poses.txt")) as f:
        res["poses_lines"] = len(f.read().strip().splitlines())
    res["so3_departure"] = [
        float(np.abs(R @ R.T - np.eye(3)).max()) for R in
        (np.asarray(p.R.cpu() if hasattr(p.R, "cpu") else p.R, np.float64)
         for p in seen["pipe"].frame_pipe.poses)]
    print(json.dumps(res))


if __name__ == "__main__":
    main()
