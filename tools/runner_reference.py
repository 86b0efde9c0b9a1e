#!/usr/bin/env python3
"""Reference numbers of the runner cell, on the CPU, from one package.

Writes the event cell's sequence (``Pinhole(400, 400, 319.5, 239.5, 640,
480)``, 32 frames, 65,536-event packets, motion 0.22, 2 micro-steps, seed
7) with that package's ``write_dataset``, switches ``calib.yaml`` to a
zero-coefficient radtan block, and runs that package's ``run_sequence`` with
the default config at 65,536 events per packet and the recorder on. Prints
one JSON line: the result dict (positions left out), the number of lines in
poses.txt, and the largest |R R^T - I| of the frame poses' rotations per
frame (how far they are from SO(3)).

``chip_smoke.py``'s ``JAX_CPU_RUNNER`` is this script's output with
``--package jax``. Only one package is imported per run.

    python3 tools/runner_reference.py --package jax --out /tmp/runner_ref
    python3 tools/runner_reference.py --package port --out /tmp/runner_ref
"""
import argparse
import dataclasses
import json
import os
import sys

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


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--out", required=True, help="a directory to write into")
    args = ap.parse_args()
    config, dataset, pipeline, runner, cam, kw = _package(args.package)
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
