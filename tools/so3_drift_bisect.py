#!/usr/bin/env python3
"""Where the rotations of the runner cell leave SO(3), in each package.

Runs the runner cell of ``tools/runner_reference.py`` (640x480, 32 frames,
65,536-event packets, motion 0.22, 2 micro-steps, seed 7, a zero radtan
calib, the default config) through one package's ``run_sequence`` and
records, in call order, the departure |R R^T - I| (largest entry, float64)
of every rotation the pipeline keeps or hands on:

* ``boot``: the bootstrap's two poses (``_record_boot``);
* ``track.pred``, ``track.T_kf``, ``track.pose``, ``track.T_wc``: each
  coarse track's prediction, the newest keyframe's current pose
  exp(delta) T_eval, the coarse tracker's result before composition
  (ref-to-new) and the world pose it composes (``WindowManager.
  track_frame``);
* ``frame.pose``: ``frame_pipe.poses[-1]`` after each frame;
* ``insert.T_wc``: the pose a keyframe enters the window with (its
  ``T_eval``);
* ``ba.T_eval``, ``ba.current``: after each window BA, the largest over
  the window's live slots of T_eval and of exp(delta) T_eval;
* ``event.qx`` (| |q| - 1 |, the quaternion's norm error), ``event.R``
  (quat_to_mat of the tracker's q, the event tracker's pose) and
  ``event.T`` (the pose ``process_events`` returns, which seeds the next
  coarse track) after each usable packet.

Each record also keeps the sign of its departure, trace(R R^T - I) / 3
(``growth``: above 0 where the rotation stretches, below where it
shrinks).

``--package jax`` or ``--package port`` runs one package (one per
process, as ``runner_reference.py`` does); the JAX run writes the dataset
into ``<out>/seq`` and the port's run reads that same directory, so both
see the same bytes. ``--package both`` (the default) runs the two in turn
in child processes and then compares them (``--compare`` alone redoes the
comparison): a table of the largest departure per frame of each source
for both packages (JAX first) and of the frame pose's growth, then one
JSON line with the same, the first step, in call order, at which the
port's departure exceeds JAX's by more than ``--ratio`` (1.5) where both
have made that step as often, and the eight records before it in each
package (how far the step's inputs already were). Whether that step
computes the same thing in both is then a test on the same inputs
(``tests/test_torch_frontend.py::test_coarse_track_departure_from_so3``
for the coarse tracker).

    JAX_PLATFORMS=cpu python3 tools/so3_drift_bisect.py --out /tmp/so3
    python3 tools/so3_drift_bisect.py --out /tmp/so3 --compare

About 5 minutes on the CPU for both packages. ``--frames N`` cuts the run.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
import runner_reference as rr  # noqa: E402

SOURCES = ("frame.pose", "ba.T_eval", "track.pose", "event.R")


def departure(R):
    """Largest entry of |R R^T - I| over the leading axes, in float64."""
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    return float(np.abs(R @ R.transpose(0, 2, 1) - np.eye(3)).max())


def growth(R):
    """trace(R R^T - I) / 3 of the rotation whose departure is largest:
    above 0 where R stretches (its singular values above 1), below 0 where
    it shrinks."""
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    M = R @ R.transpose(0, 2, 1) - np.eye(3)
    k = int(np.abs(M).reshape(len(M), -1).max(1).argmax())
    return float(np.trace(M[k]) / 3)


def _host(x):
    return np.asarray(x.detach().cpu() if hasattr(x, "detach") else x,
                      np.float32)


class Recorder:
    """The ordered records of one run: frame, step, the departure of the
    step's rotation and its growth."""

    def __init__(self):
        self.frame = -1
        self.rows = []

    def add(self, step, R, dep=None):
        """Record rotation(s) ``R`` (or, for a step without one, ``dep``)."""
        R = None if R is None else _host(R)
        self.rows.append({
            "i": len(self.rows), "frame": self.frame, "step": step,
            "departure": departure(R) if R is not None else dep,
            "growth": growth(R) if R is not None else None})


def instrument(pipeline, rec):
    """Wrap the pipeline's host-level steps so each records its poses."""
    pkg = pipeline.__name__.split(".")[0]
    WM = sys.modules[pkg + ".models.window"].WindowManager
    Frame, EDS = pipeline.FrameOnlyPipeline, pipeline.EDSPipeline
    quat_to_mat = sys.modules[pkg + ".utils.lie"].quat_to_mat

    def after(cls, name, fn):
        orig = getattr(cls, name)

        def wrapped(self, *a, **k):
            out = orig(self, *a, **k)
            fn(self, out, *a, **k)
            return out
        setattr(cls, name, wrapped)

    orig_frame = EDS.process_frame

    def process_frame(self, *a, **k):
        rec.frame += 1
        out = orig_frame(self, *a, **k)
        poses = self.frame_pipe.poses
        rec.add("frame.pose", poses[-1].R if poses else np.eye(3))
        return out
    EDS.process_frame = process_frame

    after(Frame, "_record_boot",
          lambda self, out, pairs: [rec.add("boot", T.R) for _, T in pairs])

    orig_track = WM.track_frame

    def track_frame(self, img, pose_init, *a, **k):
        R_kf = _host(self.state.current_poses().R)[self.newest_slot]
        res, T_wc = orig_track(self, img, pose_init, *a, **k)
        rec.add("track.pred", pose_init.R)
        rec.add("track.T_kf", R_kf)
        rec.add("track.pose", res.pose.R)
        rec.add("track.T_wc", T_wc.R)
        return res, T_wc
    WM.track_frame = track_frame

    after(WM, "insert_frame",
          lambda self, out, img, T_wc, *a, **k: rec.add("insert.T_wc",
                                                        T_wc.R))

    def optimize(self, out, *a, **k):
        live = np.flatnonzero(_host(self.state.frame_valid) > 0)
        rec.add("ba.T_eval", _host(self.state.T_eval.R)[live])
        rec.add("ba.current", _host(self.state.current_poses().R)[live])
    after(WM, "optimize", optimize)

    def process_events(self, out, *a, **k):
        if out is None:
            return
        q = _host(self.tracker_state.qx).astype(np.float64)
        rec.add("event.qx", None, dep=float(abs(np.linalg.norm(q) - 1.0)))
        rec.add("event.R", quat_to_mat(self.tracker_state.qx))
        rec.add("event.T", out.R)
    after(EDS, "process_events", process_events)


def run_package(package, out, frames):
    import dataclasses
    config, dataset, pipeline, runner, cam, kw = rr._package(package)
    d = os.path.join(out, "seq")
    if package == "jax" and not os.path.isdir(d):
        dataset.SyntheticSequence(cam, num_frames=32, events_per_packet=65536,
                                  motion_scale=0.22, micro_steps=2, seed=7,
                                  **kw).write_dataset(d)
        with open(os.path.join(d, "calib.yaml"), "w") as f:
            f.write(rr.RADTAN_ZERO_CALIB)
    if not os.path.isdir(d):
        raise SystemExit(f"{d} is missing: run --package jax first")
    cfg = config.EDSConfig()
    cfg = dataclasses.replace(
        cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
        event_frame=dataclasses.replace(cfg.event_frame,
                                        events_per_frame=65536))
    rec = Recorder()
    instrument(pipeline, rec)
    res = runner.run_sequence(d, cfg, verbose=False, max_frames=frames,
                              **kw) if frames else \
        runner.run_sequence(d, cfg, verbose=False, **kw)
    res = {k: v for k, v in res.items() if k != "positions"}
    with open(os.path.join(out, f"{package}.json"), "w") as f:
        json.dump({"result": res, "rows": rec.rows}, f, default=float)


def per_frame(rows):
    """{source: [largest departure per frame]}, and the frame pose's
    ``growth`` per frame under "frame.pose growth"."""
    n = max(r["frame"] for r in rows) + 1
    out = {s: [None] * n for s in (*SOURCES, "frame.pose growth")}
    for r in rows:
        if r["step"] in out and r["frame"] >= 0:
            v = out[r["step"]][r["frame"]]
            out[r["step"]][r["frame"]] = max(v or 0.0, r["departure"])
        if r["step"] == "frame.pose" and r["frame"] >= 0:
            out["frame.pose growth"][r["frame"]] = r["growth"]
    return out


def table(report):
    """The per-frame text table: each source's departure, JAX and port, and
    the frame pose's growth."""
    pf = report["per_frame"]
    cols = (*SOURCES, "frame.pose growth")
    lines = ["frame  " + "  ".join(f"{c:>25}" for c in cols)]
    for k in range(len(pf["jax"]["frame.pose"])):
        cells = []
        for c in cols:
            a = pf["jax"][c][k] if k < len(pf["jax"][c]) else None
            b = pf["port"][c][k] if k < len(pf["port"][c]) else None
            cells.append("{:>12} {:>12}".format(
                "-" if a is None else f"{a:.3g}",
                "-" if b is None else f"{b:.3g}"))
        lines.append(f"{k:5d}  " + "  ".join(cells))
    return "\n".join(lines)


def first_departure(jrows, prows, ratio):
    """The first record (call order) at which the port's departure exceeds
    ratio x JAX's, pairing the k-th record of each (frame, step) in both
    runs; None where none does."""
    def keyed(rows):
        seen, out = {}, {}
        for r in rows:
            k = (r["frame"], r["step"])
            seen[k] = seen.get(k, -1) + 1
            out[(*k, seen[k])] = r
        return out
    jk = keyed(jrows)
    for r in prows:
        k = (r["frame"], r["step"])
        n = sum(1 for x in prows[:r["i"] + 1]
                if (x["frame"], x["step"]) == k) - 1
        j = jk.get((*k, n))
        if j is None or r["step"] == "event.qx":
            continue
        if r["departure"] > ratio * j["departure"] and r["departure"] > 0:
            return {"frame": r["frame"], "step": r["step"], "occurrence": n,
                    "port": r, "jax": j}
    return None


def compare(out, ratio):
    runs = {}
    for p in ("jax", "port"):
        with open(os.path.join(out, f"{p}.json")) as f:
            runs[p] = json.load(f)
    report = {"per_frame": {p: per_frame(runs[p]["rows"]) for p in runs},
              "result": {p: runs[p]["result"] for p in runs}}
    first = first_departure(runs["jax"]["rows"], runs["port"]["rows"], ratio)
    report["first_departure"] = first
    if first is not None:
        # the records before it: how far the step's inputs already were
        report["records_before"] = {
            p: runs[p]["rows"][max(0, r["i"] - 8):r["i"]]
            for p, r in (("jax", first["jax"]), ("port", first["port"]))}
    print(table(report))
    print(json.dumps(report))
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--package", choices=("jax", "port", "both"),
                    default="both")
    ap.add_argument("--out", required=True,
                    help="directory for the dataset and the records")
    ap.add_argument("--frames", type=int, default=0,
                    help="frames to run (0: all 32)")
    ap.add_argument("--ratio", type=float, default=1.5)
    ap.add_argument("--compare", action="store_true",
                    help="only compare the records already in --out")
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)
    if args.compare:
        compare(args.out, args.ratio)
        return
    if args.package != "both":
        run_package(args.package, args.out, args.frames)
        return
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for p in ("jax", "port"):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--package", p, "--out", args.out,
                        "--frames", str(args.frames)], env=env, check=True)
    compare(args.out, args.ratio)


if __name__ == "__main__":
    main()
