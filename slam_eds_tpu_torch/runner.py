"""Sequence runner — port of ``slam_eds_tpu.runner``: the command-line
program that runs the pipeline over a standard event-camera dataset on disk

    <dir>/events.txt        # "t x y p" lines ('#' comments)
    <dir>/images.txt        # "t filename" lines
    <dir>/images/*.png      # grayscale frames
    <dir>/calib.yaml        # kalibr-style calib (utils/calib.py), optional
    <dir>/pcalib.txt        # DSO gamma response, optional (+ vignette.png)
    <dir>/groundtruth.txt   # "t x y z qx qy qz qw", optional

Frames come through the native prefetching loader, are photometrically
corrected and remapped into the working pinhole on the device; events are
streamed through the native ring and reader and interleaved with the frames
by the native scheduler (or the Python loop when the host library cannot be
built); ``EDSPipeline`` (or the frame-only slice) runs on the device, the
recorder writes TUM poses and velocities, and ATE / RPE are scored against
the ground truth when it is present.

    python -m slam_eds_tpu_torch.runner <dataset_dir> [--config cfg.yaml]
        [--frames N] [--frame-only] [--output out_dir] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import replace
from typing import Optional

import numpy as np
import torch

from .config import EDSConfig, load_config
from .device import resolve_device
from .io import event_buffer as eb
from .io import frame_loader as fl
from .io.dataset import EventPacket
from .io.image_rw import read_png
from .models.pipeline import EDSPipeline, FrameOnlyPipeline
from .utils import calib as cal
from .utils.alignment import ate_rmse, rpe, umeyama
from .utils.cameras import (Pinhole, f32, forward_maps, remap,
                            undistortion_maps)
from .utils.lie import SE3, quat_to_mat


def _load_images_index(path: str):
    times, names = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            times.append(float(parts[0]))
            names.append(parts[1])
    return np.asarray(times), names


def _load_groundtruth(path: str):
    """TUM-format ground truth ``t x y z [qx qy qz qw]``. Returns (times,
    positions, quaternions [w, x, y, z] or None)."""
    rows = np.loadtxt(path, comments="#")
    quats = None
    if rows.shape[1] >= 8:
        quats = rows[:, [7, 4, 5, 6]]    # xyzw -> wxyz
    return rows[:, 0], rows[:, 1:4], quats


def _camera_from_dataset(d: str, first_img, device):
    """The dataset's camera setup, as a dict:
      cam          -- the working Pinhole geometry
      frame_maps   -- optional (map_x, map_y) on ``device`` remapping frames
                      into ``cam``
      event_fwd    -- optional (fwd_x, fwd_y) on ``device``, per-event
                      undistortion tables
      photometric  -- optional PhotometricCalib (gamma / vignette)

    A dual rig (``cam0`` + ``cam1``) maps both sensors into the common view;
    a mono calib with distortion becomes a frame remap and event forward
    maps into its pinhole; without a calib, a 90-degree-FOV pinhole."""
    H, W = first_img.shape[:2]
    out = {"cam": None, "frame_maps": None, "event_fwd": None,
           "photometric": None}
    calib_path = os.path.join(d, "calib.yaml")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            data = cal.read_yaml(f.read()) or {}
        if "cam0" in data and "cam1" in data:
            maps = cal.dual_mappings(cal.read_dual_calibration(data),
                                     device=device)
            out["cam"] = maps["out"]
            out["frame_maps"] = (maps["frame_map_x"], maps["frame_map_y"])
            out["event_fwd"] = (maps["event_fwd_x"], maps["event_fwd_y"])
        else:
            info = cal.read_camera_calib(data)
            model = info.to_model(device=device)
            if info.distortion_model not in ("none", ""):
                out["cam"] = model.pinhole
                out["frame_maps"] = undistortion_maps(model)
                out["event_fwd"] = forward_maps(model)
            else:
                out["cam"] = model.pinhole._replace(width=W, height=H)
    if out["cam"] is None:
        f = 0.5 * W
        out["cam"] = Pinhole(f32(f), f32(f), f32(W / 2 - 0.5),
                             f32(H / 2 - 0.5), W, H)
    pcal = os.path.join(d, "pcalib.txt")
    if os.path.exists(pcal):
        vpath = os.path.join(d, "vignette.png")
        vig = read_png(vpath) if os.path.exists(vpath) else None
        out["photometric"] = cal.PhotometricCalib.from_files(
            np.loadtxt(pcal), vig)
    return out


def run_sequence(dataset_dir: str, cfg: Optional[EDSConfig] = None,
                 max_frames: Optional[int] = None, frame_only: bool = False,
                 verbose: bool = True, device="cuda"):
    """Run the pipeline over one on-disk sequence on ``device`` (the card
    unless the CPU is asked for by name). Returns a dict of results: counts,
    wall time and frames/s, the camera positions, and ATE / RPE when ground
    truth exists."""
    device = resolve_device(device)
    cfg = cfg or EDSConfig()
    img_times, img_names = _load_images_index(
        os.path.join(dataset_dir, "images.txt"))
    if max_frames:
        img_times, img_names = img_times[:max_frames], img_names[:max_frames]
    first = read_png(os.path.join(dataset_dir, img_names[0]))
    setup = _camera_from_dataset(dataset_dir, first, device)
    cam = setup["cam"]
    photometric = setup["photometric"]
    frame_maps = setup["frame_maps"]
    fwd_maps = setup["event_fwd"]

    def _prep_frame(raw):
        """Raw frame -> float32 image on the device: photometric correction,
        then the remap into the working pinhole."""
        img = torch.from_numpy(np.ascontiguousarray(raw)).to(device)
        if photometric is not None:
            img = photometric.correct(img.to(torch.int32))
        img = img.to(torch.float32)
        if frame_maps is not None:
            img = remap(img, *frame_maps)
        return img

    pipe = (FrameOnlyPipeline if frame_only else EDSPipeline)(
        cam, cfg, device=device, photometric=photometric)

    ring = reader = sched = loader = None
    events_path = os.path.join(dataset_dir, "events.txt")
    native = eb.available()
    try:
        if not frame_only and os.path.exists(events_path):
            ring = (eb.EventRing if native else eb.PurePythonRing)(1 << 22)
            # a streaming reader either way: memory is bounded by the ring,
            # not by the file
            reader = (eb.EventFileReader if native
                      else eb.PurePythonReader)(events_path)
        cap = cfg.event_frame.events_per_frame
        use_native = fl.available()
        if use_native:
            loader = fl.FrameLoader(
                [os.path.join(dataset_dir, n) for n in img_names],
                n_threads=2, depth=4)

        def _frame(k):
            # prefetched native decode when available (decode overlaps
            # the device work)
            if loader is not None:
                return _prep_frame(loader.next())
            return _prep_frame(read_png(os.path.join(dataset_dir,
                                                     img_names[k])))

        def _events(xs, ys, ts, ps, n, med):
            nonlocal n_packets
            packet = EventPacket(xs, ys, ts.astype(np.float32), ps, n)
            pipe.process_events(packet, fwd_maps=fwd_maps)
            n_packets += 1

        if use_native and isinstance(ring, eb.EventRing):
            # the native scheduler owns the frame/packet interleave and
            # tops the ring up from the reader itself
            sched = fl.SequenceScheduler(ring, reader, img_times, cap,
                                         min_events=64)
            items = iter(sched.next, (fl.DONE, None))
        else:
            items = fl.python_schedule(ring, reader, img_times, cap,
                                       min_events=64)
        t_start = time.perf_counter()
        n_packets = 0
        for kind, payload in items:
            if kind == fl.FRAME:
                k = payload
                pipe.process_frame(_frame(k), float(img_times[k]))
                if verbose and k % 10 == 0:
                    print(f"[runner] frame {k}/{len(img_names)} "
                          f"packets={n_packets}")
            else:
                _events(*payload)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t_start
    finally:
        # the scheduler holds raw pointers to the ring and the reader
        for obj in (sched, loader, reader, ring):
            if obj is not None and hasattr(obj, "close"):
                obj.close()

    out = {
        "frames": len(img_names),
        "packets": n_packets,
        "wall_s": wall,
        "frames_per_s": len(img_names) / wall,
    }
    fp = pipe if frame_only else pipe.frame_pipe
    out["resets"] = fp._resets
    out["marginalizations"] = fp.window.marg_count
    out["keyframes"] = fp.window.next_id
    est = np.stack(fp.trajectory) if fp.trajectory else np.zeros((0, 3))
    out["positions"] = est
    gt_path = os.path.join(dataset_dir, "groundtruth.txt")
    if os.path.exists(gt_path) and len(est) > 4:
        gt_t, gt_xyz, gt_q = _load_groundtruth(gt_path)
        # associate by the time recorded with each trajectory entry (the
        # bootstrap can consume several frames and append two entries)
        est_t = np.asarray(fp.times[: len(est)], np.float64)
        idx = np.clip(np.searchsorted(gt_t, est_t), 0, len(gt_t) - 1)
        out["ate_rmse"] = float(ate_rmse(est, gt_xyz[idx]))
        if gt_q is not None and fp.poses and len(fp.poses) == len(est):
            out["rpe_trans"], out["rpe_rot_rad"] = _rpe(
                fp.poses, est, gt_xyz[idx], gt_q[idx])
    if not frame_only and pipe.recorder is not None:
        pipe.recorder.flush()
    return out


def _rpe(poses, est_xyz, gt_xyz, gt_q):
    """RPE (delta 1) of the worldToCam ``poses`` against the TUM ground
    truth, with the monocular scale fixed by the Umeyama scale."""
    est_wc = SE3(torch.stack([p.R for p in poses]).cpu(),
                 torch.stack([p.t for p in poses]).cpu()).inverse()
    gt = torch.as_tensor(gt_xyz, dtype=torch.float32)
    s_fit, _, _ = umeyama(torch.as_tensor(est_xyz, dtype=torch.float32), gt)
    est_wc = SE3(est_wc.R, s_fit * est_wc.t)
    gt_wc = SE3(quat_to_mat(torch.as_tensor(gt_q, dtype=torch.float32)), gt)
    t_err, r_err = rpe(est_wc, gt_wc, delta=1)
    return float(t_err), float(r_err)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("dataset_dir")
    ap.add_argument("--config", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--frame-only", action="store_true")
    ap.add_argument("--output", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run raises without a card "
                         "unless the CPU is asked for (--device cpu)")
    args = ap.parse_args()
    cfg = load_config(args.config) if args.config else EDSConfig()
    if args.output:
        cfg = replace(cfg, recorder=replace(cfg.recorder, enabled=True,
                                            output_folder=args.output))
    res = run_sequence(args.dataset_dir, cfg, max_frames=args.frames,
                       frame_only=args.frame_only, device=args.device)
    print({k: v for k, v in res.items() if k != "positions"})


if __name__ == "__main__":
    main()
