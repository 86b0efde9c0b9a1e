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
  frames, fed frame 0's true depth as a dense map;
* ``--cell frame``: ``FrameOnlyPipeline`` over 32 frames (the smoke's frame
  cell);
* ``--cell event``: ``EDSPipeline`` over 32 frames with 65,536-event packets
  (the smoke's event cell).

``--window-size N`` sets ``bundles.window_size`` and ``bundles.min_frames``
to N (``caps.max_window_frames`` stays 8) and ``--frames N`` runs the
first N frames of the frame and event cells' 32-frame sequence.
``--per-frame`` adds to the frame and event cells' line a ``by_frame``
record (``frame_record``): after each frame k, the keyframes made
(``window.next_id``), the frames marginalized, the BA runs, the full
resets, the largest |R R^T - I| of frame k's pose, its keyframe score
(``keep_kf_inputs``) and its position (camera to world); in the event cell
also each packet's usable verdict (``u`` or ``x``, packet k after frame
k). ``horizon`` and ``per_frame_parity`` hold one such record to another
up to the last frame whose reference rotation is still within
``DRIFT_LIMIT`` of SO(3). ``--device cuda`` runs the port on the card and
``--compare`` holds its record to ``chip_smoke.py``'s reference of the
cell.

``chip_smoke.py``'s ``JAX_CPU_RUNNER``, ``JAX_CPU_REFINE``, ``JAX_CPU_DSO``,
``JAX_CPU_MIDAS`` and ``JAX_CPU_*_BY_FRAME`` are this script's output with
``--package jax``. Only one package is imported per run.

    python3 tools/runner_reference.py --package jax --out /tmp/runner_ref
    python3 tools/runner_reference.py --package jax --cell dso
    python3 tools/runner_reference.py --package port --out /tmp/runner_ref
    python3 tools/runner_reference.py --package jax --cell frame --per-frame
    python3 tools/runner_reference.py --package jax --cell frame \
        --window-size 4 --frames 24 --per-frame
    python3 tools/runner_reference.py --package jax --cell event --per-frame
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


def _package(name, device="cpu"):
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
    return config, dataset, pipeline, runner, cam, {"device": device}


# the horizon: the last frame at which the reference's frame rotation is
# within this of SO(3) (largest |R R^T - I|); below it a pose's scale error
# is under 0.5%
DRIFT_LIMIT = 1e-2
# the drift ratio (port over reference) is held from this frame on: before
# it both are a few float32 ulps (about 1e-7) and their ratio is rounding's
DRIFT_RATIO_FROM = 4
DRIFT_RATIO = (1 / 3, 3.0)
COUNTS = ("keyframes", "marginalized", "ba_runs", "resets")
# the per-frame checks: (a) counts equal, (b) positions within a bound,
# (c) the drift ratio within DRIFT_RATIO, (d) the same packet verdicts
CHECKS = ("counts", "positions", "drift_ratio", "usable")
# a keyframe decision whose scores in the two runs lie this close to the
# threshold (1), on either side of it, is float32 rounding's to make
KF_EDGE = 1e-2


def _host(x):
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def so3_departure(R):
    """Largest entry of |R R^T - I|, in float64."""
    R = np.asarray(_host(R), np.float64)
    return float(np.abs(R @ R.T - np.eye(3)).max())


def kf_score(window, fa):
    """DSO's keyframe score as ``WindowManager.need_new_kf`` (either
    package) forms it from ``fa``, its flow indicators and affine change
    (3 flow terms, then a and b; one array or a tuple of the two): a
    keyframe is made when above 1."""
    if isinstance(fa, tuple):
        fa = np.concatenate([np.ravel(_host(x)) for x in fa])
    cfg, w, h = window.cfg.bundles, window.cam.width, window.cam.height
    fa = np.asarray(_host(fa), np.float64)
    norm = (640 + 480) / (w + h)
    return float(cfg.kf_global_weight * (
        cfg.max_shift_weight_t * norm * np.sqrt(max(fa[0], 0.0))
        + cfg.max_shift_weight_r * norm * np.sqrt(max(fa[1], 0.0))
        + cfg.max_shift_weight_rt * norm * np.sqrt(max(fa[2], 0.0))
        + cfg.max_affine_weight * abs(fa[3])))


def keep_kf_inputs(window_cls):
    """Wrap ``window_cls.need_new_kf`` (either package's
    ``WindowManager``) so each call keeps its flow indicators and affine
    change on the window as ``_kf_inputs`` (on the port a copy on its
    device, so no host read), which ``frame_record`` turns into
    ``kf_score``. Returns the original method."""
    orig = window_cls.need_new_kf
    if getattr(orig, "keeps_kf_inputs", False):
        return orig

    def need_new_kf(self, res):
        fa = (res.flow_indicators, res.aff)
        if type(fa[0]).__module__ == "torch":
            import torch
            fa = torch.cat(fa).clone()
        self._kf_inputs = fa
        return orig(self, res)
    need_new_kf.keeps_kf_inputs = True
    window_cls.need_new_kf = need_new_kf
    return orig


def _f32(a):
    """Nested lists of ``a``'s float32 values, each written with the
    fewest digits that read back to it."""
    a = np.asarray(a, np.float32)
    if a.ndim == 0:
        return float(str(a))
    return [_f32(x) for x in a]


def keep_bootstrap(initializer, into):
    """Wrap ``initializer.bootstrap_eight_point`` (either package's
    module) so the first call's result is kept in ``into``: the normalized
    coordinates in the first view of every inlier (``nc``), their idepths
    and the relative pose ``R``, ``t``. Returns the original function."""
    orig = initializer.bootstrap_eight_point

    def bootstrap_eight_point(nc1, nc2, mask, *args, **kwargs):
        res = orig(nc1, nc2, mask, *args, **kwargs)
        if not into:
            inl = np.asarray(_host(res.inliers), bool)
            into.update(nc=_f32(_host(nc1)[inl]),
                        idepth=_f32(_host(res.idepth)[inl]),
                        R=_f32(_host(res.T_21.R)), t=_f32(_host(res.T_21.t)))
        return res
    initializer.bootstrap_eight_point = bootstrap_eight_point
    return orig


def shared_bootstrap(ref):
    """A stand-in for the port's ``initializer.bootstrap_eight_point`` that
    returns the reference's bootstrap (``keep_bootstrap``'s record): its
    pose, and on every candidate whose normalized coordinates equal those
    of a reference inlier that inlier's idepth; the other candidates are
    no inliers. The rest of the bootstrap (candidates, tracks, window,
    activation, BA) stays the port's."""
    import torch
    from slam_eds_tpu_torch.ops.initializer import BootstrapResult
    from slam_eds_tpu_torch.utils.lie import SE3
    where = {tuple(np.float32(x).tolist()): i
             for i, x in enumerate(np.asarray(ref["nc"], np.float32))}
    idepth = np.asarray(ref["idepth"], np.float32)

    def bootstrap_eight_point(nc1, nc2, mask, *args, **kwargs):
        dev = nc1.device
        at = np.array([where.get(tuple(x), -1)
                       for x in np.asarray(_host(nc1), np.float32).tolist()])
        inl = (at >= 0) & np.asarray(_host(mask), bool)
        idp = np.where(inl, idepth[np.maximum(at, 0)], np.float32(0))
        bootstrap_eight_point.matched = (int(inl.sum()), len(idepth))
        f32 = dict(dtype=torch.float32, device=dev)
        return BootstrapResult(
            T_21=SE3(torch.tensor(ref["R"], **f32),
                     torch.tensor(ref["t"], **f32)),
            idepth=torch.as_tensor(idp, **f32),
            inliers=torch.as_tensor(inl, device=dev),
            success=torch.tensor(True, device=dev))
    return bootstrap_eight_point


def frame_record(pipe, by_frame=None):
    """Append the state of a ``FrameOnlyPipeline`` (either package) after
    its newest frame to the columns of ``by_frame`` (new when None):
    keyframes made, frames marginalized, BA runs, full resets, the largest
    |R R^T - I| of the newest frame pose, its position (camera to world)
    and, where the frame asked ``need_new_kf`` and ``keep_kf_inputs``
    wraps it, the keyframe score (else None)."""
    if by_frame is None:
        by_frame = {k: [] for k in (*COUNTS, "drift", "position",
                                    "kf_score")}
    fa = getattr(pipe.window, "_kf_inputs", None)
    pipe.window._kf_inputs = None
    by_frame["kf_score"].append(None if fa is None
                                else kf_score(pipe.window, fa))
    by_frame["keyframes"].append(int(pipe.window.next_id))
    by_frame["marginalized"].append(int(pipe.window.marg_count))
    by_frame["ba_runs"].append(int(pipe.telemetry.counters.get("ba_runs", 0)))
    by_frame["resets"].append(int(pipe._resets))
    by_frame["drift"].append(so3_departure(pipe.poses[-1].R))
    by_frame["position"].append(
        [float(x) for x in np.asarray(pipe.trajectory[-1], np.float64)])
    return by_frame


def horizon(drift, frames=None):
    """The last frame before the first whose drift exceeds ``DRIFT_LIMIT``
    (the last frame when none does). ``drift`` is per frame, frame k at
    index k, or at ``frames[k]`` when those are given."""
    frames = range(len(drift)) if frames is None else list(frames)
    last = None
    for k, d in zip(frames, drift):
        if not d <= DRIFT_LIMIT:
            break
        last = k
    return last


def knife_edge(got, want, k):
    """Whether frame k's part is a keyframe decision on the knife-edge:
    both runs asked ``need_new_kf``, their scores lie within ``KF_EDGE``
    of the threshold 1 and on either side of it."""
    sg, sw = (r.get("kf_score", [None] * (k + 1))[k] for r in (got, want))
    return (sg is not None and sw is not None and (sg > 1.0) != (sw > 1.0)
            and abs(sg - 1.0) < KF_EDGE and abs(sw - 1.0) < KF_EDGE)


def per_frame_parity(got, want, pos_tol, H=None, hold=CHECKS):
    """Hold the per-frame record ``got`` to ``want`` (``frame_record``'s
    columns, ``usable`` optional) at every frame up to ``H`` (by default
    ``horizon`` of ``want``'s drift), by the checks named in ``hold``:
    (a) ``counts``: every count equal, (b) ``positions``: each position
    within ``pos_tol`` (Euclidean), (c) ``drift_ratio``: the drift ratio
    within ``DRIFT_RATIO`` from frame ``DRIFT_RATIO_FROM`` on, (d)
    ``usable``: where
    both have ``usable``, every packet that ends by H (packet k ends at
    frame k + 1) with the same verdict.

    Where counts are held, a count that parts by H is a fault, except a
    keyframe decision on the knife-edge (``knife_edge``: float32 rounding
    of the flow the score sums decides it): past it the two runs keep
    different windows and are no longer compared, so the checks are held
    to the frame before it (``held_to``) and the part is reported as
    ``knife_edge``. Returns the readings over every frame both runs have
    (printed; held only to ``held_to``) and ``faults``, one line per held
    check that failed."""
    if H is None:
        H = horizon(want["drift"])
    n = min(len(got["drift"]), len(want["drift"]))
    held_to, edge, faults = min(H, n - 1), None, []
    parted = [k for k in range(held_to + 1)
              if any(got[c][k] != want[c][k] for c in COUNTS)]
    if "counts" in hold and parted and knife_edge(got, want, parted[0]):
        k = parted[0]
        held_to = k - 1
        edge = {"frame": k, "kf_scores": [got["kf_score"][k],
                                          want["kf_score"][k]]}
    frames = range(held_to + 1)
    for c in COUNTS:
        off = [k for k in frames if got[c][k] != want[c][k]]
        if off and "counts" in hold:
            faults.append(f"{c} parts at frame {off[0]}: "
                          f"{got[c][off[0]]} against {want[c][off[0]]}")
    gap = [float(np.linalg.norm(np.subtract(got["position"][k],
                                            want["position"][k])))
           for k in range(n)]
    k_gap = int(np.argmax(gap[:held_to + 1]))
    if not gap[k_gap] <= pos_tol and "positions" in hold:
        faults.append(f"position gap {gap[k_gap]} at frame {k_gap} above "
                      f"{pos_tol}")
    rat = [got["drift"][k] / want["drift"][k] if want["drift"][k] > 0
           else None for k in range(n)]
    lo, hi = DRIFT_RATIO
    from_k = [k for k in frames if k >= DRIFT_RATIO_FROM]
    held = [rat[k] for k in from_k if rat[k] is not None]
    off = [k for k in from_k if not (rat[k] is not None
                                     and lo <= rat[k] <= hi)]
    if off and "drift_ratio" in hold:
        faults.append(f"drift ratio {rat[off[0]]} at frame {off[0]} outside "
                      f"{[lo, hi]}")
    out = {"horizon": H, "held_to": held_to, "held": list(hold),
           "knife_edge": edge, "frames": n,
           "first_count_part": parted[0] if parted else None,
           "counts_by_frame": {c: [got[c][:n], want[c][:n]] for c in COUNTS},
           "position_gap_max": gap[k_gap], "position_gap_frame": k_gap,
           "position_tol": pos_tol,
           "position_gap_past": max(gap[held_to + 1:], default=None),
           "drift_ratio_range": [min(held, default=None),
                                 max(held, default=None)],
           "drift_ratio_bounds": [lo, hi],
           "drift_ratio_from": DRIFT_RATIO_FROM,
           "drift_ratio_by_frame": rat, "position_gap_by_frame": gap,
           "kf_scores_by_frame": [got.get("kf_score"), want.get("kf_score")]}
    if "usable" in got and "usable" in want:
        m = min(len(got["usable"]), len(want["usable"]))
        compared = [k for k in range(m) if k + 1 <= held_to]
        flips = [k for k in range(m) if got["usable"][k] != want["usable"][k]]
        out.update(packets_compared=len(compared),
                   usable=[got["usable"], want["usable"]],
                   usable_flips_held=[k for k in flips if k in compared],
                   usable_flips_past=[k for k in flips
                                      if k not in compared])
        if out["usable_flips_held"] and "usable" in hold:
            k = out["usable_flips_held"][0]
            faults.append(f"packet {k} (ends at frame {k + 1}): "
                          f"{got['usable'][k]} against {want['usable'][k]}")
    out["faults"] = faults
    return out


def _ate(package, est, gt):
    if package == "jax":
        from slam_eds_tpu.utils.alignment import ate_rmse
        import jax.numpy as jnp
        return float(ate_rmse(jnp.asarray(est), jnp.asarray(gt)))
    from slam_eds_tpu_torch.utils.alignment import ate_rmse
    return float(ate_rmse(est, gt))


def _window_cfg(cfg, window_size=None):
    """``cfg`` with ``bundles.window_size`` and ``min_frames`` set to
    ``window_size`` (unchanged when None)."""
    if window_size is None:
        return cfg
    return dataclasses.replace(cfg, bundles=dataclasses.replace(
        cfg.bundles, window_size=window_size, min_frames=window_size))


def _tracker_cfg(config, window_size=None, **change):
    cfg = _window_cfg(config.EDSConfig(), window_size)
    return dataclasses.replace(
        cfg, caps=dataclasses.replace(cfg.caps, max_events=65536),
        event_frame=dataclasses.replace(cfg.event_frame,
                                        events_per_frame=65536),
        tracker=dataclasses.replace(cfg.tracker, **change))


def cell_frame(package, config, dataset, pipeline, cam, kw, n=32,
               window_size=None, per_frame=False):
    """The smoke's frame cell, its first ``n`` frames: counts, ATE and
    seconds; with ``per_frame`` the ``by_frame`` record."""
    seq = dataset.SyntheticSequence(cam, num_frames=32, motion_scale=0.22,
                                    micro_steps=2, **kw)
    pipe = pipeline.FrameOnlyPipeline(
        cam, _window_cfg(config.EDSConfig(), window_size), **kw)
    if per_frame:
        keep_kf_inputs(type(pipe.window))
    by_frame = None
    t0 = time.perf_counter()
    for k in range(n):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, float(t))
        if per_frame:
            by_frame = frame_record(pipe, by_frame)
    est = pipe.positions()
    out = {"ate": _ate(package, est, seq.gt_positions()[:len(est)]),
           "frames": n, "window_size": window_size,
           "keyframes": pipe.window.next_id,
           "ba_runs": pipe.telemetry.counters.get("ba_runs", 0),
           "marginalized": pipe.window.marg_count, "resets": pipe._resets,
           "seconds": time.perf_counter() - t0}
    if per_frame:
        out["by_frame"] = by_frame
    return out


def cell_event(package, config, dataset, pipeline, cam, kw, n=32,
               window_size=None, per_frame=False):
    """The smoke's event cell, its first ``n`` frames: counts, ATEs, the
    usable string and seconds; with ``per_frame`` the ``by_frame`` record
    and its ``usable``."""
    seq = dataset.SyntheticSequence(cam, num_frames=32, motion_scale=0.22,
                                    micro_steps=2, events_per_packet=65536,
                                    **kw)
    pipe = pipeline.EDSPipeline(cam, _tracker_cfg(config, window_size), **kw)
    if per_frame:
        keep_kf_inputs(type(pipe.frame_pipe.window))
    ev_pos, ev_gt, usable, by_frame = [], [], [], None
    t0 = time.perf_counter()
    for k in range(n):
        t, img, _ = seq.frame(k)
        pipe.process_frame(img, float(t))
        if per_frame:
            by_frame = frame_record(pipe.frame_pipe, by_frame)
        if k + 1 < n and pipe.kf is not None:
            T = pipe.process_events(seq.events_between(k, k + 1))
            usable.append(T is not None)
            if T is not None:
                ev_pos.append(_host(T.inverse().t))
                ev_gt.append(_host(seq.pose_at(k + 0.5).inverse().t))
    fp = pipe.frame_pipe
    est = fp.positions()
    out = {"ate": _ate(package, est, seq.gt_positions()[:len(est)]),
           "event_ate": _ate(package, np.stack(ev_pos), np.stack(ev_gt)),
           "frames": n, "window_size": window_size,
           "packets_fed": len(usable), "event_solves": int(sum(usable)),
           "usable_by_packet": "".join("u" if u else "x" for u in usable),
           "event_kfs": pipe.num_event_kfs, "keyframes": fp.window.next_id,
           "ba_runs": fp.telemetry.counters.get("ba_runs", 0),
           "marginalized": fp.window.marg_count, "resets": fp._resets,
           "seconds": time.perf_counter() - t0}
    if per_frame:
        by_frame["usable"] = out["usable_by_packet"]
        out["by_frame"] = by_frame
    return out


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


def compare_to_smoke(cell, window_size, out):
    """``per_frame_parity`` of a ``--per-frame`` line against the JAX
    reference ``chip_smoke.py`` holds the cell to, with its bound."""
    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    if cell == "event":
        ref, tol = smoke.JAX_CPU_EDS_BY_FRAME, smoke.EVENT_POSITION_TOL
    elif window_size == smoke.W4_WINDOW:
        ref, tol = smoke.JAX_CPU_W4_BY_FRAME, smoke.W4_POSITION_TOL
    else:
        ref, tol = smoke.JAX_CPU_FRAME_BY_FRAME, smoke.FRAME_POSITION_TOL
    return per_frame_parity(out["by_frame"], ref, tol)


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--package", choices=("jax", "port"), required=True)
    ap.add_argument("--cell", choices=("runner", "refine", "dso", "midas",
                                       "frame", "event"), default="runner")
    ap.add_argument("--out", help="a directory to write into (runner cell)")
    ap.add_argument("--per-frame", action="store_true",
                    help="frame and event cells: add the by_frame record")
    ap.add_argument("--window-size", type=int, default=None,
                    help="frame and event cells: bundles.window_size and "
                         "min_frames")
    ap.add_argument("--frames", type=int, default=32,
                    help="frame and event cells: the first N frames of "
                         "the 32-frame sequence")
    ap.add_argument("--device", default="cpu",
                    help="the port's device (cuda runs its kernels and "
                         "captured programs)")
    ap.add_argument("--bootstrap-out", metavar="FILE",
                    help="frame and event cells: write the bootstrap's "
                         "pose and inliers (keep_bootstrap) to FILE")
    ap.add_argument("--shared-bootstrap", metavar="FILE",
                    help="the port: bootstrap with FILE's (shared_bootstrap)")
    ap.add_argument("--compare", action="store_true",
                    help="frame and event cells, --per-frame: also print "
                         "per_frame_parity against chip_smoke.py's JAX "
                         "reference of the cell")
    args = ap.parse_args()
    config, dataset, pipeline, runner, cam, kw = _package(args.package,
                                                          args.device)
    boot = {}
    if args.bootstrap_out:
        keep_bootstrap(sys.modules[pipeline.__name__].initializer, boot)
    if args.shared_bootstrap:
        with open(args.shared_bootstrap) as f:
            sys.modules[pipeline.__name__].initializer.bootstrap_eight_point \
                = shared_bootstrap(json.load(f))
    if args.cell in ("frame", "event"):
        cell = cell_frame if args.cell == "frame" else cell_event
        out = cell(args.package, config, dataset, pipeline, cam, kw,
                   n=args.frames, window_size=args.window_size,
                   per_frame=args.per_frame)
        print(json.dumps(out))
        if args.bootstrap_out:
            with open(args.bootstrap_out, "w") as f:
                json.dump(boot, f)
        if args.compare:
            print(json.dumps(compare_to_smoke(args.cell, args.window_size,
                                              out)))
        return
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
