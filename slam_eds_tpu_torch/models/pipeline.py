"""End-to-end pipelines — port of ``slam_eds_tpu.models.pipeline``:

* ``FrameOnlyPipeline`` (BASELINE config 1): eight-point bootstrap ->
  coarse tracking of every frame against the newest keyframe with the
  motion-hypothesis try-list -> keyframe promotion -> immature tracing ->
  point activation -> window BA with point/frame marginalization, and the
  full reset after a persistent loss.
* ``EDSPipeline`` (config 3): the event front-end (event frame ->
  event-to-model alignment -> depth filter -> keyframe promotion) at packet
  rate against keyframes that the frame backend produces.

Host Python owns sequencing, as in the JAX module; every numeric step runs
in torch on the pipeline's device under ``torch.inference_mode``.
``tracker.bootstrap`` selects the two-view eight-point bootstrap, the
DSO-style joint initializer (``dso``, ``ops.coarse_init``) or an external
depth map (``midas``); ``tracker.track_refinement`` the event track
refinement of the packet step.

While ``telemetry.TRACE`` is on, each entry call is a span, ``frame`` or
``packet``, and its pieces are spans inside it: ``bootstrap``, ``reset``,
``track`` (one ``track.hypothesis`` per motion hypothesis, with its host
read), ``keyframe`` (the window's ``keyframe.*``), ``event_keyframe``;
``packet.upload``, ``packet.read`` (the step's one host read) and
``packet.adopt`` (the accepted solve's copies and bookkeeping); each
captured program's ``replay.<program>`` (``graphs``).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..config import EDSConfig
from ..device import resolve_device, set_numerics
from ..io.recorder import Recorder
from ..utils.cameras import Pinhole
from ..utils import lie
from ..utils.lie import SE3
from ..utils import klt
from ..utils import image as image_ops
from ..utils.stats import masked_median
from ..ops import initializer, event_tracker as et, depth_filter as df
from ..ops import coarse_init as ci
from ..ops.pixel_selector import candidate_points_grid
from . import ba_state as bs
from . import keyframe as kfm
from .event_frame import create_event_frame
from .window import WindowManager
from ..telemetry import TRACE, Telemetry, traced
from .. import graphs
from ..graphs import copy_out


TRACK_REFINEMENTS = ("none", "klt", "klt_pyr", "model_klt", "epiline")
BOOTSTRAPS = ("eight_points", "dso", "midas")


def _np(x):
    return x.detach().cpu().numpy()


@dataclass
class FrameOnlyPipeline:
    cam: Pinhole
    cfg: EDSConfig = field(default_factory=EDSConfig)
    device: str = "cuda"
    # optional PhotometricCalib: its response-derivative table weights the
    # pixel selector's gradient maps
    photometric: object = None

    def __post_init__(self):
        if self.cfg.tracker.bootstrap not in BOOTSTRAPS:
            raise ValueError(
                f"unknown bootstrap {self.cfg.tracker.bootstrap!r}")
        self.device = resolve_device(self.device)
        set_numerics()
        # RANSAC's generator, seeded with 0 as the JAX pipeline draws with
        # PRNGKey(0)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)
        self.window = self._new_window()
        self.trajectory: List[np.ndarray] = []   # camToWorld translations
        self.poses: List[SE3] = []               # worldToCam per frame
        self.times: List[float] = []
        self.telemetry = Telemetry()
        self._boot_img = None
        self._boot_time = None
        self._init_state = None      # ops.coarse_init.InitState (dso)
        self._initialized = False
        self._last_pose = self._identity()
        self._last_good_pose = self._identity()
        self._motion = self._identity()
        self._frames_since_kf = 0
        self._lost = False
        self._lost_frames = 0
        self._last_rms = float("inf")
        self._first_rms = None
        self._resets = 0
        self._world_anchor = self._identity()

    def _identity(self):
        return SE3.identity(device=self.device)

    def _new_window(self):
        bgrad = (None if self.photometric is None
                 else self.photometric.b_grad_table())
        return WindowManager(self.cam, self.cfg, device=self.device,
                             photometric_bgrad=bgrad)

    # ------------------------------------------------------------------
    @traced("reset")
    def _full_reset(self):
        """Discard the window after a persistent loss and re-bootstrap,
        anchored at the last OK-tracked pose."""
        anchor = self._last_good_pose
        t = _np(anchor.t)
        if not np.isfinite(t).all() or float(np.linalg.norm(t)) > 1e6:
            anchor = self._identity()
        self._world_anchor = anchor
        prev_margs = self.window.marg_count
        self.window = self._new_window()
        self.window.marg_count = prev_margs
        self._boot_img = None
        self._boot_time = None
        self._init_state = None
        self._initialized = False
        self._lost = False
        self._lost_frames = 0
        self._last_rms = float("inf")
        self._first_rms = None
        self._motion = self._identity()
        self._frames_since_kf = 0
        self._resets += 1
        self.telemetry.counters["full_resets"] = \
            self.telemetry.counters.get("full_resets", 0) + 1

    def _record_boot(self, pairs):
        if self._resets == 0:
            self.poses, self.trajectory, self.times = [], [], []
        for tt, TT in pairs:
            if self._resets > 0 and self.times and tt <= self.times[-1]:
                continue
            self.poses.append(TT)
            self.trajectory.append(_np(TT.inverse().t))
            self.times.append(tt)

    def _record_pending(self, time: float):
        if self._resets == 0:
            self.poses = self.poses or [self._identity()]
            self.trajectory = self.trajectory or [np.zeros(3)]
            self.times = [time]
        else:
            self.poses.append(self._last_pose)
            self.trajectory.append(_np(self._last_pose.inverse().t))
            self.times.append(time)

    # ------------------------------------------------------------------
    @traced("bootstrap")
    def _bootstrap(self, img0, t0, img1, t1):
        """Two-view bootstrap: KLT tracks of gradient candidates + batched
        RANSAC essential matrix (KeyFrame::initialStructure)."""
        dev = self.device
        g0 = torch.as_tensor(img0, dtype=torch.float32, device=dev)
        g1 = torch.as_tensor(img1, dtype=torch.float32, device=dev)
        gx, gy = image_ops.sobel(g0, 3)
        uv0, mask = candidate_points_grid(
            image_ops.gradient_magnitude(gx, gy), patch=8, capacity=512)
        n_lvl = 4 if min(g0.shape) >= 240 else 3
        pyr0 = [l[..., 0] for l in image_ops.build_pyramid(g0, n_lvl)[0]]
        pyr1 = [l[..., 0] for l in image_ops.build_pyramid(g1, n_lvl)[0]]
        uv1, ok, _ = klt.klt_track_pyramid(pyr0, pyr1, uv0)
        m = mask & ok
        # baseline overrun: track survival collapsed -> re-anchor the pair
        n_cand = float(mask.sum())
        if n_cand > 0 and float(m.sum()) < 0.2 * n_cand:
            return False
        # parallax gate: hold the anchor until the median displacement
        # carries real parallax
        disp = torch.linalg.vector_norm(uv1 - uv0, dim=-1)
        if float(masked_median(disp, m)) \
                < self.cfg.initializer.min_bootstrap_parallax_px:
            return "wait"

        cam = self.cam
        nc0 = torch.stack([(uv0[:, 0] - cam.cx) / cam.fx,
                           (uv0[:, 1] - cam.cy) / cam.fy], -1)
        nc1 = torch.stack([(uv1[:, 0] - cam.cx) / cam.fx,
                           (uv1[:, 1] - cam.cy) / cam.fy], -1)
        res = initializer.bootstrap_eight_point(nc0, nc1, m,
                                                generator=self.generator)
        if not bool(res.success):
            return False
        if int(res.inliers.sum()) < self.cfg.initializer.min_inliers:
            return False

        # canonical monocular scale: median seed idepth -> 1
        med_idp = torch.clamp(masked_median(res.idepth, res.inliers),
                              min=1e-6)
        seed_idp = res.idepth / med_idp
        seed_mask = res.inliers & (seed_idp > 0.05) & (seed_idp < 20.0)
        T_21 = SE3(res.T_21.R, res.T_21.t * med_idp)
        anchor = self._world_anchor
        T1 = T_21.compose(anchor)
        self.window.insert_frame(img0, anchor, t0, is_first=True,
                                 immature_seed=(uv0, seed_idp, seed_mask))
        self.window.insert_frame(img1, T1, t1, immature_seed=None)
        self.window.trace_all(self.window.newest_slot)
        n_act = self.window.activate_points()
        # degenerate structure: discard the window, keep waiting
        if n_act < max(16, 0.05 * self.cfg.caps.max_points_per_kf):
            margs, kfs = self.window.marg_count, self.window.next_id
            self.window = self._new_window()
            self.window.marg_count = margs
            self.window.next_id = kfs
            return False
        self.window.optimize()
        self.window.rebuild_coarse_template()
        self._last_pose = T1
        self._record_boot([(t0, anchor), (t1, T1)])
        self._initialized = True
        return True

    # ------------------------------------------------------------------
    @traced("bootstrap")
    def _bootstrap_dso(self, img, time: float) -> bool:
        """DSO-style pyramid initializer (``ops.coarse_init``): frames
        accumulate until the joint pose + idepth solve snaps, then the
        window is seeded from the level-0 structure."""
        pyr, _ = image_ops.build_pyramid(
            torch.as_tensor(img, dtype=torch.float32, device=self.device),
            self.cfg.initializer.pyr_levels)
        if self._init_state is None:
            self._init_state = ci.set_first(pyr)
            self._boot_img = img
            self._boot_time = time
            return False
        self._init_state, done = ci.track_frame(
            self._init_state, pyr, self.cam, counters=self.telemetry.counters)
        if not done:
            return False
        T_10, uv0, idp0, okm = ci.extract_result(self._init_state)
        anchor = self._world_anchor
        T1 = T_10.compose(anchor)
        self.window.insert_frame(self._boot_img, anchor, self._boot_time,
                                 is_first=True,
                                 immature_seed=(uv0, idp0, okm))
        self.window.insert_frame(img, T1, time, immature_seed=None)
        self.window.trace_all(self.window.newest_slot)
        self.window.activate_points()
        self.window.optimize()
        self.window.rebuild_coarse_template()
        self._last_pose = T1
        self._record_boot([(self._boot_time, anchor), (time, T1)])
        self._initialized = True
        return True

    @traced("bootstrap")
    def _bootstrap_depthmap(self, img, time: float, depth_map) -> bool:
        """Depth-map bootstrap: an externally supplied monocular depth (a
        dense [H, W] metric depth image, or a sparse (uv [N, 2], idepth [N],
        mask [N]) tuple) seeds the first keyframe's structure, immatures and
        active points with an idepth prior, so tracking starts from frame
        one without two-view parallax."""
        dev = self.device
        if isinstance(depth_map, tuple):
            uv, idp, mask = (torch.as_tensor(a, device=dev)
                             for a in depth_map)
        else:
            g0 = torch.as_tensor(img, dtype=torch.float32, device=dev)
            gx, gy = image_ops.sobel(g0, 3)
            uv, mask = candidate_points_grid(
                image_ops.gradient_magnitude(gx, gy), patch=8,
                capacity=self.cfg.caps.max_points_per_kf)
            d = torch.as_tensor(depth_map, dtype=torch.float32, device=dev)
            ui = torch.clamp(uv[:, 0].to(torch.int32), 0, d.shape[1] - 1)
            vi = torch.clamp(uv[:, 1].to(torch.int32), 0, d.shape[0] - 1)
            z = d[vi.long(), ui.long()]
            mask = mask & torch.isfinite(z) & (z > 1e-3)
            idp = 1.0 / torch.clamp(z, min=1e-3)
        anchor = self._world_anchor
        slot = self.window.insert_frame(img, anchor, time, is_first=True,
                                        immature_seed=(uv, idp, mask))
        n = self.window.activate_seed_points(
            slot, uv, idp, mask, prior=self.cfg.bundles.idepth_fix_prior)
        if n < 16:
            return False
        self.window.rebuild_coarse_template()
        self._last_pose = anchor
        self._record_boot([(time, anchor)])
        self._initialized = True
        return True

    # ------------------------------------------------------------------
    @torch.inference_mode()
    @traced("frame")
    def process_frame(self, img, time: float, depth_map=None):
        """Feed one grayscale frame [H, W]; returns the worldToCam pose.

        depth_map: optional external depth for the ``midas`` bootstrap, a
        dense [H, W] metric depth or a sparse (uv [N, 2], idepth [N],
        mask [N]) tuple."""
        return self._frame(img, time, depth_map)

    def _frame(self, img, time: float, depth_map):
        """``process_frame``'s work, which ``EDSPipeline.process_frame``
        runs inside its own ``frame`` span."""
        if not self._initialized:
            held = self._world_anchor
            if self.cfg.tracker.bootstrap == "midas":
                if depth_map is not None and \
                        self._bootstrap_depthmap(img, time, depth_map):
                    return self._last_pose
                # no depth yet: hold at the anchor until one arrives
                self._record_pending(time)
                return held
            if self.cfg.tracker.bootstrap == "dso":
                if not self._bootstrap_dso(img, time):
                    self._record_pending(time)
                    return held
                return self._last_pose
            if self._boot_img is None:
                self._boot_img = img
                self._boot_time = time
                self._record_pending(time)
                return held
            ok = self._bootstrap(self._boot_img, self._boot_time, img, time)
            if ok == "wait":
                if self._resets == 0:
                    self.times = [time]
                else:
                    self._record_pending(time)
                return held
            if not ok:
                self._boot_img = img
                self._boot_time = time
                if self._resets == 0:
                    self.times = [time]
                else:
                    self._record_pending(time)
                return held
            return self._last_pose

        # DSO motion-hypothesis try-list (trackNewFrame)
        half = SE3.exp(0.5 * self._motion.log())
        preds = [self._last_pose,
                 self._motion.compose(self._last_pose),
                 half.compose(self._last_pose)]
        if self._lost:
            T = self.window.state.current_poses()
            s = self.window.newest_slot
            preds.append(SE3(T.R[s], T.t[s]))
        res, T_wc, best = self._track(img, preds)
        track_ok = best is not None
        if best is not None:
            res, T_wc = best[0], best[1]
            # a fit whose rms sits near the robust cutoff aligned nothing
            if best[2] > 0.75 * self.cfg.coarse.coarse_cutoff_th:
                res = res._replace(ok=torch.zeros((), dtype=torch.bool,
                                                  device=self.device))
                track_ok = False
        if track_ok:
            self._motion = T_wc.compose(self._last_pose.inverse())
            self._lost = False
            self._lost_frames = 0
            self._last_good_pose = T_wc
            self._last_rms = best[2]
            if self._first_rms is None:
                self._first_rms = best[2]
        else:
            T_wc = self._last_pose
            self._lost = True
            self._lost_frames += 1
            self.telemetry.counters["track_lost"] = \
                self.telemetry.counters.get("track_lost", 0) + 1
        self.telemetry.frame()
        self._last_pose = T_wc
        self.poses.append(T_wc)
        self.trajectory.append(_np(T_wc.inverse().t))
        self.times.append(time)
        self._frames_since_kf += 1

        rms_doubled = (track_ok and self._first_rms is not None
                       and self._last_rms > 2.0 * self._first_rms
                       and self._last_rms > 4.0)
        make_kf = False
        if not self._lost:
            make_kf = (self.window.need_new_kf(res) or rms_doubled
                       or self._frames_since_kf >= self.cfg.bundles.min_frames)
        if make_kf:
            self._add_keyframe(img, T_wc, time, res)
            self._frames_since_kf = 0
            self._first_rms = None
        elif self._lost and self._lost_frames \
                >= self.cfg.coarse.full_reset_lost_frames:
            self._full_reset()
        return T_wc

    @traced("track")
    def _track(self, img, preds):
        """The motion try-list (trackNewFrame): each hypothesis in turn
        until one's finest rms is within 1.5x the last frame's. Returns
        (result, pose, best): the first result and pose if none was ok,
        best the (result, pose, rms) of the least rms among those ok."""
        res = T_wc = None
        best = None
        its = self.cfg.coarse.max_iterations
        lm_slots = sum(its[min(l, len(its) - 1)]
                       for l in range(self.cfg.coarse.pyr_levels))
        for pred in preds:
            r, T, ok_r0 = self._hypothesis(img, pred, lm_slots)
            if not ok_r0[0] > 0.5:
                if res is None:
                    res, T_wc = r, T
                continue
            r0 = float(ok_r0[1])
            if best is None or r0 < best[2]:
                best = (r, T, r0)
            if r0 <= 1.5 * self._last_rms:
                break
        return res, T_wc, best

    @traced("track.hypothesis")
    def _hypothesis(self, img, pred, lm_slots: int):
        """One coarse track from ``pred`` and its host read: its verdict,
        finest rms and the loop passes that ran (the cutoff doublings, the
        LM's). Returns (TrackResult, T_wc, the read [4])."""
        r, T = self.window.track_frame(img, pred)
        ok_r0 = torch.cat([torch.stack([r.ok.to(torch.float32),
                                        r.residuals[0]]),
                           r.passes.sum(0).to(torch.float32)]).cpu().numpy()
        c = self.telemetry.counters
        c["track_hypotheses"] += 1
        c["coarse_cutoff_doublings"] += int(ok_r0[2])
        c["coarse_lm_passes"] += int(ok_r0[3])
        c["coarse_lm_slots"] += lm_slots
        return r, T, ok_r0

    @traced("keyframe")
    def _add_keyframe(self, img, T_wc: SE3, time: float, track_res):
        w = self.window
        aff = tuple(_np(track_res.aff)) if bool(track_res.ok) else (0.0, 0.0)
        slot = w.insert_frame(img, T_wc, time, aff=aff)
        w.trace_all(slot)
        w.activate_points()
        _, lin = w.optimize()
        self.telemetry.ba()
        w.flag_and_marginalize(lin)
        # refill from surviving frames' immatures before the template
        # rebuild when marginalization emptied a large share of the map
        n_act = int((w.state.p_status == bs.PT_ACTIVE).sum())
        if n_act < 0.7 * self.cfg.caps.max_points_per_kf:
            w.activate_points()
        w.rebuild_coarse_template()
        T = w.state.current_poses()
        self._last_pose = SE3(T.R[w.newest_slot], T.t[w.newest_slot])

    # ------------------------------------------------------------------
    def positions(self):
        return np.stack(self.trajectory)


def _normalized_model(kf_nc, kf_grad, kf_idp, kf_mask, vx):
    """The per-point brightness-change model -grad . flow of the solved
    velocity, zero on dead points, normalized like the event frame: what
    ``model_klt`` and ``epiline`` splat."""
    flow = et.compute_flow(kf_nc, vx, kf_idp)
    model = -(kf_grad[:, 0] * flow[:, 0] + kf_grad[:, 1] * flow[:, 1])
    model = torch.where(kf_mask, model, torch.zeros_like(model))
    return model / torch.sqrt(1e-3 + torch.sum(model * model))


# the packet step's static arguments of the event frame (head) and of the
# tail (the solves take ``loss_kind``)
HEAD_STATICS = ("height", "width", "num_levels", "use_time_weights",
                "blur_ksize", "interpolation")
TAIL_STATICS = ("refinement", "patch_radius", "refine_levels",
                "do_points_refinement")
# the gate's retry ladder: the first solve, the retry from the frame
# tracker's prediction, the retry from the keyframe pose
RUNGS = 3


def _event_packet_head(xs, ys, ts, ps, n_valid, fwd_maps, kf_idp, kf_mask,
                       lim, *, height, width, num_levels, use_time_weights,
                       blur_ksize, interpolation):
    """The packet step's event frame (the raster kernel, blur, levels) and
    the gate's median scene depth. ``n_valid`` is an int device scalar (or a
    Python int). Returns (frames [L, H, W], time, med_depth)."""
    ef = create_event_frame(
        xs, ys, ts, ps, n_valid, height, width, num_levels=num_levels,
        fwd_maps=fwd_maps, use_time_weights=use_time_weights,
        blur_ksize=blur_ksize, interpolation=interpolation)
    # median scene depth, clamped to the configured range: exploding depth
    # estimates must not void the translation gate
    med_depth = torch.clamp(
        masked_median(1.0 / torch.clamp(kf_idp, min=1e-6), kf_mask),
        lim["min_depth"], lim["max_depth"])
    return ef.frames, ef.time, med_depth


def _rung_solve(rung: int, ef_frames, med_depth, x, cam, iters_per_level,
                lim, loss_kind):
    """One rung of the gate's ladder: the coarse-to-fine event-to-model
    solve from the rung's start (0: the tracker state, 1: the frame
    tracker's prediction T_ef_kf = T_cw_frame o T_w_kf, 2: the keyframe
    pose) and the usability gate (Tracker.cpp:217-240: the pose step since
    the previous packet, translation relative to the keyframe's median
    depth, rotation absolute). Returns (TrackerResult, usable)."""
    prev = x["state"]
    if rung == 0:
        start = prev
    elif rung == 1:
        pred_R = x["pred_R"] @ x["kf_R"]
        pred_t = x["pred_R"] @ x["kf_t"] + x["pred_t"]
        start = prev._replace(px=pred_t, qx=lie.mat_to_quat(pred_R))
    else:
        start = prev._replace(
            px=torch.zeros_like(prev.px),
            qx=lie.quat_identity(prev.qx.dtype, prev.qx.device))
    res = et._pyramid_fused(start, ef_frames, cam, x["kf_nc"], x["kf_grad"],
                            x["kf_idp"], x["kf_weight"], x["kf_mask"],
                            iters_per_level, loss_kind, x["loss_scale"],
                            False)
    d_tau = et.pose_kf_ef(res.state).compose(
        et.pose_kf_ef(prev).inverse()).log()
    usable = (torch.isfinite(res.energy) & torch.isfinite(d_tau).all()
              & (torch.linalg.vector_norm(d_tau[:3])
                 < lim["max_step_t"] * med_depth)
              & (torch.linalg.vector_norm(d_tau[3:]) < lim["max_step_r"]))
    return res, usable


def _packet_tail(res, usable, ef_frames, ef_time, med_depth, x, cam, lim, *,
                 refinement, patch_radius, refine_levels,
                 do_points_refinement):
    """The step's tail on the last solve of the ladder: the pose-filter
    push, the warp, the configured track refinement, the Vogiatzis depth
    update and the keyframe-need statistics. Every state update is selected
    back to its input when no rung passed the gate (``torch.where``).

    Returns (state, pose_filter, depth, mask, tracks, residuals, scalars
    [usable, energy, loss_scale, n_iter, flow, alive_count, ef_time,
    med_depth], T_w_ef_R, T_w_ef_t, vx)."""
    prev, pose_filter, depth = x["state"], x["pf"], x["depth"]
    kf_uv, kf_nc, kf_grad = x["kf_uv"], x["kf_nc"], x["kf_grad"]
    kf_idp, kf_mask = x["kf_idp"], x["kf_mask"]
    new_state = et._tree_where(usable, res.state, prev)
    pf_pushed = et.pose_filter_push(pose_filter, et.pose_kf_ef(res.state))
    new_pf = et._tree_where(usable, pf_pushed, pose_filter)
    T_w_ef = SE3(x["kf_R"], x["kf_t"]).compose(et.pose_filter_mean(new_pf))

    # warp, then the configured track refinement: device work on every
    # packet (its results are selected by ``usable`` below like the rest)
    uv_ef, alive = et.warp_coords(res.state, cam, kf_nc, kf_idp, kf_mask)
    if refinement in ("klt", "klt_pyr"):
        delta, _ = et.refine_tracks_klt(
            ef_frames[0], uv_ef, kf_grad, alive, patch_radius=patch_radius,
            num_levels=(refine_levels if refinement == "klt_pyr" else 1))
        uv_ef = uv_ef + delta
    elif refinement in ("model_klt", "epiline"):
        model = _normalized_model(kf_nc, kf_grad, kf_idp, kf_mask,
                                  res.state.vx)
        if refinement == "model_klt":
            delta, _ = et.refine_tracks_model_klt(
                ef_frames[0], uv_ef, model, alive, patch_radius=patch_radius)
            uv_ef = uv_ef + delta
        else:
            uv_ef, alive = et.refine_tracks_epiline(
                ef_frames[0], kf_uv, uv_ef, model, alive,
                et.pose_kf_ef(res.state), cam, patch_radius=patch_radius,
                search_range=lim["search_range"],
                consistency_px=lim["consistency_px"])
    tracks = uv_ef - kf_uv
    depth_new = df.update(depth, et.pose_kf_ef(res.state), kf_uv, tracks,
                          cam, mu_range=lim["mu_range"],
                          px_noise=lim["px_noise"], mask=alive)
    mask_new = alive
    if do_points_refinement:
        # drop points without nearby event activity (pointsRefinement)
        mask_new = mask_new & (kfm.event_activity(ef_frames[0], kf_uv)
                               > lim["activity_th"])
    depth_out = et._tree_where(usable, depth_new, depth)
    mask_out = torch.where(usable, mask_new, kf_mask)
    f32 = torch.float32
    scalars = torch.stack([
        usable.to(f32), res.energy, res.loss_scale.to(f32),
        res.n_iter.to(f32), et.mean_flow_magnitude(uv_ef, kf_uv, alive),
        mask_out.sum().to(f32), ef_time.to(f32), med_depth])
    return (new_state, new_pf, depth_out, mask_out, tracks, res.residuals,
            scalars, T_w_ef.R, T_w_ef.t, res.state.vx)


def gate_ladder(x, cam, iters, lim, statics):
    """The packet step as JAX's ``_event_packet_fused`` runs it: the head
    (event frame, median depth), rung 0's solve and gate, rung 1's solve
    where no rung passed yet, rung 2's solve where still none passed, and
    the tail once, on the last solve and ``usable = usable0 | usable1 |
    usable2``. The retries are ``graphs.cond``s, rung 2's inside rung 1's
    (JAX's ``lax.cond``s): IF nodes in the captured program, host ``if``s
    eagerly. A retry's body selects its solve by ``~usable`` itself, so
    running it where a rung passed leaves the carry as it was.

    ``x``: ``EDSPipeline.packet_inputs``. Returns (the tail's outputs
    (``_packet_tail``), the rungs run as an int32 device scalar)."""
    head_kw = {k: statics[k] for k in HEAD_STATICS}
    tail_kw = {k: statics[k] for k in TAIL_STATICS}
    frames, time, med = _event_packet_head(
        x["xs"], x["ys"], x["ts"], x["ps"], x["n_valid"], x["fwd_maps"],
        x["kf_idp"], x["kf_mask"], lim, **head_kw)

    def retry(rung):
        def body(carry):
            res, usable, rungs = carry
            new, ok = _rung_solve(rung, frames, med, x, cam, iters, lim,
                                  statics["loss_kind"])
            carry = (pytree.tree_map(lambda a, b: torch.where(usable, a, b),
                                     res, new), usable | ok,
                     rungs + (~usable).to(torch.int32))
            if rung + 1 < RUNGS:
                carry = graphs.cond(~carry[1], retry(rung + 1), carry)
            return carry
        return body

    res, usable = _rung_solve(0, frames, med, x, cam, iters, lim,
                              statics["loss_kind"])
    carry = graphs.cond(~usable, retry(1), (res, usable, torch.ones(
        (), dtype=torch.int32, device=usable.device)))
    res, usable, rungs = carry
    return _packet_tail(res, usable, frames, time, med, x, cam, lim,
                        **tail_kw), rungs


def read_packet(out, rungs):
    """The packet step's one host read: the scalar vector, event-frame pose,
    velocity and rungs run in one copy. Returns (numpy [scalars (8), t_wef
    (3), R_wef (9), vx (6)], rungs run)."""
    host = torch.cat([out[6], out[8], out[7].reshape(-1), out[9],
                      rungs.to(torch.float32)[None]]).cpu().numpy()
    return host[:-1], int(host[-1])


def _event_packet_fused(tracker_state, pose_filter, depth, cam,
                        kf_pose_R, kf_pose_t, frame_pred_R, frame_pred_t,
                        kf_uv, kf_nc, kf_grad, kf_idp, kf_weight, kf_mask,
                        xs, ys, ts, ps, n_valid, fwd_maps,
                        iters_per_level, loss_scale, lim, *,
                        height, width, num_levels, use_time_weights,
                        blur_ksize, interpolation, loss_kind, refinement,
                        patch_radius, refine_levels, do_points_refinement):
    """The whole per-packet event step, eagerly, with the JAX function's
    arguments: ``gate_ladder``, the program ``EDSPipeline.process_events``
    runs, and its host read.

    lim: {mu_range, min_depth, max_depth, px_noise, max_step_t, max_step_r,
    activity_th, search_range, consistency_px} as floats. Returns (the
    outputs (``_packet_tail``), the number of rungs run)."""
    if refinement not in TRACK_REFINEMENTS:
        raise ValueError(f"unknown track_refinement {refinement!r}")
    statics = dict(height=height, width=width, num_levels=num_levels,
                   use_time_weights=use_time_weights, blur_ksize=blur_ksize,
                   interpolation=interpolation, loss_kind=loss_kind,
                   refinement=refinement, patch_radius=patch_radius,
                   refine_levels=refine_levels,
                   do_points_refinement=do_points_refinement)
    x = {"xs": xs, "ys": ys, "ts": ts, "ps": ps, "n_valid": n_valid,
         "fwd_maps": fwd_maps, "state": tracker_state, "pf": pose_filter,
         "depth": depth, "kf_R": kf_pose_R, "kf_t": kf_pose_t,
         "pred_R": frame_pred_R, "pred_t": frame_pred_t, "kf_uv": kf_uv,
         "kf_nc": kf_nc, "kf_grad": kf_grad, "kf_idp": kf_idp,
         "kf_weight": kf_weight, "kf_mask": kf_mask, "loss_scale": loss_scale}
    out, rungs = gate_ladder(x, cam, iters_per_level, lim, statics)
    return out, read_packet(out, rungs)[1]


@dataclass
class EDSPipeline:
    """Full event-aided loop: the event front-end tracks the pose against the
    newest keyframe's generative model at packet rate; frames keep the DSO
    backend (window BA) alive and provide the keyframe images."""
    cam: Pinhole
    cfg: EDSConfig = field(default_factory=EDSConfig)
    device: str = "cuda"
    photometric: object = None

    def __post_init__(self):
        if self.cfg.tracker.track_refinement not in TRACK_REFINEMENTS:
            raise ValueError(f"unknown track_refinement "
                             f"{self.cfg.tracker.track_refinement!r}")
        self.frame_pipe = FrameOnlyPipeline(self.cam, self.cfg,
                                            device=self.device,
                                            photometric=self.photometric)
        self.device = self.frame_pipe.device
        self.kf: Optional[kfm.KeyFrame] = None
        self.depth: Optional[df.DepthFilterState] = None
        self.tracker_state = et.initial_tracker_state(self.device)
        self.loss_scale = self.cfg.tracker.loss.param
        self.pose_filter = et.pose_filter_init(
            self.cfg.tracker.pose_filter_window, self.device)
        self.event_poses: List[np.ndarray] = []   # camToWorld t per solve
        self.event_pose_list: List[SE3] = []
        self.telemetry = Telemetry()
        self._pending_kf = False
        self._seen_resets = 0
        self._kf_n_initial = 0
        self.num_event_kfs = 0
        self.recorder = (Recorder(self.cfg.recorder)
                         if self.cfg.recorder.enabled else None)

    # ------------------------------------------------------------------
    @torch.inference_mode()
    @traced("frame")
    def process_frame(self, img, time: float, depth_map=None):
        T_wc = self.frame_pipe._frame(img, time, depth_map)
        if self.frame_pipe._resets != self._seen_resets:
            # the backend discarded its map: the event keyframe and its
            # depth filter refer to it
            self._seen_resets = self.frame_pipe._resets
            self.kf = None
            self.depth = None
            self.tracker_state = et.initial_tracker_state(self.device)
            self.pose_filter = et.pose_filter_init(
                self.cfg.tracker.pose_filter_window, self.device)
        if self.frame_pipe._initialized and (self.kf is None
                                             or self._pending_kf):
            self._make_event_keyframe(img, time, T_wc)
            self._pending_kf = False
        return T_wc

    def _ba_seed_points(self, T_wc: SE3):
        """The BA window's active points projected into the new keyframe.
        Returns (uv [P, 2], idp [P], mask [P]) or None."""
        st = self.frame_pipe.window.state
        active = st.p_status == bs.PT_ACTIVE
        if int(active.sum()) <= 16:
            return None
        T = st.current_poses()
        host = st.p_host.long()
        cam = self.cam
        x = (st.p_uv[:, 0] - cam.cx) / cam.fx
        y = (st.p_uv[:, 1] - cam.cy) / cam.fy
        z = 1.0 / torch.clamp(st.p_idepth, min=1e-6)
        Xw = SE3(T.R[host], T.t[host]).inverse().apply(
            torch.stack([x * z, y * z, z], -1))
        return self._project_seed(Xw, active, T_wc)

    def _project_seed(self, Xw, ok, T_wc: SE3):
        """World points -> (uv, idepth, mask) in the camera at T_wc; seeds
        outside the depth range (2x slack) are dropped."""
        cam = self.cam
        Xk = T_wc.apply(Xw)
        z = torch.clamp(Xk[:, 2], min=1e-6)
        u = cam.fx * Xk[:, 0] / z + cam.cx
        v = cam.fy * Xk[:, 1] / z + cam.cy
        ok = ok & (Xk[:, 2] > 1e-6) & (u >= 0) & (v >= 0) \
            & (u <= cam.width - 1) & (v <= cam.height - 1) \
            & (Xk[:, 2] > 0.5 * self.cfg.mapping.min_depth) \
            & (Xk[:, 2] < 2.0 * self.cfg.mapping.max_depth)
        return torch.stack([u, v], -1), 1.0 / z, ok

    def _filter_seed_points(self, T_wc: SE3):
        """Converged depth-filter points of the outgoing event keyframe,
        transported into the new keyframe."""
        if self.kf is None or self.depth is None:
            return None
        kf = self.kf
        mp = self.cfg.mapping
        conv = df.converged(self.depth, mp.max_depth - mp.min_depth,
                            mp.convergence_sigma2_thresh)
        ok = kf.mask & conv
        if int(ok.sum()) <= 16:
            return None
        z = 1.0 / torch.clamp(self.depth.mu, min=1e-6)
        X = torch.stack([kf.norm_coord[:, 0] * z,
                         kf.norm_coord[:, 1] * z, z], -1)
        return self._project_seed(kf.pose.apply(X), ok, T_wc)

    @traced("event_keyframe")
    def _make_event_keyframe(self, img, time: float, T_wc: SE3):
        """New EDS keyframe (KeyFrame::create + Tracker::reset), its depth
        seeded from the BA map and the previous keyframe's converged
        depth-filter points."""
        cfg = self.cfg
        seeds = [s for s in (self._ba_seed_points(T_wc),
                             self._filter_seed_points(T_wc)) if s is not None]
        depth_map = None
        if seeds:
            depth_map = tuple(torch.cat([s[i] for s in seeds], 0)
                              for i in range(3))
        self.kf = kfm.create_keyframe(
            img, self.cam, capacity=cfg.caps.max_points_per_kf,
            percent_points=cfg.keyframe.percent_points,
            selection_mode=cfg.keyframe.selection_mode,
            log_eps=cfg.keyframe.log_eps,
            sobel_ksize=cfg.keyframe.sobel_ksize, depth_map=depth_map,
            init_depth=0.5 * (cfg.mapping.min_depth + cfg.mapping.max_depth),
            T_w_kf=T_wc.inverse(), time=time, device=self.device)
        if depth_map is not None:
            # drop points whose nearest map point is distant (cleanPoints)
            self.kf = kfm.clean_points(self.kf, cfg.keyframe.min_weight_clean)
        self._kf_n_initial = int(self.kf.n_initial)
        self.num_event_kfs += 1
        self.depth = df.init_from_prior(self.kf.idepth, cfg.mapping.min_depth,
                                        cfg.mapping.max_depth,
                                        cfg.mapping.init_a, cfg.mapping.init_b,
                                        device=self.device)
        # keep the velocity across keyframes; restart the pose and the pose
        # filter, whose tangents are relative to the old keyframe
        st = self.tracker_state
        self.tracker_state = st._replace(
            px=torch.zeros_like(st.px),
            qx=lie.quat_identity(st.qx.dtype, self.device))
        self.pose_filter = et.pose_filter_init(
            cfg.tracker.pose_filter_window, self.device)

    # ------------------------------------------------------------------
    def _packet_step_args(self):
        """The packet step's limits, per-level iteration caps and static
        options, built once."""
        if getattr(self, "_psa", None) is not None:
            return self._psa
        cfg = self.cfg
        lim = {
            "mu_range": cfg.mapping.max_depth - cfg.mapping.min_depth,
            "min_depth": cfg.mapping.min_depth,
            "max_depth": cfg.mapping.max_depth,
            "px_noise": cfg.mapping.px_noise,
            "max_step_t": cfg.tracker.max_step_translation,
            "max_step_r": cfg.tracker.max_step_rotation,
            "activity_th": cfg.keyframe.refinement_activity_th,
            "search_range": cfg.tracker.refinement_search_range,
            "consistency_px": cfg.tracker.refinement_consistency_px,
        }
        its = cfg.tracker.max_iterations
        iters = [its[min(lvl, len(its) - 1)]
                 for lvl in range(cfg.event_frame.num_levels)]
        statics = dict(
            height=self.cam.height, width=self.cam.width,
            num_levels=cfg.event_frame.num_levels,
            use_time_weights=cfg.event_frame.time_weighted,
            blur_ksize=cfg.event_frame.gaussian_blur_ksize,
            interpolation=cfg.event_frame.interpolation,
            loss_kind=cfg.tracker.loss.kind,
            refinement=cfg.tracker.track_refinement,
            patch_radius=cfg.tracker.refinement_patch_radius,
            refine_levels=cfg.tracker.refinement_pyr_levels,
            do_points_refinement=cfg.keyframe.points_refinement)
        self._psa = (lim, iters, statics)
        return self._psa

    @traced("packet.upload")
    def _upload(self, packet):
        """The packet's (x, y, t, polarity) arrays and its live count on the
        device, the count as an int32 scalar (data, as in JAX: a captured
        step serves every packet); on a card through pinned memory without
        a synchronizing copy. Returns (xs, ys, ts, ps, n_valid)."""
        host = torch.from_numpy(np.stack([packet.xs, packet.ys, packet.ts,
                                          packet.polarity]).astype(np.float32))
        n = torch.tensor([int(packet.n_valid)], dtype=torch.int32)
        if self.device.type == "cuda":
            host = host.pin_memory().to(self.device, non_blocking=True)
            n = n.pin_memory().to(self.device, non_blocking=True)
        else:
            host, n = host.to(self.device), n.to(self.device)
        return (*host.unbind(0), n.reshape(()))

    @torch.inference_mode()
    @traced("packet")
    def process_events(self, packet, fwd_maps=None):
        """Feed one EventPacket. Returns the worldToCam pose of the event
        frame, or None before initialization and for a rejected solve.

        fwd_maps: optional (fwd_x, fwd_y) [H, W] per-event undistortion
        tables (``utils.cameras.forward_maps``); tensors already on the
        pipeline's device are used as they are.

        The step is ``gate_ladder``: on the card one captured program
        (``graphs``) whose retries are IF nodes, on the CPU the same
        function eagerly. Host reads: 1 per packet, whatever the retries
        (``telemetry.counters``: ``event_scalar_host_reads`` counts the
        step's read of its scalars, ``event_retries`` the retries; the LM
        reads nothing, ``event_lm_host_reads`` stays 0). Run eagerly, each
        retry's ``if`` reads its predicate too.
        """
        if self.kf is None:
            return None
        c = self.telemetry.counters
        lim, iters, statics = self._packet_step_args()
        c["event_packets"] += 1
        c["event_lm_host_reads"] += 0
        out, rungs = self._run_packet(self.packet_inputs(packet, fwd_maps),
                                      lim, iters, statics)
        with TRACE.span("packet.read"):
            host, rungs = read_packet(out, rungs)
        c["event_scalar_host_reads"] += 1
        c["event_retries"] += rungs - 1
        if not host[0] > 0.5:
            # rejected solve: the step already selected every state back
            c["event_solve_rejected"] += 1
            self._pending_kf = True
            return None
        return self._adopt(out, host)

    @traced("packet.adopt")
    def _adopt(self, out, host):
        """An accepted solve: copies of the step's outputs become the
        tracker's state, the host scalars ``host`` its bookkeeping. Returns
        the worldToCam pose of the event frame."""
        (state, pf, depth, mask, tracks, residuals, _, R_wef, t_wef, _) = out
        sc = host[:8]
        # adopt copies: a captured program's outputs are overwritten by its
        # next replay
        (state, pf, depth, mask, tracks, residuals, R_wef, t_wef) = \
            copy_out((state, pf, depth, mask, tracks, residuals, R_wef,
                      t_wef))
        self.tracker_state = state
        self.pose_filter = pf
        self.depth = depth
        if self.cfg.tracker.loss.scale_estimator == "mad":
            self.loss_scale = float(sc[2])
        self.telemetry.event_solve(n_iter=int(sc[3]))

        T_w_ef = SE3(R_wef, t_wef)
        self.event_poses.append(host[8:11].copy())
        self.event_pose_list.append(T_w_ef.inverse())
        if self.recorder is not None:
            ef_time = float(sc[6])
            self.recorder.record_pose(
                ef_time, SE3(host[11:20].reshape(3, 3), host[8:11]))
            self.recorder.record_velocity(ef_time, host[20:])
        self.kf = self.kf._replace(mask=mask, track=tracks,
                                   residual=residuals, idepth=depth.mu)
        # the event tracker seeds the frame front-end's next coarse track,
        # but not while the frame tracker is lost
        if self.cfg.tracker.seed_frame_tracker and not self.frame_pipe._lost:
            self.frame_pipe._last_pose = T_w_ef.inverse()
        # keyframe need from flow magnitude / point loss, consumed at the
        # next frame
        flow, alive_count = float(sc[4]), float(sc[5])
        if flow > self.cfg.tracker.kf_flow_threshold ** 2 or \
                alive_count < (1.0 - self.cfg.keyframe.kf_point_loss_percent) \
                * self._kf_n_initial:
            self._pending_kf = True
        return T_w_ef.inverse()

    def packet_inputs(self, packet, fwd_maps=None):
        """The first rung's inputs for ``packet`` at the pipeline's current
        state: a dict of device tensors (the packet uploaded, its live count
        an int32 device scalar, the loss scale a float32 one)."""
        if fwd_maps is not None:
            fwd_maps = tuple(torch.as_tensor(m, dtype=torch.float32,
                                             device=self.device)
                             for m in fwd_maps)
        kf = self.kf
        pred = self.frame_pipe._last_pose
        xs, ys, ts, ps, n_valid = self._upload(packet)
        return {"xs": xs, "ys": ys, "ts": ts, "ps": ps, "n_valid": n_valid,
                "fwd_maps": fwd_maps, "state": self.tracker_state,
                "pf": self.pose_filter, "depth": self.depth,
                "kf_R": kf.T_w_kf_R, "kf_t": kf.T_w_kf_t, "pred_R": pred.R,
                "pred_t": pred.t, "kf_uv": kf.uv, "kf_nc": kf.norm_coord,
                "kf_grad": kf.grad, "kf_idp": kf.idepth,
                "kf_weight": kf.weight, "kf_mask": kf.mask,
                "loss_scale": torch.full((), self.loss_scale,
                                         dtype=torch.float32,
                                         device=self.device)}

    def _run_packet(self, x, lim, iters, statics):
        """The packet step (``gate_ladder``) through ``graphs.run``; its
        outputs are the program's own (``_adopt`` copies what it keeps).
        Returns (the tail's outputs, the rungs run as a device scalar)."""
        cam = self.cam

        def program(x):
            return gate_ladder(x, cam, iters, lim, statics)
        key = ("event_packet", tuple(cam), tuple(iters),
               tuple(sorted(lim.items())), tuple(sorted(statics.items())))
        return graphs.run(key, program, x)
