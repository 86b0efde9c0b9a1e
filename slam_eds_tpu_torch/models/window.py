"""Sliding-window manager — port of ``slam_eds_tpu.models.window``: slot
allocation, keyframe insertion, immature-point bookkeeping, point
activation, marginalization policy and coarse-template refresh.

Control decisions (which slot, how many points) run in host numpy as in the
JAX module, with its host reads; numerical work is torch on the window's
device. Every program the JAX module jits with fixed shapes is a captured
CUDA graph on the card (``graphs.run``, through ``WindowManager._program``;
eagerly on the CPU and in ``graphs.eagerly()``): ``_track_frame_compiled``
(``track_frame_program``: the relative-pose prefix, the coarse LM, the
world pose), the BA call (``ba_program``), the keyframe pyramid,
``all_pairs``, ``trace_on`` per slot pair, the activation GN
(``activate_idepth``), ``marg_points``, ``energy.marginalize_frame`` (one
program per slot) and the coarse-template rebuild
(``project_active_to_newest`` + ``build_template``).

What stays eager: ``activate_commit``, whose rows ``dst`` follow host data
(the JAX module pads them and drops the pad with ``mode="drop"``; here only
the real rows are written, so its shapes change from call to call); the
pixel selector and immature spawn of ``insert_frame``, which choose points
on the host; the slot and frame-row writes of ``insert_frame`` and the
host-side policy (``flag_and_marginalize``, ``_update_energy_th``).

While ``telemetry.TRACE`` is on, each piece of keyframe work is a span:
``keyframe.insert`` (``insert_frame``, holding ``keyframe.spawn``, the
immature spawn), ``keyframe.trace``, ``keyframe.activate``, ``keyframe.ba``
(``optimize`` with its energy read), ``keyframe.marginalize`` and
``keyframe.template``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .. import graphs
from ..config import EDSConfig
from ..telemetry import traced
from ..utils.cameras import Pinhole
from ..utils.lie import SE3
from ..utils import image as image_ops
from ..ops import distance_map as dmap
from ..ops import energy, immature, pixel_selector
from ..ops import coarse_tracker as ct
from . import ba_state as bs


def _np(x):
    return x.detach().cpu().numpy()


def all_pairs(state: bs.BAState, K):
    """Every host->target pair at the current state: KRKi [F, F, 3, 3],
    Kt [F, F, 3], aff [F, F, 2], indexed [host, target]."""
    T = state.current_poses()
    R_th = torch.einsum("tij,hkj->thik", T.R, T.R)           # [F_t, F_h]
    t_th = T.t[:, None, :] - torch.einsum("thik,hk->thi", R_th, T.t)
    Kinv = torch.linalg.inv_ex(K)[0]
    KRKi = torch.einsum("ij,thjk,kl->htil", K, R_th, Kinv)
    Kt = torch.einsum("ij,thj->hti", K, t_th)
    a_rel, b_rel = energy.relative_affine(state, use_zero=False)
    return KRKi, Kt, torch.stack([a_rel, b_rel], -1)


def track_frame_program(x, *, cams, max_iterations, huber_th, cutoff_th):
    """``track_frame``'s whole device program (JAX
    ``_track_frame_compiled``): the frame's pyramid, the relative-pose prefix
    (refToNew from the window state), ``track_newest_coarse`` and the world
    pose composition. x: {img [H, W], slot [1] int64, delta, T_eval_R,
    T_eval_t, exposure, aff_eval (the window's frame fields), templates,
    pose_R, pose_t, aff, exp_new}. Returns (TrackResult, T_wc)."""
    L = len(cams)
    pyr = image_ops.build_pyramid(x["img"], L)[0]
    T = SE3.exp(x["delta"][:, :6]).compose(SE3(x["T_eval_R"], x["T_eval_t"]))
    slot = x["slot"]
    T_kf = SE3(T.R.index_select(0, slot)[0], T.t.index_select(0, slot)[0])
    aff_kf = (x["aff_eval"] + x["delta"][:, 6:8]).index_select(0, slot)[0]
    res = ct.track_newest_coarse(
        x["templates"], pyr, cams,
        SE3(x["pose_R"], x["pose_t"]).compose(T_kf.inverse()), x["aff"],
        (x["exposure"].index_select(0, slot)[0], x["exp_new"]), aff_kf,
        # abort thresholds disabled: the pipeline's hypothesis ladder uses
        # the achieved residuals instead
        torch.full((L,), 1e9, device=slot.device),
        max_iterations=max_iterations, huber_th=huber_th,
        cutoff_th=cutoff_th)
    return res, res.pose.compose(T_kf)


def ba_program(x, *, height, width, **kw):
    """The BA call's device program: ``energy.ba_iterate`` on x = {state,
    planes}. Returns (state, energy, lin)."""
    return energy.ba_iterate(x["state"], x["planes"], height, width, **kw)


def activate_commit(state: bs.BAState, images, dst, host, uv, idp,
                    outlier_th: float, prior: float = 0.0) -> bs.BAState:
    """Write newly activated points into slots ``dst``: pattern colors and
    gradient weights sampled from each point's host image; ``prior`` is
    their idepth prior."""
    offs = image_ops.pattern(uv.dtype, uv.device)
    F_, H_, W_, C_ = images.shape
    x = uv[:, 0:1] + offs[None, :, 0]
    y = uv[:, 1:2] + offs[None, :, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx_ = x - x0
    fy_ = y - y0
    x0i = x0.long()
    y0i = y0.long()
    hl = host.long()[:, None]

    def gat(xi, yi):
        return images[hl, torch.clamp(yi, 0, H_ - 1), torch.clamp(xi, 0, W_ - 1)]

    hit = (gat(x0i, y0i) * ((1 - fx_) * (1 - fy_))[..., None]
           + gat(x0i + 1, y0i) * (fx_ * (1 - fy_))[..., None]
           + gat(x0i, y0i + 1) * ((1 - fx_) * fy_)[..., None]
           + gat(x0i + 1, y0i + 1) * (fx_ * fy_)[..., None])
    g2 = torch.sum(hit[..., 1:3] ** 2, -1)
    w = torch.sqrt(g2.new_tensor(outlier_th) / (outlier_th + g2))
    F = state.num_frames
    r_rows = state.frame_valid[None, :] & (
        torch.arange(F, device=uv.device)[None, :] != host[:, None])

    def put(a, v):
        a = a.clone()
        a[dst] = v.to(a.dtype) if torch.is_tensor(v) else v
        return a

    return state._replace(
        p_host=put(state.p_host, host),
        p_uv=put(state.p_uv, uv),
        p_idepth=put(state.p_idepth, idp),
        p_idepth_zero=put(state.p_idepth_zero, idp),
        p_color=put(state.p_color, hit[..., 0]),
        p_weight=put(state.p_weight, w),
        p_prior=put(state.p_prior, prior),
        p_status=put(state.p_status, bs.PT_ACTIVE),
        r_active=put(state.r_active, r_rows),
    )


def marg_points(state, images, marg_weight, idepth_fac, huber_th, *, height,
                width):
    """linearize + point marginalization."""
    lin = energy.linearize(state, images, height, width, huber_th=huber_th)
    return energy.marginalize_points(state, lin, marg_weight=marg_weight,
                                     idepth_prior_marg_fac=idepth_fac)


def project_active_to_newest(state, cam: Pinhole, newest_slot: int, *,
                             height, width):
    """All active points projected into the newest KF.
    Returns (uv [P, 2], idepth_new [P], ok [P])."""
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    T = state.current_poses()
    # an int, or a [1] int64 tensor (the captured rebuild's input)
    T_new = SE3(T.R[newest_slot].reshape(3, 3), T.t[newest_slot].reshape(3))
    active = state.p_status == bs.PT_ACTIVE
    host = state.p_host.long()
    Th = SE3(T.R[host], T.t[host])
    x = (state.p_uv[:, 0] - cx) / fx
    y = (state.p_uv[:, 1] - cy) / fy
    z = 1.0 / torch.clamp(state.p_idepth, min=1e-6)
    X_n = T_new.apply(Th.inverse().apply(torch.stack([x * z, y * z, z], -1)))
    u = fx * X_n[:, 0] / X_n[:, 2] + cx
    v = fy * X_n[:, 1] / X_n[:, 2] + cy
    idn = 1.0 / torch.clamp(X_n[:, 2], min=1e-6)
    ok = active & (X_n[:, 2] > 1e-6) & (u > 1) & (v > 1) \
        & (u < width - 2) & (v < height - 2)
    return torch.stack([u, v], -1), idn, ok


@dataclass
class WindowManager:
    cam: Pinhole
    cfg: EDSConfig
    device: torch.device
    state: bs.BAState = None
    images: torch.Tensor = None          # [F, H, W, 3]
    # channel 0 of images, planar and contiguous: the BA sampler's planes
    intensity: torch.Tensor = None       # [F, H, W]
    pyramids: list = None
    immatures: list = None
    frame_times: list = field(default_factory=list)
    frame_ids: list = field(default_factory=list)
    next_id: int = 0
    coarse_templates: list = None
    newest_slot: int = -1
    # [256] forward-response derivative table (PhotometricCalib.
    # b_grad_table) or None: when set, the pixel selector's squared-gradient
    # maps are weighted by bg(I)^2 per level (setting_gammaWeightsPixelSelect)
    photometric_bgrad: object = None
    marg_count: int = 0

    def __post_init__(self):
        F = self.cfg.caps.max_window_frames
        P = self.cfg.caps.max_points_per_kf
        dev = self.device = torch.device(self.device)
        calib = [self.cam.fx, self.cam.fy, self.cam.cx, self.cam.cy]
        if self.state is None:
            self.state = bs.empty_state(F, P, calib, device=dev)
        H, W = self.cam.height, self.cam.width
        self.images = torch.zeros((F, H, W, 3), dtype=torch.float32,
                                  device=dev)
        self.intensity = torch.zeros((F, H, W), dtype=torch.float32,
                                     device=dev)
        self.immatures = [None] * F
        self.frame_ids = [-1] * F
        self.frame_times = [0.0] * F
        self.K = self.cam.K(device=dev)

    @property
    def num_active_frames(self) -> int:
        return int(self.state.frame_valid.sum())

    def _free_slot(self) -> int:
        free = np.where(~_np(self.state.frame_valid))[0]
        if len(free) == 0:
            raise RuntimeError("window full — marginalize first")
        return int(free[0])

    def _pyramid(self, img):
        img = torch.as_tensor(img, dtype=torch.float32, device=self.device)
        L = self.cfg.coarse.pyr_levels
        return self._program(
            ("pyramid", L),
            lambda x: image_ops.build_pyramid(x["img"], L)[0], {"img": img})

    # ------------------------------------------------------------------
    @traced("keyframe.insert")
    def insert_frame(self, img, T_wc: SE3, time: float, aff=(0.0, 0.0),
                     exposure: float = 1.0, is_first: bool = False,
                     immature_seed=None) -> int:
        """Insert a keyframe into a free slot (FEJ point = the given pose)
        and spawn immature points from the pixel selector."""
        slot = self._free_slot()
        dev = self.device
        pyr = self._pyramid(img)
        self.pyramids = self.pyramids or [None] * self.state.num_frames
        self.pyramids[slot] = pyr
        self.images[slot] = pyr[0]
        self.intensity[slot] = pyr[0][..., 0]
        self.frame_ids[slot] = self.next_id
        self.frame_times[slot] = time
        self.next_id += 1

        st = self.state
        prior = np.zeros(8, np.float32)
        if is_first:
            prior[:3] = self.cfg.bundles.initial_trans_prior
            prior[3:6] = self.cfg.bundles.initial_rot_prior
        # affine priors pin every frame's (a, b) toward absolute zero
        prior_d0 = np.zeros(8, np.float32)
        if self.cfg.bundles.affine_opt_mode_a > 0:
            prior[6] = self.cfg.bundles.affine_opt_mode_a
            prior_d0[6] = -float(aff[0])
        if self.cfg.bundles.affine_opt_mode_b > 0:
            prior[7] = self.cfg.bundles.affine_opt_mode_b
            prior_d0[7] = -float(aff[1])

        def setrow(a, v):
            a = a.clone()
            a[slot] = torch.as_tensor(v, dtype=a.dtype, device=dev)
            return a

        r_active = st.r_active.clone()
        r_active[:, slot] = st.p_status == bs.PT_ACTIVE
        self.state = st._replace(
            T_eval=SE3(setrow(st.T_eval.R, T_wc.R), setrow(st.T_eval.t, T_wc.t)),
            aff_eval=setrow(st.aff_eval, np.asarray(aff, np.float32)),
            delta=setrow(st.delta, 0.0),
            exposure=setrow(st.exposure, exposure),
            frame_prior=setrow(st.frame_prior, prior),
            frame_prior_delta0=setrow(st.frame_prior_delta0, prior_d0),
            frame_valid=setrow(st.frame_valid, True),
            frame_energy_th=setrow(st.frame_energy_th, 1e8),
            r_active=r_active,
        )
        self.newest_slot = slot
        self._spawn_immature(slot, immature_seed)
        return slot

    @traced("keyframe.spawn")
    def _spawn_immature(self, slot: int, seed_depth=None):
        """Select candidate pixels on the new KF and make immature points
        (makeNewTraces)."""
        pyr = self.pyramids[slot]
        abs_sq = [torch.sum(l[..., 1:3] ** 2, -1) for l in pyr[:3]]
        if self.photometric_bgrad is not None:
            bg = torch.as_tensor(self.photometric_bgrad, dtype=torch.float32,
                                 device=self.device)
            gw = [bg[torch.clamp((l[..., 0] + 0.5).long(), 0, 255)]
                  for l in pyr[:3]]
            abs_sq = [a * g * g for a, g in zip(abs_sq, gw)]
        status, _, _ = pixel_selector.make_maps(
            pyr[0], abs_sq, density=self.cfg.selector.desired_immature_density,
            pot_initial=self.cfg.selector.potential_initial,
            rounds=self.cfg.selector.adaptation_rounds)
        cap = self.cfg.caps.max_immature_per_kf
        uv, _, mask = pixel_selector.status_to_points(status, abs_sq[0], cap)
        pts = immature.make_immature(pyr[0], uv, mask)
        if seed_depth is not None:
            # EDS seeding: idepth from an external depth map +-10%
            from .keyframe import nn_depth_lookup
            idp, _ = nn_depth_lookup(uv, *seed_depth)
            pts = pts._replace(idepth_min=torch.clamp(idp * 0.9, min=1e-4),
                               idepth_max=idp * 1.1)
        self.immatures[slot] = pts

    # ------------------------------------------------------------------
    def pairs(self):
        """``all_pairs`` at the window's state (its program)."""
        return self._program(("all_pairs",),
                             lambda x: all_pairs(x["state"], x["K"]),
                             {"state": self.state, "K": self.K})

    def all_pairs(self):
        """Pair tensors as numpy (one transfer)."""
        return tuple(_np(a) for a in self.pairs())

    @traced("keyframe.trace")
    def trace_all(self, target_slot: int):
        """traceOn every other frame's immature points against the target
        frame (traceNewCoarse): one program per call of ``trace_on``, which
        every slot pair replays."""
        H, W = self.cam.height, self.cam.width
        tgt = self.pyramids[target_slot][0]
        valid = _np(self.state.frame_valid)
        KRKi, Kt, aff = self.pairs()
        kw = dict(huber_th=self.cfg.bundles.huber_th,
                  energy_th=8 * self.cfg.immature.outlier_th,
                  max_pix_search_frac=self.cfg.immature.max_pix_search)

        def trace(x):
            return immature.trace_on(x["pts"], x["tgt"], x["KRKi"], x["Kt"],
                                     x["aff"], W, H, **kw)
        for slot in range(self.state.num_frames):
            if slot == target_slot or self.immatures[slot] is None \
                    or not valid[slot]:
                continue
            self.immatures[slot] = self._program(
                ("trace_on", W, H, tuple(sorted(kw.items()))), trace,
                {"pts": self.immatures[slot], "tgt": tgt,
                 "KRKi": KRKi[slot, target_slot],
                 "Kt": Kt[slot, target_slot], "aff": aff[slot, target_slot]})

    # ------------------------------------------------------------------
    def _activation_distance_map(self, pairs_np):
        """Level-1 distance map from the active points' projections into
        the newest keyframe (CoarseDistanceMap::makeDistanceMap)."""
        st = self.state
        H, W = self.cam.height, self.cam.width
        active = _np(st.p_status) == bs.PT_ACTIVE
        uvs = _np(st.p_uv)
        proj = np.array(uvs)
        if self.newest_slot >= 0:
            KRKi_all, Kt_all, _ = pairs_np
            idp = _np(st.p_idepth)
            hosts = _np(st.p_host)
            for slot in range(st.num_frames):
                sel = (hosts == slot) & active
                if slot == self.newest_slot or not sel.any():
                    continue
                xyz = (KRKi_all[slot, self.newest_slot] @ np.stack(
                    [uvs[sel, 0], uvs[sel, 1], np.ones(sel.sum())])).T \
                    + Kt_all[slot, self.newest_slot][None, :] * idp[sel, None]
                proj[sel, 0] = xyz[:, 0] / np.maximum(xyz[:, 2], 1e-6)
                proj[sel, 1] = xyz[:, 1] / np.maximum(xyz[:, 2], 1e-6)
        return dmap.coarse_distance_map(
            torch.as_tensor(proj, dtype=torch.float32,
                            device=self.device) * 0.5,
            torch.as_tensor(active, device=self.device), H // 2, W // 2,
            max_dist=40)

    @traced("keyframe.activate")
    def activate_points(self, max_new: Optional[int] = None):
        """Promote well-traced immature points into free BA point slots
        (activatePointsMT): GOOD/SKIPPED, quality above threshold, finite
        positive interval, spatially gated by the distance map with the
        activation distance adapted to the active-point count."""
        st = self.state
        dev = self.device
        status_np = _np(st.p_status)
        free = np.where(status_np == bs.PT_EMPTY)[0]
        budget = len(free) if max_new is None else min(len(free), max_new)
        if budget == 0:
            return 0

        n_active = int((status_np == bs.PT_ACTIVE).sum())
        ratio = n_active / max(self.cfg.selector.desired_point_density, 1.0)
        res_scale = self.cam.width / 640.0
        self.min_act_dist = float(np.clip(4.0 * (ratio - 0.4) / 0.6,
                                          0.0, 4.0)) * res_scale

        F = st.num_frames
        valid_np = _np(st.frame_valid)
        pairs_t = self.pairs()
        pairs_np = tuple(_np(a) for a in pairs_t)
        dist_np = _np(self._activation_distance_map(pairs_np))

        live = [s for s in range(F)
                if self.immatures[s] is not None and valid_np[s]]
        if not live:
            return 0
        # one stacked activation GN over all F slot lanes (dead slots ride
        # along fully masked)
        filler = self.immatures[live[0]]
        pts_list = [self.immatures[s] if s in live
                    else filler._replace(mask=torch.zeros_like(filler.mask))
                    for s in range(F)]
        pts_stack = immature.ImmaturePoints(*(torch.stack(xs)
                                              for xs in zip(*pts_list)))
        tmask_np = np.stack([(valid_np & (np.arange(F) != s)) if s in live
                             else np.zeros(F, bool) for s in range(F)])
        KRKi_t, Kt_t, aff_t = pairs_t
        gn_its = self.cfg.immature.gn_its_on_activation
        idp_all, _ = self._program(
            ("activate_idepth", gn_its),
            lambda x: immature.activate_idepth(
                x["pts"], x["images"], x["KRKi"], x["Kt"], x["aff"],
                x["tmask"], gn_iterations=gn_its),
            {"pts": pts_stack, "images": self.images, "KRKi": KRKi_t,
             "Kt": Kt_t, "aff": aff_t,
             "tmask": torch.as_tensor(tmask_np, device=dev)})
        status_s, quality_s, lo_s, hi_s, mask_s, uv_s, idp_s = (
            _np(a) for a in (pts_stack.status, pts_stack.quality,
                             pts_stack.idepth_min, pts_stack.idepth_max,
                             pts_stack.mask, pts_stack.uv, idp_all))
        KRKi_np, Kt_np, _ = pairs_np

        total = 0
        sel_dst, sel_host, sel_uv, sel_idp = [], [], [], []
        dh, dw = dist_np.shape
        for slot in range(F):
            good = mask_s[slot] & np.isin(status_s[slot],
                                          [immature.IPS_GOOD,
                                           immature.IPS_SKIPPED])
            good &= quality_s[slot] > self.cfg.immature.min_trace_quality
            good &= np.isfinite(hi_s[slot]) & (hi_s[slot] > 0) \
                & ((hi_s[slot] + lo_s[slot]) > 0)
            cand = np.where(good)[0]
            if len(cand) == 0:
                continue
            uv_c = uv_s[slot][cand]
            idp_c = 0.5 * (lo_s[slot][cand] + hi_s[slot][cand])
            if slot != self.newest_slot and self.newest_slot >= 0:
                xyz = (KRKi_np[slot, self.newest_slot] @ np.stack(
                    [uv_c[:, 0], uv_c[:, 1], np.ones(len(cand))])).T \
                    + Kt_np[slot, self.newest_slot][None, :] * idp_c[:, None]
                uv_c = xyz[:, :2] / np.maximum(xyz[:, 2:3], 1e-6)
            ix = np.clip(np.round(uv_c[:, 0] * 0.5).astype(int), 0, dw - 1)
            iy = np.clip(np.round(uv_c[:, 1] * 0.5).astype(int), 0, dh - 1)
            spaced = dist_np[iy, ix] >= self.min_act_dist
            if spaced.any():
                cand = cand[spaced]
            take = cand[: budget - total]
            if len(take) == 0:
                break
            sel_dst.append(free[total: total + len(take)])
            sel_host.append(np.full(len(take), slot, np.int32))
            sel_uv.append(uv_s[slot][take])
            sel_idp.append(np.maximum(idp_s[slot][take], 1e-4))
            m = np.array(mask_s[slot])
            m[take] = False
            self.immatures[slot] = self.immatures[slot]._replace(
                mask=torch.as_tensor(m, device=dev))
            total += len(take)
            if total >= budget:
                break
        if total == 0:
            return 0

        def cat(parts, dtype):
            return torch.as_tensor(np.concatenate(parts), dtype=dtype,
                                   device=dev)

        self.state = activate_commit(
            st, self.images, cat(sel_dst, torch.int64),
            cat(sel_host, torch.int32), cat(sel_uv, torch.float32),
            cat(sel_idp, torch.float32),
            outlier_th=self.cfg.bundles.outlier_th_sum_component)
        return total

    # ------------------------------------------------------------------
    def activate_seed_points(self, slot: int, uv, idp, mask,
                             prior: float = 2500.0,
                             max_new: Optional[int] = None) -> int:
        """Promote externally seeded points (the depth-map bootstrap)
        straight into free BA point slots of host frame ``slot``, with an
        idepth prior. uv [N, 2], idp [N], mask [N]; returns how many."""
        dev = self.device
        st = self.state
        idp = torch.as_tensor(idp, dtype=torch.float32, device=dev)
        uv = torch.as_tensor(uv, dtype=torch.float32, device=dev)
        ok = torch.as_tensor(mask, device=dev) & torch.isfinite(idp) \
            & (idp > 1e-4)
        # one read: the free slots and the usable seeds
        free = torch.nonzero(st.p_status == bs.PT_EMPTY)[:, 0]
        take = torch.nonzero(ok)[:, 0]
        n = min(len(free) if max_new is None else min(len(free), max_new),
                len(take))
        if n == 0:
            return 0
        take = take[:n]
        self.state = activate_commit(
            st, self.images, free[:n],
            torch.full((n,), slot, dtype=torch.int32, device=dev), uv[take],
            torch.clamp(idp[take], min=1e-4),
            outlier_th=self.cfg.bundles.outlier_th_sum_component, prior=prior)
        return n

    # ------------------------------------------------------------------
    def _program(self, key, fn, x):
        """``fn(x)`` as the step ``key`` (``graphs.run``), its outputs
        copied out (the next replay overwrites them)."""
        return graphs.copy_out(graphs.run(key, fn, x))

    def ba_inputs(self, iterations: Optional[int] = None):
        """(x, kw) of the BA call at the window's state: ``ba_program``'s
        inputs and static arguments."""
        b = self.cfg.bundles
        kw = dict(height=self.cam.height, width=self.cam.width,
                  iterations=iterations or b.max_opt_iterations,
                  lam=b.fix_lambda, huber_th=b.huber_th,
                  outlier_th_sum=b.outlier_th_sum_component,
                  orth_from_iteration=b.orthogonalize_x_from_it,
                  min_iterations=b.min_opt_iterations,
                  break_tol=b.opt_break_tol)
        return {"state": self.state, "planes": self.intensity}, kw

    def run_ba(self, x, kw):
        """``ba_program(x, **kw)`` (``_program``: one per (F, P, H, W,
        iterations))."""
        return self._program(("ba", tuple(sorted(kw.items()))),
                             lambda x: ba_program(x, **kw), x)

    @traced("keyframe.ba")
    def optimize(self, iterations: Optional[int] = None):
        """Run the window BA (``run_ba``); returns (energy, lin)."""
        self.state, e, lin = self.run_ba(*self.ba_inputs(iterations))
        self._update_energy_th(lin)
        return float(e), lin

    def _update_energy_th(self, lin):
        """Per-frame energy threshold from the quantile of active residual
        energies (setNewFrameEnergyTH analog; host numpy)."""
        e = _np(lin.energy)
        v = _np(lin.valid)
        th = _np(self.state.frame_energy_th).copy()
        b = self.cfg.bundles
        for f in range(self.state.num_frames):
            ef = e[:, f][v[:, f]]
            if len(ef) > 16:
                q = np.quantile(np.sqrt(ef), b.frame_energy_th_n)
                t = (q * b.frame_energy_th_fac_median) ** 2
                w = b.frame_energy_th_const_weight
                th[f] = w * t + (1 - w) * th[f] if np.isfinite(th[f]) else t
                th[f] = max(th[f], 8 * b.huber_th ** 2)
        self.state = self.state._replace(frame_energy_th=torch.as_tensor(
            th, device=self.device))

    # ------------------------------------------------------------------
    @traced("keyframe.marginalize")
    def flag_and_marginalize(self, lin):
        """Point flagging + frame marginalization policy, after BA."""
        st = self.state
        F = st.num_frames
        # a residual whose projection left the frame is removed for good
        st = st._replace(r_active=st.r_active & ~lin.oob)
        self.state = st
        n_res = _np(lin.valid & ~lin.oob).sum(axis=1)
        status = _np(st.p_status)
        host = _np(st.p_host)
        active = status == bs.PT_ACTIVE
        valid_f = _np(st.frame_valid)

        slots = [s for s in range(F) if valid_f[s]]
        marg_slot = None
        if len(slots) > self.cfg.bundles.window_size:
            support = {s: (active & (host == s)).sum() for s in slots}
            initial = {s: max(int((host == s).sum()), 1) for s in slots}
            by_age = sorted(slots, key=lambda s: self.frame_ids[s])
            newest_id = self.frame_ids[by_age[-1]]
            candidates = by_age[:-2] if len(by_age) > 2 else by_age[:1]
            candidates = [s for s in candidates
                          if newest_id - self.frame_ids[s]
                          >= self.cfg.bundles.min_frame_age] or candidates[:1]
            aff_np = _np(st.current_aff())
            exp_np = _np(st.exposure)
            newest = by_age[-1]

            def log_aff_fac(s):
                return abs(float(aff_np[s, 0] - aff_np[newest, 0]
                                 + np.log(max(exp_np[s], 1e-12)
                                          / max(exp_np[newest], 1e-12))))

            weak = [s for s in candidates
                    if support[s] < self.cfg.bundles.min_points_remaining
                    * max(initial[s], 1)
                    or log_aff_fac(s)
                    > self.cfg.bundles.max_log_aff_fac_in_window]
            if weak:
                marg_slot = weak[0]
            else:
                # DSO's pairwise distance score (flagFramesForMarginalization)
                T = st.current_poses()
                R_wc = np.swapaxes(_np(T.R), -1, -2)
                t_wc = -np.einsum("fij,fj->fi", R_wc, _np(T.t))
                newest = self.newest_slot
                others = [s for s in slots if s != newest]
                best = -np.inf
                for i in candidates:
                    ssum = sum(1.0 / (1e-5 + np.linalg.norm(t_wc[i] - t_wc[j]))
                               for j in others if j != i)
                    sc = -np.sqrt(np.linalg.norm(t_wc[i] - t_wc[newest])) \
                        * ssum
                    if sc > best:
                        best, marg_slot = sc, i

        new_status = status.copy()
        new_status[active & (n_res < 1)] = bs.PT_DROP
        if marg_slot is not None:
            of_frame = active & (host == marg_slot)
            n_marg = self.cfg.bundles.min_good_res_for_marg
            new_status[of_frame & (n_res >= n_marg)] = bs.PT_MARGINALIZE
            new_status[of_frame & (n_res < n_marg)] = bs.PT_DROP

        dropped = new_status == bs.PT_DROP
        new_status[dropped] = bs.PT_EMPTY
        dev = self.device
        self.state = st._replace(
            p_status=torch.as_tensor(new_status, device=dev),
            r_active=st.r_active
            & ~torch.as_tensor(dropped, device=dev)[:, None])

        H, W = self.cam.height, self.cam.width
        if (new_status == bs.PT_MARGINALIZE).any():
            b = self.cfg.bundles
            args = (b.marg_weight_fac, b.idepth_fix_prior_marg_fac,
                    b.huber_th)
            self.state = self._program(
                ("marg_points", *args, H, W),
                lambda x: marg_points(x["state"], x["planes"], *args,
                                      height=H, width=W),
                {"state": self.state, "planes": self.intensity})

        if marg_slot is not None:
            self.state = self._program(
                ("marginalize_frame", marg_slot),
                lambda x: energy.marginalize_frame(x, slot=marg_slot),
                self.state)
            self.immatures[marg_slot] = None
            self.frame_ids[marg_slot] = -1
            self.marg_count += 1
        return marg_slot

    # ------------------------------------------------------------------
    @traced("keyframe.template")
    def rebuild_coarse_template(self):
        """Project active points into the newest KF and rebuild the coarse
        tracking templates (setCoarseTrackingRef): one program, the newest
        slot its input."""
        cam = self.cam
        H, W = cam.height, cam.width
        caps = tuple(min(8192 >> l, max(1, (H >> l) * (W >> l)))
                     for l in range(self.cfg.coarse.pyr_levels))

        def rebuild(x):
            uv, idn, ok = project_active_to_newest(
                x["state"], cam, x["slot"], height=H, width=W)
            return ct.build_template(uv, idn, torch.ones_like(idn), ok,
                                     x["pyr"], caps=caps)
        self.coarse_templates = self._program(
            ("coarse_template", tuple(cam), caps), rebuild,
            {"state": self.state, "pyr": list(self.pyramids[self.newest_slot]),
             "slot": torch.full((1,), self.newest_slot, dtype=torch.int64,
                                device=self.device)})

    def track_frame(self, img, pose_init: SE3, aff_init=(0.0, 0.0),
                    exposure: float = 1.0):
        """Coarse-track a frame against the newest keyframe
        (``run_track``). Returns (TrackResult, T_wc of the frame)."""
        return self.run_track(*self.track_inputs(img, pose_init, aff_init,
                                                 exposure))

    def run_track(self, x, static):
        """``track_frame_program(x, **static)`` (``_program``: one per
        pyramid shape)."""
        return self._program(("track_frame", tuple(sorted(static.items()))),
                             lambda x: track_frame_program(x, **static), x)

    def track_inputs(self, img, pose_init: SE3, aff_init=(0.0, 0.0),
                     exposure: float = 1.0):
        """(x, static) of ``track_frame_program`` for ``img`` at the
        window's state."""
        dev = self.device
        st = self.state
        L = self.cfg.coarse.pyr_levels
        static = dict(cams=tuple(self.cam.pyramid_level(l) for l in range(L)),
                      max_iterations=tuple(self.cfg.coarse.max_iterations),
                      huber_th=self.cfg.coarse.huber_th,
                      cutoff_th=self.cfg.coarse.coarse_cutoff_th)
        x = {"img": torch.as_tensor(img, dtype=torch.float32, device=dev),
             "slot": torch.full((1,), self.newest_slot, dtype=torch.int64,
                                device=dev),
             "delta": st.delta, "T_eval_R": st.T_eval.R,
             "T_eval_t": st.T_eval.t, "exposure": st.exposure,
             "aff_eval": st.aff_eval, "templates": self.coarse_templates,
             "pose_R": pose_init.R, "pose_t": pose_init.t,
             "aff": (aff_init.to(torch.float32) if torch.is_tensor(aff_init)
                     else torch.stack([torch.full((), float(a), device=dev)
                                       for a in aff_init])),
             "exp_new": torch.full((), exposure, dtype=torch.float32,
                                   device=dev)}
        return x, static

    def need_new_kf(self, track_res) -> bool:
        """DSO keyframe decision from flow indicators + affine change."""
        w, h = self.cam.width, self.cam.height
        cfg = self.cfg.bundles
        fa = _np(torch.cat([track_res.flow_indicators, track_res.aff]))
        fi, a = fa[:3], fa[3:]
        norm = (640 + 480) / (w + h)
        score = cfg.kf_global_weight * (
            cfg.max_shift_weight_t * norm * np.sqrt(max(fi[0], 0.0))
            + cfg.max_shift_weight_r * norm * np.sqrt(max(fi[1], 0.0))
            + cfg.max_shift_weight_rt * norm * np.sqrt(max(fi[2], 0.0))
            + cfg.max_affine_weight * abs(float(a[0])))
        return bool(score > 1.0)
