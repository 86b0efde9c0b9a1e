"""Coarse-to-fine direct image alignment (frame -> newest keyframe) — port
of ``slam_eds_tpu.ops.coarse_tracker`` (DSO's CoarseTracker).

The per-level ``lax.while_loop``s (the cutoff escalation and the LM) are
``graphs.while_loop``s over the JAX loops' state, so a level reads nothing
back to the host and ``track_newest_coarse`` can be captured in a CUDA
graph, where each loop is a WHILE node that ends at its stop (eagerly
every pass to the cap runs, masked). Template packing is a stable descending sort, matching
``lax.top_k``'s order.

``track_level`` dispatches on the image's device: CPU tensors run
``track_level_plain`` (``calc_res``, ``calc_gs`` and the loops in torch
ops); CUDA tensors run ``track_level_fused``, the same loops with every
linearization and its scalar tail one launch of the ``coarse_pass`` kernel
(``ops/kernels/coarse_pass.py``), so a captured pass is that kernel and
the loop's pass tail.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from .. import graphs
from ..models.ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils.lie import SE3
from ..utils.cameras import Pinhole
from ..utils.interp import bilinear_3
from ..utils.scatter import order_free_index_add
from ..utils.stats import huber_weight
from ..utils.linalg import solve
from .kernels import coarse_pass as cp

# masked doublings of the robust cutoff: ceil(log2(50)), enough to reach the
# escalation's 50x bound from any start
CUTOFF_DOUBLINGS = 6

class LevelTemplate(NamedTuple):
    u: torch.Tensor       # [N]
    v: torch.Tensor       # [N]
    idepth: torch.Tensor  # [N]
    color: torch.Tensor   # [N]
    mask: torch.Tensor    # [N] bool


def template_to_numpy(tpl: LevelTemplate) -> dict:
    return tuple_to_numpy(tpl)


def template_from_numpy(d: dict, device="cuda") -> LevelTemplate:
    """LevelTemplate from a dict of arrays (e.g. a JAX LevelTemplate
    converted field by field with ``np.asarray``)."""
    return tuple_from_numpy(LevelTemplate, d, device)


class TrackResult(NamedTuple):
    pose: SE3                      # refToNew
    aff: torch.Tensor              # [2]
    ok: torch.Tensor               # bool
    residuals: torch.Tensor        # [L] per-level final RMS
    flow_indicators: torch.Tensor  # [3] (shiftT, shiftR, shiftRT)
    # [L, 2] int32 per level: the cutoff doublings and the LM passes run
    # (device data, read with the verdict; not in the JAX result)
    passes: torch.Tensor


def aff_from_to(exp_a, aff_a, exp_b, aff_b):
    """AffLight::fromToVecExposure: (a, b) with I_b ~ a * I_a + b."""
    a = torch.exp(aff_b[0] - aff_a[0]) * (exp_b / exp_a)
    return torch.stack([a, aff_b[1] - a * aff_a[1]])


def _fill_holes(idepth, wsum, diagonal: bool):
    """One hole-dilation pass (CoarseTracker.cpp:180-233)."""
    offs = ([(-1, -1), (1, 1), (1, -1), (-1, 1)] if diagonal
            else [(0, 1), (0, -1), (1, 0), (-1, 0)])
    zf = torch.zeros((), dtype=idepth.dtype, device=idepth.device)
    num = torch.zeros_like(idepth)
    sum_id = torch.zeros_like(idepth)
    sum_w = torch.zeros_like(wsum)
    for dy, dx in offs:
        nb_w = torch.roll(wsum, (dy, dx), (0, 1))
        nb_id = torch.roll(idepth, (dy, dx), (0, 1))
        has = nb_w > 0
        num = num + has.to(idepth.dtype)
        sum_id = sum_id + torch.where(has, nb_id, zf)
        sum_w = sum_w + torch.where(has, nb_w, zf)
    fill = (num > 0) & (wsum <= 0)
    nclamp = torch.clamp(num, min=1.0)
    return (torch.where(fill, sum_id / nclamp, idepth),
            torch.where(fill, sum_w / nclamp, wsum))


def splat_idepth(uv, idepth, weight, mask, height: int, width: int):
    """Weighted scatter of idepths into an L0 grid (nearest pixel). The
    same-pixel sums do not depend on the order of the additions (64-bit
    fixed point, ``utils.scatter``), so two runs give the same grid on the
    card, as the JAX package's segment sum does."""
    ix = torch.clamp((uv[:, 0] + 0.5).to(torch.int64), 0, width - 1)
    iy = torch.clamp((uv[:, 1] + 0.5).to(torch.int64), 0, height - 1)
    flat = iy * width + ix
    w = torch.where(mask, weight, torch.zeros_like(weight))
    n = height * width
    idw = order_free_index_add(flat, idepth * w, n)
    ws = order_free_index_add(flat, w, n)
    return idw.reshape(height, width), ws.reshape(height, width)


def build_template(uv, idepth, weight, mask, kf_pyr: Sequence[torch.Tensor],
                   caps: Sequence[int]):
    """Per-level semi-dense templates (makeCoarseDepthL0): splat, sum-pool
    down the pyramid, fill holes, pack valid pixels to capacity in raster
    order."""
    n_levels = len(kf_pyr)
    H0, W0 = kf_pyr[0].shape[:2]
    id_maps, w_maps = [], []
    id0, w0 = splat_idepth(uv, idepth, weight, mask, H0, W0)
    id_maps.append(id0)
    w_maps.append(w0)
    for lvl in range(1, n_levels):
        Hl, Wl = kf_pyr[lvl].shape[:2]
        id_maps.append(id_maps[-1][: 2 * Hl, : 2 * Wl].reshape(
            Hl, 2, Wl, 2).sum(dim=(1, 3)))
        w_maps.append(w_maps[-1][: 2 * Hl, : 2 * Wl].reshape(
            Hl, 2, Wl, 2).sum(dim=(1, 3)))

    templates = []
    for lvl in range(n_levels):
        idm, wm = _fill_holes(id_maps[lvl], w_maps[lvl], diagonal=(lvl < 2))
        Hl, Wl = wm.shape
        dev = wm.device
        ys = torch.arange(Hl, device=dev)[:, None]
        xs = torch.arange(Wl, device=dev)[None, :]
        interior = (xs >= 2) & (xs < Wl - 2) & (ys >= 2) & (ys < Hl - 2)
        idn = torch.where(wm > 0, idm / torch.clamp(wm, min=1e-12),
                          torch.full_like(wm, -1.0))
        color = kf_pyr[lvl][..., 0]
        valid = (wm > 0) & interior & (idn > 0) & torch.isfinite(color)
        cap = min(caps[lvl], Hl * Wl)
        # stable order: valid pixels in raster order, then invalid ones
        idx = torch.sort(valid.reshape(-1).to(torch.int8), descending=True,
                         stable=True).indices[:cap]
        templates.append(LevelTemplate(
            u=(idx % Wl).to(torch.float32),
            v=(idx // Wl).to(torch.float32),
            idepth=idn.reshape(-1)[idx],
            color=color.reshape(-1)[idx],
            mask=valid.reshape(-1)[idx]))
    return templates


def _warp(tpl: LevelTemplate, dI, cam: Pinhole, pose: SE3):
    Ki_p = torch.stack([(tpl.u - cam.cx) / cam.fx, (tpl.v - cam.cy) / cam.fy,
                        torch.ones_like(tpl.u)], -1)
    pt = Ki_p @ pose.R.T + pose.t * tpl.idepth[:, None]
    u = pt[:, 0] / pt[:, 2]
    v = pt[:, 1] / pt[:, 2]
    Ku = cam.fx * u + cam.cx
    Kv = cam.fy * v + cam.cy
    new_id = tpl.idepth / pt[:, 2]
    H, W = dI.shape[:2]
    valid = (tpl.mask & (Ku > 2) & (Kv > 2) & (Ku < W - 3) & (Kv < H - 3)
             & (new_id > 0))
    return u, v, Ku, Kv, new_id, valid


def calc_res(tpl: LevelTemplate, dI, cam: Pinhole, pose: SE3, aff_rel,
             huber_th: float, cutoff_th):
    """Residual pass (calcRes). Returns (E, n_terms, saturated_frac,
    buffers for calc_gs)."""
    u, v, Ku, Kv, new_id, valid = _warp(tpl, dI, cam, pose)
    hit = bilinear_3(dI, Ku, Kv)
    residual = hit[:, 0] - (aff_rel[0] * tpl.color + aff_rel[1])
    valid = valid & torch.isfinite(hit[:, 0])
    zf = torch.zeros((), dtype=residual.dtype, device=residual.device)

    hw = huber_weight(residual, huber_th)
    saturated = torch.abs(residual) > cutoff_th
    max_energy = 2.0 * huber_th * cutoff_th - huber_th * huber_th
    in_gn = valid & ~saturated
    E = torch.sum(torch.where(in_gn, hw * residual * residual * (2.0 - hw),
                              zf)) \
        + torch.sum(torch.where(valid & saturated, max_energy, zf))
    n_terms = torch.sum(valid)
    n_sat = torch.sum(valid & saturated)
    buffers = dict(u=u, v=v, idepth=new_id, dx=hit[:, 1], dy=hit[:, 2],
                   residual=residual, weight=hw, ref_color=tpl.color,
                   mask=in_gn)
    sat_frac = n_sat.to(torch.float32) / torch.clamp(
        n_terms.to(torch.float32), min=1.0)
    return E, n_terms, sat_frac, buffers


def flow_indicators(tpl: LevelTemplate, cam: Pinhole, pose: SE3):
    """Mean squared pixel shift under translation-only / rotation-only /
    full motion (DSO's KF-need statistics)."""
    Ki_p = torch.stack([(tpl.u - cam.cx) / cam.fx, (tpl.v - cam.cy) / cam.fy,
                        torch.ones_like(tpl.u)], -1)
    m = tpl.mask.to(torch.float32)
    n = torch.clamp(torch.sum(m), min=1.0)

    def mean_shift(R, t_sign):
        pt = Ki_p @ R.T + t_sign * pose.t * tpl.idepth[:, None]
        Ku = cam.fx * pt[:, 0] / pt[:, 2] + cam.cx
        Kv = cam.fy * pt[:, 1] / pt[:, 2] + cam.cy
        d2 = (Ku - tpl.u) ** 2 + (Kv - tpl.v) ** 2
        d2 = torch.where(torch.isfinite(d2), d2, torch.zeros_like(d2))
        return torch.sum(m * d2) / n

    I3 = torch.eye(3, dtype=pose.R.dtype, device=pose.R.device)
    shiftT = mean_shift(I3, 1.0) + mean_shift(I3, -1.0)
    shiftR = 2.0 * mean_shift(pose.R, 0.0)
    shiftRT = mean_shift(pose.R, 1.0) + mean_shift(pose.R, -1.0)
    return shiftT, shiftR, shiftRT


def calc_gs(buffers, cam: Pinhole, aff_rel, b0_ref):
    """The 8x8 GN system from the residual buffers (calcGSSSE), normalized
    by the buffer count."""
    u = buffers["u"]
    v = buffers["v"]
    idp = buffers["idepth"]
    dx = buffers["dx"] * cam.fx
    dy = buffers["dy"] * cam.fy
    r = buffers["residual"]
    w = torch.where(buffers["mask"], buffers["weight"],
                    torch.zeros_like(buffers["weight"]))
    J = torch.stack([
        idp * dx,
        idp * dy,
        -idp * (u * dx + v * dy),
        -(u * v * dx + (1.0 + v * v) * dy),
        (1.0 + u * u) * dx + u * v * dy,
        u * dy - v * dx,
        (aff_rel[0] * (b0_ref - buffers["ref_color"])),
        -torch.ones_like(u),
    ], -1)
    n = torch.clamp(torch.sum(buffers["mask"].to(torch.float32)), min=1.0)
    Jw = J * w[:, None]
    return (Jw.T @ J) / n, (Jw.T @ r) / n


def track_level(tpl: LevelTemplate, dI, cam: Pinhole, pose0: SE3, aff0,
                exposures, aff_ref, max_iterations: int, huber_th: float,
                cutoff_th: float, lambda_init: float = 0.01,
                lambda_extrap_limit: float = 0.001,
                fix_a: bool = False, fix_b: bool = False,
                scale_a: float = 1.0, scale_b: float = 1.0):
    """LM on one pyramid level. Returns (pose, aff, rms, sat_frac,
    visible, passes): passes [2] int32 are the cutoff doublings and the LM
    passes that ran. CPU tensors run ``track_level_plain``, CUDA tensors
    ``track_level_fused``."""
    if dI.device.type == "cpu":
        fn = track_level_plain
    elif dI.device.type == "cuda":
        fn = track_level_fused
    else:
        raise ValueError(f"track_level: unsupported device {dI.device}")
    return fn(tpl, dI, cam, pose0, aff0, exposures, aff_ref, max_iterations,
              huber_th, cutoff_th, lambda_init, lambda_extrap_limit, fix_a,
              fix_b, scale_a, scale_b)


def track_level_fused(tpl: LevelTemplate, dI, cam: Pinhole, pose0: SE3, aff0,
                      exposures, aff_ref, max_iterations: int,
                      huber_th: float, cutoff_th: float,
                      lambda_init: float = 0.01,
                      lambda_extrap_limit: float = 0.001,
                      fix_a: bool = False, fix_b: bool = False,
                      scale_a: float = 1.0, scale_b: float = 1.0):
    """``track_level`` by the ``coarse_pass`` kernel: one launch for the
    first residuals, one a cutoff doubling, one for the first
    linearization, one an LM pass, one for the last residuals. The LM
    carry holds the next pass's candidate (the step solved at the end of
    the previous pass), so a captured pass is the kernel and the pass
    tail."""
    lvl = cp.Level(tpl, dI, cam, exposures, aff_ref, huber_th, cutoff_th,
                   lambda_init, lambda_extrap_limit, fix_a, fix_b,
                   (scale_a, scale_b))
    pose0 = (pose0.R, pose0.t, aff0)
    # (cutoff and saturated share, doublings, stop)
    esc = graphs.while_loop(
        lambda c: c[2], lambda _, c: lvl.run("double", pose0, carry=c),
        lvl.run("sat0", pose0), CUTOFF_DOUBLINGS)
    cutoff = esc[0][0]
    # (state, passes, done): cp.STATE floats, the candidate among them
    lm = graphs.while_loop(
        lambda c: c[2],
        lambda _, c: lvl.run("lm", (c[0][cp.S_CR:cp.S_CT],
                                    c[0][cp.S_CT:cp.S_CAFF],
                                    c[0][cp.S_CAFF:cp.S_CNORM]),
                             cutoff, c),
        lvl.run("init", pose0, cutoff), max_iterations)
    st = lm[0]
    pose = (st[cp.S_R:cp.S_T], st[cp.S_T:cp.S_AFF], st[cp.S_AFF:cp.S_H])
    fin, visible = lvl.run("final", pose, cutoff, lm)
    return (SE3(pose[0].view(3, 3), pose[1]), pose[2], fin[0], fin[1],
            visible, torch.stack([esc[1], lm[1]]))


def track_level_plain(tpl: LevelTemplate, dI, cam: Pinhole, pose0: SE3,
                      aff0, exposures, aff_ref, max_iterations: int,
                      huber_th: float, cutoff_th: float,
                      lambda_init: float = 0.01,
                      lambda_extrap_limit: float = 0.001,
                      fix_a: bool = False, fix_b: bool = False,
                      scale_a: float = 1.0, scale_b: float = 1.0):
    """``track_level`` in torch ops: ``calc_res`` and ``calc_gs`` in the
    cutoff escalation's and the LM's ``graphs.while_loop``s (the
    ``coarse_pass`` kernel's plain version)."""
    exp_ref, exp_new = exposures
    b0_ref = aff_ref[1]
    dtype, dev = aff0.dtype, aff0.device

    def rel_aff(aff):
        return aff_from_to(exp_ref, aff_ref, exp_new, aff)

    # cutoff escalation: double while > 60% saturate, as JAX's while_loop,
    # in at most ceil(log2(50)) = 6 passes (20 -> 1280 takes 6 doublings)
    def grows(cutoff, sat):
        return (sat > 0.6) & (cutoff < cutoff_th * 50.0)

    def doubling(_, carry):
        cutoff, sat, n, stop = carry
        grow = ~stop
        c2 = cutoff * 2.0
        _, _, sat2, _ = calc_res(tpl, dI, cam, pose0, rel_aff(aff0),
                                 huber_th, c2)
        cutoff = torch.where(grow, c2, cutoff)
        sat = torch.where(grow, sat2, sat)
        return cutoff, sat, n + grow.to(torch.int32), ~grows(cutoff, sat)

    _, _, sat, _ = calc_res(tpl, dI, cam, pose0, rel_aff(aff0), huber_th,
                            cutoff_th)
    # grow is monotone (once false, the carry stays), so the doublings are
    # a while_loop on its negation, carried
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    cutoff = torch.full((), cutoff_th, dtype=torch.float32, device=dev)
    cutoff, sat, doublings, _ = graphs.while_loop(
        lambda c: c[3], doubling, (cutoff, sat, zero_i, ~grows(cutoff, sat)),
        CUTOFF_DOUBLINGS)

    E0, n0, _, buf0 = calc_res(tpl, dI, cam, pose0, rel_aff(aff0), huber_th,
                               cutoff)
    H, b = calc_gs(buf0, cam, rel_aff(aff0), b0_ref)
    S = torch.ones(8, dtype=dtype, device=dev)
    if scale_a != 1.0 or scale_b != 1.0:
        S = torch.cat([S[:6], torch.full((1,), scale_a, dtype=dtype,
                                         device=dev),
                       torch.full((1,), scale_b, dtype=dtype, device=dev)])
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    eye8 = torch.eye(8, dtype=dtype, device=dev)


    def solve_inc(H, b, lam):
        Hl = H + lam * torch.diag(torch.diagonal(H))
        Hs = Hl * S[None, :] * S[:, None]
        bs = b * S
        if fix_a and fix_b:
            inc = torch.cat([solve(Hs[:6, :6] + 1e-12 * eye6, -bs[:6]),
                             torch.zeros(2, dtype=dtype, device=dev)])
        else:
            inc = solve(Hs + 1e-12 * eye8, -bs)
            if fix_a:
                inc = torch.cat([inc[:6], inc.new_zeros(1), inc[7:]])
            if fix_b:
                inc = torch.cat([inc[:7], inc.new_zeros(1)])
        return inc * S

    n_tpl = torch.sum(tpl.mask)
    n_floor = torch.clamp(0.2 * n_tpl.to(torch.float32), min=10).to(
        n_tpl.dtype)
    inf = torch.full((), float("inf"), dtype=dtype, device=dev)

    def mean_E(E, n):
        return torch.where(n >= n_floor, E / torch.clamp(n, min=1), inf)

    # the LM as JAX's while_loop (it < max_iterations) & ~done; done is
    # ||inc|| <= 1e-3
    extrap_limit = torch.full((), lambda_extrap_limit, dtype=torch.float32,
                              device=dev)

    def lm_pass(_, carry):
        pose_R, pose_t, aff, H, b, res_old, lam, done, it = carry
        pose = SE3(pose_R, pose_t)
        active = ~done
        inc = solve_inc(H, b, lam)
        extrap = torch.where(lam < lambda_extrap_limit,
                             torch.sqrt(torch.sqrt(extrap_limit / lam)),
                             torch.ones_like(lam))
        inc = inc * extrap
        inc = torch.where(torch.isfinite(inc), inc, torch.zeros_like(inc))
        pose_new = SE3.exp(inc[:6]).compose(pose)
        aff_new = aff + inc[6:8]
        E_new, n_new, _, buf = calc_res(tpl, dI, cam, pose_new,
                                        rel_aff(aff_new), huber_th, cutoff)
        accept = mean_E(E_new, n_new) < mean_E(res_old[0],
                                               res_old[1].to(n_new.dtype))
        H_new, b_new = calc_gs(buf, cam, rel_aff(aff_new), b0_ref)
        take = active & accept
        return (torch.where(take, pose_new.R, pose.R),
                torch.where(take, pose_new.t, pose.t),
                torch.where(take, aff_new, aff),
                torch.where(take, H_new, H), torch.where(take, b_new, b),
                torch.where(take, torch.stack(
                    [E_new, n_new.to(E_new.dtype)]), res_old),
                torch.where(active, torch.where(
                    accept, lam * 0.5,
                    torch.clamp(lam * 4.0, min=lambda_extrap_limit)), lam),
                done | (torch.linalg.vector_norm(inc) <= 1e-3),
                it + active.to(torch.int32))

    carry = (pose0.R, pose0.t, aff0, H, b,
             torch.stack([E0, n0.to(E0.dtype)]),
             torch.full((), lambda_init, dtype=torch.float32, device=dev),
             torch.zeros((), dtype=torch.bool, device=dev), zero_i)
    pose_R, pose_t, aff, _, _, res_old, _, _, its = graphs.while_loop(
        lambda c: c[7], lm_pass, carry, max_iterations)
    pose = SE3(pose_R, pose_t)
    rms = torch.sqrt(res_old[0] / torch.clamp(res_old[1], min=1.0))
    _, n_fin, sat, _ = calc_res(tpl, dI, cam, pose, rel_aff(aff), huber_th,
                                cutoff)
    return pose, aff, rms, sat, n_fin >= n_floor, torch.stack([doublings,
                                                               its])


def track_newest_coarse(templates: Sequence[LevelTemplate],
                        target_pyr: Sequence[torch.Tensor],
                        cams: Sequence[Pinhole],
                        pose_init: SE3, aff_init,
                        exposures, aff_ref,
                        min_res_for_abort,
                        max_iterations: Sequence[int],
                        huber_th: float = 9.0,
                        cutoff_th: float = 20.0,
                        n_levels: int | None = None):
    """Coarse-to-fine tracking (trackNewestCoarse), coarsest level first;
    an abort at any level freezes the state and flags failure."""
    n_levels = n_levels or len(templates)
    dev = pose_init.R.device
    pose = pose_init
    aff = aff_init.to(torch.float32)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    per_level_rms = [torch.zeros((), device=dev)] * n_levels
    passes = [None] * n_levels

    for lvl in range(n_levels - 1, -1, -1):
        p_new, a_new, rms, _, visible, passes[lvl] = track_level(
            templates[lvl], target_pyr[lvl], cams[lvl], pose, aff,
            exposures, aff_ref,
            max_iterations=max_iterations[min(lvl, len(max_iterations) - 1)],
            huber_th=huber_th, cutoff_th=cutoff_th)
        pose = SE3(torch.where(ok, p_new.R, pose.R),
                   torch.where(ok, p_new.t, pose.t))
        aff = torch.where(ok, a_new, aff)
        per_level_rms[lvl] = torch.where(ok, rms, per_level_rms[lvl])
        ok = ok & (rms <= 1.5 * min_res_for_abort[lvl]) & visible

    shiftT, shiftR, shiftRT = flow_indicators(templates[0], cams[0], pose)
    rel = aff_from_to(exposures[0], aff_ref, exposures[1], aff)
    ok = ok & (torch.abs(aff[0]) < 1.2) & (torch.abs(aff[1]) < 200.0) \
        & (torch.abs(torch.log(torch.clamp(rel[0], min=1e-12))) < 1.5) \
        & (torch.abs(rel[1]) < 200.0)
    return TrackResult(pose=pose, aff=aff, ok=ok,
                       residuals=torch.stack(per_level_rms),
                       flow_indicators=torch.stack([shiftT, shiftR, shiftRT]),
                       passes=torch.stack(passes))
