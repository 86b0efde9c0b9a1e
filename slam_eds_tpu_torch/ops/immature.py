"""Immature-point depth tracing and activation — port of
``slam_eds_tpu.ops.immature`` (DSO's ImmaturePoint as masked fixed-shape
tensor ops over [N points x 100 steps x 8 pattern]).

``activate_idepth`` takes an optional leading slot axis on the point set and
the pair tensors: the JAX window vmaps it over the slots, here the slot
batch dimension is written out.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils.image import pattern
from ..utils.interp import bilinear, bilinear_3
from ..utils.stats import huber_weight

IPS_UNINITIALIZED = 0
IPS_GOOD = 1
IPS_OOB = 2
IPS_OUTLIER = 3
IPS_SKIPPED = 4
IPS_BADCONDITION = 5

MAX_STEPS = 100


class ImmaturePoints(NamedTuple):
    uv: torch.Tensor          # [N, 2]
    color: torch.Tensor       # [N, 8]
    weights: torch.Tensor     # [N, 8]
    gradH: torch.Tensor       # [N, 2, 2]
    idepth_min: torch.Tensor  # [N]
    idepth_max: torch.Tensor  # [N] (+inf before the first trace)
    quality: torch.Tensor     # [N]
    status: torch.Tensor      # [N] int8
    mask: torch.Tensor        # [N] bool


def to_numpy(pts: ImmaturePoints) -> dict:
    return tuple_to_numpy(pts)


def from_numpy(d: dict, device="cuda") -> ImmaturePoints:
    """ImmaturePoints from a dict of arrays (e.g. a JAX ImmaturePoints
    converted field by field with ``np.asarray``)."""
    return tuple_from_numpy(ImmaturePoints, d, device)


def make_immature(host_dI, uv, mask, outlier_th_sum: float = 2500.0,
                  idepth_init_min: float = 0.0,
                  idepth_init_max: float = float("inf")):
    """Immature points at pixels uv of the host stack [H, W, 3]: pattern
    colors, gradient weights, gradient structure tensor."""
    offs = pattern(uv.dtype, uv.device)
    hit = bilinear_3(host_dI, uv[:, 0:1] + offs[None, :, 0],
                     uv[:, 1:2] + offs[None, :, 1])       # [N, 8, 3]
    g = hit[..., 1:3]
    weights = torch.sqrt(g.new_tensor(outlier_th_sum)
                         / (outlier_th_sum + torch.sum(g * g, -1)))
    n = uv.shape[0]
    kw = dict(dtype=uv.dtype, device=uv.device)
    return ImmaturePoints(
        uv=uv, color=hit[..., 0], weights=weights,
        gradH=torch.einsum("nkg,nkh->ngh", g, g),
        idepth_min=torch.full((n,), idepth_init_min, **kw),
        idepth_max=torch.full((n,), idepth_init_max, **kw),
        quality=torch.full((n,), 1e4, **kw),
        status=torch.full((n,), IPS_UNINITIALIZED, dtype=torch.int8,
                          device=uv.device),
        mask=mask)


def trace_on(pts: ImmaturePoints, target_dI, KRKi, Kt, aff,
             width: int, height: int,
             huber_th: float = 9.0, energy_th: float = 1152.0,
             max_pix_search_frac: float = 0.027,
             slack_interval: float = 1.5,
             min_improvement_factor: float = 2.0,
             extra_slack: float = 1.2,
             gn_iterations: int = 3, gn_threshold: float = 0.1,
             test_radius: int = 2) -> ImmaturePoints:
    """One batched traceOn pass against a target frame. KRKi [3, 3],
    Kt [3], aff [2] (host -> target)."""
    N = pts.uv.shape[0]
    dtype, dev = pts.uv.dtype, pts.uv.device
    zf = torch.zeros((), dtype=dtype, device=dev)
    max_pix_search = (width + height) * max_pix_search_frac

    was_oob = pts.status == IPS_OOB
    live = pts.mask & ~was_oob

    pr = torch.cat([pts.uv, torch.ones((N, 1), dtype=dtype, device=dev)],
                   -1) @ KRKi.T
    ptp_min = pr + Kt[None, :] * pts.idepth_min[:, None]
    uMin = ptp_min[:, 0] / ptp_min[:, 2]
    vMin = ptp_min[:, 1] / ptp_min[:, 2]

    def inb(x, y):
        return (x > 4) & (y > 4) & (x < width - 5) & (y < height - 5)

    oob = ~inb(uMin, vMin)

    has_max = torch.isfinite(pts.idepth_max)
    id_for_max = torch.where(has_max, pts.idepth_max,
                             torch.full_like(pts.idepth_max, 0.01))
    ptp_max = pr + Kt[None, :] * id_for_max[:, None]
    uMax0 = ptp_max[:, 0] / ptp_max[:, 2]
    vMax0 = ptp_max[:, 1] / ptp_max[:, 2]

    dist_f = torch.sqrt((uMin - uMax0) ** 2 + (vMin - vMax0) ** 2)
    d_inv = 1.0 / torch.clamp(dist_f, min=1e-12)
    uMax_inf = uMin + max_pix_search * (uMax0 - uMin) * d_inv
    vMax_inf = vMin + max_pix_search * (vMax0 - vMin) * d_inv
    uMax = torch.where(has_max, uMax0, uMax_inf)
    vMax = torch.where(has_max, vMax0, vMax_inf)
    dist = torch.where(has_max, dist_f, torch.full_like(dist_f,
                                                        max_pix_search))
    oob = oob | ~inb(uMax, vMax)

    skipped = has_max & (dist_f < slack_interval) & ~oob

    oob = oob | ~((pts.idepth_min < 0)
                  | ((ptp_min[:, 2] > 0.75) & (ptp_min[:, 2] < 1.5)))

    dxl = uMax - uMin
    dyl = vMax - vMin
    dvec = torch.stack([dxl, dyl], -1)
    pvec = torch.stack([dyl, -dxl], -1)
    a = torch.einsum("ni,nij,nj->n", dvec, pts.gradH, dvec)
    b = torch.einsum("ni,nij,nj->n", pvec, pts.gradH, pvec)
    error_px = 0.2 + 0.2 * (a + b) / torch.clamp(a, min=1e-10)
    bad_cond = (error_px * min_improvement_factor > dist) & has_max & ~oob \
        & ~skipped
    error_px = torch.clamp(error_px, max=10.0)

    dxn = dxl / torch.clamp(dist, min=1e-12)
    dyn = dyl / torch.clamp(dist, min=1e-12)
    over = dist > max_pix_search
    uMax = torch.where(over, uMin + max_pix_search * dxn, uMax)
    vMax = torch.where(over, vMin + max_pix_search * dyn, vMax)
    dist = torch.clamp(dist, max=max_pix_search)
    n_steps = torch.clamp((1.9999 + dist).to(torch.int32), max=MAX_STEPS - 1)

    rand_shift = uMin * 1000.0 - torch.floor(uMin * 1000.0)
    ptx0 = uMin - rand_shift * dxn
    pty0 = vMin - rand_shift * dyn

    pat = pattern(dtype, dev) @ KRKi[:2, :2].T          # [8, 2] rotated

    steps = torch.arange(MAX_STEPS, dtype=dtype, device=dev)
    sx = ptx0[:, None] + steps[None, :] * dxn[:, None]
    sy = pty0[:, None] + steps[None, :] * dyn[:, None]
    px = sx[:, :, None] + pat[None, None, :, 0]
    py = sy[:, :, None] + pat[None, None, :, 1]
    hit = bilinear(target_dI[..., 0], px, py)
    residual = hit - (aff[0] * pts.color[:, None, :] + aff[1])
    hw = huber_weight(residual, huber_th)
    e_k = torch.where(torch.isfinite(hit), hw * residual * residual * (2 - hw),
                      torch.full_like(hit, 1e5))
    energies = torch.sum(e_k, -1)
    step_live = steps[None, :] < n_steps[:, None].to(dtype)
    energies = torch.where(step_live, energies,
                           torch.full_like(energies, 1e10))

    best_e, best_idx = torch.min(energies, -1)
    bestU = ptx0 + best_idx.to(dtype) * dxn
    bestV = pty0 + best_idx.to(dtype) * dyn

    far = torch.abs(torch.arange(MAX_STEPS, device=dev)[None, :]
                    - best_idx[:, None]) > test_radius
    second = torch.amin(torch.where(far, energies,
                                    torch.full_like(energies, 1e10)), -1)
    new_q = second / torch.clamp(best_e, min=1e-10)
    quality = torch.where((new_q < pts.quality) | (n_steps > 10), new_q,
                          pts.quality)

    # ---- 1-D GN refinement along the line
    target_color = aff[0] * pts.color + aff[1]

    def gn_energy_Hb(bu, bv):
        h3 = bilinear_3(target_dI, bu[:, None] + pat[None, :, 0],
                        bv[:, None] + pat[None, :, 1])        # [N, 8, 3]
        r = h3[..., 0] - target_color
        dres = dxn[:, None] * h3[..., 1] + dyn[:, None] * h3[..., 2]
        hw = huber_weight(r, huber_th)
        fin = torch.isfinite(h3[..., 0])
        Hs = 1.0 + torch.sum(torch.where(fin, hw * dres * dres, zf), -1)
        bs = torch.sum(torch.where(fin, hw * r * dres, zf), -1)
        e = torch.sum(torch.where(fin, pts.weights ** 2 * hw * r * r
                                  * (2 - hw), torch.full_like(r, 1e5)), -1)
        return e, Hs, bs

    bu, bv = bestU, bestV
    ubak, vbak = bestU, bestV
    e_best = torch.full((N,), 1e5, dtype=dtype, device=dev)
    step_back = torch.zeros((N,), dtype=dtype, device=dev)
    for _ in range(gn_iterations):
        e, Hs, bs = gn_energy_Hb(bu, bv)
        worse = e > e_best
        sb_new = torch.where(worse, step_back * 0.5,
                             torch.clamp(-bs / Hs, -0.5, 0.5))
        sb_new = torch.where(torch.isfinite(sb_new), sb_new, zf)
        bu_next = torch.where(worse, ubak + sb_new * dxn, bu + sb_new * dxn)
        bv_next = torch.where(worse, vbak + sb_new * dyn, bv + sb_new * dyn)
        ubak = torch.where(worse, ubak, bu)
        vbak = torch.where(worse, vbak, bv)
        e_best = torch.where(worse, e_best, e)
        conv = torch.abs(step_back) < gn_threshold
        bu = torch.where(conv, bu, bu_next)
        bv = torch.where(conv, bv, bv_next)
        step_back = torch.where(conv, step_back, sb_new)

    outlier = ~(e_best < energy_th * extra_slack)

    # ---- idepth interval from the matched pixel +- errorInPixel
    horiz = dxn * dxn > dyn * dyn

    def idepth_of(coord):
        pr_a = torch.where(horiz, pr[:, 0], pr[:, 1])
        kt_a = torch.where(horiz, Kt[0], Kt[1])
        return (pr[:, 2] * coord - pr_a) / (kt_a - Kt[2] * coord)

    id_lo = idepth_of(torch.where(horiz, bu - error_px * dxn,
                                  bv - error_px * dyn))
    id_hi = idepth_of(torch.where(horiz, bu + error_px * dxn,
                                  bv + error_px * dyn))
    id_min_new = torch.minimum(id_lo, id_hi)
    id_max_new = torch.maximum(id_lo, id_hi)
    bad_interval = ~torch.isfinite(id_min_new) | ~torch.isfinite(id_max_new) \
        | (id_max_new < 0)

    good = live & ~oob & ~skipped & ~bad_cond & ~outlier & ~bad_interval
    status = pts.status.to(torch.int32)

    def code(c):
        return torch.full_like(status, c)

    new_status = torch.where(oob, code(IPS_OOB), status)
    new_status = torch.where(~oob & skipped, code(IPS_SKIPPED), new_status)
    new_status = torch.where(~oob & ~skipped & bad_cond,
                             code(IPS_BADCONDITION), new_status)
    out_now = ~oob & ~skipped & ~bad_cond & (outlier | bad_interval)
    new_status = torch.where(out_now & (status == IPS_OUTLIER), code(IPS_OOB),
                             torch.where(out_now, code(IPS_OUTLIER),
                                         new_status))
    new_status = torch.where(good, code(IPS_GOOD), new_status)
    new_status = torch.where(live, new_status, status).to(torch.int8)

    return pts._replace(
        idepth_min=torch.where(good, id_min_new, pts.idepth_min),
        idepth_max=torch.where(good, id_max_new, pts.idepth_max),
        quality=torch.where(live & ~oob & ~skipped, quality, pts.quality),
        status=new_status)


def activate_idepth(pts: ImmaturePoints, target_dIs, KRKis, Kts, affs,
                    target_mask, gn_iterations: int = 3,
                    huber_th: float = 9.0):
    """Idepth-only GN for point activation (optimizeImmaturePoint) from the
    interval midpoint against every valid window frame.

    Unbatched: pts fields [N, ...], KRKis [F, 3, 3], Kts [F, 3], affs
    [F, 2], target_mask [F]. Batched over S slots: every one of those gets a
    leading [S] axis. target_dIs [F, H, W, 3] is shared.
    Returns (idepth, energy), each [N] or [S, N].
    """
    batched = pts.uv.dim() == 3
    if not batched:
        pts = ImmaturePoints(*(x[None] for x in pts))
        KRKis, Kts, affs, target_mask = (KRKis[None], Kts[None], affs[None],
                                         target_mask[None])
    S, N = pts.uv.shape[:2]
    F = target_dIs.shape[0]
    dtype, dev = pts.uv.dtype, pts.uv.device
    zf = torch.zeros((), dtype=dtype, device=dev)
    pat = pattern(dtype, dev)
    idepth = 0.5 * (pts.idepth_min + torch.where(
        torch.isfinite(pts.idepth_max), pts.idepth_max,
        pts.idepth_min + 1.0))
    idepth = torch.clamp(idepth, min=1e-3)

    uv1 = torch.cat([pts.uv, torch.ones((S, N, 1), dtype=dtype, device=dev)],
                    -1)
    pr_all = torch.einsum("sfij,snj->snfi", KRKis, uv1)     # [S, N, F, 3]
    fidx = torch.arange(F, device=dev)[None, None, :, None]
    H_, Wd = target_dIs.shape[1], target_dIs.shape[2]
    ktx = Kts[:, None, :, 0]
    kty = Kts[:, None, :, 1]
    ktz = Kts[:, None, :, 2]
    a_f = affs[:, None, :, None, 0]
    b_f = affs[:, None, :, None, 1]
    tmask = target_mask[:, None, :, None] & pts.mask[:, :, None, None]

    def energy_Hb(idp):
        ptp = pr_all + Kts[:, None, :, :] * idp[:, :, None, None]
        inv_z = 1.0 / torch.clamp(ptp[..., 2], min=1e-9)
        Ku = ptp[..., 0] * inv_z
        Kv = ptp[..., 1] * inv_z
        dKu = (ktx - ktz * Ku) * inv_z
        dKv = (kty - ktz * Kv) * inv_z
        px = Ku[..., None] + pat[:, 0]
        py = Kv[..., None] + pat[:, 1]
        hit = bilinear_3(target_dIs, px, py, frame=fidx)     # [S, N, F, 8, 3]
        r = hit[..., 0] - (a_f * pts.color[:, :, None, :] + b_f)
        dres = hit[..., 1] * dKu[..., None] + hit[..., 2] * dKv[..., None]
        hw = huber_weight(r, huber_th)
        ok = (ptp[..., 2:3] > 1e-6) & (px > 1) & (py > 1) & (px < Wd - 2) \
            & (py < H_ - 2) & torch.isfinite(hit[..., 0]) & tmask
        w = torch.where(ok, hw, zf)
        Hs = torch.sum(w * dres * dres, (2, 3)) + 1e-6
        bs = torch.sum(w * r * dres, (2, 3))
        e = torch.sum(torch.where(ok, hw * r * r * (2 - hw), zf), (2, 3))
        return e, Hs, bs

    for _ in range(gn_iterations):
        e, Hs, bs = energy_Hb(idepth)
        idepth = torch.clamp(idepth - bs / Hs, min=1e-5)
    e, _, _ = energy_Hb(idepth)
    if not batched:
        return idepth[0], e[0]
    return idepth, e
