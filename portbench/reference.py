"""The plain reference that decides ``correct``: plain torch, written from
the published formulation (DSO's photometric residuals and window
Gauss-Newton, EDS's event frame and event-to-model residuals), importing
nothing of the program.

Each function works, from the benchmark's own inputs (its frames and event
packets) and the state a step of the program started from, what the step's
outputs must be: its energy, RMS or residuals at the point where the step
ended; the window BA's own solve from where the step started
(``ba_solve``, DSO's algorithm step for step); and, for the coarse track
and the event LM, the energy that the reference's own solve still takes
off the step's answer (``track_energy_left``, ``event_energy_left``). The
reference follows the program from the program's own state (the keyframe's
points, the window's points, poses and priors, the coarse template).

Precision: the reference computes in float64. ``Precision("tf32")`` is the
control: float32 with the operands of every product rounded to TF32 (10
mantissa bits, to nearest even), as tensor cores compute; put in the
program's place, it has to fail the limits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

# DSO's 8-point residual pattern (PATTERN_DSO8), in pixels
PATTERN = ((0, -2), (-1, -1), (1, -1), (-2, 0), (0, 0), (2, 0), (-1, 1),
           (0, 2))


def round_tf32(x):
    """x (float32) rounded to the nearest TF32 value (10 explicit mantissa
    bits, ties to even); non-finite values pass."""
    x = x.to(torch.float32).contiguous()
    bits = x.view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    out = ((bits + bias) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isfinite(x), out, x)


@dataclass(frozen=True)
class Precision:
    """``"float64"``: the reference; ``"tf32"``: the control."""
    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def q(self, x):
        """An operand of a product, at this precision."""
        x = x.to(self.dtype)
        return round_tf32(x) if self.name == "tf32" else x

    def mul(self, a, b):
        return self.q(a) * self.q(b)

    def matvec(self, M, x):
        """M [..., 3, 3] times x [..., 3]."""
        return torch.sum(self.q(M) * self.q(x)[..., None, :], -1)


REFERENCE = Precision("float64")
CONTROL = Precision("tf32")


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def se3_exp(tau):
    """[..., 6] = [upsilon, omega] -> (R, t), Sophus conventions."""
    v, w = tau[..., :3], tau[..., 3:6]
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2)
    small = theta2 < 1e-12
    ts = torch.where(small, torch.ones_like(theta), theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(ts)) / (ts * ts))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (ts - torch.sin(ts)) / (ts * ts * ts))
    W = _hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    J = eye + B[..., None, None] * W + C[..., None, None] * WW
    return R, (J @ v[..., None])[..., 0]


def quat_to_mat(q):
    """Unit quaternion [w, x, y, z] -> rotation matrix."""
    q = q / torch.linalg.vector_norm(q)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)])])


# ---------------------------------------------------------------------------
# image sampling
# ---------------------------------------------------------------------------

def _clean(x, hi, pad):
    return torch.clamp(torch.nan_to_num(x, nan=-pad), -pad, hi + pad)


def bilinear(img, x, y, P: Precision):
    """Bilinear lookup of img [H, W] (or [H, W, C]) at (x=col, y=row), each
    tap clamped to the image on its own; NaN at a non-finite query."""
    H, W = img.shape[:2]
    xc, yc = _clean(x, W, 4.0), _clean(y, H, 4.0)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    dx, dy = xc - x0, yc - y0
    ix = [torch.clamp(x0.long() + i, 0, W - 1) for i in (0, 1)]
    iy = [torch.clamp(y0.long() + i, 0, H - 1) for i in (0, 1)]
    if img.dim() == 3:
        dx, dy = dx[..., None], dy[..., None]
    row = [P.mul(img[iy[r], ix[0]], 1.0 - dx) + P.mul(img[iy[r], ix[1]], dx)
           for r in (0, 1)]
    val = P.mul(row[0], 1.0 - dy) + P.mul(row[1], dy)
    bad = ~(torch.isfinite(x) & torch.isfinite(y))
    if img.dim() == 3:
        bad = bad[..., None]
    return torch.where(bad, torch.full_like(val, math.nan), val)


def _keys(t):
    """Catmull-Rom (Keys, a = -0.5) weights of the taps at -1, 0, 1, 2."""
    t2 = t * t
    t3 = t2 * t
    return (-0.5 * t3 + t2 - 0.5 * t, 1.5 * t3 - 2.5 * t2 + 1.0,
            -1.5 * t3 + 2.0 * t2 + 0.5 * t, 0.5 * t3 - 0.5 * t2)


def bicubic(img, x, y, P: Precision):
    """Bicubic (Catmull-Rom) lookup of img [H, W], each of the 4x4 taps
    clamped to the image on its own; NaN at a non-finite query."""
    H, W = img.shape
    xc, yc = _clean(x, W, 4.0), _clean(y, H, 4.0)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    wx, wy = _keys(xc - x0), _keys(yc - y0)
    cols = [torch.clamp(x0.long() - 1 + i, 0, W - 1) for i in range(4)]
    rows = [torch.clamp(y0.long() - 1 + i, 0, H - 1) for i in range(4)]
    val = 0.0
    for r in range(4):
        line = sum(P.mul(wx[c], img[rows[r], cols[c]]) for c in range(4))
        val = val + P.mul(wy[r], line)
    bad = ~(torch.isfinite(x) & torch.isfinite(y))
    return torch.where(bad, torch.full_like(val, math.nan), val)


# ---------------------------------------------------------------------------
# the event frame and the event-to-model residuals (EDS)
# ---------------------------------------------------------------------------

def gaussian_kernel(ksize: int, sigma: float):
    """cv::getGaussianKernel: sigma <= 0 derives it from ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _blur(img, ksize, sigma, P: Precision):
    """Separable Gaussian blur with reflect-101 borders."""
    k = gaussian_kernel(ksize, sigma)
    r = (ksize - 1) // 2
    H, W = img.shape
    p = torch.nn.functional.pad(img[None, None], (r, r, r, r),
                                mode="reflect")[0, 0]
    row = sum(P.mul(p[:, i:i + W], torch.tensor(float(k[i]), dtype=P.dtype))
              for i in range(ksize))
    return sum(P.mul(row[i:i + H, :], torch.tensor(float(k[i]),
                                                   dtype=P.dtype))
               for i in range(ksize))


def event_frame(xs, ys, ps, n_valid: int, height: int, width: int,
                time_weights: bool, blur_ksize: int, P: Precision,
                blur_sigma: float = 0.5):
    """EDS's event frame of one packet (EventFrame::create, level 0): the
    live events' polarities, weighted by a Gaussian bell over their order
    in the packet, splatted bilinearly (taps off the image dropped),
    blurred, and divided by the frame's Frobenius norm."""
    dev = xs.device
    xs, ys = xs.to(P.dtype), ys.to(P.dtype)
    E = xs.shape[0]
    idx = torch.arange(E, dtype=P.dtype, device=dev)
    vals = ps.to(P.dtype)
    if time_weights:
        z = (idx / max(n_valid, 1) - 0.5) * 6.0
        vals = P.mul(vals, torch.exp(-0.5 * z * z))
    vals = torch.where(idx < n_valid, vals, torch.zeros_like(vals))
    finite = torch.isfinite(xs) & torch.isfinite(ys)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    img = torch.zeros(height * width, dtype=P.dtype, device=dev)
    for dx, dy, w in ((0, 0, P.mul(1 - fx, 1 - fy)), (0, 1, P.mul(1 - fx, fy)),
                      (1, 0, P.mul(fx, 1 - fy)), (1, 1, P.mul(fx, fy))):
        xi, yi = x0 + dx, y0 + dy
        ok = finite & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        flat = torch.where(ok, yi * width + xi, torch.zeros_like(xi)).long()
        img.index_add_(0, flat, torch.where(ok, P.mul(w, vals),
                                            torch.zeros_like(vals)))
    img = img.reshape(height, width)
    if blur_ksize > 0:
        img = _blur(img, blur_ksize, blur_sigma, P)
    return img / (torch.sqrt(torch.sum(P.mul(img, img))) + 1e-12)


def event_residuals(frame, cam, norm_coord, grad, idepth, weight, mask, px,
                    qx, vx, P: Precision, R=None):
    """The event-to-model residual of every keyframe point at the tracker
    state (px, qx: T_ef_kf; vx: unit velocity): the weighted difference of
    the normalized brightness-change model -grad . flow(v) and the event
    frame's bicubic value where the point lands (EDS eq. 4-6); 0 off the
    mask. ``R``, where given, is the rotation in place of ``qx``'s."""
    d = P.dtype
    x, y = norm_coord[:, 0].to(d), norm_coord[:, 1].to(d)
    idp = idepth.to(d)
    v0, v1, v2, w0, w1, w2 = vx.to(d).unbind(0)
    m = P.mul
    flow_x = (-m(idp, v0) + m(m(x, idp), v2) + m(m(x, y), w0)
              - m(1.0 + m(x, x), w1) + m(y, w2))
    flow_y = (-m(idp, v1) + m(m(y, idp), v2) + m(1.0 + m(y, y), w0)
              - m(m(x, y), w1) - m(x, w2))
    g = grad.to(d)
    model = -(m(g[:, 0], flow_x) + m(g[:, 1], flow_y))
    model = torch.where(mask, model, torch.zeros_like(model))
    model_norm = torch.sqrt(1e-3 + torch.sum(m(model, model)))
    z = 1.0 / (idp + 1e-5)
    X = torch.stack([m(x, z), m(y, z), z], -1)
    if R is None:
        R = quat_to_mat(qx.to(d))
    p = P.matvec(R.to(d), X) + px.to(d)
    xp = cam.fx * (p[:, 0] / p[:, 2]) + cam.cx
    yp = cam.fy * (p[:, 1] / p[:, 2]) + cam.cy
    ev = bicubic(frame, xp, yp, P)
    r = m(weight.to(d), model / model_norm - ev)
    return torch.where(mask, r, torch.zeros_like(r))


# ---------------------------------------------------------------------------
# DSO's photometric residuals: the coarse tracker's and the window BA's
# ---------------------------------------------------------------------------

def frame_level0(img, P: Precision):
    """[H, W, 3]: the image and its central differences (clamped borders)."""
    I = img.to(P.dtype)
    right = torch.cat([I[:, 1:], I[:, -1:]], 1)
    left = torch.cat([I[:, :1], I[:, :-1]], 1)
    down = torch.cat([I[1:, :], I[-1:, :]], 0)
    up = torch.cat([I[:1, :], I[:-1, :]], 0)
    return torch.stack([I, 0.5 * (right - left), 0.5 * (down - up)], -1)


def aff_from_to(exp_a, aff_a, exp_b, aff_b):
    """(a, b) with I_b ~ a I_a + b (AffLight::fromToVecExposure)."""
    a = torch.exp(aff_b[0] - aff_a[0]) * (exp_b / exp_a)
    return a, aff_b[1] - a * aff_a[1]


def track_rms(img, tpl, cam, R, t, rel_a, rel_b, huber_th: float,
              cutoff: float, P: Precision):
    """The coarse tracker's finest-level RMS (CoarseTracker::calcRes) of the
    template (u, v, idepth, color, mask of the keyframe's pixels) warped by
    refToNew (R, t) into ``img``: Huber energy of the affine-corrected
    residuals, saturated terms at the cutoff's energy, over the valid
    terms' count."""
    d = P.dtype
    u, v, idp, color = (a.to(d) for a in tpl[:4])
    mask = tpl[4]
    dI = frame_level0(img, P)
    H, W = dI.shape[:2]
    Kip = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                       torch.ones_like(u)], -1)
    pt = P.matvec(R.to(d), Kip) + P.mul(t.to(d), idp[:, None])
    Ku = cam.fx * (pt[:, 0] / pt[:, 2]) + cam.cx
    Kv = cam.fy * (pt[:, 1] / pt[:, 2]) + cam.cy
    new_id = idp / pt[:, 2]
    valid = (mask & (Ku > 2) & (Kv > 2) & (Ku < W - 3) & (Kv < H - 3)
             & (new_id > 0))
    hit = bilinear(dI, Ku, Kv, P)[:, 0]
    r = hit - (P.mul(rel_a, color) + rel_b)
    valid = valid & torch.isfinite(hit)
    r = torch.where(valid, r, torch.zeros_like(r))
    a = torch.abs(r)
    hw = torch.where(a < huber_th, torch.ones_like(a),
                     huber_th / torch.clamp(a, min=1e-12))
    sat = a > cutoff
    e = torch.where(valid & ~sat, P.mul(P.mul(hw, P.mul(r, r)), 2.0 - hw),
                    torch.where(valid & sat,
                                torch.full_like(r, 2.0 * huber_th * cutoff
                                                - huber_th * huber_th),
                                torch.zeros_like(r)))
    n = torch.sum(valid)
    return torch.sqrt(torch.sum(e) / torch.clamp(n, min=1))


def ba_terms(st, planes, height: int, width: int, outlier_th_sum: float,
             P: Precision, pair_twist=None):
    """The window BA's pattern residuals of every (point, target frame)
    pair (PointFrameResidual::linearize): the point's 8-pixel pattern
    projected from its host into the target at the current poses and
    inverse depth, the target sampled bilinearly, the residual against the
    affine-corrected host colour, and its weight (gradient-dependent and
    the point's own).

    ``st``: a dict of the window state's fields (``T_eval_R``, ``T_eval_t``,
    ``delta``, ``aff_eval``, ``exposure``, ``c_zero``, ``c_delta``,
    ``p_uv``, ``p_idepth``, ``p_idepth_zero``, ``p_host``, ``p_color``,
    ``p_weight``, ``p_status``, ``r_active``, ``frame_valid``).
    Returns {``residual``, ``weight``, ``tap_ok``, the pattern's ``Ku``,
    ``Kv``, the target's gradients ``gx``, ``gy`` there, the
    affine-corrected host colour ``pred`` (each [P, F, 8]), ``usable``,
    the centre's ``Kuc``, ``Kvc`` ([P, F])}: a pair is usable in the
    window's structure with its centre (at the linearization point) and
    every pattern pixel in the image. ``pair_twist`` [6], where given,
    moves every (host, target) pair's relative pose by it, on the left."""
    d = P.dtype
    m = P.mul
    dev = st["delta"].device
    Fn = st["delta"].shape[0]
    calib = (st["c_zero"] + st["c_delta"]).to(d)
    fx, fy, cx, cy = calib.unbind(0)

    def poses(Rb, tb, delta):
        R, t = se3_exp(delta[:, :6].to(d))
        Rb, tb = Rb.to(d), tb.to(d)
        return R @ Rb, (R @ tb[..., None])[..., 0] + t

    def pairs(R, t):
        # T_th = T_t o T_h^-1, indexed [host, target]
        Rh_inv = R.transpose(-1, -2)
        th_inv = -(Rh_inv @ t[..., None])[..., 0]
        Rp = R[None, :] @ Rh_inv[:, None]
        tp = (R[None, :] @ th_inv[:, None, :, None])[..., 0] + t[None, :]
        return Rp, tp

    zero_delta = torch.zeros_like(st["delta"])
    R0, t0 = pairs(*poses(st["T_eval_R"], st["T_eval_t"], zero_delta))
    Rc, tc = pairs(*poses(st["T_eval_R"], st["T_eval_t"], st["delta"]))
    if pair_twist is not None:
        Re, te = se3_exp(pair_twist.to(d))
        Rc, tc = Re @ Rc, (Re @ tc[..., None])[..., 0] + te
    aff = (st["aff_eval"] + st["delta"][:, 6:8]).to(d)
    e = st["exposure"].to(d)
    a_rel = torch.exp(aff[None, :, 0] - aff[:, None, 0]) * (e[None, :]
                                                            / e[:, None])
    b_rel = aff[None, :, 1] - a_rel * aff[:, None, 1]

    host = st["p_host"].long()
    u_pt = st["p_uv"][:, 0].to(d)
    v_pt = st["p_uv"][:, 1].to(d)
    Klip = torch.stack([(u_pt - cx) / fx, (v_pt - cy) / fy,
                        torch.ones_like(u_pt)], -1)
    # the centre at the linearization point (first-estimate Jacobians)
    ptp0 = (P.matvec(R0[host], Klip[:, None, :])
            + m(t0[host], st["p_idepth_zero"].to(d)[:, None, None]))
    Ku0 = ptp0[..., 0] / ptp0[..., 2] * fx + cx
    Kv0 = ptp0[..., 1] / ptp0[..., 2] * fy + cy
    center_ok = ((ptp0[..., 2] > 1e-6) & (Ku0 > 1.1) & (Kv0 > 1.1)
                 & (Ku0 < width - 3) & (Kv0 < height - 3))
    # the centre at the current state
    ptpc = (P.matvec(Rc[host], Klip[:, None, :])
            + m(tc[host], st["p_idepth"].to(d)[:, None, None]))
    Kuc = ptpc[..., 0] / ptpc[..., 2] * fx + cx
    Kvc = ptpc[..., 1] / ptpc[..., 2] * fy + cy
    # the pattern at the current state
    offs = torch.tensor(PATTERN, dtype=d, device=dev)
    pat = torch.stack([(u_pt[:, None] + offs[None, :, 0] - cx) / fx,
                       (v_pt[:, None] + offs[None, :, 1] - cy) / fy,
                       torch.ones_like(u_pt)[:, None].expand(-1, 8)], -1)
    ptp = (P.matvec(Rc[host][:, :, None], pat[:, None])
           + m(tc[host][:, :, None, :],
               st["p_idepth"].to(d)[:, None, None, None]))
    Ku = ptp[..., 0] / ptp[..., 2] * fx + cx
    Kv = ptp[..., 1] / ptp[..., 2] * fy + cy
    pat_ok = ((ptp[..., 2] > 1e-6) & (Ku > 1.1) & (Kv > 1.1)
              & (Ku < width - 3) & (Kv < height - 3))
    # the target frame's intensity and central differences at the pattern
    # (the 4x4 neighbourhood's bilinear value and gradients)
    Hh, Ww = planes.shape[1:]
    f = torch.arange(Fn, device=dev)[None, :, None].expand_as(Ku)
    uc = torch.clamp(torch.nan_to_num(Ku, nan=-8.0), -8.0, Ww + 8.0)
    vc = torch.clamp(torch.nan_to_num(Kv, nan=-8.0), -8.0, Hh + 8.0)
    in_tile = (uc >= 1.0) & (uc < Ww - 2.0) & (vc >= 1.0) & (vc < Hh - 2.0)
    x0, y0 = torch.floor(uc), torch.floor(vc)
    fxr, fyr = uc - x0, vc - y0
    x0l, y0l = x0.long(), y0.long()
    img = planes.to(d)

    def tap(dy, dx):
        yy, xx = y0l + dy, x0l + dx
        inb = (xx >= 0) & (xx < Ww) & (yy >= 0) & (yy < Hh)
        val = img[f, yy.clamp(0, Hh - 1), xx.clamp(0, Ww - 1)]
        return torch.where(inb, val, torch.zeros_like(val))

    w00, w01 = m(1 - fxr, 1 - fyr), m(fxr, 1 - fyr)
    w10, w11 = m(1 - fxr, fyr), m(fxr, fyr)

    def interp(p00, p01, p10, p11):
        return m(w00, p00) + m(w01, p01) + m(w10, p10) + m(w11, p11)

    p = {(dy, dx): tap(dy, dx) for dy in range(-1, 3) for dx in range(-1, 3)
         if not (dy in (-1, 2) and dx in (-1, 2))}
    I_t = interp(p[0, 0], p[0, 1], p[1, 0], p[1, 1])
    gx = 0.5 * interp(p[0, 1] - p[0, -1], p[0, 2] - p[0, 0],
                      p[1, 1] - p[1, -1], p[1, 2] - p[1, 0])
    gy = 0.5 * interp(p[1, 0] - p[-1, 0], p[1, 1] - p[-1, 1],
                      p[2, 0] - p[0, 0], p[2, 1] - p[0, 1])

    color = st["p_color"].to(d)[:, None, :]
    pred = m(a_rel[host][..., None], color) + b_rel[host][..., None]
    residual = I_t - pred
    finite = in_tile & torch.isfinite(I_t)
    w_grad = torch.sqrt(outlier_th_sum / (outlier_th_sum + m(gx, gx)
                                          + m(gy, gy)))
    w = 0.5 * (w_grad + st["p_weight"].to(d)[:, None, :])
    not_host = torch.arange(Fn, device=dev)[None, :] != host[:, None]
    struct = (st["r_active"] & (st["p_status"][:, None] != 0)
              & st["frame_valid"][None, :] & not_host)
    tap_ok = pat_ok & finite
    usable = struct & center_ok & torch.all(tap_ok, -1)
    return {"residual": residual, "weight": w, "tap_ok": tap_ok,
            "usable": usable, "Ku": Ku, "Kv": Kv, "gx": gx, "gy": gy,
            "pred": pred, "Kuc": Kuc, "Kvc": Kvc}


def ba_pair_energy(st, planes, height: int, width: int, huber_th: float,
                   outlier_th_sum: float, P: Precision):
    """The window BA's photometric energy of every (point, target frame)
    pair (``ba_terms``' residuals, Huber-weighted per pixel, weighted,
    summed over the in-image pixels); pairs not usable are 0. Returns
    (energy [P, F], usable [P, F], the pattern's (Ku, Kv) [P, F, 8])."""
    t = ba_terms(st, planes, height, width, outlier_th_sum, P)
    residual, w, usable = t["residual"], t["weight"], t["usable"]
    m = P.mul
    hw = huber(residual, huber_th)[1]
    energy_k = m(m(m(w, w), hw), m(residual, residual)) * (2.0 - hw)
    energy = torch.sum(torch.where(t["tap_ok"], energy_k,
                                   torch.zeros_like(energy_k)), -1)
    return (torch.where(usable, energy, torch.zeros_like(energy)), usable,
            (t["Ku"], t["Kv"]))


# ---------------------------------------------------------------------------
# the reference's own solve: the energy it can still take off an answer
# ---------------------------------------------------------------------------
#
# Each of the program's solvers (the coarse track's LM, the window BA's
# Gauss-Newton, the event LM) returns a point where its energy is at a
# minimum. The reference builds its own float64 normal equations at that
# point (Jacobians by forward-mode differentiation of the residuals above,
# IRLS weights of Huber's loss), solves them, and steps on while the
# energy falls (Levenberg-Marquardt). ``left`` is the share of the energy
# that it took off: about 0 where the program's solve converged, the whole
# step where it returned its start, a large share where it stepped short
# or astray. The set of terms (valid pixels, usable pairs, the keyframe's
# mask) is held at the program's answer, so that no term is dropped to
# gain energy.

def huber(r, k):
    """(Huber's loss in DSO's scaling, r^2 within k and 2k|r| - k^2
    beyond; its IRLS weight, 1 within k and k/|r| beyond)."""
    a = torch.abs(r)
    w = torch.where(a < k, torch.ones_like(a),
                    k / torch.clamp(a, min=1e-12))
    return w * r * r * (2.0 - w), w


def _jacobian(fn, n: int, x, chunk: int = 16):
    """d fn / dx [..., n] at x [n] (forward mode, ``chunk`` tangents at a
    time)."""
    basis = torch.eye(n, dtype=x.dtype, device=x.device)
    cols = torch.func.vmap(lambda v: torch.func.jvp(fn, (x,), (v,))[1],
                           chunk_size=chunk)(basis)
    return torch.movedim(cols, 0, -1)


def lm_refine(residuals, energy, n: int, device, iterations: int = 50):
    """Levenberg-Marquardt on theta [n] from 0. ``residuals(theta)`` ->
    (r [N], IRLS weight [N]); ``energy(theta)`` -> the energy. Returns
    (the energy at 0, the least energy found, theta there)."""
    d = torch.float64
    theta = torch.zeros(n, dtype=d, device=device)
    e0 = e = float(energy(theta))
    lam = 1e-4
    eye = torch.eye(n, dtype=d, device=device)
    for _ in range(iterations):
        r, w = residuals(theta)
        J = _jacobian(lambda t: residuals(t)[0], n, theta)
        J = torch.where(torch.isfinite(J), J, torch.zeros_like(J))
        r = torch.nan_to_num(r)
        H = J.T @ (w[:, None] * J)
        g = J.T @ (w * r)
        while lam < 1e10:
            step = -torch.linalg.solve(
                H + lam * torch.diag(torch.diagonal(H)) + 1e-12 * eye, g)
            e_new = float(energy(theta + step))
            if e_new < e:
                break
            lam *= 10.0
        else:
            break
        theta = theta + step
        gain = e - e_new
        e = e_new
        lam = max(lam * 0.3, 1e-12)
        if gain <= 1e-13 * e0:
            break
    return e0, e, theta


def _left(e0: float, e: float, scale: float) -> float:
    return max(e0 - e, 0.0) / max(scale, 1e-300)


def track_energy_left(img, tpl, cam, R, t, rel_a, rel_b, huber_th: float,
                      cutoff: float):
    """The share of the coarse track's finest-level energy (``track_rms``'s,
    in float64, over the template pixels valid at the program's pose) that
    the reference's own solve takes off the program's refToNew (R, t) and
    affine brightness (rel_a, rel_b): 8 parameters, the pose's twist
    (left) and the affine factor's log and offset."""
    P = REFERENCE
    d = torch.float64
    u, v, idp, color = (a.to(d) for a in tpl[:4])
    dI = frame_level0(img, P)
    H, W = dI.shape[:2]
    R, t = R.to(d), t.to(d)
    Kip = torch.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                       torch.ones_like(u)], -1)
    pt = Kip @ R.T + t * idp[:, None]
    Ku = cam.fx * (pt[:, 0] / pt[:, 2]) + cam.cx
    Kv = cam.fy * (pt[:, 1] / pt[:, 2]) + cam.cy
    valid = (tpl[4] & (Ku > 2) & (Kv > 2) & (Ku < W - 3) & (Kv < H - 3)
             & (idp / pt[:, 2] > 0))
    hit = bilinear(dI, Ku, Kv, P)[:, 0]
    valid = valid & torch.isfinite(hit)
    Kip, idp, color = Kip[valid], idp[valid], color[valid]
    rel_a, rel_b = torch.as_tensor(rel_a, dtype=d), torch.as_tensor(
        rel_b, dtype=d)
    sat_e = 2.0 * huber_th * cutoff - huber_th * huber_th

    def res(theta):
        Re, te = se3_exp(theta[:6])
        Rn, tn = Re @ R, Re @ t + te
        q = Kip @ Rn.T + tn * idp[:, None]
        x = cam.fx * (q[:, 0] / q[:, 2]) + cam.cx
        y = cam.fy * (q[:, 1] / q[:, 2]) + cam.cy
        val = bilinear(dI, x, y, P)[:, 0]
        r = val - (rel_a * torch.exp(theta[6]) * color + rel_b + theta[7])
        e, w = huber(r, huber_th)
        sat = torch.abs(r) > cutoff
        return r, e, torch.where(sat, torch.zeros_like(w), w), sat

    def residuals(theta):
        r, _, w, _ = res(theta)
        return r, w

    def energy(theta):
        _, e, _, sat = res(theta)
        return torch.sum(torch.where(sat, torch.full_like(e, sat_e), e))

    e0, e, _ = lm_refine(residuals, energy, 8, img.device)
    return _left(e0, e, e0)


def _rotation(w):
    """Rotation matrix of the rotation vector w [3] (Rodrigues)."""
    return se3_exp(torch.cat([torch.zeros_like(w), w]))[0]


def event_energy_left(frame, cam, norm_coord, grad, idepth, weight, mask,
                      px, qx, vx, huber_k: float = 1.345):
    """The share of the event-to-model energy (``event_residuals`` in
    float64, Huber's loss at ``huber_k`` times the residuals' MAD at the
    program's state) that the reference's own solve takes off the
    program's tracker state: 12 parameters, the translation, the
    rotation's vector (left) and the velocity (renormalized)."""
    P = REFERENCE
    d = torch.float64
    R0 = quat_to_mat(qx.to(d))
    px, vx = px.to(d), vx.to(d)
    r0 = event_residuals(frame, cam, norm_coord, grad, idepth, weight, mask,
                         px, qx, vx, P)[mask]
    med = torch.median(r0)
    scale = max(float(huber_k * 1.4826 * torch.median(torch.abs(r0 - med))),
                1e-6)

    def residuals(theta):
        v = vx + theta[6:12]
        v = v / torch.linalg.vector_norm(v)
        r = event_residuals(frame, cam, norm_coord, grad, idepth, weight,
                            mask, px + theta[0:3], None, v, P,
                            R=_rotation(theta[3:6]) @ R0)[mask]
        return r, huber(r, scale)[1]

    def energy(theta):
        return torch.sum(huber(residuals(theta)[0], scale)[0])

    e0, e, _ = lm_refine(residuals, energy, 12, frame.device)
    return _left(e0, e, e0)


def _nullspace(delta, T_eval_R, T_eval_t, frame_valid):
    """The window's gauge directions [8 F, 7] at the current poses: the six
    global rigid motions (minus each frame's adjoint) and the global scale
    (each frame's translation), zero on the affine rows and on invalid
    frames, unit columns."""
    Fn = delta.shape[0]
    Re, te = se3_exp(delta[:, :6])
    R = Re @ T_eval_R
    t = (Re @ T_eval_t[..., None])[..., 0] + te
    adj = torch.cat([torch.cat([R, _hat(t) @ R], -1),
                     torch.cat([torch.zeros_like(R), R], -1)], -2)
    scale = torch.cat([t, torch.zeros_like(t)], -1)[..., None]
    cols = torch.cat([-adj, scale], -1)                      # [F, 6, 7]
    cols = cols * frame_valid[:, None, None].to(cols.dtype)
    N = torch.cat([cols, torch.zeros_like(cols[:, :2])], 1).reshape(8 * Fn,
                                                                     7)
    return N / torch.clamp(torch.linalg.vector_norm(N, dim=0), min=1e-12)


def ba_solve(st, prior, planes, height: int, width: int, kw: dict,
             P: Precision = REFERENCE):
    """The window BA's own solve at ``P``, from the state it started from
    (``st``, ``prior`` as for ``ba_terms``' state and {``frame_prior``,
    ``frame_prior_delta0``, ``HM``, ``bM``, ``p_prior``}; ``st`` also holds
    ``frame_energy_th``), as DSO runs it (FullSystem::optimize with
    FIX_LAMBDA and forceAcceptStep): ``kw["iterations"]`` Gauss-Newton
    steps, each from the residuals at the current state with first-estimate
    Jacobians (the target's image gradients at the current projection, the
    centre's projection's and the affine factors' derivatives at the
    linearization point: every frame's ``T_eval`` and ``aff_eval``, every
    point's ``p_idepth_zero``), IRLS weights of Huber's loss, DSO's outlier pairs
    (energy over either frame's threshold, or too little weighted
    gradient) left out of the system; the priors on the frames, the
    marginalization prior and the points' idepth priors; the damping
    ``kw["lam"]`` on the frames' diagonal and the points'; the system
    reduced to the frames by the points' Schur complement; the frames'
    step projected off the gauge (``_nullspace``) from
    ``kw["orth_from_iteration"]`` on; idepths kept at 1e-5 or more; a stop
    once the energy improves by less than ``kw["break_tol"]`` (relative)
    after ``kw["min_iterations"]``. The calibration is held (its prior is
    5e9). Every step to ``kw["iterations"]`` is taken. Returns ([(delta
    [F, 8], p_idepth [P]) after each step], the steps the stop would have
    taken). The first-estimate derivatives are taken in float64 and, as
    every product's operands, rounded to ``P``."""
    d = P.dtype
    dev = st["delta"].device
    st64 = {k: (v.to(torch.float64) if torch.is_tensor(v)
                and v.is_floating_point() else v) for k, v in st.items()}
    st = {k: (v.to(d) if torch.is_tensor(v) and v.is_floating_point()
              else v) for k, v in st.items()}
    Fn = st["delta"].shape[0]
    nf = 8 * Fn
    pz = st64["p_idepth_zero"]
    huber_th, outlier = kw["huber_th"], kw["outlier_th_sum"]
    lam = kw["lam"]

    def geo(dl, ip, xi=None):
        g = ba_terms(dict(st64, delta=dl.reshape(Fn, 8), p_idepth=ip),
                     planes, height, width, outlier, REFERENCE, xi)
        return torch.stack([g["Kuc"][..., None].expand_as(g["pred"]),
                            g["Kvc"][..., None].expand_as(g["pred"]),
                            g["pred"]])
    # the first-estimate derivatives, as DSO takes them: the centre's
    # projection (for every pixel of the pattern) by its pair's relative
    # pose, moved on the left, the frames' poses reached through the
    # pairs' adjoints (setAdjointsF: the target's identity, the host's
    # minus the relative pose's adjoint); the colour by the affine factors;
    # the projection by the point's inverse depth
    f64 = dict(dtype=torch.float64, device=dev)
    zero_delta = torch.zeros(nf, **f64)
    dK_rel = torch.func.vmap(                             # [6, 3, P, F, 8]
        lambda v: torch.func.jvp(lambda xi: geo(zero_delta, pz, xi),
                                 (torch.zeros(6, **f64),), (v,))[1])(
        torch.eye(6, **f64))
    aff_dirs = torch.zeros(2 * Fn, nf, **f64)
    aff_dirs[torch.arange(2 * Fn), (8 * torch.arange(Fn)[:, None]
                                    + torch.tensor([6, 7])).reshape(-1)] = 1
    dK_aff = torch.func.vmap(                          # [2F, 3, P, F, 8]
        lambda v: torch.func.jvp(lambda dl: geo(dl, pz), (zero_delta,),
                                 (v,))[1],
        chunk_size=8)(aff_dirs)
    dK_d = torch.func.jvp(lambda ip: geo(zero_delta, ip), (pz,),
                          (torch.ones_like(pz),))[1]    # [3, P, F, 8]
    Re0, te0 = st64["T_eval_R"], st64["T_eval_t"]
    Rh_inv = Re0.transpose(-1, -2)
    R_th = Re0[None, :] @ Rh_inv[:, None]                # [host, target]
    t_th = (Re0[None, :] @ (-(Rh_inv @ te0[..., None]))[:, None])[..., 0] \
        + te0[None, :]
    adj = torch.cat([torch.cat([R_th, _hat(t_th) @ R_th], -1),
                     torch.cat([torch.zeros_like(R_th), R_th], -1)], -2)
    host0 = st64["p_host"].long()
    A_h = -adj[host0]                                   # [P, F, 6, 6]
    onehot_f = torch.eye(Fn, **f64)
    onehot_h = torch.nn.functional.one_hot(host0, Fn).to(torch.float64)
    dK_rel = torch.nan_to_num(dK_rel)
    dK_aff = torch.nan_to_num(dK_aff)
    dK_d = torch.nan_to_num(dK_d).to(d)
    pz = pz.to(d)
    m = P.mul

    def frame_jacobian(gx, gy):
        """[8 F, P, F, 8]: each residual's derivative by every frame's
        eight parameters."""
        gx64, gy64 = gx.to(torch.float64), gy.to(torch.float64)
        jr = gx64 * dK_rel[:, 0] + gy64 * dK_rel[:, 1]  # [6, P, F, 8]
        jh = torch.einsum("cpfk,pfcd->dpfk", jr, A_h)
        pose = (torch.einsum("cpfk,fg->gcpfk", jr, onehot_f)
                + torch.einsum("cpfk,pg->gcpfk", jh, onehot_h))
        aff = -dK_aff[:, 2].reshape(Fn, 2, *jr.shape[1:])
        return torch.cat([pose, aff], 1).reshape(nf, *jr.shape[1:]).to(d)

    fvalid = st["frame_valid"]
    fmask = fvalid[:, None].expand(Fn, 8).reshape(-1)
    fp = prior["frame_prior"].to(d) * fvalid[:, None].to(d)
    fd0 = prior["frame_prior_delta0"].to(d)
    HM, bM = prior["HM"].to(d), prior["bM"].to(d)
    pp = prior["p_prior"].to(d)
    ncal = st["c_delta"].shape[0]
    host = st["p_host"].long()
    th = st["frame_energy_th"]
    active_pt = st["p_status"] == 1
    eye = torch.eye(nf, dtype=d, device=dev)

    delta, idp = st["delta"], st["p_idepth"]
    e_last, stop, path = math.inf, None, []
    for it in range(kw["iterations"]):
        t = ba_terms(dict(st, delta=delta, p_idepth=idp), planes, height,
                     width, outlier, P)
        keep = t["usable"][..., None] & t["tap_ok"]
        zero = torch.zeros_like(t["residual"])
        r = torch.where(keep, t["residual"], zero)
        e, hw = huber(r, huber_th)
        w2 = m(t["weight"], t["weight"])
        e_pair = torch.sum(torch.where(keep, m(w2, e), zero), -1)
        energy = float(torch.sum(e_pair))
        gx, gy = t["gx"], t["gy"]
        grad2 = torch.sum(torch.where(keep, m(m(w2, hw), m(gx, gx)
                                              + m(gy, gy)), zero), -1)
        inlier = t["usable"] & ~(
            (e_pair > torch.maximum(th[host][:, None], th[None, :]))
            | (grad2 < 2.0))
        keep = keep & inlier[..., None]
        W = torch.where(keep, m(w2, hw), zero)
        Jf = torch.where(keep, frame_jacobian(gx, gy), zero)
        jd = torch.where(keep, m(gx, dK_d[0]) + m(gy, dK_d[1]), zero)

        x = torch.cat([st["c_delta"], delta.reshape(-1)])
        JW = m(Jf, W)
        q = P.q
        Hff = (torch.einsum("apfk,bpfk->ab", q(JW), q(Jf))
               + torch.diag(fp.reshape(-1)) + HM[ncal:, ncal:])
        gf = (torch.einsum("apfk,pfk->a", q(JW), q(r))
              + (fp * (delta - fd0)).reshape(-1)
              + (q(HM) @ q(x) + bM)[ncal:])
        Hfd = torch.einsum("apfk,pfk->ap", q(JW), q(jd))
        Hdd = torch.sum(m(W, m(jd, jd)), (1, 2)) + pp
        gd = torch.sum(m(W, m(jd, r)), (1, 2)) + pp * (idp - pz)
        pt_ok = active_pt & (Hdd > 1e-10)
        Hdl = torch.where(pt_ok, Hdd * (1.0 + lam), torch.ones_like(Hdd))
        Vw = Hfd * (pt_ok.to(d) / Hdl)[None, :]
        Hs = Hff + lam * torch.diag(torch.diagonal(Hff)) - q(Vw) @ q(Hfd.T)
        gs = gf - q(Vw) @ q(gd)
        act = fmask & (torch.abs(torch.diagonal(Hs)) > 1e-10)
        Hs = torch.where(act[:, None] & act[None, :], Hs, torch.zeros_like(Hs))
        Hs = Hs + torch.diag((~act).to(d))
        # solved scaled by the diagonal, as DSO does (the gauge directions
        # are nearly singular; their part is projected off below)
        sv = 1.0 / torch.sqrt(torch.abs(torch.diagonal(Hs)) + 10.0)
        xs = sv * torch.linalg.solve(Hs * sv[:, None] * sv[None, :]
                                     + 1e-10 * eye, gs * sv)
        xs = torch.where(act, xs, torch.zeros_like(xs))
        if it >= kw["orth_from_iteration"]:
            N = _nullspace(delta, st["T_eval_R"], st["T_eval_t"], fvalid)
            G = q(N.T) @ q(N) + 1e-10 * torch.eye(7, dtype=d, device=dev)
            xs = xs - q(N) @ q(torch.linalg.solve(G, q(N.T) @ q(xs)))
        sd = torch.where(pt_ok, (q(Hfd.T) @ q(xs) - gd) / Hdl,
                         torch.zeros_like(gd))
        rel = abs(e_last - energy) / max(e_last, 1e-12)
        if stop is None and (kw["break_tol"] > 0 and rel < kw["break_tol"]
                             and it + 1 >= kw["min_iterations"]):
            stop = it + 1
        e_last = energy
        delta = delta - xs.reshape(Fn, 8) * fvalid[:, None].to(d)
        idp = torch.clamp(idp + sd, min=1e-5)
        path.append((delta, idp))
    return path, stop or kw["iterations"]


def ba_energy(st, planes, height: int, width: int, huber_th: float,
              outlier_th_sum: float):
    """The window BA's photometric energy in float64 at ``st`` (the sum of
    ``ba_pair_energy``)."""
    return float(torch.sum(ba_pair_energy(st, planes, height, width,
                                          huber_th, outlier_th_sum,
                                          REFERENCE)[0]))


# ---------------------------------------------------------------------------
# the comparison
# ---------------------------------------------------------------------------

def rel_gap(prog, ref, mask):
    """The largest gap |prog - ref| / (|ref| + median |ref|) over ``mask``
    (a NaN on one side only, or a non-finite gap, reads inf; NaN on both
    sides matches); 0 where the mask is empty."""
    prog = prog.to(torch.float64)
    ref = ref.to(torch.float64)
    if not bool(mask.any()):
        return 0.0
    p, r = prog[mask], ref[mask]
    both_nan = torch.isnan(p) & torch.isnan(r)
    scale = torch.median(torch.abs(torch.nan_to_num(r)))
    g = torch.abs(p - r) / (torch.abs(r) + scale + 1e-300)
    g = torch.where(both_nan, torch.zeros_like(g),
                    torch.nan_to_num(g, nan=math.inf, posinf=math.inf))
    return float(g.max())


def scalar_gap(prog: float, ref: float) -> float:
    """|prog - ref| / |ref| (inf where either is not finite)."""
    if not (math.isfinite(prog) and math.isfinite(ref)):
        return math.inf
    return abs(prog - ref) / max(abs(ref), 1e-300)
