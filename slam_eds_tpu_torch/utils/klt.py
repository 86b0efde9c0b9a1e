"""Sparse point tracking — port of ``slam_eds_tpu.utils.klt``:
inverse-compositional KLT (``klt_track``, ``klt_track_pyramid``), the patch
similarity measures, the discrete template search along an epipolar segment
(``search_along_epiline``) and over a window (``match_template``), and the
epipolar-geometry helpers.

The searches take the best of S candidates per point; a tie (flat patches
where the event frame is zero) goes to the lowest candidate index, as
``jnp.argmax`` does, on every device."""
from __future__ import annotations

import torch

from .interp import bilinear
from .lie import hat


def _patch_grid(radius: int, dtype, device):
    r = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


def extract_patches(img, uv, radius: int):
    """Bilinear patches [N, (2r+1)^2] centered at uv [N, 2]."""
    dx, dy = _patch_grid(radius, uv.dtype, uv.device)
    return bilinear(img, uv[:, 0:1] + dx[None, :], uv[:, 1:2] + dy[None, :])


# similarity measures; a, b: [..., K] patch vectors

def ssd(a, b):
    return torch.sum((a - b) ** 2, -1)


def nssd(a, b):
    return ssd(a, b) / torch.clamp(torch.sqrt(
        torch.sum(a * a, -1) * torch.sum(b * b, -1)), min=1e-12)


def zssd(a, b):
    return ssd(a - a.mean(-1, keepdim=True), b - b.mean(-1, keepdim=True))


def sad(a, b):
    return torch.sum(torch.abs(a - b), -1)


def zsad(a, b):
    return sad(a - a.mean(-1, keepdim=True), b - b.mean(-1, keepdim=True))


def ncc(a, b):
    den = torch.sqrt(torch.sum(a * a, -1) * torch.sum(b * b, -1))
    return torch.sum(a * b, -1) / torch.clamp(den, min=1e-12)


def zncc(a, b):
    return ncc(a - a.mean(-1, keepdim=True), b - b.mean(-1, keepdim=True))


_SIMILARITIES = {"zncc": zncc, "ncc": ncc}
_DISTANCES = {"ssd": ssd, "zssd": zssd, "sad": sad, "zsad": zsad,
              "nssd": nssd}


def klt_track(img_ref, img_new, uv0, uv_init=None, radius: int = 4,
              iterations: int = 10, min_det: float = 1e-6):
    """Track points uv0 [N, 2] from img_ref into img_new ([H, W] each).
    Returns (uv_new [N, 2], ok [N], mean abs residual [N])."""
    dx, dy = _patch_grid(radius, uv0.dtype, uv0.device)
    xs0 = uv0[:, 0:1] + dx[None, :]
    ys0 = uv0[:, 1:2] + dy[None, :]
    T = bilinear(img_ref, xs0, ys0)
    eps = 0.5
    gx = (bilinear(img_ref, xs0 + eps, ys0)
          - bilinear(img_ref, xs0 - eps, ys0)) / (2 * eps)
    gy = (bilinear(img_ref, xs0, ys0 + eps)
          - bilinear(img_ref, xs0, ys0 - eps)) / (2 * eps)
    Gxx = torch.sum(gx * gx, -1)
    Gxy = torch.sum(gx * gy, -1)
    Gyy = torch.sum(gy * gy, -1)
    det = Gxx * Gyy - Gxy * Gxy
    ok_grad = det > min_det
    inv_det = torch.where(ok_grad, 1.0 / torch.clamp(det, min=min_det),
                          torch.zeros_like(det))

    uv = uv0 if uv_init is None else uv_init
    for _ in range(iterations):
        e = bilinear(img_new, uv[:, 0:1] + dx[None, :],
                     uv[:, 1:2] + dy[None, :]) - T
        bx = torch.sum(gx * e, -1)
        by = torch.sum(gy * e, -1)
        du = (Gyy * bx - Gxy * by) * inv_det
        dv = (Gxx * by - Gxy * bx) * inv_det
        uv = uv - torch.stack([du, dv], -1)
    H, W = img_new.shape
    inb = (uv[:, 0] > radius) & (uv[:, 0] < W - radius - 1) \
        & (uv[:, 1] > radius) & (uv[:, 1] < H - radius - 1)
    I = bilinear(img_new, uv[:, 0:1] + dx[None, :], uv[:, 1:2] + dy[None, :])
    res = torch.mean(torch.abs(I - T), -1)
    return uv, ok_grad & inb & torch.isfinite(res), res


def klt_track_pyramid(pyr_ref, pyr_new, uv0, radius: int = 4,
                      iterations: int = 10):
    """Coarse-to-fine KLT over [H, W] image pyramids (level 0 finest)."""
    n_levels = len(pyr_ref)
    guess = uv0 * 0.5 ** (n_levels - 1)
    for lvl in range(n_levels - 1, -1, -1):
        guess, ok, res = klt_track(pyr_ref[lvl], pyr_new[lvl],
                                   uv0 * 0.5 ** lvl, uv_init=guess,
                                   radius=radius, iterations=iterations)
        if lvl > 0:
            guess = guess * 2.0
    return guess, ok, res


def _best_candidate(T, img_new, cand, radius: int, measure: str):
    """Score the patch of img_new at every candidate [N, S, 2] against the
    template T [N, K]; returns (the best candidate [N, 2], its score [N]):
    similarity for ncc/zncc, negated distance for the others. Ties, and NaN
    scores (which win, as in ``jnp.argmax``), go to the lowest index."""
    dx, dy = _patch_grid(radius, cand.dtype, cand.device)
    P = bilinear(img_new, cand[..., 0:1] + dx, cand[..., 1:2] + dy)  # [N,S,K]
    Tb = T[:, None, :].expand(P.shape)
    if measure in _SIMILARITIES:
        score = _SIMILARITIES[measure](Tb, P)
    else:
        score = -_DISTANCES[measure](Tb, P)
    nan = torch.isnan(score)
    key = torch.where(nan, torch.full_like(score, float("inf")), score)
    top = key.max(dim=1, keepdim=True).values
    S = score.shape[1]
    idx = torch.arange(S, device=score.device).expand(score.shape)
    best = torch.where(key == top, idx, torch.full_like(idx, S - 1)).min(1)
    best = best.values
    uv_best = torch.gather(cand, 1, best[:, None, None].expand(-1, 1, 2))
    return uv_best[:, 0, :], torch.gather(score, 1, best[:, None])[:, 0]


def search_along_epiline(img_ref, img_new, uv0, line_dir, search_range,
                         radius: int = 3, num_steps: int = 32,
                         measure: str = "zncc", uv_tpl=None):
    """Discrete patch search along per-point epipolar directions.

    line_dir: [N, 2] unit directions; search_range: half-range in pixels.
    uv_tpl: optional [N, 2] template centers in img_ref (defaults to uv0).
    Returns (uv_best [N, 2], score [N])."""
    T = extract_patches(img_ref, uv0 if uv_tpl is None else uv_tpl, radius)
    # the steps as ``jnp.linspace`` builds them: a blend of the two ends
    frac = torch.arange(num_steps, dtype=uv0.dtype,
                        device=uv0.device) / (num_steps - 1)
    steps = -search_range * (1.0 - frac) + search_range * frac
    cand = uv0[:, None, :] + steps[None, :, None] * line_dir[:, None, :]
    return _best_candidate(T, img_new, cand, radius, measure)


def match_template(img_ref, img_new, uv0, radius: int = 3,
                   search_radius: int = 8, measure: str = "zncc"):
    """Dense window search of each point's patch in the new image. Returns
    (uv_best [N, 2], best_score [N])."""
    T = extract_patches(img_ref, uv0, radius)
    ox, oy = _patch_grid(search_radius, uv0.dtype, uv0.device)
    cand = uv0[:, None, :] + torch.stack([ox, oy], -1)[None, :, :]
    return _best_candidate(T, img_new, cand, radius, measure)


def fundamental_from_pose(T_21, K):
    """F = K^-T [t]x R K^-1 for the relative pose T_21 (target <- ref)."""
    Kinv = torch.linalg.inv_ex(K)[0]    # no info check: no host read
    return Kinv.T @ (hat(T_21.t) @ T_21.R) @ Kinv


def epiline_directions(F, uv):
    """Per-point epipolar line directions in the target image for ref pixels
    uv [N, 2]: the line l = F [u, v, 1]^T has direction (b, -a)/|(a, b)|."""
    l = torch.cat([uv, torch.ones_like(uv[:, :1])], -1) @ F.T
    d = torch.stack([l[:, 1], -l[:, 0]], -1)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)
