"""Inverse-compositional KLT point tracking — port of the tracking part of
``slam_eds_tpu.utils.klt`` (``klt_track``, ``klt_track_pyramid``)."""
from __future__ import annotations

import torch

from .interp import bilinear


def _patch_grid(radius: int, dtype, device):
    r = torch.arange(-radius, radius + 1, dtype=dtype, device=device)
    dy, dx = torch.meshgrid(r, r, indexing="ij")
    return dx.reshape(-1), dy.reshape(-1)


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
