"""Bilinear and bicubic image sampling — port of
``slam_eds_tpu.utils.interp``.

The JAX module routes every sampler through 2x2/4x4 patch block-gathers or
one-hot matmuls to avoid TPU element gathers (``_fetch_patches``,
``pattern_mm_sample``); on a GPU the plain index gather is the fast form, so
only the semantics are kept:

* floor-based fractional weights with PER-TAP edge clamping (each of the two
  taps per axis clamps to ``[0, n-1]`` on its own, like
  ``getInterpolatedElement``/``ceres::Grid2D``),
* coordinates cleaned to ``[-4, n+4]`` (NaN -> -4) before indexing,
* NaN poisoning: wherever a query coordinate is not finite the result is
  NaN — callers gate bad warps with ``isfinite`` on the sampled value.
"""
from __future__ import annotations

import torch


def _clean_coords(x, hi):
    return torch.clamp(torch.nan_to_num(x, nan=-4.0), -4.0, hi + 4.0)


def bilinear(img, x, y, frame=None):
    """Bilinear sample of img at (x=col, y=row).

    img: [H, W] or [H, W, C]; with ``frame`` (an integer tensor broadcastable
    against x/y) img is a stack [F, H, W(, C)] and each query reads
    ``img[frame]``. Returns x's broadcast shape (plus C).
    """
    x, y = torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y))
    if frame is None:
        H, W = img.shape[0], img.shape[1]
        nch = img.dim() - 2
    else:
        H, W = img.shape[1], img.shape[2]
        nch = img.dim() - 3
    xc = _clean_coords(x, W)
    yc = _clean_coords(y, H)
    x0 = torch.floor(xc)
    y0 = torch.floor(yc)
    dx = xc - x0
    dy = yc - y0
    ix0 = x0.long()
    iy0 = y0.long()
    ix = (torch.clamp(ix0, 0, W - 1), torch.clamp(ix0 + 1, 0, W - 1))
    iy = (torch.clamp(iy0, 0, H - 1), torch.clamp(iy0 + 1, 0, H - 1))
    if nch:
        dx, dy = dx[..., None], dy[..., None]

    def tap(r, c):
        if frame is None:
            return img[iy[r], ix[c]]
        return img[frame, iy[r], ix[c]]

    row0 = tap(0, 0) * (1.0 - dx) + tap(0, 1) * dx
    row1 = tap(1, 0) * (1.0 - dx) + tap(1, 1) * dx
    val = row0 * (1.0 - dy) + row1 * dy
    bad = ~(torch.isfinite(x) & torch.isfinite(y))
    if nch:
        bad = bad[..., None]
    return torch.where(bad, torch.full_like(val, float("nan")), val)


def bilinear_3(img3, x, y, frame=None):
    """Bilinear sample of a [H, W, 3] ([I, gx, gy]) stack."""
    return bilinear(img3, x, y, frame)


def _cubic_weights(t):
    """Keys cubic-convolution weights, a = -0.5 (Catmull-Rom, as
    ceres::BiCubicInterpolator), for taps at offsets -1, 0, 1, 2."""
    t2 = t * t
    t3 = t2 * t
    w0 = -0.5 * t3 + t2 - 0.5 * t
    w1 = 1.5 * t3 - 2.5 * t2 + 1.0
    w2 = -1.5 * t3 + 2.0 * t2 + 0.5 * t
    w3 = 0.5 * t3 - 0.5 * t2
    return w0, w1, w2, w3


def _cubic_weights_d(t):
    """d/dt of the Keys weights."""
    t2 = t * t
    d0 = -1.5 * t2 + 2.0 * t - 0.5
    d1 = 4.5 * t2 - 5.0 * t
    d2 = -4.5 * t2 + 4.0 * t + 0.5
    d3 = 1.5 * t2 - t
    return d0, d1, d2, d3


def bicubic(img, x, y):
    """Bicubic (Catmull-Rom) sample of img [H, W] at (x=col, y=row)."""
    return bicubic_with_grad(img, x, y)[0]


def bicubic_with_grad(img, x, y):
    """Bicubic sample of img [H, W] plus its analytic spatial gradient
    (d/dx, d/dy): separable Keys kernel over the 4x4 taps, each tap index
    clamped to the image on its own (``clip(ix - 1 + t, 0, W - 1)``), as 16
    plain gathers per query. Non-finite queries give NaN in all three."""
    x, y = torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y))
    H, W = img.shape
    xc = _clean_coords(x, W)
    yc = _clean_coords(y, H)
    x0 = torch.floor(xc)
    y0 = torch.floor(yc)
    wx = _cubic_weights(xc - x0)
    dwx = _cubic_weights_d(xc - x0)
    wy = _cubic_weights(yc - y0)
    dwy = _cubic_weights_d(yc - y0)
    ix = x0.long() - 1
    iy = y0.long() - 1
    cols = [torch.clamp(ix + t, 0, W - 1) for t in range(4)]
    flat = img.reshape(-1)
    rows_v, rows_dx = [], []
    for r in range(4):
        base = torch.clamp(iy + r, 0, H - 1) * W
        taps = [flat[base + c] for c in cols]
        rows_v.append(sum(w * p for w, p in zip(wx, taps)))
        rows_dx.append(sum(w * p for w, p in zip(dwx, taps)))
    f = sum(w * v for w, v in zip(wy, rows_v))
    dfdx = sum(w * v for w, v in zip(wy, rows_dx))
    dfdy = sum(w * v for w, v in zip(dwy, rows_v))
    bad = ~(torch.isfinite(x) & torch.isfinite(y))
    nan = torch.full_like(f, float("nan"))
    return (torch.where(bad, nan, f), torch.where(bad, nan, dfdx),
            torch.where(bad, nan, dfdy))
