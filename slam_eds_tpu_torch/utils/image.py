"""Image primitives: pyramids, gradients, separable filters — port of
``slam_eds_tpu.utils.image``.

Separable correlations are sums of shifted slices (no cuDNN, so no TF32
question on the card); reflect-101 borders match OpenCV's default.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .interp import bilinear

# DSO residual pattern: 8 offsets (dx, dy), "residualPattern 8"
# (src/utils/settings.h:203-215 of the reference).
PATTERN_DSO8 = np.array(
    [[0, -2], [-1, -1], [1, -1], [-2, 0], [0, 0], [2, 0], [-1, 1], [0, 2]],
    dtype=np.int32)
PATTERN_NUM = 8
PATTERN_PAD = 2


def pattern(dtype, device):
    """PATTERN_DSO8 as a [8, 2] tensor, uploaded once per type and device
    (a host-to-device copy cannot run inside a captured program); callers
    only read it."""
    key = (dtype, str(device))
    offs = _PATTERN.get(key)
    if offs is None:
        offs = torch.as_tensor(PATTERN_DSO8, dtype=dtype, device=device)
        _PATTERN[key] = offs
    return offs


_PATTERN = {}


def _reflect101_pad(img, ph, pw):
    return F.pad(img[None, None], (pw, pw, ph, ph), mode="reflect")[0, 0]


def sep_filter2d(img, kx, ky):
    """Separable 2-D correlation with 1-D kernels kx (along x) and ky (along
    y), reflect-101 borders. img [H, W]."""
    kx = [float(k) for k in kx]
    ky = [float(k) for k in ky]
    rx = (len(kx) - 1) // 2
    ry = (len(ky) - 1) // 2
    H, W = img.shape
    p = _reflect101_pad(img, ry, rx)
    row = sum(k * p[:, i:i + W] for i, k in enumerate(kx))
    return sum(k * row[i:i + H, :] for i, k in enumerate(ky))


def _binom_row(n):
    row = np.array([1.0])
    for _ in range(n):
        row = np.convolve(row, [1.0, 1.0])
    return row


def sobel_kernels(ksize: int):
    """OpenCV-compatible (unnormalized) Sobel derivative/smoothing kernels."""
    deriv = np.convolve([-1.0, 1.0], _binom_row(ksize - 2))
    smooth = _binom_row(ksize - 1)
    return deriv, smooth


def sobel(img, ksize: int = 3):
    """(gx, gy) with OpenCV Sobel semantics."""
    deriv, smooth = sobel_kernels(ksize)
    return sep_filter2d(img, deriv, smooth), sep_filter2d(img, smooth, deriv)


def pyramid_down(img):
    """DSO half-resolution downsampling: plain 2x2 box average."""
    H, W = img.shape
    return img[: H - H % 2, : W - W % 2].reshape(
        H // 2, 2, W // 2, 2).mean(dim=(1, 3))


def central_gradients(img):
    """DSO gradients 0.5*(I[x+1] - I[x-1]) with clamped borders."""
    right = torch.cat([img[:, 1:], img[:, -1:]], 1)
    left = torch.cat([img[:, :1], img[:, :-1]], 1)
    down = torch.cat([img[1:, :], img[-1:, :]], 0)
    up = torch.cat([img[:1, :], img[:-1, :]], 0)
    return 0.5 * (right - left), 0.5 * (down - up)


def build_pyramid(img, num_levels: int):
    """Per-level [H_l, W_l, 3] stacks [I, gx, gy] and squared-gradient maps
    (FrameHessian's dIp / absSquaredGrad pyramids)."""
    levels, abs_sq = [], []
    cur = img
    for lvl in range(num_levels):
        gx, gy = central_gradients(cur)
        levels.append(torch.stack([cur, gx, gy], -1))
        abs_sq.append(gx * gx + gy * gy)
        if lvl + 1 < num_levels:
            cur = pyramid_down(cur)
    return levels, abs_sq


def gradient_magnitude(gx, gy):
    return torch.sqrt(gx * gx + gy * gy)


def gaussian_kernel_1d(ksize: int, sigma: float = -1.0):
    """cv::getGaussianKernel semantics: sigma <= 0 derives it from ksize."""
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize) - (ksize - 1) * 0.5
    k = np.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def gaussian_blur(img, ksize: int = 3, sigma: float = -1.0):
    """Gaussian smoothing of event frames (cv::GaussianBlur)."""
    k = np.asarray(gaussian_kernel_1d(ksize, sigma), np.float32)
    return sep_filter2d(img, k, k)


def minmax_normalize(img, eps: float = 1e-12):
    """Min-max normalize to [0, 1]."""
    lo = torch.min(img)
    hi = torch.max(img)
    return (img - lo) / (hi - lo + eps)


def log_image(img, log_eps: float = 0.2):
    return torch.log(img + log_eps)


def _morph3(img, iters: int, reduce):
    H, W = img.shape
    for _ in range(iters):
        p = F.pad(img[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        img = reduce(torch.stack([p[dy:dy + H, dx:dx + W]
                                  for dy in range(3) for dx in range(3)]), 0)
    return img


def dilate3(img, iters: int = 1):
    """3x3 morphological dilation (edge-replicated borders)."""
    return _morph3(img, iters, torch.amax)


def erode3(img, iters: int = 1):
    """3x3 morphological erosion (edge-replicated borders)."""
    return _morph3(img, iters, torch.amin)


def split_image_in_patches(img, uv, patch_radius: int):
    """Per-point square patches around sub-pixel centers uv [N, 2]. Returns
    ([N, S, S] bilinear patches, [N] in-bounds mask), S = 2 r + 1."""
    d = torch.arange(-patch_radius, patch_radius + 1, dtype=img.dtype,
                     device=img.device)
    xs = uv[:, 0, None, None] + d[None, None, :]
    ys = uv[:, 1, None, None] + d[None, :, None]
    H, W = img.shape[:2]
    ok = (uv[:, 0] >= patch_radius) & (uv[:, 1] >= patch_radius) \
        & (uv[:, 0] <= W - 1 - patch_radius) \
        & (uv[:, 1] <= H - 1 - patch_radius)
    return bilinear(img, xs, ys), ok


def pyramid_patches(pyr_levels, uv, patch_radius: int):
    """Patches of the same points across a pyramid: level-l centers are
    uv / 2^l. Returns a list of ([N, S, S], [N]) per level."""
    return [split_image_in_patches(img, uv / (2.0 ** l), patch_radius)
            for l, img in enumerate(pyr_levels)]


def compute_bundle_patches(img, uv):
    """DSO 8-point residual-pattern samples per point. Returns ([N, 8]
    colors, [N] in-bounds mask)."""
    offs = pattern(img.dtype, img.device)
    H, W = img.shape[:2]
    ok = (uv[:, 0] >= PATTERN_PAD) & (uv[:, 1] >= PATTERN_PAD) \
        & (uv[:, 0] <= W - 1 - PATTERN_PAD) \
        & (uv[:, 1] <= H - 1 - PATTERN_PAD)
    return bilinear(img, uv[:, 0:1] + offs[None, :, 0],
                    uv[:, 1:2] + offs[None, :, 1]), ok
