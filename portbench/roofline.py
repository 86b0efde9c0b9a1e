"""Frozen roofline counts of the program's hand-written kernels on the path,
with the card's published peaks.

Each launch's least time is the larger of its bytes over the HBM rate and
its float32 operations over the float32 peak; a kernel's share of its
roofline over a traced stretch is the sum of its recorded launches' least
times over the sum of their device times. Bytes count each input byte read
once and each output byte written once, from the shapes the path hands the
kernel; operations are counted from the kernels' arithmetic per element.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet (dense rates, 700 W): HBM3 bytes/s and float32
# operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
PEAK_POWER_W = 700.0

# float32 operations per tap / per event: the sampler's bilinear weights,
# value and two gradients (39); the raster's fractions, four weights and
# their fixed-point quantizations (22)
SAMPLER_OPS_PER_TAP = 39
RASTER_OPS_PER_EVENT = 22

# the sampler reads each tap's (u, v) and writes its value, two gradients
# (float32) and in-image flag (one byte); the raster reads each event's
# (x, y, value) and writes the float32 frame
SAMPLER_TAP_IN_BYTES = 8
SAMPLER_TAP_OUT_BYTES = 13
RASTER_EVENT_BYTES = 12
TEXEL_BYTES = 4


def bound_s(nbytes: float, ops: float) -> float:
    """A launch's least time in seconds: the larger of its two bounds."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def sampler_launch(taps: int, texels: float):
    """(bytes, operations) of one pattern-sampler launch over ``taps``
    taps that read ``texels`` distinct in-image texels of the planes."""
    nbytes = (taps * (SAMPLER_TAP_IN_BYTES + SAMPLER_TAP_OUT_BYTES)
              + texels * TEXEL_BYTES)
    return nbytes, taps * SAMPLER_OPS_PER_TAP


def raster_launch(events: int, height: int, width: int):
    """(bytes, operations) of one raster launch of ``events`` event lanes
    into an [height, width] float32 frame."""
    return (events * RASTER_EVENT_BYTES + height * width * 4,
            events * RASTER_OPS_PER_EVENT)


# the sampler's 4x4 neighbourhood without its corners, (dy, dx)
SAMPLER_OFFSETS = ((-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1), (0, 2),
                   (1, -1), (1, 0), (1, 1), (1, 2), (2, 0), (2, 1))


def sampler_texels(u, v, height: int, width: int) -> int:
    """Distinct in-image (frame, y, x) texels that the taps (u, v) [P, F, K]
    (frame f's taps in column f) read, each tap's neighbourhood clamped as
    the sampler clamps its coordinates."""
    F = u.shape[1]
    uc = torch.clamp(torch.nan_to_num(u, nan=-8.0), -8.0, width + 8.0)
    vc = torch.clamp(torch.nan_to_num(v, nan=-8.0), -8.0, height + 8.0)
    x0 = torch.floor(uc).long()
    y0 = torch.floor(vc).long()
    f = torch.arange(F, device=u.device)[None, :, None].expand_as(x0)
    ys = torch.stack([y0 + dy for dy, _ in SAMPLER_OFFSETS], -1).reshape(-1)
    xs = torch.stack([x0 + dx for _, dx in SAMPLER_OFFSETS], -1).reshape(-1)
    fs = f[..., None].expand(*f.shape, len(SAMPLER_OFFSETS)).reshape(-1)
    inb = (xs >= 0) & (xs < width) & (ys >= 0) & (ys < height)
    flat = (fs * height + ys) * width + xs
    return int(torch.unique(flat[inb]).numel())


def share(bounds_s, times_s):
    """Share (%) of the roofline over launches: their least times over
    their device times; None without a recorded launch."""
    total = sum(times_s)
    if not times_s or total <= 0:
        return None
    return 100.0 * sum(bounds_s) / total
