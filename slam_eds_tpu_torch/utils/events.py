"""Event rasterization: packets of events -> brightness-increment frames —
port of ``slam_eds_tpu.utils.events``.

A packet is fixed-capacity (x, y, t, polarity) arrays with ``n_valid`` live
events at the front. The bilinear scatter goes through
``ops/kernels/rasterize.rasterize_bilinear`` (the CUDA kernel on the card,
its plain version on the CPU); the nearest-pixel scatter is an order-free
``index_add_`` (``utils.scatter``).
"""
from __future__ import annotations

import torch

from . import image as image_ops
from .scatter import order_free_index_add
from ..ops.kernels.rasterize import rasterize_bilinear


def live_count(n_valid, device):
    """The packet's live-event count as an int32 device scalar: a tensor is
    taken as it is (it is data, as in JAX, so a captured step serves every
    packet), a Python int is filled in on the device."""
    if torch.is_tensor(n_valid):
        return n_valid.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(n_valid), dtype=torch.int32, device=device)


def event_time_weights(n_valid, capacity: int, dtype=torch.float32, *,
                       device):
    """Gaussian time-ordering weights exp(-0.5 ((i/N - 1/2) / (1/6))^2), a
    bell centred mid-packet (``expWeight``), N = max(n_valid, 1). N is a
    device scalar, so the division is a true one (a host scalar divides by
    its reciprocal on the card)."""
    idx = torch.arange(capacity, dtype=dtype, device=device)
    n = torch.clamp(live_count(n_valid, device), min=1).to(dtype)
    z = (idx / n - 0.5) * 6.0
    return torch.exp(-0.5 * z * z)


def scatter_accumulate(xs, ys, values, height: int, width: int,
                       mask=None, method: str = "bilinear"):
    """Accumulate per-event ``values`` into an [H, W] image.

    bilinear: 4-tap scatter with out-of-image taps dropped (the kernel).
    nn: nearest pixel (round half to even) with clamping. Both drop events
    with a non-finite coordinate."""
    if mask is not None:
        values = torch.where(mask, values, torch.zeros_like(values))
    if method == "bilinear":
        return rasterize_bilinear(xs, ys, values, height, width)
    if method != "nn":
        raise ValueError(f"unknown interpolation {method!r}")
    finite = torch.isfinite(xs) & torch.isfinite(ys)
    values = torch.where(finite, values, torch.zeros_like(values))
    ix = torch.clamp(torch.round(torch.where(finite, xs, 0.0)), 0, width - 1)
    iy = torch.clamp(torch.round(torch.where(finite, ys, 0.0)), 0, height - 1)
    img = order_free_index_add(iy.long() * width + ix.long(), values,
                               height * width)
    return img.reshape(height, width)


def undistort_events(xs, ys, fwd_map_x, fwd_map_y):
    """Per-event undistortion by rounding the raw coordinate and reading the
    precomputed forward maps [H, W]."""
    H, W = fwd_map_x.shape
    ix = torch.clamp(torch.round(xs), 0, W - 1).long()
    iy = torch.clamp(torch.round(ys), 0, H - 1).long()
    return fwd_map_x[iy, ix], fwd_map_y[iy, ix]


def build_event_frame(xs, ys, polarities, n_valid, height: int, width: int,
                      num_levels: int = 1, use_time_weights: bool = True,
                      blur_sigma: float = 0.5, blur_ksize: int = 3,
                      norm_eps: float = 1e-12,
                      interpolation: str = "bilinear"):
    """EventFrame raster: time-weighted polarity scatter -> Gaussian blur ->
    morphological levels (level l >= 1 is dilate + erode of level 0 with a
    (2l+1) structuring size) -> per-level Frobenius normalization.

    Returns (frames [L, H, W], norms [L])."""
    capacity = xs.shape[0]
    n_valid = live_count(n_valid, xs.device)
    mask = torch.arange(capacity, device=xs.device) < n_valid
    values = polarities.to(torch.float32)
    if use_time_weights:
        values = values * event_time_weights(n_valid, capacity,
                                             device=xs.device)
    img = scatter_accumulate(xs, ys, values, height, width, mask=mask,
                             method=interpolation)
    if blur_sigma > 0 and blur_ksize > 0:
        img = image_ops.gaussian_blur(img, blur_ksize, blur_sigma)
    frames = [img] + [image_ops.dilate3(img, iters=lvl)
                      + image_ops.erode3(img, iters=lvl)
                      for lvl in range(1, num_levels)]
    stacked = torch.stack(frames)
    norms = torch.sqrt(torch.sum(stacked * stacked, dim=(1, 2))) + norm_eps
    return stacked / norms[:, None, None], norms


def event_at(ts, index):
    """ts[index] for an int device scalar ``index`` (clamped at 0): a gather,
    where indexing with a 0-d tensor would read it back to the host."""
    return ts.gather(0, torch.clamp(index, min=0).long().reshape(1))[0]


def median_event_time(ts, n_valid):
    """Packet timestamp = time of the middle event (events time-ordered)."""
    return event_at(ts, live_count(n_valid, ts.device) // 2)
