"""Mask-aware robust statistics — port of ``slam_eds_tpu.utils.stats``.

Invalid lanes are excluded exactly: medians/quantiles sort invalid lanes to
the float maximum and index by the valid count (median index ``n // 2``,
the reference's nth_element convention, also on even counts).
"""
from __future__ import annotations

import torch

MAD_SCALE = 1.4826
HUBER_K = 1.345


def masked_mean(x, mask):
    m = mask.to(x.dtype)
    return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)


def masked_mean_std(x, mask):
    m = mask.to(x.dtype)
    n = torch.clamp(torch.sum(m), min=1.0)
    mu = torch.sum(x * m) / n
    var = torch.sum(m * (x - mu) ** 2) / n
    return mu, torch.sqrt(var)


def masked_quantile_index(x, mask, k):
    """Value at sorted index k among the valid lanes (0 for an empty mask)."""
    big = torch.finfo(x.dtype).max
    xs = torch.sort(torch.where(mask, x, torch.full_like(x, big))).values
    n = torch.sum(mask.to(torch.int64))
    if not torch.is_tensor(k):
        # a fill, not a host-to-device copy (none may run in a captured step)
        k = torch.full((), int(k), dtype=torch.int64, device=x.device)
    k = torch.minimum(torch.clamp(k, min=0), torch.clamp(n - 1, min=0))
    # gather with the device index: no host read of k
    return torch.where(n > 0, xs.gather(0, k.reshape(1))[0],
                       torch.zeros((), dtype=x.dtype, device=x.device))


def masked_median(x, mask):
    n = torch.sum(mask.to(torch.int64))
    return masked_quantile_index(x, mask, n // 2)


def masked_mad(x, mask):
    """1.4826 * median(|x - median(x)|) over valid lanes."""
    med = masked_median(x, mask)
    return MAD_SCALE * masked_median(torch.abs(x - med), mask), med


def huber_scale_mad(residuals, mask):
    mad, _ = masked_mad(residuals, mask)
    return HUBER_K * mad


def huber_scale_std(residuals, mask):
    _, std = masked_mean_std(residuals, mask)
    return HUBER_K * std


def huber_weight(r, k):
    """Huber IRLS weight: 1 if |r| < k else k / |r|."""
    a = torch.abs(r)
    kk = (k.to(a.dtype) if torch.is_tensor(k)
          else torch.full((), k, dtype=a.dtype, device=a.device))
    return torch.where(a < k, torch.ones_like(a),
                       kk / torch.clamp(a, min=1e-12))


def huber_energy(r, k):
    hw = huber_weight(r, k)
    return hw * r * r * (2.0 - hw)


def cauchy_weight(r, k):
    return 1.0 / (1.0 + (r / torch.clamp(torch.as_tensor(k), min=1e-12)) ** 2)
