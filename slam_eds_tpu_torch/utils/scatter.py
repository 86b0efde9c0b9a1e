"""Scatter-sums whose result does not depend on the order of the additions.

On a CUDA device ``index_add_`` of floats sums with atomics, so the order of
the additions into one bin, and with it the float rounding, varies from run
to run. The JAX package's segment sums are order-fixed. Here the finite
terms are quantized to 64-bit fixed point and summed with an integer
``index_add_`` (integer addition is associative), the technique of the event
raster kernel (``csrc/rasterize.cu``).
"""
from __future__ import annotations

import torch

FIXED_SCALE = 2.0 ** 32


def order_free_index_add(flat, x, size: int):
    """Sum float ``x`` [N] into ``size`` bins at indices ``flat`` [N].

    Finite terms are quantized to round(x * 2^32) and summed as int64: the
    bin's sum is exact up to that quantization, and rounded once to x's
    dtype, while its magnitude stays below 2^31. A bin that receives a
    non-finite term takes the float sum of its non-finite terms (NaN or
    +-inf, whatever the order), as a float sum would."""
    finite = torch.isfinite(x)
    zero = torch.zeros_like(x)
    q = torch.round(torch.where(finite, x, zero).double() * FIXED_SCALE)
    acc = torch.zeros(size, dtype=torch.int64, device=x.device)
    acc.index_add_(0, flat, q.long())
    bad = torch.zeros(size, dtype=x.dtype, device=x.device)
    bad.index_add_(0, flat, torch.where(finite, zero, x))
    total = (acc.double() / FIXED_SCALE).to(x.dtype)
    return torch.where(torch.isfinite(bad), total, bad)
