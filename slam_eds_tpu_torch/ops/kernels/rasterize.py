"""Bilinear event rasterization (scatter-add of weighted events).

Port of the Pallas TPU kernel ``slam_eds_tpu/ops/pallas/raster.py``
(``rasterize_bilinear``): the CUDA kernel ``csrc/rasterize.cu`` (hand-written
for ``sm_90a``, one thread per event, deterministic 64-bit fixed-point
atomics — see the header of the .cu file) plus
``rasterize_bilinear_reference``, the plain torch four-tap ``index_add_``.

``rasterize_bilinear`` dispatches on the tensors' device: a CPU tensor takes
the plain version, a CUDA tensor launches the kernel (a build or launch
failure raises — there is no fallback). ``rasterize_bilinear.launches``
counts kernel launches.

Semantics of both versions: for each event with finite (x, y), the four
bilinear taps of ``values[e]`` are added to the frame where they fall inside
[0, W) x [0, H); other taps, and events with a non-finite coordinate, are
dropped.
"""
from __future__ import annotations

import ctypes

import torch

from .build import build_library

_LIB = None


def rasterize_bilinear_reference(xs, ys, values, height: int, width: int):
    """Plain torch version: xs, ys, values [E] float32 -> [H, W] float32."""
    finite = torch.isfinite(xs) & torch.isfinite(ys)
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    fx = xs - x0
    fy = ys - y0
    out = torch.zeros(height * width, dtype=values.dtype, device=values.device)
    for dx, dy, w in ((0, 0, (1 - fx) * (1 - fy)), (0, 1, (1 - fx) * fy),
                      (1, 0, fx * (1 - fy)), (1, 1, fx * fy)):
        xi = x0 + dx
        yi = y0 + dy
        ok = finite & (xi >= 0) & (xi < width) & (yi >= 0) & (yi < height)
        zero = torch.zeros_like(xi)
        flat = (torch.where(ok, yi, zero).long() * width
                + torch.where(ok, xi, zero).long())
        out.index_add_(0, flat, torch.where(ok, w * values,
                                            torch.zeros_like(values)))
    return out.reshape(height, width)


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record."""
    global _LIB
    if _LIB is None:
        built = build_library("rasterize", ["rasterize.cu"])
        fn = built.lib.rasterize_launch
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        err = built.lib.rasterize_error_string
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _LIB = built
    return _LIB


def rasterize_bilinear_cuda(xs, ys, values, height: int, width: int):
    """Launch the CUDA kernel; every check raises on what it does not take.

    The frame is exact up to a quantization of each tap at 2^-32 and the
    final float rounding, and bitwise deterministic, while
    E * max|values| < 2^30 (the int64 fixed-point accumulator's range)."""
    if not (xs.is_cuda and ys.is_cuda and values.is_cuda):
        raise ValueError("rasterize_bilinear_cuda needs CUDA tensors")
    if not (xs.device == ys.device == values.device):
        raise ValueError(f"device mismatch: {xs.device}, {ys.device}, "
                         f"{values.device}")
    if not (xs.dtype == ys.dtype == values.dtype == torch.float32):
        raise TypeError(f"float32 required, got {xs.dtype}, {ys.dtype}, "
                        f"{values.dtype}")
    if xs.dim() != 1 or xs.shape != ys.shape or xs.shape != values.shape:
        raise ValueError(f"xs, ys, values must be [E] of one length; got "
                         f"{tuple(xs.shape)}, {tuple(ys.shape)}, "
                         f"{tuple(values.shape)}")
    if not (xs.is_contiguous() and ys.is_contiguous()
            and values.is_contiguous()):
        raise ValueError("xs, ys and values must be contiguous")
    if height <= 0 or width <= 0:
        raise ValueError(f"bad frame size {height}x{width}")
    lib = load().lib
    acc = torch.empty(height * width, dtype=torch.int64, device=xs.device)
    out = torch.empty((height, width), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        rc = lib.rasterize_launch(xs.data_ptr(), ys.data_ptr(),
                                  values.data_ptr(), xs.numel(), height, width,
                                  acc.data_ptr(), out.data_ptr(), stream)
    if rc != 0:
        msg = lib.rasterize_error_string(rc).decode()
        raise RuntimeError(f"rasterize kernel launch failed: {msg}")
    rasterize_bilinear.launches += 1
    return out


def rasterize_bilinear(xs, ys, values, height: int, width: int):
    """Device dispatch: CPU tensors -> ``rasterize_bilinear_reference``;
    CUDA tensors -> the kernel (raises on failure)."""
    if xs.device.type == "cpu":
        return rasterize_bilinear_reference(xs, ys, values, height, width)
    if xs.device.type == "cuda":
        return rasterize_bilinear_cuda(xs, ys, values, height, width)
    raise ValueError(f"rasterize_bilinear: unsupported device {xs.device}")


rasterize_bilinear.launches = 0
