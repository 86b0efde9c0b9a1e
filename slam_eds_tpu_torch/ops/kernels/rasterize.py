"""Bilinear event rasterization (scatter-add of weighted events).

Port of the Pallas TPU kernel ``slam_eds_tpu/ops/pallas/raster.py``
(``rasterize_bilinear``): the CUDA kernel ``csrc/rasterize.cu`` (hand-written
for ``sm_90a``: one launch, the frame held as 64-bit fixed-point integers in
a thread-block cluster's distributed shared memory, deterministic integer
atomics — see the header of the .cu file) plus
``rasterize_bilinear_reference``, the plain torch four-tap ``index_add_``.
``launch_geometry`` is the kernel's launch geometry in plain Python.

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
from typing import NamedTuple

import torch

from .build import counted, load_library

_GEOMETRY = {}             # (H, W) -> RasterGeometry, chosen at first use

# the most dynamic shared memory a block may use on the card (sm_90)
MAX_SMEM_PER_BLOCK = 232448
# a cluster of 16 needs the non-portable cluster size; 8 is portable
CLUSTER_SIZES = (16, 8)
# threads per block: of 256, 512 and 1024 at 640x480, 512 was fastest on
# an H100 (PERF.md)
THREADS = 512


class RasterGeometry(NamedTuple):
    cluster: int            # blocks per cluster, one cluster per band
    bands: int              # row bands of the frame
    rows_per_band: int      # the last band may hold fewer rows
    slice_px: int           # frame pixels per block (a multiple of 4)
    bytes_per_block: int    # dynamic shared memory: slice_px int64 sums
    threads: int            # threads per block


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def launch_geometry(height: int, width: int, cluster: int = 16,
                    clusters: int = 1, threads: int = THREADS):
    """Launch geometry of the raster kernel: the frame's rows cut into
    ``clusters`` bands (the clusters the card holds at once), or into more
    where a band's int64 sums would not fit a cluster's shared memory,
    balanced; each band's pixels cut into ``cluster`` slices of a multiple of
    4 pixels (block r owns band pixels [r * slice_px, (r + 1) * slice_px)).
    640x480 with one cluster of 16: 19,200 pixels and 153,600 B per block;
    with the 7 clusters of 16 an H100 holds at once, 69 rows per band and
    22,080 B per block."""
    max_slice = MAX_SMEM_PER_BLOCK // 8 // 4 * 4
    max_rows = cluster * max_slice // width
    if height <= 0 or width <= 0 or max_rows < 1 or clusters < 1:
        raise ValueError(f"no raster geometry for {height}x{width} with "
                         f"{clusters} clusters of {cluster}")
    rows = _ceil_div(height, max(_ceil_div(height, max_rows),
                                 min(clusters, height)))
    bands = _ceil_div(height, rows)
    slice_px = 4 * _ceil_div(_ceil_div(rows * width, cluster), 4)
    return RasterGeometry(cluster, bands, rows, slice_px, slice_px * 8,
                          threads)


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


_FUNCTIONS = {
    "rasterize_launch": ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 5
                         + [ctypes.c_longlong, ctypes.c_int]
                         + [ctypes.c_void_p] * 2),
    "rasterize_max_active_clusters": [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_longlong,
                                      ctypes.POINTER(ctypes.c_int)]}


def load():
    """Build (at first use) and load the kernel library; returns the
    BuiltLibrary record."""
    return load_library("rasterize", ["rasterize.cu"], _FUNCTIONS)


def _check(lib, rc, what):
    if rc != 0:
        msg = lib.rasterize_error_string(rc).decode()
        raise RuntimeError(f"rasterize kernel {what} failed: {msg}")


def card_geometry(height: int, width: int):
    """The geometry the card runs for an [H, W] frame, chosen at first use
    from ``cudaOccupancyMaxActiveClusters``: clusters of 16 where the card
    holds one, else the portable 8 (raises if it holds neither), and as many
    bands as it holds such clusters at once, so that the bands spread over
    the card's SMs. Call with the frame's device current."""
    geo = _GEOMETRY.get((height, width))
    if geo is None:
        lib = load().lib
        for cluster in CLUSTER_SIZES:
            geo = launch_geometry(height, width, cluster)
            n = ctypes.c_int(0)
            _check(lib, lib.rasterize_max_active_clusters(
                geo.cluster, geo.bands, geo.threads, geo.bytes_per_block,
                ctypes.byref(n)), "occupancy query")
            if n.value >= 1:
                geo = launch_geometry(height, width, cluster, n.value)
                break
        else:
            raise RuntimeError(
                f"the card holds no raster cluster of {geo.cluster} blocks "
                f"with {geo.bytes_per_block} B of shared memory each")
        _GEOMETRY[(height, width)] = geo
    return geo


def rasterize_bilinear_cuda(xs, ys, values, height: int, width: int):
    """Launch the CUDA kernel; every check raises on what it does not take.

    The frame is exact up to a quantization of each tap at 2^-32 and the
    final float rounding, and bitwise deterministic, while
    E * max|values| < 2^30 (the int64 fixed-point accumulator's range): for
    a packet of 65,536 events |v| < 16,384 (the values are +-1 time
    weights), for the track refinement's splats of 2,048 points
    |v| < 524,288 (keyframe gradients stay below about 1e3, the normalized
    model below 1). A non-finite value is not checked for: callers zero
    masked lanes ahead of the launch (``utils.events.scatter_accumulate``);
    a non-finite coordinate drops its event."""
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
    out = torch.empty((height, width), dtype=torch.float32, device=xs.device)
    with torch.cuda.device(xs.device):
        geo = card_geometry(height, width)
        stream = torch.cuda.current_stream(xs.device).cuda_stream
        _check(lib, lib.rasterize_launch(
            xs.data_ptr(), ys.data_ptr(), values.data_ptr(), xs.numel(),
            height, width, geo.cluster, geo.bands, geo.rows_per_band,
            geo.slice_px, geo.threads, out.data_ptr(), stream), "launch")
    rasterize_bilinear.launches += 1
    return out


@counted
def rasterize_bilinear(xs, ys, values, height: int, width: int):
    """Device dispatch: CPU tensors -> ``rasterize_bilinear_reference``;
    CUDA tensors -> the kernel (raises on failure)."""
    if xs.device.type == "cpu":
        return rasterize_bilinear_reference(xs, ys, values, height, width)
    if xs.device.type == "cuda":
        return rasterize_bilinear_cuda(xs, ys, values, height, width)
    raise ValueError(f"rasterize_bilinear: unsupported device {xs.device}")

