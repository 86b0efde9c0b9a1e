"""Coarse L1 distance map for spatially-distributed point activation —
port of ``slam_eds_tpu.ops.distance_map`` (DSO's CoarseDistanceMap BFS as
``max_dist`` rounds of a 4-neighbour min-plus dilation; the JAX
``fori_loop`` is a Python loop)."""
from __future__ import annotations

import torch


def coarse_distance_map(uv, mask, height: int, width: int,
                        max_dist: int = 40):
    """uv [N, 2] point pixels at this map's resolution, mask [N].
    Returns [height, width] float32 distances clamped to ``max_dist``."""
    dev = uv.device
    fill = float(max_dist)
    ix = torch.round(uv[:, 0]).to(torch.int64)
    iy = torch.round(uv[:, 1]).to(torch.int64)
    ok = mask & (ix >= 0) & (ix < width) & (iy >= 0) & (iy < height)
    flat = torch.where(ok, iy * width + ix,
                       torch.full_like(ix, height * width))
    seed = torch.full((height * width + 1,), fill, dtype=torch.float32,
                      device=dev)
    src = torch.where(ok, torch.zeros_like(uv[:, 0]),
                      torch.full_like(uv[:, 0], fill))
    seed = seed.scatter_reduce(0, flat, src, reduce="amin")
    d = seed[:height * width].reshape(height, width)

    big_row = torch.full((1, width), fill, device=dev)
    big_col = torch.full((height, 1), fill, device=dev)
    for _ in range(max_dist):
        up = torch.cat([d[1:], big_row], 0)
        dn = torch.cat([big_row, d[:-1]], 0)
        lf = torch.cat([d[:, 1:], big_col], 1)
        rt = torch.cat([big_col, d[:, :-1]], 1)
        n = torch.minimum(torch.minimum(up, dn), torch.minimum(lf, rt))
        d = torch.minimum(d, n + 1.0)
    return d


def sample_distance(dist_map, uv):
    """Nearest-pixel lookup of the distance map at (same-resolution) uv."""
    h, w = dist_map.shape
    ix = torch.clamp(torch.round(uv[:, 0]).long(), 0, w - 1)
    iy = torch.clamp(torch.round(uv[:, 1]).long(), 0, h - 1)
    return dist_map[iy, ix]
