"""The frozen roofline counts on small shapes, against counts by hand."""
import itertools

import pytest
import torch

from portbench import roofline as rf


def test_peaks_are_the_published_sxm_rates():
    assert rf.HBM_BYTES_PER_S == 3.35e12
    assert rf.F32_OPS_PER_S == 67e12
    assert rf.PEAK_POWER_W == 700.0


def test_sampler_launch_counts():
    # 2 points x 3 frames x 8 pattern taps, 100 distinct texels
    taps = 2 * 3 * 8
    nbytes, ops = rf.sampler_launch(taps, 100)
    assert nbytes == taps * (8 + 13) + 100 * 4
    assert ops == taps * 39


def test_raster_launch_counts():
    nbytes, ops = rf.raster_launch(1000, 4, 5)
    assert nbytes == 1000 * 12 + 4 * 5 * 4
    assert ops == 1000 * 22


def test_bound_takes_the_larger():
    assert rf.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert rf.bound_s(0, 67e12) == pytest.approx(1.0)
    assert rf.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def _texels_by_hand(u, v, H, W):
    seen = set()
    P, F, K = u.shape
    for p, f, k in itertools.product(range(P), range(F), range(K)):
        x0 = int(torch.floor(torch.clamp(u[p, f, k], -8.0, W + 8.0)))
        y0 = int(torch.floor(torch.clamp(v[p, f, k], -8.0, H + 8.0)))
        for dy, dx in rf.SAMPLER_OFFSETS:
            y, x = y0 + dy, x0 + dx
            if 0 <= x < W and 0 <= y < H:
                seen.add((f, y, x))
    return len(seen)


def test_sampler_texels_on_small_taps():
    g = torch.Generator().manual_seed(3)
    H, W = 9, 11
    u = torch.rand((3, 2, 4), generator=g) * (W + 6) - 3
    v = torch.rand((3, 2, 4), generator=g) * (H + 6) - 3
    u[0, 0, 0] = float("nan")
    assert rf.sampler_texels(u, v, H, W) == _texels_by_hand(
        torch.nan_to_num(u, nan=-8.0), v, H, W)


def test_share():
    assert rf.share([1.0, 1.0], [4.0, 4.0]) == pytest.approx(25.0)
    assert rf.share([], []) is None
