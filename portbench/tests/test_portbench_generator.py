"""The benchmark's frozen generator against the program's synthetic
sequence, at 128x96 on the CPU on two seeds: ground-truth poses, frames,
and event packets.

Tolerances: the two compute the same float32 arithmetic in a different
order of a few products (the camera-to-world inverse, the pose exponential
is shared), so
* ground-truth rotations and translations within 1e-6,
* frames within 1e-3 of 255 (a texel lookup at a coordinate 1e-6 apart),
* packets: the same live count within 0.5% and, over the events both
  packets hold, positions and polarities equal at 99.5% or more (a pixel
  whose log change sits at a contrast threshold may give one event more
  or fewer, which shifts the rest of that packet's order).
"""
import numpy as np
import pytest
import torch

from portbench import generator as gen
from slam_eds_tpu_torch.io.dataset import SyntheticSequence
from slam_eds_tpu_torch.utils.cameras import Pinhole

W, H = 128, 96
CAM = gen.Camera(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
FRAMES = 6


@pytest.fixture(scope="module", params=[7, 2 ** 31 + 12345])
def pair(request):
    kw = dict(num_frames=FRAMES, events_per_packet=8192, seed=request.param,
              micro_steps=2, motion_scale=0.22, device="cpu")
    return (gen.Sequence(CAM, **kw),
            SyntheticSequence(Pinhole(*CAM), **kw))


def test_ground_truth(pair):
    mine, port = pair
    for k in range(FRAMES):
        R, t = mine.pose(k)
        P = port.pose(k)
        assert torch.allclose(R, P.R, atol=1e-6)
        assert torch.allclose(t, P.t, atol=1e-6)
    assert np.allclose(mine.gt_positions(), port.gt_positions(), atol=1e-6)


def test_frames(pair):
    mine, port = pair
    for k in range(FRAMES):
        t0, a = mine.frame(k)
        t1, b, _ = port.frame(k)
        assert t0 == t1
        assert float((a - b).abs().max()) <= 1e-3


def test_packets(pair):
    mine, port = pair
    for k in range(FRAMES - 1):
        a, b = mine.events_between(k, k + 1), port.events_between(k, k + 1)
        assert abs(a.n_valid - b.n_valid) <= 0.005 * max(b.n_valid, 1)
        n = min(a.n_valid, b.n_valid)
        same = ((a.xs[:n] == b.xs[:n]) & (a.ys[:n] == b.ys[:n])
                & (a.polarity[:n] == b.polarity[:n]) & (a.ts[:n] == b.ts[:n]))
        assert same.mean() >= 0.995
        assert not a.xs[a.n_valid:].any()
