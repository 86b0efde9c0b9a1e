"""Pinhole camera — port of the ``Pinhole`` part of
``slam_eds_tpu.utils.cameras`` (distortion models are not ported yet).

Intrinsics are plain Python floats: the pipeline reads them on the host and
every tensor op broadcasts them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Pinhole(NamedTuple):
    """Intrinsics K = [[fx,0,cx],[0,fy,cy],[0,0,1]] plus image size."""
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int

    def K(self, dtype=torch.float32, *, device):
        return torch.tensor([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                             [0.0, 0.0, 1.0]], dtype=dtype, device=device)

    def pyramid_level(self, lvl: int) -> "Pinhole":
        """DSO per-level intrinsics: fx*0.5^l, cx = (cx+0.5)/2^l - 0.5."""
        s = 0.5 ** lvl
        return Pinhole(self.fx * s, self.fy * s, (self.cx + 0.5) * s - 0.5,
                       (self.cy + 0.5) * s - 0.5, self.width >> lvl,
                       self.height >> lvl)

