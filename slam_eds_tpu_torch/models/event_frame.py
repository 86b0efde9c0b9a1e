"""EventFrame — an accumulated brightness-increment frame with its metadata;
port of ``slam_eds_tpu.models.event_frame`` (EventFrame::create: optional
per-event undistortion, time-weighted bilinear polarity scatter, Gaussian
blur, morphological levels, Frobenius normalization, median-event time)."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import events as ev
from ..utils.lie import SE3


class EventFrame(NamedTuple):
    frames: torch.Tensor      # [L, H, W] normalized event frames
    norms: torch.Tensor       # [L] Frobenius norms before normalization
    time: torch.Tensor        # median event timestamp
    first_time: torch.Tensor
    last_time: torch.Tensor
    delta_time: torch.Tensor
    n_events: torch.Tensor
    T_w_ef_R: torch.Tensor
    T_w_ef_t: torch.Tensor

    @property
    def pose(self) -> SE3:
        return SE3(self.T_w_ef_R, self.T_w_ef_t)


def create_event_frame(xs, ys, ts, polarities, n_valid, height: int,
                       width: int, num_levels: int = 1,
                       fwd_maps=None, use_time_weights: bool = True,
                       blur_sigma: float = 0.5, blur_ksize: int = 3,
                       interpolation: str = "bilinear",
                       T_w_ef: Optional[SE3] = None) -> EventFrame:
    """EventFrame from a fixed-capacity packet whose first ``n_valid``
    events are live (an int device scalar, or a Python int). fwd_maps:
    optional (fwd_x, fwd_y) undistortion tables."""
    n_valid = ev.live_count(n_valid, xs.device)
    if fwd_maps is not None:
        xs, ys = ev.undistort_events(xs, ys, fwd_maps[0], fwd_maps[1])
    frames, norms = ev.build_event_frame(
        xs, ys, polarities, n_valid, height, width, num_levels=num_levels,
        use_time_weights=use_time_weights, blur_sigma=blur_sigma,
        blur_ksize=blur_ksize, interpolation=interpolation)
    first = ts[0]
    last = ev.event_at(ts, n_valid - 1)
    if T_w_ef is None:
        T_w_ef = SE3.identity(frames.dtype, device=frames.device)
    return EventFrame(
        frames=frames, norms=norms,
        time=ev.median_event_time(ts, n_valid),
        first_time=first, last_time=last, delta_time=last - first,
        n_events=n_valid,
        T_w_ef_R=T_w_ef.R, T_w_ef_t=T_w_ef.t)
