"""The benchmark's frozen traffic generator: a synthetic textured scene seen
by a moving pinhole camera, its frames and the contrast-threshold events
between them, with ground-truth poses.

A copy, kept with the benchmark so that the yardstick cannot move, of the
synthetic sequence the program ships (its render, ``events_between``,
``pack_events``, the SE(3) exponential and the bilinear lookup). It imports
nothing of the program. Frames are rendered in torch on the given device;
events are counted in numpy from the rendered log intensities, as the
program's sequence counts them. ``tests/test_portbench_generator.py`` holds
it to the program's sequence on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_EPS = 1e-8
TEX_SIZE = 512


class Packet(NamedTuple):
    """A fixed-capacity event packet: float32 arrays [capacity], the first
    ``n_valid`` live, the rest zeros (the program's ``EventPacket``)."""
    xs: np.ndarray
    ys: np.ndarray
    ts: np.ndarray
    polarity: np.ndarray
    n_valid: int


class Camera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


def pack_events(xs, ys, ts, pol, capacity: int) -> Packet:
    """Pad with zeros or truncate to a fixed-capacity packet."""
    n = min(len(xs), capacity)
    out = []
    for a in (xs, ys, ts, pol):
        buf = np.zeros(capacity, np.float32)
        buf[:n] = a[:n]
        out.append(buf)
    return Packet(*out, n_valid=n)


def _hat(w):
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1),
                        torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def se3_exp(tau):
    """Tangent [..., 6] = [upsilon, omega] -> (R [..., 3, 3], t [..., 3]),
    Rodrigues with Taylor guards (Sophus conventions)."""
    v, w = tau[..., :3], tau[..., 3:6]
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta
                                                  + _EPS * _EPS))
    W = _hat(w)
    WW = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    R = eye + A[..., None, None] * W + B[..., None, None] * WW
    J = eye + B[..., None, None] * W + C[..., None, None] * WW
    return R, (J @ v[..., None])[..., 0]


def bilinear(img, x, y):
    """Bilinear lookup of img [H, W] at (x=col, y=row): floor weights, each
    tap clamped to the image on its own, coordinates cleaned to [-4, n+4],
    NaN where a coordinate is not finite."""
    H, W = img.shape
    xc = torch.clamp(torch.nan_to_num(x, nan=-4.0), -4.0, W + 4.0)
    yc = torch.clamp(torch.nan_to_num(y, nan=-4.0), -4.0, H + 4.0)
    x0 = torch.floor(xc)
    y0 = torch.floor(yc)
    dx = xc - x0
    dy = yc - y0
    ix0 = x0.long()
    iy0 = y0.long()
    ix = (torch.clamp(ix0, 0, W - 1), torch.clamp(ix0 + 1, 0, W - 1))
    iy = (torch.clamp(iy0, 0, H - 1), torch.clamp(iy0 + 1, 0, H - 1))
    row0 = img[iy[0], ix[0]] * (1.0 - dx) + img[iy[0], ix[1]] * dx
    row1 = img[iy[1], ix[0]] * (1.0 - dx) + img[iy[1], ix[1]] * dx
    val = row0 * (1.0 - dy) + row1 * dy
    bad = ~(torch.isfinite(x) & torch.isfinite(y))
    return torch.where(bad, torch.full_like(val, float("nan")), val)


class Sequence:
    """One synthetic sequence: ``num_frames`` frames at times in [0, 1]
    along a smooth 6-DoF trajectory of amplitude ``motion_scale``, the
    texture and trajectory drawn from ``seed``."""

    def __init__(self, cam: Camera, num_frames: int, events_per_packet: int,
                 seed: int, contrast_threshold: float = 0.08,
                 micro_steps: int = 4, motion_scale: float = 1.0,
                 device="cuda"):
        self.cam = cam
        self.num_frames = num_frames
        self.capacity = events_per_packet
        self.ct = contrast_threshold
        self.micro_steps = micro_steps
        self.device = torch.device(device)
        rng = np.random.default_rng(seed)
        ys, xs = np.mgrid[0:TEX_SIZE, 0:TEX_SIZE]
        tex = (np.sin(xs * 0.11) * np.cos(ys * 0.13)
               + 0.7 * np.sin(xs * 0.031 + ys * 0.047)
               + 0.5 * np.cos(xs * 0.23) * np.sin(ys * 0.19)
               + 0.15 * rng.standard_normal((TEX_SIZE, TEX_SIZE)))
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 220.0 + 20.0
        # one wrapped row and column, so modulo coordinates interpolate
        # across the seam
        self.tex = torch.as_tensor(np.pad(tex, ((0, 1), (0, 1)), mode="wrap"),
                                   dtype=torch.float32, device=self.device)
        t = np.linspace(0, 1, num_frames)
        amp = motion_scale * np.array([0.25, 0.18, 0.12, 0.05, 0.06, 0.08])
        phase = rng.uniform(0, 2 * np.pi, 6)
        freq = rng.uniform(0.8, 1.6, 6)
        self.taus = np.stack([
            amp[i] * np.sin(2 * np.pi * freq[i] * t + phase[i])
            - amp[i] * np.sin(phase[i]) for i in range(6)],
            axis=-1).astype(np.float32)
        self.times = t.astype(np.float32)

    def pose(self, k: int):
        """Ground-truth worldToCam pose of frame k as (R, t)."""
        return se3_exp(torch.as_tensor(self.taus[k], device=self.device))

    def _render(self, tau):
        cam = self.cam
        R, t = se3_exp(tau)
        # camToWorld
        Rt = R.T
        tc = -(Rt @ t)
        H, W = cam.height, cam.width
        dev = self.device
        ys, xs = torch.meshgrid(
            torch.arange(H, dtype=torch.float32, device=dev),
            torch.arange(W, dtype=torch.float32, device=dev), indexing="ij")
        p = torch.stack([(xs.reshape(-1) - cam.cx) / cam.fx,
                         (ys.reshape(-1) - cam.cy) / cam.fy,
                         torch.ones(H * W, device=dev)], -1)
        dirs = p @ Rt.T
        lam = (2.0 - tc[2]) / dirs[:, 2]
        for _ in range(6):
            Xw = tc[None, :] + dirs * lam[:, None]
            lam = (self._surface_z(Xw[:, 0], Xw[:, 1]) - tc[2]) / dirs[:, 2]
        Xw = tc[None, :] + dirs * lam[:, None]
        u = torch.remainder(Xw[:, 0] * 110.0 + 256.0, float(TEX_SIZE))
        v = torch.remainder(Xw[:, 1] * 110.0 + 256.0, float(TEX_SIZE))
        return bilinear(self.tex, u, v).reshape(H, W)

    @staticmethod
    def _surface_z(X, Y):
        return 2.0 + 0.3 * torch.sin(1.1 * X) * torch.cos(0.9 * Y) + 0.15 * X

    def frame(self, k: int):
        """(time, image [H, W] float32 0..255 on the device)."""
        tau = torch.as_tensor(self.taus[k], device=self.device)
        return float(self.times[k]), self._render(tau)

    def events_between(self, k0: int, k1: int) -> Packet:
        """Contrast-threshold events between frames k0 -> k1: log-intensity
        crossings between micro-stepped renders, time-stamped at the
        micro-step midpoints, time-ordered and uniformly subsampled to the
        packet capacity."""
        t0, t1 = self.times[k0], self.times[k1]
        n_steps = self.micro_steps
        xs_all, ys_all, ts_all, ps_all = [], [], [], []
        prev_log = None
        for s in range(n_steps + 1):
            tau = ((1 - s / n_steps) * self.taus[k0]
                   + (s / n_steps) * self.taus[k1])
            img = self._render(torch.as_tensor(tau.astype(np.float32),
                                               device=self.device))
            log_img = np.log(img.cpu().numpy() + 20.0)
            if prev_log is not None:
                d = log_img - prev_log
                n_events = np.floor(np.abs(d) / self.ct).astype(np.int32)
                ys_i, xs_i = np.nonzero(n_events)
                reps = n_events[ys_i, xs_i]
                xs_all.append(np.repeat(xs_i, reps).astype(np.float32))
                ys_all.append(np.repeat(ys_i, reps).astype(np.float32))
                ps_all.append(np.repeat(np.sign(d[ys_i, xs_i]),
                                        reps).astype(np.float32))
                ts_all.append(np.full(
                    xs_all[-1].shape,
                    t0 + (t1 - t0) * (s - 0.5) / n_steps, np.float32))
            prev_log = log_img
        xs_c, ys_c, ts_c, ps_c = (np.concatenate(a) for a in
                                  (xs_all, ys_all, ts_all, ps_all))
        order = np.argsort(ts_c, kind="stable")
        if len(order) > self.capacity:
            sel = np.linspace(0, len(order) - 1, self.capacity).astype(int)
            order = order[sel]
        return pack_events(xs_c[order], ys_c[order], ts_c[order],
                           ps_c[order], self.capacity)

    def gt_positions(self) -> np.ndarray:
        """[N, 3] ground-truth camera positions (camToWorld translations)."""
        R, t = se3_exp(torch.as_tensor(self.taus, dtype=torch.float64))
        return (-(R.transpose(-1, -2) @ t[..., None])[..., 0]).numpy()
