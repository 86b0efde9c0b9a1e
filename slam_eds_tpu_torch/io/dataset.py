"""Synthetic event + frame sequence with ground truth — port of
``SyntheticSequence``, ``EventPacket`` and ``pack_events`` from
``slam_eds_tpu.io.dataset``.

The texture and trajectory come from the same numpy seed as the JAX class,
so the same arguments give the same scene and poses; frames are rendered in
torch on ``device`` (they agree with the JAX renders to float rounding).
Events are the contrast-threshold crossings of the log intensity between
micro-stepped renders, counted in numpy with the JAX class's ordering and
uniform subsampling; since a render differs from JAX's by float rounding, a
pixel near a threshold may give one event more or fewer.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..utils.cameras import Pinhole
from ..utils.interp import bilinear
from ..utils.lie import SE3


class EventPacket(NamedTuple):
    xs: np.ndarray      # [cap] float32
    ys: np.ndarray
    ts: np.ndarray
    polarity: np.ndarray
    n_valid: int


def pack_events(xs, ys, ts, pol, capacity: int) -> EventPacket:
    """Pad (with zeros) or truncate to a fixed-capacity packet."""
    n = min(len(xs), capacity)
    out = []
    for a in (xs, ys, ts, pol):
        buf = np.zeros(capacity, np.float32)
        buf[:n] = a[:n]
        out.append(buf)
    return EventPacket(*out, n_valid=n)


class SyntheticSequence:
    def __init__(self, cam: Pinhole, num_frames: int = 30,
                 events_per_packet: int = 16384, seed: int = 7,
                 contrast_threshold: float = 0.08,
                 micro_steps: int = 4, motion_scale: float = 1.0,
                 device="cuda"):
        self.cam = cam
        self.num_frames = num_frames
        self.capacity = events_per_packet
        self.ct = contrast_threshold
        self.micro_steps = micro_steps
        self.device = resolve_device(device)
        rng = np.random.default_rng(seed)

        ys, xs = np.mgrid[0:512, 0:512]
        tex = (np.sin(xs * 0.11) * np.cos(ys * 0.13)
               + 0.7 * np.sin(xs * 0.031 + ys * 0.047)
               + 0.5 * np.cos(xs * 0.23) * np.sin(ys * 0.19)
               + 0.15 * rng.standard_normal((512, 512)))
        tex = (tex - tex.min()) / (tex.max() - tex.min()) * 220.0 + 20.0
        # wrap-pad one row/col so modulo coordinates interpolate across
        # the seam
        self.tex = torch.as_tensor(np.pad(tex, ((0, 1), (0, 1)), mode="wrap"),
                                   dtype=torch.float32, device=self.device)
        self._tex_size = 512.0

        t = np.linspace(0, 1, num_frames)
        amp = motion_scale * np.array([0.25, 0.18, 0.12, 0.05, 0.06, 0.08])
        phase = rng.uniform(0, 2 * np.pi, 6)
        freq = rng.uniform(0.8, 1.6, 6)
        self.taus = np.stack([
            amp[i] * np.sin(2 * np.pi * freq[i] * t + phase[i])
            - amp[i] * np.sin(phase[i])
            for i in range(6)], axis=-1).astype(np.float32)
        self.times = t.astype(np.float32)

    def _tau(self, k):
        return torch.as_tensor(self.taus[k], device=self.device)

    def pose(self, k: int) -> SE3:
        """Ground-truth worldToCam pose of frame k."""
        return SE3.exp(self._tau(k))

    def pose_at(self, alpha: float) -> SE3:
        """Interpolated pose at a fractional frame index."""
        k0 = int(np.clip(np.floor(alpha), 0, self.num_frames - 1))
        k1 = min(k0 + 1, self.num_frames - 1)
        w = alpha - k0
        tau = (1 - w) * self.taus[k0] + w * self.taus[k1]
        return SE3.exp(torch.as_tensor(tau.astype(np.float32),
                                       device=self.device))

    def _surface_z(self, X, Y):
        return 2.0 + 0.3 * torch.sin(1.1 * X) * torch.cos(0.9 * Y) + 0.15 * X

    def _render(self, tau):
        cam = self.cam
        T_cw = SE3.exp(tau).inverse()
        H, W = cam.height, cam.width
        dev = self.device
        ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32,
                                             device=dev),
                                torch.arange(W, dtype=torch.float32,
                                             device=dev), indexing="ij")
        p = torch.stack([(xs.reshape(-1) - cam.cx) / cam.fx,
                         (ys.reshape(-1) - cam.cy) / cam.fy,
                         torch.ones(H * W, device=dev)], -1)
        dirs = p @ T_cw.R.T
        lam = (2.0 - T_cw.t[2]) / dirs[:, 2]
        for _ in range(6):
            Xw = T_cw.t[None, :] + dirs * lam[:, None]
            lam = (self._surface_z(Xw[:, 0], Xw[:, 1]) - T_cw.t[2]) \
                / dirs[:, 2]
        Xw = T_cw.t[None, :] + dirs * lam[:, None]
        u = torch.remainder(Xw[:, 0] * 110.0 + 256.0, self._tex_size)
        v = torch.remainder(Xw[:, 1] * 110.0 + 256.0, self._tex_size)
        img = bilinear(self.tex, u, v).reshape(H, W)
        return img, (lam * dirs[:, 2]).reshape(H, W)

    def frame(self, k: int):
        """(time, image [H, W] float32 0..255 on the device, gt depth)."""
        img, depth = self._render(self._tau(k))
        return float(self.times[k]), img, depth

    def events_between(self, k0: int, k1: int) -> EventPacket:
        """Contrast-threshold events between frames k0 -> k1 (micro-stepped
        log-intensity crossings, timestamps at the micro-step midpoints),
        time-ordered and uniformly subsampled to the packet capacity."""
        t0, t1 = self.times[k0], self.times[k1]
        n_steps = self.micro_steps
        xs_all, ys_all, ts_all, ps_all = [], [], [], []
        prev_log = None
        for s in range(n_steps + 1):
            tau = ((1 - s / n_steps) * self.taus[k0]
                   + (s / n_steps) * self.taus[k1])
            img, _ = self._render(torch.as_tensor(tau.astype(np.float32),
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
        if not xs_all:
            empty = np.zeros(0, np.float32)
            return pack_events(empty, empty, empty, empty, self.capacity)
        xs_c, ys_c, ts_c, ps_c = (np.concatenate(a) for a in
                                  (xs_all, ys_all, ts_all, ps_all))
        order = np.argsort(ts_c, kind="stable")
        if len(order) > self.capacity:
            sel = np.linspace(0, len(order) - 1, self.capacity).astype(int)
            order = order[sel]
        return pack_events(xs_c[order], ys_c[order], ts_c[order],
                           ps_c[order], self.capacity)

    def write_dataset(self, out_dir: str, events: bool = True,
                      progress: bool = False) -> str:
        """Write this sequence as an on-disk dataset in the layout
        ``runner.run_sequence`` reads: images/*.png (8-bit gray), images.txt
        ("t name"), events.txt ("t x y p"), calib.yaml (kalibr-style cam0
        block) and groundtruth.txt (TUM "t x y z qx qy qz qw", camToWorld).
        The layout and text formats of the JAX package's ``write_dataset``.
        Returns out_dir."""
        from .image_rw import write_png
        from ..utils.lie import mat_to_quat
        os.makedirs(os.path.join(out_dir, "images"), exist_ok=True)
        lines = []
        for k in range(self.num_frames):
            t, img, _ = self.frame(k)
            name = f"images/frame_{k:06d}.png"
            u8 = np.clip(np.rint(img.cpu().numpy()), 0, 255).astype(np.uint8)
            write_png(os.path.join(out_dir, name), u8)
            lines.append(f"{t:.9f} {name}")
            if progress and k % 20 == 0:
                print(f"[write_dataset] frame {k}/{self.num_frames}",
                      flush=True)
        with open(os.path.join(out_dir, "images.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
        if events:
            with open(os.path.join(out_dir, "events.txt"), "w") as f:
                f.write("# t x y p\n")
                for k in range(self.num_frames - 1):
                    pk = self.events_between(k, k + 1)
                    n = int(pk.n_valid)
                    rows = np.column_stack([
                        np.asarray(pk.ts[:n], np.float64),
                        np.asarray(pk.xs[:n], np.float64),
                        np.asarray(pk.ys[:n], np.float64),
                        (np.asarray(pk.polarity[:n]) > 0).astype(np.float64)])
                    np.savetxt(f, rows, fmt="%.9f %.0f %.0f %.0f")
        cam = self.cam
        with open(os.path.join(out_dir, "calib.yaml"), "w") as f:
            f.write("cam0:\n"
                    f"  resolution: [{int(cam.width)}, {int(cam.height)}]\n"
                    f"  intrinsics: [{float(cam.fx)}, {float(cam.fy)}, "
                    f"{float(cam.cx)}, {float(cam.cy)}]\n"
                    "  distortion_model: none\n")
        T = SE3.exp(torch.as_tensor(self.taus)).inverse()     # camToWorld
        q = mat_to_quat(T.R).numpy()                          # [w, x, y, z]
        with open(os.path.join(out_dir, "groundtruth.txt"), "w") as f:
            f.write("# t x y z qx qy qz qw\n")
            for k in range(self.num_frames):
                x, y, z = (float(v) for v in T.t[k])
                qw, qx, qy, qz = (float(v) for v in q[k])
                f.write(f"{self.times[k]:.9f} {x:.9f} {y:.9f} {z:.9f} "
                        f"{qx:.9f} {qy:.9f} {qz:.9f} {qw:.9f}\n")
        return out_dir

    def gt_positions(self):
        """[N, 3] ground-truth camera positions (camToWorld translations)."""
        T = SE3.exp(torch.as_tensor(self.taus, device=self.device))
        return T.inverse().t.cpu().numpy()


class ArraySequence:
    """Preloaded arrays (times [N], images [N, H, W], optional event
    packets) in the sequence interface of ``SyntheticSequence``."""

    def __init__(self, times, images, packets: Optional[list] = None,
                 gt_positions=None):
        self.times = np.asarray(times)
        self.images = np.asarray(images)
        self.packets = packets
        self._gt = gt_positions
        self.num_frames = len(self.times)

    def frame(self, k: int):
        return float(self.times[k]), self.images[k], None

    def events_between(self, k0: int, k1: int):
        if self.packets is None:
            return None
        return self.packets[k0]

    def gt_positions(self):
        return self._gt
