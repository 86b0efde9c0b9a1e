"""Output recording — port of ``slam_eds_tpu.io.recorder`` (the
``recorder::Config`` consumer): per-solve poses and 6-dof velocities
appended to TUM-format text files as they arrive (line-buffered, so a crash
loses at most the current line), and viz PNG dumps through ``image_rw``.

The recorder writes host values: a pose's R and t and a velocity may be
numpy arrays or tensors (a tensor is copied to the host). The event
pipeline hands it the arrays of its one host read per packet.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..config import RecorderConfig
from ..utils.lie import mat_to_quat
from .image_rw import write_png


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Recorder:
    def __init__(self, cfg: RecorderConfig):
        self.cfg = cfg
        os.makedirs(cfg.output_folder, exist_ok=True)
        self.poses_path = os.path.join(cfg.output_folder, cfg.poses_filename)
        self.velos_path = os.path.join(cfg.output_folder, cfg.velos_filename)
        self._poses_f = open(self.poses_path, "w", buffering=1)
        self._velos_f = open(self.velos_path, "w", buffering=1)
        self.n_poses = 0
        self.n_velos = 0

    def record_pose(self, time: float, T_wc) -> None:
        """Append one camToWorld pose (an SE3) in TUM format:
        ``t x y z qx qy qz qw``."""
        tr = _host(T_wc.t)
        q = mat_to_quat(torch.as_tensor(_host(T_wc.R),
                                        dtype=torch.float32)).numpy()
        self._poses_f.write(
            "%.9f %.6f %.6f %.6f %.6f %.6f %.6f %.6f\n"
            % (float(time), tr[0], tr[1], tr[2], q[1], q[2], q[3], q[0]))
        self.n_poses += 1

    def record_velocity(self, time: float, vx) -> None:
        """Append one 6-dof [linear, angular] velocity sample:
        ``t vx vy vz wx wy wz``."""
        v = _host(vx)
        self._velos_f.write("%.9f " % float(time)
                            + " ".join("%.6f" % x for x in v) + "\n")
        self.n_velos += 1

    def save_viz(self, name: str, img) -> str:
        """Write a float image in [0, 1] (or uint8) as ``<name>.png`` in the
        output folder; returns its path."""
        a = _host(img)
        if a.dtype != np.uint8:
            a = np.clip(np.nan_to_num(a) * 255.0, 0, 255).astype(np.uint8)
        path = os.path.join(self.cfg.output_folder, name + ".png")
        write_png(path, a)
        return path

    def flush(self) -> tuple:
        """Flush both files; returns their paths."""
        self._poses_f.flush()
        self._velos_f.flush()
        return self.poses_path, self.velos_path

    def close(self) -> None:
        self._poses_f.close()
        self._velos_f.close()

    def __del__(self):
        try:
            self.close()
        except AttributeError:   # __init__ failed before the files opened
            pass
