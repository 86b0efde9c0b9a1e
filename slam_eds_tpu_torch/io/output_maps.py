"""World-frame pointcloud and trajectory export from the BA window state —
port of ``slam_eds_tpu.io.output_maps``.

Points live in fixed-capacity masked tensors (BAState), so the export is one
vectorized backprojection and rigid transform plus a validity mask on the
state's device; the caller gets numpy arrays and the PLY / TUM writers.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import ba_state as bs
from ..utils.lie import SE3, mat_to_quat
from ..utils.viz import apply_colormap, JET


class PointCloud(NamedTuple):
    xyz: np.ndarray      # [N, 3] world coordinates
    color: np.ndarray    # [N, 3] uint8
    valid: np.ndarray    # [N] bool


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _backproject_window(state: bs.BAState):
    """World xyz [P, 3] for every point slot and a validity mask [P]: active
    or marginalized points of a valid host frame with a positive idepth."""
    fx, fy, cx, cy = state.current_calib().unbind(0)
    idp = torch.clamp(state.p_idepth, min=1e-8)
    X_host = torch.stack([(state.p_uv[:, 0] - cx) / fx / idp,
                          (state.p_uv[:, 1] - cy) / fy / idp,
                          1.0 / idp], -1)
    T_cw = state.current_poses().inverse()              # camToWorld per slot
    host = state.p_host.long()
    xyz_w = SE3(T_cw.R[host], T_cw.t[host]).apply(X_host)
    valid = ((state.p_status == bs.PT_ACTIVE)
             | (state.p_status == bs.PT_MARGINALIZE))
    valid = valid & state.frame_valid[host] & (state.p_idepth > 1e-6)
    return xyz_w, valid


def radius_outlier_removal(xyz, valid, nb_points: int = 8,
                           radius: float = 0.1):
    """Keep points with at least ``nb_points`` valid neighbours within
    ``radius``: a brute-force [N, N] distance matrix from one float32
    matmul. Returns the tightened validity mask."""
    x = xyz.to(torch.float32)
    sq = torch.sum(x * x, -1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
    near = (d2 <= radius * radius) & valid[None, :] & valid[:, None]
    return valid & (near.sum(1) - 1 >= nb_points)       # itself excluded


def get_map(state: bs.BAState, images=None, color_mode: str = "image",
            sor=None) -> PointCloud:
    """Export the BA window as a colored world pointcloud.

    color_mode: 'image' reads the host keyframe's intensity at the point's
    pixel (images: the window's [F, H, W] or [F, H, W, C] stack); 'depth'
    colors by inverse depth. sor: optional (nb_points, radius) for the
    radius outlier removal of the exported cloud."""
    xyz, valid = _backproject_window(state)
    if sor is not None:
        valid = radius_outlier_removal(xyz, valid, int(sor[0]), float(sor[1]))
    xyz = _host(xyz)
    valid = _host(valid)
    color = np.full((xyz.shape[0], 3), 200, np.uint8)
    if color_mode == "image" and images is not None:
        imgs = _host(images)
        uv = _host(state.p_uv)
        H, W = imgs.shape[1], imgs.shape[2]
        u = np.clip(np.round(uv[:, 0]).astype(np.int64), 0, W - 1)
        v = np.clip(np.round(uv[:, 1]).astype(np.int64), 0, H - 1)
        inten = imgs[_host(state.p_host), v, u]
        if inten.ndim == 2:          # channels (I, dx, dy)
            inten = inten[:, 0]
        g = np.clip(inten, 0, 255).astype(np.uint8)
        color = np.stack([g, g, g], -1)
    elif color_mode == "depth":
        idp = _host(state.p_idepth)
        sel = idp[valid] if valid.any() else idp
        color = apply_colormap(idp, JET, vmin=float(sel.min()),
                               vmax=float(sel.max()))
    return PointCloud(xyz=xyz, color=color, valid=valid)


def write_ply(path: str, cloud: PointCloud) -> int:
    """ASCII PLY dump of the valid points; returns the point count."""
    xyz = cloud.xyz[cloud.valid]
    rgb = cloud.color[cloud.valid]
    n = len(xyz)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {n}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\n"
                "property uchar blue\nend_header\n")
        for p, c in zip(xyz, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")
    return n


def write_trajectory_tum(path: str, times, poses: SE3) -> int:
    """TUM-format trajectory dump (``t x y z qx qy qz qw``) of batched
    worldToCam poses (R [N, 3, 3], t [N, 3]), exported camToWorld."""
    T_cw = SE3(torch.as_tensor(_host(poses.R), dtype=torch.float32),
               torch.as_tensor(_host(poses.t), dtype=torch.float32)).inverse()
    q = mat_to_quat(T_cw.R).numpy()                     # [N, 4] w, x, y, z
    twc = T_cw.t.numpy()
    times = np.asarray(times)
    with open(path, "w") as f:
        for k in range(len(times)):
            f.write(f"{times[k]:.9f} {twc[k, 0]:.6f} {twc[k, 1]:.6f} "
                    f"{twc[k, 2]:.6f} {q[k, 1]:.6f} {q[k, 2]:.6f} "
                    f"{q[k, 3]:.6f} {q[k, 0]:.6f}\n")
    return len(times)
