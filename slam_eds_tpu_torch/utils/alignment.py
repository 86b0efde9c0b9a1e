"""Trajectory alignment and error metrics — port of
``slam_eds_tpu.utils.alignment`` (Umeyama, ATE, RPE)."""
from __future__ import annotations

import torch

from .lie import SE3


def umeyama(src, dst, with_scale: bool = True):
    """Least-squares similarity dst ~ s * R @ src + t for [N, 3] point
    sets (Umeyama 1991). Returns (s, R, t)."""
    mu_s = torch.mean(src, 0)
    mu_d = torch.mean(dst, 0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = (xd.T @ xs) / src.shape[0]
    U, D, Vt = torch.linalg.svd(cov)
    S = torch.eye(3, dtype=src.dtype, device=src.device)
    if torch.linalg.det(U) * torch.linalg.det(Vt) < 0:
        S[2, 2] = -1.0
    R = U @ S @ Vt
    var_s = torch.mean(torch.sum(xs ** 2, 1))
    s = (torch.sum(D * torch.diagonal(S)) / torch.clamp(var_s, min=1e-12)
         if with_scale else torch.ones((), dtype=src.dtype, device=src.device))
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_xyz, gt_xyz, align: bool = True, with_scale: bool = True):
    """Absolute trajectory error RMSE after (optional) Umeyama alignment.
    Accepts tensors or arrays; computes in float32 like the JAX version."""
    est = torch.as_tensor(est_xyz, dtype=torch.float32)
    gt = torch.as_tensor(gt_xyz, dtype=torch.float32, device=est.device)
    if align:
        s, R, t = umeyama(est, gt, with_scale)
        est = s * est @ R.T + t
    return torch.sqrt(torch.mean(torch.sum((est - gt) ** 2, 1)))


def rpe(est_poses, gt_poses, delta: int = 1):
    """Relative pose error over a frame gap ``delta``. est_poses / gt_poses:
    SE3 with a leading axis N (world_T_cam). Returns (trans_rmse,
    rot_rmse_rad)."""
    def rel(poses):
        a = SE3(poses.R[:-delta], poses.t[:-delta])
        b = SE3(poses.R[delta:], poses.t[delta:])
        return a.inverse().compose(b)

    err = rel(gt_poses).inverse().compose(rel(est_poses))
    t_err = torch.sqrt(torch.mean(torch.sum(err.t ** 2, -1)))
    trace = torch.diagonal(err.R, dim1=-2, dim2=-1).sum(-1)
    cos_r = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    return t_err, torch.sqrt(torch.mean(torch.acos(cos_r) ** 2))
