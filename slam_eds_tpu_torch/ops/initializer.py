"""Monocular two-view bootstrap — port of ``slam_eds_tpu.ops.initializer``
(batched-RANSAC essential matrix, cheirality-checked pose recovery,
midpoint triangulation).

RANSAC is the only random draw of the frame path. ``ransac_essential``
takes precomputed ``picks [Hyp, 8]`` or draws them from an explicit
``torch.Generator`` (uniformly over the valid correspondences, with
replacement — the distribution of the JAX ``jax.random.categorical`` draw;
the two generators give different numbers, so a parity test hands both
packages the same picks).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.lie import SE3


def _normalize_pts(x):
    """Hartley normalization of [..., N, 2]: zero mean, mean distance
    sqrt(2). Returns homogeneous points and the 3x3 transform."""
    mu = torch.mean(x, -2)
    d = torch.mean(torch.linalg.vector_norm(x - mu[..., None, :], dim=-1),
                   -1)
    s = d.new_tensor(2.0 ** 0.5) / torch.clamp(d, min=1e-12)
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([torch.stack([s, z, -s * mu[..., 0]], -1),
                     torch.stack([z, s, -s * mu[..., 1]], -1),
                     torch.stack([z, z, o], -1)], -2)
    xh = torch.cat([x, torch.ones_like(x[..., :1])], -1) @ T.transpose(-1, -2)
    return xh, T


def _svd(A, **kw):
    """``torch.linalg.svd``, on a card through cuSOLVER's QR-based
    ``gesvd``. Its default there, the Jacobi ``gesvdj``, returns singular
    vectors orthonormal only to a few float32 ulps, and the bootstrap's
    rotation U W V^T, onto which every later pose is composed, then
    leaves SO(3) about 4.6 times as far as the JAX package's on the CPU
    (largest |R R^T - I| 1.18e-6 against 2.57e-7 on the 640x480 frame
    cell's bootstrap, 2.26e-7 through ``gesvd``; NVIDIA H100 80GB
    HBM3)."""
    if A.is_cuda:
        kw["driver"] = "gesvd"
    return torch.linalg.svd(A, **kw)


def eight_point(x1, x2):
    """Essential matrix from >= 8 normalized-camera correspondences
    x1, x2 [..., N, 2] (least squares + essential projection), unit
    Frobenius norm, sign arbitrary."""
    x1h, T1 = _normalize_pts(x1)
    x2h, T2 = _normalize_pts(x2)
    A = torch.stack([
        x2h[..., 0] * x1h[..., 0], x2h[..., 0] * x1h[..., 1], x2h[..., 0],
        x2h[..., 1] * x1h[..., 0], x2h[..., 1] * x1h[..., 1], x2h[..., 1],
        x1h[..., 0], x1h[..., 1], torch.ones_like(x1h[..., 0])], -1)
    _, _, Vt = _svd(A, full_matrices=True)
    F = Vt[..., -1, :].reshape(Vt.shape[:-2] + (3, 3))
    U, S, Vt2 = _svd(F)
    m = 0.5 * (S[..., 0] + S[..., 1])
    S = torch.stack([m, m, torch.zeros_like(m)], -1)
    F = U @ torch.diag_embed(S) @ Vt2
    E = T2.transpose(-1, -2) @ F @ T1
    n = torch.linalg.matrix_norm(E)
    return E / torch.clamp(n, min=1e-12)[..., None, None]


def sampson_distance(E, x1, x2):
    """Squared Sampson distance of correspondences to E; E [..., 3, 3],
    x1, x2 [N, 2] -> [..., N]."""
    x1h = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    x2h = torch.cat([x2, torch.ones_like(x2[:, :1])], -1)
    Ex1 = x1h @ E.transpose(-1, -2)
    Etx2 = x2h @ E
    num = torch.sum(x2h * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 \
        + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def sample_picks(mask, num_hypotheses: int,
                 generator: Optional[torch.Generator] = None):
    """[Hyp, 8] indices drawn uniformly (with replacement) from the valid
    correspondences — from all of them when none is valid."""
    valid = torch.nonzero(mask).reshape(-1)
    if valid.numel() == 0:
        valid = torch.arange(mask.shape[0], device=mask.device)
    r = torch.randint(0, valid.numel(), (num_hypotheses, 8),
                      generator=generator, device=mask.device)
    return valid[r]


def ransac_essential(x1, x2, mask, picks=None,
                     generator: Optional[torch.Generator] = None,
                     num_hypotheses: int = 128, threshold: float = 1e-4):
    """Batched RANSAC: solve every hypothesis' E at once, score Sampson
    inliers, re-fit on the best inlier set. Returns (E, inliers, n)."""
    if picks is None:
        picks = sample_picks(mask, num_hypotheses, generator)
    picks = picks.to(device=x1.device, dtype=torch.int64)
    Es = eight_point(x1[picks], x2[picks])              # [Hyp, 3, 3]
    inl = (sampson_distance(Es, x1, x2) < threshold) & mask[None, :]
    best_inl = inl[torch.argmax(torch.sum(inl, 1))]

    # re-fit on the inliers; outliers collapse onto the inlier centroid
    w = best_inl.to(x1.dtype)[:, None]
    nw = torch.clamp(torch.sum(w), min=1.0)
    c1 = torch.sum(x1 * w, 0) / nw
    c2 = torch.sum(x2 * w, 0) / nw
    E = eight_point(torch.where(best_inl[:, None], x1, c1),
                    torch.where(best_inl[:, None], x2, c2))
    inl_final = (sampson_distance(E, x1, x2) < threshold) & mask
    return E, inl_final, torch.sum(inl_final)


def triangulate_midpoint(x1, x2, T_21: SE3):
    """Midpoint triangulation of normalized-camera rays. Returns
    (X1 [N, 3] in camera 1, depth-positive mask)."""
    d1 = torch.cat([x1, torch.ones_like(x1[:, :1])], -1)
    d2c1 = torch.cat([x2, torch.ones_like(x2[:, :1])], -1) @ T_21.R
    c2 = -(T_21.R.T @ T_21.t)
    a11 = torch.sum(d1 * d1, -1)
    a12 = -torch.sum(d1 * d2c1, -1)
    a22 = torch.sum(d2c1 * d2c1, -1)
    b1 = torch.sum(d1 * c2[None, :], -1)
    b2 = -torch.sum(d2c1 * c2[None, :], -1)
    det = a11 * a22 - a12 * a12
    det_s = torch.where(torch.abs(det) > 1e-12, det,
                        torch.full_like(det, 1e-12))
    s = (a22 * b1 - a12 * b2) / det_s
    t = (a11 * b2 - a12 * b1) / det_s
    X1 = 0.5 * (d1 * s[:, None] + (d2c1 * t[:, None] + c2[None, :]))
    return X1, (s > 1e-6) & (t > 1e-6)


def recover_pose(E, x1, x2, mask):
    """Cheirality-checked decomposition of E into (R, t), |t| = 1: the
    candidate with the most points in front of both cameras wins."""
    U, _, Vt = _svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    Wm = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                      dtype=E.dtype, device=E.device)
    R1 = U @ Wm @ Vt
    R2 = U @ Wm.T @ Vt
    t = U[:, 2]
    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts = torch.stack([
        torch.sum(triangulate_midpoint(x1, x2, SE3(R, tt))[1] & mask)
        for R, tt in cands])
    best = torch.argmax(counts)
    R = torch.stack([c[0] for c in cands])[best]
    tt = torch.stack([c[1] for c in cands])[best]
    return SE3(R, tt), counts[best]


class BootstrapResult(NamedTuple):
    T_21: SE3
    idepth: torch.Tensor
    inliers: torch.Tensor
    success: torch.Tensor


def bootstrap_eight_point(nc1, nc2, mask, picks=None,
                          generator: Optional[torch.Generator] = None,
                          num_hypotheses: int = 128,
                          threshold: float = 1e-4,
                          min_inliers: int = 12) -> BootstrapResult:
    """E-RANSAC -> recoverPose -> triangulation, rescaled so the mean
    inlier idepth is 1; success if more than ``min_inliers`` inliers."""
    E, inl, n_inl = ransac_essential(nc1, nc2, mask, picks=picks,
                                     generator=generator,
                                     num_hypotheses=num_hypotheses,
                                     threshold=threshold)
    T_21, _ = recover_pose(E, nc1, nc2, inl)
    X1, ok = triangulate_midpoint(nc1, nc2, T_21)
    idepth = torch.where(ok, 1.0 / torch.clamp(X1[:, 2], min=1e-6),
                         torch.zeros_like(X1[:, 2]))
    good = inl & ok
    s = torch.sum(torch.where(good, idepth, torch.zeros_like(idepth))) \
        / torch.clamp(torch.sum(good.to(idepth.dtype)), min=1.0)
    s = torch.where(s > 1e-8, s, torch.ones_like(s))
    return BootstrapResult(T_21=SE3(T_21.R, T_21.t * s), idepth=idepth / s,
                           inliers=good, success=n_inl > min_inliers)
