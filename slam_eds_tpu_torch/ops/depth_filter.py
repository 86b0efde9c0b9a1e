"""Probabilistic inverse-depth filter (Vogiatzis/SVO Beta-Gaussian) — port
of ``slam_eds_tpu.ops.depth_filter``: per-point state [mu, sigma2, a, b],
two-view linear triangulation, a geometric measurement variance from a
1-pixel error angle, and the Vogiatzis update with its divergence guards, as
masked element-wise math over the fixed-capacity point set."""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..models.ba_state import tuple_from_numpy, tuple_to_numpy
from ..utils.lie import SE3
from ..utils.cameras import Pinhole


class DepthFilterState(NamedTuple):
    mu: torch.Tensor      # [P] inverse depth mean
    sigma2: torch.Tensor  # [P] variance
    a: torch.Tensor       # [P] Beta inlier count
    b: torch.Tensor       # [P] Beta outlier count


def to_numpy(state: DepthFilterState) -> dict:
    return tuple_to_numpy(state)


def from_numpy(d: dict, device="cuda") -> DepthFilterState:
    return tuple_from_numpy(DepthFilterState, d, device)


def angle_error(px_noise: float, fx: float, fy: float) -> float:
    """px_error_angle (DepthPoints.hpp:151-154)."""
    return math.atan(px_noise / (2.0 * fx)) + math.atan(px_noise / (2.0 * fy))


def init_uniform(num_points: int, min_depth: float, max_depth: float,
                 init_a: float = 2.0, init_b: float = 5.0, *, device,
                 dtype=torch.float32) -> DepthFilterState:
    """mu = 1/mean-depth, sigma2 = range^2 (DepthPoints::init)."""
    rng = max_depth - min_depth
    full = lambda v: torch.full((num_points,), v, dtype=dtype,  # noqa: E731
                                device=device)
    return DepthFilterState(mu=full(1.0 / (rng / 2.0)), sigma2=full(rng * rng),
                            a=full(init_a), b=full(init_b))


def init_from_prior(inv_depth, min_depth: float, max_depth: float,
                    init_a: float = 2.0, init_b: float = 5.0, *, device
                    ) -> DepthFilterState:
    """Init from a prior inverse depth [P], on ``device``: sigma2 =
    range^2/36."""
    rng = max_depth - min_depth
    inv_depth = inv_depth.to(device)
    return DepthFilterState(mu=inv_depth,
                            sigma2=torch.full_like(inv_depth, rng * rng / 36.0),
                            a=torch.full_like(inv_depth, init_a),
                            b=torch.full_like(inv_depth, init_b))


def _K(cam: Pinhole, like):
    """cam.K() on ``like``'s device and type."""
    return cam.K(like.dtype, device=like.device)


def triangulate_inv_depth(x_kf, x_ef, cam: Pinhole, T_kf_ef: SE3):
    """Two-view linear inverse-depth triangulation in the keyframe
    (invDepthTwoPointsEucl): x_kf, x_ef [P, 2] pixel coordinates,
    P_kf = K [I | 0], P_ef = K [R | t] with [R | t] = T_ef_kf."""
    K = _K(cam, x_kf)
    T_ef_kf = T_kf_ef.inverse()
    M2 = K @ T_ef_kf.R
    e2 = K @ T_ef_kf.t            # epipole of camera-1 centre in image 2
    Kinv = torch.linalg.inv_ex(K)[0]
    ones = torch.ones_like(x_kf[:, :1])
    x1 = torch.cat([x_kf, ones], -1)
    x2 = torch.cat([x_ef, ones], -1)
    x1p = x1 @ (M2 @ Kinv).T       # x1 at infinity, projected into image 2
    aux1 = torch.linalg.cross(x1p, x2)
    aux2 = torch.linalg.cross(x2, e2.expand_as(x2))
    denom = torch.sum(aux2 * aux2, -1)
    return torch.sum(aux1 * aux2, -1) / torch.clamp(denom, min=1e-20)


def compute_tau(T_kf_ef: SE3, x_norm_ef, z, px_error_angle: float):
    """Depth std from the triangulation geometry (computeTau): law of sines
    on the (t, bearing) triangle with the bearing perturbed by the pixel
    error angle."""
    t = T_kf_ef.t
    bearing = torch.cat([x_norm_ef, torch.ones_like(x_norm_ef[:, :1])], -1)
    bearing = bearing / torch.linalg.vector_norm(bearing, dim=-1,
                                                 keepdim=True)
    a_vec = bearing * z[:, None] - t[None, :]
    t_norm = torch.clamp(torch.linalg.vector_norm(t), min=1e-12)
    a_norm = torch.clamp(torch.linalg.vector_norm(a_vec, dim=-1), min=1e-12)
    alpha = torch.arccos(torch.clamp(bearing @ t / t_norm, -1.0, 1.0))
    beta = torch.arccos(torch.clamp(
        torch.sum(a_vec * (-t)[None, :], -1) / (t_norm * a_norm), -1.0, 1.0))
    beta_plus = beta + px_error_angle
    gamma_plus = math.pi - alpha - beta_plus
    z_plus = t_norm * torch.sin(beta_plus) / torch.clamp(
        torch.abs(torch.sin(gamma_plus)), min=1e-12)
    return z_plus - z


def sigma2_from_depth_sigma(depth, depth_sigma):
    """Inverse-depth variance from a depth std."""
    s = 0.5 * (1.0 / torch.clamp(depth - depth_sigma, min=1e-12)
               - 1.0 / (depth + depth_sigma))
    return s * s


def norm_pdf(x, mu, sigma):
    z = (x - mu) / sigma
    return torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2.0 * math.pi))


def vogiatzis_update(state: DepthFilterState, z, tau2, mu_range: float,
                     mask) -> DepthFilterState:
    """Masked Vogiatzis Bayesian update (filterVogiatzis) with the
    reference's guards: a non-finite or zero norm scale or measurement skips
    the point, a negative sigma2 keeps the old value, a negative mu resets to
    1, and the f - e/f denominator is clamped away from 0 keeping its
    sign."""
    mu, s2, a, b = state
    one = torch.ones_like(mu)
    norm_scale = torch.sqrt(s2 + tau2)
    ok = mask & torch.isfinite(norm_scale) & (norm_scale > 1e-12) \
        & torch.isfinite(z) & torch.isfinite(tau2)
    z = torch.where(ok, z, one)
    tau2 = torch.where(ok, tau2, one)
    ns = torch.where(ok, norm_scale, one)

    s2c = torch.clamp(s2, min=1e-20)
    tau2c = torch.clamp(tau2, min=1e-20)
    s2_new_meas = 1.0 / (1.0 / s2c + 1.0 / tau2c)
    m = s2_new_meas * (mu / s2c + z / tau2c)
    uniform_x = 1.0 / mu_range

    C1 = a / (a + b) * norm_pdf(z, mu, ns)
    C2 = b / (a + b) * uniform_x
    norm_c = torch.clamp(C1 + C2, min=1e-30)
    C1 = C1 / norm_c
    C2 = C2 / norm_c
    f = C1 * (a + 1.0) / (a + b + 1.0) + C2 * a / (a + b + 1.0)
    e = C1 * (a + 1.0) * (a + 2.0) / ((a + b + 1.0) * (a + b + 2.0)) \
        + C2 * a * (a + 1.0) / ((a + b + 1.0) * (a + b + 2.0))

    mu_new = C1 * m + C2 * mu
    s2_new = C1 * (s2_new_meas + m * m) + C2 * (s2 + mu * mu) - mu_new * mu_new
    fc = torch.clamp(f, min=1e-20)
    denom = f - e / fc
    tiny = torch.where(denom < 0, torch.full_like(denom, -1e-20),
                       torch.full_like(denom, 1e-20))
    denom = torch.where(torch.abs(denom) < 1e-20, tiny, denom)
    a_new = (e - f) / denom
    b_new = a_new * (1.0 - f) / fc

    s2_new = torch.where(s2_new < 0.0, s2, s2_new)
    mu_new = torch.where(mu_new < 0.0, one, mu_new)
    return DepthFilterState(*(torch.where(ok, new, old) for new, old in
                              ((mu_new, mu), (s2_new, s2), (a_new, a),
                               (b_new, b))))


def update(state: DepthFilterState, T_kf_ef: SE3, kf_coord, tracks,
           cam: Pinhole, mu_range: float, px_noise: float = 3.0,
           mask=None) -> DepthFilterState:
    """Measurement update from point tracks (DepthPoints::update): the
    event-frame correspondence is kf pixel + track; triangulate, tau from
    the geometry, Vogiatzis filter."""
    if mask is None:
        mask = torch.ones(kf_coord.shape[0], dtype=torch.bool,
                          device=kf_coord.device)
    x_ef = kf_coord + tracks
    inv_depth = triangulate_inv_depth(kf_coord, x_ef, cam, T_kf_ef)
    pos = inv_depth > 1e-12
    depth = 1.0 / torch.where(pos, inv_depth, torch.ones_like(inv_depth))
    x_norm = torch.stack([(x_ef[:, 0] - cam.cx) / cam.fx,
                          (x_ef[:, 1] - cam.cy) / cam.fy], -1)
    tau = compute_tau(T_kf_ef, x_norm, depth,
                      angle_error(px_noise, cam.fx, cam.fy))
    tau2 = sigma2_from_depth_sigma(depth, tau)
    return vogiatzis_update(state, inv_depth, tau2, mu_range, mask & pos)


def converged(state: DepthFilterState, mu_range: float, thresh: float):
    """sigma2 < (range/thresh)^2."""
    t = mu_range / thresh
    return state.sigma2 < t * t
