"""SO(3)/SE(3) math — port of ``slam_eds_tpu.utils.lie``.

Same conventions (Sophus): SE(3) tangents are ``[upsilon(3), omega(3)]``,
quaternions ``[w, x, y, z]``, closed forms with Taylor guards selected by
``torch.where`` (no data-dependent branching). Where the JAX functions act on
one element and are vmapped, these take any leading batch shape directly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

_EPS = 1e-8


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def hat(w):
    """so(3) hat operator: [..., 3] -> [..., 3, 3] skew matrices."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def vee(W):
    """Inverse of hat: [..., 3, 3] skew matrices -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def so3_exp(w):
    """Rodrigues formula: axis-angle [..., 3] -> rotation [..., 3, 3]."""
    theta2 = _dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    A = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    return _eye3(w) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def so3_log(R):
    """Rotation [..., 3, 3] -> axis-angle [..., 3] via the unit quaternion."""
    q = mat_to_quat(R)
    q = torch.where(q[..., :1] < 0, -q, q)
    qw = q[..., 0]
    qv = q[..., 1:]
    n = torch.linalg.vector_norm(qv, dim=-1)
    theta = 2.0 * torch.atan2(n, qw)
    small = n < 1e-6
    scale = torch.where(small, 2.0 / torch.clamp(qw, min=0.5),
                        theta / (n + _EPS * _EPS))
    return scale[..., None] * qv


def _so3_left_jacobian(w):
    theta2 = _dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS * _EPS))
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS * _EPS))
    W = hat(w)
    return _eye3(w) + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _so3_left_jacobian_inv(w):
    theta2 = _dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - 0.5 * theta * torch.cos(0.5 * theta)
         / (torch.sin(0.5 * theta) + _EPS * _EPS)) / (theta2 + _EPS * _EPS))
    W = hat(w)
    return _eye3(w) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def _matvec(M, x):
    return (M @ x[..., None])[..., 0]


class SE3(NamedTuple):
    """Rigid transform ``x_out = R @ x + t``; R [..., 3, 3], t [..., 3]."""
    R: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, *, device):
        return SE3(torch.eye(3, dtype=dtype, device=device),
                   torch.zeros(3, dtype=dtype, device=device))

    @staticmethod
    def exp(tau):
        """Tangent [..., 6] = [upsilon, omega] -> SE3."""
        v, w = tau[..., :3], tau[..., 3:6]
        return SE3(so3_exp(w), _matvec(_so3_left_jacobian(w), v))

    def log(self):
        w = so3_log(self.R)
        v = _matvec(_so3_left_jacobian_inv(w), self.t)
        return torch.cat([v, w], -1)

    def __matmul__(self, other):
        if isinstance(other, SE3):
            return self.compose(other)
        raise TypeError(type(other))

    def compose(self, other: "SE3") -> "SE3":
        return SE3(self.R @ other.R, _matvec(self.R, other.t) + self.t)

    def inverse(self) -> "SE3":
        Rt = self.R.transpose(-1, -2)
        return SE3(Rt, -_matvec(Rt, self.t))

    def apply(self, x):
        """Transform points x [..., 3]."""
        return _matvec(self.R, x) + self.t

    def adjoint(self):
        """[..., 6, 6] adjoint in [trans, rot] tangent order (Sophus Adj)."""
        z = torch.zeros_like(self.R)
        top = torch.cat([self.R, hat(self.t) @ self.R], -1)
        bot = torch.cat([z, self.R], -1)
        return torch.cat([top, bot], -2)

    def matrix(self):
        """[..., 4, 4] homogeneous matrix."""
        top = torch.cat([self.R, self.t[..., None]], -1)
        bot = torch.zeros_like(top[..., :1, :])
        bot[..., 0, 3].fill_(1.0)
        return torch.cat([top, bot], -2)

    @staticmethod
    def from_matrix(M):
        return SE3(M[..., :3, :3], M[..., :3, 3])


# ---------------------------------------------------------------------------
# Quaternions [w, x, y, z] — the event tracker's pose state.
# ---------------------------------------------------------------------------

def quat_identity(dtype, device):
    q = torch.zeros(4, dtype=dtype, device=device)
    # fill_, not ``q[0] = 1.0``: a scalar assignment copies a host tensor,
    # which a captured CUDA graph cannot hold
    q[0].fill_(1.0)
    return q


def quat_mul(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], -1)


def quat_exp(w):
    """so(3) axis-angle [..., 3] -> unit quaternion [..., 4]."""
    theta2 = _dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    half = 0.5 * theta
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([torch.cos(half)[..., None], k[..., None] * w], -1)


def quat_normalize(q):
    return q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], -2)


def mat_to_quat(R):
    """Rotation [..., 3, 3] -> unit quaternion [..., 4] (branch-free
    Shepperd: all four cases evaluated, the largest diagonal picks)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=_EPS)) * 2.0

    s = s_of(tr + 1.0)
    case_w = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s,
                          (m10 - m01) / s], -1)
    s = s_of(1.0 + m00 - m11 - m22)
    case_x = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s,
                          (m02 + m20) / s], -1)
    s = s_of(1.0 + m11 - m00 - m22)
    case_y = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s,
                          (m12 + m21) / s], -1)
    s = s_of(1.0 + m22 - m00 - m11)
    case_z = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s,
                          0.25 * s], -1)
    qs = torch.stack([case_w, case_x, case_y, case_z], -2)     # [..., 4, 4]
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    q = torch.gather(qs, -2, idx[..., None, None].expand(
        idx.shape + (1, 4)))[..., 0, :]
    return quat_normalize(q)


def quat_rotate(q, v):
    """Rotate vector(s) v [..., 3] by quaternion q without forming the
    matrix."""
    qv = q[..., 1:].expand(v.shape)
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def se3_mean(taus, weights=None):
    """(Weighted) mean of SE(3) tangent vectors [N, 6], the pose-window Lie
    mean."""
    if weights is None:
        return torch.mean(taus, 0)
    w = weights / (torch.sum(weights) + _EPS)
    return torch.sum(taus * w[:, None], 0)
