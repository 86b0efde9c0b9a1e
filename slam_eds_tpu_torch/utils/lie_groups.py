"""SO(2), SE(2), R⁺×SO(3) and Sim(3) — port of
``slam_eds_tpu.utils.lie_groups`` (the reference's vendored Sophus,
``src/sophus/{so2,se2,rxso3,sim3}.hpp``).

Sophus conventions: the SE(2) tangent is ``[upsilon(2), theta]``, the
RxSO(3) tangent ``[omega(3), sigma]`` with scale ``s = exp(sigma)``, the
Sim(3) tangent ``[upsilon(3), omega(3), sigma]``; Sim(3) ``exp`` composes
``s·R`` with ``t = W(omega, sigma) @ upsilon``, ``W = ∫₀¹ e^{σu} exp(u·ω̂)
du`` (``sim3.hpp:609`` ``calcW``). Taylor fallbacks are selected by
``torch.where`` with guarded denominators, as in ``utils/lie.py``. Device
and dtype come from the inputs.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import _EPS, _dot, _matvec, hat, so3_exp, so3_log


# ---------------------------------------------------------------------------
# SO(2) — reference src/sophus/so2.hpp
# ---------------------------------------------------------------------------

def so2_exp(theta):
    """Angle [...] -> rotation [..., 2, 2]."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)],
                       -2)


def so2_log(R):
    """Rotation [..., 2, 2] -> angle in (-pi, pi]."""
    return torch.atan2(R[..., 1, 0], R[..., 0, 0])


# ---------------------------------------------------------------------------
# SE(2) — reference src/sophus/se2.hpp
# ---------------------------------------------------------------------------

def _se2_V(theta):
    """SE(2) left Jacobian: t = V(theta) @ upsilon."""
    t2 = theta * theta
    small = t2 < _EPS
    one = torch.ones_like(theta)
    A = torch.where(small, 1.0 - t2 / 6.0,
               torch.sin(theta) / torch.where(small, one, theta))
    B = torch.where(small, 0.5 * theta - t2 * theta / 24.0,
               (1.0 - torch.cos(theta)) / torch.where(small, one, theta))
    return torch.stack([torch.stack([A, -B], -1), torch.stack([B, A], -1)],
                       -2)


def se2_exp(tau):
    """Tangent [..., 3] = [ux, uy, theta] -> (R [..., 2, 2], t [..., 2])."""
    u, theta = tau[..., :2], tau[..., 2]
    return so2_exp(theta), _matvec(_se2_V(theta), u)


def se2_log(R, t):
    """(R, t) -> tangent [..., 3] = [ux, uy, theta]."""
    theta = so2_log(R)
    V = _se2_V(theta)
    # 2x2 inverse, det(V) = A^2 + B^2 > 0 for theta in (-pi, pi]
    det = V[..., 0, 0] * V[..., 1, 1] - V[..., 0, 1] * V[..., 1, 0]
    Vinv = torch.stack([torch.stack([V[..., 1, 1], -V[..., 0, 1]], -1),
                        torch.stack([-V[..., 1, 0], V[..., 0, 0]], -1)], -2) \
        / (det + _EPS * _EPS)[..., None, None]
    return torch.cat([_matvec(Vinv, t), theta[..., None]], -1)


# ---------------------------------------------------------------------------
# RxSO(3) — scaled rotations, reference src/sophus/rxso3.hpp
# ---------------------------------------------------------------------------

def rxso3_exp(tau):
    """Tangent [..., 4] = [omega(3), sigma] -> scaled rotation s*R."""
    w, sigma = tau[..., :3], tau[..., 3]
    return torch.exp(sigma)[..., None, None] * so3_exp(w)


def _cbrt(x):
    return torch.sign(x) * torch.abs(x) ** (1.0 / 3.0)


def rxso3_log(sR):
    """Scaled rotation [..., 3, 3] -> [omega(3), sigma]."""
    s = _cbrt(torch.linalg.det(sR))
    R = sR / (s + _EPS * _EPS)[..., None, None]
    return torch.cat([so3_log(R), torch.log(s)[..., None]], -1)


# ---------------------------------------------------------------------------
# Sim(3) — reference src/sophus/sim3.hpp
# ---------------------------------------------------------------------------

def _sim3_W(w, sigma):
    """W = ∫₀¹ e^{σu} exp(u ω̂) du = C·I + A·ω̂ + B·ω̂², the matrix coupling
    translation and [rotation, scale] in Sim(3) exp (sim3.hpp:609 calcW).

    Closed forms from the integrals
      C   = (e^σ - 1)/σ
      I_s = ∫ e^{σu} sin(uθ) du = (e^σ(σ sinθ - θ cosθ) + θ)/(σ² + θ²)
      I_c = ∫ e^{σu} cos(uθ) du = (e^σ(σ cosθ + θ sinθ) - σ)/(σ² + θ²)
      A = I_s/θ,  B = (C - I_c)/θ²
    with Taylor fallbacks when θ and/or σ vanish."""
    theta2 = _dot(w, w)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    sigma2 = sigma * sigma
    es = torch.exp(sigma)
    small_t = theta2 < _EPS
    small_s = sigma2 < _EPS
    one = torch.ones_like(sigma)

    # C = (e^sigma - 1)/sigma, Taylor: 1 + sigma/2 + sigma^2/6
    C = torch.where(small_s, 1.0 + 0.5 * sigma + sigma2 / 6.0,
               (es - 1.0) / torch.where(small_s, one, sigma))

    denom = sigma2 + theta2
    safe_denom = torch.where(denom < _EPS, torch.ones_like(denom), denom)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)

    A_main = (es * (sigma * sin_t - theta * cos_t) + theta) \
        / (theta * safe_denom)
    # theta -> 0, sigma != 0:  A = (e^sigma (sigma - 1) + 1)/sigma^2
    A_st = (es * (sigma - 1.0) + 1.0) / torch.where(small_s, one, sigma2)
    # theta, sigma -> 0: (e^s(s-1)+1)/s^2 = 1/2 + s/3 + O(s^2)
    A_both = 0.5 + sigma / 3.0
    A = torch.where(small_t, torch.where(small_s, A_both, A_st), A_main)

    B_main = (C - (es * (sigma * cos_t + theta * sin_t) - sigma)
              / safe_denom) / torch.where(small_t, torch.ones_like(theta2), theta2)
    # theta -> 0, sigma != 0:  B = (e^sigma(sigma^2/2 - sigma + 1) - 1)/sigma^3
    B_st = (es * (0.5 * sigma2 - sigma + 1.0) - 1.0) \
        / torch.where(small_s, one, sigma2 * sigma)
    # theta, sigma -> 0: (e^s(s^2/2-s+1)-1)/s^3 = 1/6 + s/8 + O(s^2)
    B_both = 1.0 / 6.0 + sigma / 8.0
    B = torch.where(small_t, torch.where(small_s, B_both, B_st), B_main)

    W = hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return C[..., None, None] * eye + A[..., None, None] * W \
        + B[..., None, None] * (W @ W)


class Sim3(NamedTuple):
    """Similarity transform ``x_out = s * R @ x + t``, stored as (R, t, s):
    R [..., 3, 3] orthonormal, t [..., 3], s [...] scale."""
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor

    @staticmethod
    def identity(dtype=torch.float32, *, device):
        return Sim3(torch.eye(3, dtype=dtype, device=device),
                    torch.zeros(3, dtype=dtype, device=device),
                    torch.ones((), dtype=dtype, device=device))

    @staticmethod
    def exp(tau):
        """Tangent [..., 7] = [upsilon(3), omega(3), sigma] -> Sim3."""
        v, w, sigma = tau[..., :3], tau[..., 3:6], tau[..., 6]
        return Sim3(so3_exp(w), _matvec(_sim3_W(w, sigma), v),
                    torch.exp(sigma))

    def log(self):
        w = so3_log(self.R)
        sigma = torch.log(self.s)
        v = torch.linalg.solve(_sim3_W(w, sigma), self.t[..., None])[..., 0]
        return torch.cat([v, w, sigma[..., None]], -1)

    def compose(self, other: "Sim3") -> "Sim3":
        return Sim3(self.R @ other.R,
                    self.s[..., None] * _matvec(self.R, other.t) + self.t,
                    self.s * other.s)

    def inverse(self) -> "Sim3":
        Rt = self.R.transpose(-1, -2)
        si = 1.0 / self.s
        return Sim3(Rt, -si[..., None] * _matvec(Rt, self.t), si)

    def apply(self, x):
        return self.s[..., None] * _matvec(self.R, x) + self.t

    def adjoint(self):
        """7x7 adjoint in [upsilon, omega, sigma] order (sim3.hpp Adj)."""
        A = torch.zeros((7, 7), dtype=self.R.dtype, device=self.R.device)
        A[:3, :3] = self.s * self.R
        A[:3, 3:6] = hat(self.t) @ self.R
        A[:3, 6] = -self.t
        A[3:6, 3:6] = self.R
        A[6, 6] = 1.0
        return A

    def matrix(self):
        """[..., 4, 4] homogeneous matrix."""
        M = torch.zeros(self.R.shape[:-2] + (4, 4), dtype=self.R.dtype,
                        device=self.R.device)
        M[..., :3, :3] = self.s[..., None, None] * self.R
        M[..., :3, 3] = self.t
        M[..., 3, 3] = 1.0
        return M
