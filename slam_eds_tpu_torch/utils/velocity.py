"""Twist/velocity integration — port of ``slam_eds_tpu.utils.velocity``
(reference ``eds::utils::veloIntegration``, src/utils/Utils.hpp:459-515):
integrate a body twist (linear + angular velocity) over dt with a
4th-order quaternion integrator. Device and dtype come from the inputs.
"""
from __future__ import annotations

import torch

from . import lie
from .lie import SE3


def quat_integrate_rk4(q, omega, dt):
    """4th-order Runge-Kutta integration of dq/dt = 0.5 * q ⊗ [0, omega]
    with constant omega; returns the normalized quaternion."""
    def deriv(qi):
        return 0.5 * lie.quat_mul(qi, torch.cat([torch.zeros_like(omega[:1]),
                                                 omega]))
    k1 = deriv(q)
    k2 = deriv(q + 0.5 * dt * k1)
    k3 = deriv(q + 0.5 * dt * k2)
    k4 = deriv(q + dt * k3)
    q_new = q + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
    return lie.quat_normalize(q_new)


def velo_integration(T: SE3, velo, dt):
    """Integrate a 6-dof body twist velo = [v(3), w(3)] over dt on pose T:
    rotation by RK4 quaternion integration, translation by the rotated
    linear velocity. Returns the predicted pose."""
    q = lie.mat_to_quat(T.R)
    q_new = quat_integrate_rk4(q, velo[3:6], dt)
    t_new = T.t + T.R @ (velo[:3] * dt)
    return SE3(lie.quat_to_mat(q_new), t_new)


def twist_from_relative(T_prev: SE3, T_cur: SE3, dt):
    """The average body twist between consecutive poses."""
    rel = T_prev.inverse().compose(T_cur)
    tau = rel.log()
    return tau / torch.clamp(torch.as_tensor(dt, dtype=tau.dtype,
                                             device=tau.device), min=1e-9)
