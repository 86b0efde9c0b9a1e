"""Parity of the port's ``utils/lie_groups.py`` (SO(2), SE(2), RxSO(3),
Sim(3)) and ``utils/velocity.py`` with the JAX package on the CPU: the same
seeded numpy inputs through each function of both packages, the cases of
``tests/test_lie_groups.py`` (round trips, group axioms, adjoint identity,
Taylor branches near zero) plus the velocity helpers.

Tolerances: float32 outputs within 1e-5 of the JAX package's (1e-4 for the
Sim(3) log, whose 3x3 solve goes through two different LU routines), the
property checks with the JAX test's own bounds; the float64 Taylor-branch
check as in the JAX test.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.utils import lie_groups as jlg
from slam_eds_tpu.utils import velocity as jvel
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.utils import lie_groups as tlg
from slam_eds_tpu_torch.utils import velocity as tvel
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3

RNG = np.random.default_rng(7)
TAUS3 = RNG.normal(size=(32, 3)).astype(np.float32)
TAUS4 = (RNG.normal(size=(16, 4)) * [1.0, 1.0, 1.0, 0.5]).astype(np.float32)
TAUS7 = RNG.normal(size=(16, 7)).astype(np.float32)


def T(a, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


def close(a, b, atol=1e-5):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=1e-5)


def test_so2_roundtrip():
    for theta in [-3.0, -0.5, 0.0, 1e-9, 0.7, 3.1]:
        R = tlg.so2_exp(T(theta))
        close(R, jlg.so2_exp(jnp.float32(theta)))
        assert np.allclose(R @ R.T, np.eye(2), atol=1e-6)
        assert np.allclose(tlg.so2_log(R), theta, atol=1e-6)
        close(tlg.so2_log(R), jlg.so2_log(jnp.asarray(R.numpy())))


def test_se2_roundtrip():
    R, t = tlg.se2_exp(T(TAUS3))                       # batched
    for i, tau in enumerate(TAUS3):
        jR, jt = jlg.se2_exp(jnp.asarray(tau))
        close(R[i], jR)
        close(t[i], jt)
        close(tlg.se2_log(R[i], t[i]), jlg.se2_log(jR, jt))
    assert np.allclose(tlg.se2_log(R, t), TAUS3, atol=1e-5)


def test_se2_small_angle():
    tau = np.array([0.3, -0.2, 1e-10], np.float32)
    R, t = tlg.se2_exp(T(tau))
    jR, jt = jlg.se2_exp(jnp.asarray(tau))
    close(t, jt)
    assert np.allclose(t, tau[:2], atol=1e-6)
    assert np.allclose(tlg.se2_log(R, t), tau, atol=1e-6)


def test_rxso3_roundtrip():
    sR = tlg.rxso3_exp(T(TAUS4))
    for i, tau in enumerate(TAUS4):
        jsR = jlg.rxso3_exp(jnp.asarray(tau))
        close(sR[i], jsR)
        close(tlg.rxso3_log(sR[i]), jlg.rxso3_log(jsR))
        assert float(torch.linalg.det(sR[i])) > 0
    assert np.allclose(tlg.rxso3_log(sR), TAUS4, atol=1e-5)


def test_sim3_W_matches_quadrature_and_jax():
    """W against the JAX closed form and a fine quadrature of
    integral_0^1 e^{sigma u} exp(u w^) du (numpy Rodrigues)."""
    def rodrigues(w):
        th = np.linalg.norm(w)
        if th < 1e-12:
            return np.eye(3)
        k = w / th
        K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]],
                      [-k[1], k[0], 0]])
        return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)

    rng = np.random.default_rng(0)
    for _ in range(8):
        w = rng.normal(size=3).astype(np.float32)
        sigma = np.float32(rng.normal() * 0.5)
        us = np.linspace(0, 1, 4001)
        acc = sum(np.exp(float(sigma) * u) * rodrigues(u * w) for u in us)
        acc = acc / len(us) - 0.5 * (np.eye(3) + np.exp(float(sigma))
                                     * rodrigues(w)) / len(us)
        W = tlg._sim3_W(T(w), T(sigma)).numpy()
        close(W, jlg._sim3_W(jnp.asarray(w), jnp.asarray(sigma)))
        assert np.allclose(W, acc, atol=2e-3), (W, acc)


@pytest.mark.parametrize("scale_tau", [1.0, 1e-6])
def test_sim3_roundtrip(scale_tau):
    taus = (TAUS7 * scale_tau).astype(np.float32)
    g = tlg.Sim3.exp(T(taus))
    for i, tau in enumerate(taus):
        jg = jlg.Sim3.exp(jnp.asarray(tau))
        close(g.R[i], jg.R)
        close(g.t[i], jg.t)
        close(g.s[i], jg.s)
        gi = tlg.Sim3(g.R[i], g.t[i], g.s[i])
        close(gi.log(), jg.log(), atol=1e-4)
        assert np.allclose(gi.log(), tau, atol=1e-4), (tau, gi.log())


def test_sim3_group_axioms():
    ta = np.array([0.1, -0.2, 0.3, 0.2, 0.1, -0.3, 0.15], np.float32)
    tb = np.array([-0.3, 0.1, 0.2, -0.1, 0.25, 0.05, -0.2], np.float32)
    a, b = tlg.Sim3.exp(T(ta)), tlg.Sim3.exp(T(tb))
    ja, jb = jlg.Sim3.exp(jnp.asarray(ta)), jlg.Sim3.exp(jnp.asarray(tb))
    x = np.array([0.5, -1.0, 2.0], np.float32)
    ab = a.compose(b)
    close(ab.apply(T(x)), ja.compose(jb).apply(jnp.asarray(x)))
    assert np.allclose(ab.apply(T(x)), a.apply(b.apply(T(x))), atol=1e-5)
    ident = a.compose(a.inverse())
    close(a.inverse().t, ja.inverse().t)
    close(a.matrix(), ja.matrix())
    assert np.allclose(ident.R, np.eye(3), atol=1e-5)
    assert np.allclose(ident.t, 0.0, atol=1e-5)
    assert np.allclose(ident.s, 1.0, atol=1e-5)
    assert np.allclose(tlg.Sim3.identity(device="cpu").matrix(), np.eye(4))


def test_sim3_adjoint_identity():
    """Adj_g tau == log(g * exp(tau) * g^-1) for small tau."""
    tg = np.array([0.2, 0.1, -0.4, 0.3, -0.2, 0.1, 0.25], np.float32)
    tau = np.array([1e-3, -2e-3, 1.5e-3, 2e-3, -1e-3, 0.5e-3, 1e-3],
                   np.float32)
    g = tlg.Sim3.exp(T(tg))
    close(g.adjoint(), jlg.Sim3.exp(jnp.asarray(tg)).adjoint())
    lhs = g.adjoint() @ T(tau)
    rhs = g.compose(tlg.Sim3.exp(T(tau))).compose(g.inverse()).log()
    assert np.allclose(lhs, rhs, atol=1e-5), (lhs, rhs)


def test_sim3_reduces_to_se3():
    """sigma = 0 reproduces SE(3) exp (utils/lie.SE3)."""
    tau6 = np.array([0.3, -0.1, 0.5, 0.2, -0.4, 0.1], np.float32)
    g = tlg.Sim3.exp(T(np.concatenate([tau6, [0.0]])))
    e = TSE3.exp(T(tau6))
    assert np.allclose(g.R, e.R, atol=1e-6)
    assert np.allclose(g.t, e.t, atol=1e-6)
    assert np.allclose(g.s, 1.0, atol=1e-6)


def test_sim3_W_taylor_branch():
    """theta^2, sigma^2 < 1e-8 take the double-Taylor branch of _sim3_W; in
    float64 its first-order coefficients match the series of the closed
    forms A = 1/2 + s/3 + s^2/8 + ..., B = 1/6 + s/8 + s^2/20 + ..."""
    th = 9e-5
    w = T([th, 0.0, 0.0], torch.float64)
    for s in (1e-5, -1e-5, 9e-5, -9e-5):
        W = tlg._sim3_W(w, T(s, torch.float64)).numpy()
        assert W.dtype == np.float64
        A = W[2, 1] / th
        B = (W[0, 0] - W[1, 1]) / th ** 2
        assert abs(A - (0.5 + s / 3.0 + s * s / 8.0)) < 1e-8, (s, A)
        assert abs(B - (1.0 / 6.0 + s / 8.0 + s * s / 20.0)) < 5e-8, (s, B)


# ---------------------------------------------------------------------------
# utils/velocity.py

def test_quat_integrate_rk4():
    rng = np.random.default_rng(1)
    for _ in range(8):
        q = rng.normal(size=4).astype(np.float32)
        q /= np.linalg.norm(q)
        om = rng.normal(size=3).astype(np.float32)
        for dt in (0.01, 0.2):
            got = tvel.quat_integrate_rk4(T(q), T(om), dt)
            close(got, jvel.quat_integrate_rk4(jnp.asarray(q),
                                               jnp.asarray(om), dt))
            assert abs(float(torch.linalg.vector_norm(got)) - 1.0) < 1e-5


def test_velo_integration():
    rng = np.random.default_rng(2)
    for _ in range(8):
        tau = (rng.normal(size=6) * 0.3).astype(np.float32)
        velo = rng.normal(size=6).astype(np.float32)
        Tt = TSE3.exp(T(tau))
        Tj = JSE3.exp(jnp.asarray(tau))
        got = tvel.velo_integration(Tt, T(velo), 0.05)
        want = jvel.velo_integration(Tj, jnp.asarray(velo), 0.05)
        close(got.R, want.R)
        close(got.t, want.t)
    # zero velocity leaves the pose where it is
    still = tvel.velo_integration(Tt, torch.zeros(6), 0.05)
    close(still.R, Tt.R)
    close(still.t, Tt.t)


def test_twist_from_relative():
    rng = np.random.default_rng(3)
    for dt in (0.05, 0.0):
        a = (rng.normal(size=6) * 0.2).astype(np.float32)
        b = (rng.normal(size=6) * 0.2).astype(np.float32)
        got = tvel.twist_from_relative(TSE3.exp(T(a)), TSE3.exp(T(b)), dt)
        want = jvel.twist_from_relative(JSE3.exp(jnp.asarray(a)),
                                        JSE3.exp(jnp.asarray(b)), dt)
        # compared as tau = twist * dt (dt = 0 takes the 1e-9 guard)
        close(got.numpy() * max(dt, 1e-9), np.asarray(want) * max(dt, 1e-9))
    # a twist integrated over dt and recovered gives it back (small dt)
    v = np.array([0.1, -0.2, 0.05, 0.3, -0.1, 0.2], np.float32)
    T0 = TSE3.exp(T(a))
    T1 = T0.compose(TSE3.exp(T(v) * 0.01))
    assert np.allclose(tvel.twist_from_relative(T0, T1, 0.01), v, atol=1e-3)
