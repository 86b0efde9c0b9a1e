"""Parity of the port's event tracker, depth filter and event keyframe with
the JAX package on the CPU, on the world of ``test_event_tracker.py``
(96x128, P = 256 points, a smooth synthetic event frame whose minimum is a
known pose and velocity). Inputs are made with numpy from a seed and fed to
both sides.

Tolerances: element-wise functions 1e-5; residuals and Jacobians rtol 1e-4,
atol 1e-5 (the model norm and m^T A are reductions over all points, summed
in another order); the LM result 1e-4 on pose and velocity with the same
iteration count; the depth filter rtol 1e-5; keyframe masks and pixel
coordinates identical, values 1e-5.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.models import keyframe as jkf
from slam_eds_tpu.ops import depth_filter as jdf
from slam_eds_tpu.ops import event_tracker as jet
from slam_eds_tpu.utils import interp as jinterp
from slam_eds_tpu.utils import lie as jlie
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.models import keyframe as tkf
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.utils import interp as tinterp
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3
from torch_guard import no_host_reads

torch.set_num_threads(1)

H, W = 96, 128
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def close(a, b, rtol=1e-5, atol=1e-5, msg=""):
    np.testing.assert_allclose(N(a), N(b), rtol=rtol, atol=atol, err_msg=msg)


def _smooth_field(x, y):
    return (0.10 * np.sin(0.15 * x) * np.cos(0.12 * y)
            + 0.05 * np.sin(0.05 * x + 0.07 * y))


@pytest.fixture(scope="module")
def world():
    """Points, a smooth event frame and gradients making (T_true, v_true) the
    cost's minimum (the construction of test_event_tracker.py, in numpy)."""
    rng = np.random.default_rng(7)
    n = 256
    uv = np.stack([rng.uniform(15, W - 15, n), rng.uniform(15, H - 15, n)], -1)
    nc = np.stack([(uv[:, 0] - (W / 2 - 0.5)) / 110.0,
                   (uv[:, 1] - (H / 2 - 0.5)) / 110.0], -1)
    idp = rng.uniform(0.4, 0.7, n)
    vx = np.array([0.3, 0.1, -0.2, 0.05, -0.03, 0.08])
    vx /= np.linalg.norm(vx)
    tau = np.array([0.015, -0.01, 0.008, 0.003, 0.002, -0.004], np.float32)
    Tt = JSE3.exp(jnp.asarray(tau))
    R, t = np.asarray(Tt.R, np.float64), np.asarray(Tt.t, np.float64)
    z = 1.0 / (idp + 1e-5)
    p = np.stack([nc[:, 0] * z, nc[:, 1] * z, z], -1) @ R.T + t
    xp = 110.0 * p[:, 0] / p[:, 2] + (W / 2 - 0.5)
    yp = 110.0 * p[:, 1] / p[:, 2] + (H / 2 - 0.5)
    c = _smooth_field(xp, yp)
    cn = np.linalg.norm(c)
    ys, xs = np.mgrid[0:H, 0:W]
    img = _smooth_field(xs, ys) / cn
    flow = np.asarray(jet.compute_flow(jnp.asarray(nc, jnp.float32),
                                       jnp.asarray(vx, jnp.float32),
                                       jnp.asarray(idp, jnp.float32)),
                      np.float64)
    f2 = np.maximum(np.sum(flow * flow, -1), 1e-8)
    grad = -(100.0 * (c / cn) / f2)[:, None] * flow
    mask = np.ones(n, bool)
    mask[::17] = False
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(uv=f32(uv), nc=f32(nc), idp=f32(idp), vx=f32(vx), tau=tau,
                img=f32(img), grad=f32(grad), mask=mask,
                weights=f32(rng.uniform(0.5, 1.0, n)))


def _states(w, tau, vx):
    """The same tracker state on both sides (pose from tangent ``tau``)."""
    Tj = JSE3.exp(jnp.asarray(np.asarray(tau, np.float32)))
    q = jlie.mat_to_quat(Tj.R)
    js = jet.TrackerState(px=Tj.t, qx=q, vx=jnp.asarray(vx))
    return js, tet.state_from_numpy({k: np.asarray(v) for k, v in
                                     js._asdict().items()}, device="cpu")


def _args(w, side):
    keys = ("nc", "grad", "idp", "weights", "mask")
    conv = jnp.asarray if side == "jax" else T
    return [conv(w[k]) for k in keys]


def test_compute_flow_and_interaction_matrix(world):
    w = world
    close(tet.compute_flow(T(w["nc"]), T(w["vx"]), T(w["idp"])),
          jet.compute_flow(jnp.asarray(w["nc"]), jnp.asarray(w["vx"]),
                           jnp.asarray(w["idp"])), rtol=1e-6, atol=1e-7)
    close(tet.interaction_matrix(T(w["nc"]), T(w["idp"])),
          jet.interaction_matrix(jnp.asarray(w["nc"]), jnp.asarray(w["idp"])),
          rtol=1e-6, atol=1e-7)


def test_bicubic_with_grad(world):
    rng = np.random.default_rng(3)
    img = world["img"]
    x = rng.uniform(-6, W + 6, 600).astype(np.float32)
    y = rng.uniform(-6, H + 6, 600).astype(np.float32)
    x[:8] = [0, W - 1, W - 2, 1.5, np.nan, np.inf, 5.0, -np.inf]
    y[:8] = [0, H - 1, 0.25, H - 1.5, 3.0, 2.0, np.nan, 1.0]
    want = jinterp.bicubic_with_grad(jnp.asarray(img), jnp.asarray(x),
                                     jnp.asarray(y))
    got = tinterp.bicubic_with_grad(T(img), T(x), T(y))
    for name, g, j in zip(("f", "dfdx", "dfdy"), got, want):
        g, j = N(g), np.asarray(j)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(j), err_msg=name)
        assert np.isnan(g).sum() == 4     # the four non-finite queries
        close(g, j, rtol=0, atol=1e-5, msg=name)
    close(tinterp.bicubic(T(img), T(x), T(y)), want[0], rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm_event", [False, True])
def test_event_residuals_and_jac(world, norm_event):
    w = world
    tau = w["tau"] * 0.6
    js, ts = _states(w, tau, w["vx"])
    img = w["img"] if not norm_event else w["img"] * 37.0
    jr, jJ = jet.event_residuals_and_jac(js, jnp.asarray(img), JCAM,
                                         *_args(w, "jax"),
                                         norm_event=norm_event)
    tr_, tJ = tet.event_residuals_and_jac(ts, T(img), TCAM, *_args(w, "torch"),
                                          norm_event=norm_event)
    close(tr_, jr, rtol=1e-4, atol=1e-5, msg="r")
    close(tJ, jJ, rtol=1e-4, atol=1e-5 * float(np.abs(jJ).max()), msg="J")
    assert np.all(N(tJ)[~w["mask"]] == 0) and np.all(N(tr_)[~w["mask"]] == 0)
    close(tet.event_residuals(ts, T(img), TCAM, *_args(w, "torch"),
                              norm_event=norm_event),
          jet.event_residuals(js, jnp.asarray(img), JCAM, *_args(w, "jax"),
                              norm_event=norm_event),
          rtol=1e-4, atol=1e-5, msg="residuals")


@pytest.mark.parametrize("iters", [[3, 2], [15, 10]])
def test_optimize_pyramid(world, iters):
    """Coarse-to-fine solve. With caps of [3, 2] every iteration moves the
    energy far above the stopping tolerance, so both sides run the same
    iterations and the states after them are compared step for step. With
    [15, 10] both converge; the iteration at which an accepted step first
    moves the float32 energy by less than 1e-6 (a few ulp) is decided by
    rounding -- JAX's own jitted and eager loops stop at different
    iterations on this world -- so there the counts are held to the caps
    and the converged states to 1e-4."""
    w = world
    levels = np.stack([w["img"], 0.9 * w["img"] + 0.001])
    js, ts = _states(w, np.zeros(6), w["vx"])
    jr = jet.optimize_pyramid(js, jnp.asarray(levels), JCAM, *_args(w, "jax"),
                              iterations_per_level=iters, loss_kind="huber",
                              loss_scale=0.2)
    tr_ = tet._pyramid_fused(ts, T(levels), TCAM, *_args(w, "torch"),
                             iters, "huber", 0.2, False)
    # the LM reads nothing back to the host: the same solve under the guard
    frames, args = T(levels), _args(w, "torch")
    with no_host_reads():
        again = tet._pyramid_fused(ts, frames, TCAM, *args, iters, "huber",
                                   0.2, False)
    assert torch.equal(again.state.px, tr_.state.px)
    if iters[0] <= 3:
        assert int(tr_.n_iter) == int(jr.n_iter) == iters[0]
    else:
        assert 1 <= int(tr_.n_iter) <= iters[0]
        assert 1 <= int(jr.n_iter) <= iters[0]
    for name in ("px", "qx", "vx"):
        close(getattr(tr_.state, name), getattr(jr.state, name), rtol=0,
              atol=1e-4, msg=name)
    close(tr_.energy, jr.energy, rtol=1e-3, atol=1e-7)
    close(tr_.loss_scale, jr.loss_scale, rtol=1e-3, atol=1e-7)
    # the public entry is the same solve
    tp = tet.optimize_pyramid(ts, T(levels), TCAM, *_args(w, "torch"),
                              iterations_per_level=iters)
    close(tp.state.px, tr_.state.px, rtol=0, atol=0)


def test_optimize_single_level_recovers_pose(world):
    w = world
    js, ts = _states(w, np.zeros(6), w["vx"])
    jr = jet.optimize(js, jnp.asarray(w["img"]), JCAM, *_args(w, "jax"),
                      max_iterations=30, loss_kind="none")
    tr_ = tet.optimize(ts, T(w["img"]), TCAM, *_args(w, "torch"),
                       max_iterations=30, loss_kind="none")
    # both stop well before the cap (see test_optimize_pyramid on the count)
    assert int(tr_.n_iter) < 30 and int(jr.n_iter) < 30
    close(tr_.state.px, jr.state.px, rtol=0, atol=1e-4)
    err = np.linalg.norm(N(TSE3(tet.lie.quat_to_mat(tr_.state.qx),
                                tr_.state.px).log()) - w["tau"])
    assert err < 2e-3


def test_pose_filter_warp_and_flow(world):
    w = world
    rng = np.random.default_rng(4)
    jf = jet.pose_filter_init(3)
    tf = tet.pose_filter_init(3, "cpu")
    for k in range(5):
        tau = rng.uniform(-0.05, 0.05, 6).astype(np.float32)
        jf = jet.pose_filter_push(jf, JSE3.exp(jnp.asarray(tau)))
        tf = tet.pose_filter_push(tf, TSE3.exp(T(tau)))
        for name in ("taus", "count", "head"):
            close(getattr(tf, name), getattr(jf, name), rtol=0, atol=1e-6)
        jm, tm = jet.pose_filter_mean(jf), tet.pose_filter_mean(tf)
        close(tm.R, jm.R, rtol=0, atol=1e-6)
        close(tm.t, jm.t, rtol=0, atol=1e-6)
    back = tet.pose_filter_from_numpy(tet.pose_filter_to_numpy(tf),
                                      device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, tf))

    js, ts = _states(w, w["tau"] * 30.0, w["vx"])   # some points leave
    juv, jal = jet.warp_coords(js, JCAM, jnp.asarray(w["nc"]),
                               jnp.asarray(w["idp"]), jnp.asarray(w["mask"]))
    tuv, tal = tet.warp_coords(ts, TCAM, T(w["nc"]), T(w["idp"]),
                               T(w["mask"]))
    close(tuv, juv, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(N(tal), np.asarray(jal))
    assert 0 < N(tal).sum() < w["mask"].sum()
    close(tet.mean_flow_magnitude(tuv, T(w["uv"]), tal),
          jet.mean_flow_magnitude(juv, jnp.asarray(w["uv"]), jal), rtol=1e-5)
    jk = jet.pose_kf_ef(js)
    tk = tet.pose_kf_ef(ts)
    close(tk.R, jk.R, rtol=0, atol=1e-6)
    close(tk.t, jk.t, rtol=0, atol=1e-6)


def test_initial_tracker_state():
    j = jet.initial_tracker_state()
    t = tet.initial_tracker_state("cpu")
    for a, b in zip(t, j):
        close(a, b, rtol=0, atol=1e-7)


# ------------------------------------------------------------- depth filter
def _backproject_project(rng, n, tau):
    uv_kf = np.stack([rng.uniform(20, 100, n), rng.uniform(20, 76, n)], -1)
    idp = rng.uniform(0.3, 0.8, n)
    Tt = JSE3.exp(jnp.asarray(np.asarray(tau, np.float32)))
    X = np.stack([(uv_kf[:, 0] - 63.5) / 120.0, (uv_kf[:, 1] - 47.5) / 120.0,
                  np.ones(n)], -1) / idp[:, None]
    Rinv = np.asarray(Tt.R, np.float64).T
    Xe = (X - np.asarray(Tt.t, np.float64)) @ Rinv.T
    uv_ef = np.stack([120.0 * Xe[:, 0] / Xe[:, 2] + 63.5,
                      120.0 * Xe[:, 1] / Xe[:, 2] + 47.5], -1)
    return (np.asarray(uv_kf, np.float32), np.asarray(uv_ef, np.float32),
            np.asarray(idp, np.float32), Tt)


DCAM_J = JPinhole(jnp.float32(120.0), jnp.float32(120.0), jnp.float32(63.5),
                  jnp.float32(47.5), 128, 96)
DCAM_T = TPinhole(120.0, 120.0, 63.5, 47.5, 128, 96)


def test_triangulate_and_tau():
    rng = np.random.default_rng(8)
    uv_kf, uv_ef, idp, Tt = _backproject_project(
        rng, 64, [0.08, -0.03, 0.02, 0.01, 0.02, -0.01])
    Tp = TSE3(T(Tt.R), T(Tt.t))
    j = jdf.triangulate_inv_depth(jnp.asarray(uv_kf), jnp.asarray(uv_ef),
                                  DCAM_J, Tt)
    t = tdf.triangulate_inv_depth(T(uv_kf), T(uv_ef), DCAM_T, Tp)
    close(t, j, rtol=1e-5, atol=1e-6)
    close(t, idp, rtol=1e-3, atol=0)
    xn = np.stack([(uv_ef[:, 0] - 63.5) / 120.0,
                   (uv_ef[:, 1] - 47.5) / 120.0], -1).astype(np.float32)
    z = (1.0 / idp).astype(np.float32)
    ang_j = jdf.angle_error(3.0, DCAM_J.fx, DCAM_J.fy)
    ang_t = tdf.angle_error(3.0, 120.0, 120.0)
    close(ang_t, ang_j, rtol=1e-6, atol=0)
    close(tdf.compute_tau(Tp, T(xn), T(z), ang_t),
          jdf.compute_tau(Tt, jnp.asarray(xn), jnp.asarray(z), ang_j),
          rtol=1e-4, atol=1e-6)


def _jstate(s):
    return jdf.DepthFilterState(*(jnp.asarray(N(x)) for x in s))


def test_vogiatzis_update_and_guards():
    rng = np.random.default_rng(9)
    n = 96
    ts = tdf.init_uniform(n, 0.5, 4.0, device="cpu")
    js = jdf.init_uniform(n, 0.5, 4.0)
    for a, b in zip(ts, js):
        close(a, b, rtol=1e-7, atol=0)
    for _ in range(6):
        z = (0.7 * (1 + 0.05 * rng.normal(size=n))).astype(np.float32)
        z[::11] = rng.uniform(0.25, 2.0, len(z[::11]))
        tau2 = rng.uniform(0.001, 0.02, n).astype(np.float32)
        mask = rng.uniform(size=n) < 0.9
        js = jdf.vogiatzis_update(js, jnp.asarray(z), jnp.asarray(tau2), 3.5,
                                  jnp.asarray(mask))
        ts = tdf.vogiatzis_update(ts, T(z), T(tau2), 3.5, T(mask))
        for name, a, b in zip(js._fields, ts, js):
            close(a, b, rtol=1e-5, atol=1e-7, msg=name)
    # the guard cases of test_depth_filter.py: absurd measurements
    st = tdf.DepthFilterState(T([0.5, 0.5]), T([0.01, 0.01]), T([2.0, 2.0]),
                              T([5.0, 5.0]))
    st = tdf.DepthFilterState(*(x.float() for x in st))
    z = np.array([-5.0, np.nan], np.float32)
    tau2 = np.array([1e-9, 0.01], np.float32)
    out = tdf.vogiatzis_update(st, T(z), T(tau2), 3.5, T([True, True]))
    jout = jdf.vogiatzis_update(_jstate(st), jnp.asarray(z),
                                jnp.asarray(tau2), 3.5,
                                jnp.asarray([True, True]))
    for a, b in zip(out, jout):
        assert np.isfinite(N(a)).all()
        close(a, b, rtol=1e-5, atol=0)
    back = tdf.from_numpy(tdf.to_numpy(out), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, out))


def test_depth_update():
    rng = np.random.default_rng(10)
    n = 96
    ts = tdf.init_from_prior(T(np.full(n, 0.5, np.float32)), 0.3, 5.0,
                             device="cpu")
    js = jdf.init_from_prior(jnp.full((n,), 0.5, jnp.float32), 0.3, 5.0)
    for k in range(4):
        tau = np.concatenate([rng.uniform(-0.15, 0.15, 3),
                              rng.uniform(-0.02, 0.02, 3)])
        uv_kf, uv_ef, _, Tt = _backproject_project(rng, n, tau)
        tracks = (uv_ef - uv_kf
                  + 0.3 * rng.normal(size=(n, 2))).astype(np.float32)
        mask = rng.uniform(size=n) < 0.9
        js = jdf.update(js, Tt, jnp.asarray(uv_kf), jnp.asarray(tracks),
                        DCAM_J, mu_range=4.7, mask=jnp.asarray(mask))
        ts = tdf.update(ts, TSE3(T(Tt.R), T(Tt.t)), T(uv_kf), T(tracks),
                        DCAM_T, mu_range=4.7, mask=T(mask))
        for name, a, b in zip(js._fields, ts, js):
            close(a, b, rtol=1e-4, atol=1e-6, msg=f"{name} step {k}")
    np.testing.assert_array_equal(
        N(tdf.converged(ts, 4.7, 100.0)),
        np.asarray(jdf.converged(js, 4.7, 100.0)))


# ----------------------------------------------------------------- keyframe
def _frame_640():
    from slam_eds_tpu.io.dataset import SyntheticSequence
    cam = JPinhole(jnp.float32(400.0), jnp.float32(400.0),
                   jnp.float32(319.5), jnp.float32(239.5), 640, 480)
    seq = SyntheticSequence(cam, num_frames=4, motion_scale=0.22)
    return np.asarray(seq.frame(2)[1])


@pytest.fixture(scope="module")
def keyframes():
    """A keyframe of a real 640x480 frame on both sides, without and with a
    sparse depth map."""
    img = _frame_640()
    rng = np.random.default_rng(12)
    m = 700
    dm = (np.stack([rng.uniform(0, 639, m), rng.uniform(0, 479, m)],
                   -1).astype(np.float32),
          rng.uniform(0.2, 2.0, m).astype(np.float32), rng.uniform(size=m) < 0.8)
    jcam = JPinhole(jnp.float32(400.0), jnp.float32(400.0),
                    jnp.float32(319.5), jnp.float32(239.5), 640, 480)
    tcam = TPinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
    Tw = rng.uniform(-0.1, 0.1, 6).astype(np.float32)
    out = {}
    for name, depth in (("const", None), ("map", dm)):
        j = jkf.create_keyframe(
            jnp.asarray(img), jcam, capacity=2048, percent_points=0.4,
            depth_map=None if depth is None else tuple(map(jnp.asarray,
                                                           depth)),
            init_depth=2.65, T_w_kf=JSE3.exp(jnp.asarray(Tw)), time=0.25)
        t = tkf.create_keyframe(
            img, tcam, capacity=2048, percent_points=0.4,
            depth_map=None if depth is None else tuple(map(T, depth)),
            init_depth=2.65, T_w_kf=TSE3.exp(T(Tw)), time=0.25, device="cpu")
        out[name] = (j, t)
    return out, tcam, jcam


@pytest.mark.parametrize("name", ["const", "map"])
def test_create_keyframe_640(keyframes, name):
    (j, t), _, _ = keyframes[0][name], None, None
    np.testing.assert_array_equal(N(t.mask), np.asarray(j.mask))
    np.testing.assert_array_equal(N(t.uv), np.asarray(j.uv))
    assert int(t.n_initial) == int(j.n_initial) > 500
    for f in ("img", "log_img", "grad_img", "norm_coord", "grad", "idepth",
              "weight", "T_w_kf_R", "T_w_kf_t", "time"):
        a, b = N(getattr(t, f)), np.asarray(getattr(j, f))
        close(a, b, rtol=1e-5, atol=1e-5 * max(1.0, np.abs(b).max()), msg=f)
    back = tkf.from_numpy(tkf.to_numpy(t), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(back, t))


def test_keyframe_point_ops(keyframes):
    (j, t), tcam, jcam = keyframes[0]["map"], keyframes[1], keyframes[2]
    jc, tc = jkf.clean_points(j, 0.7), tkf.clean_points(t, 0.7)
    np.testing.assert_array_equal(N(tc.mask), np.asarray(jc.mask))
    assert 0 < N(tc.mask).sum() < N(t.mask).sum()
    assert bool(tkf.need_new_kf(tc)) == bool(jkf.need_new_kf(jc))
    vx = np.array([0.3, 0.1, -0.2, 0.05, -0.03, 0.08], np.float32)
    vx /= np.linalg.norm(vx)
    close(tkf.sparse_model(tc, T(vx)), jkf.sparse_model(jc, jnp.asarray(vx)),
          rtol=1e-5, atol=1e-6)
    mi_t = tkf.model_image(tc, T(vx), 480, 640)
    mi_j = jkf.model_image(jc, jnp.asarray(vx), 480, 640)
    close(mi_t, mi_j, rtol=0, atol=1e-5)
    assert np.abs(N(mi_t)).sum() > 0
    ef = (N(mi_t) * 10.0).astype(np.float32)
    np.testing.assert_array_equal(
        N(tkf.points_refinement(tc, T(ef)).mask),
        np.asarray(jkf.points_refinement(jc, jnp.asarray(ef)).mask))
    uvw = N(tc.uv) + np.float32(40.0)
    np.testing.assert_array_equal(
        N(tkf.erase_out_of_frame(tc, T(uvw), tcam).mask),
        np.asarray(jkf.erase_out_of_frame(jc, jnp.asarray(uvw), jcam).mask))
    for a, b in zip(tkf.export_map(tc, tcam), jkf.export_map(jc, jcam)):
        close(a, b, rtol=1e-5, atol=1e-5)
    d = np.array([0.02, -0.3, 0.1, 0.04, 0.01, -0.02], np.float32)
    Tj, Tt = JSE3.exp(jnp.asarray(d)), TSE3.exp(T(d))
    assert bool(tkf.kf_selection_occlusion(Tt, 1.5)) == \
        bool(jkf.kf_selection_occlusion(Tj, 1.5))
    assert bool(tkf.kf_selection_rotation(Tt)) == \
        bool(jkf.kf_selection_rotation(Tj))
    assert bool(tkf.kf_selection_translation(Tt)) == \
        bool(jkf.kf_selection_translation(Tj))


def test_idepth_maps():
    rng = np.random.default_rng(13)
    depth = rng.uniform(0.5, 4.0, (48, 64)).astype(np.float32)
    depth[3, 5], depth[8, 8] = np.nan, -1.0
    for a, b in zip(tkf.idepth_map_from_depth_image(T(depth), max_depth=3.5),
                    jkf.idepth_map_from_depth_image(jnp.asarray(depth),
                                                    max_depth=3.5)):
        close(a, b, rtol=1e-6, atol=0)
    Xw = rng.uniform(-1, 1, (300, 3)).astype(np.float32) + [0, 0, 2.0]
    Xw = Xw.astype(np.float32)
    d = np.array([0.1, 0.0, -0.2, 0.02, 0.05, 0.0], np.float32)
    for a, b in zip(tkf.idepth_map_from_pointcloud(T(Xw), TSE3.exp(T(d)),
                                                   TCAM),
                    jkf.idepth_map_from_pointcloud(jnp.asarray(Xw),
                                                   JSE3.exp(jnp.asarray(d)),
                                                   JCAM)):
        close(a, b, rtol=1e-5, atol=1e-5)
