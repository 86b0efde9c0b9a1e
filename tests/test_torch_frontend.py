"""Parity of the port's frame front-end with the JAX package on the CPU:
KLT, the coarse tracker, immature tracing and activation, the distance map
and the eight-point bootstrap. Frames come from the JAX package's own
``SyntheticSequence`` (128x96) and are handed to both sides as numpy.

Tolerances: coarse-tracker pose <= 1e-4 with the same ``ok``; immature
intervals relative <= 1e-3 with equal status; KLT <= 1e-3 px; RANSAC with
shared picks: E equal up to sign/scale within 1e-4, inliers equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.ops import coarse_tracker as jct
from slam_eds_tpu.ops import distance_map as jdm
from slam_eds_tpu.ops import immature as jim
from slam_eds_tpu.ops import initializer as jin
from slam_eds_tpu.ops import pixel_selector as jps
from slam_eds_tpu.utils import cameras as jcam
from slam_eds_tpu.utils import image as jimage
from slam_eds_tpu.utils import klt as jklt
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.ops import coarse_tracker as tct
from slam_eds_tpu_torch.ops import distance_map as tdm
from slam_eds_tpu_torch.ops import immature as tim
from slam_eds_tpu_torch.ops import initializer as tin
from slam_eds_tpu_torch.utils import cameras as tcam
from slam_eds_tpu_torch.utils import klt as tklt
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3

torch.set_num_threads(1)

W, H = 128, 96
JCAM = jcam.Pinhole(jnp.float32(110.0), jnp.float32(110.0),
                    jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = tcam.Pinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)


def T(a):
    return torch.as_tensor(np.array(a))


def N(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


@pytest.fixture(scope="module")
def scene():
    seq = SyntheticSequence(JCAM, num_frames=14, events_per_packet=1024,
                            motion_scale=0.35)
    frames = [seq.frame(k) for k in (0, 2, 3)]
    poses = [seq.pose(k) for k in (0, 2, 3)]
    return frames, poses


def _pyr(img, n):
    return [np.asarray(l) for l in jimage.build_pyramid(jnp.asarray(img), n)[0]]


def _points(img, n=256):
    gx, gy = jimage.sobel(jnp.asarray(img), 3)
    uv, mask = jps.candidate_points_grid(jimage.gradient_magnitude(gx, gy),
                                         patch=6, capacity=n)
    return np.asarray(uv), np.asarray(mask)


def _rel_pose(poses, a, b):
    """T_ba = T_b o T_a^-1 (camera a -> camera b) as numpy (R, t)."""
    Tr = poses[b].compose(poses[a].inverse())
    return np.asarray(Tr.R), np.asarray(Tr.t)


def test_klt_pyramid_parity(scene):
    (_, img0, _), (_, img1, _), _ = scene[0]
    uv0, mask = _points(img0)
    p0 = [l[..., 0] for l in _pyr(img0, 3)]
    p1 = [l[..., 0] for l in _pyr(img1, 3)]
    uj, okj, rj = jklt.klt_track_pyramid([jnp.asarray(a) for a in p0],
                                         [jnp.asarray(a) for a in p1],
                                         jnp.asarray(uv0))
    ut, okt, rt = tklt.klt_track_pyramid([T(a) for a in p0], [T(a) for a in p1],
                                         T(uv0))
    okj = np.asarray(okj) & mask
    np.testing.assert_array_equal(N(okt) & mask, okj)
    assert okj.sum() > 100
    np.testing.assert_allclose(N(ut)[okj], np.asarray(uj)[okj], atol=1e-3,
                               rtol=0)


def _templates(scene):
    (_, img0, depth0) = scene[0][0]
    uv, mask = _points(img0, 400)
    iy = np.clip(np.round(uv[:, 1]).astype(int), 0, H - 1)
    ix = np.clip(np.round(uv[:, 0]).astype(int), 0, W - 1)
    idp = (1.0 / np.asarray(depth0)[iy, ix]).astype(np.float32)
    pyr = _pyr(img0, 4)
    caps = (1024, 512, 256, 128)
    tj = jct.build_template(jnp.asarray(uv), jnp.asarray(idp),
                            jnp.ones(len(idp), jnp.float32),
                            jnp.asarray(mask), [jnp.asarray(l) for l in pyr],
                            caps)
    tt = tct.build_template(T(uv), T(idp), torch.ones(len(idp)), T(mask),
                            [T(l) for l in pyr], caps)
    return tj, tt


def test_build_template_parity(scene):
    tj, tt = _templates(scene)
    for a, b in zip(tj, tt):
        assert int(np.asarray(a.mask).sum()) > 20
        for f in ("u", "v", "mask"):
            np.testing.assert_array_equal(N(getattr(b, f)),
                                          np.asarray(getattr(a, f)))
        m = np.asarray(a.mask)
        for f in ("idepth", "color"):
            np.testing.assert_allclose(N(getattr(b, f))[m],
                                       np.asarray(getattr(a, f))[m],
                                       rtol=1e-5, atol=1e-5)
    # numpy round trip of the containers
    back = tct.template_from_numpy(tct.template_to_numpy(tt[0]),
                                   device="cpu")
    assert torch.equal(back.u, tt[0].u)


@pytest.mark.parametrize("target", [1, 2])
def test_track_newest_coarse_parity(scene, target):
    tj, _ = _templates(scene)
    # both sides get the JAX templates, so this isolates the LM solve
    tt = [tct.template_from_numpy({f: np.asarray(getattr(t, f))
                                   for f in t._fields}, device="cpu")
          for t in tj]
    img = scene[0][target][1]
    pyr = _pyr(img, 4)
    L = 4
    iters = (10, 20, 30, 30)
    abort = np.full(L, 1e9, np.float32)
    rj = jct.track_newest_coarse(
        tj, [jnp.asarray(l) for l in pyr],
        [JCAM.pyramid_level(l) for l in range(L)], JSE3.identity(),
        jnp.zeros(2, jnp.float32), (jnp.float32(1.0), jnp.float32(1.0)),
        jnp.zeros(2, jnp.float32), jnp.asarray(abort), max_iterations=iters)
    rt = tct.track_newest_coarse(
        tt, [T(l) for l in pyr], [TCAM.pyramid_level(l) for l in range(L)],
        TSE3.identity(device="cpu"), torch.zeros(2), (torch.tensor(1.0), torch.tensor(1.0)),
        torch.zeros(2), T(abort), max_iterations=iters)
    assert bool(rt.ok) == bool(rj.ok)
    assert bool(rj.ok)
    np.testing.assert_allclose(N(rt.pose.R), np.asarray(rj.pose.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.pose.t), np.asarray(rj.pose.t), atol=1e-4)
    np.testing.assert_allclose(N(rt.aff), np.asarray(rj.aff), atol=1e-4)
    np.testing.assert_allclose(N(rt.residuals), np.asarray(rj.residuals),
                               rtol=1e-3, atol=1e-4)
    # the recovered motion is the true one (up to the template's depth scale)
    R_true, t_true = _rel_pose(scene[1], 0, target)
    assert np.abs(N(rt.pose.R) - R_true).max() < 5e-3


def _immature_pair(scene):
    (_, img0, depth0) = scene[0][0]
    pyr0 = _pyr(img0, 3)
    abs_sq = [np.sum(l[..., 1:3] ** 2, -1) for l in pyr0]
    st, _, _ = jps.make_maps(jnp.asarray(pyr0[0]),
                             [jnp.asarray(a) for a in abs_sq], density=300.0)
    uv, _, mask = jps.status_to_points(st, jnp.asarray(abs_sq[0]), 384)
    uv, mask = np.asarray(uv), np.asarray(mask)
    pj = jim.make_immature(jnp.asarray(pyr0[0]), jnp.asarray(uv),
                           jnp.asarray(mask))
    pt = tim.make_immature(T(pyr0[0]), T(uv), T(mask))
    return pj, pt


def _KRKi_Kt(scene, a, b):
    R, t = _rel_pose(scene[1], a, b)
    K = np.asarray(JCAM.K, np.float64)
    return ((K @ R @ np.linalg.inv(K)).astype(np.float32),
            (K @ t).astype(np.float32))


def test_trace_on_parity(scene):
    pj, pt = _immature_pair(scene)
    for f in ("color", "weights", "gradH"):
        np.testing.assert_allclose(N(getattr(pt, f)), np.asarray(getattr(pj, f)),
                                   rtol=1e-5, atol=1e-3)
    aff = np.array([1.0, 0.0], np.float32)
    for target in (1, 2):          # first trace (inf interval), then refine
        KRKi, Kt = _KRKi_Kt(scene, 0, target)
        tgt = _pyr(scene[0][target][1], 1)[0]
        pj = jim.trace_on(pj, jnp.asarray(tgt), jnp.asarray(KRKi),
                          jnp.asarray(Kt), jnp.asarray(aff), W, H)
        pt = tim.trace_on(pt, T(tgt), T(KRKi), T(Kt), T(aff), W, H)
        sj = np.asarray(pj.status)
        np.testing.assert_array_equal(N(pt.status), sj)
        good = sj == jim.IPS_GOOD
        assert good.sum() > 50
        for f in ("idepth_min", "idepth_max"):
            a, b = np.asarray(getattr(pj, f))[good], N(getattr(pt, f))[good]
            r = np.abs(b - a) / np.abs(a)
            # the interval ends come from (pr_z*c - pr_a) / (Kt_a - Kt_z*c),
            # which cancels badly on short baselines: there the JAX f32
            # result itself is up to 0.4% off a float64 evaluation, so a few
            # points may exceed 1e-3 by that conditioning alone
            assert np.mean(r <= 1e-3) >= 0.95, (f, np.sort(r)[-8:])
            assert r.max() <= 5e-3, (f, r.max())
        # hand the JAX state over so each step is compared from equal inputs
        pt = tim.from_numpy({f: np.asarray(getattr(pj, f))
                             for f in pj._fields}, device="cpu")


def test_activate_idepth_parity(scene):
    pj, pt = _immature_pair(scene)
    KRKi, Kt = _KRKi_Kt(scene, 0, 1)
    tgt = _pyr(scene[0][1][1], 1)[0]
    pj = jim.trace_on(pj, jnp.asarray(tgt), jnp.asarray(KRKi), jnp.asarray(Kt),
                      jnp.asarray([1.0, 0.0], jnp.float32), W, H)
    pts = tim.from_numpy({f: np.asarray(getattr(pj, f)) for f in pj._fields},
                         device="cpu")
    imgs = np.stack([_pyr(scene[0][k][1], 1)[0] for k in range(3)])
    KR = np.stack([_KRKi_Kt(scene, 0, k)[0] for k in range(3)])
    Kts = np.stack([_KRKi_Kt(scene, 0, k)[1] for k in range(3)])
    affs = np.tile(np.array([1.0, 0.0], np.float32), (3, 1))
    tmask = np.array([False, True, True])
    ij, ej = jim.activate_idepth(pj, jnp.asarray(imgs), jnp.asarray(KR),
                                 jnp.asarray(Kts), jnp.asarray(affs),
                                 jnp.asarray(tmask))
    it, et = tim.activate_idepth(pts, T(imgs), T(KR), T(Kts), T(affs),
                                 T(tmask))
    good = np.asarray(pj.status) == jim.IPS_GOOD
    np.testing.assert_allclose(N(it)[good], np.asarray(ij)[good], rtol=1e-3)
    # the slot-batched form equals the unbatched one per slot
    stack = tim.ImmaturePoints(*(torch.stack([x, x]) for x in pts))
    ib, _ = tim.activate_idepth(stack, T(imgs), T(KR)[None].repeat(2, 1, 1, 1),
                                T(Kts)[None].repeat(2, 1, 1),
                                T(affs)[None].repeat(2, 1, 1),
                                T(tmask)[None].repeat(2, 1))
    np.testing.assert_array_equal(N(ib[1]), N(it))


def test_distance_map_exact(rng):
    uv = rng.uniform(-3, 70, (200, 2)).astype(np.float32)
    mask = rng.uniform(size=200) > 0.4
    a = jdm.coarse_distance_map(jnp.asarray(uv), jnp.asarray(mask), 48, 64)
    b = tdm.coarse_distance_map(T(uv), T(mask), 48, 64)
    np.testing.assert_array_equal(N(b), np.asarray(a))


def _correspondences(rng, n=200, outliers=40):
    R, t = np.asarray(JSE3.exp(jnp.asarray(
        [0.3, -0.1, 0.05, 0.02, -0.04, 0.03], jnp.float32)).R), \
        np.array([0.3, -0.1, 0.05])
    X = np.stack([rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
                  rng.uniform(2, 4, n)], -1)
    X2 = X @ R.T + t
    x1 = X[:, :2] / X[:, 2:]
    x2 = X2[:, :2] / X2[:, 2:] + rng.normal(0, 1e-4, (n, 2))
    # outliers pushed off their epipolar lines, well past the Sampson
    # threshold: every clean hypothesis then finds the same inlier set,
    # whichever one wins the argmax
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
    lines = np.concatenate([x1, np.ones((n, 1))], -1) @ (tx @ R).T
    normal = lines[:, :2] / np.linalg.norm(lines[:, :2], axis=1,
                                           keepdims=True)
    sign = np.where(rng.uniform(size=(n, 1)) < 0.5, -1.0, 1.0)
    x2[:outliers] += (sign * rng.uniform(0.05, 0.15, (n, 1))
                      * normal)[:outliers]
    mask = np.ones(n, bool)
    mask[-10:] = False
    return x1.astype(np.float32), x2.astype(np.float32), mask


def _jax_picks(mask, num_hypotheses=128):
    """The draw ransac_essential makes with seed 0."""
    logits = jnp.where(jnp.asarray(mask), 0.0, -1e9)
    picks = jax.random.categorical(
        jax.random.PRNGKey(0),
        logits[None, :].repeat(num_hypotheses * 8, 0), axis=-1)
    return np.asarray(picks.reshape(num_hypotheses, 8))


def _same_up_to_sign(a, b, tol):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return min(np.abs(a - b).max(), np.abs(a + b).max()) <= tol


def test_ransac_shared_picks_parity(rng):
    x1, x2, mask = _correspondences(rng)
    picks = _jax_picks(mask)
    Ej, inj, nj = jin.ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                       jnp.asarray(mask), jnp.asarray(0))
    Et, int_, nt = tin.ransac_essential(T(x1), T(x2), T(mask), picks=T(picks))
    assert _same_up_to_sign(N(Et), np.asarray(Ej), 1e-4)
    np.testing.assert_array_equal(N(int_), np.asarray(inj))
    assert int(nt) == int(nj) >= 120
    # the batched eight-point agrees hypothesis by hypothesis where the
    # hypothesis is well posed (8 distinct correspondences; a repeated pick
    # leaves a 2-D null space whose basis vector is solver-dependent)
    distinct = np.array([len(set(p)) == 8 for p in picks])
    Es_t = N(tin.eight_point(T(x1)[T(picks)], T(x2)[T(picks)]))
    Es_j = np.asarray(jax.vmap(lambda i: jin.eight_point(
        jnp.asarray(x1)[i], jnp.asarray(x2)[i]))(jnp.asarray(picks)))
    assert distinct.sum() > 100
    for a, b in zip(Es_j[distinct], Es_t[distinct]):
        assert _same_up_to_sign(b, a, 1e-3)


def test_bootstrap_eight_point_shared_picks(rng):
    x1, x2, mask = _correspondences(rng)
    picks = _jax_picks(mask)
    rj = jin.bootstrap_eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                   jnp.asarray(mask))
    rt = tin.bootstrap_eight_point(T(x1), T(x2), T(mask), picks=T(picks))
    assert bool(rt.success) == bool(rj.success)
    np.testing.assert_array_equal(N(rt.inliers), np.asarray(rj.inliers))
    np.testing.assert_allclose(N(rt.T_21.R), np.asarray(rj.T_21.R), atol=1e-4)
    np.testing.assert_allclose(N(rt.T_21.t), np.asarray(rj.T_21.t), atol=1e-4)
    good = np.asarray(rj.inliers)
    np.testing.assert_allclose(N(rt.idepth)[good], np.asarray(rj.idepth)[good],
                               rtol=1e-3)
    # a generator draw (not the JAX bits) still recovers the same geometry
    g = torch.Generator().manual_seed(0)
    rg = tin.bootstrap_eight_point(T(x1), T(x2), T(mask), generator=g)
    assert bool(rg.success)
    np.testing.assert_allclose(N(rg.T_21.R), np.asarray(rj.T_21.R), atol=5e-3)


def _so3(R):
    """(largest |R R^T - I|, trace(R R^T - I) / 3) in float64: how far R
    is from SO(3), and whether it stretches (> 0) or shrinks."""
    R = np.asarray(R, np.float64)
    M = R @ R.T - np.eye(3)
    return float(np.abs(M).max()), float(np.trace(M)) / 3


@pytest.mark.parametrize("eps", [0.0, 1e-6, -1e-6, 1e-5, -1e-5])
@pytest.mark.parametrize("target", [1, 2])
def test_coarse_track_departure_from_so3(scene, target, eps):
    """The step where the runner cell's rotations first leave SO(3) faster
    in the port than in JAX (``tools/so3_drift_bisect.py``: the coarse
    tracker's result on frame 2). Both packages compose each accepted LM
    increment as ``SE3.exp(inc).compose(pose)``, in float32; from the same
    templates, frame and initial pose, here one carrying a seeded symmetric
    departure ``eps`` (0, as the pipeline's first tracks, up to 1e-5, as
    its tenth frame), the results leave SO(3) by amounts within 5 float32
    eps of each other and stretch or shrink alike (the trace's gap within
    4 eps): over 70 seeded runs of this test at these sizes the gaps were
    at most 4.7 and 3.3 eps, 0.3 and 0.4 on average (the port's larger),
    where an LM adds 0 to 4 eps of departure."""
    tj, _ = _templates(scene)
    tt = [tct.template_from_numpy({f: np.asarray(getattr(t, f))
                                   for f in t._fields}, device="cpu")
          for t in tj]
    pyr = _pyr(scene[0][target][1], 4)
    L, iters = 4, (10, 20, 30, 30)
    abort = np.full(L, 1e9, np.float32)
    rng = np.random.default_rng(target * 10 + int(round(eps * 1e6)) + 50)
    S = rng.standard_normal((3, 3))
    S = (S + S.T) / 2
    R0 = (np.eye(3) + eps * S / np.abs(S).max()).astype(np.float32)
    t0 = np.zeros(3, np.float32)
    rj = jct.track_newest_coarse(
        tj, [jnp.asarray(l) for l in pyr],
        [JCAM.pyramid_level(l) for l in range(L)],
        JSE3(jnp.asarray(R0), jnp.asarray(t0)), jnp.zeros(2, jnp.float32),
        (jnp.float32(1.0), jnp.float32(1.0)), jnp.zeros(2, jnp.float32),
        jnp.asarray(abort), max_iterations=iters)
    rt = tct.track_newest_coarse(
        tt, [T(l) for l in pyr], [TCAM.pyramid_level(l) for l in range(L)],
        TSE3(T(R0), T(t0)), torch.zeros(2),
        (torch.tensor(1.0), torch.tensor(1.0)), torch.zeros(2), T(abort),
        max_iterations=iters)
    assert bool(rt.ok) and bool(rj.ok)
    ulp = float(np.finfo(np.float32).eps)
    dj, gj = _so3(rj.pose.R)
    dt, gt = _so3(N(rt.pose.R))
    assert abs(dt - dj) <= 5 * ulp, (dt, dj)
    assert abs(gt - gj) <= 4 * ulp, (gt, gj)
