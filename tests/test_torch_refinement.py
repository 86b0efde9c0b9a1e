"""The port's track refinement against the JAX package on the CPU: the same
seeded numpy inputs go through both.

* ``utils/klt``: every patch measure, ``extract_patches``,
  ``search_along_epiline``, ``match_template``, ``fundamental_from_pose``,
  ``epiline_directions``: values within 1e-5 (relative, float32 sums of
  49-tap patches); matched positions within 1e-5 px on textured images,
  where the best candidate is unique. On an all-zero event frame every
  candidate ties: both packages then take the lowest index.
* ``_klt_flow_from_patches``: the flow ``delta`` within 1e-4 relative (the
  intermediate eigenvectors are not compared: a rank-1 structure tensor,
  the common case on a sparse splat, sits on the knife-edge between the two
  eigenvector formulas and on the ``lam2 > 1e-3 lam1`` gate, where the two
  packages may pick different but equivalent branches).
* ``refine_tracks_klt`` (1 and 3 levels), ``_model_klt``, ``_epiline`` on
  the worlds of ``test_event_tracker.py``: increments within 2e-4 px, masks
  equal.
* One ``_event_packet_fused`` step per mode from the JAX pipeline's warm
  state (5 finest-level LM iterations, as in ``test_torch_eds_pipeline``:
  beyond that the LM's float32 path splits at this size): tracks within
  2e-3 px, the mask equal but for at most 1 point in 512 (a point whose
  ssd/ncc disagreement or activity sits on its threshold), the depth mean
  within 1e-3.
* The whole 14-frame ``EDSPipeline`` loop with ``model_klt``: the JAX
  test's own bounds, and counts within one of the JAX run's.
"""
import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models import pipeline as jpl
from slam_eds_tpu.ops import event_tracker as jet
from slam_eds_tpu.utils import klt as jklt
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole
from slam_eds_tpu.utils.lie import SE3 as JSE3

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.models import keyframe as tkf
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.ops.kernels.rasterize import \
    rasterize_bilinear_reference
from slam_eds_tpu_torch.utils import klt as tklt
from slam_eds_tpu_torch.utils.alignment import ate_rmse
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3
from torch_guard import count_host_reads

torch.set_num_threads(1)

W, H = 128, 96
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
MEASURES = ("ssd", "nssd", "zssd", "sad", "zsad", "ncc", "zncc")
MODES = ("klt", "klt_pyr", "model_klt", "epiline")


def _t(a):
    return torch.as_tensor(np.array(a))


def _texture(seed, scale=1.0):
    """A smooth random image: no two candidate patches score alike."""
    rng = np.random.default_rng(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float64)
    img = sum(a * np.sin(fx * xs + fy * ys + ph) for a, fx, fy, ph in
              rng.uniform([5, 0.1, 0.1, 0], [40, 0.9, 0.9, 6], (8, 4)))
    return (scale * img).astype(np.float32)


def _points(seed, n=48, margin=16.0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(margin, W - margin, n),
                     rng.uniform(margin, H - margin, n)],
                    -1).astype(np.float32)


# ---------------------------------------------------------------------------
# utils/klt
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure", MEASURES)
def test_patch_measures(measure):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(6, 5, 49)).astype(np.float32)
    b = (a + 0.3 * rng.normal(size=a.shape)).astype(np.float32)
    want = np.asarray(getattr(jklt, measure)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tklt, measure)(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_extract_patches():
    img, uv = _texture(1), _points(2)
    want = np.asarray(jklt.extract_patches(jnp.asarray(img), jnp.asarray(uv), 3))
    got = tklt.extract_patches(_t(img), _t(uv), 3).numpy()
    assert got.shape == (len(uv), 49)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("measure", MEASURES)
def test_search_along_epiline(measure):
    ref, uv = _texture(3), _points(4)
    new = np.roll(ref, 2, axis=1)                     # truth: +2 px in x
    rng = np.random.default_rng(6)
    ang = rng.uniform(-0.3, 0.3, len(uv))
    d = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    want_uv, want_s = jklt.search_along_epiline(
        jnp.asarray(ref), jnp.asarray(new), jnp.asarray(uv), jnp.asarray(d),
        jnp.float32(4.0), radius=3, num_steps=25, measure=measure)
    got_uv, got_s = tklt.search_along_epiline(
        _t(ref), _t(new), _t(uv), _t(d), 4.0, radius=3, num_steps=25,
        measure=measure)
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-4,
                               atol=1e-4)


@pytest.mark.parametrize("measure", ("zssd", "zncc"))
def test_search_ties_go_to_the_lowest_index(measure):
    """A zero event frame scores every candidate alike: the first one (the
    far negative end of the segment) wins in both packages, with a separate
    template centre as ``refine_tracks_epiline`` passes it."""
    ref, uv = _texture(7), _points(8)
    new = np.zeros_like(ref)
    d = np.tile(np.float32([[1.0, 0.0]]), (len(uv), 1))
    tpl_uv = uv + np.float32([1.5, -0.5])
    want_uv, want_s = jklt.search_along_epiline(
        jnp.asarray(ref), jnp.asarray(new), jnp.asarray(uv), jnp.asarray(d),
        jnp.float32(6.0), radius=3, num_steps=25, measure=measure,
        uv_tpl=jnp.asarray(tpl_uv))
    got_uv, got_s = tklt.search_along_epiline(
        _t(ref), _t(new), _t(uv), _t(d), 6.0, radius=3, num_steps=25,
        measure=measure, uv_tpl=_t(tpl_uv))
    np.testing.assert_allclose(got_uv.numpy(), uv + np.float32([-6.0, 0.0]),
                               atol=1e-5)
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("measure", ("zncc", "ssd", "zsad"))
def test_match_template(measure):
    ref, uv = _texture(9), _points(10, n=24, margin=20.0)
    new = np.roll(np.roll(ref, 3, axis=1), -2, axis=0)
    want_uv, want_s = jklt.match_template(
        jnp.asarray(ref), jnp.asarray(new), jnp.asarray(uv), radius=3,
        search_radius=5, measure=measure)
    got_uv, got_s = tklt.match_template(_t(ref), _t(new), _t(uv), radius=3,
                                        search_radius=5, measure=measure)
    np.testing.assert_allclose(got_uv.numpy(), np.asarray(want_uv), atol=1e-5)
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s), rtol=2e-4,
                               atol=1e-4)
    if measure == "zncc":
        # integer-pixel shift, float coordinates: the true match is found
        # to within the half-pixel the candidates are spaced by
        err = np.abs(got_uv.numpy() - (uv + np.float32([3.0, -2.0])))
        assert err.max() <= 0.5 + 1e-4


def test_fundamental_and_epiline_directions():
    tau = np.float32([0.05, -0.02, 0.01, 0.01, -0.02, 0.005])
    uv = _points(11)
    Fj = jklt.fundamental_from_pose(JSE3.exp(jnp.asarray(tau)), JCAM.K)
    Ft = tklt.fundamental_from_pose(TSE3.exp(_t(tau)), TCAM.K(device="cpu"))
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), rtol=1e-4,
                               atol=1e-9)
    dj = jklt.epiline_directions(Fj, jnp.asarray(uv))
    dt = tklt.epiline_directions(Ft, _t(uv))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=1e-4)


# ---------------------------------------------------------------------------
# the refinement functions of ops/event_tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ("full_rank", "single_point"))
def test_klt_flow_from_patches(kind):
    """``delta`` against JAX; see the module docstring on what is not
    compared. A single splatted point gives gx_p proportional to gy_p: the
    rank-1 case."""
    rng = np.random.default_rng(12)
    n = 64
    ev = rng.normal(size=(n, 49)).astype(np.float32)
    if kind == "full_rank":
        gx = rng.normal(size=(n, 49)).astype(np.float32) * 20
        gy = rng.normal(size=(n, 49)).astype(np.float32) * 20
    else:
        w = rng.uniform(0, 1, (n, 49)).astype(np.float32)
        g = rng.normal(size=(n, 2)).astype(np.float32) * 20
        gx, gy = w * g[:, :1], w * g[:, 1:]
    fj, okj = jet._klt_flow_from_patches(*(jnp.asarray(a)
                                           for a in (gx, gy, ev)))
    ft, okt = tet._klt_flow_from_patches(_t(gx), _t(gy), _t(ev))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-4,
                               atol=1e-6)


def _refinement_scene(seed, n=64, f_true_px=0.7):
    """``test_event_tracker._refinement_scene``: the event frame is the
    splat of each point's brightness change -grad.f_true at its true
    position; the predicted warp is short of the truth by f_true."""
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.linspace(14, W - 14, 8), np.linspace(14, H - 14, 8))
    uv_true = np.stack([gx.ravel(), gy.ravel()], -1)[:n].astype(np.float32)
    uv_true += rng.uniform(-2, 2, uv_true.shape).astype(np.float32)
    grad = rng.normal(size=(n, 2)).astype(np.float32) * 30
    f_true = grad / np.linalg.norm(grad, axis=-1, keepdims=True) * f_true_px
    dl = -(grad[:, 0] * f_true[:, 0] + grad[:, 1] * f_true[:, 1])
    ev = rasterize_bilinear_reference(_t(uv_true[:, 0].copy()),
                                      _t(uv_true[:, 1].copy()),
                                      _t(dl.astype(np.float32)), H, W).numpy()
    mask = np.ones(n, bool)
    mask[::9] = False
    return ev, (uv_true - f_true).astype(np.float32), uv_true, grad, mask


@pytest.mark.parametrize("levels", (1, 3))
def test_refine_tracks_klt(levels):
    ev, uv_warp, uv_true, grad, mask = _refinement_scene(13)
    dj, okj = jet.refine_tracks_klt(
        jnp.asarray(ev), jnp.asarray(uv_warp), jnp.asarray(grad),
        jnp.asarray(mask), patch_radius=3, num_levels=levels)
    dt, okt = tet.refine_tracks_klt(_t(ev), _t(uv_warp), _t(grad), _t(mask),
                                    patch_radius=3, num_levels=levels)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-4)
    assert (dt.numpy()[~mask] == 0).all()
    if levels == 1:
        ok = okt.numpy()
        before = np.linalg.norm(uv_warp - uv_true, axis=-1)[ok].mean()
        after = np.linalg.norm(uv_warp + dt.numpy() - uv_true,
                               axis=-1)[ok].mean()
        assert after < 0.4 * before


def test_refine_tracks_model_klt():
    ev, uv_warp, _, grad, mask = _refinement_scene(14)
    rng = np.random.default_rng(15)
    model = rng.normal(size=len(mask)).astype(np.float32)
    model /= np.linalg.norm(model)
    dj, okj = jet.refine_tracks_model_klt(
        jnp.asarray(ev), jnp.asarray(uv_warp), jnp.asarray(model),
        jnp.asarray(mask), patch_radius=3)
    dt, okt = tet.refine_tracks_model_klt(_t(ev), _t(uv_warp), _t(model),
                                          _t(mask), patch_radius=3)
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), atol=2e-4)


def test_refine_tracks_epiline():
    """The world of ``test_refine_tracks_epiline_consistency_gate``."""
    rng = np.random.default_rng(16)
    n = 32
    gx, gy = np.meshgrid(np.linspace(16, W - 16, 8), np.linspace(16, H - 16, 4))
    kf_uv = np.stack([gx.ravel(), gy.ravel()], -1)[:n].astype(np.float32)
    model = rng.normal(size=n).astype(np.float32)
    model /= np.linalg.norm(model)
    uv_true = kf_uv + np.float32([2.0, 0.0])
    ev = rasterize_bilinear_reference(_t(uv_true[:, 0].copy()),
                                      _t(uv_true[:, 1].copy()), _t(model),
                                      H, W).numpy()
    tau = np.float32([0.05, 0, 0, 0, 0, 0])
    mask = np.ones(n, bool)
    mask[5] = False
    uj, aj = jet.refine_tracks_epiline(
        jnp.asarray(ev), jnp.asarray(kf_uv), jnp.asarray(kf_uv),
        jnp.asarray(model), jnp.asarray(mask), JSE3.exp(jnp.asarray(tau)),
        JCAM, patch_radius=3, search_range=4.0, num_steps=33)
    ut, at = tet.refine_tracks_epiline(
        _t(ev), _t(kf_uv), _t(kf_uv), _t(model), _t(mask),
        TSE3.exp(_t(tau)), TCAM, patch_radius=3, search_range=4.0,
        num_steps=33)
    np.testing.assert_array_equal(at.numpy(), np.asarray(aj))
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-4)
    a = at.numpy()
    assert a.sum() >= 0.8 * n and not a[5]
    assert np.linalg.norm(ut.numpy()[a] - uv_true[a], axis=-1).mean() < 0.75


# ---------------------------------------------------------------------------
# the packet step and the whole loop
# ---------------------------------------------------------------------------

N_FRAMES = 14
CFG = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 8192},
    "tracker": {"max_iterations": [15, 10], "kf_flow_threshold": 1.0},
}


def _cfg(mode):
    return dict(CFG, tracker=dict(CFG["tracker"], track_refinement=mode))


def _np_dict(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


@pytest.fixture(scope="module")
def sequence():
    seq = SyntheticSequence(JCAM, num_frames=N_FRAMES, events_per_packet=8192,
                            motion_scale=0.35)
    frames = [(t, np.array(img))
              for t, img in (seq.frame(k)[:2] for k in range(N_FRAMES))]
    packets = [seq.events_between(k, k + 1) for k in range(N_FRAMES - 1)]
    ev_gt = [np.asarray(seq.pose_at(k + 0.5).inverse().t)
             for k in range(N_FRAMES - 1)]
    return frames, packets, seq.gt_positions(), ev_gt


@pytest.fixture(scope="module")
def warm_state(sequence):
    """The JAX pipeline's inputs to the fused step at its first warm packet
    (the one after the first usable solve), without refinement: the state a
    refinement mode first acts on."""
    frames, packets, _, _ = sequence
    jp = jpl.EDSPipeline(JCAM, jload(CFG))
    for k, (t, img) in enumerate(frames[:-1]):
        jp.process_frame(jnp.asarray(img), t)
        if jp.kf is None:
            continue
        if jp.telemetry.counters.get("event_solves", 0):
            return dict(tracker=jp.tracker_state, pf=jp.pose_filter,
                        depth=jp.depth, kf=jp.kf,
                        pred=jp.frame_pipe._last_pose,
                        loss_scale=jp.loss_scale, packet=packets[k])
        jp.process_events(packets[k])
    pytest.fail("the JAX pipeline made no usable solve")


@pytest.mark.parametrize("mode", MODES)
def test_one_packet_step_per_mode(warm_state, mode):
    inp, iters = warm_state, [5, 10]
    kf, pred, pk = inp["kf"], inp["pred"], inp["packet"]
    jlim, _, jstat = jpl.EDSPipeline(JCAM, jload(_cfg(mode))) \
        ._packet_step_args()
    assert jstat["refinement"] == mode
    jout = jpl._event_packet_fused(
        inp["tracker"], inp["pf"], inp["depth"], JCAM,
        kf.pose.R, kf.pose.t, pred.R, pred.t,
        kf.uv, kf.norm_coord, kf.grad, kf.idepth, kf.weight, kf.mask,
        *(jnp.asarray(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
        jnp.asarray(pk.n_valid), None, jnp.asarray(iters, jnp.int32),
        jnp.float32(inp["loss_scale"]), jlim, **jstat)

    tkfr = tkf.from_numpy(_np_dict(kf), device="cpu")
    tlim, _, tstat = tpl.EDSPipeline(TCAM, load_config(_cfg(mode)),
                                     device="cpu")._packet_step_args()
    assert tstat == {k: (v if not hasattr(v, "item") else v.item())
                     for k, v in jstat.items()}
    assert tlim == pytest.approx({k: float(v) for k, v in jlim.items()})
    args = (
        tet.state_from_numpy(_np_dict(inp["tracker"]), device="cpu"),
        tet.pose_filter_from_numpy(_np_dict(inp["pf"]), device="cpu"),
        tdf.from_numpy(_np_dict(inp["depth"]), device="cpu"), TCAM,
        tkfr.T_w_kf_R, tkfr.T_w_kf_t, _t(pred.R), _t(pred.t),
        tkfr.uv, tkfr.norm_coord, tkfr.grad, tkfr.idepth, tkfr.weight,
        tkfr.mask,
        *(torch.as_tensor(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
        int(pk.n_valid), None, iters, inp["loss_scale"], tlim)
    with count_host_reads() as reads:
        tout, rungs = tpl._event_packet_fused(*args, **tstat)
    # the refinement adds no host read to the step: the first rung passed
    # the gate; run eagerly, one read of the verdict (the retry's host
    # ``if``) and one of its scalar vector, none in the LM
    assert rungs == 1
    assert reads.by_method == {"__bool__": 1, "cpu": 1}
    jsc, sc = np.asarray(jout[6]), tout[6].numpy()
    assert sc[0] == jsc[0] == 1.0 and sc[3] == jsc[3]
    jmask, mask = np.asarray(jout[3]), tout[3].numpy()
    same = jmask == mask
    assert (~same).sum() <= 1, (~same).sum()
    assert abs(sc[5] - jsc[5]) <= 1
    both = jmask & mask & np.asarray(kf.mask)
    np.testing.assert_allclose(tout[4].numpy()[both], np.asarray(jout[4])[both],
                               atol=2e-3)
    np.testing.assert_allclose(tout[2].mu.numpy()[both],
                               np.asarray(jout[2].mu)[both], rtol=1e-3,
                               atol=1e-5)
    # the refinement moved the tracks off the plain warp
    plain = tet.warp_coords(tout[0], TCAM, tkfr.norm_coord, tkfr.idepth,
                            tkfr.mask)[0] - tkfr.uv
    moved = (tout[4] - plain)[torch.as_tensor(both)].abs().max()
    assert float(moved) > 1e-3, mode


@pytest.fixture(scope="module")
def loops(sequence):
    """The 14-frame loop with ``model_klt`` through both packages."""
    frames, packets, gt, ev_gt = sequence
    out = {}
    for name, pipe, conv in (
            ("jax", jpl.EDSPipeline(JCAM, jload(_cfg("model_klt"))),
             jnp.asarray),
            ("port", tpl.EDSPipeline(TCAM, load_config(_cfg("model_klt")),
                                     device="cpu"), lambda a: a)):
        ev_pos, ev_ref = [], []
        for k, (t, img) in enumerate(frames):
            pipe.process_frame(conv(img), t)
            if k + 1 < N_FRAMES and pipe.kf is not None:
                T = pipe.process_events(packets[k])
                if T is not None:
                    ev_pos.append(np.asarray(T.inverse().t))
                    ev_ref.append(ev_gt[k])
        out[name] = (pipe, ev_pos, ev_ref)
    return out, gt


def test_whole_loop_with_model_klt(loops):
    (out, gt) = loops
    pipe, ev_pos, ev_ref = out["port"]
    jpipe, jev_pos, _ = out["jax"]
    assert pipe.frame_pipe._initialized and pipe.frame_pipe._resets == 0
    assert len(ev_pos) >= 3
    assert float(ate_rmse(np.stack(ev_pos), np.stack(ev_ref))) < 0.12
    est = pipe.frame_pipe.positions()
    assert np.isfinite(est).all()
    assert float(ate_rmse(est, gt[:len(est)])) < 0.05
    # counts within one of the JAX run's
    assert abs(len(ev_pos) - len(jev_pos)) <= 1
    assert abs(pipe.num_event_kfs - jpipe.num_event_kfs) <= 1
    assert abs(pipe.frame_pipe.window.next_id
               - jpipe.frame_pipe.window.next_id) <= 1
    assert dataclasses.asdict(pipe.cfg) == dataclasses.asdict(jpipe.cfg)
