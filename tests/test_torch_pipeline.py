"""The port's frame-only slice end to end against the JAX package on the
CPU, on the setup of ``test_pipeline.py`` (128x96, the small config, 14
frames of ``SyntheticSequence``). The JAX-rendered frames go to both
pipelines, and the port's RANSAC is handed the picks the JAX pipeline draws
(``jax.random`` with seed 0), so both sides consume the same random numbers.

Two port runs are held against the one JAX run:

* the whole slice from the first frame: both bootstrap on the same frame;
  the port's ATE < 0.05 (the JAX slice's own bound); the RMS of the
  port-vs-JAX camera-position difference <= 0.01. The keyframe counts may
  differ by one: the bootstrap's inputs and inlier sets agree, but a few
  inlier rays are so near parallel that their float32 midpoint
  triangulation is rounding noise in both packages. That moves the
  mean-idepth gauge by about 1% and the later keyframe decisions with it;
  ``test_bootstrap_gauge_split_is_float32_rounding`` proves it in float64;
* the frame path from the JAX window right after the bootstrap (converted
  with the numpy converters): the same keyframe, marginalization and
  BA-run sequence frame by frame, positions within 1e-3 RMS.
"""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models.pipeline import FrameOnlyPipeline as JPipe
from slam_eds_tpu.ops import initializer as jin
from slam_eds_tpu.utils.alignment import ate_rmse as j_ate
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.models import ba_state as tbs
from slam_eds_tpu_torch.models.pipeline import FrameOnlyPipeline as TPipe
from slam_eds_tpu_torch.ops import coarse_tracker as tct
from slam_eds_tpu_torch.ops import immature as tim
from slam_eds_tpu_torch.ops import initializer as tin
from slam_eds_tpu_torch.utils.alignment import ate_rmse as t_ate
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from slam_eds_tpu_torch.utils.lie import SE3 as TSE3

torch.set_num_threads(1)

W, H = 128, 96
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
CFG = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 8192},
    "tracker": {"max_iterations": [15, 10]},
}


def _jax_picks(mask, num_hypotheses, generator=None):
    """The picks slam_eds_tpu's ransac_essential draws with seed 0."""
    logits = jnp.where(jnp.asarray(mask.cpu().numpy()), 0.0, -1e9)
    picks = jax.random.categorical(
        jax.random.PRNGKey(0),
        logits[None, :].repeat(num_hypotheses * 8, 0), axis=-1)
    return torch.as_tensor(np.array(picks).reshape(num_hypotheses, 8))


def _trace(pipe):
    return (pipe._initialized, pipe.window.next_id, pipe.window.marg_count,
            pipe.telemetry.counters.get("ba_runs", 0))


def _t(a):
    return torch.as_tensor(np.array(a))


def _se3(T):
    return TSE3(_t(T.R), _t(T.t))


def _port_from_jax(jp):
    """A port pipeline holding the JAX pipeline's exact window and tracking
    state (every array copied through numpy)."""
    tp = TPipe(TCAM, load_config(CFG), device="cpu")
    jw, w = jp.window, tp.window
    d = {k: np.asarray(v) for k, v in jw.state._asdict().items()
         if k != "T_eval"}
    d["T_eval.R"], d["T_eval.t"] = jw.state.T_eval.R, jw.state.T_eval.t
    w.state = tbs.from_numpy(d, device="cpu")
    w.images = _t(jw.images)
    w.intensity = w.images[..., 0].contiguous()
    w.pyramids = [None if p is None else [_t(l) for l in p]
                  for p in jw.pyramids]
    w.immatures = [None if p is None else tim.from_numpy(
        {f: np.asarray(getattr(p, f)) for f in p._fields}, device="cpu")
        for p in jw.immatures]
    w.coarse_templates = [tct.template_from_numpy(
        {f: np.asarray(getattr(t, f)) for f in t._fields}, device="cpu")
        for t in jw.coarse_templates]
    w.frame_ids, w.frame_times = list(jw.frame_ids), list(jw.frame_times)
    w.next_id, w.newest_slot = jw.next_id, jw.newest_slot
    w.marg_count = jw.marg_count
    for a in ("_last_pose", "_last_good_pose", "_motion", "_world_anchor"):
        setattr(tp, a, _se3(getattr(jp, a)))
    for a in ("_initialized", "_frames_since_kf", "_lost", "_lost_frames",
              "_last_rms", "_first_rms", "_resets"):
        setattr(tp, a, getattr(jp, a))
    tp.trajectory = [np.asarray(x) for x in jp.trajectory]
    tp.times = list(jp.times)
    tp.telemetry.counters.update(jp.telemetry.counters)
    return tp


@pytest.fixture(scope="module")
def runs():
    from slam_eds_tpu.config import load_config as jload
    seq = SyntheticSequence(JCAM, num_frames=14, events_per_packet=1024,
                            motion_scale=0.35)
    frames = [(t, np.array(img))
              for t, img in (seq.frame(k)[:2] for k in range(14))]
    boots = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jin, "bootstrap_eight_point",
                   _recorded(jin.bootstrap_eight_point, boots["jax"]))
        jp = JPipe(JCAM, jload(CFG))
        jtrace, shared, start = [], None, None
        for k, (t, img) in enumerate(frames):
            jp.process_frame(jnp.asarray(img), t)
            jtrace.append(_trace(jp))
            if shared is None and jp._initialized:
                shared, start = _port_from_jax(jp), k + 1
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tin, "sample_picks", _jax_picks)
        mp.setattr(tin, "bootstrap_eight_point",
                   _recorded(tin.bootstrap_eight_point, boots["port"]))
        tp = TPipe(TCAM, load_config(CFG), device="cpu")
        ttrace = []
        for t, img in frames:
            tp.process_frame(img, t)
            ttrace.append(_trace(tp))
    strace = []
    for t, img in frames[start:]:
        shared.process_frame(img, t)
        strace.append(_trace(shared))
    return dict(seq=seq, jp=jp, jtrace=jtrace, tp=tp, ttrace=ttrace,
                shared=shared, strace=strace, start=start, boots=boots)


def _recorded(fn, calls):
    """``fn`` that appends (correspondences as numpy, result) per call."""
    def wrapper(nc1, nc2, mask, *args, **kwargs):
        res = fn(nc1, nc2, mask, *args, **kwargs)
        calls.append(([np.asarray(x) for x in (nc1, nc2, mask)], res))
        return res
    return wrapper


def _triangulated_idepth_f64(x1, x2, R, t):
    """``triangulate_midpoint`` + idepth in float64; also returns the
    normal-equation determinant relative to ``a11 * a22``."""
    x1, x2, R, t = (np.asarray(a, np.float64) for a in (x1, x2, R, t))
    d1 = np.concatenate([x1, np.ones((len(x1), 1))], -1)
    d2 = np.concatenate([x2, np.ones((len(x2), 1))], -1) @ R
    c2 = -(R.T @ t)
    a11, a22 = np.sum(d1 * d1, -1), np.sum(d2 * d2, -1)
    a12 = -np.sum(d1 * d2, -1)
    b1, b2 = d1 @ c2, -(d2 @ c2)
    det = a11 * a22 - a12 * a12
    s = (a22 * b1 - a12 * b2) / det
    X1z = 0.5 * (d1[:, 2] * s + d2[:, 2] * (a11 * b2 - a12 * b1) / det
                 + c2[2])
    return 1.0 / X1z, det / (a11 * a22)


def test_same_bootstrap_and_keyframes(runs):
    jtrace, ttrace, tp = runs["jtrace"], runs["ttrace"], runs["tp"]
    boot_j = [i for i, s in enumerate(jtrace) if s[0]][0]
    boot_t = [i for i, s in enumerate(ttrace) if s[0]][0]
    assert boot_t == boot_j
    assert ttrace[boot_t] == jtrace[boot_j]
    assert jtrace[-1][1] >= 4
    assert abs(ttrace[-1][1] - jtrace[-1][1]) <= 1
    assert tp.telemetry.counters.get("full_resets", 0) == 0


def test_bootstrap_gauge_split_is_float32_rounding(runs):
    """The bootstrap's inputs agree, its inlier sets are identical, and in
    float64 both packages' inputs give the same gauge (mean inlier idepth)
    within 1e-4; the float32 gauges split by up to a few percent because
    the idepth that splits most belongs to rays so near parallel that the
    triangulation's determinant is within a few float32 ulps of zero."""
    (jin_, jres), (tin_, tres) = runs["boots"]["jax"][-1], \
        runs["boots"]["port"][-1]
    for a, b in zip(jin_[:2], tin_[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    assert np.array_equal(jin_[2], tin_[2])
    good = np.asarray(jres.inliers)
    assert np.array_equal(good, tres.inliers.numpy()) and good.sum() > 100

    # the scaled translation is gauge x the unit one recover_pose returns
    gauges, idepths, rel_dets = {}, {}, {}
    for side, (x, res) in (("jax", (jin_, jres)), ("port", (tin_, tres))):
        t = np.asarray(res.T_21.t, np.float64)
        g32 = np.linalg.norm(t)
        idp, rel_dets[side] = _triangulated_idepth_f64(
            x[0], x[1], np.asarray(res.T_21.R), t / g32)
        gauges[side] = (g32, float(np.mean(idp[good])))
        idepths[side] = np.asarray(res.idepth)
    assert abs(gauges["port"][1] / gauges["jax"][1] - 1) < 1e-4
    for g32, g64 in gauges.values():
        assert abs(g32 / g64 - 1) < 0.05
    worst = int(np.argmax(np.abs(idepths["jax"] - idepths["port"]) * good))
    for rel_det in rel_dets.values():
        assert rel_det[worst] < 8 * np.finfo(np.float32).eps, rel_det[worst]


def test_frame_path_matches_from_shared_bootstrap(runs):
    start, jp, shared = runs["start"], runs["jp"], runs["shared"]
    assert runs["strace"] == runs["jtrace"][start:]
    assert runs["jtrace"][-1][2] >= 2          # frames were marginalized
    est_s, est_j = shared.positions(), jp.positions()
    assert est_s.shape == est_j.shape
    rms = float(np.sqrt(np.mean(np.sum((est_s - est_j) ** 2, 1))))
    assert rms <= 1e-3, rms


def test_port_ate_and_trajectory_match(runs):
    seq, jp, tp = runs["seq"], runs["jp"], runs["tp"]
    est_t, est_j = tp.positions(), jp.positions()
    gt = seq.gt_positions()
    assert len(est_t) == len(est_j) == seq.num_frames
    ate = float(t_ate(est_t, gt))
    assert ate < 0.05, ate
    assert abs(ate - float(j_ate(jnp.asarray(est_j), jnp.asarray(gt)))) < 0.01
    rms = float(np.sqrt(np.mean(np.sum((est_t - est_j) ** 2, 1))))
    assert rms <= 0.01, rms


def test_window_state_stays_on_device_and_finite(runs):
    tp = runs["tp"]
    st = tp.window.state
    for name, v in tp.window.state._asdict().items():
        tensors = (v.R, v.t) if name == "T_eval" else (v,)
        for x in tensors:
            assert x.device == tp.device
            if x.is_floating_point():
                assert torch.isfinite(x).all(), name
    assert int((st.p_status == 1).sum()) > 50


@pytest.mark.parametrize("change", [
    {"tracker": {"bootstrap": "dso"}},
    {"tracker": {"bootstrap": "midas"}},
])
def test_unported_bootstraps_raise(change):
    """Both bootstraps are ported now (``test_torch_coarse_init.py`` runs
    them against JAX): the option constructs a pipeline and no longer
    raises; a name that is no bootstrap raises ``ValueError``."""
    pipe = TPipe(TCAM, load_config(change), device="cpu")
    assert pipe.cfg.tracker.bootstrap == change["tracker"]["bootstrap"]
    bad = {"tracker": {"bootstrap": change["tracker"]["bootstrap"] + "x"}}
    with pytest.raises(ValueError):
        TPipe(TCAM, load_config(bad), device="cpu")


def test_photometric_and_depth_map_raise():
    """A photometric calib no longer raises (the window weights its pixel
    selection by the calib's response-derivative table; see
    ``test_torch_calib.py``), and neither does an external depth map: the
    ``eight_points`` bootstrap ignores it, as in the JAX package, and the
    ``midas`` bootstrap starts from it on the first frame."""
    from slam_eds_tpu_torch.utils.calib import PhotometricCalib
    calib = PhotometricCalib.from_files(np.arange(256, dtype=np.float64))
    pipe = TPipe(TCAM, load_config(CFG), device="cpu", photometric=calib)
    np.testing.assert_array_equal(pipe.window.photometric_bgrad,
                                  calib.b_grad_table())
    pipe.process_frame(np.zeros((H, W), np.float32), 0.0,
                       depth_map=np.ones((H, W), np.float32))
    assert not pipe._initialized


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        TPipe(TCAM, load_config(CFG), device="cuda")


AUDIT = """
import importlib, os, sys, tempfile
import numpy as np
native = os.path.join(os.getcwd(), "native") + os.sep
seen = []

def hook(event, args):
    if event in ("open", "ctypes.dlopen", "os.listdir", "os.scandir",
                 "subprocess.Popen") and args and isinstance(
                     args[0], (str, bytes, os.PathLike)):
        seen.append(os.path.abspath(os.fsdecode(args[0])))

sys.addaudithook(hook)
for m in ("slam_eds_tpu_torch.models.pipeline", "slam_eds_tpu_torch.runner",
          "slam_eds_tpu_torch.io.dataset", "slam_eds_tpu_torch.utils.alignment",
          "slam_eds_tpu_torch.utils.calib", "slam_eds_tpu_torch.io.recorder",
          "slam_eds_tpu_torch.ops.coarse_init", "slam_eds_tpu_torch.checkpoint",
          "slam_eds_tpu_torch.eval", "slam_eds_tpu_torch.io.output_maps",
          "slam_eds_tpu_torch.utils.viz", "slam_eds_tpu_torch.utils.klt",
          "slam_eds_tpu_torch.telemetry", "slam_eds_tpu_torch.parallel",
          "slam_eds_tpu_torch.parallel.sharded_ba",
          "slam_eds_tpu_torch.parallel.sharded_event_tracker",
          "slam_eds_tpu_torch.parallel.dryrun",
          "slam_eds_tpu_torch.utils.velocity",
          "slam_eds_tpu_torch.utils.lie_groups"):
    importlib.import_module(m)
from slam_eds_tpu_torch.io import event_buffer as eb, frame_loader as fl
from slam_eds_tpu_torch.io import image_rw
eb.available() and fl.available()
with tempfile.TemporaryDirectory() as d:
    image_rw.write_png(os.path.join(d, "a.png"), np.zeros((4, 5), np.uint8))
    image_rw.read_png(os.path.join(d, "a.png"))
    eb.make_ring(16).push([1.0], [2.0], [0.5], [1.0])
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "slam_eds_tpu", "yaml"))
bad += [p for p in seen if p.startswith(native)]
print(bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_yaml():
    """The port's modules, the runner and its I/O included, import no JAX,
    nothing of the JAX package and no PyYAML; and building and using the
    host runtime, a ring and a PNG opens, lists, runs or loads nothing
    under ``native/`` (the port builds its own copy into ``_build``)."""
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", AUDIT], cwd=root,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_config_asdict_equal_after_load():
    from slam_eds_tpu.config import load_config as jload
    assert dataclasses.asdict(load_config(CFG)) == dataclasses.asdict(
        jload(CFG))
