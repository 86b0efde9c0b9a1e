"""The port's event path (``EDSPipeline``) against the JAX package on the CPU,
on the setup of ``test_pipeline.py::test_eds_pipeline_full_loop`` (128x96,
the small config with ``kf_flow_threshold`` 1.0, 14 frames). The
JAX-rendered frames and the JAX-made event packets go to both sides.

* One packet step from the same state: the JAX pipeline's state at its
  first packet and at its first warm packet (after one usable solve),
  carried over with the numpy converters, goes through one
  ``_event_packet_fused`` on each side. The usable flags are equal, the
  scalars within rtol 1e-4 (the iteration count exactly), the tracker
  state, the mask and the depth filter's mean within 1e-4 (its variance
  and Beta counts within 2e-3, see the test). At this size the LM is still
  wandering when it reaches the configured cap, so the warm packet is
  compared at 5 finest-level iterations, and at the configured 15 on what
  does not depend on the LM's path.
* The whole loop: the port bootstraps, promotes at least 2 event
  keyframes, makes at least 4 usable solves, and its event ATE stays below
  0.12 and its frame ATE below 0.05 -- the JAX test's own bounds. The
  float32 bootstrap knife-edge of the frame slice (``test_torch_pipeline``)
  can move the keyframe cadence, so the counts are held to the bounds, not
  to equality with JAX.
"""
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models import pipeline as jpl
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.models import keyframe as tkf
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.ops.kernels import rasterize as tr
from slam_eds_tpu_torch.utils.alignment import ate_rmse
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole
from torch_guard import count_host_reads

torch.set_num_threads(1)

W, H = 128, 96
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
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


def _np_dict(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


@pytest.fixture(scope="module")
def sequence():
    seq = SyntheticSequence(JCAM, num_frames=N_FRAMES, events_per_packet=8192,
                            motion_scale=0.35)
    frames = [(t, np.array(img))
              for t, img in (seq.frame(k)[:2] for k in range(N_FRAMES))]
    packets = [seq.events_between(k, k + 1) for k in range(N_FRAMES - 1)]
    gt = seq.gt_positions()
    ev_gt = [np.asarray(seq.pose_at(k + 0.5).inverse().t)
             for k in range(N_FRAMES - 1)]
    return frames, packets, gt, ev_gt


@pytest.fixture(scope="module")
def jax_packets(sequence):
    """The JAX pipeline's inputs to the fused step at its first packet (the
    initial tracker state) and at its first warm packet (the one after the
    first usable solve: its velocity and loss scale come from that solve),
    with its static arguments."""
    frames, packets, _, _ = sequence
    jp = jpl.EDSPipeline(JCAM, jload(CFG))
    states = {}
    for k, (t, img) in enumerate(frames[:-1]):
        jp.process_frame(jnp.asarray(img), t)
        if jp.kf is None:
            continue
        name = "warm" if jp.telemetry.counters.get("event_solves", 0) else \
            "first"
        states.setdefault(name, dict(
            tracker=jp.tracker_state, pf=jp.pose_filter, depth=jp.depth,
            kf=jp.kf, pred=jp.frame_pipe._last_pose,
            loss_scale=jp.loss_scale, packet=packets[k]))
        if name == "warm":
            return states, jp._packet_step_args()
        jp.process_events(packets[k])
    pytest.fail("the JAX pipeline made no usable solve")


def _jax_step(inp, lim, iters, statics):
    kf, pred, pk = inp["kf"], inp["pred"], inp["packet"]
    return jpl._event_packet_fused(
        inp["tracker"], inp["pf"], inp["depth"], JCAM,
        kf.pose.R, kf.pose.t, pred.R, pred.t,
        kf.uv, kf.norm_coord, kf.grad, kf.idepth, kf.weight, kf.mask,
        *(jnp.asarray(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
        jnp.asarray(pk.n_valid), None, jnp.asarray(iters, jnp.int32),
        jnp.float32(inp["loss_scale"]), lim, **statics)


def _port_step(inp, iters):
    """The same step in the port, from the JAX state carried over with the
    numpy converters. Returns (the outputs, the rungs run, the host reads
    the step made)."""
    kf = tkf.from_numpy(_np_dict(inp["kf"]), device="cpu")
    pk = inp["packet"]
    lim, _, statics = tpl.EDSPipeline(TCAM, load_config(CFG), \
                                       device="cpu")._packet_step_args()
    args = (
        tet.state_from_numpy(_np_dict(inp["tracker"]), device="cpu"),
        tet.pose_filter_from_numpy(_np_dict(inp["pf"]), device="cpu"),
        tdf.from_numpy(_np_dict(inp["depth"]), device="cpu"), TCAM,
        kf.T_w_kf_R, kf.T_w_kf_t,
        torch.as_tensor(np.array(inp["pred"].R)),
        torch.as_tensor(np.array(inp["pred"].t)),
        kf.uv, kf.norm_coord, kf.grad, kf.idepth, kf.weight, kf.mask,
        *(torch.as_tensor(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
        int(pk.n_valid), None, iters, inp["loss_scale"], lim)
    with count_host_reads() as reads:
        out, rungs = tpl._event_packet_fused(*args, **statics)
    return out, rungs, reads


@pytest.mark.parametrize("packet,iters", [("first", [15, 10]),
                                          ("warm", [5, 10])])
def test_one_packet_step_from_the_same_state(jax_packets, packet, iters):
    """Every output of one fused step. The warm packet runs 5 LM iterations
    on the finest level: see ``test_warm_packet_at_the_configured_caps``
    for the configured 15."""
    states, (lim, _, statics) = jax_packets
    jout = _jax_step(states[packet], lim, iters, statics)
    launches = tr.rasterize_bilinear.launches
    tout, rungs, reads = _port_step(states[packet], iters)
    # a CPU tensor takes the raster's plain version
    assert tr.rasterize_bilinear.launches == launches
    (state, pf, depth, mask, tracks, residuals, scalars, R, t, vx) = tout
    jsc = np.asarray(jout[6])
    sc = scalars.numpy()
    assert sc[0] == jsc[0] == 1.0                 # both usable
    assert sc[3] == jsc[3]                        # LM iterations
    np.testing.assert_allclose(sc, jsc, rtol=1e-4, atol=1e-7)
    # the first rung passed the gate: run eagerly, the step reads the
    # verdict once (the retry's host ``if``) and its scalar vector once (a
    # captured step only the latter); the LM reads nothing
    assert rungs == 1
    assert reads.by_method == {"__bool__": 1, "cpu": 1}
    for got, want in ((state, jout[0]), (pf, jout[1])):
        for name, a, b in zip(got._fields, got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                       atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jout[3]))
    # the depth filter: mu within 1e-4; sigma2, a and b within 2e-3. A
    # point tracked with sub-pixel parallax (0.3 px on the warm packet) has
    # a near-degenerate two-view triangulation: from the same pose and
    # tracks the two packages' float32 inverse depths differ by up to
    # 8.5e-5 relative, and the Vogiatzis weights (a Gaussian of the
    # measurement's distance to mu) carry that into sigma2, a and b
    for name, a, b in zip(depth._fields, depth, jout[2]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                   rtol=1e-4 if name == "mu" else 2e-3,
                                   atol=1e-6, err_msg=name)
    for a, b in ((tracks, jout[4]), (residuals, jout[5]), (R, jout[7]),
                 (t, jout[8]), (vx, jout[9])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-4)


def test_warm_packet_at_the_configured_caps(jax_packets):
    """At this size every solve of the run ends at the iteration cap with
    the LM still stepping across a rough cost (rejections and accepts
    alternate), which amplifies float32 rounding about 1e5-fold between
    iterations 6 and 15 of the finest level: the poses then differ by up to
    1e-2 although the 5-iteration step above agrees within 1e-6. What does
    not depend on the LM's path agrees exactly: the gate's verdict, the
    iteration count, the event-frame time, the median depth and the number
    of points alive."""
    states, (lim, iters, statics) = jax_packets
    jsc = np.asarray(_jax_step(states["warm"], lim, iters, statics)[6])
    sc = _port_step(states["warm"], [int(i) for i in iters])[0][6].numpy()
    assert sc[0] == jsc[0] == 1.0 and sc[3] == jsc[3] == iters[0]
    np.testing.assert_array_equal(sc[5:], jsc[5:])
    np.testing.assert_allclose(sc[1:3], jsc[1:3], rtol=0.05)


@pytest.fixture(scope="module")
def port_loop(sequence):
    frames, packets, gt, ev_gt = sequence
    pipe = tpl.EDSPipeline(TCAM, load_config(CFG), device="cpu")
    ev_pos, ev_ref = [], []
    for k, (t, img) in enumerate(frames):
        pipe.process_frame(img, t)
        if k + 1 < N_FRAMES and pipe.kf is not None:
            T = pipe.process_events(packets[k])
            if T is not None:
                ev_pos.append(T.inverse().t.numpy())
                ev_ref.append(ev_gt[k])
    return pipe, ev_pos, ev_ref, gt


def test_whole_event_loop(port_loop):
    pipe, ev_pos, ev_ref, gt = port_loop
    c = pipe.telemetry.counters
    assert pipe.frame_pipe._initialized
    assert pipe.num_event_kfs >= 2, pipe.num_event_kfs
    assert len(ev_pos) >= 4 and c["event_solves"] == len(ev_pos)
    ev_ate = float(ate_rmse(np.stack(ev_pos), np.stack(ev_ref)))
    assert ev_ate < 0.12, ev_ate
    est = pipe.frame_pipe.positions()
    assert len(est) == N_FRAMES and np.isfinite(est).all()
    ate = float(ate_rmse(est, gt[:len(est)]))
    assert ate < 0.05, ate
    # host reads: one read of the scalar vector per packet, whatever the
    # retries of the gate's ladder (run eagerly, each retry's ``if`` reads
    # the verdict too); the LM and the gate read nothing else
    assert c["event_iters"] > 0
    assert c["event_scalar_host_reads"] == c["event_packets"]
    assert c["event_packets"] >= len(ev_pos)
    assert c["event_retries"] <= 2 * c["event_packets"]
    assert c["event_lm_host_reads"] == 0


def test_event_state_is_finite_and_on_the_pipeline_device(port_loop):
    pipe = port_loop[0]
    for tup in (pipe.kf, pipe.depth, pipe.tracker_state, pipe.pose_filter):
        for name, x in zip(tup._fields, tup):
            assert x.device == pipe.device, name
            if x.is_floating_point():
                assert torch.isfinite(x).all(), name
    assert int(pipe.kf.mask.sum()) > 0


@pytest.mark.parametrize("change", [
    {"tracker": {"track_refinement": "klt"}},
    {"tracker": {"track_refinement": "epiline"}},
    {"tracker": {"track_refinement": "model_klt"}},
])
def test_unported_event_options_raise(change):
    """The refinement modes are ported now (``test_torch_refinement.py``
    runs them against JAX): the option constructs a pipeline and no longer
    raises; a name that is no mode raises ``ValueError``."""
    mode = change["tracker"]["track_refinement"]
    pipe = tpl.EDSPipeline(TCAM, load_config(change), device="cpu")
    assert pipe._packet_step_args()[2]["refinement"] == mode
    bad = {"tracker": {"track_refinement": mode + "x"}}
    with pytest.raises(ValueError):
        tpl.EDSPipeline(TCAM, load_config(bad), device="cpu")


def test_undistortion_maps_raise(sequence):
    """Undistortion maps no longer raise: ``process_events(fwd_maps=...)``
    undistorts each event through the maps. Identity forward maps (every
    pixel to itself, given as numpy arrays) leave the synthetic packets'
    integer coordinates as they are, so two pipelines fed the same frames
    give bitwise the same event pose with and without them."""
    frames, packets = sequence[0], sequence[1]
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    pipes = [tpl.EDSPipeline(TCAM, load_config(CFG), device="cpu")
             for _ in range(2)]
    for k, (t, img) in enumerate(frames):
        for pipe in pipes:
            pipe.process_frame(img, t)
        if pipes[0].kf is not None:
            break
    T0 = pipes[0].process_events(packets[k])
    T1 = pipes[1].process_events(packets[k], fwd_maps=(xs, ys))
    assert T0 is not None and T1 is not None
    assert torch.equal(T0.R, T1.R) and torch.equal(T0.t, T1.t)


PORT_MODULES = (
    "slam_eds_tpu_torch.models.pipeline", "slam_eds_tpu_torch.runner",
    "slam_eds_tpu_torch.ops.kernels.rasterize",
    "slam_eds_tpu_torch.io.dataset", "slam_eds_tpu_torch.io.event_buffer",
    "slam_eds_tpu_torch.io.frame_loader", "slam_eds_tpu_torch.io.image_rw",
    "slam_eds_tpu_torch.io.recorder", "slam_eds_tpu_torch.utils.calib",
    "slam_eds_tpu_torch.ops.coarse_init", "slam_eds_tpu_torch.checkpoint",
    "slam_eds_tpu_torch.eval", "slam_eds_tpu_torch.io.output_maps",
    "slam_eds_tpu_torch.utils.viz", "slam_eds_tpu_torch.utils.klt",
    "slam_eds_tpu_torch.ops.event_tracker", "slam_eds_tpu_torch.telemetry")


def test_event_path_imports_no_jax_and_no_yaml():
    code = ("import importlib, sys; "
            f"[importlib.import_module(m) for m in {PORT_MODULES!r}]; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'slam_eds_tpu', 'yaml')); print(bad); "
            "sys.exit(1 if bad else 0)")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
