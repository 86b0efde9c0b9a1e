"""The port's on-disk runner (``slam_eds_tpu_torch.runner``) against the JAX
package's, on the CPU, on one directory written by ``test_runner.py``'s
exporter (128x96, 10 frames of ``SyntheticSequence``, motion 0.35) with
``test_runner.py``'s config, for its three cases: a zero-coefficient radtan
calib (frame remap and event forward maps), the dual rig (common-view
rectification) and the pure-Python ring and reader (a 16,384-event ring,
4,096-event packets). The recorder is on in every run.

* Both runners feed their pipelines the same packets, bitwise (the I/O
  path: reader, ring, scheduler or Python interleave, float32 times), and
  the same frames within 1e-5 + 2 float32 ulps of 255 per gray level (one
  PNG decode, then the remap through maps that agree to an ulp).
* The run: the same keys; equal frames, packets and resets;
  marginalizations and keyframes within one (the split below moves the
  frame backend's keyframe cadence, since the event path seeds the frame
  tracker: the pure-Python case makes 5 marginalizations against JAX's 6);
  each ATE below ``test_runner.py``'s own bound and the port's at most
  0.05 above JAX's (after the split the two trajectories differ: the port's
  ATE is 0.050 against JAX's 0.071 in the radtan case, 0.006 against 0.060
  in the pure-Python one); poses.txt has one line per usable solve.
* The runs split where ROADMAP §3 says the event path does: at this size
  every solve runs to its iteration cap with the LM still wandering, so the
  first packets on which the two LMs' rounding differs make one side's
  solve pass the step gate and the other's not (radtan: JAX 3 usable
  solves of 9, the port 8). So the poses.txt counts are compared from the
  JAX state: each packet's step in the port, from the JAX pipeline's state
  before it with the same packet and the same forward maps, gives JAX's
  gate verdict on every packet (so JAX's poses.txt count), the iteration
  count and the event-frame time and median depth exactly, and, where the
  port's first solve passes its gate, the event-frame pose within 1e-4.
"""
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io import event_buffer as jeb
from slam_eds_tpu.io.dataset import SyntheticSequence
from slam_eds_tpu.models import pipeline as jpl
from slam_eds_tpu.runner import run_sequence as jrun
from test_runner import CAM as JCAM, _export

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.io import event_buffer as teb
from slam_eds_tpu_torch.models import keyframe as tkf
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.ops import depth_filter as tdf
from slam_eds_tpu_torch.ops import event_tracker as tet
from slam_eds_tpu_torch.runner import run_sequence as trun
from slam_eds_tpu_torch.utils.cameras import Pinhole

torch.set_num_threads(1)

W, H = 128, 96
TCAM = Pinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
N_FRAMES = 10
CFG = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 8192},
    "tracker": {"max_iterations": [15, 10], "max_step_translation": 0.5},
}
DUAL_CALIB = ("cam0:\n"
              "  intrinsics: [110.0, 110.0, 63.5, 47.5]\n"
              f"  resolution: [{W}, {H}]\n"
              "  distortion_model: radtan\n"
              "  distortion_coeffs: [0, 0, 0, 0]\n"
              "cam1:\n"
              "  intrinsics: [110.0, 110.0, 63.5, 47.5]\n"
              f"  resolution: [{W}, {H}]\n"
              "  distortion_model: none\n"
              "  T_cn_cnm1: [[1, 0, 0, 0], [0, 1, 0, 0],\n"
              "              [0, 0, 1, 0], [0, 0, 0, 1]]\n")
# test_runner.py's bounds: 0.2, and 0.25 for the pure-Python ring
ATE_BOUND = {"radtan": 0.2, "dual": 0.2, "python": 0.25}
ATE_DIFF = 0.05


def _cfg(load, case, out):
    cfg = dict(CFG)
    if case == "python":
        cfg["event_frame"] = {"num_levels": 2, "events_per_frame": 4096}
    cfg = load(cfg)
    return dataclasses.replace(cfg, recorder=dataclasses.replace(
        cfg.recorder, enabled=True, output_folder=out))


def _record(cls, log):
    """Wrap cls.process_frame / process_events to log their inputs, the
    event step's state before each packet, and each packet's verdict."""
    frame, events = cls.process_frame, cls.process_events

    def process_frame(self, img, t, depth_map=None):
        log["frames"].append(np.array(img) if not torch.is_tensor(img)
                             else img.numpy().copy())
        return frame(self, img, t, depth_map)

    def process_events(self, packet, fwd_maps=None):
        if self.kf is not None and log.get("states") is not None:
            log["states"].append(dict(
                tracker=self.tracker_state, pf=self.pose_filter,
                depth=self.depth, kf=self.kf,
                pred=self.frame_pipe._last_pose, loss_scale=self.loss_scale,
                packet=packet, maps=fwd_maps,
                args=self._packet_step_args()))
        T = events(self, packet, fwd_maps)
        if self.kf is not None and log.get("states") is not None:
            log["states"][-1]["usable"] = T is not None
        log["packets"].append(packet)
        log["usable"].append(T is not None)
        return T
    return process_frame, process_events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("runner")
    base = str(root / "seq")
    seq = SyntheticSequence(JCAM, num_frames=N_FRAMES, events_per_packet=8192,
                            motion_scale=0.35)
    _export(seq, base)
    out = {"dir": base}
    for case in ("radtan", "dual", "python"):
        d = str(root / case)
        shutil.copytree(base, d)
        if case == "dual":
            Path(d, "calib.yaml").write_text(DUAL_CALIB)
        res = {}
        for side, cls, run, load, eb in (
                ("jax", jpl.EDSPipeline, jrun, jload, jeb),
                ("port", tpl.EDSPipeline, trun, load_config, teb)):
            log = {"frames": [], "packets": [], "usable": [],
                   "states": [] if (case, side) == ("radtan", "jax")
                   else None}
            rec = str(root / f"{case}_{side}_out")
            kwargs = {} if side == "jax" else {"device": "cpu"}
            with pytest.MonkeyPatch.context() as mp:
                pf, pe = _record(cls, log)
                mp.setattr(cls, "process_frame", pf)
                mp.setattr(cls, "process_events", pe)
                if case == "python":
                    ring = eb.PurePythonRing
                    mp.setattr(eb, "available", lambda: False)
                    mp.setattr(eb, "PurePythonRing",
                               lambda cap=0, ring=ring: ring(1 << 14))
                r = run(d, _cfg(load, case, rec), verbose=False, **kwargs)
            with open(os.path.join(rec, "poses.txt")) as f:
                r["poses_lines"] = len(f.read().strip().splitlines())
            res[side] = (r, log)
        out[case] = res
    return out


@pytest.mark.parametrize("case", ["radtan", "dual", "python"])
def test_runners_feed_the_same_inputs(runs, case):
    (_, jlog), (_, tlog) = runs[case]["jax"], runs[case]["port"]
    assert len(tlog["packets"]) == len(jlog["packets"]) > 0
    for a, b in zip(tlog["packets"], jlog["packets"]):
        assert a.n_valid == b.n_valid
        for u, v in zip(a[:4], b[:4]):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    assert len(tlog["frames"]) == len(jlog["frames"]) == N_FRAMES
    for a, b in zip(tlog["frames"], jlog["frames"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 + 2.4e-7 * 255)


@pytest.mark.parametrize("case", ["radtan", "dual", "python"])
def test_run_sequence_matches_jax(runs, case):
    (jres, jlog), (tres, tlog) = runs[case]["jax"], runs[case]["port"]
    assert set(tres) == set(jres)
    for key in ("frames", "packets", "resets"):
        assert tres[key] == jres[key], key
    for key in ("marginalizations", "keyframes"):
        assert abs(tres[key] - jres[key]) <= 1, key
    assert tres["frames"] == N_FRAMES and tres["packets"] >= 3
    for res in (tres, jres):
        assert res["ate_rmse"] < ATE_BOUND[case], res["ate_rmse"]
    assert tres["ate_rmse"] <= jres["ate_rmse"] + ATE_DIFF
    assert np.isfinite(tres["positions"]).all()
    assert tres["positions"].shape == jres["positions"].shape
    for res, log in ((tres, tlog), (jres, jlog)):
        assert res["poses_lines"] == sum(log["usable"])


def _np_dict(tup):
    return {k: np.asarray(v) for k, v in tup._asdict().items()}


def test_each_packet_from_the_jax_state(runs):
    """The radtan run's packets replayed from the JAX pipeline's state."""
    jlog = runs["radtan"]["jax"][1]
    lim, _, statics = tpl.EDSPipeline(TCAM, load_config(CFG),
                                      device="cpu")._packet_step_args()
    verdicts = []
    for st in jlog["states"]:
        usable = st["usable"]
        kf, pred, pk = st["kf"], st["pred"], st["packet"]
        jlim, jiters, jstat = st["args"]
        jout = jpl._event_packet_fused(
            st["tracker"], st["pf"], st["depth"], JCAM, kf.pose.R, kf.pose.t,
            pred.R, pred.t, kf.uv, kf.norm_coord, kf.grad, kf.idepth,
            kf.weight, kf.mask,
            *(jnp.asarray(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
            jnp.asarray(pk.n_valid), st["maps"], jiters,
            jnp.float32(st["loss_scale"]), jlim, **jstat)
        tk = tkf.from_numpy(_np_dict(kf), device="cpu")
        tout, rungs = tpl._event_packet_fused(
            tet.state_from_numpy(_np_dict(st["tracker"]), device="cpu"),
            tet.pose_filter_from_numpy(_np_dict(st["pf"]), device="cpu"),
            tdf.from_numpy(_np_dict(st["depth"]), device="cpu"), TCAM,
            tk.T_w_kf_R, tk.T_w_kf_t, torch.as_tensor(np.array(pred.R)),
            torch.as_tensor(np.array(pred.t)), tk.uv, tk.norm_coord, tk.grad,
            tk.idepth, tk.weight, tk.mask,
            *(torch.as_tensor(a) for a in (pk.xs, pk.ys, pk.ts, pk.polarity)),
            int(pk.n_valid),
            tuple(torch.as_tensor(np.array(m)) for m in st["maps"]),
            [int(i) for i in jiters], st["loss_scale"], lim, **statics)
        jsc, tsc = np.asarray(jout[6]), tout[6].numpy()
        assert (tsc[0] > 0.5) == (jsc[0] > 0.5) == usable
        assert tsc[3] == jsc[3]
        np.testing.assert_array_equal(tsc[6:], jsc[6:])
        if usable and rungs == 1:
            np.testing.assert_allclose(tout[8].numpy(), np.asarray(jout[8]),
                                       rtol=0, atol=1e-4)
        verdicts.append(usable)
    assert len(verdicts) >= 6 and 0 < sum(verdicts) < len(verdicts)
    assert sum(verdicts) == runs["radtan"]["jax"][0]["poses_lines"]


def test_cli_on_the_cpu(runs, tmp_path):
    """``python -m slam_eds_tpu_torch.runner`` on the CPU: the first 3
    frames of the dataset, the recorder on through ``--output``."""
    d = str(tmp_path / "seq")
    shutil.copytree(runs["dir"], d)
    out = str(tmp_path / "out")
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "slam_eds_tpu_torch.runner", d, "--frames",
         "3", "--device", "cpu", "--output", out], cwd=root,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "'frames': 3" in proc.stdout and "'packets': 2" in proc.stdout
    assert os.path.exists(os.path.join(out, "poses.txt"))
