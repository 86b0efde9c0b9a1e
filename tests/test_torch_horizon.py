"""The port held to the JAX package frame by frame, up to the horizon H: the
last frame at which the JAX package's frame rotation is still within
``runner_reference.DRIFT_LIMIT`` (1e-2) of SO(3). Past it the reference's
poses are no longer rotations and its answer is undefined, so a whole-run
comparison would sum frames the reference cannot answer for.

Both packages' ``FrameOnlyPipeline`` run on the CPU on one 128x96
``SyntheticSequence`` (seed 7, 13 frames, motion 0.35) with a 4-frame
window (``window_size`` = ``min_frames`` = 4), each rendering its own
frames. The run marginalizes at frames 7 and 9, before its H (12, the last
frame). At every frame up to H: the keyframes, marginalizations, BA runs
and resets are equal, each position is within a tenth of the JAX run's
ATE of JAX's (reading: 1.35e-3 against 3.06e-3), and the port's drift is
1/3 to 3 times JAX's from frame 4 on (reading: 0.94 to 1.09). The same
holds from JAX's two-view bootstrap (``shared_bootstrap``: 151 of 151
inliers matched; 1.42e-3, 1.33 to 1.37), as the smoke runs its cells.

``tools/runner_reference.py`` holds the per-frame record, ``horizon`` and
``per_frame_parity``: the same the smoke's cells are held with on the
card.
"""
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_eds_tpu.config import load_config as jload
from slam_eds_tpu.io.dataset import SyntheticSequence as JSeq
from slam_eds_tpu.models import pipeline as jpl
from slam_eds_tpu.models.pipeline import FrameOnlyPipeline as JPipe
from slam_eds_tpu.utils.alignment import ate_rmse as j_ate
from slam_eds_tpu.utils.cameras import Pinhole as JPinhole

from slam_eds_tpu_torch.config import load_config
from slam_eds_tpu_torch.io.dataset import SyntheticSequence as TSeq
from slam_eds_tpu_torch.models import pipeline as tpl
from slam_eds_tpu_torch.models.pipeline import FrameOnlyPipeline as TPipe
from slam_eds_tpu_torch.utils.cameras import Pinhole as TPinhole

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import runner_reference as rr  # noqa: E402

torch.set_num_threads(1)

W, H, FRAMES, MOTION = 128, 96, 13, 0.35
JCAM = JPinhole(jnp.float32(110.0), jnp.float32(110.0),
                jnp.float32(W / 2 - 0.5), jnp.float32(H / 2 - 0.5), W, H)
TCAM = TPinhole(110.0, 110.0, W / 2 - 0.5, H / 2 - 0.5, W, H)
CFG = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 4},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 8192},
    "tracker": {"max_iterations": [15, 10]},
}

# The frame cell's drift as the issue's table prints it (the JAX package
# on the CPU, the smoke's 640x480 frame cell): frame 22's 1.0e-2 is
# 1.03e-2 rounded to two digits, given here unrounded
TABLE_FRAMES = (1, 6, 11, 16, 17, 21, 22, 24, 25, 26, 27, 30, 31)
TABLE_DRIFT = (2.4e-7, 2.6e-6, 2.8e-5, 3.1e-4, 9.3e-4, 3.4e-3, 1.03e-2,
               2.4e-2, 0.075, 0.245, 0.943, 7.02, 7.16)


def _run_both(frames, mp, shared=False):
    """Both packages over a ``frames``-frame sequence: their per-frame
    records (with each frame's keyframe score, ``keep_kf_inputs``), JAX's
    ATE and JAX's bootstrap (``keep_bootstrap``); with ``shared`` also the
    port's record from JAX's bootstrap (``shared_bootstrap``)."""
    jseq = JSeq(JCAM, num_frames=frames, motion_scale=MOTION)
    tseq = TSeq(TCAM, num_frames=frames, motion_scale=MOTION, device="cpu")
    jp, tp = JPipe(JCAM, jload(CFG)), TPipe(TCAM, load_config(CFG),
                                            device="cpu")
    for pipe in (jp, tp):
        cls = type(pipe.window)
        mp.setattr(cls, "need_new_kf", cls.need_new_kf)
        rr.keep_kf_inputs(cls)
    boot = {}
    mp.setattr(jpl.initializer, "bootstrap_eight_point",
               jpl.initializer.bootstrap_eight_point)
    rr.keep_bootstrap(jpl.initializer, boot)
    jrec = trec = None
    for k in range(frames):
        t, img, _ = jseq.frame(k)
        jp.process_frame(img, t)
        jrec = rr.frame_record(jp, jrec)
        t, img, _ = tseq.frame(k)
        tp.process_frame(img, float(t))
        trec = rr.frame_record(tp, trec)
    ate = float(j_ate(jnp.asarray(jp.positions()),
                      jnp.asarray(jseq.gt_positions())))
    out = dict(jax=jrec, port=trec, ate=ate, boot=boot)
    if shared:
        stand_in = rr.shared_bootstrap(boot)
        mp.setattr(tpl.initializer, "bootstrap_eight_point", stand_in)
        sp, srec = TPipe(TCAM, load_config(CFG), device="cpu"), None
        for k in range(frames):
            t, img, _ = tseq.frame(k)
            sp.process_frame(img, float(t))
            srec = rr.frame_record(sp, srec)
        out.update(shared=srec, matched=stand_in.matched)
    return out


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        return _run_both(FRAMES, mp, shared=True)


def test_horizon_of_the_frame_cell_table():
    assert rr.horizon(TABLE_DRIFT, frames=TABLE_FRAMES) == 21
    # at most the limit counts as within it; the first frame past it ends
    # the horizon even where a later one (after a reset) is back within
    assert rr.horizon([0.0, 1e-3, rr.DRIFT_LIMIT, 0.5, 1e-4]) == 2
    assert rr.horizon([0.0, 1e-3]) == 1
    assert rr.horizon([0.5]) is None


def test_horizon_of_the_smoke_references():
    import chip_smoke as smoke
    H = {name: rr.horizon(ref["drift"]) for name, ref in (
        ("frame", smoke.JAX_CPU_FRAME_BY_FRAME),
        ("event", smoke.JAX_CPU_EDS_BY_FRAME),
        ("window4", smoke.JAX_CPU_W4_BY_FRAME))}
    assert H == {"frame": 21, "event": 25, "window4": 19}
    # the window-4 cell marginalizes at least twice by its horizon
    assert smoke.JAX_CPU_W4_BY_FRAME["marginalized"][H["window4"]] >= 2


def test_small_cell_marginalizes_before_its_horizon(runs):
    jrec = runs["jax"]
    H = rr.horizon(jrec["drift"])
    assert jrec["marginalized"][H] >= 2
    assert jrec["resets"][H] == 0


def test_port_held_to_jax_frame_by_frame(runs):
    jrec, trec = runs["jax"], runs["port"]
    p = rr.per_frame_parity(trec, jrec, pos_tol=0.1 * runs["ate"])
    assert p["faults"] == [], p["faults"]
    assert p["horizon"] == p["held_to"] == FRAMES - 1
    for c in rr.COUNTS:
        assert trec[c] == jrec[c], c
    lo, hi = p["drift_ratio_range"]
    assert rr.DRIFT_RATIO[0] <= lo <= hi <= rr.DRIFT_RATIO[1]


def test_port_from_jax_bootstrap(runs):
    """The port's run from JAX's two-view bootstrap (its pose and its
    inliers' idepths, matched on the candidates' coordinates; the rest of
    the bootstrap the port's): every JAX inlier is found among the port's
    candidates, and the run holds every per-frame check to H."""
    jrec, srec = runs["jax"], runs["shared"]
    assert runs["matched"] == (len(runs["boot"]["nc"]),) * 2
    p = rr.per_frame_parity(srec, jrec, pos_tol=0.1 * runs["ate"])
    assert p["faults"] == [], p["faults"]


def test_parity_reports_a_count_that_parts():
    """A count that parts before H, a position past its bound, a drift
    ratio outside [1/3, 3] and a flipped verdict are each a fault; past H
    the same readings are printed, not held."""
    want = {"keyframes": [0, 2, 2, 3, 3, 3], "marginalized": [0] * 6,
            "ba_runs": [0, 0, 0, 1, 1, 1], "resets": [0] * 6,
            "drift": [0.0, 1e-7, 1e-6, 1e-5, 1e-3, 0.5],
            "position": [[0.0, 0.0, float(k)] for k in range(6)],
            "usable": "uuuux"}
    same = rr.per_frame_parity(want, want, pos_tol=1e-3)
    assert same["faults"] == [] and same["horizon"] == 4
    assert same["packets_compared"] == 4

    got = dict(want, keyframes=[0, 2, 3, 3, 3, 9],
               drift=[0.0, 1e-7, 1e-6, 1e-5, 1e-2, 5.0],
               position=[list(p) for p in want["position"]],
               usable="uxuuu")
    got["position"][4][0] += 2e-3
    faults = rr.per_frame_parity(got, want, pos_tol=1e-3)["faults"]
    assert len(faults) == 4, faults
    assert faults[0].startswith("keyframes parts at frame 2")
    assert "position gap" in faults[1] and "frame 4" in faults[1]
    assert "drift ratio" in faults[2] and "frame 4" in faults[2]
    assert faults[3].startswith("packet 1 ")
    held = rr.per_frame_parity(got, want, pos_tol=1e-3,
                               hold=("drift_ratio", "usable"))["faults"]
    assert len(held) == 2 and held[1].startswith("packet")

    past = dict(want, keyframes=[0, 2, 2, 3, 3, 9],
                drift=[0.0, 1e-7, 1e-6, 1e-5, 1e-3, 5.0],
                position=[list(p) for p in want["position"]],
                usable="uuuuu")
    past["position"][5][0] += 1.0
    p = rr.per_frame_parity(past, want, pos_tol=1e-3)
    assert p["faults"] == []
    assert p["position_gap_past"] == pytest.approx(1.0)
    assert p["usable_flips_past"] == [4]


def test_keyframe_score_knife_edge():
    """The same motion spread over 20 frames (each frame moves less far)
    parts before its H (frame 14): at frame 10 JAX's keyframe score is
    1.0012 and the port's 0.9971, so JAX makes a keyframe and the port one
    frame later, after every count agreed. ``per_frame_parity`` takes such
    a part for what it is, a keyframe decision whose scores lie within
    ``KF_EDGE`` of the threshold on either side of it (float32 rounding of
    the flow the decision sums, not a different computation): it holds
    every check to the frame before and reports the part as
    ``knife_edge``; a part of any other kind is a fault."""
    with pytest.MonkeyPatch.context() as mp:
        r = _run_both(20, mp)
    jrec, trec = r["jax"], r["port"]
    p = rr.per_frame_parity(trec, jrec, pos_tol=0.1 * r["ate"])
    assert p["faults"] == [], p["faults"]
    assert p["horizon"] == 14 and p["knife_edge"] is not None
    k, (st, sj) = p["knife_edge"]["frame"], p["knife_edge"]["kf_scores"]
    assert k == 10 and p["held_to"] == k - 1
    assert (sj > 1.0) != (st > 1.0), (k, sj, st)
    assert abs(sj - 1.0) < rr.KF_EDGE and abs(st - 1.0) < rr.KF_EDGE
    assert trec["keyframes"][k] != jrec["keyframes"][k]
    # the same part with either score moved off the edge is a fault
    far = dict(trec, kf_score=list(trec["kf_score"]))
    far["kf_score"][k] = 1.0 + 2 * rr.KF_EDGE * (1 if st > 1 else -1)
    faults = rr.per_frame_parity(far, jrec, 0.1 * r["ate"])["faults"]
    assert faults and faults[0].startswith(f"keyframes parts at frame {k}")


def test_frame_record_reads_either_package(runs):
    for rec in (runs["jax"], runs["port"]):
        assert len(rec["drift"]) == len(rec["position"]) == FRAMES
        assert len(rec["kf_score"]) == FRAMES
        # a score on every tracked frame (from frame 2 on), none before
        assert rec["kf_score"][:2] == [None, None]
        assert all(s is not None and s > 0 for s in rec["kf_score"][2:])
        assert rec["drift"][0] == 0.0
        assert all(np.isfinite(rec["position"][k]).all()
                   for k in range(FRAMES))
