#!/usr/bin/env python3
"""Where the port's frame cell parts from the JAX package's, on the CPU.

Both packages' ``FrameOnlyPipeline`` (default config, the smoke's 640x480
frame cell: motion 0.22, 2 micro-steps, seed 7) take the same frames, the
JAX package's renders, to frame ``--frames``. Prints one JSON line:

* ``bootstrap``: after frame 1, the seeded points' idepths of the port
  against JAX's, slot by slot (the two-view bootstrap triangulates
  near-parallel rays in float32: how many are more than 1e-3 and 1e-2
  apart, relative, and the largest);
* ``activation``: after each keyframe, the active points per host frame
  in both and how many of them sit on the same pixel in both (the points
  the activation chose alike), with the largest relative idepth gap among
  those;
* ``by_frame``: the keyframe score (``runner_reference.kf_score``) and
  the position gap of every frame.

    JAX_PLATFORMS=cpu python3 tools/bootstrap_split.py --frames 21

About 3 minutes on the CPU.
"""
import argparse
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(HERE), HERE]
import runner_reference as rr  # noqa: E402


def _points(pipe):
    st = pipe.window.state
    active = rr._host(st.p_status) == 1
    return (rr._host(st.p_host)[active], rr._host(st.p_uv)[active],
            rr._host(st.p_idepth)[active])


def _activation(jp, tp):
    """Per host frame: active points in each package, those on the same
    pixel in both, the largest relative idepth gap among those."""
    (jh, juv, jd), (th, tuv, td) = _points(jp), _points(tp)
    out = {}
    for host in sorted(set(jh.tolist()) | set(th.tolist())):
        j = {tuple(u): d for u, d in zip(juv[jh == host].tolist(),
                                          jd[jh == host])}
        t = {tuple(u): d for u, d in zip(tuv[th == host].tolist(),
                                          td[th == host])}
        same = set(j) & set(t)
        gap = max((abs(t[u] - j[u]) / abs(j[u]) for u in same), default=0.0)
        out[int(host)] = {"jax": len(j), "port": len(t), "same": len(same),
                          "idepth_gap": float(gap)}
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--frames", type=int, default=21)
    args = ap.parse_args()
    jconfig, jdataset, jpipeline, _, jcam, _ = rr._package("jax")
    from slam_eds_tpu_torch.config import EDSConfig
    from slam_eds_tpu_torch.models import pipeline as tpipeline
    from slam_eds_tpu_torch.utils.cameras import Pinhole
    tcam = Pinhole(400.0, 400.0, 319.5, 239.5, 640, 480)
    seq = jdataset.SyntheticSequence(jcam, num_frames=32, motion_scale=0.22,
                                     micro_steps=2)
    jp = jpipeline.FrameOnlyPipeline(jcam, jconfig.EDSConfig())
    tp = tpipeline.FrameOnlyPipeline(tcam, EDSConfig(), device="cpu")
    for pipe in (jp, tp):
        rr.keep_kf_inputs(type(pipe.window))
    jrec = trec = None
    out = {"activation": {}}
    for k in range(args.frames + 1):
        t, img, _ = seq.frame(k)
        jp.process_frame(img, float(t))
        tp.process_frame(np.array(img), float(t))
        jrec, trec = rr.frame_record(jp, jrec), rr.frame_record(tp, trec)
        if k == 1:
            jd = rr._host(jp.window.state.p_idepth).astype(np.float64)
            td = rr._host(tp.window.state.p_idepth).astype(np.float64)
            live = rr._host(jp.window.state.p_status) == 1
            rel = np.abs(td - jd)[live] / np.abs(jd[live])
            out["bootstrap"] = {"seeded": int(live.sum()),
                                "above_1e-3": int((rel > 1e-3).sum()),
                                "above_1e-2": int((rel > 1e-2).sum()),
                                "largest": float(rel.max())}
        if jrec["keyframes"][k] != (jrec["keyframes"][k - 1] if k else 0):
            out["activation"][k] = _activation(jp, tp)
    out["by_frame"] = {
        "keyframes": [trec["keyframes"], jrec["keyframes"]],
        "kf_score": [trec["kf_score"], jrec["kf_score"]],
        "position_gap": [float(np.linalg.norm(np.subtract(a, b)))
                         for a, b in zip(trec["position"],
                                         jrec["position"])]}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
