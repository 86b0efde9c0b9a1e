"""Batched multi-sequence evaluation — port of ``slam_eds_tpu.eval``.

* ``evaluate_sequences`` runs every sequence through the full pipeline in
  one process (the kernels are built once) and reports per-sequence
  ATE-RMSE / RPE / rates plus aggregates.
* ``batched_event_solves`` and ``batched_ba_windows`` are one ``torch.vmap``
  each of the read-free solvers over a leading batch axis B, as the JAX
  functions are ``jax.vmap``s: the B problems run as one batched program,
  each lane on its own accept/reject and stopping mask. The loops stay
  masked here (``graphs.while_loop`` runs eagerly under ``torch.vmap``):
  every lane runs to the cap or to the last lane's stop, as JAX's ``vmap``
  of a ``while_loop`` runs every lane until the last one stops. On the
  card the BA lanes' taps go to the sampler kernel's lane axis in one
  launch per GN pass, and the lanes' small solves to the LU substitution
  kernel in one launch (the operators' ``vmap`` rules).

CLI:
    python -m slam_eds_tpu_torch.eval <seq_dir> [<seq_dir> ...]
        [--report r.json] [--frames N] [--frame-only] [--device cuda|cpu]
A single argument that is a directory of sequence subdirectories (each with
an ``images.txt``) is expanded automatically.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import List, Optional

import numpy as np
import torch

from .config import EDSConfig
from .ops import energy
from .ops import event_tracker as et
from .utils.cameras import Pinhole


# ---------------------------------------------------------------------------
# Batched solver surface
# ---------------------------------------------------------------------------

def _lane(tree, b: int):
    """Lane b of a NamedTuple whose tensor fields carry a leading batch
    axis (nested NamedTuples included)."""
    return type(tree)(*(_lane(x, b) if isinstance(x, tuple) else x[b]
                        for x in tree))


def _stack(lanes):
    """Inverse of ``_lane`` over a list of NamedTuples."""
    first = lanes[0]
    return type(first)(*(
        _stack([l[i] for l in lanes]) if isinstance(x, tuple)
        else torch.stack([l[i] for l in lanes])
        for i, x in enumerate(first)))


@torch.inference_mode()
def batched_event_solves(states: et.TrackerState, event_frames, cam: Pinhole,
                         norm_coord, grad, idp, weights, mask,
                         max_iterations: int = 20, loss_kind: str = "huber",
                         loss_scale=0.2, norm_event: bool = False):
    """``torch.vmap`` of the event-to-model LM solve over a leading batch
    axis B.

    states: TrackerState with fields [B, ...]; event_frames [B, H, W];
    keyframe tensors [B, P, ...]; loss_scale a scalar or [B]. Returns a
    TrackerResult with every field [B, ...]; each lane runs its own LM
    trajectory (accept/reject and the stop are per lane, through the masked
    loop's carry). The lanes run the plain pass (``event_tracker.
    _lm_solve_plain``; a lane axis never takes the fused ``event_pass``
    kernel), each bitwise that plain pass on its own inputs alone: the LM's
    reductions run lane by lane (``ops.lanes``), its element-wise work
    batched, its solves one small solve launch a pass for every lane
    (``utils.linalg.solve``). On CPU tensors that is ``event_tracker.
    optimize`` itself; on the card a single ``optimize`` takes the kernel,
    whose sums run in another order."""
    def one(state, ef, nc, g, d, w, m, ls):
        return et.optimize(state, ef, cam, nc, g, d, w, m,
                           max_iterations=max_iterations, loss_kind=loss_kind,
                           loss_scale=ls, norm_event=norm_event)

    B = event_frames.shape[0]
    ls = loss_scale
    if not torch.is_tensor(ls):
        ls = torch.full((), ls, dtype=torch.float32,
                        device=event_frames.device)
    if ls.dim() == 0:
        # a scalar applies to every lane: give vmap a mapped axis
        ls = ls.expand(B)
    return torch.vmap(one)(states, event_frames, norm_coord, grad, idp,
                           weights, mask, ls)


@torch.inference_mode()
def batched_ba_windows(states, target_images, height: int, width: int,
                       iterations: int = 6, orth_from_iteration: int = 2):
    """``torch.vmap`` of the keyframe-BA GN loop (``ops.energy.ba_iterate``)
    over a leading batch axis B: B independent sliding windows in one
    batched program.

    states: BAState with every field [B, ...]; target_images [B, F, H, W]
    intensities or [B, F, H, W, 3] stacks. Returns (batched BAState,
    energies [B])."""
    def one(st, im):
        st2, e, _ = energy.ba_iterate(st, im, height, width,
                                      iterations=iterations,
                                      orth_from_iteration=orth_from_iteration)
        return st2, e

    return torch.vmap(one)(states, target_images)


# ---------------------------------------------------------------------------
# Multi-sequence evaluation
# ---------------------------------------------------------------------------

def _expand_sequence_dirs(paths: List[str]) -> List[str]:
    if len(paths) == 1 and os.path.isdir(paths[0]) and not os.path.exists(
            os.path.join(paths[0], "images.txt")):
        subs = sorted(
            os.path.join(paths[0], d) for d in os.listdir(paths[0])
            if os.path.exists(os.path.join(paths[0], d, "images.txt")))
        if subs:
            return subs
    return paths


def evaluate_sequences(seq_dirs: List[str], cfg: Optional[EDSConfig] = None,
                       max_frames: Optional[int] = None,
                       frame_only: bool = False, verbose: bool = True,
                       device="cuda"):
    """Run every sequence through the full pipeline on ``device`` in one
    process and report per-sequence ATE-RMSE / RPE / rates plus
    aggregates."""
    from .runner import run_sequence

    seq_dirs = _expand_sequence_dirs(list(seq_dirs))
    per_seq = {}
    t0 = time.perf_counter()
    for d in seq_dirs:
        name = os.path.basename(os.path.normpath(d))
        if verbose:
            print(f"[eval] sequence {name}")
        res = run_sequence(d, cfg, max_frames=max_frames,
                           frame_only=frame_only, verbose=False,
                           device=device)
        per_seq[name] = {k: v for k, v in res.items() if k != "positions"}
    wall = time.perf_counter() - t0

    ates = [v["ate_rmse"] for v in per_seq.values() if "ate_rmse" in v]
    return {
        "sequences": per_seq,
        "num_sequences": len(per_seq),
        "wall_s": wall,
        "mean_ate_rmse": float(np.mean(ates)) if ates else None,
        "median_ate_rmse": float(np.median(ates)) if ates else None,
        "total_frames_per_s": sum(v["frames"] for v in per_seq.values())
        / max(wall, 1e-9),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("sequences", nargs="+")
    ap.add_argument("--report", default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--frame-only", action="store_true")
    ap.add_argument("--config", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device; the run raises without a card "
                         "unless the CPU is asked for (--device cpu)")
    args = ap.parse_args()
    cfg = None
    if args.config:
        from .config import load_config
        cfg = load_config(args.config)
    report = evaluate_sequences(args.sequences, cfg, max_frames=args.frames,
                                frame_only=args.frame_only,
                                device=args.device)
    print(json.dumps(report, indent=2))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2)


if __name__ == "__main__":
    main()
