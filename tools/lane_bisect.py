#!/usr/bin/env python3
"""Where does a batched event lane part from its single solve, op by op?

Runs the event cell (``chip_smoke.run_event_cell``: ``EDSPipeline``, 32
frames of the bench_e2e sequence, 65,536-event packets) with the package
imported from ``--tree`` (a checkout of this repository, the current one by
default), builds the batched event lanes as the smoke's ``batched`` phase
does (``chip_smoke.event_lanes``: the tracker state B times against the
finest event frames of the last B packets), then for each lane runs the
plain pass on the lane's inputs alone (``event_tracker._lm_solve_plain``,
what the lanes run; ``optimize`` in a tree without it) and
``eval.batched_event_solves`` (one ``torch.vmap``) on all lanes, each for
``--iterations`` LM passes, recording every aten op's outputs with
``tools/history_bisect.py``'s op recorder. The batched run's outputs are
cut to the lane (``lane_of``), the two op sequences are aligned by op name
(products as one family: the batching rules turn ``mm`` into ``bmm``) and
the port's line that issued the op (an op that ``ops/lanes.py`` runs once a
lane under the map is compared on that lane's run), and the first op whose
lane output is not bitwise the single one's is reported (none where the
lane is bitwise its single solve): its name, the line of the port that
issued it, its index among the aligned ops and the largest gap; then the
pose gaps after the passes.
One JSON line per lane, and the card's name and power limit. Imports no
JAX. Run from the root of a checkout (``history_bisect`` imports
``chip_smoke`` from the working directory):

    python3 tools/lane_bisect.py [--tree DIR] [--iterations 2] [--lanes 4]
"""
import argparse
import json
import os
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "tools"))
import history_bisect as hb  # noqa: E402  (and chip_smoke, from the cwd)


class Recorder(hb.Recorder):
    """``history_bisect``'s op recorder keeping, per aten op, (name, the
    port's line that issued it, copies of its tensor outputs) in ``ops``
    in place of digests; views and ``empty*`` ops are left out."""

    def __init__(self, dev):
        super().__init__(dev)
        self.ops = []

    def record(self, name, outs):
        if outs:
            self.ops.append((name, self._loc(),
                             [t.detach().clone() for t in outs]))


# products the batching rules turn into others (mm and mv into bmm)
PRODUCTS = {"mm", "bmm", "mv", "addmm", "baddbmm", "addmv", "dot", "matmul"}


def family(name):
    """An aten op's name without its overload, products as one family."""
    base = name.split(".")[1] if name.startswith("aten.") else name
    return "product" if base in PRODUCTS else base


def lane_of(t, u, b):
    """``t`` (a batched op's output) cut to lane ``b`` as ``u`` (the single
    op's) is shaped: along the first axis whose removal gives ``u``'s
    shape, else along the first axis reshaped (a product's trailing unit
    axis); None where neither fits."""
    if t.shape == u.shape:
        return t
    if t.dim() == u.dim() + 1:
        for d in range(t.dim()):
            if t.shape[:d] + t.shape[d + 1:] == u.shape:
                return t.select(d, b)
    if t.dim() and b < t.shape[0] and t[0].numel() == u.numel():
        return t[b].reshape(u.shape)
    return None


# where the port runs an op once a lane under torch.vmap (ops/lanes.py);
# its vmap rule's own copies and stacks are left out of the comparison
LANEWISE = "ops/lanes.py"
BOOKKEEPING = {"clone", "stack", "cat"}


def lanewise(op):
    return LANEWISE in op[1]


def lane_runs(run, pool, lanes):
    """For each op of ``run`` (consecutive ops of the single run issued from
    ``ops/lanes.py``, one or more calls), its ``lanes`` copies in ``pool``
    (the batched run's ops from there, each call's ops once a lane in lane
    order): a list of index lists, or None where they do not line up. A
    call of L ops is the shortest L whose ``lanes`` repeats start the
    pool."""
    out, i, p = [], 0, 0
    while i < len(run):
        for n in range(1, len(run) - i + 1):
            fam = [family(o[0]) for o in run[i:i + n]]
            if [family(o[0]) for o in pool[p:p + n * lanes]] == fam * lanes:
                break
        else:
            return None
        out += [[p + k * n + q for k in range(lanes)] for q in range(n)]
        i, p = i + n, p + n * lanes
    return out


def first_parting(single, batched, b, lanes, window=40):
    """(the first aligned op whose lane output differs, ops compared): the
    ops are aligned by ``family`` and the port's line that issued them, a
    batched op that the single run lacks (a view the batching rule adds)
    skipped, and the reverse; a run of ops that
    ``ops/lanes.py`` issues is matched with lane ``b``'s copies
    (``lane_runs``)."""
    pairs, i, j = [], 0, 0
    while i < len(single):
        if lanewise(single[i]):
            e = i
            while e < len(single) and lanewise(single[e]):
                e += 1
            pool = [k for k in range(j, len(batched))
                    if lanewise(batched[k])
                    and family(batched[k][0]) not in BOOKKEEPING]
            pool = pool[:(e - i) * lanes]
            runs = lane_runs(single[i:e], [batched[k] for k in pool], lanes)
            if runs is not None:
                pairs += [(single[i + q], batched[pool[r[b]]])
                          for q, r in enumerate(runs)]
                j = pool[-1] + 1
            i = e
            continue
        k = next((k for k in range(j, min(j + window, len(batched)))
                  if family(batched[k][0]) == family(single[i][0])
                  and batched[k][1] == single[i][1]), None)
        if k is not None:
            pairs.append((single[i], batched[k]))
            j = k + 1
        i += 1
    compared = 0
    for (name, loc, outs), (_, _, touts) in pairs:
        for u, t in zip(outs, touts):
            lane = lane_of(t, u, b)
            if lane is None or lane.dtype != u.dtype:
                continue
            compared += 1
            same = (lane == u) | (lane.isnan() & u.isnan()) \
                if u.is_floating_point() else lane == u
            if not bool(same.all()):
                gap = float((lane.double() - u.double()).abs().max())
                return {"op": name, "line": loc, "op_index": compared,
                        "max_abs_gap": gap,
                        "max_abs_value": float(u.double().abs().max())}, \
                    compared
    return None, compared


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--iterations", type=int, default=2)
    ap.add_argument("--lanes", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("lane_bisect: needs a CUDA card")
    sys.path.insert(0, os.path.abspath(args.tree))
    cs = hb.cs
    from slam_eds_tpu_torch import eval as ev
    from slam_eds_tpu_torch.ops import event_tracker as et
    dev = cs.phase_device()
    cs.build_kernels()
    run = cs.run_event_cell(dev, cs.eds_config())
    B = args.lanes
    states, efs, pts, _ = cs.event_lanes(run, B)
    pipe = run["pipe"]
    with Recorder(dev) as rec:
        got = ev.batched_event_solves(
            states, efs, pipe.cam, *(torch.stack([a] * B) for a in pts),
            max_iterations=args.iterations, loss_scale=pipe.loss_scale)
    batched = rec.ops
    for b in range(B):
        with Recorder(dev) as rec:
            if hasattr(et, "_lm_solve_plain"):
                want = et._lm_solve_plain(
                    pipe.tracker_state, efs[b], pipe.cam, *pts,
                    args.iterations, "huber", pipe.loss_scale, 1e-6, False)
            else:
                want = et.optimize(pipe.tracker_state, efs[b], pipe.cam,
                                   *pts, max_iterations=args.iterations,
                                   loss_scale=pipe.loss_scale)
        parting, compared = first_parting(rec.ops, batched, b, B)
        lane = ev._lane(got, b)
        print(json.dumps({
            "tree": os.path.basename(os.path.abspath(args.tree)),
            "lane": b, "iterations": args.iterations,
            "usable": "".join("u" if u else "x" for u in run["usable"]),
            "single_ops": len(rec.ops), "batched_ops": len(batched),
            "ops_compared": compared, "first_parting": parting,
            "pose_gap": {n: float((getattr(lane.state, n)
                                   - getattr(want.state, n)).abs().max())
                         for n in ("px", "qx", "vx")}}), flush=True)
    print(cs.gpu_name_and_power_limit())


if __name__ == "__main__":
    main()
