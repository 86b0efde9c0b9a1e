#!/usr/bin/env python3
"""The event cell's usable verdicts of several checkouts, packet by packet,
against the JAX package's and the cell's horizon, on the card.

For each ``--tree DIR`` (a checkout of this repo, e.g. one unpacked with
``git archive``), in a process of its own with DIR as its working
directory:

1. that checkout's own ``chip_smoke.py`` builds its kernels and runs its
   event phase first in the process, ``phase_eds(dev, label="eds-first")``
   (its phase line is passed through as it prints it; a check of that
   phase that fails is reported, not raised);
2. this checkout's ``runner_reference.cell_event`` runs the event cell
   again through that checkout's package on the card, with the per-frame
   record (``frame_record``: counts, the frame pose's drift from SO(3)
   and its position after each frame).

Then prints one JSON line: each tree's usable string from both runs, the
JAX package's (``chip_smoke.JAX_CPU_EDS_BY_FRAME`` of this checkout), the
horizon H (the last frame at which JAX's drift is within
``runner_reference.DRIFT_LIMIT``), and every packet at which a tree parts
from JAX or from the tree before it: the packet (it runs after frame k and
ends at frame k + 1), whether it ends by H, and the drift of the tree and
of JAX at frame k + 1.

    python3 tools/tree_event_cells.py --tree trees/cc840de \\
        --tree trees/e803137 --tree .

About a minute per tree on an H100 (its kernels' builds included).
"""
import argparse
import json
import os
import subprocess
import sys
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def child(tree):
    """Steps 1 and 2 in this process, the tree's modules first on the
    path; prints the recorded run's line last."""
    tree = os.path.abspath(tree)
    sys.path[:0] = [tree, HERE]
    import torch
    import chip_smoke as smoke
    import runner_reference as rr
    error = None
    with torch.inference_mode():
        dev = smoke.phase_device()
        smoke.build_kernels()
        if hasattr(smoke, "record_loops"):
            smoke.record_loops()
        try:
            smoke.phase_eds(dev, label="eds-first")
        except Exception:
            error = traceback.format_exc().strip().splitlines()[-1]
        from slam_eds_tpu_torch import config
        from slam_eds_tpu_torch.io import dataset
        from slam_eds_tpu_torch.models import pipeline
        out = rr.cell_event("port", config, dataset, pipeline,
                            smoke.smoke_camera(), {"device": "cuda"},
                            per_frame=True)
    out["smoke_error"] = error
    print(json.dumps({"recorded": out}), flush=True)


def lines(stdout):
    """The JSON lines of a child's output, by their first key's value."""
    rows = {}
    for line in stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if isinstance(row, dict):
            rows[row.get("phase", next(iter(row), None))] = row
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to run (repeat, in order)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    sys.path[:0] = [ROOT, HERE]
    import runner_reference as rr
    from chip_smoke import JAX_CPU_EDS_BY_FRAME as jax_ref
    H = rr.horizon(jax_ref["drift"])
    trees = []
    for tree in args.tree:
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", os.path.abspath(tree)], cwd=tree,
                           capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        rows = lines(p.stdout)
        rec = rows.get("recorded", {}).get("recorded")
        if p.returncode != 0 or rec is None:
            sys.stderr.write(p.stderr[-4000:])
            sys.exit(f"tree {tree}: exit {p.returncode}")
        trees.append({"tree": tree,
                      "smoke_usable": rows.get("eds-first", {}).get(
                          "usable_by_packet"),
                      "smoke_error": rec.pop("smoke_error"),
                      "recorded_usable": rec["usable_by_packet"],
                      "drift": rec["by_frame"]["drift"],
                      "counts": {c: rec["by_frame"][c] for c in rr.COUNTS}})

    def parts(a, b, drift_a, drift_b):
        return [{"packet": k, "ends_at_frame": k + 1,
                 "by_horizon": k + 1 <= H, "verdicts": [a[k], b[k]],
                 "drift": [drift_a[k + 1], drift_b[k + 1]]}
                for k in range(min(len(a), len(b))) if a[k] != b[k]]
    out = {"horizon": H, "jax_usable": jax_ref["usable"], "trees": []}
    for i, t in enumerate(trees):
        row = {k: t[k] for k in ("tree", "smoke_usable", "smoke_error",
                                 "recorded_usable")}
        row["parts_from_jax"] = parts(t["recorded_usable"], jax_ref["usable"],
                                      t["drift"], jax_ref["drift"])
        if i:
            prev = trees[i - 1]
            row["parts_from_previous"] = parts(
                t["recorded_usable"], prev["recorded_usable"], t["drift"],
                prev["drift"])
        row["counts_at_horizon"] = {c: v[H] for c, v in t["counts"].items()}
        out["trees"].append(row)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
