#!/usr/bin/env python3
"""Does the event cell's outcome depend on what ran before it in the process?

Runs ``chip_smoke.py``'s event cell (``EDSPipeline``, 32 frames of the
bench_e2e sequence, 65,536-event packets) first in the process, then the
smoke's other phases (sampler, BA, frame pipeline, raster), then the event
cell again, and compares the two runs packet by packet: the usable flag, a
digest of the tracker state and the pose.

``--trace`` records, for every aten op the two runs issue (and every launch
of the port's two kernels), the op, the line of the port that issued it and
a digest of its output bits (integer-weighted sums on the card; outputs of
``empty*`` ops and views are not digested), and reports the first step
(frame or packet) and the first op in it where the runs part.

``--deterministic`` sets ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and ``torch.utils.deterministic.fill_uninitialized_memory``
first; its warnings name the nondeterministic ops the path runs.

Each run makes its own inputs. Without a CUDA device it exits 1. Imports no
JAX.

    python3 tools/history_bisect.py [--trace] [--deterministic] [--out f.json]
"""
import argparse
import hashlib
import inspect
import json
import sys
import time
import warnings
from collections import Counter
from pathlib import Path

import numpy as np
import torch
import torch.utils.deterministic  # noqa: F401
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

ROOT = Path.cwd()
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

PKG = "slam_eds_tpu_torch"
INT_OF = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _bits(t):
    x = t.detach()
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous().reshape(-1)
    return x.view(INT_OF[x.element_size()]).to(torch.int64)


class Recorder(TorchDispatchMode):
    """Per op: (op name id, source line id, output digest as a 0-d tensor
    on the op's device)."""

    def __init__(self, dev):
        super().__init__()
        self.dev = dev
        self.names, self.locs = {}, {}
        self.step = []
        self.steps = []            # (label, names [n], locs [n], digests [n])
        self.busy = False
        self._w = {}

    def _weights(self, n, dev):
        w = self._w.get(dev)
        if w is None or w.numel() < n:
            size = max(n, 1 << 23)
            w = (torch.arange(size, dtype=torch.int64, device=dev) % 1000003
                 ) * 2654435761 + 1
            self._w[dev] = w
        return w[:n]

    def digest(self, tensors):
        d = None
        for t in tensors:
            b = _bits(t)
            h = (b * self._weights(b.numel(), b.device)).sum().to(
                self.dev)
            d = h if d is None else d * 31 + h
        return d

    def _loc(self):
        f = sys._getframe(2)
        while f is not None and PKG not in f.f_code.co_filename:
            f = f.f_back
        if f is None:
            return "-"
        path = f.f_code.co_filename
        return f"{path[path.rindex(PKG):]}:{f.f_lineno}:{f.f_code.co_name}"

    def _id(self, table, key):
        return table.setdefault(key, len(table))

    def record(self, name, outs):
        d = self.digest(outs) if outs else None
        self.step.append((self._id(self.names, name),
                          self._id(self.locs, self._loc()), d))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.busy:
            return out
        name = str(func)
        rets = func._schema.returns
        alias = rets and rets[0].alias_info is not None \
            and not rets[0].alias_info.is_write
        outs = [] if ("empty" in name or alias) else [
            t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.busy = True
        try:
            self.record(name, outs)
        finally:
            self.busy = False
        return out

    def flush(self, label):
        torch.cuda.synchronize()
        names = np.array([s[0] for s in self.step], np.int64)
        locs = np.array([s[1] for s in self.step], np.int64)
        dig = np.zeros(len(self.step), np.int64)
        live = [i for i, s in enumerate(self.step) if s[2] is not None]
        if live:
            dig[live] = torch.stack([self.step[i][2] for i in live]).cpu(
            ).numpy()
        self.steps.append((label, names, locs, dig))
        self.step = []


def wrap_kernels(rec):
    """Record each launch of the port's kernels as a pseudo-op."""
    from slam_eds_tpu_torch.ops.kernels import pattern_sample as ps
    from slam_eds_tpu_torch.ops.kernels import rasterize as rz
    for mod, name in ((ps, "pattern_sample_cuda"),
                      (rz, "rasterize_bilinear_cuda")):
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            out = _fn(*a, **k)
            rec.busy = True
            try:
                rec.record(f"kernel::{_name}",
                           list(out) if isinstance(out, tuple) else [out])
            finally:
                rec.busy = False
            return out
        setattr(mod, name, wrapped)


def tensor_digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def inputs_digest(frames, packets):
    h = hashlib.sha256()
    for _, img in frames:
        h.update(img.cpu().numpy().tobytes())
    for p in packets:
        for a in (p.xs, p.ys, p.ts, p.polarity):
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def run_cell(dev, rec=None, inputs=None):
    """One event cell; returns its per-packet record."""
    from slam_eds_tpu_torch.models.pipeline import EDSPipeline
    cam, seq, frames, packets = inputs or cs.eds_inputs(dev)

    def step(label, fn):
        if rec is None:
            return fn()
        with rec:
            out = fn()
        rec.flush(label)
        return out

    pipe = step("init", lambda: EDSPipeline(cam, cs.eds_config(), device=dev))
    packets_out = []
    for k, (t, img) in enumerate(frames):
        step(f"frame {k}", lambda: pipe.process_frame(img, t))
        if k + 1 < len(frames) and pipe.kf is not None:
            T = step(f"packet {k}", lambda: pipe.process_events(packets[k]))
            st = pipe.tracker_state
            packets_out.append({
                "packet": k, "usable": T is not None,
                "state": tensor_digest(st),
                "t": None if T is None else T.inverse().t.cpu().tolist(),
                "R": None if T is None else T.R.cpu().reshape(-1).tolist()})
    fp = pipe.frame_pipe
    return {"inputs": inputs_digest(frames, packets),
            "usable": "".join("u" if p["usable"] else "x"
                              for p in packets_out),
            "event_kfs": pipe.num_event_kfs,
            "keyframes": fp.window.next_id,
            "marginalized": fp.window.marg_count,
            "counters": dict(pipe.telemetry.counters),
            "frame_counters": dict(fp.telemetry.counters),
            "packets": packets_out}


def other_phases(dev):
    """chip_smoke's phases between its two event-cell runs (its raster
    phase takes the packets or makes its own, as the checkout has it)."""
    cs.phase_kernel(dev)
    cs.phase_ba(dev)
    cs.phase_pipeline(dev)
    if len(inspect.signature(cs.phase_kernel_raster).parameters) == 2:
        cs.phase_kernel_raster(dev, cs.eds_inputs(dev)[3])
    else:
        cs.phase_kernel_raster(dev)


def compare_runs(a, b):
    out = {"same_inputs": a["inputs"] == b["inputs"],
           "usable": [a["usable"], b["usable"]],
           "counts": {k: [a[k], b[k]] for k in
                      ("event_kfs", "keyframes", "marginalized")}}
    first = None
    dmax = 0.0
    for pa, pb in zip(a["packets"], b["packets"]):
        same = (pa["usable"] == pb["usable"] and pa["state"] == pb["state"])
        if pa["t"] and pb["t"]:
            d = float(np.max(np.abs(np.subtract(pa["t"] + pa["R"],
                                                pb["t"] + pb["R"]))))
            dmax = max(dmax, d)
            same = same and d == 0.0
        if not same and first is None:
            first = {"packet": pa["packet"], "a": pa, "b": pb}
    out["first_packet_apart"] = first
    out["max_pose_diff"] = dmax
    return out


def compare_traces(ra, rb, limit=8):
    """The first step and op where two traces part."""
    names = {v: k for k, v in ra.names.items()}
    locs = {v: k for k, v in ra.locs.items()}
    names_b = {v: k for k, v in rb.names.items()}
    locs_b = {v: k for k, v in rb.locs.items()}
    for (la, na, ca, da), (lb, nb, cb, db) in zip(ra.steps, rb.steps):
        sa = [names[i] for i in na]
        sb = [names_b[i] for i in nb]
        la_ = [locs[i] for i in ca]
        lb_ = [locs_b[i] for i in cb]
        n = min(len(sa), len(sb))
        for i in range(n):
            if sa[i] != sb[i] or la_[i] != lb_[i] or da[i] != db[i]:
                apart = []
                for j in range(i, n):
                    if da[j] != db[j] or sa[j] != sb[j]:
                        apart.append({"op_index": j, "op": [sa[j], sb[j]],
                                      "line": [la_[j], lb_[j]]})
                    if len(apart) >= limit:
                        break
                return {"step": [la, lb], "op_index": i,
                        "ops_in_step": [len(sa), len(sb)],
                        "previous_op": (None if i == 0 else
                                        {"op": sa[i - 1], "line": la_[i - 1]}),
                        "first_ops_apart": apart}
        if len(sa) != len(sb) or la != lb:
            return {"step": [la, lb], "op_index": n,
                    "ops_in_step": [len(sa), len(sb)],
                    "note": "one step issued more ops"}
    return None


@torch.inference_mode()
def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--deterministic", action="store_true")
    ap.add_argument("--out", help="also write the result to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("history_bisect: needs a CUDA device")
    dev = torch.device("cuda:0")
    caught = []
    if args.deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = True
        warnings.simplefilter("always")
        warnings.showwarning = lambda m, *a, **k: caught.append(str(m)[:300])
    from slam_eds_tpu_torch.device import set_numerics
    set_numerics()
    cs.build_kernels()
    t0 = time.perf_counter()
    ra = rb = None
    if args.trace:
        ra, rb = Recorder(dev), Recorder(dev)
        from slam_eds_tpu_torch.ops.kernels import pattern_sample as ps
        from slam_eds_tpu_torch.ops.kernels import rasterize as rz
        plain = (ps.pattern_sample_cuda, rz.rasterize_bilinear_cuda)
        wrap_kernels(ra)
    first = run_cell(dev, ra)
    if args.trace:
        ps.pattern_sample_cuda, rz.rasterize_bilinear_cuda = plain
    t1 = time.perf_counter()
    other_phases(dev)
    t2 = time.perf_counter()
    if args.trace:
        wrap_kernels(rb)
    last = run_cell(dev, rb)
    t3 = time.perf_counter()
    result = {"gpu": cs.gpu_name_and_power_limit(),
              "deterministic": args.deterministic,
              "seconds": {"first": t1 - t0, "others": t2 - t1,
                          "last": t3 - t2},
              "first": {k: v for k, v in first.items() if k != "packets"},
              "last": {k: v for k, v in last.items() if k != "packets"},
              "compare": compare_runs(first, last)}
    if args.trace:
        result["trace"] = compare_traces(ra, rb)
        result["ops_traced"] = [sum(len(s[1]) for s in r.steps)
                                for r in (ra, rb)]
    if caught:
        result["warnings"] = Counter(caught).most_common(40)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1, default=str))
    print(json.dumps(result, default=str)[:20000])


if __name__ == "__main__":
    main()
