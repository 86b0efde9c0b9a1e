"""What the traced run (``--trace 1``) reads besides the host clock.

* ``counted_syncs(fn)``: the synchronising CUDA calls ``fn()`` makes,
  counted as the warnings ``torch.cuda.set_sync_debug_mode("warn")``
  raises (a device-to-host copy, ``item``, ``nonzero``, a stream
  synchronisation): the host reads of a call, measured, not tallied.
* ``Stretch``: ``torch.profiler`` (CUDA activity only, so that the host's
  eager work runs as it does untraced) over a short steady stretch of the
  run; the Chrome trace it writes to a temporary file is parsed for every
  device activity (kernels, copies, sets), and the benchmark's host spans
  (wall-clock nanoseconds around each call) are laid over it on the
  trace's own epoch base. Over long runs the profiler keeps fewer records
  of the kernels in a graph's WHILE bodies, so the stretch is kept short;
  its busy time is then a lower bound.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import warnings

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def counted_syncs(fn):
    """(``fn()``, the synchronising calls it made)."""
    prev = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(prev)
    return out, sum("synchronizing" in str(w.message) for w in seen)


def _union(intervals):
    total, end = 0.0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def _gaps(intervals, lo, hi):
    """The idle intervals in [lo, hi] between the device intervals."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(a, b) for a, b in out if b > a]


class Stretch:
    """``start()`` / ``stop()`` bound the profiled stretch; ``span(name)``
    marks a host span inside it. After ``stop()``: ``window_s`` (host
    wall of the stretch), ``busy_s`` (union of device activity),
    ``kernels`` {name: [device seconds per recorded launch]},
    ``device_ops`` [[name, seconds]] (the ten largest), ``idle_gaps``
    [[span kind, seconds]] (device-idle time by the host span it fell in,
    the ten largest)."""

    def __init__(self, ledger=None):
        # ``ledger()``: the program's launch counts ({kernel: (slots, run)}),
        # read at both ends of the stretch to count what the trace missed
        self.ledger = ledger
        self.ledger_runs = None
        self.prof = None
        self.window_s = self.busy_s = None
        self.kernels, self.device_ops, self.idle_gaps = {}, [], []
        self.spans = []
        self.spans_laid = 0

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._l0 = self.ledger() if self.ledger else None
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def span(self, name):
        return _Span(self.spans, name)

    def stop(self, labels=None):
        """``labels`` maps a span's name to its kind (default: the name
        up to its first dot)."""
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(None, None, None)
        if self._l0 is not None:
            l1 = self.ledger()
            self.ledger_runs = {k: r - self._l0.get(k, (0, 0))[1]
                                for k, (_, r) in l1.items()}
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.remove(path)
        self.prof = None
        self._read(trace.get("traceEvents", []),
                   int(trace.get("baseTimeNanoseconds", 0)), labels or {})

    def _read(self, events, base_ns, labels):
        """Device activity from the trace's events (``ts`` and ``dur`` in
        us after ``base_ns``), host spans from ``self.spans`` (wall-clock
        ns) and the trace's own ``user_annotation`` events."""
        dev, spans = [], []
        for name, t0, t1 in self.spans:
            spans.append(((t0 - base_ns) * 1e-3, (t1 - base_ns) * 1e-3,
                          labels.get(name, name.split(".")[0])))
        ops = {}
        for e in events:
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            cat, name = e.get("cat", ""), e.get("name", "")
            if cat in DEVICE_CATS:
                dev.append((ts, ts + dur))
                ops[name] = ops.get(name, 0.0) + dur * 1e-6
                if cat == "kernel":
                    self.kernels.setdefault(name, []).append(dur * 1e-6)
            elif cat == "user_annotation" and name.startswith("portbench."):
                name = name[len("portbench."):]
                spans.append((ts, ts + dur,
                               labels.get(name, name.split(".")[0])))
        self.busy_s = _union(dev) * 1e-6
        self.device_ops = sorted(([k, v] for k, v in ops.items()),
                                 key=lambda kv: -kv[1])[:10]
        if dev:
            lo_d = min(s for s, _ in dev)
            hi_d = max(e for _, e in dev)
            spans = [sp for sp in spans if sp[1] > lo_d and sp[0] < hi_d]
        self.spans_laid = len(spans)
        if not spans:
            return
        lo = min(s for s, _, _ in spans)
        hi = max(e for _, e, _ in spans)
        by = {}
        for a, b in _gaps(dev, lo, hi):
            left = b - a
            for s, e, kind in spans:
                o = min(b, e) - max(a, s)
                if o > 0:
                    by[kind] = by.get(kind, 0.0) + o * 1e-6
                    left -= o
            if left > 0:
                by["between_calls"] = by.get("between_calls", 0.0) \
                    + left * 1e-6
        self.idle_gaps = sorted(([k, v] for k, v in by.items()),
                                key=lambda kv: -kv[1])[:10]

    def kernel_times(self, substring):
        """Device seconds of each recorded launch of the kernels whose
        name holds ``substring``."""
        return [t for name, ts in self.kernels.items() if substring in name
                for t in ts]


class _Span:
    """A host span in wall-clock nanoseconds, appended on exit."""

    def __init__(self, out, name):
        self.out, self.name = out, name

    def __enter__(self):
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.out.append((self.name, self.t0, time.time_ns()))
        return False
