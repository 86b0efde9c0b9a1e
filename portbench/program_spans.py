"""The program's own spans read beside the benchmark's.

The port records, while its tracer (``slam_eds_tpu_torch.telemetry.
TRACE``) is on, a span per piece of a frame or packet call: ``(name,
parent, call, t0_ns, t1_ns)``, indices into its list, wall-clock
nanoseconds (the clock ``tracing._Span`` lays on a trace), and the device
milliseconds of each captured-program replay, ``(span, ms)``. What reads
them here takes them as arguments and imports nothing of the program:

* ``ProgramStretch``: ``tracing.Stretch`` whose idle gaps inside a program
  span go to ``<call kind>/<innermost span>`` (``keyframe_frame/
  keyframe.ba``); what no program span covers keeps the call's kind, and
  the gaps' total is the call-level total (``idle_gaps_by_call``).
* ``SpanReads``: ``tracing.counted_syncs`` that also notes, for each
  synchronising call, the innermost open program span.
* ``span_table``: per span name its count, total and self milliseconds
  (duration less its children's), host reads and replay device time.

The records a metric reads (``metrics/keyframe_ms_p50.py`` and the rest):
``rec["spans"]``, ``rec["replays"]``, ``rec["span_reads"]`` ({span index:
reads}) and ``rec["counted_calls"]`` (the entry calls whose reads were
counted); a run without them reads nothing.
"""
from __future__ import annotations

import bisect
import statistics
import warnings

import torch

from .tracing import DEVICE_CATS, Stretch, _gaps

NAME, PARENT, CALL, T0, T1 = range(5)


def _depths(spans) -> list:
    out = []
    for s in spans:
        out.append(0 if s[PARENT] < 0 else out[s[PARENT]] + 1)
    return out


def innermost_segments(spans, to_us):
    """The program spans' timeline cut where any span starts or ends:
    ``(starts, ends, names)`` of the pieces that some span covers, each
    named after the deepest span over it. ``to_us(ns)`` puts a time on the
    trace's clock."""
    if not spans:
        return [], [], []
    deep = _depths(spans)
    iv = [(to_us(s[T0]), to_us(s[T1]), d, s[NAME])
          for s, d in zip(spans, deep) if s[T1] >= s[T0]]
    cuts = sorted({t for a, b, _, _ in iv for t in (a, b)})
    starts, ends, names = [], [], []
    for u, v in zip(cuts, cuts[1:]):
        m = 0.5 * (u + v)
        best = None
        for a, b, d, name in iv:
            if a <= m < b and (best is None or d > best[0]):
                best = (d, name)
        if best is not None:
            starts.append(u)
            ends.append(v)
            names.append(best[1])
    return starts, ends, names


def split_by_program(a, b, segments):
    """{innermost span name or None: microseconds} of the interval
    [a, b]."""
    starts, ends, names = segments
    out, left = {}, b - a
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(starts) and starts[i] < b:
        o = min(b, ends[i]) - max(a, starts[i])
        if o > 0:
            out[names[i]] = out.get(names[i], 0.0) + o
            left -= o
        i += 1
    if left > 0:
        out[None] = out.get(None, 0.0) + left
    return out


class ProgramStretch(Stretch):
    """``program()`` gives the program's spans when the stretch stops (or
    ``stop`` takes them). After ``stop``: ``idle_gaps`` by
    ``<kind>/<innermost span>``, every label kept (their sum is the
    call-level breakdown's), ``idle_gaps_by_call`` the call-level
    breakdown, ``program_spans_laid`` the program spans on the trace."""

    def __init__(self, ledger=None, program=None):
        super().__init__(ledger)
        self.program = program
        self.idle_gaps_by_call = []
        self.program_spans_laid = 0
        self._program_spans = []

    def stop(self, labels=None, program_spans=None):
        if program_spans is None and self.program is not None:
            program_spans = list(self.program())
        self._program_spans = program_spans or []
        super().stop(labels)

    def _read(self, events, base_ns, labels, program_spans=None):
        if program_spans is None:
            program_spans = self._program_spans
        super()._read(events, base_ns, labels)
        self.idle_gaps_by_call = self.idle_gaps
        if not program_spans:
            return
        dev, calls = [], []
        for e in events:
            if e.get("ph") == "X" and e.get("cat", "") in DEVICE_CATS:
                ts = float(e.get("ts", 0.0))
                dev.append((ts, ts + float(e.get("dur", 0.0))))
        for name, t0, t1 in self.spans:
            calls.append(((t0 - base_ns) * 1e-3, (t1 - base_ns) * 1e-3,
                          labels.get(name, name.split(".")[0])))
        for e in events:
            name = e.get("name", "")
            if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                    and name.startswith("portbench."):
                ts, name = float(e.get("ts", 0.0)), name[len("portbench."):]
                calls.append((ts, ts + float(e.get("dur", 0.0)),
                              labels.get(name, name.split(".")[0])))
        if dev:
            lo_d = min(s for s, _ in dev)
            hi_d = max(e for _, e in dev)
            calls = [c for c in calls if c[1] > lo_d and c[0] < hi_d]
        if not calls:
            return
        lo = min(s for s, _, _ in calls)
        hi = max(e for _, e, _ in calls)
        lo_ns, hi_ns = lo * 1e3 + base_ns, hi * 1e3 + base_ns
        # the spans of the entry calls that reach into the stretch
        keep = {s[CALL] for s in program_spans
                if s[PARENT] < 0 and s[T1] > lo_ns and s[T0] < hi_ns}
        index = {}
        inside = []
        for i, s in enumerate(program_spans):
            if s[CALL] in keep:
                index[i] = len(inside)
                inside.append((s[NAME], index.get(s[PARENT], -1), s[CALL],
                               s[T0], s[T1]))
        self.program_spans_laid = len(inside)
        segments = innermost_segments(inside,
                                      lambda ns: (ns - base_ns) * 1e-3)
        by = {}
        for a, b in _gaps(dev, lo, hi):
            left = b - a
            for s, e, kind in calls:
                if min(b, e) - max(a, s) <= 0:
                    continue
                for name, o in split_by_program(max(a, s), min(b, e),
                                                segments).items():
                    label = kind if name is None else f"{kind}/{name}"
                    by[label] = by.get(label, 0.0) + o * 1e-6
                    left -= o
            if left > 0:
                by["between_calls"] = by.get("between_calls", 0.0) \
                    + left * 1e-6
        self.idle_gaps = sorted(([k, v] for k, v in by.items()),
                                key=lambda kv: -kv[1])


class SpanReads:
    """``counted(fn)`` is ``tracing.counted_syncs(fn)``: (``fn()``, the
    synchronising calls it made). Each call is also kept under
    ``trace.current()`` when it was made (``by_span``: {span index or
    None: reads}), and the entry call's span (the first span ``fn`` opened)
    in ``calls``. ``trace`` has the program tracer's ``spans`` and
    ``current()``."""

    def __init__(self, trace):
        self.trace = trace
        self.by_span = {}
        self.calls = []

    def counted(self, fn):
        prev = torch.cuda.get_sync_debug_mode()
        first = len(self.trace.spans)
        n = [0]

        def seen(message, *args, **kwargs):
            if "synchronizing" in str(message):
                n[0] += 1
                at = self.trace.current()
                self.by_span[at] = self.by_span.get(at, 0) + 1
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = fn()
            finally:
                torch.cuda.set_sync_debug_mode(prev)
        if len(self.trace.spans) > first:
            self.calls.append(first)
        return out, n[0]


def span_table(spans, replays=(), reads=None) -> dict:
    """{name: {"n", "ms", "self_ms", "reads", "device_ms"}} over the
    closed spans: their count, total and self milliseconds, the host reads
    made while one was the innermost open span, and the device time of the
    replays paired with them."""
    child = [0.0] * len(spans)
    for s in spans:
        if s[PARENT] >= 0 and s[T1] >= s[T0]:
            child[s[PARENT]] += s[T1] - s[T0]
    out = {}
    for i, s in enumerate(spans):
        if s[T1] < s[T0]:
            continue
        row = out.setdefault(s[NAME], {"n": 0, "ms": 0.0, "self_ms": 0.0,
                                       "reads": 0, "device_ms": 0.0})
        row["n"] += 1
        row["ms"] += (s[T1] - s[T0]) * 1e-6
        row["self_ms"] += (s[T1] - s[T0] - child[i]) * 1e-6
    for i, n in (reads or {}).items():
        if i is not None and spans[i][NAME] in out:
            out[spans[i][NAME]]["reads"] += n
    for i, ms in replays:
        if i is not None and spans[i][NAME] in out:
            out[spans[i][NAME]]["device_ms"] += ms
    return out


def durations_ms(rec, name):
    """Milliseconds of every closed ``name`` span in ``rec``, or None where
    the run kept no program spans."""
    spans = rec.get("spans")
    if not spans:
        return None
    return [(s[T1] - s[T0]) * 1e-6 for s in spans
            if s[NAME] == name and s[T1] >= s[T0]]


def replay_ms(rec, name):
    """Device milliseconds of every replay whose span is ``name``, or None
    where the run kept none."""
    spans, replays = rec.get("spans"), rec.get("replays")
    if not spans or not replays:
        return None
    return [ms for i, ms in replays
            if i is not None and spans[i][NAME] == name]


def median(values):
    return statistics.median(values) if values else None
