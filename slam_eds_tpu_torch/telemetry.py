"""Runtime telemetry of the port: the pipelines' counters (``Telemetry``,
port of ``slam_eds_tpu.telemetry``'s) and ``TRACE``, the process's tracer
of host spans and of the device time of every captured-program replay.

``TRACE`` is off by default; ``enable()`` / ``disable()`` switch it.

* ``TRACE.span(name)`` is a context manager around one piece of work. Off,
  it is one shared no-op context (one attribute check, no allocation, no
  clock read). On, it records a ``Span``: its name, the index of the span
  open around it (``-1`` at an entry call), the index of its entry call's
  span (every span of one ``process_frame`` or ``process_events`` call
  shares it) and its start and end in wall-clock nanoseconds
  (``time.time_ns()``, the clock a device trace's ``baseTimeNanoseconds``
  is on). ``traced(name)`` is the same as a decorator.
* While on, ``graphs.GraphCache.run`` records two CUDA events around each
  replay (``device_event``: one after the input copy, one after the
  replay, on the replay's stream) and pairs them with the replay's span
  (``time_replay``).
  ``collect()``, after the caller's ``torch.cuda.synchronize()``, resolves
  them to device milliseconds; nothing is read while the program runs.

Nothing is written out: the caller takes ``TRACE.spans`` and
``collect()`` and clears them. One thread records spans (the one that
calls the pipelines)."""
from __future__ import annotations

import functools
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import NamedTuple

import torch


@dataclass
class Telemetry:
    counters: dict = field(default_factory=lambda: defaultdict(int))

    def event_solve(self, n_iter: int):
        """TrackerInfo equivalent: one usable event solve."""
        self.counters["event_solves"] += 1
        self.counters["event_iters"] += n_iter

    def ba(self):
        """PBAInfo equivalent."""
        self.counters["ba_runs"] += 1

    def frame(self):
        self.counters["frames"] += 1

    def summary(self) -> dict:
        return dict(self.counters)


class Span(NamedTuple):
    name: str
    parent: int      # index of the span open around it, -1 at an entry call
    call: int        # index of its entry call's span
    t0_ns: int
    t1_ns: int       # -1 while open


class Replay(NamedTuple):
    span: int        # index of its ``replay.<program>`` span
    ms: float        # device milliseconds from the input copy's end


class _Off:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def _cuda_event():
    return torch.cuda.Event(enable_timing=True)


class Trace:
    def __init__(self):
        self.on = False
        self.spans: list[Span] = []
        # (span index, start event, end event) of each replay, unresolved
        self.pending: list = []
        self._open: list[int] = []
        # makes the device events; a test may put a stand-in here
        self.new_event = _cuda_event

    def enable(self):
        """Clear what was recorded and start recording."""
        self.clear()
        self.on = True

    def disable(self):
        """Stop recording; what was recorded stays until ``clear``."""
        self.on = False

    def clear(self):
        self.spans, self.pending, self._open = [], [], []

    def span(self, name: str):
        if not self.on:
            return _OFF
        spans, stack = self.spans, self._open
        i = len(spans)
        if stack:
            parent = stack[-1]
            spans.append(Span(name, parent, spans[parent][2], time.time_ns(),
                              -1))
        else:
            spans.append(Span(name, -1, i, time.time_ns(), -1))
        stack.append(i)
        return self

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        if self._open:
            i = self._open.pop()
            name, parent, call, t0, _ = self.spans[i]
            self.spans[i] = Span(name, parent, call, t0, time.time_ns())
        return False

    def current(self):
        """Index in ``spans`` of the innermost open span, or None."""
        return self._open[-1] if self._open else None

    def device_event(self, stream=None):
        """A timing event recorded on ``stream`` (the current stream by
        default; a caller recording two passes the stream it looked up once:
        the lookup costs more than the record)."""
        e = self.new_event()
        e.record(stream)
        return e

    def time_replay(self, start, end):
        """Pair a replay's two events with the innermost open span."""
        self.pending.append((self.current(), start, end))

    def collect(self) -> list[Replay]:
        """The device milliseconds of every replay recorded since the last
        ``collect``, after the caller has synchronised the device."""
        out = [Replay(i, float(a.elapsed_time(b)))
               for i, a, b in self.pending]
        self.pending = []
        return out


def traced(name: str):
    """Decorator: each call runs inside ``TRACE.span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not TRACE.on:
                return fn(*args, **kwargs)
            with TRACE.span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


# the process's tracer, which the pipelines and ``graphs`` record into
TRACE = Trace()
