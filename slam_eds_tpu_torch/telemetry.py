"""Structured runtime telemetry — port of ``slam_eds_tpu.telemetry``:
counters, wall-clock timers (``tic`` / ``toc`` / ``rate``) and
``profile_trace``, a device trace through ``torch.profiler``."""
from __future__ import annotations

import os
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Telemetry:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    sums: dict = field(default_factory=lambda: defaultdict(float))
    _t0: dict = field(default_factory=dict)

    def tic(self, name: str):
        self._t0[name] = time.perf_counter()

    def toc(self, name: str):
        dt = time.perf_counter() - self._t0.pop(name)
        self.counters[f"{name}_n"] += 1
        self.sums[f"{name}_s"] += dt
        return dt

    def event_solve(self, n_iter: int, energy: float):
        """TrackerInfo equivalent: one usable event solve."""
        self.counters["event_solves"] += 1
        self.counters["event_iters"] += n_iter
        self.sums["event_energy"] = energy

    def ba(self, energy: float):
        """PBAInfo equivalent."""
        self.counters["ba_runs"] += 1
        self.sums["ba_energy"] = energy

    def frame(self, ok: bool):
        self.counters["frames"] += 1
        if not ok:
            self.counters["track_failures"] += 1

    def rate(self, name: str):
        n = self.counters.get(f"{name}_n", 0)
        s = self.sums.get(f"{name}_s", 0.0)
        return n / s if s > 0 else 0.0

    def summary(self) -> dict:
        out = dict(self.counters)
        out.update({k: round(v, 6) for k, v in self.sums.items()})
        return out


class profile_trace:
    """Context manager around ``torch.profiler.profile`` (CPU activity, and
    CUDA when a card is present): on exit a Chrome trace, viewable in
    Perfetto or chrome://tracing, is written to ``<log_dir>/trace.json``
    (``self.path``); ``self.prof`` keeps the profiler for
    ``key_averages()``.

        with telemetry.profile_trace("trace_dir"):
            pipe.process_events(packet)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = os.path.join(log_dir, "trace.json")
        self.prof = None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.log_dir, exist_ok=True)
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.prof.export_chrome_trace(self.path)
        return False
