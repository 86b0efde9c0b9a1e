"""Runtime counters — the counters part of ``slam_eds_tpu.telemetry``. Its
wall-clock timers and ``profile_trace`` (``jax.profiler``) have no
counterpart here; use ``torch.profiler`` directly."""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Telemetry:
    counters: dict = field(default_factory=lambda: defaultdict(int))
    sums: dict = field(default_factory=lambda: defaultdict(float))

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
