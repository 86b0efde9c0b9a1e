"""A tiny cell (128x96, small capacities, one short sequence) that the CPU
tests drive through the harness with the program's plain versions."""
import json
from pathlib import Path

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]

SETTINGS = {
    "caps": {"max_points_per_kf": 512, "max_immature_per_kf": 512,
             "max_window_frames": 6, "max_events": 8192},
    "bundles": {"window_size": 4, "min_frames": 3},
    "coarse": {"pyr_levels": 4, "max_iterations": [10, 20, 30, 30]},
    "selector": {"desired_immature_density": 400.0,
                 "desired_point_density": 300.0},
    "event_frame": {"num_levels": 2, "events_per_frame": 8192},
    "tracker": {"max_iterations": [15, 10], "kf_flow_threshold": 1.0},
}
CONFIG = {"camera": {"fx": 110.0, "fy": 110.0, "cx": 63.5, "cy": 47.5,
                     "width": 128, "height": 96},
          "settings": SETTINGS}
TRAFFIC = {"events": True, "frames_per_sequence": 12,
           "events_per_packet": 8192, "motion_scale": 0.35,
           "micro_steps": 4, "contrast_threshold": 0.08,
           "sequences": [7],
           "check": {"track": [1.0, 3], "ba": [1.0, 2], "packet": [1.0, 3]},
           "profile": {"start_frame": 4, "min_frames": 3, "max_frames": 8}}


def cell(events=True):
    bench = harness.load_benchmark(ROOT)
    name = ("eds_640x480.events65k" if events
            else "eds_640x480.frames")
    real = harness.resolve_cell(bench, name, ROOT)
    traffic = dict(TRAFFIC, events=events)
    return harness.Cell("tiny", 1, json.loads(json.dumps(CONFIG)), traffic,
                        real.end_to_end, real.per_layer)
