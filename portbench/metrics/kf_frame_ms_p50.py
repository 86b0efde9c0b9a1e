"""The median host latency (ms) of the frame calls that made a keyframe
(the window's keyframe counter, ``WindowManager.next_id``, moved during
the call)."""
import statistics


def read(rec):
    ms = [f["ms"] for f in rec["frames"] if f["kf"]]
    return statistics.median(ms) if ms else None
