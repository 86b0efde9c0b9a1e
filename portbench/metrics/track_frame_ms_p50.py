"""The median host latency (ms) of the frame calls that made no keyframe:
coarse tracking alone."""
import statistics


def read(rec):
    ms = [f["ms"] for f in rec["frames"] if not f["kf"]]
    return statistics.median(ms) if ms else None
