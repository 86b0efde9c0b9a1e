"""Synchronising CUDA calls per frame call (counted under sync debug
"warn" around each frame call of the traced run)."""


def read(rec):
    n = [f["syncs"] for f in rec["frames"] if f["syncs"] is not None]
    return sum(n) / len(n) if n else None
