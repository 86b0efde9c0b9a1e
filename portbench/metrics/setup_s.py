"""Seconds from the process's start to the first timed call: imports, the
kernel libraries' build or load, the pool's render and the warm-up
sequence with its captures."""


def read(rec):
    return rec["setup_s"]
