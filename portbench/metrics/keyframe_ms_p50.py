"""The median host milliseconds of the program's ``keyframe`` span (the
frame pipeline's ``_add_keyframe``: insertion, tracing, activation, the
window BA, marginalization, the template rebuild), from the program's own
spans; nothing where the run kept none."""
from portbench import program_spans as ps


def read(rec):
    return ps.median(ps.durations_ms(rec, "keyframe"))
