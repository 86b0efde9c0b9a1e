"""The median host milliseconds of the program's ``track`` span (the
motion try-list: each hypothesis's coarse track and its host read), from
the program's own spans; nothing where the run kept none."""
from portbench import program_spans as ps


def read(rec):
    return ps.median(ps.durations_ms(rec, "track"))
