"""The median device milliseconds of the packet program's replays
(``replay.event_packet``: the event frame, the gate's rungs and the event
LM's WHILE passes, timed by the program's CUDA events); nothing where the
run kept none."""
from portbench import program_spans as ps


def read(rec):
    return ps.median(ps.replay_ms(rec, "replay.event_packet"))
