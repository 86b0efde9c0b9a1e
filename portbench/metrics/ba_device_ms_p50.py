"""The median device milliseconds of the window BA's replays
(``replay.ba``: from the end of the input copy to the end of the replay,
timed by the program's CUDA events); nothing where the run kept none."""
from portbench import program_spans as ps


def read(rec):
    return ps.median(ps.replay_ms(rec, "replay.ba"))
