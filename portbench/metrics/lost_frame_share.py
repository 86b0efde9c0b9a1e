"""Share of frame calls, in percent, after which the pipeline's tracker
had lost the track or reset (its counters ``track_lost``,
``full_resets`` moved): the frame kept the last pose."""


def read(rec):
    f = rec["frames"]
    return 100.0 * sum(x["lost"] for x in f) / len(f) if f else None
