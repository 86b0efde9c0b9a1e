"""The event LM's iterations at the finest level per usable packet (the
event pipeline's counters ``event_iters`` over ``event_solves``)."""


def read(rec):
    c = rec["counters"]
    n = c.get("event_solves", 0)
    return c.get("event_iters", 0) / n if n else None
