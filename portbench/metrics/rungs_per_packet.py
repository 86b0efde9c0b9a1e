"""Rungs of the gate's retry ladder run per packet: 1 + the retries over
the packets (the event pipeline's counters ``event_retries``,
``event_packets``)."""


def read(rec):
    c = rec["counters"]
    n = c.get("event_packets", 0)
    return 1.0 + c.get("event_retries", 0) / n if n else None
