"""Share of packet calls, in percent, whose solve the gate rejected: a
keyframe was live and the call returned no pose."""


def read(rec):
    p = rec["packets"]
    return 100.0 * sum(x["rejected"] for x in p) / len(p) if p else None
