"""Frames completed over the window's seconds (host clock): every frame
call, each sequence's pipeline construction and, with events, every packet
call sit inside that time."""


def read(rec):
    if not rec["frames"] or rec["window_s"] <= 0:
        return None
    return len(rec["frames"]) / rec["window_s"]
