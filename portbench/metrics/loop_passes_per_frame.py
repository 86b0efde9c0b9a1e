"""Loop passes run on the device per frame call: the ``pass_tail`` launches
that ran (one per WHILE-node pass, the launch ledger's device counts) over
the window, per frame (with events, the packets' passes included)."""


def read(rec):
    ledger, frames = rec["ledger"], rec["frames"]
    if not ledger or not frames or "pass_tail" not in ledger:
        return None
    return ledger["pass_tail"]["run"] / len(frames)
