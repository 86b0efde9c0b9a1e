"""Synchronising calls made inside the program's ``keyframe`` spans (in
the span or any span under it), per keyframe span, over the frame calls
whose reads were counted; nothing where the run kept no spans or counted
no keyframe call."""
from portbench import program_spans as ps


def read(rec):
    spans, reads = rec.get("spans"), rec.get("span_reads")
    calls = set(rec.get("counted_calls") or ())
    if not spans or reads is None:
        return None
    kfs = {i for i, s in enumerate(spans)
           if s[ps.NAME] == "keyframe" and s[ps.CALL] in calls}
    if not kfs:
        return None
    total = 0
    for i, n in reads.items():
        while i is not None and i >= 0 and i not in kfs:
            i = spans[i][ps.PARENT]
        if i is not None and i >= 0:
            total += n
    return total / len(kfs)
