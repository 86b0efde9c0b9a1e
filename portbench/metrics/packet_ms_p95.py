"""The 95th percentile of every packet call's host latency in the window
(the call to its ``torch.cuda.synchronize()``), in ms."""
import numpy as np


def read(rec):
    ms = [p["ms"] for p in rec["packets"]]
    return float(np.percentile(ms, 95)) if ms else None
