"""The 95th percentile of every frame call's host latency in the window
(the call to its ``torch.cuda.synchronize()``), in ms."""
import numpy as np


def read(rec):
    ms = [f["ms"] for f in rec["frames"]]
    return float(np.percentile(ms, 95)) if ms else None
