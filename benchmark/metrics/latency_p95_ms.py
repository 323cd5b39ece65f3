"""End to end: the 95th percentile, in ms, of the latency of every request
completed in the window (the call from its inputs to the wav on the host)."""

import numpy as np


def read(w):
    latencies = [r["latency_s"] for r in w.records if "latency_s" in r]
    return 1e3 * float(np.percentile(latencies, 95)) if latencies else None
