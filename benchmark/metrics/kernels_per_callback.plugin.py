"""Median count of device kernels (copies excluded) in an ordinary
callback's interval: the launches of one head step. An exact count."""

import numpy as np


def read(trace, record):
    if trace is None or not trace.device:
        return None
    refresh = {c.index for c in record["window"].calls if c.refresh}
    counts = [len(trace.events_in(lo, hi, kernels_only=True))
              for j, (lo, hi) in trace.call_intervals().items() if j not in refresh]
    return float(np.median(counts)) if counts else None
