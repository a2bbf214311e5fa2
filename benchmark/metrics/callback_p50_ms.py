"""Median callback latency over every callback of the window, from its
due time to its output block in host memory."""

import numpy as np


def read(trace, record):
    lat = [c.done - c.due for c in record["window"].calls]
    return float(np.quantile(lat, 0.5) * 1e3) if lat else None
