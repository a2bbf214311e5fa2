"""Median host time from calling the stream to its return, before the
fetch: the enqueue of the head step (and of the tail refresh, in every S-th
callback). Host clock, over the window's callbacks. Per-layer metrics are
read in traced runs, where the profiler's device tracer slows each launch:
compare it with traced runs only, never with the untraced latency."""

import numpy as np


def read(trace, record):
    d = [c.returned - c.start for c in record["window"].calls if c.ok]
    return float(np.median(d) * 1e6) if d else None
