"""Share of the window's device kernel time spent in matrix-product and FFT
kernels, matched by kernel name. In the per-block engine these are the leaf
DFTs of the four-step block transforms and their inverses; their twiddles
and transposes, and the partition MAC, are fusions and count against."""

import re

TRANSFORM = re.compile(r"gemm|xmma|cutlass|cublas|splitkreduce|fft", re.IGNORECASE)


def read(trace, record):
    if trace is None:
        return None
    w = trace.span("bench.window")
    if w is None:
        return None
    kernels = trace.events_in(w.start, w.end, kernels_only=True)
    total = sum(e.end - e.start for e in kernels)
    if total == 0:
        return None
    hit = sum(e.end - e.start for e in kernels if TRANSFORM.search(e.name))
    return 100.0 * hit / total
