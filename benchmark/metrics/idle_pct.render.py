"""Share of the traced window in which no kernel and no copy runs on the
device."""


def read(trace, record):
    if trace is None or not trace.device:
        return None
    w = trace.span("bench.window")
    if w is None:
        return None
    busy = trace.busy_ns(w.start, w.end) / max(trace.devices, 1)
    return 100.0 * (1.0 - busy / (w.end - w.start))
