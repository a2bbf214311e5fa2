"""The per-block convolver's calls against their roofline: the least time
the configured partitioning needs for the window's calls (per call the
larger of its bytes over the card's HBM bandwidth and its FLOPs over the
f32 peak, ``peaks.upola_call_work``) over the device kernel time in the
window (the union of kernel events). The whole step's share, so it bounds
the share of any one kernel on the path."""

import sys

from benchmark import peaks
from benchmark.system import num_partitions


def read(trace, record):
    cfg = record["config"]
    if trace is None or cfg["engine"] != "perblock":
        return None
    w = trace.span("bench.window")
    win = record["window"]
    if w is None or not win.calls:
        return None
    busy = trace.busy_ns(w.start, w.end, kernels_only=True) * 1e-9
    if busy <= 0:
        return None
    nbytes, flops = peaks.upola_call_work(
        num_partitions(cfg), record["traffic"]["blocks_per_call"], cfg["channels"],
        cfg["ir_channels"], cfg["block_size"], cfg["storage"],
    )
    least, bound = peaks.roofline_seconds(nbytes, flops, peaks.peaks_for(record["device_kind"]))
    calls = len(win.calls)
    print(f"upola_roofline: {bound}-bound, least {least * 1e6:.2f} us per call "
          f"({nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP), device kernel time "
          f"{busy / calls * 1e6:.2f} us per call over {calls} calls ({record['card']})",
          file=sys.stderr)
    return 100.0 * least * calls / busy
