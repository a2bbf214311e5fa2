"""Render throughput: channels x output samples of every call of the
window, over the window, which ends when the last call's output is ready."""


def read(trace, record):
    win = record["window"]
    if not win.calls or win.seconds <= 0:
        return None
    cfg, traffic = record["config"], record["traffic"]
    samples = cfg["channels"] * traffic["blocks_per_call"] * cfg["block_size"]
    return samples * len(win.calls) / win.seconds
