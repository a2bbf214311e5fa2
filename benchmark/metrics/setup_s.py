"""Set-up time: from the start of the run to the start of the window
(JAX and CUDA start, the IRs and filter from the seed, compilation or its
cache, the warm-up calls)."""


def read(trace, record):
    return record["setup_s"]
