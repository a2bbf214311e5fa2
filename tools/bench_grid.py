"""Reference-parity benchmark grid (SURVEY §6 measurement machinery).

Mirrors the reference's partitioned-convolver benchmark grid
(``/root/reference/extra/benchmark/src/convolution.cpp:42-64``): block
4096, filter lengths swept 2^11..2^17, items/s (samples) and bytes/s
counters per engine — batched channels, per-card rates, streaming through
the four-step transform and the partition MAC.

Partition counts are the REAL ceil(L / block) — no padding floor — so the
sweep varies actual MAC work and ``bytes_per_sec`` reflects the traffic
the configuration truly moves (the FDL read per block, the hot term).

Writes BENCH_GRID.json. Needs a GPU:  python tools/bench_grid.py
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

BLOCK = 4096
CHANNELS = 64
FILTERS = [1 << e for e in range(11, 18)]  # reference: 2^11..2^17
NB = 512  # blocks per timing stream


def main() -> int:
    import jax
    import jax.numpy as jnp

    from neojax.bench.env import gpu_info, setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"needs a GPU; JAX found {jax.default_backend()!r}", file=sys.stderr)
        return 1

    from neojax.conv import convolver as cv

    rng = np.random.default_rng(0)
    # Signal generated on the device (no 512 MB host->device upload).
    sig = jax.jit(
        lambda: jax.random.uniform(
            jax.random.PRNGKey(0), (CHANNELS, NB * BLOCK), jnp.float32, -1, 1
        )
    )()
    jax.block_until_ready(sig)
    grid = {}
    for storage in ("split", "bf16"):
        for L in FILTERS:
            p = max(1, -(-L // BLOCK))
            parts = (
                (
                    rng.standard_normal((1, p, BLOCK + 1))
                    + 1j * rng.standard_normal((1, p, BLOCK + 1))
                )
                * 0.05
            ).astype(np.complex64)
            cfg = cv.PartitionedConfig(BLOCK, p, CHANNELS, storage=storage)
            params = cv.filter_params(cfg, parts)
            state = cv.init_state(cfg)
            proc = jax.jit(partial(cv.process, cfg), donate_argnums=(1,))
            st, out = jax.block_until_ready(proc(params, state, sig))
            ts = []
            for _ in range(2):
                t0 = time.perf_counter()
                st, out = jax.block_until_ready(proc(params, st, sig))
                ts.append(time.perf_counter() - t0)
            dt = min(ts)
            sps = CHANNELS * NB * BLOCK / dt
            # reference items/s + bytes/s taxonomy (convolution.cpp:42-44):
            # bytes = the per-block FDL read (2 planes x P x C x B lanes),
            # computed from the REAL partition count.
            itemsize = {"split": 4, "bf16": 2}[storage]
            bytes_moved = NB * (2 * p * CHANNELS * BLOCK * itemsize)
            grid[f"upols/{storage}/L{L}"] = {
                "samples_per_sec": round(sps, 1),
                "bytes_per_sec": round(bytes_moved / dt, 1),
                "us_per_block": round(dt / NB * 1e6, 1),
                "partitions": p,
                "fourstep_transform": cv._use_fourstep_stream(cfg),
            }
            print(f"# upols/{storage}/L{L}: {sps/1e6:.1f} M samples/s "
                  f"({dt/NB*1e6:.1f} us/block, P={p})", file=sys.stderr)

    out = {
        "metric": "partitioned_conv_grid_block4096",
        "gpu": gpu_info(),
        "device_kind": jax.devices()[0].device_kind,
        "channels": CHANNELS,
        "block": BLOCK,
        "grid": grid,
    }
    print(json.dumps(out))
    with open("BENCH_GRID.json", "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
