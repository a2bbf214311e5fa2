"""Quantify the time-sharded pipeline's warmup overhead on the GPU.

The sequence-parallel stream (``neojax.dist.timesharded``) gives each
device its predecessor's trailing P blocks as a ppermute halo and rebuilds
the FDL state with ONE batched forward transform + ring assembly
(``dist.timesharded._warmup``); scaling efficiency is about
m*t_step / (m*t_step + t_warmup) for m blocks per device.

Measured at the headline config (64 ch, 10 s IR => P=938, block 512):

  - t_step:    steady-state full-step time (sequential stream rate)
  - t_warmup:  the batched halo->state reconstruction, one call
  - t_insert:  the per-block insert-only step, for comparison
  - the halo size in bytes (P*B samples x channels x 4)

and writes TIMESHARD_BENCH.json with the per-device efficiency model for a
sweep of m. Needs a GPU: python tools/bench_timesharded.py

Reference semantics being distributed: the OLS carried window tail
(``src/neo/convolution/overlap_save.hpp:37-55``) and FDL history — the
halo is exactly that state's input preimage.
"""

from __future__ import annotations

import json
import os
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def bench_device(storage: str = "bf16") -> dict:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from neojax.conv import convolver as cv

    B, C = 512, 64
    P = int(np.ceil(10.0 * 48000 / B))  # 938
    cfg = cv.PartitionedConfig(B, P, C, storage=storage)
    rng = np.random.default_rng(0)
    parts = (
        rng.standard_normal((1, P, cfg.num_bins))
        + 1j * rng.standard_normal((1, P, cfg.num_bins))
    ).astype(np.complex64) * 0.05
    params = cv.filter_params(cfg, parts)
    state = cv.init_state(cfg)

    nb = 400
    sig = jnp.asarray(rng.uniform(-1, 1, (C, nb * B)), jnp.float32)

    def timed(fn, st, sig):
        """fn(params?, state, sig) -> (state, out-ish); donation-safe: the
        returned state is threaded into the next call."""
        st, out = jax.block_until_ready(fn(st, sig))
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            st, out = jax.block_until_ready(fn(st, sig))
            ts.append(time.perf_counter() - t0)
        return min(ts) / nb

    proc = jax.jit(partial(cv.process, cfg), donate_argnums=(1,))
    t_step = timed(lambda st, sg: proc(params, st, sg), state, sig)

    @jax.jit
    def warm(state, sig):
        blocks = jnp.moveaxis(sig.reshape(C, nb, B), 1, 0)

        def body(carry, blk):
            return cv.insert_only_step(cfg, carry, blk), None

        state, _ = lax.scan(body, state, blocks)
        return state, state["fdl"]

    t_insert = timed(warm, cv.init_state(cfg), sig)

    # The batched warmup: one call reconstructing the full state from a
    # [C, P*B] halo (what each device actually runs).
    from neojax.dist import timesharded as ts

    halo = jnp.asarray(rng.uniform(-1, 1, (C, P * B)), jnp.float32)

    @jax.jit
    def warm_batched(halo):
        st = ts._warmup(cfg, params, halo)
        return jax.tree.leaves(st["fdl"])[0]

    jax.block_until_ready(warm_batched(halo))
    tws = []
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(warm_batched(halo))
        tws.append(time.perf_counter() - t0)
    t_warm = min(tws)

    halo_bytes = C * P * B * 4
    sweep = {}
    for m in [P, 2 * P, 4 * P, 16 * P, 64 * P]:
        eff = m * t_step / (m * t_step + t_warm)
        sweep[str(m)] = round(eff, 4)
    return {
        "config": {"block": B, "channels": C, "partitions": P, "storage": storage},
        "t_step_us": round(t_step * 1e6, 1),
        "t_warmup_batched_us": round(t_warm * 1e6, 1),
        "t_insert_us": round(t_insert * 1e6, 1),
        "warmup_speedup_vs_insert_steps": round((P - 1) * t_insert / t_warm, 1),
        "halo_mbytes": round(halo_bytes / 1e6, 1),
        "scaling_efficiency_vs_blocks_per_device": sweep,
        "note": (
            "eff(m) = m*t_step / (m*t_step + t_warmup_batched). Halo "
            "transfer itself is one ppermute message overlapped with "
            "warmup compute."
        ),
    }


def main() -> int:
    import jax

    from neojax.bench.env import gpu_info, setup_compile_cache

    setup_compile_cache()
    if jax.default_backend() != "gpu":
        print(f"needs a GPU; JAX found {jax.default_backend()!r}", file=sys.stderr)
        return 1
    result = {
        "metric": "timesharded_warmup_overhead",
        "gpu": gpu_info(),
        "device_kind": jax.devices()[0].device_kind,
        "device": bench_device(),
    }
    print(json.dumps(result, indent=1))
    with open("TIMESHARD_BENCH.json", "w") as f:
        json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
