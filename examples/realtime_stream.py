"""Real-time deadline demo: the hybrid engine behind an audio callback.

Drives ``conv.hybrid.HybridStream`` (single-block latency, Gardner-style
two-stage scheduling) at block 512 / 48 kHz against a 10 s IR — the
reference plugin's scenario (``extra/plugin/src/PerceptualConvolution.hpp:13``,
``dsp/ConstantOverlapAdd.hpp:89-199``, CLI loop
``extra/cli/src/convolver.cpp:108-143``) — and reports per-callback wall
latency statistics vs the 512/48000 = 10.667 ms deadline:

  1. **callback path**: N process-block calls, each fully synced (the
     output fetched to host like an audio callback writing its buffer);
     p50/p95/p99/max latency + deadline-miss rate.
  2. **executor path**: the same engine behind ``io.StreamExecutor`` —
     producer pushes odd-sized chunks into the native lock-free ring, the
     worker drains block frames, the consumer pulls at its own pace;
     verified sample-exact vs the offline ``process_hybrid`` stream and
     timed end-to-end.

Writes REALTIME_DEMO.json. Runs on any backend; the JSON names it.

Usage: python examples/realtime_stream.py [--channels 2] [--seconds 20]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--ir-seconds", type=float, default=10.0)
    ap.add_argument("--block", type=int, default=512)
    ap.add_argument("--sr", type=int, default=48000)
    ap.add_argument("--chunk-blocks", type=int, default=64)
    ap.add_argument("--out", default="REALTIME_DEMO.json")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from neojax.bench.env import setup_compile_cache

    setup_compile_cache()

    from functools import partial

    from neojax.conv import convolver as cv
    from neojax.conv import hybrid, partition
    from neojax.io import StreamExecutor

    b, sr, c = args.block, args.sr, args.channels
    deadline_ms = 1e3 * b / sr
    p = int(np.ceil(args.ir_seconds * sr / b))
    s = args.chunk_blocks

    rng = np.random.default_rng(0)
    ir = (
        rng.standard_normal((1, p * b)) * 0.05
        * np.exp(-np.arange(p * b) / (p * b / 4))
    ).astype(np.float32)
    parts = partition.uniform_partition(ir, b)

    cfg = cv.PartitionedConfig(b, p, c, storage="split")
    params = hybrid.hybrid_filter_params(cfg, parts, s)
    stream = hybrid.HybridStream(cfg, params)

    nb = int(args.seconds * sr / b)
    nb -= nb % s
    sig = rng.uniform(-1, 1, (c, nb * b)).astype(np.float32)

    # -- 1. callback path: per-block wall latency, fully synced ------------
    # warm both jitted paths (compile happens here, not in the "callback")
    for i in range(2 * s):
        np.asarray(stream(sig[:, i * b : (i + 1) * b]))
    stream.reset()

    lat = np.zeros(nb)
    outs = []
    t_run0 = time.perf_counter()
    for i in range(nb):
        t0 = time.perf_counter()
        out = np.asarray(stream(sig[:, i * b : (i + 1) * b]))
        lat[i] = time.perf_counter() - t0
        outs.append(out)
    t_run = time.perf_counter() - t_run0
    out_cb = np.concatenate(outs, axis=-1)

    # exactness vs the offline engine
    st = hybrid.hybrid_init_state(cfg, params)
    _, ref = jax.jit(partial(hybrid.process_hybrid, cfg))(
        params, st, jnp.asarray(sig)
    )
    max_err = float(np.max(np.abs(out_cb - np.asarray(ref))))

    q = lambda x: float(np.quantile(lat, x) * 1e3)
    callback = {
        "blocks": nb,
        "deadline_ms": round(deadline_ms, 3),
        "p50_ms": round(q(0.50), 3),
        "p95_ms": round(q(0.95), 3),
        "p99_ms": round(q(0.99), 3),
        "max_ms": round(float(lat.max() * 1e3), 3),
        "miss_rate": round(float(np.mean(lat > deadline_ms / 1e3)), 4),
        "meets_deadline_p99": bool(q(0.99) < deadline_ms),
        "amortized_ms_per_block": round(t_run / nb * 1e3, 3),
        "max_abs_err_vs_offline": max_err,
        "matches_offline_1e-4": bool(max_err < 1e-4),
        "realtime_factor": round(deadline_ms / (t_run / nb * 1e3), 1),
    }

    # -- 2. executor path: native rings + worker thread --------------------
    stream2 = hybrid.HybridStream(cfg, params)

    def step(state, block):
        return state, stream2(block)

    got = []
    t0 = time.perf_counter()
    with StreamExecutor(step, None, c, b, capacity_blocks=128) as ex:
        sent = 0
        while sum(x.shape[1] for x in got) < nb * b:
            if time.perf_counter() - t0 > 600:
                break
            if sent < sig.shape[1]:
                sent += ex.push(sig[:, sent : sent + 4391])  # odd chunks
            chunk = ex.pull(8 * b)
            if chunk.shape[1]:
                got.append(chunk)
            else:
                # yield the GIL to the worker thread — a spinning producer
                # starves it (real audio callbacks are naturally paced)
                time.sleep(0.002)
    t_exec = time.perf_counter() - t0
    out_ex = np.concatenate(got, axis=-1)[:, : nb * b]
    ex_err = float(np.max(np.abs(out_ex - np.asarray(ref)[:, : out_ex.shape[1]])))
    executor = {
        "wall_s": round(t_exec, 2),
        "audio_s": round(nb * b / sr, 2),
        "realtime_factor": round(nb * b / sr / t_exec, 2),
        # f32 tolerance: per-block HybridStream vs the S-blocks-per-call
        # offline engine reassociate the same sums differently
        "max_abs_err_vs_offline": ex_err,
        "matches_offline_1e-4": bool(ex_err < 1e-4),
    }

    result = {
        "metric": "realtime_deadline_demo",
        "backend": jax.default_backend(),
        "device_kind": jax.devices()[0].device_kind,
        "config": {
            "block": b, "sample_rate": sr, "channels": c,
            "ir_seconds": args.ir_seconds, "partitions": p,
            "chunk_blocks": s, "storage": "split",
        },
        "callback_path": callback,
        "executor_path": executor,
    }
    print(json.dumps(result, indent=1))
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"# wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
