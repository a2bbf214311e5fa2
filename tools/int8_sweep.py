"""int8 SNR-source isolation sweep at the headline depth.

Runs the nested engine's int8 rung at the bench config (64 ch, 10 s IR,
block 512, S=128) across {transform precision} x {scale-group count},
measuring SNR vs the same f64 UPOLS oracle bench.py uses. Controls:
int16/split/bf16 rows locate the pipeline's transform-noise floor
independently of FDL quantization. On the GPU, "default" and "high" both
run f32 matmuls as TF32.

Each row re-jits from scratch; all rows run in one process.

Usage: python tools/int8_sweep.py [out.json]
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np

sys.path.insert(0, ".")

import bench  # noqa: E402  (the bench module provides config + oracle)

jax = bench._setup_jax()
from jax import lax  # noqa: E402

from neojax.conv import convolver as cv  # noqa: E402
from neojax.conv import nested  # noqa: E402

PREC = {
    "default": (lax.Precision.DEFAULT, lax.Precision.DEFAULT),
    "high": (lax.Precision.HIGH, lax.Precision.HIGH),
    "highest": (lax.Precision.HIGHEST, lax.Precision.HIGHEST),
}


def run_row(storage, prec_name, groups, s=128):
    orig_groups = dict(nested._QUANT_GROUPS)
    nested._QUANT_GROUPS["int8"] = groups
    orig = nested._fft_precisions
    nested._fft_precisions = lambda config: PREC[prec_name]
    try:
        cfg = cv.PartitionedConfig(
            bench.BLOCK, bench.P_REAL, bench.CHANNELS, storage=storage
        )
        parts = bench._make_parts(bench.P_REAL, cfg.num_bins)
        params = nested.nested_filter_params(cfg, parts, s)
        state = nested.nested_init_state(cfg, params)
        nb = -(-(bench._SNR_START + bench._SNR_BLOCKS) // s) * s
        sig = bench._signal(nb)
        proc = jax.jit(partial(nested.process_nested, cfg))
        t0 = time.perf_counter()
        _, out = proc(params, state, sig)
        head = np.asarray(
            out[
                : bench._SNR_CH,
                bench._SNR_START * bench.BLOCK :
                (bench._SNR_START + bench._SNR_BLOCKS) * bench.BLOCK,
            ],
            np.float64,
        )
        jax.block_until_ready(out)
        wall = time.perf_counter() - t0
        return head, wall
    finally:
        nested._fft_precisions = orig
        nested._QUANT_GROUPS.clear()
        nested._QUANT_GROUPS.update(orig_groups)


def main():
    oracle = bench._oracle_head()
    rows = {}

    grid = [
        # (name, storage, prec, groups); int8 ships G64 at "high"
        ("int8/default/G16", "int8", "default", 16),
        ("int8/high/G32", "int8", "high", 32),
        ("int8/highest/G32", "int8", "highest", 32),
        ("int8/high/G64", "int8", "high", 64),
        ("int8/highest/G64", "int8", "highest", 64),
        ("int16/high/-", "int16", "high", 16),
        ("int16/highest/-", "int16", "highest", 16),
        ("bf16/default/-", "bf16", "default", 16),
        ("split/highest/-", "split", "highest", 16),
        ("split/default/-", "split", "default", 16),
    ]
    for name, storage, prec, groups in grid:
        try:
            head, wall = run_row(storage, prec, groups)
            snr = bench._snr_db(head, oracle)
            rows[name] = {"snr_db": round(snr, 2), "wall_s": round(wall, 1)}
            print(f"{name}: {snr:.2f} dB ({wall:.0f}s)", file=sys.stderr)
        except Exception as e:  # keep sweeping
            rows[name] = {"error": f"{type(e).__name__}: {e}"[:200]}
            print(f"{name} FAILED: {e}", file=sys.stderr)

    out = {"metric": "int8_snr_source_isolation",
           "device_kind": jax.devices()[0].device_kind, "rows": rows}
    path = sys.argv[1] if len(sys.argv) > 1 else "int8_sweep.json"
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
