"""Committed producer for QUALITY_SWEEP.json (the reference plugin's
in-app quality harness, ``ui/BenchmarkTab.cpp:472-525``).

Runs ``neojax.bench.quality.sparse_quality_sweep`` — dense UPOLS
reference vs perceptually-sparsified convolution, max-channel
spectrogram RMSE per threshold — on CPU (the metric is
hardware-independent).

Run: JAX_PLATFORMS=cpu python tools/bench_quality_sweep.py
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR = 48000.0
IR_SECONDS = 2.0
SIG_SECONDS = 4.0
BLOCK = 1024
CHANNELS = 2


def main() -> None:
    import jax

    if jax.default_backend() != "cpu":
        print("run on CPU (JAX_PLATFORMS=cpu); the spectrogram metric is "
              "hardware-independent", file=sys.stderr)
        return

    from neojax.bench.quality import sparse_quality_sweep

    rng = np.random.default_rng(0)
    t = np.arange(int(IR_SECONDS * SR)) / SR
    ir = (
        rng.standard_normal((CHANNELS, t.size)).astype(np.float32)
        * np.exp(-3.0 * t).astype(np.float32)
    )
    sig = rng.uniform(-1, 1, (CHANNELS, int(SIG_SECONDS * SR))).astype(np.float32)

    points = sparse_quality_sweep(
        sig, ir, sample_rate=SR, block_size=BLOCK
    )
    out = {
        "metric": "sparse_quality_sweep",
        "config": {
            "sample_rate": SR,
            "ir_seconds": IR_SECONDS,
            "signal_seconds": SIG_SECONDS,
            "block": BLOCK,
            "channels": CHANNELS,
            "note": "reference BenchmarkTab::runSparseQualityTests parity "
            "(max-channel spectrogram RMSE vs dense, ui/BenchmarkTab.cpp:472-525)",
        },
        "points": [dataclasses.asdict(p) for p in points],
    }
    print(json.dumps(out))
    with open("QUALITY_SWEEP.json", "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
