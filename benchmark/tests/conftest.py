"""Tests of the benchmark itself. They run on the CPU at sizes a test run
holds, except those marked ``gpu``, which skip without a card (the fixture
decides at run time):

    python3 -m pytest benchmark/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# Both cells, cut to a size the CPU runs in seconds. Render: 8 channels,
# block 2048 (the smallest whose transform, N = 4096, takes the four-step
# path of block 32768), 3 partitions, calls of 8 blocks. Callback: the IR to
# 38 partitions of 64 samples and the chunk to 8 blocks; the open loop runs
# at a tenth of real time.
SMALL = {
    "render64_ir10s_f32.device_io": (
        {"channels": 8, "ir_seconds": 0.12, "block_size": 2048},
        {"blocks_per_call": 8},
    ),
    "plugin_stereo_ir10s_f32.realtime": (
        {"ir_seconds": 0.05, "block_size": 64, "chunk_blocks": 8},
        {"speed": 0.1, "warmup_calls": 64},
    ),
}


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the control's precision exists only on the card")
