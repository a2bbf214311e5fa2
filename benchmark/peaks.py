"""Published peaks of the cards the benchmark runs on, and the least work
of a call through the uniformly partitioned convolver, against which its
roofline is read.

Peaks are dense rates without sparsity, from NVIDIA's H100 Tensor Core GPU
data sheet: the SXM5 part (700 W) and the PCIe part (350 W). They assume the
card's full power limit; a card set below it cannot hold its top clock under
load, so every roofline share is printed beside the card's power limit.
A card that is not in the table is an error, not a default.
"""

from __future__ import annotations

import math

PEAKS = {
    # H100 SXM5 80 GB: HBM3 3.35 TB/s; FP32 67, TF32 495, BF16 989 TFLOP/s.
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
    },
    # H100 PCIe 80 GB: HBM2e 2.0 TB/s; FP32 51, TF32 378, BF16 756 TFLOP/s.
    "NVIDIA H100 PCIe": {
        "hbm_bytes_per_s": 2.0e12,
        "f32_flops": 51e12,
        "tf32_flops": 378e12,
        "bf16_flops": 756e12,
    },
}

# Bytes per element of each delay-line storage (one plane of split complex).
STORAGE_ITEMSIZE = {"split": 4, "dense": 4, "bf16": 2, "int16": 2, "int8": 1}


def peaks_for(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; raises for an unknown card."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add the card "
            "to benchmark/peaks.py PEAKS with its data sheet"
        ) from None


def rfft_flops(n: int) -> float:
    """Operations of a real transform of n points: half the 5 n log2 n of a
    complex one."""
    return 2.5 * n * math.log2(n)


def upola_call_work(
    partitions: int,
    blocks: int,
    channels: int,
    filter_channels: int,
    block_size: int,
    storage: str,
) -> tuple[float, float]:
    """(bytes, FLOPs) that one call of ``blocks`` blocks through a uniformly
    partitioned convolver of ``partitions`` partitions needs at least,
    whatever implements it.

    Bytes: the older P-1 rows of the delay line [P, C, K] (two planes of
    the storage's itemsize) read once, the rows the call replaces written,
    the filter [P, C', K] (two f32 planes) read once, the call's audio read
    and written, and the overlap tail [C, B] read and written (f32).
    FLOPs: a real transform of N = 2B points and its inverse per block and
    channel, and 8 per complex multiply-accumulate of the partition MAC.
    """
    p, m, c, b = partitions, blocks, channels, block_size
    k = b + 1
    item = STORAGE_ITEMSIZE[storage]
    row = 2 * c * k * item
    nbytes = (
        (p - 1) * row
        + min(m, p) * row
        + 2 * p * filter_channels * k * 4
        + 2 * c * m * b * 4
        + 2 * c * b * 4
    )
    flops = m * c * (2 * rfft_flops(2 * b) + 8 * p * k)
    return float(nbytes), float(flops)


def roofline_seconds(nbytes: float, flops: float, peaks: dict,
                     flops_key: str = "f32_flops") -> tuple[float, str]:
    """The least time for the work, and which bound sets it."""
    t_mem = nbytes / peaks["hbm_bytes_per_s"]
    t_cmp = flops / peaks[flops_key]
    return (t_mem, "memory") if t_mem >= t_cmp else (t_cmp, "compute")
