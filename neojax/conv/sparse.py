"""Sparsity masks for the FDL filter, incl. perceptual (A-weighted) thresholding.

Counterpart of the reference's ``sparse_filter`` /
``csr_matrix`` (``src/neo/convolution/sparse_filter.hpp:16``,
``src/neo/container/csr_matrix.hpp:21-98``) and the plugin's perceptual
sparsification predicate (``extra/plugin/src/dsp/DenseConvolution.cpp:205-267``).

A CSR gather per partition row would defeat vectorization for the
densities this workload sees; instead the sparsity predicate produces a
boolean *bin mask* ``[P, K]`` which zeroes the dense filter — XLA's MAC
then streams exactly the same bytes but multiplies by zero (the chunked
engine's banded buckets do skip the work). The mask's density is the
quality dial, swept by the SNR harness.

All mask construction is *host-side numpy*: it happens once at filter-setup
time.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from neojax.core.bits import bit_ceil

__all__ = ["sparsity_mask", "perceptual_weights", "perceptual_mask"]


def _np_amplitude_to_db(gain: np.ndarray, floor: float = -144.0) -> np.ndarray:
    out = np.full(gain.shape, floor, dtype=np.float32)
    pos = gain > 0
    np.log10(gain, out=out, where=pos)
    out[pos] = np.maximum(20.0 * out[pos], floor)
    return out


def _np_a_weighting(f: np.ndarray) -> np.ndarray:
    c0, c1 = 12194.217**2, 20.598997**2
    c2, c3 = 107.65265**2, 737.86223**2
    f_sq = f * f
    return 2.0 + 20.0 * (
        np.log10(c0)
        + 2.0 * np.log10(np.maximum(f_sq, 1e-30))
        - np.log10(f_sq + c0)
        - np.log10(f_sq + c1)
        - 0.5 * np.log10(f_sq + c2)
        - 0.5 * np.log10(f_sq + c3)
    )


def sparsity_mask(partitions: np.ndarray, predicate: Callable) -> np.ndarray:
    """Evaluate ``predicate(row, col, value) -> bool`` over a [P, K] (or
    [C, P, K]) complex spectrum grid, vectorized. Matches the reference's
    CSR-construction predicate (``csr_matrix.hpp:67-98``)."""
    partitions = np.asarray(partitions)
    p, k = partitions.shape[-2], partitions.shape[-1]
    rows = np.broadcast_to(np.arange(p, dtype=np.int32)[:, None], partitions.shape)
    cols = np.broadcast_to(np.arange(k, dtype=np.int32)[None, :], partitions.shape)
    return np.asarray(predicate(rows, cols, partitions), dtype=bool)


def perceptual_weights(
    num_bins: int, sample_rate: float, low_bins_to_keep: int = 8
) -> np.ndarray:
    """Per-bin dB weights: +100 dB bias for the lowest bins, A-weighting at
    the bin frequency elsewhere (``DenseConvolution.cpp:139-155``)."""
    transform = bit_ceil((num_bins - 1) * 2)
    freqs = np.arange(num_bins) * (sample_rate / transform)
    weights = _np_a_weighting(np.maximum(freqs, 1e-12)).astype(np.float32)
    weights[:low_bins_to_keep] = 100.0
    return weights


def perceptual_mask(
    partitions: np.ndarray,
    sample_rate: float,
    threshold_db: float,
    low_bins_to_keep: int = 8,
) -> np.ndarray:
    """Keep bin iff ``dB(power * scale) * 0.5 + weight > threshold`` where
    ``scale = 1 / max power`` over the partitioned spectrum
    (``DenseConvolution.cpp:110-122,160-166``). ``partitions``: [P, K] or
    [C, P, K] (per-channel scale, like the per-channel loop in the plugin)."""
    partitions = np.asarray(partitions)
    power = np.abs(partitions).astype(np.float32) ** 2
    max_power = np.max(power, axis=(-2, -1), keepdims=True)
    scale = np.where(max_power > 0, 1.0 / max_power, 1.0)
    weights = perceptual_weights(partitions.shape[-1], sample_rate, low_bins_to_keep)
    db = _np_amplitude_to_db(power * scale) * 0.5 + weights
    return db > threshold_db
