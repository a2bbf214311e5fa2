"""Uniform partitioning of impulse responses into FDL filter spectra.

Counterpart of ``src/neo/convolution/uniform_partition.hpp:13-26``: an STFT
with ``frame = B``, ``transform = 2B``, ``overlap = 0`` and a rectangular
window, producing ``[ch, num_partitions, B + 1]`` complex spectra. The
number of partitions is ``ceil(len / B)`` (last partition zero-padded).

This is *filter preparation*, run once at setup: it executes host-side in
numpy; only the float32 re/im planes derived by ``filter_params`` (or,
for the "dense" storage, the complex array) are transferred.
"""

from __future__ import annotations

import numpy as np

from neojax.core.bits import idiv

__all__ = ["uniform_partition", "num_partitions"]


def num_partitions(ir_len: int, block_size: int) -> int:
    """Frame count of the partitioning STFT: ceil((len - B)/B) + 1."""
    return idiv(ir_len - block_size, block_size) + 1


def uniform_partition(impulse_response, block_size: int, backend=None):
    """IR [len] or [ch, len] -> partitioned spectra [ch, P, B+1] complex64.

    (``backend`` is accepted for API symmetry and ignored — partitioning is
    a host-side numpy rfft.)
    """
    ir = np.asarray(impulse_response, dtype=np.float32)
    if ir.ndim == 1:
        ir = ir[None, :]
    if ir.ndim != 2:
        raise ValueError(f"impulse response must be rank 1 or 2, got {ir.ndim}")
    ch, length = ir.shape
    p = num_partitions(length, block_size)
    padded = np.zeros((ch, p * block_size), np.float32)
    padded[:, :length] = ir
    frames = padded.reshape(ch, p, block_size)
    return np.fft.rfft(frames, n=2 * block_size, axis=-1).astype(np.complex64)
