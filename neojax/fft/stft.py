"""Short-time Fourier transform as a framed, batched rfft.

Counterpart of ``src/neo/fft/stft.hpp:31-125``: the reference loops
channels x frames serially, windowing and rfft-ing one frame at a time.
Here the whole cube is computed at once: frames are gathered into
``[ch, frames, transform]`` (zero-padded, window applied over the full
transform length like the reference) and a single batched rfft produces
``[ch, frames, bins]``. Frame count matches ``detail::num_sftf_frames``:
``ceil((signal - frame + overlap) / (frame - overlap)) + 1``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from neojax.core.bits import idiv
from neojax.core.windows import make_window
from neojax.fft import api as fft_api

__all__ = ["StftOptions", "num_stft_frames", "stft"]


@dataclasses.dataclass(frozen=True)
class StftOptions:
    frame_size: int
    transform_size: int
    overlap_size: int = 0
    window: Any = "hann"

    @staticmethod
    def default(transform_size: int) -> "StftOptions":
        # Matches stft_plan's convenience ctor: frame == transform, 50% overlap.
        return StftOptions(
            frame_size=transform_size,
            transform_size=transform_size,
            overlap_size=transform_size // 2,
        )


def num_stft_frames(signal_size: int, frame_size: int, overlap_size: int) -> int:
    return idiv(signal_size - frame_size + overlap_size, frame_size - overlap_size) + 1


def stft(x, options: StftOptions | int, backend: str | None = None) -> jnp.ndarray:
    """STFT of ``x`` ([len] or [ch, len]) -> [ch, frames, bins] complex.

    Rank-1 input produces a single-channel cube with the channel axis kept,
    matching the reference's matrix-in / cube-out contract.
    """
    if isinstance(options, int):
        options = StftOptions.default(options)

    x = jnp.asarray(x)
    squeeze = x.ndim == 1
    if squeeze:
        x = x[None, :]
    if x.ndim != 2:
        raise ValueError(f"stft expects rank 1 or 2 input, got {x.ndim}")

    frame = options.frame_size
    overlap = options.overlap_size
    hop = frame - overlap
    if hop <= 0:
        raise ValueError("overlap_size must be < frame_size")

    # bit_ceil sizing like rfft_plan{from_order, next_order(transform_size)}
    from neojax.core.bits import bit_ceil

    transform = bit_ceil(options.transform_size)
    if frame > transform:
        raise ValueError("frame_size must be <= transform_size")

    signal_len = x.shape[1]
    frames = num_stft_frames(signal_len, frame, overlap)

    # Zero-pad so every frame gather is in-bounds, then gather
    # [frames, frame] windows at hop intervals.
    pad_len = (frames - 1) * hop + frame - signal_len
    xp = jnp.pad(x, ((0, 0), (0, max(pad_len, 0))))
    starts = jnp.arange(frames) * hop
    idx = starts[:, None] + jnp.arange(frame)[None, :]  # [frames, frame]
    framed = xp[:, idx]  # [ch, frames, frame]

    # Zero-pad frames to the transform size; window spans the full transform
    # (reference multiplies the padded buffer by a transform-length window).
    framed = jnp.pad(framed, ((0, 0), (0, 0), (0, transform - frame)))
    win = make_window(options.window, transform, dtype=framed.dtype)
    framed = framed * win[None, None, :]

    return fft_api.rfft(framed, n=transform, backend=backend)
