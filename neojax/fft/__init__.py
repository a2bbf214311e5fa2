"""neojax.fft — transforms: fft/ifft/rfft/irfft, STFT, DCT-II, Bluestein DFT.

Backends (the vendor-vs-fallback axis of the reference, ``fft/fft.hpp:39-51``):
``"xla"`` (jnp.fft) and ``"matmul"`` (DFT-as-GEMM, split-complex native).
"""

from neojax.fft.api import fft, ifft, irfft, rfft, set_backend, get_backend
from neojax.fft.bluestein import dft, naive_dft
from neojax.fft.dct import dct2
from neojax.fft.extras import (
    packed_irfft,
    packed_rfft,
    rfft_deinterleave,
    split_fft,
    split_ifft,
)
from neojax.fft.stft import StftOptions, num_stft_frames, stft
from neojax.core.units import rfftfreq
from neojax.core.bits import next_order

__all__ = [
    "fft",
    "ifft",
    "rfft",
    "irfft",
    "set_backend",
    "get_backend",
    "dft",
    "naive_dft",
    "dct2",
    "packed_rfft",
    "packed_irfft",
    "rfft_deinterleave",
    "split_fft",
    "split_ifft",
    "stft",
    "StftOptions",
    "num_stft_frames",
    "rfftfreq",
    "next_order",
]
