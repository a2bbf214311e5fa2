"""neojax — partitioned-convolution DSP framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
``neo-sonar/neo-dsp`` C++ library: the FFT family (rfft/stft/dct/Bluestein),
streaming FFT convolution (direct, single-shot, OLA/OLS), and the
uniformly-partitioned frequency-delay-line convolution engine in dense,
split, sparse and reduced-precision variants — plus mesh sharding for
multi-chip/multi-host streaming.

The top-level namespace mirrors the reference's Python surface
(``extra/python/src/neo/__init__.py``): ``convolve``, ``amplitude_to_db``,
``a_weighting``, ``fast_log2``/``fast_log10`` and the ``fft`` submodule.
"""

from __future__ import annotations

import jax.numpy as jnp

from neojax import conv, core, dist, fft, io, ops
from neojax.core.units import (
    a_weighting,
    amplitude_to_db,
    fast_log2,
    fast_log10,
)

__version__ = "0.1.0"

__all__ = [
    "__version__",
    "a_weighting",
    "amplitude_to_db",
    "fast_log2",
    "fast_log10",
    "convolve",
    "conv",
    "core",
    "dist",
    "fft",
    "io",
    "ops",
]


def convolve(in1, in2, mode: str = "full", method: str = "auto"):
    """Convolve two 1-D arrays (reference ``neo.convolve`` semantics: only
    mode='full'). Methods mirror the reference's enum (``method.hpp:8-17``):
    'auto'/'direct', 'fft', and the streaming engines 'ols', 'ola',
    'upols', 'upola'."""
    if mode != "full":
        raise ValueError("unsupported convolution mode")
    in1 = jnp.asarray(in1)
    in2 = jnp.asarray(in2)
    if in1.ndim != 1 or in2.ndim != 1:
        raise ValueError("unsupported dimension: in1 and in2 must be 1-D")
    if method == "fft":
        return conv.fft_convolve(in1, in2)
    if method in ("ols", "ola", "upols", "upola"):
        from neojax.conv.streaming import streaming_convolve

        return streaming_convolve(in1, in2, method)
    return conv.direct_convolve(in1, in2)
