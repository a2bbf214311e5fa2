"""Unit conversions: decibels, mel scale, A-weighting, FFT bin frequencies.

Vectorized (jnp) counterparts of:
  - ``src/neo/unit/decibel.hpp:15,28`` ``amplitude_to_db`` (accurate/estimate,
    -144 dB floor, non-positive gain maps to the floor),
  - ``src/neo/math/fast_math.hpp:12,21`` ``fast_log2``/``fast_log10``
    (bit-twiddle approximation, reproduced exactly via int32 bitcast),
  - ``src/neo/math/a_weighting.hpp:14-36`` IEC A-weighting curve,
  - ``src/neo/unit/mel.hpp:14,26`` mel conversions,
  - ``src/neo/fft/rfftfreq.hpp:10-27`` bin -> Hz mapping.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "polar",
    "fast_log2",
    "fast_log10",
    "amplitude_to_db",
    "a_weighting",
    "hertz_to_mel",
    "mel_to_hertz",
    "mel_frequencies",
    "rfftfreq",
]


def fast_log2(x):
    """Bit-twiddle log2 approximation (float32), matching the reference.

    ``y = float(bits(x)) * 2^-23; m = mantissa(x) in [0.5, 1);``
    ``log2(x) ~= y - 124.2255 - 1.49803*m - 1.72588/(0.35209 + m)``
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    vx = x.view(jnp.uint32)
    mx = ((vx & jnp.uint32(0x007FFFFF)) | jnp.uint32(0x3F000000)).view(jnp.float32)
    y = vx.astype(jnp.float32) * jnp.float32(1.1920928955078125e-7)
    return (
        y
        - jnp.float32(124.22551499)
        - jnp.float32(1.498030302) * mx
        - jnp.float32(1.72587999) / (jnp.float32(0.3520887068) + mx)
    )


def fast_log10(x):
    return fast_log2(x) * jnp.float32(0.30102999566)


def amplitude_to_db(gain, floor=-144.0, precision: str = "accurate"):
    """20*log10(gain) clamped to ``floor``; non-positive gain -> ``floor``.

    ``precision='estimate'`` uses the bit-twiddle ``fast_log10``.
    """
    gain = jnp.asarray(gain)
    if not jnp.issubdtype(gain.dtype, jnp.floating):
        gain = gain.astype(jnp.float32)
    floor = jnp.asarray(floor, dtype=gain.dtype)
    safe = jnp.where(gain > 0, gain, jnp.ones_like(gain))
    if precision == "estimate":
        db = 20.0 * fast_log10(safe).astype(gain.dtype)
    else:
        db = 20.0 * jnp.log10(safe)
    db = jnp.maximum(db, floor)
    return jnp.where(gain > 0, db, floor)


def a_weighting(frequency):
    """A-weighting in dB at ``frequency`` Hz (> 0). IEC 61672 curve."""
    f = jnp.asarray(frequency)
    if not jnp.issubdtype(f.dtype, jnp.floating):
        f = f.astype(jnp.float32)
    c0 = jnp.asarray(12194.217, f.dtype) ** 2
    c1 = jnp.asarray(20.598997, f.dtype) ** 2
    c2 = jnp.asarray(107.65265, f.dtype) ** 2
    c3 = jnp.asarray(737.86223, f.dtype) ** 2
    f_sq = f * f
    return 2.0 + 20.0 * (
        jnp.log10(c0)
        + 2.0 * jnp.log10(f_sq)
        - jnp.log10(f_sq + c0)
        - jnp.log10(f_sq + c1)
        - 0.5 * jnp.log10(f_sq + c2)
        - 0.5 * jnp.log10(f_sq + c3)
    )


def hertz_to_mel(hertz):
    hertz = jnp.asarray(hertz, dtype=jnp.result_type(hertz, jnp.float32))
    return 2595.0 * jnp.log10(1.0 + hertz / 700.0)


def mel_to_hertz(mels):
    mels = jnp.asarray(mels, dtype=jnp.result_type(mels, jnp.float32))
    return 700.0 * (jnp.power(10.0, mels / 2595.0) - 1.0)


def mel_frequencies(n_mels: int, fmin, fmax, dtype=jnp.float32):
    """``n_mels`` frequencies evenly spaced on the mel scale in [fmin, fmax]."""
    if n_mels == 0:
        return jnp.zeros((0,), dtype=dtype)
    if n_mels == 1:
        return jnp.asarray([fmin], dtype=dtype)
    min_mel = hertz_to_mel(fmin)
    max_mel = hertz_to_mel(fmax)
    mels = min_mel + (max_mel - min_mel) * jnp.arange(n_mels, dtype=dtype) / (n_mels - 1)
    return mel_to_hertz(mels).astype(dtype)


def rfftfreq(n: int, d: float = 1.0, dtype=jnp.float32):
    """Frequencies of rFFT bins for an ``n``-point transform, spacing ``d``.

    Note the reference's vector overload (``rfftfreq.hpp:20-27``) divides by
    the *vector length* rather than the transform size; the scalar form here
    is the numpy-compatible definition used throughout the framework.
    """
    return (jnp.arange(n // 2 + 1, dtype=dtype) / (n * d)).astype(dtype)


def polar(magnitude, angle):
    """Split-complex polar -> rectangular: (mag*cos(angle), mag*sin(angle)).

    Reference ``math/polar.hpp`` returns std::complex; here the native
    form is the (re, im) plane pair.
    """
    return magnitude * jnp.cos(angle), magnitude * jnp.sin(angle)
