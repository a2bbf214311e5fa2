"""Reduced-precision spectrum storage: int8 / int16 / bf16.

Counterpart of the reference's ``compressed_fdl``
(``src/neo/convolution/compressed_fdl.hpp:17,26-48``) and
``compressed_accessor`` (``src/neo/container/compressed_accessor.hpp:16``):
values are quantized by ``round(x * int_max)`` on store and dequantized by
``x * (1 / int_max)`` on load. The dequant multiply fuses into the
consuming MAC, so the delay line halves (int16/bf16) or quarters (int8) its
memory footprint *and* bandwidth.

Split-complex arrays quantize per-plane with the same fixed scale — matching
the reference, which uses the full-scale int range rather than per-block
scaling (its documented tolerance: int8 <= 5e-3, int16 <= 1e-4 abs).
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["quantize_fixed", "dequantize_fixed", "int_max_for"]

_INT_MAX = {
    jnp.dtype(jnp.int8): 127,
    jnp.dtype(jnp.int16): 32767,
}


def int_max_for(dtype) -> int:
    return _INT_MAX[jnp.dtype(dtype)]


def quantize_fixed(x: jnp.ndarray, dtype) -> jnp.ndarray:
    """Quantize floats in [-1, 1] to int8/int16 at fixed full-scale."""
    dtype = jnp.dtype(dtype)
    if dtype == jnp.dtype(jnp.bfloat16):
        return x.astype(jnp.bfloat16)
    m = _INT_MAX[dtype]
    scaled = jnp.round(x.astype(jnp.float32) * m)
    return jnp.clip(scaled, -m - 1, m).astype(dtype)


def dequantize_fixed(q: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    if q.dtype == jnp.bfloat16:
        return q.astype(dtype)
    m = _INT_MAX[jnp.dtype(q.dtype)]
    return q.astype(dtype) * jnp.asarray(1.0 / m, dtype=dtype)
