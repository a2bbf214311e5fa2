"""Fixed-point (Q-format) arithmetic: q7 / q15 with saturating ops.

Counterpart of the reference's fixed-point layer
(``src/neo/fixed_point/fixed_point.hpp:33,89-95,125-126`` and the
saturating SIMD kernels ``fixed_point/simd.hpp:28-105``): values are int8
(q7, 7 fractional bits) or int16 (q15) arrays; add/subtract saturate at
the type bounds and multiply is ``(a * b) >> frac_bits`` computed in a
wider type then clipped — exactly the scalar semantics the reference's
SSE/NEON kernels implement per-lane, here vectorized over whole arrays.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "Q7",
    "Q15",
    "to_fixed",
    "to_float",
    "fixed_add",
    "fixed_subtract",
    "fixed_multiply",
]


class _QFormat:
    def __init__(self, dtype, frac_bits: int):
        self.dtype = jnp.dtype(dtype)
        self.frac_bits = frac_bits
        info = jnp.iinfo(self.dtype)
        self.min = info.min
        self.max = info.max
        self.scale = float(1 << frac_bits)

    def __repr__(self):
        return f"Q{self.frac_bits}"


Q7 = _QFormat(jnp.int8, 7)
Q15 = _QFormat(jnp.int16, 15)


def _wide(fmt: _QFormat):
    return jnp.int16 if fmt.dtype == jnp.dtype(jnp.int8) else jnp.int32


def to_fixed(x, fmt: _QFormat = Q15) -> jnp.ndarray:
    """float [-1, 1) -> fixed point with round-to-nearest and saturation."""
    scaled = jnp.round(jnp.asarray(x, jnp.float32) * fmt.scale)
    return jnp.clip(scaled, fmt.min, fmt.max).astype(fmt.dtype)


def to_float(q: jnp.ndarray, fmt: _QFormat | None = None) -> jnp.ndarray:
    if fmt is None:
        fmt = Q7 if q.dtype == jnp.dtype(jnp.int8) else Q15
    return q.astype(jnp.float32) * (1.0 / fmt.scale)


def _infer(q) -> _QFormat:
    return Q7 if q.dtype == jnp.dtype(jnp.int8) else Q15


def fixed_add(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Saturating addition (reference ``saturate(add(...))``)."""
    fmt = _infer(a)
    wide = a.astype(_wide(fmt)) + b.astype(_wide(fmt))
    return jnp.clip(wide, fmt.min, fmt.max).astype(fmt.dtype)


def fixed_subtract(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    fmt = _infer(a)
    wide = a.astype(_wide(fmt)) - b.astype(_wide(fmt))
    return jnp.clip(wide, fmt.min, fmt.max).astype(fmt.dtype)


def fixed_multiply(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Saturating Q-format multiply: (a * b) >> frac_bits in a wide type.

    Matches ``fixed_point.hpp:89-95``: the only value that can overflow the
    narrow type after the shift is (-1) * (-1) = +1, which saturates to max.
    """
    fmt = _infer(a)
    # int32 holds both products: q7 needs 15 bits, q15 needs 31 (2^30 max).
    prod = (a.astype(jnp.int32) * b.astype(jnp.int32)) >> fmt.frac_bits
    return jnp.clip(prod, fmt.min, fmt.max).astype(fmt.dtype)
