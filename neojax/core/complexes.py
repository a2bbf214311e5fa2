"""Split-complex (planar) layout helpers.

The framework's performance layout for spectra is *split complex*: separate real/imag planes stacked on a leading
axis of size 2 (reference counterpart: ``src/neo/complex/split_complex.hpp:10``
and the split FDL/filter variants). Interleaved ``complex64`` is kept as the
user-facing dtype; these helpers convert at the boundary.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["to_split", "from_split", "split_mul", "split_mul_add", "split_conj"]


def to_split(z: jnp.ndarray, dtype=jnp.float32) -> jnp.ndarray:
    """complex [...] -> split [2, ...] (plane 0 = real, plane 1 = imag)."""
    return jnp.stack([jnp.real(z), jnp.imag(z)]).astype(dtype)


def from_split(s: jnp.ndarray, dtype=jnp.complex64) -> jnp.ndarray:
    """split [2, ...] -> complex [...]."""
    return jax.lax.complex(s[0].astype(jnp.float32), s[1].astype(jnp.float32)).astype(dtype)


def split_mul(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """Elementwise complex multiply in split layout: [2,...] x [2,...] -> [2,...]."""
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return jnp.stack([xr * yr - xi * yi, xr * yi + xi * yr])


def split_mul_add(x: jnp.ndarray, y: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
    """x * y + z in split layout (the reference's hot ``multiply_add`` kernel,
    ``src/neo/algorithm/multiply_add.hpp:28-69``)."""
    xr, xi = x[0], x[1]
    yr, yi = y[0], y[1]
    return jnp.stack([xr * yr - xi * yi + z[0], xr * yi + xi * yr + z[1]])


def split_conj(x: jnp.ndarray) -> jnp.ndarray:
    return jnp.stack([x[0], -x[1]])
