"""Arbitrary-size DFT via Bluestein's chirp-z algorithm.

Counterpart of ``src/neo/fft/fallback/fallback_dft_plan.hpp:24,47-78``:
chirp pre-multiply, circular convolution through a ``bit_ceil(2N+1)``-point
FFT, chirp post-multiply. Like the reference plan, both directions are
*unnormalized* (caller applies 1/N for a backward transform); the
``neojax.fft.api`` layer handles norms.

Also provides the naive O(N^2) DFT (``src/neo/fft/dft.hpp:36-59``) used as a
test oracle — here this is just the matmul backend.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from neojax.core.bits import bit_ceil

__all__ = ["dft", "naive_dft"]


@functools.lru_cache(maxsize=64)
def _chirp_np(n: int, forward: bool):
    i = np.arange(n)
    j = (i * i) % (2 * n)
    sign = -1.0 if forward else 1.0
    w = np.exp(1j * sign * np.pi * j / n).astype(np.complex64)
    m = bit_ceil(2 * n + 1)
    b = np.zeros(m, dtype=np.complex64)
    b[0] = w[0]
    b[1:n] = np.conj(w[1:n])
    b[m - n + 1 :] = np.conj(w[1:n])[::-1]
    bf = np.fft.fft(b).astype(np.complex64)
    return w, bf, m


def dft(x, forward: bool = True) -> jnp.ndarray:
    """Unnormalized DFT of arbitrary size along the last axis."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
    n = x.shape[-1]
    w, bf, m = _chirp_np(n, forward)
    w = jnp.asarray(w)
    bf = jnp.asarray(bf)

    a = x * w
    a = jnp.pad(a, [(0, 0)] * (x.ndim - 1) + [(0, m - n)])
    conv = jnp.fft.ifft(jnp.fft.fft(a, axis=-1) * bf, axis=-1)
    return (conv[..., :n] * w).astype(x.dtype)


def naive_dft(x, forward: bool = True) -> jnp.ndarray:
    """O(N^2) matrix DFT — the cross-implementation test oracle."""
    x = jnp.asarray(x)
    if not jnp.issubdtype(x.dtype, jnp.complexfloating):
        x = x.astype(jnp.complex64)
    n = x.shape[-1]
    i = np.arange(n)
    sign = -2j if forward else 2j
    mat = np.exp(sign * np.pi * np.outer(i, i) / n).astype(np.complex64)
    return x @ jnp.asarray(mat)
