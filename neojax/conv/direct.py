"""Time-domain (direct) convolution.

Counterpart of ``src/neo/convolution/direct_convolve.hpp:16-73``. The
reference runs an O(N*L) scalar double loop; here the same full
convolution is a single XLA ``conv_general_dilated`` — no hand-scheduled
loops.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["direct_convolve"]


def direct_convolve(signal, patch):
    """Full linear convolution of two 1-D arrays (length n + l - 1)."""
    signal = jnp.asarray(signal)
    patch = jnp.asarray(patch)
    if signal.ndim != 1 or patch.ndim != 1:
        raise ValueError("direct_convolve expects 1-D inputs")
    if signal.size == 0 or patch.size == 0:
        return jnp.zeros((0,), dtype=signal.dtype)
    return jnp.convolve(signal, patch, mode="full")
