"""Elementwise linear-algebra ops, including the hot complex MAC.

Counterpart of the reference algorithm layer (``src/neo/algorithm/add.hpp``,
``multiply.hpp``, ``scale.hpp``) and, centrally, the batched complex
``multiply_add`` (``src/neo/algorithm/multiply_add.hpp:28-69,280-368``) that
the FDL convolution engine spends its time in. These are elementwise ops
that XLA fuses; the multi-partition MAC is ``neojax.conv.fdl.fdl_mac_split``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = ["add", "multiply", "scale", "multiply_add", "split_multiply_add"]


def add(x, y):
    return jnp.asarray(x) + jnp.asarray(y)


def multiply(x, y):
    return jnp.asarray(x) * jnp.asarray(y)


def scale(factor, x):
    return jnp.asarray(x) * factor


def multiply_add(x, y, z):
    """x * y + z (elementwise; complex or real)."""
    return jnp.asarray(x) * jnp.asarray(y) + jnp.asarray(z)


def split_multiply_add(x_re, x_im, y_re, y_im, z_re, z_im):
    """Split-complex MAC: returns (re, im) of x*y + z.

    ``out_re = xr*yr - xi*yi + zr``; ``out_im = xr*yi + xi*yr + zi`` —
    the exact kernel of ``multiply_add.hpp:28-69``.
    """
    return (
        x_re * y_re - x_im * y_im + z_re,
        x_re * y_im + x_im * y_re + z_im,
    )
