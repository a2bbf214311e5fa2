"""Numerical-safety tooling: NaN/Inf checks, x64 parity runs.

SURVEY.md section 5: the reference's CI runs ASan/UBSan; the JAX
analogues are functional checks — ``checkify``-wrapped NaN/Inf detection
inside jit, an eager ``assert_finite``, and a helper to rerun a function
in float64 for parity comparison (the reference's f64 path with its 1e-9
bound).
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax.experimental import checkify

__all__ = ["assert_finite", "checked", "x64_parity_error"]


def assert_finite(x, name: str = "array") -> None:
    """Eager check (host sync) that all leaves are finite."""
    for i, leaf in enumerate(jax.tree.leaves(x)):
        if jnp.issubdtype(leaf.dtype, jnp.floating) or jnp.issubdtype(
            leaf.dtype, jnp.complexfloating
        ):
            if not bool(jnp.all(jnp.isfinite(leaf))):
                raise FloatingPointError(f"{name}: leaf {i} contains NaN/Inf")


def checked(fn: Callable) -> Callable:
    """Wrap a jittable function with checkify NaN/div-by-zero checks.

    Returns a function with the same signature; raises on the first error::

        safe_step = debug.checked(partial(conv.step, config))
        state, out = safe_step(params, state, block)
    """
    cfn = checkify.checkify(fn, errors=checkify.float_checks)

    def wrapper(*args, **kwargs):
        err, out = cfn(*args, **kwargs)
        checkify.check_error(err)
        return out

    return wrapper


def x64_parity_error(fn: Callable, *args) -> float:
    """Run ``fn`` as-is and with all float inputs promoted to float64;
    return the max abs difference (cast back to f32). Useful for verifying
    f32 accumulation order stays within the reference's 1e-5 bound."""
    out32 = fn(*args)

    def promote(leaf):
        if hasattr(leaf, "dtype") and jnp.issubdtype(leaf.dtype, jnp.floating):
            return leaf.astype(jnp.float64)
        return leaf

    args64 = jax.tree.map(promote, args)
    out64 = fn(*args64)

    err = 0.0
    for a, b in zip(jax.tree.leaves(out32), jax.tree.leaves(out64)):
        if jnp.issubdtype(jnp.asarray(a).dtype, jnp.floating):
            err = max(
                err,
                float(jnp.max(jnp.abs(jnp.asarray(a, jnp.float64) - jnp.asarray(b, jnp.float64)))),
            )
    return err
