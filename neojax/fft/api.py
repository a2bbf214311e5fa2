"""User-facing transform API: fft/ifft/rfft/irfft with norm handling.

Mirrors the reference's plan API semantics (``src/neo/fft/fft.hpp:39-51``,
``rfft.hpp:18-38``) and its Python surface (``extra/python/src/main.cpp:129-167``):
norm in {"backward", "ortho", "forward"} with numpy conventions. Two
backends play the role of the reference's vendor-vs-fallback switch:

  - ``"xla"``    : jnp.fft (XLA's built-in FFT; cuFFT on the GPU) — any
                   size. What ``"auto"`` picks.
  - ``"matmul"`` : DFT-as-matmul (``neojax.fft.matmul_backend``), with the
                   four-step decomposition above ``_MATMUL_MAX_SIZE``.

The default backend is process-global and settable via ``set_backend``.
"""

from __future__ import annotations

import jax.numpy as jnp

from neojax.core.bits import is_pow2
from neojax.fft import matmul_backend

__all__ = [
    "set_backend",
    "get_backend",
    "fft",
    "ifft",
    "rfft",
    "irfft",
]

_BACKEND = "auto"
_MATMUL_MAX_SIZE = 8192


def set_backend(name: str) -> None:
    global _BACKEND
    if name not in ("auto", "xla", "matmul"):
        raise ValueError(f"unknown fft backend: {name!r}")
    _BACKEND = name


def get_backend() -> str:
    return _BACKEND


def _resolve_backend(backend, n: int) -> str:
    b = backend or _BACKEND
    if b == "auto":
        return "xla"
    if b == "matmul" and n > _MATMUL_MAX_SIZE:
        from neojax.core.bits import is_pow2

        return "fourstep" if is_pow2(n) else "xla"
    return b


def _pad_or_trim(x, n: int, axis: int = -1):
    length = x.shape[axis]
    if length == n:
        return x
    if length > n:
        return jnp.take(x, jnp.arange(n), axis=axis)
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, n - length)
    return jnp.pad(x, pad)


def fft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None):
    x = jnp.asarray(x)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    b = _resolve_backend(backend, n)
    if b in ("matmul", "fourstep") and axis in (-1, x.ndim - 1):
        xr = jnp.real(x).astype(jnp.float32)
        xi = jnp.imag(x).astype(jnp.float32) if jnp.iscomplexobj(x) else jnp.zeros_like(xr)
        if b == "fourstep":
            from neojax.fft.four_step import fft_split_large

            re, im = fft_split_large(xr, xi, n)
        else:
            re, im = matmul_backend.fft_split(xr, xi, n)
        out = jax_complex(re, im)
    else:
        out = jnp.fft.fft(x, axis=axis)
    return _apply_norm(out, n, norm, forward=True)


def ifft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None):
    x = jnp.asarray(x)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    b = _resolve_backend(backend, n)
    if b in ("matmul", "fourstep") and axis in (-1, x.ndim - 1):
        xr = jnp.real(x).astype(jnp.float32)
        xi = jnp.imag(x).astype(jnp.float32) if jnp.iscomplexobj(x) else jnp.zeros_like(xr)
        if b == "fourstep":
            from neojax.fft.four_step import fft_split_large

            re, im = fft_split_large(xr, xi, n, inverse=True)
        else:
            re, im = matmul_backend.fft_split(xr, xi, n, inverse=True)
        out = jax_complex(re / n, im / n)
    else:
        out = jnp.fft.ifft(x, axis=axis)
    return _apply_norm(out, n, norm, forward=False)


def rfft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None):
    x = jnp.asarray(x)
    n = int(n if n is not None else x.shape[axis])
    x = _pad_or_trim(x, n, axis)
    b = _resolve_backend(backend, n)
    if b == "fourstep" and axis in (-1, x.ndim - 1):
        from neojax.fft.four_step import rfft_split_large

        re, im = rfft_split_large(x.astype(jnp.float32), n)
        out = jax_complex(re, im)
    elif b == "matmul" and axis in (-1, x.ndim - 1) and n % 2 == 0:
        out = matmul_backend.rfft(x.astype(jnp.float32), n)
    else:
        out = jnp.fft.rfft(x, axis=axis)
    return _apply_norm(out, n, norm, forward=True)


def irfft(x, n: int | None = None, axis: int = -1, norm: str = "backward", backend=None):
    x = jnp.asarray(x)
    n = int(n if n is not None else 2 * (x.shape[axis] - 1))
    bins = n // 2 + 1
    x = _pad_or_trim(x, bins, axis)
    b = _resolve_backend(backend, n)
    if b == "fourstep" and axis in (-1, x.ndim - 1):
        from neojax.fft.four_step import irfft_split_large

        out = irfft_split_large(jnp.real(x), jnp.imag(x), n)
    elif b == "matmul" and axis in (-1, x.ndim - 1) and n % 2 == 0:
        out = matmul_backend.irfft(x, n)
    else:
        out = jnp.fft.irfft(x, n=n, axis=axis)
    return _apply_norm(out, n, norm, forward=False)


def _apply_norm(out, n: int, norm: str, forward: bool):
    if norm in (None, "backward"):
        return out
    if norm == "ortho":
        # Backends return backward-normalized results (inverse includes 1/n).
        return out * (1.0 / (n**0.5)) if forward else out * (n**0.5)
    if norm == "forward":
        return out * (1.0 / n) if forward else out * n
    raise ValueError(f"unknown norm: {norm!r}")


def jax_complex(re, im):
    import jax

    return jax.lax.complex(re, im)


def require_pow2(n: int) -> None:
    """Raise like the reference binding on non-power-of-two sizes
    (``extra/python/src/main.cpp:137-139``)."""
    if not is_pow2(n):
        raise ValueError(f"unsupported size: {n}")
