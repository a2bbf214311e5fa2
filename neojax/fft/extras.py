"""FFT extras: two-for-one real FFTs and split-complex C2C transform API.

Counterparts of ``src/neo/fft/rfft.hpp:44-63`` (``rfft_deinterleave``: two
real FFTs from one complex FFT via conjugate symmetry) and the split
transform plans (``fft/split_fft.hpp:22-34``), here the planar matmul
backend.
"""

from __future__ import annotations

import jax.numpy as jnp

from neojax.fft import api as fft_api
from neojax.fft import matmul_backend

__all__ = ["rfft_deinterleave", "split_fft", "split_ifft", "packed_rfft", "packed_irfft"]


def rfft_deinterleave(x, y, n: int | None = None, backend: str | None = None):
    """FFTs of two real signals from ONE complex FFT of z = x + i*y.

    ``X_k = (Z_k + conj(Z_{N-k})) / 2``;  ``Y_k = -i (Z_k - conj(Z_{N-k})) / 2``
    (``fft/rfft.hpp:44-63``). Returns the first N/2+1 bins of each.
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    n = int(n if n is not None else x.shape[-1])
    z = fft_api.fft(x + 1j * y.astype(x.dtype), n=n, backend=backend)
    zr = jnp.roll(z[..., ::-1], 1, axis=-1)  # Z_{N-k}
    k = n // 2 + 1
    xf = 0.5 * (z + jnp.conj(zr))
    yf = -0.5j * (z - jnp.conj(zr))
    return xf[..., :k], yf[..., :k]


def split_fft(re, im, n: int | None = None):
    """C2C FFT over planar re/im arrays (no complex dtype anywhere) —
    the split transform. Unnormalized forward."""
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    n = int(n if n is not None else re.shape[-1])
    return matmul_backend.fft_split(re, im, n)


def split_ifft(re, im, n: int | None = None):
    """Inverse split C2C transform, normalized (includes 1/N)."""
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    n = int(n if n is not None else re.shape[-1])
    our, oui = matmul_backend.fft_split(re, im, n, inverse=True)
    return our / n, oui / n


def _pack_twiddles(half: int):
    # Built with jnp ops (not a numpy literal): an embedded array constant
    # costs a flat ~24 ms/call on the remote-execution runtime (see
    # matmul_backend._LITERAL_MAX_BYTES); in-trace trig is microseconds.
    import numpy as np

    k = jnp.arange(half + 1, dtype=jnp.float32)
    ang = k * jnp.float32(-np.pi / half)  # e^{-2 pi i k / (2*half)}
    return jnp.cos(ang), jnp.sin(ang)


def packed_rfft(x, n: int | None = None):
    """True half-size-packed real FFT (reference ``fft/experimental/rfft.hpp:20``).

    Treats the 2N real inputs as N complex samples, runs one N-point C2C
    FFT, and reconstructs the N+1 real-spectrum bins with a post-twiddle —
    half the transform work of the conjugate-symmetry fallback. Returns
    split planes (re, im), each [..., n//2+1]; unnormalized forward,
    matching ``numpy.fft.rfft``.
    """
    x = jnp.asarray(x, jnp.float32)
    if n is None:
        n = x.shape[-1]
    if n % 2:
        raise ValueError("packed rfft requires an even size")
    if x.shape[-1] != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, max(0, n - x.shape[-1]))]
        x = jnp.pad(x[..., :n], pad)
    half = n // 2
    ze = x[..., 0::2]
    zo = x[..., 1::2]
    zre, zim = split_fft(ze, zo, half)  # FFT of z = even + i*odd
    return pack_forward_post(zre, zim, half)


def pack_forward_post(zre, zim, half: int):
    """Post-twiddle of the half-size-packed real FFT: the C2C spectrum of
    z = even + i*odd -> the 2*half-point real spectrum (re, im) planes.

    Extend to k = 0..half via Z[half] = Z[0] (periodicity), then combine:
    X[k] = (Z[k] + conj(Z[half-k]))/2 - i/2 * w^k * (Z[k] - conj(Z[half-k])).
    Shared by the direct packed path here and the large-N four-step rfft.
    """
    zre_e = jnp.concatenate([zre, zre[..., :1]], axis=-1)
    zim_e = jnp.concatenate([zim, zim[..., :1]], axis=-1)
    rre = zre_e[..., ::-1]
    rim = zim_e[..., ::-1]
    are = 0.5 * (zre_e + rre)
    aim = 0.5 * (zim_e - rim)
    bre = 0.5 * (zre_e - rre)
    bim = 0.5 * (zim_e + rim)
    wre, wim = _pack_twiddles(half)
    # -i * w * b  = (-i)(wre + i wim)(bre + i bim)
    tre = wre * bim + wim * bre
    tim = wim * bim - wre * bre
    return are + tre, aim + tim


def packed_irfft(re, im, n: int | None = None):
    """Inverse of ``packed_rfft``: N+1 spectrum bins -> 2N reals, normalized
    (1/N overall, numpy-style)."""
    re = jnp.asarray(re, jnp.float32)
    im = jnp.asarray(im, jnp.float32)
    if n is None:
        n = 2 * (re.shape[-1] - 1)
    half = n // 2
    zre, zim = pack_inverse_pre(re, im, half)
    yre, yim = split_ifft(zre, zim, half)  # normalized (1/half) inverse
    return jnp.stack([yre, yim], axis=-1).reshape(yre.shape[:-1] + (n,))


def pack_inverse_pre(re, im, half: int):
    """Pre-twiddle of the packed inverse: the 2*half-point real spectrum ->
    the C2C spectrum of z = even + i*odd (to be inverse-transformed at size
    half). Undoes :func:`pack_forward_post`:
    A = (X + conj(X~))/2, B = w^{-k} * i/2 * (X - conj(X~))."""
    wre, wim = _pack_twiddles(half)
    xr_r = re[..., ::-1]
    xi_r = im[..., ::-1]
    are = 0.5 * (re + xr_r)
    aim = 0.5 * (im - xi_r)
    dre = 0.5 * (re - xr_r)
    dim = 0.5 * (im + xi_r)
    # i * conj(w) * d = i (wre - i wim)(dre + i dim)
    tre = -(wre * dim - wim * dre)
    tim = wre * dre + wim * dim
    return (are + tre)[..., :half], (aim + tim)[..., :half]
