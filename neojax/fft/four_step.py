"""Large-N FFT via the recursive 4-step (Bailey) decomposition as GEMMs.

Plays the role of the reference's large-order plan family (its fallback
plans go to order 27, ``c2c_dit2_plan.hpp:22``): for N = N1*N2 the DFT
factors into

  1. N1-point DFTs over the n1 axis of the [N1, N2] reshape,
  2. twiddle multiply by W_N^(n2*k1),
  3. N2-point DFTs over the n2 axis,
  4. index transpose (output k = k1 + N1*k2).

Leaf DFTs are [batch, R] @ [R, R] matmuls (split-complex; no complex
dtype on device). Factors above the leaf cutoff recurse, which trades one
O(N) twiddle + transpose pass per level for an O(N * factor) matmul and
removes any upper size limit (any power of two that fits in memory).

Real transforms use the half-size packing trick (one N/2 C2C + an O(N)
post-twiddle, ``fft/experimental/rfft.hpp:20``) instead of a zero-imag
full transform — half the matmul work of the conjugate-symmetry fallback.

All transforms are unnormalized forward / normalized inverse at the
``fft.api`` layer's conventions.
"""

from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp

from neojax.core.bits import bit_log2
from neojax.fft import matmul_backend

__all__ = [
    "fft_split_large",
    "rfft_split_large",
    "irfft_split_large",
    "rfft_packed_split_large",
    "irfft_packed_split_large",
    "split_n",
]

# Largest leaf DFT evaluated as a dense matmul. 512 and 256 measure within
# noise of each other at N in [2^17, 2^22]; both beat 1024+ (flops scale
# with the factor size) and 128- (too many twiddle/transpose passes).
_LEAF = 512


def split_n(n: int) -> tuple[int, int]:
    """Factor pow-2 N into N1*N2, as square as possible (N1 <= N2)."""
    if n & (n - 1):
        raise ValueError(f"four-step FFT requires a power of two, got {n}")
    log = bit_log2(n)
    l1 = log // 2
    return 1 << l1, 1 << (log - l1)


@functools.lru_cache(maxsize=16)
def _twiddles_np(n1: int, n2: int):
    # W_N^(n2*k1) over [N2, K1=N1].
    n = n1 * n2
    n2_idx = np.arange(n2)
    k1 = np.arange(n1)
    ang = -2.0 * np.pi * np.outer(n2_idx, k1) / n  # [N2, N1]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _twiddles(n1: int, n2: int, inverse: bool):
    """[N2, N1] twiddle planes; in-trace above the literal cap (the n=2^20
    table alone is 8 MB — same HLO-literal hazard as the DFT matrices)."""
    n = n1 * n2
    if matmul_backend._use_traced(n, n2, n1):
        c, s = matmul_backend._cs_traced(n2, n1, n)
        return c, (s if inverse else -s)
    tc, ts = _twiddles_np(n1, n2)
    tc = jnp.asarray(tc)
    ts = jnp.asarray(ts) * (-1.0 if inverse else 1.0)
    return tc, ts


def fft_split_large(re, im, n: int, inverse: bool = False):
    """C2C DFT of size n (pow-2, possibly huge) in split layout over the
    last axis. Unnormalized in both directions (api layer applies norms).

    Decimation: t = n1*N2 + n2, k = k1 + N1*k2 ->
    ``X[k1 + N1 k2] = DFT_n2( W_N^(n2 k1) * DFT_n1(x[., n2])[k1] )[k2]``.
    """
    if n <= _LEAF:
        return matmul_backend.fft_split(re, im, n, inverse=inverse)
    n1, n2 = split_n(n)
    tc, ts = _twiddles(n1, n2, inverse)

    batch_shape = re.shape[:-1]
    xr = re.reshape(*batch_shape, n1, n2)
    xi = im.reshape(*batch_shape, n1, n2)

    # Step 1: N1-point DFTs over the n1 axis (transpose so it is last).
    xr = jnp.swapaxes(xr, -1, -2)  # [.., N2, N1]
    xi = jnp.swapaxes(xi, -1, -2)
    ar, ai = fft_split_large(xr, xi, n1, inverse)  # [.., N2, K1]

    # Step 2: twiddle multiply W_N^(n2*k1).
    br = ar * tc - ai * ts
    bi = ar * ts + ai * tc

    # Step 3: N2-point DFTs over the n2 axis.
    br = jnp.swapaxes(br, -1, -2)  # [.., K1, N2]
    bi = jnp.swapaxes(bi, -1, -2)
    cr, ci = fft_split_large(br, bi, n2, inverse)  # [.., K1, K2]

    # Step 4: output index k = k1 + N1*k2 -> flatten [K2, K1].
    cr = jnp.swapaxes(cr, -1, -2)
    ci = jnp.swapaxes(ci, -1, -2)
    return cr.reshape(*batch_shape, n), ci.reshape(*batch_shape, n)


def rfft_split_large(x, n: int):
    """Real [..., n] -> (re, im) [..., n//2+1] for huge pow-2 n, via the
    half-size packed transform (one n/2-point C2C)."""
    from neojax.fft.extras import pack_forward_post

    x = x.astype(jnp.float32)
    if x.shape[-1] != n:
        pad = [(0, 0)] * (x.ndim - 1) + [(0, max(0, n - x.shape[-1]))]
        x = jnp.pad(x[..., :n], pad)
    half = n // 2
    zre, zim = fft_split_large(x[..., 0::2], x[..., 1::2], half)
    return pack_forward_post(zre, zim, half)


def rfft_packed_split_large(x, n: int):
    """Real [..., n] -> PACKED (re, im) planes, each [..., n//2].

    The packed-512 lane convention of the streaming convolver (lane 0 of
    the im-plane holds Nyquist.re; see ``matmul_backend.rfft_packed_split``)
    evaluated through the four-step recursion instead of a dense [N, B]
    matmul. At block 4096 (N = 8192) the dense matrices are ~2 x 134 MB and
    get re-read from device memory every streamed block — this path touches
    only O(batch * N) data per pass plus a few KB of leaf matrices (the
    reference's block-4096 benchmark grid,
    ``extra/benchmark/src/convolution.cpp:47-50``).
    """
    re, im = rfft_split_large(x, n)
    b = n // 2
    pim = im[..., :b].at[..., 0].set(re[..., b])
    return re[..., :b], pim


def irfft_packed_split_large(re, im, n: int):
    """PACKED (re, im) [..., n//2] -> real [..., n], normalized (1/n).

    Inverse of :func:`rfft_packed_split_large`; consumes the convolver's
    accumulator whose lane 0 holds the exact (DC, Nyquist) real MACs.
    """
    b = n // 2
    ny = im[..., :1]
    fre = jnp.concatenate([re, ny], axis=-1)
    fim = jnp.concatenate([im.at[..., 0].set(0.0), jnp.zeros_like(ny)], axis=-1)
    return irfft_split_large(fre, fim, n)


def irfft_split_large(re, im, n: int):
    """(re, im) [..., n//2+1] -> real [..., n], normalized (1/n), via the
    half-size packed inverse."""
    from neojax.fft.extras import pack_inverse_pre

    half = n // 2
    zre, zim = pack_inverse_pre(re, im, half)
    yre, yim = fft_split_large(zre, zim, half, inverse=True)
    out = jnp.stack([yre, yim], axis=-1).reshape(yre.shape[:-1] + (n,))
    return out / half
