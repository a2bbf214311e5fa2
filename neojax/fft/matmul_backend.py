"""DFT-as-matmul backend: real and complex DFTs as dense GEMMs.

An interchangeable engine behind the transform API, in the role of the
reference's *vendor FFT backends* (``src/neo/fft/backend/{vdsp,ipp,mkl}.hpp``).
For the block sizes of partitioned convolution (N <= ~8192) the DFT is
evaluated as a dense [batch, N] @ [N, K] matmul, which fuses with
neighbouring elementwise work; whether it beats ``jnp.fft`` on a given
device and cell is a measurement, not an assumption.

All matrices are built in float64 on host, cast to float32 (plenty for the
reference's 1e-5 parity bound), cached per size, and contracted with
``preferred_element_type=float32``.

The backend is *split-complex native*: it produces/consumes separate
real/imag planes, the layout every split-plane delay line stores.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

__all__ = [
    "rfft_matrices",
    "irfft_matrices",
    "rfft_split",
    "irfft_split",
    "rfft_cat_matrices",
    "irfft_cat_matrices",
    "rfft_split_cat",
    "irfft_split_cat",
    "rfft_packed_matrices",
    "irfft_packed_matrices",
    "rfft_packed_split",
    "irfft_packed_split",
    "rfft",
    "irfft",
    "fft_matrices",
    "fft_split",
]

# Per-matrix byte cap for embedding host-built matrices as program literals.
# Above this (when called under tracing, power-of-two size) the matrices are
# generated in-trace instead: giant HLO literals bloat the program and its
# compile time. In-trace generation costs a little trig once per call
# (hoist it outside lax.scan — XLA does NOT hoist it for you; see
# ``_transform_mats`` in ``conv.convolver``). So: literals only below 4 KB
# (where XLA may fold them into neighbours), in-trace generation elsewhere.
_LITERAL_MAX_BYTES = 4 << 10


def _use_traced(n: int, rows: int, cols: int) -> bool:
    if rows * cols * 4 <= _LITERAL_MAX_BYTES:
        return False
    if n & (n - 1) or n < 4:
        return False  # quadrant reduction below needs power-of-two n
    # Under a trace (jit/vmap/scan) fresh arrays come back as tracers; only
    # then does literal-vs-traced matter (eager calls just upload buffers).
    return isinstance(jnp.zeros(()), jax.core.Tracer)


def _cs_traced(rows: int, cols: int, n: int):
    """cos/sin(2*pi*(i*j mod n)/n) as [rows, cols] f32, built in-trace.

    The angle is reduced exactly: m = (i*j) & (n-1) in int32 (wraparound-safe
    for power-of-two n), split into quadrant q = m // (n/4) and residue r, so
    the only rounding is theta = r * (2*pi/n) with r < n/4 exact in f32. The
    resulting matrix entries match the host float64-built literals to ~2e-7 —
    far inside the framework's 1e-5 parity bound — while keeping the lowered
    program a few KB instead of embedding O(n^2) floats.
    """
    i = lax.broadcasted_iota(jnp.int32, (rows, cols), 0)
    j = lax.broadcasted_iota(jnp.int32, (rows, cols), 1)
    m = (i * j) & (n - 1)
    quarter = n // 4
    q = m // quarter
    r = m - q * quarter
    theta = r.astype(jnp.float32) * np.float32(2.0 * np.pi / n)
    ct = jnp.cos(theta)
    st = jnp.sin(theta)
    c = jnp.where(q == 0, ct, jnp.where(q == 1, -st, jnp.where(q == 2, -ct, st)))
    s = jnp.where(q == 0, st, jnp.where(q == 1, ct, jnp.where(q == 2, -st, -ct)))
    return c, s


@functools.lru_cache(maxsize=64)
def _rfft_mats_np(n: int):
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n  # [N, K]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _irfft_mats_np(n: int):
    # x_t = (1/N) sum_k w_k (Re_k cos(2 pi k t / N) - Im_k sin(2 pi k t / N)),
    # w_k = 2 except DC and Nyquist (assumes even n, conjugate symmetry).
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2.0 * np.pi * np.outer(k, t) / n  # [K, N]
    w = np.full((n // 2 + 1, 1), 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    a = (w * np.cos(ang) / n).astype(np.float32)
    b = (-w * np.sin(ang) / n).astype(np.float32)
    return a, b


@functools.lru_cache(maxsize=64)
def _fft_mats_np(n: int):
    k = np.arange(n)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n  # [N, N]
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def rfft_matrices(n: int):
    k = n // 2 + 1
    if _use_traced(n, n, k):
        c, s = _cs_traced(n, k, n)
        return c, -s  # forward angle is negative
    c, s = _rfft_mats_np(n)
    return jnp.asarray(c), jnp.asarray(s)


def irfft_matrices(n: int):
    k = n // 2 + 1
    if _use_traced(n, k, n):
        c, s = _cs_traced(k, n, n)
        w = jnp.full((k, 1), 2.0, jnp.float32).at[0].set(1.0)
        if n % 2 == 0:
            w = w.at[-1].set(1.0)
        return w * c / n, -(w * s) / n
    a, b = _irfft_mats_np(n)
    return jnp.asarray(a), jnp.asarray(b)


def fft_matrices(n: int):
    if _use_traced(n, n, n):
        c, s = _cs_traced(n, n, n)
        return c, -s
    c, s = _fft_mats_np(n)
    return jnp.asarray(c), jnp.asarray(s)


def _matmul(x, m, precision=lax.Precision.HIGHEST):
    # Precision.HIGHEST (default): true f32 products. On the GPU, DEFAULT
    # and HIGH both run f32 operands as TF32 (10-bit mantissa), whose error
    # would blow the reference's 1e-5 parity bound — reduced-precision
    # engines pass a lower precision explicitly where their storage floor
    # is the larger error.
    #
    # bf16 OPERANDS are accepted on the DEFAULT path only: callers that keep
    # their big tensors bf16 end-to-end halve their memory traffic. A bf16
    # operand with a higher precision request is upcast instead — the
    # downcast must never silently defeat an exactness ask.
    if x.dtype == jnp.bfloat16 and m.dtype != jnp.bfloat16:
        if precision in (None, lax.Precision.DEFAULT):
            m = m.astype(jnp.bfloat16)
        else:
            x = x.astype(jnp.float32)
    return lax.dot_general(
        x,
        m,
        dimension_numbers=(((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=precision,
    )


def rfft_split(x: jnp.ndarray, n: int, precision=lax.Precision.HIGHEST,
               mats=None):
    """Real [..., n] -> (re, im) each [..., n//2+1], unnormalized forward."""
    c, s = mats if mats is not None else rfft_matrices(n)
    if x.dtype != jnp.bfloat16:
        x = x.astype(jnp.float32)
    return _matmul(x, c, precision), _matmul(x, s, precision)


def irfft_split(
    re: jnp.ndarray, im: jnp.ndarray, n: int,
    precision=lax.Precision.HIGHEST, mats=None,
) -> jnp.ndarray:
    """(re, im) [..., n//2+1] -> real [..., n]; includes the 1/N factor
    (i.e. numpy-style normalized inverse)."""
    a, b = mats if mats is not None else irfft_matrices(n)
    if re.dtype != jnp.bfloat16:
        re = re.astype(jnp.float32)
        im = im.astype(jnp.float32)
    return _matmul(re, a, precision) + _matmul(im, b, precision)


@functools.lru_cache(maxsize=32)
def _rfft_packed_mats_np(n: int):
    """Forward matrices for the PACKED spectrum layout: K = n/2 lanes where
    lane 0 of the re-plane holds DC.re and lane 0 of the im-plane holds
    Nyquist.re (both imaginary parts are identically zero for real input —
    the classic vDSP/FFTW packed format, here absorbed into the DFT matmul
    columns so the packing costs nothing)."""
    assert n % 2 == 0
    b = n // 2
    k = np.arange(b)
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, k) / n  # [N, B]
    c = np.cos(ang)
    s = np.sin(ang)
    # im-plane lane 0 := Nyquist real = sum_t x_t cos(pi t)
    s[:, 0] = np.cos(np.pi * t)
    return c.astype(np.float32), s.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _irfft_packed_mats_np(n: int):
    """Inverse matrices consuming the packed layout (with 1/n), absorbing
    the Nyquist row into the im-plane matrix (lane 0 multiplies Ny.re)."""
    assert n % 2 == 0
    b = n // 2
    a, bm = _irfft_mats_np(n)  # [B+1, N] each
    a2 = a[:b].copy()
    b2 = bm[:b].copy()
    b2[0] = a[b]  # Nyquist cos row (weight 1), multiplies Im-plane lane 0
    return a2, b2


def packed_mats_np(n: int):
    """Stacked packed-DFT matrices as host numpy: (cs [2, N, B] forward
    cos|sin, ab [2, B, N] inverse with 1/N). Test/oracle convenience —
    the convolver paths build these via the TRACED generators instead
    (rfft_packed_matrices / irfft_packed_matrices), which avoid embedding
    large HLO literals."""
    c, s = _rfft_packed_mats_np(n)
    a, b = _irfft_packed_mats_np(n)
    return np.stack([c, s]), np.stack([a, b])


def rfft_packed_matrices(n: int):
    """Packed forward matrices, in-trace above the literal cap (block 4096
    would otherwise embed ~536 MB of constants)."""
    b = n // 2
    if _use_traced(n, n, b):
        c, s = _cs_traced(n, b, n)
        t = lax.broadcasted_iota(jnp.int32, (n, b), 0)
        j = lax.broadcasted_iota(jnp.int32, (n, b), 1)
        # forward angle is negative; im-plane lane 0 = Nyquist cos column
        ny = jnp.where(t % 2 == 0, 1.0, -1.0)
        return c, jnp.where(j == 0, ny, -s)
    c, s = _rfft_packed_mats_np(n)
    return jnp.asarray(c), jnp.asarray(s)


def irfft_packed_matrices(n: int):
    b = n // 2
    if _use_traced(n, b, n):
        c, s = _cs_traced(b, n, n)
        k = lax.broadcasted_iota(jnp.int32, (b, n), 0)
        t = lax.broadcasted_iota(jnp.int32, (b, n), 1)
        w = jnp.where(k == 0, 1.0, 2.0)
        a2 = w * c * np.float32(1.0 / n)
        b2 = -(w * s) * np.float32(1.0 / n)
        nyrow = jnp.where(t % 2 == 0, 1.0, -1.0) * np.float32(1.0 / n)
        return a2, jnp.where(k == 0, nyrow, b2)
    a, bm = _irfft_packed_mats_np(n)
    return jnp.asarray(a), jnp.asarray(bm)


def rfft_packed_split(x: jnp.ndarray, n: int,
                      precision=lax.Precision.HIGHEST, mats=None):
    """Real [..., n] -> packed (re, im) each [..., n//2]: bins 0..n/2-1 with
    Nyquist.re stored in the im-plane's DC lane. Lane count n/2 is a
    power of two for power-of-two n.

    ``mats``: optional precomputed (c, s) — callers inside lax.scan MUST
    pass matrices built outside the loop for in-trace sizes, or the
    trig generation reruns every iteration (~4.5 ms/block at N=8192)."""
    c, s = mats if mats is not None else rfft_packed_matrices(n)
    x = x.astype(jnp.float32)
    return _matmul(x, c, precision), _matmul(x, s, precision)


def irfft_packed_split(
    re: jnp.ndarray, im: jnp.ndarray, n: int,
    precision=lax.Precision.HIGHEST, mats=None,
) -> jnp.ndarray:
    """Packed (re, im) [..., n//2] -> real [..., n], normalized (1/n)."""
    a, b = mats if mats is not None else irfft_packed_matrices(n)
    return _matmul(re.astype(jnp.float32), a, precision) + _matmul(
        im.astype(jnp.float32), b, precision
    )


def rfft_cat_matrices(n: int):
    """[N, 2K] forward matrix: columns [cos | sin], so ONE GEMM yields the
    lane-packed spectrum [re | im]. Same flops as the two-matmul form,
    fewer, wider GEMMs."""
    c, s = rfft_matrices(n)
    return jnp.concatenate([c, s], axis=1)


def irfft_cat_matrices(n: int):
    """[2K, N] inverse matrix consuming lane-packed [re | im] (1/N folded):
    y = [re | im] @ vstack(a, b) — one GEMM instead of two + add."""
    a, b = irfft_matrices(n)
    return jnp.concatenate([a, b], axis=0)


def rfft_split_cat(x: jnp.ndarray, n: int, precision=lax.Precision.HIGHEST,
                   mats=None):
    """Like :func:`rfft_split` but via the single concatenated GEMM.
    Returns (re, im) views of the packed output."""
    m = mats if mats is not None else rfft_cat_matrices(n)
    if x.dtype != jnp.bfloat16:
        x = x.astype(jnp.float32)
    sp = _matmul(x, m, precision)
    k = n // 2 + 1
    return sp[..., :k], sp[..., k:]


def irfft_split_cat(re: jnp.ndarray, im: jnp.ndarray, n: int,
                    precision=lax.Precision.HIGHEST, mats=None) -> jnp.ndarray:
    """Like :func:`irfft_split` (normalized inverse) via one GEMM on the
    lane-packed accumulator."""
    m = mats if mats is not None else irfft_cat_matrices(n)
    sp = jnp.concatenate([re, im], axis=-1)
    if sp.dtype != jnp.bfloat16:
        sp = sp.astype(jnp.float32)
    return _matmul(sp, m, precision)


def rfft(x: jnp.ndarray, n: int) -> jnp.ndarray:
    re, im = rfft_split(x, n)
    return lax.complex(re, im)


def irfft(spec: jnp.ndarray, n: int) -> jnp.ndarray:
    return irfft_split(jnp.real(spec), jnp.imag(spec), n)


def fft_split(
    re: jnp.ndarray,
    im: jnp.ndarray,
    n: int,
    inverse: bool = False,
    precision=lax.Precision.HIGHEST,
):
    """Full C2C DFT in split layout; unnormalized in both directions."""
    c, s = fft_matrices(n)
    if inverse:
        # Conjugate twiddles: cos unchanged, sin negated.
        out_re = _matmul(re, c, precision) + _matmul(im, s, precision)
        out_im = _matmul(im, c, precision) - _matmul(re, s, precision)
    else:
        out_re = _matmul(re, c, precision) - _matmul(im, s, precision)
        out_im = _matmul(re, s, precision) + _matmul(im, c, precision)
    return out_re, out_im
