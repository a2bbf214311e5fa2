"""Frequency-delay-line storage and the partition MAC-reduce.

Counterpart of the reference's FDL machinery:
``fdl_index`` (``src/neo/convolution/fdl_index.hpp:13-36``),
``dense_fdl``/``dense_split_fdl`` (``dense_fdl.hpp:14,38``),
``compressed_fdl`` (``compressed_fdl.hpp:17``) and the hot complex
``multiply_add`` reduction (``algorithm/multiply_add.hpp:280-368``).

Two layouts:

*shift* — the delay line stores the newest spectrum at partition 0
(``fdl[j]`` = spectrum ``j`` blocks old); insertion shifts the whole
array. Simple, but the shift rewrites all P*C*K entries per block — 3x
the theoretical memory traffic.

*ring* (default) — like the reference, a ring buffer plus a modular write
position (``fdl_index.hpp:24-36``): insertion is a single-row
``dynamic_update_slice`` (in-place in the scan carry under XLA buffer
donation), and instead of gathering filter partitions with
``(write_pos + P - segment) % P`` per step, the filter is stored
*reversed and tiled twice* ``[2P, C', K]`` so the correctly-rotated
filter view is one contiguous ``dynamic_slice`` starting at
``P - 1 - write_pos``. Per block the ring path touches ~P*C*K reads +
one row write — speed-of-light for this memory-bound MAC.

Layouts:
  dense       : complex64  ``[P, C, K]``
  split/bf16  : f32/bf16   ``[2, P, C, K]``  (plane 0 = re, 1 = im)
  int16/int8  : tuple of intN ``[2, P, C, K]`` + f32 scales ``[P, C, G]``

Quantization note: the reference's ``compressed_fdl`` quantizes at a fixed
full-scale of 1.0, which clips real FFT spectra (its own test only feeds
values in [-1, 1], ``compressed_fdl_test.cpp``). Here each inserted spectrum
is quantized with *dynamic scales* (max-abs / int_max) carried alongside
the integers, one per channel and group of K/G lanes; the dequant multiply
fuses into the MAC. This meets the reference's documented tolerance bounds
(int8 5e-3 / int16 1e-4) on real unit-range signals, not just
pre-normalized spectra.

Scale groups: a block spectrum of broadband audio is close to white, so
one scale per whole [2, K] row loads an int8 quantizer at the row's
extreme value (~3.7 sigma for K=512) and caps the storage at ~41 dB, below
the int8 class (46 dB). One scale per ``QUANT_LANES["int8"]`` = 4 lanes
(8 values over both planes) brings it to ~48 dB for 4 bytes of scale per
8 bytes of codes. int16 has 48 dB of headroom and keeps one scale per row.
Groups need K divisible by the group width: the packed layout (K = B);
the unpacked layout (K = B + 1) keeps row scales.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from neojax.ops.quantize import int_max_for

__all__ = [
    "STORAGE_DTYPES",
    "QUANT_LANES",
    "quant_groups",
    "quantize_split",
    "dequantize_split",
    "fdl_init",
    "fdl_push_dense",
    "fdl_push_split",
    "fdl_mac_dense",
    "fdl_mac_split",
    "tile_reverse_filter",
    "rotated_filter",
    "fdl_ring_push_dense",
    "fdl_ring_push_split",
    "fdl_packed_init",
    "fdl_packed_push",
    "dcny_mac",
]

STORAGE_DTYPES = {
    "dense": jnp.complex64,
    "split": jnp.float32,
    "bf16": jnp.bfloat16,
    "int16": jnp.int16,
    "int8": jnp.int8,
}


# Lanes per dynamic scale for the quantized storages (see module docstring).
QUANT_LANES = {"int8": 4}


def _is_quantized(dtype) -> bool:
    return jnp.dtype(dtype) in (jnp.dtype(jnp.int8), jnp.dtype(jnp.int16))


def quant_groups(storage: str, lanes: int) -> int:
    """Scale groups G per [2, lanes] row: ``lanes / QUANT_LANES`` where
    that divides, else one scale per row."""
    width = QUANT_LANES.get(storage)
    if width is None or lanes % width:
        return 1
    return lanes // width


def quantize_split(spec, dtype, groups: int):
    """spec [2, ..., K] f32 -> (codes [2, ..., K] ``dtype``, scales
    [..., G] f32): one max-abs scale per group of K/G lanes, shared by
    both planes."""
    m = int_max_for(dtype)
    k = spec.shape[-1]
    grp = spec.reshape(spec.shape[:-1] + (groups, k // groups))
    peak = jnp.max(jnp.abs(grp), axis=(0, grp.ndim - 1))  # [..., G]
    scale = jnp.where(peak > 0, peak, 1.0)
    q = jnp.clip(jnp.round(grp / scale[None, ..., None] * m), -m, m)
    return q.astype(dtype).reshape(spec.shape), scale


def _lane_scales(scales, lanes: int):
    """Group scales [..., G] repeated per lane [..., lanes]: an index map
    XLA fuses into the MAC's reduction (reshaping the planes into groups
    instead made the GPU compiler write a transposed f32 copy of them)."""
    return jnp.repeat(scales, lanes // scales.shape[-1], axis=-1)


def dequantize_split(planes, scales):
    """Inverse of ``quantize_split``: codes [2, ..., K] with scales
    [..., G] -> f32 [2, ..., K]."""
    if scales.shape[-1] > 1:
        scales = _lane_scales(scales, planes.shape[-1])
    return planes.astype(jnp.float32) * (scales * (1.0 / int_max_for(planes.dtype)))[None]


def fdl_init(storage: str, num_partitions: int, channels: int, bins: int):
    dtype = STORAGE_DTYPES[storage]
    if storage == "dense":
        return jnp.zeros((num_partitions, channels, bins), dtype)
    planes = jnp.zeros((2, num_partitions, channels, bins), dtype)
    if _is_quantized(dtype):
        g = quant_groups(storage, bins)
        return (planes, jnp.ones((num_partitions, channels, g), jnp.float32))
    return planes


def fdl_push_dense(fdl: jnp.ndarray, spec: jnp.ndarray) -> jnp.ndarray:
    """Insert spec [C, K] as the newest entry of fdl [P, C, K]."""
    return jnp.concatenate([spec[None], fdl[:-1]], axis=0)


def fdl_push_split(fdl, spec_re: jnp.ndarray, spec_im: jnp.ndarray):
    """Insert (re, im) [C, K] planes into the split FDL.

    Float storage (f32/bf16): fdl is [2, P, C, K]; plain cast + shift.
    Int storage: fdl is a (planes [2,P,C,K], scales [P,C,G]) tuple; the
    spectrum is quantized at dynamic per-group scales (``quantize_split``).
    """
    spec = jnp.stack([spec_re, spec_im])  # [2, C, K]
    if isinstance(fdl, tuple):
        planes, scales = fdl
        q, scale = quantize_split(spec, planes.dtype, scales.shape[-1])
        new_planes = jnp.concatenate([q[:, None], planes[:, :-1]], axis=1)
        new_scales = jnp.concatenate([scale[None], scales[:-1]], axis=0)
        return (new_planes, new_scales)
    spec = spec.astype(fdl.dtype)
    return jnp.concatenate([spec[:, None], fdl[:, :-1]], axis=1)


def fdl_mac_dense(fdl: jnp.ndarray, filt: jnp.ndarray) -> jnp.ndarray:
    """acc[c,k] = sum_p fdl[p,c,k] * filt[p,c,k] (filt channel dim may be 1)."""
    return jnp.sum(fdl * filt, axis=0)


# ----------------------------------------------------------------- ring ops


def tile_reverse_filter(filt: jnp.ndarray) -> jnp.ndarray:
    """[P, C', K] -> [2P, C', K] reversed+tiled, so that the rotation
    ``filt[(w - i) % P]`` for i in 0..P-1 equals the contiguous window
    ``tiled[P - 1 - w : 2P - 1 - w]``."""
    rev = filt[::-1]
    return jnp.concatenate([rev, rev], axis=0)


def rotated_filter(filt_tiled: jnp.ndarray, write_pos, num_partitions: int) -> jnp.ndarray:
    """Contiguous dynamic-slice view of the tiled filter aligned to the ring:
    result[i] = filt[(write_pos - i) mod P], i.e. the partition that must
    multiply ring slot i (which holds the spectrum aged (write_pos - i) mod P)."""
    start = num_partitions - 1 - write_pos
    return jax.lax.dynamic_slice_in_dim(filt_tiled, start, num_partitions, axis=0)


def fdl_ring_push_dense(fdl: jnp.ndarray, spec: jnp.ndarray, write_pos) -> jnp.ndarray:
    """In-place (donated) insert of spec [C, K] at ring slot write_pos."""
    z = jnp.zeros((), write_pos.dtype)
    return jax.lax.dynamic_update_slice(fdl, spec[None].astype(fdl.dtype), (write_pos, z, z))


def fdl_ring_push_split(fdl, spec_re, spec_im, write_pos):
    spec = jnp.stack([spec_re, spec_im])  # [2, C, K]
    if isinstance(fdl, tuple):
        planes, scales = fdl
        q, scale = quantize_split(spec, planes.dtype, scales.shape[-1])
        z = jnp.zeros((), write_pos.dtype)
        new_planes = jax.lax.dynamic_update_slice(planes, q[:, None], (z, write_pos, z, z))
        new_scales = jax.lax.dynamic_update_slice(scales, scale[None], (write_pos, z, z))
        return (new_planes, new_scales)
    z = jnp.zeros((), write_pos.dtype)
    return jax.lax.dynamic_update_slice(
        fdl, spec[:, None].astype(fdl.dtype), (z, write_pos, z, z)
    )


# ------------------------------------------------------- packed-512 layout
#
# For even transform sizes the (B+1)-bin spectrum carries two always-real
# values (DC and Nyquist). The packed layout stores exactly B lanes — a
# power of two. Lane 0 holds DC.re in the re-plane and Nyquist.re in the
# im-plane (the vDSP/FFTW packed convention; the reference's vDSP backend
# uses the same trick, fft/backend/vdsp.hpp). The DFT matmuls absorb the
# packing for free (matmul_backend.rfft_packed_split); the complex MAC
# stays branch-free because the DC/Nyquist history rides in a separate
# tiny f32 side-carry ([P, C, 2]) whose exact product overwrites the
# garbage lane-0 MAC output.


def fdl_packed_init(storage: str, num_partitions: int, channels: int, block: int):
    """Packed-layout FDL state: (planes-or-(planes,scales), dcny [P,C,2])."""
    dtype = STORAGE_DTYPES[storage]
    if storage == "dense":
        raise ValueError("packed layout is split-plane only")
    planes = jnp.zeros((2, num_partitions, channels, block), dtype)
    dcny = jnp.zeros((num_partitions, channels, 2), jnp.float32)
    if _is_quantized(dtype):
        g = quant_groups(storage, block)
        return (planes, jnp.ones((num_partitions, channels, g), jnp.float32)), dcny
    return planes, dcny


def fdl_packed_push(fdl, dcny, spec_re, spec_im, write_pos):
    """Ring-insert a packed spectrum ([C, B] planes) + its exact DC/Ny pair."""
    new_fdl = fdl_ring_push_split(fdl, spec_re, spec_im, write_pos)
    pair = jnp.stack([spec_re[:, 0], spec_im[:, 0]], axis=-1)  # [C, 2]
    z = jnp.zeros((), write_pos.dtype)
    new_dcny = jax.lax.dynamic_update_slice(dcny, pair[None], (write_pos, z, z))
    return new_fdl, new_dcny


def dcny_mac(dcny: jnp.ndarray, filt_dcny: jnp.ndarray):
    """Exact DC/Nyquist partition reduce: [P, C, 2] x [P, C', 2] -> [C, 2]
    (the two real-only bins are plain real MACs, no cross terms)."""
    return jnp.sum(dcny * filt_dcny, axis=0)


def fdl_mac_split(fdl, filt_re: jnp.ndarray, filt_im: jnp.ndarray):
    """Split-complex MAC-reduce with fused dequantization.

    fdl: [2, P, C, K] float planes, or (int planes, scales) tuple.
    filt planes [P, C', K] f32 with C' in {C, 1}.
    Returns (acc_re, acc_im) [C, K] f32, accumulating in f32.
    """
    norm = None
    if isinstance(fdl, tuple) and fdl[1].shape[-1] > 1:
        # group scales: codes * lane scales, with the 1/int_max applied
        # once after the sum (scaling the [P, C, G] table first costs a
        # pass over it). Row scales keep the pre-scaled form below: on an
        # H100 it ran the per-block int16 step at 122 us/block, this one
        # at 140.
        planes, scales = fdl
        x = planes.astype(jnp.float32) * _lane_scales(scales, planes.shape[-1])[None]
        norm = 1.0 / int_max_for(planes.dtype)
    elif isinstance(fdl, tuple):
        x = dequantize_split(*fdl)
    else:
        x = fdl.astype(jnp.float32)
    xr, xi = x[0], x[1]
    acc_re = jnp.sum(xr * filt_re - xi * filt_im, axis=0)
    acc_im = jnp.sum(xr * filt_im + xi * filt_re, axis=0)
    if norm is not None:
        acc_re, acc_im = acc_re * norm, acc_im * norm
    return acc_re, acc_im
