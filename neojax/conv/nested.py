"""Nested (two-level) FDL convolution: the large-IR throughput engine.

The chunked Toeplitz engine (``conv.chunked``) materializes the partition
MAC as a batched matmul whose [K, 2S, 2M] operand re-reads ~S shifted copies
of the filter every chunk. This module removes that expansion with a
classic recursive observation: per frequency bin, the FDL reduction

    acc[s, k] = sum_j filt[j, k] * spec[s - j, k]          (j = 0..P-1)

is *itself a streaming convolution* — of the block-spectra stream with the
filter's partition sequence. So apply uniformly-partitioned OLS again, one
level up ("meta"), along the frame axis:

  - chunk S blocks -> block rfft -> S new spectra frames  [S, C, K]
  - meta window = [previous S frames | new S frames]      (OLS, length 2S)
  - C2C meta-FFT along the frame axis (matmul, size 2S)
  - push into a meta-FDL ring of P2 = P/S meta-partitions
  - elementwise complex MAC against the meta-filter spectra, reduce P2
  - inverse meta-FFT, keep the last S frames (OLS valid part)
  - block irfft -> S output blocks

Per chunk this touches the meta-FDL once (the irreducible read), a
P2-row filter, and O(S^2 * C * K) GEMM flops for the meta transforms —
there is no Toeplitz tensor at all. Two more wins over the Toeplitz form:

  * **per-channel filters cost nothing extra** (the MAC is elementwise,
    so the filter simply carries a C axis instead of broadcasting), and
  * the minor dimension everywhere is the meta-bin axis (2S, a lane
    multiple), not the odd block-bin count K.

Output is mathematically identical to the per-block UPOLS/UPOLA schedule
(reference ``uniform_partitioned_convolver.hpp:48-66``), with latency of
S blocks — same contract as ``conv.chunked``. Partition counts are padded
to a multiple of S with zero partitions (exact).

Layouts: meta-FDL ``[2, P2, C, K, 2S]`` (plane 0 re / 1 im), meta-filter
``[P2, C'|1, K, 2S]`` per plane, ring write position carried like
``fdl_index`` (``fdl_index.hpp:24-36``); shared filters rotate the (small)
filter via the tile-reverse + dynamic-slice trick of ``conv.fdl``.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from neojax.conv import fdl as fdl_lib
from neojax.conv.chunked import _bucket_bands  # noqa: F401
from neojax.conv.chunked import _fft_precisions as _chunked_fft_precisions
from neojax.conv.convolver import PartitionedConfig, _canon_partitions
from neojax.fft import matmul_backend
from neojax.ops.quantize import int_max_for

__all__ = [
    "nested_filter_params",
    "nested_init_state",
    "process_nested",
]


def _meta_fft_filter(plane_re, plane_im, s: int):
    """[P, C', K] split filter partitions -> meta spectra [P2, C', K, 2S]."""
    p, c, k = plane_re.shape
    p2 = -(-p // s)
    pad = p2 * s - p
    if pad:
        z = np.zeros((pad, c, k), plane_re.dtype)
        plane_re = np.concatenate([plane_re, z], axis=0)
        plane_im = np.concatenate([plane_im, z], axis=0)
    # [P2, S, C', K] -> [P2, C', K, S] -> zero-pad frames to 2S -> FFT
    fr = np.moveaxis(plane_re.reshape(p2, s, c, k), 1, -1)
    fi = np.moveaxis(plane_im.reshape(p2, s, c, k), 1, -1)
    fr = np.concatenate([fr, np.zeros_like(fr)], axis=-1)
    fi = np.concatenate([fi, np.zeros_like(fi)], axis=-1)
    n = 2 * s
    t = np.arange(n)
    ang = -2.0 * np.pi * np.outer(t, t) / n
    cm, sm = np.cos(ang), np.sin(ang)
    out_re = fr @ cm - fi @ sm
    out_im = fr @ sm + fi @ cm
    return out_re.astype(np.float32), out_im.astype(np.float32), p2


def nested_filter_params(
    config: PartitionedConfig,
    partitions,
    chunk_blocks: int,
    mask=None,
) -> dict:
    """Build meta-FDL filter params (host-side numpy, like ``filter_params``).

    Shared ([1, P, K]) or per-channel ([C, P, K]) filters both work.
    ``mask``: optional boolean keep-mask ([P, K] or [C|1, P, K]); dropped
    bins are zeroed (sparse semantics; no band compaction at this level —
    use ``conv.chunked`` buckets when band savings matter).
    """
    filt = _canon_partitions(config, np.asarray(partitions)).astype(np.complex64)
    if mask is not None:
        m = np.asarray(mask, bool)
        if m.ndim == 2:
            m = m[None]
        m = np.moveaxis(m, 0, 1)  # [P, C', K]
        if m.shape[0] < filt.shape[0]:
            pad = np.zeros((filt.shape[0] - m.shape[0],) + m.shape[1:], bool)
            m = np.concatenate([m, pad], axis=0)
        filt = np.where(np.broadcast_to(m, filt.shape), filt, 0)

    s = chunk_blocks
    fre, fim, p2 = _meta_fft_filter(
        np.real(filt).astype(np.float32), np.imag(filt).astype(np.float32), s
    )
    dtype = jnp.bfloat16 if config.storage == "bf16" else jnp.float32
    shared = fre.shape[1] == 1
    if shared:
        # tile-reversed for the contiguous rotated view (conv.fdl trick)
        fre = np.concatenate([fre[::-1], fre[::-1]], axis=0)
        fim = np.concatenate([fim[::-1], fim[::-1]], axis=0)
    return {
        "filt_re": jnp.asarray(fre, dtype),
        "filt_im": jnp.asarray(fim, dtype),
    }


# Quantized meta-FDL scale granularity: one dynamic scale per GROUP of
# meta-bins instead of one per whole [2S] row. The meta-spectrum's dynamic
# range across meta-bins is what sinks the int8 rung at production depth
# with a shared row scale: low-magnitude meta-bins quantize to a few codes.
# Group scales cost G extra f32 per (p2, c, k) row and tighten the
# peak-to-rms loading of each group's quantizer (tools/int8_sweep.py
# sweeps G against the 46 dB class, compressed_fdl_test.cpp:24-29, 5e-3).
# int8 runs G=64, about 2 dB over its class.
#
# int16 runs G=1 (one scale per whole row): its 16-bit codes leave ample
# slack over the reference's 74 dB class at row granularity, and a per-row
# scalar broadcast fuses into the XLA MAC for free.
_QUANT_GROUPS = {"int8": 64, "int16": 1}


def _quant_groups(config: PartitionedConfig, s: int) -> int:
    g = min(_QUANT_GROUPS.get(config.storage, 1), 2 * s)
    while (2 * s) % g:
        g -= 1
    return g


def _storage_dtype(config: PartitionedConfig):
    if config.storage == "dense":  # host/CPU convenience: split planes anyway
        return jnp.float32
    return fdl_lib.STORAGE_DTYPES[config.storage]


def _fft_precisions(config: PartitionedConfig):
    """(forward, inverse) transform precision per storage. On the GPU, HIGH
    runs f32 operands as TF32 (10-bit mantissa, the same as DEFAULT):
      int8  HIGH: TF32 error sits below the int8 storage floor (46 dB
            class, compressed_fdl_test.cpp:24-29); HIGHEST adds ~0.1 dB.
      int16 HIGHEST: at TF32 the 10 s-IR rung read ~66 dB on an H100,
            below its 74 dB class.
      bf16 / split: the chunked policy (DEFAULT / HIGHEST)."""
    if config.storage == "int8":
        return (lax.Precision.HIGH, lax.Precision.HIGH)
    return _chunked_fft_precisions(config)


def _meta_gemm_mats(s: int):
    """Single-GEMM split-complex meta transforms.

    Instead of FOUR [.., 2S] @ [2S, 2S] matmuls (re/im x cos/sin),
    operands are packed [re | im] along lanes into ONE [.., 4S] @ [4S, 4S]
    GEMM — identical flops, a 512-deep contraction, fewer launches.
    The inverse additionally keeps only the OLS tail columns (frames
    s..2s-1 of each plane): [4S, 2S], HALF the inverse flops, with the
    1/2S normalization folded in.

    Returns (mf [4S, 4S], mi_tail [4S, 2S]):
      [re | im] @ mf      = [Xre | Xim]           (forward, unnormalized)
      [Are | Aim] @ mi_tail = [yre_tail | yim_tail] (inverse, normalized)
    """
    s2 = 2 * s
    c2, sn = matmul_backend.fft_matrices(s2)
    mf = jnp.concatenate(
        [
            jnp.concatenate([c2, -sn], axis=0),  # -> out_re
            jnp.concatenate([sn, c2], axis=0),  # -> out_im
        ],
        axis=1,
    )
    c2t = c2[:, s:] * (1.0 / s2)
    snt = sn[:, s:] * (1.0 / s2)
    mi_tail = jnp.concatenate(
        [
            jnp.concatenate([c2t, snt], axis=0),  # -> yre tail
            jnp.concatenate([-snt, c2t], axis=0),  # -> yim tail
        ],
        axis=1,
    )
    return mf, mi_tail


def meta_insert(fdl, scales, row, pos):
    """Write one meta-spectrum ``row`` [2, C, K, 2S] f32 into ring slot
    ``pos`` of ``fdl`` [2, P2, C, K, 2S]. Quantized storages (``scales``
    [P2, C, K, G] given) take one dynamic scale per group of 2S/G meta-bins
    (see ``_QUANT_GROUPS``). Returns (fdl, scales)."""
    z = jnp.zeros((), pos.dtype)
    if scales is None:
        row = row.astype(fdl.dtype)[:, None]
        return lax.dynamic_update_slice(fdl, row, (z, pos, z, z, z)), None
    q, scale = fdl_lib.quantize_split(row, fdl.dtype, scales.shape[-1])
    fdl = lax.dynamic_update_slice(fdl, q[:, None], (z, pos, z, z, z))
    scales = lax.dynamic_update_slice(scales, scale[None], (pos, z, z, z))
    return fdl, scales


def meta_mac(fdl, scales, filt_re, filt_im, pos):
    """Partition MAC over the meta-FDL ring, dequantizing on the fly.

    ``fdl`` [2, P2, C, K, 2S] (storage dtype), ``scales`` [P2, C, K, G]
    f32 or None, filter planes as built by ``nested_filter_params``
    (shared: tile-reversed [2*P2, 1, K, 2S]; per-channel: [P2, C, K, 2S]),
    ``pos`` the ring slot of the newest row. Returns (acc_re, acc_im)
    [C, K, 2S] f32: sum over q of row(age q) * filt[q]."""
    p2, c, k, s2 = fdl.shape[1:]
    if filt_re.shape[1] == 1:
        # shared: the rotated filter is one contiguous slice (conv.fdl trick)
        fr = lax.dynamic_slice_in_dim(filt_re, p2 - 1 - pos, p2, axis=0)
        fi = lax.dynamic_slice_in_dim(filt_im, p2 - 1 - pos, p2, axis=0)
        xr, xi, dq = fdl[0], fdl[1], scales
    else:
        ages = jnp.mod(pos - jnp.arange(p2), p2)
        fr, fi = filt_re, filt_im
        xr, xi = fdl[0][ages], fdl[1][ages]
        dq = None if scales is None else scales[ages]
    xr = xr.astype(jnp.float32)
    xi = xi.astype(jnp.float32)
    fr = fr.astype(jnp.float32)
    fi = fi.astype(jnp.float32)
    if dq is not None:
        g = dq.shape[-1]
        dq = (dq * (1.0 / int_max_for(fdl.dtype)))[..., None]  # [P2, C, K, G, 1]
        xr = (xr.reshape(p2, c, k, g, s2 // g) * dq).reshape(p2, c, k, s2)
        xi = (xi.reshape(p2, c, k, g, s2 // g) * dq).reshape(p2, c, k, s2)
    acc_re = jnp.sum(xr * fr - xi * fi, axis=0)
    acc_im = jnp.sum(xr * fi + xi * fr, axis=0)
    return acc_re, acc_im


def _static_dims(params: dict) -> tuple[int, int, bool]:
    """(p2, s, shared) from the filter's static shapes (jit-safe: no int
    leaves in the params pytree — those would trace under jit)."""
    filt = params["filt_re"]
    shared = filt.shape[1] == 1
    p2 = filt.shape[0] // 2 if shared else filt.shape[0]
    s = filt.shape[-1] // 2
    return p2, s, shared


def nested_init_state(config: PartitionedConfig, params: dict) -> dict:
    dtype = _storage_dtype(config)
    c = config.channels
    k = config.num_bins
    p2, s, _ = _static_dims(params)
    prev_dtype = jnp.bfloat16 if config.storage == "bf16" else jnp.float32
    state = {
        "tail": jnp.zeros((c, config.block_size), jnp.float32),
        "prev": jnp.zeros((2, c, k, s), prev_dtype),
        "fdl": jnp.zeros((2, p2, c, k, 2 * s), dtype),
        "pos": jnp.zeros((), jnp.int32),
    }
    if config.storage in ("int8", "int16"):
        # per-(partition, channel, bin, meta-bin-group) dynamic dequant
        # scale (compressed FDL semantics, ``compressed_fdl.hpp:17`` with
        # the dynamic-scale improvement of ``conv.fdl``, group-refined
        # along the meta-bin axis)
        state["scales"] = jnp.ones(
            (p2, c, k, _quant_groups(config, s)), jnp.float32
        )
    return state


def process_nested(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal: jnp.ndarray,
    chunk_blocks: int | None = None,
):
    """Process [C, T] (or [T]) through the nested-FDL path, S blocks/step.

    T is padded up to a multiple of S*B (output trimmed; the returned
    state reflects the padded stream, like ``process_chunked``).
    """
    b = config.block_size
    n = config.transform_size
    p2, s, _ = _static_dims(params)
    if chunk_blocks is not None and chunk_blocks != s:
        raise ValueError(f"chunk_blocks {chunk_blocks} != filter params' {s}")
    quant = config.storage in ("int8", "int16")
    prev_dtype = state["prev"].dtype
    fwd_prec, inv_prec = _fft_precisions(config)
    meta_prec = fwd_prec
    # bf16 rung: big intermediates that ONLY feed DEFAULT-precision
    # matmuls are kept bf16 end-to-end — half the memory traffic, at the
    # rung's own storage precision (accumulation stays f32 via
    # preferred_element_type).
    lane_dt = jnp.bfloat16 if config.storage == "bf16" else jnp.float32

    signal = jnp.asarray(signal, jnp.float32)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape

    num_chunks = -(-t_len // (s * b))
    padded = jnp.pad(signal, ((0, 0), (0, num_chunks * s * b - t_len)))
    blocks = jnp.moveaxis(padded.reshape(c, num_chunks, s, b), (1, 2), (0, 1))

    filt_re = params["filt_re"]
    filt_im = params["filt_im"]
    # Built OUTSIDE the scan: in-trace matrix generation is NOT hoisted
    # out of loop bodies by XLA (see matmul_backend._LITERAL_MAX_BYTES).
    meta_mf, meta_mi_tail = _meta_gemm_mats(s)
    rf_cat = matmul_backend.rfft_cat_matrices(n)
    irf_cat = matmul_backend.irfft_cat_matrices(n)

    def chunk_step(carry, chunk):  # chunk [S, C, B]
        if quant:
            tail, prev, fdl, pos, scales = carry
        else:
            tail, prev, fdl, pos = carry
            scales = None

        if config.scheme == "upols":
            prev_blocks = jnp.concatenate([tail[None], chunk[:-1]], axis=0)
            frames = jnp.concatenate([prev_blocks, chunk], axis=-1)  # [S, C, 2B]
            new_tail = chunk[-1]
        else:  # upola
            frames = jnp.pad(chunk, ((0, 0), (0, 0), (0, n - b)))
            new_tail = None

        sre, sim = matmul_backend.rfft_split_cat(
            frames.astype(lane_dt), n, fwd_prec, mats=rf_cat
        )  # [S, C, K]
        cur = jnp.stack(
            [jnp.moveaxis(sre, 0, -1), jnp.moveaxis(sim, 0, -1)]
        ).astype(prev_dtype)  # [2, C, K, S]

        # meta OLS window (2S frames) + C2C meta-FFT along the frame axis,
        # lane-packed [re | im] through ONE GEMM (see _meta_gemm_mats)
        wdt = lane_dt if config.storage == "bf16" else jnp.float32
        wpk = jnp.concatenate(
            [prev[0], cur[0], prev[1], cur[1]], axis=-1
        ).astype(wdt)  # [C, K, 4S]
        x = matmul_backend._matmul(wpk, meta_mf, meta_prec)
        xre = x[..., : 2 * s]
        xim = x[..., 2 * s :]

        # ring insert + rotated meta-filter, exactly the fdl_index schedule
        fdl, scales = meta_insert(fdl, scales, jnp.stack([xre, xim]), pos)
        acc_re, acc_im = meta_mac(fdl, scales, filt_re, filt_im, pos)

        # inverse meta-FFT: one packed GEMM, tail columns only, 1/2S folded
        accp = jnp.concatenate([acc_re, acc_im], axis=-1).astype(lane_dt)
        yt = matmul_backend._matmul(accp, meta_mi_tail, meta_prec)  # [C,K,2S]
        yre = yt[..., :s].astype(lane_dt)  # last S frames of the re plane
        yim = yt[..., s:].astype(lane_dt)

        y = matmul_backend.irfft_split_cat(
            jnp.moveaxis(yre, -1, 0), jnp.moveaxis(yim, -1, 0), n, inv_prec,
            mats=irf_cat,
        )  # [S, C, 2B]

        if config.scheme == "upols":
            out = y[..., b:]
        else:
            prev_tails = jnp.concatenate([tail[None], y[:-1, :, b:]], axis=0)
            out = y[..., :b] + prev_tails
            new_tail = y[-1, :, b:]

        new_pos = jnp.mod(pos + 1, p2)
        new_carry = (new_tail.astype(jnp.float32), cur, fdl, new_pos)
        if quant:
            new_carry = new_carry + (scales,)
        return new_carry, out.astype(jnp.float32)

    carry0 = (state["tail"], state["prev"], state["fdl"], state["pos"])
    if quant:
        carry0 = carry0 + (state["scales"],)
    final, outs = lax.scan(chunk_step, carry0, blocks)
    new_state = {
        "tail": final[0], "prev": final[1], "fdl": final[2], "pos": final[3],
    }
    if quant:
        new_state["scales"] = final[4]
    out = jnp.moveaxis(outs, 2, 0).reshape(c, num_chunks * s * b)[:, :t_len]
    if squeeze:
        out = out[0]
    return new_state, out
