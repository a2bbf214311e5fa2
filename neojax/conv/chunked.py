"""Chunked (multi-block) partitioned convolution: the GEMM throughput path.

The per-block streaming step (``conv.convolver.step``) is bound by memory:
each block re-reads the whole delay line for an elementwise MAC with O(1)
flops/byte. For offline/throughput workloads this module processes ``S``
blocks per step and reformulates the FDL MAC as a *batched Toeplitz matmul*
over frequency bins:

    acc[s, c, k] = sum_j filt[j, k] * spec[t + s - j, c, k]
                 = sum_m T_k[s, m] * hist[m, c, k]

where ``hist`` holds the last spectra (read ONCE per chunk — S-fold less
memory traffic than per-block streaming) and ``T_k`` is the [S, M] Toeplitz
form of filter bin k's partition sequence, built once at filter-setup
time. The complex structure folds into a single real batched matmul per
bin ([K, 2S, 2M] @ [K, 2M, C]) that runs as one batched GEMM.

Sparsity (the reference's CSR sparse filter / perceptual thresholding,
``sparse_filter.hpp``, ``DenseConvolution.cpp:205-267``) maps to *banded
buckets*: each bin k has a band length P_k = (last kept partition + 1);
bins are grouped into buckets by band length, and each bucket carries and
contracts only ``max-band`` history — MAC flops, history reads AND the
carried state all scale with the mask's density. Bins with empty bands
produce exact zeros. The dense case is the single-bucket special case.

Output is mathematically identical to the per-block path (same UPOLS/UPOLA
schedule; summation order differs within f32 tolerance). Latency grows to
S blocks — streaming real-time use keeps the per-block path.

Dtype policy: storage "split" contracts in f32 (Precision.HIGHEST),
"bf16" stores history + Toeplitz in bf16 and accumulates in f32.
Shared (single-channel) filters only BY DESIGN: the per-channel case
would need a [K, C, 2S, 2M] Toeplitz operand (terabytes at production
sizes) — per-channel IRs route to the nested engine, which covers them
at the same throughput class (see ``neojax.cli``).

The complex structure is folded into ONE real batched matmul (the
[K, 2S, 2M] @ [K, 2M, C] dot_general below), which XLA hands to its GEMM
libraries; no hand-written kernel is needed.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from neojax.conv.convolver import PartitionedConfig, _canon_partitions
from neojax.fft import matmul_backend

__all__ = [
    "chunked_filter_params",
    "chunked_init_state",
    "process_chunked",
]


def _toeplitz(filt_plane: np.ndarray, s: int) -> np.ndarray:
    """[P, K] filter plane -> [K, S, P+S-1] Toeplitz bands.

    T[k, s, m] = filt[P-1+s-m, k] for the index in [0, P), else 0.
    """
    p, k = filt_plane.shape
    m_len = p + s - 1
    t = np.zeros((k, s, m_len), filt_plane.dtype)
    fk = filt_plane.T  # [K, P]
    for row in range(s):
        t[:, row, row : row + p] = fk[:, ::-1]
    return t


def _fold_tcat(t_re: np.ndarray, t_im: np.ndarray) -> np.ndarray:
    """Fold complex structure: [[Tr, -Ti], [Ti, Tr]] -> [K, 2S, 2M]."""
    top = np.concatenate([t_re, -t_im], axis=2)
    bot = np.concatenate([t_im, t_re], axis=2)
    return np.concatenate([top, bot], axis=1)


def _bucket_bands(bands: np.ndarray, num_buckets: int) -> list[np.ndarray]:
    """Group bin indices by band length into <= num_buckets groups.

    Returns a list of int32 index arrays (bins with band 0 are excluded —
    their output is exactly zero).
    """
    active = np.nonzero(bands > 0)[0]
    if active.size == 0:
        return []
    vals = bands[active]
    order = np.argsort(vals, kind="stable")
    groups = np.array_split(order, min(num_buckets, active.size))
    return [np.sort(active[g]).astype(np.int32) for g in groups if g.size]


def chunked_filter_params(
    config: PartitionedConfig,
    partitions,
    chunk_blocks: int,
    mask=None,
    num_buckets: int = 4,
) -> dict:
    """Build (optionally banded-sparse) Toeplitz filter params.

    ``mask``: optional boolean [P, K] (or [1, P, K] / [C', P, K] any-OR)
    keep-mask — the sparsity predicate output (``conv.sparse``).
    """
    filt = _canon_partitions(config, np.asarray(partitions)).astype(np.complex64)
    if filt.shape[1] != 1:
        raise ValueError(
            "chunked mode is shared-IR only by design: a per-channel Toeplitz "
            "operand would be [K, C, 2S, 2M] (terabytes at production sizes). "
            "Use the nested engine for per-channel filters — same throughput "
            "class (conv.nested.nested_filter_params)."
        )
    plane = filt[:, 0, :]  # [P, K]
    p, k = plane.shape
    s = chunk_blocks
    dtype = jnp.bfloat16 if config.storage == "bf16" else jnp.float32

    if mask is not None:
        m = np.asarray(mask, bool)
        if m.ndim == 3:
            m = m.any(axis=0) if m.shape[0] != p else m  # [C',P,K] -> [P,K]
        if m.shape != (p, k):
            raise ValueError(f"mask shape {m.shape} != ({p}, {k})")
        plane = np.where(m, plane, 0)
        bands = np.where(m.any(axis=0), 1 + np.argmax(
            np.where(m, np.arange(p)[:, None], -1), axis=0), 0)
        # bands[k] = last kept partition + 1, or 0 if the bin is fully masked
        bucket_bins = _bucket_bands(bands.astype(np.int64), num_buckets)
    else:
        bucket_bins = [np.arange(k, dtype=np.int32)]
        bands = np.full(k, p)

    buckets = []
    for bins in bucket_bins:
        band = int(bands[bins].max())
        sub = plane[:band, :][:, bins]  # [band, Kb]
        tcat = _fold_tcat(
            _toeplitz(np.real(sub).astype(np.float32), s),
            _toeplitz(np.imag(sub).astype(np.float32), s),
        )
        buckets.append(
            {
                "tcat": jnp.asarray(tcat, dtype),
                "bins": jnp.asarray(bins),
                "band": band,
            }
        )
    return {"buckets": tuple(buckets)}


def chunked_init_state(config: PartitionedConfig, params: dict) -> dict:
    """State = overlap tail + per-bucket spectrum windows.

    Each window is the *pre-concatenated* matmul operand ``[Kb, 2M, C]``
    (re frames oldest->newest at [0:M], im at [M:2M], M = band + S - 1,
    the newest S frames being the current chunk). Keeping the carry in
    exactly the dot layout means the per-chunk update is a single
    shift-concat instead of three window-sized copies (concat re/im,
    concat hcat, re-slice tail) — the HBM traffic that dominated this
    path (the window is ~P*K*C entries; the matmul itself is cheap).
    """
    dtype = jnp.bfloat16 if config.storage == "bf16" else jnp.float32
    c = config.channels
    hists = tuple(
        jnp.zeros((b["bins"].shape[0], b["tcat"].shape[2], c), dtype)
        for b in params["buckets"]
    )
    return {
        "tail": jnp.zeros((c, config.block_size), jnp.float32),
        "hists": hists,
    }


def _precision(config: PartitionedConfig):
    return lax.Precision.HIGHEST if config.storage != "bf16" else lax.Precision.DEFAULT


def _fft_precisions(config: PartitionedConfig):
    """(forward, inverse) matmul precision for the block transforms.

    "split" (f32) keeps HIGHEST (true f32; the 1e-5 parity bound). "bf16"
    is the balanced speed mode: the transforms dominate the engine, and
    DEFAULT (TF32 on the GPU for f32 operands; bf16 operands stay bf16)
    stays well inside the rung's 40 dB class.
    """
    if config.storage == "bf16":
        return (lax.Precision.DEFAULT, lax.Precision.DEFAULT)
    return (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


def process_chunked(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal: jnp.ndarray,
    chunk_blocks: int,
):
    """Process [C, T] through the Toeplitz-GEMM path, S blocks per scan step.

    T is padded up to a multiple of S*B (output trimmed; the returned state
    reflects the padded stream — use the per-block path when exact mid-
    stream state semantics matter).
    """
    b = config.block_size
    n = config.transform_size
    k = config.num_bins
    s = chunk_blocks
    buckets = params["buckets"]
    hist_dtype = state["hists"][0].dtype if state["hists"] else jnp.float32

    signal = jnp.asarray(signal, jnp.float32)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape

    num_chunks = -(-t_len // (s * b))
    padded = jnp.pad(signal, ((0, 0), (0, num_chunks * s * b - t_len)))
    blocks = jnp.moveaxis(padded.reshape(c, num_chunks, s, b), (1, 2), (0, 1))

    prec = _precision(config)
    fwd_prec, inv_prec = _fft_precisions(config)
    rf_cat = matmul_backend.rfft_cat_matrices(n)
    irf_cat = matmul_backend.irfft_cat_matrices(n)

    def chunk_step(carry, chunk):  # chunk [S, C, B]
        tail, hists = carry

        if config.scheme == "upols":
            prev = jnp.concatenate([tail[None], chunk[:-1]], axis=0)
            frames = jnp.concatenate([prev, chunk], axis=-1)  # [S, C, 2B]
            new_tail = chunk[-1]
        else:  # upola
            frames = jnp.pad(chunk, ((0, 0), (0, 0), (0, n - b)))
            new_tail = None

        spec_re, spec_im = matmul_backend.rfft_split_cat(
            frames, n, fwd_prec, mats=rf_cat
        )  # [S, C, K]
        # K-major: [K, S, C]
        kre = jnp.transpose(spec_re, (2, 0, 1)).astype(hist_dtype)
        kim = jnp.transpose(spec_im, (2, 0, 1)).astype(hist_dtype)

        acc_re = jnp.zeros((k, s, c), jnp.float32)
        acc_im = jnp.zeros((k, s, c), jnp.float32)
        new_hists = []
        for bucket, hwin in zip(buckets, hists):
            bins = bucket["bins"]
            # A bucket whose bin count equals K covers every bin in order
            # (buckets hold sorted disjoint indices), so the gather/scatter
            # can be skipped (a gather + scatter over the whole window).
            # Static shape check: jit-safe.
            full = bins.shape[0] == k
            new_re = kre if full else kre[bins]  # [Kb, S, C]
            new_im = kim if full else kim[bins]
            # hwin is the dot operand [Kb, 2M, C] (re | im frame windows);
            # advance it by S frames in ONE shift-concat.
            m = hwin.shape[1] // 2
            hwin = jnp.concatenate(
                [hwin[:, s:m], new_re, hwin[:, m + s :], new_im], axis=1
            )
            out_cat = lax.dot_general(
                bucket["tcat"],
                hwin,
                dimension_numbers=(((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.float32,
                precision=prec,
            )  # [Kb, 2S, C]
            if full:
                acc_re = out_cat[:, :s]
                acc_im = out_cat[:, s:]
            else:
                acc_re = acc_re.at[bins].set(out_cat[:, :s])
                acc_im = acc_im.at[bins].set(out_cat[:, s:])
            new_hists.append(hwin)

        # back to [S, C, K] for the inverse transform
        y = matmul_backend.irfft_split_cat(
            jnp.transpose(acc_re, (1, 2, 0)), jnp.transpose(acc_im, (1, 2, 0)), n,
            inv_prec, mats=irf_cat,
        )  # [S, C, 2B]

        if config.scheme == "upols":
            out = y[..., b:]
        else:
            prev_tails = jnp.concatenate([tail[None], y[:-1, :, b:]], axis=0)
            out = y[..., :b] + prev_tails
            new_tail = y[-1, :, b:]

        return (new_tail.astype(jnp.float32), tuple(new_hists)), out.astype(
            jnp.float32
        )

    (tail, hists), outs = lax.scan(
        chunk_step, (state["tail"], state["hists"]), blocks
    )
    out = jnp.moveaxis(outs, 2, 0).reshape(c, num_chunks * s * b)[:, :t_len]
    if squeeze:
        out = out[0]
    return {"tail": tail, "hists": hists}, out
