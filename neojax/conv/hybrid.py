"""Hybrid (two-stage, non-uniformly scheduled) convolution: the real-time
engine for long IRs.

The per-block convolver (``conv.convolver.step``) re-reads the whole
P-partition delay line every block — for a 10 s IR that is ~940 partitions
of traffic per 512-sample block, two orders of magnitude more than the
head of the filter actually due *this* block. This module splits the
filter the way real-time convolution engines do (Gardner-style two-stage
scheduling, which the reference does not implement — its convolvers are
uniform only, ``uniform_partitioned_convolver.hpp``):

  head  —  partitions j in [0, S): a normal per-block FDL ring over just
           S partitions (``conv.fdl`` machinery), evaluated every block;
  tail  —  partitions j >= S: handled by the nested/two-level engine
           (``conv.nested``), whose meta-partitions q >= 1 depend only on
           *completed* chunks — so the whole tail contribution to chunk
           m+1 is computed once, at the end of chunk m, and handed to the
           head as S precomputed spectrum frames.

Per block the engine does: rfft -> head-ring insert -> S-partition MAC ->
add the precomputed tail frame -> irfft. Latency is the block size B —
identical to the per-block path — while the tail runs at 1/S the rate on
the meta-FFT machinery. Output is mathematically identical to the uniform
UPOLS schedule (head sum + tail sum = full partition sum; linearity).

Storage ladder as elsewhere: "split" (f32, exact), "bf16", "int8"/"int16"
(head FDL quantized per-channel like ``conv.fdl``; tail meta-FDL per-(c,k)
like ``conv.nested``). Shared and per-channel filters both supported.

int8 stores its HEAD ring at int16 (``_head_storage``): the head is 6.8%
of the delay-line rows at the headline depth but carries ~42% of a
decaying IR's signal energy, so head quantization noise would dominate
the rung (int8 row scales cap near 41 dB) while head bytes are
negligible — stage-wise noise shaping. The bulk storage (the meta-FDL) stays int8; the rung meets
its 46 dB reference class (``compressed_fdl_test.cpp:24-29``) this way.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from neojax.conv import fdl as fdl_lib
from neojax.conv import nested as nested_lib
from neojax.conv.convolver import PartitionedConfig, _canon_partitions
from neojax.fft import matmul_backend


__all__ = [
    "hybrid_filter_params",
    "hybrid_init_state",
    "process_hybrid",
    "HybridStream",
]


def hybrid_filter_params(
    config: PartitionedConfig,
    partitions,
    chunk_blocks: int,
    mask=None,
) -> dict:
    """Split the partitioned filter into head (< S) and tail (>= S) params.

    ``partitions``: [P, K], [1, P, K] or [C, P, K] complex spectra.
    ``chunk_blocks`` (S): head depth = tail scheduling period.
    """
    s = chunk_blocks
    filt = _canon_partitions(config, np.asarray(partitions)).astype(np.complex64)
    p = filt.shape[0]
    if mask is not None:
        m = np.asarray(mask, bool)
        if m.ndim == 2:
            m = m[None]
        m = np.moveaxis(m, 0, 1)
        if m.shape[0] < p:
            m = np.concatenate(
                [m, np.zeros((p - m.shape[0],) + m.shape[1:], bool)], axis=0
            )
        filt = np.where(np.broadcast_to(m, filt.shape), filt, 0)

    head = filt[:s] if p >= s else np.concatenate(
        [filt, np.zeros((s - p,) + filt.shape[1:], filt.dtype)], axis=0
    )
    params: dict = {}
    # head: ring layout, tile-reversed filter (conv.fdl trick)
    hr = np.real(head).astype(np.float32)
    hi = np.imag(head).astype(np.float32)
    params["head_re"] = jnp.asarray(np.concatenate([hr[::-1], hr[::-1]], axis=0))
    params["head_im"] = jnp.asarray(np.concatenate([hi[::-1], hi[::-1]], axis=0))
    if p > s:
        tail = np.moveaxis(filt[s:], 0, 1)  # back to [C', P-S, K]
        tail_cfg_parts = tail
        # nested params over the tail partitions (meta-partition q' covers
        # original j in [S(q'+1), S(q'+2)))
        import dataclasses

        tail_config = dataclasses.replace(config, num_partitions=p - s)
        params["tail"] = nested_lib.nested_filter_params(
            tail_config, tail_cfg_parts, s
        )
    return params


def _head_storage(config: PartitionedConfig) -> str:
    """Per-stage storage: the int8 rung keeps its (tiny, signal-dominant)
    head ring at int16 — see the module docstring."""
    if config.storage == "dense":
        return "split"
    if config.storage == "int8":
        return "int16"
    return config.storage


def _head_storage_init(config, s):
    return fdl_lib.fdl_init(_head_storage(config), s, config.channels,
                            config.num_bins)


def hybrid_init_state(config: PartitionedConfig, params: dict) -> dict:
    c = config.channels
    k = config.num_bins
    s = params["head_re"].shape[0] // 2
    state = {
        "btail": jnp.zeros((c, config.block_size), jnp.float32),
        "head_pos": jnp.zeros((), jnp.int32),
    }
    state["head_fdl"] = _head_storage_init(config, s)
    if "tail" in params:
        # only the meta ring (+ pos/scales) of the nested engine is needed:
        # the block-tail / prev-spectra bookkeeping is owned by the head.
        p2t, s_t, _ = nested_lib._static_dims(params["tail"])
        dtype = nested_lib._storage_dtype(config)
        state["meta_fdl"] = jnp.zeros((2, p2t, c, k, 2 * s_t), dtype)
        state["meta_pos"] = jnp.zeros((), jnp.int32)
        if config.storage in ("int8", "int16"):
            state["meta_scales"] = jnp.ones(
                (p2t, c, k, nested_lib._quant_groups(config, s_t)), jnp.float32
            )
        prev_dtype = jnp.bfloat16 if config.storage == "bf16" else jnp.float32
        state["prev_spec"] = jnp.zeros((2, c, k, s), prev_dtype)
        state["tail_frames"] = jnp.zeros((2, c, k, s), jnp.float32)
    return state


# State entries owned by the chunk-rate tail (present only when P > S).
_TAIL_KEYS = ("meta_fdl", "meta_pos", "meta_scales", "prev_spec", "tail_frames")


def _tail_refresh(config, tail_params, meta_mats, mstate, cur):
    """Chunk-boundary tail update: meta-FFT of the [previous | current]
    chunk spectra window, meta-ring insert, meta MAC, inverse meta-FFT ->
    the next chunk's S precomputed tail frames. ``cur`` [2, C, K, S] are
    this chunk's block spectra; returns the new ``_TAIL_KEYS`` entries.

    Tail meta-filter index q' multiplies the window q'+1 chunks old: at
    this chunk's end the newest ring entry (age 0) is the window just
    inserted, and the *next* chunk's tail needs ages 0..P2t-1 against
    F[0..]."""
    s = cur.shape[-1]
    fwd_prec, _ = nested_lib._fft_precisions(config)
    meta_mf, meta_mi_tail = meta_mats
    prev = mstate["prev_spec"]
    # lane-packed [re | im] meta-FFT: one GEMM (nested._meta_gemm_mats)
    wpk = jnp.concatenate(
        [prev[0], cur[0].astype(prev.dtype), prev[1], cur[1].astype(prev.dtype)],
        axis=-1,
    ).astype(jnp.float32)
    x = matmul_backend._matmul(wpk, meta_mf, fwd_prec)
    mpos = mstate["meta_pos"]
    mfdl, mscales = nested_lib.meta_insert(
        mstate["meta_fdl"], mstate.get("meta_scales"),
        jnp.stack([x[..., : 2 * s], x[..., 2 * s :]]), mpos,
    )
    acc_re, acc_im = nested_lib.meta_mac(
        mfdl, mscales, tail_params["filt_re"], tail_params["filt_im"], mpos
    )
    accp = jnp.concatenate([acc_re, acc_im], axis=-1)
    yt = matmul_backend._matmul(accp, meta_mi_tail, fwd_prec)  # 1/2S folded
    new = {
        "meta_fdl": mfdl,
        "meta_pos": jnp.mod(mpos + 1, mfdl.shape[1]),
        "prev_spec": cur.astype(prev.dtype),
        "tail_frames": jnp.stack([yt[..., :s], yt[..., s:]]),  # [2, C, K, S]
    }
    if mscales is not None:
        new["meta_scales"] = mscales
    return new


def process_hybrid(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal: jnp.ndarray,
):
    """Stream [C, T] (or [T]) with per-block (B-sample) latency.

    T is padded to a multiple of S*B (output trimmed; returned state
    reflects the padded stream, like the other multi-block engines).
    """
    b = config.block_size
    n = config.transform_size
    k = config.num_bins
    s = params["head_re"].shape[0] // 2
    has_tail = "tail" in params
    fwd_prec, inv_prec = nested_lib._fft_precisions(config)

    signal = jnp.asarray(signal, jnp.float32)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    c, t_len = signal.shape

    num_chunks = -(-t_len // (s * b))
    padded = jnp.pad(signal, ((0, 0), (0, num_chunks * s * b - t_len)))
    chunks = jnp.moveaxis(padded.reshape(c, num_chunks, s, b), (1, 2), (0, 1))

    head_re = params["head_re"]
    head_im = params["head_im"]
    # hoisted out of the scan (in-trace generation is not loop-hoisted)
    meta_mats = nested_lib._meta_gemm_mats(s) if has_tail else None

    rf_cat = matmul_backend.rfft_cat_matrices(n)
    irf_cat = matmul_backend.irfft_cat_matrices(n)

    def block_step(carry, block):
        btail, hfdl, hpos, tail_frames, r = carry
        frame = jnp.concatenate([btail, block], axis=-1)  # [C, 2B] (upols)
        sre, sim = matmul_backend.rfft_split_cat(frame, n, fwd_prec, mats=rf_cat)

        hfdl = fdl_lib.fdl_ring_push_split(hfdl, sre, sim, hpos)
        fr = fdl_lib.rotated_filter(head_re, hpos, s)
        fi = fdl_lib.rotated_filter(head_im, hpos, s)
        acc_re, acc_im = fdl_lib.fdl_mac_split(hfdl, fr, fi)

        if has_tail:
            acc_re = acc_re + tail_frames[0, :, :, r].reshape(c, k)
            acc_im = acc_im + tail_frames[1, :, :, r].reshape(c, k)

        y = matmul_backend.irfft_split_cat(acc_re, acc_im, n, inv_prec, mats=irf_cat)
        out = y[..., b:]
        # head-only configs never read the spectra; skip the dead stores
        ys = (out, jnp.stack([sre, sim])) if has_tail else out
        return (block, hfdl, (hpos + 1) % s, tail_frames, r + 1), ys

    def chunk_step(carry, chunk):  # chunk [S, C, B]
        btail, hfdl, hpos, mstate = carry
        tail_frames = mstate["tail_frames"] if has_tail else jnp.zeros(
            (2, c, k, 0), jnp.float32
        )
        carry_in = (btail, hfdl, hpos, tail_frames, jnp.zeros((), jnp.int32))
        if not has_tail:
            (btail, hfdl, hpos, _, _), outs = lax.scan(block_step, carry_in, chunk)
            return (btail, hfdl, hpos, mstate), outs
        (btail, hfdl, hpos, _, _), (outs, specs) = lax.scan(
            block_step, carry_in, chunk
        )
        cur = jnp.moveaxis(specs, 0, -1)  # [2, C, K, S]
        mstate = _tail_refresh(config, params["tail"], meta_mats, mstate, cur)
        return (btail, hfdl, hpos, mstate), outs

    mstate0 = {key: state[key] for key in _TAIL_KEYS if key in state}
    (btail, hfdl, hpos, mstate), outs = lax.scan(
        chunk_step,
        (state["btail"], state["head_fdl"], state["head_pos"], mstate0),
        chunks,
    )
    out = (
        jnp.moveaxis(outs, (0, 1), (1, 2))
        .reshape(c, num_chunks * s * b)[:, :t_len]
    )
    new_state = {"btail": btail, "head_fdl": hfdl, "head_pos": hpos, **mstate}
    if squeeze:
        out = out[0]
    return new_state, out


class HybridStream:
    """Per-BLOCK real-time driver of the hybrid engine.

    ``process_hybrid`` runs S blocks per jit call — right for offline
    throughput, wrong for a real-time callback that hands over ONE block
    and must return within the block deadline. This wrapper re-schedules
    the same math the way a real-time engine would (the reference
    plugin's processBlock contract, ``ConstantOverlapAdd.hpp:89-199``):

      - ``__call__(block)``: the head step — rfft, head-ring insert,
        S-partition MAC, add the precomputed tail frame, irfft. One small
        jitted function per callback.
      - every S-th block, the tail chunk step additionally runs (meta-FFT
        of the chunk's spectra, meta-FDL MAC, inverse): the amortized
        Gardner-style tail refresh, scheduled at the chunk boundary.

    Output is block-for-block identical to ``process_hybrid`` (asserted
    by tests/test_hybrid.py); latency is one block.
    """

    def __init__(self, config: PartitionedConfig, params: dict):
        if config.scheme != "upols":
            raise NotImplementedError("HybridStream is UPOLS-only")
        self.config = config
        self.params = params
        self.s = params["head_re"].shape[0] // 2
        self.has_tail = "tail" in params
        # Transform matrices evaluated EAGERLY once: generated inside the
        # jitted per-block fn they would be re-generated every call (XLA
        # does not constant-fold multi-MB trig tensors — measured 10 ms of
        # the per-callback budget on CPU).
        n = config.transform_size
        self._rf_cat = jax.tree.map(
            jnp.asarray, matmul_backend.rfft_cat_matrices(n)
        )
        self._irf_cat = jax.tree.map(
            jnp.asarray, matmul_backend.irfft_cat_matrices(n)
        )
        if self.has_tail:
            self._meta_mats = jax.tree.map(
                jnp.asarray, nested_lib._meta_gemm_mats(self.s)
            )
        self._jit_block = jax.jit(self._block_step, donate_argnums=(0,))
        self._jit_tail = jax.jit(self._tail_step, donate_argnums=(0,))
        self.reset()

    def reset(self) -> None:
        """Return to a fresh-stream state. The ONLY supported way to
        restart: it keeps the host-side chunk-phase counter in sync with
        the device state (assigning ``self.state`` alone would not)."""
        self.state = self.init_state()
        self._r = 0

    def init_state(self) -> dict:
        cfg = self.config
        c = cfg.channels
        k = cfg.num_bins
        s = self.s
        # per-block stepping uses the plain (XLA) head ring — the fused
        # whole-stream kernel is a multi-block construct
        state = {
            "btail": jnp.zeros((c, cfg.block_size), jnp.float32),
            "head_pos": jnp.zeros((), jnp.int32),
            "head_fdl": _head_storage_init(cfg, s),
            "r": jnp.zeros((), jnp.int32),
        }
        if self.has_tail:
            p2t, s_t, _ = nested_lib._static_dims(self.params["tail"])
            dtype = nested_lib._storage_dtype(cfg)
            prev_dtype = jnp.bfloat16 if cfg.storage == "bf16" else jnp.float32
            state["meta_fdl"] = jnp.zeros((2, p2t, c, k, 2 * s_t), dtype)
            state["meta_pos"] = jnp.zeros((), jnp.int32)
            if cfg.storage in ("int8", "int16"):
                state["meta_scales"] = jnp.ones(
                    (p2t, c, k, nested_lib._quant_groups(cfg, s_t)), jnp.float32
                )
            state["prev_spec"] = jnp.zeros((2, c, k, s), prev_dtype)
            state["tail_frames"] = jnp.zeros((2, c, k, s), jnp.float32)
            state["chunk_spec"] = jnp.zeros((2, c, k, s), jnp.float32)
        return state

    # -- jitted pieces ----------------------------------------------------

    def _block_step(self, state, block):
        cfg = self.config
        b = cfg.block_size
        n = cfg.transform_size
        s = self.s
        fwd_prec, inv_prec = nested_lib._fft_precisions(cfg)
        rf_cat = self._rf_cat
        irf_cat = self._irf_cat

        frame = jnp.concatenate([state["btail"], block], axis=-1)
        sre, sim = matmul_backend.rfft_split_cat(frame, n, fwd_prec, mats=rf_cat)
        hpos = state["head_pos"]
        hfdl = fdl_lib.fdl_ring_push_split(state["head_fdl"], sre, sim, hpos)
        fr = fdl_lib.rotated_filter(self.params["head_re"], hpos, s)
        fi = fdl_lib.rotated_filter(self.params["head_im"], hpos, s)
        acc_re, acc_im = fdl_lib.fdl_mac_split(hfdl, fr, fi)
        if self.has_tail:
            r = state["r"]
            acc_re = acc_re + state["tail_frames"][0, :, :, r]
            acc_im = acc_im + state["tail_frames"][1, :, :, r]
        y = matmul_backend.irfft_split_cat(acc_re, acc_im, n, inv_prec, mats=irf_cat)
        out = y[..., b:]

        new_state = dict(state)
        new_state["btail"] = block
        new_state["head_fdl"] = hfdl
        new_state["head_pos"] = (hpos + 1) % s
        new_state["r"] = state["r"] + 1
        if self.has_tail:
            spec = jnp.stack([sre, sim])  # [2, C, K]
            z = jnp.zeros((), state["r"].dtype)
            new_state["chunk_spec"] = jax.lax.dynamic_update_slice(
                state["chunk_spec"],
                spec[..., None].astype(state["chunk_spec"].dtype),
                (z, z, z, state["r"]),
            )
        return new_state, out

    def _tail_step(self, state):
        """Chunk-boundary tail refresh — the same ``_tail_refresh`` as
        ``process_hybrid.chunk_step``."""
        new_state = dict(state)
        new_state.update(
            _tail_refresh(
                self.config, self.params["tail"], self._meta_mats, state,
                state["chunk_spec"],
            )
        )
        new_state["r"] = jnp.zeros((), jnp.int32)
        return new_state

    # -- the real-time callback -------------------------------------------

    def __call__(self, block):
        """One block in, one block out (the processBlock contract).

        The chunk phase is tracked host-side (it is deterministic), so a
        callback is pure async dispatch — no device round-trip to read a
        counter."""
        block = jnp.asarray(block, jnp.float32)
        self.state, out = self._jit_block(self.state, block)
        self._r += 1
        if self._r == self.s:
            self._r = 0
            if self.has_tail:
                self.state = self._jit_tail(self.state)
            else:
                self.state["r"] = jnp.zeros((), jnp.int32)
        return out
