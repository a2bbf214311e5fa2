"""Time-sharded (sequence-parallel) streaming convolution.

The north-star axis BASELINE.json names: the *block stream itself* is
sharded over a mesh "time" axis — device d processes m consecutive blocks
[d*m, (d+1)*m) — and each device receives its predecessor's boundary state
via ``jax.lax.ppermute``: the overlap-save window tail plus the input
blocks needed to prefill its frequency-delay line. This is the halo
pattern of ring attention applied to OLS streaming: the reference's
carried tail state (``src/neo/convolution/overlap_save.hpp:37-55``,
``overlap_add.hpp:216-220``) becomes a one-hop ring exchange.

Why a halo suffices: the convolver state entering block k is a pure
function of the previous P blocks of *input* (the FDL holds the last P
frame spectra; the OLS window tail is the last B samples). So device d
needs only the trailing P*B samples of its predecessor's shard — one
``ppermute`` message — and reconstructs the state with P-1 *insert-only*
warmup steps (rfft + FDL insert, no partition MAC): the cheap part of the
step. For UPOLA the overlap tail additionally requires one full step on
the last halo block (its output is discarded). Warmup cost per device is
O(P) rffts against O(m*P) MAC work for the stream, and the exchange
itself is a single message that XLA schedules ahead of the warmup's
data dependency. Per-device scaling efficiency is about
m*t_step / (m*t_step + t_warmup) for m blocks per device;
``tools/bench_timesharded.py`` measures both times on the GPU.

Exactness: warmup replays the SAME ``_spectrum_and_push`` code path as the
sequential stream (including dynamic quantization for int8/int16 storage),
so the reconstructed FDL is bit-identical and the sharded output matches
single-device ``process`` to float-associativity (the per-block math is
identical; only launch grouping differs).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from neojax.conv import convolver as cv
from neojax.conv import fdl as fdl_lib

__all__ = ["timesharded_process"]


def _batch_spectra(config: cv.PartitionedConfig, frames: jnp.ndarray, mats):
    """Forward transforms of [m, C, N] warmup frames in ONE batched matmul
    (same matrices as the per-block path — bit-identical spectra)."""
    n = config.transform_size
    k = config.num_bins
    fwd = None if mats is None else mats[0]
    if config.storage == "dense":
        from neojax.fft import api as fft_api

        spec = fft_api.rfft(frames, n=n, backend=config.fft_backend)[..., :k]
        return spec
    from neojax.fft import matmul_backend

    if config.use_packed:
        return matmul_backend.rfft_packed_split(frames, n, mats=fwd)
    if cv._use_split_fft(config):
        return matmul_backend.rfft_split(frames, n, mats=fwd)
    from neojax.fft import api as fft_api

    spec = fft_api.rfft(frames, n=n, backend=config.fft_backend)[..., :k]
    return jnp.real(spec), jnp.imag(spec)


def _assemble_ring(config: cv.PartitionedConfig, state: dict, spectra) -> dict:
    """Place m batch-transformed spectra into ring slots 0..m-1 (ring
    layout) or reversed shift slots (shift layout) — the exact state m
    sequential ``insert_only_step`` pushes would produce."""
    state = dict(state)
    ring = config.layout == "ring"
    if config.storage == "dense":
        spec = spectra  # [m, C, K] complex
        m = spec.shape[0]
        src = spec if ring else spec[::-1]
        state["fdl"] = state["fdl"].at[:m].set(src.astype(state["fdl"].dtype))
    else:
        spec_re, spec_im = spectra  # [m, C, lanes] each
        m = spec_re.shape[0]
        planes_new = jnp.stack([spec_re, spec_im])  # [2, m, C, L]
        if not ring:
            planes_new = planes_new[:, ::-1]
        fdl = state["fdl"]
        if isinstance(fdl, tuple):
            planes, scales = fdl
            q, scale = fdl_lib.quantize_split(
                planes_new, planes.dtype, scales.shape[-1]
            )
            state["fdl"] = (
                planes.at[:, :m].set(q),
                scales.at[:m].set(scale),
            )
        else:
            state["fdl"] = fdl.at[:, :m].set(planes_new.astype(fdl.dtype))
        if config.use_packed:
            pair = jnp.stack(
                [spec_re[:, :, 0], spec_im[:, :, 0]], axis=-1
            )  # [m, C, 2]
            if not ring:
                pair = pair[::-1]
            state["dcny"] = state["dcny"].at[:m].set(pair)
    if ring:
        state["pos"] = jnp.asarray(m % config.num_partitions, jnp.int32)
    return state


def _warmup(config: cv.PartitionedConfig, params: dict, halo: jnp.ndarray) -> dict:
    """Reconstruct the convolver state from the predecessor's halo.

    halo: [C, P*B] — the P input blocks preceding this device's shard
    (zeros on device 0, which matches a fresh stream start).

    The FDL entering block k is a pure function of the previous P input
    blocks, and ring insertion order is data-independent — so the whole
    prefill collapses to ONE batched forward transform of the P-1 warmup
    frames plus a single ring assembly (quantization vectorized over
    frames, same per-frame math) instead of a scan of P-1 sequential
    insert steps; the batched warmup costs about one chunk's worth of
    transforms. Four-step
    transform configs (N >= 4096) keep the scan (their streaming
    transforms are not batch-shaped).
    """
    p = config.num_partitions
    b = config.block_size
    c = halo.shape[0]
    blocks = jnp.moveaxis(halo.reshape(c, p, b), 1, 0)  # [P, C, B]

    state = cv.init_state(config)

    if config.scheme == "upols":
        # Tail seeds the sliding window; insert frames for blocks 1..P-1
        # (the final tail is the last halo block).
        state = dict(state)
        state["tail"] = blocks[-1].astype(jnp.float32)
        frames = jnp.concatenate([blocks[:-1], blocks[1:]], axis=-1)  # [P-1, C, 2B]
        warm = blocks[1:]
    else:
        # UPOLA frames are zero-padded single blocks: insert 0..P-2, then
        # one full step on block P-1 to materialize the overlap tail.
        n = config.transform_size
        frames = jnp.pad(blocks[:-1], ((0, 0), (0, 0), (0, n - b)))
        warm = blocks[:-1]

    mats = cv._transform_mats(config)

    if cv._use_fourstep_stream(config):
        if config.scheme == "upols":
            state["tail"] = blocks[0].astype(jnp.float32)

        def body(carry, blk):
            return cv.insert_only_step(config, carry, blk, mats), None

        state, _ = jax.lax.scan(body, state, warm)
    else:
        state = _assemble_ring(config, state, _batch_spectra(config, frames, mats))

    if config.scheme == "upola":
        state, _ = cv.step(config, params, state, blocks[-1])
    return state


def timesharded_process(
    config: cv.PartitionedConfig,
    params: dict,
    signal: jnp.ndarray,
    mesh: Mesh,
    axis_name: str = "time",
):
    """Stream ``signal`` [C, T] with the block axis sharded over ``axis_name``.

    Requires T = nb*B with nb divisible by the axis size, and at least
    P blocks per device (so the halo comes from the immediate predecessor).
    Returns the [C, T] output, sharded along time like the input.
    """
    signal = jnp.asarray(signal)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]

    d = mesh.shape[axis_name]
    b = config.block_size
    p = config.num_partitions
    c, t = signal.shape
    if t % (b * d):
        raise ValueError(f"signal length {t} not divisible into {d} x block {b}")
    m = t // (b * d)
    if m < p:
        raise ValueError(
            f"{m} blocks/device < {p} partitions: halo would span multiple "
            "predecessors; use fewer devices or a longer signal"
        )

    def local(params, sig):  # sig: [C, m*B] local shard
        halo_src = sig[:, -p * b :]
        perm = [(i, i + 1) for i in range(d - 1)]
        halo = jax.lax.ppermute(halo_src, axis_name, perm)  # device 0: zeros
        state = _warmup(config, params, halo)
        _, out = cv.process(config, params, state, sig)
        return out

    fn = jax.shard_map(
        partial(local),
        mesh=mesh,
        in_specs=(P(), P(None, axis_name)),
        out_specs=P(None, axis_name),
        check_vma=False,
    )
    out = jax.jit(fn)(params, signal)
    return out[0] if squeeze else out
