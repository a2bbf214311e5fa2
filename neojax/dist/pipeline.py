"""Partition-sharded streaming pipeline with ppermute spectrum hand-off.

This is the distributed form of the FDL (SURVEY.md sections 2.7/5): the
partition axis of the delay line and filter shards over the mesh "part"
axis, channels over "ch". Each device owns a contiguous range of
partitions — i.e. a window of the IR's history. Per streamed block:

  1. every device computes the block spectrum (replicated rfft — cheap);
  2. device 0 inserts the fresh spectrum; device d>0 inserts the spectrum
     handed to it by device d-1 on the *previous* step (each hand-off ages
     the spectrum by exactly one block, which is exactly the age at which
     it enters the next device's partition range);
  3. local MAC over the local partitions, then ``psum`` over "part"
     (rides ICI);
  4. the oldest locally-held spectrum is sent to the right neighbour with
     ``jax.lax.ppermute`` — the ring hand-off that plays the role the
     reference's modular ``fdl_index`` schedule plays in one address space
     (``fdl_index.hpp:24-36``);
  5. irfft + overlap bookkeeping (replicated).

The ppermute (one [C_local, K] spectrum) overlaps with the irfft; sizing:
hand-off bytes per block are 1/(P/D) of the local MAC traffic, so scaling
stays near-linear for deep FDLs.

Storage: "dense" (complex64), the split planes
("split" f32 / "bf16"), or quantized planes ("int8"/"int16") where each
spectrum carries a per-channel dynamic scale (``conv.fdl`` semantics): the
scale rides the same ppermute hand-off as its spectrum, and the dequant
multiply fuses into the local MAC.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from neojax.conv.convolver import PartitionedConfig
from neojax.ops.quantize import int_max_for
from neojax.conv.overlap import stream_blocks, unstream_blocks
from neojax.fft import api as fft_api
from neojax.fft import matmul_backend

__all__ = ["PipelineConvolver"]


class PipelineConvolver:
    """Partition+channel sharded streaming convolver (UPOLS schedule)."""

    def __init__(self, config: PartitionedConfig, mesh: Mesh):
        if config.storage not in ("dense", "split", "bf16", "int8", "int16"):
            raise NotImplementedError(f"unknown storage: {config.storage!r}")
        self.config = config
        self.mesh = mesh
        self.d_part = mesh.shape["part"]
        self.d_ch = mesh.shape["ch"]
        if config.num_partitions % self.d_part:
            raise ValueError(
                f"num_partitions {config.num_partitions} not divisible by "
                f"mesh part={self.d_part}"
            )
        if config.channels % self.d_ch:
            raise ValueError(
                f"channels {config.channels} not divisible by mesh ch={self.d_ch}"
            )
        self._split = config.storage != "dense"
        self._quant = config.storage in ("int8", "int16")
        self._process = jax.jit(self._build_process())

    # -- state ------------------------------------------------------------

    def init_state(self) -> dict:
        cfg = self.config
        shape = (cfg.num_partitions, cfg.channels, cfg.num_bins)
        inc_shape = (self.d_part, cfg.channels, cfg.num_bins)
        if self._split:
            from neojax.conv.fdl import STORAGE_DTYPES

            dtype = STORAGE_DTYPES[cfg.storage]
            fdl = jnp.zeros((2,) + shape, dtype)
            incoming = jnp.zeros((2,) + inc_shape, dtype)
        else:
            fdl = jnp.zeros(shape, jnp.complex64)
            incoming = jnp.zeros(inc_shape, jnp.complex64)
        state = {
            "tail": jnp.zeros((cfg.channels, cfg.block_size), jnp.float32),
            "fdl": fdl,
            "incoming": incoming,
        }
        if self._quant:
            state["scales"] = jnp.ones(
                (cfg.num_partitions, cfg.channels, 1), jnp.float32
            )
            state["inc_scale"] = jnp.ones((self.d_part, cfg.channels, 1), jnp.float32)
        return state

    # -- the sharded step -------------------------------------------------

    def _build_process(self):
        cfg = self.config
        mesh = self.mesh
        b = cfg.block_size
        n = cfg.transform_size
        split = self._split
        quant = self._quant
        imax = int_max_for(
            {"int8": jnp.int8, "int16": jnp.int16}.get(cfg.storage, jnp.int8)
        ) if quant else None

        def local_process(filt, tail, fdl, scales, incoming, inc_scale, blocks):
            part_idx = jax.lax.axis_index("part")
            nparts = jax.lax.axis_size("part")
            perm = [(i, (i + 1) % nparts) for i in range(nparts)]

            def step(carry, block):
                tail, fdl, scl, inc, incs = carry
                frame = jnp.concatenate([tail, block], axis=-1)

                if split:
                    sr, si = matmul_backend.rfft_split(frame, n)
                    spec = jnp.stack([sr, si])  # [2, C, K] f32
                    if quant:
                        peak = jnp.max(jnp.abs(spec), axis=(0, 2))  # [C]
                        my_scale = jnp.where(peak > 0, peak, 1.0)[:, None]  # [C,1]
                        q = jnp.clip(
                            jnp.round(spec / my_scale[None] * imax), -imax, imax
                        ).astype(fdl.dtype)
                        mine = jnp.where(part_idx == 0, q, inc[:, 0])
                        mine_scale = jnp.where(part_idx == 0, my_scale, incs[0])
                        scl_new = jnp.concatenate(
                            [mine_scale[None], scl[:-1]], axis=0
                        )
                    else:
                        spec = spec.astype(fdl.dtype)
                        mine = jnp.where(part_idx == 0, spec, inc[:, 0])
                        scl_new = scl
                    fdl_new = jnp.concatenate([mine[:, None], fdl[:, :-1]], axis=1)
                    fr, fi = filt[0], filt[1]  # [P/D, C, K] f32
                    x = fdl_new.astype(jnp.float32)
                    if quant:
                        x = x * (scl_new * (1.0 / imax))[None]
                    acc_re = jnp.sum(x[0] * fr - x[1] * fi, axis=0)
                    acc_im = jnp.sum(x[0] * fi + x[1] * fr, axis=0)
                    acc_re = jax.lax.psum(acc_re, "part")
                    acc_im = jax.lax.psum(acc_im, "part")
                    handoff = jax.lax.ppermute(fdl_new[:, -1], "part", perm)
                    if quant:
                        scale_handoff = jax.lax.ppermute(scl_new[-1], "part", perm)
                        incs_next = scale_handoff[None]
                    else:
                        incs_next = incs
                    y = matmul_backend.irfft_split(acc_re, acc_im, n)
                    inc_next = handoff[:, None]
                else:
                    spec = fft_api.rfft(frame, n=n)
                    mine = jnp.where(part_idx == 0, spec, inc[0])
                    fdl_new = jnp.concatenate([mine[None], fdl[:-1]], axis=0)
                    partial_acc = jnp.sum(fdl_new * filt, axis=0)
                    acc = jax.lax.psum(partial_acc, "part")
                    handoff = jax.lax.ppermute(fdl_new[-1], "part", perm)
                    y = fft_api.irfft(acc, n=n)
                    inc_next = handoff[None]

                    scl_new = scl
                    incs_next = incs

                out = y[..., b:]
                return (block, fdl_new, scl_new, inc_next, incs_next), out

            if split:
                inc0 = incoming[:, 0][:, None]
            else:
                inc0 = incoming[0][None]
            incs0 = inc_scale[0][None]
            (tail, fdl, scales_out, incoming_out, incs_out), outs = jax.lax.scan(
                step, (tail, fdl, scales, inc0, incs0), blocks
            )
            return tail, fdl, scales_out, incoming_out, incs_out, outs

        if split:
            fdl_spec = P(None, "part", "ch", None)
            inc_spec = P(None, "part", "ch", None)
            filt_spec = P(None, "part", "ch", None)
        else:
            fdl_spec = P("part", "ch", None)
            inc_spec = P("part", "ch", None)
            filt_spec = P("part", "ch", None)
        scl_spec = P("part", "ch", None)

        sharded = shard_map(
            local_process,
            mesh=mesh,
            in_specs=(filt_spec, P("ch", None), fdl_spec, scl_spec, inc_spec,
                      scl_spec, P(None, "ch", None)),
            out_specs=(P("ch", None), fdl_spec, scl_spec, inc_spec, scl_spec,
                       P(None, "ch", None)),
            check_vma=False,
        )

        def process(filt, state, signal):
            blocks, length = stream_blocks(signal, b)
            scales = state.get("scales")
            inc_scale = state.get("inc_scale")
            if scales is None:  # placeholders keep one shard_map signature
                scales = jnp.ones((cfg.num_partitions, cfg.channels, 1), jnp.float32)
                inc_scale = jnp.ones((self.d_part, cfg.channels, 1), jnp.float32)
            tail, fdl, scales, incoming, inc_scale, outs = sharded(
                filt, state["tail"], state["fdl"], scales, state["incoming"],
                inc_scale, blocks,
            )
            out = unstream_blocks(outs, length)
            new_state = {"tail": tail, "fdl": fdl, "incoming": incoming}
            if self._quant:
                new_state["scales"] = scales
                new_state["inc_scale"] = inc_scale
            return new_state, out

        return process

    # -- public -----------------------------------------------------------

    def shard_filter(self, filt) -> jnp.ndarray:
        """Filter [P, C|1, K] complex (host array) -> sharded device layout.

        Dense: complex64 [P, C, K]. Split/bf16: f32 planes [2, P, C, K].
        Shared filters broadcast to the channel count first.
        """
        import numpy as np

        cfg = self.config
        filt = np.asarray(filt, np.complex64)
        if filt.shape[1] == 1 and cfg.channels > 1:
            filt = np.broadcast_to(
                filt, (cfg.num_partitions, cfg.channels, cfg.num_bins)
            )
        if self._split:
            planes = np.stack([filt.real, filt.imag]).astype(np.float32)
            return jax.device_put(
                jnp.asarray(planes),
                NamedSharding(self.mesh, P(None, "part", "ch", None)),
            )
        return jax.device_put(
            jnp.asarray(filt), NamedSharding(self.mesh, P("part", "ch", None))
        )

    def process(self, filt, state, signal):
        signal = jax.device_put(
            jnp.asarray(signal, jnp.float32),
            NamedSharding(self.mesh, P("ch", None)),
        )
        return self._process(filt, state, signal)
