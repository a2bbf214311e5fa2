"""Bin-sharded streaming convolution (model-parallel over spectrum width).

The third parallel axis of SURVEY.md section 2.7: frequency bins are
independent in the FDL MAC (``multiply_add.hpp:280-301``), so for very
large transforms the delay line, filter and MAC shard over the mesh axis
"bin". The split-plane formulation makes everything *except one psum*
local, because the DFT-as-matmul backend distributes over its contraction:

  - forward: each device computes only its bin columns of the rfft
    matmul — ``frame @ C[:, k_shard]`` — no spectrum ever materializes
    whole;
  - the FDL ring push and partition MAC are elementwise in k: local;
  - inverse: the irfft is a contraction over k, so each device computes a
    *partial* time-domain block from its bins and ``psum`` over "bin"
    reassembles it — the only collective, one [C_local, 2B] f32 block per
    step, independent of P and K.

Composes with channel sharding ("ch" axis). The odd reference bin count
(K = B + 1) is zero-padded to a multiple of the bin-axis size: padded
bins carry zero filter weight and zero irfft rows, so results are exact.

Quantized storages (int8/int16) keep *per-shard* dynamic scales: each
device quantizes its local bin slice against its own per-channel peak and
dequantizes locally inside the MAC — no extra collective rides the step
(unlike a global scale, which would need a pmax over "bin"), and the
per-shard granularity strictly improves SNR versus one whole-spectrum
scale (the reference's ``compressed_fdl`` uses a single fixed full-scale,
``src/neo/convolution/compressed_fdl.hpp:26-48``).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from neojax.conv.convolver import PartitionedConfig, _np_tile_reverse
from neojax.conv.overlap import stream_blocks, unstream_blocks
from neojax.fft import matmul_backend

__all__ = ["BinShardedConvolver"]


class BinShardedConvolver:
    """UPOLS streaming convolver sharded over ("bin", "ch") mesh axes."""

    def __init__(self, config: PartitionedConfig, mesh: Mesh):
        if config.storage == "dense":
            raise NotImplementedError(
                "bin sharding is split-plane only (complex64 never touches "
                "a device); use split/bf16/int16/int8"
            )
        if "bin" not in mesh.shape:
            raise ValueError('mesh must have a "bin" axis')
        self.config = config
        self.mesh = mesh
        self.d_bin = mesh.shape["bin"]
        self.d_ch = mesh.shape.get("ch", 1)
        if config.channels % self.d_ch:
            raise ValueError(
                f"channels {config.channels} not divisible by mesh ch={self.d_ch}"
            )
        k = config.num_bins
        self.k_pad = -(-k // self.d_bin) * self.d_bin
        self._quant = config.storage in ("int8", "int16")
        self._process = jax.jit(self._build())

    # -- padded transform matrices (host) ----------------------------------

    def _mats(self):
        n = self.config.transform_size
        k = self.config.num_bins
        kp = self.k_pad
        c, s = (np.asarray(m) for m in matmul_backend.rfft_matrices(n))
        a, b = (np.asarray(m) for m in matmul_backend.irfft_matrices(n))
        cz = np.zeros((n, kp), np.float32)
        sz = np.zeros((n, kp), np.float32)
        az = np.zeros((kp, n), np.float32)
        bz = np.zeros((kp, n), np.float32)
        cz[:, :k], sz[:, :k], az[:k], bz[:k] = c, s, a, b
        return cz, sz, az, bz

    def init_state(self) -> dict:
        from neojax.conv.fdl import STORAGE_DTYPES

        cfg = self.config
        dtype = STORAGE_DTYPES[cfg.storage]
        fdl = jnp.zeros((2, cfg.num_partitions, cfg.channels, self.k_pad), dtype)
        fdl = jax.device_put(
            fdl, NamedSharding(self.mesh, P(None, None, "ch", "bin"))
        )
        state = {
            "tail": jax.device_put(
                jnp.zeros((cfg.channels, cfg.block_size), jnp.float32),
                NamedSharding(self.mesh, P("ch", None)),
            ),
            "fdl": fdl,
            "pos": jnp.zeros((), jnp.int32),
        }
        if self._quant:
            # per-(partition, channel, bin-shard) dynamic scales
            state["scl"] = jax.device_put(
                jnp.ones((cfg.num_partitions, cfg.channels, self.d_bin), jnp.float32),
                NamedSharding(self.mesh, P(None, "ch", "bin")),
            )
        return state

    def shard_filter(self, filt) -> tuple:
        """[P, C|1, K] complex (host; same layout as PipelineConvolver's
        shard_filter) -> tile-reversed split planes sharded over "bin"
        (padded to k_pad)."""
        cfg = self.config
        filt = np.asarray(filt, np.complex64)
        p, cf, k = filt.shape
        if k != cfg.num_bins or p != cfg.num_partitions:
            raise ValueError(f"filter shape {filt.shape} mismatch")
        if cf == 1 and cfg.channels > 1:
            filt = np.broadcast_to(filt, (p, cfg.channels, k))
        pad = np.zeros((p, filt.shape[1], self.k_pad - k), np.complex64)
        tiled = _np_tile_reverse(np.concatenate([filt, pad], axis=2))  # [2P, C, Kp]
        planes = np.stack([tiled.real, tiled.imag]).astype(np.float32)
        ch = "ch" if self.d_ch > 1 else None
        return jax.device_put(
            jnp.asarray(planes), NamedSharding(self.mesh, P(None, None, ch, "bin"))
        )

    def _build(self):
        from neojax.ops.quantize import int_max_for

        cfg = self.config
        b = cfg.block_size
        p = cfg.num_partitions
        quant = self._quant
        cz, sz, az, bz = self._mats()
        mats = (jnp.asarray(cz), jnp.asarray(sz), jnp.asarray(az), jnp.asarray(bz))

        def local_process(filt, cmat, smat, amat, bmat, tail, fdl, scl, pos, blocks):
            m = int_max_for(fdl.dtype) if quant else None

            def step(carry, block):
                tail, fdl, scl, pos = carry
                frame = jnp.concatenate([tail, block], axis=-1)  # [C_l, 2B]
                # local rfft columns only
                sre = frame @ cmat  # [C_l, K_l]
                sim = frame @ smat
                spec = jnp.stack([sre, sim])
                z = jnp.zeros((), pos.dtype)
                if quant:
                    # per-shard dynamic scale: local peak, local dequant —
                    # exact, and no collective rides the quantization
                    peak = jnp.max(jnp.abs(spec), axis=(0, 2))  # [C_l]
                    scale = jnp.where(peak > 0, peak, 1.0)[:, None]  # [C_l, 1]
                    q = jnp.clip(jnp.round(spec / scale[None] * m), -m, m)
                    spec = q.astype(fdl.dtype)
                    scl = jax.lax.dynamic_update_slice(scl, scale[None], (pos, z, z))
                else:
                    spec = spec.astype(fdl.dtype)
                fdl_new = jax.lax.dynamic_update_slice(
                    fdl, spec[:, None], (z, pos, z, z)
                )
                start = p - 1 - pos
                fwin = jax.lax.dynamic_slice_in_dim(filt, start, p, axis=1)
                x = fdl_new.astype(jnp.float32)
                if quant:
                    x = x * (scl * (1.0 / m))[None]
                fr, fi = fwin[0], fwin[1]
                acc_re = jnp.sum(x[0] * fr - x[1] * fi, axis=0)  # [C_l, K_l]
                acc_im = jnp.sum(x[0] * fi + x[1] * fr, axis=0)
                # partial irfft from the local bins, then the one collective
                y = acc_re @ amat + acc_im @ bmat  # [C_l, 2B]
                y = jax.lax.psum(y, "bin")
                return (block, fdl_new, scl, (pos + 1) % p), y[..., b:]

            (tail, fdl, scl, pos), outs = jax.lax.scan(
                step, (tail, fdl, scl, pos), blocks
            )
            return tail, fdl, scl, pos, outs

        ch = "ch" if self.d_ch > 1 else None
        sharded = shard_map(
            local_process,
            mesh=self.mesh,
            in_specs=(
                P(None, None, ch, "bin"),
                P(None, "bin"),
                P(None, "bin"),
                P("bin", None),
                P("bin", None),
                P(ch, None),
                P(None, None, ch, "bin"),
                P(None, ch, "bin"),
                P(),
                P(None, ch, None),
            ),
            out_specs=(
                P(ch, None),
                P(None, None, ch, "bin"),
                P(None, ch, "bin"),
                P(),
                P(None, ch, None),
            ),
            check_vma=False,
        )

        def process(filt, state, signal):
            blocks, length = stream_blocks(signal, b)
            scl = state.get(
                "scl",
                jnp.ones((cfg.num_partitions, cfg.channels, self.d_bin), jnp.float32),
            )
            tail, fdl, scl, pos, outs = sharded(
                filt, *mats, state["tail"], state["fdl"], scl, state["pos"], blocks
            )
            out = unstream_blocks(outs, length)
            new_state = {"tail": tail, "fdl": fdl, "pos": pos}
            if quant:
                new_state["scl"] = scl
            return new_state, out

        return process

    def process(self, filt, state, signal):
        signal = jax.device_put(
            jnp.asarray(signal, jnp.float32),
            NamedSharding(self.mesh, P("ch" if self.d_ch > 1 else None, None)),
        )
        return self._process(filt, state, signal)
