"""Uniformly-partitioned FDL convolvers (UPOLS / UPOLA) — the product.

Counterpart of
``src/neo/convolution/uniform_partitioned_convolver.hpp:14-66`` and its
aliases (``dense_convolver.hpp:20-39``, ``sparse_convolver.hpp:16-21``).
The reference composes policy templates {overlap_save, overlap_add} x
{dense, split, compressed FDL} x {dense, split, sparse filter}; here the
same cross-product is a config dataclass over a single functional core:

  config  (static)  : block size, partitions, channels, scheme, storage
  params  (pytree)  : partitioned filter spectra (+ sparsity mask)
  state   (pytree)  : {frame tail / overlap tail, FDL, }  — the scan carry

Per block (UPOLS): frame = [previous block | new block] (2B samples) ->
rfft -> push spectrum into the FDL -> MAC-reduce over partitions against
the filter -> irfft -> last B samples. UPOLA: frame = zero-padded block,
output = first B samples + carried overlap. Filter partition j always
multiplies the spectrum j blocks old — the schedule the reference encodes
with ``fdl_index``'s modular arithmetic (``fdl_index.hpp:24-36``).

The state is an explicit pytree, so streaming jobs checkpoint/resume by
serializing {tail, FDL} — a first-class feature (SURVEY.md section 5).

Everything is batched-native over channels and shards over a device mesh:
the channel axis is embarrassingly parallel (data parallel), the partition
axis reduces (see ``neojax.dist``).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import numpy as np
import jax
import jax.numpy as jnp

from neojax.conv import fdl as fdl_lib
from neojax.conv.overlap import stream_blocks, unstream_blocks
from neojax.conv.partition import uniform_partition
from neojax.conv.sparse import sparsity_mask
from neojax.fft import api as fft_api
from neojax.fft import matmul_backend

__all__ = [
    "PartitionedConfig",
    "filter_params",
    "init_state",
    "step",
    "process",
    "Convolver",
    "make_convolver",
    "upols_convolver",
    "upola_convolver",
    "upola_convolver_v2",
    "split_upols_convolver",
    "split_upola_convolver",
    "sparse_upols_convolver",
    "sparse_upola_convolver",
]


@dataclasses.dataclass(frozen=True)
class PartitionedConfig:
    block_size: int
    num_partitions: int
    channels: int
    scheme: str = "upols"  # "upols" | "upola"
    storage: str = "dense"  # "dense" | "split" | "bf16" | "int16" | "int8"
    fft_backend: str | None = None
    # "ring": fdl_index-style ring buffer + write position (one-row insert,
    # contiguous rotated-filter slice — the fast path). "shift": newest-first
    # shift layout (simplest dataflow; used by the distributed pipeline).
    layout: str = "ring"
    # Packed-512 spectrum layout (Nyquist.re stored in the im-plane DC lane,
    # DC/Ny history in an exact f32 side-carry): the FDL's lane count is the
    # power-of-two B instead of B+1, so the planes' minor axis is a power
    # of two.
    # None = auto (on for ring-layout split storages with even block size).
    packed: bool | None = None

    @property
    def transform_size(self) -> int:
        return 2 * self.block_size

    @property
    def num_bins(self) -> int:
        return self.block_size + 1

    @property
    def use_packed(self) -> bool:
        if self.packed is not None:
            return self.packed
        return (
            self.storage != "dense"
            and self.layout == "ring"
            and self.block_size % 2 == 0
        )

    def __post_init__(self):
        if self.scheme not in ("upols", "upola"):
            raise ValueError(f"unknown scheme: {self.scheme!r}")
        if self.storage not in fdl_lib.STORAGE_DTYPES:
            raise ValueError(f"unknown storage: {self.storage!r}")
        if self.layout not in ("ring", "shift"):
            raise ValueError(f"unknown layout: {self.layout!r}")
        if self.packed and (
            self.storage == "dense"
            or self.layout != "ring"
            or self.block_size % 2
        ):
            raise ValueError(
                "packed layout requires a split-plane storage, ring layout "
                "and an even block size"
            )


def _canon_partitions(config: PartitionedConfig, partitions: "np.ndarray") -> "np.ndarray":
    """[P,K] / [C,P,K] / [1,P,K] -> [P, C', K] with C' in {1, channels}."""
    if partitions.ndim == 2:
        partitions = partitions[None]
    if partitions.ndim != 3:
        raise ValueError(f"filter partitions must be rank 2 or 3, got {partitions.ndim}")
    c = partitions.shape[0]
    if c not in (1, config.channels):
        raise ValueError(
            f"filter has {c} channels, config expects 1 (shared) or {config.channels}"
        )
    if partitions.shape[1] != config.num_partitions or partitions.shape[2] != config.num_bins:
        raise ValueError(
            f"filter shape {partitions.shape[1:]} != "
            f"({config.num_partitions}, {config.num_bins})"
        )
    return np.moveaxis(partitions, 0, 1)  # [P, C', K]


def _np_tile_reverse(filt: "np.ndarray") -> "np.ndarray":
    rev = filt[::-1]
    return np.concatenate([rev, rev], axis=0)


def filter_params(
    config: PartitionedConfig, partitions, sparsity: Any = None
) -> dict:
    """Build filter params from partitioned spectra ([C|1, P, K] complex).

    Filter preparation is *host-side* (numpy): only the final float32 re/im
    planes (or, for the "dense" storage, the complex array) reach a device.

    ``sparsity``: optional predicate ``(row, col, value) -> bool`` or a
    boolean mask broadcastable to the filter; kept bins stay, others zero
    (the reference's sparse_filter/CSR semantics, in mask form).
    """
    filt = _canon_partitions(config, np.asarray(partitions)).astype(np.complex64)

    mask = None
    if sparsity is not None:
        if callable(sparsity):
            per_channel = np.moveaxis(filt, 1, 0)  # [C', P, K]
            mask = np.moveaxis(np.asarray(sparsity_mask(per_channel, sparsity)), 0, 1)
        else:
            # Mask arrays use the same channel-first layout as the filter
            # input ([P,K] or [C|1,P,K]); canonicalize to [P, C', K] and pad
            # any missing (zero-padded) partitions with False.
            mask = np.asarray(sparsity, bool)
            if mask.ndim == 2:
                mask = mask[None]
            mask = np.moveaxis(mask, 0, 1)
            if mask.shape[0] < filt.shape[0]:
                pad = np.zeros((filt.shape[0] - mask.shape[0],) + mask.shape[1:], bool)
                mask = np.concatenate([mask, pad], axis=0)
            mask = np.broadcast_to(mask, filt.shape)
        filt = np.where(mask, filt, 0)

    params = {}
    ring = config.layout == "ring"
    if config.storage == "dense":
        params["filt"] = jnp.asarray(_np_tile_reverse(filt) if ring else filt)
    elif config.use_packed:
        # Packed-512 layout: lanes 0..B-1 = bins 0..B-1 with the im-plane's
        # lane 0 repurposed for Nyquist.re; the DC/Nyquist reals also ride a
        # dedicated [2P, C', 2] side filter for the exact lane-0 fixup.
        b = config.block_size
        fr = np.real(filt[:, :, :b]).astype(np.float32)
        fi = np.imag(filt[:, :, :b]).astype(np.float32)
        fi[:, :, 0] = np.real(filt[:, :, b])
        fdcny = np.stack(
            [np.real(filt[:, :, 0]), np.real(filt[:, :, b])], axis=-1
        ).astype(np.float32)
        params["filt_re"] = jnp.asarray(_np_tile_reverse(fr))
        params["filt_im"] = jnp.asarray(_np_tile_reverse(fi))
        params["filt_dcny"] = jnp.asarray(_np_tile_reverse(fdcny))
    else:
        fr = np.real(filt).astype(np.float32)
        fi = np.imag(filt).astype(np.float32)
        if ring:
            fr = _np_tile_reverse(fr)
            fi = _np_tile_reverse(fi)
        params["filt_re"] = jnp.asarray(fr)
        params["filt_im"] = jnp.asarray(fi)
    if mask is not None:
        params["mask"] = jnp.asarray(mask)
    return params


def init_state(config: PartitionedConfig) -> dict:
    state = {
        "tail": jnp.zeros((config.channels, config.block_size), jnp.float32),
    }
    if config.use_packed:
        state["fdl"], state["dcny"] = fdl_lib.fdl_packed_init(
            config.storage, config.num_partitions, config.channels, config.block_size
        )
    else:
        state["fdl"] = fdl_lib.fdl_init(
            config.storage, config.num_partitions, config.channels, config.num_bins
        )
    if config.layout == "ring":
        state["pos"] = jnp.zeros((), jnp.int32)
    return state


def _use_split_fft(config: PartitionedConfig) -> bool:
    backend = fft_api._resolve_backend(config.fft_backend, config.transform_size)
    return backend == "matmul" and config.storage != "dense"


# Transform sizes at or above this stream through the four-step (Bailey)
# recursion instead of the dense DFT matmul. The dense [N, N/2] matrices at
# N = 4096 are 2 x 33 MB (forward) + 2 x 33 MB (inverse) of device memory
# re-read per streamed block; the four-step path touches O(channels * N) per
# pass with KB-sized leaf matrices. Below this keep the single-matmul path.
_FOURSTEP_MIN_N = 4096


def _use_fourstep_stream(config: PartitionedConfig) -> bool:
    n = config.transform_size
    return (
        config.storage != "dense"
        and config.fft_backend in (None, "auto", "matmul")
        and n >= _FOURSTEP_MIN_N
        and n & (n - 1) == 0  # four-step recursion is pow-2 only
    )


def _frame(config: PartitionedConfig, state: dict, block: jnp.ndarray) -> jnp.ndarray:
    """Build the transform-size frame for one block (UPOLS sliding window /
    UPOLA zero-padding, ``overlap_save.hpp:90-95`` / ``overlap_add.hpp:214``)."""
    b = config.block_size
    n = config.transform_size
    if block.shape[-1] != b:
        raise ValueError(f"block size {block.shape[-1]} != configured {b}")
    if config.scheme == "upols":
        return jnp.concatenate([state["tail"], block], axis=-1)  # [C, 2B]
    return jnp.pad(block, [(0, 0)] * (block.ndim - 1) + [(0, n - b)])


def _transform_mats(config: PartitionedConfig):
    """Precompute the DFT matmul matrices used by the per-block step — built
    ONCE outside lax.scan and closed over as loop constants. For in-trace
    sizes (block >= ~1024) leaving them to the transform calls would rerun
    the trig generation EVERY scan iteration (~4.5 ms/block at N=8192)."""
    n = config.transform_size
    if config.storage == "dense" or _use_fourstep_stream(config):
        return None  # four-step closes over KB-sized leaf matrices itself
    if config.use_packed:
        return (
            matmul_backend.rfft_packed_matrices(n),
            matmul_backend.irfft_packed_matrices(n),
        )
    if _use_split_fft(config):
        return (
            matmul_backend.rfft_matrices(n),
            matmul_backend.irfft_matrices(n),
        )
    return None


def _spectrum_and_push(config: PartitionedConfig, state: dict, frame: jnp.ndarray,
                       mats=None):
    """rfft the frame and insert the spectrum into the FDL.

    Returns (state_update, spectrum): state_update is a dict of changed
    state entries; spectrum is a complex array (dense storage) or an
    (re, im) tuple (split storages). Shared by the full ``step`` and the
    insert-only warmup of the time-sharded pipeline — both must produce
    bit-identical FDL contents (incl. quantization).
    """
    n = config.transform_size
    k = config.num_bins
    ring = config.layout == "ring"
    pos = state.get("pos")

    if config.storage == "dense":
        spec = fft_api.rfft(frame, n=n, backend=config.fft_backend)[..., :k]
        if ring:
            new_fdl = fdl_lib.fdl_ring_push_dense(state["fdl"], spec, pos)
        else:
            new_fdl = fdl_lib.fdl_push_dense(state["fdl"], spec)
        return {"fdl": new_fdl}, spec

    fwd = None if mats is None else mats[0]
    if config.use_packed:
        if _use_fourstep_stream(config):
            from neojax.fft.four_step import rfft_packed_split_large

            spec_re, spec_im = rfft_packed_split_large(frame, n)
        else:
            spec_re, spec_im = matmul_backend.rfft_packed_split(frame, n, mats=fwd)
        new_fdl, new_dcny = fdl_lib.fdl_packed_push(
            state["fdl"], state["dcny"], spec_re, spec_im, pos
        )
        return {"fdl": new_fdl, "dcny": new_dcny}, (spec_re, spec_im)

    if _use_fourstep_stream(config):
        from neojax.fft.four_step import rfft_split_large

        spec_re, spec_im = rfft_split_large(frame, n)
    elif _use_split_fft(config):
        spec_re, spec_im = matmul_backend.rfft_split(frame, n, mats=fwd)
    else:
        spec = fft_api.rfft(frame, n=n, backend=config.fft_backend)[..., :k]
        spec_re = jnp.real(spec)
        spec_im = jnp.imag(spec)
    if ring:
        new_fdl = fdl_lib.fdl_ring_push_split(state["fdl"], spec_re, spec_im, pos)
    else:
        new_fdl = fdl_lib.fdl_push_split(state["fdl"], spec_re, spec_im)
    return {"fdl": new_fdl}, (spec_re, spec_im)


def insert_only_step(config: PartitionedConfig, state: dict, block: jnp.ndarray,
                     mats=None) -> dict:
    """Advance the FDL/tail state by one block WITHOUT the MAC + irfft.

    The warmup primitive of the time-sharded pipeline (``dist.timesharded``):
    prefilling a device's FDL from halo blocks costs one rfft per block but
    skips the expensive partition reduce. State after N insert-only steps is
    identical to N full steps (outputs discarded).
    """
    frame = _frame(config, state, block)
    update, _ = _spectrum_and_push(config, state, frame, mats)
    new_state = dict(state)
    new_state.update(update)
    if config.scheme == "upols":
        new_state["tail"] = block.astype(jnp.float32)
    if config.layout == "ring":
        new_state["pos"] = (state["pos"] + 1) % config.num_partitions
    return new_state


def step(config: PartitionedConfig, params: dict, state: dict, block: jnp.ndarray,
         mats=None):
    """One streaming block: [C, B] in -> [C, B] out (pure; state is the carry).

    ``mats``: optional precomputed transform matrices (``_transform_mats``);
    pass them when calling step inside a loop so the in-trace matrix
    generation is hoisted (process does this automatically)."""
    b = config.block_size
    n = config.transform_size

    frame = _frame(config, state, block)
    new_tail = block if config.scheme == "upols" else None

    ring = config.layout == "ring"
    p = config.num_partitions
    pos = state.get("pos")

    update, _ = _spectrum_and_push(config, state, frame, mats)
    new_fdl = update["fdl"]
    if config.storage == "dense":
        if ring:
            filt = fdl_lib.rotated_filter(params["filt"], pos, p)
        else:
            filt = params["filt"]
        acc = fdl_lib.fdl_mac_dense(new_fdl, filt)
        y = fft_api.irfft(acc, n=n, backend=config.fft_backend)
    else:
        if ring:
            filt_re = fdl_lib.rotated_filter(params["filt_re"], pos, p)
            filt_im = fdl_lib.rotated_filter(params["filt_im"], pos, p)
        else:
            filt_re, filt_im = params["filt_re"], params["filt_im"]
        acc_re, acc_im = fdl_lib.fdl_mac_split(new_fdl, filt_re, filt_im)
        if config.use_packed:
            # Overwrite the garbage lane-0 complex product with the exact
            # DC/Nyquist real MACs from the f32 side-carry.
            filt_dcny = fdl_lib.rotated_filter(params["filt_dcny"], pos, p)
            acc_dcny = fdl_lib.dcny_mac(update["dcny"], filt_dcny)  # [C, 2]
            acc_re = acc_re.at[:, 0].set(acc_dcny[:, 0])
            acc_im = acc_im.at[:, 0].set(acc_dcny[:, 1])
            if _use_fourstep_stream(config):
                from neojax.fft.four_step import irfft_packed_split_large

                y = irfft_packed_split_large(acc_re, acc_im, n)
            else:
                y = matmul_backend.irfft_packed_split(
                    acc_re, acc_im, n, mats=None if mats is None else mats[1]
                )
        elif _use_fourstep_stream(config):
            from neojax.fft.four_step import irfft_split_large

            y = irfft_split_large(acc_re, acc_im, n)
        elif _use_split_fft(config):
            y = matmul_backend.irfft_split(
                acc_re, acc_im, n, mats=None if mats is None else mats[1]
            )
        else:
            y = fft_api.irfft(
                jax.lax.complex(acc_re, acc_im), n=n, backend=config.fft_backend
            )

    if config.scheme == "upols":
        out = y[..., b:].astype(block.dtype)
    else:
        out = (y[..., :b] + state["tail"]).astype(block.dtype)
        new_tail = y[..., b:].astype(jnp.float32)

    new_state = dict(state)
    new_state.update(update)
    new_state["tail"] = new_tail.astype(jnp.float32)
    if ring:
        new_state["pos"] = (pos + 1) % p
    return new_state, out


def process(
    config: PartitionedConfig, params: dict, state: dict, signal: jnp.ndarray
):
    """Stream a whole signal [C, T] (or [T]) through the convolver via scan."""
    signal = jnp.asarray(signal)
    squeeze = signal.ndim == 1
    if squeeze:
        signal = signal[None]
    blocks, length = stream_blocks(signal, config.block_size)

    mats = _transform_mats(config)

    def body(carry, blk):
        new_carry, out = step(config, params, carry, blk, mats)
        return new_carry, out

    state, outs = jax.lax.scan(body, state, blocks)
    out = unstream_blocks(outs, length)
    if squeeze:
        out = out[0]
    return state, out


class Convolver:
    """Stateful convenience wrapper mirroring the reference's ergonomics
    (``convolver.filter(partitions); convolver(block)``), built on the pure
    functional core. Use the functional API directly inside jit/scan."""

    def __init__(
        self,
        scheme: str = "upols",
        storage: str | None = None,
        fft_backend: str | None = None,
        sparsity: Any = None,
        require_sparsity: bool = False,
    ):
        if storage is None:
            # complex64 on the CPU; on an accelerator the split
            # (planar re/im float) storage is the native layout.
            storage = "dense" if jax.default_backend() == "cpu" else "split"
        self._scheme = scheme
        self._storage = storage
        self._fft_backend = fft_backend
        # Sparse-convolver semantics (``sparse_convolver.hpp:16-21``): the
        # reference's sparse aliases compose a ``sparse_filter`` whose
        # ``filter(partitions, predicate)`` REQUIRES a sparsity predicate;
        # the dense aliases have no such slot. ``sparsity`` here is the
        # construction-time default predicate/mask, ``require_sparsity``
        # makes ``filter()`` reject a missing one instead of silently
        # running dense.
        self._default_sparsity = sparsity
        self._require_sparsity = require_sparsity
        self.config: PartitionedConfig | None = None
        self.params: dict | None = None
        self.state: dict | None = None
        self._jit_step = None
        self._jit_process = None

    def filter(self, partitions, sparsity: Any = None) -> None:
        """Install a partitioned filter ([P, K] or [C|1, P, K] spectra)."""
        if sparsity is None:
            sparsity = self._default_sparsity
        if sparsity is None and self._require_sparsity:
            raise ValueError(
                "this is a sparse convolver (sparse_upols/upola_convolver, "
                "sparse_convolver.hpp:16-21): pass a sparsity predicate "
                "(row, col, value) -> bool or a boolean keep-mask, either "
                "to filter(partitions, sparsity=...) or at construction"
            )
        partitions = np.asarray(partitions)
        if partitions.ndim == 2:
            partitions = partitions[None]
        channels, p, bins = partitions.shape
        self._filter_channels = channels
        self.config = PartitionedConfig(
            block_size=bins - 1,
            num_partitions=p,
            channels=channels,
            scheme=self._scheme,
            storage=self._storage,
            fft_backend=self._fft_backend,
        )
        self.params = filter_params(self.config, partitions, sparsity=sparsity)
        self.reset()
        self._jit_step = jax.jit(partial(step, self.config))
        self._jit_process = jax.jit(partial(process, self.config))

    def reset(self) -> None:
        if self.config is None:
            raise RuntimeError("call filter() first")
        self.state = init_state(self.config)
        self._streamed = False
        self._in_fifo: np.ndarray | None = None
        self._out_fifo: np.ndarray | None = None
        self.latency = 0

    def _bind_channels(self, channels: int) -> None:
        """Late channel binding: a shared (mono) filter serves any channel
        count — like the reference plugin instantiating one convolver per
        signal channel over one IR (``DenseConvolution.cpp:151-154``)."""
        if self.config.channels == channels:
            return
        if self._filter_channels != 1:
            raise ValueError(
                f"signal has {channels} channels but filter has "
                f"{self._filter_channels}"
            )
        if self._streamed:
            raise RuntimeError("cannot change channel count mid-stream; reset() first")
        self.config = dataclasses.replace(self.config, channels=channels)
        self.state = init_state(self.config)
        self._jit_step = jax.jit(partial(step, self.config))
        self._jit_process = jax.jit(partial(process, self.config))

    def __call__(self, block):
        """Stream one chunk of ANY length >= 0 (the reference upola_v2 /
        ConstantOverlapAdd contract, ``overlap_add_convolver.hpp:72-135``,
        ``ConstantOverlapAdd.hpp:89-199``): returns exactly as many samples
        as given. Exact-block chunks with nothing buffered take the direct
        path (zero added latency, bit-identical to ``process``); any other
        chunking engages a host re-blocking FIFO with a fixed stream
        latency of block_size-1 silence samples (``self.latency``)."""
        if self.config is None:
            raise RuntimeError("call filter() first")
        block = jnp.asarray(block, dtype=jnp.float32)
        squeeze = block.ndim == 1
        if squeeze:
            block = block[None]
        self._bind_channels(block.shape[0])
        b = self.config.block_size
        buffered = self._in_fifo is not None and self._in_fifo.shape[-1] > 0
        if block.shape[-1] == b and not buffered:
            self.state, out = self._jit_step(self.params, self.state, block)
            self._streamed = True
            return out[0] if squeeze else out
        out = self._reblocked(np.asarray(block))
        return out[0] if squeeze else out

    def _reblocked(self, x: "np.ndarray") -> "np.ndarray":
        b = self.config.block_size
        c = self.config.channels
        if self._in_fifo is None:
            # Fixed stream latency of B-1 samples, pre-filled as silence —
            # the tight worst-case re-blocking bound (at most B-1 input
            # samples can sit unprocessed), so the output never underruns
            # mid-stream no matter how calls are chunked. The reference
            # plugin re-blocker reports its frame size the same way
            # (ConstantOverlapAdd.hpp:89-199, getLatencyInSamples).
            self.latency = b - 1
            self._in_fifo = np.zeros((c, 0), np.float32)
            self._out_fifo = np.zeros((c, self.latency), np.float32)
        self._in_fifo = np.concatenate([self._in_fifo, x], axis=-1)
        n_blocks = self._in_fifo.shape[-1] // b
        for i in range(n_blocks):  # per-block jit steps: one compiled shape
            blk = jnp.asarray(self._in_fifo[:, i * b : (i + 1) * b])
            self.state, y = self._jit_step(self.params, self.state, blk)
            self._streamed = True
            self._out_fifo = np.concatenate([self._out_fifo, np.asarray(y)], -1)
        self._in_fifo = self._in_fifo[:, n_blocks * b :]
        want = x.shape[-1]
        out = self._out_fifo[:, :want]
        self._out_fifo = self._out_fifo[:, want:]
        return out

    def flush(self) -> "np.ndarray":
        """Drain the re-blocking FIFO: zero-pad any pending partial block,
        process it, and return the ``self.latency`` samples still owed —
        so concat(all __call__ returns, flush()) == zeros(latency) ++
        offline ``process(signal)``."""
        if self.config is None:
            raise RuntimeError("call filter() first")
        if self._in_fifo is None:
            return np.zeros((self.config.channels, 0), np.float32)
        b = self.config.block_size
        c = self.config.channels
        pending = self._in_fifo.shape[-1]
        if pending:
            pad = np.zeros((c, b - pending), np.float32)
            block = np.concatenate([self._in_fifo, pad], -1)
            self._in_fifo = np.zeros((c, 0), np.float32)
            self.state, y = self._jit_step(self.params, self.state, jnp.asarray(block))
            self._streamed = True
            self._out_fifo = np.concatenate([self._out_fifo, np.asarray(y)], -1)
        out = self._out_fifo[:, : self.latency]
        self._out_fifo = self._out_fifo[:, self.latency :]
        return out

    def process(self, signal):
        if self.config is None:
            raise RuntimeError("call filter() first")
        signal = jnp.asarray(signal, dtype=jnp.float32)
        self._bind_channels(signal.shape[0] if signal.ndim > 1 else 1)
        self.state, out = self._jit_process(self.params, self.state, signal)
        self._streamed = True
        return out


def make_convolver(scheme: str = "upols", storage: str | None = None, **kw) -> Convolver:
    return Convolver(scheme=scheme, storage=storage, **kw)


# Aliases mirroring the reference convolver family
# (``dense_convolver.hpp:20-39``, ``sparse_convolver.hpp:16-21``).
def upols_convolver() -> Convolver:
    return Convolver("upols")


def upola_convolver() -> Convolver:
    return Convolver("upola")


def upola_convolver_v2() -> Convolver:
    # The reference's v2 reschedules the tail-partition sum for arbitrary
    # input lengths (``overlap_add_convolver.hpp:21-137``); block-for-block
    # its output is identical, so v2 shares this implementation.
    return Convolver("upola")


def split_upols_convolver() -> Convolver:
    return Convolver("upols", "split")


def split_upola_convolver() -> Convolver:
    return Convolver("upola", "split")


def sparse_upols_convolver(sparsity: Any = None) -> Convolver:
    """UPOLS over a sparse (predicate-thinned) filter. Unlike the dense
    aliases this composes the reference's ``sparse_filter`` contract
    (``sparse_convolver.hpp:16``, ``sparse_filter.hpp:25-38``): a sparsity
    predicate ``(row, col, value) -> bool`` (or boolean keep-mask) must be
    supplied — here at construction, or later to ``filter(..., sparsity=)``.
    Dropped bins are zeroed in the filter planes (same output; the MAC
    still reads them)."""
    return Convolver("upols", sparsity=sparsity, require_sparsity=True)


def sparse_upola_convolver(sparsity: Any = None) -> Convolver:
    """UPOLA twin of :func:`sparse_upols_convolver` (same sparse-filter
    contract, ``sparse_convolver.hpp:21``)."""
    return Convolver("upola", sparsity=sparsity, require_sparsity=True)
