"""One uniform handle over the four convolution engines.

The functional cores (``conv.convolver.process``, ``conv.chunked``,
``conv.nested``, ``conv.hybrid``) share the (params, state, signal)
shape but differ in builders and chunking constraints. ``make_engine``
bundles them behind one stateful object so switching engines is a
string — the ergonomic parity point for a reference user picking
between convolver aliases (``dense_convolver.hpp:20-39``), extended
with this framework's beyond-parity engines:

    eng = conv.make_engine("hybrid", parts, block_size=512,
                           storage="int16", chunk_blocks=64)
    wet = eng.process(sig)        # streaming state carries across calls
    eng.reset()

Engines: "perblock" (uniform per-block step — TRUE 1-block latency),
"hybrid" (two-stage head+tail — 1-block latency at near-throughput
speed), "nested" (two-level FDL — the throughput engine, S-block
latency), "chunked" (Toeplitz-GEMM, S-block latency). For a per-block
real-time callback use ``conv.hybrid.HybridStream`` directly.
"""

from __future__ import annotations

from functools import partial
from typing import Any

import jax
import numpy as np

from neojax.conv import chunked as chunked_lib
from neojax.conv import convolver as cv
from neojax.conv import hybrid as hybrid_lib
from neojax.conv import nested as nested_lib

__all__ = ["make_engine", "Engine"]

_DEFAULT_CHUNKS = {"nested": 128, "hybrid": 64, "chunked": 32}


class Engine:
    """Stateful wrapper: filter installed at construction, streaming
    state carried across ``process`` calls, checkpointable via
    ``.state`` (a pytree — see ``io.checkpoint``)."""

    def __init__(
        self,
        engine: str,
        partitions,
        block_size: int | None = None,
        storage: str | None = None,
        scheme: str = "upols",
        chunk_blocks: int | None = None,
        channels: int | None = None,
        sparsity: Any = None,
    ):
        if engine not in ("perblock", "nested", "hybrid", "chunked"):
            raise ValueError(f"unknown engine {engine!r}")
        partitions = np.asarray(partitions)
        if partitions.ndim == 2:
            partitions = partitions[None]
        c_filt, p, bins = partitions.shape
        if block_size is None:
            block_size = bins - 1
        if block_size != bins - 1:
            raise ValueError(
                f"partitions have {bins} bins but block_size={block_size} "
                f"expects {block_size + 1} (uniform_partition at the same "
                "block size)"
            )
        if storage is None:
            storage = "dense" if jax.default_backend() == "cpu" else "split"
        self.engine = engine
        self.chunk_blocks = chunk_blocks or _DEFAULT_CHUNKS.get(engine, 0)
        channels = channels or c_filt
        self.config = cv.PartitionedConfig(
            block_size, p, channels, scheme=scheme, storage=storage
        )

        mask = None
        if sparsity is not None:
            from neojax.conv.sparse import sparsity_mask

            if callable(sparsity):
                per_channel = np.moveaxis(
                    cv._canon_partitions(self.config, partitions), 1, 0
                )
                mask = sparsity_mask(per_channel, sparsity)
            else:
                mask = np.asarray(sparsity, bool)

        s = self.chunk_blocks
        if engine == "perblock":
            self.params = cv.filter_params(
                self.config, partitions, sparsity=mask
            )
            self._init = lambda: cv.init_state(self.config)
            self._proc = jax.jit(partial(cv.process, self.config))
        elif engine == "nested":
            self.params = nested_lib.nested_filter_params(
                self.config, partitions, s, mask=mask
            )
            self._init = lambda: nested_lib.nested_init_state(
                self.config, self.params
            )
            self._proc = jax.jit(partial(nested_lib.process_nested, self.config))
        elif engine == "hybrid":
            self.params = hybrid_lib.hybrid_filter_params(
                self.config, partitions, s, mask=mask
            )
            self._init = lambda: hybrid_lib.hybrid_init_state(
                self.config, self.params
            )
            self._proc = jax.jit(partial(hybrid_lib.process_hybrid, self.config))
        else:  # chunked
            self.params = chunked_lib.chunked_filter_params(
                self.config, partitions, s, mask=mask
            )
            self._init = lambda: chunked_lib.chunked_init_state(
                self.config, self.params
            )
            self._proc = jax.jit(
                partial(chunked_lib.process_chunked, self.config, chunk_blocks=s)
            )
        self.reset()

    # latency in samples: what the engine's scheduling delays the stream by
    @property
    def latency(self) -> int:
        if self.engine in ("perblock", "hybrid"):
            return 0  # one-block-in, one-block-out
        return 0  # nested/chunked pad internally; process() is offline-exact

    def reset(self) -> None:
        self.state = self._init()

    def process(self, signal):
        """[C, T] (or [T]) -> same-shape wet signal; state carries over.

        nested/chunked process in S*B-sample steps — feed multiples of
        ``chunk_blocks * block_size`` samples to keep the carried state
        exactly continuous across calls (a partial final chunk is
        zero-padded internally, exact for THAT call's output only)."""
        self.state, out = self._proc(self.params, self.state, signal)
        return out


def make_engine(engine: str, partitions, **kwargs) -> Engine:
    return Engine(engine, partitions, **kwargs)
