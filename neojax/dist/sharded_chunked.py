"""Channel-sharded chunked (Toeplitz-GEMM) processing.

The throughput path of the framework combined with its distribution story:
the chunked engine's history/accumulator tensors carry the channel axis
last ([K, M, C]), so sharding C over the mesh "ch" axis keeps every
matmul, concat and FFT local to its shard — zero collectives, linear
scaling over chips and hosts (the 256-channel multi-host config of
BASELINE.json). Toeplitz params are replicated (shared filter).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from neojax.conv import chunked, nested
from neojax.conv.convolver import PartitionedConfig

__all__ = [
    "shard_chunked_state",
    "sharded_process_chunked",
    "shard_nested_state",
    "sharded_process_nested",
    "shard_hybrid_state",
    "sharded_process_hybrid",
]


def _named(mesh, *spec):
    return NamedSharding(mesh, P(*spec))


def shard_chunked_state(state: dict, mesh: Mesh) -> dict:
    hists = tuple(
        jax.device_put(h, _named(mesh, None, None, "ch")) for h in state["hists"]
    )
    return {
        "tail": jax.device_put(state["tail"], _named(mesh, "ch", None)),
        "hists": hists,
    }


@partial(jax.jit, static_argnums=(0, 4))
def _process(config, params, state, signal, chunk_blocks):
    return chunked.process_chunked(config, params, state, signal, chunk_blocks)


def sharded_process_chunked(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal,
    mesh: Mesh,
    chunk_blocks: int,
):
    """Channel-sharded ``process_chunked`` (shared filter, replicated params)."""
    signal = jax.device_put(jnp.asarray(signal, jnp.float32), _named(mesh, "ch", None))
    params = jax.tree.map(lambda v: jax.device_put(v, _named(mesh)), params)
    state = shard_chunked_state(state, mesh)
    return _process(config, params, state, signal, chunk_blocks)


def shard_nested_state(state: dict, mesh: Mesh) -> dict:
    """Channel axis is dim 1 of prev [2,C,K,S], dim 2 of fdl [2,P2,C,K,2S]."""
    out = {
        "tail": jax.device_put(state["tail"], _named(mesh, "ch", None)),
        "prev": jax.device_put(state["prev"], _named(mesh, None, "ch", None, None)),
        "fdl": jax.device_put(
            state["fdl"], _named(mesh, None, None, "ch", None, None)
        ),
        "pos": jax.device_put(state["pos"], _named(mesh)),
    }
    if "scales" in state:
        out["scales"] = jax.device_put(
            state["scales"],
            _named(mesh, *(["ch" if i == 1 else None
                            for i in range(state["scales"].ndim)])),
        )
    return out


@partial(jax.jit, static_argnums=(0,))
def _process_nested(config, params, state, signal):
    return nested.process_nested(config, params, state, signal)


def sharded_process_nested(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal,
    mesh: Mesh,
):
    """Channel-sharded ``process_nested``.

    Shared filters are replicated; per-channel filters shard their channel
    axis (dim 1 of [P2, C, K, 2S]) so filter reads stay shard-local too.
    """
    signal = jax.device_put(jnp.asarray(signal, jnp.float32), _named(mesh, "ch", None))
    per_channel = params["filt_re"].shape[1] > 1
    fspec = _named(mesh, None, "ch", None, None) if per_channel else _named(mesh)
    params = {k: jax.device_put(v, fspec) for k, v in params.items()}
    state = shard_nested_state(state, mesh)
    return _process_nested(config, params, state, signal)


def shard_hybrid_state(state: dict, mesh: Mesh) -> dict:
    """Channel axes: btail [C,B] dim 0; head_fdl [2,S,C,K] dim 2;
    meta_fdl [2,P2,C,K,2S] dim 2; prev_spec/tail_frames [2,C,K,S] dim 1;
    meta_scales [P2,C,K,G] dim 1."""
    spec_of = {
        "btail": ("ch", None),
        "head_fdl": (None, None, "ch", None),
        "meta_fdl": (None, None, "ch", None, None),
        "prev_spec": (None, "ch", None, None),
        "tail_frames": (None, "ch", None, None),
        "meta_scales": (None, "ch", None, None),
    }
    return {
        k: jax.device_put(v, _named(mesh, *spec_of.get(k, ())))
        for k, v in state.items()
    }


@partial(jax.jit, static_argnums=(0,))
def _process_hybrid(config, params, state, signal):
    from neojax.conv import hybrid

    return hybrid.process_hybrid(config, params, state, signal)


def sharded_process_hybrid(
    config: PartitionedConfig,
    params: dict,
    state: dict,
    signal,
    mesh: Mesh,
):
    """Channel-sharded ``process_hybrid`` — the real-time (single-block
    latency) engine over the data-parallel mesh axis. Shared filters
    replicate; per-channel filters shard their channel axis so head and
    tail filter reads stay shard-local."""
    signal = jax.device_put(
        jnp.asarray(signal, jnp.float32), _named(mesh, "ch", None)
    )
    per_channel = params["head_re"].shape[1] > 1
    head_spec = _named(mesh, None, "ch", None) if per_channel else _named(mesh)
    tail_spec = (
        _named(mesh, None, "ch", None, None) if per_channel else _named(mesh)
    )
    new_params = {
        "head_re": jax.device_put(params["head_re"], head_spec),
        "head_im": jax.device_put(params["head_im"], head_spec),
    }
    if "tail" in params:
        new_params["tail"] = {
            k: jax.device_put(v, tail_spec) for k, v in params["tail"].items()
        }
    state = shard_hybrid_state(state, mesh)
    return _process_hybrid(config, new_params, state, signal)
