"""Scaling-efficiency harness: samples/s per device across mesh sizes.

BASELINE.md's third north-star metric is 1 -> N-device scaling efficiency
(>= 0.9) for the channel-sharded streaming convolution. This module
measures it on whatever devices exist: real GPUs when available,
or the `--xla_force_host_platform_device_count` CPU mesh (structure
validation only — CPU wall-clock is not the metric).

Weak scaling is the natural audio axis (channels grow with devices:
every chip serves its own channel block and there are zero collectives in
the channel-sharded engine), so efficiency is defined as

    eff(N) = per-device samples/s at N devices
             / per-device samples/s at the smallest measured mesh

with the per-device channel count held fixed (with the default
device_counts starting at 1, this is exactly the 1 -> N definition).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import jax
import jax.numpy as jnp

from neojax.conv import convolver as cv
from neojax.conv import nested
from neojax import dist

__all__ = ["ScalingPoint", "weak_scaling_sweep"]


@dataclasses.dataclass
class ScalingPoint:
    devices: int
    channels: int
    samples_per_sec: float
    per_device: float
    efficiency: float


def _run_once(config, params, state, sig, mesh) -> float:
    t_best = None
    for _ in range(3):
        st = jax.tree.map(jnp.copy, state)
        t0 = time.perf_counter()
        _, out = dist.sharded_process_nested(config, params, st, sig, mesh)
        float(jnp.sum(jnp.abs(out[:, -8:])))  # host fetch = reliable sync
        dt = time.perf_counter() - t0
        t_best = dt if t_best is None else min(t_best, dt)
    return sig.shape[0] * sig.shape[1] / t_best


def weak_scaling_sweep(
    device_counts=None,
    channels_per_device: int = 8,
    block_size: int = 512,
    num_partitions: int = 256,
    chunk_blocks: int = 64,
    seconds: float = 10.0,
    storage: str = "bf16",
):
    """Run the channel-sharded nested engine at growing mesh sizes.

    Returns a list of ScalingPoint (efficiency relative to the 1-device
    run, per-device channels fixed at ``channels_per_device``).
    """
    n_dev = len(jax.devices())
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= n_dev]
    rng = np.random.default_rng(0)
    nb = int(seconds * 48000) // block_size
    nb -= nb % chunk_blocks
    ir = rng.uniform(-1, 1, (1, num_partitions * block_size)).astype(np.float32) * 0.05

    points: list[ScalingPoint] = []
    base_per_device = None
    for d in device_counts:
        ch = channels_per_device * d
        config = cv.PartitionedConfig(
            block_size, num_partitions, channels=ch, storage=storage
        )
        from neojax.conv.partition import uniform_partition

        parts = uniform_partition(jnp.asarray(ir), block_size)
        params = nested.nested_filter_params(config, parts, chunk_blocks)
        state = nested.nested_init_state(config, params)
        sig = jnp.asarray(
            rng.uniform(-1, 1, (ch, nb * block_size)).astype(np.float32)
        )
        mesh = dist.make_mesh(ch=d, devices=jax.devices()[:d])
        sps = _run_once(config, params, state, sig, mesh)
        if base_per_device is None:
            base_per_device = sps / d
        points.append(
            ScalingPoint(
                devices=d,
                channels=ch,
                samples_per_sec=sps,
                per_device=sps / d,
                efficiency=(sps / d) / base_per_device,
            )
        )
    return points
