"""Distribution tests on the simulated 8-device CPU mesh.

The oracle (SURVEY.md section 4): the same workload run sharded must match
the single-device run within the reference tolerance.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from neojax import conv, dist


def np_full(x, h):
    return np.convolve(np.asarray(x), np.asarray(h), mode="full")


def test_mesh_construction():
    m = dist.make_mesh()
    assert m.shape["ch"] == 8 and m.shape["part"] == 1
    m2 = dist.make_mesh(ch=4, part=2)
    assert m2.shape["ch"] == 4 and m2.shape["part"] == 2


def test_channel_sharded_matches_single_device(make_noise):
    b = 128
    channels = 8
    ir = make_noise(4 * b)
    sig = make_noise(channels, 6 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, parts.shape[1], channels=channels)
    params = conv.filter_params(cfg, parts)
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)

    mesh = dist.make_mesh(ch=8)
    state2 = conv.init_state(cfg)
    _, out = dist.sharded_process(cfg, params, state2, jnp.asarray(sig), mesh)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-6


@pytest.mark.parametrize("part,ch", [(8, 1), (4, 2), (2, 4)])
def test_partition_pipeline_matches_oracle(make_noise, part, ch):
    b = 64
    channels = 4
    p = 16
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 8 * b)

    parts = conv.uniform_partition(ir, b)  # [1, P, K]
    mesh = dist.make_mesh(part=part, ch=ch)
    cfg = conv.PartitionedConfig(b, p, channels=channels)

    pipe = dist.PipelineConvolver(cfg, mesh)
    filt = pipe.shard_filter(jnp.moveaxis(jnp.asarray(parts), 0, 1))
    state = pipe.init_state()
    _, out = pipe.process(filt, state, sig)
    out = np.asarray(out)

    for c in range(channels):
        ref = np_full(sig[c], ir)[: out.shape[1]]
        assert np.max(np.abs(out[c] - ref)) < 1e-4


def test_pipeline_streaming_resume(make_noise):
    """Pipeline state carries across process() calls (stream continuity)."""
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(2, 8 * b)

    mesh = dist.make_mesh(part=4, ch=2)
    cfg = conv.PartitionedConfig(b, p, channels=2)
    pipe = dist.PipelineConvolver(cfg, mesh)
    parts = conv.uniform_partition(ir, b)
    filt = pipe.shard_filter(jnp.moveaxis(jnp.asarray(parts), 0, 1))

    state = pipe.init_state()
    _, full = pipe.process(filt, state, sig)

    state = pipe.init_state()
    state, first = pipe.process(filt, state, sig[:, : 4 * b])
    _, second = pipe.process(filt, state, sig[:, 4 * b :])
    resumed = np.concatenate([np.asarray(first), np.asarray(second)], axis=-1)
    assert np.max(np.abs(resumed - np.asarray(full))) < 1e-6


def test_bin_sharded_matches_oracle(make_noise):
    """Model-parallel over spectrum width (SURVEY 2.7 "bin" axis): the only
    collective is one psum of the time-domain block."""
    import jax.numpy as jnp
    from neojax import conv, dist

    b = 64
    p = 8
    ch = 4
    ir = make_noise(p * b) * 0.2
    sig = make_noise(ch, 8 * b)
    parts = conv.uniform_partition(ir, b)

    mesh = dist.make_mesh(bin=4, ch=2)
    cfg = conv.PartitionedConfig(b, p, channels=ch, storage="split")
    bc = dist.BinShardedConvolver(cfg, mesh)
    filt = bc.shard_filter(np.moveaxis(np.asarray(parts), 0, 1))
    state = bc.init_state()
    state, out = bc.process(filt, state, sig)
    out = np.asarray(out)
    for c in range(ch):
        ref = np.convolve(np.asarray(sig)[c], ir)[: out.shape[1]]
        assert np.max(np.abs(out[c] - ref)) < 1e-4


@pytest.mark.parametrize("storage,tol", [("bf16", 2e-2), ("int16", 1e-4), ("int8", 5e-3)])
def test_bin_sharded_quantized(make_noise, storage, tol):
    """Quantized bin-sharding: per-shard dynamic
    scales, no extra collective; bounds follow the reference's compressed-FDL
    tolerances (``test/.../compressed_fdl_test.cpp:24-29``) relative to the
    split-storage run."""
    from neojax import conv, dist

    b = 64
    p = 8
    ch = 4
    ir = make_noise(p * b) * 0.2
    sig = make_noise(ch, 8 * b)
    parts = conv.uniform_partition(ir, b)
    mesh = dist.make_mesh(bin=4, ch=2)

    outs = {}
    for st in ("split", storage):
        cfg = conv.PartitionedConfig(b, p, channels=ch, storage=st)
        bc = dist.BinShardedConvolver(cfg, mesh)
        filt = bc.shard_filter(np.moveaxis(np.asarray(parts), 0, 1))
        state = bc.init_state()
        _, out = bc.process(filt, state, sig)
        outs[st] = np.asarray(out)
    scale = max(1e-6, np.abs(outs["split"]).max())
    assert np.max(np.abs(outs[storage] - outs["split"])) / scale < tol


def test_bin_sharded_resume(make_noise):
    import jax.numpy as jnp
    from neojax import conv, dist

    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(2, 8 * b)
    parts = conv.uniform_partition(ir, b)
    mesh = dist.make_mesh(bin=8)
    cfg = conv.PartitionedConfig(b, p, channels=2, storage="split")
    bc = dist.BinShardedConvolver(cfg, mesh)
    filt = bc.shard_filter(np.moveaxis(np.asarray(parts), 0, 1))

    state = bc.init_state()
    _, full = bc.process(filt, state, sig)
    state = bc.init_state()
    state, a = bc.process(filt, state, sig[:, : 4 * b])
    _, bb = bc.process(filt, state, sig[:, 4 * b :])
    got = np.concatenate([np.asarray(a), np.asarray(bb)], axis=-1)
    assert np.max(np.abs(got - np.asarray(full))) < 1e-6


def test_weak_scaling_sweep_structure():
    """Structure check on the CPU mesh (wall-clock is not the metric here:
    the efficiency field just has to be populated and the math coherent)."""
    from neojax import bench

    points = bench.weak_scaling_sweep(
        device_counts=[1, 2, 4],
        channels_per_device=2,
        block_size=64,
        num_partitions=8,
        chunk_blocks=4,
        seconds=0.05,
        storage="split",
    )
    assert [p.devices for p in points] == [1, 2, 4]
    assert [p.channels for p in points] == [2, 4, 8]
    assert points[0].efficiency == 1.0
    for p in points:
        assert p.samples_per_sec > 0
        assert abs(p.per_device - p.samples_per_sec / p.devices) < 1e-6
