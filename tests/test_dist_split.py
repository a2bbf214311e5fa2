"""Split-storage (complex-free) pipeline on the CPU mesh."""

import numpy as np
import pytest
import jax.numpy as jnp

from neojax import conv, dist


@pytest.mark.parametrize("storage", ["split", "bf16", "int8", "int16"])
@pytest.mark.parametrize("part,ch", [(4, 2), (2, 4)])
def test_split_pipeline_matches_oracle(make_noise, storage, part, ch):
    b = 64
    channels = 4
    p = 16
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 8 * b)

    parts = conv.uniform_partition(ir, b)  # [1, P, K]
    mesh = dist.make_mesh(part=part, ch=ch)
    cfg = conv.PartitionedConfig(b, p, channels=channels, storage=storage,
                                 fft_backend="matmul")

    pipe = dist.PipelineConvolver(cfg, mesh)
    filt = pipe.shard_filter(np.moveaxis(np.asarray(parts), 0, 1))
    state = pipe.init_state()
    _, out = pipe.process(filt, state, sig)
    out = np.asarray(out)

    # bf16: 2^-8 rel on ~O(10) spectra; int8/int16 follow the reference's
    # compressed-FDL bounds scaled by spectrum magnitude (the quantized
    # spectra here are O(10), vs the reference's unit-range test vectors).
    tol = {"split": 1e-4, "bf16": 1e-2, "int16": 1e-2, "int8": 1e-1}[storage]
    for c in range(channels):
        ref = np.convolve(np.asarray(sig)[c], ir)[: out.shape[1]]
        assert np.max(np.abs(out[c] - ref)) < tol


def test_split_pipeline_resume(make_noise):
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(2, 8 * b)

    mesh = dist.make_mesh(part=4, ch=2)
    cfg = conv.PartitionedConfig(b, p, channels=2, storage="split",
                                 fft_backend="matmul")
    pipe = dist.PipelineConvolver(cfg, mesh)
    parts = conv.uniform_partition(ir, b)
    filt = pipe.shard_filter(np.moveaxis(np.asarray(parts), 0, 1))

    state = pipe.init_state()
    _, full = pipe.process(filt, state, sig)

    state = pipe.init_state()
    state, first = pipe.process(filt, state, sig[:, : 4 * b])
    _, second = pipe.process(filt, state, sig[:, 4 * b :])
    resumed = np.concatenate([np.asarray(first), np.asarray(second)], axis=-1)
    assert np.max(np.abs(resumed - np.asarray(full))) < 1e-6


def test_sharded_chunked_matches_single_device(make_noise):
    import jax.numpy as jnp
    from neojax.conv import chunked
    from neojax.dist.sharded_chunked import sharded_process_chunked

    b = 64
    p = 16
    channels = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 8 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    cparams = chunked.chunked_filter_params(cfg, parts, 4)
    cstate = chunked.chunked_init_state(cfg, cparams)
    _, ref = chunked.process_chunked(cfg, cparams, cstate, jnp.asarray(sig), 4)

    mesh = dist.make_mesh(ch=8)
    cstate2 = chunked.chunked_init_state(cfg, cparams)
    _, out = sharded_process_chunked(cfg, cparams, cstate2, sig, mesh, 4)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-5  # reference parity bound; GEMM tiling differs across shard counts


def test_sharded_nested_matches_single_device(make_noise):
    import jax.numpy as jnp

    from neojax.conv import nested
    from neojax.dist.sharded_chunked import sharded_process_nested
    from neojax import conv, dist

    b = 64
    p = 8
    channels = 8
    ir = make_noise(channels, p * b) * 0.2  # per-channel filters
    sig = make_noise(channels, 8 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, 4)
    nstate = nested.nested_init_state(cfg, nparams)
    _, ref = nested.process_nested(cfg, nparams, nstate, jnp.asarray(sig))

    mesh = dist.make_mesh(ch=4)
    nstate2 = nested.nested_init_state(cfg, nparams)
    _, out = sharded_process_nested(cfg, nparams, nstate2, sig, mesh)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-5  # reference parity bound; GEMM tiling differs across shard counts


def test_sharded_hybrid_matches_single_device(make_noise):
    """Channel-sharded hybrid (single-block-latency engine) equals the
    single-device run — per-channel filters shard their channel axis."""
    import jax.numpy as jnp

    from neojax.conv import hybrid
    from neojax.dist.sharded_chunked import sharded_process_hybrid
    from neojax import conv, dist

    b = 64
    p = 16
    channels = 8
    ir = make_noise(channels, p * b) * 0.2
    sig = make_noise(channels, 8 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    hparams = hybrid.hybrid_filter_params(cfg, parts, 4)
    hstate = hybrid.hybrid_init_state(cfg, hparams)
    _, ref = hybrid.process_hybrid(cfg, hparams, hstate, jnp.asarray(sig))

    mesh = dist.make_mesh(ch=4)
    hstate2 = hybrid.hybrid_init_state(cfg, hparams)
    _, out = sharded_process_hybrid(cfg, hparams, hstate2, sig, mesh)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-5
