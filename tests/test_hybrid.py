"""Hybrid (two-stage) engine must match the uniform per-block schedule."""

import time

import numpy as np
from functools import partial
import pytest
import jax
import jax.numpy as jnp

from neojax import conv
from neojax.conv import hybrid
from neojax.conv import hybrid as hy


@pytest.mark.parametrize("s", [4, 8])
def test_hybrid_matches_blockwise(make_noise, s):
    b = 64
    p = 19  # not a multiple of s; tail padded with zero partitions
    channels = 3
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 24 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    params = conv.filter_params(cfg, parts)
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)

    hparams = hybrid.hybrid_filter_params(cfg, parts, s)
    hstate = hybrid.hybrid_init_state(cfg, hparams)
    _, out = hybrid.process_hybrid(cfg, hparams, hstate, jnp.asarray(sig))

    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4


def test_hybrid_per_channel_oracle(make_noise):
    b = 128
    p = 10
    channels = 2
    irs = make_noise(channels, p * b) * 0.1
    sig = make_noise(channels, 16 * b)
    parts = conv.uniform_partition(irs, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    hparams = hybrid.hybrid_filter_params(cfg, parts, 4)
    hstate = hybrid.hybrid_init_state(cfg, hparams)
    _, out = hybrid.process_hybrid(cfg, hparams, hstate, jnp.asarray(sig))
    out = np.asarray(out)

    for ch in range(channels):
        ref = np.convolve(np.asarray(sig)[ch], np.asarray(irs)[ch])[: out.shape[1]]
        assert np.max(np.abs(out[ch] - ref)) < 1e-4


def test_hybrid_short_filter_head_only(make_noise):
    """P <= S: pure per-block head, no tail machinery in the state."""
    b = 64
    p = 3
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 8 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    hparams = hybrid.hybrid_filter_params(cfg, parts, 4)
    assert "tail" not in hparams
    hstate = hybrid.hybrid_init_state(cfg, hparams)
    assert "meta_fdl" not in hstate
    _, out = hybrid.process_hybrid(cfg, hparams, hstate, jnp.asarray(sig))
    ref = np.convolve(np.asarray(sig)[0], ir)[: out.shape[1]]
    assert np.max(np.abs(np.asarray(out)[0] - ref)) < 1e-4


def test_hybrid_state_carries_across_calls(make_noise):
    b = 64
    p = 16
    s = 4
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 24 * b)
    parts = conv.uniform_partition(ir, b)
    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    hparams = hybrid.hybrid_filter_params(cfg, parts, s)

    st = hybrid.hybrid_init_state(cfg, hparams)
    _, full = hybrid.process_hybrid(cfg, hparams, st, jnp.asarray(sig))

    st = hybrid.hybrid_init_state(cfg, hparams)
    st, a = hybrid.process_hybrid(cfg, hparams, st, jnp.asarray(sig[:, : 12 * b]))
    _, bb = hybrid.process_hybrid(cfg, hparams, st, jnp.asarray(sig[:, 12 * b :]))
    got = np.concatenate([np.asarray(a), np.asarray(bb)], axis=-1)
    assert np.max(np.abs(got - np.asarray(full))) < 1e-6


@pytest.mark.parametrize("storage,tol", [("bf16", 5e-2), ("int16", 1e-2), ("int8", 1e-1)])
def test_hybrid_reduced_precision(make_noise, storage, tol):
    b = 64
    p = 16
    ir = make_noise(p * b) * 0.2
    sig = make_noise(2, 16 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=2, storage=storage)
    hparams = hybrid.hybrid_filter_params(cfg, parts, 4)
    hstate = hybrid.hybrid_init_state(cfg, hparams)
    _, out = hybrid.process_hybrid(cfg, hparams, hstate, jnp.asarray(sig))
    out = np.asarray(out)
    for ch in range(2):
        ref = np.convolve(np.asarray(sig)[ch], ir)[: out.shape[1]]
        assert np.max(np.abs(out[ch] - ref)) < tol


@pytest.mark.parametrize("storage", ["split", "int8"])
def test_hybrid_stream_matches_process(make_noise, storage):
    """HybridStream (per-block real-time driver) is block-for-block
    identical to the offline S-blocks-per-call process_hybrid."""
    b, s, c, p = 32, 4, 2, 20
    rng = np.random.default_rng(9)
    parts = (
        (rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1)))
        * 0.1
    ).astype(np.complex64)
    sig = make_noise(c, 6 * s * b)

    cfg = conv.PartitionedConfig(b, p, c, storage=storage)
    params = hy.hybrid_filter_params(cfg, parts, s)
    st = hy.hybrid_init_state(cfg, params)
    _, ref = jax.jit(partial(hy.process_hybrid, cfg))(params, st, jnp.asarray(sig))

    stream = hy.HybridStream(cfg, params)
    outs = []
    for i in range(sig.shape[1] // b):
        outs.append(np.asarray(stream(sig[:, i * b : (i + 1) * b])))
    out = np.concatenate(outs, axis=-1)
    tol = 1e-5 if storage == "split" else 1e-4
    np.testing.assert_allclose(out, np.asarray(ref), atol=tol)


def test_hybrid_stream_through_executor(make_noise):
    """The real-time path end-to-end: HybridStream driven by the
    StreamExecutor worker over the native lock-free rings, arbitrary
    producer chunk sizes — equals the offline stream (the plugin's
    ConstantOverlapAdd + processFrame contract)."""
    from neojax.io import StreamExecutor

    b, s, c, p = 32, 4, 2, 12
    rng = np.random.default_rng(11)
    parts = (
        (rng.standard_normal((1, p, b + 1)) + 1j * rng.standard_normal((1, p, b + 1)))
        * 0.1
    ).astype(np.complex64)
    nb = 4 * s
    sig = make_noise(c, nb * b)

    cfg = conv.PartitionedConfig(b, p, c, storage="split")
    params = hy.hybrid_filter_params(cfg, parts, s)
    st = hy.hybrid_init_state(cfg, params)
    _, ref = jax.jit(partial(hy.process_hybrid, cfg))(params, st, jnp.asarray(sig))

    stream = hy.HybridStream(cfg, params)

    def step(state, block):  # executor owns no engine state; stream does
        return state, stream(block)

    got = []
    with StreamExecutor(step, None, c, b) as ex:
        sent = 0
        t0 = time.time()
        while sum(x.shape[1] for x in got) < nb * b and time.time() - t0 < 60:
            if sent < sig.shape[1]:
                sent += ex.push(sig[:, sent : sent + 100])  # odd chunk size
            chunk = ex.pull(96)
            if chunk.shape[1]:
                got.append(chunk)
    out = np.concatenate(got, axis=-1)[:, : nb * b]
    np.testing.assert_allclose(out, np.asarray(ref)[:, : out.shape[1]], atol=1e-5)
