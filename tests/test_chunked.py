"""Chunked (Toeplitz-GEMM) path must match the per-block streaming path."""

import numpy as np
import pytest
import jax.numpy as jnp

from neojax import conv
from neojax.conv import chunked


@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("s", [4, 8])
def test_chunked_matches_blockwise(make_noise, scheme, s):
    b = 64
    p = 12
    channels = 3
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 16 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, scheme=scheme, storage="split")
    params = conv.filter_params(cfg, parts)
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)

    cparams = chunked.chunked_filter_params(cfg, parts, s)
    cstate = chunked.chunked_init_state(cfg, cparams)
    _, out = chunked.process_chunked(cfg, cparams, cstate, jnp.asarray(sig), s)

    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4


def test_chunked_matches_direct_oracle(make_noise):
    b = 128
    p = 8
    ir = make_noise(p * b) * 0.1
    sig = make_noise(2, 16 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=2, storage="split")
    cparams = chunked.chunked_filter_params(cfg, parts, 8)
    cstate = chunked.chunked_init_state(cfg, cparams)
    _, out = chunked.process_chunked(cfg, cparams, cstate, jnp.asarray(sig), 8)
    out = np.asarray(out)

    for ch in range(2):
        ref = np.convolve(np.asarray(sig)[ch], ir)[: out.shape[1]]
        assert np.max(np.abs(out[ch] - ref)) < 1e-4


def test_chunked_state_carries_across_calls(make_noise):
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 16 * b)
    parts = conv.uniform_partition(ir, b)
    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    cparams = chunked.chunked_filter_params(cfg, parts, 4)

    st = chunked.chunked_init_state(cfg, cparams)
    _, full = chunked.process_chunked(cfg, cparams, st, jnp.asarray(sig), 4)

    st = chunked.chunked_init_state(cfg, cparams)
    st, a = chunked.process_chunked(cfg, cparams, st, jnp.asarray(sig[:, : 8 * b]), 4)
    _, bb = chunked.process_chunked(cfg, cparams, st, jnp.asarray(sig[:, 8 * b :]), 4)
    got = np.concatenate([np.asarray(a), np.asarray(bb)], axis=-1)
    assert np.max(np.abs(got - np.asarray(full))) < 1e-6


def test_chunked_rejects_per_channel_filter(make_noise):
    b = 64
    parts = conv.uniform_partition(make_noise(2, 4 * b), b)
    cfg = conv.PartitionedConfig(b, parts.shape[1], channels=2)
    with pytest.raises(ValueError, match="nested"):
        chunked.chunked_filter_params(cfg, parts, 4)


def test_chunked_banded_sparse_matches_masked_dense(make_noise):
    """Banded-bucket sparse chunked == per-block convolver with the same
    mask (the perceptual sparse path at GEMM speed)."""
    b = 64
    p = 24
    ir = (make_noise(p * b) * np.exp(-np.arange(p * b) / (4 * b))).astype(np.float32) * 0.3
    sig = make_noise(2, 16 * b)
    parts = conv.uniform_partition(ir, b)
    mask = np.asarray(conv.perceptual_mask(np.asarray(parts)[0], 48000.0, -50.0))

    cfg = conv.PartitionedConfig(b, p, channels=2, storage="split")
    # reference: per-block with masked filter
    params = conv.filter_params(cfg, parts, sparsity=mask[None])
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)

    cparams = chunked.chunked_filter_params(cfg, parts, 8, mask=mask)
    assert len(cparams["buckets"]) > 1  # actually bucketed
    total_band = sum(bk["band"] * bk["bins"].shape[0] for bk in cparams["buckets"])
    assert total_band < 0.9 * p * cfg.num_bins  # real band savings
    cstate = chunked.chunked_init_state(cfg, cparams)
    _, out = chunked.process_chunked(cfg, cparams, cstate, jnp.asarray(sig), 8)

    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4


def test_chunked_fully_masked_bins_are_zero(make_noise):
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    parts = conv.uniform_partition(ir, b)
    mask = np.ones((p, b + 1), bool)
    mask[:, 40:] = False  # kill all high bins entirely

    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    cparams = chunked.chunked_filter_params(cfg, parts, 4, mask=mask)
    cstate = chunked.chunked_init_state(cfg, cparams)
    sig = make_noise(1, 8 * b)
    _, out = chunked.process_chunked(cfg, cparams, cstate, jnp.asarray(sig), 4)

    # compare against per-block with the same mask
    params = conv.filter_params(cfg, parts, sparsity=mask[None])
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4
