"""Nested (two-level FDL) path must match the per-block streaming path."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from neojax import conv
from neojax.conv import nested


@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("s", [4, 8])
def test_nested_matches_blockwise(make_noise, scheme, s):
    b = 64
    p = 12  # not a multiple of s: exercises the zero-partition padding
    channels = 3
    ir = make_noise(p * b) * 0.2
    sig = make_noise(channels, 16 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=channels, scheme=scheme, storage="split")
    params = conv.filter_params(cfg, parts)
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)

    nparams = nested.nested_filter_params(cfg, parts, s)
    nstate = nested.nested_init_state(cfg, nparams)
    _, out = nested.process_nested(cfg, nparams, nstate, jnp.asarray(sig))

    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4


def test_nested_per_channel_filter_matches_oracle(make_noise):
    """Per-channel IRs — the capability the Toeplitz chunked mode lacks."""
    b = 128
    p = 6
    channels = 2
    irs = make_noise(channels, p * b) * 0.1
    sig = make_noise(channels, 12 * b)
    parts = conv.uniform_partition(irs, b)  # [C, P, K]

    cfg = conv.PartitionedConfig(b, p, channels=channels, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, 4)
    nstate = nested.nested_init_state(cfg, nparams)
    _, out = nested.process_nested(cfg, nparams, nstate, jnp.asarray(sig))
    out = np.asarray(out)

    for ch in range(channels):
        ref = np.convolve(np.asarray(sig)[ch], np.asarray(irs)[ch])[: out.shape[1]]
        assert np.max(np.abs(out[ch] - ref)) < 1e-4


def test_nested_state_carries_across_calls(make_noise):
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 16 * b)
    parts = conv.uniform_partition(ir, b)
    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, 4)

    st = nested.nested_init_state(cfg, nparams)
    _, full = nested.process_nested(cfg, nparams, st, jnp.asarray(sig))

    st = nested.nested_init_state(cfg, nparams)
    st, a = nested.process_nested(cfg, nparams, st, jnp.asarray(sig[:, : 8 * b]))
    _, bb = nested.process_nested(cfg, nparams, st, jnp.asarray(sig[:, 8 * b :]))
    got = np.concatenate([np.asarray(a), np.asarray(bb)], axis=-1)
    assert np.max(np.abs(got - np.asarray(full))) < 1e-6


def test_nested_mask_zeroes_bins(make_noise):
    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    parts = conv.uniform_partition(ir, b)
    mask = np.ones((p, b + 1), bool)
    mask[:, 40:] = False

    cfg = conv.PartitionedConfig(b, p, channels=1, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, 4, mask=mask)
    nstate = nested.nested_init_state(cfg, nparams)
    sig = make_noise(1, 8 * b)
    _, out = nested.process_nested(cfg, nparams, nstate, jnp.asarray(sig))

    params = conv.filter_params(cfg, parts, sparsity=mask[None])
    state = conv.init_state(cfg)
    _, ref = conv.process(cfg, params, state, sig)
    assert np.max(np.abs(np.asarray(out) - np.asarray(ref))) < 1e-4


def test_nested_rejects_mismatched_chunk_blocks(make_noise):
    b = 64
    parts = conv.uniform_partition(make_noise(4 * b), b)
    cfg = conv.PartitionedConfig(b, 4, channels=1, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, 4)
    nstate = nested.nested_init_state(cfg, nparams)
    with pytest.raises(ValueError):
        nested.process_nested(cfg, nparams, nstate, jnp.zeros((1, 8 * b)), chunk_blocks=8)


@pytest.mark.parametrize("storage,tol", [("int16", 1e-2), ("int8", 1e-1)])
def test_nested_quantized_storage(make_noise, storage, tol):
    """Compressed meta-FDL (int8/int16 + per-(c,k) dynamic scales)."""
    b = 64
    p = 16
    ir = make_noise(p * b) * 0.2
    sig = make_noise(2, 16 * b)
    parts = conv.uniform_partition(ir, b)

    cfg = conv.PartitionedConfig(b, p, channels=2, storage=storage)
    nparams = nested.nested_filter_params(cfg, parts, 4)
    nstate = nested.nested_init_state(cfg, nparams)
    st, out = nested.process_nested(cfg, nparams, nstate, jnp.asarray(sig))
    out = np.asarray(out)
    assert "scales" in st

    for ch in range(2):
        ref = np.convolve(np.asarray(sig)[ch], ir)[: out.shape[1]]
        # tolerance scales with spectrum magnitude (the reference's
        # compressed-FDL bounds assume unit-range data,
        # compressed_fdl_test.cpp:24-29)
        assert np.max(np.abs(out[ch] - ref)) < tol


def test_nested_state_checkpoint_roundtrip(make_noise, tmp_path):
    """The nested carry (incl. quantized scales) checkpoints exactly."""
    from neojax import io

    b = 64
    p = 8
    ir = make_noise(p * b) * 0.2
    sig = make_noise(1, 8 * b)
    parts = conv.uniform_partition(ir, b)
    cfg = conv.PartitionedConfig(b, p, channels=1, storage="int16")
    nparams = nested.nested_filter_params(cfg, parts, 4)
    st = nested.nested_init_state(cfg, nparams)
    st, _ = nested.process_nested(cfg, nparams, st, jnp.asarray(sig))

    path = str(tmp_path / "nested_state.npz")
    io.save_state(path, st)
    restored = io.load_state(path)
    for key in st:
        assert np.array_equal(np.asarray(st[key]), np.asarray(restored[key])), key

    # resuming from the restored state matches resuming from the live one
    sig2 = make_noise(1, 4 * b)
    _, a = nested.process_nested(cfg, nparams, st, jnp.asarray(sig2))
    _, bb = nested.process_nested(
        cfg, nparams, jax.tree.map(jnp.asarray, restored), jnp.asarray(sig2)
    )
    assert np.max(np.abs(np.asarray(a) - np.asarray(bb))) == 0.0


def test_nested_int16_row_scale_meets_class(make_noise):
    """int16 with G=1 row-granular scales stays within the reference's
    1e-4 tolerance class (compressed_fdl_test.cpp:24-29) on unit noise."""
    from functools import partial

    b, p, c, s = 64, 16, 2, 4
    rng = np.random.default_rng(4)
    ir = (rng.uniform(-1, 1, (1, p * b)) * 0.3).astype(np.float32)
    parts = conv.uniform_partition(ir, b)
    sig = make_noise(c, 8 * s * b)

    cfg = conv.PartitionedConfig(b, p, c, storage="int16")
    assert nested._quant_groups(cfg, s) == 1
    params = nested.nested_filter_params(cfg, parts, s)
    _, out = jax.jit(partial(nested.process_nested, cfg))(
        params, nested.nested_init_state(cfg, params), jnp.asarray(sig)
    )
    ref = np.stack(
        [np.convolve(sig[i], np.asarray(ir)[0])[: sig.shape[1]] for i in range(c)]
    )
    # The reference tolerance (1e-4 abs) is stated for unit-range data
    # (compressed_fdl_test feeds [-1, 1]); scale by the output's range.
    tol = 1.2e-4 * max(1.0, float(np.abs(ref).max()))
    assert np.max(np.abs(np.asarray(out) - ref)) < tol
