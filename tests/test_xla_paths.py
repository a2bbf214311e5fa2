"""The XLA per-block path every platform runs, against f64 oracles.

Covers what carries the per-block engine now that it has no hand-written
kernel: each storage x scheme x layout against numpy's convolution,
per-channel filters, the identity impulse, sparse and perceptual masks
through the XLA MAC, the quantizer's scale groups, the removed config
options, the compile-cache rule, the peak table, and the entry points
that refuse to run without a GPU.
"""

import os
import subprocess
import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from neojax import conv
from neojax.conv import convolver as cv
from neojax.conv import fdl as fdl_lib
from neojax.ops.quantize import int_max_for

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

B, P, C = 32, 6, 2
# SNR floors (dB) vs the f64 oracle at these shapes: the storage classes of
# bench._SNR_CLASS_DB, except int8 in the unpacked (shift) layout, which
# keeps one scale per spectrum row (conv.fdl docstring).
_FLOOR = {"split": 90.0, "bf16": 40.0, "int16": 74.0, "int8": 46.0}
_FLOOR_ROW_SCALE_INT8 = 38.0


def _snr_db(got, ref):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return 10 * np.log10(np.sum(ref**2) / np.sum((got - ref) ** 2))


def _oracle(sig, irs):
    """Per-channel f64 linear convolution, trimmed to the signal length."""
    irs = np.broadcast_to(irs, (sig.shape[0], irs.shape[-1]))
    return np.stack(
        [np.convolve(s.astype(np.float64), h.astype(np.float64))[: sig.shape[1]]
         for s, h in zip(sig, irs)]
    )


def _run(cfg, parts, sig, **kw):
    params = cv.filter_params(cfg, parts, **kw)
    _, out = jax.jit(partial(cv.process, cfg))(
        params, cv.init_state(cfg), jnp.asarray(sig)
    )
    return np.asarray(out)


def _decaying(rng, shape):
    n = shape[-1]
    return (rng.standard_normal(shape) * np.exp(-np.arange(n) / (n / 3))).astype(
        np.float32
    )


@pytest.mark.parametrize("layout", ["ring", "shift"])
@pytest.mark.parametrize("scheme", ["upols", "upola"])
@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_process_matches_f64_oracle(storage, scheme, layout, make_noise):
    rng = np.random.default_rng(1)
    ir = _decaying(rng, (1, P * B))
    sig = make_noise(C, 24 * B)
    cfg = cv.PartitionedConfig(B, P, C, scheme=scheme, storage=storage,
                               layout=layout)
    assert cfg.use_packed == (layout == "ring")
    out = _run(cfg, conv.uniform_partition(ir, B), sig)
    floor = _FLOOR[storage]
    if storage == "int8" and layout == "shift":
        floor = _FLOOR_ROW_SCALE_INT8
    assert _snr_db(out, _oracle(sig, ir)) >= floor


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_per_channel_filters(storage, make_noise):
    rng = np.random.default_rng(2)
    irs = _decaying(rng, (C, P * B))
    sig = make_noise(C, 20 * B)
    cfg = cv.PartitionedConfig(B, P, C, storage=storage)
    out = _run(cfg, conv.uniform_partition(irs, B), sig)
    assert _snr_db(out, _oracle(sig, irs)) >= _FLOOR[storage]


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_identity_impulse_passes_signal(storage, make_noise):
    ir = np.zeros((1, P * B), np.float32)
    ir[0, 0] = 1.0
    sig = make_noise(C, 12 * B)
    cfg = cv.PartitionedConfig(B, P, C, storage=storage)
    out = _run(cfg, conv.uniform_partition(ir, B), sig)
    assert _snr_db(out, sig) >= _FLOOR[storage]


def _sparse_case(make_noise):
    rng = np.random.default_rng(3)
    ir = _decaying(rng, (1, P * B))
    parts = np.asarray(conv.uniform_partition(ir, B))
    sig = make_noise(C, 16 * B)
    return parts, sig


def test_sparse_mask_equals_masked_filter(make_noise):
    parts, sig = _sparse_case(make_noise)
    mask = np.random.default_rng(4).uniform(size=parts.shape) < 0.4
    cfg = cv.PartitionedConfig(B, P, C, storage="split")
    got = _run(cfg, parts, sig, sparsity=mask)
    ref = _run(cfg, np.where(mask, parts, 0), sig)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_sparse_predicate_equals_masked_filter(make_noise):
    parts, sig = _sparse_case(make_noise)

    def keep(row, col, value):
        return (row < P // 2) | (col < B // 4)

    mask = conv.sparsity_mask(parts, keep)
    cfg = cv.PartitionedConfig(B, P, C, storage="bf16")
    got = _run(cfg, parts, sig, sparsity=keep)
    ref = _run(cfg, np.where(mask, parts, 0), sig)
    np.testing.assert_allclose(got, ref, atol=1e-6)


def test_perceptual_mask_through_xla_mac(make_noise):
    parts, sig = _sparse_case(make_noise)
    mask = conv.perceptual_mask(parts, 48000.0, -40.0)
    assert 0 < mask.mean() < 1
    got = _run(cv.PartitionedConfig(B, P, C, storage="int8"), parts, sig,
               sparsity=mask)
    ref = _run(cv.PartitionedConfig(B, P, C, storage="split"),
               np.where(mask, parts, 0), sig)
    assert _snr_db(got, ref) >= _FLOOR["int8"]


@pytest.mark.parametrize(
    "storage,lanes,groups",
    [("int8", 512, 128), ("int8", 513, 1), ("int16", 512, 1), ("bf16", 512, 1)],
)
def test_quant_groups(storage, lanes, groups):
    assert fdl_lib.quant_groups(storage, lanes) == groups


@pytest.mark.parametrize("dtype,groups", [(jnp.int8, 8), (jnp.int8, 1), (jnp.int16, 1)])
def test_quantize_round_trip_within_half_step(dtype, groups):
    spec = jax.random.normal(jax.random.PRNGKey(0), (2, 3, 32), jnp.float32)
    q, scale = fdl_lib.quantize_split(spec, dtype, groups)
    assert q.dtype == dtype and scale.shape == (3, groups)
    back = fdl_lib.dequantize_split(q[:, None], scale[None])[:, 0]
    step = np.repeat(np.asarray(scale), 32 // groups, axis=-1) / int_max_for(dtype)
    assert np.all(np.abs(np.asarray(back - spec)) <= 0.5 * step[None] * (1 + 1e-5))


@pytest.mark.parametrize("storage", ["split", "bf16", "int16", "int8"])
def test_fdl_mac_split_matches_numpy(storage):
    rng = np.random.default_rng(5)
    k = 16
    fdl = fdl_lib.fdl_packed_init(storage, P, C, k)[0]
    specs = rng.standard_normal((P, 2, C, k)).astype(np.float32)
    for i, (re, im) in enumerate(specs):
        fdl = fdl_lib.fdl_ring_push_split(fdl, jnp.asarray(re), jnp.asarray(im), jnp.int32(i))
    fr = rng.standard_normal((P, 1, k)).astype(np.float32)
    fi = rng.standard_normal((P, 1, k)).astype(np.float32)
    acc_re, acc_im = fdl_lib.fdl_mac_split(fdl, jnp.asarray(fr), jnp.asarray(fi))
    x = specs[:, 0] + 1j * specs[:, 1]
    ref = np.sum(x * (fr + 1j * fi), axis=0)
    got = np.asarray(acc_re) + 1j * np.asarray(acc_im)
    assert _snr_db(np.stack([got.real, got.imag]), np.stack([ref.real, ref.imag])) >= {
        "split": 120.0, "bf16": 40.0, "int16": 80.0, "int8": 40.0}[storage]


@pytest.mark.parametrize("option", [{"mac_backend": "pallas"}, {"fused": True}])
def test_config_rejects_removed_options(option):
    with pytest.raises(TypeError):
        cv.PartitionedConfig(B, P, C, storage="split", **option)


def test_filter_has_no_partition_padding():
    c = conv.make_convolver("upols", "split")
    c.filter(np.ones((1, 3, B + 1), np.complex64))
    assert c.config.num_partitions == 3
    with pytest.raises(TypeError):
        c.filter(np.ones((1, 3, B + 1), np.complex64), pad_partitions=32)


def test_fft_auto_backend_is_jnp_fft():
    from neojax.fft import api

    assert api._resolve_backend("auto", 1024) == "xla"
    assert api._resolve_backend("matmul", 1 << 20) == "fourstep"


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    from neojax.bench import env

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert env.compile_cache_dir() is None
    assert env.setup_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_default_is_repo_dir(monkeypatch):
    from neojax.bench import env

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert env.compile_cache_dir() == os.path.join(_REPO, ".jax_cache")
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


@pytest.mark.parametrize(
    "kind,peak", [("NVIDIA H100 80GB HBM3", 3.35e12), ("NVIDIA H100 PCIe", 2.0e12)]
)
def test_peak_table_knows_h100(kind, peak):
    from neojax.bench.harness import hbm_peak_bytes_per_sec

    assert hbm_peak_bytes_per_sec(kind) == peak


def test_peak_table_unknown_device_raises():
    from neojax.bench.harness import hbm_peak_bytes_per_sec

    with pytest.raises(ValueError, match="no published memory bandwidth"):
        hbm_peak_bytes_per_sec("NVIDIA A100-SXM4-80GB")


def _run_script(args, cwd, tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
    env.pop("XLA_FLAGS", None)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_entry_point_refuses_cpu(script, tmp_path):
    r = _run_script([os.path.join(_REPO, script)], _REPO, tmp_path)
    assert r.returncode != 0
    assert "needs a GPU" in r.stderr
    assert r.stdout.strip() == "" or '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    alone = tmp_path / "alone"
    alone.mkdir()
    with open(os.path.join(_REPO, "chip_smoke.py")) as f:
        (alone / "chip_smoke.py").write_text(f.read())
    r = _run_script([str(alone / "chip_smoke.py")], str(alone), tmp_path)
    assert r.returncode != 0, (r.stdout, r.stderr)
    assert '"ok"' not in r.stdout
