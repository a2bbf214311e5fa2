"""Headline benchmark: 64-channel, 10 s shared-IR partitioned convolution,
streaming block 512 @ 48 kHz (BASELINE.json config #3), on one GPU.

Prints ONE JSON line to stdout:
  metric: samples/s per card (output samples x channels per wall second)
  vs_baseline: real-time factor for the whole 64-channel stream
     (value / (64 ch * 48000 Hz)); the reference publishes no absolute
     numbers (BASELINE.md), so its own CLI headline metric — real-time
     factor, ``extra/cli/src/convolver.cpp:108-113`` — is the baseline axis.
  gpu: the card's name and power limit (nvidia-smi).

Engines benchmarked (``ROWS``; details to stderr):
  - nested:   two-level FDL mode (S=128 blocks/step; meta-FFT along the
    frame axis, elementwise partition MAC) — the throughput path.
    Each storage rung's SNR vs the f64 UPOLS oracle is measured per run
    and reported in the JSON (``snr_db_vs_f64``).
  - chunked:  Toeplitz-GEMM multi-block mode (same math, batched matmul)
  - hybrid:   two-stage (Gardner-style) scheduling — per-block head over the
    first S partitions + nested tail once per chunk: TRUE single-block
    (512-sample) latency at near-throughput speed (the real-time path)
  - perblock: uniform single-block streaming step (real-time baseline)

Throughput engines stream ~150 s of audio so the metric reflects steady
state (the 10 s IR / block 512 / 64 ch *config* is unchanged; only the
stream is longer). Needs a GPU: with none, exits non-zero.
"""

from __future__ import annotations

import json
import sys
import time
from functools import partial

import numpy as np


def _setup_jax():
    import jax

    from neojax.bench.env import setup_compile_cache

    setup_compile_cache()
    # _signal's length-invariant prefix (the shared SNR oracle depends on
    # it) holds only under partitionable threefry; pin it explicitly so a
    # config/env drift can't silently garbage the per-engine SNRs.
    jax.config.update("jax_threefry_partitionable", True)
    return jax


SR = 48000
BLOCK = 512
CHANNELS = 64
P_REAL = int(np.ceil(10.0 * SR / BLOCK))  # 938 partitions (10 s IR)


def _make_ir(p=None, block=None):
    """Time-domain bench IR: 10 s of exponentially decaying noise (the
    shape of a real reverb tail, like the WAV IRs the reference CLI
    convolves, ``extra/cli/src/convolver.cpp:60-148``)."""
    p = P_REAL if p is None else p
    block = BLOCK if block is None else block
    rng = np.random.default_rng(0)
    n = p * block
    t = np.arange(n)
    return rng.standard_normal(n) * (0.05 * np.exp(-t / (n / 4)))


def _make_parts(p, bins):
    """Partitioned spectra of the bench IR (``uniform_partition`` semantics:
    rfft of each B-sample segment zero-padded to 2B,
    ``uniform_partition.hpp:13-26``). Deriving the spectra from a real
    time-domain IR (rather than sampling random spectra) makes the exact
    convolution a plain f64 FFT convolution — so the SNR oracle can be
    evaluated at ANY stream offset, in particular in steady state."""
    b = bins - 1
    ir = _make_ir(p, b).reshape(p, b)
    seg = np.concatenate([ir, np.zeros_like(ir)], axis=-1)
    return np.fft.rfft(seg, axis=-1)[None].astype(np.complex64)


def _signal(num_blocks):
    """Test signal, generated ON DEVICE (no multi-GB host->device copy of
    the steady-state stream).

    One fold_in key PER CHANNEL: threefry counts elements positionally, so
    the [c, :t] head is identical for every stream length — engines stream
    different nb (steady-state length varies by engine) but the SNR oracle
    sees the same 16-block prefix.
    """
    import jax
    import jax.numpy as jnp

    @partial(jax.jit, static_argnums=0)
    def gen(t):
        keys = jax.vmap(
            lambda c: jax.random.fold_in(jax.random.PRNGKey(1), c)
        )(jnp.arange(CHANNELS))
        return jax.vmap(
            lambda k: jax.random.uniform(k, (t,), jnp.float32, -1, 1)
        )(keys)

    return gen(num_blocks * BLOCK)


# SNR check: _SNR_BLOCKS blocks x _SNR_CH channels of every engine's
# output vs one shared exact-f64 oracle, measured in STEADY STATE — the
# window starts at block _SNR_START, past the 938-block IR depth, so the
# delay line is fully populated. A cold-start window
# systematically under-reads quantized storages: output blocks < P hold
# only the partial signal energy of the partitions streamed so far, while
# the inverse meta-FFT spreads each quantized row's noise white across
# ALL frames — the first 16 blocks see < 20% of the signal energy against
# the full row noise. The reference's own tolerance checks run warmed
# convolvers (streams past the filter length,
# ``uniform_partitioned_convolver_test.cpp:59-88``), so steady state is
# the honest class measurement.
_SNR_START = 1152  # blocks; > P_REAL and a multiple of every chunk size
_SNR_BLOCKS = 16
_SNR_CH = 4


def snr_window(out):
    """The steady-state SNR window of an engine's [C, T] output, as f64."""
    assert out.shape[-1] >= (_SNR_START + _SNR_BLOCKS) * BLOCK, (
        "stream too short for the steady-state SNR window"
    )
    return np.asarray(
        out[:_SNR_CH, _SNR_START * BLOCK : (_SNR_START + _SNR_BLOCKS) * BLOCK],
        np.float64,
    )


def _time(proc, params, state, sig, repeats=2):
    import jax.numpy as jnp

    st, out = proc(params, state, sig)
    head = snr_window(out)
    float(jnp.sum(jnp.abs(out)))  # host fetch = sync
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        st, out = proc(params, st, sig)
        float(jnp.sum(jnp.abs(out)))
        times.append(time.perf_counter() - t0)
    return min(times), head


def _oracle_head():
    """Exact f64 linear convolution of the bench signal with the bench IR
    (one FFT multiply — the parts are uniform_partition spectra of a real
    time-domain IR, so the partitioned engines compute exactly this),
    sliced to the steady-state SNR window."""
    ir = _make_ir()
    sig = np.asarray(_signal(_SNR_START + _SNR_BLOCKS)[:_SNR_CH], np.float64)
    t_len = sig.shape[1]
    nfft = 1 << int(np.ceil(np.log2(t_len + ir.size)))
    out = np.fft.irfft(
        np.fft.rfft(sig, nfft) * np.fft.rfft(ir, nfft)[None], nfft
    )[:, :t_len]
    return out[:, _SNR_START * BLOCK :]


def _snr_db(head, oracle):
    err = head - oracle
    num = float(np.sum(oracle**2))
    den = float(np.sum(err**2))
    if den == 0:
        return float("inf")
    return 10.0 * np.log10(num / den)


def bench_chunked(storage="bf16", s=32, mult=16):
    jax = _setup_jax()

    from neojax.conv import chunked
    from neojax.conv import convolver as cv

    cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
    parts = _make_parts(P_REAL, cfg.num_bins)
    params = chunked.chunked_filter_params(cfg, parts, s)
    state = chunked.chunked_init_state(cfg, params)
    nb = (P_REAL - (P_REAL % s)) * mult  # ~150 s of audio (steady state)
    sig = _signal(nb)
    proc = jax.jit(
        partial(chunked.process_chunked, cfg, chunk_blocks=s), donate_argnums=(1,)
    )
    dt, head = _time(proc, params, state, sig)
    return CHANNELS * nb * BLOCK / dt, dt, nb, head, None


def bench_nested(storage="bf16", s=128, mult=16):
    jax = _setup_jax()

    from neojax.conv import nested
    from neojax.conv import convolver as cv

    cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
    parts = _make_parts(P_REAL, cfg.num_bins)
    params = nested.nested_filter_params(cfg, parts, s)
    state = nested.nested_init_state(cfg, params)
    nb = (P_REAL - (P_REAL % s)) * mult
    sig = _signal(nb)
    proc = jax.jit(partial(nested.process_nested, cfg), donate_argnums=(1,))
    dt, head = _time(proc, params, state, sig)
    return CHANNELS * nb * BLOCK / dt, dt, nb, head, None


def bench_hybrid(storage="bf16", s=64, mult=4):
    jax = _setup_jax()

    from neojax.conv import hybrid
    from neojax.conv import convolver as cv

    cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
    parts = _make_parts(P_REAL, cfg.num_bins)
    params = hybrid.hybrid_filter_params(cfg, parts, s)
    state = hybrid.hybrid_init_state(cfg, params)
    nb = (P_REAL - (P_REAL % s)) * mult
    sig = _signal(nb)
    proc = jax.jit(partial(hybrid.process_hybrid, cfg), donate_argnums=(1,))
    dt, head = _time(proc, params, state, sig)
    return CHANNELS * nb * BLOCK / dt, dt, nb, head, None


def _perblock_bytes(cfg):
    """Device-memory bytes touched per block by the uniform per-block step:
    the full FDL read + one row write, rotated filter planes, DFT matrices,
    block IO, and the quantized storages' scale table."""
    lanes = cfg.block_size if cfg.use_packed else cfg.num_bins
    itemsize = {"dense": 8, "split": 4, "bf16": 2, "int16": 2, "int8": 1}[cfg.storage]
    p = cfg.num_partitions
    n = cfg.transform_size
    fdl = 2 * p * cfg.channels * lanes * itemsize
    filt = 2 * p * lanes * 4
    mats = (2 * n * lanes + 2 * lanes * n) * 4
    io = 2 * cfg.channels * cfg.block_size * 4
    scl = 0
    if cfg.storage in ("int8", "int16"):  # f32 scales: read + one row write
        from neojax.conv.fdl import quant_groups

        scl = (p + 1) * cfg.channels * quant_groups(cfg.storage, lanes) * 4
    return fdl + filt + mats + io + scl


def bench_perblock(storage):
    jax = _setup_jax()

    from neojax.conv import convolver as cv

    cfg = cv.PartitionedConfig(BLOCK, P_REAL, CHANNELS, storage=storage)
    params = cv.filter_params(cfg, _make_parts(P_REAL, cfg.num_bins))
    state = cv.init_state(cfg)
    nb = 8192  # ~87 s of audio
    sig = _signal(nb)
    proc = jax.jit(partial(cv.process, cfg), donate_argnums=(1,))
    dt, head = _time(proc, params, state, sig)
    return CHANNELS * nb * BLOCK / dt, dt, nb, head, _perblock_bytes(cfg)


# Every engine x storage row: name -> (engine, storage, chunk_blocks).
# chip_smoke.py and the GPU test suite run the same rows through
# ``conv.make_engine``.
ROWS = {
    "nested/int8/S128": ("nested", "int8", 128),
    "nested/bf16/S128": ("nested", "bf16", 128),
    "nested/int16/S128": ("nested", "int16", 128),
    "nested/split/S128": ("nested", "split", 128),
    "chunked/bf16/S128": ("chunked", "bf16", 128),
    "hybrid/bf16/S64": ("hybrid", "bf16", 64),
    "hybrid/int8/S64": ("hybrid", "int8", 64),
    "hybrid/split/S64": ("hybrid", "split", 64),
    "hybrid/int16/S64": ("hybrid", "int16", 64),
    "perblock/split": ("perblock", "split", None),
    "perblock/bf16": ("perblock", "bf16", None),
    "perblock/int8": ("perblock", "int8", None),
}


def make_row_engine(name):
    """The ``conv.make_engine`` handle of one ``ROWS`` row at the bench
    configuration (shared IR, ``CHANNELS`` channels)."""
    from neojax import conv

    engine, storage, s = ROWS[name]
    return conv.make_engine(
        engine, _make_parts(P_REAL, BLOCK + 1), storage=storage,
        chunk_blocks=s, channels=CHANNELS,
    )


def row_stream_blocks() -> int:
    """Blocks that take every row past the steady-state SNR window, in whole
    chunks of every row's engine."""
    chunk = max(s or 1 for _, _, s in ROWS.values())
    return -(-(_SNR_START + _SNR_BLOCKS) // chunk) * chunk


def bench_row(name):
    engine, storage, s = ROWS[name]
    if engine == "perblock":
        return bench_perblock(storage)
    fn = {"nested": bench_nested, "chunked": bench_chunked, "hybrid": bench_hybrid}
    return fn[engine](storage, s)


# Headline eligibility: an engine must meet the SNR class of its storage
# (vs the shared f64 UPOLS oracle) — the reference's own tolerance ladder
# translated to energy SNR on unit-range noise:
#   f32 split/dense: 1e-5 abs  (allclose.hpp:36-37)        -> >= 90 dB
#   int16 FDL:       1e-4 abs  (compressed_fdl_test.cpp)   -> >= 74 dB
#   int8 FDL:        5e-3 abs  (compressed_fdl_test.cpp)   -> >= 46 dB
#   bf16:            no reference analogue; class = its 8-bit-mantissa
#                    storage floor (eps/2 = 3.9e-3, int8-adjacent) -> >= 40 dB
# A faster row that misses its class is still reported — it just can't be
# the headline.
_SNR_CLASS_DB = {"split": 90.0, "dense": 90.0, "int16": 74.0,
                 "int8": 46.0, "bf16": 40.0}


def main():
    jax = _setup_jax()
    if jax.default_backend() != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    from neojax.bench.env import gpu_info
    from neojax.bench.harness import hbm_peak_bytes_per_sec

    gpu = gpu_info()
    print(f"# device: {jax.devices()[0]} ({gpu})", file=sys.stderr)
    peak = hbm_peak_bytes_per_sec()
    oracle = _oracle_head()

    engines = {}
    failed = {}

    def record(name):
        storage = ROWS[name][1]
        try:
            sps, dt, nb, head, bpb = bench_row(name)
        except Exception as e:
            # A broken engine is VISIBLE in the artifact, not a silently
            # missing key: record the failure in the JSON.
            failed[name] = f"{type(e).__name__}: {e}"[:300]
            print(f"# {name} FAILED: {type(e).__name__}: {e}", file=sys.stderr)
            return
        snr = _snr_db(head, oracle)
        row = {
            "samples_per_sec": round(sps, 1),
            "us_per_block": round(dt / nb * 1e6, 1),
            "snr_db_vs_f64": round(snr, 1),
            "meets_snr_class": bool(snr >= _SNR_CLASS_DB[storage]),
        }
        msg = (f"# {name}: {sps/1e6:.1f} M samples/s "
               f"({dt/nb*1e6:.1f} us/block over {nb} blocks) snr {snr:.1f} dB")
        if bpb:
            roof = bpb * nb / dt / peak
            row["roofline_fraction"] = round(roof, 3)
            row["effective_gbps"] = round(bpb * nb / dt / 1e9, 1)
            msg += f" roofline {roof:.2f}"
        engines[name] = row
        print(msg, file=sys.stderr)

    for name in ROWS:
        record(name)

    if not engines:
        print(json.dumps({"metric": "error", "value": 0, "unit": "samples/s",
                          "vs_baseline": 0, "gpu": gpu, "failed": failed}))
        return 1

    # Headline = fastest engine MEETING its storage's SNR class; falls back
    # to the fastest row (flagged) if nothing qualifies.
    qual = [k for k in engines if engines[k]["meets_snr_class"]]
    in_class = bool(qual)
    best_key = max(qual or list(engines), key=lambda k: engines[k]["samples_per_sec"])
    best = engines[best_key]["samples_per_sec"]
    print(f"# best (snr-class qualified: {in_class}): {best_key}", file=sys.stderr)

    out = {
        "metric": "partitioned_conv_64ch_10s_ir_block512_samples_per_sec_per_card",
        "value": round(best, 1),
        "unit": "samples/s",
        "vs_baseline": round(best / (CHANNELS * SR), 3),
        "best_engine": best_key,
        "best_meets_snr_class": in_class,
        "gpu": gpu,
        "platform": jax.devices()[0].platform,
        "device_kind": jax.devices()[0].device_kind,
        "device_count": len(jax.devices()),
        "engines": engines,
    }
    if failed:
        out["failed"] = failed
    print(json.dumps(out))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
