"""GPU smoke run: neojax's main path at full width, on the card.

    python chip_smoke.py          one GPU: phases 1-4 below
    python chip_smoke.py --four   four GPUs: the sharded paths only

1. engines   ``conv.make_engine`` for perblock / hybrid / nested / chunked
             over every storage ``bench.py`` runs (``bench.ROWS``), at 64
             channels, a 10 s IR (938 partitions), block 512, 48 kHz. Each
             row streams 1280 blocks, so bench.py's steady-state window
             (blocks 1152-1168) exists, and its SNR against the f64 oracle
             (``bench._oracle_head``) must meet its storage's class
             (``bench._SNR_CLASS_DB``).
2. realtime  a stereo ``conv.hybrid.HybridStream`` (10 s IR, block 512,
             S=64, split) answers 4*S callbacks and must match the offline
             ``process_hybrid`` within 1e-4; callback p50/p99 against the
             10.67 ms deadline are printed for information. Then the same
             stream through ``io.StreamExecutor`` over the native rings
             (``make -C native``).
3. cli       ``neojax.cli`` (the ``python -m neojax.cli`` entry, run in this
             process) convolves a generated stereo WAV with a generated
             10 s IR WAV; the output must meet the split class against
             numpy's convolve.
4. tests     the GPU-marked tests (``pytest -m gpu``), in this process.

--four: 256 channels, channel-sharded over four cards
(``dist.sharded_process_nested``, ``dist.sharded_process``), and
``dist.PipelineConvolver`` over ``make_mesh(part=4)`` (psum + ppermute),
each against the same engine on one card.

One process drives the card(s). Any failure exits non-zero and prints no
result; the last stdout line is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from functools import partial

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CALLBACK_BLOCKS_PER_CHUNK = 4  # HybridStream callbacks per tail period S


def log(msg: str) -> None:
    print(msg, flush=True)


def _snr_db(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    den = float(np.sum((got - ref) ** 2))
    return float("inf") if den == 0 else 10 * np.log10(np.sum(ref**2) / den)


# ------------------------------------------------------------------ phases


def phase_engines(rows, card: str = "") -> dict:
    """Every ``bench.ROWS`` row through ``conv.make_engine`` at bench.py's
    configuration; each must meet its storage's SNR class."""
    import jax

    import bench

    nb = bench.row_stream_blocks()
    oracle = bench._oracle_head()
    sig = bench._signal(nb)
    res = {}
    for name in rows:
        storage = bench.ROWS[name][1]
        t0 = time.perf_counter()
        eng = bench.make_row_engine(name)
        head = bench.snr_window(eng.process(sig))
        first = time.perf_counter() - t0
        eng.reset()
        t0 = time.perf_counter()
        jax.block_until_ready(eng.process(sig))
        wall = time.perf_counter() - t0
        snr = _snr_db(head, oracle)
        cls = bench._SNR_CLASS_DB[storage]
        res[name] = {"snr_db": snr, "class_db": cls, "first_call_s": first,
                     "stream_s": wall}
        log(f"engines {name}: snr {snr:.2f} dB (class {cls:.0f}), first call "
            f"{first:.2f} s, {nb} blocks in {wall:.4f} s "
            f"({bench.CHANNELS * nb * bench.BLOCK / wall / 1e6:.1f} M samples/s) "
            f"on {card}")
        if not snr >= cls:
            raise AssertionError(f"{name}: SNR {snr:.2f} dB below its {cls} dB class")
    return res


def _decaying_ir(p: int, block: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = p * block
    return (rng.standard_normal(n) * 0.05 * np.exp(-np.arange(n) / (n / 4))).astype(
        np.float32
    )


def phase_realtime(channels=2, ir_seconds=10.0, block=512, sr=48000, s=64,
                   native_dir=os.path.join(HERE, "native")) -> dict:
    """Per-block real-time path: HybridStream callbacks, then the same
    stream behind the native-ring executor; both vs the offline engine."""
    import jax
    import jax.numpy as jnp

    from neojax import conv
    from neojax.conv import hybrid
    from neojax.io import StreamExecutor
    from neojax.io.native import load_runtime

    p = int(np.ceil(ir_seconds * sr / block))
    parts = conv.uniform_partition(_decaying_ir(p, block)[None], block)
    cfg = conv.PartitionedConfig(block, p, channels, storage="split")
    params = hybrid.hybrid_filter_params(cfg, parts, s)
    nb = CALLBACK_BLOCKS_PER_CHUNK * s
    sig = np.random.default_rng(1).uniform(-1, 1, (channels, nb * block)).astype(
        np.float32
    )
    _, ref = jax.jit(partial(hybrid.process_hybrid, cfg))(
        params, hybrid.hybrid_init_state(cfg, params), jnp.asarray(sig)
    )
    ref = np.asarray(ref)

    stream = hybrid.HybridStream(cfg, params)
    for i in range(s):  # compile the block step and the tail refresh
        np.asarray(stream(sig[:, i * block : (i + 1) * block]))
    stream.reset()
    lat = np.zeros(nb)
    outs = []
    for i in range(nb):
        t0 = time.perf_counter()
        outs.append(np.asarray(stream(sig[:, i * block : (i + 1) * block])))
        lat[i] = time.perf_counter() - t0
    err = float(np.max(np.abs(np.concatenate(outs, axis=-1) - ref)))
    deadline_ms = 1e3 * block / sr
    p50, p99 = (float(np.quantile(lat, q) * 1e3) for q in (0.5, 0.99))
    log(f"realtime HybridStream: {nb} callbacks, max err vs offline {err:.3g}, "
        f"p50 {p50:.3f} ms, p99 {p99:.3f} ms, max {lat.max() * 1e3:.3f} ms "
        f"(deadline {deadline_ms:.2f} ms, information only)")
    if not err < 1e-4:
        raise AssertionError(f"HybridStream differs from process_hybrid by {err}")

    subprocess.run(["make", "-C", native_dir], check=True, capture_output=True)
    if load_runtime() is None:
        raise RuntimeError("native runtime did not load after make -C native")
    stream2 = hybrid.HybridStream(cfg, params)
    got = []
    t0 = time.perf_counter()
    with StreamExecutor(lambda st, blk: (st, stream2(blk)), None, channels, block,
                        capacity_blocks=128) as ex:
        sent = 0
        while sum(x.shape[1] for x in got) < nb * block:
            if time.perf_counter() - t0 > 300:
                raise TimeoutError("executor stalled")
            if sent < sig.shape[1]:
                sent += ex.push(sig[:, sent : sent + 4391])  # odd producer chunks
            chunk = ex.pull(8 * block)
            if chunk.shape[1]:
                got.append(chunk)
            else:
                time.sleep(0.001)
    wall = time.perf_counter() - t0
    ex_err = float(np.max(np.abs(np.concatenate(got, axis=-1)[:, : nb * block] - ref)))
    log(f"realtime StreamExecutor: {nb} blocks in {wall:.3f} s, max err vs "
        f"offline {ex_err:.3g}")
    if not ex_err < 1e-4:
        raise AssertionError(f"executor output differs from offline by {ex_err}")
    return {"max_err": err, "p50_ms": p50, "p99_ms": p99, "executor_err": ex_err}


def phase_cli(workdir: str, seconds=10.0, ir_seconds=10.0, sr=48000,
              extra=()) -> dict:
    """``neojax.cli`` on generated WAVs vs numpy's convolve (f32 WAV out)."""
    from neojax import cli
    from neojax.io.wav import read_wav, write_wav

    rng = np.random.default_rng(2)
    sig = rng.uniform(-0.5, 0.5, (2, int(seconds * sr))).astype(np.float32)
    ir = _decaying_ir(1, int(ir_seconds * sr), seed=3)
    paths = [os.path.join(workdir, f) for f in ("sig.wav", "ir.wav", "out.wav")]
    write_wav(paths[0], sig, sr, bits=32)
    write_wav(paths[1], ir[None], sr, bits=32)
    t0 = time.perf_counter()
    rc = cli.main([*paths, "--bits", "32", *extra])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"neojax.cli exited {rc}")
    out, _ = read_wav(paths[2])
    irn = ir.astype(np.float64) / np.sqrt(np.sum(ir.astype(np.float64) ** 2))
    ref = np.stack([np.convolve(x, irn)[: sig.shape[1]] for x in sig.astype(np.float64)])
    peak = np.max(np.abs(ref))
    if peak > 1.0:  # the CLI normalizes a clipping output to peak 1
        ref = ref / peak
    snr = _snr_db(out, ref)
    log(f"cli: {sig.shape[1] / sr:.1f} s stereo x {ir_seconds:.1f} s IR in "
        f"{wall:.2f} s, snr {snr:.2f} dB vs numpy convolve (class 90)")
    if not snr >= 90.0:
        raise AssertionError(f"CLI output SNR {snr:.2f} dB below 90 dB")
    return {"snr_db": snr, "wall_s": wall}


def phase_tests() -> None:
    """The GPU-marked tests, in this process (one process per card)."""
    import pytest

    os.environ["NEOJAX_GPU_TESTS"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(HERE, "tests")])
    log(f"tests: pytest -m gpu exited {int(rc)}")
    if rc != 0:
        raise AssertionError(f"GPU tests failed (pytest exit {int(rc)})")


def phase_four(devices, channels=256, p=938, block=512, nb=1280, s=128,
               pipe_channels=64) -> dict:
    """The paths that exist only across cards, each against one card."""
    import jax
    import jax.numpy as jnp

    from neojax import conv, dist
    from neojax.conv import nested

    ir = _decaying_ir(p, block)[None]
    parts = np.asarray(conv.uniform_partition(ir, block))
    sig = jax.random.uniform(jax.random.PRNGKey(4), (channels, nb * block),
                             jnp.float32, -1, 1)
    mesh = dist.make_mesh(ch=len(devices), devices=devices)
    res = {}

    def check(name, got, ref, t):
        snr = _snr_db(got, ref)
        res[name] = {"snr_db_vs_one_card": snr, "sharded_s": t}
        log(f"four {name}: snr {snr:.2f} dB vs one card, sharded call {t:.3f} s")
        if not snr >= 90.0:
            raise AssertionError(f"{name}: sharded vs one card {snr:.2f} dB")

    cfg = conv.PartitionedConfig(block, p, channels, storage="split")
    nparams = nested.nested_filter_params(cfg, parts, s)
    _, ref = jax.jit(partial(nested.process_nested, cfg))(
        nparams, nested.nested_init_state(cfg, nparams), sig)
    t0 = time.perf_counter()
    _, out = dist.sharded_process_nested(
        cfg, nparams, nested.nested_init_state(cfg, nparams), sig, mesh)
    jax.block_until_ready(out)
    check("sharded_process_nested", out, ref, time.perf_counter() - t0)

    params = conv.filter_params(cfg, parts)
    _, ref = jax.jit(partial(conv.process, cfg))(params, conv.init_state(cfg), sig)
    t0 = time.perf_counter()
    _, out = dist.sharded_process(cfg, params, conv.init_state(cfg), sig, mesh)
    jax.block_until_ready(out)
    check("sharded_process", out, ref, time.perf_counter() - t0)

    d = len(devices)
    pp = -(-p // d) * d  # partitions divisible by the part axis (zero pad)
    pparts = np.concatenate(
        [parts, np.zeros((1, pp - p, block + 1), parts.dtype)], axis=1)
    pcfg = conv.PartitionedConfig(block, pp, pipe_channels, storage="split",
                                  layout="shift")
    psig = sig[:pipe_channels]
    _, ref = jax.jit(partial(conv.process, pcfg))(
        conv.filter_params(pcfg, pparts), conv.init_state(pcfg), psig)
    pipe = dist.PipelineConvolver(pcfg, dist.make_mesh(part=d, devices=devices))
    filt = pipe.shard_filter(np.moveaxis(pparts, 0, 1))
    t0 = time.perf_counter()
    _, out = pipe.process(filt, pipe.init_state(), psig)
    jax.block_until_ready(out)
    check("PipelineConvolver", out, ref, time.perf_counter() - t0)
    return res


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded paths")
    args = ap.parse_args(argv)

    sys.path.insert(0, HERE)
    try:
        import bench
        from neojax.bench.env import gpu_info
    except ImportError as e:
        print(f"chip_smoke: the neojax checkout is missing ({e})", file=sys.stderr)
        return 1
    jax = bench._setup_jax()  # also sets the compile cache
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {jax.default_backend()!r}",
              file=sys.stderr)
        return 1
    card = gpu_info()
    log(f"gpu: {card}")
    log(f"jax {jax.__version__}, devices: {jax.devices()}")

    t0 = time.perf_counter()
    if args.four:
        if len(jax.devices()) < 4:
            print(f"chip_smoke --four: needs 4 GPUs, found {len(jax.devices())}",
                  file=sys.stderr)
            return 1
        devices = jax.devices()[:4]
        phase_four(devices)
    else:
        devices = jax.devices()[:1]
        phase_engines(list(bench.ROWS), card)
        phase_realtime()
        with tempfile.TemporaryDirectory() as d:
            phase_cli(d)
        phase_tests()
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    log(card)  # nvidia-smi's name and power limit, as it prints them
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
