"""What XLA makes of the engines' hot spots on the GPU, at the headline shapes.

Two probes, both run by default:

  mac        the two partition MACs, each alone and inside its engine:
             - perblock: ``conv.fdl.fdl_mac_split`` over the packed ring
               [2, P=938, C=64, 512] (split / bf16 / int16 / int8), and the
               per-block ``conv.process`` stream around it (us per block);
             - nested: ``conv.nested.meta_mac`` over the meta ring
               [2, P2=8, C=64, K=513, 2S=256] (S=128; bf16 / int8 / int16 /
               split), and ``process_nested`` around it (samples/s).
             For each MAC: the fusions of the optimized HLO (is a dequantized
             f32 copy of the planes written by a fusion of its own?), the
             device kernels of one call from a profiler trace, and the read
             rate against the card's peak (``bench.harness``).
  precision  what lax.Precision DEFAULT / HIGH / HIGHEST give an f32 DFT
             matmul of the block transform's shape: error against float64
             and the time of one call.

Usage:  python tools/xla_probe.py [mac|precision] [--out DIR]
Writes <DIR>/xla_probe.json and the optimized HLO of each MAC
(default DIR: chiprun_out/xla_probe). Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import time
from functools import partial

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from neojax.bench.env import setup_compile_cache  # noqa: E402

C, B, P, S = 64, 512, 938, 128


def _time_calls(fn, args, iters=20):
    """Mean wall seconds of one call, ``iters`` calls in flight, one sync."""
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _fusions(hlo: str) -> list[str]:
    """The kernel-launching instructions of the optimized module's entry."""
    entry = hlo[hlo.index("ENTRY"):]
    body = entry[: entry.index("\n}")]
    keep = []
    for line in body.splitlines():
        line = line.strip()
        if any(t in line for t in (" fusion(", "custom-call(", " reduce(", " convert(")):
            keep.append(line[:220])
    return keep


def _device_kernels(fn, args, calls=3):
    """Device events of ``calls`` calls, summed by name: {name: us per call}
    (the 12 longest, plus "_total"). A trace that cannot be read gives
    {"_error": ...} instead: the timings above it still stand."""
    try:
        return _device_kernels_or_raise(fn, args, calls)
    except Exception as e:  # informational probe: keep the other numbers
        return {"_error": f"{type(e).__name__}: {e}"[:300]}


def _device_kernels_or_raise(fn, args, calls):
    import jax
    from jax.profiler import ProfileData

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as d:
        with jax.profiler.trace(d):
            for _ in range(calls):
                out = fn(*args)
            jax.block_until_ready(out)
        path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
        prof = ProfileData.from_file(path)
    totals: dict[str, float] = {}
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if "XLA" in line.name or "Modules" in line.name:
                continue  # summary lines repeat the stream's events
            for ev in line.events:
                totals[ev.name] = totals.get(ev.name, 0.0) + ev.duration_ns
    out = {k: round(v / calls / 1e3, 2) for k, v in
           sorted(totals.items(), key=lambda kv: -kv[1])[:12]}
    out["_total"] = round(sum(totals.values()) / calls / 1e3, 2)
    return out


def _mac_record(name, fn, args, nbytes, out_dir, peak):
    import jax

    compiled = jax.jit(fn).lower(*args).compile()
    hlo = compiled.as_text()
    with open(os.path.join(out_dir, f"{name.replace('/', '_')}.hlo.txt"), "w") as f:
        f.write(hlo)
    jf = jax.jit(fn)
    dt = _time_calls(jf, args)
    kern = _device_kernels(jf, args)
    rec = {
        "us_per_call": round(dt * 1e6, 1),
        "bytes_per_call": nbytes,
        "read_tbps": round(nbytes / dt / 1e12, 3),
        "share_of_peak": round(nbytes / dt / peak, 3),
        "entry_kernels": _fusions(hlo),
        "device_us_by_kernel": kern,
    }
    if kern.get("_total"):
        rec["device_read_tbps"] = round(nbytes / (kern["_total"] * 1e-6) / 1e12, 3)
    print(f"# {name}: {rec['us_per_call']} us, {rec['read_tbps']} TB/s "
          f"({rec['share_of_peak']} of peak), device {kern.get('_total')} us "
          f"({rec.get('device_read_tbps')} TB/s), entry kernels "
          f"{rec['entry_kernels']}", file=sys.stderr)
    return rec


def probe_mac(out_dir: str) -> dict:
    import jax
    import jax.numpy as jnp

    import bench
    from neojax.bench.harness import hbm_peak_bytes_per_sec
    from neojax.conv import convolver as cv
    from neojax.conv import fdl as fdl_lib
    from neojax.conv import nested
    from neojax.ops.quantize import int_max_for

    peak = hbm_peak_bytes_per_sec()
    key = jax.random.PRNGKey(0)
    res = {"perblock": {}, "nested": {}}

    # ---- perblock: [2, P, C, B] packed ring, shared filter
    fr = jax.random.normal(key, (P, 1, B), jnp.float32)
    fi = jax.random.normal(jax.random.fold_in(key, 1), (P, 1, B), jnp.float32)
    for storage in ("split", "bf16", "int16", "int8"):
        dt = fdl_lib.STORAGE_DTYPES[storage]
        x = jax.random.normal(key, (2, P, C, B), jnp.float32)
        if storage in ("int8", "int16"):
            m = int_max_for(dt)
            planes = jnp.clip(jnp.round(x * m / 4), -m, m).astype(dt)
            scales = jnp.ones((P, C, fdl_lib.quant_groups(storage, B)), jnp.float32)
            fdl = (planes, scales)
            nbytes = planes.nbytes + scales.nbytes
        else:
            fdl = x.astype(dt)
            nbytes = fdl.nbytes
        nbytes += fr.nbytes + fi.nbytes + 2 * C * B * 4
        rec = _mac_record(f"perblock/{storage}/mac", fdl_lib.fdl_mac_split,
                          (fdl, fr, fi), nbytes, out_dir, peak)
        # the engine around it: per-block stream, XLA MAC
        cfg = cv.PartitionedConfig(B, P, C, storage=storage)
        parts = bench._make_parts(P, cfg.num_bins)
        params = cv.filter_params(cfg, parts)
        nb = 512
        sig = bench._signal(nb)
        proc = jax.jit(partial(cv.process, cfg))
        st = cv.init_state(cfg)
        t = _time_calls(lambda: proc(params, st, sig), (), iters=3)
        rec["engine_us_per_block"] = round(t / nb * 1e6, 1)
        rec["engine_kernels_us_per_block"] = {
            k: round(v / nb, 2)
            for k, v in _device_kernels(lambda: proc(params, st, sig), (), 1).items()
        }
        print(f"#   engine: {rec['engine_us_per_block']} us/block", file=sys.stderr)
        res["perblock"][storage] = rec

    # ---- nested: [2, P2, C, K, 2S] meta ring, shared tile-reversed filter
    k = B + 1
    for storage in ("bf16", "int8", "int16", "split"):
        cfg = cv.PartitionedConfig(B, P, C, storage=storage)
        parts = bench._make_parts(P, cfg.num_bins)
        params = nested.nested_filter_params(cfg, parts, S)
        st = nested.nested_init_state(cfg, params)
        p2 = st["fdl"].shape[1]
        dt = st["fdl"].dtype
        x = jax.random.normal(key, (2, p2, C, k, 2 * S), jnp.float32)
        if storage in ("int8", "int16"):
            imax = int_max_for(dt)
            fdl = jnp.clip(jnp.round(x * imax / 4), -imax, imax).astype(dt)
            scales = st["scales"]
        else:
            fdl = x.astype(dt)
            scales = None
        nbytes = fdl.nbytes + (0 if scales is None else scales.nbytes)
        nbytes += params["filt_re"].nbytes + 2 * C * k * 2 * S * 4
        rec = _mac_record(
            f"nested/{storage}/mac", nested.meta_mac,
            (fdl, scales, params["filt_re"], params["filt_im"], jnp.int32(3)),
            nbytes, out_dir, peak,
        )
        nb = 10 * S
        sig = bench._signal(nb)
        proc = jax.jit(partial(nested.process_nested, cfg))
        t = _time_calls(lambda: proc(params, st, sig), (), iters=3)
        rec["engine_samples_per_sec"] = round(C * nb * B / t, 1)
        rec["engine_kernels_us_per_chunk"] = {
            kk: round(v / 10, 1)
            for kk, v in _device_kernels(lambda: proc(params, st, sig), (), 1).items()
        }
        print(f"#   engine: {rec['engine_samples_per_sec'] / 1e6:.1f} M samples/s",
              file=sys.stderr)
        res["nested"][storage] = rec
    return res


def probe_precision() -> dict:
    import jax
    import jax.numpy as jnp
    from jax import lax

    from neojax.fft import matmul_backend

    n = 2 * B
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (S * C, n)).astype(np.float32)
    m = np.asarray(matmul_backend.rfft_cat_matrices(n))
    ref = x.astype(np.float64) @ m.astype(np.float64)
    res = {}
    for name in ("DEFAULT", "HIGH", "HIGHEST"):
        prec = getattr(lax.Precision, name)
        f = jax.jit(partial(matmul_backend._matmul, precision=prec))
        xa, ma = jnp.asarray(x), jnp.asarray(m)
        y = np.asarray(f(xa, ma), np.float64)
        err = y - ref
        snr = 10 * np.log10(np.sum(ref**2) / np.sum(err**2))
        hlo = jax.jit(f).lower(xa, ma).compile().as_text()
        calls = sorted({ln.split("custom_call_target=")[1].split(",")[0]
                        for ln in hlo.splitlines() if "custom_call_target=" in ln})
        algo = sorted({ln.split("algorithm=")[1].split(",")[0].split("}")[0]
                       for ln in hlo.splitlines() if "algorithm=" in ln})
        res[name] = {
            "snr_db_vs_f64": round(float(snr), 2),
            "max_rel_err": float(np.max(np.abs(err)) / np.max(np.abs(ref))),
            "us_per_call": round(_time_calls(f, (xa, ma)) * 1e6, 1),
            "custom_calls": calls,
            "algorithms": algo,
        }
        print(f"# precision {name}: {res[name]}", file=sys.stderr)
    return res


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("probe", nargs="?", choices=["mac", "precision"])
    ap.add_argument("--out", default="chiprun_out/xla_probe")
    args = ap.parse_args()
    setup_compile_cache()
    import jax

    if jax.default_backend() != "gpu":
        print("xla_probe needs a GPU", file=sys.stderr)
        return 1
    os.makedirs(args.out, exist_ok=True)
    from neojax.bench.env import gpu_info

    res = {"gpu": gpu_info(), "device_kind": jax.devices()[0].device_kind}
    if args.probe in (None, "precision"):
        res["precision"] = probe_precision()
    if args.probe in (None, "mac"):
        res["mac"] = probe_mac(args.out)
    with open(os.path.join(args.out, "xla_probe.json"), "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "mac"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
