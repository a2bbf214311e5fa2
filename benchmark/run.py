#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

In order: JAX's persistent compile cache at a fixed path in the checkout;
a GPU whose ``device_kind`` has published peaks (``peaks.py``), else exit 1
with no result; the cell's impulse responses and input from ``--seed``;
the cell's own warm-up (set-up ends there); the measured window; the check
against the float64 reference; the result.

Everything a cell is made of is found by name: its configuration file
(``configs``), its traffic file ``benchmark/traffic/<traffic>.json`` read by
the one generator (``generator.py``), and one reader per metric,
``benchmark/metrics/<metric>.py`` with ``read(trace, record)``.

Diagnostics go to standard error. Its last lines, and the last key of the
result, are the numbers compared with their limits. The last line of
standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device`` (and ``breakdown`` when traced).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import generator, monitor, peaks, reference, system  # noqa: E402
from benchmark import trace as trace_lib  # noqa: E402

CHECK_SAMPLES = 4096  # samples per compared segment of a long call


class NoChip(RuntimeError):
    """JAX found no accelerator, too few, or one without published peaks."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


# ---------------------------------------------------------------- the cell


def load_cell(root: str, workload: str) -> dict:
    """The cell's entry, configuration, traffic and metric lists, found by
    the names in ``<root>/BENCHMARK.json``."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        spec = json.load(f)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        cfg = json.load(f)
    bench_dir = os.path.join(root, "benchmark")
    with open(os.path.join(bench_dir, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)

    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    per_layer = [m for m in spec["per_layer"] if workload in m["workloads"]]
    return {"cell": cell, "config": cfg, "traffic": traffic, "end_to_end": e2e,
            "per_layer": per_layer, "bench_dir": bench_dir}


def load_reader(bench_dir: str, name: str):
    """``read(trace, record)`` of ``<bench_dir>/metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + re.sub(r"\W", "_", name), path
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------------ set-up


def setup_jax(root: str):
    """JAX with its persistent compile cache at ``<root>/.jax_cache``, or
    where ``JAX_COMPILATION_CACHE_DIR`` says (then JAX reads it itself). A
    fixed path: it is part of the cache's key. Every program is cached, so
    only a checkout's first run compiles."""
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return jax


def require_chips(jax, chips: int):
    """The cell's devices; raises ``NoChip`` unless JAX found that many GPUs
    of a kind with published peaks."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise NoChip(f"JAX found no GPU (platform {devs[0].platform!r})")
    if len(devs) < chips:
        raise NoChip(f"the cell needs {chips} GPUs, JAX found {len(devs)}")
    try:
        peaks.peaks_for(devs[0].device_kind)
    except ValueError as e:
        raise NoChip(str(e)) from None
    return devs[:chips]


class CompileCounter:
    """Counts JAX's compile events (tracing, lowering, backend compile and
    cache retrieval) while ``on``."""

    def __init__(self, jax):
        self.on = False
        self.count = 0
        jax.monitoring.register_event_duration_secs_listener(self._event)

    def _event(self, name, _secs, **_kw):
        if self.on and ("/compile" in name or "compilation_cache" in name):
            self.count += 1


# ------------------------------------------------------------------- check


def check(win, inputs, irs, cfg, rng) -> reference.Comparison:
    """Compare what the window's calls produced with the reference.

    The calls compared are those the window kept: every call of an open
    loop; of a closed loop, those drawn from the seed and the last. A call
    of at most three segments of CHECK_SAMPLES is compared whole, on every
    channel. A longer call is compared on one channel drawn from each
    quarter of the channels, in three segments: its first (whose history
    lies in the previous call, so the state carried between calls is
    checked), one drawn from the seed that starts past the IR's length
    inside the call where the call is that long, and its last."""
    comp = reference.Comparison(cfg["snr_class_db"])
    comp.add_missing(sum(1 for rec in win.calls if not rec.ok))
    kept = sorted(win.kept)
    c, n = cfg["channels"], inputs.length
    if n <= 3 * CHECK_SAMPLES:
        runs = [[j] for j in kept[:1]]
        for j in kept[1:]:  # consecutive calls share one reference
            if j == runs[-1][-1] + 1:
                runs[-1].append(j)
            else:
                runs.append([j])
        for run in runs:
            lo, hi = run[0] * n, (run[-1] + 1) * n
            for ch in range(c):
                ref = reference.stream_output(inputs, irs[ch % irs.shape[0]], ch, lo, hi)
                for j in run:
                    comp.add(np.asarray(win.kept[j][ch]), ref[j * n - lo : (j + 1) * n - lo])
        return comp
    quarters = np.array_split(np.arange(c), min(4, c))
    chans = [int(rng.choice(q)) for q in quarters]
    seg = CHECK_SAMPLES
    mid_lo = min(irs.shape[1], n - seg)
    for j in kept:
        out = win.kept[j]
        starts = [0, int(rng.integers(mid_lo, n - seg + 1)), n - seg]
        for ch in chans:
            h = irs[ch % irs.shape[0]]
            for a in starts:
                got = np.asarray(out[ch, a : a + seg])
                comp.add(got, reference.stream_output(inputs, h, ch, j * n + a,
                                                      j * n + a + seg))
    return comp


# --------------------------------------------------------------------- run


def run_cell(root: str, workload: str, seed: int, seconds: float, traced: bool,
             require_gpu: bool = True, fault=None, overrides=None,
             traffic_overrides=None) -> dict:
    """One run of one cell; returns the result object. ``fault(system)``
    breaks the timed path (tests of the check); ``overrides`` and
    ``traffic_overrides`` replace keys of the configuration and traffic
    (tests at a size a CPU holds)."""
    spec = load_cell(root, workload)
    cfg = dict(spec["config"], **(overrides or {}))
    traffic = dict(spec["traffic"], **(traffic_overrides or {}))
    chips = spec["cell"]["chips"]
    jax = setup_jax(root)
    if require_gpu:
        devices = require_chips(jax, chips)
    else:
        devices = jax.devices()[:chips]
    kind = devices[0].device_kind
    card = monitor.card() if require_gpu else f"{kind} (no card check)"
    log(f"card: {card}; JAX {jax.__version__} {devices[0].platform} x{len(devices)}")

    seed_seq = seed % 2**64
    rng = np.random.default_rng(seed_seq)
    check_rng = np.random.default_rng([seed_seq, 1])
    irs = system.make_irs(cfg, rng)
    sut = system.System(cfg, irs)
    if fault is not None:
        fault(sut)
    n_open = None
    if traffic["loop"] == "open":
        n_open = generator.open_calls(cfg, traffic, seconds)
    inputs = system.Inputs(cfg, traffic, rng, calls=None if n_open is None
                           else traffic["warmup_calls"] + n_open)
    first = generator.warm_up(sut, inputs, traffic)

    probe = None
    if traced and devices[0].platform == "gpu":
        probe = _compile_copy_probe(jax)
    counter = CompileCounter(jax)
    log_dir = tempfile.mkdtemp(prefix="bench-trace-") if traced else None
    span = jax.profiler.TraceAnnotation if traced else generator.no_span

    gc.collect()
    gc.disable()
    try:
        setup_s = time.perf_counter() - T_START
        if traced:
            jax.profiler.start_trace(log_dir, profiler_options=trace_lib.profile_options())
        counter.on = True
        with monitor.Sampler() as sampler, span("bench.window"):
            win = generator.run_window(sut, inputs, traffic, seconds, first, check_rng,
                                       span=span, calls=n_open)
        counter.on = False
        memory_peak = max((d.memory_stats() or {}).get("peak_bytes_in_use", 0)
                          for d in devices)
        if probe is not None:
            with span("bench.copy_probe"):
                _run_copy_probe(jax, probe)
        if traced:
            jax.profiler.stop_trace()
    finally:
        gc.enable()

    log(f"setup_s {setup_s:.3f}; window {win.seconds:.3f} s, {len(win.calls)} calls, "
        f"{win.failed} failed; compilations in the window: {counter.count}")
    log(f"peak device memory {memory_peak} bytes; {sampler.summary()}")
    if traffic["loop"] == "open":
        late = np.array([r.start - r.due for r in win.calls]) * 1e3
        lat = np.array([r.done - r.due for r in win.calls]) * 1e3
        log(f"wake-up lateness against due time: p50 {np.median(late):.4f} ms, "
            f"p99 {np.quantile(late, 0.99):.4f} ms, max {late.max():.4f} ms")
        log(f"callback latency: p99 {np.quantile(lat, 0.99):.4f} ms, max "
            f"{lat.max():.4f} ms, {win.failed} of {len(lat)} past the deadline")

    del sut  # the program's state is freed before the reference runs
    gc.collect()
    comp = check(win, inputs, irs, cfg, check_rng)
    del inputs
    win.kept = {}

    record = {"config": cfg, "traffic": traffic, "window": win, "setup_s": setup_s,
              "device_kind": kind, "card": card}
    tr = None
    device = {"platform": devices[0].platform, "kind": kind, "count": len(devices),
              "memory_peak_bytes": int(memory_peak)}
    result = {"correct": comp.correct, "attempted": len(win.calls),
              "failed": win.failed}
    if traced:
        tr = trace_lib.load(log_dir)
        shutil.rmtree(log_dir, ignore_errors=True)
        w = tr.span("bench.window")
        if w is not None and tr.device:
            device["busy_s"] = tr.busy_ns(w.start, w.end) * 1e-9 / max(tr.devices, 1)
            device["window_s"] = (w.end - w.start) * 1e-9
            result["breakdown"] = tr.breakdown(w.start, w.end)
            _report_copy_probe(tr, probe, kind, card)
    metrics = {}
    for m in (spec["per_layer"] if traced else spec["end_to_end"]):
        value = load_reader(spec["bench_dir"], m["name"])(tr, record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            log(f"{m['name']}: {value} {m['unit']}")
    result["metrics"] = metrics
    result["device"] = device
    log(comp.summary())
    log(f"correct: {comp.correct}")
    result["check"] = comp.numbers()
    for name, v in result["check"].items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    return result


# ----------------------------------------------- large-copy probe (traced)

_PROBE_FLOATS = 1 << 28  # 1 GiB of float32 read and 1 GiB written per call
_PROBE_CALLS = 20


def _compile_copy_probe(jax):
    import jax.numpy as jnp

    f = jax.jit(lambda v: v + 1.0)
    return f.lower(jax.ShapeDtypeStruct((_PROBE_FLOATS,), jnp.float32)).compile()


def _run_copy_probe(jax, probe) -> None:
    import jax.numpy as jnp

    x = jnp.zeros((_PROBE_FLOATS,), jnp.float32)
    for _ in range(_PROBE_CALLS):
        x = probe(x)
    jax.block_until_ready(x)


def _report_copy_probe(tr, probe, kind, card) -> None:
    s = tr.span("bench.copy_probe")
    if s is None:
        return
    durs = [e.end - e.start for e in tr.events_in(s.start, s.end, kernels_only=True)]
    if not durs:
        return
    rate = 8.0 * _PROBE_FLOATS / (statistics.median(durs) * 1e-9)
    peak = peaks.peaks_for(kind)["hbm_bytes_per_s"]
    log(f"copy probe: {rate / 1e12:.4f} TB/s read+write, {100 * rate / peak:.2f}% of "
        f"the data sheet's {peak / 1e12} TB/s ({card})")


# -------------------------------------------------------------------- main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(ROOT, args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except NoChip as e:
        log(f"no result: {e}")
        return 1
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
