"""Benchmark harness: wall-clock timing + items/s / bytes/s / flops counters.

Keeps the reference's measurement taxonomy (SURVEY.md section 5/6):
google-benchmark items/s + bytes/s (``extra/benchmark/src/convolution.cpp:42-44``),
FFT flop-rate ``5 N log2 N`` (``fft.cpp:37``), rfft round-trip flops
(``rfft.cpp:38-39``), and memcpy/multiply_add roofline probes
(``memcpy.cpp:27-36``) — re-expressed for the GPU: per-card throughput plus
a device-memory roofline fraction.

Timing protocol: synchronize by fetching a device-side reduction to host,
subtract nothing, report the min over repeats.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import numpy as np
import jax
import jax.numpy as jnp

__all__ = [
    "BenchResult",
    "measure",
    "fft_flops",
    "hbm_peak_bytes_per_sec",
    "memcpy_probe",
    "multiply_add_probe",
]

# Peak device-memory bandwidth per card, bytes/s, keyed on
# ``jax.devices()[0].device_kind``. Source: NVIDIA H100 data sheet
# (SXM5 80 GB HBM3: 3.35 TB/s; PCIe 80 GB HBM2e: 2.0 TB/s).
_HBM_PEAK = {
    "NVIDIA H100 80GB HBM3": 3.35e12,  # SXM5
    "NVIDIA H100 PCIe": 2.0e12,
}


def hbm_peak_bytes_per_sec(device_kind: str | None = None) -> float:
    """Published peak memory bandwidth of the card; an unknown card is an
    error (a roofline share against a guessed peak is worse than none)."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return _HBM_PEAK[kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind {kind!r}; "
            "add it to neojax.bench.harness._HBM_PEAK with its source"
        ) from None


@dataclasses.dataclass(frozen=True)
class BenchResult:
    name: str
    seconds: float
    items_per_sec: float | None = None
    bytes_per_sec: float | None = None
    flops_per_sec: float | None = None
    roofline_fraction: float | None = None

    def __str__(self):
        parts = [f"{self.name}: {self.seconds * 1e3:.2f} ms"]
        if self.items_per_sec:
            parts.append(f"{self.items_per_sec / 1e6:.1f} M items/s")
        if self.bytes_per_sec:
            parts.append(f"{self.bytes_per_sec / 1e9:.0f} GB/s")
        if self.flops_per_sec:
            parts.append(f"{self.flops_per_sec / 1e9:.0f} GFLOP/s")
        if self.roofline_fraction:
            parts.append(f"{self.roofline_fraction * 100:.0f}% of HBM roofline")
        return " | ".join(parts)


def _sync(out) -> None:
    leaves = jax.tree.leaves(out)
    if leaves:
        float(jnp.sum(jnp.abs(leaves[0]).astype(jnp.float32)))


def measure(
    name: str,
    fn: Callable,
    *args,
    repeats: int = 3,
    items: int | None = None,
    bytes_moved: int | None = None,
    flops: int | None = None,
) -> BenchResult:
    """Time ``fn(*args)`` (jit-compiled or not) with fetch-to-host sync."""
    out = fn(*args)
    _sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        _sync(out)
        times.append(time.perf_counter() - t0)
    dt = min(times)
    # a roofline share is a device metric: only on the card
    roof = None
    if bytes_moved and jax.default_backend() == "gpu":
        roof = bytes_moved / dt / hbm_peak_bytes_per_sec()
    return BenchResult(
        name=name,
        seconds=dt,
        items_per_sec=items / dt if items else None,
        bytes_per_sec=bytes_moved / dt if bytes_moved else None,
        flops_per_sec=flops / dt if flops else None,
        roofline_fraction=roof,
    )


def fft_flops(n: int, batch: int = 1) -> int:
    """The reference's FFT flop model: 5 N log2 N per transform."""
    return int(5 * n * np.log2(n)) * batch


def memcpy_probe(nbytes: int = 256 * 1024 * 1024) -> BenchResult:
    """Device-memory copy bandwidth probe (reference ``memcpy.cpp:27-36``)."""
    n = nbytes // 4
    x = jnp.arange(n, dtype=jnp.float32)
    f = jax.jit(lambda v: v + 1.0)
    return measure("memcpy", f, x, bytes_moved=2 * nbytes)


def multiply_add_probe(nbytes: int = 128 * 1024 * 1024) -> BenchResult:
    """Split-complex MAC bandwidth probe (``multiply_add.cpp``)."""
    n = nbytes // 4 // 4
    xr = jnp.ones((n,), jnp.float32)
    xi = jnp.ones((n,), jnp.float32)
    yr = jnp.ones((n,), jnp.float32)
    yi = jnp.ones((n,), jnp.float32)

    @jax.jit
    def mac(xr, xi, yr, yi):
        return xr * yr - xi * yi, xr * yi + xi * yr

    return measure(
        "multiply_add", mac, xr, xi, yr, yi, bytes_moved=6 * n * 4, flops=6 * n
    )
