"""Profiling and structured run reporting.

SURVEY.md section 5: the reference's observability is google-benchmark
counters + wall-clock prints; the equivalents here are
``jax.profiler`` trace capture plus structured per-run JSON records
(config, samples/s per device, roofline fraction, SNR) for baseline tracking.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
import time

import jax

__all__ = ["trace", "RunRecord", "emit_record"]


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/neojax-trace"):
    """Capture a jax.profiler trace around a workload::

        with profile.trace("/tmp/trace"):
            out = proc(params, state, sig)
            jax.block_until_ready(out)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@dataclasses.dataclass
class RunRecord:
    """Structured result of one benchmark/parity run."""

    name: str
    config: dict
    samples_per_sec: float | None = None
    seconds: float | None = None
    roofline_fraction: float | None = None
    snr_db: float | None = None
    extra: dict = dataclasses.field(default_factory=dict)
    timestamp: float = dataclasses.field(default_factory=time.time)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def emit_record(record: RunRecord, stream=None) -> None:
    print(record.to_json(), file=stream or sys.stderr)
