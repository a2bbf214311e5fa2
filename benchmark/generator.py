"""The one general traffic generator. A traffic file under
``benchmark/traffic/`` holds its parameters; nothing else describes a mix.

Keys of a traffic file:

- ``loop``: ``"closed"`` (the next call is dispatched as soon as fewer than
  ``in_flight`` calls are outstanding: the throughput a caller gets whose
  audio is ready) or ``"open"`` (call i is due at t0 + i * period, whatever
  happened before: a host's audio callback).
- ``blocks_per_call``: blocks of ``block_size`` samples per call.
- ``input``: ``"device"`` (a pool of ``pool_calls`` distinct calls made on
  the device from the seed) or ``"host"`` (host arrays made from the seed:
  a pool of ``pool_calls``, or in an open loop without it one per call).
- ``output``: ``"device"`` (the call's output stays on the device; the loop
  waits for it with ``block_until_ready``) or ``"host"`` (fetched to host
  memory inside the call's time).

Either input goes with either output, in either loop.
- ``warmup_calls``: unpaced calls before the window, counted as set-up.
  Every shape of the window is compiled by them.
- open loop only: ``speed`` (1.0 is real time; the period is
  blocks_per_call * block_size / sample_rate / speed) and
  ``deadline_periods`` (a call whose output lands later than this many
  periods after its due time has failed).
- closed loop only: ``in_flight`` and ``kept_outputs`` (how many calls'
  outputs, drawn from the seed, are kept for the check besides the last).
  An open loop keeps every call's output.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np


@dataclasses.dataclass
class Call:
    index: int  # position in the stream, warm-up calls included
    due: float  # host clock, seconds
    start: float
    returned: float = 0.0  # the program's call returned (dispatch done)
    done: float = 0.0  # the output is ready (or in host memory)
    refresh: bool = False
    ok: bool = True


@dataclasses.dataclass
class Window:
    t0: float
    t1: float = 0.0
    calls: list = dataclasses.field(default_factory=list)
    kept: dict = dataclasses.field(default_factory=dict)  # index -> output
    failed: int = 0

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def no_span(name):
    return contextlib.nullcontext()


def warm_up(system, inputs, traffic) -> int:
    """Unpaced calls 0 .. warmup_calls-1, each waited for; returns the index
    of the window's first call."""
    import jax

    n = traffic["warmup_calls"]
    for j in range(n):
        out = system.call(inputs.call(j))
        if traffic["output"] == "host":
            np.asarray(out)
        else:
            jax.block_until_ready(out)
    return n


def run_window(system, inputs, traffic, seconds, first, rng, span=no_span,
               calls=None) -> Window:
    """Drive the window: ``seconds`` of closed-loop calls, or ``calls`` paced
    calls of an open loop. ``span(name)`` opens a host span (a
    ``TraceAnnotation`` in traced runs)."""
    if traffic["loop"] == "closed":
        return _closed(system, inputs, traffic, seconds, first, rng, span)
    if traffic["loop"] == "open":
        return _open(system, inputs, traffic, calls, first, span)
    raise ValueError(f"unknown loop {traffic['loop']!r}")


def open_calls(cfg, traffic, seconds) -> int:
    """Calls of an open loop in a window of ``seconds``."""
    return int(seconds / open_period(cfg, traffic))


def open_period(cfg, traffic) -> float:
    return (traffic["blocks_per_call"] * cfg["block_size"] / cfg["sample_rate"]
            / traffic.get("speed", 1.0))


def _closed(system, inputs, traffic, seconds, first, rng, span) -> Window:
    import jax

    to_host = traffic["output"] == "host"
    in_flight = traffic["in_flight"]
    keep = traffic["kept_outputs"]
    pending = []  # (Call, output)
    reservoir = []  # (Call index, output), a uniform sample drawn from the seed
    last = {}  # the last call finished, which is the window's last call
    seen = 0

    def finish(rec, out):
        nonlocal seen
        out = np.asarray(out) if to_host else jax.block_until_ready(out)
        last.clear()
        last[rec.index] = out
        rec.done = time.perf_counter()
        if len(reservoir) < keep:
            reservoir.append((rec.index, out))
        else:
            r = int(rng.integers(0, seen + 1))
            if r < keep:
                reservoir[r] = (rec.index, out)
        seen += 1

    w = Window(t0=time.perf_counter())
    j = first
    while time.perf_counter() - w.t0 < seconds:
        x = inputs.call(j)
        with span(f"bench.call.{j}"):
            rec = Call(j, due=time.perf_counter(), start=time.perf_counter(),
                       refresh=system.refreshes(j))
            out = system.call(x)
            rec.returned = time.perf_counter()
        w.calls.append(rec)
        pending.append((rec, out))
        if len(pending) >= in_flight:
            finish(*pending.pop(0))
        j += 1
    for rec, out in pending:
        finish(rec, out)
    w.t1 = time.perf_counter()
    w.kept = {**dict(reservoir), **last}
    return w


def _open(system, inputs, traffic, calls, first, span) -> Window:
    import jax

    period = open_period(system.cfg, traffic)
    deadline = traffic["deadline_periods"] * period
    to_host = traffic["output"] == "host"
    w = Window(t0=time.perf_counter() + 0.005)
    for i in range(calls):
        j = first + i
        due = w.t0 + i * period
        x = inputs.call(j)
        now = time.perf_counter()
        if now < due:
            with span("bench.sleep"):
                if due - now > 0.001:
                    time.sleep(due - now - 0.001)
                while time.perf_counter() < due:
                    pass
        rec = Call(j, due=due, start=time.perf_counter(), refresh=system.refreshes(j))
        with span(f"bench.call.{j}"):
            try:
                out = system.call(x)
                rec.returned = time.perf_counter()
                out = np.asarray(out) if to_host else jax.block_until_ready(out)
            except Exception as e:  # a callback that raises has failed
                rec.ok = False
                rec.returned = rec.returned or time.perf_counter()
                print(f"call {j} raised {type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
            rec.done = time.perf_counter()
        if rec.ok:
            w.kept[j] = out
        if not rec.ok or rec.done - due > deadline:
            w.failed += 1
        w.calls.append(rec)
    w.t1 = time.perf_counter()
    return w
