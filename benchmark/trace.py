"""Reduction of a JAX profiler trace (``.xplane.pb``) to what the per-layer
metrics read: the device's kernel and copy events, the benchmark's own host
spans on the same clock, the busy union, idle gaps, and the breakdown.

Device events are those of the ``/device:GPU:<n>`` planes. Their summary
lines ("XLA Modules", "XLA Ops", ...) repeat the stream's events and are
skipped. Host spans are the ``jax.profiler.TraceAnnotation`` events whose
names start with ``bench.``: the harness writes one per call
(``bench.call.<index>``), one around the measured window (``bench.window``)
and one around each idle wait of an open loop (``bench.sleep``).
"""

from __future__ import annotations

import bisect
import dataclasses
import glob
import os
import re

SPAN_PREFIX = "bench."
_COPY = re.compile(r"memcpy|memset", re.IGNORECASE)


@dataclasses.dataclass(frozen=True)
class Event:
    start: int  # ns, trace clock
    end: int
    name: str


def is_copy(name: str) -> bool:
    """A copy or fill on the device, as opposed to a kernel."""
    return bool(_COPY.search(name))


class Trace:
    """One traced run, reduced: device events (all GPUs, sorted by start)
    and the benchmark's host spans."""

    def __init__(self, device: list[Event], spans: list[Event], devices: int):
        self.device = sorted(device, key=lambda e: (e.start, e.end))
        self.spans = sorted(spans, key=lambda e: (e.start, e.end))
        self.devices = devices
        self._starts = [e.start for e in self.device]
        self._longest = max((e.end - e.start for e in self.device), default=0)

    # -- spans ----------------------------------------------------------------

    def span(self, name: str) -> Event | None:
        """The first host span of exactly this name."""
        for s in self.spans:
            if s.name == name:
                return s
        return None

    def call_spans(self) -> dict[int, Event]:
        """``bench.call.<index>`` spans by index."""
        out = {}
        for s in self.spans:
            if s.name.startswith(SPAN_PREFIX + "call."):
                out[int(s.name.rsplit(".", 1)[1])] = s
        return out

    def call_intervals(self) -> dict[int, tuple[int, int]]:
        """Each call's interval, from its span's start to the next call's
        (the window's end for the last). In a paced loop whose calls wait
        for their outputs, a call's device work, and any work it enqueued
        after its output, runs inside its interval."""
        spans = sorted(self.call_spans().items())
        window = self.span(SPAN_PREFIX + "window")
        out = {}
        for i, (j, s) in enumerate(spans):
            end = spans[i + 1][1].start if i + 1 < len(spans) else (
                window.end if window is not None else s.end)
            out[j] = (s.start, end)
        return out

    # -- device events --------------------------------------------------------

    def events_in(self, lo: int, hi: int, kernels_only: bool = False) -> list[Event]:
        """Device events that start in [lo, hi)."""
        i = bisect.bisect_left(self._starts, lo)
        j = bisect.bisect_left(self._starts, hi)
        evs = self.device[i:j]
        if kernels_only:
            evs = [e for e in evs if not is_copy(e.name)]
        return evs

    def busy_ns(self, lo: int, hi: int, kernels_only: bool = False) -> int:
        """Length of the union of device events clipped to [lo, hi). Events
        of all devices fall in one union: every cell runs on one chip."""
        i = bisect.bisect_left(self._starts, lo - self._longest)
        j = bisect.bisect_left(self._starts, hi)
        evs = self.device[i:j]
        if kernels_only:
            evs = [e for e in evs if not is_copy(e.name)]
        return sum(b - a for a, b in _union(evs, lo, hi))

    def idle_gaps(self, lo: int, hi: int) -> list[tuple[int, int]]:
        """Intervals of [lo, hi) in which no device event runs."""
        gaps, cur = [], lo
        for a, b in _union(self.device, lo, hi):
            if a > cur:
                gaps.append((cur, a))
            cur = max(cur, b)
        if cur < hi:
            gaps.append((cur, hi))
        return gaps

    def host_label(self, t: int) -> str:
        """The innermost ``bench.`` span holding ``t``, without its index:
        what the harness was doing then."""
        best = None
        for s in self.spans:
            if s.start <= t < s.end and s.name != SPAN_PREFIX + "window":
                if best is None or s.end - s.start < best.end - best.start:
                    best = s
        if best is None:
            return "no span"
        return re.sub(r"\.\d+$", "", best.name)

    def breakdown(self, lo: int, hi: int, top: int = 10) -> dict:
        """The device operations that took most time in [lo, hi), and the
        longest idle gaps labelled by the host span they fall in; seconds."""
        totals: dict[str, int] = {}
        for e in self.events_in(lo, hi):
            totals[e.name] = totals.get(e.name, 0) + (e.end - e.start)
        ops = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps(lo, hi), key=lambda g: g[0] - g[1])[:top]
        return {
            "device_ops": [[name[:120], ns * 1e-9] for name, ns in ops],
            "idle_gaps": [[self.host_label((a + b) // 2), (b - a) * 1e-9]
                          for a, b in gaps],
        }


def _union(events, lo: int, hi: int):
    """Merged [start, end) intervals of ``events`` clipped to [lo, hi)."""
    out: list[list[int]] = []
    for e in sorted(events, key=lambda e: e.start):
        a, b = max(e.start, lo), min(e.end, hi)
        if a >= b:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def profile_options():
    """Profiler options of a traced run: no Python function tracer (it
    records every Python call, slows the host path it measures and swells
    the trace), host events at level 1 (the benchmark's
    ``TraceAnnotation`` spans), no HLO protos."""
    import jax

    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    opts.host_tracer_level = 1
    opts.enable_hlo_proto = False
    return opts


def find_xplane(log_dir: str) -> str:
    """The one ``.xplane.pb`` a ``jax.profiler`` session wrote under
    ``log_dir``."""
    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f"expected one .xplane.pb under {log_dir}, found {paths}")
    return paths[0]


def load(path: str) -> Trace:
    """Read an ``.xplane.pb`` file (or the log directory holding one)."""
    from jax.profiler import ProfileData

    if os.path.isdir(path):
        path = find_xplane(path)
    prof = ProfileData.from_file(path)
    device, spans, devices = [], [], 0
    for plane in prof.planes:
        if plane.name.startswith("/device:GPU"):
            devices += 1
            for line in plane.lines:
                if "XLA" in line.name or "Modules" in line.name:
                    continue  # summary lines repeat the stream's events
                for ev in line.events:
                    s = int(ev.start_ns)
                    device.append(Event(s, s + int(ev.duration_ns), ev.name))
        elif plane.name.startswith("/host:"):
            for line in plane.lines:
                for ev in line.events:
                    if ev.name.startswith(SPAN_PREFIX):
                        s = int(ev.start_ns)
                        spans.append(Event(s, s + int(ev.duration_ns), ev.name))
    return Trace(device, spans, devices)
