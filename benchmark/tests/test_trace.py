"""The trace reduction, on hand-made events and on a small trace recorded
on an H100 (``data/small.xplane.pb``: 8 channels through the nested engine
in closed-loop calls, then 24 paced callbacks of a stereo HybridStream
with S=8, inside one ``bench.window`` span)."""

import os

import pytest

from benchmark import trace as T

DATA = os.path.join(os.path.dirname(__file__), "data", "small.xplane.pb")


def _trace():
    dev = [T.Event(10, 20, "gemm_a"), T.Event(15, 30, "fusion_b"),
           T.Event(50, 60, "MemcpyD2H"), T.Event(80, 90, "gemm_a")]
    spans = [T.Event(0, 100, "bench.window"), T.Event(5, 40, "bench.call.7"),
             T.Event(45, 70, "bench.call.8"), T.Event(70, 95, "bench.sleep")]
    return T.Trace(dev, spans, devices=1)


def test_busy_union_and_gaps():
    tr = _trace()
    assert tr.busy_ns(0, 100) == 20 + 10 + 10
    assert tr.busy_ns(0, 100, kernels_only=True) == 30
    assert tr.busy_ns(12, 55) == 18 + 5
    assert tr.idle_gaps(0, 100) == [(0, 10), (30, 50), (60, 80), (90, 100)]
    assert sum(b - a for a, b in tr.idle_gaps(0, 100)) + tr.busy_ns(0, 100) == 100


def test_spans_intervals_and_labels():
    tr = _trace()
    assert tr.call_intervals() == {7: (5, 45), 8: (45, 100)}
    assert [e.name for e in tr.events_in(5, 45, kernels_only=True)] == ["gemm_a", "fusion_b"]
    assert tr.host_label(35) == "bench.call"
    assert tr.host_label(85) == "bench.sleep"
    assert tr.host_label(2) == "no span"


def test_breakdown():
    b = _trace().breakdown(0, 100)
    assert b["device_ops"][0] == ["gemm_a", pytest.approx(20e-9)]
    # the longest gap, 30-50, falls between the two calls' spans
    assert b["idle_gaps"][0] == ["no span", pytest.approx(20e-9)]
    assert len(b["idle_gaps"]) == 4


def test_recorded_trace():
    if not os.path.exists(DATA):
        pytest.fail("the recorded trace is missing")
    tr = T.load(DATA)
    assert tr.devices == 1
    w = tr.span("bench.window")
    assert w is not None and w.end > w.start
    kernels = tr.events_in(w.start, w.end, kernels_only=True)
    assert kernels, "no device kernels inside the window"
    assert any(T.is_copy(e.name) for e in tr.device), "no copies in the trace"
    busy = tr.busy_ns(w.start, w.end)
    gaps = tr.idle_gaps(w.start, w.end)
    assert 0 < busy < w.end - w.start
    assert busy + sum(b - a for a, b in gaps) == w.end - w.start
    iv = tr.call_intervals()
    assert len(iv) >= 24 + 2
    # every callback of the paced stream launched kernels inside its interval
    stream_calls = sorted(iv)[-24:]
    assert all(tr.events_in(*iv[j], kernels_only=True) for j in stream_calls)
    b = tr.breakdown(w.start, w.end)
    assert 0 < len(b["device_ops"]) <= 10 and 0 < len(b["idle_gaps"]) <= 10
    assert {lab for lab, _ in b["idle_gaps"]} <= {"bench.call", "bench.sleep", "no span"}
