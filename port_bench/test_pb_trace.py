"""The trace reader on a hand-made Chrome trace: busy time is the union of
the device's intervals within the window, and idle time is named by the
innermost span open over it."""

import json

import pytest

from port_bench.trace_io import Trace


def _trace(tmp_path):
    ev = [
        # host spans on the main thread (tid 1); one on another thread
        {"ph": "X", "cat": "user_annotation", "name": "bench.window",
         "ts": 0, "dur": 100, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "job", "ts": 0,
         "dur": 90, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "stage", "ts": 10,
         "dur": 30, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "inner", "ts": 20,
         "dur": 5, "tid": 1},
        {"ph": "X", "cat": "user_annotation", "name": "decode", "ts": 0,
         "dur": 100, "tid": 2},
        # device: two overlapping kernels, a copy, one outside the window
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 40, "dur": 10},
        {"ph": "X", "cat": "kernel", "name": "k_b", "ts": 45, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 70,
         "dur": 5},
        {"ph": "X", "cat": "kernel", "name": "k_a", "ts": 120, "dur": 10},
        {"ph": "i", "cat": "kernel", "name": "marker", "ts": 50},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    return Trace(str(path))


def test_busy_and_window(tmp_path):
    t = _trace(tmp_path)
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(20e-6)  # [40, 55) and [70, 75)
    assert t.kernel_s(r"^k_") == pytest.approx(20e-6)
    assert t.gaps() == [(0.0, 40.0), (55.0, 70.0), (75.0, 100.0)]


def test_idle_named_by_innermost_span(tmp_path):
    idle = dict(_trace(tmp_path).idle_by_span())
    # [0, 10) job, [10, 20) stage, [20, 25) inner, [25, 40) stage,
    # [55, 70) job, [75, 90) job, [90, 100) outside any span
    assert idle == pytest.approx({"job": 40e-6, "stage": 25e-6,
                                  "inner": 5e-6, "outside": 10e-6})
    assert sum(idle.values()) == pytest.approx(80e-6)


def test_device_ops(tmp_path):
    ops = dict(_trace(tmp_path).device_ops())
    assert ops == pytest.approx({"k_a": 10e-6, "k_b": 10e-6,
                                 "Memcpy HtoD": 5e-6})
