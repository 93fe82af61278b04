"""Spans and counters of the port, read through torch.profiler.

A span names a stretch of the program (a slab, a window batch, a loop or
a stage; never a block, a line or a site) in the profiler's trace. While
a torch profiler runs, `span(name)` enters
torch.profiler.record_function(name): the range lands in the same Chrome
trace as the kernels and copies, on the profiler's clock, and the kernels
launched inside it carry its name (a gpu_user_annotation range). While no
profiler runs, a span costs one flag test and calls nothing. A span never
synchronises the device.

A counter adds only while a profiler runs, so a profiled stretch counts
and the rest of the process does not. `counters()` returns the sums since
the process started or `reset_counters()` ran. A caller computes a
counter's value under `if on():`, so that an unprofiled run does no extra
work.

`stage` is device.timed's context: the stage's span, and with a timings
dict the stage's wall seconds added to it after a synchronise of a CUDA
device.

    from torch.profiler import ProfilerActivity, profile
    from wgbs_tools_tpu_torch import trace
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pat2beta("sample.pat.gz", out_dir="out")
    prof.export_chrome_trace("trace.json")  # pat2beta.run, pileup.stage, ...
    trace.counters()                        # {"pileup.sites": ..., ...}
"""

import threading
import time
from contextlib import nullcontext

import torch
from torch.autograd import profiler as _profiler

_NULL = nullcontext()
_LOCK = threading.Lock()
_COUNTERS = {}


def on():
    """True while a torch profiler runs in this process."""
    return _profiler._is_profiler_enabled


def span(name):
    """A context naming its block `name` in the profiler's trace; a shared
    do-nothing context while no profiler runs."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(name)


def count(name, n):
    """Add `n` to the counter `name` while a profiler runs."""
    if not _profiler._is_profiler_enabled:
        return
    with _LOCK:
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def counters():
    """The counters' sums, by name."""
    with _LOCK:
        return dict(_COUNTERS)


def reset_counters():
    with _LOCK:
        _COUNTERS.clear()


class _Stage:
    """A span around the block and, with `timings`, the block's wall
    seconds added to timings[stage] once a CUDA `device` has synchronised.
    A block that raises adds nothing."""

    __slots__ = ("_span", "_timings", "_stage", "_device", "_t0")

    def __init__(self, span_cm, timings, stage, device):
        self._span = span_cm
        self._timings = timings
        self._stage = stage
        self._device = device

    def __enter__(self):
        if self._span is not None:
            self._span.__enter__()
        if self._timings is not None:
            self._t0 = time.perf_counter()

    def __exit__(self, exc_type, exc, tb):
        try:
            if self._timings is not None and exc_type is None:
                if self._device is not None and \
                        torch.device(self._device).type == "cuda":
                    torch.cuda.synchronize(self._device)
                dt = time.perf_counter() - self._t0
                with _LOCK:
                    self._timings[self._stage] = \
                        self._timings.get(self._stage, 0.0) + dt
        finally:
            if self._span is not None:
                self._span.__exit__(exc_type, exc, tb)
        return False


def stage(timings, stage_name, device, span_name):
    """The context of one timed stage: the span `span_name` while a
    profiler runs, and the seconds of `stage_name` in `timings` (a dict, or
    None for none)."""
    rf = (torch.profiler.record_function(span_name)
          if _profiler._is_profiler_enabled else None)
    if rf is None and timings is None:
        return _NULL
    return _Stage(rf, timings, stage_name, device)
