"""The device trace of a traced run: torch.profiler over the measured window,
read back from its Chrome trace.

Busy time is the union of the card's kernels, copies and sets within the
window; idle time is the rest, named piece by piece by the innermost span
that the benchmark's wrappers (record_function, see run.py) held open on
the main thread.
"""

import bisect
import heapq
import json
import re
from collections import defaultdict
from contextlib import contextmanager

WINDOW_SPAN = "bench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
TOP = 10
NAME = 160  # characters of a kernel name kept in the breakdown


@contextmanager
def profiled():
    """torch.profiler over CPU and CUDA, without shapes or stacks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield prof


class Trace:
    """The window, the device's intervals and the host's spans of one
    Chrome trace (times in microseconds, as the trace gives them)."""

    def __init__(self, path):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        spans, device = [], []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            a = float(e["ts"])
            b = a + float(e["dur"])
            if cat in DEVICE_CATS:
                device.append((a, b, e.get("name", "")))
            elif cat == "user_annotation":
                spans.append((a, b, e.get("name", ""), e.get("tid")))
        win = [s for s in spans if s[2] == WINDOW_SPAN]
        if not win:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
        self.w0, self.w1, _, tid = win[0]
        self.spans = sorted((s for s in spans if s[3] == tid
                             and s[2] != WINDOW_SPAN), key=lambda s: s[0])
        self.device = sorted(d for d in device if d[1] > self.w0
                             and d[0] < self.w1)

    @property
    def window_s(self):
        return (self.w1 - self.w0) * 1e-6

    def busy_intervals(self):
        out = []
        for a, b, _ in self.device:
            a, b = max(a, self.w0), min(b, self.w1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def gaps(self):
        """Idle intervals of the window, in order."""
        out, t = [], self.w0
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if t < self.w1:
            out.append((t, self.w1))
        return out

    def kernel_s(self, pattern):
        """Seconds of the device intervals whose name matches `pattern`."""
        rx = re.compile(pattern)
        return sum(b - a for a, b, n in self.device if rx.search(n)) * 1e-6

    def device_ops(self):
        """Device seconds by operation, the names cut to NAME characters."""
        by = defaultdict(float)
        for a, b, n in self.device:
            by[n[:NAME]] += (b - a) * 1e-6
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[
            :TOP]

    def host_segments(self):
        """The window cut where a span opens or closes, each piece named by
        the innermost span open over it ("outside" where none is)."""
        cuts = sorted({self.w0, self.w1} | {t for s in self.spans
                                             for t in s[:2]
                                             if self.w0 < t < self.w1})
        starts = [s[0] for s in self.spans]
        heap, nxt, out = [], 0, []
        for a, b in zip(cuts[:-1], cuts[1:]):
            mid = 0.5 * (a + b)
            hi = bisect.bisect_right(starts, mid)
            while nxt < hi:
                s = self.spans[nxt]
                heapq.heappush(heap, (-s[0], s[1], s[2]))
                nxt += 1
            while heap and heap[0][1] < mid:
                heapq.heappop(heap)
            name = heap[0][2] if heap else "outside"
            if out and out[-1][2] == name and out[-1][1] == a:
                out[-1][1] = b
            else:
                out.append([a, b, name])
        return out

    def idle_by_span(self):
        """Idle seconds of the window by the innermost host span open while
        the card was idle."""
        by = defaultdict(float)
        segs = self.host_segments()
        j = 0
        for a, b in self.gaps():
            while j < len(segs) and segs[j][1] <= a:
                j += 1
            k = j
            while k < len(segs) and segs[k][0] < b:
                lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
                if hi > lo:
                    by[segs[k][2]] += (hi - lo) * 1e-6
                k += 1
        return sorted(([n, s] for n, s in by.items()), key=lambda x: -x[1])[
            :TOP]

    def breakdown(self):
        return {"device_ops": self.device_ops(),
                "idle_gaps": self.idle_by_span()}
