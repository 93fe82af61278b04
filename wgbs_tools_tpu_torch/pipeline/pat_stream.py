"""Streaming per-pat reductions and the sorted stream emitter.

The port's copy of wgbs_tools_tpu/pipeline/pat_stream.py's
`SortedStreamEmitter` (:26-69), which streaming bam2pat writes through,
and `homog_pat_streaming` (:248-268), over the port's `iter_pat`.
"""

from ..formats.pat import DEF_CHUNK_BYTES, iter_pat
from ..ops.frag_ops import HomogBins
from .pat2beta import stream_into


class SortedStreamEmitter:
    """Watermark reorder buffer: push (frags, min_future_start) batches,
    flush sorted+collapsed prefixes (start < watermark) to a sink.

    Rows with equal start are never split across flushes (watermarks bound
    future starts from below), so cross-flush collapse boundaries are safe:
    the concatenated output equals one global sort().collapse().
    """

    def __init__(self, sink):
        self.sink = sink  # callable(PatFrags)
        self.pending = []

    def push(self, frags, min_future_start):
        if frags is not None and frags.nr_frags:
            self.pending.append(frags)
        self._flush(min_future_start)

    def _concat(self):
        if len(self.pending) == 1:
            return self.pending[0]
        from ..cli.cmd_pat import _concat_frags

        return _concat_frags(self.pending)

    def _flush(self, watermark):
        if not self.pending:
            return
        frags = self._concat()
        mask = frags.start < watermark
        if not mask.any():
            self.pending = [frags]
            return
        emit = frags.take(mask)
        rest = frags.take(~mask)
        self.pending = [rest] if rest.nr_frags else []
        self.sink(emit.sort().collapse())

    def close(self):
        if self.pending:
            frags = self._concat()
            self.pending = []
            if frags.nr_frags:
                self.sink(frags.sort().collapse())


def homog_pat_streaming(pat_path, bstart_sorted, bend_sorted, ranges,
                        min_len=3, inclusive=False, chunk_bytes=None,
                        device="cuda", timings=None):
    """Streaming homog counting: per-fragment block counts are additive, so
    chunk results sum bit-identically to the whole-file pass (the streaming
    analogue of homog.cpp's sliding deque, ref: src/homog/homog.cpp:58-145).
    The counts stay on `device` across the slabs (ops/frag_ops.py::
    HomogBins) and come back once; with `timings`, the seconds of decode
    (the wait for the next slab), overlap, h2d, kernel and fetch accumulate
    there. Returns int64 (B, len(ranges) - 1).
    """
    hb = HomogBins(bstart_sorted, bend_sorted, ranges, min_cpgs=min_len,
                   inclusive=inclusive, device=device, timings=timings)
    stream_into(hb, iter_pat(pat_path, chunk_bytes=chunk_bytes
                             or DEF_CHUNK_BYTES), timings)
    return hb.result()
