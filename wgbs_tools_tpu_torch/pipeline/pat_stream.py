"""Streaming per-pat reductions.

The port's copy of wgbs_tools_tpu/pipeline/pat_stream.py's
`homog_pat_streaming` (:248-268), over the port's `iter_pat`.
"""

from ..formats.pat import DEF_CHUNK_BYTES, iter_pat
from ..ops.frag_ops import HomogBins
from .pat2beta import stream_into


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
