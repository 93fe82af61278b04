"""Streaming pat consumers: bounded-memory view / merge / mask / homog.

The port's copy of wgbs_tools_tpu/pipeline/pat_stream.py:
`SortedStreamEmitter` (:26-69), which streaming bam2pat writes through,
`iter_view_pat` (:72), `merge_pats_streaming` (:136),
`mask_pat_streaming` (:216) and `homog_pat_streaming` (:248-268), over
the port's `iter_pat`.

pat files are sorted by startCpG, and every transform applied here (block
clipping, strict truncation, site masking with re-strip) can only move a
fragment's start FORWARD. So after consuming a chunk whose last raw start
is W, every future transformed fragment starts at >= W — transformed rows
with start < W are final and can be sorted, collapsed, and emitted. The
reorder buffer holds at most ~one chunk of fragments.
"""

import numpy as np

from ..formats.pat import DEF_CHUNK_BYTES, PatFrags, iter_pat, read_pat
from ..ops.frag_ops import HomogBins
from ..utils import IllegalArgumentError
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


def iter_view_pat(pat_path, genome, region=None, sites=None, bed_file=None,
                  strict=False, strip=False, min_len=1, no_gaps=False,
                  sub_sample=None, seed=None, chunk_bytes=None,
                  keep_extras=False):
    """Stream a pat file through the cview filter set as (frags,
    min_future_start) batches — the chunked equivalent of cli.view.view_pat
    (ref: cview pipeline, src/python/cview.py:25-52).

    Note on --sub_sample: sampling is per-chunk with a per-chunk derived
    seed; like the reference's pat_sampler (which seeds from the wall
    clock, ref: sampler.cpp:40-41) results are distributional, not
    byte-reproducible across chunkings.
    """
    from ..genome.region import GenomicRegion
    from ..ops.frag_ops import filter_by_blocks, sample_frags

    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    bstart = bend = None
    if bed_file is not None:
        from ..formats.blocks import load_blocks

        blocks = load_blocks(bed_file)
        keep = blocks["startCpG"] >= 0
        bs, be = blocks["startCpG"][keep], blocks["endCpG"][keep]
        order = np.argsort(bs, kind="stable")
        bstart, bend = bs[order], be[order]
    elif not gr.is_whole():
        s, e = gr.sites
        bstart, bend = np.array([s]), np.array([e])

    if not gr.is_whole():
        # region reads are index-bounded already; one batch
        chunks = [read_pat(pat_path, region_sites=gr.sites,
                           keep_extras=keep_extras)]
    else:
        chunks = iter_pat(pat_path, chunk_bytes=chunk_bytes
                          or DEF_CHUNK_BYTES, keep_extras=keep_extras)

    if bstart is None:
        bstart = np.array([1])
        bend = np.array([genome.get_nr_sites() + 1])

    ss, rep = sub_sample, 1
    if ss is not None:
        if ss < 0:
            raise IllegalArgumentError("sub-sampling rate must be >= 0")
        # rate > 0.25 handled by doubling reps (ref: cview.py:55-67)
        while ss > 0.25:
            rep *= 2
            ss /= 2

    for k, frags in enumerate(chunks):
        if frags.nr_frags == 0:
            continue
        wm = int(frags.start.max())  # raw starts only move forward
        out = filter_by_blocks(frags, bstart, bend, strict=strict,
                               strip=strip, min_cpgs=min_len,
                               no_gaps=no_gaps)
        if ss is not None:
            out = sample_frags(out, ss, reps=rep,
                               seed=None if seed is None else seed + 7919 * k)
        yield out, wm


def merge_pats_streaming(pat_paths, out_path, genome, labels=None,
                         view_kwargs=None, sub_samples=None, seed=None,
                         chunk_bytes=None, level=6):
    """k-way streaming merge of filtered pat streams into a sorted pat.gz.

    The streaming analogue of cli.cmd_pat.merge_pats — and of the
    reference's `sort -m <(cview ..) <(cview ..) | collapse_pat | bgzip`
    (ref: src/python/merge.py:76-103) — with the unix sort -m replaced by
    the shared watermark reorder buffer: per round, every live source
    contributes its buffered rows below the global watermark (the min over
    sources' last raw starts), which sort+collapse exactly like the k-way
    line merge. Memory is bounded by ~one chunk per source.
    """
    from ..formats.pat import PatStreamWriter

    view_kwargs = dict(view_kwargs or {})
    srcs = []
    for i, pat in enumerate(pat_paths):
        kw = dict(view_kwargs)
        if sub_samples is not None:
            kw["sub_sample"] = sub_samples[i]
            kw["seed"] = None if seed is None else seed + i
        # always carry extra columns (the reference's sort -m line merge
        # preserves them); --labels appends on top of any existing extras
        srcs.append(iter_view_pat(pat, genome, chunk_bytes=chunk_bytes,
                                  keep_extras=True, **kw))

    def _labelled(frags, i):
        if labels is None or frags.nr_frags == 0:
            return frags
        lab = labels[i].encode()
        if frags.extras is None:
            extras = np.full(frags.nr_frags, lab, dtype=object)
        else:
            # vectorized object concat: ufunc add over the column, no
            # per-row Python loop on the merge hot path
            base = frags.extras
            has = ~np.equal(base, None)
            extras = np.full(frags.nr_frags, lab, dtype=object)
            n = int(has.sum())
            if n:
                extras[has] = base[has] + np.full(n, b"\t" + lab,
                                                  dtype=object)
        return PatFrags(frags.start, frags.length, frags.count, frags.codes,
                        frags.chrom_id, frags.chrom_names, extras)

    writer = PatStreamWriter(out_path, level=level)
    em = SortedStreamEmitter(writer.write_frags)

    def _pull(i):
        """Buffer source i's next chunk; returns its raw frontier or None."""
        nxt = next(srcs[i], None)
        if nxt is None:
            return None
        em.push(_labelled(nxt[0], i), 0)  # buffer only (watermark 0)
        return nxt[1]

    try:
        # every buffered chunk lives in the emitter; frontiers[i] bounds
        # source i's future raw starts from below
        frontiers = [_pull(i) for i in range(len(srcs))]
        while True:
            live = [f for f in frontiers if f is not None]
            if not live:
                break
            wm = min(live)
            for i, f in enumerate(frontiers):
                if f == wm:
                    frontiers[i] = _pull(i)
            live = [f for f in frontiers if f is not None]
            if live:
                em.push(None, min(live))  # flush rows below the new min
        em.close()
        writer.close()  # inside try: a finalize failure must abort too
    except BaseException:
        writer.abort()  # never leave finalized-looking partial output
        raise
    return out_path


def mask_pat_streaming(pat_path, out_path, bstart, bend, genome,
                       region_sites=None, chunk_bytes=None,
                       level=6):
    """Streaming site masking (ref: src/pat2beta/mask_pat.cpp): masked
    fragments re-strip, so starts only move forward — same watermark
    machinery bounds memory."""
    from ..formats.pat import PatStreamWriter
    from ..ops.frag_ops import mask_sites

    writer = PatStreamWriter(out_path, level=level)
    em = SortedStreamEmitter(writer.write_frags)
    try:
        if region_sites is not None:
            chunks = [read_pat(pat_path, region_sites=region_sites)]
        else:
            # keep extra columns in both branches (read_pat above defaults
            # keep_extras=True; mask output preserves the input's columns)
            chunks = iter_pat(pat_path, chunk_bytes=chunk_bytes
                              or DEF_CHUNK_BYTES, keep_extras=True)
        for frags in chunks:
            if frags.nr_frags == 0:
                continue
            wm = int(frags.start.max())
            em.push(mask_sites(frags, bstart, bend, strip=True), wm)
        em.close()
        writer.close()  # inside try: a finalize failure must abort too
    except BaseException:
        writer.abort()  # never leave finalized-looking partial output
        raise
    return out_path



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
