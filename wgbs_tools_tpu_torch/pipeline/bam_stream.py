"""Bounded-memory streaming bam2pat.

The port's copy of wgbs_tools_tpu/pipeline/bam_stream.py, with the same
names; the reads of each slab group call and merge on the `device` given
(ops/calling.py's kernels), where JAX asks use_device_calling() and merges
on the host.

The whole-file columnar path (bam_columnar.py) decompresses the entire BAM
into host RAM and accumulates every output fragment before one write — a
30x human WGBS BAM (~100 GB compressed) cannot physically run. This module
processes the BAM in fixed-size compressed slabs instead:

  compressed slab -> BGZF-boundary cut -> native MT inflate -> columnar
  record scan (partial trailing record carried to the next slab) ->
  filter/decode/call (shared with bam_columnar) -> cross-slab mate pairing
  (qname dict + BAM next_pos to retire mate-lost singles) -> watermarked
  sorted emission into a PatStreamWriter.

Host memory is bounded by one slab (compressed + decompressed), the
in-flight mate window, and one slab's worth of pending fragments —
independent of BAM size. Output text is byte-identical to the in-memory
path (and hence to reference `match_maker | patter | sort | collapse`).

The reference streams per chromosome through `samtools view chrN` pipes and
per-chromosome tmp part files (ref: src/python/bam2pat.py:144-209,303-422);
this is the single-pass equivalent with the sort replaced by the
watermarked reorder buffer (BAM coordinate order is already ~CpG order; only
fragments inside the open mate window can be out of order).
"""

import struct

import numpy as np

from ..device import timed
from ..formats.pat import PatStreamWriter, _last_block_end, empty_frags
from ..utils import IllegalArgumentError, logger
from .bam import FPAIRED, FUNMAP
from .calling import MBiasCounter, ReadStats, rows_to_frags

DEFAULT_SLAB = 32 << 20


class StreamUnsupported(Exception):
    """Raised when this BAM cannot take the streaming path (the dispatcher
    falls back to the whole-file columnar path)."""


def _parse_header(buf):
    """(header_text, ref_names, ref_lengths, records_off) or None if the
    buffer does not yet contain the complete header."""
    if len(buf) < 12:
        return None
    if buf[:4] != b"BAM\x01":
        raise IllegalArgumentError("not a BAM file (bad magic)")
    (l_text,) = struct.unpack_from("<i", buf, 4)
    pos = 8 + l_text
    if len(buf) < pos + 4:
        return None
    (n_ref,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        if len(buf) < pos + 4:
            return None
        (l_name,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        if len(buf) < pos + l_name + 4:
            return None
        ref_names.append(buf[pos : pos + l_name - 1].decode())
        pos += l_name
        ref_lengths.append(struct.unpack_from("<i", buf, pos)[0])
        pos += 4
    header_text = buf[8 : 8 + l_text].decode(errors="replace")
    return header_text, ref_names, ref_lengths, pos


def iter_bam_columnar_slabs(path, slab_bytes=DEFAULT_SLAB):
    """Yield ("header", text, ref_names, ref_lengths) once, then
    ("slab", buf, cols, offs, rec_end) columnar slabs with bounded memory.

    Compressed bytes are cut at BGZF block boundaries; a partial trailing
    record's bytes are carried into the next slab's buffer, so every yielded
    slab contains only complete records.
    """
    from ..formats.bgzf import is_gzip
    from ..native import bam_scan_native, bgzf_decompress_native

    gz = is_gzip(path)
    header_done = False
    rec_carry = b""
    comp_carry = b""
    with open(path, "rb") as f:
        at_eof = False
        while not at_eof:
            fresh = f.read(slab_bytes)
            at_eof = not fresh
            if gz:
                slab = comp_carry + fresh
                if not slab:
                    break
                end = _last_block_end(slab)
                if end == 0:
                    if at_eof:
                        raise IllegalArgumentError(
                            f"truncated BGZF block at end of {path}")
                    comp_carry = slab
                    continue
                comp_carry = slab[end:]
                dec = bgzf_decompress_native(slab[:end])
                if dec is None:
                    raise IllegalArgumentError(
                        f"BGZF decompression failed in {path}")
            else:
                dec = fresh
                if not dec and not rec_carry:
                    break
            buf = rec_carry + dec if rec_carry else dec
            rec_carry = b""
            if not header_done:
                parsed = _parse_header(buf)
                if parsed is None:
                    rec_carry = buf
                    continue
                header_text, names, lengths, off = parsed
                header_done = True
                yield ("header", header_text, names, lengths)
                buf = buf[off:]
            if not buf:
                continue
            scanned = bam_scan_native(buf, 0)
            if scanned is None:
                raise StreamUnsupported("native BAM scan unavailable")
            cols, offs, rec_end = scanned
            if cols.shape[0] == 0:
                rec_carry = buf
                continue
            last = int(rec_end[-1])
            rec_carry = buf[last:]
            yield ("slab", buf, cols, offs, rec_end)
    if comp_carry:
        raise IllegalArgumentError(f"truncated BGZF data at end of {path}")
    if rec_carry:
        if not header_done:
            raise IllegalArgumentError(f"truncated BAM header in {path}")
        raise IllegalArgumentError(f"truncated BAM record at end of {path}")


def _i32_at(bufarr, addr):
    """Vectorized little-endian int32 gather at byte addresses."""
    u = (bufarr[addr].astype(np.uint32)
         | (bufarr[addr + 1].astype(np.uint32) << 8)
         | (bufarr[addr + 2].astype(np.uint32) << 16)
         | (bufarr[addr + 3].astype(np.uint32) << 24))
    return u.view(np.int32) if u.ndim else np.uint32(u).view(np.int32)


class _ChromState:
    """Per-chromosome streaming state: open mate window + pending reorder
    buffer. Pairing semantics equal the whole-chromosome path's
    first-two-occurrences-in-position-order rule (bam_columnar.py). The
    reorder buffer is the shared SortedStreamEmitter (pat_stream.py) — one
    implementation of the watermark-flush/collapse-boundary invariant."""

    def __init__(self, chrom, site_base, loci, writer=None, timings=None):
        from .pat_stream import SortedStreamEmitter

        self.chrom = chrom
        self.site_base = site_base
        self.loci = loci
        # qname -> (start, pattern bytes | None, next_pos)
        self.outstanding = {}
        self.stats = ReadStats()
        self.emitted = 0
        self.last_pos = -1
        self._writer = writer
        self._timings = timings
        self.em = SortedStreamEmitter(self._sink)

    def _sink(self, frags):
        if self._writer is not None:
            with timed(self._timings, "write", None):
                self._writer.write_frags(frags)
        self.emitted += frags.nr_frags

    @property
    def pending(self):
        """PatFrags batches awaiting the watermark (the emitter's buffer)."""
        return self.em.pending


def _pad_rows(rows, W):
    """'.'-padded uint8 (n, W) matrix from a list of pattern byte strings."""
    out = np.full((len(rows), W), ord("."), dtype=np.uint8)
    for i, r in enumerate(rows):
        if r:
            out[i, : len(r)] = np.frombuffer(r, dtype=np.uint8)
    return out


def _emit_mat(state, starts, patmat, span, min_cpg):
    """Append a called matrix batch to pending (min_cpg filtered)."""
    from .bam_columnar import _mat_to_frags

    if min_cpg > 1:
        short = span < min_cpg
        state.stats.nr_short += int(short.sum())
        keep = ~short
        starts, patmat, span = starts[keep], patmat[keep], span[keep]
    if starts.shape[0]:
        state.pending.append(_mat_to_frags(starts, patmat, span, state.chrom))


def _emit_entries(state, entries, min_cpg):
    """Append outstanding-entry singles (mate never arrived) to pending."""
    rows = [(s, p) for s, p, _np in entries if s >= 0 and p is not None]
    if not rows:
        return
    starts = np.array([s for s, _ in rows], dtype=np.int64)
    pats = [p for _, p in rows]
    if min_cpg > 1:
        keep = np.array([len(p) >= min_cpg for p in pats])
        state.stats.nr_short += int((~keep).sum())
        starts = starts[keep]
        pats = [p for p, k in zip(pats, keep) if k]
    if starts.shape[0]:
        state.pending.append(rows_to_frags(starts, pats, state.chrom))


def _process_group_pe(state, buf, bufarr, cols, offs, rows, clip, min_cpg,
                      mbias, device=None, timings=None):
    """Paired-end: call, then pair against the open mate window; calling
    and merging on `device` (None: numpy on the host)."""
    from .bam_columnar import decode_and_call, merge_mates

    order = np.argsort(cols[rows, 1], kind="stable")
    rs = rows[order]
    starts, patmat, span, qnames, _bad = decode_and_call(
        buf, bufarr, cols, offs, rs, state.loci, state.site_base, True,
        clip, state.stats, mbias=mbias, device=device, chrom=state.chrom,
        timings=timings)
    R = rs.shape[0]
    this_rid = cols[rs, 0]
    next_rid = _i32_at(bufarr, offs[rs, 0].astype(np.int64) - 12)
    next_pos = _i32_at(bufarr, offs[rs, 0].astype(np.int64) - 8)
    has = starts >= 0

    out = state.outstanding
    pair_a = []  # outstanding entries
    pair_b = []  # local row index
    single_local = []
    qn = qnames.tolist()
    for i in range(R):
        q = qn[i]
        ent = out.pop(q, None)
        if ent is not None:
            state.stats.nr_pairs += 1
            pair_a.append(ent)
            pair_b.append(i)
        elif next_rid[i] != this_rid[i]:
            # mate maps to another chromosome: never pairable here (the
            # whole-chromosome path pairs within chromosome only)
            single_local.append(i)
        else:
            out[q] = (
                int(starts[i]),
                bytes(patmat[i, : span[i]]) if has[i] else None,
                int(next_pos[i]),
            )
    if rs.shape[0]:
        state.last_pos = max(state.last_pos, int(cols[rs[-1], 1]))

    if pair_b:
        b = np.asarray(pair_b)
        sA = np.array([e[0] for e in pair_a], dtype=np.int64)
        hasA = sA >= 0
        hasB = has[b]
        both = hasA & hasB
        if both.any():
            spA = np.array([len(e[1]) if e[1] else 0 for e in pair_a],
                           dtype=np.int64)
            WA = max(int(spA[both].max(initial=1)), 1)
            patA = _pad_rows([e[1] for e, m in zip(pair_a, both) if m], WA)
            bm = b[both]
            m_starts, m_pat, m_span, too_long = merge_mates(
                sA[both], patA, spA[both], starts[bm], patmat[bm], span[bm],
                device, timings)
            state.stats.nr_invalid += 2 * int(too_long.sum())
            ok = m_starts >= 0
            _emit_mat(state, m_starts[ok], m_pat[ok], m_span[ok], min_cpg)
        # one-sided pairs -> singles
        a_only = [e for e, ha, hb in zip(pair_a, hasA, hasB) if ha and not hb]
        if a_only:
            _emit_entries(state, [(s, p, 0) for s, p, _ in a_only], min_cpg)
        b_only = b[~hasA & hasB]
        if b_only.shape[0]:
            _emit_mat(state, starts[b_only], patmat[b_only], span[b_only],
                      min_cpg)
    if single_local:
        sl = np.asarray(single_local)
        sl = sl[has[sl]]
        if sl.shape[0]:
            _emit_mat(state, starts[sl], patmat[sl], span[sl], min_cpg)


def _process_group_se(state, buf, bufarr, cols, offs, rec_end, rows, clip,
                      min_cpg, mbias, ont, device=None, timings=None):
    """Single-end (incl. nanopore): call and append straight to pending;
    the calling on `device` (None, and nanopore reads: on the host)."""
    order = np.argsort(cols[rows, 1], kind="stable")
    rs = rows[order]
    if ont is not None:
        from .bam_columnar_ont import (MMParseError, mmml_bad_rows,
                                       process_chrom_columnar_ont)

        # per-record degradation, like the reference's per-read parser
        # (ref: src/pipeline_wgbs/ont.cpp:90-221): records the native
        # MM/ML parser rejects go through the scalar record path; only an
        # internally inconsistent parse hands the whole file back to the
        # in-memory path
        bad = mmml_bad_rows(buf, offs, rec_end, rs)
        good = rs[~bad] if bad.any() else rs
        if good.shape[0]:
            try:
                frags = process_chrom_columnar_ont(
                    buf, bufarr, cols, offs, rec_end, good, state.loci,
                    state.site_base, state.chrom, clip, min_cpg, state.stats,
                    False, **ont)
            except MMParseError as e:
                raise StreamUnsupported(str(e)) from e
            if frags.nr_frags:
                state.pending.append(frags)
        if bad.any():
            _process_ont_scalar(state, buf, cols, offs, rec_end, rs[bad],
                                clip, min_cpg, ont)
    else:
        from .bam_columnar import decode_and_call

        starts, patmat, span, _q, _bad = decode_and_call(
            buf, bufarr, cols, offs, rs, state.loci, state.site_base, False,
            clip, state.stats, mbias=mbias, device=device, chrom=state.chrom,
            timings=timings)
        has = starts >= 0
        _emit_mat(state, starts[has], patmat[has], span[has], min_cpg)
    if rs.shape[0]:
        state.last_pos = max(state.last_pos, int(cols[rs[-1], 1]))


def _process_ont_scalar(state, buf, cols, offs, rec_end, rows, clip,
                        min_cpg, ont):
    """Scalar record path for nanopore records the native MM/ML parser
    rejects: byte-equal per read to the columnar kernel by construction
    (bam_columnar_ont reuses the same calling helpers), so mixing paths
    inside one chromosome preserves output identity."""
    from .bam import record_from_columnar
    from .calling import call_records

    records = [record_from_columnar(buf, cols, offs, rec_end, int(r))
               for r in rows]
    records.sort(key=lambda r: r.pos)
    starts, patterns, _q = call_records(
        records, state.loci, state.site_base, state.chrom, False, clip=clip,
        min_cpg=min_cpg, stats=state.stats, nanopore=True,
        np_thresh=ont["np_thresh"], cpc_call=ont["cpc_call"],
        combine_mods=ont["combine_mods"])
    if len(patterns):
        state.pending.append(rows_to_frags(np.asarray(starts, dtype=np.int64),
                                           patterns, state.chrom))


def _retire_lost_mates(state, min_cpg):
    """Flush outstanding reads whose mate's position has been passed (the
    mate was filtered out / absent): they are singles, exactly as the
    whole-chromosome qname grouping would leave them."""
    if not state.outstanding:
        return
    lost = [q for q, e in state.outstanding.items() if e[2] < state.last_pos]
    if lost:
        _emit_entries(state, [state.outstanding.pop(q) for q in lost],
                      min_cpg)


def _watermark(state):
    """Every future fragment of this chromosome starts at or past this
    site: the min over (first CpG past the last processed position) and the
    called starts of still-open mates (a merged pair's start is the min of
    its mates')."""
    w = state.site_base + int(
        np.searchsorted(state.loci, state.last_pos + 1, side="left"))
    for s, p, _np_ in state.outstanding.values():
        if s >= 0 and s < w:
            w = s
    return w


def _flush_pending(state, final=False):
    if final:
        state.em.close()
    else:
        state.em.push(None, _watermark(state))


def _finalize_chrom(state, writer, min_cpg, total_stats):
    _emit_entries(state, list(state.outstanding.values()), min_cpg)
    state.outstanding.clear()
    _flush_pending(state, final=True)
    for k in state.stats.__dict__:
        total_stats.__dict__[k] += state.stats.__dict__[k]
    logger.info("bam2pat: %s", state.stats.summary(state.chrom))


def bam2pat_streaming(bam_path, g, idx, out_path, min_mapq, exclude_flags,
                      clip=0, min_cpg=1, include_chroms=None, nanopore=None,
                      np_thresh=0.667, cpc_call="C", combine_mods=False,
                      include_flags=None, top_strand=False,
                      bottom_strand=False, read_group=None, wl=None, bl=None,
                      mbias_prefix=None, slab_bytes=DEFAULT_SLAB, level=6,
                      device=None, timings=None):
    """Stream-convert a coordinate-sorted BAM into a sorted pat.gz.

    Returns (empty PatFrags, out_path, stats) — fragments are never all
    resident; writer.nr_frags is logged instead. Raises StreamUnsupported
    when the BAM's reference order conflicts with the CpG dictionary (the
    output could not be globally sorted single-pass). Reads call and merge
    on `device` (None: numpy on the host). With `timings`, the seconds of
    "scan" (inflating and scanning the slabs), "decode", "call", "merge"
    and "write" accumulate there.
    """
    from .bam2pat_run import (_overlaps_vec, _read_group_keep,
                              _ref_spans_columnar, _strand_flags)

    allowed = set(include_chroms or idx.chrom_names)
    total_stats = ReadStats()
    mbias = MBiasCounter() if mbias_prefix else None
    writer = PatStreamWriter(out_path, level=level)
    state = None
    done_chroms = set()
    ref_names = None
    chrom_of_rid = None
    paired = None
    ont = None
    required = 0
    strand_flags = None
    try:
        slabs = iter_bam_columnar_slabs(bam_path, slab_bytes)
        while True:
            with timed(timings, "scan", None):
                item = next(slabs, None)
            if item is None:
                break
            if item[0] == "header":
                _tag, header_text, ref_names, _lengths = item
                chrom_of_rid = [c if c in allowed and c in idx.chrom_names
                                else None for c in ref_names]
                # streaming needs BAM ref order == CpG-dictionary order for
                # the single-pass sorted output
                bases = [idx.chrom_site_bounds(c)[0]
                         for c in chrom_of_rid if c is not None]
                if any(b2 < b1 for b1, b2 in zip(bases, bases[1:])):
                    raise StreamUnsupported(
                        "BAM reference order differs from the genome "
                        "dictionary order")
                if nanopore is None:
                    nanopore = "PL:ONT" in header_text
                continue
            _tag, buf, cols, offs, rec_end = item
            bufarr = np.frombuffer(buf, dtype=np.uint8)
            if paired is None:
                paired, nanopore = _detect_first(
                    buf, cols, offs, rec_end, nanopore)
                if paired is None:
                    # no mapped record yet: skip this slab, keep detecting
                    continue
                if nanopore:
                    if paired:
                        raise IllegalArgumentError(
                            "Unrecognized bam format: paired end and "
                            "nanopore")
                    ont = dict(np_thresh=np_thresh, cpc_call=cpc_call,
                               combine_mods=combine_mods)
                    if device is not None:
                        logger.info("bam2pat: nanopore reads call with "
                                    "numpy on the host")
                if exclude_flags is None:
                    from .bam import (EXCLUDE_FLAGS,
                                      EXCLUDE_FLAGS_NANOPORE)

                    exclude_flags = (EXCLUDE_FLAGS_NANOPORE if nanopore
                                     else EXCLUDE_FLAGS)
                required = include_flags if include_flags is not None else (
                    3 if paired else 0)
                strand_flags = _strand_flags(top_strand, bottom_strand,
                                             paired)

            flag = cols[:, 2]
            keep = ((flag & FUNMAP) == 0) & (cols[:, 0] >= 0) \
                & (cols[:, 3] >= min_mapq) & ((flag & exclude_flags) == 0)
            if required:
                keep &= (flag & required) == required
            if strand_flags is not None:
                keep &= np.isin(flag, strand_flags)
            if read_group is not None:
                rr = np.nonzero(keep)[0]
                sub = _read_group_keep(buf, offs, rec_end, rr, read_group)
                keep[rr[~sub]] = False
            rows_all = np.nonzero(keep)[0]
            if rows_all.shape[0] == 0:
                if state is not None:
                    _retire_lost_mates(state, min_cpg)
                    _flush_pending(state)
                continue
            rids = cols[rows_all, 0]
            cuts = np.concatenate(
                [[0], np.nonzero(np.diff(rids))[0] + 1, [rows_all.shape[0]]])
            for a, b in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
                rid = int(rids[a])
                chrom = chrom_of_rid[rid] if 0 <= rid < len(chrom_of_rid) \
                    else None
                if chrom is None:
                    continue
                if state is not None and chrom != state.chrom:
                    _finalize_chrom(state, writer, min_cpg, total_stats)
                    done_chroms.add(state.chrom)
                    state = None
                if state is None:
                    if chrom in done_chroms:
                        raise IllegalArgumentError(
                            f"BAM is not coordinate-sorted: {chrom} records "
                            "are not contiguous")
                    site_base, _ = idx.chrom_site_bounds(chrom)
                    state = _ChromState(chrom, site_base,
                                        idx.chrom_loci(chrom), writer,
                                        timings)
                rows = rows_all[a:b]
                if wl is not None or bl is not None:
                    start0 = cols[rows, 1].astype(np.int64)
                    end0 = start0 + _ref_spans_columnar(bufarr, cols, offs,
                                                        rows)
                    if wl is not None:
                        rows = rows[_overlaps_vec(wl, chrom, start0, end0)]
                    else:
                        rows = rows[~_overlaps_vec(bl, chrom, start0, end0)]
                if rows.shape[0] == 0:
                    continue
                if paired:
                    _process_group_pe(state, buf, bufarr, cols, offs, rows,
                                      clip, min_cpg, mbias, device, timings)
                else:
                    _process_group_se(state, buf, bufarr, cols, offs,
                                      rec_end, rows, clip, min_cpg, mbias,
                                      ont, device, timings)
            if state is not None:
                _retire_lost_mates(state, min_cpg)
                _flush_pending(state)
        if state is not None:
            _finalize_chrom(state, writer, min_cpg, total_stats)
        nr = writer.nr_frags
        writer.close()
    except BaseException:
        # do NOT finalize: a truncated-but-EOF-terminated pat.gz with index
        # sidecars would look complete to delete_or_skip and downstream
        writer.abort()
        raise
    if mbias is not None:
        mbias.dump(mbias_prefix)
    logger.info("bam2pat: wrote %s (%d fragments, streamed)", out_path, nr)
    return empty_frags(), out_path, total_stats


def _detect_first(buf, cols, offs, rec_end, nanopore):
    """(paired, nanopore) from the first mapped record — or (None, nanopore)
    when this slab has no mapped record, so the caller keeps detecting on
    later slabs instead of locking in a default (ref: bam2pat.py:243-267
    scans until the first mapped read)."""
    from .bam import parse_tag

    mapped = np.nonzero((cols[:, 2] & FUNMAP == 0) & (cols[:, 0] >= 0))[0]
    if not mapped.size:
        return None, bool(nanopore)
    paired = bool(cols[mapped[0], 2] & FPAIRED)
    if not nanopore:
        r = mapped[0]
        tags = bytes(buf[offs[r, 4] : rec_end[r]])
        nanopore = (parse_tag(tags, b"MM") is not None
                    or parse_tag(tags, b"Mm") is not None)
    return paired, bool(nanopore)
