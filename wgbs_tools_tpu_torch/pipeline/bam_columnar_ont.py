"""Columnar nanopore (MM/ML) bam2pat fast path.

The port's copy of wgbs_tools_tpu/pipeline/bam_columnar_ont.py, with the
same names; nanopore calling runs on the host (numpy), as in the JAX
package.

The ONT analogue of bam_columnar.py: no per-record Python objects, no
Python tag scanning, no MM string splitting. The native library locates
MM/ML aux tags (wgbsio.cpp::bam_mmml_scan) and batch-parses every MM
string into a flat section table (mm_count/mm_fill); per read, the
modification-status mask is built directly in stored (reference)
orientation — the record path's revcomp + flip round trip
(ref: src/pipeline_wgbs/ont.cpp:90-130) collapses to one reversed scatter —
and CIGAR normalization is a single vectorized gather applied to both the
sequence and the mask. Calling reuses the exact helpers of
pipeline/nanopore.py, so outputs are identical to the record path (and the
reference oracle) by construction.
"""

import numpy as np

from ..utils import IllegalArgumentError
from .bam import _PAIR_LUT, FREVERSE

B_C, B_G = ord("C"), ord("G")


class MMParseError(RuntimeError):
    """Native MM/ML machinery unavailable or internally inconsistent.

    This is an infrastructure failure, never a per-record data problem —
    records whose MM/ML tags the native parser rejects are reported
    per-record by mmml_bad_rows() so callers can route just those through
    the scalar record path (the streaming analogue of the reference's
    per-read degradation, ref: src/pipeline_wgbs/ont.cpp:90-221)."""


def mmml_bad_rows(buf, offs, rec_end, rows):
    """Per-record MM/ML parseability for the given row indices.

    Returns a bool mask aligned with `rows` (True = the native parser
    cannot handle this record's aux region — send it to the scalar record
    path)."""
    from ..native import bam_mmml_scan_native

    _mm_off, mm_len, _ml_off, ml_n = bam_mmml_scan_native(
        buf, np.ascontiguousarray(offs[rows, 4]),
        np.ascontiguousarray(rec_end[rows]))
    return (mm_len == -9) | (ml_n == -9)

# CIGAR op codes: MIDNSHP=X -> 0..8
_PRODUCE = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=np.int64)
_COPY = np.array([1, 0, 0, 0, 0, 0, 0, 1, 1], dtype=bool)
_CONSUME = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=np.int64)


def scan_mmml(buf, offs, rec_end, rows=None):
    """Native MM/ML tag location for (a subset of) records.

    Returns (mm_off, mm_len, ml_off, ml_n), or None when any record's aux
    region failed to parse (the caller then takes the record path, which
    reports those reads invalid exactly like the reference patter does).
    """
    from ..native import bam_mmml_scan_native

    tags_off = offs[:, 4] if rows is None else offs[rows, 4]
    ends = rec_end if rows is None else rec_end[rows]
    mm_off, mm_len, ml_off, ml_n = bam_mmml_scan_native(
        buf, np.ascontiguousarray(tags_off), np.ascontiguousarray(ends))
    if (mm_len == -9).any() or (ml_n == -9).any():
        return None
    return mm_off, mm_len, ml_off, ml_n


def _normalize_cigar(seq, words, stats):
    """CIGAR-normalize via one gather (ref: patter_utils.cpp:209-251).

    Returns (seq_adj, gather_idx, iscopy) or None for an invalid CIGAR
    (unknown op — the record path raises per read)."""
    op = (words & 0xF).astype(np.int64)
    if (op > 8).any() or (op == 6).any():  # P / invalid: reference raises
        return None
    ln = (words >> np.uint32(4)).astype(np.int64)
    produce = ln * _PRODUCE[op]
    consume = ln * _CONSUME[op]
    src0 = np.cumsum(consume) - consume
    total = int(produce.sum())
    if total == 0:
        return np.zeros(0, dtype=np.uint8), None, None
    bounds = np.cumsum(produce) - produce
    offw = np.arange(total, dtype=np.int64) - np.repeat(bounds, produce)
    gidx = np.repeat(src0, produce) + offw
    iscopy = np.repeat(_COPY[op], produce)
    np.minimum(gidx, max(seq.shape[0] - 1, 0), out=gidx)
    seq_adj = np.where(iscopy, seq[gidx] if seq.size else 0,
                       ord("N")).astype(np.uint8)
    return seq_adj, gidx, iscopy


def process_chrom_columnar_ont(buf, bufarr, cols, offs, rec_end, idx_rows,
                               loci, site_base, chrom_name, clip, min_cpg,
                               stats, with_qname, np_thresh=0.667,
                               cpc_call="C", combine_mods=False):
    """Call one chromosome's nanopore reads (row indices into cols/offs).

    Returns a PatFrags batch. Raises MMParseError when native MM parsing is
    unavailable or rejects a record — callers must pre-validate with
    scan_mmml()/mmml_bad_rows() (bam2pat_run.py / bam_stream.py do) and
    route such records through the record path instead; a worker must never
    receive an unparseable job silently."""
    from ..native import mm_parse_native
    from .calling import rows_to_frags
    from .nanopore import NanoporeCalls, np_call_read_arr, ordinal_status

    sub_cols = cols[idx_rows]
    sub_offs = offs[idx_rows]
    sub_end = rec_end[idx_rows]
    order = np.argsort(sub_cols[:, 1], kind="stable")
    sub_cols = sub_cols[order]
    sub_offs = sub_offs[order]
    sub_end = sub_end[order]
    R = sub_cols.shape[0]
    stats.nr_lines += R

    scan = scan_mmml(buf, sub_offs, sub_end)
    if scan is None:
        raise MMParseError(
            "nanopore columnar path: MM/ML aux scan failed for %s; "
            "pre-validate with scan_mmml and use the record path" % chrom_name)
    mm_off, mm_len, ml_off, ml_n = scan
    parsed = mm_parse_native(buf, mm_off, mm_len)
    if parsed is None:
        raise MMParseError(
            "nanopore columnar path: native MM parse unavailable for %s; "
            "pre-validate with scan_mmml and use the record path" % chrom_name)
    sec_rec, sec_mod, sec_npdot, sec_part, sec_nskip, skips = parsed
    skip_off = np.zeros(sec_rec.shape[0] + 1, dtype=np.int64)
    np.cumsum(sec_nskip, out=skip_off[1:])
    rgrid = np.arange(R, dtype=np.int64)
    sec_start = np.searchsorted(sec_rec, rgrid, side="left")
    sec_stop = np.searchsorted(sec_rec, rgrid, side="right")

    l_seq = sub_cols[:, 4].astype(np.int64)
    n_cigar = sub_cols[:, 5].astype(np.int64)
    flags = sub_cols[:, 2].astype(np.int64)
    pos0 = sub_cols[:, 1].astype(np.int64)

    starts_out, patterns_out, q_out = [], [], []
    for r in range(R):
        lseq = int(l_seq[r])
        secs = {}
        for s in range(int(sec_start[r]), int(sec_stop[r])):
            mod = chr(int(sec_mod[s]) & 0xFF)
            if mod not in secs:
                secs[mod] = (
                    skips[skip_off[s]:skip_off[s + 1]].astype(np.int64),
                    bool(sec_npdot[s]),
                    int(sec_part[s]),
                )
        ml = None
        if ml_off[r] >= 0:
            ml = bufarr[ml_off[r]:ml_off[r] + ml_n[r]]
        try:
            calls = NanoporeCalls.from_sections(
                secs, ml, cpc_call=cpc_call, combine_mods=combine_mods)
        except IllegalArgumentError:
            stats.nr_invalid += 1
            continue
        if calls.empty or lseq == 0:
            stats.nr_empty += 1
            continue

        nb = (lseq + 1) // 2
        o2 = int(sub_offs[r, 2])
        seq = _PAIR_LUT[bufarr[o2:o2 + nb]].view(np.uint8)[:lseq]
        bottom = bool(flags[r] & FREVERSE)
        # C-ordinals of the as-sequenced read live at stored-orientation
        # G positions (right-to-left) for bottom reads, C positions for top
        c_pos = np.nonzero(seq == (B_G if bottom else B_C))[0]
        status = ordinal_status(calls, c_pos.shape[0], np_thresh)
        mask = np.full(lseq, ord("E"), dtype=np.uint8)
        mask[c_pos] = status[::-1] if bottom else status

        fc = int(sub_cols[r, 6]) & 0xFFFFFFFF
        if n_cigar[r] == 1 and (fc & 0xF) in (0, 7, 8):
            seq_adj = seq[: fc >> 4]
            mask_adj = mask[: fc >> 4]
        else:
            words = np.frombuffer(buf, dtype="<u4", count=int(n_cigar[r]),
                                  offset=int(sub_offs[r, 1]))
            norm = _normalize_cigar(seq, words, stats)
            if norm is None:
                stats.nr_invalid += 1
                continue
            seq_adj, gidx, iscopy = norm
            if gidx is None:
                mask_adj = seq_adj  # empty
            else:
                mask_adj = np.where(iscopy, mask[gidx] if mask.size else 0,
                                    ord("N")).astype(np.uint8)
        res = np_call_read_arr(seq_adj, mask_adj, int(pos0[r]) + 1, bottom,
                               calls.np_dot, loci, site_base, clip=clip)
        if res is None:
            stats.nr_empty += 1
            continue
        if len(res[1]) < min_cpg:
            stats.nr_short += 1
            continue
        starts_out.append(res[0])
        patterns_out.append(res[1])
        if with_qname:
            lq = int(sub_cols[r, 7])
            q0 = int(sub_offs[r, 0])
            q_out.append(bytes(bufarr[q0:q0 + lq - 1]).decode())

    return rows_to_frags(np.array(starts_out, dtype=np.int64), patterns_out,
                         chrom_name, q_out if with_qname else None)
