"""The .tbi index of a BGZF bed: the port's copy of
wgbs_tools_tpu/formats/csi.py's `write_tbi` and what it calls (`reg2bin`,
`_bin_parent`, `_bin_first`, `_compress_binning`), with the same names.

The reference indexes bed files with external `tabix -p bed`
(ref: src/python/index.py:20-29,85-95); `write_tbi` emits the same layout
(htslib binning, min_shift=14, depth=5, plus the 16 kb linear index).
"""

import struct

import numpy as np

from .bgzf import BgzfWriter

MIN_SHIFT = 14
DEPTH = 5


def reg2bin(beg, end):
    """htslib hts_reg2bin for min_shift=14, depth=5 (vectorized)."""
    beg = np.asarray(beg, dtype=np.int64)
    end = np.asarray(end, dtype=np.int64) - 1
    out = np.zeros(beg.shape, dtype=np.int64)
    done = np.zeros(beg.shape, dtype=bool)
    s = MIN_SHIFT
    t = ((1 << (DEPTH * 3)) - 1) // 7
    for l in range(DEPTH, 0, -1):
        hit = (~done) & ((beg >> s) == (end >> s))
        out[hit] = t + (beg[hit] >> s)
        done |= hit
        s += 3
        t -= 1 << ((l - 1) * 3)
    return out


TBI_MAGIC = b"TBI\x01"
TBX_UCSC = 0x10000  # tabix -p bed preset (0-based half-open begin/end)


def write_tbi(path, chrom_names, rec_chrom_ids, rec_begs, rec_ends,
              rec_voffs, rec_voff_ends, preset=TBX_UCSC, cols=(1, 2, 3),
              meta="#", skip=0):
    """Write an htslib-compatible .tbi index (tabix spec) for a BGZF bed.

    The reference indexes bed files with external `tabix -p bed`
    (ref: src/python/index.py:20-29,85-95); this emits the same layout
    natively: per-ref binning (min_shift=14, depth=5 — the classic BAI
    scheme) plus the 16kb linear index.
    """
    rec_chrom_ids = np.asarray(rec_chrom_ids)
    rec_begs = np.asarray(rec_begs, dtype=np.int64)
    rec_ends = np.asarray(rec_ends, dtype=np.int64)
    rec_voffs = np.asarray(rec_voffs, dtype=np.uint64)
    rec_voff_ends = np.asarray(rec_voff_ends, dtype=np.uint64)
    bins_per = reg2bin(rec_begs, rec_ends)
    n_ref = len(chrom_names)

    body = bytearray()
    body += TBI_MAGIC
    names_blob = b"".join(c.encode() + b"\x00" for c in chrom_names)
    body += struct.pack("<8i", n_ref, preset, cols[0], cols[1], cols[2],
                        ord(meta), skip, len(names_blob))
    body += names_blob
    for rid in range(n_ref):
        sel = rec_chrom_ids == rid
        if not sel.any():
            body += struct.pack("<ii", 0, 0)
            continue
        rbins = bins_per[sel]
        rvo = rec_voffs[sel]
        rve = rec_voff_ends[sel]
        rb = rec_begs[sel]
        re_ = rec_ends[sel]
        bins = _compress_binning(rbins, rvo, rve)
        # htslib's metadata pseudo-bin: ref voff span + record counts
        bins[META_BIN] = [(int(rvo[0]), int(rve[-1])), (int(sel.sum()), 0)]
        body += struct.pack("<i", len(bins))
        for b in sorted(bins):
            chunks = bins[b]
            body += struct.pack("<Ii", int(b), len(chunks))
            for cs, ce in chunks:
                body += struct.pack("<QQ", cs, ce)
        # 16kb linear index: per window, the first (smallest) voff of any
        # record overlapping it; unset windows forward-fill, leading
        # windows take the first record's voff (htslib/tabix behavior)
        n_intv = int(((re_.max() - 1) >> 14) + 1)
        win0 = (rb >> 14).astype(np.int64)
        win1 = ((re_ - 1) >> 14).astype(np.int64)
        unset = np.uint64(0xFFFFFFFFFFFFFFFF)
        lidx = np.full(n_intv, unset, dtype=np.uint64)
        np.minimum.at(lidx, win0, rvo)
        for j in np.nonzero(win1 > win0)[0]:
            sl = slice(win0[j], win1[j] + 1)
            lidx[sl] = np.minimum(lidx[sl], rvo[j])
        have = lidx != unset
        last_set = np.maximum.accumulate(
            np.where(have, np.arange(n_intv), -1))
        first_val = lidx[np.nonzero(have)[0][0]]
        lidx = np.where(last_set >= 0, lidx[np.maximum(last_set, 0)],
                        first_val)
        body += struct.pack("<i", n_intv)
        body += lidx.astype("<u8").tobytes()
    with BgzfWriter(path) as w:
        w.write(bytes(body))
    return path


_MIN_MARKER_DIST = 1 << 16  # htslib HTS_MIN_MARKER_DIST (compressed bytes)
META_BIN = 37450  # htslib metadata pseudo-bin id for min_shift=14, depth=5


def _bin_parent(b):
    return (b - 1) >> 3


def _bin_first(level):
    return ((1 << (3 * level)) - 1) // 7


def _compress_binning(rbins, rvo, rve):
    """htslib-equivalent index compaction (hts.c::compress_binning):

    1. deepest-to-shallowest, a bin whose chunks span < 64 KiB of
       compressed bytes merges into its parent bin (only if the parent
       already exists);
    2. chunks that start in the same (or an earlier) BGZF block as the
       previous chunk's end merge together.
    Returns {bin: [(voff_beg, voff_end), ...]} with sorted chunk lists.
    """
    bins = {}
    order = np.argsort(rbins, kind="stable")
    sb = rbins[order]
    svo = rvo[order].astype(np.uint64)
    sve = rve[order].astype(np.uint64)
    uniq, bin_start = np.unique(sb, return_index=True)
    bounds = np.concatenate([bin_start, [sb.shape[0]]])
    for k in range(uniq.shape[0]):
        lo, hi = int(bounds[k]), int(bounds[k + 1])
        bins[int(uniq[k])] = [[int(svo[j]), int(sve[j])]
                              for j in range(lo, hi)]
    for level in range(DEPTH, 0, -1):
        start = _bin_first(level)
        stop = _bin_first(level + 1)
        for b in [b for b in bins if start <= b < stop]:
            chunks = bins[b]
            if level < DEPTH and len(chunks) > 1:
                chunks.sort()
            if (int(chunks[-1][1]) >> 16) - (int(chunks[0][0]) >> 16) \
                    < _MIN_MARKER_DIST:
                parent = _bin_parent(b)
                if parent not in bins:
                    continue
                bins[parent].extend(chunks)
                del bins[b]
    if 0 in bins:
        bins[0].sort()
    out = {}
    for b, chunks in bins.items():
        merged = [chunks[0][:]]
        for cs, ce in chunks[1:]:
            if (int(merged[-1][1]) >> 16) >= (int(cs) >> 16):
                if merged[-1][1] < ce:
                    merged[-1][1] = ce
            else:
                merged.append([cs, ce])
        out[b] = [(int(cs), int(ce)) for cs, ce in merged]
    return out
