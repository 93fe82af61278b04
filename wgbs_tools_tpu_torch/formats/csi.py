"""The .csi index of a pat.gz and the .tbi index of a BGZF bed: the port's
copy of wgbs_tools_tpu/formats/csi.py's `write_csi`, `CsiAccumulator`,
`write_tbi` and what they call (`reg2bin`, `_bin_parent`, `_bin_first`,
`_compress_binning`), with the same names.

The reference indexes pat files with external `tabix -C -b 2 -e 2` and
bed files with `tabix -p bed` (ref: src/python/index.py:20-29,85-95,
126-139); these emit the same layouts (htslib binning, min_shift=14,
depth=5; the CSI v1 layout with tabix's aux header, each pat record
covering the single base [start-1, start) of its startCpG column; the
.tbi with the 16 kb linear index).
"""

import struct

import numpy as np

from .bgzf import BgzfWriter

MIN_SHIFT = 14
DEPTH = 5
TBX_PRESET = 0  # generic
CSI_MAGIC = b"CSI\x01"


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


def write_csi(path, chrom_names, rec_chrom_ids, rec_begs, rec_voffs,
              rec_voff_ends):
    """Write <path> (BGZF-wrapped CSI).

    rec_chrom_ids: int per record (index into chrom_names, grouped);
    rec_begs: 0-based begin coordinate per record; rec_voffs/_ends: virtual
    offset range of each record's bytes in the data file.
    """
    n_ref = len(chrom_names)
    rec_chrom_ids = np.asarray(rec_chrom_ids)
    rec_begs = np.asarray(rec_begs, dtype=np.int64)
    bins_per_rec = reg2bin(rec_begs, rec_begs + 1)

    body = bytearray()
    body += CSI_MAGIC
    body += struct.pack("<ii", MIN_SHIFT, DEPTH)
    names_blob = b"".join(c.encode() + b"\x00" for c in chrom_names)
    aux = struct.pack("<7i", TBX_PRESET, 1, 2, 2, ord("#"), 0,
                      len(names_blob)) + names_blob
    body += struct.pack("<i", len(aux)) + aux
    body += struct.pack("<i", n_ref)

    rec_voffs = np.asarray(rec_voffs, dtype=np.uint64)
    rec_voff_ends = np.asarray(rec_voff_ends, dtype=np.uint64)
    for rid in range(n_ref):
        sel = rec_chrom_ids == rid
        if not sel.any():
            body += struct.pack("<i", 0)
            continue
        rbins = bins_per_rec[sel]
        rvo = rec_voffs[sel]
        rve = rec_voff_ends[sel]
        order = np.argsort(rbins, kind="stable")
        rbins, rvo, rve = rbins[order], rvo[order], rve[order]
        # group into bins; records within a bin stay in file order, so
        # adjacent chunks merge when contiguous. Every CSI record (bin
        # header and chunk alike) is 16 bytes, so the whole ref section is
        # assembled as one (n_bins + n_chunks, 16) byte matrix.
        uniq, bin_start = np.unique(rbins, return_index=True)
        n_bins = uniq.shape[0]
        body += struct.pack("<i", n_bins)
        new_bin = np.zeros(rbins.shape[0], dtype=bool)
        new_bin[bin_start] = True
        chunk_start = new_bin | np.concatenate(
            [[True], rvo[1:] != rve[:-1]])
        cs_idx = np.nonzero(chunk_start)[0]
        ce_idx = np.concatenate([cs_idx[1:] - 1, [rbins.shape[0] - 1]])
        n_chunk = np.add.reduceat(chunk_start.astype(np.int64), bin_start)

        hdr = np.zeros(n_bins, dtype=np.dtype(
            [("bin", "<u4"), ("loff", "<u8"), ("n", "<i4")]))
        hdr["bin"] = uniq
        hdr["loff"] = rvo[bin_start]
        hdr["n"] = n_chunk
        chunks = np.zeros(cs_idx.shape[0], dtype=np.dtype(
            [("cs", "<u8"), ("ce", "<u8")]))
        chunks["cs"] = rvo[cs_idx]
        chunks["ce"] = rve[ce_idx]

        rows = np.empty((n_bins + chunks.shape[0], 16), dtype=np.uint8)
        hdr_pos = np.arange(n_bins) + np.concatenate(
            [[0], np.cumsum(n_chunk)[:-1]])
        rows[hdr_pos] = hdr.view(np.uint8).reshape(n_bins, 16)
        mask = np.ones(rows.shape[0], dtype=bool)
        mask[hdr_pos] = False
        rows[mask] = chunks.view(np.uint8).reshape(-1, 16)
        body += rows.tobytes()

    with BgzfWriter(path) as w:
        w.write(bytes(body))
    return path


class CsiAccumulator:
    """Incremental CSI construction for streaming writers.

    write_csi needs every record's (chrom, beg, voff) at once — ~10 GB of
    arrays for a genome-wide pat. Coordinate-sorted pat records land in the
    deepest bin level (1-bp intervals), so bins arrive in non-decreasing
    order per chromosome and each (chrom, bin) collapses to a handful of
    merged chunks: the accumulator folds each flushed batch into a per-bin
    chunk dict (~genome/16kb entries) and emits the same CSI layout at
    close. Mirrors the reference's `tabix -C` over a streamed bgzip
    (ref: src/python/index.py:126-139)."""

    def __init__(self):
        # (rid, bin) -> [loff, [ [cs, ce], ... ]] in first-seen file order
        self._bins = {}

    def add(self, rec_chrom_ids, rec_begs, rec_voffs, rec_voff_ends):
        rec_chrom_ids = np.asarray(rec_chrom_ids)
        rec_begs = np.asarray(rec_begs, dtype=np.int64)
        rec_voffs = np.asarray(rec_voffs, dtype=np.uint64)
        rec_voff_ends = np.asarray(rec_voff_ends, dtype=np.uint64)
        bins = reg2bin(rec_begs, rec_begs + 1)
        # group consecutive records with the same (rid, bin): within a batch
        # records are file-contiguous, so each run is one chunk
        key_change = np.ones(rec_begs.shape[0], dtype=bool)
        key_change[1:] = (bins[1:] != bins[:-1]) | (
            rec_chrom_ids[1:] != rec_chrom_ids[:-1])
        starts = np.nonzero(key_change)[0]
        ends = np.concatenate([starts[1:], [rec_begs.shape[0]]])
        for s, e in zip(starts.tolist(), ends.tolist()):
            key = (int(rec_chrom_ids[s]), int(bins[s]))
            cs, ce = int(rec_voffs[s]), int(rec_voff_ends[e - 1])
            ent = self._bins.get(key)
            if ent is None:
                self._bins[key] = [cs, [[cs, ce]]]
            else:
                chunks = ent[1]
                if chunks[-1][1] == cs:
                    chunks[-1][1] = ce
                else:
                    chunks.append([cs, ce])

    def write(self, path, chrom_names):
        n_ref = len(chrom_names)
        body = bytearray()
        body += CSI_MAGIC
        body += struct.pack("<ii", MIN_SHIFT, DEPTH)
        names_blob = b"".join(c.encode() + b"\x00" for c in chrom_names)
        aux = struct.pack("<7i", TBX_PRESET, 1, 2, 2, ord("#"), 0,
                          len(names_blob)) + names_blob
        body += struct.pack("<i", len(aux)) + aux
        body += struct.pack("<i", n_ref)
        by_rid = {}
        for (rid, b), ent in self._bins.items():
            by_rid.setdefault(rid, []).append((b, ent))
        for rid in range(n_ref):
            ents = sorted(by_rid.get(rid, []))
            body += struct.pack("<i", len(ents))
            for b, (loff, chunks) in ents:
                body += struct.pack("<IQi", b, loff, len(chunks))
                for cs, ce in chunks:
                    body += struct.pack("<QQ", cs, ce)
        with BgzfWriter(path) as w:
            w.write(bytes(body))
        return path


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
