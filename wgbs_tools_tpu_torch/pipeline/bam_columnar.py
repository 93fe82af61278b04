"""Columnar bam2pat fast path.

The port's copy of wgbs_tools_tpu/pipeline/bam_columnar.py, with the same
names. Decodes and calls reads without per-record Python objects: the
host library's scan (host/wgbsio.cpp::bam_scan) yields columnar arrays,
sequences are materialized with one fancy gather + 4-bit LUT expansion,
qname pairing uses np.unique over fixed-width name bytes, and calling and
merging go through the batch kernels. Reads with non-trivial CIGARs take
the per-read normalizer.

Where JAX decides by WGBS_TPU_DEVICE_CALLING and an h2d bandwidth probe
(use_device_calling), the port is told: `device` is the torch device that
calls and merges (ops/calling.py's kernels on cuda, their twins on the
CPU), or None for numpy on the host (--device cpu, --mbias).
"""

import numpy as np

from ..device import timed
from ..utils import outer_add
from .bam import _PAIR_LUT, CIGAR_OPS
from .calling import call_reads_mat, clean_cigar, merge_pe_batch, merge_pe_mat


def _bgzf_block_len(hdr18):
    """Compressed length of the BGZF block whose first 18 bytes are hdr18
    (BSIZE-1 lives in the BC extra subfield at bytes 16:18)."""
    import struct

    return struct.unpack_from("<H", hdr18, 16)[0] + 1


def _read_bam_range(path, byte_range):
    """Decompressed header + the record bytes of a BAI virtual-offset
    range [v_start, v_end) — the per-worker input slice of the
    multi-process bam2pat (the analogue of the reference's per-chromosome
    `samtools view` seeks, ref: bam2pat.py:144-209).

    v_start/v_end are BAI virtual offsets ((coffset << 16) | uoffset);
    v_end None = EOF. Both must point at record boundaries (BAI linear /
    chunk offsets do). Returns (buf, pos) with records starting at pos,
    or None when the file is not BGZF.
    """
    import struct

    from ..native import bgzf_decompress_native

    v_start, v_end = byte_range
    with open(path, "rb") as f:
        # header: read + decompress blocks until the full header section
        # (magic .. ref list) parses; alignment bytes in the final block
        # are dropped
        raw_hdr = b""
        hdr = None
        while True:
            chunk = f.read(256 << 10)
            if not raw_hdr and chunk[:2] != b"\x1f\x8b":
                return None
            raw_hdr += chunk
            # keep only whole blocks
            end = 0
            while end + 18 <= len(raw_hdr):
                bl = _bgzf_block_len(raw_hdr[end : end + 18])
                if end + bl > len(raw_hdr):
                    break
                end += bl
            if end == 0 and not chunk:
                return None
            dec = bgzf_decompress_native(raw_hdr[:end])
            if dec is not None and len(dec) >= 12 and dec[:4] == b"BAM\x01":
                (l_text,) = struct.unpack_from("<i", dec, 4)
                pos = 8 + l_text
                if len(dec) >= pos + 4:
                    (n_ref,) = struct.unpack_from("<i", dec, pos)
                    pos += 4
                    ok = True
                    for _ in range(n_ref):
                        if len(dec) < pos + 4:
                            ok = False
                            break
                        (l_name,) = struct.unpack_from("<i", dec, pos)
                        pos += 4 + l_name + 4
                    if ok and len(dec) >= pos:
                        hdr = dec[:pos]
                        break
            if not chunk:
                return None
        c0, u0 = v_start >> 16, v_start & 0xFFFF
        f.seek(c0)
        if v_end is None:
            body = bgzf_decompress_native(f.read())
            if body is None:
                return None
            body = body[u0:]
        else:
            c1, u1 = v_end >> 16, v_end & 0xFFFF
            mid_raw = f.read(max(c1 - c0, 0))
            tail = b""
            if u1:
                h18 = f.read(18)
                if len(h18) == 18:
                    bl = _bgzf_block_len(h18)
                    blk = bgzf_decompress_native(h18 + f.read(bl - 18))
                    if blk is None:
                        return None
                    tail = blk[:u1]
            mid = bgzf_decompress_native(mid_raw) if mid_raw else b""
            if mid is None:
                return None
            body = (mid + tail)[u0:] if c1 > c0 else tail[u0:]
    return hdr + body, len(hdr)


def scan_bam_columnar(path, byte_range=None):
    """(buf, header info, cols, offs, rec_end), or None when the file is not
    a BGZF (or plain) BAM whose records scan: the record path takes it.

    byte_range: optional (v_start, v_end) BAI virtual-offset pair — only
    that record range (plus the header) is decompressed and scanned
    (_read_bam_range).
    """
    import struct

    from ..native import bam_scan_native, bgzf_decompress_native

    if byte_range is not None:
        got = _read_bam_range(path, byte_range)
        if got is None:
            return None
        buf, _pos = got
    else:
        with open(path, "rb") as f:
            raw = f.read()
        buf = bgzf_decompress_native(raw) if raw[:2] == b"\x1f\x8b" else raw
    if buf is None or buf[:4] != b"BAM\x01":
        return None
    (l_text,) = struct.unpack_from("<i", buf, 4)
    header_text = buf[8 : 8 + l_text].decode(errors="replace")
    pos = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buf, pos)
    pos += 4
    ref_names, ref_lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        ref_names.append(buf[pos : pos + l_name - 1].decode())
        pos += l_name
        ref_lengths.append(struct.unpack_from("<i", buf, pos)[0])
        pos += 4
    scanned = bam_scan_native(buf, pos)
    if scanned is None:
        return None
    cols, offs, rec_end = scanned
    return buf, header_text, ref_names, ref_lengths, cols, offs, rec_end


_M_OP = CIGAR_OPS.index("M")


def decode_and_call(buf, bufarr, cols, offs, idx_rows, loci, site_base,
                    paired, clip, stats, mbias=None, need_qnames=False,
                    device=None, chrom=None, timings=None):
    """Decode + CIGAR-normalize + methylation-call one batch of reads.

    Rows are processed in (stable) position-sorted order. Returns
    (starts, patmat, span, qnames|None, bad) where starts < 0 marks reads
    with no CpG call (counted nr_empty unless `bad`, i.e. invalid CIGAR).
    Shared by the whole-chromosome columnar path and the bounded-memory
    slab-streaming path (pipeline/bam_stream.py). The reads call on
    `device` (call_reads_device; `chrom` keeps its loci there), or with
    numpy when `device` is None or `mbias` counts; with `timings`, the
    seconds of "decode" and "call" accumulate there."""
    with timed(timings, "decode", None):
        decoded = _decode(buf, bufarr, cols, offs, idx_rows, stats)
    chars, lens, sub_cols, sub_offs, bad = decoded
    flags = sub_cols[:, 2].astype(np.int64)
    pos1 = sub_cols[:, 1].astype(np.int64) + 1
    if device is not None and mbias is None:
        from ..ops.calling import call_reads_device

        with timed(timings, "call", device):
            starts, patmat, span = call_reads_device(
                pos1, flags, paired, loci, site_base, chars, lens, clip=clip,
                device=device, chrom=chrom, timings=timings)
    else:
        with timed(timings, "call", None):
            starts, patmat, span = call_reads_mat(pos1, flags, paired, loci,
                                                  site_base, chars, lens,
                                                  clip=clip, mbias=mbias)
    has = starts >= 0
    stats.nr_empty += int((~has & ~bad).sum())

    # qnames (needed for pairing / --long output)
    qnames = None
    if paired or need_qnames:
        lq = sub_cols[:, 7].astype(np.int64)
        LQ = max(int(lq.max(initial=1)), 1)
        qidx = np.minimum(outer_add(sub_offs[:, 0], LQ),
                          bufarr.shape[0] - 1)
        qmat = bufarr[qidx].copy()
        qmat[np.arange(LQ)[None, :] >= (lq - 1)[:, None]] = 0
        qnames = qmat.view(f"S{LQ}").ravel()
    return starts, patmat, span, qnames, bad


def _decode(buf, bufarr, cols, offs, idx_rows, stats):
    """The batch's CIGAR-normalized (R, L) sequence matrix, zero past each
    read: (chars, lens, sub_cols, sub_offs, bad), rows in (stable)
    position-sorted order, `bad` marking invalid CIGARs (len 0)."""
    sub_cols = cols[idx_rows]
    sub_offs = offs[idx_rows]
    order = np.argsort(sub_cols[:, 1], kind="stable")
    sub_cols = sub_cols[order]
    sub_offs = sub_offs[order]
    R = sub_cols.shape[0]
    stats.nr_lines += R

    l_seq = sub_cols[:, 4].astype(np.int64)
    n_cigar = sub_cols[:, 5]
    first_cigar = sub_cols[:, 6].astype(np.int64) & 0xFFFFFFFF
    simple = (n_cigar == 1) & ((first_cigar & 0xF) == _M_OP) & (
        (first_cigar >> 4) == l_seq
    )

    # sequence matrix: vectorized decode for simple reads
    nb = (l_seq + 1) // 2
    NBmax = max(int(nb.max(initial=1)), 1)
    gidx = np.minimum(outer_add(sub_offs[:, 2], NBmax), bufarr.shape[0] - 1)
    chars = _PAIR_LUT[bufarr[gidx]].view(np.uint8).reshape(R, 2 * NBmax)
    lens = l_seq.copy()

    # complex CIGARs: per-read normalization (rare)
    complex_rows = np.nonzero(~simple)[0]
    widened = None
    bad = np.zeros(R, dtype=bool)
    for r in complex_rows:
        n_c = int(n_cigar[r])
        co = int(sub_offs[r, 1])
        cigar_words = np.frombuffer(buf, dtype="<u4", count=n_c, offset=co)
        cigar = [(CIGAR_OPS[w & 0xF], int(w) >> 4) for w in cigar_words]
        raw = chars[r, : l_seq[r]].tobytes()
        try:
            adj = clean_cigar(raw, cigar)
        except Exception:
            stats.nr_invalid += 1
            bad[r] = True
            lens[r] = 0
            continue
        lens[r] = len(adj)
        if len(adj) > chars.shape[1]:
            if widened is None:
                widened = {}
            widened[r] = adj
        else:
            chars[r, : len(adj)] = np.frombuffer(adj, dtype=np.uint8)
            chars[r, len(adj) : max(int(l_seq[r]), len(adj))] = 0
    if widened:
        newL = max(len(a) for a in widened.values())
        grow = np.zeros((R, newL), dtype=np.uint8)
        grow[:, : chars.shape[1]] = chars
        chars = grow
        for r, adj in widened.items():
            chars[r, : len(adj)] = np.frombuffer(adj, dtype=np.uint8)

    cols_mask = np.arange(chars.shape[1])[None, :]
    chars[cols_mask >= lens[:, None]] = 0
    return chars, lens, sub_cols, sub_offs, bad


def process_chrom_columnar(buf, bufarr, cols, offs, idx_rows, loci, site_base,
                           chrom_name, paired, clip, min_cpg, stats,
                           with_qname, mbias=None, device=None,
                           timings=None):
    """Call + pair one chromosome's reads (row indices into cols/offs), the
    calling and merging on `device` (None: numpy on the host)."""
    starts, patmat, span, qnames, bad = decode_and_call(
        buf, bufarr, cols, offs, idx_rows, loci, site_base, paired, clip,
        stats, mbias=mbias, need_qnames=with_qname, device=device,
        chrom=chrom_name, timings=timings)
    has = starts >= 0
    R = starts.shape[0]

    if with_qname:
        return _emit_with_qnames(starts, patmat, span, qnames, paired,
                                 min_cpg, stats, chrom_name)

    if not paired:
        out_starts, out_pat, out_span = (starts[has], patmat[has], span[has])
    else:
        # mates: first two occurrences of each qname pair up, in row order
        # (same as the streaming qname-dict of the record path); a trailing
        # odd occurrence stays single
        _, inv = np.unique(qnames, return_inverse=True)
        ordq = np.argsort(inv, kind="stable")
        inv_s = inv[ordq]
        newgrp = np.empty(R, dtype=bool)
        newgrp[0] = True
        newgrp[1:] = inv_s[1:] != inv_s[:-1]
        pos_in = np.arange(R) - np.maximum.accumulate(
            np.where(newgrp, np.arange(R), 0))
        second = (pos_in & 1) == 1
        b_rows = ordq[second]
        a_rows = ordq[np.nonzero(second)[0] - 1]
        stats.nr_pairs += int(b_rows.size)
        nxt_new = np.empty(R, dtype=bool)
        nxt_new[:-1] = newgrp[1:]
        nxt_new[-1] = True
        single_rows = ordq[~second & nxt_new]

        hasA, hasB = has[a_rows], has[b_rows]
        both = hasA & hasB
        am, bm = a_rows[both], b_rows[both]
        m_starts, m_pat, m_span, too_long = merge_mates(
            starts[am], patmat[am], span[am], starts[bm], patmat[bm],
            span[bm], device, timings)
        stats.nr_invalid += 2 * int(too_long.sum())
        ok = m_starts >= 0
        one_rows = np.concatenate([
            a_rows[hasA & ~hasB],
            b_rows[~hasA & hasB],
            single_rows[has[single_rows]],
        ])
        W = max(m_pat.shape[1], patmat.shape[1], 1)

        def padW(p):
            if p.shape[1] == W:
                return p
            out = np.full((p.shape[0], W), ord("."), dtype=np.uint8)
            out[:, : p.shape[1]] = p
            return out

        out_starts = np.concatenate([m_starts[ok], starts[one_rows]])
        out_pat = np.vstack([padW(m_pat[ok]), padW(patmat[one_rows])])
        out_span = np.concatenate([m_span[ok], span[one_rows]])

    if min_cpg > 1:
        short = out_span < min_cpg
        stats.nr_short += int(short.sum())
        keep = ~short
        out_starts, out_pat, out_span = (out_starts[keep], out_pat[keep],
                                         out_span[keep])
    return _mat_to_frags(out_starts, out_pat, out_span, chrom_name)


def merge_mates(s1, pat1, sp1, s2, pat2, sp2, device, timings=None):
    """merge_pe_mat's outputs, from the merge_pe kernel on `device` or
    numpy on the host (device None); seconds under "merge"."""
    if device is not None:
        from ..ops.calling import merge_pe_device

        return merge_pe_device(s1, pat1, sp1, s2, pat2, sp2, device=device,
                               timings=timings)
    with timed(timings, "merge", None):
        return merge_pe_mat(s1, pat1, sp1, s2, pat2, sp2)


def _mat_to_frags(starts, patmat, span, chrom_name):
    from ..formats.pat import _ENCODE_LUT, PatFrags, empty_frags

    n = starts.shape[0]
    if n == 0:
        return empty_frags()
    return PatFrags(
        starts.astype(np.int32),
        span.astype(np.int32),
        np.ones(n, dtype=np.int32),
        _ENCODE_LUT[patmat],
        np.zeros(n, dtype=np.int16),
        [chrom_name],
    )


def _emit_with_qnames(starts, patmat, span, qnames, paired, min_cpg, stats,
                      chrom_name):
    """--long output path: per-read tuples so each row keeps its qname."""
    from .calling import rows_to_frags

    R = starts.shape[0]
    results = [None] * R
    for r in np.nonzero(starts >= 0)[0]:
        results[r] = (int(starts[r]), bytes(patmat[r, : span[r]]))

    starts_out, patterns_out, qnames_out = [], [], []

    def emit(res, q):
        if res is None:
            return
        if len(res[1]) < min_cpg:
            stats.nr_short += 1
            return
        starts_out.append(res[0])
        patterns_out.append(res[1])
        qnames_out.append(q.decode() if isinstance(q, bytes) else q)

    if not paired:
        for r in range(R):
            emit(results[r], qnames[r])
    else:
        _, inv = np.unique(qnames, return_inverse=True)
        first_of = {}
        pair_list = []
        for r in range(R):
            q = int(inv[r])
            if q in first_of:
                pair_list.append((first_of.pop(q), r))
                stats.nr_pairs += 1
            else:
                first_of[q] = r
        merged = merge_pe_batch(
            [(results[a], results[b]) for a, b in pair_list]
        )
        for (a, b), m in zip(pair_list, merged):
            if isinstance(m, ValueError):
                stats.nr_invalid += 2
            else:
                emit(m, qnames[b])
        for q, r in first_of.items():
            emit(results[r], qnames[r])

    return rows_to_frags(np.array(starts_out, dtype=np.int64), patterns_out,
                         chrom_name, qnames_out)
