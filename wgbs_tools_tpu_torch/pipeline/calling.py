"""Methylation calling: aligned reads -> pat fragments.

The port's copy of wgbs_tools_tpu/pipeline/calling.py, with the same
names; `call_reads_batch` and `call_records` take a `device` on which to
call (ops/calling.py::call_reads_device), None for numpy on the host.

Exact reimplementation of the reference's patter calling rules
(ref: src/pipeline_wgbs/patter.cpp:105-184, patter_utils.cpp:209-342):

- CIGAR normalization: M/=/X copy, D/N insert 'N', I/S drop, H ignore.
- Orientation: OT reads compare the C position against {C->meth, T->unmeth};
  OB (bottom) reads compare the G position (+1 shift) against
  {G->meth, A->unmeth}; the read must itself show a CpG-compatible
  dinucleotide (is_cpg) else the site is unknown.
- `clip` first/last bases are forced unknown; the pattern spans the first
  through last known call over consecutive CpG indices.
- Paired-end mates merge site-wise; disagreements become unknown
  (patter_utils.cpp:292-342); merged reads longer than MAX_PE_PAT_LEN are
  invalid.
"""

import numpy as np

from ..formats.pat import PatFrags
from ..utils import logger
from .bam import FREVERSE

MAX_PE_PAT_LEN = 300  # ref: patter_utils.h:21

B_C, B_G, B_T, B_A = ord("C"), ord("G"), ord("T"), ord("A")


class ReadStats:
    """First-class per-shard read accounting (ref: patter.cpp:298-316)."""

    def __init__(self):
        self.nr_lines = 0
        self.nr_pairs = 0
        self.nr_empty = 0
        self.nr_short = 0
        self.nr_invalid = 0
        self.nr_bad_conv = 0

    def snapshot(self):
        out = ReadStats()
        out.__dict__.update(self.__dict__)
        return out

    def summary(self, chrom="", since=None):
        """Per-chromosome summary; `since` subtracts an earlier snapshot so
        multi-chromosome runs report per-chromosome counts like the
        reference's per-process patter does (ref: patter.cpp:298-316)."""
        d = dict(self.__dict__)
        if since is not None:
            d = {k: v - since.__dict__[k] for k, v in d.items()}
        good = d["nr_lines"] - d["nr_empty"] - d["nr_invalid"]
        rate = (100.0 * (1 - d["nr_invalid"] / d["nr_lines"])
                if d["nr_lines"] else 0)
        return (f"[ {chrom} ] finished {d['nr_lines']:,} lines. "
                f"({d['nr_pairs']:,} pairs). {good:,} good, "
                f"{d['nr_empty']:,} empty, {d['nr_short']:,} short, "
                f"{d['nr_invalid']:,} invalid. (success {rate:.0f}%)")


def clean_cigar(seq: bytes, cigar) -> bytes:
    """ref: patter_utils.cpp:209-251."""
    if len(cigar) == 1 and cigar[0][0] in "M=X":
        return seq[: cigar[0][1]]
    out = bytearray()
    pos = 0
    for op, num in cigar:
        if op in ("M", "=", "X"):
            out += seq[pos : pos + num]
            pos += num
        elif op in ("D", "N"):
            out += b"N" * num
        elif op in ("I", "S"):
            pos += num
        elif op == "H":
            continue
        else:
            raise ValueError(f"Unknown CIGAR character: {op}")
    return bytes(out)


def is_bottom(flag, paired):
    """ref: patter_utils.cpp:163-168."""
    if paired:
        return (flag & 0x53) == 83 or (flag & 0xA3) == 163
    return bool(flag & FREVERSE)


def passes_bisulfite_conversion(seq_adj: bytes, ref_slice: bytes, bottom,
                                margin=3, min_ch=3, min_rate=0.9):
    """Blueprint conversion filter: require >= min_rate of non-CpG cytosines
    to be bisulfite-converted (ref: src/pipeline_wgbs/blueprint/
    patter.cpp:104-142, margin=3)."""
    seq = np.frombuffer(seq_adj, dtype=np.uint8)
    ref = np.frombuffer(ref_slice, dtype=np.uint8)
    n = min(seq.shape[0], ref.shape[0])
    if n < 2:
        return False
    j = np.arange(n)
    in_margin = (j < margin) | (j >= seq.shape[0] - margin)
    if bottom:
        ch = (ref == B_G) & (j >= 1)
        ch &= np.concatenate([[False], ref[:-1] != B_C])[:n]
        conv = ch & (seq[:n] == B_A) & ~in_margin
        nonconv = ch & (seq[:n] == B_G) & ~in_margin
    else:
        ch = (ref == B_C) & (j < n - 1)
        nxt = np.concatenate([ref[1:], [0]])[:n]
        ch &= nxt != B_G
        conv = ch & (seq[:n] == B_T) & ~in_margin
        nonconv = ch & (seq[:n] == B_C) & ~in_margin
    nr_conv = int(conv.sum())
    nr_ch = nr_conv + int(nonconv.sum())
    if nr_ch < min_ch:
        return False
    return nr_conv / nr_ch >= min_rate


def call_read(seq: bytes, start_locus: int, flag: int, paired: bool,
              loci: np.ndarray, site_base: int, clip: int = 0,
              mbias=None, check_cpg=True, acc_end_guard=False):
    """Call one CIGAR-normalized read.

    loci: sorted 1-based C positions of the chromosome's CpG sites;
    site_base: global 1-based site index of loci[0].
    Returns (start_site, pattern bytes) or None if the read covers no
    known-call CpG.

    check_cpg=False / acc_end_guard=True reproduce the add_cpg_counts
    binary's divergences from patter: it never verifies the read-side CpG
    context (no is_cpg(seq, j, ro) — add_cpg_counts.cpp:162-205 vs
    patter.cpp:149-151) and it drops a read wholesale when its start locus
    reaches the chromosome's last CpG (`start_locus + 1 > bsize - 1`,
    add_cpg_counts.cpp:183 — patter guards per position instead).
    """
    n = len(seq)
    if n == 0:
        return None
    if acc_end_guard and loci.shape[0] and start_locus >= int(loci[-1]) - 1:
        return None
    bottom = is_bottom(flag, paired)
    shift = 1 if bottom else 0
    ref_chr = B_G if bottom else B_C
    unmeth_chr = B_A if bottom else B_T

    k0 = int(np.searchsorted(loci, start_locus, side="left"))
    k1 = int(np.searchsorted(loci, start_locus + n, side="left"))
    if k1 <= k0:
        return None

    arr = np.frombuffer(seq, dtype=np.uint8)
    i = loci[k0:k1].astype(np.int64) - start_locus  # read-coords of the C
    j = i + shift
    jn = np.clip(j, 0, n - 1)
    s = arr[jn]

    if not check_cpg:
        iscpg = (j >= 0) & (j < n)
    elif bottom:
        prev = arr[np.clip(j - 1, 0, n - 1)]
        iscpg = (j > 0) & ((s == B_G) | (s == B_A)) & (prev == B_C)
    else:
        nxt = arr[np.clip(j + 1, 0, n - 1)]
        iscpg = (j < n - 1) & ((s == B_C) | (s == B_T)) & (nxt == B_G)

    calls = np.full(i.shape[0], ord("."), dtype=np.uint8)
    calls[iscpg & (s == unmeth_chr)] = ord("T")
    calls[iscpg & (s == ref_chr)] = ord("C")
    if clip > 0:
        clipped = ~((j >= clip) & (j < n - clip))
        calls[clipped] = ord(".")
    # positions where j is out of read bounds can never be valid calls
    calls[(j < 0) | (j >= n)] = ord(".")

    if mbias is not None:
        mbias.update(flag, paired, bottom, n, j, calls, iscpg)

    known = calls != ord(".")
    if not known.any():
        return None
    first = int(np.argmax(known))
    last = int(len(known) - 1 - np.argmax(known[::-1]))
    pattern = calls[first : last + 1].tobytes()
    return site_base + k0 + first, pattern


def merge_pe_batch(pairs):
    """Vectorized mate merging; same semantics as merge_pe per pair.

    pairs: list of (r1, r2) where each element is (start, pattern) | None.
    Returns list of merged (start, pattern) | None | ValueError (too-long).
    """
    out = [None] * len(pairs)
    idxs, s1s, s2s, p1s, p2s = [], [], [], [], []
    for i, (r1, r2) in enumerate(pairs):
        if r1 is None and r2 is None:
            continue
        if r1 is None or r2 is None:
            out[i] = r1 if r2 is None else r2
            continue
        if r1[0] > r2[0]:
            r1, r2 = r2, r1
        idxs.append(i)
        s1s.append(r1[0])
        s2s.append(r2[0])
        p1s.append(r1[1])
        p2s.append(r2[1])
    if not idxs:
        return out
    n = len(idxs)
    s1 = np.asarray(s1s, dtype=np.int64)
    s2 = np.asarray(s2s, dtype=np.int64)
    l1 = np.fromiter((len(p) for p in p1s), dtype=np.int64, count=n)
    l2 = np.fromiter((len(p) for p in p2s), dtype=np.int64, count=n)
    last = np.maximum(s1 + l1, s2 + l2)
    width = last - s1
    too_long = width > MAX_PE_PAT_LEN
    W = int(np.minimum(width, MAX_PE_PAT_LEN).max())
    A = np.full((n, W), ord("."), dtype=np.uint8)
    B = np.full((n, W), ord("."), dtype=np.uint8)
    cols = np.arange(W)[None, :]
    # place p1 at 0 and p2 at its offset
    for k, p in enumerate(p1s):
        if not too_long[k]:
            A[k, : len(p)] = np.frombuffer(p, dtype=np.uint8)
    off = s2 - s1
    for k, p in enumerate(p2s):
        if not too_long[k]:
            B[k, off[k] : off[k] + len(p)] = np.frombuffer(p, dtype=np.uint8)
    dot = ord(".")
    merged = np.where(A == dot, B,
                      np.where((B != dot) & (A != B), dot, A))
    in_range = cols < width[:, None]
    merged[~in_range] = dot
    rows = merged.view(f"S{W}").ravel()
    for k, i in enumerate(idxs):
        if too_long[k]:
            out[i] = ValueError("invalid pairing. merged read is too long")
            continue
        m = rows[k][: width[k]]
        stripped = m.strip(b".")
        if not stripped:
            out[i] = None
            continue
        lead = len(m) - len(m.lstrip(b"."))
        out[i] = (int(s1[k]) + lead, stripped)
    return out


def merge_pe_mat(s1, pat1, sp1, s2, pat2, sp2):
    """Array-native mate merging; same rules as `merge_pe` per row.

    Both sides must be present (start >= 0). Inputs are call matrices as
    returned by `call_reads_mat`, subset to the paired rows. Returns
    (start int64[n] (-1 = merged read all-unknown), patmat uint8[n, W]
    '.'-padded, span int64[n], too_long bool[n]); too_long rows are invalid
    (ref: patter_utils.cpp:292-342) and carry no pattern.
    """
    n = s1.shape[0]
    dot = ord(".")
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 1), np.uint8),
                np.zeros(0, np.int64), np.zeros(0, bool))
    S = max(pat1.shape[1], pat2.shape[1], 1)

    def pad(p):
        if p.shape[1] == S:
            return p
        out = np.full((p.shape[0], S), dot, dtype=np.uint8)
        out[:, : p.shape[1]] = p
        return out

    p1, p2 = pad(pat1), pad(pat2)
    swap = s1 > s2
    a_s = np.where(swap, s2, s1)
    b_s = np.where(swap, s1, s2)
    a_sp = np.where(swap, sp2, sp1)
    b_sp = np.where(swap, sp1, sp2)
    a_p = np.where(swap[:, None], p2, p1)
    b_p = np.where(swap[:, None], p1, p2)

    last = np.maximum(a_s + a_sp, b_s + b_sp)
    width = last - a_s
    too_long = width > MAX_PE_PAT_LEN
    W = int(np.minimum(width, MAX_PE_PAT_LEN).max(initial=1))
    cols = np.arange(W)[None, :]
    A = np.where(cols < a_sp[:, None], a_p[:, np.minimum(np.arange(W), S - 1)],
                 dot).astype(np.uint8)
    off = b_s - a_s
    bidx = cols - off[:, None]
    validB = (bidx >= 0) & (bidx < b_sp[:, None])
    B = np.where(validB, np.take_along_axis(b_p, np.clip(bidx, 0, S - 1),
                                            axis=1), dot).astype(np.uint8)
    merged = np.where(A == dot, B,
                      np.where((B != dot) & (A != B), dot, A))
    merged[cols >= np.minimum(width, W)[:, None]] = dot

    known = merged != dot
    any_ = known.any(axis=1) & ~too_long
    firstc = known.argmax(axis=1)
    lastc = W - 1 - known[:, ::-1].argmax(axis=1)
    span = np.where(any_, lastc - firstc + 1, 0)
    starts = np.where(any_, a_s + firstc, -1)
    Wout = int(span.max(initial=1))
    oidx = firstc[:, None] + np.arange(Wout)[None, :]
    out = np.where(np.arange(Wout)[None, :] < span[:, None],
                   np.take_along_axis(merged, np.clip(oidx, 0, W - 1), axis=1),
                   dot).astype(np.uint8)
    return starts, out, span, too_long


def merge_pe(r1, r2):
    """Merge two called mates (ref: patter_utils.cpp:292-342).

    Each of r1/r2 is (start_site, pattern bytes) or None.
    Returns merged tuple, None (both empty), or raises ValueError (too far).
    """
    if r1 is None:
        return r2
    if r2 is None:
        return r1
    if r1[0] > r2[0]:
        r1, r2 = r2, r1
    start1, pat1 = r1
    start2, pat2 = r2
    last = max(start1 + len(pat1), start2 + len(pat2))
    if last - start1 > MAX_PE_PAT_LEN:
        raise ValueError("invalid pairing. merged read is too long")
    merged = bytearray(b"." * (last - start1))
    merged[: len(pat1)] = pat1
    off = start2 - start1
    for i, c in enumerate(pat2):
        cur = merged[off + i]
        if cur == ord("."):
            merged[off + i] = c
        elif c != ord(".") and cur != c:
            merged[off + i] = ord(".")  # mate disagreement -> unknown
    # strip
    m = bytes(merged)
    stripped = m.strip(b".")
    if not stripped:
        return None
    lead = len(m) - len(m.lstrip(b"."))
    return start1 + lead, stripped


class MBiasCounter:
    """Methylation-by-read-position counters (ref: patter.cpp:50-72,116-164).

    Four tables: OT/OB x read1/read2, each (max_read_len, 2) [meth, unmeth].
    """

    MAX_READ_LEN = 1000

    def __init__(self):
        self.tables = {
            ("OT", 0): np.zeros((self.MAX_READ_LEN, 2), dtype=np.int64),
            ("OT", 1): np.zeros((self.MAX_READ_LEN, 2), dtype=np.int64),
            ("OB", 0): np.zeros((self.MAX_READ_LEN, 2), dtype=np.int64),
            ("OB", 1): np.zeros((self.MAX_READ_LEN, 2), dtype=np.int64),
        }

    def update(self, flag, paired, bottom, read_len, j, calls, iscpg):
        if paired:
            if (flag & 0x53) == 0x53:
                key = ("OB", 0)
            elif (flag & 0xA3) == 0xA3:
                key = ("OB", 1)
            elif (flag & 0x63) == 0x63:
                key = ("OT", 0)
            elif (flag & 0x93) == 0x93:
                key = ("OT", 1)
            else:
                return
        else:
            key = ("OB" if bottom else "OT", 0)
        if read_len > self.MAX_READ_LEN:
            return
        # reference indexes by the position within the original read (the
        # conv position i = j - strand shift, not j itself)
        i = j - (1 if bottom else 0)
        mj = (read_len - 1 - i) if bottom else i
        tab = self.tables[key]
        for pos, c in zip(mj, calls):
            if 0 <= pos < self.MAX_READ_LEN:
                if c == ord("C"):
                    tab[pos, 0] += 1
                elif c == ord("T"):
                    tab[pos, 1] += 1

    def update_batch(self, flags, paired, bottom, read_lens, j, calls):
        """Vectorized `update` over flat (read, CpG) pairs.

        flags/bottom/read_lens are per-pair (already gathered by read id);
        j/calls as in update. Same key precedence and position mapping.
        """
        flags = np.asarray(flags, dtype=np.int64)
        if paired:
            cats = [
                (("OB", 0), (flags & 0x53) == 0x53),
                (("OB", 1), (flags & 0xA3) == 0xA3),
                (("OT", 0), (flags & 0x63) == 0x63),
                (("OT", 1), (flags & 0x93) == 0x93),
            ]
            taken = np.zeros(flags.shape[0], dtype=bool)
            resolved = []
            for key, m in cats:  # same elif precedence as update()
                m = m & ~taken
                taken |= m
                resolved.append((key, m))
        else:
            resolved = [
                (("OB", 0), bottom),
                (("OT", 0), ~bottom),
            ]
        shift = bottom.astype(np.int64)
        i = j - shift
        mj = np.where(bottom, read_lens - 1 - i, i)
        valid = ((read_lens <= self.MAX_READ_LEN)
                 & (mj >= 0) & (mj < self.MAX_READ_LEN))
        is_c = calls == ord("C")
        is_t = calls == ord("T")
        for key, m in resolved:
            tab = self.tables[key]
            for col, mask in ((0, is_c), (1, is_t)):
                sel = m & valid & mask
                if sel.any():
                    np.add.at(tab[:, col], mj[sel], 1)

    def dump(self, prefix):
        for strand in ("OT", "OB"):
            path = f"{prefix}.{strand}.txt"
            with open(path, "w") as f:
                f.write("r1m1\tr1u1\tr2m2\tr2u2\n")
                t0, t1 = self.tables[(strand, 0)], self.tables[(strand, 1)]
                for pos in range(self.MAX_READ_LEN):
                    f.write(f"{t0[pos, 0]}\t{t0[pos, 1]}\t"
                            f"{t1[pos, 0]}\t{t1[pos, 1]}\n")


def call_read_nanopore(rec, loci, site_base, clip=0, np_thresh=0.667,
                       cpc_call="C", combine_mods=False):
    """ONT/modification-aware calling of one record
    (ref: src/pipeline_wgbs/ont.cpp:90-221)."""
    from .nanopore import (
        NanoporeCalls,
        make_meth_mask,
        np_call_read,
        revcomp,
    )

    mm = rec.get_tag("MM")
    if mm is None:
        mm = rec.get_tag("Mm")
    ml = rec.get_tag("ML")
    if ml is None:
        ml = rec.get_tag("Ml")
    calls = NanoporeCalls(mm or "", ml, cpc_call=cpc_call,
                          combine_mods=combine_mods)
    if calls.empty or not rec.seq or rec.seq == b"*":
        return None
    bottom = bool(rec.flag & FREVERSE)
    orig_seq = revcomp(rec.seq) if bottom else rec.seq
    mask = make_meth_mask(orig_seq, calls, np_thresh=np_thresh)
    if bottom:
        mask = mask[::-1]
    seq_adj = clean_cigar(rec.seq, rec.cigar)
    mask_adj = clean_cigar(mask, rec.cigar)
    return np_call_read(seq_adj, mask_adj, rec.pos + 1, bottom, calls.np_dot,
                        loci, site_base, clip=clip)


def call_reads_batch(seqs_adj, positions, flags, paired, loci, site_base,
                     clip=0, seqmat=None, lens=None, mbias=None, device=None,
                     chrom=None):
    """Vectorized calling of many CIGAR-normalized reads at once.

    Exactly equivalent to per-read `call_read` (same masks/rules), but all
    (read, CpG) pairs are processed in one pass: numpy on the host, or the
    call_reads kernel on `device` (not with m-bias, which counts every
    call on the host). seqs_adj: list of bytes (or pass a prebuilt
    zero-padded `seqmat` uint8 (R, Lmax) + `lens`); returns a list of
    (start_site, pattern bytes) | None entries.
    """
    if seqmat is not None:
        R = seqmat.shape[0]
    else:
        R = len(seqs_adj)
        if R == 0:
            return []
        lens = np.fromiter((len(s) for s in seqs_adj), dtype=np.int64,
                           count=R)
        Lmax = max(int(lens.max()), 1)
        seqmat = np.zeros((R, Lmax), dtype=np.uint8)
        for r, s in enumerate(seqs_adj):
            seqmat[r, : len(s)] = np.frombuffer(s, dtype=np.uint8)
    if R == 0:
        return []
    if device is not None and mbias is None:
        from ..ops.calling import call_reads_device

        starts, patmat, span = call_reads_device(
            positions, flags, paired, loci, site_base, seqmat, lens,
            clip=clip, device=device, chrom=chrom)
    else:
        starts, patmat, span = call_reads_mat(positions, flags, paired, loci,
                                              site_base, seqmat, lens,
                                              clip=clip, mbias=mbias)
    results = [None] * R
    for r in np.nonzero(starts >= 0)[0]:
        results[r] = (int(starts[r]), bytes(patmat[r, : span[r]]))
    return results


def call_reads_mat(positions, flags, paired, loci, site_base, seqmat, lens,
                   clip=0, mbias=None):
    """Array-native batched calling (no per-read Python objects).

    Same rules as `call_read` (ref: patter.cpp:105-184). Inputs: zero-padded
    `seqmat` uint8 (R, Lmax) of CIGAR-normalized read bytes + `lens`.
    Returns (start int64[R] — global 1-based CpG index of the first known
    call, -1 when the read has none; patmat uint8[R, S] of pattern chars,
    '.'-padded beyond each span; span int64[R]).
    """
    R = seqmat.shape[0]
    lens = np.asarray(lens, dtype=np.int64)
    no_calls = (np.full(R, -1, dtype=np.int64),
                np.full((R, 1), ord("."), dtype=np.uint8),
                np.zeros(R, dtype=np.int64))
    if R == 0:
        return no_calls
    Lmax = seqmat.shape[1]
    pos1 = np.asarray(positions, dtype=np.int64)  # 1-based start locus
    flags = np.asarray(flags, dtype=np.int64)
    if paired:
        bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    else:
        bottom = (flags & FREVERSE) != 0
    shift = bottom.astype(np.int64)

    k0 = np.searchsorted(loci, pos1, side="left")
    k1 = np.searchsorted(loci, pos1 + lens, side="left")
    counts = k1 - k0
    P = int(counts.sum())
    if P == 0:
        return no_calls
    rid = np.repeat(np.arange(R), counts)
    kk = (np.arange(P) - np.repeat(np.cumsum(counts) - counts, counts)
          + np.repeat(k0, counts))
    i = loci[kk].astype(np.int64) - pos1[rid]
    j = i + shift[rid]
    n_r = lens[rid]
    jn = np.clip(j, 0, Lmax - 1)
    s = seqmat[rid, jn]
    bot = bottom[rid]

    prev = seqmat[rid, np.clip(j - 1, 0, Lmax - 1)]
    nxt = seqmat[rid, np.clip(j + 1, 0, Lmax - 1)]
    iscpg = np.where(
        bot,
        (j > 0) & ((s == B_G) | (s == B_A)) & (prev == B_C),
        (j < n_r - 1) & ((s == B_C) | (s == B_T)) & (nxt == B_G),
    )
    ref_chr = np.where(bot, B_G, B_C)
    unmeth_chr = np.where(bot, B_A, B_T)
    calls = np.full(P, ord("."), dtype=np.uint8)
    calls[iscpg & (s == unmeth_chr)] = ord("T")
    calls[iscpg & (s == ref_chr)] = ord("C")
    if clip > 0:
        clipped = ~((j >= clip) & (j < n_r - clip))
        calls[clipped] = ord(".")
    calls[(j < 0) | (j >= n_r)] = ord(".")

    if mbias is not None:
        mbias.update_batch(flags[rid], paired, bot, n_r, j, calls)

    # per-read pattern extents over known calls
    known = calls != ord(".")
    if not known.any():
        return no_calls
    idx = np.arange(P)
    first = np.full(R, P + 1, dtype=np.int64)
    last = np.full(R, -1, dtype=np.int64)
    np.minimum.at(first, rid[known], idx[known])
    np.maximum.at(last, rid[known], idx[known])
    has = last >= 0
    if not has.any():
        return no_calls
    span = np.zeros(R, dtype=np.int64)
    span[has] = last[has] - first[has] + 1
    maxspan = int(span.max())
    patmat = np.full((R, maxspan), ord("."), dtype=np.uint8)
    sel = has[rid] & (idx >= np.where(has, first, 0)[rid]) & (idx <= last[rid])
    patmat[rid[sel], idx[sel] - first[rid[sel]]] = calls[sel]
    # start site = global 1-based index of the first known call's CpG
    starts = np.full(R, -1, dtype=np.int64)
    starts[has] = site_base + kk[first[has]]
    return starts, patmat, span


def call_records(records, loci, site_base, chrom_name, paired, clip=0,
                 min_cpg=1, stats=None, mbias=None, with_qname=False,
                 nanopore=False, np_thresh=0.667, cpc_call="C",
                 combine_mods=False, device=None):
    """Call + pair a chromosome's worth of BamRecords into pat rows.

    records: position-sorted primary records of one chromosome; `device`
    as in call_reads_batch (nanopore reads call on the host).
    Returns (starts int64[], patterns list[bytes], qnames list|None).
    """
    stats = stats if stats is not None else ReadStats()
    starts, patterns, qnames = [], [], []

    def emit(res, qname):
        if res is None:
            return
        if len(res[1]) < min_cpg:
            stats.nr_short += 1
            return
        starts.append(res[0])
        patterns.append(res[1])
        if with_qname:
            qnames.append(qname)

    # batched pre-calling (fast path); m-bias accumulates vectorized inside
    # call_reads_mat (MBiasCounter.update_batch)
    precomputed = None
    if not nanopore and records:
        seqs, positions, flags, ok = [], [], [], []
        for rec in records:
            try:
                seqs.append(clean_cigar(rec.seq, rec.cigar))
                positions.append(rec.pos + 1)
                flags.append(rec.flag)
                ok.append(True)
            except Exception as e:
                stats.nr_invalid += 1
                if stats.nr_invalid <= 20:
                    logger.warning("[ %s ] invalid read %s: %s", chrom_name,
                                   rec.qname, e)
                ok.append(False)
        batch = call_reads_batch(seqs, positions, flags, paired, loci,
                                 site_base, clip=clip, mbias=mbias,
                                 device=device, chrom=chrom_name)
        precomputed = {}
        bi = 0
        for rec, good in zip(records, ok):
            precomputed[id(rec)] = batch[bi] if good else ("invalid",)
            if good:
                bi += 1

    def call_one(rec):
        stats.nr_lines += 1
        if precomputed is not None:
            res = precomputed[id(rec)]
            if res == ("invalid",):
                return None  # already counted
            if res is None:
                stats.nr_empty += 1
            return res
        try:
            if nanopore:
                res = call_read_nanopore(
                    rec, loci, site_base, clip=clip, np_thresh=np_thresh,
                    cpc_call=cpc_call, combine_mods=combine_mods,
                )
            else:
                seq = clean_cigar(rec.seq, rec.cigar)
                res = call_read(seq, rec.pos + 1, rec.flag, paired, loci,
                                site_base, clip=clip, mbias=mbias)
            if res is None:
                stats.nr_empty += 1
            return res
        except Exception as e:  # invalid read
            stats.nr_invalid += 1
            if stats.nr_invalid <= 20:
                logger.warning("[ %s ] invalid read %s: %s", chrom_name,
                               rec.qname, e)
            return None

    if not paired:
        for rec in records:
            emit(call_one(rec), rec.qname)
    else:
        pending = {}
        pair_list = []
        for rec in records:
            if rec.qname in pending:
                pair_list.append((pending.pop(rec.qname), rec))
                stats.nr_pairs += 1
            else:
                pending[rec.qname] = rec
        if precomputed is not None:
            pair_res = [(call_one(a), call_one(b)) for a, b in pair_list]
            for (a, b), m in zip(pair_list, merge_pe_batch(pair_res)):
                if isinstance(m, ValueError):
                    stats.nr_invalid += 2
                else:
                    emit(m, b.qname)
        else:
            for mate, rec in pair_list:
                r1 = call_one(mate)
                r2 = call_one(rec)
                try:
                    emit(merge_pe(r1, r2), rec.qname)
                except ValueError:
                    stats.nr_invalid += 2
        for qname, rec in pending.items():  # unpaired singles
            emit(call_one(rec), qname)

    return (np.array(starts, dtype=np.int64), patterns,
            qnames if with_qname else None)


def rows_to_frags(starts, patterns, chrom_name, qnames=None) -> PatFrags:
    """Pack called rows into a PatFrags batch (count=1 each), unsorted."""
    from ..formats.pat import _ENCODE_LUT

    n = len(patterns)
    if n == 0:
        from ..formats.pat import empty_frags

        return empty_frags()
    max_len = max(len(p) for p in patterns)
    mat = np.array(patterns, dtype=f"S{max_len}").view(np.uint8).reshape(n, -1)
    codes = _ENCODE_LUT[mat]
    lengths = np.array([len(p) for p in patterns], dtype=np.int32)
    extras = None
    if qnames is not None:
        extras = np.array([q.encode() for q in qnames], dtype=object)
    return PatFrags(
        np.asarray(starts, dtype=np.int32),
        lengths,
        np.ones(n, dtype=np.int32),
        codes,
        np.zeros(n, dtype=np.int16),
        [chrom_name],
        extras,
    )
