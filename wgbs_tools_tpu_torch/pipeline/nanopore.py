"""Nanopore / modification-aware calling: MM/ML tags -> pat patterns.

The port's copy of wgbs_tools_tpu/pipeline/nanopore.py, with the same
names. Nanopore calling runs on the host (numpy), as in the JAX package.

Exact reimplementation of the reference's ONT branch
(ref: src/pipeline_wgbs/ont.cpp): MM skip-counts index the C's of the
as-sequenced read (reverse-complement for bottom-strand alignments), ML
probabilities threshold at np_thresh into M/U/H/N states, the per-C mask is
flipped to forward orientation and CIGAR-normalized, and the pattern is
emitted over reference CpG positions with the dot-convention
(unlisted C = unmethylated) only when the MM header uses "C+m"/"C+m."
(not "C+m?"). Biomodal "C+C" sections merge into 5mC or 5hmC calls per
`cpc_call`; `combine_mods` sums 5mC+5hmC probabilities.
"""

import numpy as np

from ..utils import IllegalArgumentError

B_C, B_G = ord("C"), ord("G")
_RC = bytes.maketrans(b"ACGTN", b"TGCAN")


def revcomp(seq: bytes) -> bytes:
    return seq.translate(_RC)[::-1]


def parse_mm_sections(mm_str):
    """MM tag -> {mod_char: (skips array, np_dot, section_index)}.

    Section headers look like C+m, C+m., C+m?, C+h, C+C?
    (ref: ont.cpp:310-333,361-416).
    """
    sections = {}
    parts = [s for s in mm_str.split(";") if s]
    for idx, part in enumerate(parts):
        if len(part) < 3 or not part.startswith("C+"):
            continue
        mod = part[2]
        header = part.split(",", 1)[0]
        np_dot = not (len(header) > 3 and header[3] == "?")
        if "," in part:
            skips = np.array(part.split(",")[1:], dtype=np.int64)
        else:
            skips = np.zeros(0, dtype=np.int64)
        if mod not in sections:
            sections[mod] = (skips, np_dot, idx)
    return sections


def mm_positions(skips):
    """Cumulative skip counts -> C-ordinal positions (ref: ont.cpp:302-308)."""
    skips = np.asarray(skips, dtype=np.int64)
    return np.cumsum(skips) + np.arange(skips.shape[0], dtype=np.int64)


def slice_ml(ml_vals, section_idx, n, total_sections_n):
    """ML is a flat array; slice the block for this section
    (ref: ont.cpp:395-415). Missing ML (Biomodal) -> all 255."""
    if ml_vals is None:
        return np.full(n, 255, dtype=np.int64)
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if len(ml_vals) % n != 0:
        raise IllegalArgumentError("Unsupported MM field (ML not modulo)")
    lo = section_idx * n
    if len(ml_vals) >= lo + n:
        return np.frombuffer(bytes(ml_vals[lo : lo + n]),
                             dtype=np.uint8).astype(np.int64)
    return np.full(n, 255, dtype=np.int64)


class NanoporeCalls:
    """Per-read parsed modification calls."""

    def __init__(self, mm_str, ml_vals, cpc_call="C", combine_mods=False):
        secs = parse_mm_sections(mm_str) if mm_str else {}
        self._init_from_sections(secs, ml_vals, cpc_call, combine_mods)

    @classmethod
    def from_sections(cls, secs, ml_vals, cpc_call="C", combine_mods=False):
        """Build from a pre-parsed sections dict
        {mod: (skips, np_dot, part_idx)} (the columnar path's native MM
        parser produces these without the Python string split)."""
        self = cls.__new__(cls)
        self._init_from_sections(secs, ml_vals, cpc_call, combine_mods)
        return self

    def _init_from_sections(self, secs, ml_vals, cpc_call, combine_mods):
        self.np_dot = False
        zero = np.zeros(0, dtype=np.int64)
        m_pos = m_ml = h_pos = h_ml = zero
        if "h" in secs:
            skips, _, idx = secs["h"]
            h_pos = mm_positions(skips)
            h_ml = slice_ml(ml_vals, idx, len(h_pos), len(secs))
        if "m" in secs:
            skips, np_dot, idx = secs["m"]
            self.np_dot = np_dot
            m_pos = mm_positions(skips)
            m_ml = slice_ml(ml_vals, idx, len(m_pos), len(secs))
        if "C" in secs and cpc_call != ".":
            skips, _, idx = secs["C"]
            c_pos = mm_positions(skips)
            tgt_pos, tgt_ml = (h_pos, h_ml) if cpc_call == "H" else (m_pos, m_ml)
            new = c_pos[~np.isin(c_pos, tgt_pos)]
            k = np.searchsorted(tgt_pos, new)
            tgt_pos = np.insert(tgt_pos, k, new)
            tgt_ml = np.insert(tgt_ml, k, 255)
            if cpc_call == "H":
                h_pos, h_ml = tgt_pos, tgt_ml
            else:
                m_pos, m_ml = tgt_pos, tgt_ml
        self.m_pos, self.m_ml = m_pos, m_ml
        self.h_pos, self.h_ml = h_pos, h_ml
        self.combine_mods = combine_mods

    @property
    def empty(self):
        return not len(self.m_pos) and not len(self.h_pos) and not self.np_dot


def _prep_section(pos, ml, n_c):
    """Emulate the reference's advancing-pointer match (ref: ont.cpp:40-78):
    ordinals must be strictly increasing to keep matching; a non-increasing
    ordinal wedges the pointer, blocking all later entries. Ordinals beyond
    the read's C count never match."""
    pos = np.asarray(pos, dtype=np.int64)
    ml = np.asarray(ml, dtype=np.int64)
    if pos.size:
        bad = np.nonzero(np.diff(pos) <= 0)[0]
        if bad.size:
            pos, ml = pos[: bad[0] + 1], ml[: bad[0] + 1]
        keep = pos < n_c
        pos, ml = pos[keep], ml[keep]
    return pos, ml


def ordinal_status(calls: NanoporeCalls, n_c: int, np_thresh=0.667):
    """Status byte (M/H/U/N/E) per C-ordinal of the as-sequenced read
    (the section-scatter half of make_meth_mask, reusable by the columnar
    path which scatters onto stored-orientation positions itself)."""
    hi_t = 255 * np_thresh
    lo_t = 255 * (1 - np_thresh)
    m_pos, m_ml = _prep_section(calls.m_pos, calls.m_ml, n_c)
    h_pos, h_ml = _prep_section(calls.h_pos, calls.h_ml, n_c)
    status = np.full(n_c, ord("E"), dtype=np.uint8)
    if calls.combine_mods:
        comb = np.zeros(n_c, dtype=np.int64)
        has = np.zeros(n_c, dtype=bool)
        comb[h_pos] += h_ml
        has[h_pos] = True
        comb[m_pos] += m_ml
        has[m_pos] = True
        np.minimum(comb, 255, out=comb)
        st = np.full(n_c, ord("N"), dtype=np.uint8)
        st[comb > hi_t] = ord("M")
        st[comb < lo_t] = ord("U")
        status[has] = st[has]
    else:
        st_h = np.full(h_pos.shape, ord("N"), dtype=np.uint8)
        st_h[h_ml > hi_t] = ord("H")
        st_h[h_ml < lo_t] = ord("U")
        status[h_pos] = st_h
        st_m = np.full(m_pos.shape, ord("N"), dtype=np.uint8)
        st_m[m_ml > hi_t] = ord("M")
        st_m[m_ml < lo_t] = ord("U")
        # an H call survives unless the m section upgrades to M
        prev = status[m_pos]
        st_m = np.where((prev == ord("H")) & (st_m != ord("M")), prev, st_m)
        status[m_pos] = st_m
    return status


def make_meth_mask(orig_seq: bytes, calls: NanoporeCalls, np_thresh=0.667):
    """Per-base status mask over the as-sequenced read
    (ref: ont.cpp:22-87). E=not called, M/H/U/N as documented.

    Vectorized: C ordinals are materialized once, each MM section scatters
    its thresholded status onto them, and the per-ordinal statuses scatter
    back to base positions.
    """
    seq = np.frombuffer(orig_seq, dtype=np.uint8)
    c_idx = np.nonzero(seq == B_C)[0]
    status = ordinal_status(calls, c_idx.shape[0], np_thresh)
    mask = np.full(seq.shape, ord("E"), dtype=np.uint8)
    mask[c_idx] = status
    return mask.tobytes()


def np_call_read(seq_adj: bytes, mask_adj: bytes, start_locus: int,
                 bottom: bool, np_dot: bool, loci: np.ndarray, site_base: int,
                 clip: int = 0):
    """Build the pattern over reference CpG positions (ref: ont.cpp:132-218).

    seq_adj / mask_adj: CIGAR-normalized forward-oriented read and status
    mask. Returns (start_site, pattern bytes) or None.
    """
    return np_call_read_arr(np.frombuffer(seq_adj, dtype=np.uint8),
                            np.frombuffer(mask_adj, dtype=np.uint8),
                            start_locus, bottom, np_dot, loci, site_base,
                            clip=clip)


def np_call_read_arr(seqarr, maskarr, start_locus: int, bottom: bool,
                     np_dot: bool, loci: np.ndarray, site_base: int,
                     clip: int = 0):
    """Array-input form of np_call_read (columnar path)."""
    n = seqarr.shape[0]
    loop_start = -1 if bottom else 0
    k0 = int(np.searchsorted(loci, start_locus + loop_start, side="left"))
    k1 = int(np.searchsorted(loci, start_locus + n, side="left"))
    if k1 <= k0:
        return None
    i = loci[k0:k1].astype(np.int64) - start_locus
    di = i + 1 if bottom else i
    in_range = (di >= 0) & (di < maskarr.shape[0])
    dic = np.clip(di, 0, max(maskarr.shape[0] - 1, 0))
    st = np.where(in_range, maskarr[dic] if maskarr.size else 0, 0)
    cur = np.full(di.shape, ord("."), dtype=np.uint8)
    cur[st == ord("M")] = ord("C")
    cur[st == ord("U")] = ord("T")
    cur[st == ord("H")] = ord("H")
    if np_dot:
        has_base = in_range & (
            (seqarr[dic] if seqarr.size else 0) == (B_G if bottom else B_C))
        cur[(st == ord("E")) & has_base] = ord("T")
    if clip > 0:
        clip_pos = di if bottom else i
        cur[(clip_pos < clip) | (clip_pos >= n - clip)] = ord(".")
    nz = np.nonzero(cur != ord("."))[0]
    if nz.size == 0:
        return None
    pattern = cur[nz[0] : nz[-1] + 1].tobytes()
    return site_base + k0 + int(nz[0]), pattern
