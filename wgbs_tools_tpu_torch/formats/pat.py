"""pat fragment batches: struct-of-arrays over the CpG-index axis.

The port's copy of what it calls from wgbs_tools_tpu/formats/pat.py, with
the same names. The pat format (ref: docs/pat_format.md) is a bgzipped TSV
sorted by CpG index: ``chrom  startCpG  pattern  count [extras...]`` with
pattern alphabet C (methylated), T (unmethylated), H (5hmC), '.' (unknown).
Fragments are a `PatFrags` struct-of-arrays: int32 global start sites,
int32 lengths/counts, and the calls as a dense (F, Lmax) uint8 code matrix
(T=0, C=1, H=2, unknown=3).

Parsing and BGZF inflation run in the port's host library (native.py),
which raises when it cannot be built: there is no Python parser to fall
back to. Text the parser refuses raises IllegalArgumentError.
"""

import gzip
import os.path as op
from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..native import bgzf_decompress_native, parse_pat_native
from ..utils import IllegalArgumentError
from .bgzf import BgzfReader, is_gzip

# 2-bit call codes
CODE_T, CODE_C, CODE_H, CODE_DOT = 0, 1, 2, 3

PAT_INDEX_SUFFIX = ".cdx"
# one streamed slab: iter_pat reads this many bytes of the file at a time,
# so a BGZF pat.gz slab is 32 MB compressed (~5M fragments of <= 24 sites)
# and a plain-text pat slab 32 MB of text; host peak memory stays O(slab)
DEF_CHUNK_BYTES = 32 << 20


@dataclass
class PatFrags:
    """A batch of pat fragments (host-side numpy SoA)."""

    start: np.ndarray        # int32 [F], 1-based global CpG index
    length: np.ndarray       # int32 [F]
    count: np.ndarray        # int32 [F]
    codes: np.ndarray        # uint8 [F, Lmax], values in {0,1,2,3}; cols >= length are 3
    chrom_id: np.ndarray     # int16 [F] index into chrom_names
    chrom_names: list        # chromosome name per chrom_id
    extras: Optional[np.ndarray] = None  # object[F] raw extra-column bytes or None

    @property
    def nr_frags(self) -> int:
        return int(self.start.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.codes.shape[1])

    def __len__(self):
        return self.nr_frags

    def take(self, idx) -> "PatFrags":
        return PatFrags(
            self.start[idx],
            self.length[idx],
            self.count[idx],
            self.codes[idx],
            self.chrom_id[idx],
            self.chrom_names,
            None if self.extras is None else self.extras[idx],
        )

    def slice_sites(self, start, end, min_overlap=1) -> "PatFrags":
        """Fragments overlapping the 1-based [start, end) site window.

        Assumes sorted by start. The candidate window uses the batch's max
        length bound (the analogue of the reference's MAX_PAT_LEN-padded tabix
        pulls, ref: cview.py:34-38) then filters exactly by length.
        """
        lo = np.searchsorted(self.start, start - self.max_len + 1, side="left")
        hi = np.searchsorted(self.start, end, side="left")
        sel = self.take(slice(int(lo), int(hi)))
        keep = sel.start + sel.length >= start + min_overlap
        if not keep.all():
            sel = sel.take(keep)
        return sel


def empty_frags(max_len=1) -> PatFrags:
    return PatFrags(
        np.empty(0, dtype=np.int32),
        np.empty(0, dtype=np.int32),
        np.empty(0, dtype=np.int32),
        np.empty((0, max_len), dtype=np.uint8),
        np.empty(0, dtype=np.int16),
        [],
        None,
    )


def parse_pat_bytes(data: bytes, keep_extras=True) -> PatFrags:
    """Parse raw pat text into a PatFrags batch with the host library's
    parser; raises IllegalArgumentError on a line it refuses."""
    if not data:
        return empty_frags()
    res = parse_pat_native(data)
    if res is None:
        raise IllegalArgumentError(
            "Invalid pat text: a line without 4 tab-separated columns, a "
            "non-numeric start or count, or a pattern character outside "
            "'CTH.'")
    starts, lengths, counts, codes, chrom_ids, chrom_names, extras = res
    return PatFrags(starts, lengths, counts, codes, chrom_ids, chrom_names,
                    extras if keep_extras else None)


def iter_pat(path, chunk_bytes=DEF_CHUNK_BYTES, keep_extras=False):
    """Stream a pat[.gz] file as a sequence of PatFrags batches.

    Bounded host memory: at most ~2 chunks of decompressed text are resident
    at a time. BGZF inputs decompress slab-by-slab through the multithreaded
    native inflater; block boundaries are found by walking the BSIZE chain,
    so no block is ever split. The reference's answer to this is per-
    chromosome `tabix` streams (ref: src/python/pat2beta.py:41-65).
    """
    carry = b""  # partial trailing line
    for text in _iter_decompressed(path, chunk_bytes):
        text = carry + text
        cut = text.rfind(b"\n")
        if cut < 0:
            carry = text
            continue
        carry = text[cut + 1 :]
        chunk = text[: cut + 1]
        if chunk:
            yield parse_pat_bytes(chunk, keep_extras=keep_extras)
    if carry:
        yield parse_pat_bytes(carry, keep_extras=keep_extras)


def iter_pat_region(path, region_sites, chunk_bytes=DEF_CHUNK_BYTES,
                    keep_extras=False):
    """Stream a 1-based [s, e) site range of a pat as PatFrags batches in
    bounded memory.

    With a .cdx sidecar the read seeks straight to the first candidate
    virtual offset and stops past the range (the analogue of the
    reference's per-range tabix pulls); without one it degrades to the
    whole-file stream with per-chunk overlap filtering (bounded memory
    either way). Yields fragments OVERLAPPING the range."""
    s, e = region_sites
    idx = load_pat_index(path) if path.endswith(".gz") else None
    if idx is None:
        for frags in iter_pat(path, chunk_bytes, keep_extras):
            part = frags.slice_sites(s, e)
            if part.nr_frags:
                yield part
            if frags.nr_frags and int(frags.start[0]) >= e:
                return  # sorted input: all later starts are past the range
        return
    samples_sites, samples_voff, max_len = idx
    i = np.searchsorted(samples_sites, s - max_len + 1, side="right") - 1
    i = max(int(i), 0)
    reader = BgzfReader(path)
    reader.seek_virtual(int(samples_voff[i]))
    buf, size = [], 0
    try:
        while True:
            line = reader.readline()
            if not line:
                break
            start = int(line.split(b"\t", 3)[1])
            if start >= e:
                break
            buf.append(line)
            size += len(line)
            if size >= chunk_bytes:
                part = parse_pat_bytes(
                    b"".join(buf), keep_extras=keep_extras).slice_sites(s, e)
                buf, size = [], 0
                if part.nr_frags:
                    yield part
    finally:
        reader.close()
    if buf:
        part = parse_pat_bytes(
            b"".join(buf), keep_extras=keep_extras).slice_sites(s, e)
        if part.nr_frags:
            yield part


def _iter_decompressed(path, chunk_bytes):
    """Yield decompressed byte chunks of a pat / pat.gz / BGZF file: BGZF
    through the native inflater, a plain (single-member) gzip through
    zlib, uncompressed text as it is."""
    if not is_gzip(path):
        with open(path, "rb") as f:
            while True:
                buf = f.read(chunk_bytes)
                if not buf:
                    return
                yield buf
        return
    with open(path, "rb") as f:
        head = f.read(18)
        f.seek(0)
        if len(head) < 18 or head[:4] != b"\x1f\x8b\x08\x04":
            with gzip.open(f, "rb") as gz:
                while True:
                    buf = gz.read(chunk_bytes)
                    if not buf:
                        return
                    yield buf
        comp_carry = b""
        while True:
            fresh = f.read(chunk_bytes)
            slab = comp_carry + fresh
            if not slab:
                return
            end = _last_block_end(slab)
            if end == 0:  # truncated mid-block; need more bytes
                if not fresh:
                    raise IllegalArgumentError(
                        f"truncated BGZF block at end of {path}")
                comp_carry = slab
                continue
            comp_carry = slab[end:]
            out = bgzf_decompress_native(slab[:end])
            if out is None:
                raise IllegalArgumentError(
                    f"BGZF decompression failed mid-stream in {path}")
            if out:
                yield out


def _last_block_end(slab):
    """Byte offset just past the last complete BGZF block in `slab` (0 if
    none complete). Walks the BSIZE chain in the BC extra subfield."""
    off = 0
    last = 0
    n = len(slab)
    while off + 18 <= n:
        if slab[off : off + 4] != b"\x1f\x8b\x08\x04":
            raise IllegalArgumentError(f"not a BGZF block at offset {off}")
        xlen = int.from_bytes(slab[off + 10 : off + 12], "little")
        extra = slab[off + 12 : off + 12 + xlen]
        bsize = None
        p = 0
        while p + 4 <= len(extra):
            slen = int.from_bytes(extra[p + 2 : p + 4], "little")
            if extra[p] == 0x42 and extra[p + 1] == 0x43 and slen == 2:
                bsize = int.from_bytes(extra[p + 4 : p + 6], "little") + 1
                break
            p += 4 + slen
        if bsize is None:
            raise IllegalArgumentError("BGZF block without BC subfield")
        if off + bsize > n:
            break
        off += bsize
        last = off
    return last


def load_pat_index(path):
    """(sites, voffsets, max_len) of a pat.gz's .cdx sidecar, or None."""
    idx_path = path + PAT_INDEX_SUFFIX
    if not op.isfile(idx_path):
        # legacy sidecars written via np.savez(str) got '.npz' appended
        if op.isfile(idx_path + ".npz"):
            idx_path += ".npz"
        else:
            return None
    z = np.load(idx_path)
    return z["sites"], z["voffsets"], int(z["max_len"])


def _bgzf_block_table(comp: bytes):
    """(compressed_offsets, uncompressed_offsets) of each BGZF block."""
    import struct as _struct

    coffs, uoffs = [], []
    pos = 0
    upos = 0
    n = len(comp)
    while pos + 18 <= n:
        xlen = _struct.unpack_from("<H", comp, pos + 10)[0]
        bsize = None
        p = pos + 12
        while p + 4 <= pos + 12 + xlen:
            s1, s2 = comp[p], comp[p + 1]
            slen = _struct.unpack_from("<H", comp, p + 2)[0]
            if s1 == 0x42 and s2 == 0x43 and slen == 2:
                bsize = _struct.unpack_from("<H", comp, p + 4)[0] + 1
                break
            p += 4 + slen
        if bsize is None:
            break
        isize = _struct.unpack_from("<I", comp, pos + bsize - 4)[0]
        coffs.append(pos)
        uoffs.append(upos)
        upos += isize
        pos += bsize
    return np.asarray(coffs, dtype=np.int64), np.asarray(uoffs, dtype=np.int64)
