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

from ..native import (bgzf_compress_native, bgzf_decompress_native,
                      parse_pat_native, serialize_pat_native)
from ..utils import IllegalArgumentError
from .bgzf import _BGZF_EOF, BgzfReader, is_gzip

# 2-bit call codes
CODE_T, CODE_C, CODE_H, CODE_DOT = 0, 1, 2, 3

_ENCODE_LUT = np.full(256, 255, dtype=np.uint8)
_ENCODE_LUT[ord("T")] = CODE_T
_ENCODE_LUT[ord("C")] = CODE_C
_ENCODE_LUT[ord("H")] = CODE_H
_ENCODE_LUT[ord(".")] = CODE_DOT
_ENCODE_LUT[0] = CODE_DOT  # padding in fixed-width byte matrices

_DECODE_LUT = np.frombuffer(b"TCH.", dtype=np.uint8)

# Default index sampling stride (records per index entry)
INDEX_STRIDE = 4096
PAT_INDEX_SUFFIX = ".cdx"
# one streamed slab: iter_pat reads this many bytes of the file at a time,
# so a BGZF pat.gz slab is 32 MB compressed (~5M fragments of <= 24 sites)
# and a plain-text pat slab 32 MB of text; host peak memory stays O(slab)
DEF_CHUNK_BYTES = 32 << 20


def _save_cdx(idx_path, **arrays):
    """np.savez to the exact path (np.savez on a str appends '.npz')."""
    with open(idx_path, "wb") as f:
        np.savez(f, **arrays)


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

    def sort(self) -> "PatFrags":
        """pat order: by startCpG, then pattern bytes (C locale `sort -k2,2n -k3,3`,
        ref: docs/pat_format.md:43)."""
        pat_bytes = self.pattern_bytes()
        keys = [pat_bytes, self.start]
        if self.extras is not None:
            keys.insert(0, self.extras.astype("S"))
        order = np.lexsort(keys)
        return self.take(order)

    def pattern_bytes(self) -> np.ndarray:
        """Fixed-width bytes (|S Lmax) of the visible pattern strings."""
        chars = _DECODE_LUT[self.codes]
        cols = np.arange(self.max_len)
        chars[cols[None, :] >= self.length[:, None]] = 0
        return chars.view(f"S{max(self.max_len, 1)}").ravel()

    def collapse(self) -> "PatFrags":
        """Merge adjacent identical (chrom,start,pattern[,extras]) rows summing
        counts (ref: src/collapse_pat.pl). Assumes sorted order."""
        if self.nr_frags == 0:
            return self
        pat_bytes = self.pattern_bytes()
        same = (self.start[1:] == self.start[:-1]) & (pat_bytes[1:] == pat_bytes[:-1])
        if self.extras is not None:
            same &= self.extras[1:] == self.extras[:-1]
        # group ids for runs of identical rows
        gid = np.concatenate([[0], np.cumsum(~same)])
        n_groups = int(gid[-1]) + 1
        counts = np.zeros(n_groups, dtype=np.int64)
        np.add.at(counts, gid, self.count)
        first = np.concatenate([[0], np.nonzero(~same)[0] + 1])
        out = self.take(first)
        out.count = counts.astype(np.int32)
        return out

    def packed(self) -> np.ndarray:
        """Bit-pack codes to 2 bits/call, 4 calls/byte -> uint8 [F, ceil(L/4)]."""
        return pack_codes(self.codes)

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


def pack_codes(codes: np.ndarray) -> np.ndarray:
    F, L = codes.shape
    Lp = (L + 3) // 4 * 4
    if Lp != L:
        codes = np.pad(codes, ((0, 0), (0, Lp - L)), constant_values=CODE_DOT)
    c = codes.reshape(F, Lp // 4, 4).astype(np.uint8)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def unpack_codes(packed: np.ndarray, max_len=None) -> np.ndarray:
    F, P = packed.shape
    out = np.empty((F, P * 4), dtype=np.uint8)
    for j in range(4):
        out[:, j::4] = (packed >> (2 * j)) & 3
    return out[:, :max_len] if max_len is not None else out


def frags_to_bytes(frags: PatFrags) -> bytes:
    """Serialize a PatFrags batch to pat text: the host library's
    serializer, or, for a batch with extra columns (--long's read names),
    a Python loop."""
    if frags.nr_frags == 0:
        return b""
    if frags.extras is None:
        return serialize_pat_native(frags.start, frags.length, frags.count,
                                    frags.codes, frags.chrom_id,
                                    frags.chrom_names)
    chars = _DECODE_LUT[frags.codes]
    out = bytearray()
    names = [c.encode() for c in frags.chrom_names]
    lengths = frags.length.tolist()
    starts = frags.start.tolist()
    counts = frags.count.tolist()
    cids = frags.chrom_id.tolist()
    extras = frags.extras
    for i in range(frags.nr_frags):
        out += names[cids[i]]
        out += b"\t%d\t" % starts[i]
        out += chars[i, : lengths[i]].tobytes()
        out += b"\t%d" % counts[i]
        if extras is not None and extras[i] is not None:
            out += b"\t" + extras[i]
        out += b"\n"
    return bytes(out)


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


def read_pat(path, region_sites=None, keep_extras=True) -> PatFrags:
    """Read a pat[.gz] file, optionally restricted to a 1-based [s, e) site
    window (random access through the .cdx index when present)."""
    if region_sites is not None and path.endswith(".gz"):
        idx = load_pat_index(path)
        if idx is not None:
            return _read_region_indexed(path, idx, region_sites, keep_extras)
    with open(path, "rb") as f:
        data = f.read()
    if is_gzip(path):
        # BGZF through the native inflater, a plain gzip through zlib
        data = bgzf_decompress_native(data) or gzip.decompress(data)
    frags = parse_pat_bytes(data, keep_extras=keep_extras)
    if region_sites is not None:
        frags = frags.slice_sites(*region_sites)
    return frags


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


def _read_region_indexed(path, idx, region_sites, keep_extras):
    s, e = region_sites
    samples_sites, samples_voff, max_len = idx
    # first sample whose site could still have overlapping reads
    i = np.searchsorted(samples_sites, s - max_len + 1, side="right") - 1
    i = max(int(i), 0)
    reader = BgzfReader(path)
    reader.seek_virtual(int(samples_voff[i]))
    chunks = []
    while True:
        line = reader.readline()
        if not line:
            break
        start = int(line.split(b"\t", 3)[1])
        if start >= e:
            break
        chunks.append(line)
    reader.close()
    frags = parse_pat_bytes(b"".join(chunks), keep_extras=keep_extras)
    return frags.slice_sites(s, e)



def write_pat(frags: PatFrags, path, level=6, index=True, stride=INDEX_STRIDE,
              csi=True):
    """Write fragments as a BGZF pat.gz (+ .cdx sidecar and a
    tabix-compatible .csi index): the host library's multithreaded block
    compression of the serialized text, with the index's virtual offsets
    recovered from the block table."""
    text = frags_to_bytes(frags)
    comp = bgzf_compress_native(text, level=level)
    samples_sites, samples_voff = [], []
    with open(path, "wb") as f:
        f.write(comp)
    if index and frags.nr_frags:
        starts = frags.start
        all_rows = np.arange(frags.nr_frags)
        offs_all = np.concatenate([_line_offsets(text, all_rows), [len(text)]])
        coffs, uoffs = _bgzf_block_table(comp)
        blk = np.searchsorted(uoffs, offs_all, side="right") - 1
        voffs_all = (coffs[blk] << 16) | (offs_all - uoffs[blk])
        idx_rows = all_rows[::stride]
        samples_sites = starts[idx_rows].astype(np.int64)
        samples_voff = voffs_all[idx_rows].astype(np.int64)
        if csi:
            from .csi import write_csi

            write_csi(path + ".csi", frags.chrom_names, frags.chrom_id,
                      starts.astype(np.int64) - 1, voffs_all[:-1],
                      voffs_all[1:])
    if index:
        max_len = int(frags.length.max()) if frags.nr_frags else 1
        _save_cdx(
            path + PAT_INDEX_SUFFIX,
            sites=np.asarray(samples_sites, dtype=np.int64),
            voffsets=np.asarray(samples_voff, dtype=np.int64),
            max_len=np.int64(max_len),
        )
    return path


class PatStreamWriter:
    """Incremental writer of a sorted pat.gz: batches are serialized,
    BGZF-compressed (the host library's multithreaded deflater) and appended
    as they arrive, with the .cdx sidecar and .csi index accumulated on the
    fly; host memory stays bounded whatever the output's size. The streaming
    analogue of write_pat (same sidecars; BGZF block framing differs,
    decompressed bytes are identical), mirroring the reference's
    per-chromosome part files + `cat` concat (ref: src/python/
    bam2pat.py:398-422).

    Batches must arrive in global pat order (non-decreasing startCpG; rows
    with equal start must not be split across batches or collapse/ordering
    would be violated: callers flush on start boundaries)."""

    def __init__(self, path, level=6, index=True, stride=INDEX_STRIDE,
                 csi=True):
        self.path = path
        self.level = level
        self.index = index
        self.csi = csi and index
        self.stride = stride
        self._f = open(path, "wb")
        self._coff = 0          # compressed bytes written so far
        self._n_lines = 0
        self._nr_frags = 0
        self._max_len = 1
        self._last_start = None
        self._cdx_sites = []
        self._cdx_voffs = []
        self._chrom_names = []
        self._chrom_lookup = {}
        if self.csi:
            from .csi import CsiAccumulator

            self._csi_acc = CsiAccumulator()

    def write_frags(self, frags: PatFrags):
        if frags.nr_frags == 0:
            return
        if self._last_start is not None \
                and int(frags.start[0]) < self._last_start:
            raise IllegalArgumentError(
                "PatStreamWriter batches must be globally sorted: got start "
                f"{int(frags.start[0])} after {self._last_start}")
        self._last_start = int(frags.start[-1])
        text = frags_to_bytes(frags)
        comp = bgzf_compress_native(text, level=self.level)
        comp = comp[:-28]  # strip the per-buffer EOF block; one at close()
        if self.index:
            rows = np.arange(frags.nr_frags)
            offs_all = np.concatenate([_line_offsets(text, rows),
                                       [len(text)]])
            coffs, uoffs = _bgzf_block_table(comp)
            blk = np.searchsorted(uoffs, offs_all, side="right") - 1
            voffs_all = ((coffs[blk] + self._coff) << 16) \
                | (offs_all - uoffs[blk])
            # the batch's final end-voff points at the next batch's first
            # byte: compressed offset after this batch, in-block offset 0
            voffs_all[-1] = (self._coff + len(comp)) << 16
            first = (-self._n_lines) % self.stride
            for i in range(first, frags.nr_frags, self.stride):
                self._cdx_sites.append(int(frags.start[i]))
                self._cdx_voffs.append(int(voffs_all[i]))
            if self.csi:
                local_to_global = []
                for name in frags.chrom_names:
                    if name not in self._chrom_lookup:
                        self._chrom_lookup[name] = len(self._chrom_names)
                        self._chrom_names.append(name)
                    local_to_global.append(self._chrom_lookup[name])
                gids = np.asarray(local_to_global,
                                  dtype=np.int64)[frags.chrom_id]
                self._csi_acc.add(gids, frags.start.astype(np.int64) - 1,
                                  voffs_all[:-1], voffs_all[1:])
            self._max_len = max(self._max_len,
                                int(frags.length.max(initial=1)))
            self._n_lines += frags.nr_frags
        self._nr_frags += frags.nr_frags
        self._f.write(comp)
        self._coff += len(comp)

    @property
    def nr_frags(self):
        return self._nr_frags

    def abort(self):
        """Close without finalizing (no EOF block, no index sidecars) and
        remove the partial file: a failed run must not leave output that
        looks like a complete one."""
        import os

        if self._f is not None:
            self._f.close()
            self._f = None
        for p in (self.path, self.path + PAT_INDEX_SUFFIX,
                  self.path + ".csi"):
            try:
                os.remove(p)
            except OSError:
                pass

    def close(self):
        if self._f is None:
            return self.path
        self._f.write(_BGZF_EOF)
        self._f.close()
        self._f = None
        if self.index:
            _save_cdx(
                self.path + PAT_INDEX_SUFFIX,
                sites=np.asarray(self._cdx_sites, dtype=np.int64),
                voffsets=np.asarray(self._cdx_voffs, dtype=np.int64),
                max_len=np.int64(self._max_len),
            )
            if self.csi and self._n_lines:
                self._csi_acc.write(self.path + ".csi", self._chrom_names)
        return self.path

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _line_offsets(text: bytes, rows):
    """Byte offsets of the given (sorted) line numbers within `text`."""
    nl = np.frombuffer(text, dtype=np.uint8) == ord("\n")
    line_starts = np.concatenate([[0], np.nonzero(nl)[0] + 1])
    return line_starts[rows]


def index_pat(path, stride=INDEX_STRIDE, csi=True):
    """Build the .cdx sidecar (and a tabix-compatible .csi) for an existing
    BGZF pat.gz (ref cmd: index, src/python/index.py)."""
    if not is_gzip(path):
        raise IllegalArgumentError(f"pat index requires a bgzipped file: {path}")
    reader = BgzfReader(path)
    sites, voffs = [], []
    all_sites, all_voffs, chrom_per_line = [], [], []
    max_len = 1
    i = 0
    while True:
        voff = reader.virtual_offset
        line = reader.readline()
        if not line:
            break
        tokens = line.split(b"\t", 3)
        if len(tokens) < 3:
            continue
        if i % stride == 0:
            sites.append(int(tokens[1]))
            voffs.append(voff)
        if csi:
            all_sites.append(int(tokens[1]))
            all_voffs.append(voff)
            chrom_per_line.append(tokens[0])
        max_len = max(max_len, len(tokens[2]))
        i += 1
    end_voff = reader.virtual_offset
    reader.close()
    _save_cdx(
        path + PAT_INDEX_SUFFIX,
        sites=np.asarray(sites, dtype=np.int64),
        voffsets=np.asarray(voffs, dtype=np.int64),
        max_len=np.int64(max_len),
    )
    if csi and all_sites:
        from .csi import write_csi

        chrom_names = []
        lookup = {}
        ids = np.empty(len(chrom_per_line), dtype=np.int32)
        for k, c in enumerate(chrom_per_line):
            name = c.decode()
            if name not in lookup:
                lookup[name] = len(chrom_names)
                chrom_names.append(name)
            ids[k] = lookup[name]
        va = np.asarray(all_voffs + [end_voff], dtype=np.int64)
        write_csi(path + ".csi", chrom_names, ids,
                  np.asarray(all_sites, dtype=np.int64) - 1, va[:-1], va[1:])
    return path + PAT_INDEX_SUFFIX


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
