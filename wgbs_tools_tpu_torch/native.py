"""ctypes bindings of the port's host library (host/wgbsio.cpp and
host/segment_exact.cpp).

The port's own copy of the wrappers it calls from
wgbs_tools_tpu/native/__init__.py, with the same names. g++ builds the
library from both sources (SOURCE, SEGMENT_SOURCE) at first use (never at
import) into `build/` beside this file, and again when either source is
newer than the library. The port has no Python fallback: a library that
cannot be built or loaded raises, with g++'s output. A wrapper returns
None only where its input is refused (a malformed pat line, a buffer that
is not BGZF, a count above 255), as the JAX package's do.
"""

import ctypes
import os
import os.path as op
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

_PKG_DIR = op.dirname(op.abspath(__file__))
SOURCE = op.join(_PKG_DIR, "host", "wgbsio.cpp")
SEGMENT_SOURCE = op.join(_PKG_DIR, "host", "segment_exact.cpp")
BUILD_DIR = op.join(_PKG_DIR, "build")
_SO = op.join(BUILD_DIR, "libwgbs_host.so")

_LIB = None
_LOCK = threading.Lock()


def build(force=False):
    """Compile the host sources into the shared library if it is missing or
    older than a source. Returns the library path; raises on failure."""
    sources = [SOURCE, SEGMENT_SOURCE]
    newest = max(op.getmtime(s) for s in sources)
    if not force and op.isfile(_SO) and op.getmtime(_SO) >= newest:
        return _SO
    os.makedirs(BUILD_DIR, exist_ok=True)
    # built under a private name, then renamed: a concurrent loader never
    # sees a half-written library
    tmpdir = tempfile.mkdtemp(dir=BUILD_DIR)
    try:
        tmp_so = op.join(tmpdir, "lib.so")
        cmd = ["g++", "-O3", "-shared", "-fPIC", "-o", tmp_so] + sources \
            + ["-lz", "-lpthread"]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run g++ to build the host library: "
                               f"{e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp_so, _SO)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    return _SO


def _bind(lib):
    i64, vp = ctypes.c_int64, ctypes.c_void_p
    lib.pat_scan.restype = ctypes.c_int
    lib.pat_scan.argtypes = [vp, i64, ctypes.POINTER(i64), ctypes.POINTER(i64)]
    lib.pat_parse.restype = ctypes.c_int
    lib.pat_parse.argtypes = [vp, i64, i64, i64] + [vp] * 5 \
        + [ctypes.c_char_p, i64, vp]
    lib.bgzf_scan_blocks.restype = i64
    lib.bgzf_scan_blocks.argtypes = [ctypes.c_char_p, i64, vp, vp, i64]
    lib.bgzf_compress_mt.restype = i64
    lib.bgzf_compress_mt.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p,
                                     ctypes.c_int, ctypes.c_int]
    lib.bgzf_decompress_mt.restype = ctypes.c_int
    lib.bgzf_decompress_mt.argtypes = [ctypes.c_char_p, i64, vp, vp, i64,
                                       ctypes.c_char_p, ctypes.c_int]
    lib.bed_scan.restype = i64
    lib.bed_scan.argtypes = [vp, i64, i64] + [vp] * 4 + [ctypes.POINTER(i64)]
    lib.pat_pileup.restype = None
    lib.pat_pileup.argtypes = [vp] * 4 + [i64] * 4 + [vp, ctypes.c_int]
    lib.pack_rows128.restype = i64
    lib.pack_rows128.argtypes = [vp] * 4 + [i64] + [vp] * 3
    lib.place_pack_rows.restype = i64
    lib.place_pack_rows.argtypes = [vp, i64, i64] + [vp] * 6
    lib.place_counts_rows.restype = i64
    lib.place_counts_rows.argtypes = [vp] * 4 + [i64, vp]
    lib.place_vals_rows.restype = i64
    lib.place_vals_rows.argtypes = [vp, i64, i64] + [vp] * 8
    lib.stage_prep_v3.restype = i64
    lib.stage_prep_v3.argtypes = [vp, vp, vp] + [i64] * 5 \
        + [ctypes.c_int] + [vp] * 7
    lib.segment_exact_dp.restype = i64
    lib.segment_exact_dp.argtypes = [vp, i64, i64, vp, ctypes.c_int32,
                                     ctypes.c_uint32, ctypes.c_float, vp]
    lib.pat_serialize.restype = i64
    lib.pat_serialize.argtypes = [i64, i64] + [vp] * 5 + [ctypes.c_char_p,
                                                          vp, i64]
    lib.bam_count.restype = i64
    lib.bam_count.argtypes = [ctypes.c_char_p, i64, i64]
    lib.bam_scan.restype = i64
    lib.bam_scan.argtypes = [ctypes.c_char_p, i64, i64, i64, vp, vp, vp]
    lib.bam_mmml_scan.restype = i64
    lib.bam_mmml_scan.argtypes = [ctypes.c_char_p, i64] + [vp] * 6
    lib.mm_count.restype = i64
    lib.mm_count.argtypes = [ctypes.c_char_p, i64] + [vp] * 4
    lib.mm_fill.restype = i64
    lib.mm_fill.argtypes = [ctypes.c_char_p, i64] + [vp] * 8


def get_lib():
    """The loaded host library, building it first if needed; raises when
    it cannot be built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            try:
                lib = ctypes.CDLL(build())
                _bind(lib)
            except (RuntimeError, OSError, AttributeError) as e:
                raise RuntimeError(
                    f"the host library ({SOURCE}, {SEGMENT_SOURCE}) could "
                    f"not be built or loaded (needs g++ and zlib): {e}") from e
            _LIB = lib
    return _LIB


def _c(a, dtype):
    return np.ascontiguousarray(a, dtype=dtype)


def parse_pat_native(data: bytes, threads=None):
    """pat text -> (starts, lengths, counts, codes, chrom_ids, chrom_names,
    extras) via the C++ parser, or None when a line is malformed.

    Large buffers parse in parallel: the text splits at line boundaries
    into per-thread ranges (scan + parse per range, GIL released inside
    the C calls), each range writing its rows directly into the shared
    output at its prefix offset; per-range chromosome tables merge in
    range order, which equals first-appearance order over the whole
    buffer."""
    lib = get_lib()
    if not data:
        return None
    view = np.frombuffer(data, dtype=np.uint8)  # zero-copy address anchor
    base = view.ctypes.data
    n_bytes = len(data)
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    if n_bytes < (4 << 20):
        threads = 1
    cuts = [0]
    for t in range(1, threads):
        pos = n_bytes * t // threads
        nl = data.find(b"\n", pos)
        pos = n_bytes if nl < 0 else nl + 1
        if pos > cuts[-1]:
            cuts.append(pos)
    if cuts[-1] != n_bytes:
        cuts.append(n_bytes)
    ranges = list(zip(cuts[:-1], cuts[1:]))

    def scan(rng):
        a, b = rng
        nl_ = ctypes.c_int64()
        ml_ = ctypes.c_int64()
        rc = lib.pat_scan(base + a, b - a, ctypes.byref(nl_),
                          ctypes.byref(ml_))
        return None if rc != 0 else (nl_.value, ml_.value)

    with ThreadPoolExecutor(len(ranges)) as pool:
        scans = list(pool.map(scan, ranges))
        if any(s is None for s in scans):
            return None
        per_n = [s[0] for s in scans]
        n = sum(per_n)
        L = max(max((s[1] for s in scans), default=1), 1)
        offs = np.concatenate([[0], np.cumsum(per_n)]).astype(np.int64)

        starts = np.empty(n, dtype=np.int32)
        lengths = np.empty(n, dtype=np.int32)
        counts = np.empty(n, dtype=np.int32)
        codes = np.empty((n, L), dtype=np.uint8)
        chrom_ids = np.empty(n, dtype=np.int16)
        extras_off = np.empty(2 * n + 2, dtype=np.int64)
        cbufs = [ctypes.create_string_buffer(65536) for _ in ranges]

        def parse(t):
            a, b = ranges[t]
            o = int(offs[t])
            if per_n[t] == 0:
                return 0
            return lib.pat_parse(
                base + a, b - a, per_n[t], L, starts.ctypes.data + 4 * o,
                lengths.ctypes.data + 4 * o, counts.ctypes.data + 4 * o,
                codes.ctypes.data + L * o, chrom_ids.ctypes.data + 2 * o,
                cbufs[t], 65536, extras_off.ctypes.data + 16 * o)

        rcs = list(pool.map(parse, range(len(ranges))))
    if any(r < 0 for r in rcs):
        return None

    # merge per-range chromosome tables (range order == first appearance)
    chrom_names = []
    cmap = {}
    for t, rc in enumerate(rcs):
        if per_n[t] == 0:
            continue
        local = cbufs[t].value.decode().split("\n")[:rc]
        lut = np.empty(max(rc, 1), dtype=np.int16)
        for i, name in enumerate(local):
            if name not in cmap:
                cmap[name] = len(chrom_names)
                chrom_names.append(name)
            lut[i] = cmap[name]
        sl = slice(int(offs[t]), int(offs[t + 1]))
        if not (np.arange(rc, dtype=np.int16) == lut[:rc]).all():
            chrom_ids[sl] = lut[chrom_ids[sl]]
        # extras offsets are relative to the range start
        extras_off[2 * int(offs[t]) : 2 * int(offs[t + 1])] += ranges[t][0]

    eo = extras_off[: 2 * n].reshape(n, 2)
    extras = None
    if n and (eo[:, 1] > eo[:, 0]).any():
        extras = np.array(
            [data[a:b] if b > a else None for a, b in eo.tolist()],
            dtype=object)
    return starts, lengths, counts, codes, chrom_ids, chrom_names, extras


def bed_scan_native(buf, max_rows=None):
    """One pass over a blocks bed's bytes (a uint8 array) by host/
    wgbsio.cpp::bed_scan: (vals int64 (n, 4): start, end, startCpG,
    endCpG; name int64 (n, 2) and line int64 (n, 2): the first column's
    and the line's bounds; flags uint8 (n,): bit 0 a column left to the
    caller, bit 1 a new name; short_at: the offset of a line of fewer
    than 5 columns that stopped the scan, or -1)."""
    lib = get_lib()
    buf = _c(buf, np.uint8)
    cap = int(np.count_nonzero(buf == ord("\n"))) + 1
    if max_rows is not None:
        cap = min(cap, max_rows)
    vals = np.empty((cap, 4), np.int64)
    name = np.empty((cap, 2), np.int64)
    line = np.empty((cap, 2), np.int64)
    flags = np.empty(cap, np.uint8)
    short_at = ctypes.c_int64(-1)
    n = lib.bed_scan(buf.ctypes.data, buf.size, cap, vals.ctypes.data,
                     name.ctypes.data, line.ctypes.data, flags.ctypes.data,
                     ctypes.byref(short_at))
    return vals[:n], name[:n], line[:n], flags[:n], short_at.value


def bgzf_decompress_native(data: bytes, n_threads=None):
    """Inflate a buffer of whole BGZF blocks on n_threads threads; None when
    the buffer is not BGZF or a block does not inflate."""
    lib = get_lib()
    if not data:
        return None
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    max_blocks = len(data) // 28 + 2
    in_offs = np.empty(max_blocks + 1, dtype=np.int64)
    out_offs = np.empty(max_blocks + 1, dtype=np.int64)
    nb = lib.bgzf_scan_blocks(data, len(data), in_offs.ctypes.data,
                              out_offs.ctypes.data, max_blocks)
    if nb < 0:
        return None  # plain gzip, not BGZF
    total = int(out_offs[nb])
    out = ctypes.create_string_buffer(max(total, 1))
    rc = lib.bgzf_decompress_mt(data, len(data), in_offs.ctypes.data,
                                out_offs.ctypes.data, nb, out,
                                max(n_threads, 1))
    if rc != 0:
        return None
    return out.raw[:total]


def bgzf_compress_native(data: bytes, n_threads=None, level=6):
    """BGZF-compress a buffer on n_threads threads: 65,280-byte blocks,
    then the EOF block."""
    lib = get_lib()
    if n_threads is None:
        n_threads = min(os.cpu_count() or 1, 16)
    n_blocks = (len(data) + 65279) // 65280
    cap = (n_blocks + 2) * (65280 + 1064) + 64
    out = ctypes.create_string_buffer(cap)
    w = lib.bgzf_compress_mt(data, len(data), out, max(n_threads, 1), level)
    return out.raw[:w]


def serialize_pat_native(starts, lengths, counts, codes, chrom_ids,
                         chrom_names):
    """PatFrags columns -> pat text (chrom, start, pattern, count lines)."""
    lib = get_lib()
    n, L = codes.shape
    chrom_buf = ("\n".join(chrom_names) + "\n").encode() + b"\x00"
    cap = int(n * (L + 40) + 1024)
    out = ctypes.create_string_buffer(cap)
    starts = _c(starts, np.int32)
    lengths = _c(lengths, np.int32)
    counts = _c(counts, np.int32)
    codes = _c(codes, np.uint8)
    chrom_ids = _c(chrom_ids, np.int16)
    w = lib.pat_serialize(n, L, starts.ctypes.data, lengths.ctypes.data,
                          counts.ctypes.data, codes.ctypes.data,
                          chrom_ids.ctypes.data, chrom_buf, out, cap)
    if w < 0:
        raise RuntimeError("pat_serialize: output buffer too small")
    return out.raw[:w]


def bam_scan_native(buf: bytes, records_off: int):
    """Columnar scan of a decompressed BAM record region.

    Returns (cols int32 [n, 8], offs int64 [n, 5], rec_end int64 [n]) where
    cols = [ref_id, pos, flag, mapq, l_seq, n_cigar, first_cigar, l_qname]
    and offs = [qname, cigar, seq, qual, tags] byte offsets, or None when
    the records do not scan (a count and a fill that disagree).
    """
    lib = get_lib()
    n = lib.bam_count(buf, len(buf), records_off)
    if n < 0:
        return None
    n = int(n)
    cols = np.zeros((max(n, 1), 8), dtype=np.int32)
    offs = np.zeros((max(n, 1), 5), dtype=np.int64)
    rec_end = np.zeros(max(n, 1), dtype=np.int64)
    got = lib.bam_scan(buf, len(buf), records_off, n, cols.ctypes.data,
                       offs.ctypes.data, rec_end.ctypes.data)
    if got != n:
        return None
    return cols[:n], offs[:n], rec_end[:n]


def bam_mmml_scan_native(buf, tags_off, rec_end):
    """Locate MM/Mm:Z + ML/Ml:B,C aux tags for each record.

    Returns (mm_off, mm_len, ml_off, ml_n) int64 arrays (see wgbsio.cpp for
    the -1 / -9 sentinel conventions).
    """
    lib = get_lib()
    n = tags_off.shape[0]
    tags_off = _c(tags_off, np.int64)
    rec_end = _c(rec_end, np.int64)
    mm_off, mm_len, ml_off, ml_n = (np.empty(max(n, 1), dtype=np.int64)
                                    for _ in range(4))
    lib.bam_mmml_scan(buf, n, tags_off.ctypes.data, rec_end.ctypes.data,
                      mm_off.ctypes.data, mm_len.ctypes.data,
                      ml_off.ctypes.data, ml_n.ctypes.data)
    return mm_off[:n], mm_len[:n], ml_off[:n], ml_n[:n]


def mm_parse_native(buf, mm_off, mm_len):
    """Batch-parse all MM tag strings into a flat section table.

    Returns (sec_rec int32[S], sec_mod int8[S], sec_npdot int8[S],
    sec_part_idx int32[S], sec_nskip int64[S], skips int32[K]) where
    sections appear in record order, or None when the fill disagrees with
    the count.
    """
    lib = get_lib()
    n = mm_off.shape[0]
    mm_off = _c(mm_off, np.int64)
    mm_len = _c(mm_len, np.int64)
    n_sec = np.empty(max(n, 1), dtype=np.int64)
    n_skip = np.empty(max(n, 1), dtype=np.int64)
    lib.mm_count(buf, n, mm_off.ctypes.data, mm_len.ctypes.data,
                 n_sec.ctypes.data, n_skip.ctypes.data)
    S = int(n_sec[:n].sum())
    K = int(n_skip[:n].sum())
    sec_rec = np.empty(max(S, 1), dtype=np.int32)
    sec_mod = np.empty(max(S, 1), dtype=np.int8)
    sec_npdot = np.empty(max(S, 1), dtype=np.int8)
    sec_part_idx = np.empty(max(S, 1), dtype=np.int32)
    sec_nskip = np.empty(max(S, 1), dtype=np.int64)
    skips = np.empty(max(K, 1), dtype=np.int32)
    got = lib.mm_fill(buf, n, mm_off.ctypes.data, mm_len.ctypes.data,
                      sec_rec.ctypes.data, sec_mod.ctypes.data,
                      sec_npdot.ctypes.data, sec_part_idx.ctypes.data,
                      sec_nskip.ctypes.data, skips.ctypes.data)
    if got != S:
        return None
    return (sec_rec[:S], sec_mod[:S], sec_npdot[:S], sec_part_idx[:S],
            sec_nskip[:S], skips[:K])


def stage_prep_native(start, length, count, codes, window_start,
                      window_len, threads=None):
    """The v3 staging's prep in one pass (host/wgbsio.cpp::stage_prep_v3):
    a slab's pat lines over the 1-based window [window_start, window_start
    + window_len) -> its pieces, each inside one 128-site sub-block, in the
    order of the JAX package's staging: int32 (p_g, p_rr, p_len, p_cnt,
    p_src, p_off), the arrays the packer and the placers take, and the
    number of 128-site units cut from lines over 128 sites. A piece's codes
    are codes[p_src, p_off : p_off + p_len], read in place. The counting
    sort of the pieces runs on `threads` threads (default: up to 4 from
    2^16 lines; the pieces are the same for any number). None when a
    length is negative or wider than codes, or a start is outside int32."""
    lib = get_lib()
    start = np.asarray(start)
    if start.dtype != np.int32 and start.size and (
            start.min() < -2**31 or start.max() >= 2**31):
        return None
    start, length, count = (_c(a, np.int32) for a in (start, length, count))
    codes = np.asarray(codes)
    F = start.shape[0]
    if not (start.shape == length.shape == count.shape == (F,)
            and codes.ndim == 2 and codes.shape[0] == F):
        raise ValueError("stage_prep_native: start, length, count and the "
                         "rows of a 2-D codes must be as many")
    if threads is None:
        threads = min(os.cpu_count() or 1, 4) if F >= (1 << 16) else 1
    # a line of L sites gives <= ceil(L / 128) units of <= 2 pieces each
    # (a negative length is refused before any piece is written)
    cap = 2 * (F + int(length.sum(dtype=np.int64)) // 128)
    out = [np.empty(max(cap, 1), np.int32) for _ in range(6)]
    n_split = ctypes.c_int64(0)
    P = lib.stage_prep_v3(
        start.ctypes.data, length.ctypes.data, count.ctypes.data, F,
        codes.shape[1], int(window_start),
        int(window_len), cap, int(threads), *(a.ctypes.data for a in out),
        ctypes.byref(n_split))
    if P < 0:
        return None
    return tuple(a[:P] for a in out) + (n_split.value,)


def pack_rows_native(g, count, rr, ln):
    """First-fit 128-bit-mask interval packing for the v3 pileup staging.

    Pieces grouped by ascending sub-block g; same-(g, count) pieces with
    disjoint [rr, rr+len) share a kernel row. Returns (piece_row int32[n],
    row_g int32[R], row_count int32[R]), or None when the pieces are not
    grouped by g or a piece leaves its sub-block."""
    lib = get_lib()
    g, count, rr, ln = (_c(a, np.int32) for a in (g, count, rr, ln))
    n = g.shape[0]
    piece_row = np.empty(max(n, 1), dtype=np.int32)
    row_g = np.empty(max(n, 1), dtype=np.int32)
    row_count = np.empty(max(n, 1), dtype=np.int32)
    nr = lib.pack_rows128(g.ctypes.data, count.ctypes.data, rr.ctypes.data,
                          ln.ctypes.data, n, piece_row.ctypes.data,
                          row_g.ctypes.data, row_count.ctypes.data)
    if nr < 0:
        return None
    return piece_row[:n], row_g[:nr], row_count[:nr]


def place_pack_native(codes, p_src, p_off, p_rr, p_len, piece_row, words):
    """Fused code placement + planar 2-bit packing into the (R, 8) int32
    word matrix (pre-filled with -1 == all '.'). Returns the piece count,
    or None on a piece outside its sub-block."""
    lib = get_lib()
    codes = _c(codes, np.uint8)
    p_src, p_off, p_rr, p_len, piece_row = (
        _c(a, np.int32) for a in (p_src, p_off, p_rr, p_len, piece_row))
    if words.dtype != np.int32 or not words.flags.c_contiguous:
        raise ValueError("words: want a C-contiguous int32 array")
    got = lib.place_pack_rows(
        codes.ctypes.data, codes.shape[1], p_src.shape[0], p_src.ctypes.data,
        p_off.ctypes.data, p_rr.ctypes.data, p_len.ctypes.data,
        piece_row.ctypes.data, words.ctypes.data)
    return None if got < 0 else int(got)


def place_counts_native(p_cnt, p_rr, p_len, piece_row, cnt_words):
    """Per-lane repeat counts for the count-agnostic v3 packing: write each
    piece's count (< 256) into its lanes' 8-bit fields of the (R, 32)
    int32 word matrix (zero-initialized by the caller). Returns the piece
    count, or None when a count exceeds 255 or a piece leaves its
    sub-block."""
    lib = get_lib()
    p_cnt, p_rr, p_len, piece_row = (_c(a, np.int32)
                                     for a in (p_cnt, p_rr, p_len, piece_row))
    if cnt_words.dtype != np.int32 or not cnt_words.flags.c_contiguous:
        raise ValueError("cnt_words: want a C-contiguous int32 array")
    got = lib.place_counts_rows(
        p_cnt.ctypes.data, p_rr.ctypes.data, p_len.ctypes.data,
        piece_row.ctypes.data, p_cnt.shape[0], cnt_words.ctypes.data)
    return None if got < 0 else int(got)


def place_vals_native(codes, p_src, p_off, p_rr, p_len, p_cnt, piece_row,
                      mv, cv):
    """Pre-masked uint8 value planes for the v3 value-plane staging: write
    each piece's count into mv (where the code is a methylation call) and
    cv (where observed) at its lane positions of the (R, 128) uint8 planes
    (zero-initialized by the caller). Returns the piece count, or None
    when a count exceeds 255 or a piece leaves its sub-block."""
    lib = get_lib()
    codes = _c(codes, np.uint8)
    p_src, p_off, p_rr, p_len, p_cnt, piece_row = (
        _c(a, np.int32) for a in (p_src, p_off, p_rr, p_len, p_cnt,
                                  piece_row))
    for name, plane in (("mv", mv), ("cv", cv)):
        if plane.dtype != np.uint8 or not plane.flags.c_contiguous:
            raise ValueError(f"{name}: want a C-contiguous uint8 array")
    got = lib.place_vals_rows(
        codes.ctypes.data, codes.shape[1], p_src.shape[0], p_src.ctypes.data,
        p_off.ctypes.data, p_rr.ctypes.data, p_len.ctypes.data,
        p_cnt.ctypes.data, piece_row.ctypes.data, mv.ctypes.data,
        cv.ctypes.data)
    return None if got < 0 else int(got)


def pileup_native(start, length, count, codes, window_start, n_sites,
                  out=None, threads=None):
    """Host pileup of pat fragments into an int64 (n_sites, 2) [meth, cov]
    table (ref: stdin2beta.cpp:59-93), the oracle of the device kernels.

    `start` must be sorted ascending when threads > 1 (threads partition the
    site axis and binary-search their fragment range). Adds into `out` when
    given (zero-initialized by the first caller)."""
    lib = get_lib()
    start, length, count = (_c(a, np.int32) for a in (start, length, count))
    codes = _c(codes, np.uint8)
    max_len = codes.shape[1] if codes.ndim == 2 else 0
    if out is None:
        out = np.zeros((n_sites, 2), dtype=np.int64)
    if (out.shape != (n_sites, 2) or out.dtype != np.int64
            or not out.flags.c_contiguous):
        raise ValueError(f"out: want a C-contiguous int64 ({n_sites}, 2) "
                         "array")
    if threads is None:
        threads = min(os.cpu_count() or 1, 8)
    lib.pat_pileup(start.ctypes.data, length.ctypes.data, count.ctypes.data,
                   codes.ctypes.data, start.shape[0], max_len,
                   int(window_start), int(n_sites), out.ctypes.data,
                   int(threads))
    return out


def segment_exact_native(data, loci, max_cpg, max_bp, pseudo_count):
    """Exact-parity segmentation DP traceback via the C++ kernel
    (host/segment_exact.cpp; ref: src/segment_betas/segmentor.cpp:60-159).

    data: (K, n, 2) integer counts; loci: (n,) basepair positions.
    Returns the traceback array T (n+1,) int64; raises on arguments the
    kernel refuses (n, K or max_cpg below 1)."""
    lib = get_lib()
    K, n, _ = data.shape
    dataf = _c(data, np.float32)
    dists = _c(loci, np.uint32)
    T = np.empty(n + 1, dtype=np.int32)
    rc = lib.segment_exact_dp(dataf.ctypes.data, K, n, dists.ctypes.data,
                              int(max_cpg), int(max_bp) if max_bp else 0,
                              float(pseudo_count), T.ctypes.data)
    if rc != 0:
        raise ValueError(f"segment_exact_dp refused its arguments (K={K}, "
                         f"n={n}, max_cpg={max_cpg}): rc {rc}")
    return T.astype(np.int64)
