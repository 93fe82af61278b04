"""Row-packed pileup (v3): host staging, the two CUDA kernels and their
plain PyTorch twins.

Port of wgbs_tools_tpu/ops/pileup_tpu3.py (with pileup_tpu2.py's
`_split_long`). The host staging is the JAX package's, line for line, so
the staged arrays are identical and the tests compare them one to one:
fragments are split at 128-site sub-blocks, the pieces are packed into
rows by the native first-fit packer, and the rows are chunked (at most
rc - 1 rows, g_max sub-blocks and one output tile per chunk). Four staged
forms reach a kernel; while every count is < 256 the first applicable of
them is taken (the JAX package's gates, pileup_tpu3.py:834-843):

- "vals" (`stage_v3()`, the default): one uint8 (rows, 256) plane, lanes
  0-127 = the count where the code is a methylation call, 128-255 = the
  count where the site is observed. Kernel: `flat_vals_fused`.
- "vals_split" (`stage_v3(fused=False)`): the same values in two uint8
  (rows, 128) planes, mv and cv. Kernel: `flat_vals`.
- "lane" (`stage_v3(vals=False)`): rows packed with no regard to count,
  2-bit planar code words (rows, 8) plus (rows, 32) int32 words of
  per-lane 8-bit counts, split into rc classes (16, 128). Kernel:
  `flat_lc`, one launch per class.
- "classic" (any count >= 256, no fragments, or
  `stage_v3(lane_counts=False)`): rows packed per count, code words
  (rows, 8) plus one int32 count per row, in rc classes (16, 128).
  Kernels: `flat_classic` on the flat grid (one CTA per tile), or
  `tiled_classic` on the tiled grid (`call_staged(grid="tiled")`, one CTA
  per staged chunk). The classes' outputs sum.

`flat_vals_add` piles up a batch of either value-plane form and adds it
in place into a given int32 total, in one launch (the sharded path's
kernel).

The staged layout keeps the TPU's constraints for now (rc a multiple of
8, base_g stashed in padding row rc-1, pow2 chunk padding): the Hopper
kernels do not need them, and dropping them is later work guarded by the
staged-array test.

A kernel wrapper sends CUDA tensors to the kernel (csrc/pileup_v3.cu) and
CPU tensors to the kernel's plain twin; any other device raises. Each
wrapper counts its launches in `<wrapper>.launches`.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels, native
from ..formats.pat import CODE_DOT
from ..trace import span

SB = 128  # sites per sub-block = lanes per row
# Hopper gives a block at most 227 KB (232,448 bytes) of dynamic shared
# memory
MAX_SMEM_BYTES = 232_448
# default geometry by form: the JAX package's defaults
# (pileup_tpu3.py:75-97, 1067-1082)
VALS_GEOMETRY = dict(tile=SB * 64, rc=1024, g_max=64, classes=None)
CLASSIC_GEOMETRY = dict(tile=SB * 8, rc=256, g_max=8, classes=(16, 128))


def _native_ok(result, what):
    if result is None:
        raise RuntimeError(f"native {what} refused its input: v3 staging "
                           "has no fallback")
    return result


# ---------------------------------------------------------------------------
# Host staging (numpy)
# ---------------------------------------------------------------------------


def _split_long(start, length, count, codes, max_piece=SB):
    """Split fragments longer than max_piece into independent pieces."""
    start = np.asarray(start, dtype=np.int64)
    length = np.asarray(length, dtype=np.int32)
    count = np.asarray(count, dtype=np.int32)
    codes = np.asarray(codes)
    long = length > max_piece
    if not long.any():
        return start, length, count, codes[:, :max_piece]
    s_out = [start[~long]]
    l_out = [length[~long]]
    c_out = [count[~long]]
    code_out = [codes[~long][:, :max_piece]]
    for i in np.nonzero(long)[0]:
        L = int(length[i])
        for off in range(0, L, max_piece):
            ln = min(max_piece, L - off)
            row = np.full(max_piece, CODE_DOT, dtype=np.uint8)
            row[:ln] = codes[i, off : off + ln]
            s_out.append(np.array([start[i] + off]))
            l_out.append(np.array([ln], dtype=np.int32))
            c_out.append(np.array([count[i]], dtype=np.int32))
            code_out.append(row[None])
    start = np.concatenate(s_out)
    order = np.argsort(start, kind="stable")
    return (
        start[order],
        np.concatenate(l_out)[order],
        np.concatenate(c_out)[order],
        np.concatenate(code_out)[order],
    )


def _prep_window(start, length, count, codes, window_start, window_len):
    """Split long frags, clip to the window; returns (rel, length, count,
    codes) with rel in [0, window_len) and length <= SB."""
    codes = np.asarray(codes)
    start, length, count, codes = _split_long(start, length, count, codes)
    rel = (np.asarray(start) - window_start).astype(np.int64)
    keep = (rel + length > 0) & (rel < window_len)
    rel, length, count, codes = (rel[keep], length[keep], count[keep],
                                 codes[keep])
    neg = np.nonzero(rel < 0)[0]
    if neg.size:
        codes = codes.copy()
        width = codes.shape[1]
        for idx in neg:
            sh = int(-rel[idx])
            row = np.full(width, CODE_DOT, dtype=np.uint8)
            ln = max(int(length[idx]) - sh, 0)
            if ln > 0:
                row[:ln] = codes[idx, sh : sh + ln]
            codes[idx] = row
            length[idx] = ln
            rel[idx] = 0
        pos = length > 0
        rel, length, count, codes = (rel[pos], length[pos], count[pos],
                                     codes[pos])
    return rel, length, count, codes


def stage_v3(start, length, count, codes, window_start, window_len,
             tile=None, rc=None, g_max=None, classes="auto",
             lane_counts=True, vals=True, fused=True):
    """Host staging of one fragment batch over the 1-based window
    [window_start, window_start + window_len).

    Returns the JAX package's staged tuple (numpy), byte for byte, for the
    same keywords (each the negation of one of its switches:
    lane_counts=False is WGBS_TPU_V3_LANE_COUNTS=0, vals=False
    WGBS_TPU_V3_VALS=0, fused=False WGBS_TPU_V3_FUSED_PLANE=0). While every
    count is < 256: with lane_counts and vals, (c0, c1, meta, plane, None,
    max_chunks, tile, rc, g_max, "vals"), or with fused=False the split
    planes (c0, c1, meta, mv, cv, ..., "vals"); with lane_counts alone a
    list with one lane-count tuple (c0, c1, meta, words, cnts, max_chunks,
    tile, rc, g_max) per rc class. Otherwise (a count >= 256, no fragments,
    or lane_counts=False) a list with one classic tuple (c0, c1, meta,
    words, max_chunks, tile, rc, g_max) per rc class. vals needs
    lane_counts and fused needs vals, as in JAX. Geometry left as None
    takes the form's default (VALS_GEOMETRY, or CLASSIC_GEOMETRY for both
    code-word forms); explicit `classes` set rc to the largest class.
    Raises when the host library cannot be built (native.get_lib) or a
    native call refuses its input, where the JAX package falls back to
    another form or to v2."""
    native.get_lib()
    with span("pileup.stage.prep"):
        rel, length, count, codes = _prep_window(
            start, length, count, codes, window_start, window_len)
        F = rel.shape[0]

        # split at sub-block boundaries: each fragment (len <= SB) yields <= 2
        # pieces, each inside a single sub-block
        rr_all = (rel % SB).astype(np.int64)
        g_all = (rel // SB).astype(np.int64)
        len1 = np.minimum(length, SB - rr_all).astype(np.int64)
        len2 = (length - len1).astype(np.int64)
        has2 = len2 > 0

        p_g = np.concatenate([g_all, g_all[has2] + 1])
        p_rr = np.concatenate([rr_all, np.zeros(int(has2.sum()), np.int64)])
        p_len = np.concatenate([len1, len2[has2]])
        p_cnt = np.concatenate([count, count[has2]]).astype(np.int32)
        # piece code source: (frag index, column offset within the fragment)
        p_src = np.concatenate([np.arange(F), np.nonzero(has2)[0]])
        p_off = np.concatenate([np.zeros(F, np.int64), len1[has2]])

        order = np.argsort(p_g, kind="stable")
        p_g, p_rr, p_len, p_cnt = (p_g[order], p_rr[order], p_len[order],
                                   p_cnt[order])
        p_src, p_off = p_src[order], p_off[order]

    # value planes and count words hold one count per byte: any count >=
    # 256 (and the empty batch, as in JAX) takes the classic per-count-row
    # form
    lane_counts = bool(lane_counts and F and int(p_cnt.max(initial=0)) < 256)
    vals = bool(vals and lane_counts)
    fused = bool(fused and vals)
    geom = VALS_GEOMETRY if vals else CLASSIC_GEOMETRY
    if classes == "auto":
        classes = geom["classes"]
    tile = geom["tile"] if tile is None else tile
    rc = geom["rc"] if rc is None else rc
    g_max = geom["g_max"] if g_max is None else g_max
    if classes is not None:
        classes = tuple(sorted(int(c) for c in classes))
        if not classes or classes[0] < 8 or any(c % 8 for c in classes):
            raise ValueError(f"bad rc classes {classes}: each must be a "
                             "multiple of 8, >= 8")
        rc = classes[-1]
    if tile % SB:
        raise ValueError(f"tile={tile} must be a multiple of SB={SB}")
    tile_sb = tile // SB

    with span("pileup.stage.pack"):
        if F:
            # value-plane and lane-count rows are count-agnostic: pieces of
            # any count share
            pk_cnt = np.ones_like(p_cnt) if lane_counts else p_cnt
            packed = _native_ok(native.pack_rows_native(p_g, pk_cnt, p_rr,
                                                        p_len),
                                "pack_rows128")
        else:
            packed = (np.zeros(0, np.int32),) * 3
    piece_row, row_g, row_count = packed
    R = row_g.shape[0]

    with span("pileup.stage.place"):
        if vals:
            all_mv = np.zeros((max(R, 1), SB), dtype=np.uint8)
            all_cv = np.zeros((max(R, 1), SB), dtype=np.uint8)
            _native_ok(native.place_vals_native(codes, p_src, p_off, p_rr,
                                                p_len, p_cnt, piece_row,
                                                all_mv, all_cv),
                       "place_vals_rows")
        else:
            all_words = np.full((max(R, 1), SB // 16), -1, dtype=np.int32)
            if F:
                _native_ok(native.place_pack_native(codes, p_src, p_off,
                                                    p_rr, p_len, piece_row,
                                                    all_words),
                           "place_pack_rows")
        all_cnts = None
        if lane_counts and not vals:
            all_cnts = np.zeros((R, SB // 4), dtype=np.int32)  # R >= 1
            _native_ok(native.place_counts_native(p_cnt, p_rr, p_len,
                                                  piece_row, all_cnts),
                       "place_counts_rows")

    with span("pileup.stage.assemble"):
        # chunking over rows: bounded rows, sub-block span, single tile
        row_tile = row_g // tile_sb
        breaks = [0]
        cstart = 0
        while cstart < R:
            lim1 = cstart + rc - 1
            lim2 = int(np.searchsorted(row_g, row_g[cstart] + g_max,
                                       side="left"))
            lim3 = int(np.searchsorted(row_tile, row_tile[cstart] + 1,
                                       side="left"))
            nxt = max(min(lim1, lim2, lim3, R), cstart + 1)
            breaks.append(nxt)
            cstart = nxt
        bstarts = np.asarray(breaks[:-1], dtype=np.int64)
        bends = np.asarray(breaks[1:], dtype=np.int64)
        if not R:
            if vals:
                all_mv = np.zeros((0, SB), dtype=np.uint8)
                all_cv = np.zeros((0, SB), dtype=np.uint8)
            else:
                all_words = np.zeros((0, SB // 16), dtype=np.int32)
        rows = (all_mv, all_cv) if vals else all_words
        num_tiles = (window_len + tile - 1) // tile
        if classes is None:
            return _assemble_class(row_g, row_tile, row_count, rows, bstarts,
                                   bends, rc, g_max, tile, num_tiles, R, fused,
                                   all_cnts)
        out = []
        lens_c = bends - bstarts
        lo = 0
        for rc_c in classes:
            # a class-rc_c chunk holds at most rc_c - 1 rows: row rc_c - 1 must
            # stay padding (it carries the base_g stash)
            sel = (lens_c > lo) & (lens_c <= rc_c - 1) if rc_c != classes[-1] \
                else (lens_c > lo)
            out.append(_assemble_class(
                row_g, row_tile, row_count, rows, bstarts[sel], bends[sel],
                rc_c, g_max, tile, num_tiles, R, fused, all_cnts))
            lo = rc_c - 1
        return out


def _assemble_class(row_g, row_tile, row_count, rows, bstarts, bends, rc,
                    g_max, tile, num_tiles, R, fused, all_cnts=None):
    """One staged tuple from a (sorted, disjoint) subset of chunk row
    ranges. `rows` is (mv, cv) for the value-plane form, which becomes one
    fused (n_chunks*rc, 256) plane, or with fused=False two (n_chunks*rc,
    128) planes; or the (R, 8) code words of the code-word forms, with
    all_cnts the lane-count form's (R, 32) count words (the tuple's 5th
    field). Padding rows are zero values / all-'.' words / zero counts."""
    vals = isinstance(rows, tuple)
    n_real = max(bstarts.shape[0], 1)
    gran = 1 << max(4, n_real.bit_length() - 3)
    n_chunks = (n_real + gran - 1) // gran * gran

    meta = np.zeros((n_chunks, 2, rc), dtype=np.int32)
    meta[:, 1, :] = g_max  # padding rows select no sub-block
    cvp = None
    if vals and fused:
        plane = np.zeros((n_chunks * rc, 2 * SB), dtype=np.uint8)
    elif vals:
        plane = np.zeros((n_chunks * rc, SB), dtype=np.uint8)
        cvp = np.zeros((n_chunks * rc, SB), dtype=np.uint8)
    else:
        plane = np.full((n_chunks * rc, SB // 16), -1,
                        dtype=np.int32)  # all '.'
    cnts = (None if all_cnts is None else
            np.zeros((n_chunks * rc, SB // 4), dtype=np.int32))
    if R and bstarts.shape[0]:
        lens_c = bends - bstarts
        ci_arr = np.repeat(np.arange(bstarts.shape[0]), lens_c)
        src = np.repeat(bstarts, lens_c) + (
            np.arange(int(lens_c.sum())) -
            np.repeat(np.cumsum(lens_c) - lens_c, lens_c))
        pos_arr = src - np.repeat(bstarts, lens_c)
        base_g = row_g[bstarts]
        meta[ci_arr, 0, pos_arr] = row_count[src]
        meta[ci_arr, 1, pos_arr] = (row_g[src] - base_g[ci_arr]).astype(
            np.int32)
        # base_g stashed in the guaranteed-padding row rc-1 (offset by g_max
        # so the padding default there still selects no sub-block)
        meta[: bstarts.shape[0], 1, rc - 1] = base_g + g_max
        dst = ci_arr * rc + pos_arr
        if vals:
            plane[dst, :SB] = rows[0][src]
            if fused:
                plane[dst, SB:] = rows[1][src]
            else:
                cvp[dst] = rows[1][src]
        else:
            plane[dst] = rows[src]
            if cnts is not None:
                cnts[dst] = all_cnts[src]
        chunk_tile = row_tile[bstarts]
        c0 = np.searchsorted(chunk_tile, np.arange(num_tiles), side="left")
        c1 = np.searchsorted(chunk_tile, np.arange(num_tiles), side="right")
    else:
        c0 = np.zeros(num_tiles, dtype=np.int64)
        c1 = np.zeros(num_tiles, dtype=np.int64)
    # kept for layout identity with JAX (its tiled grid's step count)
    max_chunks = max(int((c1 - c0).max(initial=1)), 1)
    max_chunks = 1 << (max_chunks - 1).bit_length()
    c0, c1 = c0.astype(np.int32), c1.astype(np.int32)
    if vals:
        return (c0, c1, meta, plane, cvp, max_chunks, tile, rc, g_max,
                "vals")
    if cnts is not None:
        return (c0, c1, meta, plane, cnts, max_chunks, tile, rc, g_max)
    return (c0, c1, meta, plane, max_chunks, tile, rc, g_max)


# ---------------------------------------------------------------------------
# Staged batches on a device
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Staged:
    """One staged batch as tensors on one device.

    form "vals": rows = uint8 (n_chunks*rc, 256), the fused meth|cov value
    plane. form "vals_split": rows = the uint8 (n_chunks*rc, 128) meth
    plane mv, and cv the cov plane of the same shape. form "classic": rows
    = int32 (n_chunks*rc, 8), planar 2-bit code words, with each row's
    repeat count in meta[:, 0]. form "lane": the same code words, and cnts
    = int32 (n_chunks*rc, 32) per-lane 8-bit counts. c0/c1 = int32
    (num_tiles,) chunk range of each output tile; meta = int32 (n_chunks,
    2, rc). cv is None except in the "vals_split" form, cnts except in the
    "lane" form. max_chunks (the JAX tiled grid's chunk steps, >= the most
    chunks of any tile; no kernel of the port reads it) is None when not
    given."""

    form: str
    c0: torch.Tensor
    c1: torch.Tensor
    meta: torch.Tensor
    rows: torch.Tensor
    tile: int
    rc: int
    g_max: int
    cv: torch.Tensor = None
    cnts: torch.Tensor = None
    max_chunks: int = None

    @property
    def tile_sb(self):
        return self.tile // SB

    @property
    def device(self):
        return self.meta.device


def staged_from_numpy(staged, device):
    """A numpy staged tuple (from this module's or the JAX package's
    stage_v3), or a list of them, -> Staged tensors on `device`.

    Every form the JAX package stages is accepted: the value planes, fused
    or split (10 fields, tagged "vals"), the lane-count form (9 fields) and
    the classic form (8 fields); any other tuple raises. The chunk ranges
    are checked here, on the host, because the kernels index chunks with
    them (the tiled kernel finds a chunk's tile by a search of c1, so the
    tiles' ranges must ascend and not overlap), and max_chunks for layout
    identity with the JAX package's tuple."""
    if isinstance(staged, list):
        return [staged_from_numpy(st, device) for st in staged]
    cvp = cnts = None
    if len(staged) == 10:
        c0, c1, meta, rows, cvp, max_chunks, tile, rc, g_max, tag = staged
        if tag != "vals":
            raise ValueError(f"a 10-field staged tuple tagged {tag!r}: only "
                             "the value-plane form ('vals') exists")
        form = "vals" if cvp is None else "vals_split"
    elif len(staged) == 9:
        c0, c1, meta, rows, cnts, max_chunks, tile, rc, g_max = staged
        form = "lane"
    elif len(staged) == 8:
        c0, c1, meta, rows, max_chunks, tile, rc, g_max = staged
        form = "classic"
    else:
        raise ValueError(f"a staged tuple of {len(staged)} fields: a v3 "
                         "staged form has 8 (classic), 9 (lane-count) or 10 "
                         "(value-plane)")
    c0, c1 = np.asarray(c0), np.asarray(c1)
    n_chunks = np.asarray(meta).shape[0]
    if ((c0 < 0) | (c0 > c1) | (c1 > n_chunks)).any():
        raise ValueError("staged chunk ranges c0/c1 out of bounds")
    if (c0[1:] < c1[:-1]).any():
        raise ValueError("staged chunk ranges c0/c1 overlap or descend: the "
                         "tiles' ranges must ascend, one after another")
    if int(max_chunks) < max(int((c1 - c0).max(initial=0)), 1):
        raise ValueError(f"max_chunks={max_chunks} is below the chunks of a "
                         "tile")
    dev = torch.device(device)

    def put(a):
        return None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)).to(dev)

    return Staged(form, put(c0), put(c1), put(meta), put(rows), int(tile),
                  int(rc), int(g_max), put(cvp), put(cnts), int(max_chunks))


# (width, dtype) of the rows (and of cv, for "vals_split") by form
_ROWS = {"vals": (2 * SB, torch.uint8), "vals_split": (SB, torch.uint8),
         "classic": (SB // 16, torch.int32), "lane": (SB // 16, torch.int32)}


def _smem_bytes(st):
    """Dynamic shared memory of the staged form's kernel (csrc/pileup_v3.cu):
    the value-plane body keeps a padded tile_sb x 272 int32 accumulator and
    a 1024-row dg window (vals_smem_bytes), the code-word body a padded
    tile_sb x 264 int32 accumulator and a 512-row list of three int32 each
    (codes_smem_bytes)."""
    if st.form in ("vals", "vals_split"):
        return (st.tile_sb * (2 * SB + 16) + 1024) * 4
    return (st.tile_sb * (2 * SB + 8) + 3 * 512) * 4


def _check(st, forms, window_len):
    """Validate a staged batch for a kernel that takes `forms`; returns
    num_tiles."""
    if st.form not in forms:
        raise ValueError(f"staged form {st.form!r} given to a kernel of "
                         f"form {' or '.join(map(repr, forms))}")
    if window_len < 1:
        raise ValueError(f"window_len={window_len} must be >= 1")
    if st.tile % SB or st.tile < SB:
        raise ValueError(f"tile={st.tile} must be a positive multiple of "
                         f"{SB}")
    if st.rc < 2 or st.g_max < 1:
        raise ValueError(f"rc={st.rc}, g_max={st.g_max}: a chunk needs a "
                         "padding row (rc >= 2) and g_max >= 1")
    if _smem_bytes(st) > MAX_SMEM_BYTES:
        raise ValueError(f"tile={st.tile}: the tile accumulator exceeds "
                         f"{MAX_SMEM_BYTES} bytes of shared memory")
    num_tiles = (window_len + st.tile - 1) // st.tile
    n_chunks = st.meta.shape[0]
    if n_chunks * st.rc >= 2**31:
        raise ValueError(f"{n_chunks} chunks of rc={st.rc} rows: the kernels "
                         "index rows with int32")
    width, dtype = _ROWS[st.form]
    want = {"c0": ((num_tiles,), torch.int32),
            "c1": ((num_tiles,), torch.int32),
            "meta": ((n_chunks, 2, st.rc), torch.int32),
            "rows": ((n_chunks * st.rc, width), dtype)}
    if st.form == "vals_split":
        want["cv"] = want["rows"]
    elif st.cv is not None:
        raise ValueError(f"staged form {st.form!r} carries no cv plane")
    if st.form == "lane":
        want["cnts"] = ((n_chunks * st.rc, SB // 4), torch.int32)
    elif st.cnts is not None:
        raise ValueError(f"staged form {st.form!r} carries no count words")
    for name, (shape, dt) in want.items():
        x = getattr(st, name)
        if (tuple(x.shape) != shape or x.dtype != dt
                or x.device != st.device or not x.is_contiguous()):
            raise ValueError(
                f"staged {name}: got {x.dtype} {tuple(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()}), want {dt} "
                f"{shape} on {st.device}, contiguous")
    return num_tiles


def _launch(name, st, window_len, num_tiles, planes, out, *extra):
    """Launch the kernel `name` of csrc/pileup_v3.cu on the staged device's
    current stream (see _kernels.launch), writing or adding into `out`;
    returns `out`. `planes` are the data pointers of the rows (None for an
    absent cv), `extra` int arguments after g_max."""
    _kernels.launch(name, st.device, st.c0.data_ptr(), st.c1.data_ptr(),
                    st.meta.data_ptr(), *planes, out.data_ptr(), num_tiles,
                    window_len, st.tile_sb, st.rc, st.g_max, *extra)
    return out


def _plane_ptrs(st):
    """Data pointers of a value-plane batch's planes (rows, then cv when
    split); the kernel loads 16-byte vectors, so each must be 16-aligned."""
    ptrs = tuple(p.data_ptr() for p in (st.rows, st.cv) if p is not None)
    if any(p % 16 for p in ptrs):
        raise ValueError("staged value planes: the kernel loads 16-byte "
                         "vectors; each plane's data pointer must be "
                         "16-aligned")
    return ptrs


def _new_out(st, window_len):
    return torch.empty((window_len, 2), dtype=torch.int32, device=st.device)


def flat_vals_fused(st, window_len):
    """Pileup of a "vals" staged batch -> int32 (window_len, 2) [meth, cov].

    Replaces pileup_tpu3.py::_kernel_flat_vals_fused. CUDA tensors launch
    the kernel; CPU tensors take flat_vals_fused_plain."""
    num_tiles = _check(st, ("vals",), window_len)
    if st.device.type == "cpu":
        return flat_vals_fused_plain(st, window_len)
    out = _launch("pileup_flat_vals_fused", st, window_len, num_tiles,
                  _plane_ptrs(st), _new_out(st, window_len))
    flat_vals_fused.launches += 1
    return out


flat_vals_fused.launches = 0


def flat_vals(st, window_len):
    """Pileup of a "vals_split" staged batch -> int32 (window_len, 2).

    Replaces pileup_tpu3.py::_kernel_flat_vals. CUDA tensors launch the
    kernel; CPU tensors take flat_vals_plain."""
    num_tiles = _check(st, ("vals_split",), window_len)
    if st.device.type == "cpu":
        return flat_vals_plain(st, window_len)
    out = _launch("pileup_flat_vals", st, window_len, num_tiles,
                  _plane_ptrs(st), _new_out(st, window_len))
    flat_vals.launches += 1
    return out


flat_vals.launches = 0


def flat_vals_add(total, st, window_len):
    """total += the pileup of a value-plane staged batch ("vals" or
    "vals_split"), in place; returns total.

    `total` is int32 (window_len, 2), contiguous (a row slice of a larger
    table will do) and on the staged device. Replaces
    pileup_tpu3.py::pileup_vals_add (kernel, stack and add on a donated
    total, one dispatch) with one launch that adds each tile into the total;
    tiles that get no chunk leave their rows untouched, and the add wraps as
    int32. The launch is queued on the current stream, with no
    synchronisation. CPU tensors take flat_vals_add_plain."""
    num_tiles = _check(st, ("vals", "vals_split"), window_len)
    if (total.dtype != torch.int32 or tuple(total.shape) != (window_len, 2)
            or total.device != st.device or not total.is_contiguous()):
        raise ValueError(
            f"total: got {total.dtype} {tuple(total.shape)} on "
            f"{total.device} (contiguous={total.is_contiguous()}), want "
            f"torch.int32 {(window_len, 2)} on {st.device}, contiguous")
    if st.device.type == "cpu":
        return flat_vals_add_plain(total, st, window_len)
    if total.data_ptr() % 8:
        raise ValueError("total: the kernel reads (meth, cov) pairs as "
                         "8-byte words; its data pointer must be 8-aligned")
    planes = _plane_ptrs(st)
    _launch("pileup_flat_vals_add", st, window_len, num_tiles,
            planes + (None,) * (2 - len(planes)), total)
    flat_vals_add.launches += 1
    return total


flat_vals_add.launches = 0


def flat_classic(st, window_len):
    """Pileup of a "classic" staged batch -> int32 (window_len, 2).

    Replaces pileup_tpu3.py::_kernel_flat. CUDA tensors launch the kernel;
    CPU tensors take flat_classic_plain."""
    num_tiles = _check(st, ("classic",), window_len)
    if st.device.type == "cpu":
        return flat_classic_plain(st, window_len)
    out = _launch("pileup_flat_classic", st, window_len, num_tiles,
                  (st.rows.data_ptr(),), _new_out(st, window_len))
    flat_classic.launches += 1
    return out


flat_classic.launches = 0


def flat_lc(st, window_len):
    """Pileup of a "lane" staged batch -> int32 (window_len, 2).

    Replaces pileup_tpu3.py::_kernel_flat_lc. CUDA tensors launch the
    kernel; CPU tensors take flat_lc_plain."""
    num_tiles = _check(st, ("lane",), window_len)
    if st.device.type == "cpu":
        return flat_lc_plain(st, window_len)
    out = _launch("pileup_flat_lc", st, window_len, num_tiles,
                  (st.rows.data_ptr(), st.cnts.data_ptr()),
                  _new_out(st, window_len))
    flat_lc.launches += 1
    return out


flat_lc.launches = 0


def tiled_classic(st, window_len):
    """Pileup of a "classic" staged batch on the tiled grid -> int32
    (window_len, 2): one CTA per staged chunk, each adding its chunk into
    the zeroed output with atomics.

    Replaces pileup_tpu3.py::_kernel (the JAX package's
    WGBS_TPU_PILEUP_V3_GRID=tiled). CUDA tensors launch the kernel; CPU
    tensors take tiled_classic_plain."""
    num_tiles = _check(st, ("classic",), window_len)
    if st.device.type == "cpu":
        return tiled_classic_plain(st, window_len)
    out = _launch("pileup_tiled_classic", st, window_len, num_tiles,
                  (st.rows.data_ptr(),), _new_out(st, window_len),
                  st.meta.shape[0])
    tiled_classic.launches += 1
    return out


tiled_classic.launches = 0


# ---------------------------------------------------------------------------
# Plain PyTorch twins (the CPU path, and the kernels' oracle on the card)
# ---------------------------------------------------------------------------


def chunk_tiles(c0, c1, n_chunks):
    """int64 (n_chunks,) output tile of each chunk, from the per-tile chunk
    ranges [c0[t], c1[t]), or -1 for a chunk in no tile's range."""
    dev = c0.device
    lens = (c1 - c0).to(torch.int64)
    n_in = int(lens.sum())
    tiles = torch.repeat_interleave(
        torch.arange(c0.shape[0], dtype=torch.int64, device=dev), lens)
    firsts = torch.repeat_interleave(c0.to(torch.int64), lens)
    offs = (torch.arange(n_in, dtype=torch.int64, device=dev)
            - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    chunk_tile = torch.full((n_chunks,), -1, dtype=torch.int64, device=dev)
    chunk_tile[firsts + offs] = tiles
    return chunk_tile


def _row_targets(st, num_tiles):
    """Accumulator row (global sub-block) of every staged row, or the drop
    row num_tiles * tile_sb where a kernel skips the row: padding rows
    (dg outside [0, g_max)), chunks in no tile's range, and sub-blocks
    outside their chunk's tile."""
    ct = chunk_tiles(st.c0, st.c1, st.meta.shape[0])[:, None]
    dg = st.meta[:, 1, :].to(torch.int64)
    sb = dg[:, -1:] - st.g_max - ct * st.tile_sb + dg  # sub-block in tile
    ok = ((ct >= 0) & (dg >= 0) & (dg < st.g_max) & (sb >= 0)
          & (sb < st.tile_sb))
    return torch.where(ok, ct * st.tile_sb + sb,
                       num_tiles * st.tile_sb).reshape(-1)


def _scatter_rows(st, vals, window_len):
    """index_add_ int32 (rows, 256) meth|cov values into a per-sub-block
    accumulator -> (window_len, 2)."""
    num_tiles = (window_len + st.tile - 1) // st.tile
    acc = torch.zeros((num_tiles * st.tile_sb + 1, 2 * SB),
                      dtype=torch.int32, device=st.device)
    acc.index_add_(0, _row_targets(st, num_tiles), vals)
    acc = acc[:-1]
    return torch.stack([acc[:, :SB].reshape(-1), acc[:, SB:].reshape(-1)],
                       dim=1)[:window_len]


def flat_vals_fused_plain(st, window_len):
    """Twin of the flat_vals_fused kernel in plain PyTorch."""
    return _scatter_rows(st, st.rows.to(torch.int32), window_len)


def flat_vals_plain(st, window_len):
    """Twin of the flat_vals kernel in plain PyTorch."""
    return _scatter_rows(st, torch.cat([st.rows, st.cv], dim=1)
                         .to(torch.int32), window_len)


def flat_vals_add_plain(total, st, window_len):
    """Twin of the flat_vals_add kernel in plain PyTorch: total += the
    batch's pileup, in place (a tile with no chunk adds zeros)."""
    plain = flat_vals_fused_plain if st.form == "vals" else flat_vals_plain
    return total.add_(plain(st, window_len))


def _code_word_rows(st, cnt):
    """int32 (rows, 256) meth|cov values of the code-word forms: decode the
    planar words (site l = field l // 8 of word l % 8) and mask the counts
    `cnt` (one per row, (rows, 1), or one per lane, (rows, 128))."""
    lane = torch.arange(SB, dtype=torch.int32, device=st.device)
    codes = (st.rows[:, (lane % 8).long()] >> (2 * (lane // 8))) & 3
    meth = torch.where((codes == 1) | (codes == 2), cnt, 0)
    cov = torch.where(codes != CODE_DOT, cnt, 0)
    return torch.cat([meth, cov], dim=1)


def flat_classic_plain(st, window_len):
    """Twin of the flat_classic kernel in plain PyTorch: the row counts
    masked by the decoded codes, scattered by sub-block."""
    return _scatter_rows(st, _code_word_rows(st, st.meta[:, 0, :].reshape(
        -1, 1)), window_len)


def flat_lc_plain(st, window_len):
    """Twin of the flat_lc kernel in plain PyTorch: the count of lane l is
    the 8-bit field l // 32 of count word l % 32."""
    lane = torch.arange(SB, dtype=torch.int32, device=st.device)
    cnt = (st.cnts[:, (lane % 32).long()] >> (8 * (lane // 32))) & 255
    return _scatter_rows(st, _code_word_rows(st, cnt), window_len)


def tiled_classic_plain(st, window_len):
    """Twin of the tiled_classic kernel in plain PyTorch. The tiled grid
    piles up the same chunks (those of [c0[t], c1[t]) for tile t) as the
    flat one, so the twin is flat_classic_plain."""
    return flat_classic_plain(st, window_len)


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------


GRIDS = ("flat", "tiled")


def call_staged(staged, window_len, grid="flat"):
    """Run a Staged batch (or a list: the code-word forms' rc classes,
    whose disjoint chunk sets sum exactly) through its kernel -> int32
    (window_len, 2) [meth, cov] on the staged device.

    grid "flat" (one CTA per tile) serves every form; "tiled" (one CTA per
    staged chunk, the JAX package's WGBS_TPU_PILEUP_V3_GRID=tiled)
    has a kernel for the classic form only, and raises for the others as
    the JAX package does."""
    if grid not in GRIDS:
        raise ValueError(f"grid {grid!r}: one of {GRIDS}")
    if isinstance(staged, list):
        out = None
        for st in staged:
            res = call_staged(st, window_len, grid)
            out = res if out is None else out.add_(res)
        return out
    if grid == "tiled":
        if staged.form in ("vals", "vals_split"):
            raise ValueError("value-plane staging has no tiled-grid kernel; "
                             "stage with lane_counts=False for the tiled "
                             "grid")
        if staged.form == "lane":
            raise ValueError("lane-count staging has no tiled-grid kernel; "
                             "stage with lane_counts=False for the tiled "
                             "grid")
        return tiled_classic(staged, window_len)
    kernel = {"vals": flat_vals_fused, "vals_split": flat_vals,
              "lane": flat_lc, "classic": flat_classic}[staged.form]
    return kernel(staged, window_len)


def pileup_v3(start, length, count, codes, window_start, window_len, device,
              grid="flat", **staging):
    """Pileup over the 1-based window [window_start, window_start +
    window_len) -> int32 (window_len, 2) [meth, cov] on `device`: staging
    (stage_v3's keywords), upload, kernel. grid="tiled" stages the classic
    form (lane_counts=False), as the JAX package's pileup_pallas_v3 does."""
    if grid == "tiled":
        staging["lane_counts"] = False
    staged = stage_v3(start, length, count, codes, window_start, window_len,
                      **staging)
    return call_staged(staged_from_numpy(staged, device), window_len, grid)
