"""Sub-block grouped pileup (v2): host staging, the CUDA kernel and its
plain PyTorch twin.

Port of wgbs_tools_tpu/ops/pileup_tpu2.py (the JAX package's backend
"pallas2"). The host staging is the JAX package's, line for line, so the
staged arrays are identical: fragments longer than 128 sites are split
and the batch is clipped to the window (pileup_v3._prep_window), then
chunked in start order, at most fc - 1 fragments, g_max sub-blocks and one
output tile per chunk. One fragment per row:

- c0/c1 int32 (num_tiles,): chunk range of each output tile;
- meta int32 (n_chunks, 3, fc): start relative to the window, length |
  dg << 16 (the sub-block offset from the chunk's base; dg = g_max on
  padding rows, whose start slot in row fc - 1 stashes the chunk's base),
  count;
- words int32 (n_chunks*fc, w_cols): 2-bit planar codes, code j at field
  j // w_cols of word j % w_cols, w_cols in {2, 4, 8} the narrowest power
  of two that holds the batch's code width.

The kernel (csrc/pileup_v2.cu::tiles_v2_kernel) replaces
pileup_tpu2.py::_kernel. A wrapper sends CUDA tensors to the kernel and
CPU tensors to the twin; any other device raises. `tiles_v2.launches`
counts its launches.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..formats.pat import CODE_DOT
from .pileup_v3 import SB, _prep_window, chunk_tiles

TILE = SB * 8     # sites per output tile
FRAG_CHUNK = 256  # fragment rows per chunk (row fc - 1 is always padding)
G_MAX = 8         # most distinct sub-blocks per chunk
# fragments per twin pass: bounds the (rows, width) temporaries
TWIN_ROWS = 1 << 20


def planar_pack_cols(codes, w_cols):
    """uint8 (F, L) codes -> int32 (F, w_cols) planar words: code s at
    word column s % w_cols, bits 2 * (s // w_cols). Columns past L unpack
    to code 0, which the kernel's length mask hides."""
    F, L = codes.shape
    if L > 16 * w_cols:
        raise ValueError(f"{L} code columns do not fit {w_cols} words")
    word = np.zeros((F, w_cols), dtype=np.uint32)
    for j in range((L + w_cols - 1) // w_cols):
        blk = codes[:, j * w_cols : (j + 1) * w_cols].astype(np.uint32)
        if blk.shape[1] < w_cols:
            blk = np.pad(blk, ((0, 0), (0, w_cols - blk.shape[1])))
        word |= blk << (2 * j)
    return word.view(np.int32)


def sorted_by_start(start, length, count, codes):
    """The batch in start order (a stable sort, only when it is not sorted
    already). The v1 and v2 staging cut chunks and tile ranges with
    searchsorted and assume it; pat files are sorted, so on the main path
    this is a check, and a sorted batch stages exactly as in JAX."""
    start = np.asarray(start)
    if start.size < 2 or (np.diff(start) >= 0).all():
        return start, length, count, codes
    order = np.argsort(start, kind="stable")
    return (start[order], np.asarray(length)[order],
            np.asarray(count)[order], np.asarray(codes)[order])


def stage_v2(start, length, count, codes, window_start, window_len,
             tile=TILE, fc=FRAG_CHUNK, g_max=G_MAX):
    """Host staging of one fragment batch over the 1-based window
    [window_start, window_start + window_len) -> the JAX package's
    (c0, c1, meta, words, max_chunks), array for array."""
    rel, length, count, codes = _prep_window(
        *sorted_by_start(start, length, count, codes), window_start,
        window_len)

    F = rel.shape[0]
    g = rel // SB
    tile_of = g // (tile // SB)

    breaks = [0]
    cstart = 0
    while cstart < F:
        lim1 = cstart + fc - 1
        lim2 = int(np.searchsorted(g, g[cstart] + g_max, side="left"))
        lim3 = int(np.searchsorted(tile_of, tile_of[cstart] + 1, side="left"))
        nxt = max(min(lim1, lim2, lim3, F), cstart + 1)
        breaks.append(nxt)
        cstart = nxt
    n_real = max(len(breaks) - 1, 1)
    # the chunk count bucketed to 3 significant bits, as in JAX (one
    # compiled shape per size octave there; kept for layout identity)
    gran = 1 << max(4, n_real.bit_length() - 3)
    n_chunks = (n_real + gran - 1) // gran * gran

    w_cols = 2
    while 16 * w_cols < min(codes.shape[1], SB):
        w_cols <<= 1
    meta = np.zeros((n_chunks, 3, fc), dtype=np.int32)
    meta[:, 1, :] = g_max << 16  # padding rows select no sub-block
    words = np.zeros((n_chunks * fc, w_cols), dtype=np.int32)
    bstarts = np.asarray(breaks[:-1], dtype=np.int64)
    bends = np.asarray(breaks[1:], dtype=np.int64)
    num_tiles = (window_len + tile - 1) // tile
    if F:
        lens_c = bends - bstarts
        ci_arr = np.repeat(np.arange(n_real), lens_c)
        pos_arr = np.arange(F) - np.repeat(bstarts, lens_c)
        base_g = g[bstarts]
        meta[ci_arr, 0, pos_arr] = rel
        meta[ci_arr, 1, pos_arr] = (
            length | ((g - base_g[ci_arr]).astype(np.int32) << 16))
        meta[ci_arr, 2, pos_arr] = count
        meta[:n_real, 0, fc - 1] = base_g  # row fc-1 is guaranteed padding
        words[ci_arr * fc + pos_arr] = planar_pack_cols(codes, w_cols)
        chunk_tile = tile_of[bstarts]
        c0 = np.searchsorted(chunk_tile, np.arange(num_tiles), side="left")
        c1 = np.searchsorted(chunk_tile, np.arange(num_tiles), side="right")
    else:
        c0 = np.zeros(num_tiles, dtype=np.int64)
        c1 = np.zeros(num_tiles, dtype=np.int64)
    max_chunks = max(int((c1 - c0).max(initial=1)), 1)
    max_chunks = 1 << (max_chunks - 1).bit_length()
    return (c0.astype(np.int32), c1.astype(np.int32), meta, words,
            max_chunks)


@dataclass(frozen=True)
class StagedV2:
    """One v2 staged batch as tensors on one device: c0/c1 int32
    (num_tiles,), meta int32 (n_chunks, 3, fc), words int32 (n_chunks*fc,
    w_cols); the geometry (tile, g_max) is not in the JAX tuple, so it is
    given here."""

    c0: torch.Tensor
    c1: torch.Tensor
    meta: torch.Tensor
    words: torch.Tensor
    tile: int = TILE
    g_max: int = G_MAX

    @property
    def device(self):
        return self.meta.device

    @property
    def fc(self):
        return self.meta.shape[2]

    @property
    def w_cols(self):
        return self.words.shape[1]


def staged_v2_from_numpy(staged, device, tile=TILE, g_max=G_MAX):
    """stage_v2's 5-field tuple (this module's or the JAX package's) ->
    StagedV2 on `device`. The chunk ranges are checked on the host, since
    the kernel indexes chunks with them."""
    if len(staged) != 5:
        raise ValueError(f"a v2 staged tuple has 5 fields, not {len(staged)}")
    c0, c1, meta, words, _max_chunks = staged
    c0, c1 = np.asarray(c0), np.asarray(c1)
    if ((c0 < 0) | (c0 > c1) | (c1 > np.asarray(meta).shape[0])).any():
        raise ValueError("staged chunk ranges c0/c1 out of bounds")
    if (c0[1:] != c1[:-1]).any():
        raise ValueError("staged chunk ranges c0/c1 are not contiguous")
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return StagedV2(put(c0), put(c1), put(meta), put(words), int(tile),
                    int(g_max))


def _check(st, window_len):
    """Validate a v2 staged batch; returns num_tiles."""
    if window_len < 1:
        raise ValueError(f"window_len={window_len} must be >= 1")
    if st.tile < SB or st.tile % SB:
        raise ValueError(f"tile={st.tile} must be a positive multiple of {SB}")
    if st.w_cols not in (2, 4, 8) or st.fc < 2 or st.g_max < 1:
        raise ValueError(f"w_cols={st.w_cols}, fc={st.fc}, g_max={st.g_max}: "
                         "want w_cols in (2, 4, 8), fc >= 2, g_max >= 1")
    num_tiles = (window_len + st.tile - 1) // st.tile
    n_chunks = st.meta.shape[0]
    want = {"c0": (num_tiles,), "c1": (num_tiles,),
            "meta": (n_chunks, 3, st.fc),
            "words": (n_chunks * st.fc, st.w_cols)}
    for name, shape in want.items():
        x = getattr(st, name)
        if (tuple(x.shape) != shape or x.dtype != torch.int32
                or x.device != st.device or not x.is_contiguous()):
            raise ValueError(
                f"staged {name}: got {x.dtype} {tuple(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()}), want "
                f"torch.int32 {shape} on {st.device}, contiguous")
    return num_tiles


def tiles_v2(st, window_len):
    """Pileup of a v2 staged batch -> int32 (window_len, 2) [meth, cov].

    Replaces pileup_tpu2.py::_kernel. CUDA tensors launch the kernel; CPU
    tensors take tiles_v2_plain."""
    num_tiles = _check(st, window_len)
    if st.device.type == "cpu":
        return tiles_v2_plain(st, window_len)
    align = min(4 * st.w_cols, 16)  # the kernel loads a row's words as vectors
    if st.words.data_ptr() % align:
        raise ValueError(f"staged words must be {align}-byte aligned for the "
                         "kernel's vector loads")
    out = torch.empty((window_len, 2), dtype=torch.int32, device=st.device)
    _kernels.launch("pileup_tiles_v2", st.device, st.c0.data_ptr(),
                    st.c1.data_ptr(), st.meta.data_ptr(), st.words.data_ptr(),
                    out.data_ptr(), num_tiles, window_len, st.tile, st.fc,
                    st.g_max, st.w_cols)
    tiles_v2.launches += 1
    return out


tiles_v2.launches = 0


def scatter_fragments(rel, lens, counts, words, keep_site, window_len):
    """int32 (window_len, 2) [meth, cov] of fragment rows in plain PyTorch:
    row i adds counts[i] at sites rel[i] + j, j < lens[i], with code j of
    its planar words (field j // w of word j % w) deciding meth (C or H)
    and cov (not '.'); `keep_site(rows, sites)` masks (row, site) pairs
    further. The rows go in passes of TWIN_ROWS, each as a (rows, width)
    site grid of the longest fragment of the pass."""
    dev = words.device
    w = words.shape[1]
    out = torch.zeros((window_len + 1, 2), dtype=torch.int32, device=dev)
    for lo in range(0, rel.shape[0], TWIN_ROWS):
        sl = slice(lo, lo + TWIN_ROWS)
        ln = lens[sl].clamp(max=16 * w)
        width = int(ln.max()) if ln.numel() else 0
        if width <= 0:
            continue
        j = torch.arange(width, dtype=torch.int64, device=dev)
        codes = (words[sl][:, (j % w)] >> (2 * (j // w)).to(torch.int32)) & 3
        site = rel[sl].to(torch.int64)[:, None] + j
        rows = torch.arange(lo, lo + ln.shape[0], dtype=torch.int64,
                            device=dev)[:, None]
        ok = ((j < ln[:, None]) & (codes != CODE_DOT) & (site >= 0)
              & (site < window_len) & keep_site(rows, site))
        cnt = counts[sl][:, None]
        vals = torch.stack([torch.where(ok & (codes != 0), cnt, 0),
                            torch.where(ok, cnt, 0)], dim=2)
        out.index_add_(0, torch.where(ok, site, window_len).reshape(-1),
                       vals.reshape(-1, 2))
    return out[:window_len]


def tiles_v2_plain(st, window_len):
    """Twin of the tiles_v2 kernel in plain PyTorch: every real row (dg in
    [0, g_max)) of a chunk in tile t's range adds its sites of tiles t and
    t + 1, the tiles the kernel's CTAs t and t + 1 read it for."""
    row_tile = chunk_tiles(st.c0, st.c1, st.meta.shape[0]).repeat_interleave(
        st.fc)
    lw = st.meta[:, 1, :].reshape(-1)
    dg = lw >> 16
    real = (row_tile >= 0) & (dg >= 0) & (dg < st.g_max)
    lens_r = torch.where(real, lw & 0xFFFF, 0)

    def keep(rows, site):
        d = site // st.tile - row_tile[rows]
        return (d == 0) | (d == 1)

    return scatter_fragments(st.meta[:, 0, :].reshape(-1), lens_r,
                             st.meta[:, 2, :].reshape(-1), st.words, keep,
                             window_len)


def pileup_v2(start, length, count, codes, window_start, window_len, device):
    """Pileup over the 1-based window [window_start, window_start +
    window_len) -> int32 (window_len, 2) [meth, cov] on `device`: staging,
    upload, kernel."""
    staged = stage_v2(start, length, count, codes, window_start, window_len)
    return tiles_v2(staged_v2_from_numpy(staged, device), window_len)
