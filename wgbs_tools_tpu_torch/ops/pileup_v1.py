"""Tiled pileup (v1): host prep, the CUDA kernel and its plain PyTorch twin.

Port of wgbs_tools_tpu/ops/pileup_tpu.py::pileup_pallas (the JAX
package's backend "pallas"). The host prep is the JAX function's, so the
arrays are identical: one fragment per row, in start order and not split,
rows padded to whole chunks of fc, and for each output tile the rows
[lo, hi) that can reach it (a searchsorted that looks back max_len - 1
sites):

- lo/hi int32 (num_tiles,): JAX's lo_adj (lo rounded down to its chunk,
  clamped so the TPU grid's index maps stay in range) and hi;
- meta int32 (n_chunks, 4, fc): start relative to the window (2^30 on
  padding rows), length, count, 0;
- words int32 (n_chunks*fc, max_len // 16): 2-bit planar codes, code j at
  field j // w16 of word j % w16, with max_len the codes' width rounded up
  to 128 and '.' past each fragment's codes.

Two departures, neither changing an array: the words are built with
uint32 operations from the codes as they are (JAX's planar_pack widens a
'.'-padded copy to int64, 8 bytes per code: ~5.8 GB for one 5.6M-fragment
slab at max_len 128), and the codes are taken directly rather than through
JAX's packed() -> unpack_codes round trip (pileup.py:288-293), which pads
with '.' too.

The kernel (csrc/pileup_v1.cu::tiles_v1_kernel: a thread per row for w16
8 and 16, a warp per row for any other w16) replaces
pileup_tpu.py::_pileup_kernel. A wrapper sends CUDA tensors to the kernel
and CPU tensors to the twin; any other device raises. `tiles_v1.launches`
counts its launches.
"""

from dataclasses import dataclass

import numpy as np
import torch

from .. import _kernels
from ..formats.pat import CODE_DOT
from .pileup_v2 import scatter_fragments, sorted_by_start

TILE = 1024       # sites per output tile
FRAG_CHUNK = 256  # fragment rows per chunk
SENTINEL = np.int32(2**30)


def _round_up(x, m):
    return (x + m - 1) // m * m


def planar_words(codes, max_len, n_rows):
    """uint8 (F, L) codes -> int32 (n_rows, max_len // 16) planar words,
    equal to pileup_tpu.planar_pack of the codes padded with '.' to
    (n_rows, max_len): code j of a row at bits 2 * (j // w16) of word
    j % w16. Built in uint32 from an all-'.' start (every bit set), one
    16th of the columns at a time."""
    F, L = codes.shape
    w16 = max_len // 16
    word = np.full((n_rows, w16), 0xFFFFFFFF, dtype=np.uint32)
    for j in range(16):
        cols = min(L - j * w16, w16)
        if cols <= 0:
            break
        part = word[:F, :cols]
        part &= np.uint32(~(3 << (2 * j)) & 0xFFFFFFFF)
        part |= codes[:, j * w16 : j * w16 + cols].astype(np.uint32) << (2 * j)
    return word.view(np.int32)


def stage_v1(start, length, count, codes, window_start, window_len,
             tile=TILE, fc=FRAG_CHUNK):
    """Host prep of one fragment batch over the 1-based window
    [window_start, window_start + window_len) -> (lo, hi, meta, words,
    max_chunks, max_len), the arrays pileup_pallas hands its kernel."""
    start, length, count, codes = sorted_by_start(start, length, count,
                                                  codes)
    start = np.asarray(start, dtype=np.int64)
    codes = np.asarray(codes)
    F, L = codes.shape
    max_len = max(_round_up(L, 128), 128)

    rel = (start - window_start).astype(np.int32)
    Fp = _round_up(max(F, 1), fc)
    n_chunks = Fp // fc
    meta = np.zeros((n_chunks, 4, fc), dtype=np.int32)
    starts_p = np.full(Fp, SENTINEL, dtype=np.int32)
    lens_p = np.zeros(Fp, dtype=np.int32)
    counts_p = np.zeros(Fp, dtype=np.int32)
    starts_p[:F] = rel
    lens_p[:F] = np.asarray(length, dtype=np.int32)
    counts_p[:F] = np.asarray(count, dtype=np.int32)
    meta[:, 0, :] = starts_p.reshape(n_chunks, fc)
    meta[:, 1, :] = lens_p.reshape(n_chunks, fc)
    meta[:, 2, :] = counts_p.reshape(n_chunks, fc)
    words = planar_words(codes, max_len, Fp)

    num_tiles = (window_len + tile - 1) // tile
    tile_bounds = np.arange(num_tiles, dtype=np.int64) * tile
    lo = np.searchsorted(rel, tile_bounds - max_len + 1, side="left")
    hi = np.searchsorted(rel, tile_bounds + tile, side="left")
    first_chunk = lo // fc
    chunks_per_tile = (hi + fc - 1) // fc - first_chunk
    max_chunks = max(int(chunks_per_tile.max(initial=1)), 1)
    # kept for identity with JAX: its grid's index maps stay in range
    first_chunk = np.minimum(first_chunk, max(n_chunks - max_chunks, 0))
    lo_adj = first_chunk * fc
    hi = np.minimum(hi, lo_adj + max_chunks * fc)
    return (lo_adj.astype(np.int32), hi.astype(np.int32), meta, words,
            max_chunks, max_len)


@dataclass(frozen=True)
class StagedV1:
    """One v1 staged batch as tensors on one device: lo/hi int32
    (num_tiles,), meta int32 (n_chunks, 4, fc), words int32 (n_chunks*fc,
    w16)."""

    lo: torch.Tensor
    hi: torch.Tensor
    meta: torch.Tensor
    words: torch.Tensor
    tile: int = TILE

    @property
    def device(self):
        return self.meta.device

    @property
    def fc(self):
        return self.meta.shape[2]

    @property
    def w16(self):
        return self.words.shape[1]


def staged_v1_from_numpy(staged, device, tile=TILE):
    """stage_v1's 6-field tuple -> StagedV1 on `device`. The row ranges are
    checked on the host, since the kernel indexes rows with them."""
    if len(staged) != 6:
        raise ValueError(f"a v1 staged tuple has 6 fields, not {len(staged)}")
    lo, hi, meta, words, _max_chunks, max_len = staged
    lo, hi = np.asarray(lo), np.asarray(hi)
    n_rows = np.asarray(meta).shape[0] * np.asarray(meta).shape[2]
    if ((lo < 0) | (hi > n_rows)).any():
        raise ValueError("staged row ranges lo/hi out of bounds")
    if np.asarray(words).shape[1] * 16 != max_len:
        raise ValueError(f"words of {np.asarray(words).shape[1]} columns do "
                         f"not hold max_len={max_len} codes")
    dev = torch.device(device)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return StagedV1(put(lo), put(hi), put(meta), put(words), int(tile))


def _check(st, window_len):
    """Validate a v1 staged batch; returns num_tiles."""
    if window_len < 1:
        raise ValueError(f"window_len={window_len} must be >= 1")
    if st.tile < 2 or st.tile % 2 or st.fc < 1 or st.w16 < 1:
        raise ValueError(f"tile={st.tile}, fc={st.fc}, w16={st.w16}: want an "
                         "even tile (the kernel writes sites in pairs), fc "
                         "and w16 >= 1")
    num_tiles = (window_len + st.tile - 1) // st.tile
    n_chunks = st.meta.shape[0]
    want = {"lo": (num_tiles,), "hi": (num_tiles,),
            "meta": (n_chunks, 4, st.fc),
            "words": (n_chunks * st.fc, st.w16)}
    for name, shape in want.items():
        x = getattr(st, name)
        if (tuple(x.shape) != shape or x.dtype != torch.int32
                or x.device != st.device or not x.is_contiguous()):
            raise ValueError(
                f"staged {name}: got {x.dtype} {tuple(x.shape)} on "
                f"{x.device} (contiguous={x.is_contiguous()}), want "
                f"torch.int32 {shape} on {st.device}, contiguous")
    return num_tiles


def tiles_v1(st, window_len):
    """Pileup of a v1 staged batch -> int32 (window_len, 2) [meth, cov].

    Replaces pileup_tpu.py::_pileup_kernel. CUDA tensors launch the
    kernel; CPU tensors take tiles_v1_plain."""
    num_tiles = _check(st, window_len)
    if st.device.type == "cpu":
        return tiles_v1_plain(st, window_len)
    # w16 8 and 16 take the thread-per-row form, which loads a row's words
    # as 16-B vectors
    if st.w16 in (8, 16) and st.words.data_ptr() % 16:
        raise ValueError("staged words must be 16-byte aligned for the "
                         "kernel's vector loads")
    out = torch.empty((window_len, 2), dtype=torch.int32, device=st.device)
    _kernels.launch("pileup_tiles_v1", st.device, st.lo.data_ptr(),
                    st.hi.data_ptr(), st.meta.data_ptr(), st.words.data_ptr(),
                    out.data_ptr(), num_tiles, window_len, st.tile, st.fc,
                    st.w16)
    tiles_v1.launches += 1
    return out


tiles_v1.launches = 0


def tiles_v1_plain(st, window_len):
    """Twin of the tiles_v1 kernel in plain PyTorch: row f adds its sites
    of tile t when lo[t] <= f < hi[t], the rows the kernel's CTA t walks."""
    num_tiles = (window_len + st.tile - 1) // st.tile

    def keep(rows, site):
        t = (site // st.tile).clamp(0, num_tiles - 1)
        return (rows >= st.lo[t]) & (rows < st.hi[t])

    return scatter_fragments(st.meta[:, 0, :].reshape(-1),
                             st.meta[:, 1, :].reshape(-1),
                             st.meta[:, 2, :].reshape(-1), st.words, keep,
                             window_len)


def pileup_v1(start, length, count, codes, window_start, window_len, device):
    """Pileup over the 1-based window [window_start, window_start +
    window_len) -> int32 (window_len, 2) [meth, cov] on `device`: host
    prep, upload, kernel. `codes` are the uint8 (F, L) codes, not the
    packed ones."""
    staged = stage_v1(start, length, count, codes, window_start, window_len)
    return tiles_v1(staged_v1_from_numpy(staged, device), window_len)
