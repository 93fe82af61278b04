"""Fragment-level operations: region/blocks filtering (cview), strip/clip,
subsampling (pat_sampler), site masking (mask_pat), and homog's per-block
U/X/M read counting.

The port's copy of wgbs_tools_tpu/ops/frag_ops.py: the numpy host ops
`strip_frags` (:22), `has_gaps` (:49), `_pass_filters` (:55),
`overlap_pairs` (:72), `filter_by_blocks` (:94), `sample_frags` (:278)
and `mask_sites` (:297), and `homog_counts` (:125), whose `device` takes
the place of JAX's `backend`. The (read, block) overlap
pairs are found on the host; each pair's clip, call counts, gates, bin
and add run in `homog_bins`: CUDA tensors launch the kernel
(csrc/homog.cu: chunks of CHUNK pairs a warp, each counting into a
shared-memory window of (block, bin) cells flushed by one global atomic
a cell, a pair outside the window straight into out; each clip counted
by T and C-or-H bit flags over its row's aligned 8-byte words, the same
body for every row length and alignment), CPU tensors take
its twin `homog_bins_plain`. `homog_bins.launches` counts the kernel's
launches. `HomogBins` keeps the (B, nbins) int64 counts on the device
across a pat's slabs and fetches them once.

Semantics (ref: homog.cpp:154-196): H counts as C; a pair counts when the
clip's length (the whole read's with `inclusive`) and nrC + nrT are both
>= min_cpgs; its bin b has ranges[b] <= nrC / (nrC + nrT) < ranges[b+1]
(an IEEE float32 division, numpy's searchsorted side="right"), the last
bin right-inclusive.
"""

import numpy as np
import torch

from .. import _kernels
from ..device import resolve_device, timed
from ..formats.pat import CODE_C, CODE_DOT, CODE_H, CODE_T, PatFrags
from ..utils import IllegalArgumentError

TWIN_PAIRS = 1 << 22  # pairs per slice of the twin's (pairs, L) masks
# csrc/homog.cu's geometry: pairs a warp's chunk, (block, bin) cells of its
# window, edges kept in shared memory, the most bins whose bin is a linear
# count of the edges (a binary search above), the most informative calls
# whose bin is looked up in a table, the 8-byte words of a row loaded with
# its pair
CHUNK = 256
WINDOW_CELLS = 256
EDGES_MAX = 256
LINEAR_BINS = 8
TABLE_CALLS = 64
PREFETCH_WORDS = 4


def strip_frags(frags: PatFrags) -> PatFrags:
    """Remove leading/trailing unknown ('.') calls, dropping all-dot reads
    (ref: cview's --strip via patter_utils strip_read)."""
    if frags.nr_frags == 0:
        return frags
    L = frags.max_len
    cols = np.arange(L)[None, :]
    in_read = cols < frags.length[:, None]
    known = (frags.codes != CODE_DOT) & in_read
    any_known = known.any(axis=1)
    first = np.argmax(known, axis=1)
    last = L - 1 - np.argmax(known[:, ::-1], axis=1)

    out = frags.take(any_known)
    first = first[any_known]
    last = last[any_known]
    new_len = (last - first + 1).astype(np.int32)
    # shift codes left by `first` per row
    idx = np.clip(first[:, None] + np.arange(out.max_len)[None, :], 0, L - 1)
    codes = np.take_along_axis(out.codes, idx, axis=1)
    codes[np.arange(out.max_len)[None, :] >= new_len[:, None]] = CODE_DOT
    out.codes = codes
    out.start = (out.start + first).astype(np.int32)
    out.length = new_len
    return out


def has_gaps(frags: PatFrags) -> np.ndarray:
    cols = np.arange(frags.max_len)[None, :]
    in_read = cols < frags.length[:, None]
    return ((frags.codes == CODE_DOT) & in_read).any(axis=1)


def _pass_filters(frags: PatFrags, strip=False, min_cpgs=1, no_gaps=False):
    """cview's pass_read filter chain (ref: cview.cpp:8-17)."""
    if strip:
        frags = strip_frags(frags)
    keep = np.ones(frags.nr_frags, dtype=bool)
    if min_cpgs > 1:
        keep &= frags.length >= min_cpgs
    if no_gaps:
        keep &= ~has_gaps(frags)
    return frags.take(keep) if not keep.all() else frags



def overlap_pairs(frags: PatFrags, bstart, bend):
    """(frag_idx, block_idx) pairs for every fragment/block overlap.

    Blocks must be sorted by startCpG (ends may be non-monotonic; we use a
    running-max bound like the reference's deque scan, homog.cpp:246-258).
    """
    bstart = np.asarray(bstart, dtype=np.int64)
    bend = np.asarray(bend, dtype=np.int64)
    s = frags.start.astype(np.int64)
    e = s + frags.length
    be_max = np.maximum.accumulate(bend)
    lo = np.searchsorted(be_max, s, side="right")  # first block with end > start
    hi = np.searchsorted(bstart, e, side="left")  # blocks starting before read end
    counts = np.maximum(hi - lo, 0)
    fi = np.repeat(np.arange(frags.nr_frags), counts)
    offs = np.repeat(lo - np.concatenate([[0], np.cumsum(counts)[:-1]]), counts)
    bi = np.arange(fi.shape[0], dtype=np.int64) + offs
    # exact overlap check (running-max bound may over-include)
    ok = (bstart[bi] < e[fi]) & (bend[bi] > s[fi])
    return fi[ok], bi[ok]


def filter_by_blocks(frags: PatFrags, bstart, bend, strict=False, strip=False,
                     min_cpgs=1, no_gaps=False) -> PatFrags:
    """cview: keep reads overlapping blocks; --strict clips each read to each
    overlapping block (ref: cview.cpp:87-167)."""
    fi, bi = overlap_pairs(frags, bstart, bend)
    if not strict:
        keep = np.unique(fi)
        return _pass_filters(frags.take(keep), strip, min_cpgs, no_gaps)

    bstart = np.asarray(bstart, dtype=np.int64)
    bend = np.asarray(bend, dtype=np.int64)
    sub = frags.take(fi)
    os = np.maximum(sub.start.astype(np.int64), bstart[bi])
    oe = np.minimum(sub.start.astype(np.int64) + sub.length, bend[bi])
    shift = (os - sub.start).astype(np.int64)
    new_len = (oe - os).astype(np.int32)
    idx = np.clip(shift[:, None] + np.arange(sub.max_len)[None, :], 0,
                  max(sub.max_len - 1, 0))
    codes = np.take_along_axis(sub.codes, idx, axis=1)
    codes[np.arange(sub.max_len)[None, :] >= new_len[:, None]] = CODE_DOT
    sub.codes = codes
    sub.start = os.astype(np.int32)
    sub.length = new_len
    return _pass_filters(sub, strip, min_cpgs, no_gaps)



def _check_ranges(ranges):
    """ranges as float32, as JAX casts them; raises unless they start at
    0, end at 1 and increase."""
    ranges = np.asarray(ranges, dtype=np.float32)
    if ranges[0] != 0 or ranges[-1] != 1 or (np.diff(ranges) <= 0).any():
        raise IllegalArgumentError("Invalid range - must start with 0, end with 1")
    return ranges


def _check(out, codes, fstart, flen, fcount, bstart, bend, fi, bi, ranges):
    F, P = codes.shape[0], fi.shape[0]
    B, nbins = out.shape
    want = ((out, torch.int64, (B, nbins)),
            (fstart, torch.int32, (F,)), (flen, torch.int32, (F,)),
            (fcount, torch.int32, (F,)), (bstart, torch.int64, (B,)),
            (bend, torch.int64, (B,)), (fi, torch.int32, (P,)),
            (bi, torch.int32, (P,)),
            (ranges, torch.float32, (nbins + 1,)))
    if codes.dim() != 2 or codes.dtype != torch.uint8:
        raise ValueError(f"codes: got {codes.dtype} {tuple(codes.shape)}, "
                         "want torch.uint8 (F, L)")
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != tuple(shape):
            raise ValueError(f"got {t.dtype} {tuple(t.shape)}, want {dtype} "
                             f"{tuple(shape)}")
    for t in (codes,) + tuple(w[0] for w in want):
        if not t.is_contiguous() or t.device != out.device:
            raise ValueError(f"every tensor must be contiguous on "
                             f"{out.device} (one is on {t.device})")
    if nbins < 1:
        raise ValueError(f"nbins={nbins} must be >= 1")


def homog_bins(out, codes, fstart, flen, fcount, bstart, bend, fi, bi,
               ranges, min_cpgs, inclusive, stats=None):
    """out (B, nbins) int64 += the binned counts of the overlap pairs (fi,
    bi) of one slab (codes (F, L) uint8; fstart, flen, fcount int32 (F,);
    bstart, bend int64 (B,); fi, bi int32 (P,), in any order; ranges
    float32 (nbins + 1,), increasing from 0 to 1 as HomogBins checks
    them), in place. CUDA tensors launch the kernel; CPU tensors take
    homog_bins_plain. With `stats` (int64 (4,) on out's device, CUDA
    only) the kernel adds its [chunks, pairs added straight into out,
    passing pairs, global atomics] there. Returns out."""
    _check(out, codes, fstart, flen, fcount, bstart, bend, fi, bi, ranges)
    if out.device.type == "cpu":
        if stats is not None:
            raise ValueError("stats counts the kernel's work: CUDA only")
        return homog_bins_plain(out, codes, fstart, flen, fcount, bstart,
                                bend, fi, bi, ranges, min_cpgs, inclusive)
    if stats is not None and (stats.dtype != torch.int64
                              or tuple(stats.shape) != (4,)
                              or not stats.is_contiguous()
                              or stats.device != out.device):
        raise ValueError(f"stats: got {stats.dtype} {tuple(stats.shape)} "
                         f"on {stats.device}, want torch.int64 (4,) on "
                         f"{out.device}")
    P = fi.shape[0]
    if P == 0:
        return out
    ptrs = [codes.data_ptr(), fstart.data_ptr(), flen.data_ptr(),
            fcount.data_ptr(), bstart.data_ptr(), bend.data_ptr(),
            fi.data_ptr(), bi.data_ptr(), ranges.data_ptr(), out.data_ptr()]
    if stats is not None:
        ptrs.append(stats.data_ptr())
    _kernels.launch("homog_bins" if stats is None else "homog_bins_stats",
                    out.device, *ptrs, P, codes.shape[1], out.shape[1],
                    int(min_cpgs), int(bool(inclusive)))
    homog_bins.launches += 1
    return out


homog_bins.launches = 0


def homog_bins_plain(out, codes, fstart, flen, fcount, bstart, bend, fi, bi,
                     ranges, min_cpgs, inclusive):
    """Twin of the kernel in plain PyTorch (numpy's homog_counts after
    overlap_pairs), in slices of TWIN_PAIRS pairs: the clip, the call
    counts as float32, the gates, the float32 division, searchsorted and
    an index_add_ into out."""
    _check(out, codes, fstart, flen, fcount, bstart, bend, fi, bi, ranges)
    flat_out = out.view(-1)
    for lo in range(0, fi.shape[0], TWIN_PAIRS):
        f = fi[lo:lo + TWIN_PAIRS].to(torch.int64)
        cell = _cells(codes, fstart, flen, bstart, bend, f,
                      bi[lo:lo + TWIN_PAIRS].to(torch.int64), ranges,
                      out.shape[1], min_cpgs, inclusive)
        keep = cell >= 0
        flat_out.index_add_(0, cell[keep], fcount[f][keep].to(torch.int64))
    return out


def homog_cells_plain(codes, fstart, flen, bstart, bend, fi, bi, ranges,
                      min_cpgs, inclusive):
    """The twin's (block, bin) cell of each pair, b * nbins + bin, int64
    (P,), -1 where the pair does not count."""
    nbins = ranges.shape[0] - 1
    return torch.cat([_cells(codes, fstart, flen, bstart, bend,
                             fi[lo:lo + TWIN_PAIRS].to(torch.int64),
                             bi[lo:lo + TWIN_PAIRS].to(torch.int64), ranges,
                             nbins, min_cpgs, inclusive)
                      for lo in range(0, fi.shape[0], TWIN_PAIRS)]
                     or [torch.zeros(0, dtype=torch.int64,
                                     device=fi.device)])


def _cells(codes, fstart, flen, bstart, bend, f, b, ranges, nbins, min_cpgs,
           inclusive):
    """The cells of the pairs (f, b) (int64), -1 where a pair does not
    count."""
    s = fstart[f].to(torch.int64)
    ln = flen[f].to(torch.int64)
    if inclusive:
        off = torch.zeros_like(s)
        length = ln
    else:
        os_ = torch.maximum(s, bstart[b])
        length = torch.minimum(s + ln, bend[b]) - os_
        off = os_ - s
    c = codes[f]
    cols = torch.arange(codes.shape[1], device=codes.device)[None, :]
    in_clip = (cols >= off[:, None]) & (cols < (off + length)[:, None])
    nrC = (((c == CODE_C) | (c == CODE_H)) & in_clip).sum(dim=1).to(
        torch.float32)
    nrT = ((c == CODE_T) & in_clip).sum(dim=1).to(torch.float32)
    informative = nrC + nrT
    keep = ((length >= min_cpgs) & (informative >= min_cpgs)
            & (informative > 0))
    meth = nrC[keep] / informative[keep]
    bins = torch.clamp(torch.searchsorted(ranges, meth, right=True) - 1,
                       max=nbins - 1)
    cell = torch.full_like(b, -1)
    cell[keep] = b[keep] * nbins + bins
    return cell


class HomogBins:
    """homog's counts of one job on `device` ("cuda" raises without CUDA;
    "cpu" runs the twin): the blocks (sorted by start) and ranges go up
    once, each slab's fragments and overlap pairs per `add`, and `result`
    fetches the int64 (B, nbins) counts once. With `timings`, the seconds
    of overlap, h2d, kernel and fetch accumulate there."""

    def __init__(self, bstart, bend, ranges, min_cpgs=5, inclusive=False,
                 device="cuda", timings=None):
        self.device = dev = resolve_device(device)
        self.ranges = _check_ranges(ranges)
        self.bstart = np.asarray(bstart, dtype=np.int64)
        self.bend = np.asarray(bend, dtype=np.int64)
        self.min_cpgs = min_cpgs
        self.inclusive = inclusive
        self.timings = timings
        with timed(timings, "h2d", dev):
            self._blocks = [torch.from_numpy(a.copy()).to(dev) for a in
                            (self.bstart, self.bend, self.ranges)]
        self.out = torch.zeros((self.bstart.shape[0],
                                self.ranges.shape[0] - 1),
                               dtype=torch.int64, device=dev)

    def add(self, frags):
        if frags.nr_frags == 0 or self.bstart.shape[0] == 0:
            return
        with timed(self.timings, "overlap", None):
            fi, bi = overlap_pairs(frags, self.bstart, self.bend)
        if fi.shape[0] == 0:
            return
        dev = self.device
        with timed(self.timings, "h2d", dev):
            t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in (frags.codes, frags.start.astype(np.int32),
                           frags.length.astype(np.int32),
                           frags.count.astype(np.int32),
                           fi.astype(np.int32), bi.astype(np.int32))]
        codes, fstart, flen, fcount, fi_t, bi_t = t
        bstart, bend, ranges = self._blocks
        with timed(self.timings, "kernel", dev):
            homog_bins(self.out, codes, fstart, flen, fcount, bstart, bend,
                       fi_t, bi_t, ranges, self.min_cpgs, self.inclusive)

    def result(self):
        with timed(self.timings, "fetch", None):
            return self.out.cpu().numpy()


def homog_counts(frags: PatFrags, bstart, bend, ranges, min_cpgs=5,
                 inclusive=False, device="cuda"):
    """Per-block counts of reads binned by their methylation fraction.

    ranges: monotone float boundaries starting at 0 and ending at 1, e.g.
    [0, 0.34, 0.66, 1] -> 3 bins U/X/M. Blocks sorted by startCpG. Runs on
    `device` ("cuda": the kernel; "cpu": its twin). Returns int64
    (n_blocks, len(ranges)-1) on the host.
    """
    hb = HomogBins(bstart, bend, ranges, min_cpgs, inclusive, device)
    hb.add(frags)
    return hb.result()


def sample_frags(frags: PatFrags, rate, reps=1, seed=None) -> PatFrags:
    """count' ~ Binomial(count*reps, rate); drop zero-count rows
    (ref: src/pat_sampler/sampler.cpp:36-50 — which seeds per line from the
    wall clock; we use a counter-based generator for reproducibility)."""
    if not 0 < rate <= 1:
        raise IllegalArgumentError(f"Invalid sampling rate: {rate}")
    rng = np.random.default_rng(seed)
    new_counts = rng.binomial(frags.count.astype(np.int64) * reps, rate)
    keep = new_counts > 0
    out = frags.take(keep)
    out.count = new_counts[keep].astype(np.int32)
    return out


def mask_sites(frags: PatFrags, bstart, bend, strip=True) -> PatFrags:
    """Replace calls falling in [bstart, bend) blocks with '.', then strip
    (ref: src/pat2beta/mask_pat.cpp:12-150)."""
    if frags.nr_frags == 0:
        return frags
    bstart = np.asarray(bstart, dtype=np.int64)
    bend = np.asarray(bend, dtype=np.int64)
    sites = frags.start.astype(np.int64)[:, None] + np.arange(frags.max_len)[None, :]
    # site masked iff inside any block: use searchsorted over sorted blocks
    be_max = np.maximum.accumulate(bend)
    j = np.searchsorted(bstart, sites, side="right") - 1
    jc = np.clip(j, 0, len(bstart) - 1)
    masked = (j >= 0) & (sites < bend[jc]) & (sites >= bstart[jc])
    if len(bstart) > 1 and not (bstart[1:] >= bend[:-1]).all():
        # overlapping blocks: fall back to interval stabbing via running max
        masked = (j >= 0) & (sites < be_max[jc])
    codes = frags.codes.copy()
    codes[masked] = CODE_DOT
    out = PatFrags(frags.start.copy(), frags.length.copy(), frags.count.copy(),
                   codes, frags.chrom_id.copy(), frags.chrom_names,
                   frags.extras)
    return strip_frags(out) if strip else out
