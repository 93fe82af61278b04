"""Adjacent-CpG pair counts (tt/tc/ct/cc): the `.pairs` format.

Port of wgbs_tools_tpu/ops/pairs.py (ref: src/pat2beta/stdin2pairs.cpp:
59-97). Counts are indexed at the second site of each pair: for each
fragment and position p >= 1 whose calls p - 1 and p are both T or C (H
is not counted), table[start + p - window start][2 (pre == C) + (cur ==
C)] += count, inside the window only. `StreamingPairs` folds pat slabs
into a device-resident int32 (n, 4) table (451 MB at hg19) and fetches
it once; `pair_counts` is one slab on a zeroed table. The fold is
`pair_counts_add`: CUDA tensors launch the kernel (csrc/pairs.cu: a CTA
owns a tile of TILE sites in shared memory, finds the fragments that
reach it by a search on the sorted starts, and adds the tile into the
table once), CPU tensors take its twin `pair_counts_add_plain` (an
index_add_ of the masked flat ids). The kernel takes fragments sorted by
start: a batch that is not (`is_sorted` False, or found so on the device
when it is None) is sorted first, stably, on the device.
`pair_counts_add.launches` counts the kernel's launches. Pairs are
intra-read, so the slabs' contributions add: streaming is bit-identical
to one pass. JAX pads each slab to a bucket of shapes to limit
recompiles; nothing here compiles per shape, so the slabs go up as they
are.
"""

import numpy as np
import torch

from .. import _kernels
from ..device import resolve_device, timed
from ..formats.pat import CODE_C, CODE_T

TWIN_FRAGS = 1 << 20  # fragments per slice of the twin's masks
# csrc/pairs.cu's geometry (its TILE and ROW_MAX), for the tests' model of
# its order of work
TILE = 2048     # sites a CTA owns at a time
ROW_MAX = 32    # the longest row (min(length, L) calls) one thread walks


def _check(table, start_rel, length, count, codes):
    if (table.dim() != 2 or table.shape[1] != 4
            or table.dtype != torch.int32 or not table.is_contiguous()):
        raise ValueError(f"table: got {table.dtype} {tuple(table.shape)}, "
                         "want a contiguous torch.int32 (n, 4)")
    if (codes.dim() != 2 or codes.dtype != torch.uint8
            or not codes.is_contiguous()):
        raise ValueError(f"codes: got {codes.dtype} {tuple(codes.shape)}, "
                         "want a contiguous torch.uint8 (F, L)")
    F = codes.shape[0]
    for name, t in (("start_rel", start_rel), ("length", length),
                    ("count", count)):
        if (t.dtype != torch.int32 or t.shape != (F,)
                or not t.is_contiguous()):
            raise ValueError(f"{name}: got {t.dtype} {tuple(t.shape)}, "
                             f"want a contiguous torch.int32 ({F},)")
    for t in (start_rel, length, count, codes):
        if t.device != table.device:
            raise ValueError(f"a tensor on {t.device}, the table on "
                             f"{table.device}")


def pair_counts_add(table, start_rel, length, count, codes, is_sorted=None):
    """table (n, 4) int32 += the pair counts of one batch of fragments
    (start_rel: first site minus the window's first; length, count; codes
    (F, L) uint8), in place. CUDA tensors launch the kernel; CPU tensors
    take pair_counts_add_plain. The kernel takes start_rel in ascending
    order: `is_sorted` True vouches for that (a pat slab is sorted by
    start), None checks it on the device (a synchronizing read), and a
    batch that is not sorted goes to the kernel as a copy sorted by a
    stable device sort. Returns table."""
    _check(table, start_rel, length, count, codes)
    if table.device.type == "cpu":
        return pair_counts_add_plain(table, start_rel, length, count, codes)
    F, L = codes.shape
    if F == 0 or L < 2 or table.shape[0] == 0:
        return table
    _kernels.require_cuda("pair_counts", table.device)
    if table.data_ptr() % 16:
        raise ValueError("table: each site's 4 counts are added as one "
                         "16-byte vector; the table must be 16-byte aligned")
    if is_sorted is None:
        is_sorted = bool((start_rel[1:] >= start_rel[:-1]).all())
    if not is_sorted:
        order = torch.sort(start_rel, stable=True).indices
        start_rel, length, count, codes = (
            t.index_select(0, order) for t in (start_rel, length, count,
                                               codes))
    _kernels.launch("pair_counts", table.device, start_rel.data_ptr(),
                    length.data_ptr(), count.data_ptr(), codes.data_ptr(),
                    table.data_ptr(), F, L, table.shape[0])
    pair_counts_add.launches += 1
    return table


pair_counts_add.launches = 0


def pair_counts_add_plain(table, start_rel, length, count, codes):
    """Twin of the kernel in plain PyTorch (JAX's _pairs_accum): the
    masked flat ids site * 4 + pair, index_add_ of the counts, in slices
    of TWIN_FRAGS fragments."""
    _check(table, start_rel, length, count, codes)
    n = table.shape[0]
    F, L = codes.shape
    flat_table = table.view(-1)
    pos = torch.arange(1, L, dtype=torch.int64, device=table.device)[None, :]
    for lo in range(0, F, TWIN_FRAGS):
        c = codes[lo:lo + TWIN_FRAGS].to(torch.int64)
        site = start_rel[lo:lo + TWIN_FRAGS, None].to(torch.int64) + pos
        pre, cur = c[:, :-1], c[:, 1:]
        valid = ((pos < length[lo:lo + TWIN_FRAGS, None]) & (site >= 0)
                 & (site < n) & ((pre == CODE_T) | (pre == CODE_C))
                 & ((cur == CODE_T) | (cur == CODE_C)))
        flat = site * 4 + (pre == CODE_C).to(torch.int64) * 2 + (
            cur == CODE_C)
        vals = count[lo:lo + TWIN_FRAGS, None].expand(flat.shape)
        flat_table.index_add_(0, flat[valid], vals[valid])
    return table


class StreamingPairs:
    """Bounded-memory whole-genome pair counting: fold PatFrags batches
    into a (window_len, 4) int32 table on `device` ("cuda" raises without
    CUDA; "cpu" runs the twin), fetch once at the end. With `timings`, the
    seconds of h2d, kernel and fetch accumulate there."""

    def __init__(self, window, device="cuda", timings=None):
        self.window = window
        self.device = resolve_device(device)
        self.timings = timings
        n = window[1] - window[0]
        self.acc = torch.zeros((n, 4), dtype=torch.int32, device=self.device)

    def add(self, frags):
        s, e = self.window
        sel = frags.slice_sites(s, e) if frags.nr_frags else frags
        if sel.nr_frags == 0:
            return
        dev = self.device
        with timed(self.timings, "h2d", dev):
            cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in ((sel.start.astype(np.int64) - s).astype(
                        np.int32), sel.length.astype(np.int32),
                        sel.count.astype(np.int32), sel.codes)]
        with timed(self.timings, "kernel", dev):
            # slice_sites already takes the slab to be sorted by start
            pair_counts_add(self.acc, *cols, is_sorted=True)

    def result(self):
        with timed(self.timings, "fetch", None):
            return self.acc.cpu().numpy()


def pair_counts(frags, window, device="cuda"):
    """(window_len, 4) int32 [tt, tc, ct, cc] over 1-based [s, e)."""
    sp = StreamingPairs(window, device)
    sp.add(frags)
    return sp.result()
