"""Pileup: pat fragments -> per-CpG (meth, cov) counts on a torch device.

Port of wgbs_tools_tpu/ops/pileup.py (single device). The reference
streams pat text through a C++ accumulator one line at a time
(ref: src/pat2beta/stdin2beta.cpp:59-93): cov[site] += count for calls in
{C,T,H}, meth[site] += count for {C,H}. Counts are int32 on the device and
int64 on the host; nothing passes through a floating-point type.

Backends of PileupAccumulator and pileup_frags:
- "cuda": v3 staging + the hand-written kernels (ops/pileup_v3.py). The
  main path; on a CUDA device it launches the kernels, on the CPU their
  plain twins run.
- "cuda_v2": v2 staging + its kernel (ops/pileup_v2.py), the same way.
- "cuda_v1": v1 host prep + its kernel (ops/pileup_v1.py), the same way.
- "torch": `pileup_torch`, an index_add_ scatter; CPU only, so that no
  plain path runs on the card in place of the kernels.
- "native": the host C++ kernel (native.pileup_native, the port's copy
  of the JAX package's) into an int64 host total; CPU only (the
  accumulator's alone). With `finalize` it is the host oracle:
  pileup_native followed by trim_to_uint.

The JAX package picks its pileup with environment switches; the port
takes keywords, one for each (the v3 form keywords apply to the "cuda"
backend only):

| JAX switch                       | port keyword                        |
|----------------------------------|-------------------------------------|
| WGBS_TPU_V3_VALS=0               | vals=False                          |
| WGBS_TPU_V3_LANE_COUNTS=0        | lane_counts=False                   |
| WGBS_TPU_V3_FUSED_PLANE=0        | fused=False                         |
| WGBS_TPU_PILEUP_V3_GRID=tiled    | grid="tiled" (implies               |
|                                  | lane_counts=False, as               |
|                                  | pileup_tpu3.py:1095 does)           |
| backend "pallas2"                | backend="cuda_v2"                   |
| backend "pallas"                 | backend="cuda_v1"                   |
"""

import os

import numpy as np
import torch

from ..device import resolve_device, timed
from ..formats.beta import trim_to_uint
from ..formats.pat import CODE_C, CODE_DOT, CODE_H, PatFrags
from ..native import pileup_native
from .pileup_v1 import stage_v1, staged_v1_from_numpy, tiles_v1
from .pileup_v2 import stage_v2, staged_v2_from_numpy, tiles_v2
from .pileup_v3 import GRIDS, call_staged, stage_v3, staged_from_numpy

DEFAULT_BATCH = 1 << 20
KERNEL_BACKENDS = ("cuda", "cuda_v2", "cuda_v1")
BACKENDS = KERNEL_BACKENDS + ("torch", "native")


def _check_backend(backend, device, forms, backends=BACKENDS):
    """Raise on an unknown backend, a host backend on a CUDA device, or v3
    form keywords (`forms`: fused, vals, lane_counts, grid) away from their
    defaults with a backend other than "cuda"."""
    if backend not in backends:
        raise ValueError(f"backend {backend!r}: one of {backends}")
    if backend not in KERNEL_BACKENDS and torch.device(device).type != "cpu":
        raise ValueError(f"the {backend!r} backend runs on the host only: "
                         "use device='cpu' (on the card the 'cuda' "
                         "backend's kernels run)")
    fused, vals, lane_counts, grid = forms
    if grid not in GRIDS:
        raise ValueError(f"grid {grid!r}: one of {GRIDS}")
    if backend != "cuda" and not (fused and vals and lane_counts
                                  and grid == "flat"):
        raise ValueError("the v3 form keywords (fused, vals, lane_counts, "
                         f"grid) apply to the 'cuda' backend, not "
                         f"{backend!r}")


def _stagers(backend, fused=True, vals=True, lane_counts=True, grid="flat"):
    """(stage, upload, kernel) of a kernel backend: stage(start, length,
    count, codes, window_start, window_len) -> numpy staged batch,
    upload(staged, device) -> tensors, kernel(tensors, window_len) ->
    int32 (window_len, 2) on the device."""
    if backend == "cuda_v2":
        return stage_v2, staged_v2_from_numpy, tiles_v2
    if backend == "cuda_v1":
        return stage_v1, staged_v1_from_numpy, tiles_v1
    lane_counts = lane_counts and grid == "flat"

    def stage(*frags):
        return stage_v3(*frags, fused=fused, vals=vals,
                        lane_counts=lane_counts)

    def kernel(staged, window_len):
        return call_staged(staged, window_len, grid)

    return stage, staged_from_numpy, kernel


def pileup_torch(start, length, count, codes, window_start, window_len,
                 device, batch=DEFAULT_BATCH):
    """Scatter-add pileup over the 1-based window [window_start,
    window_start + window_len) -> int32 (window_len, 2) [meth, cov] on
    `device`. Twin of _pileup_batch_xla: sites outside the window go to a
    dropped row n. `batch` bounds the fragments per scatter."""
    dev = torch.device(device)
    start = np.asarray(start)
    length, count, codes = (np.asarray(length), np.asarray(count),
                            np.asarray(codes))
    out = torch.zeros((window_len + 1, 2), dtype=torch.int32, device=dev)
    pos = torch.arange(codes.shape[1], dtype=torch.int64, device=dev)
    for lo in range(0, start.shape[0], batch):
        sl = slice(lo, lo + batch)
        rel = torch.from_numpy(start[sl].astype(np.int64) - window_start).to(dev)
        ln = torch.from_numpy(length[sl].astype(np.int64)).to(dev)
        cnt = torch.from_numpy(count[sl].astype(np.int32)).to(dev)[:, None]
        cd = torch.from_numpy(np.ascontiguousarray(codes[sl])).to(dev)
        site = rel[:, None] + pos
        in_window = (site >= 0) & (site < window_len)
        observed = (pos < ln[:, None]) & in_window & (cd != CODE_DOT)
        meth_call = (cd == CODE_C) | (cd == CODE_H)
        vals = torch.stack([torch.where(observed & meth_call, cnt, 0),
                            torch.where(observed, cnt, 0)], dim=2)
        idx = torch.where(in_window, site, window_len)
        out.index_add_(0, idx.reshape(-1), vals.reshape(-1, 2))
    return out[:window_len]


def overlap_span(frags: PatFrags, window):
    """The fragments of a batch that overlap the 1-based window [s, e), and
    the site span [lo, hi) they cover within it: (sel, lo, hi), or None
    when no fragment overlaps. pat files are sorted by startCpG, so a
    streamed batch covers one contiguous span of the site axis."""
    s, e = window
    sel = frags.slice_sites(s, e, min_overlap=1) if frags.nr_frags \
        else frags
    if sel.nr_frags == 0:
        return None
    lo = max(int(sel.start.min()), s)
    hi = min(int((sel.start.astype(np.int64) + sel.length).max()), e)
    return sel, lo, hi


class PileupAccumulator:
    """Streaming single-device pileup: fold PatFrags batches into a
    (window_len, 2) count table.

    pat files are sorted by startCpG, so each batch covers a contiguous
    span of the site axis; it piles up over that span only and is added
    in place into the device-resident int32 total. With `timings` (a dict)
    each stage's seconds accumulate there, the device synchronized after
    each (see device.timed). The v3 form keywords of the "cuda" backend
    (see the module's table) pick the staged form and kernel grid: fused,
    vals, lane_counts (stage_v3's) and grid ("flat" or "tiled"); every
    choice gives the same counts."""

    def __init__(self, window, device, backend="cuda", timings=None,
                 fused=True, vals=True, lane_counts=True, grid="flat"):
        _check_backend(backend, device, (fused, vals, lane_counts, grid))
        self.window = window
        self.n = window[1] - window[0]
        self.device = resolve_device(device)
        self.backend = backend
        self.timings = timings
        if backend in KERNEL_BACKENDS:
            self._stage, self._upload, self._kernel = _stagers(
                backend, fused, vals, lane_counts, grid)
        if backend == "native":
            self.total = np.zeros((self.n, 2), dtype=np.int64)
        else:
            self.total = torch.zeros((self.n, 2), dtype=torch.int32,
                                     device=self.device)

    def _timed(self, stage):
        return timed(self.timings, stage, self.device)

    def add(self, frags: PatFrags):
        hit = overlap_span(frags, self.window)
        if hit is None:
            return
        sel, lo, hi = hit
        s = self.window[0]
        if self.backend == "native":
            st = np.asarray(sel.start)
            thr = (min(os.cpu_count() or 1, 8)
                   if st.size < 2 or np.all(np.diff(st) >= 0) else 1)
            with self._timed("kernel"):
                pileup_native(st, sel.length, sel.count, sel.codes, s,
                              self.n, out=self.total, threads=thr)
            return
        span = hi - lo
        if self.backend == "torch":
            with self._timed("kernel"):
                res = pileup_torch(sel.start, sel.length, sel.count,
                                   sel.codes, lo, span, self.device)
        else:
            with self._timed("stage"):
                staged = self._stage(sel.start, sel.length, sel.count,
                                     sel.codes, lo, span)
            with self._timed("h2d"):
                staged = self._upload(staged, self.device)
            with self._timed("kernel"):
                res = self._kernel(staged, span)
        with self._timed("kernel"):
            # in place, where the JAX package donates the total to _fold_at
            self.total[lo - s : lo - s + span].add_(res)

    def result(self):
        """Raw count table, int64 numpy."""
        if self.backend == "native":
            return self.total
        return fetch_chunked(self.total).astype(np.int64)

    def finalize(self, lbeta=False):
        """Saturated uint8/uint16 (n, 2) beta array, exact reference
        semantics (ref: utils_wgbs.py:277-290)."""
        if self.backend == "native":
            return trim_to_uint(self.total, lbeta)
        with self._timed("saturate_fetch"):
            return saturate_device_counts(self.total, lbeta)


def _saturate_compact(total, max_val, cap, out_dtype):
    """Device saturation + compaction of coverage-overflow rows.

    Rows with cov <= max_val are exact as they are; rows with cov >
    max_val are zeroed in the output and their (site, meth, cov) triples
    (the first `cap` of them) gathered for exact re-saturation on the host.
    Returns (out, n_big, triples)."""
    meth, cov = total[:, 0], total[:, 1]
    big = cov > max_val
    out = torch.stack([meth.masked_fill(big, 0), cov.clamp(max=max_val)],
                      dim=1).to(out_dtype)
    sites = torch.nonzero(big).squeeze(1)
    n_big = int(sites.shape[0])
    sites = sites[:cap]
    triples = torch.stack([sites.to(torch.int32), meth[sites], cov[sites]],
                          dim=1)
    return out, n_big, triples


def saturate_device_counts(total, lbeta=False, cap=1 << 20,
                           fetch_bytes=8 << 20):
    """Device int32 (n, 2) counts -> host saturated uint8/uint16 beta,
    byte-identical to trim_to_uint(counts) with bounded d2h traffic: the
    narrow table crosses back, plus the coverage-overflow rows, which are
    re-saturated on the host with the reference's float64 chain."""
    max_val = 65535 if lbeta else 255
    dt = torch.uint16 if lbeta else torch.uint8
    out, n_big, triples = _saturate_compact(total, max_val, cap, dt)
    if n_big > cap:
        # more overflow rows than the compaction buffer: an exact host pass
        # over the full counts
        return trim_to_uint(fetch_chunked(total).astype(np.int64), lbeta)
    beta = fetch_chunked(out, max_bytes=fetch_bytes)
    if n_big:
        rows = triples.cpu().numpy()
        beta[rows[:, 0]] = trim_to_uint(rows[:, 1:3].astype(np.int64), lbeta)
    return beta


def pileup_frags(frags: PatFrags, window, backend="cuda", device="cuda",
                 batch=DEFAULT_BATCH, fused=True, vals=True, lane_counts=True,
                 grid="flat"):
    """Pileup of a PatFrags batch over the 1-based site window [s, e) ->
    int32 (e - s, 2) [meth, cov] on `device`.

    Port of wgbs_tools_tpu/ops/pileup.py::pileup_frags, dispatching the
    same way: the fragments overlapping the window, then the backend's
    staging and kernel ("cuda" = v3, "cuda_v2", "cuda_v1"; the v3 form
    keywords as in the module's table), or "torch", the scatter twin, on
    the CPU only, with `batch` fragments per scatter."""
    _check_backend(backend, device, (fused, vals, lane_counts, grid),
                   backends=KERNEL_BACKENDS + ("torch",))
    dev = resolve_device(device)
    s, e = window
    n = e - s
    sel = frags.slice_sites(s, e, min_overlap=1) if frags.nr_frags else frags
    if backend == "torch":
        return pileup_torch(sel.start, sel.length, sel.count, sel.codes, s,
                            n, dev, batch=batch)
    stage, upload, kernel = _stagers(backend, fused, vals, lane_counts, grid)
    return kernel(upload(stage(sel.start, sel.length, sel.count, sel.codes,
                               s, n), dev), n)


def fetch_chunked(x, max_bytes=8 << 20):
    """Device -> host copy in row slabs of at most `max_bytes`, into one
    preallocated numpy array (host memory is not doubled by a full-size
    staging copy)."""
    x_np = np.empty(tuple(x.shape), dtype=torch.empty(0, dtype=x.dtype)
                    .numpy().dtype)
    host = torch.from_numpy(x_np)
    row_bytes = max(x.element_size() * int(np.prod(x.shape[1:], initial=1)),
                    1)
    step = max(int(max_bytes) // row_bytes, 1)
    for lo in range(0, x.shape[0], step):
        host[lo : lo + step].copy_(x[lo : lo + step])
    return x_np
