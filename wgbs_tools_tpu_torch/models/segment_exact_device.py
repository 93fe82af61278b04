"""Exact segmentation on a torch device: the ll table on the host, the band
cost and the float64 ring DP in one kernel.

The port's copy of wgbs_tools_tpu/models/segment_exact_tpu.py, with the
same names. Exact mode's borders depend on a chain of float32 / float64
roundings (ref: src/segment_betas/segmentor.cpp:60-159): per-dataset
log-likelihoods rounded to float32, their sum over the datasets and the DP's
maximization in IEEE float64 with strict-'>' first-argmax ties.

  1. The per-dataset likelihood is a function of the integer pair
     (nmeth, ntotal) alone. The HOST builds a triangular float32 table of
     every ll(nm, nt) with the reference's rounding chain (numpy, libm's
     log2: build_ll_table), sized to the largest in-band total of the
     windows.
  2. The DEVICE reads band counts as int32 prefix-sum differences, looks
     their ll up in the table and does the float64 dataset sum and the DP
     in ops/segment_exact.py::segment_exact_dp: the hand-written kernel
     csrc/segment_exact.cu on CUDA, its plain twin on the CPU. The H100's
     float64 is IEEE, so where JAX needs software doubles (ops/softfloat.py)
     this is one hardware add, and the borders equal the host chain's
     (host/segment_exact.cpp) bit for bit.

Windows whose in-band totals pass the table cap (`WGBS_TPU_LL_CAP`, 8192
by default: a 134 MB table) or whose loci are not monotone below 2^31 are
not taken: their entry is None, and the caller runs them on the host, as in
JAX. `segment_exact_device_batch.host_windows` counts them.
"""

import os

import numpy as np
import torch

from ..device import resolve_device, timed
from ..ops.segment_exact import segment_exact_dp
from ..utils import logger

LL_CAP = int(os.environ.get("WGBS_TPU_LL_CAP", 8192))
BATCH = 512  # windows per kernel launch

_TABLE_CACHE = {}
_DEV_TABLE_CACHE = {}


def _device_table(pc, tbl, device):
    """The host table as a tensor on `device`, one resident at a time,
    keyed on (pc, size, device)."""
    key = (float(pc), tbl.shape[0], str(device))
    hit = _DEV_TABLE_CACHE.get(key)
    if hit is not None:
        return hit
    _DEV_TABLE_CACHE.clear()
    arr = torch.from_numpy(tbl).to(device)
    _DEV_TABLE_CACHE[key] = arr
    return arr


def build_ll_table(pc, cap):
    """Host-side float32 table of ll(nm, nt) for 0 <= nm <= nt < cap,
    triangular-flat at index nt*(nt+1)//2 + nm, with the reference's exact
    rounding chain (matches host/segment_exact.cpp)."""
    # the triangular-flat layout is cap-independent (entries for nt < cap'
    # sit at identical indices in any larger table), so a cached table for
    # the same pc and any cap' >= cap is reusable as-is
    for (c_pc, c_cap), tbl in _TABLE_CACHE.items():
        if c_pc == float(pc) and c_cap >= cap:
            return tbl
    nt = np.repeat(np.arange(cap, dtype=np.int64),
                   np.arange(1, cap + 1, dtype=np.int64))
    size = nt.shape[0]
    nm = np.arange(size, dtype=np.int64) - (nt * (nt + 1)) // 2
    pc32 = np.float32(pc)
    nm32 = nm.astype(np.float32)
    nt32 = nt.astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        p32 = (nm32 + pc32) / (nt32 + np.float32(2) * pc32)
        p64 = p32.astype(np.float64)
        t1 = np.where(p32 > 0, nm32.astype(np.float64) * np.log2(p64), 0.0)
        ll = (np.zeros(size, np.float32).astype(np.float64) + t1).astype(
            np.float32)
        t2 = np.where(p32 < 1,
                      (nt32 - nm32).astype(np.float64) * np.log2(1.0 - p64),
                      0.0)
        ll = (ll.astype(np.float64) + t2).astype(np.float32)
    ll = np.where(nt32 == 0, np.float32(0), ll)
    _TABLE_CACHE.clear()  # one table resident at a time (134 MB at the cap)
    _TABLE_CACHE[(float(pc), int(cap))] = ll
    return ll


def max_band_width(loci, W, max_bp):
    """Largest number of in-band candidate predecessors of any site: the
    DP's effective window. Every cell this clips has loci-distance > max_bp
    and was masked out of the full-width DP anyway."""
    if not max_bp:
        return int(W)
    loci = np.asarray(loci, dtype=np.int64)
    klo = np.searchsorted(loci, loci - max_bp, side="left")
    width = np.arange(loci.shape[0], dtype=np.int64) - klo + 1
    return int(min(max(int(width.max(initial=1)), 1), W))


def _round_width(bw):
    """Pad the band width to a multiple of 128, at least 128 (JAX's lane
    width; kept so that Wb, and the kernel's work, is JAX's)."""
    return max((bw + 127) // 128 * 128, 128)


def max_band_total(data, loci, W, max_bp):
    """Largest in-band (nm <= nt) total of any candidate block: the table
    size the kernel needs. Host-side, int64, monotone loci only."""
    pt = np.cumsum(np.asarray(data, dtype=np.int64)[:, :, 1], axis=1)
    pt = np.concatenate([np.zeros((pt.shape[0], 1), np.int64), pt], axis=1)
    n = loci.shape[0]
    if max_bp:
        hi = np.searchsorted(loci, loci + max_bp, side="right")
    else:
        hi = np.full(n, n, dtype=np.int64)
    hi = np.minimum(np.maximum(hi, np.arange(n) + 1), np.arange(n) + W)
    hi = np.minimum(hi, n)
    return int((pt[:, hi] - pt[:, :n]).max(initial=0))


def _narrow(datas):
    """The counts as shipped: their own dtype where torch adds it exactly
    (uint8 .beta, int8, int16, int32), uint16 (.lbeta) as int32, any other
    as int64. The prefix sums wrap mod 2^32 either way."""
    if datas.dtype in (np.uint8, np.int8, np.int16, np.int32):
        return datas
    if datas.dtype == np.uint16:
        return datas.astype(np.int32)
    return datas.astype(np.int64)


def _prefix_sums_wrapped(counts):
    """(B, K, n, 2) counts on the device -> meth / total prefix sums
    (B, K, n+1) int32, each wrapped mod 2^32: an int64 cumsum masked to
    32 bits, which equals JAX's int32 device cumsum that wraps and the
    host's int64-then-mask."""
    B, K, _, _ = counts.shape
    ps = torch.cat([torch.zeros((B, K, 1, 2), dtype=torch.int64,
                                device=counts.device),
                    torch.cumsum(counts, dim=2, dtype=torch.int64)], dim=2)
    ps = (((ps + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    return ps[..., 0].contiguous(), ps[..., 1].contiguous()


def plan_windows(datas, locis, W, max_bp, pseudo_count, cap_limit=None):
    """JAX's eligibility and sizes for B equal-size windows: (the eligible
    window indices, the host table, Wb), or (the empty list, None, None).
    A window is eligible where its loci are monotone and below 2^31 and
    its largest in-band total + 1 is within cap_limit (LL_CAP by default);
    the table's cap is the next power of two of the largest need (64 at
    least), and Wb = min(W, _round_width(the widest band))."""
    cap_limit = LL_CAP if cap_limit is None else cap_limit
    elig, need_max = [], 0
    for w in range(datas.shape[0]):
        loci = locis[w]
        if (np.diff(loci) < 0).any() or loci.max(initial=0) >= 1 << 31:
            continue
        need = max_band_total(datas[w], loci, W, max_bp) + 1
        if need > cap_limit:
            continue
        elig.append(w)
        need_max = max(need_max, need)
    if not elig:
        return elig, None, None
    cap = 1 << max(int(need_max - 1).bit_length(), 6)
    tbl = build_ll_table(pseudo_count, cap)
    Wb = min(W, _round_width(max(max_band_width(locis[w], W, max_bp)
                                 for w in elig)))
    return elig, tbl, Wb


def _upload(datas, locis, dev):
    """The windows' counts, narrow (_narrow), and their loci as int32, on
    `dev`: (counts, loci)."""
    counts = torch.from_numpy(np.ascontiguousarray(_narrow(datas))).to(dev)
    loci = torch.from_numpy(np.ascontiguousarray(locis,
                                                 dtype=np.int32)).to(dev)
    return counts, loci


def segment_exact_device_batch(datas, locis, W, max_bp, pseudo_count,
                               cap_limit=None, batch=BATCH, device="cuda",
                               timings=None):
    """Exact DP over equal-size windows on `device` (cuda: the kernel; cpu:
    its twin).

    datas: (B, K, n, 2) int counts; locis: (B, n). Returns a list of B
    traceback arrays T (n+1,) int64, T[0] = 0 and T[1:] = ks; the entry is
    None for a window the device path does not take (non-monotone loci, or
    totals past the table cap), which the caller runs on the host. Windows
    go `batch` at a time; the result does not depend on it. With `timings`
    (a dict), the seconds of the plan (eligibility and table), the upload,
    the DP (prefix sums and kernel) and the fetch are added to it, each
    device stage ending in a synchronize."""
    dev = resolve_device(device)
    datas = np.asarray(datas)
    locis = np.asarray(locis, dtype=np.int64)
    B, K, n, _ = datas.shape
    res = [None] * B
    if n < 2:
        return res
    max_bp = int(max_bp) if max_bp else 0
    with timed(timings, "plan", None):
        elig, tbl, Wb = plan_windows(datas, locis, W, max_bp, pseudo_count,
                                     cap_limit)
    if len(elig) < B:
        segment_exact_device_batch.host_windows += B - len(elig)
        logger.info(f"segment: {B - len(elig)} of {B} windows of {n:,} "
                    "sites are past the device table's cap or have "
                    "non-monotone loci; they run on the host")
    if not elig:
        return res
    with timed(timings, "h2d", dev):
        tbl_d = _device_table(pseudo_count, tbl, dev)
    outs = []
    for lo in range(0, len(elig), max(1, int(batch))):
        sel = elig[lo:lo + batch]
        with timed(timings, "h2d", dev):
            counts, loci = _upload(datas[sel], locis[sel], dev)
        with timed(timings, "dp", dev):
            pm, pt = _prefix_sums_wrapped(counts)
            del counts
            outs.append((sel, segment_exact_dp(pm, pt, loci, tbl_d, Wb,
                                               max_bp)))
            del pm, pt, loci
    with timed(timings, "ks_fetch", None):
        for sel, ks in outs:
            ks = ks.cpu().numpy()
            for j, w in enumerate(sel):
                T = np.empty(n + 1, dtype=np.int64)
                T[0] = 0
                T[1:] = ks[j]
                res[w] = T
    return res


segment_exact_device_batch.host_windows = 0


def segment_exact_device_T(data, loci, W, max_bp, pseudo_count,
                           cap_limit=None, device="cuda"):
    """Exact traceback of one window on `device`, or None where the window
    is ineligible (non-monotone loci, totals past the table cap): the
    caller then uses the host path. Returns T (n+1,) int64 identical to
    native.segment_exact_native's."""
    data = np.asarray(data)
    loci = np.asarray(loci, dtype=np.int64)
    return segment_exact_device_batch(data[None], loci[None], W, max_bp,
                                      pseudo_count, cap_limit,
                                      device=device)[0]
