"""The yardstick of the roofline metrics: the card's peaks, and the work a
kernel's job must do, counted from the benchmark's own inputs and never
from the program's staged forms, so that a change of staging or of kernel
leaves the count as it is.
"""

import numpy as np
import torch

# NVIDIA H100 SXM (the data sheet; dense, no sparsity, at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12  # FP64 outside the tensor cores
# 32-bit integer adds: the whitepaper's 64 INT32 lanes per SM, 132 SMs at
# the 1,980 MHz boost clock
INT32_OPS = 132 * 64 * 1.98e9


def bound_s(n_bytes, ops, ops_per_s):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the compute peak."""
    return max(n_bytes / HBM_BYTES_PER_S, ops / ops_per_s)


def pileup_work(frags):
    """(bytes, ops) of a pileup of the pat lines `frags` (gen.Frags): each
    line's start, length and count (int32) and each site's code byte read
    once, the (sites, 2) int32 table of the sites the lines span written
    once, and two integer adds (meth, cov) a called site."""
    sites = int(frags.length.sum())
    called = int((frags.codes != 3).sum())
    span = int((frags.start + frags.length).max() - frags.start.min())
    n_bytes = 12 * frags.n + sites + 8 * span
    return n_bytes, 2 * called


def band_cells(loci, chrom_offsets, windows, max_cpg, max_bp, device="cpu"):
    """Valid band cells of the exact DP over the 1-based windows [s, e): a
    (k, i) pair counts where i - k < min(max_cpg, n) and locus(i) -
    locus(k) <= max_bp within a window of n sites."""
    dev = torch.device(device)
    off = np.asarray(chrom_offsets, np.int64)
    chrom = np.repeat(np.arange(len(off) - 1), np.diff(off)).astype(np.int64)
    key = torch.from_numpy((chrom << 40) + np.asarray(loci, np.int64)).to(dev)
    total = 0
    for s, e in windows:
        n = e - s
        if n <= 1:
            continue
        k = key[s - 1:e - 1]
        first = torch.searchsorted(k, k - max_bp)
        i = torch.arange(n, device=dev)
        kmin = torch.maximum(first, i - min(max_cpg, n) + 1).clamp(min=0)
        total += int((i - kmin + 1).sum())
    return total


def exact_dp_work(cells, n_sites, K):
    """(bytes, flops) of the exact DP: cells x K float64 adds; each site's
    K (meth, cov) uint8 pairs and its int32 locus read once, its int32
    traceback written once."""
    return n_sites * (2 * K + 8), cells * K
