"""Whole-genome pileup over site shards, one device per shard.

Port of wgbs_tools_tpu/parallel/sharded.py::ShardedPileupV3 (:380-501).
The site axis of the window splits into contiguous shards of
S = ceil(n / n_shards) sites; shard i holds an int32 (S, 2) total on its
own device. Each streamed batch is clipped to every shard's sites on the
host (PatFrags.slice_sites: the fragments overlapping the shard; staging
drops the sites outside it), so the shards are independent: no halo and no
cross-device traffic. Counts are integer adds in another grouping, so the
result equals the single-device pileup exactly.
"""

import numpy as np
import torch

from ..device import timed
from ..ops.pileup import fetch_chunked, saturate_device_counts
from ..ops.pileup_v3 import (call_staged, flat_vals_add, stage_v3,
                             staged_from_numpy)


class ShardedPileupV3:
    """Streaming pileup of PatFrags batches into per-shard device totals.

    `devices` (parallel/mesh.py::shard_devices) lists one device per shard;
    a device may hold several shards. A value-plane batch piles up and adds
    into its shard's total in one launch (flat_vals_add, in place, where
    the JAX package donates the total to pileup_vals_add); a classic batch
    (a count >= 256) runs flat_classic per rc class and is added with add_.
    fused=False stages value planes split (the flat_vals_add kernel's split
    form). With `timings` (a dict) each stage's seconds accumulate there
    (see device.timed)."""

    def __init__(self, devices, window, fused=True, timings=None):
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("ShardedPileupV3 needs at least one device")
        self.window = window
        self.n = window[1] - window[0]
        self.S = -(-self.n // len(self.devices))
        self.fused = fused
        self.timings = timings
        self.totals = [torch.zeros((self.S, 2), dtype=torch.int32,
                                   device=d) for d in self.devices]

    def add(self, frags):
        if frags.nr_frags == 0:
            return
        base = self.window[0]
        for i, dev in enumerate(self.devices):
            lo = base + i * self.S
            hi = min(lo + self.S, self.window[1])
            if hi <= lo:
                continue
            sel = frags.slice_sites(lo, hi, min_overlap=1)
            if sel.nr_frags == 0:
                continue
            with timed(self.timings, "stage", None):
                staged = stage_v3(sel.start, sel.length, sel.count,
                                  sel.codes, lo, self.S, fused=self.fused)
            with timed(self.timings, "h2d", dev):
                staged = staged_from_numpy(staged, dev)
            with timed(self.timings, "kernel", dev):
                if isinstance(staged, list):
                    self.totals[i].add_(call_staged(staged, self.S))
                else:
                    flat_vals_add(self.totals[i], staged, self.S)

    def result(self):
        """Raw count table, int64 numpy (n, 2)."""
        return np.concatenate([fetch_chunked(t) for t in self.totals]
                              ).astype(np.int64)[: self.n]

    def coverage(self):
        """Sum of the coverage column, exact in int64."""
        return sum(int(t[:, 1].sum(dtype=torch.int64)) for t in self.totals)

    def finalize(self, lbeta=False):
        """Saturated uint8/uint16 (n, 2) beta array. Each shard saturates on
        its own device; saturation is per site, so concatenating the shards'
        results on the host is exact."""
        with timed(self.timings, "saturate_fetch", None):
            return np.concatenate([saturate_device_counts(t, lbeta)
                                   for t in self.totals])[: self.n]

