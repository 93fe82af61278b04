"""Whole-genome pipelines over site shards and a (samples, sites) mesh.

Port of wgbs_tools_tpu/parallel/sharded.py, with its names. JAX runs these
as shard_map programs whose collectives move data between devices; here
each shard's work is dispatched to its device and the collectives are
explicit tensor moves (mesh.py: devices may repeat, so a multi-card mesh
stands in on one card or on the CPU):

- ShardedPileupV3 (:380-501), pat2beta's sharded path: fragments clipped
  to each shard's sites on the host, the v3 kernels per shard, no halo.
- the fused analysis step (AnalysisStep, JAX's build_analysis_step
  :125-185): pileup of bucketed fragments (_local_pileup, the tiles_v1
  kernel on the card) with the halo `ppermute` as a copy of each shard's
  tail into the next shard's head, the multi-sample segmentation cost
  (_segment_cost_local) summed over sample shards on the site shard's
  device (the `psum`), the serial DP (JAX's _dp_scan, here
  ops/dp_scan.py::dp_scan, one chain per site shard) and the
  overflow-safe coverage total (_psum64 / decode_sum64);
- the halo-exchange ShardedPileup (build_pileup_accum_step, :281-373),
  the analysis step's pileup as a streaming accumulator;
- window-sharded fast segmentation (segment_windows_sharded, :211-278):
  the chunk windows split over every device of the mesh.

Counts are integer adds, so every pileup equals the single-device pileup
exactly; the cost is f32 PyTorch (its log2 may differ from XLA's by an
ulp), and the DPs' adds and maxima are exact.
"""

import numpy as np
import torch

from ..device import resolve_device, timed
from ..formats.pat import CODE_C, CODE_DOT, CODE_H
from ..models.segment import (_borders_mask, _cost_fast, _dp_fast_blocked,
                              _hankel, _int32, _prefix_sums, _safe_log2,
                              _warm_cpu_log2, pack_mask_bits,
                              unpack_mask_bits)
from ..ops.dp_scan import dp_scan
from ..ops.pileup import fetch_chunked, saturate_device_counts
from ..ops.pileup_v1 import pileup_v1
from ..ops.pileup_v3 import (call_staged, flat_vals_add, stage_v3,
                             staged_from_numpy)

NEG = float("-inf")
COST_CHUNK = 1 << 24  # (rows x W) cost cells built at a time


def _local_pileup_plain(rel_start, length, count, codes, out_len):
    """Twin of _local_pileup in plain PyTorch, JAX's _local_pileup (:44-60)
    as written: int32 (out_len, 2) [meth, cov] of fragment rows with
    0-based starts relative to the window, an index_add_ over every (row,
    position) pair with position < length, site in [0, out_len) and code
    not '.'; meth where the code is C or H. Tensors on one device."""
    dev = codes.device
    L = codes.shape[1]
    pos = torch.arange(L, dtype=torch.int64, device=dev)[None, :]
    site = rel_start.to(torch.int64)[:, None] + pos
    observed = ((pos < length.to(torch.int64)[:, None]) & (site >= 0)
                & (site < out_len) & (codes != CODE_DOT))
    meth_call = (codes == CODE_C) | (codes == CODE_H)
    cnt = count.to(torch.int32)[:, None].expand(-1, L)
    meth = torch.zeros(out_len, dtype=torch.int32, device=dev)
    cov = torch.zeros(out_len, dtype=torch.int32, device=dev)
    m = observed & meth_call
    meth.index_add_(0, site[m], cnt[m])
    cov.index_add_(0, site[observed], cnt[observed])
    return torch.stack([meth, cov], dim=1)


def _local_pileup(rel_start, length, count, codes, out_len, device="cuda"):
    """Dense (out_len, 2) int32 pileup of one fragment shard (0-based starts
    relative to the shard, host arrays) on `device`.

    On CUDA it is the port's v1 pileup (ops/pileup_v1.py::pileup_v1, the
    tiles_v1 kernel) over the window [0, out_len): bucket_fragments' rows
    are v1's unsplit fragment rows, its padding rows (length 0 or count 0,
    which add nothing) are dropped before staging, and sites at or past
    out_len (or below 0) are dropped as JAX's mode="drop" drops them. On
    the CPU it is _local_pileup_plain."""
    dev = resolve_device(device)
    arrays = [np.asarray(a) for a in (rel_start, length, count, codes)]
    if dev.type == "cpu":
        return _local_pileup_plain(*(torch.from_numpy(
            np.ascontiguousarray(a)) for a in arrays), out_len)
    rs, ln, cn, cd = arrays
    keep = (ln > 0) & (cn != 0)
    if not keep.any():
        return torch.zeros((out_len, 2), dtype=torch.int32, device=dev)
    return pileup_v1(rs[keep], ln[keep], cn[keep], cd[keep], 0, out_len, dev)


def _segment_cost_local(counts, loci, W, max_bp, pc, out=None):
    """(S, W) float32 cost rows (ascending-k order) from one sample's local
    counts, JAX's _segment_cost_local (:63-102), on counts' device.

    counts: (S, 2) int32 tensor; loci: (S,) int tensor. Window sums are
    differences of int64 prefix sums (JAX's int32 cumsum wraps; the two
    agree wherever a window sum fits in int32); window values pad with 0
    (the sums) and with loci[0] (the loci), as in JAX. The cost is -inf
    where k < 0 and where the window spans more than max_bp. The rows are
    built COST_CHUNK cells at a time; with `out` (S, W) f32 they are added
    into it in place (out += cost, the same f32 adds as JAX's cost +=) and
    out is returned."""
    dev = counts.device
    S = counts.shape[0]
    # window_vals: W - 1 fill values in front, then Hankel rows. The prefix
    # sums ps[0] = 0, ps[i+1] = counts[0..i] sit at pad[W-1 + i]; each
    # column is scanned on its own (a contiguous 1-D cumsum: along dim 0 of
    # the (S, 2) counts CUDA scans each column in a few threads)
    zeros = torch.zeros(W, dtype=torch.int64, device=dev)
    padm, padt = (torch.cat([zeros, counts[:, c].to(torch.int64).cumsum(0)])
                  for c in (0, 1))
    loci = loci.to(torch.int64)
    padl = torch.cat([loci[:1].expand(W - 1), loci])
    pcf = torch.tensor(pc, dtype=torch.float32, device=dev)
    pc2 = 2 * pcf
    if dev.type == "cpu":
        _warm_cpu_log2()
    if out is None:
        out = torch.empty((S, W), dtype=torch.float32, device=dev)
        add = False
    else:
        add = True
    j_col = torch.arange(W, device=dev)[None, :]
    rows = max(1, COST_CHUNK // W)
    for r0 in range(0, S, rows):
        r1 = min(S, r0 + rows)
        m = r1 - r0
        nm = (padm[W + r0:W + r1, None]
              - _hankel(padm[r0:r1 + W - 1], m, W)).to(torch.float32)
        nt = (padt[W + r0:W + r1, None]
              - _hankel(padt[r0:r1 + W - 1], m, W)).to(torch.float32)
        p = (nm + pcf) / (nt + pc2)
        # _safe_log2 is JAX's _log2s: log2(x) where x > 0, else 0
        ll = nm * _safe_log2(p) + (nt - nm) * _safe_log2(1.0 - p)
        ll.masked_fill_(nt == 0, 0.0)
        del nm, nt, p
        if max_bp:
            dist = loci[r0:r1, None] - _hankel(padl[r0:r1 + W - 1], m, W)
            ll.masked_fill_(dist > max_bp, NEG)
            del dist
        i_row = torch.arange(r0, r1, device=dev)[:, None]
        ll.masked_fill_(i_row - (W - 1) + j_col < 0, NEG)
        if add:
            out[r0:r1].add_(ll)
        else:
            out[r0:r1] = ll
        del ll
    return out


def _psum64(xs):
    """Overflow-safe total of the int32 tensors `xs` (one per site shard):
    (lo, f) with lo the exact int64 total wrapped to int32 and f that total
    as float32, numpy scalars. JAX's _psum64 (:188-201) gives the same lo
    (int32 adds wrap) and an f32 tree sum for f; decode_sum64 recovers the
    exact total from either while it is below ~2^44."""
    total = sum(int(x.sum(dtype=torch.int64)) for x in xs)
    lo = np.int32(((total + (1 << 31)) % (1 << 32)) - (1 << 31))
    return lo, np.float32(total)


def decode_sum64(lo, f):
    """Host-side exact reconstruction of a _psum64 pair -> python int."""
    lo_u = int(np.uint32(np.int32(np.asarray(lo))))
    hi = int(np.round((float(np.asarray(f)) - lo_u) / 4294967296.0))
    return hi * 4294967296 + lo_u


def _split_rows(arrays, n_shards):
    """Bucketed fragment arrays (n_shards * Fp rows) -> per-shard slices."""
    arrays = [np.asarray(a) for a in arrays]
    F = arrays[0].shape[0]
    if F % n_shards or any(a.shape[0] != F for a in arrays):
        raise ValueError(f"{F} fragment rows do not split into {n_shards} "
                         "equal shards (use bucket_fragments)")
    Fp = F // n_shards
    return [[a[j * Fp:(j + 1) * Fp] for a in arrays] for j in range(n_shards)]


def _halo_pileup(mesh, shards, S, halo):
    """Per site shard j: the (S, 2) int32 pileup of its fragment rows on
    mesh.device(0, j), with the `halo` rows past S added into shard j+1's
    first rows (JAX's ppermute; shard 0 receives zeros, and the last shard's
    tail is dropped: no wrap)."""
    locs = [_local_pileup(*shards[j], S + halo, mesh.device(0, j))
            for j in range(mesh.shape["sites"])]
    for j in range(1, len(locs)):
        locs[j][:halo] += locs[j - 1][S:].to(locs[j].device)
    return [loc[:S] for loc in locs]


class AnalysisStep:
    """The fused sharded step: fragments -> counts -> per-window
    segmentation (JAX's build_analysis_step, a callable with the same
    arguments and the same 4-tuple out).

    AnalysisStep(mesh, n_sites, halo, W, max_bp, pc)(rel_start, length,
    count, codes, sample_counts, loci):
      rel_start/length/count (F,) int32, codes (F, L) uint8: fragments from
        bucket_fragments (shard j's rows [j*F/b, (j+1)*F/b), 0-based starts
        relative to the shard), host arrays;
      sample_counts (K, n_sites, 2) int32 (numpy or a tensor), K a multiple
        of the samples axis: sample shard s holds samples [s*K/a,
        (s+1)*K/a);
      loci (n_sites,) or (n_sites, 1) int32.
    Returns (counts (n_sites, 2) int32, tb (n_sites,) int32, cov_lo, cov_f)
    with counts and tb on mesh.device(0, 0); decode_sum64(cov_lo, cov_f) is
    the exact total coverage.

    Each site shard j (S = n_sites / b sites) piles up its rows on its
    device mesh.device(0, j) (_local_pileup over S + halo sites) and adds
    its tail into shard j+1's head. Its cost is each sample shard's partial
    (zeros, then + the cost of each local sample in turn, JAX's order),
    built on mesh.device(s, j), then summed into sample shard 0's on the site
    shard's device in sample-shard order (the psum: the JAX step's meshes
    have at most 2 sample shards, and a sum of two f32 terms does not depend
    on their order). tb is each window's own DP (window == shard, the
    window-relative predecessor of every site, JAX's semantics): the costs of
    the site shards on one device are built into one (chains, S, W) tensor
    and go to dp_scan in one launch. With `timings` (a dict) the seconds of
    the pileup, cost, psum and dp stages are added to it (device.timed)."""

    def __init__(self, mesh, n_sites, halo, W, max_bp=0, pc=15.0,
                 timings=None):
        self.mesh = mesh
        self.n_shards = mesh.shape["sites"]
        self.S = n_sites // self.n_shards
        if self.S * self.n_shards != n_sites:
            raise ValueError(f"n_sites={n_sites} must be a multiple of the "
                             f"{self.n_shards} site shards")
        if not 0 <= halo <= self.S:
            raise ValueError(f"halo={halo} must be in [0, {self.S}] (a site "
                             "shard)")
        self.n_sites, self.halo, self.W = n_sites, halo, W
        self.max_bp, self.pc = max_bp, pc
        self.timings = timings

    def __call__(self, rel_start, length, count, codes, sample_counts, loci):
        mesh, S, W, nsh = self.mesh, self.S, self.W, self.n_shards
        a = mesh.shape["samples"]
        sample_counts = torch.as_tensor(sample_counts)
        K = sample_counts.shape[0]
        if K % a or tuple(sample_counts.shape[1:]) != (self.n_sites, 2):
            raise ValueError(f"sample_counts {tuple(sample_counts.shape)}: "
                             f"want (K, {self.n_sites}, 2), K a multiple of "
                             f"{a}")
        loci = torch.as_tensor(loci)
        if loci.dim() == 2 and loci.shape[1] == 1:
            loci = loci[:, 0]
        if tuple(loci.shape) != (self.n_sites,):
            raise ValueError(f"loci {tuple(loci.shape)}: want "
                             f"({self.n_sites},) or ({self.n_sites}, 1)")
        shards = _split_rows((rel_start, length, count, codes), nsh)
        with timed(self.timings, "pileup", mesh.device(0, nsh - 1)):
            counts = _halo_pileup(mesh, shards, S, self.halo)
        tb = [None] * nsh
        groups = {}
        for j in range(nsh):
            groups.setdefault(mesh.device(0, j), []).append(j)
        for dev, js in groups.items():
            cost = torch.empty((len(js), S, W), dtype=torch.float32,
                               device=dev)
            for g, j in enumerate(js):
                self._cost(cost[g], j, sample_counts, loci)
            with timed(self.timings, "dp", dev):
                ks = dp_scan(cost, W)
            del cost
            for g, j in enumerate(js):
                tb[j] = ks[g]
        with timed(self.timings, "psum", None):
            cov_lo, cov_f = _psum64([c[:, 1] for c in counts])
        out = mesh.device(0, 0)
        return (torch.cat([c.to(out) for c in counts]),
                torch.cat([t.to(out) for t in tb]), cov_lo, cov_f)

    def _cost(self, dst, j, sample_counts, loci):
        """Site shard j's summed cost into dst (S, W) on its device."""
        mesh, S, W = self.mesh, self.S, self.W
        a = mesh.shape["samples"]
        k_local = sample_counts.shape[0] // a
        rows = slice(j * S, (j + 1) * S)
        for s in range(a):
            dev = mesh.device(s, j)
            with timed(self.timings, "cost", dev):
                part = dst if s == 0 else torch.empty((S, W),
                                                      dtype=torch.float32,
                                                      device=dev)
                part.zero_()
                lo = loci[rows].to(dev)
                for d in range(s * k_local, (s + 1) * k_local):
                    _segment_cost_local(sample_counts[d, rows].to(dev), lo,
                                        W, self.max_bp, self.pc, out=part)
            if s:
                with timed(self.timings, "psum", dst.device):
                    dst.add_(part.to(dst.device))
                del part


def build_segment_windows_step(mesh, W, max_bp=0, pc=15.0, B=128):
    """Data-parallel batched fast segmentation over the mesh's devices.

    Returns step(pm, pt, loci): pm/pt int32 (nw, K, n+1) and loci int32
    (nw, n) host arrays, nw a multiple of the mesh's device count; the
    window axis is split over every device of the mesh (flattened), and
    device d segments its windows with the fast path's own functions:
    _cost_fast -> _dp_fast_blocked (the maxplus_closure kernel on CUDA) ->
    _borders_mask -> pack_mask_bits. Returns the per-device packed masks,
    left on their devices (the caller fetches them)."""
    devs = mesh.devices

    def step(pm, pt, loci):
        nw = pm.shape[0]
        if nw % len(devs):
            raise ValueError(f"{nw} windows do not split over "
                             f"{len(devs)} devices (pad on the host)")
        per = nw // len(devs)
        outs = []
        for d, dev in enumerate(devs):
            sl = slice(d * per, (d + 1) * per)
            Crev = _cost_fast(_int32(pm[sl], dev), _int32(pt[sl], dev),
                              _int32(loci[sl], dev), W, max_bp, pc)
            outs.append(pack_mask_bits(_borders_mask(_dp_fast_blocked(
                Crev, W, B))))
            del Crev
        return outs

    return step


def segment_windows_sharded(mesh, datas, locis, max_cpg=1000, max_bp=2000,
                            pseudo_count=15.0, per_device_batch=2,
                            timings=None):
    """Host wrapper: run the window-sharded step in fixed-size launches of
    (n_devices * per_device_batch) windows (tail padded with window 0), all
    queued before the masks are fetched; returns per-window relative border
    arrays, equal to segment_windows_fast's window for window. With
    `timings` (a dict) the seconds of the queued launches (dp) and of the
    mask fetch are added to it."""
    datas = np.asarray(datas)
    locis = np.asarray(locis)
    nw, K, n, _ = datas.shape
    ndev = mesh.size
    W = int(min(max_cpg, n))
    launch = ndev * max(1, per_device_batch)
    pms, pts = [], []
    for w in range(nw):
        pm, pt = _prefix_sums(datas[w])
        pms.append(pm)
        pts.append(pt)
    step = build_segment_windows_step(
        mesh, W, int(max_bp) if max_bp else 0, float(pseudo_count))
    outs = []
    with timed(timings, "dp", None):
        for lo in range(0, nw, launch):
            sel = list(range(lo, min(lo + launch, nw)))
            sel = sel + [sel[0]] * (launch - len(sel))
            outs.append(step(np.stack([pms[w] for w in sel]),
                             np.stack([pts[w] for w in sel]), locis[sel]))
    with timed(timings, "mask_fetch", None):
        masks = [unpack_mask_bits(np.concatenate(
            [o.cpu().numpy() for o in out]), n + 1) for out in outs]
    res = []
    for li, lo in enumerate(range(0, nw, launch)):
        for j in range(min(launch, nw - lo)):
            res.append(np.flatnonzero(masks[li][j]).astype(np.int64))
    return res


def build_pileup_accum_step(mesh, n_sites_pad, halo):
    """Sharded pileup accumulation step (JAX's :281-308).

    Returns step(totals, rel_start, length, count, codes): totals is a list
    of int32 (S, 2) tensors, site shard j's on mesh.device(0, j); the
    fragment arrays are as bucket_fragments makes them. Each shard piles up
    its rows over S + halo sites; boundary-crossing fragments land in the
    next shard's first `halo` rows (the ppermute hop). Adds the batch into
    totals in place and returns them. Integer adds: the result equals the
    single-device pileup in any shard order."""
    n_shards = mesh.shape["sites"]
    S = n_sites_pad // n_shards

    def step(totals, rel_start, length, count, codes):
        shards = _split_rows((rel_start, length, count, codes), n_shards)
        for total, part in zip(totals, _halo_pileup(mesh, shards, S, halo)):
            total += part
        return totals

    return step


class ShardedPileup:
    """Streaming whole-genome pileup over the `sites` axis of a mesh, the
    halo-exchange form (JAX's ShardedPileup, :311-372).

    add() buckets each PatFrags batch to site shards on the host and folds
    it into per-shard device totals (build_pileup_accum_step); result()
    fetches once. pat2beta's sharded path is ShardedPileupV3; this form is
    the analysis step's pileup as an accumulator."""

    def __init__(self, mesh, window, halo=512, fp_mult=1 << 14):
        self.mesh = mesh
        self.window = window
        self.n = window[1] - window[0]
        self.n_shards = mesh.shape["sites"]
        self.n_pad = (self.n + self.n_shards - 1) // self.n_shards \
            * self.n_shards
        self.halo = max(16, min(halo, self.n_pad // self.n_shards))
        self.fp_mult = fp_mult
        self._step = None
        S = self.n_pad // self.n_shards
        self.totals = [torch.zeros((S, 2), dtype=torch.int32,
                                   device=mesh.device(0, j))
                       for j in range(self.n_shards)]

    def add(self, frags):
        if frags.nr_frags == 0:
            return
        if int(frags.length.max(initial=0)) > self.halo:
            # halo must cover the longest fragment; grow in pow2 buckets
            h = self.halo
            while h < int(frags.length.max()):
                h <<= 1
            if h > self.n_pad // self.n_shards:
                raise ValueError(
                    f"fragment length {int(frags.length.max())} exceeds a "
                    f"site shard ({self.n_pad // self.n_shards} sites)")
            self.halo = h
            self._step = None
        if self._step is None:
            self._step = build_pileup_accum_step(self.mesh, self.n_pad,
                                                 self.halo)
        L32 = (frags.codes.shape[1] + 31) // 32 * 32  # bucket the codes
        rs, ln, cn, cd = bucket_fragments(                # width too
            frags.start, frags.length, frags.count, frags.codes,
            self.n_pad, self.n_shards, max_len=L32, base=self.window[0],
            fp_mult=self.fp_mult)
        self.totals = self._step(self.totals, rs, ln, cn, cd)

    def result(self):
        """Raw count table, int64 numpy (n, 2)."""
        return np.concatenate([fetch_chunked(t) for t in self.totals]
                              ).astype(np.int64)[: self.n]

    def finalize(self, lbeta=False):
        """Saturated uint8/uint16 (n, 2) beta array; each shard saturates on
        its own device (saturation is per site)."""
        return np.concatenate([saturate_device_counts(t, lbeta)
                               for t in self.totals])[: self.n]


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


def bucket_fragments(start, length, count, codes, n_sites, n_shards,
                     max_len=None, base=1, fp_mult=1):
    """Host-side: assign fragments to site shards, pad to equal counts, and
    make starts shard-relative. Returns arrays shaped (n_shards*Fp, ...).

    base: 1-based site index of the first site of shard 0 (window start).
    fp_mult: round the per-shard fragment capacity up to a multiple (keeps
    the jitted step's shapes in a small bucket set across streaming chunks).
    """
    start = np.asarray(start, dtype=np.int64) - (base - 1)
    S = n_sites // n_shards
    shard_of = np.clip((start - 1) // S, 0, n_shards - 1)
    order = np.argsort(shard_of, kind="stable")
    start, shard_of = start[order], shard_of[order]
    length = np.asarray(length, dtype=np.int32)[order]
    count = np.asarray(count, dtype=np.int32)[order]
    codes = np.asarray(codes)[order]
    per = np.bincount(shard_of, minlength=n_shards)
    Fp = max(int(per.max(initial=1)), 1)
    Fp = (Fp + fp_mult - 1) // fp_mult * fp_mult
    L = codes.shape[1] if max_len is None else max_len
    out_start = np.zeros((n_shards, Fp), dtype=np.int32)
    out_len = np.zeros((n_shards, Fp), dtype=np.int32)
    out_cnt = np.zeros((n_shards, Fp), dtype=np.int32)
    out_codes = np.full((n_shards, Fp, L), CODE_DOT, dtype=np.uint8)
    pos = 0
    for sh in range(n_shards):
        k = int(per[sh])
        sl = slice(pos, pos + k)
        out_start[sh, :k] = start[sl] - 1 - sh * S  # shard-relative, 0-based
        out_len[sh, :k] = length[sl]
        out_cnt[sh, :k] = count[sl]
        out_codes[sh, :k, : codes.shape[1]] = codes[sl]
        pos += k
    return (
        out_start.reshape(-1),
        out_len.reshape(-1),
        out_cnt.reshape(-1),
        out_codes.reshape(n_shards * Fp, L),
    )
