"""Change-point segmentation of beta files into homogeneously-methylated blocks.

The port's copy of wgbs_tools_tpu/models/segment.py, with the same names.
The reference implements this as a single-core C++ DP over 60k-site chunks
(ref: src/segment_betas/segmentor.cpp:60-159) orchestrated by a Python Pool
with overlap-patch stitching (ref: src/python/segment.py). The DP:

    M[i+1] = max_{k in [i+1-max_cpg, i]} M[k] + cost(k, i)
    cost(k, i) = sum_d  nm*log2(p) + (nt-nm)*log2(1-p),
                 p = (nm + pc) / (nt + 2*pc)  over sites k..i of dataset d
    blocks longer than max_bp basepairs get cost -inf

Two modes:
- "exact" (the CLI default) gives the reference segmentor's borders
  byte for byte, on the device it is given. On a CUDA device (the
  default) the chunks, batched by size, and windows of 4096 sites or more
  run through models/segment_exact_device.py: the ll table on the host,
  the cost and float64 DP in the kernel csrc/segment_exact.cu; a window
  that route does not take (JAX's eligibility) and the stitching's
  patches run on the host DP. On the CPU it runs the host DP
  (host/segment_exact.cpp through native.segment_exact_native, the JAX
  package's kernel copied), chunks on a thread pool. There is no numpy
  emulation: a host library that cannot be built raises.
- "fast" runs in float32 on a torch device: the cost tensor
  (_cost_fast), the blocked max-plus DP (_dp_fast_blocked, its in-block
  closures in the hand-written kernel ops/maxplus.py::maxplus_closure) or,
  for a lone window under 512 sites, the scan DP (_dp_fast_scan), the
  traceback as a border mask on the device (_borders_mask) and its bit
  packing (pack_mask_bits); only the packed masks cross to the host. The
  DP's adds and maxima are exact, so given the same cost tensor it gives
  the JAX package's tracebacks bit for bit; the cost's log2 may differ by
  an ulp between libraries. With device "cuda" and more than one card
  visible, the chunk groups go over all the cards
  (parallel/sharded.py::segment_windows_sharded), as in JAX.

The chunking and the overlap-patch stitching are host code, as in JAX.
"""

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..device import resolve_device, timed
from ..formats.beta import load_beta
from ..native import segment_exact_native
from ..ops.maxplus import maxplus_closure
from ..utils import IllegalArgumentError

DEF_CHUNK = 60000  # ref: segment.py:21
NEG = float("-inf")
SCAN_MAX = 512  # a lone fast window below this many sites takes the scan DP
EXACT_DEVICE_MIN = 4096  # a lone exact window takes the device from here
BLOCK = 128     # borders per block of the blocked DP


def _prefix_sums(data):
    """data: (K, n, 2) int -> meth/total prefix sums (K, n+1) int64."""
    data = np.asarray(data, dtype=np.int64)
    ps = np.zeros((data.shape[0], data.shape[1] + 1, 2), dtype=np.int64)
    np.cumsum(data, axis=1, out=ps[:, 1:])
    return ps[:, :, 0], ps[:, :, 1]


def _traceback(T, n):
    """ref: segmentor.cpp:50-58 — borders ascending, endpoints included."""
    borders = [n]
    i = n
    while i > 0:
        i = max(0, int(T[i]))
        borders.append(i)
    return np.array(borders[::-1], dtype=np.int64)


# ---------------------------------------------------------------------------
# Fast float32 path (torch, on the device the tensors lie on)
# ---------------------------------------------------------------------------


def _hankel(x, n, W):
    """Hankel view S[..., i, j] = x[..., i + j], i in [0, n), j in [0, W).

    x must have length >= n + W - 1 along its last axis. A strided view
    (unfold), so nothing is copied until it is used."""
    return x.unfold(-1, W, 1)[..., :n, :]


def _safe_log2(x):
    """log2(x) where x > 0, else 0 (the JAX package's _safe_log2)."""
    y = x.clamp_min(1e-38).log2_()
    return y.masked_fill_(x.gt(0).logical_not_(), 0.0)


def _warm_cpu_log2():
    """One throwaway log2 over a tensor that every intra-op thread takes a
    slice of: an unverified workaround. Without it, the CPU cost build's
    first torch.log2 now and then gave one intra-op thread's whole slice
    errors of hundreds of ulps, while later calls were exact to half an
    ulp. It showed only in test processes that had run the JAX package
    first, on a loaded host; a bare first log2 in a fresh process did not
    show it, so its cause (MKL's VML, which runs the log2, is the suspect)
    is not known. The cost build takes its own log2s only after this one."""
    torch.log2(torch.ones(max(torch.get_num_threads(), 1) << 16))


def _cost_fast(pm, pt, loci, W, max_bp, pc):
    """Cost tensor Crev[..., i, j] (f32) with j = W-1-w (ascending-k order,
    Crev[i, j] = cost(k = i-W+1+j, i)); from _cost_fast_jax.

    pm/pt: int32 (K, n+1) prefix sums and loci: int32 (n,) on one device,
    or the same with a leading window axis (nw, K, n+1) / (nw, n). The
    datasets accumulate one at a time into one f32 tensor, in place, so
    the build holds a few (nw, n, W) tensors at most. pc is taken as an
    f32 scalar, and 2 * pc and p are computed in f32, as in JAX."""
    single = pm.dim() == 2
    if single:
        pm, pt, loci = pm[None], pt[None], loci[None]
    nw, K, _ = pm.shape
    n = loci.shape[-1]
    dev = pm.device
    pc = torch.tensor(pc, dtype=torch.float32, device=dev)
    pc2 = 2 * pc
    j_col = torch.arange(W, device=dev)[None, :]
    i_row = torch.arange(n, device=dev)[:, None]
    valid = (i_row - (W - 1) + j_col) >= 0  # k >= 0

    def window_vals(vec, fill):
        # S[w, i, j] = vec[w, k] with k = i - (W-1) + j; k < 0 reads fill
        pad = fill.expand(nw, W - 1)
        return _hankel(torch.cat([pad, vec], dim=-1), n, W)

    if dev.type == "cpu":
        _warm_cpu_log2()
    zero = torch.zeros((nw, 1), dtype=pm.dtype, device=dev)
    row = torch.zeros((nw, n, W), dtype=torch.float32, device=dev)
    for d in range(K):
        nm = (pm[:, d, 1:n + 1, None] - window_vals(pm[:, d, :n + 1], zero)
              ).to(torch.float32)
        nt = (pt[:, d, 1:n + 1, None] - window_vals(pt[:, d, :n + 1], zero)
              ).to(torch.float32)
        empty = nt == 0
        p = (nm + pc).div_(nt + pc2)
        lq = _safe_log2(1.0 - p)
        lp = _safe_log2(p)
        del p
        # ll = nm * log2(p) + (nt - nm) * log2(1 - p)
        ll = lp.mul_(nm).add_(lq.mul_(nt.sub_(nm)))
        del nm, nt, lq
        row.add_(ll.masked_fill_(empty, 0.0))
        del ll, empty

    if max_bp:
        lk = window_vals(loci[:, :n], loci[:, :1])
        row.masked_fill_((loci[:, :, None] - lk) > max_bp, NEG)
    row.masked_fill_(valid.logical_not_(), NEG)
    return row[0] if single else row


def _closure_inputs(Crev, W, B=BLOCK):
    """The blocked DP's blocks and in-block edge matrices.

    Crev: (nw, n, W) f32. Returns (blocks (nw, n_blocks, B, W): Crev's rows
    padded with -inf to a whole block, S0 (nw * n_blocks, B+1, B+1)
    contiguous: I (+) A per block, A[p, q] = rows[q-1, W-(q-p)] for
    1 <= p < q, q - p <= W, else -inf). A is the JAX package's staircase
    skew (segment.py:316-320), read here by index."""
    nw, n, _ = Crev.shape
    dev = Crev.device
    n_blocks = (n + B - 1) // B
    blocks = torch.full((nw, n_blocks * B, W), NEG, dtype=torch.float32,
                        device=dev)
    blocks[:, :n] = Crev
    blocks = blocks.view(nw, n_blocks, B, W)
    P = torch.arange(B + 1, device=dev)[:, None]
    Q = torch.arange(B + 1, device=dev)[None, :]
    a_valid = (Q > P) & (P >= 1) & (Q - P <= W)
    A = blocks[:, :, (Q - 1).clamp(0, B - 1).expand(B + 1, B + 1),
               (W - (Q - P)).clamp(0, W - 1)]
    S0 = A.masked_fill_(a_valid.logical_not(), NEG).masked_fill_(P == Q, 0.0)
    return blocks, S0.view(-1, B + 1, B + 1)


def _dp_fast_blocked(Crev, W, B=BLOCK):
    """Blocked max-plus DP (from the JAX package's _dp_fast_blocked).

    The site axis is cut into blocks of B borders: contributions from
    borders before a block are a parallel (B, W) reduction, and the
    in-block dependencies are closed with ceil(log2 B) max-plus squarings
    of the (B+1, B+1) edge matrix S = I (+) A, all blocks at once, in the
    maxplus_closure kernel. A sequential loop over the blocks carries the
    last W values of M; the optimal predecessors come from one parallel
    argmax pass over the final M.

    Crev: (n, W) or (nw, n, W) float32 cost rows in ascending-k order
    (Crev[i, j] = cost(k = i-W+1+j, i)). Returns T (n+1,) / (nw, n+1) int32.
    """
    single = Crev.dim() == 2
    if single:
        Crev = Crev[None]
    nw, n, _ = Crev.shape
    dev = Crev.device
    blocks, S0 = _closure_inputs(Crev, W, B)
    n_blocks = blocks.shape[1]
    log_steps = max(int(math.ceil(math.log2(max(B, 2)))), 1)
    Sstars = maxplus_closure(S0, log_steps).view(nw, n_blocks, B + 1, B + 1)
    del S0

    # H term: H[q] = max_j Mwin[(q-1) + j] + rows[q-1, j] restricted to
    # k <= b0  (k - b0 = q + j - W)
    Jj = torch.arange(W, device=dev)[None, :]
    Qq = torch.arange(1, B + 1, device=dev)[:, None]
    h_invalid = (Qq + Jj - W) > 0
    negB = torch.full((nw, B), NEG, dtype=torch.float32, device=dev)
    Mwin = torch.full((nw, W), NEG, dtype=torch.float32, device=dev)
    Mwin[:, -1] = 0.0  # Mwin = M[b0-W+1 .. b0]
    Ms = torch.empty((nw, n_blocks * B), dtype=torch.float32, device=dev)
    for b in range(n_blocks):
        gat = _hankel(torch.cat([Mwin, negB], dim=-1), B, W)
        H = (gat + blocks[:, b]).masked_fill_(h_invalid, NEG).amax(dim=-1)
        v = torch.cat([Mwin[:, -1:], H], dim=-1)  # borders b0 .. b0+B
        M_blk = torch.maximum((v[:, :, None] + Sstars[:, b]).amax(dim=1), v)
        Ms[:, b * B:(b + 1) * B] = M_blk[:, 1:]
        Mwin = torch.cat([Mwin, M_blk[:, 1:]], dim=-1)[:, -W:]
    del blocks, Sstars

    # parallel predecessor recovery: T[i+1] = argmax_k M[k] + Crev[i, :]
    Mpad = torch.cat([torch.full((nw, W - 1), NEG, dtype=torch.float32,
                                 device=dev),
                      torch.zeros((nw, 1), dtype=torch.float32, device=dev),
                      Ms[:, :n]], dim=-1)
    am = torch.argmax(_hankel(Mpad, n, W) + Crev, dim=-1)  # first maximum
    ks = (torch.arange(n, device=dev) - (W - 1) + am).to(torch.int32)
    T = torch.cat([torch.zeros((nw, 1), dtype=torch.int32, device=dev), ks],
                  dim=-1)
    return T[0] if single else T


def _dp_fast_scan(Crev, W):
    """Sequential DP (from the JAX package's _dp_fast_jax, a lax.scan).
    Crev: (n, W) f32 in ascending-k order. Returns T (n+1,) int32."""
    n = Crev.shape[0]
    dev = Crev.device
    Mpad = torch.full((n + W + 1,), NEG, dtype=torch.float32, device=dev)
    Mpad[W] = 0.0
    ams = []
    for i in range(n):
        cand = Mpad[i + 1:i + 1 + W] + Crev[i]  # M[k], ascending k
        ams.append(torch.argmax(cand))  # first max = smallest k
        Mpad[W + i + 1] = cand.amax()
    ks = (torch.arange(n, device=dev) - (W - 1)
          + torch.stack(ams)).to(torch.int32)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), ks])


def _borders_mask(T):
    """Device traceback: mark the border chain {n, T[n], T[T[n]], .., 0}.

    Pointer doubling: after round k, S holds every chain node reachable
    from n in < 2^k steps and P is T composed 2^k times, so
    ceil(log2(n+1)) rounds of one scatter-max and one gather mark the whole
    chain, and only the mask crosses to the host. T: int32 (n+1,) or
    (nw, n+1); returns uint8 of the same shape. The scatter-max reads the
    old S (out of place, into a new tensor) and runs on int32, which CUDA
    reduces with amax."""
    n1 = T.shape[-1]
    P = T.clamp(0, n1 - 1).to(torch.int64)
    P[..., 0] = 0
    S = torch.zeros(T.shape, dtype=torch.int32, device=T.device)
    S[..., n1 - 1] = 1
    for _ in range(max(1, int(math.ceil(math.log2(n1))))):
        # for every marked p, mark its 2^k-th predecessor P[p]
        S = S.scatter_reduce(-1, P, S, reduce="amax", include_self=True)
        P = torch.gather(P, -1, P)
    return S.to(torch.uint8)


def pack_mask_bits(masks):
    """uint8 0/1 masks (nw, m) -> bit-packed (nw, ceil(m/8)) uint8,
    numpy-`unpackbits`-compatible (MSB first), on the masks' device."""
    nw, m = masks.shape
    m8 = (m + 7) // 8 * 8
    p = torch.zeros((nw, m8), dtype=torch.uint8, device=masks.device)
    p[:, :m] = masks
    p = p.view(nw, m8 // 8, 8).to(torch.int32)
    w = 1 << torch.arange(7, -1, -1, dtype=torch.int32, device=masks.device)
    return (p * w).sum(dim=-1).to(torch.uint8)


def unpack_mask_bits(packed, m):
    """Host inverse of pack_mask_bits: (nw, m8/8) uint8 -> (nw, m) uint8."""
    return np.unpackbits(np.asarray(packed), axis=1)[:, :m]


def _int32(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dev)


def segment_windows_fast(datas, locis, max_cpg=1000, max_bp=2000,
                         pseudo_count=15.0, batch=8, device="cuda",
                         timings=None):
    """Batch-segment many equal-size windows (fast float32 mode).

    datas: (nw, K, n, 2) int counts; locis: (nw, n). Returns a list of
    relative border arrays. Windows run `batch` at a time (the tail is
    padded with window 0 and dropped), all batches queued before the masks
    are fetched; device memory stays bounded at a few (batch, n, W)
    tensors per batch. With `timings` (a dict), the seconds of the upload,
    cost, DP (with the mask and its packing) and mask fetch stages are
    added to it, each device stage ending in a synchronize."""
    dev = resolve_device(device)
    datas = np.asarray(datas)
    locis = np.asarray(locis)
    nw, K, n, _ = datas.shape
    W = int(min(max_cpg, n))
    batch = max(1, min(batch, nw))
    max_bp = int(max_bp) if max_bp else 0
    pc = float(pseudo_count)
    pms, pts = [], []
    for w in range(nw):
        pm, pt = _prefix_sums(datas[w])
        pms.append(pm)
        pts.append(pt)
    outs = []
    for lo in range(0, nw, batch):
        sel = list(range(lo, min(lo + batch, nw)))
        sel = sel + [sel[0]] * (batch - len(sel))
        with timed(timings, "h2d", dev):
            pm = _int32(np.stack([pms[w] for w in sel]), dev)
            pt = _int32(np.stack([pts[w] for w in sel]), dev)
            loci = _int32(locis[sel], dev)
        with timed(timings, "cost", dev):
            Crev = _cost_fast(pm, pt, loci, W, max_bp, pc)
        with timed(timings, "dp", dev):
            outs.append(pack_mask_bits(_borders_mask(_dp_fast_blocked(Crev,
                                                                      W))))
        del Crev
    with timed(timings, "mask_fetch", None):
        masks = [unpack_mask_bits(o.cpu().numpy(), n + 1) for o in outs]
    res = []
    for li, lo in enumerate(range(0, nw, batch)):
        for j in range(min(batch, nw - lo)):
            res.append(np.flatnonzero(masks[li][j]).astype(np.int64))
    return res


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def segment_borders(data, loci, max_cpg=1000, max_bp=2000, pseudo_count=15.0,
                    mode="exact", device="cuda"):
    """Segment one window of K beta datasets.

    data: (K, n, 2) int counts for sites [s, s+n).
    loci: int (n,) basepair positions of those sites (for max_bp).
    Returns 0-based relative border array (ascending, includes 0 and n).
    `device` is the torch device (cuda by default: it raises without
    CUDA). Fast mode runs on it; exact mode runs a window of
    EXACT_DEVICE_MIN sites or more on it where it is CUDA, and on the host
    DP otherwise.
    """
    data = np.asarray(data)
    K, n, _ = data.shape
    if n == 1:
        return np.array([0, 1], dtype=np.int64)
    W = int(min(max_cpg, n))
    loci = np.asarray(loci, dtype=np.int64)
    if loci.shape[0] != n:
        raise IllegalArgumentError(
            f"nr_sites != number of loci: {n} != {loci.shape[0]}"
        )

    if mode == "exact":
        dev = resolve_device(device)
        T = None
        # the device route: bit-identical, None for an ineligible window.
        # Small windows (the stitching's patches, ~100-400 sites) stay on
        # the host, as in JAX
        if n >= EXACT_DEVICE_MIN and dev.type == "cuda":
            from .segment_exact_device import segment_exact_device_T

            T = segment_exact_device_T(data, loci, W, max_bp, pseudo_count,
                                       device=dev)
        if T is None:
            # native C++ kernel: the reference's rounding chain,
            # band-limited cost evaluation (host/segment_exact.cpp)
            T = segment_exact_native(data, loci, W, max_bp, pseudo_count)
    elif mode == "fast":
        dev = resolve_device(device)
        pm, pt = _prefix_sums(data)
        Crev = _cost_fast(_int32(pm, dev), _int32(pt, dev), _int32(loci, dev),
                          W, int(max_bp) if max_bp else 0,
                          float(pseudo_count))
        if n >= SCAN_MAX:
            T = _dp_fast_blocked(Crev, W)
        else:
            T = _dp_fast_scan(Crev, W)
        T = T.cpu().numpy().astype(np.int64)
    else:
        raise IllegalArgumentError(f"unknown segment mode: {mode}")
    return _traceback(T, n)


def segment_sites_window(beta_paths, sites, index, max_cpg=1000, max_bp=2000,
                         pseudo_count=15.0, mode="exact", device="cuda"):
    """Segment 1-based [start, end) sites of beta files.

    Returns absolute 1-based border sites (ref: segment.py:41-55 adds +start).
    """
    start, end = sites
    if end - start == 1:
        return np.array([start, end], dtype=np.int64)
    data = np.stack([load_beta(b, sites=(start, end)) for b in beta_paths])
    for d, b in zip(data, beta_paths):
        if (d[:, 0] > d[:, 1]).any():
            raise IllegalArgumentError(f"invalid beta data in {b}")
    loci = index.loci[start - 1 : end - 1]
    rel = segment_borders(data, loci, max_cpg, max_bp, pseudo_count,
                          mode=mode, device=device)
    return rel + start


# ---------------------------------------------------------------------------
# Chunked orchestration + overlap-patch stitching (ref: segment.py:84-252)
# ---------------------------------------------------------------------------


class SegmentConfig:
    """Segmentation settings. `device` is the torch device, cuda by default
    (it raises without CUDA). Fast mode runs on it; exact mode runs its DP
    on the card where it is CUDA, and on the host DP's thread pool where it
    is the CPU. `timings`, a dict, collects the stage seconds of
    segment_ranges."""

    def __init__(self, max_cpg=1000, max_bp=2000, pseudo_count=15.0,
                 chunk_size=DEF_CHUNK, min_cpg=1, mode="exact", threads=None,
                 device="cuda", timings=None):
        self.max_bp = max_bp
        self.max_cpg = min(max_cpg, max_bp // 2) if max_bp else max_cpg
        if self.max_cpg <= 1:
            raise IllegalArgumentError(
                f"max_cpg must exceed 1 (min(max_cpg, max_bp // 2) is "
                f"{self.max_cpg})")
        self.pseudo_count = pseudo_count
        self.chunk_size = chunk_size
        self.min_cpg = min_cpg
        self.mode = mode
        if threads is None:
            threads = int(os.environ.get("SLURM_JOB_CPUS_PER_NODE", 0)) \
                or (os.cpu_count() or 1)  # ref: utils_wgbs.py:250-261
        self.threads = max(1, threads)
        self.device = resolve_device(device)
        self.timings = timings


def break_to_chunks(ranges, step):
    """[(s, e)] -> (tags, chunk_sites) keeping ranges separated
    (ref: segment.py:126-135)."""
    tags, chunks = [], []
    for start, end in ranges:
        bords = list(range(start, end, step)) + [end]
        for s, e in zip(bords[:-1], bords[1:]):
            tags.append((start, end))
            chunks.append((s, e))
    return tags, chunks


def segment_ranges(beta_paths, ranges, index, cfg: SegmentConfig):
    """Segment a list of site ranges; returns (startCpG, endCpG) block arrays."""
    tags, chunks = break_to_chunks(ranges, cfg.chunk_size)
    seg = _seg_fn(beta_paths, index, cfg)
    results = segment_chunks(beta_paths, chunks, index, cfg)
    batch_seg = (_batch_seg_fast(beta_paths, index, cfg)
                 if cfg.mode == "fast" else None)
    with timed(cfg.timings, "stitch", cfg.device):
        return finalize_segmentation(tags, chunks, results, seg, cfg,
                                     batch_seg=batch_seg)


def _seg_fn(beta_paths, index, cfg):
    return lambda sites: segment_sites_window(
        beta_paths, sites, index, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count,
        cfg.mode, cfg.device,
    )


def _load_windows(beta_paths, windows, index):
    """(datas (nw, K, n, 2), locis (nw, n)) of equal-size 1-based windows."""
    datas = np.stack([np.stack([load_beta(b, sites=w) for b in beta_paths])
                      for w in windows])
    locis = np.stack([index.loci[s - 1 : e - 1] for s, e in windows])
    return datas, locis


def segment_chunks(beta_paths, chunks, index, cfg: SegmentConfig,
                   subset=None):
    """Per-chunk absolute border arrays (the parallelizable phase of
    segment_ranges). `subset`: chunk indices this caller owns (default
    all) — entries outside it stay None; the multi-process path
    (parallel/multihost.py) round-robins the subset over processes. In fast
    mode a group of equal-size chunks goes to segment_windows_fast on
    cfg.device, or, where cfg.device is "cuda" and more than one card is
    visible, to parallel/sharded.py::segment_windows_sharded over all of
    them (JAX's multi-device route)."""
    seg = _seg_fn(beta_paths, index, cfg)
    results = [None] * len(chunks)
    own = list(range(len(chunks))) if subset is None else \
        sorted(set(int(i) for i in subset))
    if cfg.mode == "exact" and cfg.device.type == "cuda":
        # the exact DP on the device, batched over equal-size chunks (no
        # size gate: every chunk of more than one site); a window the route
        # does not take stays None and runs on the host below
        from .segment_exact_device import segment_exact_device_batch

        by_size = {}
        for i in own:
            s, e = chunks[i]
            if e - s > 1:
                by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            with timed(cfg.timings, "beta_load", None):
                datas, locis = _load_windows(beta_paths,
                                             [chunks[i] for i in idxs], index)
            # the host path's invalid-beta guard (segment_sites_window), on
            # the device route too: the first chunk's first bad beta raises
            bad = np.argwhere((datas[..., 0] > datas[..., 1]).any(axis=2))
            if bad.size:
                raise IllegalArgumentError(
                    f"invalid beta data in {beta_paths[bad[0, 1]]}")
            Ts = segment_exact_device_batch(
                datas, locis, int(min(cfg.max_cpg, n)), cfg.max_bp,
                cfg.pseudo_count, device=cfg.device, timings=cfg.timings)
            del datas
            for i, T in zip(idxs, Ts):
                if T is not None:
                    results[i] = _traceback(T, n) + chunks[i][0]
    if cfg.mode == "fast":
        # batch all equal-size chunks into single device launches
        by_size = {}
        for i in own:
            s, e = chunks[i]
            by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            if n <= 1 or len(idxs) == 1:
                continue
            with timed(cfg.timings, "beta_load", None):
                datas, locis = _load_windows(beta_paths,
                                             [chunks[i] for i in idxs], index)
            if (cfg.device.type == "cuda" and cfg.device.index is None
                    and torch.cuda.device_count() > 1):
                # the window axis over every visible card (the windows are
                # independent by the chunk+stitch decomposition; replaces
                # the reference's process Pool, segment.py:144-146)
                from ..parallel.mesh import make_mesh
                from ..parallel.sharded import segment_windows_sharded

                borders = segment_windows_sharded(
                    make_mesh(device="cuda"), datas, locis, cfg.max_cpg,
                    cfg.max_bp, cfg.pseudo_count, timings=cfg.timings)
            else:
                borders = segment_windows_fast(
                    datas, locis, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count,
                    device=cfg.device, timings=cfg.timings)
            for i, rel in zip(idxs, borders):
                results[i] = rel + chunks[i][0]
    todo = [i for i in own if results[i] is None]
    with timed(cfg.timings, "chunks", cfg.device):
        if cfg.mode == "exact" and cfg.threads > 1 and len(todo) > 1:
            # thread pool over chunks (the reference forks a process per
            # chunk, segment.py:144-146; the C++ DP releases the GIL, so
            # threads scale and the beta files / index stay shared)
            with ThreadPoolExecutor(min(cfg.threads, len(todo))) as pool:
                for i, res in zip(todo, pool.map(seg, [chunks[i]
                                                       for i in todo])):
                    results[i] = res
        else:
            for i in todo:
                results[i] = seg(chunks[i])
    return results


def _batch_seg_fast(beta_paths, index, cfg):
    """Batched window segmentation for the fast-mode stitcher: groups
    equal-size patch windows into single device launches (identical
    per-window borders to segment_sites_window(mode=fast))."""

    def run(windows):
        out = [None] * len(windows)
        by_size = {}
        for i, (s, e) in enumerate(windows):
            by_size.setdefault(e - s, []).append(i)
        for n, idxs in by_size.items():
            if n <= 1 or len(idxs) == 1:
                for i in idxs:
                    out[i] = segment_sites_window(
                        beta_paths, windows[i], index, cfg.max_cpg,
                        cfg.max_bp, cfg.pseudo_count, "fast", cfg.device)
                continue
            datas, locis = _load_windows(beta_paths,
                                         [windows[i] for i in idxs], index)
            borders = segment_windows_fast(
                datas, locis, cfg.max_cpg, cfg.max_bp, cfg.pseudo_count,
                device=cfg.device)
            for i, rel in zip(idxs, borders):
                out[i] = rel + windows[i][0]
        return out

    return run


def finalize_segmentation(tags, chunks, results, seg, cfg: SegmentConfig,
                          batch_seg=None):
    """Stitch per-chunk borders into the final (starts, ends) block arrays
    (the sequential phase of segment_ranges; overlap patches re-segment
    through `seg` — or through `batch_seg` in one device launch per
    stitching round, ref: segment.py:157-252)."""
    order_tags = list(dict.fromkeys(tags))  # preserve order, unique
    groups = [[results[i] for i in range(len(results)) if tags[i] == tag]
              for tag in order_tags]
    if batch_seg is not None:
        merged_list = _merge_groups_batched(groups, batch_seg)
    else:
        merged_list = [_merge_border_list(g, seg) for g in groups]
    all_starts, all_ends = [], []
    for merged in merged_list:
        all_starts.append(merged[:-1])
        all_ends.append(merged[1:])
    starts = np.concatenate(all_starts) if all_starts else np.empty(0, np.int64)
    ends = np.concatenate(all_ends) if all_ends else np.empty(0, np.int64)
    order = np.argsort(starts, kind="stable")
    starts, ends = starts[order], ends[order]
    keep = ends - starts > cfg.min_cpg - 1
    return starts[keep], ends[keep]


def _merge_border_list(blist, seg_fn):
    """Pairwise-reduce stitching rounds (ref: segment.py:157-165)."""
    while len(blist) > 1:
        nxt = [
            _stitch_2(blist[i - 1], blist[i], seg_fn)
            for i in range(1, len(blist), 2)
        ]
        if len(blist) % 2:
            nxt.append(blist[-1])
        blist = nxt
    return blist[0]


def _merge_groups_batched(groups, batch_seg):
    """All tags' pairwise stitching rounds with BATCHED patch
    re-segmentation: every pending pair's patch window segments in one
    device launch per (round, growth iteration) instead of one launch per
    pair. Per-pair semantics are exactly _stitch_2's (same initial patch,
    same growth rule, same failure condition), so the merged borders are
    identical to the serial path.

    groups: list of border lists (one per tag). Returns the merged border
    array per tag.
    """
    out = [None] * len(groups)
    work = [(gi, list(g)) for gi, g in enumerate(groups)]
    while work:
        nxt_work = []
        pairs = []  # [gi, slot, b1, b2, p1, p2, n1, n2]
        slots = {}  # (gi) -> next-round blist with None placeholders
        for gi, blist in work:
            if len(blist) == 1:
                out[gi] = blist[0]
                continue
            nxt = []
            for i in range(1, len(blist), 2):
                b1, b2 = blist[i - 1], blist[i]
                if b1[-1] != b2[0]:
                    raise IllegalArgumentError(
                        "Patch stitching failed: non-adjacent chunks")
                n1 = int(b1[-1] - b1[0])
                n2 = int(b2[-1] - b2[0])
                pairs.append([gi, len(nxt), b1, b2, min(50, n1),
                              min(50, n2), n1, n2])
                nxt.append(None)
            if len(blist) % 2:
                nxt.append(blist[-1])
            slots[gi] = nxt
        pending = pairs
        while pending:
            wins = [(int(p[2][-1]) - p[4], int(p[2][-1]) + p[5])
                    for p in pending]
            patches = batch_seg(wins)
            still = []
            for p, patch in zip(pending, patches):
                gi, slot, b1, b2, p1, p2, n1, n2 = p
                o1 = _overlaps(b1, patch)
                o2 = _overlaps(patch, b2)
                if o1 and o2:
                    slots[gi][slot] = _merge2(_merge2(b1, patch), b2)
                    continue
                if not o1:
                    p[4] = _grow(p1, n1)
                if not o2:
                    p[5] = _grow(p2, n2)
                if p[4] > n1 or p[5] > n2:
                    raise IllegalArgumentError(
                        "Patch stitching failed. Try increasing chunk "
                        "size (--chunk_size)")
                still.append(p)
            pending = still
        for gi, nxt in slots.items():
            nxt_work.append((gi, nxt))
        work = nxt_work
    return out


def _stitch_2(b1, b2, seg_fn):
    """Re-segment an overlap patch until its borders agree with both sides
    (ref: segment.py:199-252)."""
    if b1[-1] != b2[0]:
        raise IllegalArgumentError("Patch stitching failed: non-adjacent chunks")
    n1 = int(b1[-1] - b1[0])
    n2 = int(b2[-1] - b2[0])
    p1 = min(50, n1)
    p2 = min(50, n2)
    while p1 <= n1 and p2 <= n2:
        start = int(b1[-1]) - p1
        end = int(b1[-1]) + p2
        patch = seg_fn((start, end))
        if _overlaps(b1, patch) and _overlaps(patch, b2):
            return _merge2(_merge2(b1, patch), b2)
        if not _overlaps(b1, patch):
            p1 = _grow(p1, n1)
        if not _overlaps(patch, b2):
            p2 = _grow(p2, n2)
    raise IllegalArgumentError(
        "Patch stitching failed. Try increasing chunk size (--chunk_size)"
    )


def _dups_mask(b1, b2):
    cat = np.concatenate([b1, b2])
    _, inv, counts = np.unique(cat, return_inverse=True, return_counts=True)
    return counts[inv] > 1


def _overlaps(b1, b2):
    return bool(_dups_mask(b1, b2).sum())


def _merge2(b1, b2):
    dups = _dups_mask(b1, b2)
    nr_from_b1 = int(np.argmax(dups))
    skip_from_b2 = int(np.searchsorted(b2, b1[nr_from_b1]))
    return np.concatenate([b1[: nr_from_b1 + 1], b2[skip_from_b2 + 1 :]])


def _grow(pre, maxval):
    if pre == maxval:
        return maxval + 1
    return int(min(pre * 2, maxval))
