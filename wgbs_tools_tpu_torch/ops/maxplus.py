"""Max-plus closure of the fast segmentation DP's in-block edge matrices:
the CUDA kernel's wrapper and its plain PyTorch twin.

`maxplus_closure(S0, steps)` squares each (n, n) f32 matrix of S0
(nb, n, n) `steps` times in the (max, +) semiring,
S'[p, q] = max_r S[p, r] + S[r, q]. It replaces `closure` inside
wgbs_tools_tpu/models/segment.py::_dp_fast_blocked (:313-329), where S0 =
I (+) A of one block of B = 128 borders (n = 129) and steps =
ceil(log2 B) = 7. The kernel (csrc/maxplus.cu::maxplus_closure_kernel)
keeps one block's matrix on chip; on a matrix with nothing finite below
the diagonal (the DP's) it computes only the upper triangle, in 4 x 4
tiles that `upper_schedule(n)` hands to its threads. The twin
materializes the n^3 sums of a slice of blocks at a time. max is exact
and each sum is one IEEE rounding, so the two agree bit for bit (the twin
refuses +inf and NaN, which would break that). A wrapper sends CUDA
tensors to the kernel and CPU tensors to the twin; any other device
raises. `maxplus_closure.launches` counts its
launches.
"""

import functools

import numpy as np
import torch

from .. import _kernels

NMAX = 144               # the kernel's largest matrix side
TWIN_ELEMS = 1 << 26     # (blocks, n, n, n) sums per twin slice (256 MB)
# the kernel's upper schedule (csrc/maxplus.cu): threads per CTA, output
# tile side, tiles per thread at most, lanes per warp, warp schedulers per SM
THREADS, TILE, SLOTS, WARP, SCHEDULERS = 256, 4, 3, 32, 4


def tile_r_range(a, c, n):
    """The r that the kernel scans for output tile (a, c): [p_lo, r_end)."""
    return TILE * a, min(TILE * c + TILE, n)


def tile_pairs(a, c, n):
    """The (p, r, q) triples that the kernel evaluates for tile (a, c), as
    closure_upper's loops run: a diagonal tile's r = p_lo + t (< n) reach
    rows i <= t and columns j >= t; another tile's first TILE - 1 r reach
    rows i <= r - p_lo, its r in [p_lo + TILE - 1, q_lo] all, and its last
    TILE - 1 r (< n) columns j >= r - q_lo."""
    p_lo, q_lo = TILE * a, TILE * c
    if a == c:
        return sum((t + 1) * (TILE - t) for t in range(TILE) if p_lo + t < n)
    return (TILE * TILE * (TILE - 1) // 2
            + TILE * TILE * (q_lo - p_lo - TILE + 2)
            + sum(TILE * (TILE - t) for t in range(1, TILE) if q_lo + t < n))


@functools.lru_cache(maxsize=None)
def upper_schedule(n):
    """The kernel's upper schedule for side n: an int32 (SLOTS, THREADS)
    table whose entry [k, t] is thread t's tile of slot k, a << 16 | c for
    the 4 x 4 output tile (a, c), c >= a (rows [TILE a, TILE a + TILE) by
    columns [TILE c, TILE c + TILE) of the side padded to a multiple of
    TILE), or -1.

    The tiles, sorted by the length of their r range (longest first), are
    cut into groups of WARP: a group is one warp's slot, so its lanes loop
    for nearly the same count. The groups go to the SM's SCHEDULERS
    (warp w runs on scheduler w % SCHEDULERS) longest first, each to the
    least loaded scheduler with a free slot, and within a scheduler to the
    least loaded of its warps, so every scheduler's warps sum to nearly the
    same count of r steps. Read-only (cached)."""
    if not 1 <= n <= NMAX:
        raise ValueError(f"n={n} must be in [1, {NMAX}]")
    nt = -(-n // TILE)
    tiles = sorted(((a, c) for a in range(nt) for c in range(a, nt)),
                   key=lambda t: (TILE * t[0] - tile_r_range(*t, n)[1], t))
    groups = [tiles[i:i + WARP] for i in range(0, len(tiles), WARP)]
    warps = THREADS // WARP
    per_sched = warps // SCHEDULERS
    sched_load = [0] * SCHEDULERS
    warp_load = [0] * warps
    warp_used = [0] * warps
    table = np.full((SLOTS, THREADS), -1, np.int32)
    for g in groups:  # longest first: the LPT rule
        lo, end = tile_r_range(*g[0], n)
        length = end - lo  # the group's longest
        free = [s for s in range(SCHEDULERS)
                if any(warp_used[s + SCHEDULERS * i] < SLOTS
                       for i in range(per_sched))]
        s = min(free, key=lambda s: sched_load[s])
        w = min((s + SCHEDULERS * i for i in range(per_sched)
                 if warp_used[s + SCHEDULERS * i] < SLOTS),
                key=lambda w: warp_load[w])
        table[warp_used[w], w * WARP:w * WARP + len(g)] = [
            a << 16 | c for a, c in g]
        sched_load[s] += length
        warp_load[w] += length
        warp_used[w] += 1
    table.flags.writeable = False
    return table


def upper_pairs(n):
    """The (p, r, q) triples that the upper schedule evaluates per matrix
    and squaring (tile_pairs over its table)."""
    t = upper_schedule(n)
    t = t[t >= 0]
    return sum(tile_pairs(int(a), int(c), n)
               for a, c in zip(t >> 16, t & 0xFFFF))


_SCHEDULES = {}


def _schedule_on(n, device):
    """upper_schedule(n) on `device`, uploaded once per (n, device)."""
    key = (n, device)
    if key not in _SCHEDULES:
        _SCHEDULES[key] = torch.from_numpy(upper_schedule(n).copy()).to(
            device)
    return _SCHEDULES[key]


def _check(S0, steps):
    if (S0.dim() != 3 or S0.shape[1] != S0.shape[2]
            or S0.dtype != torch.float32 or not S0.is_contiguous()):
        raise ValueError(f"S0: got {S0.dtype} {tuple(S0.shape)} "
                         f"(contiguous={S0.is_contiguous()}), want a "
                         "contiguous torch.float32 (nb, n, n)")
    if not 1 <= S0.shape[1] <= NMAX:
        raise ValueError(f"n={S0.shape[1]} must be in [1, {NMAX}]")
    if steps < 0:
        raise ValueError(f"steps={steps} must be >= 0")


def maxplus_closure(S0, steps):
    """S0 (nb, n, n) f32 squared `steps` times in the (max, +) semiring.

    Replaces the squarings of segment.py::_dp_fast_blocked's `closure`.
    CUDA tensors launch the kernel; CPU tensors take maxplus_closure_plain."""
    _check(S0, steps)
    if S0.device.type == "cpu":
        return maxplus_closure_plain(S0, steps)
    out = torch.empty_like(S0)
    nb, n, _ = S0.shape
    if nb == 0:
        return out
    sched = _schedule_on(n, S0.device)
    _kernels.launch("maxplus_closure", S0.device, S0.data_ptr(),
                    out.data_ptr(), sched.data_ptr(), nb, n, int(steps))
    maxplus_closure.launches += 1
    return out


maxplus_closure.launches = 0


def maxplus_closure_plain(S0, steps):
    """Twin of the kernel in plain PyTorch: the JAX package's squaring,
    max over r of S[:, p, r, None] + S[:, None, r, q], on slices of blocks
    so that the (blocks, n, n, n) sums stay within TWIN_ELEMS."""
    _check(S0, steps)
    if torch.isnan(S0).any() or (S0 == float("inf")).any():
        raise ValueError("S0 holds NaN or +inf: the max-plus closure takes "
                         "finite values and -inf only")
    nb, n, _ = S0.shape
    out = S0.clone()
    per = max(1, TWIN_ELEMS // max(n ** 3, 1))
    for lo in range(0, nb, per):
        S = S0[lo:lo + per]
        for _ in range(steps):
            S = (S[:, :, :, None] + S[:, None, :, :]).amax(dim=2)
        out[lo:lo + per] = S
    return out
