"""Exact segmentation's band cost and float64 ring DP: the CUDA kernel's
wrapper and its plain PyTorch twin.

`segment_exact_dp(pm, pt, loci, tbl, Wb, max_bp)` takes B windows' wrapped
int32 prefix sums pm, pt (B, K, n+1), their int32 loci (B, n), the host's
float32 ll table (models/segment_exact_device.py::build_ll_table) and the
band width Wb, and returns ks (B, n) int32: ks[i] = k of the first maximum,
in ascending k, of M[k] + C[i, v] over the band's ok cells, with M[i+1] that
maximum, M[0] = +0.0. It replaces
wgbs_tools_tpu/models/segment_exact_tpu.py::_exact_batch_ring_raw (:349):
the cost (_exact_cost_body :168, here exact_cost_plain) under vmap, then the
ring DP (_dp_exact_batched_ring :284, here dp_exact_ring_plain), which JAX
runs in software doubles. The kernel (csrc/segment_exact.cu) has two bodies
that its C entry picks by Wb alone (dp_occupancy reports it): "ahead",
where cost warps compute the steps' costs ahead of a chain warp into a
shared ring, and "single", one warp per window that computes each cell's
cost where its step needs it. The twin, segment_exact_dp_plain, chains the
two plain functions over slices of windows. All three do IEEE float64 adds
only, in the same order, and take the same first maximum, so they agree
bit for bit. A wrapper sends CUDA tensors to the kernel and CPU tensors to
the twin; any other device raises. `segment_exact_dp.launches` counts its
launches.
"""

import ctypes

import torch

from .. import _kernels
from ..models.segment import _hankel

LL_CAP_MAX = 32768     # the largest table cap whose index fits in int32
SMEM_RING = 6144       # the single body's largest ring of M in shared memory
TWIN_CELLS = 1 << 24   # (windows, n, Wb) cost cells per twin slice
NEG = float("-inf")


def dp_occupancy(Wb):
    """The launch segment_exact_dp makes for band width Wb on the current
    CUDA device, as its C entry chooses it, and the CTAs per SM that
    cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it: {"body":
    "ahead" or "single", "threads" per CTA, "lookahead" (cost slots, 0 for
    single), "smem" (dynamic shared bytes), "ctas_per_sm"}. Needs the
    card."""
    out = (ctypes.c_int64 * 5)()
    _kernels.check(_kernels.load().segment_exact_dp_occupancy(int(Wb), out),
                   "segment_exact_dp_occupancy")
    return {"body": "ahead" if out[0] else "single", "threads": out[1],
            "lookahead": out[3], "smem": out[2], "ctas_per_sm": out[4]}


def _check(pm, pt, loci, tbl, Wb, max_bp):
    for name, t in (("pm", pm), ("pt", pt), ("loci", loci)):
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name}: got {t.dtype} (contiguous="
                             f"{t.is_contiguous()}), want contiguous int32")
    if pm.dim() != 3 or pt.shape != pm.shape or pm.shape[1] < 1 \
            or pm.shape[2] < 2:
        raise ValueError(f"pm, pt: got {tuple(pm.shape)} and "
                         f"{tuple(pt.shape)}, want one (B, K >= 1, n+1 >= 2)")
    B, _, n1 = pm.shape
    if tuple(loci.shape) != (B, n1 - 1):
        raise ValueError(f"loci: got {tuple(loci.shape)}, want {(B, n1 - 1)}")
    if tbl.dtype != torch.float32 or tbl.dim() != 1 or tbl.numel() < 1 \
            or not tbl.is_contiguous():
        raise ValueError(f"tbl: got {tbl.dtype} {tuple(tbl.shape)}, want a "
                         "contiguous non-empty float32 vector")
    if tbl.numel() > LL_CAP_MAX * (LL_CAP_MAX + 1) // 2:
        raise ValueError(f"tbl: {tbl.numel():,} entries is a cap above "
                         f"{LL_CAP_MAX}, whose indices overflow int32")
    if not 1 <= Wb < 1 << 31:
        raise ValueError(f"Wb={Wb} must be in [1, 2^31)")
    if not 0 <= max_bp < 1 << 31:
        raise ValueError(f"max_bp={max_bp} must be in [0, 2^31) (0: no band)")
    devs = {t.device for t in (pm, pt, loci, tbl)}
    if len(devs) != 1:
        raise ValueError(f"pm, pt, loci and tbl lie on "
                         f"{sorted(map(str, devs))}: want one device")


def segment_exact_dp(pm, pt, loci, tbl, Wb, max_bp):
    """ks (B, n) int32 of the exact ring DP over B windows' band costs.

    Replaces segment_exact_tpu.py::_exact_batch_ring_raw. CUDA tensors
    launch the kernel (the body dp_occupancy(Wb) names); CPU tensors take
    segment_exact_dp_plain. The single body keeps M in shared memory up to
    SMEM_RING values of Wb and in global scratch above. The caller keeps
    every in-band index nt * (nt + 1) / 2 + nm (0 <= nm <= nt) inside tbl,
    as the route does."""
    Wb, max_bp = int(Wb), int(max_bp)
    _check(pm, pt, loci, tbl, Wb, max_bp)
    if pm.device.type == "cpu":
        return segment_exact_dp_plain(pm, pt, loci, tbl, Wb, max_bp)
    B, K, n1 = pm.shape
    ks = torch.empty((B, n1 - 1), dtype=torch.int32, device=pm.device)
    if B == 0:
        return ks
    ring = None
    if Wb > SMEM_RING:
        ring = torch.empty((B, Wb), dtype=torch.float64, device=pm.device)
    _kernels.launch("segment_exact_dp", pm.device, pm.data_ptr(),
                    pt.data_ptr(), loci.data_ptr(), tbl.data_ptr(),
                    ks.data_ptr(), None if ring is None else ring.data_ptr(),
                    B, K, n1 - 1, Wb, max_bp, tbl.numel())
    segment_exact_dp.launches += 1
    return ks


segment_exact_dp.launches = 0


def _wrap32(x):
    """int64 -> the int32 value it wraps to mod 2^32, still int64."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def exact_cost_plain(pm, pt, loci, tbl, Wb, max_bp):
    """The band costs C (B, n, Wb) float64 and their mask ok (B, n, Wb)
    bool of JAX's _exact_cost_body, for B windows at once: cell (i, v) is
    block [k..i], k = i - Wb + 1 + v, ok where k >= 0 and (max_bp 0, or)
    loci[i] - loci[k] <= max_bp; C = ll_0 + ... + ll_{K-1} in float64 in
    dataset order, ll_d = tbl[nt*(nt+1)//2 + nm] where ok and nt > 0, else
    +0.0, from the int32 prefix differences (wrapped, as JAX's int32
    subtraction wraps; taken here in int64 and wrapped). The table is
    indexed directly (JAX's _gather_tbl is a TPU gather workaround)."""
    B, K, n1 = pm.shape
    n = n1 - 1
    dev = pm.device
    j_col = torch.arange(Wb, device=dev)[None, :]
    i_row = torch.arange(n, device=dev)[:, None]
    valid = (i_row - (Wb - 1) + j_col) >= 0  # k >= 0

    def window_vals(vec, fill):
        # S[b, i, v] = vec[b, k], k = i - (Wb-1) + v; k < 0 reads fill
        pad = fill.expand(B, Wb - 1)
        return _hankel(torch.cat([pad, vec], dim=-1), n, Wb)

    lo = loci.to(torch.int64)
    if max_bp:
        lk = window_vals(lo, lo[:, :1])
        ok = valid & (_wrap32(lo[:, :, None] - lk) <= max_bp)
    else:
        ok = valid.expand(B, n, Wb).clone()
    zero = torch.zeros((B, 1), dtype=torch.int64, device=dev)
    C = None
    for d in range(K):
        m = pm[:, d].to(torch.int64)
        t = pt[:, d].to(torch.int64)
        nm = _wrap32(m[:, 1:, None] - window_vals(m, zero))
        nt = _wrap32(t[:, 1:, None] - window_vals(t, zero))
        use = ok & (nt > 0)
        idx = torch.where(use, nt * (nt + 1) // 2 + nm, 0)
        ll = torch.where(use, tbl[idx], 0.0).to(torch.float64)
        C = ll if C is None else C + ll  # dataset 0 seeds the sum, as in JAX
    return C, ok


def dp_exact_ring_plain(C, ok):
    """ks (B, n) int32 of JAX's _dp_exact_batched_ring (and, at B = 1, its
    _dp_exact_body) on float64 costs C (B, n, Wb) and mask ok: a loop over
    the sites on (B, Wb) tensors. M[0] = +0.0; step i takes the first
    maximum (torch.max's index, the first) of M[k] + C[i, v] with the
    masked cells at -inf, below every ok cell's finite sum, and k < 0 reads
    +0.0 and is masked, as in JAX. The step's k = i cell is always ok
    (max_bp >= 0), so a maximum is always an ok cell's."""
    B, n, Wb = C.shape
    dev = C.device
    Cm = C.masked_fill(~ok, NEG)
    Mpad = torch.zeros((B, n + Wb), dtype=torch.float64, device=dev)
    ams = []
    for i in range(n):
        best, am = torch.max(Mpad[:, i:i + Wb] + Cm[:, i], dim=1)
        Mpad[:, Wb + i] = best  # M[i+1]; Mpad[:, Wb-1+k] = M[k]
        ams.append(am)
    ks = torch.stack(ams, dim=1) + (torch.arange(n, device=dev) - (Wb - 1))
    return ks.to(torch.int32)


def segment_exact_dp_plain(pm, pt, loci, tbl, Wb, max_bp):
    """Twin of the kernel in plain PyTorch: exact_cost_plain then
    dp_exact_ring_plain, over slices of windows whose (windows, n, Wb)
    costs stay within TWIN_CELLS (one window at least)."""
    Wb, max_bp = int(Wb), int(max_bp)
    _check(pm, pt, loci, tbl, Wb, max_bp)
    B, _, n1 = pm.shape
    per = max(1, TWIN_CELLS // max((n1 - 1) * Wb, 1))
    out = torch.empty((B, n1 - 1), dtype=torch.int32, device=pm.device)
    for lo in range(0, B, per):
        sl = slice(lo, lo + per)
        C, ok = exact_cost_plain(pm[sl], pt[sl], loci[sl], tbl, Wb, max_bp)
        out[sl] = dp_exact_ring_plain(C, ok)
    return out
