// Hand-written Hopper (sm_90a) kernel for exact segmentation: the band cost
// from the ll table and the float64 ring DP, in one pass
// (wgbs_tools_tpu_torch/ops/segment_exact.py::segment_exact_dp):
//
//   pm, pt  int32 [B][K][n+1]  per window and dataset, the meth and total
//                              prefix sums, wrapped mod 2^32
//   loci    int32 [B][n]       the sites' positions
//   tbl     f32   [size]       ll(nm, nt) at nt * (nt + 1) / 2 + nm, the
//                              host's table (models/segment_exact_device.py::
//                              build_ll_table)
//   ks      int32 [B][n]       out: ks[i] = k, the first site of the last
//                              block of the best segmentation of sites 0..i
//   ring    f64   [B][Wb]      scratch for M where Wb > SMEM_RING, else NULL
//
// Replaces wgbs_tools_tpu/models/segment_exact_tpu.py::_exact_batch_ring_raw
// (:349), that is _exact_cost_body (:168) under vmap followed by
// _dp_exact_batched_ring (:284). The TPU runs those in software doubles
// (ops/softfloat.py) because its f64 is not IEEE; the H100's FP64 is, so each
// add here is one hardware add with the software add's bits.
//
// Per window, with M[0] = +0.0 and, for site i = 0..n-1, the band's cells
// v in [0, Wb), k = i - Wb + 1 + v, ok = k >= 0 && loci[i] - loci[k] <=
// max_bp (no band test where max_bp == 0):
//   nm, nt  = pm[d][i+1] - pm[d][k], pt[d][i+1] - pt[d][k]  (int32, wrapped)
//   ll_d    = nt > 0 ? tbl[nt * (nt + 1) / 2 + nm] : +0.0f, widened exactly
//   C[i][v] = ll_0 + ll_1 + ... + ll_{K-1}, in float64, in dataset order
//   ks[i]   = the k of the first maximum of M[k] + C[i][v] over the ok
//             cells, in ascending k; M[i+1] = that maximum.
// A cell's cost does not depend on M, so it is computed where its step reads
// it: the (B, n, Wb) float64 cost never reaches device memory (~29 GB for a
// genome's 471 windows of 60,000 sites at Wb = 128).
//
// Bound: the chain. Step i + 1 reads M[i + 1], so a window is n dependent
// steps; the operations (~K float64 adds per valid cell) and the bytes (the
// prefix sums, loci and table read once, ks written once) take well under a
// millisecond for a genome on the whole card, while the steps take a table
// read's latency, the adds and a warp reduction each.
//
// Design (right and simple first; computing costs ahead of the chain with
// more warps per window is later work): one warp per window, one window per
// CTA, all windows at once. Lane l owns the cells v = l, l + 32, ..., taken
// CH at a time (CH = 1, 2 or 4 by Wb), and per step loads the loci of its
// cells, then the prefix sums and table entries of its ok cells, DG datasets
// at a time, each group's loads issued before the first is used (the loads
// of a masked cell, or of a dataset past K, are predicated off; an index is
// also clamped to the table). M's last Wb values live in a ring, slot k mod
// Wb: in shared memory up to SMEM_RING values, else in global scratch. Each
// lane keeps its first maximum, a warp butterfly of (value, k) pairs reduces
// them (the larger value wins, the smaller k breaks a tie) into every lane,
// every lane writes M[i + 1] into the ring (so each reads back only its own
// writes, and no barrier orders the steps), and lane 0 writes ks[i].
//
// Exactness:
// - No multiply on the device. The table holds every product, so the kernel
//   does float64 adds (__dadd_rn, which is never contracted), integer index
//   arithmetic and compares only: no FMA can form, no flag is needed, and no
//   log2 runs here (the host's libm chain is in the table).
// - Wraparound. The prefix differences are taken in uint32 and read as
//   int32, as JAX's int32 subtraction wraps (a signed overflow in C++ is UB).
// - The table index nt * (nt + 1) / 2 + nm fits in 32 bits for nt < 65,535;
//   the wrapper refuses a table of more than LL_CAP_MAX (LL_CAP_MAX + 1) / 2
//   entries and the route sizes it so that every in-band index lies in it.
//   The index is also clamped to the table, for memory safety only.
// - Order. JAX takes the first maximum of f64_sort_key over the cells in
//   ascending k, with masked cells keyed 0, below every value. A masked cell
//   here never wins, and on the ok cells the keys order as the doubles do
//   unless a -0.0 or a NaN is among them, and neither can be: every table
//   entry is <= 0 and is +0.0 only where its dataset adds nothing (the table
//   seeds each ll with +0.0, and +0.0 + -0.0 is +0.0), a dataset with
//   nt <= 0 adds +0.0, M[0] is +0.0, and a sum of values <= 0 none of which
//   is -0.0 is never -0.0. The k = i cell is always ok (the wrapper refuses
//   a negative max_bp), so a step always has a maximum.
// - Width. Wb is whatever the caller takes; a ring over SMEM_RING values
//   lives in global memory, so no width raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int DG = 4;                // datasets whose loads fly at once
constexpr int64_t SMEM_RING = 6144;  // M values in shared memory (48 KB)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int32_t wrap_diff(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// (s, k) beats the best so far (bs, bk): the larger sum, or the smaller k on
// a tie; k < 0 is no cell, bk < 0 nothing yet.
__device__ __forceinline__ bool beats(double s, int k, double bs, int bk) {
    return k >= 0 && (bk < 0 || s > bs || (s == bs && k < bk));
}

template <int CH>
__global__ void __launch_bounds__(WARP)
segment_exact_dp_kernel(const int32_t* __restrict__ pm,
                        const int32_t* __restrict__ pt,
                        const int32_t* __restrict__ loci,
                        const float* __restrict__ tbl,
                        int32_t* __restrict__ ks, double* ring_g, int K,
                        int n, int Wb, int max_bp, uint32_t tbl_last) {
    extern __shared__ double ring_s[];
    const int lane = threadIdx.x;
    const size_t w = blockIdx.x;
    const size_t row = (size_t)n + 1;
    const int32_t* pmw = pm + w * K * row;
    const int32_t* ptw = pt + w * K * row;
    const int32_t* lw = loci + w * n;
    int32_t* kw = ks + w * n;
    double* ring = ring_g != nullptr ? ring_g + w * Wb : ring_s;

    for (int s = lane; s < Wb; s += WARP) ring[s] = 0.0;  // M[0] at slot 0
    __syncwarp();

    int slot0 = 1 % Wb;  // the slot of k = i - Wb + 1, that is (i + 1) mod Wb
    for (int i = 0; i < n; ++i) {
        const int32_t li = lw[i];
        double bs = 0.0;
        int bk = -1;
        for (int v0 = lane; v0 < Wb; v0 += WARP * CH) {
            int kk[CH];
            bool ok[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                const int v = v0 + WARP * c;
                const int k = i - Wb + 1 + v;
                kk[c] = k < 0 ? 0 : (v < Wb ? k : i);
                ok[c] = k >= 0 && v < Wb;
            }
            if (max_bp != 0) {
#pragma unroll
                for (int c = 0; c < CH; ++c)
                    ok[c] = ok[c] && wrap_diff(li, lw[kk[c]]) <= max_bp;
            }
            double acc[CH];
            for (int d0 = 0; d0 < K; d0 += DG) {
                float ll[DG][CH];
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    // a dataset past K keeps a valid address, loads nothing
                    const bool has = d0 + g < K;
                    const int d = has ? d0 + g : K - 1;
                    const int32_t* pmd = pmw + d * row;
                    const int32_t* ptd = ptw + d * row;
                    const int32_t mi = pmd[i + 1], ti = ptd[i + 1];
#pragma unroll
                    for (int c = 0; c < CH; ++c) {
                        const bool use = has && ok[c];
                        int32_t nt = 0;
                        uint32_t nm = 0;
                        if (use) {
                            nt = wrap_diff(ti, ptd[kk[c]]);
                            nm = (uint32_t)wrap_diff(mi, pmd[kk[c]]);
                        }
                        uint32_t idx = (uint32_t)nt * ((uint32_t)nt + 1u) / 2u
                                       + nm;
                        idx = idx < tbl_last ? idx : tbl_last;
                        float x = 0.0f;
                        if (use && nt > 0) x = __ldg(tbl + idx);
                        ll[g][c] = x;
                    }
                }
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    if (d0 + g >= K) break;
#pragma unroll
                    for (int c = 0; c < CH; ++c)
                        acc[c] = d0 + g == 0
                                     ? (double)ll[g][c]
                                     : __dadd_rn(acc[c], (double)ll[g][c]);
                }
            }
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                if (!ok[c]) continue;
                const int v = v0 + WARP * c;
                const int slot = slot0 + v < Wb ? slot0 + v : slot0 + v - Wb;
                const double s = __dadd_rn(ring[slot], acc[c]);
                const int k = i - Wb + 1 + v;
                if (beats(s, k, bs, bk)) {
                    bs = s;
                    bk = k;
                }
            }
        }
#pragma unroll
        for (int off = WARP / 2; off > 0; off >>= 1) {
            const double os = __shfl_xor_sync(FULL, bs, off);
            const int ok_ = __shfl_xor_sync(FULL, bk, off);
            if (beats(os, ok_, bs, bk)) {
                bs = os;
                bk = ok_;
            }
        }
        // every lane holds the same (bs, bk) now and writes M[i + 1] itself,
        // into the slot of M[i + 1 - Wb], which only lane 0 (v = 0) read
        // this step (before the butterfly, so before any lane writes): a
        // lane reads back only what it wrote, and the steps need no barrier
        ring[slot0] = bs;
        if (lane == 0) kw[i] = bk;
        slot0 = slot0 + 1 == Wb ? 0 : slot0 + 1;
    }
}

template <int CH>
int launch_dp(const void* pm, const void* pt, const void* loci,
              const void* tbl, void* ks, void* ring, int64_t B, int64_t K,
              int64_t n, int64_t Wb, int64_t max_bp, int64_t tbl_size,
              void* stream) {
    const size_t smem = ring == nullptr ? (size_t)Wb * sizeof(double) : 0;
    segment_exact_dp_kernel<CH><<<(unsigned)B, WARP, smem,
                                  (cudaStream_t)stream>>>(
        (const int32_t*)pm, (const int32_t*)pt, (const int32_t*)loci,
        (const float*)tbl, (int32_t*)ks, (double*)ring, (int)K, (int)n,
        (int)Wb, (int)max_bp, (uint32_t)(tbl_size - 1));
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Arguments outside the kernel's range return cudaErrorInvalidValue (the
// wrapper checks first): B, K or n below 1 (B = 0 launches nothing), Wb
// outside [1, 2^31), max_bp outside [0, 2^31), a table of 0 or 2^32 entries
// or more, a ring missing where Wb > SMEM_RING. Launches on `stream` on the
// current device.
int segment_exact_dp(const void* pm, const void* pt, const void* loci,
                     const void* tbl, void* ks, void* ring, int64_t B,
                     int64_t K, int64_t n, int64_t Wb, int64_t max_bp,
                     int64_t tbl_size, void* stream) {
    if (B < 0 || B > INT32_MAX || K < 1 || K > INT32_MAX || n < 1
        || n >= INT32_MAX || Wb < 1 || Wb > INT32_MAX || max_bp < 0
        || max_bp > INT32_MAX || tbl_size < 1 || tbl_size > UINT32_MAX
        || (ring == nullptr && Wb > SMEM_RING))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    if (Wb <= WARP)
        return launch_dp<1>(pm, pt, loci, tbl, ks, ring, B, K, n, Wb, max_bp,
                            tbl_size, stream);
    if (Wb <= 2 * WARP)
        return launch_dp<2>(pm, pt, loci, tbl, ks, ring, B, K, n, Wb, max_bp,
                            tbl_size, stream);
    return launch_dp<4>(pm, pt, loci, tbl, ks, ring, B, K, n, Wb, max_bp,
                        tbl_size, stream);
}

}  // extern "C"
