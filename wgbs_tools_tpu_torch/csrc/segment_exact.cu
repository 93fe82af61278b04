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
//   ring    f64   [B][Wb]      scratch for M where the single body runs with
//                              Wb > SMEM_RING, else NULL
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
// The (B, n, Wb) float64 cost never reaches device memory (~29 GB for a
// genome's 471 windows of 60,000 sites at Wb = 128).
//
// Bound. The operations (~K float64 adds per valid cell) and the bytes (the
// prefix sums, loci and table read once, ks written once) take ~0.3 ms for a
// genome on the whole card. What paces the kernel is elsewhere: step i + 1
// reads M[i + 1], so a window is n dependent steps (the chain), and each
// valid cell reads K table entries at addresses that depend on the data
// (~63 cells x 3 per step at the CLI's defaults, each its own 32-byte L2
// sector: the table, 2 MB at cap 1024, stays in L2 but is read at random).
// A cell's cost does not depend on M, so only the chain has to wait on M.
// On an H100 (kernel_ab.py, with timing probes built from copies of this
// source that skip parts of the work; PERF.md) the ahead body takes ~615 ns
// a step on a genome's 470 windows, ~360 ns not counting the table
// gathers, which so set the pace there (~145 G lookups/s); on 2 windows
// ~360 ns, of which the chain alone (no hand-off, no cost warps) takes
// ~190 ns.
//
// Two bodies compute the same function; the C entry picks one by Wb alone.
//
// * ahead (lookahead(Wb) >= LOOKAHEAD_MIN, that is Wb <= 1,227; the
//   route's case: Wb is 128 at the CLI's defaults). One CTA per window:
//   warp 0 runs the chain, warps 1..P (the cost warps, P = COST_WARPS)
//   compute C[i][.] for steps ahead of it into a shared ring of L slots of
//   Wb doubles, L = lookahead(Wb) (8 at Wb = 128). Cost warp w takes the
//   steps i = w - 1 (mod P), in order, slot i mod L. For a step it issues
//   all its loads first: the loci of its cells and, for DG datasets at a
//   time, both prefix sums at i + 1 and at each cell (the band test does
//   not gate these loads, so they fly together with the loci's), and then
//   the table entries of the ok cells with nt > 0; so a cost step waits on
//   two rounds of memory, and the P warps of each of the SM's windows keep
//   many gathers in flight. A masked cell's cost is -inf. Each slot has a
//   full and an empty mbarrier of one arrival: every lane of the producing
//   (consuming) warp writes (reads) the slot, __syncwarp orders those
//   accesses before lane 0's arrive, whose release the other side's wait
//   acquires. A cost warp waits only for its slot to be empty (the chain
//   done with step i - L), the chain only for the step it needs. The chain
//   warp's step adds each of its cells' C and M (one __dadd_rn), keeps the
//   lane's first maximum, frees the slot, reduces across the warp, writes
//   M[i + 1] into M's ring (slot k mod Wb, in shared memory; every lane
//   writes it, so each reads back only its own writes) and has lane 0
//   write ks[i]. Where a lane's cells fit its registers (Wb <= 256), the
//   chain reads step i + 1's costs and M values while step i reduces, and
//   the newest cell (k = i + 1) takes M[i + 1] from the reduction's
//   register (on an H100, 1.17x faster on the 470 windows than reading
//   them as the step starts, which wider bands do). The cross-lane step is
//   __reduce_min_sync on a key (below), in place of a 5-round butterfly of
//   (double, int) pairs.
//   CTA: 32 (1 + P) threads, at most SMEM_BUDGET bytes of shared memory and
//   built for MIN_CTAS CTAs per SM (__launch_bounds__), so 528 windows run
//   in one wave on 132 SMs. On an H100, 3 cost warps beat 2 and 5 on the
//   470 windows, 8 slots beat 16, and the key reduction a butterfly.
// * single (Wb >= 1,228, where L would fall below LOOKAHEAD_MIN): the
//   kernel's first body, kept as it was. One warp per window computes each
//   step's costs where it reads them: lane l owns the cells v = l, l + 32,
//   ..., CH at a time (CH = 1, 2 or 4 by Wb), loads their loci, then the
//   prefix sums and table entries of its ok cells, DG datasets at a time;
//   M's ring is in shared memory up to SMEM_RING values, else in global
//   scratch; a warp butterfly of (value, k) pairs reduces the lanes' first
//   maxima.
//
// Exactness:
// - No multiply on the device. The table holds every product, so the kernel
//   does float64 adds (__dadd_rn, which is never contracted), integer index
//   arithmetic and compares only: no FMA can form, no flag is needed, and no
//   log2 runs here (the host's libm chain is in the table). The dataset sum
//   is acc = ll_0, then one __dadd_rn per further dataset, in dataset order,
//   in both bodies.
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
//   entry is finite and <= 0 and is +0.0 only where its dataset adds nothing
//   (the table seeds each ll with +0.0, and +0.0 + -0.0 is +0.0), a dataset
//   with nt <= 0 adds +0.0, M[0] is +0.0, and a sum of values <= 0 none of
//   which is -0.0 is never -0.0. The k = i cell is always ok (the wrapper
//   refuses a negative max_bp), so a step always has a finite maximum.
// - The ahead body's key. For doubles <= 0 that are not -0.0 or NaN, the
//   larger double has the smaller IEEE bit pattern read as uint64 (+0.0 is
//   0; a negative double's pattern grows with its magnitude). A masked cell
//   sums to -inf (-inf + a finite M), whose pattern 0xfff0... lies above
//   every finite one, and a lane without a cell keeps all ones; neither can
//   be the minimum, since the k = i cell is finite. So the first maximum is
//   the smallest (key, v): the lane keeps its first strict minimum over its
//   cells in ascending v, and the warp takes the least high half, then the
//   least low half among the lanes with that high half, then the least v
//   among the lanes with that key.
// - Width. Wb is whatever the caller takes; a single-body ring over
//   SMEM_RING values lives in global memory, so no width raises.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARP = 32;
constexpr int DG = 4;                // datasets whose loads fly at once
constexpr int64_t SMEM_RING = 6144;  // single body: M values in shared memory
constexpr unsigned FULL = 0xffffffffu;

// the ahead body
constexpr int COST_WARPS = 3;        // cost warps beside the chain warp
constexpr int AHEAD_THREADS = WARP * (1 + COST_WARPS);
constexpr int MIN_CTAS = 4;          // CTAs per SM it is built for
constexpr int CG = 4;                // a cost lane's cells a pass
constexpr int64_t LOOKAHEAD_MIN = 4;
constexpr int64_t LOOKAHEAD_MAX = 8;
constexpr int64_t SMEM_BUDGET = 48 * 1024;  // bytes of shared memory a CTA
constexpr int64_t SLOT_BARRIERS = 2 * sizeof(uint64_t);  // full, empty

// The ahead body's ring depth for Wb: the most slots (up to LOOKAHEAD_MAX)
// whose barriers, costs and M's ring fit SMEM_BUDGET; below LOOKAHEAD_MIN
// the single body runs.
int64_t lookahead(int64_t Wb) {
    const int64_t row = Wb * (int64_t)sizeof(double);
    if (row >= SMEM_BUDGET) return 0;
    const int64_t L = (SMEM_BUDGET - row) / (row + SLOT_BARRIERS);
    return L < LOOKAHEAD_MAX ? L : LOOKAHEAD_MAX;
}

size_t ahead_smem(int64_t Wb, int64_t L) {
    return (size_t)(L * SLOT_BARRIERS
                    + (L + 1) * Wb * (int64_t)sizeof(double));
}

__device__ __forceinline__ int32_t wrap_diff(int32_t a, int32_t b) {
    return (int32_t)((uint32_t)a - (uint32_t)b);
}

// (s, k) beats the best so far (bs, bk): the larger sum, or the smaller k on
// a tie; k < 0 is no cell, bk < 0 nothing yet.
__device__ __forceinline__ bool beats(double s, int k, double bs, int bk) {
    return k >= 0 && (bk < 0 || s > bs || (s == bs && k < bk));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                 :: "r"(smem_addr(bar)) : "memory");
}

// Returns once the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
    uint32_t done;
    do {
        asm volatile("{\n"
                     ".reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n"
                     "}\n"
                     : "=r"(done) : "r"(smem_addr(bar)), "r"(parity)
                     : "memory");
    } while (!done);
}

// The hand-off of the ahead body's cost slots, in SLOT_BARRIERS bytes a
// slot: step i lives in slot i mod L, in its round i / L. A full and an
// empty mbarrier of one arrival per slot: the side that writes (reads) a
// slot has every lane access it, then __syncwarp orders those accesses
// before lane 0's arrive, whose release the other side's wait acquires.
struct Ring {
    uint64_t* bars;  // full [L], empty [L]
    int L;

    __device__ uint64_t* full() const { return bars; }
    __device__ uint64_t* empty() const { return bars + L; }
    __device__ void init() const {
        for (int s = 0; s < L; ++s) {
            bar_init(full() + s, 1);
            bar_init(empty() + s, 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the slot's step of this round is in it
    __device__ void chain_wait(int slot, int round) const {
        bar_wait(full() + slot, (uint32_t)round & 1u);
    }
    // the chain is done with the slot's step
    __device__ void chain_release(int slot, int lane) const {
        __syncwarp();
        if (lane == 0) bar_arrive(empty() + slot);
    }
    // the slot is free: its step of the last round has left the chain (no
    // wait in the first round: the slots start empty)
    __device__ void cost_wait(int slot, int round) const {
        if (round > 0) bar_wait(empty() + slot, (uint32_t)(round - 1) & 1u);
    }
    // the slot's step is written
    __device__ void cost_publish(int slot, int lane) const {
        __syncwarp();
        if (lane == 0) bar_arrive(full() + slot);
    }
};

// ---------------------------------------------------------------------------
// the single body
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// the ahead body
// ---------------------------------------------------------------------------

// Cost warp w (0..COST_WARPS-1): C[i][.] for i = w, w + COST_WARPS, ...
// into slot i mod L, -inf on the masked cells.
__device__ __forceinline__ void cost_steps(
    const int32_t* __restrict__ pmw, const int32_t* __restrict__ ptw,
    const int32_t* __restrict__ lw, const float* __restrict__ tbl,
    double* Cring, Ring ring, int K, int n, int Wb, int L, int max_bp,
    uint32_t tbl_last, size_t row, int w, int lane) {
    int slot = w % L, round = w / L;
    for (int i = w; i < n; i += COST_WARPS) {
        ring.cost_wait(slot, round);
        double* C = Cring + (size_t)slot * Wb;
        const int32_t li = max_bp != 0 ? __ldg(lw + i) : 0;
        for (int v0 = lane; v0 < Wb; v0 += WARP * CG) {
            int kk[CG];
            bool ok[CG];
#pragma unroll
            for (int c = 0; c < CG; ++c) {
                const int v = v0 + WARP * c;
                const int k = i - Wb + 1 + v;
                ok[c] = k >= 0 && v < Wb;
                kk[c] = ok[c] ? k : i;  // a valid address either way
            }
            int32_t lk[CG];
            if (max_bp != 0) {
#pragma unroll
                for (int c = 0; c < CG; ++c) lk[c] = __ldg(lw + kk[c]);
            }
            double acc[CG];
            for (int d0 = 0; d0 < K; d0 += DG) {
                // every prefix load of the group before any use; a dataset
                // past K reads dataset K - 1 and is not used
                int32_t mi[DG], ti[DG], mk[DG][CG], tk[DG][CG];
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    const int d = d0 + g < K ? d0 + g : K - 1;
                    const int32_t* pmd = pmw + d * row;
                    const int32_t* ptd = ptw + d * row;
                    mi[g] = __ldg(pmd + i + 1);
                    ti[g] = __ldg(ptd + i + 1);
#pragma unroll
                    for (int c = 0; c < CG; ++c) {
                        mk[g][c] = __ldg(pmd + kk[c]);
                        tk[g][c] = __ldg(ptd + kk[c]);
                    }
                }
                if (d0 == 0 && max_bp != 0) {
#pragma unroll
                    for (int c = 0; c < CG; ++c)
                        ok[c] = ok[c] && wrap_diff(li, lk[c]) <= max_bp;
                }
                float x[DG][CG];
#pragma unroll
                for (int g = 0; g < DG; ++g) {
#pragma unroll
                    for (int c = 0; c < CG; ++c) {
                        const int32_t nt = wrap_diff(ti[g], tk[g][c]);
                        const uint32_t nm = (uint32_t)wrap_diff(mi[g],
                                                                mk[g][c]);
                        uint32_t idx = (uint32_t)nt * ((uint32_t)nt + 1u) / 2u
                                       + nm;
                        idx = idx < tbl_last ? idx : tbl_last;
                        float y = 0.0f;
                        if (d0 + g < K && ok[c] && nt > 0)
                            y = __ldg(tbl + idx);
                        x[g][c] = y;
                    }
                }
#pragma unroll
                for (int g = 0; g < DG; ++g) {
                    if (d0 + g >= K) break;
#pragma unroll
                    for (int c = 0; c < CG; ++c)
                        acc[c] = d0 + g == 0
                                     ? (double)x[g][c]
                                     : __dadd_rn(acc[c], (double)x[g][c]);
                }
            }
#pragma unroll
            for (int c = 0; c < CG; ++c) {
                const int v = v0 + WARP * c;
                if (v < Wb) C[v] = ok[c] ? acc[c] : -CUDART_INF;
            }
        }
        ring.cost_publish(slot, lane);
        for (slot += COST_WARPS; slot >= L; slot -= L) ++round;
    }
}

// The warp's first maximum of the lanes' (bkey, bv) (see Exactness): M, the
// maximum (M[i + 1]), and cand, the lane's bv where its key is the
// maximum's, else ~0; finish_v(cand) is the maximum's v, on every lane.
struct Best {
    double M;
    uint32_t cand;
};

__device__ __forceinline__ Best reduce_best(uint64_t bkey, uint32_t bv) {
    const uint32_t hi = (uint32_t)(bkey >> 32), lo = (uint32_t)bkey;
    const uint32_t mh = __reduce_min_sync(FULL, hi);
    const uint32_t ml = __reduce_min_sync(FULL, hi == mh ? lo : ~0u);
    const double M = __longlong_as_double((long long)((uint64_t)mh << 32
                                                      | ml));
    return {M, hi == mh && lo == ml ? bv : ~0u};
}

__device__ __forceinline__ uint32_t finish_v(uint32_t cand) {
    return __reduce_min_sync(FULL, cand);
}

__device__ __forceinline__ int ring_slot(int slot0, int v, int Wb) {
    return slot0 + v < Wb ? slot0 + v : slot0 + v - Wb;
}

// The chain warp where a lane's CH cells fit its registers (Wb <= 32 CH):
// step i + 1's costs and M values (all but M[i + 1], which the newest cell,
// v = Wb - 1, takes from the reduction's register) are read while step i
// reduces, so a step's critical path is one add, the lane's compares and
// two reductions.
template <int CH>
__device__ __forceinline__ void chain_steps_reg(const double* Cring,
                                                double* M, Ring ring,
                                                int32_t* __restrict__ kw,
                                                int n, int Wb, int L,
                                                int lane) {
    for (int s = lane; s < Wb; s += WARP) M[s] = 0.0;  // M[0] at slot 0
    __syncwarp();
    const bool newest_lane = lane == (Wb - 1) % WARP;
    const int newest_c = (Wb - 1) / WARP;
    int slot0 = 1 % Wb;  // M's slot of k = i - Wb + 1, that is (i + 1) mod Wb
    int cs = 0;          // the cost slot of step i, i mod L
    int round = 0;       // i / L
    double Cc[CH], Mc[CH];
    ring.chain_wait(0, 0);
#pragma unroll
    for (int c = 0; c < CH; ++c) {
        const int v = lane + WARP * c;
        Cc[c] = v < Wb ? Cring[v] : 0.0;
        Mc[c] = 0.0;
    }
    double Mi = 0.0;  // M[i]
    for (int i = 0; i < n; ++i) {
        // the lane's first minimum (key, v): a tree over its cells, the
        // lower v kept on a tie
        uint64_t key[CH];
        uint32_t kv[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            const int v = lane + WARP * c;
            const double m = newest_lane && c == newest_c ? Mi : Mc[c];
            key[c] = v < Wb ? (uint64_t)__double_as_longlong(
                                  __dadd_rn(m, Cc[c]))
                            : ~0ull;
            kv[c] = (uint32_t)v;
        }
#pragma unroll
        for (int s = 1; s < CH; s *= 2) {
#pragma unroll
            for (int c = 0; c + s < CH; c += 2 * s) {
                if (key[c + s] < key[c]) {
                    key[c] = key[c + s];
                    kv[c] = kv[c + s];
                }
            }
        }
        uint64_t bkey = key[0];
        uint32_t bv = kv[0];
        ring.chain_release(cs, lane);
        const int slot1 = slot0 + 1 == Wb ? 0 : slot0 + 1;
        if (++cs == L) {
            cs = 0;
            ++round;
        }
        if (i + 1 < n) {
            // step i + 1's cell v reads M[i + 2 - Wb + v]: written by an
            // earlier step for v < Wb - 1 (the newest's read is not used)
            ring.chain_wait(cs, round);
            const double* C = Cring + (size_t)cs * Wb;
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                // a cell past Wb reads cell Wb - 1 (unused): no branch
                const int v = min(lane + WARP * c, Wb - 1);
                Cc[c] = C[v];
                Mc[c] = M[ring_slot(slot1, v, Wb)];
            }
        }
        const Best b = reduce_best(bkey, bv);
        Mi = b.M;
        // every lane writes M[i + 1] (slot0, the slot of M[i + 1 - Wb], read
        // by no later step): a lane reads back only what it wrote
        M[slot0] = Mi;
        const uint32_t v = finish_v(b.cand);
        if (lane == 0) kw[i] = i - Wb + 1 + (int)v;
        slot0 = slot1;
    }
}

// The chain warp for wider bands: each step reads its cells' C and M from
// shared memory, CH per lane at a time.
template <int CH>
__device__ __forceinline__ void chain_steps_loop(const double* Cring,
                                                 double* M, Ring ring,
                                                 int32_t* __restrict__ kw,
                                                 int n, int Wb, int L,
                                                 int lane) {
    for (int s = lane; s < Wb; s += WARP) M[s] = 0.0;  // M[0] at slot 0
    __syncwarp();
    int slot0 = 1 % Wb;
    int cs = 0, round = 0;
    for (int i = 0; i < n; ++i) {
        ring.chain_wait(cs, round);
        const double* C = Cring + (size_t)cs * Wb;
        uint64_t bkey = ~0ull;
        uint32_t bv = ~0u;
        for (int v0 = lane; v0 < Wb; v0 += WARP * CH) {
            uint64_t key[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                const int v = v0 + WARP * c;
                key[c] = v < Wb ? (uint64_t)__double_as_longlong(__dadd_rn(
                                      M[ring_slot(slot0, v, Wb)], C[v]))
                                : ~0ull;
            }
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                if (key[c] < bkey) {
                    bkey = key[c];
                    bv = (uint32_t)(v0 + WARP * c);
                }
            }
        }
        ring.chain_release(cs, lane);
        const Best b = reduce_best(bkey, bv);
        // M[i + 1] into the slot of M[i + 1 - Wb], which only lane 0 (v = 0)
        // read this step, before the reduction
        M[slot0] = b.M;
        const uint32_t v = finish_v(b.cand);
        if (lane == 0) kw[i] = i - Wb + 1 + (int)v;
        slot0 = slot0 + 1 == Wb ? 0 : slot0 + 1;
        if (++cs == L) {
            cs = 0;
            ++round;
        }
    }
}

// CH: a chain lane's cells, all in registers (1, 2, 4, 8), or 0, the loop
// form for Wb > 8 x 32.
template <int CH>
__global__ void __launch_bounds__(AHEAD_THREADS, MIN_CTAS)
segment_exact_dp_ahead_kernel(const int32_t* __restrict__ pm,
                              const int32_t* __restrict__ pt,
                              const int32_t* __restrict__ loci,
                              const float* __restrict__ tbl,
                              int32_t* __restrict__ ks, int K, int n, int Wb,
                              int L, int max_bp, uint32_t tbl_last) {
    // the hand-off [L], M's ring [Wb], the costs [L][Wb]
    extern __shared__ uint64_t smem_u64[];
    const Ring ring{smem_u64, L};
    double* M = reinterpret_cast<double*>(smem_u64 + 2 * L);
    double* Cring = M + Wb;
    const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
    const size_t w = blockIdx.x;
    const size_t row = (size_t)n + 1;

    if (threadIdx.x == 0) ring.init();
    __syncthreads();
    if (warp == 0) {
        if constexpr (CH > 0)
            chain_steps_reg<CH>(Cring, M, ring, ks + w * n, n, Wb, L, lane);
        else
            chain_steps_loop<4>(Cring, M, ring, ks + w * n, n, Wb, L, lane);
    } else {
        cost_steps(pm + w * K * row, pt + w * K * row, loci + w * n, tbl,
                   Cring, ring, K, n, Wb, L, max_bp, tbl_last, row, warp - 1,
                   lane);
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

template <int CH>
int launch_ahead(const void* pm, const void* pt, const void* loci,
                 const void* tbl, void* ks, int64_t B, int64_t K, int64_t n,
                 int64_t Wb, int64_t max_bp, int64_t tbl_size, void* stream) {
    const int64_t L = lookahead(Wb);
    segment_exact_dp_ahead_kernel<CH><<<(unsigned)B, AHEAD_THREADS,
                                        ahead_smem(Wb, L),
                                        (cudaStream_t)stream>>>(
        (const int32_t*)pm, (const int32_t*)pt, (const int32_t*)loci,
        (const float*)tbl, (int32_t*)ks, (int)K, (int)n, (int)Wb, (int)L,
        (int)max_bp, (uint32_t)(tbl_size - 1));
    return (int)cudaGetLastError();
}

// CH by Wb: the single body's cells a lane takes per pass
template <typename F>
int by_width(int64_t Wb, F f) {
    if (Wb <= WARP) return f(std::integral_constant<int, 1>());
    if (Wb <= 2 * WARP) return f(std::integral_constant<int, 2>());
    return f(std::integral_constant<int, 4>());
}

// CH by Wb: the ahead body's chain cells a lane keeps in registers, 0 for
// the loop form
template <typename F>
int by_width_ahead(int64_t Wb, F f) {
    if (Wb <= 4 * WARP) return by_width(Wb, f);
    if (Wb <= 8 * WARP) return f(std::integral_constant<int, 8>());
    return f(std::integral_constant<int, 0>());
}

}  // namespace

extern "C" {

// Arguments outside the kernel's range return cudaErrorInvalidValue (the
// wrapper checks first): B, K or n below 1 (B = 0 launches nothing), Wb
// outside [1, 2^31), max_bp outside [0, 2^31), a table of 0 or 2^32 entries
// or more, a ring missing where Wb > SMEM_RING. The body is chosen by Wb
// alone: ahead where lookahead(Wb) >= LOOKAHEAD_MIN, else single (which
// needs `ring` above SMEM_RING; the ahead body ignores it). Launches on
// `stream` on the current device.
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
    if (lookahead(Wb) >= LOOKAHEAD_MIN)
        return by_width_ahead(Wb, [&](auto ch) {
            return launch_ahead<decltype(ch)::value>(
                pm, pt, loci, tbl, ks, B, K, n, Wb, max_bp, tbl_size, stream);
        });
    return by_width(Wb, [&](auto ch) {
        return launch_dp<decltype(ch)::value>(pm, pt, loci, tbl, ks, ring, B,
                                              K, n, Wb, max_bp, tbl_size,
                                              stream);
    });
}

// The launch segment_exact_dp makes for band width Wb, and the CTAs per SM
// that cudaOccupancyMaxActiveBlocksPerMultiprocessor gives it on the current
// device: out = {ahead (1) or single (0), threads per CTA, dynamic shared
// bytes, lookahead L (0 for single), CTAs per SM}. The single body is asked
// with its ring in shared memory up to SMEM_RING, in global memory above.
int segment_exact_dp_occupancy(int64_t Wb, int64_t* out) {
    if (Wb < 1 || Wb > INT32_MAX) return (int)cudaErrorInvalidValue;
    const int64_t L = lookahead(Wb);
    const bool ahead = L >= LOOKAHEAD_MIN;
    const int threads = ahead ? AHEAD_THREADS : WARP;
    const size_t smem = ahead ? ahead_smem(Wb, L)
                              : (Wb <= SMEM_RING ? (size_t)Wb * sizeof(double)
                                                 : 0);
    int blocks = 0;
    const int err =
        ahead ? by_width_ahead(Wb, [&](auto ch) {
                    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks,
                        segment_exact_dp_ahead_kernel<decltype(ch)::value>,
                        threads, smem);
                })
              : by_width(Wb, [&](auto ch) {
                    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &blocks, segment_exact_dp_kernel<decltype(ch)::value>,
                        threads, smem);
                });
    out[0] = ahead;
    out[1] = threads;
    out[2] = (int64_t)smem;
    out[3] = ahead ? L : 0;
    out[4] = blocks;
    return err;
}

}  // extern "C"
