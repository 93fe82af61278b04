// Hand-written Hopper (sm_90a) kernels for the serial segmentation DP of the
// fused analysis step (wgbs_tools_tpu_torch/ops/dp_scan.py::dp_scan):
//
//   C       f32 [nb][n][W]  cost rows in ascending-k order, one chain per b:
//                           C[b][i][k] = cost(i - (W-1) + k, i), -inf where
//                           invalid or too long
//   ks      i32 [nb][n]     ks[b][i] = i - (W-1) + am, am the FIRST maximum
//                           of cand[k] = M[i+1+k] + C[b][i][k] over k in
//                           [0, W)
//   scratch f32 [nb][...]   dp_scan_plan's floats per chain: the push body's
//                           M (n + W + 1, and 32 past it that the last
//                           round writes), the warp body's global ring (W)
//
// M has n + W + 1 slots per chain: M[W] = 0, the rest -inf, and step i
// writes M[W+i+1] = cand[am]. Replaces wgbs_tools_tpu/parallel/sharded.py::
// _dp_scan (:105-122), a lax.scan with one dependent step per CpG site
// inside the analysis step's shard_map.
//
// Bound: the chain. Step i's candidate k reads M[i+1+k], which step
// i + k - W wrote; only k = W-1 reads the value of the step just before. So
// n steps run one after another whatever the card's width, and the least a
// step can take is one add and one compare-select on the newest M (~8
// cycles: chip_smoke.CHAIN_CYCLES); the other W - 1 candidates of a step
// are known one or more steps earlier. The data, nb * n * (W + 1) * 4 B, is
// read and written once (a few ms at 3.35 TB/s for a 14 M-site shard at
// W 64).
//
// Three bodies compute the same function; the C entry picks one by W alone
// (dp_scan_plan reports it):
//
// * push (W <= PUSH_W_MAX; the analysis step's W is 64). One CTA of two
//   warps per chain.
//   - The chain. Every lane of warp 0 holds M_{i-1} (the newest M) in a
//     register and computes M_i = max(R_i, M_{i-1} + C[i][W-1]): one add
//     and one max. R_i, step i's other candidates folded together, is
//     ready before M_{i-1} is, so nothing else is on the dependent path: no
//     warp reduction, no shared-memory round trip, no __syncwarp.
//   - The folds, off the chain. Each new M is added into the W - 1 later
//     steps that read it (a push). The D - 1 newest pushes of a step (k =
//     W-D .. W-2) are done in every lane on registers (the chain side);
//     the older ones (k <= W-1-D) by the lane that owns the step: lane l
//     owns the steps s with s - D = l (mod 32), and Q registers hold the
//     steps whose last lane push falls in this round of 32 steps or the Q -
//     1 after it (slot q: s = 32 (r + q) + l + D). After its last lane push
//     (k = W-1-D) a step's value is broadcast (__shfl_sync) from its lane
//     to the chain side, which has D - 1 steps to take it in: the shuffle's
//     latency is off the chain. Slots rotate once a round, and a slot folds
//     only from its step's k = 0 on (a predicate); after the hand-off its
//     value is no longer read; slots q <= Q - 3 have k >= 0 throughout
//     and fold without the predicate. D - 1 = 2 steps cover the shuffle's
//     latency; widths W <= D put every candidate on the chain side.
//   - Why lanes of the chain warp do the older pushes, and not push warps
//     handing values over through shared memory and mbarriers (as the
//     exact segmentation kernel's cost warps do): such a hand-off takes
//     hundreds of cycles, so D would have to reach tens of steps, and the
//     chain side costs ~3 instructions a step for each; a shuffle takes
//     tens of cycles, which D = 3 covers.
//   - Width: the ring holds S = (W + 30) / 32 + 1 + PREFETCH stages of 32
//     rows (~150 KB of shared memory at W = PUSH_W_MAX = 128) and a lane Q
//     = 1 + (W + 27) / 32 slots (5 at 128); the analysis step's W is 64.
//     Wider widths take the warp bodies, whose step costs ~W / 32 loads,
//     adds and key compares a lane anyway.
//   - What paces it on an H100 (PERF.md): not the add and max of the
//     chain but the warp's other dependent work a step (~25 instructions:
//     the Q lane folds, the chain side's 3 adds and 3 maxima, the
//     shuffle) and the round's own (the stage wait, the diagonal, the
//     slot rotation).
//   - The maximum is max.NaN.f32 on values: NaN if either is NaN, else the
//     larger, so its key (the order below, chip_smoke's and the tests'
//     order_key) is the largest key of its operands, in any order. So M_i
//     is the first maximum's value up to the sign of a zero and a NaN's
//     payload, which no later comparison sees: a later candidate's key is
//     the same. The folds carry no k.
//   - ks leave the chain: lane 0 stores each step's M straight into
//     `scratch` (a select into a register, or a shared store, costs more
//     there), and a second kernel (dp_scan_argmax_kernel, one warp per 32
//     steps, the whole card) takes am = the first k whose candidate
//     M[i+1+k] + C[i][k], the same add on the same operands, has the key
//     of M[W+i+1]: equal (== treats -0.0 as +0.0), or both NaN. That is
//     jnp.argmax's first maximum, NaN first, and an all -inf row's am 0.
//   - Cost rows reach shared memory without the chain's instructions: lane
//     0 of warp 1 issues one TMA bulk copy (cp.async.bulk, an mbarrier per
//     stage) per 32 rows into a ring of S stages, PREFETCH stages ahead of
//     the ones a round reads; the chain warp frees a stage (an arrive on
//     its empty barrier) once its round is done. A copy starts at the
//     chain's 16-byte boundary below its first row; the rows sit delta
//     floats into each stage (delta = the chain's offset mod 16 bytes).
//     Each round (32 steps) the lanes stage the next round's chain-side
//     costs in a small diagonal buffer (a broadcast load a step), so no
//     shared store or wait precedes a round's steps. A lane's slot reads
//     C[s][k] along an
//     anti-diagonal: stride W - 1 floats across lanes, conflict-free for
//     even W, gcd(W-1, 32)-way for odd W (32-way at W 33 and 65).
//   - Initial slots: candidates that read M[0..W-1] (-inf) are folded as
//     real candidates into each step's slot before the loop (-inf + +inf
//     is NaN), M[W] = 0 is M_{-1}.
// * warp (PUSH_W_MAX < W <= SMEM_W_MAX): the first body of this kernel,
//   kept as it was. One warp per chain; lane l takes the candidates k = l,
//   l + 32, ... of each step; M is a ring of W floats in shared memory, the
//   cost rows come in double-buffered cp.async tiles, and two warp
//   reductions (redux.sync on order_key, then the smallest k) give the
//   first maximum every step.
// * warp global (W > SMEM_W_MAX): the same with the ring in `scratch` and
//   the rows read from global memory.
//
// Exactness: each candidate is one IEEE f32 add of the same two operands as
// the plain version's (__fadd_rn, no multiply, no fast-math flags), and the
// maxima and comparisons are exact, so ks equal the plain version's and
// JAX's bit for bit, ties to the smaller k, an all -inf row to am = 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// the warp body
constexpr int SMEM_W_MAX = 4096;     // the widest W with the ring in shared
constexpr int TILE_FLOATS = 8192;    // cost floats per tile buffer (32 KB)
constexpr int MAX_TILE_ROWS = 64;

// the push body
constexpr int PUSH_W_MAX = 128;      // the widest W it takes
constexpr int ROWS = 32;             // cost rows a stage holds: one round
constexpr int PREFETCH = 4;          // stages in flight beyond a round's
constexpr int STAGE_PAD = 32;        // floats after a stage's rows
constexpr int ARGMAX_THREADS = 256;

// Order-preserving key: a < b as floats <=> key(a) < key(b), -0.0 and +0.0
// one key, NaN above +inf. Every key is at least key(-inf) = 0x007FFFFF.
__device__ __forceinline__ unsigned order_key(float v) {
    if (v != v) return FULL;
    unsigned u = __float_as_uint(v);
    if ((u << 1) == 0u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

// One step of the chain: reads the ring and `crow` (the step's W costs),
// writes M[W+i+1] and keeps ks[i]. `base` is (i + 1) % W.
__device__ __forceinline__ void dp_step(float* ring, const float* crow,
                                        int W, int base, int64_t i,
                                        int64_t n, int* kb, int lane,
                                        int& mine) {
    unsigned bkey = 0u, bidx = FULL;
    for (int k = lane; k < W; k += WARP) {
        int s = base + k;
        if (s >= W) s -= W;
        const unsigned key = order_key(ring[s] + crow[k]);
        if (key > bkey) {  // strict: the first k of a lane's equal keys
            bkey = key;
            bidx = (unsigned)k;
        }
    }
    const unsigned kmax = __reduce_max_sync(FULL, bkey);
    const unsigned am = __reduce_min_sync(FULL, bkey == kmax ? bidx : FULL);
    if (lane == 0) ring[base] = key_value(kmax);
    const int r = (int)(i & (WARP - 1));
    if (lane == r) mine = (int)(i - (W - 1) + (int64_t)am);
    if ((r == WARP - 1 || i == n - 1) && lane <= r) kb[i - r + lane] = mine;
    __syncwarp();
}

template <bool SMEM>
__global__ void __launch_bounds__(WARP)
    dp_scan_kernel(const float* __restrict__ C, int* __restrict__ ks,
                   float* __restrict__ gring, int64_t n, int W, int rows) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x;
    const int64_t b = blockIdx.x;
    const float* Cb = C + b * n * (int64_t)W;
    int* kb = ks + b * n;
    float* ring = SMEM ? smem + 2 * (size_t)rows * W : gring + b * W;
    // M[1 .. W-1] = -inf, M[W] = 0 at slot 0
    for (int s = lane; s < W; s += WARP) ring[s] = s ? -CUDART_INF_F : 0.0f;
    __syncwarp();
    int base = W > 1 ? 1 : 0;
    int mine = 0;

    if (!SMEM) {
        for (int64_t i = 0; i < n; ++i) {
            dp_step(ring, Cb + i * W, W, base, i, n, kb, lane, mine);
            if (++base == W) base = 0;
        }
        return;
    }

    const int64_t n_tiles = (n + rows - 1) / rows;
    const size_t tile_floats = (size_t)rows * W;
    auto issue = [&](int64_t t) {
        float* dst = smem + (t & 1) * tile_floats;
        const int64_t r0 = t * rows;
        const int cnt = (int)((n - r0 < rows ? n - r0 : rows) * W);
        const float* src = Cb + r0 * W;
        for (int e = lane; e < cnt; e += WARP)
            __pipeline_memcpy_async(dst + e, src + e, sizeof(float));
        __pipeline_commit();
    };
    issue(0);
    for (int64_t t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            // the buffer it fills was last read in tile t - 1, before the
            // __syncwarp that ended it
            issue(t + 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncwarp();  // every lane's copies of tile t are visible
        const float* tile = smem + (t & 1) * tile_floats;
        const int64_t r0 = t * rows;
        const int nr = (int)(n - r0 < rows ? n - r0 : rows);
        for (int r = 0; r < nr; ++r) {
            dp_step(ring, tile + (size_t)r * W, W, base, r0 + r, n, kb, lane,
                    mine);
            if (++base == W) base = 0;
        }
    }
}

// ---------------------------------------------------------------------------
// the push body
// ---------------------------------------------------------------------------

// NaN if either is NaN, else the larger: its key is the larger key.
__device__ __forceinline__ float max_nan(float a, float b) {
    float r;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
    return r;
}

// x = max_nan(x, term) where t >= e (a lane slot's k >= 0 at step t of the
// round), as one compare and one predicated max.
__device__ __forceinline__ void fold_from(float& x, float term, int e,
                                          int t) {
    asm("{\n"
        ".reg .pred p;\n"
        "setp.le.s32 p, %2, %3;\n"
        "@p max.NaN.f32 %0, %0, %1;\n"
        "}\n"
        : "+f"(x) : "f"(term), "r"(e), "r"(t));
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

__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
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

// TMA: `bytes` (a multiple of 16) from global `src` to shared `dst` (both
// 16-byte aligned), completing on `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::"
                 "complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                    "r"(smem_addr(bar))
                 : "memory");
}

// The push body's lane slots for width W (D = 3): the steps whose last lane
// push falls in this round or the Q - 1 after it.
constexpr int push_slots(int W) { return W <= 3 ? 0 : 1 + (W + 27) / 32; }

struct PushGeometry {
    int64_t S;       // stages in the ring
    int64_t stage;   // floats a stage takes
    size_t smem;     // dynamic shared bytes
};

// F: the stages past a round's own that it reads (rows up to 32 r + 30 + W)
PushGeometry push_geometry(int64_t W) {
    const int64_t F = (W + 30) / ROWS;
    PushGeometry g;
    g.S = F + 1 + PREFETCH;
    g.stage = ROWS * W + STAGE_PAD;
    // barriers (full, empty), the diagonal buffer (2 x 3 x 32 floats:
    // costs of the chain side), the initial values (PUSH_W_MAX), then the
    // ring (16-byte aligned)
    g.smem = (size_t)(2 * g.S * sizeof(uint64_t)
                      + (6 * WARP + PUSH_W_MAX) * sizeof(float)
                      + g.S * g.stage * sizeof(float));
    return g;
}

// One CTA of 2 warps per chain: warp 0 runs the chain and the folds (D
// candidates on the chain side, Q lane slots), lane 0 of warp 1 copies.
// Writes M[b][0 .. n + W] into Mg; dp_scan_argmax_kernel makes ks from it.
template <int D, int Q>
__global__ void __launch_bounds__(2 * WARP)
    dp_scan_push_kernel(const float* __restrict__ C, float* __restrict__ Mg,
                        int64_t n, int W, int S, int stage) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw);
    uint64_t* empty = full + S;
    float* diag = reinterpret_cast<float*>(empty + S);  // [2][3][32]
    float* pre = diag + 6 * WARP;                       // [PUSH_W_MAX]
    float* ring = pre + PUSH_W_MAX;                     // [S][stage]
    const int lane = threadIdx.x & (WARP - 1);
    const int64_t b = blockIdx.x;
    const float* Cb = C + b * n * (int64_t)W;
    float* Mb = Mg + b * (n + W + 1 + ROWS);
    const int64_t n_stages = (n + ROWS - 1) / ROWS;
    // the copies start at the 16-byte boundary at or below the chain's row 0
    const uintptr_t c0 = reinterpret_cast<uintptr_t>(Cb);
    const int delta = (int)((c0 & 15u) / sizeof(float));
    const char* src0 = reinterpret_cast<const char*>(c0 & ~(uintptr_t)15);

    if (threadIdx.x == 0) {
        for (int s = 0; s < S; ++s) {
            bar_init(full + s, 1);
            bar_init(empty + s, 1);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    // stage m lives in ring slot m % S; the indices below count slots and
    // phases as they go (a 64-bit modulo is a long software routine)
    auto next_slot = [&](int slot, int by) {  // by < S
        slot += by;
        return slot >= S ? slot - S : slot;
    };
    if (threadIdx.x >= WARP) {  // the copy warp
        if (threadIdx.x != WARP) return;
        int slot = 0;
        // the parity of the empty barrier's phase stage m waits for (m >= S:
        // (m / S - 1) & 1); it flips as the slots wrap
        uint32_t phase = 1;
        for (int64_t m = 0; m < n_stages; ++m) {
            if (m >= S) bar_wait(empty + slot, phase);
            const int64_t rows = n - m * ROWS < ROWS ? n - m * ROWS : ROWS;
            const uint32_t bytes = (uint32_t)(
                (delta * sizeof(float) + rows * W * sizeof(float) + 15) & ~15);
            bar_expect_tx(full + slot, bytes);
            bulk_load(ring + (size_t)slot * stage,
                      src0 + m * ROWS * (int64_t)W * sizeof(float), bytes,
                      full + slot);
            slot = next_slot(slot, 1);
            if (slot == 0) phase ^= 1u;
        }
        return;
    }

    // the chain warp. Row j of the stage in ring slot `slot` is at
    // row(slot, j); every lane keeps its own count of the stages it has
    // waited for.
    auto row = [&](int slot, int j) {
        return ring + (size_t)slot * stage + delta + j * W;
    };
    const int F = (W + 30) / ROWS;
    int64_t waited = 0;
    int wait_slot = 0;
    uint32_t wait_phase = 0;
    auto wait_through = [&](int64_t m_last) {
        if (m_last > n_stages - 1) m_last = n_stages - 1;
        for (; waited <= m_last; ++waited) {
            bar_wait(full + wait_slot, wait_phase);
            wait_slot = next_slot(wait_slot, 1);
            if (wait_slot == 0) wait_phase ^= 1u;
        }
    };
    wait_through(F);

    // the candidates of steps 0 .. W-2 (stages 0 .. F < S: slot = stage)
    // that read M[0 .. W-1] (-inf), and M's first W + 1 slots
    for (int s = lane; s < W - 1; s += WARP) {
        const float* c = row(s / ROWS, s % ROWS);
        float p = -CUDART_INF_F;
        for (int k = 0; k <= W - 2 - s; ++k)
            p = max_nan(p, __fadd_rn(-CUDART_INF_F, c[k]));
        pre[s] = p;
    }
    for (int p = lane; p <= W; p += WARP) Mb[p] = p < W ? -CUDART_INF_F : 0.0f;
    __syncwarp();

    // the chain side: M = M_{i-1}; U0 = step i's candidates but the chain's;
    // U1 = step i+1's k = W-3; H1, H2 = the lanes' values of steps i+1, i+2
    float M = 0.0f;
    float U0 = W >= 2 ? pre[0] : -CUDART_INF_F;
    float U1 = (D == 3 && Q == 0) ? pre[1] : -CUDART_INF_F;
    float H1 = Q ? pre[1] : -CUDART_INF_F;
    float H2 = Q ? pre[2] : -CUDART_INF_F;
    // lane slot q: its value, the address of its cost at the round's step
    // 0 (floats from ring; k = W-1-D-32q-lane there), and e[q]: the round's
    // first step at which its k >= 0
    // (slot q holds step 32 (r + q) + lane + D: row (lane + D) % 32 of
    // stage r + q + (lane + D) / 32, whose ring slot is slot_r's + that)
    float x[Q > 0 ? Q : 1];
    int addr[Q > 0 ? Q : 1];
    int e[Q > 0 ? Q : 1];
    const int lrow = (lane + D) % ROWS, lcarry = (lane + D) / ROWS;
    auto slot_addr = [&](int slot, int q) {
        return (int)(row(slot, lrow) - ring) + (W - 1 - D - WARP * q - lane);
    };
#pragma unroll
    for (int q = 0; q < Q; ++q) {
        const int s = WARP * q + lane + D;
        x[q] = s <= W - 2 ? pre[s] : -CUDART_INF_F;
        addr[q] = slot_addr(q + lcarry, q);  // q + lcarry <= Q < S
        e[q] = WARP * q + lane - (W - 1 - D);
    }

    // Round r runs steps 32 r .. 32 r + 31. The chain side's costs of
    // round r, C[i+d][W-1-d] for i = 32 r + t, sit in diag's half r & 1; a
    // round stages the next round's (rows of stages r + 1 and r + 2, waited
    // for) while it runs, so no shared store or wait precedes its steps.
    auto stage_diag = [&](int64_t rr, int slot) {
        float* dg = diag + (rr & 1) * 3 * WARP;
#pragma unroll
        for (int d = 0; d < D; ++d)
            dg[d * WARP + lane] = row(lane + d < ROWS ? slot
                                                      : next_slot(slot, 1),
                                      (lane + d) % ROWS)[W - 1 - d];
    };
    float* Mr = Mb + W + 1;  // M of round r's steps
    auto step = [&](int64_t rr, int t) {  // step 32 rr + t
        const float* dg = diag + (rr & 1) * 3 * WARP;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
            const float term = __fadd_rn(M, ring[addr[q] + t]);
            if (q + 3 <= Q)  // k >= 0 at every step of the round
                x[q] = max_nan(x[q], term);
            else
                fold_from(x[q], term, e[q], t);
        }
        const float Mn = D == 1 ? __fadd_rn(M, dg[t])
                                : max_nan(U0, __fadd_rn(M, dg[t]));
        if constexpr (D == 2) {
            U0 = __fadd_rn(M, dg[WARP + t]);
        } else if constexpr (D == 3) {
            const float near = Q ? max_nan(U1, H1) : U1;
            U0 = max_nan(near, __fadd_rn(M, dg[WARP + t]));
            U1 = __fadd_rn(M, dg[2 * WARP + t]);
        }
        if constexpr (Q > 0) {
            H1 = H2;
            H2 = __shfl_sync(FULL, x[0], t);  // step 32 rr + t + D
        }
        if (lane == 0) Mr[t] = Mn;
        M = Mn;
    };

    int slot_r = 0;  // the ring slot of stage r
    stage_diag(0, 0);
    __syncwarp();
    for (int64_t r = 0; r * ROWS < n; ++r) {
        const bool more = (r + 1) * ROWS < n;
        const int slot_n = next_slot(slot_r, 1);
        if (more) {
            wait_through(r + 1 + F);
            stage_diag(r + 1, slot_n);
        }
        // 8 steps of code: a fully unrolled round (~13 KB of instructions)
        // ran slower on an H100
#pragma unroll 8
        for (int t = 0; t < ROWS; ++t) step(r, t);
        Mr += ROWS;
        if constexpr (Q > 0) {
#pragma unroll
            for (int q = 0; q + 1 < Q; ++q) {
                x[q] = x[q + 1];
                addr[q] = addr[q + 1] + ROWS;
            }
            // step 32 (r + Q) + lane + D; Q + lcarry <= Q + 1 < S
            x[Q - 1] = -CUDART_INF_F;
            addr[Q - 1] = slot_addr(next_slot(slot_r, Q + lcarry), Q - 1);
        }
        __syncwarp();  // the next round's diag is in; stage r is read
        if (lane == 0) bar_arrive(empty + slot_r);
        slot_r = slot_n;
    }
}

// ks from the push body's M: one warp per 32 steps of a chain; step s's am
// is the first k whose candidate has M[W+s+1]'s key.
__global__ void __launch_bounds__(ARGMAX_THREADS)
    dp_scan_argmax_kernel(const float* __restrict__ C,
                          const float* __restrict__ Mg, int* __restrict__ ks,
                          int64_t nb, int64_t n, int W) {
    const int lane = threadIdx.x & (WARP - 1);
    const int64_t per_chain = (n + WARP - 1) / WARP;
    const int64_t warps = (int64_t)gridDim.x * (ARGMAX_THREADS / WARP);
    for (int64_t w = ((int64_t)blockIdx.x * ARGMAX_THREADS + threadIdx.x)
                     / WARP;
         w < nb * per_chain; w += warps) {
        const int64_t b = w / per_chain;
        const int64_t s0 = (w % per_chain) * WARP;
        const float* Mb = Mg + b * (n + W + 1 + ROWS);
        const float* Cb = C + b * n * (int64_t)W;
        const int cnt = (int)(n - s0 < WARP ? n - s0 : WARP);
        const float mine_m = lane < cnt ? Mb[W + 1 + s0 + lane] : 0.0f;
        int mine = 0;
        for (int j = 0; j < cnt; ++j) {
            const int64_t s = s0 + j;
            const float ms = __shfl_sync(FULL, mine_m, j);
            const bool ms_nan = ms != ms;
            int am = 0;
            for (int k0 = 0; k0 < W; k0 += WARP) {
                const int k = k0 + lane;
                bool hit = false;
                if (k < W) {
                    const float c = __fadd_rn(Mb[s + 1 + k], Cb[s * W + k]);
                    hit = c == ms || (ms_nan && c != c);
                }
                const unsigned bal = __ballot_sync(FULL, hit);
                if (bal) {
                    am = k0 + __ffs(bal) - 1;
                    break;
                }
            }
            if (lane == j) mine = (int)(s - (W - 1) + am);
        }
        if (lane < cnt) ks[b * n + s0 + lane] = mine;
    }
}

template <int D, int Q>
int launch_push(const float* C, int* ks, float* Mg, int64_t nb, int64_t n,
                int64_t W, void* stream) {
    const PushGeometry g = push_geometry(W);
    int err = wgbs::launch(dp_scan_push_kernel<D, Q>, dim3((unsigned)nb),
                           2 * WARP, g.smem, stream, C, Mg, n, (int)W,
                           (int)g.S, (int)g.stage);
    if (err) return err;
    const int64_t warps = nb * ((n + WARP - 1) / WARP);
    int64_t blocks = (warps + ARGMAX_THREADS / WARP - 1)
                     / (ARGMAX_THREADS / WARP);
    if (blocks > 132 * 16) blocks = 132 * 16;
    dp_scan_argmax_kernel<<<(unsigned)blocks, ARGMAX_THREADS, 0,
                            (cudaStream_t)stream>>>(C, Mg, ks, nb, n,
                                                    (int)W);
    return (int)cudaGetLastError();
}

int launch_push_by_width(const float* C, int* ks, float* Mg, int64_t nb,
                         int64_t n, int64_t W, void* stream) {
    switch (W) {
        case 1: return launch_push<1, 0>(C, ks, Mg, nb, n, W, stream);
        case 2: return launch_push<2, 0>(C, ks, Mg, nb, n, W, stream);
        case 3: return launch_push<3, 0>(C, ks, Mg, nb, n, W, stream);
        default: break;
    }
    switch (push_slots((int)W)) {
        case 1: return launch_push<3, 1>(C, ks, Mg, nb, n, W, stream);
        case 2: return launch_push<3, 2>(C, ks, Mg, nb, n, W, stream);
        case 3: return launch_push<3, 3>(C, ks, Mg, nb, n, W, stream);
        case 4: return launch_push<3, 4>(C, ks, Mg, nb, n, W, stream);
        case 5: return launch_push<3, 5>(C, ks, Mg, nb, n, W, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

// The warp body's cost tile rows for width W <= SMEM_W_MAX.
int warp_rows(int64_t W) {
    const int r = TILE_FLOATS / (int)W;
    return r < 1 ? 1 : (r > MAX_TILE_ROWS ? MAX_TILE_ROWS : r);
}

enum Body { PUSH = 0, WARP_SMEM = 1, WARP_GLOBAL = 2 };

Body body_of(int64_t W) {
    return W <= PUSH_W_MAX ? PUSH : (W <= SMEM_W_MAX ? WARP_SMEM
                                                     : WARP_GLOBAL);
}

}  // namespace

extern "C" {

// The launch dp_scan makes for n steps of width W, chosen by W alone: out =
// {body (0 push, 1 warp, 2 warp with the ring in global memory), scratch
// floats per chain (push: its M, n + W + 1 + 32; warp global: the ring, W),
// threads per CTA, dynamic shared bytes}. Touches no device.
int dp_scan_plan(int64_t n, int64_t W, int64_t* out) {
    if (n < 0 || n > INT32_MAX || W < 1 || W > (1 << 24))
        return (int)cudaErrorInvalidValue;
    const Body body = body_of(W);
    out[0] = body;
    if (body == PUSH) {
        out[1] = n + W + 1 + ROWS;
        out[2] = 2 * WARP;
        out[3] = (int64_t)push_geometry(W).smem;
    } else {
        const int rows = body == WARP_SMEM ? warp_rows(W) : 0;
        out[1] = body == WARP_GLOBAL ? W : 0;
        out[2] = WARP;
        out[3] = rows ? (int64_t)((2 * (size_t)rows * W + W) * sizeof(float))
                      : 0;
    }
    return 0;
}

// Launches the body dp_scan_plan names on `stream` (the current device):
// one CTA per chain (and, for push, the argmax kernel after it). `scratch`
// must hold dp_scan_plan's floats per chain for nb chains where that is not
// 0. Bad sizes return cudaErrorInvalidValue (the wrapper checks first).
int dp_scan(const void* C, void* ks, void* scratch, int64_t nb, int64_t n,
            int64_t W, void* stream) {
    if (nb < 0 || nb > INT32_MAX || n < 0 || n > INT32_MAX || W < 1 ||
        W > (1 << 24))
        return (int)cudaErrorInvalidValue;
    if (nb == 0 || n == 0) return 0;
    int64_t plan[4];
    dp_scan_plan(n, W, plan);
    if (plan[1] && scratch == nullptr) return (int)cudaErrorInvalidValue;
    switch (body_of(W)) {
        case PUSH:
            return launch_push_by_width((const float*)C, (int*)ks,
                                        (float*)scratch, nb, n, W, stream);
        case WARP_SMEM:
            return wgbs::launch(
                dp_scan_kernel<true>, dim3((unsigned)nb), WARP,
                (size_t)plan[3], stream, (const float*)C, (int*)ks,
                (float*)nullptr, n, (int)W, warp_rows(W));
        default:
            return wgbs::launch(dp_scan_kernel<false>, dim3((unsigned)nb),
                                WARP, (size_t)0, stream, (const float*)C,
                                (int*)ks, (float*)scratch, n, (int)W, 0);
    }
}

}  // extern "C"
