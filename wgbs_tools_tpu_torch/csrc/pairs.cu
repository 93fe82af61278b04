// Hand-written Hopper (sm_90a) kernel for the adjacent-CpG pair counts of
// pat2pairs (wgbs_tools_tpu_torch/ops/pairs.py::pair_counts_add):
//
//   start_rel i32 [F]      each fragment's first site minus the window's
//                          first (negative for a fragment that starts
//                          before the window), sorted ascending (the
//                          wrapper sorts an unsorted batch first)
//   length    i32 [F]      sites the fragment covers
//   count     i32 [F]      its count
//   codes     u8  [F][L]   its calls, T=0 C=1 H=2 '.'=3 (3 past length)
//   table     i32 [n][4]   the window's (tt, tc, ct, cc) counts, added to in
//                          place; 16-byte aligned
//
// For each fragment and position p in [1, min(length, L)), with pre =
// codes[p-1] and cur = codes[p] both T or C (H is not counted) and site
// start_rel + p in [0, n): table[site][2 (pre == C) + (cur == C)] += count.
// A pair is counted at its second site. Replaces wgbs_tools_tpu/ops/
// pairs.py::_pairs_accum (:57), the jitted scatter-add of StreamingPairs
// (and _pairs_batch, :17, of the one-shot pair_counts: the same function
// on a zeroed table), which XLA fuses into one pass and plain PyTorch would
// materialize as masks, ids and an index_add_.
//
// Bound: bytes. A slab's codes and its three int32 columns are read once;
// each table entry that the slab's pairs reach is read and written once.
// A pat slab is sorted by start, so neighbouring fragments add into the
// same sites: one 32-bit L2 atomic per pair (the earlier body, a warp a
// fragment) paid ~2.5 round trips per table entry and ran at ~10 % of the
// bound.
//
// A site tile that one CTA owns: the window's sites are cut into tiles of
// TILE sites, and a CTA walks the tiles the slab reaches (from the first
// fragment's first pair to the last one's last), grid-strided. For a tile
// [site0, site0 + TILE), warp 0 finds the fragments that can reach it, the
// start_rel in [site0 - (L - 1), site0 + TILE - 1), by a 33-ary search on
// the sorted start_rel (two searches in step, one ballot each a step). The
// CTA's counts live in shared memory as four planes of TILE uint32 (tt, tc,
// ct, cc), a plane per class, so neighbouring sites are neighbouring banks.
// Consecutive threads take consecutive fragments, PER a thread at a time:
// their columns and the first min(L, ROW_MAX) bytes of their rows (V-byte
// loads, V = 8, 4 or 1 as L and the codes' alignment allow) are all
// loaded before any is used, since the loads do not wait on the length. A row of up to ROW_MAX calls becomes two 32-bit masks, ok (T or
// C) and c, four calls a word by a zero-byte test and a multiply that
// gathers one bit a byte; the valid pairs ok & ok << 1, cut to the tile,
// split by class and walked by __ffs, are each a shared atomicAdd. A
// longer row (L > ROW_MAX only: the kernel's LONG instance, the one with
// a barrier a round) is pushed to a list and walked by a warp, lane k
// taking p = p0 + k, p0 + k + 32, ... Once the tile is complete,
// warp 0 searches the CTA's next tile while the other warps add the tile
// into the table with one 16-byte read-modify-write a site (int4,
// coalesced, FLUSH_BATCH loads a thread in flight), skipping a site whose
// four counts are zero, and zero the planes. No other CTA writes that
// tile: the flush needs no global atomic, and the table is the same on
// every run. The uint32 sums in shared memory and the int32 add of the
// flush wrap as JAX's int32 scatter-add does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int NWARPS = THREADS / WARP;
constexpr int TILE = 2048;    // sites a CTA owns at a time
constexpr int ROW_MAX = 32;   // the longest row (min(length, L)) a thread walks
constexpr int WORDS = ROW_MAX / 4;  // 32-bit words of such a row
constexpr int FLUSH_BATCH = 4;      // sites a flushing thread has in flight
constexpr int MIN_CTAS = 4;         // CTAs an SM holds (registers: <= 64)
constexpr int PER = 2;              // fragments a thread loads a round
constexpr int CODE_C = 1;     // T = 0, C = 1; H = 2 and '.' = 3 do not count

__host__ __device__ constexpr size_t plane_bytes() {
    return 4 * TILE * sizeof(uint32_t);
}

// Bit j of the result: byte j of x is 0 or 1 (T or C). A byte y is 0
// when neither its low 7 bits plus 0x7F nor y itself reach bit 7 (no carry
// crosses a byte); the 4 bit-7 flags then land on bits 28-31 of the
// product, each from one byte, and no other term reaches them.
__device__ __forceinline__ uint32_t ok4(uint32_t x) {
    const uint32_t y = x & 0xFEFEFEFEu;
    const uint32_t z = ~(((y & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | y) & 0x80808080u;
    return (z * 0x00204081u) >> 28;
}

// Bit j of the result: bit 0 of byte j of x (C where byte j is T or C):
// the 4 bits land on bits 24-27 of the product.
__device__ __forceinline__ uint32_t c4(uint32_t x) {
    return ((x & 0x01010101u) * 0x01020408u) >> 24;
}

// Bits [lo, hi) of a 32-bit mask, 0 <= lo, hi <= 32.
__device__ __forceinline__ uint32_t bit_range(int lo, int hi) {
    if (lo >= hi) return 0u;
    const uint32_t below_hi = hi >= 32 ? ~0u : (1u << hi) - 1u;
    return below_hi & ~((1u << lo) - 1u);
}

// A fragment as a thread holds it: its columns and the first min(L,
// ROW_MAX) calls of its row as 32-bit words (call j in byte j % 4 of word
// j / 4), then as the masks ok (T or C) and c (C where T or C), bit j for
// call j.
struct Frag {
    int s0, len, cnt;
    uint32_t w[WORDS];
    uint32_t ok, c;
};

// Loads fragment f with V-byte loads (V divides L and the codes' address)
// of the row's first Lr = min(L, ROW_MAX) bytes: the loads wait on nothing
// (not on the fragment's length), so a thread's two fragments' loads are
// in flight together.
template <int V>
__device__ __forceinline__ void load_frag(const int* __restrict__ start_rel,
                                          const int* __restrict__ length,
                                          const int* __restrict__ count,
                                          const uint8_t* __restrict__ codes,
                                          int64_t L, int Lr, int64_t f,
                                          Frag& a) {
    a.s0 = start_rel[f];
    a.len = length[f];
    a.cnt = count[f];
    const uint8_t* row = codes + f * L;
#pragma unroll
    for (int k = 0; k < WORDS; ++k) a.w[k] = 0u;  // calls past Lr: unused
    if constexpr (V == 8) {
        const uint2* r = reinterpret_cast<const uint2*>(row);
#pragma unroll
        for (int j = 0; j < ROW_MAX / 8; ++j)
            if (8 * j < Lr) {
                const uint2 v = __ldg(r + j);
                a.w[2 * j] = v.x;
                a.w[2 * j + 1] = v.y;
            }
    } else if constexpr (V == 4) {
        const uint32_t* r = reinterpret_cast<const uint32_t*>(row);
#pragma unroll
        for (int j = 0; j < WORDS; ++j)
            if (4 * j < Lr) a.w[j] = __ldg(r + j);
    } else {
#pragma unroll
        for (int j = 0; j < ROW_MAX; ++j)
            if (j < Lr) a.w[j / 4] |= (uint32_t)__ldg(row + j) << (8 * (j % 4));
    }
}

// Loads this thread's fragments of the round from f0: f0 + threadIdx.x +
// k THREADS for k < PER, those below hi.
template <int V>
__device__ __forceinline__ void load_round(const int* __restrict__ start_rel,
                                           const int* __restrict__ length,
                                           const int* __restrict__ count,
                                           const uint8_t* __restrict__ codes,
                                           int64_t L, int Lr, int64_t f0,
                                           int64_t hi, Frag (&a)[PER],
                                           bool (&in)[PER]) {
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int64_t f = f0 + threadIdx.x + k * THREADS;
        in[k] = f < hi;
        if (in[k])
            load_frag<V>(start_rel, length, count, codes, L, Lr, f, a[k]);
    }
}

// The masks of a loaded fragment's first Lr calls, four calls a word.
__device__ __forceinline__ void frag_masks(Frag& a, int Lr) {
    a.ok = 0u;
    a.c = 0u;
#pragma unroll
    for (int k = 0; k < WORDS; ++k)
        if (4 * k < Lr) {  // uniform
            a.ok |= ok4(a.w[k]) << (4 * k);
            a.c |= c4(a.w[k]) << (4 * k);
        }
}

// The first index in [0, F) whose a[] >= key, or F, of two keys at once,
// by all lanes of a warp: while a range is wider than a warp, its lanes
// probe 32 points that cut it into 33 parts and the first probe >= key
// (a ballot) narrows it; then each lane probes one index. On unsorted a[]
// the answer is some index in [0, F].
__device__ void warp_lower_bound2(const int* __restrict__ a, int64_t F,
                                  int64_t key0, int64_t key1, int64_t& r0,
                                  int64_t& r1) {
    const int lane = threadIdx.x % WARP;
    int64_t lo[2] = {0, 0}, hi[2] = {F, F};
    const int64_t key[2] = {key0, key1};
    while (hi[0] - lo[0] > WARP || hi[1] - lo[1] > WARP) {
        bool ge[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int64_t w = hi[k] - lo[k];
            ge[k] = w > WARP
                    && a[lo[k] + (lane + 1) * w / (WARP + 1)] >= key[k];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
            const int64_t w = hi[k] - lo[k];
            if (w <= WARP) continue;  // uniform over the warp
            const unsigned b = __ballot_sync(~0u, ge[k]);
            const int first = b ? __ffs(b) - 1 : WARP;  // probes below: < key
            const int64_t l0 = lo[k];
            if (first > 0) lo[k] = l0 + first * w / (WARP + 1) + 1;
            if (first < WARP) hi[k] = l0 + (first + 1) * w / (WARP + 1);
        }
    }
#pragma unroll
    for (int k = 0; k < 2; ++k) {
        const int64_t w = hi[k] - lo[k];
        const unsigned b =
            __ballot_sync(~0u, lane < w && a[lo[k] + lane] >= key[k]);
        const int64_t r = b ? lo[k] + __ffs(b) - 1 : hi[k];
        (k == 0 ? r0 : r1) = r;
    }
}

// Warp 0: the fragments [lo, hi) that can reach tile t, into s_range.
__device__ __forceinline__ void find_range(const int* __restrict__ start_rel,
                                           int64_t F, int64_t L, int64_t n,
                                           int64_t t, int64_t* s_range) {
    const int64_t site0 = t * TILE;
    const int64_t tile_n = n - site0 < TILE ? n - site0 : TILE;
    int64_t lo, hi;
    warp_lower_bound2(start_rel, F, site0 - (L - 1), site0 + tile_n - 1, lo,
                      hi);
    if (threadIdx.x == 0) {
        s_range[0] = lo;
        s_range[1] = hi;
    }
}

// Adds the pairs of a fragment whose sites lie in the tile [site0, site0 +
// tile_n) to the planes: one thread, a row of last <= ROW_MAX calls. The
// valid pairs are split by class (bit p of c << 1 is call p - 1's C) and
// each class's walked by __ffs.
__device__ __forceinline__ void thread_row(const Frag& a, int last,
                                           int64_t site0, int tile_n,
                                           uint32_t* planes) {
    // positions whose site s0 + p, tile site rel + p, is in the tile, p >= 1
    const int64_t rel = (int64_t)a.s0 - site0;
    const int64_t plo = -rel > 1 ? -rel : 1;
    const int64_t phi = tile_n - rel < last ? tile_n - rel : (int64_t)last;
    if (plo >= phi) return;
    const uint32_t vm = a.ok & (a.ok << 1) & bit_range((int)plo, (int)phi);
    const uint32_t pre = a.c << 1;
    const uint32_t n = (uint32_t)a.cnt;
#pragma unroll
    for (int cls = 0; cls < 4; ++cls) {
        uint32_t m = vm & (cls & 2 ? pre : ~pre) & (cls & 1 ? a.c : ~a.c);
        const int at = cls * TILE + (int)rel;  // + p >= 0: p >= plo
        while (m) {
            const int p = __ffs(m) - 1;
            m &= m - 1;
            atomicAdd(planes + at + p, n);
        }
    }
}

// The same for a row of any length, walked by the 32 lanes of a warp.
__device__ __forceinline__ void warp_row(
    const int* __restrict__ start_rel, const int* __restrict__ length,
    const int* __restrict__ count, const uint8_t* __restrict__ codes,
    int64_t L, int64_t f, int64_t site0, int tile_n, uint32_t* planes) {
    const int lane = threadIdx.x % WARP;
    const int64_t s0 = start_rel[f];
    const int64_t len = length[f];
    const int64_t last = len < L ? len : L;
    const int64_t plo = site0 - s0 > 1 ? site0 - s0 : 1;
    const int64_t phi =
        site0 + tile_n - s0 < last ? site0 + tile_n - s0 : last;
    const uint32_t n = (uint32_t)count[f];
    const uint8_t* row = codes + f * L;
    for (int64_t p = plo + lane; p < phi; p += WARP) {
        const int pre = row[p - 1], cur = row[p];
        if (pre <= CODE_C && cur <= CODE_C)
            atomicAdd(planes + (2 * pre + cur) * TILE + (s0 + p - site0), n);
    }
}

template <int V, bool LONG>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
pair_counts_kernel(const int* __restrict__ start_rel,
                   const int* __restrict__ length,
                   const int* __restrict__ count,
                   const uint8_t* __restrict__ codes, int* __restrict__ table,
                   int64_t F, int64_t L, int64_t n) {
    extern __shared__ uint32_t planes[];  // [4][TILE]
    __shared__ int64_t s_range[2];
    __shared__ int64_t s_long[PER * THREADS];  // rows a warp walks, a round
    __shared__ int s_nlong[2];               // their count, by round parity
    for (int i = threadIdx.x; i < 4 * TILE; i += THREADS) planes[i] = 0u;
    if (threadIdx.x < 2) s_nlong[threadIdx.x] = 0;
    const int warp = threadIdx.x / WARP;

    // the tiles the slab reaches: the first fragment's first pair site to
    // the last one's last
    const int64_t num_tiles = (n + TILE - 1) / TILE;
    const int64_t first = (int64_t)start_rel[0] + 1;
    const int64_t t_first = first > 0 ? first / TILE : 0;
    const int64_t end = (int64_t)start_rel[F - 1] + L - 1;  // last site
    const int64_t t_last = end < 0 ? -1 : (end / TILE < num_tiles
                                               ? end / TILE
                                               : num_tiles - 1);
    const int Lr = (int)(L < ROW_MAX ? L : ROW_MAX);
    constexpr bool long_rows = LONG;  // L > ROW_MAX
    int parity = 0;
    int64_t t = t_first + blockIdx.x;
    if (warp == 0 && t <= t_last) find_range(start_rel, F, L, n, t, s_range);
    for (; t <= t_last; t += gridDim.x) {
        __syncthreads();  // the range is in, the last flush's zeroes too
        const int64_t site0 = t * TILE;
        const int tile_n = (int)(n - site0 < TILE ? n - site0 : TILE);
        const int64_t lo = s_range[0], hi = s_range[1];
        // PER fragments a thread a round, all loaded before any is used
        for (int64_t f0 = lo; f0 < hi; f0 += PER * THREADS) {
            Frag a[PER];
            bool in[PER];
            load_round<V>(start_rel, length, count, codes, L, Lr, f0, hi, a,
                          in);
#pragma unroll
            for (int k = 0; k < PER; ++k)
                if (in[k]) frag_masks(a[k], Lr);
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                if (!in[k]) continue;
                if (long_rows && a[k].len > ROW_MAX)
                    s_long[atomicAdd(s_nlong + parity, 1)] =
                        f0 + threadIdx.x + k * THREADS;
                else
                    thread_row(a[k], a[k].len < Lr ? a[k].len : Lr, site0,
                               tile_n, planes);
            }
            if (long_rows) {
                __syncthreads();
                const int n_long = s_nlong[parity];
                if (threadIdx.x == 0) s_nlong[parity ^ 1] = 0;
                for (int i = warp; i < n_long; i += NWARPS)
                    warp_row(start_rel, length, count, codes, L, s_long[i],
                             site0, tile_n, planes);
                __syncthreads();
                parity ^= 1;
            }
        }
        __syncthreads();  // the tile is complete
        if (warp == 0) {
            // the next tile's range, while the other warps flush
            if (t + gridDim.x <= t_last)
                find_range(start_rel, F, L, n, t + gridDim.x, s_range);
            continue;
        }
        // the flush: one int4 read-modify-write a site with a count,
        // FLUSH_BATCH sites a thread in flight
        int4* out = reinterpret_cast<int4*>(table) + site0;
        constexpr int FLUSHERS = THREADS - WARP;
        for (int i0 = threadIdx.x - WARP; i0 < tile_n;
             i0 += FLUSH_BATCH * FLUSHERS) {
            bool any[FLUSH_BATCH];
            int4 v[FLUSH_BATCH];
#pragma unroll
            for (int k = 0; k < FLUSH_BATCH; ++k) {
                const int i = i0 + k * FLUSHERS;
                any[k] = i < tile_n && (planes[i] | planes[TILE + i] |
                                        planes[2 * TILE + i] |
                                        planes[3 * TILE + i]);
                if (any[k]) v[k] = out[i];
            }
#pragma unroll
            for (int k = 0; k < FLUSH_BATCH; ++k) {
                const int i = i0 + k * FLUSHERS;
                if (!any[k]) continue;
                v[k].x = (int)((uint32_t)v[k].x + planes[i]);
                v[k].y = (int)((uint32_t)v[k].y + planes[TILE + i]);
                v[k].z = (int)((uint32_t)v[k].z + planes[2 * TILE + i]);
                v[k].w = (int)((uint32_t)v[k].w + planes[3 * TILE + i]);
                out[i] = v[k];
                planes[i] = planes[TILE + i] = planes[2 * TILE + i] =
                    planes[3 * TILE + i] = 0u;
            }
        }
    }
}

template <int V, bool LONG>
int launch_pairs(const void* start_rel, const void* length, const void* count,
                 const void* codes, void* table, int64_t F, int64_t L,
                 int64_t n, void* stream) {
    auto kernel = pair_counts_kernel<V, LONG>;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)plane_bytes());
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, THREADS, plane_bytes());
    if (err != cudaSuccess) return (int)err;
    const int64_t tiles = (n + TILE - 1) / TILE;
    const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(tiles < most ? tiles : most);
    return wgbs::launch(kernel, dim3(grid), THREADS, plane_bytes(), stream,
                        (const int*)start_rel, (const int*)length,
                        (const int*)count, (const uint8_t*)codes, (int*)table,
                        F, L, n);
}

// The instance for row width L and the codes' alignment: V-byte loads,
// and the long-row list only where a row can pass ROW_MAX.
template <bool LONG>
int launch_by_width(const void* start_rel, const void* length,
                    const void* count, const void* codes, void* table,
                    int64_t F, int64_t L, int64_t n, void* stream) {
    const uintptr_t at = (uintptr_t)codes;
    if (L % 8 == 0 && at % 8 == 0)
        return launch_pairs<8, LONG>(start_rel, length, count, codes, table,
                                     F, L, n, stream);
    if (L % 4 == 0 && at % 4 == 0)
        return launch_pairs<4, LONG>(start_rel, length, count, codes, table,
                                     F, L, n, stream);
    return launch_pairs<1, LONG>(start_rel, length, count, codes, table, F,
                                 L, n, stream);
}

}  // namespace

extern "C" {

// F < 0, L < 1, n < 0 or a table not 16-byte aligned returns
// cudaErrorInvalidValue. F == 0, L == 1 or n == 0 launches nothing (no pair
// can count). start_rel must be sorted ascending. Launches on `stream` on
// the current device, at most as many CTAs as the tiles and as fit on the
// card at once (tiles grid-strided).
int pair_counts(const void* start_rel, const void* length, const void* count,
                const void* codes, void* table, int64_t F, int64_t L,
                int64_t n, void* stream) {
    if (F < 0 || L < 1 || n < 0 || ((uintptr_t)table & 15u))
        return (int)cudaErrorInvalidValue;
    if (F == 0 || L == 1 || n == 0) return 0;
    return L > ROW_MAX ? launch_by_width<true>(start_rel, length, count, codes,
                                               table, F, L, n, stream)
                       : launch_by_width<false>(start_rel, length, count,
                                                codes, table, F, L, n, stream);
}

}  // extern "C"
