// The output tile of the fragment-row kernels (pileup_v2.cu, pileup_v1.cu),
// shared by both: a CTA piles the rows that reach its tile into shared
// memory and writes the tile whole.
//
// Shared memory: (3 * tile + 4) 32-bit words, zeroed by zero_tile:
//   pm [0, tile)          count of the rows' T sites ('meth' taken away)
//   pc [tile, 2 * tile)   count of the rows' '.' sites
//   d  [2 * tile, 3 * tile + 1)  difference array of the rows' intervals
// so that cov = prefix(d) - pc and meth = cov - pm. A row adds +count and
// -count at the ends of its in-tile interval, then count at each of its T
// and '.' sites only (about a third of them), found as bit masks of its
// 2-bit code words. All sums are unsigned 32-bit, so the prefix sum and the
// differences wrap exactly as an int32 index_add_ does; nothing is packed
// into 16 bits (a deep site sums thousands of counts of up to 3000). The
// adds are shared-memory atomicAdds (rows overlap), exact in any order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wgbs {

constexpr uint32_t EVEN = 0x55555555u;  // low bit of every 2-bit field

__host__ __device__ constexpr int tile_smem_words(int tile) {
    return 3 * tile + 4;
}

// All threads of the CTA; a barrier must follow.
__device__ __forceinline__ void zero_tile(int4* smem4, int tile) {
    for (int i = threadIdx.x; i < tile_smem_words(tile) / 4; i += blockDim.x)
        smem4[i] = make_int4(0, 0, 0, 0);
}

// Row `row`'s W words as one 8-B (W = 2) or W / 4 16-B loads; the wrapper
// checks that `words` is aligned to min(4 * W, 16) bytes.
template <int W>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ words,
                                           int64_t row, uint32_t (&w)[W]) {
    if constexpr (W == 2) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(words) + row);
        w[0] = v.x;
        w[1] = v.y;
    } else {
        const uint4* p = reinterpret_cast<const uint4*>(words) + row * (W / 4);
#pragma unroll
        for (int q = 0; q < W / 4; ++q) {
            const uint4 v = __ldg(p + q);
            w[4 * q] = v.x;
            w[4 * q + 1] = v.y;
            w[4 * q + 2] = v.z;
            w[4 * q + 3] = v.w;
        }
    }
}

// Adds count n of a row whose codes are W planar words held in registers
// (code j = field j >> log2(W) of word j & (W - 1)) at its sites j in
// [j0, j1), tile sites o + j: the interval into d, the T and '.' sites into
// pm and pc. Words c and c + W / 2 merge into one 32-bit mask whose bit p is
// site (p << log2(W / 2)) + c, so a row of up to 16 * W sites takes W / 2
// masks, each cut to [j0, j1) and walked by __ffs.
template <int W>
__device__ __forceinline__ void add_sites(uint32_t* pm, uint32_t* d, int tile,
                                          int o, int j0, int j1, uint32_t n,
                                          const uint32_t (&w)[W]) {
    constexpr int H = W / 2;  // merged masks
    constexpr int SH = W == 2 ? 0 : (W == 4 ? 1 : (W == 8 ? 2 : 3));
    static_assert(H == 1 << SH, "W is 2, 4, 8 or 16");
    atomicAdd(d + o + j0, n);
    atomicAdd(d + o + j1, 0u - n);
#pragma unroll
    for (int c = 0; c < H; ++c) {
        // bit p of the merged masks: field p / 2 of word c + H * (p % 2),
        // site j = (p << SH) + c
        const uint32_t alo = w[c] & EVEN, ahi = (w[c] >> 1) & EVEN;
        const uint32_t blo = w[c + H] & EVEN, bhi = (w[c + H] >> 1) & EVEN;
        const uint32_t dot = (alo & ahi) | ((blo & bhi) << 1);
        const uint32_t tee = (~(alo | ahi) & EVEN) | ((~(blo | bhi) & EVEN) << 1);
        // bits of the sites in [j0, j1): [ceil((j0 - c) / H), ceil((j1 - c) / H))
        const int lo_p = (j0 - c + H - 1) >> SH;
        const int hi_p = (j1 - c + H - 1) >> SH;  // <= 32
        uint32_t m = (dot | tee) & (uint32_t)((1ull << hi_p) - (1ull << lo_p));
        uint32_t* at = pm + o + c;
        while (m) {
            const int p = __ffs(m) - 1;
            m &= m - 1;
            atomicAdd(at + (p << SH) + ((dot >> p) & 1u) * tile, n);
        }
    }
}

// Writes the tile [site0, site0 + tile) of the (window_len, 2) output,
// clipped to the window: cov = prefix(d) - pc, meth = cov - pm, in rounds of
// 2 x THREADS sites (two per thread, scanned within the warp by shuffles and
// across warps through s_warp, THREADS / 32 words), each pair written as one
// 16-B (meth, cov, meth, cov) store where the output is 16-B aligned. All
// THREADS threads of the CTA, after a barrier; tile is even.
template <int THREADS>
__device__ __forceinline__ void store_tile(const uint32_t* pm,
                                           const uint32_t* d,
                                           uint32_t* s_warp, int tile,
                                           int64_t site0, int64_t window_len,
                                           int2* __restrict__ out) {
    const bool wide = ((uintptr_t)out & 15u) == 0;  // uniform over the CTA
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    uint32_t carry = 0u;  // prefix of d before the round
    for (int i0 = 0; i0 < tile; i0 += 2 * THREADS) {
        const int i = i0 + 2 * threadIdx.x;
        const uint32_t d0 = i < tile ? d[i] : 0u;
        const uint32_t d1 = i < tile ? d[i + 1] : 0u;
        uint32_t x = d0 + d1;
#pragma unroll
        for (int s = 1; s < 32; s <<= 1) {
            const uint32_t y = __shfl_up_sync(~0u, x, s);
            if (lane >= s) x += y;
        }
        if (lane == 31) s_warp[warp] = x;
        __syncthreads();
        uint32_t pre = carry;
#pragma unroll
        for (int k = 0; k < THREADS / 32; ++k) {
            const uint32_t v = s_warp[k];
            pre += k < warp ? v : 0u;
            carry += v;
        }
        __syncthreads();  // s_warp is read; the next round may write it
        const int64_t site = site0 + i;
        if (i >= tile || site >= window_len) continue;
        const uint32_t* pc = pm + tile;
        const uint32_t cov1 = pre + x - pc[i + 1];
        const uint32_t cov0 = pre + x - d1 - pc[i];
        const int4 v = make_int4((int)(cov0 - pm[i]), (int)cov0,
                                 (int)(cov1 - pm[i + 1]), (int)cov1);
        if (wide && site + 1 < window_len) {
            *reinterpret_cast<int4*>(out + site) = v;
            continue;
        }
        out[site] = make_int2(v.x, v.y);
        if (site + 1 < window_len) out[site + 1] = make_int2(v.z, v.w);
    }
}

}  // namespace wgbs
