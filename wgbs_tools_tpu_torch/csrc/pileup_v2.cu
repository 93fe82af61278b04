// Hand-written Hopper (sm_90a) kernel for the v2 staged pileup
// (wgbs_tools_tpu_torch/ops/pileup_v2.py, the same layout as
// wgbs_tools_tpu/ops/pileup_tpu2.py::stage_v2): one fragment per row.
//
//   c0, c1  int32 [num_tiles]         chunk range [c0[t], c1[t]) of output tile t;
//                                     a chunk's fragments start inside its tile
//   meta    int32 [n_chunks][3][fc]   [c][0][r] = start relative to the window,
//                                     [c][1][r] = len | dg << 16 (dg outside
//                                     [0, g_max) marks a padding row; row fc - 1
//                                     is padding and stashes the chunk's base_g
//                                     in its start slot),
//                                     [c][2][r] = repeat count
//   words   int32 [n_chunks*fc][w_cols] 2-bit planar codes: code j of the
//                                     fragment is (word[j % w_cols] >> 2*(j / w_cols)) & 3
//
// and write the (window_len, 2) int32 [meth, cov] pileup of the window:
// meth += count where the code is C(1) or H(2); cov += count where it is not
// '.'(3), at site rel + j for j < len -- ref stdin2beta.cpp:59-93.
//
// Replaces wgbs_tools_tpu/ops/pileup_tpu2.py::_kernel. The TPU kernel walks
// the tiles in order and carries each tile's 256-lane right halo into the
// next through scratch; Hopper blocks run in no set order, so nothing may
// carry. A fragment starts inside its chunk's tile and is at most 128 sites
// long (staging splits longer ones), so it reaches at most the next tile:
// CTA t adds the sites in tile t of the rows of tile t's chunks and of tile
// t - 1's, and every site is written by exactly one CTA. No carry, no global
// atomics, no memset, one launch; a tile with no chunk (c0[t] == c1[t]) still
// takes tile t - 1's crossers and writes zeros elsewhere. Exactly: a real row
// (dg in [0, g_max)) of a chunk in tile T's range adds its sites rel + j,
// j < min(len, 16 * w_cols), that lie in tile T or T + 1 and in the window,
// whatever its start (the twin's rule, tiles_v2_plain). Nothing assumes start
// order inside a chunk.
//
// Bound: device-memory bytes, as chip_smoke.py::_work counts them (12 B of
// meta and 4 * w_cols B of words per real row, 8 B per output site); two
// adds per site of a real row take ~4 % of that time at the 32-bit rate.
// What keeps a plain body far from it is latency and issue: one thread per
// row that loads its meta and then its words, and two shared atomics per
// site, run at ~19 % of the bound, and with each row read once but still
// added site by site the per-site loop's instructions are the limit
// (PERF.md). This body:
// - Reads each real row once. Of its own chunks CTA t loads every staged
//   row; of tile t - 1's chunks only the 4-B starts, and len | dg, count and
//   words only for the rows that start within 16 * w_cols sites before the
//   tile, the only ones that can reach it (~3 % of a big tile's rows).
// - Keeps loads in flight: a chunk is fc = 256 rows, one per thread, and a
//   thread issues the loads of its row of U chunks (start, len | dg, count,
//   and the words as one uint2 / uint4 vector), and the starts of tile
//   t - 1's first U chunks, before it adds any, so no load waits on another.
//   Padding rows (~5 % of a big tile's staged rows, the base_g row among
//   them) are loaded and skipped by dg; a listing pass, as pileup_v3.cu's
//   pile_codes has, would save those lanes for a shared-memory round trip
//   and a barrier per pass.
// - Adds a row in a few operations, not two per site. Its in-tile sites
//   [j0, j1) form one interval: +count at its start and -count one past its
//   end go into a difference array d, whose prefix sum is the coverage of
//   every site the rows span. Then only the sites that take less are added
//   one by one: count into pc where the code is '.', into pm where it is T,
//   so that cov = prefix(d) - pc and meth = cov - pm. A row's '.' and T
//   sites are found as bit masks of its words, decoded in registers (w_cols
//   is a template parameter; words c and c + w_cols / 2 merge into one
//   32-bit mask whose bit p is site (p << log2(w_cols / 2)) + c), cut to
//   [j0, j1), and walked by __ffs: ~30 % of a big slab's sites. The adds
//   are shared-memory atomicAdds (rows overlap), exact in any order; all
//   sums are unsigned 32-bit, so the prefix sum and the differences wrap
//   exactly as the twin's int32 index_add_ does, and nothing is packed into
//   16 bits (a deep site sums thousands of counts of up to 3000).
// - The epilogue scans d in rounds of 2 x 256 sites (two per thread, warp
//   shuffles, one partial sum per warp in shared memory) and writes each
//   pair of sites as one 16-B (meth, cov, meth, cov) store. The tile, the
//   decode and the epilogue are frag_tile.cuh's, shared with pileup_v1.cu.
// Balance: 256 threads and (3 x tile + 4) x 4 B = 12 KB of shared memory per
// CTA; the launch bound asks for 6 CTAs per SM (at most 40 registers), and U
// is 3 chunks for w_cols 2 (2 and 1 for 4 and 8), which ptxas fits with no
// spills (4 CTAs per SM with U = 4 took ~60 registers and was slower on the
// card: PERF.md).
//
// No entry point sets the CUDA device (see launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "frag_tile.cuh"
#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BLOCKS = 6;  // CTAs per SM the launch bound asks for

// Starts of row r of tile t - 1's chunks [c, c + U); INT32_MIN, which no
// reach test passes, for chunks at or past prev1.
template <int U>
__device__ __forceinline__ void load_starts(const int* __restrict__ meta,
                                            int c, int prev1, int fc, int r,
                                            int (&rel)[U]) {
#pragma unroll
    for (int k = 0; k < U; ++k)
        rel[k] = c + k < prev1 ? __ldg(meta + (int64_t)(c + k) * 3 * fc + r)
                               : INT32_MIN;
}

// Adds a row's sites in tile t (site0 = t * tile) into the accumulators, if
// the row is real: site rel + j, j < min(len, 16 * W).
template <int W>
__device__ __forceinline__ void add_row(uint32_t* pm, uint32_t* d, int tile,
                                        int64_t site0, int rel, int lw,
                                        int n, const uint32_t (&w)[W],
                                        int g_max) {
    const int dg = lw >> 16;
    if (dg < 0 || dg >= g_max) return;  // padding, the base_g row among them
    const int64_t len = min(lw & 0xFFFF, 16 * W);
    const int64_t off = (int64_t)rel - site0;
    if (max((int64_t)0, -off) >= min(len, (int64_t)tile - off)) return;
    // now off is in (-16 * W, tile), and the row's sites j in [j0, j1) are
    // tile sites o + j
    const int o = (int)off;
    wgbs::add_sites<W>(pm, d, tile, o, max(0, -o), min((int)len, tile - o),
                       (uint32_t)n, w);
}

// CTA t: tile t of the pileup. U: chunks whose row loads a thread issues
// before it adds any.
template <int W, int U>
__global__ void __launch_bounds__(THREADS, BLOCKS)
tiles_v2_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                const int* __restrict__ meta,
                const uint32_t* __restrict__ words, int2* __restrict__ out,
                int64_t window_len, int tile, int fc, int g_max) {
    extern __shared__ int4 smem4[];
    uint32_t* pm = reinterpret_cast<uint32_t*>(smem4);  // then pc
    uint32_t* d = pm + 2 * tile;
    __shared__ uint32_t s_warp[THREADS / 32];
    const int t = blockIdx.x;
    const int64_t site0 = (int64_t)t * tile;
    const int own0 = __ldg(c0 + t), own1 = __ldg(c1 + t);
    const int prev0 = t > 0 ? __ldg(c0 + t - 1) : 0;
    const int prev1 = t > 0 ? __ldg(c1 + t - 1) : 0;
    wgbs::zero_tile(smem4, tile);
    __syncthreads();

    const int64_t reach = site0 - 16 * W;
    for (int r = threadIdx.x; r < fc; r += THREADS) {
        int prel[U];  // tile t - 1's first starts, in flight meanwhile
        load_starts<U>(meta, prev0, prev1, fc, r, prel);
        // tile t's chunks: every staged row
        for (int c = own0; c < own1; c += U) {
            int rel[U], lw[U], n[U];
            uint32_t w[U][W];
#pragma unroll
            for (int k = 0; k < U; ++k) {
                rel[k] = n[k] = 0;
                lw[k] = -1;  // dg -1: not a row
#pragma unroll
                for (int q = 0; q < W; ++q) w[k][q] = 0u;
                if (c + k < own1) {
                    const int* m = meta + (int64_t)(c + k) * 3 * fc + r;
                    rel[k] = __ldg(m);
                    lw[k] = __ldg(m + fc);
                    n[k] = __ldg(m + 2 * fc);
                    wgbs::load_words<W>(words, (int64_t)(c + k) * fc + r, w[k]);
                }
            }
#pragma unroll
            for (int k = 0; k < U; ++k)
                add_row<W>(pm, d, tile, site0, rel[k], lw[k], n[k], w[k],
                           g_max);
        }
        // tile t - 1's chunks: only the rows that can reach tile t (start
        // in (site0 - 16 * W, site0 + tile)) load the rest
        for (int c = prev0; c < prev1; c += U) {
            if (c != prev0) load_starts<U>(meta, c, prev1, fc, r, prel);
            int lw[U], n[U];
            uint32_t w[U][W];
#pragma unroll
            for (int k = 0; k < U; ++k) {
                n[k] = 0;
                lw[k] = -1;
#pragma unroll
                for (int q = 0; q < W; ++q) w[k][q] = 0u;
                if (prel[k] > reach && prel[k] < site0 + tile) {
                    const int* m = meta + (int64_t)(c + k) * 3 * fc + r;
                    lw[k] = __ldg(m + fc);
                    n[k] = __ldg(m + 2 * fc);
                    wgbs::load_words<W>(words, (int64_t)(c + k) * fc + r, w[k]);
                }
            }
#pragma unroll
            for (int k = 0; k < U; ++k)
                add_row<W>(pm, d, tile, site0, prel[k], lw[k], n[k], w[k],
                           g_max);
        }
    }
    __syncthreads();

    wgbs::store_tile<THREADS>(pm, d, s_warp, tile, site0, window_len, out);
}

template <int W>
int launch_tiles(const void* c0, const void* c1, const void* meta,
                 const void* words, void* out, int64_t num_tiles,
                 int64_t window_len, int64_t tile, int64_t fc, int64_t g_max,
                 void* stream) {
    // a big slab's tile holds ~3 chunks; at most 40 registers with no spills
    constexpr int U = W == 2 ? 3 : (W == 4 ? 2 : 1);
    return wgbs::launch(tiles_v2_kernel<W, U>, dim3((unsigned)num_tiles),
                        THREADS, (size_t)wgbs::tile_smem_words((int)tile) * sizeof(int),
                        stream,
                        (const int*)c0, (const int*)c1, (const int*)meta,
                        (const uint32_t*)words, (int2*)out, window_len,
                        (int)tile, (int)fc, (int)g_max);
}

}  // namespace

extern "C" {

// w_cols other than 2, 4 or 8 returns cudaErrorInvalidValue (the wrapper
// checks it first).
int pileup_tiles_v2(const void* c0, const void* c1, const void* meta,
                    const void* words, void* out, int64_t num_tiles,
                    int64_t window_len, int64_t tile, int64_t fc,
                    int64_t g_max, int64_t w_cols, void* stream) {
    switch (w_cols) {
        case 2:
            return launch_tiles<2>(c0, c1, meta, words, out, num_tiles,
                                   window_len, tile, fc, g_max, stream);
        case 4:
            return launch_tiles<4>(c0, c1, meta, words, out, num_tiles,
                                   window_len, tile, fc, g_max, stream);
        case 8:
            return launch_tiles<8>(c0, c1, meta, words, out, num_tiles,
                                   window_len, tile, fc, g_max, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

}  // extern "C"
