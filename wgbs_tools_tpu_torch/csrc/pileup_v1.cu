// Hand-written Hopper (sm_90a) kernels for the v1 staged pileup
// (wgbs_tools_tpu_torch/ops/pileup_v1.py, the host prep of
// wgbs_tools_tpu/ops/pileup_tpu.py::pileup_pallas): one fragment per row,
// not split, rows padded to whole chunks of fc.
//
//   lo, hi  int32 [num_tiles]        fragment rows [lo[t], hi[t]) that can reach
//                                    output tile t (a host searchsorted that looks
//                                    back max_len - 1 sites, lo rounded down to
//                                    its chunk)
//   meta    int32 [n_chunks][4][fc]  [c][0][r] = start relative to the window
//                                    (2^30 on padding rows), [c][1][r] = length,
//                                    [c][2][r] = repeat count, [c][3][r] = 0;
//                                    row f is chunk f / fc, position f % fc
//   words   int32 [n_chunks*fc][w16] 2-bit planar codes, w16 = max_len / 16:
//                                    code j of the fragment is
//                                    (word[j % w16] >> 2*(j / w16)) & 3
//
// and write the (window_len, 2) int32 [meth, cov] pileup of the window:
// meth += count where the code is C(1) or H(2); cov += count where it is not
// '.'(3), at site start + j for j < min(length, 16 * w16) -- ref
// stdin2beta.cpp:59-93.
//
// Replaces wgbs_tools_tpu/ops/pileup_tpu.py::_pileup_kernel. The TPU kernel
// runs a grid of (tile, chunk) steps in order, rolls every row of a chunk
// across a (tile + 2 * max_len)-lane accumulator with a barrel shifter and
// carries the accumulator from chunk to chunk. Hopper blocks run in no set
// order, so nothing carries: CTA t walks the rows [lo[t], hi[t]) itself and
// adds their sites in tile t into shared memory (frag_tile.cuh), and every
// site is written by exactly one CTA, zeros where no row reaches it. No
// global atomics, no memset, one launch; a tile with no row of its own
// still takes the rows from behind it. Exactly: row f in [lo[t], hi[t]) adds
// its sites start + j, j < min(length, 16 * w16), that lie in tile t and in
// the window, whatever its start (the twin's rule, tiles_v1_plain); nothing
// assumes start order inside [lo, hi), and padding rows (length 0) and the
// rows that the chunk rounding adds before lo reach nothing.
//
// Bound: device-memory bytes, as chip_smoke.py::_work counts them (12 B of
// meta and 4 B for each word a row's codes occupy, min(length, w16) words,
// per real row; 8 B per output site); two adds per site take a few % of
// that time at the 32-bit rate. What kept the first body near a third of
// it was latency and issue: one thread walked one row at a time with
// dependent loads, reloaded a word and divided twice for every site, and
// took two shared atomics per site; a long row was one thread's loop,
// while its warp-mates idled. This body:
// - Reads each row only as far as it needs: every row of [lo, hi) loads its
//   4-B start (coalesced across threads); only a row that can reach the
//   tile (start in (site0 - 16 * w16, site0 + tile)) loads its length and
//   count, and only a row that does reach it loads its words. In the rows
//   behind the tile (the look-back and the chunk rounding, ~1 in 5 of a big
//   tile's walked rows) that saves all but the start.
// - Adds a row in a few operations: +count / -count at the ends of its
//   in-tile interval into the difference array, and count at its T and '.'
//   sites only, found as bit masks of its words (frag_tile.cuh).
// - Short rows (w16 8 or 16: max_len 128 or 256, the big and deep slabs):
//   one thread per row, as in pileup_v2.cu. Its words load as one or two
//   16-B vectors per 8 words (the wrapper refuses words not 16-B aligned),
//   and code j = field j / w16 of word j % w16 is pileup_v2.cu's decode with
//   W = w16 a template parameter: no per-site load or division. A thread
//   issues the loads of its row (length, count and words together for a row
//   that starts in the tile) before it adds any.
// - Long rows (any other w16, e.g. 24, 40 or 128: nanopore rows of
//   thousands of sites): a listing pass, as pileup_v3.cu's pile_codes has,
//   writes the reaching rows of each 256 walked rows to shared memory (row,
//   in-tile interval, count; a warp ballot and per-warp counts), and then a
//   warp takes one listed row. Lane l loads words l, l + 32, ... below
//   min(j1, w16), the words that hold a site of the interval (coalesced
//   128-B loads), and keeps each word's fields whose site f * w16 + w lies
//   in the interval: the interval's ends are divided by w16 once per row,
//   and a word's field range is two compares. Lanes hold consecutive
//   sites, so a warp's shared atomics land on different banks. A row that
//   spans k tiles is loaded by k CTAs; neighbouring tiles run at about the
//   same time, so the repeats are mostly L2 hits. This form is correct at
//   every w16, but at w16 8 only 8 lanes of a warp hold a row's words and a
//   warp takes its rows one at a time: on the big and deep slabs it takes
//   7.8x / 3.7x the thread-per-row form's time (kernel_ab.py --listed,
//   PERF.md), which is why both forms stay. It is left untuned: no
//   long-read traffic with a public source has been timed yet.
// Balance: 256 threads and (3 x tile + 4) x 4 B = 12 KB of shared memory
// per CTA (the long form 5 KB more for the list). The launch bounds ask for
// 7 CTAs per SM (at most 36 registers) for w16 8, 4 (64) for w16 16,
// whose row holds 16 words in registers, and 8 (32), the thread limit,
// for the long form: with no minimum, ptxas gives that form 40 registers
// and 6 CTAs per SM, and it runs slower on big and deep (kernel_ab.py
// --listed 1,8; PERF.md).
//
// No entry point sets the CUDA device (see launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "frag_tile.cuh"
#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LONG_BLOCKS = 8;  // CTAs per SM the long form's bound asks for

// Row f's start, length and count: meta[f / fc][k][f % fc].
__device__ __forceinline__ const int* row_meta(const int* __restrict__ meta,
                                               int f, int fc) {
    return meta + f + (int64_t)(f / fc) * 3 * fc;
}

// Adds the rows of [f, f1) with a stride of THREADS that reach tile t
// (site0 = t * tile), of at most 16 * W sites: a thread per row.
template <int W>
__device__ __forceinline__ void pile_rows(uint32_t* pm, uint32_t* d,
                                          int tile, int64_t site0, int f,
                                          int f1,
                                          const int* __restrict__ meta,
                                          const uint32_t* __restrict__ words,
                                          int fc) {
    for (; f < f1; f += THREADS) {
        const int* m = row_meta(meta, f, fc);
        const int64_t off = (int64_t)__ldg(m) - site0;
        // in the tile: load the rest at once; behind it: the length first
        int len = 0, n = 0;
        uint32_t w[W];
#pragma unroll
        for (int q = 0; q < W; ++q) w[q] = 0u;
        if (off >= 0 && off < tile) {
            len = __ldg(m + fc);
            n = __ldg(m + 2 * fc);
            wgbs::load_words<W>(words, f, w);
        } else if (off < 0 && off > -16 * W) {
            len = __ldg(m + fc);
            if (off + min(len, 16 * W) > 0) {
                n = __ldg(m + 2 * fc);
                wgbs::load_words<W>(words, f, w);
            }
        }
        const int64_t end = off + min(len, 16 * W);  // one past its last site
        if (end <= max(off, (int64_t)0) || off >= tile) continue;
        // now off is in (-16 * W, tile): tile sites o + j, j in [j0, j1)
        const int o = (int)off;
        wgbs::add_sites<W>(pm, d, tile, o, max(0, -o),
                           (int)min(end, (int64_t)tile) - o, (uint32_t)n, w);
    }
}

// Adds a listed row e = (o, j0, j1, count) at tile sites o + j, j in
// [j0, j1): word w of the row holds sites f * w16 + w, f < 16. Lane l of the
// warp takes the words l, l + 32, ... below min(j1, w16) and keeps each
// word's fields f in [q0 + (w < r0), q1 + (w < r1)), where j0 = q0 * w16 + r0
// and j1 = q1 * w16 + r1: the T and '.' fields as a bit mask (bit 2f),
// walked by __ffs.
__device__ __forceinline__ void add_long_row(uint32_t* pm, uint32_t* d,
                                             int tile, int w16,
                                             const uint32_t* __restrict__ wp,
                                             int4 e, int lane) {
    const int o = e.x, j0 = e.y, j1 = e.z;
    const uint32_t n = (uint32_t)e.w;
    if (lane == 0) {
        atomicAdd(d + o + j0, n);
        atomicAdd(d + o + j1, 0u - n);
    }
    const int q0 = j0 / w16, r0 = j0 - q0 * w16;
    const int q1 = j1 / w16, r1 = j1 - q1 * w16;
    const int nw = min(j1, w16);  // the words with a site below j1
    for (int w = lane; w < nw; w += 32) {
        const uint32_t v = __ldg(wp + w);
        const int flo = q0 + (w < r0), fhi = q1 + (w < r1);
        if (flo >= fhi) continue;
        const uint32_t blo = v & wgbs::EVEN, bhi = (v >> 1) & wgbs::EVEN;
        const uint32_t dot = blo & bhi;                  // '.': bits 2f
        const uint32_t tee = ~(blo | bhi) & wgbs::EVEN;  // T
        uint32_t m = (dot | tee) &
                     (uint32_t)((1ull << 2 * fhi) - (1ull << 2 * flo));
        uint32_t* at = pm + o + w;
        while (m) {
            const int p = __ffs(m) - 1;
            m &= m - 1;
            atomicAdd(at + (p >> 1) * w16 + ((dot >> p) & 1u) * tile, n);
        }
    }
}

// Adds the rows of [f0, f1) that reach tile t (site0 = t * tile), of any
// width (w16 words): a listing pass over each THREADS rows, then a warp per
// listed row. All threads of the CTA.
__device__ __forceinline__ void pile_listed(uint32_t* pm, uint32_t* d,
                                            uint32_t* s_warp, int tile,
                                            int64_t site0, int f0, int f1,
                                            const int* __restrict__ meta,
                                            const uint32_t* __restrict__ words,
                                            int fc, int w16) {
    __shared__ int s_row[THREADS];   // the list: row,
    __shared__ int4 s_ent[THREADS];  // (o, j0, j1, count)
    const int max_len = 16 * w16;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    for (; f0 < f1; f0 += THREADS) {
        const int f = f0 + (int)threadIdx.x;
        int4 e = make_int4(0, 0, 0, 0);
        if (f < f1) {
            const int* m = row_meta(meta, f, fc);
            const int64_t off = (int64_t)__ldg(m) - site0;
            if (off > -max_len && off < tile) {
                const int len = min(__ldg(m + fc), max_len);
                e = make_int4((int)off, max(0, (int)-off),
                              (int)min((int64_t)len + off, (int64_t)tile) -
                                  (int)off,
                              __ldg(m + 2 * fc));
            }
        }
        const bool reach = e.y < e.z;
        const unsigned ball = __ballot_sync(~0u, reach);
        if (lane == 0) s_warp[warp] = __popc(ball);
        __syncthreads();
        int pos = __popc(ball & ((1u << lane) - 1u)), listed = 0;
#pragma unroll
        for (int k = 0; k < WARPS; ++k) {
            const int c = (int)s_warp[k];
            pos += k < warp ? c : 0;
            listed += c;
        }
        if (reach) {
            s_row[pos] = f;
            s_ent[pos] = e;
        }
        __syncthreads();
        // warp i takes listed rows i, i + WARPS, ...; the next pass lists
        // only after every warp is done here (its first barrier), and
        // s_warp is read by now
        for (int i = warp; i < listed; i += WARPS)
            add_long_row(pm, d, tile, w16,
                         words + (int64_t)s_row[i] * w16, s_ent[i], lane);
    }
}

// CTA t: tile t of the pileup. W = w16 (8 or 16) for the thread-per-row
// form, 0 for the warp-per-row form of any w16.
template <int W, int BLOCKS>
__global__ void __launch_bounds__(THREADS, BLOCKS)
tiles_v1_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                const int* __restrict__ meta,
                const uint32_t* __restrict__ words, int2* __restrict__ out,
                int64_t window_len, int tile, int fc, int w16) {
    extern __shared__ int4 smem4[];
    uint32_t* pm = reinterpret_cast<uint32_t*>(smem4);  // then pc
    uint32_t* d = pm + 2 * tile;
    __shared__ uint32_t s_warp[WARPS];
    const int t = blockIdx.x;
    const int64_t site0 = (int64_t)t * tile;
    const int f0 = __ldg(lo + t), f1 = __ldg(hi + t);
    wgbs::zero_tile(smem4, tile);
    __syncthreads();
    if constexpr (W > 0)
        pile_rows<W>(pm, d, tile, site0, f0 + (int)threadIdx.x, f1, meta,
                     words, fc);
    else
        pile_listed(pm, d, s_warp, tile, site0, f0, f1, meta, words, fc,
                    w16);
    __syncthreads();
    wgbs::store_tile<THREADS>(pm, d, s_warp, tile, site0, window_len, out);
}

template <int W, int BLOCKS>
int launch_tiles(const void* lo, const void* hi, const void* meta,
                 const void* words, void* out, int64_t num_tiles,
                 int64_t window_len, int64_t tile, int64_t fc, int64_t w16,
                 void* stream) {
    return wgbs::launch(tiles_v1_kernel<W, BLOCKS>, dim3((unsigned)num_tiles),
                        THREADS,
                        (size_t)wgbs::tile_smem_words((int)tile) * sizeof(int),
                        stream, (const int*)lo, (const int*)hi,
                        (const int*)meta, (const uint32_t*)words, (int2*)out,
                        window_len, (int)tile, (int)fc, (int)w16);
}

}  // namespace

extern "C" {

// w16 8 and 16 take the thread-per-row form (words 16-B aligned: the wrapper
// checks it), any other w16 the warp-per-row form.
int pileup_tiles_v1(const void* lo, const void* hi, const void* meta,
                    const void* words, void* out, int64_t num_tiles,
                    int64_t window_len, int64_t tile, int64_t fc, int64_t w16,
                    void* stream) {
    if (w16 == 8)
        return launch_tiles<8, 7>(lo, hi, meta, words, out, num_tiles,
                                  window_len, tile, fc, w16, stream);
    if (w16 == 16)
        return launch_tiles<16, 4>(lo, hi, meta, words, out, num_tiles,
                                   window_len, tile, fc, w16, stream);
    return launch_tiles<0, LONG_BLOCKS>(lo, hi, meta, words, out,
                                        num_tiles, window_len, tile, fc, w16,
                                        stream);
}

}  // extern "C"
