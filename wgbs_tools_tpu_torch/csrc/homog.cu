// Hand-written Hopper (sm_90a) kernel for homog's read-level binning
// (wgbs_tools_tpu_torch/ops/frag_ops.py::homog_bins):
//
//   codes   u8  [F][L]     a slab's calls, T=0 C=1 H=2 '.'=3
//   fstart  i32 [F]        each fragment's first site (1-based)
//   flen    i32 [F]        its length in sites
//   fcount  i32 [F]        its count
//   bstart  i64 [B]        the blocks' [startCpG, endCpG)
//   bend    i64 [B]
//   fi, bi  i32 [P]        the (fragment, block) overlap pairs
//                          (frag_ops.py::overlap_pairs, on the host: by
//                          fragment, then block), in any order here
//   ranges  f32 [nbins+1]  the bin edges, increasing, 0 first and 1 last
//   out     i64 [B][nbins] read counts per block and bin, added to in place
//
// Per pair: the fragment's calls inside the clip [off, off + length) (the
// whole fragment with `inclusive`, else its overlap with the block) give
// nrC (C or H) and nrT (T). The pair counts when the clip's length (the
// fragment's with `inclusive`) and informative = nrC + nrT are both >=
// min_cpgs and informative > 0. Its bin is the number of edges <= meth =
// nrC / informative, an IEEE float32 division (__fdiv_rn; the source is
// built without fast math), minus 1, capped at nbins - 1: numpy's
// searchsorted(ranges, meth, side="right") - 1, so a meth equal to an edge
// goes to the bin above it and meth 1.0 to the last. Then out[b][bin] +=
// count. Replaces wgbs_tools_tpu/ops/frag_ops.py::_homog_kernel_jax (:204),
// which gathers codes[fi] on the host and runs the clip, counts, bins and
// a segment_sum in XLA.
//
// Bound: bytes. The pairs, the reached fragments' clips and columns, the
// reached blocks' bounds are read once and each (block, bin) cell that
// gets a count is read and written once. The earlier body (a thread a
// pair) read the clip a byte at a time, looped over the edges in global
// memory and issued one 64-bit global atomicAdd a passing pair. With its
// global atomic taken out it ran nearly as long (`kernel_ab.py --kernels
// homog_bins` times that probe beside it): a pair is held back by its
// instructions and by its chain of dependent loads more than by the
// atomics. So the design cuts each pair's instructions and keeps every
// warp's loads in flight, the same body for every row length:
// - Chunks a warp owns. A warp takes CHUNK consecutive pairs at a time
//   (grid-strided over the warps of SMs x CTAS_PER_SM CTAs, no barrier
//   after the start); lane l takes pairs l, l + 32, ... of it, and issues
//   each pair's loads (its pair, columns, block bounds and the first
//   PREFETCH_WORDS words of its row) before it uses any.
// - A shared-memory window a warp. The chunk's counts go into the warp's
//   WINDOW_CELLS (block, bin) cells from b0, the least block of its first
//   32 pairs: two 32-bit shared atomics a pair (the sums of the low and
//   of the high 16 bits of the counts, the second only where a count
//   passes 2^16; a chunk adds at most CHUNK counts into a cell, so
//   neither sum passes 2^24 and the cell's count, hi 2^16 + lo, is exact
//   for any int32 counts). Once the chunk is counted, each nonzero cell up
//   to the last one added to is added to `out` by one global 64-bit
//   atomicAdd (the window is a contiguous range of `out`) and zeroed:
//   one global atomic a (chunk, cell). A pair whose block lies outside
//   the window's WINDOW_CELLS / nbins blocks (blocks out of order or
//   overlapping, pairs unsorted, a wide nbins) adds straight into `out`,
//   so any order stays exact.
// - Clips by masks over 8-byte words. A row is read as the 8-byte aligned
//   words from its address rounded down (r = its address mod 8): any L
//   and any alignment. Each word gives a T flag (byte 0) and a C-or-H
//   flag (byte 1 or 2; any other byte neither) a byte by SWAR tests,
//   gathered into 8 bits by one multiply; the clip's counts are __popc of
//   the flags under its bit range [r + c0, r + c1). The first
//   PREFETCH_WORDS words (a clip within them: every row of L <= 25, the
//   main path's 24) are loaded with the pair; a clip's words past them
//   are loaded a word at a time after its bounds. Only words that hold a
//   byte of the row are read (an aligned 8-byte word never crosses a
//   page), and the bytes outside the clip are masked off.
// - The bin by table. Each CTA tabulates bin + 1 of every nrC / informative
//   with informative <= min(L, TABLE_CALLS) once (nbins < 256), by the
//   float32 division and the count of the edges; other pairs divide and
//   count the edges (shared memory: a linear count for nbins <=
//   LINEAR_BINS, a binary search above, the same count on increasing
//   edges; EDGES_MAX edges, more read from global memory).
//
// With `stats` (homog_bins_stats), the kernel adds [chunks, pairs added
// straight into out, passing pairs, global atomics] into stats, int64[4],
// one atomicAdd a warp at the end; homog_bins passes none (the same
// kernel: it counts either way).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARP = 32;
constexpr int NWARPS = THREADS / WARP;
constexpr int PER = 8;                // pairs a lane takes a chunk
constexpr int CHUNK = WARP * PER;     // pairs a warp takes at a time
constexpr int WINDOW_CELLS = 256;     // (block, bin) cells of a window
constexpr int EDGES_MAX = 256;        // edges kept in shared memory
constexpr int LINEAR_BINS = 8;        // up to this nbins the bin is a count
constexpr int TABLE_CALLS = 64;       // informative counts whose bins are
                                      // looked up (nbins < 256)
constexpr int PREFETCH_WORDS = 4;     // 8-byte words of a row loaded with
                                      // its pair
constexpr int CTAS_PER_SM = 3;

// The T and the C-or-H flags of the 8 bytes of x (bit j: byte j): T where
// the byte is 0, C or H where it is 1 or 2. Each test leaves its answer in
// bit 7 of the byte: (x & 0x7C) + 0x7F reaches bit 7 where a bit 2-6 is
// set, and never carries into the next byte; x << 7 and x << 6 bring bits
// 0 and 1 there. One multiply gathers bit 8j + 7 into bit 56 + j (the
// other products land on distinct bits below 56 or past 63, so no carry).
__device__ __forceinline__ void call_flags(uint64_t x, uint32_t& t,
                                           uint32_t& ch) {
    constexpr uint64_t HIGH = 0x8080808080808080ull;
    constexpr uint64_t GATHER = 0x0002040810204081ull;
    const uint64_t small =
        ~(((x & 0x7C7C7C7C7C7C7C7Cull) + 0x7F7F7F7F7F7F7F7Full) | x) & HIGH;
    const uint64_t b0 = x << 7, b1 = x << 6;
    t = (uint32_t)(((small & ~(b0 | b1)) * GATHER) >> 56);
    ch = (uint32_t)(((small & (b0 ^ b1)) * GATHER) >> 56);
}

// numpy's searchsorted(edges, meth, side="right") - 1, capped at nbins -
// 1: the edges <= meth counted (nbins <= LINEAR_BINS) or found by a binary
// search (the same count on increasing edges).
__device__ __forceinline__ int bin_of(float meth, const float* edges,
                                      int nbins) {
    int le = 0;
    if (nbins <= LINEAR_BINS) {
#pragma unroll
        for (int k = 0; k <= LINEAR_BINS; ++k)
            if (k <= nbins) le += edges[k] <= meth;
    } else {
        int hi = nbins + 1;
        while (le < hi) {
            const int mid = (le + hi) / 2;
            if (edges[mid] <= meth)
                le = mid + 1;
            else
                hi = mid;
        }
    }
    return le - 1 < nbins - 1 ? le - 1 : nbins - 1;
}

// npf: the prefetched words that can hold a row's bytes, the same for
// every row (min(PREFETCH_WORDS, ceil((r_max + L) / 8)), r_max the most a
// row's address passes a multiple of 8).
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
homog_bins_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ fstart,
                  const int* __restrict__ flen,
                  const int* __restrict__ fcount,
                  const int64_t* __restrict__ bstart,
                  const int64_t* __restrict__ bend,
                  const int* __restrict__ fi, const int* __restrict__ bi,
                  const float* __restrict__ ranges,
                  unsigned long long* __restrict__ out,
                  unsigned long long* __restrict__ stats, int64_t P,
                  int64_t L, int64_t nbins, int64_t min_cpgs,
                  bool inclusive, int npf) {
    // each warp's window: a cell's sums of the low and of the high 16 bits
    // of its counts
    __shared__ unsigned s_lo[NWARPS][WINDOW_CELLS];
    __shared__ int s_hi[NWARPS][WINDOW_CELLS];
    __shared__ float s_edges[EDGES_MAX];
    // bin + 1 of nrC / informative, at [informative][nrC] for informative
    // up to tc = min(L, TABLE_CALLS) (0 where nrC > informative or
    // informative is 0; 0 also a bin of -1)
    __shared__ uint8_t s_bin[(TABLE_CALLS + 1) * (TABLE_CALLS + 1)];
    const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
    unsigned* w_lo = s_lo[warp];
    int* w_hi = s_hi[warp];
    for (int i = lane; i < WINDOW_CELLS; i += WARP) {
        w_lo[i] = 0u;
        w_hi[i] = 0;
    }
    const bool edges_in = nbins + 1 <= EDGES_MAX;
    if (edges_in)
        for (int i = threadIdx.x; i <= nbins; i += THREADS)
            s_edges[i] = ranges[i];
    __syncthreads();  // the edges are in
    const float* edges = edges_in ? s_edges : ranges;
    const int Li = (int)L, nb = (int)nbins;
    const bool tabled = nb < 256;
    const int tc = Li < TABLE_CALLS ? Li : TABLE_CALLS;
    if (tabled) {
        for (int i = threadIdx.x; i < (tc + 1) * (tc + 1); i += THREADS) {
            const int inf = i / (tc + 1), c = i % (tc + 1);
            s_bin[i] = c <= inf && inf > 0
                           ? (uint8_t)(bin_of(__fdiv_rn((float)c, (float)inf),
                                              edges, nb) + 1)
                           : 0;
        }
        __syncthreads();  // the table is in (the last barrier)
    }
    // the blocks a window holds from b0: its cells are (b - b0) nb + bin
    const int win_blocks = nb <= WINDOW_CELLS ? WINDOW_CELLS / nb : 0;
    // the stats: pairs added straight into out, passing pairs, flush
    // atomics
    unsigned n_direct = 0, n_pass = 0, n_flush = 0;

    const int64_t n_chunks = (P + CHUNK - 1) / CHUNK;
    const int64_t first = (int64_t)blockIdx.x * NWARPS + warp;
    const int64_t step = (int64_t)gridDim.x * NWARPS;
    for (int64_t c = first; c < n_chunks; c += step) {
        const int64_t p0 = c * CHUNK;
        // the window: blocks from b0, the least of its first WARP pairs'
        // (sorted pairs: the chunk's least but where a fragment's run of
        // more than WARP pairs is cut by the chunk's start), on
        const int n_here = (int)(P - p0 < CHUNK ? P - p0 : CHUNK);
        const int64_t q = p0 + lane;
        const int b0 =
            __reduce_min_sync(~0u, lane < n_here ? __ldg(bi + q) : INT32_MAX);
        int top = -1;  // the last window cell this lane added to
        for (int k = 0; k < PER; ++k) {
            if (k * WARP + lane >= n_here) break;
            // all the pair reads, at once: its columns, its block's bounds
            // and its row's first words (those that hold a byte of it)
            const int f = __ldg(fi + q + k * WARP);
            const int b = __ldg(bi + q + k * WARP);
            const int s = __ldg(fstart + f), ln = __ldg(flen + f);
            const int cnt = __ldg(fcount + f);
            int64_t bs = 0, be = 0;
            if (!inclusive) {
                bs = __ldg(bstart + b);
                be = __ldg(bend + b);
            }
            const uint8_t* row = codes + (int64_t)f * L;
            const int r = (int)((uintptr_t)row & 7);
            const unsigned long long* words =
                reinterpret_cast<const unsigned long long*>(row - r);
            uint64_t x[PREFETCH_WORDS];
#pragma unroll
            for (int w = 0; w < PREFETCH_WORDS; ++w)
                x[w] = w < npf && 8 * w < r + Li ? __ldg(words + w) : 0ull;
            // the clip [c0, c1) of the row, and its length (the gate)
            int64_t len = ln;
            int c0 = 0;
            if (!inclusive) {
                const int64_t os = s > bs ? s : bs;
                const int64_t oe = (int64_t)s + ln < be ? (int64_t)s + ln : be;
                len = oe - os;
                c0 = (int)(os - s < L ? os - s : L);
            }
            if (len < min_cpgs) continue;
            const int c1 = (int)(c0 + len < Li ? c0 + len : Li);
            // the clip's bytes [lo, hi) from the row's aligned words
            const int lo = r + c0, hi = r + c1;
            int nrC = 0, nrT = 0;
            if (lo < hi && lo < 8 * PREFETCH_WORDS) {
                uint32_t t = 0, ch = 0;
#pragma unroll
                for (int w = 0; w < PREFETCH_WORDS; ++w) {
                    if (w >= npf) break;
                    uint32_t tw, cw;
                    call_flags(x[w], tw, cw);
                    t |= tw << (8 * w);
                    ch |= cw << (8 * w);
                }
                const int e = hi < 8 * PREFETCH_WORDS ? hi : 8 * PREFETCH_WORDS;
                const uint32_t m =
                    (uint32_t)(((1ull << e) - 1) & ~((1ull << lo) - 1));
                nrT = __popc(t & m);
                nrC = __popc(ch & m);
            }
            // the clip's words past the prefetched ones, one at a time
            for (int w = lo / 8 > PREFETCH_WORDS ? lo / 8 : PREFETCH_WORDS;
                 8 * w < hi; ++w) {
                uint32_t tw, cw;
                call_flags(__ldg(words + w), tw, cw);
                const int a = lo - 8 * w > 0 ? lo - 8 * w : 0;
                const int e = hi - 8 * w < 8 ? hi - 8 * w : 8;
                const uint32_t m = ((1u << e) - 1) & ~((1u << a) - 1);
                nrT += __popc(tw & m);
                nrC += __popc(cw & m);
            }
            const int informative = nrC + nrT;
            if (informative < min_cpgs || informative <= 0) continue;
            const int bin =
                tabled && informative <= tc
                    ? s_bin[informative * (tc + 1) + nrC] - 1
                    : bin_of(__fdiv_rn((float)nrC, (float)informative),
                             edges, nb);
            if (bin < 0) continue;  // guards memory only: edges start at 0
            ++n_pass;
            const unsigned db = (unsigned)(b - b0);  // b, b0 >= 0
            if (db < (unsigned)win_blocks) {
                const int cell = (int)db * nb + bin;
                atomicAdd(w_lo + cell, (unsigned)cnt & 0xFFFFu);
                if (cnt >> 16) atomicAdd(w_hi + cell, cnt >> 16);
                top = top > cell ? top : cell;
            } else {  // outside the window: straight into out
                atomicAdd(out + (int64_t)b * nbins + bin,
                          (unsigned long long)(long long)cnt);
                ++n_direct;
            }
        }
        // the flush: the window is out[b0 * nbins + i], i <= top; the
        // warp's shared adds are ordered before its reads
        __syncwarp();
        top = __reduce_max_sync(~0u, top);
        unsigned long long* dst = out + (int64_t)b0 * nbins;
        for (int i = lane; i <= top; i += WARP) {
            const unsigned lo = w_lo[i];
            const int hi = w_hi[i];
            if (lo | (unsigned)hi) {
                const long long v = (long long)hi * 65536 + lo;
                if (v) {
                    atomicAdd(dst + i, (unsigned long long)v);
                    ++n_flush;
                }
                w_lo[i] = 0u;
                w_hi[i] = 0;
            }
        }
        __syncwarp();  // the window is zero again
    }
    if (stats) {
        // this warp's chunks: first, first + step, ... below n_chunks
        const unsigned chunks =
            first < n_chunks ? (unsigned)((n_chunks - 1 - first) / step + 1)
                             : 0u;
        unsigned n[4] = {lane == 0 ? chunks : 0u, n_direct, n_pass,
                         n_direct + n_flush};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            n[i] = __reduce_add_sync(~0u, n[i]);
            if (lane == 0 && n[i]) atomicAdd(stats + i, n[i]);
        }
    }
}

int launch(const void* codes, const void* fstart, const void* flen,
           const void* fcount, const void* bstart, const void* bend,
           const void* fi, const void* bi, const void* ranges, void* out,
           void* stats, int64_t P, int64_t L, int64_t nbins,
           int64_t min_cpgs, int64_t inclusive, void* stream) {
    if (P < 0 || L < 1 || L > INT32_MAX / 2 || nbins < 1 ||
        nbins > INT32_MAX / 2)
        return (int)cudaErrorInvalidValue;
    if (P == 0) return 0;
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, homog_bins_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    const int64_t ctas = (P + (int64_t)CHUNK * NWARPS - 1) / (CHUNK * NWARPS);
    const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(ctas < most ? ctas : most);
    // rows at one offset mod 8 when L is a multiple of 8, else any
    const int64_t r_max = L % 8 == 0 ? (int64_t)((uintptr_t)codes & 7) : 7;
    const int64_t row_words = (r_max + L + 7) / 8;
    const int npf =
        (int)(row_words < PREFETCH_WORDS ? row_words : PREFETCH_WORDS);
    homog_bins_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int*)fstart, (const int*)flen,
        (const int*)fcount, (const int64_t*)bstart, (const int64_t*)bend,
        (const int*)fi, (const int*)bi, (const float*)ranges,
        (unsigned long long*)out, (unsigned long long*)stats, P, L, nbins,
        min_cpgs, inclusive != 0, npf);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// P < 0, L < 1 or nbins < 1 returns cudaErrorInvalidValue; P == 0
// launches nothing. Launches on `stream` on the current device, on at most
// SMs x the CTAs an SM holds (chunks grid-strided over their warps).
int homog_bins(const void* codes, const void* fstart, const void* flen,
               const void* fcount, const void* bstart, const void* bend,
               const void* fi, const void* bi, const void* ranges, void* out,
               int64_t P, int64_t L, int64_t nbins, int64_t min_cpgs,
               int64_t inclusive, void* stream) {
    return launch(codes, fstart, flen, fcount, bstart, bend, fi, bi, ranges,
                  out, nullptr, P, L, nbins, min_cpgs, inclusive, stream);
}

// The same launch, adding [chunks, pairs added straight into out, passing
// pairs, global atomics] into stats (int64[4]).
int homog_bins_stats(const void* codes, const void* fstart, const void* flen,
                     const void* fcount, const void* bstart, const void* bend,
                     const void* fi, const void* bi, const void* ranges,
                     void* out, void* stats, int64_t P, int64_t L,
                     int64_t nbins, int64_t min_cpgs, int64_t inclusive,
                     void* stream) {
    return launch(codes, fstart, flen, fcount, bstart, bend, fi, bi, ranges,
                  out, stats, P, L, nbins, min_cpgs, inclusive, stream);
}

}  // extern "C"
