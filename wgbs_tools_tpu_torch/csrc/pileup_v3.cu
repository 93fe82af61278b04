// Hand-written Hopper (sm_90a) kernels for the pat2beta pileup.
//
// Every kernel consumes the staged batch of wgbs_tools_tpu_torch/ops/pileup_v3.py
// (the same layout as wgbs_tools_tpu/ops/pileup_tpu3.py::stage_v3):
//
//   c0, c1  int32 [num_tiles]          chunk range [c0[t], c1[t]) of output tile t
//   meta    int32 [n_chunks][2][rc]    [c][0][r] = repeat count of row r (classic
//                                      form), [c][1][r] = dg, the row's sub-block
//                                      offset from the chunk's base; dg outside
//                                      [0, g_max) marks a padding row, and the
//                                      padding row rc-1 stashes base_g + g_max
//   rows    one row per 128-site sub-block slice:
//           value planes: uint8 meth values (count where the code is a
//                         methylation call) and cov values (count where the site
//                         is observed), either fused side by side in one
//                         [n_chunks*rc][256] plane (lanes 0-127 meth, 128-255
//                         cov) or split into two [n_chunks*rc][128] planes
//           flat_classic, tiled_classic, flat_lc: int32 [n_chunks*rc][8], 2-bit
//                         planar codes: site l of the sub-block is
//                         (word[l % 8] >> 2*(l / 8)) & 3
//   cnts    flat_lc only: int32 [n_chunks*rc][32] per-lane 8-bit counts: the
//           count of lane l is (cnts[row][l % 32] >> 8*(l / 32)) & 255
//
// and write the (window_len, 2) int32 [meth, cov] pileup of the window, or, for
// flat_vals_add, add it into a given (window_len, 2) int32 total.
//
// Every kernel adds integers only (no tensor cores): counts stay exact, and
// neither the grouping nor the order of integer adds (atomics included)
// changes the bits; int32 sums wrap as the twins' int32 index_add_ does.
// A flat kernel writes every site of the window, zeros for a tile with no
// chunk (so the wrapper allocates the output with torch.empty), except
// flat_vals_add, which leaves a chunkless tile's rows of the total as they
// were.
//
// Bound of the code-word kernels (flat_classic, flat_lc, tiled_classic):
// device-memory bytes, as chip_smoke.py::_work counts them (36 B per real
// classic row, 160 B per real lane-count row, 4 B of dg per staged row of a
// visited chunk, 8 B per output site); their decode is ~4 integer
// operations per site of a real row, about half the bytes' time. Two
// things keep a kernel off that floor whatever its body: the rc classes
// (16, 128) are two launches per batch, and each writes (flat) or memsets
// and atomically adds into (tiled) the whole window, while the bound counts
// the output once. The first body (one thread per lane, a 4-B load of word
// l % 8 per thread per row, rows one after another, a data-dependent branch
// between each row's dg and its loads) ran at ~9-17 % of the bound (PERF.md,
// PR 4). This body (pile_codes) does four things about it:
// - Listing: a pass over the tile's (or, tiled, the chunk's) staged rows,
//   one coalesced 4-B dg load per thread, lists the real rows (dg in
//   [0, g_max), sub-block in the tile) in order in shared memory (a warp
//   ballot and a per-warp count), with the classic form's row counts, up
//   to CWIN = 512 rows at a time; padding rows and rows outside the tile
//   are never loaded again, and rc-16 chunks no longer leave threads idle.
// - A row split across threads: 8 threads per row, thread j owning code
//   word j (sites j, j + 8, ..., j + 120) and, in the lane form, count words
//   j, j + 8, j + 16, j + 24 (site j + 8k's count is byte k / 4 of word
//   j + 8 (k % 4)); a warp's load covers 4 rows, 128 contiguous bytes of
//   words, and each count-word load 32 contiguous bytes per row. 4-B loads
//   rather than 16-B ones: a row's words are 32 B, so a 16-B split would
//   leave 2 threads per row decoding 64 sites each (64 int32 sums, past the
//   register budget of 6 CTAs per SM), and the bytes per load instruction
//   are the same 128 per warp either way.
// - Many rows in flight: the 16 row groups of a CTA each take a contiguous
//   run of the list, and each thread issues CUNROLL = 4 rows' loads before
//   it adds any (in the lane form 20 loads).
// - Sums in registers: 16 sites x (meth, cov) per thread, decoded with bit
//   masks (cov where the 2-bit code is not 3, meth where its bits differ),
//   kept as int32 in the classic form and as 16-bit halves in the lane
//   form (a byte mask of the 4 sites of one count word: one add per two
//   sites), flushed into the shared accumulator with atomicAdd when the
//   row's sub-block changes and at the end of the run (a run is at most
//   CWIN / 16 = 32 rows, 32 x 255 < 2^16, so no half carries). Staging
//   packs rows in ascending sub-block order; flush-on-change is right for
//   rows in any order (a shuffled chunk only flushes more often).
// Only the accumulator rows the listed rows reach are zeroed (the zeroed
// rows grow as one span), and the epilogue reads only those: a flat tile
// writes zeros elsewhere with 16-B stores (as vals_epilogue), and a tiled
// CTA adds just those rows' nonzero cells into the output with global
// atomics. The tiled grid is one CTA per staged chunk (each warp finds the
// chunk's tile by a 32-way search of c1; a chunk in no tile's range exits),
// in place of num_tiles x max_chunks steps that mostly exited.
// Balance: 128 threads, (tile_sb x 264 + 3 x 512) x 4 B = 14.6 KB of shared
// memory at the classic tile_sb = 8; the launch bound asks for 6 CTAs per
// SM (at most 85 registers), and ptxas gives each of the three kernels 64,
// so 8 fit. Measured (PERF.md, PR 5): 2-3.3x the first body's speed, at
// 17-58 % of the bound; what is left is latency per CTA (a tile or chunk
// holds ~100 real rows, a few dependent global loads each) and, for the
// tiled grid, the memset and global atomics of each class launch.
//
// Bound of the value-plane kernels (flat_vals_fused, flat_vals_add, and
// flat_vals on the same body): device-memory bytes. Their work is one
// integer add per plane byte, while each must move 256 B per real row, 4 B
// of dg per staged row of a visited chunk and 8 B per output site (16 for
// the add, which reads the total too); chip_smoke.py computes that floor
// (bound_ms) from each run's batches, and PERF.md gives it beside the
// measured times. A body that loads one byte per thread per row, walks a
// CTA's rows one after another and does a shared-memory read-modify-write
// per byte keeps few loads in flight and stays load-latency-bound at ~12 %
// of that floor (PERF.md); this body does three things about it:
// - Wide loads: a thread loads 16 B of a row (uint4, __ldg), 16 threads
//   (a half-warp) one whole 256-B row, neighbouring threads neighbouring
//   addresses; a warp's load instruction covers two rows.
// - Many rows in flight: the CTA stages up to WIN rows' dg (sub-block
//   offsets) in shared memory with one coalesced pass, then each half-warp
//   takes a contiguous run of those rows and issues UNROLL row loads before
//   it adds any of them (UNROLL x 16 B per thread, 32 KB per CTA, ~96 KB per
//   SM at 3 CTAs). Padding rows (dg outside [0, g_max)) and rows whose
//   sub-block lies outside the tile are never loaded.
// - Few shared-memory updates: staging packs rows in ascending sub-block
//   order, ~15 rows per sub-block, so a thread keeps its 16 lanes' running
//   sums in registers, two lanes per 32-bit register (16-bit halves, each
//   byte masked in with 0x00FF00FF: one add per two bytes), and flushes them
//   into the tile accumulator with shared-memory atomicAdd only when the
//   row's sub-block changes or 256 rows have been added (256 x 255 < 2^16, so
//   a half never carries into its neighbour). Flush-on-change is right for
//   rows in any order (a shuffled chunk only flushes more often), and the
//   integer atomics are exact in any order. The accumulator row is padded
//   to 272 ints (one int after each 16 lanes), so the 16 threads of a
//   half-warp flushing lane k of their segments hit 16 distinct banks.
// Balance: one CTA per tile, 256 threads, (64 x 272 + 1024) x 4 = 72 KB of
// shared memory at the default tile_sb = 64, so 3 CTAs share an SM and the
// big slab's 972 tiles run as ~2.5 waves of 396 CTAs; the hardware hands a
// finished CTA's SM the next tile, so the ragged tail is one tile deep
// (a persistent grid would balance no better at this granularity, and a
// smaller accumulator would force a tile's chunks apart).
// Epilogue: two sites per thread, one 16-B store of (meth, cov, meth, cov)
// where the output is 16-B aligned (8-B stores for a total that is a row
// slice only 8-B aligned, and at the window's last odd site).
//
// No entry point sets the CUDA device (see launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "launch.cuh"

namespace {

constexpr int SB = 128;       // sites per sub-block (= lanes of one row)
constexpr int ROW_W = 2 * SB; // accumulator width: meth lanes, then cov lanes

// ---------------------------------------------------------------------------
// The value-plane body (flat_vals_fused, flat_vals, flat_vals_add): see the
// design note at the top of the file.
// ---------------------------------------------------------------------------

constexpr int VT = 256;                // threads of a value-plane CTA
constexpr int SEG = 16;                // plane bytes a thread loads per row
constexpr int SEGS = ROW_W / SEG;      // threads per row: one half-warp
constexpr int GROUPS = VT / SEGS;      // row groups (half-warps) per CTA
constexpr int ACC_W = ROW_W + SEGS;    // padded accumulator row, in ints
constexpr int WIN = 1024;              // rows whose dg a CTA stages at once
constexpr int UNROLL = 8;              // row loads a thread issues ahead
constexpr int RUN_MAX = 256;           // rows a 16-bit half may add (x 255)
static_assert(SEGS == 16 && GROUPS == 16, "a half-warp covers one row");

// Shared memory of a value-plane CTA: the padded accumulator, then the
// staged dg window.
__host__ __device__ constexpr size_t vals_smem_bytes(int tile_sb) {
    return ((size_t)tile_sb * ACC_W + WIN) * sizeof(int);
}

// A thread's running sums of its 16 lanes of one sub-block: lane 4j + i of
// the segment is the low (i = 0, 2) or high (i = 1, 3) 16-bit half of lo[j]
// (even bytes of plane word j) or hi[j] (odd bytes).
struct SegSums {
    uint32_t lo[4], hi[4];

    __device__ __forceinline__ void clear() {
#pragma unroll
        for (int j = 0; j < 4; ++j) lo[j] = hi[j] = 0u;
    }

    __device__ __forceinline__ void add(const uint4& v) {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            lo[j] += w[j] & 0x00FF00FFu;
            hi[j] += (w[j] >> 8) & 0x00FF00FFu;
        }
    }

    // Adds the sums into the accumulator row `row` (already offset to the
    // thread's segment: lane l of the segment is row[l]) and clears them.
    __device__ __forceinline__ void flush(int* row) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            atomicAdd(row + 4 * j + 0, (int)(lo[j] & 0xFFFFu));
            atomicAdd(row + 4 * j + 1, (int)(hi[j] & 0xFFFFu));
            atomicAdd(row + 4 * j + 2, (int)(lo[j] >> 16));
            atomicAdd(row + 4 * j + 3, (int)(hi[j] >> 16));
        }
        clear();
    }
};

// *o = (meth, cov), or *o += (meth, cov) with ADD (int32 adds that wrap).
template <bool ADD>
__device__ __forceinline__ void store_pair(int2* o, int meth, int cov) {
    if (ADD) {
        const int2 x = *o;
        meth = (int)((unsigned)x.x + (unsigned)meth);
        cov = (int)((unsigned)x.y + (unsigned)cov);
    }
    *o = make_int2(meth, cov);
}

// The tile's output pairs p (sites 2p, 2p + 1 of the tile): without ADD
// written as (meth, cov, meth, cov), with ADD added into the total (int32
// adds that wrap, as the JAX package's do); clipped to the window. acc is
// the padded accumulator, or nullptr for a tile of zeros. Lane l of sub-
// block sb sits at acc[sb * ACC_W + l + l / 16]; l and l + 1 (l even) share
// a 16-lane segment, and cov lane 128 + l sits 136 ints after meth lane l.
template <bool ADD>
__device__ __forceinline__ void vals_epilogue(const int* acc, int2* out,
                                              int t, int tile_sb,
                                              int64_t window_len) {
    const int64_t site0 = (int64_t)t * tile_sb * SB;
    const bool wide = ((uintptr_t)out & 15u) == 0;  // uniform over the CTA
    for (int p = threadIdx.x; p < tile_sb * SB / 2; p += VT) {
        const int64_t site = site0 + 2 * p;
        if (site >= window_len) break;  // p only grows
        int4 v = make_int4(0, 0, 0, 0);
        if (acc != nullptr) {
            const int l = (2 * p) % SB;
            const int* a = acc + (2 * p / SB) * ACC_W + l + l / SEGS;
            v = make_int4(a[0], a[SB + SB / SEGS], a[1], a[SB + SB / SEGS + 1]);
        }
        int2* o = out + site;
        if (wide && site + 1 < window_len) {
            if (ADD) {
                const int4 x = *reinterpret_cast<const int4*>(o);
                v.x = (int)((unsigned)x.x + (unsigned)v.x);
                v.y = (int)((unsigned)x.y + (unsigned)v.y);
                v.z = (int)((unsigned)x.z + (unsigned)v.z);
                v.w = (int)((unsigned)x.w + (unsigned)v.w);
            }
            *reinterpret_cast<int4*>(o) = v;
            continue;
        }
        store_pair<ADD>(o, v.x, v.y);
        if (site + 1 < window_len) store_pair<ADD>(o + 1, v.z, v.w);
    }
}

// The value-plane pileup of tile t. FUSED: one (rows, 256) plane, a row's
// segment s at plane + row * 256 + 16 s. Split: segments 0-7 in mv (rows,
// 128), 8-15 in cv. With ADD the tile is added into `out` (the running
// total), and a tile with no chunks returns at once, leaving its rows of the
// total untouched; without ADD the tile is written, zeros for a tile with no
// chunks. The plane form is a template parameter (a run-time form cost the
// first body 36-50 %, PERF.md), so the row stride is a constant.
template <bool ADD, bool FUSED>
__device__ __forceinline__ void pile_vals(const int* __restrict__ c0,
                                          const int* __restrict__ c1,
                                          const int* __restrict__ meta,
                                          const uint8_t* __restrict__ mv,
                                          const uint8_t* __restrict__ cv,
                                          int2* __restrict__ out,
                                          int64_t window_len, int tile_sb,
                                          int rc, int g_max) {
    constexpr int STRIDE = FUSED ? ROW_W : SB;  // bytes per plane row
    extern __shared__ int4 smem4[];
    int* acc = reinterpret_cast<int*>(smem4);
    int* s_dg = acc + tile_sb * ACC_W;
    const int t = blockIdx.x;
    const int c_beg = c0[t];
    const int c_end = c1[t];
    if (c_beg == c_end) {  // uniform over the block
        if (!ADD) vals_epilogue<false>(nullptr, out, t, tile_sb, window_len);
        return;
    }
    for (int i = threadIdx.x; i < tile_sb * ACC_W / 4; i += VT)
        smem4[i] = make_int4(0, 0, 0, 0);

    const int seg = threadIdx.x % SEGS;
    const int grp = threadIdx.x / SEGS;
    const uint8_t* col = FUSED ? mv + SEG * seg
                               : (seg < SEGS / 2 ? mv + SEG * seg
                                                 : cv + SEG * (seg - SEGS / 2));
    int* acc_seg = acc + seg * (SEG + 1);  // lane l of the segment: [l]
    SegSums sums;
    sums.clear();
    int cur = -1;  // sub-block the sums belong to, -1 before the first row
    int run = 0;   // rows added since the last flush

    for (int c = c_beg; c < c_end; ++c) {
        const int* dg_row = meta + ((int64_t)c * 2 + 1) * rc;
        // sub-block of dg = 0, relative to this tile
        const int base = __ldg(dg_row + rc - 1) - g_max - t * tile_sb;
        const uint8_t* chunk = col + (int64_t)c * rc * STRIDE;
        for (int w0 = 0; w0 < rc; w0 += WIN) {
            const int n = min(WIN, rc - w0);
            __syncthreads();  // the zeroing, or the last window's dg reads
            for (int i = threadIdx.x; i < n; i += VT)
                s_dg[i] = __ldg(dg_row + w0 + i);
            __syncthreads();
            const int per = (n + GROUPS - 1) / GROUPS;
            const int r_end = min((grp + 1) * per, n);
            for (int r = grp * per; r < r_end; r += UNROLL) {
                uint4 v[UNROLL];
                int sb[UNROLL];
#pragma unroll
                for (int k = 0; k < UNROLL; ++k) {
                    const int row = r + k;
                    sb[k] = -1;
                    v[k] = make_uint4(0u, 0u, 0u, 0u);
                    if (row < r_end) {
                        const int dg = s_dg[row];
                        const int b = base + dg;
                        if (dg >= 0 && dg < g_max && b >= 0 && b < tile_sb) {
                            sb[k] = b;
                            v[k] = __ldg(reinterpret_cast<const uint4*>(
                                chunk + (int64_t)(w0 + row) * STRIDE));
                        }
                    }
                }
#pragma unroll
                for (int k = 0; k < UNROLL; ++k) {
                    if (sb[k] < 0) continue;
                    if (sb[k] != cur || run == RUN_MAX) {
                        if (cur >= 0) sums.flush(acc_seg + cur * ACC_W);
                        cur = sb[k];
                        run = 0;
                    }
                    sums.add(v[k]);
                    ++run;
                }
            }
        }
    }
    if (cur >= 0) sums.flush(acc_seg + cur * ACC_W);
    __syncthreads();
    vals_epilogue<ADD>(acc, out, t, tile_sb, window_len);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_vals_fused (the
// default pileup kernel: a one-hot (g_max x rc) x (rc x 256) MXU dot per chunk).
__global__ void __launch_bounds__(VT, 3)
flat_vals_fused_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                       const int* __restrict__ meta,
                       const uint8_t* __restrict__ plane,
                       int2* __restrict__ out, int64_t window_len, int tile_sb,
                       int rc, int g_max) {
    pile_vals<false, true>(c0, c1, meta, plane, nullptr, out, window_len,
                           tile_sb, rc, g_max);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_vals (the same math
// over two separate (rc, 128) planes, two one-hot dots per chunk on the TPU).
__global__ void __launch_bounds__(VT, 3)
flat_vals_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                 const int* __restrict__ meta, const uint8_t* __restrict__ mv,
                 const uint8_t* __restrict__ cv, int2* __restrict__ out,
                 int64_t window_len, int tile_sb, int rc, int g_max) {
    pile_vals<false, false>(c0, c1, meta, mv, cv, out, window_len, tile_sb, rc,
                            g_max);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::pileup_vals_add (either value-
// plane kernel, then total + stack([meth, cov]) on a donated total, in one
// dispatch): the pileup with an in-place add epilogue, in one launch. One
// instantiation per plane form (cv is unused when FUSED).
template <bool FUSED>
__global__ void __launch_bounds__(VT, 3)
flat_vals_add_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                     const int* __restrict__ meta,
                     const uint8_t* __restrict__ mv,
                     const uint8_t* __restrict__ cv, int2* __restrict__ total,
                     int64_t window_len, int tile_sb, int rc, int g_max) {
    pile_vals<true, FUSED>(c0, c1, meta, mv, cv, total, window_len, tile_sb,
                           rc, g_max);
}

// ---------------------------------------------------------------------------
// The code-word body (flat_classic, flat_lc, tiled_classic): see the design
// note at the top of the file. meth += count where the code is C(1) or H(2);
// cov += count where it is not '.'(3) -- ref stdin2beta.cpp:59-93.
// ---------------------------------------------------------------------------

constexpr int CT = 128;              // threads of a code-word CTA
constexpr int CBLOCKS = 6;           // code-word CTAs per SM (launch bound)
constexpr int WORDS = SB / 16;       // code words per row: one per thread
constexpr int CGROUPS = CT / WORDS;  // row groups per CTA
constexpr int CWARPS = CT / 32;
constexpr int CACC_W = ROW_W + 8;    // padded accumulator row, in ints
constexpr int CWIN = 512;            // real rows a CTA lists at once
constexpr int CUNROLL = 4;           // row loads a thread issues ahead
static_assert(CWIN % CT == 0 && CACC_W % 4 == 0, "list and row widths");
// a group adds at most CWIN / CGROUPS rows between flushes: the lane form's
// 16-bit halves hold 256 x 255
static_assert(CWIN / CGROUPS <= 256, "a 16-bit lane sum could carry");

// Shared memory of a code-word CTA: the padded accumulator, then the list
// (row index, sub-block in the tile, count).
__host__ __device__ constexpr size_t codes_smem_bytes(int tile_sb) {
    return ((size_t)tile_sb * CACC_W + 3 * CWIN) * sizeof(int);
}

// Site k (0-15) of code word w sits in bits 2k, 2k + 1. Bit 2k of
// cov_bits(w) is set where the site is observed (code != 3), of
// meth_bits(w) where it is a methylation call (code 1 or 2: the bits differ).
__device__ __forceinline__ uint32_t cov_bits(uint32_t w) {
    return ~(w & (w >> 1)) & 0x55555555u;
}

__device__ __forceinline__ uint32_t meth_bits(uint32_t w) {
    return (w ^ (w >> 1)) & 0x55555555u;
}

// A thread's running sums of the classic form (one count per row, no upper
// bound): site k of its word, (meth[k], cov[k]), 32-bit and wrapping.
struct ClassicSums {
    uint32_t meth[16], cov[16];

    __device__ __forceinline__ void clear() {
#pragma unroll
        for (int k = 0; k < 16; ++k) meth[k] = cov[k] = 0u;
    }

    __device__ __forceinline__ void add(uint32_t w, uint32_t n) {
        const uint32_t cb = cov_bits(w), mb = meth_bits(w);
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            cov[k] += ((cb >> (2 * k)) & 1u) * n;
            meth[k] += ((mb >> (2 * k)) & 1u) * n;
        }
    }

    // Adds the sums into an accumulator row offset to the thread's word j
    // (site j + 8k at row[8k], its cov at row[SB + 8k]) and clears them.
    __device__ __forceinline__ void flush(unsigned* row) {
#pragma unroll
        for (int k = 0; k < 16; ++k) {
            atomicAdd(row + 8 * k, meth[k]);
            atomicAdd(row + SB + 8 * k, cov[k]);
        }
        clear();
    }
};

// A thread's running sums of the lane-count form (an 8-bit count per site).
// Its count word m (0-3) is word j + 8m of the row's count words, and byte q
// of it is the count of site k = m + 4q; the sums of those 4 sites are two
// registers of two 16-bit halves each: lo = bytes 0 (low half) and 2 (high),
// hi = bytes 1 and 3.
struct LaneSums {
    uint32_t m_lo[4], m_hi[4], c_lo[4], c_hi[4];

    __device__ __forceinline__ void clear() {
#pragma unroll
        for (int m = 0; m < 4; ++m) m_lo[m] = m_hi[m] = c_lo[m] = c_hi[m] = 0u;
    }

    __device__ __forceinline__ void add(uint32_t w, const uint32_t (&cw)[4]) {
        const uint32_t cb = cov_bits(w), mb = meth_bits(w);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            // byte q of a mask is 0xFF where site m + 4q is observed / a call
            const uint32_t xc = cw[m] & (((cb >> (2 * m)) & 0x01010101u) * 0xFFu);
            const uint32_t xm = cw[m] & (((mb >> (2 * m)) & 0x01010101u) * 0xFFu);
            c_lo[m] += xc & 0x00FF00FFu;
            c_hi[m] += (xc >> 8) & 0x00FF00FFu;
            m_lo[m] += xm & 0x00FF00FFu;
            m_hi[m] += (xm >> 8) & 0x00FF00FFu;
        }
    }

    // As ClassicSums::flush: site m + 4q sits at row[8 (m + 4q)].
    __device__ __forceinline__ void flush(unsigned* row) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
            atomicAdd(row + 8 * m, m_lo[m] & 0xFFFFu);
            atomicAdd(row + 8 * (m + 4), m_hi[m] & 0xFFFFu);
            atomicAdd(row + 8 * (m + 8), m_lo[m] >> 16);
            atomicAdd(row + 8 * (m + 12), m_hi[m] >> 16);
            atomicAdd(row + SB + 8 * m, c_lo[m] & 0xFFFFu);
            atomicAdd(row + SB + 8 * (m + 4), c_hi[m] & 0xFFFFu);
            atomicAdd(row + SB + 8 * (m + 8), c_lo[m] >> 16);
            atomicAdd(row + SB + 8 * (m + 12), c_hi[m] >> 16);
        }
        clear();
    }
};

// Adds the n listed rows (s_row: row index, s_sb: sub-block in the tile,
// s_cnt: the classic form's count) into the accumulator, after zeroing the
// rows of [lo, hi] (the listed sub-blocks) outside the zeroed span [z_lo,
// z_hi], which grows to cover them. n and the spans are uniform over the
// CTA; the call holds two __syncthreads.
template <bool LANE>
__device__ __forceinline__ void add_listed(int* acc, const int* s_row,
                                           const int* s_sb, const int* s_cnt,
                                           int n, int lo, int hi, int& z_lo,
                                           int& z_hi,
                                           const uint32_t* __restrict__ words,
                                           const uint32_t* __restrict__ cnts) {
    using Sums = std::conditional_t<LANE, LaneSums, ClassicSums>;
    constexpr int ROW4 = CACC_W / 4;  // int4s per accumulator row
    if (n == 0) return;
    const int n_lo = min(lo, z_lo), n_hi = max(hi, z_hi);
    int4* acc4 = reinterpret_cast<int4*>(acc);
    for (int i = n_lo * ROW4 + threadIdx.x; i < (n_hi + 1) * ROW4; i += CT) {
        const int sb = i / ROW4;
        if (sb < z_lo || sb > z_hi) acc4[i] = make_int4(0, 0, 0, 0);
    }
    z_lo = n_lo;
    z_hi = n_hi;
    __syncthreads();  // the list and the zeroed rows

    const int grp = threadIdx.x / WORDS;
    const int j = threadIdx.x % WORDS;
    unsigned* acc_j = reinterpret_cast<unsigned*>(acc) + j;
    const int per = (n + CGROUPS - 1) / CGROUPS;
    const int r_end = min(n, (grp + 1) * per);
    Sums sums;
    sums.clear();
    int cur = -1;  // sub-block the sums belong to, -1 before the first row
    for (int r = grp * per; r < r_end; r += CUNROLL) {
        uint32_t w[CUNROLL], cw[CUNROLL][4];
        int sb[CUNROLL];
        uint32_t cnt[CUNROLL];
#pragma unroll
        for (int k = 0; k < CUNROLL; ++k) {
            sb[k] = -1;
            w[k] = cnt[k] = 0u;
#pragma unroll
            for (int m = 0; m < 4; ++m) cw[k][m] = 0u;
            if (r + k < r_end) {
                const int64_t row = s_row[r + k];
                sb[k] = s_sb[r + k];
                w[k] = __ldg(words + row * WORDS + j);
                if (LANE) {
#pragma unroll
                    for (int m = 0; m < 4; ++m)
                        cw[k][m] = __ldg(cnts + row * (SB / 4) + j + WORDS * m);
                } else {
                    cnt[k] = (uint32_t)s_cnt[r + k];
                }
            }
        }
#pragma unroll
        for (int k = 0; k < CUNROLL; ++k) {
            if (sb[k] < 0) continue;
            if (sb[k] != cur) {
                if (cur >= 0) sums.flush(acc_j + cur * CACC_W);
                cur = sb[k];
            }
            if constexpr (LANE) {
                sums.add(w[k], cw[k]);
            } else {
                sums.add(w[k], cnt[k]);
            }
        }
    }
    if (cur >= 0) sums.flush(acc_j + cur * CACC_W);
    __syncthreads();  // the sums are in; the list may be refilled
}

// Tile t's pairs from the accumulator, whose rows [z_lo, z_hi] are in use
// (none when z_lo > z_hi). Flat: every site of the tile written as (meth,
// cov, meth, cov), zeros outside the rows in use, clipped to the window (as
// vals_epilogue). TILED: the nonzero cells of the rows in use added into
// `out` with global atomics (several CTAs, one per chunk of the tile, add
// into one site).
template <bool TILED>
__device__ __forceinline__ void codes_epilogue(const int* acc, int2* out,
                                               int t, int tile_sb,
                                               int64_t window_len, int z_lo,
                                               int z_hi) {
    const int64_t site0 = (int64_t)t * tile_sb * SB;
    if (TILED) {
        unsigned* o = reinterpret_cast<unsigned*>(out);
        for (int i = z_lo * SB + threadIdx.x; i < (z_hi + 1) * SB; i += CT) {
            const int64_t site = site0 + i;
            if (site >= window_len) break;  // i only grows
            const int* a = acc + (i / SB) * CACC_W + i % SB;
            if (a[0] != 0) atomicAdd(o + 2 * site, (unsigned)a[0]);
            if (a[SB] != 0) atomicAdd(o + 2 * site + 1, (unsigned)a[SB]);
        }
        return;
    }
    const bool wide = ((uintptr_t)out & 15u) == 0;  // uniform over the CTA
    for (int p = threadIdx.x; p < tile_sb * SB / 2; p += CT) {
        const int64_t site = site0 + 2 * p;
        if (site >= window_len) break;  // p only grows
        const int sb = 2 * p / SB;
        int4 v = make_int4(0, 0, 0, 0);
        if (sb >= z_lo && sb <= z_hi) {
            const int* a = acc + sb * CACC_W + (2 * p) % SB;
            v = make_int4(a[0], a[SB], a[1], a[SB + 1]);
        }
        int2* o = out + site;
        if (wide && site + 1 < window_len) {
            *reinterpret_cast<int4*>(o) = v;
            continue;
        }
        store_pair<false>(o, v.x, v.y);
        if (site + 1 < window_len) store_pair<false>(o + 1, v.z, v.w);
    }
}

// The code-word pileup of chunks [c_beg, c_end) into tile t, then its
// epilogue. LANE: the lane-count form (the count words cnts); otherwise the
// classic form (the row's count in meta[c][0]). The form is a template
// parameter (a run-time form cost the first value-plane body 36-50 %,
// PERF.md). The CTA lists the real rows of entries e = 0, 1, ... of the
// chunks' staged rows (chunk c_beg + e / rc, row e % rc), CT at a time, and
// adds the list whenever another pass might not fit in it.
template <bool LANE, bool TILED>
__device__ __forceinline__ void pile_codes(int t, int c_beg, int c_end,
                                           const int* __restrict__ meta,
                                           const uint32_t* __restrict__ words,
                                           const uint32_t* __restrict__ cnts,
                                           int2* __restrict__ out,
                                           int64_t window_len, int tile_sb,
                                           int rc, int g_max) {
    extern __shared__ int4 smem4[];
    int* acc = reinterpret_cast<int*>(smem4);
    int* s_row = acc + tile_sb * CACC_W;
    int* s_sb = s_row + CWIN;
    int* s_cnt = s_sb + CWIN;
    // per warp of a listing pass: rows listed, their lowest and highest
    // sub-block; two buffers, by the parity of the pass, so that one
    // __syncthreads per pass suffices
    __shared__ int s_warp[2][3][CWARPS];
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    int z_lo = tile_sb, z_hi = -1;     // accumulator rows zeroed: none yet
    int n = 0, lo = tile_sb, hi = -1;  // rows listed and their sub-blocks
    const int total = (c_end - c_beg) * rc;  // < 2^31: the wrapper checks
    for (int e0 = 0, pass = 0; e0 < total; e0 += CT, pass ^= 1) {
        const int e = e0 + threadIdx.x;
        bool ok = false;
        int sb = 0, row = 0, cnt = 0;
        if (e < total) {
            const int c = c_beg + e / rc;
            const int r = e % rc;
            const int* dg_row = meta + ((int64_t)c * 2 + 1) * rc;
            const int dg = __ldg(dg_row + r);
            sb = __ldg(dg_row + rc - 1) - g_max - t * tile_sb + dg;
            ok = dg >= 0 && dg < g_max && sb >= 0 && sb < tile_sb;
            row = c * rc + r;
            if (!LANE && ok) cnt = __ldg(meta + (int64_t)c * 2 * rc + r);
        }
        const unsigned mask = __ballot_sync(~0u, ok);
        const int wlo = __reduce_min_sync(~0u, ok ? sb : tile_sb);
        const int whi = __reduce_max_sync(~0u, ok ? sb : -1);
        if (lane == 0) {
            s_warp[pass][0][warp] = __popc(mask);
            s_warp[pass][1][warp] = wlo;
            s_warp[pass][2][warp] = whi;
        }
        __syncthreads();
        int pos = n + __popc(mask & ((1u << lane) - 1u));
#pragma unroll
        for (int w = 0; w < CWARPS; ++w) {
            const int k = s_warp[pass][0][w];
            pos += w < warp ? k : 0;
            n += k;
            lo = min(lo, s_warp[pass][1][w]);
            hi = max(hi, s_warp[pass][2][w]);
        }
        if (ok) {
            s_row[pos] = row;
            s_sb[pos] = sb;
            if (!LANE) s_cnt[pos] = cnt;
        }
        if (n > CWIN - CT || e0 + CT >= total) {  // uniform over the CTA
            add_listed<LANE>(acc, s_row, s_sb, s_cnt, n, lo, hi, z_lo, z_hi,
                             words, cnts);
            n = 0;
            lo = tile_sb;
            hi = -1;
        }
    }
    codes_epilogue<TILED>(acc, out, t, tile_sb, window_len, z_lo, z_hi);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat (the classic form,
// taken by any batch holding a count >= 256: per-row int32 counts with no
// upper bound, 2-bit codes, HIGHEST-precision f32 dots on the TPU). One CTA
// per tile, walking the tile's chunks [c0[t], c1[t]).
__global__ void __launch_bounds__(CT, CBLOCKS)
flat_classic_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                    const int* __restrict__ meta,
                    const uint32_t* __restrict__ words,
                    int2* __restrict__ out, int64_t window_len, int tile_sb,
                    int rc, int g_max) {
    const int t = blockIdx.x;
    pile_codes<false, false>(t, __ldg(c0 + t), __ldg(c1 + t), meta, words,
                             nullptr, out, window_len, tile_sb, rc, g_max);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_lc (the lane-count
// form: rows packed with no regard to count, so pieces of different counts
// share a row; a 4-way 8-bit unpack of the (rc, 32) count words on the TPU).
// flat_classic's kernel with the count read per site.
__global__ void __launch_bounds__(CT, CBLOCKS)
flat_lc_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
               const int* __restrict__ meta, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ cnts, int2* __restrict__ out,
               int64_t window_len, int tile_sb, int rc, int g_max) {
    const int t = blockIdx.x;
    pile_codes<true, false>(t, __ldg(c0 + t), __ldg(c1 + t), meta, words,
                            cnts, out, window_len, tile_sb, rc, g_max);
}

// The tile whose chunk range [c0[t], c1[t]) holds chunk c, or -1 when none
// does; the ranges ascend and are disjoint (as staging makes them, and
// staged_from_numpy checks), so t is the first tile with c1[t] > c. The
// warp searches 32 ways at a time: each lane probes the last tile of its
// 1/32 of the candidates [lo, hi) (hi: no tile), ~3 rounds at ~8,000 tiles.
__device__ __forceinline__ int chunk_tile(const int* __restrict__ c0,
                                          const int* __restrict__ c1,
                                          int num_tiles, int c) {
    const int lane = threadIdx.x % 32;
    int lo = 0, hi = num_tiles;
    while (lo < hi) {  // uniform over the warp
        const int step = (hi - lo + 31) / 32;
        const int p = lo + lane * step + step - 1;
        const unsigned gt = __ballot_sync(~0u, p >= hi || __ldg(c1 + p) > c);
        if (gt == 0u) {  // every candidate's range ends at or before c
            lo = hi;
            break;
        }
        lo += (__ffs(gt) - 1) * step;
        hi = min(lo + step - 1, hi);
    }
    return lo < num_tiles && __ldg(c0 + lo) <= c ? lo : -1;
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel (the classic form on the
// tiled grid, num_tiles x max_chunks steps, inactive steps skipped). The TPU
// runs that grid in order and carries the tile's accumulator across its
// chunk steps; here one CTA per staged chunk (in no order) piles up its chunk
// and adds the rows it reached into `out` with global atomics; a chunk in no
// tile's range adds nothing. `out` is zeroed by the entry point before the
// launch, so every tile is written, zeros where the tile has no chunk.
// Against the flat kernel it trades one walk per tile for a CTA and global
// atomics per chunk.
__global__ void __launch_bounds__(CT, CBLOCKS)
tiled_classic_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                     const int* __restrict__ meta,
                     const uint32_t* __restrict__ words, int2* __restrict__ out,
                     int num_tiles, int64_t window_len, int tile_sb, int rc,
                     int g_max) {
    const int c = blockIdx.x;
    const int t = chunk_tile(c0, c1, num_tiles, c);
    if (t < 0) return;  // uniform: every warp finds the same tile
    pile_codes<false, true>(t, c, c + 1, meta, words, nullptr, out,
                            window_len, tile_sb, rc, g_max);
}

// Launches `blocks` CTAs of `threads` with `smem` bytes of dynamic shared
// memory and the SM's carveout set to the most shared memory, so that
// several CTAs share an SM.
template <typename Kernel, typename... Args>
int launch_carveout(Kernel kernel, int64_t blocks, int threads, size_t smem,
                    void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    return wgbs::launch(kernel, dim3((unsigned)blocks), threads, smem, stream,
                        args...);
}

// Launches a value-plane kernel, one CTA of VT threads per tile, with its
// padded accumulator and dg window (vals_smem_bytes): 3 CTAs fit on an SM at
// the default tile_sb = 64.
template <typename Kernel, typename... Args>
int launch_vals(Kernel kernel, int64_t num_tiles, int64_t tile_sb,
                void* stream, Args... args) {
    return launch_carveout(kernel, num_tiles, VT,
                           vals_smem_bytes((int)tile_sb), stream, args...);
}

}  // namespace

extern "C" {

int pileup_flat_vals_fused(const void* c0, const void* c1, const void* meta,
                           const void* plane, void* out, int64_t num_tiles,
                           int64_t window_len, int64_t tile_sb, int64_t rc,
                           int64_t g_max, void* stream) {
    return launch_vals(flat_vals_fused_kernel, num_tiles, tile_sb, stream,
                       (const int*)c0, (const int*)c1, (const int*)meta,
                       (const uint8_t*)plane, (int2*)out, window_len,
                       (int)tile_sb, (int)rc, (int)g_max);
}

int pileup_flat_vals(const void* c0, const void* c1, const void* meta,
                     const void* mv, const void* cv, void* out,
                     int64_t num_tiles, int64_t window_len, int64_t tile_sb,
                     int64_t rc, int64_t g_max, void* stream) {
    return launch_vals(flat_vals_kernel, num_tiles, tile_sb, stream,
                       (const int*)c0, (const int*)c1, (const int*)meta,
                       (const uint8_t*)mv, (const uint8_t*)cv, (int2*)out,
                       window_len, (int)tile_sb, (int)rc, (int)g_max);
}

// cv == NULL: mv is the fused (rows, 256) plane; else mv and cv are the two
// split (rows, 128) planes.
int pileup_flat_vals_add(const void* c0, const void* c1, const void* meta,
                         const void* mv, const void* cv, void* total,
                         int64_t num_tiles, int64_t window_len,
                         int64_t tile_sb, int64_t rc, int64_t g_max,
                         void* stream) {
    return launch_vals(cv == nullptr ? flat_vals_add_kernel<true>
                                     : flat_vals_add_kernel<false>,
                       num_tiles, tile_sb, stream, (const int*)c0,
                       (const int*)c1, (const int*)meta, (const uint8_t*)mv,
                       (const uint8_t*)cv, (int2*)total, window_len,
                       (int)tile_sb, (int)rc, (int)g_max);
}

int pileup_flat_classic(const void* c0, const void* c1, const void* meta,
                        const void* words, void* out, int64_t num_tiles,
                        int64_t window_len, int64_t tile_sb, int64_t rc,
                        int64_t g_max, void* stream) {
    return launch_carveout(flat_classic_kernel, num_tiles, CT,
                           codes_smem_bytes((int)tile_sb), stream,
                           (const int*)c0, (const int*)c1, (const int*)meta,
                           (const uint32_t*)words, (int2*)out, window_len,
                           (int)tile_sb, (int)rc, (int)g_max);
}

int pileup_flat_lc(const void* c0, const void* c1, const void* meta,
                   const void* words, const void* cnts, void* out,
                   int64_t num_tiles, int64_t window_len, int64_t tile_sb,
                   int64_t rc, int64_t g_max, void* stream) {
    return launch_carveout(flat_lc_kernel, num_tiles, CT,
                           codes_smem_bytes((int)tile_sb), stream,
                           (const int*)c0, (const int*)c1, (const int*)meta,
                           (const uint32_t*)words, (const uint32_t*)cnts,
                           (int2*)out, window_len, (int)tile_sb, (int)rc,
                           (int)g_max);
}

// Zeroes out (window_len, 2) on `stream`, then launches one CTA per staged
// chunk (n_chunks of them).
int pileup_tiled_classic(const void* c0, const void* c1, const void* meta,
                         const void* words, void* out, int64_t num_tiles,
                         int64_t window_len, int64_t tile_sb, int64_t rc,
                         int64_t g_max, int64_t n_chunks, void* stream) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)window_len * 2 * sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess || n_chunks == 0) return (int)err;
    return launch_carveout(tiled_classic_kernel, n_chunks, CT,
                           codes_smem_bytes((int)tile_sb), stream,
                           (const int*)c0, (const int*)c1, (const int*)meta,
                           (const uint32_t*)words, (int2*)out, (int)num_tiles,
                           window_len, (int)tile_sb, (int)rc, (int)g_max);
}

const char* wgbs_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
