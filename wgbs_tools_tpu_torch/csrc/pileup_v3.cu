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
// Design of the classic flat kernels (flat_classic, flat_lc): one CTA per
// output tile (tile_sb sub-blocks of 128 sites). The CTA walks its chunks in
// order; each thread owns one lane of the row, so every shared-memory
// accumulator cell has exactly one writer and plain int32 adds suffice (no
// atomics, no tensor cores: counts stay exact integers, and the grouping of
// integer adds does not change the bits). The accumulator is tile_sb x 256
// int32 in dynamic shared memory (8 KB at the classic default tile_sb = 8;
// the attribute call allows more than 48 KB). A tile with no chunks
// still writes zeros (every site of the window is written, so the wrapper
// allocates the output with torch.empty). tiled_classic is the
// chunk-parallel form of the same pileup: see its own note. The
// value-plane kernels have their own body (pile_vals, below); of them,
// flat_vals_add leaves a chunkless tile's rows of the total as they were.
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

#include "launch.cuh"

namespace {

constexpr int SB = 128;       // sites per sub-block (= lanes of one row)
constexpr int ROW_W = 2 * SB; // accumulator width: meth lanes, then cov lanes

// Writes the tile's accumulator to out[site] = (meth, cov), clipped to the
// window. acc is [tile_sb][ROW_W].
__device__ __forceinline__ void store_tile(const int* acc, int2* out, int t,
                                           int tile_sb, int64_t window_len) {
    const int64_t site0 = (int64_t)t * tile_sb * SB;
    for (int i = threadIdx.x; i < tile_sb * SB; i += blockDim.x) {
        const int64_t site = site0 + i;
        if (site < window_len) {
            const int* a = acc + (i / SB) * ROW_W + (i % SB);
            out[site] = make_int2(a[0], a[SB]);
        }
    }
}

// out[site] += (meth, cov) for the tile's nonzero cells, clipped to the
// window, with global atomics: several CTAs (one per chunk of the tile) add
// into one site. Integer atomics are exact, and their order does not change
// the bits (the adds wrap modulo 2^32 in any order).
__device__ __forceinline__ void atomic_add_tile(const int* acc, int* out,
                                                int t, int tile_sb,
                                                int64_t window_len) {
    const int64_t site0 = (int64_t)t * tile_sb * SB;
    for (int i = threadIdx.x; i < tile_sb * SB; i += blockDim.x) {
        const int64_t site = site0 + i;
        if (site < window_len) {
            const int* a = acc + (i / SB) * ROW_W + (i % SB);
            if (a[0] != 0) atomicAdd(out + 2 * site, a[0]);
            if (a[SB] != 0) atomicAdd(out + 2 * site + 1, a[SB]);
        }
    }
}

__device__ __forceinline__ void zero_acc(int* acc, int tile_sb) {
    for (int i = threadIdx.x; i < tile_sb * ROW_W; i += blockDim.x) acc[i] = 0;
}

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

// Chunk c of the code-word forms, added into tile t's accumulator. 128
// threads, thread = site (lane) of the sub-block, owning its meth and cov
// cells. meth += count where the code is C(1) or H(2); cov += count where it
// is not '.'(3) -- ref stdin2beta.cpp:59-93. The count source is a template
// parameter (a run-time choice of the plane form cost the value-plane kernels
// 36-50 %, PERF.md): LANE reads the lane's 8-bit field of the row's count
// words (the lane-count form, every count < 256); otherwise the row's count
// is meta[c][0][r] (the classic form, no upper bound).
template <bool LANE>
__device__ __forceinline__ void classic_chunk(int* acc, int c, int t,
                                              const int* __restrict__ meta,
                                              const uint32_t* __restrict__ words,
                                              const uint32_t* __restrict__ cnts,
                                              int tile_sb, int rc, int g_max) {
    const int lane = threadIdx.x;
    const int shift = 2 * (lane / 8);
    const int* cnt_row = meta + (int64_t)c * 2 * rc;
    const int* dg_row = cnt_row + rc;
    const int base = dg_row[rc - 1] - g_max - t * tile_sb;
    const uint32_t* w = words + (int64_t)c * rc * 8 + lane % 8;
    const uint32_t* cw = LANE ? cnts + (int64_t)c * rc * 32 + lane % 32
                              : nullptr;
    const int cshift = 8 * (lane / 32);
#pragma unroll 4
    for (int r = 0; r < rc; ++r) {
        const int dg = dg_row[r];
        const int sb = base + dg;
        if (dg >= 0 && dg < g_max && sb >= 0 && sb < tile_sb) {
            const uint32_t code = (w[(int64_t)r * 8] >> shift) & 3u;
            const int n = LANE ? (int)((cw[(int64_t)r * 32] >> cshift) & 255u)
                               : cnt_row[r];
            int* a = acc + sb * ROW_W + lane;
            if (code != 3u) {
                a[SB] += n;
                if (code != 0u) a[0] += n;
            }
        }
    }
}

// The flat pileup of the code-word forms: the CTA of tile t walks its chunks
// [c0[t], c1[t]) and writes the tile.
template <bool LANE>
__device__ __forceinline__ void pile_classic(const int* __restrict__ c0,
                                             const int* __restrict__ c1,
                                             const int* __restrict__ meta,
                                             const uint32_t* __restrict__ words,
                                             const uint32_t* __restrict__ cnts,
                                             int2* __restrict__ out,
                                             int64_t window_len, int tile_sb,
                                             int rc, int g_max) {
    extern __shared__ int acc[];
    const int t = blockIdx.x;
    zero_acc(acc, tile_sb);
    __syncthreads();
    const int c_end = c1[t];
    for (int c = c0[t]; c < c_end; ++c)
        classic_chunk<LANE>(acc, c, t, meta, words, cnts, tile_sb, rc, g_max);
    __syncthreads();
    store_tile(acc, out, t, tile_sb, window_len);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat (the classic form,
// taken by any batch holding a count >= 256: per-row int32 counts with no
// upper bound, 2-bit codes, HIGHEST-precision f32 dots on the TPU).
__global__ void __launch_bounds__(SB)
flat_classic_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                    const int* __restrict__ meta,
                    const uint32_t* __restrict__ words,
                    int2* __restrict__ out, int64_t window_len, int tile_sb,
                    int rc, int g_max) {
    pile_classic<false>(c0, c1, meta, words, nullptr, out, window_len,
                        tile_sb, rc, g_max);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_lc (the lane-count
// form: rows packed with no regard to count, so pieces of different counts
// share a row; a 4-way 8-bit unpack of the (rc, 32) count words on the TPU).
// The classic kernel's body with the count read per lane.
__global__ void __launch_bounds__(SB)
flat_lc_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
               const int* __restrict__ meta, const uint32_t* __restrict__ words,
               const uint32_t* __restrict__ cnts, int2* __restrict__ out,
               int64_t window_len, int tile_sb, int rc, int g_max) {
    pile_classic<true>(c0, c1, meta, words, cnts, out, window_len, tile_sb, rc,
                       g_max);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel (the classic form on the
// tiled grid, num_tiles x max_chunks steps, inactive steps skipped). The TPU
// runs that grid in order and carries the tile's accumulator across its
// chunk steps; here the grid's chunk axis is parallel: CTA (t, k) piles up
// chunks c0[t] + k, c0[t] + k + gridDim.y, ... below c1[t] (one each when
// gridDim.y = max_chunks, the launch's usual shape; the stride keeps every
// chunk when max_chunks exceeds the 65,535 limit of gridDim.y), each into a
// zeroed shared tile, and adds the tile's nonzero cells into `out` with
// global atomics. `out` is zeroed by the entry point before the launch, so
// every tile is written, zeros where the tile has no chunk. Against the flat
// kernel it trades one serial walk per tile for more CTAs (and shared tiles
// to zero and flush) plus atomics.
__global__ void __launch_bounds__(SB)
tiled_classic_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                     const int* __restrict__ meta,
                     const uint32_t* __restrict__ words, int* __restrict__ out,
                     int64_t window_len, int tile_sb, int rc, int g_max) {
    extern __shared__ int acc[];
    const int t = blockIdx.x;
    const int c_end = c1[t];
    for (int c = c0[t] + (int)blockIdx.y; c < c_end; c += gridDim.y) {
        zero_acc(acc, tile_sb);
        __syncthreads();
        classic_chunk<false>(acc, c, t, meta, words, nullptr, tile_sb, rc,
                             g_max);
        __syncthreads();
        atomic_add_tile(acc, out, t, tile_sb, window_len);
        __syncthreads();
    }
}

// Launches with the tile accumulator (tile_sb x ROW_W int32) as dynamic
// shared memory.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int threads, dim3 grid, int64_t tile_sb,
           void* stream, Args... args) {
    return wgbs::launch(kernel, grid, threads,
                        (size_t)tile_sb * ROW_W * sizeof(int), stream, args...);
}

// Launches a value-plane kernel, one CTA of VT threads per tile, with its
// padded accumulator and dg window (vals_smem_bytes) as dynamic shared
// memory and the SM's carveout set to the most shared memory, so that 3
// CTAs fit on an SM at the default tile_sb = 64.
template <typename Kernel, typename... Args>
int launch_vals(Kernel kernel, int64_t num_tiles, int64_t tile_sb,
                void* stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    return wgbs::launch(kernel, dim3((unsigned)num_tiles), VT,
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
    return launch(flat_classic_kernel, SB, dim3((unsigned)num_tiles), tile_sb,
                  stream, (const int*)c0, (const int*)c1, (const int*)meta,
                  (const uint32_t*)words, (int2*)out, window_len,
                  (int)tile_sb, (int)rc, (int)g_max);
}

int pileup_flat_lc(const void* c0, const void* c1, const void* meta,
                   const void* words, const void* cnts, void* out,
                   int64_t num_tiles, int64_t window_len, int64_t tile_sb,
                   int64_t rc, int64_t g_max, void* stream) {
    return launch(flat_lc_kernel, SB, dim3((unsigned)num_tiles), tile_sb,
                  stream, (const int*)c0, (const int*)c1, (const int*)meta,
                  (const uint32_t*)words, (const uint32_t*)cnts, (int2*)out,
                  window_len, (int)tile_sb, (int)rc, (int)g_max);
}

// Zeroes out (window_len, 2) on `stream`, then launches the num_tiles x
// min(max_chunks, 65535) grid.
int pileup_tiled_classic(const void* c0, const void* c1, const void* meta,
                         const void* words, void* out, int64_t num_tiles,
                         int64_t window_len, int64_t tile_sb, int64_t rc,
                         int64_t g_max, int64_t max_chunks, void* stream) {
    cudaError_t err = cudaMemsetAsync(
        out, 0, (size_t)window_len * 2 * sizeof(int), (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    const unsigned ny = (unsigned)(max_chunks < 65535 ? max_chunks : 65535);
    return launch(tiled_classic_kernel, SB, dim3((unsigned)num_tiles, ny),
                  tile_sb, stream, (const int*)c0, (const int*)c1,
                  (const int*)meta, (const uint32_t*)words, (int*)out,
                  window_len, (int)tile_sb, (int)rc, (int)g_max);
}

const char* wgbs_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
