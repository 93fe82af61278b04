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
// Design of the flat kernels: one CTA per output tile (tile_sb sub-blocks of
// 128 sites). The CTA walks its chunks in order; each thread owns one lane of
// the row, so every shared-memory accumulator cell has exactly one writer and
// plain int32 adds suffice (no atomics, no tensor cores: counts stay exact
// integers, and the grouping of integer adds does not change the bits). The
// accumulator is tile_sb x 256 int32 in dynamic shared memory (64 KB at the
// default tile_sb = 64, above the 48 KB static limit, hence the attribute
// call). A tile with no chunks still writes zeros in the kernels that write a
// fresh output (every site of the window is written, so the wrapper allocates
// it with torch.empty); flat_vals_add leaves such a tile's rows of the total
// as they were. tiled_classic is the chunk-parallel form of the same pileup:
// see its own note.
//
// Bound: load latency, not bandwidth. The planes are read once (256 B per
// row for the value planes, 32 B + the count for the classic form) and the
// output written once, with almost no arithmetic, so the floor is the
// device-memory bytes; but each thread loads one byte (value planes) or one
// word (classic) per row and a CTA walks its rows one after another, so few
// loads are in flight and measured throughput stays far below that floor
// (PERF.md). The fix is later work: wider per-thread loads (16 B vectors)
// and several rows in flight per CTA (unrolling, cp.async or TMA).
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

// total[site] += (meth, cov) for the tile's sites, clipped to the window.
// Each site belongs to exactly one tile, so exactly one CTA reads, adds and
// writes it: the plain read-add-write is race-free without atomics. The add
// wraps modulo 2^32, as the JAX package's int32 add does (no widening).
__device__ __forceinline__ void add_tile(const int* acc, int2* total, int t,
                                         int tile_sb, int64_t window_len) {
    const int64_t site0 = (int64_t)t * tile_sb * SB;
    for (int i = threadIdx.x; i < tile_sb * SB; i += blockDim.x) {
        const int64_t site = site0 + i;
        if (site < window_len) {
            const int* a = acc + (i / SB) * ROW_W + (i % SB);
            int2 v = total[site];
            v.x = (int)((unsigned)v.x + (unsigned)a[0]);
            v.y = (int)((unsigned)v.y + (unsigned)a[SB]);
            total[site] = v;
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

// The value-plane pileup shared by flat_vals_fused, flat_vals and
// flat_vals_add: 256 threads, thread = lane of the meth|cov row. FUSED: one
// (rows, 256) plane, lane l reads plane[row * 256 + l]. Split: lanes 0-127
// read mv[row * 128 + lane], lanes 128-255 cv[row * 128 + lane - 128]. With
// ADD the tile is added into `out` (the running total), and a tile with no
// chunks returns at once, leaving its rows of the total untouched; without
// ADD the tile is written, zeros for a tile with no chunks.
//
// The plane form is a template parameter, so the row stride is a constant and
// the fused plane is read through one direct pointer, and the plane and meta
// loads carry __ldg. Measured on the H100 (PERF.md, Findings): the same loop with
// the stride and the plane form chosen at run time, or with the per-lane
// pointer select and no __ldg, ran 36-50 % slower, although every variant's
// plane loads compile to read-only-cache loads (LDG.E.U8.CONSTANT).
template <bool ADD, bool FUSED>
__device__ __forceinline__ void pile_vals(const int* __restrict__ c0,
                                          const int* __restrict__ c1,
                                          const int* __restrict__ meta,
                                          const uint8_t* __restrict__ mv,
                                          const uint8_t* __restrict__ cv,
                                          int2* __restrict__ out,
                                          int64_t window_len, int tile_sb,
                                          int rc, int g_max) {
    constexpr int STRIDE = FUSED ? ROW_W : SB;
    extern __shared__ int acc[];
    const int t = blockIdx.x;
    const int lane = threadIdx.x;
    const int c_beg = c0[t];
    const int c_end = c1[t];
    if (ADD && c_beg == c_end) return;  // uniform over the block
    zero_acc(acc, tile_sb);
    __syncthreads();
    const uint8_t* lane_col =
        FUSED ? mv + lane : (lane < SB ? mv + lane : cv + (lane - SB));
    for (int c = c_beg; c < c_end; ++c) {
        const int* dg_row = meta + ((int64_t)c * 2 + 1) * rc;
        // sub-block of dg = 0, relative to this tile
        const int base = __ldg(dg_row + rc - 1) - g_max - t * tile_sb;
        const uint8_t* col = lane_col + (int64_t)c * rc * STRIDE;
#pragma unroll 8
        for (int r = 0; r < rc; ++r) {
            const int dg = __ldg(dg_row + r);
            const int sb = base + dg;
            if (dg >= 0 && dg < g_max && sb >= 0 && sb < tile_sb)
                acc[sb * ROW_W + lane] += __ldg(col + (int64_t)r * STRIDE);
        }
    }
    __syncthreads();
    if (ADD)
        add_tile(acc, out, t, tile_sb, window_len);
    else
        store_tile(acc, out, t, tile_sb, window_len);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_vals_fused (the
// default pileup kernel: a one-hot (g_max x rc) x (rc x 256) MXU dot per chunk).
__global__ void __launch_bounds__(ROW_W)
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
__global__ void __launch_bounds__(ROW_W)
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
__global__ void __launch_bounds__(ROW_W)
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

}  // namespace

extern "C" {

int pileup_flat_vals_fused(const void* c0, const void* c1, const void* meta,
                           const void* plane, void* out, int64_t num_tiles,
                           int64_t window_len, int64_t tile_sb, int64_t rc,
                           int64_t g_max, void* stream) {
    return launch(flat_vals_fused_kernel, ROW_W, dim3((unsigned)num_tiles),
                  tile_sb, stream, (const int*)c0, (const int*)c1,
                  (const int*)meta, (const uint8_t*)plane, (int2*)out,
                  window_len, (int)tile_sb, (int)rc, (int)g_max);
}

int pileup_flat_vals(const void* c0, const void* c1, const void* meta,
                     const void* mv, const void* cv, void* out,
                     int64_t num_tiles, int64_t window_len, int64_t tile_sb,
                     int64_t rc, int64_t g_max, void* stream) {
    return launch(flat_vals_kernel, ROW_W, dim3((unsigned)num_tiles), tile_sb,
                  stream, (const int*)c0, (const int*)c1, (const int*)meta,
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
    return launch(cv == nullptr ? flat_vals_add_kernel<true>
                                : flat_vals_add_kernel<false>,
                  ROW_W, dim3((unsigned)num_tiles), tile_sb, stream,
                  (const int*)c0, (const int*)c1, (const int*)meta,
                  (const uint8_t*)mv, (const uint8_t*)cv, (int2*)total,
                  window_len, (int)tile_sb, (int)rc, (int)g_max);
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
