// Hand-written Hopper (sm_90a) kernels for the pat2beta pileup.
//
// Both kernels consume the staged batch of wgbs_tools_tpu_torch/ops/pileup_v3.py
// (the same layout as wgbs_tools_tpu/ops/pileup_tpu3.py::stage_v3):
//
//   c0, c1  int32 [num_tiles]          chunk range [c0[t], c1[t]) of output tile t
//   meta    int32 [n_chunks][2][rc]    [c][0][r] = repeat count of row r (classic
//                                      form), [c][1][r] = dg, the row's sub-block
//                                      offset from the chunk's base; dg outside
//                                      [0, g_max) marks a padding row, and the
//                                      padding row rc-1 stashes base_g + g_max
//   rows    one row per 128-site sub-block slice:
//           flat_vals_fused: uint8 [n_chunks*rc][256], lanes 0-127 = meth value,
//                            128-255 = cov value (count pre-masked by the code)
//           flat_classic:    int32 [n_chunks*rc][8], 2-bit planar codes: site l
//                            of the sub-block is (word[l % 8] >> 2*(l / 8)) & 3
//
// and write the (window_len, 2) int32 [meth, cov] pileup of the window.
//
// Design: one CTA per output tile (tile_sb sub-blocks of 128 sites). The CTA
// walks its chunks in order; each thread owns one lane of the row, so every
// shared-memory accumulator cell has exactly one writer and plain int32 adds
// suffice (no atomics, no tensor cores: counts stay exact integers, and the
// grouping of integer adds does not change the bits). The accumulator is
// tile_sb x 256 int32 in dynamic shared memory (64 KB at the default
// tile_sb = 64, above the 48 KB static limit, hence the attribute call). A
// tile with no chunks still writes zeros: every site of the window is
// written, so the wrapper allocates the output with torch.empty.
//
// Bound: load latency, not bandwidth. The planes are read once (256 B per
// row for the fused form, 32 B + the count for the classic form) and the
// output written once, with almost no arithmetic, so the floor is the
// device-memory bytes; but each thread loads one byte (fused) or one word
// (classic) per row and a CTA walks its rows one after another, so few
// loads are in flight and measured throughput stays far below that floor
// (PERF.md). The fix is later work: wider per-thread loads (16 B vectors)
// and several rows in flight per CTA (unrolling, cp.async or TMA).

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void zero_acc(int* acc, int tile_sb) {
    for (int i = threadIdx.x; i < tile_sb * ROW_W; i += blockDim.x) acc[i] = 0;
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat_vals_fused (the
// default pileup kernel: a one-hot (g_max x rc) x (rc x 256) MXU dot per chunk).
// Here: 256 threads, thread = lane of the fused meth|cov plane.
__global__ void __launch_bounds__(ROW_W)
flat_vals_fused_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                       const int* __restrict__ meta,
                       const uint8_t* __restrict__ plane,
                       int2* __restrict__ out, int64_t window_len, int tile_sb,
                       int rc, int g_max) {
    extern __shared__ int acc[];
    const int t = blockIdx.x;
    const int lane = threadIdx.x;
    zero_acc(acc, tile_sb);
    __syncthreads();
    const int c_end = c1[t];
    for (int c = c0[t]; c < c_end; ++c) {
        const int* dg_row = meta + ((int64_t)c * 2 + 1) * rc;
        // sub-block of dg = 0, relative to this tile
        const int base = dg_row[rc - 1] - g_max - t * tile_sb;
        const uint8_t* col = plane + (int64_t)c * rc * ROW_W + lane;
#pragma unroll 8
        for (int r = 0; r < rc; ++r) {
            const int dg = dg_row[r];
            const int sb = base + dg;
            if (dg >= 0 && dg < g_max && sb >= 0 && sb < tile_sb)
                acc[sb * ROW_W + lane] += col[(int64_t)r * ROW_W];
        }
    }
    __syncthreads();
    store_tile(acc, out, t, tile_sb, window_len);
}

// Replaces wgbs_tools_tpu/ops/pileup_tpu3.py::_kernel_flat (the classic form,
// taken by any batch holding a count >= 256: per-row int32 counts with no
// upper bound, 2-bit codes, HIGHEST-precision f32 dots on the TPU). Here: 128
// threads, thread = site of the sub-block, owning its meth and cov cells.
// meth += count where the code is C(1) or H(2); cov += count where it is not
// '.'(3) -- ref stdin2beta.cpp:59-93.
__global__ void __launch_bounds__(SB)
flat_classic_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                    const int* __restrict__ meta,
                    const uint32_t* __restrict__ words,
                    int2* __restrict__ out, int64_t window_len, int tile_sb,
                    int rc, int g_max) {
    extern __shared__ int acc[];
    const int t = blockIdx.x;
    const int lane = threadIdx.x;
    const int wcol = lane % 8;
    const int shift = 2 * (lane / 8);
    zero_acc(acc, tile_sb);
    __syncthreads();
    const int c_end = c1[t];
    for (int c = c0[t]; c < c_end; ++c) {
        const int* cnt_row = meta + (int64_t)c * 2 * rc;
        const int* dg_row = cnt_row + rc;
        const int base = dg_row[rc - 1] - g_max - t * tile_sb;
        const uint32_t* w = words + (int64_t)c * rc * 8 + wcol;
#pragma unroll 4
        for (int r = 0; r < rc; ++r) {
            const int dg = dg_row[r];
            const int sb = base + dg;
            if (dg >= 0 && dg < g_max && sb >= 0 && sb < tile_sb) {
                const uint32_t code = (w[(int64_t)r * 8] >> shift) & 3u;
                const int n = cnt_row[r];
                int* a = acc + sb * ROW_W + lane;
                if (code != 3u) {
                    a[SB] += n;
                    if (code != 0u) a[0] += n;
                }
            }
        }
    }
    __syncthreads();
    store_tile(acc, out, t, tile_sb, window_len);
}

template <typename Kernel, typename Row>
int launch(Kernel kernel, int threads, int device, const void* c0,
           const void* c1, const void* meta, const void* rows, void* out,
           int64_t num_tiles, int64_t window_len, int64_t tile_sb, int64_t rc,
           int64_t g_max, void* stream) {
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    const size_t smem = (size_t)tile_sb * ROW_W * sizeof(int);
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<(unsigned)num_tiles, threads, smem, (cudaStream_t)stream>>>(
        (const int*)c0, (const int*)c1, (const int*)meta, (const Row*)rows,
        (int2*)out, window_len, (int)tile_sb, (int)rc, (int)g_max);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int pileup_flat_vals_fused(int device, const void* c0, const void* c1,
                           const void* meta, const void* plane, void* out,
                           int64_t num_tiles, int64_t window_len,
                           int64_t tile_sb, int64_t rc, int64_t g_max,
                           void* stream) {
    return launch<decltype(&flat_vals_fused_kernel), uint8_t>(
        flat_vals_fused_kernel, ROW_W, device, c0, c1, meta, plane, out,
        num_tiles, window_len, tile_sb, rc, g_max, stream);
}

int pileup_flat_classic(int device, const void* c0, const void* c1,
                        const void* meta, const void* words, void* out,
                        int64_t num_tiles, int64_t window_len,
                        int64_t tile_sb, int64_t rc, int64_t g_max,
                        void* stream) {
    return launch<decltype(&flat_classic_kernel), uint32_t>(
        flat_classic_kernel, SB, device, c0, c1, meta, words, out, num_tiles,
        window_len, tile_sb, rc, g_max, stream);
}

const char* wgbs_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
