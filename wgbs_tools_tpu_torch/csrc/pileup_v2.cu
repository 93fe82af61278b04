// Hand-written Hopper (sm_90a) kernel for the v2 staged pileup
// (wgbs_tools_tpu_torch/ops/pileup_v2.py, the same layout as
// wgbs_tools_tpu/ops/pileup_tpu2.py::stage_v2): one fragment per row.
//
//   c0, c1  int32 [num_tiles]         chunk range [c0[t], c1[t]) of output tile t;
//                                     a chunk's fragments start inside its tile
//   meta    int32 [n_chunks][3][fc]   [c][0][r] = start relative to the window,
//                                     [c][1][r] = len | dg << 16 (dg outside
//                                     [0, g_max) marks a padding row),
//                                     [c][2][r] = repeat count
//   words   int32 [n_chunks*fc][w_cols] 2-bit planar codes: code j of the
//                                     fragment is (word[j % w_cols] >> 2*(j / w_cols)) & 3
//
// and write the (window_len, 2) int32 [meth, cov] pileup of the window:
// meth += count where the code is C(1) or H(2); cov += count where it is not
// '.'(3), at site rel + j for j < len -- ref stdin2beta.cpp:59-93.
//
// Design: the TPU kernel walks the tiles in order and carries each tile's
// 256-lane right halo into the next through scratch; Hopper blocks run in no
// set order, so nothing may carry. A fragment starts inside its chunk's tile
// and is at most 128 sites long (staging splits longer ones), so it reaches at
// most the next tile: the CTA of tile t walks the chunks of tiles t - 1 and t,
// [c0[t-1], c1[t]), and keeps only the sites of its own tile. Every site is
// then written by exactly one CTA: no carry and no global atomics, and every
// tile is written, zeros where no fragment reaches it. Inside the CTA one
// thread takes one fragment row and adds its in-tile sites into the shared
// (2, tile) int32 accumulator with shared-memory atomics, because rows of a
// chunk overlap; integer atomics are exact, and their order does not change
// the bits. The TPU's barrel rolls and one-hot strip dots have no part here.
//
// Bound: shared-memory atomics and the row walk (one thread per fragment of
// ~12 sites; each fragment is read by two CTAs), not device-memory bytes:
// meta is 12 B and the words 4 * w_cols B per fragment.
//
// No entry point sets the CUDA device (see launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;

// Replaces wgbs_tools_tpu/ops/pileup_tpu2.py::_kernel.
__global__ void __launch_bounds__(THREADS)
tiles_v2_kernel(const int* __restrict__ c0, const int* __restrict__ c1,
                const int* __restrict__ meta,
                const uint32_t* __restrict__ words, int2* __restrict__ out,
                int64_t window_len, int tile, int fc, int g_max, int w_cols) {
    extern __shared__ int acc[];  // [0, tile): meth, [tile, 2 * tile): cov
    const int t = blockIdx.x;
    for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) acc[i] = 0;
    __syncthreads();
    const int64_t site0 = (int64_t)t * tile;
    const int n_cols = 16 * w_cols;  // codes held by a row's words
    const int c_end = c1[t];
    for (int c = c0[t > 0 ? t - 1 : 0]; c < c_end; ++c) {
        const int* m = meta + (int64_t)c * 3 * fc;
        for (int r = threadIdx.x; r < fc; r += blockDim.x) {
            const int lw = __ldg(m + fc + r);
            const int dg = lw >> 16;
            if (dg < 0 || dg >= g_max) continue;
            const int64_t rel = __ldg(m + r);
            const int64_t len = min(lw & 0xFFFF, n_cols);
            const int64_t j0 = max((int64_t)0, site0 - rel);
            const int64_t j1 = min(len, site0 + tile - rel);
            if (j0 >= j1) continue;
            const int n = __ldg(m + 2 * fc + r);
            const uint32_t* w = words + ((int64_t)c * fc + r) * w_cols;
            const int off = (int)(rel - site0);  // in (-n_cols, tile)
            for (int j = (int)j0; j < (int)j1; ++j) {
                const uint32_t code =
                    (__ldg(w + j % w_cols) >> (2 * (j / w_cols))) & 3u;
                if (code != 3u) {
                    atomicAdd(acc + tile + off + j, n);
                    if (code != 0u) atomicAdd(acc + off + j, n);
                }
            }
        }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < tile; i += blockDim.x) {
        const int64_t site = site0 + i;
        if (site < window_len) out[site] = make_int2(acc[i], acc[tile + i]);
    }
}

}  // namespace

extern "C" {

int pileup_tiles_v2(const void* c0, const void* c1, const void* meta,
                    const void* words, void* out, int64_t num_tiles,
                    int64_t window_len, int64_t tile, int64_t fc,
                    int64_t g_max, int64_t w_cols, void* stream) {
    return wgbs::launch(tiles_v2_kernel, dim3((unsigned)num_tiles), THREADS,
                        (size_t)tile * 2 * sizeof(int), stream, (const int*)c0,
                        (const int*)c1, (const int*)meta,
                        (const uint32_t*)words, (int2*)out, window_len,
                        (int)tile, (int)fc, (int)g_max, (int)w_cols);
}

}  // extern "C"
