// Hand-written Hopper (sm_90a) kernel for the v1 staged pileup
// (wgbs_tools_tpu_torch/ops/pileup_v1.py, the host prep of
// wgbs_tools_tpu/ops/pileup_tpu.py::pileup_pallas): one fragment per row, in
// start order, rows padded to whole chunks of fc.
//
//   lo, hi  int32 [num_tiles]        fragment rows [lo[t], hi[t]) that can reach
//                                    output tile t (a host searchsorted that looks
//                                    back max_len - 1 sites)
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
// '.'(3), at site start + j for j < length -- ref stdin2beta.cpp:59-93.
//
// Design: one CTA per 1024-site output tile walks its rows [lo[t], hi[t]),
// one thread per fragment, and adds the fragment's in-tile sites into a
// shared (2, tile) int32 accumulator with shared-memory atomics (rows overlap;
// integer atomics are exact, in any order). v1 does not split long
// fragments, so max_len follows the batch's widest fragment (nanopore reads
// reach thousands of sites); the TPU kernel sizes its accumulator as
// tile + 2 * max_len lanes and rolls every row across it. Here the shared
// memory is the tile alone and a thread's loop runs over the fragment's
// in-tile sites only, so any max_len works. Every site belongs to one tile
// and one CTA, so the tile is written whole, zeros where no fragment
// reaches it, with no carry and no global atomics.
//
// Bound: shared-memory atomics and the row walk (one thread per fragment),
// not device-memory bytes: meta is 16 B and the words 4 * w16 B per row.
//
// No entry point sets the CUDA device (see launch.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;

// Replaces wgbs_tools_tpu/ops/pileup_tpu.py::_pileup_kernel.
__global__ void __launch_bounds__(THREADS)
tiles_v1_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                const int* __restrict__ meta,
                const uint32_t* __restrict__ words, int2* __restrict__ out,
                int64_t window_len, int tile, int fc, int w16) {
    extern __shared__ int acc[];  // [0, tile): meth, [tile, 2 * tile): cov
    const int t = blockIdx.x;
    for (int i = threadIdx.x; i < 2 * tile; i += blockDim.x) acc[i] = 0;
    __syncthreads();
    const int64_t site0 = (int64_t)t * tile;
    const int max_len = 16 * w16;  // codes held by a row's words
    const int f_end = hi[t];
    for (int f = lo[t] + (int)threadIdx.x; f < f_end; f += blockDim.x) {
        const int* m = meta + (int64_t)(f / fc) * 4 * fc + f % fc;
        const int64_t start = __ldg(m);
        const int64_t len = min(__ldg(m + fc), max_len);
        const int64_t j0 = max((int64_t)0, site0 - start);
        const int64_t j1 = min(len, site0 + tile - start);
        if (j0 >= j1) continue;
        const int n = __ldg(m + 2 * fc);
        const uint32_t* w = words + (int64_t)f * w16;
        const int off = (int)(start - site0);  // in (-max_len, tile)
        for (int j = (int)j0; j < (int)j1; ++j) {
            const uint32_t code = (__ldg(w + j % w16) >> (2 * (j / w16))) & 3u;
            if (code != 3u) {
                atomicAdd(acc + tile + off + j, n);
                if (code != 0u) atomicAdd(acc + off + j, n);
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

int pileup_tiles_v1(const void* lo, const void* hi, const void* meta,
                    const void* words, void* out, int64_t num_tiles,
                    int64_t window_len, int64_t tile, int64_t fc, int64_t w16,
                    void* stream) {
    return wgbs::launch(tiles_v1_kernel, dim3((unsigned)num_tiles), THREADS,
                        (size_t)tile * 2 * sizeof(int), stream, (const int*)lo,
                        (const int*)hi, (const int*)meta,
                        (const uint32_t*)words, (int2*)out, window_len,
                        (int)tile, (int)fc, (int)w16);
}

}  // extern "C"
