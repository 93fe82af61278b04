// Hand-written Hopper (sm_90a) kernel for the block sums of beta_to_blocks
// and beta_to_table (wgbs_tools_tpu_torch/ops/reduceat.py::block_sums):
//
//   data    u8 or u16 [N][2]  a beta (.beta / .bin) or lbeta table as it is
//                             on disk: (meth, cov) per CpG site
//   bounds  i64 [B][2]        each block's [s, e) rows of data, already
//                             clipped to [0, N] with e >= s (the wrapper's
//                             ops/reduceat.py::block_bounds; an NA block is
//                             [0, 0))
//   out     i64 [B][2]        out[b] = sum of data[s:e] per column
//
// Replaces wgbs_tools_tpu/ops/reduceat.py::_reduce_nice (:17), a
// jax.ops.segment_sum over per-site block ids, and the per-block numpy sums
// of reduce_data_to_blocks' other path (:68-71): both compute this function,
// each block summing its own clipped range. Taking [s, e) per block means
// no per-site id array (28 M entries at hg19) is built on the host, and
// overlapping, unsorted or duplicated blocks need no second path. The sums
// are 64-bit, so a block whose coverage passes 2^31 (a whole chromosome at
// coverage 255) is exact; JAX's segment_sum sums in int32 and wraps there.
//
// Bound: bytes. Each site's 2 (or 4) bytes are read once and each block
// writes 16 bytes and reads its 16 bytes of bounds: ~0.1 us of work per
// 26-site block against the ~1 ns each byte takes at 3.35 TB/s, so the
// kernel is a streaming read at memory rate if enough blocks are in flight.
//
// One warp per block: lane l sums rows s + l, s + l + 32, ... (a warp's
// loads are one contiguous run of the table), then a shuffle tree adds the
// 32 lanes' 64-bit sums and lane 0 writes the block's pair. A block of a
// few dozen sites takes one or two loads a lane; a block of millions of
// sites keeps 4 independent loads a lane in flight (the unrolled loop).
// The grid covers B warps, THREADS / 32 per CTA.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int UNROLL = 4;

// one (meth, cov) row as a single 2- or 4-byte load
template <typename T> struct Row;
template <> struct Row<uint8_t> { using V = uchar2; };
template <> struct Row<uint16_t> { using V = ushort2; };

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_sums_kernel(const T* __restrict__ data,
                  const int64_t* __restrict__ bounds,
                  unsigned long long* __restrict__ out, int64_t B) {
    using V = typename Row<T>::V;
    const int64_t b = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / WARP;
    const int lane = threadIdx.x % WARP;
    if (b >= B) return;  // whole warps leave together
    const int64_t s = bounds[2 * b], e = bounds[2 * b + 1];
    const V* rows = reinterpret_cast<const V*>(data);
    unsigned long long m = 0, c = 0;
    int64_t r = s + lane;
    for (; r + (UNROLL - 1) * WARP < e; r += UNROLL * WARP) {
        V v[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) v[u] = rows[r + u * WARP];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            m += v[u].x;
            c += v[u].y;
        }
    }
    for (; r < e; r += WARP) {
        const V v = rows[r];
        m += v.x;
        c += v.y;
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off /= 2) {
        m += __shfl_down_sync(0xffffffffu, m, off);
        c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
        out[2 * b] = m;
        out[2 * b + 1] = c;
    }
}

}  // namespace

extern "C" {

// itemsize 1 (uint8 data) or 2 (uint16); anything else, or B < 0, returns
// cudaErrorInvalidValue. B == 0 launches nothing. Launches on `stream` on
// the current device.
int block_sums(const void* data, const void* bounds, void* out, int64_t B,
               int64_t itemsize, void* stream) {
    if (B < 0 || B > ((int64_t)INT32_MAX) * (THREADS / WARP) ||
        (itemsize != 1 && itemsize != 2))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    const unsigned grid =
        (unsigned)((B + THREADS / WARP - 1) / (THREADS / WARP));
    cudaStream_t st = (cudaStream_t)stream;
    if (itemsize == 1)
        block_sums_kernel<uint8_t><<<grid, THREADS, 0, st>>>(
            (const uint8_t*)data, (const int64_t*)bounds,
            (unsigned long long*)out, B);
    else
        block_sums_kernel<uint16_t><<<grid, THREADS, 0, st>>>(
            (const uint16_t*)data, (const int64_t*)bounds,
            (unsigned long long*)out, B);
    return (int)cudaGetLastError();
}

}  // extern "C"
