// Hand-written Hopper (sm_90a) kernel for the max-plus closure of the fast
// segmentation DP's in-block edge matrices
// (wgbs_tools_tpu_torch/ops/maxplus.py::maxplus_closure):
//
//   S0   f32 [nb][n][n]   per block of B = n - 1 borders, S0 = I (+) A: 0 on
//                         the diagonal, the edge costs above it, -inf elsewhere
//   out  f32 [nb][n][n]   S0 squared `steps` times in the (max, +) semiring,
//                         S'[p][q] = max_r S[p][r] + S[r][q]
//
// Replaces `closure` inside wgbs_tools_tpu/models/segment.py::
// _dp_fast_blocked (:313-329), which XLA computes on the TPU as a max over
// the broadcast S[:, :, None] + S[None, :, :], fused so the n^3 sums never
// reach memory. Plain PyTorch materializes them (129^3 floats, 8.6 MB, per
// block and squaring); here one block's matrix stays on chip for all of its
// squarings.
//
// Bound: operations. A squaring is n^3 (add, max) pairs, 2 FP32
// instructions each, against 2 * n^2 * 4 B in and out of device memory per
// closure: at n = 129 and 7 steps about 230 instructions per byte, far
// above the card's ~10 FP32 instructions per byte of device memory (132 SMs
// x 128 lanes x ~2 GHz over 3.35 TB/s).
//
// Design (right and simple first; tiling for more reuse is later work): one
// CTA per matrix, its S in shared memory, NMAX x LD floats (rows and columns
// from n to NMAX hold -inf; LD = 144 puts the two rows a warp reads, ty and
// ty + 1, 16 banks apart). 256 threads as 16 x 16; thread (ty, tx) owns the
// 9 x 9 outputs p = ty + 16 i, q = tx + 16 j in registers: per r it loads 9
// values of column r and 9 of row r, and does 81 (add, max) pairs. After a
// squaring every thread writes its outputs back into the one buffer between
// two barriers. NMAX = 144 >= 129 = B + 1 covers the DP's blocks.
//
// Exactness: max is exact and each a + b is one IEEE rounding (no multiply,
// so no contraction into an FMA, and no fast-math flags); -inf + x = -inf,
// and no +inf or NaN enters (the plain version asserts it). So the result
// is the plain version's, bit for bit, whatever order r is scanned in.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int TY = 16;            // thread rows
constexpr int TX = 16;            // thread columns
constexpr int TI = 9;             // outputs per thread along p
constexpr int TJ = 9;             // outputs per thread along q
constexpr int NMAX = TY * TI;     // largest matrix side (144)
constexpr int LD = 144;           // row stride of S in shared memory
constexpr int THREADS = TY * TX;
constexpr size_t SMEM = (size_t)NMAX * LD * sizeof(float);  // 82,944 B
constexpr int MAX_DEVICES = 64;

static_assert(TX * TJ == NMAX, "the thread tile must cover NMAX columns");
static_assert(LD >= NMAX, "a row of S must hold NMAX columns");

__global__ void __launch_bounds__(THREADS, 2)
maxplus_closure_kernel(const float* __restrict__ S0, float* __restrict__ out,
                       int n, int steps) {
    extern __shared__ float S[];
    const size_t base = (size_t)blockIdx.x * n * n;
    const int tx = threadIdx.x % TX;
    const int ty = threadIdx.x / TX;

    for (int e = threadIdx.x; e < NMAX * LD; e += THREADS) {
        const int p = e / LD, q = e - p * LD;
        S[e] = (p < n && q < n) ? S0[base + (size_t)p * n + q] : -CUDART_INF_F;
    }
    __syncthreads();

    const float* col = S + ty * LD;   // a[i] = S[ty + TY * i][r]
    for (int s = 0; s < steps; ++s) {
        float acc[TI][TJ];
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TJ; ++j) acc[i][j] = -CUDART_INF_F;
        for (int r = 0; r < n; ++r) {
            float a[TI], b[TJ];
#pragma unroll
            for (int i = 0; i < TI; ++i) a[i] = col[i * TY * LD + r];
            const float* row = S + r * LD + tx;  // b[j] = S[r][tx + TX * j]
#pragma unroll
            for (int j = 0; j < TJ; ++j) b[j] = row[j * TX];
#pragma unroll
            for (int i = 0; i < TI; ++i)
#pragma unroll
                for (int j = 0; j < TJ; ++j)
                    acc[i][j] = fmaxf(acc[i][j], a[i] + b[j]);
        }
        __syncthreads();  // every read of this squaring is done
#pragma unroll
        for (int i = 0; i < TI; ++i) {
            const int p = ty + TY * i;
#pragma unroll
            for (int j = 0; j < TJ; ++j) {
                const int q = tx + TX * j;
                if (p < n && q < n) S[p * LD + q] = acc[i][j];
            }
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < n * n; e += THREADS) {
        const int p = e / n, q = e - p * n;
        out[base + e] = S[p * LD + q];
    }
}

// The dynamic shared memory attribute is per device; it is set at the first
// launch on each device only (a repeated set costs host time per launch).
bool g_attr_set[MAX_DEVICES];

}  // namespace

extern "C" {

// n outside [1, NMAX] or a negative nb / steps returns cudaErrorInvalidValue
// (the wrapper checks first). Launches on `stream` on the current device.
int maxplus_closure(const void* S0, void* out, int64_t nb, int64_t n,
                    int64_t steps, void* stream) {
    if (n < 1 || n > NMAX || nb < 0 || nb > INT32_MAX || steps < 0)
        return (int)cudaErrorInvalidValue;
    if (nb == 0) return 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev < 0 || dev >= MAX_DEVICES) return (int)cudaErrorInvalidDevice;
    if (!g_attr_set[dev]) {
        err = cudaFuncSetAttribute(maxplus_closure_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)SMEM);
        if (err != cudaSuccess) return (int)err;
        g_attr_set[dev] = true;
    }
    maxplus_closure_kernel<<<(unsigned)nb, THREADS, SMEM,
                             (cudaStream_t)stream>>>(
        (const float*)S0, (float*)out, (int)n, (int)steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
