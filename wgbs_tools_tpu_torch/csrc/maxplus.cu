// Hand-written Hopper (sm_90a) kernel for the max-plus closure of the fast
// segmentation DP's in-block edge matrices
// (wgbs_tools_tpu_torch/ops/maxplus.py::maxplus_closure):
//
//   S0     f32 [nb][n][n]   per block of B = n - 1 borders, S0 = I (+) A: 0
//                           on the diagonal, the edge costs above it, -inf
//                           elsewhere
//   sched  i32 [SLOTS][THREADS]  the upper schedule of n (maxplus.py::
//                           upper_schedule): tile (a, c) as a << 16 | c per
//                           slot and thread, -1 where the thread is idle
//   out    f32 [nb][n][n]   S0 squared `steps` times in the (max, +)
//                           semiring, S'[p][q] = max_r S[p][r] + S[r][q]
//
// Replaces `closure` inside wgbs_tools_tpu/models/segment.py::
// _dp_fast_blocked (:313-329), which XLA computes on the TPU as a max over
// the broadcast S[:, :, None] + S[None, :, :], fused so the n^3 sums never
// reach memory. Plain PyTorch materializes them (129^3 floats, 8.6 MB, per
// block and squaring); here one block's matrix stays on chip for all of its
// squarings.
//
// Bound: operations. A squaring is up to n^3 (add, max) pairs, 2 FP32
// instructions each, against 2 * n^2 * 4 B in and out of device memory per
// closure: far above the card's ~10 FP32 instructions per byte of device
// memory (132 SMs x 128 lanes x ~2 GHz over 3.35 TB/s). The work that can
// win is smaller: on the DP's matrices (A strictly upper triangular, a
// shape that squaring keeps) only p <= r <= q, about a seventh of n^3.
//
// One CTA per matrix, THREADS = 256. While it loads S0 into shared memory
// the CTA finds out whether an entry strictly below the diagonal is finite
// (__syncthreads_or); it then takes one of two schedules, both exact:
//
// * upper (nothing finite below the diagonal; the DP's case). One buffer
//   M, NMAX x LD floats, holds S on and above the diagonal and S's
//   transpose below it: M[i][j] = S[min(i, j)][max(i, j)], so row r of M
//   gives both operands as rows, S[p][r] (p <= r) at M[r][p] and S[r][q]
//   (q >= r) at M[r][q]; rows and columns from n on hold -inf. The outputs
//   are 4 x 4 tiles [p_lo, p_lo + 3] x [q_lo, q_lo + 3] of the side padded
//   to a multiple of 4 (132 for n = 129); only tiles with c >= a exist, and
//   tile (a, c) scans r over [p_lo, min(q_lo + 3, n - 1)] only. Per r a
//   thread reads a = M[r][p_lo .. +3] and b = M[r][q_lo .. +3] as two
//   float4 loads and does up to 16 (add, max) pairs. At its first 3 r
//   (some p > r) and its last 3 (some q < r) a tile's reads cross M's
//   diagonal; there, in loops unrolled so that the bounds are constants,
//   only the rows p <= r and the columns q >= r are updated (the others'
//   true term is -inf). So each output scans exactly r in [p, min(q, n-1)]:
//   the triangle, plus the padding columns (1.069x the triangle at n =
//   129). Which tiles a thread computes is the table `sched`, built on the
//   host (one per n): up to SLOTS tiles per thread, each warp's lanes in a
//   slot on tiles of nearly one r length, and the warps on each of the
//   SM's four schedulers given nearly equal sums of r lengths. A thread
//   keeps its tiles in registers until every read of the squaring is done,
//   then writes each to M twice (as itself and transposed; a diagonal tile
//   once, folded) between two barriers.
// * general (something finite below the diagonal): the kernel's first
//   body, kept as it was. S in shared memory, NMAX x 144; thread (ty, tx)
//   of 16 x 16 owns the 9 x 9 outputs p = ty + 16 i, q = tx + 16 j and
//   scans every r.
//
// One buffer of 85,248 B lets two CTAs share an SM (registers: at most 128
// a thread), so one CTA's loads, stores and barriers overlap the other's
// squarings. On an H100 (kernel_ab.py) S and its transpose in two buffers
// (one CTA per SM) took 1.19x as long, and 8 x 4 tiles (fewer shared
// reads per pair, a coarser balance) 1.17x. LD = 148 (a multiple of 4
// with 4 LD = 16 mod 32 words) puts the 16-byte reads of the 8 lanes of a
// quarter warp on tiles (a, a + d), consecutive a, on 8 distinct groups
// of 4 banks; lanes on one tile row share the address of a.
//
// Exactness: max is exact and each a + b is one IEEE rounding (no multiply,
// so no contraction into an FMA, and no fast-math flags); -inf + x = -inf,
// and no +inf or NaN enters (the plain version asserts it). A (p, r, q)
// that the upper schedule skips has S[p][r] or S[r][q] below the diagonal,
// an exact -inf term: max(acc, -inf + x) is acc. So both schedules give
// the plain version's result bit for bit, whatever order r is scanned in.
// Squaring keeps S upper triangular (a tile's entries below the diagonal
// stay -inf and are never stored), and the output gets -inf there.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int NMAX = 144;         // largest matrix side
// upper schedule
constexpr int TILE = 4;           // output tile side (one float4)
constexpr int SLOTS = 3;          // tiles per thread at most
constexpr int LD = 148;           // row stride of M
// general schedule (the first body)
constexpr int TY = 16;            // thread rows
constexpr int TX = 16;            // thread columns
constexpr int TI = 9;             // outputs per thread along p
constexpr int TJ = 9;             // outputs per thread along q
constexpr int LDG = 144;          // row stride of S
constexpr size_t SMEM = (size_t)NMAX * LD * sizeof(float);  // 85,248 B
constexpr int MAX_DEVICES = 64;

static_assert(TY * TX == THREADS && TY * TI == NMAX && TX * TJ == NMAX,
              "the general body's thread tile must cover NMAX x NMAX");
static_assert(NMAX * LDG <= NMAX * LD, "the general body's S must fit");
static_assert(LD % TILE == 0 && (TILE * LD) % 32 == 16 && LD >= NMAX,
              "LD: float4 rows, quarter warps on distinct banks");
static_assert(NMAX * (NMAX / TILE + 1) / TILE / 2 <= SLOTS * THREADS,
              "every upper tile of NMAX needs a slot");

// S -> S^steps, general: any finite / -inf matrix.
__device__ __forceinline__ void closure_general(
    float* S, const float* __restrict__ A0, float* __restrict__ O, int n,
    int steps) {
    const int tx = threadIdx.x % TX;
    const int ty = threadIdx.x / TX;
    for (int e = threadIdx.x; e < NMAX * LDG; e += THREADS) {
        const int p = e / LDG, q = e - p * LDG;
        S[e] = (p < n && q < n) ? A0[(size_t)p * n + q] : -CUDART_INF_F;
    }
    __syncthreads();

    const float* col = S + ty * LDG;   // a[i] = S[ty + TY * i][r]
    for (int s = 0; s < steps; ++s) {
        float acc[TI][TJ];
#pragma unroll
        for (int i = 0; i < TI; ++i)
#pragma unroll
            for (int j = 0; j < TJ; ++j) acc[i][j] = -CUDART_INF_F;
        for (int r = 0; r < n; ++r) {
            float a[TI], b[TJ];
#pragma unroll
            for (int i = 0; i < TI; ++i) a[i] = col[i * TY * LDG + r];
            const float* row = S + r * LDG + tx;  // b[j] = S[r][tx + TX * j]
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
                if (p < n && q < n) S[p * LDG + q] = acc[i][j];
            }
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < n * n; e += THREADS) {
        const int p = e / n, q = e - p * n;
        O[e] = S[p * LDG + q];
    }
}

// acc[i][j] = max(acc[i][j], S[p_lo + i][r] + S[r][q_lo + j]) for one r,
// from row r of M (row = M + r * LD), for the rows i < rows and the
// columns j >= col0 only: the others would read across M's diagonal,
// where S holds -inf, and fmaxf(acc, -inf) is acc. rows and col0 are
// constants wherever it is called (the loops around it are unrolled).
__device__ __forceinline__ void upper_step(const float* row, int p_lo,
                                           int q_lo, float (&acc)[TILE][TILE],
                                           int rows = TILE, int col0 = 0) {
    const float4 x = *reinterpret_cast<const float4*>(row + p_lo);
    const float4 y = *reinterpret_cast<const float4*>(row + q_lo);
    const float a[TILE] = {x.x, x.y, x.z, x.w};
    const float b[TILE] = {y.x, y.y, y.z, y.w};
#pragma unroll
    for (int i = 0; i < TILE; ++i)
#pragma unroll
        for (int j = 0; j < TILE; ++j)
            if (i < rows && j >= col0)
                acc[i][j] = fmaxf(acc[i][j], a[i] + b[j]);
}

// M -> M^steps, upper: M (loaded) holds an S that is -inf strictly below
// the diagonal. tiles[k] is this thread's tile of slot k (-1: none).
__device__ __forceinline__ void closure_upper(
    float* M, float* __restrict__ O, const int (&tiles)[SLOTS], int n,
    int steps) {
    for (int s = 0; s < steps; ++s) {
        float acc[SLOTS][TILE][TILE];
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
#pragma unroll
            for (int i = 0; i < TILE; ++i)
#pragma unroll
                for (int j = 0; j < TILE; ++j) acc[k][i][j] = -CUDART_INF_F;
            if (tiles[k] < 0) continue;
            const int p_lo = TILE * (tiles[k] >> 16);
            const int q_lo = TILE * (tiles[k] & 0xffff);
            if (p_lo == q_lo) {  // a diagonal tile: r = p_lo + t
#pragma unroll
                for (int t = 0; t < TILE; ++t)
                    if (p_lo + t < n)
                        upper_step(M + (p_lo + t) * LD, p_lo, q_lo, acc[k],
                                   t + 1, t);
                continue;
            }
            // the first TILE - 1 r reach rows i <= r - p_lo only, the
            // last TILE - 1 (those below n) columns j >= r - q_lo only
#pragma unroll
            for (int t = 0; t < TILE - 1; ++t)
                upper_step(M + (p_lo + t) * LD, p_lo, q_lo, acc[k], t + 1);
            const float* row = M + (p_lo + TILE - 1) * LD;
#pragma unroll 4
            for (int r = p_lo + TILE - 1; r <= q_lo; ++r, row += LD)
                upper_step(row, p_lo, q_lo, acc[k]);
#pragma unroll
            for (int t = 1; t < TILE; ++t)
                if (q_lo + t < n)
                    upper_step(M + (q_lo + t) * LD, p_lo, q_lo, acc[k], TILE,
                               t);
        }
        __syncthreads();  // every read of this squaring is done
#pragma unroll
        for (int k = 0; k < SLOTS; ++k) {
            if (tiles[k] < 0) continue;
            const int p_lo = TILE * (tiles[k] >> 16);
            const int q_lo = TILE * (tiles[k] & 0xffff);
            float (&t)[TILE][TILE] = acc[k];
#pragma unroll
            for (int i = 0; i < TILE; ++i) {
                if (p_lo == q_lo) {  // a diagonal tile: S above, folded
                    *reinterpret_cast<float4*>(M + (p_lo + i) * LD + p_lo) =
                        make_float4(t[min(i, 0)][max(i, 0)],
                                    t[min(i, 1)][max(i, 1)],
                                    t[min(i, 2)][max(i, 2)],
                                    t[min(i, 3)][max(i, 3)]);
                } else {
                    *reinterpret_cast<float4*>(M + (p_lo + i) * LD + q_lo) =
                        make_float4(t[i][0], t[i][1], t[i][2], t[i][3]);
                    *reinterpret_cast<float4*>(M + (q_lo + i) * LD + p_lo) =
                        make_float4(t[0][i], t[1][i], t[2][i], t[3][i]);
                }
            }
        }
        __syncthreads();
    }

    for (int p = threadIdx.x / 32; p < n; p += THREADS / 32)
        for (int q = threadIdx.x % 32; q < n; q += 32)
            O[p * n + q] = p <= q ? M[p * LD + q] : -CUDART_INF_F;
}

__global__ void __launch_bounds__(THREADS, 2)
maxplus_closure_kernel(const float* __restrict__ S0, float* __restrict__ out,
                       const int* __restrict__ sched, int n, int steps) {
    extern __shared__ float4 smem4[];
    float* M = reinterpret_cast<float*>(smem4);
    const size_t base = (size_t)blockIdx.x * n * n;
    const float* A0 = S0 + base;
    int tiles[SLOTS];
#pragma unroll
    for (int k = 0; k < SLOTS; ++k)
        tiles[k] = sched[k * THREADS + threadIdx.x];

    // M over the padded side np (rows and columns from n on -inf; rows from
    // np on are never read): S[p][q], p <= q, to M[p][q] and M[q][p]. Warp
    // w loads rows w, w + 8, ..., ROWS of them at once, each lane its
    // columns lane + 32 j; the entries below the diagonal are only tested
    const int np = (n + TILE - 1) / TILE * TILE;
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    constexpr int WARPS = THREADS / 32, COLS = (NMAX + 31) / 32, ROWS = 4;
    int below = 0;
    for (int p0 = warp; p0 < np; p0 += ROWS * WARPS) {
        float v[ROWS][COLS];
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int p = p0 + u * WARPS, q = lane + 32 * j;
                v[u][j] = (p < n && q < n) ? A0[p * n + q] : -CUDART_INF_F;
            }
#pragma unroll
        for (int u = 0; u < ROWS; ++u)
#pragma unroll
            for (int j = 0; j < COLS; ++j) {
                const int p = p0 + u * WARPS, q = lane + 32 * j;
                if (p > q) {
                    below |= !(v[u][j] == -CUDART_INF_F);
                } else if (q < np) {
                    M[p * LD + q] = v[u][j];
                    M[q * LD + p] = v[u][j];
                }
            }
    }
    if (__syncthreads_or(below))
        closure_general(M, A0, out + base, n, steps);
    else
        closure_upper(M, out + base, tiles, n, steps);
}

// The dynamic shared memory attribute is per device; it is set at the first
// launch on each device only (a repeated set costs host time per launch).
bool g_attr_set[MAX_DEVICES];

}  // namespace

extern "C" {

// n outside [1, NMAX] or a negative nb / steps returns cudaErrorInvalidValue
// (the wrapper checks first). `sched` is upper_schedule(n) on the device
// (the wrapper's cached copy). Launches on `stream` on the current device.
int maxplus_closure(const void* S0, void* out, const void* sched, int64_t nb,
                    int64_t n, int64_t steps, void* stream) {
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
        (const float*)S0, (float*)out, (const int*)sched, (int)n,
        (int)steps);
    return (int)cudaGetLastError();
}

}  // extern "C"
