// Hand-written Hopper (sm_90a) kernel for the serial segmentation DP of the
// fused analysis step (wgbs_tools_tpu_torch/ops/dp_scan.py::dp_scan):
//
//   C    f32 [nb][n][W]  cost rows in ascending-k order, one chain per b:
//                        C[b][i][k] = cost(i - (W-1) + k, i), -inf where
//                        invalid or too long
//   ks   i32 [nb][n]     ks[b][i] = i - (W-1) + am, am the FIRST maximum of
//                        cand[k] = M[i+1+k] + C[b][i][k] over k in [0, W)
//   ring f32 [nb][W]     global scratch for M, used only when W > SMEM_W_MAX
//
// M has n + W + 1 slots per chain: M[W] = 0, the rest -inf, and step i
// writes M[W+i+1] = cand[am]. Replaces wgbs_tools_tpu/parallel/sharded.py::
// _dp_scan (:105-122), a lax.scan with one dependent step per CpG site
// inside the analysis step's shard_map.
//
// Bound: the chain. Each step needs the value the step before produced, so
// n steps run one after another whatever the card's width; the data, nb *
// n * (W + 1) * 4 B, is read and written once (a few ms at 3.35 TB/s for a
// 14 M-site shard at W 64). The least a step can take is one add and one
// comparison on the newest M (the other W - 1 candidates can be formed off
// the chain); this design pays more a step (below), and making the step
// shorter is later work.
//
// The design: one warp (one CTA of 32 threads) per chain; lane l takes the
// candidates k = l, l + 32, ... of each step.
// * M is a ring of W floats, M[p] at ring[p % W]. Step i reads M[i+1 ..
//   i+W] and then overwrites M[i+1]'s slot with M[W+i+1]; only lane 0 (k =
//   0) reads that slot, so the write needs no barrier before it, and a
//   __syncwarp after it makes it visible to the lane that reads it next step
//   (k = W-1). The ring sits in shared memory up to W = SMEM_W_MAX (16 KB),
//   in the global scratch above.
// * The cost rows do not depend on the chain: up to SMEM_W_MAX they are
//   copied into shared memory a tile of `rows` rows (rows * W <= 8,192
//   floats) at a time with cp.async, double-buffered, so a tile's copy runs
//   while the warp steps through the one before (a step is far shorter than
//   a load from device memory). Above SMEM_W_MAX each step reads its row
//   from global memory directly: each lane then has W / 32 independent
//   loads in flight, and one latency a step is small beside W / 32 adds.
// * The maximum: each lane keeps its best (key, k), the first of equal keys;
//   then two warp reductions (redux.sync: the largest key, then the smallest
//   k of a lane holding it) give the first maximum in every lane. The key
//   is the float's bits mapped to an order-preserving uint32, with -0.0 as
//   +0.0 (they compare equal) and every NaN as the largest key (jnp.argmax
//   takes the first NaN). M[W+i+1] is the key mapped back: the maximum's
//   value, up to the sign of a zero and a NaN's payload, which no later
//   comparison sees.
// * ks: lane (i % 32) keeps step i's k, and every 32 steps (and at the
//   end) the warp stores its 32 ks in one coalesced 128-byte write.
//
// Exactness: each candidate is one IEEE f32 add of the same two operands as
// the plain version's (no multiply, so nothing to contract into an FMA; no
// fast-math flags), and the reductions are exact, so ks equal the plain
// version's and JAX's bit for bit, ties to the smaller k, an all -inf row
// to am = 0.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int SMEM_W_MAX = 4096;     // the widest W with the ring in shared
constexpr int TILE_FLOATS = 8192;    // cost floats per tile buffer (32 KB)
constexpr int MAX_TILE_ROWS = 64;

// Order-preserving key: a < b as floats <=> key(a) < key(b), -0.0 and +0.0
// one key, NaN above +inf. Every key is at least key(-inf) = 0x007FFFFF.
__device__ __forceinline__ unsigned order_key(float v) {
    if (v != v) return FULL;
    unsigned u = __float_as_uint(v);
    if ((u << 1) == 0u) u = 0u;
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned key) {
    return __uint_as_float((key & 0x80000000u) ? (key & 0x7FFFFFFFu) : ~key);
}

// One step of the chain: reads the ring and `crow` (the step's W costs),
// writes M[W+i+1] and keeps ks[i]. `base` is (i + 1) % W.
__device__ __forceinline__ void dp_step(float* ring, const float* crow,
                                        int W, int base, int64_t i,
                                        int64_t n, int* kb, int lane,
                                        int& mine) {
    unsigned bkey = 0u, bidx = FULL;
    for (int k = lane; k < W; k += WARP) {
        int s = base + k;
        if (s >= W) s -= W;
        const unsigned key = order_key(ring[s] + crow[k]);
        if (key > bkey) {  // strict: the first k of a lane's equal keys
            bkey = key;
            bidx = (unsigned)k;
        }
    }
    const unsigned kmax = __reduce_max_sync(FULL, bkey);
    const unsigned am = __reduce_min_sync(FULL, bkey == kmax ? bidx : FULL);
    if (lane == 0) ring[base] = key_value(kmax);
    const int r = (int)(i & (WARP - 1));
    if (lane == r) mine = (int)(i - (W - 1) + (int64_t)am);
    if ((r == WARP - 1 || i == n - 1) && lane <= r) kb[i - r + lane] = mine;
    __syncwarp();
}

template <bool SMEM>
__global__ void __launch_bounds__(WARP)
    dp_scan_kernel(const float* __restrict__ C, int* __restrict__ ks,
                   float* __restrict__ gring, int64_t n, int W, int rows) {
    extern __shared__ float smem[];
    const int lane = threadIdx.x;
    const int64_t b = blockIdx.x;
    const float* Cb = C + b * n * (int64_t)W;
    int* kb = ks + b * n;
    float* ring = SMEM ? smem + 2 * (size_t)rows * W : gring + b * W;
    // M[1 .. W-1] = -inf, M[W] = 0 at slot 0
    for (int s = lane; s < W; s += WARP) ring[s] = s ? -CUDART_INF_F : 0.0f;
    __syncwarp();
    int base = W > 1 ? 1 : 0;
    int mine = 0;

    if (!SMEM) {
        for (int64_t i = 0; i < n; ++i) {
            dp_step(ring, Cb + i * W, W, base, i, n, kb, lane, mine);
            if (++base == W) base = 0;
        }
        return;
    }

    const int64_t n_tiles = (n + rows - 1) / rows;
    const size_t tile_floats = (size_t)rows * W;
    auto issue = [&](int64_t t) {
        float* dst = smem + (t & 1) * tile_floats;
        const int64_t r0 = t * rows;
        const int cnt = (int)((n - r0 < rows ? n - r0 : rows) * W);
        const float* src = Cb + r0 * W;
        for (int e = lane; e < cnt; e += WARP)
            __pipeline_memcpy_async(dst + e, src + e, sizeof(float));
        __pipeline_commit();
    };
    issue(0);
    for (int64_t t = 0; t < n_tiles; ++t) {
        if (t + 1 < n_tiles) {
            // the buffer it fills was last read in tile t - 1, before the
            // __syncwarp that ended it
            issue(t + 1);
            __pipeline_wait_prior(1);
        } else {
            __pipeline_wait_prior(0);
        }
        __syncwarp();  // every lane's copies of tile t are visible
        const float* tile = smem + (t & 1) * tile_floats;
        const int64_t r0 = t * rows;
        const int nr = (int)(n - r0 < rows ? n - r0 : rows);
        for (int r = 0; r < nr; ++r) {
            dp_step(ring, tile + (size_t)r * W, W, base, r0 + r, n, kb, lane,
                    mine);
            if (++base == W) base = 0;
        }
    }
}

}  // namespace

extern "C" {

// The rows of cost a tile holds for width W (0: no tiles, W > SMEM_W_MAX)
// and the dynamic shared memory of the launch, in bytes.
static void dp_scan_geometry(int64_t W, int* rows, size_t* smem) {
    if (W > SMEM_W_MAX) {
        *rows = 0;
        *smem = 0;
        return;
    }
    int r = TILE_FLOATS / (int)W;
    r = r < 1 ? 1 : (r > MAX_TILE_ROWS ? MAX_TILE_ROWS : r);
    *rows = r;
    *smem = (2 * (size_t)r * W + W) * sizeof(float);
}

// Launches one CTA of one warp per chain on `stream` (the current device).
// `ring` (f32 [nb][W]) is read only when W > SMEM_W_MAX, and must then be
// given. Bad sizes return cudaErrorInvalidValue (the wrapper checks first).
int dp_scan(const void* C, void* ks, void* ring, int64_t nb, int64_t n,
            int64_t W, void* stream) {
    if (nb < 0 || nb > INT32_MAX || n < 0 || n > INT32_MAX || W < 1 ||
        W > (1 << 24))
        return (int)cudaErrorInvalidValue;
    if (nb == 0 || n == 0) return 0;
    int rows;
    size_t smem;
    dp_scan_geometry(W, &rows, &smem);
    if (rows) {
        return wgbs::launch(dp_scan_kernel<true>, dim3((unsigned)nb), WARP,
                            smem, stream, (const float*)C, (int*)ks,
                            (float*)nullptr, n, (int)W, rows);
    }
    if (ring == nullptr) return (int)cudaErrorInvalidValue;
    return wgbs::launch(dp_scan_kernel<false>, dim3((unsigned)nb), WARP,
                        (size_t)0, stream, (const float*)C, (int*)ks,
                        (float*)ring, n, (int)W, 0);
}

}  // extern "C"
