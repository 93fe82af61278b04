// Hand-written Hopper (sm_90a) kernels for the block sums of beta_to_blocks
// and beta_to_table (wgbs_tools_tpu_torch/ops/reduceat.py::block_sums):
//
//   data    u8 or u16 [N][2]  a beta (.beta / .bin) or lbeta table as it is
//                             on disk: (meth, cov) per CpG site; rows
//                             aligned to their 2 (4) bytes
//   bounds  i64 [B][2]        each block's [s, e) rows of data, already
//                             clipped to [0, N] with e >= s (the wrapper's
//                             ops/reduceat.py::block_bounds; an NA block is
//                             [0, 0))
//   out     i64 [B][2]        out[b] = sum of data[s:e] per column
//   scratch i64 [B + 1]       the long blocks' list: a count, then indices
//                             (with list_long only)
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
// reads its 16 bytes of bounds and writes 16 bytes. The earlier body (a warp a
// block: one or two loads a lane, then a 64-bit shuffle tree) paid each
// block's load latency in ~130 waves of resident warps: 13.7 % of it.
//
// Staged runs (block_runs_kernel). A run is RUN = 32 consecutive blocks,
// one warp's, a lane each; the warps need no barrier. Warp w of the grid's
// W (as many as fit on the card at once) takes the runs w, w + W, ..., two
// deep: while it sums run k from one of its two shared stages, run k + 1's
// hull is copying into the other (cp.async) and run k + 2's bounds are
// loading, so that the copies overlap the sums. For each run: with
// list_long, a block longer than SPAN_ROWS rows is long: the warp writes
// its zeros and appends it to the long list (a global atomic on its count)
// for the pieces kernel. The other non-empty blocks' hull [lo, hi) decides
// the body:
// - hi - lo <= SPAN_ROWS: the 16-byte groups that cover the hull are
//   copied whole into the stage by cp.async (a group that is not whole
//   inside the table row by row, with 0 outside it), stage byte 0 the
//   16-byte boundary at or below the hull. The stage's rows are cut into
//   chunks of C rows, C the power of two (at least a 32-bit word) that
//   makes at most 32 chunks; lane l sums chunk l's words in an order
//   rotated by the lane (the warp's 32 loads in 32 banks), two uint8 rows a
//   word by two byte dot products (__dp4a), and a warp scan gives each
//   chunk's prefix. A block of at most C rows sums its rows; a longer one
//   is P(e) - P(s), P(x) its chunk's prefix (a shuffle from the chunk's
//   lane) plus the rows of the chunk before x (the rows before the hull
//   cancel): at most 2 C rows a lane either way, whatever the blocks'
//   lengths, order or overlap. All in uint32: a hull of at most SPAN_ROWS
//   rows of uint16 sums below 2^32.
// - a wider hull (sparse or scattered blocks, or a long block without
//   list_long): the warp sums its lanes' blocks from global memory, one at
//   a time, lane l taking rows s + l, s + l + 32, ... (4 loads in flight),
//   then a shuffle tree (the earlier body).
// Long blocks (block_pieces_kernel, a second launch after the runs kernel
// with list_long): each long block is cut into pieces of PIECE_ROWS rows,
// numbered across the list, and CTA c of the grid (SMs x
// PIECE_CTAS_PER_SM) sums the pieces c, c + grid, ... with 16-byte loads,
// adding each piece's sums into the block's zeroed out row with a 64-bit
// atomicAdd: a whole-genome block is summed by the whole card. The sums
// are integers: exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int NWARPS = THREADS / WARP;
constexpr int RUN = WARP;                 // blocks a warp takes, a lane each
// rows of a staged hull at most: with the up to 7 rows before it in its
// first 16 bytes, a stage's STAGE_ROWS hold 32 chunks of 64
constexpr int64_t SPAN_ROWS = 2040;
constexpr int STAGE_ROWS = 2048;
constexpr int64_t PIECE_ROWS = 65536;     // rows of a long block's piece
constexpr int PIECE_CTAS_PER_SM = 4;
constexpr int UNROLL = 4;

// one (meth, cov) row as a single 2- or 4-byte load
template <typename T> struct Row;
template <> struct Row<uint8_t> { using V = uchar2; };
template <> struct Row<uint16_t> { using V = ushort2; };

// A warp's stage: rows from the 16-byte boundary at or below the hull's
// first (at most 7 rows before it) to the end of its last chunk.
template <typename T>
__host__ __device__ constexpr size_t stage_bytes() {
    return STAGE_ROWS * 2 * sizeof(T);
}

// Sums of 32-bit words of rows: two uint8 rows a word (meth, cov, meth,
// cov: one byte dot product each, __dp4a with 1, 0, 1, 0 and 0, 1, 0, 1)
// or one uint16 row.
template <typename T>
struct Acc {
    uint32_t m = 0u, c = 0u;
    __device__ __forceinline__ void add(uint32_t w) {
        if constexpr (sizeof(T) == 1) {
            m = __dp4a(w, 0x00010001u, m);
            c = __dp4a(w, 0x01000100u, c);
        } else {
            m += w & 0xFFFFu;
            c += w >> 16;
        }
    }
    __device__ __forceinline__ void add(uint4 v) {
        add(v.x);
        add(v.y);
        add(v.z);
        add(v.w);
    }
};

// The sums of stage rows [r0, r1) (`st`: the stage as 32-bit words).
template <typename T>
__device__ __forceinline__ void sum_rows(const uint32_t* st, int r0, int r1,
                                         Acc<T>& acc) {
    if constexpr (sizeof(T) == 1) {  // a word holds rows 2k and 2k + 1
        if (r0 < r1 && (r0 & 1)) {
            acc.add(st[r0 >> 1] & 0xFFFF0000u);
            ++r0;
        }
        if (r0 < r1 && (r1 & 1)) {
            acc.add(st[r1 >> 1] & 0x0000FFFFu);
            --r1;
        }
        r0 >>= 1;
        r1 >>= 1;
    }
#pragma unroll 4
    for (int k = r0; k < r1; ++k) acc.add(st[k]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// The sums of rows [s, e) of data by the 32 lanes of a warp, 4 loads a lane
// in flight, added up by a shuffle tree; every lane gets them.
template <typename V>
__device__ __forceinline__ void warp_sum(const V* __restrict__ rows,
                                         int64_t s, int64_t e,
                                         unsigned long long& m,
                                         unsigned long long& c) {
    const int lane = threadIdx.x % WARP;
    m = 0;
    c = 0;
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
        m += __shfl_xor_sync(0xffffffffu, m, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
    }
}

// A run as its warp plans it, the same in all its lanes.
struct Plan {
    int body;          // NONE, WIDE or STAGED
    long long lo, hi;  // the hull of the run's used blocks
    uintptr_t Af;      // STAGED: the 16-byte boundary at or below its start
    int groups;        // the 16-byte groups from Af that cover it
    int r0, rows, lg;  // the hull is stage rows [r0, rows); C = 2^lg
};
constexpr int NONE = 0, WIDE = 1, STAGED = 2;

// Run r, this lane's block b = r RUN + lane with bounds [s, e): writes the
// zeros of an empty or (with list_long) long block, listing a long one,
// finds the hull of the used blocks and, if it fits, starts copying the
// 16-byte groups that cover it into `stage` (cp.async, one commit group a
// lane whatever the body). A group that is not whole inside the table
// [data, end) is left to finish_stage.
template <typename T>
__device__ __forceinline__ Plan plan_run(
    const T* __restrict__ data, uintptr_t end,
    unsigned long long* __restrict__ out,
    unsigned long long* __restrict__ long_list, int64_t B, int list_long,
    int64_t b, int64_t s, int64_t e, unsigned char* stage) {
    constexpr int RB = 2 * sizeof(T);  // bytes a row
    const int lane = threadIdx.x % WARP;
    const bool is_long = list_long && e - s > SPAN_ROWS;
    const bool used = e > s && !is_long;
    if (b < B && !used) {  // long: the pieces kernel adds to these zeros
        out[2 * b] = 0;
        out[2 * b + 1] = 0;
        if (is_long) long_list[1 + atomicAdd(long_list, 1ull)] = b;
    }
    Plan p;
    p.lo = used ? s : INT64_MAX;
    p.hi = used ? e : INT64_MIN;
#pragma unroll
    for (int off = WARP / 2; off > 0; off /= 2) {
        const long long l = __shfl_xor_sync(~0u, p.lo, off);
        const long long h = __shfl_xor_sync(~0u, p.hi, off);
        p.lo = l < p.lo ? l : p.lo;
        p.hi = h > p.hi ? h : p.hi;
    }
    p.body = p.hi <= p.lo ? NONE : (p.hi - p.lo > SPAN_ROWS ? WIDE : STAGED);
    if (p.body == STAGED) {
        const uintptr_t A = (uintptr_t)data + (uintptr_t)p.lo * RB;
        const uintptr_t Z = (uintptr_t)data + (uintptr_t)p.hi * RB;
        p.Af = A & ~(uintptr_t)15;
        p.groups = (int)(((Z + 15) & ~(uintptr_t)15) - p.Af) / 16;
        p.r0 = (int)((A - p.Af) / RB);
        p.rows = p.r0 + (int)(p.hi - p.lo);
        p.lg = RB == 2 ? 1 : 0;
        while (((p.rows + (1 << p.lg) - 1) >> p.lg) > WARP) ++p.lg;
        for (int g = lane; g < p.groups; g += WARP) {
            const uintptr_t at = p.Af + 16 * (uintptr_t)g;
            if (at >= (uintptr_t)data && at + 16 <= end)
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                             :: "r"(smem_addr(stage + 16 * g)), "l"(at)
                             : "memory");
        }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    return p;
}

// Once the run's copies are in: the rows of a group not whole inside the
// table (at most the first and the last; rows outside the table as 0) and
// the stage rows past the last group to the last chunk's end (0), so that
// every stage row the sums read is written. The lanes then see the stage.
template <typename T>
__device__ __forceinline__ void finish_stage(const T* __restrict__ data,
                                             uintptr_t end, const Plan& p,
                                             unsigned char* stage) {
    using V = typename Row<T>::V;
    constexpr int RB = sizeof(V), RPG = 16 / RB;  // rows a group
    const int lane = threadIdx.x % WARP;
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    if (p.body == STAGED) {
        V* srow = reinterpret_cast<V*>(stage);
        const V zero = {0, 0};
        for (int k = 0; k < 2; ++k) {
            const int g = k ? p.groups - 1 : 0;
            const uintptr_t at = p.Af + 16 * (uintptr_t)g;
            if ((k && g == 0) || (at >= (uintptr_t)data && at + 16 <= end))
                continue;
            if (lane < RPG) {
                const uintptr_t row = at + lane * RB;
                srow[g * RPG + lane] =
                    row >= (uintptr_t)data && row + RB <= end
                        ? *reinterpret_cast<const V*>(row) : zero;
            }
        }
        const int C = 1 << p.lg;
        for (int r = p.groups * RPG + lane; r < ((p.rows + C - 1) & -C);
             r += WARP)
            srow[r] = zero;
    }
    __syncwarp();
}

// The sums of the run's blocks by the body its plan names; this lane's
// block b with bounds [s, e).
template <typename T>
__device__ __forceinline__ void sum_run(const T* __restrict__ data,
                                        unsigned long long* __restrict__ out,
                                        int list_long, int64_t b, int64_t s,
                                        int64_t e, const Plan& p,
                                        const unsigned char* stage) {
    using V = typename Row<T>::V;
    constexpr int RB = sizeof(V);
    const int lane = threadIdx.x % WARP;
    const bool used = e > s && !(list_long && e - s > SPAN_ROWS);
    if (p.body == WIDE) {
        // the warp sums its lanes' blocks from global memory
        const V* rows = reinterpret_cast<const V*>(data);
        for (int j = 0; j < WARP; ++j) {
            const int64_t sj = __shfl_sync(~0u, (long long)s, j);
            const int64_t ej = __shfl_sync(~0u, (long long)e, j);
            if (!__shfl_sync(~0u, (int)used, j)) continue;  // uniform
            unsigned long long m, c;
            warp_sum(rows, sj, ej, m, c);
            if (lane == 0) {
                out[2 * (b - lane + j)] = m;
                out[2 * (b - lane + j) + 1] = c;
            }
        }
        return;
    }
    if (p.body != STAGED) return;
    // chunk sums: lane l sums chunk l's Wc words, the i-th in an order
    // rotated by the lane so that the warp's 32 loads fall in 32 banks
    const uint32_t* st = reinterpret_cast<const uint32_t*>(stage);
    const int lg = p.lg, C = 1 << lg;
    const int wc_log = lg + (RB == 2 ? -1 : 0);  // log2 words a chunk
    const int Wc = 1 << wc_log;
    const int rot = Wc >= WARP ? lane : lane >> (5 - wc_log);
    Acc<T> acc;
    if ((lane << lg) < p.rows) {
        const uint32_t* cw = st + (lane << wc_log);
#pragma unroll 4
        for (int i = 0; i < Wc; ++i) acc.add(cw[(i + rot) & (Wc - 1)]);
    }
    uint32_t m = acc.m, c = acc.c;
    // inclusive scan over the warp; chunk k's prefix is lane k's
    // exclusive sum (k = WARP: the total)
    uint32_t im = m, ic = c;
#pragma unroll
    for (int off = 1; off < WARP; off *= 2) {
        const uint32_t ym = __shfl_up_sync(~0u, im, off);
        const uint32_t yc = __shfl_up_sync(~0u, ic, off);
        if (lane >= off) {
            im += ym;
            ic += yc;
        }
    }
    const uint32_t xm = im - m, xc = ic - c;
    const int xs = p.r0 + (int)(s - p.lo), xe = p.r0 + (int)(e - p.lo);
    const int ks = used ? xs >> lg : 0, ke = used ? xe >> lg : 0;
    const uint32_t tm = __shfl_sync(~0u, im, WARP - 1);
    const uint32_t tc = __shfl_sync(~0u, ic, WARP - 1);
    uint32_t pms = __shfl_sync(~0u, xm, ks & (WARP - 1));
    uint32_t pcs = __shfl_sync(~0u, xc, ks & (WARP - 1));
    uint32_t pme = __shfl_sync(~0u, xm, ke & (WARP - 1));
    uint32_t pce = __shfl_sync(~0u, xc, ke & (WARP - 1));
    if (ks == WARP) {
        pms = tm;
        pcs = tc;
    }
    if (ke == WARP) {
        pme = tm;
        pce = tc;
    }
    if (!used) return;
    if (xe - xs <= C) {
        Acc<T> blk;
        sum_rows<T>(st, xs, xe, blk);
        m = blk.m;
        c = blk.c;
    } else {
        // P(xe) - P(xs); P(x) = the prefix of x's chunk + its rows before x
        Acc<T> before, after;
        sum_rows<T>(st, ks << lg, xs, before);
        sum_rows<T>(st, ke << lg, xe, after);
        m = after.m + pme - pms - before.m;
        c = after.c + pce - pcs - before.c;
    }
    out[2 * b] = m;
    out[2 * b + 1] = c;
}

// The runs kernel: warp w of the grid's W warps takes the runs w, w + W,
// ..., two deep: while it sums run k from one of its two stages, run k +
// 1's groups are copying into the other and run k + 2's bounds loading.
template <typename T>
__global__ void __launch_bounds__(THREADS)
block_runs_kernel(const T* __restrict__ data,
                  const int64_t* __restrict__ bounds,
                  unsigned long long* __restrict__ out,
                  unsigned long long* __restrict__ long_list, int64_t B,
                  int64_t N, int list_long) {
    extern __shared__ __align__(16) unsigned char stages[];
    constexpr size_t STAGE = stage_bytes<T>();
    const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
    unsigned char* mine = stages + warp * 2 * STAGE;
    const uintptr_t end = (uintptr_t)data + (uintptr_t)N * 2 * sizeof(T);
    const int64_t runs = (B + RUN - 1) / RUN;
    const int64_t W = (int64_t)gridDim.x * NWARPS;
    auto load = [&](int64_t r, int64_t& s, int64_t& e) {
        const int64_t b = r * RUN + lane;
        s = e = 0;
        if (r < runs && b < B) {
            s = bounds[2 * b];
            e = bounds[2 * b + 1];
        }
    };
    int64_t r = (int64_t)blockIdx.x * NWARPS + warp;
    int64_t s0, e0, s1, e1;
    load(r, s0, e0);
    load(r + W, s1, e1);
    Plan p0 = plan_run(data, end, out, long_list, B, list_long,
                       r * RUN + lane, s0, e0, mine);
    for (int k = 0; r < runs; ++k, r += W) {
        int64_t s2, e2;
        load(r + 2 * W, s2, e2);
        const Plan p1 = plan_run(data, end, out, long_list, B, list_long,
                                 (r + W) * RUN + lane, s1, e1,
                                 mine + ((k + 1) & 1) * STAGE);
        unsigned char* stage = mine + (k & 1) * STAGE;
        finish_stage(data, end, p0, stage);
        sum_run(data, out, list_long, r * RUN + lane, s0, e0, p0, stage);
        __syncwarp();  // the stage is free for run k + 2
        s0 = s1;
        e0 = e1;
        s1 = s2;
        e1 = e2;
        p0 = p1;
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}



template <typename T>
__global__ void __launch_bounds__(THREADS)
block_pieces_kernel(const T* __restrict__ data,
                    const int64_t* __restrict__ bounds,
                    unsigned long long* __restrict__ out,
                    const unsigned long long* __restrict__ long_list) {
    using V = typename Row<T>::V;
    constexpr int RB = sizeof(V);
    __shared__ unsigned long long s_m[NWARPS], s_c[NWARPS];
    const int lane = threadIdx.x % WARP, warp = threadIdx.x / WARP;
    const int64_t n_long = (int64_t)long_list[0];
    const int64_t G = gridDim.x;
    int64_t first = 0;  // the piece number of entry i's first piece
    for (int64_t i = 0; i < n_long; ++i) {
        const int64_t b = (int64_t)long_list[1 + i];
        const int64_t s = bounds[2 * b], e = bounds[2 * b + 1];
        const int64_t pieces = (e - s + PIECE_ROWS - 1) / PIECE_ROWS;
        // this CTA's pieces g == blockIdx.x (mod G) in [first, first + pieces)
        int64_t g = first + ((int64_t)blockIdx.x - first % G + G) % G;
        for (; g < first + pieces; g += G) {
            const int64_t r0 = s + (g - first) * PIECE_ROWS;
            const int64_t r1 = r0 + PIECE_ROWS < e ? r0 + PIECE_ROWS : e;
            const uintptr_t A = (uintptr_t)data + (uintptr_t)r0 * RB;
            const uintptr_t Z = (uintptr_t)data + (uintptr_t)r1 * RB;
            const uintptr_t A16 = (A + 15) & ~(uintptr_t)15;
            const uintptr_t Z16 = Z & ~(uintptr_t)15;
            Acc<T> acc;
            if (Z16 > A16) {
                const uint4* v = reinterpret_cast<const uint4*>(A16);
                const int64_t nv = (int64_t)(Z16 - A16) / 16;
                int64_t k = threadIdx.x;
                for (; k + (UNROLL - 1) * THREADS < nv;
                     k += UNROLL * THREADS) {
                    uint4 u[UNROLL];
#pragma unroll
                    for (int q = 0; q < UNROLL; ++q)
                        u[q] = __ldg(v + k + q * THREADS);
#pragma unroll
                    for (int q = 0; q < UNROLL; ++q) acc.add(u[q]);
                }
                for (; k < nv; k += THREADS) acc.add(__ldg(v + k));
            }
            // the rows outside the 16-byte vectors, as in the staged body
            const uintptr_t head_end = A16 < Z ? A16 : Z;
            const uintptr_t tail_start = Z16 > A16 ? Z16 : head_end;
            const int head = (int)((head_end - A) / RB);
            const int tail = (int)((Z - tail_start) / RB);
            if (threadIdx.x < head) {
                const V x = reinterpret_cast<const V*>(A)[threadIdx.x];
                acc.m += x.x;
                acc.c += x.y;
            } else if (threadIdx.x >= WARP && threadIdx.x < WARP + tail) {
                const V x =
                    reinterpret_cast<const V*>(tail_start)[threadIdx.x - WARP];
                acc.m += x.x;
                acc.c += x.y;
            }
            unsigned long long wm = acc.m, wc = acc.c;
#pragma unroll
            for (int off = WARP / 2; off > 0; off /= 2) {
                wm += __shfl_xor_sync(~0u, wm, off);
                wc += __shfl_xor_sync(~0u, wc, off);
            }
            if (lane == 0) {
                s_m[warp] = wm;
                s_c[warp] = wc;
            }
            __syncthreads();
            if (threadIdx.x == 0) {
                unsigned long long pm = 0, pc = 0;
#pragma unroll
                for (int w = 0; w < NWARPS; ++w) {
                    pm += s_m[w];
                    pc += s_c[w];
                }
                atomicAdd(out + 2 * b, pm);
                atomicAdd(out + 2 * b + 1, pc);
            }
            __syncthreads();
        }
        first += pieces;
    }
}

template <typename T>
int launch_sums(const void* data, const void* bounds, void* out,
                void* scratch, int64_t B, int64_t N, bool list_long,
                cudaStream_t st) {
    constexpr size_t smem = NWARPS * 2 * stage_bytes<T>();
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(block_runs_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, block_runs_kernel<T>, THREADS, smem);
    if (err == cudaSuccess && list_long)
        err = cudaMemsetAsync(scratch, 0, sizeof(unsigned long long), st);
    if (err != cudaSuccess) return (int)err;
    const int64_t ctas = (B + RUN * NWARPS - 1) / (RUN * NWARPS);
    const int64_t most = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
    const unsigned grid = (unsigned)(ctas < most ? ctas : most);
    int rc = wgbs::launch(block_runs_kernel<T>, dim3(grid), THREADS,
                          smem, st, (const T*)data, (const int64_t*)bounds,
                          (unsigned long long*)out,
                          (unsigned long long*)scratch, B, N, (int)list_long);
    if (rc || !list_long) return rc;
    block_pieces_kernel<T><<<sms * PIECE_CTAS_PER_SM, THREADS, 0, st>>>(
        (const T*)data, (const int64_t*)bounds, (unsigned long long*)out,
        (const unsigned long long*)scratch);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// itemsize 1 (uint8 data) or 2 (uint16); anything else, B < 0, data not
// aligned to its rows, or list_long without scratch returns
// cudaErrorInvalidValue. B == 0 launches nothing. With list_long: zeroes
// scratch's count, launches the runs kernel (a warp a run) and then the
// pieces kernel; without: the runs kernel alone, whose wide body then
// sums a long block too. On `stream` on the current device.
int block_sums(const void* data, const void* bounds, void* out,
               void* scratch, int64_t B, int64_t N, int64_t itemsize,
               int64_t list_long, void* stream) {
    if (B < 0 || N < 0 ||
        (itemsize != 1 && itemsize != 2) ||
        ((uintptr_t)data % (2 * itemsize)) || (list_long && !scratch))
        return (int)cudaErrorInvalidValue;
    if (B == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    return itemsize == 1 ? launch_sums<uint8_t>(data, bounds, out, scratch,
                                                B, N, list_long != 0, st)
                         : launch_sums<uint16_t>(data, bounds, out, scratch,
                                                 B, N, list_long != 0, st);
}

}  // extern "C"
