// Hand-written Hopper (sm_90a) kernel for the adjacent-CpG pair counts of
// pat2pairs (wgbs_tools_tpu_torch/ops/pairs.py::pair_counts_add):
//
//   start_rel i32 [F]      each fragment's first site minus the window's
//                          first (negative for a fragment that starts
//                          before the window)
//   length    i32 [F]      sites the fragment covers
//   count     i32 [F]      its count
//   codes     u8  [F][L]   its calls, T=0 C=1 H=2 '.'=3 (3 past length)
//   table     i32 [n][4]   the window's (tt, tc, ct, cc) counts, added to in
//                          place
//
// For each fragment and position p in [1, length), with pre = codes[p-1]
// and cur = codes[p] both T or C (H is not counted) and site start_rel + p
// in [0, n): table[site][2 (pre == C) + (cur == C)] += count. A pair is
// counted at its second site. Replaces wgbs_tools_tpu/ops/pairs.py::
// _pairs_accum (:57), the jitted scatter-add of StreamingPairs (and
// _pairs_batch, :17, of the one-shot pair_counts: the same function on a
// zeroed table), which XLA fuses into one pass and plain PyTorch would
// materialize as masks, ids and an index_add_.
//
// Bound: bytes, with the atomics beside them. A slab's codes (F x L bytes)
// and its three int32 columns are read once; each table entry that the
// slab's pairs reach is read and written once (8 bytes). The adds are
// 32-bit atomics in L2 (one per valid pair); their order varies from run
// to run, but every add is an integer, so the table is exact.
//
// One warp per fragment, fragments grid-strided: lane k takes the
// positions p = 1 + k, 1 + k + 32, ... (a fragment of up to 33 sites is
// one pass), reads codes[p-1] and codes[p] (the warp's loads are one
// contiguous run of the row) and adds its pair. The fragment's start,
// length and count are read by every lane of the warp (one broadcast
// load). Adjacent lanes add into adjacent sites, 16 bytes apart.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARP = 32;
constexpr int CODE_C = 1;  // T = 0, C = 1; H = 2 and '.' = 3 do not count

__global__ void __launch_bounds__(THREADS)
pair_counts_kernel(const int* __restrict__ start_rel,
                   const int* __restrict__ length,
                   const int* __restrict__ count,
                   const uint8_t* __restrict__ codes, int* __restrict__ table,
                   int64_t F, int64_t L, int64_t n) {
    const int lane = threadIdx.x % WARP;
    const int64_t warps = (int64_t)gridDim.x * (THREADS / WARP);
    for (int64_t f = ((int64_t)blockIdx.x * THREADS + threadIdx.x) / WARP;
         f < F; f += warps) {
        const int64_t s0 = start_rel[f];
        const int len = length[f];
        const int cnt = count[f];
        const uint8_t* row = codes + f * L;
        const int64_t last = len < L ? len : L;
        for (int64_t p = 1 + lane; p < last; p += WARP) {
            const int pre = row[p - 1], cur = row[p];
            const int64_t site = s0 + p;
            if (pre <= CODE_C && cur <= CODE_C && site >= 0 && site < n)
                atomicAdd(table + site * 4 + 2 * pre + cur, cnt);
        }
    }
}

}  // namespace

extern "C" {

// F < 0, L < 1 or n < 0 returns cudaErrorInvalidValue. F == 0, L == 1 or
// n == 0 launches nothing (no pair can count). Launches on `stream` on the
// current device, on at most 132 x 16 CTAs (fragments grid-strided).
int pair_counts(const void* start_rel, const void* length, const void* count,
                const void* codes, void* table, int64_t F, int64_t L,
                int64_t n, void* stream) {
    if (F < 0 || L < 1 || n < 0) return (int)cudaErrorInvalidValue;
    if (F == 0 || L == 1 || n == 0) return 0;
    const int64_t want = (F + THREADS / WARP - 1) / (THREADS / WARP);
    const unsigned grid = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    pair_counts_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const int*)start_rel, (const int*)length, (const int*)count,
        (const uint8_t*)codes, (int*)table, F, L, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
