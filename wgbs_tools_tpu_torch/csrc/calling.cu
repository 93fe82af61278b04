// Hand-written Hopper (sm_90a) kernels for bam2pat's methylation calling
// and mate merging (wgbs_tools_tpu_torch/ops/calling.py::call_reads and
// ::merge_pe). They replace wgbs_tools_tpu/ops/calling_tpu.py's jitted
// _call_kernel (:59) and _merge_kernel (:113), which XLA compiles from
// integer gathers and selects; both compute pipeline/calling.py's
// call_reads_mat and merge_pe_mat (ref: src/pipeline_wgbs/patter.cpp:
// 105-184, patter_utils.cpp:292-342) and, being integer selects, are
// bit-identical to them.
//
// Pattern codes are 2 bits, T=0 C=1 H=2 '.'=3 (formats/pat.py), packed 4 a
// byte, code t of a byte in bits 2t..2t+1 (calling_tpu.py::_pack2bit): a
// read's codes leave the card at a quarter of a byte each.
//
// call_reads, a warp a read (grid-strided):
//   seq      u8  [R][L]  CIGAR-normalized read bytes, zero past each len
//   lens     i32 [R]     normalized read lengths (<= L)
//   pos1     i32 [R]     1-based reference position of each read's byte 0
//   bottom   u8  [R]     1 for a bottom-strand (OB) read
//   loci     i32 [n]     the chromosome's sorted 1-based CpG loci
//   first_k  i32 [R]     out: locus index of the first known call, or -1
//   span     i32 [R]     out: calls from the first to the last known one
//   packed   u8  [R][KB] out: the calls from first_k on, '.' past span
// Lanes 0 and 1 binary-search the read's loci window [k0, k1) (the loci in
// [pos1, pos1 + len)); the lanes then take its slots 32 at a time. At slot
// k, j = loci[k0 + k] - pos1 + bottom is the read byte of the call: a top
// read calls C / T there when the next byte is G (a CpG on the read), a
// bottom read G / A when the previous byte is C; j outside [0, len), the
// read's first byte (bottom) or its last (top), a byte inside `clip` of
// either end, and any other byte give '.'. A ballot a round finds the
// first and last known slot. The packed row is written a byte a lane (4
// calls apart), each call computed again from the row and the loci: no
// per-read scratch, so a read of any length takes the same body.
//
// merge_pe, a warp a pair (grid-strided):
//   s1, s2   i64 [n]      the mates' first sites (both >= 0)
//   sp1, sp2 i32 [n]      their spans (<= their pattern widths S1, S2)
//   p1, p2   u8  [n][S*]  their pattern chars ('T', 'C', 'H', '.'; any
//                         other byte reads as '.')
//   start    i64 [n]      out: first site of the merged read, -1 if none
//   span     i32 [n]      out: its span (0 when too long or unknown)
//   packed   u8  [n][75]  out: its MAX_PE_PAT_LEN = 300 codes
//   too_long u8  [n]      out: 1 when the pair spans > 300 sites
// Mate A is the one that starts first (mate 1 at equal starts). Over the
// pair's width (from A's start to the later end, at most 300), A's call
// stands where it is known and B's fills a '.'; where both are known and
// differ the site is '.'. Lanes take the pair's columns (up to 300) 32 at
// a time, a ballot a round finds the first and last known column, and the
// result is left-aligned to the first one.
//
// Bound: bytes. call_reads must read each row's bytes at its calls (and
// their neighbours), its 9 bytes of columns and its loci, and write 8 bytes
// and ceil(span / 4) packed bytes; merge_pe must read both rows up to their
// spans and 24 bytes of columns, and write 13 bytes and ceil(span / 4)
// packed bytes a pair. Both kernels also write the '.' bytes past a span
// (to KB bytes a read, 75 a pair), which the bound does not count: only
// the calls up to each span are needed. Neither does arithmetic worth
// counting. Both first bodies
// are latency-bound: a read's binary search is a chain of dependent loads,
// and a warp takes one read or pair at a time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PE_PAT_LEN = 300;       // ref: patter_utils.h:21
constexpr int MERGE_BYTES = MAX_PE_PAT_LEN / 4;
constexpr uint32_t DOT = 3u;

// The first index of the sorted loci[0, n) that is >= x.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ loci,
                                           int n, int32_t x) {
    int lo = 0, hi = n;
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(loci + mid) < x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// The call of the CpG at `locus` on a read (calling.py::call_reads_mat's
// rules; patter.cpp:105-184).
__device__ __forceinline__ uint32_t call_code(const uint8_t* __restrict__ row,
                                              int32_t locus, int32_t pos1,
                                              int bottom, int32_t n_r,
                                              int32_t clip) {
    const int32_t j = locus - pos1 + bottom;
    if (j < 0 || j >= n_r) return DOT;
    if (clip > 0 && (j < clip || j >= n_r - clip)) return DOT;
    const uint8_t s = __ldg(row + j);
    if (bottom) {
        if (j == 0 || __ldg(row + j - 1) != 'C') return DOT;
        return s == 'A' ? 0u : (s == 'G' ? 1u : DOT);
    }
    if (j >= n_r - 1 || __ldg(row + j + 1) != 'G') return DOT;
    return s == 'T' ? 0u : (s == 'C' ? 1u : DOT);
}

__global__ void __launch_bounds__(THREADS)
call_reads_kernel(const uint8_t* __restrict__ seq,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ pos1,
                  const uint8_t* __restrict__ bottom,
                  const int32_t* __restrict__ loci, int32_t* __restrict__ first_k,
                  int32_t* __restrict__ span, uint8_t* __restrict__ packed,
                  int64_t R, int64_t L, int32_t n_loci, int32_t KB,
                  int32_t clip) {
    const int lane = threadIdx.x & 31;
    const int64_t n_warps = (int64_t)gridDim.x * WARPS;
    for (int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); r < R;
         r += n_warps) {
        const int32_t p = __ldg(pos1 + r);
        const int32_t n_r = __ldg(lens + r);
        const int bot = __ldg(bottom + r) != 0;
        const uint8_t* row = seq + r * L;
        // lane 0 finds k0, lane 1 k1
        const int k = lower_bound(loci, n_loci, lane == 0 ? p : p + n_r);
        const int k0 = __shfl_sync(0xffffffffu, k, 0);
        const int nv = __shfl_sync(0xffffffffu, k, 1) - k0;
        int first = -1, last = -1;
        for (int base = 0; base < nv; base += 32) {
            const int slot = base + lane;
            const uint32_t c =
                slot < nv ? call_code(row, __ldg(loci + k0 + slot), p, bot,
                                      n_r, clip)
                          : DOT;
            const unsigned m = __ballot_sync(0xffffffffu, c != DOT);
            if (m) {
                if (first < 0) first = base + __ffs(m) - 1;
                last = base + 31 - __clz(m);
            }
        }
        const int sp = first >= 0 ? last - first + 1 : 0;
        if (lane == 0) {
            first_k[r] = first >= 0 ? k0 + first : -1;
            span[r] = sp;
        }
        uint8_t* out = packed + r * KB;
        for (int b = lane; b < KB; b += 32) {
            uint32_t byte = 0;
#pragma unroll
            for (int t = 0; t < 4; t++) {
                const int o = 4 * b + t;
                const uint32_t c =
                    o < sp ? call_code(row, __ldg(loci + k0 + first + o), p,
                                       bot, n_r, clip)
                           : DOT;
                byte |= c << (2 * t);
            }
            out[b] = (uint8_t)byte;
        }
    }
}

__device__ __forceinline__ uint32_t char_code(uint8_t c) {
    return c == 'T' ? 0u : (c == 'C' ? 1u : (c == 'H' ? 2u : DOT));
}

// Column c of a merged pair (calling.py::merge_pe_mat's rules;
// patter_utils.cpp:292-342): A's call, B's where A's is '.', '.' where both
// are known and differ; '.' at and past the width cap.
__device__ __forceinline__ uint32_t merged_at(int c, int cap,
                                              const uint8_t* __restrict__ ap,
                                              int a_sp, int Sa,
                                              const uint8_t* __restrict__ bp,
                                              int b_off, int b_sp, int Sb) {
    if (c >= cap) return DOT;
    const uint32_t A = (c < a_sp && c < Sa) ? char_code(__ldg(ap + c)) : DOT;
    const int bi = c - b_off;
    const uint32_t B = (bi >= 0 && bi < b_sp && bi < Sb)
                           ? char_code(__ldg(bp + bi))
                           : DOT;
    if (A == DOT) return B;
    return (B != DOT && A != B) ? DOT : A;
}

__global__ void __launch_bounds__(THREADS)
merge_pe_kernel(const int64_t* __restrict__ s1, const int32_t* __restrict__ sp1,
                const uint8_t* __restrict__ p1, const int64_t* __restrict__ s2,
                const int32_t* __restrict__ sp2, const uint8_t* __restrict__ p2,
                int64_t* __restrict__ start, int32_t* __restrict__ span,
                uint8_t* __restrict__ packed, uint8_t* __restrict__ too_long,
                int64_t n, int64_t S1, int64_t S2) {
    const int lane = threadIdx.x & 31;
    const int64_t n_warps = (int64_t)gridDim.x * WARPS;
    for (int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); r < n;
         r += n_warps) {
        const int64_t x1 = __ldg(s1 + r), x2 = __ldg(s2 + r);
        const int l1 = __ldg(sp1 + r), l2 = __ldg(sp2 + r);
        const bool swap = x1 > x2;
        const int64_t a_s = swap ? x2 : x1, b_s = swap ? x1 : x2;
        const int a_sp = swap ? l2 : l1, b_sp = swap ? l1 : l2;
        const uint8_t* ap = swap ? p2 + r * S2 : p1 + r * S1;
        const uint8_t* bp = swap ? p1 + r * S1 : p2 + r * S2;
        const int Sa = (int)(swap ? S2 : S1), Sb = (int)(swap ? S1 : S2);
        const int64_t width = max(a_s + a_sp, b_s + b_sp) - a_s;
        const bool longer = width > MAX_PE_PAT_LEN;
        const int cap = (int)min(width, (int64_t)MAX_PE_PAT_LEN);
        // past the cap B adds nothing, so its offset fits an int
        const int b_off = (int)min(b_s - a_s, (int64_t)(2 * MAX_PE_PAT_LEN));
        // columns at and past the cap are '.': the rounds stop there
        int first = -1, last = -1;
        for (int base = 0; base < cap; base += 32) {
            const int c = base + lane;
            const uint32_t code =
                merged_at(c, cap, ap, a_sp, Sa, bp, b_off, b_sp, Sb);
            const unsigned m = __ballot_sync(0xffffffffu, code != DOT);
            if (m) {
                if (first < 0) first = base + __ffs(m) - 1;
                last = base + 31 - __clz(m);
            }
        }
        const bool any = first >= 0 && !longer;
        const int sp = any ? last - first + 1 : 0;
        if (lane == 0) {
            start[r] = any ? a_s + first : -1;
            span[r] = sp;
            too_long[r] = longer ? 1 : 0;
        }
        uint8_t* out = packed + r * MERGE_BYTES;
        for (int b = lane; b < MERGE_BYTES; b += 32) {
            uint32_t byte = 0;
#pragma unroll
            for (int t = 0; t < 4; t++) {
                const int o = 4 * b + t;
                const uint32_t c =
                    o < sp ? merged_at(first + o, cap, ap, a_sp, Sa, bp, b_off,
                                       b_sp, Sb)
                           : DOT;
                byte |= c << (2 * t);
            }
            out[b] = (uint8_t)byte;
        }
    }
}

int blocks_for(int64_t rows) {
    const int64_t b = (rows + WARPS - 1) / WARPS;
    return (int)(b < (1 << 30) ? b : (1 << 30));
}

}  // namespace

extern "C" {

// R < 0, L < 1, n_loci < 0, KB < 1 or clip < 0 returns
// cudaErrorInvalidValue; R == 0 launches nothing. Every lens[r] must be
// <= L and KB * 4 must hold every read's calls (len / 2 + 1 of them).
// Launches on `stream` on the current device.
int call_reads(const void* seq, const void* lens, const void* pos1,
               const void* bottom, const void* loci, void* first_k, void* span,
               void* packed, int64_t R, int64_t L, int64_t n_loci, int64_t KB,
               int64_t clip, void* stream) {
    if (R < 0 || L < 1 || n_loci < 0 || n_loci > INT32_MAX || KB < 1 ||
        KB > INT32_MAX || clip < 0 || clip > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    return wgbs::launch(call_reads_kernel, dim3(blocks_for(R)), THREADS, 0,
                        stream, (const uint8_t*)seq, (const int32_t*)lens,
                        (const int32_t*)pos1, (const uint8_t*)bottom,
                        (const int32_t*)loci, (int32_t*)first_k,
                        (int32_t*)span, (uint8_t*)packed, R, L,
                        (int32_t)n_loci, (int32_t)KB, (int32_t)clip);
}

// n < 0, S1 < 1 or S2 < 1 returns cudaErrorInvalidValue; n == 0 launches
// nothing. Each span must be <= its pattern width. Launches on `stream` on
// the current device.
int merge_pe(const void* s1, const void* sp1, const void* p1, const void* s2,
             const void* sp2, const void* p2, void* start, void* span,
             void* packed, void* too_long, int64_t n, int64_t S1, int64_t S2,
             void* stream) {
    if (n < 0 || S1 < 1 || S2 < 1 || S1 > INT32_MAX || S2 > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    return wgbs::launch(merge_pe_kernel, dim3(blocks_for(n)), THREADS, 0,
                        stream, (const int64_t*)s1, (const int32_t*)sp1,
                        (const uint8_t*)p1, (const int64_t*)s2,
                        (const int32_t*)sp2, (const uint8_t*)p2,
                        (int64_t*)start, (int32_t*)span, (uint8_t*)packed,
                        (uint8_t*)too_long, n, S1, S2);
}

}  // extern "C"
