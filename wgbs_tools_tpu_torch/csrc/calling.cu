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
// call_reads:
//   seq      u8  [R][L]  CIGAR-normalized read bytes, zero past each len
//   lens     i32 [R]     normalized read lengths (<= L)
//   pos1     i32 [R]     1-based reference position of each read's byte 0
//   bottom   u8  [R]     1 for a bottom-strand (OB) read
//   loci     i32 [n]     the chromosome's sorted 1-based CpG loci
//   first_k  i32 [R]     out: locus index of the first known call, or -1
//   span     i32 [R]     out: calls from the first to the last known one
//   packed   u8  [R][KB] out: the calls from first_k on, '.' past span
// A read's slots are the loci in [pos1, pos1 + len), at most 4 KB of them.
// At slot k, j = loci[k0 + k] - pos1 + bottom is the read byte of the call:
// a top read calls C / T there when the next byte is G (a CpG on the read),
// a bottom read G / A when the previous byte is C; j outside [0, len), the
// read's first byte (bottom) or its last (top), a byte inside `clip` of
// either end, and any other byte give '.'.
//
// A CTA of 256 threads takes a tile of T consecutive reads (512, fewer
// when KB > 20 so that the tile's T x KB bytes of codes fit its shared
// memory: tile_reads), two reads a thread for the reads' own steps: two
// chains of loads in flight a thread hide more latency than one. bam2pat's
// batches are sorted by position (bam_columnar.py::_decode), so a tile's
// reads mostly reach a short run of loci:
//   - sorted tiles (every pos1 >= the one before, a block vote): while the
//     columns load, two warps find the loci the tile can reach, [first
//     pos1, last pos1 + L), by 33-ary searches (~5 dependent loads each,
//     not ~20 a read); when that range holds at most WIN loci it is copied
//     into shared memory by 16-byte cp.async and each read's [k0, k1) is a
//     binary search there (path "staged");
//   - other tiles search each read's window in global memory, a thread a
//     read: unsorted tiles over the whole loci array ("unsorted"), sorted
//     tiles whose range is wider than WIN inside that range ("wide").
// Then the calls: a block-wide prefix sum of each read's quads (4 slots,
// one byte of codes) turns the tile's (read, quad) items into one flat
// list that the threads take in turn, so a tile's load is balanced however
// many CpGs each read covers. An item issues the row loads of its 4 calls
// together and writes its byte of codes once into the tile's (read, slot)
// buffer in shared memory, set to '.' beforehand. No call is computed
// twice: a thread a read then finds its first and last known slot in its
// bytes and left-aligns them in place, and the buffer, laid out as the
// tile's T x KB output bytes (contiguous in `packed`), is stored as
// 16-byte vectors. Rows are read where the calls are, a byte load each
// through the read-only path: at phase 11's ~1.5 calls a 150-byte read
// the calls touch ~1.3 of a row's ~4.75 32-byte sectors (PERF.md §6 has
// the designs measured against this one: each call's bytes from one
// 8-byte word, a dense tile's rows streamed into L2 first, a read a
// thread).
// Reads of over ~5,100 bases (KB > 640: no tile of 16 fits) take
// call_reads_long_kernel, a warp a read (its many slots keep the lanes
// busy): a binary search of its window, its slots 32 at a time with a
// ballot for the first and last known slot, the packed row a byte a lane
// with each call computed again.
// With a counter array (the call_reads_paths entry) the kernels count
// the paths they take: a tile body's thread 0 adds one to its tile's path
// (staged, unsorted, wide), the long body's lane 0 one a read (long).
//
// merge_pe:
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
// differ the site is '.'. The result is left-aligned to the first known
// column. A CTA takes a tile of T pairs (merge_pe_plan), a thread a pair
// for its columns and outputs. Both mates' rows of a tile are two
// contiguous byte spans; where T x (S1 + S2) fits STAGE_BYTES for a T of
// at least 128 they are copied into shared memory by 16-byte cp.async
// (body "staged"), else the columns read them from global memory (body
// "gather", T = 256; at phase 11's widths the staged body is the faster:
// PERF.md §6 has the A/B). A pair's quads of columns (none for a pair
// that is too long: its output is all '.') form a flat list over the tile
// as in call_reads; each merged code is computed once into shared memory,
// where a thread a pair left-aligns its row, and the tile's T x 75 packed
// bytes are stored as 16-byte vectors.
//
// Bound: bytes. call_reads must read each row's bytes at its calls (and
// their neighbours), its 9 bytes of columns and its loci, and write 8 bytes
// and ceil(span / 4) packed bytes; merge_pe must read both rows up to their
// spans and 24 bytes of columns, and write 13 bytes and ceil(span / 4)
// packed bytes a pair. Both kernels also write the '.' bytes past a span
// (to KB bytes a read, 75 a pair), which the bound does not count. Row
// bytes at a call come in 32-byte sectors, so the rows cost at least the
// sectors the calls touch (chip_smoke.py reports them beside the bound).
// A tile is a short chain of dependent steps (columns, range search, loci
// copy, window searches, calls, packing); several CTAs on an SM overlap
// their chains.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "launch.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PE_PAT_LEN = 300;       // ref: patter_utils.h:21
constexpr int MERGE_BYTES = MAX_PE_PAT_LEN / 4;
constexpr uint32_t DOT = 3u;

// call_reads' tiles
constexpr int RPT = 2;               // reads a thread in a tile
constexpr int TILE = RPT * THREADS;  // reads a tile at most
constexpr int TILE_ALIGN = 16;       // a tile's reads are a multiple of this
constexpr int WIN = 2048;            // loci of a tile's shared window
constexpr int CODE_BYTES = 10240;    // a tile's (read, slot) codes: T x KB
// the counters of call_reads_paths (ops/calling.py::CALL_PATHS)
enum CallPath { STAGED = 0, UNSORTED = 1, WIDE = 2, LONG = 3 };
// merge_pe's tiles
constexpr int MERGE_TILE = THREADS;  // pairs a tile at most
constexpr int MERGE_TILE_MIN = 128;  // a staged tile holds at least this
constexpr int STAGE_BYTES = 32768;   // both mates' rows of a staged tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The first index in [lo, hi) of the sorted loci (global memory) that is
// >= x, or hi.
__device__ __forceinline__ int lower_bound(const int32_t* __restrict__ loci,
                                           int lo, int hi, int32_t x) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(loci + mid) < x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// The same over a window in shared memory.
__device__ __forceinline__ int lower_bound_shared(const int32_t* a, int lo,
                                                  int hi, int32_t x) {
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (a[mid] < x)
            lo = mid + 1;
        else
            hi = mid;
    }
    return lo;
}

// The first index in [0, n) of the sorted loci that is >= x, or n, by all
// lanes of a warp: while the range is wider than a warp, its lanes probe 32
// points that cut it into 33 parts and the first probe >= x (a ballot)
// narrows it; then each lane probes one index.
__device__ int warp_lower_bound(const int32_t* __restrict__ loci, int n,
                                int32_t x) {
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;
    while (hi - lo > 32) {
        const int64_t w = hi - lo;
        const bool ge = __ldg(loci + lo + (int)((lane + 1) * w / 33)) >= x;
        const unsigned b = __ballot_sync(~0u, ge);
        const int f = b ? __ffs(b) - 1 : 32;  // probes below f: < x
        const int l0 = lo;
        if (f > 0) lo = l0 + (int)(f * w / 33) + 1;
        if (f < 32) hi = l0 + (int)((f + 1) * w / 33);
    }
    const unsigned b =
        __ballot_sync(~0u, lane < hi - lo && __ldg(loci + lo + lane) >= x);
    return b ? lo + __ffs(b) - 1 : hi;
}

// Whether a read of n_r bytes calls at its byte j (calling.py::
// call_reads_mat's rules; patter.cpp:105-184): j inside the read and
// outside `clip` of either end, and not the read's first byte (bottom: the
// call's neighbour is the byte before) or its last (top: the byte after).
__device__ __forceinline__ bool call_in_read(int32_t j, int32_t n_r,
                                             int bottom, int32_t clip) {
    if (j < 0 || j >= n_r) return false;
    if (clip > 0 && (j < clip || j >= n_r - clip)) return false;
    return bottom ? j > 0 : j < n_r - 1;
}

// The call from the read's byte s at a CpG and its neighbour nb: a top
// read calls C / T where the next byte is G, a bottom read G / A where the
// previous byte is C.
__device__ __forceinline__ uint32_t code_of(uint32_t s, uint32_t nb,
                                            int bottom) {
    if (bottom) {
        if (nb != 'C') return DOT;
        return s == 'A' ? 0u : (s == 'G' ? 1u : DOT);
    }
    if (nb != 'G') return DOT;
    return s == 'T' ? 0u : (s == 'C' ? 1u : DOT);
}

// The call of the CpG at `locus` on a read.
__device__ __forceinline__ uint32_t call_code(const uint8_t* __restrict__ row,
                                              int32_t locus, int32_t pos1,
                                              int bottom, int32_t n_r,
                                              int32_t clip) {
    const int32_t j = locus - pos1 + bottom;
    if (!call_in_read(j, n_r, bottom, clip)) return DOT;
    return code_of(__ldg(row + j), __ldg(row + j + (bottom ? -1 : 1)),
                   bottom);
}

// Exclusive prefix sum of v over the CTA (every thread calls it); *total
// gets the sum. Ends with the CTA synchronized.
__device__ __forceinline__ int block_scan(int v, int* warp_sums,
                                          int* total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int incl = v;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl += u;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    if (warp == 0) {
        int s = lane < WARPS ? warp_sums[lane] : 0;
#pragma unroll
        for (int d = 1; d < WARPS; d <<= 1) {
            const int u = __shfl_up_sync(~0u, s, d);
            if (lane >= d) s += u;
        }
        if (lane < WARPS) warp_sums[lane] = s;
        if (lane == WARPS - 1) *total = s;
    }
    __syncthreads();
    return incl - v + (warp ? warp_sums[warp - 1] : 0);
}

// The row of the flat (row, quad) list that item i falls in: the last r in
// [0, rows) with off[r] <= i (off ascending, off[0] = 0).
__device__ __forceinline__ int item_row(const uint16_t* off, int rows,
                                        int i) {
    int lo = 0, hi = rows;
    while (hi - lo > 1) {
        const int mid = (lo + hi) >> 1;
        if (off[mid] <= i)
            lo = mid;
        else
            hi = mid;
    }
    return lo;
}

// Exclusive offsets of the CTA's rows' counts cnt[0, n) (n a multiple of
// THREADS), in place, a thread a run of n / THREADS rows; cnt[n] gets the
// sum. Ends with the CTA synchronized.
__device__ __forceinline__ int scan_counts(uint16_t* cnt, int n,
                                           int* warp_sums, int* total) {
    const int per = n / THREADS, r0 = threadIdx.x * per;
    int sum = 0;
    for (int k = 0; k < per; ++k) sum += cnt[r0 + k];
    int at = block_scan(sum, warp_sums, total);
    for (int k = 0; k < per; ++k) {
        const int c = cnt[r0 + k];
        cnt[r0 + k] = (uint16_t)at;
        at += c;
    }
    if (threadIdx.x == THREADS - 1) cnt[n] = (uint16_t)at;
    __syncthreads();
    return *total;
}

// The tile's rows x W bytes of codes set to '.' (0xFF), 16 a thread (the
// buffer holds whole 16-byte groups past rows x W).
__device__ __forceinline__ void fill_dots(uint8_t* codes, int nbytes) {
    for (int c = threadIdx.x; 16 * c < nbytes; c += THREADS)
        *reinterpret_cast<uint4*>(codes + 16 * c) =
            make_uint4(~0u, ~0u, ~0u, ~0u);
}

// The first known slot of a row's codes (its nq bytes) and the span from
// it to the last known one (0, and first 0, when none is known).
__device__ __forceinline__ void known_span(const uint8_t* row, int nq,
                                           int& first, int& sp) {
    int lo = 0, hi = nq - 1;
    while (lo < nq && row[lo] == 0xFF) ++lo;
    if (lo == nq) {
        first = sp = 0;
        return;
    }
    while (row[hi] == 0xFF) --hi;
    // a byte's known codes: those whose 2 bits are not 3
    const uint32_t a = row[lo], z = row[hi];
    int t = 0;
    while (((a >> (2 * t)) & 3u) == 3u) ++t;
    int u = 3;
    while (((z >> (2 * u)) & 3u) == 3u) --u;
    first = 4 * lo + t;
    sp = 4 * hi + u - first + 1;
}

// A row's codes (its nq bytes, '.' after them) left-aligned in place to
// its first known slot: byte b takes slots first + 4b.. (bytes at or
// after b, so the bytes still to read are never overwritten), '.' from the
// span on.
__device__ __forceinline__ void align_row(uint8_t* row, int first, int sp,
                                          int nq) {
    const int nb = (sp + 3) >> 2, q0 = first >> 2, sh = 2 * (first & 3);
    for (int b = 0; b < nq; ++b) {
        uint32_t v = 0xFFu;
        if (b < nb) {
            const uint32_t hi = q0 + b + 1 < nq ? row[q0 + b + 1] : 0xFFu;
            v = (row[q0 + b] | (hi << 8)) >> sh;
            if (sp - 4 * b < 4) v |= 0xFFu << (2 * (sp - 4 * b));
        }
        row[b] = (uint8_t)v;
    }
}

// The tile's nbytes of packed rows from shared memory to out (contiguous),
// 16 a thread as one vector store where out is 16-byte aligned, the rest
// a byte a thread.
__device__ __forceinline__ void copy_out(uint8_t* __restrict__ out,
                                         const uint8_t* codes, int nbytes) {
    const int n16 = ((uintptr_t)out & 15) == 0 ? nbytes / 16 : 0;
    for (int c = threadIdx.x; c < n16; c += THREADS)
        *reinterpret_cast<uint4*>(out + 16 * c) =
            *reinterpret_cast<const uint4*>(codes + 16 * c);
    for (int e = 16 * n16 + threadIdx.x; e < nbytes; e += THREADS)
        out[e] = codes[e];
}

// A thread's RPT reads of a tile: t = tid + k * THREADS (coalesced loads).
#define FOR_MY_READS(t) \
    for (int t = threadIdx.x; t < TILE; t += THREADS)

__global__ void __launch_bounds__(THREADS)
call_reads_tiles_kernel(const uint8_t* __restrict__ seq,
                        const int32_t* __restrict__ lens,
                        const int32_t* __restrict__ pos1,
                        const uint8_t* __restrict__ bottom,
                        const int32_t* __restrict__ loci,
                        int32_t* __restrict__ first_k,
                        int32_t* __restrict__ span,
                        uint8_t* __restrict__ packed,
                        unsigned long long* __restrict__ paths, int64_t R,
                        int64_t L, int32_t n_loci, int32_t KB, int32_t clip,
                        int32_t T) {
    __shared__ __align__(16) int32_t win[WIN + 4];
    __shared__ __align__(16) uint8_t codes[CODE_BYTES + 16];
    __shared__ int32_t s_p[TILE], s_n[TILE], s_k0[TILE];
    __shared__ uint16_t s_nv[TILE], s_off[TILE + 1];
    __shared__ uint8_t s_bot[TILE];
    __shared__ int32_t s_warp[WARPS], s_k[2], s_total;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t n_tiles = (R + T - 1) / T;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t t0 = tile * T;
        const int Tn = (int)min((int64_t)T, R - t0);
        fill_dots(codes, Tn * KB);
        // the columns, and whether each read starts at or after the one
        // before it (a second, cached load of the read before)
        bool ok = true;
        FOR_MY_READS(t) {
            if (t < Tn) {
                const int32_t p = __ldg(pos1 + t0 + t);
                const int32_t n_r = __ldg(lens + t0 + t);
                ok &= t == 0 || __ldg(pos1 + t0 + t - 1) <= p;
                s_p[t] = p;
                s_n[t] = n_r;
                s_bot[t] = __ldg(bottom + t0 + t) != 0;
            }
        }
        // meanwhile warps 0 and 1 find the range a sorted tile reaches,
        // [first pos1, last pos1 + L) (every end is <= last pos1 + L)
        if (warp < 2) {
            const int64_t key =
                warp ? min((int64_t)__ldg(pos1 + t0 + Tn - 1) + L,
                           (int64_t)INT32_MAX)
                     : (int64_t)__ldg(pos1 + t0);
            const int k = warp_lower_bound(loci, n_loci, (int32_t)key);
            if (lane == 0) s_k[warp] = k;
        }
        const bool sorted = __syncthreads_and(ok);
        int path = UNSORTED, glo = 0, ghi = n_loci;
        if (sorted) {
            glo = s_k[0];
            ghi = s_k[1];
            path = ghi - (glo & ~3) > WIN ? WIDE : STAGED;
        }
        const int kb = glo & ~3;  // the window's first locus (16-byte aligned)
        if (path == STAGED) {
            const bool vec = ((uintptr_t)loci & 15) == 0;
            for (int g = tid; 4 * g < ghi - kb; g += THREADS) {
                const int k = kb + 4 * g;
                if (vec && k + 4 <= n_loci) {
                    cp_async16(win + 4 * g, loci + k);
                } else {
                    for (int e = 0; e < 4 && k + e < ghi; ++e)
                        win[4 * g + e] = __ldg(loci + k + e);
                }
            }
            cp_async_wait_all();
            __syncthreads();
        }
        // each read's window [k0, k0 + nv), at most 4 KB slots, and its
        // quads
        FOR_MY_READS(t) {
            int nv = 0;
            if (t < Tn) {
                const int32_t p = s_p[t], e = p + s_n[t];
                int k0;
                if (path == STAGED) {
                    k0 = kb + lower_bound_shared(win, glo - kb, ghi - kb, p);
                    nv = kb + lower_bound_shared(win, k0 - kb, ghi - kb, e) -
                         k0;
                } else {
                    k0 = lower_bound(loci, glo, ghi, p);
                    nv = lower_bound(loci, k0, ghi, e) - k0;
                }
                nv = min(nv, 4 * KB);
                s_k0[t] = k0;
                s_nv[t] = (uint16_t)nv;
            }
            s_off[t] = (uint16_t)((nv + 3) >> 2);
        }
        __syncthreads();
        const int total = scan_counts(s_off, TILE, s_warp, &s_total);
        // the calls, a quad of one read's slots an item
        const uint8_t* tseq = seq + t0 * L;
        for (int i = tid; i < total; i += THREADS) {
            const int r = item_row(s_off, Tn, i);
            const int q = i - s_off[r];
            const int32_t pr = s_p[r], nr = s_n[r], kr = s_k0[r];
            const int nvr = s_nv[r], br = s_bot[r];
            const uint8_t* row = tseq + r * L;
            // the quad's byte offsets, then all its row loads at once
            int32_t j[4];
            bool ok[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int s = 4 * q + t;
                ok[t] = s < nvr;
                const int32_t locus =
                    !ok[t] ? 0
                           : (path == STAGED ? win[kr - kb + s]
                                             : __ldg(loci + kr + s));
                j[t] = locus - pr + br;
                ok[t] = ok[t] && call_in_read(j[t], nr, br, clip);
            }
            uint32_t sb[4], nb[4];
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                sb[t] = ok[t] ? __ldg(row + j[t]) : 0u;
                nb[t] = ok[t] ? __ldg(row + j[t] + (br ? -1 : 1)) : 0u;
            }
            uint32_t byte = 0;
#pragma unroll
            for (int t = 0; t < 4; ++t)
                byte |= (ok[t] ? code_of(sb[t], nb[t], br) : DOT) << (2 * t);
            codes[r * KB + q] = (uint8_t)byte;
        }
        __syncthreads();
        FOR_MY_READS(t) {
            if (t < Tn) {
                const int nq = (s_nv[t] + 3) >> 2;
                int f, sp;
                known_span(codes + t * KB, nq, f, sp);
                first_k[t0 + t] = sp ? s_k0[t] + f : -1;
                span[t0 + t] = sp;
                align_row(codes + t * KB, f, sp, nq);
            }
        }
        __syncthreads();
        copy_out(packed + t0 * KB, codes, Tn * KB);
        if (paths && tid == 0) atomicAdd(paths + path, 1ull);
        __syncthreads();  // the next tile reuses the shared arrays
    }
}

__global__ void __launch_bounds__(THREADS)
call_reads_long_kernel(const uint8_t* __restrict__ seq,
                       const int32_t* __restrict__ lens,
                       const int32_t* __restrict__ pos1,
                       const uint8_t* __restrict__ bottom,
                       const int32_t* __restrict__ loci,
                       int32_t* __restrict__ first_k,
                       int32_t* __restrict__ span,
                       uint8_t* __restrict__ packed,
                       unsigned long long* __restrict__ paths, int64_t R,
                       int64_t L, int32_t n_loci, int32_t KB, int32_t clip) {
    const int lane = threadIdx.x & 31;
    const int64_t n_warps = (int64_t)gridDim.x * WARPS;
    for (int64_t r = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); r < R;
         r += n_warps) {
        const int32_t p = __ldg(pos1 + r);
        const int32_t n_r = __ldg(lens + r);
        const int bot = __ldg(bottom + r) != 0;
        const uint8_t* row = seq + r * L;
        // lane 0 finds k0, lane 1 k1
        const int k = lower_bound(loci, 0, n_loci, lane == 0 ? p : p + n_r);
        const int k0 = __shfl_sync(0xffffffffu, k, 0);
        const int nv = min(__shfl_sync(0xffffffffu, k, 1) - k0, 4 * KB);
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
            if (paths) atomicAdd(paths + LONG, 1ull);
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

// The columns of a mate of span sp in a pattern matrix S wide that can
// hold a call: min(sp, S, 300), at least 0.
__device__ __forceinline__ uint16_t call_cols(int sp, int64_t S) {
    return (uint16_t)max(0, (int)min(min((int64_t)sp, S),
                                     (int64_t)MAX_PE_PAT_LEN));
}

// A tile's rows [A, Z) of a pattern matrix [base, end) into `stage` from
// the 16-byte group A falls in: whole groups inside the matrix by
// cp.async, the bytes of [A, Z) in a group that is not whole inside it one
// at a time. Row r of the tile is at stage + (A & 15) + r * S.
__device__ __forceinline__ void stage_rows(uint8_t* stage,
                                           const uint8_t* base,
                                           const uint8_t* end,
                                           const uint8_t* A,
                                           const uint8_t* Z) {
    const uint8_t* Af = (const uint8_t*)((uintptr_t)A & ~(uintptr_t)15);
    const int groups = (int)((Z - Af + 15) / 16);
    for (int g = threadIdx.x; g < groups; g += THREADS) {
        const uint8_t* at = Af + 16 * g;
        if (at >= base && at + 16 <= end) {
            cp_async16(stage + 16 * g, at);
        } else {
            for (int e = 0; e < 16; ++e)
                if (at + e >= A && at + e < Z) stage[16 * g + e] = at[e];
        }
    }
}

// With STAGED, a tile's rows come from shared memory (merge_pe_plan's body
// 0), else from global memory (body 1). Dynamic shared memory: the staged
// rows of mate 1, then of mate 2 (merge_pe_plan's bytes).
template <bool STAGED>
__global__ void __launch_bounds__(THREADS)
merge_pe_kernel(const int64_t* __restrict__ s1, const int32_t* __restrict__ sp1,
                const uint8_t* __restrict__ p1, const int64_t* __restrict__ s2,
                const int32_t* __restrict__ sp2, const uint8_t* __restrict__ p2,
                int64_t* __restrict__ start, int32_t* __restrict__ span,
                uint8_t* __restrict__ packed, uint8_t* __restrict__ too_long,
                int64_t n, int64_t S1, int64_t S2, int32_t T,
                int32_t stage2) {
    extern __shared__ __align__(16) uint8_t stage[];
    __shared__ __align__(16) uint8_t codes[MERGE_TILE * MERGE_BYTES + 16];
    // a pair's columns, B's offset, and the columns of A and of B that
    // hold a call (min(span, width, 300)), all < 2^16
    __shared__ uint16_t s_cap[MERGE_TILE], s_boff[MERGE_TILE];
    __shared__ uint16_t s_asp[MERGE_TILE], s_bsp[MERGE_TILE];
    __shared__ uint16_t s_off[MERGE_TILE + 1];
    __shared__ uint8_t s_swap[MERGE_TILE];
    __shared__ int32_t s_warp[WARPS], s_total;
    const int tid = threadIdx.x;
    const int64_t n_tiles = (n + T - 1) / T;
    for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int64_t t0 = tile * T;
        const int Tn = (int)min((int64_t)T, n - t0);
        const bool mine = tid < Tn;
        fill_dots(codes, Tn * MERGE_BYTES);
        int nq = 0;
        int64_t a_s = 0;
        bool longer = false;
        if (mine) {
            const int64_t x1 = __ldg(s1 + t0 + tid), x2 = __ldg(s2 + t0 + tid);
            const int l1 = __ldg(sp1 + t0 + tid), l2 = __ldg(sp2 + t0 + tid);
            const bool swap = x1 > x2;
            a_s = swap ? x2 : x1;
            const int64_t b_s = swap ? x1 : x2;
            const int a_sp = swap ? l2 : l1, b_sp = swap ? l1 : l2;
            const int64_t width = max(a_s + a_sp, b_s + b_sp) - a_s;
            longer = width > MAX_PE_PAT_LEN;
            const int cap = (int)min(width, (int64_t)MAX_PE_PAT_LEN);
            // a too-long pair's output is all '.': no columns
            nq = longer ? 0 : (max(cap, 0) + 3) >> 2;
            s_cap[tid] = (uint16_t)max(cap, 0);
            // past the cap B adds nothing, so its offset fits 16 bits
            s_boff[tid] =
                (uint16_t)min(b_s - a_s, (int64_t)(2 * MAX_PE_PAT_LEN));
            s_asp[tid] = call_cols(a_sp, swap ? S2 : S1);
            s_bsp[tid] = call_cols(b_sp, swap ? S1 : S2);
            s_swap[tid] = swap;
        }
        int sh1 = 0, sh2 = 0;
        if (STAGED) {
            const uint8_t* A1 = p1 + t0 * S1;
            const uint8_t* A2 = p2 + t0 * S2;
            stage_rows(stage, p1, p1 + n * S1, A1, A1 + Tn * S1);
            stage_rows(stage + stage2, p2, p2 + n * S2, A2, A2 + Tn * S2);
            cp_async_wait_all();
            sh1 = (int)((uintptr_t)A1 & 15);
            sh2 = stage2 + (int)((uintptr_t)A2 & 15);
        }
        s_off[tid] = (uint16_t)nq;
        __syncthreads();
        const int total = scan_counts(s_off, MERGE_TILE, s_warp, &s_total);
        for (int i = tid; i < total; i += THREADS) {
            const int r = item_row(s_off, Tn, i);
            const int q = i - s_off[r];
            const bool swap = s_swap[r];
            const int cap = s_cap[r], b_off = s_boff[r];
            const int a_n = s_asp[r], b_n = s_bsp[r];
            const uint8_t *r1, *r2;
            if (STAGED) {
                r1 = stage + sh1 + r * (int)S1;
                r2 = stage + sh2 + r * (int)S2;
            } else {
                r1 = p1 + (t0 + r) * S1;
                r2 = p2 + (t0 + r) * S2;
            }
            const uint8_t* ap = swap ? r2 : r1;
            const uint8_t* bp = swap ? r1 : r2;
            uint32_t byte = 0;
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                const int c = 4 * q + t;
                uint32_t code = DOT;
                if (c < cap) {
                    const uint32_t A = c < a_n ? char_code(ap[c]) : DOT;
                    const int bi = c - b_off;
                    const uint32_t B =
                        (bi >= 0 && bi < b_n) ? char_code(bp[bi]) : DOT;
                    code = A == DOT ? B : ((B != DOT && A != B) ? DOT : A);
                }
                byte |= code << (2 * t);
            }
            codes[r * MERGE_BYTES + q] = (uint8_t)byte;
        }
        __syncthreads();
        if (mine) {
            int f, sp;
            known_span(codes + tid * MERGE_BYTES, nq, f, sp);
            start[t0 + tid] = sp ? a_s + f : -1;
            span[t0 + tid] = sp;
            too_long[t0 + tid] = longer ? 1 : 0;
            align_row(codes + tid * MERGE_BYTES, f, sp, nq);
        }
        __syncthreads();
        copy_out(packed + t0 * MERGE_BYTES, codes, Tn * MERGE_BYTES);
        __syncthreads();  // the next tile reuses the shared arrays
    }
}

int grid_for(int64_t tiles) {
    return (int)(tiles < (1 << 30) ? tiles : (1 << 30));
}

int stage_bytes(int64_t T, int64_t S) {  // one mate's rows, 16-byte groups
    return (int)((T * S + 15 + 15) / 16 * 16);
}

// call_reads' reads a tile for KB packed bytes a read: the most, a
// multiple of TILE_ALIGN up to TILE, whose codes fit CODE_BYTES; 0 (the
// long body) when not even TILE_ALIGN fit.
int64_t tile_reads(int64_t KB) {
    return std::min<int64_t>(TILE, CODE_BYTES / KB) / TILE_ALIGN * TILE_ALIGN;
}

}  // namespace

extern "C" {

// R < 0, L < 1, n_loci < 0, KB < 1 or clip < 0 returns
// cudaErrorInvalidValue; R == 0 launches nothing. Every lens[r] must be
// <= L and KB * 4 must hold every read's calls (len / 2 + 1 of them).
// With `paths` (int64[4], or null), the kernel counts the paths it takes:
// [staged, unsorted, wide] tiles and long reads. Launches on `stream` on the
// current device.
int call_reads_paths(const void* seq, const void* lens, const void* pos1,
                     const void* bottom, const void* loci, void* first_k,
                     void* span, void* packed, void* paths, int64_t R,
                     int64_t L, int64_t n_loci, int64_t KB, int64_t clip,
                     void* stream) {
    if (R < 0 || L < 1 || n_loci < 0 || n_loci > INT32_MAX || KB < 1 ||
        KB > INT32_MAX || clip < 0 || clip > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    if (R == 0) return 0;
    const int64_t T = tile_reads(KB);
    if (T == 0)
        return wgbs::launch(call_reads_long_kernel,
                            dim3(grid_for((R + WARPS - 1) / WARPS)), THREADS,
                            0, stream, (const uint8_t*)seq,
                            (const int32_t*)lens, (const int32_t*)pos1,
                            (const uint8_t*)bottom, (const int32_t*)loci,
                            (int32_t*)first_k, (int32_t*)span,
                            (uint8_t*)packed, (unsigned long long*)paths, R,
                            L, (int32_t)n_loci, (int32_t)KB, (int32_t)clip);
    return wgbs::launch(call_reads_tiles_kernel,
                        dim3(grid_for((R + T - 1) / T)), THREADS,
                        0, stream, (const uint8_t*)seq, (const int32_t*)lens,
                        (const int32_t*)pos1, (const uint8_t*)bottom,
                        (const int32_t*)loci, (int32_t*)first_k,
                        (int32_t*)span, (uint8_t*)packed,
                        (unsigned long long*)paths, R, L, (int32_t)n_loci,
                        (int32_t)KB, (int32_t)clip, (int32_t)T);
}

int call_reads(const void* seq, const void* lens, const void* pos1,
               const void* bottom, const void* loci, void* first_k, void* span,
               void* packed, int64_t R, int64_t L, int64_t n_loci, int64_t KB,
               int64_t clip, void* stream) {
    return call_reads_paths(seq, lens, pos1, bottom, loci, first_k, span,
                            packed, nullptr, R, L, n_loci, KB, clip, stream);
}

// The launch merge_pe makes for pattern widths S1, S2: out = {body (0
// staged, 1 gather), pairs a tile, dynamic shared bytes}. Touches no
// device.
int merge_pe_plan(int64_t S1, int64_t S2, int64_t* out) {
    if (S1 < 1 || S2 < 1 || S1 > INT32_MAX || S2 > INT32_MAX)
        return (int)cudaErrorInvalidValue;
    const int64_t T = std::min<int64_t>(MERGE_TILE, STAGE_BYTES / (S1 + S2))
                      / TILE_ALIGN * TILE_ALIGN;
    const bool staged = T >= MERGE_TILE_MIN;
    out[0] = !staged;
    out[1] = staged ? T : MERGE_TILE;
    out[2] = staged ? stage_bytes(T, S1) + stage_bytes(T, S2) : 0;
    return 0;
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
    int64_t plan[3];
    merge_pe_plan(S1, S2, plan);
    const int T = (int)plan[1];
    const dim3 grid(grid_for((n + T - 1) / T));
    const int stage2 = plan[0] ? 0 : stage_bytes(T, S1);
    return wgbs::launch(
        plan[0] ? merge_pe_kernel<false> : merge_pe_kernel<true>, grid,
        THREADS, (size_t)plan[2], stream, (const int64_t*)s1,
        (const int32_t*)sp1, (const uint8_t*)p1, (const int64_t*)s2,
        (const int32_t*)sp2, (const uint8_t*)p2, (int64_t*)start,
        (int32_t*)span, (uint8_t*)packed, (uint8_t*)too_long, n, S1, S2, T,
        stage2);
}

}  // extern "C"
