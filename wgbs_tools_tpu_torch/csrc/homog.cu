// Hand-written Hopper (sm_90a) kernel for homog's read-level binning
// (wgbs_tools_tpu_torch/ops/frag_ops.py::homog_bins):
//
//   codes   u8  [F][L]     a slab's calls, T=0 C=1 H=2 '.'=3
//   fstart  i32 [F]        each fragment's first site (1-based)
//   flen    i32 [F]        its length in sites
//   fcount  i32 [F]        its count
//   bstart  i64 [B]        the blocks' [startCpG, endCpG), sorted by start
//   bend    i64 [B]
//   fi, bi  i32 [P]        the (fragment, block) overlap pairs
//                          (frag_ops.py::overlap_pairs, on the host)
//   ranges  f32 [nbins+1]  the bin edges, 0 first and 1 last
//   out     i64 [B][nbins] read counts per block and bin, added to in place
//
// Per pair: the fragment's calls inside the clip [off, off + length) (the
// whole fragment with `inclusive`, else its overlap with the block) give
// nrC (C or H) and nrT (T). The pair counts when the clip's length (the
// fragment's with `inclusive`) and informative = nrC + nrT are both >=
// min_cpgs and informative > 0. Its bin is the number of edges <= meth =
// nrC / informative, an IEEE float32 division (__fdiv_rn; the source is
// built without fast math), minus 1, capped at nbins - 1: numpy's
// searchsorted(ranges, meth, side="right") - 1, so a meth equal to an edge
// goes to the bin above it and meth 1.0 to the last. Then out[b][bin] +=
// count, a 64-bit atomic. Replaces wgbs_tools_tpu/ops/frag_ops.py::
// _homog_kernel_jax (:204), which gathers codes[fi] on the host and runs
// the clip, counts, bins and a segment_sum in XLA; here each pair reads its
// fragment's row of the slab's codes, uploaded once, through fi.
//
// Bound: bytes. The slab's codes, its fragment columns, the pairs and the
// blocks are read once and each (block, bin) cell that gets a count is
// read and written once; the clip's bytes (a few dozen a pair) are the
// work. The atomics' order varies, the counts are integers: exact.
//
// One thread per pair, grid-strided. Pairs come fragment by fragment, so
// neighbouring threads mostly read the same or the next rows of codes
// (L1 and L2 serve them) and add into the same or neighbouring blocks.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
homog_bins_kernel(const uint8_t* __restrict__ codes,
                  const int* __restrict__ fstart,
                  const int* __restrict__ flen,
                  const int* __restrict__ fcount,
                  const int64_t* __restrict__ bstart,
                  const int64_t* __restrict__ bend,
                  const int* __restrict__ fi, const int* __restrict__ bi,
                  const float* __restrict__ ranges,
                  unsigned long long* __restrict__ out, int64_t P, int64_t L,
                  int64_t nbins, int64_t min_cpgs, bool inclusive) {
    const int64_t stride = (int64_t)gridDim.x * THREADS;
    for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < P;
         i += stride) {
        const int64_t f = fi[i], b = bi[i];
        const int64_t s = fstart[f], ln = flen[f];
        int64_t off = 0, len = ln;
        if (!inclusive) {
            const int64_t bs = bstart[b], be = bend[b];
            const int64_t os = s > bs ? s : bs;
            const int64_t oe = s + ln < be ? s + ln : be;
            off = os - s;
            len = oe - os;
        }
        // len doubles as the length gate (the whole fragment's with
        // inclusive, as numpy's len_gate)
        if (len < min_cpgs) continue;
        const uint8_t* row = codes + f * L;
        const int64_t end = off + len < L ? off + len : L;
        int nrC = 0, nrT = 0;
        for (int64_t c = off < 0 ? 0 : off; c < end; ++c) {
            const int code = row[c];
            nrC += (code == 1) | (code == 2);
            nrT += code == 0;
        }
        const int informative = nrC + nrT;
        if (informative < min_cpgs || informative <= 0) continue;
        const float meth = __fdiv_rn((float)nrC, (float)informative);
        int64_t le = 0;  // edges <= meth
        for (int64_t k = 0; k <= nbins; ++k) le += ranges[k] <= meth;
        int64_t bin = le - 1;
        if (bin > nbins - 1) bin = nbins - 1;
        atomicAdd(out + b * nbins + bin,
                  (unsigned long long)(long long)fcount[f]);
    }
}

}  // namespace

extern "C" {

// P < 0, L < 1 or nbins < 1 returns
// cudaErrorInvalidValue; P == 0 launches nothing. Launches on `stream` on
// the current device, on at most 132 x 16 CTAs (pairs grid-strided).
int homog_bins(const void* codes, const void* fstart, const void* flen,
               const void* fcount, const void* bstart, const void* bend,
               const void* fi, const void* bi, const void* ranges, void* out,
               int64_t P, int64_t L, int64_t nbins, int64_t min_cpgs,
               int64_t inclusive, void* stream) {
    if (P < 0 || L < 1 || nbins < 1)
        return (int)cudaErrorInvalidValue;
    if (P == 0) return 0;
    const int64_t want = (P + THREADS - 1) / THREADS;
    const unsigned grid = (unsigned)(want < 132 * 16 ? want : 132 * 16);
    homog_bins_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const int*)fstart, (const int*)flen,
        (const int*)fcount, (const int64_t*)bstart, (const int64_t*)bend,
        (const int*)fi, (const int*)bi, (const float*)ranges,
        (unsigned long long*)out, P, L, nbins, min_cpgs, inclusive != 0);
    return (int)cudaGetLastError();
}

}  // extern "C"
