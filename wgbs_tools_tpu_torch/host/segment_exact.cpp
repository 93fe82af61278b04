// The port's own copy of native/segment_exact.cpp, unchanged below this
// note, with the same C name. wgbs_tools_tpu_torch/native.py builds it with
// host/wgbsio.cpp into one library (g++ at first use) and binds
// segment_exact_dp as segment_exact_native.
//
// Exact-parity change-point segmentation DP.
//
// Numeric chain mirrors the reference segmentor (ref: src/segment_betas/
// segmentor.cpp:60-159) so block borders come out byte-identical:
//   - nmeth/ntotal accumulate in float (exact: integer-valued < 2^24)
//   - p_mle = (nmeth + pc) / (ntotal + 2*pc) computed in float
//   - log2 evaluated in double (libm), each product rounded back through a
//     float accumulator per dataset (ll_k), summed across datasets in double
//   - DP maximization in double with strict-'>' first-argmax tie-breaking
//
// Two exactness-preserving optimizations over the reference's loop:
//   1. When loci are strictly non-decreasing (always, for real dictionaries)
//      the max_bp cutoff is monotone in j, so each cost row is computed only
//      inside its [0, band) prefix and the tail is bulk-filled with -inf —
//      identical values, no per-cell branch.
//   2. The DP inner scan skips k whose row cannot reach i (band_hi[k] <= i):
//      those candidates are -inf and -inf never wins a strict '>' against
//      the -inf initializer, so the argmax is unchanged.
// A literal (reference-shaped) fallback loop handles non-monotone loci.
//
// Per-dataset log-likelihoods are additionally cached between adjacent j
// when the newly absorbed site has zero counts for that dataset: the float
// inputs to the chain are bit-identical, so the cached float output is too.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

// ll(nm, nt) memoization. The per-dataset float chain
//   p  = (nm + pc) / (nt + 2*pc)                       [float]
//   ll = fl(fl(nm * log2((double)p)) + (nt-nm) * log2(1-(double)p))
// is a pure function of the integer-valued float pair (nm, nt) and pc, so
// its output can be cached and replayed bit-identically. Realistic blocks
// (max_bp ~2kb at >=30x) keep nt within a few thousand, making a
// triangular table L2/L3-resident; the libm log2 calls it replaces are
// ~80% of the exact kernel's cycles. Larger pairs fall through to the
// direct computation. Table is per-thread and rebuilt when pc changes.
constexpr int64_t NT_CAP = 512;  // pairs with nt < NT_CAP are cached
constexpr size_t TBL_SIZE = (size_t)NT_CAP * (NT_CAP + 1) / 2;

inline float ll_direct(float nmk, float ntk, float pc) {
    const float p = (nmk + pc) / (ntk + 2 * pc);
    float ll = 0.0f;
    if (p > 0.0) ll += nmk * log2((double)p);
    if (p < 1.0) ll += (ntk - nmk) * log2(1.0 - (double)p);
    return ll;
}

struct LLMemo {
    std::vector<float> tbl;
    float pc = std::numeric_limits<float>::quiet_NaN();

    void reset(float new_pc) {
        if (pc == new_pc && !tbl.empty()) return;
        pc = new_pc;
        tbl.assign(TBL_SIZE, std::numeric_limits<float>::quiet_NaN());
    }

    // caller guarantees nmk/ntk are exact integers with 0<=nmk<=ntk<NT_CAP
    inline float get_small(float nmk, float ntk) {
        const int64_t nti = (int64_t)ntk;
        float& slot = tbl[(size_t)nti * (nti + 1) / 2 + (int64_t)nmk];
        if (std::isnan(slot)) slot = ll_direct(nmk, ntk, pc);
        return slot;
    }
};

thread_local LLMemo g_memo;

}  // namespace

extern "C" {

// data:  (K, n, 2) float32, [meth, total] per site (integer-valued)
// dists: (n,) uint32 basepair loci (used only when max_bp != 0)
// T_out: (n+1,) int32 traceback (T_out[0] unused, set to 0)
// Returns 0 on success, -1 on bad arguments.
int64_t segment_exact_dp(const float* data, int64_t K, int64_t n,
                         const uint32_t* dists, int32_t max_cpg,
                         uint32_t max_bp, float pseudo_count,
                         int32_t* T_out) {
    if (n <= 0 || K <= 0 || max_cpg <= 0) return -1;
    // memoization is valid only for exact-integer counts (always true for
    // beta-derived data); verified once so the hot loop needs no per-cell
    // integrality checks
    bool memo_ok = true;
    double cov_sum = 0.0;
    for (int64_t x = 0; x < K * n; x++) {
        const float m = data[2 * x], t = data[2 * x + 1];
        // meth > cov (malformed beta) would accumulate nm > nt and index
        // past the triangular memo row — an OOB heap write, not just a
        // garbage likelihood; such input must fall through to ll_direct
        if (m < 0.0f || t < 0.0f || m != (float)(int64_t)m
            || t != (float)(int64_t)t || t >= 16777216.0f || m > t) {
            memo_ok = false;
            break;
        }
        cov_sum += t;
    }
    const float nt_cap_f = (float)NT_CAP;
    const double NEG_INF = -std::numeric_limits<double>::infinity();
    const int64_t W = max_cpg;

    int64_t ring_size = 1;
    while (ring_size < W) ring_size <<= 1;
    const int64_t ring_mask = ring_size - 1;
    std::vector<double> ring((size_t)ring_size * W);
    std::vector<double> M((size_t)n + 1, 0.0);
    std::vector<float> nm((size_t)K), nt((size_t)K), ll_cache((size_t)K);

    bool monotone = true;
    if (max_bp) {
        for (int64_t i = 1; i < n; i++)
            if (dists[i] < dists[i - 1]) { monotone = false; break; }
    }

    // band_hi[i] = exclusive end of the cost band for rows starting at i
    std::vector<int64_t> band_hi;
    if (monotone) {
        band_hi.resize((size_t)n);
        int64_t hi = 0;
        for (int64_t i = 0; i < n; i++) {
            if (hi < i + 1) hi = i + 1;
            if (max_bp) {
                while (hi < n && (uint32_t)(dists[hi] - dists[i]) <= max_bp)
                    hi++;
            } else {
                hi = n;
            }
            int64_t cap = i + W < n ? i + W : n;
            band_hi[i] = hi < cap ? hi : cap;
        }
    }

    // enable the memo only when typical in-band block totals fit the cap:
    // at high coverage the sub-cap prefix cells have little reuse and the
    // scattered table lookups cost more than the libm calls they replace
    // (measured: 1.8x faster at ~4x coverage, ~5% slower at 30x without
    // this gate)
    if (memo_ok) {
        double band_est = (double)W;
        if (monotone && max_bp && n > 1) {
            int64_t s = 0, cnt = 0;
            for (int64_t i = 0; i < n; i += 64) {
                s += band_hi[i] - i;
                cnt++;
            }
            band_est = (double)s / (double)cnt;
        }
        const double mean_cov = cov_sum / (double)(n * K);
        memo_ok = mean_cov * band_est <= (double)NT_CAP;
        if (memo_ok) g_memo.reset(pseudo_count);
    }

    int64_t k_lo = 0;  // smallest k whose band can still reach i
    T_out[0] = 0;
    for (int64_t i = 0; i < n; i++) {
        double* row = &ring[(size_t)(i & ring_mask) * W];
        std::memset(nm.data(), 0, (size_t)K * sizeof(float));
        std::memset(nt.data(), 0, (size_t)K * sizeof(float));
        std::memset(ll_cache.data(), 0, (size_t)K * sizeof(float));
        const int64_t window = (n - i) < W ? (n - i) : W;

        if (monotone) {
            const int64_t band = band_hi[i] - i;  // >= 1 (j=0 always passes)
            for (int64_t j = 0; j < band; j++) {
                double ll_sum = 0.0;
                for (int64_t k = 0; k < K; k++) {
                    const float m_add = data[((size_t)k * n + i + j) * 2];
                    const float t_add = data[((size_t)k * n + i + j) * 2 + 1];
                    if (m_add == 0.0f && t_add == 0.0f) {
                        ll_sum += ll_cache[k];
                        continue;
                    }
                    nm[k] += m_add;
                    nt[k] += t_add;
                    const float ntk = nt[k], nmk = nm[k];
                    if (!ntk) continue;  // unreachable here (t_add > 0)
                    const float ll = (memo_ok && ntk < nt_cap_f)
                        ? g_memo.get_small(nmk, ntk)
                        : ll_direct(nmk, ntk, pseudo_count);
                    ll_cache[k] = ll;
                    ll_sum += ll;
                }
                row[j] = (ll_sum != 0.0) ? ll_sum : 0.0;
            }
            if (band < window)
                std::fill(row + band, row + window, NEG_INF);
        } else {
            // literal reference semantics for non-monotone loci: the dist
            // test may pass again after failing, and skipped sites are not
            // absorbed into the running counts (segmentor.cpp:112-117)
            for (int64_t j = 0; j < window; j++) {
                if (max_bp && ((uint32_t)(dists[i + j] - dists[i]) > max_bp
                               || dists[i + j] < dists[i])) {
                    row[j] = NEG_INF;
                    continue;
                }
                double ll_sum = 0.0;
                for (int64_t k = 0; k < K; k++) {
                    nm[k] += data[((size_t)k * n + i + j) * 2];
                    nt[k] += data[((size_t)k * n + i + j) * 2 + 1];
                    const float ntk = nt[k], nmk = nm[k];
                    if (!ntk) continue;
                    ll_sum += (memo_ok && ntk < nt_cap_f)
                        ? g_memo.get_small(nmk, ntk)
                        : ll_direct(nmk, ntk, pseudo_count);
                }
                // always write: the reference prefills each row with 0.0
                // (segmentor.cpp:105 std::fill) — leaving the ring slot's
                // stale previous-row value on a zero ll_sum (all-zero
                // coverage prefix) would poison the DP after W rows
                row[j] = (ll_sum != 0.0) ? ll_sum : 0.0;
            }
        }
        if (window < W)
            std::fill(row + window, row + W, 0.0);  // never read; keep clean

        // DP step: M[i+1] = max over k in [max(0, i+1-W), i] of M[k] +
        // row_k[i-k], first maximum wins (strict '>')
        double best = NEG_INF;
        int32_t best_ind = -1;
        int64_t k0 = i + 1 - W;
        if (k0 < 0) k0 = 0;
        if (monotone) {
            while (k_lo < i && band_hi[k_lo] <= i) k_lo++;
            if (k_lo > k0) k0 = k_lo;
        }
        for (int64_t k = k0; k <= i; k++) {
            const double* kr = &ring[(size_t)(k & ring_mask) * W];
            const double tmp = M[k] + kr[i - k];
            if (tmp > best) {
                best = tmp;
                best_ind = (int32_t)k;
            }
        }
        M[i + 1] = best;
        T_out[i + 1] = best_ind;
    }
    return 0;
}

}  // extern "C"
