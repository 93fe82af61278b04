// Host library of the PyTorch port: pat text parsing and serialization,
// the BGZF block deflater (write_pat's and index_bed's bgzip) and
// inflater, the host pileup (the oracle of the device kernels), the v3
// prep pass, row packer and placers that the pileup staging runs, and
// bam2pat's columnar BAM record scan and MM/ML tag parsers.
// segment_exact.cpp beside it holds the exact segmentation DP; both go into
// one library.
//
// The port's own copy of the functions it calls from native/wgbsio.cpp,
// with the same C names, so that a reader finds each one's counterpart
// there; place_pack_rows and place_vals_rows take int32 pieces (the dtype
// stage_prep_v3 gives). bed_scan (the blocks bed's one pass) and
// stage_prep_v3 (the v3 staging's prep) are the port's own.
// wgbs_tools_tpu_torch/native.py builds this file with g++ at first use
// and binds it with ctypes.
//
// Build: g++ -O3 -shared -fPIC -o libwgbs_host.so wgbsio.cpp segment_exact.cpp \
//            -lz -lpthread

#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// pat text parsing
// ---------------------------------------------------------------------------

// First pass: count records and the maximum pattern length.
// Returns 0 on success, -1 on malformed input.
int pat_scan(const char* buf, int64_t len, int64_t* n_lines,
             int64_t* max_len) {
    int64_t lines = 0, maxlen = 0;
    const char* p = buf;
    const char* end = buf + len;
    while (p < end) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* line_end = nl ? nl : end;
        if (line_end > p) {
            // third column is the pattern
            const char* t1 = (const char*)memchr(p, '\t', line_end - p);
            if (!t1) return -1;
            const char* t2 = (const char*)memchr(t1 + 1, '\t', line_end - t1 - 1);
            if (!t2) return -1;
            const char* t3 = (const char*)memchr(t2 + 1, '\t', line_end - t2 - 1);
            if (!t3) return -1;
            int64_t plen = t3 - (t2 + 1);
            if (plen > maxlen) maxlen = plen;
            lines++;
        }
        if (!nl) break;
        p = nl + 1;
    }
    *n_lines = lines;
    *max_len = maxlen;
    return 0;
}

// Second pass: fill the SoA arrays.
//   starts/lengths/counts: int32[n_lines]
//   codes: uint8[n_lines * max_len], pre-filled by caller or filled here
//          with 3 ('.') padding. T=0 C=1 H=2 .=3
//   chrom_ids: int16[n_lines]
//   chrom_buf: char[chrom_buf_cap] receives '\n'-separated distinct chrom
//              names in first-appearance order.
//   extras_off: int64[n_lines + 1]; extras byte ranges into buf (0-length
//               when a line has exactly 4 columns).
// Returns number of distinct chroms, or -1 on error.
int pat_parse(const char* buf, int64_t len, int64_t n_lines, int64_t max_len,
              int32_t* starts, int32_t* lengths, int32_t* counts,
              uint8_t* codes, int16_t* chrom_ids, char* chrom_buf,
              int64_t chrom_buf_cap, int64_t* extras_off) {
    // thread-safe lazy init (C++11 magic static): pat_parse now runs
    // concurrently on disjoint ranges from the Python-side MT parse
    struct PatLut {
        int8_t v[256];
        PatLut() {
            memset(v, -1, sizeof(v));
            v[(uint8_t)'T'] = 0; v[(uint8_t)'C'] = 1;
            v[(uint8_t)'H'] = 2; v[(uint8_t)'.'] = 3;
        }
    };
    static const PatLut lut_holder;
    const int8_t* lut = lut_holder.v;

    memset(codes, 3, (size_t)n_lines * max_len);

    std::vector<std::string> chroms;
    std::string cur_chrom;
    int16_t cur_id = -1;

    const char* p = buf;
    const char* end = buf + len;
    int64_t i = 0;
    while (p < end && i < n_lines) {
        const char* nl = (const char*)memchr(p, '\n', end - p);
        const char* line_end = nl ? nl : end;
        if (line_end > p) {
            const char* t1 = (const char*)memchr(p, '\t', line_end - p);
            const char* t2 = (const char*)memchr(t1 + 1, '\t', line_end - t1 - 1);
            const char* t3 = (const char*)memchr(t2 + 1, '\t', line_end - t2 - 1);
            if (!t1 || !t2 || !t3) return -1;

            // chrom
            if (cur_id < 0 || (size_t)(t1 - p) != cur_chrom.size() ||
                memcmp(p, cur_chrom.data(), t1 - p) != 0) {
                cur_chrom.assign(p, t1 - p);
                cur_id = -1;
                for (size_t c = 0; c < chroms.size(); c++) {
                    if (chroms[c] == cur_chrom) { cur_id = (int16_t)c; break; }
                }
                if (cur_id < 0) {
                    cur_id = (int16_t)chroms.size();
                    chroms.push_back(cur_chrom);
                }
            }
            chrom_ids[i] = cur_id;

            // start
            int64_t v = 0;
            for (const char* q = t1 + 1; q < t2; q++) {
                if (*q < '0' || *q > '9') return -1;
                v = v * 10 + (*q - '0');
            }
            starts[i] = (int32_t)v;

            // pattern
            int64_t plen = t3 - (t2 + 1);
            lengths[i] = (int32_t)plen;
            uint8_t* row = codes + (size_t)i * max_len;
            for (int64_t j = 0; j < plen; j++) {
                int8_t c = lut[(uint8_t)t2[1 + j]];
                if (c < 0) return -1;
                row[j] = (uint8_t)c;
            }

            // count (4th column, up to tab or line end)
            const char* t4 = (const char*)memchr(t3 + 1, '\t', line_end - t3 - 1);
            const char* cnt_end = t4 ? t4 : line_end;
            v = 0;
            for (const char* q = t3 + 1; q < cnt_end; q++) {
                if (*q < '0' || *q > '9') return -1;
                v = v * 10 + (*q - '0');
            }
            counts[i] = (int32_t)v;

            // extras
            if (t4) {
                extras_off[2 * i] = (t4 + 1) - buf;
                extras_off[2 * i + 1] = line_end - buf;
            } else {
                extras_off[2 * i] = 0;
                extras_off[2 * i + 1] = 0;
            }
            i++;
        }
        if (!nl) break;
        p = nl + 1;
    }

    // emit chrom names
    int64_t off = 0;
    for (auto& c : chroms) {
        if (off + (int64_t)c.size() + 1 > chrom_buf_cap) return -1;
        memcpy(chrom_buf + off, c.data(), c.size());
        off += c.size();
        chrom_buf[off++] = '\n';
    }
    if (off < chrom_buf_cap) chrom_buf[off] = 0;
    return (int)chroms.size();
}


// ---------------------------------------------------------------------------
// pat serialization: SoA arrays -> text buffer
// ---------------------------------------------------------------------------

// Returns the number of bytes written, or -1 if out_cap is too small.
int64_t pat_serialize(int64_t n_lines, int64_t max_len, const int32_t* starts,
                      const int32_t* lengths, const int32_t* counts,
                      const uint8_t* codes, const int16_t* chrom_ids,
                      const char* chrom_buf,  // '\n'-separated names
                      char* out, int64_t out_cap) {
    static const char dec[4] = {'T', 'C', 'H', '.'};
    // split chrom names
    std::vector<std::string> chroms;
    {
        const char* p = chrom_buf;
        while (*p) {
            const char* nl = strchr(p, '\n');
            if (!nl) break;
            chroms.emplace_back(p, nl - p);
            p = nl + 1;
        }
    }
    char* w = out;
    char* wend = out + out_cap;
    char tmp[16];
    for (int64_t i = 0; i < n_lines; i++) {
        const std::string& chrom = chroms[chrom_ids[i]];
        int64_t need = chrom.size() + 1 + 12 + lengths[i] + 12 + 2;
        if (w + need > wend) return -1;
        memcpy(w, chrom.data(), chrom.size());
        w += chrom.size();
        *w++ = '\t';
        w += sprintf(w, "%d", starts[i]);
        *w++ = '\t';
        const uint8_t* row = codes + (size_t)i * max_len;
        for (int32_t j = 0; j < lengths[i]; j++) *w++ = dec[row[j] & 3];
        *w++ = '\t';
        w += sprintf(w, "%d", counts[i]);
        *w++ = '\n';
    }
    return w - out;
}

// ---------------------------------------------------------------------------
// BGZF block deflater (multi-threaded)
// ---------------------------------------------------------------------------

static const int64_t BGZF_BLOCK = 65280;

static int64_t compress_one_block(const uint8_t* data, int64_t n, int level,
                                  uint8_t* out) {
    // header (18B) + deflate payload + crc/isize (8B)
    z_stream zs;
    memset(&zs, 0, sizeof(zs));
    deflateInit2(&zs, level, Z_DEFLATED, -15, 8, Z_DEFAULT_STRATEGY);
    zs.next_in = (Bytef*)data;
    zs.avail_in = (uInt)n;
    zs.next_out = out + 18;
    zs.avail_out = (uInt)(BGZF_BLOCK + 1024);
    deflate(&zs, Z_FINISH);
    int64_t payload = zs.total_out;
    deflateEnd(&zs);

    uint16_t bsize = (uint16_t)(payload + 25);
    const uint8_t hdr[16] = {0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff,
                             6, 0, 'B', 'C', 2, 0};
    memcpy(out, hdr, 16);
    out[16] = bsize & 0xff;
    out[17] = (bsize >> 8) & 0xff;
    uint32_t crc = crc32(0, data, (uInt)n);
    uint8_t* f = out + 18 + payload;
    memcpy(f, &crc, 4);
    uint32_t isize = (uint32_t)n;
    memcpy(f + 4, &isize, 4);
    return 18 + payload + 8;
}

// Compress `len` bytes into BGZF blocks using `n_threads` workers.
// out must have capacity >= (len/BGZF_BLOCK + 2) * (BGZF_BLOCK + 1064).
// Appends the 28-byte EOF marker. Returns bytes written.
int64_t bgzf_compress_mt(const uint8_t* data, int64_t len, uint8_t* out,
                         int n_threads, int level) {
    int64_t n_blocks = (len + BGZF_BLOCK - 1) / BGZF_BLOCK;
    if (n_blocks == 0) n_blocks = 0;
    std::vector<int64_t> sizes(n_blocks, 0);
    int64_t stride = BGZF_BLOCK + 1064;
    std::vector<uint8_t> scratch((size_t)n_blocks * stride);

    auto worker = [&](int tid) {
        for (int64_t b = tid; b < n_blocks; b += n_threads) {
            int64_t off = b * BGZF_BLOCK;
            int64_t n = std::min(BGZF_BLOCK, len - off);
            sizes[b] = compress_one_block(data + off, n, level,
                                          scratch.data() + b * stride);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();

    uint8_t* w = out;
    for (int64_t b = 0; b < n_blocks; b++) {
        memcpy(w, scratch.data() + b * stride, sizes[b]);
        w += sizes[b];
    }
    static const uint8_t eof[28] = {
        0x1f, 0x8b, 0x08, 0x04, 0, 0, 0, 0, 0, 0xff, 0x06, 0x00, 0x42,
        0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
        0x00, 0x00, 0x00, 0x00};
    memcpy(w, eof, 28);
    w += 28;
    return w - out;
}

// ---------------------------------------------------------------------------
// BGZF block inflater (multi-threaded)
// ---------------------------------------------------------------------------

// Decompress a BGZF/multi-member-gzip buffer. Two-phase:
// bgzf_scan_blocks fills (in_off, out_off) pairs so callers can size the
// output and decompress in parallel.
int64_t bgzf_scan_blocks(const uint8_t* data, int64_t len, int64_t* in_offs,
                         int64_t* out_offs, int64_t max_blocks) {
    int64_t nb = 0;
    int64_t in_pos = 0, out_pos = 0;
    while (in_pos + 18 <= len && nb < max_blocks) {
        if (data[in_pos] != 0x1f || data[in_pos + 1] != 0x8b) return -1;
        uint16_t xlen = data[in_pos + 10] | (data[in_pos + 11] << 8);
        // find BC subfield
        int64_t xs = in_pos + 12;
        int64_t bsize = -1;
        int64_t p = xs;
        while (p + 4 <= xs + xlen) {
            uint8_t s1 = data[p], s2 = data[p + 1];
            uint16_t slen = data[p + 2] | (data[p + 3] << 8);
            if (s1 == 'B' && s2 == 'C' && slen == 2) {
                bsize = (data[p + 4] | (data[p + 5] << 8)) + 1;
                break;
            }
            p += 4 + slen;
        }
        if (bsize < 0) return -2;  // not BGZF
        uint32_t isize;
        memcpy(&isize, data + in_pos + bsize - 4, 4);
        in_offs[nb] = in_pos;
        out_offs[nb] = out_pos;
        out_pos += isize;
        in_pos += bsize;
        nb++;
    }
    in_offs[nb] = in_pos;
    out_offs[nb] = out_pos;
    return nb;
}

int bgzf_decompress_mt(const uint8_t* data, int64_t len, const int64_t* in_offs,
                       const int64_t* out_offs, int64_t n_blocks, uint8_t* out,
                       int n_threads) {
    volatile int err = 0;
    auto worker = [&](int tid) {
        for (int64_t b = tid; b < n_blocks; b += n_threads) {
            int64_t in_pos = in_offs[b];
            uint16_t xlen = data[in_pos + 10] | (data[in_pos + 11] << 8);
            int64_t payload_off = in_pos + 12 + xlen;
            int64_t payload_len = in_offs[b + 1] - payload_off - 8;
            int64_t out_n = out_offs[b + 1] - out_offs[b];
            if (out_n == 0) continue;
            z_stream zs;
            memset(&zs, 0, sizeof(zs));
            inflateInit2(&zs, -15);
            zs.next_in = (Bytef*)(data + payload_off);
            zs.avail_in = (uInt)payload_len;
            zs.next_out = out + out_offs[b];
            zs.avail_out = (uInt)out_n;
            int r = inflate(&zs, Z_FINISH);
            if (r != Z_STREAM_END) err = 1;
            inflateEnd(&zs);
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
    return err ? -1 : 0;
}

// ---------------------------------------------------------------------------
// pileup (host fallback of the device kernel)
// ---------------------------------------------------------------------------

// Accumulate pat fragments into a (n_sites, 2) int64 [meth, cov] table —
// the same reduction as ops/pileup.py (ref: src/pat2beta/stdin2beta.cpp:59-93)
// computed on the host. Used when the accelerator link is thin (the SoA
// arrays are already decoded, so this runs at memory bandwidth) and as an
// independent oracle for the device kernels.
//
// codes: row-major uint8 (F, max_len), T=0 C=1 H=2 .=3 (formats/pat.py).
// start: 1-based global CpG indices, REQUIRED sorted ascending when
// n_threads > 1 (threads partition the site axis and binary-search their
// fragment range; the per-thread site guard makes overlap duplication safe).
// out: caller-zeroed int64 (n_sites, 2); this function adds into it.
static void pileup_range(const int32_t* start, const int32_t* length,
                         const int32_t* count, const uint8_t* codes,
                         int64_t f_lo, int64_t f_hi, int64_t max_len,
                         int64_t window_start, int64_t site_lo,
                         int64_t site_hi, int64_t* out) {
    for (int64_t f = f_lo; f < f_hi; f++) {
        int64_t rel = (int64_t)start[f] - window_start;
        int64_t cnt = count[f];
        const uint8_t* row = codes + f * max_len;
        int64_t len = length[f];
        if (len > max_len) len = max_len;
        for (int64_t j = 0; j < len; j++) {
            uint8_t c = row[j];
            if (c == 3) continue;  // '.'
            int64_t site = rel + j;
            if (site < site_lo || site >= site_hi) continue;
            out[2 * site + 1] += cnt;           // cov: C/T/H
            if (c == 1 || c == 2) out[2 * site] += cnt;  // meth: C/H
        }
    }
}

void pat_pileup(const int32_t* start, const int32_t* length,
                const int32_t* count, const uint8_t* codes, int64_t n_frags,
                int64_t max_len, int64_t window_start, int64_t n_sites,
                int64_t* out, int n_threads) {
    if (n_frags <= 0 || n_sites <= 0) return;
    if (n_threads < 2 || n_frags < (1 << 16)) {
        pileup_range(start, length, count, codes, 0, n_frags, max_len,
                     window_start, 0, n_sites, out);
        return;
    }
    std::vector<std::thread> ts;
    for (int t = 0; t < n_threads; t++) {
        int64_t site_lo = n_sites * t / n_threads;
        int64_t site_hi = n_sites * (t + 1) / n_threads;
        // fragments that can touch [site_lo, site_hi): start (1-based,
        // window-relative rel = start - window_start) in
        // [site_lo - max_len + 1, site_hi)
        int32_t lo_key = (int32_t)(site_lo - max_len + 1 + window_start);
        int32_t hi_key = (int32_t)(site_hi + window_start);
        const int32_t* b = std::lower_bound(start, start + n_frags, lo_key);
        const int32_t* e = std::lower_bound(start, start + n_frags, hi_key);
        int64_t f_lo = b - start, f_hi = e - start;
        ts.emplace_back(pileup_range, start, length, count, codes, f_lo,
                        f_hi, max_len, window_start, site_lo, site_hi, out);
    }
    for (auto& th : ts) th.join();
}

// ---------------------------------------------------------------------------
// Row packing for the v3 pileup kernel: pieces (each inside one 128-site
// sub-block) are bin-packed into shared kernel rows. Two pieces may share a
// row iff they have the same sub-block g, the same repeat count (the row
// count is a scalar multiplier in the kernel), and disjoint [rr, rr+len)
// site intervals — enforced exactly with a 128-bit occupancy mask per row
// (first-fit). Pieces must arrive grouped by ascending g (sorted pat order
// guarantees it); rows come out grouped by g in creation order.
// Returns n_rows (or -1 on bad input).
int64_t pack_rows128(const int32_t* g, const int32_t* count,
                     const int32_t* rr, const int32_t* len, int64_t n,
                     int32_t* piece_row, int32_t* row_g, int32_t* row_count) {
    struct Row {
        uint64_t m0, m1;
        int32_t idx;
    };
    // per-count open rows of the CURRENT g (counts are few distinct values;
    // linear scan over classes is fine)
    std::vector<int32_t> class_count;
    std::vector<std::vector<Row>> class_rows;
    int64_t n_rows = 0;
    int32_t cur_g = n ? g[0] : 0;
    for (int64_t i = 0; i < n; i++) {
        if (g[i] < cur_g) return -1;  // not grouped
        if (g[i] != cur_g) {
            class_count.clear();
            class_rows.clear();
            cur_g = g[i];
        }
        const int32_t r0 = rr[i], ln = len[i];
        if (r0 < 0 || ln <= 0 || r0 + ln > 128) return -1;
        uint64_t m0 = 0, m1 = 0;
        {
            // bits [r0, r0+ln) across the two 64-bit halves
            int lo = r0, hi = r0 + ln;
            if (lo < 64) {
                int h = hi < 64 ? hi : 64;
                m0 = (h - lo == 64) ? ~0ULL : (((1ULL << (h - lo)) - 1) << lo);
            }
            if (hi > 64) {
                int l2 = lo > 64 ? lo - 64 : 0;
                int h2 = hi - 64;
                m1 = (h2 - l2 == 64) ? ~0ULL
                                     : (((1ULL << (h2 - l2)) - 1) << l2);
            }
        }
        size_t cls = 0;
        for (; cls < class_count.size(); cls++)
            if (class_count[cls] == count[i]) break;
        if (cls == class_count.size()) {
            class_count.push_back(count[i]);
            class_rows.emplace_back();
        }
        auto& rows = class_rows[cls];
        int32_t target = -1;
        for (auto& r : rows) {
            if ((r.m0 & m0) == 0 && (r.m1 & m1) == 0) {
                r.m0 |= m0;
                r.m1 |= m1;
                target = r.idx;
                break;
            }
        }
        if (target < 0) {
            target = (int32_t)n_rows;
            rows.push_back({m0, m1, target});
            row_g[n_rows] = cur_g;
            row_count[n_rows] = count[i];
            n_rows++;
        }
        piece_row[i] = target;
    }
    return n_rows;
}

// Fused code placement + planar 2-bit packing for the v3 pileup staging.
// Replaces the numpy rowmat scatter + planar_pack_cols pass (the two
// dominant host-staging costs, ~1.1 s per 2M fragments): each packed
// piece's codes are written straight into the per-row planar words.
// Layout matches ops/pileup_tpu2.py::planar_pack_cols with w_cols = 8:
// in-sub-block position pos -> word column pos % 8, bit 2 * (pos / 8).
// words must be pre-filled with -1 (0b11 == '.' in every field).
int64_t place_pack_rows(const uint8_t* codes, int64_t W, int64_t P,
                        const int32_t* p_src, const int32_t* p_off,
                        const int32_t* p_rr, const int32_t* p_len,
                        const int32_t* piece_row, int32_t* words) {
    constexpr int64_t W_COLS = 8;
    for (int64_t p = 0; p < P; p++) {
        const uint8_t* src = codes + (int64_t)p_src[p] * W + p_off[p];
        int32_t* row = words + (int64_t)piece_row[p] * W_COLS;
        const int64_t rr = p_rr[p], len = p_len[p];
        if (rr < 0 || len < 0 || rr + len > 128) return -1;
        for (int64_t j = 0; j < len; j++) {
            const int64_t pos = rr + j;
            const uint32_t s = (uint32_t)(2 * (pos >> 3));
            int32_t* w = row + (pos & 7);
            // unsigned word arithmetic: 3 << 30 on a signed literal is UB
            // pre-C++20 (matches pack_rows128's mask handling)
            const uint32_t wu =
                ((uint32_t)*w & ~(3u << s)) | (((uint32_t)src[j] & 3u) << s);
            *w = (int32_t)wu;
        }
    }
    return P;
}

// Per-LANE repeat counts for the count-agnostic v3 row packing: write each
// piece's count (< 256) into the 8-bit field of its lanes, 4 lanes per
// int32 word (lane l -> word l%32, byte l/32 — mirroring the code layout's
// word l%8 / field l/8). words must be zero-initialized ((R, 32) int32).
int64_t place_counts_rows(const int32_t* p_cnt, const int32_t* p_rr,
                          const int32_t* p_len, const int32_t* piece_row,
                          int64_t P, int32_t* words) {
    constexpr int64_t W_COLS = 32;
    for (int64_t p = 0; p < P; p++) {
        int32_t* row = words + (int64_t)piece_row[p] * W_COLS;
        const int64_t rr = p_rr[p], len = p_len[p];
        if (rr < 0 || len < 0 || rr + len > 128) return -1;
        if (p_cnt[p] < 0 || p_cnt[p] > 255) return -1;
        const uint32_t c = (uint32_t)p_cnt[p];
        for (int64_t j = 0; j < len; j++) {
            const int64_t pos = rr + j;
            const uint32_t s = (uint32_t)(8 * (pos >> 5));
            int32_t* w = row + (pos & 31);
            const uint32_t wu = ((uint32_t)*w & ~(0xFFu << s)) | (c << s);
            *w = (int32_t)wu;
        }
    }
    return P;
}

// Pre-masked uint8 VALUE PLANES for the v3 value-plane staging: instead
// of packed 2-bit codes + packed 8-bit counts (which the kernel must
// unpack, compare and select every step), write the two dot operands the
// kernel actually needs, one byte per lane: mv[pos] = count if the code
// is a methylation call (C/H), cv[pos] = count if observed (not '.'),
// else 0. Planes are (R, 128) uint8, ZERO-initialized by the caller
// (zero == "no contribution", so padding needs no fill pass). Pieces
// within a row occupy disjoint [rr, rr+len) ranges (pack_rows128's
// first-fit invariant), so plain stores suffice. Counts must be < 256
// (the lane/vals forms are gated off above that; return -1 restores the
// classic path).
int64_t place_vals_rows(const uint8_t* codes, int64_t W, int64_t P,
                        const int32_t* p_src, const int32_t* p_off,
                        const int32_t* p_rr, const int32_t* p_len,
                        const int32_t* p_cnt, const int32_t* piece_row,
                        uint8_t* mv, uint8_t* cv) {
    for (int64_t p = 0; p < P; p++) {
        const uint8_t* src = codes + (int64_t)p_src[p] * W + p_off[p];
        const int64_t rr = p_rr[p], len = p_len[p];
        if (rr < 0 || len < 0 || rr + len > 128) return -1;
        if (p_cnt[p] < 0 || p_cnt[p] > 255) return -1;
        const uint8_t c = (uint8_t)p_cnt[p];
        uint8_t* mrow = mv + (int64_t)piece_row[p] * 128;
        uint8_t* crow = cv + (int64_t)piece_row[p] * 128;
        for (int64_t j = 0; j < len; j++) {
            const uint8_t code = src[j] & 3u;
            if (code == 3u) continue;  // '.' — unobserved, leave 0
            const int64_t pos = rr + j;
            crow[pos] = c;
            if (code != 0u) mrow[pos] = c;  // codes 1 (C) and 2 (H)
        }
    }
    return P;
}

// ---------------------------------------------------------------------------
// The v3 staging's prep in one pass (ops/pileup_v3.py::stage_v3): a slab's
// pat lines -> the pieces that pack_rows128 and the placers take. Lines over
// 128 sites split into 128-site units, units are clipped to the window, and
// each unit splits at its sub-block boundary into <= 2 pieces. A piece
// points into the caller's (F, W) codes (p_src = the line's row, p_off =
// the column of its first site), so no code row is copied.
//
// The pieces come out in the order of the JAX package's staging
// (pileup_tpu2.py::_split_long, pileup_tpu3.py::_prep_window and the
// stable argsort of stage_v3), so the staged arrays are the same bytes:
//   1. when some line is long: the lines of <= 128 sites in input order,
//      then the long lines' units in (line, offset) order, stable-sorted
//      by start; otherwise input order;
//   2. the window clip, which keeps that order (a unit that starts left of
//      the window loses its first sites; when any unit does, units of no
//      site are dropped too);
//   3. every unit's first piece, then the second pieces, stable-sorted by
//      sub-block g.
// Both sorts are stable and made of counting passes, so the work is linear
// in lines and pieces whatever order the lines come in.
// ---------------------------------------------------------------------------

struct PrepUnit {
    int64_t rel;  // start - window_start, before the clip
    int32_t src;  // row of the caller's codes
    int32_t off;  // column of the unit's first site in that row
    int32_t len;
};

// Stable LSD radix sort of units by rel, in passes of at most 16 bits.
static void prep_sort_by_rel(std::vector<PrepUnit>& u) {
    const size_t n = u.size();
    if (n < 2) return;
    int64_t lo = u[0].rel, hi = u[0].rel;
    bool sorted = true;
    for (size_t i = 1; i < n; i++) {
        sorted &= u[i - 1].rel <= u[i].rel;
        lo = std::min(lo, u[i].rel);
        hi = std::max(hi, u[i].rel);
    }
    if (sorted) return;
    const uint64_t span = (uint64_t)(hi - lo);
    int bits = 0;
    while (bits < 64 && (span >> bits)) bits++;
    const int passes = (bits + 15) / 16;
    const int digit = (bits + passes - 1) / passes;
    const uint64_t mask = (1ULL << digit) - 1;
    std::vector<PrepUnit> tmp(n);
    std::vector<int64_t> pos((size_t)1 << digit);
    for (int p = 0; p < passes; p++) {
        const int shift = p * digit;
        std::fill(pos.begin(), pos.end(), 0);
        for (const PrepUnit& x : u) pos[((uint64_t)(x.rel - lo) >> shift) & mask]++;
        int64_t acc = 0;
        for (int64_t& c : pos) {
            const int64_t k = c;
            c = acc;
            acc += k;
        }
        for (const PrepUnit& x : u)
            tmp[pos[((uint64_t)(x.rel - lo) >> shift) & mask]++] = x;
        u.swap(tmp);
    }
}

// start, length, count: the F lines; W: the codes' row width. The six
// int32 piece arrays hold `cap` entries. Step 3 runs on n_threads threads,
// each over a contiguous run of units; the pieces are the same for any
// number. *n_split = the units cut from lines of more than 128 sites
// (before the clip). Returns the number of pieces, or -1 on a negative
// length, a length above W, or more pieces than cap.
int64_t stage_prep_v3(const int32_t* start, const int32_t* length,
                      const int32_t* count, int64_t F, int64_t W,
                      int64_t window_start, int64_t window_len, int64_t cap,
                      int n_threads, int32_t* p_g, int32_t* p_rr,
                      int32_t* p_len, int32_t* p_cnt, int32_t* p_src,
                      int32_t* p_off, int64_t* n_split) {
    constexpr int64_t SB = 128;
    *n_split = 0;
    if (F < 0 || F > INT32_MAX || W < 0) return -1;
    int64_t n_long_units = 0;
    for (int64_t i = 0; i < F; i++) {
        const int64_t L = length[i];
        if (L < 0 || L > W) return -1;
        if (L > SB) n_long_units += (L + SB - 1) / SB;
    }
    *n_split = n_long_units;

    // 1. with a long line, the units kept by the clip ([rel, rel + len)
    // meets [0, window_len)) in their order: dropping the others before the
    // stable sort keeps the order of the rest. Without one, the units are
    // the lines.
    std::vector<PrepUnit> u;
    if (n_long_units) {
        for (int64_t i = 0; i < F; i++) {
            const int64_t L = length[i];
            const int64_t rel = start[i] - window_start;
            if (L <= SB && rel + L > 0 && rel < window_len)
                u.push_back({rel, (int32_t)i, 0, (int32_t)L});
        }
        for (int64_t i = 0; i < F; i++) {
            const int64_t L = length[i];
            if (L <= SB) continue;
            for (int64_t off = 0; off < L; off += SB) {
                const int64_t ln = std::min(SB, L - off);
                const int64_t rel = start[i] + off - window_start;
                if (rel + ln > 0 && rel < window_len)
                    u.push_back({rel, (int32_t)i, (int32_t)off, (int32_t)ln});
            }
        }
        prep_sort_by_rel(u);
    }
    const int64_t n_units = n_long_units ? (int64_t)u.size() : F;

    // 2. unit k after the clip of the window's left edge, which takes a
    // unit's sites left of the window; false for a unit the clip drops,
    // and for a unit of no site once the clip has shortened any unit
    struct Seen {
        bool clipped = false, empty = false;
    };
    bool drop_empty = false;
    auto unit = [&](int64_t k, PrepUnit& x, Seen& seen) {
        if (n_long_units) x = u[k];
        else x = {start[k] - window_start, (int32_t)k, 0, length[k]};
        if (x.rel + x.len <= 0 || x.rel >= window_len) return false;
        if (x.rel < 0) {
            seen.clipped = true;
            x.off -= (int32_t)x.rel;
            x.len += (int32_t)x.rel;
            x.rel = 0;
        }
        seen.empty |= x.len == 0;
        return !(drop_empty && x.len == 0);
    };

    // 3. pieces: a counting sort by sub-block g, first pieces before second
    // pieces, parts in order within each
    struct Part {
        // by sub-block: the part's first and second pieces, then where the
        // next of each goes
        std::vector<int64_t> first, second;
        Seen seen;
    };
    const int T = (int)std::max<int64_t>(1, std::min<int64_t>(n_threads,
                                                              n_units));
    std::vector<Part> parts(T);
    auto each_part = [&](const std::function<void(int)>& body) {
        std::vector<std::thread> ts;
        for (int t = 1; t < T; t++) ts.emplace_back(body, t);
        body(0);
        for (auto& th : ts) th.join();
    };
    auto histogram = [&](int t) {
        std::vector<int64_t> first, second;
        Seen seen;
        PrepUnit x;
        for (int64_t k = n_units * t / T; k < n_units * (t + 1) / T; k++) {
            if (!unit(k, x, seen)) continue;
            const size_t g = (size_t)(x.rel / SB);
            if (g + 2 > first.size()) {
                first.resize(std::max(g + 2, 2 * first.size()));
                second.resize(first.size());
            }
            first[g]++;
            if (x.len > SB - x.rel % SB) second[g + 1]++;
        }
        parts[t] = {std::move(first), std::move(second), seen};
    };
    each_part(histogram);
    Seen seen;
    for (const Part& q : parts) {
        seen.clipped |= q.seen.clipped;
        seen.empty |= q.seen.empty;
    }
    if (seen.clipped && seen.empty) {
        drop_empty = true;
        each_part(histogram);
    }
    size_t n_g = 0;
    for (const Part& q : parts) n_g = std::max(n_g, q.first.size());
    int64_t P = 0;
    for (Part& q : parts) {
        q.first.resize(n_g);
        q.second.resize(n_g);
    }
    for (size_t g = 0; g < n_g; g++) {
        for (Part& q : parts) {
            const int64_t c = q.first[g];
            q.first[g] = P;
            P += c;
        }
        for (Part& q : parts) {
            const int64_t c = q.second[g];
            q.second[g] = P;
            P += c;
        }
    }
    if (P > cap) return -1;
    each_part([&](int t) {
        // copies, so that no two threads write one cache line
        std::vector<int64_t> first = parts[t].first;
        std::vector<int64_t> second = parts[t].second;
        Seen seen;
        PrepUnit x;
        for (int64_t k = n_units * t / T; k < n_units * (t + 1) / T; k++) {
            if (!unit(k, x, seen)) continue;
            const int64_t g = x.rel / SB, rr = x.rel % SB;
            const int64_t len1 = std::min<int64_t>(x.len, SB - rr);
            int64_t j = first[g]++;
            p_g[j] = (int32_t)g;
            p_rr[j] = (int32_t)rr;
            p_len[j] = (int32_t)len1;
            p_cnt[j] = count[x.src];
            p_src[j] = x.src;
            p_off[j] = x.off;
            if (x.len == len1) continue;
            j = second[g + 1]++;
            p_g[j] = (int32_t)(g + 1);
            p_rr[j] = 0;
            p_len[j] = (int32_t)(x.len - len1);
            p_cnt[j] = count[x.src];
            p_src[j] = x.src;
            p_off[j] = (int32_t)(x.off + len1);
        }
    });
    return P;
}

// ---------------------------------------------------------------------------
// blocks bed scanning (formats/blocks.py::load_blocks)
// ---------------------------------------------------------------------------

// What bytes.strip() and int() strip.
static inline bool bed_white(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r' || c == 0x0b ||
           c == 0x0c;
}

// buf[s, e) as 1-18 plain digits into *v (such a value fits int64).
static inline bool bed_plain(const uint8_t* buf, int64_t s, int64_t e,
                             int64_t* v) {
    if (e <= s || e - s > 18) return false;
    int64_t x = 0;
    for (int64_t i = s; i < e; i++) {
        const unsigned d = (unsigned)buf[i] - '0';
        if (d > 9) return false;
        x = x * 10 + d;
    }
    *v = x;
    return true;
}

// One pass over a blocks bed by the rules of the line loop of
// wgbs_tools_tpu/formats/blocks.py::load_blocks: lines split on '\n'; an
// empty line or one that starts with '#' is skipped; at a line of fewer
// than 5 tab-separated columns the scan stops (*short_at = its offset; the
// caller raises); a line whose second column is not all digits (a header)
// is skipped; the scan stops after max_rows rows. Per row r: vals[4r ..
// 4r + 3] = start, end, startCpG, endCpG (the last two -1 for NA / NaN /
// nan / empty; columns 2-4 stripped of whitespace first); name[2r, 2r + 1]
// = the first column's bounds; line[2r, 2r + 1] = the line's; flags[r] bit
// 0 set where a column is not 1-18 plain digits (its value is then the
// caller's to convert), bit 1 where the name differs from the last row's.
// Returns the rows; the outputs hold max_rows (at most the lines) rows.
int64_t bed_scan(const uint8_t* buf, int64_t len, int64_t max_rows,
                 int64_t* vals, int64_t* name, int64_t* line, uint8_t* flags,
                 int64_t* short_at) {
    int64_t pos = 0, n = 0;
    *short_at = -1;
    while (pos < len && n < max_rows) {
        const uint8_t* nl =
            (const uint8_t*)memchr(buf + pos, '\n', (size_t)(len - pos));
        const int64_t ls = pos, le = nl ? nl - buf : len;
        pos = nl ? le + 1 : len;
        if (le == ls || buf[ls] == '#') continue;
        int64_t tab[5];
        int nt = 0;
        for (int64_t i = ls; i < le && nt < 5; i++)
            if (buf[i] == '\t') tab[nt++] = i;
        if (nt < 4) {
            *short_at = ls;
            break;
        }
        const int64_t cs[5] = {ls, tab[0] + 1, tab[1] + 1, tab[2] + 1,
                               tab[3] + 1};
        const int64_t ce[5] = {tab[0], tab[1], tab[2], tab[3],
                               nt == 5 ? tab[4] : le};
        bool header = ce[1] <= cs[1];
        for (int64_t i = cs[1]; i < ce[1] && !header; i++)
            header = (unsigned)buf[i] - '0' > 9;
        if (header) continue;
        int64_t* v = vals + 4 * n;
        bool odd = !bed_plain(buf, cs[1], ce[1], v);
        for (int k = 2; k <= 4; k++) {
            int64_t s = cs[k], e = ce[k];
            while (s < e && bed_white(buf[s])) s++;
            while (e > s && bed_white(buf[e - 1])) e--;
            const uint8_t* t = buf + s;
            const bool na =
                k >= 3 && (e == s || (e - s == 2 && t[0] == 'N' && t[1] == 'A') ||
                           (e - s == 3 && t[1] == 'a' &&
                            ((t[0] == 'N' && t[2] == 'N') ||
                             (t[0] == 'n' && t[2] == 'n'))));
            if (na)
                v[k - 1] = -1;
            else if (!bed_plain(buf, s, e, v + k - 1)) {
                v[k - 1] = 0;
                odd = true;
            }
        }
        bool fresh = n == 0;
        if (!fresh) {
            const int64_t w = ce[0] - cs[0], pw = name[2 * n - 1] - name[2 * n - 2];
            fresh = w != pw || memcmp(buf + cs[0], buf + name[2 * n - 2], (size_t)w);
        }
        name[2 * n] = cs[0];
        name[2 * n + 1] = ce[0];
        line[2 * n] = ls;
        line[2 * n + 1] = le;
        flags[n] = (uint8_t)(odd | (fresh << 1));
        n++;
    }
    return n;
}


// ---------------------------------------------------------------------------
// BAM record scan (columnar)
// ---------------------------------------------------------------------------

// Count records in a decompressed BAM buffer starting at `off` (first record).
int64_t bam_count(const uint8_t* buf, int64_t len, int64_t off) {
    int64_t n = 0;
    while (off + 4 <= len) {
        int32_t bs;
        memcpy(&bs, buf + off, 4);
        if (bs < 32 || off + 4 + bs > len) break;
        off += 4 + bs;
        n++;
    }
    return n;
}

// Fill columnar arrays for n records:
//   cols: int32 [n, 8] = ref_id, pos, flag, mapq, l_seq, n_cigar,
//                        first_cigar_word, block_end_offset_low32 (unused=0)
//   offs: int64 [n, 5] = qname_off, cigar_off, seq_off, qual_off, tags_off
//   (tags end at the next record's start - can be derived from offs[n+1])
// Returns number scanned.
int64_t bam_scan(const uint8_t* buf, int64_t len, int64_t off, int64_t n,
                 int32_t* cols, int64_t* offs, int64_t* rec_end) {
    int64_t i = 0;
    while (i < n && off + 4 <= len) {
        int32_t bs;
        memcpy(&bs, buf + off, 4);
        if (bs < 32 || off + 4 + bs > len) break;
        const uint8_t* p = buf + off + 4;
        int32_t ref_id, pos, l_seq;
        memcpy(&ref_id, p, 4);
        memcpy(&pos, p + 4, 4);
        uint8_t l_qname = p[8];
        uint8_t mapq = p[9];
        uint16_t n_cigar, flag;
        memcpy(&n_cigar, p + 12, 2);
        memcpy(&flag, p + 14, 2);
        memcpy(&l_seq, p + 16, 4);
        int64_t qname_off = off + 4 + 32;
        int64_t cigar_off = qname_off + l_qname;
        int64_t seq_off = cigar_off + 4LL * n_cigar;
        int64_t qual_off = seq_off + (l_seq + 1) / 2;
        int64_t tags_off = qual_off + l_seq;
        int32_t first_cigar = 0;
        if (n_cigar > 0) memcpy(&first_cigar, buf + cigar_off, 4);
        int32_t* c = cols + i * 8;
        c[0] = ref_id; c[1] = pos; c[2] = flag; c[3] = mapq;
        c[4] = l_seq; c[5] = n_cigar; c[6] = first_cigar; c[7] = l_qname;
        int64_t* o = offs + i * 5;
        o[0] = qname_off; o[1] = cigar_off; o[2] = seq_off; o[3] = qual_off;
        o[4] = tags_off;
        rec_end[i] = off + 4 + bs;
        off += 4 + bs;
        i++;
    }
    return i;
}

// Locate MM/Mm:Z and ML/Ml:B,C aux tags for n records (nanopore
// modification calls). Outputs per record:
//   mm_off/mm_len : byte bounds of the MM string value (excl. NUL), or -1
//                   when absent; mm_len = -9 when the aux region failed to
//                   parse (unknown tag type) so callers can fall back.
//   ml_off/ml_n   : offset / element count of the ML byte array, or -1;
//                   ml_n = -9 when ML exists with a non-byte subtype.
int64_t bam_mmml_scan(const uint8_t* buf, int64_t n,
                      const int64_t* tags_off, const int64_t* rec_end,
                      int64_t* mm_off, int64_t* mm_len,
                      int64_t* ml_off, int64_t* ml_n) {
    for (int64_t r = 0; r < n; r++) {
        mm_off[r] = -1; mm_len[r] = -1; ml_off[r] = -1; ml_n[r] = -1;
        int64_t i = tags_off[r], end = rec_end[r];
        while (i + 3 <= end) {
            uint8_t t0 = buf[i], t1 = buf[i + 1], typ = buf[i + 2];
            i += 3;
            int64_t sz;
            switch (typ) {
                case 'A': case 'c': case 'C': sz = 1; break;
                case 's': case 'S': sz = 2; break;
                case 'i': case 'I': case 'f': sz = 4; break;
                case 'Z': case 'H': {
                    int64_t j = i;
                    while (j < end && buf[j] != 0) j++;
                    if (t0 == 'M' && (t1 == 'M' || t1 == 'm')
                        && mm_off[r] < 0) {
                        mm_off[r] = i; mm_len[r] = j - i;
                    }
                    i = j + 1;
                    continue;
                }
                case 'B': {
                    if (i + 5 > end) { mm_len[r] = -9; i = end; continue; }
                    uint8_t sub = buf[i];
                    uint32_t cnt;
                    memcpy(&cnt, buf + i + 1, 4);
                    int64_t es =
                        (sub == 'c' || sub == 'C') ? 1 :
                        (sub == 's' || sub == 'S') ? 2 :
                        (sub == 'i' || sub == 'I' || sub == 'f') ? 4 : -1;
                    if (es < 0) { mm_len[r] = -9; i = end; continue; }
                    if (i + 5 + es * (int64_t)cnt > end) {
                        // truncated B-array: reject the record rather than
                        // letting ml_off/ml_n point past its end
                        mm_len[r] = -9; ml_n[r] = -9; i = end; continue;
                    }
                    if (t0 == 'M' && (t1 == 'L' || t1 == 'l')
                        && ml_off[r] < 0) {
                        if (es == 1) {
                            ml_off[r] = i + 5; ml_n[r] = (int64_t)cnt;
                        } else {
                            ml_n[r] = -9;
                        }
                    }
                    i += 5 + es * (int64_t)cnt;
                    continue;
                }
                default:
                    mm_len[r] = -9;  // unknown type: record unparseable
                    i = end;
                    continue;
            }
            i += sz;
        }
    }
    return n;
}

// Pass 1 over MM strings: per record, count "C+" sections and their total
// skip integers (commas). Records with mm_off < 0 yield zeros.
int64_t mm_count(const uint8_t* buf, int64_t n, const int64_t* mm_off,
                 const int64_t* mm_len, int64_t* n_sec, int64_t* n_skip) {
    for (int64_t r = 0; r < n; r++) {
        n_sec[r] = 0; n_skip[r] = 0;
        if (mm_off[r] < 0 || mm_len[r] < 0) continue;
        const uint8_t* s = buf + mm_off[r];
        int64_t len = mm_len[r];
        int64_t i = 0;
        while (i < len) {
            int64_t j = i;
            while (j < len && s[j] != ';') j++;
            if (j - i >= 3 && s[i] == 'C' && s[i + 1] == '+') {
                n_sec[r]++;
                for (int64_t k = i; k < j; k++)
                    if (s[k] == ',') n_skip[r]++;
            }
            i = j + 1;
        }
    }
    return 0;
}

// Pass 2: fill per-section metadata + flat skip ints, in record order.
// Semantics mirror the Python reference parser (pipeline/nanopore.py
// parse_mm_sections, itself after ref ont.cpp:310-416): a section is any
// non-empty ';'-part; C+ sections record mod char (4th byte), the
// dot-convention flag (header longer than 3 chars with a '?' 4th char
// disables it), and the part index among ALL non-empty parts (used for ML
// block slicing).
int64_t mm_fill(const uint8_t* buf, int64_t n, const int64_t* mm_off,
                const int64_t* mm_len,
                int32_t* sec_rec, int8_t* sec_mod, int8_t* sec_npdot,
                int32_t* sec_part_idx, int64_t* sec_nskip, int32_t* skips) {
    int64_t S = 0, K = 0;
    for (int64_t r = 0; r < n; r++) {
        if (mm_off[r] < 0 || mm_len[r] < 0) continue;
        const uint8_t* s = buf + mm_off[r];
        int64_t len = mm_len[r];
        int64_t i = 0;
        int32_t part = 0;
        while (i < len) {
            int64_t j = i;
            while (j < len && s[j] != ';') j++;
            if (j == i) { i = j + 1; continue; }  // empty part: uncounted
            if (j - i >= 3 && s[i] == 'C' && s[i + 1] == '+') {
                int64_t h = i;
                while (h < j && s[h] != ',') h++;
                sec_rec[S] = (int32_t)r;
                sec_mod[S] = (int8_t)s[i + 2];
                sec_npdot[S] = (h - i > 3 && s[i + 3] == '?') ? 0 : 1;
                sec_part_idx[S] = part;
                int64_t ns = 0;
                int64_t k = h;
                while (k < j) {
                    k++;  // step over the comma
                    int32_t v = 0;
                    int neg = 0;
                    if (k < j && s[k] == '-') { neg = 1; k++; }
                    while (k < j && s[k] >= '0' && s[k] <= '9') {
                        v = v * 10 + (s[k] - '0');
                        k++;
                    }
                    skips[K++] = neg ? -v : v;
                    ns++;
                    // skip any trailing junk up to the next comma so the
                    // number of entries written always equals mm_count's
                    // comma count (a stray non-digit char must not mint an
                    // extra entry — that would overflow the skips buffer)
                    while (k < j && s[k] != ',') k++;
                }
                sec_nskip[S] = ns;
                S++;
            }
            part++;
            i = j + 1;
        }
    }
    return S;
}

}  // extern "C"
