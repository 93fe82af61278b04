#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (wgbs_tools_tpu_torch) on one GPU.

    python3 chip_smoke.py [--frags N]

Phases, each printed as it runs; any failure exits nonzero and prints no
result line:
  1. the card: `nvidia-smi` name and power limit; fails without CUDA.
  2. build: nvcc compiles the ten sources csrc/*.cu for sm_90a, in
     parallel (seconds and ptxas register counts printed), and g++ the
     port's host library (host/wgbsio.cpp and host/segment_exact.cpp) that
     decoding, staging, exact segmentation and the oracle run; both must
     load.
  3. data, then kernels vs twins: a 20M-fragment pat.gz (<= 24 sites each)
     over hg19's 28,217,448 CpG sites and a small pat with counts up to
     3000 are written. Each of the 8 CUDA kernels is held against its plain
     PyTorch twin on the card on the batches its paths give it: the first
     streamed slab of a pat, staged as PileupAccumulator.add stages it for
     that path at the default geometry -- the big pat's for the value-
     plane kernels (fused and split planes) and for flat_lc (vals=False),
     the deep pat's for flat_classic, both pats' for tiled_classic
     (lane_counts=False), tiles_v2 (stage_v2) and tiles_v1 (v1's prep),
     and for tiles_v1 also a long slab made from a seed (long_slab: 300,000
     fragments of median 150 sites, up to 2048, over 8,000,000 sites, ~10x
     deep: max_len 2048, the warp-per-row form; an unverified stand-in for
     long reads);
     then on each slab with the middle third of its span emptied, so the
     window has empty tiles, where zeros must come back. flat_vals_add, in
     both plane forms, starts from a seeded nonzero total, and the rows of
     the empty tiles must come back unchanged. Then the value-plane kernels
     on hand-made edge cases (VALS_EDGE: shuffled rows, padding between
     rows, a padding-only chunk, 5 chunks in a tile, every byte 255, a
     ragged window, rows outside their tile; the add into a fresh and an
     8-byte-aligned total), and the code-word kernels on theirs (CODE_EDGE,
     in both rc classes: shuffled rows, padding between rows, padding-only
     chunks, a tile of many chunks, rows outside their tile, a ragged
     window, every count at its form's most), and tiles_v2 on its
     (FRAG_EDGE: fragments that start or end on tile edges, empty tiles
     with crossers, a tile of 6 chunks with crossers in each, padding rows
     and base_g rows with counts, w_cols 2 / 4 / 8, a ragged window, counts
     of 3000 ~900 deep, shuffled rows), and tiles_v1 on its (FRAG_EDGE_V1:
     rows of up to 4096 sites spanning whole tiles, tiles covered only by
     rows from far back, rows on tile edges, w16 16 / 24 / 40 / 128 / 192 /
     256, a mixed batch of short rows and one long one, padding rows with
     counts and words, negative starts, a ragged window, counts of 3000
     ~900 deep, shuffled rows). Exactly equal (tolerance 0,
     the counts are integers); kernel and twin times (CUDA events) on the
     unaltered slabs: the kernel's on the card (_device_ms: its launches
     queued behind a spinning kernel, so no host time between them; the
     code-word kernels also per rc-class launch) and per call with the
     host's (_time_ms, the wrapper's checks and launch included),
     beside each kernel's bound (the bytes it must move over 3.35 TB/s, or
     its adds over 67 T/s, whichever is longer: _work) and, for the
     value-plane kernels, the time of one index_add_ of the same rows
     (library_ms); no launch may change the current CUDA device.
  4. pat2beta end to end: both pats go through the port's CLI on cuda,
     with the kernels' launch counters set to 0 just before and read just
     after; each .beta / .lbeta must equal the host oracle's bytes (the
     port's "native" backend: its own native.pileup_native, then
     formats.beta.trim_to_uint). A second, timed run prints seconds per stage.
  5. sharded: pat2beta over 4 site shards on the one card
     (devices=shard_devices("cuda", n_shards=4)) writes phase 4's oracle
     bytes for both pats (flat_vals_add and flat_classic must launch);
     then the big pat's first slab through the sharded and the
     single-device accumulator with split planes (flat_vals_add's split
     form, and flat_vals) equals the sharded default.
  6. processes: `python -m wgbs_tools_tpu_torch pat2beta big.pat.gz
     --procs 2`, both workers on cuda:0, writes the oracle bytes, and each
     worker's launch line shows flat_vals_add; the same CLI in one process
     runs beside it for the wall.
  7. the other pileup forms: pat2beta of both pats (.beta, and .lbeta of
     the deep one) on one device through vals=False (flat_lc),
     grid="tiled" (tiled_classic), backend="cuda_v2" (tiles_v2) and
     backend="cuda_v1" (tiles_v1) writes phase 4's oracle bytes, each with
     its kernel's launch counter >= 1, and the wall of each configuration.
  8. segment at hg19 size (bench_segment4.py's shape): 3 betas over
     28,217,448 sites made from a seed (Poisson(10) coverage each, 300-site
     blocks of methylation 0.15 / 0.85) on a genome of that many sites with
     loci cumsum(integers(5, 60)) + 100, and the CLI defaults (max_cpg
     1000, max_bp 2000, 60,000-site chunks: 471). `segment --mode exact
     --device cpu` through the CLI on the host cores, then `segment --mode
     fast --device cuda` with the launch counters set to 0 just before and read just
     after (maxplus_closure must launch): both walls, the fast run's stage
     seconds, each bed checked to tile [1, N + 1), and the share of exact
     borders that fast mode finds (fails under 0.95). maxplus_closure is
     held to its twin with tolerance 0 on the main path's batch (8 real
     chunks: 3,752 matrices of 129 x 129) and on hand-made edges (all -inf
     off the diagonal; W 64 < B; a ragged last block; MAXPLUS_EDGE: banded
     upper triangular matrices with holes at n 1 / 2 / 31 / 33 / 64 / 65 /
     128 / 129 / 144, one launch mixing them with a matrix that has one
     finite entry below the diagonal, 0 and 1 squarings); the batch must
     be -inf below the diagonal (so its launch takes the upper schedule),
     and it is timed beside its bound (pairs x 2 instructions over 132 SMs
     x 128 FP32 lanes x clocks.max.sm; pairs: the (p, r, q) whose two
     terms are finite on this run's data, per squaring), with the triples
     the upper schedule evaluates (at most 1.3x the triangle's) and the
     kernel's registers; the fast DP's T on the card equals the CPU's
     (the twin's closures) on one real chunk fed the same cost tensor.
     Exact mode on the card: `segment` with its defaults (--mode exact,
     --device cuda) through the CLI, counters set to 0 just before and read
     just after (segment_exact_dp must launch, no window may go to the
     host), its stage seconds, and its bed byte-identical to the host
     run's. segment_exact_dp (csrc/segment_exact.cu) is held to its twin
     with tolerance 0 on two main-path windows cut to 8,192 sites (the
     twin timed there, and the kernel beside it), on the same prefix sums
     shifted across 2^31 (ks unchanged), and on hand-made edges (ties from
     1,000 sites of zero coverage, K 1, K 8, W 48, max_bp 0 with W 1000,
     max_bp 0 with Wb 1,227 and 1,228 on either side of the threshold
     between the kernel's ahead and single bodies, the ragged last
     window; both bodies must be among them);
     its T equals the host DP's on 16 main-path chunks (the ragged last
     among them) and, through segment_exact_device_T, on a 32,768-site
     window with max_bp 0 and W 30,000 (the ring in global memory). It is
     timed on the main path's batch (the 470 full chunks in one launch, as
     the CLI launches them) beside its bound: the larger of the valid band
     cells x K float64 adds over 132 SMs x 64 FP64 lanes x clocks.max.sm
     and the bytes (prefix sums, loci, table, ks) over 3.35 TB/s; with the
     table lookups the batch makes (ok cells with nt > 0, per dataset) and
     their rate, the chain's ns per step there and on the cut windows, the
     body the launch takes, its registers and spills per body (ptxas), and
     its CTAs per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor, which
     must put the batch in one wave).
     Phase 8 also keeps its fast run's borders of the 470 full chunks.
  9. the parallel layer at hg19 size. The analysis step
     (parallel/sharded.py::AnalysisStep) on a (2 samples, 2 sites) mesh of
     4 stand-in devices on the card: the big pat's 20M fragments through
     bucket_fragments, 4 samples from phase 8's generator, seed and loci,
     W 64, halo 32, max_bp 2000, pc 15, the counters set to 0 just before
     and read just after (tiles_v1 and dp_scan must launch); its counts
     equal native.pileup_native's of the same fragments, decode_sum64 of
     its coverage pair equals the int64 sum, its peak device memory stays
     under 60 GB, and dp_scan's C entry must name its push body for the
     step's chains; its two chains' cost is built again and dp_scan
     (csrc/dp_scan.cu) timed on it with CUDA events (its ks equal the
     step's), each chain's first 1,000,000 ks equal scan_numpy (the DP in
     numpy on the host) bit for bit, the share _dp_fast_blocked agrees on
     is printed (it sums a path's costs in another order, so near-ties
     move), dp_scan equals its twin on two windows cut to 8,192 sites and,
     with tolerance 0, on dp_edge_batch (edges of ties, -inf rows, NaN,
     signed zeros, +inf in the first W steps, the oldest and newest
     candidates tied, n < W, nb 1 and 3, W 1-3, 31-33, 63-65 and both
     sides of each body's threshold, which dp_plan gives), which must hold
     every body; its time stands beside its bound (the larger of the chain
     floor, 8 cycles a step over clocks.max.sm, and the bytes over 3.35
     TB/s) with its ns per step, share of the chain floor, and registers
     and spills per body (ptxas). Then
     segment_windows_sharded on phase 8's 470 chunks over 4 stand-in
     shards (maxplus_closure must launch) equals phase 8's fast borders
     window for window; `segment --procs 2` through the CLI (both ranks on
     cuda:0), exact and fast, writes phase 8's one-process beds, each
     worker's launch line showing segment_exact_dp / maxplus_closure;
     flagship.entry() on the card (merged equals the host pileup plus the
     samples) and flagship.dryrun_multichip(4), each with its line.
 10. the block and read-level device ops at hg19 size, each command
     through the port's CLI on cuda with the launch counters set to 0 just
     before and read just after (its kernel must launch) and its stage
     seconds: beta_to_blocks of phase 4's big.beta and phase 8's three
     betas over phase 8's exact blocks (1,070,393), once more with
     --lbeta, and over a non-nice copy of the blocks (every 10th block
     duplicated and shifted into its neighbour), every .bin / .lbeta
     equal to a numpy int64 prefix-sum oracle's bytes (block_sums);
     reduce_data_to_blocks over 4 stand-in shards equal to one device's;
     beta_to_table of phase 8's betas with a groups file equal to
     --device cpu's text; pat2pairs of the big pat (pair_counts), its
     table equal to the twin's on the card over the whole pat and to
     numpy's bincount on the first generated slab's sites, with the
     device's peak memory; homog of the big pat over the blocks as text
     and --binary, each equal to --device cpu's bytes (homog_bins). Each
     kernel is held to its twin at tolerance 0 on its main-path launch and
     on hand-made edges (BLOCK_EDGE: a whole-genome block at coverage 255
     past 2^31, NA blocks, s == e, blocks clipped past N, uint16 data;
     pair_edge_batch: H and '.', start_rel < 0, the last site, length 1,
     counts to 3000; HOMOG_EDGE: exact ties on the edges, meth 0 and 1,
     inclusive, min_cpgs 1 / 3 / 4, reads over many blocks, and the
     shapes hot_block, wide_span, permuted_pairs, long_rows, big_counts,
     hundred and mask_rows, each with the kernel's chunk stats), and timed
     with CUDA events on its main-path launch beside its bound (bytes
     over 3.35 TB/s; pair_counts with its atomics; homog_bins the same
     counts on two runs, with its global atomics against the (chunk,
     cell) pairs its passing pairs touch, and the same counts and its
     time on rows of 25, 41 and 72 calls, HOMOG_ROW_FORMS) and its twin's
     time (block_sums also beside one index_add_ of the rows by block
     id).
 11. bam2pat at chromosome scale: a genome of 2 x 60,000,000 bp at about
     hg19's CpG density (~1 a 100 bp; methylation in 300-site blocks of
     0.15 / 0.85) and two coordinate-sorted BGZF BAMs made here from a
     seed with vectorized numpy records (the port's bgzf_compress_native;
     tests/bisim.py imports the JAX package): 4,000,000 pairs of 2 x 150
     bp (~10x; ~2.3 GB of records, so the default route streams) and
     2,000,000 single-end reads, ~1 % of the reads with a complex CIGAR
     (soft clip, insertion, deletion), ~0.5 % MAPQ 5, ~0.5 % duplicates,
     ~0.2 % of the pairs without a mate. bam2pat through the port's CLI on
     cuda, with the launch counters set to 0 just before and read just
     after: the default route (streamed), --no_stream and the single-end
     BAM; call_reads, merge_pe (paired-end) and flat_vals_fused must
     launch; the single-end run's pat.gz and .csi equal --device cpu's
     bytes and its .cdx arrays, its beta --device cpu's; each beta equals
     native.pileup_native + trim_to_uint of its pat, and the streamed pat
     inflates to the --no_stream pat's text (so neither PE run has a
     --device cpu run of its own: their calling kernels are held to their
     twins launch by launch below); stage seconds (scan, decode, call with
     its h2d / kernel / d2h, merge, write, pat2beta) of each.
     call_reads and merge_pe (csrc/calling.cu) on every launch the
     streamed and the --no_stream runs on cuda made (their batches kept by
     wrapping call_reads_device and merge_mates, split as the wrappers
     split them; as many launches as the streamed run's counters) equal
     their twins on the card at tolerance 0, each streamed batch numpy's
     call_reads_mat / merge_pe_mat, and so do CALL_EDGE / MERGE_EDGE; each
     launch timed (_device_ms, _time_ms) beside its bound (the bytes it
     must move over 3.35 TB/s: each row's packed calls up to its span, not
     the '.' padding past it) and its twin, with numpy's time and the h2d
     of the sequence matrices; call_reads also on chr1's whole-file batch
     in one launch; merge_pe_device on MERGE_EDGE from two host threads at
     once (launches of different shared memory meeting, as the whole-file
     run's chromosome threads make them), each result the one-thread
     run's.
 12. the commands users run after bam2pat and pat2beta, through the
     port's CLI on phase 11's files: bam2pat --procs 2 on the PE BAM with a
     .bai written here (_write_bai), both workers on cuda:0, each decoding
     its own byte range and launching call_reads and merge_pe (their
     launch lines), its pat inflating to the one-process streamed pat's
     text, its beta the same bytes, and region reads through its rebuilt
     .cdx and .csi (_csi_lines) equal to the one-process file's, timed
     from process start; add_cpg_counts (under bam2pat's filters) on a
     BAM of COUNT_PAIRS pairs from phase 11's generator, its YI totals
     beside the C / T totals of that BAM's pat (they differ by the calls
     the two reference binaries make differently: within 5 %), and
     split_by_meth of its output (M + U + dropped == its records, each
     side as the YI tags say); split_by_allele on a BAM of SMALL_PAIRS
     pairs at chr1's best-covered CpG on cuda, each part's pat, index and
     beta equal to bam2pat --device cpu's (call_reads must launch);
     find_markers over phase 10's exact blocks and four betas made here
     (two groups of two, _marker_betas) on cuda and --device cpu, the same
     Markers.*.bed and params.txt bytes (block_sums must launch), the
     markers a group printed; test_bimodal on MARKER_REGIONS regions of
     the PE pat; view (the whole SE pat prints its own text), cview
     --strict (rows inside the region), index of an unindexed copy (its
     region reads equal the original's), merge (the counts add up),
     mask_pat --beta and mix_pat on cuda (their betas == the host pileup
     of the masked pat and of the SE pat; flat_vals_fused must launch) and
     frag_len (the histogram counts every read); each command's wall.
 13. the last commands of the CLI, on the files of phases 4-11:
     init_genome of phase 11's genome written as a FASTA of 100-bp lines
     (its CpG index equal to the one phase 11 wrote by hand, its
     CpG.chrome.size the per-chromosome counts), set_default_ref back to
     the earlier default; on phase 4's big.beta and phase 8's betas over
     phase 10's exact blocks: beta2bed -L, beta2bw -L and beta_stats -L
     of the first P13_BED_BLOCKS blocks (the beta's rows, read_bigwig its
     values, numpy's figures), beta_cov -L over all the blocks on cuda
     (block_sums must launch) equal to --device cpu's text, lbeta2beta of
     phase 10's block lbeta (trim_to_uint), compare_betas (numpy's
     pearson and rmse), beta_to_450k over an Illumina map of P13_ILMN_IDS
     ids made from a seed (numpy's gather), convert -L of
     P13_CONVERT_BLOCKS blocks (its CpG columns equal to the bed's);
     bed2beta --add_one of beta2bed -r's bed of phase 11's SE beta over
     P13_BED2BETA_BP of chr2 (the beta there, 0 elsewhere; bed2beta and
     convert search a chromosome's loci once a line, ~75 ms over
     hg19seg's one chromosome); vis --text of a region of the big pat
     (each column's letters equal to the oracle beta) and vis of two betas
     (numpy's digits); `worker serve --warm` on cuda, then pat2beta of
     phase 11's SE pat timed from process start in its own process and
     twice through `worker run`, each beta phase 11's bytes, the server's
     launch lines showing flat_vals_fused after the warm-up and each
     job, and `worker stop` (the server starts with the phase, so its
     start and warm-up run beside the other commands); each command's
     wall. No figure mode runs: the card's machine has no matplotlib.
Then a summary (the card line again, build, end to end), a line of the
smoke's total seconds and each phase's, one {"kernels": [...]} line (the
8 pileup kernels, maxplus_closure, segment_exact_dp, dp_scan,
block_sums, pair_counts, homog_bins, call_reads and merge_pe), and last
{"ok": true, "device": ...}.

Scratch data goes to build/ (ignored by git) and is deleted at the end.
"""

import argparse
import contextlib
import importlib
import json
import os
import os.path as op
import re
import shutil
import signal
import struct
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

N_SITES = 28_217_448  # hg19 CpG sites
MAX_LEN = 24
SLAB = 2_000_000      # fragments generated per slab
_CSRC = "wgbs_tools_tpu_torch/csrc/"
_TPU3 = "wgbs_tools_tpu/ops/pileup_tpu3.py:"
# kernel wrapper -> (module of wgbs_tools_tpu_torch.ops, CUDA source, the
# TPU kernel it replaces)
KERNELS = {
    "flat_vals_fused": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "457"),
    "flat_classic": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "177"),
    "flat_vals": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "391"),
    "flat_vals_add": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "569"),
    "flat_lc": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "314"),
    "tiled_classic": ("pileup_v3", _CSRC + "pileup_v3.cu", _TPU3 + "115"),
    "tiles_v2": ("pileup_v2", _CSRC + "pileup_v2.cu",
                 "wgbs_tools_tpu/ops/pileup_tpu2.py:62"),
    "tiles_v1": ("pileup_v1", _CSRC + "pileup_v1.cu",
                 "wgbs_tools_tpu/ops/pileup_tpu.py:54"),
    # not Pallas kernels: the XLA max-plus closure of fast segmentation,
    # exact segmentation's cost and ring DP (_exact_batch_ring_raw)
    "maxplus_closure": ("maxplus", _CSRC + "maxplus.cu",
                        "wgbs_tools_tpu/models/segment.py:313"),
    "segment_exact_dp": ("segment_exact", _CSRC + "segment_exact.cu",
                         "wgbs_tools_tpu/models/segment_exact_tpu.py:349"),
    # and the analysis step's serial DP (a lax.scan)
    "dp_scan": ("dp_scan", _CSRC + "dp_scan.cu",
                "wgbs_tools_tpu/parallel/sharded.py:105"),
    # the block and read-level device ops: JAX's segment_sum of the block
    # sums, the pair counts' scatter-add and homog's binning
    "block_sums": ("reduceat", _CSRC + "reduceat.cu",
                   "wgbs_tools_tpu/ops/reduceat.py:17"),
    "pair_counts": ("pairs", _CSRC + "pairs.cu",
                    "wgbs_tools_tpu/ops/pairs.py:57"),
    "homog_bins": ("frag_ops", _CSRC + "homog.cu",
                   "wgbs_tools_tpu/ops/frag_ops.py:204"),
    # bam2pat's jitted calling and mate merging
    "call_reads": ("calling", _CSRC + "calling.cu",
                   "wgbs_tools_tpu/ops/calling_tpu.py:59"),
    "merge_pe": ("calling", _CSRC + "calling.cu",
                 "wgbs_tools_tpu/ops/calling_tpu.py:113"),
}
# kernel -> its wrapper's name where the two differ (ops/pairs.py's
# pair_counts is the one-shot count, pair_counts_add the kernel's wrapper)
WRAPPERS = {"pair_counts": "pair_counts_add"}
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")


def log(msg):
    print(f"[chip_smoke] {msg}", flush=True)


# ---------------------------------------------------------------------------
# synthetic data: fragments as bench_e2e.py::make_pat draws them, written as
# BGZF pat.gz text here (numpy + zlib) without the JAX package's writer
# ---------------------------------------------------------------------------


def make_slab(rng, n, lo, hi, max_count):
    import numpy as np

    starts = np.sort(rng.integers(lo, max(hi, lo + 1), size=n)).astype(
        np.int32)
    lengths = rng.integers(1, MAX_LEN + 1, size=n).astype(np.int32)
    counts = rng.integers(1, max_count + 1, size=n).astype(np.int32)
    codes = np.where(rng.random((n, MAX_LEN)) < 0.7, 1, 0).astype(np.uint8)
    codes[rng.random((n, MAX_LEN)) < 0.02] = 3
    codes[np.arange(MAX_LEN)[None, :] >= lengths[:, None]] = 3
    return starts, lengths, counts, codes


def _digits(x, width):
    """Decimal digits of x, right-aligned in `width` columns, with the mask
    of the significant ones."""
    import numpy as np

    x = x.astype(np.int64)
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = ((x[:, None] // pw) % 10 + ord("0")).astype(np.uint8)
    nd = 1 + (x[:, None] >= pw[None, :-1]).sum(axis=1)
    return digits, np.arange(width)[None, :] >= (width - nd)[:, None]


def pat_text(starts, lengths, counts, codes):
    """pat lines `chr1<TAB>start<TAB>pattern<TAB>count`."""
    import numpy as np

    n = starts.shape[0]

    def const(s):
        a = np.frombuffer(s, np.uint8)
        return np.broadcast_to(a, (n, a.size)), np.ones((n, a.size), bool)

    pattern = np.frombuffer(b"TCH.", np.uint8)[codes]
    cols = [const(b"chr1\t"), _digits(starts, 10), const(b"\t"),
            (pattern, np.arange(MAX_LEN)[None, :] < lengths[:, None]),
            const(b"\t"), _digits(counts, 5), const(b"\n")]
    buf = np.concatenate([c[0] for c in cols], axis=1)
    keep = np.concatenate([c[1] for c in cols], axis=1)
    return buf[keep].tobytes()


def _bgzf_block(data):
    comp = zlib.compressobj(6, zlib.DEFLATED, -15)
    body = comp.compress(data) + comp.flush()
    bsize = 18 + len(body) + 8
    if bsize > 65536:
        raise RuntimeError("BGZF block too large")
    head = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", bsize - 1))
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def write_pat_gz(path, n_frags, seed, site_lo, site_hi, max_count, pool):
    """Sorted pat.gz of n_frags fragments over [site_lo, site_hi), written
    slab by slab (disjoint site ranges, so the file is sorted)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_slabs = (n_frags + SLAB - 1) // SLAB
    span = site_hi - MAX_LEN - site_lo
    with open(path, "wb") as f:
        done = 0
        for i in range(n_slabs):
            n = min(SLAB, n_frags - done)
            lo = site_lo + span * i // n_slabs
            hi = site_lo + span * (i + 1) // n_slabs
            text = pat_text(*make_slab(rng, n, lo, hi, max_count))
            blocks = [text[j : j + 65280] for j in range(0, len(text), 65280)]
            for blk in pool.map(_bgzf_block, blocks):
                f.write(blk)
            done += n
        f.write(BGZF_EOF)


def write_cpg_index(refs, name, chroms, loci, sizes):
    """The reference dir refs/name: the CpG index of the chromosomes
    `chroms` with their int32 loci and sizes (the layout of
    wgbs_tools_tpu/genome/cpg_index.py)."""
    import numpy as np

    gdir = op.join(refs, name)
    os.makedirs(gdir)
    counts = [len(x) for x in loci]
    np.savez(op.join(gdir, "cpg_index.npz"),
             loci=np.concatenate(loci).astype(np.int32),
             chrom_offsets=np.concatenate([[0], np.cumsum(counts)]).astype(
                 np.int64), chrom_sizes=np.array(sizes, np.int64))
    with open(op.join(gdir, "cpg_index.json"), "w") as f:
        json.dump({"name": name, "chroms": list(chroms),
                   "nr_sites": sum(counts)}, f)


def write_genome(refs, n_sites):
    """A one-chromosome reference dir with n_sites CpG sites, set as the
    default genome."""
    import numpy as np

    loci = np.arange(n_sites, dtype=np.int64) * 70 + 10
    write_cpg_index(refs, "hg19sites", ["chr1"], [loci], [loci[-1] + 100])
    os.symlink("hg19sites", op.join(refs, "default"))


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    log(f"phase 1: torch {torch.__version__} (CUDA {torch.version.cuda}), "
        f"{torch.cuda.device_count()} device(s), using "
        f"{torch.cuda.get_device_name(0)}")
    return smi


# kernel function -> kernel name (segment_exact_dp has two bodies)
FUNCTIONS = {**{name + "_kernel": name for name in KERNELS},
             "segment_exact_dp_ahead_kernel": "segment_exact_dp",
             "dp_scan_push_kernel": "dp_scan",
             "dp_scan_argmax_kernel": "dp_scan",
             "block_runs_kernel": "block_sums",
             "block_pieces_kernel": "block_sums",
             "call_reads_tiles_kernel": "call_reads"}
# segment_exact_dp's kernel functions -> its bodies
SEGX_BODIES = {"segment_exact_dp_ahead_kernel": "ahead",
               "segment_exact_dp_kernel": "single"}
# dp_scan's kernel functions -> its bodies (the push body's second kernel
# apart)
DPS_BODIES = {"dp_scan_push_kernel": "push",
              "dp_scan_argmax_kernel": "push argmax",
              "dp_scan_kernel": "warp"}
# block_sums' kernel functions -> its launches (and the earlier single
# warp-a-block kernel's name, for an older tree's build log)
BLK_BODIES = {"block_runs_kernel": "runs", "block_pieces_kernel": "pieces",
              "block_sums_kernel": "warp a block"}
# calling.cu's kernel functions -> their bodies (merge_pe's by its
# template's STAGED; an older tree's single bodies as their kernel's name)
CALLING_BODIES = {"call_reads_tiles_kernel": "call_reads tiles",
                  "call_reads_long_kernel": "call_reads long",
                  "call_reads_kernel": "call_reads (a warp a read)",
                  "merge_pe_kernelILb1E": "merge_pe staged",
                  "merge_pe_kernelILb0E": "merge_pe gather",
                  "merge_pe_kernel": "merge_pe (a warp a pair)"}


def _ptxas_registers(build_log, functions=None):
    """({kernel name: registers per thread}, {kernel name: spill bytes})
    from nvcc's `-Xptxas -v` log; a kernel built in several template
    instances (w_cols, plane form) or bodies reports the most any of them
    uses. `functions` maps a kernel function's name to the name it is
    reported under (default FUNCTIONS)."""
    regs, spills, entry = {}, {}, None
    functions = FUNCTIONS if functions is None else functions
    with open(build_log) as f:
        for line in f:
            if "Compiling entry function" in line:
                entry = next((name for fn, name in functions.items()
                              if fn in line), None)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m and entry is not None:
                spills[entry] = max(spills.get(entry, 0), int(m.group(1))
                                    + int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry is not None:
                regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
    return regs, spills


def phase_build():
    from wgbs_tools_tpu_torch import _kernels, native

    t0 = time.perf_counter()
    _kernels.build(force=True)
    _kernels.load()
    build_s = time.perf_counter() - t0
    regs, spills = _ptxas_registers(_kernels.BUILD_LOG)
    log(f"phase 2: nvcc built {', '.join(map(op.basename, _kernels.sources()))}"
        f" for sm_90a in {build_s:.3f} s; ptxas registers {regs}, spill "
        f"bytes {spills}")
    t0 = time.perf_counter()
    native.build(force=True)
    native.get_lib()
    log(f"phase 2: g++ built and loaded the host library in "
        f"{time.perf_counter() - t0:.3f} s")
    return build_s, regs


def _wrapper(name):
    """The kernel wrapper `name` (it carries the launch counter)."""
    module = importlib.import_module("wgbs_tools_tpu_torch.ops."
                                     + KERNELS[name][0])
    return getattr(module, WRAPPERS.get(name, name))


def _zero_launches():
    for name in KERNELS:
        _wrapper(name).launches = 0


def _read_launches():
    return {name: _wrapper(name).launches for name in KERNELS}


def _require_launches(what, launches, names):
    missing = [n for n in names if launches.get(n, 0) < 1]
    if missing:
        raise RuntimeError(f"{what}: a kernel of the path never launched "
                           f"({', '.join(missing)}): {launches}")


def _time_ms(fn, reps):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


SLEEP_CYCLES = 20_000_000  # ~10 ms of a spinning kernel at H100 clocks


def _device_ms(fn, reps):
    """The card's time per call of fn, without the host's: the calls'
    launches are queued behind a kernel that spins for SLEEP_CYCLES, so the
    card runs them back to back and the CUDA events around them see no
    gaps. _time_ms counts the host's time per call (a wrapper's checks and
    its launch) wherever a launch is shorter than its call. Raises if the
    queuing outlasted the spin, when the time would include host gaps."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queued_ms = 1e3 * (time.perf_counter() - t0)
    ev[2].record()
    torch.cuda.synchronize()
    if queued_ms >= ev[0].elapsed_time(ev[1]):
        raise RuntimeError(f"queuing {reps} calls took {queued_ms:.3f} ms, "
                           "longer than the spin kernel: raise SLEEP_CYCLES")
    return ev[1].elapsed_time(ev[2]) / reps


def phase_data(work, n_frags):
    """The genome and both pats; returns (big, deep) paths."""
    refs = op.join(work, "refs")
    write_genome(refs, N_SITES)
    os.environ["WGBS_TPU_REFDIR"] = refs
    big = op.join(work, "big.pat.gz")
    deep = op.join(work, "deep.pat.gz")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        write_pat_gz(big, n_frags, 20260820, 1, N_SITES, 3, pool)
        write_pat_gz(deep, 200_000, 5, 1, 2_000_000, 3000, pool)
    log(f"phase 3: wrote {n_frags:,} frags ({op.getsize(big) / 1e6:.1f} MB "
        f"pat.gz) and 200,000 frags with counts up to 3000 "
        f"({op.getsize(deep) / 1e6:.1f} MB) in "
        f"{time.perf_counter() - t0:.3f} s")
    return big, deep


# the long slab of phase 3 (tiles_v1 only), made from a seed, not read from
# a pat: an unverified stand-in for long-read (nanopore) traffic. No public
# read-length or depth distribution stands behind these numbers; they give
# the listed form of tiles_v1 (w16 128) a batch at a realistic size to be
# held exact and timed on, and no design choice rests on its times.
LONG_FRAGS = 300_000
LONG_SITES = 8_000_000
LONG_MEDIAN = 150  # sites; log-normal lengths, sigma 1 (~10x depth)
LONG_CAP = 2048    # the widest fragment: max_len 2048, w16 128


def long_slab(n=LONG_FRAGS, n_sites=LONG_SITES, cap=LONG_CAP, seed=8):
    """(fragments, window start 1, window length n_sites): n fragments of
    log-normal lengths (median LONG_MEDIAN sites, at most cap, at least one
    of cap), counts 1-3, in start order over the window; codes as make_slab
    draws them ('.' past each length)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.pat import PatFrags

    rng = np.random.default_rng(seed)
    lengths = np.clip(rng.lognormal(np.log(LONG_MEDIAN), 1.0, n), 1,
                      cap).astype(np.int32)
    lengths[rng.integers(n)] = cap
    starts = np.sort(rng.integers(1, n_sites - cap + 2, size=n)).astype(
        np.int32)
    counts = rng.integers(1, 4, size=n).astype(np.int32)
    draw = rng.integers(0, 100, size=(n, cap), dtype=np.uint8)
    codes = (draw < 70).astype(np.uint8)
    codes[draw >= 98] = 3
    del draw
    codes[np.arange(cap, dtype=np.int32)[None, :] >= lengths[:, None]] = 3
    return (PatFrags(starts, lengths, counts, codes, np.zeros(n, np.int16),
                     ["chr1"]), 1, n_sites)


def _first_slab(pat):
    """The first streamed slab of a pat, as the main path reads it:
    (fragments overlapping the genome, lo, span)."""
    from wgbs_tools_tpu_torch.formats.pat import DEF_CHUNK_BYTES, iter_pat
    from wgbs_tools_tpu_torch.ops.pileup import overlap_span

    it = iter_pat(pat, chunk_bytes=DEF_CHUNK_BYTES)
    sel, lo, hi = overlap_span(next(it), (1, N_SITES + 1))
    it.close()
    return sel, lo, hi - lo


def _holed(sel, lo, span):
    """The slab with no fragment starting in the middle third of its span:
    a window with empty tiles. Returns (fragments, number taken out)."""
    import numpy as np

    start = np.asarray(sel.start)
    hole = (start >= lo + span // 3) & (start < lo + 2 * span // 3)
    return sel.take(np.nonzero(~hole)[0]), int(hole.sum())


def _stage(frags, lo, span, dev, path):
    """A batch staged as PileupAccumulator.add stages it for a path (default
    geometry): "v2", "v1", or a dict of stage_v3's form keywords. Returns
    a list of staged batches on `dev`."""
    from wgbs_tools_tpu_torch.ops import pileup_v1 as pv1
    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    args = (frags.start, frags.length, frags.count, frags.codes, lo, span)
    if path == "v2":
        return [pv2.staged_v2_from_numpy(pv2.stage_v2(*args), dev)]
    if path == "v1":
        return [pv1.staged_v1_from_numpy(pv1.stage_v1(*args), dev)]
    staged = pv3.stage_v3(*args, **path)
    return pv3.staged_from_numpy(
        staged if isinstance(staged, list) else [staged], dev)


def _launch_checked(kernel, *args, **kwargs):
    """A call that launches kernels and must leave the current CUDA device
    as it was."""
    import torch

    before = torch.cuda.current_device()
    out = kernel(*args, **kwargs)
    after = torch.cuda.current_device()
    if after != before:
        raise RuntimeError(f"{kernel.__name__} moved the current device "
                           f"from {before} to {after}")
    return out


def _kernel_vs_twin(name, kernel, plain, sts, span):
    """Exact comparison of a kernel with its twin; returns (max abs err,
    the kernel's output)."""
    import torch

    got = sum(_launch_checked(kernel, st, span) for st in sts)
    want = sum(plain(st, span) for st in sts)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want).abs().max())
    if not torch.equal(got, want):
        raise RuntimeError(f"{name}: kernel != twin (max abs err {err})")
    return err, got


def _zero_tiles(out, tile):
    """Number of `tile`-site tiles of a (span, 2) pileup with no coverage."""
    import torch

    n = -(-out.shape[0] // tile)
    cov = torch.zeros(n * tile, dtype=out.dtype, device=out.device)
    cov[: out.shape[0]] = out[:, 1]
    return int((cov.view(n, tile) == 0).all(dim=1).sum())


def _empty_rows(st, span):
    """Boolean (span,) mask of the sites in tiles that get no chunk."""
    import torch

    return torch.repeat_interleave((st.c1 - st.c0) == 0, st.tile)[:span]


def _add_vs_twin(st, span, total0):
    """flat_vals_add against its twin from the same nonzero total: exactly
    equal, and the rows of tiles without chunks unchanged. Returns (max
    abs err, number of empty tiles)."""
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    got = _launch_checked(pv3.flat_vals_add, total0.clone(), st, span)
    want = pv3.flat_vals_add_plain(total0.clone(), st, span)
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want).abs().max())
    if not torch.equal(got, want):
        raise RuntimeError(f"flat_vals_add ({st.form}): kernel != twin "
                           f"(max abs err {err})")
    empty = _empty_rows(st, span)
    if not torch.equal(got[empty], total0[empty]):
        raise RuntimeError(f"flat_vals_add ({st.form}): rows of tiles "
                           "without chunks changed")
    return err, int(((st.c1 - st.c0) == 0).sum())


def _geometry(st):
    if hasattr(st, "rc"):
        return (f"rc={st.rc} tile={st.tile} g_max={st.g_max} "
                f"chunks={st.meta.shape[0]}")
    return f"tile={st.tile} fc={st.fc} chunks={st.meta.shape[0]}"


# ---------------------------------------------------------------------------
# edge cases of the value-plane body (csrc/pileup_v3.cu::pile_vals), as
# hand-made staged batches at the default geometry; tests/test_torch_pileup_v3.py
# holds the twins to numpy and, on the card, the kernels to the twins on them
# ---------------------------------------------------------------------------

VALS_EDGE = ("shuffled", "padding_between", "padding_chunk", "many_chunks",
             "all_255", "ragged_window", "outside_tile")


def vals_edge_batch(name, fused=True):
    """(stage_v3's 10-field value-plane tuple, window_len) for one edge case
    of the value-plane kernels: tile_sb 64, g_max 64, rc 1024 (4096 for
    "all_255"), 3 tiles. A chunk is (base sub-block, dg of its rows); rows
    past the given ones are padding (dg = g_max), and every padding row
    carries nonzero bytes, which the kernels and twins must skip by dg.
      shuffled         rows of each chunk out of sub-block order
      padding_between  padding rows (dg = g_max and dg < 0) between real rows
      padding_chunk    a chunk of padding rows only, inside a tile's range,
                       and a tile whose only chunk is one
      many_chunks      a tile with 5 chunks over overlapping sub-blocks
      all_255          every byte 255, 4095 rows over 2 sub-blocks (runs of
                       > 256 rows of one sub-block; several dg windows), and
                       a tile with no chunk
      ragged_window    window_len = 2 tiles + 4097 sites (odd, not a multiple
                       of the tile), rows past the window's end
      outside_tile     rows whose sub-block lies outside their chunk's tile
    With fused=False the split planes (mv, cv) of the same bytes."""
    import numpy as np

    rng = np.random.default_rng(VALS_EDGE.index(name) + 7)
    tile_sb = g_max = 64
    tile = tile_sb * 128
    rc = 4096 if name == "all_255" else 1024
    window_len = 3 * tile

    def rows(n, lo=0, hi=g_max):
        return np.sort(rng.integers(lo, hi, size=n))

    if name == "shuffled":
        tiles = [[(64 * t, rng.permutation(rows(n)))]
                 for t, n in enumerate((1000, 700, 1023))]
    elif name == "padding_between":
        tiles = []
        for t in range(3):
            d = rows(1023)
            d[::3] = g_max
            d[1::7] = -5
            tiles.append([(64 * t, d)])
    elif name == "padding_chunk":
        tiles = [[(0, rows(800)), (0, np.full(1023, g_max)),
                  (32, rows(500, 0, 32))],
                 [(64, np.full(600, g_max))], [(128, rows(10))]]
    elif name == "many_chunks":
        tiles = [[(0, rows(900))],
                 [(64 + 10 * k, rows(600, 0, 30)) for k in range(5)],
                 [(128, rows(1023))]]
    elif name == "all_255":
        tiles = [[(0, rows(4095, 0, 2))], [(64, rows(4095))], []]
    elif name == "ragged_window":
        window_len = 2 * tile + 4097
        tiles = [[(64 * t, rows(1023))] for t in range(3)]
    elif name == "outside_tile":
        tiles = [[(-10, rows(1000))], [(64 + 20, rows(1000))],
                 [(128, rows(1000))]]
    else:
        raise ValueError(f"no value-plane edge case {name!r}")
    chunks = [c for t in tiles for c in t]
    n_chunks = len(chunks)
    meta = np.zeros((n_chunks, 2, rc), np.int32)
    meta[:, 1, :] = g_max
    for c, (base, dg) in enumerate(chunks):
        meta[c, 1, : dg.size] = dg
        meta[c, 1, rc - 1] = base + g_max  # the base_g stash
    counts = [len(t) for t in tiles]
    c1 = np.cumsum(counts).astype(np.int32)
    c0 = (c1 - counts).astype(np.int32)
    if name == "all_255":
        plane = np.full((n_chunks * rc, 256), 255, np.uint8)
    else:
        plane = rng.integers(1, 256, size=(n_chunks * rc, 256)).astype(
            np.uint8)
    max_chunks = 1 << (max(max(counts), 1) - 1).bit_length()
    if fused:
        return (c0, c1, meta, plane, None, max_chunks, tile, rc, g_max,
                "vals"), window_len
    return (c0, c1, meta, np.ascontiguousarray(plane[:, :128]),
            np.ascontiguousarray(plane[:, 128:]), max_chunks, tile, rc, g_max,
            "vals"), window_len


def _vals_edge_cases(dev):
    """Each edge case through flat_vals_fused, flat_vals and flat_vals_add
    (both plane forms; a fresh total and an 8-byte-aligned row slice of a
    larger table) against the twins, exactly. Returns {kernel: max abs
    err}."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    errs = {"flat_vals_fused": 0, "flat_vals": 0, "flat_vals_add": 0}
    for name in VALS_EDGE:
        for fused in (True, False):
            staged, wl = vals_edge_batch(name, fused)
            st = pv3.staged_from_numpy(staged, dev)
            kernel = pv3.flat_vals_fused if fused else pv3.flat_vals
            plain = pv3.flat_vals_fused_plain if fused else pv3.flat_vals_plain
            err, _ = _kernel_vs_twin(kernel.__name__, kernel, plain, [st], wl)
            errs[kernel.__name__] = max(errs[kernel.__name__], err)
            table = torch.from_numpy(np.random.default_rng(wl).integers(
                -(1 << 30), 1 << 30, size=(wl + 2, 2), dtype=np.int32)).to(dev)
            for total0 in (table[:wl], table[1 : wl + 1]):  # 16-, 8-aligned
                err, _ = _add_vs_twin(st, wl, total0)
                errs["flat_vals_add"] = max(errs["flat_vals_add"], err)
    log(f"phase 3: value-plane edge cases {', '.join(VALS_EDGE)}: "
        f"flat_vals_fused, flat_vals and flat_vals_add (both plane forms, "
        f"16- and 8-byte-aligned totals) == twins, max_abs_err {errs}")
    return errs


# ---------------------------------------------------------------------------
# edge cases of the code-word body (csrc/pileup_v3.cu::pile_codes), as
# hand-made staged batches at the classic geometry in both rc classes;
# tests/test_torch_pileup_v3.py holds the twins to numpy and to the JAX
# package, and, on the card, the kernels to the twins on them
# ---------------------------------------------------------------------------

CODE_EDGE = ("shuffled", "padding_between", "padding_chunk", "many_chunks",
             "outside_tile", "ragged_window", "max_counts")
CODE_CLASSES = (16, 128)


def code_edge_batch(name, form="classic"):
    """([one staged tuple per rc class (16, 128)], window_len) for one edge
    case of the code-word kernels at the classic geometry: tile_sb 8,
    g_max 8, 3 tiles. form "classic": 8-field tuples, row counts in [1,
    3000]; "lane": 9-field tuples, per-lane counts of any byte. A tile is a
    list of runs (base sub-block, dg of its rows); each class cuts a run
    into chunks of at most rc - 1 rows (row rc - 1 stashes the base), and
    the chunk count is padded to a multiple of 16 with padding chunks in
    no tile's range, as staging pads it. Rows past a chunk's given ones
    are padding (dg = g_max); every row, padding too, carries random code
    words and counts (nonzero in the classic form), which the kernels must
    skip by dg.
      shuffled         rows of each chunk out of sub-block order
      padding_between  padding rows (dg = g_max and dg < 0) between real rows
      padding_chunk    chunks of padding rows only inside a tile's range, and
                       a tile whose only chunks are such
      many_chunks      a tile with 6 runs over overlapping sub-blocks (up to
                       18 chunks: more than the JAX tiled grid's one step)
      outside_tile     rows whose sub-block lies outside their chunk's tile
      ragged_window    window_len = 2 tiles + 511 sites (odd), rows past the
                       window's end
      max_counts       every count at its form's most (classic 2^20, so that
                       a site's sum passes 2^16 many times over; lane 255 in
                       every lane) over 500 rows of one tile, 400 of them in
                       one sub-block (runs of more than 256 rows), and a
                       tile with no chunk"""
    import numpy as np

    lane = form == "lane"
    if form not in ("classic", "lane"):
        raise ValueError(f"code-word form {form!r}: 'classic' or 'lane'")
    rng = np.random.default_rng(CODE_EDGE.index(name) + 31 + 100 * lane)
    tile_sb = g_max = 8
    tile = tile_sb * 128
    window_len = 3 * tile

    def rows(n, lo=0, hi=g_max):
        return np.sort(rng.integers(lo, hi, size=n))

    if name == "shuffled":
        tiles = [[(8 * t, rng.permutation(rows(n)))]
                 for t, n in enumerate((120, 45, 127))]
    elif name == "padding_between":
        tiles = []
        for t in range(3):
            d = rows(127)
            d[::3] = g_max
            d[1::7] = -5
            tiles.append([(8 * t, d)])
    elif name == "padding_chunk":
        tiles = [[(0, rows(100)), (0, np.full(127, g_max)),
                  (4, rows(50, 0, 4))],
                 [(8, np.full(60, g_max))], [(16, rows(10))]]
    elif name == "many_chunks":
        tiles = [[(0, rows(90))],
                 [(8 + k, rows(40, 0, 8 - k)) for k in range(6)],
                 [(16, rows(127))]]
    elif name == "outside_tile":
        tiles = [[(-3, rows(100))], [(8 + 5, rows(100))], [(16, rows(100))]]
    elif name == "ragged_window":
        window_len = 2 * tile + 511
        tiles = [[(8 * t, rows(127))] for t in range(3)]
    elif name == "max_counts":
        tiles = [[(0, rows(300, 0, 1)), (0, rows(200, 0, 2))],
                 [(8, rows(127))], []]
    else:
        raise ValueError(f"no code-word edge case {name!r}")
    out = []
    for rc in CODE_CLASSES:
        chunks = [[(base, dg[i : i + rc - 1])
                   for base, dg in runs for i in range(0, len(dg), rc - 1)]
                  for runs in tiles]
        counts = [len(t) for t in chunks]
        chunks = [c for t in chunks for c in t]
        n_chunks = -(-len(chunks) // 16) * 16
        meta = np.zeros((n_chunks, 2, rc), np.int32)
        meta[:, 1, :] = g_max
        for c, (base, dg) in enumerate(chunks):
            meta[c, 1, : dg.size] = dg
            meta[c, 1, rc - 1] = base + g_max  # the base_g stash
        c1 = np.cumsum(counts).astype(np.int32)
        c0 = (c1 - counts).astype(np.int32)
        words = rng.integers(-(1 << 31), 1 << 31, size=(n_chunks * rc, 8),
                             dtype=np.int64).astype(np.int32)
        max_chunks = 1 << (max(max(counts), 1) - 1).bit_length()
        if lane:
            cnts = (np.full((n_chunks * rc, 32), -1, np.int32)
                    if name == "max_counts" else rng.integers(
                        0, 256, size=(n_chunks * rc, 128), dtype=np.uint8)
                    .view(np.int32))
            out.append((c0, c1, meta, words, cnts, max_chunks, tile, rc,
                        g_max))
            continue
        meta[:, 0, :] = (1 << 20 if name == "max_counts" else
                         rng.integers(1, 3001, size=(n_chunks, rc)))
        out.append((c0, c1, meta, words, max_chunks, tile, rc, g_max))
    return out, window_len


def _code_edge_cases(dev):
    """Each edge case through flat_classic and tiled_classic (classic form)
    and flat_lc (lane form) against the twins, exactly, both rc classes
    summed as call_staged sums them. Returns {kernel: max abs err}."""
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    errs = {"flat_classic": 0, "tiled_classic": 0, "flat_lc": 0}
    for name in CODE_EDGE:
        for form in ("classic", "lane"):
            staged, wl = code_edge_batch(name, form)
            sts = pv3.staged_from_numpy(staged, dev)
            for kernel in ((pv3.flat_classic, pv3.tiled_classic)
                           if form == "classic" else (pv3.flat_lc,)):
                kname = kernel.__name__
                plain = getattr(pv3, kname + "_plain")
                err, _ = _kernel_vs_twin(kname, kernel, plain, sts, wl)
                errs[kname] = max(errs[kname], err)
    log(f"phase 3: code-word edge cases {', '.join(CODE_EDGE)}: "
        f"flat_classic, tiled_classic and flat_lc (rc classes "
        f"{CODE_CLASSES}) == twins, max_abs_err {errs}")
    return errs


# ---------------------------------------------------------------------------
# edge cases of the v2 fragment-row kernel (csrc/pileup_v2.cu::tiles_v2), as
# v2 staged tuples at the default geometry (tile 1024, fc 256, g_max 8), made
# by stage_v2 or, where staging cannot make the case, by hand;
# tests/test_torch_pileup_v2.py holds the twin to numpy and to the JAX
# package's Pallas kernel, and, on the card, the kernel to the twin on them
# ---------------------------------------------------------------------------

FRAG_EDGE = ("start_last_site", "end_last_site", "start_first_site",
             "empty_tile", "many_chunks", "padding_stash", "w_cols_2",
             "w_cols_4", "w_cols_8", "ragged_window", "counts_3000",
             "shuffled")


def _frags(rng, n, lo, hi, max_len):
    """n random fragments starting at window sites [lo, hi) (0-based), with
    counts up to 3000 and random codes in every column, past each
    fragment's length too."""
    import numpy as np

    return (rng.integers(lo, hi, size=n), rng.integers(1, max_len + 1, size=n),
            rng.integers(1, 3001, size=n),
            rng.integers(0, 4, size=(n, max_len)).astype(np.uint8))


def _stage_batches(stage, window_len, *batches, window_start=1):
    """stage (stage_v2 or stage_v1) of the fragment batches together, at
    0-based window sites, over [window_start, window_start + window_len);
    the codes are padded to the widest batch's columns."""
    import numpy as np

    width = max(b[3].shape[1] for b in batches)
    start = np.concatenate([b[0] for b in batches]) + 1
    length = np.concatenate([b[1] for b in batches]).astype(np.int32)
    count = np.concatenate([b[2] for b in batches]).astype(np.int32)
    codes = np.concatenate([np.pad(b[3], ((0, 0), (0, width - b[3].shape[1])))
                            for b in batches])
    return stage(start, length, count, codes, window_start, window_len)


def _v2_staged(window_len, *batches):
    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2

    return _stage_batches(pv2.stage_v2, window_len, *batches)


def _fixed(starts, lengths):
    """Fragments at the given 0-based starts and lengths, count 3000, codes
    C, T, C, '.' repeated over 128 columns."""
    import numpy as np

    n = len(starts)
    codes = np.tile(np.array([1, 0, 1, 3], np.uint8), 32)
    return (np.asarray(starts), np.asarray(lengths), np.full(n, 3000),
            np.broadcast_to(codes, (n, 128)).copy())


def _v2_by_hand(rng, tiles, window_len, w_cols, stash_count=0):
    """A v2 tuple made row by row, as stage_v2 lays it out where it can: a
    tile is a list of chunks, a chunk a list of (start, length, count) rows
    (dg -1 or g_max: a padding row) whose sub-blocks span at most g_max from
    the chunk's lowest (its base_g, stashed in row fc - 1's start slot).
    Rows past the given ones are padding; every row carries random words
    (codes past its length too), and every padding row a start in the
    chunk's tile and a count, which the kernel must skip by dg; the base_g
    row's count is stash_count. Chunks are padded to a multiple of 16, as
    staging pads them, with chunks in no tile's range."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2

    fc, g_max, tile = pv2.FRAG_CHUNK, pv2.G_MAX, pv2.TILE
    chunks = [(t, rows) for t, tile_chunks in enumerate(tiles)
              for rows in tile_chunks]
    n_chunks = -(-len(chunks) // 16) * 16
    meta = np.zeros((n_chunks, 3, fc), np.int32)
    meta[:, 1, :] = g_max << 16
    words = rng.integers(-(1 << 31), 1 << 31, size=(n_chunks * fc, w_cols),
                         dtype=np.int64).astype(np.int32)
    for c, (t, rows) in enumerate(chunks):
        meta[c, 0, :] = rng.integers(t * tile, (t + 1) * tile, fc)
        meta[c, 1, :] |= rng.integers(1, 129, fc)
        meta[c, 2, :] = rng.integers(1, 3001, fc)
        real = [(s, ln, n) for s, ln, n, *pad in rows if not pad]
        base_g = min(s // 128 for s, _, _ in real) if real else 8 * t
        for r, (s, ln, n, *pad) in enumerate(rows):
            dg = pad[0] if pad else s // 128 - base_g
            if not (pad or 0 <= dg < g_max):
                raise ValueError(f"row {r} of chunk {c}: dg {dg}")
            meta[c, :, r] = (s, ln | (dg << 16), n)
        meta[c, :, fc - 1] = (base_g, g_max << 16, stash_count)
    counts = [len(tile_chunks) for tile_chunks in tiles]
    c1 = np.cumsum(counts).astype(np.int32)
    c0 = (c1 - counts).astype(np.int32)
    max_chunks = 1 << (max(max(counts), 1) - 1).bit_length()
    return (c0, c1, meta, words, max_chunks), window_len


def _rows(rng, n, lo, hi, max_len):
    """n (start, length, count) rows starting in [lo, hi)."""
    return list(zip(rng.integers(lo, hi, n).tolist(),
                    rng.integers(1, max_len + 1, n).tolist(),
                    rng.integers(1, 3001, n).tolist()))


def frag_edge_batch(name):
    """(stage_v2's 5-field tuple, window_len) for one edge case of tiles_v2
    at the default geometry:
      start_last_site   128-site fragments starting on a tile's last site
                        (sites 1023, 2047, and 3071, the window's last)
      end_last_site     fragments ending exactly on a tile's last site
      start_first_site  fragments starting exactly on a tile's first site
      empty_tile        tiles 1 and 3 with no chunk (c0 == c1) that take
                        crossers from tiles 0 and 2
      many_chunks       (by hand) tile 1 of 6 chunks whose rows spread over
                        the whole tile, so every chunk has crossers
      padding_stash     (by hand) padding rows (dg g_max and -1) between real
                        rows, at starts in reach of the next tile, with
                        counts and words; each chunk's base_g row carries a
                        count, and tile 0's base_g (7) is a site of the tile
      w_cols_2/4/8      (by hand) random words, lengths past 16 * w_cols
      ragged_window     window_len = 2 tiles + 517 sites (odd), fragments
                        clipped at its end
      counts_3000       every count 3000, ~900 fragments deep across the
                        edge of tiles 0 and 1 (a 16-bit sum would carry)
      shuffled          a staged batch with the rows of each chunk (but the
                        base_g row) in random order"""
    import numpy as np

    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2

    rng = np.random.default_rng(FRAG_EDGE.index(name) + 71)
    tile, fc = pv2.TILE, pv2.FRAG_CHUNK
    wl = 3 * tile
    if name == "start_last_site":
        return _v2_staged(wl, _frags(rng, 400, 0, wl, 128),
                          _fixed([1023, 1023, 2047, 3071], [128, 5, 128,
                                                            128])), wl
    if name == "end_last_site":
        return _v2_staged(wl, _frags(rng, 400, 0, wl, 128),
                          _fixed([896, 1000, 1023, 1920, 2040],
                                 [128, 24, 1, 128, 8])), wl
    if name == "start_first_site":
        return _v2_staged(wl, _frags(rng, 400, 0, wl, 128),
                          _fixed([1024, 1024, 2048, 0], [128, 1, 20, 128])), wl
    if name == "empty_tile":
        wl = 4 * tile
        return _v2_staged(wl, _frags(rng, 300, 0, 1024, 128),
                          _frags(rng, 300, 2048, 3072, 128),
                          _fixed([1023, 3000], [128, 128])), wl
    if name == "many_chunks":
        return _v2_by_hand(rng, [[_rows(rng, 100, 0, 1024, 128)],
                                 [_rows(rng, 255, 1024, 2048, 128)
                                  for _ in range(6)],
                                 [_rows(rng, 50, 2048, 3072, 128)]], wl, 8)
    if name == "padding_stash":
        tiles = []
        for t, lo in enumerate((896, 1024, 2560)):  # base_g 7, 8, 20
            rows = _rows(rng, 200, lo, (t + 1) * tile, 64)
            for i in range(0, 200, 3):
                s, ln, n = rows[i]
                rows[i] = (max(s, (t + 1) * tile - 30), ln, n,
                           pv2.G_MAX if i % 2 else -1)
            tiles.append([rows])
        return _v2_by_hand(rng, tiles, wl, 4, stash_count=3000)
    if name.startswith("w_cols_"):
        w = int(name[len("w_cols_"):])
        tiles = [[_rows(rng, 255, 1024 * t, 1024 * (t + 1), 16 * w + 40)
                  for _ in range(2)] for t in range(3)]
        return _v2_by_hand(rng, tiles, wl, w)
    if name == "ragged_window":
        wl = 2 * tile + 517
        return _v2_staged(wl, _frags(rng, 600, 0, wl, 128),
                          _fixed([wl - 1, wl - 60, 2047], [128, 100, 128])), wl
    if name == "counts_3000":
        f = _frags(rng, 900, 900, 1100, 128)
        return _v2_staged(wl, (f[0], np.full(900, 128), np.full(900, 3000),
                               np.ones((900, 128), np.uint8))), wl
    if name == "shuffled":
        c0, c1, meta, words, mc = _v2_staged(wl, _frags(rng, 2000, 0, wl,
                                                        64))
        meta, words = meta.copy(), words.reshape(-1, fc, words.shape[1])
        for c in range(meta.shape[0]):
            p = rng.permutation(fc - 1)
            meta[c, :, : fc - 1] = meta[c, :, p].T
            words[c, : fc - 1] = words[c, p]
        return (c0, c1, meta, words.reshape(-1, words.shape[2]), mc), wl
    raise ValueError(f"no fragment-row edge case {name!r}")


# ---------------------------------------------------------------------------
# edge cases of the v1 fragment-row kernel (csrc/pileup_v1.cu::tiles_v1), as
# v1 staged tuples at the default geometry (tile 1024, fc 256), made by
# stage_v1 or, where staging cannot make the case, altered by hand;
# tests/test_torch_pileup_v1.py holds the twin to numpy and (rows in start
# order) to the JAX package's Pallas kernel, and, on the card, the kernel
# to the twin on them
# ---------------------------------------------------------------------------

FRAG_EDGE_V1 = ("max_len_4096", "far_crossers", "tile_edges", "w16_24",
                "w16_40", "mixed", "padding_rows", "negative_start",
                "ragged_window", "counts_3000", "shuffled", "shuffled_long")
# the cases whose rows are not in start order inside [lo, hi): held to the
# twin's rule (numpy), not to the JAX kernel, which walks whole chunks
FRAG_EDGE_V1_UNORDERED = ("shuffled", "shuffled_long")


def _long_rows(rng, starts, lengths, width):
    """Fragments at the given 0-based starts and lengths, counts up to 3000,
    random codes in all `width` columns."""
    import numpy as np

    n = len(starts)
    return (np.asarray(starts), np.asarray(lengths),
            rng.integers(1, 3001, size=n),
            rng.integers(0, 4, size=(n, width)).astype(np.uint8))


def _v1_staged(window_len, *batches, window_start=1):
    """stage_v1 of the batches (_stage_batches): max_len follows the widest
    batch's code columns."""
    from wgbs_tools_tpu_torch.ops import pileup_v1 as pv1

    return _stage_batches(pv1.stage_v1, window_len, *batches,
                          window_start=window_start)


def _shuffled_v1(rng, staged):
    """The staged rows of each chunk in random order, padding rows too."""
    lo, hi, meta, words, max_chunks, max_len = staged
    fc = meta.shape[2]
    meta, words = meta.copy(), words.reshape(-1, fc, words.shape[1]).copy()
    for c in range(meta.shape[0]):
        p = rng.permutation(fc)
        meta[c] = meta[c][:, p]
        words[c] = words[c, p]
    return lo, hi, meta, words.reshape(-1, words.shape[2]), max_chunks, max_len


def frag_edge_v1_batch(name):
    """(stage_v1's 6-field tuple, window_len) for one edge case of tiles_v1
    at the default geometry (rows of the thread-per-row form where w16 is 8
    or 16, of the warp-per-row form otherwise):
      max_len_4096   w16 256: 4096-site rows that span three whole tiles,
                     each tile's look-back over four tiles
      far_crossers   w16 192: tiles 1-3 with no row starting in them,
                     covered only by 2048-3072-site rows from tile 0
      tile_edges     w16 16: 256-site rows (max_len exactly) starting on a
                     tile's first site and ending on a tile's last site
      w16_24/40      max_len 384 / 640 (w16 not a power of two)
      mixed          w16 128: 3000 rows of <= 24 sites and one 2000-site row:
                     every look-back is wide, few of its rows reach
      padding_rows   (by hand) the padding rows carry counts, random words
                     and, half of them, a length; tiles have rows in
                     [lo_adj, lo) from the chunk rounding
      negative_start w16 8: window start 600, rows from site 1 (negative
                     relative starts)
      ragged_window  w16 24: window_len = 2 tiles + 517 sites (odd), rows
                     past its end
      counts_3000    w16 24: every count 3000, ~900 rows deep across the
                     edge of tiles 0 and 1 (a 16-bit sum would carry)
      shuffled       (by hand) w16 8, rows of each chunk in random order
      shuffled_long  (by hand) w16 24, the same"""
    import numpy as np

    rng = np.random.default_rng(FRAG_EDGE_V1.index(name) + 171)
    tile = 1024
    wl = 3 * tile
    if name == "max_len_4096":
        wl = 6 * tile
        return _v1_staged(wl, _frags(rng, 300, 0, wl, 200),
                          _long_rows(rng, [0, 1000, 1024, 2047, 2048],
                                     [4096, 4096, 3000, 4096, 2500],
                                     4096)), wl
    if name == "far_crossers":
        wl = 5 * tile
        return _v1_staged(wl, _frags(rng, 100, 0, tile, 64),
                          _frags(rng, 100, 4 * tile, wl, 64),
                          _long_rows(rng, [10, 500, 900, 1000, 1020, 1023],
                                     [3000, 2900, 2500, 2048, 3072, 3072],
                                     3072)), wl
    if name == "tile_edges":
        wl = 4 * tile
        return _v1_staged(wl, _frags(rng, 300, 0, wl, 256),
                          _long_rows(rng, [0, 1024, 2048, 3072, 768, 1792,
                                           3840], [256] * 7, 256)), wl
    if name in ("w16_24", "w16_40"):
        width = 16 * int(name[len("w16_"):])
        return _v1_staged(wl, _frags(rng, 400, 0, wl, width)), wl
    if name == "mixed":
        wl = 4 * tile
        return _v1_staged(wl, _frags(rng, 3000, 0, wl, 24),
                          _long_rows(rng, [100], [2000], 2000)), wl
    if name == "padding_rows":
        lo, hi, meta, words, mc, max_len = _v1_staged(
            wl, _frags(rng, 300, 0, wl, 128))
        meta, words = meta.copy(), words.copy()
        pad = meta[:, 0] == 1 << 30
        meta[:, 2][pad] = 3000
        meta[:, 1][pad & (np.arange(meta.shape[2]) % 2 == 0)] = 128
        flat = pad.reshape(-1)
        words[flat] = rng.integers(-(1 << 31), 1 << 31, size=(
            int(flat.sum()), words.shape[1]), dtype=np.int64).astype(np.int32)
        return (lo, hi, meta, words, mc, max_len), wl
    if name == "negative_start":
        return _v1_staged(wl, _frags(rng, 600, 0, wl + 599, 128),
                          window_start=600), wl
    if name == "ragged_window":
        wl = 2 * tile + 517
        return _v1_staged(wl, _frags(rng, 600, 0, wl, 384),
                          _long_rows(rng, [wl - 1, wl - 300, 2047],
                                     [384, 384, 384], 384)), wl
    if name == "counts_3000":
        f = _frags(rng, 900, 700, 1100, 384)
        return _v1_staged(wl, (f[0], np.maximum(f[1], 330),
                               np.full(900, 3000), f[3])), wl
    if name == "shuffled":
        return _shuffled_v1(rng, _v1_staged(wl, _frags(rng, 2000, 0, wl,
                                                       128))), wl
    if name == "shuffled_long":
        return _shuffled_v1(rng, _v1_staged(wl, _frags(rng, 800, 0, wl,
                                                       384))), wl
    raise ValueError(f"no v1 fragment-row edge case {name!r}")


def _frag_edge_cases(dev):
    """Each edge case through tiles_v2 (FRAG_EDGE) and tiles_v1
    (FRAG_EDGE_V1) against its twin, exactly. Returns {kernel: max abs
    err}."""
    from wgbs_tools_tpu_torch.ops import pileup_v1 as pv1
    from wgbs_tools_tpu_torch.ops import pileup_v2 as pv2

    err = 0
    for name in FRAG_EDGE:
        staged, wl = frag_edge_batch(name)
        st = pv2.staged_v2_from_numpy(staged, dev)
        e, _ = _kernel_vs_twin("tiles_v2", pv2.tiles_v2, pv2.tiles_v2_plain,
                               [st], wl)
        err = max(err, e)
    log(f"phase 3: fragment-row edge cases {', '.join(FRAG_EDGE)}: tiles_v2 "
        f"== twin, max_abs_err {err}")
    err1 = 0
    for name in FRAG_EDGE_V1:
        staged, wl = frag_edge_v1_batch(name)
        st = pv1.staged_v1_from_numpy(staged, dev)
        e, _ = _kernel_vs_twin("tiles_v1", pv1.tiles_v1, pv1.tiles_v1_plain,
                               [st], wl)
        err1 = max(err1, e)
    log(f"phase 3: v1 fragment-row edge cases {', '.join(FRAG_EDGE_V1)}: "
        f"tiles_v1 == twin, max_abs_err {err1}")
    return {"tiles_v2": err, "tiles_v1": err1}


# H100 SXM data-sheet peaks: device memory bytes/s, and the non-tensor
# 32-bit rate, for the kernels' integer adds
HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def _work(sts, span):
    """(bytes, ops) a pileup of these staged batches must move and do,
    counted as a roofline bound counts them: each input read once (only
    the rows that land in the window: real rows, of a v1 row only the
    min(length, w16) words its codes occupy; the dg words of every chunk a
    tile visits; the per-tile ranges), the (span, 2) int32
    output written once; ops = one integer add per plane byte of a real row
    (value planes), per lane of a real code-word row, or two per site of a
    real fragment (v1, v2)."""
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    n_bytes, ops = span * 8, 0
    for st in sts:
        meta = st.meta.to(torch.int64)
        if hasattr(st, "rc"):  # v3 forms
            num_tiles = -(-span // st.tile)
            real = int((pv3._row_targets(st, num_tiles)
                        < num_tiles * st.tile_sb).sum())
            visited = int((pv3.chunk_tiles(st.c0, st.c1, meta.shape[0])
                           >= 0).sum())
            row_bytes = {"vals": 256, "vals_split": 256, "classic": 32 + 4,
                         "lane": 32 + 128}[st.form]
            n_bytes += real * row_bytes + visited * st.rc * 4 + num_tiles * 8
            ops += real * 256
            continue
        if hasattr(st, "g_max"):  # v2: len | dg << 16, dg outside = padding
            dg = meta[:, 1, :] >> 16
            real = (dg >= 0) & (dg < st.g_max)
            lens = meta[:, 1, :] & 0xFFFF
            words = int(real.sum()) * st.words.shape[1]
            ranges = st.c0.numel() * 8
        else:  # v1: start 2^30 on padding rows; the words its codes occupy
            real = meta[:, 0, :] != (1 << 30)
            lens = meta[:, 1, :]
            words = int(lens[real].clamp(0, st.words.shape[1]).sum())
            ranges = st.lo.numel() * 8
        n_bytes += int(real.sum()) * 12 + 4 * words + ranges
        ops += 2 * int(lens[real].sum())
    return n_bytes, ops


def _bound(n_bytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    ops over the 32-bit rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _library_ms(st, span):
    """The one PyTorch call that computes a value-plane pileup from the same
    staged rows: index_add_ of the int32 rows into the (sub-block, 256)
    accumulator, the cast and the row targets made outside the timed
    window. Timed only; the port never calls it."""
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    num_tiles = -(-span // st.tile)
    planes = st.rows if st.cv is None else torch.cat([st.rows, st.cv], dim=1)
    vals = planes.to(torch.int32)
    targets = pv3._row_targets(st, num_tiles)
    acc = torch.zeros((num_tiles * st.tile_sb + 1, 256), dtype=torch.int32,
                      device=st.device)
    return _time_ms(lambda: acc.index_add_(0, targets, vals), 20)


# kernel -> (its pats, the path that stages its batches, the staged form
# where stage_v3 stages them); the flat_vals_add kernel comes after these
PHASE3 = {
    "flat_vals_fused": (("big",), {}, "vals"),
    "flat_vals": (("big",), dict(fused=False), "vals_split"),
    "flat_classic": (("deep",), {}, "classic"),
    "flat_lc": (("big",), dict(vals=False), "lane"),
    "tiled_classic": (("big", "deep"), dict(lane_counts=False), "classic"),
    "tiles_v2": (("big", "deep"), "v2", None),
    "tiles_v1": (("big", "deep", "long"), "v1", None),
}


def phase_kernels(big, deep, regs):
    """Each kernel vs its twin on the first streamed slab of its pats,
    staged as its path stages it, and on each slab with a hole; the code-
    word kernels also timed per rc-class launch, beside their ptxas
    registers (`regs`). Returns (per-kernel results, the big pat's first
    slab)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3

    dev = torch.device("cuda")
    pats = {"big": big, "deep": deep}
    slabs = {name: _first_slab(pat) for name, pat in pats.items()}
    t0 = time.perf_counter()
    slabs["long"] = long_slab()
    log(f"phase 3: made the long slab ({LONG_FRAGS:,} frags of median "
        f"{LONG_MEDIAN} sites, at most {LONG_CAP}, over {LONG_SITES:,} sites, "
        f"mean depth {slabs['long'][0].length.sum() / LONG_SITES:.2f}) in "
        f"{time.perf_counter() - t0:.3f} s")
    out, kept = {}, {}  # kept: form -> (staged slab, staged holed slab)
    for name, (names, path, form) in PHASE3.items():
        kernel = _wrapper(name)
        plain = getattr(importlib.import_module(kernel.__module__),
                        name + "_plain")
        res = out[name] = {"max_abs_err": 0}
        for pat in names:
            sel, lo, span = slabs[pat]
            sts = _stage(sel, lo, span, dev, path)
            if form and any(st.form != form for st in sts):
                raise RuntimeError(f"{name}: the slab staged as "
                                   f"{[st.form for st in sts]}, not "
                                   f"{form!r}")
            err, _ = _kernel_vs_twin(name, kernel, plain, sts, span)
            ms = _device_ms(lambda: [kernel(st, span) for st in sts], 20)
            call_ms = _time_ms(lambda: [kernel(st, span) for st in sts], 20)
            plain_ms = _time_ms(lambda: [plain(st, span) for st in sts], 5)
            holed_frags, n_out = _holed(sel, lo, span)
            holed = _stage(holed_frags, lo, span, dev, path)
            herr, hout = _kernel_vs_twin(name, kernel, plain, holed, span)
            empty = _zero_tiles(hout, sts[0].tile)
            if not empty:
                raise RuntimeError(f"{name}: the holed slab of {pat} has no "
                                   "empty tile")
            err = max(err, herr)
            res["max_abs_err"] = max(res["max_abs_err"], err)
            n_bytes, ops = _work(sts, span)
            bound_ms, bound_by = _bound(n_bytes, ops)
            log(f"phase 3: {name}: kernel == twin (max_abs_err {err}) on "
                f"the first slab of {pat}.pat.gz: {sel.nr_frags:,} frags "
                f"over {span:,} sites, {sum(st.meta.shape[0] for st in sts):,}"
                f" chunks [{'; '.join(map(_geometry, sts))}], and on it with "
                f"{n_out:,} frags taken out ({empty} tiles of zeros); "
                f"kernel {ms:.4f} ms on the card ({call_ms:.4f} ms per call "
                f"with the host's), twin {plain_ms:.4f} ms per slab "
                f"({len(sts)} launch(es))")
            key = "" if pat == names[0] else pat + "_"
            res.update({key + "ms": ms, key + "call_ms": call_ms,
                        key + "plain_ms": plain_ms,
                        key + "bytes": n_bytes, key + "ops": ops,
                        key + "bound_ms": bound_ms, key + "bound_by": bound_by,
                        key + "slab_frags": sel.nr_frags,
                        key + "slab_sites": span})
            if not key:
                res["library_ms"] = (_library_ms(sts[0], span)
                                     if form in ("vals", "vals_split")
                                     else None)
            log(f"phase 3: {name} on {pat}: {n_bytes:,} bytes, {ops:,} adds:"
                f" bound {bound_ms:.4f} ms ({bound_by}), the kernel at "
                f"{100 * bound_ms / ms:.1f} % of it; library call "
                f"{res['library_ms'] if not key else None} ms")
            if form in ("classic", "lane"):
                # one launch per rc class: each writes (or zeroes and adds
                # into) the whole window
                res[key + "class_ms"] = {
                    str(st.rc): _device_ms(lambda st=st: kernel(st, span),
                                           20)
                    for st in sts}
                log(f"phase 3: {name} on {pat} per rc-class launch: "
                    + ", ".join(f"rc {rc} {v:.4f} ms" for rc, v in
                                res[key + "class_ms"].items())
                    + f" ({ms:.4f} ms per slab); ptxas {regs.get(name)} "
                    "registers")
            if name == "tiled_classic":
                # the JAX package's grid A/B: the flat kernel on the same
                # batches, in the same process
                res[key + "flat_ms"] = _device_ms(
                    lambda: [pv3.flat_classic(st, span) for st in sts], 20)
                log(f"phase 3: tiled_classic vs flat_classic on the same "
                    f"batches of {pat}: {ms:.4f} against "
                    f"{res[key + 'flat_ms']:.4f} ms")
            if form in ("vals", "vals_split"):
                kept[form] = (sts[0], holed[0])

    # flat_vals_add in both plane forms, from a seeded nonzero total
    sel, lo, span = slabs["big"]
    total0 = torch.from_numpy(np.random.default_rng(3).integers(
        -(1 << 20), 1 << 20, size=(span, 2), dtype=np.int32)).to(dev)
    res = {}
    for st, holed in (kept["vals"], kept["vals_split"]):
        err, _ = _add_vs_twin(st, span, total0)
        herr, empty = _add_vs_twin(holed, span, total0)
        if not empty:
            raise RuntimeError("flat_vals_add: the holed slab has no empty "
                               "tile")
        total = total0.clone()
        ms = _device_ms(lambda: pv3.flat_vals_add(total, st, span), 20)
        call_ms = _time_ms(lambda: pv3.flat_vals_add(total, st, span), 20)
        plain_ms = _time_ms(lambda: pv3.flat_vals_add_plain(total, st, span),
                            5)
        # the pileup's bytes, with the total read and written where a tile
        # has chunks (the others' rows are left alone) in place of the output
        covered = int((~_empty_rows(st, span)).sum())
        n_bytes, ops = _work([st], span)
        n_bytes += 16 * covered - 8 * span
        bound_ms, bound_by = _bound(n_bytes, ops)
        res[st.form] = {"max_abs_err": max(err, herr), "ms": ms,
                        "call_ms": call_ms, "plain_ms": plain_ms, "empty_tiles": empty,
                        "bytes": n_bytes, "ops": ops, "bound_ms": bound_ms,
                        "bound_by": bound_by}
        log(f"phase 3: flat_vals_add ({st.form}): kernel == twin (max_abs_err "
            f"{max(err, herr)}) from a nonzero total on the big pat's first "
            f"slab and on it with a hole ({empty} empty tiles, their rows "
            f"unchanged); kernel {ms:.4f} ms on the card ({call_ms:.4f} ms "
            f"per call), twin {plain_ms:.4f} ms per slab; {n_bytes:,} bytes: bound {bound_ms:.4f} ms ({bound_by}), "
            f"the kernel at {100 * bound_ms / ms:.1f} % of it")
    fused, split = res["vals"], res["vals_split"]
    out["flat_vals_add"] = {
        **fused, "max_abs_err": max(fused["max_abs_err"],
                                    split["max_abs_err"]),
        # the same index_add_ as the pileup's (the add is not in it)
        "library_ms": out["flat_vals_fused"]["library_ms"],
        "split_ms": split["ms"], "split_call_ms": split["call_ms"],
        "split_plain_ms": split["plain_ms"],
        "split_bound_ms": split["bound_ms"],
        "split_library_ms": out["flat_vals"]["library_ms"],
        "slab_frags": sel.nr_frags, "slab_sites": span}

    edges = {**_vals_edge_cases(dev), **_code_edge_cases(dev),
             **_frag_edge_cases(dev)}
    for name, err in edges.items():
        out[name]["edge_max_abs_err"] = err
        out[name]["max_abs_err"] = max(out[name]["max_abs_err"], err)
    return out, slabs["big"]


def _same(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def phase_pat2beta(work, big, deep, n_frags):
    """Returns (launches, summary line)."""
    import numpy as np

    from wgbs_tools_tpu_torch.cli.main import main as cli_main
    from wgbs_tools_tpu_torch.ops import pileup_v3 as pv3
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    out_gpu = op.join(work, "gpu")
    os.makedirs(out_gpu)
    _zero_launches()
    t0 = time.perf_counter()
    if cli_main(["pat2beta", big, deep, "-o", out_gpu, "--device", "cuda"]):
        raise RuntimeError("pat2beta CLI failed")
    wall = time.perf_counter() - t0
    if cli_main(["pat2beta", deep, "-l", "-o", out_gpu, "--device", "cuda"]):
        raise RuntimeError("pat2beta -l CLI failed")
    launches = _read_launches()
    cli = (f"CLI pat2beta on cuda: {wall:.3f} s for both pats "
           f"({(n_frags + 200_000) / wall / 1e6:.3f} M frags/s); kernel "
           f"launches {launches}")
    log("phase 4: " + cli)
    _require_launches("phase 4", launches, ("flat_vals_fused", "flat_classic"))

    t0 = time.perf_counter()
    for pat, lbeta in ((big, False), (deep, False), (deep, True)):
        suff = ".lbeta" if lbeta else ".beta"
        name = op.basename(pat)[: -len(".pat.gz")]
        oracle = pat2beta(pat, lbeta=lbeta, backend="native", device="cpu",
                          out_path=op.join(work, name + ".oracle" + suff))
        got = op.join(out_gpu, name + suff)
        size = N_SITES * 2 * (2 if lbeta else 1)
        if op.getsize(got) != size or not _same(got, oracle):
            raise RuntimeError(f"{got} differs from the host oracle")
        beta = np.fromfile(got, np.uint16 if lbeta else np.uint8)
        cov = beta[1::2].astype(np.float64)
        log(f"phase 4: {name}{suff} == host oracle, {size:,} bytes, "
            f"mean cov {cov.mean():.4f}, covered sites "
            f"{int((cov > 0).sum()):,}")
    log(f"phase 4: host oracle runs took {time.perf_counter() - t0:.3f} s")

    timings = {}
    t0 = time.perf_counter()
    timed_out = pat2beta(big, device="cuda", timings=timings,
                         out_path=op.join(work, "timed.beta"))
    total = time.perf_counter() - t0
    if not _same(timed_out, op.join(out_gpu, "big.beta")):
        raise RuntimeError("the timed run wrote other bytes")
    stages = (f"stage seconds (timed run of the big pat, {n_frags:,} frags; "
              "decode = wait for the lookahead's slab, device synchronized "
              "after each device stage): " + ", ".join(
                  f"{k} {v:.3f}" for k, v in timings.items())
              + f"; total {total:.3f}")
    log("phase 4: " + stages)
    return launches, cli + "; " + stages


def phase_sharded(work, big, deep, n_frags, slab):
    """pat2beta over 4 site shards on the one card against phase 4's
    oracle files, then the first big slab through the split-plane paths.
    Returns (launches of the sharded pat2beta, launches of the split run,
    summary line)."""
    import torch

    from wgbs_tools_tpu_torch.ops.pileup import PileupAccumulator
    from wgbs_tools_tpu_torch.parallel.mesh import shard_devices
    from wgbs_tools_tpu_torch.parallel.sharded import ShardedPileupV3
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    devs = shard_devices("cuda", n_shards=4)
    out = op.join(work, "sharded")
    os.makedirs(out)
    _zero_launches()
    t0 = time.perf_counter()
    walls = {}
    for pat, lbeta in ((big, False), (deep, False), (deep, True)):
        suff = ".lbeta" if lbeta else ".beta"
        name = op.basename(pat)[: -len(".pat.gz")]
        t1 = time.perf_counter()
        got = _launch_checked(pat2beta, pat, lbeta=lbeta, devices=devs,
                              out_path=op.join(out, name + suff))
        walls[name + suff] = time.perf_counter() - t1
        if not _same(got, op.join(work, name + ".oracle" + suff)):
            raise RuntimeError(f"sharded {name}{suff} differs from the host "
                               "oracle")
        log(f"phase 5: sharded {name}{suff} == host oracle "
            f"({walls[name + suff]:.3f} s)")
    launches = _read_launches()
    wall = walls["big.beta"] + walls["deep.beta"]
    line = (f"sharded pat2beta, 4 shards on one card: {wall:.3f} s for both "
            f"pats' .beta ({(n_frags + 200_000) / wall / 1e6:.3f} M frags/s), "
            f"big {walls['big.beta']:.3f} s; kernel launches {launches}")
    log("phase 5: " + line)
    _require_launches("phase 5", launches, ("flat_vals_add", "flat_classic"))

    # the first big slab, staged with split planes: the sharded path (the
    # split form of flat_vals_add) and the single-device accumulator (the
    # flat_vals kernel), against the default sharded path (fused planes)
    sel, _, _ = slab
    window = (1, N_SITES + 1)
    ref = ShardedPileupV3(devs, window)
    ref.add(sel)
    want = ref.result()
    _zero_launches()
    split = ShardedPileupV3(devs, window, fused=False)
    split.add(sel)
    single = PileupAccumulator(window, torch.device("cuda"), fused=False)
    single.add(sel)
    torch.cuda.synchronize()
    split_launches = _read_launches()
    for what, acc in (("sharded fused=False", split),
                      ("single-device fused=False", single)):
        if not (acc.result() == want).all():
            raise RuntimeError(f"{what} != the sharded default on the "
                               "first big slab")
    log(f"phase 5: the first big slab ({sel.nr_frags:,} frags) through the "
        "sharded and the single-device accumulator with split planes == the "
        f"sharded default; kernel launches {split_launches}")
    _require_launches("phase 5 (split planes)", split_launches,
                      ("flat_vals", "flat_vals_add"))
    return launches, split_launches, line


def _run_group(cmd, timeout):
    """Run a command in its own process group (it starts workers); on a
    timeout kill the whole group. Returns (rc, stdout, stderr)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        raise RuntimeError(f"{' '.join(cmd)} timed out after {timeout} s:\n"
                           f"{err[-3000:]}")
    return proc.returncode, out, err


def _worker_launches(stderr, n, need, what):
    """{rank: launches} from the workers' launch lines; each worker's
    `need` kernels must have launched."""
    workers = {int(m.group(1)): json.loads(m.group(2)) for m in re.finditer(
        r"\[wgbs-torch worker (\d+)\] launches (\{.*\})", stderr)}
    if sorted(workers) != list(range(n)):
        raise RuntimeError(f"{what}: expected a launch line from each of {n} "
                           f"workers, got {workers}:\n{stderr[-3000:]}")
    for r, ln in workers.items():
        _require_launches(f"{what} worker {r}", ln, need)
    return workers


def phase_procs(work, big, n_frags):
    """`pat2beta --procs 2` through the CLI, both workers on cuda:0,
    against phase 4's oracle; the same CLI without --procs beside it.
    Returns (per-worker launches, summary line)."""
    walls, workers = {}, {}
    for procs in (2, 1):
        out = op.join(work, f"procs{procs}")
        os.makedirs(out)
        cmd = [sys.executable, "-m", "wgbs_tools_tpu_torch", "pat2beta", big,
               "-o", out, "--device", "cuda"] + (
                   ["--procs", str(procs)] if procs > 1 else [])
        t0 = time.perf_counter()
        rc, _, stderr = _run_group(cmd, 600)
        walls[procs] = time.perf_counter() - t0
        if rc:
            raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n"
                               f"{stderr[-3000:]}")
        if not _same(op.join(out, "big.beta"),
                     op.join(work, "big.oracle.beta")):
            raise RuntimeError(f"pat2beta --procs {procs}: big.beta differs "
                               "from the host oracle")
        if procs > 1:
            workers = _worker_launches(stderr, procs, ("flat_vals_add",),
                                       "phase 6")
            for m in re.finditer(r"multihost pat2beta: (p\d+ (streamed|total)"
                                 r".*)", stderr):
                log("phase 6: worker " + m.group(1))
    line = (f"CLI pat2beta --procs 2 (both workers on cuda:0): "
            f"{walls[2]:.3f} s for the big pat "
            f"({n_frags / walls[2] / 1e6:.3f} M frags/s) against "
            f"{walls[1]:.3f} s for the same CLI in one process (both timed "
            f"from process start); worker launches {workers}")
    log("phase 6: big.beta == host oracle through both; " + line)
    return workers, line




PHASE7 = (("vals=False", dict(vals=False), "flat_lc"),
          ('grid="tiled"', dict(grid="tiled"), "tiled_classic"),
          ('backend="cuda_v2"', dict(backend="cuda_v2"), "tiles_v2"),
          ('backend="cuda_v1"', dict(backend="cuda_v1"), "tiles_v1"))


def phase_forms(work, big, deep, n_frags):
    """pat2beta on one device through the four other pileup forms against
    phase 4's oracle files, with the counters set to 0 just before each
    form and read just after. Returns ({kernel: (path, launches)}, summary
    line)."""
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    out = op.join(work, "forms")
    os.makedirs(out)
    launches, walls = {}, []
    for label, forms, kernel in PHASE7:
        _zero_launches()
        wall, timings = {}, {}
        for pat, lbeta in ((big, False), (deep, False), (deep, True)):
            suff = ".lbeta" if lbeta else ".beta"
            name = op.basename(pat)[: -len(".pat.gz")]
            t0 = time.perf_counter()
            # stage seconds of the big pat's run (a few synchronizes more)
            got = _launch_checked(pat2beta, pat, lbeta=lbeta, device="cuda",
                                  out_path=op.join(out, name + suff),
                                  timings=timings if pat == big else None,
                                  **forms)
            wall[name + suff] = time.perf_counter() - t0
            if not _same(got, op.join(work, name + ".oracle" + suff)):
                raise RuntimeError(f"pat2beta {label}: {name}{suff} differs "
                                   "from the host oracle")
        counts = _read_launches()
        _require_launches(f"phase 7 {label}", counts, (kernel,))
        launches[kernel] = (f"phase 7 pat2beta {label}", counts)
        line = (f"pat2beta {label}: big.beta {wall['big.beta']:.3f} s "
                f"({n_frags / wall['big.beta'] / 1e6:.3f} M frags/s; "
                + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
                + f"), deep.beta {wall['deep.beta']:.3f} s, deep.lbeta "
                f"{wall['deep.lbeta']:.3f} s")
        walls.append(line)
        log(f"phase 7: {line}; all == host oracle; kernel launches {counts}")
    return launches, "; ".join(walls)


# ---------------------------------------------------------------------------
# phase 8: segment at hg19 size, bench_segment4.py's shape
# ---------------------------------------------------------------------------

SEG_K = 3          # betas
SEG_COV = 10.0     # Poisson coverage of each beta (~30x in all)
SEG_BLOCK = 300    # sites per methylation block (p 0.15 / 0.85)
SEG_GENOME = "hg19seg"
SEG_ARGS = dict(max_cpg=1000, max_bp=2000, pcount=15.0)  # the CLI defaults
SEG_BATCH = 8      # windows per launch of segment_windows_fast


def seg_data(k=SEG_K):
    """bench_segment4.py:66-85's data at N_SITES sites, from its seed: loci
    cumsum(integers(5, 60)) + 100 (int64), then k betas (default SEG_K) of
    Poisson(SEG_COV) coverage over SEG_BLOCK-site blocks of methylation
    0.15 / 0.85 (+ N(0, 0.05), clipped to [0.01, 0.99]). Yields the loci,
    then each beta's (N_SITES, 2) int64 (meth, cov)."""
    import numpy as np

    rng = np.random.default_rng(20260821)
    yield np.cumsum(rng.integers(5, 60, size=N_SITES, dtype=np.int64)) + 100
    for _ in range(k):
        cov = rng.poisson(SEG_COV, size=N_SITES).astype(np.int64)
        p = np.clip(0.15 + 0.7 * ((np.arange(N_SITES) // SEG_BLOCK) % 2)
                    + rng.normal(0, 0.05, size=N_SITES), 0.01, 0.99)
        yield np.stack([rng.binomial(cov, p), cov], axis=1)


def write_seg_data(work, refs):
    """seg_data() on disk: one chromosome with its loci (reference
    SEG_GENOME) and SEG_K betas. Returns (beta paths, loci)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import save_beta

    data = seg_data()
    loci = next(data)
    write_cpg_index(refs, SEG_GENOME, ["chr1"], [loci], [loci[-1] + 100])
    betas = [save_beta(op.join(work, f"seg{k}.beta"), beta)
             for k, beta in enumerate(data)]
    return betas, loci.astype(np.int32)


def _blocks_of(path):
    """(startCpG, endCpG) of a blocks bed, checked to tile [1, N_SITES + 1)."""
    import numpy as np

    cols = np.loadtxt(path, dtype=np.int64, usecols=(3, 4), ndmin=2)
    s, e = cols[:, 0], cols[:, 1]
    if not (s[0] == 1 and e[-1] == N_SITES + 1 and (s[1:] == e[:-1]).all()
            and (e > s).all()):
        raise RuntimeError(f"{path}: the blocks do not tile [1, "
                           f"{N_SITES + 1})")
    return s, e


def _sm_clock_mhz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return float(out)


def _seg_closures(betas, loci, chunks, W, dev):
    """The in-block edge matrices S0 of real chunks, as the main path's
    batch gives them to maxplus_closure: (cost tensor, S0)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import load_beta
    from wgbs_tools_tpu_torch.models import segment as seg

    pms, pts = zip(*(seg._prefix_sums(np.stack([load_beta(b, sites=c)
                                                 for b in betas]))
                     for c in chunks))
    Crev = seg._cost_fast(seg._int32(np.stack(pms), dev),
                          seg._int32(np.stack(pts), dev),
                          seg._int32(np.stack([loci[s - 1:e - 1]
                                               for s, e in chunks]), dev),
                          W, SEG_ARGS["max_bp"], SEG_ARGS["pcount"])
    return Crev, seg._closure_inputs(Crev, W)[1]


def _maxplus_pairs(S0, steps):
    """The (add, max) pairs that the closure of S0 needs on this data: per
    squaring, the triples (p, r, q) with S[p, r] and S[r, q] both finite
    (a -inf term never wins the max), summed over the squarings. The
    squarings between are the twin's. On the main path S0 = I (+) A with A
    strictly upper triangular and banded (max_bp), so this is at most the
    triangle p <= r <= q, (n + 2)(n + 1)n / 6 per matrix and squaring."""
    import torch

    from wgbs_tools_tpu_torch.ops import maxplus as mp

    pairs, S = 0, S0
    for i in range(steps):
        fin = torch.isfinite(S)
        pairs += int((fin.sum(1, dtype=torch.int64)
                      * fin.sum(2, dtype=torch.int64)).sum())
        if i + 1 < steps:
            S = mp.maxplus_closure_plain(S, 1)
    return pairs

MAXPLUS_UPPER_N = (1, 2, 31, 33, 64, 65, 128, 129, 144)
MAXPLUS_EDGE = tuple(f"upper_n{n}" for n in MAXPLUS_UPPER_N) + (
    "mixed", "steps_0", "steps_1")


def _upper_band(rng, nb, n, band):
    """nb random (n, n) f32 matrices, finite only on the diagonal and in
    the band 0 < q - p <= band above it, with a fifth of those -inf
    (holes); the diagonal is 0 in even matrices, random in odd ones."""
    import numpy as np

    P, Q = np.arange(n)[:, None], np.arange(n)[None, :]
    keep = (Q > P) & (Q - P <= band)
    S = rng.normal(size=(nb, n, n)).astype(np.float32)
    S[:, ~keep] = -np.inf
    S[rng.random((nb, n, n)) < 0.2] = -np.inf
    diag = rng.normal(size=(nb, n)).astype(np.float32)
    diag[::2] = 0.0
    S[:, P[:, 0], P[:, 0]] = diag
    return S


def finite_below(S):
    """Whether a matrix of the batch S (nb, n, n) has a finite entry strictly
    below the diagonal (maxplus_closure then takes its general schedule)."""
    import torch

    below = torch.ones(S.shape[1:], dtype=torch.bool,
                       device=S.device).tril(-1)
    return bool(torch.isfinite(S[:, below]).any())


def maxplus_edge_batch(name):
    """(S0 (nb, n, n) f32 numpy, steps) for one edge case of
    maxplus_closure, from a seed:
      upper_nN   6 matrices of side N, upper triangular with a band and
                 holes (_upper_band): the kernel's upper schedule at every
                 tile remainder, N = 1 up to its NMAX of 144
      mixed      8 upper matrices of side 129 and, third in the launch,
                 one with a single finite entry below the diagonal: one
                 launch reaches both schedules
      steps_0/1  4 upper matrices of side 129, 0 and 1 squarings"""
    import numpy as np

    rng = np.random.default_rng(MAXPLUS_EDGE.index(name) + 1100)
    if name.startswith("upper_n"):
        n = int(name[len("upper_n"):])
        return _upper_band(rng, 6, n, max(1, 3 * n // 4)), 7
    if name == "mixed":
        S = _upper_band(rng, 9, 129, 100)
        S[2, 100, 40] = -0.5
        return S, 7
    return _upper_band(rng, 4, 129, 129), int(name[-1])


SEG_CUT = 8192              # sites of the two main-path windows the twin runs
SEG_WIDE = (30_000, 32_768)  # (W, sites) of the wide case, max_bp 0
SEG_SAMPLE = 16             # main-path chunks held to the host DP's T
SEG_EDGE_SITES = 3000       # sites of a hand-made edge window


def _seg_chunks():
    """The CLI's chunks of the genome: 60,000 sites each, the last ragged."""
    from wgbs_tools_tpu_torch.models import segment as seg

    b = list(range(1, N_SITES + 1, seg.DEF_CHUNK)) + [N_SITES + 1]
    return list(zip(b[:-1], b[1:]))


def _exact_inputs(datas, locis, W, max_bp, dev):
    """The kernel's inputs for equal-size windows as the route makes them
    (plan_windows's table and Wb, the narrow upload, the wrapped prefix
    sums on the card): (pm, pt, loci, tbl, Wb). Every window must be
    eligible."""
    import torch

    import numpy as np

    from wgbs_tools_tpu_torch.models import segment_exact_device as sed

    locis = np.asarray(locis, dtype=np.int64)
    elig, tbl, Wb = sed.plan_windows(datas, locis, W, max_bp,
                                     SEG_ARGS["pcount"])
    if len(elig) != len(datas):
        raise RuntimeError(f"only windows {elig} of {len(datas)} are "
                           "eligible for the device route")
    counts, loci = sed._upload(datas, locis, dev)
    pm, pt = sed._prefix_sums_wrapped(counts)
    return pm, pt, loci, torch.from_numpy(tbl).to(dev), Wb


def _exact_vs_twin(name, pm, pt, loci, tbl, Wb, max_bp):
    """segment_exact_dp against its twin on the same card tensors, tolerance
    0; returns (the kernel's ks, the twin's seconds)."""
    import torch

    from wgbs_tools_tpu_torch.ops import segment_exact as se

    got = _launch_checked(se.segment_exact_dp, pm, pt, loci, tbl, Wb, max_bp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = se.segment_exact_dp_plain(pm, pt, loci, tbl, Wb, max_bp)
    torch.cuda.synchronize()
    twin_s = time.perf_counter() - t0
    if not torch.equal(got, want):
        bad = (got != want).nonzero()[:5].tolist()
        raise RuntimeError(f"segment_exact_dp != its twin on {name}: first "
                           f"differing (window, site) {bad}")
    B, K, n1 = pm.shape
    log(f"phase 8: segment_exact_dp == twin (tolerance 0) on {name}: {B} x "
        f"{n1 - 1:,} sites, K {K}, Wb {Wb}, max_bp {max_bp}; twin "
        f"{twin_s:.3f} s")
    return got, twin_s


def _table_lookups(pt, loci, Wb, max_bp, per=8):
    """The table entries segment_exact_dp reads on these inputs: over the
    windows and datasets, the ok band cells whose total nt is above 0 (a
    cell with nt <= 0 adds +0.0 without a read). Counted on the card,
    `per` windows at a time."""
    import torch

    B, K, n1 = pt.shape
    dev = pt.device
    i = torch.arange(n1 - 1, device=dev)[:, None]
    k = i - Wb + 1 + torch.arange(Wb, device=dev)[None, :]
    kc = k.clamp(min=0)
    lookups = 0
    for lo in range(0, B, per):
        ok = (k >= 0).expand(min(per, B - lo), -1, -1)
        if max_bp:
            lw = loci[lo:lo + per].long()
            ok = ok & (lw[:, i] - lw[:, kc] <= max_bp)
        for d in range(K):
            p = pt[lo:lo + per, d].long()
            nt = (p[:, i + 1] - p[:, kc] + (1 << 31)) % (1 << 32) - (1 << 31)
            lookups += int((ok & (nt > 0)).sum())
    return lookups


def _band_cells(locis, Wb, max_bp):
    """The valid band cells (k >= 0, i - k < Wb, loci[i] - loci[k] <=
    max_bp) of the windows: the cells whose cost and sum the DP needs."""
    import numpy as np

    cells = 0
    for loci in locis:
        i = np.arange(loci.shape[0], dtype=np.int64)
        lo = np.maximum(i - Wb + 1, 0)
        if max_bp:
            lo = np.maximum(lo, np.searchsorted(loci, loci - max_bp,
                                                side="left"))
        cells += int((i - lo + 1).sum())
    return cells


def _edge_windows(betas, loci, chunks):
    """The hand-made edge cases: {name: (datas, locis, W, max_bp)}, from
    the phase's betas and loci and from a seed."""
    import numpy as np

    from wgbs_tools_tpu_torch.models.segment import _load_windows
    from wgbs_tools_tpu_torch.ops.segment_exact import dp_occupancy

    class _Idx:
        pass

    idx = _Idx()
    idx.loci = loci
    m = SEG_EDGE_SITES
    wins = [(s, s + m) for s, _ in chunks[2:4]]
    datas, locis = _load_windows(betas, wins, idx)
    rng = np.random.default_rng(20261017)
    zero = datas.copy()
    zero[:, :, 500:1500] = 0
    k8 = rng.poisson(SEG_COV, size=(2, 8, m)).astype(np.int64)
    k8 = np.stack([rng.binomial(k8, 0.6), k8], axis=3)
    sparse = rng.poisson(0.2, size=(2, SEG_K, m)).astype(np.int64)
    sparse = np.stack([rng.binomial(sparse, 0.5), sparse], axis=3)
    last, llast = _load_windows(betas, chunks[-1:], idx)
    wide = next(w for w in range(1, m)
                if dp_occupancy(w)["body"] == "single")
    return {
        f"max_bp 0, Wb {wide - 1:,} (the ahead body's widest)":
            (sparse, locis, wide - 1, 0),
        f"max_bp 0, Wb {wide:,} (the single body's narrowest)":
            (sparse, locis, wide, 0),
        "ties: 1,000 sites of zero coverage": (zero, locis, 1000, 2000),
        "K 1": (datas[:, :1], locis, 1000, 2000),
        "K 8": (k8, locis, 1000, 2000),
        "W 48": (datas, locis, 48, 2000),
        "max_bp 0, W 1000 (coverage Poisson(0.2))": (sparse, locis, 1000, 0),
        f"the ragged last window ({chunks[-1][1] - chunks[-1][0]:,} sites)":
            (last, llast, 1000, 2000),
    }


def _wide_case(loci):
    """The wide case: max_bp 0 and W SEG_WIDE[0] over SEG_WIDE[1] sites, 2
    datasets of Poisson(0.08) coverage (so that the in-band totals fit the
    table), from a seed: (data, loci, W)."""
    import numpy as np

    W, n = SEG_WIDE
    rng = np.random.default_rng(30000)
    cov = rng.poisson(0.08, size=(2, n)).astype(np.int64)
    data = np.stack([rng.binomial(cov, 0.5), cov], axis=2)
    return data, loci[:n].astype(np.int64), W


def _exact_device_checks(betas, loci, dev, launches):
    """segment_exact_dp on the card: against its twin (tolerance 0) on two
    main-path windows cut to SEG_CUT sites and on the edge cases; the
    route's T against the host DP's on SEG_SAMPLE main-path chunks (the
    ragged last one among them) and on the wide case; timed on the main
    path's batch (every full chunk, one launch, as the CLI launched it)
    beside its bound. Returns (kernels-line entry, summary)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch import _kernels, native
    from wgbs_tools_tpu_torch.models import segment_exact_device as sed
    from wgbs_tools_tpu_torch.models.segment import _load_windows
    from wgbs_tools_tpu_torch.ops import segment_exact as se

    class _Idx:
        pass

    idx = _Idx()
    idx.loci = loci
    W, max_bp, pc = SEG_ARGS["max_cpg"], SEG_ARGS["max_bp"], SEG_ARGS["pcount"]
    chunks = _seg_chunks()
    full = [c for c in chunks if c[1] - c[0] == chunks[0][1] - chunks[0][0]]
    pool = ThreadPoolExecutor(max(1, (os.cpu_count() or 2) - 1))
    # the host DP's T, in the background while the card works
    wide_data, wide_loci, wide_W = _wide_case(loci)
    wide_host = pool.submit(native.segment_exact_native, wide_data, wide_loci,
                            wide_W, 0, pc)
    sample = list(range(SEG_SAMPLE - 1)) + [len(chunks) - 1]
    sample_data = {}
    for c in sample:
        d, lo = _load_windows(betas, [chunks[c]], idx)
        sample_data[c] = (d[0], lo[0].astype(np.int64))
    sample_host = {c: pool.submit(native.segment_exact_native, d, lo,
                                  min(W, d.shape[1]), max_bp, pc)
                   for c, (d, lo) in sample_data.items()}

    # the main path's batch: every full chunk in one launch
    t0 = time.perf_counter()
    datas, locis = _load_windows(betas, full, idx)
    pm, pt, tl, tbl, Wb = _exact_inputs(datas, locis, W, max_bp, dev)
    prep_s = time.perf_counter() - t0
    ks = _launch_checked(se.segment_exact_dp, pm, pt, tl, tbl, Wb, max_bp)
    torch.cuda.synchronize()
    ms = _device_ms(lambda: se.segment_exact_dp(pm, pt, tl, tbl, Wb, max_bp),
                    3)
    call_ms = _time_ms(lambda: se.segment_exact_dp(pm, pt, tl, tbl, Wb,
                                                   max_bp), 2)
    ks_host = ks.cpu().numpy()
    B, K, n1 = pm.shape
    n = n1 - 1
    # the launch the C entry makes and its residency: one wave
    occ = se.dp_occupancy(Wb)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    if occ["ctas_per_sm"] * sms < B:
        raise RuntimeError(f"{B} windows at {occ['ctas_per_sm']} CTAs per "
                           f"SM on {sms} SMs take more than one wave")
    body_regs, body_spills = _ptxas_registers(_kernels.BUILD_LOG,
                                              SEGX_BODIES)
    lookups = _table_lookups(pt, tl, Wb, max_bp)
    cells = _band_cells(locis.astype(np.int64), Wb, max_bp)
    clock = _sm_clock_mhz()
    adds = cells * K  # K - 1 across the datasets, 1 with M
    t_ops = adds / (132 * 64 * clock * 1e6)
    n_bytes = (pm.numel() + pt.numel() + tl.numel() + ks.numel()) * 4 \
        + tbl.numel() * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"phase 8: segment_exact_dp on the main path's batch ({B} windows "
        f"of {n:,} sites, K {K}, Wb {Wb}, table {tbl.numel():,} entries; "
        f"loaded and staged in {prep_s:.3f} s): kernel {ms:.4f} ms on the "
        f"card ({call_ms:.4f} ms per call); bound {bound_ms:.4f} ms "
        f"({bound_by}) = max({cells:,} valid band cells x {K} float64 adds "
        f"/ (132 SMs x 64 FP64 lanes x {clock:.0f} MHz clocks.max.sm) = "
        f"{1e3 * t_ops:.4f} ms, {n_bytes:,} bytes / 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms); the kernel at {100 * bound_ms / ms:.2f} % "
        f"of it; the chain: {n:,} steps at {1e6 * ms / n:.1f} ns per step; "
        f"{lookups:,} table lookups ({lookups / (ms * 1e6):.1f} G/s); "
        f"launch {occ}; ptxas registers {body_regs}, spill bytes "
        f"{body_spills}")
    del pm, pt, tl, ks, datas

    # kernel == twin: two main-path windows cut to SEG_CUT sites (timed on
    # both), then the edge cases
    cut = [(s, s + SEG_CUT) for s, _ in chunks[:2]]
    cd, cl = _load_windows(betas, cut, idx)
    cpm, cpt, ctl, ctbl, cWb = _exact_inputs(cd, cl, W, max_bp, dev)
    cks, twin_s = _exact_vs_twin(f"2 main-path windows cut to {SEG_CUT:,} "
                                 "sites", cpm, cpt, ctl, ctbl, cWb, max_bp)
    cut_ms = _device_ms(lambda: se.segment_exact_dp(cpm, cpt, ctl, ctbl, cWb,
                                                    max_bp), 3)
    # the same prefix sums shifted by one constant so that dataset 0's
    # total crosses 2^31 at site SEG_CUT / 2 of window 0: the differences,
    # and so ks, do not change
    shift = (1 << 31) - int(cpt[0, 0, SEG_CUT // 2])

    def shifted(p):
        x = p.to(torch.int64) + shift
        return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)

    spm, spt = shifted(cpm), shifted(cpt)
    if not (int(spt[0, 0, 0]) > 0 > int(spt[0, 0, -1])):
        raise RuntimeError("the shifted prefix sums do not cross 2^31")
    sks, _ = _exact_vs_twin("the cut windows, prefix sums shifted across "
                            "2^31", spm, spt, ctl, ctbl, cWb, max_bp)
    if not torch.equal(sks, cks):
        raise RuntimeError("shifting the prefix sums changed ks")
    del cpm, cpt, spm, spt
    last_T = None
    bodies = {se.dp_occupancy(cWb)["body"]}
    for name, (d, lo, w, mbp) in _edge_windows(betas, loci, chunks).items():
        epm, ept, etl, etbl, eWb = _exact_inputs(d, lo, min(w, d.shape[2]),
                                                 mbp, dev)
        body = se.dp_occupancy(eWb)["body"]
        bodies.add(body)
        eks, _ = _exact_vs_twin(f"{name} [{body} body]", epm, ept, etl, etbl,
                                eWb, mbp)
        if name.startswith("the ragged"):
            last_T = np.concatenate([[0], eks[0].cpu().numpy()])
    if bodies != {"ahead", "single"}:
        raise RuntimeError(f"the twin checks reached only {bodies}")

    # the route's T against the host DP's: SEG_SAMPLE chunks (the ragged
    # last one from its edge case) and the wide case (Wb above SMEM_RING)
    for c in sample:
        T = (np.concatenate([[0], ks_host[c]]) if c < len(full) else last_T)
        if not np.array_equal(T[1:], sample_host[c].result()[1:]):
            raise RuntimeError(f"segment_exact_dp's T != the host DP's on "
                               f"chunk {chunks[c]}")
    log(f"phase 8: segment_exact_dp's T == the host DP's on {len(sample)} "
        f"main-path chunks (0-{SEG_SAMPLE - 2} and the ragged last)")
    before = se.segment_exact_dp.launches
    t0 = time.perf_counter()
    wide_T = sed.segment_exact_device_T(wide_data, wide_loci, wide_W, 0, pc,
                                        device=dev)
    wide_s = time.perf_counter() - t0
    if wide_T is None or se.segment_exact_dp.launches != before + 1:
        raise RuntimeError("the wide case did not take the kernel")
    want = wide_host.result()
    pool.shutdown()
    if not np.array_equal(wide_T[1:], want[1:]):
        raise RuntimeError("segment_exact_dp's T != the host DP's on the "
                           "wide case")
    log(f"phase 8: segment_exact_device_T == the host DP's T on the wide "
        f"case (max_bp 0, W {wide_W:,} over {SEG_WIDE[1]:,} sites, ring in "
        f"global memory): {wide_s:.3f} s on the card")
    res = {"max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
           "plain_ms": 1e3 * twin_s,
           "plain_on": f"2 windows x {SEG_CUT} sites",
           "kernel_ms_on_plain_inputs": cut_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "library_ms": None, "windows": B,
           "sites": n, "K": K, "Wb": Wb, "band_cells": cells,
           "float64_adds": adds, "bytes": n_bytes, "sm_clock_mhz": clock,
           "ns_per_step": 1e6 * ms / n,
           "ns_per_step_cut_windows": 1e6 * cut_ms / SEG_CUT,
           "table_lookups": lookups, "launch": occ,
           "registers_by_body": body_regs, "spills_by_body": body_spills,
           "launches_per_job": launches["segment_exact_dp"]}
    line = (f"segment_exact_dp {ms:.4f} ms per launch on {B} windows "
            f"({1e6 * ms / n:.1f} ns per step of {n:,}; {occ['body']} body, "
            f"{occ['ctas_per_sm']} CTAs per SM, registers {body_regs}), bound "
            f"{bound_ms:.4f} ms ({bound_by}), twin {1e3 * twin_s:.1f} ms on "
            f"{SEG_CUT:,} x 2 sites (kernel {cut_ms:.4f} ms there, "
            f"{1e6 * cut_ms / SEG_CUT:.1f} ns per step)")
    return res, line



def phase_segment(work, regs):
    """segment at hg19 size through the port's CLI: exact mode on the host
    cores and on the card, fast mode on the card (launch counters set to 0
    just before each device run and read just after), the two exact beds'
    identity and the fast/exact border agreement, the max-plus kernel
    against its twin on real and hand-made closures and timed beside its
    bound, the fast DP's T on the card against the CPU's on one real chunk,
    and the exact kernel's checks (_exact_device_checks). Returns ({kernel:
    results}, {kernel: launches of its run}, summary line, {what phase 9
    reads: the betas, loci and flags, the three beds, the fast run's
    borders of the full chunks and the in-process walls})."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.cli import cmd_segment
    from wgbs_tools_tpu_torch.cli.main import main as cli_main
    from wgbs_tools_tpu_torch.models import segment as seg
    from wgbs_tools_tpu_torch.models import segment_exact_device as sed
    from wgbs_tools_tpu_torch.ops import maxplus as mp

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    betas, loci = write_seg_data(work, os.environ["WGBS_TPU_REFDIR"])
    log(f"phase 8: wrote {SEG_K} betas over {N_SITES:,} sites (Poisson "
        f"{SEG_COV} coverage each, {SEG_BLOCK}-site blocks) and genome "
        f"{SEG_GENOME} in {time.perf_counter() - t0:.3f} s")
    flags = ["--max_cpg", str(SEG_ARGS["max_cpg"]), "--max_bp",
             str(SEG_ARGS["max_bp"]), "-p", str(SEG_ARGS["pcount"])]
    base = ["--betas"] + betas + ["--genome", SEG_GENOME] + flags

    exact_bed = op.join(work, "exact.bed")
    t0 = time.perf_counter()
    if cli_main(["segment"] + base + ["--device", "cpu", "-o", exact_bed]):
        raise RuntimeError("segment --mode exact CLI failed")
    exact_wall = time.perf_counter() - t0
    es, ee = _blocks_of(exact_bed)
    log(f"phase 8: CLI segment --mode exact --device cpu on the host ({os.cpu_count()} "
        f"threads): {exact_wall:.3f} s, {len(es):,} blocks tiling "
        f"[1, {N_SITES + 1:,})")

    # exact mode on the card (the CLI's defaults: --mode exact, --device
    # cuda), the counters set to 0 just before and read just after: the host
    # run's bytes
    dev_bed = op.join(work, "exact_dev.bed")
    ex_timings = {}
    host0 = sed.segment_exact_device_batch.host_windows
    _zero_launches()
    t0 = time.perf_counter()
    if cmd_segment.main(base + ["-o", dev_bed], timings=ex_timings):
        raise RuntimeError("segment --mode exact on the card: CLI failed")
    dev_wall = time.perf_counter() - t0
    ex_launches = _read_launches()
    _require_launches("phase 8 exact on the card", ex_launches,
                      ("segment_exact_dp",))
    host_windows = sed.segment_exact_device_batch.host_windows - host0
    if host_windows:
        raise RuntimeError(f"{host_windows} windows of the exact device run "
                           "went to the host")
    if not _same(dev_bed, exact_bed):
        raise RuntimeError("segment --mode exact on the card: the bed "
                           "differs from the host run's")
    ex_stages = ", ".join(f"{k} {v:.3f}" for k, v in ex_timings.items())
    log(f"phase 8: CLI segment --mode exact on the card "
        f"(the defaults, --device cuda): {dev_wall:.3f} s "
        f"({ex_stages}; each device stage synchronized), bed byte-identical "
        f"to the host run's ({op.getsize(dev_bed):,} bytes); host windows "
        f"{host_windows}; kernel launches {ex_launches}")

    fast_bed = op.join(work, "fast.bed")
    timings = {}
    # phase 9 holds segment_windows_sharded to this run's borders of the
    # full chunks (the one group of DEF_CHUNK-site windows)
    fast_chunks = {}
    windows_fast = seg.segment_windows_fast

    def recording(datas, locis, *args, **kw):
        out = windows_fast(datas, locis, *args, **kw)
        if datas.shape[2] == seg.DEF_CHUNK:
            fast_chunks[datas.shape[0]] = out
        return out

    _zero_launches()
    seg.segment_windows_fast = recording
    t0 = time.perf_counter()
    try:
        if cmd_segment.main(base + ["--mode", "fast", "--device", "cuda",
                                    "-o", fast_bed], timings=timings):
            raise RuntimeError("segment --mode fast CLI failed")
    finally:
        seg.segment_windows_fast = windows_fast
    fast_wall = time.perf_counter() - t0
    launches = _read_launches()
    _require_launches("phase 8", launches, ("maxplus_closure",))
    fs, fe = _blocks_of(fast_bed)
    exact_b = np.union1d(es, ee)
    share = np.intersect1d(exact_b, np.union1d(fs, fe)).size / exact_b.size
    stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    log(f"phase 8: CLI segment --mode fast --device cuda: {fast_wall:.3f} s "
        f"({stages}; each device stage synchronized), {len(fs):,} blocks "
        f"tiling [1, {N_SITES + 1:,}); kernel launches {launches}")
    log(f"phase 8: fast mode finds {share:.4%} of exact mode's "
        f"{exact_b.size:,} borders")
    if share < 0.95:
        raise RuntimeError(f"fast mode found {share:.4%} of the exact "
                           "borders, under 0.95")

    # the kernel against its twin: the main path's batch of SEG_BATCH real
    # chunks (60,000 sites, W = 1000: 469 blocks each), then hand-made
    # edges: all -inf off the diagonal; W < B; a ragged last block
    W = SEG_ARGS["max_cpg"]
    chunk = seg.DEF_CHUNK
    chunks = [(1 + i * chunk, 1 + (i + 1) * chunk) for i in range(SEG_BATCH)]
    Crev, S0 = _seg_closures(betas, loci, chunks, W, dev)
    steps = int(np.ceil(np.log2(seg.BLOCK)))
    n = seg.BLOCK + 1
    edge = torch.full((4, n, n), float("-inf"), device=dev)
    edge[:, torch.arange(n), torch.arange(n)] = 0.0
    cases = {"batch": S0, "all -inf off the diagonal": edge,
             "W 64 < B": _seg_closures(betas, loci, chunks[:1], 64, dev)[1],
             "ragged (1,000 sites)": seg._closure_inputs(
                 Crev[:1, :1000].contiguous(), W)[1]}
    cases = {name: (S, steps) for name, S in cases.items()}
    for name in MAXPLUS_EDGE:
        S, k = maxplus_edge_batch(name)
        cases[name] = (torch.from_numpy(S).to(dev), k)
    for name, (S, k) in cases.items():
        got = _launch_checked(mp.maxplus_closure, S, k)
        torch.cuda.synchronize()
        want = mp.maxplus_closure_plain(S, k)
        if not torch.equal(got, want):
            err = float((got - want).abs().nan_to_num(0.0).max())
            raise RuntimeError(f"maxplus_closure != its twin on {name}: "
                               f"max_abs_err {err}")
        log(f"phase 8: maxplus_closure == twin (tolerance 0) on {name}: "
            f"{S.shape[0]:,} matrices of {S.shape[1]} x {S.shape[1]}, {k} "
            "squarings")
    # the timed batch takes the upper schedule: nothing finite below the
    # diagonal
    if finite_below(S0):
        raise RuntimeError("the batch's S0 has a finite entry below the "
                           "diagonal: the timed launch would not take the "
                           "upper schedule")
    nb = S0.shape[0]
    ms = _device_ms(lambda: mp.maxplus_closure(S0, steps), 5)
    call_ms = _time_ms(lambda: mp.maxplus_closure(S0, steps), 5)
    plain_ms = _time_ms(lambda: mp.maxplus_closure_plain(S0, steps), 1)
    pairs = _maxplus_pairs(S0, steps)
    tri = nb * steps * (n + 2) * (n + 1) * n // 6
    scanned = nb * steps * mp.upper_pairs(n)
    clock = _sm_clock_mhz()
    ops = 2 * pairs
    t_ops = ops / (132 * 128 * clock * 1e6)
    n_bytes = 2 * nb * n * n * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"phase 8: maxplus_closure on the batch ({nb:,} matrices, {steps} "
        f"squarings): kernel {ms:.4f} ms on the card ({call_ms:.4f} ms per "
        f"call), twin {plain_ms:.4f} ms; bound {bound_ms:.4f} ms "
        f"({bound_by}) = {pairs:,} (add, max) pairs with both terms finite "
        f"x 2 instructions / (132 SMs x 128 FP32 lanes x {clock:.0f} MHz "
        f"clocks.max.sm) [the triangle p <= r <= q: {tri:,} pairs; the "
        f"dense square: {nb * steps * n ** 3:,}; what the kernel's upper "
        f"schedule scans, 4 x 4 tiles over their r ranges: {scanned:,} "
        f"({scanned / tri:.4f}x the triangle); the general schedule "
        f"scans {mp.NMAX} x {mp.NMAX} outputs x {n} r: "
        f"{nb * steps * mp.NMAX ** 2 * n:,}; bytes {n_bytes:,} / 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms]; the kernel at "
        f"{100 * bound_ms / ms:.1f} % of it; ptxas registers "
        f"{regs.get('maxplus_closure')}")
    if scanned > 1.3 * tri:
        raise RuntimeError(f"the upper schedule scans {scanned:,} pairs, "
                           f"over 1.3x the triangle's {tri:,}")

    # the fast DP's T on the card against the CPU's (the twin's closures)
    # on one real chunk, fed the same cost tensor
    t_dev = seg._dp_fast_blocked(Crev[0], W).cpu()
    t0 = time.perf_counter()
    t_cpu = seg._dp_fast_blocked(Crev[0].cpu(), W)
    cpu_s = time.perf_counter() - t0
    if not torch.equal(t_dev, t_cpu):
        raise RuntimeError("the fast DP's T on the card != the CPU's on "
                           f"chunk {chunks[0]}")
    log(f"phase 8: fast DP T on the card == on the CPU for chunk "
        f"{chunks[0]} ({chunk:,} sites, W {W}; the CPU took {cpu_s:.3f} s)")
    del Crev, S0, cases
    torch.cuda.empty_cache()
    ex_res, ex_line = _exact_device_checks(betas, loci, dev, ex_launches)
    torch.cuda.empty_cache()
    res = {"max_abs_err": 0.0, "ms": ms, "call_ms": call_ms,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": None, "pairs": pairs, "triangle_pairs": tri,
           "scanned_pairs": scanned,
           "matrices": nb,
           "squarings": steps, "sm_clock_mhz": clock, "bytes": n_bytes}
    line = (f"segment at {N_SITES:,} sites, {SEG_K} betas: exact (host) "
            f"{exact_wall:.3f} s, {len(es):,} blocks; exact (cuda) "
            f"{dev_wall:.3f} s ({ex_stages}), the same bytes; fast (cuda) "
            f"{fast_wall:.3f} s ({stages}), {len(fs):,} blocks; fast finds "
            f"{share:.4%} of exact's borders; maxplus_closure launches "
            f"{launches['maxplus_closure']}, segment_exact_dp launches "
            f"{ex_launches['segment_exact_dp']}; {ex_line}")
    if len(fast_chunks) != 1:
        raise RuntimeError(f"expected one group of {seg.DEF_CHUNK:,}-site "
                           f"chunks in the fast run, got "
                           f"{sorted(fast_chunks)}")
    seg_out = {"betas": betas, "loci": loci, "flags": flags,
               "exact_bed": exact_bed, "dev_bed": dev_bed,
               "fast_bed": fast_bed, "fast_chunks": fast_chunks.popitem()[1],
               "walls": {"exact": dev_wall, "fast": fast_wall}}
    return {"maxplus_closure": res, "segment_exact_dp": ex_res}, \
        {"maxplus_closure": launches, "segment_exact_dp": ex_launches}, \
        line, seg_out


# ---------------------------------------------------------------------------
# phase 9: the parallel layer at hg19 size
# ---------------------------------------------------------------------------

PAR_MESH = (2, 2)      # (samples, sites): the dry run's rule for 4 devices
PAR_K = 4              # samples
PAR_W, PAR_HALO, PAR_MAX_BP, PAR_PC = 64, 32, 2000, 15.0  # entry()'s W
PAR_PREFIX = 1_000_000  # ks entries of each chain held to the host scan
PAR_CUT = 8192          # sites of the two windows the twin runs
PAR_MEM_MAX = 60e9      # bytes of device memory the step may peak at
CHAIN_CYCLES = 8        # dp_scan's floor a step: an add, then a compare
DPS_EDGE_SEED = 14


def _load_frags(pat):
    """Every fragment of a pat, (start, length, count, codes) with codes
    '.'-padded to MAX_LEN columns."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.pat import iter_pat

    parts = list(iter_pat(pat))
    codes = np.full((sum(p.nr_frags for p in parts), MAX_LEN), 3, np.uint8)
    pos = 0
    for p in parts:
        codes[pos:pos + p.nr_frags, :p.codes.shape[1]] = p.codes
        pos += p.nr_frags
    return (np.concatenate([p.start for p in parts]),
            np.concatenate([p.length for p in parts]),
            np.concatenate([p.count for p in parts]), codes)


def scan_numpy(C, W):
    """The serial DP in numpy on the host, the plain reference of dp_scan's
    chains: C (n, W) f32 -> ks (n,) int32, f32 adds and np.argmax's first
    maximum, JAX's _dp_scan step by step."""
    import numpy as np

    n = C.shape[0]
    M = np.full(n + W + 1, -np.inf, np.float32)
    M[W] = 0.0
    ks = np.empty(n, np.int64)
    for i in range(n):
        cand = M[i + 1:i + 1 + W] + C[i]
        am = int(np.argmax(cand))
        M[W + i + 1] = cand[am]
        ks[i] = i - (W - 1) + am
    return ks.astype(np.int32)


def dp_body_edges(n=100, w_max=5000):
    """The widths at which dp_scan's C entry starts each body after the
    first (dp_plan over W = 1 .. w_max), checked to come in BODIES' order."""
    from wgbs_tools_tpu_torch.ops import dp_scan as dps

    bodies = [dps.dp_plan(n, W)["body"] for W in range(1, w_max + 1)]
    edges = [W for W in range(2, w_max + 1) if bodies[W - 1] != bodies[W - 2]]
    if [bodies[0]] + [bodies[W - 1] for W in edges] != list(dps.BODIES):
        raise RuntimeError(f"dp_scan's bodies by W: {bodies[0]} then "
                           f"{[(W, bodies[W - 1]) for W in edges]}, want "
                           f"{dps.BODIES} in order")
    return edges


def dp_edge_batch(edges):
    """(name, C (nb, n, W) f32) cases for dp_scan on each body, made from
    DPS_EDGE_SEED: rows of -inf, exact ties, NaN, signed zeros, +inf in the
    first W steps (-inf + +inf is NaN), the oldest and newest candidates
    tied, n < W, n not a multiple of 32 (the push body's stage rows), nb 1
    and 3, W 1, 2, 3, 31-33, 63-65, and W on both sides of each body's
    threshold (`edges`)."""
    import numpy as np

    rng = np.random.default_rng(DPS_EDGE_SEED)
    neg = np.float32(-np.inf)

    def normal(nb, n, W):
        C = rng.normal(size=(nb, n, W)).astype(np.float32)
        C[:, :, ::5] = np.round(C[:, :, ::5])  # ties
        return C

    cases = []
    C = normal(3, 120, 16)
    C[0, 40:44] = neg
    C[1] = np.round(C[1])
    C[2, 50:60, ::2] = -1.0
    cases.append(("nb 3, -inf rows, ties", C))
    C = normal(1, 60, 40)
    C[0, 30, 7] = C[0, 45, [3, 9]] = np.nan
    cases.append(("NaN", C))
    C = np.zeros((1, 50, 33), np.float32)
    C[0, ::3] = -0.0
    cases.append(("signed zeros", C))
    C = normal(2, 40, 12)
    C[0, 2, 1] = np.inf
    C[1, :12, ::4] = np.inf
    cases.append(("+inf in the first W steps", C))
    for W in (6, 64):
        C = np.full((1, 150, W), neg, np.float32)
        C[0, :, 0] = C[0, :, W - 1] = 0.0
        C[0, 1::2, 0] = -0.0
        cases.append((f"oldest and newest tie, W {W}", C))
    for W in (1, 2, 3, 31, 32, 33, 63, 64, 65):
        cases.append((f"W {W}, nb 1, n 77", normal(1, 77, W)))
        cases.append((f"W {W}, nb 3, n < W", normal(3, W // 2 + 1, W)))
    for e in edges:
        for W in (e - 1, e):
            cases.append((f"W {W} (threshold {e})", normal(2, 45, W)))
    return cases


def _dp_edges_vs_twin(edges):
    """dp_scan on the card == its twin on dp_edge_batch, tolerance 0, each
    case's body asked of the C entry; fails unless every body was held.
    Returns {body: cases}."""
    import torch

    from wgbs_tools_tpu_torch.ops import dp_scan as dps

    held = {}
    for name, C in dp_edge_batch(edges):
        W = C.shape[2]
        body = dps.dp_plan(C.shape[1], W)["body"]
        Ct = torch.from_numpy(C).cuda()
        got = dps.dp_scan(Ct, W)
        want = dps.dp_scan_plain(Ct, W)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = (got != want).nonzero()[:5].tolist()
            raise RuntimeError(f"dp_scan ({body} body) != its twin on the "
                               f"edge case {name!r} at {bad}")
        held[body] = held.get(body, 0) + 1
    if set(held) != set(dps.BODIES):
        raise RuntimeError(f"dp_scan's edge batch held only {held} to the "
                           f"twin, want every body of {dps.BODIES}")
    return held


def _analysis_step(big, dev, clock):
    """The analysis step at N_SITES sites on a PAR_MESH mesh of stand-in
    devices on the card, checked: counts against the host pileup of the
    same fragments, the coverage pair against the int64 sum, each chain's
    first PAR_PREFIX ks against scan_numpy on the same cost rows, dp_scan
    against its twin on two windows cut to PAR_CUT sites. Returns
    (dp_scan's results, launches of the step's run, summary line)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch import _kernels, native
    from wgbs_tools_tpu_torch.models import segment as seg
    from wgbs_tools_tpu_torch.ops import dp_scan as dps
    from wgbs_tools_tpu_torch.parallel.mesh import make_mesh
    from wgbs_tools_tpu_torch.parallel.sharded import (AnalysisStep,
                                                       bucket_fragments,
                                                       decode_sum64)

    a, b = PAR_MESH
    S, W = N_SITES // b, PAR_W
    t0 = time.perf_counter()
    frags = _load_frags(big)
    data = seg_data(PAR_K)
    loci = next(data).astype(np.int32)
    sample_counts = np.stack([d.astype(np.int32) for d in data])
    del data
    log(f"phase 9: loaded {frags[0].shape[0]:,} fragments of the big pat and "
        f"made {PAR_K} samples of {N_SITES:,} sites (phase 8's generator, "
        f"seed and loci) in {time.perf_counter() - t0:.3f} s")
    timings = {}
    t0 = time.perf_counter()
    bucket = bucket_fragments(*frags, N_SITES, b)
    timings["bucket"] = time.perf_counter() - t0
    mesh = make_mesh(a * b, samples_axis=a, device="cuda")
    step = AnalysisStep(mesh, N_SITES, PAR_HALO, W, PAR_MAX_BP, PAR_PC,
                        timings=timings)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = time.perf_counter()
    counts, tb, lo, f = step(*bucket, sample_counts, loci)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated()
    _require_launches("phase 9 analysis step", launches,
                      ("tiles_v1", "dp_scan"))
    plan = dps.dp_plan(S, W)
    if plan["body"] != "push":
        raise RuntimeError(f"dp_scan took its {plan['body']} body on the "
                           f"step's chains (W {W}), not the push body")
    t0 = time.perf_counter()
    counts_h, tb_h = counts.cpu().numpy(), tb.cpu().numpy()
    timings["fetch"] = time.perf_counter() - t0
    del bucket, counts, tb
    stages = ", ".join(f"{k} {v:.3f}" for k, v in timings.items())
    log(f"phase 9: AnalysisStep on a {dict(mesh.shape)} mesh of stand-ins "
        f"for cuda:0, {N_SITES:,} sites (2 chains of {S:,}), W {W}, halo "
        f"{PAR_HALO}, max_bp {PAR_MAX_BP}, pc {PAR_PC}: {step_s:.3f} s "
        f"({stages}; each device stage synchronized); peak device memory "
        f"{peak / 1e9:.3f} GB; kernel launches {launches}")
    if peak > PAR_MEM_MAX:
        raise RuntimeError(f"the analysis step peaked at {peak / 1e9:.3f} "
                           f"GB of device memory, over {PAR_MEM_MAX / 1e9} GB")

    t0 = time.perf_counter()
    oracle = native.pileup_native(*frags, 1, N_SITES)
    if not np.array_equal(counts_h, oracle):
        raise RuntimeError("the analysis step's counts differ from the host "
                           "pileup of the same fragments")
    total = int(oracle[:, 1].sum())
    if decode_sum64(lo, f) != total:
        raise RuntimeError(f"decode_sum64 gives {decode_sum64(lo, f)}, the "
                           f"coverage sums to {total}")
    del frags, oracle
    log(f"phase 9: counts == the host pileup (native.pileup_native) at "
        f"{N_SITES:,} sites; decode_sum64 == the int64 coverage sum "
        f"{total:,} (lo {int(lo)}, f {float(f)!r}); "
        f"{time.perf_counter() - t0:.3f} s")

    # the chains' cost again (the step frees it): the same functions on the
    # same inputs; dp_scan on it timed with CUDA events gives the step's ks
    sc = torch.from_numpy(sample_counts)
    lt = torch.from_numpy(loci)
    cost = torch.empty((b, S, W), dtype=torch.float32, device=dev)
    for j in range(b):
        step._cost(cost[j], j, sc, lt)
    del sc
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    ks = dps.dp_scan(cost, W)
    ev[1].record()
    torch.cuda.synchronize()
    ms = ev[0].elapsed_time(ev[1])
    if not np.array_equal(ks.cpu().numpy().reshape(-1), tb_h):
        raise RuntimeError("dp_scan on the rebuilt cost != the step's tb")
    # each chain's first PAR_PREFIX entries against the plain reference
    # on the host (the recurrence is causal), and how many of them the
    # blocked DP shares (it sums a path's costs in another order)
    shared = []
    t0 = time.perf_counter()
    for j in range(b):
        prefix = cost[j, :PAR_PREFIX].contiguous()
        want = scan_numpy(prefix.cpu().numpy(), W)
        got = tb_h[j * S:j * S + PAR_PREFIX]
        if not np.array_equal(got, want):
            bad = np.flatnonzero(got != want)
            raise RuntimeError(f"chain {j}: dp_scan's ks differ from the host "
                               f"scan at {bad.size} of {PAR_PREFIX:,} sites, "
                               f"first {bad[:5].tolist()}")
        blocked = seg._dp_fast_blocked(prefix, W)[1:].cpu().numpy()
        shared.append(int((blocked == want).sum()))
    scan_s = time.perf_counter() - t0
    log(f"phase 9: each chain's first {PAR_PREFIX:,} ks == scan_numpy "
        f"(host, numpy f32) bit for bit; _dp_fast_blocked on the card "
        f"agrees at {shared} of them (a path's costs summed in another "
        f"order move near-ties); {scan_s:.3f} s")

    cut = cost[:, :PAR_CUT].contiguous()
    del cost
    torch.cuda.empty_cache()
    got = dps.dp_scan(cut, W)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dps.dp_scan_plain(cut, W)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    if not torch.equal(got, want):
        raise RuntimeError("dp_scan != its twin on the two cut windows")
    cut_ms = _time_ms(lambda: dps.dp_scan(cut, W), 5)
    del cut
    t0 = time.perf_counter()
    edges = dp_body_edges()
    held = _dp_edges_vs_twin(edges)
    log(f"phase 9: dp_scan == twin (tolerance 0) on {sum(held.values())} "
        f"edge cases, by body {held} (each body from W "
        f"{[1] + edges}); {time.perf_counter() - t0:.3f} s")
    n_bytes = b * S * (W + 1) * 4
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_chain = S * CHAIN_CYCLES / (clock * 1e6)
    t_ops = b * S * W / OPS_PER_S
    bound_ms = 1e3 * max(t_bytes, t_chain, t_ops)
    bound_by = "bytes" if t_bytes >= max(t_chain, t_ops) else "operations"
    log(f"phase 9: dp_scan == twin (tolerance 0) on 2 windows cut to "
        f"{PAR_CUT:,} sites: kernel {cut_ms:.4f} ms "
        f"({1e6 * cut_ms / PAR_CUT:.1f} ns per step), twin "
        f"{plain_ms:.3f} ms")
    res = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
           "plain_on": f"2 x {PAR_CUT} sites", "cut_ms": cut_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
           "bytes": n_bytes, "bytes_ms": 1e3 * t_bytes,
           "chain_floor_ms": 1e3 * t_chain, "chains": b, "steps": S,
           "ns_per_step": 1e6 * ms / S, "sm_clock_mhz": clock,
           "body": plan["body"], "smem": plan["smem"],
           "chain_floor_share": t_chain * 1e3 / ms, "edge_cases": held}
    regs, spills = _ptxas_registers(_kernels.BUILD_LOG, DPS_BODIES)
    res["registers_by_body"], res["spill_bytes_by_body"] = regs, spills
    log(f"phase 9: dp_scan on the step's chains (2 x {S:,} steps, W {W}, one "
        f"launch of its {plan['body']} body, {plan['threads']} threads and "
        f"{plan['smem']:,} B of shared memory a chain; ptxas registers by "
        f"body {regs}, spill bytes {spills}): {ms:.3f} ms "
        f"({1e6 * ms / S:.1f} ns per step, "
        f"{100 * t_chain * 1e3 / ms:.2f} % of the chain floor); bound "
        f"{bound_ms:.4f} ms ({bound_by}: the chain floor {S:,} steps x "
        f"{CHAIN_CYCLES} cycles (an add and a compare) / {clock:.0f} MHz = "
        f"{1e3 * t_chain:.4f} ms; bytes {n_bytes:,} / 3.35 TB/s = "
        f"{1e3 * t_bytes:.4f} ms; adds {b * S * W:,} / 67 T/s = "
        f"{1e3 * t_ops:.4f} ms); the kernel at {100 * bound_ms / ms:.2f} % "
        f"of it")
    line = (f"analysis step at {N_SITES:,} sites ({dict(mesh.shape)} mesh on "
            f"cuda:0): {step_s:.3f} s ({stages}), peak {peak / 1e9:.3f} GB; "
            f"dp_scan {ms:.3f} ms ({1e6 * ms / S:.1f} ns per step)")
    return res, launches, line


def _procs_segment(work, seg_out):
    """`segment --procs 2` through the CLI (both ranks on cuda:0), exact
    and fast, each bed against phase 8's one-process bed. Returns the
    summary line."""
    walls, lines = {}, []
    base = (["--betas"] + seg_out["betas"] + ["--genome", SEG_GENOME]
            + seg_out["flags"] + ["--device", "cuda", "--procs", "2"])
    for mode, want, kernel in (("exact", seg_out["dev_bed"],
                                "segment_exact_dp"),
                               ("fast", seg_out["fast_bed"],
                                "maxplus_closure")):
        bed = op.join(work, f"procs_{mode}.bed")
        cmd = [sys.executable, "-m", "wgbs_tools_tpu_torch", "segment"] + \
            base + ["--mode", mode, "-o", bed]
        t0 = time.perf_counter()
        rc, _, stderr = _run_group(cmd, 900)
        walls[mode] = time.perf_counter() - t0
        if rc:
            raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n"
                               f"{stderr[-3000:]}")
        if not _same(bed, want):
            raise RuntimeError(f"segment --procs 2 --mode {mode}: the bed "
                               "differs from phase 8's one-process bed")
        workers = _worker_launches(stderr, 2, (kernel,), f"phase 9 segment "
                                   f"--procs 2 --mode {mode}")
        for m in re.finditer(r"multihost segment: (p\d .*)", stderr):
            log(f"phase 9: --mode {mode} worker {m.group(1)}")
        lines.append(f"--mode {mode} {walls[mode]:.3f} s from process start "
                     f"(phase 8's one process, in-process: "
                     f"{seg_out['walls'][mode]:.3f} s), worker launches "
                     f"{workers}")
        log(f"phase 9: CLI segment --procs 2 --mode {mode} (both ranks on "
            f"cuda:0): the bed == phase 8's one-process bed; {lines[-1]}")
    return "segment --procs 2: " + "; ".join(lines)


def phase_parallel(work, big, seg_out):
    """Phase 9: the analysis step at hg19 size, segment_windows_sharded on
    phase 8's chunks over 4 stand-in shards, segment --procs 2, and
    flagship.entry() / dryrun_multichip(4) on the card. Returns ({kernel:
    results}, {kernel: launches of its run}, summary line)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch import flagship, native
    from wgbs_tools_tpu_torch.models import segment as seg
    from wgbs_tools_tpu_torch.parallel.mesh import make_mesh
    from wgbs_tools_tpu_torch.parallel.sharded import (
        _segment_cost_local, segment_windows_sharded)

    dev = torch.device("cuda")
    clock = _sm_clock_mhz()
    res, launches, step_line = _analysis_step(big, dev, clock)
    torch.cuda.empty_cache()

    # phase 8's full chunks over 4 stand-in shards of the card
    chunk = seg.DEF_CHUNK
    want = seg_out["fast_chunks"]
    chunks = [(1 + i * chunk, 1 + (i + 1) * chunk) for i in range(len(want))]

    class _Index:
        loci = seg_out["loci"]

    datas, locis = seg._load_windows(seg_out["betas"], chunks, _Index)
    timings = {}
    _zero_launches()
    t0 = time.perf_counter()
    got = segment_windows_sharded(
        make_mesh(4, device="cuda"), datas, locis, SEG_ARGS["max_cpg"],
        SEG_ARGS["max_bp"], SEG_ARGS["pcount"], timings=timings)
    win_wall = time.perf_counter() - t0
    win_launches = _read_launches()
    _require_launches("phase 9 segment_windows_sharded", win_launches,
                      ("maxplus_closure",))
    del datas, locis
    diff = [i for i, (g, w) in enumerate(zip(got, want))
            if not np.array_equal(g, w)]
    if len(got) != len(want) or diff:
        raise RuntimeError(f"segment_windows_sharded differs from phase 8's "
                           f"fast run at windows {diff[:5]} (of {len(want)})")
    win_line = (f"segment_windows_sharded on phase 8's {len(want)} chunks "
                f"over 4 stand-in shards: {win_wall:.3f} s (" + ", ".join(
                    f"{k} {v:.3f}" for k, v in timings.items())
                + f"), maxplus_closure launches "
                f"{win_launches['maxplus_closure']}")
    log(f"phase 9: {win_line}; every window's borders == phase 8's fast run")
    torch.cuda.empty_cache()

    procs_line = _procs_segment(work, seg_out)

    t0 = time.perf_counter()
    fn, args = flagship.entry()
    merged, tb, total = fn(*args)
    torch.cuda.synchronize()
    # merged against the host pileup plus the samples; tb against
    # scan_numpy on the forward's cost, rebuilt from the host pileup
    start, length, count, codes, sample_counts, loci = args
    pile = native.pileup_native(start, length, count, codes, 1,
                                flagship.N_SITES)
    want_m = pile + sample_counts.sum(dim=0).cpu().numpy()
    pile = torch.from_numpy(pile.astype(np.int32)).to(dev)
    cost = torch.zeros((flagship.N_SITES, flagship.W), device=dev)
    for d in range(sample_counts.shape[0]):
        _segment_cost_local(sample_counts[d] + pile, loci, flagship.W,
                            flagship.MAX_BP, flagship.PC, out=cost)
    want_tb = scan_numpy(cost.cpu().numpy(), flagship.W)
    if not (np.array_equal(merged.cpu().numpy(), want_m)
            and int(total) == int(pile[:, 1].sum())
            and np.array_equal(tb.cpu().numpy(), want_tb)):
        raise RuntimeError("flagship.entry(): merged, the coverage or tb "
                           "differs from the host's")
    shapes = [tuple(o.shape) for o in (merged, tb, total)]
    log(f"[entry] ok: {shapes} on cuda, merged == the host pileup + the "
        f"samples, tb == scan_numpy, total coverage {int(total):,}; "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    flagship.dryrun_multichip(4)
    log(f"phase 9: dryrun_multichip(4) on cuda: "
        f"{time.perf_counter() - t0:.3f} s")
    return {"dp_scan": res}, {"dp_scan": launches}, "; ".join(
        (step_line, win_line, procs_line))


# ---------------------------------------------------------------------------
# phase 10: the block and read-level device ops at hg19 size
# ---------------------------------------------------------------------------

BLOCK_EDGE = ("whole_genome_255", "uint16", "unsorted", "overlapping",
              "over_budget", "mixed_run")
PAIR_EDGE = ("unsorted", "long_rows")
PAIR_EDGE_SITES = 50_000
# homog_bins' edge cases: ranges x clip x min_cpgs over the same reads, and
# shapes of their own -> (ranges, inclusive, min_cpgs) (homog_edge_batch)
HOMOG_SHAPES = {"hot_block": ("ties", False, 3),
                "wide_span": ("rlen3", False, 3),
                "permuted_pairs": ("ties", False, 3),
                "long_rows": ("rlen3", False, 3),
                "big_counts": ("rlen3", False, 3),
                "hundred": ("hundred", False, 1),
                "mask_rows": ("rlen3", False, 3)}
# the shapes where some pairs fall outside their chunk's window
HOMOG_DIRECT = ("wide_span", "permuted_pairs", "long_rows", "hundred")
HOMOG_EDGE = tuple(f"{r}_{'inclusive' if inc else 'clipped'}_min{m}"
                   for r in ("ties", "rlen3") for inc in (False, True)
                   for m in (1, 3, 4)) + tuple(HOMOG_SHAPES)
HOMOG_RANGES = {"ties": [0.0, 0.25, 0.5, 1.0],
                "rlen3": [0.0, 0.334, 0.667, 1.0],
                "hundred": [k / 100 for k in range(101)]}


def _tiling(rng, n_blocks, first, max_len=60):
    """Blocks of 1-max_len sites tiling [first, ...): 1-based (s, e)."""
    import numpy as np

    lens = rng.integers(1, max_len + 1, size=n_blocks)
    e = first + np.cumsum(lens)
    return e - lens, e


def block_edge_batch(name, n=N_SITES):
    """block_sums' hand-made edges: (data (n, 2), starts, ends) with 1-based
    blocks, base 1. Each starts with one block over all n sites (long: its
    pieces are summed across the card), an NA block, s == e, blocks
    clipped past n. "whole_genome_255": uint8 at coverage 255 on every
    site (the whole block's coverage passes 2^31 from n = 8,500,000 on),
    then seeded blocks of 1-300 sites over the table (wide hulls: a warp a
    block); "uint16": an lbeta's uint16 table of 1,000,000 sites with
    values up to 65,535 and the same kinds of blocks. On the coverage-255
    table: "unsorted", 128 runs of ops/reduceat.py::RUN blocks tiling
    sites from 1,001 on, the first half permuted within each run (staged
    runs out of order), the second over the half (wide hulls);
    "overlapping", 3,000 blocks of 1-300 sites starting 0-29 sites apart,
    every 17th a copy of its neighbour (staged, overlapping); "over_budget",
    blocks of SPAN_ROWS - 1, SPAN_ROWS (the staged budget: staged),
    SPAN_ROWS + 1, 2 SPAN_ROWS, PIECE_ROWS, PIECE_ROWS + 1 and 3
    PIECE_ROWS + 5 sites (long: 1-4 pieces), each followed by 300 blocks
    tiling the sites after it; "mixed_run", 48 runs of RUN blocks in turn
    tiling (staged), scattered over the table (a warp a block), and tiling
    with one block of SPAN_ROWS + 1 sites among them (staged and a long
    block)."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops.reduceat import PIECE_ROWS, RUN, SPAN_ROWS

    rng = np.random.default_rng(15)
    if name == "uint16":
        n = 1_000_000
        data = rng.integers(0, 65536, size=(n, 2)).astype(np.uint16)
    else:
        data = np.full((n, 2), 255, np.uint8)
        data[:, 0] = rng.integers(0, 256, size=n)
    if name in ("whole_genome_255", "uint16"):
        s = np.sort(rng.integers(1, n + 1, size=5000))
        e = s + rng.integers(1, 300, size=5000)
    elif name == "unsorted":
        s, e = _tiling(rng, 128 * RUN, 1001)
        p = np.concatenate([k + rng.permutation(RUN)
                            for k in range(0, 64 * RUN, RUN)]
                           + [64 * RUN + rng.permutation(64 * RUN)])
        s, e = s[p], e[p]
    elif name == "overlapping":
        s = 1001 + np.cumsum(rng.integers(0, 30, size=3000))
        e = s + rng.integers(1, 301, size=3000)
        s[5::17], e[5::17] = s[4::17][:len(s[5::17])], e[4::17][:len(
            e[5::17])]
    elif name == "over_budget":
        parts, at = [], 1001
        for size in (SPAN_ROWS - 1, SPAN_ROWS, SPAN_ROWS + 1, 2 * SPAN_ROWS,
                     PIECE_ROWS, PIECE_ROWS + 1, 3 * PIECE_ROWS + 5):
            ts, te = _tiling(rng, 300, at + size)
            parts.append((np.concatenate([[at], ts]),
                          np.concatenate([[at + size], te])))
            at = int(te[-1]) + 100
        s, e = (np.concatenate(x) for x in zip(*parts))
    elif name == "mixed_run":
        parts, at = [], 1001
        for k in range(48):
            if k % 3 == 1:  # scattered over the table
                ss = np.sort(rng.integers(1, n - 400, size=RUN))
                parts.append((ss, ss + rng.integers(1, 300, size=RUN)))
                continue
            ts, te = _tiling(rng, RUN, at)
            if k % 3 == 2:  # a long block among the tiling ones
                ts[RUN // 2], te[RUN // 2] = at, at + SPAN_ROWS + 1
            parts.append((ts, te))
            at = int(te.max()) + 50
        s, e = (np.concatenate(x) for x in zip(*parts))
    else:
        raise KeyError(name)
    s = np.concatenate([[1, -1, 7, n - 5, n + 3, 2], s])
    e = np.concatenate([[n + 1, -1, 7, n + 100, n + 9, 1], e])
    return data, s, e


def pair_edge_batch(name="unsorted"):
    """pair_counts' hand-made edges on a window of PAIR_EDGE_SITES sites:
    (start_rel, length, count, codes (F, L) uint8, n) with every call
    T / C / H / '.', fragments starting up to L sites before the window
    (start_rel < 0) and reaching past its end, one ending on the last
    site, length-1 fragments, and counts up to 3000. "unsorted": 40,000
    fragments of up to 40 sites in no order (the wrapper sorts them);
    "long_rows": 20,000 fragments of up to L = 200 sites sorted by start
    (the rows of more than ops/pairs.py::ROW_MAX calls walked by a warp),
    some of them across the kernel's tile edges."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops.pairs import TILE

    rng = np.random.default_rng(16 if name == "unsorted" else 17)
    if name not in PAIR_EDGE:
        raise KeyError(name)
    F, L, n = ((40_000, 40, PAIR_EDGE_SITES) if name == "unsorted"
               else (20_000, 200, PAIR_EDGE_SITES))
    start = rng.integers(-L, n + 5, size=F)
    length = rng.integers(1, L + 1, size=F)
    length[::7] = 1
    start[:3], length[:3] = (n - 10, -30, n - 1), (10, 35, 1)
    if name == "long_rows":
        start[3:9] = (TILE - 1, TILE - 150, 2 * TILE - 199, 3 * TILE - 1,
                      -L + 1, n - L)
        length[3:9] = L
    count = rng.integers(1, 3001, size=F)
    codes = rng.integers(0, 4, size=(F, L)).astype(np.uint8)
    codes[np.arange(L)[None, :] >= length[:, None]] = 3
    if name == "long_rows":
        order = np.argsort(start, kind="stable")
        start, length, count, codes = (a[order] for a in (start, length,
                                                          count, codes))
    return (start.astype(np.int32), length.astype(np.int32),
            count.astype(np.int32), codes, n)


def homog_edge_batch(name):
    """homog_bins' hand-made edges: (frags, bstart, bend, ranges,
    min_cpgs, inclusive) of case `name` (HOMOG_EDGE). "<ranges>_<clip>_
    min<m>": 20,000 fragments of 1-60 sites (a quarter of them 4 calls of
    T / C / H, so meth ties the edges 0.25 and 0.5 exactly, and meth 0 and
    1 come up) over blocks of 1-6 sites (a read covers many blocks), '.'
    and H among the calls, counts up to 3000. The shapes (HOMOG_SHAPES):
    "hot_block", the same reads inside one 100-site block (every pair
    into one block's cells); "wide_span", the same reads over blocks of
    10-40 sites, every 10th doubled half a block on (overlapping), and
    one over the whole range first (ends not sorted: a chunk's window fits
    only near the start); "permuted_pairs", the same reads and blocks, their pairs
    shuffled (homog_edge_pairs); "long_rows", 5,000 reads of up to L = 200
    sites over many blocks; "big_counts", the same reads with counts
    within 3000 of 2^31 - 1 (cells past 2^32); "hundred", 100 bins (a
    binary search) at min_cpgs 1; "mask_rows", 20,000 reads of up to L =
    64 sites (clips past the kernel's prefetched words) with 1 % of the
    calls bytes above 3 (neither T nor C or H)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.pat import PatFrags

    if name in HOMOG_SHAPES:
        ranges, inclusive, m = HOMOG_SHAPES[name]
    else:
        ranges, clip, m = name.split("_")
        inclusive, m = clip == "inclusive", int(m[3:])
    rng = np.random.default_rng(17)
    F, L, n = {"long_rows": (5_000, 200, 30_000),
               "mask_rows": (20_000, 64, 30_000)}.get(name,
                                                      (20_000, 60, 30_000))
    start = np.sort(rng.integers(1, n, size=F)).astype(np.int32)
    length = rng.integers(1, L + 1, size=F).astype(np.int32)
    length[::4] = 4
    codes = rng.choice(np.array([0, 1, 2, 3], np.uint8), size=(F, L),
                       p=[0.4, 0.4, 0.1, 0.1])
    codes[::4, :4] = rng.integers(0, 3, size=(len(codes[::4]), 4))
    codes[np.arange(L)[None, :] >= length[:, None]] = 3
    count = rng.integers(1, 3001, size=F).astype(np.int32)
    bend = np.cumsum(rng.integers(1, 7, size=n // 3)) + 1
    bstart = np.concatenate([[1], bend[:-1]])
    if name == "hot_block":  # every read inside [hot, hot + 100)
        k = int(np.searchsorted(bstart, 1000))
        hot = int(bstart[k])
        after = bstart >= hot + 100
        bstart = np.concatenate([bstart[:k], [hot], bstart[after]])
        bend = np.concatenate([bend[:k], [hot + 100], bend[after]])
        start = hot + rng.integers(0, 100 - length + 1)
        order = np.argsort(start, kind="stable")
        start, length, codes, count = (a[order] for a in (start, length,
                                                          codes, count))
        start = start.astype(np.int32)
    elif name == "wide_span":  # blocks of 10-40 sites, every 10th doubled
        # half a block on, and one block over the whole range
        bend = np.cumsum(rng.integers(10, 41, size=n // 25)) + 1
        bstart = np.concatenate([[1], bend[:-1]])
        idx = np.arange(0, bstart.shape[0], 10)
        shift = (bend[idx] - bstart[idx]) // 2 + 1
        bstart = np.concatenate([[1], np.insert(bstart, idx + 1,
                                                bstart[idx] + shift)])
        bend = np.concatenate([[n + L], np.insert(bend, idx + 1,
                                                  bend[idx] + shift)])
    elif name == "big_counts":
        count = (2**31 - 1 - rng.integers(0, 3001, size=F)).astype(np.int32)
    elif name == "mask_rows":
        hit = rng.random((F, L)) < 0.01
        codes[hit] = rng.integers(4, 256, size=int(hit.sum()))
    frags = PatFrags(start, length, count, codes, np.zeros(F, np.int16),
                     ["chr1"])
    return (frags, bstart.astype(np.int64), bend.astype(np.int64),
            HOMOG_RANGES[ranges], m, inclusive)


def homog_edge_pairs(name, frags, bstart, bend):
    """The overlap pairs (fi, bi) homog_bins takes on edge case `name`:
    overlap_pairs', by fragment then block, shuffled for
    "permuted_pairs"."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops.frag_ops import overlap_pairs

    fi, bi = overlap_pairs(frags, bstart, bend)
    if name == "permuted_pairs":
        perm = np.random.default_rng(18).permutation(fi.shape[0])
        fi, bi = fi[perm], bi[perm]
    return fi, bi


# '.' calls put before each row of the main path's slab (24 calls): rows of
# 25 (no longer a multiple of 8), 41 (clips across the kernel's prefetched
# words) and 72 calls (clips past them, more than 64 calls)
HOMOG_ROW_FORMS = (1, 17, 48)


def homog_row_form(cols, k):
    """homog_bins' tensors of one slab (_homog_cols' order) with k '.'
    calls (code 3) put before each row, each fragment starting k sites
    earlier and k sites longer, and the same pairs: each clip holds the
    same calls k bytes further into a row of L + k, and the gates pass the
    same pairs (a clip that gains sites gains only '.', and informative,
    which counts only calls, is at most the clip's length), so the counts
    are the same."""
    import torch

    codes, fstart, flen, *rest = cols
    wide = torch.full((codes.shape[0], codes.shape[1] + k), 3,
                      dtype=torch.uint8, device=codes.device)
    wide[:, k:] = codes
    return [wide, fstart - k, flen + k] + rest


def _homog_cols(frags, bstart, bend, ranges, dev, pairs=None):
    """The tensors homog_bins takes for one slab, on `dev`: (codes,
    fstart, flen, fcount, bstart, bend, fi, bi, ranges); `pairs` (fi, bi)
    or overlap_pairs'."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops.frag_ops import overlap_pairs

    fi, bi = overlap_pairs(frags, bstart, bend) if pairs is None else pairs
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        frags.codes, frags.start.astype(np.int32),
        frags.length.astype(np.int32), frags.count.astype(np.int32),
        np.asarray(bstart, np.int64), np.asarray(bend, np.int64),
        fi.astype(np.int32), bi.astype(np.int32),
        np.asarray(ranges, np.float32))]


def _pair_cols(frags, s, dev):
    """The tensors pair_counts_add takes for one slab (window start s)."""
    import numpy as np
    import torch

    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        (frags.start.astype(np.int64) - s).astype(np.int32),
        frags.length.astype(np.int32), frags.count.astype(np.int32),
        frags.codes)]


def _edge_checks(dev):
    """Each of the phase's kernels against its twin on the card, tolerance
    0, on its hand-made edge batch. Returns a summary line."""
    import torch

    from wgbs_tools_tpu_torch.ops import frag_ops, pairs, reduceat

    parts = []
    for name in BLOCK_EDGE:
        data, s, e = block_edge_batch(name)
        bd = torch.from_numpy(reduceat.block_bounds(s, e, 1, data.shape[0]))
        d = torch.from_numpy(data).to(dev)
        got = _launch_checked(reduceat.block_sums, d, bd.to(dev))
        want = reduceat.block_sums_plain(d, bd.to(dev))
        if not torch.equal(got, want) or not torch.equal(
                _launch_checked(reduceat.block_sums, d, bd.to(dev), False),
                want):
            raise RuntimeError(f"block_sums != twin on edge case {name}")
        if name == "whole_genome_255" and int(got[0, 1]) <= 2 ** 31:
            raise RuntimeError("the whole-genome block's coverage does not "
                               "pass 2^31")
        parts.append(f"block_sums {name} ({len(s)} blocks, whole-genome "
                     f"coverage {int(got[0, 1]):,})")
        if name == "whole_genome_255":
            # the whole-genome block alone: its pieces over the card
            one = bd[:1].to(dev)
            ms = _device_ms(lambda: reduceat.block_sums(d, one), 20)
            bound_ms, _ = _bound(data.nbytes + 2 * one.nbytes, 0)
            log(f"phase 10: block_sums on the whole-genome block alone "
                f"({data.shape[0]:,} sites of coverage 255): kernel "
                f"{ms:.4f} ms on the card, bound {bound_ms:.4f} ms "
                f"({bound_ms / ms:.1%})")
            parts[-1] += f", the whole-genome block alone {ms:.4f} ms"
    for name in PAIR_EDGE:
        start, length, count, codes, n = pair_edge_batch(name)
        cols = [torch.from_numpy(a).to(dev) for a in (start, length, count,
                                                      codes)]
        table = torch.zeros((n, 4), dtype=torch.int32, device=dev)
        want = pairs.pair_counts_add_plain(table.clone(), *cols)
        hints = (None, False) + ((True,) if name == "long_rows" else ())
        for hint in hints:
            got = _launch_checked(pairs.pair_counts_add, table.clone(),
                                  *cols, is_sorted=hint)
            if not torch.equal(got, want):
                raise RuntimeError(f"pair_counts != twin on edge case {name} "
                                   f"(is_sorted={hint})")
        parts.append(f"pair_counts {name} ({len(start):,} frags, L "
                     f"{codes.shape[1]}, {int(got.sum()):,} in the table; "
                     f"is_sorted {', '.join(map(str, hints))})")
    shapes = []
    for name in HOMOG_EDGE:
        frags, bstart, bend, ranges, m, inclusive = homog_edge_batch(name)
        cols = _homog_cols(frags, bstart, bend, ranges, dev,
                           homog_edge_pairs(name, frags, bstart, bend))
        out = torch.zeros((len(bstart), len(ranges) - 1), dtype=torch.int64,
                          device=dev)
        stats = torch.zeros(4, dtype=torch.int64, device=dev)
        got = _launch_checked(frag_ops.homog_bins, out.clone(), *cols, m,
                              inclusive, stats=stats)
        want = frag_ops.homog_bins_plain(out, *cols, m, inclusive)
        if not torch.equal(got, want) or int(got.sum()) == 0:
            raise RuntimeError(f"homog_bins != twin on edge case {name}")
        chunks, direct, passing, atomics = stats.tolist()
        P = cols[6].numel()
        if chunks != -(-P // frag_ops.CHUNK) or passing != int(
                (frag_ops.homog_cells_plain(*cols[:3], *cols[4:], m,
                                            inclusive) >= 0).sum()):
            raise RuntimeError(f"homog_bins' stats on {name}: {chunks} "
                               f"chunks, {passing} passing pairs")
        if (name in HOMOG_DIRECT) != (direct > 0):
            raise RuntimeError(f"homog_bins added {direct} pairs straight "
                               f"into out on {name}")
        if name == "big_counts" and int(got.max()) <= 2**32:
            raise RuntimeError("big_counts has no cell past 2^32")
        if name in HOMOG_SHAPES:
            shapes.append(f"{name} {P:,} pairs: {chunks:,} chunks, "
                          f"{passing:,} passing, {direct:,} straight into "
                          f"out, {atomics:,} global atomics")
    parts.append(f"homog_bins on {len(HOMOG_EDGE)} cases "
                 f"({', '.join(HOMOG_EDGE)}; {'; '.join(shapes)})")
    return "; ".join(parts)


def _first_gen_slab(n_frags):
    """The first SLAB fragments of the big pat, drawn again from its seed as
    write_pat_gz drew them: (start, length, count, codes, hi), its
    fragments' starts in [1, hi), the next slab's from hi on."""
    import numpy as np

    rng = np.random.default_rng(20260820)
    n_slabs = (n_frags + SLAB - 1) // SLAB
    span = N_SITES - MAX_LEN - 1
    hi = 1 + span // n_slabs
    return (*make_slab(rng, min(SLAB, n_frags), 1, hi, 3), hi)


def _pairs_oracle(n_frags):
    """(rows, int64 (rows, 4)): the pair counts of the first generated
    slab in numpy (np.bincount of the flat ids) at the sites no later
    fragment reaches."""
    import numpy as np

    start, length, count, codes, hi = _first_gen_slab(n_frags)
    p = np.arange(1, MAX_LEN)[None, :]
    pre, cur = codes[:, :-1].astype(np.int64), codes[:, 1:].astype(np.int64)
    row = start[:, None].astype(np.int64) - 1 + p
    ok = (p < length[:, None]) & (pre <= 1) & (cur <= 1) & (row < hi - 1)
    flat = (row * 4 + 2 * pre + cur)[ok]
    w = np.broadcast_to(count[:, None], ok.shape)[ok]
    rows = hi - 1
    return rows, np.bincount(flat, weights=w, minlength=rows * 4)[
        :rows * 4].astype(np.int64).reshape(rows, 4)


def _run_cli(what, fn, argv, kernel=None):
    """fn(argv, timings=...) with the launch counters set to 0 just before
    and read just after; `kernel` must launch. Returns (wall, timings,
    launches)."""
    timings = {}
    _zero_launches()
    t0 = time.perf_counter()
    if fn(argv, timings=timings):
        raise RuntimeError(f"{what} failed")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    if kernel is not None:
        _require_launches(f"phase 10 {what}", launches, (kernel,))
    return wall, timings, launches


def _stages(timings):
    return ", ".join(f"{k} {v:.3f}" for k, v in timings.items())


def run_bodies(bounds, long_blocks=True):
    """How csrc/reduceat.cu's runs kernel takes the runs of `bounds` (host
    (B, 2) rows): {"staged": runs, "wide": runs, "none": runs, "long":
    blocks}, by its rule (a run is ops/reduceat.py::RUN blocks, staged when
    the hull of its used blocks fits SPAN_ROWS rows)."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops.reduceat import RUN, SPAN_ROWS

    B = bounds.shape[0]
    pad = np.zeros((-B % RUN, 2), np.int64)
    s, e = np.concatenate([bounds, pad]).T.reshape(2, -1, RUN)
    long_ = (e - s > SPAN_ROWS) & long_blocks
    used = (e > s) & ~long_
    lo = np.where(used, s, np.iinfo(np.int64).max).min(axis=1)
    hi = np.where(used, e, -1).max(axis=1)
    none = hi <= lo
    wide = ~none & (hi - lo > SPAN_ROWS)
    return {"staged": int((~none & ~wide).sum()), "wide": int(wide.sum()),
            "none": int(none.sum()), "long": int(long_.sum())}


def _block_sums_timing(beta, s, e, dev, regs):
    """block_sums on its main-path launch (one beta over the blocks),
    timed beside its bound, the twin and one index_add_ of the rows by
    block id. Returns the kernel's results."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import reduceat

    data = np.fromfile(beta, np.uint8).reshape(-1, 2)
    bounds = reduceat.block_bounds(s, e, 1, data.shape[0])
    d = torch.from_numpy(data).to(dev)
    bd = torch.from_numpy(bounds).to(dev)
    # the main path's call (reduce_data_to_blocks: the pieces launch only
    # where a block is longer than SPAN_ROWS), then with it
    long_blocks = bool((bounds[:, 1] - bounds[:, 0]
                        > reduceat.SPAN_ROWS).any())
    ms = _device_ms(lambda: reduceat.block_sums(d, bd, long_blocks), 50)
    call_ms = _time_ms(lambda: reduceat.block_sums(d, bd, long_blocks), 50)
    pieces_ms = _device_ms(lambda: reduceat.block_sums(d, bd, True), 50)
    plain_ms = _time_ms(lambda: reduceat.block_sums_plain(d, bd), 5)
    # the yardstick: a block id per site (B where no block covers it), the
    # int64 rows and the accumulator made outside the timed window
    B = bounds.shape[0]
    ids = torch.full((data.shape[0],), B, dtype=torch.int64, device=dev)
    lens = bd[:, 1] - bd[:, 0]
    pos = torch.repeat_interleave(bd[:, 0], lens) + (
        torch.arange(int(lens.sum()), device=dev)
        - torch.repeat_interleave(torch.cumsum(lens, 0) - lens, lens))
    ids[pos] = torch.repeat_interleave(torch.arange(B, device=dev), lens)
    rows = d.to(torch.int64)
    acc = torch.zeros((B + 1, 2), dtype=torch.int64, device=dev)
    library_ms = _time_ms(lambda: acc.index_add_(0, ids, rows), 20)
    acc.zero_().index_add_(0, ids, rows)
    got = reduceat.block_sums(d, bd, long_blocks)
    if not (torch.equal(acc[:B], got)
            and torch.equal(got, reduceat.block_sums_plain(d, bd))
            and torch.equal(got, reduceat.block_sums(d, bd, True))):
        raise RuntimeError("block_sums != its twin or index_add_ on the "
                           "main path's launch")
    n_bytes = data.nbytes + 2 * bounds.nbytes
    bound_ms, bound_by = _bound(n_bytes, 0)
    log(f"phase 10: block_sums on {op.basename(beta)} over {B:,} blocks "
        f"(one launch, == twin and index_add_): {n_bytes:,} bytes, bound "
        f"{bound_ms:.4f} ms; kernel {ms:.4f} ms on the card ({bound_ms / ms:.1%}"
        f" of its bound; long_blocks={long_blocks}, the main path's; runs "
        f"{run_bodies(bounds, long_blocks)}), "
        f"{call_ms:.4f} per call; with the pieces launch {pieces_ms:.4f} ms; "
        f"twin {plain_ms:.4f} ms; index_add_ {library_ms:.4f} ms; registers "
        f"{regs.get('block_sums')}")
    return {"max_abs_err": 0, "ms": ms, "call_ms": call_ms,
            "pieces_ms": pieces_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bytes": n_bytes, "blocks": B}


def _pair_counts_timing(slab, dev, regs):
    """pair_counts on its main-path launch (the big pat's first streamed
    slab into the hg19 table), timed beside its bound (the slab's bytes and
    each table entry it reaches read and written once) with its atomics,
    and the twin's time. Returns the kernel's results."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import pairs

    sel = slab.slice_sites(1, N_SITES + 1)
    cols = _pair_cols(sel, 1, dev)
    table = torch.zeros((N_SITES, 4), dtype=torch.int32, device=dev)
    # the main path's call (StreamingPairs.add: a pat slab is sorted)
    pairs.pair_counts_add(table, *cols, is_sorted=True)
    twin = pairs.pair_counts_add_plain(
        torch.zeros_like(table), *cols)
    if not torch.equal(table, twin):
        raise RuntimeError("pair_counts != twin on the first slab")
    again = pairs.pair_counts_add(torch.zeros_like(table), *cols,
                                  is_sorted=True)
    if not torch.equal(again, table):
        raise RuntimeError("pair_counts gave another table on a second run")
    del again
    touched = int((table != 0).sum())
    F, L = sel.codes.shape
    p = np.arange(1, L)[None, :]
    ok = ((p < sel.length[:, None]) & (sel.codes[:, :-1] <= 1)
          & (sel.codes[:, 1:] <= 1))
    atomics = int(ok.sum())
    ms = _device_ms(
        lambda: pairs.pair_counts_add(table, *cols, is_sorted=True), 20)
    call_ms = _time_ms(
        lambda: pairs.pair_counts_add(table, *cols, is_sorted=True), 20)
    # without the hint: the wrapper's sortedness check on the card
    check_ms = _time_ms(lambda: pairs.pair_counts_add(table, *cols), 20)
    plain_ms = _time_ms(lambda: pairs.pair_counts_add_plain(table, *cols), 3)
    # the codes each row's pairs read (its first min(length, L) calls; a
    # row of one call reads none), the three columns, each table entry
    # reached read and written once
    last = np.minimum(sel.length.astype(np.int64), L)
    code_bytes = int(last[last >= 2].sum())
    n_bytes = code_bytes + 12 * F + 8 * touched
    bound_ms, bound_by = _bound(n_bytes, 0)
    del table, twin
    log(f"phase 10: pair_counts on the big pat's first slab ({F:,} frags, "
        f"L {L}): {n_bytes:,} bytes ({code_bytes:,} of codes, {touched:,} "
        f"table entries reached), "
        f"{atomics:,} shared atomics, bound {bound_ms:.4f} ms; kernel "
        f"{ms:.4f} ms on the card ({bound_ms / ms:.1%} of its bound, "
        f"{atomics / ms / 1e6:.3f} G pairs/s), {call_ms:.4f} per call "
        f"(is_sorted=True, the main path's), {check_ms:.4f} per call with "
        f"the sortedness check; the same table on two runs; twin "
        f"{plain_ms:.4f} ms; registers {regs.get('pair_counts')}")
    return {"max_abs_err": 0, "ms": ms, "call_ms": call_ms,
            "check_call_ms": check_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bytes": n_bytes, "atomics": atomics,
            "frags": F}


def _homog_bins_timing(slab, bstart, bend, dev, regs):
    """homog_bins on its main-path launch (the big pat's first slab over
    the blocks, the CLI's default ranges at rlen 3), timed beside its
    bound and the twin's time. Returns the kernel's results."""
    import torch

    from wgbs_tools_tpu_torch.ops import frag_ops

    ranges = HOMOG_RANGES["rlen3"]
    cols = _homog_cols(slab, bstart, bend, ranges, dev)
    out = torch.zeros((len(bstart), 3), dtype=torch.int64, device=dev)
    got = frag_ops.homog_bins(out.clone(), *cols, 3, False)
    if not torch.equal(got, frag_ops.homog_bins_plain(out.clone(), *cols, 3,
                                                      False)):
        raise RuntimeError("homog_bins != twin on the first slab")
    stats = torch.zeros(4, dtype=torch.int64, device=dev)
    if not torch.equal(frag_ops.homog_bins(out.clone(), *cols, 3, False,
                                           stats=stats), got):
        raise RuntimeError("homog_bins gave other counts on a second run")
    cells = int((got != 0).sum())
    P = cols[6].numel()
    # the global atomics against the (chunk, cell) pairs the passing pairs
    # touch (the flush: at most one each; a pair outside its chunk's window
    # one of its own) and the passing pairs (the earlier body's one each)
    codes, fstart, flen, _, bs, be, fi, bi, rng = cols
    cell = frag_ops.homog_cells_plain(codes, fstart, flen, bs, be, fi, bi,
                                      rng, 3, False)
    kept = cell >= 0
    chunk = torch.arange(P, device=dev)[kept] // frag_ops.CHUNK
    touched = int(torch.unique(chunk * got.numel() + cell[kept]).numel())
    passing = int(kept.sum())
    del cell, kept, chunk
    n_chunks, direct, n_pass, atomics = stats.tolist()
    if n_pass != passing or atomics - direct > touched:
        raise RuntimeError(f"homog_bins: {n_pass:,} passing pairs (the "
                           f"twin's {passing:,}), {direct:,} straight into "
                           f"out, {atomics:,} global atomics for {touched:,} "
                           f"(chunk, cell) pairs")
    ms = _device_ms(lambda: frag_ops.homog_bins(out, *cols, 3, False), 20)
    call_ms = _time_ms(lambda: frag_ops.homog_bins(out, *cols, 3, False), 20)
    plain_ms = _time_ms(
        lambda: frag_ops.homog_bins_plain(out, *cols, 3, False), 3)
    # the same launch on rows of other lengths (homog_row_form): the same
    # counts, timed
    forms = {}
    for k in HOMOG_ROW_FORMS:
        wide = homog_row_form(cols, k)
        if not torch.equal(frag_ops.homog_bins(torch.zeros_like(out),
                                               *wide, 3, False), got):
            raise RuntimeError(f"homog_bins on rows of {24 + k} calls "
                               "gave other counts")
        forms[int(wide[0].shape[1])] = _device_ms(
            lambda w=wide: frag_ops.homog_bins(out, *w, 3, False), 20)
        del wide
    # what the launch reaches: each pair's clip of its row's codes where
    # the clip passes the length gate (the blocks do not overlap, so no
    # call is read twice), the three columns of each fragment and the two
    # bounds of each block that a pair names, the pairs, the edges, and
    # each (block, bin) cell that gets a count read and written once
    _, fstart, flen, _, bs, be, fi, bi, rng = cols
    fs = fstart[fi].long()
    clip = (torch.minimum(fs + flen[fi].long(), be[bi])
            - torch.maximum(fs, bs[bi]))
    code_bytes = int(clip[clip >= 3].sum())
    nf = int(torch.unique(fi).numel())
    nb = int(torch.unique(bi).numel())
    n_bytes = (code_bytes + 12 * nf + 16 * nb + 8 * P
               + rng.numel() * rng.element_size() + 16 * cells)
    bound_ms, bound_by = _bound(n_bytes, 0)
    log(f"phase 10: homog_bins on the big pat's first slab "
        f"({slab.nr_frags:,} frags, {P:,} pairs, {len(bstart):,} blocks): "
        f"{n_bytes:,} bytes ({code_bytes:,} of codes in the clips, {nf:,} "
        f"frags and {nb:,} blocks reached), bound {bound_ms:.4f} ms; "
        f"kernel {ms:.4f} ms on "
        f"the card ({bound_ms / ms:.1%} of its bound), {call_ms:.4f} per "
        f"call; the same counts on two runs; {n_chunks:,} chunks of "
        f"{frag_ops.CHUNK} pairs, {direct:,} pairs straight into out; "
        f"{atomics:,} global atomics for {touched:,} "
        f"(chunk, cell) pairs touched and {passing:,} passing pairs; twin "
        f"{plain_ms:.4f} ms; registers {regs.get('homog_bins')}; the same "
        f"launch on rows of other lengths (the same counts): " + ", ".join(
            f"L {n} {t:.4f} ms" for n, t in forms.items()))
    del fs, clip
    return {"max_abs_err": 0, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "bytes": n_bytes, "pairs": P,
            "global_atomics": atomics, "chunk_cells": touched,
            "passing_pairs": passing, "direct_pairs": direct,
            "row_forms_ms": forms}


def _non_nice_bed(work, s, e):
    """A copy of the blocks with every 10th block duplicated and shifted
    into its neighbour (so beta_to_blocks takes JAX's per-block path).
    Returns (path, starts, ends)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.blocks import is_block_file_nice

    idx = np.arange(0, s.shape[0], 10)
    shift = (e[idx] - s[idx]) // 2 + 1
    s2 = np.insert(s, idx + 1, s[idx] + shift)
    e2 = np.insert(e, idx + 1, np.minimum(e[idx] + shift, N_SITES + 1))
    if is_block_file_nice({"startCpG": s2, "endCpG": e2})[0]:
        raise RuntimeError("the non-nice blocks came out nice")
    path = op.join(work, "non_nice.bed")
    with open(path, "w") as f:
        f.write("".join(f"chr1\t{a}\t{b}\t{a}\t{b}\n"
                        for a, b in zip(s2.tolist(), e2.tolist())))
    return path, s2, e2


def _blocks_oracle(beta, s, e, lbeta):
    """The .bin / .lbeta bytes of one beta over [s, e) blocks, from numpy:
    an int64 prefix sum, P[e - 1] - P[s - 1], then the port's saturation."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import trim_to_uint

    data = np.fromfile(beta, np.uint8).reshape(-1, 2).astype(np.int64)
    n = data.shape[0]
    P = np.zeros((n + 1, 2), np.int64)
    np.cumsum(data, axis=0, out=P[1:])
    sc = np.clip(s - 1, 0, n)
    ec = np.maximum(np.clip(e - 1, 0, n), sc)
    return trim_to_uint(P[ec] - P[sc], lbeta).tobytes()


# ---------------------------------------------------------------------------
# bam2pat's calling kernels: hand-made edges (tests/test_torch_calling.py
# holds the twins to numpy and JAX on the same batches)
# ---------------------------------------------------------------------------

CALL_EDGE = ("random", "bottom_ends", "top_ends", "clip3", "clip_half",
             "no_loci", "all_dots", "widened", "last_locus", "len0",
             "single_end", "sorted_tiles", "dense", "wide_window")
MERGE_EDGE = ("random", "equal_starts", "b_before_a", "b_beyond",
              "conflicts", "widths", "span0", "all_dots", "wide_mates")
EDGE_CHROM = 6000         # bp of the edges' chromosome
EDGE_CPG_FREE = (3000, 3600)  # a stretch of it without a CpG
EDGE_SITE_BASE = 1_000_000
_PE_FLAGS = (99, 147, 83, 163, 81, 161, 113, 177)


def _edge_chrom(rng):
    """A chromosome (ACGT with a CpG planted about every 25 bp, none in
    EDGE_CPG_FREE, one at its very end) and its 1-based CpG loci."""
    import numpy as np

    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, EDGE_CHROM)]
    seq = seq.copy()
    at = rng.choice(EDGE_CHROM - 1, EDGE_CHROM // 25, replace=False)
    seq[at], seq[at + 1] = ord("C"), ord("G")
    lo, hi = EDGE_CPG_FREE
    cg = np.nonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))[0]
    seq[cg[(cg >= lo - 1) & (cg < hi)] + 1] = ord("A")
    seq[-2:] = (ord("C"), ord("G"))
    loci = (np.nonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))[0]
            + 1).astype(np.int32)
    return seq, loci


def _edge_read(rng, seq, pos0, n, bottom):
    """Bisulfite bytes of seq[pos0:pos0 + n] on one strand: a C (top) or G
    (bottom) outside a CpG converts, one inside a CpG converts with p 0.3,
    and 1 % of the bytes are N."""
    import numpy as np

    r = seq[pos0:pos0 + n].copy()
    nxt = np.append(seq[pos0 + 1:pos0 + n + 1], 0)[:r.shape[0]]
    prv = seq[max(pos0 - 1, 0):pos0 - 1 + r.shape[0]] if pos0 else \
        np.append([0], seq[:r.shape[0] - 1])
    conv = rng.random(r.shape[0]) < 0.3
    if bottom:
        g = r == ord("G")
        r[g & ((prv != ord("C")) | conv)] = ord("A")
    else:
        c = r == ord("C")
        r[c & ((nxt != ord("G")) | conv)] = ord("T")
    r[rng.random(r.shape[0]) < 0.01] = ord("N")
    return r


def _chrom_of(rng, bp, keep=1.0, gaps=None, run=None):
    """A chromosome of random ACGT and its 1-based CpG loci: each CpG of the
    random bytes kept with p `keep` (its G turns A), a CpG planted after
    each gap drawn from [gaps[0], gaps[1]] bp, and [run[0], run[1]) made
    CGCG... (a CpG every 2 bp)."""
    import numpy as np

    C, G = ord("C"), ord("G")
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, bp)].copy()
    cg = np.nonzero((seq[:-1] == C) & (seq[1:] == G))[0]
    seq[cg[rng.random(cg.shape[0]) >= keep] + 1] = ord("A")
    if gaps is not None:
        at = np.cumsum(rng.integers(gaps[0], gaps[1] + 1, bp // gaps[0]))
        at = at[at < bp - 1]
        seq[at], seq[at + 1] = C, G
    if run is not None:
        seq[run[0]:run[1]] = np.resize(np.frombuffer(b"CG", np.uint8),
                                       run[1] - run[0])
    loci = (np.nonzero((seq[:-1] == C) & (seq[1:] == G))[0] + 1).astype(
        np.int32)
    return seq, loci


def _tile_edge(name, rng):
    """The chromosome, clip, read starts (0-based) and lengths of the edges
    that reach call_reads' tile paths: reads sorted by position at phase
    11's CpG density (sorted_tiles); RRBS-like reads piled at 40 starts
    over a CpG every 4-10 bp, a fifth of them inside a CG run with odd
    lengths (len // 2 + 1 slots each), clip 2 (dense); and a chromosome
    with more loci than a tile's window, its first tile unsorted, its
    second sorted but spread over the whole chromosome, the rest sorted in
    a short stretch (wide_window: two tiles and 88 reads, a tile being
    calling.cu's 512 reads at L 150)."""
    import numpy as np

    n, L, clip = 600, 150, 0
    if name == "sorted_tiles":
        seq, loci = _chrom_of(rng, 12_000, keep=BAM_CPG_KEEP)
        pos0 = np.sort(rng.integers(0, seq.shape[0] - L, n))
        lens = rng.integers(100, L + 1, n)
    elif name == "dense":
        run = (4000, 4400)
        seq, loci = _chrom_of(rng, 8_000, gaps=(4, 10), run=run)
        starts = rng.choice(seq.shape[0] - L, 40, replace=False)
        pos0 = starts[rng.integers(0, 40, n)]
        lens = rng.integers(60, L + 1, n)
        inrun = rng.random(n) < 0.2
        k = int(inrun.sum())
        pos0[inrun] = run[0] + 2 * rng.integers(0, (run[1] - run[0] - L) // 2,
                                                k)
        lens[inrun] = 2 * rng.integers(40, L // 2, k) + 1
        order = np.argsort(pos0, kind="stable")
        pos0, lens, clip = pos0[order], lens[order], 2
    else:
        seq, loci = _chrom_of(rng, 24_000, gaps=(4, 12))
        T = 512
        n = 2 * T + 88
        pos0 = rng.integers(0, seq.shape[0] - L, n)
        pos0[T:2 * T] = np.linspace(0, seq.shape[0] - L - 1, T).astype(
            np.int64)
        pos0[2 * T:] = np.sort(rng.integers(10_000, 11_000, n - 2 * T))
        lens = rng.integers(30, L + 1, n)
    return seq, loci, clip, pos0, lens


def call_edge_batch(name):
    """call_reads_mat's inputs of a hand-made edge: {positions, flags,
    paired, loci, site_base, seqmat, lens, clip}. The edges: bottom reads
    whose first byte is a CpG's C and whose last is a CpG's G or C
    (bottom_ends), top reads ending on a CpG's C (top_ends), clip 3, clip
    >= len / 2, reads with no CpG in reach, reads whose CpGs are all '.',
    a matrix widened past its reads (a 500-byte read among 100-byte ones),
    reads over the chromosome's last locus, rows of length 0,
    single-end flags (every batch but that one is paired-end, with the
    flags of both mates of OT and OB pairs and of pairs whose proper-pair
    bit is clear), and the tile paths' edges (_tile_edge: sorted_tiles,
    dense, wide_window)."""
    import numpy as np

    rng = np.random.default_rng(CALL_EDGE.index(name) + 40)
    L, paired = 150, name != "single_end"
    if name in ("sorted_tiles", "dense", "wide_window"):
        seq, loci, clip, pos0, lens = _tile_edge(name, rng)
        n = pos0.shape[0]
    else:
        seq, loci = _edge_chrom(rng)
        n, clip = 600, 0
        pos0 = rng.integers(0, EDGE_CHROM - L, n)
        lens = rng.integers(30, L + 1, n)
    if name == "bottom_ends":
        k = rng.integers(0, loci.shape[0] - 8, n)
        pos0 = loci[k].astype(np.int64) - 1
        ends = loci[k + rng.integers(2, 8, n)].astype(np.int64)
        lens = np.minimum(ends - pos0 + rng.integers(0, 2, n), L)
    elif name == "top_ends":
        k = rng.integers(8, loci.shape[0] - 1, n)
        lens = rng.integers(30, L + 1, n)
        pos0 = np.maximum(loci[k].astype(np.int64) - lens, 0)
        lens = loci[k].astype(np.int64) - pos0
    elif name == "clip3":
        clip = 3
    elif name == "clip_half":
        lens = rng.integers(2, 61, n)  # clip >= len / 2 up to 40
        clip = 20
    elif name == "no_loci":
        lo, hi = EDGE_CPG_FREE
        pos0 = rng.integers(lo, hi - lens)
    elif name == "widened":
        L = 520
        lens[:5] = rng.integers(480, 501, 5)
        pos0 = np.minimum(pos0, EDGE_CHROM - lens)
    elif name == "last_locus":
        pos0 = rng.integers(EDGE_CHROM - 140, EDGE_CHROM - 2, n)
        lens = np.minimum(lens, EDGE_CHROM - pos0)
    if paired:
        flags = np.asarray(_PE_FLAGS)[rng.integers(0, len(_PE_FLAGS), n)]
        bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    else:
        flags = rng.choice([0, 16, 83, 99], n)
        bottom = (flags & 0x10) != 0
    if name == "bottom_ends":
        flags = np.where(rng.random(n) < 0.5, 83, 163)
        bottom[:] = True
    elif name == "top_ends":
        flags = np.where(rng.random(n) < 0.5, 99, 147)
        bottom[:] = False
    seqmat = np.zeros((n, L), np.uint8)
    for r in range(n):
        read = _edge_read(rng, seq, int(pos0[r]), int(lens[r]), bottom[r])
        lens[r] = read.shape[0]
        if name == "all_dots":
            # no CpG context left: a top read's G and a bottom read's C go
            read[read == (ord("C") if bottom[r] else ord("G"))] = ord("T")
        seqmat[r, :read.shape[0]] = read
    if name == "len0":
        zero = rng.random(n) < 0.15
        lens[zero] = 0
        seqmat[zero] = 0
    return dict(positions=pos0.astype(np.int64) + 1,
                flags=flags.astype(np.int64), paired=paired, loci=loci,
                site_base=EDGE_SITE_BASE, seqmat=seqmat,
                lens=lens.astype(np.int64), clip=clip)


def call_long_batch():
    """call_reads_mat's inputs of 64 paired-end reads of 8,200-9,000 bases
    over a 40 kbp chromosome with a CpG planted every 15-35 bp, clip 3:
    KB > 640, so call_reads takes its long body (a warp a read)."""
    import numpy as np

    rng = np.random.default_rng(70)
    seq, loci = _chrom_of(rng, 40_000, gaps=(15, 35))
    n, L = 64, 9000
    lens = rng.integers(8200, L + 1, n)
    pos0 = rng.integers(0, seq.shape[0] - L, n)
    flags = np.asarray(_PE_FLAGS)[rng.integers(0, len(_PE_FLAGS), n)]
    bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    seqmat = np.zeros((n, L), np.uint8)
    for r in range(n):
        seqmat[r, :lens[r]] = _edge_read(rng, seq, int(pos0[r]),
                                         int(lens[r]), bottom[r])
    return dict(positions=pos0.astype(np.int64) + 1,
                flags=flags.astype(np.int64), paired=True, loci=loci,
                site_base=EDGE_SITE_BASE, seqmat=seqmat,
                lens=lens.astype(np.int64), clip=3)


DENSE_READS = 300_000  # the dense batch: one call_reads launch
DENSE_CHROM_BP = 4_000_000


def dense_batch(seed=190, n=None, bp=None):
    """call_reads_mat's inputs of a CpG-dense batch at launch size, made
    from a seed (RRBS-like): a chromosome of bp (DENSE_CHROM_BP) with a
    CpG planted every 4-10 bp (_chrom_of), n (DENSE_READS) paired-end
    reads of 60-150 bases piled at n / 15 fragment starts, sorted by
    position, converted as _edge_read converts (a C or G outside a CpG
    always, inside one with p 0.3; 1 % N), in bulk."""
    import numpy as np

    n = DENSE_READS if n is None else n
    bp = DENSE_CHROM_BP if bp is None else bp
    rng = np.random.default_rng(seed)
    seq, loci = _chrom_of(rng, bp, gaps=(4, 10))
    L = 150
    starts = rng.choice(np.arange(1, bp - L - 1), n // 15, replace=False)
    pos0 = np.sort(starts[rng.integers(0, starts.shape[0], n)])
    lens = rng.integers(60, L + 1, n)
    flags = np.asarray(_PE_FLAGS)[rng.integers(0, len(_PE_FLAGS), n)]
    bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    at = pos0[:, None] + np.arange(L)[None, :]
    rows = seq[at]
    conv = rng.integers(0, 100, (n, L), dtype=np.uint8) < 30
    top = ~bottom[:, None]
    c = (rows == ord("C")) & top & ((seq[at + 1] != ord("G")) | conv)
    g = (rows == ord("G")) & ~top & ((seq[at - 1] != ord("C")) | conv)
    rows[c] = ord("T")
    rows[g] = ord("A")
    rows[rng.integers(0, 100, (n, L), dtype=np.uint8) < 1] = ord("N")
    rows[np.arange(L)[None, :] >= lens[:, None]] = 0
    return dict(positions=pos0.astype(np.int64) + 1,
                flags=flags.astype(np.int64), paired=True, loci=loci,
                site_base=EDGE_SITE_BASE, seqmat=rows,
                lens=lens.astype(np.int64), clip=0)


def dense_pairs(calls):
    """merge_pe_mat's inputs from call_reads_mat's (start, patmat, span) of
    the dense batch: reads 2i and 2i + 1 as mates where both have a call
    (neighbours in position order, mostly of one fragment start)."""
    import numpy as np

    start, pat, span = calls
    a, b = np.arange(0, start.shape[0] - 1, 2), np.arange(1, start.shape[0], 2)
    both = (start[a] >= 0) & (start[b] >= 0)
    a, b = a[both], b[both]
    return start[a], pat[a], span[a], start[b], pat[b], span[b]


def _edge_pats(rng, spans, p_dot=0.3):
    """'.'-padded pattern chars (n, max span) of the given spans: T and C,
    some H, p_dot of '.'."""
    import numpy as np

    W = max(int(spans.max(initial=1)), 1)
    pats = np.frombuffer(b"TCH.", np.uint8)[rng.choice(
        4, (spans.shape[0], W), p=[(1 - p_dot) * 0.48, (1 - p_dot) * 0.48,
                                   (1 - p_dot) * 0.04, p_dot])].copy()
    pats[np.arange(W)[None, :] >= spans[:, None]] = ord(".")
    return pats


def merge_edge_batch(name):
    """merge_pe_mat's inputs of a hand-made edge: (s1, pat1, sp1, s2,
    pat2, sp2). The edges: equal starts, mate 2 first, mate 2 past mate
    1's span, overlaps that disagree, pairs 299, 300 and 301 sites wide
    (either mate first), mates of span 0, all-'.' mates, and mates of
    spans to 250 with S1 != S2, too wide for a staged tile (wide_mates)."""
    import numpy as np

    rng = np.random.default_rng(MERGE_EDGE.index(name) + 60)
    n = 600
    s1 = rng.integers(1, 10_000_000, n).astype(np.int64)
    sp1 = rng.integers(1, 81, n).astype(np.int64)
    sp2 = rng.integers(1, 81, n).astype(np.int64)
    off = rng.integers(-50, 151, n)
    p_dot = 0.3
    if name == "wide_mates":
        # rows too wide for a staged tile: spans to 250, S1 != S2
        sp1 = rng.integers(150, 251, n).astype(np.int64)
        sp2 = rng.integers(40, 201, n).astype(np.int64)
        off = rng.integers(-60, 201, n)
    elif name == "equal_starts":
        off[:] = 0
    elif name == "b_before_a":
        off = -rng.integers(1, 61, n)
    elif name == "b_beyond":
        off = sp1 + rng.integers(1, 41, n)
    elif name == "widths":
        sp1 = rng.integers(100, 201, n).astype(np.int64)
        sp2 = rng.integers(100, 201, n).astype(np.int64)
        width = 299 + rng.integers(0, 3, n)
        off = width - sp2
        off = np.where(rng.random(n) < 0.5, off, -(width - sp1))
    elif name == "span0":
        zero1 = rng.random(n) < 0.4
        sp1[zero1] = 0
        sp2[~zero1 & (rng.random(n) < 0.6)] = 0
    elif name == "all_dots":
        p_dot = 1.0
    s2 = np.maximum(s1 + off, 0)
    pat1 = _edge_pats(rng, sp1, p_dot)
    if name == "conflicts":
        # mate 2 copies mate 1's overlap, then a third of its calls flip
        off = rng.integers(0, 40, n)
        s2 = s1 + off
        pat2 = np.full((n, int(sp2.max())), ord("."), np.uint8)
        for r in range(n):
            o = int(off[r])
            take = pat1[r, o:int(sp1[r])][: int(sp2[r])]
            pat2[r, :take.shape[0]] = take
            rest = int(sp2[r]) - take.shape[0]
            pat2[r, take.shape[0]:int(sp2[r])] = _edge_pats(
                rng, np.array([rest]))[0, :rest]
        flip = (rng.random(pat2.shape) < 0.33) & (pat2 != ord("."))
        pat2[flip] = np.where(pat2[flip] == ord("T"), ord("C"), ord("T"))
    else:
        pat2 = _edge_pats(rng, sp2, p_dot)
    return s1, pat1, sp1, s2, pat2, sp2


def phase_blocks(work, big, n_frags, seg_out, regs):
    """Phase 10: beta_to_blocks, beta_to_table, pat2pairs and homog through
    the port's CLI on cuda at hg19 size, each with the launch counters set
    to 0 just before and read just after (its kernel must launch) and its
    stage seconds; each output against its oracle; the sharded block sums
    against one device's; the three kernels against their twins on the
    main path and on hand-made edges, and timed. Returns ({kernel:
    results}, {kernel: (path, launches)}, summary line)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch import _kernels
    from wgbs_tools_tpu_torch.cli import cmd_beta, cmd_homog, cmd_misc
    from wgbs_tools_tpu_torch.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.ops import pairs, reduceat
    from wgbs_tools_tpu_torch.parallel.mesh import shard_devices

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = op.join(work, "blocks_out")
    os.makedirs(out)
    bed = seg_out["exact_bed"]
    s, e = _blocks_of(bed)
    betas = [op.join(work, "gpu", "big.beta")] + list(seg_out["betas"])
    lines, launches, res = [], {}, {}

    # beta_to_blocks: the 4 betas, one of them with --lbeta, then a non-nice
    # copy of the blocks; every file == the numpy oracle's bytes
    wall, tm, ln = _run_cli("beta_to_blocks", cmd_beta.main_beta_to_blocks,
                            betas + ["-b", bed, "-o", out, "--device",
                                     "cuda"], "block_sums")
    launches["block_sums"] = ("phase 10 beta_to_blocks CLI", ln)
    lwall, ltm, _ = _run_cli("beta_to_blocks --lbeta",
                             cmd_beta.main_beta_to_blocks,
                             betas[:1] + ["-b", bed, "-o", out, "--lbeta",
                                          "--device", "cuda"],
                             "block_sums")
    nn_bed, s2, e2 = _non_nice_bed(work, s, e)
    nn_out = op.join(work, "blocks_non_nice")
    os.makedirs(nn_out)
    nwall, ntm, _ = _run_cli("beta_to_blocks (non-nice)",
                             cmd_beta.main_beta_to_blocks,
                             betas + ["-b", nn_bed, "-o", nn_out,
                                      "--device", "cuda"],
                             "block_sums")
    t0 = time.perf_counter()
    for beta in betas:
        name = op.splitext(op.basename(beta))[0]
        checks = [(op.join(out, name + ".bin"), s, e, False),
                  (op.join(nn_out, name + ".bin"), s2, e2, False)]
        if beta == betas[0]:
            checks.append((op.join(out, name + ".lbeta"), s, e, True))
        for path, bs, be, lb in checks:
            with open(path, "rb") as f:
                if f.read() != _blocks_oracle(beta, bs, be, lb):
                    raise RuntimeError(f"{path} != the numpy oracle")
    line = (f"beta_to_blocks on cuda: {len(betas)} betas over {len(s):,} "
            f"blocks {wall:.3f} s ({_stages(tm)}), block_sums launches "
            f"{ln['block_sums']}; --lbeta on 1 {lwall:.3f} s; non-nice "
            f"({len(s2):,} blocks) {nwall:.3f} s ({_stages(ntm)}); every "
            f".bin / .lbeta == the numpy oracle (checked in "
            f"{time.perf_counter() - t0:.3f} s)")
    log("phase 10: " + line)
    lines.append(line)

    # the block sums over 4 stand-in shards == one device's
    data = np.fromfile(betas[0], np.uint8).reshape(-1, 2)
    t0 = time.perf_counter()
    one = reduceat.reduce_data_to_blocks(data, s2, e2, device=dev)
    t1 = time.perf_counter()
    four = reduceat.reduce_data_to_blocks(
        data, s2, e2, device=shard_devices("cuda", n_shards=4))
    t2 = time.perf_counter()
    if not np.array_equal(one, four):
        raise RuntimeError("the block sums over 4 stand-in shards != one "
                           "device's")
    line = (f"reduce_data_to_blocks over 4 stand-in shards == one device's "
            f"({len(s2):,} non-nice blocks of big.beta; {t2 - t1:.3f} s "
            f"against {t1 - t0:.3f} s)")
    log("phase 10: " + line)
    lines.append(line)
    del data
    res["block_sums"] = _block_sums_timing(betas[0], s, e, dev, regs)

    # beta_to_table over phase 8's betas with a groups file: cuda == cpu
    groups = op.join(work, "groups.csv")
    names = [op.splitext(op.basename(b))[0] for b in seg_out["betas"]]
    with open(groups, "w") as f:
        f.write("name,group\n" + "".join(
            f"{n},{'g1' if k < 2 else 'g2'}\n" for k, n in enumerate(names)))
    tables = []
    for device in ("cuda", "cpu"):
        table = op.join(work, f"table_{device}.tsv")
        twall, ttm, tln = _run_cli(
            f"beta_to_table --device {device}", cmd_beta.main_beta_to_table,
            [bed, "--betas"] + list(seg_out["betas"]) + ["-g", groups, "-o",
                                                          table,
                                                          "--device", device],
            "block_sums" if device == "cuda" else None)
        tables.append((table, twall, ttm, tln))
    if not _same(tables[0][0], tables[1][0]):
        raise RuntimeError("beta_to_table on cuda != --device cpu")
    line = (f"beta_to_table on cuda: {len(names)} betas, 2 groups, "
            f"{len(s):,} blocks {tables[0][1]:.3f} s ({_stages(tables[0][2])}"
            f"), block_sums launches {tables[0][3]['block_sums']}; --device "
            f"cpu {tables[1][1]:.3f} s; the same bytes "
            f"({op.getsize(tables[0][0]):,})")
    log("phase 10: " + line)
    lines.append(line)

    # pat2pairs on the big pat: the kernel's table == the twin's on the card
    # over the whole pat, and == numpy on the first generated slab's sites
    torch.cuda.reset_peak_memory_stats(dev)
    pwall, ptm, pln = _run_cli("pat2pairs", cmd_misc.main_pat2pairs,
                               [big, "-o", out, "--device", "cuda"],
                               "pair_counts")
    peak = torch.cuda.max_memory_allocated(dev)
    launches["pair_counts"] = ("phase 10 pat2pairs CLI", pln)
    got = np.fromfile(op.join(out, "big.pairs"), np.uint32).view(
        np.int32).reshape(-1, 4)
    if got.shape[0] != N_SITES:
        raise RuntimeError(f"big.pairs has {got.shape[0]:,} rows")
    t0 = time.perf_counter()
    twin = torch.zeros((N_SITES, 4), dtype=torch.int32, device=dev)
    for frags in iter_pat(big):
        pairs.pair_counts_add_plain(
            twin, *_pair_cols(frags.slice_sites(1, N_SITES + 1), 1, dev))
    same = np.array_equal(twin.cpu().numpy(), got)
    twin_s = time.perf_counter() - t0
    del twin
    torch.cuda.empty_cache()
    if not same:
        raise RuntimeError("pat2pairs' table != the twin's on the card")
    rows, oracle = _pairs_oracle(n_frags)
    if not np.array_equal(got[:rows], oracle):
        raise RuntimeError("pat2pairs' table != numpy on the first slab's "
                           "sites")
    line = (f"pat2pairs on cuda: {n_frags:,} frags {pwall:.3f} s "
            f"({_stages(ptm)}), pair_counts launches {pln['pair_counts']}, "
            f"device peak {peak / 1e9:.3f} GB; table == the twin's on the "
            f"card over the whole pat (tolerance 0; the twin's pass "
            f"{twin_s:.3f} s) and == numpy's bincount on the first "
            f"{rows:,} sites; {int(got.astype(np.int64).sum()):,} pairs")
    log("phase 10: " + line)
    lines.append(line)

    # homog on the big pat over the blocks, text and --binary: cuda == cpu
    hwalls = {}
    for form in ("text", "binary"):
        outs = []
        for device in ("cuda", "cpu"):
            d = op.join(work, f"homog_{form}_{device}")
            hwall, htm, hln = _run_cli(
                f"homog {form} --device {device}", cmd_homog.main,
                [big, "-b", bed, "-o", d, "--device", device]
                + (["--binary"] if form == "binary" else []),
                "homog_bins" if device == "cuda" else None)
            hwalls[(form, device)] = (hwall, htm)
            if (form, device) == ("text", "cuda"):
                launches["homog_bins"] = ("phase 10 homog CLI", hln)
            outs.append(op.join(d, "big.uxm" + ("" if form == "binary"
                                                else ".bed.gz")))
        if not _same(*outs):
            raise RuntimeError(f"homog {form}: cuda != --device cpu")
    line = "homog on cuda over the blocks: " + "; ".join(
        f"{form} {hwalls[(form, 'cuda')][0]:.3f} s "
        f"({_stages(hwalls[(form, 'cuda')][1])}) against --device cpu "
        f"{hwalls[(form, 'cpu')][0]:.3f} s" for form in ("text", "binary")) \
        + (f", homog_bins launches "
           f"{launches['homog_bins'][1]['homog_bins']}; the same bytes")
    log("phase 10: " + line)
    lines.append(line)

    # the kernels on the main path's first slab, timed, then the edges
    slab = next(iter_pat(big))
    res["pair_counts"] = _pair_counts_timing(slab, dev, regs)
    torch.cuda.empty_cache()
    res["homog_bins"] = _homog_bins_timing(slab, s, e, dev, regs)
    del slab
    torch.cuda.empty_cache()
    line = "edges == twins (tolerance 0): " + _edge_checks(dev)
    log("phase 10: " + line)
    lines.append(line)
    torch.cuda.empty_cache()
    _, spills = _ptxas_registers(_kernels.BUILD_LOG)
    for name in res:
        res[name]["spill_bytes"] = spills.get(name)
    body_regs, body_spills = _ptxas_registers(_kernels.BUILD_LOG, BLK_BODIES)
    log("phase 10: ptxas registers " + ", ".join(
        f"{name} {regs.get(name)}" for name in res) + "; spill bytes "
        + ", ".join(f"{name} {spills.get(name)}" for name in res)
        + f"; block_sums by kernel: registers {body_regs}, spill bytes "
        f"{body_spills}")
    log(f"phase 10: took {time.perf_counter() - t_phase:.3f} s")
    return res, launches, "; ".join(lines)


# ---------------------------------------------------------------------------
# phase 11: bam2pat at chromosome scale, on BAMs made here from a seed
# (vectorized numpy records, BGZF by the port's host library; the JAX
# package's test simulator is not imported)
# ---------------------------------------------------------------------------

BAM_GENOME = "bam2chr"
BAM_CHROMS = ("chr1", "chr2")
BAM_CHROM_BP = 60_000_000
BAM_CPG_KEEP = 0.16       # CpGs kept of random ACGT's 1 in 16: ~1 a 100 bp
BAM_BLOCK = 300           # sites per methylation block (p 0.15 / 0.85)
BAM_PAIRS = 4_000_000     # 2 x 150 bp: ~10x over the 120 Mbp
BAM_SE_READS = 2_000_000
READ_LEN = 150
BAM_CHUNK = 250_000       # records encoded and compressed at a time
BAM_FRACS = dict(complex=0.01, low_mapq=0.005, dup=0.005, single=0.002)
# 4-bit BAM base codes ("=ACMGRSVTWYHKDBN")
_NIB = [0] * 256
for _i, _c in enumerate("=ACMGRSVTWYHKDBN"):
    _NIB[ord(_c)] = _i
# the complex CIGARs (as tests/bisim.py's variants): soft clip, insertion,
# deletion; (op, length) words, l_seq READ_LEN each
_CIGARS = ([(0, READ_LEN)], [(4, 5), (0, READ_LEN - 5)],
           [(0, 10), (1, 3), (0, READ_LEN - 13)],
           [(0, 10), (2, 2), (0, READ_LEN - 10)])


def bam_genome(rng):
    """The genome's bytes (the chromosomes back to back, uint8 ACGT), per
    byte the methylation probability x 256 of the CpG it belongs to (its C
    or G; 0 elsewhere), and each chromosome's 1-based CpG loci."""
    import numpy as np

    n = BAM_CHROM_BP
    seq = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 2 * n,
                                                        dtype=np.uint8)]
    seq = seq.copy()
    seq[n - 1] = ord("A")  # no CpG across the chromosomes' seam
    cg = np.nonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))[0]
    drop = cg[rng.random(cg.shape[0]) >= BAM_CPG_KEEP]
    seq[drop + 1] = ord("A")
    cg = np.nonzero((seq[:-1] == ord("C")) & (seq[1:] == ord("G")))[0]
    p = np.where(rng.random(cg.shape[0] // BAM_BLOCK + 1) < 0.5, 38, 218)
    pm = np.zeros(2 * n, np.uint8)
    pm[cg] = pm[cg + 1] = p[np.arange(cg.shape[0]) // BAM_BLOCK]
    loci = [(cg[(cg >= k * n) & (cg < (k + 1) * n)] - k * n + 1).astype(
        np.int32) for k in range(2)]
    return seq, pm, loci


def _bam_records(rng, paired, n=None):
    """The records' columns, coordinate-sorted: chrom, pos (0-based), flag,
    mapq, CIGAR kind (_CIGARS), mate chrom and pos, pair id; n pairs or
    reads (default BAM_PAIRS / BAM_SE_READS)."""
    import numpy as np

    n = n or (BAM_PAIRS if paired else BAM_SE_READS)
    chrom = rng.integers(0, 2, n)
    bottom = rng.random(n) < 0.5
    if paired:
        p1 = rng.integers(0, BAM_CHROM_BP - 1000, n)
        frag = np.clip(rng.normal(320, 60, n), 170, 700).astype(np.int64)
        p2 = p1 + frag - READ_LEN
        pos = np.stack([p1, p2], 1)
        flag = np.where(bottom[:, None], [83, 163], [99, 147])
        mate = pos[:, ::-1]
        keep = np.ones((n, 2), bool)
        single = rng.random(n) < BAM_FRACS["single"]
        keep[single, rng.integers(0, 2, int(single.sum()))] = False
        rec = dict(chrom=np.repeat(chrom, 2), pos=pos.ravel(),
                   flag=flag.ravel(), mate=mate.ravel(),
                   pair=np.repeat(np.arange(n), 2))
        rec = {k: v[keep.ravel()] for k, v in rec.items()}
    else:
        pos = rng.integers(0, BAM_CHROM_BP - READ_LEN, n)
        rec = dict(chrom=chrom, pos=pos, flag=np.where(bottom, 16, 0),
                   mate=np.full(n, -1), pair=np.arange(n))
    m = rec["pos"].shape[0]
    rec["mapq"] = np.where(rng.random(m) < BAM_FRACS["low_mapq"], 5, 60)
    rec["flag"] = rec["flag"] | np.where(rng.random(m) < BAM_FRACS["dup"],
                                         0x400, 0)
    rec["kind"] = np.where(rng.random(m) < BAM_FRACS["complex"],
                           rng.integers(1, 4, m), 0)
    order = np.lexsort((rec["pos"], rec["chrom"]))
    return {k: v[order] for k, v in rec.items()}


def _bam_reads(rng, rec, sl, seq, pm):
    """The bisulfite bytes (n, READ_LEN) of the records sl: a top read's C
    stays C only at a CpG drawn methylated, a bottom read's G likewise;
    1 in 1,000 bytes is N, and each CIGAR kind shapes its bytes as
    tests/bisim.py's variants do."""
    import numpy as np

    g = rec["chrom"][sl] * BAM_CHROM_BP + rec["pos"][sl]
    win = np.lib.stride_tricks.sliding_window_view
    r = win(seq, READ_LEN)[g]
    meth = rng.integers(0, 256, r.shape, dtype=np.uint8) < win(pm,
                                                               READ_LEN)[g]
    flag = rec["flag"][sl]
    bottom = (((flag & 0x53) == 83) | ((flag & 0xA3) == 163)
              | ((flag & 0x11) == 0x10))
    top = ~bottom
    rt, rb = r[top], r[bottom]
    rt[(rt == ord("C")) & ~meth[top]] = ord("T")
    rb[(rb == ord("G")) & ~meth[bottom]] = ord("A")
    r[top], r[bottom] = rt, rb
    flat = r.reshape(-1)
    flat[rng.integers(0, flat.size, rng.binomial(flat.size, 1e-3))] = ord("N")
    kind = rec["kind"][sl]
    rows = np.nonzero(kind == 1)[0]  # 5S: 5 A's, then the first 145 bytes
    r[rows, 5:] = r[rows, :READ_LEN - 5]
    r[rows, :5] = ord("A")
    rows = np.nonzero(kind == 2)[0]  # 10M3I: 3 A's after the 10th byte
    r[rows, 13:] = r[rows, 10:READ_LEN - 3]
    r[rows, 10:13] = ord("A")
    return r


# each CIGAR kind's bytes in a record's widest CIGAR slot (3 words), and
# which bytes of a record laid out at the widest a kind keeps
_CIGAR_SLOT = 12
_REC_MAX = 36 + 10 + _CIGAR_SLOT + READ_LEN // 2 + READ_LEN


def _cigar_tables():
    import numpy as np

    words = np.zeros((len(_CIGARS), _CIGAR_SLOT), np.uint8)
    keep = np.ones((len(_CIGARS), _REC_MAX), bool)
    for k, cig in enumerate(_CIGARS):
        w = np.array([(ln << 4) | o for o, ln in cig], "<u4").view(np.uint8)
        words[k, :w.size] = w
        keep[k, 46 + w.size:46 + _CIGAR_SLOT] = False
    return words, keep


def _encode_chunk(rng, rec, sl, seq, pm, paired):
    """The BAM records of sl, as bytes: each laid out at the widest CIGAR,
    then the unused CIGAR bytes dropped."""
    import numpy as np

    n = sl.stop - sl.start
    reads = _bam_reads(rng, rec, sl, seq, pm)
    nib = np.array(_NIB, np.uint8)[reads]
    kind = rec["kind"][sl]
    words, keep = _cigar_tables()
    nc = np.array([len(c) for c in _CIGARS])[kind]
    hdr = np.zeros(n, np.dtype([
        ("bs", "<i4"), ("ref", "<i4"), ("pos", "<i4"), ("lqn", "u1"),
        ("mapq", "u1"), ("bin", "<u2"), ("nc", "<u2"), ("flag", "<u2"),
        ("lseq", "<i4"), ("nref", "<i4"), ("npos", "<i4"), ("tlen", "<i4")]))
    hdr["bs"] = 32 + 10 + 4 * nc + READ_LEN // 2 + READ_LEN
    hdr["ref"] = rec["chrom"][sl]
    hdr["pos"] = rec["pos"][sl]
    hdr["lqn"] = 10
    hdr["mapq"] = rec["mapq"][sl]
    hdr["nc"] = nc
    hdr["flag"] = rec["flag"][sl]
    hdr["lseq"] = READ_LEN
    hdr["nref"] = rec["chrom"][sl] if paired else -1
    hdr["npos"] = rec["mate"][sl]
    mat = np.empty((n, _REC_MAX), np.uint8)
    mat[:, :36] = hdr.view(np.uint8).reshape(n, 36)
    pw = 10 ** np.arange(7, -1, -1, dtype=np.int64)
    mat[:, 36] = ord("p")  # the qname "p%08d\0" of the pair
    mat[:, 37:45] = rec["pair"][sl][:, None] // pw % 10 + ord("0")
    mat[:, 45] = 0
    mat[:, 46:46 + _CIGAR_SLOT] = words[kind]
    o = 46 + _CIGAR_SLOT
    mat[:, o:o + READ_LEN // 2] = (nib[:, 0::2] << 4) | nib[:, 1::2]
    mat[:, o + READ_LEN // 2:] = 0xFF
    return mat[keep[kind]].tobytes()


def write_bam(path, seed, paired, seq, pm, n=None):
    """A coordinate-sorted BGZF BAM of n (default BAM_PAIRS) pairs (paired)
    or BAM_SE_READS reads over the genome, BAM_FRACS of them with a complex
    CIGAR, MAPQ 5, a duplicate flag or (pairs) no mate; chunks of
    BAM_CHUNK records are made and compressed on the host's cores, each
    from its own seed. Returns the records' count."""
    import numpy as np

    from wgbs_tools_tpu_torch.native import bgzf_compress_native

    rec = _bam_records(np.random.default_rng(seed), paired, n)
    text = "".join(f"@SQ\tSN:{c}\tLN:{BAM_CHROM_BP}\n" for c in BAM_CHROMS)
    head = (b"BAM\x01" + struct.pack("<i", len(text)) + text.encode()
            + struct.pack("<i", 2) + b"".join(
                struct.pack("<i", len(c) + 1) + c.encode() + b"\x00"
                + struct.pack("<i", BAM_CHROM_BP) for c in BAM_CHROMS))
    m = rec["pos"].shape[0]

    def chunk(k):
        lo = k * BAM_CHUNK
        data = _encode_chunk(np.random.default_rng([seed, k]), rec,
                             slice(lo, min(lo + BAM_CHUNK, m)), seq, pm,
                             paired)
        comp = bgzf_compress_native(head + data if k == 0 else data,
                                    n_threads=1, level=1)
        return comp[:-len(BGZF_EOF)]

    with open(path, "wb") as f, ThreadPoolExecutor(os.cpu_count()
                                                   or 4) as pool:
        for comp in pool.map(chunk, range((m + BAM_CHUNK - 1) // BAM_CHUNK)):
            f.write(comp)
        f.write(BGZF_EOF)
    return m


BAM_RUNS = (("stream", "pe", []), ("no_stream", "pe", ["--no_stream"]),
            ("se", "se", []))
BAM_KERNELS = ("call_reads", "merge_pe")


def _bam2pat_cli(what, argv, need):
    """cmd_bam2pat.main(argv) with the launch counters set to 0 just before
    and read just after; the kernels `need` must launch. Returns (wall,
    stage seconds, launches)."""
    from wgbs_tools_tpu_torch.cli import cmd_bam2pat

    timings = {}
    _zero_launches()
    t0 = time.perf_counter()
    if cmd_bam2pat.main(argv, timings=timings):
        raise RuntimeError(f"{what} failed")
    wall = time.perf_counter() - t0
    launches = _read_launches()
    _require_launches(f"phase 11 {what}", launches, need)
    return wall, timings, launches


def _same_pat(got, want):
    """pat.gz and .csi the same bytes, .cdx the same arrays."""
    import numpy as np

    for ext in ("", ".csi"):
        if not _same(got + ext, want + ext):
            raise RuntimeError(f"{got}{ext} != {want}{ext}")
    a, b = np.load(got + ".cdx"), np.load(want + ".cdx")
    if sorted(a.files) != sorted(b.files) or not all(
            np.array_equal(a[k], b[k]) for k in a.files):
        raise RuntimeError(f"{got}.cdx's arrays != {want}.cdx's")


def _beta_oracle(pat, n_sites):
    """native.pileup_native + trim_to_uint of a pat: the beta's bytes."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import trim_to_uint
    from wgbs_tools_tpu_torch.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.native import pileup_native

    out = np.zeros((n_sites, 2), np.int64)
    for f in iter_pat(pat):
        pileup_native(f.start, f.length, f.count, f.codes, 1, n_sites, out=out)
    return trim_to_uint(out).tobytes()


@contextlib.contextmanager
def _main_path_batches():
    """Keeps, in the dict it yields, every batch that the run inside the
    block hands to call_reads_device ("call": its (args, kwargs) a call)
    and to the merge ("merge": merge_mates' six arrays a call), from every
    chromosome thread, by wrapping both functions for the block."""
    import threading

    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline import bam_columnar

    got = {"call": [], "merge": []}
    lock = threading.Lock()
    call_fn, merge_fn = calling.call_reads_device, bam_columnar.merge_mates

    def call_spy(*args, **kw):
        with lock:
            got["call"].append((args, kw))
        return call_fn(*args, **kw)

    def merge_spy(*args, **kw):
        with lock:
            got["merge"].append(args[:6])
        return merge_fn(*args, **kw)

    calling.call_reads_device, bam_columnar.merge_mates = call_spy, merge_spy
    try:
        yield got
    finally:
        calling.call_reads_device, bam_columnar.merge_mates = call_fn, \
            merge_fn


def _call_launches(call, dev, rows):
    """The call_reads launches of one batch as call_reads_device makes
    them with chunks of `rows` reads (calling.ROWS on the path): a list of
    (the launch's arguments on the card, its host pos1, lens and
    bottom)."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import calling

    (pos1, flags, paired, loci, site_base, seqmat, lens), kw = call
    R = seqmat.shape[0]
    if R == 0:
        return []
    pos1, lens, bottom, KB = calling.call_columns(pos1, flags, paired,
                                                  seqmat, lens)
    loci_t = torch.from_numpy(np.ascontiguousarray(loci, np.int32)).to(dev)
    out = []
    for lo in range(0, R, rows):
        sl = slice(lo, min(lo + rows, R))
        cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            seqmat[sl].astype(np.uint8, copy=False), lens[sl].astype(np.int32),
            pos1[sl].astype(np.int32), bottom[sl].astype(np.uint8))]
        out.append(((*cols, loci_t, int(kw["clip"]), KB), pos1[sl], lens[sl],
                    bottom[sl]))
    return out


def _edge_call(b):
    """An edge batch (call_edge_batch's dict) as _call_launches takes it."""
    return ((b["positions"], b["flags"], b["paired"], b["loci"],
             b["site_base"], b["seqmat"], b["lens"]), {"clip": b["clip"]})


# the paths of call_reads that an edge is made to reach, and no other
# (the long batch as "long"): each path with a count, every other none
EDGE_PATHS = {"sorted_tiles": {"staged"}, "dense": {"staged"},
              "wide_window": {"staged", "unsorted", "wide"},
              "random": {"unsorted"}, "long": {"long"}}


# the merge edges whose rows are too wide for a staged tile (the others
# are staged)
MERGE_BODIES = {"widths": "gather", "wide_mates": "gather"}


def merge_plan(S1, S2):
    """csrc/calling.cu's merge_pe_plan at pattern widths S1, S2: (body 0
    staged / 1 gather, pairs a tile, dynamic shared bytes)."""
    import ctypes

    from wgbs_tools_tpu_torch import _kernels

    out = (ctypes.c_int64 * 3)()
    _kernels.check(_kernels.load().merge_pe_plan(int(S1), int(S2), out),
                   "merge_pe_plan")
    return tuple(out)


def merge_body(S1, S2):
    """The body merge_pe takes at pattern widths S1, S2: "staged" (a
    tile's rows in shared memory) or "gather"."""
    return ("staged", "gather")[merge_plan(S1, S2)[0]]


def kernel_paths(launches, dev):
    """call_reads on each launch with the kernel's own path counters
    (calling.CALL_PATHS), each == its twin (tolerance 0). Returns {path:
    tiles (reads for "long")}, summed."""
    import torch

    from wgbs_tools_tpu_torch.ops import calling

    tot = dict.fromkeys(calling.CALL_PATHS, 0)
    for args, _, _, _ in launches:
        paths = torch.zeros(len(calling.CALL_PATHS), dtype=torch.int64,
                            device=dev)
        got = calling.call_reads(*args, paths=paths)
        if not all(torch.equal(a, b) for a, b in zip(
                got, calling.call_reads_plain(*args))):
            raise RuntimeError("call_reads with its path counters != twin")
        tot = {k: tot[k] + n for k, n in zip(tot, paths.tolist())}
    return tot


def _paths_text(paths):
    return "/".join(str(paths[k]) for k in paths)


def _call_bytes(pos1, lens, loci, span):
    """The bytes a call_reads launch must move: its three columns (9 bytes
    a read), 2 bytes of a row a covered CpG (the call and its neighbour),
    the loci in reach once; out first_k and span (8 bytes a read) and each
    read's packed calls, ceil(span / 4) bytes (the '.' bytes past a span
    that the kernel writes and nothing reads are not counted)."""
    import numpy as np

    R = pos1.shape[0]
    ends = pos1 + lens
    covered = int((np.searchsorted(loci, ends)
                   - np.searchsorted(loci, pos1)).sum())
    reach = int(np.searchsorted(loci, int(ends.max()))
                - np.searchsorted(loci, int(pos1.min())))
    packed = int(((span.astype(np.int64) + 3) // 4).sum())
    return 9 * R + 2 * covered + 4 * reach + 8 * R + packed, covered


def call_sectors(pos1, lens, bottom, loci, L):
    """The 32-byte sectors of a launch's (R, L) sequence matrix that its
    calls touch: each covered CpG's byte j (j = locus - pos1 + bottom,
    inside the read) and its neighbour (j + 1 top, j - 1 bottom, inside
    the read), as offsets from the matrix's start."""
    import numpy as np

    pos1 = np.asarray(pos1, np.int64)
    lens = np.asarray(lens, np.int64)
    k0 = np.searchsorted(loci, pos1)
    nv = np.searchsorted(loci, pos1 + lens) - k0
    r = np.repeat(np.arange(pos1.shape[0]), nv)
    k = np.arange(r.shape[0]) - np.repeat(np.cumsum(nv) - nv, nv) \
        + np.repeat(k0, nv)
    bot = np.asarray(bottom, np.int64)[r]
    j = loci[k].astype(np.int64) - pos1[r] + bot
    nb = j + 1 - 2 * bot
    n_r = lens[r]
    at = np.concatenate([r[(j >= 0) & (j < n_r)] * L + j[(j >= 0) & (j < n_r)],
                         r[(j >= 0) & (j < n_r) & (nb >= 0) & (nb < n_r)] * L
                         + nb[(j >= 0) & (j < n_r) & (nb >= 0) & (nb < n_r)]])
    return int(np.unique(at >> 5).shape[0])


def merge_sectors(sp1, sp2, S1, S2):
    """The 32-byte sectors of both mates' (n, S) pattern matrices that the
    merge's columns touch: each row's chars up to its span."""
    import numpy as np

    total = 0
    for sp, S in ((sp1, S1), (sp2, S2)):
        sp = np.asarray(sp, np.int64)
        r = np.nonzero(sp > 0)[0]
        a, b = (r * S) >> 5, (r * S + sp[r] - 1) >> 5
        prev = np.maximum.accumulate(np.concatenate([[-1], b[:-1]]))
        total += int(np.maximum(b - np.maximum(a, prev + 1) + 1, 0).sum())
    return total


def _launch_figures(launches, kernel, plain, bytes_of):
    """Each launch held to its twin (tolerance 0) and timed: the card's
    time (_device_ms), the time a call (_time_ms), the twin's, and its
    bound from bytes_of(launch, kernel's outputs). Returns the sums and the
    launches' sizes."""
    import torch

    tot = {"launches": 0, "ms": 0.0, "call_ms": 0.0, "plain_ms": 0.0,
           "bound_ms": 0.0, "bytes": 0, "rows": [], "ms_each": []}
    for args, host in launches:
        k = kernel(*args)
        if not all(torch.equal(a, b) for a, b in zip(k, plain(*args))):
            raise RuntimeError(f"{kernel.__name__} != its twin on a launch "
                               f"of {args[0].shape[0]:,} rows")
        n_bytes = bytes_of(host, k)
        ms = _device_ms(lambda: kernel(*args), 5)
        tot["launches"] += 1
        tot["ms"] += ms
        tot["call_ms"] += _time_ms(lambda: kernel(*args), 5)
        tot["plain_ms"] += _time_ms(lambda: plain(*args), 1)
        tot["bound_ms"] += _bound(n_bytes, 0)[0]
        tot["bytes"] += n_bytes
        tot["rows"].append(int(args[0].shape[0]))
        tot["ms_each"].append(ms)
    return tot


def _per_launch(tot):
    n = tot["launches"]
    return {k: tot[k] / n for k in ("ms", "call_ms", "plain_ms", "bound_ms")}


def _route_line(what, tot, unit):
    each = _per_launch(tot)
    return (f"{what}: {tot['launches']} launches of {min(tot['rows']):,}-"
            f"{max(tot['rows']):,} {unit} ({sum(tot['rows']):,} in all; == "
            f"twin, tolerance 0): {tot['bytes']:,} bytes, bound "
            f"{tot['bound_ms']:.4f} ms; kernel {tot['ms']:.4f} ms in all "
            f"({tot['bound_ms'] / tot['ms']:.1%} of its bound), "
            f"{each['ms']:.4f} ms a launch (the launches "
            f"{', '.join(f'{m:.4f}' for m in tot['ms_each'])}), "
            f"{each['call_ms']:.4f} a call; twin {tot['plain_ms']:.4f} ms in "
            f"all")


def _calling_timing(routes, dev, regs, dense):
    """call_reads on the launches that the streamed and whole-file runs
    made (their batches split at calling.ROWS as call_reads_device splits
    them), each == its twin on the card, each streamed batch's
    call_reads_device == numpy's call_reads_mat (tolerance 0; the whole-
    file run's bytes were held to --device cpu's); timed a launch beside
    its bound and the 32-byte sectors of the rows its calls touch, with
    the h2d of the sequence matrices and numpy's time on the streamed
    batches, and the tiles by path (kernel_paths); chr1's whole-file batch
    in one launch, == its twin; and the dense batch (dense_batch) in one
    launch, also == numpy. Returns the kernel's results: its figures a
    launch on the default (streamed) route."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline.calling import call_reads_mat

    def call_bytes(host, k):
        return _call_bytes(*host, k[1].cpu().numpy())[0]

    def figures(launches):
        fig = _launch_figures(
            [(a, (p, n, a[4].cpu().numpy())) for a, p, n, _ in launches],
            calling.call_reads, calling.call_reads_plain, call_bytes)
        fig["sectors"] = sum(call_sectors(p, n, bt, a[4].cpu().numpy(),
                                          a[0].shape[1])
                             for a, p, n, bt in launches)
        fig["paths"] = kernel_paths(launches, dev)
        return fig

    def sectors_text(tot):
        return (f"; the rows' 32-byte sectors the calls touch "
                f"{tot['sectors']:,} ({32 * tot['sectors']:,} bytes); tiles "
                f"staged/unsorted/wide, long-body reads "
                f"{_paths_text(tot['paths'])}")

    res, lines = {}, []
    for name, batches in routes.items():
        numpy_s = h2d_s = 0.0
        tot = None
        for call in batches:
            (pos1, flags, paired, loci, site_base, seqmat, lens), kw = call
            if name == "stream":
                t0 = time.perf_counter()
                want = call_reads_mat(pos1, flags, paired, loci, site_base,
                                      seqmat, lens, clip=kw["clip"])
                numpy_s += time.perf_counter() - t0
                got = calling.call_reads_device(
                    pos1, flags, paired, loci, site_base, seqmat, lens,
                    clip=kw["clip"], device=dev)
                if not all(a.dtype == b.dtype and np.array_equal(a, b)
                           for a, b in zip(got, want)):
                    raise RuntimeError("call_reads_device on cuda != "
                                       "call_reads_mat on a streamed batch")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            torch.from_numpy(seqmat).to(dev)
            torch.cuda.synchronize()
            h2d_s += time.perf_counter() - t0
            launches = _call_launches(call, dev, calling.ROWS)
            part = figures(launches)
            tot = part if tot is None else {
                k: ({p: tot[k][p] + part[k][p] for p in tot[k]}
                    if k == "paths" else tot[k] + part[k]) for k in tot}
            del launches
            torch.cuda.empty_cache()
        tot.update(h2d_ms=1e3 * h2d_s, numpy_ms=1e3 * numpy_s,
                   batches=len(batches))
        res[name] = tot
        line = _route_line(f"call_reads on the {name} run's launches ("
                           f"{len(batches)} batches)", tot, "reads")
        line += sectors_text(tot)
        line += (f"; h2d of the sequence matrices (pageable) "
                 f"{tot['h2d_ms']:.3f} ms" + (
                     f"; == call_reads_mat, numpy {tot['numpy_ms']:.1f} ms"
                     if name == "stream" else ""))
        log("phase 11: " + line)
        lines.append(line)
    # chr1's whole-file batch in a single launch, a launch no route makes
    call = next(c for c in routes["no_stream"]
                if c[1].get("chrom") == BAM_CHROMS[0])
    (args, pos1, lens, _), = _call_launches(call, dev, call[0][5].shape[0])
    k = calling.call_reads(*args)
    if not all(torch.equal(a, b) for a, b in zip(
            k, calling.call_reads_plain(*args))):
        raise RuntimeError("call_reads != its twin on chr1's whole-file "
                           "batch in one launch")
    n_bytes, covered = _call_bytes(pos1, lens, call[0][3],
                                   k[1].cpu().numpy())
    one = {"reads": int(pos1.shape[0]), "bytes": n_bytes,
           "bound_ms": _bound(n_bytes, 0)[0],
           "ms": _device_ms(lambda: calling.call_reads(*args), 10)}
    del args, k
    torch.cuda.empty_cache()
    line = (f"call_reads on chr1's whole-file batch in one launch "
            f"({one['reads']:,} reads, {covered:,} covered CpGs; == twin, "
            f"tolerance 0): "
            f"{n_bytes:,} bytes, bound {one['bound_ms']:.4f} ms; kernel "
            f"{one['ms']:.4f} ms ({one['bound_ms'] / one['ms']:.1%}); "
            f"registers {regs.get('call_reads')}")
    log("phase 11: " + line)
    lines.append(line)
    # the dense batch (RRBS-like, a CpG every 4-10 bp) in one launch
    call = _edge_call(dense)
    want = call_reads_mat(*call[0], clip=dense["clip"])
    got = calling.call_reads_device(*call[0], clip=dense["clip"],
                                    device=dev)
    if not all(a.dtype == b.dtype and np.array_equal(a, b)
               for a, b in zip(got, want)):
        raise RuntimeError("call_reads_device on cuda != call_reads_mat on "
                           "the dense batch")
    res["dense"] = figures(_call_launches(call, dev, calling.ROWS))
    covered = _call_bytes(dense["positions"], dense["lens"], dense["loci"],
                          want[2])[1]
    line = _route_line(f"call_reads on the dense batch ({covered:,} "
                       f"covered CpGs, == call_reads_mat)", res["dense"],
                       "reads")
    log("phase 11: " + line + sectors_text(res["dense"]))
    lines.append(line + sectors_text(res["dense"]))
    torch.cuda.empty_cache()
    job = res["stream"]
    return {"max_abs_err": 0, **_per_launch(job), "bound_by": "bytes",
            "library_ms": None, "bytes_per_launch":
            job["bytes"] / job["launches"], "job": job,
            "whole_file": res["no_stream"], "single_launch": one,
            "dense": res["dense"]}, lines, want


def _merge_launches(merge, dev, rows):
    """The merge_pe launches of one batch as merge_pe_device makes them
    with chunks of `rows` pairs: a list of (the launch's arguments on the
    card, its host spans of both mates)."""
    import numpy as np
    import torch

    s1, p1, sp1, s2, p2, sp2 = merge
    out = []
    for lo in range(0, s1.shape[0], rows):
        sl = slice(lo, min(lo + rows, s1.shape[0]))
        args = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
            np.asarray(s1[sl], np.int64), np.asarray(sp1[sl], np.int32),
            p1[sl].astype(np.uint8, copy=False),
            np.asarray(s2[sl], np.int64), np.asarray(sp2[sl], np.int32),
            p2[sl].astype(np.uint8, copy=False))]
        out.append((args, (np.asarray(sp1[sl], np.int64),
                           np.asarray(sp2[sl], np.int64))))
    return out


def _merge_bytes(sp1, sp2, span):
    """The bytes a merge_pe launch must move: the starts and spans (24
    bytes a pair), each mate's chars up to its span; out the start, span
    and too_long (13 bytes a pair) and each pair's packed codes, ceil(span
    / 4) bytes (not the 75 the kernel writes)."""
    n = sp1.shape[0]
    return (24 * n + int(sp1.sum() + sp2.sum()) + 13 * n
            + int(((span.astype("int64") + 3) // 4).sum()))


def _merging_timing(routes, dev, regs, dense):
    """merge_pe on the launches that the streamed and whole-file runs made
    (at calling.ROWS pairs a launch, as merge_pe_device makes them), each
    == its twin on the card, each streamed batch's merge_pe_device ==
    numpy's merge_pe_mat (tolerance 0), timed a launch beside its bound,
    the 32-byte sectors of the rows its columns touch, its body
    (merge_body) and numpy's time; and on the dense batch's pairs
    (dense_pairs of its calls `dense`), also == numpy. Returns its figures
    a launch on the streamed route."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline.calling import merge_pe_mat

    res, lines = {}, []
    routes = dict(routes, dense=[dense_pairs(dense)])
    for name, batches in routes.items():
        numpy_s, tot, too_long, sectors = 0.0, None, 0, 0
        bodies = set()
        for merge in batches:
            if merge[0].shape[0] == 0:  # merge_pe_device launches nothing
                continue
            if name != "no_stream":
                t0 = time.perf_counter()
                want = merge_pe_mat(*merge)
                numpy_s += time.perf_counter() - t0
                got = calling.merge_pe_device(*merge, device=dev)
                if not all(a.dtype == b.dtype and np.array_equal(a, b)
                           for a, b in zip(got, want)):
                    raise RuntimeError(f"merge_pe_device on cuda != "
                                       f"merge_pe_mat on a {name} batch")
                too_long += int(got[3].sum())
            S1, S2 = merge[1].shape[1], merge[4].shape[1]
            bodies.add(f"{merge_body(S1, S2)} (S {S1}, {S2})")
            sectors += merge_sectors(merge[2], merge[5], S1, S2)
            part = _launch_figures(
                _merge_launches(merge, dev, calling.ROWS), calling.merge_pe,
                calling.merge_pe_plain,
                lambda host, k: _merge_bytes(*host, k[1].cpu().numpy()))
            tot = part if tot is None else {
                k: tot[k] + part[k] for k in tot}
        tot.update(numpy_ms=1e3 * numpy_s, batches=len(batches),
                   too_long=too_long, sectors=sectors,
                   bodies=sorted(bodies))
        res[name] = tot
        line = _route_line(f"merge_pe on the {name} " + (
            "batch's pairs" if name == "dense" else "run's launches"),
            tot, "pairs")
        line += (f"; the rows' 32-byte sectors the columns touch "
                 f"{sectors:,} ({32 * sectors:,} bytes); bodies "
                 f"{', '.join(tot['bodies'])}")
        line += ((f"; == merge_pe_mat, {too_long:,} too long, numpy "
                  f"{tot['numpy_ms']:.1f} ms" if name != "no_stream" else "")
                 + f"; registers {regs.get('merge_pe')}")
        log("phase 11: " + line)
        lines.append(line)
    torch.cuda.empty_cache()
    job = res["stream"]
    return {"max_abs_err": 0, **_per_launch(job), "bound_by": "bytes",
            "library_ms": None, "bytes_per_launch":
            job["bytes"] / job["launches"], "job": job,
            "whole_file": res["no_stream"], "dense": res["dense"]}, lines


def _calling_edges(dev):
    """call_reads and merge_pe on CALL_EDGE / MERGE_EDGE and call_reads on
    call_long_batch: the kernel == its twin == numpy (tolerance 0); the
    tiles of each call edge by path, from the kernel's own counters
    (kernel_paths), and each merge edge's body (merge_body). The edges of
    EDGE_PATHS must reach their paths and no other, those of MERGE_BODIES
    their body, and every path and body must be reached."""
    import numpy as np

    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline.calling import (call_reads_mat,
                                                       merge_pe_mat)

    def same(*outs):
        return all(a.dtype == b.dtype and np.array_equal(a, b)
                   for o in outs[1:] for a, b in zip(outs[0], o))

    called, reached = [], dict.fromkeys(calling.CALL_PATHS, 0)
    for name in CALL_EDGE + ("long",):
        b = call_long_batch() if name == "long" else call_edge_batch(name)
        call = _edge_call(b)
        outs = [calling.call_reads_device(*call[0], clip=b["clip"], device=d)
                for d in (dev, "cpu")]
        outs.append(call_reads_mat(*call[0], clip=b["clip"]))
        if not same(*outs):
            raise RuntimeError(f"call_reads: edge {name}: kernel, twin and "
                               "numpy differ")
        paths = kernel_paths(_call_launches(call, dev, calling.ROWS), dev)
        if name in EDGE_PATHS and {k for k, v in paths.items() if v} != \
                EDGE_PATHS[name]:
            raise RuntimeError(f"call_reads: edge {name} took the paths "
                               f"{paths}, want {sorted(EDGE_PATHS[name])}")
        reached = {k: reached[k] + paths[k] for k in reached}
        called.append(f"{name} {int((outs[0][0] >= 0).sum())} "
                      f"({_paths_text(paths)})")
    merged, bodies = [], set()
    for name in MERGE_EDGE:
        b = merge_edge_batch(name)
        outs = [calling.merge_pe_device(*b, device=d) for d in (dev, "cpu")]
        outs.append(merge_pe_mat(*b))
        if not same(*outs):
            raise RuntimeError(f"merge_pe: MERGE_EDGE {name}: kernel, twin "
                               "and numpy differ")
        body = merge_body(b[1].shape[1], b[4].shape[1])
        if body != MERGE_BODIES.get(name, "staged"):
            raise RuntimeError(f"merge_pe: MERGE_EDGE {name} took its {body} "
                               "body")
        bodies.add(body)
        merged.append(f"{name} {int((outs[0][0] >= 0).sum())}/"
                      f"{int(outs[0][3].sum())} ({body})")
    missed = [k for k, v in reached.items() if not v] + [
        k for k in ("staged", "gather") if k not in bodies]
    if missed:
        raise RuntimeError(f"the edges reach no {', '.join(missed)} path")
    threads = _merge_threads(dev)
    return (f"call_reads on CALL_EDGE and the long batch (reads with a "
            f"call; tiles staged/unsorted/wide, long-body reads): "
            f"{', '.join(called)}; merge_pe on MERGE_EDGE (merged / too "
            f"long; body): {', '.join(merged)}; {threads}")


MERGE_THREAD_ROUNDS = 40   # rounds of the batches a thread
MERGE_THREAD_WIDTHS = (80, 96, 112, 128)   # pattern widths: staged tiles
                                           # of 4 shared-memory sizes


def _merge_threads(dev):
    """merge_pe on MERGE_EDGE's staged batches, their patterns widened with
    '.' to each of MERGE_THREAD_WIDTHS, from two host threads that meet at
    a barrier before every launch, in opposite orders, so that launches of
    different dynamic shared memory meet, as the whole-file bam2pat's
    chromosome threads make them (csrc/launch.cuh holds a lock from the
    attribute to the launch): every result == the one-thread run's.
    Returns its line."""
    import threading

    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.ops import calling

    def cuda(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def widened(p, S):
        out = np.full((p.shape[0], S), ord("."), np.uint8)
        out[:, :p.shape[1]] = p
        return out

    cols, sizes = [], set()
    for name in MERGE_EDGE:
        if MERGE_BODIES.get(name, "staged") != "staged":
            continue
        s1, p1, sp1, s2, p2, sp2 = merge_edge_batch(name)
        for S in MERGE_THREAD_WIDTHS:
            cols.append((cuda(s1), cuda(sp1.astype(np.int32)),
                         cuda(widened(p1, S)), cuda(s2),
                         cuda(sp2.astype(np.int32)), cuda(widened(p2, S))))
            sizes.add(merge_plan(S, S)[2])
    want = [calling.merge_pe(*c) for c in cols]
    barrier = threading.Barrier(2)

    def run(order):
        for _ in range(MERGE_THREAD_ROUNDS):
            for i in order:
                barrier.wait()
                got = calling.merge_pe(*cols[i])
                if not all(torch.equal(g, w) for g, w in zip(got, want[i])):
                    raise RuntimeError(f"merge_pe from two threads != the "
                                       f"one-thread run on batch {i}")
        return len(order) * MERGE_THREAD_ROUNDS

    orders = [list(range(len(cols))), list(range(len(cols)))[::-1]]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        n = sum(pool.map(run, orders))
    torch.cuda.synchronize()
    return (f"merge_pe from 2 threads in step: {n:,} launches of "
            f"{len(cols)} batches ({len(sizes)} shared-memory sizes "
            f"{sorted(sizes)} B) in {time.perf_counter() - t0:.3f} s, each "
            "== the one-thread run")


def bam_data(work, refs, kinds=("pe", "se", "small", "counts")):
    """Phase 11's genome (its CpG index written under refs) and BAMs of
    the kinds asked ("pe", "se", and "small" / "counts": SMALL_PAIRS /
    COUNT_PAIRS pairs, which phase 12's per-record commands read), made
    from seeds. Returns ({kind: path}, CpG sites, a line that says what
    was made)."""
    import numpy as np

    from wgbs_tools_tpu_torch.genome.refdir import Genome

    t0 = time.perf_counter()
    seq, pm, loci = bam_genome(np.random.default_rng(180))
    write_cpg_index(refs, BAM_GENOME, BAM_CHROMS, loci, [BAM_CHROM_BP] * 2)
    bams = {k: op.join(work, f"{k}.bam") for k in kinds}
    n_rec = {k: write_bam(bams[k], {"pe": 181, "se": 182, "small": 183,
                                    "counts": 184}[k], k != "se", seq, pm,
                          {"small": SMALL_PAIRS,
                           "counts": COUNT_PAIRS}.get(k)) for k in kinds}
    del seq, pm
    n_sites = Genome(BAM_GENOME).get_nr_sites()
    return bams, n_sites, (
        f"data: {len(BAM_CHROMS)} x {BAM_CHROM_BP:,} bp, {n_sites:,} CpG "
        f"sites; " + ", ".join(
            f"{k}.bam {n_rec[k]:,} records "
            f"({op.getsize(bams[k]) / 1e6:.1f} MB)" for k in kinds)
        + f", made in {time.perf_counter() - t0:.3f} s")


def phase_bam2pat(work, regs):
    """Phase 11: bam2pat at chromosome scale through the port's CLI on cuda
    (the default streaming route, --no_stream, single-end), the streamed
    and single-end runs against --device cpu's bytes, --no_stream's text
    against the streamed run's, each beta against the host pileup; the two
    calling kernels against their twins on every launch the PE runs made on
    cuda, against numpy on the streamed batches, and on the edges, timed a
    launch. Returns ({kernel: results a launch of the streamed run},
    {kernel: (path, launches)}, summary line, what phase 12 reads: the
    BAMs, the CpG sites and the walls on cuda by run)."""
    import torch

    from wgbs_tools_tpu_torch import _kernels

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    body_regs, body_spills = _ptxas_registers(_kernels.BUILD_LOG,
                                              CALLING_BODIES)
    log(f"phase 11: calling.cu's bodies: ptxas registers {body_regs}, spill "
        f"bytes {body_spills}")
    bams, n_sites, line = bam_data(work, os.environ["WGBS_TPU_REFDIR"])
    log("phase 11: " + line)
    lines, launches, batches, walls = [line], {}, {}, {}
    for name, bam, flags in BAM_RUNS:
        outs = {}
        # the two PE runs' pat texts are held to each other below, their
        # betas to the host pileup, and every launch of their calling
        # kernels to its twin: no --device cpu run of their own; the SE
        # run keeps its --device cpu run
        for device in ("cuda", "cpu") if name == "se" else ("cuda",):
            d = op.join(work, f"bam_{name}_{device}")
            os.makedirs(d)
            need = ((("call_reads", "merge_pe") if bam == "pe"
                     else ("call_reads",)) + ("flat_vals_fused",)
                    if device == "cuda" else ())
            main_path = device == "cuda" and bam == "pe"
            with (_main_path_batches() if main_path
                  else contextlib.nullcontext({})) as got:
                wall, tm, ln = _bam2pat_cli(
                    f"bam2pat {name} --device {device}",
                    [bams[bam], "-o", d, "--genome", BAM_GENOME, "--device",
                     device] + flags, need)
            if main_path:
                batches[name] = got
            outs[device] = (op.join(d, bam + ".pat.gz"), wall, tm, ln)
        got = outs["cuda"][0]
        beta = got[: -len(".pat.gz")] + ".beta"
        if "cpu" in outs:
            want = outs["cpu"][0]
            _same_pat(got, want)
            if not _same(beta, want[: -len(".pat.gz")] + ".beta"):
                raise RuntimeError(f"{beta} != --device cpu's")
        with open(beta, "rb") as f:
            if f.read() != _beta_oracle(got, n_sites):
                raise RuntimeError(f"{beta} != the host pileup's")
        ln = outs["cuda"][3]
        if name == "stream":
            launches.update({k: ("phase 11 bam2pat CLI (default: streamed)",
                                 ln) for k in BAM_KERNELS})
        wall, tm = outs["cuda"][1:3]
        walls[name] = wall
        line = (f"bam2pat {name} on cuda: {wall:.3f} s ({_stages(tm)}), "
                f"launches call_reads {ln['call_reads']} merge_pe "
                f"{ln['merge_pe']} flat_vals_fused {ln['flat_vals_fused']} "
                f"flat_classic {ln['flat_classic']}; " + (
                    f"--device cpu {outs['cpu'][1]:.3f} s "
                    f"({_stages(outs['cpu'][2])}); pat.gz "
                    f"({op.getsize(got):,} bytes) and .csi == --device "
                    f"cpu's, .cdx arrays equal, beta == --device cpu's and "
                    if "cpu" in outs else f"pat.gz ({op.getsize(got):,} "
                    f"bytes) inflates to the other PE run's text (below), "
                    f"beta == ") + "the host pileup's")
        log("phase 11: " + line)
        lines.append(line)
    # the streamed and the whole-file pat inflate to the same text
    a, b = (op.join(work, f"bam_{n}_cuda", "pe.pat.gz")
            for n in ("stream", "no_stream"))
    from wgbs_tools_tpu_torch.native import bgzf_decompress_native
    with open(a, "rb") as fa, open(b, "rb") as fb:
        if bgzf_decompress_native(fa.read()) != bgzf_decompress_native(
                fb.read()):
            raise RuntimeError("the streamed pat's text != --no_stream's")
    # the kernels on the launches the two PE runs made on cuda; the
    # streamed run's must be as many as its counters say
    res = {}
    dense = dense_batch()
    res["call_reads"], more, dense_calls = _calling_timing(
        {n: batches[n]["call"] for n in ("stream", "no_stream")}, dev, regs,
        dense)
    lines += more
    del dense
    res["merge_pe"], more = _merging_timing(
        {n: batches[n]["merge"] for n in ("stream", "no_stream")}, dev, regs,
        dense_calls)
    lines += more
    for kernel, key in (("call_reads", "call"), ("merge_pe", "merge")):
        if res[kernel]["job"]["launches"] != launches[kernel][1][kernel]:
            raise RuntimeError(
                f"{kernel}: {res[kernel]['job']['launches']} launches made "
                f"of the streamed run's batches, its counter says "
                f"{launches[kernel][1][kernel]}")
        for name in ("stream", "no_stream"):
            batches[name][key] = None
    del batches
    torch.cuda.empty_cache()
    line = "edges == twins == numpy (tolerance 0): " + _calling_edges(dev)
    log("phase 11: " + line)
    lines.append(line)
    log(f"phase 11: took {time.perf_counter() - t_phase:.3f} s")
    return res, launches, "; ".join(lines), dict(bams=bams, n_sites=n_sites,
                                                 walls=walls)


# ---------------------------------------------------------------------------
# phase 12: the commands users run after bam2pat and pat2beta: bam2pat
# --procs, the BAM-splitting commands, find_markers / test_bimodal and the
# pat-stream commands, on phase 11's BAMs and pats (and phase 10's blocks)
# ---------------------------------------------------------------------------

# pairs of the BAMs that the per-record commands read: split_by_allele
# (~10 us a record) reads SMALL_PAIRS; add_cpg_counts calls each read as
# JAX's host code does, ~730 us a read on this genome (each call's two
# searches cast the chromosome's 600,000 int32 loci to int64: PERF.md
# section 4), so it and split_by_meth read COUNT_PAIRS
SMALL_PAIRS = 200_000
COUNT_PAIRS = 10_000
MARKER_FRAC = 0.01      # blocks where group A is hypo-, B hypermethylated
MARKER_REGIONS = 6      # test_bimodal's regions
MASK_BLOCKS = 2000      # mask_pat's blocks


def _write_bai(bam):
    """A .bai beside a coordinate-sorted BGZF BAM: one bin a reference with
    one chunk over its records (tests/test_multihost.py::_make_bai's
    layout), the virtual offsets from the file's BGZF block table and the
    host library's record scan."""
    import numpy as np

    from wgbs_tools_tpu_torch.pipeline.bam_columnar import scan_bam_columnar

    with open(bam, "rb") as f:
        raw = f.read()
    cs, ds = [], []
    c = d = 0
    while c + 18 <= len(raw):
        bl = struct.unpack_from("<H", raw, c + 16)[0] + 1
        cs.append(c)
        ds.append(d)
        d += struct.unpack_from("<I", raw, c + bl - 4)[0]
        c += bl
    del raw
    cs, ds = np.array(cs, np.int64), np.array(ds, np.int64)
    buf, _, names, _, cols, offs, rec_end = scan_bam_columnar(bam)
    if buf[int(offs[0, 0]) - 36:int(offs[0, 0]) - 32] != struct.pack(
            "<i", int(rec_end[0]) - int(offs[0, 0]) + 32):
        raise RuntimeError("the record scan's name offset is not 36 bytes "
                           "into its record")
    del buf

    def voff(u):
        j = int(np.searchsorted(ds, u, side="right")) - 1
        return (int(cs[j]) << 16) | int(u - ds[j])

    out = b"BAI\x01" + struct.pack("<i", len(names))
    for r in range(len(names)):
        rows = np.flatnonzero(cols[:, 0] == r)
        if not rows.size:
            out += struct.pack("<ii", 0, 0)
            continue
        out += struct.pack("<iIiQQi", 1, 4681, 1,
                           voff(int(offs[rows[0], 0]) - 36),
                           voff(int(rec_end[rows[-1]])), 0)
    with open(bam + ".bai", "wb") as f:
        f.write(out)


def _csi_lines(pat, chrom, beg, end):
    """The lines of a pat.gz whose startCpG - 1 lies in [beg, end) on
    `chrom`, found through its .csi alone (htslib's query: the chunks of
    every bin that overlaps the range)."""
    import gzip

    from wgbs_tools_tpu_torch.formats.bgzf import BgzfReader

    with open(pat + ".csi", "rb") as f:
        data = gzip.decompress(f.read())
    if data[:4] != b"CSI\x01":
        raise RuntimeError(f"{pat}.csi: not a CSI index")
    min_shift, depth, l_aux = struct.unpack_from("<3i", data, 4)
    names = data[16 + 28:16 + l_aux].rstrip(b"\x00").split(b"\x00")
    off = 16 + l_aux
    (n_ref,) = struct.unpack_from("<i", data, off)
    off += 4
    refs = []
    for _ in range(n_ref):
        (n_bin,) = struct.unpack_from("<i", data, off)
        off += 4
        bins = {}
        for _ in range(n_bin):
            b, _loff, n_chunk = struct.unpack_from("<IQi", data, off)
            off += 16
            bins[b] = [struct.unpack_from("<QQ", data, off + 16 * k)
                       for k in range(n_chunk)]
            off += 16 * n_chunk
        refs.append(bins)
    bins = refs[names.index(chrom.encode())]
    chunks = []
    for lev in range(depth + 1):
        t = ((1 << (3 * lev)) - 1) // 7
        shift = min_shift + 3 * (depth - lev)
        for b in range(t + (beg >> shift), t + ((end - 1) >> shift) + 1):
            chunks += bins.get(b, [])
    found = {}
    reader = BgzfReader(pat)
    try:
        for v0, v1 in sorted(chunks):
            reader.seek_virtual(v0)
            while reader.virtual_offset < v1:
                v = reader.virtual_offset
                line = reader.readline()
                if not line:
                    break
                tok = line.split(b"\t", 2)
                if (tok[0] == chrom.encode()
                        and beg <= int(tok[1]) - 1 < end):
                    found[v] = line
    finally:
        reader.close()
    return [found[v] for v in sorted(found)]


def _region_reads_equal(a, b, regions):
    """Region reads of two pat.gz files through their .cdx
    (formats/pat.py::iter_pat_region) and through their .csi (_csi_lines)
    give the same text; returns the lines read."""
    from wgbs_tools_tpu_torch.formats.pat import frags_to_bytes, \
        iter_pat_region

    n = 0
    for chrom, s, e in regions:
        ta, tb = (b"".join(frags_to_bytes(f) for f in iter_pat_region(
            p, (s, e), keep_extras=True)) for p in (a, b))
        if ta != tb:
            raise RuntimeError(f"{a} and {b}: the .cdx reads of sites "
                               f"[{s}, {e}) differ")
        la, lb = (_csi_lines(p, chrom, s - 1, e - 1) for p in (a, b))
        if la != lb or b"".join(la) != b"".join(
                ln for ln in ta.splitlines(keepends=True)
                if s <= int(ln.split(b"\t", 2)[1]) < e):
            raise RuntimeError(f"{a} and {b}: the .csi reads of sites "
                               f"[{s}, {e}) differ (from each other or "
                               "from the .cdx read)")
        n += ta.count(b"\n")
    return n


def _inflate(path):
    from wgbs_tools_tpu_torch.native import bgzf_decompress_native

    with open(path, "rb") as f:
        return bgzf_decompress_native(f.read())


def _sites_regions(n_sites, chrom_bounds):
    """Region reads for the index checks: (chrom, s, e) sites at the
    start, the middle and the end of each chromosome."""
    out = []
    for chrom, (lo, hi) in chrom_bounds.items():
        mid = (lo + hi) // 2
        out += [(chrom, lo, lo + 50), (chrom, mid, mid + 400),
                (chrom, hi - 30, hi)]
    return out


def _procs_run(work, ctx, regions):
    """bam2pat --procs 2 through the CLI on phase 11's PE BAM with a .bai
    (both workers on cuda:0), against the one-process streamed run's
    files. Returns the summary line."""
    bam = ctx["bams"]["pe"]
    t0 = time.perf_counter()
    _write_bai(bam)
    bai_s = time.perf_counter() - t0
    out = op.join(work, "bam_procs")
    os.makedirs(out)
    cmd = [sys.executable, "-m", "wgbs_tools_tpu_torch", "bam2pat", bam, "-o",
           out, "--genome", BAM_GENOME, "--device", "cuda", "--procs", "2"]
    t0 = time.perf_counter()
    rc, _, stderr = _run_group(cmd, 900)
    wall = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"{' '.join(cmd)} exited {rc}:\n{stderr[-3000:]}")
    workers = _worker_launches(stderr, 2, BAM_KERNELS, "phase 12 bam2pat "
                               "--procs 2")
    parts = re.findall(r"bam2pat --procs: part (\[.*?\]) decodes BAM virtual "
                       r"offsets (\S+)", stderr)
    if len(parts) != 2 or any(r == "none" for _, r in parts):
        raise RuntimeError(f"bam2pat --procs 2: each worker must decode its "
                           f"own byte range, got {parts}")
    for m in re.finditer(r"(bam2pat: \[ chr\d \] finished.*)", stderr):
        log("phase 12: worker " + m.group(1))
    one = op.join(work, "bam_stream_cuda", "pe.pat.gz")
    got = op.join(out, "pe.pat.gz")
    if _inflate(got) != _inflate(one):
        raise RuntimeError("bam2pat --procs 2: the pat's text != the one-"
                           "process run's")
    if not _same(got[:-len(".pat.gz")] + ".beta",
                 one[:-len(".pat.gz")] + ".beta"):
        raise RuntimeError("bam2pat --procs 2: the beta != the one-process "
                           "run's")
    n = _region_reads_equal(got, one, regions)
    return (f"bam2pat --procs 2 (both workers on cuda:0, each decoding its "
            f"byte range {', '.join(f'{c} {r}' for c, r in parts)}): "
            f"{wall:.3f} s from process start against the one-process "
            f"streamed {ctx['walls']['stream']:.3f} s (.bai written in "
            f"{bai_s:.3f} s); the pat inflates to the one-process text, the "
            f"beta the same bytes, the rebuilt .cdx and .csi read "
            f"{len(regions)} regions ({n} lines) as the one-process file's; "
            f"worker launches {workers}")


def _yi_totals(bam):
    """(records, records with YI, meth, unmeth summed once a read name,
    M-side / U-side / dropped counts at homog_prop 0.75)."""
    from wgbs_tools_tpu_torch.pipeline.bam import BamReader

    n = n_yi = 0
    per_name = {}
    side = {"M": 0, "U": 0, "dropped": 0}
    for rec in BamReader(bam):
        n += 1
        v = rec.get_tag("YI")
        if v is None:
            side["dropped"] += 1
            continue
        n_yi += 1
        m, u = (int(x) for x in v.split(","))
        per_name.setdefault(rec.qname, (m, u))
        tot = m + u
        prop = m / tot if tot else 0.0
        side["M" if tot and prop >= 0.75 else "U" if tot and prop <= 0.25
             else "dropped"] += 1
    return (n, n_yi, sum(m for m, _ in per_name.values()),
            sum(u for _, u in per_name.values()), side)


def _pat_calls(pat):
    """(C calls, T calls, fragments) of a pat, each row by its count."""
    from wgbs_tools_tpu_torch.formats.pat import CODE_C, CODE_T, iter_pat

    c = t = n = 0
    for f in iter_pat(pat):
        c += int(((f.codes == CODE_C).sum(1) * f.count).sum())
        t += int(((f.codes == CODE_T).sum(1) * f.count).sum())
        n += int(f.count.sum())
    return c, t, n


def _split_runs(work, ctx):
    """add_cpg_counts and split_by_meth on phase 11's COUNT_PAIRS-pair BAM,
    split_by_allele on its SMALL_PAIRS-pair BAM. Returns the summary
    line."""
    from wgbs_tools_tpu_torch.cli import cmd_bam2pat
    from wgbs_tools_tpu_torch.genome.refdir import Genome
    from wgbs_tools_tpu_torch.pipeline.bam import BamReader

    small, counts = ctx["bams"]["small"], ctx["bams"]["counts"]
    d = op.join(work, "split")
    os.makedirs(d)
    walls = {}
    # add_cpg_counts under bam2pat's filters (-F 1796 -q 10, pairs 0x3)
    t0 = time.perf_counter()
    if cmd_bam2pat.main_add_cpg_counts([counts, "-o", d, "--genome",
                                        BAM_GENOME, "--include_flags", "3"]):
        raise RuntimeError("add_cpg_counts failed")
    walls["add_cpg_counts"] = time.perf_counter() - t0
    counted = op.join(d, "counts.counts.bam")
    n_in, n_yi, ym, yu, side = _yi_totals(counted)
    d2 = op.join(work, "split_bam2pat")
    os.makedirs(d2)
    for name, bam in (("counts", counts), ("small", small)):
        wall, _, ln = _bam2pat_cli(f"bam2pat {name}",
                                   [bam, "-o", d2, "--genome", BAM_GENOME,
                                    "--device", "cuda"], BAM_KERNELS)
        walls[f"bam2pat {name}"] = wall
    pc, pt, pn = _pat_calls(op.join(d2, "counts.pat.gz"))
    # add_cpg_counts calls as the reference's add_cpg_counts.cpp does,
    # bam2pat as patter.cpp: the counts differ by the calls where the read
    # does not show the CpG's other base (tier-1 holds each to JAX's bytes)
    if not (n_yi and abs(ym - pc) <= 0.05 * pc and abs(yu - pt)
            <= 0.05 * pt):
        raise RuntimeError(f"add_cpg_counts: YI totals {ym} / {yu} far from "
                           f"the pat's C / T {pc} / {pt}")
    # split_by_meth: M + U + dropped == the input's records
    t0 = time.perf_counter()
    if cmd_bam2pat.main_split_by_meth([counted, "0.75", "-o", d]):
        raise RuntimeError("split_by_meth failed")
    walls["split_by_meth"] = time.perf_counter() - t0
    got = {k: sum(1 for _ in BamReader(op.join(d, f"counts.counts.{k}.bam")))
           for k in ("M", "U")}
    if (got["M"], got["U"]) != (side["M"], side["U"]) or (
            got["M"] + got["U"] + side["dropped"] != n_in):
        raise RuntimeError(f"split_by_meth: M {got['M']} U {got['U']} "
                           f"dropped {side['dropped']} of {n_in} records; "
                           f"by the YI tags {side}")
    # split_by_allele at the best-covered CpG of chr1, then bam2pat of each
    # part on cuda (the CLI) and on the host
    import numpy as np

    beta = np.fromfile(op.join(d2, "small.beta"), np.uint8).reshape(-1, 2)
    idx = Genome(BAM_GENOME).index
    lo, hi = idx.chrom_site_bounds(BAM_CHROMS[0])
    site = lo + int(np.argmax(beta[lo - 1:hi - 1, 1]))
    pos = int(idx.loci[site - 1])
    d3 = op.join(work, "split_allele")
    os.makedirs(d3)
    timings = {}
    _zero_launches()
    t0 = time.perf_counter()
    if cmd_bam2pat.main_split_by_allele(
            [small, f"{BAM_CHROMS[0]}:{pos}", "C/T", "-o", d3, "--genome",
             BAM_GENOME, "--device", "cuda"], timings=timings):
        raise RuntimeError("split_by_allele failed")
    walls["split_by_allele"] = time.perf_counter() - t0
    _require_launches("phase 12 split_by_allele", _read_launches(),
                      ("call_reads",))
    parts = {}
    for let in "CT":
        base = f"small.{BAM_CHROMS[0]}_{pos}{let}"
        parts[let] = sum(1 for _ in BamReader(op.join(d3, base + ".bam")))
        d4 = op.join(work, f"split_allele_cpu_{let}")
        os.makedirs(d4)
        if cmd_bam2pat.main([op.join(d3, base + ".bam"), "-o", d4,
                             "--genome", BAM_GENOME, "--device", "cpu"]):
            raise RuntimeError("bam2pat --device cpu of a split BAM failed")
        a, b = op.join(d3, base + ".pat.gz"), op.join(d4, base + ".pat.gz")
        if op.isfile(b + ".csi") or op.isfile(a + ".csi"):
            _same_pat(a, b)
        elif not _same(a, b):
            raise RuntimeError(f"{a} != --device cpu's")
        if not _same(a[:-len(".pat.gz")] + ".beta",
                     b[:-len(".pat.gz")] + ".beta"):
            raise RuntimeError(f"{a}: the beta != --device cpu's")
    if not parts["C"]:
        raise RuntimeError("split_by_allele: no read went to the C side")
    return (f"add_cpg_counts of {COUNT_PAIRS:,} pairs "
            f"{walls['add_cpg_counts']:.3f} s: {n_yi:,} of {n_in:,} records "
            f"tagged, YI {ym:,} meth / {yu:,} unmeth against bam2pat's pat "
            f"{pc:,} C / {pt:,} T ({pn:,} fragments; bam2pat on cuda "
            f"{walls['bam2pat counts']:.3f} s); split_by_meth 0.75 "
            f"{walls['split_by_meth']:.3f} s: M {got['M']:,} + U "
            f"{got['U']:,} + dropped {side['dropped']:,} == {n_in:,} "
            f"records; split_by_allele of {SMALL_PAIRS:,} pairs (bam2pat "
            f"on cuda {walls['bam2pat small']:.3f} s, call_reads "
            f"{ln['call_reads']}, merge_pe {ln['merge_pe']}) at "
            f"{BAM_CHROMS[0]}:{pos} C/T on cuda "
            f"{walls['split_by_allele']:.3f} s ({_stages(timings)}): C "
            f"{parts['C']:,} reads, T {parts['T']:,}; each part's pat, index "
            f"and beta == bam2pat --device cpu's")


def _marker_betas(work, bed):
    """Four betas over the blocks' N_SITES sites, two a group (A: a1, a2;
    B: b1, b2), made from a seed: coverage 6-22 a site (every block above
    find_markers' min_cov), methylation a block drawn from 0.1 / 0.5 /
    0.9 for both groups, except MARKER_FRAC of the blocks where A is at
    0.08 and B at 0.9 and as many the other way round; a site's meth is
    its coverage times that, rounded, moved by -1, 0 or +1."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.blocks import load_blocks

    blocks = load_blocks(bed)
    s = blocks["startCpG"]
    rng = np.random.default_rng(120)
    nb = s.shape[0]
    p = np.stack([rng.choice([0.1, 0.5, 0.9], nb)] * 2)
    kind = rng.random(nb)
    p[0, kind < MARKER_FRAC], p[1, kind < MARKER_FRAC] = 0.08, 0.9
    hyper = (kind >= MARKER_FRAC) & (kind < 2 * MARKER_FRAC)
    p[0, hyper], p[1, hyper] = 0.9, 0.08
    block = np.searchsorted(s, np.arange(1, N_SITES + 1), side="right") - 1
    paths = []
    for g, names in ((0, ("a1", "a2")), (1, ("b1", "b2"))):
        pm = p[g][block]
        for name in names:
            cov = rng.integers(6, 23, N_SITES)
            meth = np.clip(np.rint(cov * pm) + rng.integers(-1, 2, N_SITES),
                           0, cov)
            path = op.join(work, f"{name}.beta")
            np.stack([meth, cov], 1).astype(np.uint8).tofile(path)
            paths.append(path)
    groups = op.join(work, "marker_groups.csv")
    with open(groups, "w") as f:
        f.write("name,group\na1,A\na2,A\nb1,B\nb2,B\n")
    return paths, groups


def _markers_run(work, bed):
    """find_markers over the blocks and four betas in groups of 2 and 2, on
    cuda and with --device cpu: the same Markers.*.bed and params.txt
    bytes; block_sums must launch. Returns the summary line."""
    from wgbs_tools_tpu_torch.cli import cmd_markers

    t0 = time.perf_counter()
    betas, groups = _marker_betas(work, bed)
    made = time.perf_counter() - t0
    outs, walls, ln = {}, {}, None
    cwd = os.getcwd()
    try:
        for device in ("cuda", "cpu"):
            d = op.join(work, f"markers_{device}")
            os.makedirs(d)
            os.chdir(d)  # params.txt names the out_dir: the same relative one
            _zero_launches()
            t0 = time.perf_counter()
            if cmd_markers.main(["-b", bed, "-g", groups, "--betas"] + betas
                                + ["-o", "mk", "--device", device]):
                raise RuntimeError(f"find_markers --device {device} failed")
            walls[device] = time.perf_counter() - t0
            if device == "cuda":
                ln = _read_launches()
                _require_launches("phase 12 find_markers", ln,
                                  ("block_sums",))
            outs[device] = {f: open(op.join(d, "mk", f), "rb").read()
                            for f in sorted(os.listdir(op.join(d, "mk")))}
    finally:
        os.chdir(cwd)
    if outs["cuda"] != outs["cpu"]:
        raise RuntimeError("find_markers: cuda's files != --device cpu's")
    counts = {f: v.count(b"\n") - 1 for f, v in outs["cuda"].items()
              if f.startswith("Markers.")}
    if sorted(counts) != ["Markers.A.bed", "Markers.B.bed"] or min(
            counts.values()) < 1:
        raise RuntimeError(f"find_markers: expected markers in each group, "
                           f"got {counts}")
    return (f"find_markers of 4 betas (2 + 2) over {bed}'s blocks: cuda "
            f"{walls['cuda']:.3f} s (block_sums {ln['block_sums']}), "
            f"--device cpu {walls['cpu']:.3f} s, the same bytes; markers a "
            f"group {counts} (betas made in {made:.3f} s)")


def _bimodal_run(work, pe_pat, chrom_bounds):
    """test_bimodal on MARKER_REGIONS regions of phase 11's PE pat, every
    region printed. Returns the summary line."""
    from wgbs_tools_tpu_torch.cli import cmd_markers

    bed = op.join(work, "bimodal.bed")
    rows = []
    for k in range(MARKER_REGIONS):
        chrom = BAM_CHROMS[k % 2]
        lo, hi = chrom_bounds[chrom]
        s = lo + (hi - lo) * (k + 1) // (MARKER_REGIONS + 2)
        rows.append(f"{chrom}\t0\t1\t{s}\t{s + 10 + 8 * k}\n")
    with open(bed, "w") as f:
        f.write("".join(rows))
    out = op.join(work, "bimodal.tsv")
    t0 = time.perf_counter()
    if cmd_markers.main_test_bimodal([pe_pat, "-L", bed, "--genome",
                                      BAM_GENOME, "--print_all_regions",
                                      "-o", out]):
        raise RuntimeError("test_bimodal failed")
    wall = time.perf_counter() - t0
    with open(out) as f:
        lines = f.read().splitlines()
    reads = [int(ln.split("\t")[2]) for ln in lines[1:]]
    if len(reads) != MARKER_REGIONS or min(reads) < 1 or not all(
            0 <= float(ln.split("\t")[3]) <= 1 for ln in lines[1:]):
        raise RuntimeError(f"test_bimodal: {lines}")
    return (f"test_bimodal of {MARKER_REGIONS} regions {wall:.3f} s, reads "
            f"a region {reads}")


def _stream_runs(work, ctx, regions):
    """view, cview, index, merge, mask_pat, mix_pat and frag_len on phase
    11's pats. Returns the summary line."""
    import numpy as np

    from wgbs_tools_tpu_torch.cli import cmd_pat, cmd_view
    from wgbs_tools_tpu_torch.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.genome.refdir import Genome

    n_sites = ctx["n_sites"]
    pe = op.join(work, "bam_stream_cuda", "pe.pat.gz")
    se = op.join(work, "bam_se_cuda", "se.pat.gz")
    d = op.join(work, "stream_cmds")
    os.makedirs(d)
    walls = {}
    G = ["--genome", BAM_GENOME]

    def run(name, fn, argv, kernel=None):
        _zero_launches()
        t0 = time.perf_counter()
        if fn(argv + (G if fn is not cmd_pat.main_index else [])):
            raise RuntimeError(f"{name} failed")
        walls[name] = time.perf_counter() - t0
        if kernel:
            _require_launches(f"phase 12 {name}", _read_launches(), (kernel,))

    # view of the whole SE pat prints its text back
    run("view", cmd_view.main, [se, "-o", op.join(d, "se.view.pat")])
    with open(op.join(d, "se.view.pat"), "rb") as f:
        if f.read() != _inflate(se):
            raise RuntimeError("view of the whole pat != its text")
    # cview of a region, --strict: every row inside it
    chrom, s, e = regions[1]
    run("cview", cmd_view.main_cview, [pe, "-s", f"{s}-{e}", "--strict",
                                       "-o", op.join(d, "pe.cview.pat")])
    with open(op.join(d, "pe.cview.pat")) as f:
        rows = [ln.split("\t") for ln in f.read().splitlines()]
    if not rows or not all(s <= int(r[1]) and int(r[1]) + len(r[2]) <= e
                           for r in rows):
        raise RuntimeError(f"cview --strict of sites {s}-{e}: {rows[:3]}")
    # index of an unindexed copy reads regions as the original's index does
    copy = op.join(d, "se.pat.gz")
    shutil.copy(se, copy)
    run("index", cmd_pat.main_index, [copy])
    n_idx = _region_reads_equal(copy, se, regions)
    # merge: the counts add up
    run("merge", cmd_pat.main_merge, [pe, se, "-p", op.join(d, "merged")])
    totals = [sum(int(f.count.sum()) for f in iter_pat(p))
              for p in (op.join(d, "merged.pat.gz"), pe, se)]
    if totals[0] != totals[1] + totals[2]:
        raise RuntimeError(f"merge: {totals[0]} reads, the inputs "
                           f"{totals[1]} + {totals[2]}")
    # mask_pat --beta on cuda: the beta is the host pileup of the masked pat
    rng = np.random.default_rng(121)
    starts = np.sort(rng.choice(np.arange(1, n_sites - 100), MASK_BLOCKS,
                                replace=False))
    idx = Genome(BAM_GENOME).index
    cid = idx.site2chrom_id(starts)
    mask_bed = op.join(d, "mask.bed")
    with open(mask_bed, "w") as f:
        f.write("".join(f"{idx.chrom_names[c]}\t0\t1\t{a}\t{a + 1 + k % 40}\n"
                        for k, (c, a) in enumerate(zip(cid, starts))))
    run("mask_pat", cmd_pat.main_mask_pat,
        [pe, "-b", mask_bed, "-p", op.join(d, "masked"), "--beta", "--device",
         "cuda"], "flat_vals_fused")
    masked = op.join(d, "masked.pat.gz")
    with open(op.join(d, "masked.beta"), "rb") as f:
        if f.read() != _beta_oracle(masked, n_sites):
            raise RuntimeError("mask_pat: the beta != the host pileup's")
    if _pat_calls(masked)[:2] == _pat_calls(pe)[:2]:
        raise RuntimeError("mask_pat masked no call")
    # mix_pat: the SE copy has no beta, so mix_pat makes it on cuda
    mix = op.join(d, "mix")
    os.makedirs(mix)
    for src in (pe, pe[:-len(".pat.gz")] + ".beta", se):
        shutil.copy(src, mix)
    run("mix_pat", cmd_pat.main_mix_pat,
        [op.join(mix, "pe.pat.gz"), op.join(mix, "se.pat.gz"), "--rates",
         "0.3", "--seed", "7", "-p", op.join(mix, "m"), "--device", "cuda"],
        "flat_vals_fused")
    with open(op.join(mix, "se.beta"), "rb") as f:
        made = f.read()
    if made != _beta_oracle(op.join(mix, "se.pat.gz"), n_sites) or not _same(
            op.join(mix, "se.beta"), se[:-len(".pat.gz")] + ".beta"):
        raise RuntimeError("mix_pat: the beta it made != the host pileup's")
    n_mix = sum(int(f.count.sum()) for f in iter_pat(op.join(mix,
                                                             "m_1.pat.gz")))
    if not 0 < n_mix < totals[0]:
        raise RuntimeError(f"mix_pat: {n_mix} reads of {totals[0]}")
    # frag_len: the histogram counts every read once
    run("frag_len", cmd_pat.main_frag_len, [pe, "--out_path",
                                            op.join(d, "fl.txt")])
    with open(op.join(d, "fl.txt")) as f:
        hist = [int(ln.split("\t")[1]) for ln in f.read().splitlines()[1:]]
    if sum(hist) != totals[1]:
        raise RuntimeError(f"frag_len: {sum(hist)} reads, the pat {totals[1]}")
    return ("pat-stream commands on phase 11's pats: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in walls.items())
        + f"; view's text == the pat's, cview --strict rows inside sites "
          f"{s}-{e} ({len(rows)}), index reads {n_idx} lines as the "
          f"original's, merge {totals[0]:,} == {totals[1]:,} + "
          f"{totals[2]:,} reads, mask_pat's and mix_pat's betas == the host "
          f"pileup's, mix of {n_mix:,} reads, frag_len {sum(hist):,} reads")


def phase_commands(work, ctx, seg_out):
    """Phase 12: bam2pat --procs 2, add_cpg_counts / split_by_meth /
    split_by_allele, find_markers / test_bimodal and the pat-stream
    commands through the port's CLI. Returns the summary line."""
    from wgbs_tools_tpu_torch.genome.refdir import Genome

    t_phase = time.perf_counter()
    idx = Genome(BAM_GENOME).index
    bounds = {c: idx.chrom_site_bounds(c) for c in BAM_CHROMS}
    regions = _sites_regions(ctx["n_sites"], bounds)
    lines = []
    for what, fn in (
            ("procs", lambda: _procs_run(work, ctx, regions)),
            ("split", lambda: _split_runs(work, ctx)),
            ("markers", lambda: _markers_run(work, seg_out["exact_bed"])),
            ("bimodal", lambda: _bimodal_run(
                work, op.join(work, "bam_stream_cuda", "pe.pat.gz"),
                bounds)),
            ("stream", lambda: _stream_runs(work, ctx, regions))):
        t0 = time.perf_counter()
        line = fn()
        log(f"phase 12: {line} [{time.perf_counter() - t0:.3f} s]")
        lines.append(line)
    log(f"phase 12: took {time.perf_counter() - t_phase:.3f} s")
    return "; ".join(lines)


# ---------------------------------------------------------------------------
# phase 13: the last commands of the CLI (init_genome / set_default_ref, the
# beta text and bigWig commands, convert, vis's text modes, the worker)
# ---------------------------------------------------------------------------

FASTA_WIDTH = 100          # bases a FASTA line
P13_BED_BLOCKS = 2_000     # beta2bed -L / beta2bw -L / beta_stats -L's
                           # blocks (JAX's per-site Python loops)
P13_CONVERT_BLOCKS = 20    # convert -L's blocks (two ~75 ms searches a
                           # block over hg19seg's loci, as in bed2beta)
P13_BED2BETA_BP = 1_000_000   # beta2bed -r / bed2beta's region of chr2
P13_ILMN_IDS = 450_000     # the Illumina map's ids (a 450K array's count)
P13_VIS_SITES = 60         # vis's region
P13_VIS_FROM = 5_000_000   # its first site
P13_GENOME = "bam2chr_init"


def _cli_text(what, argv, walls, kernel=None):
    """The port's CLI main(argv) in this process, its stdout kept, with the
    launch counters set to 0 just before and read just after (`kernel`
    must launch); its wall into walls[what]. Returns (stdout, launches)."""
    import io

    from wgbs_tools_tpu_torch.cli.main import main

    buf = io.StringIO()
    _zero_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    walls[what] = time.perf_counter() - t0
    if rc:
        raise RuntimeError(f"phase 13 {what} exited {rc}")
    launches = _read_launches()
    if kernel is not None:
        _require_launches(f"phase 13 {what}", launches, (kernel,))
    return buf.getvalue(), launches


def write_fasta(path, seq, chroms, width=FASTA_WIDTH):
    """The chromosomes' bytes (back to back in `seq`, equal lengths) as a
    FASTA of `width`-base lines."""
    import numpy as np

    n = seq.shape[0] // len(chroms)
    with open(path, "wb") as f:
        for k, c in enumerate(chroms):
            rows = seq[k * n:(k + 1) * n].reshape(-1, width)
            f.write(f">{c}\n".encode())
            f.write(np.hstack([rows, np.full((rows.shape[0], 1), 10,
                                             np.uint8)]).tobytes())


def _init_genome_run(work, refs, walls):
    """init_genome of phase 11's genome written as a FASTA: its CpG index
    equals the one phase 11 wrote by hand; then set_default_ref switches
    the default back. Returns the summary line."""
    import numpy as np

    from wgbs_tools_tpu_torch.genome.cpg_index import CpGIndex
    from wgbs_tools_tpu_torch.genome.refdir import Genome

    t0 = time.perf_counter()
    seq, _, _ = bam_genome(np.random.default_rng(180))
    fa = op.join(work, "bam2chr.fa")
    write_fasta(fa, seq, BAM_CHROMS)
    del seq
    walls["write FASTA"] = time.perf_counter() - t0
    link = op.join(refs, "default")
    before = os.readlink(link)
    _cli_text("init_genome", ["init_genome", P13_GENOME, "--fasta_path", fa],
              walls)
    if os.readlink(link) != P13_GENOME:
        raise RuntimeError("init_genome did not set the default genome")
    got = CpGIndex.load(op.join(refs, P13_GENOME))
    want = Genome(BAM_GENOME).index
    if not (got.chrom_names == want.chrom_names
            and np.array_equal(got.loci, want.loci)
            and np.array_equal(got.chrom_offsets, want.chrom_offsets)
            and np.array_equal(got.chrom_sizes, want.chrom_sizes)):
        raise RuntimeError("init_genome's CpG index != phase 11's")
    with open(op.join(refs, P13_GENOME, "CpG.chrome.size")) as f:
        counts = f.read()
    if counts != "".join(f"{c}\t{want.chrom_nr_sites(c)}\n"
                         for c in BAM_CHROMS):
        raise RuntimeError(f"CpG.chrome.size: {counts!r}")
    _cli_text("set_default_ref", ["set_default_ref", before], walls)
    if os.readlink(link) != before:
        raise RuntimeError("set_default_ref did not switch the default")
    return (f"init_genome of a {op.getsize(fa) / 1e6:.1f} MB FASTA "
            f"({len(BAM_CHROMS)} x {BAM_CHROM_BP:,} bp): {got.nr_sites:,} "
            f"CpG sites, its loci and per-chromosome counts == phase 11's "
            f"index; set_default_ref back to {before}")


def _head_bed(src, dst, n):
    with open(src) as f, open(dst, "w") as g:
        for _, line in zip(range(n), f):
            g.write(line)
    return dst


def _numbers(text, col):
    """Column `col` of a table's data rows as floats (NA -> nan)."""
    import numpy as np

    return np.array([float("nan") if r[col] == "NA" else float(r[col])
                     for r in (ln.split("\t") for ln in
                               text.splitlines()[1:])])


def _beta_runs(work, refs, seg_out, walls):
    """The beta commands on phase 4's big.beta, phase 8's betas and
    phase 10's blocks (genome hg19seg, whose 28,217,448 loci the big beta's
    sites are read on), each against a numpy oracle or its --device cpu
    run. Returns the summary line."""
    import gzip

    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import (beta2vec, load_beta,
                                                   trim_to_uint)
    from wgbs_tools_tpu_torch.formats.bigwig import read_bigwig
    from wgbs_tools_tpu_torch.genome.refdir import Genome

    d = op.join(work, "p13")
    os.makedirs(d)
    G = ["--genome", SEG_GENOME]
    bed = seg_out["exact_bed"]
    sub = _head_bed(bed, op.join(d, "sub.bed"), P13_BED_BLOCKS)
    starts, ends = _blocks_of_head(sub)
    beta = op.join(work, "gpu", "big.beta")
    data = load_beta(beta).astype(np.int64)
    loci = Genome(SEG_GENOME).index.loci.astype(np.int64)
    lines = []

    # beta2bed -L: one line a covered site of the blocks
    out_bed = op.join(d, "big.bed")
    _cli_text("beta2bed -L", ["beta2bed", beta, "-L", sub, "-o", out_bed]
              + G, walls)
    rows = np.arange(starts[0] - 1, ends[-1] - 1)
    rows = rows[data[rows, 1] > 0]
    want = "".join(f"chr1\t{a - 1}\t{a + 1}\t{m}\t{c}\n" for a, m, c in zip(
        loci[rows].tolist(), data[rows, 0].tolist(), data[rows, 1].tolist()))
    with open(out_bed) as f:
        if f.read() != want:
            raise RuntimeError("beta2bed -L != the beta's rows")
    lines.append(f"beta2bed -L of {P13_BED_BLOCKS:,} blocks: {len(rows):,} "
                 f"lines == the beta's rows")
    # bed2beta --add_one of beta2bed's bed: the beta's bytes at its sites, 0
    # elsewhere. On phase 11's SE beta over a region of its genome: bed2beta
    # (JAX's code) searches a chromosome's int32 loci with a Python int a
    # line, which numpy casts to int64 whole: ~75 ms a search over the
    # 28,217,448 loci of hg19seg's one chromosome, ~0.3 ms over bam2chr's
    se_beta = op.join(work, "bam_se_cuda", "se.beta")
    region = f"chr2:1-{P13_BED2BETA_BP}"
    se_bed = op.join(d, "se.bed")
    B = ["--genome", BAM_GENOME]
    _cli_text("beta2bed -r", ["beta2bed", se_beta, "-r", region, "-o",
                              se_bed] + B, walls)
    os.makedirs(op.join(d, "rt"))
    _cli_text("bed2beta", ["bed2beta", se_bed, "--add_one", "-o",
                           op.join(d, "rt")] + B, walls)
    se_data = load_beta(se_beta)
    lo, hi = Genome(BAM_GENOME).index.region2sites("chr2", 1,
                                                   P13_BED2BETA_BP)
    rt = np.zeros_like(se_data)
    rt[lo - 1:hi - 1] = se_data[lo - 1:hi - 1]
    with open(op.join(d, "rt", "se.beta"), "rb") as f:
        if f.read() != rt.tobytes():
            raise RuntimeError("bed2beta of beta2bed's bed != the beta")
    with open(se_bed) as f:
        n_rt = sum(1 for _ in f)
    lines.append(f"bed2beta --add_one of beta2bed -r {region} of the SE "
                 f"beta ({n_rt:,} lines) == the beta there, 0 elsewhere")

    # beta2bw -L: read back, the beta's values at the covered sites
    _cli_text("beta2bw -L", ["beta2bw", beta, "-L", sub, "-o", d] + G, walls)
    tracks, summary = read_bigwig(op.join(d, "big.bigwig"))
    st, en, vals = tracks["chr1"]
    if not (np.array_equal(st, loci[rows] - 1)
            and np.array_equal(en, loci[rows] + 1)
            and np.array_equal(vals, (data[rows, 0] / data[rows, 1])
                               .astype(np.float32))):
        raise RuntimeError("beta2bw -L: read_bigwig != the beta's values")
    lines.append(f"beta2bw -L: {op.getsize(op.join(d, 'big.bigwig')):,} "
                 f"bytes, read_bigwig == the beta's {len(rows):,} values")

    # beta_stats -L of the first blocks: numpy's figures
    betas = [beta, seg_out["betas"][0]]
    datas = [data, load_beta(betas[1]).astype(np.int64)]
    text, _ = _cli_text("beta_stats -L", ["beta_stats"] + betas + ["-L", sub]
                        + G, walls)
    span = slice(starts[0] - 1, ends[-1] - 1)
    for col, name in ((1, "mean_meth"), (2, "covered"), (3, "total"),
                      (4, "mean_depth")):
        want = []
        for x in (x[span] for x in datas):
            ok = x[:, 1] >= 1
            want.append({1: (x[ok, 0] / x[ok, 1]).mean(), 2: ok.sum(),
                         3: x.shape[0], 4: x[:, 1].mean()}[col])
        got = _numbers(text, col)
        if not np.allclose(got, want, rtol=0, atol=1e-4 if col == 1 else
                           (0.01 if col == 4 else 0)):
            raise RuntimeError(f"beta_stats {name}: {got} != {want}")
    lines.append(f"beta_stats -L of {len(betas)} betas == numpy's")

    # beta_cov -L over all the blocks on cuda (block_sums) == --device cpu's
    covs, ln = _cli_text("beta_cov -L", ["beta_cov"] + betas + ["-L", bed,
                         "--device", "cuda"] + G, walls, "block_sums")
    cpu, _ = _cli_text("beta_cov -L --device cpu", ["beta_cov"] + betas
                       + ["-L", bed, "--device", "cpu"] + G, walls)
    if covs != cpu or covs.count("\n") != len(betas):
        raise RuntimeError(f"beta_cov -L on cuda {covs!r} != --device cpu's "
                           f"{cpu!r}")
    lines.append(f"beta_cov -L of {len(betas)} betas over all the blocks on "
                 f"cuda == --device cpu's text, block_sums launches "
                 f"{ln['block_sums']}")

    # lbeta2beta of phase 10's block lbeta: trim_to_uint of its counts
    lbeta = op.join(work, "blocks_out", "big.lbeta")
    _cli_text("lbeta2beta", ["lbeta2beta", lbeta, "-o", d], walls)
    with open(op.join(d, "big.beta"), "rb") as f:
        if f.read() != trim_to_uint(load_beta(lbeta).astype(np.int64)) \
                .tobytes():
            raise RuntimeError("lbeta2beta != trim_to_uint of the lbeta")
    lines.append(f"lbeta2beta of a {op.getsize(lbeta):,}-byte lbeta == "
                 f"trim_to_uint")

    # compare_betas (text): numpy's pearson and rmse
    pair = list(seg_out["betas"][:2])
    text, _ = _cli_text("compare_betas", ["compare_betas"] + pair + G, walls)
    got = [float(x) for x in text.splitlines()[1].split("\t")[2:5]]
    a, b = (beta2vec(x, min_cov=10) for x in (datas[1],
                                              load_beta(pair[1])))
    both = ~np.isnan(a) & ~np.isnan(b)
    a, b = a[both], b[both]
    want = [np.corrcoef(a, b)[0, 1], np.sqrt(np.mean((a - b) ** 2)),
            both.sum()]
    if not (abs(got[0] - want[0]) <= 1e-4 and abs(got[1] - want[1]) <= 1e-4
            and got[2] == want[2]):
        raise RuntimeError(f"compare_betas {got} != numpy's {want}")
    lines.append(f"compare_betas of 2 betas == numpy's (pearson "
                 f"{got[0]:.4f})")

    # beta_to_450k over an Illumina map made from a seed: a numpy gather
    sites = np.sort(np.random.default_rng(131).choice(
        np.arange(1, N_SITES + 1), P13_ILMN_IDS, replace=False))
    with gzip.open(op.join(refs, SEG_GENOME, "ilmn2CpG.tsv.gz"), "wt",
                   compresslevel=1) as f:
        f.write("".join(f"cg{k:08d}\t{s}\n" for k, s in
                        enumerate(sites.tolist())))
    csv = op.join(d, "450k.csv")
    _cli_text("beta_to_450k", ["beta_to_450k"] + betas + ["-o", csv] + G,
              walls)
    with open(csv) as f:
        rows_ = [r.split(",") for r in f.read().splitlines()[1:]]
    if len(rows_) != P13_ILMN_IDS or rows_[7][0] != "cg00000007":
        raise RuntimeError(f"beta_to_450k: {len(rows_)} rows")
    for k, x in enumerate(datas):
        want = beta2vec(x)[sites - 1]
        got = np.array([float("nan") if r[k + 1] == "NA" else float(r[k + 1])
                        for r in rows_])
        if not (np.array_equal(np.isnan(got), np.isnan(want))
                and np.allclose(got[~np.isnan(want)], want[~np.isnan(want)],
                                rtol=0, atol=5.001e-4)):
            raise RuntimeError(f"beta_to_450k: column {k + 1} != numpy's "
                               "gather of the beta")
    lines.append(f"beta_to_450k of {P13_ILMN_IDS:,} ids == numpy's gather")

    # convert -L of the blocks: its CpG columns == the bed's own
    cbed = _head_bed(bed, op.join(d, "convert.bed"), P13_CONVERT_BLOCKS)
    out = op.join(d, "converted.bed")
    _cli_text("convert -L", ["convert", "-L", cbed, "-o", out] + G, walls)
    with open(out) as f:
        rows_ = [r.split("\t") for r in f.read().splitlines()]
    if len(rows_) != P13_CONVERT_BLOCKS or not all(
            r[3] == r[5] and r[4] == r[6] for r in rows_):
        raise RuntimeError("convert -L: the CpG columns != the bed's")
    lines.append(f"convert -L of {P13_CONVERT_BLOCKS:,} blocks: CpG columns "
                 f"== the bed's")
    return "; ".join(lines)


def _blocks_of_head(path):
    import numpy as np

    cols = np.loadtxt(path, dtype=np.int64, usecols=(3, 4), ndmin=2)
    return cols[:, 0], cols[:, 1]


def _vis_runs(work, big, walls):
    """vis --text of a region of the big pat (every read placed once a
    count: its C / H letters a column are the oracle beta's meth, its C /
    T / H letters the coverage) and vis of two betas (numpy's digits)."""
    import numpy as np

    from wgbs_tools_tpu_torch.formats.beta import load_beta

    s, e = P13_VIS_FROM, P13_VIS_FROM + P13_VIS_SITES
    text, _ = _cli_text("vis --text (pat)", [
        "vis", big, "-s", f"{s}-{e}", "--text", "--no_color", "-m",
        "1000000"], walls)
    lines = text.splitlines()
    k = next(i for i, ln in enumerate(lines) if "+" in ln and not
             ln.strip(" +"))
    col0 = lines[k].index("+")
    table = lines[k + 1:]
    oracle = load_beta(op.join(work, "big.oracle.beta"), sites=(s, e))
    for j in range(e - s):
        col = [r[col0 + j] if col0 + j < len(r) else " " for r in table]
        meth = sum(c in "CH" for c in col)
        cov = sum(c in "CTH" for c in col)
        if (meth, cov) != tuple(int(x) for x in oracle[j]):
            raise RuntimeError(f"vis --text: site {s + j} shows {meth}/{cov},"
                               f" the beta {oracle[j]}")
    betas = [op.join(work, "gpu", "big.beta"), op.join(work,
                                                       "big.oracle.beta")]
    text, _ = _cli_text("vis (betas)", ["vis"] + betas + [
        "-s", f"{s}-{e}", "--no_color"], walls)
    rows = [ln.split(": ", 1)[1] for ln in text.splitlines()[-2:]]
    for row, b in zip(rows, betas):
        x = load_beta(b, sites=(s, e)).astype(np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            v = np.round(x[:, 0] / x[:, 1] * 10, 0)
        v = np.nan_to_num(v, nan=-1).astype(int)
        v[v == 10] = 9
        v[x[:, 1] < 1] = -1
        if row != "".join("." if q == -1 else str(q) for q in v):
            raise RuntimeError(f"vis of {b}: {row!r}")
    return (f"vis --text of sites {s}-{e} of the big pat ({len(table)} "
            f"rows): each column's C / H / T letters == the oracle beta; vis "
            f"of 2 betas == numpy's digits")


_LAUNCH_LINE = re.compile(r"\[wgbs-torch worker serve\] launches (\{.*\})")


def _start_worker(work):
    """Starts `worker serve --warm` on the card, so that its start and
    warm-up run beside the other commands of the phase; a thread notes
    when its socket and its warm-up's launch line appear. Returns what
    _worker_runs and _end_worker take."""
    d = op.join(work, "p13_worker")
    os.makedirs(d)
    sock_dir = d if len(d) < 90 else tempfile.mkdtemp(prefix="wt")
    ctx = {"dir": d, "sock_dir": sock_dir,
           "sock": op.join(sock_dir, "w.sock"),
           "log": op.join(d, "server.log"),
           "cli": [sys.executable, "-m", "wgbs_tools_tpu_torch"],
           "pool": ThreadPoolExecutor(1)}
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    ctx["t0"] = time.perf_counter()
    with open(ctx["log"], "w") as srv_log:
        ctx["server"] = subprocess.Popen(
            ctx["cli"] + ["worker", "serve", "--warm", "--socket", ctx["sock"],
                          "--device", "cuda"],
            stdout=srv_log, stderr=subprocess.STDOUT, env=env,
            start_new_session=True)
    ctx["marks"] = ctx["pool"].submit(_watch_worker, ctx)
    return ctx


def _watch_worker(ctx):
    """Seconds from the server's start to its socket and to its warm-up's
    launch line (the socket is bound before the warm-up)."""
    marks = {}
    while "warm" not in marks:
        if ctx["server"].poll() is not None:
            with open(ctx["log"]) as f:
                raise RuntimeError(f"worker serve --warm exited "
                                   f"{ctx['server'].returncode}:\n"
                                   f"{f.read()[-3000:]}")
        t = time.perf_counter() - ctx["t0"]
        if t > 300:
            raise RuntimeError(f"worker serve --warm: not warm after 300 s "
                               f"({marks})")
        if "socket" not in marks and op.exists(ctx["sock"]):
            marks["socket"] = t
        if "socket" in marks:
            with open(ctx["log"]) as f:
                if _LAUNCH_LINE.search(f.read()):
                    marks["warm"] = t
        time.sleep(0.05)
    return marks


def _end_worker(ctx):
    """Kills a server still running (a phase that failed) and cleans up."""
    if ctx["server"].poll() is None:
        os.killpg(ctx["server"].pid, signal.SIGKILL)
        ctx["server"].wait()
    ctx["pool"].shutdown(wait=True)
    if ctx["sock_dir"] != ctx["dir"]:
        shutil.rmtree(ctx["sock_dir"], ignore_errors=True)


def _worker_runs(work, walls, ctx):
    """The server _start_worker started, once warm: pat2beta of phase 11's
    single-end pat in a process of its own and twice through `worker run`,
    each timed from process start; the betas the same bytes; the server's
    launch lines show flat_vals_fused at its warm-up and at each job; then
    `worker stop`. Returns the summary line."""
    se = op.join(work, "bam_se_cuda", "se.pat.gz")
    cli, sock, server = ctx["cli"], ctx["sock"], ctx["server"]
    marks = ctx["marks"].result(timeout=600)
    walls["worker serve (to its socket)"] = marks["socket"]
    walls["worker serve --warm (warm)"] = marks["warm"]
    outs = {}
    for name, pre in (("in-process", []),
                      ("worker, first", ["worker", "run", "--socket", sock]),
                      ("worker, second", ["worker", "run", "--socket",
                                          sock])):
        o = op.join(ctx["dir"], name.replace(", ", "_").replace("-", "_"))
        os.makedirs(o)
        t1 = time.perf_counter()
        rc, _, err = _run_group(cli + pre + [
            "pat2beta", se, "-o", o, "--genome", BAM_GENOME, "--device",
            "cuda"], 600)
        walls[f"pat2beta ({name})"] = time.perf_counter() - t1
        if rc:
            raise RuntimeError(f"pat2beta ({name}) exited {rc}:\n"
                               f"{err[-3000:]}")
        outs[name] = op.join(o, "se.beta")
    want = se[:-len(".pat.gz")] + ".beta"
    for name, path in outs.items():
        if not _same(path, want):
            raise RuntimeError(f"pat2beta ({name}): the beta != phase 11's")
    rc, _, err = _run_group(cli + ["worker", "stop", "--socket", sock], 120)
    if rc or server.wait(timeout=120):
        raise RuntimeError(f"worker stop: rc {rc}, server rc "
                           f"{server.returncode}:\n{err[-2000:]}")
    with open(ctx["log"]) as f:
        counts = [json.loads(m.group(1))["flat_vals_fused"]
                  for m in _LAUNCH_LINE.finditer(f.read())]
    if len(counts) != 3 or not 0 < counts[0] < counts[1] < counts[2]:
        raise RuntimeError(f"worker: flat_vals_fused launches after the "
                           f"warm-up and each job {counts}")
    return (f"worker serve --warm on cuda (started with the phase, beside "
            f"its other commands): socket after {marks['socket']:.3f} s, "
            f"warm after {marks['warm']:.3f} s; pat2beta of the SE pat from "
            f"process start: in-process {walls['pat2beta (in-process)']:.3f}"
            f" s, through the worker {walls['pat2beta (worker, first)']:.3f}"
            f" s then {walls['pat2beta (worker, second)']:.3f} s; the betas "
            f"== phase 11's bytes; flat_vals_fused launches in the server "
            f"after the warm-up and each job {counts}")


def phase_last(work, big, seg_out):
    """Phase 13: init_genome / set_default_ref, the beta text and bigWig
    commands, convert, vis's text modes and the worker through the port's
    CLI, each against its oracle, each command's wall. No figure mode runs:
    the card's machine has no matplotlib. Returns the summary line."""
    t_phase = time.perf_counter()
    refs = os.environ["WGBS_TPU_REFDIR"]
    log("phase 13: no figure mode runs here (pat_fig, vis --plot, beta_cov "
        "--plot, compare_betas' figure, mbias_plot, bam2pat --mbias's plot): "
        "the card's machine has no matplotlib; tests/test_torch_vis.py holds "
        "each figure to the JAX CLI's on the CPU")
    walls, lines = {}, []
    ctx = _start_worker(work)
    try:
        for what, fn in (
                ("init", lambda: _init_genome_run(work, refs, walls)),
                ("beta", lambda: _beta_runs(work, refs, seg_out, walls)),
                ("vis", lambda: _vis_runs(work, big, walls)),
                ("worker", lambda: _worker_runs(work, walls, ctx))):
            t0 = time.perf_counter()
            line = fn()
            log(f"phase 13: {line} [{time.perf_counter() - t0:.3f} s]")
            lines.append(line)
    finally:
        _end_worker(ctx)
    walls_line = ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
    log(f"phase 13: walls: {walls_line}")
    log(f"phase 13: took {time.perf_counter() - t_phase:.3f} s")
    return "; ".join(lines) + "; walls: " + walls_line


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frags", type=int, default=20_000_000,
                   help="fragments in the big pat (default 20,000,000)")
    args = p.parse_args()

    import torch

    t_start = time.perf_counter()
    seconds = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = round(time.perf_counter() - t0, 3)
        return out

    smi = phase("1 card", phase_card)
    build_s, regs = phase("2 build", phase_build)
    os.makedirs(op.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=op.join(REPO, "build"))
    try:
        big, deep = phase("3 data", phase_data, work, args.frags)
        kernels, slab = phase("3 kernels", phase_kernels, big, deep, regs)
        single, e2e = phase("4 pat2beta", phase_pat2beta, work, big, deep,
                            args.frags)
        sharded, split, e2e_sharded = phase("5 sharded", phase_sharded, work,
                                            big, deep, args.frags, slab)
        del slab
        workers, e2e_procs = phase("6 procs", phase_procs, work, big,
                                   args.frags)
        forms, e2e_forms = phase("7 forms", phase_forms, work, big, deep,
                                 args.frags)
        seg_kernels, seg_launches, e2e_seg, seg_out = phase(
            "8 segment", phase_segment, work, regs)
        kernels.update(seg_kernels)
        par_kernels, par_launches, e2e_par = phase(
            "9 parallel", phase_parallel, work, big, seg_out)
        kernels.update(par_kernels)
        seg_launches.update(par_launches)
        blk_kernels, blk_launches, e2e_blk = phase(
            "10 blocks", phase_blocks, work, big, args.frags, seg_out, regs)
        kernels.update(blk_kernels)
        bam_kernels, bam_launches, e2e_bam, bam_ctx = phase(
            "11 bam2pat", phase_bam2pat, work, regs)
        kernels.update(bam_kernels)
        e2e_cmds = phase("12 commands", phase_commands, work, bam_ctx,
                         seg_out)
        e2e_last = phase("13 last commands", phase_last, work, big, seg_out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    if torch.cuda.current_device() != 0:
        raise RuntimeError("the current CUDA device moved off cuda:0")
    # each kernel's launches on its path: the single-device CLI (phase 4),
    # the sharded pat2beta (phase 5), the split-plane accumulator (phase
    # 5), pat2beta through the other forms (phase 7), segment --mode fast
    # and --mode exact on the card (phase 8), the analysis step (phase 9)
    launches = {"flat_vals_fused": ("phase 4 CLI", single),
                "flat_classic": ("phase 4 CLI", single),
                "flat_vals_add": ("phase 5 sharded pat2beta", sharded),
                "flat_vals": ("phase 5 split-plane slab", split), **forms,
                "maxplus_closure": ("phase 8 segment --mode fast CLI",
                                    seg_launches["maxplus_closure"]),
                "segment_exact_dp": ("phase 8 segment --mode exact CLI "
                                     "on cuda",
                                     seg_launches["segment_exact_dp"]),
                "dp_scan": ("phase 9 analysis step", seg_launches["dp_scan"]),
                **blk_launches, **bam_launches}
    # a summary at the end, which a log that keeps only its tail still shows
    print(smi, flush=True)
    log("end to end: " + e2e)
    log("end to end: " + e2e_sharded)
    log("end to end: " + e2e_procs)
    log("end to end: " + e2e_forms)
    log("end to end: " + e2e_seg)
    log("end to end: " + e2e_par)
    log("end to end: " + e2e_blk)
    log("end to end: " + e2e_bam)
    log("end to end: " + e2e_cmds)
    log("end to end: " + e2e_last)
    print("[chip_smoke] seconds " + json.dumps(
        {"total": round(time.perf_counter() - t_start, 3),
         "phases": seconds}), flush=True)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": source,
         "replaces": replaces, "launches": launches[name][1][name],
         "path": launches[name][0], **kernels[name], "build_s": build_s,
         "registers": regs.get(name)}
        for name, (_, source, replaces) in KERNELS.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception as e:  # report which phase failed, exit nonzero
        import traceback

        traceback.print_exc()
        print(f"[chip_smoke] FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
