#!/usr/bin/env python3
"""A/B of the code-word pileup kernels (flat_classic, flat_lc,
tiled_classic) and the fragment-row kernels (tiles_v2, tiles_v1) of two
source trees, on one GPU, on the slabs that chip_smoke.py's phase 3 gives
them (tiles_v1 also on its long slab), of the max-plus closure
(maxplus_closure) on fast segmentation's batch, of exact
segmentation's DP (segment_exact_dp) on phase 8's batch, of the
analysis step's serial DP (dp_scan) on phase 9's cost shape, of the
block and read-level kernels (block_sums, pair_counts, homog_bins) on
phase 10's launches, and of bam2pat's calling kernels (call_reads,
merge_pe) on phase 11's.

    python3 kernel_ab.py OTHER_TREE [--frags N] [--reps R] [--rounds K]
                         [--listed B[,B...]] [--kernels NAME[,NAME...]]
                         [--squarings K[,K...]]

OTHER_TREE is another checkout of this repo (for the parent commit:
`git archive HEAD~1 | tar -x -C build/parent`; build/ is ignored by git).
Each tree's wgbs_tools_tpu_torch/csrc/pileup_v3.cu, pileup_v2.cu and
pileup_v1.cu are compiled by nvcc with the port's flags into a library
of its own, and both are called through ctypes on the same staged
tensors (staged by this tree; the layout is the same in both), in turns
other, this, this, other (K rounds). --listed also times this tree's
tiles_v1 in its listed (warp-per-row) form at every w16, B CTAs per SM,
in the same turns: a probe source that includes pileup_v1.cu and calls
its launch_tiles<0, B> takes pileup_v1.cu's place in a third build.
Every output must equal the kernel's plain twin. Times are the card's
(chip_smoke._device_ms: launches queued behind a spinning kernel), per
slab (for the code-word kernels both rc-class launches) and per rc-class
launch. maxplus_closure: each tree's csrc/maxplus.cu is compiled alone,
and both are called on one S0 batch (SEG_BATCH chunks of 60,000 sites
made from a seed as chip_smoke.write_seg_data makes its betas, cut into
129 x 129 edge matrices by _closure_inputs at W = 1000: 3,752 matrices;
7 squarings, or each count of --squarings), in the same turns; a tree
whose entry takes a schedule table gets this tree's upper_schedule; each
output must equal the twin's bit for bit. segment_exact_dp: each tree's
csrc/segment_exact.cu is compiled alone, and both are called on phase 8's
inputs as chip_smoke._exact_inputs makes them from chip_smoke.seg_data
(the same seed): "batch", the 470 full chunks of 60,000 sites in one
launch (K 3, max_bp 2000, Wb 128), and "cut", the first two chunks cut to
SEG_CUT sites; and on phase 8's edge case "max_bp 0, W 1000" (K 3 of
Poisson(0.2) coverage from a seed, Wb 1000): "wide", at the batch's size
(470 chunks of 60,000 sites, the batch's loci), and "wide cut", its first
two chunks cut to SEG_EDGE_SITES sites, the edge case's size; in the same
turns, with --reps R (at most 3 on the batches); both trees' ks must be
equal (and equal the twin's on the cut slabs); each tree's registers and
spills per body and, where its source has the entry, the launch and CTAs
per SM that segment_exact_dp_occupancy reports at each slab's Wb are
printed. dp_scan: each tree's csrc/dp_scan.cu is compiled alone, and both
are called in the same turns on phase 9's cost shape (kernel_ab.dps_inputs:
W 64, from chip_smoke.seg_data's samples and loci): "chains", 2 chains of
DPS_STEPS steps in one launch (one rep a turn), and "cut", their first
8,192 sites; both trees' ks must be equal on every step (and the twin's on
the cut slab); each tree's registers and spills per body and, where its
source has dp_scan_plan, the body it takes are printed. block_sums and
pair_counts: each tree's csrc/reduceat.cu / csrc/pairs.cu is compiled
alone, and both are called in the same turns on phase 10's launches, made
from chip_smoke.py's seeds: block_sums on "big.beta" (phase 4's beta of
the big pat, the port's pat2beta on cuda) over "exact blocks" (phase 8's
1,070,393 blocks, the port's exact segment on cuda of
chip_smoke.write_seg_data's betas), on chip_smoke.block_edge_batch
("whole_genome_255"), the edge batch, and on its whole-genome block alone;
pair_counts on the big pat's first slab into the hg19 table (the main
path's call: sorted, as a pat slab is). This tree's block_sums is called
as the main path calls it (the pieces launch only where a block is longer
than SPAN_ROWS); a tree whose entry takes no long-block list (the earlier
warp-a-block kernel's) is
called without it. Every output must equal
the twin's; each tree's registers and spills per kernel function are
printed. homog_bins: each tree's csrc/homog.cu is compiled alone, and
both are called in the same turns on its main-path launch: the big pat's
first slab over phase 8's exact blocks (made as for block_sums; no beta),
the CLI's default ranges at rlen 3, min_cpgs 3, and on that launch with
rows of 25, 41 and 72 calls (chip_smoke.homog_row_form: '.' calls before
each row, the same counts); every output must equal the twin's. Where the
other tree's homog.cu is the thread-a-pair body, a probe of it without
its global atomic (HOMOG_NO_ATOMIC) is timed beside them on the main-path
rows, its output unchecked. call_reads and merge_pe: each tree's
csrc/calling.cu is compiled alone, and both are called in the same turns
on phase 11's launches, made from chip_smoke.py's seeds (the PE BAM
through the port's bam2pat on cuda, streamed and --no_stream, its
batches kept by chip_smoke._main_path_batches and split at calling.ROWS
as the wrappers split them): call_reads on the streamed run's launches,
chr1's whole-file batch in one launch and the dense batch
(chip_smoke.dense_batch, 300,000 RRBS-like reads in one launch);
merge_pe on the streamed run's launches, the whole-file run's and the
dense batch's pairs (chip_smoke.dense_pairs); a turn runs a set's
launches one after another (times are per set); every output must equal
the twin's; each tree's registers and spills per body
(chip_smoke.CALLING_BODIES) are printed.
--kernels picks the kernels (default: all).
Prints the card's name and power limit, one line per kernel, slab and
run, and last one JSON object with every run's times and each tree's
ptxas registers (the most any template instance uses, and each
instance's).
"""

import argparse
import ctypes
import json
import os
import os.path as op
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

REPO = op.dirname(op.abspath(__file__))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

SRCS = ("wgbs_tools_tpu_torch/csrc/pileup_v3.cu",
        "wgbs_tools_tpu_torch/csrc/pileup_v2.cu",
        "wgbs_tools_tpu_torch/csrc/pileup_v1.cu")
# kernel -> (its pats, the staging path of chip_smoke.PHASE3)
KERNELS = {name: chip_smoke.PHASE3[name][:2]
           for name in ("flat_classic", "flat_lc", "tiled_classic",
                        "tiles_v2", "tiles_v1")}
# C entry -> (device pointers, int64 scalars) before the stream
ENTRIES = {"pileup_flat_classic": (5, 5), "pileup_flat_lc": (6, 5),
           "pileup_tiled_classic": (5, 6), "pileup_tiles_v2": (5, 6),
           "pileup_tiles_v1": (5, 5)}


MAXPLUS = "maxplus_closure"
MAXPLUS_SRC = "wgbs_tools_tpu_torch/csrc/maxplus.cu"
MAXPLUS_SEED = 20261017


def build_maxplus(tree, out_dir):
    """nvcc the tree's maxplus.cu into out_dir/lib.so; returns (its C
    entry, whether it takes the schedule table, ptxas registers)."""
    from wgbs_tools_tpu_torch import _kernels

    os.makedirs(out_dir, exist_ok=True)
    src = op.join(tree, MAXPLUS_SRC)
    so = op.join(out_dir, "lib.so")
    proc = subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                          + ["-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs = [int(m) for m in re.findall(r"Used (\d+) registers",
                                       proc.stdout + proc.stderr)]
    with open(src) as f:
        takes_sched = "const void* sched" in f.read()
    fn = ctypes.CDLL(so).maxplus_closure
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    fn.argtypes = [vp] * (3 if takes_sched else 2) + [i64] * 3 + [vp]
    fn.restype = ctypes.c_int
    return fn, takes_sched, max(regs)


def maxplus_batch(dev):
    """S0 of fast segmentation's batch: chip_smoke.SEG_BATCH chunks of
    DEF_CHUNK sites, chip_smoke.SEG_K betas of Poisson(SEG_COV) coverage
    over SEG_BLOCK-site blocks of methylation 0.15 / 0.85 and loci
    cumsum(integers(5, 60)) + 100 (write_seg_data's recipe, from this
    file's seed), cost at the CLI's defaults, cut by _closure_inputs."""
    import numpy as np

    from wgbs_tools_tpu_torch.models import segment as seg

    rng = np.random.default_rng(MAXPLUS_SEED)
    n = chip_smoke.SEG_BATCH * seg.DEF_CHUNK
    loci = np.cumsum(rng.integers(5, 60, size=n, dtype=np.int64)) + 100
    site = np.arange(n)
    datas = []
    for _ in range(chip_smoke.SEG_K):
        cov = rng.poisson(chip_smoke.SEG_COV, size=n)
        p = np.clip(0.15 + 0.7 * ((site // chip_smoke.SEG_BLOCK) % 2)
                    + rng.normal(0, 0.05, size=n), 0.01, 0.99)
        datas.append(np.stack([rng.binomial(cov, p), cov], axis=1))
    data = np.stack(datas).reshape(chip_smoke.SEG_K, chip_smoke.SEG_BATCH,
                                   seg.DEF_CHUNK, 2).transpose(1, 0, 2, 3)
    pms, pts = zip(*map(seg._prefix_sums, data))
    args = chip_smoke.SEG_ARGS
    Crev = seg._cost_fast(seg._int32(np.stack(pms), dev),
                          seg._int32(np.stack(pts), dev),
                          seg._int32(loci.reshape(chip_smoke.SEG_BATCH, -1),
                                     dev),
                          args["max_cpg"], args["max_bp"], args["pcount"])
    return seg._closure_inputs(Crev, args["max_cpg"])[1]


def ab_maxplus(trees, reps, rounds, squarings):
    """Both trees' maxplus_closure on maxplus_batch in turns, at each
    count of squarings; returns (runs, {"batch s<k>": {tree: median ms}})."""
    import torch

    from wgbs_tools_tpu_torch.ops import maxplus as mp

    dev = torch.device("cuda")
    S0 = maxplus_batch(dev)
    if chip_smoke.finite_below(S0):
        raise RuntimeError("the batch has a finite entry below the diagonal")
    nb, n, _ = S0.shape
    sched = mp._schedule_on(n, dev)
    runs, summary = [], {}
    for steps in squarings:
        want = mp.maxplus_closure_plain(S0, steps)
        calls = {}
        for tree, (fn, takes_sched, _) in trees.items():
            out = torch.empty_like(S0)
            ptrs = [S0.data_ptr(), out.data_ptr()] + (
                [sched.data_ptr()] if takes_sched else [])

            def launch(fn=fn, ptrs=ptrs, steps=steps):
                err = fn(*ptrs, nb, n, steps,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"maxplus_closure: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise RuntimeError(f"{tree} maxplus_closure, {steps} "
                                   "squarings: kernel != twin")
            calls[tree] = launch
        slab = f"batch s{steps}"
        order = (list(calls) + list(calls)[::-1]) * rounds
        for i, tree in enumerate(order):
            ms = chip_smoke._device_ms(calls[tree], reps)
            runs.append({"kernel": "maxplus_closure", "slab": slab,
                         "tree": tree, "turn": i, "ms": ms})
            chip_smoke.log(f"A/B maxplus_closure on the batch ({nb:,} "
                           f"matrices of {n} x {n}, {steps} squarings) turn "
                           f"{i} {tree}: {ms:.4f} ms == twin")
        med = summary[slab] = {
            tree: statistics.median(r["ms"] for r in runs
                                    if r["tree"] == tree
                                    and r["slab"] == slab)
            for tree in calls}
        chip_smoke.log(f"A/B maxplus_closure on the batch, {steps} "
                       "squarings: median " + ", ".join(
                           f"{tree} {v:.4f} ms ({med['other'] / v:.2f}x)"
                           for tree, v in med.items()))
    return runs, summary


SEGX = "segment_exact_dp"
SEGX_SRC = "wgbs_tools_tpu_torch/csrc/segment_exact.cu"


def build_alone(tree, src, out_dir, bodies):
    """nvcc the tree's `src` alone into out_dir/lib.so; returns (the
    library, {body: registers}, {body: spill bytes}), body by the kernel
    function's name (`bodies`, as chip_smoke._ptxas_registers takes it)."""
    from wgbs_tools_tpu_torch import _kernels

    os.makedirs(out_dir, exist_ok=True)
    src = op.join(tree, src)
    so = op.join(out_dir, "lib.so")
    proc = subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                          + ["-shared", "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}"
                           f"{proc.stderr}")
    log = op.join(out_dir, "nvcc.log")
    with open(log, "w") as f:
        f.write(proc.stdout + proc.stderr)
    regs, spills = chip_smoke._ptxas_registers(log, bodies)
    return ctypes.CDLL(so), regs, spills


def build_segx(tree, out_dir):
    """The tree's segment_exact.cu alone (build_alone), body "ahead" or
    "single"."""
    lib, regs, spills = build_alone(tree, SEGX_SRC, out_dir,
                                    chip_smoke.SEGX_BODIES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.segment_exact_dp.argtypes = [vp] * 6 + [i64] * 6 + [vp]
    lib.segment_exact_dp.restype = ctypes.c_int
    return lib, regs, spills


def segx_inputs(dev):
    """segment_exact_dp's slabs (see the module's docstring): {slab: (pm,
    pt, loci, tbl, Wb, max_bp)}, made as chip_smoke._exact_inputs makes
    them."""
    import numpy as np

    from wgbs_tools_tpu_torch.models import segment as seg

    data = chip_smoke.seg_data()
    loci = next(data)
    betas = [b.astype(np.uint8) for b in data]  # as load_beta reads them
    chunks = chip_smoke._seg_chunks()
    full = [c for c in chunks if c[1] - c[0] == seg.DEF_CHUNK]
    W, max_bp = chip_smoke.SEG_ARGS["max_cpg"], chip_smoke.SEG_ARGS["max_bp"]

    def window_loci(wins):
        return np.stack([loci[s - 1:e - 1] for s, e in wins])

    def inputs(wins, bp):
        datas = np.stack([np.stack([b[s - 1:e - 1] for b in betas])
                          for s, e in wins])
        return chip_smoke._exact_inputs(datas, window_loci(wins), W, bp,
                                        dev) + (bp,)

    slabs = {"batch": inputs(full, max_bp),
             "cut": inputs([(s, s + chip_smoke.SEG_CUT)
                            for s, _ in full[:2]], max_bp)}
    del betas
    rng = np.random.default_rng(20261017)
    cov = rng.poisson(0.2, size=(len(full), chip_smoke.SEG_K,
                                 seg.DEF_CHUNK)).astype(np.uint8)
    sparse = np.stack([rng.binomial(cov, 0.5).astype(np.uint8), cov],
                      axis=3)
    del cov
    m = chip_smoke.SEG_EDGE_SITES
    for slab, datas, locis in (
            ("wide", sparse, window_loci(full)),
            ("wide cut", sparse[:2, :, :m], window_loci(full[:2])[:, :m])):
        slabs[slab] = chip_smoke._exact_inputs(
            np.ascontiguousarray(datas), locis, W, 0, dev) + (0,)
    return slabs


def ab_segx(trees, reps, rounds):
    """The trees' segment_exact_dp on segx_inputs in turns; returns (runs,
    {slab: {tree: median ms}}, {tree: {slab: occupancy at its Wb}})."""
    import torch

    from wgbs_tools_tpu_torch.ops import segment_exact as se

    dev = torch.device("cuda")
    slabs = segx_inputs(dev)
    runs, summary, occ = [], {}, {}
    for slab, (pm, pt, tl, tbl, Wb, max_bp) in slabs.items():
        B, K, n1 = pm.shape
        calls, first = {}, None
        for tree, (lib, _, _) in trees.items():
            ks = torch.empty((B, n1 - 1), dtype=torch.int32, device=dev)

            def launch(fn=lib.segment_exact_dp, ks=ks):
                err = fn(pm.data_ptr(), pt.data_ptr(), tl.data_ptr(),
                         tbl.data_ptr(), ks.data_ptr(), None, B, K, n1 - 1,
                         Wb, max_bp, tbl.numel(),
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"segment_exact_dp: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if first is None:
                first = ks
                if "cut" in slab and not torch.equal(
                        ks, se.segment_exact_dp_plain(pm, pt, tl, tbl, Wb,
                                                      max_bp)):
                    raise RuntimeError(f"{tree} segment_exact_dp on {slab}: "
                                       "kernel != twin")
            elif not torch.equal(ks, first):
                raise RuntimeError(f"{tree} segment_exact_dp on {slab}: ks "
                                   f"!= {next(iter(trees))}'s")
            calls[tree] = launch
            if hasattr(lib, "segment_exact_dp_occupancy"):
                out = (ctypes.c_int64 * 5)()
                if lib.segment_exact_dp_occupancy(ctypes.c_int64(Wb), out):
                    raise RuntimeError("segment_exact_dp_occupancy failed")
                occ.setdefault(tree, {})[slab] = dict(zip(
                    ("ahead", "threads", "smem", "lookahead", "ctas_per_sm"),
                    out))
        order = (list(calls) + list(calls)[::-1]) * rounds
        r = reps if "cut" in slab else min(reps, 3)
        for i, tree in enumerate(order):
            ms = chip_smoke._device_ms(calls[tree], r)
            runs.append({"kernel": SEGX, "slab": slab, "tree": tree,
                         "turn": i, "ms": ms, "ns_per_step": 1e6 * ms
                         / (n1 - 1)})
            chip_smoke.log(f"A/B segment_exact_dp on {slab} ({B} windows of "
                           f"{n1 - 1:,} sites, K {K}, Wb {Wb}, max_bp "
                           f"{max_bp}) turn {i} {tree}: {ms:.4f} ms "
                           f"({1e6 * ms / (n1 - 1):.1f} ns per step), ks == "
                           "the first tree's")
        med = summary[slab] = {
            tree: statistics.median(x["ms"] for x in runs
                                    if x["tree"] == tree
                                    and x["slab"] == slab)
            for tree in calls}
        chip_smoke.log(f"A/B segment_exact_dp on {slab}: median " + ", ".join(
            f"{tree} {v:.4f} ms ({1e6 * v / (n1 - 1):.1f} ns per step, "
            f"{med['other'] / v:.2f}x)" for tree, v in med.items()))
    return runs, summary, occ


DPS = "dp_scan"
DPS_SRC = "wgbs_tools_tpu_torch/csrc/dp_scan.cu"
DPS_STEPS = 2_000_000  # steps of each of the "chains" slab's 2 chains


def build_dps(tree, out_dir):
    """The tree's dp_scan.cu alone (build_alone), bodies as
    chip_smoke.DPS_BODIES names them."""
    lib, regs, spills = build_alone(tree, DPS_SRC, out_dir,
                                    chip_smoke.DPS_BODIES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.dp_scan.argtypes = [vp] * 3 + [i64] * 3 + [vp]
    lib.dp_scan.restype = ctypes.c_int
    if hasattr(lib, "dp_scan_plan"):
        lib.dp_scan_plan.argtypes = [i64, i64, vp]
        lib.dp_scan_plan.restype = ctypes.c_int
    return lib, regs, spills


def dps_inputs(dev):
    """dp_scan's slabs, {slab: C (2, n, W) f32}: "chains", phase 9's cost
    shape (AnalysisStep's cost at W 64, max_bp 2000, pc 15: the sum over
    chip_smoke.PAR_K samples of _segment_cost_local, from
    chip_smoke.seg_data's samples and loci, without the pileup) on the first
    DPS_STEPS sites of each of phase 9's 2 site shards; "cut", each chain's
    first chip_smoke.PAR_CUT sites."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.parallel.sharded import _segment_cost_local

    data = chip_smoke.seg_data(chip_smoke.PAR_K)
    loci = torch.from_numpy(next(data).astype(np.int32))
    samples = [torch.from_numpy(d.astype(np.int32)) for d in data]
    S = chip_smoke.N_SITES // chip_smoke.PAR_MESH[1]
    W = chip_smoke.PAR_W
    C = torch.zeros((2, DPS_STEPS, W), dtype=torch.float32, device=dev)
    for j in range(2):
        rows = slice(j * S, j * S + DPS_STEPS)
        for d in samples:
            _segment_cost_local(d[rows].to(dev), loci[rows].to(dev), W,
                                chip_smoke.PAR_MAX_BP, chip_smoke.PAR_PC,
                                out=C[j])
    return {"chains": C, "cut": C[:, :chip_smoke.PAR_CUT].contiguous()}


def ab_dps(trees, reps, rounds):
    """The trees' dp_scan on dps_inputs in turns; returns (runs, {slab:
    {tree: median ms}}, {tree: the body its C entry names, or None})."""
    import torch

    from wgbs_tools_tpu_torch.ops import dp_scan as dps

    dev = torch.device("cuda")
    slabs = dps_inputs(dev)
    runs, summary, bodies = [], {}, {}
    for slab, C in slabs.items():
        nb, n, W = C.shape
        calls, first = {}, None
        for tree, (lib, _, _) in trees.items():
            floats = 0
            if hasattr(lib, "dp_scan_plan"):
                out = (ctypes.c_int64 * 4)()
                if lib.dp_scan_plan(n, W, out):
                    raise RuntimeError("dp_scan_plan failed")
                floats = out[1]
                bodies[tree] = dps.BODIES[out[0]]
            else:
                bodies[tree] = None
            scratch = (torch.empty((nb, floats), dtype=torch.float32,
                                   device=dev) if floats else None)
            ks = torch.empty((nb, n), dtype=torch.int32, device=dev)

            def launch(fn=lib.dp_scan, ks=ks, scratch=scratch):
                err = fn(C.data_ptr(), ks.data_ptr(),
                         None if scratch is None else scratch.data_ptr(),
                         nb, n, W, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"dp_scan: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if first is None:
                first = ks
                if slab == "cut" and not torch.equal(
                        ks, dps.dp_scan_plain(C, W)):
                    raise RuntimeError(f"{tree} dp_scan on {slab}: kernel "
                                       "!= twin")
            elif not torch.equal(ks, first):
                bad = (ks != first).nonzero()[:5].tolist()
                raise RuntimeError(f"{tree} dp_scan on {slab}: ks != "
                                   f"{next(iter(trees))}'s at {bad}")
            calls[tree] = launch
        order = (list(calls) + list(calls)[::-1]) * rounds
        r = reps if slab == "cut" else 1
        for i, tree in enumerate(order):
            ms = chip_smoke._device_ms(calls[tree], r)
            runs.append({"kernel": DPS, "slab": slab, "tree": tree,
                         "turn": i, "ms": ms, "ns_per_step": 1e6 * ms / n})
            chip_smoke.log(f"A/B dp_scan on {slab} ({nb} chains of {n:,} "
                           f"steps, W {W}) turn {i} {tree}: {ms:.4f} ms "
                           f"({1e6 * ms / n:.2f} ns per step), ks == the "
                           "first tree's")
        med = summary[slab] = {
            tree: statistics.median(x["ms"] for x in runs
                                    if x["tree"] == tree
                                    and x["slab"] == slab)
            for tree in calls}
        chip_smoke.log(f"A/B dp_scan on {slab}: median " + ", ".join(
            f"{tree} {v:.4f} ms ({1e6 * v / n:.2f} ns per step, "
            f"{med['other'] / v:.2f}x)" for tree, v in med.items()))
    return runs, summary, bodies


BLK, PAIRS, HOMOG = "block_sums", "pair_counts", "homog_bins"
BLK_SRC = "wgbs_tools_tpu_torch/csrc/reduceat.cu"
PAIRS_SRC = "wgbs_tools_tpu_torch/csrc/pairs.cu"
HOMOG_SRC = "wgbs_tools_tpu_torch/csrc/homog.cu"
PAIRS_BODIES = {"pair_counts_kernel": "pair_counts"}
HOMOG_BODIES = {"homog_bins_kernel": "homog_bins"}
# the probe of the thread-a-pair body (a tree whose homog.cu has that body):
# its global atomicAdd under a test no pair passes (fcount >= 1 and bin >=
# -1, so the sum is never min_cpgs - 100 at the A/B's min_cpgs 3), so every
# load and the bin stay
HOMOG_ATOMIC = re.compile(r"atomicAdd\(out \+ b \* nbins \+ bin,\s*"
                          r"\(unsigned long long\)\(long long\)"
                          r"fcount\[f\]\);")
HOMOG_NO_ATOMIC = ("if ((long long)fcount[f] + bin == min_cpgs - 100) "
                   "out[0] = 0;")


def build_blk(tree, out_dir):
    """The tree's reduceat.cu alone (build_alone); returns (library, regs,
    spills, whether its entry takes the long-block list (scratch, N,
    list_long) as this tree's does)."""
    lib, regs, spills = build_alone(tree, BLK_SRC, out_dir,
                                     chip_smoke.BLK_BODIES)
    with open(op.join(tree, BLK_SRC)) as f:
        listing = "int64_t list_long" in f.read()
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.block_sums.argtypes = ([vp] * 4 + [i64] * 4 if listing
                               else [vp] * 3 + [i64] * 2) + [vp]
    lib.block_sums.restype = ctypes.c_int
    return lib, regs, spills, listing


def build_pairs(tree, out_dir):
    """The tree's pairs.cu alone (build_alone)."""
    lib, regs, spills = build_alone(tree, PAIRS_SRC, out_dir, PAIRS_BODIES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.pair_counts.argtypes = [vp] * 5 + [i64] * 3 + [vp]
    lib.pair_counts.restype = ctypes.c_int
    return lib, regs, spills


def build_homog(tree, out_dir, no_atomic=False):
    """The tree's homog.cu alone (build_alone); its homog_bins entry takes
    the same arguments in every tree. With `no_atomic`, the thread-a-pair
    body's global atomic is taken out (HOMOG_NO_ATOMIC; None for a tree
    with another body)."""
    if no_atomic:
        with open(op.join(tree, HOMOG_SRC)) as f:
            src, n = HOMOG_ATOMIC.subn(HOMOG_NO_ATOMIC, f.read())
        if n != 1:
            return None
        tree = op.join(out_dir, "tree")
        os.makedirs(op.dirname(op.join(tree, HOMOG_SRC)), exist_ok=True)
        with open(op.join(tree, HOMOG_SRC), "w") as f:
            f.write(src)
    lib, regs, spills = build_alone(tree, HOMOG_SRC, out_dir, HOMOG_BODIES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.homog_bins.argtypes = [vp] * 10 + [i64] * 5 + [vp]
    lib.homog_bins.restype = ctypes.c_int
    return lib, regs, spills


def phase10_inputs(work, frags, which):
    """Phase 10's main-path inputs from chip_smoke.py's seeds: {"pat": the
    big pat, "beta": its beta (the port's pat2beta on cuda), "blocks":
    phase 8's exact blocks (s, e) (the port's exact segment on cuda),
    "bounds": them as block_bounds rows}; the blocks only if block_sums
    or homog_bins is in `which`, the beta and bounds only for
    block_sums."""
    from wgbs_tools_tpu_torch.cli import cmd_segment
    from wgbs_tools_tpu_torch.ops import reduceat
    from wgbs_tools_tpu_torch.pipeline.pat2beta import pat2beta

    big, _ = chip_smoke.phase_data(work, frags)
    out = {"pat": big}
    if BLK not in which and HOMOG not in which:
        return out
    if BLK in which:
        out["beta"] = pat2beta(big, out_path=op.join(work, "big.beta"),
                               device="cuda")
    betas, _ = chip_smoke.write_seg_data(work, os.environ["WGBS_TPU_REFDIR"])
    bed = op.join(work, "exact.bed")
    args = chip_smoke.SEG_ARGS
    if cmd_segment.main(["--betas"] + betas + [
            "--genome", chip_smoke.SEG_GENOME, "--max_cpg",
            str(args["max_cpg"]), "--max_bp", str(args["max_bp"]), "-p",
            str(args["pcount"]), "-o", bed]):
        raise RuntimeError("segment --mode exact on cuda failed")
    s, e = chip_smoke._blocks_of(bed)
    out["blocks"] = (s, e)
    if BLK in which:
        out["bounds"] = reduceat.block_bounds(s, e, 1, chip_smoke.N_SITES)
    return out


def _ab_turns(kernel, slab, calls, reps, rounds, runs, summary, what,
              unchecked=()):
    """calls {tree: launch} in turns other, this, this, other (rounds
    times), each timed by chip_smoke._device_ms; fills runs and summary.
    Every tree's output was held to the twin but those in `unchecked`."""
    order = (list(calls) + list(calls)[::-1]) * rounds
    for i, tree in enumerate(order):
        ms = chip_smoke._device_ms(calls[tree], reps)
        runs.append({"kernel": kernel, "slab": slab, "tree": tree,
                     "turn": i, "ms": ms})
        chip_smoke.log(f"A/B {kernel} on {slab} ({what}) turn {i} {tree}: "
                       f"{ms:.4f} ms"
                       + (" (a probe)" if tree in unchecked else " == twin"))
    med = summary[f"{kernel} {slab}"] = {
        tree: statistics.median(x["ms"] for x in runs if x["tree"] == tree
                                and x["slab"] == slab
                                and x["kernel"] == kernel)
        for tree in calls}
    chip_smoke.log(f"A/B {kernel} on {slab}: median " + ", ".join(
        f"{tree} {v:.4f} ms ({med['other'] / v:.2f}x)"
        for tree, v in med.items()))


def ab_blocks_pairs(btrees, ptrees, inputs, reps, rounds):
    """Both trees' block_sums and pair_counts on phase 10's launches, in
    turns; returns (runs, {kernel slab: {tree: median ms}})."""
    import numpy as np
    import torch

    from wgbs_tools_tpu_torch.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.ops import pairs, reduceat

    dev = torch.device("cuda")
    runs, summary = [], {}
    if btrees:
        data = np.fromfile(inputs["beta"], np.uint8).reshape(-1, 2)
        edge, es, ee = chip_smoke.block_edge_batch("whole_genome_255")
        eb = reduceat.block_bounds(es, ee, 1, edge.shape[0])
        slabs = {"big.beta over the exact blocks": (data, inputs["bounds"]),
                 "whole_genome_255": (edge, eb),
                 "the whole-genome block alone": (edge, eb[:1])}
        for slab, (d, b) in slabs.items():
            d = torch.from_numpy(d).to(dev)
            b = torch.from_numpy(b).to(dev)
            want = reduceat.block_sums_plain(d, b)
            B = b.shape[0]
            calls = {}
            # the main path's long_blocks (ops/reduceat.py::_sums_on)
            lens = b[:, 1] - b[:, 0]
            list_long = int(bool((lens > reduceat.SPAN_ROWS).any()))
            for tree, (lib, _, _, listing) in btrees.items():
                out = torch.empty((B, 2), dtype=torch.int64, device=dev)
                scratch = torch.empty(B + 1, dtype=torch.int64, device=dev)
                args = ([d.data_ptr(), b.data_ptr(), out.data_ptr(),
                         scratch.data_ptr(), B, d.shape[0], 1, list_long]
                        if listing else
                        [d.data_ptr(), b.data_ptr(), out.data_ptr(), B, 1])

                def launch(fn=lib.block_sums, args=args):
                    err = fn(*args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"block_sums: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise RuntimeError(f"{tree} block_sums on {slab}: kernel "
                                       "!= twin")
                calls[tree] = launch
            _ab_turns(BLK, slab, calls, reps, rounds, runs, summary,
                      f"{d.shape[0]:,} rows, {B:,} blocks; this tree's runs "
                      f"{chip_smoke.run_bodies(b.cpu().numpy(), list_long)}")
            del d, b, want
    if ptrees:
        frags = next(iter_pat(inputs["pat"])).slice_sites(
            1, chip_smoke.N_SITES + 1)
        cols = chip_smoke._pair_cols(frags, 1, dev)
        F, L = frags.codes.shape
        n = chip_smoke.N_SITES
        want = pairs.pair_counts_add_plain(
            torch.zeros((n, 4), dtype=torch.int32, device=dev), *cols)
        calls = {}
        for tree, (lib, _, _) in ptrees.items():
            table = torch.zeros((n, 4), dtype=torch.int32, device=dev)
            ptrs = [c.data_ptr() for c in cols] + [table.data_ptr()]

            def launch(fn=lib.pair_counts, ptrs=ptrs):
                err = fn(*ptrs, F, L, n,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"pair_counts: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if not torch.equal(table, want):
                raise RuntimeError(f"{tree} pair_counts on the first slab: "
                                   "kernel != twin")
            calls[tree] = launch
        _ab_turns(PAIRS, "the big pat's first slab", calls, reps, rounds,
                  runs, summary, f"{F:,} frags, L {L}")
    return runs, summary


def ab_homog(htrees, inputs, reps, rounds):
    """Both trees' homog_bins on its main-path launch (the big pat's first
    slab over phase 8's exact blocks, the CLI's default ranges at rlen 3)
    and on it with rows of other lengths (chip_smoke.homog_row_form: the
    same counts), in turns; every output == the twin's. The "probe" tree
    (the other tree's body without its global atomic) is timed beside
    them on the main-path rows, its output unchecked. Returns (runs,
    {kernel slab: {tree: median ms}})."""
    import torch

    from wgbs_tools_tpu_torch.formats.pat import iter_pat
    from wgbs_tools_tpu_torch.ops import frag_ops

    dev = torch.device("cuda")
    runs, summary = [], {}
    s, e = inputs["blocks"]
    slab = next(iter_pat(inputs["pat"]))
    cols = chip_smoke._homog_cols(slab, s, e, chip_smoke.HOMOG_RANGES["rlen3"],
                                  dev)
    B, P, L = len(s), cols[6].numel(), cols[0].shape[1]
    want = frag_ops.homog_bins_plain(
        torch.zeros((B, 3), dtype=torch.int64, device=dev), *cols, 3, False)
    for k in (0,) + chip_smoke.HOMOG_ROW_FORMS:
        form = chip_smoke.homog_row_form(cols, k) if k else cols
        calls = {}
        for tree, (lib, _, _) in htrees.items():
            if k and tree == "probe":
                continue
            out = torch.zeros((B, 3), dtype=torch.int64, device=dev)
            ptrs = [c.data_ptr() for c in form] + [out.data_ptr()]

            def launch(fn=lib.homog_bins, ptrs=ptrs):
                err = fn(*ptrs, P, L + k, 3, 3, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"homog_bins: CUDA error {err}")

            launch()
            torch.cuda.synchronize()
            if tree != "probe" and not torch.equal(out, want):
                raise RuntimeError(f"{tree} homog_bins on the first slab "
                                   f"(rows of {L + k}): kernel != twin")
            calls[tree] = launch
        where = "the big pat's first slab" + (f", rows of {L + k}" if k
                                              else "")
        _ab_turns(HOMOG, where, calls, reps, rounds, runs, summary,
                  f"{slab.nr_frags:,} frags, {P:,} pairs, {B:,} blocks, L "
                  f"{L + k}", unchecked=("probe",))
        del form
    return runs, summary


PROBE = """#include "{src}"
"""
PROBE_ENTRY = """extern "C" int pileup_tiles_v1_listed_b{b}(
    const void* lo, const void* hi, const void* meta, const void* words,
    void* out, int64_t num_tiles, int64_t window_len, int64_t tile,
    int64_t fc, int64_t w16, void* stream) {{
    return launch_tiles<0, {b}>(lo, hi, meta, words, out, num_tiles,
                                window_len, tile, fc, w16, stream);
}}
"""


def build(tree, out_dir, listed=()):
    """nvcc the tree's pileup_v3.cu, pileup_v2.cu and pileup_v1.cu into
    out_dir/lib.so (with `listed`, a probe in place of pileup_v1.cu that
    adds an entry pileup_tiles_v1_listed_bB for each B);
    returns (the loaded library, {kernel: registers}, whether its tiled
    entry takes max_chunks (the first tiled grid) rather than n_chunks,
    {template instance: registers})."""
    from wgbs_tools_tpu_torch import _kernels

    os.makedirs(out_dir, exist_ok=True)
    srcs = [op.join(tree, src) for src in SRCS]
    if listed:
        probe = op.join(out_dir, "probe_v1.cu")
        with open(probe, "w") as f:
            f.write(PROBE.format(src=srcs[-1]) + "".join(
                PROBE_ENTRY.format(b=b) for b in listed))
        srcs[-1] = probe
    so = op.join(out_dir, "lib.so")
    proc = subprocess.run([_kernels._nvcc()] + _kernels.NVCC_FLAGS
                          + ["-shared", "-o", so] + srcs,
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {srcs}:\n{proc.stdout}"
                           f"{proc.stderr}")
    regs, inst, entry = {}, {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in line:
            entry = next((k for k in KERNELS if k + "_kernel" in line), None)
            m = re.search(r"_kernel(I\w*?E)Ev", line)
            key = entry and entry + (m.group(1) if m else "")
        m = re.search(r"Used (\d+) registers", line)
        if m and entry is not None:
            regs[entry] = max(regs.get(entry, 0), int(m.group(1)))
            inst[key] = int(m.group(1))
    lib = ctypes.CDLL(so)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    entries = dict(ENTRIES, **{f"pileup_tiles_v1_listed_b{b}":
                               ENTRIES["pileup_tiles_v1"] for b in listed})
    for name, (n_ptr, n_int) in entries.items():
        fn = getattr(lib, name)
        fn.argtypes = [vp] * n_ptr + [i64] * n_int + [vp]
        fn.restype = ctypes.c_int
    with open(srcs[0]) as f:
        max_chunks = "int64_t max_chunks" in f.read()
    return lib, regs, max_chunks, inst


def launcher(tree_lib, name, st, span, entry=None):
    """A function that launches kernel `name` of a built tree (through its
    C entry `entry`, pileup_<name> by default) on one staged batch into its
    own output, and the output."""
    import torch

    lib, _, max_chunks, _ = tree_lib
    out = torch.zeros((span, 2), dtype=torch.int32, device=st.device)
    num_tiles = -(-span // st.tile)
    if name == "tiles_v1":
        args = [st.lo.data_ptr(), st.hi.data_ptr(), st.meta.data_ptr(),
                st.words.data_ptr(), out.data_ptr(), num_tiles, span,
                st.tile, st.fc, st.w16]
    elif name == "tiles_v2":
        args = [st.c0.data_ptr(), st.c1.data_ptr(), st.meta.data_ptr(),
                st.words.data_ptr(), out.data_ptr(), num_tiles, span,
                st.tile, st.fc, st.g_max, st.w_cols]
    else:
        planes = [st.rows.data_ptr()] + (
            [st.cnts.data_ptr()] if name == "flat_lc" else [])
        extra = ([st.max_chunks if max_chunks else st.meta.shape[0]]
                 if name == "tiled_classic" else [])
        args = ([st.c0.data_ptr(), st.c1.data_ptr(), st.meta.data_ptr()]
                + planes + [out.data_ptr(), num_tiles, span, st.tile_sb,
                            st.rc, st.g_max] + extra)
    fn = getattr(lib, entry or "pileup_" + name)

    def launch():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"pileup_{name}: CUDA error {err}")

    return launch, out


CALL, MERGE = "call_reads", "merge_pe"
CALLING_SRC = "wgbs_tools_tpu_torch/csrc/calling.cu"


def build_calling(tree, out_dir):
    """The tree's calling.cu alone (build_alone); its call_reads and
    merge_pe entries take the same arguments in every tree."""
    lib, regs, spills = build_alone(tree, CALLING_SRC, out_dir,
                                    chip_smoke.CALLING_BODIES)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.call_reads.argtypes = [vp] * 8 + [i64] * 5 + [vp]
    lib.call_reads.restype = ctypes.c_int
    lib.merge_pe.argtypes = [vp] * 10 + [i64] * 3 + [vp]
    lib.merge_pe.restype = ctypes.c_int
    return lib, regs, spills


def calling_inputs(work):
    """Phase 11's launches, made as chip_smoke.py makes them (its seeds):
    the PE BAM through bam2pat on cuda, streamed and --no_stream, with
    chip_smoke._main_path_batches keeping each run's batches; and the
    dense batch (chip_smoke.dense_batch) with its calls. Returns {"call":
    {set: [call_reads launches]}, "merge": {set: [merge_pe launches]}},
    launches as chip_smoke._call_launches / _merge_launches make them at
    calling.ROWS rows (chr1's whole-file batch in one launch)."""
    import torch

    from wgbs_tools_tpu_torch.ops import calling

    dev = torch.device("cuda")
    refs = op.join(work, "refs")
    os.makedirs(refs)
    os.environ["WGBS_TPU_REFDIR"] = refs
    bams, _, line = chip_smoke.bam_data(work, refs, ("pe",))
    chip_smoke.log("A/B calling: " + line)
    got = {}
    for name, flags in (("stream", []), ("no_stream", ["--no_stream"])):
        out = op.join(work, name)
        os.makedirs(out)
        with chip_smoke._main_path_batches() as got[name]:
            chip_smoke._bam2pat_cli(
                f"bam2pat {name}", [bams["pe"], "-o", out, "--genome",
                                    chip_smoke.BAM_GENOME, "--device",
                                    "cuda"] + flags, (CALL, MERGE))
    chr1 = next(c for c in got["no_stream"]["call"]
                if c[1].get("chrom") == chip_smoke.BAM_CHROMS[0])
    dense = chip_smoke.dense_batch()
    call = chip_smoke._edge_call(dense)
    calls = calling.call_reads_device(*call[0], clip=dense["clip"],
                                      device=dev)

    def call_set(batches, rows=calling.ROWS):
        return [ln for c in batches
                for ln in chip_smoke._call_launches(c, dev, rows or
                                                    c[0][5].shape[0])]

    def merge_set(batches):
        return [ln for m in batches if m[0].shape[0]
                for ln in chip_smoke._merge_launches(m, dev, calling.ROWS)]

    return {"call": {
        "the streamed PE run's launches": call_set(got["stream"]["call"]),
        "chr1's whole-file batch": call_set([chr1], None),
        "the dense batch": call_set([call])},
        "merge": {
        "the streamed PE run's launches": merge_set(got["stream"]["merge"]),
        "the whole-file run's launches": merge_set(
            got["no_stream"]["merge"]),
        "the dense batch's pairs": merge_set(
            [chip_smoke.dense_pairs(calls)])}}


def ab_calling(ctrees, inputs, picked, reps, rounds):
    """Both trees' call_reads and merge_pe on phase 11's launch sets, each
    set's launches one after another a turn, in turns; every output ==
    the twin's. Returns (runs, {kernel slab: {tree: median ms a set}})."""
    import torch

    from wgbs_tools_tpu_torch.ops import calling

    runs, summary = [], {}
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    for kernel in (CALL, MERGE):
        if kernel not in picked:
            continue
        plain = (calling.call_reads_plain if kernel == CALL
                 else calling.merge_pe_plain)
        for slab, launches in inputs["call" if kernel == CALL
                                     else "merge"].items():
            wants = [plain(*ln[0]) for ln in launches]
            calls = {}
            for tree, (lib, _, _) in ctrees.items():
                jobs = []
                for ln, want in zip(launches, wants):
                    args = ln[0]
                    outs = [torch.empty_like(w) for w in want]
                    if kernel == CALL:
                        seq, lens, pos1, bottom, loci, clip, KB = args
                        ptrs = [t.data_ptr() for t in (seq, lens, pos1,
                                                       bottom, loci, *outs)]
                        ints = [seq.shape[0], seq.shape[1], loci.shape[0],
                                KB, clip]
                    else:
                        s1, sp1, p1, s2, sp2, p2 = args
                        ptrs = [t.data_ptr() for t in (*args, *outs)]
                        ints = [s1.shape[0], p1.shape[1], p2.shape[1]]
                    jobs.append((getattr(lib, kernel), ptrs, ints, outs,
                                 want))

                def launch(jobs=jobs):
                    for fn, ptrs, ints, _, _ in jobs:
                        err = fn(*ptrs, *ints, stream())
                        if err:
                            raise RuntimeError(f"{kernel}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                for _, _, _, outs, want in jobs:
                    if not all(torch.equal(a, b) for a, b in zip(outs, want)):
                        raise RuntimeError(f"{tree} {kernel} on {slab}: "
                                           "kernel != twin")
                calls[tree] = launch
            rows = [ln[0][0].shape[0] for ln in launches]
            widths = sorted({(ln[0][0].shape[1], 0) if kernel == CALL else
                             (ln[0][2].shape[1], ln[0][5].shape[1])
                             for ln in launches})
            _ab_turns(kernel, slab, calls, reps, rounds, runs, summary,
                      f"{len(launches)} launches of {min(rows):,}-"
                      f"{max(rows):,} rows, {sum(rows):,} in all; "
                      + ("L" if kernel == CALL else "S1, S2") + " "
                      + ", ".join(str(w[0]) if kernel == CALL else str(w)
                                  for w in widths))
            del wants, calls
            torch.cuda.empty_cache()
    return runs, summary


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("other", help="the other tree (e.g. the parent commit)")
    p.add_argument("--frags", type=int, default=20_000_000)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--listed", default="",
                   help="CTAs per SM (comma-separated) at which to time this "
                        "tree's tiles_v1 also in its listed form")
    p.add_argument("--squarings", default="7",
                   help="maxplus_closure's squaring counts (comma-separated; "
                        "default 7, the DP's)")
    p.add_argument("--kernels",
                   default=",".join(list(KERNELS)
                                    + [MAXPLUS, SEGX, DPS, BLK, PAIRS,
                                       HOMOG, CALL, MERGE]),
                   help="the kernels to A/B (comma-separated; default all)")
    args = p.parse_args()
    listed = [int(b) for b in args.listed.split(",") if b]
    picked = args.kernels.split(",")
    unknown = set(picked) - set(KERNELS) - {MAXPLUS, SEGX, DPS, BLK, PAIRS,
                                            HOMOG, CALL, MERGE}
    if unknown:
        p.error(f"unknown kernels {sorted(unknown)}")
    pileups = [name for name in KERNELS if name in picked]

    smi = chip_smoke.phase_card()
    os.makedirs(op.join(REPO, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="kernel_ab_", dir=op.join(REPO, "build"))
    runs, summary, regs, inst = [], {}, {}, {}
    try:
        if pileups:
            trees = {"other": build(op.abspath(args.other),
                                    op.join(work, "o")),
                     "this": build(REPO, op.join(work, "t"))}
            probe = build(REPO, op.join(work, "p"), listed) if listed \
                else None
            runs += ab_pileups(trees, probe, listed, pileups, work, args,
                               summary)
            regs.update({t: tl[1] for t, tl in trees.items()})
            inst.update({t: tl[3] for t, tl in dict(
                trees, **({"probe": probe} if listed else {})).items()})
        if MAXPLUS in picked:
            mtrees = {"other": build_maxplus(op.abspath(args.other),
                                             op.join(work, "mo")),
                      "this": build_maxplus(REPO, op.join(work, "mt"))}
            squarings = [int(k) for k in args.squarings.split(",")]
            mruns, med = ab_maxplus(mtrees, args.reps, args.rounds,
                                    squarings)
            runs += mruns
            summary.update({f"{MAXPLUS} {k}": v for k, v in med.items()})
            for t, (_, _, r) in mtrees.items():
                regs.setdefault(t, {})[MAXPLUS] = r
        if SEGX in picked:
            strees = {"other": build_segx(op.abspath(args.other),
                                          op.join(work, "so")),
                      "this": build_segx(REPO, op.join(work, "st"))}
            sruns, med, occ = ab_segx(strees, args.reps, args.rounds)
            runs += sruns
            summary.update({f"{SEGX} {k}": v for k, v in med.items()})
            for t, (_, r, sp) in strees.items():
                regs.setdefault(t, {})[SEGX] = {"registers": r, "spills": sp,
                                                "occupancy": occ.get(t)}
                chip_smoke.log(f"segment_exact_dp {t}: ptxas registers {r}, "
                               f"spill bytes {sp}, launch by slab "
                               f"{occ.get(t)}")
        if DPS in picked:
            dtrees = {"other": build_dps(op.abspath(args.other),
                                         op.join(work, "do")),
                      "this": build_dps(REPO, op.join(work, "dt"))}
            druns, med, bodies = ab_dps(dtrees, args.reps, args.rounds)
            runs += druns
            summary.update({f"{DPS} {k}": v for k, v in med.items()})
            for t, (_, r, sp) in dtrees.items():
                regs.setdefault(t, {})[DPS] = {"registers": r, "spills": sp,
                                               "body": bodies.get(t)}
                chip_smoke.log(f"dp_scan {t}: ptxas registers {r}, spill "
                               f"bytes {sp}, body at W 64 {bodies.get(t)}")
        if BLK in picked or PAIRS in picked or HOMOG in picked:
            both = (("other", op.abspath(args.other)), ("this", REPO))
            btrees = {t: build_blk(tree, op.join(work, "b" + t[0]))
                      for t, tree in both} if BLK in picked else {}
            ptrees = {t: build_pairs(tree, op.join(work, "p" + t[0]))
                      for t, tree in both} if PAIRS in picked else {}
            htrees = {t: build_homog(tree, op.join(work, "h" + t[0]))
                      for t, tree in both} if HOMOG in picked else {}
            probe = build_homog(op.abspath(args.other),
                                op.join(work, "hp"), True) if htrees \
                else None
            if probe:
                htrees["probe"] = probe
            inputs = phase10_inputs(work, args.frags, picked)
            bruns, med = ab_blocks_pairs(btrees, ptrees, inputs, args.reps,
                                         args.rounds)
            runs += bruns
            summary.update(med)
            if htrees:
                hruns, med = ab_homog(htrees, inputs, args.reps, args.rounds)
                runs += hruns
                summary.update(med)
            for kernel, trees in ((BLK, btrees), (PAIRS, ptrees),
                                  (HOMOG, htrees)):
                for t, built in trees.items():
                    regs.setdefault(t, {})[kernel] = {
                        "registers": built[1], "spills": built[2]}
                    chip_smoke.log(f"{kernel} {t}: ptxas registers "
                                   f"{built[1]}, spill bytes {built[2]}")
        if CALL in picked or MERGE in picked:
            ctrees = {t: build_calling(tree, op.join(work, "c" + t[0]))
                      for t, tree in (("other", op.abspath(args.other)),
                                      ("this", REPO))}
            cruns, med = ab_calling(ctrees, calling_inputs(work), picked,
                                    args.reps, args.rounds)
            runs += cruns
            summary.update(med)
            for t, (_, r, sp) in ctrees.items():
                regs.setdefault(t, {})["calling"] = {"registers": r,
                                                     "spills": sp}
                chip_smoke.log(f"calling.cu {t}: ptxas registers {r}, spill "
                               f"bytes {sp}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"card": smi, "reps": args.reps, "median_ms": summary,
                      "registers": regs, "instances": inst, "runs": runs}),
          flush=True)
    return 0


def ab_pileups(trees, probe, listed, pileups, work, args, summary):
    """The pileup kernels `pileups` of both trees (and tiles_v1's listed
    forms from `probe`) on chip_smoke's slabs, in turns; fills `summary`
    with each kernel and slab's medians and returns the runs."""
    import torch

    from wgbs_tools_tpu_torch.ops import pileup_v1, pileup_v2, pileup_v3

    # the tiles_v1 variants beyond the two trees: (tree, C entry)
    forms = {f"listed b{b}": (probe, f"pileup_tiles_v1_listed_b{b}")
             for b in listed}
    big, deep = chip_smoke.phase_data(work, args.frags)
    slabs = {"big": chip_smoke._first_slab(big),
             "deep": chip_smoke._first_slab(deep)}
    slabs["long"] = chip_smoke.long_slab()
    dev = torch.device("cuda")
    runs = []
    for name in pileups:
        pats, path = KERNELS[name]
        module = {"tiles_v1": pileup_v1,
                  "tiles_v2": pileup_v2}.get(name, pileup_v3)
        plain = getattr(module, name + "_plain")
        for pat in pats:
            sel, lo, span = slabs[pat]
            sts = chip_smoke._stage(sel, lo, span, dev, path)
            want = sum(plain(st, span) for st in sts)
            variants = {tree: (tl, None) for tree, tl in trees.items()}
            if name == "tiles_v1":
                variants.update(forms)
            calls = {}
            for tree, (tl, entry) in variants.items():
                calls[tree] = [launcher(tl, name, st, span, entry)
                               for st in sts]
                for launch, _ in calls[tree]:
                    launch()
                torch.cuda.synchronize()
                got = sum(out for _, out in calls[tree])
                if not torch.equal(got, want):
                    raise RuntimeError(f"{tree} {name} on {pat}: kernel "
                                       "!= twin")
            order = (list(calls) + list(calls)[::-1]) * args.rounds
            for i, tree in enumerate(order):
                cl = calls[tree]
                ms = chip_smoke._device_ms(
                    lambda: [launch() for launch, _ in cl], args.reps)
                per_class = {
                    str(st.rc): chip_smoke._device_ms(launch, args.reps)
                    for st, (launch, _) in zip(sts, cl)
                    if hasattr(st, "rc")}
                runs.append({"kernel": name, "slab": pat, "tree": tree,
                             "turn": i, "ms": ms, "class_ms": per_class})
                chip_smoke.log(f"A/B {name} on {pat} turn {i} {tree}: "
                               f"{ms:.4f} ms per slab (" + ", ".join(
                                   f"rc {rc} {v:.4f}" for rc, v in
                                   per_class.items()) + ") == twin")
    for name in pileups:
        for pat in KERNELS[name][0]:
            med = {tree: statistics.median(
                r["ms"] for r in runs if r["kernel"] == name
                and r["slab"] == pat and r["tree"] == tree)
                for tree in dict.fromkeys(
                    r["tree"] for r in runs if r["kernel"] == name)}
            summary[f"{name} {pat}"] = med
            chip_smoke.log(f"A/B {name} on {pat}: median " + ", ".join(
                f"{tree} {v:.4f} ms ({med['other'] / v:.2f}x)"
                for tree, v in med.items()))
    return runs


if __name__ == "__main__":
    sys.exit(main())
