"""Multi-process pat2beta, segment and bam2pat: N worker processes on one
machine.

Port of wgbs_tools_tpu/parallel/multihost.py's three jobs
(pat2beta_worker :67-157, segment_worker :160-214,
run_segment_multiprocess :217-264, _bam_ref_names :267,
_bam_chrom_weights :287, _bai_ref_begs :342, _partition_contiguous :383,
bam2pat_part_worker :402, run_bam2pat_multiprocess :424-521,
_worker_main :524-572, free_port :575, run_pat2beta_multiprocess
:583-624). The pat2beta and segment workers join one torch.distributed
job on the gloo backend; the bam2pat workers are independent processes.
Rank r runs on one device, cuda:{r % device_count} (or the CPU).

- pat2beta: rank r owns the sites [r*S + 1, (r+1)*S + 1) with S =
  ceil(nr_sites / world). It streams the pat rows overlapping its range
  (formats/pat.py::iter_pat_region), piles them up in a one-shard
  ShardedPileupV3 (which clips fragments at the range's edges), saturates
  on its device and writes its own byte range of the beta. The only
  collectives are one int64 coverage allgather and two write barriers.
- segment: the 60,000-site chunk axis is round-robined over the ranks
  (the distributed form of the reference's chunk Pool, ref:
  src/python/segment.py:137-155). Each rank segments its chunks on its
  device (models/segment.py::segment_chunks: exact mode through the device
  route on cuda and the host DP on cpu, fast mode through
  segment_windows_fast) and writes a part file; after one barrier rank 0
  stitches (finalize_segmentation).
- bam2pat: contiguous blocks of chromosomes (weighted by the .bai's
  compressed spans, else by CpG counts), one a worker; with a .bai each
  worker decodes only its block's byte range. A worker calls reads and
  merges mates on its device (call_reads, merge_pe) and writes its part
  pat; the parts join by BGZF byte append in chromosome order, and the
  .cdx / .csi are rebuilt over the joined file. The parts depend on
  nothing of each other, so these workers hold no process group.

The collectives are host scalars and barriers, which is why gloo and not
NCCL carries them (two ranks on one card cannot use NCCL).

    python -m wgbs_tools_tpu_torch.parallel.multihost --coordinator HOST:PORT \\
        --num_processes N --process_id R [--device cuda|cpu] \\
        (--pat x.pat.gz --out x.beta --nr_sites S [--lbeta]
         | --job segment --params job.json
         | --job bam2pat --params parts.json)

is one worker; run_pat2beta_multiprocess, run_segment_multiprocess and
run_bam2pat_multiprocess start N of them on this machine.
"""

import argparse
import datetime
import importlib
import json
import os
import os.path as op
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ..device import resolve_device
from ..formats.pat import iter_pat_region
from ..utils import logger

# the longest a worker waits for the others at init or at a barrier
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def distributed_init(coordinator, num_processes, process_id):
    """Join (or create, for process 0) the gloo process group at
    `coordinator` (host:port)."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id,
                            timeout=COLLECTIVE_TIMEOUT)


def worker_device(device, rank):
    """The device rank `rank` runs on: cuda:{rank % device_count} for
    "cuda" (raises when CUDA is absent: a worker never moves to the host
    on its own), the CPU for "cpu"."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def pat2beta_worker(pat_path, out_path, nr_sites, lbeta=False,
                    device="cuda"):
    """Per-process body of the multi-process pat2beta; every process of
    the group calls it with the same arguments. Process 0 creates the
    output file, every process writes its own byte range, and process 0
    returns the path (the others None)."""
    import torch.distributed as dist

    from ..pipeline.pat2beta import stream_into
    from .sharded import ShardedPileupV3

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = worker_device(device, rank)
    S = -(-nr_sites // world)
    lo = min(rank * S + 1, nr_sites + 1)  # 1-based, inclusive
    hi = min((rank + 1) * S + 1, nr_sites + 1)
    logger.info("multihost pat2beta: p%d streams sites [%d, %d) on %s", rank,
                lo, hi, dev)
    n_seen, cov, beta = 0, 0, None
    t0 = t1 = time.perf_counter()
    if hi > lo:
        acc = ShardedPileupV3([dev], (lo, hi))
        n_seen = stream_into(acc, iter_pat_region(pat_path, (lo, hi)))
        t1 = time.perf_counter()
        beta = acc.finalize(lbeta)
        cov = acc.coverage()
    t2 = time.perf_counter()
    logger.info("multihost pat2beta: p%d streamed %d frags in %.3f s, "
                "saturated and fetched in %.3f s", rank, n_seen, t1 - t0,
                t2 - t1)

    covs = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(covs, torch.tensor([cov], dtype=torch.int64))
    itemsize = 2 if lbeta else 1
    if rank == 0:
        with open(out_path, "wb") as f:
            f.truncate(nr_sites * 2 * itemsize)
    dist.barrier()
    if beta is not None:
        with open(out_path, "r+b") as f:
            f.seek((lo - 1) * 2 * itemsize)
            f.write(np.ascontiguousarray(beta).tobytes())
    dist.barrier()
    logger.info("multihost pat2beta: p%d total coverage %d; %.3f s from "
                "streaming to the written beta", rank,
                int(sum(int(c) for c in covs)), time.perf_counter() - t0)
    return out_path if rank == 0 else None


def segment_worker(beta_paths, ranges, out_prefix, max_cpg=1000,
                   max_bp=2000, pseudo_count=15.0, chunk_size=None,
                   min_cpg=1, mode="exact", genome=None, threads=None,
                   device="cuda"):
    """Per-process body of the multi-process segmentation; every process of
    the group calls it with the same arguments. Rank r segments the chunks
    r, r + world, ... on worker_device(device, r) and writes
    {out_prefix}.part{r}.npz; after the barrier rank 0 stitches every part
    and writes {out_prefix}.blocks.npz (starts, ends), whose path it returns
    (the others None). Rank 0 stitches as segment_ranges does (in fast mode
    the patches batched, models/segment.py::_batch_seg_fast, where JAX's
    worker segments them one at a time), so the blocks equal one process's
    segment_ranges on the same device."""
    import torch.distributed as dist

    from ..genome.refdir import Genome
    from ..models.segment import (DEF_CHUNK, SegmentConfig, _batch_seg_fast,
                                  _seg_fn, break_to_chunks,
                                  finalize_segmentation, segment_chunks)

    rank, world = dist.get_rank(), dist.get_world_size()
    dev = worker_device(device, rank)
    idx = Genome(genome).index
    cfg = SegmentConfig(max_cpg=max_cpg, max_bp=max_bp,
                        pseudo_count=pseudo_count,
                        chunk_size=chunk_size or DEF_CHUNK, min_cpg=min_cpg,
                        mode=mode, threads=threads, device=dev)
    ranges = [(int(s), int(e)) for s, e in ranges]
    tags, chunks = break_to_chunks(ranges, cfg.chunk_size)
    own = list(range(rank, len(chunks), world))
    t0 = time.perf_counter()
    results = segment_chunks(beta_paths, chunks, idx, cfg, subset=own)
    np.savez(f"{out_prefix}.part{rank}.npz",
             idx=np.asarray(own, dtype=np.int64),
             **{f"r{i}": np.asarray(results[i], dtype=np.int64)
                for i in own})
    logger.info("multihost segment: p%d segmented %d/%d chunks on %s in "
                "%.3f s", rank, len(own), len(chunks), dev,
                time.perf_counter() - t0)
    dist.barrier()
    if rank != 0:
        return None
    results_all = [None] * len(chunks)
    for q in range(world):
        part = f"{out_prefix}.part{q}.npz"
        with np.load(part) as z:
            for i in z["idx"]:
                results_all[int(i)] = z[f"r{int(i)}"]
        os.unlink(part)
    t1 = time.perf_counter()
    seg = _seg_fn(beta_paths, idx, cfg)
    batch_seg = (_batch_seg_fast(beta_paths, idx, cfg)
                 if cfg.mode == "fast" else None)
    starts, ends = finalize_segmentation(tags, chunks, results_all, seg, cfg,
                                         batch_seg=batch_seg)
    out = out_prefix + ".blocks.npz"
    np.savez(out, starts=starts, ends=ends)
    logger.info("multihost segment: p0 stitched %d blocks in %.3f s",
                len(starts), time.perf_counter() - t1)
    return out


def _bam_ref_names(bam_path):
    """Reference names from a BAM header (lazy gzip read — only the header
    blocks are ever decompressed)."""
    import gzip
    import struct

    with gzip.open(bam_path, "rb") as f:
        if f.read(4) != b"BAM\x01":
            raise IOError(f"{bam_path}: not a BAM file")
        (l_text,) = struct.unpack("<i", f.read(4))
        f.read(l_text)
        (n_ref,) = struct.unpack("<i", f.read(4))
        names = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", f.read(4))
            names.append(f.read(l_name)[:-1].decode())
            f.read(4)  # l_ref
        return names


def _bam_chrom_weights(bam_path, chrom_names, idx):
    """Per-chromosome work estimate for partitioning bam2pat workers.

    With a .bai sidecar: compressed byte span of each reference's records
    (linear-index min .. chunk-end max — the same information `samtools
    view <chrom>` seeks by). Without one: the genome's per-chromosome CpG
    counts as a proxy.
    """
    import struct

    bai = bam_path + ".bai"
    if not op.isfile(bai):
        return {c: float(max(idx.chrom_nr_sites(c), 1))
                for c in chrom_names}
    try:
        with open(bai, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("bad magic")
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        spans = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            beg, end = None, 0
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                for _ in range(n_chunk):
                    cbeg, cend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    if bin_id == 37450:  # pseudo-bin: meta counts, not coords
                        continue
                    c0, c1 = cbeg >> 16, cend >> 16
                    beg = c0 if beg is None else min(beg, c0)
                    end = max(end, c1)
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4 + 8 * n_intv
            spans.append(0.0 if beg is None else float(end - beg + 1))
        # map BAM ref order -> requested chromosome names via the header
        ref_names = _bam_ref_names(bam_path)
        w = {c: 1.0 for c in chrom_names}
        for name, sp in zip(ref_names, spans):
            if name in w:
                w[name] = max(sp, 1.0)
        return w
    except Exception as e:
        logger.info("bam2pat --procs: .bai parse failed (%s); using CpG "
                    "counts for balance", e)
        return {c: float(max(idx.chrom_nr_sites(c), 1))
                for c in chrom_names}


def _bai_ref_begs(bam_path):
    """Per-reference smallest chunk-begin VIRTUAL offset from the .bai
    (None for refs without alignments), in BAM header ref order — the
    seek targets for per-worker ranged decode. Returns None when no
    usable .bai exists."""
    import struct

    bai = bam_path + ".bai"
    if not op.isfile(bai):
        return None
    try:
        with open(bai, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            return None
        off = 4
        (n_ref,) = struct.unpack_from("<i", data, off)
        off += 4
        begs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, off)
            off += 4
            beg = None
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, off)
                off += 8
                for _ in range(n_chunk):
                    cbeg, _cend = struct.unpack_from("<QQ", data, off)
                    off += 16
                    if bin_id == 37450:  # pseudo-bin
                        continue
                    beg = cbeg if beg is None else min(beg, cbeg)
            (n_intv,) = struct.unpack_from("<i", data, off)
            off += 4 + 8 * n_intv
            begs.append(beg)
        return begs
    except Exception as e:
        logger.info("bam2pat --procs: .bai voffset parse failed (%s)", e)
        return None


def _partition_contiguous(names, weights, n_parts):
    """Split `names` (order preserved) into <= n_parts CONTIGUOUS groups
    with roughly equal total weight. Contiguity matters: per-part pat
    files concatenate in chromosome order, which IS global startCpG order
    (chromosome site ranges are disjoint and increasing)."""
    total = sum(weights[c] for c in names)
    parts, cur, acc = [], [], 0.0
    target = total / max(n_parts, 1)
    for c in names:
        cur.append(c)
        acc += weights[c]
        if acc >= target and len(parts) < n_parts - 1:
            parts.append(cur)
            cur, acc = [], 0.0
    if cur:
        parts.append(cur)
    return parts


def bam2pat_part_worker(bam, out_dir, chroms, genome=None, byte_range=None,
                        device="cuda", **kw):
    """Standalone worker: run bam2pat restricted to a CONTIGUOUS block of
    chromosomes on `device` (reads call and mates merge there); the part
    pat lands in out_dir. No process group: the parts have no cross-part
    dependencies (mates pair within a chromosome, exactly as in the
    single-process pipeline and the reference's per-chromosome Pool,
    ref: src/python/bam2pat.py:303-356). byte_range: optional BAI
    virtual-offset pair — only that slice of the BAM is decompressed."""
    from ..genome.refdir import Genome
    from ..pipeline.bam2pat_run import bam2pat

    g = Genome(genome)
    if byte_range is not None:
        byte_range = (int(byte_range[0]),
                      None if byte_range[1] is None else int(byte_range[1]))
    logger.info("bam2pat --procs: part %s decodes BAM virtual offsets %s",
                list(chroms), "none" if byte_range is None
                else "%d-%s" % byte_range)
    _, pat_path, _ = bam2pat(bam, genome=g, out_dir=out_dir,
                             include_chroms=list(chroms),
                             byte_range=byte_range, device=device, **kw)
    return pat_path


def run_bam2pat_multiprocess(bam, out_dir=".", num_processes=2,
                             genome=None, device="cuda", timeout=1800,
                             **kw):
    """Multi-process bam2pat: contiguous chromosome blocks (.bai-weighted
    when a BAI exists) across worker processes (_run_workers; worker w on
    worker_device(device, w)); parts concatenate by raw BGZF byte append
    (readers skip the embedded empty EOF blocks), then the .cdx/.csi index
    is rebuilt over the final file. The decompressed pat is byte-identical
    to the single-process output. `kw` are bam2pat's keyword arguments.
    Returns the pat path."""
    import shutil

    from ..formats.pat import index_pat
    from ..genome.refdir import Genome
    from ..utils import pretty_name

    g = Genome(genome)
    idx = g.index
    ref_names = _bam_ref_names(bam)
    present = [c for c in idx.chrom_names if c in set(ref_names)]
    weights = _bam_chrom_weights(bam, present, idx)
    parts = _partition_contiguous(present, weights, num_processes)
    out_path = op.join(out_dir, pretty_name(bam) + ".pat.gz")

    # per-worker BYTE ranges from the .bai: each worker decompresses only
    # its chromosome block's records (plus the header) instead of the
    # whole BAM — decode then scales 1/N. Requires the BAM's on-disk ref
    # order (restricted to present chroms) to match genome order, which a
    # coordinate-sorted BAM against the same reference always satisfies;
    # otherwise workers fall back to whole-file decode + chrom filter
    # (identical output either way — the range is a pure IO optimization).
    begs = _bai_ref_begs(bam)
    ranges = [None] * len(parts)
    if begs is not None:
        beg_of = {n: begs[i] for i, n in enumerate(ref_names)
                  if i < len(begs)}
        order_ok = ([c for c in ref_names if c in set(present)] == present)
        if order_ok:
            starts = []
            for chroms in parts:
                vs = [beg_of.get(c) for c in chroms
                      if beg_of.get(c) is not None]
                starts.append(min(vs) if vs else None)
            for w in range(len(parts)):
                v0 = starts[w]
                if v0 is None:
                    continue
                v1 = None
                for w2 in range(w + 1, len(parts)):
                    if starts[w2] is not None:
                        v1 = starts[w2]
                        break
                ranges[w] = [int(v0), None if v1 is None else int(v1)]
        else:
            logger.info("bam2pat --procs: BAM ref order differs from the "
                        "genome's; using whole-file decode per worker")

    with tempfile.TemporaryDirectory() as td:
        part_params, part_paths = [], []
        for w, chroms in enumerate(parts):
            wdir = op.join(td, f"w{w}")
            os.makedirs(wdir)
            part_params.append(dict(bam=bam, out_dir=wdir, chroms=chroms,
                                    genome=genome, byte_range=ranges[w],
                                    **kw))
            part_paths.append(op.join(wdir, pretty_name(bam) + ".pat.gz"))
        pfile = op.join(td, "parts.json")
        with open(pfile, "w") as f:
            json.dump({"parts": part_params}, f)
        _run_workers("bam2pat", ["--params", pfile], len(parts), device,
                     timeout)
        with open(out_path, "wb") as dst:
            for pp in part_paths:
                if op.isfile(pp):
                    with open(pp, "rb") as src:
                        shutil.copyfileobj(src, dst)
    index_pat(out_path)
    return out_path


# the kernels each job's worker reports on its launch line -> their module
# in wgbs_tools_tpu_torch.ops
JOB_KERNELS = {
    "pat2beta": {name: "pileup_v3" for name in (
        "flat_vals_fused", "flat_vals", "flat_vals_add", "flat_classic")},
    "segment": {"maxplus_closure": "maxplus",
                "segment_exact_dp": "segment_exact"},
    "bam2pat": {"call_reads": "calling", "merge_pe": "calling"}}


def _launches(job):
    """{kernel: launches} of this process, for the job's kernels."""
    return {name: getattr(importlib.import_module(
        "wgbs_tools_tpu_torch.ops." + module), name).launches
        for name, module in JOB_KERNELS[job].items()}


def _worker_main(argv=None):
    p = argparse.ArgumentParser(prog="wgbs-torch-multihost-worker")
    p.add_argument("--coordinator", help="host:port of process 0")
    p.add_argument("--num_processes", type=int)
    p.add_argument("--process_id", type=int)
    p.add_argument("--job", default="pat2beta", choices=sorted(JOB_KERNELS))
    p.add_argument("--params", help="JSON file of the segment job's keyword "
                                    "arguments, or of the bam2pat job's "
                                    "parts ({'parts': [kwargs, ...]}, "
                                    "worker r takes part r)")
    p.add_argument("--pat")
    p.add_argument("--out")
    p.add_argument("--nr_sites", type=int)
    p.add_argument("--lbeta", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    # validate before any init, so usage errors exit with argparse's 2
    if not (args.coordinator and args.num_processes
            and args.process_id is not None):
        p.error("--coordinator/--num_processes/--process_id are required")
    if args.job in ("segment", "bam2pat") and not args.params:
        p.error(f"--params is required for the {args.job} job")
    if args.job == "pat2beta" and not (args.pat and args.out
                                       and args.nr_sites):
        p.error("--pat/--out/--nr_sites are required")
    if not 0 <= args.process_id < args.num_processes:
        p.error(f"--process_id {args.process_id} outside [0, "
                f"{args.num_processes})")
    if args.job == "bam2pat":
        # independent parts: no process group to hold
        with open(args.params) as f:
            part = json.load(f)["parts"][args.process_id]
        bam2pat_part_worker(**part, device=worker_device(args.device,
                                                         args.process_id))
    else:
        import torch.distributed as dist

        distributed_init(args.coordinator, args.num_processes,
                         args.process_id)
        try:
            if args.job == "segment":
                with open(args.params) as f:
                    segment_worker(**json.load(f), device=args.device)
            else:
                pat2beta_worker(args.pat, args.out, args.nr_sites,
                                lbeta=args.lbeta, device=args.device)
        finally:
            dist.destroy_process_group()
    # one line a caller can parse: this worker's kernel launches
    print(f"[wgbs-torch worker {args.process_id}] launches "
          f"{json.dumps(_launches(args.job))}", flush=True)
    return 0


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(job, args, num_processes, device, timeout):
    """Start num_processes workers of `job` (their shared arguments `args`)
    on this machine and block until all exit. Each worker's output (its log
    and its launch-count line) is copied to this process's stderr. When a
    worker exits nonzero or `timeout` seconds pass, the others are killed
    and a RuntimeError carries the failing worker's output."""
    resolve_device(device)  # no CUDA: raise here, before any worker starts
    cmd_base = [
        sys.executable, "-m", "wgbs_tools_tpu_torch.parallel.multihost",
        "--job", job, "--coordinator", f"127.0.0.1:{free_port()}",
        "--num_processes", str(num_processes), "--device", str(device),
    ] + args
    env = dict(os.environ)
    env["PYTHONPATH"] = op.dirname(op.dirname(op.dirname(
        op.abspath(__file__)))) + os.pathsep + env.get("PYTHONPATH", "")
    with tempfile.TemporaryDirectory() as td:
        logs = [open(op.join(td, f"w{i}.log"), "w+")
                for i in range(num_processes)]
        procs = [subprocess.Popen(cmd_base + ["--process_id", str(i)],
                                  env=env, stdout=log,
                                  stderr=subprocess.STDOUT)
                 for i, log in enumerate(logs)]
        fail = _wait_all(procs, timeout)
        outs = []
        for log in logs:
            log.seek(0)
            outs.append(log.read())
            log.close()
    for i, out in enumerate(outs):
        sys.stderr.write(f"--- worker {i} ---\n{out}")
    sys.stderr.flush()
    if fail is not None:
        i, why = fail
        raise RuntimeError(f"multi-process {job} failed: worker {i} "
                           f"{why}:\n{outs[i][-2000:]}")


def run_pat2beta_multiprocess(pat_path, out_path, nr_sites, num_processes=2,
                              lbeta=False, device="cuda", timeout=600):
    """Launcher: run num_processes pat2beta workers on this machine
    (_run_workers) and return out_path."""
    _run_workers("pat2beta", ["--pat", pat_path, "--out", out_path,
                              "--nr_sites", str(nr_sites)]
                 + (["--lbeta"] if lbeta else []), num_processes, device,
                 timeout)
    return out_path


def run_segment_multiprocess(beta_paths, ranges, out_prefix, num_processes=2,
                             device="cuda", timeout=600, **cfg_kwargs):
    """Launcher: multi-process segmentation on this machine (_run_workers;
    `cfg_kwargs` are segment_worker's: max_cpg, max_bp, pseudo_count,
    chunk_size, min_cpg, mode, genome, threads). Returns (starts, ends)
    from rank 0's {out_prefix}.blocks.npz. JAX's platform= and
    local_devices= become device=."""
    params = dict(beta_paths=list(beta_paths),
                  ranges=[[int(s), int(e)] for s, e in ranges],
                  out_prefix=out_prefix, **cfg_kwargs)
    fd, pfile = tempfile.mkstemp(suffix=".json")
    with os.fdopen(fd, "w") as f:
        json.dump(params, f)
    try:
        _run_workers("segment", ["--params", pfile], num_processes, device,
                     timeout)
    finally:
        os.unlink(pfile)
    with np.load(out_prefix + ".blocks.npz") as z:
        return z["starts"].copy(), z["ends"].copy()


def _wait_all(procs, timeout):
    """Wait for every process; on the first nonzero exit or at the
    deadline kill the rest. Returns None, or (worker index, reason)."""
    deadline = time.monotonic() + timeout
    fail = None
    while fail is None:
        rcs = [pr.poll() for pr in procs]
        bad = next((i for i, rc in enumerate(rcs) if rc not in (None, 0)),
                   None)
        if bad is not None:
            fail = (bad, f"exited with rc={rcs[bad]}")
        elif None not in rcs:
            break
        elif time.monotonic() > deadline:
            fail = (rcs.index(None), f"timed out after {timeout} s")
        else:
            time.sleep(0.05)
    for pr in procs:
        if pr.poll() is None:
            pr.kill()
        pr.wait()
    return fail


if __name__ == "__main__":
    sys.exit(_worker_main())
