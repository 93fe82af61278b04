"""segment command of the port (ref: src/python/segment.py).

    python -m wgbs_tools_tpu_torch segment --betas a.beta b.beta -o blocks.bed
        [--mode exact|fast] [--device cuda|cpu] [--procs N]
        [-r REGION | -s SITES | -L BED]

Flags match wgbs_tools_tpu's segment (cli/cmd_segment.py::main), plus
--device, less --array_id: the JAX CLI accepts it and segments the whole
genome; here it is refused with a usage error. Both modes run on
--device, cuda by default, which raises when CUDA is absent. Exact mode
(the default) writes the JAX CLI's bytes: on cuda its DP runs in the
kernel csrc/segment_exact.cu, on cpu in the host DP on a thread pool.
Fast mode on cpu runs the plain PyTorch path, with the max-plus kernel's
twin. --procs N above 1 segments the chunks over N worker processes
(parallel/multihost.py::run_segment_multiprocess: gloo, rank r on
cuda:{r % device_count} or the CPU), with the bytes of one process.
"""

import argparse
import os.path as op
import sys
import tempfile

import numpy as np

from ..formats.beta import beta_sanity_check
from ..formats.blocks import index_bed, load_blocks, sites_blocks
from ..genome.refdir import Genome
from ..genome.region import GenomicRegion
from ..models.segment import DEF_CHUNK, SegmentConfig, segment_ranges
from ..parallel.multihost import run_segment_multiprocess
from ..trace import count, on, span
from ..utils import IllegalArgumentError, eprint, validate_file_list, \
    validate_single_file
from .main import add_gr_args


def main(argv, timings=None):
    """Run the command on argv. `timings`, a dict, collects the stage
    seconds of the segmentation (SegmentConfig.timings). While a torch
    profiler runs, the command is the span segment.run, and the counter
    segment.bed_rows counts the blocks it writes (see trace.py)."""
    with span("segment.run"):
        with span("segment.setup"):
            args, betas, idx, ranges, cfg = _setup(argv, timings)
        if args.procs and args.procs > 1:
            with tempfile.TemporaryDirectory() as td:
                starts, ends = run_segment_multiprocess(
                    betas, ranges, op.join(td, "seg"),
                    num_processes=args.procs, device=args.device,
                    max_cpg=cfg.max_cpg, max_bp=cfg.max_bp,
                    pseudo_count=cfg.pseudo_count, chunk_size=cfg.chunk_size,
                    min_cpg=cfg.min_cpg, mode=cfg.mode, genome=args.genome,
                    threads=args.threads)
        else:
            starts, ends = segment_ranges(betas, ranges, idx, cfg)
        eprint(f"[wt segment] found {len(starts):,} blocks")

        with span("segment.bed_loci"):
            blocks = sites_blocks(idx, np.stack([starts, ends], axis=1))
        with span("segment.bed_write"):
            _write_bed(args.out_path, blocks, len(starts))
        if on():
            count("segment.bed_rows", len(starts))
    return 0


def _setup(argv, timings):
    """The parsed arguments, the betas, the genome's CpG index, the site
    ranges to segment and the SegmentConfig of argv."""
    p = argparse.ArgumentParser(
        prog="segment",
        description="Segment the genome into homogeneously methylated blocks")
    add_gr_args(p, bed_file=True)
    g1 = p.add_mutually_exclusive_group(required=True)
    g1.add_argument("--betas", nargs="+")
    g1.add_argument("--beta_file", "-F")
    p.add_argument("-c", "--chunk_size", type=int, default=DEF_CHUNK)
    p.add_argument("-p", "--pcount", type=float, default=15)
    p.add_argument("--min_cpg", type=int, default=1)
    p.add_argument("--max_cpg", type=int, default=1000)
    p.add_argument("--max_bp", type=int, default=2000)
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="exact mode with --device cpu: chunks run on this "
                        "many host threads (default: all cores); on cuda, "
                        "and in fast mode, chunks are batched on the device "
                        "instead")
    p.add_argument("--mode", choices=["exact", "fast"], default="exact",
                   help="'exact' matches the reference segmentor bit-for-bit "
                        "(a float64 DP kernel on cuda, the native C++ DP "
                        "threaded over chunks on cpu); "
                        "'fast' runs the whole DP on --device in float32, "
                        "but some borders may differ at numerical ties")
    p.add_argument("-o", "--out_path", default=None)
    p.add_argument("--procs", type=int, default=None,
                   help="segment the chunks over N worker processes on this "
                        "machine (torch.distributed, gloo; rank r on "
                        "cuda:{r %% device_count}, or the CPU with --device "
                        "cpu); the same blocks as one process")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; an error without "
                        "CUDA) or cpu (exact mode: the host DP; fast mode: "
                        "the plain PyTorch path)")
    args = p.parse_args(argv)
    if args.array_id:
        p.error("--array_id is not supported by segment: it names one site")

    if args.betas:
        betas = args.betas
    else:
        validate_single_file(args.beta_file)
        with open(args.beta_file) as f:
            betas = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    validate_file_list(betas)

    g = Genome(args.genome)
    idx = g.index
    for b in betas:
        if not beta_sanity_check(b, idx.nr_sites):
            raise IllegalArgumentError(
                f"genome reference does not match beta file {b}")

    # ranges to segment (ref: segment.py:84-135)
    if args.bed_file:
        blocks = load_blocks(args.bed_file)
        keep = blocks["startCpG"] >= 0
        ranges = list(zip(blocks["startCpG"][keep].tolist(),
                          blocks["endCpG"][keep].tolist()))
    else:
        gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
        if gr.is_whole():
            ranges = [idx.chrom_site_bounds(c) for c in idx.chrom_names
                      if idx.chrom_nr_sites(c) > 0]
        else:
            ranges = [gr.sites]

    cfg = SegmentConfig(
        max_cpg=args.max_cpg,
        max_bp=args.max_bp,
        pseudo_count=args.pcount,
        chunk_size=args.chunk_size,
        min_cpg=args.min_cpg,
        mode=args.mode,
        threads=args.threads,
        device=args.device,
        timings=timings,
    )
    return args, betas, idx, ranges, cfg


def _write_bed(out_path, blocks, n):
    """The n blocks' bed lines to out_path (stdout where it is None); a
    path ending in .gz is bgzipped and indexed after."""
    gz = bool(out_path) and out_path.endswith(".gz")
    txt_path = out_path[:-3] if gz else out_path
    out = open(txt_path, "w") if out_path else sys.stdout
    for i in range(n):
        out.write(
            f"{blocks['chr'][i]}\t{blocks['start'][i]}\t{blocks['end'][i]}"
            f"\t{blocks['startCpG'][i]}\t{blocks['endCpG'][i]}\n"
        )
    if out_path:
        out.close()
        if gz:
            # bgzip + .tbi like the reference's Indxer on block outputs
            # (ref: src/python/index.py:96-139)
            index_bed(txt_path)
