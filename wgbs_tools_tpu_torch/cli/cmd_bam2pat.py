"""bam2pat and the BAM-splitting commands (ref: src/python/bam2pat.py,
add_cpg_counts.py, split_by_meth.py, split_by_allele.py): the port's copy
of wgbs_tools_tpu/cli/cmd_bam2pat.py (`main`, `main_add_cpg_counts`,
`main_split_by_allele`, `main_split_by_meth`).

bam2pat and split_by_allele take --device: reads call and mates merge
there (call_reads, merge_pe), and the beta piles up there. bam2pat
--procs N runs N worker processes, one contiguous block of chromosomes
each (parallel/multihost.py::run_bam2pat_multiprocess), each on
cuda:{rank % cards}. --mbias writes the JAX command's m-bias tables
(<name>.mbias.OT.txt and .OB.txt) and draws their plot as JAX does
(cli/cmd_misc.py::plot_mbias, matplotlib; a plot that fails is logged and
the run goes on). bam2pat refuses --array_id (JAX accepts and ignores
it). add_cpg_counts and split_by_meth are host code
(pipeline/bam_split.py) and take no --device.
"""

import argparse
import os
import os.path as op

from ..device import resolve_device, timed
from ..genome.refdir import Genome
from ..pipeline.bam import EXCLUDE_FLAGS, MIN_MAPQ
from ..pipeline.bam2pat_run import bam2pat
from ..pipeline.pat2beta import pat2beta
from ..utils import IllegalArgumentError, delete_or_skip, eprint, \
    pretty_name, validate_single_file
from .main import add_gr_args


def main(argv, timings=None):
    p = argparse.ArgumentParser(
        prog="bam2pat",
        description="Convert aligned BAM to pat + beta (PyTorch/CUDA): "
                    "reads call and mates merge on --device, and the beta "
                    "piles up there")
    p.add_argument("bam", nargs="+")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-F", "--exclude_flags", type=int, default=None,
                   help=f"samtools-style exclusion flags [{EXCLUDE_FLAGS}]")
    p.add_argument("--include_flags", type=int, default=None,
                   help="required FLAG bits (samtools view -f). "
                        "Default: 3 for paired-end, none for single-end")
    p.add_argument("-q", "--mapq", type=int, default=MIN_MAPQ)
    strands = p.add_mutually_exclusive_group()
    strands.add_argument("--top_strand", action="store_true",
                         help="only use reads from the top (OT) strand")
    strands.add_argument("--bottom_strand", action="store_true",
                         help="only use reads from the bottom (OB) strand")
    p.add_argument("-rg", "--read_group", default=None,
                   help="only use reads with this RG:Z read-group tag")
    p.add_argument("-T", "--temp_dir", default=None,
                   help="(compat; unused — sorting is in-memory, not unix "
                        "sort)")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int,
                   default=os.cpu_count() or 1,
                   help="worker threads (one per chromosome) of the "
                        "whole-file path")
    p.add_argument("--clip", type=int, default=0,
                   help="clip first/last bases of each read")
    p.add_argument("--min_cpg", type=int, default=1)
    p.add_argument("--mbias", "-mb", action="store_true",
                   help="dump m-bias tables and their plot alongside the "
                        "pat (calling then runs on the host)")
    p.add_argument("--no_beta", action="store_true")
    p.add_argument("--no_pat", action="store_true")
    p.add_argument("-l", "--lbeta", action="store_true")
    p.add_argument("--long", dest="long_reads", action="store_true",
                   help="keep read names as an extra pat column")
    p.add_argument("--nanopore", "-np", action="store_true",
                   default=None)
    p.add_argument("--np_thresh", type=float, default=0.667)
    p.add_argument("--cpc_call", choices=["C", "H", "."], default="C")
    p.add_argument("--combine_mods", action="store_true")
    p.add_argument("--blueprint", "-bp", action="store_true",
                   help="drop reads with <90%% non-CpG cytosine conversion")
    p.add_argument("-L", "--whitelist", nargs="?", const=True, default=None,
                   help="keep only reads overlapping this bed "
                        "(genome default when no path given)")
    p.add_argument("--blacklist", nargs="?", const=True, default=None,
                   help="drop reads overlapping this bed "
                        "(genome default when no path given)")
    stream_g = p.add_mutually_exclusive_group()
    stream_g.add_argument("--stream", action="store_true", default=None,
                          help="bounded-memory slab streaming (automatic "
                               "for BAMs of 256 MB or more)")
    stream_g.add_argument("--no_stream", dest="stream", action="store_false",
                          help="force the whole-file in-memory path")
    p.add_argument("--procs", type=int, default=None,
                   help="convert contiguous chromosome blocks in N worker "
                        "processes (.bai-weighted partition; parts "
                        "concatenate in chromosome order; worker r on "
                        "cuda:{r %% cards})")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; an error without "
                        "CUDA) or cpu (calling and merging with numpy on "
                        "the host, the pileup's plain PyTorch twins)")
    add_gr_args(p)
    args = p.parse_args(argv)
    if args.array_id:
        p.error("--array_id is not supported by bam2pat")
    device = resolve_device(args.device)
    if args.verbose or args.debug:
        from ..utils import set_verbose

        set_verbose()
    if not op.isdir(args.out_dir):
        # ref: src/python/bam2pat.py:509-510
        raise IllegalArgumentError(f"Invalid output dir: {args.out_dir}")
    g = Genome(args.genome)
    include = None
    if args.region:
        from ..genome.region import GenomicRegion

        gr = GenomicRegion(region=args.region, genome=g)
        include = [gr.chrom]
    for bam in args.bam:
        try:
            validate_single_file(bam)
            suff = f".{args.read_group}" if args.read_group else ""
            out_pat = op.join(args.out_dir,
                              pretty_name(bam) + suff + ".pat.gz")
            if not delete_or_skip(out_pat, args.force):
                continue
            mb = (op.join(args.out_dir, pretty_name(bam) + ".mbias")
                  if args.mbias else None)
            if args.procs and args.procs > 1:
                if args.mbias or args.long_reads or args.no_pat:
                    raise IllegalArgumentError(
                        "--procs does not combine with --mbias/--long/"
                        "--no_pat (single-process covers those)")
                from ..parallel.multihost import run_bam2pat_multiprocess

                with timed(timings, "procs", None):
                    pat_path = run_bam2pat_multiprocess(
                        bam, out_dir=args.out_dir, num_processes=args.procs,
                        genome=args.genome, device=args.device,
                        min_mapq=args.mapq,
                        exclude_flags=args.exclude_flags, clip=args.clip,
                        min_cpg=args.min_cpg,
                        nanopore=args.nanopore, np_thresh=args.np_thresh,
                        cpc_call=args.cpc_call,
                        combine_mods=args.combine_mods,
                        whitelist=args.whitelist, blacklist=args.blacklist,
                        blueprint=args.blueprint,
                        include_flags=args.include_flags,
                        top_strand=args.top_strand,
                        bottom_strand=args.bottom_strand,
                        read_group=args.read_group, stream=args.stream)
                if args.read_group and pat_path and op.isfile(pat_path):
                    # same RG-suffix rename as the single-process path
                    # (ref: bam2pat.py:406-407)
                    os.replace(pat_path, out_pat)
                    for ext in (".cdx", ".cdx.npz", ".csi"):
                        if op.isfile(pat_path + ext):
                            os.replace(pat_path + ext, out_pat + ext)
                    pat_path = out_pat
                if not args.no_beta and pat_path:
                    with timed(timings, "pat2beta", device):
                        pat2beta(pat_path, args.out_dir, genome=g,
                                 lbeta=args.lbeta, device=device)
                continue
            frags, pat_path, stats = bam2pat(
                bam, genome=g, out_dir=args.out_dir, min_mapq=args.mapq,
                exclude_flags=args.exclude_flags, clip=args.clip,
                min_cpg=args.min_cpg, mbias_prefix=mb, include_chroms=include,
                write_output=not args.no_pat, with_qname=args.long_reads,
                nanopore=args.nanopore, np_thresh=args.np_thresh,
                cpc_call=args.cpc_call, combine_mods=args.combine_mods,
                whitelist=args.whitelist, blacklist=args.blacklist,
                blueprint=args.blueprint, threads=args.threads,
                include_flags=args.include_flags,
                top_strand=args.top_strand, bottom_strand=args.bottom_strand,
                read_group=args.read_group, stream=args.stream,
                device=device, timings=timings,
            )
            if args.read_group and pat_path and op.isfile(pat_path):
                # ref: bam2pat.py:406-407 — suffix the pat with the RG name
                os.replace(pat_path, out_pat)
                for ext in (".cdx", ".cdx.npz", ".csi"):
                    if op.isfile(pat_path + ext):
                        os.replace(pat_path + ext, out_pat + ext)
                pat_path = out_pat
            if mb:
                try:
                    from .cmd_misc import plot_mbias

                    plot_mbias([mb + ".OT.txt", mb + ".OB.txt"],
                               args.out_dir, PE=True)
                except Exception as e:
                    eprint(f"[wt bam2pat] mbias plot failed: {e}")
            if not args.no_beta and pat_path:
                with timed(timings, "pat2beta", device):
                    pat2beta(pat_path, args.out_dir, genome=g,
                             lbeta=args.lbeta, device=device)
        except IllegalArgumentError as e:
            # skip-and-continue per file (ref: bam2pat.py:516-519)
            eprint(f"[wt bam2pat] skipping {bam}: {e}")
    return 0


def main_add_cpg_counts(argv):
    from ..pipeline.bam_split import add_cpg_counts_bam

    p = argparse.ArgumentParser(
        prog="add_cpg_counts",
        description="Annotate BAM reads with YI:Z:<nrMeth>,<nrUnmeth> tags")
    p.add_argument("bam", nargs="+")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("--suffix", default="counts")
    p.add_argument("--add_pat", action="store_true",
                   help="also add the pat string as an XP:Z tag")
    p.add_argument("--drop_singles", action="store_true",
                   help="paired-end: keep only reads whose mate is present")
    p.add_argument("--min_cpg", type=int, default=1)
    p.add_argument("--clip", type=int, default=0)
    p.add_argument("-F", "--exclude_flags", type=int, default=EXCLUDE_FLAGS)
    p.add_argument("--include_flags", type=int, default=None)
    p.add_argument("-q", "--mapq", type=int, default=MIN_MAPQ)
    strands = p.add_mutually_exclusive_group()
    strands.add_argument("--top_strand", action="store_true",
                         help="only use reads from the top (OT) strand")
    strands.add_argument("--bottom_strand", action="store_true",
                         help="only use reads from the bottom (OB) strand")
    p.add_argument("-rg", "--read_group", default=None,
                   help="only use reads with this RG:Z read-group tag")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the decode/call path is vectorized)")
    p.add_argument("-L", "--bed_file", default=None,
                   help="only annotate reads overlapping this bed")
    add_gr_args(p)
    args = p.parse_args(argv)
    if args.verbose or args.debug:
        from ..utils import set_verbose

        set_verbose()
    g = Genome(args.genome)
    regions = None
    if args.bed_file:
        from ..pipeline.bam2pat_run import _load_region_bed

        regions = _load_region_bed(args.bed_file)
    elif args.region or args.sites:
        import numpy as np

        from ..genome.region import GenomicRegion

        gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
        lo, hi = gr.bp_tuple
        regions = {gr.chrom: (np.array([lo - 1]), np.array([hi]))}
    if not op.isdir(args.out_dir):
        # ref: src/python/add_cpg_counts.py:114-115
        raise IllegalArgumentError(f"Invalid output dir: {args.out_dir}")
    for bam in args.bam:
        validate_single_file(bam)
        out = op.join(args.out_dir,
                      pretty_name(bam) + f".{args.suffix}.bam")
        if not delete_or_skip(out, args.force):
            continue
        add_cpg_counts_bam(bam, out, genome=g, min_mapq=args.mapq,
                           exclude_flags=args.exclude_flags, clip=args.clip,
                           add_pat=args.add_pat, min_cpg=args.min_cpg,
                           drop_singles=args.drop_singles, regions=regions,
                           include_flags=args.include_flags,
                           top_strand=args.top_strand,
                           bottom_strand=args.bottom_strand,
                           read_group=args.read_group)
    return 0


def main_split_by_allele(argv, timings=None):
    from ..pipeline.bam_split import split_bam_by_allele
    p = argparse.ArgumentParser(
        prog="split_by_allele",
        description="Split a BAM by the allele at a SNP position, then run "
                    "bam2pat on each part on --device")
    p.add_argument("bam")
    p.add_argument("pos", help="SNP position, e.g. chr1:12345")
    p.add_argument("alleles", help="e.g. 'C/T'")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-F", "--exclude_flags", type=int, default=EXCLUDE_FLAGS)
    p.add_argument("-q", "--mapq", type=int, default=MIN_MAPQ)
    p.add_argument("--snp_qual", type=int, default=0)
    p.add_argument("--no_pat", action="store_true",
                   help="do not run bam2pat on the split BAMs")
    p.add_argument("--no_beta", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the split is a single vectorized pass)")
    p.add_argument("--genome", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of bam2pat and pat2beta on the split "
                        "BAMs: cuda (default; an error without CUDA) or cpu")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if args.verbose or args.debug:
        from ..utils import set_verbose

        set_verbose()
    if not op.isdir(args.out_dir):
        # ref: src/python/split_by_allele.py:230-231
        raise IllegalArgumentError(f"Invalid output dir: {args.out_dir}")
    validate_single_file(args.bam)
    chrom, position = args.pos.split(":")
    let1, let2 = args.alleles.split("/")
    g = Genome(args.genome)
    with timed(timings, "split", None):
        paths = split_bam_by_allele(
            args.bam, chrom, int(position), let1, let2, out_dir=args.out_dir,
            genome=g, min_mapq=args.mapq, exclude_flags=args.exclude_flags,
            qual_filter=args.snp_qual,
        )
    if not args.no_pat:
        for bam in paths:
            _, pat_path, _ = bam2pat(bam, genome=g, out_dir=args.out_dir,
                                     include_chroms=[chrom],
                                     force=args.force, device=device,
                                     timings=timings)
            if pat_path and not args.no_beta:
                with timed(timings, "pat2beta", device):
                    pat2beta(pat_path, args.out_dir, genome=g, device=device)
    return 0


def main_split_by_meth(argv):
    from ..pipeline.bam_split import split_bam_by_meth

    p = argparse.ArgumentParser(
        prog="split_by_meth",
        description="Split a YI-tagged BAM into homogeneously meth/unmeth "
        "reads")
    p.add_argument("bam", nargs="+")
    p.add_argument("homog_prop", type=float,
                   help="homogeneity proportion threshold (e.g. 0.75)")
    p.add_argument("--min_cpg", type=int, default=1)
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-F", "--exclude_flags", type=int, default=None)
    p.add_argument("-q", "--mapq", type=int, default=None)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the split is a single pass)")
    add_gr_args(p)
    args = p.parse_args(argv)
    if args.verbose or args.debug:
        from ..utils import set_verbose

        set_verbose()
    include = None
    if args.region or args.sites:
        from ..genome.region import GenomicRegion

        gr = GenomicRegion(region=args.region, sites=args.sites,
                           genome=Genome(args.genome))
        include = gr.chrom
    if not op.isdir(args.out_dir):
        # ref: src/python/split_by_meth.py:141-142
        raise IllegalArgumentError(f"Invalid output dir: {args.out_dir}")
    for bam in args.bam:
        validate_single_file(bam)
        split_bam_by_meth(bam, out_dir=args.out_dir,
                          homog_prop=args.homog_prop, min_cpg=args.min_cpg,
                          min_mapq=args.mapq,
                          exclude_flags=args.exclude_flags,
                          include_chrom=include)
    return 0
