"""bam2pat (ref: src/python/bam2pat.py): the port's copy of
wgbs_tools_tpu/cli/cmd_bam2pat.py's `main`, with --device.

Every flag of the JAX command is here except --procs, which waits for its
slice. --mbias writes the JAX command's m-bias tables (<name>.mbias.OT.txt
and .OB.txt) but not its plot, which waits for the port's mbias_plot
(matplotlib). add_cpg_counts, split_by_allele and split_by_meth are not
ported yet.
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
                    "piles up there",
        epilog="Not ported yet: --procs, and the m-bias plot (--mbias "
               "writes the tables only).")
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
                   help="dump m-bias tables alongside the pat (calling "
                        "then runs on the host; the plot is not ported "
                        "yet)")
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
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; an error without "
                        "CUDA) or cpu (calling and merging with numpy on "
                        "the host, the pileup's plain PyTorch twins)")
    add_gr_args(p)
    args = p.parse_args(argv)
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
            if not args.no_beta and pat_path:
                with timed(timings, "pat2beta", device):
                    pat2beta(pat_path, args.out_dir, genome=g,
                             lbeta=args.lbeta, device=device)
        except IllegalArgumentError as e:
            # skip-and-continue per file (ref: bam2pat.py:516-519)
            eprint(f"[wt bam2pat] skipping {bam}: {e}")
    return 0
