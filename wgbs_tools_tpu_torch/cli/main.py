"""Command line of the PyTorch/CUDA port.

    python -m wgbs_tools_tpu_torch pat2beta x.pat.gz -o out/ [--device cpu]
        [--procs N]
    python -m wgbs_tools_tpu_torch segment --betas a.beta ... [-o blocks.bed]
        [--mode exact|fast] [--device cpu]
    python -m wgbs_tools_tpu_torch beta_to_blocks a.beta ... -b blocks.bed
        [-o out/] [--lbeta] [--bedGraph] [--device cpu]
    python -m wgbs_tools_tpu_torch beta_to_table blocks.bed --betas a.beta
        ... [-g groups.csv] [-o table.tsv] [--device cpu]
    python -m wgbs_tools_tpu_torch pat2pairs x.pat.gz [-o out/]
        [--device cpu]
    python -m wgbs_tools_tpu_torch homog x.pat.gz -b blocks.bed [-o out/ |
        -p prefix] [--binary] [--device cpu]
    python -m wgbs_tools_tpu_torch bam2pat x.bam [-o out/] [--device cpu]
        [--clip N] [--min_cpg N] [--stream | --no_stream] [--mbias] ...

Flags match wgbs_tools_tpu's pat2beta (cli/cmd_pat.py::main_pat2beta),
segment (cli/cmd_segment.py), beta_to_blocks and beta_to_table
(cli/cmd_beta.py), pat2pairs (cli/cmd_misc.py), homog
(cli/cmd_homog.py) and bam2pat (cli/cmd_bam2pat.py, without --procs),
plus --device. The device defaults to cuda
and raises when CUDA is absent: the host path runs only when asked for.
With more than one visible card pat2beta's table is sharded over the
cards; --procs N (N > 1) runs N worker processes, one site range each
(parallel/multihost.py). segment runs both its modes on --device too;
its exact mode's --device cpu is the host DP (cli/cmd_segment.py).
beta_to_blocks and beta_to_table sum blocks in the block_sums kernel,
pat2pairs counts pairs in pair_counts and homog bins reads in homog_bins;
bam2pat calls reads in call_reads and merges mates in merge_pe, then runs
pat2beta; --device cpu runs each kernel's plain twin (bam2pat's calling:
numpy on the host).
"""

import argparse
import difflib
import os.path as op
import sys

from ..device import resolve_device
from ..genome.refdir import Genome
from ..parallel.multihost import run_pat2beta_multiprocess
from ..pipeline.pat2beta import pat2beta
from .cmd_beta import main_beta_to_blocks, main_beta_to_table
from .cmd_homog import main as main_homog
from .cmd_misc import main_pat2pairs
from ..utils import (
    IllegalArgumentError,
    delete_or_skip,
    eprint,
    logger,
    splitextgz,
    validate_single_file,
)


def main_pat2beta(argv):
    p = argparse.ArgumentParser(
        prog="pat2beta",
        description="Generate a beta file from a pat file (PyTorch/CUDA)")
    p.add_argument("pat_paths", nargs="+")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-l", "--lbeta", action="store_true")
    p.add_argument("--genome", default=None)
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the pileup runs on the device)")
    p.add_argument("--procs", type=int, default=None,
                   help="run as N torch.distributed worker processes, one "
                        "site range each (rank r on cuda:{r %% cards}); "
                        "byte-identical to the single-process path")
    p.add_argument("--device", default="cuda",
                   help="torch device: cuda (default; an error without "
                        "CUDA) or cpu (the kernels' plain PyTorch twins)")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    g = Genome(args.genome)
    for pat in args.pat_paths:
        validate_single_file(pat)
        suff = ".lbeta" if args.lbeta else ".beta"
        out = op.join(args.out_dir, splitextgz(op.basename(pat))[0] + suff)
        if not delete_or_skip(out, args.force):
            continue
        if args.procs and args.procs > 1:
            run_pat2beta_multiprocess(pat, out, g.get_nr_sites(),
                                      num_processes=args.procs,
                                      lbeta=args.lbeta, device=args.device)
            logger.info("pat2beta: %s -> %s (%d processes)", pat, out,
                        args.procs)
            continue
        pat2beta(pat, args.out_dir, genome=g, lbeta=args.lbeta,
                 device=device)
    return 0


def main_bam2pat(argv, timings=None):
    from .cmd_bam2pat import main as run  # it imports add_gr_args from here

    return run(argv, timings=timings)


def main_segment(argv):
    from .cmd_segment import main as run  # it imports add_gr_args from here

    return run(argv)


def add_gr_args(parser, bed_file=False):
    """Shared region flags (ref: utils_wgbs.py:233-247), without
    --array_id and --no_anno: no command of the port reads them yet."""
    g = parser.add_mutually_exclusive_group()
    g.add_argument("-s", "--sites", help='CpG index range, e.g. "450000-450050"')
    g.add_argument("-r", "--region", help='genomic region, e.g. "chr1:10,000-10,500"')
    if bed_file:
        g.add_argument("-L", "--bed_file", help="bed file with CpG columns 4-5")
    parser.add_argument("--genome", default=None, help="genome reference name")
    return parser


COMMANDS = {"pat2beta": main_pat2beta, "segment": main_segment,
            "beta_to_blocks": main_beta_to_blocks,
            "beta_to_table": main_beta_to_table,
            "pat2pairs": main_pat2pairs, "homog": main_homog,
            "bam2pat": main_bam2pat}


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="wgbstools-torch",
        description="wgbs_tools on PyTorch + CUDA (" + ", ".join(COMMANDS)
        + ")")
    parser.add_argument("command", nargs="?", help="|".join(COMMANDS))
    parser.add_argument("--version", action="store_true")
    args, _ = parser.parse_known_args(argv[:1])
    if args.version:
        from .. import __version__

        print(__version__)
        return 0
    cmd = args.command
    if cmd is None:
        parser.print_help()
        return 1
    if cmd not in COMMANDS:
        eprint(f"Invalid command: {cmd}")
        close = difflib.get_close_matches(cmd, COMMANDS.keys())
        if close:
            eprint("did you mean", " or ".join(close), "?")
        return 1
    try:
        return COMMANDS[cmd](argv[1:]) or 0
    except IllegalArgumentError as e:
        eprint(f"[wt-torch {cmd}] error: {e}")
        return 1
