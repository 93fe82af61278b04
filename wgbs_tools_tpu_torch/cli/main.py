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
        [--procs N] [--clip N] [--min_cpg N] [--stream | --no_stream] ...
    python -m wgbs_tools_tpu_torch split_by_allele x.bam chr1:12345 C/T
        [-o out/] [--device cpu]
    python -m wgbs_tools_tpu_torch add_cpg_counts x.bam [-o out/]
    python -m wgbs_tools_tpu_torch split_by_meth x.counts.bam 0.75
    python -m wgbs_tools_tpu_torch find_markers -b blocks.bed -g groups.csv
        --betas a.beta ... [-o out/] [--device cpu]
    python -m wgbs_tools_tpu_torch test_bimodal x.pat.gz -r chr1:1000-2000
    python -m wgbs_tools_tpu_torch view | cview x.pat.gz [-r ...]
    python -m wgbs_tools_tpu_torch index | merge | frag_len ...
    python -m wgbs_tools_tpu_torch mask_pat | mix_pat ... [--device cpu]
    python -m wgbs_tools_tpu_torch beta_cov a.beta ... [-L blocks.bed]
        [--device cpu]
    python -m wgbs_tools_tpu_torch beta2bed | beta2bw | beta_stats |
        compare_betas | beta_to_450k | bed2beta | lbeta2beta ...
    python -m wgbs_tools_tpu_torch convert -r chr1:1000-2000 | -s 10-20 |
        -L x.bed | --array_id cg...
    python -m wgbs_tools_tpu_torch init_genome NAME --fasta_path x.fa
    python -m wgbs_tools_tpu_torch set_default_ref NAME
    python -m wgbs_tools_tpu_torch vis | pat_fig x.pat.gz -s 100-140 ...
    python -m wgbs_tools_tpu_torch mbias_plot x.mbias.OT.txt x.mbias.OB.txt
    python -m wgbs_tools_tpu_torch worker serve [--warm] | run CMD ... | stop

The installed script is `wgbstools-torch`. The registry holds the JAX
CLI's 34 commands (wgbs_tools_tpu/cli/main.py). Flags match
wgbs_tools_tpu's commands of the same names, plus --device on each command
that reaches the card (and on `worker`, for its --warm pileup). The
device defaults to cuda and raises when CUDA is absent: the host path
runs only when asked for. With more than one visible card pat2beta's
table is sharded over the cards; pat2beta --procs N and bam2pat --procs N
(N > 1) run N worker processes (parallel/multihost.py). segment runs both
its modes on --device too; its exact mode's --device cpu is the host DP
(cli/cmd_segment.py). beta_to_blocks, beta_to_table, beta_cov -L and
find_markers sum blocks in the block_sums kernel, pat2pairs counts pairs
in pair_counts and homog bins reads in homog_bins; bam2pat (and
split_by_allele on its parts) calls reads in call_reads and merges mates
in merge_pe, then runs pat2beta, as mask_pat --beta and mix_pat do;
--device cpu runs each kernel's plain twin (bam2pat's calling: numpy on
the host). The other commands are host code and take no --device.
WGBS_TPU_WORKER=1 routes a command to a running `worker serve`
(cli/worker.py), and runs it in-process where none answers. This module
imports no torch: a command imports what it runs when it runs, so a
`worker run` client starts without torch.
"""

import argparse
import difflib
import os
import os.path as op
import sys

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
    from ..device import resolve_device
    from ..genome.refdir import Genome
    from ..parallel.multihost import run_pat2beta_multiprocess
    from ..pipeline.pat2beta import pat2beta

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


def _lazy(module, fn="main"):
    """A command whose module imports add_gr_args from here, loaded at its
    first call."""
    def runner(argv):
        import importlib

        mod = importlib.import_module(f"wgbs_tools_tpu_torch.cli.{module}")
        return getattr(mod, fn)(argv)

    return runner


def add_gr_args(parser, bed_file=False, no_anno=False):
    """Shared region flags (ref: utils_wgbs.py:233-247)."""
    g = parser.add_mutually_exclusive_group()
    g.add_argument("-s", "--sites", help='CpG index range, e.g. "450000-450050"')
    g.add_argument("-r", "--region", help='genomic region, e.g. "chr1:10,000-10,500"')
    g.add_argument("--array_id", help="Illumina array id, e.g. cg00001755")
    if bed_file:
        g.add_argument("-L", "--bed_file", help="bed file with CpG columns 4-5")
    if no_anno:
        parser.add_argument("--no_anno", action="store_true",
                            help="do not print genome annotations")
    parser.add_argument("--genome", default=None, help="genome reference name")
    return parser


def add_view_args(parser, out_path=True, sub_sample=True):
    parser.add_argument("--strict", action="store_true",
                        help="truncate reads outside the region")
    parser.add_argument("--strip", action="store_true",
                        help="remove leading/trailing dots")
    parser.add_argument("--min_len", type=int, default=1,
                        help="only reads covering >= MIN_LEN CpGs")
    parser.add_argument("--no_gaps", action="store_true",
                        help="drop reads with unknown (.) sites")
    if sub_sample:
        parser.add_argument("--sub_sample", type=float, help="subsample rate")
    parser.add_argument("--no_sort", action="store_true")
    parser.add_argument("--shuffle", action="store_true",
                        help="random order of reads sharing a start site "
                             "(ref: cview.py:43-46, sort -k3,3R)")
    parser.add_argument("-np", "--nanopore", action="store_true",
                        help="(compat; ref cview.py:34-37 widens the tabix "
                             "back-scan for very long reads — our .cdx "
                             "index records the true max fragment length, "
                             "so overlapping long reads are always pulled)")
    parser.add_argument("--seed", type=int, default=None)
    if out_path:
        parser.add_argument("-o", "--out_path", default=None)
    return parser


COMMANDS = {
    # view
    "vis": _lazy("cmd_vis"),
    "view": _lazy("cmd_view"),
    "cview": _lazy("cmd_view", "main_cview"),
    "convert": _lazy("cmd_convert"),
    "pat_fig": _lazy("cmd_vis", "main_pat_fig"),
    # beta ops
    "beta_to_blocks": _lazy("cmd_beta", "main_beta_to_blocks"),
    "beta_to_table": _lazy("cmd_beta", "main_beta_to_table"),
    "beta2bed": _lazy("cmd_beta", "main_beta2bed"),
    "beta2bw": _lazy("cmd_beta", "main_beta2bw"),
    "beta_cov": _lazy("cmd_beta", "main_beta_cov"),
    "beta_stats": _lazy("cmd_beta", "main_beta_stats"),
    "beta_to_450k": _lazy("cmd_beta", "main_beta_to_450k"),
    "compare_betas": _lazy("cmd_beta", "main_compare_betas"),
    # generation
    "init_genome": _lazy("cmd_genome", "main_init_genome"),
    "set_default_ref": _lazy("cmd_genome", "main_set_default_ref"),
    "bam2pat": main_bam2pat,
    "index": _lazy("cmd_pat", "main_index"),
    "pat2beta": main_pat2beta,
    "bed2beta": _lazy("cmd_beta", "main_bed2beta"),
    "lbeta2beta": _lazy("cmd_beta", "main_lbeta2beta"),
    "mix_pat": _lazy("cmd_pat", "main_mix_pat"),
    "merge": _lazy("cmd_pat", "main_merge"),
    "mask_pat": _lazy("cmd_pat", "main_mask_pat"),
    # analysis
    "segment": main_segment,
    "homog": _lazy("cmd_homog"),
    "find_markers": _lazy("cmd_markers"),
    "add_cpg_counts": _lazy("cmd_bam2pat", "main_add_cpg_counts"),
    "frag_len": _lazy("cmd_pat", "main_frag_len"),
    "split_by_allele": _lazy("cmd_bam2pat", "main_split_by_allele"),
    "split_by_meth": _lazy("cmd_bam2pat", "main_split_by_meth"),
    "test_bimodal": _lazy("cmd_markers", "main_test_bimodal"),
    # extras beyond the reference's registered commands
    "pat2pairs": _lazy("cmd_misc", "main_pat2pairs"),
    "mbias_plot": _lazy("cmd_misc", "main_mbias_plot"),
    "worker": _lazy("worker"),
}


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
    if cmd != "worker" and os.environ.get("WGBS_TPU_WORKER") == "1":
        # transparent routing: run on the persistent worker when one is up
        # (its process keeps the CUDA context and kernels loaded across
        # invocations); fall through to in-process execution when it is not
        from .worker import run_via_worker

        rc = run_via_worker(argv)
        if rc is not None:
            return rc
    try:
        return COMMANDS[cmd](argv[1:]) or 0
    except IllegalArgumentError as e:
        eprint(f"[wt-torch {cmd}] error: {e}")
        return 1
