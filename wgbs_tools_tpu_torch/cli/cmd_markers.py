"""find_markers and test_bimodal commands (ref: src/python/find_markers.py,
test_bimodal.py): the port's copy of wgbs_tools_tpu/cli/cmd_markers.py.

find_markers takes --device: the blocks' sums run in the block_sums kernel
on cuda (every visible card's site shard), in its plain twin with cpu; the
scan and its statistics run on the host (models/markers.py, no pandas).
test_bimodal is host code and takes no --device.
"""

import argparse

from ..models.markers import MarkerParams, find_markers
from ..parallel.mesh import shard_devices
from ..utils import IllegalArgumentError, validate_file_list, \
    validate_single_file


def main(argv):
    p = argparse.ArgumentParser(
        prog="find_markers",
        description="Find differentially methylated blocks between groups")
    p.add_argument("--blocks_path", "-b")
    p.add_argument("--groups_file", "-g")
    p.add_argument("--betas", nargs="+")
    p.add_argument("--beta_list_file")
    p.add_argument("--config_file", "-p")
    p.add_argument("--targets", nargs="+")
    p.add_argument("--background", nargs="+")
    p.add_argument("-o", "--out_dir", default=None)
    p.add_argument("--min_cpg", type=int, default=None)
    p.add_argument("--max_cpg", type=int, default=None)
    p.add_argument("--min_bp", type=int, default=None)
    p.add_argument("--max_bp", type=int, default=None)
    p.add_argument("-c", "--min_cov", type=int, default=None)
    p.add_argument("--delta_means", type=float, default=None)
    p.add_argument("--delta_quants", type=float, default=None)
    p.add_argument("--delta_maxmin", type=float, default=None)
    p.add_argument("--tg_quant", type=float, default=None)
    p.add_argument("--bg_quant", type=float, default=None)
    p.add_argument("--na_rate_tg", type=float, default=None)
    p.add_argument("--na_rate_bg", type=float, default=None)
    p.add_argument("--unmeth_mean_thresh", type=float, default=None)
    p.add_argument("--meth_mean_thresh", type=float, default=None)
    p.add_argument("--unmeth_quant_thresh", type=float, default=None)
    p.add_argument("--meth_quant_thresh", type=float, default=None)
    p.add_argument("--pval", type=float, default=None)
    p.add_argument("--test_type", choices=["t", "mw", "m_t"], default=None)
    p.add_argument("--only_hyper", action="store_true")
    p.add_argument("--only_hypo", action="store_true")
    p.add_argument("--top", type=int, default=None)
    p.add_argument("--sort_by", default=None)
    p.add_argument("--header", action="store_true")
    p.add_argument("--chunk_size", type=int, default=None,
                   help="(compat; ref find_markers.py:101-106 pages blocks "
                        "through pandas — the scan here is one vectorized "
                        "pass over the block reduction)")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the U/M scans are vectorized batches)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device of the blocks' sums: cuda (default; "
                        "an error without CUDA) or cpu (the kernel's plain "
                        "PyTorch twin)")
    args = p.parse_args(argv)

    betas = args.betas
    if args.beta_list_file:
        validate_single_file(args.beta_list_file)
        with open(args.beta_list_file) as f:
            betas = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    if not betas:
        raise IllegalArgumentError("provide --betas or --beta_list_file")
    validate_file_list(betas)

    kw = {k: v for k, v in vars(args).items()
          if k not in ("betas", "beta_list_file", "config_file", "device")}
    params = MarkerParams(config_file=args.config_file, **kw)
    find_markers(params, betas, devices=shard_devices(args.device))
    return 0


def main_test_bimodal(argv):
    p = argparse.ArgumentParser(
        prog="test_bimodal",
        description="EM-based bimodality / allele-specific methylation test")
    p.add_argument("pat")
    p.add_argument("-s", "--sites")
    p.add_argument("-r", "--region")
    p.add_argument("-L", "--bed_file")
    p.add_argument("--array_id", help="Illumina array id, e.g. cg00001755")
    p.add_argument("--genome", default=None)
    p.add_argument("--min_len", type=int, default=3,
                   help="min CpGs per read to include")
    p.add_argument("--max_iter", type=int, default=50)
    p.add_argument("--strict", action="store_true",
                   help="truncate reads to the tested region")
    p.add_argument("-o", "--out_file", default="-",
                   help="output file ('-' = stdout)")
    p.add_argument("--print_all_regions", action="store_true",
                   help="print all regions, not only the significant ones")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the EM runs as one batch)")
    p.add_argument("-v", "--verbose", action="store_true")
    args = p.parse_args(argv)

    from ..formats.blocks import load_blocks
    from ..genome.refdir import Genome
    from ..models.bimodal import test_bimodal_region
    from .view import view_pat

    g = Genome(args.genome)
    regions = []
    if args.bed_file:
        blocks = load_blocks(args.bed_file)
        for i in range(len(blocks["startCpG"])):
            if blocks["startCpG"][i] >= 0:
                regions.append((int(blocks["startCpG"][i]),
                                int(blocks["endCpG"][i])))
    else:
        from ..genome.region import GenomicRegion

        gr = GenomicRegion(region=args.region, sites=args.sites,
                           array_id=args.array_id, genome=g)
        if gr.is_whole():
            raise IllegalArgumentError("test_bimodal requires -r/-s/-L")
        regions.append(gr.sites)

    import sys

    out = sys.stdout if args.out_file == "-" else open(args.out_file, "w")
    out.write("startCpG\tendCpG\tnr_reads\tpval\ttheta1\ttheta2\n")
    pvals = []
    rows = []
    for s, e in regions:
        frags = view_pat(args.pat, g, sites=f"{s}-{e}")
        res = test_bimodal_region(frags, s, e, max_iter=args.max_iter,
                                  strict=args.strict, min_len=args.min_len)
        rows.append((s, e, res))
        pvals.append(res["pval"])
    # BH correction across regions, most significant first; only regions
    # passing FDR alpha=0.05 are printed unless --print_all_regions
    # (ref: test_bimodal.py:195-235)
    import numpy as np

    pv = np.array([x if x == x else 1.0 for x in pvals])
    order = np.argsort(pv)
    m = len(pv)
    bh = np.empty(m)
    prev = 1.0
    for rank_i in range(m - 1, -1, -1):
        idx = order[rank_i]
        val = min(prev, pv[idx] * m / (rank_i + 1))
        bh[idx] = val
        prev = val
    single = len(rows) == 1 and not args.bed_file
    for idx in order:
        s, e, res = rows[idx]
        q = bh[idx]
        if not (single or args.print_all_regions) and q > 0.05:
            continue
        out.write(f"{s}\t{e}\t{res['nr_reads']}\t{q:.4g}\t"
                  f"{res['theta1']:.3f}\t{res['theta2']:.3f}\n")
    if args.out_file != "-":
        out.close()
    return 0
