"""pat-centric commands: index, merge, mix_pat, mask_pat, frag_len.

ref: src/python/index.py, merge.py, mix_pat.py, mask_pat.py, frag_len.py.
The port's copy of wgbs_tools_tpu/cli/cmd_pat.py (pat2beta is in
cli/main.py), with `_concat_frags`, which bam2pat (the chromosomes'
batches) and the sorted stream emitter use. mask_pat's --beta / --lbeta
and mix_pat's pat2beta of an input without a beta run on --device;
everything else is host code.
"""

import argparse
import os.path as op
import sys

import numpy as np

from ..device import resolve_device
from ..formats.beta import merge_betas
from ..formats.blocks import load_blocks
from ..formats.pat import PatFrags, index_pat
from ..genome.refdir import Genome
from ..genome.region import GenomicRegion
from ..pipeline.pat2beta import pat2beta
from ..utils import (
    IllegalArgumentError,
    delete_or_skip,
    logger,
    pretty_name,
    splitextgz,
    validate_file_list,
    validate_single_file,
)
from .main import add_gr_args, add_view_args

DEVICE_HELP = ("torch device of the beta (--beta / --lbeta): cuda (default; "
               "an error without CUDA) or cpu (the kernels' plain PyTorch "
               "twins)")


def main_index(argv):
    p = argparse.ArgumentParser(
        prog="index",
        description="bgzip and index pat (.cdx/.csi) or bed (.tbi) files")
    p.add_argument("input_files", nargs="+")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; BGZF compression is already multithreaded)")
    args = p.parse_args(argv)
    for f in args.input_files:
        validate_single_file(f)
        # exact suffix check, like the reference Indxer's validation
        # (ref: index.py:115-123 rejects anything but .pat/.bed[.gz]) —
        # a loose "bed in suffix" match would route .bedgraph files into
        # the destructive sort-check/re-sort path
        suff = splitextgz(f)[1][1:]
        if suff in ("bed", "bed.gz"):
            # bed branch: sort-check, bgzip, .tbi (ref: index.py:20-29)
            from ..formats.blocks import index_bed

            gz = f if f.endswith(".gz") else f + ".gz"
            if op.isfile(gz + ".tbi") and not args.force:
                logger.info("index exists for %s (use -f)", f)
                continue
            index_bed(f)
        elif suff in ("pat", "pat.gz"):
            if op.isfile(f + ".cdx") and not args.force:
                logger.info("index exists for %s (use -f)", f)
                continue
            index_pat(f)
        else:
            raise IllegalArgumentError(
                "Index only supports pat, bed formats")
    return 0


def _concat_frags(frag_list, labels=None):
    if not frag_list:
        raise IllegalArgumentError("no fragments to merge")
    max_len = max(f.max_len for f in frag_list)
    chrom_names = []
    lookup = {}
    parts = []
    for k, f in enumerate(frag_list):
        codes = f.codes
        if codes.shape[1] < max_len:
            codes = np.pad(codes, ((0, 0), (0, max_len - codes.shape[1])),
                           constant_values=3)
        # chrom-name union across inputs
        ids = []
        for c in f.chrom_names:
            if c not in lookup:
                lookup[c] = len(chrom_names)
                chrom_names.append(c)
            ids.append(lookup[c])
        idmap = np.array(ids, dtype=np.int16)
        cid = idmap[f.chrom_id] if len(ids) else f.chrom_id
        extras = f.extras
        if labels is not None:
            lab = labels[k].encode()
            base = f.extras if f.extras is not None else np.array(
                [None] * f.nr_frags, dtype=object)
            extras = np.array(
                [lab if b is None else b + b"\t" + lab for b in base],
                dtype=object,
            )
        parts.append((f.start, f.length, f.count, codes, cid, extras))
    has_extras = any(p[5] is not None for p in parts)
    if has_extras:
        for i, pp in enumerate(parts):
            if pp[5] is None:
                parts[i] = pp[:5] + (np.array([None] * len(pp[0]), dtype=object),)
    return PatFrags(
        np.concatenate([p[0] for p in parts]),
        np.concatenate([p[1] for p in parts]),
        np.concatenate([p[2] for p in parts]),
        np.concatenate([p[3] for p in parts]),
        np.concatenate([p[4] for p in parts]),
        chrom_names,
        np.concatenate([p[5] for p in parts]) if has_extras else None,
    )


def merge_pats(pat_paths, out_path, genome, labels=None, view_kwargs=None,
               sub_samples=None, seed=None):
    """Merge pat files with a bounded-memory k-way streaming merge
    (ref: merge.py:55-120 — `sort -m` of cview streams + collapse)."""
    from ..pipeline.pat_stream import merge_pats_streaming

    return merge_pats_streaming(pat_paths, out_path, genome, labels=labels,
                                view_kwargs=view_kwargs,
                                sub_samples=sub_samples, seed=seed)


def main_merge(argv):
    p = argparse.ArgumentParser(prog="merge", description="Merge pat or beta files")
    p.add_argument("input_files", nargs="+")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-l", "--lbeta", action="store_true")
    p.add_argument("--labels", nargs="+")
    p.add_argument("-T", "--temp_dir", default=None,
                   help="(compat; merging is in-memory, not unix sort -m)")
    p.add_argument("-v", "--verbose", action="store_true")
    add_gr_args(p, bed_file=True)
    add_view_args(p)
    args = p.parse_args(argv)
    files = args.input_files
    validate_file_list(files)
    ftype = splitextgz(files[0])[1][1:]
    out_path = args.prefix + splitextgz(files[0])[1]
    if op.realpath(out_path) in [op.realpath(x) for x in files]:
        raise IllegalArgumentError("output path identical to an input file")
    if not delete_or_skip(out_path, args.force):
        return 0
    if ftype in ("beta", "lbeta", "bin"):
        merge_betas(files, out_path, args.lbeta)
    elif ftype == "pat.gz":
        g = Genome(args.genome)
        view_kwargs = dict(
            region=args.region, sites=args.sites, bed_file=args.bed_file,
            strict=args.strict, strip=args.strip, min_len=args.min_len,
        )
        merge_pats(files, args.prefix + ".pat.gz", g, labels=args.labels,
                   view_kwargs=view_kwargs)
    else:
        raise IllegalArgumentError(f"Unknown input format: {files[0]}")
    return 0


def main_mask_pat(argv):
    p = argparse.ArgumentParser(prog="mask_pat",
                                description="Mask CpG sites inside given blocks")
    p.add_argument("pat")
    p.add_argument("-b", "--sites_to_hide", "-L", "--bed_file",
                   dest="bed_file", required=True,
                   help="bed file with sites / blocks to mask out")
    p.add_argument("-p", "--prefix", required=True)
    p.add_argument("-f", "--force", action="store_true")
    which = p.add_mutually_exclusive_group()
    which.add_argument("--beta", action="store_true",
                       help="create beta from the masked pat")
    which.add_argument("--lbeta", action="store_true",
                       help="create lbeta from the masked pat")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; masking is one vectorized pass)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    add_gr_args(p)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    validate_single_file(args.pat, ".pat.gz")
    g = Genome(args.genome)
    out = args.prefix + ".pat.gz"
    if not delete_or_skip(out, args.force):
        return 0
    blocks = load_blocks(args.bed_file)
    keep = blocks["startCpG"] >= 0
    order = np.argsort(blocks["startCpG"][keep], kind="stable")
    bstart = blocks["startCpG"][keep][order]
    bend = blocks["endCpG"][keep][order]
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
    from ..pipeline.pat_stream import mask_pat_streaming

    mask_pat_streaming(args.pat, out, bstart, bend, g,
                       region_sites=None if gr.is_whole() else gr.sites)
    if args.beta or args.lbeta:
        pat2beta(out, op.dirname(out) or ".", genome=g, lbeta=args.lbeta,
                 device=device)
    return 0


def main_mix_pat(argv):
    p = argparse.ArgumentParser(
        prog="mix_pat", description="In-silico mix of K pat files")
    p.add_argument("pat_files", nargs="+")
    p.add_argument("-c", "--cov", type=float)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--reps", type=int, default=1)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    p.add_argument("--labels", nargs="+")
    p.add_argument("-p", "--prefix")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-l", "--lbeta", action="store_true")
    p.add_argument("-T", "--temp_dir", default=None,
                   help="(compat; merging is in-memory, not unix sort)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; repetitions run as vectorized batches)")
    p.add_argument("--device", default="cuda",
                   help="torch device of pat2beta for an input without a "
                        "beta: cuda (default; an error without CUDA) or cpu")
    add_gr_args(p, bed_file=True)
    add_view_args(p, out_path=False, sub_sample=False)  # provides --seed etc.
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    validate_file_list(args.pat_files, "pat.gz", 2)
    g = Genome(args.genome)

    rates = list(args.rates)
    n = len(args.pat_files)
    if len(rates) == n - 1:
        rates.append(1.0 - float(np.sum(rates)))
    if len(rates) != n:
        raise IllegalArgumentError("len(rates) must be len(files) or len(files)-1")
    if abs(sum(rates) - 1) > 1e-8:
        raise IllegalArgumentError(f"Sum(rates) == {sum(rates)} != 1")

    # coverage of each input (ref: mix_pat.py:88-114)
    from .cmd_beta import beta_cov_value

    covs = []
    for pat in args.pat_files:
        beta = pat[:-7] + (".lbeta" if args.lbeta else ".beta")
        if not op.isfile(beta):
            logger.info("mix: no beta for %s; generating", pat)
            beta = pat2beta(pat, op.dirname(pat) or ".", genome=g,
                            lbeta=args.lbeta, device=device)
        covs.append(beta_cov_value(beta, g, region=args.region,
                                   sites=args.sites))
    dest_cov = args.cov or covs[int(np.argmax(rates))]
    adj_rates = []
    for i in range(n):
        adjr = rates[i] * dest_cov / covs[i]
        if adjr > 1:
            logger.warning("mix: %s has low coverage; reads will be duplicated",
                           args.pat_files[i])
        adj_rates.append(adjr)

    labels = args.labels or [pretty_name(f) for f in args.pat_files]
    if len(set(labels)) != len(labels):
        raise IllegalArgumentError("duplicated labels")

    prefix = args.prefix
    if not prefix:
        names = "_".join(
            f"{pretty_name(f)}_{r}" for f, r in zip(args.pat_files, rates)
        )
        prefix = op.join(args.out_dir, f"{names}_cov_{dest_cov:.2f}")

    view_kwargs = dict(region=args.region, sites=args.sites,
                       bed_file=args.bed_file, strict=args.strict,
                       strip=args.strip, min_len=args.min_len)
    for rep in range(args.reps):
        out = prefix + f"_{rep + 1}.pat.gz"
        if not delete_or_skip(out, args.force):
            continue
        # subsample rates > 0.25 use binomial reps doubling inside view_pat
        merge_pats(args.pat_files, out, g, labels=labels,
                   view_kwargs=view_kwargs, sub_samples=adj_rates,
                   seed=None if args.seed is None else args.seed + rep * 1000)
        logger.info("mix: wrote %s", out)
    return 0


def main_frag_len(argv):
    p = argparse.ArgumentParser(
        prog="frag_len", description="Fragment length (in CpGs) histogram")
    p.add_argument("pat_paths", nargs="+")
    p.add_argument("-m", "--max_frag_size", type=int, default=30)
    p.add_argument("-o", "--outdir", default=None,
                   help="output directory for the histogram figure(s)")
    p.add_argument("--display", action="store_true",
                   help="display histogram plot(s) (plt.show)")
    p.add_argument("--out_path", default=None,
                   help="write the histogram values to this file")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the histogram values to stdout")
    add_gr_args(p, bed_file=True)
    args = p.parse_args(argv)
    g = Genome(args.genome)
    out = open(args.out_path, "w") if args.out_path else sys.stdout
    for pat in args.pat_paths:
        # the histogram is additive over chunks: stream the pat in bounded
        # memory (the reference streams awk over a cview pipe likewise,
        # ref: src/python/frag_len.py:21-46); no sort/collapse needed
        from ..pipeline.pat_stream import iter_view_pat

        hist = np.zeros(args.max_frag_size + 1)
        for frags, _wm in iter_view_pat(pat, g, region=args.region,
                                        sites=args.sites,
                                        bed_file=args.bed_file):
            if frags.nr_frags == 0:
                continue
            sizes = np.minimum(frags.length, args.max_frag_size)
            hist += np.bincount(sizes, weights=frags.count,
                                minlength=args.max_frag_size + 1)
        if args.out_path or args.verbose or not (args.outdir
                                                 or args.display):
            out.write(f"# {pretty_name(pat)}\n")
            for i in range(1, args.max_frag_size + 1):
                out.write(f"{i}\t{int(hist[i])}\n")
        if args.outdir or args.display:
            import matplotlib

            if not args.display:
                matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure()
            plt.bar(np.arange(1, args.max_frag_size + 1),
                    hist[1:args.max_frag_size + 1])
            plt.title(f"fragment lengths (CpGs)\n{pretty_name(pat)}")
            if args.outdir:
                fpath = op.join(args.outdir, pretty_name(pat) + ".png")
                plt.savefig(fpath)
                logger.info("frag_len: %s", fpath)
            if args.display:
                plt.show()
    if args.out_path:
        out.close()
    return 0
