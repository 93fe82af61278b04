"""beta-centric commands of the port: beta_to_blocks, beta_to_table,
beta2bed, beta2bw, beta_cov, beta_stats, bed2beta, lbeta2beta,
beta_to_450k and compare_betas.

Port of wgbs_tools_tpu/cli/cmd_beta.py (ref: src/python/beta_to_blocks.py,
beta_to_table.py, beta2bed.py, beta2bw.py, beta_cov.py, beta_stats.py,
bed2beta.py, lbeta2beta.py, beta_to_450k.py, compare_betas.py). The block
sums of beta_to_blocks, beta_to_table and beta_cov -L run in
ops/reduceat.py::reduce_data_to_blocks: on cuda the block_sums kernel
(over every visible card's site shard when there are several), with
--device cpu its plain twin; those three take --device. The other seven
are host code (numpy; beta2bw writes its bigWig with formats/bigwig.py),
and beta_cov --plot and compare_betas' figure import matplotlib when
asked for. Each writes the JAX CLI's bytes.
"""

import argparse
import gzip
import os.path as op
import sys

import numpy as np

from ..device import resolve_device, timed
from ..formats.beta import beta2vec, load_beta, trim_to_uint
from ..formats.blocks import is_block_file_nice, load_blocks
from ..genome.refdir import Genome
from ..genome.region import GenomicRegion
from ..ops.reduceat import reduce_data_to_blocks
from ..parallel.mesh import shard_devices
from ..utils import (
    IllegalArgumentError,
    delete_or_skip,
    logger,
    pretty_name,
    set_verbose,
    splitextgz,
    validate_file_list,
    validate_single_file,
)
from .main import add_gr_args

DEVICE_HELP = ("torch device: cuda (default; an error without CUDA) or cpu "
               "(the kernels' plain PyTorch twins)")

# ------------------------------------------------------------ beta_to_blocks


def reduce_beta_to_blocks(beta_path, blocks, devices=None, timings=None):
    """One beta -> (B, 2) int64 block sums (ref: beta_to_blocks.py:101-126).

    Over the site shards of `devices` (parallel/mesh.py::shard_devices;
    default: every visible card, one shard each). With `timings`, the
    seconds of load (the beta's rows from disk), h2d, kernel and fetch
    accumulate there."""
    if devices is None:
        devices = shard_devices("cuda")
    starts = blocks["startCpG"]
    ends = blocks["endCpG"]
    nice, _ = (is_block_file_nice(blocks) if (starts >= 0).all()
               else (False, "NA"))
    with timed(timings, "load", None):
        if nice and starts.shape[0]:
            lo, hi = int(starts.min()), int(ends.max())
            data, base = load_beta(beta_path, sites=(lo, hi)), lo
        else:
            data, base = load_beta(beta_path), 1
    return reduce_data_to_blocks(data, starts, ends, base=base,
                                 device=devices, timings=timings)


def beta_cov_value(beta_path, genome, region=None, sites=None, blocks=None,
                   devices=None):
    """Mean coverage (ref: beta_cov.py:62-69); with `blocks`, the blocks'
    sums come from reduce_beta_to_blocks on `devices`."""
    if blocks is not None:
        reduced = reduce_beta_to_blocks(beta_path, blocks, devices=devices)
        nr_sites = (blocks["endCpG"] - blocks["startCpG"]).clip(0).sum()
        return float(reduced[:, 1].sum() / max(nr_sites, 1))
    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    if gr.is_whole():
        data = load_beta(beta_path)
    else:
        data = load_beta(beta_path, sites=gr.sites)
    return float(np.mean(data[:, 1]))


def main_beta_to_blocks(argv, timings=None):
    p = argparse.ArgumentParser(
        prog="beta_to_blocks",
        description="Collapse beta files to block binary files")
    p.add_argument("input_files", nargs="+")
    p.add_argument("-b", "--blocks_file", required=True)
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-l", "--lbeta", action="store_true")
    p.add_argument("--bedGraph", action="store_true")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the reduction is one kernel launch per "
                        "file and card)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    devices = shard_devices(resolve_device(args.device))
    validate_file_list(args.input_files)
    blocks = load_blocks(args.blocks_file)
    for beta in args.input_files:
        name = op.splitext(op.basename(beta))[0]
        suff = ".lbeta" if args.lbeta else ".bin"
        prefix = op.join(args.out_dir, name)
        if not delete_or_skip(prefix + suff, args.force):
            continue
        reduced = reduce_beta_to_blocks(beta, blocks, devices=devices,
                                        timings=timings)
        with timed(timings, "write", None):
            trim_to_uint(reduced, args.lbeta).tofile(prefix + suff)
        logger.info("beta_to_blocks: %s", prefix + suff)
        if args.bedGraph:
            with np.errstate(divide="ignore", invalid="ignore"):
                vals = reduced[:, 0] / reduced[:, 1]
            with timed(timings, "write", None), \
                    open(prefix + ".bedGraph", "w") as f:
                for i in range(reduced.shape[0]):
                    v = "-1" if np.isnan(vals[i]) else f"{vals[i]:.2f}"
                    f.write(
                        f"{blocks['chr'][i]}\t{blocks['start'][i]}\t"
                        f"{blocks['end'][i]}\t{v}\t{reduced[i, 1]}\n"
                    )
    return 0


# ------------------------------------------------------------ beta_to_table


def load_uxm(path, n_blocks, um="U", min_cov=4):
    """U (or M) read fraction per block from a binary .uxm file
    (ref: dmb.py:10-16; cond is strictly greater than min_cov)."""
    data = np.fromfile(path, np.uint8).reshape((-1, 3))[:n_blocks]
    covs = data.sum(axis=1).astype(np.float64)
    cond = covs > min_cov
    idx = {"U": 0, "X": 1, "M": 2}[um]
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.divide(data[:, idx], covs, where=cond)
    r[~cond] = np.nan
    return r.astype(float)


def build_beta_table(blocks, beta_paths, groups=None, min_cov=4,
                     devices=None, timings=None):
    """blocks x samples mean-methylation matrix (ref: beta_to_table.py:72-106).

    Inputs may be beta/lbeta (mean methylation) or binary .uxm files
    (U-read fraction, ref: beta_to_table.py:59-69). groups: optional
    {group_name: [basenames]}; group columns average member columns
    (NaN-aware). The block sums run as reduce_beta_to_blocks runs them.
    """
    names = [pretty_name(b) for b in beta_paths]
    cols = {}
    n_blocks = blocks["startCpG"].shape[0]
    for b, name in zip(beta_paths, names):
        if b.endswith(".uxm"):
            cols[name] = load_uxm(b, n_blocks, "U", min_cov)
            continue
        reduced = reduce_beta_to_blocks(b, blocks, devices, timings)
        cols[name] = beta2vec(reduced, min_cov=min_cov)
    if groups:
        out = {}
        for gname, members in groups.items():
            mat = np.stack([cols[m] for m in members])
            with np.errstate(invalid="ignore"):
                out[gname] = np.nanmean(mat, axis=0)
        return out
    return cols


def load_groups_file(path):
    """groups csv: columns name,group (ref: dmb.py:24-38)."""
    import csv

    groups = {}
    with open(path) as f:
        reader = csv.DictReader(f)
        if "name" not in reader.fieldnames or "group" not in reader.fieldnames:
            raise IllegalArgumentError("groups file must have name,group columns")
        for row in reader:
            groups.setdefault(row["group"], []).append(row["name"])
    return groups


def main_beta_to_table(argv, timings=None):
    p = argparse.ArgumentParser(
        prog="beta_to_table",
        description="blocks x samples methylation table")
    p.add_argument("blocks_file")
    p.add_argument("--betas", nargs="+")
    p.add_argument("-g", "--groups_file", default=None)
    p.add_argument("-c", "--min_cov", type=int, default=4)
    p.add_argument("-o", "--output", default=None)
    p.add_argument("--digits", type=int, default=2,
                   help="float precision [2]")
    p.add_argument("--chunk_size", type=int, default=200_000,
                   help="blocks processed per chunk (memory bound)")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the block sums run on the device)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    devices = shard_devices(resolve_device(args.device))
    blocks = load_blocks(args.blocks_file)
    groups = None
    if args.groups_file:
        groups = load_groups_file(args.groups_file)
        name2path = {pretty_name(b): b for b in args.betas}
        for gname, members in groups.items():
            missing = [m for m in members if m not in name2path]
            if missing:
                raise IllegalArgumentError(f"group {gname}: missing betas {missing}")
    out = open(args.output, "w") if args.output else sys.stdout
    B = blocks["startCpG"].shape[0]
    first = True
    # chunked generator over the blocks axis (ref: beta_to_table.py:131-139)
    for lo in range(0, max(B, 1), max(args.chunk_size, 1)):
        hi = min(lo + args.chunk_size, B)
        if lo >= hi:
            break
        chunk = {k: v[lo:hi] for k, v in blocks.items()}
        table = build_beta_table(chunk, args.betas, groups=groups,
                                 min_cov=args.min_cov, devices=devices,
                                 timings=timings)
        with timed(timings, "write", None):
            if first:
                hdr = (["chr", "start", "end", "startCpG", "endCpG"]
                       + list(table.keys()))
                out.write("\t".join(hdr) + "\n")
                first = False
            colvals = list(table.values())
            for i in range(hi - lo):
                row = [
                    str(chunk["chr"][i]), str(chunk["start"][i]),
                    str(chunk["end"][i]), str(chunk["startCpG"][i]),
                    str(chunk["endCpG"][i]),
                ]
                for v in colvals:
                    row.append("NA" if np.isnan(v[i])
                               else f"{v[i]:.{args.digits}f}")
                out.write("\t".join(row) + "\n")
    if args.output:
        out.close()
    return 0


# ------------------------------------------------------------ beta2bed / bw


def main_beta2bed(argv):
    p = argparse.ArgumentParser(prog="beta2bed",
                                description="beta -> bedGraph text")
    p.add_argument("beta_path")
    p.add_argument("-c", "--min_cov", type=int, default=1)
    p.add_argument("--mean", action="store_true",
                   help="print mean methylation instead of meth/cov pair")
    p.add_argument("--keep_na", action="store_true",
                   help="keep sites below min_cov (as NaN in --mean mode)")
    p.add_argument("-o", "--out_path", "--outpath", dest="out_path",
                   default=None)
    p.add_argument("-f", "--force", action="store_true",
                   help="overwrite an existing output file")
    add_gr_args(p, bed_file=True)
    args = p.parse_args(argv)
    g = Genome(args.genome)
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
    idx = g.index
    if args.out_path and not delete_or_skip(args.out_path, args.force):
        return 0
    # -L: one site range per block, emitted in block order (the reference
    # streams bview per block, ref: beta2bed.py:11 -> view.py bview with -L)
    if args.bed_file:
        blocks = load_blocks(args.bed_file)
        keep = blocks["startCpG"] >= 0
        ranges = list(zip(blocks["startCpG"][keep].tolist(),
                          blocks["endCpG"][keep].tolist()))
    else:
        s, e = (1, idx.nr_sites + 1) if gr.is_whole() else gr.sites
        ranges = [(s, e)]
    out = open(args.out_path, "w") if args.out_path else sys.stdout
    names = idx.chrom_names
    for s, e in ranges:
        data = load_beta(args.beta_path, sites=(s, e))
        loci = idx.loci[s - 1 : e - 1]
        cids = idx.site2chrom_id(np.arange(s, e))
        # ref: beta2bed.py:11-19 — sites below min_cov are zeroed; without
        # keep_na zero-coverage rows are dropped; --mean prints -1 for them
        for i in range(e - s):
            cov = int(data[i, 1])
            m = int(data[i, 0])
            if cov < args.min_cov:
                cov = m = 0
            if cov == 0 and not args.keep_na:
                continue
            loc = int(loci[i])
            if args.mean:
                val = -1.0 if cov == 0 else m / cov
                out.write(
                    f"{names[cids[i]]}\t{loc - 1}\t{loc + 1}\t{val:.3g}\n")
            else:
                out.write(
                    f"{names[cids[i]]}\t{loc - 1}\t{loc + 1}\t{m}\t{cov}\n")
    if args.out_path:
        out.close()
    return 0


def main_beta2bw(argv):
    """beta -> bigWig (native container writer; ref: beta2bw.py shells out
    to UCSC bedGraphToBigWig instead)."""
    p = argparse.ArgumentParser(prog="beta2bw", description="beta -> bigWig")
    p.add_argument("beta_paths", nargs="+")
    p.add_argument("-c", "--min_cov", type=int, default=1)
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("--cov", "--dump_cov", dest="with_cov",
                   action="store_true", help="also emit a coverage track")
    p.add_argument("--keep_na", action="store_true",
                   help="emit sites below min_cov with value -1")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-b", "--bedGraph", action="store_true",
                   help="also keep a compressed bedGraph of the meth track "
                        "(ref: beta2bw.py:48-51)")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; tracks are written in one pass)")
    add_gr_args(p, bed_file=True)
    args = p.parse_args(argv)
    from ..formats.bigwig import write_bigwig

    if not op.isdir(args.outdir):
        # ref: src/python/beta2bw.py:30-31
        raise IllegalArgumentError(f"Invalid output directory: "
                                   f"{args.outdir}")
    g = Genome(args.genome)
    idx = g.index
    chrom_sizes = [(c, int(s)) for c, s in
                   zip(idx.chrom_names, idx.chrom_sizes.tolist())]
    site_mask = None
    if args.bed_file:  # -L: restrict tracks to the bed's site ranges
        blocks = load_blocks(args.bed_file)
        site_mask = np.zeros(idx.nr_sites, dtype=bool)
        for bs, be in zip(blocks["startCpG"], blocks["endCpG"]):
            if bs >= 1:
                site_mask[bs - 1 : be - 1] = True
    for beta in args.beta_paths:
        out = op.join(args.outdir, pretty_name(beta) + ".bigwig")
        if not delete_or_skip(out, args.force):
            continue
        data = load_beta(beta)
        meth_tracks, cov_tracks = {}, {}
        for cid, chrom in enumerate(idx.chrom_names):
            lo, hi = idx.chrom_offsets[cid], idx.chrom_offsets[cid + 1]
            sub = data[lo:hi]
            loci = idx.loci[lo:hi].astype(np.int64)
            keep = (sub[:, 1] >= args.min_cov)
            if args.keep_na:  # NA sites emitted as -1 (ref: beta2bed.py:18)
                keep = np.ones(sub.shape[0], dtype=bool)
            if site_mask is not None:
                keep &= site_mask[lo:hi]
            if keep.any():
                covd = np.maximum(sub[keep, 1], 1)
                vals = np.where(sub[keep, 1] >= max(args.min_cov, 1),
                                sub[keep, 0] / covd, -1.0)
                meth_tracks[chrom] = (loci[keep] - 1, loci[keep] + 1,
                                      vals.astype(np.float32))
            covk = sub[:, 1] > 0
            if site_mask is not None:
                covk &= site_mask[lo:hi]
            if args.with_cov and covk.any():
                cov_tracks[chrom] = (loci[covk] - 1, loci[covk] + 1,
                                     sub[covk, 1].astype(np.float32))
        write_bigwig(out, chrom_sizes, meth_tracks)
        logger.info("beta2bw: %s", out)
        if args.bedGraph:
            bg = op.join(args.outdir, pretty_name(beta) + ".bedGraph.gz")
            with gzip.open(bg, "wt") as f:
                for chrom, (st, en, vals) in meth_tracks.items():
                    for j in range(st.shape[0]):
                        f.write(f"{chrom}\t{st[j]}\t{en[j]}"
                                f"\t{vals[j]:.3g}\n")
            logger.info("beta2bw: %s", bg)
        if args.with_cov:
            covout = op.join(args.outdir, pretty_name(beta) + ".cov.bigwig")
            write_bigwig(covout, chrom_sizes, cov_tracks)
            logger.info("beta2bw: %s", covout)
    return 0


# ------------------------------------------------------------ cov / stats


def main_beta_cov(argv):
    p = argparse.ArgumentParser(prog="beta_cov",
                                description="Mean coverage of beta files")
    p.add_argument("betas", nargs="+")
    p.add_argument("-L", "--bed_file", default=None)
    p.add_argument("--plot", action="store_true",
                   help="matplotlib histogram of per-file coverages")
    p.add_argument("--hist", action="store_true",
                   help="in-terminal histogram of per-file coverages")
    p.add_argument("-o", "--out_path", default=None,
                   help="save the --plot figure here instead of showing it")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; -L's block sums run on the device)")
    add_gr_args(p)
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    devices = shard_devices(resolve_device(args.device))
    g = Genome(args.genome)
    blocks = load_blocks(args.bed_file) if args.bed_file else None
    names, covs = [], []
    for beta in args.betas:
        cov = beta_cov_value(beta, g, region=args.region, sites=args.sites,
                             blocks=blocks, devices=devices)
        names.append(pretty_name(beta))
        covs.append(cov)
        print(f"{names[-1]}\t{cov:.2f}")
    if args.hist:
        # in-terminal histogram (ref: beta_cov.py:13-17 uses plotille)
        lo, hi = min(covs), max(covs)
        nb = min(20, max(len(covs), 1))
        edges = np.linspace(lo, hi + 1e-9, nb + 1)
        counts, _ = np.histogram(covs, bins=edges)
        peak = max(int(counts.max()), 1)
        for k in range(nb):
            bar = "#" * int(40 * counts[k] / peak)
            print(f"{edges[k]:8.2f}-{edges[k + 1]:<8.2f} {bar} {counts[k]}")
    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.hist(covs)
        plt.title(f"beta coverage histogram\nmean cov:{np.mean(covs):.2f}")
        plt.xticks(rotation=70)
        plt.subplots_adjust(bottom=0.15)
        out = args.out_path or "beta_cov_hist.png"
        plt.savefig(out)
        print(f"[wt beta_cov] saved {out}")
    return 0


def main_beta_stats(argv):
    p = argparse.ArgumentParser(prog="beta_stats",
                                description="Summary stats per beta file")
    p.add_argument("betas", nargs="+")
    p.add_argument("-c", "--min_cov", type=int, default=1)
    p.add_argument("-w", "--width", type=int, default=120,
                   help="(compat; output is plain TSV, never wrapped)")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; stats are one vectorized pass per file)")
    add_gr_args(p, bed_file=True)
    args = p.parse_args(argv)
    g = Genome(args.genome)
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
    sel = None
    if args.bed_file:  # -L: stats over the bed's site ranges only
        blocks = load_blocks(args.bed_file)
        sel = np.zeros(g.index.nr_sites, dtype=bool)
        for bs, be in zip(blocks["startCpG"], blocks["endCpG"]):
            if bs >= 1:
                sel[bs - 1 : be - 1] = True
    print("name\tmean_meth\tcovered_sites\ttotal_sites\tmean_depth")
    for beta in args.betas:
        data = (load_beta(beta) if gr.is_whole()
                else load_beta(beta, sites=gr.sites))
        if sel is not None:
            data = data[sel if gr.is_whole()
                        else sel[gr.sites[0] - 1 : gr.sites[1] - 1]]
        vec = beta2vec(data, min_cov=args.min_cov)
        covered = int((data[:, 1] >= args.min_cov).sum())
        mean_meth = float(np.nanmean(vec)) if covered else float("nan")
        print(f"{pretty_name(beta)}\t{mean_meth:.4f}\t{covered}\t"
              f"{data.shape[0]}\t{np.mean(data[:, 1]):.2f}")
    return 0


# ------------------------------------------------------------ conversions


def main_bed2beta(argv):
    p = argparse.ArgumentParser(
        prog="bed2beta",
        description="bed (chr start end #meth #total) -> beta")
    p.add_argument("bed_paths", nargs="+")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--add_one", action="store_true",
                   help="add 1 to start column to match CpG dictionary loci")
    p.add_argument("-o", "--outdir", default=".")
    p.add_argument("--genome", default=None)
    p.add_argument("-d", "--debug", action="store_true",
                   help="verbose (DEBUG-level) logging")
    args = p.parse_args(argv)
    if args.debug:
        set_verbose()
    validate_file_list(args.bed_paths)
    g = Genome(args.genome)
    idx = g.index
    for bed in args.bed_paths:
        outpath = op.join(args.outdir, splitextgz(op.basename(bed))[0] + ".beta")
        if not delete_or_skip(outpath, args.force):
            continue
        counts = np.zeros((idx.nr_sites, 2), dtype=np.int64)
        opener = gzip.open if bed.endswith(".gz") else open
        seen = set()
        with opener(bed, "rb") as f:
            for line in f:
                tokens = line.rstrip(b"\n").split(b"\t")
                if len(tokens) < 5 or not tokens[1].isdigit():
                    continue
                chrom = tokens[0].decode()
                if chrom not in idx._chrom_lookup:
                    continue
                start = int(tokens[1]) + (1 if args.add_one else 0)
                key = (chrom, start)
                if key in seen:
                    continue
                seen.add(key)
                site = idx.locus2site(chrom, start)
                lo, hi = idx.chrom_site_bounds(chrom)
                if site < hi and int(idx.loci[site - 1]) == start:
                    counts[site - 1, 0] = int(tokens[3])
                    counts[site - 1, 1] = int(tokens[4])
        trim_to_uint(counts).tofile(outpath)
        logger.info("bed2beta: %s", outpath)
    return 0


def main_lbeta2beta(argv):
    p = argparse.ArgumentParser(prog="lbeta2beta", description="uint16 -> uint8")
    p.add_argument("lbetas", nargs="+")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("--genome", default=None,
                   help="genome name for the size sanity check")
    args = p.parse_args(argv)
    if args.genome:
        from ..formats.beta import beta_sanity_check

        nr = Genome(args.genome).index.nr_sites
        for lb in args.lbetas:
            if not beta_sanity_check(lb, nr):
                raise IllegalArgumentError(
                    f"{lb} does not match genome {args.genome} "
                    f"({nr} sites)")
    for lb in args.lbetas:
        validate_single_file(lb, ".lbeta")
        out = op.join(args.out_dir, op.basename(lb)[: -len(".lbeta")] + ".beta")
        if not delete_or_skip(out, args.force):
            continue
        data = load_beta(lb).astype(np.int64)
        trim_to_uint(data, lbeta=False).tofile(out)
    return 0


def main_beta_to_450k(argv):
    p = argparse.ArgumentParser(
        prog="beta_to_450k",
        description="beta -> Illumina 450K/EPIC array-style csv")
    p.add_argument("betas", nargs="+")
    p.add_argument("-o", "--out_path", default=None)
    p.add_argument("-c", "--min_cov", "--cov_thresh", dest="min_cov",
                   type=int, default=1)
    p.add_argument("--EPIC", action="store_true",
                   help="also emit EPIC-only probes (default: 450K subset)")
    p.add_argument("--ref", default=None,
                   help="one-column file of Illumina IDs to use instead of "
                        "the genome map's default subset")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; one vectorized gather per file)")
    p.add_argument("--genome", default=None)
    args = p.parse_args(argv)
    g = Genome(args.genome)
    idict = g.ilmn2cpg_dict
    if idict is None:
        raise IllegalArgumentError(
            "no ilmn2CpG.tsv.gz map in the genome reference dir")
    ids, sites, is450 = [], [], []
    with gzip.open(idict, "rt") as f:
        for line in f:
            tokens = line.rstrip("\n").split("\t")
            if len(tokens) >= 2 and tokens[1].isdigit():
                ids.append(tokens[0])
                sites.append(int(tokens[1]))
                # optional 3rd column marks 450K membership
                # (ref: beta_to_450k.py:39-41 drops EPIC-only probes)
                is450.append(len(tokens) < 3 or tokens[2] == "1")
    sites = np.array(sites, dtype=np.int64)
    if args.ref:
        with open(args.ref) as f:
            wanted = {line.strip() for line in f if line.strip()}
        keep = np.array([i in wanted for i in ids])
    elif args.EPIC:
        keep = np.ones(len(ids), dtype=bool)
    else:
        keep = np.array(is450, dtype=bool)
    ids = [i for i, k in zip(ids, keep) if k]
    sites = sites[keep]
    out = open(args.out_path, "w") if args.out_path else sys.stdout
    names = [pretty_name(b) for b in args.betas]
    out.write("ID_REF," + ",".join(names) + "\n")
    vecs = []
    for b in args.betas:
        data = load_beta(b)
        vec = beta2vec(data, min_cov=args.min_cov)
        vecs.append(vec[sites - 1])
    for i, cgid in enumerate(ids):
        row = [cgid]
        for v in vecs:
            row.append("NA" if np.isnan(v[i]) else f"{v[i]:.3f}")
        out.write(",".join(row) + "\n")
    if args.out_path:
        out.close()
    return 0


def main_compare_betas(argv):
    p = argparse.ArgumentParser(
        prog="compare_betas",
        description="Pairwise comparison of beta files")
    p.add_argument("betas", nargs="+")
    p.add_argument("-c", "--min_cov", type=int, default=10)
    p.add_argument("-o", "--outpath", default=None,
                   help="save pairwise 2-D histogram figure (png/pdf)")
    p.add_argument("--bins", type=int, default=101,
                   help="histogram bins (resolution) [101]")
    p.add_argument("--show", action="store_true",
                   help="display the figure (matplotlib.pyplot.show)")
    add_gr_args(p)
    args = p.parse_args(argv)
    validate_file_list(args.betas, min_len=2)
    g = Genome(args.genome)
    gr = GenomicRegion(region=args.region, sites=args.sites, genome=g)
    vecs = []
    for b in args.betas:
        data = (load_beta(b) if gr.is_whole() else load_beta(b, sites=gr.sites))
        vecs.append(beta2vec(data, min_cov=args.min_cov))
    n = len(vecs)
    print("fileA\tfileB\tpearson\trmse\tn_common")
    for i in range(n):
        for j in range(i + 1, n):
            both = ~np.isnan(vecs[i]) & ~np.isnan(vecs[j])
            a, b = vecs[i][both], vecs[j][both]
            r = float(np.corrcoef(a, b)[0, 1]) if both.sum() > 1 else float("nan")
            rmse = float(np.sqrt(np.mean((a - b) ** 2))) if both.sum() else float("nan")
            print(f"{pretty_name(args.betas[i])}\t{pretty_name(args.betas[j])}"
                  f"\t{r:.4f}\t{rmse:.4f}\t{int(both.sum())}")
    if args.outpath or args.show:
        import matplotlib

        if not args.show:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(n, n, figsize=(3 * n, 3 * n))
        axes = np.atleast_2d(axes)
        for i in range(n):
            for j in range(n):
                ax = axes[i][j]
                if i == j:
                    ax.hist(vecs[i][~np.isnan(vecs[i])], bins=args.bins)
                else:
                    both = ~np.isnan(vecs[i]) & ~np.isnan(vecs[j])
                    ax.hist2d(vecs[j][both], vecs[i][both], bins=args.bins,
                              cmap="viridis", cmin=1)
                if i == n - 1:
                    ax.set_xlabel(pretty_name(args.betas[j]))
                if j == 0:
                    ax.set_ylabel(pretty_name(args.betas[i]))
        fig.tight_layout()
        if args.outpath:
            fig.savefig(args.outpath)
        if args.show:
            plt.show()
    return 0
