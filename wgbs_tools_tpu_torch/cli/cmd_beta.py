"""beta-centric commands of the port: beta_to_blocks and beta_to_table.

Port of wgbs_tools_tpu/cli/cmd_beta.py (:33-210; ref: src/python/
beta_to_blocks.py, beta_to_table.py), plus --device, and of its
`beta_cov_value` (:361), which mix_pat reads. The block sums run
in ops/reduceat.py::reduce_data_to_blocks: on cuda the block_sums kernel
(over every visible card's site shard when there are several), with
--device cpu its plain twin. Both write the JAX CLI's bytes.
"""

import argparse
import os.path as op
import sys

import numpy as np

from ..device import resolve_device, timed
from ..formats.beta import beta2vec, load_beta, trim_to_uint
from ..formats.blocks import is_block_file_nice, load_blocks
from ..ops.reduceat import reduce_data_to_blocks
from ..parallel.mesh import shard_devices
from ..utils import (
    IllegalArgumentError,
    delete_or_skip,
    logger,
    pretty_name,
    validate_file_list,
)

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
    from ..genome.region import GenomicRegion

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
