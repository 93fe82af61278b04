"""homog on the port: per-block U/X/M read counting
(ref: src/python/homog.py).

Port of wgbs_tools_tpu/cli/cmd_homog.py, plus --device. The JAX CLI counts
on the host (homog_counts' default backend "numpy"); here the counts run
on cuda in the homog_bins kernel, or with --device cpu in its plain twin
(ops/frag_ops.py). Both write the JAX CLI's bytes.
"""

import argparse
import os.path as op

import numpy as np

from ..device import resolve_device, timed
from ..formats.bgzf import BgzfWriter
from ..formats.blocks import load_blocks
from ..pipeline.pat_stream import homog_pat_streaming
from ..utils import (
    IllegalArgumentError,
    delete_or_skip,
    logger,
    mkdirp,
    pretty_name,
    validate_file_list,
)
from .cmd_beta import DEVICE_HELP

WRITE_ROWS = 1 << 16  # text rows per write


def trim_uxm_to_uint(data, nr_bits=8):
    """Row-wise saturation by the row max (ref: homog.py:48-58)."""
    dtype = np.uint16 if nr_bits == 16 else np.uint8
    max_val = 2**nr_bits - 1
    data = np.array(data, dtype=np.float64, copy=True)
    big = data.max(axis=1) > max_val
    if big.any():
        data[big, :] = data[big, :] / data.max(axis=1)[big][:, None] * max_val
    return data.astype(dtype)


def homog_pat(pat_path, blocks, ranges, min_len=3, inclusive=False,
              device="cuda", timings=None):
    """Counts (B, nbins) for one pat file over (possibly unsorted) blocks.

    Streams the pat in bounded-memory chunks: per-fragment block counts are
    additive, so chunk sums are bit-identical to a whole-file pass (the
    analogue of the reference's sliding block deque over the pat stream,
    ref: src/homog/homog.cpp:58-145)."""
    bstart = blocks["startCpG"]
    bend = blocks["endCpG"]
    if (bstart < 0).any():
        raise IllegalArgumentError("Some blocks are empty (NA)")
    order = np.argsort(bstart, kind="stable")
    inv = np.argsort(order, kind="stable")
    counts = homog_pat_streaming(pat_path, bstart[order], bend[order],
                                 ranges, min_len=min_len,
                                 inclusive=inclusive, device=device,
                                 timings=timings)
    return counts[inv]


def main(argv, timings=None):
    p = argparse.ArgumentParser(
        prog="homog",
        description="Count U/X/M reads per block per pat file")
    p.add_argument("input_files", nargs="+")
    p.add_argument("-b", "--blocks_file", required=True)
    g1 = p.add_mutually_exclusive_group()
    g1.add_argument("-o", "--out_dir", default=".")
    g1.add_argument("-p", "--prefix")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--inclusive", action="store_true")
    p.add_argument("--binary", action="store_true")
    p.add_argument("--genome", default=None)
    p.add_argument("--nr_bits", type=int, default=8)
    p.add_argument("-t", "--thresholds",
                   help='UXM thresholds "LOW,HIGH", e.g. "0.3334,0.666"')
    p.add_argument("-l", "--rlen", type=int, default=3,
                   help="minimal read length in CpGs [3]")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; counting is one kernel launch per slab)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    device = resolve_device(args.device)

    if args.nr_bits not in (8, 16):
        raise IllegalArgumentError("nr_bits must be in {8, 16}")
    if args.rlen < 2:
        raise IllegalArgumentError("rlen must be >= 2")
    # default thresholds derived from rlen (ref: homog.py:96-104)
    if args.thresholds:
        th = args.thresholds.split(",")
        if len(th) != 2:
            raise IllegalArgumentError("Invalid thresholds")
        t1, t2 = float(th[0]), float(th[1])
        if not 1 > t2 > t1 > 0:
            raise IllegalArgumentError("Invalid thresholds")
        ranges = [0.0, t1, t2, 1.0]
    elif args.rlen == 2:
        raise IllegalArgumentError("for rlen==2, --thresholds must be specified")
    else:
        l = args.rlen
        t1 = round(1 - (l - 1) / l, 3) + 0.001
        t2 = round((l - 1) / l, 3)
        ranges = [0.0, t1, t2, 1.0]

    pats = args.input_files
    validate_file_list(pats, ".pat.gz")
    outdir = args.out_dir
    prefix = args.prefix
    if prefix is not None:
        outdir = op.dirname(prefix) or "."
    mkdirp(outdir)

    blocks = load_blocks(args.blocks_file)
    for pat in sorted(pats):
        name = pretty_name(pat)
        pfx = prefix if prefix else op.join(outdir, name)
        opath = pfx + ".uxm" + ("" if args.binary else ".bed.gz")
        if not delete_or_skip(opath, args.force):
            continue
        counts = homog_pat(pat, blocks, ranges, min_len=args.rlen,
                           inclusive=args.inclusive, device=device,
                           timings=timings)
        if counts.sum() == 0:
            logger.warning("[ %s ] all zeros!", name)
        with timed(timings, "write", None):
            if args.binary:
                trim_uxm_to_uint(counts, args.nr_bits).tofile(opath)
            else:
                # one write per WRITE_ROWS rows: BgzfWriter cuts its
                # blocks by size, not by write, so the bytes are those of
                # the JAX CLI's row-by-row writes
                with BgzfWriter(opath) as w:
                    for lo in range(0, counts.shape[0], WRITE_ROWS):
                        w.write("".join(
                            f"{blocks['chr'][i]}\t{blocks['start'][i]}\t"
                            f"{blocks['end'][i]}\t{blocks['startCpG'][i]}\t"
                            f"{blocks['endCpG'][i]}\t"
                            + "\t".join(str(int(x)) for x in counts[i])
                            + "\n"
                            for i in range(lo, min(lo + WRITE_ROWS,
                                                   counts.shape[0]))))
        logger.info("homog: %s", opath)
    return 0
