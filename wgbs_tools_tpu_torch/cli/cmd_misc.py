"""pat2pairs and mbias_plot on the port (ref: src/python/pat2pairs.py,
mbias_plot.py).

Port of wgbs_tools_tpu/cli/cmd_misc.py. main_pat2pairs takes --device:
the pat streams slab by slab into a device-resident (sites, 4) int32
table (ops/pairs.py::StreamingPairs; on cuda the pair_counts kernel, with
--device cpu its plain twin), written once as uint32. mbias_plot (and
bam2pat --mbias) draws the m-bias tables with matplotlib, imported when
the plot is drawn. Both write the JAX CLI's bytes.
"""

import argparse
import os.path as op

import numpy as np

from ..device import resolve_device, timed
from ..formats.pat import iter_pat
from ..genome.refdir import Genome
from ..ops.pairs import StreamingPairs
from ..pipeline.pat2beta import stream_into
from ..utils import delete_or_skip, eprint, pretty_name, validate_single_file
from .cmd_beta import DEVICE_HELP


def main_pat2pairs(argv, timings=None):
    p = argparse.ArgumentParser(
        prog="pat2pairs",
        description="Adjacent-CpG pair counts (tt/tc/ct/cc) binary")
    p.add_argument("pat_paths", nargs="+")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--genome", default=None)
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the pair scan is one kernel launch per "
                        "slab)")
    p.add_argument("--device", default="cuda", help=DEVICE_HELP)
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    g = Genome(args.genome)

    for pat in args.pat_paths:
        validate_single_file(pat)
        out = op.join(args.out_dir, pretty_name(pat) + ".pairs")
        if not delete_or_skip(out, args.force):
            continue
        # streamed: pairs are intra-read, so per-chunk contributions are
        # purely additive (ref: stdin2pairs.cpp:59-97 streams stdin
        # likewise); host RSS stays O(chunk) instead of O(pat)
        sp = StreamingPairs((1, g.get_nr_sites() + 1), device, timings)
        stream_into(sp, iter_pat(pat), timings)
        table = sp.result()
        with timed(timings, "write", None):
            table.astype(np.uint32).tofile(out)
        eprint(f"[wt pat2pairs] wrote {out}")
    return 0


def main_mbias_plot(argv):
    p = argparse.ArgumentParser(
        prog="mbias_plot",
        description="Plot m-bias curves from bam2pat --mbias tables")
    p.add_argument("mbias_tables", nargs=2, help="<prefix>.OT.txt and .OB.txt")
    p.add_argument("-o", "--out_dir", default=".")
    p.add_argument("-PE", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    args = p.parse_args(argv)
    plot_mbias(args.mbias_tables, args.out_dir, args.PE)
    return 0


def plot_mbias(mtables, out_dir, PE=True):
    """Meth fraction + coverage vs read position, OT/OB x read1/read2
    (ref: src/python/mbias_plot.py:38-82)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    mtables = list(mtables)
    if mtables[0].endswith(".OT.txt"):
        mtables.reverse()  # OB first, OT second

    def load(path):
        data = np.loadtxt(path, skiprows=1)
        out = []
        for rn, cols in ((1, (0, 1)), (2, (2, 3))):
            m, u = data[:, cols[0]], data[:, cols[1]]
            n = m + u
            with np.errstate(invalid="ignore", divide="ignore"):
                meth = m / n
            cov_thresh = np.nanmedian(n[:50]) / 10 if n[:50].size else 0
            meth = np.where(n < cov_thresh, np.nan, meth)
            nshow = np.where(n < cov_thresh, np.nan, n)
            out.append((rn, meth, nshow))
        return out

    tabs = [load(m) for m in mtables]
    fig, axes = plt.subplots(2, 2, figsize=(10, 10))
    titles = ["OT / CTOT" if PE else "OB", "OB / CTOB" if PE else "OT"]
    for col, series in enumerate(tabs):
        for rn, meth, n in series:
            if not PE and rn == 2:
                continue
            label = f"read #{rn}" if PE else None
            x = np.arange(1, meth.shape[0] + 1)
            axes[0][col].plot(x, meth, label=label)
            axes[1][col].plot(x, n, label=label)
        axes[0][col].set_title(titles[col])
        axes[0][col].set_ylim(0, 1)
        if PE:
            axes[0][col].legend()
    axes[0][0].set_ylabel("Average methylation")
    axes[1][0].set_ylabel("Number of observations")
    name = op.basename(mtables[0])
    for suff in (".mbias.OB.txt", ".mbias.OT.txt", ".OB.txt", ".OT.txt"):
        if name.endswith(suff):
            name = name[: -len(suff)]
            break
    fig.suptitle(f"{name}: Methylation Bias")
    outpath = op.join(out_dir, name) + ".mbias.pdf"
    fig.savefig(outpath)
    eprint(f"[wt mbias] dumped figure to {outpath}")
    return outpath
