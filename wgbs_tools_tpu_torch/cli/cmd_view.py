"""view / cview commands (ref: src/python/view.py, cview.py): the port's
copy of wgbs_tools_tpu/cli/cmd_view.py. Host code (numpy); no --device.
"""

import argparse
import os.path as op
import sys

import numpy as np

from ..formats.beta import load_beta
from ..genome.refdir import Genome
from ..utils import IllegalArgumentError, validate_single_file
from .main import add_gr_args, add_view_args
from .view import print_frags, view_beta_text


def _parse(argv, prog):
    p = argparse.ArgumentParser(prog=prog)
    p.add_argument("input_file")
    add_gr_args(p, bed_file=True)
    add_view_args(p)  # provides --shuffle and -np/--nanopore too
    return p.parse_args(argv)


def main(argv):
    args = _parse(argv, "view")
    validate_single_file(args.input_file)
    genome = Genome(args.genome)
    suff = op.splitext(args.input_file)[1]
    if suff in (".beta", ".lbeta"):
        out = open(args.out_path, "w") if args.out_path else sys.stdout
        try:
            view_beta_text(args.input_file, genome, region=args.region,
                           sites=args.sites, bed_file=args.bed_file, out=out)
        finally:
            if args.out_path:
                out.close()
        return 0
    if suff == ".bin":
        data = load_beta(args.input_file)
        np.savetxt(sys.stdout, data, fmt="%s", delimiter="\t")
        return 0
    if args.input_file.endswith((".pat.gz", ".pat")):
        return main_cview(argv)
    raise IllegalArgumentError(f"Unknown input format: {args.input_file}")


def main_cview(argv):
    args = _parse(argv, "cview")
    genome = Genome(args.genome)
    # streamed in bounded-memory chunks: a whole-genome `view` of a 30x pat
    # never holds the full file (the reference pipes gunzip|cview likewise,
    # ref: cview.py:25-52); region reads are one index-bounded batch
    from ..formats.pat import frags_to_bytes
    from ..pipeline.pat_stream import SortedStreamEmitter, iter_view_pat

    shuffle = getattr(args, "shuffle", False)
    out = args.out_path if args.out_path else sys.stdout
    sink_close = None
    if isinstance(out, str) and out.endswith(".gz"):
        from ..formats.bgzf import BgzfWriter

        w = BgzfWriter(out)
        write_frags, sink_close = (lambda fr: w.write(frags_to_bytes(fr))), \
            w.close
    elif isinstance(out, str):
        fh = open(out, "wb")
        write_frags, sink_close = (lambda fr: fh.write(frags_to_bytes(fr))), \
            fh.close
    else:
        def write_frags(fr):
            print_frags(fr, out)

    def emit(fr):
        if fr.nr_frags == 0:
            return
        if shuffle:
            from .view import _shuffle_within_start

            fr = _shuffle_within_start(fr, args.seed)
        write_frags(fr)

    chunks = iter_view_pat(
        args.input_file, genome, region=args.region, sites=args.sites,
        bed_file=getattr(args, "bed_file", None), strict=args.strict,
        strip=args.strip, min_len=args.min_len, no_gaps=args.no_gaps,
        sub_sample=args.sub_sample, seed=args.seed,
        # extra pat columns pass through, like the reference cview's
        # whole-line processing (the pre-streaming view_pat kept them too)
        keep_extras=True)
    try:
        if args.no_sort:
            for fr, _wm in chunks:
                emit(fr)
        else:
            em = SortedStreamEmitter(emit)
            for fr, wm in chunks:
                em.push(fr, wm)
            em.close()
    finally:
        if sink_close is not None:
            sink_close()
    return 0
