"""pat2pairs on the port (ref: src/python/pat2pairs.py).

Port of wgbs_tools_tpu/cli/cmd_misc.py::main_pat2pairs (:13-41), plus
--device: the pat streams slab by slab into a device-resident (sites, 4)
int32 table (ops/pairs.py::StreamingPairs; on cuda the pair_counts
kernel, with --device cpu its plain twin), written once as uint32. Both
write the JAX CLI's bytes.
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
