"""init_genome / set_default_ref commands (ref: src/python/init_genome.py,
set_default_ref.py).

The port's copy of wgbs_tools_tpu/cli/cmd_genome.py. Host code: the CpG
scan is numpy, the CpG.bed.gz the port's BGZF writer. The port and the
JAX package write the same reference directory, byte for byte.
"""

import argparse

from ..genome.init_genome import init_genome
from ..genome.refdir import references_root, set_default_ref


def main_init_genome(argv):
    p = argparse.ArgumentParser(prog="init_genome",
                                description="Init genome reference.")
    p.add_argument("name", help="genome name (e.g. hg19)")
    p.add_argument("--fasta_path", default=None,
                   help="reference genome FASTA (.fa or .fa.gz). When "
                   "omitted, the UCSC auto-download seam is invoked "
                   "(unavailable in no-egress environments; see "
                   "genome.init_genome.download_fasta).")
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("--no_default", action="store_true")
    p.add_argument("--no_sort", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; the CpG scan is one vectorized pass)")
    # auxiliary reference files ingested into the refdir under their
    # standard names (the reference links these from its supplemental/ dir
    # for hg19/hg38 — ref: init_genome.py:189-210; with no egress, accept
    # user-supplied files for any genome)
    p.add_argument("--annotations",
                   help="annotation bed (chr start end type gene) -> "
                        "annotations.bed.gz")
    p.add_argument("--ilmn2cpg",
                   help="Illumina array map tsv (cgID<TAB>CpG index) -> "
                        "ilmn2CpG.tsv.gz")
    p.add_argument("--blacklist", help="blacklist bed -> blacklist.bed")
    p.add_argument("--whitelist", help="whitelist bed -> whitelist.bed")
    p.add_argument("--blocks", help="default blocks bed -> blocks.bed.gz")
    args = p.parse_args(argv)
    if args.debug:
        from ..utils import set_verbose

        set_verbose()
    if args.fasta_path is None:
        # the reference auto-downloads from UCSC here (init_genome.py:60-92)
        from ..genome.init_genome import download_fasta
        from ..genome.refdir import references_root
        import os.path as _op

        args.fasta_path = download_fasta(
            args.name, _op.join(references_root(), args.name))
    init_genome(
        args.name,
        args.fasta_path,
        force=args.force,
        set_default=not args.no_default,
        sort_chroms=not args.no_sort,
        annotations=args.annotations,
        ilmn2cpg=args.ilmn2cpg,
        blacklist=args.blacklist,
        whitelist=args.whitelist,
        blocks=args.blocks,
    )
    return 0


def main_set_default_ref(argv):
    p = argparse.ArgumentParser(prog="set_default_ref")
    g = p.add_mutually_exclusive_group(required=True)
    g.add_argument("name", nargs="?", help="genome name to set as default")
    g.add_argument("--name", dest="name_opt", default=None,
                   help="genome name to set as default")
    g.add_argument("-ls", "--list_refs", action="store_true")
    args = p.parse_args(argv)
    if args.list_refs:
        import os
        import os.path as op

        root = references_root()
        default = None
        link = op.join(root, "default")
        if op.islink(link):
            default = os.readlink(link)
        for d in sorted(os.listdir(root)):
            if d == "default" or not op.isdir(op.join(root, d)):
                continue
            mark = " *" if d == default else ""
            print(d + mark)
        return 0
    set_default_ref(args.name or args.name_opt)
    return 0
