"""convert command: genomic region <-> CpG index range, bed <-> CpG columns
(ref: src/python/convert.py).

The port's copy of wgbs_tools_tpu/cli/cmd_convert.py: host code, with the
genome's annotations (genome/annotations.py) and Illumina ids
(genome/region.py::GenomicRegion.parse_array_id).
"""

import argparse
import gzip
import sys

import numpy as np

from ..genome.refdir import Genome
from ..genome.region import GenomicRegion
from ..utils import IllegalArgumentError, delete_or_skip
from .main import add_gr_args


def bed_to_cpg_columns(rows, index):
    """Insert startCpG/endCpG as columns 4-5 of a bed table.

    Exact merge_asof semantics (ref: convert.py:147-185): startCpG = first
    site with locus >= start; endCpG = first site with locus >= end, +1 when
    a site sits exactly at `end`; regions without CpGs -> NA.
    """
    out = []
    for chrom, start, end, extra in rows:
        if chrom not in index._chrom_lookup:
            out.append((chrom, start, end, None, None, extra))
            continue
        cid = index.chrom_id(chrom)
        lo, hi = index.chrom_offsets[cid], index.chrom_offsets[cid + 1]
        sub = index.loci[lo:hi]
        si = np.searchsorted(sub, start, side="left")
        ei = np.searchsorted(sub, end, side="left")
        s_cpg = int(lo + si) + 1 if si < sub.shape[0] else None
        if ei < sub.shape[0]:
            e_cpg = int(lo + ei) + 1
            if int(sub[ei]) == end:
                e_cpg += 1
        else:
            e_cpg = int(hi) + 1
        if s_cpg is None or e_cpg - s_cpg <= 0:
            s_cpg = e_cpg = None
        out.append((chrom, start, end, s_cpg, e_cpg, extra))
    return out


def load_bed_rows(path):
    opener = gzip.open if path.endswith(".gz") else open
    rows = []
    with opener(path, "rb") as f:
        for line in f:
            line = line.rstrip(b"\n")
            if not line or line.startswith(b"#"):
                continue
            tokens = line.split(b"\t")
            if len(tokens) < 3 or not tokens[1].isdigit():
                continue
            extra = b"\t".join(tokens[3:]).decode() if len(tokens) > 3 else ""
            rows.append((tokens[0].decode(), int(tokens[1]), int(tokens[2]),
                         extra))
    return rows


def main(argv):
    p = argparse.ArgumentParser(
        prog="convert",
        description="Convert genomic region to CpG index range and vice versa")
    add_gr_args(p, bed_file=True, no_anno=True)
    p.add_argument("--site_file",
                   help="file with lines 'startCpG[\\tendCpG]' to annotate "
                        "with loci")
    p.add_argument("--drop_empty", action="store_true")
    p.add_argument("--parsable", "-p", action="store_true")
    p.add_argument("-o", "--out_path", default=None)
    p.add_argument("-f", "--force", action="store_true")
    p.add_argument("-d", "--debug", action="store_true")
    p.add_argument("-@", "--threads", type=int, default=None,
                   help="(compat; conversions are vectorized searchsorted)")
    args = p.parse_args(argv)
    g = Genome(args.genome)

    if args.bed_file:
        rows = load_bed_rows(args.bed_file)
        res = bed_to_cpg_columns(rows, g.index)
        # annotation columns (type, gene) unless --no_anno/--parsable
        # (ref: convert.py:60,126-128,257-273)
        annos = None
        if not (args.no_anno or args.parsable):
            from ..genome.annotations import annotate_rows

            annos = annotate_rows([(c, s, e) for c, s, e, _ in rows], g)
        out = open(args.out_path, "w") if args.out_path else sys.stdout
        for i, (chrom, start, end, s_cpg, e_cpg, extra) in enumerate(res):
            if s_cpg is None and args.drop_empty:
                continue
            s_str = "NA" if s_cpg is None else str(s_cpg)
            e_str = "NA" if e_cpg is None else str(e_cpg)
            line = f"{chrom}\t{start}\t{end}\t{s_str}\t{e_str}"
            if extra:
                line += "\t" + extra
            if annos is not None:
                line += f"\t{annos[i][0]}\t{annos[i][1]}"
            out.write(line + "\n")
        if args.out_path:
            out.close()
        return 0

    if args.site_file:
        out_path = args.out_path
        if out_path is not None and not delete_or_skip(out_path, args.force):
            return 0
        from ..formats.blocks import sites_blocks

        sites = []
        with open(args.site_file) as f:
            for line in f:
                tokens = line.split()
                if not tokens:
                    continue
                s = int(tokens[0])
                e = int(tokens[1]) if len(tokens) > 1 else s + 1
                sites.append((s, e))
        blocks = sites_blocks(g.index, sites)
        out = open(out_path, "w") if out_path else sys.stdout
        for i in range(len(sites)):
            out.write(
                f"{blocks['chr'][i]}\t{blocks['start'][i]}\t{blocks['end'][i]}"
                f"\t{blocks['startCpG'][i]}\t{blocks['endCpG'][i]}\n"
            )
        if out_path:
            out.close()
        return 0

    if not (args.region or args.sites or args.array_id):
        raise IllegalArgumentError("specify -r, -s, --array_id, -L or --site_file")
    gr = GenomicRegion(region=args.region, sites=args.sites,
                       array_id=args.array_id, genome=g,
                       no_anno=args.no_anno or args.parsable)
    if args.parsable:
        # sites / array_id inputs translate to a region; regions to sites
        print(gr.region_str if (args.sites or args.array_id)
              else "{}-{}".format(*gr.sites))
    else:
        print(gr)
    return 0
