"""Genome annotation queries (annotations.bed.gz).

The port's copy of wgbs_tools_tpu/genome/annotations.py.

The reference resolves annotations by shelling to tabix / bedtools
(ref: src/python/genomic_region.py:58-70, convert.py:257-273); here the
annotation bed is loaded once into sorted numpy interval arrays per
chromosome and queried with searchsorted overlap tests.

Annotation file format (as linked by the reference's init_genome from
supplemental/hg19.annotations.bed.gz): BED3 + `type` + `gene` columns.
"""

import gzip

import numpy as np

_CACHE = {}


def load_annotations(path):
    """-> {chrom: (starts0 int64[], ends0 int64[], extras list[str])} with
    intervals sorted by start (0-based half-open, standard BED)."""
    if path in _CACHE:
        return _CACHE[path]
    per = {}
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line or line.startswith("#"):
                continue
            t = line.split("\t")
            if len(t) < 3:
                continue
            per.setdefault(t[0], []).append(
                (int(t[1]), int(t[2]), "\t".join(t[3:])))
    out = {}
    for chrom, rows in per.items():
        rows.sort()
        out[chrom] = (
            np.array([r[0] for r in rows], dtype=np.int64),
            np.array([r[1] for r in rows], dtype=np.int64),
            [r[2] for r in rows],
        )
    _CACHE[path] = out
    return out


def _overlapping(anno, chrom, bp_from, bp_to):
    """Indices of annotation rows overlapping the 1-based region
    [bp_from, bp_to] (tabix semantics on a 0-based bed)."""
    iv = anno.get(chrom)
    if iv is None:
        return None, []
    starts, ends, extras = iv
    ends_max = np.maximum.accumulate(ends)
    i0 = int(np.searchsorted(ends_max, bp_from - 1, side="right"))
    hits = [i for i in range(i0, starts.shape[0])
            if starts[i] < bp_to and ends[i] > bp_from - 1]
    return iv, hits


def region_annotation(genome, chrom, bp_from, bp_to):
    """The reference's GenomicRegion annotation fetch: overlapping rows'
    columns 4+ with consecutive duplicates removed, newline-joined
    (ref: genomic_region.py:58-70 — `tabix | cut -f4- | uniq`).
    Returns '' when no annotation file / no overlap."""
    path = genome.annotations
    if path is None:
        return ""
    anno = load_annotations(path)
    iv, hits = _overlapping(anno, chrom, bp_from, bp_to)
    lines = []
    for i in hits:
        val = iv[2][i]
        if not lines or lines[-1] != val:
            lines.append(val)
    return "\n".join(lines)


def annotate_rows(rows, genome):
    """Per (chrom, start0, end0) bed row: (type, gene) aggregated over
    overlapping annotation intervals — distinct values in order of first
    appearance, comma-joined, '.' when none (ref: convert.py:257-273,
    `bedtools intersect -wao | merge -c 7,8 -o distinct`)."""
    path = genome.annotations
    if path is None:
        return None
    anno = load_annotations(path)
    out = []
    for chrom, start0, end0 in rows:
        iv, hits = _overlapping(anno, chrom, start0 + 1, end0)
        types, genes = [], []
        for i in hits:
            t = iv[2][i].split("\t")
            ty = t[0] if t else "."
            ge = t[1] if len(t) > 1 else "."
            if ty not in types:
                types.append(ty)
            if ge not in genes:
                genes.append(ge)
        out.append((",".join(types) if types else ".",
                    ",".join(genes) if genes else "."))
    return out
