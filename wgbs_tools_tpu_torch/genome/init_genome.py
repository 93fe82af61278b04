"""Genome bootstrap: FASTA -> CpG-index reference directory.

The port's copy of wgbs_tools_tpu/genome/init_genome.py. It replaces the
reference's subprocess pipeline (samtools faidx | regex scan per chromosome
in a Pool, then bgzip+tabix — ref: src/python/init_genome.py) with
a single vectorized numpy scan and native BGZF output. Emits both:

- the native artifacts (`cpg_index.npz` + `cpg_index.json`) used by this
  framework, and
- the reference-compatible text artifacts (`CpG.bed.gz`, `chrome.size`,
  `CpG.chrome.size`, `rev.CpG.bed.gz` symlink) so external wgbstools
  installations can consume the same directory.
"""

import os
import os.path as op
import shutil

import numpy as np

from ..formats.bgzf import BgzfWriter
from ..utils import IllegalArgumentError, logger, mkdirp
from .cpg_index import build_from_fasta
from .refdir import references_root, set_default_ref

KNOWN_NR_SITES = {"mm9": 13120864, "hg19": 28217448}  # ref: init_genome.py:215-218

# UCSC download scheme the reference uses (ref: init_genome.py:60-92)
UCSC_FASTA_URL = "https://hgdownload.soe.ucsc.edu/goldenPath/{name}/bigZips/{name}.fa.gz"


def download_fasta(name, out_dir, url=None):
    """Seam for the reference's FASTA auto-download (ref: init_genome.py:
    60-92: curl/wget of UCSC goldenPath, gunzip, faidx).

    PERMANENT LIMITATION in this build environment: there is no network
    egress, so auto-download cannot work here by construction — this is the
    one reference feature that is environmentally infeasible rather than
    unimplemented. Deployments with egress can implement this seam (fetch
    `url or UCSC_FASTA_URL.format(name=name)` into out_dir, gunzip, return
    the path); everything downstream (init_genome) consumes a plain FASTA
    path and needs no change.
    """
    raise IllegalArgumentError(
        f"No --fasta_path given and FASTA auto-download is unavailable in "
        f"this environment (no network egress). Download "
        f"{url or UCSC_FASTA_URL.format(name=name)} yourself and pass it "
        "via --fasta_path."
    )


def init_genome(
    name,
    fasta_path,
    force=False,
    set_default=True,
    sort_chroms=True,
    write_compat_files=True,
    annotations=None,
    ilmn2cpg=None,
    blacklist=None,
    whitelist=None,
    blocks=None,
):
    if fasta_path is None or not op.isfile(fasta_path):
        raise IllegalArgumentError(f"Invalid reference FASTA: {fasta_path}")

    out_dir = op.join(references_root(), name)
    if op.isdir(out_dir):
        if not force:
            raise IllegalArgumentError(
                f"genome {name} already exists ({out_dir}). Use -f to overwrite."
            )
        shutil.rmtree(out_dir)
    mkdirp(out_dir)
    logger.info("init: scanning %s for CpG sites", fasta_path)

    index = build_from_fasta(fasta_path, name=name, sort_chroms=sort_chroms)
    if index.nr_sites == 0:
        raise IllegalArgumentError("No CpG sites found in FASTA")
    index.save(out_dir)
    logger.info("init: %d CpG sites on %d chromosomes", index.nr_sites, index.nr_chroms)

    expected = KNOWN_NR_SITES.get(name)
    if expected is not None and expected != index.nr_sites:
        logger.warning(
            "number of sites of genome %s is usually %d, but got %d",
            name,
            expected,
            index.nr_sites,
        )

    if write_compat_files:
        write_reference_compat_files(index, out_dir)

    # auxiliary reference files (user-supplied — ref: init_genome.py:189-210
    # links these from supplemental/ for hg19/hg38; no egress here)
    for src, dst, gz in [
        (annotations, "annotations.bed.gz", True),
        (ilmn2cpg, "ilmn2CpG.tsv.gz", True),
        (blacklist, "blacklist.bed", False),
        (whitelist, "whitelist.bed", False),
        (blocks, "blocks.bed.gz", True),
    ]:
        if src is None:
            continue
        if not op.isfile(src):
            raise IllegalArgumentError(f"Invalid file: {src}")
        _ingest_aux_file(src, op.join(out_dir, dst), gz)

    # keep a genome.fa link for tools that need raw sequence (bam2pat blueprint
    # mode, snp split)
    dst = op.join(out_dir, "genome.fa" + (".gz" if fasta_path.endswith(".gz") else ""))
    if not op.exists(dst):
        os.symlink(op.abspath(fasta_path), dst)

    if set_default:
        set_default_ref(name)
    return out_dir


def _ingest_aux_file(src, dst, want_gz):
    """Copy an auxiliary reference file into the refdir under its standard
    name, gzip-compressing (BGZF) when the standard name is .gz and the
    source is plain text."""
    import gzip as _gzip

    src_gz = False
    with open(src, "rb") as f:
        src_gz = f.read(2) == b"\x1f\x8b"
    if want_gz and not src_gz:
        with open(src, "rb") as f, BgzfWriter(dst) as w:
            shutil.copyfileobj(f, w)
    elif not want_gz and src_gz:
        with _gzip.open(src, "rb") as f, open(dst, "wb") as w:
            shutil.copyfileobj(f, w)
    else:
        shutil.copyfile(src, dst)
    logger.info("init: ingested %s -> %s", src, dst)


def write_reference_compat_files(index, out_dir):
    """Write CpG.bed.gz / chrome.size / CpG.chrome.size in the reference's
    exact column layout (ref: init_genome.py:151-179)."""
    dict_path = op.join(out_dir, "CpG.bed.gz")
    with BgzfWriter(dict_path) as w:
        site = 1
        for cid, chrom in enumerate(index.chrom_names):
            lo, hi = index.chrom_offsets[cid], index.chrom_offsets[cid + 1]
            loci = index.loci[lo:hi]
            sites = np.arange(site, site + loci.shape[0])
            # chrom \t locus \t site
            lines = "\n".join(
                f"{chrom}\t{l}\t{s}" for l, s in zip(loci.tolist(), sites.tolist())
            )
            if lines:
                w.write(lines + "\n")
            site += loci.shape[0]

    rev = op.join(out_dir, "rev.CpG.bed.gz")
    if not op.exists(rev):
        os.symlink("CpG.bed.gz", rev)

    with open(op.join(out_dir, "chrome.size"), "w") as f:
        for chrom, size in zip(index.chrom_names, index.chrom_sizes.tolist()):
            f.write(f"{chrom}\t{size}\n")

    with open(op.join(out_dir, "CpG.chrome.size"), "w") as f:
        for cid, chrom in enumerate(index.chrom_names):
            n = int(index.chrom_offsets[cid + 1] - index.chrom_offsets[cid])
            f.write(f"{chrom}\t{n}\n")
