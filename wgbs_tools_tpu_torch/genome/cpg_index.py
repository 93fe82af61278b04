"""CpGIndex: the genome's CpG dictionary as flat arrays.

The port's copy of wgbs_tools_tpu/genome/cpg_index.py's `CpGIndex` (with
`save` and `load`), with the same names: `loci[int32 N]` (1-based position
of the C of each CG dinucleotide) and `chrom_offsets[int64 C+1]`, so every
locus <-> site translation is a `searchsorted`. Site indices are 1-based
(1..NR_SITES) at the API surface, matching the pat format. `read_fasta`
reads a FASTA as bam2pat --blueprint does.
"""

import gzip
import json
import os.path as op

import numpy as np

from ..utils import IllegalArgumentError

INDEX_BASENAME = "cpg_index.npz"
META_BASENAME = "cpg_index.json"


class CpGIndex:
    """In-memory CpG dictionary for one genome build."""

    def __init__(self, loci, chrom_offsets, chrom_names, chrom_sizes, name="genome"):
        self.loci = np.asarray(loci, dtype=np.int32)
        self.chrom_offsets = np.asarray(chrom_offsets, dtype=np.int64)
        self.chrom_names = list(chrom_names)
        self.chrom_sizes = np.asarray(chrom_sizes, dtype=np.int64)
        self.name = name
        if len(self.chrom_offsets) != len(self.chrom_names) + 1:
            raise IllegalArgumentError("chrom_offsets must have len(chroms)+1 entries")
        self._chrom_lookup = {c: i for i, c in enumerate(self.chrom_names)}

    # ---------------- basic facts ----------------

    @property
    def nr_sites(self) -> int:
        return int(self.loci.shape[0])

    @property
    def nr_chroms(self) -> int:
        return len(self.chrom_names)

    def chrom_id(self, chrom: str) -> int:
        if chrom not in self._chrom_lookup:
            raise IllegalArgumentError(f"Unknown chromosome: {chrom}")
        return self._chrom_lookup[chrom]

    def chrom_size(self, chrom: str) -> int:
        return int(self.chrom_sizes[self.chrom_id(chrom)])

    def chrom_nr_sites(self, chrom: str) -> int:
        cid = self.chrom_id(chrom)
        return int(self.chrom_offsets[cid + 1] - self.chrom_offsets[cid])

    def chrom_site_bounds(self, chrom: str):
        """1-based [start, end) site range of a chromosome."""
        cid = self.chrom_id(chrom)
        return (
            int(self.chrom_offsets[cid]) + 1,
            int(self.chrom_offsets[cid + 1]) + 1,
        )

    def chrom_loci(self, chrom: str) -> np.ndarray:
        cid = self.chrom_id(chrom)
        return self.loci[self.chrom_offsets[cid] : self.chrom_offsets[cid + 1]]

    # ---------------- translations ----------------

    def site2chrom_id(self, site) -> np.ndarray:
        """1-based site index -> chromosome id (vectorized).

        Mirrors index2chrom's cumsum+searchsorted (ref: genomic_region.py:10-12).
        """
        site = np.asarray(site, dtype=np.int64)
        return np.searchsorted(self.chrom_offsets[1:], site - 1, side="right")

    def site2locus(self, site):
        """1-based site -> (chrom, 1-based locus of the C)."""
        site = int(site)
        if not 1 <= site <= self.nr_sites:
            raise IllegalArgumentError(f"Out of range site index: {site}")
        cid = int(self.site2chrom_id(site))
        return self.chrom_names[cid], int(self.loci[site - 1])

    def locus2site(self, chrom: str, locus: int) -> int:
        """First 1-based site with locus >= `locus` on `chrom` (global index)."""
        cid = self.chrom_id(chrom)
        lo, hi = self.chrom_offsets[cid], self.chrom_offsets[cid + 1]
        i = np.searchsorted(self.loci[lo:hi], locus, side="left")
        return int(lo + i) + 1

    def region2sites(self, chrom: str, bp_from: int, bp_to: int):
        """bp region [from, to] -> 1-based site range [s1, s2).

        Matches the reference's awk-over-tabix rule
        (ref: genomic_region.py:141-161): a site whose locus equals the
        region end is NOT included; raises if the region holds no CpGs.
        """
        cid = self.chrom_id(chrom)
        lo, hi = self.chrom_offsets[cid], self.chrom_offsets[cid + 1]
        sub = self.loci[lo:hi]
        s1 = int(lo + np.searchsorted(sub, bp_from, side="left")) + 1
        s2 = int(lo + np.searchsorted(sub, bp_to, side="left")) + 1
        if s2 <= s1 or s1 > int(hi):
            raise IllegalArgumentError(
                f"Invalid genomic region: {chrom}:{bp_from}-{bp_to}. No CpGs in range"
            )
        return s1, s2

    # ---------------- persistence ----------------

    def save(self, refdir):
        np.savez_compressed(
            op.join(refdir, INDEX_BASENAME),
            loci=self.loci,
            chrom_offsets=self.chrom_offsets,
            chrom_sizes=self.chrom_sizes,
        )
        with open(op.join(refdir, META_BASENAME), "w") as f:
            json.dump(
                {"name": self.name, "chroms": self.chrom_names,
                 "nr_sites": self.nr_sites},
                f,
                indent=1,
            )

    @classmethod
    def load(cls, refdir, name=None):
        npz_path = op.join(refdir, INDEX_BASENAME)
        meta_path = op.join(refdir, META_BASENAME)
        if not (op.isfile(npz_path) and op.isfile(meta_path)):
            raise IllegalArgumentError(f"Not an initialized genome dir: {refdir}")
        with open(meta_path) as f:
            meta = json.load(f)
        z = np.load(npz_path)
        return cls(
            z["loci"],
            z["chrom_offsets"],
            meta["chroms"],
            z["chrom_sizes"],
            name=name or meta.get("name", "genome"),
        )


def read_fasta(path):
    """Parse a FASTA (.fa or .fa.gz) into an ordered {chrom: uint8 seq array}."""
    opener = gzip.open if path.endswith(".gz") else open
    chroms = {}
    name = None
    parts = []
    with opener(path, "rb") as f:
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    chroms[name] = _concat_seq(parts)
                name = line[1:].split()[0].decode()
                parts = []
            else:
                parts.append(line.rstrip())
    if name is not None:
        chroms[name] = _concat_seq(parts)
    return chroms


def _concat_seq(parts):
    seq = np.frombuffer(b"".join(parts), dtype=np.uint8).copy()
    # uppercase in place: 'a'..'z' -> 'A'..'Z'
    lower = (seq >= 97) & (seq <= 122)
    seq[lower] -= 32
    return seq


def find_cpg_loci(seq: np.ndarray) -> np.ndarray:
    """1-based positions of the C of each CG dinucleotide (vectorized scan)."""
    if seq.shape[0] < 2:
        return np.empty(0, dtype=np.int32)
    hits = (seq[:-1] == ord("C")) & (seq[1:] == ord("G"))
    return (np.nonzero(hits)[0] + 1).astype(np.int32)


def build_from_fasta(fasta_path, name="genome", chrom_filter=None, sort_chroms=True):
    """Scan a FASTA and build a CpGIndex.

    `chrom_filter`/`sort_chroms` mirror the reference's chromosome validation
    and ordering (ref: init_genome.py:263-281): keep chr1..chrN/X/Y/M style
    names, order numerically then X, Y, M.
    """
    seqs = read_fasta(fasta_path)
    names = list(seqs.keys())
    if chrom_filter is None:
        chrom_filter = is_valid_chrom
    names = [c for c in names if chrom_filter(c)]
    if sort_chroms:
        names = sorted(names, key=chromosome_order)
    loci_parts = []
    offsets = [0]
    sizes = []
    for c in names:
        loci_c = find_cpg_loci(seqs[c])
        loci_parts.append(loci_c)
        offsets.append(offsets[-1] + loci_c.shape[0])
        sizes.append(seqs[c].shape[0])
    loci = (
        np.concatenate(loci_parts) if loci_parts else np.empty(0, dtype=np.int32)
    )
    return CpGIndex(loci, np.asarray(offsets), names, np.asarray(sizes), name=name)


def chromosome_order(c):
    """chr1 < chr2 < ... < chrX < chrY < chrM (ref: init_genome.py:263-275)."""
    if c.startswith("chr"):
        c = c[3:]
    if c.isdigit():
        return int(c)
    return {"X": 10000, "Y": 10001, "M": 10002, "MT": 10002}.get(c, 10003)


def is_valid_chrom(chrom):
    """chrN / N / X / Y / M / MT names only (ref: init_genome.py:278-281)."""
    import re

    return bool(re.match(r"^(chr)?([\d]+|[XYM]|(MT))$", chrom))
