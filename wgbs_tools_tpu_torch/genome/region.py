"""GenomicRegion: parse `-r chr:start-end` / `-s siteA-siteB` and translate
between genomic loci and CpG-site indices.

The port's copy of wgbs_tools_tpu/genome/region.py's `GenomicRegion`
(same semantics as the reference, ref: src/python/genomic_region.py),
against the in-memory CpGIndex, with Illumina array ids (`array_id`, through
the genome's ilmn2CpG.tsv.gz) and the genome's annotation lines under the
region line unless `no_anno` (`genome/annotations.py`).
"""

import re

from ..utils import IllegalArgumentError
from .refdir import Genome


class GenomicRegion:
    def __init__(self, region=None, sites=None, genome_name=None, genome=None,
                 array_id=None, no_anno=True):
        self.genome = genome if genome is not None else Genome(genome_name)
        self.genome_name = self.genome.name
        self.chrom = None
        self.sites = None
        self.region_str = None
        self.bp_tuple = None
        self.no_anno = no_anno
        self._annotation = None

        if region is not None:
            self.parse_region(region)
        elif sites is not None:
            self.parse_sites(sites)
        elif array_id is not None:
            self.parse_array_id(array_id)
        # else: whole genome

        self.nr_sites = None if self.sites is None else self.sites[1] - self.sites[0]

    # ------------------------------------------------------------------

    def is_whole(self):
        return self.sites is None

    def parse_sites(self, sites_str):
        s1, s2 = self._sites_str_to_tuple(sites_str)
        idx = self.genome.index
        self.chrom, region_from = idx.site2locus(s1)
        chrom2, region_to = idx.site2locus(s2 - 1)
        region_to += 1  # include both bases of the last CG (ref: genomic_region.py:80-81)
        if self.chrom != chrom2:
            raise IllegalArgumentError(f"sites range cross chromosomes! ({s1}, {s2})")
        self.sites = (s1, s2)
        self.region_str = f"{self.chrom}:{region_from}-{region_to}"
        self.bp_tuple = (region_from, region_to)

    def parse_region(self, region):
        region = region.replace(",", "")
        idx = self.genome.index

        # whole chromosome
        if re.match(r"^(chr)?([\d]+|[XYM]|(MT))$", region):
            if region not in self.genome.get_chroms():
                raise IllegalArgumentError(f"Unknown chromosome: {region}")
            self.chrom = region
            region_from, region_to = 1, idx.chrom_size(region)
            self.region_str = region
        else:
            # chr:from (single locus) -> chr:from-(from+1)
            m = re.match(r"^(chr)?([\d]+|[XYM]|(MT)):([\d]+)$", region)
            if m:
                region += f"-{int(m.group(4)) + 1}"
            m = re.match(r"^((chr)?([\d]+|[XYM]|(MT))):([\d]+)-([\d]+)$", region)
            if not m:
                raise IllegalArgumentError(f"Invalid genomic region: {region}")
            self.chrom = m.group(1)
            if self.chrom not in self.genome.get_chroms():
                raise IllegalArgumentError(f"Unknown chromosome: {region}")
            region_from, region_to = int(m.group(5)), int(m.group(6))
            if region_to <= region_from:
                raise IllegalArgumentError(
                    f"Invalid genomic region: {region}. end before start"
                )
            if region_to > idx.chrom_size(self.chrom) or region_from < 1:
                raise IllegalArgumentError(
                    f"Invalid genomic region: {region}. Out of range"
                )
            self.region_str = region

        self.bp_tuple = (region_from, region_to)
        self.sites = idx.region2sites(self.chrom, region_from, region_to)

    def parse_array_id(self, array_id):
        """Illumina array id (e.g. cg00001755) -> single site
        (ref: genomic_region.py:212-232)."""
        if not (array_id.startswith("cg") and len(array_id) > 2 and array_id[2:].isdigit()):
            raise IllegalArgumentError(f"Invalid Illumina array id: {array_id}")
        idict = self.genome.ilmn2cpg_dict
        if idict is None:
            raise IllegalArgumentError("Could not find Illumina map file")
        import gzip

        with gzip.open(idict, "rt") as f:
            for line in f:
                tokens = line.rstrip("\n").split("\t")
                if tokens and tokens[0] == array_id:
                    self.parse_sites(tokens[1])
                    return
        raise IllegalArgumentError(f"array id {array_id} not found in {idict}")

    def _sites_str_to_tuple(self, sites_str):
        if isinstance(sites_str, (tuple, list)):
            site1, site2 = int(sites_str[0]), int(sites_str[1])
        else:
            if not sites_str:
                raise IllegalArgumentError(f"Empty sites string: {sites_str}")
            sites_str = str(sites_str).replace(",", "")
            m = re.match(r"([\d]+)-([\d]+)", sites_str)
            if m:
                site1, site2 = int(m.group(1)), int(m.group(2))
            elif "-" not in sites_str and sites_str.isdigit():
                site1 = int(sites_str)
                site2 = site1 + 1
            else:
                raise IllegalArgumentError(
                    f'sites must be of format: "start-end" or "site". Got: {sites_str}'
                )
        nr = self.genome.get_nr_sites()
        if not (nr + 1 >= site2 >= site1 >= 1):
            raise IllegalArgumentError(
                f"sites violate the constraints: {nr + 1} >= {site2} > {site1} >= 1"
            )
        if site1 == site2:
            site2 += 1
        return site1, site2

    @property
    def annotation(self):
        """Annotation lines for the region, or '' (ref:
        genomic_region.py:58-70 — fetched unless no_anno/whole-genome)."""
        if self.no_anno or self.is_whole():
            return ""
        if self._annotation is None:
            from .annotations import region_annotation

            self._annotation = region_annotation(
                self.genome, self.chrom, self.bp_tuple[0], self.bp_tuple[1])
        return self._annotation

    def __str__(self):
        if self.sites is None:
            return "Whole genome"
        s1, s2 = self.sites
        nr_bp = self.bp_tuple[1] - self.bp_tuple[0] + 1
        res = f"{self.region_str} - {nr_bp:,}bp, {s2 - s1:,}CpGs: {s1}-{s2}"
        if self.annotation:
            res += "\n" + self.annotation
        return res
