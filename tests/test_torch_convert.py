"""The port's convert (cli/cmd_convert.py over genome/region.py and
genome/annotations.py) against the JAX CLI, byte for byte: a region, a
sites range and an Illumina id, each parsed and printed (with the genome's
annotation lines, and with --no_anno / --parsable), a bed given its CpG
columns (with the annotation columns, --drop_empty, --parsable), and a
site file given its loci. The genome is the mini genome of
tests/conftest.py with an annotation bed and an Illumina map made here."""

import gzip
import os

import numpy as np
import pytest

GENOME = "mini_anno_convert"


@pytest.fixture(scope="module")
def data(mini_genome, tmp_path_factory):
    d = tmp_path_factory.mktemp("convert")
    anno_genome = os.path.join(os.path.dirname(mini_genome.refdir), GENOME)
    os.makedirs(anno_genome, exist_ok=True)
    for f in os.listdir(mini_genome.refdir):
        link = os.path.join(anno_genome, f)
        if not os.path.lexists(link):
            os.symlink(os.path.join(mini_genome.refdir, f), link)
    # overlapping, unsorted rows with a repeated value, and rows of a
    # chromosome the genome lacks
    with gzip.open(os.path.join(anno_genome, "annotations.bed.gz"),
                   "wt") as f:
        f.write("chr1\t4000\t9000\texon\tGENE_A\n"
                "chr1\t1000\t5000\tpromoter\tGENE_A\n"
                "chr1\t1200\t1300\tpromoter\tGENE_A\n"
                "chr1\t20000\t25000\tintron\tGENE_B\n"
                "chr2\t100\t400\ttss\tGENE_C\n"
                "chr2\t300\t8000\tintergenic\n"
                "# a comment\n"
                "chrUn\t0\t100\tx\ty\n")
    with gzip.open(os.path.join(anno_genome, "ilmn2CpG.tsv.gz"), "wt") as f:
        f.write("cg00000001\t5\ncg00000002\t17\t1\ncg00000003\t420\n")
    rng = np.random.default_rng(77)
    lines = ["track name=x\n", "#chr\tstart\tend\n"]
    for _ in range(60):
        chrom = ("chr1", "chr2", "chrX")[int(rng.integers(0, 3))]
        size = {"chr1": 50000, "chr2": 30000, "chrX": 10000}[chrom]
        s = int(rng.integers(0, size - 600))
        e = s + int(rng.integers(1, 600))
        extra = "" if rng.random() < 0.5 else f"\tname{s}\t{e - s}"
        lines.append(f"{chrom}\t{s}\t{e}{extra}\n")
    lines += ["chr1\t1000\t1001\n", "chr1\t10\t12\n", "chrUn\t5\t500\n",
              "chr2\t29990\t30000\n", "chr1\t1500\t2000\tpromoter_row\n"]
    bed = d / "regions.bed"
    bed.write_text("".join(lines))
    with open(bed, "rb") as f, gzip.open(d / "regions.bed.gz", "wb") as g:
        g.write(f.read())
    sites = d / "sites.txt"
    sites.write_text("5\t10\n17\n\n300 420\n100\t101\n")
    return {"BED": str(bed), "BED_GZ": str(d / "regions.bed.gz"),
            "SITES": str(sites),
            "LOCUS": f"chr2:{int(mini_genome.index.chrom_loci('chr2')[3])}"}


def _both(argv, data, tmp_path, capsys, rc=0):
    """The JAX CLI's and the port's convert, each writing into its own
    directory ("OUT/<name>"); returns the directories and printed text."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    dirs, texts = [], []
    capsys.readouterr()
    for who, main in (("j", jax_main), ("t", port_main)):
        d = tmp_path / who
        d.mkdir()
        args = [str(d / a[4:]) if a.startswith("OUT/") else data.get(a, a)
                for a in argv]
        assert main(["convert"] + args) == rc
        dirs.append(d)
        texts.append(capsys.readouterr().out)
    return dirs, texts


CONVERT_CASES = {
    "region_anno": ["-r", "chr1:1,500-4,600"],
    "region_no_anno": ["-r", "chr1:1500-4600", "--no_anno"],
    "region_parsable": ["-r", "chr1:4500-9000", "-p"],
    "region_no_hit": ["-r", "chr1:30000-31000"],
    "region_locus": ["-r", "LOCUS"],
    "region_chrom": ["-r", "chrX"],
    "sites": ["-s", "5-10"],
    "sites_parsable": ["-s", "300-420", "--parsable"],
    "site_one": ["-s", "17"],
    "array_id": ["--array_id", "cg00000002"],
    "array_id_parsable": ["--array_id", "cg00000003", "-p"],
    "bed": ["-L", "BED"],
    "bed_gz_out": ["-L", "BED_GZ", "-o", "OUT/x.bed"],
    "bed_no_anno_drop": ["-L", "BED", "--no_anno", "--drop_empty"],
    "bed_parsable": ["-L", "BED", "-p", "-o", "OUT/x.bed"],
    "site_file": ["--site_file", "SITES"],
    "site_file_out": ["--site_file", "SITES", "-o", "OUT/x.bed"],
}


@pytest.mark.parametrize("case", sorted(CONVERT_CASES))
def test_convert_equals_jax_cli(data, tmp_path, capsys, case):
    (j, t), (jt, tt) = _both(CONVERT_CASES[case] + ["--genome", GENOME],
                             data, tmp_path, capsys)
    assert tt == jt
    want = {p.name: p.read_bytes() for p in j.iterdir()}
    got = {p.name: p.read_bytes() for p in t.iterdir()}
    assert got == want
    assert tt or got
    if case == "region_anno":
        assert "promoter\tGENE_A\nexon\tGENE_A" in tt
    if case == "bed":
        assert "\tpromoter\tGENE_A\n" in tt and "\tNA\tNA" in tt


@pytest.mark.parametrize("argv", [[], ["-r", "chr1:900-800"],
                                  ["--array_id", "cg99999999"],
                                  ["--array_id", "xx1"],
                                  ["-s", "0-3"], ["-r", "chr9:1-100"]])
def test_convert_refuses_what_jax_refuses(data, tmp_path, capsys, argv):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    capsys.readouterr()
    assert jax_main(["convert"] + argv + ["--genome", GENOME]) == 1
    want = capsys.readouterr().err
    assert port_main(["convert"] + argv + ["--genome", GENOME]) == 1
    got = capsys.readouterr().err
    assert got.replace("[wt-torch ", "[wt ") == want
