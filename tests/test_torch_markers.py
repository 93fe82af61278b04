"""The port's find_markers (models/markers.py, without pandas) and
test_bimodal (models/bimodal.py) against the JAX CLI, byte for byte: every
Markers.<group>.bed and params.txt, and test_bimodal's table. The betas
are made from a seed over the mini genome with group-specific
methylation, blocks with no coverage in some samples (NaN), and a stretch
of blocks whose data are the same in each group, so every statistic ties
there; the pat comes from the JAX CLI's bam2pat of a simulated BAM."""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bisim import dump_bam, simulate_reads  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

SAMPLES = {"s1": "A", "s2": "A", "s3": "B", "s4": "B", "s5": "C",
           "s6": "C"}
TIE_BLOCKS = range(40, 70)  # blocks whose data tie in every column


@pytest.fixture(scope="module")
def data(mini_genome, tmp_path_factory):
    """Blocks of 3-20 sites (none across a chromosome), six betas and
    groups files."""
    d = tmp_path_factory.mktemp("markers")
    rng = np.random.default_rng(88)
    idx = mini_genome.index
    n = idx.nr_sites
    bounds = [1]
    for c in range(len(idx.chrom_names)):
        lo, hi = int(idx.chrom_offsets[c]) + 1, int(idx.chrom_offsets[c + 1]) + 1
        s = lo
        while s < hi:
            s = min(s + int(rng.integers(3, 21)), hi)
            bounds.append(s)
    bounds = np.unique(bounds)
    bs, be = bounds[:-1], bounds[1:]
    cid = idx.site2chrom_id(bs)
    lines = [f"{idx.chrom_names[c]}\t{idx.loci[s - 1] - 1}\t"
             f"{idx.loci[e - 2] + 1}\t{s}\t{e}\n"
             for c, s, e in zip(cid, bs, be)]
    blocks = d / "blocks.bed"
    blocks.write_text("".join(lines))
    nb = len(bs)
    # per (group, block) methylation: most blocks alike, some apart
    base = rng.choice([0.05, 0.5, 0.95], size=nb)
    p = {g: base.copy() for g in "ABC"}
    apart = rng.random(nb) < 0.3
    p["A"][apart] = 0.05
    p["B"][apart] = 0.92
    hyper = (rng.random(nb) < 0.15) & ~apart
    p["A"][hyper] = 0.95
    p["B"][hyper] = 0.1
    site_block = np.searchsorted(bs, np.arange(1, n + 1), side="right") - 1
    betas = []
    for k, (name, g) in enumerate(SAMPLES.items()):
        cov = rng.poisson(9, size=n).astype(np.int64)
        pm = p[g][site_block]
        meth = rng.binomial(cov, pm)
        dead = rng.random(nb) < 0.05  # no coverage: NaN blocks
        cov[dead[site_block]] = 0
        meth[dead[site_block]] = 0
        tie = np.isin(site_block, list(TIE_BLOCKS))
        cov[tie] = 10
        meth[tie] = {"A": 1, "B": 9, "C": 5}[g]
        arr = np.stack([meth, cov], axis=1).astype(np.uint8)
        path = d / f"{name}.beta"
        arr.tofile(path)
        betas.append(str(path))
    groups = d / "groups.csv"
    groups.write_text("# samples\nname,group\n" + "".join(
        f"{s},{g}\n" for s, g in SAMPLES.items()))
    include = d / "include.csv"
    include.write_text("sample,group,include\n" + "".join(
        f"{s},{g},{'False' if s in ('s2', 's6') else 'True'}\n"
        for s, g in SAMPLES.items()) + "s7,,True\n")
    one = d / "one_vs_one.csv"
    one.write_text("name,group\ns1,A\ns3,B\n")
    numeric = d / "numeric.csv"
    numeric.write_text("name,group\n" + "".join(
        f"{s},{'ABC'.index(g) + 1}\n" for s, g in SAMPLES.items()))
    cfg = d / "params.cfg"
    cfg.write_text("# find_markers parameters\nmin_cov: 4\ndelta_means: 0.4"
                   "\ntargets: A B\ntest_type: mw\npval: 0.2\n")
    blist = d / "betas.txt"
    blist.write_text("# betas\n" + "\n".join(betas) + "\n")
    return dict(blocks=str(blocks), betas=betas, groups=str(groups),
                include=str(include), one=str(one), numeric=str(numeric),
                cfg=str(cfg), blist=str(blist))


# case -> the flags after -b blocks
MARKER_CASES = {
    "t": ["-g", "groups", "--betas", "BETAS"],
    "mw_top_sort": ["-g", "groups", "--betas", "BETAS", "--test_type", "mw",
                    "--top", "7", "--sort_by", "delta_means", "--pval", "0.2"],
    "m_t_header": ["-g", "groups", "--betas", "BETAS", "--test_type", "m_t",
                   "--header"],
    "sort_ties": ["-g", "groups", "--betas", "BETAS", "--sort_by", "ttest",
                  "--top", "40", "--pval", "1"],
    "sort_tg_mean": ["-g", "groups", "--betas", "BETAS", "--sort_by",
                     "tg_mean"],
    "include": ["-g", "include", "--betas", "BETAS", "--header"],
    "one_vs_one": ["-g", "one", "--betas", "BETAS", "--sort_by", "mw_test"],
    "none": ["-g", "groups", "--betas", "BETAS", "--delta_means", "0.99"],
    "targets": ["-g", "groups", "--betas", "BETAS", "--targets", "A",
                "--background", "B", "C", "--only_hypo", "--min_cpg", "4",
                "--max_bp", "900", "--na_rate_tg", "0"],
    "hyper_quants": ["-g", "groups", "--betas", "BETAS", "--only_hyper",
                     "--delta_quants", "0.2", "--tg_quant", "0.1",
                     "--min_cov", "10", "--na_rate_bg", "0.5"],
    "config": ["-g", "groups", "--beta_list_file", "blist", "-p", "cfg"],
    "numeric_groups": ["-g", "numeric", "--betas", "BETAS", "--test_type",
                       "mw", "--pval", "0.2"],
    "sort_chr": ["-g", "groups", "--betas", "BETAS", "--sort_by", "chr",
                 "--pval", "1", "--delta_means", "0"],
    "sort_direction": ["-g", "groups", "--betas", "BETAS", "--sort_by",
                       "direction"],
}


def _argv(data, case):
    out = ["-b", data["blocks"]]
    for a in MARKER_CASES[case]:
        if a == "BETAS":
            out += data["betas"]
        else:
            out.append(data.get(a, a))
    return out + ["-o", "mk"]


@pytest.mark.parametrize("case", sorted(MARKER_CASES))
def test_find_markers_equals_jax_cli(data, tmp_path, monkeypatch, case):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    out = {}
    for who, main, more in (("j", jax_main, []),
                            ("t", port_main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        monkeypatch.chdir(d)
        assert main(["find_markers"] + _argv(data, case) + more) == 0
        out[who] = {p.name: p.read_bytes() for p in (d / "mk").iterdir()}
    assert sorted(out["t"]) == sorted(out["j"])
    for name, want in out["j"].items():
        assert out["t"][name] == want, name
    beds = [v for k, v in out["t"].items() if k.startswith("Markers.")]
    assert beds
    rows = sum(b.count(b"\n") for b in beds) - len(beds)
    if case == "none":
        assert all(b.startswith(b"#chr\tstart\t") and b.count(b"\n") == 1
                   for b in beds)
    elif case != "targets":
        assert rows > 10, rows
    if case == "numeric_groups":
        assert "Markers.1.bed" in out["t"]


def test_find_markers_asks_for_cuda(data, tmp_path, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["find_markers"] + _argv(data, "t"))
    assert not list(tmp_path.iterdir())


def test_groups_csv_parse_equals_pandas(tmp_path):
    """The groups file's parse keeps pandas.read_csv's rules on what the
    scan reads: comments, NA strings, blank lines, short rows, int /
    float / bool / str columns; a row longer than the header is refused
    (pandas raises too)."""
    import pandas as pd

    from wgbs_tools_tpu_torch.models.markers import _read_groups_csv
    from wgbs_tools_tpu_torch.utils import IllegalArgumentError

    text = ("# a comment\nfname,group,include,x\n"
            "a,1,True,1.5\n\nb,2,False,NA\n  # spaced\n   \n\t\n"
            "c,,true,2\nd,3\ne,4,TRUE,3\n")
    path = tmp_path / "g.csv"
    path.write_text(text)
    want = pd.read_csv(path, index_col=False, comment="#")
    header, cols = _read_groups_csv(str(path))
    assert header == list(want.columns)
    for name in header:
        got = [None if v is None else v for v in cols[name]]
        exp = [None if pd.isna(v) else v for v in want[name].tolist()]
        assert got == exp, name
        assert [type(v) for v in got if v is not None] == [
            type(v) for v in exp if v is not None], name
    path.write_text(text + "f,5,True,4,extra\n")
    with pytest.raises(pd.errors.ParserError):
        pd.read_csv(path, index_col=False, comment="#")
    with pytest.raises(IllegalArgumentError, match="fields"):
        _read_groups_csv(str(path))


# ------------------------------------------------------------ test_bimodal


@pytest.fixture(scope="module")
def pat(mini_genome, tmp_path_factory):
    """A pat.gz (and its beta) from the JAX CLI's bam2pat of a simulated
    paired-end BAM, and a genome dir that adds an Illumina map to the mini
    genome's files."""
    from wgbs_tools_tpu.cli.main import main as jax_main

    d = tmp_path_factory.mktemp("bimodal")
    rng = np.random.default_rng(707)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=4000, paired=True,
                              meth_rate=0.5)
    bam = dump_bam(reads, seqs, str(d / "bi.bam"))
    assert jax_main(["bam2pat", bam, "-o", str(d)]) == 0
    ilmn = os.path.join(os.path.dirname(mini_genome.refdir), "mini_ilmn")
    if not os.path.isdir(ilmn):
        os.makedirs(ilmn)
        for f in os.listdir(mini_genome.refdir):
            os.symlink(os.path.join(mini_genome.refdir, f),
                       os.path.join(ilmn, f))
        with gzip.open(os.path.join(ilmn, "ilmn2CpG.tsv.gz"), "wt") as f:
            f.write("cg00000001\t150\ncg00000002\t1200-1260\n")
    bed = d / "regions.bed"
    bed.write_text("chr1\t0\t1\t100\t130\nchr1\t0\t1\t500\t540\n"
                   "chr2\t0\t1\t2500\t2520\nchr1\t0\t1\t900\t903\n"
                   "chrX\t0\t1\tNA\tNA\n")
    return dict(pat=str(d / "bi.pat.gz"), bed=str(bed))


BIMODAL_CASES = {
    "region": ["-r", "chr1:3000-8000"],
    "sites": ["-s", "700-760", "--strict", "--min_len", "2"],
    "bed": ["-L", "BED"],
    "bed_all": ["-L", "BED", "--print_all_regions", "--max_iter", "5"],
    "array_id": ["--array_id", "cg00000002", "--genome", "mini_ilmn"],
}


@pytest.mark.parametrize("case", sorted(BIMODAL_CASES))
def test_test_bimodal_equals_jax_cli(pat, tmp_path, case):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    flags = [pat["bed"] if a == "BED" else a for a in BIMODAL_CASES[case]]
    out = []
    for who, main in (("j", jax_main), ("t", port_main)):
        path = tmp_path / f"{who}.tsv"
        assert main(["test_bimodal", pat["pat"], "-o", str(path)]
                    + flags) == 0
        out.append(path.read_text())
    assert out[0] == out[1]
    assert out[0].startswith("startCpG\tendCpG\tnr_reads")
    if case in ("bed_all", "region", "sites", "array_id"):
        assert out[0].count("\n") >= 2
