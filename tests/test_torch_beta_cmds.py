"""The port's beta commands (cli/cmd_beta.py: beta2bed, beta2bw, beta_cov,
beta_stats, bed2beta, lbeta2beta, beta_to_450k, compare_betas) against the
JAX CLI on the same inputs, byte for byte: every file each writes (a
.bedGraph.gz: its inflated text, since gzip stamps the time) and the text
it prints. The betas are made from a seed over the mini genome of
tests/conftest.py; beta_to_450k reads an ilmn2CpG.tsv.gz made here."""

import gzip
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from wgbs_tools_tpu.formats.blocks import sites_blocks  # noqa: E402

ILMN = "mini_ilmn_beta_cmds"
N_IDS = 400


@pytest.fixture(scope="module")
def data(mini_genome, tmp_path_factory):
    d = tmp_path_factory.mktemp("beta_cmds")
    rng = np.random.default_rng(2121)
    n = mini_genome.get_nr_sites()
    out = {}
    for name, hi in (("a", 40), ("b", 25), ("c", 90)):
        cov = rng.integers(0, hi, n)
        cov[rng.random(n) < 0.2] = 0
        meth = (cov * rng.random(n)).astype(np.int64)
        path = str(d / f"{name}.beta")
        np.stack([meth, cov], 1).astype(np.uint8).tofile(path)
        out[name] = path
    cov = rng.integers(0, 3000, n)
    meth = (cov * rng.random(n)).astype(np.int64)
    out["lbeta"] = str(d / "deep.lbeta")
    np.stack([meth, cov], 1).astype(np.uint16).tofile(out["lbeta"])
    idx = mini_genome.index
    ranges = [(s, s + int(k)) for s, k in zip(
        np.sort(rng.choice(np.arange(1, n - 40), 60, replace=False)),
        rng.integers(1, 30, 60))]
    ranges = [r for i, r in enumerate(ranges)
              if i == 0 or r[0] >= ranges[i - 1][1]]
    ranges = [(s, e) for s, e in ranges
              if idx.site2chrom_id(s) == idx.site2chrom_id(e - 1)]
    b = sites_blocks(idx, ranges)
    with open(d / "blocks.bed", "w") as f:
        for i in range(len(ranges)):
            f.write(f"{b['chr'][i]}\t{b['start'][i]}\t{b['end'][i]}\t"
                    f"{b['startCpG'][i]}\t{b['endCpG'][i]}\n")
        f.write("chrX\t0\t1\tNA\tNA\n")
    out["bed"] = str(d / "blocks.bed")
    # a genome of the same files with an Illumina map: ids over a seeded
    # choice of sites, a 450K-membership third column on most rows
    ilmn = os.path.join(os.path.dirname(mini_genome.refdir), ILMN)
    os.makedirs(ilmn, exist_ok=True)
    for f in os.listdir(mini_genome.refdir):
        link = os.path.join(ilmn, f)
        if not os.path.lexists(link):
            os.symlink(os.path.join(mini_genome.refdir, f), link)
    sites = rng.choice(np.arange(1, n + 1), N_IDS, replace=False)
    with gzip.open(os.path.join(ilmn, "ilmn2CpG.tsv.gz"), "wt") as f:
        for k, s in enumerate(sites.tolist()):
            tail = "" if k % 7 == 0 else f"\t{int(k % 3 != 0)}"
            f.write(f"cg{k:08d}\t{s}{tail}\n")
        f.write("header_like\tNA\n")
    out["ilmn_sites"] = sites
    ref = d / "ref_ids.txt"
    ref.write_text("".join(f"cg{k:08d}\n" for k in range(0, N_IDS, 5)))
    out["ref"] = str(ref)
    return out


def _sub(data, argv, d):
    """argv with the data's names ("A", "B", "C", "LBETA", "BED", "REF")
    and "OUT" / "OUT/<name>" (the run's directory) filled in."""
    names = {"A": data["a"], "B": data["b"], "C": data["c"],
             "LBETA": data["lbeta"], "BED": data["bed"], "REF": data["ref"]}
    args = []
    for a in argv:
        if a == "OUT":
            a = str(d)
        elif a.startswith("OUT/"):
            a = str(d / a[4:])
        else:
            a = names.get(a, a)
        args.append(a)
    return args


def _both(cmd, argv, data, tmp_path, capsys, device=False, rc=0):
    """The JAX CLI and the port's CLI (with --device cpu when `device`),
    each writing into its own directory; returns the directories and the
    text each printed."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    dirs, texts = [], []
    capsys.readouterr()
    for who, main in (("j", jax_main), ("t", port_main)):
        d = tmp_path / who
        d.mkdir()
        args = _sub(data, argv, d) + (["--device", "cpu"]
                                      if device and who == "t" else [])
        assert main([cmd] + args) == rc
        dirs.append(d)
        texts.append(capsys.readouterr().out)
    return dirs, texts


def _inflated(path):
    if path.name.endswith(".gz"):
        with gzip.open(path, "rb") as f:
            return f.read()
    return path.read_bytes()


def assert_same_dirs(j, t, min_files=1):
    want = {p.name: p for p in j.iterdir() if p.is_file()}
    got = {p.name: p for p in t.iterdir() if p.is_file()}
    assert sorted(got) == sorted(want)
    assert len(want) >= min_files
    for name, path in want.items():
        assert _inflated(got[name]) == _inflated(path), name


BETA2BED_CASES = {
    "whole": ["A", "-o", "OUT/x.bed"],
    "region": ["A", "-r", "chr1:2000-9000", "-o", "OUT/x.bed"],
    "sites_mean": ["B", "-s", "300-420", "--mean", "-o", "OUT/x.bed"],
    "keep_na_mean_cov": ["C", "--keep_na", "--mean", "-c", "30",
                         "-o", "OUT/x.bed"],
    "bed": ["A", "-L", "BED", "-o", "OUT/x.bed"],
    "bed_keep_na": ["LBETA", "-L", "BED", "--keep_na", "-c", "1000",
                    "-o", "OUT/x.bed"],
    "stdout": ["B", "-r", "chr2"],
}


@pytest.mark.parametrize("case", sorted(BETA2BED_CASES))
def test_beta2bed_equals_jax_cli(data, tmp_path, capsys, case):
    (j, t), (jt, tt) = _both("beta2bed", BETA2BED_CASES[case], data,
                             tmp_path, capsys)
    assert tt == jt
    if case == "stdout":
        assert tt.count("\n") > 100
    else:
        assert_same_dirs(j, t)
        assert (t / "x.bed").read_bytes().count(b"\n") > 10


BEAT2BW_CASES = {
    "plain": ["A", "B", "-o", "OUT"],
    "cov_keep_na": ["C", "--cov", "--keep_na", "-o", "OUT"],
    "min_cov_bed": ["A", "-c", "10", "-L", "BED", "--dump_cov", "-o", "OUT"],
    "bedgraph_lbeta": ["LBETA", "-b", "-c", "500", "-o", "OUT"],
}


@pytest.mark.parametrize("case", sorted(BEAT2BW_CASES))
def test_beta2bw_equals_jax_cli(data, tmp_path, capsys, case):
    from wgbs_tools_tpu.formats.bigwig import read_bigwig as jax_read
    from wgbs_tools_tpu_torch.formats.beta import load_beta
    from wgbs_tools_tpu_torch.formats.bigwig import read_bigwig
    from wgbs_tools_tpu_torch.genome.refdir import Genome

    (j, t), _ = _both("beta2bw", BEAT2BW_CASES[case], data, tmp_path, capsys)
    assert_same_dirs(j, t)
    if case != "plain":
        return
    # read back: the beta's values at the covered sites
    idx = Genome().index
    for name in ("a", "b"):
        tracks, summary = read_bigwig(str(t / f"{name}.bigwig"))
        want_tracks, want_summary = jax_read(str(j / f"{name}.bigwig"))
        assert summary == want_summary
        beta = load_beta(data[name]).astype(np.int64)
        for cid, chrom in enumerate(idx.chrom_names):
            lo, hi = idx.chrom_offsets[cid], idx.chrom_offsets[cid + 1]
            sub = beta[lo:hi]
            keep = sub[:, 1] >= 1
            starts, ends, vals = tracks[chrom]
            loci = idx.loci[lo:hi][keep].astype(np.int64)
            assert np.array_equal(starts, loci - 1)
            assert np.array_equal(ends, loci + 1)
            assert np.array_equal(vals, (sub[keep, 0] / sub[keep, 1])
                                  .astype(np.float32))
            for a, b in zip(tracks[chrom], want_tracks[chrom]):
                assert np.array_equal(a, b)


BETA_COV_CASES = {
    "whole": ["A", "B", "C"],
    "region": ["A", "LBETA", "-r", "chr1:1000-30000"],
    "sites": ["B", "-s", "50-900"],
    "bed": ["A", "C", "LBETA", "-L", "BED"],
    "hist": ["A", "B", "C", "--hist"],
}


@pytest.mark.parametrize("case", sorted(BETA_COV_CASES))
def test_beta_cov_equals_jax_cli(data, tmp_path, capsys, case):
    _, (jt, tt) = _both("beta_cov", BETA_COV_CASES[case], data, tmp_path,
                        capsys, device=True)
    assert tt == jt and tt.count("\t") >= 1


def test_beta_cov_asks_for_cuda(data, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["beta_cov", data["a"], "-L", data["bed"]])


BETA_STATS_CASES = {
    "whole": ["A", "B", "LBETA"],
    "region": ["A", "C", "-r", "chr2:100-20000"],
    "bed_min_cov": ["A", "B", "C", "-L", "BED", "-c", "5"],
    "sites": ["C", "-s", "10-20"],
}


@pytest.mark.parametrize("case", sorted(BETA_STATS_CASES))
def test_beta_stats_equals_jax_cli(data, tmp_path, capsys, case):
    _, (jt, tt) = _both("beta_stats", BETA_STATS_CASES[case], data,
                        tmp_path, capsys)
    assert tt == jt and tt.count("\n") >= 2


@pytest.mark.parametrize("add_one", [False, True])
def test_bed2beta_equals_jax_cli(data, tmp_path, capsys, add_one):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.formats.beta import load_beta, trim_to_uint

    src = tmp_path / "src"
    src.mkdir()
    bed = str(src / "a.bed")
    assert jax_main(["beta2bed", data["a"], "-o", bed]) == 0
    # a line bed2beta skips, a repeated locus and a foreign chromosome
    with open(bed, "a") as f:
        f.write("chr1\tstart\tend\t1\t2\nchrUn\t10\t12\t1\t1\n")
        f.write(open(bed).readline())
    lines = open(bed).readlines()
    with open(src / "b.bed", "w") as f:  # the same lines, shuffled
        f.writelines(np.random.default_rng(7).permutation(lines).tolist())
    (j, t), _ = _both("bed2beta", [bed, str(src / "b.bed"), "-o", "OUT"]
                      + (["--add_one"] if add_one else []), data, tmp_path,
                      capsys)
    assert_same_dirs(j, t, min_files=2)
    got = load_beta(str(t / "a.beta"))
    if add_one:  # the beta's bytes, round-tripped
        want = trim_to_uint(load_beta(data["a"]).astype(np.int64))
        assert np.array_equal(got, want)
    else:  # bed starts are loci - 1: no CpG matches
        assert not got.any()


def test_lbeta2beta_equals_jax_cli(data, tmp_path, capsys):
    from wgbs_tools_tpu_torch.formats.beta import load_beta, trim_to_uint

    (j, t), _ = _both("lbeta2beta", ["LBETA", "-o", "OUT", "--genome",
                                     "mini"], data, tmp_path, capsys)
    assert_same_dirs(j, t)
    want = trim_to_uint(load_beta(data["lbeta"]).astype(np.int64))
    assert np.array_equal(load_beta(str(t / "deep.beta")), want)


def test_lbeta2beta_size_check_equals_jax_cli(data, tmp_path, capsys):
    short = tmp_path / "short.lbeta"
    short.write_bytes(b"\x00" * 40)
    data = dict(data, lbeta=str(short))
    (j, t), _ = _both("lbeta2beta", ["LBETA", "-o", "OUT", "--genome",
                                     "mini"], data, tmp_path, capsys, rc=1)
    assert not list(j.iterdir()) and not list(t.iterdir())


BETA_450K_CASES = {
    "default": ["A", "B", "--genome", ILMN, "-o", "OUT/x.csv"],
    "epic_min_cov": ["A", "C", "--EPIC", "-c", "20", "--genome", ILMN,
                     "-o", "OUT/x.csv"],
    "ref": ["B", "--ref", "REF", "--genome", ILMN, "-o", "OUT/x.csv"],
    "stdout": ["LBETA", "--genome", ILMN],
}


@pytest.mark.parametrize("case", sorted(BETA_450K_CASES))
def test_beta_to_450k_equals_jax_cli(data, tmp_path, capsys, case):
    (j, t), (jt, tt) = _both("beta_to_450k", BETA_450K_CASES[case], data,
                             tmp_path, capsys)
    assert tt == jt
    if case == "stdout":
        assert tt.count("\n") > 100
        return
    assert_same_dirs(j, t)
    if case == "epic_min_cov":  # every id, the beta's mean at its site
        from wgbs_tools_tpu_torch.formats.beta import beta2vec, load_beta

        rows = (t / "x.csv").read_text().splitlines()[1:]
        assert len(rows) == N_IDS
        vec = beta2vec(load_beta(data["a"]), min_cov=20)
        want = vec[data["ilmn_sites"] - 1]
        got = np.array([np.nan if r.split(",")[1] == "NA"
                        else float(r.split(",")[1]) for r in rows])
        assert np.array_equal(np.isnan(got), np.isnan(want))
        ok = ~np.isnan(want)
        assert np.array_equal(got[ok], np.round(want[ok], 3))


def test_beta_to_450k_without_map_equals_jax_cli(data, tmp_path, capsys):
    _both("beta_to_450k", ["A"], data, tmp_path, capsys, rc=1)


COMPARE_CASES = {
    "three": ["A", "B", "C"],
    "region_min_cov": ["A", "C", "-r", "chr1:1000-40000", "-c", "3"],
    "sites": ["B", "C", "-s", "100-3000", "-c", "1"],
}


@pytest.mark.parametrize("case", sorted(COMPARE_CASES))
def test_compare_betas_equals_jax_cli(data, tmp_path, capsys, case):
    _, (jt, tt) = _both("compare_betas", COMPARE_CASES[case], data,
                        tmp_path, capsys)
    assert tt == jt and tt.count("\n") >= 2
