"""The port's pat-stream commands (view, cview, index, merge, mask_pat,
mix_pat, frag_len; cli/cmd_view.py, cli/cmd_pat.py over
pipeline/pat_stream.py and ops/frag_ops.py) against the JAX CLI, byte for
byte: every file each writes (.cdx: the same arrays) and the text it
prints. The pats come from the JAX CLI's bam2pat of simulated BAMs
(paired-end, single-end, and a --long pat whose rows carry a name
column), with their betas."""

import gzip
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bisim import dump_bam, simulate_reads  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

ILMN = "mini_ilmn_view"


@pytest.fixture(scope="module")
def pats(mini_genome, tmp_path_factory):
    from wgbs_tools_tpu.cli.main import main as jax_main

    d = tmp_path_factory.mktemp("view")
    rng = np.random.default_rng(515)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    out = {}
    for name, paired, n in (("pe", True, 3000), ("se", False, 2500)):
        reads, _ = simulate_reads(seqs, rng, n_reads=n, paired=paired)
        bam = dump_bam(reads, seqs, str(d / f"{name}.bam"))
        assert jax_main(["bam2pat", bam, "-o", str(d)]) == 0
        out[name] = str(d / f"{name}.pat.gz")
    long_dir = d / "long"
    long_dir.mkdir()
    assert jax_main(["bam2pat", str(d / "pe.bam"), "-o", str(long_dir),
                     "--long", "--no_beta"]) == 0
    out["long"] = str(long_dir / "pe.pat.gz")
    bed = d / "blocks.bed"
    bed.write_text("chr1\t0\t1\t100\t160\nchr1\t0\t1\t150\t170\n"
                   "chr2\t0\t1\t2300\t2400\nchrX\t0\t1\tNA\tNA\n"
                   "chr1\t0\t1\t900\t905\n")
    out["bed"] = str(bed)
    ilmn = os.path.join(os.path.dirname(mini_genome.refdir), ILMN)
    os.makedirs(ilmn, exist_ok=True)
    for f in os.listdir(mini_genome.refdir):
        link = os.path.join(ilmn, f)
        if not os.path.lexists(link):
            os.symlink(os.path.join(mini_genome.refdir, f), link)
    with gzip.open(os.path.join(ilmn, "ilmn2CpG.tsv.gz"), "wt") as f:
        f.write("cg00000001\t150\n")
    return out


def _both(cmd, argv, tmp_path, copy=(), device=False, rc=0):
    """The JAX CLI and the port's CLI (with --device cpu when `device`),
    each in its own directory holding copies of the inputs named in `copy`
    (the argument "OUT" names the directory, "IN:<key>" a copy); returns
    the directories."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    dirs = []
    for who, main in (("j", jax_main), ("t", port_main)):
        d = tmp_path / who
        d.mkdir()
        for src in copy:
            for ext in ("", ".cdx", ".csi"):
                if os.path.isfile(src + ext):
                    shutil.copy(src + ext, d)
        args = []
        for a in argv:
            if a == "OUT":
                a = str(d)
            elif a.startswith("OUT/"):
                a = str(d / a[4:])
            elif a.startswith("IN:"):
                a = str(d / os.path.basename(a[3:]))
            args.append(a)
        if device and who == "t":
            args += ["--device", "cpu"]
        assert main([cmd] + args) == rc
        dirs.append(d)
    return dirs


def assert_same_dirs(j, t, min_files=1):
    want = {p.name: p for p in j.iterdir() if p.is_file()}
    got = {p.name: p for p in t.iterdir() if p.is_file()}
    assert sorted(got) == sorted(want)
    assert len(want) >= min_files
    for name, path in want.items():
        if name.endswith(".cdx"):
            a, b = np.load(path), np.load(got[name])
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
        else:
            assert got[name].read_bytes() == path.read_bytes(), name


VIEW_CASES = {
    "whole": [],
    "region": ["-r", "chr1:2000-9000"],
    "sites": ["-s", "300-420", "--strict"],
    "bed": ["-L", "BED"],
    "bed_strict_strip": ["-L", "BED", "--strict", "--strip"],
    "min_len_no_gaps": ["--min_len", "3", "--no_gaps"],
    "sub_sample": ["--sub_sample", "0.2", "--seed", "3"],
    "sub_sample_reps": ["--sub_sample", "0.7", "--seed", "4", "-r", "chr2"],
    "shuffle": ["--shuffle", "--seed", "9", "-r", "chr1"],
    "no_sort": ["--no_sort", "-s", "100-2000"],
    "array_id": ["--array_id", "cg00000001", "--genome", ILMN],
    "bgzip_out": ["-r", "chr2:100-20000", "-o", "OUT/v.pat.gz"],
}


@pytest.mark.parametrize("cmd", ["view", "cview"])
@pytest.mark.parametrize("case", sorted(VIEW_CASES))
def test_view_pat_equals_jax_cli(pats, tmp_path, cmd, case):
    flags = [pats["bed"] if a == "BED" else a for a in VIEW_CASES[case]]
    if "-o" not in flags:
        flags += ["-o", "OUT/v.pat"]
    j, t = _both(cmd, [pats["pe"]] + flags, tmp_path)
    assert_same_dirs(j, t)
    text = (t / ("v.pat.gz" if case == "bgzip_out" else "v.pat")).read_bytes()
    if case == "bgzip_out":
        text = gzip.decompress(text)
    assert text.count(b"\n") > 5


@pytest.mark.parametrize("flags", [[], ["-r", "chr1:5000-9000", "--strict"],
                                   ["--sub_sample", "0.5", "--seed", "1"]])
def test_view_long_pat_keeps_extra_columns(pats, tmp_path, flags):
    j, t = _both("view", [pats["long"], "-o", "OUT/v.pat"] + flags,
                 tmp_path)
    assert_same_dirs(j, t)
    first = (t / "v.pat").read_text().splitlines()[0]
    assert len(first.split("\t")) == 5


@pytest.mark.parametrize("flags", [[], ["-r", "chr2:1000-9000"],
                                   ["-L", "BED"], ["-s", "50-90"]])
def test_view_beta_equals_jax_cli(pats, tmp_path, flags):
    beta = pats["pe"][:-len(".pat.gz")] + ".beta"
    flags = [pats["bed"] if a == "BED" else a for a in flags]
    j, t = _both("view", [beta, "-o", "OUT/v.txt"] + flags, tmp_path)
    assert_same_dirs(j, t)
    assert (t / "v.txt").read_text().count("\n") > 5


@pytest.mark.parametrize("kind", ["pat.gz", "pat", "bed", "bed.gz"])
def test_index_equals_jax_cli(pats, tmp_path, kind):
    src = tmp_path / "src"
    src.mkdir()
    if kind.startswith("pat"):
        raw = open(pats["se"], "rb").read()  # BGZF, without its index
        if kind == "pat":
            (src / "x.pat").write_bytes(gzip.decompress(raw))
        else:
            (src / "x.pat.gz").write_bytes(raw)
    else:
        bed = ("chr2\t5\t9\t400\t410\nchr1\t1\t3\t10\t20\n"
               "chr1\t4\t8\t30\t44\n")
        if kind == "bed":
            (src / "x.bed").write_text(bed)
        else:
            (src / "x.bed.gz").write_bytes(gzip.compress(bed.encode()))
    name = str(src / f"x.{kind}")
    # a plain-text pat is refused by both (rc 1), and nothing is written
    j, t = _both("index", ["IN:" + name], tmp_path, copy=[name],
                 rc=1 if kind == "pat" else 0)
    assert_same_dirs(j, t, min_files=1 if kind == "pat" else 2)


MERGE_CASES = {
    "pat": ["IN:pe", "IN:se"],
    "labels_region": ["IN:pe", "IN:se", "--labels", "a", "b", "-r",
                      "chr1:1000-30000"],
    "bed_strict": ["IN:pe", "IN:se", "-L", "BED", "--strict", "--min_len",
                   "2"],
    "long": ["IN:long", "IN:se"],
    "beta": ["IN:pe_beta", "IN:se_beta"],
}


@pytest.mark.parametrize("case", sorted(MERGE_CASES))
def test_merge_equals_jax_cli(pats, tmp_path, case):
    files = {"pe": pats["pe"], "se": pats["se"], "long": pats["long"],
             "pe_beta": pats["pe"][:-7] + ".beta",
             "se_beta": pats["se"][:-7] + ".beta"}
    argv = []
    copy = []
    for a in MERGE_CASES[case]:
        if a.startswith("IN:"):
            copy.append(files[a[3:]])
            a = "IN:" + files[a[3:]]
        argv.append(pats["bed"] if a == "BED" else a)
    j, t = _both("merge", argv + ["-p", "OUT/m"], tmp_path, copy=copy)
    assert_same_dirs(j, t)
    if case == "pat":
        from wgbs_tools_tpu_torch.formats.pat import read_pat

        n = read_pat(str(t / "m.pat.gz")).count.sum()
        assert n == sum(read_pat(f).count.sum()
                        for f in (pats["pe"], pats["se"]))


@pytest.mark.parametrize("flags", [["--beta"], ["--lbeta"],
                                   ["-r", "chr1:1000-40000", "--beta"], []])
def test_mask_pat_equals_jax_cli(pats, tmp_path, flags):
    j, t = _both("mask_pat", [pats["pe"], "-b", pats["bed"], "-p", "OUT/mk"]
                 + flags, tmp_path, device=True)
    assert_same_dirs(j, t, min_files=3)


def test_mask_pat_asks_for_cuda(pats, tmp_path, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["mask_pat", pats["pe"], "-b", pats["bed"], "-p",
                   str(tmp_path / "mk"), "--beta"])
    assert not list(tmp_path.iterdir())


MIX_CASES = {
    "rates": ["--rates", "0.3", "--seed", "5", "--reps", "2"],
    "cov": ["--rates", "0.6", "0.4", "-c", "3", "--seed", "8",
            "--labels", "x", "y"],
    "region_no_prefix": ["--rates", "0.5", "--seed", "2", "-r", "chr1"],
    "no_beta": ["--rates", "0.25", "--seed", "6"],
}


@pytest.mark.parametrize("case", sorted(MIX_CASES))
def test_mix_pat_equals_jax_cli(pats, tmp_path, case):
    """mix_pat of the PE and SE pats; with "no_beta" the SE pat's beta is
    missing, so each CLI makes it first (the port by pat2beta on its
    --device)."""
    copy = [pats["pe"], pats["pe"][:-7] + ".beta", pats["se"]]
    if case != "no_beta":
        copy.append(pats["se"][:-7] + ".beta")
    flags = list(MIX_CASES[case])
    if case != "region_no_prefix":
        flags += ["-p", "OUT/mix"]
    else:
        flags += ["-o", "OUT"]
    j, t = _both("mix_pat", ["IN:" + pats["pe"], "IN:" + pats["se"]] + flags,
                 tmp_path, copy=copy, device=True)
    assert_same_dirs(j, t, min_files=5)


@pytest.mark.parametrize("flags", [[], ["-m", "8"], ["-r", "chr2"],
                                   ["-L", "BED", "-m", "12"]])
def test_frag_len_equals_jax_cli(pats, tmp_path, flags, capsys):
    flags = [pats["bed"] if a == "BED" else a for a in flags]
    j, t = _both("frag_len", [pats["pe"], pats["se"], "--out_path",
                              "OUT/h.txt"] + flags, tmp_path)
    assert_same_dirs(j, t)
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    printed = []
    for main in (jax_main, port_main):
        capsys.readouterr()
        assert main(["frag_len", pats["pe"], "-v"] + flags) == 0
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1] and printed[0].startswith("# pe\n1\t")
