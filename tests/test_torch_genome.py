"""The port's init_genome and set_default_ref (cli/cmd_genome.py over
genome/init_genome.py and genome/refdir.py) against the JAX CLI: each
initializes the same FASTA, made here from a seed, into a reference root
of its own, and every file either writes is the same (bytes; the .npz, its
arrays), with the chromosomes sorted and with --no_sort, with and without
the auxiliary files. set_default_ref switches the `default` link as JAX's
does, and lists the genomes in the same words."""

import gzip
import os

import numpy as np
import pytest

from synth import make_fasta

CHROMS = {"chr2": 9000, "chr10": 4000, "chrX": 3000, "chr1": 12000,
          "chrUn_x": 2000, "chrM": 500, "7": 1500}


@pytest.fixture(scope="module")
def fastas(tmp_path_factory):
    d = tmp_path_factory.mktemp("genome_src")
    rng = np.random.default_rng(2103)
    out = {"plain": make_fasta(str(d / "g.fa"), CHROMS, rng)}
    with open(out["plain"], "rb") as f, gzip.open(d / "g.fa.gz", "wb") as g:
        g.write(f.read())
    out["gz"] = str(d / "g.fa.gz")
    anno = d / "anno.bed"
    anno.write_text("chr1\t100\t900\tpromoter\tGENE_A\n"
                    "chr2\t10\t5000\texon\tGENE_B\n")
    ilmn = d / "ilmn.tsv"
    ilmn.write_text("cg00000001\t5\t1\ncg00000002\t17\t0\n")
    with open(ilmn, "rb") as f, gzip.open(d / "ilmn.tsv.gz", "wb") as g:
        g.write(f.read())
    black = d / "black.bed"
    black.write_text("chr1\t0\t100\n")
    with open(black, "rb") as f, gzip.open(d / "white.bed.gz", "wb") as g:
        g.write(b"chr2\t0\t5000\n")
    blocks = d / "blocks.bed"
    blocks.write_text("chr1\t0\t500\t1\t5\n")
    out.update(anno=str(anno), ilmn=str(d / "ilmn.tsv.gz"), black=str(black),
               white=str(d / "white.bed.gz"), blocks=str(blocks))
    return out


def _run(who, root, argv, monkeypatch):
    """One CLI's command with WGBS_TPU_REFDIR at `root`."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setenv("WGBS_TPU_REFDIR", str(root))
    return (jax_main if who == "j" else port_main)(argv)


def _tree(root):
    """{relative path: bytes, link target or the .npz's arrays}."""
    out = {}
    for dirpath, dirnames, files in os.walk(root):
        for name in files + [d for d in dirnames
                             if os.path.islink(os.path.join(dirpath, d))]:
            path = os.path.join(dirpath, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            elif name.endswith(".npz"):
                with np.load(path) as z:
                    out[rel] = {k: z[k] for k in z.files}
            else:
                with open(path, "rb") as f:
                    out[rel] = f.read()
    return out


def assert_same_trees(j, t, min_files):
    a, b = _tree(j), _tree(t)
    assert sorted(b) == sorted(a)
    assert len(a) >= min_files
    for rel, want in a.items():
        got = b[rel]
        if isinstance(want, dict):
            assert sorted(got) == sorted(want), rel
            for k in want:
                assert got[k].dtype == want[k].dtype, (rel, k)
                assert np.array_equal(got[k], want[k]), (rel, k)
        else:
            assert got == want, rel


INIT_CASES = {
    "sorted": ["FASTA"],
    "no_sort": ["FASTA", "--no_sort"],
    "gz_no_default": ["FASTA_GZ", "--no_default", "-@", "4"],
    "aux": ["FASTA", "--annotations", "ANNO", "--ilmn2cpg", "ILMN",
            "--blacklist", "BLACK", "--whitelist", "WHITE", "--blocks",
            "BLOCKS"],
}


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_genome_equals_jax_cli(fastas, tmp_path, monkeypatch, case):
    names = {"FASTA": fastas["plain"], "FASTA_GZ": fastas["gz"],
             "ANNO": fastas["anno"], "ILMN": fastas["ilmn"],
             "BLACK": fastas["black"], "WHITE": fastas["white"],
             "BLOCKS": fastas["blocks"]}
    argv = ["init_genome", "tg"]
    for a in INIT_CASES[case]:
        argv += (["--fasta_path", names[a]] if a.startswith("FASTA")
                 else [names.get(a, a)])
    roots = {who: tmp_path / who for who in "jt"}
    for who, root in roots.items():
        assert _run(who, root, argv, monkeypatch) == 0
    assert_same_trees(roots["j"], roots["t"], min_files=6)
    # the port reads back what it wrote: the CpG loci of the FASTA
    from wgbs_tools_tpu_torch.genome.cpg_index import (CpGIndex,
                                                       find_cpg_loci,
                                                       read_fasta)

    idx = CpGIndex.load(str(roots["t"] / "tg"))
    seqs = read_fasta(fastas["plain"])
    assert "chrUn_x" not in idx.chrom_names
    assert len(idx.chrom_names) == len(CHROMS) - 1
    if case != "no_sort":
        assert idx.chrom_names == ["chr1", "chr2", "7", "chr10", "chrX",
                                   "chrM"]
    for c in idx.chrom_names:
        assert np.array_equal(idx.chrom_loci(c), find_cpg_loci(seqs[c]))
    assert os.path.islink(roots["t"] / "default") == (
        case != "gz_no_default")


def test_init_genome_refuses_what_jax_refuses(fastas, tmp_path, monkeypatch,
                                              capsys):
    roots = {who: tmp_path / who for who in "jt"}
    for argv in (["init_genome", "tg", "--fasta_path", fastas["plain"]],
                 ["init_genome", "tg", "--fasta_path", fastas["plain"]],
                 ["init_genome", "tg2", "--fasta_path", "/nonexistent.fa"],
                 ["init_genome", "tg3", "--fasta_path", fastas["plain"],
                  "--annotations", "/nonexistent.bed"],
                 ["init_genome", "tg4"]):
        rcs, errs = [], []
        for who, root in roots.items():
            rcs.append(_run(who, root, argv, monkeypatch))
            errs.append(capsys.readouterr().err.replace(str(root), "ROOT")
                        .replace("[wt-torch ", "[wt ")
                        .replace("[wt wgbs_tpu_torch]", "[wt wgbs_tpu]"))
        assert rcs[0] == rcs[1]
        assert errs[0].splitlines()[-1:] == errs[1].splitlines()[-1:]
    assert rcs == [1, 1] and "auto-download is unavailable" in errs[1]
    assert_same_trees(roots["j"], roots["t"], min_files=6)


def test_init_genome_force_equals_jax_cli(fastas, tmp_path, monkeypatch):
    roots = {who: tmp_path / who for who in "jt"}
    for who, root in roots.items():
        for extra in ([], ["-f", "--no_sort"]):
            assert _run(who, root, ["init_genome", "tg", "--fasta_path",
                                    fastas["plain"]] + extra,
                        monkeypatch) == 0
    assert_same_trees(roots["j"], roots["t"], min_files=6)


def test_set_default_ref_equals_jax_cli(fastas, tmp_path, monkeypatch,
                                        capsys):
    from wgbs_tools_tpu.genome.refdir import set_default_ref as jax_set
    from wgbs_tools_tpu.utils import IllegalArgumentError as JaxIllegal
    from wgbs_tools_tpu_torch.genome.refdir import Genome, set_default_ref
    from wgbs_tools_tpu_torch.utils import IllegalArgumentError

    roots = {who: tmp_path / who for who in "jt"}
    texts = {}
    for who, root in roots.items():
        for name in ("ga", "gb"):
            assert _run(who, root, ["init_genome", name, "--fasta_path",
                                    fastas["plain"]], monkeypatch) == 0
        seen = []
        for argv in (["set_default_ref", "-ls"], ["set_default_ref", "ga"],
                     ["set_default_ref", "-ls"],
                     ["set_default_ref", "--name", "gb"],
                     ["set_default_ref", "--list_refs"]):
            assert _run(who, root, argv, monkeypatch) == 0
            seen.append(capsys.readouterr().out)
            seen.append(os.readlink(root / "default"))
        assert _run(who, root, ["set_default_ref", "nope"], monkeypatch) == 1
        seen.append(capsys.readouterr().err.replace("[wt-torch ", "[wt "))
        texts[who] = seen
    assert texts["t"] == texts["j"]
    assert texts["t"][0] == "ga\ngb *\n" and texts["t"][3] == "ga"
    assert Genome().name == "gb"
    for fn, err in ((jax_set, JaxIllegal), (set_default_ref,
                                            IllegalArgumentError)):
        with pytest.raises(err, match="Invalid reference name: nope"):
            fn("nope")
    # a `default` that is not a link is refused by both
    os.unlink(roots["t"] / "default")
    (roots["t"] / "default").write_text("")
    for fn, err in ((jax_set, JaxIllegal), (set_default_ref,
                                            IllegalArgumentError)):
        with pytest.raises(err, match="exists and is not a symlink"):
            fn("ga")
