"""The port's BAM-splitting commands (add_cpg_counts, split_by_meth,
split_by_allele; pipeline/bam_split.py) and bam2pat --procs against the
JAX CLI, byte for byte: the BAMs they write, and the pat.gz, .csi and beta
of bam2pat on the split BAMs (.cdx: the same arrays). BAMs are simulated
from a seed (tests/bisim.py): paired- and single-end with CIGAR variants,
varied MAPQ, duplicates and read groups, and a planted SNP with low base
qualities on some of its reads."""

import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bisim import add_cigar_variants, dump_bam, simulate_reads  # noqa: E402
from test_torch_bam2pat import _vary  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402
from wgbs_tools_tpu.pipeline.bam import BamReader, write_bam  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

SNP_CHROM = "chr1"


def assert_same_outputs(jdir, tdir, need=".pat.gz"):
    """Every file the JAX CLI wrote is in tdir with the same bytes (.cdx:
    the same arrays; it is an np.savez zip with a timestamp), tdir has no
    other file, and one of them ends with `need`."""
    want = {p.name: p for p in jdir.iterdir() if p.is_file()}
    got = {p.name: p for p in tdir.iterdir() if p.is_file()}
    assert sorted(got) == sorted(want)
    assert any(n.endswith(need) for n in want), sorted(want)
    for name, path in want.items():
        if name.endswith(".cdx"):
            a, b = np.load(path), np.load(got[name])
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
        else:
            assert got[name].read_bytes() == path.read_bytes(), name


def _tagged(src, dst, rng):
    """A copy of the BAM src whose reads carry RG:Z:grpA or grpB (by qname,
    so both mates share one), a third with an NM:i tag before it."""
    reader = BamReader(src)
    recs = list(reader)
    for rec in recs:
        h = zlib.crc32(rec.qname.encode())
        tag = b"RGZgrp" + (b"A" if h % 2 else b"B") + b"\x00"
        if h % 3 == 0:
            tag = b"NMi" + int(h % 7).to_bytes(4, "little") + tag
        rec.tags = tag
    write_bam(dst, reader.ref_names, reader.ref_lengths, recs)
    return dst


def _planted_snp(src, dst, seqs):
    """A copy of the BAM src with a SNP planted at the most covered A/T
    base of chr1 that only reads with a plain CIGAR cover: reads whose
    qname hashes odd carry the other allele (C for an A, G for a T; both
    mates alike), and every fifth read has base quality 5 there. Returns
    (path, 1-based position, "ref/alt")."""
    reader = BamReader(src)
    recs = list(reader)
    cid = reader.ref_names.index(SNP_CHROM)
    ref = seqs[SNP_CHROM]
    cov = np.zeros(len(ref) + 1, dtype=np.int64)
    bad = np.zeros(len(ref) + 1, dtype=bool)
    for rec in recs:
        if rec.ref_id != cid:
            continue
        span = sum(n for op, n in rec.cigar if op in "MDN=X")
        if len(rec.cigar) == 1:
            cov[rec.pos:rec.pos + span] += 1
        else:
            bad[rec.pos:rec.pos + span] = True
    at = np.isin(ref[:len(ref)], np.frombuffer(b"AT", np.uint8))
    score = np.where(at & ~bad[:len(ref)], cov[:len(ref)], -1)
    pos0 = int(np.argmax(score))
    assert score[pos0] >= 4
    base = chr(ref[pos0])
    alt = {"A": "C", "T": "G"}[base]
    for k, rec in enumerate(recs):
        if (rec.ref_id != cid or len(rec.cigar) != 1
                or not rec.pos <= pos0 < rec.pos + len(rec.seq)):
            continue
        i = pos0 - rec.pos
        h = zlib.crc32(rec.qname.encode())
        if h % 2:
            rec.seq = rec.seq[:i] + alt.encode() + rec.seq[i + 1:]
        qual = bytearray(rec.qual if rec.qual else b"\x25" * len(rec.seq))
        if h % 5 == 0:
            qual[i] = 5
        rec.qual = bytes(qual)
    write_bam(dst, reader.ref_names, reader.ref_lengths, recs)
    return dst, pos0 + 1, f"{base}/{alt}"


@pytest.fixture(scope="module")
def bams(mini_genome, tmp_path_factory):
    d = tmp_path_factory.mktemp("bam_split")
    rng = np.random.default_rng(2020)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    pe, _ = simulate_reads(seqs, rng, n_reads=1500, paired=True)
    pe = _vary(add_cigar_variants(pe, seqs, rng, frac=0.2), rng)
    se, _ = simulate_reads(seqs, rng, n_reads=800, paired=False)
    se = _vary(add_cigar_variants(se, seqs, rng, frac=0.2), rng)
    # mates whose partner is gone: drop one mate of every 40th pair
    pe = [r for k, r in enumerate(pe) if not (k % 80 == 1)]
    out = {"pe": dump_bam(pe, seqs, str(d / "pe.bam")),
           "se": dump_bam(se, seqs, str(d / "se.bam"))}
    out["rg"] = _tagged(out["pe"], str(d / "rg.bam"), rng)
    out["snp"], out["snp_pos"], out["alleles"] = _planted_snp(
        out["pe"], str(d / "snp.bam"), seqs)
    bed = d / "regions.bed"
    bed.write_text("chr1\t2000\t9000\nchr2\t100\t12000\nchrX\t0\t3000\n")
    out["bed"] = str(bed)
    return out


def _run(argv_j, argv_t, tmp_path, cmd):
    """The JAX CLI and the port's CLI on the same arguments, each writing
    into its own directory (the argument "OUT" names it); returns the two
    directories and the return codes."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    dirs, rcs = [], []
    for who, main, argv in (("j", jax_main, argv_j), ("t", port_main,
                                                       argv_t)):
        d = tmp_path / who
        d.mkdir()
        rcs.append(main([cmd] + [str(d) if a == "OUT" else a
                                 for a in argv]))
        dirs.append(d)
    return dirs, rcs


# case -> (BAM, flags)
COUNT_CASES = {
    "pe": ("pe", []),
    "se": ("se", []),
    "add_pat": ("pe", ["--add_pat"]),
    "drop_singles": ("pe", ["--drop_singles"]),
    "bed": ("pe", ["-L", "bed"]),
    "region": ("pe", ["-r", "chr1:3000-20000"]),
    "sites": ("se", ["-s", "100-1200"]),
    "top_strand": ("pe", ["--top_strand"]),
    "bottom_strand": ("se", ["--bottom_strand"]),
    "read_group": ("rg", ["-rg", "grpA", "--add_pat"]),
    "clip_min_cpg": ("pe", ["--clip", "4", "--min_cpg", "3"]),
    "mapq_flags": ("pe", ["-q", "30", "-F", "1024", "--include_flags",
                          "2"]),
    "suffix": ("se", ["--suffix", "yi"]),
}


def _count_argv(bams, case):
    bam, flags = COUNT_CASES[case]
    return [bams[bam], "-o", "OUT"] + [bams.get(f, f) if f == "bed" else f
                                       for f in flags]


@pytest.mark.parametrize("case", sorted(COUNT_CASES))
def test_add_cpg_counts_equals_jax_cli(bams, tmp_path, case):
    argv = _count_argv(bams, case)
    (j, t), rcs = _run(argv, argv, tmp_path, "add_cpg_counts")
    assert rcs == [0, 0]
    assert_same_outputs(j, t, need=".bam")
    out = next(t.iterdir())
    n = sum(1 for r in BamReader(str(out)) if r.get_tag("YI") is not None)
    assert n > (10 if case in ("sites", "region", "bed") else 200)


@pytest.mark.parametrize("case", ["pe", "read_group", "drop_singles"])
@pytest.mark.parametrize("flags", [["0.75"], ["0.3", "--min_cpg", "3"],
                                   ["0.5", "-q", "30", "-F", "1024"],
                                   ["0.8", "-r", "chr2"]])
def test_split_by_meth_equals_jax_cli(bams, tmp_path, case, flags):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    counted = tmp_path / "counted"
    counted.mkdir()
    assert port_main(["add_cpg_counts"] + [
        str(counted) if a == "OUT" else a
        for a in _count_argv(bams, case)]) == 0
    src = str(next(counted.iterdir()))
    argv = [src] + flags + ["-o", "OUT"]
    (j, t), rcs = _run(argv, argv, tmp_path, "split_by_meth")
    assert rcs == [0, 0]
    assert_same_outputs(j, t, need=".bam")
    kept = sum(1 for p in t.iterdir() for _ in BamReader(str(p)))
    assert kept > 10


def test_split_by_meth_without_yi_refused_as_jax(bams, tmp_path):
    argv = [bams["pe"], "0.75", "-o", "OUT"]
    (j, t), rcs = _run(argv, argv, tmp_path, "split_by_meth")
    assert rcs == [1, 1]
    assert not list(j.iterdir()) and not list(t.iterdir())


@pytest.mark.parametrize("flags", [[], ["--snp_qual", "20"],
                                   ["--no_beta"], ["--no_pat"],
                                   ["-q", "30", "-F", "1024"]])
def test_split_by_allele_equals_jax_cli(bams, tmp_path, flags):
    argv = [bams["snp"], f"{SNP_CHROM}:{bams['snp_pos']}", bams["alleles"],
            "-o", "OUT"] + flags
    (j, t), rcs = _run(argv, argv + ["--device", "cpu"], tmp_path,
                       "split_by_allele")
    assert rcs == [0, 0]
    assert_same_outputs(j, t, need=".bam")
    split = sorted(p for p in t.iterdir() if p.name.endswith(".bam"))
    assert len(split) == 2
    counts = [sum(1 for _ in BamReader(str(p))) for p in split]
    assert min(counts) > 0, counts
    if "--no_pat" not in flags:
        assert any(p.name.endswith(".pat.gz") for p in t.iterdir())


def test_split_by_allele_asks_for_cuda(bams, tmp_path, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["split_by_allele", bams["snp"],
                   f"{SNP_CHROM}:{bams['snp_pos']}", bams["alleles"], "-o",
                   str(tmp_path)])
    assert not list(tmp_path.iterdir())


# ------------------------------------------------------------ --procs


def _bai_copy(bams, tmp_path, name):
    """The BAM copied into tmp_path, with a .bai written beside it by the
    JAX tests' minimal writer (one chunk a reference)."""
    from test_multihost import _make_bai

    dst = tmp_path / f"{name}.bam"
    dst.write_bytes(open(bams[name], "rb").read())
    _make_bai(str(dst))
    return str(dst)


@pytest.mark.parametrize("case,bai", [(("pe", []), False),
                                      (("pe", []), True),
                                      (("se", ["--clip", "3"]), True),
                                      (("rg", ["-rg", "grpB", "-l"]), False)])
def test_bam2pat_procs_equals_one_process(bams, tmp_path, bai, case):
    """bam2pat --procs 2 (two worker processes, each a contiguous block of
    chromosomes, on the CPU): its pat.gz and beta are the JAX CLI's
    --procs 2 bytes (parts joined by BGZF byte append; held on the PE
    BAM, the other cases hold the one-process port to the JAX CLI's one
    process), its pat inflates to the one-process port's text and its
    beta is the one-process beta;
    its rebuilt .cdx samples the one-process sites, and region reads
    through its .cdx and its .csi give the one-process file's lines (JAX's
    index of the joined file stops at the first part's EOF block: the
    port's BGZF reader goes on, formats/bgzf.py). With a .bai each worker
    decodes only its byte range."""
    import gzip

    from chip_smoke import _region_reads_equal
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.formats.pat import load_pat_index
    from wgbs_tools_tpu_torch.genome.refdir import Genome
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    name, flags = case
    bam = _bai_copy(bams, tmp_path, name) if bai else bams[name]
    dirs = {}
    # the JAX CLI's --procs starts two jax processes: its bytes are held
    # on the PE cases, its one-process run (the same bytes but the
    # pat.gz's blocks and its index) on the others
    jax_more = ["--procs", "2"] if name == "pe" else []
    for who, main, more in (("jax", jax_main, jax_more),
                            ("one", port_main, ["--device", "cpu"]),
                            ("procs", port_main, ["--device", "cpu",
                                                  "--procs", "2"])):
        d = tmp_path / who
        d.mkdir()
        assert main(["bam2pat", bam, "-o", str(d)] + flags + more) == 0
        dirs[who] = d
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert sorted(p.name for p in dirs["procs"].iterdir()) == names
    idx = Genome("mini").index
    regions = []
    for c in idx.chrom_names:
        lo, hi = idx.chrom_site_bounds(c)
        regions += [(c, lo, lo + 40), (c, (lo + hi) // 2, hi)]
    for n in names:
        p, q, o = (dirs[k] / n for k in ("jax", "procs", "one"))
        if n.endswith(".pat.gz"):
            # the JAX CLI's --procs bytes, or its one-process bytes
            assert (q if jax_more else o).read_bytes() == p.read_bytes()
            text = gzip.decompress(o.read_bytes())
            assert gzip.decompress(q.read_bytes()) == text
            assert text.count(b"\n") > 100
            assert _region_reads_equal(str(q), str(o), regions) > 100
        elif n.endswith(".cdx"):
            (sq, _, mq), (so, _, mo) = (load_pat_index(str(x)[:-4])
                                        for x in (q, o))
            assert np.array_equal(sq, so) and mq == mo
        elif n.endswith((".beta", ".lbeta")):
            assert q.read_bytes() == p.read_bytes() == o.read_bytes()


def test_bam2pat_procs_refusals_equal_jax(bams, tmp_path, capsys):
    """--procs with --mbias, --long or --no_pat is refused as JAX refuses
    it (the file skipped, rc 0, nothing written)."""
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    for flag in ("--mbias", "--long", "--no_pat"):
        assert port_main(["bam2pat", bams["pe"], "-o", str(tmp_path),
                          "--procs", "2", "--device", "cpu", flag]) == 0
        assert "does not combine" in capsys.readouterr().err
    assert not list(tmp_path.iterdir())


def test_bam2pat_array_id_refused(bams, tmp_path):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    with pytest.raises(SystemExit):
        port_main(["bam2pat", bams["pe"], "-o", str(tmp_path), "--device",
                   "cpu", "--array_id", "cg00001755"])
    assert not list(tmp_path.iterdir())


def test_bam_partition_helpers_equal_jax(bams, tmp_path, mini_genome):
    """_bam_ref_names, _bam_chrom_weights (with and without a .bai),
    _bai_ref_begs and _partition_contiguous equal JAX's; the ranged decode
    of each reference's byte range scans that reference's records."""
    from wgbs_tools_tpu.parallel import multihost as jm
    from wgbs_tools_tpu.pipeline.bam_columnar import \
        scan_bam_columnar as jax_scan
    from wgbs_tools_tpu_torch.genome.refdir import Genome
    from wgbs_tools_tpu_torch.parallel import multihost as pm
    from wgbs_tools_tpu_torch.pipeline.bam_columnar import scan_bam_columnar

    idx = Genome("mini").index
    jidx = mini_genome.index
    for bam in (bams["pe"], _bai_copy(bams, tmp_path, "pe")):
        names = pm._bam_ref_names(bam)
        assert names == jm._bam_ref_names(bam) == ["chr1", "chr2", "chrX"]
        w = pm._bam_chrom_weights(bam, names, idx)
        assert w == jm._bam_chrom_weights(bam, names, jidx)
        assert pm._bai_ref_begs(bam) == jm._bai_ref_begs(bam)
        for n in (1, 2, 3, 5):
            assert (pm._partition_contiguous(names, w, n)
                    == jm._partition_contiguous(names, w, n))
    begs = pm._bai_ref_begs(bam)
    assert begs is not None and None not in begs
    full = scan_bam_columnar(bam)
    for r in range(3):
        rng_ = (begs[r], begs[r + 1] if r + 1 < 3 else None)
        got, want = scan_bam_columnar(bam, rng_), jax_scan(bam, rng_)
        assert got[0] == want[0]
        for a, b in zip(got[4:], want[4:]):
            assert np.array_equal(a, b)
        assert set(got[4][:, 0].tolist()) == {r}
        assert (got[4][:, 0] == r).sum() == (full[4][:, 0] == r).sum()
