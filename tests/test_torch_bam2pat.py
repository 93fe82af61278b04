"""The port's bam2pat CLI (cli/cmd_bam2pat.py) with --device cpu against
the JAX CLI, byte for byte: the pat.gz, its .csi, the beta (or .lbeta) and
the m-bias tables; the .cdx sidecar is an np.savez zip with a timestamp, so
its arrays are compared. BAMs are simulated from a seed (tests/bisim.py,
tests/test_nanopore.py): paired- and single-end with CIGAR variants,
varied MAPQ, duplicate flags, read groups, and a nanopore BAM. Then the
device route through the whole pipeline with the kernels' twins on the CPU
(bam2pat_run.calling_device), and --stream against --no_stream."""

import gzip
import os
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bisim import add_cigar_variants, dump_bam, simulate_reads  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402
from wgbs_tools_tpu.pipeline.bam import BamReader, write_bam  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")


def _vary(reads, rng):
    """Mapping qualities of 0-60 and some duplicate flags, mate by mate."""
    for rd in reads:
        rd.mapq = int(rng.choice([0, 5, 20, 40, 60], p=[.05, .05, .1, .2,
                                                        .6]))
        if rng.random() < 0.03:
            rd.flag |= 0x400
    return reads


def _with_read_groups(src, dst):
    """A copy of the BAM src whose reads carry RG:Z:grpA or grpB (by
    qname, so both mates share one)."""
    reader = BamReader(src)
    recs = list(reader)
    for rec in recs:
        rec.tags = b"RGZgrp" + (b"A" if zlib.crc32(rec.qname.encode()) % 2
                                else b"B") + b"\x00"
    write_bam(dst, reader.ref_names, reader.ref_lengths, recs)
    return dst


@pytest.fixture(scope="module")
def inputs(mini_genome, tmp_path_factory):
    from test_nanopore import dump_np_bam, simulate_np_reads

    d = tmp_path_factory.mktemp("bam2pat")
    rng = np.random.default_rng(41)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    pe, _ = simulate_reads(seqs, rng, n_reads=700, paired=True)
    pe = _vary(add_cigar_variants(pe, seqs, rng, frac=0.25), rng)
    se, _ = simulate_reads(seqs, rng, n_reads=700, paired=False)
    se = _vary(add_cigar_variants(se, seqs, rng, frac=0.25), rng)
    nano = simulate_np_reads(seqs, rng, n_reads=120)
    out = {"pe": dump_bam(pe, seqs, str(d / "pe.bam")),
           "se": dump_bam(se, seqs, str(d / "se.bam")),
           "np": dump_np_bam(nano, seqs, str(d / "np.bam"))}
    out["rg"] = _with_read_groups(out["pe"], str(d / "rg.bam"))
    for name, iv in (("wl", [("chr1", 1000, 20000), ("chr2", 5000, 9000)]),
                     ("bl", [("chr1", 15000, 30000), ("chrX", 0, 4000)])):
        path = d / f"{name}.bed"
        path.write_text("".join(f"{c}\t{a}\t{b}\n" for c, a, b in iv))
        out[name] = str(path)
    return out


# case -> (BAM, flags)
CASES = {
    "pe": ("pe", []),
    "se": ("se", []),
    "pe_clip_min_cpg": ("pe", ["--clip", "3", "--min_cpg", "2"]),
    "se_clip": ("se", ["--clip", "5"]),
    "mapq_exclude": ("pe", ["-q", "30", "-F", "1024"]),
    "include_flags": ("pe", ["--include_flags", "1"]),
    "top_strand": ("pe", ["--top_strand"]),
    "bottom_strand": ("se", ["--bottom_strand"]),
    "read_group": ("rg", ["-rg", "grpA"]),
    "whitelist": ("pe", ["-L", "wl"]),
    "blacklist": ("pe", ["--blacklist", "bl"]),
    "long": ("pe", ["--long"]),
    "mbias": ("pe", ["--mbias"]),
    "blueprint": ("pe", ["--blueprint"]),
    "nanopore": ("np", []),
    "stream_pe": ("pe", ["--stream"]),
    "stream_se": ("se", ["--stream"]),
    "lbeta": ("pe", ["-l"]),
    "region": ("pe", ["-r", "chr2"]),
}


def _argv(inputs, case):
    bam, flags = CASES[case]
    return [inputs[bam]] + [inputs.get(f, f) if f in ("wl", "bl") else f
                            for f in flags]


def _outputs(d):
    return {p.name: p for p in d.iterdir() if p.is_file()}


def assert_same_outputs(jdir, tdir):
    """Every file the JAX CLI wrote (its m-bias plot too) is in tdir with
    the same bytes (.cdx: the same arrays), and tdir has no other file."""
    want = _outputs(jdir)
    got = _outputs(tdir)
    assert sorted(got) == sorted(want)
    assert any(n.endswith(".pat.gz") for n in want)
    for name, path in want.items():
        if name.endswith(".cdx"):
            a, b = np.load(path), np.load(got[name])
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert np.array_equal(a[k], b[k]), (name, k)
        else:
            assert got[name].read_bytes() == path.read_bytes(), name


def _run_both(inputs, case, tmp_path, extra=()):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    argv = _argv(inputs, case)
    dirs = []
    for who, main, more in (("j", jax_main, []),
                            ("t", port_main, ["--device", "cpu"])):
        d = tmp_path / who
        d.mkdir()
        assert main(["bam2pat"] + argv + ["-o", str(d)] + more
                    + list(extra)) == 0
        dirs.append(d)
    return dirs


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_bam2pat_equals_jax_cli(inputs, tmp_path, monkeypatch, case):
    # the m-bias plot's PDF carries no clock time, so both CLIs' are the
    # same bytes
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")
    j, t = _run_both(inputs, case, tmp_path)
    assert_same_outputs(j, t)
    names = _outputs(t)
    if case == "mbias":
        assert {"pe.mbias.OT.txt", "pe.mbias.OB.txt"} <= set(names)
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            pass
        else:
            assert "pe.mbias.pdf" in names
    if case == "read_group":
        assert "rg.grpA.pat.gz" in names
    pat = next(p for n, p in names.items() if n.endswith(".pat.gz"))
    assert gzip.decompress(pat.read_bytes()).count(b"\n") > (
        10 if case in ("nanopore", "region", "whitelist") else 100)


def test_stream_equals_no_stream(inputs, tmp_path):
    """The streamed pat.gz frames its BGZF blocks otherwise, but inflates
    to the whole-file path's text, and the betas are the same bytes."""
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    texts, betas = [], []
    for flag in ("--stream", "--no_stream"):
        d = tmp_path / flag.strip("-")
        d.mkdir()
        assert port_main(["bam2pat", inputs["pe"], "-o", str(d), flag,
                          "--device", "cpu"]) == 0
        texts.append(gzip.decompress((d / "pe.pat.gz").read_bytes()))
        betas.append((d / "pe.beta").read_bytes())
    assert texts[0] == texts[1] and betas[0] == betas[1]
    assert texts[0].count(b"\n") > 100


@pytest.mark.parametrize("case", ["pe", "se", "stream_pe", "stream_se",
                                  "long", "blueprint", "pe_clip_min_cpg"])
def test_device_route_with_twins_equals_jax_cli(inputs, tmp_path,
                                                monkeypatch, case):
    """The route a cuda run takes (calling and merging through
    call_reads_device / merge_pe_device, the loci kept by chromosome,
    the chromosome threads), with the kernels' twins on the CPU standing in
    for the card: the JAX CLI's bytes, and no kernel launched."""
    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline import bam2pat_run

    used = []

    def twins(dev, mbias_prefix):
        used.append(dev)
        return torch.device("cpu")

    monkeypatch.setattr(bam2pat_run, "calling_device", twins)
    before = (calling.call_reads.launches, calling.merge_pe.launches)
    j, t = _run_both(inputs, case, tmp_path, extra=["-@", "3"])
    assert used and (calling.call_reads.launches,
                     calling.merge_pe.launches) == before
    assert_same_outputs(j, t)


def test_calling_device_rules():
    """Calling leaves the card only for a CPU device and for --mbias, and
    says so."""
    from wgbs_tools_tpu_torch.pipeline.bam2pat_run import calling_device

    cuda = torch.device("cuda")
    assert calling_device(cuda, None) == cuda
    assert calling_device(torch.device("cpu"), None) is None
    assert calling_device(cuda, "x.mbias") is None


def test_cli_bam2pat_asks_for_cuda(inputs, tmp_path, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["bam2pat", inputs["pe"], "-o", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cli_bam2pat_procs_equals_one_process(inputs, tmp_path):
    """--procs 2 (two worker processes on the CPU): the pat inflates to the
    one-process text, and the beta is the same bytes."""
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    got = {}
    for name, more in (("one", []), ("procs", ["--procs", "2"])):
        d = tmp_path / name
        d.mkdir()
        assert port_main(["bam2pat", inputs["pe"], "-o", str(d), "--device",
                          "cpu"] + more) == 0
        got[name] = (gzip.decompress((d / "pe.pat.gz").read_bytes()),
                     (d / "pe.beta").read_bytes())
    assert got["procs"] == got["one"]
    assert got["one"][0].count(b"\n") > 100


@pytest.fixture(scope="module")
def slab_bams(mini_genome, tmp_path_factory):
    """A PE BAM whose long inserts put mates in different slabs, with CIGAR
    variants and read 2s of MAPQ 2 (mates the streamed route retires by the
    PNEXT watermark), and an SE BAM with CIGAR variants."""
    d = tmp_path_factory.mktemp("slabs")
    rng = np.random.default_rng(43)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    pe, _ = simulate_reads(seqs, rng, n_reads=1200, paired=True,
                           insert=4000)
    pe = add_cigar_variants(pe, seqs, rng, frac=0.2)
    for rd in pe:
        if rd.flag in (147, 163) and rng.random() < 0.1:
            rd.mapq = 2
    se, _ = simulate_reads(seqs, rng, n_reads=1200, paired=False)
    se = add_cigar_variants(se, seqs, rng, frac=0.2)
    return {"pe": dump_bam(pe, seqs, str(d / "pe.bam")),
            "se": dump_bam(se, seqs, str(d / "se.bam"))}


@pytest.mark.parametrize("bam,slab,route", [
    ("pe", 1 << 12, "host"), ("pe", 1 << 13, "twins"),
    ("se", 1 << 12, "twins"), ("se", 1 << 13, "host")])
def test_small_slabs_equal_jax_and_no_stream(mini_genome, slab_bams,
                                             tmp_path, monkeypatch, bam,
                                             slab, route):
    """The streamed route with slabs of a few KB (mate windows carried
    across slabs, the sorted emitter flushing often): the pat.gz, .csi and
    .cdx of JAX's streamed bam2pat at the same slab size, the text and the
    stats of the port's whole-file route. "twins" calls and merges through
    call_reads_device / merge_pe_device with the kernels' twins on the CPU,
    as a cuda run does."""
    from wgbs_tools_tpu.formats.bgzf import decompress_file
    from wgbs_tools_tpu.pipeline.bam2pat_run import bam2pat as jax_bam2pat
    from wgbs_tools_tpu_torch.genome.refdir import Genome
    from wgbs_tools_tpu_torch.ops import calling
    from wgbs_tools_tpu_torch.pipeline import bam2pat_run

    assert os.path.getsize(slab_bams[bam]) > 4 * slab
    if route == "twins":
        monkeypatch.setattr(bam2pat_run, "calling_device",
                            lambda dev, mbias_prefix: torch.device("cpu"))
    dirs = {w: tmp_path / w for w in ("jax", "stream", "whole")}
    for d in dirs.values():
        d.mkdir()
    jax_bam2pat(slab_bams[bam], genome=mini_genome,
                out_dir=str(dirs["jax"]), stream=True, slab_bytes=slab)
    before = (calling.call_reads.launches, calling.merge_pe.launches)
    g = Genome("mini")
    runs = {w: bam2pat_run.bam2pat(slab_bams[bam], genome=g,
                                   out_dir=str(dirs[w]),
                                   stream=w == "stream", slab_bytes=slab,
                                   device="cpu")
            for w in ("stream", "whole")}
    assert (calling.call_reads.launches,
            calling.merge_pe.launches) == before
    assert_same_outputs(dirs["jax"], dirs["stream"])
    texts = [decompress_file(runs[w][1]) for w in ("stream", "whole")]
    assert texts[0] == texts[1] and texts[0].count(b"\n") > 300
    assert runs["stream"][2].__dict__ == runs["whole"][2].__dict__
