"""bam2pat's calling and merging (ops/calling.py) against the JAX package,
tolerance 0: the twins of the call_reads and merge_pe kernels, through
call_reads_device / merge_pe_device on the CPU, equal numpy's
call_reads_mat / merge_pe_mat and JAX's call_reads_device,
call_reads_device_v2 and merge_pe_device (the JAX CPU backend, as
tests/test_bam2pat.py runs them), value and dtype, on the hand-made edges
chip_smoke.CALL_EDGE / MERGE_EDGE and on the batches decode_and_call hands
over for a simulated BAM. The kernels themselves run only on the card:
the tests marked cuda hold them to the twins there."""

import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from bisim import add_cigar_variants, dump_bam, simulate_reads  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.genome.cpg_index import read_fasta  # noqa: E402
from wgbs_tools_tpu.ops import calling_tpu as jcall  # noqa: E402
from wgbs_tools_tpu.pipeline import calling as jcalling  # noqa: E402
from wgbs_tools_tpu_torch.ops import calling  # noqa: E402
from wgbs_tools_tpu_torch.pipeline import bam_columnar  # noqa: E402
from wgbs_tools_tpu_torch.pipeline.bam_columnar import (  # noqa: E402
    scan_bam_columnar)
from wgbs_tools_tpu_torch.pipeline.calling import ReadStats  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert np.array_equal(g, w)


def _call_args(b):
    return (b["positions"], b["flags"], b["paired"], b["loci"],
            b["site_base"], b["seqmat"], b["lens"])


def _all_calls(b, chunk=64):
    """(numpy, JAX v1, JAX v2, the port's twin) on a call batch."""
    args, clip = _call_args(b), b["clip"]
    return (jcalling.call_reads_mat(*args, clip=clip),
            jcall.call_reads_device(*args, clip=clip),
            jcall.call_reads_device_v2(*args, clip=clip, chunk=chunk),
            calling.call_reads_device(*args, clip=clip, device="cpu"))


@pytest.mark.parametrize("name", chip_smoke.CALL_EDGE)
def test_call_edge_twin_equals_numpy_and_jax(name):
    b = chip_smoke.call_edge_batch(name)
    before = calling.call_reads.launches
    want, v1, v2, got = _all_calls(b)
    assert calling.call_reads.launches == before  # the CPU takes the twin
    _same(got, want)
    _same(v1, want)
    # JAX's v2 leaves the pattern as wide as its K; the values agree
    assert np.array_equal(v2[0], want[0]) and np.array_equal(v2[2], want[2])
    assert np.array_equal(v2[1][:, :want[1].shape[1]], want[1])


def test_call_edges_reach_their_cases():
    """The edges hold what they are named for."""
    b = chip_smoke.call_edge_batch("bottom_ends")
    start, _, span = jcalling.call_reads_mat(*_call_args(b))
    assert (start >= 0).all() and b["seqmat"][:, 0].tolist().count(
        ord("C")) > 500
    for name in ("no_loci", "all_dots"):
        start, pat, _ = jcalling.call_reads_mat(
            *_call_args(chip_smoke.call_edge_batch(name)))
        assert (start < 0).all() and pat.shape[1] == 1
    b = chip_smoke.call_edge_batch("widened")
    assert b["seqmat"].shape[1] == 520 and b["lens"].max() >= 480
    b = chip_smoke.call_edge_batch("last_locus")
    start, _, span = jcalling.call_reads_mat(*_call_args(b))
    last = b["site_base"] + b["loci"].shape[0] - 1
    assert ((start + span - 1) == last).sum() > 100
    assert (chip_smoke.call_edge_batch("len0")["lens"] == 0).sum() > 50
    # the tile paths' edges: sorted reads, R not a multiple of a tile;
    # CpG-dense reads, some with len // 2 + 1 slots; more loci than a
    # tile's window; and wide mates of two widths
    for name in ("sorted_tiles", "dense"):
        b = chip_smoke.call_edge_batch(name)
        assert (np.diff(b["positions"]) >= 0).all()
        assert b["seqmat"].shape[0] % TILE
    b = chip_smoke.call_edge_batch("dense")
    pos1, lens = b["positions"], b["lens"]
    nv = (np.searchsorted(b["loci"], pos1 + lens)
          - np.searchsorted(b["loci"], pos1))
    assert nv.mean() > 20 and ((nv == lens // 2 + 1) & (lens > 100)).any()
    assert chip_smoke.call_edge_batch("wide_window")["loci"].shape[0] > WIN
    _, p1, sp1, _, p2, sp2 = chip_smoke.merge_edge_batch("wide_mates")
    assert p1.shape[1] != p2.shape[1] and sp1.max() >= 240


# csrc/calling.cu's call_reads tile at L 150 (reads), its shared window
# (loci), and the widest pair of rows (S1 + S2) merge_pe stages: the shapes
# the edges are made to, not a model of the kernels (the card holds each
# edge to the paths the kernel counts and the body its C plan names,
# chip_smoke.EDGE_PATHS and MERGE_BODIES)
TILE, WIN, STAGED_ROWS = 512, 2048, 256


def test_call_edges_reach_the_kernel_paths():
    """The edges of chip_smoke.EDGE_PATHS have the shapes that lead the
    kernel down their paths: sorted_tiles and dense sorted over a
    chromosome whose loci all fit a tile's window (staged tiles alone);
    wide_window's first tile unsorted, its second sorted and spread over
    more loci than a window, the rest sorted within a short stretch;
    random unsorted in its one tile; the long batch's reads over 8 kb (the
    long body); the merge edges of MERGE_BODIES wider than a staged tile's
    rows, the others narrower."""
    assert set(chip_smoke.EDGE_PATHS) <= set(chip_smoke.CALL_EDGE) | {"long"}
    for name in ("sorted_tiles", "dense"):
        b = chip_smoke.call_edge_batch(name)
        assert (np.diff(b["positions"]) >= 0).all()
        assert b["loci"].shape[0] <= WIN
    b = chip_smoke.call_edge_batch("wide_window")
    pos, loci = b["positions"], b["loci"]
    spread, rest = pos[TILE:2 * TILE], pos[2 * TILE:]
    assert (np.diff(pos[:TILE]) < 0).any()
    assert (np.diff(spread) >= 0).all() and (np.diff(rest) >= 0).all()
    assert np.searchsorted(loci, spread[-1]) - \
        np.searchsorted(loci, spread[0]) > WIN
    assert 0 < rest.shape[0] < TILE and np.searchsorted(
        loci, rest[-1] + 150) - np.searchsorted(loci, rest[0]) < WIN
    assert (np.diff(chip_smoke.call_edge_batch("random")["positions"])
            < 0).any()
    assert chip_smoke.call_long_batch()["lens"].min() > 8000
    for name in chip_smoke.MERGE_EDGE:
        _, p1, _, _, p2, _ = chip_smoke.merge_edge_batch(name)
        wide = p1.shape[1] + p2.shape[1] > STAGED_ROWS
        assert wide == (name in chip_smoke.MERGE_BODIES), name


def test_dense_batch_twin_equals_numpy_and_jax():
    """chip_smoke.dense_batch cut to 3,000 reads over 40 kbp (its reads a
    kbp), and its pairs: sorted, CpG-dense (> 10 covered CpGs a read),
    each tile's loci within a window;
    the twins equal numpy and JAX's v1 entry points;
    the sectors its calls touch lie between its covered CpGs' count over 8
    and twice it, and merge_sectors counts each mate's sectors once."""
    b = chip_smoke.dense_batch(n=3000, bp=40_000)
    args, clip = _call_args(b), b["clip"]
    assert (np.diff(b["positions"]) >= 0).all()
    pos1, lens, _, _ = calling.call_columns(b["positions"], b["flags"],
                                            b["paired"], b["seqmat"],
                                            b["lens"])
    L = b["seqmat"].shape[1]
    for lo in range(0, pos1.shape[0], TILE):  # each tile's loci fit a window
        p = pos1[lo:lo + TILE]
        assert np.searchsorted(b["loci"], p[-1] + L) - \
            np.searchsorted(b["loci"], p[0]) < WIN
    want = jcalling.call_reads_mat(*args, clip=clip)
    assert want[2].mean() > 10
    _same(calling.call_reads_device(*args, clip=clip, device="cpu"), want)
    _same(jcall.call_reads_device(*args, clip=clip), want)
    _, _, bottom, _ = calling.call_columns(*args[:2], True, args[5], args[6])
    covered = chip_smoke._call_bytes(pos1, lens, b["loci"], want[2])[1]
    sectors = chip_smoke.call_sectors(pos1, lens, bottom, b["loci"],
                                      b["seqmat"].shape[1])
    assert covered / 8 < sectors < 2 * covered
    m = chip_smoke.dense_pairs(want)
    assert m[0].shape[0] > 1000
    got = calling.merge_pe_device(*m, device="cpu")
    _same(got, jcalling.merge_pe_mat(*m))
    _same(jcall.merge_pe_device(*m), got)
    sp1, sp2, S1, S2 = m[2], m[5], m[1].shape[1], m[4].shape[1]
    rows = set()
    for r in range(m[0].shape[0]):
        for base, sp, S in ((0, sp1, S1), (1 << 40, sp2, S2)):
            rows.update((base + r * S + np.arange(sp[r])) >> 5)
    assert chip_smoke.merge_sectors(sp1, sp2, S1, S2) == len(rows)


def test_long_reads_twin_equals_numpy_and_jax():
    """The long body's batch (reads over 8 kb; JAX's v2 entry point, whose
    compares span R x K x L, is not run at this width)."""
    b = chip_smoke.call_long_batch()
    args, clip = _call_args(b), b["clip"]
    want = jcalling.call_reads_mat(*args, clip=clip)
    assert (want[0] >= 0).all() and want[2].max() > 100
    _same(calling.call_reads_device(*args, clip=clip, device="cpu"), want)
    _same(jcall.call_reads_device(*args, clip=clip), want)


@pytest.mark.parametrize("name", chip_smoke.MERGE_EDGE)
def test_merge_edge_twin_equals_numpy_and_jax(name):
    b = chip_smoke.merge_edge_batch(name)
    before = calling.merge_pe.launches
    want = jcalling.merge_pe_mat(*b)
    got = calling.merge_pe_device(*b, device="cpu")
    assert calling.merge_pe.launches == before
    _same(got, want)
    _same(jcall.merge_pe_device(*b), want)
    if name == "widths":
        s1, _, sp1, s2, _, sp2 = b
        width = np.maximum(s1 + sp1, s2 + sp2) - np.minimum(s1, s2)
        assert {299, 300, 301} <= set(width.tolist())
        assert np.array_equal(want[3], width > 300)


def test_empty_batches_equal_numpy():
    b = chip_smoke.call_edge_batch("random")
    args = list(_call_args(b))
    args[5], args[6] = args[5][:0], args[6][:0]
    args[0], args[1] = args[0][:0], args[1][:0]
    _same(calling.call_reads_device(*args, device="cpu"),
          jcalling.call_reads_mat(*args))
    m = [x[:0] for x in chip_smoke.merge_edge_batch("random")]
    _same(calling.merge_pe_device(*m, device="cpu"),
          jcalling.merge_pe_mat(*m))


@pytest.fixture(scope="module")
def bam_batches(mini_genome, tmp_path_factory):
    """decode_and_call's inputs for each chromosome of a simulated
    paired-end BAM with CIGAR variants: (genome, [(chrom, kwargs)])."""
    d = tmp_path_factory.mktemp("calling")
    rng = np.random.default_rng(31)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=700, paired=True)
    reads = add_cigar_variants(reads, seqs, rng, frac=0.3)
    bam = dump_bam(reads, seqs, str(d / "pe.bam"))
    buf, _h, ref_names, _l, cols, offs, _e = scan_bam_columnar(bam)
    idx = mini_genome.index
    out = []
    for rid, chrom in enumerate(ref_names):
        rows = np.nonzero((cols[:, 0] == rid) & (cols[:, 2] & 4 == 0))[0]
        site_base, _ = idx.chrom_site_bounds(chrom)
        out.append((chrom, dict(buf=buf, bufarr=np.frombuffer(buf, np.uint8),
                                cols=cols, offs=offs, idx_rows=rows,
                                loci=idx.chrom_loci(chrom),
                                site_base=site_base, paired=True)))
    return out


@pytest.mark.parametrize("clip", [0, 3])
def test_bam_batch_calls_and_merges_equal_jax(bam_batches, clip):
    """The batch decode_and_call calls, and its mates, through the twins
    and through the host: the same calls and merged pairs, equal to JAX's
    device entry points on the same matrices."""
    for chrom, kw in bam_batches:
        host = bam_columnar.decode_and_call(clip=clip, stats=ReadStats(),
                                            **kw)
        twin = bam_columnar.decode_and_call(
            clip=clip, stats=ReadStats(), device=torch.device("cpu"),
            chrom=chrom, **kw)
        for g, w in zip(twin, host):
            assert np.array_equal(g, w)
        chars, lens, sub_cols, _, _ = bam_columnar._decode(
            kw["buf"], kw["bufarr"], kw["cols"], kw["offs"], kw["idx_rows"],
            ReadStats())
        args = (sub_cols[:, 1].astype(np.int64) + 1,
                sub_cols[:, 2].astype(np.int64), True, kw["loci"],
                kw["site_base"], chars, lens)
        want = jcall.call_reads_device(*args, clip=clip)
        _same(host[:3], want)
        starts, patmat, span, qnames = host[:4]
        has = np.nonzero(starts >= 0)[0]
        _, inv = np.unique(qnames[has], return_inverse=True)
        order = np.argsort(inv, kind="stable")
        a, b = has[order][:-1], has[order][1:]
        pair = inv[order][:-1] == inv[order][1:]
        a, b = a[pair], b[pair]
        assert a.size > 100
        m = (starts[a], patmat[a], span[a], starts[b], patmat[b], span[b])
        got = calling.merge_pe_device(*m, device="cpu")
        _same(got, jcalling.merge_pe_mat(*m))
        _same(got, jcall.merge_pe_device(*m))


def test_wrappers_check_their_inputs():
    b = chip_smoke.call_edge_batch("random")
    args = list(_call_args(b))
    args[6] = args[6].copy()
    args[6][0] = args[5].shape[1] + 1
    with pytest.raises(ValueError, match="width"):
        calling.call_reads_device(*args, device="cpu")
    s1, p1, sp1, s2, p2, sp2 = chip_smoke.merge_edge_batch("random")
    sp1 = sp1.copy()
    sp1[0] = p1.shape[1] + 1
    with pytest.raises(ValueError, match="span"):
        calling.merge_pe_device(s1, p1, sp1, s2, p2, sp2, device="cpu")
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="lens"):
        calling.call_reads(torch.zeros((4, 8), dtype=torch.uint8),
                           z.to(torch.int64), z, z.to(torch.uint8), z, 0, 3)


def test_call_reads_paths_is_cuda_only():
    """The path counters are the kernel's: a CPU call that asks for them
    raises, one that does not takes the twin."""
    b = chip_smoke.call_edge_batch("sorted_tiles")
    pos1, lens, bottom, KB = calling.call_columns(
        b["positions"], b["flags"], b["paired"], b["seqmat"], b["lens"])
    cols = [torch.from_numpy(np.ascontiguousarray(a)) for a in (
        b["seqmat"], lens.astype(np.int32), pos1.astype(np.int32),
        bottom.astype(np.uint8), b["loci"])]
    paths = torch.zeros(len(calling.CALL_PATHS), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA only"):
        calling.call_reads(*cols, b["clip"], KB, paths=paths)
    assert paths.tolist() == [0] * len(calling.CALL_PATHS)
    got = calling.call_reads(*cols, b["clip"], KB)
    want = calling.call_reads_plain(*cols, b["clip"], KB)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_loci_stay_on_the_device_by_chromosome():
    """One upload a chromosome, whichever thread asks first and however
    often its view of the genome's loci is taken again; another genome's
    chromosome of the same name, number of loci and last locus gets its
    own loci, and the cache then holds that genome alone."""
    dev = torch.device("cpu")
    genome = np.arange(10, 5000, 7, dtype=np.int32)
    got = []

    def ask():
        got.append(calling.loci_device(genome[100:300], dev, "chr_cache"))

    threads = [threading.Thread(target=ask) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert all(t is got[0] for t in got)
    assert np.array_equal(got[0].numpy(), genome[100:300])
    # another chromosome of the same genome is its own entry, and both stay
    chr_b = calling.loci_device(genome[300:], dev, "chr_cache_b")
    assert np.array_equal(chr_b.numpy(), genome[300:])
    assert calling.loci_device(genome[100:300], dev, "chr_cache") is got[0]
    assert calling.loci_device(genome[300:], dev, "chr_cache_b") is chr_b
    # a shorter view under the same name is not the cached loci
    short = calling.loci_device(genome[100:299], dev, "chr_cache")
    assert np.array_equal(short.numpy(), genome[100:299])
    # another genome: same name, count and last locus, other loci between
    other = genome.copy()
    other[150:250] += 3
    assert (other[100:300].shape == genome[100:300].shape
            and other[299] == genome[299])
    t = calling.loci_device(other[100:300], dev, "chr_cache")
    assert np.array_equal(t.numpy(), other[100:300])
    assert not np.array_equal(t.numpy(), got[0].numpy())
    assert calling.loci_device(other[100:300], dev, "chr_cache") is t
    assert set(calling._LOCI) == {("chr_cache", "cpu")}
    # without a chromosome name nothing is kept
    assert calling.loci_device(other[100:300], dev) is not t


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.CALL_EDGE)
def test_cuda_call_reads_equals_twin(cuda_device, name):
    b = chip_smoke.call_edge_batch(name)
    args, clip = _call_args(b), b["clip"]
    before = calling.call_reads.launches
    got = calling.call_reads_device(*args, clip=clip, device=cuda_device)
    assert calling.call_reads.launches == before + 1
    _same(got, calling.call_reads_device(*args, clip=clip, device="cpu"))
    _same(got, jcalling.call_reads_mat(*args, clip=clip))


@pytest.mark.cuda
def test_cuda_call_reads_paths_and_long_body(cuda_device):
    """The kernel's own path counts on every edge, each launch == the
    twin: the edges of chip_smoke.EDGE_PATHS reach their paths and no
    other, and every path is reached."""
    reached = dict.fromkeys(calling.CALL_PATHS, 0)
    for name in chip_smoke.CALL_EDGE + ("long",):
        b = chip_smoke.call_long_batch() if name == "long" else \
            chip_smoke.call_edge_batch(name)
        pos1, lens, bottom, KB = calling.call_columns(
            b["positions"], b["flags"], b["paired"], b["seqmat"], b["lens"])
        cols = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
                for a in (b["seqmat"], lens.astype(np.int32),
                          pos1.astype(np.int32), bottom.astype(np.uint8),
                          b["loci"])]
        paths = torch.zeros(len(calling.CALL_PATHS), dtype=torch.int64,
                            device=cuda_device)
        got = calling.call_reads(*cols, b["clip"], KB, paths=paths)
        want = calling.call_reads_plain(*[c.cpu() for c in cols], b["clip"],
                                        KB)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        counts = dict(zip(calling.CALL_PATHS, paths.tolist()))
        if name in chip_smoke.EDGE_PATHS:
            assert {k for k, v in counts.items() if v} == \
                chip_smoke.EDGE_PATHS[name], (name, counts)
        reached = {k: reached[k] + counts[k] for k in reached}
    assert all(reached.values()), reached


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.MERGE_EDGE)
def test_cuda_merge_pe_equals_twin(cuda_device, name):
    b = chip_smoke.merge_edge_batch(name)
    assert chip_smoke.merge_body(b[1].shape[1], b[4].shape[1]) == \
        chip_smoke.MERGE_BODIES.get(name, "staged")
    before = calling.merge_pe.launches
    got = calling.merge_pe_device(*b, device=cuda_device)
    assert calling.merge_pe.launches == before + 1
    _same(got, calling.merge_pe_device(*b, device="cpu"))
    _same(got, jcalling.merge_pe_mat(*b))
