"""The port's own host layer (utils, native, formats, genome) equals the
JAX package's originals exactly, on seeded numpy inputs: the pat parser
and streams, the BGZF reader, writer, compressor and inflater, beta IO and
saturation, the host pileup (the device kernels' oracle), the v3 row
packer and placers (and the v3 staging's native prep against its numpy
prep), blocks beds and their .tbi, the genome's site count,
CpG index and region parsing, the CLI's file checks, exact segmentation's
host helpers (the ll table and the band sizes), and init_genome's host
code: the FASTA's CpG scan and chromosome rules, the reference files'
writers, the annotation queries and the bigWig writer and reader."""

import gzip
import io
import os
import os.path as op
import subprocess
import sys

import numpy as np
import pytest

from synth import random_frags
from test_torch_oracle_lib import oracle_lib
from wgbs_tools_tpu import native as jnat
from wgbs_tools_tpu.formats import bgzf as jbgzf
from wgbs_tools_tpu.formats import pat as jpat
from wgbs_tools_tpu.formats.beta import trim_to_uint as jax_trim
from wgbs_tools_tpu.genome.refdir import Genome as JaxGenome
from wgbs_tools_tpu.utils import IllegalArgumentError as JaxIllegalArgument
from wgbs_tools_tpu.utils import delete_or_skip as jax_delete_or_skip
from wgbs_tools_tpu.utils import splitextgz as jax_splitextgz
from wgbs_tools_tpu_torch import native as pnat
from wgbs_tools_tpu_torch import utils as putils
from wgbs_tools_tpu_torch.formats import bgzf as pbgzf
from wgbs_tools_tpu_torch.formats import pat as ppat
from wgbs_tools_tpu_torch.formats.beta import trim_to_uint
from wgbs_tools_tpu_torch.genome.refdir import Genome
from wgbs_tools_tpu_torch.ops import pileup_v3

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="the JAX package's native library "
                                       "(the reference) is unavailable")


def assert_same_frags(got, want):
    for field in ("start", "length", "count", "codes", "chrom_id"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a, b), field
    assert got.chrom_names == want.chrom_names
    if want.extras is None:
        assert got.extras is None
    else:
        assert got.extras.tolist() == want.extras.tolist()


def _frags(seed, n=3000, nr_sites=20000, chroms=1, **kw):
    f = random_frags(np.random.default_rng(seed), n, nr_sites, **kw)
    if chroms > 1:  # consecutive start ranges on consecutive chromosomes
        f.chrom_id = (f.start.astype(np.int64) * chroms // (nr_sites + 1)) \
            .astype(np.int16)
        f.chrom_names = [f"chr{i + 1}" for i in range(chroms)]
    return f


def _text(case):
    """pat text of a test case, written by the JAX package's serializer
    (extras and interleaved chromosomes by hand)."""
    if case == "plain":
        return jpat.frags_to_bytes(_frags(1, h_rate=0.05))
    if case == "chroms":
        return jpat.frags_to_bytes(_frags(2, chroms=3))
    if case == "big":  # > 4 MB: the parser's multithreaded path
        return jpat.frags_to_bytes(_frags(3, n=200_000, nr_sites=2_000_000,
                                          max_len=24))
    rng = np.random.default_rng(4)
    lines = []
    for i in range(400):
        chrom = ("chr2", "chr10", "chrX")[i % 7 % 3]  # a chromosome recurs
        pat = "".join(rng.choice(list("CTH."), size=int(rng.integers(1, 20))))
        line = f"{chrom}\t{100 + 3 * i}\t{pat}\t{int(rng.integers(1, 900))}"
        if case == "extras" and i % 3:
            line += f"\tXM:{i}\tqual{i % 5}"
        lines.append(line + "\n")
    return "".join(lines).encode()


@pytest.mark.parametrize("keep_extras", [True, False])
@pytest.mark.parametrize("case", ["plain", "chroms", "big", "extras",
                                  "mixed_chroms"])
def test_parse_pat_bytes_equals_jax(case, keep_extras):
    data = _text(case)
    want = jpat.parse_pat_bytes(data, keep_extras=keep_extras)
    got = ppat.parse_pat_bytes(data, keep_extras=keep_extras)
    assert want.nr_frags > 0 and got.nr_frags == want.nr_frags
    if case == "extras" and keep_extras:
        assert want.extras is not None
    if case in ("chroms", "mixed_chroms", "extras"):
        assert len(want.chrom_names) == 3
    assert_same_frags(got, want)


@pytest.mark.parametrize("line", [b"chr1\t5\tCTX\t1\n", b"chr1\t5\tCT\n",
                                  b"chr1\tx5\tCT\t1\n"])
def test_parse_pat_bytes_refuses_what_jax_refuses(line):
    """A line that the JAX package's parsers refuse raises here too, with
    the same error type (the port has no Python parser to fall back to)."""
    data = b"chr1\t1\tCC\t2\n" + line
    with pytest.raises(ValueError):
        jpat.parse_pat_bytes(data)
    with pytest.raises(putils.IllegalArgumentError):
        ppat.parse_pat_bytes(data)
    assert ppat.parse_pat_bytes(b"").nr_frags == 0


@pytest.fixture(scope="module")
def pat_files(tmp_path_factory):
    """One pat in four encodings, each written by the JAX package or the
    standard library: BGZF with a .cdx index, BGZF without it, plain gzip
    (one member, not BGZF) and uncompressed text."""
    d = tmp_path_factory.mktemp("host_pats")
    f = _frags(11, n=20_000, nr_sites=60_000, max_len=30, chroms=2)
    out = {"bgzf": str(d / "a.pat.gz"), "bgzf_noindex": str(d / "b.pat.gz"),
           "gzip": str(d / "c.pat.gz"), "text": str(d / "d.pat")}
    jpat.write_pat(f, out["bgzf"])
    jpat.write_pat(f, out["bgzf_noindex"], index=False)
    text = jpat.frags_to_bytes(f)
    with gzip.open(out["gzip"], "wb") as g:
        g.write(text)
    with open(out["text"], "wb") as g:
        g.write(text)
    assert os.path.isfile(out["bgzf"] + ".cdx")
    assert not os.path.isfile(out["bgzf_noindex"] + ".cdx")
    return out


@pytest.mark.parametrize("chunk_bytes", [30_000, 150_000, 32 << 20])
@pytest.mark.parametrize("kind", ["bgzf", "gzip", "text"])
def test_iter_pat_slabs_equal_jax(pat_files, kind, chunk_bytes):
    want = list(jpat.iter_pat(pat_files[kind], chunk_bytes=chunk_bytes))
    got = list(ppat.iter_pat(pat_files[kind], chunk_bytes=chunk_bytes))
    assert len(got) == len(want) >= 1
    if chunk_bytes == 30_000:
        assert len(want) > 3
    for g, w in zip(got, want):
        assert_same_frags(g, w)


@pytest.mark.parametrize("region", [(1, 60_001), (1, 500), (17_000, 17_031),
                                    (29_990, 45_000), (59_000, 80_000)])
@pytest.mark.parametrize("kind", ["bgzf", "bgzf_noindex"])
def test_iter_pat_region_equals_jax(pat_files, kind, region):
    """With the .cdx index (seek, then BgzfReader lines) and without it
    (the whole stream, filtered per slab); slabs small enough that a
    region spans several."""
    want = list(jpat.iter_pat_region(pat_files[kind], region,
                                     chunk_bytes=40_000))
    got = list(ppat.iter_pat_region(pat_files[kind], region,
                                    chunk_bytes=40_000))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert_same_frags(g, w)
    ix = ppat.load_pat_index(pat_files[kind])
    jix = jpat.load_pat_index(pat_files[kind])
    if kind == "bgzf":
        assert all(np.array_equal(a, b) for a, b in zip(ix, jix))
    else:
        assert ix is None and jix is None


def test_bgzf_reader_and_inflater_equal_jax(pat_files):
    path = pat_files["bgzf"]
    assert pbgzf.is_gzip(path) and not pbgzf.is_gzip(pat_files["text"])
    _, voffs, _ = jpat.load_pat_index(path)
    for voff in voffs[::3].tolist() + [int(voffs[-1])]:
        with pbgzf.BgzfReader(path) as r, jbgzf.BgzfReader(path) as j:
            r.seek_virtual(voff)
            j.seek_virtual(voff)
            for _ in range(50):
                line = r.readline()
                assert line == j.readline()
    raw = open(path, "rb").read()
    assert pnat.bgzf_decompress_native(raw, n_threads=3) == \
        jnat.bgzf_decompress_native(raw, n_threads=3)
    gz = open(pat_files["gzip"], "rb").read()
    assert pnat.bgzf_decompress_native(gz) is None
    assert jnat.bgzf_decompress_native(gz) is None
    end = ppat._last_block_end(raw[:100_000])
    assert 0 < end == jpat._last_block_end(raw[:100_000]) <= 100_000


@pytest.mark.parametrize("lbeta", [False, True])
def test_trim_to_uint_equals_jax(lbeta):
    """At the saturation edges: coverage max - 1, max, max + 1, far above;
    meth 0 and meth == cov; then random counts across the edge."""
    m = 65535 if lbeta else 255
    edges = np.array([[0, 0], [m - 1, m - 1], [m, m], [m + 1, m + 1],
                      [0, m + 1], [1, m + 1], [m, m + 1], [7, 3 * m],
                      [2**31 - 2, 2**31 - 1], [1, 2**40]], dtype=np.int64)
    rng = np.random.default_rng(5 + lbeta)
    cov = rng.integers(0, 3 * m, size=5000)
    rand = np.stack([rng.integers(0, cov + 1), cov], axis=1)
    for data in (edges, rand):
        got, want = trim_to_uint(data, lbeta), jax_trim(data, lbeta)
        assert got.dtype == want.dtype == (np.uint16 if lbeta else np.uint8)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("threads", [1, 4])
@pytest.mark.parametrize("window", [(1, 30_000), (4_000, 9_000)])
def test_pileup_native_equals_jax(threads, window):
    """The oracle of the device kernels, and its add into a given total.
    70,000 fragments: above the 2^16 threshold of the threaded path."""
    f = _frags(21, n=70_000, nr_sites=30_000, max_len=40, max_count=3000)
    ws, n = window
    kw = dict(threads=threads)
    want = jnat.pileup_native(f.start, f.length, f.count, f.codes, ws, n, **kw)
    got = pnat.pileup_native(f.start, f.length, f.count, f.codes, ws, n, **kw)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert want[:, 1].sum() > 0
    out = np.ones((n, 2), np.int64)
    pnat.pileup_native(f.start, f.length, f.count, f.codes, ws, n, out=out,
                       **kw)
    assert np.array_equal(out, want + 1)


def _pieces(seed, n=4000):
    """Pieces as stage_v3 makes them: grouped by ascending sub-block g,
    each inside its sub-block ([rr, rr + len) within 128 lanes), with the
    codes they are cut from."""
    rng = np.random.default_rng(seed)
    g = np.sort(rng.integers(0, n // 10, size=n)).astype(np.int32)
    rr = rng.integers(0, 128, size=n).astype(np.int32)
    ln = np.minimum(rng.integers(1, 30, size=n), 128 - rr).astype(np.int32)
    cnt = rng.integers(1, 6, size=n).astype(np.int32)  # few: rows shared
    codes = rng.integers(0, 4, size=(n, 40)).astype(np.uint8)
    src = rng.permutation(n).astype(np.int64)
    off = rng.integers(0, 40 - ln + 1).astype(np.int64)
    return g, cnt, rr, ln, codes, src, off


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_and_place_equal_jax(seed):
    """pack_rows_native, then place_vals / place_pack / place_counts on its
    rows: every output array equal to the JAX package's."""
    g, cnt, rr, ln, codes, src, off = _pieces(seed)
    want = jnat.pack_rows_native(g, cnt, rr, ln)
    got = pnat.pack_rows_native(g, cnt, rr, ln)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    piece_row, row_g, _ = got
    R = row_g.shape[0]
    assert 0 < R < g.shape[0]  # pieces share rows
    args = (codes, src, off, rr, ln)
    planes = {}
    for mod in (pnat, jnat):
        mv, cv = np.zeros((R, 128), np.uint8), np.zeros((R, 128), np.uint8)
        words = np.full((R, 8), -1, np.int32)
        cnts = np.zeros((R, 32), np.int32)
        assert mod.place_vals_native(*args, cnt, piece_row, mv, cv) == len(g)
        assert mod.place_pack_native(*args, piece_row, words) == len(g)
        assert mod.place_counts_native(cnt, rr, ln, piece_row, cnts) == len(g)
        planes[mod] = (mv, cv, words, cnts)
    for a, b in zip(planes[pnat], planes[jnat]):
        assert np.array_equal(a, b)
    assert planes[pnat][0].any() and planes[pnat][3].any()


def test_pack_and_place_refuse_what_jax_refuses():
    """None, as in the JAX package, for pieces not grouped by sub-block
    and for a count above 255 in the value and count placers."""
    g, cnt, rr, ln, codes, src, off = _pieces(7, n=300)
    bad_g = g[::-1].copy()
    assert pnat.pack_rows_native(bad_g, cnt, rr, ln) is None
    assert jnat.pack_rows_native(bad_g, cnt, rr, ln) is None
    piece_row, row_g, _ = pnat.pack_rows_native(g, cnt, rr, ln)
    big = cnt.copy()
    big[5] = 256
    R = row_g.shape[0]
    for mod in (pnat, jnat):
        mv, cv = np.zeros((R, 128), np.uint8), np.zeros((R, 128), np.uint8)
        assert mod.place_vals_native(codes, src, off, rr, ln, big, piece_row,
                                     mv, cv) is None
        assert mod.place_counts_native(big, rr, ln, piece_row,
                                       np.zeros((R, 32), np.int32)) is None


def _numpy_pieces(start, length, count, codes, window_start, window_len):
    """stage_v3's numpy prep before the native pass: _prep_window, then the
    split at sub-block boundaries and its stable sort by g. Returns the
    pieces, each with its codes cut out: (g, rr, len, cnt, piece codes
    (P, 128), '.' past each piece's end)."""
    rel, length, count, codes = pileup_v3._prep_window(
        start, length, count, codes, window_start, window_len)
    F = rel.shape[0]
    rr, g = rel % 128, rel // 128
    len1 = np.minimum(length, 128 - rr)
    len2 = length - len1
    has2 = len2 > 0
    p_g = np.concatenate([g, g[has2] + 1])
    p_rr = np.concatenate([rr, np.zeros(int(has2.sum()), np.int64)])
    p_len = np.concatenate([len1, len2[has2]])
    p_cnt = np.concatenate([count, count[has2]])
    p_src = np.concatenate([np.arange(F), np.nonzero(has2)[0]])
    p_off = np.concatenate([np.zeros(F, np.int64), len1[has2]])
    order = np.argsort(p_g, kind="stable")
    cut = _cut(codes, p_src[order], p_off[order], p_len[order])
    return p_g[order], p_rr[order], p_len[order], p_cnt[order], cut


def _cut(codes, src, off, ln):
    """codes[src, off : off + ln] of each piece into a '.'-padded (P, 128)
    array."""
    col = np.arange(128)
    inside = col[None, :] < ln[:, None]
    at = np.where(inside, off[:, None] + col[None, :], 0)
    return np.where(inside, codes[src[:, None], at], 3).astype(np.uint8)


def _prep_batch(seed):
    """Unsorted lines of 0-700 sites (a third over 128, a few of none),
    and two long lines that the window's left edge (3000) cuts in their
    second and third 128-site pieces."""
    rng = np.random.default_rng(seed)
    n = 600
    length = np.concatenate([rng.integers(1, 701, n), [400, 500]])
    length[rng.choice(n, 4, replace=False)] = 0
    start = np.concatenate([rng.integers(1, 9000, n),
                            [3000 - 128 - 40, 3000 - 256 - 7]])
    width = int(length.max())
    codes = rng.integers(0, 4, (n + 2, width)).astype(np.uint8)
    count = rng.integers(1, 300, n + 2)
    return (start.astype(np.int32), length.astype(np.int32),
            count.astype(np.int32), codes)


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("window", [(1, 9800), (3000, 4096)])
@pytest.mark.parametrize("seed", [0, 1])
def test_stage_prep_equals_numpy_prep(seed, window, threads):
    """native.stage_prep_native's pieces equal stage_v3's numpy prep and
    piece split, piece for piece, on one thread or several; their codes,
    read through p_src / p_off in the caller's codes, equal the numpy
    prep's copied rows."""
    start, length, count, codes = _prep_batch(seed)
    got = pnat.stage_prep_native(start, length, count, codes, *window,
                                 threads=threads)
    p_g, p_rr, p_len, p_cnt, p_src, p_off, n_split = got
    assert all(a.dtype == np.int32 for a in got[:6])
    want = _numpy_pieces(start, length, count, codes, *window)
    for a, b in zip((p_g, p_rr, p_len, p_cnt), want[:4]):
        assert np.array_equal(a, b)
    assert np.array_equal(_cut(codes, p_src, p_off, p_len), want[4])
    long = length[length > 128]
    assert n_split == int(((long + 127) // 128).sum()) > 0
    # a line of no site makes an empty piece, unless the clip shortened a
    # line
    assert (p_rr + p_len <= 128).all() and (p_len >= 0).all()
    assert (p_len == 0).any() == (window[0] == 1)


def test_stage_prep_refuses_bad_lines():
    """None, as the placers' wrappers refuse theirs, for a negative length
    and for codes narrower than a line; an empty batch has no pieces; arrays
    of different lengths raise."""
    start, length, count, codes = _prep_batch(3)
    bad = length.copy()
    bad[7] = -1
    assert pnat.stage_prep_native(start, bad, count, codes, 1, 9800) is None
    assert pnat.stage_prep_native(start, length, count, codes[:, :600], 1,
                                  9800) is None
    got = pnat.stage_prep_native(start[:0], length[:0], count[:0],
                                 codes[:0], 1, 9800)
    assert all(a.size == 0 for a in got[:6]) and got[6] == 0
    with pytest.raises(ValueError, match="as many"):
        pnat.stage_prep_native(start, length[:-1], count, codes, 1, 9800)


def test_genome_nr_sites_equals_jax(mini_genome):
    """The CpG site count of a reference made by init_genome, by name and
    through the default link; unknown names raise as in the JAX package."""
    assert Genome("mini").get_nr_sites() == mini_genome.get_nr_sites() > 0
    assert Genome(None).get_nr_sites() == JaxGenome(None).get_nr_sites()
    assert Genome(None).name == JaxGenome(None).name == "mini"
    with pytest.raises(JaxIllegalArgument):
        JaxGenome("no_such_genome")
    with pytest.raises(putils.IllegalArgumentError, match="Invalid reference"):
        Genome("no_such_genome")


def test_utils_equal_jax(tmp_path, capsys):
    for name in ("a.pat.gz", "x/y.beta", "b.lbeta", "c.tar.gz", "plain", ".gz"):
        assert putils.splitextgz(name) == jax_splitextgz(name)
    out = tmp_path / "o.beta"
    for mod_delete in (putils.delete_or_skip, jax_delete_or_skip):
        out.write_bytes(b"x")
        (tmp_path / "o.beta.cdx").write_bytes(b"x")
        assert mod_delete(str(out), False) is False
        assert "already exists" in capsys.readouterr().err
        assert mod_delete(str(out), True) is True
        assert not out.exists() and not (tmp_path / "o.beta.cdx").exists()
        assert mod_delete(str(out), False) is True
    out.write_bytes(b"x")
    assert putils.validate_single_file(str(out)) == str(out)
    with pytest.raises(putils.IllegalArgumentError, match="No such file"):
        putils.validate_single_file(str(tmp_path / "missing.pat.gz"))
    with pytest.raises(putils.IllegalArgumentError, match="must end with"):
        putils.validate_single_file(str(out), ".pat.gz")


def test_pretty_name_and_mkdirp_equal_jax(tmp_path):
    from wgbs_tools_tpu.utils import mkdirp as jax_mkdirp
    from wgbs_tools_tpu.utils import pretty_name as jax_pretty_name

    for name in ("a.pat.gz", "x/y.beta", "/p/q/b.lbeta", "c.tar.gz", "plain",
                 "d.uxm", "e.uxm.bed.gz"):
        assert putils.pretty_name(name) == jax_pretty_name(name)
    for mk, who in ((putils.mkdirp, "p"), (jax_mkdirp, "j")):
        d = str(tmp_path / who / "a" / "b")
        assert mk(d) == d and op.isdir(d)
        assert mk(d) == d  # exists already
        assert mk("") == "" and mk(None) is None


def test_beta2vec_equals_jax():
    from wgbs_tools_tpu.formats.beta import beta2vec as jax_beta2vec
    from wgbs_tools_tpu_torch.formats.beta import beta2vec

    rng = np.random.default_rng(14)
    cov = rng.integers(0, 12, size=3000)
    data = np.stack([rng.integers(0, cov + 1), cov], axis=1)
    for min_cov in (1, 4):
        for na in (np.nan, -1.0):
            got = beta2vec(data, min_cov=min_cov, na=na)
            want = jax_beta2vec(data, min_cov=min_cov, na=na)
            assert got.dtype == want.dtype
            assert np.array_equal(got, want, equal_nan=True)


@pytest.mark.parametrize("case", ["nice", "na", "empty_block", "unsorted",
                                  "ends_unsorted", "duplicate", "overlap",
                                  "one"])
def test_is_block_file_nice_equals_jax(case):
    from wgbs_tools_tpu.formats.blocks import is_block_file_nice as jax_nice
    from wgbs_tools_tpu_torch.formats.blocks import is_block_file_nice

    s = np.arange(1, 400, 4, dtype=np.int64)
    e = s + 3
    if case == "na":
        s[7] = e[7] = -1
    elif case == "empty_block":
        e[3] = s[3]
    elif case == "unsorted":
        s[[4, 5]] = s[[5, 4]]
    elif case == "ends_unsorted":
        e[10] = e[11] + 1
    elif case == "duplicate":
        s[6], e[6] = s[5], e[5]
    elif case == "overlap":
        e[8] = s[9] + 1
    elif case == "one":
        s, e = s[:1], e[:1]
    blocks = {"startCpG": s, "endCpG": e}
    got = is_block_file_nice(blocks)
    assert got == jax_nice(blocks)
    assert got[0] == (case in ("nice", "one"))


# ---------------------------------------------------------------------------
# the host copies that segment reads: file checks, beta IO, BGZF writer and
# compressor, blocks bed, .tbi, CpGIndex, GenomicRegion
# ---------------------------------------------------------------------------


def test_validate_file_list_equals_jax(tmp_path):
    from wgbs_tools_tpu.utils import validate_file_list as jax_vfl

    a, b = tmp_path / "a.beta", tmp_path / "b.beta"
    a.write_bytes(b"xx")
    b.write_bytes(b"xx")
    (tmp_path / "c.lbeta").write_bytes(b"xx")
    good = [str(a), str(b)]
    assert putils.validate_file_list(good) is None
    assert jax_vfl(good) is None
    for bad in ([], ["a"], [str(a), str(tmp_path / "c.lbeta")],
                [str(a), str(tmp_path / "missing.beta")]):
        with pytest.raises(JaxIllegalArgument) as je:
            jax_vfl(bad)
        with pytest.raises(putils.IllegalArgumentError) as pe:
            putils.validate_file_list(bad)
        assert str(pe.value) == str(je.value)
    with pytest.raises(putils.IllegalArgumentError, match="must end with"):
        putils.validate_file_list(good, force_suff=".lbeta")


@pytest.mark.parametrize("suffix", [".beta", ".lbeta", ".bin"])
def test_beta_io_equals_jax(tmp_path, suffix):
    from wgbs_tools_tpu.formats import beta as jbeta
    from wgbs_tools_tpu_torch.formats import beta as pbeta

    rng = np.random.default_rng(9)
    cov = rng.integers(0, 70_000 if suffix == ".lbeta" else 400, size=5000)
    data = np.stack([rng.integers(0, cov + 1), cov], axis=1)
    pj, pp = str(tmp_path / ("j" + suffix)), str(tmp_path / ("p" + suffix))
    jbeta.save_beta(pj, data)
    pbeta.save_beta(pp, data)
    assert open(pp, "rb").read() == open(pj, "rb").read()
    assert pbeta.beta_dtype(pp) == jbeta.beta_dtype(pj)
    for sites in (None, (1, 5001), (17, 18), (1234, 4321)):
        got, want = pbeta.load_beta(pp, sites), jbeta.load_beta(pj, sites)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    assert pbeta.beta_sanity_check(pp, 5000) and jbeta.beta_sanity_check(pj,
                                                                         5000)
    assert not pbeta.beta_sanity_check(pp, 4999)
    with pytest.raises(putils.IllegalArgumentError, match="Invalid beta"):
        pbeta.load_beta(str(tmp_path / "x.txt"))


def test_bgzf_writer_and_compressor_equal_jax():
    from wgbs_tools_tpu.formats.pat import _bgzf_block_table as jax_table

    rng = np.random.default_rng(12)
    text = b"".join(b"chr1\t%d\t%d\t%d\t%d\n" % tuple(rng.integers(0, 10**6, 4))
                    for _ in range(30_000))
    for data in (b"", b"x", text):
        for level in (1, 6):
            got = pnat.bgzf_compress_native(data, n_threads=3, level=level)
            assert got == jnat.bgzf_compress_native(data, n_threads=3,
                                                    level=level)
            assert gzip.decompress(got) == data
            wj, wp = io.BytesIO(), io.BytesIO()
            with jbgzf.BgzfWriter(wj, level=level) as w:
                w.write(data)
            with pbgzf.BgzfWriter(wp, level=level) as w:
                w.write(data)
            assert wp.getvalue() == wj.getvalue()
    comp = pnat.bgzf_compress_native(text)
    for a, b in zip(ppat._bgzf_block_table(comp), jax_table(comp)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.fixture
def blocks_bed(tmp_path):
    """A blocks bed over three chromosomes with a header, a comment, an NA
    row and rows out of startCpG order."""
    rows = ["#comment", "chr\tstart\tend\tstartCpG\tendCpG"]
    rng = np.random.default_rng(13)
    s = 1
    for i in range(4000):
        e = s + int(rng.integers(1, 9))
        chrom = ("chr1", "chr2", "chrX")[i * 3 // 4000]
        rows.append(f"{chrom}\t{10 * s}\t{10 * e}\t{s}\t{e}")
        s = e
    rows.insert(50, "chr1\t5\t7\tNA\tNA")
    rows[100], rows[101] = rows[101], rows[100]
    path = tmp_path / "b.bed"
    path.write_text("\n".join(rows) + "\n")
    return path


def test_blocks_bed_io_equals_jax(tmp_path, blocks_bed):
    from wgbs_tools_tpu.formats import blocks as jblocks
    from wgbs_tools_tpu_torch.formats import blocks as pblocks

    got = pblocks.load_blocks(str(blocks_bed))
    want = jblocks.load_blocks(str(blocks_bed))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert (got["startCpG"] == -1).sum() == 1
    small = {k: v[:40] for k, v in got.items()}
    for name in ("w.bed", "w.bed.gz"):
        a = pblocks.write_blocks(small, str(tmp_path / ("p" + name)))
        b = jblocks.write_blocks(small, str(tmp_path / ("j" + name)))
        assert open(a, "rb").read() == open(b, "rb").read()
    assert pblocks.load_blocks(str(tmp_path / "pw.bed.gz"),
                               nrows=7)["endCpG"].tolist() == \
        small["endCpG"][:7].tolist()


def _bed_rows(n=300, seed=21):
    """n wgbstools bed rows (no line ends) over two chromosomes."""
    rng = np.random.default_rng(seed)
    e = np.cumsum(rng.integers(1, 9, size=n)) + 1
    s = np.concatenate([[1], e[:-1]])
    return [f"{'chr1' if i < n // 2 else 'chrX'}\t{10 * a}\t{10 * b}\t{a}"
            f"\t{b}".encode() for i, (a, b) in enumerate(zip(s, e))]


def _bed_form(form):
    """(file bytes, nrows, gz) of a blocks bed in form `form`."""
    rows = _bed_rows()
    nrows, gz = None, False
    if form == "gz":
        gz = True
    elif form == "header":
        rows.insert(0, b"chr\tstart\tend\tstartCpG\tendCpG")
        rows.insert(120, b"chr\tstart\tend\tstartCpG\tendCpG")
    elif form == "comments":
        rows[0:0] = [b"#a comment", b"#\tx\ty"]
        rows.insert(77, b"# mid-file")
    elif form == "blank_lines":
        rows[0:0] = [b""]
        rows.insert(40, b"")
        rows.insert(41, b"")
    elif form == "na_nan":
        for i, tok in ((3, b"NA"), (9, b"NaN"), (15, b"nan"), (21, b"")):
            t = rows[i].split(b"\t")
            rows[i] = b"\t".join(t[:3] + [tok, tok])
    elif form == "more_columns":
        rows = [r + b"\t0.5\tx\t" for r in rows]
    elif form == "nrows":
        nrows = 117
        rows.insert(200, b"chr1\t5\t6")  # past nrows: never read
    elif form == "crlf":
        rows = [r + b"\r" for r in rows]
    elif form == "odd_tokens":  # the loop's int() and strip() on these
        rows[5] = b"chr1\t50\t +60 \t 5\t6 "
        rows[6] = b"chr1\t60\t7_0\t0006\t\tNA"
        rows[7] = b"chr1\t" + b"0" * 12 + b"1234567\t1\t2\t3"  # 19 digits
    elif form == "short_line":
        rows.insert(150, b"chr1\t5\t6\t7")
    elif form == "bad_int":
        rows[30] = b"chr1\t10\tx\t1\t2"
    elif form == "non_utf8":
        rows[40] = b"\xffchr\t10\t20\t1\t2"
    data = b"\n".join(rows) + b"\n"
    return (gzip.compress(data) if gz else data), nrows, gz


BED_FORMS = ("gz", "header", "comments", "blank_lines", "na_nan",
             "more_columns", "nrows", "crlf", "odd_tokens", "short_line",
             "bad_int", "non_utf8")


@pytest.mark.parametrize("form", BED_FORMS)
def test_load_blocks_forms_equal_jax(tmp_path, form):
    """The one-pass load_blocks on each bed form: JAX's line loop's arrays
    and dtypes, or its error (type and message)."""
    from wgbs_tools_tpu.formats import blocks as jblocks
    from wgbs_tools_tpu_torch.formats import blocks as pblocks

    data, nrows, gz = _bed_form(form)
    path = str(tmp_path / ("b.bed.gz" if gz else "b.bed"))
    with open(path, "wb") as f:
        f.write(data)
    outcome = []
    for mod in (jblocks, pblocks):  # the result, or the error's name and text
        try:
            outcome.append(mod.load_blocks(path, nrows=nrows))
        except Exception as e:  # noqa: BLE001 (compared by name and text)
            outcome.append((type(e).__name__, str(e)))
    want, got = outcome
    if isinstance(want, tuple):
        assert got == want
        assert form in ("short_line", "bad_int", "non_utf8")
        return
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert np.array_equal(got[k], want[k]), k
    assert len(want["start"]) == (117 if form == "nrows" else 300)


@pytest.mark.parametrize("form", ["plain", "gzip", "bgzf"])
def test_index_bed_equals_jax(tmp_path, blocks_bed, form):
    """bgzip + .tbi of a blocks bed (unsorted rows, comment, header, NA),
    from plain text, plain gzip and BGZF input: the same bytes."""
    from wgbs_tools_tpu.formats import blocks as jblocks
    from wgbs_tools_tpu_torch.formats import blocks as pblocks

    text = blocks_bed.read_bytes()
    out = {}
    for who, mod in (("j", jblocks), ("p", pblocks)):
        d = tmp_path / who
        d.mkdir()
        path = d / ("b.bed" if form == "plain" else "b.bed.gz")
        if form == "plain":
            path.write_bytes(text)
        elif form == "gzip":
            path.write_bytes(gzip.compress(text))
        else:
            path.write_bytes(jnat.bgzf_compress_native(text))
        out[who] = mod.index_bed(str(path))
        assert out[who].endswith(".gz")
        assert not (d / "b.bed").exists()
    for suff in ("", ".tbi"):
        assert (open(out["p"] + suff, "rb").read()
                == open(out["j"] + suff, "rb").read()), suff


def test_write_tbi_and_reg2bin_equal_jax(tmp_path):
    from wgbs_tools_tpu.formats import csi as jcsi
    from wgbs_tools_tpu_torch.formats import csi as pcsi

    rng = np.random.default_rng(14)
    beg = rng.integers(0, 3 << 26, size=5000)
    end = beg + rng.integers(1, 1 << 18, size=5000)
    assert np.array_equal(pcsi.reg2bin(beg, end), jcsi.reg2bin(beg, end))
    n = 6000
    cids = np.repeat([0, 1, 2], n // 3)
    begs = np.sort(rng.integers(0, 5 << 20, size=n)) \
        + (np.arange(n) % 7) * 100
    ends = begs + rng.integers(2, 90_000, size=n)
    voffs = np.cumsum(rng.integers(20, 3000, size=n + 1)).astype(np.uint64)
    args = (["chr1", "chr2", "chrX"], cids, begs, ends, voffs[:-1], voffs[1:])
    a = pcsi.write_tbi(str(tmp_path / "p.tbi"), *args)
    b = jcsi.write_tbi(str(tmp_path / "j.tbi"), *args)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert jcsi.read_tbi(a)["names"] == ["chr1", "chr2", "chrX"]


def test_cpg_index_and_region_equal_jax(mini_genome):
    """Genome.index, CpGIndex's translations, sites_blocks and
    GenomicRegion's parsing (-r, -s, whole genome, the errors)."""
    from wgbs_tools_tpu.formats.blocks import sites_blocks as jax_sb
    from wgbs_tools_tpu.genome.region import GenomicRegion as JaxRegion
    from wgbs_tools_tpu_torch.formats.blocks import sites_blocks
    from wgbs_tools_tpu_torch.genome.region import GenomicRegion

    g, jg = Genome("mini"), JaxGenome("mini")
    idx, jidx = g.index, jg.index
    for k in ("loci", "chrom_offsets", "chrom_sizes"):
        a, b = getattr(idx, k), getattr(jidx, k)
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert idx.chrom_names == jidx.chrom_names and idx.name == jidx.name
    assert g.get_chroms() == jg.get_chroms()
    assert idx.nr_sites == g.get_nr_sites() == jidx.nr_sites
    for c in idx.chrom_names:
        assert idx.chrom_site_bounds(c) == jidx.chrom_site_bounds(c)
        assert idx.chrom_nr_sites(c) == jidx.chrom_nr_sites(c)
        assert idx.chrom_size(c) == jidx.chrom_size(c)
        assert np.array_equal(idx.chrom_loci(c), jidx.chrom_loci(c))
    sites = np.arange(1, idx.nr_sites + 1)
    assert np.array_equal(idx.site2chrom_id(sites), jidx.site2chrom_id(sites))
    for s in (1, 77, idx.nr_sites):
        assert idx.site2locus(s) == jidx.site2locus(s)
    assert idx.locus2site("chr2", 500) == jidx.locus2site("chr2", 500)
    assert idx.region2sites("chr1", 100, 9000) == \
        jidx.region2sites("chr1", 100, 9000)
    pairs = np.array([[1, 5], [5, 5], [40, idx.nr_sites + 1]])
    got, want = sites_blocks(idx, pairs), jax_sb(jidx, pairs)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    for kw in ({}, {"region": "chr1:2,000-40,000"}, {"region": "chr2"},
               {"region": f"chr1:{idx.loci[10]}"}, {"sites": "100-1500"},
               {"sites": "42"}):
        r, jr = GenomicRegion(genome=g, **kw), JaxRegion(genome=jg, **kw)
        assert (r.sites, r.chrom, r.region_str, r.bp_tuple, r.is_whole(),
                r.nr_sites) == (jr.sites, jr.chrom, jr.region_str,
                                jr.bp_tuple, jr.is_whole(), jr.nr_sites)
        assert str(r) == str(jr)
    for kw in ({"region": "chr9:1-100"}, {"region": "chr1:500-100"},
               {"region": "bad"}, {"sites": "0-5"},
               {"sites": f"5-{idx.nr_sites + 2}"}):
        with pytest.raises(JaxIllegalArgument) as je:
            JaxRegion(genome=jg, **kw)
        with pytest.raises(putils.IllegalArgumentError) as pe:
            GenomicRegion(genome=g, **kw)
        assert str(pe.value) == str(je.value)


# ---------------------------------------------------------------------------
# exact segmentation's host helpers (models/segment_exact_device.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("pc", [0.5, 1.0, 15.0])
def test_ll_table_equals_jax(pc):
    """build_ll_table bit for bit (numpy's libm log2 on both sides), and
    its one-table cache: a smaller cap reuses a larger cached table."""
    from wgbs_tools_tpu.models import segment_exact_tpu as jsx
    from wgbs_tools_tpu_torch.models import segment_exact_device as sed

    for cap in (64, 1024):
        jsx._TABLE_CACHE.clear()
        sed._TABLE_CACHE.clear()
        want, got = jsx.build_ll_table(pc, cap), sed.build_ll_table(pc, cap)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
        assert sed.build_ll_table(pc, cap // 2) is got
    assert (got <= 0).all() and not np.signbit(got[got == 0]).any()


def test_band_helpers_equal_jax():
    """max_band_width, _round_width, max_band_total and LL_CAP."""
    from wgbs_tools_tpu.models import segment_exact_tpu as jsx
    from wgbs_tools_tpu_torch.models import segment_exact_device as sed

    rng = np.random.default_rng(12)
    for n, K, step in ((300, 2, 60), (1000, 3, 20), (50, 1, 400)):
        data = rng.integers(0, 30, size=(K, n, 2))
        loci = np.cumsum(rng.integers(2, step, size=n)) + 100
        for W in (16, 128, 1000):
            for max_bp in (0, 500, 2000):
                assert sed.max_band_width(loci, W, max_bp) == \
                    jsx.max_band_width(loci, W, max_bp)
                assert sed.max_band_total(data, loci, W, max_bp) == \
                    jsx.max_band_total(data, loci, W, max_bp)
    for bw in (1, 127, 128, 129, 1000):
        assert sed._round_width(bw) == jsx._round_width(bw)
    assert sed.LL_CAP == jsx.LL_CAP
    r = subprocess.run([sys.executable, "-c",
                        "from wgbs_tools_tpu_torch.models import "
                        "segment_exact_device as s; print(s.LL_CAP)"],
                       env={**os.environ, "WGBS_TPU_LL_CAP": "512"},
                       capture_output=True, text=True, timeout=120,
                       cwd=op.dirname(op.dirname(op.abspath(__file__))))
    assert r.returncode == 0 and r.stdout.split() == ["512"], r.stderr


# ---------------------------------------------------------------------------
# bam2pat's host layer: the pat writers and indexes, the BAM scans and
# reader, the FASTA reader and the genome's bam2pat files
# ---------------------------------------------------------------------------


def _port_frags(f):
    return ppat.PatFrags(f.start, f.length, f.count, f.codes, f.chrom_id,
                         f.chrom_names, f.extras)


def _with_extras(f):
    f.extras = np.array([b"q%d" % i if i % 4 else None
                         for i in range(f.nr_frags)], dtype=object)
    return f


@pytest.mark.parametrize("case", ["plain", "chroms", "extras"])
def test_frags_to_bytes_and_serializer_equal_jax(case):
    f = _frags(11, chroms=3 if case == "chroms" else 1, h_rate=0.05)
    if case == "extras":
        f = _with_extras(f)
    else:
        assert pnat.serialize_pat_native(
            f.start, f.length, f.count, f.codes, f.chrom_id,
            f.chrom_names) == jnat.serialize_pat_native(
            f.start, f.length, f.count, f.codes, f.chrom_id, f.chrom_names)
    assert ppat.frags_to_bytes(_port_frags(f)) == jpat.frags_to_bytes(f)


@pytest.mark.parametrize("extras", [False, True])
def test_sort_collapse_and_packing_equal_jax(extras):
    rng = np.random.default_rng(12)
    f = _frags(12, n=4000, nr_sites=300, max_len=4)
    perm = rng.permutation(f.nr_frags)
    f = f.take(np.concatenate([perm, perm[:1000]]))  # unsorted, repeats
    if extras:
        f.extras = np.array([b"r%d" % (x % 2) for x in f.start.tolist()],
                            dtype=object)
    want = f.sort().collapse()
    got = _port_frags(f).sort().collapse()
    assert want.nr_frags < f.nr_frags
    assert_same_frags(got, want)
    assert np.array_equal(_port_frags(f).pattern_bytes(), f.pattern_bytes())
    assert np.array_equal(_port_frags(f).packed(), f.packed())
    assert np.array_equal(ppat.unpack_codes(f.packed(), f.max_len),
                          jpat.unpack_codes(f.packed(), f.max_len))


def _same_index(got, want):
    """A pat.gz's .cdx arrays (np.savez stamps its zip) and .csi bytes."""
    a, b = np.load(got + ".cdx"), np.load(want + ".cdx")
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        assert np.array_equal(a[k], b[k]), k
    with open(got + ".csi", "rb") as f1, open(want + ".csi", "rb") as f2:
        assert f1.read() == f2.read()


@pytest.mark.parametrize("case", ["plain", "chroms", "extras", "stride"])
def test_write_pat_and_index_pat_equal_jax(tmp_path, case):
    f = _frags(13, n=20_000, nr_sites=60_000,
               chroms=3 if case == "chroms" else 1)
    if case == "extras":
        f = _with_extras(f)
    stride = 100 if case == "stride" else jpat.INDEX_STRIDE
    got, want = str(tmp_path / "t.pat.gz"), str(tmp_path / "j.pat.gz")
    ppat.write_pat(_port_frags(f), got, stride=stride)
    jpat.write_pat(f, want, stride=stride)
    with open(got, "rb") as f1, open(want, "rb") as f2:
        assert f1.read() == f2.read()
    _same_index(got, want)
    # index_pat of the written file: the same sidecars again
    ppat.index_pat(got, stride=stride)
    jpat.index_pat(want, stride=stride)
    _same_index(got, want)


def test_pat_stream_writer_equals_jax(tmp_path):
    f = _frags(14, n=30_000, nr_sites=90_000, chroms=2)
    cuts = [0, 7_000, 7_001, 19_000, 30_000]
    paths = []
    for mod, who in ((ppat, "t"), (jpat, "j")):
        path = str(tmp_path / f"{who}.pat.gz")
        with mod.PatStreamWriter(path, stride=1000) as w:
            for a, b in zip(cuts[:-1], cuts[1:]):
                part = f.take(slice(a, b))
                w.write_frags(_port_frags(part) if mod is ppat else part)
        assert w.nr_frags == f.nr_frags
        paths.append(path)
    with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
        assert f1.read() == f2.read()
    _same_index(*paths)
    with pytest.raises(putils.IllegalArgumentError):
        w = ppat.PatStreamWriter(str(tmp_path / "bad.pat.gz"))
        w.write_frags(_port_frags(f.take(slice(10, 20))))
        w.write_frags(_port_frags(f.take(slice(0, 5))))
    w.abort()
    assert not op.exists(str(tmp_path / "bad.pat.gz"))


def test_csi_writers_equal_jax(tmp_path):
    from wgbs_tools_tpu.formats import csi as jcsi
    from wgbs_tools_tpu_torch.formats import csi as pcsi

    rng = np.random.default_rng(15)
    n = 5000
    ids = np.repeat([0, 1, 2], [2000, 1000, 2000]).astype(np.int32)
    begs = np.concatenate([np.sort(rng.integers(0, 10**7, k))
                           for k in (2000, 1000, 2000)])
    voffs = np.cumsum(rng.integers(1, 40, n + 1)).astype(np.int64) << 4
    names = ["chr1", "chr2", "chrX"]
    pcsi.write_csi(str(tmp_path / "t.csi"), names, ids, begs, voffs[:-1],
                   voffs[1:])
    jcsi.write_csi(str(tmp_path / "j.csi"), names, ids, begs, voffs[:-1],
                   voffs[1:])
    acc_p, acc_j = pcsi.CsiAccumulator(), jcsi.CsiAccumulator()
    for a, b in ((0, 1500), (1500, 3600), (3600, n)):
        for acc in (acc_p, acc_j):
            acc.add(ids[a:b], begs[a:b], voffs[a:b], voffs[a + 1:b + 1])
    acc_p.write(str(tmp_path / "ta.csi"), names)
    acc_j.write(str(tmp_path / "ja.csi"), names)
    for t, j in (("t.csi", "j.csi"), ("ta.csi", "ja.csi")):
        assert (tmp_path / t).read_bytes() == (tmp_path / j).read_bytes()


@pytest.fixture(scope="module")
def sim_bams(mini_genome, tmp_path_factory):
    from bisim import add_cigar_variants, dump_bam, simulate_reads
    from test_nanopore import dump_np_bam, simulate_np_reads
    from wgbs_tools_tpu.genome.cpg_index import read_fasta

    d = tmp_path_factory.mktemp("host_bams")
    rng = np.random.default_rng(16)
    seqs = read_fasta(mini_genome.join("genome.fa"))
    reads, _ = simulate_reads(seqs, rng, n_reads=300, paired=True)
    reads = add_cigar_variants(reads, seqs, rng, frac=0.3)
    nano = simulate_np_reads(seqs, rng, n_reads=60)
    return (dump_bam(reads, seqs, str(d / "pe.bam")),
            dump_np_bam(nano, seqs, str(d / "np.bam")))


def _bam_buf(path):
    with open(path, "rb") as f:
        buf = jnat.bgzf_decompress_native(f.read())
    from wgbs_tools_tpu.pipeline.bam import BamReader

    return buf, BamReader(path)._records_off


def test_bam_scans_equal_jax(sim_bams):
    for path in sim_bams:
        buf, off = _bam_buf(path)
        got, want = pnat.bam_scan_native(buf, off), jnat.bam_scan_native(
            buf, off)
        assert want[0].shape[0] > 50
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        cols, offs, rec_end = want
        mm = pnat.bam_mmml_scan_native(buf, offs[:, 4], rec_end)
        for a, b in zip(mm, jnat.bam_mmml_scan_native(buf, offs[:, 4],
                                                        rec_end)):
            assert np.array_equal(a, b)
        got = pnat.mm_parse_native(buf, mm[0], mm[1])
        want = jnat.mm_parse_native(buf, mm[0], mm[1])
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        if path.endswith("np.bam"):
            assert (mm[0] >= 0).all() and want[0].shape[0] >= 60


def test_bam_reader_and_tags_equal_jax(sim_bams):
    from wgbs_tools_tpu.pipeline import bam as jbam
    from wgbs_tools_tpu_torch.pipeline import bam as pbam

    for path in sim_bams:
        got, want = pbam.BamReader(path), jbam.BamReader(path)
        assert got.header_text == want.header_text
        assert (got.ref_names, got.ref_lengths) == (want.ref_names,
                                                    want.ref_lengths)
        recs = list(want)
        for a, b in zip(got, recs):
            for k in ("qname", "flag", "ref_id", "pos", "mapq", "cigar",
                      "seq", "qual", "tags"):
                assert getattr(a, k) == getattr(b, k), k
            for tag in ("MM", "ML", "RG"):
                assert a.get_tag(tag) == b.get_tag(tag)
        assert len(recs) > 50
        # the writer: the records written again, the same bytes
        pbam.write_bam(path + ".t", got.ref_names, got.ref_lengths, recs)
        jbam.write_bam(path + ".j", got.ref_names, got.ref_lengths, recs)
        with open(path + ".t", "rb") as f1, open(path + ".j", "rb") as f2:
            assert f1.read() == f2.read()


def test_fasta_outer_add_and_genome_files_equal_jax(mini_genome, tmp_path):
    from wgbs_tools_tpu.genome.cpg_index import read_fasta as jax_fasta
    from wgbs_tools_tpu.utils import outer_add as jax_outer_add
    from wgbs_tools_tpu_torch.genome.cpg_index import read_fasta

    fa = mini_genome.join("genome.fa")
    got, want = read_fasta(fa), jax_fasta(fa)
    assert list(got) == list(want)
    assert all(np.array_equal(got[c], want[c]) for c in want)
    gz = tmp_path / "g.fa.gz"
    gz.write_bytes(gzip.compress(b">c1 x\nacgTN\nCG\n>c2\nAAA\n"))
    got, want = read_fasta(str(gz)), jax_fasta(str(gz))
    assert list(got) == list(want) == ["c1", "c2"]
    assert all(np.array_equal(got[c], want[c]) for c in want)
    col = np.array([5, 0, 17, 3], np.int64)
    for dtype in (None, np.int32):
        a, b = putils.outer_add(col, 6, dtype), jax_outer_add(col, 6, dtype)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    g, jg = Genome("mini"), JaxGenome("mini")
    for name in ("genome.fa", "CpG.bed", "nothing.txt"):
        assert g.join(name) == jg.join(name)
    with pytest.raises(putils.IllegalArgumentError):
        g.join("nothing.txt", validate=True)
    assert (g.blacklist, g.whitelist) == (jg.blacklist, jg.whitelist)


def test_concat_frags_equals_jax():
    from wgbs_tools_tpu.cli.cmd_pat import _concat_frags as jax_concat
    from wgbs_tools_tpu_torch.cli.cmd_pat import _concat_frags

    parts = [_frags(17, n=300, max_len=5), _frags(18, n=200, chroms=2,
                                                  max_len=9)]
    parts[1] = _with_extras(parts[1])
    want = jax_concat(parts)
    assert_same_frags(_concat_frags([_port_frags(p) for p in parts]), want)


# ------------------------------------------------ the pat-stream host ops


def _blocks(seed, n, nr_sites=20000, overlapping=False):
    rng = np.random.default_rng(seed)
    s = np.sort(rng.integers(1, nr_sites, size=n)).astype(np.int64)
    if overlapping:
        e = s + rng.integers(1, 400, size=n)
    else:
        e = np.minimum(np.append(s[1:], nr_sites), s + rng.integers(1, 60,
                                                                    size=n))
        e = np.maximum(e, s + 1)
        s, e = s[e > s], e[e > s]
    return s, e


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("strip,min_cpgs,no_gaps",
                         [(False, 1, False), (True, 3, False),
                          (False, 2, True), (True, 1, True)])
@pytest.mark.parametrize("overlapping", [False, True])
def test_frag_filters_equal_jax(strict, strip, min_cpgs, no_gaps,
                                overlapping):
    """filter_by_blocks (and through it overlap_pairs, strip_frags,
    has_gaps and _pass_filters) equals JAX's on reads with '.' calls."""
    from wgbs_tools_tpu.ops import frag_ops as jops
    from wgbs_tools_tpu_torch.ops import frag_ops as pops

    f = _with_extras(_frags(40, n=2500, dot_rate=0.3, h_rate=0.05))
    bs, be = _blocks(41, 150, overlapping=overlapping)
    want = jops.filter_by_blocks(f, bs, be, strict=strict, strip=strip,
                                 min_cpgs=min_cpgs, no_gaps=no_gaps)
    got = pops.filter_by_blocks(_port_frags(f), bs, be, strict=strict,
                                strip=strip, min_cpgs=min_cpgs,
                                no_gaps=no_gaps)
    assert_same_frags(got, want)
    assert want.nr_frags > 50
    assert np.array_equal(pops.has_gaps(_port_frags(f)), jops.has_gaps(f))
    assert_same_frags(pops.strip_frags(_port_frags(f)), jops.strip_frags(f))


@pytest.mark.parametrize("rate,reps,seed", [(0.1, 1, 5), (0.25, 4, 6),
                                            (1.0, 1, 7)])
def test_sample_frags_equals_jax(rate, reps, seed):
    from wgbs_tools_tpu.ops.frag_ops import sample_frags as jax_sample
    from wgbs_tools_tpu_torch.ops.frag_ops import sample_frags

    f = _frags(42, n=3000, max_count=9)
    assert_same_frags(sample_frags(_port_frags(f), rate, reps=reps,
                                   seed=seed),
                      jax_sample(f, rate, reps=reps, seed=seed))
    with pytest.raises(putils.IllegalArgumentError):
        sample_frags(_port_frags(f), 1.5)


@pytest.mark.parametrize("overlapping", [False, True])
@pytest.mark.parametrize("strip", [True, False])
def test_mask_sites_equals_jax(overlapping, strip):
    from wgbs_tools_tpu.ops.frag_ops import mask_sites as jax_mask
    from wgbs_tools_tpu_torch.ops.frag_ops import mask_sites

    f = _with_extras(_frags(43, n=2000, max_len=20))
    bs, be = _blocks(44, 80, overlapping=overlapping)
    assert_same_frags(mask_sites(_port_frags(f), bs, be, strip=strip),
                      jax_mask(f, bs, be, strip=strip))


@pytest.mark.parametrize("kind", ["bgzf", "bgzf_noindex", "gzip", "text"])
@pytest.mark.parametrize("region", [None, (1, 60_001), (17_000, 17_031)])
def test_read_pat_equals_jax(pat_files, kind, region):
    path = pat_files[kind]
    for keep in (True, False):
        assert_same_frags(ppat.read_pat(path, region_sites=region,
                                        keep_extras=keep),
                          jpat.read_pat(path, region_sites=region,
                                        keep_extras=keep))


def test_merge_betas_equals_jax(tmp_path):
    from wgbs_tools_tpu.formats.beta import merge_betas as jax_merge
    from wgbs_tools_tpu_torch.formats.beta import merge_betas

    rng = np.random.default_rng(45)
    paths = []
    for k in range(3):
        p = tmp_path / f"b{k}.beta"
        rng.integers(0, 256, size=(500, 2)).astype(np.uint8).tofile(p)
        paths.append(str(p))
    for lbeta in (False, True):
        a, b = tmp_path / "a.out", tmp_path / "b.out"
        got = merge_betas(paths, str(a), lbeta)
        want = jax_merge(paths, str(b), lbeta)
        assert got.dtype == want.dtype and np.array_equal(got, want)
        assert a.read_bytes() == b.read_bytes()


def test_bimodal_equals_jax():
    from wgbs_tools_tpu.models import bimodal as jbi
    from wgbs_tools_tpu_torch.models import bimodal as pbi

    f = _frags(46, n=400, nr_sites=300, max_len=10, dot_rate=0.2)
    for start, end, strict, min_len in ((20, 60, True, 1), (1, 300, False, 3),
                                        (250, 290, True, 4)):
        a = pbi.frags_to_matrix(_port_frags(f), start, end, strict, min_len)
        b = jbi.frags_to_matrix(f, start, end, strict, min_len)
        assert np.array_equal(a, b)
        got = pbi.test_bimodal_region(_port_frags(f), start, end,
                                      max_iter=20, strict=strict,
                                      min_len=min_len)
        want = jbi.test_bimodal_region(f, start, end, max_iter=20,
                                       strict=strict, min_len=min_len)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k] == want[k] or (want[k] != want[k]
                                          and got[k] != got[k]), k


def test_shuffle_within_start_equals_jax():
    from wgbs_tools_tpu.cli.cmd_vis import _shuffle_within_start as jshuf
    from wgbs_tools_tpu_torch.cli.view import _shuffle_within_start

    f = _with_extras(_frags(47, n=900, nr_sites=60))
    for seed in (3, 11):
        assert_same_frags(_shuffle_within_start(_port_frags(f), seed),
                          jshuf(f, seed))


def test_array_id_equals_jax(mini_genome, tmp_path, monkeypatch):
    """GenomicRegion(array_id=...) through the genome's ilmn2CpG.tsv.gz,
    its refusals too."""
    from wgbs_tools_tpu.genome.region import GenomicRegion as JaxRegion
    from wgbs_tools_tpu.utils import IllegalArgumentError as JaxErr
    from wgbs_tools_tpu_torch.genome.region import GenomicRegion

    root = os.path.dirname(mini_genome.refdir)
    g = os.path.join(root, "mini_ilmn_host")
    os.makedirs(g, exist_ok=True)
    for f in os.listdir(mini_genome.refdir):
        if not os.path.lexists(os.path.join(g, f)):
            os.symlink(os.path.join(mini_genome.refdir, f),
                       os.path.join(g, f))
    with gzip.open(os.path.join(g, "ilmn2CpG.tsv.gz"), "wt") as f:
        f.write("cg00000001\t150\ncg00000002\t1200-1260\n")
    for aid in ("cg00000001", "cg00000002"):
        a = GenomicRegion(array_id=aid, genome=Genome("mini_ilmn_host"))
        b = JaxRegion(array_id=aid, genome=JaxGenome("mini_ilmn_host"))
        assert (a.sites, a.chrom, a.region_str, a.bp_tuple, str(a)) == (
            b.sites, b.chrom, b.region_str, b.bp_tuple, str(b))
    for aid, genome in (("cg00000009", "mini_ilmn_host"),
                        ("xx1", "mini_ilmn_host"), ("cg00000001", "mini")):
        with pytest.raises(JaxErr) as je:
            JaxRegion(array_id=aid, genome=JaxGenome(genome))
        with pytest.raises(putils.IllegalArgumentError) as pe:
            GenomicRegion(array_id=aid, genome=Genome(genome))
        assert str(pe.value) == str(je.value)


def test_snp_classify_and_yi_parse_equal_jax(sim_bams):
    """split_by_allele's per-read verdict and split_by_meth's YI parse equal
    JAX's on every record of the simulated BAMs, for each allele pair and
    quality gate."""
    from wgbs_tools_tpu.pipeline import bam_split as jsp
    from wgbs_tools_tpu.pipeline.bam import BamReader as JaxReader
    from wgbs_tools_tpu_torch.pipeline import bam_split as psp
    from wgbs_tools_tpu_torch.pipeline.bam import BamReader

    for path in sim_bams:
        precs = list(BamReader(path))
        jrecs = list(JaxReader(path))
        for k, (pr, jr) in enumerate(zip(precs, jrecs)):
            pos = pr.pos + 1 + (k % 90)
            for let in (("C", "T"), ("G", "A"), ("A", "C"), ("C", "G")):
                for q in (0, 30):
                    assert (psp._snp_classify(pr, pos, *let, q, k % 2 == 0)
                            == jsp._snp_classify(jr, pos, *let, q,
                                                 k % 2 == 0))
        assert len(precs) == len(jrecs) >= 60
    for tags in (b"YIZ3,4\x00", b"NMi\x01\x00\x00\x00YIZ0,12\x00",
                 b"YIZbad\x00", b"", None):
        assert psp._parse_yi(tags) == jsp._parse_yi(tags)


def test_marker_params_equal_jax(tmp_path):
    from wgbs_tools_tpu.models import markers as jm
    from wgbs_tools_tpu_torch.models import markers as pm

    cfg = tmp_path / "p.cfg"
    cfg.write_text("min_cov: 4 # cov\ndelta_means: 0.4\ntargets: A B\n"
                   "only_hyper: True\nsort_by: None\nname: x\n")
    assert pm._load_param_file(str(cfg)) == jm._load_param_file(str(cfg))
    a = pm.MarkerParams(config_file=str(cfg), top=3, header=False, pval=0.1)
    b = jm.MarkerParams(config_file=str(cfg), top=3, header=False, pval=0.1)
    assert a.as_dict() == b.as_dict()
    for bad in (dict(only_hyper=True, only_hypo=True), dict(pval=2.0),
                dict(delta_means=-3), dict(test_type="z")):
        with pytest.raises(putils.IllegalArgumentError):
            pm.MarkerParams(**bad)
        with pytest.raises(JaxIllegalArgument):
            jm.MarkerParams(**bad)


def test_bgzf_reader_reads_past_joined_parts(tmp_path):
    """Two BGZF files joined by byte append (bam2pat --procs's parts, each
    with its EOF block): the port's reader reads every line of both, from
    the start and from any line's virtual offset; JAX's stops at the first
    part's EOF block (a known divergence, ROADMAP section 3)."""
    f1 = _frags(50, n=3000, nr_sites=20000)
    f2 = _frags(51, n=2000, nr_sites=20000)
    f2.start = f2.start + 20000
    parts = []
    for k, f in enumerate((f1, f2)):
        p = tmp_path / f"p{k}.pat.gz"
        jpat.write_pat(f, str(p), index=False)
        parts.append(p.read_bytes())
    joined = tmp_path / "j.pat.gz"
    joined.write_bytes(b"".join(parts))
    want = jpat.frags_to_bytes(f1) + jpat.frags_to_bytes(f2)

    def lines(reader_cls, path):
        r = reader_cls(str(path))
        out, voffs = [], []
        while True:
            voffs.append(r.virtual_offset)
            ln = r.readline()
            if not ln:
                break
            out.append(ln)
        r.close()
        return out, voffs

    got, voffs = lines(pbgzf.BgzfReader, joined)
    assert b"".join(got) == want
    jgot, _ = lines(jbgzf.BgzfReader, joined)
    assert b"".join(jgot) == jpat.frags_to_bytes(f1)
    r = pbgzf.BgzfReader(str(joined))
    for k in (0, len(got) // 3, f1.nr_frags - 1, f1.nr_frags, len(got) - 1):
        r.seek_virtual(voffs[k])
        assert r.readline() == got[k]
    r.close()
    # the index of the joined file samples both parts
    ppat.index_pat(str(joined), stride=100)
    sites, _, _ = ppat.load_pat_index(str(joined))
    assert sites[-1] > 20000


@pytest.mark.parametrize("seed", [0, 1])
def test_cpg_scan_and_chromosome_rules_equal_jax(tmp_path, seed):
    from synth import make_fasta
    from wgbs_tools_tpu.genome import cpg_index as jidx
    from wgbs_tools_tpu_torch.genome import cpg_index as pidx

    rng = np.random.default_rng(seed)
    for n in (0, 1, 2, 3, 500):
        seq = rng.choice(np.frombuffer(b"ACGTN", np.uint8), n)
        seq[: min(n, 2)] = np.frombuffer(b"CG", np.uint8)[: min(n, 2)]
        a, b = pidx.find_cpg_loci(seq), jidx.find_cpg_loci(seq)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    names = ["chr1", "chr10", "chr2", "X", "chrY", "chrM", "MT", "chrUn_1",
             "chr1_alt", "7", "chrx", "chr01"]
    for c in names:
        assert pidx.is_valid_chrom(c) == jidx.is_valid_chrom(c), c
        assert pidx.chromosome_order(c) == jidx.chromosome_order(c), c
    fa = make_fasta(str(tmp_path / "g.fa"), {c: int(rng.integers(1, 900))
                                            for c in names}, rng)
    for kw in ({}, {"sort_chroms": False},
               {"chrom_filter": lambda c: c.startswith("chr")},
               {"name": "gg", "chrom_filter": lambda c: True}):
        a, b = pidx.build_from_fasta(fa, **kw), jidx.build_from_fasta(fa, **kw)
        assert a.chrom_names == b.chrom_names and a.name == b.name
        for field in ("loci", "chrom_offsets", "chrom_sizes"):
            x, y = getattr(a, field), getattr(b, field)
            assert x.dtype == y.dtype and np.array_equal(x, y), field


def test_annotations_equal_jax(mini_genome, tmp_path, monkeypatch):
    from wgbs_tools_tpu.genome import annotations as janno
    from wgbs_tools_tpu.genome.refdir import Genome as JGenome
    from wgbs_tools_tpu_torch.genome import annotations as panno

    rng = np.random.default_rng(44)
    g = tmp_path / "refs" / "ag"
    g.mkdir(parents=True)
    for f in os.listdir(mini_genome.refdir):
        os.symlink(op.join(mini_genome.refdir, f), g / f)
    rows = []
    for _ in range(300):
        c = ("chr1", "chr2", "chrX", "chrZ")[int(rng.integers(0, 4))]
        s = int(rng.integers(0, 30000))
        e = s + int(rng.integers(1, 3000))
        rows.append(f"{c}\t{s}\t{e}\tt{int(rng.integers(0, 5))}"
                    + ("" if rng.random() < 0.2
                       else f"\tG{int(rng.integers(0, 9))}") + "\n")
    rows += ["# comment\n", "\n", "chr1\t5\n"]
    with gzip.open(g / "annotations.bed.gz", "wt") as f:
        f.writelines(rows)
    mini = Genome("mini")
    monkeypatch.setenv("WGBS_TPU_REFDIR", str(tmp_path / "refs"))
    pg, jg = Genome("ag"), JGenome("ag")
    assert pg.annotations == jg.annotations
    a, b = panno.load_annotations(pg.annotations), janno.load_annotations(
        jg.annotations)
    assert sorted(a) == sorted(b)
    for c in b:
        assert all(np.array_equal(x, y) for x, y in zip(a[c][:2], b[c][:2]))
        assert a[c][2] == b[c][2]
    queries = [("chr1", int(s), int(s) + int(k)) for s, k in zip(
        rng.integers(1, 40000, 200), rng.integers(1, 4000, 200))]
    queries += [("chrZ", 10, 20), ("chr9", 1, 2)]
    for c, s, e in queries:
        assert panno.region_annotation(pg, c, s, e) == \
            janno.region_annotation(jg, c, s, e)
    bed_rows = [(c, s - 1, e) for c, s, e in queries]
    got = panno.annotate_rows(bed_rows, pg)
    assert got == janno.annotate_rows(bed_rows, jg)
    assert sum(t != "." for t, _ in got) > 50
    assert panno.annotate_rows(bed_rows, mini) is None


@pytest.mark.parametrize("n_per_chrom", [0, 3, 2500, 270_000])
def test_bigwig_writer_and_reader_equal_jax(tmp_path, n_per_chrom):
    from wgbs_tools_tpu.formats import bigwig as jbw
    from wgbs_tools_tpu_torch.formats import bigwig as pbw

    rng = np.random.default_rng(n_per_chrom)
    sizes = [("chr1", 60_000_000), ("chr10", 9_000_000), ("chrX", 500)]
    data = {}
    for c, size in sizes[:2]:
        if n_per_chrom == 0:
            continue
        starts = np.sort(rng.choice(size // 2, n_per_chrom, replace=False)) * 2
        data[c] = (starts, starts + 2, rng.random(n_per_chrom).astype(
            np.float32))
    pbw.write_bigwig(str(tmp_path / "t.bw"), sizes, data)
    jbw.write_bigwig(str(tmp_path / "j.bw"), sizes, data)
    got = (tmp_path / "t.bw").read_bytes()
    assert got == (tmp_path / "j.bw").read_bytes()
    tracks, summary = pbw.read_bigwig(str(tmp_path / "t.bw"))
    want_tracks, want_summary = jbw.read_bigwig(str(tmp_path / "j.bw"))
    assert summary == want_summary and sorted(tracks) == sorted(want_tracks)
    for c, cols in data.items():
        for x, y, z in zip(tracks[c], want_tracks[c], cols):
            assert np.array_equal(x, y) and np.array_equal(x, z)
    assert summary["valid"] == 2 * n_per_chrom * len(data)


def test_init_genome_writers_equal_jax(mini_genome, tmp_path):
    import importlib

    from wgbs_tools_tpu.utils import IllegalArgumentError as JErr

    jinit = importlib.import_module("wgbs_tools_tpu.genome.init_genome")
    pinit = importlib.import_module("wgbs_tools_tpu_torch.genome.init_genome")

    idx = mini_genome.index
    for who, mod in (("t", pinit), ("j", jinit)):
        d = tmp_path / who
        d.mkdir()
        mod.write_reference_compat_files(idx, str(d))
        text = b"chr1\t1\t9\tx\n" * 50
        (tmp_path / "plain.txt").write_bytes(text)
        (tmp_path / "z.gz").write_bytes(gzip.compress(text))
        for src, dst, gz in (("plain.txt", "a.gz", True),
                             ("plain.txt", "b.bed", False),
                             ("z.gz", "c.gz", True), ("z.gz", "d.bed", False)):
            mod._ingest_aux_file(str(tmp_path / src), str(d / dst), gz)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    assert len(names) == 8
    for name in names:
        a, b = tmp_path / "t" / name, tmp_path / "j" / name
        if a.is_symlink():
            assert os.readlink(a) == os.readlink(b)
        else:
            assert a.read_bytes() == b.read_bytes(), name
    with gzip.open(tmp_path / "t" / "CpG.bed.gz", "rt") as f:
        assert sum(1 for _ in f) == idx.nr_sites
    assert pinit.KNOWN_NR_SITES == jinit.KNOWN_NR_SITES
    assert pinit.UCSC_FASTA_URL == jinit.UCSC_FASTA_URL
    with pytest.raises(putils.IllegalArgumentError) as got:
        pinit.download_fasta("hg19", str(tmp_path))
    with pytest.raises(JErr) as want:
        jinit.download_fasta("hg19", str(tmp_path))
    assert str(got.value) == str(want.value)
