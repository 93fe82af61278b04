"""The port's homog (ops/frag_ops.py, pipeline/pat_stream.py,
cli/cmd_homog.py) against the JAX package, tolerance 0: overlap_pairs,
homog_counts' twin against JAX's numpy homog_counts and its device path
(_homog_counts_jax) with inclusive on and off, thresholds that meth ties
exactly, the min_cpgs edges, streaming over tiny slabs, and the CLI's
bytes (text, --binary with 8 and 16 bits, --prefix, --thresholds, --rlen,
unsorted blocks) against the JAX CLI's."""

import gzip

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from synth import random_frags  # noqa: E402
from test_torch_reduceat import make_blocks  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import frags_to_bytes, write_pat  # noqa: E402
from wgbs_tools_tpu.ops import frag_ops as jfo  # noqa: E402
from wgbs_tools_tpu.pipeline.pat_stream import (  # noqa: E402
    homog_pat_streaming as jax_streaming)
from wgbs_tools_tpu_torch.formats.pat import PatFrags  # noqa: E402
from wgbs_tools_tpu_torch.ops import frag_ops  # noqa: E402
from wgbs_tools_tpu_torch.pipeline.pat_stream import (  # noqa: E402
    homog_pat_streaming)
from wgbs_tools_tpu_torch.utils import IllegalArgumentError  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native library unavailable")

N = 4000
# the CLI's default U/X/M edges at rlen 3 and 5, and edges that meth ties
# exactly (4-call reads give 0.25 and 0.5; 1.0 must land in the last bin),
# and 100 bins (the kernel takes any number of edges, as JAX's code does)
RANGES = {"rlen3": [0.0, 0.334, 0.667, 1.0], "rlen5": [0.0, 0.201, 0.8, 1.0],
          "ties": [0.0, 0.25, 0.5, 1.0], "five": [0.0, 0.2, 0.4, 0.6, 0.8,
                                                  1.0],
          "hundred": [k / 100 for k in range(101)]}


def _frags(seed, n=3000, max_len=14, max_count=5):
    f = random_frags(np.random.default_rng(seed), n, N - 20, max_len=max_len,
                     max_count=max_count, h_rate=0.05, dot_rate=0.1)
    return PatFrags(f.start, f.length, f.count, f.codes, f.chrom_id,
                    f.chrom_names)


def _blocks(seed=2, n_blocks=250):
    s, e = make_blocks(np.random.default_rng(seed), n_blocks, N - 10,
                       min_len=1, max_len=12)
    return s, e


def test_overlap_pairs_equals_jax():
    f = _frags(1)
    s, e = _blocks()
    e = e.copy()
    e[5] = e[9] + 4  # a long block: ends no longer monotone
    fi, bi = frag_ops.overlap_pairs(f, s, e)
    jfi, jbi = jfo.overlap_pairs(f, s, e)
    assert fi.size > 1000
    assert np.array_equal(fi, jfi) and np.array_equal(bi, jbi)


@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("ranges", sorted(RANGES))
@pytest.mark.parametrize("min_cpgs", [1, 3, 4])
def test_homog_counts_equals_jax(inclusive, ranges, min_cpgs):
    f = _frags(3)
    s, e = _blocks()
    args = (f, s, e, RANGES[ranges])
    want = jfo.homog_counts(*args, min_cpgs=min_cpgs, inclusive=inclusive)
    assert want.sum() > 0
    before = frag_ops.homog_bins.launches
    got = frag_ops.homog_counts(*args, min_cpgs=min_cpgs,
                                inclusive=inclusive, device="cpu")
    assert frag_ops.homog_bins.launches == before  # the CPU takes the twin
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jfo.homog_counts(
        *args, min_cpgs=min_cpgs, inclusive=inclusive, backend="jax"))


def test_homog_ties_and_gates_by_hand():
    """4-call reads at meth 0, 0.25, 0.5, 0.75 and 1 against edges 0.25 and
    0.5: a meth on an edge goes to the bin above it, 1.0 to the last; H
    counts as C; a read whose clip or informative calls fall under
    min_cpgs does not count."""
    T, C, H, D = 0, 1, 2, 3
    rows = [[T, T, T, T], [C, T, T, T], [C, H, T, T], [C, C, H, T],
            [C, C, C, C], [C, C, D, T], [C, C, C, D]]
    codes = np.array([r + [D, D] for r in rows], np.uint8)
    n = len(rows)
    f = PatFrags(np.full(n, 10, np.int32), np.full(n, 4, np.int32),
                 np.arange(1, n + 1, dtype=np.int32) * 1000, codes,
                 np.zeros(n, np.int16), ["chr1"])
    ranges = RANGES["ties"]
    s, e = np.array([10, 12]), np.array([14, 20])
    got = frag_ops.homog_counts(f, s, e, ranges, min_cpgs=3, device="cpu")
    # block [10, 14): meth 0 -> U, .25 -> X, .5 -> M, .75 -> M, 1 -> M; the
    # two reads with a '.' have 3 informative calls: 1.0 -> M (>= 3), and
    # 2/3 -> M; block [12, 14) (clip of 2 sites) counts nothing at 3
    assert got.tolist() == [[1000, 2000, 3000 + 4000 + 5000 + 6000 + 7000],
                            [0, 0, 0]]
    assert np.array_equal(got, jfo.homog_counts(f, s, e, ranges,
                                                min_cpgs=3))
    inc = frag_ops.homog_counts(f, s, e, ranges, min_cpgs=3,
                                inclusive=True, device="cpu")
    assert np.array_equal(inc[1], inc[0])
    assert np.array_equal(inc, jfo.homog_counts(f, s, e, ranges, min_cpgs=3,
                                                inclusive=True))


@pytest.mark.parametrize("name", chip_smoke.HOMOG_EDGE)
def test_homog_edge_twin_equals_jax(name):
    """chip_smoke.py's edge cases for homog_bins (exact ties on the edges,
    meth 0 and 1, inclusive, min_cpgs 1 / 3 / 4, reads over many blocks):
    the twin == JAX's numpy homog_counts."""
    frags, bstart, bend, ranges, m, inclusive = chip_smoke.homog_edge_batch(
        name)
    want = jfo.homog_counts(frags, bstart, bend, ranges, min_cpgs=m,
                            inclusive=inclusive)
    got = frag_ops.homog_counts(frags, bstart, bend, ranges, min_cpgs=m,
                                inclusive=inclusive, device="cpu")
    assert want.sum() > 0 and np.array_equal(got, want)


def test_homog_refuses_bad_ranges():
    f = _frags(4, n=10)
    for bad in ([0.1, 0.5, 1.0], [0.0, 0.5, 0.9], [0.0, 0.6, 0.5, 1.0]):
        with pytest.raises(IllegalArgumentError):
            frag_ops.homog_counts(f, [1], [5], bad, device="cpu")


@pytest.mark.parametrize("inclusive", [False, True])
def test_streaming_over_tiny_slabs_equals_jax(tmp_path, inclusive):
    f = _frags(5, n=4000, max_count=3000)
    pat = tmp_path / "p.pat"  # text: iter_pat's slabs are 3,000 bytes
    pat.write_bytes(frags_to_bytes(f))
    s, e = _blocks()
    want = jax_streaming(str(pat), s, e, RANGES["rlen3"], min_len=3,
                         inclusive=inclusive, chunk_bytes=3000)
    got = homog_pat_streaming(str(pat), s, e, RANGES["rlen3"], min_len=3,
                              inclusive=inclusive, chunk_bytes=3000,
                              device="cpu")
    assert want.sum() > 0 and np.array_equal(got, want)


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def homog_inputs(tmp_path_factory):
    """A pat with counts up to 3000 (so 16-bit output saturates rows
    differently from 8-bit) and two beds of the same blocks: sorted, and
    shuffled."""
    d = tmp_path_factory.mktemp("homog")
    f = random_frags(np.random.default_rng(6), 5000, N - 20, max_len=14,
                     max_count=3000, h_rate=0.05, dot_rate=0.1)
    pat = str(d / "s.pat.gz")
    write_pat(f, pat)
    s, e = _blocks()
    rows = [f"chr1\t{a * 7}\t{b * 7}\t{a}\t{b}\n" for a, b in zip(s, e)]
    beds = {"sorted": str(d / "b.bed"), "unsorted": str(d / "u.bed")}
    with open(beds["sorted"], "w") as fh:
        fh.write("".join(rows))
    perm = np.random.default_rng(7).permutation(len(rows))
    with open(beds["unsorted"], "w") as fh:
        fh.write("".join(rows[i] for i in perm))
    return pat, beds


FORMS = {"text": [], "binary8": ["--binary"],
         "binary16": ["--binary", "--nr_bits", "16"],
         "thresholds": ["-t", "0.25,0.5"], "rlen": ["-l", "5"],
         "inclusive": ["--inclusive"], "unsorted": [], "prefix": None}


@pytest.mark.parametrize("form", sorted(FORMS))
def test_cli_homog_equals_jax_cli(tmp_path, homog_inputs, form):
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    pat, beds = homog_inputs
    bed = beds["unsorted" if form == "unsorted" else "sorted"]
    outs = []
    for who, main, extra in (("j", jax_main, []),
                             ("t", port_main, ["--device", "cpu"])):
        d = tmp_path / who
        where = (["-p", str(d / "sub" / "pre")] if form == "prefix"
                 else ["-o", str(d)])
        assert main(["homog", pat, "-b", bed] + where
                    + (FORMS[form] or []) + extra) == 0
        outs.append(d)
    j, t = outs
    files = sorted(p.relative_to(j) for p in j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(t) for p in t.rglob("*")
                           if p.is_file()) and len(files) == 1
    want = (j / files[0]).read_bytes()
    assert (t / files[0]).read_bytes() == want
    if not str(files[0]).endswith(".uxm"):
        assert gzip.decompress(want).count(b"\n") == 250


def test_cli_homog_asks_for_cuda(tmp_path, homog_inputs, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    pat, beds = homog_inputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_main(["homog", pat, "-b", beds["sorted"], "-o", str(tmp_path)])


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("inclusive", [False, True])
@pytest.mark.parametrize("ranges", sorted(RANGES))
def test_cuda_homog_bins_equals_twin(cuda_device, inclusive, ranges):
    f = _frags(8, max_len=40, max_count=3000)
    s, e = _blocks()
    before = frag_ops.homog_bins.launches
    got = frag_ops.homog_counts(f, s, e, RANGES[ranges], min_cpgs=3,
                                inclusive=inclusive, device=cuda_device)
    torch.cuda.synchronize()
    assert frag_ops.homog_bins.launches == before + 1
    assert np.array_equal(got, frag_ops.homog_counts(
        f, s, e, RANGES[ranges], min_cpgs=3, inclusive=inclusive,
        device="cpu"))


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 7])
@pytest.mark.parametrize("name", chip_smoke.HOMOG_EDGE)
def test_cuda_homog_edge_equals_twin(cuda_device, name, offset):
    """The kernel on chip_smoke.py's HOMOG_EDGE batches (the pairs the
    smoke hands it, shuffled for permuted_pairs), the codes at byte
    `offset` of their buffer (0: rows at one offset mod 8 where L is a
    multiple of 8; 7: rows across word edges): == the twin, tolerance 0,
    and its stats (chunks, pairs added
    straight into out, passing pairs, global atomics) == the numpy
    model's of its order of work."""
    from test_torch_homog_chunks import model_counts

    frags, bstart, bend, ranges, m, inclusive = chip_smoke.homog_edge_batch(
        name)
    fi, bi = chip_smoke.homog_edge_pairs(name, frags, bstart, bend)
    cols = chip_smoke._homog_cols(frags, bstart, bend, ranges, cuda_device,
                                  (fi, bi))
    F, L = frags.codes.shape
    buf = torch.empty(F * L + 16, dtype=torch.uint8, device=cuda_device)
    cols[0] = buf[offset:offset + F * L].view(F, L)
    cols[0].copy_(torch.from_numpy(frags.codes))
    out = torch.zeros((len(bstart), len(ranges) - 1), dtype=torch.int64,
                      device=cuda_device)
    stats = torch.zeros(4, dtype=torch.int64, device=cuda_device)
    got = frag_ops.homog_bins(out.clone(), *cols, m, inclusive, stats=stats)
    torch.cuda.synchronize()
    assert torch.equal(got, frag_ops.homog_bins_plain(out, *cols, m,
                                                      inclusive))
    want, st = model_counts(frags, bstart, bend, ranges, m, inclusive, fi,
                            bi, align=cols[0].data_ptr() % 16)
    assert np.array_equal(got.cpu().numpy(), want)
    assert stats.tolist() == [st["chunks"], st["direct"], st["passing"],
                              st["atomics"]]
