"""The port's v1 pileup against the JAX package's (pileup_tpu.py): the
host prep's arrays one to one with what pileup_pallas hands its kernel,
the planar words against planar_pack, the twin against the Pallas kernel
(interpret mode) and a numpy loop with tolerance 0, on random batches and
on chip_smoke.py's edge cases (FRAG_EDGE_V1) and long slab, and the CUDA
kernel against its twin on the card."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.formats.pat import CODE_C, CODE_DOT, PatFrags  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu as jax_v1  # noqa: E402
from wgbs_tools_tpu.ops.pileup import pileup_xla  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v1  # noqa: E402


def _boundaries():
    """test_pileup_tpu.py's fragments that straddle tile edges."""
    starts = np.array([1020, 1023, 1024, 1025, 2047, 2048], dtype=np.int32)
    return PatFrags(starts, np.full(6, 10, np.int32),
                    np.ones(6, dtype=np.int32),
                    np.full((6, 10), CODE_C, np.uint8),
                    np.zeros(6, np.int16), ["chr1"], None)


# name -> (fragments, window_start, window_len), at test_pileup_tpu.py's
# sizes, plus 400-site fragments (max_len 512: no split in v1), counts up
# to 3000, empty tiles and the empty batch
CASES = {
    "small": (dict(nr_frags=400, nr_sites=2000, max_len=12, h_rate=0.05),
              1, 2000),
    "multi_tile": (dict(nr_frags=3000, nr_sites=5000, max_len=20,
                        dot_rate=0.1), 1, 5000),
    "offset_window": (dict(nr_frags=2000, nr_sites=6000, max_len=16),
                      2500, 2048),
    "long_fragments": (dict(nr_frags=300, nr_sites=9000, max_len=400),
                       1, 9000),
    "counts_3000": (dict(nr_frags=2000, nr_sites=5000, max_len=24,
                         max_count=3000, h_rate=0.05), 1, 5000),
    "empty_tiles": (dict(nr_frags=40, nr_sites=30000, max_len=10), 1, 30000),
    "tile_boundaries": (None, 1, 3000),
    "empty": (dict(nr_frags=1, nr_sites=100, max_len=3), 1, 1500),
}


def _case(name):
    kw, ws, wl = CASES[name]
    if kw is None:
        return _boundaries(), ws, wl
    f = random_frags(np.random.default_rng(sorted(CASES).index(name) + 301),
                     **kw)
    if name == "empty":
        f = f.take(np.zeros(0, np.int64))
    return f, ws, wl


def _jax_run(monkeypatch, f, ws, wl):
    """pileup_pallas (interpret mode) on the fragments: its output, and the
    arguments it hands _pileup_pallas_call (lo, hi, meta, words, then the
    static ones)."""
    seen = []
    call = jax_v1._pileup_pallas_call

    def spy(*args):
        seen.append(args)
        return call(*args)

    monkeypatch.setattr(jax_v1, "_pileup_pallas_call", spy)
    out = jax_v1.pileup_pallas(f.start, f.length, f.count, f.packed(), ws,
                               wl, interpret=True)
    (args,) = seen
    return out, args


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_and_prep_equal_jax(monkeypatch, name):
    f, ws, wl = _case(name)
    want, args = _jax_run(monkeypatch, f, ws, wl)
    lo, hi, meta, words, max_chunks, max_len = pileup_v1.stage_v1(
        f.start, f.length, f.count, f.codes, ws, wl)
    for x, y in zip(args[:4], (lo, hi, meta, words)):
        x = np.asarray(x)
        assert x.dtype == y.dtype and np.array_equal(x, y)
    # (window_len, max_len, tile, fc, max_chunks, interpret)
    assert args[4:9] == (wl, max_len, pileup_v1.TILE, pileup_v1.FRAG_CHUNK,
                         max_chunks)
    st = pileup_v1.staged_v1_from_numpy(
        (lo, hi, meta, words, max_chunks, max_len), "cpu")
    got = pileup_v1.tiles_v1_plain(st, wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(pileup_v1.tiles_v1(st, wl), got)
    assert torch.equal(pileup_v1.pileup_v1(f.start, f.length, f.count,
                                           f.codes, ws, wl, "cpu"), got)
    assert np.array_equal(want, pileup_xla(f.start, f.length, f.count,
                                           f.codes, ws, wl))


@pytest.mark.parametrize("width", [1, 12, 24, 128, 130, 400])
def test_planar_words_equal_planar_pack(width):
    """The uint32 words equal pileup_tpu.planar_pack's (int64) of the codes
    padded with '.' to (rows, max_len), padding rows included."""
    rng = np.random.default_rng(width)
    codes = rng.integers(0, 4, size=(37, width), dtype=np.uint8)
    max_len = max(-(-width // 128) * 128, 128)
    padded = np.full((64, max_len), CODE_DOT, dtype=np.uint8)
    padded[:37, :width] = codes
    got = pileup_v1.planar_words(codes, max_len, 64)
    assert got.dtype == np.int32
    assert np.array_equal(got, jax_v1.planar_pack(padded))


def test_unsorted_batch_is_sorted_first():
    """The JAX prep's searchsorted assumes a batch in start order; the
    port sorts an unsorted one first and piles it up exactly."""
    f, ws, wl = _case("multi_tile")
    g = f.take(np.random.default_rng(4).permutation(f.nr_frags))
    got = pileup_v1.pileup_v1(g.start, g.length, g.count, g.codes, ws, wl,
                              "cpu")
    assert np.array_equal(got.numpy(), pileup_xla(f.start, f.length, f.count,
                                                  f.codes, ws, wl))


def test_staged_v1_checks():
    f, ws, wl = _case("small")
    staged = pileup_v1.stage_v1(f.start, f.length, f.count, f.codes, ws, wl)
    with pytest.raises(ValueError, match="6 fields"):
        pileup_v1.staged_v1_from_numpy(staged[:5], "cpu")
    bad = list(staged)
    bad[1] = bad[1] + 10**6
    with pytest.raises(ValueError, match="out of bounds"):
        pileup_v1.staged_v1_from_numpy(tuple(bad), "cpu")
    bad = list(staged)
    bad[5] = 256
    with pytest.raises(ValueError, match="max_len"):
        pileup_v1.staged_v1_from_numpy(tuple(bad), "cpu")
    # the kernel writes a tile's sites in pairs: an odd tile is refused
    st = pileup_v1.staged_v1_from_numpy(staged, "cpu", tile=1023)
    with pytest.raises(ValueError, match="even tile"):
        pileup_v1.tiles_v1(st, wl)


def _numpy_v1_pileup(staged, wl, tile=pileup_v1.TILE):
    """The v1 pileup of a staged tuple by a plain loop over tiles: row f in
    [lo[t], hi[t]) adds count at site start + j, j < min(len, 16 * w16),
    where the code (word[j % w16] >> 2 (j // w16)) & 3 is not 3 (cov) and
    is 1 or 2 (meth), for sites in tile t and in the window; int32 sums."""
    lo, hi, meta, words, _mc, _ml = staged
    fc, w = meta.shape[2], words.shape[1]
    acc = np.zeros((wl + 1, 2), np.int64)
    j = np.arange(16 * w)
    for t in range(len(lo)):
        rows = np.arange(lo[t], hi[t])
        start = meta[rows // fc, 0, rows % fc].astype(np.int64)[:, None]
        ln = np.minimum(meta[rows // fc, 1, rows % fc], 16 * w)[:, None]
        n = np.broadcast_to(meta[rows // fc, 2, rows % fc].astype(np.int64)
                            [:, None], (len(rows), j.size))
        code = (words[rows][:, j % w].view(np.uint32).astype(np.int64)
                >> (2 * (j // w))) & 3
        site = start + j
        ok = ((j < ln) & (code != 3) & (site >= t * tile)
              & (site < (t + 1) * tile) & (site < wl))
        np.add.at(acc[:, 1], np.where(ok, site, wl), np.where(ok, n, 0))
        np.add.at(acc[:, 0], np.where(ok & (code != 0), site, wl),
                  np.where(ok, n, 0))
    return ((acc[:wl] + 2**31) % 2**32 - 2**31).astype(np.int32)


def _jax_kernel(staged, wl):
    """The JAX package's Pallas kernel (interpret mode) on a staged tuple."""
    lo, hi, meta, words, max_chunks, max_len = staged
    meth, cov = jax_v1._pileup_pallas_call(
        jnp.asarray(lo), jnp.asarray(hi), jnp.asarray(meta),
        jnp.asarray(words), wl, max_len, pileup_v1.TILE,
        pileup_v1.FRAG_CHUNK, max_chunks, interpret=True)
    return np.stack([np.asarray(meth), np.asarray(cov)], axis=1)


def _row_fields(staged):
    """Start, clamped length and count of every staged row."""
    _lo, _hi, meta, words, _mc, _ml = staged
    return (meta[:, 0].reshape(-1).astype(np.int64),
            np.minimum(meta[:, 1].reshape(-1), 16 * words.shape[1]),
            meta[:, 2].reshape(-1))


@pytest.mark.parametrize("name", chip_smoke.FRAG_EDGE_V1)
def test_frag_edge_v1_twin_equals_jax_and_numpy(name):
    """The twin of tiles_v1 on the edge cases that the card tests and
    chip_smoke.py hold the kernel to (rows of up to 4096 sites over whole
    tiles, tiles covered only from far back, rows on tile edges, w16 that
    are not powers of two, a mixed batch, padding rows with counts and
    words, negative starts, a ragged window, counts of 3000 ~900 deep,
    shuffled rows): equal to a plain numpy loop, tolerance 0, and, where the
    rows are in start order, to the JAX package's Pallas kernel in
    interpret mode (it walks whole chunks; the twin walks [lo, hi))."""
    staged, wl = chip_smoke.frag_edge_v1_batch(name)
    lo, hi, meta, words, _mc, max_len = staged
    want = _numpy_v1_pileup(staged, wl)
    got = pileup_v1.tiles_v1_plain(pileup_v1.staged_v1_from_numpy(staged,
                                                                  "cpu"), wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    if name not in chip_smoke.FRAG_EDGE_V1_UNORDERED:
        assert np.array_equal(_jax_kernel(staged, wl), want)
    tile = pileup_v1.TILE
    start, ln, count = _row_fields(staged)
    real = start != pileup_v1.SENTINEL
    cov = np.zeros(len(lo) * tile, np.int64)
    cov[:wl] = want[:, 1]
    covered = cov.reshape(len(lo), tile).any(axis=1)
    own = np.bincount(start[real & (start >= 0)] // tile,
                      minlength=len(lo))[: len(lo)]
    w16 = {"max_len_4096": 256, "far_crossers": 192, "tile_edges": 16,
           "w16_24": 24, "w16_40": 40, "mixed": 128, "padding_rows": 8,
           "negative_start": 8, "ragged_window": 24, "counts_3000": 24,
           "shuffled": 8, "shuffled_long": 24}[name]
    assert words.shape[1] == w16 and max_len == 16 * w16
    if name == "max_len_4096":
        # rows over three whole tiles; tile 5 looks back over four tiles
        assert ((start % tile != 0) & (ln == 4096) & real).any()
        assert lo[5] <= np.nonzero(start == 1000)[0][0] < hi[5]
    if name == "far_crossers":
        assert list(own[1:4]) == [0, 0, 0] and covered[1:4].all()
    if name == "tile_edges":
        for s in (0, 1024, 2048, 3072, 768, 1792, 3840):
            assert ((start == s) & (ln == 256)).any()
        assert (want[[0, 1023, 1024, 2047, 3071, 3072, 4095], 1] > 0).all()
    if name == "mixed":
        assert (ln[real] == 2000).sum() == 1 and (ln[real] <= 24).sum() == 3000
        reach = [(start[lo[t]:hi[t]] + ln[lo[t]:hi[t]] > t * tile).mean()
                 for t in range(1, len(lo))]
        assert max(reach) < 0.6
    if name == "padding_rows":
        pad = ~real
        assert (count[pad] == 3000).all() and (ln[pad] > 0).any()
        assert (words.reshape(-1, w16)[pad] != -1).any(axis=1).all()
        # a tile whose walk starts with rows the chunk rounding added
        assert any(start[lo[t]] + ln[lo[t]] <= t * tile
                   for t in range(len(lo)) if lo[t] < hi[t])
    if name == "negative_start":
        assert (start[real] < 0).any() and want[0, 1] > 0
    if name == "ragged_window":
        assert wl % tile and want[-1, 1] > 0
    if name == "counts_3000":
        assert want[:, 1].max() > 2**16 and (count[real] == 3000).all()
    if name in chip_smoke.FRAG_EDGE_V1_UNORDERED:
        assert any((np.diff(start[lo[t]:hi[t]]) < 0).any()
                   for t in range(len(lo)))


def test_long_slab_twin_equals_numpy():
    """chip_smoke.py's long slab, at a small size: log-normal lengths up to
    the cap (one at it, so w16 = cap / 16 and the warp-per-row form), in
    start order, codes '.' past each length; its v1 staging piles up as the
    numpy loop says."""
    f, ws, wl = chip_smoke.long_slab(n=600, n_sites=20_000, cap=512, seed=3)
    assert f.nr_frags == 600 and (np.diff(f.start) >= 0).all()
    assert f.length.max() == 512 and f.length.min() >= 1
    assert (f.codes[np.arange(512)[None, :] >= f.length[:, None]] == 3).all()
    staged = pileup_v1.stage_v1(f.start, f.length, f.count, f.codes, ws, wl)
    assert staged[3].shape[1] == 32
    got = pileup_v1.tiles_v1(pileup_v1.staged_v1_from_numpy(staged, "cpu"),
                             wl)
    assert np.array_equal(got.numpy(), _numpy_v1_pileup(staged, wl))


def test_work_counts_the_words_v1_codes_occupy():
    """chip_smoke._work's bytes of a v1 batch: 12 B and the min(length,
    w16) words of each real row, the tile ranges, the output."""
    staged, wl = chip_smoke.frag_edge_v1_batch("mixed")
    st = pileup_v1.staged_v1_from_numpy(staged, "cpu")
    start, ln, _count = _row_fields(staged)
    real = start != pileup_v1.SENTINEL
    n_bytes, ops = chip_smoke._work([st], wl)
    assert n_bytes == (12 * real.sum() + 4 * np.minimum(ln[real], 128).sum()
                       + 8 * len(staged[0]) + 8 * wl)
    assert ops == 2 * ln[real].sum()


def test_kernel_ab_probe_matches_pileup_v1_cu():
    """kernel_ab.py --listed includes csrc/pileup_v1.cu and adds an entry
    per B that calls its launch_tiles<0, B> with the C entry's parameters:
    the source still has that template, and the entry's parameter list is
    pileup_tiles_v1's."""
    import re

    import kernel_ab

    with open(os.path.join(kernel_ab.REPO, kernel_ab.SRCS[-1])) as f:
        src = f.read()
    probe = kernel_ab.PROBE_ENTRY.format(b=6)
    assert "template <int W, int BLOCKS>\nint launch_tiles(" in src
    assert "launch_tiles<0, 6>(lo, hi, meta, words, out, num_tiles," in probe

    def params(text, name):
        m = re.search(name + r"\((.*?)\)\s*\{", text, re.S)
        return " ".join(m.group(1).split())

    assert params(probe, "pileup_tiles_v1_listed_b6") == params(
        src, "int pileup_tiles_v1")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_twin(cuda_device, name):
    f, ws, wl = _case(name)
    st = pileup_v1.staged_v1_from_numpy(pileup_v1.stage_v1(
        f.start, f.length, f.count, f.codes, ws, wl), cuda_device)
    before = pileup_v1.tiles_v1.launches
    got = pileup_v1.tiles_v1(st, wl)
    torch.cuda.synchronize()
    assert pileup_v1.tiles_v1.launches == before + 1
    assert torch.equal(got, pileup_v1.tiles_v1_plain(st, wl))
    assert np.array_equal(got.cpu().numpy(), pileup_xla(
        f.start, f.length, f.count, f.codes, ws, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.FRAG_EDGE_V1)
def test_cuda_frag_edge_v1_cases(cuda_device, name):
    """tiles_v1 on the card == its twin, tolerance 0, on each edge case,
    into an output the allocator has dirtied (the kernel writes every
    site)."""
    staged, wl = chip_smoke.frag_edge_v1_batch(name)
    st = pileup_v1.staged_v1_from_numpy(staged, cuda_device)
    torch.full((wl, 2), 7, dtype=torch.int32, device=cuda_device)
    before = pileup_v1.tiles_v1.launches
    got = pileup_v1.tiles_v1(st, wl)
    torch.cuda.synchronize()
    assert pileup_v1.tiles_v1.launches == before + 1
    assert torch.equal(got, pileup_v1.tiles_v1_plain(st, wl))


@pytest.mark.cuda
def test_cuda_rejects_misaligned_words(cuda_device):
    """The thread-per-row form (w16 8 and 16) loads a row's words as 16-B
    vectors: words that are not 16-B aligned are refused before any
    launch."""
    staged, wl = chip_smoke.frag_edge_v1_batch("tile_edges")
    st = pileup_v1.staged_v1_from_numpy(staged, cuda_device)
    flat = torch.empty(st.words.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    words = flat[1:].view(st.words.shape)
    words.copy_(st.words)
    bad = pileup_v1.StagedV1(st.lo, st.hi, st.meta, words)
    before = pileup_v1.tiles_v1.launches
    with pytest.raises(ValueError, match="aligned"):
        pileup_v1.tiles_v1(bad, wl)
    assert pileup_v1.tiles_v1.launches == before
