"""The port's v2 pileup against the JAX package's (pileup_tpu2.py): the
staged arrays one to one, the twin against the Pallas kernel (interpret
mode) with tolerance 0, and the CUDA kernel against its twin on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.formats.pat import CODE_C, PatFrags  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu2 as jax_v2  # noqa: E402
from wgbs_tools_tpu.ops.pileup import pileup_xla  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v2  # noqa: E402


def _boundaries():
    """test_pileup_tpu2.py's fragments that start at and around tile and
    sub-block edges."""
    starts = np.array([1020, 1023, 1024, 1151, 2047, 2048], dtype=np.int32)
    return PatFrags(starts, np.full(6, 10, np.int32),
                    np.arange(1, 7, dtype=np.int32),
                    np.full((6, 10), CODE_C, np.uint8),
                    np.zeros(6, np.int16), ["chr1"], None)


# name -> (fragments, window_start, window_len), at test_pileup_tpu2.py's
# sizes, plus counts up to 3000 and the empty batch
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
    f = random_frags(np.random.default_rng(sorted(CASES).index(name) + 201),
                     **kw)
    if name == "empty":
        f = f.take(np.zeros(0, np.int64))
    return f, ws, wl


def _jax_kernel(staged, wl):
    """pileup_tpu2._call (the Pallas kernel, interpret mode) on a staged
    tuple at pileup_pallas_v2's geometry."""
    c0, c1, meta, words, max_chunks = staged
    m, c = jax_v2._call(jnp.asarray(c0), jnp.asarray(c1), jnp.asarray(meta),
                        jnp.asarray(words), wl, pileup_v2.TILE,
                        pileup_v2.FRAG_CHUNK, pileup_v2.G_MAX, max_chunks,
                        interpret=True)
    return np.stack([np.asarray(m), np.asarray(c)], axis=1)


@pytest.mark.parametrize("name", sorted(CASES))
def test_stage_v2_equals_jax(name):
    f, ws, wl = _case(name)
    want = jax_v2.stage_v2(f.start, f.length, f.count, f.codes, ws, wl)
    got = pileup_v2.stage_v2(f.start, f.length, f.count, f.codes, ws, wl)
    assert len(got) == len(want) == 5
    for x, y in zip(want, got):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_jax_kernel(name):
    f, ws, wl = _case(name)
    staged = jax_v2.stage_v2(f.start, f.length, f.count, f.codes, ws, wl)
    want = _jax_kernel(staged, wl)
    st = pileup_v2.staged_v2_from_numpy(staged, "cpu")
    got = pileup_v2.tiles_v2_plain(st, wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert torch.equal(pileup_v2.tiles_v2(st, wl), got)
    assert np.array_equal(want, pileup_xla(f.start, f.length, f.count,
                                           f.codes, ws, wl))
    if name in ("empty", "empty_tiles"):
        assert ((staged[1] - staged[0]) == 0).any()


def test_pileup_v2_equals_jax_and_sorts_its_batch():
    """pileup_v2 == pileup_pallas_v2 end to end; an unsorted batch (which
    the JAX staging assumes away) is sorted first and piles up exactly."""
    f, ws, wl = _case("multi_tile")
    want = jax_v2.pileup_pallas_v2(f.start, f.length, f.count, f.codes, ws,
                                   wl, interpret=True)
    got = pileup_v2.pileup_v2(f.start, f.length, f.count, f.codes, ws, wl,
                              "cpu")
    assert np.array_equal(got.numpy(), want)
    g = f.take(np.random.default_rng(3).permutation(f.nr_frags))
    got = pileup_v2.pileup_v2(g.start, g.length, g.count, g.codes, ws, wl,
                              "cpu")
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width,w_cols", [(10, 2), (32, 2), (33, 4),
                                          (128, 8)])
def test_planar_pack_cols_equals_jax(width, w_cols):
    codes = np.random.default_rng(width).integers(0, 4, size=(50, width),
                                                  dtype=np.uint8)
    assert np.array_equal(pileup_v2.planar_pack_cols(codes, w_cols),
                          jax_v2.planar_pack_cols(codes, w_cols))


def test_staged_v2_checks():
    f, ws, wl = _case("small")
    staged = pileup_v2.stage_v2(f.start, f.length, f.count, f.codes, ws, wl)
    with pytest.raises(ValueError, match="5 fields"):
        pileup_v2.staged_v2_from_numpy(staged[:4], "cpu")
    bad = list(staged)
    bad[1] = bad[1] + 10**6
    with pytest.raises(ValueError, match="out of bounds"):
        pileup_v2.staged_v2_from_numpy(tuple(bad), "cpu")
    st = pileup_v2.staged_v2_from_numpy(staged, "cpu")
    with pytest.raises(ValueError, match="staged c0"):
        pileup_v2.tiles_v2(st, wl + 5000)


def _numpy_v2_pileup(staged, wl, tile=pileup_v2.TILE,
                     g_max=pileup_v2.G_MAX):
    """The v2 pileup of a staged tuple by a plain loop over tiles and
    chunks: a real row (dg in [0, g_max)) of a chunk in tile t's range adds
    count at site start + j, j < min(len, 16 * w_cols), where the code
    (word[j % w] >> 2 (j // w)) & 3 is not 3 (cov) and is 1 or 2 (meth),
    for sites in tiles t and t + 1 and in the window; int32 sums."""
    c0, c1, meta, words, _mc = staged
    fc, w = meta.shape[2], words.shape[1]
    acc = np.zeros((wl + 1, 2), np.int64)
    j = np.arange(16 * w)
    for t in range(len(c0)):
        for c in range(c0[t], c1[t]):
            rel = meta[c, 0].astype(np.int64)[:, None]
            lw = meta[c, 1].astype(np.int64)
            dg = lw >> 16
            code = (words[c * fc : (c + 1) * fc, j % w].view(np.uint32)
                    .astype(np.int64) >> (2 * (j // w))) & 3
            site = rel + j
            ok = (((dg >= 0) & (dg < g_max))[:, None]
                  & (j < np.minimum(lw & 0xFFFF, 16 * w)[:, None])
                  & (code != 3) & (site >= t * tile)
                  & (site < (t + 2) * tile) & (site < wl))
            n = np.broadcast_to(meta[c, 2].astype(np.int64)[:, None],
                                site.shape)
            np.add.at(acc[:, 1], np.where(ok, site, wl), np.where(ok, n, 0))
            np.add.at(acc[:, 0], np.where(ok & (code != 0), site, wl),
                      np.where(ok, n, 0))
    return ((acc[:wl] + 2**31) % 2**32 - 2**31).astype(np.int32)


def _reaches_next_tile(staged, t, tile=pileup_v2.TILE):
    """Chunks of tile t with a real row that reaches tile t + 1."""
    c0, c1, meta, words, _mc = staged
    lw = meta[:, 1].astype(np.int64)
    ln = np.minimum(lw & 0xFFFF, 16 * words.shape[1])
    real = ((lw >> 16) >= 0) & ((lw >> 16) < pileup_v2.G_MAX)
    cross = real & (meta[:, 0] + ln > (t + 1) * tile)
    return [c for c in range(c0[t], c1[t]) if cross[c].any()]


@pytest.mark.parametrize("name", chip_smoke.FRAG_EDGE)
def test_frag_edge_twin_equals_jax_and_numpy(name):
    """The twin of tiles_v2 on the edge cases that the card tests and
    chip_smoke.py hold the kernel to (starts and ends on tile edges, empty
    tiles with crossers, a tile of 6 chunks with crossers in each, padding
    rows and the base_g row with counts, w_cols 2 / 4 / 8, a ragged window,
    counts of 3000 ~900 deep, shuffled rows): equal to a plain numpy loop
    and to the JAX package's Pallas kernel in interpret mode, tolerance 0.
    Every case keeps the JAX kernel's f32 strip sums below 2^24 (at most
    fc - 1 rows of count <= 3000 in a chunk), where its one-hot dot is
    exact."""
    staged, wl = chip_smoke.frag_edge_batch(name)
    c0, c1, meta, words, _mc = staged
    real = ((meta[:, 1] >> 16) >= 0) & ((meta[:, 1] >> 16) < pileup_v2.G_MAX)
    assert (np.where(real, meta[:, 2], 0).sum(axis=1) < 2**24).all()
    want = _numpy_v2_pileup(staged, wl)
    got = pileup_v2.tiles_v2_plain(pileup_v2.staged_v2_from_numpy(staged,
                                                                  "cpu"), wl)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    assert np.array_equal(_jax_kernel(staged, wl), want)
    tile = pileup_v2.TILE
    cov = np.zeros(len(c0) * tile, np.int64)
    cov[:wl] = want[:, 1]
    covered = cov.reshape(len(c0), tile).any(axis=1)
    if name.startswith("w_cols_"):
        assert words.shape[1] == int(name[len("w_cols_"):])
    if name == "empty_tile":
        empty = np.nonzero(c1 == c0)[0]
        assert list(empty) == [1, 3] and covered[empty].all()
    if name == "many_chunks":
        assert (c1 - c0)[1] == 6 and len(_reaches_next_tile(staged, 1)) == 6
    if name == "padding_stash":
        pad = ~real[:, : pileup_v2.FRAG_CHUNK - 1] & (meta[:, 2, :-1] > 0)
        assert pad[: c1[-1]].any(axis=1).all()
        assert list(meta[: c1[-1], 0, -1]) == [7, 8, 20]
    if name == "ragged_window":
        assert wl % tile and want[-1, 1] > 0
    if name == "counts_3000":
        assert want[:, 1].max() > 2**16 and (meta[:, 2][real] == 3000).all()
    if name == "shuffled":
        assert any((np.diff(meta[c, 0, real[c]]) < 0).any()
                   for c in range(c1[-1]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_twin(cuda_device, name):
    f, ws, wl = _case(name)
    st = pileup_v2.staged_v2_from_numpy(pileup_v2.stage_v2(
        f.start, f.length, f.count, f.codes, ws, wl), cuda_device)
    before = pileup_v2.tiles_v2.launches
    got = pileup_v2.tiles_v2(st, wl)
    torch.cuda.synchronize()
    assert pileup_v2.tiles_v2.launches == before + 1
    assert torch.equal(got, pileup_v2.tiles_v2_plain(st, wl))
    assert np.array_equal(got.cpu().numpy(), pileup_xla(
        f.start, f.length, f.count, f.codes, ws, wl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", chip_smoke.FRAG_EDGE)
def test_cuda_frag_edge_cases(cuda_device, name):
    """tiles_v2 on the card == its twin, tolerance 0, on each edge case,
    into an output the allocator has dirtied (the kernel writes every
    site)."""
    staged, wl = chip_smoke.frag_edge_batch(name)
    st = pileup_v2.staged_v2_from_numpy(staged, cuda_device)
    torch.full((wl, 2), 7, dtype=torch.int32, device=cuda_device)
    before = pileup_v2.tiles_v2.launches
    got = pileup_v2.tiles_v2(st, wl)
    torch.cuda.synchronize()
    assert pileup_v2.tiles_v2.launches == before + 1
    assert torch.equal(got, pileup_v2.tiles_v2_plain(st, wl))


@pytest.mark.cuda
def test_cuda_rejects_misaligned_words(cuda_device):
    """The kernel loads a row's words as one vector: words that are not
    aligned to it are refused before any launch."""
    staged, wl = chip_smoke.frag_edge_batch("w_cols_4")
    st = pileup_v2.staged_v2_from_numpy(staged, cuda_device)
    flat = torch.empty(st.words.numel() + 1, dtype=torch.int32,
                       device=cuda_device)
    words = flat[1:].view(st.words.shape)
    words.copy_(st.words)
    bad = pileup_v2.StagedV2(st.c0, st.c1, st.meta, words)
    before = pileup_v2.tiles_v2.launches
    with pytest.raises(ValueError, match="aligned"):
        pileup_v2.tiles_v2(bad, wl)
    assert pileup_v2.tiles_v2.launches == before
