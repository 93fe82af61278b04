"""The port's v2 pileup against the JAX package's (pileup_tpu2.py): the
staged arrays one to one, the twin against the Pallas kernel (interpret
mode) with tolerance 0, and the CUDA kernel against its twin on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
