"""The port's v1 pileup against the JAX package's (pileup_tpu.py): the
host prep's arrays one to one with what pileup_pallas hands its kernel,
the planar words against planar_pack, the twin against the Pallas kernel
(interpret mode) with tolerance 0, and the CUDA kernel against its twin
on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
