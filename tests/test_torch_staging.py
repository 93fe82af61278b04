"""The port's v3 host staging equals the JAX package's stage_v3, array for
array (tolerance 0), for the value-plane form (fused and split planes),
the lane-count form and the classic form (with the JAX package's gates
between them), and raises where the JAX package would fall back."""

from functools import partial

import numpy as np
import pytest

pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import CODE_DOT  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu3 as jax_v3  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v3  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="native packer unavailable")

SMALL = dict(tile=512, rc=64, g_max=4)


def _lines(rng, starts, lengths, counts=None):
    """(start, length, count, codes) of pat lines in the given order: codes
    T, C, H or '.' at random, '.' past each line's end, counts 1-5 unless
    given."""
    starts = np.asarray(starts, np.int32)
    lengths = np.asarray(lengths, np.int32)
    width = int(lengths.max(initial=1))
    codes = rng.integers(0, 4, (starts.size, width)).astype(np.uint8)
    codes[np.arange(width)[None, :] >= lengths[:, None]] = CODE_DOT
    if counts is None:
        counts = rng.integers(1, 6, starts.size)
    return starts, lengths, np.asarray(counts, np.int32), codes


def _sorted_lines(rng, starts, lengths, **kw):
    order = np.argsort(starts, kind="stable")
    return _lines(rng, np.asarray(starts)[order], np.asarray(lengths)[order],
                  **kw)


def edge_lengths(rng):
    """Lines of exactly 127, 128, 129, 256 and 257 sites, 40 of each."""
    lengths = np.repeat([127, 128, 129, 256, 257], 40)
    rng.shuffle(lengths)
    return _sorted_lines(rng, rng.integers(1, 6000, lengths.size), lengths)


def ont_like(rng, top_count=5):
    """Nanopore-like lines: log-normal spans (median 100 sites, sigma 1,
    cap 3,000), so ~40 % are over 128 sites; one long line's count is
    `top_count`."""
    n = 300
    lengths = np.clip(np.rint(np.exp(rng.normal(np.log(100), 1.0, n))), 1,
                      3000).astype(np.int32)
    counts = rng.integers(1, 6, n)
    counts[np.argmax(lengths)] = top_count
    return _sorted_lines(rng, rng.integers(1, 30_000, n), lengths,
                         counts=counts)


def unsorted_long(rng):
    """Unsorted lines of 1-400 sites; after them, short lines whose starts
    tie the first and the second 128-site piece of a long line."""
    lengths = rng.integers(1, 401, 300)
    starts = rng.integers(1, 8000, 300)
    i = int(np.argmax(lengths > 128))
    starts = np.concatenate([starts, [starts[i], starts[i] + 128]])
    lengths = np.concatenate([lengths, [10, 20]])
    return _lines(rng, starts, lengths)


def left_edge_cuts_long(rng):
    """Lines of 1-400 sites about the window's left edge (2500), and two
    long lines that the edge cuts in their second and third 128-site
    pieces."""
    starts = np.concatenate([rng.integers(1, 6000, 300),
                             [2500 - 128 - 50, 2500 - 256 - 30]])
    lengths = np.concatenate([rng.integers(1, 401, 300), [400, 300]])
    return _sorted_lines(rng, starts, lengths)


def before_window(rng):
    """Lines (some over 128 sites) that all end before the window."""
    return _sorted_lines(rng, rng.integers(1, 3000, 200),
                         rng.integers(1, 300, 200))


# (fragments, window_start, window_len, geometry); fragments from a seed:
# random_frags' keywords, or a function of the generator
CASES = {
    "vals": (dict(nr_frags=2000, nr_sites=5000, max_len=16, h_rate=0.05),
             1, 5000, SMALL),
    "vals_left_edge": (dict(nr_frags=2000, nr_sites=6000, max_len=16),
                       2500, 2048, SMALL),
    "vals_long_frags": (dict(nr_frags=200, nr_sites=4000, max_len=300),
                        1, 4000, SMALL),
    "vals_empty_tiles": (dict(nr_frags=30, nr_sites=20000, max_len=10),
                         1, 20000, SMALL),
    "classic_counts_3000": (dict(nr_frags=500, nr_sites=4000, max_len=10,
                                 max_count=3000), 1, 4000, SMALL),
    "classic_one_class": (dict(nr_frags=500, nr_sites=4000, max_len=10,
                               max_count=3000), 1, 4000,
                          dict(SMALL, classes=None)),
    "classic_left_edge": (dict(nr_frags=400, nr_sites=5000, max_len=40,
                               max_count=900), 1500, 3000,
                          dict(SMALL, classes=(16, 32, 64))),
    "default_geometry": (dict(nr_frags=3000, nr_sites=30000, max_len=24),
                         1, 30000, {}),
    # split planes: the JAX package's WGBS_TPU_V3_FUSED_PLANE=0
    "vals_split": (dict(nr_frags=2000, nr_sites=5000, max_len=16,
                        h_rate=0.05), 1, 5000, dict(SMALL, fused=False)),
    "vals_split_left_edge_long": (dict(nr_frags=300, nr_sites=6000,
                                       max_len=300), 2500, 2048,
                                  dict(SMALL, fused=False)),
    "vals_split_default_geometry": (dict(nr_frags=3000, nr_sites=30000,
                                         max_len=24), 1, 30000,
                                    dict(fused=False)),
    "classic_fused_false": (dict(nr_frags=500, nr_sites=4000, max_len=10,
                                 max_count=3000), 1, 4000,
                            dict(SMALL, fused=False)),
    # the lane-count form: the JAX package's WGBS_TPU_V3_VALS=0 (9 fields)
    "lane": (dict(nr_frags=2000, nr_sites=5000, max_len=16, h_rate=0.05),
             1, 5000, dict(SMALL, vals=False)),
    "lane_one_class": (dict(nr_frags=1500, nr_sites=5000, max_len=20),
                       1, 5000, dict(SMALL, vals=False, classes=None)),
    "lane_left_edge_long": (dict(nr_frags=300, nr_sites=6000, max_len=300,
                                 max_count=120), 2500, 2048,
                            dict(SMALL, vals=False)),
    "lane_default_geometry": (dict(nr_frags=3000, nr_sites=30000,
                                   max_len=24), 1, 30000, dict(vals=False)),
    # lane_counts=False with every count < 256: the classic form (the
    # tiled grid's staging, WGBS_TPU_V3_LANE_COUNTS=0)
    "classic_lane_counts_off": (dict(nr_frags=2000, nr_sites=5000,
                                     max_len=16), 1, 5000,
                                dict(SMALL, lane_counts=False)),
    "classic_lane_counts_off_default": (dict(nr_frags=3000, nr_sites=30000,
                                             max_len=24), 1, 30000,
                                        dict(lane_counts=False)),
    # the gates: vals needs lane_counts, and a count >= 256 leaves the
    # lane-count form for the classic one
    "classic_vals_without_lane_counts": (dict(nr_frags=500, nr_sites=4000,
                                              max_len=10), 1, 4000,
                                         dict(SMALL, lane_counts=False,
                                              vals=True)),
    "classic_lane_counts_3000": (dict(nr_frags=500, nr_sites=4000,
                                      max_len=10, max_count=3000), 1, 4000,
                                 dict(SMALL, vals=False)),
    # the native prep against the JAX package's split, clip and piece order
    "vals_lengths_127_to_257": (edge_lengths, 1, 6400, SMALL),
    "lane_lengths_127_to_257": (edge_lengths, 1, 6400,
                                dict(SMALL, vals=False)),
    "classic_lengths_127_to_257": (edge_lengths, 1, 6400,
                                   dict(SMALL, lane_counts=False)),
    "vals_ont_like": (ont_like, 1, 33_000, SMALL),
    "vals_ont_like_default_geometry": (ont_like, 1, 33_000, {}),
    "lane_ont_like": (ont_like, 1, 33_000, dict(SMALL, vals=False)),
    "classic_ont_like": (ont_like, 1, 33_000, dict(SMALL, lane_counts=False)),
    "vals_unsorted_long": (unsorted_long, 1, 8500, SMALL),
    "lane_unsorted_long": (unsorted_long, 1, 8500, dict(SMALL, vals=False)),
    "classic_unsorted_long": (unsorted_long, 1, 8500,
                              dict(SMALL, lane_counts=False)),
    "vals_left_edge_cuts_long": (left_edge_cuts_long, 2500, 2048, SMALL),
    "lane_left_edge_cuts_long": (left_edge_cuts_long, 2500, 2048,
                                 dict(SMALL, vals=False)),
    "classic_left_edge_cuts_long": (left_edge_cuts_long, 2500, 2048,
                                    dict(SMALL, lane_counts=False)),
    # every line clipped away: no piece, the classic form
    "classic_clipped_away": (before_window, 5000, 1000, SMALL),
    "classic_clipped_away_lane": (before_window, 5000, 1000,
                                  dict(SMALL, vals=False)),
    # the gates with long lines: a count of 255 keeps the count-per-byte
    # forms, 256 takes the classic one
    "vals_counts_255_long": (partial(ont_like, top_count=255), 1, 33_000,
                             SMALL),
    "lane_counts_255_long": (partial(ont_like, top_count=255), 1, 33_000,
                             dict(SMALL, vals=False)),
    "classic_counts_256_long": (partial(ont_like, top_count=256), 1, 33_000,
                                SMALL),
    "classic_counts_256_long_lane": (partial(ont_like, top_count=256), 1,
                                     33_000, dict(SMALL, vals=False)),
}

WIDTH = {"vals": 10, "lane": 9, "classic": 8}


def assert_same_staged(a, b):
    if isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            assert_same_staged(x, y)
        return
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("case", sorted(CASES))
def test_stage_v3_equals_jax(case):
    spec, ws, wl, geo = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    if callable(spec):
        frags = spec(rng)
    else:
        f = random_frags(rng, **spec)
        frags = (f.start, f.length, f.count, f.codes)
    want = jax_v3.stage_v3(*frags, ws, wl, **geo)
    got = pileup_v3.stage_v3(*frags, ws, wl, **geo)
    assert_same_staged(want, got)
    form = next((f for f in ("classic", "lane") if case.startswith(f)),
                "vals")
    assert isinstance(got, list) == (form != "vals" and
                                     geo.get("classes", "auto") is not None)
    one = got[0] if isinstance(got, list) else got
    assert len(one) == WIDTH[form]
    if form == "vals":  # cv is None exactly for the fused plane
        assert (one[4] is None) == geo.get("fused", True)
    if form == "lane":  # (n_chunks * rc, 32) count words, counts < 256
        assert one[4].dtype == np.int32 and one[4].shape == (
            one[3].shape[0], 32)


def test_stage_v3_empty_batch_equals_jax():
    from wgbs_tools_tpu.formats.pat import empty_frags

    f = empty_frags()
    want = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 1500)
    got = pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 1500)
    assert_same_staged(want, got)


@pytest.mark.parametrize("fn,counts", [("pack_rows_native", 5),
                                       ("place_vals_native", 5),
                                       ("place_pack_native", 3000)])
def test_staging_raises_without_native(monkeypatch, fn, counts):
    """The JAX package falls back (to v2 or other staged forms) when a
    native call returns None; the port raises."""
    import wgbs_tools_tpu_torch.native as nat

    f = random_frags(np.random.default_rng(3), 200, 2000, max_count=counts)
    monkeypatch.setattr(nat, fn, lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no fallback"):
        pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 2000)


def test_lane_staging_raises_without_place_counts(monkeypatch):
    """The JAX package's stage_v3 returns None when place_counts fails
    (and pileup_pallas_v3 drops to v2); the port raises."""
    import wgbs_tools_tpu_torch.native as nat

    f = random_frags(np.random.default_rng(5), 200, 2000)
    monkeypatch.setattr(nat, "place_counts_native", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no fallback"):
        pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 2000,
                           vals=False)
    # the other forms do not place count words
    assert len(pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1,
                                  2000)) == 10


def test_staging_raises_without_native_lib(monkeypatch, tmp_path):
    """The port builds its own host library with g++; a source that does
    not compile makes staging raise, with g++'s output."""
    import wgbs_tools_tpu_torch.native as nat

    broken = tmp_path / "wgbsio.cpp"
    broken.write_text("int pat_scan(;\n")
    monkeypatch.setattr(nat, "_LIB", None)
    monkeypatch.setattr(nat, "SOURCE", str(broken))
    monkeypatch.setattr(nat, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(nat, "_SO", str(tmp_path / "build" / "lib.so"))
    f = random_frags(np.random.default_rng(4), 50, 1000)
    with pytest.raises(RuntimeError, match=r"could not be built(.|\n)*g\+\+ failed"):
        pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 1000)
