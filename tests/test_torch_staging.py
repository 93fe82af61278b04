"""The port's v3 host staging equals the JAX package's stage_v3, array for
array (tolerance 0), for the value-plane form (fused and split planes) and
the classic form, and raises where the JAX package would fall back."""

import numpy as np
import pytest

pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.native import get_lib  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu3 as jax_v3  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v3  # noqa: E402

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native packer unavailable")

SMALL = dict(tile=512, rc=64, g_max=4)

# (fragments, window_start, window_len, geometry); fragments from a seed
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
}


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
    kw, ws, wl, geo = CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case) + 11)
    f = random_frags(rng, **kw)
    want = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl, **geo)
    got = pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             **geo)
    assert_same_staged(want, got)
    form = "classic" if case.startswith("classic") else "vals"
    assert isinstance(got, list) == (form == "classic" and
                                     geo.get("classes", "auto") is not None)
    one = got[0] if isinstance(got, list) else got
    assert (len(one) == 10) == (form == "vals")
    if form == "vals":  # cv is None exactly for the fused plane
        assert (one[4] is None) == geo.get("fused", True)


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
    import wgbs_tools_tpu.native as nat

    f = random_frags(np.random.default_rng(3), 200, 2000, max_count=counts)
    monkeypatch.setattr(nat, fn, lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="no fallback"):
        pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 2000)


def test_staging_raises_without_native_lib(monkeypatch):
    import wgbs_tools_tpu.native as nat

    f = random_frags(np.random.default_rng(4), 50, 1000)
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    with pytest.raises(RuntimeError, match="could not be built"):
        pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 1000)
