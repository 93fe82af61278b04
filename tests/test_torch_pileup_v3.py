"""The v3 kernels' plain twins equal the JAX package's Pallas kernels
(interpret mode) on identical staged inputs, with tolerance 0; the CUDA
kernels equal their twins on the card."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from synth import random_frags  # noqa: E402
from wgbs_tools_tpu.native import get_lib  # noqa: E402
from wgbs_tools_tpu.ops import pileup_tpu3 as jax_v3  # noqa: E402
from wgbs_tools_tpu.ops.pileup import pileup_xla  # noqa: E402
from wgbs_tools_tpu_torch.ops import pileup_v3  # noqa: E402

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native packer unavailable")

SMALL = dict(tile=512, rc=64, g_max=4)

# (random_frags kwargs, window_start, window_len, geometry, form)
CASES = {
    "vals_dense": (dict(nr_frags=2500, nr_sites=5000, max_len=18,
                        dot_rate=0.05, h_rate=0.05), 1, 5000, SMALL, "vals"),
    "vals_empty_tiles": (dict(nr_frags=40, nr_sites=30000, max_len=10),
                         1, 30000, SMALL, "vals"),
    "vals_left_edge": (dict(nr_frags=2000, nr_sites=6000, max_len=16),
                       2500, 2048, SMALL, "vals"),
    "vals_long_frags": (dict(nr_frags=300, nr_sites=9000, max_len=400),
                        1, 9000, SMALL, "vals"),
    "classic_counts_3000": (dict(nr_frags=300, nr_sites=4000, max_len=10,
                                 max_count=3000, dot_rate=0.1, h_rate=0.05),
                            1, 4000, SMALL, "classic"),
    "classic_empty_tiles_left_edge": (dict(nr_frags=60, nr_sites=20000,
                                           max_len=150, max_count=3000),
                                      700, 15000, SMALL, "classic"),
}


def _case(name):
    kw, ws, wl, geo, form = CASES[name]
    rng = np.random.default_rng(sorted(CASES).index(name) + 101)
    return random_frags(rng, **kw), ws, wl, geo, form


def _jax_pileup(staged, wl):
    """JAX call_staged (Pallas, interpret mode) summed over rc classes."""
    out = np.zeros((wl, 2), np.int64)
    for st in staged if isinstance(staged, list) else [staged]:
        m, c = jax_v3.call_staged(st, wl, interpret=True)
        out += np.stack([np.asarray(m), np.asarray(c)], axis=1)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_equals_jax_kernel(name):
    f, ws, wl, geo, form = _case(name)
    staged = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                             **geo)
    port = pileup_v3.staged_from_numpy(staged, "cpu")
    for st in port if isinstance(port, list) else [port]:
        assert st.form == form
    got = pileup_v3.call_staged(port, wl)
    assert got.dtype == torch.int32 and tuple(got.shape) == (wl, 2)
    want = _jax_pileup(staged, wl)
    assert np.array_equal(got.numpy(), want)
    # and both equal the scatter oracle
    assert np.array_equal(want, pileup_xla(f.start, f.length, f.count,
                                           f.codes, ws, wl))
    if name.endswith("empty_tiles"):
        one = staged[0] if isinstance(staged, list) else staged
        assert ((one[1] - one[0]) == 0).any()


def test_pileup_v3_equals_jax_default_geometry():
    """End to end at the default geometry (rc=1024, tile_sb=64): the port's
    staging + twin against pileup_pallas_v3 in interpret mode."""
    f = random_frags(np.random.default_rng(7), 3000, 20000, max_len=24)
    want = jax_v3.pileup_pallas_v3(f.start, f.length, f.count, f.codes, 1,
                                   20000, interpret=True)
    got = pileup_v3.pileup_v3(f.start, f.length, f.count, f.codes, 1, 20000,
                              "cpu")
    assert np.array_equal(got.numpy(), want)


def test_staged_from_numpy_rejects_unported_forms():
    f = random_frags(np.random.default_rng(8), 200, 3000)
    split = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                            fused=False, **SMALL)
    with pytest.raises(ValueError, match="split value planes"):
        pileup_v3.staged_from_numpy(split, "cpu")
    lane = jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                           vals=False, **SMALL)
    with pytest.raises(ValueError, match="lane-count"):
        pileup_v3.staged_from_numpy(lane, "cpu")
    good = list(jax_v3.stage_v3(f.start, f.length, f.count, f.codes, 1, 3000,
                                **SMALL))
    good[1] = good[1] + 10**6  # c1 past the chunk count
    with pytest.raises(ValueError, match="out of bounds"):
        pileup_v3.staged_from_numpy(tuple(good), "cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_cuda_kernel_equals_twin(cuda_device, name):
    f, ws, wl, geo, form = _case(name)
    staged = pileup_v3.stage_v3(f.start, f.length, f.count, f.codes, ws, wl,
                                **geo)
    port = pileup_v3.staged_from_numpy(staged, cuda_device)
    if form == "vals":
        kernel, plain = (pileup_v3.flat_vals_fused,
                         pileup_v3.flat_vals_fused_plain)
    else:
        kernel, plain = pileup_v3.flat_classic, pileup_v3.flat_classic_plain
    before = kernel.launches
    got = pileup_v3.call_staged(port, wl)
    torch.cuda.synchronize()
    assert kernel.launches > before
    want = sum(plain(st, wl) for st in (port if isinstance(port, list)
                                        else [port]))
    assert torch.equal(got, want)
    assert np.array_equal(got.cpu().numpy(), pileup_xla(
        f.start, f.length, f.count, f.codes, ws, wl))
