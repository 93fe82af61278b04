"""The port's parallel layer (parallel/mesh.py, parallel/sharded.py,
ops/dp_scan.py) against the JAX package's parallel/sharded.py on its
8-device CPU mesh, on the same seeded numpy inputs: bucket_fragments, the
local pileup, the segmentation cost (rtol 1e-6: the f32 log2 differs from
XLA's by ulps), the serial DP on JAX's cost (bit for bit), the coverage
pair, the analysis step, the halo ShardedPileup, the window-sharded
segmentation and the multi-card route. Tolerance 0 elsewhere. Tests
marked cuda hold the kernels (dp_scan, tiles_v1 under _local_pileup) to
their twins on the card and skip without one."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from synth import random_frags  # noqa: E402
from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu.formats.pat import CODE_C  # noqa: E402
from wgbs_tools_tpu.models import segment as jseg  # noqa: E402
from wgbs_tools_tpu.ops.pileup import pileup_xla  # noqa: E402
from wgbs_tools_tpu.parallel import sharded as J  # noqa: E402
from wgbs_tools_tpu.parallel.mesh import make_mesh as jax_mesh  # noqa: E402
from wgbs_tools_tpu.parallel.mesh import \
    pad_to_multiple as jax_pad  # noqa: E402
from wgbs_tools_tpu_torch.models import segment as pseg  # noqa: E402
from wgbs_tools_tpu_torch.ops import dp_scan as pdp  # noqa: E402
from wgbs_tools_tpu_torch.ops.pileup_v1 import pileup_v1  # noqa: E402
from wgbs_tools_tpu_torch.parallel import sharded as P  # noqa: E402
from wgbs_tools_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh,
    make_mesh,
    pad_to_multiple,
)

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="the JAX package's native library "
                                       "(the reference) is unavailable")

NEG = float("-inf")


def _mesh(a, b):
    """The port's (a, b) mesh of CPU stand-in devices."""
    return make_mesh(a * b, samples_axis=a, device="cpu")


def test_make_mesh_and_pad():
    m = _mesh(2, 4)
    assert isinstance(m, Mesh) and m.shape == {"samples": 2, "sites": 4}
    assert m.size == 8 and m.devices == [torch.device("cpu")] * 8
    assert m.device(1, 3) == torch.device("cpu")
    assert make_mesh(device="cpu").shape == {"samples": 1, "sites": 1}
    devs = [torch.device("cpu")] * 6
    assert make_mesh(4, devices=devs).size == 4
    with pytest.raises(ValueError, match="cannot host 3 sample shards"):
        make_mesh(4, samples_axis=3, device="cpu")
    rng = np.random.default_rng(1)
    for shape, mult, axis, fill in [((10, 3), 4, 0, 0), ((7,), 7, 0, 3),
                                    ((2, 5), 3, 1, -1)]:
        x = rng.integers(0, 9, size=shape)
        assert np.array_equal(pad_to_multiple(x, mult, axis, fill),
                              jax_pad(x, mult, axis, fill))


def _frags(seed, n_frags, n_sites, max_len=14, past=0):
    """Sorted random fragments; with `past`, some start past n_sites (the
    last shard's clip)."""
    rng = np.random.default_rng(seed)
    f = random_frags(rng, n_frags, n_sites - 20, max_len=max_len)
    if past:
        f.start[-past:] = n_sites + rng.integers(0, 30, size=past)
    return f


@pytest.mark.parametrize("n_shards,base,fp_mult,max_len",
                         [(4, 1, 1, None), (3, 1, 64, 32), (8, 101, 16, None),
                          (1, 1, 1, 20)])
def test_bucket_fragments_equals_jax(n_shards, base, fp_mult, max_len):
    n_sites = 1200
    f = _frags(3 + n_shards, 500, n_sites, past=7)
    args = (f.start + (base - 1), f.length, f.count, f.codes, n_sites,
            n_shards)
    kw = dict(max_len=max_len, base=base, fp_mult=fp_mult)
    want = J.bucket_fragments(*args, **kw)
    got = P.bucket_fragments(*args, **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    # the clip: fragments starting past the last shard go to the last shard
    S = n_sites // n_shards
    assert (got[0].reshape(n_shards, -1)[-1] >= S).any()


def _bucketed(seed, n_sites, n_shards, n_frags=600, max_len=14):
    f = _frags(seed, n_frags, n_sites, max_len=max_len, past=5)
    return J.bucket_fragments(f.start, f.length, f.count, f.codes, n_sites,
                              n_shards)


@pytest.mark.parametrize("out_len", [256 + 32, 256, 200])
def test_local_pileup_plain_equals_jax(out_len):
    """JAX's _local_pileup and the twin on a shard's rows (padding rows,
    sites past out_len; negative starts in the second half); the card's
    path (padding rows dropped, then v1's staging, here with its twin)
    gives the same table."""
    rs, ln, cn, cd = _bucketed(11, 1024, 4)
    rs = rs.copy()
    rs[len(rs) // 2:] -= 20  # some rows start before the window
    want = np.asarray(J._local_pileup(jnp.asarray(rs), jnp.asarray(ln),
                                      jnp.asarray(cn), jnp.asarray(cd),
                                      out_len))
    got = P._local_pileup(rs, ln, cn, cd, out_len, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (out_len, 2)
    assert np.array_equal(got.numpy(), want) and want[:, 1].sum() > 0
    keep = (ln > 0) & (cn != 0)
    v1 = pileup_v1(rs[keep], ln[keep], cn[keep], cd[keep], 0, out_len, "cpu")
    assert np.array_equal(v1.numpy(), want)


def _cost_inputs(seed, S):
    rng = np.random.default_rng(seed)
    cov = rng.integers(0, 25, size=S)
    cov[S // 3:S // 3 + 40] = 0  # windows of no coverage
    meth = rng.binomial(cov, np.repeat(rng.random(S // 50 + 1), 50)[:S])
    counts = np.stack([meth, cov], axis=1).astype(np.int32)
    loci = (np.cumsum(rng.integers(2, 60, size=S)) + 9).astype(np.int32)
    return counts, loci


def _jax_cost(counts, loci, W, max_bp, pc):
    return np.asarray(J._segment_cost_local(jnp.asarray(counts),
                                            jnp.asarray(loci), W, max_bp, pc))


@pytest.mark.parametrize("pc", [1.0, 15.0])
@pytest.mark.parametrize("max_bp", [0, 1500])
@pytest.mark.parametrize("W", [8, 32])
def test_segment_cost_local_equals_jax(W, max_bp, pc, monkeypatch):
    counts, loci = _cost_inputs(W + max_bp, 300)
    want = _jax_cost(counts, loci, W, max_bp, pc)
    ct, lt = torch.from_numpy(counts), torch.from_numpy(loci)
    got = P._segment_cost_local(ct, lt, W, max_bp, pc).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(want[np.isfinite(want)]).all() and \
        np.isfinite(got[~np.isneginf(got)]).all()
    fin = np.isfinite(want)
    assert fin.sum() > 100
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    # built a few rows at a time, and added into a running cost: the same
    # values and the same f32 adds
    monkeypatch.setattr(P, "COST_CHUNK", 7 * W)
    assert np.array_equal(P._segment_cost_local(ct, lt, W, max_bp,
                                                pc).numpy(), got)
    base = torch.full((300, W), 2.5)
    out = P._segment_cost_local(ct, lt, W, max_bp, pc, out=base)
    assert out is base and np.array_equal(out.numpy(),
                                          np.float32(2.5) + got)


def _dp_cases():
    """(name, Crev (nb, n, W) f32): JAX's cost rows, and hand-made edges."""
    cases = []
    for W in (8, 16, 32):
        counts, loci = _cost_inputs(W, 400)
        cases.append((f"cost W{W}", _jax_cost(counts, loci, W, 1500,
                                              15.0)[None]))
    rng = np.random.default_rng(9)
    W, n = 16, 120
    C = rng.normal(size=(3, n, W)).astype(np.float32)
    C[0, 40:44] = NEG              # rows of -inf: am = 0
    C[1] = np.round(C[1])          # exact ties everywhere
    C[2, 50:60, ::2] = -1.0        # ties within a row
    valid = (np.arange(n)[:, None] - (W - 1) + np.arange(W)[None, :]) >= 0
    cases.append(("nb 3, -inf rows, ties", np.where(valid, C, NEG)))
    cases.append(("n < W", rng.normal(size=(2, 5, 12)).astype(np.float32)))
    C = rng.normal(size=(1, 60, 40)).astype(np.float32)
    C[0, 30, 7] = np.nan           # JAX's argmax takes the first NaN
    C[0, 45, [3, 9]] = np.nan
    cases.append(("NaN", C))
    cases.append(("W 1", rng.normal(size=(2, 30, 1)).astype(np.float32)))
    C = np.zeros((1, 50, 33), np.float32)
    C[0, ::3] = -0.0               # -0.0 ties +0.0
    cases.append(("signed zeros, W 33", C))
    W = 12
    C = rng.normal(size=(2, 40, W)).astype(np.float32)
    C[0, 2, 1] = np.inf            # -inf + +inf: NaN in the first W steps
    C[1, :W, ::4] = np.inf
    cases.append(("+inf in the first W steps", C))
    # the oldest (k = 0) and newest (k = W-1) candidates tie exactly: every
    # other cost is -inf and those two are 0 (-0.0 at k = 0 on odd rows), so
    # M stays 0 and from step W-1 on both sums are 0; the first, k = 0,
    # wins (the seam between candidates folded ahead and the chain's own)
    for W in (6, 64):
        C = np.full((1, 150, W), NEG, np.float32)
        C[0, :, 0] = 0.0
        C[0, 1::2, 0] = -0.0
        C[0, :, W - 1] = 0.0
        cases.append((f"oldest and newest tie, W {W}", C))
    for W, n in ((2, 33), (3, 41), (65, 100)):
        C = np.round(rng.normal(size=(2, n, W))).astype(np.float32)
        cases.append((f"W {W}", C))
    return cases


DP_CASES = _dp_cases()


@pytest.mark.parametrize("case", range(len(DP_CASES)),
                         ids=[c[0] for c in DP_CASES])
def test_dp_scan_plain_equals_jax(case):
    """The twin (and dp_scan, which takes it for CPU tensors) on JAX's cost
    rows and on the edges: ks equal JAX's _dp_scan bit for bit, every
    chain of a batch its own."""
    _, C = DP_CASES[case]
    W = C.shape[2]
    launches = pdp.dp_scan.launches
    want = np.stack([np.asarray(J._dp_scan(jnp.asarray(c), W)) for c in C])
    got = pdp.dp_scan_plain(torch.from_numpy(C.copy()), W)
    assert got.dtype == torch.int32 and got.shape == C.shape[:2]
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(pdp.dp_scan(torch.from_numpy(C.copy()), W).numpy(),
                          want)
    assert pdp.dp_scan.launches == launches  # CPU tensors: no launch


def test_dp_scan_refuses_bad_input():
    with pytest.raises(ValueError, match="contiguous torch.float32"):
        pdp.dp_scan(torch.zeros((2, 3, 4), dtype=torch.float64), 4)
    with pytest.raises(ValueError, match="last axis"):
        pdp.dp_scan(torch.zeros((2, 3, 4)), 5)
    assert pdp.dp_scan(torch.zeros((2, 0, 4)), 4).shape == (2, 0)


@pytest.mark.parametrize("total", [2**31 + 12345, 2**32 - 7, 2**32 + 3,
                                   3 * 2**32 + 2**31, 2**40 + 987654321,
                                   1000, 0])
def test_decode_sum64_equals_jax(total):
    """JAX's test_decode_sum64_past_int32 shape: 4 site shards of int32
    coverage summing past 2^31 and 2^32; lo equals JAX's, and both pairs
    decode to the exact total."""
    from jax.sharding import PartitionSpec as PS

    n = 1 << 12
    base, rem = divmod(total, n)
    x = np.full(n, base, dtype=np.int64)
    x[:rem] += 1
    x32 = x.astype(np.int32)
    step = jax.jit(J.shard_map(lambda v: J._psum64(v, ("sites",)),
                               jax_mesh(4, samples_axis=1),
                               in_specs=(PS("sites"),),
                               out_specs=(PS(), PS())))
    jlo, jf = step(jnp.asarray(x32))
    lo, f = P._psum64(list(torch.from_numpy(x32).chunk(4)))
    assert lo.dtype == np.int32 and f.dtype == np.float32
    assert int(lo) == int(np.asarray(jlo))
    assert P.decode_sum64(lo, f) == J.decode_sum64(jlo, jf) == total


def _step_inputs(rng, a, b, S, W):
    n_sites = S * b
    K = 2 * a
    cov = rng.integers(1, 25, size=(K, n_sites))
    meth = rng.binomial(cov, np.repeat(rng.random((K, n_sites // 64)), 64,
                                       axis=1))
    sample_counts = np.stack([meth, cov], axis=-1).astype(np.int32)
    loci = (np.cumsum(rng.integers(2, 60, size=n_sites)) + 9).astype(np.int32)
    frags = random_frags(rng, 600, n_sites - 40, max_len=14)
    bucket = J.bucket_fragments(frags.start, frags.length, frags.count,
                                frags.codes, n_sites, b)
    return frags, bucket, sample_counts, loci


def _borders_per_window(tb, S, n_shards):
    return [jseg._traceback(np.concatenate([[0], tb[w * S:(w + 1) * S]]), S)
            .tolist() for w in range(n_shards)]


@pytest.mark.parametrize("a,b", [(1, 4), (2, 2), (2, 4)])
def test_analysis_step_equals_jax(a, b):
    """The step on a CPU stand-in mesh: counts equal JAX's (and the
    single-device pileup), the coverage pair decodes to JAX's total, and
    every window's borders from tb equal JAX's."""
    rng = np.random.default_rng(100 + 10 * a + b)
    S, W, halo = 256, 32, 16
    n_sites = S * b
    frags, bucket, sample_counts, loci = _step_inputs(rng, a, b, S, W)
    jstep = J.build_analysis_step(jax_mesh(a * b, samples_axis=a), n_sites,
                                  halo=halo, W=W, max_bp=1500, pc=15.0)
    jc, jtb, jlo, jf = jstep(*(jnp.asarray(x) for x in bucket),
                             jnp.asarray(sample_counts),
                             jnp.asarray(loci[:, None]))
    step = P.AnalysisStep(_mesh(a, b), n_sites, halo, W, 1500, 15.0)
    counts, tb, lo, f = step(*bucket, sample_counts, loci[:, None])
    assert counts.dtype == tb.dtype == torch.int32
    assert counts.shape == (n_sites, 2) and tb.shape == (n_sites,)
    assert np.array_equal(counts.numpy(), np.asarray(jc))
    assert np.array_equal(counts.numpy(), pileup_xla(
        frags.start, frags.length, frags.count, frags.codes, 1, n_sites))
    assert P.decode_sum64(lo, f) == J.decode_sum64(jlo, jf) \
        == int(np.asarray(jc)[:, 1].sum())
    assert _borders_per_window(tb.numpy(), S, b) == \
        _borders_per_window(np.asarray(jtb), S, b)


def test_analysis_step_halo_crossing_reads():
    """JAX's test_halo_crossing_reads: fragments straddling the shard
    borders land in the next shard through the halo."""
    starts = np.array([250, 255, 256, 511, 512, 767, 1000], dtype=np.int32)
    lengths = np.full(7, 12, dtype=np.int32)
    counts = np.arange(1, 8, dtype=np.int32)
    codes = np.full((7, 12), CODE_C, dtype=np.uint8)
    n_sites = 1024
    bucket = P.bucket_fragments(starts, lengths, counts, codes, n_sites, 4)
    sample_counts = np.zeros((1, n_sites, 2), dtype=np.int32)
    loci = np.arange(1, n_sites + 1, dtype=np.int32) * 3
    jstep = J.build_analysis_step(jax_mesh(4, samples_axis=1), n_sites,
                                  halo=32, W=8, max_bp=0, pc=1.0)
    want = np.asarray(jstep(*(jnp.asarray(x) for x in bucket),
                            jnp.asarray(sample_counts),
                            jnp.asarray(loci[:, None]))[0])
    got = P.AnalysisStep(_mesh(1, 4), n_sites, 32, 8, 0, 1.0)(
        *bucket, sample_counts, loci)[0].numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, pileup_xla(starts, lengths, counts, codes, 1,
                                          n_sites))
    assert got[256:270, 1].sum() > 0  # the crossers reached the next shard


def test_analysis_step_refuses_bad_shapes():
    mesh = _mesh(2, 2)
    with pytest.raises(ValueError, match="multiple of the 2 site shards"):
        P.AnalysisStep(mesh, 1001, 8, 8)
    with pytest.raises(ValueError, match="halo=600"):
        P.AnalysisStep(mesh, 1000, 600, 8)
    step = P.AnalysisStep(mesh, 1000, 8, 8)
    bucket = P.bucket_fragments(np.array([5]), np.array([3]), np.array([1]),
                                np.ones((1, 3), np.uint8), 1000, 2)
    with pytest.raises(ValueError, match="K a multiple of 2"):
        step(*bucket, np.zeros((3, 1000, 2), np.int32),
             np.arange(1000, dtype=np.int32))


def test_sharded_pileup_equals_jax():
    """The halo ShardedPileup over streamed batches, one of them with
    fragments longer than the halo (it grows), equals JAX's: result and
    finalize (uint8 and uint16)."""
    n_sites = 12000
    rng = np.random.default_rng(31)
    f = random_frags(rng, 4000, n_sites - 80, max_len=18,
                     max_count=40).sort().collapse()
    long = random_frags(rng, 30, n_sites - 80, max_len=70,
                        max_count=3).sort().collapse()
    bounds = [0, 700, 1100, 2500, f.nr_frags]
    batches = [f.take(np.arange(lo, hi))
               for lo, hi in zip(bounds[:-1], bounds[1:])]
    batches.insert(2, long)
    jacc = J.ShardedPileup(jax_mesh(4, samples_axis=1), (1, n_sites + 1),
                           halo=32, fp_mult=64)
    acc = P.ShardedPileup(_mesh(1, 4), (1, n_sites + 1), halo=32,
                          fp_mult=64)
    halos = []
    for b in batches:
        jacc.add(b)
        acc.add(b)
        halos.append((acc.halo, jacc.halo))
    assert all(h == j for h, j in halos) and halos[-1][0] == 128
    got = acc.result()
    assert got.dtype == np.int64 and got.shape == (n_sites, 2)
    assert np.array_equal(got, jacc.result())
    assert (got[:, 1] > 255).any()
    for lbeta in (False, True):
        want = jacc.finalize(lbeta)
        fin = acc.finalize(lbeta)
        assert fin.dtype == want.dtype and np.array_equal(fin, want)


@pytest.fixture(scope="module")
def windows():
    """JAX's test_segment_windows_sharded_matches_single_device data, 9
    windows: not a multiple of 4 devices, and more than one launch."""
    rng = np.random.default_rng(17)
    n, K, nw = 600, 2, 9
    datas = np.zeros((nw, K, n, 2), dtype=np.int64)
    locis = np.zeros((nw, n), dtype=np.int64)
    for w in range(nw):
        cov = rng.integers(1, 20, size=(K, n))
        datas[w, :, :, 0] = rng.binomial(cov, rng.random((K, 1)))
        datas[w, :, :, 1] = cov
        locis[w] = np.cumsum(rng.integers(2, 100, size=n)) + 50
    return datas, locis


def test_segment_windows_sharded_equals_jax(windows):
    datas, locis = windows
    kw = dict(max_cpg=150, max_bp=2000, pseudo_count=15.0)
    want = J.segment_windows_sharded(jax_mesh(4, samples_axis=1), datas,
                                     locis, **kw)
    timings = {}
    got = P.segment_windows_sharded(_mesh(1, 4), datas, locis, **kw,
                                    timings=timings)
    single = pseg.segment_windows_fast(datas, locis, **kw, device="cpu")
    assert len(got) == len(want) == len(single) == datas.shape[0]
    for g, w, s in zip(got, want, single):
        assert g.dtype == np.int64 and g[0] == 0 and g[-1] == 600
        assert g.tolist() == w.tolist() == s.tolist()
    assert set(timings) == {"dp", "mask_fetch"}


def test_segment_chunks_routes_to_sharded(monkeypatch, windows):
    """Fast mode with device "cuda" and more than one visible card sends
    each equal-size chunk group to segment_windows_sharded over every card
    (the CPU stands in for the cards here); one card, or a card named by
    index, keeps segment_windows_fast."""
    import wgbs_tools_tpu_torch.parallel.sharded as sharded

    calls = []
    fast = pseg.segment_windows_fast

    def fake(mesh, datas, locis, *args, **kw):
        calls.append(mesh)
        return fast(datas, locis, *args, device="cpu")

    monkeypatch.setattr(sharded, "segment_windows_sharded", fake)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    datas, locis = windows

    class _Idx:
        loci = locis.reshape(-1)

    chunks = [(1 + 600 * i, 1 + 600 * (i + 1)) for i in range(4)]
    monkeypatch.setattr(pseg, "_load_windows", lambda b, w, i: (
        datas[[(s - 1) // 600 for s, _ in w]],
        locis[[(s - 1) // 600 for s, _ in w]]))
    want = [b + s for b, (s, _) in zip(fast(
        datas[:4], locis[:4], 150, 2000, 15.0, device="cpu"), chunks)]
    for n_cards, device, routed in ((4, "cuda", True), (1, "cuda", False),
                                    (4, "cuda:1", False)):
        calls.clear()
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
        cfg = pseg.SegmentConfig(max_cpg=150, max_bp=2000, mode="fast",
                                 device=device)
        if not routed:
            # the single-device route would launch on the card: stand in
            monkeypatch.setattr(pseg, "segment_windows_fast",
                                lambda d, l, *a, **k: fake(None, d, l, *a))
        got = pseg.segment_chunks(["x.beta"], chunks, _Idx, cfg)
        assert [g.tolist() for g in got] == [w.tolist() for w in want]
        if routed:
            assert len(calls) == 1 and calls[0].size == 4
            assert calls[0].devices == [torch.device("cuda", i)
                                        for i in range(4)]
        else:
            assert calls == [None]


# ---------------------------------------------------------------------------
# the kernels on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_dp_scan_equals_twin(cuda_device):
    """dp_scan on the card == its twin on the edges above, on
    chip_smoke.dp_edge_batch (W 1-3, 31-33, 63-65, both sides of each
    body's threshold, n < W, nb 1 and 3, ties, +inf in the first W steps,
    the oldest and newest candidates tied) and on W above 32, not a
    multiple of 32, n not a multiple of 32 and nb 3. Each case's body is
    asked of the C entry (dp_plan) and must be the one its W's range
    names; the analysis step's W 64 takes the push body, and every body is
    held."""
    import chip_smoke

    edges = chip_smoke.dp_body_edges()
    assert pdp.dp_plan(1000, 64)["body"] == "push"
    rng = np.random.default_rng(23)
    cases = [C for _, C in DP_CASES]
    cases += [C for _, C in chip_smoke.dp_edge_batch(edges)]
    for nb, n, W in ((3, 700, 64), (2, 300, 100), (1, 40, 1000), (2, 9, 70),
                     (1, 1000, 64), (3, 333, 37)):
        C = rng.normal(size=(nb, n, W)).astype(np.float32)
        C[:, :, ::5] = np.round(C[:, :, ::5])
        cases.append(C)
    held = set()
    for C in cases:
        nb, n, W = C.shape
        body = pdp.dp_plan(n, W)["body"]
        assert body == pdp.BODIES[sum(W >= e for e in edges)], W
        held.add(body)
        Ct = torch.from_numpy(C.copy())
        before = pdp.dp_scan.launches
        got = pdp.dp_scan(Ct.to(cuda_device), W)
        torch.cuda.synchronize()
        assert pdp.dp_scan.launches == before + 1
        assert torch.equal(got.cpu(), pdp.dp_scan_plain(Ct, W)), (body, W)
    assert held == set(pdp.BODIES)


@pytest.mark.cuda
def test_cuda_local_pileup_equals_twin(cuda_device):
    """_local_pileup through tiles_v1 on the card == the twin."""
    from wgbs_tools_tpu_torch.ops import pileup_v1 as v1

    rs, ln, cn, cd = _bucketed(13, 4096, 4, n_frags=3000, max_len=40)
    for out_len in (1024 + 64, 1024, 700):
        before = v1.tiles_v1.launches
        got = P._local_pileup(rs, ln, cn, cd, out_len, device=cuda_device)
        assert v1.tiles_v1.launches == before + 1
        want = P._local_pileup(rs, ln, cn, cd, out_len, device="cpu")
        assert torch.equal(got.cpu(), want)
