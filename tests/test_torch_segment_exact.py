"""The port's exact segmentation on a torch device equals the JAX package's
device route and the host DP, with tolerance 0: the cost twin against
JAX's software-double cost pairs, the ring DP twin against JAX's ring DP
on JAX's own pairs, the route's tracebacks against JAX's and the native
host DP's, and the CLI's bytes against the host path's. The kernel itself
runs only on the card (the cuda-marked test)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from test_torch_oracle_lib import oracle_lib  # noqa: E402
from test_torch_segment import genome_betas  # noqa: E402,F401
from wgbs_tools_tpu import native as jnat  # noqa: E402
from wgbs_tools_tpu.models import segment_exact_tpu as jsx  # noqa: E402
from wgbs_tools_tpu_torch import native as pnat  # noqa: E402
from wgbs_tools_tpu_torch.models import segment as pseg  # noqa: E402
from wgbs_tools_tpu_torch.models import \
    segment_exact_device as sed  # noqa: E402
from wgbs_tools_tpu_torch.ops import segment_exact as se  # noqa: E402
from wgbs_tools_tpu_torch.utils import IllegalArgumentError  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="the JAX package's native library "
                                       "(the reference) is unavailable")


def _rand_window(rng, K, n, cov_hi, bp_step=60):
    """tests/test_segment_exact_tpu.py's _rand_window."""
    cov = rng.integers(0, cov_hi, size=(K, n))
    meth = rng.binomial(cov, rng.random((K, n, 1))[:, :, 0])
    data = np.stack([meth, cov], axis=2)
    loci = np.cumsum(rng.integers(2, bp_step, size=n)) + 100
    return data, loci


def _wrapped(data):
    """JAX's segment_exact_device_T prefix sums: int64, masked to int32."""
    d64 = np.asarray(data, dtype=np.int64)
    ps = np.concatenate([np.zeros((d64.shape[0], 1, 2), np.int64),
                         np.cumsum(d64, axis=1)], axis=1)
    pm = (ps[:, :, 0] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    pt = (ps[:, :, 1] & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return pm, pt


def _sizes(data, loci, W, max_bp, pc):
    """(table, Wb) as both routes size them for one window."""
    need = jsx.max_band_total(data, loci, W, max_bp) + 1
    cap = 1 << max(int(need - 1).bit_length(), 6)
    Wb = min(W, jsx._round_width(jsx.max_band_width(loci, W, max_bp)))
    return jsx.build_ll_table(pc, cap), Wb


def _pairs_f64(ch, cl):
    """JAX's (hi, lo) uint32 pairs viewed as float64."""
    ch = np.asarray(ch).astype(np.uint64)
    cl = np.asarray(cl).astype(np.uint64)
    return ((ch << np.uint64(32)) | cl).view(np.float64)


def _host_T(data, loci, W, max_bp, pc):
    return jnat.segment_exact_native(data, loci, W, max_bp, pc)


# the rows of test_segment_exact_tpu.py::test_device_T_equals_host_T
ROWS = [(1, 220, 5, 32, 2000), (3, 300, 12, 48, 2000),
        (5, 256, 25, 64, 1500), (2, 400, 8, 64, 0), (4, 180, 60, 32, 800)]


@pytest.mark.parametrize("K,n,cov_hi,W,max_bp", ROWS)
def test_cost_and_dp_twins_equal_jax(K, n, cov_hi, W, max_bp):
    """The cost twin's float64 == JAX's software-double pairs and its mask
    == JAX's; the ring DP twin on JAX's pairs == JAX's ring DP; the twin
    chain == the host DP (JAX's single-window DP, _dp_exact_body, is what
    JAX's segment_exact_device_T runs: the tests below hold the route to
    it)."""
    rng = np.random.default_rng(100 * K + n)
    data, loci = _rand_window(rng, K, n, cov_hi)
    tbl, Wb = _sizes(data, loci, W, max_bp, 15.0)
    pm, pt = _wrapped(data)
    ch, cl, ok = jsx._exact_cost_pairs(
        jnp.asarray(pm), jnp.asarray(pt), jnp.asarray(loci, dtype=jnp.int32),
        jsx._device_table(15.0, tbl), Wb, max_bp)
    want_C = _pairs_f64(ch, cl)
    tpm, tpt = torch.from_numpy(pm)[None], torch.from_numpy(pt)[None]
    tloci = torch.from_numpy(loci.astype(np.int32))[None]
    C, got_ok = se.exact_cost_plain(tpm, tpt, tloci, torch.from_numpy(tbl),
                                    Wb, max_bp)
    assert C.dtype == torch.float64 and tuple(C.shape) == (1, n, Wb)
    assert np.array_equal(got_ok[0].numpy(), np.asarray(ok))
    # bit for bit, masked cells included (+0.0 there in both)
    assert np.array_equal(C[0].numpy().view(np.int64), want_C.view(np.int64))

    ring_ks = np.asarray(jsx._dp_exact_batched_ring(
        ch[:, None], cl[:, None], ok[:, None], Wb))[0]
    ks = se.dp_exact_ring_plain(torch.from_numpy(want_C)[None],
                                torch.from_numpy(np.array(ok))[None])
    assert ks.dtype == torch.int32
    assert np.array_equal(ks[0].numpy(), ring_ks)

    T = sed.segment_exact_device_T(data, loci, W, max_bp, 15.0, device="cpu")
    assert np.array_equal(T[1:], ring_ks) and T[0] == 0
    assert np.array_equal(T[1:], _host_T(data, loci, W, max_bp, 15.0)[1:])


def test_twins_batched_equal_jax_and_host():
    """Several windows at once (B = 3): the cost twin over the batch ==
    JAX's cost of each window, and the DP twin's ks == the host DP's per window
    (test_batch_equals_jax_whatever_the_batch_size holds the batch to JAX's
    batched ring DP)."""
    rng = np.random.default_rng(11)
    wins = [_rand_window(rng, 2, 160, 9) for _ in range(3)]
    datas = np.stack([d for d, _ in wins])
    locis = np.stack([lo for _, lo in wins]).astype(np.int64)
    elig, tbl, Wb = sed.plan_windows(datas, locis, 40, 2000, 15.0)
    assert elig == [0, 1, 2] and Wb == 40
    pms, pts = zip(*(_wrapped(d) for d in datas))
    pm, pt = np.stack(pms), np.stack(pts)
    ch, cl, ok = (np.stack(x) for x in zip(*(jsx._exact_cost_pairs(
        jnp.asarray(pm[w]), jnp.asarray(pt[w]),
        jnp.asarray(locis[w], dtype=jnp.int32),
        jsx._device_table(15.0, tbl), Wb, 2000) for w in range(3))))
    want_ks = np.stack([_host_T(d, lo, 40, 2000, 15.0)[1:]
                        for d, lo in zip(datas, locis)])
    C, got_ok = se.exact_cost_plain(
        torch.from_numpy(pm), torch.from_numpy(pt),
        torch.from_numpy(locis.astype(np.int32)), torch.from_numpy(tbl), Wb,
        2000)
    assert np.array_equal(C.numpy().view(np.int64),
                          _pairs_f64(ch, cl).view(np.int64))
    assert np.array_equal(got_ok.numpy(), np.asarray(ok))
    ks = se.dp_exact_ring_plain(C, got_ok)
    assert np.array_equal(ks.numpy(), want_ks)
    # the wrapper on CPU tensors is the chained twin
    got = se.segment_exact_dp(torch.from_numpy(pm), torch.from_numpy(pt),
                              torch.from_numpy(locis.astype(np.int32)),
                              torch.from_numpy(tbl), Wb, 2000)
    assert np.array_equal(got.numpy(), want_ks)
    assert se.segment_exact_dp.launches == 0


def test_ties_from_zero_coverage_equal_jax_and_host():
    """A long empty stretch gives exactly equal candidates: the first
    maximum in ascending k must be JAX's and the host's."""
    rng = np.random.default_rng(78)
    data, loci = _rand_window(rng, 2, 300, 3)
    data[:, 50:150] = 0
    T = sed.segment_exact_device_T(data, loci, 40, 2000, 15.0, device="cpu")
    want = jsx.segment_exact_device_T(data, loci, 40, 2000, 15.0)
    assert np.array_equal(T, want)
    assert np.array_equal(T[1:], _host_T(data, loci, 40, 2000, 15.0)[1:])


@pytest.mark.parametrize("pc", [0.5, 1.0, 15.0])
def test_pseudocounts_equal_jax_and_host(pc):
    rng = np.random.default_rng(79)
    data, loci = _rand_window(rng, 2, 250, 8)
    T = sed.segment_exact_device_T(data, loci, 32, 2000, pc, device="cpu")
    assert np.array_equal(T, jsx.segment_exact_device_T(data, loci, 32, 2000,
                                                        pc))
    assert np.array_equal(T[1:], _host_T(data, loci, 32, 2000, pc)[1:])


def test_ineligible_windows_return_none_as_in_jax():
    """Cap exceeded, non-monotone loci and loci past 2^31: None in both."""
    rng = np.random.default_rng(80)
    data, loci = _rand_window(rng, 1, 100, 5)
    before = sed.segment_exact_device_batch.host_windows
    for args, kw in (((data, loci, 16, 2000, 15.0), dict(cap_limit=4)),
                     ((data, np.where(np.arange(100) == 50, loci[49] - 10,
                                      loci), 16, 2000, 15.0), {}),
                     ((data, loci + (1 << 31), 16, 2000, 15.0), {})):
        assert jsx.segment_exact_device_T(*args, **kw) is None
        assert sed.segment_exact_device_T(*args, device="cpu", **kw) is None
    assert sed.segment_exact_device_batch.host_windows == before + 3
    # a lone site, or none, is no window for the device
    assert sed.segment_exact_device_T(data[:, :1], loci[:1], 16, 2000, 15.0,
                                      device="cpu") is None


def test_batch_equals_jax_whatever_the_batch_size():
    """JAX's batched route (one ineligible window mixed in) == the port's,
    at batch sizes 1, 2 and one launch for all, and == the host DP."""
    rng = np.random.default_rng(82)
    wins = [_rand_window(rng, 2, 180, 7) for _ in range(5)]
    datas = np.stack([d for d, _ in wins])
    locis = np.stack([lo for _, lo in wins]).astype(np.int64)
    locis[3, 90] = locis[3, 89] - 5  # non-monotone -> the host's
    want = jsx.segment_exact_device_batch(datas, locis, 24, 2000, 15.0,
                                          batch=2)
    assert want[3] is None
    for batch in (1, 2, sed.BATCH):
        got = sed.segment_exact_device_batch(datas, locis, 24, 2000, 15.0,
                                             batch=batch, device="cpu")
        assert got[3] is None
        for w in (0, 1, 2, 4):
            assert np.array_equal(got[w], want[w]), (batch, w)
            assert np.array_equal(got[w][1:], _host_T(datas[w], locis[w], 24,
                                                      2000, 15.0)[1:])


def test_prefix_sums_wrap_as_jax():
    """Counts whose sums pass 2^31 and 2^32: the device prefix sums equal
    the host's int64-then-mask and JAX's int32 device cumsum."""
    rng = np.random.default_rng(3)
    data = rng.integers(0, 1 << 30, size=(2, 3, 40, 2)).astype(np.int32)
    data[..., 0] = np.minimum(data[..., 0], data[..., 1])
    pm, pt = sed._prefix_sums_wrapped(torch.from_numpy(data))
    for w in range(2):
        hpm, hpt = _wrapped(data[w])
        assert np.array_equal(pm[w].numpy(), hpm)
        assert np.array_equal(pt[w].numpy(), hpt)
        d32 = jnp.asarray(data[w])
        ps = np.asarray(jnp.concatenate(
            [jnp.zeros((3, 1, 2), jnp.int32), jnp.cumsum(d32, axis=1)],
            axis=1))
        assert np.array_equal(pt[w].numpy(), ps[..., 1])
    assert (pt.numpy() < 0).any()  # it did wrap


def test_shifted_prefix_sums_leave_ks_unchanged():
    """Prefix sums shifted by one constant so that they cross 2^31 in
    mid-window: the differences, and so ks, do not change."""
    rng = np.random.default_rng(4)
    data, loci = _rand_window(rng, 3, 300, 10)
    tbl, Wb = _sizes(data, loci, 64, 2000, 15.0)
    pm, pt = _wrapped(data)
    shift = (1 << 31) - int(pt[1, 150])
    spm, spt = ((((p.astype(np.int64) + shift + (1 << 31)) & 0xFFFFFFFF)
                 - (1 << 31)).astype(np.int32) for p in (pm, pt))
    # dataset 1's sums cross 2^31 at site 150: positive before, negative on
    assert (spt[1, :150] >= 0).any() and (spt[1, 150:] < 0).all()
    tl = torch.from_numpy(loci.astype(np.int32))[None]
    tt = torch.from_numpy(tbl)
    base = se.segment_exact_dp(torch.from_numpy(pm)[None],
                               torch.from_numpy(pt)[None], tl, tt, Wb, 2000)
    got = se.segment_exact_dp(torch.from_numpy(spm)[None],
                              torch.from_numpy(spt)[None], tl, tt, Wb, 2000)
    assert torch.equal(got, base)
    assert np.array_equal(base[0].numpy(),
                          _host_T(data, loci, 64, 2000, 15.0)[1:])


def test_wrapper_refuses_what_the_kernel_does_not_take():
    z = torch.zeros((1, 2, 11), dtype=torch.int32)
    loci = torch.arange(10, dtype=torch.int32)[None]
    tbl = torch.zeros(2080, dtype=torch.float32)
    for bad in (dict(max_bp=-1), dict(Wb=0)):
        kw = dict(Wb=8, max_bp=100) | bad
        with pytest.raises(ValueError):
            se.segment_exact_dp(z, z, loci, tbl, **kw)
    with pytest.raises(ValueError, match="int32"):
        se.segment_exact_dp(z.long(), z, loci, tbl, 8, 100)
    with pytest.raises(ValueError, match="loci"):
        se.segment_exact_dp(z, z, loci[:, :5], tbl, 8, 100)
    with pytest.raises(ValueError, match="cap above"):
        se.segment_exact_dp(z, z, loci, torch.empty(
            se.LL_CAP_MAX * (se.LL_CAP_MAX + 1) // 2 + 1, device="meta"), 8,
            100)
    assert se.segment_exact_dp.launches == 0


# ---------------------------------------------------------------------------
# the route: segment_borders, segment_chunks and the CLI
# ---------------------------------------------------------------------------


def _route_on_cpu(monkeypatch):
    """Stand-ins for the card: CUDA reads as available (and a synchronize
    does nothing), and the device route resolves the device it is given to
    the CPU, where it runs the kernel's twin. Returns the device types the
    route was asked for."""
    asked = []

    def to_cpu(device):
        asked.append(torch.device(device).type)
        return torch.device("cpu")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(sed, "resolve_device", to_cpu)
    return asked


def test_segment_borders_routes_long_windows_to_the_device(monkeypatch):
    """On a CUDA device a window of EXACT_DEVICE_MIN sites or more takes
    the device route, a shorter one the host; on the CPU every window takes
    the host DP. All give the host path's borders."""
    rng = np.random.default_rng(81)
    data, loci = _rand_window(rng, 2, pseg.EXACT_DEVICE_MIN + 40, 8)
    want = pseg.segment_borders(data, loci, 48, 2000, 15.0, "exact",
                                device="cpu")
    calls = _route_on_cpu(monkeypatch)
    assert np.array_equal(pseg.segment_borders(
        data, loci, 48, 2000, 15.0, "exact", device="cpu"), want)
    assert calls == []
    got = pseg.segment_borders(data, loci, 48, 2000, 15.0, "exact",
                               device="cuda")
    assert calls == ["cuda"]
    assert np.array_equal(got, want)
    short = pseg.segment_borders(data[:, :300], loci[:300], 48, 2000, 15.0,
                                 "exact", device="cuda")
    assert len(calls) == 1 and short[-1] == 300


def _betas_idx(tmp_path, n, meth_gt_cov=False):
    """Two betas of n sites and an index of their loci."""
    rng = np.random.default_rng(83)
    data, loci = _rand_window(rng, 2, n, 9)
    if meth_gt_cov:
        data[1, 700, 0] = data[1, 700, 1] + 3

    class _Idx:
        pass

    idx = _Idx()
    idx.loci = np.concatenate([loci, loci[-1:] + 100])
    paths = []
    for d in range(2):
        p = str(tmp_path / f"s{d}.beta")
        data[d].astype(np.uint8).tofile(p)
        paths.append(p)
    return paths, idx


def test_segment_ranges_on_the_device_equals_the_host(monkeypatch,
                                                     tmp_path):
    """segment_ranges on cuda takes the device route (the twin standing in
    for the card): chunks of 400 sites and a ragged last one, stitched on
    the host, give --device cpu's (the host DP's) blocks; no window goes to
    the host."""
    paths, idx = _betas_idx(tmp_path, 1230)
    cfg = pseg.SegmentConfig(max_cpg=32, max_bp=2000, chunk_size=400,
                             mode="exact", threads=1, device="cpu")
    want = pseg.segment_ranges(paths, [(1, 1231)], idx, cfg)
    calls = _route_on_cpu(monkeypatch)
    assert calls == []
    timings = {}
    cfg = pseg.SegmentConfig(max_cpg=32, max_bp=2000, chunk_size=400,
                             mode="exact", threads=1, timings=timings)
    assert cfg.device == torch.device("cuda")
    before = sed.segment_exact_device_batch.host_windows
    got = pseg.segment_ranges(paths, [(1, 1231)], idx, cfg)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert calls == ["cuda", "cuda"]  # the 400-site chunks, the ragged one
    assert sed.segment_exact_device_batch.host_windows == before
    assert {"beta_load", "plan", "h2d", "dp", "ks_fetch", "chunks",
            "stitch"} <= set(timings)


def test_device_route_raises_on_invalid_beta(monkeypatch, tmp_path):
    """The host path's invalid-beta guard holds on the device route."""
    paths, idx = _betas_idx(tmp_path, 1200, meth_gt_cov=True)
    calls = _route_on_cpu(monkeypatch)
    cfg = pseg.SegmentConfig(max_cpg=32, max_bp=2000, chunk_size=400,
                             mode="exact", threads=1)
    with pytest.raises(IllegalArgumentError, match="invalid beta data in "
                       + paths[1]):
        pseg.segment_chunks(paths, [(1, 401), (401, 801), (801, 1201)], idx,
                            cfg)
    assert calls == []  # raised before the route ran


def _cli(argv):
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    return port_main(["segment"] + argv)


@pytest.mark.parametrize("out,form", [("blocks.bed", []),
                                      ("blocks.bed.gz", ["-c", "400"])])
def test_cli_device_route_writes_the_host_bytes(tmp_path, genome_betas,
                                                monkeypatch, out, form):
    """The CLI's default device (cuda) takes the device route, here through
    the twin, and writes --device cpu's (the host DP's) bed, .gz and .tbi
    bytes, on the whole genome and chunked."""
    paths, _, _ = genome_betas
    argv = ["--betas"] + paths + form
    (tmp_path / "h").mkdir()
    (tmp_path / "d").mkdir()
    assert _cli(argv + ["--device", "cpu", "-o", str(tmp_path / "h" / out)]) \
        == 0
    calls = _route_on_cpu(monkeypatch)
    before = sed.segment_exact_device_batch.host_windows
    assert _cli(argv + ["-o", str(tmp_path / "d" / out)]) == 0
    assert calls and set(calls) == {"cuda"}
    assert sed.segment_exact_device_batch.host_windows == before
    files = [out] + ([out + ".tbi"] if out.endswith(".gz") else [])
    for name in files:
        want = (tmp_path / "h" / name).read_bytes()
        assert len(want) > 100
        assert (tmp_path / "d" / name).read_bytes() == want, name


def test_switch_asks_for_cuda(tmp_path, genome_betas, monkeypatch):
    """Exact mode on the default --device cuda raises without CUDA rather
    than running on the host; --device cpu runs the host DP, with no
    launch and no call of the device route."""
    paths, _, _ = genome_betas
    out = tmp_path / "x.bed"
    argv = ["--betas"] + paths + ["-s", "1-2000", "-o", str(out)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _cli(argv)
    assert not out.exists()

    def no_route(*a, **kw):
        raise AssertionError("the device route ran on --device cpu")

    monkeypatch.setattr(sed, "segment_exact_device_batch", no_route)
    monkeypatch.setattr(sed, "segment_exact_device_T", no_route)
    launches = se.segment_exact_dp.launches
    assert _cli(argv + ["--device", "cpu"]) == 0 and out.stat().st_size > 0
    assert se.segment_exact_dp.launches == launches


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_segment_exact_dp_equals_twin(cuda_device):
    """The kernel equals its twin bit for bit: K 1 / 3 / 8, W 32 / 48 /
    200 with a band, W 300 without one, ties from zero coverage; and the
    route's T equals the host's. (chip_smoke.py holds the ring in global
    memory, Wb above SMEM_RING, to the host DP.)"""
    rng = np.random.default_rng(5)
    for K, n, W, max_bp, zero in ((1, 700, 32, 2000, False),
                                  (3, 900, 48, 2000, True),
                                  (8, 500, 200, 1500, False),
                                  (2, 600, 300, 0, True)):
        datas = np.stack([_rand_window(rng, K, n, 12)[0] for _ in range(3)])
        locis = np.stack([_rand_window(rng, 1, n, 2)[1] for _ in range(3)])
        if zero:
            datas[:, :, 100:300] = 0
        elig, tbl, Wb = sed.plan_windows(datas, locis, W, max_bp, 15.0)
        assert elig == [0, 1, 2]
        counts, loci = sed._upload(datas, locis, cuda_device)
        pm, pt = sed._prefix_sums_wrapped(counts)
        tt = torch.from_numpy(tbl).to(cuda_device)
        want = se.segment_exact_dp_plain(pm, pt, loci, tt, Wb, max_bp)
        before = se.segment_exact_dp.launches
        got = se.segment_exact_dp(pm, pt, loci, tt, Wb, max_bp)
        torch.cuda.synchronize()
        assert se.segment_exact_dp.launches == before + 1
        assert torch.equal(got, want), (K, W, max_bp)
        T = sed.segment_exact_device_T(datas[0], locis[0], W, max_bp, 15.0,
                                       device=cuda_device)
        assert np.array_equal(T[1:], pnat.segment_exact_native(
            datas[0], locis[0], W, max_bp, 15.0)[1:])


AHEAD_WB_MAX = 1227  # the widest band the kernel's ahead body takes
MIN_CTAS = 4         # the ahead body's CTAs per SM (its __launch_bounds__)

# (name, K, n, Wb, max_bp, windows, cov_hi, zero stretch): the edges of
# both bodies; Wb is given to the kernel as it is, the table planned at W =
# Wb (so that it holds every in-band total)
CUDA_EDGES = [
    ("n below the lookahead", 2, 7, 32, 2000, 3, 12, False),
    ("n not a multiple of L or P", 3, 1001, 128, 2000, 3, 12, False),
    ("Wb 1", 2, 300, 1, 0, 3, 12, False),
    ("Wb 31", 3, 400, 31, 2000, 3, 12, False),
    ("Wb 33", 3, 400, 33, 0, 3, 12, False),
    ("Wb 128", 3, 2000, 128, 2000, 3, 12, False),
    ("Wb at the body threshold", 2, 2500, 1227, 0, 2, 2, False),
    ("Wb above the body threshold", 2, 2500, 1228, 0, 2, 2, False),
    ("K 1", 1, 800, 64, 2000, 3, 12, False),
    ("K 8", 8, 600, 96, 1500, 3, 12, False),
    ("ties from zero coverage", 2, 900, 128, 2000, 3, 3, True),
    ("B 1", 3, 700, 128, 2000, 1, 12, False),
    ("B above one wave", 2, 200, 64, 2000, 600, 12, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,K,n,Wb,max_bp,B,cov_hi,zero", CUDA_EDGES,
                         ids=[c[0] for c in CUDA_EDGES])
def test_cuda_segment_exact_dp_edges_equal_twin(cuda_device, name, K, n, Wb,
                                                max_bp, B, cov_hi, zero):
    """Each body's edges equal the twin bit for bit: n below the lookahead
    and not a multiple of it or of the cost warps, Wb 1 / 31 / 33 / 128 and
    on both sides of the body threshold, K 1 / 8, ties from zero coverage,
    one window and more windows than one wave holds. The C entry takes the
    ahead body up to AHEAD_WB_MAX, at MIN_CTAS CTAs per SM or more."""
    rng = np.random.default_rng(n + 7 * Wb + B)
    datas = np.stack([_rand_window(rng, K, n, cov_hi)[0] for _ in range(B)])
    locis = np.stack([_rand_window(rng, 1, n, 2)[1] for _ in range(B)])
    if zero:
        datas[:, :, 100:400] = 0
    elig, tbl, _ = sed.plan_windows(datas, locis, Wb, max_bp, 15.0)
    assert elig == list(range(B))
    counts, loci = sed._upload(datas, locis, cuda_device)
    pm, pt = sed._prefix_sums_wrapped(counts)
    tt = torch.from_numpy(tbl).to(cuda_device)
    want = se.segment_exact_dp_plain(pm, pt, loci, tt, Wb, max_bp)
    before = se.segment_exact_dp.launches
    got = se.segment_exact_dp(pm, pt, loci, tt, Wb, max_bp)
    torch.cuda.synchronize()
    assert se.segment_exact_dp.launches == before + 1
    assert torch.equal(got, want), name
    occ = se.dp_occupancy(Wb)
    assert occ["body"] == ("ahead" if Wb <= AHEAD_WB_MAX else "single")
    if occ["body"] == "ahead":
        assert occ["ctas_per_sm"] >= MIN_CTAS


@pytest.mark.cuda
def test_cuda_segment_exact_dp_runs_phase_8s_batch_in_one_wave(cuda_device):
    """At every Wb from 1 to 8,192 the launch the C entry makes puts 470
    windows (phase 8's batch) in one wave on the card's SMs: the ahead body
    up to AHEAD_WB_MAX, with 32 (1 + 3) threads, 4 to 8 cost slots and at
    most 48 KB of shared memory; the single body above, one warp, its ring
    in shared memory up to SMEM_RING values."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for Wb in range(1, 8193):
        occ = se.dp_occupancy(Wb)
        assert occ["ctas_per_sm"] * sms >= 470, (Wb, occ)
        if Wb <= AHEAD_WB_MAX:
            assert occ["body"] == "ahead" and occ["threads"] == 128, Wb
            assert 4 <= occ["lookahead"] <= 8, (Wb, occ)
            assert occ["smem"] <= 48 * 1024, (Wb, occ)
            assert occ["ctas_per_sm"] >= MIN_CTAS, (Wb, occ)
        else:
            assert occ["body"] == "single" and occ["threads"] == 32, Wb
            assert occ["lookahead"] == 0, Wb
            assert occ["smem"] == (8 * Wb if Wb <= se.SMEM_RING else 0), Wb
