"""The reduction key of exact segmentation's DP kernel
(csrc/segment_exact.cu), checked on the CPU in numpy: its order (the ahead
body's first minimum over the lanes is the first maximum of the sums), and
the table lookups and registers chip_smoke.py reports for the kernel."""

import numpy as np
import pytest

pytest.importorskip("torch")

ALL_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)


def _key(s):
    """The ahead body's key: the IEEE bits of a float64 sum as uint64."""
    return np.array(s, dtype=np.float64).view(np.uint64)


def _chain_first_max(s):
    """The chain warp's first maximum of the sums s (Wb,), as the kernel
    takes it: lane v % 32 keeps its first strict minimum key over its cells
    in ascending v (a lane without a cell keeps all ones), then the warp
    takes the least high half, the least low half among the lanes with that
    high half, and the least v among the lanes with that key."""
    keys = _key(s)
    bkey = np.full(32, ALL_ONES, dtype=np.uint64)
    bv = np.full(32, 0xFFFFFFFF, dtype=np.uint64)
    for v, k in enumerate(keys):
        if k < bkey[v % 32]:
            bkey[v % 32], bv[v % 32] = k, v
    hi, lo = bkey >> np.uint64(32), bkey & np.uint64(0xFFFFFFFF)
    mh = hi.min()
    ml = np.where(hi == mh, lo, np.uint64(0xFFFFFFFF)).min()
    return int(np.where((hi == mh) & (lo == ml), bv,
                        np.uint64(0xFFFFFFFF)).min())


def _sums(rng, Wb, kind):
    """Sums of a step: finite doubles <= 0, never -0.0 (+0.0 is 0.0 - 0.0),
    with ties, +0.0 and neighbours that differ in the low 32 bits only; the
    masked cells (M + -inf) are -inf, and the last cell (k = i) is ok."""
    if kind == "ties":
        x = rng.integers(0, 4, Wb) * 0.5
    elif kind == "low bits":
        x = np.nextafter(1.25, 2.0) + rng.integers(0, 5, Wb) \
            * np.spacing(1.25)
    else:
        x = rng.exponential(30.0, Wb)
        x[rng.random(Wb) < 0.2] = 0.0
    s = np.float64(0.0) - x
    ok = rng.random(Wb) < 0.7
    ok[-1] = True
    return np.where(ok, s, -np.inf), ok


@pytest.mark.parametrize("Wb", [1, 2, 31, 32, 33, 64, 128, 1000, 1227])
@pytest.mark.parametrize("kind", ["ties", "low bits", "spread"])
def test_chain_key_first_min_is_the_first_max(Wb, kind):
    """On every step's sums the chain's key reduction gives np.argmax's
    first maximum of the ok cells."""
    rng = np.random.default_rng(Wb * 31 + len(kind))
    for _ in range(200):
        s, ok = _sums(rng, Wb, kind)
        assert not np.signbit(s[s == 0]).any()
        assert _chain_first_max(s) == int(np.argmax(s))
        keys = _key(s)
        keys[~ok] = ALL_ONES  # masked cells keyed all ones: the same minimum
        assert int(np.argmin(keys)) == int(np.argmax(s))


def test_key_orders_as_the_doubles():
    """For finite doubles <= 0 that are not -0.0, a > b exactly where
    key(a) < key(b), and a == b where the keys are equal; -inf's key lies
    above every finite one."""
    rng = np.random.default_rng(12)
    x = np.float64(0.0) - np.concatenate([
        rng.exponential(10.0, 5000), np.zeros(50),
        rng.integers(0, 3, 500) * 0.25,
        np.nextafter(3.0, 4.0) + rng.integers(0, 3, 500) * np.spacing(3.0)])
    assert not np.signbit(x[x == 0]).any()
    a, b = x[:, None], x[None, ::3]
    ka, kb = _key(x)[:, None], _key(x)[None, ::3]
    assert np.array_equal(a > b, ka < kb)
    assert np.array_equal(a == b, ka == kb)
    assert (_key(np.array([-np.inf])) > _key(x)).all()


@pytest.mark.parametrize("W,max_bp", [(64, 800), (40, 0)])
def test_smoke_counts_the_table_lookups(W, max_bp):
    """chip_smoke._table_lookups (the reads the PERF rate divides) counts
    the ok band cells with a total above 0, per dataset, as a loop over the
    cells in numpy does."""
    import chip_smoke
    from wgbs_tools_tpu_torch.models import segment_exact_device as sed

    rng = np.random.default_rng(W + max_bp)
    B, K, n = 3, 2, 400
    cov = rng.poisson(0.7, size=(B, K, n))
    datas = np.stack([rng.binomial(cov, 0.5), cov], axis=3)
    locis = np.cumsum(rng.integers(5, 60, size=(B, n)), axis=1) + 100
    _, _, Wb = sed.plan_windows(datas, locis, W, max_bp, 15.0)
    counts, loci = sed._upload(datas, locis, "cpu")
    _, pt = sed._prefix_sums_wrapped(counts)
    i = np.arange(n)[:, None]
    k = i - Wb + 1 + np.arange(Wb)[None, :]
    kc = np.maximum(k, 0)
    want = 0
    for b in range(B):
        ok = k >= 0
        if max_bp:
            ok &= locis[b][i] - locis[b][kc] <= max_bp
        for d in range(K):
            p = np.concatenate([[0], np.cumsum(cov[b, d])])
            want += int((ok & (p[i + 1] - p[kc] > 0)).sum())
    assert chip_smoke._table_lookups(pt, loci, Wb, max_bp, per=2) == want


def test_smoke_reads_registers_per_body(tmp_path):
    """ptxas's log read per body (chip_smoke.SEGX_BODIES), and under the
    kernel's one name (the most either body uses)."""
    import chip_smoke

    log = tmp_path / "nvcc.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_123"
        "segment_exact_dp_kernelILi4EEEvPKi' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 63 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_129"
        "segment_exact_dp_ahead_kernelILi4EEEvPKi' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 120 registers, used 1 barriers\n")
    assert chip_smoke._ptxas_registers(str(log), chip_smoke.SEGX_BODIES) \
        == ({"single": 63, "ahead": 120}, {"single": 0, "ahead": 12})
    assert chip_smoke._ptxas_registers(str(log)) \
        == ({"segment_exact_dp": 120}, {"segment_exact_dp": 12})
