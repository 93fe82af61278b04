"""The port's segment equals the JAX package's: the exact host DP, the fast
path's cost tensor, blocked and scan DPs, max-plus closure, border mask
and bit packing, and the CLI's blocks bed / .gz / .tbi bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_oracle_lib import oracle_lib  # noqa: E402
from wgbs_tools_tpu import native as jnat  # noqa: E402
from wgbs_tools_tpu.formats.beta import save_beta  # noqa: E402
from wgbs_tools_tpu.models import segment as jseg  # noqa: E402
from wgbs_tools_tpu_torch import native as pnat  # noqa: E402
from wgbs_tools_tpu_torch.models import segment as pseg  # noqa: E402
from wgbs_tools_tpu_torch.ops import maxplus  # noqa: E402

import chip_smoke  # noqa: E402

pytestmark = pytest.mark.skipif(oracle_lib() is None,
                                reason="the JAX package's native library "
                                       "(the reference) is unavailable")

N = 3000


def make_blocky_beta(rng, n, n_blocks=40, max_cov=30):
    """Beta data with genuine methylation change-points (as
    tests/test_segment.py makes them)."""
    borders = np.sort(rng.choice(np.arange(1, n), size=n_blocks,
                                 replace=False))
    levels = rng.random(n_blocks + 1)
    per_site_p = np.repeat(levels, np.diff(np.concatenate([[0], borders,
                                                           [n]])))
    cov = rng.integers(1, max_cov, size=n).astype(np.int64)
    meth = rng.binomial(cov, per_site_p).astype(np.int64)
    return np.stack([meth, cov], axis=1)


@pytest.fixture(scope="module")
def betas():
    """Three 3,000-site blocky betas and strictly increasing loci (the JAX
    tests' beta_fixture, from the same seed)."""
    rng = np.random.default_rng(42)
    datas = np.stack([make_blocky_beta(rng, N) for _ in range(3)])
    loci = np.cumsum(rng.integers(2, 120, size=N)) + 100
    return datas, loci


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32))


# ---------------------------------------------------------------------------
# exact mode: the host DP
# ---------------------------------------------------------------------------

# the parameter rows of test_segment.py::test_exact_matches_reference
EXACT_ROWS = [(1, 1000, 10**9, 15.0), (3, 1000, 10**9, 15.0),
              (3, 50, 10**9, 1.0), (3, 1000, 2000, 15.0),
              (2, 200, 500, 0.01)]


@pytest.mark.parametrize("K,max_cpg,max_bp,ps", EXACT_ROWS)
def test_exact_native_equals_jax(betas, K, max_cpg, max_bp, ps):
    datas, loci = betas
    W = min(max_cpg, N)
    want = jnat.segment_exact_native(datas[:K], loci, W, max_bp, ps)
    got = pnat.segment_exact_native(datas[:K], loci, W, max_bp, ps)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    b = pseg.segment_borders(datas[:K], loci, max_cpg, max_bp, ps, "exact",
                             device="cpu")
    assert b.tolist() == jseg.segment_borders(datas[:K], loci, max_cpg,
                                              max_bp, ps, "exact").tolist()
    assert b[0] == 0 and b[-1] == N and len(b) > 10


def test_exact_native_nonmonotone_equals_jax(betas):
    """Loci that restart mid-window (a chromosome boundary) and a
    descending dip take the native code's literal branch."""
    datas, loci = betas
    n = 800
    for case in ("restart", "dip"):
        lc = loci[:n].copy()
        if case == "restart":
            lc[500:] = lc[500:] - lc[500] + 150
        else:
            lc[300:340] = lc[300] - np.arange(40)
        want = jnat.segment_exact_native(datas[:2, :n], lc, 200, 1500, 15.0)
        got = pnat.segment_exact_native(datas[:2, :n], lc, 200, 1500, 15.0)
        assert np.array_equal(got, want), case


def test_exact_native_meth_gt_cov_equals_jax():
    rng = np.random.default_rng(5)
    n, K = 800, 3
    data = rng.integers(0, 6, size=(K, n, 2)).astype(np.int64)
    data[:, :, 1] = data[:, :, 0] + rng.integers(0, 5, size=(K, n))
    data[1, 37, 0] = data[1, 37, 1] + 7  # meth > cov at one site
    loci = np.cumsum(rng.integers(2, 50, size=n)).astype(np.int64)
    want = jnat.segment_exact_native(data, loci, 100, 2000, 15.0)
    got = pnat.segment_exact_native(data, loci, 100, 2000, 15.0)
    assert np.array_equal(got, want)
    res = pseg.segment_borders(data, loci, 100, 2000, 15.0, "exact",
                               device="cpu")
    assert res[0] == 0 and res[-1] == n and np.all(np.diff(res) > 0)


def test_exact_raises_without_host_library(betas, monkeypatch):
    """No fallback: exact mode raises when the host library cannot load."""
    datas, loci = betas

    def no_lib():
        raise RuntimeError("the host library could not be built or loaded")

    monkeypatch.setattr(pnat, "get_lib", no_lib)
    with pytest.raises(RuntimeError, match="host library"):
        pseg.segment_borders(datas[:1, :100], loci[:100], 50, 2000, 15.0,
                             "exact", device="cpu")


# ---------------------------------------------------------------------------
# fast mode: cost, DPs, closure, mask
# ---------------------------------------------------------------------------

COST_ROWS = [(3, 300, 2000, 15.0), (1, 1000, 0, 0.01), (2, 50, 10**9, 1.0),
             (3, 1000, 2000, 15.0)]


def _jax_cost(datas, loci, W, max_bp, pc):
    pm, pt = jseg._prefix_sums(datas)
    return np.asarray(jseg._cost_fast_jax(
        jnp.asarray(pm, jnp.int32), jnp.asarray(pt, jnp.int32),
        jnp.asarray(loci, jnp.int32), W, max_bp, pc))


@pytest.mark.parametrize("K,W,max_bp,pc", COST_ROWS)
def test_cost_fast_equals_jax(betas, K, W, max_bp, pc):
    """-inf at the same entries; the finite ones within rtol 1e-6 (log2 may
    differ by an ulp between XLA and PyTorch; the rest is the same f32
    arithmetic)."""
    datas, loci = betas
    want = _jax_cost(datas[:K], loci, W, max_bp, pc)
    pm, pt = pseg._prefix_sums(datas[:K])
    got = pseg._cost_fast(_t(pm), _t(pt), _t(loci), W, max_bp, pc).numpy()
    assert got.shape == want.shape == (N, W) and got.dtype == np.float32
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    assert np.isfinite(want[~np.isneginf(want)]).all()
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=0)
    # the batched form: two windows at once equal each one alone
    two = pseg._cost_fast(_t(np.stack([pm, pm[:, ::-1].copy()])),
                          _t(np.stack([pt, pt[:, ::-1].copy()])),
                          _t(np.stack([loci, loci])), W, max_bp, pc)
    assert torch.equal(two[0], torch.from_numpy(got))


def _random_cost(n, W):
    """test_segment.py::test_blocked_dp_matches_scan_dp's cost rows."""
    rng = np.random.default_rng(n * 1000 + W)
    C = rng.normal(size=(n, W)).astype(np.float32)
    valid = (np.arange(n)[:, None] - (W - 1) + np.arange(W)[None, :]) >= 0
    return np.where(valid, C, -np.inf).astype(np.float32)


# W < B, W = B + 1 and W > B, as in test_blocked_dp_matches_scan_dp
@pytest.mark.parametrize("n,W", [(37, 3), (200, 64), (513, 129), (1000, 300)])
def test_dp_fast_equals_jax_random(n, W):
    C = _random_cost(n, W)
    want_b = np.asarray(jseg._dp_fast_blocked(jnp.asarray(C), W))
    want_s = np.asarray(jseg._dp_fast_jax(jnp.asarray(C), W))
    got_b = pseg._dp_fast_blocked(torch.from_numpy(C), W)
    got_s = pseg._dp_fast_scan(torch.from_numpy(C), W)
    assert want_b.tolist() == want_s.tolist()  # no near-ties in these costs
    assert got_b.dtype == got_s.dtype == torch.int32
    assert got_b.numpy().tolist() == want_b.tolist()
    assert got_s.numpy().tolist() == want_s.tolist()


@pytest.mark.parametrize("n,W,max_bp", [(3000, 300, 2000), (3000, 1000, 2000),
                                        (600, 600, 0), (400, 100, 1500)])
def test_dp_fast_equals_jax_on_beta_windows(betas, n, W, max_bp):
    """Fed JAX's cost tensor of a real window, each DP gives its JAX
    counterpart's T bit for bit (the blocked one also batched with a second
    window). The two DPs sum the same path costs in other orders, so at
    near-ties their T may differ from each other: each is held to its own."""
    datas, loci = betas
    C = _jax_cost(datas[:, :n], loci[:n], W, max_bp, 15.0)
    want_b = np.asarray(jseg._dp_fast_blocked(jnp.asarray(C), W)).tolist()
    want_s = np.asarray(jseg._dp_fast_jax(jnp.asarray(C), W)).tolist()
    Ct = torch.from_numpy(C.copy())
    assert pseg._dp_fast_blocked(Ct, W).numpy().tolist() == want_b
    assert pseg._dp_fast_scan(Ct, W).numpy().tolist() == want_s
    both = pseg._dp_fast_blocked(torch.stack([Ct.flip(0), Ct]), W)
    assert both[1].numpy().tolist() == want_b


def _jax_closure_from_rows(rows, W, B=128):
    """The JAX package's `closure` (segment.py:313-329) on one block's
    (B, W) cost rows, line for line: the staircase skew, I (+) A, then
    log_steps max-plus squarings. Returns (S0, S*)."""
    NEG = jnp.float32(-jnp.inf)
    P = jnp.arange(B + 1)[:, None]
    Q = jnp.arange(B + 1)[None, :]
    a_valid = (Q > P) & (P >= 1) & (Q - P <= W)
    F = jnp.concatenate([rows, jnp.full((B, B + 1), NEG)], axis=1)
    S2 = F.reshape(-1)[: B * (W + B)].reshape(B, W + B)
    Bmat = S2[:, W - 1 : W + B]
    A = jnp.concatenate([jnp.full((B + 1, 1), NEG), Bmat.T], axis=1)
    A = jnp.where(a_valid, A, NEG)
    S0 = jnp.where(P == Q, 0.0, A)

    def sq(S, _):
        return jnp.max(S[:, :, None] + S[None, :, :], axis=1), None

    log_steps = max(int(np.ceil(np.log2(max(B, 2)))), 1)
    S, _ = jax.lax.scan(sq, S0, None, length=log_steps)
    return np.asarray(S0), np.asarray(S)


@pytest.mark.parametrize("n,W", [(300, 40), (400, 129), (700, 300),
                                 (3000, 1000)])
def test_closure_equals_jax(betas, n, W):
    """The port's edge matrices equal JAX's staircase skew, and
    maxplus_closure_plain (and the wrapper, which takes it for CPU
    tensors) equals JAX's closure bit for bit, for W < B, W = B + 1 and
    W > B, with a ragged last block."""
    datas, loci = betas
    C = _jax_cost(datas[:, :n], loci[:n], W, 2000, 15.0)
    blocks, S0 = pseg._closure_inputs(torch.from_numpy(C.copy())[None], W)
    nb = blocks.shape[1]
    assert S0.shape == (nb, 129, 129) and S0.is_contiguous()
    S_plain = maxplus.maxplus_closure_plain(S0, 7)
    launches = maxplus.maxplus_closure.launches
    assert torch.equal(maxplus.maxplus_closure(S0, 7), S_plain)
    assert maxplus.maxplus_closure.launches == launches  # the twin ran
    Cp = np.full((nb * 128, W), -np.inf, np.float32)
    Cp[:n] = C
    for b in range(nb):
        want_s0, want = _jax_closure_from_rows(
            jnp.asarray(Cp[b * 128:(b + 1) * 128]), W)
        assert np.array_equal(S0[b].numpy(), want_s0), b
        assert np.array_equal(S_plain[b].numpy(), want), b


@pytest.mark.parametrize("n,W", [(300, 40), (400, 129), (700, 300),
                                 (3000, 1000)])
def test_closure_inputs_are_upper_triangular(betas, n, W):
    """The premise of the kernel's upper schedule: on JAX's cost of a real
    window (W < B, W = B + 1 and W > B, a ragged last block) the DP's S0 is
    -inf strictly below the diagonal, and every squaring keeps it so."""
    datas, loci = betas
    C = _jax_cost(datas[:, :n], loci[:n], W, 2000, 15.0)
    S = pseg._closure_inputs(torch.from_numpy(C.copy())[None], W)[1]
    below = torch.ones(129, 129, dtype=torch.bool).tril(-1)
    assert torch.isfinite(S[:, ~below]).any()
    for _ in range(8):
        assert torch.isneginf(S[:, below]).all()
        S = maxplus.maxplus_closure_plain(S, 1)


def _schedule_tiles(n):
    """upper_schedule(n) as arrays (a, c, r_lo, r_end), -1 / 0 where idle."""
    tp = tq = maxplus.TILE
    t = maxplus.upper_schedule(n).astype(np.int64)
    a = np.where(t >= 0, t >> 16, -1)
    c = np.where(t >= 0, t & 0xFFFF, -1)
    r_lo = np.where(t >= 0, tp * a, 0)
    r_end = np.where(t >= 0, np.minimum(tq * c + tq, n), 0)
    return a, c, r_lo, r_end


def test_upper_schedule_covers_the_triangle():
    """For every n the kernel takes, the upper schedule's tiles cover each
    (p, q) with p <= q < n exactly once, each output's r range [p, q] lies
    in its tile's, and no tile lies wholly below the diagonal. The triples
    the kernel's loops evaluate (upper_pairs) are the triangle's, each
    output's r in [p, q], plus the padding columns' r in [p, n) for q from
    n to the side padded to a multiple of 4."""
    tp = tq = maxplus.TILE
    assert maxplus.upper_schedule(129).shape == (maxplus.SLOTS,
                                                 maxplus.THREADS)
    for n in range(1, maxplus.NMAX + 1):
        a, c, r_lo, r_end = _schedule_tiles(n)
        on = a >= 0
        # inside the side, and some output on or above the diagonal
        assert (tp * a[on] < n).all() and (tq * c[on] < n).all(), n
        assert (tq * c[on] + tq - 1 >= tp * a[on]).all(), n
        cover = np.zeros((n, n), np.int64)
        for ai, ci in zip(a[on], c[on]):
            cover[tp * ai:tp * ai + tp, tq * ci:tq * ci + tq] += 1
        assert np.array_equal(np.triu(cover), np.triu(np.ones((n, n)))), n
        # p_lo is the tile's first output row, q_hi its last column
        assert (r_lo[on] == tp * a[on]).all(), n
        assert (r_end[on] == np.minimum(tq * c[on] + tq, n)).all(), n
        pad = -(-n // tq) * tq - n
        assert maxplus.upper_pairs(n) == ((n + 2) * (n + 1) * n // 6
                                          + pad * n * (n + 1) // 2), n


@pytest.mark.parametrize("n", [96, 112, 128, 129, 144])
def test_upper_schedule_balance(n):
    """The work is balanced where it matters, at the DP's n = 129 and
    around it: each warp's lanes loop together, so a slot costs its
    longest tile, and the warps w and w + 4 share one of the SM's 4
    schedulers. Each scheduler's sum of slot costs is within 1.2x of the
    ideal (all r steps over 128 lanes); the largest thread's r count is at
    most the larger of its longest tile and 1.2x the mean; the scanned
    pairs are within 1.3x of the triangle's (n + 2)(n + 1)n / 6."""
    a, c, r_lo, r_end = _schedule_tiles(n)
    steps = r_end - r_lo                                # (SLOTS, THREADS)
    per_sched = steps.reshape(maxplus.SLOTS, 2, 4, 32).max(-1).sum((0, 1))
    assert per_sched.max() <= 1.2 * steps.sum() / 128, per_sched
    per_thread = steps.sum(0)
    assert per_thread.max() <= max(steps.max(), 1.2 * per_thread.mean())
    assert maxplus.upper_pairs(n) <= 1.3 * (n + 2) * (n + 1) * n // 6


def _maxplus_numpy(S, steps):
    for _ in range(steps):
        S = np.max(S[:, :, :, None] + S[:, None, :, :], axis=2)
    return S


@pytest.mark.parametrize("name", chip_smoke.MAXPLUS_EDGE)
def test_maxplus_edge_twin_equals_numpy(name):
    """chip_smoke.py's edge cases of maxplus_closure: the upper ones are
    -inf below the diagonal (the mixed launch has one finite entry there,
    in one matrix), and the twin (the wrapper on the CPU) equals a numpy
    max-plus power bit for bit."""
    S, steps = chip_smoke.maxplus_edge_batch(name)
    n = S.shape[1]
    below = np.tril(np.isfinite(S), -1).sum((1, 2))
    assert below.tolist() == ([0, 0, 1] + [0] * 6 if name == "mixed"
                              else [0] * S.shape[0])
    assert np.isfinite(S).any() and not np.isnan(S).any()
    got = maxplus.maxplus_closure(torch.from_numpy(S), steps).numpy()
    assert got.shape == (S.shape[0], n, n)
    assert np.array_equal(got, _maxplus_numpy(S, steps))


def test_closure_plain_refuses_nan_and_inf():
    S = torch.zeros((2, 5, 5))
    S[1, 2, 3] = float("inf")
    with pytest.raises(ValueError, match="NaN or \\+inf"):
        maxplus.maxplus_closure_plain(S, 1)
    with pytest.raises(ValueError, match="contiguous"):
        maxplus.maxplus_closure(torch.zeros((2, 5, 4)), 1)
    with pytest.raises(ValueError, match="must be in"):
        maxplus.maxplus_closure(torch.zeros((1, 145, 145)), 1)


def test_argmax_takes_the_first_maximum():
    """The DP's tie-break rests on torch.argmax returning the first of
    equal maxima (JAX's jnp.argmax does); a cost of ties gives JAX's T."""
    x = torch.tensor([1.0, 3.0, 3.0, float("-inf"), 3.0])
    assert int(torch.argmax(x)) == 1
    assert torch.argmax(torch.stack([x, x.flip(0)]), dim=-1).tolist() == [1, 0]
    n, W = 600, 70
    C = np.where((np.arange(n)[:, None] - (W - 1) + np.arange(W)[None, :])
                 >= 0, -1.0, -np.inf).astype(np.float32)
    want = np.asarray(jseg._dp_fast_jax(jnp.asarray(C), W)).tolist()
    assert want == np.asarray(jseg._dp_fast_blocked(jnp.asarray(C),
                                                    W)).tolist()
    assert pseg._dp_fast_scan(torch.from_numpy(C), W).numpy().tolist() == want
    assert pseg._dp_fast_blocked(torch.from_numpy(C),
                                 W).numpy().tolist() == want


def test_borders_mask_equals_traceback():
    """Pointer-doubling chain marking == the host traceback, on the JAX
    test's adversarial T arrays, one at a time and batched."""
    rng = np.random.default_rng(1729)
    for n in (1, 2, 5, 64, 1000):
        Ts = []
        for trial in range(4):
            T = np.empty(n + 1, np.int32)
            T[0] = 0
            for i in range(1, n + 1):
                if trial == 0:
                    T[i] = i - 1          # worst case: chain of length n
                elif trial == 1:
                    T[i] = 0              # single block
                elif trial == 2:
                    T[i] = rng.integers(-1, i)  # random incl. -1 sentinel
                else:
                    T[i] = max(0, i - int(rng.integers(1, 8)))
            want = pseg._traceback(T, n)
            assert want.tolist() == jseg._traceback(T, n).tolist()
            mask = pseg._borders_mask(torch.from_numpy(T))
            assert mask.dtype == torch.uint8
            assert np.flatnonzero(mask.numpy()).tolist() == want.tolist()
            assert np.array_equal(mask.numpy(), np.asarray(
                jseg._borders_mask(jnp.asarray(T))))
            Ts.append(T)
        batched = pseg._borders_mask(torch.from_numpy(np.stack(Ts)))
        for T, row in zip(Ts, batched.numpy()):
            assert np.flatnonzero(row).tolist() == \
                pseg._traceback(T, n).tolist()


def test_pack_mask_bits_roundtrip():
    rng = np.random.default_rng(41)
    for m in (1, 7, 8, 9, 60001, 256):
        masks = (rng.random((3, m)) < 0.3).astype(np.uint8)
        masks[0] = 1
        masks[1] = 0
        packed = pseg.pack_mask_bits(torch.from_numpy(masks)).numpy()
        assert np.array_equal(packed, np.packbits(masks, axis=1)), m
        assert np.array_equal(packed, np.asarray(
            jseg.pack_mask_bits(jnp.asarray(masks))))
        assert np.array_equal(pseg.unpack_mask_bits(packed, m), masks)


def test_segment_windows_fast_equals_jax(betas):
    """Batched windows (a batch of 2 with a padded tail) give the JAX
    package's borders on the same windows."""
    datas, loci = betas
    n = 1000
    windows = [(0, n), (n, 2 * n), (2 * n, 3 * n)]
    d = np.stack([datas[:, s:e] for s, e in windows])
    lc = np.stack([loci[s:e] for s, e in windows])
    want = jseg.segment_windows_fast(d, lc, 200, 2000, 15.0)
    got = pseg.segment_windows_fast(d, lc, 200, 2000, 15.0, batch=2,
                                    device="cpu")
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    single = pseg.segment_borders(d[1], lc[1], 200, 2000, 15.0, "fast",
                                  device="cpu")
    assert got[1].tolist() == single.tolist()


def test_fast_close_to_exact(betas):
    """The JAX gate of test_fast_mode_close_to_exact, on the port."""
    datas, loci = betas
    exact = pseg.segment_borders(datas, loci, 300, 2000, 15.0, "exact",
                                 device="cpu")
    fast = pseg.segment_borders(datas, loci, 300, 2000, 15.0, "fast",
                                device="cpu")
    assert len(np.intersect1d(exact, fast)) >= 0.95 * len(exact)


# ---------------------------------------------------------------------------
# the CLI against the JAX CLI
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def genome_betas(mini_genome, tmp_path_factory):
    """Three blocky betas over the mini genome's sites, written by the JAX
    package, and a blocks bed of three ranges (one NA row)."""
    n = mini_genome.get_nr_sites()
    d = tmp_path_factory.mktemp("seg_betas")
    rng = np.random.default_rng(7)
    paths = []
    for k in range(3):
        p = str(d / f"s{k}.beta")
        save_beta(p, make_blocky_beta(rng, n, n_blocks=60))
        paths.append(p)
    bed = str(d / "ranges.bed")
    with open(bed, "w") as f:
        f.write("chr\tstart\tend\tstartCpG\tendCpG\n")
        f.write(f"chr1\t1\t2\t5\t{n // 3}\n")
        f.write("chr1\t3\t4\tNA\tNA\n")
        f.write(f"chr1\t5\t6\t{n // 3 + 10}\t{n // 2}\n")
    return paths, bed, n


def _run_both(tmp_path, argv, name, port_extra=()):
    """The JAX CLI and the port's CLI on argv with `-o <dir>/<name>`;
    returns the two output directories."""
    from wgbs_tools_tpu.cli.main import main as jax_main
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    outs = []
    for who, main, extra in (("j", jax_main, ()), ("t", port_main,
                                                   port_extra)):
        d = tmp_path / who
        d.mkdir(exist_ok=True)
        assert main(["segment"] + argv + ["-o", str(d / name)]
                    + list(extra)) == 0
        outs.append(d)
    return outs


FORMS = {"whole": [], "region": ["-r", "chr1:2,000-40,000"],
         "sites": ["-s", "100-1500"], "bed": None,
         "min_cpg": ["--min_cpg", "3"], "chunked": ["-c", "400"]}


@pytest.mark.parametrize("out", ["blocks.bed", "blocks.bed.gz"])
@pytest.mark.parametrize("form", sorted(FORMS))
def test_cli_exact_bytes_equal_jax(tmp_path, genome_betas, form, out):
    paths, bed, _ = genome_betas
    argv = ["--betas"] + paths + (["-L", bed] if form == "bed"
                                  else FORMS[form])
    j, t = _run_both(tmp_path, argv, out, ("--device", "cpu"))
    files = [out] + ([out + ".tbi"] if out.endswith(".gz") else [])
    for name in files:
        want = (j / name).read_bytes()
        assert len(want) > 100
        assert (t / name).read_bytes() == want, name
    if out.endswith(".gz"):
        assert not (t / "blocks.bed").exists()


def test_cli_exact_threads_equal_jax(tmp_path, genome_betas):
    """--threads 1 and 4 (the thread pool over chunks) write the same
    bytes as the JAX CLI, over a chunked genome that stitches."""
    paths, _, _ = genome_betas
    argv = ["--betas"] + paths + ["-c", "300", "--threads", "1"]
    j, t = _run_both(tmp_path, argv, "b1.bed", ("--device", "cpu"))
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    assert port_main(["segment", "--betas"] + paths
                     + ["-c", "300", "--threads", "4", "--device", "cpu",
                        "-o", str(t / "b4.bed")]) == 0
    want = (j / "b1.bed").read_bytes()
    assert (t / "b1.bed").read_bytes() == want
    assert (t / "b4.bed").read_bytes() == want


def _borders(path):
    cols = np.loadtxt(path, dtype=np.int64, usecols=(3, 4), ndmin=2)
    return set(cols.ravel().tolist())


@pytest.mark.parametrize("form", ["whole", "chunked"])
def test_cli_fast_close_to_jax(tmp_path, genome_betas, form):
    """Fast mode through the port's CLI on the CPU finds >= 99 % of the
    JAX fast CLI's borders (the cost's log2 may flip near-ties)."""
    paths, _, _ = genome_betas
    argv = ["--betas"] + paths + ["--mode", "fast"] + FORMS[form]
    j, t = _run_both(tmp_path, argv, "fast.bed", ("--device", "cpu"))
    want, got = _borders(j / "fast.bed"), _borders(t / "fast.bed")
    share = len(want & got) / len(want)
    print(f"fast CLI ({form}): the port finds {share:.4%} of the JAX CLI's "
          f"{len(want)} borders ({len(got)} borders)")
    assert share >= 0.99


def test_cli_refuses_procs_and_asks_for_cuda(tmp_path, genome_betas,
                                             monkeypatch):
    from wgbs_tools_tpu_torch.cli import cmd_segment
    from wgbs_tools_tpu_torch.cli.main import main as port_main

    paths, _, _ = genome_betas
    argv = ["--betas"] + paths + ["-o", str(tmp_path / "x.bed")]
    # max_bp 2 leaves max_cpg = min(1000, 2 // 2) = 1: refused, not asserted
    assert port_main(["segment"] + argv + ["--max_bp", "2"]) == 1
    # --array_id is not ported: refused, not read as the whole genome
    with pytest.raises(SystemExit):
        port_main(["segment"] + argv + ["--array_id", "cg00001755"])
    assert not (tmp_path / "x.bed").exists()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("fast", "exact"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(["segment"] + argv + ["--mode", mode])
    # --procs 2 asks for CUDA too, before any worker starts
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cmd_segment.main(argv + ["--procs", "2"])
    assert not (tmp_path / "x.bed").exists()
    # --device cpu: exact mode's host DP needs no card
    assert port_main(["segment"] + argv + ["--procs", "1", "--device",
                                           "cpu"]) == 0
    assert (tmp_path / "x.bed").stat().st_size > 0


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_maxplus_closure_equals_twin(cuda_device, betas):
    """The kernel equals its twin bit for bit on real edge matrices (W <
    B and W > B, a ragged last block), an all -inf block and a small dense
    n (the general schedule), and on chip_smoke.py's maxplus edges."""
    datas, loci = betas
    cases = []
    for n, W in ((700, 300), (400, 100)):
        C = _jax_cost(datas[:, :n], loci[:n], W, 2000, 15.0)
        cases.append(pseg._closure_inputs(torch.from_numpy(C.copy())[None],
                                          W)[1])
    edge = torch.full((2, 129, 129), float("-inf"))
    edge[:, torch.arange(129), torch.arange(129)] = 0.0
    cases += [edge, torch.randn((5, 17, 17)).clamp_max(2.0)]
    cases = [(S0, 7) for S0 in cases]
    # chip_smoke.py's edges: banded upper matrices with holes at every n in
    # MAXPLUS_UPPER_N, a launch that mixes both schedules, 0 / 1 squarings
    cases += [(torch.from_numpy(S), k) for S, k in map(
        chip_smoke.maxplus_edge_batch, chip_smoke.MAXPLUS_EDGE)]
    for S0, steps in cases:
        S0 = S0.to(cuda_device)
        before = maxplus.maxplus_closure.launches
        got = maxplus.maxplus_closure(S0, steps)
        torch.cuda.synchronize()
        assert maxplus.maxplus_closure.launches == before + 1
        assert torch.equal(got, maxplus.maxplus_closure_plain(S0, steps))
