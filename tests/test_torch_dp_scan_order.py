"""The order of work of dp_scan's push body (csrc/dp_scan.cu), modelled in
numpy step by step and held to JAX's parallel/sharded.py::_dp_scan.

The model does what the body does, index for index: the candidates that
read M's initial -inf slots are folded into each step's value before the
loop; each new M is pushed into the later steps that read it, the D - 1
newest on the chain side and the older ones (k <= W-1-D) into lane slots
(lane l owns the steps s with s - D = l mod 32, Q slots that rotate every
32 steps, a slot folds from its step's k = 0 on, the slots q <= Q - 3
without the predicate, which the model asserts true); a step's lane value is
handed to the chain side after its last lane push; the chain is one add
and one max.NaN; am is then the first k whose candidate has M's key. A
lane reads that the body does not use (k past the lanes' last, rows past
n) give NaN here, so one that reached a result would show. The model runs
at D in {1, 2, 3 (the body's), 4, W-1, W} where W allows, and its ks must
equal JAX's bit for bit on every case of test_torch_parallel.DP_CASES and
on seeded rows of ties, +-inf, NaN and -0.0. Tolerance 0 throughout."""

import numpy as np
import pytest

import jax.numpy as jnp
from test_torch_parallel import DP_CASES
from wgbs_tools_tpu.parallel import sharded as J

NEG = np.float32(-np.inf)
NAN = np.float32(np.nan)
LANES = 32


def order_key(v):
    """csrc/dp_scan.cu's order_key: uint32 keys ordered as the floats, -0.0
    as +0.0, every NaN above +inf."""
    v = np.asarray(v, np.float32)
    u = v.view(np.uint32).copy()
    u[(u << np.uint32(1)) == 0] = 0
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def max_nan(a, b):
    """PTX max.NaN.f32: NaN if either is NaN, else the larger."""
    return np.maximum(np.float32(a), np.float32(b))


def first_key_match(C, W, Mpad):
    """The argmax kernel: ks of each step from M, the first k whose
    candidate M[s+1+k] + C[s, k] equals M[W+s+1] or is NaN with it (k = 0
    where none does, as in the kernel; with the body's M one always
    does)."""
    n = C.shape[0]
    idx = np.arange(n)[:, None] + 1 + np.arange(W)[None, :]
    cand = Mpad[idx] + C
    ms = Mpad[W + 1:W + 1 + n, None]
    hit = (cand == ms) | (np.isnan(cand) & np.isnan(ms))
    return (np.arange(n) - (W - 1) + hit.argmax(axis=1)).astype(np.int32)


def push_model(C, W, D, slot_shift=0):
    """ks of one chain C (n, W) f32 in the push body's order of work with D
    candidates on the chain side (the body's D is min(3, W)). slot_shift
    moves the lane slots' first step, for the test that the model sees a
    slip."""
    with np.errstate(invalid="ignore"):  # -inf + +inf is NaN, as on the card
        return _push_model(C, W, D, slot_shift)


def _push_model(C, W, D, slot_shift):
    n = C.shape[0]
    lanes = W > D
    Q = 1 + (W - D + 30) // LANES if lanes else 0
    kmax = W - 1 - D  # the lanes' last k
    lane = np.arange(LANES)

    def lane_cost(s, k):
        ok = (k >= 0) & (k <= kmax) & (s < n)
        return np.where(ok, C[np.minimum(s, n - 1), np.clip(k, 0, W - 1)],
                        NAN).astype(np.float32)

    def chain_cost(i, d):  # C[i+d][W-1-d], what the diagonal buffer holds
        return C[i + d, W - 1 - d] if i + d < n else NAN

    pre = np.full(max(W - 1, 0), NEG)
    for s in range(W - 1):
        for k in range(W - 1 - s):
            c = C[s, k] if s < n else NAN
            pre[s] = max_nan(pre[s], NEG + c)
    chain_side = {s: pre[s] for s in range(min(D, W - 1))}
    hand = {}
    x = np.full((Q, LANES), NEG)
    for q in range(Q):
        s = LANES * q + lane + D
        x[q] = np.where(s <= W - 2, pre[np.minimum(s, max(W - 2, 0))], NEG)
    e = LANES * np.arange(Q)[:, None] + lane[None, :] - kmax + slot_shift
    M = np.float32(0.0)
    Mpad = np.full(n + W + 1, NEG)
    Mpad[W] = 0.0
    for r in range((n + LANES - 1) // LANES):
        for t in range(LANES):
            i = LANES * r + t
            for q in range(Q):  # push M_{i-1} into the lane slots
                s = LANES * (r + q) + lane + D
                k = kmax + t - LANES * q - lane
                term = M + lane_cost(s, k)
                if q + 3 <= Q:  # the body folds these without the predicate
                    assert (t >= e[q]).all()
                    x[q] = max_nan(x[q], term)
                else:
                    x[q] = np.where(t >= e[q], max_nan(x[q], term), x[q])
            R = max_nan(chain_side.pop(i, NEG), hand.pop(i, NEG))
            Mn = max_nan(R, M + chain_cost(i, 0))  # the chain
            for d in range(1, D):  # and the chain side's pushes
                chain_side[i + d] = max_nan(chain_side.get(i + d, NEG),
                                            M + chain_cost(i, d))
            if lanes:
                hand[i + D] = x[0, t]  # after the step's last lane push
            M = Mn
            if i < n:
                Mpad[W + 1 + i] = Mn
        if Q:
            x = np.concatenate([x[1:], np.full((1, LANES), NEG)])
    return first_key_match(C, W, Mpad)


def _random_cases():
    rng = np.random.default_rng(14)
    cases = []
    for W, n in ((1, 40), (2, 37), (3, 50), (4, 45), (5, 70), (7, 33),
                 (31, 80), (33, 90), (36, 100), (37, 110), (64, 150),
                 (65, 140)):
        C = np.round(2 * rng.normal(size=(2, n, W))).astype(np.float32)
        u = rng.random(size=C.shape)
        C[u < 0.02] = np.inf
        C[(u >= 0.02) & (u < 0.1)] = -np.inf
        C[(u >= 0.1) & (u < 0.11)] = np.nan
        C[(u >= 0.11) & (u < 0.2)] = -0.0
        cases.append((f"random W{W} n{n}", C))
    return cases


CASES = DP_CASES + _random_cases()


def _depths(W):
    return sorted({d for d in (1, 2, min(3, W), 4, W - 1, W) if 1 <= d <= W})


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_push_model_equals_jax(case):
    """The push body's order of work gives JAX's ks at every depth D."""
    _, C = CASES[case]
    W = C.shape[2]
    want = [np.asarray(J._dp_scan(jnp.asarray(c), W)) for c in C]
    for D in _depths(W):
        for c, w in zip(C, want):
            assert np.array_equal(push_model(c, W, D), w), D


def test_push_model_sees_a_slot_slip():
    """A lane slot that starts folding one step early or late (a slip of
    the predicate the body computes) changes ks on the cases."""
    for shift in (-1, 1):
        slipped = 0
        for _, C in CASES:
            W = C.shape[2]
            if W > 3:
                want = np.asarray(J._dp_scan(jnp.asarray(C[0]), W))
                slipped += not np.array_equal(
                    push_model(C[0], W, 3, slot_shift=shift), want)
        assert slipped, shift


def test_max_nan_keeps_the_largest_key():
    """max.NaN's result has the larger order_key of its operands, in either
    order, so the pushes may fold a step's candidates in any order."""
    vals = np.array([-np.inf, -3.5, -1.0, -0.0, 0.0, 1e-30, 2.0, np.inf,
                     np.nan, -np.nan], np.float32)
    a, b = np.meshgrid(vals, vals)
    got = order_key(max_nan(a, b))
    assert np.array_equal(got, np.maximum(order_key(a), order_key(b)))
    assert np.array_equal(got, order_key(max_nan(b, a)))
