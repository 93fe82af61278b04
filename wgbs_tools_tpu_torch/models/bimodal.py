"""test_bimodal: EM-based bimodality / allele-specific-methylation test.

Reimplements the reference's hard-assignment EM over the read x CpG matrix
(ref: src/python/test_bimodal.py:72-180): two allele profiles initialized at
0.9/0.1, reads argmax-assigned by log-likelihood, per-column Bernoulli
re-estimation with 1e-3 pseudocounts; the test statistic is a likelihood-
ratio chi^2 against the single-profile model with df = #CpGs.

The port's copy of wgbs_tools_tpu/models/bimodal.py (numpy; scipy's chi^2
for the p-value), on the host.
"""

import numpy as np

from ..formats.pat import CODE_C, CODE_T


def frags_to_matrix(frags, start, end, strict=True, min_len=1):
    """Expand fragments into a (reads, cpgs) call matrix with repeats.

    Exact reference semantics (ref: test_bimodal.py:25-69): reads ending at
    or before `start` are dropped; strict mode clips to [start, end) and
    min_len gates on the CLIPPED length; the matrix spans from the first
    kept read's (clipped) start to the max PRE-clip read end — both the
    trailing all-missing columns and all-missing rows are retained because
    they enter the chi^2 degrees of freedom / per-read mixture terms.
    """
    entries = []  # (clipped_start, codes, count)
    first_ind = None
    max_ind = 0
    for i in range(frags.nr_frags):
        s = int(frags.start[i])
        ln = int(frags.length[i])
        codes = frags.codes[i, :ln]
        cur_end = s + ln
        if cur_end <= start:
            continue
        if strict:
            if s < start:
                codes = codes[start - s :]
                s = start
            if s + len(codes) > end:
                codes = codes[: end - s]
        if len(codes) < min_len:
            continue
        if first_ind is None:
            first_ind = s
        max_ind = max(max_ind, cur_end)
        entries.append((s, codes, int(frags.count[i])))
    if first_ind is None:
        return np.zeros((0, 0), dtype=np.uint8)
    n_cpgs = max_ind - first_ind
    total = sum(c for _, _, c in entries)
    mat = np.full((total, n_cpgs), 3, dtype=np.uint8)
    row = 0
    for s, codes, count in entries:
        col = s - first_ind
        for _ in range(count):
            mat[row, col : col + len(codes)] = codes
            row += 1
    return mat


def _initial_ll(is_c, is_t):
    c_per_col = 1e-3 + is_c.sum(axis=0)
    t_per_col = 1e-3 + is_t.sum(axis=0)
    n_per_col = c_per_col + t_per_col
    l_p_c = np.log2(c_per_col / n_per_col)
    l_p_t = np.log2(t_per_col / n_per_col)
    ll0 = float((is_c.sum(axis=0) * l_p_c + is_t.sum(axis=0) * l_p_t).sum())
    return ll0, float(n_per_col.sum())


def _em(is_c, is_t, max_iter=100):
    num_reads, num_cpgs = is_c.shape
    p_c = np.zeros((2, num_cpgs))
    p_c[0, :] = 0.9
    p_c[1, :] = 0.1
    p_t = 1 - p_c
    l_p_c = np.log2(p_c)
    l_p_t = np.log2(p_t)
    l_p_alleles = np.log2(np.array([0.5, 0.5]))
    ll = -np.inf
    theta = (0.9, 0.1)
    for _ in range(max_iter):
        ll_alleles = (
            l_p_alleles[:, None]
            + l_p_c @ is_c.T.astype(np.float64)
            + l_p_t @ is_t.T.astype(np.float64)
        )
        assign = np.argmax(ll_alleles, axis=0)
        new_ll = float(ll_alleles[0, assign == 0].sum()
                       + ll_alleles[1, assign == 1].sum())
        if new_ll - ll <= 0:
            break
        ll = new_ll
        p_c = np.stack([
            1e-3 + is_c[assign == 0].sum(axis=0),
            1e-3 + is_c[assign == 1].sum(axis=0),
        ])
        p_t = np.stack([
            1e-3 + is_t[assign == 0].sum(axis=0),
            1e-3 + is_t[assign == 1].sum(axis=0),
        ])
        totals = p_c + p_t
        with np.errstate(divide="ignore"):
            l_p_c = np.log2(p_c / totals)
            l_p_t = np.log2(p_t / totals)
        theta = (float((p_c[0] / totals[0]).mean()),
                 float((p_c[1] / totals[1]).mean()))
    return ll, theta


def test_bimodal_region(frags, start, end, max_iter=100, strict=True,
                        min_len=1):
    """Returns {pval, nr_reads, theta1, theta2, ll0, ll1}."""
    from scipy import stats

    mat = frags_to_matrix(frags, start, end, strict=strict, min_len=min_len)
    if mat.shape[0] == 0:
        return dict(pval=1.0, nr_reads=0, theta1=np.nan, theta2=np.nan,
                    ll0=np.nan, ll1=np.nan)
    is_c = mat == CODE_C
    is_t = mat == CODE_T
    ll0, _ = _initial_ll(is_c, is_t)
    ll1, theta = _em(is_c, is_t, max_iter=max_iter)
    test_stat = 2 * np.log(2) * (ll1 - ll0)
    pv = float(1 - stats.chi2.cdf(test_stat, mat.shape[1]))
    return dict(pval=pv, nr_reads=int(mat.shape[0]), theta1=theta[0],
                theta2=theta[1], ll0=ll0, ll1=ll1)
