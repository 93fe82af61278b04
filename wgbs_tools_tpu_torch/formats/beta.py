"""beta / lbeta / bin file IO.

Format (ref: docs/beta_format.md): a raw binary (NR_SITES x 2) matrix of
(#meth, #coverage) per CpG site, uint8 for .beta/.bin, uint16 for .lbeta.
Random access by seeking to (site-1)*2*itemsize (ref: utils_wgbs.py:307-330).
The port's copy of wgbs_tools_tpu/formats/beta.py's `beta_dtype`,
`load_beta`, `save_beta`, `trim_to_uint`, `beta2vec`,
`beta_sanity_check` and `merge_betas`.
"""

import os.path as op

import numpy as np

from ..utils import IllegalArgumentError

BETA_SUFFIXES = (".beta", ".lbeta", ".bin")


def beta_dtype(path):
    return np.uint16 if path.endswith(".lbeta") else np.uint8


def load_beta(path, sites=None):
    """Load a beta file (or a 1-based [start, end) site slice) as (n, 2)."""
    suff = op.splitext(path)[1]
    if not (op.isfile(path) and suff in BETA_SUFFIXES):
        raise IllegalArgumentError(f"Invalid beta file:\n{path}")
    dtype = beta_dtype(path)
    if sites is None:
        data = np.fromfile(path, dtype).reshape((-1, 2))
    else:
        start, end = sites
        with open(path, "rb") as f:
            f.seek((start - 1) * 2 * dtype().itemsize)
            data = np.fromfile(f, dtype=dtype, count=(end - start) * 2).reshape((-1, 2))
    if not data.size:
        raise IllegalArgumentError(path + ": Data table is empty!")
    return data


def save_beta(path, data, lbeta=None):
    """Saturate+write counts to .beta/.lbeta/.bin (uint8/uint16)."""
    if lbeta is None:
        lbeta = path.endswith(".lbeta")
    trim_to_uint(np.asarray(data), lbeta).tofile(path)
    return path


def trim_to_uint(data, lbeta=False):
    """Saturation-normalize counts into uint8/uint16 range.

    Exact reference semantics (ref: utils_wgbs.py:277-290): where coverage
    exceeds the dtype max, meth is rescaled by meth/cov*max (numpy float->int
    truncation) and cov is clamped to max.
    """
    nr_bits = 16 if lbeta else 8
    dtype = np.uint16 if lbeta else np.uint8
    max_val = 2**nr_bits - 1
    data = np.array(data, dtype=np.int64, copy=True)
    big = data[:, 1] > max_val
    if big.any():
        data[big, 0] = (
            data[big, 0].astype(np.float64) / data[big, 1] * max_val
        ).astype(np.int64)
        data[big, 1] = max_val
    return data.astype(dtype)


def beta2vec(data, min_cov=1, na=np.nan):
    """Per-site methylation fraction with NaN below min coverage
    (ref: utils_wgbs.py:270-274)."""
    data = np.asarray(data, dtype=np.float64)
    cond = data[:, 1] >= min_cov
    with np.errstate(divide="ignore", invalid="ignore"):
        vec = data[:, 0] / data[:, 1]
    vec[~cond] = na
    return vec


def beta_sanity_check(path, nr_sites):
    found = op.getsize(path) // 2
    if path.endswith(".lbeta"):
        found //= 2
    return int(found) == int(nr_sites)


def merge_betas(beta_paths, out_path=None, lbeta=False):
    """Element-wise sum of beta files, saturated back to uint8/16
    (ref: merge.py:123-140). Returns the saturated array."""
    data = load_beta(beta_paths[0]).astype(np.int64)
    for b in beta_paths[1:]:
        nxt = load_beta(b)
        if nxt.shape != data.shape:
            raise IllegalArgumentError("beta files have incompatible sizes")
        data += nxt
    data = trim_to_uint(data, lbeta=lbeta)
    if out_path is not None:
        data.tofile(out_path)
    return data
