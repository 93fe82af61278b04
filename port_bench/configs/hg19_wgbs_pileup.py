"""Plain reference of hg19_wgbs_pileup: wgbs_tools' pat2beta in numpy.

upstream's stdin2beta.cpp reads the pat lines one by one and, for each
call of a line, adds the line's count to the site's coverage for C, T or
H and to its methylated count for C or H; '.' adds nothing. The table is
then saved as a uint8 beta by trim_to_uint8 (utils_wgbs.py): a site whose
coverage passes 255 keeps trunc(meth / cov * 255) of 255.

This file imports nothing but numpy: it reads the fragments the benchmark
drew (port_bench/gen.py::Frags), never the program's output or state.
"""

import numpy as np

CODE_T, CODE_C, CODE_H, CODE_DOT = 0, 1, 2, 3


def pileup(frags, n_sites):
    """(n_sites, 2) int64 [meth, cov] of the lines."""
    owner = np.repeat(np.arange(frags.n), frags.length)
    off = frags.offsets()
    site = frags.start[owner] - 1 + (np.arange(owner.shape[0]) - off[owner])
    w = frags.count[owner]
    called = frags.codes != CODE_DOT
    meth = (frags.codes == CODE_C) | (frags.codes == CODE_H)
    out = np.zeros((n_sites, 2), np.int64)
    out[:, 1] = np.bincount(site[called], weights=w[called],
                            minlength=n_sites).astype(np.int64)
    out[:, 0] = np.bincount(site[meth], weights=w[meth],
                            minlength=n_sites).astype(np.int64)
    return out


def saturate(counts, bits=8):
    """trim_to_uint8 with a cap of 2**bits - 1, as uint8."""
    cap = (1 << bits) - 1
    data = np.array(counts, np.int64)
    big = data[:, 1] > cap
    data[big, 0] = (data[big, 0].astype(np.float64) / data[big, 1]
                    * cap).astype(np.int64)
    data[big, 1] = cap
    return data.astype(np.uint8)


def beta(frags, n_sites, bits=8):
    """The beta file's (n_sites, 2) uint8 table. bits=4 is the control: the
    same table saturated in four bits, the precision below the beta's
    eight."""
    return saturate(pileup(frags, n_sites), bits)
