"""beta / lbeta saturation (ref: docs/beta_format.md): a raw binary
(NR_SITES x 2) matrix of (#meth, #coverage) per CpG site, uint8 for .beta,
uint16 for .lbeta. The port's copy of wgbs_tools_tpu/formats/beta.py's
`trim_to_uint`."""

import numpy as np


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
