"""Block reductions: per-CpG count tables -> per-block sums, the device op
of beta_to_blocks and beta_to_table.

Port of wgbs_tools_tpu/ops/reduceat.py. `reduce_data_to_blocks` clips
each block to the table as JAX does (np.clip(starts - base, 0, N); an NA
block, start < 0, sums to zeros) and sums it in int64. One kernel,
`block_sums` (csrc/reduceat.cu), takes the table as it is on disk (uint8,
or uint16 for lbeta) and each block's clipped [s, e), so JAX's two paths,
the segment_sum over sorted non-overlapping blocks (:53-67) and the
per-block numpy sums (:68-71), are one here: each block sums its own
range: a warp takes a run of RUN blocks and, where their hull fits in
SPAN_ROWS rows, stages it in shared memory and answers each block from
chunk prefix sums; a wider hull is summed a warp a block from global
memory; with `long_blocks`, a block of more than SPAN_ROWS rows is cut
into pieces of PIECE_ROWS rows that a second launch sums over the whole
card (without, its warp sums it). Its twin, `block_sums_plain`, is an
int64 prefix sum and P[e] - P[s]. A wrapper sends CUDA tensors to the
kernel and CPU tensors to the twin; `block_sums.launches` counts the
kernel's calls (one a call, with or without the pieces launch).

JAX's sums are int32 and wrap past 2^31 (a block over a whole chromosome
at coverage 255); numpy's and these do not.

With a list of more than one device the site range is split over them
(JAX's _reduce_nice_sharded, :75): each shard sums the blocks clipped to
its rows, and the int64 partials are added on the first device.
"""

import numpy as np
import torch

from .. import _kernels
from ..device import resolve_device, timed

# csrc/reduceat.cu's geometry, for the tests' model of its order of work
RUN = 32             # blocks a warp takes
SPAN_ROWS = 2040     # rows of a staged hull at most; a longer block is long
STAGE_ROWS = 2048    # rows of a warp's stage
PIECE_ROWS = 65536   # rows of a long block's piece


def block_bounds(starts, ends, base, n):
    """(B, 2) int64 [s, e) rows of an n-row table whose row 0 is 1-based
    site `base`, per block of 1-based [starts, ends): clipped to [0, n]
    with e >= s; an NA block (start < 0) is [0, 0)."""
    starts = np.asarray(starts, dtype=np.int64)
    ends = np.asarray(ends, dtype=np.int64)
    s = np.clip(starts - base, 0, n)
    e = np.maximum(np.clip(ends - base, 0, n), s)
    na = starts < 0
    s[na] = 0
    e[na] = 0
    return np.stack([s, e], axis=1)


def _check(data, bounds):
    if data.dim() != 2 or not data.is_contiguous():
        raise ValueError(f"data: got {tuple(data.shape)} (contiguous="
                         f"{data.is_contiguous()}), want a contiguous (N, C)")
    if (bounds.dim() != 2 or bounds.shape[1] != 2
            or bounds.dtype != torch.int64 or not bounds.is_contiguous()):
        raise ValueError(f"bounds: got {bounds.dtype} {tuple(bounds.shape)}, "
                         "want a contiguous torch.int64 (B, 2)")
    if bounds.device != data.device:
        raise ValueError(f"bounds on {bounds.device}, data on {data.device}")


def block_sums(data, bounds, long_blocks=True):
    """int64 (B, C) sums of data[s:e] per row [s, e) of `bounds`.

    data: (N, 2) uint8 or uint16 on CUDA (the kernel), or (N, C) of any
    integer type on the CPU (block_sums_plain). bounds: int64 (B, 2), 0 <=
    s <= e <= N (block_bounds), on data's device. long_blocks False (the
    caller knows no block is longer than SPAN_ROWS rows) skips the pieces
    launch: a longer block is then still summed, by one warp."""
    _check(data, bounds)
    if data.device.type == "cpu":
        return block_sums_plain(data, bounds)
    if data.shape[1] != 2 or data.dtype not in (torch.uint8, torch.uint16):
        raise ValueError(f"data: got {data.dtype} {tuple(data.shape)}, the "
                         "kernel takes a (N, 2) torch.uint8 or torch.uint16 "
                         "table")
    itemsize = data.element_size()
    if data.data_ptr() % (2 * itemsize):
        raise ValueError("data: rows are loaded as one vector of "
                         f"{2 * itemsize} bytes and must be aligned to it")
    B = bounds.shape[0]
    out = torch.empty((B, 2), dtype=torch.int64, device=data.device)
    if B == 0:
        return out
    # the long blocks' list: a count, then up to B indices
    scratch = (torch.empty(B + 1, dtype=torch.int64, device=data.device)
               if long_blocks else None)
    _kernels.launch("block_sums", data.device, data.data_ptr(),
                    bounds.data_ptr(), out.data_ptr(),
                    None if scratch is None else scratch.data_ptr(), B,
                    data.shape[0], itemsize, int(bool(long_blocks)))
    block_sums.launches += 1
    return out


block_sums.launches = 0


def block_sums_plain(data, bounds):
    """Twin of the kernel in plain PyTorch: P, the int64 prefix sums of
    each column of data with a zero first, then P[e] - P[s]. Each column
    is its own 1-D scan (a scan down the rows of an (N, 2) tensor takes
    seconds on the card at hg19 size)."""
    _check(data, bounds)
    P = torch.zeros((data.shape[1], data.shape[0] + 1), dtype=torch.int64,
                    device=data.device)
    for c in range(data.shape[1]):
        torch.cumsum(data[:, c].to(torch.int64), dim=0, out=P[c, 1:])
    return (P[:, bounds[:, 1]] - P[:, bounds[:, 0]]).T.contiguous()


def _sums_on(rows, bounds, dev, timings):
    """block_sums of the host table `rows` over host `bounds` on `dev`."""
    long_blocks = bool((bounds[:, 1] - bounds[:, 0] > SPAN_ROWS).any())
    with timed(timings, "h2d", dev):
        d = torch.from_numpy(rows).to(dev)
        bd = torch.from_numpy(bounds).to(dev)
    with timed(timings, "kernel", dev):
        return block_sums(d, bd, long_blocks)


def reduce_data_to_blocks(data, starts, ends, base=1, device="cuda",
                          timings=None):
    """Sum data rows per block.

    data: (N, C) host counts whose row 0 corresponds to 1-based site
    `base` (a beta table as loaded: uint8 / uint16). starts/ends: 1-based
    [startCpG, endCpG) per block; rows with start < 0 (NA) yield zeros
    (ref: beta_to_blocks.py:108-116). `device` is one device ("cuda"
    raises without CUDA; "cpu" runs the twin) or a list of them, one per
    site shard (parallel/mesh.py::shard_devices). Only the rows the blocks
    reach are uploaded. With
    `timings`, the seconds of h2d, kernel and fetch accumulate there.
    Returns int64 (B, C) on the host."""
    bounds = block_bounds(starts, ends, base, data.shape[0])
    out = np.zeros((bounds.shape[0], data.shape[1]), dtype=np.int64)
    used = bounds[:, 1] > bounds[:, 0]
    if not used.any():
        return out
    lo = int(bounds[used, 0].min())
    hi = int(bounds[used, 1].max())
    rows = np.ascontiguousarray(data[lo:hi])
    bounds = np.where(used[:, None], bounds - lo, 0)
    devices = [resolve_device(d) for d in (
        device if isinstance(device, (list, tuple)) else [device])]
    if len(devices) == 1:
        res = _sums_on(rows, bounds, devices[0], timings)
    else:
        res = None
        n = hi - lo
        for j, dev in enumerate(devices):
            a, b = n * j // len(devices), n * (j + 1) // len(devices)
            part = _sums_on(rows[a:b], np.clip(bounds, a, b) - a, dev,
                            timings)
            part = part.to(devices[0])
            res = part if res is None else res + part
    with timed(timings, "fetch", None):
        out[:] = res.cpu().numpy()
    return out
