"""bam2pat's methylation calling and mate merging on the card.

The port's counterpart of wgbs_tools_tpu/ops/calling_tpu.py. Two kernels
(csrc/calling.cu) compute pipeline/calling.py's call_reads_mat and
merge_pe_mat (ref: src/pipeline_wgbs/patter.cpp:105-184, patter_utils.cpp:
292-342), which JAX jits from integer gathers and selects (_call_kernel
:59, _merge_kernel :113):

  - `call_reads`: tiles of consecutive reads of the CIGAR-normalized (R, L)
    sequence matrix; a sorted tile finds its run of the chromosome's CpG
    loci (resident on the device, one upload a chromosome) once and
    searches each read's window there, other tiles a read at a time in
    the whole array. Each covered CpG is called T / C / '.' once, and the
    calls are left-aligned to the first known one: its locus index, the
    span and the codes packed 2 bits each (4 a byte; T=0 C=1 H=2 .=3).
    Reads longer than ~5 kb take a warp a read. The kernel counts the
    paths it takes where asked (`call_reads(..., paths=)`);
  - `merge_pe`: tiles of pairs of mates, their rows staged in shared memory
    unless they are too wide (the C entry merge_pe_plan names the body);
    the earlier mate is A, a '.' in A takes B's call, a conflict gives '.',
    a pair wider than MAX_PE_PAT_LEN (300) sites is too long, and the
    result is left-aligned.

Each wrapper launches its kernel on CUDA tensors and counts the launch
(`call_reads.launches`, `merge_pe.launches`); on CPU tensors it runs the
kernel's plain-PyTorch twin (`call_reads_plain`, `merge_pe_plain`), and on
any other device it raises. Everything is an integer select, so kernel,
twin, JAX's kernels and numpy agree bit for bit.

`call_reads_device` and `merge_pe_device` keep JAX's contract: the inputs
of call_reads_mat / merge_pe_mat and outputs with their values and dtypes,
on `device`. Reads go up in chunks of ROWS (the device needs no padding of
R, unlike XLA's static shapes), and the codes come back packed, cut to the
widest span. JAX's v2 entry point (call_reads_device_v2: one-hot matmuls
over byte planes in place of gathers) is a TPU workaround for the same
function; the port has no counterpart, and its tests hold call_reads_device
to both JAX entry points.
"""

import threading

import numpy as np
import torch

from .. import _kernels
from ..device import resolve_device, timed
from ..pipeline.bam import FREVERSE

DOT = ord(".")
MAX_PE_PAT_LEN = 300  # ref: patter_utils.h:21
MERGE_BYTES = MAX_PE_PAT_LEN // 4
B_C, B_T, B_G, B_A = ord("C"), ord("T"), ord("G"), ord("A")
ROWS = 1 << 21       # reads (or pairs) a launch of the device entry points
TWIN_ROWS = 1 << 16  # rows a slice of the twins' (rows, K) temporaries
# the counters of csrc/calling.cu's call_reads_paths: tiles by path, and
# the reads of the long body
CALL_PATHS = ("staged", "unsorted", "wide", "long")

# call chars <-> 2-bit codes (formats/pat.py convention: T=0 C=1 H=2 .=3)
_CHAR2CODE = np.full(256, 3, dtype=np.uint8)
_CHAR2CODE[B_T] = 0
_CHAR2CODE[B_C] = 1
_CHAR2CODE[ord("H")] = 2
_CODE2CHAR = np.frombuffer(b"TCH.", dtype=np.uint8)


def _unpack2bit_host(packed, K):
    """(R, K // 4) packed codes -> (R, K) codes (calling_tpu.py:50)."""
    R = packed.shape[0]
    out = np.empty((R, K), dtype=np.uint8)
    for t in range(4):
        out[:, t::4] = (packed >> (2 * t)) & 3
    return out


def _pack2bit(codes):
    """(R, 4 * KB) int codes -> (R, KB) uint8, code t of a byte in bits
    2t..2t+1 (calling_tpu.py:41)."""
    c = codes.reshape(codes.shape[0], -1, 4).to(torch.int32)
    return (c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4)
            | (c[..., 3] << 6)).to(torch.uint8)


def _first_last(known):
    """(any, first, last) known column of each row of a bool matrix."""
    k = known.to(torch.uint8)
    first = k.argmax(1)
    last = known.shape[1] - 1 - k.flip(1).argmax(1)
    return known.any(1), first, last


def _check_rows(name, dtype, t, R):
    if t.dtype != dtype or t.shape != (R,) or not t.is_contiguous():
        raise ValueError(f"{name}: got {t.dtype} {tuple(t.shape)}, want a "
                         f"contiguous {dtype} ({R},)")


def _check_call(seq, lens, pos1, bottom, loci, KB):
    if seq.dim() != 2 or seq.dtype != torch.uint8 or not seq.is_contiguous():
        raise ValueError(f"seq: got {seq.dtype} {tuple(seq.shape)}, want a "
                         "contiguous torch.uint8 (R, L)")
    R = seq.shape[0]
    for name, dtype, t in (("lens", torch.int32, lens),
                           ("pos1", torch.int32, pos1),
                           ("bottom", torch.uint8, bottom)):
        _check_rows(name, dtype, t, R)
    _check_rows("loci", torch.int32, loci, loci.shape[0])
    for t in (lens, pos1, bottom, loci):
        if t.device != seq.device:
            raise ValueError(f"a tensor on {t.device}, seq on {seq.device}")
    if KB < 1:
        raise ValueError(f"KB must be >= 1, got {KB}")


def call_reads(seq, lens, pos1, bottom, loci, clip, KB, paths=None):
    """Call the CpGs of R reads: seq (R, L) uint8 CIGAR-normalized bytes
    (zero past each read), lens / pos1 (1-based first position) int32 (R,),
    bottom uint8 (R,) (1 for an OB read), loci int32 the chromosome's
    sorted CpG loci, `clip` bases forced unknown at either end, KB packed
    bytes a read (4 * KB >= the most calls a read can hold, len // 2 + 1).
    Returns (first_k int32 (R,): the locus index of the first known call or
    -1; span int32 (R,); packed uint8 (R, KB): the calls from first_k on,
    '.' past the span). CUDA tensors launch the kernel; CPU tensors take
    call_reads_plain. Every lens must be <= L. With `paths` (int64 (4,) on
    seq's CUDA device), the kernel adds to it the paths it took
    (CALL_PATHS: tiles staged, unsorted or wide; reads of the long
    body)."""
    _check_call(seq, lens, pos1, bottom, loci, KB)
    if seq.device.type == "cpu":
        if paths is not None:
            raise ValueError("paths counts the kernel's paths: CUDA only")
        return call_reads_plain(seq, lens, pos1, bottom, loci, clip, KB)
    _kernels.require_cuda("call_reads", seq.device)
    want = (len(CALL_PATHS),)
    if paths is not None and (paths.dtype != torch.int64
                              or tuple(paths.shape) != want
                              or not paths.is_contiguous()
                              or paths.device != seq.device):
        raise ValueError(f"paths: got {paths.dtype} {tuple(paths.shape)} on "
                         f"{paths.device}, want torch.int64 {want} on "
                         f"{seq.device}")
    R, L = seq.shape
    first_k = torch.empty(R, dtype=torch.int32, device=seq.device)
    span = torch.empty(R, dtype=torch.int32, device=seq.device)
    packed = torch.empty((R, KB), dtype=torch.uint8, device=seq.device)
    if R == 0:
        return first_k, span, packed
    ptrs = [seq.data_ptr(), lens.data_ptr(), pos1.data_ptr(),
            bottom.data_ptr(), loci.data_ptr(), first_k.data_ptr(),
            span.data_ptr(), packed.data_ptr()]
    if paths is not None:
        ptrs.append(paths.data_ptr())
    _kernels.launch("call_reads" if paths is None else "call_reads_paths",
                    seq.device, *ptrs, R, max(L, 1), loci.shape[0], KB,
                    int(clip))
    call_reads.launches += 1
    return first_k, span, packed


call_reads.launches = 0


def call_reads_plain(seq, lens, pos1, bottom, loci, clip, KB):
    """Twin of the call_reads kernel in plain PyTorch, JAX's _call_kernel
    step for step (searchsorted windows, (rows, K) gathers and selects,
    argmax for the first and last known call), in slices of TWIN_ROWS
    reads."""
    _check_call(seq, lens, pos1, bottom, loci, KB)
    R, L = seq.shape
    dev = seq.device
    K = 4 * KB
    first_k = torch.full((R,), -1, dtype=torch.int32, device=dev)
    span = torch.zeros(R, dtype=torch.int32, device=dev)
    packed = torch.full((R, KB), 0xFF, dtype=torch.uint8, device=dev)
    n = loci.shape[0]
    if R == 0 or n == 0 or L == 0:
        return first_k, span, packed
    loci64 = loci.to(torch.int64)
    kc = torch.arange(K, dtype=torch.int64, device=dev)[None, :]
    for lo in range(0, R, TWIN_ROWS):
        sl = slice(lo, min(lo + TWIN_ROWS, R))
        p = pos1[sl].to(torch.int64)
        n_r = lens[sl].to(torch.int64)[:, None]
        k0 = torch.searchsorted(loci64, p)
        k1 = torch.searchsorted(loci64, p + n_r[:, 0])
        valid = kc < (k1 - k0)[:, None]
        locus = loci64[torch.clamp(k0[:, None] + kc, max=n - 1)]
        bot = bottom[sl].to(torch.bool)[:, None]
        j = locus - p[:, None] + bot.to(torch.int64)
        rows = seq[sl].to(torch.int64)

        def at(x):
            return rows.gather(1, torch.clamp(x, 0, L - 1))

        s, prev, nxt = at(j), at(j - 1), at(j + 1)
        iscpg = torch.where(
            bot, (j > 0) & ((s == B_G) | (s == B_A)) & (prev == B_C),
            (j < n_r - 1) & ((s == B_C) | (s == B_T)) & (nxt == B_G))
        ref_chr = torch.where(bot, B_G, B_C)
        unmeth_chr = torch.where(bot, B_A, B_T)
        codes = torch.full(j.shape, 3, dtype=torch.int64, device=dev)
        codes = torch.where(iscpg & (s == unmeth_chr), 0, codes)
        codes = torch.where(iscpg & (s == ref_chr), 1, codes)
        if clip > 0:
            codes = torch.where((j >= clip) & (j < n_r - clip), codes, 3)
        codes = torch.where((j >= 0) & (j < n_r) & valid, codes, 3)
        any_, first, last = _first_last(codes != 3)
        sp = torch.where(any_, last - first + 1, 0)
        aligned = codes.gather(1, torch.clamp(first[:, None] + kc, max=K - 1))
        aligned = torch.where(kc < sp[:, None], aligned, 3)
        first_k[sl] = torch.where(any_, k0 + first, -1).to(torch.int32)
        span[sl] = sp.to(torch.int32)
        packed[sl] = _pack2bit(aligned)
    return first_k, span, packed


def _check_merge(s1, sp1, p1, s2, sp2, p2):
    n = s1.shape[0]
    for name, dtype, t in (("s1", torch.int64, s1), ("s2", torch.int64, s2),
                           ("sp1", torch.int32, sp1),
                           ("sp2", torch.int32, sp2)):
        _check_rows(name, dtype, t, n)
    for name, p in (("p1", p1), ("p2", p2)):
        if (p.dim() != 2 or p.shape[0] != n or p.shape[1] < 1
                or p.dtype != torch.uint8 or not p.is_contiguous()):
            raise ValueError(f"{name}: got {p.dtype} {tuple(p.shape)}, want "
                             f"a contiguous torch.uint8 ({n}, S >= 1)")
    for t in (sp1, p1, s2, sp2, p2):
        if t.device != s1.device:
            raise ValueError(f"a tensor on {t.device}, s1 on {s1.device}")


def merge_pe(s1, sp1, p1, s2, sp2, p2):
    """Merge n pairs of called mates: s1 / s2 int64 (n,) first sites (>=
    0), sp1 / sp2 int32 (n,) spans (each <= its pattern width), p1 / p2
    uint8 (n, S1) / (n, S2) pattern chars ('T', 'C', 'H', '.'; any other
    byte reads as '.'). Returns (start int64 (n,): the merged read's first
    site or -1; span int32 (n,); packed uint8 (n, 75): its 300 codes from
    the start, '.' past the span; too_long uint8 (n,): 1 where the pair is
    wider than 300 sites, which then carries no pattern). CUDA tensors
    launch the kernel; CPU tensors take merge_pe_plain."""
    _check_merge(s1, sp1, p1, s2, sp2, p2)
    if s1.device.type == "cpu":
        return merge_pe_plain(s1, sp1, p1, s2, sp2, p2)
    _kernels.require_cuda("merge_pe", s1.device)
    n, dev = s1.shape[0], s1.device
    start = torch.empty(n, dtype=torch.int64, device=dev)
    span = torch.empty(n, dtype=torch.int32, device=dev)
    packed = torch.empty((n, MERGE_BYTES), dtype=torch.uint8, device=dev)
    too_long = torch.empty(n, dtype=torch.uint8, device=dev)
    if n == 0:
        return start, span, packed, too_long
    _kernels.launch("merge_pe", dev, s1.data_ptr(), sp1.data_ptr(),
                    p1.data_ptr(), s2.data_ptr(), sp2.data_ptr(),
                    p2.data_ptr(), start.data_ptr(), span.data_ptr(),
                    packed.data_ptr(), too_long.data_ptr(), n, p1.shape[1],
                    p2.shape[1])
    merge_pe.launches += 1
    return start, span, packed, too_long


merge_pe.launches = 0


def merge_pe_plain(s1, sp1, p1, s2, sp2, p2):
    """Twin of the merge_pe kernel in plain PyTorch, JAX's _merge_kernel
    step for step over (rows, 300) codes, in slices of TWIN_ROWS pairs."""
    _check_merge(s1, sp1, p1, s2, sp2, p2)
    n, dev = s1.shape[0], s1.device
    W = MAX_PE_PAT_LEN
    start = torch.full((n,), -1, dtype=torch.int64, device=dev)
    span = torch.zeros(n, dtype=torch.int32, device=dev)
    packed = torch.full((n, MERGE_BYTES), 0xFF, dtype=torch.uint8,
                        device=dev)
    too_long = torch.zeros(n, dtype=torch.uint8, device=dev)
    lut = torch.from_numpy(_CHAR2CODE).to(dev).to(torch.int64)
    S = max(p1.shape[1], p2.shape[1])
    cols = torch.arange(W, dtype=torch.int64, device=dev)[None, :]
    for lo in range(0, n, TWIN_ROWS):
        sl = slice(lo, min(lo + TWIN_ROWS, n))
        c1, c2 = (torch.nn.functional.pad(lut[p[sl].to(torch.int64)],
                                          (0, S - p.shape[1]), value=3)
                  for p in (p1, p2))
        x1, x2 = s1[sl], s2[sl]
        l1, l2 = sp1[sl].to(torch.int64), sp2[sl].to(torch.int64)
        swap = x1 > x2
        a_s, b_s = torch.where(swap, x2, x1), torch.where(swap, x1, x2)
        a_sp, b_sp = torch.where(swap, l2, l1), torch.where(swap, l1, l2)
        a_p = torch.where(swap[:, None], c2, c1)
        b_p = torch.where(swap[:, None], c1, c2)
        width = torch.maximum(a_s + a_sp, b_s + b_sp) - a_s
        longer = width > W
        A = torch.where(cols < a_sp[:, None],
                        a_p[:, torch.clamp(cols[0], max=S - 1)], 3)
        bidx = cols - (b_s - a_s)[:, None]
        validB = (bidx >= 0) & (bidx < b_sp[:, None])
        B = torch.where(validB, b_p.gather(1, torch.clamp(bidx, 0, S - 1)),
                        3)
        merged = torch.where(A == 3, B,
                             torch.where((B != 3) & (A != B), 3, A))
        merged = torch.where(cols < torch.clamp(width, max=W)[:, None],
                             merged, 3)
        known_any, first, last = _first_last(merged != 3)
        any_ = known_any & ~longer
        sp = torch.where(any_, last - first + 1, 0)
        patm = merged.gather(1, torch.clamp(first[:, None] + cols, max=W - 1))
        patm = torch.where(cols < sp[:, None], patm, 3)
        start[sl] = torch.where(any_, a_s + first, -1)
        span[sl] = sp.to(torch.int32)
        packed[sl] = _pack2bit(patm)
        too_long[sl] = longer.to(torch.uint8)
    return start, span, packed, too_long


_LOCI = {}  # (chrom, device) -> (the host loci, their tensor)
_LOCI_GENOME = [None]  # the array the cached loci are views of
_LOCI_LOCK = threading.Lock()


def _genome_array(a):
    """The array that `a` is a view of (a itself if it owns its data)."""
    while isinstance(a.base, np.ndarray):
        a = a.base
    return a


def _same_buffer(a, b):
    return (a.__array_interface__["data"][0] == b.__array_interface__["data"]
            [0] and a.shape == b.shape and a.strides == b.strides
            and a.dtype == b.dtype)


def loci_device(loci, device, chrom=None):
    """The chromosome's CpG loci as an int32 tensor on `device`. With a
    chromosome name the tensor stays resident while the same host memory
    asks for it: an entry is keyed by (chromosome, device), holds the host
    array it was made from (so its memory cannot be reused while the entry
    lives), and answers only an array over the same bytes (a view of the
    CpG index's loci taken again hits). The cache holds one genome: loci
    that are views of another array than the cached ones' clear it. So
    each chromosome goes up once a process however many batches and host
    threads call it; without a name it goes up on each call."""
    if chrom is None or len(loci) == 0:
        return torch.from_numpy(np.ascontiguousarray(loci, dtype=np.int32)
                                ).to(device)
    key = (chrom, str(device))
    genome = _genome_array(loci)
    with _LOCI_LOCK:
        if _LOCI_GENOME[0] is not genome:
            _LOCI.clear()
            _LOCI_GENOME[0] = genome
        hit = _LOCI.get(key)
        if hit is None or not _same_buffer(hit[0], loci):
            hit = (loci, torch.from_numpy(np.ascontiguousarray(
                loci, dtype=np.int32)).to(device))
            _LOCI[key] = hit
    return hit[1]


def call_columns(positions, flags, paired, seqmat, lens):
    """call_reads_device's host columns of a batch: (pos1 int64, lens
    int64, bottom bool (R,), KB packed bytes a read). Raises if a read is
    longer than the sequence matrix is wide."""
    lens = np.asarray(lens, dtype=np.int64)
    pos1 = np.asarray(positions, dtype=np.int64)
    flags = np.asarray(flags, dtype=np.int64)
    if paired:
        bottom = ((flags & 0x53) == 83) | ((flags & 0xA3) == 163)
    else:
        bottom = (flags & FREVERSE) != 0
    L = seqmat.shape[1]
    Lmax = int(lens.max(initial=0))
    if Lmax > L:
        raise ValueError(f"a read of length {Lmax} in a sequence matrix of "
                         f"width {L}")
    # calls per read <= len // 2 + 1 (a CpG every 2 bp); K from the
    # normalized lengths, which a CIGAR can widen past the raw reads'
    return pos1, lens, bottom, (Lmax // 2 + 2 + 3) // 4


def call_reads_device(positions, flags, paired, loci, site_base, seqmat,
                      lens, clip=0, device="cuda", chrom=None, timings=None):
    """calling.call_reads_mat on `device` ('cuda' launches the kernel,
    'cpu' runs its twin), m-bias excluded: m-bias runs call on the host.
    Returns (start int64 (R,): the global 1-based site of each read's first
    known call or -1; patmat uint8 (R, max span) of pattern chars,
    '.'-padded; span int64 (R,)), call_reads_mat's values and dtypes.
    `chrom` names the chromosome whose loci these are, to keep them on the
    device (loci_device). With `timings`, the seconds of h2d, the calls and
    d2h accumulate under "call_h2d", "call_kernel" and "call_d2h"."""
    R = seqmat.shape[0]
    no_calls = (np.full(R, -1, dtype=np.int64),
                np.full((R, 1), DOT, dtype=np.uint8),
                np.zeros(R, dtype=np.int64))
    if R == 0:
        return no_calls
    dev = resolve_device(device)
    pos1, lens, bottom, KB = call_columns(positions, flags, paired, seqmat,
                                          lens)
    with timed(timings, "call_h2d", dev):
        loci_t = loci_device(loci, dev, chrom)
    outs = []
    for lo in range(0, R, ROWS):
        sl = slice(lo, min(lo + ROWS, R))
        with timed(timings, "call_h2d", dev):
            cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (seqmat[sl].astype(np.uint8, copy=False),
                              lens[sl].astype(np.int32),
                              pos1[sl].astype(np.int32),
                              bottom[sl].astype(np.uint8))]
        with timed(timings, "call_kernel", dev):
            outs.append((sl, call_reads(*cols, loci_t, int(clip), KB)))
    with timed(timings, "call_d2h", dev):
        starts = np.full(R, -1, dtype=np.int64)
        spans = np.zeros(R, dtype=np.int64)
        for sl, (first_k, span, _) in outs:
            fk = first_k.cpu().numpy().astype(np.int64)
            spans[sl] = span.cpu().numpy()
            starts[sl] = np.where(fk >= 0, site_base + fk, -1)
        maxspan = max(int(spans.max(initial=1)), 1)
        nb = (maxspan + 3) // 4
        pats = np.empty((R, 4 * nb), dtype=np.uint8)
        for sl, (_, _, packed) in outs:
            pats[sl] = _unpack2bit_host(packed[:, :nb].cpu().numpy(), 4 * nb)
    return starts, _CODE2CHAR[pats[:, :maxspan]], spans


def merge_pe_device(s1, pat1, sp1, s2, pat2, sp2, device="cuda",
                    timings=None):
    """calling.merge_pe_mat on `device` ('cuda' launches the kernel, 'cpu'
    runs its twin): char matrices in and out. Returns (start int64 (-1 =
    merged read all-unknown), patmat uint8 (n, max span) '.'-padded, span
    int64, too_long bool), merge_pe_mat's values and dtypes. With
    `timings`, its seconds accumulate under "merge"."""
    n = s1.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros((0, 1), np.uint8),
                np.zeros(0, np.int64), np.zeros(0, bool))
    for sp, pat in ((sp1, pat1), (sp2, pat2)):
        if int(np.max(sp, initial=0)) > pat.shape[1]:
            raise ValueError("a span wider than its pattern matrix")
    dev = resolve_device(device)
    with timed(timings, "merge", dev):
        outs = []
        for lo in range(0, n, ROWS):
            sl = slice(lo, min(lo + ROWS, n))
            cols = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                    for a in (np.asarray(s1[sl], np.int64),
                              np.asarray(sp1[sl], np.int32),
                              pat1[sl].astype(np.uint8, copy=False),
                              np.asarray(s2[sl], np.int64),
                              np.asarray(sp2[sl], np.int32),
                              pat2[sl].astype(np.uint8, copy=False))]
            outs.append((sl, merge_pe(*cols)))
        starts = np.empty(n, dtype=np.int64)
        span = np.empty(n, dtype=np.int64)
        too_long = np.empty(n, dtype=bool)
        for sl, (st, sp, _, tl) in outs:
            starts[sl] = st.cpu().numpy()
            span[sl] = sp.cpu().numpy()
            too_long[sl] = tl.cpu().numpy() != 0
        Wout = max(int(span.max(initial=1)), 1)
        nb = (Wout + 3) // 4
        codes = np.empty((n, 4 * nb), dtype=np.uint8)
        for sl, (_, _, packed, _) in outs:
            codes[sl] = _unpack2bit_host(packed[:, :nb].cpu().numpy(), 4 * nb)
    return starts, _CODE2CHAR[codes[:, :Wout]], span, too_long
