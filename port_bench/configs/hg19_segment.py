"""Plain reference of hg19_segment: wgbs_tools' segment in plain PyTorch.

upstream (src/python/segment.py, src/segment_betas/segmentor.cpp) cuts
each chromosome into chunks of chunk_size sites, segments each chunk by a
DP, and stitches neighbouring chunks by re-segmenting a patch around their
common border until the patch shares a border with each side.

The DP over the sites of a window, for a block [k, i] of sites:

    cost(k, i) = sum_d nm*log2(p) + (nt - nm)*log2(1 - p),
                 p = (nm + pc) / (nt + 2*pc), over the block's counts in
                 dataset d, and -inf where i - k >= min(max_cpg, n) or
                 locus(i) - locus(k) > max_bp
    M[i + 1] = max_k M[k] + cost(k, i), the first (smallest) k on a tie

segmentor.cpp computes p in float, each log2 in double, rounds each
dataset's sum through a float, and adds the datasets and runs the DP in
double; "float64" here follows that chain. "float32" and "bfloat16" run
the same DP wholly in the lower type: they are the controls.

The windows of one call run together, a step of the DP at a time for all
of them, on the device given. This file imports nothing but numpy and
torch: it reads the counts the benchmark drew, never the program's output
or state.
"""

import numpy as np
import torch

NEG = float("-inf")
CELLS = 40_000_000  # (window, site, candidate) cells of the cost a block


def _key(loci, chrom_offsets):
    """A monotone int64 position key: the chromosome in the high bits, so a
    band never crosses from one chromosome into the next."""
    chrom = np.repeat(np.arange(len(chrom_offsets) - 1),
                      np.diff(chrom_offsets))
    return (chrom.astype(np.int64) << 40) + np.asarray(loci, np.int64)


class Segmenter:
    """The genome's counts on `device`, and the DP over windows of it."""

    def __init__(self, data, loci, chrom_offsets, params, precision="float64",
                 device="cpu"):
        dev = torch.device(device)
        self.dev = dev
        self.params = params
        self.precision = precision
        d = torch.from_numpy(np.ascontiguousarray(data)).to(dev)
        K, n, _ = d.shape
        self.K, self.n = K, n
        z = torch.zeros((K, 1, 2), dtype=torch.int64, device=dev)
        self.prefix = torch.cat([z, d.to(torch.int64).cumsum(1)], dim=1)
        self.key = torch.from_numpy(_key(loci, chrom_offsets)).to(dev)
        self.chrom_offsets = np.asarray(chrom_offsets, np.int64)

    # -- the DP -----------------------------------------------------------

    def _kmin(self, base, lens, pos):
        """Smallest local k of the band ending at local site pos, per
        window; pos past a window's end gets a band of one."""
        p = self.params
        gi = (base[:, None] + pos[None, :]).clamp(max=self.n - 1)
        first = torch.searchsorted(self.key, self.key[gi] - p["max_bp"])
        w = torch.clamp(lens, max=p["max_cpg"])[:, None]
        kmin = torch.maximum(first - base[:, None], pos[None, :] - w + 1)
        kmin = kmin.clamp(min=0)
        return torch.where(pos[None, :] < lens[:, None], kmin, pos[None, :])

    def _costs(self, base, kmin, i0, i1, Wb):
        """(nw, i1 - i0, Wb) costs of the blocks [k, i], k = i - Wb + 1 + j,
        in the DP's type; -inf outside the band."""
        dev, p = self.dev, self.params
        i = torch.arange(i0, i1, device=dev)
        j = torch.arange(Wb, device=dev)
        k = i[:, None] - Wb + 1 + j[None, :]
        valid = k[None] >= kmin[:, i0:i1, None]
        hi = (base[:, None] + i[None, :] + 1).clamp(max=self.n)
        lo = (base[:, None, None] + k[None]).clamp(0, self.n)
        pc = float(p["pcount"])
        exact = self.precision == "float64"
        dt = {"float64": torch.float64, "float32": torch.float32,
              "bfloat16": torch.bfloat16}[self.precision]
        total = torch.zeros(valid.shape, dtype=dt, device=dev)
        for d in range(self.K):
            ps = self.prefix[d]
            nm = ps[hi, 0][:, :, None] - ps[lo, 0]
            nt = ps[hi, 1][:, :, None] - ps[lo, 1]
            if exact:
                nm, nt = nm.double(), nt.double()
                # float p: the quotient of exact floats, correctly rounded
                prob = ((nm + pc) / (nt + 2 * pc)).float().double()
                a = (nm * torch.log2(prob)).float().double()
                ll = (a + (nt - nm) * torch.log2(1.0 - prob)).float().double()
            else:
                nm, nt = nm.to(dt), nt.to(dt)
                prob = (nm + pc) / (nt + 2 * pc)
                ll = nm * torch.log2(prob) + (nt - nm) * torch.log2(1 - prob)
            total = total + ll.masked_fill_(nt == 0, 0)
        return total.masked_fill_(~valid, NEG)

    def dp(self, windows):
        """1-based absolute borders of each 1-based window [s, e), endpoints
        included."""
        out = [None] * len(windows)
        todo = [w for w, (s, e) in enumerate(windows) if e - s > 1]
        for w, (s, e) in enumerate(windows):
            if e - s <= 1:
                out[w] = np.array([s, e], np.int64)
        if not todo:
            return out
        dev = self.dev
        base = torch.tensor([windows[w][0] - 1 for w in todo], device=dev)
        lens = torch.tensor([windows[w][1] - windows[w][0] for w in todo],
                            device=dev)
        nw, L = len(todo), int(lens.max())
        pos = torch.arange(L, device=dev)
        kmin = self._kmin(base, lens, pos)
        Wb = int((pos[None, :] - kmin).max()) + 1
        dt = {"float64": torch.float64, "float32": torch.float32,
              "bfloat16": torch.bfloat16}[self.precision]
        M = torch.full((nw, L + Wb), NEG, dtype=dt, device=dev)
        M[:, Wb - 1] = 0  # M[k] lives at column Wb - 1 + k
        args = []
        step = max(16, CELLS // (nw * Wb))
        for i0 in range(0, L, step):
            i1 = min(L, i0 + step)
            C = self._costs(base, kmin, i0, i1, Wb)
            for i in range(i0, i1):
                best, arg = (M[:, i:i + Wb] + C[:, i - i0]).max(dim=1)
                M[:, Wb + i] = best
                args.append(arg)
        T = torch.stack(args, dim=1) + (pos - Wb + 1)[None, :]
        T = T.cpu().numpy()
        n = lens.cpu().numpy()
        # trace every window back at once: cur[w] walks T from n[w] to 0
        mark = np.zeros((nw, L + 1), bool)
        rows = np.arange(nw)
        cur = n.copy()
        mark[rows, cur] = True
        while (cur > 0).any():
            act = cur > 0
            cur[act] = T[rows[act], cur[act] - 1]
            mark[rows[act], cur[act]] = True
        for r, w in enumerate(todo):
            out[w] = np.flatnonzero(mark[r, : n[r] + 1]) + windows[w][0]
        return out

    # -- chunks and stitching ---------------------------------------------

    def segment(self):
        """(starts, ends) 1-based of the blocks over every chromosome."""
        p = self.params
        groups = []
        for c in range(len(self.chrom_offsets) - 1):
            s, e = int(self.chrom_offsets[c]) + 1, int(
                self.chrom_offsets[c + 1]) + 1
            if e > s:
                b = list(range(s, e, p["chunk_size"])) + [e]
                groups.append(list(zip(b[:-1], b[1:])))
        flat = [w for g in groups for w in g]
        res = iter(self.dp(flat))
        borders = [[next(res) for _ in g] for g in groups]
        merged = self._stitch(borders)
        starts = np.concatenate([m[:-1] for m in merged])
        ends = np.concatenate([m[1:] for m in merged])
        order = np.argsort(starts, kind="stable")
        starts, ends = starts[order], ends[order]
        keep = ends - starts > p["min_cpg"] - 1
        return starts[keep], ends[keep]

    def _stitch(self, groups):
        """Pairwise rounds over each chromosome's chunks; a pair's patch
        starts 50 sites to each side of the common border and grows on the
        side that shares no border with it."""
        out = [None] * len(groups)
        work = [(gi, list(g)) for gi, g in enumerate(groups)]
        while work:
            pairs, nxt = [], {}
            for gi, bl in work:
                if len(bl) == 1:
                    out[gi] = bl[0]
                    continue
                slots = []
                for i in range(1, len(bl), 2):
                    b1, b2 = bl[i - 1], bl[i]
                    n1, n2 = int(b1[-1] - b1[0]), int(b2[-1] - b2[0])
                    pairs.append([gi, len(slots), b1, b2, min(50, n1),
                                  min(50, n2), n1, n2])
                    slots.append(None)
                if len(bl) % 2:
                    slots.append(bl[-1])
                nxt[gi] = slots
            while pairs:
                patches = self.dp([(int(q[2][-1]) - q[4], int(q[2][-1]) + q[5])
                                   for q in pairs])
                still = []
                for q, patch in zip(pairs, patches):
                    gi, slot, b1, b2, p1, p2, n1, n2 = q
                    o1, o2 = _shared(b1, patch), _shared(patch, b2)
                    if o1 and o2:
                        nxt[gi][slot] = _join(_join(b1, patch), b2)
                        continue
                    if not o1:
                        q[4] = _grow(p1, n1)
                    if not o2:
                        q[5] = _grow(p2, n2)
                    if q[4] > n1 or q[5] > n2:
                        raise RuntimeError("patch stitching failed")
                    still.append(q)
                pairs = still
            work = list(nxt.items())
        return out


def _common(a, b):
    """The borders of b that a holds too (both ascending)."""
    i = np.minimum(np.searchsorted(a, b), a.size - 1)
    return b[a[i] == b]


def _shared(a, b):
    return bool(_common(a, b).size)


def _join(a, b):
    """a up to its first border that b shares, then b after it."""
    v = _common(a, b)[0]
    return np.concatenate([a[: int(np.searchsorted(a, v)) + 1],
                           b[int(np.searchsorted(b, v)) + 1:]])


def _grow(pre, most):
    return most + 1 if pre == most else int(min(pre * 2, most))


def segment(data, loci, chrom_offsets, params, precision="float64",
            device="cpu"):
    """(starts, ends) of the blocks of (K, n_sites, 2) counts `data`."""
    return Segmenter(data, loci, chrom_offsets, params, precision,
                     device).segment()


def bed_columns(starts, ends, loci, chrom_offsets):
    """(chrom index, start bp, end bp) of each block, as wgbs_tools' bed
    writes them (add_loci.cpp): the first site's locus, and the last
    site's locus + 1."""
    off = np.asarray(chrom_offsets, np.int64)
    chrom = np.searchsorted(off, starts - 1, side="right") - 1
    loci = np.asarray(loci, np.int64)
    return chrom, loci[starts - 1], loci[ends - 2] + 1
