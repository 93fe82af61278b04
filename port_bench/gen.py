"""The one generator of the benchmark's inputs: a CpG index, methylation
levels, pat fragments and beta tables, all drawn from a seed by the numbers
of a configuration file (`configs/<name>.json`) and a traffic file
(`workloads/<traffic>.json`).

Every draw runs in torch on the device it is given, in a few large calls,
with a `torch.Generator` seeded from (seed, purpose): the same seed and
device give the same inputs. The cell's card makes them in a run; the
tests make small ones on the CPU.

The pat writer is chip_smoke.py's BGZF writer (`_bgzf_block`, vectorised
text), with a ragged pattern column so that a line holds as many calls as
its fragment covers.
"""

import hashlib
import os
import os.path as op
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

CODE_T, CODE_C, CODE_DOT = 0, 1, 3
PAT_CHARS = b"TCH."
BGZF_EOF = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000"
                         "000000")
BGZF_TEXT = 65280  # text bytes per BGZF block, as bgzip cuts them
BGZF_LEVEL = 6     # bgzip's default zlib level


def subseed(seed, purpose):
    """A 63-bit seed for one purpose of one run's seed."""
    digest = hashlib.blake2b(f"{int(seed)}:{purpose}".encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def generator(seed, purpose, device):
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, purpose))
    return g


# ---------------------------------------------------------------------------
# the CpG index
# ---------------------------------------------------------------------------


@dataclass
class GenomeSim:
    names: list          # chromosome names
    sizes: np.ndarray    # int64 bp a chromosome
    offsets: np.ndarray  # int64 (n_chroms + 1,) first site of each, 0-based
    loci: torch.Tensor   # int64 (n_sites,) bp within the chromosome
    gpos: torch.Tensor   # int64 (n_sites,) bp on the concatenated genome
    island: torch.Tensor  # bool (n_sites,)

    @property
    def n_sites(self):
        return int(self.offsets[-1])


def sites_per_chrom(n_sites, sizes):
    """Sites of each chromosome in proportion to its size; the rest of the
    rounding goes to the largest ones."""
    sizes = np.asarray(sizes, np.int64)
    counts = n_sites * sizes // sizes.sum()
    order = np.argsort(-sizes, kind="stable")
    counts[order[: n_sites - counts.sum()]] += 1
    return counts


def make_genome(spec, seed, device):
    """The CpG index of `spec` (a configuration's "genome" group): n_sites
    sites over the chromosomes [name, size] in proportion to size; about
    island_share of the sites in islands of island_sites [lo, hi] sites at
    island_gap_bp mean gaps; the rest at the gap that spans fill of each
    chromosome. A gap is 2 + floor(Exp(mean - 1.5)) bp, so two CpGs never
    overlap."""
    dev = torch.device(device)
    g = generator(seed, "genome", dev)
    names = [c[0] for c in spec["chroms"]]
    sizes = np.array([c[1] for c in spec["chroms"]], np.int64)
    n = int(spec["n_sites"])
    counts = sites_per_chrom(n, sizes)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)

    lo, hi = spec["island_sites"]
    share = float(spec["island_share"])
    n_isl = int(round(share * n / ((lo + hi) / 2)))
    starts = torch.randint(0, n, (n_isl,), generator=g, device=dev)
    lens = torch.randint(lo, hi + 1, (n_isl,), generator=g, device=dev)
    edge = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    edge.index_add_(0, starts, torch.ones_like(starts, dtype=torch.int32))
    edge.index_add_(0, (starts + lens).clamp(max=n),
                    -torch.ones_like(starts, dtype=torch.int32))
    island = edge.cumsum(0)[:n] > 0

    chrom = torch.repeat_interleave(
        torch.arange(len(names), device=dev),
        torch.from_numpy(counts).to(dev))
    isl_gap = float(spec["island_gap_bp"])
    real_share = float(island.float().mean())
    mean_gap = (float(spec["fill"]) * torch.from_numpy(sizes).to(dev)
                / torch.from_numpy(np.maximum(counts, 1)).to(dev))
    bg_gap = ((mean_gap - real_share * isl_gap) / (1 - real_share))[chrom]
    scale = torch.where(island, torch.full_like(bg_gap, isl_gap), bg_gap)
    gaps = 2 + torch.floor(torch.empty(n, dtype=torch.float64, device=dev)
                           .exponential_(generator=g) * (scale - 1.5))
    cum = gaps.to(torch.int64).cumsum(0)
    first = torch.from_numpy(offsets[:-1]).to(dev)[chrom]
    start_bp = int(spec["first_locus_bp"])
    loci = start_bp + cum - cum[first]
    last = np.array([int(loci[b - 1]) if b > a else 0 for a, b in
                     zip(offsets[:-1], offsets[1:])], np.int64)
    sizes = np.maximum(sizes, last + 2)
    chrom_start = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                                   [:-1]).to(dev)
    return GenomeSim(names, sizes, offsets, loci, chrom_start[chrom] + loci,
                     island)


def write_cpg_index(refs, name, genome):
    """The reference dir refs/name (cpg_index.npz + cpg_index.json, the
    layout the port's genome/cpg_index.py loads) set as the default
    genome (chip_smoke.py::write_cpg_index)."""
    import json

    gdir = op.join(refs, name)
    os.makedirs(gdir, exist_ok=True)
    np.savez(op.join(gdir, "cpg_index.npz"),
             loci=genome.loci.cpu().numpy().astype(np.int32),
             chrom_offsets=genome.offsets, chrom_sizes=genome.sizes)
    with open(op.join(gdir, "cpg_index.json"), "w") as f:
        json.dump({"name": name, "chroms": genome.names,
                   "nr_sites": genome.n_sites}, f)
    link = op.join(refs, "default")
    if op.lexists(link):
        os.unlink(link)
    os.symlink(name, link)
    return gdir


# ---------------------------------------------------------------------------
# methylation
# ---------------------------------------------------------------------------


def block_levels(genome, spec, seed, device, n_tissues=1):
    """(n_tissues, n_sites) float32 methylation levels, constant over blocks
    of block_sites_mean sites on average: island sites at
    U(island_level), the others at N(background_mean, background_sd)
    clipped to [0, 1]. A block is differential with probability
    differential_share: each tissue then draws its own U(0, 1) level
    there."""
    dev = torch.device(device)
    g = generator(seed, "levels", dev)
    n = genome.n_sites
    brk = torch.rand(n, generator=g, device=dev) < 1.0 / spec[
        "block_sites_mean"]
    brk[0] = True
    block = brk.to(torch.int64).cumsum(0) - 1
    nb = int(block[-1]) + 1
    ilo, ihi = spec["island_level"]
    isl = ilo + (ihi - ilo) * torch.rand(nb, generator=g, device=dev)
    bg = (spec["background_mean"] + spec["background_sd"]
          * torch.randn(nb, generator=g, device=dev)).clamp(0, 1)
    base = torch.where(genome.island, isl[block], bg[block])
    levels = base.expand(n_tissues, n).clone()
    if n_tissues > 1:
        diff = (torch.rand(nb, generator=g, device=dev)
                < spec["differential_share"])[block]
        own = torch.rand((n_tissues, nb), generator=g, device=dev)[:, block]
        levels = torch.where(diff, own, levels)
    return levels.float()


def saturate_uint8(meth, cov):
    """wgbs_tools' trim_to_uint8 (utils_wgbs.py): where cov > 255, meth
    becomes trunc(meth / cov * 255) and cov 255. int64 tensors in,
    uint8 (n, 2) out."""
    big = cov > 255
    m = torch.where(big, (meth.double() / cov.clamp(min=1).double()
                          * 255).to(torch.int64), meth)
    return torch.stack([m, cov.clamp(max=255)], dim=-1).to(torch.uint8)


def make_betas(genome, levels, spec, seed, device):
    """(K, n_sites, 2) uint8 beta tables: coverage Poisson(depth) a site,
    meth Binomial(cov, level), saturated as wgbs_tools saves them."""
    dev = torch.device(device)
    g = generator(seed, "betas", dev)
    rate = torch.full(levels.shape, float(spec["depth"]),
                      dtype=torch.float32, device=dev)
    cov = torch.poisson(rate, generator=g)
    meth = torch.binomial(cov, levels.float(), generator=g)
    return saturate_uint8(meth.to(torch.int64), cov.to(torch.int64))


# ---------------------------------------------------------------------------
# fragments
# ---------------------------------------------------------------------------


@dataclass
class Frags:
    """pat lines as flat arrays (host numpy): 1-based start site, length
    in sites, count, chromosome id, and the codes of all lines end to end
    (T=0, C=1, '.'=3)."""
    start: np.ndarray
    length: np.ndarray
    count: np.ndarray
    chrom: np.ndarray
    codes: np.ndarray

    @property
    def n(self):
        return int(self.start.shape[0])

    def offsets(self):
        return np.concatenate([[0], np.cumsum(self.length, dtype=np.int64)])


def _ragged(first, length):
    """Flat site index of every (fragment, position) and the fragment of
    each, for fragments [first, first + length)."""
    owner = torch.repeat_interleave(
        torch.arange(first.shape[0], device=first.device), length)
    off = torch.cumsum(length, 0) - length
    pos = torch.arange(owner.shape[0], device=first.device) - off[owner]
    return first[owner] + pos, owner, pos


def _calls(genome, level, site, owner, dot, g):
    """C with the site's level, else T; '.' with probability dot."""
    dev = site.device
    u = torch.rand(site.shape[0], generator=g, device=dev)
    codes = torch.where(u < level[site], CODE_C, CODE_T).to(torch.uint8)
    d = torch.rand(site.shape[0], generator=g, device=dev) < dot
    return codes.masked_fill_(d, CODE_DOT)


def _draw_pe(genome, level, traffic, n_raw, g):
    """Paired-end inserts: lengths log-normal around insert_median_bp,
    clipped to [insert_min_bp, insert_max_bp], starts uniform over the bp
    stretch that gives `depth` inserts over each base from the genome's
    start; each spans the CpGs of its insert within its chromosome, and
    the unread middle of an insert longer than two reads is '.'."""
    dev = genome.gpos.device
    ins = torch.exp(np.log(traffic["insert_median_bp"])
                    + traffic["insert_sigma"]
                    * torch.randn(n_raw, generator=g, device=dev))
    ins = ins.round().clamp(traffic["insert_min_bp"],
                            traffic["insert_max_bp"]).to(torch.int64)
    span = int(ins.sum()) // traffic["depth"]
    s_bp = torch.randint(0, span, (n_raw,), generator=g, device=dev)
    ends = torch.from_numpy(np.cumsum(genome.sizes)).to(dev)
    c = torch.searchsorted(ends, s_bp, right=True)
    e_bp = torch.minimum(s_bp + ins, ends[c])
    first = torch.searchsorted(genome.gpos, s_bp)
    length = torch.searchsorted(genome.gpos, e_bp) - first
    keep = length > 0
    first, length, s_bp, e_bp = first[keep], length[keep], s_bp[keep], \
        e_bp[keep]
    site, owner, _ = _ragged(first, length)
    codes = _calls(genome, level, site, owner, traffic["dot_share"], g)
    read = traffic["read_bp"]
    bp = genome.gpos[site]
    unread = (bp >= s_bp[owner] + read) & (bp < e_bp[owner] - read)
    codes.masked_fill_(unread, CODE_DOT)
    return first, length, codes


def _draw_long(genome, level, traffic, n_raw, g):
    """Long reads: spans of CpG sites log-normal around span_median_sites,
    clipped to [1, span_max_sites], starts uniform over the site stretch
    that gives `depth` reads over each site from site 1, cut at their
    chromosome's last site."""
    dev = genome.gpos.device
    span = torch.exp(np.log(traffic["span_median_sites"])
                     + traffic["span_sigma"]
                     * torch.randn(n_raw, generator=g, device=dev))
    span = span.round().clamp(1, traffic["span_max_sites"]).to(torch.int64)
    stretch = min(int(span.sum()) // traffic["depth"], genome.n_sites)
    first = torch.randint(0, stretch, (n_raw,), generator=g, device=dev)
    ends = torch.from_numpy(genome.offsets[1:]).to(dev)
    c = torch.searchsorted(ends, first, right=True)
    length = torch.minimum(first + span, ends[c]) - first
    site, owner, _ = _ragged(first, length)
    codes = _calls(genome, level, site, owner, traffic["dot_share"], g)
    return first, length, codes


DRAWS = {"paired_end": _draw_pe, "long": _draw_long}


def _trim(first, length, codes):
    """Cut the '.' calls off both ends of each line and drop lines with no
    call left: a pat line starts at its first called site."""
    dev = first.device
    _, owner, j = _ragged(first, length)
    called = codes != CODE_DOT
    big = torch.iinfo(torch.int64).max
    lo = torch.full_like(first, big).scatter_reduce(
        0, owner, torch.where(called, j, big), reduce="amin")
    hi = torch.full_like(first, -1).scatter_reduce(
        0, owner, torch.where(called, j, -1), reduce="amax")
    keep = hi >= 0
    src = (torch.cumsum(length, 0) - length + lo)[keep]
    new_len = (hi - lo + 1)[keep]
    pos, _, _ = _ragged(src, new_len)
    return first[keep] + lo[keep], new_len, codes[pos]


def _collapse(first, length, codes):
    """Sort by start site and merge identical lines (start, length and
    codes) into one line with their count, as wgbs_tools' bam2pat writes
    them. Returns (first, length, count, codes) in pat order."""
    dev = first.device
    n = first.shape[0]
    site_pos = _ragged(torch.zeros_like(first), length)[0]
    gh = torch.Generator(device=dev)
    gh.manual_seed(0x5eed)
    weights = torch.randint(-(1 << 62), 1 << 62, (int(length.max()) + 1,),
                            generator=gh, device=dev)
    prod = (codes.to(torch.int64) + 1) * weights[site_pos]
    cs = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                    prod.cumsum(0)])
    off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                     length.cumsum(0)])
    h = cs[off[1:]] - cs[off[:-1]]
    order = torch.argsort(h, stable=True)
    order = order[torch.argsort(length[order], stable=True)]
    order = order[torch.argsort(first[order], stable=True)]
    first, length, h = first[order], length[order], h[order]
    dup = torch.zeros(n, dtype=torch.bool, device=dev)
    dup[1:] = ((first[1:] == first[:-1]) & (length[1:] == length[:-1])
               & (h[1:] == h[:-1]))
    # rows in pat order; a duplicate whose codes differ (a hash collision)
    # is kept as a line of its own
    src_off = off[:-1][order]
    cand = torch.nonzero(dup).squeeze(1)
    if cand.numel():
        a_pos, a_own, a_j = _ragged(src_off[cand], length[cand])
        b_pos = src_off[cand - 1][a_own] + a_j
        diff = torch.zeros(cand.shape[0], dtype=torch.int32, device=dev)
        diff.index_add_(0, a_own, (codes[a_pos] != codes[b_pos]).to(
            torch.int32))
        dup[cand[diff > 0]] = False
    group = (~dup).to(torch.int64).cumsum(0) - 1
    ng = int(group[-1]) + 1
    count = torch.zeros(ng, dtype=torch.int64, device=dev)
    count.index_add_(0, group, torch.ones(n, dtype=torch.int64, device=dev))
    head = ~dup
    keep_src = src_off[head]
    keep_len = length[head]
    pos, _, _ = _ragged(keep_src, keep_len)
    return first[head], keep_len, count, codes[pos]


def make_frags(genome, level, traffic, seed, device):
    """The traffic's pat lines: `frags` lines, drawn by the traffic's
    `kind` (DRAWS), collapsed, in pat order. Host numpy (Frags)."""
    dev = torch.device(device)
    g = generator(seed, "frags", dev)
    want = int(traffic["frags"])
    n_raw = int(want * traffic["oversample"]) + 16
    draw = DRAWS[traffic["kind"]]
    while True:
        first, length, codes = _trim(*draw(genome, level, traffic, n_raw, g))
        first, length, count, codes = _collapse(first, length, codes)
        if first.shape[0] >= want:
            break
        n_raw = int(n_raw * 1.5)  # the next draw of this generator
    first, length, count = first[:want], length[:want], count[:want]
    codes = codes[: int(length.sum())]
    ends = torch.from_numpy(genome.offsets[1:]).to(dev)
    chrom = torch.searchsorted(ends, first, right=True)
    return Frags(start=(first + 1).cpu().numpy(),
                 length=length.cpu().numpy().astype(np.int64),
                 count=count.cpu().numpy().astype(np.int64),
                 chrom=chrom.cpu().numpy().astype(np.int64),
                 codes=codes.cpu().numpy())


# ---------------------------------------------------------------------------
# text and BGZF
# ---------------------------------------------------------------------------


def _digits(x, width):
    """(n, width) ASCII digits of x, right-aligned, and the mask of the
    significant ones."""
    x = x.to(torch.int64)
    pw = 10 ** torch.arange(width - 1, -1, -1, dtype=torch.int64,
                            device=x.device)
    digits = ((x[:, None] // pw) % 10 + ord("0")).to(torch.uint8)
    nd = 1 + (x[:, None] >= pw[None, :-1]).sum(dim=1)
    col = torch.arange(width, device=x.device)[None, :]
    keep = col >= (width - nd)[:, None]
    return digits, keep


def _const(s, n, dev):
    a = torch.tensor(list(s), dtype=torch.uint8, device=dev)
    return a.expand(n, a.numel()), torch.ones((n, a.numel()), dtype=torch.bool,
                                              device=dev)


def _names(names, idx):
    """(n, w) bytes of the names idx picks, left-aligned, with the mask."""
    dev = idx.device
    w = max(len(s) for s in names)
    tab = torch.zeros((len(names), w), dtype=torch.uint8)
    mask = torch.zeros((len(names), w), dtype=torch.bool)
    for i, s in enumerate(names):
        tab[i, : len(s)] = torch.tensor(list(s.encode()), dtype=torch.uint8)
        mask[i, : len(s)] = True
    return tab.to(dev)[idx], mask.to(dev)[idx]


def _fields(fields):
    buf = torch.cat([f[0] for f in fields], dim=1)
    keep = torch.cat([f[1] for f in fields], dim=1)
    return buf, keep


def pat_text(frags, names, lo, hi, device):
    """pat lines lo..hi-1 as bytes: chrom, start, pattern, count."""
    dev = torch.device(device)
    n = hi - lo
    off = frags.offsets()
    start = torch.from_numpy(frags.start[lo:hi]).to(dev)
    count = torch.from_numpy(frags.count[lo:hi]).to(dev)
    chrom = torch.from_numpy(frags.chrom[lo:hi]).to(dev)
    length = torch.from_numpy(frags.length[lo:hi]).to(dev)
    codes = torch.from_numpy(frags.codes[off[lo]:off[hi]]).to(dev)
    head, hkeep = _fields([_names(names, chrom), _const(b"\t", n, dev),
                           _digits(start, 10), _const(b"\t", n, dev)])
    tail, tkeep = _fields([_const(b"\t", n, dev), _digits(count, 10),
                           _const(b"\n", n, dev)])
    hl, tl = hkeep.sum(1), tkeep.sum(1)
    line = hl + length + tl
    base = torch.cumsum(line, 0) - line
    out = torch.empty(int(line.sum()), dtype=torch.uint8, device=dev)
    rank = hkeep.to(torch.int64).cumsum(1) - 1
    out[(base[:, None] + rank)[hkeep]] = head[hkeep]
    pos, owner, j = _ragged(base + hl, length)
    chars = torch.tensor(list(PAT_CHARS), dtype=torch.uint8, device=dev)
    out[pos] = chars[codes.to(torch.int64)]
    rank = tkeep.to(torch.int64).cumsum(1) - 1
    out[((base + hl + length)[:, None] + rank)[tkeep]] = tail[tkeep]
    return out.cpu().numpy().tobytes()


def bgzf_block(data, level=BGZF_LEVEL):
    """One BGZF block of `data` (chip_smoke.py::_bgzf_block)."""
    comp = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = comp.compress(data) + comp.flush()
    bsize = 18 + len(body) + 8
    if bsize > 65536:
        raise RuntimeError("BGZF block too large")
    head = (b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
            + struct.pack("<H", bsize - 1))
    return head + body + struct.pack("<II", zlib.crc32(data), len(data))


def write_pat_gz(path, frags, names, device, lines_per_slab=4_000_000,
                 threads=8):
    """The lines as a BGZF pat.gz; text made on `device` a slab of lines
    at a time, blocks compressed on `threads` host threads."""
    with open(path, "wb") as f, ThreadPoolExecutor(threads) as pool:
        for lo in range(0, frags.n, lines_per_slab):
            hi = min(frags.n, lo + lines_per_slab)
            text = pat_text(frags, names, lo, hi, device)
            blocks = [text[j : j + BGZF_TEXT]
                      for j in range(0, len(text), BGZF_TEXT)]
            for blk in pool.map(bgzf_block, blocks):
                f.write(blk)
        f.write(BGZF_EOF)
    return path
