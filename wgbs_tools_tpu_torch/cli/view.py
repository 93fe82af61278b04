"""view / cview: render pat and beta files as text, filtered by region/blocks.

Mirrors the reference's view/cview composition (ref: src/python/view.py,
cview.py): pat goes through region/blocks filtering + optional subsample +
sort + collapse; beta prints `chr  loc-1  loc+1  meth  cov` rows
(ref: src/view_beta.sh).

The port's copy of wgbs_tools_tpu/cli/view.py (`view_pat`,
`view_beta_text`, `print_frags`) and of cli/cmd_vis.py's
`_shuffle_within_start`. Host code: numpy, no pandas (JAX's
view_beta_text formats its rows through pandas' csv writer; here the
same bytes come from a string join a chunk).
"""

import sys

import numpy as np

from ..formats.beta import load_beta
from ..formats.blocks import load_blocks
from ..formats.pat import PatFrags, frags_to_bytes, read_pat
from ..genome.region import GenomicRegion
from ..ops.frag_ops import filter_by_blocks, sample_frags
from ..utils import IllegalArgumentError


def view_pat(pat_path, genome, region=None, sites=None, bed_file=None,
             strict=False, strip=False, min_len=1, no_gaps=False,
             sub_sample=None, seed=None, no_sort=False) -> PatFrags:
    """Load + filter a pat file, returning sorted/collapsed fragments."""
    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    if bed_file is not None:
        blocks = load_blocks(bed_file)
        bstart, bend = blocks["startCpG"], blocks["endCpG"]
        keep = bstart >= 0
        bstart, bend = bstart[keep], bend[keep]
        order = np.argsort(bstart, kind="stable")
        bstart, bend = bstart[order], bend[order]
        if len(bstart):
            # bound the read to the blocks' site envelope (index-seekable,
            # overlap-inclusive) instead of materializing the whole pat —
            # the reference likewise tabixes only extended block regions
            # (ref: src/python/cview.py:82-101). Whole-genome bed files
            # still stream through iter_view_pat in the CLI paths.
            lo = int(bstart[0])
            hi = int(bend.max())
            frags = read_pat(pat_path, region_sites=(lo, hi))
        else:
            frags = read_pat(pat_path, region_sites=(1, 1))
    elif gr.is_whole():
        frags = read_pat(pat_path)
        bstart = np.array([1])
        bend = np.array([genome.get_nr_sites() + 1])
    else:
        s, e = gr.sites
        frags = read_pat(pat_path, region_sites=(s, e))
        bstart, bend = np.array([s]), np.array([e])

    frags = filter_by_blocks(frags, bstart, bend, strict=strict, strip=strip,
                             min_cpgs=min_len, no_gaps=no_gaps)
    if sub_sample is not None:
        if sub_sample < 0:
            raise IllegalArgumentError("sub-sampling rate must be >= 0")
        # rate > 0.25 handled by doubling reps (ref: cview.py:55-67); rates
        # above 1 (coverage-boosting mixes) duplicate reads the same way
        # (ref: mix_pat.py:108-111)
        ss, rep = sub_sample, 1
        while ss > 0.25:
            rep *= 2
            ss /= 2
        frags = sample_frags(frags, ss, reps=rep, seed=seed)
    if not no_sort:
        frags = frags.sort().collapse()
    return frags


def view_beta_text(beta_path, genome, region=None, sites=None, bed_file=None,
                   out=None):
    """beta -> text rows `chr  loc-1  loc+1  meth  cov`, optionally
    restricted to bed regions (replaces the reference's
    `| bedtools intersect` post-filter, ref: view.py:47-50)."""
    out = out or sys.stdout
    gr = GenomicRegion(region=region, sites=sites, genome=genome)
    idx = genome.index
    if gr.is_whole():
        s, e = 1, idx.nr_sites + 1
    else:
        s, e = gr.sites
    data = load_beta(beta_path, sites=(s, e))
    loci = idx.loci[s - 1 : e - 1]
    cids = idx.site2chrom_id(np.arange(s, e))
    names = idx.chrom_names
    keep = None
    if bed_file is not None:
        blocks = load_blocks(bed_file)
        valid = blocks["startCpG"] >= 0
        bstart = blocks["startCpG"][valid]
        bend = blocks["endCpG"][valid]
        order = np.argsort(bstart, kind="stable")
        bstart, bend = bstart[order], bend[order]
        site_ids = np.arange(s, e)
        j = np.searchsorted(bstart, site_ids, side="right") - 1
        jc = np.clip(j, 0, max(len(bstart) - 1, 0))
        be_max = np.maximum.accumulate(bend) if len(bend) else bend
        keep = (j >= 0) & (len(bend) > 0) & (site_ids < be_max[jc])
    # chunked row formatting (bounded memory on a whole-genome view): the
    # chromosome names by a gather, the numbers as ints, one join a chunk
    names_arr = np.array(names, dtype=object)
    n_rows = e - s
    step = 1 << 20
    for lo in range(0, n_rows, step):
        hi = min(lo + step, n_rows)
        sel = slice(lo, hi)
        if keep is not None:
            m = keep[sel]
            if not m.any():
                continue
            loc = loci[sel][m].astype(np.int64)
            cid = cids[sel][m]
            d = data[sel][m]
        else:
            loc = loci[sel].astype(np.int64)
            cid = cids[sel]
            d = data[sel]
        out.write("".join(
            f"{c}\t{a}\t{b}\t{x}\t{y}\n" for c, a, b, x, y in zip(
                names_arr[cid].tolist(), (loc - 1).tolist(),
                (loc + 1).tolist(), d[:, 0].tolist(), d[:, 1].tolist())))


def print_frags(frags, out=None):
    out = out or sys.stdout
    data = frags_to_bytes(frags)
    if hasattr(out, "buffer"):
        out.buffer.write(data)
    elif isinstance(out, str):
        mode = "wb"
        if out.endswith(".gz"):
            from ..formats.bgzf import BgzfWriter

            with BgzfWriter(out) as w:
                w.write(data)
            return
        with open(out, mode) as f:
            f.write(data)
    else:
        try:
            out.write(data)
        except TypeError:  # text-mode stream (e.g. StringIO)
            out.write(data.decode())


def _shuffle_within_start(frags, seed=None):
    """Random order of patterns sharing a start site
    (ref: cview.py:43-46: `sort -k2,2n -k3,3R` when --shuffle)."""
    rng = np.random.default_rng(seed)
    key = rng.random(frags.nr_frags)
    order = np.lexsort((key, np.asarray(frags.start)))
    return frags.take(order)
