"""Blocks files (wgbstools bed: chr, start, end, startCpG, endCpG).

ref: docs/bed_format.md, src/python/beta_to_blocks.py:23-91. The port's
copy of wgbs_tools_tpu/formats/blocks.py's `load_blocks`, `index_bed`,
`is_block_file_nice`, `write_blocks` and `sites_blocks`, with the same
names. `index_bed`
compresses through the port's host library (native.py), which raises
when it cannot be built: there is no Python compressor to fall back to.
"""

import gzip
import os

import numpy as np

from ..native import bed_scan_native, bgzf_compress_native
from ..utils import IllegalArgumentError
from .bgzf import BgzfWriter, decompress_file, is_gzip
from .csi import write_tbi
from .pat import _bgzf_block_table

BLOCK_COLS = ("chr", "start", "end", "startCpG", "endCpG")


def load_blocks(path, nrows=None):
    """Load a blocks bed into a dict of numpy columns.

    Accepts optional header, comments, gz compression. Returns
    {chr: object[n], start,end,startCpG,endCpG: int64[n]}; NA CpG columns
    become -1.

    One pass over the file by the host library (native.bed_scan_native),
    by the rules of JAX's line loop: lines split on "\n"; an empty line
    or one that starts with "#" is skipped; one of fewer than 5
    tab-separated columns raises; one whose second column is not all
    digits (a header) is skipped; at most `nrows` rows (at least one). A
    row with a column the scan leaves (a sign, an underscore, more than 18
    digits) or a name that is not UTF-8 is converted by the loop's own
    code, in file order, so it gives the loop's value or its error.
    """
    opener = gzip.open if is_gzip(path) else open
    with opener(path, "rb") as f:
        buf = np.frombuffer(f.read(), dtype=np.uint8)
    vals, name, line, flags, short_at = bed_scan_native(
        buf, None if nrows is None else max(int(nrows), 1))
    # one str a run of rows with the same name
    heads = np.flatnonzero(flags & 2)
    names = []
    for i in heads.tolist():
        try:
            names.append(buf[name[i, 0]:name[i, 1]].tobytes().decode())
        except UnicodeDecodeError:
            names.append(None)
    chroms = np.empty(len(names), dtype=object)
    chroms[:] = names
    chroms = chroms[np.cumsum(flags & 2 > 0) - 1]
    odd = np.flatnonzero((flags & 1) | np.equal(chroms, None))
    cols = [vals[:, k] for k in range(4)]
    if odd.size:  # the loop's own conversions, in file order
        cols = [c.astype(object) for c in cols]
        for i in odd.tolist():
            tokens = buf[line[i, 0]:line[i, 1]].tobytes().split(b"\t")
            chroms[i] = tokens[0].decode()
            cols[0][i] = int(tokens[1])
            cols[1][i] = int(tokens[2])
            cols[2][i] = _int_or_na(tokens[3])
            cols[3][i] = _int_or_na(tokens[4])
    if short_at >= 0:
        raise IllegalArgumentError(
            f"Invalid blocks file: {path}. less than 5 columns. "
            "Run convert -L to add the CpG columns"
        )
    return {
        "chr": chroms,
        "start": np.array(cols[0], dtype=np.int64),
        "end": np.array(cols[1], dtype=np.int64),
        "startCpG": np.array(cols[2], dtype=np.int64),
        "endCpG": np.array(cols[3], dtype=np.int64),
    }


def _int_or_na(tok):
    t = tok.strip()
    if t in (b"NA", b"NaN", b"nan", b""):
        return -1
    return int(t)


def index_bed(path, level=6):
    """bgzip (when needed) + native .tbi index for a wgbstools bed.

    Mirrors the reference Indxer's bed branch (ref: src/python/index.py:
    20-29,96-139): plain or gzip input is sort-checked on the startCpG
    column (`sort -k4,4n`), sorted if needed, BGZF-compressed, and indexed;
    an already-BGZF input is indexed in place. Returns the final .gz path.
    """
    with open(path, "rb") as f:
        head = f.read(18)
    is_bgzf = len(head) >= 18 and head[:4] == b"\x1f\x8b\x08\x04"
    if is_bgzf:
        comp = open(path, "rb").read()
        text = decompress_file(path)
        out_path = path
    else:
        opener = gzip.open if is_gzip(path) else open
        with opener(path, "rb") as f:
            text = f.read()
        lines = text.splitlines(keepends=True)
        meta = [l for l in lines if l.startswith(b"#")]
        rows = [l for l in lines if l and not l.startswith(b"#")]
        keys = []
        for l in rows:
            t = l.split(b"\t")
            k = t[3].strip() if len(t) > 3 else b""
            keys.append(int(k) if k.isdigit() else -1)
        keys = np.asarray(keys, dtype=np.int64)
        if (np.diff(keys) < 0).any():
            # not sorted by startCpG: sort stably (ref sort -k4,4n)
            order = np.argsort(keys, kind="stable")
            rows = [rows[i] for i in order]
        text = b"".join(meta + rows)
        comp = bgzf_compress_native(text, level=level)
        out_path = path if path.endswith(".gz") else path + ".gz"
        with open(out_path, "wb") as f:
            f.write(comp)
        if out_path != path:
            os.remove(path)

    # per-line voffsets from the block table
    nl = np.frombuffer(text, dtype=np.uint8) == ord("\n")
    line_starts = np.concatenate([[0], np.nonzero(nl)[0] + 1])
    if line_starts.shape[0] and line_starts[-1] >= len(text):
        line_starts = line_starts[:-1]
    offs_all = np.concatenate([line_starts, [len(text)]])
    coffs, uoffs = _bgzf_block_table(comp)
    blk = np.searchsorted(uoffs, offs_all, side="right") - 1
    voffs_all = (coffs[blk] << 16) | (offs_all - uoffs[blk])

    chrom_names, lookup = [], {}
    cids, begs, ends, keep = [], [], [], []
    for i, lo in enumerate(line_starts):
        hi = offs_all[i + 1]
        line = text[lo:hi]
        if not line or line.startswith(b"#"):
            continue
        t = line.split(b"\t")
        if len(t) < 3 or not t[1].strip().isdigit():
            continue
        c = t[0].decode()
        if c not in lookup:
            lookup[c] = len(chrom_names)
            chrom_names.append(c)
        cids.append(lookup[c])
        begs.append(int(t[1]))
        ends.append(int(t[2]))
        keep.append(i)
    keep = np.asarray(keep, dtype=np.int64)
    write_tbi(out_path + ".tbi", chrom_names,
              np.asarray(cids), np.asarray(begs, dtype=np.int64),
              np.asarray(ends, dtype=np.int64),
              voffs_all[keep], voffs_all[keep + 1])
    return out_path


def is_block_file_nice(blocks):
    """Sorted / non-empty / non-overlapping validation
    (exact rule set of ref: beta_to_blocks.py:23-47)."""
    s, e = blocks["startCpG"], blocks["endCpG"]
    if (s < 0).any() or (e < 0).any():
        return False, "Some blocks are empty (NA)"
    if not (e - s > 0).all():
        return False, "Some blocks are empty (startCpG==endCpG)"
    if not (np.diff(s) >= 0).all():
        return False, "startCpG is not monotonically increasing"
    if not (np.diff(e) >= 0).all():
        return False, "endCpG is not monotonically increasing"
    stacked = np.stack([s, e])
    if np.unique(stacked, axis=1).shape[1] != s.shape[0]:
        return False, "Some blocks are duplicated"
    if s.shape[0] > 1 and not (s[1:] - e[:-1] >= 0).all():
        return False, "Some blocks overlap"
    return True, ""


def write_blocks(blocks, path):
    rows = []
    for i in range(blocks["startCpG"].shape[0]):
        rows.append(
            f"{blocks['chr'][i]}\t{blocks['start'][i]}\t{blocks['end'][i]}"
            f"\t{blocks['startCpG'][i]}\t{blocks['endCpG'][i]}\n"
        )
    data = "".join(rows).encode()
    if path.endswith(".gz"):
        with BgzfWriter(path) as w:
            w.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)
    return path


def sites_blocks(index, sites_list):
    """Build a blocks dict from a list of (startCpG, endCpG) using a CpGIndex
    for the locus columns (replaces add_loci, ref: src/cpg2bed/add_loci.cpp)."""
    sites_arr = np.asarray(sites_list, dtype=np.int64).reshape(-1, 2)
    s, e = sites_arr[:, 0], sites_arr[:, 1]
    cids = index.site2chrom_id(s)
    chroms = np.array([index.chrom_names[c] for c in cids], dtype=object)
    # exact add_loci convention (ref: src/cpg2bed/add_loci.cpp:51-52):
    # start = locus of first site; end = locus of last site + 1 (or start+2
    # for empty blocks)
    start_loc = index.loci[s - 1].astype(np.int64)
    end_loc = np.where(e == s, start_loc + 2, index.loci[np.maximum(e - 2, 0)] + 1)
    return {
        "chr": chroms,
        "start": start_loc.astype(np.int64),
        "end": end_loc.astype(np.int64),
        "startCpG": s,
        "endCpG": e,
    }
