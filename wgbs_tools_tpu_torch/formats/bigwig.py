"""Minimal native BigWig writer/reader.

The reference shells out to UCSC `bedGraphToBigWig` (ref: src/python/
beta2bw.py:56-148); that tool isn't a dependency here, so beta2bw writes the
BigWig container directly (kent bbiFile layout, version 4): header, total
summary, chromosome B+ tree, zlib-compressed bedGraph-type data sections, one
zoom level, and an R-tree index (two levels when needed).

The reader implements just enough to round-trip values for tests. The
port's copy of wgbs_tools_tpu/formats/bigwig.py: the same bytes.
"""

import struct
import zlib

import numpy as np

BIGWIG_MAGIC = 0x888FFC26
CHROM_TREE_MAGIC = 0x78CA8C91
RTREE_MAGIC = 0x2468ACE0
ITEMS_PER_SLOT = 1024
BLOCK_SIZE = 256


def write_bigwig(path, chrom_sizes, data):
    """chrom_sizes: [(name, size)]; data: {name: (starts, ends, values)}
    with 0-based half-open intervals, sorted, non-overlapping."""
    chrom_ids = {name: i for i, (name, _) in enumerate(chrom_sizes)}

    # ---- data sections
    sections = []  # (chrom_id, start, end, compressed payload)
    max_uncomp = 0
    valid = 0
    minv, maxv = np.inf, -np.inf
    sumd = sumsq = 0.0
    for name, _size in chrom_sizes:
        if name not in data:
            continue
        starts, ends, vals = (np.asarray(x) for x in data[name])
        if starts.size == 0:
            continue
        cid = chrom_ids[name]
        valid += int((ends - starts).sum())
        minv = min(minv, float(vals.min()))
        maxv = max(maxv, float(vals.max()))
        lens = (ends - starts).astype(np.float64)
        sumd += float((vals * lens).sum())
        sumsq += float((vals * vals * lens).sum())
        for lo in range(0, starts.size, ITEMS_PER_SLOT):
            hi = min(lo + ITEMS_PER_SLOT, starts.size)
            n = hi - lo
            hdr = struct.pack("<IIIIIBBH", cid, int(starts[lo]),
                              int(ends[hi - 1]), 0, 0, 1, 0, n)
            items = np.empty(n, dtype=[("s", "<u4"), ("e", "<u4"),
                                       ("v", "<f4")])
            items["s"] = starts[lo:hi]
            items["e"] = ends[lo:hi]
            items["v"] = vals[lo:hi]
            payload = hdr + items.tobytes()
            max_uncomp = max(max_uncomp, len(payload))
            sections.append((cid, int(starts[lo]), int(ends[hi - 1]),
                             zlib.compress(payload)))
    if not np.isfinite(minv):
        minv = maxv = 0.0

    # ---- zoom level (single, coarse): per chrom fixed bins
    zoom_reduction = 10240
    zsections = []
    for name, _size in chrom_sizes:
        if name not in data:
            continue
        starts, ends, vals = (np.asarray(x) for x in data[name])
        if starts.size == 0:
            continue
        cid = chrom_ids[name]
        bins = {}
        for s, e, v in zip(starts.tolist(), ends.tolist(), vals.tolist()):
            b = s // zoom_reduction
            st = bins.setdefault(b, [0, np.inf, -np.inf, 0.0, 0.0])
            n = e - s
            st[0] += n
            st[1] = min(st[1], v)
            st[2] = max(st[2], v)
            st[3] += v * n
            st[4] += v * v * n
        recs = []
        for b in sorted(bins):
            st = bins[b]
            recs.append(struct.pack(
                "<IIIIffff", cid, b * zoom_reduction,
                min((b + 1) * zoom_reduction, _size), st[0], st[1], st[2],
                st[3], st[4]))
        for lo in range(0, len(recs), ITEMS_PER_SLOT):
            chunk = recs[lo : lo + ITEMS_PER_SLOT]
            payload = b"".join(chunk)
            max_uncomp = max(max_uncomp, len(payload))
            first = struct.unpack("<III", chunk[0][:12])
            last = struct.unpack("<III", chunk[-1][:12])
            zsections.append((cid, first[1], last[2], zlib.compress(payload)))

    # ---- assemble file
    out = bytearray()
    out += b"\x00" * 64  # header placeholder
    zoom_hdr_off = len(out)
    out += b"\x00" * 24  # one zoom header placeholder

    total_summary_off = len(out)
    out += struct.pack("<Qdddd", valid, minv, maxv, sumd, sumsq)

    chrom_tree_off = len(out)
    out += _chrom_btree(chrom_sizes, chrom_ids)

    full_data_off = len(out)
    out += struct.pack("<Q", len(sections))
    sec_offsets = []
    for cid, s, e, payload in sections:
        sec_offsets.append((cid, s, e, len(out), len(payload)))
        out += payload

    full_index_off = len(out)
    out += _rtree(sec_offsets, full_index_off)

    zoom_data_off = len(out)
    out += struct.pack("<I", len(zsections))
    zsec_offsets = []
    for cid, s, e, payload in zsections:
        zsec_offsets.append((cid, s, e, len(out), len(payload)))
        out += payload
    zoom_index_off = len(out)
    out += _rtree(zsec_offsets, zoom_index_off)

    struct.pack_into("<IHHQQQHHQQIQ", out, 0,
                     BIGWIG_MAGIC, 4, 1, chrom_tree_off, full_data_off,
                     full_index_off, 0, 0, 0, total_summary_off,
                     max(max_uncomp, 1), 0)
    struct.pack_into("<IIQQ", out, zoom_hdr_off, zoom_reduction, 0,
                     zoom_data_off, zoom_index_off)

    with open(path, "wb") as f:
        f.write(out)
    return path


def _chrom_btree(chrom_sizes, chrom_ids):
    key_size = max(len(n) for n, _ in chrom_sizes)
    out = struct.pack("<IIIIQQ", CHROM_TREE_MAGIC, BLOCK_SIZE, key_size, 8,
                      len(chrom_sizes), 0)
    out += struct.pack("<BBH", 1, 0, len(chrom_sizes))  # leaf node
    for name, size in sorted(chrom_sizes, key=lambda x: x[0]):
        key = name.encode().ljust(key_size, b"\x00")
        out += key + struct.pack("<II", chrom_ids[name], size)
    return out


def _rtree(sec_offsets, index_start):
    """R-tree over data sections; one leaf level (+ root internal node when
    more than BLOCK_SIZE leaves are needed)."""
    n = len(sec_offsets)
    if n == 0:
        hdr = struct.pack("<IIQIIIIQIi", RTREE_MAGIC, BLOCK_SIZE, 0, 0, 0, 0,
                          0, 0, ITEMS_PER_SLOT, 0)
        node = struct.pack("<BBH", 1, 0, 0)
        return hdr + node
    s_cid, s_base = sec_offsets[0][0], sec_offsets[0][1]
    e_cid, e_base = sec_offsets[-1][0], sec_offsets[-1][2]
    end_file = sec_offsets[-1][3] + sec_offsets[-1][4]

    hdr = struct.pack("<IIQIIIIQIi", RTREE_MAGIC, BLOCK_SIZE, n, s_cid,
                      s_base, e_cid, e_base, end_file, ITEMS_PER_SLOT, 0)

    leaves = [sec_offsets[i : i + BLOCK_SIZE]
              for i in range(0, n, BLOCK_SIZE)]
    if len(leaves) == 1:
        node = struct.pack("<BBH", 1, 0, n)
        for cid, s, e, off, size in sec_offsets:
            node += struct.pack("<IIIIQQ", cid, s, cid, e, off, size)
        return hdr + node

    # two levels: root internal node + leaf nodes
    root_size = 4 + 24 * len(leaves)
    leaf_sizes = [4 + 32 * len(l) for l in leaves]
    base = index_start + len(hdr) + root_size
    leaf_offsets = []
    pos = base
    for ls in leaf_sizes:
        leaf_offsets.append(pos)
        pos += ls
    root = struct.pack("<BBH", 0, 0, len(leaves))
    for leaf, off in zip(leaves, leaf_offsets):
        root += struct.pack("<IIIIQ", leaf[0][0], leaf[0][1], leaf[-1][0],
                            leaf[-1][2], off)
    body = root
    for leaf in leaves:
        node = struct.pack("<BBH", 1, 0, len(leaf))
        for cid, s, e, off, size in leaf:
            node += struct.pack("<IIIIQQ", cid, s, cid, e, off, size)
        body += node
    return hdr + body


# ---------------------------------------------------------------------------
# Reader (round-trip validation)
# ---------------------------------------------------------------------------


def read_bigwig(path):
    """Parse a bigWig written by write_bigwig (or compatible). Returns
    ({name: (starts, ends, values)}, summary dict)."""
    with open(path, "rb") as f:
        buf = f.read()
    (magic, version, zooms, chrom_off, data_off, index_off, _fc, _dfc,
     _sql, summary_off, uncomp, _r) = struct.unpack_from("<IHHQQQHHQQIQ",
                                                         buf, 0)
    assert magic == BIGWIG_MAGIC, "not a bigWig file"
    valid, minv, maxv, sumd, sumsq = struct.unpack_from("<Qdddd", buf,
                                                        summary_off)
    # chrom tree (single leaf assumed)
    t_magic, bsz, key_size, val_size, n_chroms, _ = struct.unpack_from(
        "<IIIIQQ", buf, chrom_off)
    assert t_magic == CHROM_TREE_MAGIC
    pos = chrom_off + 32
    is_leaf, _, count = struct.unpack_from("<BBH", buf, pos)
    pos += 4
    names = {}
    for _ in range(count):
        key = buf[pos : pos + key_size].rstrip(b"\x00").decode()
        cid, size = struct.unpack_from("<II", buf, pos + key_size)
        names[cid] = key
        pos += key_size + 8
    # data sections
    (n_sections,) = struct.unpack_from("<Q", buf, data_off)
    pos = data_off + 8
    out = {}
    for _ in range(n_sections):
        dco = zlib.decompressobj()
        payload = dco.decompress(buf[pos:])
        consumed = len(buf) - pos - len(dco.unused_data)
        pos += consumed
        cid, start, end, step, span, typ, _rsv, cnt = struct.unpack_from(
            "<IIIIIBBH", payload, 0)
        items = np.frombuffer(payload, dtype=[("s", "<u4"), ("e", "<u4"),
                                              ("v", "<f4")], offset=24,
                              count=cnt)
        name = names[cid]
        cur = out.setdefault(name, ([], [], []))
        cur[0].append(items["s"])
        cur[1].append(items["e"])
        cur[2].append(items["v"])
    final = {
        k: tuple(np.concatenate(v) for v in vals) for k, vals in out.items()
    }
    summary = dict(valid=valid, min=minv, max=maxv, sum=sumd, sumsq=sumsq)
    return final, summary
