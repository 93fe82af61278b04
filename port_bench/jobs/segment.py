"""Jobs of `segment`: K beta files of the whole genome to a blocks bed,
through the port's CLI entry cli/cmd_segment.py::main in this process,
in the traffic's mode on the run's device.

Set-up draws the genome, K tissues' methylation and their betas from the
seed (port_bench/gen.py) and writes the CpG index and the betas under the
run's directory; the warm-up segments one chromosome
(`warmup_region`). Each job writes its own bed. The check segments the
same betas with the configuration's reference and holds every job's bed
to it: its blocks must tile each chromosome, its loci must be those of its
sites, and the share of borders that differ from the reference's must
stay within the traffic's limit.
"""

import hashlib
import os.path as op
import sys
import time

import numpy as np

from port_bench import gen, work

SPANS = [
    ("wgbs_tools_tpu_torch.models.segment", "segment_chunks",
     "segment.chunks"),
    ("wgbs_tools_tpu_torch.models.segment", "_load_windows",
     "segment.beta_load"),
    ("wgbs_tools_tpu_torch.models.segment", "finalize_segmentation",
     "segment.stitch"),
    ("wgbs_tools_tpu_torch.models.segment", "_cost_fast", "segment.fast_cost"),
    ("wgbs_tools_tpu_torch.models.segment", "_dp_fast_blocked",
     "segment.fast_dp"),
    ("wgbs_tools_tpu_torch.models.segment_exact_device", "plan_windows",
     "segment.exact_plan"),
    ("wgbs_tools_tpu_torch.models.segment_exact_device", "segment_exact_dp",
     "segment.exact_dp"),
    ("wgbs_tools_tpu_torch.cli.cmd_segment", "sites_blocks",
     "segment.bed_loci"),
]
EXACT_KERNELS = r"segment_exact_dp"


class State:
    pass


def log(msg):
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def setup(cell, seed, dev, work_dir):
    cfg = cell.config
    st = State()
    st.cell, st.dev, st.work = cell, dev, work_dir
    genome = gen.make_genome(cfg["genome"], seed, dev)
    levels = gen.block_levels(genome, cfg["methylation"], seed, dev,
                              n_tissues=cfg["n_betas"])
    betas = gen.make_betas(genome, levels, cfg, seed, dev)
    st.data = betas.cpu().numpy()
    st.loci = genome.loci.cpu().numpy()
    st.offsets = genome.offsets
    st.names = genome.names
    gen.write_cpg_index(op.join(work_dir, "refs"), cfg["genome"]["name"],
                        genome)
    st.betas = []
    for k, name in enumerate(cfg["tissues"][: cfg["n_betas"]]):
        path = op.join(work_dir, f"{name}.beta")
        st.data[k].tofile(path)
        st.betas.append(path)
    del genome, levels, betas

    from wgbs_tools_tpu_torch.cli.cmd_segment import main

    st.entry = main
    st.outputs = []
    return st


def _argv(st, out, region=None):
    cfg, traffic = st.cell.config, st.cell.traffic
    argv = ["--betas", *st.betas, "-o", out, "--mode", traffic["mode"],
            "--device", str(st.dev), "-c", str(cfg["chunk_size"]),
            "--max_cpg", str(cfg["max_cpg"]), "--max_bp", str(cfg["max_bp"]),
            "-p", str(cfg["pcount"]), "--min_cpg", str(cfg["min_cpg"])]
    return argv + (["-r", region] if region else [])


def warmup(st):
    st.entry(_argv(st, op.join(st.work, "warm.bed"),
                   st.cell.traffic["warmup_region"]))


def run(st, i, timings):
    out = op.join(st.work, f"job{i}.bed")
    st.entry(_argv(st, out), timings=timings)
    st.outputs.append(out)
    return {"segment_sites_per_s": int(st.offsets[-1])}



def chunk_windows(st):
    cs = st.cell.config["chunk_size"]
    out = []
    for a, b in zip(st.offsets[:-1], st.offsets[1:]):
        if b > a:
            bords = list(range(int(a) + 1, int(b) + 1, cs)) + [int(b) + 1]
            out += list(zip(bords[:-1], bords[1:]))
    return out


def work_counts(st):
    """Per-job (bytes, flops) of the exact DP over the chunks."""
    cfg = st.cell.config
    cells = work.band_cells(st.loci, st.offsets, chunk_windows(st),
                            min(cfg["max_cpg"], cfg["max_bp"] // 2),
                            cfg["max_bp"], device=st.dev)
    return work.exact_dp_work(cells, int(st.offsets[-1]), cfg["n_betas"])


def parse_bed(path, names):
    """(chrom index, start, end, startCpG, endCpG) int64 columns of a
    5-column bed, parsed in numpy: the name column cut out, the rest read
    as whitespace-separated integers."""
    buf = np.fromfile(path, np.uint8)
    if buf.size == 0:
        return [np.zeros(0, np.int64)] * 5
    nl = np.flatnonzero(buf == 10)
    tabs = np.flatnonzero(buf == 9)
    if tabs.size != 4 * nl.size:
        raise ValueError(f"{path}: not a 5-column bed")
    first = np.concatenate([[0], nl[:-1] + 1])
    tab0 = tabs[::4]
    width = int((tab0 - first).max())
    idx = first[:, None] + np.arange(width)[None, :]
    inside = idx < tab0[:, None]
    raw = np.where(inside, buf[np.minimum(idx, buf.size - 1)], 0)
    digits = buf.copy()
    digits[idx[inside]] = ord(" ")
    nums = np.fromstring(digits.tobytes(), dtype=np.int64, sep=" ")
    if nums.size != 4 * nl.size:
        raise ValueError(f"{path}: a column is not an integer")
    nums = nums.reshape(-1, 4)
    # the chromosome: its name's first 8 bytes as one integer key
    raw = raw[:, :8]
    key = (raw.astype(np.uint64) << (8 * np.arange(raw.shape[1],
                                                   dtype=np.uint64))
           ).sum(axis=1, dtype=np.uint64)
    key[tab0 - first > 8] = 0
    table = {int.from_bytes(n.encode(), "little"): i
             for i, n in enumerate(names) if len(n.encode()) <= 8}
    u, inv = np.unique(key, return_inverse=True)
    lut = np.array([table.get(int(k), -1) for k in u], np.int64)
    return [lut[inv.reshape(-1)]] + [nums[:, j] for j in range(4)]


def _digest(path):
    h = hashlib.blake2b()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def compare(bed, starts, ends, loci, offsets):
    """(tiling errors, bed locus errors, share of borders that differ) of a
    parsed bed against the reference's blocks."""
    chrom, bs, be, s, e = bed
    tiling = 0
    # the blocks must tile each chromosome's sites, in order
    n_chroms = len(offsets) - 1
    for c in range(n_chroms):
        a, b = int(offsets[c]) + 1, int(offsets[c + 1]) + 1
        if b <= a:
            continue
        sel = (s >= a) & (s < b)
        cs, ce = s[sel], e[sel]
        if cs.size == 0:
            tiling += 1
            continue
        tiling += int(cs[0] != a) + int(ce[-1] != b) + int(
            (cs[1:] != ce[:-1]).sum()) + int((ce <= cs).sum())
    tiling += int((chrom < 0).sum()) + int(((s < 1) | (e > offsets[-1] + 1)
                                            ).sum())
    ok = (s >= 1) & (e >= s + 1) & (e <= offsets[-1] + 1) & (chrom >= 0)
    want_c = np.searchsorted(offsets, s[ok] - 1, side="right") - 1
    lo = np.asarray(loci, np.int64)
    locus = int((chrom[ok] != want_c).sum() + (bs[ok] != lo[s[ok] - 1]).sum()
                + (be[ok] != lo[e[ok] - 2] + 1).sum()) + int((~ok).sum())
    diff = np.setxor1d(s, starts).size
    return tiling, locus, diff / max(starts.size, 1)


def check(st, n_jobs, control=False):
    """Every job's bed against the reference segmentation (float64). With
    `control`, the reference in the precision below the mode's (exact:
    float32; fast: bfloat16) stands in the program's place."""
    cfg = st.cell.config
    params = {k: cfg[k] for k in ("chunk_size", "max_bp", "pcount",
                                  "min_cpg")}
    params["max_cpg"] = min(cfg["max_cpg"], cfg["max_bp"] // 2)
    ref = st.cell.reference
    t = time.perf_counter()
    starts, ends = ref.segment(st.data, st.loci, st.offsets, params,
                               device=st.dev)
    log(f"reference: {starts.size} blocks in {time.perf_counter() - t:.3f} s")
    if control:
        prec = {"exact": "float32", "fast": "bfloat16"}[
            st.cell.traffic["mode"]]
        cs, ce = ref.segment(st.data, st.loci, st.offsets, params,
                             precision=prec, device=st.dev)
        chrom, bs, be = ref.bed_columns(cs, ce, st.loci, st.offsets)
        beds = [[chrom, bs, be, cs, ce]]
    else:
        seen, beds = {}, []
        for path in st.outputs:
            d = _digest(path)
            if d not in seen:
                seen[d] = parse_bed(path, st.names)
            beds.append(seen[d])
    lim = st.cell.traffic["limits"]
    worst = {"border_diff_share": 0.0, "tiling_errors": 0,
             "bed_locus_errors": 0}
    bad = 0
    for bed in beds:
        t, l, share = compare(bed, starts, ends, st.loci, st.offsets)
        got = {"border_diff_share": share, "tiling_errors": t,
               "bed_locus_errors": l}
        bad += any(got[k] > lim[k] for k in got if lim[k] is not None)
        worst = {k: max(worst[k], got[k]) for k in worst}
    checks = {k: {"value": worst[k], "limit": lim[k]} for k in
              ("tiling_errors", "bed_locus_errors", "border_diff_share")}
    return checks, bad
