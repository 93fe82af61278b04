"""bam2pat: BAM -> pat (+ beta) conversion pipeline.

The port's copy of wgbs_tools_tpu/pipeline/bam2pat_run.py, with the same
names, where `device` decides where reads call and mates merge: the
call_reads and merge_pe kernels (ops/calling.py) on cuda, numpy on the host
with device="cpu". Three rules keep calling on the host whatever the
device, each logged once a run: --device cpu, --mbias runs (MBiasCounter
counts every call as numpy makes it, as in the JAX package) and nanopore
reads (which JAX never sends to the device either).

Reference flow (ref: src/python/bam2pat.py:144-209,303-422): a Pool forks per
chromosome, each running `samtools view | match_maker | patter | sort | uniq`
and parts are concatenated. Here the BAM is decoded natively, reads are
called per chromosome with the exact patter rules (pipeline/calling.py),
fragments are sorted/collapsed as arrays, and the pileup runs on device.
"""

import os.path as op

import numpy as np

from ..device import resolve_device, timed
from ..formats.pat import empty_frags, write_pat
from ..genome.refdir import Genome
from ..utils import IllegalArgumentError, logger, pretty_name
from .bam import (
    BamReader,
    EXCLUDE_FLAGS,
    EXCLUDE_FLAGS_NANOPORE,
    FPAIRED,
    FUNMAP,
    MIN_MAPQ,
)
from .calling import MBiasCounter, ReadStats, call_records, rows_to_frags

STREAM_BYTES = 256 << 20  # BAMs this size or more stream by default


def detect_layout(bam_path):
    """(is_paired_end, is_nanopore) from the first primary record
    (ref: bam2pat.py:243-267, patter.cpp:324-350)."""
    reader = BamReader(bam_path)
    paired = False
    nanopore = "PL:ONT" in reader.header_text
    for rec in reader:
        if rec.flag & FUNMAP:
            continue
        paired = bool(rec.flag & FPAIRED)
        if rec.get_tag("MM") is not None or rec.get_tag("Mm") is not None:
            nanopore = True
        break
    reader.close()
    return paired, nanopore


def _ref_span(cigar):
    """Reference bases consumed by a CIGAR (M/D/N/=/X)."""
    return sum(n for op, n in cigar if op in "MDN=X")


def _load_region_bed(path):
    """{chrom: (starts, ends)} 0-based half-open intervals from a bed."""
    import gzip as _gzip

    from ..formats.bgzf import is_gzip

    opener = _gzip.open if is_gzip(path) else open
    per = {}
    with opener(path, "rb") as f:
        for line in f:
            t = line.rstrip(b"\n").split(b"\t")
            if len(t) < 3 or not t[1].isdigit():
                continue
            per.setdefault(t[0].decode(), []).append((int(t[1]), int(t[2])))
    out = {}
    for c, iv in per.items():
        iv.sort()
        out[c] = (np.array([a for a, _ in iv]), np.array([b for _, b in iv]))
    return out


def _overlaps_regions(regions, chrom, start0, end0):
    iv = regions.get(chrom)
    if iv is None:
        return False
    starts, ends = iv
    ends_max = np.maximum.accumulate(ends)
    i = np.searchsorted(ends_max, start0, side="right")
    return i < starts.shape[0] and starts[i] < end0


def _strand_flags(top_strand, bottom_strand, paired):
    """Exact-FLAG whitelists for --top_strand/--bottom_strand
    (ref: bam2pat.py:159-168 awk '$2 == ...' filters)."""
    if top_strand:
        return (99, 147) if paired else (0,)
    if bottom_strand:
        return (83, 163) if paired else (16,)
    return None


def _read_group_keep(buf, offs, rec_end, rows, read_group):
    """Row mask of reads whose RG:Z tag equals read_group
    (ref: samtools view -r, bam2pat.py:171-172)."""
    from .bam import parse_tag

    keep = np.zeros(rows.shape[0], dtype=bool)
    for k, r in enumerate(rows):
        tags = bytes(buf[offs[r, 4] : rec_end[r]])
        keep[k] = parse_tag(tags, b"RG") == read_group
    return keep


def bam2pat(bam_path, genome=None, out_dir=".", region=None, min_mapq=MIN_MAPQ,
            exclude_flags=None, clip=0, min_cpg=1, mbias_prefix=None,
            include_chroms=None, force=True, write_output=True,
            with_qname=False, nanopore=None, np_thresh=0.667, cpc_call="C",
            combine_mods=False, whitelist=None, blacklist=None,
            blueprint=False, threads=1, include_flags=None, top_strand=False,
            bottom_strand=False, read_group=None, stream=None,
            slab_bytes=None, device="cuda", timings=None, byte_range=None):
    """Convert a BAM to a sorted/collapsed PatFrags batch (and pat.gz file).

    Returns (frags, out_path or None, stats). `stream=True` (or BAMs larger
    of STREAM_BYTES, 256 MB, or more with stream=None) takes the
    bounded-memory slab-streaming path (pipeline/bam_stream.py) — host RSS
    stays O(slab) instead of O(BAM); the returned frags are then empty
    (the pat.gz on disk is the output). `slab_bytes` sets its slab size
    (default bam_stream.DEFAULT_SLAB). The reference bounds memory with
    per-chromosome `samtools view` pipes (ref: bam2pat.py:144-209).
    Reads call and mates merge on `device` ('cuda' raises without CUDA;
    'cpu' is numpy on the host), except in --mbias runs and for nanopore
    reads, which call on the host. With `timings`, the seconds of "scan",
    "decode", "call", "merge" and "write" accumulate there (summed over
    the chromosome threads). `byte_range`, a BAI virtual-offset pair
    (v_start, v_end or None), decodes only that slice of the BAM (plus its
    header) on the whole-file route: the part of one `--procs` worker.
    """
    g = genome if genome is not None else Genome(None)
    idx = g.index
    call_device = calling_device(resolve_device(device), mbias_prefix)

    if byte_range is not None:
        stream = False  # ranged decode is an in-memory columnar feature
    if stream is None and not blueprint and not with_qname and write_output:
        try:
            stream = op.getsize(bam_path) >= STREAM_BYTES
        except OSError:
            stream = False
    if stream and write_output and not blueprint and not with_qname:
        from .bam_stream import (DEFAULT_SLAB, StreamUnsupported,
                                 bam2pat_streaming)

        wl = bl = None
        if whitelist:
            wl_path = g.whitelist if whitelist is True else whitelist
            wl = _load_region_bed(wl_path) if wl_path else None
        elif blacklist:
            bl_path = g.blacklist if blacklist is True else blacklist
            bl = _load_region_bed(bl_path) if bl_path else None
        out_path = op.join(out_dir, pretty_name(bam_path) + ".pat.gz")
        try:
            return bam2pat_streaming(
                bam_path, g, idx, out_path, min_mapq, exclude_flags,
                clip=clip, min_cpg=min_cpg, include_chroms=include_chroms,
                nanopore=nanopore, np_thresh=np_thresh, cpc_call=cpc_call,
                combine_mods=combine_mods, include_flags=include_flags,
                top_strand=top_strand, bottom_strand=bottom_strand,
                read_group=read_group, wl=wl, bl=bl,
                mbias_prefix=mbias_prefix,
                slab_bytes=slab_bytes or DEFAULT_SLAB, device=call_device,
                timings=timings)
        except StreamUnsupported as e:
            logger.info("bam2pat: streaming path unavailable (%s); using "
                        "the in-memory path", e)

    # columnar fast path: no per-record python objects (native scan +
    # vectorized decode); falls back for nanopore / blueprint runs
    columnar = None
    if not blueprint:
        from .bam_columnar import scan_bam_columnar

        with timed(timings, "scan", None):
            columnar = scan_bam_columnar(bam_path, byte_range=byte_range)
    if columnar is not None:
        from .bam import parse_tag
        from .bam_columnar import process_chrom_columnar

        buf, header_text, ref_names, ref_lengths, cols, offs, rec_end = \
            columnar
        mapped = (cols[:, 2] & FUNMAP == 0) & (cols[:, 0] >= 0)
        first = np.nonzero(mapped)[0]
        paired = bool(cols[first[0], 2] & FPAIRED) if first.size else False
        detected_np = "PL:ONT" in header_text
        if first.size and not detected_np:
            r = first[0]
            tags = bytes(buf[offs[r, 4] : rec_end[r]])
            detected_np = (parse_tag(tags, b"MM") is not None
                           or parse_tag(tags, b"Mm") is not None)
        if nanopore is None:
            nanopore = detected_np
        if not nanopore:
            wl = bl = None
            if whitelist:
                wl_path = g.whitelist if whitelist is True else whitelist
                wl = _load_region_bed(wl_path) if wl_path else None
            elif blacklist:
                bl_path = g.blacklist if blacklist is True else blacklist
                bl = _load_region_bed(bl_path) if bl_path else None
            return _bam2pat_columnar(
                bam_path, g, idx, out_dir, buf, ref_names, cols, offs,
                paired, min_mapq,
                exclude_flags if exclude_flags is not None else EXCLUDE_FLAGS,
                clip, min_cpg, include_chroms, write_output, with_qname,
                threads,
                include_flags=include_flags,
                strand_flags=_strand_flags(top_strand, bottom_strand, paired),
                read_group=read_group, rec_end=rec_end,
                wl=wl, bl=bl, mbias_prefix=mbias_prefix, device=call_device,
                timings=timings)
        # nanopore columnar path: requires every record's aux region to
        # native-parse (one cheap pass); otherwise the record path below
        # reports unparseable reads invalid, like the reference patter
        if paired:
            raise IllegalArgumentError(
                "Unrecognized bam format: paired end and nanopore")
        from .bam_columnar_ont import scan_mmml

        if scan_mmml(buf, offs, rec_end) is not None:
            wl = bl = None
            if whitelist:
                wl_path = g.whitelist if whitelist is True else whitelist
                wl = _load_region_bed(wl_path) if wl_path else None
            elif blacklist:
                bl_path = g.blacklist if blacklist is True else blacklist
                bl = _load_region_bed(bl_path) if bl_path else None
            return _bam2pat_columnar(
                bam_path, g, idx, out_dir, buf, ref_names, cols, offs,
                False, min_mapq,
                exclude_flags if exclude_flags is not None
                else EXCLUDE_FLAGS_NANOPORE,
                clip, min_cpg, include_chroms, write_output, with_qname,
                threads,
                include_flags=include_flags,
                strand_flags=_strand_flags(top_strand, bottom_strand, False),
                read_group=read_group, rec_end=rec_end,
                wl=wl, bl=bl, mbias_prefix=mbias_prefix,
                ont=dict(np_thresh=np_thresh, cpc_call=cpc_call,
                         combine_mods=combine_mods), timings=timings)
        # fall through to the record path below

    paired, detected_np = detect_layout(bam_path)
    if nanopore is None:
        nanopore = detected_np
    if nanopore and paired:
        raise IllegalArgumentError(
            "Unrecognized bam format: paired end and nanopore")
    if nanopore:
        paired = False
        _log_nanopore(call_device)
    if exclude_flags is None:
        exclude_flags = EXCLUDE_FLAGS_NANOPORE if nanopore else EXCLUDE_FLAGS

    # region allow/deny lists (ref: bam2pat.py:173-179, genome defaults
    # bam2pat.py:288-295)
    wl = bl = None
    if whitelist:
        wl_path = g.whitelist if whitelist is True else whitelist
        wl = _load_region_bed(wl_path) if wl_path else None
    elif blacklist:
        bl_path = g.blacklist if blacklist is True else blacklist
        bl = _load_region_bed(bl_path) if bl_path else None

    required = include_flags if include_flags is not None else (
        3 if paired else 0)
    strand_ok = _strand_flags(top_strand, bottom_strand, paired)
    reader = BamReader(bam_path)
    ref_names = reader.ref_names
    per_chrom = {c: [] for c in idx.chrom_names}
    for rec in reader:
        if rec.flag & FUNMAP or rec.ref_id < 0:
            continue
        if rec.mapq < min_mapq or (rec.flag & exclude_flags):
            continue
        if required and (rec.flag & required) != required:
            continue
        if strand_ok is not None and rec.flag not in strand_ok:
            continue
        if read_group is not None and rec.get_tag("RG") != read_group:
            continue
        chrom = ref_names[rec.ref_id]
        if chrom not in per_chrom:
            continue
        if wl is not None or bl is not None:
            end0 = rec.pos + _ref_span(rec.cigar)
            if wl is not None and not _overlaps_regions(wl, chrom, rec.pos,
                                                        end0):
                continue
            if bl is not None and _overlaps_regions(bl, chrom, rec.pos, end0):
                continue
        per_chrom[chrom].append(rec)
    reader.close()

    ref_seqs = None
    if blueprint:
        from ..genome.cpg_index import read_fasta

        fa = g.join("genome.fa")
        if fa is None:
            raise IllegalArgumentError(
                "--blueprint requires genome.fa in the reference dir")
        ref_seqs = read_fasta(fa)

    stats = ReadStats()
    mbias = MBiasCounter() if mbias_prefix else None
    parts = []
    chroms = include_chroms or idx.chrom_names
    for chrom in chroms:
        records = per_chrom.get(chrom, [])
        if not records:
            continue
        records.sort(key=lambda r: r.pos)
        site_base, _ = idx.chrom_site_bounds(chrom)
        loci = idx.chrom_loci(chrom)
        if ref_seqs is not None:
            from .calling import clean_cigar, is_bottom, \
                passes_bisulfite_conversion

            ref = ref_seqs.get(chrom)
            kept = []
            for rec in records:
                seq_adj = clean_cigar(rec.seq, rec.cigar)
                sl = ref[rec.pos : rec.pos + len(seq_adj)].tobytes()
                if passes_bisulfite_conversion(
                    seq_adj, sl, is_bottom(rec.flag, paired)
                ):
                    kept.append(rec)
                else:
                    stats.nr_bad_conv += 1
            records = kept
        before = stats.snapshot()
        starts, patterns, qnames = call_records(
            records, loci, site_base, chrom, paired, clip=clip,
            min_cpg=min_cpg, stats=stats, mbias=mbias, with_qname=with_qname,
            nanopore=nanopore, np_thresh=np_thresh, cpc_call=cpc_call,
            combine_mods=combine_mods, device=call_device,
        )
        frags = rows_to_frags(starts, patterns, chrom, qnames)
        if frags.nr_frags:
            parts.append(frags.sort().collapse())
        logger.info("bam2pat: %s", stats.summary(chrom, since=before))

    if parts:
        from ..cli.cmd_pat import _concat_frags

        frags = _concat_frags(parts)
    else:
        frags = empty_frags()

    out_path = None
    if write_output:
        out_path = op.join(out_dir, pretty_name(bam_path) + ".pat.gz")
        with timed(timings, "write", None):
            write_pat(frags, out_path)
        logger.info("bam2pat: wrote %s (%d fragments)", out_path,
                    frags.nr_frags)
    if mbias_prefix and mbias is not None:
        mbias.dump(mbias_prefix)
    return frags, out_path, stats


# state shared by the chromosome worker threads: the decompressed BAM buffer
# and columnar arrays (the analogue of each reference patter process
# re-reading its own slice; here every worker reads the same arrays)
_SHARED = {}


def calling_device(dev, mbias_prefix):
    """The torch device reads call and mates merge on, or None for numpy
    on the host: None with a CPU device and in --mbias runs (each logged
    at info level)."""
    if dev.type == "cpu":
        logger.info("bam2pat: calling and merging run with numpy on the "
                    "host (device cpu)")
        return None
    if mbias_prefix:
        logger.info("bam2pat: --mbias: calling and merging run with numpy "
                    "on the host, where the m-bias tables count each call")
        return None
    return dev


def _log_nanopore(call_device):
    if call_device is not None:
        logger.info("bam2pat: nanopore reads call with numpy on the host")


def _columnar_chrom_worker(args):
    """Per-chromosome worker (GIL-releasing vectorized numpy, and the
    calling kernels on `device`)."""
    (rows, loci, site_base, chrom, paired, clip, min_cpg, with_qname,
     want_mbias, ont, device, timings) = args

    buf = _SHARED["buf"]
    bufarr = _SHARED["bufarr"]
    cols = _SHARED["cols"]
    offs = _SHARED["offs"]
    stats = ReadStats()
    mbias = MBiasCounter() if want_mbias else None
    if ont is not None:
        from .bam_columnar_ont import process_chrom_columnar_ont

        frags = process_chrom_columnar_ont(
            buf, bufarr, cols, offs, _SHARED["rec_end"], rows, loci,
            site_base, chrom, clip, min_cpg, stats, with_qname, **ont)
    else:
        from .bam_columnar import process_chrom_columnar

        frags = process_chrom_columnar(
            buf, bufarr, cols, offs, rows, loci, site_base, chrom, paired,
            clip, min_cpg, stats, with_qname, mbias=mbias, device=device,
            timings=timings)
    if frags.nr_frags:
        frags = frags.sort().collapse()
    return chrom, frags, stats, None if mbias is None else mbias.tables


def _ref_spans_columnar(bufarr, cols, offs, rows):
    """Reference-consumed span per read (vectorized CIGAR word scan)."""
    n_cigar = cols[rows, 5].astype(np.int64)
    spans = cols[rows, 4].astype(np.int64)  # unmapped/cigar-less: l_seq
    total = int(n_cigar.sum())
    if total == 0:
        return spans
    rid = np.repeat(np.arange(rows.shape[0]), n_cigar)
    within = (np.arange(total)
              - np.repeat(np.cumsum(n_cigar) - n_cigar, n_cigar))
    addr = np.repeat(offs[rows, 1], n_cigar) + 4 * within
    words = (bufarr[addr].astype(np.uint32)
             | (bufarr[addr + 1].astype(np.uint32) << 8)
             | (bufarr[addr + 2].astype(np.uint32) << 16)
             | (bufarr[addr + 3].astype(np.uint32) << 24))
    op = words & 0xF
    ln = (words >> 4).astype(np.int64)
    # ref-consuming ops: M,D,N,=,X (CIGAR_OPS indices 0,2,3,7,8)
    consume = (op == 0) | (op == 2) | (op == 3) | (op == 7) | (op == 8)
    out = np.zeros(rows.shape[0], dtype=np.int64)
    np.add.at(out, rid, ln * consume)
    has = n_cigar > 0
    spans[has] = out[has]
    return spans


def _overlaps_vec(regions, chrom, start0, end0):
    """Vectorized _overlaps_regions over read arrays for one chromosome."""
    iv = regions.get(chrom)
    if iv is None:
        return np.zeros(start0.shape[0], dtype=bool)
    starts, ends = iv
    ends_max = np.maximum.accumulate(ends)
    i = np.searchsorted(ends_max, start0, side="right")
    ok = i < starts.shape[0]
    res = np.zeros(start0.shape[0], dtype=bool)
    res[ok] = starts[i[ok]] < end0[ok]
    return res


def _bam2pat_columnar(bam_path, g, idx, out_dir, buf, ref_names, cols, offs,
                      paired, min_mapq, exclude_flags, clip, min_cpg,
                      include_chroms, write_output, with_qname, threads=1,
                      include_flags=None, strand_flags=None, read_group=None,
                      rec_end=None, wl=None, bl=None, mbias_prefix=None,
                      ont=None, device=None, timings=None):
    if ont is not None:
        _log_nanopore(device)
        device = None
    bufarr = np.frombuffer(buf, dtype=np.uint8)
    flag = cols[:, 2]
    keep = ((flag & FUNMAP) == 0) & (cols[:, 0] >= 0) \
        & (cols[:, 3] >= min_mapq) & ((flag & exclude_flags) == 0)
    # required-bits filter (samtools view -f; PE default 3 — bam2pat.py:154-157)
    required = include_flags if include_flags is not None else (
        3 if paired else 0)
    if required:
        keep &= (flag & required) == required
    if strand_flags is not None:
        keep &= np.isin(flag, strand_flags)
    if read_group is not None:
        rows = np.nonzero(keep)[0]
        sub = _read_group_keep(buf, offs, rec_end, rows, read_group)
        keep[rows[~sub]] = False
    ref_id = cols[:, 0]
    stats = ReadStats()
    parts = []
    chroms = include_chroms or idx.chrom_names
    name_to_rid = {n: i for i, n in enumerate(ref_names)}
    jobs = []
    want_mbias = mbias_prefix is not None
    for chrom in chroms:
        rid = name_to_rid.get(chrom)
        if rid is None:
            continue
        rows = np.nonzero(keep & (ref_id == rid))[0]
        if rows.size and (wl is not None or bl is not None):
            # vectorized region allow/deny (ref: bam2pat.py:173-179)
            start0 = cols[rows, 1].astype(np.int64)
            end0 = start0 + _ref_spans_columnar(bufarr, cols, offs, rows)
            if wl is not None:
                rows = rows[_overlaps_vec(wl, chrom, start0, end0)]
            else:
                rows = rows[~_overlaps_vec(bl, chrom, start0, end0)]
        if rows.size == 0:
            continue
        site_base, _ = idx.chrom_site_bounds(chrom)
        loci = idx.chrom_loci(chrom)
        jobs.append((rows, loci, site_base, chrom, paired, clip, min_cpg,
                     with_qname, want_mbias, ont, device, timings))

    _SHARED.update(buf=buf, bufarr=bufarr, cols=cols, offs=offs,
                   rec_end=rec_end)
    try:
        if threads > 1 and len(jobs) > 1:
            # threads, not fork: the workers are numpy-vectorized and wait
            # on the card without the GIL, and threads share the
            # decompressed BAM buffer; each launch takes its tensors'
            # device and that device's current stream
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(threads, len(jobs))) as pool:
                results = list(pool.map(_columnar_chrom_worker, jobs))
        else:
            results = [_columnar_chrom_worker(j) for j in jobs]
    finally:
        _SHARED.clear()

    mbias = MBiasCounter() if want_mbias else None
    for chrom, frags, cstats, mb_tables in results:
        for k in cstats.__dict__:
            stats.__dict__[k] += cstats.__dict__[k]
        if mbias is not None and mb_tables is not None:
            for key in mbias.tables:
                mbias.tables[key] += mb_tables[key]
        if frags.nr_frags:
            parts.append(frags)
        logger.info("bam2pat: %s", cstats.summary(chrom))
    if mbias is not None:
        mbias.dump(mbias_prefix)

    if parts:
        from ..cli.cmd_pat import _concat_frags

        frags = _concat_frags(parts)
    else:
        frags = empty_frags()
    out_path = None
    if write_output:
        out_path = op.join(out_dir, pretty_name(bam_path) + ".pat.gz")
        with timed(timings, "write", None):
            write_pat(frags, out_path)
        logger.info("bam2pat: wrote %s (%d fragments)", out_path,
                    frags.nr_frags)
    return frags, out_path, stats
