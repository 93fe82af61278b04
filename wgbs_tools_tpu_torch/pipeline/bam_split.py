"""BAM annotation and splitting:

- add_cpg_counts: re-emit a BAM with per-read-pair YI:Z:<nrMeth>,<nrUnmeth>
  tags (and optionally the pat string as XP:Z:) —
  ref: src/pipeline_wgbs/add_cpg_counts.cpp.
- split_by_meth: filter YI-tagged reads into .M.bam / .U.bam by methylation
  proportion — ref: src/pipeline_wgbs/bam_split.sh, src/python/split_by_meth.py.
- split_by_allele: classify reads by the base at a SNP position with
  bisulfite-aware ambiguity rules — ref: src/pipeline_wgbs/snp_patter.cpp.

The port's copy of wgbs_tools_tpu/pipeline/bam_split.py, over the port's
BamReader / write_bam (pipeline/bam.py) and per-read calling
(pipeline/calling.py). It works record by record on the host, as JAX's
does.
"""

import os.path as op

from ..genome.refdir import Genome
from ..utils import IllegalArgumentError, logger
from .bam import (
    BamReader,
    EXCLUDE_FLAGS,
    FDUP,
    FPAIRED,
    FUNMAP,
    MIN_MAPQ,
    write_bam,
)
from .calling import call_read, clean_cigar, is_bottom, merge_pe


def _yi_tag(n_meth, n_unmeth, pattern=None):
    blob = b"YIZ" + f"{n_meth},{n_unmeth}".encode() + b"\x00"
    if pattern is not None:
        blob += b"XPZ" + pattern + b"\x00"
    return blob


def add_cpg_counts_bam(bam_in, bam_out, genome=None, min_mapq=MIN_MAPQ,
                       exclude_flags=EXCLUDE_FLAGS, clip=0, add_pat=False,
                       include_chroms=None, min_cpg=1, drop_singles=False,
                       regions=None, include_flags=None, top_strand=False,
                       bottom_strand=False, read_group=None):
    """Annotate each read (pair) with its methylation counts. Returns path.

    min_cpg: pairs with fewer known calls are dropped
    (ref: add_cpg_counts.cpp:399-402); drop_singles: keep only full pairs
    (ref: match_maker --drop_singles); regions: (chrom, start0, end0) list —
    only overlapping reads are kept (ref: add_cpg_counts.py --bed_file).
    """
    from .bam2pat_run import _overlaps_regions, _ref_span, _strand_flags

    g = genome if genome is not None else Genome(None)
    idx = g.index
    reader = BamReader(bam_in)
    ref_names = reader.ref_names
    ref_lengths = reader.ref_lengths
    header_text = reader.header_text
    per_chrom = {}
    for rec in reader:
        if rec.flag & FUNMAP or rec.ref_id < 0:
            continue
        if rec.mapq < min_mapq or (rec.flag & exclude_flags):
            continue
        if include_flags and (rec.flag & include_flags) != include_flags:
            continue
        if top_strand or bottom_strand:
            # exact-FLAG whitelist, per-record pairedness (ref: the awk
            # '$2 == ...' filters behind add_samtools_view_flags)
            if rec.flag not in _strand_flags(top_strand, bottom_strand,
                                             bool(rec.flag & FPAIRED)):
                continue
        if read_group is not None and rec.get_tag("RG") != read_group:
            continue
        chrom = ref_names[rec.ref_id]
        if chrom not in idx._chrom_lookup:
            continue
        if include_chroms and chrom not in include_chroms:
            continue
        if regions is not None and not _overlaps_regions(
                regions, chrom, rec.pos, rec.pos + _ref_span(rec.cigar)):
            continue
        per_chrom.setdefault(chrom, []).append(rec)
    reader.close()

    out_records = []
    for chrom in idx.chrom_names:
        records = per_chrom.get(chrom)
        if not records:
            continue
        records.sort(key=lambda r: r.pos)
        site_base, _ = idx.chrom_site_bounds(chrom)
        loci = idx.chrom_loci(chrom)
        paired = bool(records[0].flag & FPAIRED)

        def _call(rec):
            try:
                seq = clean_cigar(rec.seq, rec.cigar)
                # add_cpg_counts-flavored calling (no read-side CpG context
                # check, per-read chromosome-end guard — see call_read)
                return call_read(seq, rec.pos + 1, rec.flag, paired, loci,
                                 site_base, clip=clip, check_cpg=False,
                                 acc_end_guard=True)
            except Exception:
                return None

        def _annotate(recs, merged):
            if merged is None:
                nm = nu = 0
                pat = b""
            else:
                pat = merged[1]
                nm = pat.count(ord("C"))
                nu = pat.count(ord("T"))
            if nm + nu < min_cpg:  # ref: add_cpg_counts.cpp:399-402
                return
            tag = _yi_tag(nm, nu, pat if add_pat else None)
            for r in recs:
                r.tags = (r.tags or b"") + tag
                out_records.append(r)

        if paired:
            pending = {}
            for rec in records:
                if rec.qname in pending:
                    mate = pending.pop(rec.qname)
                    try:
                        merged = merge_pe(_call(mate), _call(rec))
                    except ValueError:
                        merged = None
                    _annotate([mate, rec], merged)
                else:
                    pending[rec.qname] = rec
            if not drop_singles:
                for rec in pending.values():
                    _annotate([rec], _call(rec))
        else:
            for rec in records:
                _annotate([rec], _call(rec))

    out_records.sort(key=lambda r: (r.ref_id, r.pos))
    write_bam(bam_out, ref_names, ref_lengths, out_records,
              header_text=header_text)
    logger.info("add_cpg_counts: wrote %s (%d reads)", bam_out,
                len(out_records))
    return bam_out


def _parse_yi(tags):
    from .bam import parse_tag

    val = parse_tag(tags or b"", b"YI")
    if val is None:
        return None
    try:
        m, u = val.split(",")
        return int(m), int(u)
    except Exception:
        return None


def split_bam_by_meth(bam_in, out_dir=".", homog_prop=0.75, min_cpg=1,
                      min_mapq=None, exclude_flags=None, include_chrom=None):
    """YI-tagged BAM -> .M.bam (meth_prop >= homog_prop) and .U.bam
    (meth_prop <= 1 - homog_prop). Returns (m_path, u_path)."""
    reader = BamReader(bam_in)
    base = op.basename(bam_in)[:-4]
    m_path = op.join(out_dir, base + ".M.bam")
    u_path = op.join(out_dir, base + ".U.bam")
    m_records, u_records = [], []
    found_yi = False
    for rec in reader:
        if min_mapq is not None and rec.mapq < min_mapq:
            continue
        if exclude_flags is not None and (rec.flag & exclude_flags):
            continue
        if include_chrom is not None and (
                rec.ref_id < 0
                or reader.ref_names[rec.ref_id] != include_chrom):
            continue
        yi = _parse_yi(rec.tags)
        if yi is None:
            continue
        found_yi = True
        m, u = yi
        total = m + u
        if total < min_cpg or total == 0:
            continue
        prop = m / total
        # exact bam_split.sh rule for each output (prop_to_use >= 0.5 selects
        # the >=-side comparison)
        if (homog_prop >= 0.5 and prop >= homog_prop) or (
            homog_prop < 0.5 and prop <= homog_prop
        ):
            m_records.append(rec)
        u_thresh = 1 - homog_prop
        if (u_thresh >= 0.5 and prop >= u_thresh) or (
            u_thresh < 0.5 and prop <= u_thresh
        ):
            u_records.append(rec)
    if not found_yi:
        raise IllegalArgumentError(
            "bam file must contain CpG counts info (YI:Z). "
            "Run add_cpg_counts first.")
    write_bam(m_path, reader.ref_names, reader.ref_lengths, m_records,
              header_text=reader.header_text)
    write_bam(u_path, reader.ref_names, reader.ref_lengths, u_records,
              header_text=reader.header_text)
    reader.close()
    logger.info("split_by_meth: %s (%d reads), %s (%d reads)", m_path,
                len(m_records), u_path, len(u_records))
    return m_path, u_path


def _snp_classify(rec, snp_pos, let1, let2, qual_filter, paired):
    """ref: snp_patter.cpp:16-59. Returns let1 / let2 / 'Z' (unknown)."""
    if rec.flag & FDUP:
        return "Z"
    seq = clean_cigar(rec.seq, rec.cigar).decode()
    qual = clean_cigar(rec.qual if rec.qual else b"\x00" * len(rec.seq),
                       rec.cigar)
    idx = snp_pos - (rec.pos + 1)
    if idx < 0 or idx >= len(seq):
        return "Z"
    if qual_filter > 0 and idx < len(qual) and qual[idx] < qual_filter:
        return "Z"
    bottom = is_bottom(rec.flag, paired)
    pair = {let1, let2}
    if pair == {"C", "T"} and not bottom:
        return "Z"
    if pair == {"G", "A"} and bottom:
        return "Z"

    def allowed(let, other):
        if let == "C" and other != "T" and not bottom:
            return {"C", "T"}
        if let == "G" and other != "A" and bottom:
            return {"G", "A"}
        return {let}

    snp_val = seq[idx]
    if snp_val in allowed(let1, let2):
        return let1
    if snp_val in allowed(let2, let1):
        return let2
    return "Z"


def split_bam_by_allele(bam_in, chrom, snp_pos, let1, let2, out_dir=".",
                        genome=None, min_mapq=MIN_MAPQ,
                        exclude_flags=EXCLUDE_FLAGS, qual_filter=0):
    """Split reads by allele at (chrom, snp_pos). Returns the two BAM paths."""
    reader = BamReader(bam_in)
    if chrom not in reader.ref_names:
        raise IllegalArgumentError(f"chromosome {chrom} not in bam")
    ref_id = reader.ref_names.index(chrom)
    records = []
    for rec in reader:
        if rec.ref_id != ref_id or rec.flag & FUNMAP:
            continue
        if rec.mapq < min_mapq or (rec.flag & exclude_flags):
            continue
        records.append(rec)
    records.sort(key=lambda r: r.pos)
    paired = bool(records[0].flag & FPAIRED) if records else False

    # pair-aware classification: mates share a verdict; conflicts are dropped
    out = {let1: [], let2: []}
    pending = {}

    def classify_emit(recs):
        verdicts = {
            _snp_classify(r, snp_pos, let1, let2, qual_filter, paired)
            for r in recs
        }
        verdicts.discard("Z")
        if len(verdicts) == 1:
            out[verdicts.pop()].extend(recs)

    if paired:
        for rec in records:
            if rec.qname in pending:
                classify_emit([pending.pop(rec.qname), rec])
            else:
                pending[rec.qname] = rec
        for rec in pending.values():
            classify_emit([rec])
    else:
        for rec in records:
            classify_emit([rec])

    base = op.basename(bam_in)[:-4]
    paths = []
    for let in (let1, let2):
        path = op.join(out_dir, f"{base}.{chrom}_{snp_pos}{let}.bam")
        write_bam(path, reader.ref_names, reader.ref_lengths, out[let],
                  header_text=reader.header_text)
        logger.info("split_by_allele: %s (%d reads)", path, len(out[let]))
        paths.append(path)
    reader.close()
    return paths
