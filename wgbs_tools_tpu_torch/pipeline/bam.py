"""BAM decoder/encoder: the port's copy of wgbs_tools_tpu/pipeline/bam.py
(the reader, the writer, the flags and `parse_tag`), with the same names.

The reference delegates BAM decoding to `samtools view` piping SAM text into
its C++ filters (ref: src/python/bam2pat.py:144-209). samtools is not a
dependency here: BAM is BGZF-compressed binary and this module decodes
records directly (header, flags, CIGAR, 4-bit packed sequence, and the aux
tags the pipeline reads: MM/ML for nanopore, RG for --read_group) through
the port's host library (native.py: the multithreaded BGZF inflater and the
columnar record scan), which raises when it cannot be built; there is no
Python record parser to fall back to.

A minimal encoder exists so tests can synthesize BAMs without samtools.
"""

import gzip
import struct

import numpy as np

from ..formats.bgzf import BgzfWriter
from ..native import bam_scan_native, bgzf_decompress_native
from ..utils import IllegalArgumentError

SEQ_CODES = "=ACMGRSVTWYHKDBN"
CIGAR_OPS = "MIDNSHP=X"

# sam FLAG bits
FPAIRED = 0x1
FUNMAP = 0x4
FREVERSE = 0x10
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

# default exclusion masks (ref: bam2pat.py:26-28)
EXCLUDE_FLAGS = 1796
EXCLUDE_FLAGS_NANOPORE = 3844
MIN_MAPQ = 10


class BamRecord:
    __slots__ = ("qname", "flag", "ref_id", "pos", "mapq", "cigar", "seq",
                 "qual", "tags", "next_ref_id", "next_pos")

    def __init__(self, qname, flag, ref_id, pos, mapq, cigar, seq, qual, tags):
        self.qname = qname
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos  # 0-based
        self.mapq = mapq
        self.cigar = cigar  # list[(op_char, length)]
        self.seq = seq  # bytes, ASCII
        self.qual = qual
        self.tags = tags  # raw bytes (lazily parsed)

    def get_tag(self, name):
        """Find an aux tag by 2-char name; returns decoded value or None."""
        return parse_tag(self.tags, name.encode())


def record_from_columnar(buf, cols, offs, rec_end, i):
    """Materialize one BamRecord from the columnar scan arrays (the
    single-row form of BamReader._iter_scanned) — used to route individual
    records to the scalar call path when the vectorized one rejects them."""
    (ref_id, rpos, flag, mapq, l_seq, n_cigar, first_cigar, l_qname) = cols[i]
    qo, co, so, uo, to = offs[i]
    qname = buf[qo : qo + l_qname - 1].decode()
    if n_cigar == 1:
        v = int(np.uint32(first_cigar))
        cigar = [(CIGAR_OPS[v & 0xF], v >> 4)]
    else:
        cigar = [(CIGAR_OPS[v & 0xF], v >> 4)
                 for v in struct.unpack_from(f"<{n_cigar}I", buf, co)]
    seq = _decode_seq(buf[so:uo], int(l_seq))
    return BamRecord(qname, int(flag), int(ref_id), int(rpos), int(mapq),
                     cigar, seq, buf[uo:to], buf[to : rec_end[i]])


def parse_tag(blob, name):
    i = 0
    n = len(blob)
    while i + 3 <= n:
        tag = blob[i : i + 2]
        typ = blob[i + 2 : i + 3]
        i += 3
        if typ == b"A":
            val, i = chr(blob[i]), i + 1
        elif typ == b"c":
            val, i = struct.unpack_from("<b", blob, i)[0], i + 1
        elif typ == b"C":
            val, i = blob[i], i + 1
        elif typ == b"s":
            val, i = struct.unpack_from("<h", blob, i)[0], i + 2
        elif typ == b"S":
            val, i = struct.unpack_from("<H", blob, i)[0], i + 2
        elif typ == b"i":
            val, i = struct.unpack_from("<i", blob, i)[0], i + 4
        elif typ == b"I":
            val, i = struct.unpack_from("<I", blob, i)[0], i + 4
        elif typ == b"f":
            val, i = struct.unpack_from("<f", blob, i)[0], i + 4
        elif typ in (b"Z", b"H"):
            end = blob.index(b"\x00", i)
            val, i = blob[i:end].decode(), end + 1
        elif typ == b"B":
            sub = blob[i : i + 1]
            cnt = struct.unpack_from("<I", blob, i + 1)[0]
            fmt = {b"c": "b", b"C": "B", b"s": "h", b"S": "H", b"i": "i",
                   b"I": "I", b"f": "f"}[sub]
            size = struct.calcsize(fmt)
            val = list(struct.unpack_from(f"<{cnt}{fmt}", blob, i + 5))
            i += 5 + cnt * size
        else:
            raise IllegalArgumentError(f"unknown BAM tag type {typ!r}")
        if tag == name:
            return val
    return None


class BamReader:
    def __init__(self, path):
        # decompress the whole file up front (the native multithreaded
        # BGZF inflater; a plain gzip member through zlib) and parse from
        # the in-memory buffer
        with open(path, "rb") as f:
            raw = f.read()
        if raw[:2] == b"\x1f\x8b":
            buf = bgzf_decompress_native(raw)
            if buf is None:
                buf = gzip.decompress(raw)
        else:
            buf = raw
        self._buf = buf
        if buf[:4] != b"BAM\x01":
            raise IllegalArgumentError(f"not a BAM file: {path}")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        self.header_text = buf[8 : 8 + l_text].decode(errors="replace")
        pos = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, pos)
        pos += 4
        self.ref_names = []
        self.ref_lengths = []
        for _ in range(n_ref):
            (l_name,) = struct.unpack_from("<i", buf, pos)
            pos += 4
            self.ref_names.append(buf[pos : pos + l_name - 1].decode())
            pos += l_name
            self.ref_lengths.append(struct.unpack_from("<i", buf, pos)[0])
            pos += 4
        self._records_off = pos

    def __iter__(self):
        # the columnar native scan, one C pass over the records
        scanned = bam_scan_native(self._buf, self._records_off)
        if scanned is None:
            raise IllegalArgumentError("the BAM records do not scan")
        yield from self._iter_scanned(*scanned)

    def _iter_scanned(self, cols, offs, rec_end):
        buf = self._buf
        ops = CIGAR_OPS
        unpack_from = struct.unpack_from
        for i in range(cols.shape[0]):
            (ref_id, rpos, flag, mapq, l_seq, n_cigar, first_cigar,
             l_qname) = cols[i]
            qo, co, so, uo, to = offs[i]
            qname = buf[qo : qo + l_qname - 1].decode()
            if n_cigar == 1:
                v = int(np.uint32(first_cigar))
                cigar = [(ops[v & 0xF], v >> 4)]
            else:
                cigar = [
                    (ops[v & 0xF], v >> 4)
                    for v in unpack_from(f"<{n_cigar}I", buf, co)
                ]
            seq = _decode_seq(buf[so:uo], int(l_seq))
            yield BamRecord(qname, int(flag), int(ref_id), int(rpos),
                            int(mapq), cigar, seq, buf[uo:to],
                            buf[to : rec_end[i]])

    def close(self):
        self._buf = b""


_SEQ_LUT = np.frombuffer(SEQ_CODES.encode(), dtype=np.uint8)
# byte -> two ASCII bases, as a uint16 LUT (single gather per record)
_PAIR_LUT = np.zeros(256, dtype="<u2")
for _b in range(256):
    _PAIR_LUT[_b] = int(_SEQ_LUT[_b >> 4]) | (int(_SEQ_LUT[_b & 0xF]) << 8)


def _decode_seq(packed, l_seq):
    b = np.frombuffer(packed, dtype=np.uint8)
    return _PAIR_LUT[b].tobytes()[:l_seq]


# ---------------------------------------------------------------------------
# Writer (for tests / split_by_* outputs)
# ---------------------------------------------------------------------------

_SEQ_ENC = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(SEQ_CODES):
    _SEQ_ENC[ord(_c)] = _i


def write_bam(path, ref_names, ref_lengths, records, header_text=None):
    if header_text is None:
        header_text = "".join(
            f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in zip(ref_names, ref_lengths)
        )
    with BgzfWriter(path) as w:
        w.write(b"BAM\x01")
        ht = header_text.encode()
        w.write(struct.pack("<i", len(ht)))
        w.write(ht)
        w.write(struct.pack("<i", len(ref_names)))
        for n, l in zip(ref_names, ref_lengths):
            nb = n.encode() + b"\x00"
            w.write(struct.pack("<i", len(nb)))
            w.write(nb)
            w.write(struct.pack("<i", l))
        for rec in records:
            w.write(_encode_record(rec))
    return path


def _encode_record(rec: BamRecord):
    qname = rec.qname.encode() + b"\x00"
    cigar = b"".join(
        struct.pack("<I", (ln << 4) | CIGAR_OPS.index(op))
        for op, ln in rec.cigar
    )
    seq_arr = _SEQ_ENC[np.frombuffer(rec.seq, dtype=np.uint8)]
    if seq_arr.shape[0] % 2:
        seq_arr = np.concatenate([seq_arr, np.zeros(1, dtype=np.uint8)])
    packed = ((seq_arr[0::2] << 4) | seq_arr[1::2]).astype(np.uint8).tobytes()
    qual = rec.qual if rec.qual else b"\xff" * len(rec.seq)
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id,
        rec.pos,
        len(qname),
        rec.mapq,
        0,
        len(rec.cigar),
        rec.flag,
        len(rec.seq),
        getattr(rec, "next_ref_id", rec.ref_id),
        getattr(rec, "next_pos", 0),
        0,
    )
    blob = body + qname + cigar + packed + qual + (rec.tags or b"")
    return struct.pack("<i", len(blob)) + blob
