"""BGZF (blocked gzip): the port's copy of `is_gzip`, `decompress_file`,
`BgzfWriter` (with `_make_block`) and `BgzfReader`'s seeking, line reads
and virtual offsets from wgbs_tools_tpu/formats/bgzf.py.

A BGZF file is a sequence of gzip members, each at most 64 KiB of
uncompressed payload, whose FEXTRA field carries a "BC" subfield with the
total compressed block size. Virtual offsets are (compressed_block_offset
<< 16 | in-block offset), as in htslib.
"""

import gzip
import io
import os
import struct
import zlib

# 64 KiB minus header/footer margin, matching htslib's default payload cap.
MAX_BLOCK_DATA = 65280

_BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _make_block(data: bytes, level: int = 6) -> bytes:
    """Compress one chunk (<= MAX_BLOCK_DATA bytes) into a BGZF block."""
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    # header: 12 fixed bytes + 6 extra ("BC", len=2, BSIZE-1)
    header = (
        b"\x1f\x8b\x08\x04"  # magic, CM=deflate, FLG=FEXTRA
        + b"\x00\x00\x00\x00"  # mtime
        + b"\x00\xff"  # XFL, OS=unknown
        + struct.pack("<H", 6)  # XLEN
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", len(payload) + 25)  # BSIZE - 1 (total block size - 1)
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data) & 0xFFFFFFFF)
    return header + payload + footer


class BgzfWriter(io.RawIOBase):
    """Streaming BGZF writer with virtual-offset tracking."""

    def __init__(self, path_or_fileobj, level=6, append=False):
        if hasattr(path_or_fileobj, "write"):
            self._fh = path_or_fileobj
            self._own = False
        else:
            self._fh = open(path_or_fileobj, "ab" if append else "wb")
            self._own = True
        self._level = level
        self._buf = bytearray()
        self._coffset = self._fh.tell() if self._fh.seekable() else 0
        self._closed = False

    def writable(self):
        return True

    @property
    def virtual_offset(self) -> int:
        """Virtual offset of the next byte to be written."""
        return (self._coffset << 16) | len(self._buf)

    def write(self, data) -> int:
        if isinstance(data, str):
            data = data.encode()
        self._buf += data
        while len(self._buf) >= MAX_BLOCK_DATA:
            self._flush_block(MAX_BLOCK_DATA)
        return len(data)

    def flush_block(self):
        """Force the current buffer out as a block (e.g. at record boundaries)."""
        if self._buf:
            self._flush_block(len(self._buf))

    def _flush_block(self, n):
        block = _make_block(bytes(self._buf[:n]), self._level)
        self._fh.write(block)
        self._coffset += len(block)
        del self._buf[:n]

    def close(self):
        if self._closed:
            return
        self.flush_block()
        self._fh.write(_BGZF_EOF)
        self._fh.flush()
        if self._own:
            self._fh.close()
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def decompress_file(path) -> bytes:
    """Decompress a BGZF/gzip file fully (multi-member aware)."""
    with gzip.open(path, "rb") as f:
        return f.read()


def is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


class BgzfReader:
    """Random-access BGZF reader: virtual-offset seeks, then line reads.

    Unlike wgbs_tools_tpu's copy, a line read goes on past an empty block
    that is not the file's last, as htslib's reader does: in BGZF files
    joined by byte append the JAX reader stops at the first part's EOF
    marker, so an index built by index_pat covered the first part alone.
    """

    def __init__(self, path):
        self._fh = open(path, "rb")
        self._size = os.fstat(self._fh.fileno()).st_size
        self._block_coffset = 0
        self._block_data = b""
        self._within = 0
        self._next_coffset = 0
        self._load_block(0)

    def _load_block(self, coffset):
        self._fh.seek(coffset)
        header = self._fh.read(18)
        if len(header) < 18:
            self._block_coffset = coffset
            self._block_data = b""
            self._within = 0
            self._next_coffset = coffset
            return False
        if header[:4] != b"\x1f\x8b\x08\x04":
            raise ValueError(f"not a BGZF block at offset {coffset}")
        xlen = struct.unpack("<H", header[10:12])[0]
        extra = header[12:18]
        if xlen > 6:
            extra += self._fh.read(xlen - 6)
        bsize = None
        pos = 0
        while pos + 4 <= len(extra):
            slen = struct.unpack("<H", extra[pos + 2 : pos + 4])[0]
            if extra[pos] == 0x42 and extra[pos + 1] == 0x43 and slen == 2:
                bsize = struct.unpack("<H", extra[pos + 4 : pos + 6])[0] + 1
                break
            pos += 4 + slen
        if bsize is None:
            raise ValueError(f"BGZF block without BC subfield at {coffset}")
        payload_len = bsize - 12 - xlen - 8
        payload = self._fh.read(payload_len)
        self._fh.read(8)  # crc, isize
        self._block_coffset = coffset
        self._block_data = zlib.decompress(payload, -15) if payload_len else b""
        self._within = 0
        self._next_coffset = coffset + bsize
        return True

    @property
    def virtual_offset(self) -> int:
        return (self._block_coffset << 16) | self._within

    def seek_virtual(self, voffset: int):
        coffset, within = voffset >> 16, voffset & 0xFFFF
        if coffset != self._block_coffset or not self._block_data:
            self._load_block(coffset)
        self._within = within

    def readline(self) -> bytes:
        chunks = []
        while True:
            nl = self._block_data.find(b"\n", self._within)
            if nl >= 0:
                chunks.append(self._block_data[self._within : nl + 1])
                self._within = nl + 1
                return b"".join(chunks)
            chunks.append(self._block_data[self._within :])
            # on to the next block with data: an empty block inside the file
            # (the EOF marker of a part in BGZF files joined by byte append,
            # as bam2pat --procs joins its parts) is skipped; the file's
            # last block ends the read where it stands
            while True:
                if not self._load_block(self._next_coffset):
                    return b"".join(chunks)
                if self._block_data:
                    break
                if self._next_coffset >= self._size:
                    return b"".join(chunks)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
