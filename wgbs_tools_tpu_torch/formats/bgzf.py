"""BGZF (blocked gzip) reading: the port's copy of `is_gzip` and of
`BgzfReader`'s seeking and line reads from wgbs_tools_tpu/formats/bgzf.py.

A BGZF file is a sequence of gzip members, each at most 64 KiB of
uncompressed payload, whose FEXTRA field carries a "BC" subfield with the
total compressed block size. Virtual offsets are (compressed_block_offset
<< 16 | in-block offset), as in htslib.
"""

import struct
import zlib


def is_gzip(path) -> bool:
    with open(path, "rb") as f:
        return f.read(2) == b"\x1f\x8b"


class BgzfReader:
    """Random-access BGZF reader: virtual-offset seeks, then line reads."""

    def __init__(self, path):
        self._fh = open(path, "rb")
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
            prev = self._block_coffset
            if not self._load_block(self._next_coffset) or (
                not self._block_data and self._block_coffset == prev
            ):
                return b"".join(chunks)
            if not self._block_data:
                return b"".join(chunks)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
