# Copy of velocyto_tpu/counting/bamio.py; imports nothing of the JAX package.
"""BGZF + BAM binary I/O in pure Python (zlib).

The reference relies on pysam/htslib for BAM decoding
(reference: velocyto/counter.py:217-306).  pysam is not a dependency
here: this module implements the BAM spec directly.  It serves as

  - the correctness oracle + fallback decoder (the C++ decoder in
    velocyto_tpu_torch/native is the production path),
  - a writer, used by the test-suite to synthesize BAM fixtures and by
    the dropest barcode-correction tool to rewrite CB tags.

Layout notes (SAM/BAM spec v1.6):
  BGZF: concatenated gzip members with a BSIZE extra subfield; a plain
  multi-member gzip inflate reads it.
  BAM:  "BAM\\1", l_text, text, n_ref, (l_name, name, l_ref)*, then
  records: block_size, refID, pos, l_read_name, mapq, bin, n_cigar_op,
  flag, l_seq, next_refID, next_pos, tlen, read_name\\0, cigar[], seq
  (4-bit), qual, tags.
"""
from __future__ import annotations

import struct
import zlib
from typing import Any, Dict, Iterator, List, Optional, Tuple

_BAM_MAGIC = b"BAM\x01"
_SEQ_NT = "=ACMGRSVTWYHKDBN"
_CIGAR_OPS = "MIDNSHP=X"

# BGZF EOF marker block (28 bytes, per the SAM spec appendix)
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

def bgzf_decompress(data: bytes) -> bytes:
    """Inflate a BGZF byte string (concatenated gzip members)."""
    out = []
    pos = 0
    n = len(data)
    while pos < n:
        d = zlib.decompressobj(31)
        out.append(d.decompress(data[pos:]))
        consumed = n - pos - len(d.unused_data)
        if consumed <= 0:
            break
        pos += consumed
    return b"".join(out)


def bgzf_compress_block(payload: bytes, level: int = 6) -> bytes:
    """One BGZF block (payload must be <= 65255 bytes)."""
    c = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = c.compress(payload) + c.flush()
    # BSIZE = total block size - 1 (SAM spec 4.1): 18 header + comp + 8 - 1
    bsize = len(comp) + 25
    header = (b"\x1f\x8b\x08\x04" + b"\x00" * 6 +
              struct.pack("<HBBHH", 6, ord("B"), ord("C"), 2, bsize))
    crc = zlib.crc32(payload) & 0xFFFFFFFF
    return header + comp + struct.pack("<II", crc, len(payload))


def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    out = []
    for i in range(0, len(data), 60000):
        out.append(bgzf_compress_block(data[i:i + 60000], level))
    out.append(BGZF_EOF)
    return b"".join(out)


# ---------------------------------------------------------------------------
# BAM records
# ---------------------------------------------------------------------------

class BamRecord:
    __slots__ = ["name", "flag", "ref_id", "pos", "mapq", "cigar", "seq",
                 "qual", "tags", "next_ref_id", "next_pos", "tlen"]

    def __init__(self, name: str, flag: int, ref_id: int, pos: int,
                 cigar: List[Tuple[int, int]], tags: Dict[str, Any],
                 mapq: int = 255, seq: str = "", qual: Optional[bytes] = None,
                 next_ref_id: int = -1, next_pos: int = -1,
                 tlen: int = 0) -> None:
        self.name = name
        self.flag = flag
        self.ref_id = ref_id
        self.pos = pos            # 0-based leftmost coordinate
        self.mapq = mapq
        self.cigar = cigar        # list of (op_code, length)
        self.seq = seq
        self.qual = qual
        self.tags = tags          # tag -> python value
        self.next_ref_id = next_ref_id
        self.next_pos = next_pos
        self.tlen = tlen

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & 0x4)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & 0x10)


def _encode_tags(tags: Dict[str, Any]) -> bytes:
    out = b""
    for tag, val in tags.items():
        t = tag.encode()
        if isinstance(val, str):
            out += t + b"Z" + val.encode() + b"\x00"
        elif isinstance(val, int):
            out += t + b"i" + struct.pack("<i", val)
        elif isinstance(val, float):
            out += t + b"f" + struct.pack("<f", val)
        else:
            raise TypeError(f"unsupported tag type {type(val)}")
    return out


def _decode_tags(buf: bytes) -> Dict[str, Any]:
    tags: Dict[str, Any] = {}
    pos = 0
    n = len(buf)
    while pos + 3 <= n:
        tag = buf[pos:pos + 2].decode()
        typ = chr(buf[pos + 2])
        pos += 3
        if typ == "A":
            tags[tag] = chr(buf[pos]); pos += 1
        elif typ == "c":
            tags[tag] = struct.unpack_from("<b", buf, pos)[0]; pos += 1
        elif typ == "C":
            tags[tag] = struct.unpack_from("<B", buf, pos)[0]; pos += 1
        elif typ == "s":
            tags[tag] = struct.unpack_from("<h", buf, pos)[0]; pos += 2
        elif typ == "S":
            tags[tag] = struct.unpack_from("<H", buf, pos)[0]; pos += 2
        elif typ == "i":
            tags[tag] = struct.unpack_from("<i", buf, pos)[0]; pos += 4
        elif typ == "I":
            tags[tag] = struct.unpack_from("<I", buf, pos)[0]; pos += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, pos)[0]; pos += 4
        elif typ in ("Z", "H"):
            end = buf.index(b"\x00", pos)
            tags[tag] = buf[pos:end].decode()
            pos = end + 1
        elif typ == "B":
            sub = chr(buf[pos]); cnt = struct.unpack_from("<i", buf, pos + 1)[0]
            pos += 5
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt = "<" + str(cnt) + {"c": "b", "C": "B", "s": "h", "S": "H",
                                    "i": "i", "I": "I", "f": "f"}[sub]
            tags[tag] = list(struct.unpack_from(fmt, buf, pos))
            pos += size * cnt
        else:
            raise ValueError(f"unknown tag type {typ}")
    return tags


def _encode_record(rec: BamRecord) -> bytes:
    name_b = rec.name.encode() + b"\x00"
    cigar_b = b"".join(struct.pack("<I", (length << 4) | op)
                       for op, length in rec.cigar)
    l_seq = len(rec.seq)
    seq_b = bytearray((l_seq + 1) // 2)
    for i, ch in enumerate(rec.seq):
        code = _SEQ_NT.index(ch) if ch in _SEQ_NT else 15
        if i % 2 == 0:
            seq_b[i // 2] |= code << 4
        else:
            seq_b[i // 2] |= code
    qual_b = rec.qual if rec.qual is not None else b"\xff" * l_seq
    tags_b = _encode_tags(rec.tags)
    body = struct.pack("<iiBBHHHiiii", rec.ref_id, rec.pos, len(name_b),
                       rec.mapq, 4680, len(rec.cigar), rec.flag, l_seq,
                       rec.next_ref_id, rec.next_pos, rec.tlen)
    body += name_b + cigar_b + bytes(seq_b) + qual_b + tags_b
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, references: List[Tuple[str, int]],
              records: List[BamRecord], header_text: str = "") -> None:
    """Write a BGZF-compressed BAM file."""
    payload = bytearray()
    payload += _BAM_MAGIC
    text = header_text.encode()
    payload += struct.pack("<i", len(text)) + text
    payload += struct.pack("<i", len(references))
    for name, length in references:
        nb = name.encode() + b"\x00"
        payload += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
    for rec in records:
        payload += _encode_record(rec)
    with open(path, "wb") as f:
        f.write(bgzf_compress(bytes(payload)))


class _BgzfStream:
    """Incremental BGZF/gzip inflater with a read(n) interface: the
    compressed file is consumed in chunks, so a BamReader never holds a
    whole decoded BAM in memory."""

    _CHUNK = 1 << 20

    def __init__(self, f) -> None:
        self._f = f
        self._d = zlib.decompressobj(31)
        self._buf = bytearray()
        self._pos = 0
        self._eof = False

    def _fill(self, want: int) -> None:
        while len(self._buf) - self._pos < want and not self._eof:
            if self._pos > (1 << 22):
                del self._buf[:self._pos]
                self._pos = 0
            if self._d.eof:
                carry = self._d.unused_data
                self._d = zlib.decompressobj(31)
                if carry:
                    self._buf += self._d.decompress(carry)
                    continue
            raw = self._f.read(self._CHUNK)
            if not raw:
                self._eof = True
                break
            self._buf += self._d.decompress(raw)

    def read(self, n: int) -> bytes:
        self._fill(n)
        out = bytes(self._buf[self._pos:self._pos + n])
        self._pos += len(out)
        return out


class _RawStream:
    def __init__(self, f) -> None:
        self._f = f

    def read(self, n: int) -> bytes:
        return self._f.read(n)


class BamReader:
    """Sequential streaming BAM reader (pure python fallback / oracle)."""

    def __init__(self, path: str) -> None:
        self._fh = open(path, "rb")
        magic = self._fh.read(2)
        self._fh.seek(0)
        if magic == b"\x1f\x8b":
            self._stream = _BgzfStream(self._fh)
        else:
            self._stream = _RawStream(self._fh)
        if self._stream.read(4) != _BAM_MAGIC:
            raise IOError(f"{path} is not a BAM file")
        l_text = struct.unpack("<i", self._stream.read(4))[0]
        self.header_text = self._stream.read(l_text).decode(errors="replace")
        n_ref = struct.unpack("<i", self._stream.read(4))[0]
        self.references: List[str] = []
        self.lengths: List[int] = []
        for _ in range(n_ref):
            l_name = struct.unpack("<i", self._stream.read(4))[0]
            self.references.append(
                self._stream.read(l_name)[:-1].decode())
            self.lengths.append(
                struct.unpack("<i", self._stream.read(4))[0])

    def get_reference_name(self, ref_id: int) -> str:
        return self.references[ref_id]

    def __iter__(self) -> Iterator[BamRecord]:
        read = self._stream.read
        while True:
            head = read(4)
            if len(head) < 4:
                return
            block_size = struct.unpack("<i", head)[0]
            data = read(block_size)
            if len(data) < block_size:
                return
            (ref_id, p, l_rn, mapq, _bin, n_cig, flag, l_seq, nrid, npos,
             tlen) = struct.unpack_from("<iiBBHHHiiii", data)
            off = 32
            name = data[off:off + l_rn - 1].decode()
            off += l_rn
            cigar = []
            for _ in range(n_cig):
                v = struct.unpack_from("<I", data, off)[0]
                cigar.append((v & 0xF, v >> 4))
                off += 4
            seq_bytes = data[off:off + (l_seq + 1) // 2]
            off += (l_seq + 1) // 2
            seq = "".join(
                _SEQ_NT[(seq_bytes[i // 2] >> 4) if i % 2 == 0
                        else (seq_bytes[i // 2] & 0xF)]
                for i in range(l_seq))
            qual = data[off:off + l_seq]
            off += l_seq
            tags = _decode_tags(data[off:block_size])
            yield BamRecord(name, flag, ref_id, p, cigar, tags, mapq, seq,
                            qual, nrid, npos, tlen)
