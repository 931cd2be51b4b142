"""Raw-byte BAM record layer.

Record accessors work directly on BAM wire bytes at fixed offsets, mirroring the
reference's raw-record design (crates/fgumi-raw-bam/src/fields.rs:7-24:
refID/pos/l_read_name/mapq/bin/n_cigar_op/flag/l_seq/next_refID/next_pos/tlen then
name, cigar, packed seq, qual, aux TLV) — decoding only what each consumer touches.
"""

import contextvars
import logging
import os
import struct
import time
import zlib
from dataclasses import dataclass

import numpy as np

from .bgzf import BgzfReader, BgzfWriter, _bc_bsize
from .errors import InputFormatError, OutputIntegrityError

BAM_MAGIC = b"BAM\x01"
# SAM spec reg2bin(-1, 0) — the unmapped record bin (builder.rs:1-3).
UNMAPPED_BIN = 4680

# BAM flags (SAM spec).
FLAG_PAIRED = 0x1
FLAG_PROPER_PAIR = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_FIRST = 0x40
FLAG_LAST = 0x80
FLAG_SECONDARY = 0x100
FLAG_QC_FAIL = 0x200
FLAG_DUPLICATE = 0x400
FLAG_SUPPLEMENTARY = 0x800

# 4-bit seq nibble -> ASCII (=ACMGRSVTWYHKDBN).
NIBBLE_TO_BASE = np.frombuffer(b"=ACMGRSVTWYHKDBN", dtype=np.uint8)
BASE_TO_NIBBLE = np.full(256, 15, dtype=np.uint8)  # default N
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    BASE_TO_NIBBLE[_b] = _i
for _i, _b in enumerate(b"=acmgrsvtwyhkdbn"):
    BASE_TO_NIBBLE[_b] = _i

CIGAR_OPS = "MIDNSHP=X"
_CONSUMES_REF = frozenset("MDN=X")


@dataclass
class BamHeader:
    text: str
    ref_names: list
    ref_lengths: list

    def encode(self) -> bytes:
        text_b = self.text.encode()
        out = bytearray(BAM_MAGIC)
        out += struct.pack("<i", len(text_b))
        out += text_b
        out += struct.pack("<i", len(self.ref_names))
        for name, length in zip(self.ref_names, self.ref_lengths):
            nb = name.encode() + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", length)
        return bytes(out)

    @classmethod
    def decode_from(cls, read, path: str = None):
        """Parse from a `read(n)` callable positioned at the stream start;
        ``path`` names the input in an error."""
        magic = read(4)
        if magic != BAM_MAGIC:
            raise InputFormatError(f"not a BAM stream (magic {magic!r})",
                                   path=path)
        try:
            return cls._decode_rest(read)
        except struct.error as e:
            raise InputFormatError(f"truncated BAM header ({e})",
                                   path=path) from e

    @classmethod
    def _decode_rest(cls, read):
        (l_text,) = struct.unpack("<i", read(4))
        text = read(l_text).decode(errors="replace").rstrip("\x00")
        (n_ref,) = struct.unpack("<i", read(4))
        names, lengths = [], []
        for _ in range(n_ref):
            (l_name,) = struct.unpack("<i", read(4))
            names.append(read(l_name)[:-1].decode())
            (l_ref,) = struct.unpack("<i", read(4))
            lengths.append(l_ref)
        return cls(text=text, ref_names=names, ref_lengths=lengths)


class RawRecord:
    """A single BAM record's wire bytes (without the leading block_size)."""

    __slots__ = ("data", "_tag_idx", "_cigar")

    def __init__(self, data: bytes):
        self.data = data
        self._tag_idx = None  # lazy {tag: (typ, value_off)} built on first lookup
        self._cigar = None    # lazy cached decoded CIGAR

    # --- fixed-offset fields (fields.rs:7-24) ---
    @property
    def ref_id(self) -> int:
        return int.from_bytes(self.data[0:4], "little", signed=True)

    @property
    def pos(self) -> int:
        return int.from_bytes(self.data[4:8], "little", signed=True)

    @property
    def l_read_name(self) -> int:
        return self.data[8]

    @property
    def mapq(self) -> int:
        return self.data[9]

    @property
    def n_cigar_op(self) -> int:
        return int.from_bytes(self.data[12:14], "little")

    @property
    def flag(self) -> int:
        return int.from_bytes(self.data[14:16], "little")

    @property
    def l_seq(self) -> int:
        return int.from_bytes(self.data[16:20], "little")

    @property
    def next_ref_id(self) -> int:
        return int.from_bytes(self.data[20:24], "little", signed=True)

    @property
    def next_pos(self) -> int:
        return int.from_bytes(self.data[24:28], "little", signed=True)

    @property
    def tlen(self) -> int:
        return int.from_bytes(self.data[28:32], "little", signed=True)

    @property
    def name(self) -> bytes:
        return self.data[32 : 32 + self.l_read_name - 1]

    # --- variable sections ---
    def _cigar_off(self) -> int:
        return 32 + self.l_read_name

    def _seq_off(self) -> int:
        return self._cigar_off() + 4 * self.n_cigar_op

    def _qual_off(self) -> int:
        return self._seq_off() + (self.l_seq + 1) // 2

    def _aux_off(self) -> int:
        return self._qual_off() + self.l_seq

    def cigar(self):
        """[(op_char, length)] decoded CIGAR (cached; the record's bytes are
        immutable and consumers probe the CIGAR several times per record)."""
        out = self._cigar
        if out is None:
            off = self._cigar_off()
            data = self.data
            out = []
            for i in range(self.n_cigar_op):
                v = int.from_bytes(data[off + 4 * i: off + 4 * i + 4],
                                   "little")
                out.append((CIGAR_OPS[v & 0xF], v >> 4))
            self._cigar = out
        return out

    def seq_bytes(self) -> bytes:
        """ASCII sequence (unpacked from 4-bit codes)."""
        n = self.l_seq
        packed = np.frombuffer(self.data, dtype=np.uint8, count=(n + 1) // 2,
                               offset=self._seq_off())
        nibbles = np.empty(2 * len(packed), dtype=np.uint8)
        nibbles[0::2] = packed >> 4
        nibbles[1::2] = packed & 0xF
        return NIBBLE_TO_BASE[nibbles[:n]].tobytes()

    def quals(self) -> np.ndarray:
        return np.frombuffer(self.data, dtype=np.uint8, count=self.l_seq,
                             offset=self._qual_off()).copy()

    # --- aux tag TLV scan (tags.rs:8-40) ---
    def _iter_tags(self):
        data = self.data
        off = self._aux_off()
        end = len(data)
        while off + 3 <= end:
            tag = data[off: off + 2]
            typ = data[off + 2]
            off += 3
            yield tag, typ, off
            off = _skip_tag_value(data, typ, off)

    def find_tag(self, tag: bytes):
        """Return (type_char, python value) or None. The TLV scan runs once
        per record and caches {tag: (typ, off)}; the first occurrence wins."""
        idx = self._tag_idx
        if idx is None:
            idx = {}
            for t, typ, off in self._iter_tags():
                if t not in idx:
                    idx[t] = (typ, off)
            self._tag_idx = idx
        got = idx.get(tag)
        if got is None:
            return None
        typ, off = got
        return chr(typ), _read_tag_value(self.data, typ, off)

    def get_str(self, tag: bytes):
        got = self.find_tag(tag)
        if got is None:
            return None
        typ, val = got
        return val if typ in ("Z", "H") else None

    def get_int(self, tag: bytes):
        got = self.find_tag(tag)
        if got is None:
            return None
        typ, val = got
        return int(val) if typ in "cCsSiI" else None

    def data_without_tag(self, tag: bytes) -> bytes:
        """Record bytes with every occurrence of `tag` removed (aux TLV edit)."""
        spans = [(off - 3, _skip_tag_value(self.data, typ, off))
                 for t, typ, off in self._iter_tags() if t == tag]
        if not spans:
            return self.data
        out = bytearray()
        prev = 0
        for start, end in spans:
            out += self.data[prev:start]
            prev = end
        out += self.data[prev:]
        return bytes(out)

    def reference_length(self) -> int:
        return sum(n for op, n in self.cigar() if op in _CONSUMES_REF)

    def unclipped_start(self) -> int:
        """0-based alignment start minus leading clips."""
        pos = self.pos
        for op, n in self.cigar():
            if op not in "SH":
                break
            pos -= n
        return pos

    def unclipped_end(self) -> int:
        """0-based inclusive alignment end plus trailing clips."""
        end = self.pos + self.reference_length() - 1
        for op, n in reversed(self.cigar()):
            if op not in "SH":
                break
            end += n
        return end


_TAG_SIZES = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2, ord("i"): 4,
              ord("I"): 4, ord("f"): 4, ord("A"): 1}
_ARRAY_DTYPES = {ord("c"): np.int8, ord("C"): np.uint8, ord("s"): np.int16,
                 ord("S"): np.uint16, ord("i"): np.int32, ord("I"): np.uint32,
                 ord("f"): np.float32}


def _skip_tag_value(data: bytes, typ: int, off: int) -> int:
    size = _TAG_SIZES.get(typ)
    if size is not None:
        return off + size
    if typ in (ord("Z"), ord("H")):
        return data.index(b"\x00", off) + 1
    if typ == ord("B"):
        sub = data[off]
        (count,) = struct.unpack_from("<I", data, off + 1)
        return off + 5 + count * _TAG_SIZES[sub]
    raise ValueError(f"unknown aux tag type {typ!r}")


def _read_tag_value(data: bytes, typ: int, off: int):
    c = chr(typ)
    if c == "A":
        return chr(data[off])
    if c in "cCsSiI":
        fmt = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I"}[c]
        return struct.unpack_from(fmt, data, off)[0]
    if c == "f":
        return struct.unpack_from("<f", data, off)[0]
    if c in "ZH":
        end = data.index(b"\x00", off)
        return data[off:end].decode(errors="replace")
    if c == "B":
        sub = data[off]
        (count,) = struct.unpack_from("<I", data, off + 1)
        dt = _ARRAY_DTYPES[sub]
        return np.frombuffer(data, dtype=dt, count=count, offset=off + 5).copy()
    raise ValueError(f"unknown aux tag type {c!r}")


def pack_seq(seq) -> bytes:
    """ASCII sequence (bytes or uint8 array) -> BAM 4-bit packed bytes."""
    codes = BASE_TO_NIBBLE[np.frombuffer(seq, dtype=np.uint8)
                           if isinstance(seq, (bytes, bytearray))
                           else np.asarray(seq, dtype=np.uint8)]
    if len(codes) % 2:
        codes = np.append(codes, 0)
    return ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()


class RecordBuilder:
    """Builds raw BAM record bytes (mirrors UnmappedSamBuilder, builder.rs:69-200)."""

    def __init__(self):
        self._buf = bytearray()

    def start_unmapped(self, name: bytes, flag: int, seq: bytes, quals) -> "RecordBuilder":
        """Begin an unmapped record: ref_id=-1, pos=-1, mapq=0, bin=4680, no CIGAR."""
        buf = self._buf
        buf.clear()
        l_name = len(name) + 1
        if l_name > 255:
            raise ValueError(f"read name too long ({len(name)} bytes): {name[:40]!r}...")
        n = len(seq)
        buf += struct.pack("<iiBBHHHiiii", -1, -1, l_name, 0, UNMAPPED_BIN, 0,
                           flag, n, -1, -1, 0)
        buf += name
        buf += b"\x00"
        buf += pack_seq(seq)
        buf += np.asarray(quals, dtype=np.uint8).tobytes()
        return self

    def start_mapped(self, name: bytes, flag: int, ref_id: int, pos: int,
                     mapq: int, cigar, seq: bytes, quals,
                     next_ref_id: int = -1, next_pos: int = -1,
                     tlen: int = 0) -> "RecordBuilder":
        """Begin a mapped record. `cigar` is [(op_char, length)] (builder.rs:356)."""
        from .bai import reg2bin

        buf = self._buf
        buf.clear()
        l_name = len(name) + 1
        if l_name > 255:
            raise ValueError(f"read name too long ({len(name)} bytes)")
        n = len(seq)
        ref_len = sum(ln for op, ln in cigar if op in _CONSUMES_REF) or 1
        bin_ = reg2bin(pos, pos + ref_len) if pos >= 0 else UNMAPPED_BIN
        buf += struct.pack("<iiBBHHHiiii", ref_id, pos, l_name, mapq, bin_,
                           len(cigar), flag, n, next_ref_id, next_pos, tlen)
        buf += name
        buf += b"\x00"
        for op, length in cigar:
            buf += struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
        buf += pack_seq(seq)
        buf += np.asarray(quals, dtype=np.uint8).tobytes()
        return self

    def tag_str(self, tag: bytes, value: bytes) -> "RecordBuilder":
        self._buf += tag + b"Z" + value + b"\x00"
        return self

    def tag_int(self, tag: bytes, value: int) -> "RecordBuilder":
        self._buf += tag + b"i" + struct.pack("<i", value)
        return self

    def tag_float(self, tag: bytes, value: float) -> "RecordBuilder":
        self._buf += tag + b"f" + struct.pack("<f", value)
        return self

    def tag_array_i16(self, tag: bytes, values) -> "RecordBuilder":
        arr = np.asarray(values, dtype=np.int16)
        self._buf += tag + b"Bs" + struct.pack("<I", arr.size) + arr.tobytes()
        return self

    def tag_array_u8(self, tag: bytes, values) -> "RecordBuilder":
        arr = np.asarray(values, dtype=np.uint8)
        self._buf += tag + b"BC" + struct.pack("<I", arr.size) + arr.tobytes()
        return self

    def finish(self) -> bytes:
        return bytes(self._buf)


class BamReader:
    """Sequential BAM reader yielding RawRecord over a BGZF/gzip stream."""

    def __init__(self, path_or_obj):
        owns = isinstance(path_or_obj, str)
        fileobj = open(path_or_obj, "rb") if owns else path_or_obj
        self._path = path_or_obj if owns else getattr(fileobj, "name", None)
        self._r = BgzfReader(fileobj, owns_fileobj=owns, name=self._path)
        self.header = BamHeader.decode_from(self._r.read, self._path)

    def __iter__(self):
        read = self._r.read
        while True:
            sz = read(4)
            if len(sz) < 4:
                return
            (block_size,) = struct.unpack("<I", sz)
            data = read(block_size)
            if len(data) < block_size:
                raise InputFormatError(
                    f"truncated BAM record (expected {block_size} bytes, "
                    f"got {len(data)} before EOF)", path=self._path)
            yield RawRecord(data)

    def close(self):
        self._r.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _read_bgzf_block_at(f):
    """One BGZF block at the current file position -> (payload, csize),
    or None at EOF. Parses BSIZE from the BC extra subfield (BGZF spec)."""
    header = f.read(12)
    if len(header) < 12:
        return None
    if header[:4] != b"\x1f\x8b\x08\x04":
        raise ValueError("not a BGZF block (missing BC extra flag)")
    (xlen,) = struct.unpack_from("<H", header, 10)
    bsize = _bc_bsize(f.read(xlen)) + 1
    if bsize == 0:
        raise ValueError("BGZF block lacks BSIZE")
    cdata_len = bsize - 12 - xlen - 8
    cdata = f.read(cdata_len)
    footer = f.read(8)
    if len(cdata) < cdata_len or len(footer) < 8:
        raise EOFError("truncated BGZF block")
    payload = zlib.decompress(cdata, wbits=-15)
    (isize,) = struct.unpack_from("<I", footer, 4)
    if len(payload) != isize:
        raise ValueError("BGZF ISIZE mismatch")
    return payload, bsize


class BamIndexedReader:
    """Random-access BAM reader over a coordinate-sorted BAM + .bai index.

    Analog of the reference's indexed reader
    (crates/fgumi-raw-bam/src/indexed_reader.rs): BAI bins +
    linear index select candidate chunks, BGZF blocks are decompressed from
    each chunk's virtual offset, and records are filtered by actual overlap.
    """

    def __init__(self, path: str, index_path: str = None):
        """`index_path`: explicit .bai/.csi path; by default .bai is tried
        first, then .csi (both expose the same query_chunks interface)."""
        with BamReader(path) as r:
            self.header = r.header
        from .bai import BaiIndex, CsiIndex

        if index_path is None:
            index_path = path + ".bai" if os.path.exists(path + ".bai") \
                else path + ".csi"
        self.index = CsiIndex(index_path) if index_path.endswith(".csi") \
            else BaiIndex(index_path)
        self._f = open(path, "rb")

    def query(self, tid: int, beg: int, end: int):
        """Yield RawRecords overlapping [beg, end) on reference `tid`."""
        for vo_beg, vo_end in self.index.query_chunks(tid, beg, end):
            yield from self._scan_chunk(vo_beg, vo_end, tid, beg, end)

    def _scan_chunk(self, vo_beg, vo_end, tid, beg, end):
        f = self._f
        coffset = vo_beg >> 16
        f.seek(coffset)
        got = _read_bgzf_block_at(f)
        if got is None:
            return
        payload, csize = got
        buf = bytearray(payload[vo_beg & 0xFFFF:])
        # markers: (buf_pos, block_file_offset, offset_of_buf_pos_in_block)
        markers = [(0, coffset, vo_beg & 0xFFFF)]
        next_coffset = coffset + csize
        pos = 0
        while True:
            if pos > (1 << 20):
                # stream with bounded memory: drop the consumed prefix and
                # rebase the block markers (whole-chromosome queries would
                # otherwise hold the full decompressed chunk)
                keep = max(i for i, m in enumerate(markers) if m[0] <= pos)
                rebased = []
                for bpos, blk_off, in_blk in markers[keep:]:
                    if bpos < pos:  # the block containing `pos`
                        rebased.append((0, blk_off, in_blk + pos - bpos))
                    else:
                        rebased.append((bpos - pos, blk_off, in_blk))
                markers = rebased
                del buf[:pos]
                pos = 0
            while len(buf) < pos + 4:
                got = _read_bgzf_block_at(f)
                if got is None:
                    return
                markers.append((len(buf), next_coffset, 0))
                buf += got[0]
                next_coffset += got[1]
            # virtual offset of this record's first byte
            m = next(m for m in reversed(markers) if m[0] <= pos)
            rec_vo = (m[1] << 16) | (m[2] + pos - m[0])
            if rec_vo >= vo_end:
                return
            (block_size,) = struct.unpack_from("<I", buf, pos)
            while len(buf) < pos + 4 + block_size:
                got = _read_bgzf_block_at(f)
                if got is None:
                    raise EOFError("truncated BAM record in indexed read")
                markers.append((len(buf), next_coffset, 0))
                buf += got[0]
                next_coffset += got[1]
            rec = RawRecord(bytes(buf[pos + 4:pos + 4 + block_size]))
            pos += 4 + block_size
            if rec.ref_id != tid or rec.pos >= end:
                if rec.ref_id > tid or (rec.ref_id == tid and rec.pos >= end):
                    return  # coordinate order: nothing later can overlap
                continue
            rec_end = rec.pos + max(rec.reference_length(), 1)
            if rec_end > beg:
                yield rec

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# default BGZF level for BamWriter (reference CompressionOptions default 1)
DEFAULT_COMPRESSION_LEVEL = 1


_audit_output_var = contextvars.ContextVar("fgumi_tpu_torch_audit_output",
                                           default=False)


def set_audit_output(enabled: bool):
    """Arm (for this invocation's context) the ``--audit-output``
    pre-commit integrity pass of BAM outputs."""
    _audit_output_var.set(bool(enabled))


def audit_output_enabled() -> bool:
    return _audit_output_var.get() or \
        os.environ.get("FGUMI_TPU_AUDIT_OUTPUT", "").strip().lower() \
        in ("1", "true", "on", "all")


class _OutputTally:
    """The writer's own accounting for the ``--audit-output`` re-walk: the
    record count and a running CRC32 over the record stream's bytes
    (block_size prefixes and payloads, in write order) as they were handed
    to the writer. Any loss, duplication, reordering or flipped bit between
    the writer's buffer and the page cache changes the digest; its order
    sensitivity is the sort-order check."""

    __slots__ = ("records", "content_crc", "header_crc")

    def __init__(self):
        self.records = 0
        self.content_crc = 0
        self.header_crc = 0  # CRC32 of the encoded BAM header

    def add_record(self, framed):
        """One record with its 4-byte block_size prefix."""
        self.records += 1
        self.content_crc = zlib.crc32(framed, self.content_crc)

    def add_serialized(self, blob):
        """A run of block_size-prefixed records."""
        view = memoryview(blob)
        off = 0
        n = len(view)
        while off + 4 <= n:
            size = int.from_bytes(view[off:off + 4], "little")
            self.records += 1
            off += 4 + size
        if off != n:
            # the writer itself was handed a torn blob: a caller bug, not
            # disk corruption; fail now, not at the re-walk
            raise OutputIntegrityError(
                "serialized record blob is torn (partial block_size "
                "prefix)")
        self.content_crc = zlib.crc32(view, self.content_crc)

    def add_indexed(self, blob, starts):
        """A prefix-framed blob whose record boundaries the caller already
        delimited (``starts``: cumulative offsets, one past the record
        count); the re-walk catches any disagreement with the framing."""
        self.records += len(starts) - 1
        self.content_crc = zlib.crc32(memoryview(blob), self.content_crc)


class _BamStreamAudit:
    """Incremental BAM structure walker over decompressed member payloads
    (the ``--audit-output`` record-layer pass): parses the magic, header
    and references, then counts records and CRCs them as
    :class:`_OutputTally` does; optionally checks coordinate order."""

    def __init__(self, path: str, expect_coordinate: bool = False):
        self._path = path
        self._buf = bytearray()
        self._state = "magic"
        self._text_len = 0
        self._refs_left = None
        self.records = 0
        self.content_crc = 0
        self.header_crc = 0
        self._expect_coord = expect_coordinate
        self._last_key = None

    def _fail(self, message):
        raise OutputIntegrityError(message, path=self._path)

    def _eat_header(self, n: int):
        """Consume n header bytes into ``header_crc`` (a flipped bit in
        @HD/@SQ/@PG is as published as one in a read)."""
        self.header_crc = zlib.crc32(memoryview(self._buf)[:n],
                                     self.header_crc)
        del self._buf[:n]

    def feed(self, data):
        self._buf += data
        buf = self._buf
        while True:
            if self._state == "magic":
                if len(buf) < 8:
                    return
                if bytes(buf[:4]) != BAM_MAGIC:
                    self._fail("decompressed stream does not start with "
                               "the BAM magic")
                self._text_len = int.from_bytes(buf[4:8], "little")
                self._eat_header(8)
                self._state = "text"
            elif self._state == "text":
                if len(buf) < self._text_len + 4:
                    return
                self._refs_left = int.from_bytes(
                    buf[self._text_len:self._text_len + 4], "little")
                self._eat_header(self._text_len + 4)
                self._state = "refs"
            elif self._state == "refs":
                if self._refs_left == 0:
                    self._state = "records"
                    continue
                if len(buf) < 4:
                    return
                l_name = int.from_bytes(buf[:4], "little")
                if len(buf) < 8 + l_name:
                    return
                self._eat_header(8 + l_name)
                self._refs_left -= 1
            else:  # records
                if len(buf) < 4:
                    return
                size = int.from_bytes(buf[:4], "little")
                if len(buf) < 4 + size:
                    return
                if size < 32:
                    self._fail(f"record #{self.records} shorter than the "
                               "fixed BAM record header")
                key = bytes(buf[4:12])
                self.records += 1
                self.content_crc = zlib.crc32(memoryview(buf)[:4 + size],
                                              self.content_crc)
                if self._expect_coord:
                    # the sorter's key: refID unsigned (unmapped last),
                    # pos + 1 (a mapped record at pos -1 sorts first)
                    k = (int.from_bytes(key[:4], "little"),
                         int.from_bytes(key[4:8], "little",
                                        signed=True) + 1)
                    if self._last_key is not None and k < self._last_key:
                        self._fail(
                            f"record #{self.records} out of coordinate "
                            "order in an SO:coordinate file")
                    self._last_key = k
                del buf[:4 + size]

    def finish(self):
        if self._state != "records" or self._buf:
            self._fail("decompressed stream ends mid-structure "
                       f"(state={self._state}, {len(self._buf)} residual "
                       "bytes)")


class BamWriter:
    """Sequential BAM writer over BGZF, committed atomically
    (``utils/atomic.py``): the file appears under its name only on a clean
    close, and leaving the ``with`` block on an exception removes the
    partial output.

    With ``--audit-output`` (and the atomic commit on) the writer tallies
    every record it is handed and, at close, re-walks the finished
    temporary file (each member's CRC32/ISIZE, the BAM structure, the
    record count and the record digest against its tallies) before the
    rename publishes it; a mismatch raises :class:`OutputIntegrityError`
    (exit 5) and nothing is published."""

    def __init__(self, path_or_obj, header: BamHeader,
                 level: int = DEFAULT_COMPRESSION_LEVEL):
        owns = isinstance(path_or_obj, str)
        self._audit = None
        self._audit_coord = False
        self._audit_path = path_or_obj if owns else None
        if owns:
            from ..utils.atomic import open_output

            fileobj = open_output(path_or_obj)
            if audit_output_enabled():
                if hasattr(fileobj, "pre_commit_check"):
                    self._audit = _OutputTally()
                    self._audit_coord = "SO:coordinate" in header.text
                    fileobj.pre_commit_check = self._run_output_audit
                else:
                    logging.getLogger("fgumi_tpu_torch").debug(
                        "--audit-output: atomic commit disabled for %s; "
                        "no pre-rename window to audit in, skipping",
                        path_or_obj)
        else:
            fileobj = path_or_obj
        self._w = BgzfWriter(fileobj, level=level, owns_fileobj=owns)
        try:
            enc = header.encode()
            if self._audit is not None:
                self._audit.header_crc = zlib.crc32(enc)
            self._w.write(enc)
        except BaseException:
            self.discard()
            raise

    def write_record_bytes(self, data: bytes):
        framed = struct.pack("<I", len(data)) + data
        if self._audit is not None:
            self._audit.add_record(framed)
        self._w.write(framed)

    def write_record(self, rec: RawRecord):
        self.write_record_bytes(rec.data)

    def write_serialized(self, blob):
        """Append a run of already block_size-prefixed records."""
        if len(blob):
            if self._audit is not None:
                self._audit.add_serialized(blob)
            self._w.write(blob)

    def write_indexed(self, blob, starts):
        """Append a run of block_size-prefixed records and return the BGZF
        virtual offset of each position in ``starts`` (offsets into
        ``blob``; :meth:`BgzfWriter.write_indexed`)."""
        if self._audit is not None:
            self._audit.add_indexed(blob, starts)
        return self._w.write_indexed(blob, starts)

    def _run_output_audit(self, tmp_path: str):
        """The pre-commit hook: verify the finished temporary file end to
        end; an :class:`OutputIntegrityError` aborts the rename."""
        from ..observe.metrics import METRICS
        from .bgzf import verify_members

        t0 = time.monotonic()
        walker = _BamStreamAudit(tmp_path,
                                 expect_coordinate=self._audit_coord)
        stats = {"members": 0, "data_bytes": 0, "eof_sentinel": False}
        try:
            stats = verify_members(tmp_path, sink=walker.feed)
            walker.finish()
            if not stats["eof_sentinel"]:
                raise OutputIntegrityError("missing BGZF EOF sentinel",
                                           path=tmp_path)
            if walker.header_crc != self._audit.header_crc:
                raise OutputIntegrityError(
                    "BAM header digest mismatch: the header block on disk "
                    "is not the header the writer encoded", path=tmp_path)
            if walker.records != self._audit.records:
                raise OutputIntegrityError(
                    f"record count mismatch: file holds {walker.records}, "
                    f"writer tallied {self._audit.records}", path=tmp_path)
            if walker.content_crc != self._audit.content_crc:
                raise OutputIntegrityError(
                    "record-stream digest mismatch: the record bytes on "
                    "disk are not (in order) the bytes the writer was "
                    "handed", path=tmp_path)
        except OutputIntegrityError as e:
            self._note_audit(self._audit_path, False, stats["members"],
                             walker.records, error=str(e))
            raise
        dt = time.monotonic() - t0
        METRICS.observe("io.output_audit_s", dt)
        self._note_audit(self._audit_path, True, stats["members"],
                         walker.records)
        logging.getLogger("fgumi_tpu_torch").info(
            "output audit: %d BGZF members / %d records verified clean in "
            "%.2fs", stats["members"], walker.records, dt)

    @staticmethod
    def _note_audit(path, ok, members, records, error=None):
        """The verdict to the result sentinel (the run report's and the
        ``stats`` op's ``audit`` section); ops.sentinel imports no torch."""
        from ..ops.sentinel import SENTINEL

        SENTINEL.note_output_audit(path or "", ok, members=members,
                                   records=records, error=error)

    def tell_virtual(self) -> int:
        """BGZF virtual offset of the next record."""
        return self._w.tell_virtual()

    def close(self):
        self._w.close()

    def discard(self):
        """Abandon the output (error path): the temporary file is removed
        and nothing is published. With the atomic commit off the file is
        only closed, as the reference's is (it may be a FIFO or another
        special file)."""
        self._w.discard()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.discard()
