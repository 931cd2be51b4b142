"""In-place edits on raw BAM record bytes (bytearray).

The port's copy of fgumi_tpu/core/record_edit.py (the reference's raw-record
mutators, fgumi-raw-bam: set_* fixed-offset writers, aux TLV editing,
reg2bin). Every function takes the record's wire bytes as a bytearray (no
block_size prefix) and edits in place; :class:`TagEditor` stages aux edits
and rebuilds the record once.
"""

import struct

from ..io.bai import reg2bin as _reg2bin
from ..io.bam import RawRecord, _read_tag_value, _skip_tag_value


def set_flags(buf: bytearray, flags: int):
    buf[14:16] = struct.pack("<H", flags)


def set_ref_id(buf: bytearray, ref_id: int):
    buf[0:4] = struct.pack("<i", ref_id)


def set_pos(buf: bytearray, pos: int):
    buf[4:8] = struct.pack("<i", pos)


def set_mate_ref_id(buf: bytearray, ref_id: int):
    buf[20:24] = struct.pack("<i", ref_id)


def set_mate_pos(buf: bytearray, pos: int):
    buf[24:28] = struct.pack("<i", pos)


def set_tlen(buf: bytearray, tlen: int):
    buf[28:32] = struct.pack("<i", tlen)


def set_bin(buf: bytearray):
    """Recompute the BAM bin from pos + reference length."""
    rec = RawRecord(bytes(buf))
    pos = rec.pos
    if pos < 0:
        b = _reg2bin(-1, 0)
    else:
        ref_len = rec.reference_length() or 1
        b = _reg2bin(pos, pos + ref_len)
    buf[10:12] = struct.pack("<H", b)


def cigar_string(rec: RawRecord) -> str:
    ops = rec.cigar()
    if not ops:
        return "*"
    return "".join(f"{n}{op}" for op, n in ops)


def raw_tag_entries(rec: RawRecord):
    """[(tag, type_byte, value_bytes)] for every aux tag, pre-encoded."""
    out = []
    for tag, typ, off in rec._iter_tags():
        end = _skip_tag_value(rec.data, typ, off)
        out.append((tag, typ, rec.data[off:end]))
    return out


class TagEditor:
    """Single-pass aux-tag editor for one record's wire bytes.

    The TLV region parses once; removals and updates stage against the
    parsed entries plus staged appends, and finish() rebuilds the record in
    one concatenation. Fixed-field edits go directly to the underlying
    bytearray; the prefix (header/name/cigar/seq/qual) is copied verbatim
    at finish time.

    Removals drop every original occurrence, updates re-append at the end,
    and find() returns the first surviving original, else the first staged
    append: what find_tag would see on the rebuilt record.
    """

    __slots__ = ("buf", "aux0", "entries", "_removed", "_appends")

    def __init__(self, buf: bytearray):
        self.buf = buf
        l_read_name = buf[8]
        n_cigar = int.from_bytes(buf[12:14], "little")
        l_seq = int.from_bytes(buf[16:20], "little")
        self.aux0 = 32 + l_read_name + 4 * n_cigar + (l_seq + 1) // 2 + l_seq
        entries = []
        off = self.aux0
        end = len(buf)
        while off + 3 <= end:
            tag = bytes(buf[off:off + 2])
            typ = buf[off + 2]
            nxt = _skip_tag_value(buf, typ, off + 3)
            entries.append((tag, typ, off, nxt))
            off = nxt
        self.entries = entries
        self._removed = set()
        self._appends = []  # (tag, typ_byte, value_bytes)

    def find(self, tag: bytes):
        """(type_char, python value) like RawRecord.find_tag, or None."""
        for t, typ, off, _nxt in self.entries:
            if t == tag and t not in self._removed:
                return chr(typ), _read_tag_value(self.buf, typ, off + 3)
        for t, typ, vb in self._appends:
            if t == tag:
                return chr(typ), _read_tag_value(vb, typ, 0)
        return None

    def get_int(self, tag: bytes):
        got = self.find(tag)
        if got is None or got[0] not in "cCsSiI":
            return None
        return int(got[1])

    def remove(self, tag: bytes):
        self._removed.add(tag)
        self._appends = [a for a in self._appends if a[0] != tag]

    def append_entry(self, tag: bytes, typ: int, value_bytes: bytes):
        self._appends.append((tag, typ, value_bytes))

    def set_i32(self, tag: bytes, value: int):
        self.remove(tag)
        self.append_entry(tag, ord("i"), struct.pack("<i", value))

    def set_str(self, tag: bytes, value: bytes):
        self.remove(tag)
        self.append_entry(tag, ord("Z"), value + b"\x00")

    def set_i32_array(self, tag: bytes, values):
        self.remove(tag)
        self.append_entry(
            tag, ord("B"),
            b"i" + struct.pack("<I", len(values))
            + b"".join(struct.pack("<i", v) for v in values))

    def normalize_int_smallest(self, tag: bytes):
        """AS/XS smallest-signed-type normalization: the tag is always
        removed and re-appended at the end, even when already smallest
        (reference tags.rs:995-1001 removes + re-appends unconditionally,
        so tag ORDER must shift too)."""
        got = self.find(tag)
        if got is None or got[0] not in "cCsSiI":
            return
        value = int(got[1])
        if not -(2**31) <= value < 2**31:
            return
        self.remove(tag)
        if -128 <= value <= 127:
            self.append_entry(tag, ord("c"), struct.pack("<b", value))
        elif -32768 <= value <= 32767:
            self.append_entry(tag, ord("s"), struct.pack("<h", value))
        else:
            self.append_entry(tag, ord("i"), struct.pack("<i", value))

    def finish(self) -> bytes:
        buf = self.buf
        parts = [bytes(buf[:self.aux0])]
        for tag, typ, off, nxt in self.entries:
            if tag in self._removed:
                continue
            parts.append(bytes(buf[off:nxt]))
        for tag, typ, vb in self._appends:
            parts.append(tag + bytes([typ]) + vb)
        return b"".join(parts)
