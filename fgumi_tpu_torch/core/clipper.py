"""Record clipping: soft / soft-with-mask / hard CIGAR surgery.

Mirrors crates/fgumi-sam/src/clipper.rs (SamRecordClipper /
RawRecordClipper) and record_utils.rs:
- three modes (ClippingMode, clipper.rs:89-97): soft keeps bases, soft-with-mask
  masks them to N/Q2, hard removes them and converts existing soft clips;
- clip_start/end_of_alignment: consume aligned ops up to the clip point,
  splitting ops at the boundary, swallowing whole insertions at the boundary
  and trailing deletions; unmap the read when no aligned bases would remain
  (clipper.rs:273-455);
- clip_*_of_read: "ensure at least N clipped" semantics counting existing
  clips, upgrading existing clipping when already satisfied (clipper.rs:2205+);
- clip_overlapping_reads: FR pairs only, midpoint of the two 5' ends
  (clipper.rs:673-775);
- clip_extending_past_mate_ends: fgbio numBasesExtendingPastMate against the
  mate's un-soft-clipped span (clipper.rs:784-935);
- upgrade_all_clipping: convert existing soft clips to the configured mode
  (clipper.rs:1264-1450);
- auto-clip extended attributes: per-base tags matching the old read length
  are sliced alongside hard clipping (clip_extended_attributes, clipper.rs:148+).
"""

import struct
from dataclasses import dataclass, field

import numpy as np

from ..constants import reverse_complement_bytes
from ..io.bai import reg2bin as _reg2bin
from ..io.bam import (CIGAR_OPS, FLAG_DUPLICATE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_PROPER_PAIR, FLAG_REVERSE,
                      FLAG_SECONDARY, FLAG_SUPPLEMENTARY, FLAG_UNMAPPED,
                      UNMAPPED_BIN, RawRecord, _skip_tag_value)
from .tag_reversal import TAGS_TO_REVERSE, TAGS_TO_REVERSE_COMPLEMENT

MIN_PHRED = 2

_CONSUMES_READ = frozenset("MI=X")
_CONSUMES_REF = frozenset("MD=XN")
_BASE_TO_NIBBLE = np.full(256, 15, dtype=np.uint8)
for _i, _b in enumerate(b"=ACMGRSVTWYHKDBN"):
    _BASE_TO_NIBBLE[_b] = _i
    _BASE_TO_NIBBLE[ord(chr(_b).lower())] = _i


@dataclass
class MutableRecord:
    """A decoded, mutable BAM record (the Python analog of the reference's
    RecordBuf surgery surface). `aux_entries` holds raw (tag, type_byte,
    value_bytes) TLV entries so tag edits never re-scan the record."""

    name: bytes
    flag: int
    ref_id: int
    pos: int  # 0-based; -1 = unmapped
    mapq: int
    cigar: list  # [(op_char, length)]
    seq: bytes  # ASCII
    quals: bytes
    next_ref_id: int
    next_pos: int
    tlen: int
    aux_entries: list = field(default_factory=list)

    @classmethod
    def from_raw(cls, rec: RawRecord) -> "MutableRecord":
        entries = []
        data = rec.data
        for tag, typ, off in rec._iter_tags():
            end = _skip_tag_value(data, typ, off)
            entries.append((bytes(tag), bytes([typ]), bytes(data[off:end])))
        return cls(name=bytes(rec.name), flag=rec.flag, ref_id=rec.ref_id,
                   pos=rec.pos, mapq=rec.mapq, cigar=rec.cigar(),
                   seq=rec.seq_bytes(), quals=rec.quals().tobytes(),
                   next_ref_id=rec.next_ref_id, next_pos=rec.next_pos,
                   tlen=rec.tlen, aux_entries=entries)

    def encode(self) -> bytes:
        buf = bytearray()
        l_name = len(self.name) + 1
        n = len(self.seq)
        ref_len = sum(ln for op, ln in self.cigar if op in _CONSUMES_REF)
        if self.pos >= 0:
            bin_ = _reg2bin(self.pos, self.pos + (ref_len or 1))
        else:
            bin_ = UNMAPPED_BIN
        buf += struct.pack("<iiBBHHHiiii", self.ref_id, self.pos, l_name,
                           self.mapq, bin_, len(self.cigar), self.flag, n,
                           self.next_ref_id, self.next_pos, self.tlen)
        buf += self.name + b"\x00"
        for op, length in self.cigar:
            buf += struct.pack("<I", (length << 4) | CIGAR_OPS.index(op))
        if n:
            codes = _BASE_TO_NIBBLE[np.frombuffer(self.seq, dtype=np.uint8)]
            if n % 2:
                codes = np.append(codes, 0)
            buf += ((codes[0::2] << 4) | codes[1::2]).astype(np.uint8).tobytes()
            buf += self.quals
        for tag, typ, value in self.aux_entries:
            buf += tag + typ + value
        return bytes(buf)

    # --- aux tag editing over pre-parsed entries ---
    def remove_tag(self, tag: bytes):
        self.aux_entries = [e for e in self.aux_entries if e[0] != tag]

    def set_str_tag(self, tag: bytes, value: bytes):
        self.remove_tag(tag)
        self.aux_entries.append((tag, b"Z", value + b"\x00"))

    def set_int_tag(self, tag: bytes, value: int):
        self.remove_tag(tag)
        self.aux_entries.append((tag, b"i", struct.pack("<i", value)))

    # --- derived geometry ---
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    def reference_length(self) -> int:
        return sum(ln for op, ln in self.cigar if op in _CONSUMES_REF)

    def alignment_end(self) -> int:
        """0-based inclusive reference end."""
        return self.pos + self.reference_length() - 1

    def cigar_string(self) -> str:
        if not self.cigar:
            return "*"
        return "".join(f"{ln}{op}" for op, ln in self.cigar)

    def unsoftclipped_start(self) -> int:
        """0-based start minus leading soft clips only (hard-clipped bases are
        physically absent; record_utils unsoftclipped_start)."""
        pos = self.pos
        for op, ln in self.cigar:
            if op == "H":
                continue
            if op == "S":
                pos -= ln
            break
        return pos

    def unsoftclipped_end(self) -> int:
        end = self.alignment_end()
        for op, ln in reversed(self.cigar):
            if op == "H":
                continue
            if op == "S":
                end += ln
            break
        return end


def _leading(cigar, kind) -> int:
    """Leading hard clip, or soft clip after hard clips."""
    i = 0
    hard = 0
    while i < len(cigar) and cigar[i][0] == "H":
        hard += cigar[i][1]
        i += 1
    if kind == "H":
        return hard
    soft = 0
    while i < len(cigar) and cigar[i][0] == "S":
        soft += cigar[i][1]
        i += 1
    return soft


def read_pos_at_ref_pos(rec: MutableRecord, ref_pos: int,
                        return_last_base_if_deleted: bool = False) -> int:
    """1-based read position at 1-based reference position, 0 if unaligned
    there (record_utils.rs:66-130)."""
    if rec.pos < 0:
        return 0
    read_pos = 0
    ref_cursor = rec.pos + 1  # 1-based
    last_aligned = 0
    for op, ln in rec.cigar:
        if op in "M=X":
            if ref_cursor <= ref_pos < ref_cursor + ln:
                return read_pos + (ref_pos - ref_cursor) + 1
            last_aligned = read_pos + ln
            read_pos += ln
            ref_cursor += ln
        elif op in "IS":
            read_pos += ln
        elif op in "DN":
            if ref_cursor <= ref_pos < ref_cursor + ln:
                return last_aligned if (return_last_base_if_deleted and last_aligned) else 0
            ref_cursor += ln
    return 0


def is_fr_pair(r1: MutableRecord, r2: MutableRecord) -> bool:
    """fgbio isFrPair (record_utils.rs:635-667): paired, both (+ mates) mapped,
    same reference, one forward one reverse, positive 5' < negative 5'."""
    for r in (r1, r2):
        if not r.flag & FLAG_PAIRED or r.flag & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
            return False
    if r1.ref_id != r2.ref_id:
        return False
    if r1.is_reverse() == r2.is_reverse():
        return False
    fwd, rev = (r2, r1) if r1.is_reverse() else (r1, r2)
    # FR iff the positive strand 5' (fwd start) precedes the negative strand 5'
    # (rev alignment end), both 1-based (htsjdk getPairOrientation)
    return fwd.pos + 1 < rev.alignment_end() + 1


def reorient_strand_tags(rec: MutableRecord):
    """Reverse / reverse-complement the strand-sensitive per-base aux tags,
    returning them to read orientation (make_read_unmapped path)."""
    new_entries = []
    for tag, typ, value in rec.aux_entries:
        if tag in TAGS_TO_REVERSE:
            if typ == b"Z":
                value = value[-2::-1] + b"\x00"
            elif typ == b"B":
                sub, n = value[0:1], struct.unpack("<I", value[1:5])[0]
                size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4, b"I": 4,
                        b"f": 4}[sub]
                body = value[5:5 + n * size]
                rev = b"".join(body[i * size:(i + 1) * size]
                               for i in reversed(range(n)))
                value = sub + value[1:5] + rev
        elif tag in TAGS_TO_REVERSE_COMPLEMENT and typ == b"Z":
            value = reverse_complement_bytes(value[:-1]) + b"\x00"
        new_entries.append((tag, typ, value))
    rec.aux_entries = new_entries


class RecordClipper:
    """Clipping engine; `mode` is 'soft' | 'soft-with-mask' | 'hard'."""

    def __init__(self, mode: str = "hard", auto_clip_attributes: bool = False):
        if mode not in ("soft", "soft-with-mask", "hard"):
            raise ValueError(f"unknown clipping mode {mode!r}")
        self.mode = mode
        self.auto_clip_attributes = auto_clip_attributes

    # ------------------------------------------------------------------
    @staticmethod
    def number_of_clippable_bases(rec: MutableRecord) -> int:
        return sum(ln for op, ln in rec.cigar if op in _CONSUMES_READ)

    @staticmethod
    def make_read_unmapped(rec: MutableRecord):
        """htsjdk SAMUtils.makeReadUnmapped (clipper.rs:205-255)."""
        if rec.is_reverse():
            rec.seq = reverse_complement_bytes(rec.seq)
            rec.quals = rec.quals[::-1]
            reorient_strand_tags(rec)
        rec.flag &= ~(FLAG_REVERSE | FLAG_DUPLICATE | FLAG_SECONDARY |
                      FLAG_SUPPLEMENTARY | FLAG_PROPER_PAIR)
        rec.flag |= FLAG_UNMAPPED
        rec.ref_id = -1
        rec.pos = -1
        rec.mapq = 0
        rec.tlen = 0
        rec.cigar = []

    def _clip_extended_attributes(self, rec: MutableRecord, remove: int,
                                  from_start: bool):
        """Hard mode + auto-clip: slice per-base tags whose length matches the
        pre-clip read length (clipper.rs:148-196)."""
        if self.mode != "hard" or remove == 0 or not self.auto_clip_attributes:
            return
        new_length = len(rec.seq)
        old_length = new_length + remove
        start, end = (remove, old_length) if from_start else (0, new_length)
        new_entries = []
        for tag, typ, value in rec.aux_entries:
            if typ == b"Z" and len(value) - 1 == old_length:
                value = value[start:end] + b"\x00"
            elif typ == b"B":
                sub = value[0:1]
                n = struct.unpack("<I", value[1:5])[0]
                if n == old_length:
                    size = {b"c": 1, b"C": 1, b"s": 2, b"S": 2, b"i": 4,
                            b"I": 4, b"f": 4}[sub]
                    body = value[5:]
                    value = (sub + struct.pack("<I", end - start)
                             + body[start * size:end * size])
            new_entries.append((tag, typ, value))
        rec.aux_entries = new_entries

    # ------------------------------------------------------------------
    def clip_start_of_alignment(self, rec: MutableRecord, bases_to_clip: int) -> int:
        """clipper.rs:273-455. Returns read bases newly clipped."""
        if bases_to_clip == 0 or rec.is_unmapped() or not rec.seq:
            return 0
        num_clippable = self.number_of_clippable_bases(rec)
        if num_clippable <= bases_to_clip:
            self.make_read_unmapped(rec)
            return num_clippable

        ops = rec.cigar
        existing_hard = _leading(ops, "H")
        existing_soft = _leading(ops, "S")
        i = 0
        while i < len(ops) and ops[i][0] in "HS":
            i += 1
        post = ops[i:]

        read_clipped = 0
        ref_clipped = 0
        new_ops = []
        j = 0
        while (read_clipped < bases_to_clip
               or (read_clipped == bases_to_clip and not new_ops
                   and j < len(post) and post[j][0] == "D")):
            if j >= len(post):
                break
            op, ln = post[j]
            j += 1
            consumes_read = op in _CONSUMES_READ
            consumes_ref = op in "M=XD"
            if consumes_read and ln > bases_to_clip - read_clipped:
                if op == "I":
                    read_clipped += ln  # swallow whole insertion at boundary
                else:
                    remaining_clip = bases_to_clip - read_clipped
                    read_clipped += remaining_clip
                    ref_clipped += remaining_clip
                    new_ops.append((op, ln - remaining_clip))
            else:
                if consumes_read:
                    read_clipped += ln
                if consumes_ref:
                    ref_clipped += ln
        new_ops.extend(post[j:])

        if self.mode == "hard":
            added_hard = existing_soft + read_clipped
            final = [("H", existing_hard + added_hard)] + new_ops
            bases_to_remove = added_hard
        else:
            final = []
            if existing_hard:
                final.append(("H", existing_hard))
            final.append(("S", existing_soft + read_clipped))
            final += new_ops
            bases_to_remove = 0
        rec.cigar = final
        if ref_clipped:
            rec.pos += ref_clipped
        if self.mode == "soft-with-mask":
            total_soft = existing_soft + read_clipped
            k = min(total_soft, len(rec.seq))
            rec.seq = b"N" * k + rec.seq[k:]
            rec.quals = bytes([MIN_PHRED]) * k + rec.quals[k:]
        elif self.mode == "hard":
            rec.seq = rec.seq[bases_to_remove:]
            rec.quals = rec.quals[bases_to_remove:]
            self._clip_extended_attributes(rec, bases_to_remove, True)
        return read_clipped

    def clip_end_of_alignment(self, rec: MutableRecord, bases_to_clip: int) -> int:
        """Symmetric counterpart (clipper.rs:456-628)."""
        if bases_to_clip == 0 or rec.is_unmapped() or not rec.seq:
            return 0
        num_clippable = self.number_of_clippable_bases(rec)
        if num_clippable <= bases_to_clip:
            self.make_read_unmapped(rec)
            return num_clippable

        ops = rec.cigar[::-1]  # work on reversed ops
        existing_hard = _leading(ops, "H")
        existing_soft = _leading(ops, "S")
        i = 0
        while i < len(ops) and ops[i][0] in "HS":
            i += 1
        post = ops[i:]

        read_clipped = 0
        new_ops = []
        j = 0
        while (read_clipped < bases_to_clip
               or (read_clipped == bases_to_clip and not new_ops
                   and j < len(post) and post[j][0] == "D")):
            if j >= len(post):
                break
            op, ln = post[j]
            j += 1
            consumes_read = op in _CONSUMES_READ
            if consumes_read and ln > bases_to_clip - read_clipped:
                if op == "I":
                    read_clipped += ln
                else:
                    remaining_clip = bases_to_clip - read_clipped
                    read_clipped += remaining_clip
                    new_ops.append((op, ln - remaining_clip))
            else:
                if consumes_read:
                    read_clipped += ln
        new_ops.extend(post[j:])

        if self.mode == "hard":
            added_hard = existing_soft + read_clipped
            final_rev = [("H", existing_hard + added_hard)] + new_ops
            bases_to_remove = added_hard
        else:
            final_rev = []
            if existing_hard:
                final_rev.append(("H", existing_hard))
            final_rev.append(("S", existing_soft + read_clipped))
            final_rev += new_ops
            bases_to_remove = 0
        rec.cigar = final_rev[::-1]
        if self.mode == "soft-with-mask":
            total_soft = existing_soft + read_clipped
            k = min(total_soft, len(rec.seq))
            cut = len(rec.seq) - k
            rec.seq = rec.seq[:cut] + b"N" * k
            rec.quals = rec.quals[:cut] + bytes([MIN_PHRED]) * k
        elif self.mode == "hard":
            keep = len(rec.seq) - bases_to_remove
            rec.seq = rec.seq[:keep]
            rec.quals = rec.quals[:keep]
            self._clip_extended_attributes(rec, bases_to_remove, False)
        return read_clipped

    def clip_5_prime_end_of_alignment(self, rec, n):
        return (self.clip_end_of_alignment(rec, n) if rec.is_reverse()
                else self.clip_start_of_alignment(rec, n))

    def clip_3_prime_end_of_alignment(self, rec, n):
        return (self.clip_start_of_alignment(rec, n) if rec.is_reverse()
                else self.clip_end_of_alignment(rec, n))

    # --- "ensure at least N clipped" read-level entry points ---
    def clip_start_of_read(self, rec: MutableRecord, clip_length: int) -> int:
        existing = 0
        for op, ln in rec.cigar:
            if op in "SH":
                existing += ln
            else:
                break
        if clip_length > existing:
            return self.clip_start_of_alignment(rec, clip_length - existing)
        self._upgrade_clipping(rec, clip_length, True)
        return 0

    def clip_end_of_read(self, rec: MutableRecord, clip_length: int) -> int:
        existing = 0
        for op, ln in reversed(rec.cigar):
            if op in "SH":
                existing += ln
            else:
                break
        if clip_length > existing:
            return self.clip_end_of_alignment(rec, clip_length - existing)
        self._upgrade_clipping(rec, clip_length, False)
        return 0

    def clip_5_prime_end_of_read(self, rec, n):
        return (self.clip_end_of_read(rec, n) if rec.is_reverse()
                else self.clip_start_of_read(rec, n))

    def clip_3_prime_end_of_read(self, rec, n):
        return (self.clip_start_of_read(rec, n) if rec.is_reverse()
                else self.clip_end_of_read(rec, n))

    # --- clipping upgrades ---
    def _upgrade_clipping(self, rec: MutableRecord, length: int, from_start: bool):
        """clipper.rs:1028-1155: upgrade up to `length` existing clipped bases
        to the configured (more stringent) mode."""
        if self.mode == "soft" or length == 0:
            return
        ops = rec.cigar if from_start else rec.cigar[::-1]
        hard_clipped = _leading(ops, "H")
        soft_clipped = _leading(ops, "S")
        if hard_clipped >= length or soft_clipped == 0:
            return
        to_upgrade = min(soft_clipped, length - hard_clipped)

        if self.mode == "hard":
            i = 0
            while i < len(ops) and ops[i][0] in "HS":
                i += 1
            new_ops = [("H", hard_clipped + to_upgrade)]
            if soft_clipped > to_upgrade:
                new_ops.append(("S", soft_clipped - to_upgrade))
            new_ops.extend(ops[i:])
            rec.cigar = new_ops if from_start else new_ops[::-1]
            if from_start:
                rec.seq = rec.seq[to_upgrade:]
                rec.quals = rec.quals[to_upgrade:]
            else:
                keep = len(rec.seq) - to_upgrade
                rec.seq = rec.seq[:keep]
                rec.quals = rec.quals[:keep]
            self._clip_extended_attributes(rec, to_upgrade, from_start)
        else:  # soft-with-mask
            if from_start:
                rec.seq = b"N" * to_upgrade + rec.seq[to_upgrade:]
                rec.quals = bytes([MIN_PHRED]) * to_upgrade + rec.quals[to_upgrade:]
            else:
                keep = len(rec.seq) - to_upgrade
                rec.seq = rec.seq[:keep] + b"N" * to_upgrade
                rec.quals = rec.quals[:keep] + bytes([MIN_PHRED]) * to_upgrade

    def upgrade_all_clipping(self, rec: MutableRecord):
        """Convert all existing soft clipping to the configured mode
        (clipper.rs:1264-1450). Returns (leading, trailing) upgraded counts."""
        if self.mode == "soft" or rec.is_unmapped():
            return (0, 0)
        if not any(op == "S" for op, _ in rec.cigar):
            return (0, 0)
        leading_hard = _leading(rec.cigar, "H")
        leading_soft = _leading(rec.cigar, "S")
        rev = rec.cigar[::-1]
        trailing_hard = _leading(rev, "H")
        trailing_soft = _leading(rev, "S")
        if leading_soft:
            self._upgrade_clipping(rec, leading_hard + leading_soft, True)
        if trailing_soft:
            self._upgrade_clipping(rec, trailing_hard + trailing_soft, False)
        return (leading_soft, trailing_soft)

    # --- pairwise clipping ---
    def _query_bases_for_ref_region(self, rec: MutableRecord, ref_bases: int,
                                    from_start: bool) -> int:
        """clipper.rs:963-1012."""
        remaining_ref = ref_bases
        query = 0
        ops = rec.cigar if from_start else rec.cigar[::-1]
        for op, ln in ops:
            if remaining_ref == 0:
                break
            consumes_ref = op in "M=XD"
            consumes_query = op in _CONSUMES_READ
            if consumes_ref:
                consumed = min(ln, remaining_ref)
                remaining_ref -= consumed
                if consumes_query:
                    query += consumed
            elif consumes_query and remaining_ref > 0:
                query += ln  # insertion inside the region
        return query

    def clip_overlapping_reads(self, r1: MutableRecord, r2: MutableRecord):
        """FR midpoint overlap clipping (clipper.rs:673-775).
        Returns (clipped_r1, clipped_r2) in the caller's argument order."""
        if not is_fr_pair(r1, r2):
            return (0, 0)
        swapped = r1.is_reverse()
        fwd, rev = (r2, r1) if swapped else (r1, r2)
        if fwd.pos < 0 or rev.pos < 0:
            return (0, 0)
        f_start, f_end = fwd.pos + 1, fwd.pos + fwd.reference_length()
        r_start, r_end = rev.pos + 1, rev.pos + rev.reference_length()
        if max(f_start, r_start) > min(f_end, r_end):
            return (0, 0)
        midpoint = (f_start + r_end) // 2
        if midpoint > f_end:
            midpoint = f_end
        elif midpoint < r_start:
            midpoint = max(r_start - 1, 0)
        f_clip = (self._query_bases_for_ref_region(fwd, f_end - midpoint, False)
                  if f_end > midpoint else 0)
        r_clip = (self._query_bases_for_ref_region(rev, midpoint + 1 - r_start, True)
                  if midpoint + 1 > r_start else 0)
        clipped_f = self.clip_end_of_alignment(fwd, f_clip) if f_clip else 0
        clipped_r = self.clip_start_of_alignment(rev, r_clip) if r_clip else 0
        if self.mode == "hard":
            self.upgrade_all_clipping(fwd)
            self.upgrade_all_clipping(rev)
        return (clipped_r, clipped_f) if swapped else (clipped_f, clipped_r)

    @staticmethod
    def num_bases_extending_past_mate(rec: MutableRecord,
                                      mate_unclipped_start: int,
                                      mate_unclipped_end: int) -> int:
        """fgbio numBasesExtendingPastMate (clipper.rs:784-870); positions are
        1-based."""
        read_length = sum(ln for op, ln in rec.cigar if op in "M=XIS")
        if rec.pos < 0:
            return 0
        if not rec.is_reverse():
            alignment_end = rec.pos + 1 + max(rec.reference_length() - 1, 0)
            if alignment_end >= mate_unclipped_end:
                pos_at = read_pos_at_ref_pos(rec, mate_unclipped_end, False)
                return max(read_length - pos_at, 0)
            trailing_soft = _leading(rec.cigar[::-1], "S")
            gap = mate_unclipped_end - alignment_end
            return max(trailing_soft - gap, 0)
        alignment_start = rec.pos + 1
        if alignment_start > mate_unclipped_start:
            leading_soft = _leading(rec.cigar, "S")
            gap = alignment_start - mate_unclipped_start
            return max(leading_soft - gap, 0)
        pos_at = read_pos_at_ref_pos(rec, mate_unclipped_start, False)
        return max(pos_at - 1, 0)

    def _clip_single_extending(self, rec: MutableRecord, mate_start: int,
                               mate_end: int) -> int:
        n = self.num_bases_extending_past_mate(rec, mate_start, mate_end)
        if n == 0:
            return 0
        if not rec.is_reverse():
            return self.clip_end_of_read(rec, n)
        return self.clip_start_of_read(rec, n)

    def clip_extending_past_mate_ends(self, r1: MutableRecord, r2: MutableRecord):
        """clipper.rs:873-935. Returns (clipped_r1, clipped_r2)."""
        if not is_fr_pair(r1, r2):
            return (0, 0)
        r1_span = (r1.unsoftclipped_start() + 1, r1.unsoftclipped_end() + 1)
        r2_span = (r2.unsoftclipped_start() + 1, r2.unsoftclipped_end() + 1)
        clipped_r1 = self._clip_single_extending(r1, r2_span[0], r2_span[1])
        clipped_r2 = self._clip_single_extending(r2, r1_span[0], r1_span[1])
        return (clipped_r1, clipped_r2)


def clipped_bases(rec: MutableRecord) -> int:
    return sum(ln for op, ln in rec.cigar if op in "SH")
