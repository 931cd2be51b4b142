"""zipper: merge an aligner's output BAM with the original unmapped BAM.

The port's copy of fgumi_tpu/commands/zipper.py, the per-template engine
(``zipper --classic``) and the semantics the batch engine
(commands/fast_zipper.py) is held to; the reference is fgumi's zipper.rs.
Both inputs must be queryname-sorted/grouped with identical
ordering. Per template: fix mate info (MC/MQ/ms, TLEN), remove requested tags,
copy all tags from the unmapped primaries onto the matching mapped records
(reverse / reverse-complement per-base tags on negative-strand reads), transfer
the QC-fail flag, normalize AS/XS to the smallest signed int type, and add a
``tc`` template-coordinate tag (B:i array) to secondary/supplementary records.
"""

from dataclasses import dataclass, field

from ..core.record_edit import (TagEditor, cigar_string, raw_tag_entries,
                                set_bin, set_flags, set_mate_pos,
                                set_mate_ref_id, set_pos, set_ref_id,
                                set_tlen)
from ..core.tag_reversal import (TAGS_TO_REVERSE, TAGS_TO_REVERSE_COMPLEMENT,
                                 revcomp_tag_value_at, reverse_tag_value_at)
from ..core.template import iter_name_groups, unclipped_5prime
from ..io.bam import (FLAG_FIRST, FLAG_MATE_REVERSE, FLAG_MATE_UNMAPPED,
                      FLAG_PAIRED, FLAG_QC_FAIL, FLAG_REVERSE, FLAG_SECONDARY,
                      FLAG_SUPPLEMENTARY, FLAG_UNMAPPED, RawRecord)

# The "Consensus" named tag set (umi TagSets; tag_reversal.rs:88-90), derived
# from the canonical byte constants in core.tag_reversal.
CONSENSUS_REVERSE_TAGS = tuple(t.decode() for t in TAGS_TO_REVERSE)
CONSENSUS_REVCOMP_TAGS = tuple(t.decode() for t in TAGS_TO_REVERSE_COMPLEMENT)


@dataclass
class TagInfo:
    remove: set = field(default_factory=set)
    reverse: set = field(default_factory=set)
    revcomp: set = field(default_factory=set)

    @classmethod
    def from_options(cls, remove=(), reverse=(), revcomp=()):
        def expand(names, consensus):
            out = set()
            for n in names:
                if n == "Consensus":
                    out.update(consensus)
                else:
                    out.add(n)
            return out

        return cls(remove=expand(remove, ()),
                   reverse=expand(reverse, CONSENSUS_REVERSE_TAGS),
                   revcomp=expand(revcomp, CONSENSUS_REVCOMP_TAGS))


@dataclass
class MappedTemplate:
    """One QNAME's mapped records as mutable bytearrays, classified."""
    name: bytes
    bufs: list  # bytearray per record, input order
    r1: int | None = None  # index of primary R1 (or fragment)
    r2: int | None = None
    r1_others: list = field(default_factory=list)  # secondary/supp of R1/fragment
    r2_others: list = field(default_factory=list)
    r1_supplementals: list = field(default_factory=list)
    r2_supplementals: list = field(default_factory=list)

    @classmethod
    def from_records(cls, name, records):
        t = cls(name=name, bufs=[bytearray(r.data) for r in records])
        for i, rec in enumerate(records):
            flg = rec.flag
            first = (not flg & FLAG_PAIRED) or bool(flg & FLAG_FIRST)
            if flg & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY):
                (t.r1_others if first else t.r2_others).append(i)
                if flg & FLAG_SUPPLEMENTARY:
                    (t.r1_supplementals if first
                     else t.r2_supplementals).append(i)
            elif first:
                t.r1 = i
            else:
                t.r2 = i
        return t


def _flag(buf) -> int:
    return int.from_bytes(buf[14:16], "little")


def _rec(buf) -> RawRecord:
    return RawRecord(bytes(buf))


def _set_mate_flags(buf, mate_reverse: bool, mate_unmapped: bool):
    f = _flag(buf) & ~(FLAG_MATE_REVERSE | FLAG_MATE_UNMAPPED)
    if mate_reverse:
        f |= FLAG_MATE_REVERSE
    if mate_unmapped:
        f |= FLAG_MATE_UNMAPPED
    set_flags(buf, f)


def _insert_size(rec1: RawRecord, rec2: RawRecord) -> int:
    """TLEN via 5'-to-5' distance (template.rs:819-851, htsjdk convention)."""
    if rec1.flag & FLAG_UNMAPPED or rec2.flag & FLAG_UNMAPPED:
        return 0
    if rec1.ref_id != rec2.ref_id:
        return 0
    pos1, pos2 = rec1.pos + 1, rec2.pos + 1
    end1 = pos1 + rec1.reference_length() - 1
    end2 = pos2 + rec2.reference_length() - 1
    first_5p = end1 if rec1.flag & FLAG_REVERSE else pos1
    second_5p = end2 if rec2.flag & FLAG_REVERSE else pos2
    adjustment = 1 if second_5p >= first_5p else -1
    return second_5p - first_5p + adjustment


def _as_tag(rec: RawRecord):
    return rec.get_int(b"AS")


def _set_mate_from(buf, ed: TagEditor, mate: RawRecord, tlen=None):
    """Write mate ref/pos/flags/MQ/MC from `mate` onto `buf`/its editor."""
    set_mate_ref_id(buf, mate.ref_id)
    set_mate_pos(buf, mate.pos)
    mate_unmapped = bool(mate.flag & FLAG_UNMAPPED)
    _set_mate_flags(buf, bool(mate.flag & FLAG_REVERSE), mate_unmapped)
    ed.set_i32(b"MQ", mate.mapq)
    cig = cigar_string(mate)
    if cig != "*" and not mate_unmapped:
        ed.set_str(b"MC", cig.encode())
    else:
        ed.remove(b"MC")
    if tlen is not None:
        set_tlen(buf, tlen)


def fix_mate_info(t: MappedTemplate, editors=None):
    """template.rs:459-605: primary pair mate pointers, MQ/MC/ms tags, TLEN,
    and supplementals pointing at the opposite primary. With editors=None
    (standalone use) the staged aux edits apply back into t.bufs."""
    standalone = editors is None
    if standalone:
        editors = [TagEditor(buf) for buf in t.bufs]
    if t.r1 is not None and t.r2 is not None:
        b1, b2 = t.bufs[t.r1], t.bufs[t.r2]
        e1, e2 = editors[t.r1], editors[t.r2]
        r1, r2 = _rec(b1), _rec(b2)
        r1_unmapped = bool(r1.flag & FLAG_UNMAPPED)
        r2_unmapped = bool(r2.flag & FLAG_UNMAPPED)
        r1_as, r2_as = _as_tag(r1), _as_tag(r2)
        if not r1_unmapped and not r2_unmapped:
            tlen = _insert_size(r1, r2)
            _set_mate_from(b1, e1, r2, tlen)
            _set_mate_from(b2, e2, r1, -tlen)
        elif r1_unmapped and r2_unmapped:
            for b, ed, other in ((b1, e1, r2), (b2, e2, r1)):
                set_ref_id(b, -1)
                set_pos(b, -1)
                set_mate_ref_id(b, -1)
                set_mate_pos(b, -1)
                _set_mate_flags(b, bool(other.flag & FLAG_REVERSE), True)
                ed.remove(b"MQ")
                ed.remove(b"MC")
                set_tlen(b, 0)
                set_bin(b)  # POS moved to -1: bin must be reg2bin(-1,0)=4680
        else:
            mapped_i, unmapped_i = ((t.r2, t.r1) if r1_unmapped
                                    else (t.r1, t.r2))
            mapped_b, unmapped_b = t.bufs[mapped_i], t.bufs[unmapped_i]
            mapped = _rec(mapped_b)
            unmapped = _rec(unmapped_b)
            # place the unmapped read at its mate's coordinates
            set_ref_id(unmapped_b, mapped.ref_id)
            set_pos(unmapped_b, mapped.pos)
            set_mate_ref_id(mapped_b, mapped.ref_id)
            set_mate_pos(mapped_b, mapped.pos)
            _set_mate_flags(mapped_b, bool(unmapped.flag & FLAG_REVERSE), True)
            editors[mapped_i].remove(b"MQ")
            editors[mapped_i].remove(b"MC")
            set_tlen(mapped_b, 0)
            _set_mate_from(unmapped_b, editors[unmapped_i], mapped, 0)
            set_bin(unmapped_b)
        # ms (mate score) from the mate's AS, both cases
        if r2_as is not None:
            e1.set_i32(b"ms", int(r2_as))
        if r1_as is not None:
            e2.set_i32(b"ms", int(r1_as))

    # Supplementals point at the opposite primary (template.rs:513-605).
    for supp_list, primary_i in ((t.r1_supplementals, t.r2),
                                 (t.r2_supplementals, t.r1)):
        if primary_i is None or not supp_list:
            continue
        pbuf = t.bufs[primary_i]
        primary = _rec(pbuf)
        p_tlen = primary.tlen
        p_as = _as_tag(primary)
        for i in supp_list:
            _set_mate_from(t.bufs[i], editors[i], primary, -p_tlen)
            if p_as is not None:
                editors[i].set_i32(b"ms", int(p_as))
    if standalone:
        for i, ed in enumerate(editors):
            t.bufs[i][:] = ed.finish()


def add_template_coordinate_tags(t: MappedTemplate, editors=None):
    """tc tag (B:i [tid1,pos1,neg1,tid2,pos2,neg2], lower coordinate first) on
    secondary/supplementary records only (zipper.rs:281-357). With
    editors=None (standalone use) the edits apply back into t.bufs."""
    others = t.r1_others + t.r2_others
    if not others:
        return
    standalone = editors is None
    if standalone:
        others_set = set(others)
        editors = [TagEditor(t.bufs[i]) if i in others_set else None
                   for i in range(len(t.bufs))]

    def info(i):
        if i is None:
            return None
        rec = _rec(t.bufs[i])
        if rec.flag & FLAG_UNMAPPED:
            return None
        return (rec.ref_id, unclipped_5prime(rec),
                1 if rec.flag & FLAG_REVERSE else 0)

    i1, i2 = info(t.r1), info(t.r2)
    if i1 is not None and i2 is not None:
        a, b = (i1, i2) if (i1[0], i1[1]) <= (i2[0], i2[1]) else (i2, i1)
    elif i1 is not None or i2 is not None:
        a = b = i1 if i1 is not None else i2
    else:
        return
    values = [a[0], a[1], a[2], b[0], b[1], b[2]]
    for i in others:
        editors[i].set_i32_array(b"tc", values)
    if standalone:
        for i in others:
            t.bufs[i][:] = editors[i].finish()


def merge_template(unmapped_records, t: MappedTemplate, tag_info: TagInfo,
                   skip_tc_tags: bool = False):
    """Transfer tags/flags from an unmapped template onto the mapped one
    (zipper.rs merge_raw:397-545). Returns the rebuilt record bytes (one
    aux-region rebuild per record via TagEditor)."""
    editors = [TagEditor(buf) for buf in t.bufs]
    fix_mate_info(t, editors)

    for ed in editors:
        for tag in tag_info.remove:
            if len(tag) == 2:
                ed.remove(tag.encode())

    primaries = [r for r in unmapped_records
                 if not r.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY)]
    for u in primaries:
        u_flags = u.flag
        is_unpaired = not u_flags & FLAG_PAIRED
        is_first = bool(u_flags & FLAG_FIRST)
        if is_unpaired or is_first:
            indices = ([t.r1] if t.r1 is not None else []) + t.r1_others
        else:
            indices = ([t.r2] if t.r2 is not None else []) + t.r2_others
        u_tags = [(tag, typ, vb) for tag, typ, vb in raw_tag_entries(u)
                  if tag.decode(errors="replace") not in tag_info.remove]
        for i in indices:
            ed = editors[i]
            has_pg = ed.find(b"PG") is not None
            negative = bool(_flag(t.bufs[i]) & FLAG_REVERSE)
            for entry in u_tags:
                tag, typ, vb = entry
                if tag == b"PG" and has_pg:
                    continue
                ed.remove(tag)
                if negative:
                    tag_str = tag.decode(errors="replace")
                    if tag_str in tag_info.reverse:
                        vb = bytearray(vb)
                        reverse_tag_value_at(vb, typ, 0)
                        vb = bytes(vb)
                    elif tag_str in tag_info.revcomp:
                        vb = bytearray(vb)
                        revcomp_tag_value_at(vb, typ, 0)
                        vb = bytes(vb)
                ed.append_entry(tag, typ, vb)
        # QC pass/fail transfer
        qc_fail = bool(u_flags & FLAG_QC_FAIL)
        for i in indices:
            f = _flag(t.bufs[i])
            f = (f | FLAG_QC_FAIL) if qc_fail else (f & ~FLAG_QC_FAIL)
            set_flags(t.bufs[i], f)

    for ed in editors:
        ed.normalize_int_smallest(b"AS")
        ed.normalize_int_smallest(b"XS")

    if not skip_tc_tags:
        add_template_coordinate_tags(t, editors)
    return [ed.finish() for ed in editors]


def run_zipper(mapped_reader, unmapped_reader, writer, tag_info: TagInfo, *,
               skip_tc_tags: bool = False, exclude_missing_reads: bool = False,
               restore_unconverted=None):
    """Lockstep merge by QNAME. Returns (templates, records_out, missing).

    Both inputs must share queryname ordering. An unmapped template absent from
    the mapped BAM (aligner dropped it) is written through as unmapped records,
    or dropped under exclude_missing_reads (zipper.rs:896-928); a mapped
    template absent from the unmapped BAM is always an error (the unmapped BAM
    is the source of truth).
    """
    mapped_groups = iter_name_groups(mapped_reader)
    n_templates = 0
    n_records = 0
    n_missing = 0
    mapped_item = next(mapped_groups, None)
    for u_name, u_records in iter_name_groups(unmapped_reader):
        if mapped_item is None or mapped_item[0] != u_name:
            # aligner omitted this template: write it through as unmapped
            # records (zipper.rs:896-928), or drop under exclude_missing_reads
            n_missing += 1
            if not exclude_missing_reads:
                for rec in u_records:
                    writer.write_record_bytes(rec.data)
                    n_records += 1
                n_templates += 1
            continue
        t = MappedTemplate.from_records(mapped_item[0], mapped_item[1])
        out_bytes = merge_template(u_records, t, tag_info, skip_tc_tags)
        for data in out_bytes:
            if restore_unconverted is not None:
                data = restore_unconverted_bases_record(
                    data, restore_unconverted[0], restore_unconverted[1])
            writer.write_record_bytes(data)
            n_records += 1
        n_templates += 1
        mapped_item = next(mapped_groups, None)
    if mapped_item is not None:
        raise ValueError(
            f"read '{mapped_item[0].decode(errors='replace')}' present in the "
            "mapped BAM but not in the unmapped BAM; inputs must share "
            "queryname ordering")
    return n_templates, n_records, n_missing


def restore_unconverted_bases_record(data: bytes, reference,
                                     ref_names) -> bytes:
    """EM-Seq post-bwameth restore (zipper.rs:629-760): for a mapped record
    carrying the bwameth YD strand tag ('f' top / 'r' bottom), rewrite
    converted bases back to the unconverted reference form at aligned
    ref-C (top) / ref-G (bottom) positions. SEQ is stored in reference
    orientation, so the (strand, reverse-flag) pair picks the target:
    (top, fwd) and (bottom, rev) restore C<-T; the other two G<-A.
    Methylation state stays in the MM/ML/cu/ct tags."""
    import numpy as np

    rec = RawRecord(data)
    if rec.flag & FLAG_UNMAPPED or rec.ref_id < 0 \
            or rec.ref_id >= len(ref_names):
        return data
    yd = rec.get_str(b"YD")
    if yd == "f":
        is_top = True
    elif yd == "r":
        is_top = False
    else:
        return data
    ref_seq = reference.get(ref_names[rec.ref_id]) \
        if hasattr(reference, "get") else None
    if ref_seq is None:
        return data
    is_reverse = bool(rec.flag & FLAG_REVERSE)
    if is_top != is_reverse:  # (top, fwd) / (bottom, rev)
        target, conv, unconv = ord("C"), ord("T"), ord("C")
    else:
        target, conv, unconv = ord("G"), ord("A"), ord("G")

    # per-query-position ref byte (uppercased), -1 for I/S — the shared
    # resolver used by the methylation filters too
    from ..consensus.methylation import ref_bytes_for_alignment

    l_seq = rec.l_seq
    ref_at = ref_bytes_for_alignment(rec.cigar(), rec.pos, ref_seq, l_seq)

    seq = rec.seq_bytes()
    codes = np.frombuffer(seq, dtype=np.uint8)
    hit = (ref_at[:len(codes)] == target) & (codes == conv)
    if not hit.any():
        return data
    # rewrite the packed nibbles in place
    buf = bytearray(data)
    l_read_name = buf[8]
    n_cigar = int.from_bytes(buf[12:14], "little")
    seq_off = 32 + l_read_name + 4 * n_cigar
    packed = np.frombuffer(bytes(buf[seq_off:seq_off + (l_seq + 1) // 2]),
                           dtype=np.uint8)
    nib = np.empty(2 * len(packed), dtype=np.uint8)
    nib[0::2] = packed >> 4
    nib[1::2] = packed & 0xF
    nib = nib[:l_seq].copy()
    # BAM nibble code for the unconverted base (A=1 C=2 G=4 T=8 in the SAM
    # spec's 16-code space)
    nib[hit] = 2 if unconv == ord("C") else 4
    out = np.zeros(((l_seq + 1) // 2) * 2, dtype=np.uint8)
    out[:l_seq] = nib
    buf[seq_off:seq_off + (l_seq + 1) // 2] = \
        ((out[0::2] << 4) | out[1::2]).astype(np.uint8).tobytes()
    return bytes(buf)
