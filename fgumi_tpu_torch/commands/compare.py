"""compare: BAM and metrics equivalence (the port's parity tool).

The reference's feature-gated ``compare`` (commands/compare/): ``compare
bams`` checks two BAMs for functional equivalence, the core SAM fields plus
tag values whatever their order and width (bams.rs:1-14), in a ``content``
mode (exact and in order, or as multisets with ``--ignore-order``) or a
``grouping`` mode that matches molecules by an MI-invariant canonical id
(the smallest read name of the molecule) and checks membership, content
without the MI tag, and the duplex /A-/B strand partition up to a global
swap (engines/molecule_join.rs). ``--verify-sort`` checks each input
against its header's declared sort order on the port's packed keys
(``sort/keys.py``). ``compare metrics`` diffs TSVs with a float tolerance.
Exit 1 on a mismatch (mod.rs:32-41, CompareMismatch), 0 on a match, 2 on a
structural error such as an ungrouped input in grouping mode.
"""

import logging
import math

import numpy as np

from ..io.bam import (FLAG_FIRST, FLAG_LAST, BamReader, RawRecord,
                      _read_tag_value)

log = logging.getLogger("fgumi_tpu_torch")

MAX_REPORTED = 10


def _normalize_tag(typ: str, val):
    """Width- and representation-independent tag value (value compare,
    bams.rs:3-5)."""
    if typ in "cCsSiI":
        return ("i", int(val))
    if typ == "f":
        return ("f", float(np.float32(val)))
    if typ == "A":
        return ("A", val)
    if typ in "ZH":
        return ("Z", val)
    if typ == "B":
        arr = np.asarray(val)
        if arr.dtype.kind == "f":
            return ("Bf", tuple(float(np.float32(x)) for x in arr))
        return ("Bi", tuple(int(x) for x in arr))
    return (typ, val)


def record_tags(rec: RawRecord, ignore_tags=frozenset()):
    """{tag: normalized value}, order-independent."""
    out = {}
    for t, typ, off in rec._iter_tags():
        if t in ignore_tags:
            continue
        out[t] = _normalize_tag(chr(typ), _read_tag_value(rec.data, typ, off))
    return out


def record_fingerprint(rec: RawRecord, ignore_tags=frozenset()):
    """Hashable identity of all compared content of one record."""
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            tuple(rec.cigar()), rec.next_ref_id, rec.next_pos, rec.tlen,
            rec.seq_bytes(), rec.quals().tobytes(),
            tuple(sorted(record_tags(rec, ignore_tags).items())))


def _describe(rec: RawRecord) -> str:
    return (f"{rec.name.decode(errors='replace')} flag={rec.flag} "
            f"ref={rec.ref_id} pos={rec.pos}")


def compare_headers(ha, hb) -> list:
    """@SQ compatibility: same reference names and lengths, same order
    (engines/header.rs semantics)."""
    problems = []
    if ha.ref_names != hb.ref_names:
        problems.append(f"reference names differ: {ha.ref_names[:3]}... vs "
                        f"{hb.ref_names[:3]}...")
    elif ha.ref_lengths != hb.ref_lengths:
        problems.append("reference lengths differ")
    return problems


def _diff_records(a: RawRecord, b: RawRecord, ignore_tags) -> list:
    """Field-level differences between two paired records."""
    diffs = []
    for field in ("name", "flag", "ref_id", "pos", "mapq", "next_ref_id",
                  "next_pos", "tlen"):
        va, vb = getattr(a, field), getattr(b, field)
        if va != vb:
            diffs.append(f"{field}: {va!r} != {vb!r}")
    if a.cigar() != b.cigar():
        diffs.append("cigar differs")
    if a.seq_bytes() != b.seq_bytes():
        diffs.append("sequence differs")
    if a.quals().tobytes() != b.quals().tobytes():
        diffs.append("qualities differ")
    ta, tb = record_tags(a, ignore_tags), record_tags(b, ignore_tags)
    for tag in sorted(set(ta) | set(tb)):
        if ta.get(tag) != tb.get(tag):
            diffs.append(f"tag {tag.decode()}: {ta.get(tag)!r} != "
                         f"{tb.get(tag)!r}")
    return diffs


def compare_bams_content(path_a: str, path_b: str, ignore_order: bool = False,
                         ignore_tags=frozenset()) -> list:
    """Content engine: exact record by record (order-honest) or multiset
    compare.

    Returns mismatch description lines (empty = equal).
    """
    mismatches = []
    with BamReader(path_a) as ra, BamReader(path_b) as rb:
        mismatches.extend(compare_headers(ra.header, rb.header))
        if ignore_order:
            from collections import Counter

            ca = Counter(record_fingerprint(r, ignore_tags) for r in ra)
            cb = Counter(record_fingerprint(r, ignore_tags) for r in rb)
            only_a = ca - cb
            only_b = cb - ca
            for fp, n in list(only_a.items())[:MAX_REPORTED]:
                mismatches.append(
                    f"record only in A (x{n}): "
                    f"{fp[0].decode(errors='replace')} "
                    f"flag={fp[1]} pos={fp[3]}")
            for fp, n in list(only_b.items())[:MAX_REPORTED]:
                mismatches.append(
                    f"record only in B (x{n}): "
                    f"{fp[0].decode(errors='replace')} "
                    f"flag={fp[1]} pos={fp[3]}")
            hidden = (len(only_a) - min(len(only_a), MAX_REPORTED)
                      + len(only_b) - min(len(only_b), MAX_REPORTED))
            if hidden:
                mismatches.append(f"... and {hidden} more differing records")
        else:
            n_a = n_b = 0
            ib = iter(rb)
            for i, a in enumerate(ra):
                n_a += 1
                b = next(ib, None)
                if b is None:
                    continue
                n_b += 1
                if record_fingerprint(a, ignore_tags) != \
                        record_fingerprint(b, ignore_tags):
                    if len(mismatches) < MAX_REPORTED:
                        diffs = _diff_records(a, b, ignore_tags)
                        mismatches.append(
                            f"record {i} ({_describe(a)}): "
                            + "; ".join(diffs[:4]))
                    else:
                        mismatches.append(None)
            for b in ib:
                n_b += 1
            if n_a != n_b:
                mismatches.append(f"record counts differ: {n_a} vs {n_b}")
        n_hidden = sum(1 for m in mismatches if m is None)
        mismatches = [m for m in mismatches if m is not None]
        if n_hidden:
            mismatches.append(f"... and {n_hidden} more record mismatches")
    return mismatches


def _mi_of(rec, tag: bytes):
    """Group-tag value as a string: string aux, or the integer aux form some
    tools emit (reference record_key.rs get_mi_tag_raw parses both)."""
    mi = rec.get_str(tag)
    if mi is None:
        v = rec.get_int(tag)
        if v is not None:
            return str(v)
    return mi


def _iter_molecules(reader, tag: bytes):
    """Yield (records,) runs of consecutive equal group-tag values."""
    current = None
    run = []
    for rec in reader:
        mi = _mi_of(rec, tag)
        if mi is None:
            raise ValueError(f"record {rec.name!r} missing {tag.decode()} tag")
        base = mi[:-2] if mi.endswith(("/A", "/B")) else mi
        if base != current:
            if run:
                yield run
            current = base
            run = []
        run.append(rec)
    if run:
        yield run


def _molecule_summary(records, ignore_tags, tag: bytes):
    """(canonical_id, membership, content_multiset, strand_partition).

    canonical id = lexicographically smallest read name (grouping-tag
    invariant,
    molecule_join.rs); membership = sorted (name, R1/R2-identity); content
    excludes the grouping tag; strand partition maps name -> 'A'/'B'/None.
    """
    from collections import Counter

    canonical = min(r.name for r in records)
    membership = tuple(sorted(
        (r.name, r.flag & (FLAG_FIRST | FLAG_LAST)) for r in records))
    ignore = frozenset(ignore_tags) | {tag}
    content = Counter(record_fingerprint(r, ignore) for r in records)
    strands = {}
    for r in records:
        mi = _mi_of(r, tag) or ""
        strand = mi[-1] if mi.endswith(("/A", "/B")) else None
        strands[(r.name, r.flag & (FLAG_FIRST | FLAG_LAST))] = strand
    return canonical, membership, content, strands


def compare_bams_grouping(path_a: str, path_b: str, tag: bytes = b"MI",
                          ignore_tags=frozenset()) -> list:
    """Grouping engine: MI-numbering-invariant molecule equivalence
    (molecule_join.rs semantics; requires grouped inputs)."""
    mismatches = []
    with BamReader(path_a) as ra, BamReader(path_b) as rb:
        mismatches.extend(compare_headers(ra.header, rb.header))
        mols_a = {}
        for records in _iter_molecules(ra, tag):
            cid, membership, content, strands = _molecule_summary(
                records, ignore_tags, tag)
            if cid in mols_a:
                mismatches.append(f"A: molecule id {cid!r} not unique "
                                  "(input not grouped?)")
            mols_a[cid] = (membership, content, strands)
        seen_b = set()
        for records in _iter_molecules(rb, tag):
            cid, membership, content, strands = _molecule_summary(
                records, ignore_tags, tag)
            seen_b.add(cid)
            got = mols_a.get(cid)
            if got is None:
                if len(mismatches) < MAX_REPORTED:
                    mismatches.append(f"molecule {cid!r} only in B")
                continue
            m_a, c_a, s_a = got
            if m_a != membership:
                if len(mismatches) < MAX_REPORTED:
                    mismatches.append(f"molecule {cid!r}: membership differs")
                continue
            if c_a != content:
                if len(mismatches) < MAX_REPORTED:
                    mismatches.append(f"molecule {cid!r}: record content "
                                      "differs "
                                      "(ignoring MI)")
                continue
            # duplex strand partition equivalence up to a global A/B swap
            pairs = {(s_a[k], strands[k]) for k in strands}
            consistent = (pairs <= {("A", "A"), ("B", "B"), (None, None)}
                          or pairs <= {("A", "B"), ("B", "A"), (None, None)})
            if not consistent:
                if len(mismatches) < MAX_REPORTED:
                    mismatches.append(
                        f"molecule {cid!r}: strand partition differs")
        for cid in set(mols_a) - seen_b:
            if len(mismatches) < MAX_REPORTED:
                mismatches.append(f"molecule {cid!r} only in A")
    return mismatches


def compare_metrics(path_a: str, path_b: str,
                    float_tolerance: float = 1e-5) -> list:
    """TSV metric compare: same columns and rows; numeric cells within relative
    tolerance (metrics.rs semantics)."""
    mismatches = []
    with open(path_a) as fa, open(path_b) as fb:
        lines_a = [l.rstrip("\n") for l in fa if not l.startswith("#")]
        lines_b = [l.rstrip("\n") for l in fb if not l.startswith("#")]
    if not lines_a or not lines_b:
        if bool(lines_a) != bool(lines_b):
            mismatches.append("one file is empty")
        return mismatches
    head_a, head_b = lines_a[0].split("\t"), lines_b[0].split("\t")
    if head_a != head_b:
        mismatches.append(f"columns differ: {head_a} vs {head_b}")
        return mismatches
    if len(lines_a) != len(lines_b):
        mismatches.append(f"row counts differ: {len(lines_a) - 1} vs "
                          f"{len(lines_b) - 1}")
    for i, (la, lb) in enumerate(zip(lines_a[1:], lines_b[1:]), start=1):
        if la == lb:
            continue
        ca, cb = la.split("\t"), lb.split("\t")
        if len(ca) != len(cb):
            mismatches.append(f"row {i}: cell counts differ")
            continue
        for col, (va, vb) in zip(head_a, zip(ca, cb)):
            if va == vb:
                continue
            try:
                fa_, fb_ = float(va), float(vb)
                if math.isclose(fa_, fb_, rel_tol=float_tolerance,
                                abs_tol=float_tolerance):
                    continue
            except ValueError:
                pass
            if len(mismatches) < MAX_REPORTED:
                mismatches.append(f"row {i} col {col}: {va!r} != {vb!r}")
    return mismatches


def verify_sort_order(path: str) -> list:
    """Check that records satisfy the header's declared sort order (the
    sort-verification engine of the reference's compare,
    engines/sort_verify.rs:810-870): coordinate, queryname (natural or
    lexicographical sub-sort) or template-coordinate, on the packed byte
    keys (memcmp order is the semantic order, sort/keys.py), a record
    batch at a time. A header that declares no verifiable order gives no
    findings."""
    from ..core.template import _hd_fields
    from ..sort.keys import make_batch_keys_fn

    mismatches = []
    with BamReader(path) as reader:
        header = reader.header
        hd = _hd_fields(header.text)
    so = hd.get("SO", "")
    ss = hd.get("SS", "")
    if so == "coordinate":
        order, subsort = "coordinate", "natural"
    elif so == "queryname":
        order = "queryname"
        subsort = "lex" if ss.endswith("lexicographical") else "natural"
    elif ss.endswith("template-coordinate"):
        order, subsort = "template-coordinate", "natural"
    else:
        return []

    def report(i, prev_i):
        if len(mismatches) < MAX_REPORTED:
            mismatches.append(f"{path}: record {i} out of declared {order} "
                              f"order (violates record {prev_i})")

    prev = b""
    prev_i = -1
    from ..io.batch_reader import BamBatchReader

    batch_fn = make_batch_keys_fn(order, header, subsort)
    i = 0
    with BamBatchReader(path) as br:
        for batch in br:
            blob, koff, klen = batch_fn(batch)
            for j in range(batch.n):
                key = blob[koff[j]:koff[j] + klen[j]]
                if key < prev:
                    report(i + j, prev_i)
                else:
                    prev, prev_i = key, i + j
            i += batch.n
    return mismatches


# ------------------------------------------------------------------ CLI glue

# --command preset -> (mode, ignore_order, also_verify_sort): canonical
# comparison settings per pipeline stage (reference compare/bams.rs
# CommandPreset::resolve, bams.rs:178-206). group is the only preset that
# verifies grouping equivalence instead of positional content; sort verifies
# each input's declared order and compares content as a multiset (tie
# reordering within equal sort keys is legitimate); every other stage is
# deterministic exact content.
_PRESETS = {
    "extract": ("content", False, False),
    "zipper": ("content", False, False),
    "correct": ("content", False, False),
    "dedup": ("content", False, False),
    "clip": ("content", False, False),
    "filter": ("content", False, False),
    "simplex": ("content", False, False),
    "duplex": ("content", False, False),
    "codec": ("content", False, False),
    "group": ("grouping", True, False),
    "sort": ("content", True, True),
}


def run_compare_bams(args) -> int:
    preset = getattr(args, "preset", None)
    if preset is not None:
        p_mode, p_ignore, p_verify = _PRESETS[preset]
        if args.mode is None:
            args.mode = p_mode
        if args.ignore_order is None:
            args.ignore_order = p_ignore
        if p_verify:
            args.verify_sort = True
    if args.mode is None:
        args.mode = "content"
    if args.ignore_order is None:
        args.ignore_order = False
    ignore_tags = frozenset(t.encode() for t in (args.ignore_tags or []))
    if getattr(args, "verify_sort", False):
        sort_mismatches = []
        for path in (args.a, args.b):
            sort_mismatches.extend(verify_sort_order(path))
        if sort_mismatches:
            for m in sort_mismatches:
                log.error("compare: %s", m)
            log.error("compare: declared sort order VIOLATED "
                      "(%d findings)", len(sort_mismatches))
            return 1
    if args.mode == "grouping":
        try:
            mismatches = compare_bams_grouping(
                args.a, args.b, tag=args.tag.encode(),
                ignore_tags=ignore_tags)
        except ValueError as e:
            # a structural error (an ungrouped input) is not a mismatch:
            # exit 2
            log.error("compare: %s", e)
            return 2
    else:
        mismatches = compare_bams_content(args.a, args.b,
                                          ignore_order=args.ignore_order,
                                          ignore_tags=ignore_tags)
    if mismatches:
        for m in mismatches:
            log.error("compare: %s", m)
        log.error("compare: files DIFFER (%d mismatch lines)", len(mismatches))
        return 1
    log.info("compare: files match")
    return 0


def run_compare_metrics(args) -> int:
    mismatches = compare_metrics(args.a, args.b,
                                 float_tolerance=args.float_tolerance)
    if mismatches:
        for m in mismatches:
            log.error("compare: %s", m)
        log.error("compare: metrics DIFFER")
        return 1
    log.info("compare: metrics match")
    return 0
