"""review: extract consensus + raw reads supporting variant calls.

Mirrors src/lib/commands/review.rs (fgbio
ReviewConsensusVariants): builds a SNP variant list from a VCF (with optional
sample genotype/MAF gating) or an interval list + reference FASTA, extracts
every consensus read with a non-reference allele (alt, third allele, no-call,
or spanning deletion) at any variant site into <output>.consensus.bam, the raw
grouped reads of the same source molecules into <output>.grouped.bam, and
writes a per-variant per-consensus-read TSV <output>.txt with consensus and
raw-read base counts (variant_review.rs ConsensusVariantReviewInfo columns).

Reads are correlated by the MI tag truncated at the last '/'
(review.rs:30-42 to_mi). Consensus-read selection uses BAI/CSI random
access over the variant windows when an index exists next to the consensus
BAM (io/bam.py BamIndexedReader — the indexed_reader.rs analog; a sparse
variant list touches only candidate BGZF blocks), falling back to one
streaming pass otherwise. The grouped-BAM pass always streams: it selects
by molecule id over the whole file (every read of a selected molecule is
extracted, wherever it maps), which no coordinate index can answer.
"""

import bisect
import gzip
import logging
import os
from dataclasses import dataclass
from typing import Optional

from ..core.cigar import read_pos_at_ref_pos
from ..core.reference import ReferenceReader
from ..io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_REVERSE,
                      FLAG_MATE_UNMAPPED, FLAG_PAIRED, FLAG_REVERSE,
                      FLAG_UNMAPPED, BamIndexedReader, BamReader, BamWriter,
                      RawRecord)
from ..metrics import write_metrics

log = logging.getLogger("fgumi_tpu_torch")

REVIEW_COLUMNS = ["chrom", "pos", "ref", "genotype", "filters",
                  "A", "C", "G", "T", "N",
                  "consensus_read", "consensus_insert", "consensus_call",
                  "consensus_qual", "a", "c", "g", "t", "n"]


@dataclass
class Variant:
    """One SNP site under review (variant_review.rs:159-184)."""

    chrom: str
    pos: int  # 1-based
    ref_base: str
    genotype: Optional[str] = None
    filters: Optional[str] = None


class BaseCounts:
    """A/C/G/T/N counts at a position (variant_review.rs:186-212)."""

    __slots__ = ("a", "c", "g", "t", "n")

    def __init__(self):
        self.a = self.c = self.g = self.t = self.n = 0

    def add(self, base: str):
        base = base.upper()
        if base == "A":
            self.a += 1
        elif base == "C":
            self.c += 1
        elif base == "G":
            self.g += 1
        elif base == "T":
            self.t += 1
        elif base == "N":
            self.n += 1


def extract_mi_base(mi: str) -> str:
    """MI truncated at the last '/' ('1/A' -> '1'; review.rs:30-42)."""
    idx = mi.rfind("/")
    return mi[:idx] if idx >= 0 else mi


def read_number_suffix(rec: RawRecord) -> str:
    """'/2' only for paired second-of-pair reads (variant_review.rs:214-224)."""
    flg = rec.flag
    return "/2" if (flg & FLAG_PAIRED and flg & FLAG_LAST) else "/1"


def format_insert_string(rec: RawRecord, ref_names: list) -> str:
    """'chr:start-end | F1R2' for mapped FR pairs, else 'NA'
    (variant_review.rs:231-320)."""
    flg = rec.flag
    if not flg & FLAG_PAIRED or flg & (FLAG_UNMAPPED | FLAG_MATE_UNMAPPED):
        return "NA"
    if rec.ref_id < 0 or rec.next_ref_id < 0 or rec.ref_id != rec.next_ref_id:
        return "NA"
    is_reverse = bool(flg & FLAG_REVERSE)
    if is_reverse == bool(flg & FLAG_MATE_REVERSE):
        return "NA"
    tlen = rec.tlen
    if tlen == 0 or (not is_reverse and tlen < 0) or (is_reverse and tlen > 0):
        return "NA"
    if rec.ref_id >= len(ref_names):
        return "NA"
    ref_name = ref_names[rec.ref_id]
    outer = (rec.pos + rec.reference_length()) if is_reverse else (rec.pos + 1)
    other = outer + tlen + (1 if tlen < 0 else -1)
    start, end = (outer, other) if outer < other else (other, outer)
    is_first = bool(flg & FLAG_FIRST)
    pairing = "F1R2" if is_first == (start == outer) else "F2R1"
    return f"{ref_name}:{start}-{end} | {pairing}"


def _base_at_position(rec: RawRecord, ref_pos: int):
    """(ASCII base, qual) at 1-based ref_pos, or None when not covered
    (deletion / outside; review.rs get_base_at_position)."""
    offset = read_pos_at_ref_pos(rec.cigar(), rec.pos + 1, ref_pos, False)
    if offset is None:
        return None
    idx = offset - 1
    seq = rec.seq_bytes()
    if idx >= len(seq):
        return None
    return chr(seq[idx]), int(rec.quals()[idx])


def _normalize(base: str, ref_base: str) -> str:
    """BAM '=' means the reference base (review.rs normalize_base_for_variant)."""
    return ref_base.upper() if base == "=" else base.upper()


# ------------------------------------------------------------------ variants

def format_genotype(gt: str, ref: str, alts: list) -> str:
    """htsjdk Genotype.getGenotypeString: allele bases in genotype order,
    '|' only when fully phased (review.rs:44-76)."""
    phased = "/" not in gt
    sep = "|" if phased and "|" in gt else "/"
    parts = gt.replace("|", "/").split("/")
    bases = []
    for p in parts:
        if p == ".":
            bases.append(".")
        elif p == "0":
            bases.append(ref)
        else:
            i = int(p) - 1
            bases.append(alts[i] if i < len(alts) else ".")
    return sep.join(bases)


def _maf_from_fields(fields: dict):
    """fgbio mafFromGenotype: AF first, then 1 - AD[0]/sum(AD); None when
    neither is usable (review.rs:665-713). A zero-AD sum yields NaN."""
    af = fields.get("AF")
    if af and af != ".":
        try:
            return float(af.split(",")[0])
        except ValueError:
            pass
    ad = fields.get("AD")
    if ad and ad != ".":
        try:
            # a missing ('.') AD entry counts as 0, matching the reference
            counts = [0 if x == "." else int(x) for x in ad.split(",")]
        except ValueError:
            return None
        total = sum(counts)
        if total == 0:
            return float("nan")
        return 1.0 - counts[0] / total
    return None


def _open_text(path: str):
    if path.lower().endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path)


def load_variants_from_vcf(path: str, sample: Optional[str],
                           maf_threshold: float) -> list:
    """SNPs from a VCF (plain or gzipped); genotype/filters from the chosen
    sample; variants whose AF/AD-derived MAF exceeds the threshold (or is NaN)
    are dropped (review.rs:412-517)."""
    variants = []
    sample_names = []
    with _open_text(path) as fh:
        for line in fh:
            line = line.rstrip("\r\n")
            if line.startswith("##") or not line:
                continue
            if line.startswith("#CHROM"):
                cols = line.split("\t")
                sample_names = cols[9:] if len(cols) > 9 else []
                continue
            cols = line.split("\t")
            if len(cols) < 8:
                continue
            chrom, pos_s, _id, ref, alt = cols[0], cols[1], cols[2], cols[3], cols[4]
            # SNPs only: single-base ACGT ref with at least one single-base alt
            if len(ref) != 1 or ref.upper() not in "ACGT":
                continue
            alts = [a for a in alt.split(",") if a != "."]
            if not alts or not all(len(a) == 1 for a in alts):
                continue
            filters = cols[6]
            v = Variant(chrom=chrom, pos=int(pos_s), ref_base=ref.upper(),
                        filters=None if filters in (".", "PASS", "") else filters)

            if len(cols) > 9 and sample_names:
                if sample is not None:
                    if sample not in sample_names:
                        raise ValueError(
                            f"sample {sample!r} not found in VCF (has "
                            f"{sample_names})")
                    s_idx = sample_names.index(sample)
                elif len(sample_names) == 1:
                    s_idx = 0
                else:
                    s_idx = None
                if s_idx is not None:
                    fmt = cols[8].split(":")
                    vals = cols[9 + s_idx].split(":")
                    fields = dict(zip(fmt, vals))
                    gt = fields.get("GT")
                    if gt:
                        v.genotype = format_genotype(gt, ref.upper(), alts)
                    maf = _maf_from_fields(fields)
                    # keep only when MAF is absent or <= threshold; a NaN
                    # MAF fails the comparison and drops the variant
                    # (fgbio forall(_ <= maf) semantics)
                    if maf is not None and not maf <= maf_threshold:
                        continue
            variants.append(v)
    return variants


def load_variants_from_intervals(path: str, reference) -> list:
    """One variant per position per interval (1-based closed), ref base from
    the FASTA (review.rs:519-559)."""
    variants = []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith(("@", "#")):
                continue
            fields = line.split("\t")
            if len(fields) < 3:
                continue
            chrom, start, end = fields[0], int(fields[1]), int(fields[2])
            seq = reference.fetch(chrom, start - 1, end).decode().upper()
            for i, pos in enumerate(range(start, end + 1)):
                ref_base = seq[i] if i < len(seq) else "N"
                variants.append(Variant(chrom, pos, ref_base))
    return variants


# ------------------------------------------------------------------ main flow

def _open_indexed(path: str):
    """BamIndexedReader over `path` when a .bai/.csi sits next to it, else
    None (streaming fallback). Tagged with index_kind for the log line."""
    for ext in (".bai", ".csi"):
        ipath = path + ext
        if os.path.exists(ipath):
            try:
                if os.path.getmtime(ipath) < os.path.getmtime(path):
                    # stale index (BAM rewritten after indexing): virtual
                    # offsets would silently fetch garbage — try the next
                    # flavor, else stream
                    log.warning("review: %s is older than %s; ignoring the "
                                "stale index", ipath, path)
                    continue
                r = BamIndexedReader(path, ipath)
            except (OSError, ValueError) as e:
                log.warning("review: index %s unusable (%s)", ipath, e)
                continue
            r.index_kind = ext[1:]
            return r
    return None


def _index_variants(variants) -> dict:
    """chrom -> (sorted positions array, variants sorted by pos)."""
    by_chrom = {}
    for v in variants:
        by_chrom.setdefault(v.chrom, []).append(v)
    out = {}
    for chrom, vs in by_chrom.items():
        vs.sort(key=lambda v: v.pos)
        out[chrom] = ([v.pos for v in vs], vs)
    return out


def _variants_overlapping(variant_index, rec: RawRecord, ref_names):
    """Variants within the record's reference span, via bisect over the
    per-chromosome sorted position list."""
    if rec.flag & FLAG_UNMAPPED or rec.ref_id < 0 or rec.ref_id >= len(ref_names):
        return []
    entry = variant_index.get(ref_names[rec.ref_id])
    if entry is None:
        return []
    positions, chrom_variants = entry
    start = rec.pos + 1
    end = rec.pos + rec.reference_length()
    lo = bisect.bisect_left(positions, start)
    hi = bisect.bisect_right(positions, end)
    return chrom_variants[lo:hi]


def run_review(args) -> int:
    lower = args.input.lower()
    try:
        if lower.endswith((".vcf", ".vcf.gz")):
            variants = load_variants_from_vcf(args.input, args.sample, args.maf)
        else:
            if args.ref is None:
                log.error("--ref is required for interval-list input")
                return 2
            variants = load_variants_from_intervals(args.input,
                                                    ReferenceReader(args.ref))
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2

    log.info("review: %d variant sites loaded", len(variants))

    # Pass 1: consensus BAM — select non-reference reads per variant, and
    # pileup site base counts over ALL consensus reads covering each variant
    # (dedup by (base, read name), review.rs:989-1002 / REV3-02).
    site_seen = set()
    selected_mis = set()
    n_consensus_out = 0
    with BamReader(args.consensus_bam) as reader:
        ref_names = reader.header.ref_names
        header = reader.header
        # reference parity (review.rs:283-298, fgumi issue #497): variants
        # process — and TSV rows emit — in sequence-dictionary coordinate
        # order regardless of the input file's order; a variant on a contig
        # absent from the dictionary is an error, as in fgbio
        dict_order = {n.decode() if isinstance(n, bytes) else n: i
                      for i, n in enumerate(ref_names)}
        missing = sorted({v.chrom for v in variants
                          if v.chrom not in dict_order})
        if missing:
            log.error("review: variant contig(s) %s not in the BAM "
                      "sequence dictionary", ", ".join(missing))
            return 2
        variants.sort(key=lambda v: (dict_order[v.chrom], v.pos))
        variant_index = _index_variants(variants)
        per_variant_consensus = {id(v): [] for v in variants}
        consensus_site_counts = {id(v): BaseCounts() for v in variants}

        class _MissingMi(Exception):
            pass

        def visit(rec, writer):
            """Shared per-record selection for both access paths."""
            nonlocal n_consensus_out
            overlapping = _variants_overlapping(variant_index, rec,
                                                ref_names)
            if not overlapping:
                return
            hits = []
            for v in overlapping:
                got = _base_at_position(rec, v.pos)
                if got is not None:
                    base = _normalize(got[0], v.ref_base)
                    key = (id(v), base, rec.name)
                    if key not in site_seen:
                        site_seen.add(key)
                        consensus_site_counts[id(v)].add(base)
                    non_ref = base != v.ref_base and \
                        not (args.ignore_ns and base == "N")
                    detail = (base, got[1])  # drives the TSV row later
                else:
                    non_ref = True  # spanning deletion
                    detail = None  # extracted, but no detail row
                if non_ref:
                    hits.append((v, detail))
            if not hits:
                return
            mi = rec.get_str(b"MI")
            if mi is None:
                raise _MissingMi(rec.name.decode(errors="replace"))
            mi_base = extract_mi_base(mi)
            selected_mis.add(mi_base)
            writer.write_record(rec)
            n_consensus_out += 1
            for v, detail in hits:
                per_variant_consensus[id(v)].append((rec, detail))

        # a dense variant list touches essentially every block, where
        # per-variant queries would re-decompress shared BGZF chunks — the
        # index only wins when the list is sparse
        indexed = _open_indexed(args.consensus_bam) \
            if len(variants) <= 20000 else None
        try:
            with BamWriter(args.output + ".consensus.bam", header) as writer:
                if indexed is not None:
                    # BAI/CSI fast path: only blocks overlapping variant
                    # windows are touched. A read spanning several variants
                    # appears in several queries; dedup keeps the first
                    # (lowest-coordinate) visit so record handling matches
                    # the streaming order.
                    with indexed:
                        visited = set()
                        for v in variants:
                            tid = dict_order[v.chrom]
                            for rec in indexed.query(tid, v.pos - 1, v.pos):
                                rkey = (rec.name, rec.flag, rec.ref_id,
                                        rec.pos)
                                if rkey in visited:
                                    continue
                                visited.add(rkey)
                                visit(rec, writer)
                    log.info("review: consensus pass used the %s index",
                             "CSI" if indexed.index_kind == "csi" else "BAI")
                else:
                    for rec in reader:
                        visit(rec, writer)
        except _MissingMi as e:
            log.error("consensus read %s has no MI tag", e)
            return 2

    # Pass 2: grouped BAM — extract raw reads of the selected molecules and
    # accumulate per-(variant, mi, read-number) base counts.
    raw_counts = {}
    n_grouped_out = 0
    with BamReader(args.grouped_bam) as reader:
        g_ref_names = reader.header.ref_names
        with BamWriter(args.output + ".grouped.bam", reader.header) as writer:
            seen = set()
            for rec in reader:
                mi = rec.get_str(b"MI")
                if mi is None:
                    continue
                mi_base = extract_mi_base(mi)
                if mi_base not in selected_mis:
                    continue
                writer.write_record(rec)
                n_grouped_out += 1
                suffix = read_number_suffix(rec)
                for v in _variants_overlapping(variant_index, rec,
                                               g_ref_names):
                    dedup_key = (id(v), rec.name, suffix)
                    if dedup_key in seen:
                        continue
                    seen.add(dedup_key)
                    got = _base_at_position(rec, v.pos)
                    if got is None:
                        continue
                    key = (id(v), mi_base, suffix)
                    counts = raw_counts.get(key)
                    if counts is None:
                        counts = raw_counts[key] = BaseCounts()
                    counts.add(_normalize(got[0], v.ref_base))

    # Review TSV: one row per (variant, non-reference consensus read).
    cons_ref_names = ref_names
    rows = []
    for v in variants:
        cons_reads = per_variant_consensus[id(v)]
        if not cons_reads:
            continue
        consensus_counts = consensus_site_counts[id(v)]

        variant_rows = []
        for rec, detail in cons_reads:
            if detail is None:
                continue  # spanning deletion: extracted but no detail row
            base, qual = detail
            mi_base = extract_mi_base(rec.get_str(b"MI"))
            suffix = read_number_suffix(rec)
            rc = raw_counts.get((id(v), mi_base, suffix), BaseCounts())
            variant_rows.append((mi_base + suffix, {
                "chrom": v.chrom, "pos": v.pos, "ref": v.ref_base,
                "genotype": v.genotype or "NA",
                "filters": v.filters or "PASS",
                "A": consensus_counts.a, "C": consensus_counts.c,
                "G": consensus_counts.g, "T": consensus_counts.t,
                "N": consensus_counts.n,
                "consensus_read": rec.name.decode(errors="replace") + suffix,
                "consensus_insert": format_insert_string(rec, cons_ref_names),
                "consensus_call": base, "consensus_qual": qual,
                "a": rc.a, "c": rc.c, "g": rc.g, "t": rc.t, "n": rc.n,
            }))
        variant_rows.sort(key=lambda t: t[0])
        rows.extend(r for _, r in variant_rows)

    write_metrics(args.output + ".txt", rows, REVIEW_COLUMNS)
    log.info("review: %d consensus reads, %d raw reads extracted; %d detail "
             "rows -> %s.{consensus.bam,grouped.bam,txt}",
             n_consensus_out, n_grouped_out, len(rows), args.output)
    return 0
