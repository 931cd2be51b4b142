"""duplex-metrics: CollectDuplexSeqMetrics analog.

Mirrors src/lib/commands/duplex_metrics.rs +
crates/fgumi-metrics/src/duplex.rs: 20-level deterministic downsampling
(Murmur3 read-name hashing), CS / SS / DS family size distributions, AB/BA
duplex family sizes with 2D cumulative fractions, UMI count metrics with
within-family consensus correction, duplex yield metrics with a binomial
ideal-duplex model, and optional interval filtering.

Outputs: <output>.family_sizes.txt, <output>.duplex_family_sizes.txt,
<output>.duplex_yield_metrics.txt, <output>.umi_counts.txt, and (with
--duplex-umi-counts) <output>.duplex_umi_counts.txt. (The reference's optional
R-based PDF plots are not produced — no R in this environment.)
"""

import logging
from collections import Counter

from ..consensus.simple_umi import consensus_umis
from ..metrics import (UmiCountTracker, binomial_cdf, family_size_rows, frac,
                       write_metrics)
from .metrics_common import (DOWNSAMPLING_FRACTIONS, compute_template_metadata,
                             parse_intervals, process_templates_from_bam,
                             validate_not_consensus_bam)

log = logging.getLogger("fgumi_tpu_torch")

FAMILY_SIZE_FIELDS = [
    "family_size", "cs_count", "cs_fraction", "cs_fraction_gt_or_eq_size",
    "ss_count", "ss_fraction", "ss_fraction_gt_or_eq_size",
    "ds_count", "ds_fraction", "ds_fraction_gt_or_eq_size"]
DUPLEX_FAMILY_FIELDS = ["ab_size", "ba_size", "count", "fraction",
                        "fraction_gt_or_eq_size"]
YIELD_FIELDS = ["fraction", "read_pairs", "cs_families", "ss_families",
                "ds_families", "ds_duplexes", "ds_fraction_duplexes",
                "ds_fraction_duplexes_ideal"]
UMI_FIELDS = ["umi", "raw_observations", "raw_observations_with_errors",
              "unique_observations", "fraction_raw_observations",
              "fraction_unique_observations"]
DUPLEX_UMI_FIELDS = UMI_FIELDS + ["fraction_unique_observations_expected"]


class DuplexMetricsCollector:
    """Per-fraction accumulator (fgumi-metrics duplex.rs:246-500)."""

    def __init__(self, collect_duplex_umi_counts: bool = False):
        self.collect_duplex_umi_counts = collect_duplex_umi_counts
        self.cs_family_sizes = {}
        self.ss_family_sizes = {}
        self.ds_family_sizes = {}
        self.duplex_family_sizes = {}
        self.umi_counts = UmiCountTracker()
        self.duplex_umi_counts = UmiCountTracker()

    def record_cs_family(self, size: int):
        self.cs_family_sizes[size] = self.cs_family_sizes.get(size, 0) + 1

    def record_ss_family(self, size: int):
        self.ss_family_sizes[size] = self.ss_family_sizes.get(size, 0) + 1

    def record_ds_family(self, size: int):
        self.ds_family_sizes[size] = self.ds_family_sizes.get(size, 0) + 1

    def record_duplex_family(self, ab_size: int, ba_size: int):
        key = (max(ab_size, ba_size), min(ab_size, ba_size))
        self.duplex_family_sizes[key] = self.duplex_family_sizes.get(key, 0) + 1

    def record_umi(self, umi: str, raw_count: int, error_count: int,
                   is_unique: bool):
        self.umi_counts.record(umi, raw_count, error_count, is_unique)

    def family_size_metrics(self) -> list:
        """One sparse row per observed size, ascending, with cumulative >=size
        fractions (duplex.rs:333-388)."""
        return family_size_rows({"cs": self.cs_family_sizes,
                                 "ss": self.ss_family_sizes,
                                 "ds": self.ds_family_sizes})

    def duplex_family_size_metrics(self) -> list:
        """(ab, ba)-sorted rows with sparse 2D cumulative fractions
        (duplex.rs:390-442)."""
        total = sum(self.duplex_family_sizes.values())
        entries = sorted(self.duplex_family_sizes.items())
        rows = []
        for (ab, ba), count in entries:
            cumulative = sum(c for (a, b), c in entries if a >= ab and b >= ba)
            rows.append({
                "ab_size": ab, "ba_size": ba, "count": count,
                "fraction": frac(count, total),
                "fraction_gt_or_eq_size": frac(cumulative, total),
            })
        return rows

    def umi_metrics(self) -> list:
        return self.umi_counts.to_metrics()

    def duplex_umi_metrics(self, umi_metrics: list) -> list:
        if not self.collect_duplex_umi_counts:
            return []
        single_fractions = {m["umi"]: m["fraction_unique_observations"]
                            for m in umi_metrics}
        total_raw = self.duplex_umi_counts.total_raw()
        total_unique = self.duplex_umi_counts.total_unique()
        rows = []
        for umi in sorted(self.duplex_umi_counts.counts):
            raw, errors, unique = self.duplex_umi_counts.counts[umi]
            if "-" in umi:
                u1, u2 = umi.split("-", 1)
                expected = (single_fractions.get(u1, 0.0)
                            * single_fractions.get(u2, 0.0))
            else:
                expected = 0.0
            rows.append({
                "umi": umi, "raw_observations": raw,
                "raw_observations_with_errors": errors,
                "unique_observations": unique,
                "fraction_raw_observations": frac(raw, total_raw),
                "fraction_unique_observations": frac(unique, total_unique),
                "fraction_unique_observations_expected": expected,
            })
        return rows


def _safe_consensus(umis: list) -> str:
    try:
        return consensus_umis(umis)
    except ValueError:
        # ragged UMI lengths: fall back to the most common observation
        return Counter(umis).most_common(1)[0][0]


def _update_umi_metrics(collector, group_pairs, duplex_umi_counts):
    """Per-DS-family UMI consensus + observation counting
    (duplex_metrics.rs:564-668): RX halves oriented F1R2 by the R1 strand.
    `group_pairs` is already one base-UMI family (built per ds_groups entry)."""
    umi1s, umi2s = [], []
    for mi, rx, r1_positive in group_pairs:
        parts = rx.split("-")
        if len(parts) != 2:
            raise ValueError(
                f"Duplex UMI did not contain 2 segments delimited by '-': "
                f"{rx!r} (MI {mi!r})")
        if r1_positive:
            umi1s.append(parts[0])
            umi2s.append(parts[1])
        else:
            umi1s.append(parts[1])
            umi2s.append(parts[0])

    consensus = []
    for umis in (umi1s, umi2s):
        if not umis:
            continue
        cons = _safe_consensus(umis)
        errors = sum(1 for u in umis if u != cons)
        collector.record_umi(cons, len(umis), errors, True)
        consensus.append(cons)

    if duplex_umi_counts and len(consensus) == 2:
        duplex_umi = f"{consensus[0]}-{consensus[1]}"
        expected = {duplex_umi, f"{consensus[1]}-{consensus[0]}"}
        errors = sum(1 for _mi, rx, _pos in group_pairs if rx not in expected)
        collector.duplex_umi_counts.record(duplex_umi, len(umi1s), errors, True)


def _ideal_duplex_fraction(family_rows: list, min_ab: int, min_ba: int) -> float:
    """Binomial(n, 0.5) ideal model weighted by per-size DS counts
    (duplex_metrics.rs:498-556)."""
    total = sum(r["ds_count"] for r in family_rows)
    if total == 0:
        return 0.0
    ideal = 0.0
    for row in family_rows:
        ds_count = row["ds_count"]
        size = row["family_size"]
        if ds_count == 0 or size < min_ab + min_ba:
            continue
        upper = size - min_ba
        lower = min_ab
        if upper >= lower:
            prob = binomial_cdf(upper, size) - \
                (binomial_cdf(lower - 1, size) if lower > 0 else 0.0)
        else:
            prob = 0.0
        ideal += prob * ds_count
    return ideal / total


def _yield_metric(collector, fraction, read_pairs, min_ab, min_ba):
    """DuplexYieldMetric for one fraction (duplex_metrics.rs:420-496)."""
    family_rows = collector.family_size_metrics()
    duplex_rows = collector.duplex_family_size_metrics()
    ds_families = sum(r["ds_count"] for r in family_rows)
    ds_duplexes = sum(r["count"] for r in duplex_rows
                      if r["ab_size"] >= min_ab and r["ba_size"] >= min_ba)
    cs_families = sum(r["cs_count"] for r in family_rows)
    ss_families = sum(
        ((1 if r["ab_size"] > 0 else 0) + (1 if r["ba_size"] > 0 else 0))
        * r["count"] for r in duplex_rows)
    return {
        "fraction": fraction, "read_pairs": read_pairs,
        "cs_families": cs_families, "ss_families": ss_families,
        "ds_families": ds_families, "ds_duplexes": ds_duplexes,
        "ds_fraction_duplexes": frac(ds_duplexes, ds_families),
        "ds_fraction_duplexes_ideal":
            _ideal_duplex_fraction(family_rows, min_ab, min_ba),
    }


def run_duplex_metrics(args) -> int:
    if args.min_ab_reads < 1 or args.min_ba_reads < 1:
        log.error("--min-ab-reads/--min-ba-reads must be >= 1")
        return 2
    if args.min_ba_reads > args.min_ab_reads:
        log.error("--min-ba-reads must be <= --min-ab-reads")
        return 2
    try:
        validate_not_consensus_bam(args.input)
        intervals = parse_intervals(args.intervals) if args.intervals else []
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2

    fractions = DOWNSAMPLING_FRACTIONS
    collectors = [DuplexMetricsCollector(args.duplex_umi_counts)
                  for _ in fractions]
    last_idx = len(fractions) - 1

    def process_group(group, fraction_counts):
        metadata = compute_template_metadata(group)
        for idx, fraction in enumerate(fractions):
            downsampled = [m for m in metadata
                           if m.template.hash_fraction <= fraction]
            if not downsampled:
                continue
            fraction_counts[idx] += len(downsampled)
            collectors[idx].record_cs_family(len(downsampled))
            is_full = idx == last_idx

            ss_groups = {}
            for m in downsampled:
                ss_groups[m.template.mi] = ss_groups.get(m.template.mi, 0) + 1
            for size in ss_groups.values():
                collectors[idx].record_ss_family(size)

            ds_groups = {}
            for m in downsampled:
                entry = ds_groups.setdefault(m.base_umi, [0, 0, []])
                if m.is_b_strand:
                    entry[1] += 1
                else:
                    entry[0] += 1  # /A or unsuffixed counts toward AB
                if is_full:
                    entry[2].append((m.template.mi, m.template.rx,
                                     m.template.r1_positive))
            for base_umi, (a_count, b_count, pairs) in ds_groups.items():
                collectors[idx].record_ds_family(a_count + b_count)
                collectors[idx].record_duplex_family(a_count, b_count)
                if is_full:
                    _update_umi_metrics(collectors[idx], pairs,
                                        args.duplex_umi_counts)

    try:
        total, fraction_counts = process_templates_from_bam(
            args.input, intervals, len(fractions), process_group)
    except ValueError as e:
        log.error("%s", e)
        return 2

    full = collectors[last_idx]
    write_metrics(f"{args.output}.family_sizes.txt",
                  full.family_size_metrics(), FAMILY_SIZE_FIELDS)
    write_metrics(f"{args.output}.duplex_family_sizes.txt",
                  full.duplex_family_size_metrics(), DUPLEX_FAMILY_FIELDS)
    yields = [_yield_metric(c, f, n, args.min_ab_reads, args.min_ba_reads)
              for c, f, n in zip(collectors, fractions, fraction_counts)]
    write_metrics(f"{args.output}.duplex_yield_metrics.txt", yields,
                  YIELD_FIELDS)
    umi_rows = full.umi_metrics()
    write_metrics(f"{args.output}.umi_counts.txt", umi_rows, UMI_FIELDS)
    if args.duplex_umi_counts:
        write_metrics(f"{args.output}.duplex_umi_counts.txt",
                      full.duplex_umi_metrics(umi_rows), DUPLEX_UMI_FIELDS)

    log.info("duplex-metrics: %d templates -> %s.{family_sizes,"
             "duplex_family_sizes,duplex_yield_metrics,umi_counts}.txt",
             total, args.output)
    return 0
