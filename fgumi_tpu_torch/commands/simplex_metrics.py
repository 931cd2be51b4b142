"""simplex-metrics: simplex yield/family QC metrics (no fgbio equivalent).

Mirrors src/lib/commands/simplex_metrics.rs +
crates/fgumi-metrics/src/simplex.rs: CS/SS family size distributions, UMI
count metrics (per-component RX consensus, no strand swapping), and yield
metrics at 20 downsampling levels (mean SS family size, singleton fraction,
families meeting --min-reads). Rejects duplex-UMI input (base UMIs on both
/A and /B strands) with a pointer at duplex-metrics.

Outputs: <output>.family_sizes.txt, <output>.simplex_yield_metrics.txt,
<output>.umi_counts.txt.
"""

import logging

from ..metrics import UmiCountTracker, family_size_rows, frac, write_metrics
from .duplex_metrics import UMI_FIELDS, _safe_consensus
from .metrics_common import (DOWNSAMPLING_FRACTIONS, compute_template_metadata,
                             parse_intervals, process_templates_from_bam,
                             validate_not_consensus_bam)

log = logging.getLogger("fgumi_tpu_torch")

FAMILY_SIZE_FIELDS = [
    "family_size", "cs_count", "cs_fraction", "cs_fraction_gt_or_eq_size",
    "ss_count", "ss_fraction", "ss_fraction_gt_or_eq_size"]
YIELD_FIELDS = ["fraction", "read_pairs", "cs_families", "ss_families",
                "mean_ss_family_size", "ss_singletons", "ss_singleton_fraction",
                "ss_consensus_families"]


class SimplexMetricsCollector:
    """Per-fraction accumulator (fgumi-metrics simplex.rs)."""

    def __init__(self):
        self.cs_family_sizes = {}
        self.ss_family_sizes = {}
        self.umi_counts = UmiCountTracker()

    def record_cs_family(self, size: int):
        self.cs_family_sizes[size] = self.cs_family_sizes.get(size, 0) + 1

    def record_ss_family(self, size: int):
        self.ss_family_sizes[size] = self.ss_family_sizes.get(size, 0) + 1

    def family_size_metrics(self) -> list:
        return family_size_rows({"cs": self.cs_family_sizes,
                                 "ss": self.ss_family_sizes})


def _yield_metric(collector, fraction, read_pairs, min_reads):
    """SimplexYieldMetric (simplex_metrics.rs:333-371)."""
    rows = collector.family_size_metrics()
    cs_families = sum(r["cs_count"] for r in rows)
    ss_families = sum(r["ss_count"] for r in rows)
    total_ss_reads = sum(r["family_size"] * r["ss_count"] for r in rows)
    ss_singletons = next((r["ss_count"] for r in rows if r["family_size"] == 1), 0)
    ss_consensus = sum(r["ss_count"] for r in rows
                       if r["family_size"] >= min_reads)
    return {
        "fraction": fraction, "read_pairs": read_pairs,
        "cs_families": cs_families, "ss_families": ss_families,
        "mean_ss_family_size": frac(total_ss_reads, ss_families),
        "ss_singletons": ss_singletons,
        "ss_singleton_fraction": frac(ss_singletons, ss_families),
        "ss_consensus_families": ss_consensus,
    }


def run_simplex_metrics(args) -> int:
    if args.min_reads < 1:
        log.error("--min-reads must be >= 1 (got %d)", args.min_reads)
        return 2
    try:
        validate_not_consensus_bam(args.input)
        intervals = parse_intervals(args.intervals) if args.intervals else []
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2

    fractions = DOWNSAMPLING_FRACTIONS
    collectors = [SimplexMetricsCollector() for _ in fractions]
    last_idx = len(fractions) - 1

    def process_group(group, fraction_counts):
        metadata = compute_template_metadata(group)
        # duplex-data guard (SIMM3-01): a base UMI on both strands means
        # duplex input; the per-family RX consensus below would mix the two
        # strand orientations.
        strands = {}
        for m in metadata:
            seen = strands.setdefault(m.base_umi, [False, False])
            seen[0] |= m.is_a_strand
            seen[1] |= m.is_b_strand
            if seen[0] and seen[1]:
                raise ValueError(
                    f"simplex-metrics received duplex-UMI data: base UMI "
                    f"{m.base_umi!r} has reads on both the /A and /B strands. "
                    "Run duplex-metrics for duplex data.")

        for idx, fraction in enumerate(fractions):
            downsampled = [m for m in metadata
                           if m.template.hash_fraction <= fraction]
            if not downsampled:
                continue
            fraction_counts[idx] += len(downsampled)
            collectors[idx].record_cs_family(len(downsampled))

            ss_groups = {}
            for m in downsampled:
                ss_groups[m.template.mi] = ss_groups.get(m.template.mi, 0) + 1
            for size in ss_groups.values():
                collectors[idx].record_ss_family(size)

            if idx == last_idx:
                umi_groups = {}
                for m in downsampled:
                    umi_groups.setdefault(m.base_umi, []).append(m.template.rx)
                for rx_tags in umi_groups.values():
                    split_rx = [rx.split("-") for rx in rx_tags]
                    num_components = len(split_rx[0]) if split_rx else 0
                    for pos in range(num_components):
                        umis = [parts[pos] for parts in split_rx
                                if pos < len(parts)]
                        if not umis:
                            continue
                        cons = _safe_consensus(umis)
                        errors = sum(1 for u in umis if u != cons)
                        collectors[idx].umi_counts.record(
                            cons, len(umis), errors, True)

    try:
        total, fraction_counts = process_templates_from_bam(
            args.input, intervals, len(fractions), process_group)
    except ValueError as e:
        log.error("%s", e)
        return 2

    full = collectors[last_idx]
    write_metrics(f"{args.output}.family_sizes.txt",
                  full.family_size_metrics(), FAMILY_SIZE_FIELDS)
    yields = [_yield_metric(c, f, n, args.min_reads)
              for c, f, n in zip(collectors, fractions, fraction_counts)]
    write_metrics(f"{args.output}.simplex_yield_metrics.txt", yields,
                  YIELD_FIELDS)
    write_metrics(f"{args.output}.umi_counts.txt",
                  full.umi_counts.to_metrics(), UMI_FIELDS)

    log.info("simplex-metrics: %d templates -> %s.{family_sizes,"
             "simplex_yield_metrics,umi_counts}.txt", total, args.output)
    return 0
