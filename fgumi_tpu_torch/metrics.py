"""fgbio-compatible metric TSVs and the QC metric helpers.

Float cells follow fgbio's Metric format (integral values drop the
fraction; NaN/Infinity use Java's tokens); a metric file is a TSV whose
header row is the field-name list. Every file is written through
:func:`utils.atomic.open_output`. The helpers of ``duplex-metrics`` and
``simplex-metrics`` (family-size rows, the UMI count tracker, the binomial
CDF of the ideal duplex model, and the Murmur3 downsampling score) mirror
crates/fgumi-metrics/src/ and src/lib/commands/shared_metrics.rs.
"""

import math

from .utils.atomic import open_output


def format_metric_value(v) -> str:
    """One fgbio Metric cell."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float):
        if math.isnan(v):
            return "NaN"
        if math.isinf(v):
            return "Infinity" if v > 0 else "-Infinity"
        if v == int(v) and abs(v) < 2**63:
            return str(int(v))
        return repr(v)
    return str(v)


def write_metrics(path: str, rows: list, fieldnames=None):
    """Write metric rows (dicts) as an fgbio-style TSV. The header is the
    field-name list; empty ``rows`` with explicit ``fieldnames`` still
    write the header (fgbio writes headers for empty metric files)."""
    if fieldnames is None:
        if not rows:
            raise ValueError("fieldnames required when rows is empty")
        fieldnames = list(rows[0].keys())
    with open_output(path, "w") as fh:
        fh.write("\t".join(fieldnames) + "\n")
        for row in rows:
            fh.write("\t".join(format_metric_value(row[k])
                              for k in fieldnames) + "\n")


def frac(n: int, d: int) -> float:
    """n/d, 0 for an empty denominator."""
    return n / d if d else 0.0


def family_size_rows(histograms: dict) -> list:
    """Sparse per-size rows with reversed-cumulative >=size fractions.

    `histograms` maps a column prefix (e.g. "cs") to its {size: count} map;
    output rows carry `<prefix>_count`, `<prefix>_fraction`, and
    `<prefix>_fraction_gt_or_eq_size` per prefix, sorted ascending by
    family_size (fgumi-metrics duplex.rs:333-388 and simplex.rs).
    """
    totals = {p: sum(h.values()) for p, h in histograms.items()}
    sizes = sorted(set().union(*histograms.values()) if histograms else ())
    rows = []
    for size in sizes:
        row = {"family_size": size}
        for prefix, hist in histograms.items():
            count = hist.get(size, 0)
            row[f"{prefix}_count"] = count
            row[f"{prefix}_fraction"] = frac(count, totals[prefix])
            row[f"{prefix}_fraction_gt_or_eq_size"] = 0.0
        rows.append(row)
    for prefix in histograms:
        running = 0.0
        for row in reversed(rows):
            running += row[f"{prefix}_fraction"]
            row[f"{prefix}_fraction_gt_or_eq_size"] = running
    return rows


def size_distribution_fields(size_field: str) -> list:
    """Column schema of :func:`size_distribution_rows` (passed to
    write_metrics so empty inputs still write the right header)."""
    return [size_field, "count", "fraction",
            f"fraction_gt_or_eq_{size_field}"]


def size_distribution_rows(counts: dict, size_field: str) -> list:
    """fgbio-format size distribution of one {size: count} map: ascending
    ``size_field`` rows with ``count``, ``fraction`` and the reverse-
    cumulative ``fraction_gt_or_eq_<size_field>`` (the family-size and
    position-group-size files of ``group``)."""
    total = sum(counts.values())
    rows = []
    for size in sorted(counts):
        rows.append({size_field: size, "count": counts[size],
                     "fraction": frac(counts[size], total),
                     f"fraction_gt_or_eq_{size_field}": 0.0})
    running = 0.0
    for row in reversed(rows):
        running += row["fraction"]
        row[f"fraction_gt_or_eq_{size_field}"] = running
    return rows


def umi_grouping_metrics_row(filter_metrics: dict) -> dict:
    """The 5-column fgbio ``UmiGroupingMetric`` row (with fgbio's
    ``discarded_umis_to_short`` spelling) from the group engines'
    filter-metrics dict (zero counters are absent from it and read as 0)."""
    return {
        "accepted_sam_records": filter_metrics.get("accepted", 0),
        "discarded_non_pf": filter_metrics.get("non_pf", 0),
        "discarded_poor_alignment": filter_metrics.get("poor_alignment", 0),
        "discarded_ns_in_umi": filter_metrics.get("ns_in_umi", 0),
        "discarded_umis_to_short": filter_metrics.get("umi_too_short", 0),
    }


def write_family_size_histogram(family_sizes: dict, path: str):
    """The plain ``family_size``/``count`` TSV of ``--family-size-out``."""
    with open_output(path, "w") as f:
        f.write("family_size\tcount\n")
        for size, count in family_sizes.items():
            f.write(f"{size}\t{count}\n")


class UmiCountTracker:
    """Raw/error/unique observation counts per UMI (shared.rs:61-140)."""

    def __init__(self):
        self.counts = {}  # umi -> [raw, errors, unique]

    def record(self, umi: str, raw_count: int, error_count: int, is_unique: bool):
        entry = self.counts.setdefault(umi, [0, 0, 0])
        entry[0] += raw_count
        entry[1] += error_count
        if is_unique:
            entry[2] += 1

    def total_raw(self) -> int:
        return sum(e[0] for e in self.counts.values())

    def total_unique(self) -> int:
        return sum(e[2] for e in self.counts.values())

    def to_metrics(self) -> list:
        """Sorted [{umi, raw_observations, ...}] rows (shared.rs:110-140)."""
        total_raw = self.total_raw()
        total_unique = self.total_unique()
        rows = []
        for umi in sorted(self.counts):
            raw, errors, unique = self.counts[umi]
            rows.append({
                "umi": umi,
                "raw_observations": raw,
                "raw_observations_with_errors": errors,
                "unique_observations": unique,
                "fraction_raw_observations": frac(raw, total_raw),
                "fraction_unique_observations": frac(unique, total_unique),
            })
        return rows


def binomial_cdf(k: int, n: int, p: float = 0.5) -> float:
    """P(X <= k) for X ~ Binomial(n, p), via log-space term accumulation.

    Exact-enough replacement for statrs Binomial::cdf
    (duplex_metrics.rs:522-545); log-gamma keeps large n stable.
    """
    if k < 0:
        return 0.0
    if k >= n:
        return 1.0
    if p <= 0.0:
        return 1.0
    if p >= 1.0:
        return 0.0
    log_p = math.log(p)
    log_q = math.log(1.0 - p)
    total = 0.0
    lg_n = math.lgamma(n + 1)
    for i in range(k + 1):
        log_term = (lg_n - math.lgamma(i + 1) - math.lgamma(n - i + 1)
                    + i * log_p + (n - i) * log_q)
        total += math.exp(log_term)
    return min(total, 1.0)


def _murmur3_mix_k1(k1: int) -> int:
    k1 = (k1 * 0xCC9E2D51) & 0xFFFFFFFF
    k1 = ((k1 << 15) | (k1 >> 17)) & 0xFFFFFFFF
    return (k1 * 0x1B873593) & 0xFFFFFFFF


def _murmur3_mix_h1(h1: int, k1: int) -> int:
    h1 ^= k1
    h1 = ((h1 << 13) | (h1 >> 19)) & 0xFFFFFFFF
    return (h1 * 5 + 0xE6546B64) & 0xFFFFFFFF


def compute_hash_fraction(read_name: str) -> float:
    """fgbio-compatible Murmur3 downsampling score in [0, 1].

    Ports htsjdk Murmur3.hashUnencodedChars over UTF-16 code units with seed
    42, including the Java Math.abs(Int.MinValue) quirk
    (shared_metrics.rs:122-205).
    """
    chars = [ord(c) for c in read_name]  # BMP names: code units == code points
    # surrogate-pair expansion for non-BMP characters (UTF-16 code units)
    units = []
    for c in chars:
        if c > 0xFFFF:
            c -= 0x10000
            units.append(0xD800 + (c >> 10))
            units.append(0xDC00 + (c & 0x3FF))
        else:
            units.append(c)

    h1 = 42
    length = len(units)
    i = 1
    while i < length:
        k1 = units[i - 1] | (units[i] << 16)
        h1 = _murmur3_mix_h1(h1, _murmur3_mix_k1(k1))
        i += 2
    if length & 1:
        h1 ^= _murmur3_mix_k1(units[length - 1])

    # fmix
    h1 ^= (2 * length) & 0xFFFFFFFF
    h1 ^= h1 >> 16
    h1 = (h1 * 0x85EBCA6B) & 0xFFFFFFFF
    h1 ^= h1 >> 13
    h1 = (h1 * 0xC2B2AE35) & 0xFFFFFFFF
    h1 ^= h1 >> 16

    # to signed i32, then Java Math.abs (Int.MinValue stays negative)
    signed = h1 - 0x100000000 if h1 >= 0x80000000 else h1
    abs_val = signed if signed == -0x80000000 else abs(signed)
    return abs_val / 2147483647.0
