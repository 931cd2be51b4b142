"""downsample: uniform per-UMI-family sampling in one streaming pass.

Mirrors the reference's downsample command (src/lib/commands/
downsample.rs): groups consecutive records sharing an MI tag, draws once per
family, and keeps or rejects the whole family. Requires group-produced
template-coordinate input; --seed makes runs reproducible (one sequential
draw per family, order-dependent by design — NOT Picard DownsampleSam).
"""

import math
import random
from collections import Counter
from dataclasses import dataclass, field


@dataclass
class DownsampleStats:
    families_total: int = 0
    families_kept: int = 0
    records_total: int = 0
    records_kept: int = 0
    kept_sizes: Counter = field(default_factory=Counter)
    rejected_sizes: Counter = field(default_factory=Counter)


def validate_fraction(fraction: float):
    """(0.0, 1.0]; NaN/inf rejected (downsample.rs:116-126)."""
    if math.isnan(fraction) or math.isinf(fraction) or not 0.0 < fraction <= 1.0:
        raise ValueError(
            f"--fraction must be in (0.0, 1.0], got {fraction}")


def _mi_value(rec) -> str:
    got = rec.find_tag(b"MI")
    if got is None:
        raise ValueError(
            f"record '{rec.name.decode(errors='replace')}' has no MI tag; "
            "downsample requires group-produced input")
    typ, val = got
    if typ == "Z":
        return val
    if typ in "cCsSiI":
        return str(val)
    raise ValueError(f"MI tag has unsupported type '{typ}'")


def iter_mi_families(records):
    """Yield (mi, [records]) for consecutive records sharing an MI value."""
    current_mi = None
    current = []
    for rec in records:
        mi = _mi_value(rec)
        if current and mi != current_mi:
            yield current_mi, current
            current = []
        current_mi = mi
        current.append(rec)
    if current:
        yield current_mi, current


def run_downsample(reader, writer, fraction: float, *, seed=None,
                   rejects_writer=None, validate_mi_order: bool = True
                   ) -> DownsampleStats:
    validate_fraction(fraction)
    rng = random.Random(seed)
    stats = DownsampleStats()
    seen = set()
    for mi, records in iter_mi_families(reader):
        if validate_mi_order:
            if mi in seen:
                raise ValueError(
                    f"MI tag '{mi}' appears in non-consecutive blocks; input "
                    "must be grouped (template-coordinate order from group)")
            seen.add(mi)
        stats.families_total += 1
        stats.records_total += len(records)
        if rng.random() < fraction:
            stats.families_kept += 1
            stats.records_kept += len(records)
            stats.kept_sizes[len(records)] += 1
            for rec in records:
                writer.write_record_bytes(rec.data)
        else:
            stats.rejected_sizes[len(records)] += 1
            if rejects_writer is not None:
                for rec in records:
                    rejects_writer.write_record_bytes(rec.data)
    return stats

