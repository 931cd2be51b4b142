"""correct: error-correct UMIs (or sample barcodes) to a fixed whitelist.

The port's copy of fgumi_tpu/commands/correct.py, after the reference's
correct.rs:
- whitelist from --umis and/or --umi-files, uppercased, deduped, sorted,
  uniform length required (load_umi_sequences, correct.rs:563-595);
- ambiguity warning for whitelist pairs within min-distance-diff - 1
  (check_umi_distances, correct.rs:600-624; --min-distance 0 reports nothing,
  matching fgbio's signed arithmetic);
- per template: one consistent UMI across all records (mismatched UMIs or
  inconsistent presence is an error; non-Z tag type is an error;
  extract_and_validate_template_umi_raw, correct.rs:770-835);
- matching: per '-'-separated segment, nearest whitelist entry by Hamming
  distance; accept when best <= max-mismatches AND second_best - best >=
  min-distance-diff (find_best_match_encoded, correct.rs:1578-1643) — the
  whole-whitelist distance sweep is vectorized over a byte matrix;
- --revcomp reverse-complements each segment and reverses segment order
  before matching (correct.rs:639-643);
- accepted templates: sequence tag updated, original stashed in the original
  tag when there were actual mismatches (unless --dont-store-original);
  rejected templates: dropped from the main output, optionally routed to a
  --rejects BAM (correct.rs:1037-1085);
- per-UMI metrics credited per segment for every correct-length template
  BEFORE the accept/reject decision; unmatched segments credit the all-N
  bucket; missing-UMI and wrong-length templates credit nothing
  (credit_umi_metrics, correct.rs:735-765);
- --min-corrected: fail the run when kept/total falls below the threshold
  (correct.rs:1220-1229);
- --target umi reads/writes RX with original in OX; --target barcode
  reads/writes BC with original in the fgumi-local ob tag (Target,
  correct.rs:100-131).
"""

import logging
from collections import OrderedDict
from dataclasses import dataclass, field

import numpy as np

from ..constants import reverse_complement_bytes
from ..core.template import iter_name_groups
from ..io.bam import RawRecord

log = logging.getLogger("fgumi_tpu_torch.correct")

TARGET_TAGS = {
    "umi": (b"RX", b"OX"),
    "barcode": (b"BC", b"ob"),
}


def load_umi_sequences(umis=(), umi_files=()):
    """(sorted unique uppercased UMIs, length); uniform length required."""
    umi_set = {u.upper() for u in umis}
    for path in umi_files:
        with open(path) as f:
            for line in f:
                u = line.strip().upper()
                if u:
                    umi_set.add(u)
    if not umi_set:
        raise ValueError("At least one UMI or UMI file must be provided.")
    seqs = sorted(umi_set)
    length = len(seqs[0])
    if any(len(u) != length for u in seqs):
        raise ValueError("All UMIs must have the same length.")
    return seqs, length


def find_umi_pairs_within_distance(umis, distance):
    """All whitelist pairs within `distance` mismatches (correct.rs:1668-1683).
    One row of the distance matrix at a time keeps memory at O(N*L) even for
    barcode whitelists with tens of thousands of entries."""
    pairs = []
    mat = np.frombuffer("".join(umis).encode(), dtype=np.uint8)
    mat = mat.reshape(len(umis), -1)
    for i in range(len(umis) - 1):
        dists = (mat[i + 1:] != mat[i][None, :]).sum(axis=1)
        for off in np.nonzero(dists <= distance)[0]:
            j = i + 1 + int(off)
            pairs.append((umis[i], umis[j], int(dists[off])))
    return pairs


class UmiMatcher:
    """Nearest-whitelist matching with an LRU cache over observed segments.

    The per-observation sweep compares the observed segment against the whole
    whitelist at once as a numpy byte-matrix reduction (the vectorized
    equivalent of the reference's BitEnc XOR/popcount loop).
    """

    def __init__(self, umis, max_mismatches: int, min_distance_diff: int,
                 cache_size: int = 100_000):
        self.umis = umis
        self.matrix = np.frombuffer("".join(umis).encode(), dtype=np.uint8)
        self.matrix = self.matrix.reshape(len(umis), -1)
        self.max_mismatches = max_mismatches
        self.min_distance_diff = min_distance_diff
        self.cache_size = cache_size
        self._cache = OrderedDict()

    def find_best(self, observed: bytes):
        """(matched, best_umi, mismatches) for one uppercased segment."""
        hit = self._cache.get(observed)
        if hit is not None:
            self._cache.move_to_end(observed)
            return hit
        obs = np.frombuffer(observed, dtype=np.uint8)
        dists = (self.matrix != obs[None, :]).sum(axis=1)
        best_i = int(dists.argmin())
        best = int(dists[best_i])
        if len(dists) > 1:
            second = int(np.partition(dists, 1)[1])
        else:
            second = np.iinfo(np.int64).max
        matched = best <= self.max_mismatches and (second - best) >= self.min_distance_diff
        result = (matched, self.umis[best_i], best)
        if self.cache_size > 0:
            self._cache[observed] = result
            if len(self._cache) > self.cache_size:
                self._cache.popitem(last=False)
        return result


@dataclass
class TemplateCorrection:
    matched: bool
    corrected_umi: str | None
    original_umi: str
    needs_correction: bool
    has_mismatches: bool
    matches: list
    rejection: str  # '' | 'wrong_length' | 'mismatched'


def compute_template_correction(umi: str, umi_length: int, revcomp: bool,
                                matcher: UmiMatcher) -> TemplateCorrection:
    """correct.rs:627-717."""
    if revcomp:
        segments = [reverse_complement_bytes(s.encode()).decode()
                    for s in umi.split("-")][::-1]
    else:
        segments = umi.split("-")
    if any(len(s) != umi_length for s in segments):
        return TemplateCorrection(False, None, umi, False, False, [], "wrong_length")
    matches = [matcher.find_best(s.upper().encode()) for s in segments]
    all_matched = all(m[0] for m in matches)
    has_mismatches = any(m[2] > 0 for m in matches)
    if all_matched:
        corrected = "-".join(m[1] for m in matches)
        return TemplateCorrection(True, corrected, umi,
                                  has_mismatches or revcomp, has_mismatches,
                                  matches, "")
    return TemplateCorrection(False, None, umi, False, False, matches, "mismatched")


def extract_template_umi(records, umi_tag: bytes):
    """One consistent UMI per template or None (correct.rs:770-835)."""
    first = None
    first_present = None
    for rec in records:
        got = rec.find_tag(umi_tag)
        if got is not None and got[0] != "Z":
            raise ValueError(
                f"UMI tag {umi_tag.decode()} exists but has non-string type "
                f"{got[0]!r}, expected 'Z'")
        umi = got[1] if got is not None else None
        if first_present is None:
            first, first_present = umi, umi is not None
        else:
            if (umi is not None) != first_present:
                raise ValueError(
                    "Template has inconsistent UMI presence across records")
            if umi is not None and umi != first:
                raise ValueError(
                    f"Template has mismatched UMIs: first={first!r}, "
                    f"current={umi!r}")
    return first


def apply_correction(rec: RawRecord, correction: TemplateCorrection,
                     umi_tag: bytes, original_tag: bytes,
                     store_original: bool) -> bytes:
    if not correction.needs_correction:
        return rec.data
    data = rec.data_without_tag(umi_tag)
    if store_original and correction.has_mismatches:
        data = RawRecord(data).data_without_tag(original_tag)
        data += original_tag + b"Z" + correction.original_umi.encode() + b"\x00"
    data += umi_tag + b"Z" + correction.corrected_umi.encode() + b"\x00"
    return data


@dataclass
class CorrectStats:
    templates: int = 0
    records_written: int = 0
    missing_umis: int = 0
    wrong_length: int = 0
    mismatched: int = 0
    umi_metrics: dict = field(default_factory=dict)  # umi -> [total, m0, m1, m2, m3+]


def _credit(metrics: dict, matches, num_records: int, unmatched_umi: str):
    """credit_umi_metrics (correct.rs:735-765)."""
    for matched, umi, mismatches in matches:
        if matched:
            row = metrics.setdefault(umi, [0, 0, 0, 0, 0])
            row[0] += num_records
            row[min(mismatches, 3) + 1] += num_records
        else:
            metrics.setdefault(unmatched_umi, [0, 0, 0, 0, 0])[0] += num_records


def run_correct(reader, writer, matcher: UmiMatcher, umi_length: int, *,
                target: str = "umi", revcomp: bool = False,
                store_original: bool = True, rejects_writer=None) -> CorrectStats:
    """Stream reader -> writer correcting template UMIs."""
    umi_tag, original_tag = TARGET_TAGS[target]
    stats = CorrectStats()
    unmatched_umi = "N" * umi_length
    for _name, records in iter_name_groups(reader):
        stats.templates += 1
        umi = extract_template_umi(records, umi_tag)
        if umi is None:
            # missing UMIs never credit the all-N metric bucket
            # (CorrectUmis.scala:199-202 via correct.rs:1018-1024)
            stats.missing_umis += len(records)
            if rejects_writer is not None:
                for rec in records:
                    rejects_writer.write_record_bytes(rec.data)
            continue
        correction = compute_template_correction(umi, umi_length, revcomp, matcher)
        if correction.matches:
            _credit(stats.umi_metrics, correction.matches, len(records),
                    unmatched_umi)
        if correction.matched:
            for rec in records:
                writer.write_record_bytes(
                    apply_correction(rec, correction, umi_tag, original_tag,
                                     store_original))
                stats.records_written += 1
        else:
            if correction.rejection == "wrong_length":
                stats.wrong_length += len(records)
            else:
                stats.mismatched += len(records)
            if rejects_writer is not None:
                for rec in records:
                    rejects_writer.write_record_bytes(rec.data)
    return stats


_METRIC_COLUMNS = ["umi", "total_matches", "perfect_matches",
                   "one_mismatch_matches", "two_mismatch_matches",
                   "other_matches", "fraction_of_matches", "representation"]


def write_correction_metrics(stats: CorrectStats, umi_length: int, path: str):
    """UmiCorrectionMetrics TSV, fraction/representation semantics matching
    finalize_metrics (correct.rs:867-900): NaN/inf allowed when empty."""
    unmatched = "N" * umi_length
    metrics = stats.umi_metrics
    total = sum(row[0] for row in metrics.values())
    matched_total = sum(row[0] for umi, row in metrics.items() if umi != unmatched)
    umi_count = sum(1 for umi in metrics if umi != unmatched)
    mean = matched_total / umi_count if umi_count else float("nan")
    from ..utils.atomic import open_output

    with open_output(path, "w") as f:
        f.write("\t".join(_METRIC_COLUMNS) + "\n")
        for umi in sorted(metrics):
            row = metrics[umi]
            frac = row[0] / total if total else float("nan")
            rep = row[0] / mean if mean else float("nan")
            f.write("\t".join([umi, str(row[0]), str(row[1]), str(row[2]),
                               str(row[3]), str(row[4]), f"{frac:.6f}",
                               f"{rep:.6f}"]) + "\n")
