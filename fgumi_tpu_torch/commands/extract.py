"""extract: FASTQ(.gz) -> unmapped BAM with UMI extraction.

Behavioral parity with the reference's extract command
(src/lib/commands/extract.rs): fgbio read structures allocate
bases to template / sample-barcode / molecular-barcode / cell-barcode / skip
segments; molecular segments land in RX (joined '-'), their qualities in QX
(joined ' ', raw ASCII); read-name UMIs (8+ colon fields, 'r'-revcomp prefix,
'+'->'-') can be prepended; quality encoding (Phred+33 vs +64) is detected by
pooling the heads of all inputs (extract.rs:210-338).

Two routes, chosen by :func:`_fast_extract_ok` from the read structures and
options alone: the native batch route (``fgumi_extract_records``) for T/M/S
structures ending in ``+`` without the name/barcode options, and the
per-record :class:`Extractor` for everything else. A failed native build
raises; it never switches the route.
"""

import re
from dataclasses import dataclass, field

import numpy as np

from ..core.read_structure import ReadStructure, TEMPLATE
from ..io.bam import FLAG_FIRST, FLAG_LAST, FLAG_MATE_UNMAPPED, FLAG_PAIRED, \
    FLAG_UNMAPPED, BamHeader, BamWriter, RecordBuilder
from ..io.fastq import FastqReader, strip_read_suffix

QUALITY_DETECTION_SAMPLE_SIZE = 400

# Complement preserving unknowns (dna.rs reverse_complement: ACGT<->TGCA, U->A,
# N->N, others pass through and are rejected by UMI validation downstream).
_COMP = bytes.maketrans(b"ACGTUacgtu", b"TGCATtgcat")

_VALID_UMI = re.compile(rb"^[ACGTN-]*$")


def _revcomp_loose(seq: bytes) -> bytes:
    return seq.translate(_COMP)[::-1]


class ExtractError(ValueError):
    pass


def detect_quality_encoding(paths, sample_size=QUALITY_DETECTION_SAMPLE_SIZE):
    """Return the Phred offset (33 or 64) from pooled input heads.

    Decision table mirrors extract.rs:275-338: any byte outside [33,126] is an
    error; min<59 -> 33; min>=64 and max>=75 -> 64; otherwise 33.
    """
    min_q, max_q = 255, 0
    total_bases = 0
    num_records = 0
    for path in paths:
        with FastqReader(path) as reader:
            for i, rec in enumerate(reader):
                if i >= sample_size:
                    break
                num_records += 1
                if rec.quals:
                    min_q = min(min_q, min(rec.quals))
                    max_q = max(max_q, max(rec.quals))
                    total_bases += len(rec.quals)
    if num_records == 0:
        raise ExtractError("Cannot detect quality encoding: no records provided")
    if total_bases == 0:
        return 33
    if min_q < 33 or max_q > 126:
        raise ExtractError(
            f"Invalid quality scores detected: range [{min_q}, {max_q}]. "
            "Quality scores must be in the printable ASCII range (33-126)")
    if min_q < 59:
        return 33
    if min_q >= 64 and max_q >= 75:
        return 64
    return 33


def normalize_read_name_umi(raw: bytes) -> bytes:
    """Normalize a read-name UMI (extract.rs:838-885 / fgbio Umis.scala:85-126).

    Reverse-complements 'r'-prefixed segments, translates the '+' dual-UMI
    delimiter to '-', upper-cases, and rejects characters outside ACGTN-.
    """
    has_r = b"r" in raw
    plus_at = raw.find(b"+")
    has_delim = plus_at > 0  # a leading '+' is not a delimiter
    if has_r and has_delim:
        parts = []
        for seg in raw.split(b"+"):
            if seg.startswith(b"r"):
                parts.append(_revcomp_loose(seg[1:]))
            else:
                parts.append(seg)
        out = b"-".join(parts)
    elif has_r:
        out = _revcomp_loose(raw[1:] if raw.startswith(b"r") else raw)
    elif has_delim:
        out = raw.replace(b"+", b"-")
    else:
        out = raw
    out = out.upper()
    if not _VALID_UMI.match(out):
        bad = next(chr(b) for b in out if not _VALID_UMI.match(bytes([b])))
        raise ExtractError(
            f"Invalid UMI '{out.decode(errors='replace')}' extracted from read "
            f"name (illegal character '{bad}')")
    return out


def extract_read_name_umi(name: bytes) -> bytes | None:
    """The last ':'-field of an 8+-field read name, normalized; else None."""
    parts = name.split(b":")
    if len(parts) >= 8 and parts[-1]:
        return normalize_read_name_umi(parts[-1])
    return None


@dataclass
class ExtractOptions:
    read_structures: list = field(default_factory=list)  # strings
    sample: str = "sample"
    library: str = "library"
    read_group_id: str = "A"
    store_umi_quals: bool = False
    store_cell_quals: bool = False
    store_sample_barcode_quals: bool = False
    extract_umis_from_read_names: bool = False
    annotate_read_names: bool = False
    single_tag: str | None = None
    barcode: str | None = None
    platform: str = "illumina"
    platform_unit: str | None = None
    platform_model: str | None = None
    sequencing_center: str | None = None
    predicted_insert_size: int | None = None
    description: str | None = None
    run_date: str | None = None
    comments: list = field(default_factory=list)
    command_line: str = "fgumi-tpu-torch extract"


# Tags extract itself emits; --single-tag must not collide with these
# (extract.rs:644-649 RESERVED_OUTPUT_TAGS).
_RESERVED_OUTPUT_TAGS = {"RX", "QX", "CB", "CY", "BC", "QT", "RG"}

_SAM_TAG = re.compile(r"^[A-Za-z][A-Za-z0-9]$")


def build_header(opts: ExtractOptions) -> BamHeader:
    """Unmapped-BAM header: @HD SO:unsorted GO:query + one @RG (extract.rs:680-715)."""
    rg = [("ID", opts.read_group_id), ("SM", opts.sample), ("LB", opts.library)]
    if opts.barcode:
        rg.append(("BC", opts.barcode))
    rg.append(("PL", opts.platform))
    for tag, val in (("PU", opts.platform_unit), ("PM", opts.platform_model),
                     ("CN", opts.sequencing_center),
                     ("PI", opts.predicted_insert_size),
                     ("DS", opts.description), ("DT", opts.run_date)):
        if val is not None:
            rg.append((tag, val))
    lines = ["@HD\tVN:1.6\tSO:unsorted\tGO:query",
             "@RG\t" + "\t".join(f"{t}:{v}" for t, v in rg),
             "@PG\tID:fgumi-tpu-torch\tPN:fgumi-tpu-torch\tCL:"
             + opts.command_line]
    lines += [f"@CO\t{c}" for c in opts.comments]
    return BamHeader(text="\n".join(lines) + "\n", ref_names=[], ref_lengths=[])


def _join(parts, sep: bytes) -> bytes:
    return sep.join(parts) if parts else b""


class Extractor:
    """Stateless per-readset record maker (extract.rs make_raw_records:980-1115)."""

    def __init__(self, structures, opts: ExtractOptions, qual_offset: int):
        self.structures = structures
        self.opts = opts
        self.qual_offset = qual_offset
        self._builder = RecordBuilder()
        template_count = sum(
            sum(1 for s in rs.segments if s.kind == TEMPLATE) for rs in structures)
        if not 1 <= template_count <= 2:
            raise ExtractError(
                f"Read structures must contain 1-2 template segments total, "
                f"found {template_count}")
        if opts.single_tag:
            if not _SAM_TAG.match(opts.single_tag):
                raise ExtractError(
                    f"Single tag must be a two-character SAM tag: {opts.single_tag}")
            if opts.single_tag in _RESERVED_OUTPUT_TAGS:
                raise ExtractError(
                    f"Single tag cannot be one of the tags extract already emits "
                    f"(RX, QX, CB, CY, BC, QT, RG): {opts.single_tag}")
        if opts.extract_umis_from_read_names and opts.store_umi_quals:
            raise ExtractError(
                "--store-umi-quals conflicts with --extract-umis-from-read-names "
                "(read-name UMIs have no qualities)")

    def make_records(self, reads):
        """reads: one FastqRead per input. Yields raw BAM record bytes."""
        opts = self.opts
        # read names must agree across all inputs (extract.rs:887-920)
        name0 = strip_read_suffix(reads[0].name)
        for i, r in enumerate(reads[1:], 1):
            ni = strip_read_suffix(r.name)
            if ni != name0:
                raise ExtractError(
                    f"Read names do not match across FASTQs: "
                    f"'{name0.decode(errors='replace')}' vs "
                    f"'{ni.decode(errors='replace')}' (FASTQ index 0 vs {i})")

        segments = []  # (kind, seq, quals) across all reads, in order
        for r, rs in zip(reads, self.structures):
            err = rs.check_read_length(len(r.seq))
            if err:
                raise ExtractError(
                    f"read '{r.name.decode(errors='replace')}': {err}")
            segments.extend(rs.extract(r.seq, r.quals))

        def seqs(kind):
            return [s for k, s, _ in segments if k == kind and s]

        def qs(kind):
            return [q for k, s, q in segments if k == kind and s]

        cell_bc = _join(seqs("C"), b"-")
        cell_quals = _join(qs("C"), b" ")
        sample_bc = _join(seqs("B"), b"-")
        sample_quals = _join(qs("B"), b" ")
        umi = _join(seqs("M"), b"-")
        umi_quals = _join(qs("M"), b" ")

        umi_from_name = (extract_read_name_umi(name0)
                         if opts.extract_umis_from_read_names else None)
        if umi_from_name and umi:
            final_umi = umi_from_name + b"-" + umi
        else:
            final_umi = umi_from_name or umi

        templates = [(s, q) for k, s, q in segments if k == TEMPLATE]
        num_templates = len(templates)
        name = name0
        if opts.annotate_read_names and final_umi:
            name = name0 + b"+" + final_umi

        for index, (seq, quals) in enumerate(templates):
            flag = FLAG_UNMAPPED
            if num_templates == 2:
                flag |= FLAG_PAIRED | FLAG_MATE_UNMAPPED
                flag |= FLAG_FIRST if index == 0 else FLAG_LAST
            if seq:
                # saturating subtract (to_standard_numeric, extract.rs:256-261):
                # a sub-offset byte past the detection sample clamps to Q0.
                off = self.qual_offset
                qarr = np.frombuffer(quals, dtype=np.uint8)
                numeric = np.where(qarr >= off, qarr - off, 0).astype(np.uint8)
            else:
                # empty template segment -> single N @ Q2 (extract.rs:947-948)
                seq, numeric = b"N", bytearray([2])
            b = self._builder.start_unmapped(name, flag, seq, numeric)
            b.tag_str(b"RG", opts.read_group_id.encode())
            if cell_bc:
                b.tag_str(b"CB", cell_bc)
                if cell_quals and opts.store_cell_quals:
                    b.tag_str(b"CY", cell_quals)
            if sample_bc:
                b.tag_str(b"BC", sample_bc)
                if sample_quals and opts.store_sample_barcode_quals:
                    b.tag_str(b"QT", sample_quals)
            if final_umi:
                b.tag_str(b"RX", final_umi)
                if opts.single_tag:
                    b.tag_str(opts.single_tag.encode(), final_umi)
                if umi_from_name is None and umi_quals and opts.store_umi_quals:
                    b.tag_str(b"QX", umi_quals)
            yield b.finish()


_SEG_KIND_CODE = {TEMPLATE: 0, "M": 1, "S": 2}


def _fast_extract_ok(structures, opts) -> bool:
    """The native batch path covers the common option surface: T/M/S segments
    with any '+' only in last position, and none of the exotic output options
    (cell/sample barcodes, single-tag, name annotation, read-name UMIs)."""
    if (opts.extract_umis_from_read_names or opts.annotate_read_names
            or opts.single_tag):
        return False
    for rs in structures:
        # every structure must END with a '+' segment: a fully-fixed
        # structure errors on over-long reads in the Python path, which the
        # native walk cannot reproduce
        if rs.segments[-1].length is not None:
            return False
        for i, seg in enumerate(rs.segments):
            if seg.kind not in _SEG_KIND_CODE:
                return False
            if seg.length is None and i != len(rs.segments) - 1:
                return False
            # UMI segments must be fixed-length (bounded native join buffer)
            if seg.kind == "M" and seg.length is None:
                return False
    umi_total = sum((seg.length or 0) + 1 for rs in structures
                    for seg in rs.segments if seg.kind == "M")
    return umi_total < 1000  # native join buffer is 1024 bytes


def _open_writer(output, header, sink, level):
    return BamWriter(output, header, level=level) if sink is None \
        else sink(header)


def _run_extract_fast(inputs, output, structures, opts, offset, header,
                      sink=None, level=1):
    """Batched native extraction (fgumi_extract_records): vectorized FASTQ
    lexing + C record assembly, byte-identical to make_records on the
    supported option surface."""
    from ..io.fastq import FastqBatchReader
    from ..native import batch as nb

    segments = []
    for k, rs in enumerate(structures):
        for seg in rs.segments:
            segments.append((k, _SEG_KIND_CODE[seg.kind],
                             -1 if seg.length is None else seg.length))
    rg = opts.read_group_id.encode()

    from ..utils.progress import ProgressTracker

    progress = ProgressTracker("extract read sets")
    n_sets = 0
    readers = [FastqBatchReader(p) for p in inputs]
    try:
        with _open_writer(output, header, sink, level) as writer:
            iters = [iter(r) for r in readers]
            cur = [None] * len(readers)  # (arrays tuple, consumed)
            while True:
                for i, it in enumerate(iters):
                    if cur[i] is None or cur[i][1] >= len(cur[i][0][1]):
                        nxt = next(it, None)
                        cur[i] = (nxt, 0) if nxt is not None else None
                if all(c is None for c in cur):
                    break
                if any(c is None for c in cur):
                    short = [inputs[i] for i, c in enumerate(cur) if c is None]
                    raise ExtractError(
                        f"FASTQ inputs have differing record counts; "
                        f"{short} ended early")
                take = min(len(c[0][1]) - c[1] for c in cur)
                bufs = []
                name_off = []
                name_len = []
                seq_off = []
                seq_len = []
                qual_off = []
                for i, (batch, pos) in enumerate(cur):
                    buf, no, nl, so, sl, qo = batch
                    bufs.append(buf)
                    name_off.append(no[pos:pos + take])
                    name_len.append(nl[pos:pos + take])
                    seq_off.append(so[pos:pos + take])
                    seq_len.append(sl[pos:pos + take])
                    qual_off.append(qo[pos:pos + take])
                    cur[i] = (batch, pos + take)
                try:
                    blob = nb.extract_records(
                        bufs, np.stack(name_off), np.stack(name_len),
                        np.stack(seq_off), np.stack(seq_len),
                        np.stack(qual_off), segments, offset, rg,
                        opts.store_umi_quals)
                except nb.NativeExtractError as e:
                    # canonical error path: rebuild the offending record as
                    # FastqReads and let make_records raise its ExtractError
                    from ..io.fastq import FastqRead

                    r = e.record_index
                    reads = []
                    for i, buf in enumerate(bufs):
                        bb = buf.tobytes()
                        reads.append(FastqRead(
                            bb[name_off[i][r]:name_off[i][r] + name_len[i][r]],
                            bb[seq_off[i][r]:seq_off[i][r] + seq_len[i][r]],
                            bb[qual_off[i][r]:qual_off[i][r] + seq_len[i][r]]))
                    extractor = Extractor(structures, opts, offset)
                    list(extractor.make_records(reads))
                    raise ExtractError(str(e))  # native-only failure
                writer.write_serialized(blob)
                n_sets += take
                progress.add(take)
    finally:
        for r in readers:
            r.close()
    progress.finish()
    # each read set emits exactly one record per template segment
    n_templates = sum(1 for s in segments if s[1] == 0)
    n_records = n_sets * n_templates
    return n_records, n_sets


def run_extract(inputs, output, opts: ExtractOptions, sink=None,
                level: int = 1):
    """Full extract: detect encoding, zip FASTQs, write unmapped BAM.

    ``sink`` (optional) replaces the file output: a callable taking the
    output BamHeader and returning a BamWriter-compatible context manager —
    the fused pipeline chain passes a channel-backed writer here so
    extract's records stream straight into sort with no intermediate file.

    ``level`` is the output's BGZF level (file output only).

    Returns (records_written, read_pairs_processed).
    """
    if opts.read_structures:
        if len(opts.read_structures) != len(inputs):
            raise ExtractError(
                f"Number of read structures ({len(opts.read_structures)}) must "
                f"match number of inputs ({len(inputs)})")
        structures = [ReadStructure.parse(rs) for rs in opts.read_structures]
    elif 1 <= len(inputs) <= 2:
        structures = [ReadStructure.parse("+T")] * len(inputs)
    else:
        raise ExtractError(
            "Read structures are required for more than 2 input FASTQs")

    offset = detect_quality_encoding(inputs)
    extractor = Extractor(structures, opts, offset)
    header = build_header(opts)

    if _fast_extract_ok(structures, opts):
        return _run_extract_fast(inputs, output, structures, opts, offset,
                                 header, sink=sink, level=level)

    n_records = 0
    n_sets = 0
    readers = [FastqReader(p) for p in inputs]
    try:
        with _open_writer(output, header, sink, level) as writer:
            iters = [iter(r) for r in readers]
            while True:
                reads = []
                for i, it in enumerate(iters):
                    rec = next(it, None)
                    reads.append(rec)
                if all(r is None for r in reads):
                    break
                if any(r is None for r in reads):
                    short = [inputs[i] for i, r in enumerate(reads) if r is None]
                    raise ExtractError(
                        f"FASTQ inputs have differing record counts; "
                        f"{short} ended early")
                n_sets += 1
                for rec_bytes in extractor.make_records(reads):
                    writer.write_record_bytes(rec_bytes)
                    n_records += 1
    finally:
        for r in readers:
            r.close()
    return n_records, n_sets
