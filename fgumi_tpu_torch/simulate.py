"""Synthetic UMI-family data generation: MI-grouped BAM input for simplex,
/A+/B duplex-grouped BAM input for duplex, CODEC-shaped grouped BAM input
for codec, template-coordinate mapped BAM input for group, and paired gzip
FASTQ input for extract and the pipeline.

Deterministic, seeded generation (the reference's `fgumi simulate
grouped-reads` / `duplex-reads` / `codec-reads` / `mapped-reads` /
`fastq-reads` analogs,
src/lib/simulate/): the same seed
writes the same records as the reference implementation's generator, so a
run can be compared record for record without golden files.
"""

import struct

import numpy as np

from .constants import (BASE_TO_CODE, CODE_COMPLEMENT, CODE_TO_BASE,
                        reverse_complement_bytes)
from .io.bam import (BamHeader, BamWriter, FLAG_FIRST, FLAG_LAST,
                     FLAG_MATE_REVERSE, FLAG_PAIRED, FLAG_REVERSE, RecordBuilder,
                     pack_seq)


def _build_mapped_record(name, flag, ref_id, pos, mapq, cigar_ops, seq, quals,
                         next_ref_id, next_pos, tlen, tags):
    """Assemble a mapped BAM record (RecordBuilder only covers unmapped)."""
    buf = bytearray()
    l_name = len(name) + 1
    buf += struct.pack("<iiBBHHHiiii", ref_id, pos, l_name, mapq, 0,
                       len(cigar_ops), flag, len(seq), next_ref_id, next_pos, tlen)
    buf += name + b"\x00"
    op_codes = {"M": 0, "I": 1, "D": 2, "N": 3, "S": 4, "H": 5, "P": 6, "=": 7, "X": 8}
    for op, length in cigar_ops:
        buf += struct.pack("<I", (length << 4) | op_codes[op])
    buf += pack_seq(seq)
    buf += np.asarray(quals, dtype=np.uint8).tobytes()
    for tag, typ, value in tags:
        if typ == "Z":
            buf += tag + b"Z" + value + b"\x00"
        elif typ == "i":
            buf += tag + b"i" + struct.pack("<i", value)
        elif typ == "f":
            buf += tag + b"f" + struct.pack("<f", value)
        elif typ == "B":
            arr = np.asarray(value)
            sub = {np.dtype(np.int16): b"s", np.dtype(np.uint16): b"S",
                   np.dtype(np.int8): b"c", np.dtype(np.uint8): b"C",
                   np.dtype(np.int32): b"i", np.dtype(np.uint32): b"I",
                   np.dtype(np.float32): b"f"}[arr.dtype]
            buf += tag + b"B" + sub + struct.pack("<I", len(arr))
            buf += arr.tobytes()
        else:
            raise ValueError(f"unsupported tag type {typ!r}")
    return bytes(buf)


def simulate_mapped_bam(path: str, num_families: int = 100, family_size: int = 5,
                        read_length: int = 100, umi_length: int = 8,
                        umi_error_rate: float = 0.02, error_rate: float = 0.01,
                        base_quality: int = 35, seed: int = 42, paired_umis: bool = False,
                        ref_name: str = "chr1", ref_length: int = 10_000_000):
    """Write a template-coordinate-ordered mapped BAM with RX UMI tags (pre-`group`).

    Families share a genomic position and a true UMI; a read's UMI carries
    at most one error, with probability ``umi_error_rate`` per base. With
    ``paired_umis`` the RX is dual ("AAAA-CCCC") and half the reads come
    from the opposite strand with the flipped UMI — the `group --strategy
    paired` input shape.
    """
    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\tSS:unsorted:template-coordinate\n"
             f"@SQ\tSN:{ref_name}\tLN:{ref_length}\n"
             "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=[ref_name], ref_lengths=[ref_length],
    )
    # families at distinct positions, emitted in position order (template-coordinate)
    starts = np.sort(rng.choice(ref_length - 4 * read_length,
                                size=num_families, replace=False))
    n_written = 0
    with BamWriter(path, header) as w:
        for fam, start in enumerate(starts):
            start = int(start)
            insert = 2 * read_length
            r2_pos = start + insert - read_length
            half = umi_length // 2
            u1 = CODE_TO_BASE[rng.integers(0, 4, size=half)].tobytes().decode()
            u2 = CODE_TO_BASE[rng.integers(0, 4, size=umi_length - half)].tobytes().decode()
            true_umi = f"{u1}-{u2}" if paired_umis else (u1 + u2)
            cigar = [("M", read_length)]
            mc = f"{read_length}M".encode()
            truth1 = rng.integers(0, 4, size=read_length).astype(np.uint8)
            truth2 = rng.integers(0, 4, size=read_length).astype(np.uint8)

            def mutate_seq(truth):
                codes = truth.copy()
                errs = rng.random(read_length) < error_rate
                n_err = int(errs.sum())
                if n_err:
                    codes[errs] = (codes[errs] + rng.integers(1, 4, n_err)) % 4
                return CODE_TO_BASE[codes].tobytes()

            def mutate_umi(u):
                # at most one error, so `--edits 1` strategies provably
                # re-merge every family (rate = per-base rate * length)
                chars = list(u)
                base_positions = [i for i, c in enumerate(chars) if c != "-"]
                if rng.random() < umi_error_rate * len(base_positions):
                    i = int(rng.choice(base_positions))
                    c = chars[i]
                    chars[i] = "ACGT"[("ACGT".index(c) + int(rng.integers(1, 4))) % 4]
                return "".join(chars)

            for r in range(family_size):
                is_ba = paired_umis and bool(rng.integers(0, 2))
                rx = mutate_umi(true_umi)
                if is_ba:
                    a, b = rx.split("-")
                    rx = f"{b}-{a}"
                seq1 = mutate_seq(truth1)
                seq2 = mutate_seq(truth2)
                quals = np.full(read_length, base_quality, dtype=np.uint8)
                name = f"t{fam}:{r}".encode()
                tags = [(b"MC", "Z", mc), (b"RG", "Z", b"A"), (b"RX", "Z", rx.encode())]
                # BA-strand templates flip which physical end is R1
                first_flag, last_flag = (FLAG_LAST, FLAG_FIRST) if is_ba else (FLAG_FIRST, FLAG_LAST)
                rec1 = _build_mapped_record(
                    name, FLAG_PAIRED | first_flag | FLAG_MATE_REVERSE, 0, start, 60,
                    cigar, seq1, quals, 0, r2_pos, insert, tags)
                rec2 = _build_mapped_record(
                    name, FLAG_PAIRED | last_flag | FLAG_REVERSE, 0, r2_pos, 60,
                    cigar, seq2, quals, 0, start, -insert, tags)
                w.write_record_bytes(rec1)
                w.write_record_bytes(rec2)
                n_written += 2
    return n_written


def simulate_grouped_bam(path: str, num_families: int = 100, family_size: int = 5,
                         family_size_distribution: str = "fixed",
                         read_length: int = 100, error_rate: float = 0.01,
                         base_quality: int = 35, qual_jitter: int = 5,
                         paired: bool = True, seed: int = 42,
                         read_length_jitter: int = 0,
                         qual_slope: float = 0.0,
                         insert_size_mean: int = None,
                         insert_size_sd: int = 0,
                         ref_name: str = "chr1", ref_length: int = 10_000_000):
    """Write a grouped (MI-tagged) BAM simulating PCR families of reads.

    Models (reference src/lib/simulate/mod.rs:41-47 analogs): family sizes
    fixed/lognormal/longtail (_family_size), per-READ length variation
    (`read_length_jitter` bases truncated from the 3' end — stresses the
    ragged consensus-length rule), normal insert sizes
    (`insert_size_mean`/`insert_size_sd`; default uniform 1.5-3x read), and
    a per-position quality decay (`qual_slope`, _read_quals).

    Returns the number of records written. Families appear consecutively in
    MI order (the post-`group` layout simplex consumes).
    """
    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             f"@SQ\tSN:{ref_name}\tLN:{ref_length}\n"
             "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=[ref_name], ref_lengths=[ref_length],
    )
    return _write_grouped_records(
        path, header, rng, num_families, family_size,
        family_size_distribution, paired, read_length,
        read_length_jitter, insert_size_mean, insert_size_sd,
        ref_length, error_rate, base_quality, qual_jitter, qual_slope)


def simulate_duplex_bam(path: str, num_molecules: int = 100,
                        reads_per_strand: int = 3, read_length: int = 100,
                        error_rate: float = 0.01, base_quality: int = 35,
                        qual_jitter: int = 5, seed: int = 42,
                        ref_name: str = "chr1", ref_length: int = 10_000_000,
                        ba_fraction: float = 1.0,
                        strand_bias_alpha: float = None,
                        strand_bias_beta: float = None):
    """Write a duplex-grouped BAM: molecules with /A (AB) and /B (BA) strand
    reads.

    Geometry mirrors real duplex ligation: AB-R1 and BA-R2 sequence the top
    strand forward; AB-R2 and BA-R1 sequence the bottom strand (stored
    reverse-complement, FLAG_REVERSE). RX carries the dual UMI, strand-
    flipped between /A and /B.

    ``ba_fraction``: the chance a molecule keeps its B strand.
    ``strand_bias_alpha``/``beta``: a Beta-distributed A/B split of each
    molecule's 2 * reads_per_strand reads (the reference's PCR
    amplification bias model, simulate/strand_bias.rs; one strand may come
    out empty). The split is drawn first, so a molecule that then loses its
    B strand keeps only its A share. None keeps the symmetric split.
    """
    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             f"@SQ\tSN:{ref_name}\tLN:{ref_length}\n"
             "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=[ref_name], ref_lengths=[ref_length],
    )
    n_written = 0
    with BamWriter(path, header) as w:
        for mol in range(num_molecules):
            start = int(rng.integers(0, ref_length - 3 * read_length))
            insert = int(rng.integers(int(read_length * 1.5),
                                      3 * read_length))
            r2_pos = start + insert - read_length
            # one molecule over the insert (reference orientation); the
            # bottom-strand read covers the insert's end, in its own
            # orientation
            molecule = rng.integers(0, 4, size=insert).astype(np.uint8)
            truth_top = molecule[:read_length]
            truth_bot = CODE_COMPLEMENT[molecule[insert - read_length:][::-1]]
            umi_codes = rng.integers(0, 4, size=8)
            u1 = CODE_TO_BASE[umi_codes[:4]].tobytes().decode()
            u2 = CODE_TO_BASE[umi_codes[4:]].tobytes().decode()
            cigar = [("M", read_length)]
            mc = f"{read_length}M".encode()

            def mutate(truth):
                codes = truth.copy()
                errs = rng.random(read_length) < error_rate
                n_err = int(errs.sum())
                if n_err:
                    codes[errs] = (codes[errs]
                                   + rng.integers(1, 4, n_err)) % 4
                return codes

            def qgen():
                return np.clip(base_quality
                               + rng.integers(-qual_jitter, qual_jitter + 1,
                                              read_length),
                               2, 40).astype(np.uint8)

            emit_ba = rng.random() < ba_fraction
            if strand_bias_alpha is not None:
                ratio = rng.beta(strand_bias_alpha,
                                 strand_bias_beta
                                 if strand_bias_beta is not None
                                 else strand_bias_alpha)
                total = 2 * reads_per_strand
                n_a = int(round(ratio * total))
                strand_reads = {"A": n_a, "B": total - n_a}
            else:
                strand_reads = {"A": reads_per_strand, "B": reads_per_strand}
            for strand, mi_suffix, rx in (("A", "/A", f"{u1}-{u2}"),
                                          ("B", "/B", f"{u2}-{u1}")):
                if strand == "B" and not emit_ba:
                    continue
                for r in range(strand_reads[strand]):
                    name = f"mol{mol}:{strand}{r}".encode()
                    tags = [(b"MC", "Z", mc), (b"RG", "Z", b"A"),
                            (b"MI", "Z", f"{mol}{mi_suffix}".encode()),
                            (b"RX", "Z", rx.encode())]
                    # top-strand-forward read (AB-R1 / BA-R2)
                    fwd_flag = FLAG_PAIRED | FLAG_MATE_REVERSE | (
                        FLAG_FIRST if strand == "A" else FLAG_LAST)
                    rec_f = _build_mapped_record(
                        name, fwd_flag, 0, start, 60, cigar,
                        CODE_TO_BASE[mutate(truth_top)].tobytes(), qgen(),
                        0, r2_pos, insert, tags)
                    # bottom-strand read, stored reverse-complemented
                    # (AB-R2 / BA-R1)
                    rev_flag = FLAG_PAIRED | FLAG_REVERSE | (
                        FLAG_LAST if strand == "A" else FLAG_FIRST)
                    stored = CODE_COMPLEMENT[mutate(truth_bot)[::-1]]
                    rec_r = _build_mapped_record(
                        name, rev_flag, 0, r2_pos, 60, cigar,
                        CODE_TO_BASE[stored].tobytes(), qgen(),
                        0, start, -insert, tags)
                    w.write_record_bytes(rec_f)
                    w.write_record_bytes(rec_r)
                    n_written += 2
    return n_written


def simulate_codec_bam(path: str, num_molecules: int = 100, pairs_per_molecule: int = 1,
                       read_length: int = 100, error_rate: float = 0.01,
                       base_quality: int = 35, qual_jitter: int = 5, seed: int = 42,
                       overlap_fraction: float = 0.5, umi_length: int = 8,
                       ref_name: str = "chr1", ref_length: int = 10_000_000):
    """Write a CODEC-shaped grouped BAM: each FR pair covers both strands.

    One read-pair per duplex molecule (optionally more): R1 forward from the
    insert start, R2 reverse from the insert end, overlapping on the genome by
    ``overlap_fraction * read_length`` bases. MI tags carry plain molecule ids
    (no /A,/B — the `codec` command's input contract), plus RX UMIs.
    """
    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             f"@SQ\tSN:{ref_name}\tLN:{ref_length}\n"
             "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=[ref_name], ref_lengths=[ref_length],
    )
    overlap = max(1, int(read_length * overlap_fraction))
    insert = 2 * read_length - overlap
    n_written = 0
    with BamWriter(path, header) as w:
        for mol in range(num_molecules):
            start = int(rng.integers(0, ref_length - 2 * insert))
            r2_pos = start + insert - read_length
            # reference-orientation truth over the whole insert
            truth = rng.integers(0, 4, size=insert).astype(np.uint8)
            umi = CODE_TO_BASE[rng.integers(0, 4, size=umi_length)].tobytes().decode()
            cigar = [("M", read_length)]
            mc = f"{read_length}M".encode()

            def mutate(segment):
                codes = segment.copy()
                errs = rng.random(len(codes)) < error_rate
                n_err = int(errs.sum())
                if n_err:
                    codes[errs] = (codes[errs] + rng.integers(1, 4, n_err)) % 4
                return CODE_TO_BASE[codes].tobytes()

            def qgen():
                return np.clip(
                    base_quality + rng.integers(-qual_jitter, qual_jitter + 1,
                                                read_length), 2, 40).astype(np.uint8)

            for r in range(pairs_per_molecule):
                name = f"codec{mol}:{r}".encode()
                tags = [(b"MC", "Z", mc), (b"RG", "Z", b"A"),
                        (b"MI", "Z", str(mol).encode()),
                        (b"RX", "Z", umi.encode())]
                rec1 = _build_mapped_record(
                    name, FLAG_PAIRED | FLAG_FIRST | FLAG_MATE_REVERSE, 0, start,
                    60, cigar, mutate(truth[:read_length]), qgen(),
                    0, r2_pos, insert, tags)
                rec2 = _build_mapped_record(
                    name, FLAG_PAIRED | FLAG_LAST | FLAG_REVERSE, 0, r2_pos,
                    60, cigar, mutate(truth[insert - read_length:]), qgen(),
                    0, start, -insert, tags)
                w.write_record_bytes(rec1)
                w.write_record_bytes(rec2)
                n_written += 2
    return n_written


def _write_grouped_records(path, header, rng, num_families, family_size,
                           family_size_distribution, paired, read_length,
                           read_length_jitter, insert_size_mean,
                           insert_size_sd, ref_length, error_rate,
                           base_quality, qual_jitter, qual_slope):
    n_written = 0
    with BamWriter(path, header) as w:
        for fam in range(num_families):
            size = _family_size(rng, family_size_distribution, family_size)
            if insert_size_mean:
                insert = int(rng.normal(insert_size_mean,
                                        insert_size_sd or 1))
                # keep the molecule on the contig; generous ceiling so a
                # requested N(mean, sd) well beyond 3x read length is honored
                insert = max(read_length + 1,
                             min(insert, 10 * read_length,
                                 ref_length // 2))
            else:
                insert = int(rng.integers(int(read_length * 1.5),
                                          3 * read_length))
            start = int(rng.integers(0, ref_length - insert - 1))
            # one molecule truth over the insert: R1/R2 agree where they overlap
            truth = rng.integers(0, 4, size=insert).astype(np.uint8)
            mi = str(fam)

            # never truncate below 20 bases (or below 1 for tiny reads)
            jit = max(min(read_length_jitter, read_length - 20), 0)

            def rlen():
                if not jit:
                    return read_length
                return read_length - int(rng.integers(0, jit + 1))

            for r in range(size):
                ln1 = rlen()
                ln2 = rlen()
                truth_r1 = truth[:ln1]
                truth_r2 = truth[insert - ln2:]

                # per-read errors
                def mutate(truth):
                    codes = truth.copy()
                    errs = rng.random(len(codes)) < error_rate
                    n_err = int(errs.sum())
                    if n_err:
                        codes[errs] = (codes[errs] + rng.integers(1, 4, n_err)) % 4
                    return CODE_TO_BASE[codes].tobytes()

                cigar = [("M", ln1)]
                quals = _read_quals(rng, ln1, base_quality, qual_jitter,
                                    qual_slope)
                name = f"fam{fam}:r{r}".encode()
                if paired:
                    cigar2 = [("M", ln2)]
                    mc1 = f"{ln2}M".encode()   # mate (R2) cigar
                    mc2 = f"{ln1}M".encode()   # mate (R1) cigar
                    r2_pos = start + insert - ln2
                    rec1 = _build_mapped_record(
                        name, FLAG_PAIRED | FLAG_FIRST | FLAG_MATE_REVERSE, 0, start,
                        60, cigar, mutate(truth_r1), quals, 0, r2_pos, insert,
                        [(b"MC", "Z", mc1), (b"RG", "Z", b"A"), (b"MI", "Z", mi.encode())])
                    quals2 = _read_quals(rng, ln2, base_quality, qual_jitter,
                                         qual_slope)
                    rec2 = _build_mapped_record(
                        name, FLAG_PAIRED | FLAG_LAST | FLAG_REVERSE, 0, r2_pos,
                        60, cigar2, mutate(truth_r2), quals2, 0, start, -insert,
                        [(b"MC", "Z", mc2), (b"RG", "Z", b"A"), (b"MI", "Z", mi.encode())])
                    w.write_record_bytes(rec1)
                    w.write_record_bytes(rec2)
                    n_written += 2
                else:
                    rec = _build_mapped_record(
                        name, 0, 0, start, 60, cigar, mutate(truth_r1), quals,
                        -1, -1, 0,
                        [(b"RG", "Z", b"A"), (b"MI", "Z", mi.encode())])
                    w.write_record_bytes(rec)
                    n_written += 1
    return n_written


def _family_size(rng, distribution: str, mean: int) -> int:
    """Family-size model (the reference's family-size distributions,
    src/lib/simulate/mod.rs:41-47):

    - fixed:     every family has `mean` members
    - lognormal: lognormal around `mean` (sigma 0.6)
    - longtail:  Pareto-tailed mixture capped at 50 — mostly singletons and
      small families with a heavy tail, the BASELINE eval-config-2 shape
      ("real targeted panel, mixed family sizes 1-50")
    """
    if distribution == "fixed":
        return mean
    if distribution == "lognormal":
        return max(1, int(rng.lognormal(np.log(max(mean, 1)), 0.6)))
    if distribution == "longtail":
        return min(50, 1 + int(rng.pareto(1.3) * max(mean, 1) * 0.5))
    raise ValueError(distribution)


def _read_quals(rng, n: int, base_quality: int, qual_jitter: int,
                qual_slope: float = 0.0):
    """Per-position quality model: linear 3'-decay (`qual_slope` Phred per
    base, the Illumina-like degradation profile) plus uniform jitter."""
    q = base_quality - qual_slope * np.arange(n)
    if qual_jitter:
        q = q + rng.integers(-qual_jitter, qual_jitter + 1, n)
    return np.clip(q, 2, 40).astype(np.uint8)


def _random_umi(rng, length):
    return CODE_TO_BASE[rng.integers(0, 4, size=length)].tobytes()


def _mutate_bases(rng, seq_bytes, error_rate):
    """Substitute bases at `error_rate` (ACGT only)."""
    if error_rate <= 0:
        return seq_bytes
    codes = BASE_TO_CODE[np.frombuffer(seq_bytes, dtype=np.uint8)].copy()
    errs = rng.random(len(codes)) < error_rate
    n_err = int(errs.sum())
    if n_err:
        codes[errs] = (codes[errs] + rng.integers(1, 4, n_err)) % 4
    return CODE_TO_BASE[codes].tobytes()


def simulate_fastq_reads(r1_path: str, r2_path: str, truth_path: str = None,
                         num_families: int = 100, family_size: int = 5,
                         family_size_distribution: str = "fixed",
                         read_length: int = 100, umi_length: int = 8,
                         error_rate: float = 0.0, base_quality: int = 35,
                         qual_jitter: int = 5, duplex: bool = False,
                         includelist: str = None, seed: int = 42):
    """Paired gzip FASTQ with UMI prefixes (the reference's simulate
    fastq-reads, src/lib/commands/simulate/fastq_reads.rs:40-99).

    R1 = UMI + template-forward (read structure f"{umi_length}M+T"); R2 =
    template-reverse-complement (+T), or UMI + body when duplex=True. The
    truth TSV records family -> UMI(s) and size. Returns the number of read
    pairs written. Every output is published only when complete.
    """
    import gzip

    from .utils.atomic import discard_output, open_output

    rng = np.random.default_rng(seed)
    whitelist = None
    if includelist is not None:
        with open(includelist) as f:
            whitelist = [line.strip().encode() for line in f if line.strip()]
        if not whitelist:
            raise ValueError(f"includelist {includelist!r} contains no UMIs")
        umi_length = len(whitelist[0])

    def qline(n, umi_prefix=0):
        q = np.clip(base_quality + rng.integers(-qual_jitter, qual_jitter + 1,
                                                n), 2, 40)
        if umi_prefix:
            q[:umi_prefix] = 37  # UMI bases kept high-quality
        return (q + 33).astype(np.uint8).tobytes()

    n_pairs = 0
    truth_f = open_output(truth_path, "w") if truth_path else None
    try:
        if truth_f:
            truth_f.write("family\tumi\tsize\n")
        # GzipFile closes (trailer) before the atomic wrapper commits; an
        # exception discards both
        with open_output(r1_path) as raw1, \
                open_output(r2_path) as raw2, \
                gzip.GzipFile(fileobj=raw1, mode="wb", compresslevel=1,
                              mtime=0) as f1, \
                gzip.GzipFile(fileobj=raw2, mode="wb", compresslevel=1,
                              mtime=0) as f2:
            for fam in range(num_families):
                size = _family_size(rng, family_size_distribution,
                                    family_size)
                if whitelist:
                    umi1 = whitelist[int(rng.integers(len(whitelist)))]
                    umi2 = whitelist[int(rng.integers(len(whitelist)))]
                else:
                    umi1 = _random_umi(rng, umi_length)
                    umi2 = _random_umi(rng, umi_length)
                insert = int(read_length * 1.8)
                template = CODE_TO_BASE[rng.integers(0, 4,
                                                     size=insert)].tobytes()
                body1 = template[:read_length]
                body2 = reverse_complement_bytes(template[-read_length:])
                umi_str = (umi1 + b"-" + umi2).decode() if duplex \
                    else umi1.decode()
                if truth_f:
                    truth_f.write(f"{fam}\t{umi_str}\t{size}\n")
                for r in range(size):
                    name = f"fam{fam}:r{r}".encode()
                    r1_seq = umi1 + _mutate_bases(rng, body1, error_rate)
                    r2_body = _mutate_bases(rng, body2, error_rate)
                    r2_seq = (umi2 + r2_body) if duplex else r2_body
                    f1.write(b"@" + name + b"/1\n" + r1_seq + b"\n+\n"
                             + qline(len(r1_seq), umi_length) + b"\n")
                    f2.write(b"@" + name + b"/2\n" + r2_seq + b"\n+\n"
                             + qline(len(r2_seq),
                                     umi_length if duplex else 0) + b"\n")
                    n_pairs += 1
    except BaseException:
        if truth_f:
            discard_output(truth_f)  # never commit a partial truth table
        raise
    else:
        if truth_f:
            truth_f.close()
    return n_pairs


def simulate_consensus_bam(path: str, truth_path: str = None,
                           num_reads: int = 1000, read_length: int = 150,
                           min_depth: int = 1, max_depth: int = 10,
                           depth_mean: float = 5.0, depth_stddev: float = 2.0,
                           error_rate_mean: float = 0.01,
                           per_base_tags: bool = True, seed: int = 42,
                           ref_name: str = "chr1",
                           ref_length: int = 10_000_000):
    """Unmapped query-grouped BAM shaped like simplex consensus output
    (cD/cM/cE + cd/ce per-base tags), the `filter` command's input (the
    reference's simulate consensus-reads, consensus_reads.rs:43-90;
    unmapped like the pre-zipper consensus stream). Returns records
    written; every output is published only when complete."""
    from .utils.atomic import discard_output, open_output

    del ref_name, ref_length  # consensus records are unmapped here
    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=[], ref_lengths=[])
    truth_f = open_output(truth_path, "w") if truth_path else None
    n = 0
    try:
        if truth_f:
            truth_f.write("name\tdepth\terror_rate\n")
        with BamWriter(path, header) as w:
            for i in range(num_reads):
                depth = int(np.clip(round(rng.normal(depth_mean, depth_stddev)),
                                    min_depth, max_depth))
                err = float(np.clip(rng.exponential(error_rate_mean), 0, 0.5))
                seq = CODE_TO_BASE[rng.integers(0, 4, size=read_length)].tobytes()
                quals = np.clip(rng.integers(25, 60, size=read_length), 2,
                                93).astype(np.uint8)
                name = f"fgumi:{i}".encode()
                per_base = np.maximum(
                    depth - (rng.random(read_length) < 0.2), 1).astype(np.int16)
                errors = (rng.random(read_length) < err).astype(np.int16)
                b = RecordBuilder().start_unmapped(name, 0x4, seq, quals)
                b.tag_str(b"RG", b"A")
                b.tag_str(b"MI", str(i).encode())
                b.tag_str(b"RX", _random_umi(rng, 8))
                b.tag_int(b"cD", depth)
                b.tag_int(b"cM", int(per_base.min()))
                b.tag_float(b"cE", err)
                if per_base_tags:
                    b.tag_array_i16(b"cd", per_base)
                    b.tag_array_i16(b"ce", errors)
                w.write_record_bytes(b.finish())
                n += 1
                if truth_f:
                    truth_f.write(f"{name.decode()}\t{depth}\t{err:.6f}\n")
    except BaseException:
        if truth_f:
            discard_output(truth_f)  # never commit a partial truth table
        raise
    else:
        if truth_f:
            truth_f.close()
    return n


def simulate_correct_reads(path: str, includelist_path: str,
                           truth_path: str = None, num_reads: int = 10000,
                           num_umis: int = 1000, umi_length: int = 8,
                           read_length: int = 100, max_errors: int = 2,
                           base_quality: int = 35, seed: int = 42):
    """Unmapped BAM with RX UMIs drawn from a generated includelist, plus the
    includelist file and a truth TSV (the reference's simulate
    correct-reads, correct_reads.rs:36-76). Returns records written."""
    from .utils.atomic import discard_output, open_output

    rng = np.random.default_rng(seed)
    umis = set()
    while len(umis) < num_umis:
        umis.add(_random_umi(rng, umi_length))
    whitelist = sorted(umis)
    with open(includelist_path, "w") as f:
        for u in whitelist:
            f.write(u.decode() + "\n")
    header = BamHeader(text="@HD\tVN:1.6\tSO:unsorted\n"
                            "@RG\tID:A\tSM:sample\tLB:lib\n",
                       ref_names=[], ref_lengths=[])
    truth_f = open_output(truth_path, "w") if truth_path else None
    try:
        if truth_f:
            truth_f.write("name\ttrue_umi\tobserved_umi\terrors\n")
        with BamWriter(path, header) as w:
            for i in range(num_reads):
                true_umi = whitelist[int(rng.integers(len(whitelist)))]
                n_err = int(rng.integers(0, min(max_errors,
                                                umi_length) + 1))
                if n_err:
                    # exact error count at random positions
                    codes = BASE_TO_CODE[
                        np.frombuffer(true_umi, np.uint8)].copy()
                    pos = rng.choice(umi_length, size=n_err, replace=False)
                    codes[pos] = (codes[pos] + rng.integers(1, 4, n_err)) % 4
                    observed = CODE_TO_BASE[codes].tobytes()
                else:
                    observed = true_umi
                seq = CODE_TO_BASE[
                    rng.integers(0, 4, size=read_length)].tobytes()
                quals = np.clip(base_quality + rng.integers(-5, 6,
                                                            read_length),
                                2, 40)
                b = RecordBuilder().start_unmapped(
                    f"r{i}".encode(), 0x4, seq, quals.astype(np.uint8))
                b.tag_str(b"RG", b"A")
                b.tag_str(b"RX", observed)
                w.write_record_bytes(b.finish())
                if truth_f:
                    truth_f.write(f"r{i}\t{true_umi.decode()}\t"
                                  f"{observed.decode()}\t{n_err}\n")
    except BaseException:
        if truth_f:
            discard_output(truth_f)  # never commit a partial truth table
        raise
    else:
        if truth_f:
            truth_f.close()
    return num_reads
