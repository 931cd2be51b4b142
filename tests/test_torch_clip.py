"""The port's ``core/clipper.py`` and ``clip`` against the JAX package's.

``RecordClipper``: every case of ``tests/test_clip.py`` (one parametrised
test) and a seeded fuzz of random CIGARs (soft and hard clips, insertions
and deletions at the clip boundaries, per-base tags, reverse strands, reads
clipped to nothing) through every entry point in each mode, with and without
auto-clipped attributes: returns and re-encoded records equal. ``clip``: a
query-grouped zoo (FR pairs that overlap or reach past their mate, tandem
and cross-contig pairs, unmapped mates, fragments, secondary and
supplementary records, a lone R2) over a seeded FASTA, through
``fgumi_tpu.cli.main`` and ``fgumi_tpu_torch.cli.main`` on every mode
crossed with overlap, past-mate, fixed ends, ``-H`` and ``-a``: records
(all but @PG) and the metrics TSV byte-identical; the refusals exit 2 on
both with nothing written. The JAX package's native library is never
loaded.
"""

import os

import numpy as np
import pytest

import fgumi_tpu.core.clipper as jax_clipper
import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
import fgumi_tpu_torch.core.clipper as port_clipper
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.core.reference import write_fasta
from fgumi_tpu_torch.io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_MATE_REVERSE,
                                    FLAG_MATE_UNMAPPED, FLAG_PAIRED,
                                    FLAG_PROPER_PAIR, FLAG_REVERSE,
                                    FLAG_SECONDARY, FLAG_SUPPLEMENTARY,
                                    FLAG_UNMAPPED, BamHeader, BamReader,
                                    BamWriter, RecordBuilder)

MODULES = {"port": port_clipper, "jax": jax_clipper}


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package runs on its pure-Python paths: its native library is
    never loaded (its build races between test workers), and none of these
    commands' records depends on it."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


MODES = ("soft", "soft-with-mask", "hard")


def rec(mod, cigar, pos=100, flag=0, seq=None, name=b"q"):
    length = sum(ln for op, ln in cigar if op in "MIS=X")
    seq = seq or b"A" * length
    return mod.MutableRecord(name=name, flag=flag, ref_id=0, pos=pos,
                             mapq=60, cigar=list(cigar), seq=seq,
                             quals=b"\x1e" * len(seq), next_ref_id=-1,
                             next_pos=-1, tlen=0)


def fr_pair(mod, r1_pos, r2_pos, length=30):
    r1 = rec(mod, [("M", length)], pos=r1_pos,
             flag=FLAG_PAIRED | FLAG_FIRST | FLAG_MATE_REVERSE, name=b"p")
    r2 = rec(mod, [("M", length)], pos=r2_pos,
             flag=FLAG_PAIRED | FLAG_LAST | FLAG_REVERSE, name=b"p")
    r1.next_ref_id, r1.next_pos = r2.ref_id, r2.pos
    r2.next_ref_id, r2.next_pos = r1.ref_id, r1.pos
    return r1, r2


# every case of tests/test_clip.py's clipper tests: (mode, build, call)
# where build(mod) makes the records and call(clipper, mod, recs) clips
CLIPPER_CASES = {
    "soft_clip_start": ("soft", lambda m: [rec(m, [("M", 50)])],
                        lambda c, m, r: c.clip_start_of_alignment(r[0], 10)),
    "hard_clip_start": ("hard", lambda m: [rec(m, [("M", 50)])],
                        lambda c, m, r: c.clip_start_of_alignment(r[0], 10)),
    "soft_with_mask_start": (
        "soft-with-mask", lambda m: [rec(m, [("M", 20)], seq=b"C" * 20)],
        lambda c, m, r: c.clip_start_of_alignment(r[0], 5)),
    "clip_converts_existing_soft_to_hard": (
        "hard", lambda m: [rec(m, [("S", 5), ("M", 45)])],
        lambda c, m, r: c.clip_start_of_alignment(r[0], 10)),
    "clip_end": ("hard", lambda m: [rec(m, [("M", 50)])],
                 lambda c, m, r: c.clip_end_of_alignment(r[0], 10)),
    "clip_through_insertion_swallows_it": (
        "soft", lambda m: [rec(m, [("M", 10), ("I", 5), ("M", 10)])],
        lambda c, m, r: c.clip_start_of_alignment(r[0], 12)),
    "clip_removes_boundary_deletion": (
        "soft", lambda m: [rec(m, [("M", 10), ("D", 4), ("M", 10)])],
        lambda c, m, r: c.clip_start_of_alignment(r[0], 10)),
    "clip_all_unmaps_read": (
        "soft", lambda m: [rec(m, [("M", 20)], flag=FLAG_REVERSE,
                               seq=b"ACGT" * 5)],
        lambda c, m, r: c.clip_start_of_alignment(r[0], 20)),
    "clip_5prime_strand_aware": (
        "soft", lambda m: [rec(m, [("M", 30)]),
                           rec(m, [("M", 30)], flag=FLAG_REVERSE)],
        lambda c, m, r: (c.clip_5_prime_end_of_alignment(r[0], 5),
                         c.clip_5_prime_end_of_alignment(r[1], 5))),
    "clip_read_ensures_at_least": (
        "soft", lambda m: [rec(m, [("S", 5), ("M", 45)])],
        lambda c, m, r: (c.clip_start_of_read(r[0], 5),
                         c.clip_start_of_read(r[0], 8))),
    "upgrade_all_clipping_hard": (
        "hard", lambda m: [rec(m, [("S", 4), ("M", 20), ("S", 6)])],
        lambda c, m, r: c.upgrade_all_clipping(r[0])),
    "read_pos_at_ref_pos": (
        "soft", lambda m: [rec(m, [("S", 5), ("M", 10), ("D", 2),
                                   ("M", 10)], pos=99)],
        lambda c, m, r: [m.read_pos_at_ref_pos(r[0], p, last)
                         for p in (95, 100, 109, 110, 111, 112, 125, 130)
                         for last in (False, True)]),
    "clip_overlapping_reads_midpoint": (
        "soft", lambda m: list(fr_pair(m, 100, 110)),
        lambda c, m, r: c.clip_overlapping_reads(r[0], r[1])),
    "clip_overlapping_requires_fr": (
        "soft", lambda m: [r.__setattr__("flag", r.flag & ~FLAG_REVERSE)
                           or r if r.flag & FLAG_LAST else r
                           for r in fr_pair(m, 100, 110)],
        lambda c, m, r: c.clip_overlapping_reads(r[0], r[1])),
    "clip_extending_past_mate": (
        "soft", lambda m: list(fr_pair(m, 100, 90)),
        lambda c, m, r: c.clip_extending_past_mate_ends(r[0], r[1])),
}


def _run_case(mod, mode, build, call, auto=False):
    recs = build(mod)
    got = call(mod.RecordClipper(mode, auto), mod, recs)
    return got, [r.encode() for r in recs], [mod.clipped_bases(r)
                                              for r in recs]


@pytest.mark.parametrize("case", sorted(CLIPPER_CASES))
def test_record_clipper_cases_match_jax_package(case):
    mode, build, call = CLIPPER_CASES[case]
    got = {pkg: _run_case(mod, mode, build, call)
           for pkg, mod in MODULES.items()}
    assert got["port"] == got["jax"]


def _random_cigar(rng, with_hard: bool):
    ops = []
    if with_hard and rng.random() < 0.3:
        ops.append(("H", int(rng.integers(1, 6))))
    if rng.random() < 0.4:
        ops.append(("S", int(rng.integers(1, 12))))
    for k in range(int(rng.integers(1, 4))):
        if k:
            ops.append((str(rng.choice(["I", "D"])), int(rng.integers(1, 5))))
        ops.append((str(rng.choice(["M", "M", "=", "X"])),
                    int(rng.integers(1, 30))))
    if rng.random() < 0.4:
        ops.append(("S", int(rng.integers(1, 12))))
    if with_hard and rng.random() < 0.3:
        ops.append(("H", int(rng.integers(1, 6))))
    return ops


def _random_record(mod, rng, flag, pos, with_hard=True):
    cigar = _random_cigar(rng, with_hard)
    n = sum(ln for op, ln in cigar if op in "MIS=X")
    seq = bytes(rng.choice(list(b"ACGTN"), n).astype(np.uint8))
    r = mod.MutableRecord(
        name=b"f", flag=flag, ref_id=0, pos=pos, mapq=60, cigar=cigar,
        seq=seq, quals=bytes(rng.integers(2, 41, n).astype(np.uint8)),
        next_ref_id=0, next_pos=pos, tlen=0)
    r.aux_entries = [
        (b"ac", b"Z", seq + b"\x00"),
        (b"cd", b"B", b"s" + np.uint32(n).tobytes()
         + rng.integers(0, 9, n).astype(np.int16).tobytes()),
        (b"XQ", b"B", b"C" + np.uint32(n + 1).tobytes() + bytes(n + 1)),
        (b"RX", b"Z", b"ACGT\x00")]
    return r


# entry points of the fuzz: (name, number of records it takes)
FUZZ_CALLS = [
    ("clip_start_of_alignment", 1), ("clip_end_of_alignment", 1),
    ("clip_5_prime_end_of_alignment", 1), ("clip_3_prime_end_of_alignment", 1),
    ("clip_start_of_read", 1), ("clip_end_of_read", 1),
    ("clip_5_prime_end_of_read", 1), ("clip_3_prime_end_of_read", 1),
    ("upgrade_all_clipping", 1), ("clip_overlapping_reads", 2),
    ("clip_extending_past_mate_ends", 2),
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("auto", [False, True])
def test_record_clipper_fuzz_matches_jax_package(mode, auto):
    got = {}
    for pkg, mod in MODULES.items():
        rng = np.random.default_rng(11)
        out = []
        clipper = mod.RecordClipper(mode, auto)
        for i in range(600):
            name, n_recs = FUZZ_CALLS[i % len(FUZZ_CALLS)]
            if n_recs == 1:
                flag = FLAG_REVERSE if rng.random() < 0.5 else 0
                recs = [_random_record(mod, rng, flag,
                                       int(rng.integers(0, 400)))]
                args = [int(rng.integers(0, 45))] \
                    if name != "upgrade_all_clipping" else []
            else:
                p1 = int(rng.integers(100, 200))
                p2 = p1 + int(rng.integers(-40, 60))
                fwd = FLAG_PAIRED | FLAG_MATE_REVERSE
                rev = FLAG_PAIRED | FLAG_REVERSE
                if rng.random() < 0.1:  # not an FR pair
                    rev &= ~FLAG_REVERSE
                first, last = (fwd, rev) if rng.random() < 0.5 \
                    else (rev, fwd)
                recs = [_random_record(mod, rng, first | FLAG_FIRST, p1),
                        _random_record(mod, rng, last | FLAG_LAST, p2)]
                args = []
            ret = getattr(clipper, name)(*recs, *args)
            geometry = [(r.alignment_end(), r.unsoftclipped_start(),
                         r.unsoftclipped_end(), r.cigar_string(),
                         mod.clipped_bases(r), r.is_unmapped())
                        for r in recs]
            out.append((name, ret, geometry, [r.encode() for r in recs],
                        mod.is_fr_pair(*recs) if n_recs == 2 else None))
        got[pkg] = out
    assert got["port"] == got["jax"]
    unmapped = sum(1 for *_, recs, _ in got["port"] for r in recs
                   if r[4:8] == b"\xff\xff\xff\xff")
    assert unmapped > 0  # some reads were clipped to nothing


# ------------------------------------------------------------- the command

CONTIG_LEN = 5000


def clip_zoo(d, n_templates=240, seed=5):
    """A query-grouped BAM of ``n_templates`` templates over a seeded
    two-contig FASTA; returns (bam, fasta)."""
    rng = np.random.default_rng(seed)
    contigs = {f"chr{c + 1}": bytes(rng.choice(list(b"ACGT"), CONTIG_LEN)
                                    .astype(np.uint8)) for c in range(2)}
    fasta = os.path.join(d, "zoo.fa")
    write_fasta(fasta, contigs)
    names = list(contigs)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:queryname\n"
             + "".join(f"@SQ\tSN:{n}\tLN:{CONTIG_LEN}\n" for n in names),
        ref_names=names, ref_lengths=[CONTIG_LEN] * len(names))

    def read(name, flag, tid, pos, cigar, mate_tid, mate_pos, tlen,
             mate_cigar=None):
        n = sum(ln for op, ln in cigar if op in "MIS=X")
        if tid >= 0:
            ref = contigs[names[tid]][pos:pos + n]
            seq = bytearray(ref + b"A" * (n - len(ref)))
            for k in rng.integers(0, n, 2):
                seq[k] = ord("ACGT"[int(rng.integers(0, 4))])
            seq = bytes(seq)
            b = RecordBuilder().start_mapped(
                name, flag, tid, pos, 60, cigar, seq,
                rng.integers(2, 41, n), mate_tid, mate_pos, tlen)
        else:
            seq = bytes(rng.choice(list(b"ACGT"), n).astype(np.uint8))
            b = RecordBuilder().start_unmapped(name, flag, seq,
                                               rng.integers(2, 41, n))
            b._buf[20:24] = np.int32(mate_tid).tobytes()
            b._buf[24:28] = np.int32(mate_pos).tobytes()
        b.tag_str(b"RX", b"ACGTACGT").tag_str(b"MI", b"7")
        b.tag_array_i16(b"cd", rng.integers(0, 9, n))
        b.tag_str(b"ac", seq).tag_str(b"aq", bytes(rng.integers(35, 70, n)
                                                   .astype(np.uint8)))
        b.tag_int(b"NM", 9)
        if mate_cigar:
            b.tag_str(b"MC", mate_cigar.encode())
        return b.finish()

    def cig(n, lead=0, trail=0, indel=None):
        body = [("M", n - lead - trail)]
        if indel is not None:
            k = (n - lead - trail) // 2
            body = [("M", k), indel, ("M", n - lead - trail - k
                                      - (indel[1] if indel[0] == "I" else 0))]
        return ([("S", lead)] if lead else []) + body \
            + ([("S", trail)] if trail else [])

    def cstr(c):
        return "".join(f"{ln}{op}" for op, ln in c)

    recs = []
    for t in range(n_templates):
        name = f"t{t:05d}".encode()
        kind = t % 10
        tid = t % 2
        p1 = int(rng.integers(50, CONTIG_LEN - 400))
        l1, l2 = (int(x) for x in rng.integers(20, 90, 2))
        indel = [None, ("I", 2), ("D", 3)][t % 3]
        c1 = cig(l1, lead=int(rng.integers(0, 6)) * (t % 4 == 1),
                 trail=int(rng.integers(0, 6)) * (t % 4 == 2), indel=indel)
        c2 = cig(l2, lead=int(rng.integers(0, 6)) * (t % 5 == 1),
                 trail=int(rng.integers(0, 6)) * (t % 5 == 3))
        p2 = p1 + int(rng.integers(-30, 120))
        rev1 = t % 7 == 3  # R1 the reverse read of an FR pair
        f1 = FLAG_PAIRED | FLAG_FIRST | FLAG_PROPER_PAIR
        f2 = FLAG_PAIRED | FLAG_LAST | FLAG_PROPER_PAIR
        f1 |= FLAG_REVERSE if rev1 else FLAG_MATE_REVERSE
        f2 |= FLAG_MATE_REVERSE if rev1 else FLAG_REVERSE
        if kind <= 4:
            recs += [read(name, f1, tid, p1, c1, tid, p2, p2 - p1 + l2,
                          cstr(c2)),
                     read(name, f2, tid, p2, c2, tid, p1, p1 - p2 - l2,
                          cstr(c1))]
        elif kind == 5:  # tandem, or mates on two contigs
            t2 = tid if t % 20 < 10 else 1 - tid
            f2t = f2 & ~FLAG_REVERSE if t2 == tid else f2
            recs += [read(name, f1 & ~FLAG_REVERSE, tid, p1, c1, t2, p2, 0),
                     read(name, f2t, t2, p2, c2, tid, p1, 0)]
        elif kind == 6:  # R2 unmapped
            recs += [read(name, (f1 | FLAG_MATE_UNMAPPED) & ~FLAG_PROPER_PAIR,
                          tid, p1, c1, tid, p1, 0),
                     read(name, (f2 | FLAG_UNMAPPED) & ~FLAG_PROPER_PAIR,
                          -1, p1, c2, tid, p1, 0)]
        elif kind == 7:  # a fragment, mapped or not
            if t % 20 < 10:
                recs.append(read(name, FLAG_REVERSE * (t % 3 == 0), tid, p1,
                                 c1, -1, -1, 0))
            else:
                recs.append(read(name, FLAG_UNMAPPED, -1, -1, c1, -1, -1, 0))
        elif kind == 8:  # a pair with a supplementary R1, a secondary R2
            recs += [read(name, f1, tid, p1, c1, tid, p2, p2 - p1 + l2),
                     read(name, f1 | FLAG_SUPPLEMENTARY, 1 - tid,
                          p1 + 17, [("S", 10), ("M", l1 - 10)], tid, p2, 0),
                     read(name, f2, tid, p2, c2, tid, p1, p1 - p2 - l2),
                     read(name, f2 | FLAG_SECONDARY, tid, p1 + 300, c2, tid,
                          p1, 0)]
        else:  # a lone primary R2 with a supplementary
            recs += [read(name, f2, tid, p2, c2, tid, p1, 0),
                     read(name, f2 | FLAG_SUPPLEMENTARY, 1 - tid, p2 + 5,
                          [("M", l2)], tid, p1, 0)]
    bam = os.path.join(d, "zoo.bam")
    with BamWriter(bam, header) as w:
        for data in recs:
            w.write_record_bytes(data)
    return bam, fasta


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    return clip_zoo(str(tmp_path_factory.mktemp("torch_clip")))


def bam_body(path):
    """(header text without @PG lines, [record bytes])."""
    with BamReader(path) as r:
        text = "\n".join(line for line in r.header.text.splitlines()
                         if not line.startswith("@PG"))
        return text, [rec.data for rec in r]


def run_both(tmp_path, argv_of, files=()):
    """Run ``argv_of(prefix)`` through both packages; returns {pkg: (rc,
    {name: bytes or None})} for the outputs in ``files``."""
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        prefix = str(tmp_path / pkg)
        rc = main(argv_of(prefix))
        outs = {}
        for f in files:
            path = prefix + f
            if not os.path.exists(path):
                outs[f] = None
            elif path.endswith(".bam"):
                outs[f] = bam_body(path)
            else:
                outs[f] = open(path, "rb").read()
        got[pkg] = (rc, outs)
    return got


CLIP_FLAGS = [
    ["--clip-overlapping-reads"],
    ["--clip-bases-past-mate"],
    ["--clip-overlapping-reads", "--clip-extending-past-mate"],
    ["--read-one-five-prime", "3", "--read-one-three-prime", "4",
     "--read-two-five-prime", "5", "--read-two-three-prime", "2"],
    ["--read-one-five-prime", "40", "--read-two-three-prime", "45"],
    ["-H"],
    ["-H", "-a", "--clip-overlapping-reads", "--read-two-five-prime", "7"],
    ["-a", "--clip-overlapping-reads", "--clip-bases-past-mate",
     "--read-one-three-prime", "6"],
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("flags", range(len(CLIP_FLAGS)))
def test_clip_matches_jax_package(tmp_path, zoo, mode, flags):
    bam, fasta = zoo
    got = run_both(tmp_path, lambda pre: [
        "clip", "-i", bam, "-o", pre + ".bam", "-r", fasta, "-c", mode,
        "-m", pre + ".tsv", *CLIP_FLAGS[flags]], (".bam", ".tsv"))
    assert got["port"] == got["jax"]
    rc, outs = got["port"]
    assert rc == 0 and len(outs[".bam"][1]) == len(bam_body(bam)[1])
    assert outs[".bam"][1] != bam_body(bam)[1]


def test_clip_round_trips_unclipped_records(zoo):
    """MutableRecord decodes and re-encodes every zoo record unchanged on
    both packages."""
    _, recs = bam_body(zoo[0])
    from fgumi_tpu_torch.io.bam import RawRecord

    for mod in MODULES.values():
        for data in recs:
            assert mod.MutableRecord.from_raw(RawRecord(data)).encode() \
                == data


def _unsorted(src, dst):
    with BamReader(src) as r:
        text = r.header.text.replace("SO:queryname", "SO:coordinate")
        header = BamHeader(text=text, ref_names=r.header.ref_names,
                           ref_lengths=r.header.ref_lengths)
        with BamWriter(dst, header) as w:
            for rec in r:
                w.write_record(rec)


def _duplicate_r1(src, dst):
    with BamReader(src) as r, BamWriter(dst, r.header) as w:
        recs = list(r)
        for rec in recs[:2] + recs[:1] + recs[2:]:
            w.write_record(rec)


@pytest.mark.parametrize("case", ["no_option", "not_grouped",
                                  "missing_reference", "duplicate_r1",
                                  "bad_mode"])
def test_clip_refusals_match_jax_package(tmp_path, zoo, case):
    bam, fasta = zoo
    flags = ["--clip-overlapping-reads"]
    if case == "no_option":
        flags = []
    elif case == "not_grouped":
        bam = str(tmp_path / "coord.bam")
        _unsorted(zoo[0], bam)
    elif case == "missing_reference":
        fasta = str(tmp_path / "none.fa")
    elif case == "duplicate_r1":
        bam = str(tmp_path / "dup.bam")
        _duplicate_r1(zoo[0], bam)
    else:
        flags += ["-c", "sideways"]

    def argv(pre):
        return ["clip", "-i", bam, "-o", pre + ".bam", "-r", fasta,
                "-m", pre + ".tsv", *flags]

    if case == "bad_mode":
        for main in (port_main, jax_main):
            with pytest.raises(SystemExit) as e:
                main(argv(str(tmp_path / "x")))
            assert e.value.code == 2
        return
    got = run_both(tmp_path, argv, (".bam", ".tsv"))
    assert got["port"] == got["jax"]
    assert got["port"] == (2, {".bam": None, ".tsv": None})


def test_clip_under_global_options(tmp_path, zoo):
    """``clip`` and ``downsample`` take the port's global options: with
    ``--audit-output``, ``--trace`` and ``--run-report`` the records equal
    the plain run's, the audit passes and the report names the command."""
    import json

    bam, fasta = zoo
    plain, traced = str(tmp_path / "plain.bam"), str(tmp_path / "traced.bam")
    report, trace = str(tmp_path / "r.json"), str(tmp_path / "t.json")
    argv = ["clip", "-i", bam, "-r", fasta, "--clip-overlapping-reads"]
    assert port_main([*argv, "-o", plain]) == 0
    assert port_main(["--audit-output", "--trace", trace, "--run-report",
                      report, *argv, "-o", traced]) == 0
    assert bam_body(traced) == bam_body(plain)
    with open(report) as f:
        assert json.load(f)["command"] == "clip"
    assert os.path.exists(trace)
    out = str(tmp_path / "down.bam")
    assert port_main(["--audit-output", "downsample", "-i", traced, "-o",
                      out, "-f", "1.0"]) == 0
    assert bam_body(out)[1] == bam_body(traced)[1]
