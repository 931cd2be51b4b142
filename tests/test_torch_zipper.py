"""The port's ``zipper`` (``commands/zipper.py``, ``fast_zipper.py``,
``core/record_edit.py`` and the command line) against the JAX package's.

Each CLI case runs four times on the same inputs: the port's batch engine and
``--classic``, and the JAX package's batch engine and ``--classic``
(``fgumi_tpu.cli.main``, its native library built from its source into a
pytest temporary directory, never its own build path). The exit codes and the
records must be equal (the header too, but for its @PG line). The inputs are
the port's copy of the JAX package's zipper zoo (``tests/test_zipper.py``
``_zip_pair_bams``), built with the port's ``RecordBuilder``: pairs and
fragments, secondary and supplementary records, half and fully unmapped
pairs, negative strands, PG on one side, both or neither, typed-int and
B-array tags, per-base consensus tags, stale MC and ms tags, exact
unclipped-5' ties, QC-fail transfer and templates the aligner dropped. The
options: ``--tags-to-remove NM``/``MQ``, ``--skip-tc-tags``,
``--exclude-missing-reads``, ``--tags-to-reverse Consensus`` and
``--tags-to-revcomp Consensus``; ``--restore-unconverted-bases --ref`` on an
EM-Seq input with bwameth YD tags; the batch engine over record batches of a
few hundred bytes; the port's ``TagEditor``, ``fix_mate_info`` and
``merge_template`` against the JAX package's; and the exit-2 refusals on
both packages, nothing written.
"""

import os
import random

import numpy as np
import pytest

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.commands import zipper as jax_zipper
from fgumi_tpu.io.bam import RawRecord as JaxRawRecord
from fgumi_tpu_torch.cli import _merge_zipper_headers
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.commands import zipper as port_zipper
from fgumi_tpu_torch.commands.fast_zipper import run_zipper_fast
from fgumi_tpu_torch.core.record_edit import TagEditor
from fgumi_tpu_torch.core.reference import write_fasta
from fgumi_tpu_torch.io.bam import (BamHeader, BamReader, BamWriter,
                                    RawRecord, RecordBuilder)
from fgumi_tpu_torch.io.batch_reader import BamBatchReader
from test_torch_dedup import jax_lib, with_jax_lib  # noqa: F401 (fixtures)


def _header_and_records(path):
    with BamReader(path) as r:
        text = "\n".join(line for line in r.header.text.splitlines()
                         if not line.startswith("@PG"))
        return text, [rec.data for rec in r]


ZOO_HEADER = ("@HD\tVN:1.6\tSO:queryname\n@SQ\tSN:c1\tLN:100000\n"
              "@SQ\tSN:c2\tLN:100000\n@RG\tID:A\tLB:l\n")


def zip_pair_bams(d, seed, n_templates=300):
    """(mapped, unmapped) BAMs of the template-shape zoo (the JAX package's
    ``tests/test_zipper.py`` ``_zip_pair_bams``, with per-base consensus
    tags on the unmapped side for the reverse and revcomp sets)."""
    rng = random.Random(seed)
    header = BamHeader(text=ZOO_HEADER, ref_names=["c1", "c2"],
                       ref_lengths=[100000, 100000])
    m_path = os.path.join(d, f"m{seed}.bam")
    u_path = os.path.join(d, f"u{seed}.bam")
    seq = b"ACGTACGTACGTACGTACGTACGTACGTACGT"

    def utags(b, i):
        b.tag_str(b"RX", b"ACGT-TTAA"[: 4 + (i % 5)])
        if i % 3:
            b.tag_str(b"QX", b"IIII")
        if i % 4 == 0:
            b.tag_str(b"PG", b"extract")
        if i % 5 == 0:
            b.tag_int(b"cD", i % 100)
        if i % 6 == 1:
            b.tag_array_i16(b"cd", list(range(len(seq))))
            b.tag_str(b"ac", seq[:12] + b"N")
        b.tag_str(b"RG", b"A")

    def mtags(b, i):
        if i % 2:
            b.tag_int(b"AS", rng.randrange(-300, 3000))
        if i % 3 == 0:
            b.tag_int(b"XS", rng.randrange(0, 100))
        if i % 4 != 1:
            b.tag_str(b"PG", b"aligner")
        b.tag_str(b"RG", b"A")
        if i % 7 == 0:
            b.tag_str(b"MC", b"10M")  # stale MC to be replaced
        if i % 6 == 0:
            b.tag_int(b"NM", i % 9)
        if i % 5 == 2:
            # a stale ms with no AS on the mate is kept
            b.tag_int(b"ms", 5 + (i % 30))

    with BamWriter(m_path, header) as mw, BamWriter(u_path, header) as uw:
        for i in range(n_templates):
            name = f"q{i:06d}".encode()
            shape = rng.random()
            paired = shape > 0.15
            if paired:
                for fl in (0x1 | 0x40 | 0x4 | 0x8, 0x1 | 0x80 | 0x4 | 0x8):
                    b = RecordBuilder().start_unmapped(
                        name, fl | (0x200 if i % 11 == 0 else 0), seq,
                        [30] * len(seq))
                    utags(b, i)
                    uw.write_record_bytes(b.finish())
            else:
                b = RecordBuilder().start_unmapped(
                    name, 0x4, seq, [30] * len(seq))
                utags(b, i)
                uw.write_record_bytes(b.finish())
            if shape < 0.05:
                continue  # the aligner dropped this template

            def mapped_rec(fl, tid=None, pos=None, cig=None):
                b = RecordBuilder().start_mapped(
                    name, fl, tid if tid is not None else rng.randrange(2),
                    pos if pos is not None else rng.randrange(50000),
                    rng.randrange(10, 61),
                    cig or ([("S", 3), ("M", 29)] if rng.random() < 0.4
                            else [("M", 32)]),
                    seq, [30] * len(seq), next_ref_id=0, next_pos=10,
                    tlen=0)
                mtags(b, i)
                return b

            if not paired:
                fl = 0x10 if rng.random() < 0.5 else 0
                mw.write_record_bytes(mapped_rec(fl).finish())
                if rng.random() < 0.1:  # supplementary fragment
                    mw.write_record_bytes(mapped_rec(fl | 0x800).finish())
                continue
            r = rng.random()
            f1 = 0x1 | 0x40 | (0x10 if rng.random() < 0.5 else 0)
            f2 = 0x1 | 0x80 | (0x10 if rng.random() < 0.5 else 0)
            if r < 0.08:  # R2 unmapped
                f2 |= 0x4
            elif r < 0.12:  # both unmapped but the aligner emitted them
                f1 |= 0x4
                f2 |= 0x4
            elif r < 0.17:
                # exact unclipped-5' tie: R1 forward at p, R2 reverse ending
                # at p + 1; the TLEN sign splits +1/-1 from R1's side
                p = rng.randrange(100, 50000)
                mw.write_record_bytes(
                    mapped_rec(0x1 | 0x40, tid=0, pos=p,
                               cig=[("M", 32)]).finish())
                mw.write_record_bytes(
                    mapped_rec(0x1 | 0x80 | 0x10, tid=0, pos=p - 31,
                               cig=[("M", 32)]).finish())
                continue
            mw.write_record_bytes(mapped_rec(f1).finish())
            if rng.random() < 0.12:  # secondary of R1
                mw.write_record_bytes(mapped_rec(f1 | 0x100).finish())
            mw.write_record_bytes(mapped_rec(f2).finish())
            if rng.random() < 0.12:  # supplementary of R2
                mw.write_record_bytes(mapped_rec(f2 | 0x800).finish())
    return m_path, u_path


@pytest.fixture(scope="module")
def zoo(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_zipper"))
    return {seed: zip_pair_bams(d, seed) for seed in (1, 2, 3)}


def _zip_all(tmp_path, m_path, u_path, flags, engines=("fast", "classic")):
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        for engine in engines:
            key = f"{pkg}_{engine}"
            out = str(tmp_path / f"{key}.bam")
            argv = ["zipper", "-i", m_path, "-u", u_path, "-o", out, *flags]
            if engine == "classic":
                argv.append("--classic")
            rc = main(argv)
            got[key] = (rc, _header_and_records(out) if rc == 0 else None)
    return got


EXTRAS = [[], ["--tags-to-remove", "NM"], ["--tags-to-remove", "MQ"],
          ["--skip-tc-tags"], ["--exclude-missing-reads"],
          ["--tags-to-reverse", "Consensus"],
          ["--tags-to-revcomp", "Consensus"],
          ["--tags-to-reverse", "Consensus", "--tags-to-revcomp",
           "Consensus", "--tags-to-remove", "QX", "cD"]]


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("extra", range(len(EXTRAS)))
def test_zipper_matches_jax_package(tmp_path, zoo, seed, extra):
    m_path, u_path = zoo[seed]
    got = _zip_all(tmp_path, m_path, u_path, EXTRAS[extra])
    want = got["jax_classic"]
    assert want[0] == 0 and len(want[1][1]) > 500
    for key, res in got.items():
        assert res == want, f"{key} differs from the JAX package's classic"


@pytest.mark.parametrize("targets", [(600, 700), (300, 5000), (1, 1)])
def test_fast_zipper_over_small_batches(tmp_path, zoo, targets):
    """Templates split across the batch buffers of either input take the
    per-template path; the records equal the JAX package's classic run."""
    m_path, u_path = zoo[2]
    out = str(tmp_path / "tiny.bam")
    with BamBatchReader(m_path, target_bytes=targets[0]) as m, \
            BamBatchReader(u_path, target_bytes=targets[1]) as u:
        hdr = _merge_zipper_headers(m.header, u.header)
        with BamWriter(out, hdr) as w:
            run_zipper_fast(m, u, w, port_zipper.TagInfo.from_options())
    ref = str(tmp_path / "ref.bam")
    assert jax_main(["zipper", "-i", m_path, "-u", u_path, "-o", ref,
                     "--classic"]) == 0
    assert _header_and_records(out)[1] == _header_and_records(ref)[1]


def test_template_functions_match_jax_package(zoo):
    """``merge_template`` (``fix_mate_info``, the tag transfer, ``tc``) and
    ``TagEditor`` of both packages on each zoo template."""
    m_path, u_path = zoo[1]
    with BamReader(m_path) as r:
        mapped = {}
        for rec in r:
            mapped.setdefault(rec.name, []).append(rec)
    with BamReader(u_path) as r:
        unmapped = {}
        for rec in r:
            unmapped.setdefault(rec.name, []).append(rec)
    for info in ([], ["Consensus"]):
        pt = port_zipper.TagInfo.from_options(remove=["NM"], reverse=info,
                                              revcomp=info)
        jt = jax_zipper.TagInfo.from_options(remove=["NM"], reverse=info,
                                             revcomp=info)
        assert (pt.remove, pt.reverse, pt.revcomp) == \
            (jt.remove, jt.reverse, jt.revcomp)
        for name, recs in mapped.items():
            p = port_zipper.merge_template(
                unmapped[name], port_zipper.MappedTemplate.from_records(
                    name, recs), pt)
            j = jax_zipper.merge_template(
                [JaxRawRecord(u.data) for u in unmapped[name]],
                jax_zipper.MappedTemplate.from_records(
                    name, [JaxRawRecord(x.data) for x in recs]), jt)
            assert p == j
    rec = next(iter(mapped.values()))[0]
    ed = TagEditor(bytearray(rec.data))
    ed.normalize_int_smallest(b"AS")
    ed.set_str(b"MC", b"5M")
    ed.remove(b"RG")
    ed.set_i32_array(b"tc", [1, 2, 3])
    assert ed.find(b"MC") == ("Z", "5M") and ed.find(b"RG") is None
    out = RawRecord(ed.finish())
    assert out.get_str(b"MC") == "5M" and out.find_tag(b"RG") is None


def _emseq_inputs(d):
    """A seeded FASTA and query-grouped mapped/unmapped EM-Seq pairs whose
    reads carry converted bases and bwameth's YD strand tag."""
    rng = np.random.default_rng(13)
    ref = {"c1": "".join("ACGT"[i] for i in rng.integers(0, 4, 4000)),
           "c2": "".join("ACGT"[i] for i in rng.integers(0, 4, 4000))}
    fa = os.path.join(d, "ref.fa")
    write_fasta(fa, {k: v.encode() for k, v in ref.items()})
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:queryname\n@SQ\tSN:c1\tLN:4000\n"
             "@SQ\tSN:c2\tLN:4000\n",
        ref_names=["c1", "c2"], ref_lengths=[4000, 4000])
    m_path, u_path = os.path.join(d, "em_m.bam"), os.path.join(d, "em_u.bam")
    with BamWriter(m_path, header) as mw, BamWriter(u_path, header) as uw:
        for i in range(80):
            name = f"e{i:04d}".encode()
            tid = i % 2
            pos = int(rng.integers(0, 3900))
            frag = ref[("c1", "c2")[tid]][pos:pos + 40]
            top = i % 4 < 2
            conv = frag.replace("C", "T") if top else frag.replace("G", "A")
            for k, fl in enumerate((0x1 | 0x40, 0x1 | 0x80)):
                ub = RecordBuilder().start_unmapped(
                    name, fl | 0x4 | 0x8, conv.encode(), [30] * 40)
                ub.tag_str(b"RX", b"ACGTACGT")
                uw.write_record_bytes(ub.finish())
                rev = 0x10 if (k == 1) != (i % 3 == 0) else 0
                mb = RecordBuilder().start_mapped(
                    name, fl | rev, tid, pos, 60,
                    [("S", 2), ("M", 36), ("I", 1), ("M", 1)],
                    conv.encode(), [30] * 40)
                if i % 5:
                    mb.tag_str(b"YD", b"f" if top else b"r")
                mw.write_record_bytes(mb.finish())
    return fa, m_path, u_path


def test_restore_unconverted_bases_matches_jax_package(tmp_path):
    fa, m_path, u_path = _emseq_inputs(str(tmp_path))
    flags = ["--restore-unconverted-bases", "--ref", fa]
    got = _zip_all(tmp_path, m_path, u_path, flags, engines=("fast",))
    assert got["jax_fast"][0] == 0
    assert got["port_fast"] == got["jax_fast"]
    plain = _zip_all(tmp_path, m_path, u_path, [], engines=("fast",))
    assert plain["port_fast"][1] != got["port_fast"][1]


@pytest.mark.parametrize("case", ["not_grouped", "mapped_only", "no_ref",
                                  "bad_ref"])
def test_zipper_refusals_exit_2_on_both(tmp_path, zoo, case):
    m_path, u_path = zoo[3]
    flags = []
    if case == "not_grouped":
        bad = str(tmp_path / "coord.bam")
        with BamReader(m_path) as r, BamWriter(bad, BamHeader(
                text=r.header.text.replace("SO:queryname", "SO:coordinate"),
                ref_names=r.header.ref_names,
                ref_lengths=r.header.ref_lengths)) as w:
            for rec in r:
                w.write_record_bytes(rec.data)
        m_path = bad
    elif case == "mapped_only":
        u_path, m_path = m_path, u_path
        part = str(tmp_path / "part.bam")
        with BamReader(m_path) as r, BamWriter(part, r.header) as w:
            for k, rec in enumerate(r):
                if k % 3:
                    w.write_record_bytes(rec.data)
        m_path, u_path = u_path, part
    elif case == "no_ref":
        flags = ["--restore-unconverted-bases"]
    else:
        flags = ["--restore-unconverted-bases", "--ref",
                 str(tmp_path / "missing.fa")]
    for main in (port_main, jax_main):
        for engine in ([], ["--classic"]):
            out = tmp_path / "out.bam"
            assert main(["zipper", "-i", m_path, "-u", u_path, "-o",
                         str(out), *flags, *engine]) == 2
            assert not out.exists()
