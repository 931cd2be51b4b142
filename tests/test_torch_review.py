"""The port's ``review`` and ``io/bam.BamIndexedReader`` against the JAX
package's.

Inputs: a grouped library (``simulate_mapped_bam`` over a 100 kb contig,
then ``group``, through the port), the same reads with some bases masked to
N standing in for a consensus BAM, sorted by coordinate with a BAI or a CSI
(``sort --write-index``), a seeded FASTA and seeded VCFs of SNV sites over
covered positions (genotypes, AF/AD, filters, indels and multi-allelic
sites that are skipped, a second sample). ``review`` through
``fgumi_tpu.cli.main`` and ``fgumi_tpu_torch.cli.main`` with a VCF, a
``.vcf.gz``, ``-s``, ``-m``, ``-N``, an interval list with ``--ref``, the
indexed pass (BAI, CSI) and the streaming one (no index, a stale index):
the three outputs byte-identical between the packages and between the
passes. The refusals (an unknown contig, an interval list without
``--ref``, an unknown sample, a selected consensus read without MI) exit 2
on both. ``BamIndexedReader.query`` over random regions: the same records
as the JAX package's reader and as a linear scan.
"""

import gzip
import os

import numpy as np
import pytest

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.io.bam import BamIndexedReader as JaxIndexedReader
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.core.clipper import MutableRecord
from fgumi_tpu_torch.core.reference import write_fasta
from fgumi_tpu_torch.io.bam import BamIndexedReader, BamReader, BamWriter
from fgumi_tpu_torch.simulate import simulate_mapped_bam
from test_torch_clip import bam_body, no_jax_native  # noqa: F401

REF_LEN = 100_000


def _write_vcf(path, sites, samples=("S1",), extra_lines=()):
    lines = ["##fileformat=VCFv4.2", "##contig=<ID=chr1,length=100000>",
             "\t".join(["#CHROM", "POS", "ID", "REF", "ALT", "QUAL",
                        "FILTER", "INFO", "FORMAT", *samples])]
    lines += [*extra_lines, *sites]
    text = "\n".join(lines) + "\n"
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_review")
    rng = np.random.default_rng(13)
    p = {k: str(d / k) for k in (
        "sim.bam", "grouped.bam", "masked.bam", "cons.bam", "cons_csi.bam",
        "cons_noidx.bam", "ref.fa", "sites.vcf", "sites.vcf.gz",
        "two.vcf", "unknown.vcf", "sites.interval_list")}
    simulate_mapped_bam(p["sim.bam"], num_families=300, family_size=4,
                        seed=13, ref_length=REF_LEN)
    assert port_main(["group", "-i", p["sim.bam"], "-o", p["grouped.bam"],
                      "-s", "adjacency", "--device", "cpu"]) == 0
    # the consensus stand-in: every 5th read with a few bases masked to N
    with BamReader(p["grouped.bam"]) as r, \
            BamWriter(p["masked.bam"], r.header) as w:
        for k, rec in enumerate(r):
            if k % 5 == 0:
                m = MutableRecord.from_raw(rec)
                seq = bytearray(m.seq)
                for i in rng.integers(0, len(seq), 6):
                    seq[i] = ord("N")
                m.seq = bytes(seq)
                w.write_record_bytes(m.encode())
            else:
                w.write_record(rec)
    for out, fmt in (("cons.bam", "bai"), ("cons_csi.bam", "csi")):
        assert port_main(["sort", "-i", p["masked.bam"], "-o", p[out],
                          "--order", "coordinate", "--write-index",
                          "--index-format", fmt]) == 0
    assert port_main(["sort", "-i", p["masked.bam"], "-o",
                      p["cons_noidx.bam"], "--order", "coordinate",
                      "--write-index", "false"]) == 0
    write_fasta(p["ref.fa"], {"chr1": bytes(
        rng.choice(list(b"ACGT"), REF_LEN).astype(np.uint8))})
    # SNV sites at covered positions: the first covering read's base as
    # the reference base at two sites of three, a random base at the rest
    with BamReader(p["cons.bam"]) as r:
        recs = list(r)
    sites = {}
    for k in rng.choice(len(recs), 120, replace=False):
        rec = recs[int(k)]
        off = int(rng.integers(0, 100))
        pos = rec.pos + off + 1
        base = chr(rec.seq_bytes()[off])
        sites.setdefault(pos, base if k % 3 else "ACGT"[int(k) % 4])
    rows = []
    for i, (pos, ref) in enumerate(sorted(sites.items())):
        ref = ref if ref in "ACGT" else "A"
        alt = "C" if ref != "C" else "T"
        gt = ["0/1", "1|0", "1/1", "./.", "0|1"][i % 5]
        fmt, val = [("GT:AD", f"{gt}:30,{i % 7}"), ("GT:AF", f"{gt}:0.0{i % 9}"),
                    ("GT", gt), ("GT:AD", f"{gt}:0,0")][i % 4]
        filt = ["PASS", ".", "LowQual", "q10;s50"][i % 4]
        rows.append(f"chr1\t{pos}\tv{i}\t{ref}\t{alt}\t50\t{filt}\t.\t{fmt}"
                    f"\t{val}")
        if i % 11 == 0:  # skipped: an indel and a multi-allelic MNV
            rows.append(f"chr1\t{pos}\t.\t{ref}\t{alt}{alt}\t50\tPASS\t.\t"
                        f"GT\t0/1")
    rows.append("chr1\t500\t.\tA\t.\t50\tPASS\t.\tGT\t0/0")
    _write_vcf(p["sites.vcf"], rows)
    _write_vcf(p["sites.vcf.gz"], rows)
    _write_vcf(p["two.vcf"], [r + "\t0/0:0.5" if ":" not in r.split("\t")[8]
                              else r + "\t" + r.split("\t")[9]
                              for r in rows], samples=("S1", "S2"))
    _write_vcf(p["unknown.vcf"], rows[:5] + ["chrX\t100\t.\tA\tC\t50\tPASS"
                                             "\t.\tGT\t0/1"])
    some = sorted(sites)[:6]
    with open(p["sites.interval_list"], "w") as f:
        f.write("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:100000\n# picked\n")
        for pos in some:
            f.write(f"chr1\t{pos}\t{pos + 2}\t+\tt\n")
    return p


def run_review(tmp_path, cons, grouped, vcf, flags=()):
    outs = (".consensus.bam", ".grouped.bam", ".txt")
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        pre = str(tmp_path / pkg)
        rc = main(["review", "-i", vcf, "-c", cons, "-g", grouped, "-o",
                   pre, *flags])
        files = {}
        for o in outs:
            path = pre + o
            if not os.path.exists(path):
                files[o] = None
            elif o.endswith(".bam"):
                files[o] = bam_body(path)
            else:
                files[o] = open(path, "rb").read()
        got[pkg] = (rc, files)
    return got


CASES = [
    ("cons.bam", "sites.vcf", []),
    ("cons.bam", "sites.vcf.gz", []),
    ("cons.bam", "sites.vcf", ["-N"]),
    ("cons.bam", "sites.vcf", ["-N", "false", "-m", "0.02"]),
    ("cons.bam", "two.vcf", ["-s", "S2"]),
    ("cons.bam", "two.vcf", []),
    ("cons.bam", "sites.interval_list", ["--ref", "ref.fa"]),
    ("cons_csi.bam", "sites.vcf", ["--ignore-ns", "true"]),
    ("cons_noidx.bam", "sites.vcf", ["-m", "1.0"]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_review_matches_jax_package(tmp_path, inputs, case, caplog):
    cons, vcf, flags = CASES[case]
    flags = [inputs.get(f, f) for f in flags]
    caplog.set_level("INFO")
    got = run_review(tmp_path, inputs[cons], inputs["grouped.bam"],
                     inputs[vcf], flags)
    assert got["port"] == got["jax"]
    rc, files = got["port"]
    assert rc == 0
    assert files[".txt"].count(b"\n") > 1
    assert len(files[".consensus.bam"][1]) > 0
    indexed = {"cons.bam": "BAI", "cons_csi.bam": "CSI"}.get(cons)
    used = [r.getMessage() for r in caplog.records
            if r.name == "fgumi_tpu_torch" and "index" in r.getMessage()]
    assert used == ([f"review: consensus pass used the {indexed} index"]
                    if indexed else [])


def test_review_indexed_equals_streaming_and_stale_index(tmp_path, inputs):
    """One VCF through the BAI pass, the CSI pass, no index and a stale BAI
    (the BAM rewritten after its index): the same three outputs."""
    runs = {}
    stale = str(tmp_path / "stale.bam")
    with open(inputs["cons.bam"], "rb") as src:
        data = src.read()
    with open(stale + ".bai", "wb") as f:
        f.write(open(inputs["cons.bam"] + ".bai", "rb").read())
    with open(stale, "wb") as f:
        f.write(data)
    os.utime(stale + ".bai", (1_000_000, 1_000_000))
    for name, cons in (("bai", inputs["cons.bam"]),
                       ("csi", inputs["cons_csi.bam"]),
                       ("none", inputs["cons_noidx.bam"]), ("stale", stale)):
        d = tmp_path / name
        d.mkdir()
        got = run_review(d, cons, inputs["grouped.bam"], inputs["sites.vcf"])
        assert got["port"] == got["jax"]
        runs[name] = got["port"]
    assert runs["bai"] == runs["csi"] == runs["none"] == runs["stale"]


def _no_mi(src, dst):
    with BamReader(src) as r, BamWriter(dst, r.header) as w:
        for rec in r:
            w.write_record_bytes(rec.data_without_tag(b"MI"))


@pytest.mark.parametrize("case", ["unknown_contig", "intervals_no_ref",
                                  "unknown_sample", "no_mi",
                                  "missing_vcf"])
def test_review_refusals_match_jax_package(tmp_path, inputs, case):
    cons, vcf, flags = inputs["cons.bam"], inputs["sites.vcf"], []
    if case == "unknown_contig":
        vcf = inputs["unknown.vcf"]
    elif case == "intervals_no_ref":
        vcf = inputs["sites.interval_list"]
    elif case == "unknown_sample":
        flags = ["-s", "S9"]
    elif case == "no_mi":
        cons = str(tmp_path / "no_mi.bam")
        _no_mi(inputs["cons_noidx.bam"], cons)
    else:
        vcf = str(tmp_path / "none.vcf")
    got = run_review(tmp_path, cons, inputs["grouped.bam"], vcf, flags)
    assert got["port"] == got["jax"]
    assert got["port"][0] == 2
    assert got["port"][1][".txt"] is None


def test_review_bad_arguments_exit_2(tmp_path, inputs):
    for argv in (["-m", "x"], ["-N", "maybe"], ["-N", "y"], []):
        for main in (port_main, jax_main):
            with pytest.raises(SystemExit) as e:
                main(["review", "-i", inputs["sites.vcf"], "-c",
                      inputs["cons.bam"], "-g", inputs["grouped.bam"],
                      *(["-o", str(tmp_path / "x")] if argv else []),
                      *argv])
            assert e.value.code == 2


@pytest.mark.parametrize("index", ["cons.bam", "cons_csi.bam"])
def test_indexed_reader_query_matches_jax_package(inputs, index):
    path = inputs[index]
    with BamReader(path) as r:
        recs = [rec.data for rec in r]
    rng = np.random.default_rng(31)
    regions = [(0, int(b), int(b) + int(n)) for b, n in zip(
        rng.integers(0, REF_LEN, 60), rng.integers(1, 3000, 60))]
    regions += [(0, 0, REF_LEN), (0, REF_LEN - 10, REF_LEN), (1, 0, 100),
                (-1, 0, 100), (0, 50_000, 50_001)]
    port, jax = BamIndexedReader(path), JaxIndexedReader(path)
    with port, jax:
        for tid, beg, end in regions:
            got = [rec.data for rec in port.query(tid, beg, end)]
            want = [rec.data for rec in jax.query(tid, beg, end)]
            scan = []
            for data in recs:
                from fgumi_tpu_torch.io.bam import RawRecord

                rec = RawRecord(data)
                end_ = rec.pos + max(rec.reference_length(), 1)
                if rec.ref_id == tid and rec.pos < end and end_ > beg:
                    scan.append(data)
            assert got == want == scan, (tid, beg, end)
