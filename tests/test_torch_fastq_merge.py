"""The port's ``fastq`` and ``merge`` and ``simulate consensus-reads``
against the JAX package's ``fgumi_tpu.cli.main``.

``fastq``: the zipper zoo's mapped BAM (pairs far apart, secondary and
supplementary records, fragments, unmapped and reverse-strand reads) and its
zippered output (RX/OX UMIs with a duplex '-'), under ``-F``, ``-f``, ``-n``,
``-a``, ``--umi-tag``, ``--umi-sep`` and ``--umi-name-delim``, to a file and
to stdout: the bytes must be equal. ``merge``: the zoo split in thirds, each
sorted by the port's ``sort`` in every order and subsort, merged by both
packages (``-i`` and ``--input-list``): the records must equal each other
and, but for coordinate order (whose keys tie), those of the whole input
sorted at once, and the headers must be equal but for @PG. The refusals (an
input in another order, differing references, an unreadable list, a missing
file, no input) exit 2 on both with nothing written. The JAX package's
native library is built from its source into a pytest temporary directory,
so its merge takes its batch-key route.
"""

import gzip
import os

import pytest

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamHeader, BamReader, BamWriter
from test_torch_dedup import jax_lib, with_jax_lib  # noqa: F401 (fixtures)
from test_torch_zipper import _header_and_records, zip_pair_bams


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_fastq_merge")
    m_path, u_path = zip_pair_bams(str(d), 4, n_templates=200)
    zipped = str(d / "zipped.bam")
    assert port_main(["zipper", "-i", m_path, "-u", u_path, "-o",
                      zipped]) == 0
    # duplex UMIs on half of the zippered reads (RX or only OX)
    duplex = str(d / "duplex.bam")
    with BamReader(zipped) as r, BamWriter(duplex, r.header) as w:
        for k, rec in enumerate(r):
            data = rec.data
            if k % 3 == 0:
                data = rec.data_without_tag(b"RX") + b"OXZAC-GT\x00"
            w.write_record_bytes(data)
    return {"mapped": m_path, "zipped": zipped, "duplex": duplex, "dir": d}


FASTQ_CASES = [
    ("mapped", []), ("mapped", ["-F", "0"]), ("mapped", ["-F", "0x800"]),
    ("mapped", ["-F", "0x100", "-n"]), ("mapped", ["-f", "0x40"]),
    ("mapped", ["-f", "1", "-F", "0x904"]), ("zipped", ["-a"]),
    ("zipped", ["-n", "true", "-a", "--umi-name-delim", "_"]),
    ("duplex", ["-a", "--umi-tag", "OX,RX", "--umi-sep", "_"]),
    ("duplex", ["-U", "--umi-tag", "RX"]),
]


@pytest.mark.parametrize("case", range(len(FASTQ_CASES)))
def test_fastq_matches_jax_package(tmp_path, inputs, case):
    name, flags = FASTQ_CASES[case]
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        out = str(tmp_path / f"{pkg}.fq")
        assert main(["fastq", "-i", inputs[name], "-o", out, *flags]) == 0
        got[pkg] = open(out, "rb").read()
    assert got["port"] == got["jax"]
    assert got["port"].count(b"\n+\n") > 100


def test_fastq_to_stdout_matches_jax_package(inputs, capsysbinary):
    outs = []
    for main in (port_main, jax_main):
        assert main(["fastq", "-i", inputs["zipped"], "-a"]) == 0
        outs.append(capsysbinary.readouterr().out)
    assert outs[0] == outs[1] and outs[0].startswith(b"@q")


def test_fastq_missing_input_writes_nothing(tmp_path):
    for main in (port_main, jax_main):
        out = tmp_path / "x.fq"
        with pytest.raises(OSError):
            main(["fastq", "-i", str(tmp_path / "none.bam"), "-o", str(out)])
        assert not out.exists()


ORDERS = [("template-coordinate", "natural"), ("coordinate", "natural"),
          ("queryname", "natural"), ("queryname", "lex")]


def _split_sorted(d, src, order, subsort, parts=3):
    """``src`` in ``parts`` consecutive pieces, each sorted by the port;
    the whole sorted once too (records of equal keys keep their input
    order in both)."""
    with BamReader(src) as r:
        header, recs = r.header, [rec.data for rec in r]
    paths = []
    for k in range(parts):
        raw = os.path.join(d, f"raw{k}.bam")
        with BamWriter(raw, header) as w:
            for data in recs[k * len(recs) // parts:
                             (k + 1) * len(recs) // parts]:
                w.write_record_bytes(data)
        paths.append(os.path.join(d, f"part{k}.{order}.{subsort}.bam"))
        assert port_main(["sort", "-i", raw, "-o", paths[-1], "--order",
                          order, "--subsort", subsort]) == 0
    whole = os.path.join(d, f"whole.{order}.{subsort}.bam")
    assert port_main(["sort", "-i", src, "-o", whole, "--order", order,
                      "--subsort", subsort]) == 0
    return paths, whole


@pytest.mark.parametrize("order,subsort", ORDERS)
def test_merge_matches_jax_package_and_whole_sort(tmp_path, inputs, order,
                                                  subsort):
    parts, whole = _split_sorted(str(tmp_path), inputs["zipped"], order,
                                 subsort)
    lst = tmp_path / "inputs.txt"
    lst.write_text("# sorted parts\n" + "\n".join(parts[1:]) + "\n\n")
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        for how, args in (("i", ["-i", *parts]),
                          ("list", ["-i", parts[0], "--input-list",
                                    str(lst)])):
            out = str(tmp_path / f"{pkg}_{how}.bam")
            assert main(["merge", *args, "-o", out, "--order", order,
                         "--subsort", subsort]) == 0
            got[f"{pkg}_{how}"] = _header_and_records(out)
    want = got["jax_i"]
    for key, res in got.items():
        assert res == want, key
    if order != "coordinate":
        # coordinate keys tie on (tid, pos), and the sort keeps no input
        # order among ties; the other orders' keys leave no tie here
        assert want[1] == _header_and_records(whole)[1]


@pytest.mark.parametrize("case", ["wrong_order", "refs", "no_list",
                                  "missing_in_list", "no_inputs"])
def test_merge_refusals_exit_2_on_both(tmp_path, inputs, case):
    parts, _ = _split_sorted(str(tmp_path), inputs["zipped"], "queryname",
                             "natural", parts=2)
    args = ["-i", *parts]
    if case == "wrong_order":
        args = ["-i", *parts, "--subsort", "lex"]
    elif case == "refs":
        bad2 = str(tmp_path / "refs2.bam")
        with BamReader(parts[1]) as r, BamWriter(bad2, BamHeader(
                text=r.header.text, ref_names=["c1", "cX"],
                ref_lengths=r.header.ref_lengths)) as w:
            for rec in r:
                w.write_record_bytes(rec.data)
        args = ["-i", parts[0], bad2]
    elif case == "no_list":
        args = ["-i", parts[0], "--input-list", str(tmp_path / "none.txt")]
    elif case == "missing_in_list":
        lst = tmp_path / "l.txt"
        lst.write_text(str(tmp_path / "gone.bam") + "\n")
        args = ["-i", parts[0], "--input-list", str(lst)]
    else:
        args = []
    for main in (port_main, jax_main):
        out = tmp_path / "out.bam"
        assert main(["merge", *args, "-o", str(out), "--order",
                     "queryname"]) == 2
        assert not out.exists()


@pytest.mark.parametrize("argv", [
    ["-n", "60", "--seed", "3"],
    ["-n", "40", "-l", "30", "--min-depth", "2", "--max-depth", "4",
     "--depth-mean", "3", "--error-rate-mean", "0.05", "--no-per-base-tags",
     "--seed", "8"],
])
def test_simulate_consensus_reads_matches_jax_package(tmp_path, argv):
    files = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        bam, tsv = str(tmp_path / f"{name}.bam"), str(tmp_path / f"{name}.tsv")
        assert main(["simulate", "consensus-reads", "-o", bam, "--truth", tsv,
                     *argv]) == 0
        files[name] = (gzip.open(bam).read(), open(tsv, "rb").read())
    assert files["port"] == files["jax"]
