"""The port's ``downsample`` against the JAX package's.

A grouped library (``simulate mapped-reads`` then ``group``, through the
port) is downsampled by ``fgumi_tpu.cli.main`` and
``fgumi_tpu_torch.cli.main`` at several fractions and seeds, with
``--rejects`` and both histograms, with integer MI tags, at other
compression levels and with ``--validate-mi-order false`` on an input
whose families are split: records (all but @PG), rejects and histograms
byte-identical, and kept and rejected records together the input, family
by family. Every refusal (a fraction outside (0, 1], NaN, split families, a
record without MI) exits 2 on both and publishes no output.
"""

import os

import pytest

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader, BamWriter
from test_torch_clip import bam_body, no_jax_native  # noqa: F401


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_downsample")
    sim, out = str(d / "sim.bam"), str(d / "grouped.bam")
    assert port_main(["simulate", "mapped-reads", "-o", sim,
                      "--num-families", "300", "--family-size", "4",
                      "--seed", "9"]) == 0
    assert port_main(["group", "-i", sim, "-o", out, "-s", "adjacency",
                      "--device", "cpu"]) == 0
    with BamReader(out) as r:
        header, recs = r.header, list(r)
    paths = {"grouped": out}
    # the same records with MI as an integer
    paths["int_mi"] = str(d / "int_mi.bam")
    with BamWriter(paths["int_mi"], header) as w:
        for rec in recs:
            mi = int(rec.get_str(b"MI"))
            w.write_record_bytes(rec.data_without_tag(b"MI") + b"MIi"
                                 + mi.to_bytes(4, "little"))
    # the first record moved to the end: its family's MI in two blocks
    paths["split"] = str(d / "split.bam")
    with BamWriter(paths["split"], header) as w:
        for rec in recs[1:] + recs[:1]:
            w.write_record(rec)
    paths["no_mi"] = str(d / "no_mi.bam")
    with BamWriter(paths["no_mi"], header) as w:
        for k, rec in enumerate(recs):
            w.write_record_bytes(rec.data_without_tag(b"MI") if k == 40
                                 else rec.data)
    return paths


OUTS = (".bam", ".rejects.bam", ".kept.tsv", ".rejected.tsv")


def run_both(tmp_path, inp, flags, outs=OUTS):
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        pre = str(tmp_path / pkg)
        rc = main(["downsample", "-i", inp, "-o", pre + ".bam",
                   "--rejects", pre + ".rejects.bam", "--histogram-kept",
                   pre + ".kept.tsv", "--histogram-rejected",
                   pre + ".rejected.tsv", *flags])
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


def _families(recs):
    from fgumi_tpu_torch.io.bam import RawRecord

    fams = {}
    for data in recs:
        fams.setdefault(RawRecord(data).find_tag(b"MI"), []).append(data)
    return fams


CASES = [
    ("grouped", ["-f", "0.5", "--seed", "7"]),
    ("grouped", ["-f", "0.1", "--seed", "1"]),
    ("grouped", ["-f", "0.9", "--seed", "42", "--compression-level", "0"]),
    ("grouped", ["-f", "1.0", "--seed", "3"]),
    ("grouped", ["-f", "0.25", "--seed", "5", "--compression-level", "6"]),
    ("int_mi", ["-f", "0.5", "--seed", "7"]),
    ("split", ["-f", "0.5", "--seed", "2", "--validate-mi-order", "false"]),
]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_downsample_matches_jax_package(tmp_path, grouped, case):
    name, flags = CASES[case]
    got = run_both(tmp_path, grouped[name], flags)
    assert got["port"] == got["jax"]
    rc, files = got["port"]
    assert rc == 0
    _, inp = bam_body(grouped[name])
    kept, rejected = files[".bam"][1], files[".rejects.bam"][1]
    assert len(kept) + len(rejected) == len(inp)
    if name != "split":
        want = _families(inp)
        both = {**_families(kept), **_families(rejected)}
        assert both == want
        hist = [files[".kept.tsv"], files[".rejected.tsv"]]
        fams = sum(int(line.split(b"\t")[1]) for h in hist
                   for line in h.splitlines()[1:])
        assert fams == len(want)
    if "1.0" in flags:
        assert kept == inp and not rejected


def test_downsample_without_outputs_matches_jax_package(tmp_path, grouped):
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        out = str(tmp_path / f"{pkg}.bam")
        assert main(["downsample", "-i", grouped["grouped"], "-o", out,
                     "-f", "0.3", "--seed", "11"]) == 0
        got[pkg] = bam_body(out)
    assert got["port"] == got["jax"]


REFUSALS = [
    ("grouped", ["-f", "0"]), ("grouped", ["-f", "1.5"]),
    ("grouped", ["-f", "-0.1"]), ("grouped", ["-f", "nan"]),
    ("grouped", ["-f", "inf"]), ("split", ["-f", "0.5", "--seed", "1"]),
    ("no_mi", ["-f", "0.5", "--seed", "1"]),
    ("missing", ["-f", "0.5"]),
]


@pytest.mark.parametrize("case", range(len(REFUSALS)))
def test_downsample_refusals_match_jax_package(tmp_path, grouped, case):
    name, flags = REFUSALS[case]
    inp = grouped.get(name, str(tmp_path / "none.bam"))
    got = run_both(tmp_path, inp, flags)
    assert got["port"] == got["jax"]
    assert got["port"] == (2, {o: None for o in OUTS})


def test_downsample_bad_arguments_exit_2(tmp_path, grouped):
    for argv in (["-f", "half"], [], ["-f", "0.5",
                                     "--validate-mi-order", "maybe"]):
        for main in (port_main, jax_main):
            with pytest.raises(SystemExit) as e:
                main(["downsample", "-i", grouped["grouped"], "-o",
                      str(tmp_path / "x.bam"), *argv])
            assert e.value.code == 2
