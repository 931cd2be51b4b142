"""The port's ``correct`` (``commands/correct.py``, ``fast_correct.py`` and
the command line) and ``simulate correct-reads`` against the JAX package's.

Each CLI case runs four times on the same input: the port's batch engine and
``--classic``, and the JAX package's batch engine and ``--classic``
(``fgumi_tpu.cli.main``, its native library built from its source into a
pytest temporary directory, never its own build path). The exit codes must
be equal, and so must the records of the output and of ``-r`` (the header
too, but for its @PG line) and the bytes of ``-m``. The inputs: ``simulate
correct-reads`` at a few seeds and error counts, and a messy BAM of paired
and fragment templates with dual UMIs, lowercase UMIs, missing UMIs, UMIs
of the wrong length and stale OX/ob tags. The matcher cases of
``tests/test_correct.py`` run on both packages' functions, the batch engine
also over record batches of a few hundred bytes (templates split across
batches), and the error inputs exit 2 on both packages with nothing
written.
"""

import numpy as np
import pytest

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.commands import correct as jax_correct
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.commands import correct as port_correct
from fgumi_tpu_torch.commands.fast_correct import run_correct_fast
from fgumi_tpu_torch.io.bam import (BamHeader, BamReader, BamWriter,
                                    FLAG_FIRST, FLAG_LAST, FLAG_PAIRED,
                                    FLAG_UNMAPPED, RecordBuilder)
from fgumi_tpu_torch.io.batch_reader import BamBatchReader
from test_torch_dedup import jax_lib, with_jax_lib  # noqa: F401 (fixtures)
from test_torch_zipper import _header_and_records


WHITELIST = ["AACCGGTT", "ACGTACGT", "CATGCATG", "GGGGAAAA", "TTTTCCCC",
             "TGCATGCA", "CCAAGGTT", "GTACGTAC"]


def _mutate(umi: str, rng, n: int) -> str:
    s = list(umi)
    for p in rng.choice(len(s), size=n, replace=False):
        s[p] = "ACGT"[("ACGT".index(s[p]) + int(rng.integers(1, 4))) % 4]
    return "".join(s)


def messy_bam(path, seed: int, n_templates: int = 120):
    """Paired and fragment templates whose RX (and BC) are single or dual
    UMIs from :data:`WHITELIST` with 0-3 errors, some lowercase, some
    missing on every record, some of the wrong length, some with a stale
    OX or ob."""
    rng = np.random.default_rng(seed)
    header = BamHeader(text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
                            "@RG\tID:A\tSM:s\tLB:l\n",
                       ref_names=[], ref_lengths=[])
    with BamWriter(path, header) as w:
        for i in range(n_templates):
            kind = rng.random()
            segs = [_mutate(WHITELIST[int(rng.integers(len(WHITELIST)))],
                            rng, int(rng.integers(0, 4)))
                    for _ in range(1 + (i % 3 == 0))]
            umi = "-".join(segs)
            if kind < 0.1:
                umi = umi[:-2]
            elif kind < 0.25:
                umi = umi.lower()
            present = kind >= 0.05
            paired = i % 4 != 1
            flags = ([FLAG_UNMAPPED | FLAG_PAIRED | FLAG_FIRST,
                      FLAG_UNMAPPED | FLAG_PAIRED | FLAG_LAST] if paired
                     else [FLAG_UNMAPPED])
            for fl in flags:
                b = RecordBuilder().start_unmapped(
                    f"t{i:04d}".encode(), fl, b"ACGTACGTAC", [30] * 10)
                b.tag_str(b"RG", b"A")
                if present:
                    b.tag_str(b"RX", umi.encode())
                    b.tag_str(b"BC", umi.encode())
                if i % 7 == 0:
                    b.tag_str(b"OX", b"STALE")
                    b.tag_str(b"ob", b"STALE")
                w.write_record_bytes(b.finish())
    return path


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_correct")
    p = {}
    for name, argv in (("sim", ["-n", "600", "--num-umis", "40",
                                "--seed", "5"]),
                       ("sim_err3", ["-n", "400", "--num-umis", "25", "-u",
                                     "6", "--max-errors", "3", "--seed",
                                     "9"])):
        bam, wl = str(d / f"{name}.bam"), str(d / f"{name}.txt")
        assert port_main(["simulate", "correct-reads", "-o", bam, "-i", wl,
                          *argv]) == 0
        p[name] = (bam, ["-U", wl])
    wl = d / "messy.txt"
    wl.write_text("\n".join(WHITELIST) + "\n")
    p["messy"] = (messy_bam(str(d / "messy.bam"), seed=3), ["-U", str(wl)])
    p["messy_b"] = (messy_bam(str(d / "messy_b.bam"), seed=8),
                    ["-u", *WHITELIST[:5], "-U", str(wl)])
    return p


CASES = [
    ("sim", []),
    ("sim", ["--max-mismatches", "0"]),
    ("sim", ["--max-mismatches", "1", "--min-distance", "3"]),
    ("sim", ["--max-mismatches", "3", "--min-distance", "1"]),
    ("sim", ["--min-distance", "0", "--cache-size", "0"]),
    ("sim", ["--cache-size", "1", "--dont-store-original"]),
    ("sim_err3", ["--max-mismatches", "3", "--min-distance", "2"]),
    ("sim_err3", ["--revcomp"]),
    ("messy", []),
    ("messy", ["--target", "barcode"]),
    ("messy", ["--target", "barcode", "--dont-store-original"]),
    ("messy", ["--revcomp", "--max-mismatches", "1"]),
    ("messy", ["--min-distance", "0", "--max-mismatches", "3"]),
    ("messy", ["--cache-size", "1", "--min-corrected", "0.1"]),
    ("messy", ["--min-corrected", "0.99"]),
    ("messy_b", ["--min-distance", "3", "--cache-size", "0"]),
]


def _run_all(tmp_path, inp, wl, flags):
    """Exit code, records, rejects and metrics of each of the four runs."""
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        for engine in ("fast", "classic"):
            key = f"{pkg}_{engine}"
            out = str(tmp_path / f"{key}.bam")
            rej = str(tmp_path / f"{key}.rej.bam")
            met = str(tmp_path / f"{key}.tsv")
            argv = ["correct", "-i", inp, "-o", out, "-r", rej, "-m", met,
                    *wl, *flags]
            if engine == "classic":
                argv.append("--classic")
            rc = main(argv)
            got[key] = (rc, _header_and_records(out),
                        _header_and_records(rej), open(met, "rb").read())
    return got


@pytest.mark.parametrize("case", range(len(CASES)))
def test_correct_matches_jax_package(tmp_path, inputs, case):
    name, flags = CASES[case]
    inp, wl = inputs[name]
    got = _run_all(tmp_path, inp, wl, flags)
    want = got["jax_classic"]
    assert want[0] == (1 if "0.99" in flags else 0)
    assert len(want[1][1]) > 0 and len(want[3]) > 0
    for key, res in got.items():
        assert res == want, f"{key} differs from the JAX package's classic"


def test_correct_target_barcode_writes_bc_and_ob(tmp_path, inputs):
    """``--target barcode`` corrects BC and keeps the original in ob."""
    inp, wl = inputs["messy"]
    out = str(tmp_path / "bc.bam")
    assert port_main(["correct", "-i", inp, "-o", out, *wl, "--target",
                      "barcode"]) == 0
    with BamReader(out) as r:
        recs = list(r)
    corrected = [rec for rec in recs if rec.get_str(b"ob") not in
                 (None, "STALE")]
    assert corrected
    for rec in corrected:
        assert rec.get_str(b"BC") in WHITELIST or "-" in rec.get_str(b"BC")
        assert rec.get_str(b"RX") == rec.get_str(b"ob")


def _bad_bam(path, kind):
    header = BamHeader(text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n",
                       ref_names=[], ref_lengths=[])
    with BamWriter(path, header) as w:
        for i, fl in enumerate((FLAG_UNMAPPED | FLAG_PAIRED | FLAG_FIRST,
                                FLAG_UNMAPPED | FLAG_PAIRED | FLAG_LAST)):
            b = RecordBuilder().start_unmapped(b"t0", fl, b"ACGT", [30] * 4)
            if kind == "mismatched":
                b.tag_str(b"RX", WHITELIST[i].encode())
            elif kind == "presence":
                if i == 0:
                    b.tag_str(b"RX", WHITELIST[0].encode())
            elif kind == "type":
                b.tag_int(b"RX", 7)
            w.write_record_bytes(b.finish())
    return path


@pytest.mark.parametrize("kind", ["mismatched", "presence", "type",
                                  "--min-corrected", "no-whitelist",
                                  "uneven-whitelist"])
def test_correct_errors_exit_as_jax_package(tmp_path, kind):
    """Inconsistent template UMIs, a non-Z UMI tag and bad arguments: each
    engine exits as the JAX package's does (2 on the per-template engine,
    which checks every record's tag type), and nothing is written."""
    wl = ["-u", *WHITELIST]
    flags = []
    if kind in ("mismatched", "presence", "type"):
        inp = _bad_bam(str(tmp_path / "bad.bam"), kind)
    else:
        inp = messy_bam(str(tmp_path / "ok.bam"), seed=1, n_templates=4)
        if kind == "no-whitelist":
            wl = []
        elif kind == "uneven-whitelist":
            wl = ["-u", "ACGT", "ACGTA"]
        else:
            flags = [kind, "1.5"]
    for engine in ([], ["--classic"]):
        rcs = []
        for main in (port_main, jax_main):
            out = tmp_path / "out.bam"
            rcs.append(main(["correct", "-i", inp, "-o", str(out), *wl,
                             *flags, *engine]))
            assert rcs[-1] == 0 or not out.exists()
        assert rcs[0] == rcs[1]
        if engine or kind != "type":
            assert rcs[0] == 2


@pytest.mark.parametrize("target,chunk", [(300, "umi"), (600, "barcode"),
                                          (1, "umi")])
def test_fast_correct_over_small_batches(tmp_path, inputs, target, chunk):
    """The batch engine over record batches of ``target`` bytes (templates
    split across batches) writes what the per-template engine writes."""
    inp, wl = inputs["messy"]
    umis, n = port_correct.load_umi_sequences((), [wl[1]])
    got = {}
    for engine in ("fast", "classic"):
        m = port_correct.UmiMatcher(umis, 2, 2)
        out = str(tmp_path / f"{engine}.bam")
        rej = str(tmp_path / f"{engine}.rej.bam")
        reader = (BamBatchReader(inp, target_bytes=target)
                  if engine == "fast" else BamReader(inp))
        with reader, BamWriter(out, reader.header) as w, \
                BamWriter(rej, reader.header) as rw:
            run = (run_correct_fast if engine == "fast"
                   else port_correct.run_correct)
            stats = run(reader, w, m, n, target=chunk, rejects_writer=rw)
        got[engine] = (_header_and_records(out), _header_and_records(rej),
                       stats)
    assert got["fast"] == got["classic"]


def _matchers(umis, max_mismatches=2, min_distance_diff=2):
    return [mod.UmiMatcher(list(umis), max_mismatches, min_distance_diff)
            for mod in (port_correct, jax_correct)]


@pytest.mark.parametrize("umis,observed,kw,want", [
    (["AAAAAA", "CCCCCC"], b"AAAAAA", {}, (True, "AAAAAA", 0)),
    (["AAAAAA", "CCCCCC"], b"AAAATA", {}, (True, "AAAAAA", 1)),
    (["AAAAAA", "CCCCCC"], b"AATTTA", {}, (False, "AAAAAA", 3)),
    (["AAAAAA", "AAAATT"], b"AAAATA", {}, (False, "AAAAAA", 1)),
    (["AAAAAA"], b"AAAAAC", {"min_distance_diff": 5}, (True, "AAAAAA", 1)),
])
def test_matcher_matches_jax_package(umis, observed, kw, want):
    port, jax = _matchers(umis, **kw)
    assert port.find_best(observed) == jax.find_best(observed) == want


@pytest.mark.parametrize("umi,revcomp,umis", [
    ("aaaaaa", False, ["AAAAAA"]),
    ("AAAACC-GGGTTT", False, ["AAAACC", "GGGTTT"]),
    ("AAACCC-GGTTTT", True, ["AAAACC", "GGGTTT"]),
    ("AAAA", False, ["AAAAAA"]),
    ("AAAAAT-CCCCCC", False, ["AAAAAA", "TTTTTT"]),
])
def test_template_correction_matches_jax_package(umi, revcomp, umis):
    port, jax = _matchers(umis, min_distance_diff=1)
    a = port_correct.compute_template_correction(umi, 6, revcomp, port)
    b = jax_correct.compute_template_correction(umi, 6, revcomp, jax)
    assert a.__dict__ == b.__dict__
    if umi == "AAACCC-GGTTTT":
        assert a.matched and a.corrected_umi == "AAAACC-GGGTTT"
        assert a.needs_correction


def test_load_and_pairs_match_jax_package(tmp_path):
    f = tmp_path / "wl.txt"
    f.write_text("acgtaa\nTTTTTT\n\nACGTAT\n")
    got = port_correct.load_umi_sequences(["GGGGGG"], [str(f)])
    assert got == jax_correct.load_umi_sequences(["GGGGGG"], [str(f)])
    assert got == (["ACGTAA", "ACGTAT", "GGGGGG", "TTTTTT"], 6)
    for d in range(4):
        assert port_correct.find_umi_pairs_within_distance(got[0], d) == \
            jax_correct.find_umi_pairs_within_distance(got[0], d)


@pytest.mark.parametrize("argv", [
    ["-n", "300", "--num-umis", "30", "--seed", "4"],
    ["-n", "200", "--num-umis", "10", "-u", "5", "-l", "30",
     "--max-errors", "4", "--seed", "6"],
])
def test_simulate_correct_reads_matches_jax_package(tmp_path, argv):
    import gzip

    files = {}
    for name, main in (("jax", jax_main), ("port", port_main)):
        paths = [str(tmp_path / f"{name}.{ext}")
                 for ext in ("bam", "txt", "tsv")]
        assert main(["simulate", "correct-reads", "-o", paths[0], "-i",
                     paths[1], "--truth", paths[2], *argv]) == 0
        files[name] = [gzip.open(paths[0]).read(),
                       open(paths[1], "rb").read(),
                       open(paths[2], "rb").read()]
    assert files["port"] == files["jax"]
