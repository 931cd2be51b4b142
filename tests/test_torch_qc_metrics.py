"""The port's QC metric helpers, ``duplex-metrics`` and ``simplex-metrics``
against the JAX package's.

Per function: ``binomial_cdf`` over a grid of (k, n, p), the Murmur3
``compute_hash_fraction`` on the pinned names of ``tests/test_metrics.py``
and 1,000 seeded random names (non-BMP characters too), ``UmiCountTracker``
and ``family_size_rows`` on seeded counts: values equal. The commands: a
grouped simplex library (``group -s adjacency``) and a grouped duplex one
(``group -s paired``, MI ``n/A`` and ``n/B``), both from ``simulate
mapped-reads`` through the port, through ``fgumi_tpu.cli.main`` and
``fgumi_tpu_torch.cli.main`` with and without ``--duplex-umi-counts``, with
a BED and a Picard interval list, ``--min-ab/--min-ba-reads`` and
``--min-reads``: every metric file byte-identical. Every refusal (a
consensus BAM, a missing MI or RX, duplex data to ``simplex-metrics``, a
single-part RX to ``duplex-metrics``, bad counts, a bad or missing
interval file, a missing input, a bad option) exits with the reference's code on both and
writes nothing.
"""

import os

import numpy as np
import pytest

import fgumi_tpu.metrics as jax_metrics
import fgumi_tpu_torch.metrics as port_metrics
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader, BamWriter
from test_torch_clip import no_jax_native  # noqa: F401

METRIC_MODULES = {"port": port_metrics, "jax": jax_metrics}


def test_binomial_cdf_matches_jax_package():
    grid = [(k, n, p) for n in (0, 1, 2, 5, 17, 60, 301, 2000)
            for k in sorted({-1, 0, 1, n // 3, n // 2, n - 1, n, n + 1})
            for p in (0.0, 0.1, 0.5, 0.73, 1.0)]
    got = {pkg: [m.binomial_cdf(*g) for g in grid]
           for pkg, m in METRIC_MODULES.items()}
    assert got["port"] == got["jax"]


def _names():
    rng = np.random.default_rng(17)
    alphabet = list("ACGTacgt0123456789:_/-#") + ["é", "漢", "\U0001F600"]
    names = ["q1", "alpha", "beta", ""] + [f"read:{i}" for i in range(50)]
    for _ in range(1000):
        n = int(rng.integers(1, 40))
        names.append("".join(rng.choice(alphabet, n)))
    return names


def test_compute_hash_fraction_matches_jax_package():
    names = _names()
    got = {pkg: [m.compute_hash_fraction(s) for s in names]
           for pkg, m in METRIC_MODULES.items()}
    assert got["port"] == got["jax"]
    assert all(0.0 <= v <= 1.0 for v in got["port"])


def test_umi_count_tracker_and_family_size_rows_match_jax_package():
    rng = np.random.default_rng(23)
    events = [("".join(rng.choice(list("ACGT"), 6)), int(rng.integers(1, 9)),
               int(rng.integers(0, 3)), bool(rng.integers(0, 2)))
              for _ in range(400)]
    hists = {p: {int(s): int(c) for s, c in zip(rng.integers(1, 30, 12),
                                               rng.integers(1, 50, 12))}
             for p in ("cs", "ss", "ds")}
    got = {}
    for pkg, m in METRIC_MODULES.items():
        t = m.UmiCountTracker()
        for ev in events:
            t.record(*ev)
        got[pkg] = (t.counts, t.total_raw(), t.total_unique(),
                    t.to_metrics(), m.family_size_rows(hists),
                    m.family_size_rows({"cs": hists["cs"]}),
                    m.family_size_rows({}))
    assert got["port"] == got["jax"]


# ------------------------------------------------------------ the commands

@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_qc_metrics")
    out = {}
    for kind, sim, strategy in (("simplex", [], "adjacency"),
                                ("duplex", ["--paired-umis"], "paired")):
        sim_path = str(d / f"{kind}.sim.bam")
        out[kind] = str(d / f"{kind}.grouped.bam")
        assert port_main(["simulate", "mapped-reads", "-o", sim_path,
                          "--num-families", "300", "--seed", "3",
                          *sim]) == 0
        assert port_main(["group", "-i", sim_path, "-o", out[kind], "-s",
                          strategy, "--device", "cpu"]) == 0
    with BamReader(out["duplex"]) as r:
        starts = sorted({rec.pos for rec in r if rec.pos >= 0})
    # half of the positions, as a BED (0-based) and an interval list
    picked = starts[::2]
    bed = d / "half.bed"
    bed.write_text("# half of the positions\n" + "".join(
        f"chr1\t{p}\t{p + 150}\textra\n" for p in picked))
    ilist = d / "half.interval_list"
    ilist.write_text("@HD\tVN:1.6\n@SQ\tSN:chr1\tLN:10000000\n" + "".join(
        f"chr1\t{p + 1}\t{p + 150}\t+\tx\n" for p in picked))
    out.update(bed=str(bed), ilist=str(ilist), dir=d)
    return out


def _edited(src, dst, edit):
    """``src`` with ``edit(RawRecord) -> bytes or None`` applied to every
    record (None drops it)."""
    with BamReader(src) as r, BamWriter(dst, r.header) as w:
        for rec in r:
            data = edit(rec)
            if data is not None:
                w.write_record_bytes(data)


DUPLEX_OUTS = (".family_sizes.txt", ".duplex_family_sizes.txt",
               ".duplex_yield_metrics.txt", ".umi_counts.txt",
               ".duplex_umi_counts.txt")
SIMPLEX_OUTS = (".family_sizes.txt", ".simplex_yield_metrics.txt",
                ".umi_counts.txt")


def run_metrics(tmp_path, command, inp, flags, outs):
    got = {}
    for pkg, main in (("port", port_main), ("jax", jax_main)):
        prefix = str(tmp_path / pkg)
        rc = main([command, "-i", inp, "-o", prefix, *flags])
        got[pkg] = (rc, {o: open(prefix + o, "rb").read()
                         if os.path.exists(prefix + o) else None
                         for o in outs})
    return got


DUPLEX_CASES = [
    [], ["--duplex-umi-counts"], ["--min-ab-reads", "2"],
    ["--min-ab-reads", "3", "--min-ba-reads", "2", "--duplex-umi-counts"],
    ["--intervals", "bed"], ["--intervals", "ilist", "--duplex-umi-counts"],
    ["--description", "a sample", "--min-ab-reads", "2"],
]


@pytest.mark.parametrize("case", range(len(DUPLEX_CASES)))
def test_duplex_metrics_match_jax_package(tmp_path, grouped, case):
    flags = [grouped.get(f, f) for f in DUPLEX_CASES[case]]
    got = run_metrics(tmp_path, "duplex-metrics", grouped["duplex"], flags,
                      DUPLEX_OUTS)
    assert got["port"] == got["jax"]
    rc, outs = got["port"]
    assert rc == 0
    assert (outs[".duplex_umi_counts.txt"] is not None) \
        == ("--duplex-umi-counts" in flags)
    assert outs[".duplex_yield_metrics.txt"].count(b"\n") == 21


SIMPLEX_CASES = [[], ["--min-reads", "3"], ["--intervals", "bed"],
                 ["--intervals", "ilist", "--min-reads", "2"],
                 ["--description", "x"]]


@pytest.mark.parametrize("case", range(len(SIMPLEX_CASES)))
def test_simplex_metrics_match_jax_package(tmp_path, grouped, case):
    flags = [grouped.get(f, f) for f in SIMPLEX_CASES[case]]
    got = run_metrics(tmp_path, "simplex-metrics", grouped["simplex"],
                      flags, SIMPLEX_OUTS)
    assert got["port"] == got["jax"]
    rc, outs = got["port"]
    assert rc == 0 and outs[".umi_counts.txt"].count(b"\n") > 100


def _bad_input(kind, grouped, d):
    """(input path, extra flags) of a refusal case."""
    src = grouped["duplex"]
    path = os.path.join(d, f"{kind}.bam")
    if kind == "consensus_bam":
        _edited(src, path, lambda r: r.data + b"cDi\x05\x00\x00\x00")
    elif kind == "missing_mi":
        _edited(src, path, lambda r: r.data_without_tag(b"MI"))
    elif kind == "missing_rx":
        _edited(src, path, lambda r: r.data_without_tag(b"RX"))
    elif kind == "single_part_rx":
        _edited(src, path, lambda r: r.data_without_tag(b"RX")
                + b"RXZACGTACGT\x00")
    elif kind == "bad_bed":
        bed = os.path.join(d, "bad.bed")
        with open(bed, "w") as f:
            f.write("chr1\t100\n")
        return src, ["--intervals", bed]
    elif kind == "missing_intervals":
        return src, ["--intervals", os.path.join(d, "none.bed")]
    elif kind == "missing_input":
        return os.path.join(d, "none.bam"), []
    else:
        return src, []
    return path, []


DUPLEX_REFUSALS = [
    ("consensus_bam", []), ("missing_mi", []), ("missing_rx", []),
    ("single_part_rx", []), ("bad_bed", []), ("missing_intervals", []),
    ("missing_input", []), ("ok", ["--min-ab-reads", "0"]), ("ok", ["--min-ba-reads", "0"]),
    ("ok", ["--min-ab-reads", "1", "--min-ba-reads", "2"]),
]


@pytest.mark.parametrize("case", range(len(DUPLEX_REFUSALS)))
def test_duplex_metrics_refusals_match_jax_package(tmp_path, grouped, case):
    kind, flags = DUPLEX_REFUSALS[case]
    inp, extra = _bad_input(kind, grouped, str(tmp_path))
    got = run_metrics(tmp_path, "duplex-metrics", inp, flags + extra,
                      DUPLEX_OUTS)
    assert got["port"] == got["jax"]
    assert got["port"] == (2, {o: None for o in DUPLEX_OUTS})


SIMPLEX_REFUSALS = [
    ("consensus_bam", []), ("missing_mi", []), ("missing_rx", []),
    ("duplex_data", []), ("bad_bed", []), ("missing_intervals", []),
    ("missing_input", []), ("ok", ["--min-reads", "0"]),
]


@pytest.mark.parametrize("case", range(len(SIMPLEX_REFUSALS)))
def test_simplex_metrics_refusals_match_jax_package(tmp_path, grouped,
                                                    case):
    kind, flags = SIMPLEX_REFUSALS[case]
    inp, extra = _bad_input(kind, grouped, str(tmp_path))
    if kind == "ok":
        inp = grouped["simplex"]
    got = run_metrics(tmp_path, "simplex-metrics", inp, flags + extra,
                      SIMPLEX_OUTS)
    assert got["port"] == got["jax"]
    assert got["port"] == (2, {o: None for o in SIMPLEX_OUTS})


@pytest.mark.parametrize("command,argv", [
    ("duplex-metrics", ["-o", "x", "--min-ab-reads", "two"]),
    ("simplex-metrics", ["-o", "x", "--min-reads"]),
    ("duplex-metrics", ["-o", "x", "--no-such-option"]),
    ("simplex-metrics", []),  # no -o
])
def test_metrics_bad_arguments_exit_2(tmp_path, grouped, command, argv):
    for main in (port_main, jax_main):
        with pytest.raises(SystemExit) as e:
            main([command, "-i", grouped["duplex"], *argv])
        assert e.value.code == 2


def test_template_metadata_and_intervals_match_jax_package(grouped):
    import fgumi_tpu.commands.metrics_common as jax_mc
    import fgumi_tpu_torch.commands.metrics_common as port_mc

    got = {}
    for pkg, mc in (("port", port_mc), ("jax", jax_mc)):
        groups = []
        ivs = mc.parse_intervals(grouped["ilist"])
        total, counts = mc.process_templates_from_bam(
            grouped["duplex"], ivs, 20,
            lambda g, fc: groups.append(
                [(m.template.__dict__, m.base_umi, m.is_a_strand,
                  m.is_b_strand) for m in mc.compute_template_metadata(g)]))
        got[pkg] = (total, counts, groups,
                    [iv.__dict__ for iv in mc.parse_intervals(
                        grouped["bed"])], [iv.__dict__ for iv in ivs],
                    mc.DOWNSAMPLING_FRACTIONS)
    assert got["port"] == got["jax"]
    assert got["port"][0] > 0
