"""The port's ``dedup`` (``commands/dedup.py``, ``FastDedup`` and the command
line) against the JAX package's ``fgumi_tpu.cli.main(["dedup", ...])``.

Each case runs four times on the same input: the port's batch engine and
``--classic`` (``--device cpu``), and the JAX package's batch engine and
``--classic``. The records must be equal (the header too, but for its @PG
line, which names each program), and so must the bytes of the ``-m``
metrics and ``-H`` family-size files. The inputs: ``simulate mapped-reads``
(single and paired UMIs), the awkward templates of ``test_torch_group``
(mapping qualities, MQ tags, QC-fail, unmapped mates, fragments, secondary
records, soft clips, short and N-containing UMIs; the strategies that
compare UMIs run it with ``-l 6``, since it mixes UMI lengths), the same
with CB cell barcodes on a third of the templates, and one amplicon
position of 1,100
molecules (a group past K4's 1,024 distinct UMIs, whose distances take
K4's plain version on the CPU). The options: the strategies adjacency,
edit, identity and paired (UMIs of ``ACGT-``, within K4's alphabet),
``--no-umi``, ``-r``, ``--include-unmapped``, ``-q``, ``-n``, ``-l`` and
``--threads 3``. ``FastDedup`` is also driven over record batches of a few
KiB and less (templates and position groups split across batches) against
the port's ``run_dedup``, ``rewrite_tag_records(new_flags=)`` is held to
the per-record editor, and the header and argument refusals exit 2 on both
packages with nothing written.

The JAX package's native library is built from its source into a pytest
temporary directory (never its own build path, whose build races between
xdist workers), so its batch engine runs too.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.commands.dedup import (_record_with_flag_and_mi,
                                            run_dedup)
from fgumi_tpu_torch.commands.fast_group import FastDedup
from fgumi_tpu_torch.io.bam import (BamReader, BamWriter, FLAG_DUPLICATE,
                                    RawRecord)
from fgumi_tpu_torch.native import batch as nb
from fgumi_tpu_torch.umi.assigners import make_assigner
from test_torch_fast_group import _records, _small_batches
from test_torch_group import messy_bam


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    src = os.path.join(os.path.dirname(jax_native.__file__),
                       "fgumi_native.cc")
    so = str(tmp_path_factory.mktemp("jaxnative") / "libjax_native.so")
    subprocess.run(["g++", "-O1", "-shared", "-fPIC", "-pthread", "-o", so,
                    src, "-ldeflate"], check=True, capture_output=True)
    lib = ctypes.CDLL(so)
    jax_native._declare(lib)
    return lib


@pytest.fixture(autouse=True)
def with_jax_lib(monkeypatch, jax_lib):
    monkeypatch.setattr(jax_native, "get_lib", lambda: jax_lib)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: jax_lib)


def _with_cells(src, dst):
    """``src`` with a CB barcode on every template whose name ends in 0, 3
    or 6 (three cells), the others without one."""
    with BamReader(src) as r:
        header = r.header
        recs = [rec.data for rec in r]
    with BamWriter(dst, header) as w:
        for data in recs:
            rec = RawRecord(data)
            digit = rec.name[-1:]
            if digit in (b"0", b"3", b"6"):
                data += b"CBZ" + b"cell" + digit + b"\x00"
            w.write_record_bytes(data)


def _amplicon(path):
    import chip_smoke

    chip_smoke.amplicon_bam(path, positions=1, molecules=1100, copies=2,
                            read_length=40, seed=7)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_dedup")
    p = {k: str(d / f"{k}.bam") for k in ("sim", "sim_paired", "messy",
                                          "messy_paired", "cells",
                                          "amplicon")}
    assert port_main(["simulate", "mapped-reads", "-o", p["sim"],
                      "--num-families", "40", "--family-size", "4",
                      "--umi-error-rate", "0.03", "--seed", "11"]) == 0
    assert port_main(["simulate", "mapped-reads", "-o", p["sim_paired"],
                      "--num-families", "30", "--family-size", "5",
                      "--paired-umis", "--umi-error-rate", "0.03",
                      "--seed", "7"]) == 0
    messy_bam(p["messy"], seed=3)
    messy_bam(p["messy_paired"], seed=4, paired_umi=True)
    _with_cells(p["messy"], p["cells"])
    _amplicon(p["amplicon"])
    return p


CASES = [
    ("sim", []),
    ("sim", ["-s", "edit"]),
    ("sim", ["-s", "identity"]),
    ("sim", ["--no-umi"]),
    ("sim", ["-r"]),
    ("sim", ["--threads", "3"]),
    ("sim_paired", ["-s", "paired"]),
    ("sim_paired", ["-s", "paired", "-e", "2", "-r"]),
    ("messy", ["-l", "6"]),
    ("messy", ["-s", "identity", "--include-unmapped"]),
    ("messy", ["-s", "identity", "-q", "30", "-n"]),
    ("messy", ["-r", "--include-unmapped", "-s", "edit", "-e", "2", "-l",
               "6"]),
    ("messy", ["--no-umi", "--include-unmapped"]),
    ("messy", ["--threads", "3", "--include-unmapped", "-n", "-l", "6"]),
    ("messy_paired", ["-s", "paired", "-n"]),
    ("cells", ["-l", "6"]),
    ("cells", ["-s", "identity", "--include-unmapped", "-r"]),
    ("amplicon", []),
    ("amplicon", ["-s", "edit"]),
]


def _read(path):
    with BamReader(path) as r:
        hd = [ln for ln in r.header.text.splitlines()
              if not ln.startswith("@PG")]
        return hd, [rec.data for rec in r]


def _dedup(main, d, inp, flags, extra):
    os.makedirs(d)
    argv = ["dedup", "-i", inp, "-o", os.path.join(d, "out.bam"), "-m",
            os.path.join(d, "m.tsv"), "-H", os.path.join(d, "h.tsv"),
            *flags, *extra]
    assert main(argv) == 0, (d, argv)
    with open(os.path.join(d, "m.tsv"), "rb") as f:
        metrics = f.read()
    with open(os.path.join(d, "h.tsv"), "rb") as f:
        hist = f.read()
    return _read(os.path.join(d, "out.bam")), metrics, hist


@pytest.mark.parametrize("config,flags", CASES,
                         ids=[f"{c}-{'_'.join(f) or 'default'}"
                              for c, f in CASES])
def test_dedup_matches_jax(tmp_path, inputs, config, flags):
    inp = inputs[config]
    want = _dedup(jax_main, str(tmp_path / "jax_fast"), inp, flags, [])
    (hd, recs), metrics, hist = want
    assert recs and b"total_templates" in metrics
    assert _dedup(jax_main, str(tmp_path / "jax_classic"), inp, flags,
                  ["--classic"]) == want
    for name, extra in (("port_fast", []), ("port_classic", ["--classic"])):
        got = _dedup(port_main, str(tmp_path / name), inp, flags,
                     ["--device", "cpu", *extra])
        assert got[0][0] == hd, name
        assert got[0][1] == recs, name
        assert got[1] == metrics, name
        assert got[2] == hist, name


def test_dedup_stats_json(tmp_path, inputs):
    """``--stats-json``: the engine, the input records, the dedup metrics
    and, on the amplicon position, one distance call past K4's threshold
    (on the CPU, K4's plain version: no launch counted)."""
    import json

    out, st = str(tmp_path / "o.bam"), str(tmp_path / "s.json")
    assert port_main(["dedup", "-i", inputs["amplicon"], "-o", out,
                      "--device", "cpu", "--stats-json", st]) == 0
    stats = json.load(open(st))
    assert stats["engine"] == "fast" and stats["device"] == "cpu"
    assert stats["input_reads"] == 4400
    assert stats["metrics"]["total_templates"] == 2200
    assert stats["device_span"]["calls"] == 1
    assert stats["device_span"]["largest"][0] >= 1024
    assert all(n == 0 for n in stats["launches"].values())


SPLIT_CASES = [
    ("sim", {}, 4096),
    ("sim", {"no_umi": True}, 700),
    ("sim_paired", {"strategy": "paired"}, 1024),
    ("messy", {"include_unmapped": True, "min_mapq": 20,
               "min_umi_length": 6}, 600),
    ("messy", {"remove_duplicates": True, "strategy": "identity"}, 1),
    ("cells", {"include_non_pf": True, "min_umi_length": 6}, 2048),
]


@pytest.mark.parametrize("config,kw,target", SPLIT_CASES,
                         ids=[f"{c}-{'-'.join(kw) or 'default'}-{t}"
                              for c, kw, t in SPLIT_CASES])
def test_fast_dedup_batch_splits_match_run_dedup(inputs, tmp_path, config,
                                                 kw, target):
    """FastDedup over record batches of ``target`` bytes (templates and
    position groups straddle them) equals the per-template engine."""
    inp = inputs[config]
    header, batches = _small_batches(inp, target, max(64, min(target, 256)))
    assert len(batches) >= 4
    strategy = kw.pop("strategy", "adjacency")
    s, e = ("identity", 0) if kw.get("no_umi") else (strategy, 1)
    dd = FastDedup(header, make_assigner(s, e, "cpu"), **kw)
    chunks = []
    for batch in batches:
        chunks.extend(dd.process_batch(batch))
    chunks.extend(dd.flush())
    metrics, sizes = dd.result()
    want_out = str(tmp_path / "classic.bam")
    with BamReader(inp) as r, BamWriter(want_out, r.header) as w:
        want_m, want_sizes = run_dedup(r, w, strategy=strategy, device="cpu",
                                       **kw)
    assert _records(chunks) == _read(want_out)[1]
    assert _as_dict(metrics) == _as_dict(want_m) and sizes == want_sizes


def _as_dict(metrics):
    return {**vars(metrics), "filter": metrics.filter.as_dict()}


def test_rewrite_tag_records_new_flags(inputs):
    """The native MI rewrite with per-row flags (-1 keeps a record's) is
    byte for byte the per-record editor; without flags the bytes are the
    plain rewrite's."""
    _, batches = _small_batches(inputs["messy"], 1 << 20, 1 << 16)
    batch = batches[0]
    rng = np.random.default_rng(5)
    rows = np.sort(rng.choice(batch.n, size=min(batch.n, 60),
                              replace=False)).astype(np.int64)
    values = [f"{i}/A".encode() for i in range(len(rows))]
    dup = rng.random(len(rows)) < 0.5
    keep = rng.random(len(rows)) < 0.2
    flags = np.array([-1 if k else (int(batch.flag[r]) & ~FLAG_DUPLICATE)
                      | (FLAG_DUPLICATE if d else 0)
                      for r, d, k in zip(rows, dup, keep)], dtype=np.int32)
    got = nb.rewrite_tag_records(batch, rows, b"MI", values, new_flags=flags)
    want = []
    for r, v, f, k in zip(rows, values, flags, keep):
        rec = batch.raw_record(int(r))
        is_dup = bool(rec.flag & FLAG_DUPLICATE) if k \
            else bool(f & FLAG_DUPLICATE)
        data = _record_with_flag_and_mi(rec, is_dup, v.decode(), b"MI")
        if k:
            data = data[:14] + rec.data[14:16] + data[16:]
        want.append(len(data).to_bytes(4, "little") + data)
    assert got == b"".join(want)
    assert nb.rewrite_tag_records(batch, rows, b"MI", values) == \
        nb.rewrite_tag_records(batch, rows, b"MI", values,
                               new_flags=np.full(len(rows), -1, np.int32))


@pytest.mark.parametrize("flags,source", [
    ([], "grouped"),
    (["--no-umi", "-s", "paired"], "sim"),
    (["-s", "paired", "-l", "6"], "sim_paired")],
    ids=["not_template_coordinate", "no_umi_paired", "paired_min_umi_length"])
@pytest.mark.parametrize("engine", [[], ["--classic"]],
                         ids=["fast", "classic"])
def test_refusals_exit_2_with_nothing_written(tmp_path, inputs, flags,
                                              source, engine):
    if source == "grouped":
        inp = str(tmp_path / "grouped.bam")
        assert port_main(["simulate", "grouped-reads", "-o", inp,
                          "--num-families", "2"]) == 0
    else:
        inp = inputs[source]
    for name, main, extra in (("jax", jax_main, []),
                              ("port", port_main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        argv = ["dedup", "-i", inp, "-o", str(d / "o.bam"), "-m",
                str(d / "m.tsv"), "-H", str(d / "h.tsv"), *flags, *engine,
                *extra]
        assert main(argv) == 2, name
        assert os.listdir(d) == [], name


def test_every_reference_dedup_option_is_accepted():
    """``dedup`` takes every option of the JAX package's command line (and
    adds ``--device`` and ``--stats-json``)."""
    from fgumi_tpu.cli import build_parser as jax_parser
    from fgumi_tpu_torch.cli import build_parser as port_parser

    def options(parser):
        sub = next(a for a in parser._actions
                   if a.__class__.__name__ == "_SubParsersAction")
        return {s for a in sub.choices["dedup"]._actions
                for s in a.option_strings}

    port, jax = options(port_parser()), options(jax_parser())
    assert jax <= port
    assert port - jax == {"--device", "--stats-json"}
