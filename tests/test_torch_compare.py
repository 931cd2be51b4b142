"""The port's ``compare`` (``fgumi_tpu_torch/commands/compare.py`` and the
``compare bams|metrics`` command line) against the JAX package's.

Every case of ``tests/test_compare.py`` is rebuilt here on seeded inputs
(``simulate grouped-reads``, ``simulate mapped-reads`` and the port's
``sort``): identical files, a perturbed base, a missing record, reordered
records with and without ``--ignore-order``, tags in another order and
width, ``--ignore-tags``, MI renumbering and a split molecule and a moved
read in grouping mode, integer MI values, metrics within and past the float
tolerance and with other columns, ``--verify-sort`` on coordinate,
template-coordinate and queryname files and on a broken one, and the
``--command`` presets. Each call runs on both packages: the mismatch lines
(and so their count) and the exit codes must be equal, and each case's
outcome must be the one the JAX package's test asserts. The JAX package's
native library is never loaded: its loader is patched to report no library,
so its ``--verify-sort`` takes the per-record keys, and the port's batch
keys are held to them.
"""

import struct

import numpy as np
import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.commands import compare as J
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.commands import compare as P
from fgumi_tpu_torch.io.bam import (BamHeader, BamReader, BamWriter,
                                    RawRecord, RecordBuilder)
from fgumi_tpu_torch.simulate import simulate_grouped_bam


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


def _rewrite(src, dst, transform):
    """Copy records through ``transform(index, data) -> bytes | None``
    (None drops the record)."""
    with BamReader(src) as r:
        recs = list(r)
        header = r.header
    with BamWriter(dst, header) as w:
        for i, rec in enumerate(recs):
            data = transform(i, rec.data)
            if data is not None:
                w.write_record_bytes(data)


def _with_mi(data, mi: bytes):
    return RawRecord(data).data_without_tag(b"MI") + b"MIZ" + mi + b"\x00"


def _grouped(tmp, name="a.bam", seed=11, families=10):
    path = str(tmp / name)
    simulate_grouped_bam(path, num_families=families, family_size=3,
                         read_length=40, seed=seed)
    return path


def _mapped(tmp, families, seed):
    sim = str(tmp / f"m{seed}.bam")
    assert port_main(["simulate", "mapped-reads", "-o", sim,
                      "--num-families", str(families), "--family-size", "3",
                      "--seed", str(seed)]) == 0
    return sim


def _sorted(tmp, sim, order, name=None):
    out = str(tmp / (name or f"{order}.bam"))
    assert port_main(["sort", "-i", sim, "-o", out, "--order", order]) == 0
    return out


# each case function returns calls: (kind, args, kwargs, expected), the
# kind one of content, grouping, metrics, verify (expected: a match) or cli
# (expected: the exit code)

def case_identical(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    _rewrite(a, b, lambda i, d: d)
    return [("content", (a, b), {}, True),
            ("cli", ["compare", "bams", "-a", a, "-b", b], {}, 0)]


def case_perturbed_base(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")

    def flip(i, d):
        if i != 4:
            return d
        buf = bytearray(d)
        buf[RawRecord(d)._seq_off()] ^= 0xFF
        return bytes(buf)

    _rewrite(a, b, flip)
    return [("content", (a, b), {}, False),
            ("cli", ["compare", "bams", "-a", a, "-b", b], {}, 1)]


def case_missing_record(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    _rewrite(a, b, lambda i, d: None if i == 0 else d)
    return [("content", (a, b), {}, False),
            ("cli", ["compare", "bams", "-a", a, "-b", b], {}, 1)]


def case_reordered(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    with BamReader(a) as r:
        recs = [rec.data for rec in r]
        header = r.header
    recs[0], recs[1] = recs[1], recs[0]
    with BamWriter(b, header) as w:
        for d in recs:
            w.write_record_bytes(d)
    return [("content", (a, b), {}, False),
            ("content", (a, b), {"ignore_order": True}, True),
            ("cli", ["compare", "bams", "-a", a, "-b", b, "--ignore-order"],
             {}, 0),
            ("cli", ["compare", "bams", "-a", a, "-b", b, "--ignore-order",
                     "false"], {}, 1)]


def case_tag_order_and_width(tmp):
    header = BamHeader(text="@HD\tVN:1.6\n", ref_names=[], ref_lengths=[])

    def make(path, tags):
        b = RecordBuilder()
        with BamWriter(path, header) as w:
            b.start_unmapped(b"r1", 4, b"ACGT", np.full(4, 30, np.uint8))
            for tag, val in tags:
                if isinstance(val, bytes):
                    b.tag_str(tag, val)
                else:
                    b.tag_int(tag, val)
            w.write_record_bytes(b.finish())

    a, c = str(tmp / "a.bam"), str(tmp / "c.bam")
    make(a, [(b"RG", b"A"), (b"cD", 7)])
    make(c, [(b"cD", 7), (b"RG", b"A")])
    # a wider integer type of the same value is the same value
    d = str(tmp / "d.bam")
    _rewrite(c, d, lambda i, data: RawRecord(data).data_without_tag(b"cD")
             + b"cDi" + struct.pack("<i", 7))
    return [("content", (a, c), {}, True), ("content", (a, d), {}, True)]


def case_ignore_tags(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    _rewrite(a, b, lambda i, d: RawRecord(d).data_without_tag(b"MI"))
    return [("content", (a, b), {}, False),
            ("content", (a, b), {"ignore_tags": frozenset([b"MI"])}, True),
            ("cli", ["compare", "bams", "-a", a, "-b", b, "--ignore-tags",
                     "MI"], {}, 0)]


def case_grouping_renumbered(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    _rewrite(a, b, lambda i, d: _with_mi(
        d, str(int(RawRecord(d).get_str(b"MI")) + 100).encode()))
    return [("content", (a, b), {}, False),
            ("grouping", (a, b), {}, True),
            ("cli", ["compare", "bams", "--mode", "grouping", "-a", a, "-b",
                     b], {}, 0)]


def case_grouping_split_molecule(tmp):
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    seen = {"n": 0}

    def split(i, d):
        if RawRecord(d).get_str(b"MI") == "3" and seen["n"] < 2:
            seen["n"] += 1
            return _with_mi(d, b"999")
        return d

    _rewrite(a, b, split)
    return [("grouping", (a, b), {}, False),
            ("cli", ["compare", "bams", "--mode", "grouping", "-a", a, "-b",
                     b], {}, 1)]


def case_grouping_moved_read(tmp):
    """One read of a molecule moved into another: every MI value is still
    a valid id, and grouping mode must catch it."""
    a = _grouped(tmp)
    b = str(tmp / "moved.bam")
    with BamReader(a) as r:
        recs = list(r)
        header = r.header
    mis = [rec.get_str(b"MI") for rec in recs]
    uniq = sorted(set(mis))
    victim = mis.index(uniq[0])
    with BamWriter(b, header) as w:
        order = sorted(range(len(recs)),
                       key=lambda i: uniq[1] if i == victim else mis[i])
        for i in order:
            data = recs[i].data
            w.write_record_bytes(_with_mi(data, uniq[1].encode())
                                 if i == victim else data)
    return [("grouping", (a, b), {}, False),
            ("cli", ["compare", "bams", "-a", a, "-b", b, "--mode",
                     "grouping"], {}, 1)]


def case_grouping_integer_mi(tmp):
    a = str(tmp / "g.bam")
    simulate_grouped_bam(a, num_families=6, family_size=3, read_length=40,
                         seed=3)
    b = str(tmp / "int_mi.bam")
    _rewrite(a, b, lambda i, d: RawRecord(d).data_without_tag(b"MI")
             + b"MIi" + struct.pack("<i", int(RawRecord(d).get_str(b"MI"))))
    return [("grouping", (a, b), {}, True),
            ("cli", ["compare", "bams", "-a", a, "-b", b, "--mode",
                     "grouping"], {}, 0)]


def case_ungrouped_input_exits_2(tmp):
    """Grouping mode on records without the grouping tag: a structural
    error, exit 2 on both."""
    a = _grouped(tmp)
    b = str(tmp / "b.bam")
    _rewrite(a, b, lambda i, d: RawRecord(d).data_without_tag(b"MI"))
    return [("cli", ["compare", "bams", "--mode", "grouping", "-a", b, "-b",
                     b], {}, 2)]


def _tsv(tmp, name, text):
    path = tmp / name
    path.write_text(text)
    return str(path)


def case_metrics(tmp):
    a = _tsv(tmp, "a.tsv", "name\tcount\trate\nx\t5\t0.123456\ny\t7\t1.0\n")
    b = _tsv(tmp, "b.tsv", "name\tcount\trate\nx\t5\t0.123457\ny\t7\t1.0\n")
    c = _tsv(tmp, "c.tsv", "name\tcount\trate\nx\t5\t0.123456\ny\t8\t1.0\n")
    return [("metrics", (a, b), {}, True),
            ("metrics", (a, b), {"float_tolerance": 1e-9}, False),
            ("metrics", (a, c), {}, False),
            ("cli", ["compare", "metrics", "-a", a, "-b", b], {}, 0),
            ("cli", ["compare", "metrics", "-a", a, "-b", b,
                     "--float-tolerance", "1e-9"], {}, 1),
            ("cli", ["compare", "metrics", "-a", a, "-b", c], {}, 1)]


def case_metrics_columns_and_rows(tmp):
    a = _tsv(tmp, "a.tsv", "name\tcount\nx\t5\n")
    b = _tsv(tmp, "b.tsv", "name\ttotal\nx\t5\n")
    c = _tsv(tmp, "c.tsv", "name\tcount\nx\t5\ny\t6\n")
    e = _tsv(tmp, "e.tsv", "# only a comment\n")
    return [("metrics", (a, b), {}, False), ("metrics", (a, c), {}, False),
            ("metrics", (a, e), {}, False), ("metrics", (e, e), {}, True),
            ("cli", ["compare", "metrics", "-a", a, "-b", b], {}, 1)]


def case_verify_sort_coordinate(tmp):
    sim = _mapped(tmp, 50, 5)
    coord = _sorted(tmp, sim, "coordinate")
    broken = str(tmp / "broken.bam")
    with BamReader(coord) as r:
        recs = [rec.data for rec in r]
        header = r.header
    recs[5], recs[40] = recs[40], recs[5]
    with BamWriter(broken, header) as w:
        for d in recs:
            w.write_record_bytes(d)
    return [("verify", (coord,), {}, True), ("verify", (broken,), {}, False),
            ("cli", ["compare", "bams", "-a", coord, "-b", broken,
                     "--verify-sort", "--ignore-order"], {}, 1),
            ("cli", ["compare", "bams", "-a", coord, "-b", coord,
                     "--verify-sort"], {}, 0)]


def case_verify_sort_other_orders(tmp):
    sim = _mapped(tmp, 40, 6)
    calls = [("verify", (_sorted(tmp, sim, order),), {}, True)
             for order in ("template-coordinate", "queryname")]
    # the unsorted simulator output declares no verifiable order
    return calls + [("verify", (sim,), {}, True)]


def case_verify_sort_broken_template_coordinate(tmp):
    sim = _mapped(tmp, 40, 7)
    tc = _sorted(tmp, sim, "template-coordinate")
    broken = str(tmp / "tc_broken.bam")
    with BamReader(tc) as r:
        recs = [rec.data for rec in r]
        header = r.header
    recs[2], recs[-3] = recs[-3], recs[2]
    with BamWriter(broken, header) as w:
        for d in recs:
            w.write_record_bytes(d)
    return [("verify", (broken,), {}, False)]


def case_command_presets(tmp):
    a = _grouped(tmp)
    same = str(tmp / "same.bam")
    _rewrite(a, same, lambda i, d: d)
    renum = str(tmp / "renum.bam")
    _rewrite(a, renum, lambda i, d: _with_mi(
        d, str(int(RawRecord(d).get_str(b"MI")) + 1000).encode()))
    calls = [("cli", ["compare", "bams", "-a", a, "-b", same, "--command",
                      preset], {}, 0)
             for preset in ("extract", "filter", "simplex", "clip", "dedup")]
    return calls + [
        ("cli", ["compare", "bams", "-a", a, "-b", renum, "--command",
                 "group"], {}, 0),
        ("cli", ["compare", "bams", "-a", a, "-b", renum, "--command",
                 "simplex"], {}, 1),
        ("cli", ["compare", "bams", "-a", a, "-b", renum, "--command",
                 "group", "--mode", "content"], {}, 1)]


def case_sort_preset_tie_swaps(tmp):
    sim = _grouped(tmp, "s.bam", seed=5, families=8)
    a = _sorted(tmp, sim, "coordinate", "a.bam")
    b = _sorted(tmp, sim, "coordinate", "b.bam")
    return [("cli", ["compare", "bams", "-a", a, "-b", b, "--command",
                     "sort"], {}, 0)]


CASES = {name[5:]: fn for name, fn in sorted(globals().items())
         if name.startswith("case_")}


def _run(mod, kind, args, kwargs):
    if kind == "content":
        return mod.compare_bams_content(*args, **kwargs)
    if kind == "grouping":
        return mod.compare_bams_grouping(*args, **kwargs)
    if kind == "metrics":
        return mod.compare_metrics(*args, **kwargs)
    return mod.verify_sort_order(*args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compare_matches_jax(tmp_path, case):
    for kind, args, kwargs, expected in CASES[case](tmp_path):
        if kind == "cli":
            got, want = port_main(args), jax_main(args)
            assert got == want == expected, (args, got, want)
            continue
        got = _run(P, kind, args, kwargs)
        want = _run(J, kind, args, kwargs)
        assert got == want, (kind, args, kwargs)
        assert (got == []) == expected, (kind, args, kwargs, got)


def test_every_reference_compare_option_is_accepted():
    """``compare bams`` and ``compare metrics`` take every option of the
    JAX package's command line."""
    from fgumi_tpu.cli import build_parser as jax_parser
    from fgumi_tpu_torch.cli import build_parser as port_parser

    def options(parser, *path):
        for name in ("compare",) + path:
            sub = next(a for a in parser._actions
                       if a.__class__.__name__ == "_SubParsersAction")
            parser = sub.choices[name]
        return {s for a in parser._actions for s in a.option_strings}

    for mode in ("bams", "metrics"):
        assert options(jax_parser(), mode) == options(port_parser(), mode)
