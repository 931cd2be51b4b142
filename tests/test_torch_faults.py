"""Fault injection (``fgumi_tpu_torch/utils/faults.py``) and the exit-code
contract of the port's global options, held against the JAX package.

- For one ``FGUMI_TPU_FAULT`` and ``FGUMI_TPU_FAULT_SEED``, the port's
  ``fire`` and ``fgumi_tpu.utils.faults.fire`` trigger on the same calls,
  raise the same errors and corrupt the same bytes, over 1,200 seeded
  fires per kind.
- Chaos cases through ``fgumi_tpu.cli.main`` and the port's ``main(...
  --device cpu)`` give the same exit code and publish no output: 3 from an
  injected raise, 4 from ``enospc`` at a sort spill, 5 from corrupt bytes
  under ``--audit-output``; the device points and kind ``oom`` exit 2 on
  the port ("not yet ported") before any output is opened.
- Every global option of the reference is accepted; ``--profile``,
  ``--mesh``, ``--xla-profile`` and ``--shape-buckets`` exit 2 with one
  line, never argparse's usage error.
"""

import errno
import json
import logging
import os

import numpy as np
import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu import cli as jax_cli
from fgumi_tpu.utils import faults as jax_faults
from fgumi_tpu_torch import cli as port_cli
from fgumi_tpu_torch.utils import faults as port_faults


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX package's native library, built from its source into a
    private temporary directory (never the package's own build path, whose
    build races between xdist workers): the JAX CLI then runs the same
    batch engines (and ``run_stages``) as the port."""
    import ctypes
    import subprocess

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


@pytest.fixture(autouse=True)
def reset_faults(monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_FAULT", raising=False)
    port_faults.reset()
    jax_faults.reset()
    yield
    monkeypatch.delenv("FGUMI_TPU_FAULT", raising=False)
    port_faults.reset()
    jax_faults.reset()


def test_grammar_matches_jax():
    assert port_faults.FAULT_POINTS == jax_faults.FAULT_POINTS
    assert port_faults.KINDS == jax_faults.KINDS
    assert port_faults.UNPORTED_POINTS <= port_faults.FAULT_POINTS


# ---------------------------------------------------------------------------
# fire() parity


def _outcome(mod, point, payload):
    before = mod.snapshot().get(point, 0)
    try:
        got = mod.fire(point, payload)
    except Exception as e:  # noqa: BLE001 - compared by type and text
        return ("raised", type(e).__name__, getattr(e, "errno", None),
                str(e))
    fired = mod.snapshot().get(point, 0) - before
    if isinstance(got, np.ndarray):
        return ("array", fired, got.tobytes())
    return ("data", fired, bytes(got) if got is not None else None)


@pytest.mark.parametrize("point,kind", [
    ("pipeline.process", "raise"),
    ("sort.spill", "enospc"),
    ("writer.compress", "corrupt-bytes"),
    ("reader.decompress", "corrupt-bytes"),
    ("chain.handoff", "corrupt-bytes"),
    ("device.fetch", "corrupt-result"),
    ("native.batch", "hang"),
    ("governor.sample", "oom")])
@pytest.mark.parametrize("prob,count,seed", [
    (0.3, None, 0), (0.05, None, 11), (1.0, 600, 3), (0.5, 100, 7)])
def test_fire_triggers_and_corrupts_like_jax(monkeypatch, point, kind, prob,
                                             count, seed):
    spec = f"{point}:{kind}:{prob}" + ("" if count is None else f":{count}")
    monkeypatch.setenv("FGUMI_TPU_FAULT", spec)
    monkeypatch.setenv("FGUMI_TPU_FAULT_SEED", str(seed))
    monkeypatch.setenv("FGUMI_TPU_FAULT_HANG_S", "0")
    for name in ("fgumi_tpu", "fgumi_tpu_torch"):
        monkeypatch.setattr(logging.getLogger(name), "disabled", True)
    rng = np.random.default_rng(seed)
    triggered = 0
    for _ in range(1200):
        n = int(rng.integers(1, 5000))
        if kind == "corrupt-result":
            payload = rng.integers(0, 256, size=n, dtype=np.uint8)
        else:
            payload = rng.integers(0, 256, size=n,
                                   dtype=np.uint8).tobytes()
        got = _outcome(port_faults, point, payload)
        want = _outcome(jax_faults, point, payload)
        assert got == want
        changed = got[0] == "raised" or got[1] > 0
        triggered += changed
        assert port_faults.armed(point) == jax_faults.armed(point)
    expected = 1200 * prob if count is None else min(count, 1200 * prob)
    assert abs(triggered - expected) <= max(5 * (1200 * prob) ** 0.5, 3)
    assert port_faults.snapshot() == jax_faults.snapshot()


@pytest.mark.parametrize("spec,err", [
    ("nope.point:raise:1.0", "unknown fault point"),
    ("pipeline.process:explode:1.0", "unknown kind"),
    ("pipeline.process:raise", "expected point:kind:prob")])
def test_bad_spec_is_loud(monkeypatch, spec, err):
    monkeypatch.setenv("FGUMI_TPU_FAULT", spec)
    with pytest.raises(ValueError, match=err):
        port_faults.fire("pipeline.process")


@pytest.mark.parametrize("spec,unported", [
    ("device.dispatch:raise:1.0", "device.dispatch:raise"),
    ("pipeline.process:raise:1.0,device.fetch:corrupt-result:1.0:1",
     "device.fetch:corrupt-result"),
    ("reader.decompress:oom:1.0", "reader.decompress:oom"),
    ("serve.dispatch:raise:1.0", "serve.dispatch:raise"),
    ("sort.spill:enospc:1.0:1", None),
    ("", None)])
def test_unported_spec(spec, unported):
    assert port_faults.unported_spec(spec) == unported


# ---------------------------------------------------------------------------
# chaos exit codes, port against the JAX CLI


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_faults")
    p = {"grouped": str(d / "g.bam"), "mapped": str(d / "m.bam"),
         "r1": str(d / "r1.fq.gz"), "r2": str(d / "r2.fq.gz")}
    for argv in (["simulate", "grouped-reads", "-o", p["grouped"],
                  "--num-families", "150"],
                 ["simulate", "mapped-reads", "-o", p["mapped"],
                  "--num-families", "150"],
                 ["simulate", "fastq-reads", "-1", p["r1"], "-2", p["r2"],
                  "--num-families", "150"]):
        assert port_cli.main(argv) == 0
    return p


def _argv(command, p, out):
    if command == "simplex":
        return ["simplex", "-i", p["grouped"], "-o", out]
    if command == "simplex-threads":
        return ["simplex", "-i", p["grouped"], "-o", out, "--threads", "4"]
    if command == "sort":
        return ["sort", "-i", p["mapped"], "-o", out, "--order",
                "template-coordinate", "--max-records-in-ram", "200"]
    return ["pipeline", "-i", p["r1"], p["r2"], "-r", "8M+T", "+T", "-o",
            out, "--sample", "s", "--library", "l"]


#: (fault spec, command, global flags, exit code of both CLIs)
CHAOS = [
    ("pipeline.process:raise:1.0:1", "simplex", [], 3),
    ("pipeline.process:raise:1.0:1", "simplex-threads", [], 3),
    ("pipeline.process:raise:1.0:1", "pipeline", [], 3),
    ("reader.decompress:raise:1.0:1", "simplex", [], 3),
    ("chain.handoff:raise:1.0:1", "pipeline", [], 3),
    ("sort.spill:enospc:1.0:1", "sort", [], 4),
    ("writer.compress:corrupt-bytes:1.0:1", "simplex", ["--audit-output"],
     5),
    ("writer.compress:corrupt-bytes:1.0:1", "sort", ["--audit-output"], 5),
    ("writer.compress:corrupt-bytes:1.0:1", "pipeline", ["--audit-output"],
     5),
    ("writer.compress:raise:1.0:1", "simplex", ["--audit-output"], 3),
    ("native.batch:raise:1.0:1", "simplex", [], 3),
    ("native.batch:raise:1.0:1", "pipeline", [], 3),
]


@pytest.mark.parametrize("spec,command,flags,rc", CHAOS)
def test_chaos_exit_code_matches_jax(tmp_path, monkeypatch, inputs, spec,
                                     command, flags, rc):
    monkeypatch.setenv("FGUMI_TPU_FAULT", spec)
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        port_faults.reset()
        jax_faults.reset()
        d = tmp_path / name
        d.mkdir()
        out = str(d / "out.bam")
        argv = flags + _argv(command, inputs, out)
        if command != "sort":
            argv += extra
        assert main(argv) == rc, name
        # nothing published, no temporary left behind
        assert os.listdir(d) == [], (name, os.listdir(d))


def test_audit_exit_5_writes_flight_dump_and_report(tmp_path, monkeypatch,
                                                    inputs):
    from fgumi_tpu_torch.observe import flight
    from fgumi_tpu_torch.observe.report import validate_report

    flight.FLIGHT.reset()
    monkeypatch.setenv("FGUMI_TPU_FAULT",
                       "writer.compress:corrupt-bytes:1.0:1")
    dumps, rpt = tmp_path / "fl", tmp_path / "r.json"
    out = tmp_path / "o.bam"
    try:
        assert port_cli.main(["--audit-output", "--flight-dump-dir",
                              str(dumps), "--run-report", str(rpt)]
                             + _argv("simplex", inputs, str(out))
                             + ["--device", "cpu"]) == 5
        assert not out.exists()
        (name,) = os.listdir(dumps)
        assert "output-integrity" in name
        dump = json.load(open(dumps / name))
        assert flight.validate_dump(dump) == []
        assert dump["exception"]["type"] == "OutputIntegrityError"
        report = json.load(open(rpt))
        assert validate_report(report) == []
        assert report["exit_status"] == 5
        assert report["faults"] == {"writer.compress": 1}
        assert report["flight_dumps"] == [str(dumps / name)]
    finally:
        flight.FLIGHT.reset()


def test_clean_audit_passes_and_is_timed(tmp_path, inputs):
    rpt = tmp_path / "r.json"
    out = tmp_path / "o.bam"
    assert port_cli.main(["--audit-output", "--run-report", str(rpt)]
                         + _argv("sort", inputs, str(out))) == 0
    assert out.exists()
    assert json.load(open(rpt))["latency"]["io.output_audit_s"]["count"] \
        == 1


def test_audit_skipped_without_atomic_commit(tmp_path, monkeypatch, inputs):
    monkeypatch.setenv("FGUMI_TPU_FAULT",
                       "writer.compress:corrupt-bytes:1.0:1")
    out = tmp_path / "o.bam"
    # no pre-rename window: the corrupt file is written, as the reference's
    assert port_cli.main(["--audit-output", "--no-atomic-output"]
                         + _argv("simplex", inputs, str(out))
                         + ["--device", "cpu"]) == 0
    assert out.exists()


@pytest.mark.parametrize("spec", [
    "device.dispatch:raise:1.0:1", "device.wedge:hang:1.0:1",
    "device.fetch:corrupt-result:1.0:1", "reader.decompress:oom:1.0:1",
    "pipeline.process:oom:0.5"])
def test_unported_fault_refused_before_output(tmp_path, monkeypatch, caplog,
                                              inputs, spec):
    monkeypatch.setenv("FGUMI_TPU_FAULT", spec)
    out = tmp_path / "o.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        assert port_cli.main(_argv("simplex", inputs, str(out))
                             + ["--device", "cpu"]) == 2
    assert os.listdir(tmp_path) == []
    errors = [r.getMessage() for r in caplog.records
              if r.levelno >= logging.ERROR]
    assert len(errors) == 1 and "not yet ported" in errors[0]


# ---------------------------------------------------------------------------
# global options


def _option_strings(parser):
    return {s for a in parser._actions for s in a.option_strings} \
        - {"-h", "--help"}


def test_every_reference_global_option_is_accepted():
    assert _option_strings(jax_cli.build_parser()) \
        <= _option_strings(port_cli.build_parser())


@pytest.mark.parametrize("flag,value,reason", [
    ("--profile", "p.json", "not yet ported"),
    ("--mesh", "dp2xsp1", "not yet ported"),
    ("--xla-profile", "xp", "JAX-only"),
    ("--shape-buckets", "1.5", "JAX-only")])
def test_refused_global_option_exits_2_one_line(tmp_path, caplog, inputs,
                                                flag, value, reason):
    out = tmp_path / "o.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        rc = port_cli.main([flag, value] + _argv("simplex", inputs,
                                                 str(out))
                           + ["--device", "cpu"])
    assert rc == 2
    assert not out.exists()
    errors = [r.getMessage() for r in caplog.records
              if r.levelno >= logging.ERROR]
    assert len(errors) == 1 and reason in errors[0]
    assert flag in errors[0] and "\n" not in errors[0]


def test_enospc_unmapped_backstop_records_event(tmp_path, monkeypatch):
    from fgumi_tpu_torch.utils.governor import GOVERNOR

    def command(*args, **kwargs):
        raise OSError(errno.ENOSPC, "No space left on device")

    monkeypatch.setattr(port_cli, "cmd_simplex", command)
    GOVERNOR.reset_for_tests()
    assert port_cli.main(["simplex", "-i", "x.bam", "-o",
                          str(tmp_path / "o.bam")]) == 4
    assert any(e["kind"] == "enospc" and e["where"] == "unhandled"
               for e in GOVERNOR.snapshot()["events"])
    GOVERNOR.reset_for_tests()
