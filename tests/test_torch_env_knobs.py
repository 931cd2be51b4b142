"""The environment forms of the reference's options on the port, against the
JAX CLI (``fgumi_tpu.cli.main``).

``FGUMI_TPU_DEVICE_FILTER``: ``1``, ``true``, ``On`` and ``force`` stand for
``--device-filter`` on ``simplex`` (both engines), ``duplex``, ``codec`` and
``pipeline`` (fused and ``--no-fuse``); ``0``/``off`` request nothing, and
with the flag the fast engine keeps its fused filter (K1-f on the card)
where the JAX CLI computes the masks from full columns. The records must
equal the JAX CLI's under the same variable: on ``simulate grouped-reads`` (300 families x 3, seed 3) and
``duplex-reads`` (200 molecules, seed 4) with ``--min-reads 1``, 594, 388
and 0 records for ``simplex``, ``duplex`` and ``codec``.

``FGUMI_TPU_MESH``, ``FGUMI_TPU_SP`` and ``FGUMI_TPU_PROFILE``: the values
that build no mesh on the reference run as without the variable, a value the
reference rejects exits 2 on both with the reference's knob line (a missing
profile's "unreadable" line too), a mesh shape or a read-axis split exits 2
with "not yet ported" and writes nothing, and a valid profile runs with the
JAX CLI's records under the same profile. ``FGUMI_TPU_XLA_PROFILE`` and
``FGUMI_TPU_SHAPE_BUCKETS`` tune JAX alone: the port ignores them, and the
JAX CLI's ``simplex`` also exits 0 with a bad value of either. The JAX
package's native library is kept out (its loader is patched to report
none), but where the reference rejects a mesh value: its ``simplex`` parses
the mesh on its batch engine, so its library is built from its source into
a pytest temporary directory there.
"""

import json

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader
from test_torch_dedup import jax_lib  # noqa: F401 (a fixture)
from test_torch_profile import profile_state  # noqa: F401 (a fixture)


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)
    for knob in ("FGUMI_TPU_DEVICE_FILTER", "FGUMI_TPU_MESH", "FGUMI_TPU_SP",
                 "FGUMI_TPU_PROFILE"):
        monkeypatch.delenv(knob, raising=False)


RS = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_env_knobs")
    p = {"grouped": str(d / "grouped.bam"), "duplex": str(d / "duplex.bam"),
         "fastq": (str(d / "r1.fq.gz"), str(d / "r2.fq.gz"))}
    for argv in (["simulate", "grouped-reads", "-o", p["grouped"],
                  "--num-families", "300", "--family-size", "3", "--seed",
                  "3"],
                 ["simulate", "duplex-reads", "-o", p["duplex"],
                  "--num-molecules", "200", "--seed", "4"],
                 ["simulate", "fastq-reads", "-1", p["fastq"][0], "-2",
                  p["fastq"][1], "--num-families", "60", "--family-size",
                  "4"]):
        assert port_main(argv) == 0
    return p


def _records(path):
    with BamReader(path) as r:
        return ([ln for ln in r.header.text.splitlines()
                 if not ln.startswith("@PG")], [rec.data for rec in r])


# command -> (input, records the JAX CLI writes under the variable)
FILTERED = {"simplex": ("grouped", 594), "duplex": ("duplex", 388),
            "codec": ("duplex", 0)}


@pytest.fixture(scope="module")
def jax_filtered(inputs, tmp_path_factory):
    """The JAX CLI's records of each command under
    ``FGUMI_TPU_DEVICE_FILTER=1`` and without it."""
    d = tmp_path_factory.mktemp("jax_filtered")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_native, "get_lib", lambda: None)
    mp.setattr(jax_native_batch, "get_lib", lambda: None)
    out = {}
    try:
        for command, (inp, _) in FILTERED.items():
            for value in ("1", None):
                if value is None:
                    mp.delenv("FGUMI_TPU_DEVICE_FILTER", raising=False)
                else:
                    mp.setenv("FGUMI_TPU_DEVICE_FILTER", value)
                path = str(d / f"{command}{value}.bam")
                assert jax_main([command, "-i", inputs[inp], "-o", path,
                                 "--min-reads", "1"]) == 0
                out[command, value] = _records(path)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("command,value,extra", [
    ("simplex", "1", []), ("simplex", "true", ["--classic"]),
    ("simplex", "On", []), ("simplex", "force", ["--classic"]),
    ("simplex", "0", ["--device-filter"]),
    ("simplex", "off", ["--device-filter", "--classic"]),
    ("simplex", "", []), ("simplex", "0", []),
    ("duplex", "1", []), ("duplex", "TRUE", ["--classic"]),
    ("duplex", "0", ["--device-filter"]),
    ("codec", "1", []), ("codec", "on", ["--classic"]),
    ("codec", "false", ["--device-filter"]), ("codec", "no", []),
])
def test_device_filter_env_matches_jax_cli(inputs, jax_filtered, tmp_path,
                                           monkeypatch, command, value,
                                           extra):
    inp, n_filtered = FILTERED[command]
    monkeypatch.setenv("FGUMI_TPU_DEVICE_FILTER", value)
    filtered = (value.lower() in ("1", "true", "on", "force")
                or "--device-filter" in extra)
    want = jax_filtered[command, "1" if filtered else None]
    if filtered:
        assert len(want[1]) == n_filtered
    got = str(tmp_path / "port.bam")
    stats = str(tmp_path / "stats.json")
    assert port_main([command, "-i", inputs[inp], "-o", got, "--min-reads",
                      "1", "--device", "cpu", "--stats-json", stats,
                      *extra]) == 0
    assert _records(got) == want
    if command == "simplex" and "--classic" not in extra:
        with open(stats) as f:
            st = json.load(f)
        # the flag keeps the fused filter whatever the variable says
        assert (st["fused_batches"] > 0) == filtered
        assert ("filter" in st) == filtered


@pytest.mark.parametrize("value,flags", [("1", []), ("force", ["--no-fuse"]),
                                         ("0", ["--device-filter"]),
                                         ("off", ["--device-filter",
                                                  "--no-fuse"])])
def test_device_filter_env_pipeline_matches_jax_cli(inputs, tmp_path,
                                                    monkeypatch, value,
                                                    flags):
    monkeypatch.setenv("FGUMI_TPU_DEVICE_FILTER", value)
    got, want = str(tmp_path / "port.bam"), str(tmp_path / "jax.bam")
    assert port_main(["pipeline", "-i", *inputs["fastq"], *RS, "-o", got,
                      "--device", "cpu", *flags]) == 0
    assert jax_main(["pipeline", "-i", *inputs["fastq"], *RS, "-o", want,
                     *flags]) == 0
    port = _records(got)
    assert port[1] and port == _records(want)


@pytest.mark.parametrize("knob,value,rc,line", [
    ("FGUMI_TPU_MESH", "bogus", 2, "unrecognized shape 'bogus'"),
    ("FGUMI_TPU_MESH", "dp0", 2, "below the >= 1 floor"),
    ("FGUMI_TPU_MESH", "dp2xsp0", 2, "below the >= 1 floor"),
    ("FGUMI_TPU_MESH", "auto", 2, "not yet ported (multi-GPU)"),
    ("FGUMI_TPU_MESH", "dp2", 2, "not yet ported (multi-GPU)"),
    ("FGUMI_TPU_MESH", "DP1xSP2", 2, "not yet ported (multi-GPU)"),
    ("FGUMI_TPU_MESH", "off", 0, None), ("FGUMI_TPU_MESH", " None ", 0, None),
    ("FGUMI_TPU_MESH", "0", 0, None), ("FGUMI_TPU_MESH", "1", 0, None),
    ("FGUMI_TPU_MESH", "", 0, None),
    ("FGUMI_TPU_SP", "2", 2, "not yet ported (multi-GPU)"),
    ("FGUMI_TPU_SP", "1", 0, None), ("FGUMI_TPU_SP", "0", 0, None),
    ("FGUMI_TPU_SP", "two", 0, None),
    ("FGUMI_TPU_PROFILE", "/nonexistent.json", 2,
     "unreadable (No such file or directory)"),
    ("FGUMI_TPU_PROFILE", "", 0, None),
    ("FGUMI_TPU_PROFILE", "@valid", 0, None),
    ("FGUMI_TPU_XLA_PROFILE", "/dev/null/x", 0, None),
    ("FGUMI_TPU_SHAPE_BUCKETS", "bogus", 0, None),
])
def test_global_env_forms(inputs, tmp_path, monkeypatch, caplog, request,
                          knob, value, rc, line):
    if value == "@valid":
        # a valid profile (its application isolated: process-once state)
        request.getfixturevalue("profile_state")
        value = str(tmp_path / "p.json")
        with open(value, "w") as f:
            json.dump({"schema_version": 1, "source": "manual",
                       "fingerprint": {}, "knobs": {
                           "mesh": "off", "coalesce_window_ms": 1.0,
                           "chain_bytes": 1 << 20}}, f)
    monkeypatch.setenv(knob, value)
    got = tmp_path / "port.bam"
    caplog.clear()
    assert port_main(["simplex", "-i", inputs["grouped"], "-o", str(got),
                      "--device", "cpu"]) == rc
    errors = [r.getMessage() for r in caplog.records
              if r.levelname == "ERROR"]
    if rc:
        assert not got.exists()
        assert len(errors) == 1 and line in errors[0]
        assert errors[0].startswith(knob)
    else:
        assert errors == []
    if line is not None and "not yet ported" not in line:
        # a value the reference rejects: the same exit and knob line
        lib = request.getfixturevalue("jax_lib")
        monkeypatch.setattr(jax_native, "get_lib", lambda: lib)
        monkeypatch.setattr(jax_native_batch, "get_lib", lambda: lib)
        caplog.clear()
        want = tmp_path / "jax.bam"
        assert jax_main(["simplex", "-i", inputs["grouped"], "-o",
                         str(want)]) == 2
        assert [r.getMessage() for r in caplog.records
                if r.levelname == "ERROR"] == errors
    elif rc == 0 and (knob != "FGUMI_TPU_PROFILE" or value):
        want = tmp_path / "jax.bam"
        assert jax_main(["simplex", "-i", inputs["grouped"], "-o",
                         str(want)]) == 0
        assert _records(str(got)) == _records(str(want))
