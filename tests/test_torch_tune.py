"""``tune`` on the port (``fgumi_tpu_torch/tune/autotune.py``, the CLI's
``tune``), against the JAX package's (``fgumi_tpu.tune.autotune``,
``fgumi_tpu.cli.main``).

- ``_cell_pileup`` is byte-identical to the reference's for one generator
  over every cell of the full matrix; ``_crossover_depths``,
  ``_derive_priors``, ``_derive_knobs`` (but its ``mesh``, which names the
  port's device) and ``derive_from_replay`` equal the reference's on the
  same inputs.
- ``tune --replay`` of the same run reports writes, on both CLIs, profiles
  equal but for ``fingerprint`` and ``created_unix``; a bad ``--replay``
  exits 2 with the reference's line.
- ``tune --quick --device cpu`` exits 0 with a profile and an atlas both
  packages' validators accept, the reference's cell names, rows and
  families; its device column goes through the wire dispatch on every timed
  call even under ``FGUMI_TPU_ROUTE=host``; its default outputs land in the
  working directory; ``--device cuda`` without CUDA exits 2 and writes
  nothing.
- A command under the port-tuned profile (``--profile`` and
  ``FGUMI_TPU_PROFILE``) writes the records of the plain run and of the
  JAX CLI under the same profile; a ``serve`` daemon given ``--profile``
  applies it once across two jobs.
- The repo root's ``deploy_profile.json`` and ``TUNE_ATLAS.json`` (the JAX
  package's records) never change.
"""

import hashlib
import json
import logging
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.tune import autotune as jax_autotune
from fgumi_tpu.tune import profile as jax_profile
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.ops import cuda_kernel
from fgumi_tpu_torch.ops import kernel as port_kernel
from fgumi_tpu_torch.ops import router
from fgumi_tpu_torch.serve.client import ServeClient
from fgumi_tpu_torch.tune import autotune
from fgumi_tpu_torch.tune import profile
from test_torch_profile import profile_state  # noqa: F401 (a fixture)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_RECORDS = ("deploy_profile.json", "TUNE_ATLAS.json")
WAIT_S = 120


def _digests():
    out = {}
    for name in ROOT_RECORDS:
        with open(os.path.join(REPO, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


@pytest.fixture(scope="module", autouse=True)
def root_records_unchanged():
    """The committed JAX-package records at the repo root stay as they
    are, whatever the tests of this file run."""
    before = _digests()
    yield
    assert _digests() == before


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


# ---------------------------------------------------------------------------
# the derivations


def test_cell_pileup_is_byte_identical_to_jax():
    rng, jrng = np.random.default_rng(11), np.random.default_rng(11)
    for name, dist, depth, L, _, _ in autotune.FULL_MATRIX:
        got = autotune._cell_pileup(rng, dist, depth, L, 900)
        want = jax_autotune._cell_pileup(jrng, dist, depth, L, 900)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
    assert autotune.FULL_MATRIX == jax_autotune.FULL_MATRIX
    assert autotune.QUICK_MATRIX == jax_autotune.QUICK_MATRIX
    assert (autotune.QUICK_ROWS, autotune.FULL_ROWS) \
        == (jax_autotune.QUICK_ROWS, jax_autotune.FULL_ROWS)


CELLS = [
    {"name": "a", "distribution": "fixed", "mean_depth": 3,
     "read_length": 100, "device_rows_per_sec": 500.0,
     "host_rows_per_sec": 1000.0, "winner": "host"},
    {"name": "b", "distribution": "fixed", "mean_depth": 10,
     "read_length": 100, "device_rows_per_sec": 900.0,
     "host_rows_per_sec": 1000.0, "winner": "host"},
    {"name": "c", "distribution": "fixed", "mean_depth": 30,
     "read_length": 100, "device_rows_per_sec": 2000.0,
     "host_rows_per_sec": 1000.0, "winner": "device"},
    {"name": "d", "distribution": "longtail", "mean_depth": 3,
     "read_length": 150, "device_rows_per_sec": 3000.0,
     "host_rows_per_sec": 1000.0, "winner": "device"},
    {"name": "e", "distribution": "lognormal", "mean_depth": 5,
     "read_length": 100, "device_rows_per_sec": 3000.0},
]


@pytest.mark.parametrize("cells", [CELLS, CELLS[:1], CELLS[1:3], [],
                                   list(reversed(CELLS))])
def test_crossover_depths_equal_jax(cells):
    got = autotune._crossover_depths([dict(c) for c in cells])
    assert got == jax_autotune._crossover_depths([dict(c) for c in cells])
    if len(cells) == 5:
        assert 10 < got["fixed_L100"]["crossover_depth"] < 30


SNAPS = [
    {"link_samples": 12, "link_mbps": 3500.0, "overhead_s": 0.0021,
     "dispatch_wall_s": 0.0061, "host_samples": 6,
     "host_mcells_per_s": 49.4},
    {"link_samples": 0, "host_samples": 0,
     "mesh": {"4": {"link_mbps": 10.0, "overhead_s": 0.1,
                    "dispatch_wall_s": 0.3, "link_samples": 2}}},
    {},
]


@pytest.mark.parametrize("snap", SNAPS)
@pytest.mark.parametrize("choosers", [{}, {"duplex_combine": {
    "device_s_per_mcell": 0.01, "host_s_per_mcell": 0.02}}])
def test_derive_priors_and_knobs_equal_jax(snap, choosers):
    keep = [0.9, 0.9, 0.3]
    got = autotune._derive_priors(CELLS[:4], dict(snap), choosers, keep)
    want = jax_autotune._derive_priors(CELLS[:4], dict(snap), choosers,
                                       keep)
    assert got == want
    for priors in ({}, got["router"], {"overhead_s": 0.5,
                                       "dispatch_wall_s": 0.01},
                   {"overhead_s": 0.0001, "dispatch_wall_s": 0.1},
                   {"overhead_s": 0.0}):
        knobs = autotune._derive_knobs(priors, True)
        ref = jax_autotune._derive_knobs(priors, True)
        ref.pop("mesh", None)  # the reference's names jax's devices
        assert knobs == ref
        assert autotune._derive_knobs(priors, True, "cpu") \
            == {**knobs, "mesh": "off"}


def test_derive_from_replay_equals_jax(tmp_path):
    docs = [{"device": {"routing": {"link_mbps": 100.0, "overhead_s": 0.02,
                                    "dispatch_wall_s": 0.03,
                                    "host_mcells_per_s": 40.0}}},
            {"device": {"routing": {"link_mbps": 200.0, "overhead_s": 0.04,
                                    "dispatch_wall_s": 0.05,
                                    "host_mcells_per_s": 60.0,
                                    "filter_keep_rate": 0.5}}},
            {"tune_cells": CELLS[:2]}, [1, 2], {"device": None}]
    paths = []
    for i, doc in enumerate(docs):
        paths.append(str(tmp_path / f"in{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump(doc, f)
    got = autotune.derive_from_replay(paths)
    assert got == jax_autotune.derive_from_replay(paths)
    assert got[1]["link_mbps"] == 150.0 and len(got[0]) == 2


def _replay_reports(tmp_path):
    paths = []
    for i, routing in enumerate((
            {"prior_source": "cold", "link_mbps": 3500.0, "link_samples": 18,
             "overhead_s": 0.0021, "dispatch_wall_s": 0.0061,
             "host_mcells_per_s": 49.4, "host_samples": 5},
            {"link_mbps": 3100.0, "overhead_s": 0.0035,
             "dispatch_wall_s": 0.0059, "host_mcells_per_s": 0,
             "filter_keep_rate": 0.46})):
        paths.append(str(tmp_path / f"report{i}.json"))
        with open(paths[-1], "w") as f:
            json.dump({"device": {"routing": routing}}, f)
    return paths


def test_tune_replay_equals_jax_cli(profile_state, tmp_path,  # noqa: F811
                                    monkeypatch):
    import jax

    # the tests' JAX runs on several host devices; the reference's mesh
    # knob names them, the port's its own device: both see one here
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 1)
    reports = _replay_reports(tmp_path)
    replay = [a for p in reports for a in ("--replay", p)]
    port, jax = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    patlas, jatlas = str(tmp_path / "pa.json"), str(tmp_path / "ja.json")
    assert port_main(["tune", *replay, "-o", port, "--atlas", patlas,
                      "--device", "cpu"]) == 0
    assert jax_main(["tune", *replay, "-o", jax, "--atlas", jatlas]) == 0
    docs = []
    for path in (port, jax):
        with open(path) as f:
            doc = json.load(f)
        assert profile.validate_profile(doc) \
            and jax_profile.validate_profile(doc)
        doc.pop("fingerprint"), doc.pop("created_unix")
        docs.append(doc)
    assert docs[0] == docs[1]
    assert docs[0]["source"] == "replay"
    assert docs[0]["priors"]["router"]["link_mbps"] == 3300.0
    assert docs[0]["knobs"] == {"coalesce_window_ms": 2.8,
                                "feeder_depth": 2, "mesh": "off"}
    atlases = []
    for path in (patlas, jatlas):
        with open(path) as f:
            doc = json.load(f)
        doc.pop("fingerprint"), doc.pop("created_unix")
        atlases.append(doc)
    assert atlases[0] == atlases[1]
    # a replay never probes the card: the cheap fingerprint
    with open(port) as f:
        assert "torch_backend" not in json.load(f)["fingerprint"]


@pytest.mark.parametrize("doc", [None, "{not json"])
def test_bad_replay_exits_2_as_jax(tmp_path, caplog, doc):
    src = str(tmp_path / "in.json")
    if doc is not None:
        with open(src, "w") as f:
            f.write(doc)
    lines = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        caplog.clear()
        out = tmp_path / "p.json"
        assert main(["tune", "--replay", src, "-o", str(out), "--atlas", "",
                     *extra]) == 2
        assert not out.exists()
        lines.append([r.getMessage() for r in caplog.records
                      if r.levelno >= logging.ERROR])
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert lines[0][0].startswith("--replay=")


# ---------------------------------------------------------------------------
# the sweep


@pytest.fixture(scope="module")
def quick_tune(tmp_path_factory):
    """One ``tune --quick --device cpu`` under ``FGUMI_TPU_ROUTE=host``
    with the default output names, in a working directory of its own; its
    K1 wrapper calls and dispatches counted. Returns (dir, log lines, K1
    wrapper calls, dispatches)."""
    d = tmp_path_factory.mktemp("torch_tune")
    mp = pytest.MonkeyPatch()
    calls = []
    full = cuda_kernel.consensus_wire_full

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return full(*args, **kwargs)

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep(logging.INFO)
    logger = logging.getLogger("fgumi_tpu_torch")
    try:
        mp.chdir(d)
        mp.setenv("FGUMI_TPU_ROUTE", "host")
        # the sweep feeds the router's EWMAs: a fresh router takes them
        mp.setattr(router, "ROUTER", router.OffloadRouter())
        mp.setattr(cuda_kernel, "consensus_wire_full", counted)
        logger.addHandler(handler)
        profile.reset_applied_for_tests()
        assert port_main(["tune", "--quick", "--device", "cpu"]) == 0
        dispatches = port_kernel.DEVICE_STATS.snapshot()["dispatches"]
    finally:
        logger.removeHandler(handler)
        mp.undo()
    return str(d), records, calls, dispatches


def test_tune_quick_cpu_artifacts_validate_on_both(quick_tune):
    d, _, _, _ = quick_tune
    assert sorted(os.listdir(d)) == sorted(ROOT_RECORDS)
    path = os.path.join(d, "deploy_profile.json")
    doc = profile.load_profile(path)
    assert doc == jax_profile.load_profile(path)
    assert doc["source"] == "autotune" and doc["quick"] is True
    assert doc["fingerprint"]["torch_backend"] == "cpu"
    assert doc["fingerprint"]["device_count"] == 0
    assert doc["knobs"]["mesh"] == "off"
    router = doc["priors"]["router"]
    assert router["link_mbps"] > 0 and router["host_mcells_per_s"] > 0
    assert router["filter_keep_rate"] == 0.9
    for name in ("duplex_combine", "codec_combine"):
        pair = doc["priors"]["choosers"][name]
        assert pair["device_s_per_mcell"] > 0 < pair["host_s_per_mcell"]
    with open(os.path.join(d, "TUNE_ATLAS.json")) as f:
        atlas = json.load(f)
    assert atlas["kind"] == "fgumi-tpu-crossover-atlas"
    assert atlas["schema_version"] == jax_autotune.ATLAS_SCHEMA_VERSION
    assert set(atlas["crossover"]) == {"fixed_L100"}
    # the reference's cells: names, rows and families from its generator
    rng = np.random.default_rng(11)
    for cell, (name, dist, depth, L, keep, ab) in zip(
            atlas["cells"], jax_autotune.QUICK_MATRIX, strict=True):
        _, _, counts, starts = jax_autotune._cell_pileup(
            rng, dist, depth, L, jax_autotune.QUICK_ROWS)
        assert (cell["name"], cell["rows"], cell["families"]) \
            == (name, int(starts[-1]), len(counts))
        assert cell["device_rows_per_sec"] > 0 < cell["host_rows_per_sec"]
        assert cell["winner"] in ("device", "host")
        assert (cell["keep_rate"], cell["duplex_ab_fraction"]) == (keep, ab)


def test_device_column_is_timed_under_route_host(quick_tune):
    """``FGUMI_TPU_ROUTE=host`` sends every routed batch to the native
    engine; the sweep's device side calls the wire dispatch itself, so K1's
    wrapper runs on every timed call (a warm-up and 3 timed calls a
    cell)."""
    _, lines, calls, dispatches = quick_tune
    assert len(calls) == dispatches == 4 * len(autotune.QUICK_MATRIX)
    assert [ln for ln in lines if "wire dispatches" in ln] == [
        "tune: 12 wire dispatches on cpu; launches consensus_wire_full 0, "
        "consensus_wire_packed2 0, tune_combine 0"]


def test_tune_cuda_without_cuda_exits_2(tmp_path, monkeypatch, caplog):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    assert port_main(["tune", "--quick"]) == 2
    assert port_main(["tune", "--replay", "x.json", "-o", "p.json"]) == 2
    assert os.listdir(tmp_path) == []
    assert "no CUDA device" in caplog.text


def test_chooser_bench_uses_the_combine(monkeypatch):
    from fgumi_tpu_torch.ops import tune_combine

    calls = []
    plain = tune_combine.tune_combine

    def counted(x, y):
        calls.append(tuple(x.shape))
        return plain(x, y)

    monkeypatch.setattr(tune_combine, "tune_combine", counted)
    out = autotune._bench_choosers(True, "cpu")
    assert calls == [(512, 100)] * 4  # a warm-up and 3 timed calls
    assert out["duplex_combine"] == out["codec_combine"]
    assert set(out["duplex_combine"]) == {"device_s_per_mcell",
                                          "host_s_per_mcell"}


# ---------------------------------------------------------------------------
# commands under the port-tuned profile


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_tune_in") / "g.bam")
    assert port_main(["simulate", "grouped-reads", "-o", path,
                      "--num-families", "150", "--family-size", "4",
                      "--seed", "12"]) == 0
    return path


def _records(path):
    with BamReader(path) as r:
        return ([ln for ln in r.header.text.splitlines()
                 if not ln.startswith("@PG")], [rec.data for rec in r])


@pytest.mark.parametrize("how", ["flag", "env"])
def test_tuned_profile_keeps_records_and_equals_jax(
        profile_state, quick_tune, grouped, tmp_path,  # noqa: F811
        monkeypatch, how):
    prof = os.path.join(quick_tune[0], "deploy_profile.json")
    plain = str(tmp_path / "plain.bam")
    assert port_main(["simplex", "-i", grouped, "-o", plain, "--device",
                      "cpu"]) == 0
    pre = ["--profile", prof] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("FGUMI_TPU_PROFILE", prof)
    out, rpt = str(tmp_path / "c.bam"), str(tmp_path / "r.json")
    assert port_main(pre + ["--run-report", rpt, "simplex", "-i", grouped,
                            "-o", out, "--device", "cpu"]) == 0
    assert _records(out) == _records(plain)
    with open(rpt) as f:
        report = json.load(f)
    assert report["profile"]["knobs_applied"] == ["mesh"]
    assert report["profile"]["seeded_router"] is True
    assert report["device"]["routing"]["prior_source"] == "profile"
    for env in profile.KNOB_ENV.values():
        monkeypatch.delenv(env, raising=False)
    want = str(tmp_path / "jax.bam")
    assert jax_main(pre + ["simplex", "-i", grouped, "-o", want]) == 0
    assert _records(want) == _records(plain)


def test_serve_applies_the_profile_once_across_jobs(quick_tune, grouped,
                                                    tmp_path):
    """A daemon started with ``--profile`` applies it at start (one
    'knob(s) applied' line, one fingerprint warning) and each of two jobs
    carries its outcome (the run report's ``profile`` section) without
    applying it again."""
    import shutil
    import tempfile

    with open(os.path.join(quick_tune[0], "deploy_profile.json")) as f:
        doc = json.load(f)
    doc["fingerprint"]["cpu_count"] += 64
    prof = str(tmp_path / "p.json")
    with open(prof, "w") as f:
        json.dump(doc, f)
    sock_dir = tempfile.mkdtemp(prefix="ftt")
    sock = os.path.join(sock_dir, "d.sock")
    reports = str(tmp_path / "reports")
    err = open(tmp_path / "daemon.log", "w")
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("FGUMI_TPU_PROFILE", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", "--profile", prof,
         "serve", "--socket", sock, "--no-warmup", "--workers", "1",
         "--report-dir", reports], env=env, stdout=subprocess.DEVNULL,
        stderr=err)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                client = ServeClient(sock, timeout=30)
                client.ping()
                break
            except Exception:  # noqa: BLE001 - not up yet
                assert time.monotonic() < deadline and proc.poll() is None
                time.sleep(0.1)
        outs = [str(tmp_path / f"o{i}.bam") for i in range(2)]
        ids = [client.submit(["simplex", "-i", grouped, "-o", out,
                              "--device", "cpu"])["id"] for out in outs]
        for jid in ids:
            assert client.wait(jid, timeout=WAIT_S)["state"] == "done"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    text = (tmp_path / "daemon.log").read_text()
    assert text.count("knob(s) applied") == 1, text
    assert text.count("DIFFERENT hardware") == 1, text
    assert _records(outs[0]) == _records(outs[1])
    for jid in ids:
        with open(os.path.join(reports, f"{jid}.report.json")) as f:
            report = json.load(f)
        assert report["profile"]["path"] == prof
        assert report["profile"]["knobs_applied"] == ["mesh"]
        assert report["metrics"]["tune.profile.loaded"] == 1
        assert report["metrics"]["tune.profile.fingerprint_mismatch"] == 1
