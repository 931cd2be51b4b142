"""Deployment profiles on the port (``fgumi_tpu_torch/tune/profile.py``),
against the JAX package's (``fgumi_tpu.tune.profile``).

- The validator: a corpus of documents (every knob and prior out of range,
  bad types, an unknown knob or chooser, a schema too new, bad ``mesh`` and
  ``shape_buckets``) gets the same verdict from both packages, with the
  same ``ProfileError`` text; so do ``load_profile``'s errors and the knob
  grammars of ``FGUMI_TPU_MESH`` and ``FGUMI_TPU_SHAPE_BUCKETS``.
- Application: precedence per knob (an explicit variable wins), once a
  process, cold-only seeding with ``prior_source == "profile"``, the seeded
  chooser's first decision, the fingerprint mismatch's one warning, the
  ``tune.profile.*`` gauges in the current scope and the run report's
  ``profile`` section.
- Profiles are interchangeable: the JAX package's ``tune --replay`` output
  and its ``write_profile`` documents load and apply on the port.
- The coalescer stays opt-in: a profile's window is listed as applied but
  fills the variable only where ``FGUMI_TPU_COALESCE`` is set, so it arms
  nothing alone; ``FGUMI_TPU_COALESCE=auto|1`` opts in and the profile's
  window is the hold (``serve --coalesce-window-ms`` sets its own).
- Through the CLI: ``simplex --device cpu`` under ``--profile`` and under
  ``FGUMI_TPU_PROFILE`` writes the records it writes without one and that
  the JAX CLI writes under the same profile; a ``mesh`` other than ``off``
  exits 2 "not yet ported (multi-GPU)" naming the profile, before any
  output, unless ``FGUMI_TPU_MESH=off`` is set; a bad ``mesh`` or
  ``shape_buckets`` exits 2 with the JAX CLI's line; ``shape_buckets``
  fills a variable the port never reads.

Every test starts and ends with no profile applied in either package, the
profile's variables unset and fresh routers and choosers
(:func:`profile_state`).
"""

import copy
import json
import logging
import os

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.ops import datapath as jax_datapath
from fgumi_tpu.ops import router as jax_router
from fgumi_tpu.tune import profile as jax_profile
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.ops import coalesce
from fgumi_tpu_torch.ops import kernel as port_kernel
from fgumi_tpu_torch.ops import router
from fgumi_tpu_torch.tune import profile

#: every variable a profile can fill, plus the ones that name or arm it
PROFILE_ENV = tuple(profile.KNOB_ENV.values()) + (
    "FGUMI_TPU_PROFILE", "FGUMI_TPU_COALESCE")


@pytest.fixture
def profile_state(monkeypatch):
    """No profile applied in either package, the profile's variables unset
    (and unset again afterwards, whatever an application filled), fresh
    routers and choosers in both packages, and an unconfigured port
    feeder (its depth is read once a process). Afterwards the JAX
    package's shape ladder, which reads ``FGUMI_TPU_SHAPE_BUCKETS`` once
    (a profile run through the JAX CLI filled it), reads it again."""
    for env in PROFILE_ENV:
        monkeypatch.setenv(env, "")
        monkeypatch.delenv(env)
    for prof, mod in ((profile, router), (jax_profile, jax_router)):
        prof.reset_applied_for_tests()
        monkeypatch.setattr(mod, "ROUTER", mod.OffloadRouter())
        for name in ("duplex_combine", "codec_combine"):
            monkeypatch.setattr(mod, name.upper(), mod.AdaptiveChooser(name))
    monkeypatch.setattr(port_kernel.DEVICE_FEEDER, "_depth", None)
    monkeypatch.setattr(port_kernel.DEVICE_FEEDER, "_budget", None)
    yield
    profile.reset_applied_for_tests()
    jax_profile.reset_applied_for_tests()
    jax_datapath.SHAPE_REGISTRY.reconfigure()


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


def base_profile(**over):
    doc = {
        "schema_version": 1,
        "tool": "fgumi-tpu tune",
        "created_unix": 1700000000,
        "source": "autotune",
        "fingerprint": profile.fingerprint_host(),
        "knobs": {"feeder_depth": 3, "coalesce_window_ms": 5.0},
        "priors": {
            "router": {"link_mbps": 120.0, "overhead_s": 0.01,
                       "dispatch_wall_s": 0.02,
                       "host_mcells_per_s": 50.0,
                       "filter_keep_rate": 0.7},
            "choosers": {"duplex_combine": {"device_s_per_mcell": 0.001,
                                            "host_s_per_mcell": 0.004}},
        },
    }
    doc.update(over)
    return doc


def write(path, doc) -> str:
    with open(path, "w") as f:
        json.dump(doc, f)
    return str(path)


# ---------------------------------------------------------------------------
# the validator


def _set(*keys_value):
    """A mutation: the value at the key path (the last element)."""
    *keys, value = keys_value

    def mutate(doc):
        d = doc
        for k in keys[:-1]:
            d = d.setdefault(k, {})
        d[keys[-1]] = value
    return mutate


def _pop(*keys):
    def mutate(doc):
        d = doc
        for k in keys[:-1]:
            d = d[k]
        d.pop(keys[-1])
    return mutate


CORPUS = {
    "valid": lambda d: None,
    "empty_knobs_priors": lambda d: d.update(knobs={}, priors={}),
    "no_knobs_priors": lambda d: (d.pop("knobs"), d.pop("priors")),
    "not_an_object": lambda d: d.clear() or d.update(x=None),
    "no_schema_version": _pop("schema_version"),
    "schema_version_0": _set("schema_version", 0),
    "schema_version_str": _set("schema_version", "1"),
    "schema_version_bool": _set("schema_version", True),
    "schema_too_new": _set("schema_version", 99),
    "no_fingerprint": _pop("fingerprint"),
    "fingerprint_list": _set("fingerprint", []),
    "bad_source": _set("source", "guesswork"),
    "source_manual": _set("source", "manual"),
    "source_replay": _set("source", "replay"),
    "knobs_list": _set("knobs", []),
    "unknown_knob": _set("knobs", "bogus_knob", 1),
    "feeder_depth_1": _set("knobs", "feeder_depth", 1),
    "feeder_depth_65": _set("knobs", "feeder_depth", 65),
    "feeder_depth_float": _set("knobs", "feeder_depth", 3.0),
    "feeder_depth_str": _set("knobs", "feeder_depth", "two"),
    "feeder_depth_bool": _set("knobs", "feeder_depth", True),
    "feeder_depth_64": _set("knobs", "feeder_depth", 64),
    "feeder_bytes_small": _set("knobs", "feeder_bytes", 1000),
    "feeder_bytes_ok": _set("knobs", "feeder_bytes", 64 << 20),
    "chain_bytes_small": _set("knobs", "chain_bytes", 100),
    "chain_bytes_float": _set("knobs", "chain_bytes", 1e6),
    "window_negative": _set("knobs", "coalesce_window_ms", -1),
    "window_high": _set("knobs", "coalesce_window_ms", 1000.5),
    "window_str": _set("knobs", "coalesce_window_ms", "5"),
    "shape_buckets_growth": _set("knobs", "shape_buckets", "9.9"),
    "shape_buckets_cap": _set("knobs", "shape_buckets", "1.5:100"),
    "shape_buckets_fields": _set("knobs", "shape_buckets", "1.5:2048:3"),
    "shape_buckets_nan": _set("knobs", "shape_buckets", "x"),
    "shape_buckets_cap_str": _set("knobs", "shape_buckets", "1.5:big"),
    "shape_buckets_ok": _set("knobs", "shape_buckets", "1.25:4096"),
    "shape_buckets_empty": _set("knobs", "shape_buckets", ""),
    "mesh_dp0": _set("knobs", "mesh", "dp0"),
    "mesh_bogus": _set("knobs", "mesh", "bogus"),
    "mesh_sp0": _set("knobs", "mesh", "dp2xsp0"),
    "mesh_auto": _set("knobs", "mesh", "auto"),
    "mesh_off": _set("knobs", "mesh", "off"),
    "mesh_shape": _set("knobs", "mesh", "DP2xSP2"),
    "priors_list": _set("priors", []),
    "router_list": _set("priors", "router", []),
    "link_negative": _set("priors", "router", {"link_mbps": -5}),
    "link_zero": _set("priors", "router", {"link_mbps": 0}),
    "link_str": _set("priors", "router", {"link_mbps": "fast"}),
    "overhead_negative": _set("priors", "router", {"overhead_s": -0.1}),
    "wall_zero": _set("priors", "router", {"dispatch_wall_s": 0}),
    "host_rate_zero": _set("priors", "router", {"host_mcells_per_s": 0}),
    "keep_high": _set("priors", "router", {"filter_keep_rate": 1.5}),
    "keep_negative": _set("priors", "router", {"filter_keep_rate": -0.1}),
    "router_none_values": _set("priors", "router", {"link_mbps": None}),
    "mesh_prior_list": _set("priors", "router", {"mesh": []}),
    "mesh_prior_key0": _set("priors", "router", {"mesh": {"0": {}}}),
    "mesh_prior_key_str": _set("priors", "router", {"mesh": {"x": {}}}),
    "mesh_prior_value": _set("priors", "router", {"mesh": {"4": 3}}),
    "mesh_prior_negative": _set("priors", "router",
                                {"mesh": {"4": {"overhead_s": -1}}}),
    "mesh_prior_ok": _set("priors", "router",
                          {"mesh": {"4": {"link_mbps": 10.0}}}),
    "choosers_list": _set("priors", "choosers", []),
    "unknown_chooser": _set("priors", "choosers", {"nope": {}}),
    "chooser_list": _set("priors", "choosers", {"codec_combine": []}),
    "chooser_negative": _set("priors", "choosers", {
        "codec_combine": {"host_s_per_mcell": -1}}),
    "chooser_str": _set("priors", "choosers", {
        "duplex_combine": {"device_s_per_mcell": "x"}}),
    "crossover_dict": _set("priors", "crossover", {}),
    "crossover_ok": _set("priors", "crossover", [{"name": "a"}]),
}


#: the corpus's documents both packages accept
VALID = {"valid", "empty_knobs_priors", "no_knobs_priors", "source_manual",
         "source_replay", "feeder_depth_64", "feeder_bytes_ok",
         "shape_buckets_ok", "shape_buckets_empty", "mesh_auto", "mesh_off",
         "mesh_shape", "router_none_values", "mesh_prior_ok",
         "crossover_ok", "schema_version_bool", "wall_zero"}


def _verdict(mod, doc):
    try:
        mod.validate_profile(doc)
        return "ok"
    except mod.ProfileError as e:
        return f"error: {e}"


@pytest.mark.parametrize("case", sorted(CORPUS))
def test_validator_verdicts_equal_jax(case):
    doc = base_profile()
    CORPUS[case](doc)
    got = _verdict(profile, copy.deepcopy(doc))
    assert got == _verdict(jax_profile, copy.deepcopy(doc))
    if case in VALID:
        assert got == "ok"
    else:
        assert got.startswith("error: ") and "expected" in got


def test_not_a_document_equal_jax():
    for doc in (None, [], "x", 3):
        assert _verdict(profile, doc) == _verdict(jax_profile, doc) \
            != "ok"


@pytest.mark.parametrize("spec", ["", None, "1.0625", "2.0", "1.01:1024",
                                  "1.009", "2.01", "a", "1.5:1023",
                                  "1.5:x", "1:2:3", " 1.5 "])
def test_shape_bucket_grammar_equals_jax(spec):
    from fgumi_tpu.ops.datapath import parse_shape_buckets

    def run(fn):
        try:
            return fn(spec)
        except ValueError as e:
            return str(e)

    assert run(profile.parse_shape_buckets) == run(parse_shape_buckets)


@pytest.mark.parametrize("spec", [None, "", "off", "None", "0", "1", "auto",
                                  "AUTO", "dp2", "dp4xsp2", "dp0", "dp2xsp0",
                                  "bogus", " dp1xsp1 "])
def test_mesh_grammar_equals_jax(spec):
    from fgumi_tpu.parallel.mesh import MeshConfigError as JaxMeshError
    from fgumi_tpu.parallel.mesh import parse_mesh_spec as jax_parse
    from fgumi_tpu_torch.parallel import MeshConfigError
    from fgumi_tpu_torch.parallel.mesh import parse_mesh_spec

    def run(fn, err):
        try:
            return fn(spec)
        except err as e:
            return f"error: {e}"

    assert run(parse_mesh_spec, MeshConfigError) == run(jax_parse,
                                                        JaxMeshError)


def test_load_profile_errors_equal_jax(tmp_path):
    (tmp_path / "bad.json").write_text("{not json")
    cases = {"missing": str(tmp_path / "nope.json"),
             "bad_json": str(tmp_path / "bad.json"),
             "schema": write(tmp_path / "schema.json",
                             {"schema_version": 1}),
             "a_directory": str(tmp_path)}
    for name, path in cases.items():
        msgs = []
        for mod in (profile, jax_profile):
            with pytest.raises(mod.ProfileError) as ei:
                mod.load_profile(path)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1], name
    with pytest.raises(profile.ProfileError, match="unreadable"):
        profile.load_profile(cases["missing"])
    with pytest.raises(profile.ProfileError, match="not valid JSON"):
        profile.load_profile(cases["bad_json"])


def test_write_profile_round_trip_and_validates(tmp_path):
    path = str(tmp_path / "p.json")
    profile.write_profile(path, base_profile())
    assert profile.load_profile(path) == base_profile()
    assert jax_profile.load_profile(path) == base_profile()
    assert os.listdir(tmp_path) == ["p.json"]  # atomic: no temporary left
    with pytest.raises(profile.ProfileError):
        profile.write_profile(str(tmp_path / "q.json"),
                              base_profile(source="x"))
    assert os.listdir(tmp_path) == ["p.json"]


# ---------------------------------------------------------------------------
# application


@pytest.mark.parametrize("knob,env,value", [
    ("feeder_depth", "FGUMI_TPU_FEEDER_DEPTH", 4),
    ("feeder_bytes", "FGUMI_TPU_FEEDER_BYTES", 64 << 20),
    ("shape_buckets", "FGUMI_TPU_SHAPE_BUCKETS", "1.25:4096"),
    ("chain_bytes", "FGUMI_TPU_CHAIN_BYTES", 1 << 20),
    ("coalesce_window_ms", "FGUMI_TPU_COALESCE_WINDOW_MS", 3.5),
    ("mesh", "FGUMI_TPU_MESH", "dp2xsp1"),
])
def test_precedence_per_knob_equals_jax(profile_state, monkeypatch, knob,
                                        env, value):
    """An explicit variable beats the profile, which beats the default;
    the records of both packages agree knob by knob (the port fills the
    coalescer's window where ``FGUMI_TPU_COALESCE`` opts in)."""
    doc = base_profile(knobs={knob: value})
    if knob == "coalesce_window_ms":
        monkeypatch.setenv("FGUMI_TPU_COALESCE", "auto")
    for mod in (profile, jax_profile):
        monkeypatch.setenv(env, "explicit")
        rec = mod.apply_profile(doc, path="p")
        assert rec["skipped_explicit"] == [knob] and rec["applied"] == []
        assert os.environ[env] == "explicit"
        mod.reset_applied_for_tests()
        monkeypatch.delenv(env)
        rec = mod.apply_profile(doc, path="p")
        assert rec["applied"] == [knob] and rec["skipped_explicit"] == []
        assert os.environ[env] == str(value)
        monkeypatch.delenv(env)


def test_application_is_process_once(profile_state, caplog):
    fp = profile.fingerprint_host()
    fp["cpu_count"] = (fp["cpu_count"] or 1) + 64
    with caplog.at_level(logging.INFO, logger="fgumi_tpu_torch"):
        rec = profile.apply_profile(base_profile(fingerprint=fp), "first")
        again = profile.apply_profile(
            base_profile(knobs={"mesh": "auto"}), "second")
        assert profile.maybe_apply_from_env("third.json") is rec
    assert again is rec and profile.applied_info() is rec
    assert "FGUMI_TPU_MESH" not in os.environ
    lines = [r.getMessage() for r in caplog.records]
    assert sum("DIFFERENT hardware" in ln for ln in lines) == 1
    assert sum("knob(s) applied" in ln for ln in lines) == 1


def test_seeding_is_cold_only_and_stamps_profile(profile_state,
                                                 monkeypatch):
    live = router.ROUTER
    live.observe_host(1_000_000, 0.1)  # measured: 10 Mcells/s
    rec = profile.apply_profile(base_profile(), "p")
    snap = live.snapshot()
    assert rec["seeded_router"] and snap["prior_source"] == "profile"
    assert snap["host_mcells_per_s"] == 10.0  # the live EWMA kept
    assert snap["link_mbps"] == 120.0 and snap["overhead_s"] == 0.01
    assert rec["seeded_choosers"] == ["duplex_combine"]
    # the same document seeds the JAX package's router alike (its knobs
    # unset again first: the port's application filled them)
    for env in profile.KNOB_ENV.values():
        monkeypatch.delenv(env, raising=False)
    jax_router.ROUTER.observe_host(1_000_000, 0.1)
    jrec = jax_profile.apply_profile(base_profile(), "p")
    jsnap = jax_router.ROUTER.snapshot()
    for k in ("prior_source", "link_mbps", "overhead_s", "dispatch_wall_s",
              "host_mcells_per_s", "filter_keep_rate"):
        assert snap[k] == jsnap[k], k
    assert {k: v for k, v in rec.items() if k != "path"} \
        == {k: v for k, v in jrec.items() if k != "path"}


def test_cold_router_unseeded_by_empty_priors(profile_state):
    rec = profile.apply_profile(base_profile(priors={}), "p")
    assert not rec["seeded_router"] and rec["seeded_choosers"] == []
    assert router.ROUTER.snapshot()["prior_source"] == "cold"


def test_seeded_chooser_decides_the_winner_first(profile_state,
                                                 monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_ROUTE_PROBE", raising=False)
    cold = router.AdaptiveChooser("t_cold")
    assert cold.decide(1000) == "device"  # alternates while unmeasured
    doc = base_profile(priors={"choosers": {
        "duplex_combine": {"device_s_per_mcell": 4.0,
                           "host_s_per_mcell": 1.0},
        "codec_combine": {"device_s_per_mcell": 1.0,
                          "host_s_per_mcell": 4.0}}})
    rec = profile.apply_profile(doc, "p")
    assert rec["seeded_choosers"] == ["duplex_combine", "codec_combine"]
    assert router.DUPLEX_COMBINE.decide(1000) == "host"
    assert router.CODEC_COMBINE.decide(1000) == "device"
    # cold-only: a second seed changes nothing
    assert not router.DUPLEX_COMBINE.seed(device_s_per_mcell=0.1)


def test_fingerprint_mismatch_warns_but_loads(profile_state, caplog):
    fp = {"platform": "linux", "machine": "x86_64", "cpu_count": 224,
          "ram_bytes": 4 << 40, "jax_backend": "tpu", "device_count": 4}
    with caplog.at_level(logging.WARNING, logger="fgumi_tpu_torch"):
        rec = profile.apply_profile(base_profile(fingerprint=fp),
                                    "tpu_host.json")
    warnings = [r.getMessage() for r in caplog.records
                if "DIFFERENT hardware" in r.getMessage()]
    assert len(warnings) == 1 and "cpu_count" in warnings[0]
    fields = {m["field"] for m in rec["fingerprint_mismatch"]}
    assert "cpu_count" in fields and "ram_bytes" in fields
    # a plain load never probes the card: no torch or jax fields compared
    assert not fields & {"device_count", "jax_backend", "torch_backend"}
    assert rec["applied"] == ["coalesce_window_ms", "feeder_depth"]


def test_matching_fingerprint_is_silent(profile_state, caplog):
    with caplog.at_level(logging.WARNING, logger="fgumi_tpu_torch"):
        rec = profile.apply_profile(base_profile(), "here.json")
    assert rec["fingerprint_mismatch"] == []
    assert not any("DIFFERENT" in r.getMessage() for r in caplog.records)


def test_fingerprint_of_a_plain_load_is_cheap():
    fp = profile.fingerprint_host()
    assert set(fp) == {"platform", "machine", "cpu_count", "ram_bytes"}
    jfp = jax_profile.fingerprint_host()
    for k in fp:
        assert fp[k] == jfp[k]
    cpu = profile.fingerprint_host("cpu")
    assert cpu["torch_backend"] == "cpu" and cpu["device_count"] == 0


def test_stamp_metrics_writes_into_the_current_scope(profile_state):
    from fgumi_tpu_torch.observe.metrics import METRICS
    from fgumi_tpu_torch.observe.scope import scoped_telemetry

    with scoped_telemetry("before") as scope:
        profile.stamp_metrics()  # nothing applied: nothing stamped
        assert "tune.profile.loaded" not in scope.metrics.snapshot()
    profile.apply_profile(base_profile(), "p")
    with scoped_telemetry("job") as scope:
        profile.stamp_metrics()
        assert METRICS.snapshot() is not None
        snap = scope.metrics.snapshot()
    assert snap["tune.profile.loaded"] == 1
    assert snap["tune.profile.knobs_applied"] == 2
    assert snap["tune.profile.knobs_skipped_explicit"] == 0
    assert snap["tune.profile.fingerprint_mismatch"] == 0
    assert snap["tune.profile.seeded_router"] == 1


def test_profile_section_rides_the_run_report(profile_state):
    from fgumi_tpu_torch.observe.report import build_report, validate_report

    profile.apply_profile(base_profile(), path="prof.json")
    report = build_report("sort", ["sort"], 0.0, 0.1, 0)
    assert validate_report(report) == []
    from fgumi_tpu.observe.report import validate_report as jax_validate

    assert jax_validate(report) == []
    assert report["profile"] == {
        "path": "prof.json",
        "knobs_applied": ["coalesce_window_ms", "feeder_depth"],
        "knobs_skipped_explicit": [], "fingerprint_mismatch": [],
        "seeded_router": True, "seeded_choosers": ["duplex_combine"]}
    assert report["device"]["routing"]["prior_source"] == "profile"


# ---------------------------------------------------------------------------
# interchangeable with the JAX package's documents


def test_jax_replay_profile_loads_and_applies_on_the_port(profile_state,
                                                         tmp_path):
    rpt = write(tmp_path / "r.json", {"device": {"routing": {
        "link_mbps": 3500.0, "overhead_s": 0.002, "dispatch_wall_s": 0.006,
        "host_mcells_per_s": 49.4, "filter_keep_rate": 0.46}}})
    path = str(tmp_path / "jax.json")
    assert jax_main(["tune", "--replay", rpt, "-o", path, "--atlas",
                     ""]) == 0
    doc = profile.load_profile(path)
    assert doc == jax_profile.load_profile(path)
    rec = profile.apply_profile(doc, path)
    assert rec["seeded_router"]
    assert sorted(rec["applied"]) == sorted(doc["knobs"])
    assert router.ROUTER.snapshot()["link_mbps"] == 3500.0


def test_jax_written_profile_loads_on_the_port(tmp_path):
    path = str(tmp_path / "p.json")
    jax_profile.write_profile(path, base_profile(
        knobs={"mesh": "off", "shape_buckets": "1.5:4096",
               "chain_bytes": 1 << 20}))
    assert profile.load_profile(path) == jax_profile.load_profile(path)


# ---------------------------------------------------------------------------
# the coalescer stays opt-in


def test_profile_window_does_not_arm_the_coalescer(profile_state,
                                                   monkeypatch):
    """Alone, the profile lists its window as applied and leaves the
    variable unset: the coalescer stays off. Where ``FGUMI_TPU_COALESCE``
    is set at application, it fills the window, which is the hold."""
    rec = profile.apply_profile(base_profile(), "p")
    assert "coalesce_window_ms" in rec["applied"]
    assert "FGUMI_TPU_COALESCE_WINDOW_MS" not in os.environ
    c = coalesce.DispatchCoalescer()
    c.set_serving(True)
    c.set_active_jobs(2)
    assert coalesce._force_mode() == "off" and not c.armed()
    for value, mode in (("auto", "auto"), ("1", "force"), ("0", "off")):
        profile.reset_applied_for_tests()
        monkeypatch.delenv("FGUMI_TPU_COALESCE_WINDOW_MS", raising=False)
        monkeypatch.setenv("FGUMI_TPU_COALESCE", value)
        rec = profile.apply_profile(base_profile(), "p")
        assert "coalesce_window_ms" in rec["applied"]
        assert os.environ["FGUMI_TPU_COALESCE_WINDOW_MS"] == "5.0"
        assert coalesce._force_mode() == mode
        assert c.armed() == (mode != "off")
        assert coalesce.window_s() == 0.005  # the profile's hold
    monkeypatch.delenv("FGUMI_TPU_COALESCE")
    # an explicit window (serve --coalesce-window-ms) opts in
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "7")
    assert coalesce._force_mode() == "auto" and c.armed()


def test_explicit_window_with_a_profile_still_arms(profile_state,
                                                   monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_COALESCE_WINDOW_MS", "2")
    rec = profile.apply_profile(base_profile(), "p")
    assert rec["skipped_explicit"] == ["coalesce_window_ms"]
    assert coalesce._force_mode() == "auto"


def test_serve_window_flag_takes_the_window_back(profile_state,
                                                 monkeypatch, tmp_path):
    from fgumi_tpu_torch import cli as port_cli

    profile.apply_profile(base_profile(), "p")
    seen = {}

    def fake_service(*args, **kwargs):
        seen["mode"] = coalesce._force_mode()
        raise ValueError("stopped before binding")

    monkeypatch.setattr("fgumi_tpu_torch.serve.daemon.JobService",
                        fake_service)
    assert port_cli.main(["serve", "--socket", str(tmp_path / "s.sock"),
                          "--no-warmup", "--coalesce-window-ms",
                          "5.0"]) == 2
    assert seen["mode"] == "auto"


# ---------------------------------------------------------------------------
# through the CLI


@pytest.fixture(scope="module")
def grouped(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("torch_profile") / "g.bam")
    assert port_main(["simulate", "grouped-reads", "-o", path,
                      "--num-families", "200", "--family-size", "3",
                      "--seed", "8"]) == 0
    return path


@pytest.fixture(scope="module")
def plain_records(grouped, tmp_path_factory):
    out = str(tmp_path_factory.mktemp("torch_profile_plain") / "c.bam")
    assert port_main(["simplex", "-i", grouped, "-o", out, "--device",
                      "cpu"]) == 0
    return _records(out)


def _records(path):
    with BamReader(path) as r:
        return ([ln for ln in r.header.text.splitlines()
                 if not ln.startswith("@PG")], [rec.data for rec in r])


def _errors(caplog):
    return [r.getMessage() for r in caplog.records
            if r.levelno >= logging.ERROR]


CLI_PROFILE = base_profile(knobs={
    "feeder_depth": 2, "feeder_bytes": 1 << 20, "chain_bytes": 1 << 16,
    "coalesce_window_ms": 0.5, "mesh": "off",
    "shape_buckets": "1.5:4096"})


@pytest.mark.parametrize("how", ["flag", "env"])
def test_simplex_under_a_profile_equals_plain_and_jax(
        profile_state, grouped, plain_records, tmp_path, monkeypatch, how):
    p = write(tmp_path / "p.json", CLI_PROFILE)
    pre = ["--profile", p] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("FGUMI_TPU_PROFILE", p)
    out, rpt = str(tmp_path / "c.bam"), str(tmp_path / "r.json")
    assert port_main(pre + ["--run-report", rpt, "simplex", "-i", grouped,
                            "-o", out, "--device", "cpu"]) == 0
    assert _records(out) == plain_records
    with open(rpt) as f:
        report = json.load(f)
    assert report["profile"]["path"] == p
    assert sorted(report["profile"]["knobs_applied"]) \
        == sorted(CLI_PROFILE["knobs"])
    assert report["profile"]["seeded_router"] is True
    assert report["device"]["routing"]["prior_source"] == "profile"
    assert report["metrics"]["tune.profile.loaded"] == 1
    # the filled window arms nothing; the knobs stay in the environment
    assert coalesce._force_mode() == "off"
    assert os.environ["FGUMI_TPU_SHAPE_BUCKETS"] == "1.5:4096"
    # the JAX CLI under the same profile, in the same process
    for env in profile.KNOB_ENV.values():
        monkeypatch.delenv(env, raising=False)
    want = str(tmp_path / "j.bam")
    assert jax_main(pre + ["simplex", "-i", grouped, "-o", want]) == 0
    assert _records(want) == plain_records
    assert jax_profile.applied_info()["applied"] \
        == profile.applied_info()["applied"]


@pytest.mark.parametrize("mesh", ["auto", "dp2", "dp1xsp2"])
def test_profile_mesh_exits_2_naming_the_profile(profile_state, grouped,
                                                 tmp_path, caplog, mesh):
    p = write(tmp_path / "p.json", base_profile(knobs={"mesh": mesh}))
    out = tmp_path / "c.bam"
    assert port_main(["--profile", p, "simplex", "-i", grouped, "-o",
                      str(out), "--device", "cpu"]) == 2
    assert not out.exists() and os.listdir(tmp_path) == ["p.json"]
    assert _errors(caplog) == [
        f"FGUMI_TPU_MESH={mesh} (from profile {p}): not yet ported "
        "(multi-GPU)"]


def test_explicit_mesh_off_beats_the_profile(profile_state, grouped,
                                             plain_records, tmp_path,
                                             monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_MESH", "off")
    p = write(tmp_path / "p.json", base_profile(knobs={"mesh": "auto"}))
    out = str(tmp_path / "c.bam")
    assert port_main(["--profile", p, "simplex", "-i", grouped, "-o", out,
                      "--device", "cpu"]) == 0
    assert profile.applied_info()["skipped_explicit"] == ["mesh"]
    assert _records(out) == plain_records


@pytest.mark.parametrize("knobs", [{"mesh": "dp0"}, {"mesh": "bogus"},
                                   {"shape_buckets": "9.9"},
                                   {"shape_buckets": "1.5:10"},
                                   {"feeder_depth": 1}])
def test_bad_knob_exits_2_with_the_jax_line(profile_state, grouped, tmp_path,
                                            caplog, knobs):
    p = write(tmp_path / "p.json", base_profile(knobs=knobs))
    lines = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        caplog.clear()
        out = tmp_path / "c.bam"
        assert main(["--profile", p, "simplex", "-i", grouped, "-o",
                     str(out), *extra]) == 2
        assert not out.exists()
        lines.append(_errors(caplog))
    assert lines[0] == lines[1] and len(lines[0]) == 1
    assert lines[0][0].startswith("profile:knobs.")
    assert profile.applied_info() is None


@pytest.mark.parametrize("how", ["flag", "env"])
def test_missing_profile_exits_2_as_jax(profile_state, grouped, tmp_path,
                                        caplog, monkeypatch, how):
    missing = str(tmp_path / "nope.json")
    pre = ["--profile", missing] if how == "flag" else []
    if how == "env":
        monkeypatch.setenv("FGUMI_TPU_PROFILE", missing)
    lines = []
    for main, extra in ((port_main, ["--device", "cpu"]), (jax_main, [])):
        caplog.clear()
        assert main(pre + ["simplex", "-i", grouped, "-o",
                           str(tmp_path / "c.bam"), *extra]) == 2
        lines.append(_errors(caplog))
    assert lines[0] == lines[1]
    assert lines[0] == [f"FGUMI_TPU_PROFILE={missing!r}: unreadable (No such "
                        "file or directory); expected a readable profile "
                        "JSON path"]
