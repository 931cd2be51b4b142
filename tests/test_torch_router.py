"""The offload router (``fgumi_tpu_torch/ops/router.py``) against the JAX
package's, and the port's routing policy.

- ``decide``/``decide_batch`` give the JAX package's side, reason and
  predicted walls on one seeded grid of EWMA states, batch shapes, in-flight
  counts and knobs (``ROUTE``, ``MAX_INFLIGHT``, ``ROUTE_PROBE``), the
  port under its opt-in ``FGUMI_TPU_HYBRID=1`` (the JAX package's model is
  on whenever an accelerator is attached), with both fed the same
  measurements; an open or SDC-quarantined breaker is stamped alike.
- The two strand-combine choosers decide alike over a seeded script.
- :func:`route_mode`, the port's one policy function, on every combination
  of its knobs; unset, every batch goes to the device and the breaker moves
  no work.
- A device failure inside ``run_adaptive_stage`` raises on the port (the
  JAX package finishes the stage on the host): a departure, tested as one.
- Router states and the daemon's routing snapshot file round-trip both
  ways between the packages."""

import itertools
import json
import os
import shutil
import tempfile

import numpy as np
import pytest

import fgumi_tpu.native.batch as jax_nb
from fgumi_tpu.ops import breaker as jax_breaker
from fgumi_tpu.ops import kernel as jax_kernel
from fgumi_tpu.ops import router as jax_router
from fgumi_tpu_torch.ops import breaker as port_breaker
from fgumi_tpu_torch.ops import kernel as port_kernel
from fgumi_tpu_torch.ops import router as port_router

KNOBS = ("FGUMI_TPU_ROUTE", "FGUMI_TPU_HYBRID", "FGUMI_TPU_HOST_ENGINE",
         "FGUMI_TPU_MAX_INFLIGHT", "FGUMI_TPU_ROUTE_PROBE")


class _Kernel:
    """The reference's mode gates of a kernel with an accelerator."""

    def hybrid_mode(self):
        return True

    def host_mode(self):
        return False


class _Stats:
    """A DeviceStats stand-in: a set in-flight count, the routes stamped."""

    def __init__(self):
        self.n = 0
        self.routes = []

    def in_flight_count(self):
        return self.n

    def add_route(self, side):
        self.routes.append(side)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(jax_nb, "available", lambda: True)
    jax_breaker.BREAKER.reset()
    port_breaker.BREAKER.reset()
    yield
    jax_breaker.BREAKER.reset()
    port_breaker.BREAKER.reset()


@pytest.fixture
def stats(monkeypatch):
    """Both packages' DeviceStats replaced by stand-ins."""
    out = {"jax": _Stats(), "port": _Stats()}
    monkeypatch.setattr(jax_kernel, "DEVICE_STATS", out["jax"])
    monkeypatch.setattr(port_kernel, "DEVICE_STATS", out["port"])
    return out


def _ewma_state(rng):
    def one(lo, hi):
        if rng.random() < 0.25:
            return {"value": None, "samples": 0}
        return {"value": float(10 ** rng.uniform(lo, hi)),
                "samples": int(rng.integers(1, 5))}

    return {"mesh": {"1": {"link_bps": one(6, 10), "overhead_s": one(-5, -1),
                           "dispatch_wall_s": one(-4, 0)}},
            "host_cps": one(6, 8.5), "filter_keep": one(-2, 0)}


ENVS = [{}, {"FGUMI_TPU_ROUTE": "device"}, {"FGUMI_TPU_ROUTE": "host"},
        {"FGUMI_TPU_MAX_INFLIGHT": "0"}, {"FGUMI_TPU_MAX_INFLIGHT": "2"},
        {"FGUMI_TPU_ROUTE_PROBE": "0"}, {"FGUMI_TPU_ROUTE_PROBE": "3"},
        {"FGUMI_TPU_ROUTE": "bogus"}]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(
    f"{k[10:]}={v}" for k, v in e.items()) or "defaults")
def test_decide_batch_equals_jax(monkeypatch, stats, env, seed):
    for k, v in {"FGUMI_TPU_HYBRID": "1", **env}.items():
        monkeypatch.setenv(k, v)
    rng = np.random.default_rng(seed)
    state = _ewma_state(rng)
    routers = {"jax": jax_router.OffloadRouter(),
               "port": port_router.OffloadRouter()}
    for r in routers.values():
        r.restore_state(state)
    kern = _Kernel()
    for step in range(40):
        n_rows = int(rng.integers(1, 200_000))
        J = int(rng.integers(1, max(n_rows // 2, 2)))
        L = int(rng.choice([4, 100, 152, 304]))
        filtered = bool(rng.random() < 0.3)
        inflight = int(rng.integers(0, 5))
        got = {}
        for name, r in routers.items():
            stats[name].n = inflight
            side = r.decide_batch(kern, n_rows, J, L, filtered=filtered)
            got[name] = (side, r.last_prediction(),
                         r.snapshot().get("last_decision"))
        assert got["port"] == got["jax"], (step, got)
        # the same measurements fed to both
        kind = rng.integers(0, 4)
        for r in routers.values():
            if kind == 0:
                r.observe_device(n_rows * L, 5 * J * L, 0.002 + step * 1e-4,
                                 0.001 * (step % 3), 0.004)
            elif kind == 1:
                r.observe_host(n_rows * L, 0.05 + 0.001 * step)
            elif kind == 2:
                r.observe_filter_keep(step % 7, 7)
    assert stats["port"].routes == stats["jax"].routes
    assert routers["port"].export_state() == routers["jax"].export_state()
    snap = routers["port"].snapshot()
    assert snap == routers["jax"].snapshot()


@pytest.mark.parametrize("trip", ["sdc", "transient"])
def test_open_breaker_denies_device_under_hybrid_only(monkeypatch, stats,
                                                     trip):
    monkeypatch.setenv("FGUMI_TPU_HYBRID", "1")
    for b in (jax_breaker.BREAKER, port_breaker.BREAKER):
        if trip == "sdc":
            b.record_sdc("test")
        else:
            for _ in range(10):
                b.record_transient_failure()
    why = "sdc-quarantine" if trip == "sdc" else "breaker-open"
    # a state in which the cost model prices the device the winner
    fast = {"mesh": {"1": {"link_bps": {"value": 1e10, "samples": 3},
                           "overhead_s": {"value": 1e-5, "samples": 3}}},
            "host_cps": {"value": 1e6, "samples": 3}}
    for mod in (jax_router, port_router):
        r = mod.OffloadRouter()
        r.restore_state(fast)
        assert r.decide_batch(_Kernel(), 1000, 100, 100) == "host"
        assert r.snapshot()["last_decision"]["why"] == why
    # the port's default route: the breaker moves no work
    monkeypatch.delenv("FGUMI_TPU_HYBRID")
    r = port_router.OffloadRouter()
    assert r.decide_batch(_Kernel(), 1000, 100, 100) == "device"
    assert r.snapshot()["last_decision"] == {"side": "device",
                                             "why": "default",
                                             "forced": False}


ROUTES = (None, "device", "host", "auto", "bogus")
HYBRIDS = (None, "auto", "1", "on", "0", "off")
ENGINES = (None, "1", "force", "0")
INFLIGHTS = (None, "3")


def _expected_mode(route, hybrid, engine, inflight):
    """The port's policy as README states it."""
    if route == "host" or engine in ("1", "force"):
        return "host"
    if hybrid in ("0", "off"):
        return "device"
    if hybrid in ("1", "on") or route == "auto" or inflight:
        return "hybrid"
    return "device"


@pytest.mark.parametrize("route,hybrid,engine,inflight", list(
    itertools.product(ROUTES, HYBRIDS, ENGINES, INFLIGHTS)))
def test_route_mode_matrix(monkeypatch, route, hybrid, engine, inflight):
    for name, v in (("FGUMI_TPU_ROUTE", route), ("FGUMI_TPU_HYBRID", hybrid),
                    ("FGUMI_TPU_HOST_ENGINE", engine),
                    ("FGUMI_TPU_MAX_INFLIGHT", inflight)):
        if v is not None:
            monkeypatch.setenv(name, v)
    want = _expected_mode(route, hybrid, engine, inflight)
    assert port_router.route_mode() == want
    side = port_router.OffloadRouter().decide_batch(_Kernel(), 100, 10, 100)
    if want == "host":
        assert side == "host"
    elif want == "device":
        assert side == "device"


def test_default_route_sends_every_batch_to_the_device(stats):
    r = port_router.OffloadRouter()
    for i in range(200):
        assert r.decide_batch(_Kernel(), 10 + i, 5, 100) == "device"
    assert stats["port"].routes == ["device"] * 200
    # the batch is still priced: its predicted wall sets the deadline
    t_dev, t_host = r.last_prediction()
    assert 0 < t_dev < 1 and t_host > 0
    assert port_kernel.dispatch_deadline_s(t_dev) == 30.0  # the floor


@pytest.mark.parametrize("override", ["auto", "device", "host"])
def test_choosers_equal_jax(monkeypatch, override):
    monkeypatch.setenv("FGUMI_TPU_ROUTE_PROBE", "5")
    rng = np.random.default_rng(3)
    a = jax_router.AdaptiveChooser("duplex_combine")
    b = port_router.AdaptiveChooser("duplex_combine")
    for step in range(60):
        cells = int(rng.integers(1, 10_000))
        side = a.decide(cells, override)
        assert b.decide(cells, override) == side, step
        t = float(rng.uniform(0.001, 0.01)) * (2 if side == "host" else 1)
        a.observe(side, cells, t)
        b.observe(side, cells, t)
    assert a.snapshot() == b.snapshot()
    assert a.export_state() == b.export_state()


@pytest.mark.parametrize("value,want", [(None, "device"), ("", "device"),
                                        ("device", "device"),
                                        ("host", "host"), ("auto", "auto"),
                                        (" AUTO ", "auto"),
                                        ("bogus", "device")])
def test_combine_override(monkeypatch, value, want):
    if value is not None:
        monkeypatch.setenv("FGUMI_TPU_CODEC_COMBINE", value)
    assert port_router.combine_override("CODEC_COMBINE") == want


def test_adaptive_stage_failure_raises_not_host():
    """A departure: the JAX package finishes a failed device stage on the
    host; the port's raises and the command publishes nothing."""
    from fgumi_tpu.utils.faults import InjectedFault as JaxFault
    from fgumi_tpu_torch.utils.faults import InjectedFault

    def fail_jax():
        raise JaxFault("injected fault at device.dispatch")

    def fail_port():
        raise InjectedFault("injected fault at device.dispatch")

    out, side = jax_router.run_adaptive_stage(
        jax_router.AdaptiveChooser("x"), 10, "device", fail_jax,
        lambda: "host result")
    assert (out, side) == ("host result", "host")
    chooser = port_router.AdaptiveChooser("x")
    with pytest.raises(InjectedFault):
        port_router.run_adaptive_stage(chooser, 10, "device", fail_port,
                                       lambda: "host result")
    # the failed attempt is charged to the device side
    assert chooser.snapshot()["device"]["samples"] == 1
    assert port_router.run_adaptive_stage(
        chooser, 10, "host", lambda: 1, lambda: "host result") == \
        ("host result", "host")


def test_state_round_trips_both_ways():
    rng = np.random.default_rng(9)
    for _ in range(5):
        state = _ewma_state(rng)
        src = port_router.OffloadRouter()
        src.restore_state(state)
        dst = jax_router.OffloadRouter()
        dst.restore_state(src.export_state())
        assert dst.export_state() == src.export_state()
        back = port_router.OffloadRouter()
        back.restore_state(dst.export_state())
        assert back.export_state() == src.export_state()
        assert back.snapshot() == dst.snapshot()


def test_daemon_routing_snapshot_files_interchange(monkeypatch):
    """A port daemon reads the JAX daemon's ``.routing.json`` and the other
    way round (schema 1, restored cold-only)."""
    from fgumi_tpu.serve.daemon import JobService as JaxService
    from fgumi_tpu_torch.serve.daemon import JobService as PortService

    d = tempfile.mkdtemp(prefix="ftr")
    try:
        state = _ewma_state(np.random.default_rng(2))
        for mod in (jax_router, port_router):
            monkeypatch.setattr(mod, "ROUTER", mod.OffloadRouter())
            monkeypatch.setattr(mod, "DUPLEX_COMBINE",
                                mod.AdaptiveChooser("duplex_combine"))
            monkeypatch.setattr(mod, "CODEC_COMBINE",
                                mod.AdaptiveChooser("codec_combine"))
        port_router.ROUTER.restore_state(state)
        port_router.DUPLEX_COMBINE.seed(2.5, 7.0)
        port_svc = PortService(os.path.join(d, "p.sock"))
        port_svc.routing_state = {}
        path = port_svc.save_routing_state()
        assert path == os.path.join(d, "p.sock.routing.json")
        saved = json.load(open(path))
        assert saved["schema_version"] == 1
        jax_svc = JaxService(os.path.join(d, "p.sock"))
        assert jax_svc.load_routing_state()
        assert jax_router.ROUTER.export_state() == \
            port_router.ROUTER.export_state()
        assert jax_router.ROUTER.prior_source == "snapshot"
        assert jax_router.DUPLEX_COMBINE.export_state() == \
            port_router.DUPLEX_COMBINE.export_state()
        # and back: the JAX daemon's file into a cold port router
        jax_svc.socket_path = os.path.join(d, "j.sock")
        jpath = jax_svc.save_routing_state()
        monkeypatch.setattr(port_router, "ROUTER",
                            port_router.OffloadRouter())
        port2 = PortService(os.path.join(d, "j.sock"))
        assert jpath == port2._routing_state_path()
        assert port2.load_routing_state()
        assert port_router.ROUTER.export_state() == \
            jax_router.ROUTER.export_state()
        assert port2.routing_state["loaded"]
        # a live measurement wins over a later restore (cold-only)
        port_router.ROUTER.observe_host(1000, 0.001)
        before = port_router.ROUTER.export_state()["host_cps"]
        port2.load_routing_state()
        assert port_router.ROUTER.export_state()["host_cps"] == before
        # another schema starts cold
        with open(jpath, "w") as f:
            json.dump({"schema_version": 2}, f)
        assert not PortService(os.path.join(d, "j.sock")).load_routing_state()
    finally:
        shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# the commands under each route, against the JAX CLI


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    from fgumi_tpu_torch import cli as port_cli

    d = tmp_path_factory.mktemp("torch_router_cli")
    p = {k: str(d / f"{k}.bam") for k in ("simplex", "duplex", "codec")}
    for argv in (["simulate", "grouped-reads", "-o", p["simplex"],
                  "--num-families", "300", "--seed", "3"],
                 ["simulate", "duplex-reads", "-o", p["duplex"],
                  "--num-molecules", "200", "--seed", "4"],
                 ["simulate", "codec-reads", "-o", p["codec"],
                  "--num-molecules", "200", "--seed", "5"]):
        assert port_cli.main(argv) == 0
    p["jax_lib"] = tmp_path_factory.mktemp("router_jax_native")
    return p


ROUTE_ENVS = {"host": {"FGUMI_TPU_ROUTE": "host"},
              "hybrid": {"FGUMI_TPU_HYBRID": "1"},
              "audit_all": {"FGUMI_TPU_AUDIT": "all"}}


@pytest.mark.parametrize("route", sorted(ROUTE_ENVS))
@pytest.mark.parametrize("command", ["simplex", "duplex", "codec"])
def test_cli_records_equal_jax_under_route(tmp_path, monkeypatch,
                                           cli_inputs, command, route):
    from fgumi_tpu import cli as jax_cli
    from fgumi_tpu.io.bam import BamReader
    from fgumi_tpu_torch import cli as port_cli
    from fgumi_tpu_torch.ops.sentinel import SENTINEL

    from jax_native_build import build_jax_native, use_jax_native

    lib_dir = cli_inputs["jax_lib"]
    lib = getattr(test_cli_records_equal_jax_under_route, "_lib", None)
    if lib is None:
        lib = build_jax_native(lib_dir)
        test_cli_records_equal_jax_under_route._lib = lib
    use_jax_native(monkeypatch, lib)
    monkeypatch.setattr(jax_nb, "available", lambda: True)
    for k, v in ROUTE_ENVS[route].items():
        monkeypatch.setenv(k, v)
    SENTINEL.reset()
    flags = [] if command == "simplex" else ["--min-reads", "1"]
    recs, rcs = {}, {}
    for name, main, extra in (("jax", jax_cli.main, []),
                              ("port", port_cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.bam")
        rcs[name] = main([command, "-i", cli_inputs[command], "-o", out,
                          *flags, *extra])
        with BamReader(out) as r:
            recs[name] = [rec.data for rec in r]
    assert rcs == {"jax": 0, "port": 0}
    assert recs["port"] and recs["port"] == recs["jax"]
    snap = SENTINEL.snapshot()
    assert snap["divergent"] == 0
    if route == "audit_all" and command != "codec":
        assert snap["sampled"] > 0
    SENTINEL.reset()
