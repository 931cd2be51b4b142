"""The port's resource governor (``fgumi_tpu_torch.utils.governor``).

The ``DynamicBudget`` and ``ResourceGovernor`` cases of
``tests/test_governor.py`` that need neither serve nor fault injection, on
the port's classes: accounting and the one item always admitted, damping,
hysteresis, floor and ceiling, the watchdog's widen, the resize hook,
demand rebalancing (hot queues grow, cold ones give under a tight cap, a
budget without a demand signal stays), RSS and disk watermarks, a hard
state failing a blocked producer, the merge prefetch turned off under
pressure and ``reraise_enospc``. No test runs the governor's thread: each
drives ``GOVERNOR.sample_once()`` with injected RSS and disk samplers
(``FGUMI_TPU_GOVERNOR=0`` keeps the commands from starting it).

End to end, against the JAX package's CLI where it has the same contract:
a hard disk watermark ends ``sort`` (on its spill directory) and
``pipeline`` (fused and staged, on its output directory) with exit 4, one
error line and no output or temporary file left; a full disk during a BGZF
write or a sort spill does the same; and under aggressive rebalancing (tiny
channel budgets, a tick on every channel put, budget wait and BGZF piece
read, the RSS sampler flipping soft pressure on and off) the fused and
staged pipelines write the records of ``fgumi_tpu pipeline``, as they do
with ``FGUMI_TPU_GOVERNOR=0``.
"""

import errno
import logging
import os
import threading
import time

import pytest

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
import fgumi_tpu_torch.utils.atomic as port_atomic
import fgumi_tpu_torch.io.bgzf as BG
import fgumi_tpu_torch.io.batch_reader as BR
import fgumi_tpu_torch.utils.memory as port_memory
import fgumi_tpu_torch.sort.external as X
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.io.bam import BamReader
from fgumi_tpu_torch import pipeline as pipeline_mod
from fgumi_tpu_torch import pipeline_chain as PC
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.pipeline import run_stages
from fgumi_tpu_torch.utils import governor as G
from fgumi_tpu_torch.utils.governor import (GOVERNOR, DynamicBudget,
                                            ResourceExhausted,
                                            ResourceGovernor, StopSignal,
                                            merge_prefetch_bytes,
                                            reraise_enospc)

ENV = ("FGUMI_TPU_GOVERNOR", "FGUMI_TPU_MEM_BUDGET", "FGUMI_TPU_RSS_SOFT",
       "FGUMI_TPU_RSS_HARD", "FGUMI_TPU_DISK_SOFT", "FGUMI_TPU_DISK_HARD",
       "FGUMI_TPU_MERGE_PREFETCH", "FGUMI_TPU_CHAIN_BYTES",
       "FGUMI_TPU_GOVERNOR_PERIOD_S")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ENV:
        monkeypatch.delenv(var, raising=False)
    # the commands run here never start the sampling thread
    monkeypatch.setenv("FGUMI_TPU_GOVERNOR", "0")
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)
    GOVERNOR.reset_for_tests()
    yield
    GOVERNOR.reset_for_tests()


# ------------------------------------------------------------ DynamicBudget


def test_budget_accounting_and_oversized_admission():
    b = DynamicBudget("t", 100, damp_s=0.0)
    assert b.acquire(60)
    assert b.acquire(40)  # exactly at the limit
    b.release(100)
    assert b.acquire(10_000)  # one item always admits
    assert b.used == 10_000 and b.peak == 10_000
    b.release(10_000)
    assert b.used == 0


def test_budget_disabled_when_limit_nonpositive():
    b = DynamicBudget("t", 0)
    assert b.acquire(1 << 40)
    b.release(1 << 40)
    assert b.used == 0
    b.grow(1 << 20)
    assert b.limit == 0  # a disabled budget never resizes into existence


def test_budget_blocks_then_releases():
    b = DynamicBudget("t", 100, damp_s=0.0)
    assert b.acquire(100)
    got = []
    t = threading.Thread(target=lambda: got.append(b.acquire(50)))
    t.start()
    time.sleep(0.05)
    assert not got
    b.release(100)
    t.join(timeout=5)
    assert not t.is_alive() and got == [True]
    b.release(50)


def test_stop_signal_wakes_acquire_immediately():
    b = DynamicBudget("t", 100, damp_s=0.0)
    assert b.acquire(100)
    stop = StopSignal()
    out = []
    t = threading.Thread(target=lambda: out.append(b.acquire(50, stop=stop)))
    t.start()
    time.sleep(0.05)
    assert not out
    t0 = time.monotonic()
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive() and out == [False]
    assert time.monotonic() - t0 < 1.0
    stop.set()  # the subscription is gone: a second set is harmless
    b.release(100)


def test_budget_damping_one_resize_per_window():
    b = DynamicBudget("t", 100 << 20, damp_s=30.0)
    assert b.grow(10 << 20) == 10 << 20
    assert b.grow(10 << 20) == 0  # damped: inside the window
    assert b.limit == 110 << 20 and b.grows == 1


def test_budget_hysteresis_blocks_quick_direction_flip():
    b = DynamicBudget("t", 100 << 20, damp_s=0.05)
    assert b.grow(10 << 20) > 0
    time.sleep(0.08)  # past damp_s, inside the 4x window of a flip
    assert b.shrink(0.5) == 0
    assert b.flips == 0
    time.sleep(0.25)
    assert b.shrink(0.5) > 0
    assert b.flips == 1


def test_budget_floor_and_ceiling_clamp():
    b = DynamicBudget("t", 64 << 20, floor=16 << 20, ceiling=128 << 20,
                      damp_s=0.0)
    for _ in range(10):
        b.shrink(0.1)
    assert b.limit == 16 << 20
    for _ in range(10):
        b.grow(1 << 30)
    assert b.limit == 128 << 20


def test_widen_bypasses_damping_and_raises_ceiling():
    b = DynamicBudget("t", 64 << 20, ceiling=100 << 20, damp_s=60.0)
    assert b.grow(1 << 20) > 0  # takes the damping window
    b.widen(2)  # the watchdog's path: undamped
    assert b.limit == (65 << 20) * 2
    assert b.ceiling == (65 << 20) * 2
    assert b.snapshot()["widenings"] == 1


def test_on_resize_hook_fires_and_survives_exceptions():
    b = DynamicBudget("t", 64 << 20, damp_s=0.0)
    calls = []
    b.on_resize = lambda: calls.append(1)
    b.grow(1 << 20)
    assert calls == [1]
    b.on_resize = lambda: 1 / 0
    b.grow(1 << 20)
    assert b.grows == 2


# -------------------------------------------------------------- rebalancing


@pytest.fixture
def fresh_gov():
    """A private governor: no budget another test left registered."""
    g = ResourceGovernor()
    g._rss_fn = lambda: None
    g._disk_fn = lambda path: None
    return g


def test_rebalance_moves_budget_to_hot_queue(monkeypatch, fresh_gov):
    monkeypatch.setenv("FGUMI_TPU_MEM_BUDGET", "1G")
    hot = DynamicBudget("hot", 32 << 20, damp_s=0.0)
    cold = DynamicBudget("cold", 32 << 20, damp_s=0.0)
    waits = {"hot": 0.0}
    fresh_gov.register_budget(
        hot, demand_fn=lambda: {"put_wait_s": waits["hot"],
                                "get_wait_s": 0.0})
    fresh_gov.register_budget(
        cold, demand_fn=lambda: {"put_wait_s": 0.0, "get_wait_s": 0.5})
    for _ in range(4):
        waits["hot"] += 0.1
        fresh_gov.sample_once()
    assert hot.limit > 32 << 20
    assert fresh_gov.rebalances >= 1
    assert cold.limit == 32 << 20  # a roomy cap: no donor shrinks
    assert hot.flips == 0


def test_rebalance_steals_from_cold_under_tight_cap(monkeypatch, fresh_gov):
    monkeypatch.setenv("FGUMI_TPU_MEM_BUDGET", "64M")
    hot = DynamicBudget("hot", 32 << 20, damp_s=0.0)
    cold = DynamicBudget("cold", 32 << 20, floor=8 << 20, damp_s=0.0)
    waits = {"hot": 0.0}
    fresh_gov.register_budget(
        hot, demand_fn=lambda: {"put_wait_s": waits["hot"],
                                "get_wait_s": 0.0})
    fresh_gov.register_budget(
        cold, demand_fn=lambda: {"put_wait_s": 0.0, "get_wait_s": 0.0})
    for _ in range(4):
        waits["hot"] += 0.1
        fresh_gov.sample_once()
    assert hot.limit > 32 << 20
    assert cold.floor <= cold.limit < 32 << 20
    assert hot.limit + cold.limit <= 64 << 20


def test_rebalance_ignores_budgets_without_demand_fn(monkeypatch,
                                                     fresh_gov):
    monkeypatch.setenv("FGUMI_TPU_MEM_BUDGET", "1G")
    b = DynamicBudget("mute", 32 << 20, damp_s=0.0)
    fresh_gov.register_budget(b)
    for _ in range(3):
        fresh_gov.sample_once()
    assert b.limit == 32 << 20
    assert fresh_gov.rebalances == 0


def test_skewed_two_stage_pipeline_wait_drops_vs_static(monkeypatch,
                                                        fresh_gov):
    """A fast producer against a slow consumer through a budget: governed
    (ticks driven here), the budget grows toward the contended side and the
    producer waits less than with the static budget, with no flip."""
    monkeypatch.setenv("FGUMI_TPU_MEM_BUDGET", "1G")
    blob = 64 << 10
    n_items = 80

    def scenario(governed: bool) -> float:
        budget = DynamicBudget("stage", 4 * blob, ceiling=n_items * blob,
                               damp_s=0.0)
        tok = fresh_gov.register_budget(
            budget, demand_fn=lambda: {"put_wait_s": budget.wait_s,
                                       "get_wait_s": 0.0}) \
            if governed else None
        stop = StopSignal()
        q = []
        cv = threading.Condition()

        def producer():
            for _ in range(n_items):
                budget.acquire(blob, stop=stop)
                with cv:
                    q.append(blob)
                    cv.notify()

        def consumer():
            for _ in range(n_items):
                with cv:
                    while not q:
                        cv.wait(1.0)
                    n = q.pop(0)
                time.sleep(0.002)
                budget.release(n)

        threads = [threading.Thread(target=producer),
                   threading.Thread(target=consumer)]
        for t in threads:
            t.start()
        try:
            while any(t.is_alive() for t in threads):
                if governed:
                    fresh_gov.sample_once()
                time.sleep(0.05)
        finally:
            for t in threads:
                t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        fresh_gov.unregister_budget(tok)
        assert budget.flips == 0
        if governed:
            assert budget.limit > 4 * blob
        return budget.wait_s

    static_wait = scenario(governed=False)
    governed_wait = scenario(governed=True)
    assert governed_wait < static_wait
    assert static_wait > 0.01


# ---------------------------------------------------------------- sentinels


def test_rss_watermarks_soft_then_hard(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_RSS_SOFT", "100M")
    monkeypatch.setenv("FGUMI_TPU_RSS_HARD", "200M")
    rss = {"v": 50 << 20}
    GOVERNOR._rss_fn = lambda: rss["v"]
    b = DynamicBudget("x", 64 << 20, floor=8 << 20, damp_s=0.0)
    tok = GOVERNOR.register_budget(b)
    try:
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "ok"
        rss["v"] = 150 << 20
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "soft" and GOVERNOR.soft_pressure()
        assert b.limit < 64 << 20  # degradation: budgets shrink
        rss["v"] = 250 << 20
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "hard"
        with pytest.raises(ResourceExhausted) as err:
            GOVERNOR.check_hard()
        assert err.value.kind == "hard_watermark" and "rss" in str(err.value)
        rss["v"] = 50 << 20
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "ok" and not GOVERNOR.soft_pressure()
        snap = GOVERNOR.snapshot()
        assert [ev["kind"] for ev in snap["events"]] == [
            "pressure_soft", "pressure_hard", "pressure_ok"]
        assert snap["rss_peak_bytes"] == 250 << 20
        assert snap["budgets"]["x"]["shrinks"] >= 1
    finally:
        GOVERNOR.unregister_budget(tok)


def test_disk_watermarks_via_watch_path(tmp_path):
    free = {"v": 10 << 30}
    GOVERNOR._rss_fn = lambda: None
    GOVERNOR._disk_fn = lambda path: free["v"]
    tok = GOVERNOR.watch_path("spill", str(tmp_path))
    try:
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "ok"
        free["v"] = 256 << 20  # under the 512 MiB soft default
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "soft"
        free["v"] = 32 << 20  # under the 64 MiB hard default
        GOVERNOR.sample_once()
        assert GOVERNOR.state == "hard"
        assert "spill" in GOVERNOR.hard_reason
        assert GOVERNOR.snapshot()["disk_free_min_bytes"] == 32 << 20
    finally:
        GOVERNOR.unwatch_path(tok)
    GOVERNOR.sample_once()  # nothing watched: the pressure clears
    assert GOVERNOR.state == "ok"


def test_hard_pressure_fails_blocked_acquire(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_RSS_HARD", "100M")
    GOVERNOR._rss_fn = lambda: 200 << 20
    GOVERNOR.sample_once()
    assert GOVERNOR.state == "hard"
    b = DynamicBudget("x", 100, damp_s=0.0)
    assert b.acquire(100)
    with pytest.raises(ResourceExhausted):
        b.acquire(50)  # the producer that must wait is the one to stop
    b.release(100)


def test_merge_prefetch_forced_off_under_pressure(monkeypatch):
    assert merge_prefetch_bytes() == 64 << 20
    monkeypatch.setenv("FGUMI_TPU_MERGE_PREFETCH", "16M")
    assert merge_prefetch_bytes() == 16 << 20
    GOVERNOR.state = "soft"
    assert merge_prefetch_bytes() == 0
    GOVERNOR.state = "ok"
    monkeypatch.setenv("FGUMI_TPU_MERGE_PREFETCH", "0")
    assert merge_prefetch_bytes() == 0


def test_reraise_enospc_converts_only_enospc(tmp_path):
    other = OSError(errno.EIO, "io error")
    assert reraise_enospc(other, "sort.spill") is None
    assert reraise_enospc(ValueError("x"), "sort.spill") is None
    full = OSError(errno.ENOSPC, "No space left on device")
    with pytest.raises(ResourceExhausted) as err:
        reraise_enospc(full, "sort.spill", path=str(tmp_path))
    assert err.value.kind == "enospc"
    assert err.value.__cause__ is full
    ev = GOVERNOR.snapshot()["events"][-1]
    assert ev["kind"] == "enospc" and ev["where"] == "sort.spill"
    assert ev["free_bytes"] > 0


def test_maybe_start_honours_the_switch(monkeypatch):
    GOVERNOR.maybe_start()  # FGUMI_TPU_GOVERNOR=0 here
    assert GOVERNOR._thread is None
    monkeypatch.setenv("FGUMI_TPU_GOVERNOR_PERIOD_S", "30")
    monkeypatch.delenv("FGUMI_TPU_GOVERNOR")
    GOVERNOR.maybe_start()
    try:
        assert GOVERNOR._thread.is_alive()
        GOVERNOR.maybe_start()  # idempotent
    finally:
        GOVERNOR.stop()
    assert GOVERNOR._thread is None


# -------------------------------------------------- registrations in the port


def test_channel_governs_its_default_budget(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_CHAIN_BYTES", "8192")
    ch = PC.ChainChannel("t")
    assert ch.max_bytes == 8192
    assert ch._gov_token in GOVERNOR._entries
    static = PC.ChainChannel("s", max_bytes=100)
    assert static._gov_token is None
    ch.put(b"x" * 10)
    ch.close()
    assert ch._gov_token is None  # closed: no longer competing for the cap
    assert ch.get() == b"x" * 10 and ch.get() is None


def test_channel_put_fails_under_hard_pressure(monkeypatch):
    monkeypatch.setenv("FGUMI_TPU_RSS_HARD", "1M")
    ch = PC.ChainChannel("t", max_bytes=1 << 20)
    ch.put(b"a")
    GOVERNOR._rss_fn = lambda: 2 << 20
    GOVERNOR.sample_once()
    with pytest.raises(ResourceExhausted):
        ch.put(b"b")
    ch.cancel()


def test_run_stages_registers_its_input_budget():
    seen = []

    def process(i):
        seen.append(set(GOVERNOR.snapshot()["budgets"]))
        return [i]

    out = []
    run_stages(iter(range(5)), process, out.append, threads=2,
               queue_items=2, watchdog_interval=0, max_bytes=1 << 20,
               item_bytes=lambda i: 100)
    assert out == list(range(5))
    assert all("pipeline.input" in s for s in seen)
    assert "pipeline.input" not in GOVERNOR.snapshot()["budgets"]


# ------------------------------------------------------------ end to end

OPTS = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_governor")
    r1, r2 = str(d / "r1.fq.gz"), str(d / "r2.fq.gz")
    assert port_main(["simulate", "fastq-reads", "-1", r1, "-2", r2,
                      "--num-families", "60", "--family-size", "4",
                      "--read-length", "60", "--seed", "29"]) == 0
    bam = str(d / "g.bam")
    assert port_main(["simulate", "grouped-reads", "-o", bam,
                      "--num-families", "150", "--family-size", "4",
                      "--seed", "13"]) == 0
    return {"fastq": (r1, r2), "grouped": bam}


def _errors(caplog):
    return [r for r in caplog.records if r.levelno >= logging.ERROR
            and r.name == "fgumi_tpu_torch"]


def _hard_on_watch(monkeypatch):
    """Every watched path reports 1 MiB free, and registering a watch runs
    one governor tick: the hard disk watermark trips where a command
    starts watching its disk."""
    GOVERNOR._rss_fn = lambda: None
    GOVERNOR._disk_fn = lambda path: 1 << 20
    real = GOVERNOR.watch_path

    def watch_then_sample(label, path):
        token = real(label, path)
        GOVERNOR.sample_once()
        return token

    monkeypatch.setattr(GOVERNOR, "watch_path", watch_then_sample)


@pytest.mark.parametrize("threads", ["1", "3"])
def test_sort_hard_disk_watermark_exits_4(inputs, tmp_path, monkeypatch,
                                          caplog, threads):
    _hard_on_watch(monkeypatch)
    spill = tmp_path / "spill"
    spill.mkdir()
    out = tmp_path / "out.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        rc = port_main(["sort", "-i", inputs["grouped"], "-o", str(out),
                        "--order", "coordinate", "--max-records-in-ram",
                        "50", "--tmp-dir", str(spill), "--threads", threads])
    assert rc == 4
    errors = _errors(caplog)
    assert len(errors) == 1 and "hard watermark" in errors[0].getMessage()
    assert errors[0].exc_info is None
    assert not out.exists() and list(spill.iterdir()) == []
    assert os.listdir(tmp_path) == ["spill"]


@pytest.mark.parametrize("mode", [[], ["--no-fuse"]], ids=["fused", "staged"])
def test_pipeline_hard_disk_watermark_exits_4(inputs, tmp_path, monkeypatch,
                                              caplog, mode):
    _hard_on_watch(monkeypatch)
    out = tmp_path / "out.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        rc = port_main(["pipeline", "-i", *inputs["fastq"], *OPTS, "-o",
                        str(out), "--device", "cpu", *mode])
    assert rc == 4
    errors = _errors(caplog)
    assert len(errors) == 1 and "output" in errors[0].getMessage()
    assert os.listdir(tmp_path) == []  # no output, no intermediates


class _FullDiskFile:
    """A file that takes ``room`` bytes, then fails with ENOSPC."""

    def __init__(self, path, mode="wb", room: int = 50_000):
        self.name = path
        self._f = open(path, mode)
        self._room = room
        self.data = bytearray()

    def write(self, data):
        if len(self.data) + len(data) > self._room:
            raise OSError(errno.ENOSPC, "No space left on device", self.name)
        self.data += data
        return self._f.write(data)

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def test_bgzf_writer_enospc_marks_the_stream_broken(tmp_path):
    f = _FullDiskFile(str(tmp_path / "x.bgz"), room=30_000)
    w = BG.BgzfWriter(f, owns_fileobj=True)
    with pytest.raises(ResourceExhausted) as err:
        w.write(os.urandom(200_000))
    assert err.value.kind == "enospc"
    w.close()  # broken: discarded, no EOF block
    assert w.closed and not f.data.endswith(BG.BGZF_EOF)


def test_bgzf_write_enospc_exits_4(inputs, tmp_path, monkeypatch, caplog):
    # BAM outputs open their (temporary) file in utils/atomic.py
    monkeypatch.setattr(port_atomic, "open",
                        lambda p, mode="rb": _FullDiskFile(p, mode)
                        if "w" in mode else open(p, mode), raising=False)
    out = tmp_path / "out.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        rc = port_main(["simplex", "-i", inputs["grouped"], "-o", str(out),
                        "--device", "cpu", "--min-reads", "1",
                        "--compression-level", "0"])
    assert rc == 4
    errors = _errors(caplog)
    assert len(errors) == 1 and "disk full" in errors[0].getMessage()
    assert not out.exists()


class _SpillFullLib:
    """The native library, but every spill run write fails with ENOSPC."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def fgumi_write_run(self, *args):
        return -errno.ENOSPC


@pytest.mark.parametrize("threads", ["1", "3"])
def test_sort_spill_enospc_exits_4(inputs, tmp_path, monkeypatch, caplog,
                                   threads):
    real = X.get_lib
    monkeypatch.setattr(X, "get_lib", lambda: _SpillFullLib(real()))
    spill = tmp_path / "spill"
    spill.mkdir()
    out = tmp_path / "out.bam"
    with caplog.at_level(logging.ERROR, logger="fgumi_tpu_torch"):
        rc = port_main(["sort", "-i", inputs["grouped"], "-o", str(out),
                        "--max-records-in-ram", "50", "--tmp-dir",
                        str(spill), "--threads", threads])
    assert rc == 4
    errors = _errors(caplog)
    assert len(errors) == 1 and "disk full during sort.spill" \
        in errors[0].getMessage()
    assert not out.exists() and list(spill.iterdir()) == []
    assert any(ev["kind"] == "enospc"
               for ev in GOVERNOR.snapshot()["events"])


_JAX_PIPELINE = {}


def _jax_pipeline(inputs, tmp_path_factory):
    if "records" not in _JAX_PIPELINE:
        out = str(tmp_path_factory.mktemp("gov_jax") / "jax.bam")
        assert jax_main(["pipeline", "-i", *inputs["fastq"], *OPTS, "-o",
                         out, "--filter-min-reads", "1"]) == 0
        with BamReader(out) as r:
            _JAX_PIPELINE["records"] = [rec.data for rec in r]
    return _JAX_PIPELINE["records"]


def _port_pipeline(inputs, out, mode):
    """Two threads a stage and a small input budget on each stage runner
    (``--memory-per-thread``, the 64 MiB floor of a budget patched off),
    so the staged chain's stages acquire their input budget too."""
    assert port_main(["pipeline", "-i", *inputs["fastq"], *OPTS, "-o",
                      str(out), "--device", "cpu", "--filter-min-reads", "1",
                      "--threads", "2", "--memory-per-thread", "1M",
                      *mode]) == 0
    with BamReader(str(out)) as r:
        return [rec.data for rec in r]


def _aggressive(monkeypatch):
    """Tiny channel budgets, a tick on every channel put, budget wait and
    BGZF piece read, and an RSS sampler that turns soft pressure on and off at every
    other tick: budgets grow, shrink and flip while the run moves."""
    monkeypatch.setenv("FGUMI_TPU_CHAIN_BYTES", "8192")
    monkeypatch.setenv("FGUMI_TPU_GOVERNOR_PERIOD_S", "0.05")
    monkeypatch.setenv("FGUMI_TPU_RSS_SOFT", "1M")
    monkeypatch.setenv("FGUMI_TPU_RSS_HARD", "1T")
    flip = {"n": 0}

    def rss():
        flip["n"] += 1
        return (2 << 20) if flip["n"] % 4 < 2 else (512 << 10)

    GOVERNOR._rss_fn = rss
    GOVERNOR._disk_fn = lambda path: None
    lock = threading.Lock()

    def tick():
        with lock:
            GOVERNOR.sample_once()

    put, acquire = PC.ChainChannel.put, DynamicBudget.acquire
    read = BG.BgzfReader.read_decoded

    def ticking_put(self, blob):
        tick()
        return put(self, blob)

    def ticking_acquire(self, n, stop=None):
        tick()
        return acquire(self, n, stop)

    def ticking_read(self):
        tick()
        return read(self)

    monkeypatch.setattr(PC.ChainChannel, "put", ticking_put)
    monkeypatch.setattr(DynamicBudget, "acquire", ticking_acquire)
    monkeypatch.setattr(BG.BgzfReader, "read_decoded", ticking_read)


@pytest.mark.parametrize("mode", [[], ["--no-fuse"]], ids=["fused", "staged"])
def test_governed_pipeline_records_equal_jax_and_ungoverned(
        inputs, tmp_path, tmp_path_factory, monkeypatch, mode):
    want = _jax_pipeline(inputs, tmp_path_factory)
    assert want
    # record batches of ~4 KiB: many items through every budget
    monkeypatch.setattr(port_memory, "_FLOOR", 1 << 10)
    monkeypatch.setattr(BR.BamBatchReader.__init__, "__defaults__", (4096,))
    with monkeypatch.context() as m:
        _aggressive(m)
        governed = _port_pipeline(inputs, tmp_path / "gov.bam", mode)
        kinds = {ev["kind"] for ev in GOVERNOR.snapshot()["events"]}
        assert GOVERNOR.samples > 5 and "pressure_soft" in kinds
    GOVERNOR.reset_for_tests()
    ungoverned = _port_pipeline(inputs, tmp_path / "static.bam", mode)
    assert GOVERNOR.samples == 0  # FGUMI_TPU_GOVERNOR=0: static budgets
    assert governed == ungoverned == want


def test_input_budget_never_grows_past_max_bytes(fresh_gov, monkeypatch):
    """The stage runner's input budget is the user's cap (half of
    ``--max-memory``): the governor may shrink it under pressure and
    give it back, never grow it past the cap."""
    monkeypatch.setenv("FGUMI_TPU_MEM_BUDGET", "1G")
    monkeypatch.setattr(G, "GOVERNOR", fresh_gov)
    monkeypatch.setattr(pipeline_mod, "GOVERNOR", fresh_gov)
    limits = []

    def process(i):
        time.sleep(0.01)
        for _ in range(3):  # the reader waits on the budget: hot
            fresh_gov.sample_once()
        limits.append(fresh_gov.snapshot()["budgets"]["pipeline.input"])
        return [i]

    out = []
    run_stages(iter(range(20)), process, out.append, threads=2,
               queue_items=8, watchdog_interval=0, max_bytes=2000,
               item_bytes=lambda i: 1000)
    assert out == list(range(20))
    assert limits and all(b["limit"] <= 2000 and b["ceiling"] == 2000
                          for b in limits)
    assert max(b["peak"] for b in limits) <= 2000
