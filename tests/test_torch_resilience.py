"""Device resilience of the port (``ops/kernel.py``): the bounded retry, the
out-of-memory batch halving and the exits that replace the JAX package's
host-engine fallback, on ``--device cpu``.

The chaos cases of ``tests/test_faults.py`` (``device.dispatch`` faults on
``simplex``), run in process through the port's CLI on a seeded longtail
input, inline and on the stage runner at ``--threads 3``:

- ``device.dispatch:raise:1.0:2`` (two failed attempts, then success) and
  ``device.dispatch:oom:1.0:1`` (the first dispatch halves) exit 0, log
  ``retry`` or ``halving``, count ``dispatch_retries`` or ``batch_splits``
  in ``--stats-json`` and write records equal to the JAX CLI's clean run;
- an unbounded ``raise`` and an unbounded ``oom`` exit 3 with one error
  line and publish nothing. Here the port departs from the JAX package on
  purpose: the reference finishes such a batch on its host engine and
  exits 0; the port has no host engine behind the device.

The other dispatch routes take the same faults with records equal to their
own clean runs: ``simplex --device-filter`` (K1-f, whose halves come back
as full columns through K1), ``duplex`` (K1-r: a split batch joins its
halves' resident arrays, and its strand combine runs on K5 as the clean
run's does), ``codec`` and an input of more than 63 distinct quals (the
packed2 route). A ``torch.cuda.OutOfMemoryError`` raised by a stubbed
kernel halves the batch at resolve time with columns equal to the unsplit
ones; one that cannot split exits 4 with one ``device memory exhausted``
line; a CUDA error exits 1 with one line naming the dispatch and its
attempts, or the fetch where it surfaced; none publishes anything.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from fgumi_tpu.cli import main as jax_main
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.ops import cuda_kernel
from fgumi_tpu_torch.ops import kernel as K
from fgumi_tpu_torch.ops.tables import quality_tables
from fgumi_tpu_torch.utils import faults

LOGGER = "fgumi_tpu_torch"


@pytest.fixture(autouse=True)
def clean_faults(monkeypatch):
    monkeypatch.delenv("FGUMI_TPU_FAULT", raising=False)
    monkeypatch.setenv("FGUMI_TPU_DEVICE_BACKOFF_S", "0.001")
    faults.reset()
    yield
    faults.reset()


def _records(path):
    with BamReader(str(path)) as r:
        return [rec.data for rec in r]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_resilience")
    p = {k: str(d / f"{k}.bam") for k in ("longtail", "duplex", "codec",
                                          "quals", "mapped")}
    for argv in (
            ["simulate", "grouped-reads", "-o", p["longtail"],
             "--num-families", "300", "--family-size-distribution",
             "longtail", "--read-length", "60", "--error-rate", "0.02",
             "--seed", "13"],
            ["simulate", "duplex-reads", "-o", p["duplex"],
             "--num-molecules", "150", "--reads-per-strand", "3",
             "--read-length", "60", "--seed", "4"],
            ["simulate", "codec-reads", "-o", p["codec"], "--num-molecules",
             "150", "--pairs-per-molecule", "2", "--read-length", "60",
             "--seed", "9"],
            ["simulate", "grouped-reads", "-o", p["quals"],
             "--num-families", "150", "--family-size", "5",
             "--base-quality", "40", "--qual-slope", "0.3",
             "--insert-size-mean", "150", "--insert-size-sd", "30",
             "--seed", "44"],
            ["simulate", "mapped-reads", "-o", p["mapped"],
             "--num-families", "40", "--family-size", "4", "--seed", "11"]):
        assert port_main(argv) == 0
    clean = str(d / "jax_clean.bam")
    assert jax_main(["simplex", "-i", p["longtail"], "-o", clean,
                     "--min-reads", "1"]) == 0
    p["jax_clean"] = _records(clean)
    return p


def _run(tmp_path, name, argv, monkeypatch, spec=None, caplog=None):
    """One in-process port run in its own directory: (exit code, stats
    dict or None, the directory's files, the error messages)."""
    d = tmp_path / name
    d.mkdir()
    if spec is None:
        monkeypatch.delenv("FGUMI_TPU_FAULT", raising=False)
    else:
        monkeypatch.setenv("FGUMI_TPU_FAULT", spec)
    faults.reset()
    stats = str(tmp_path / f"{name}.json")
    if caplog is not None:
        caplog.clear()
    rc = port_main([*argv, "-o", str(d / "out.bam"), "--device", "cpu",
                    "--stats-json", stats])
    errors = [r.getMessage() for r in (caplog.records if caplog else [])
              if r.levelno >= logging.ERROR]
    st = json.load(open(stats)) if rc == 0 else None
    return rc, st, sorted(os.listdir(d)), errors


SIMPLEX = ["simplex", "--min-reads", "1"]


@pytest.mark.parametrize("threads", [[], ["--threads", "3"]],
                         ids=["inline", "threads3"])
@pytest.mark.parametrize("spec,marker,counter", [
    ("device.dispatch:raise:1.0:2", "retry", "dispatch_retries"),
    ("device.dispatch:oom:1.0:1", "halving", "batch_splits")],
    ids=["retry", "oom_split"])
def test_dispatch_fault_recovered_identical(tmp_path, monkeypatch, caplog,
                                            inputs, spec, marker, counter,
                                            threads):
    argv = [*SIMPLEX, "-i", inputs["longtail"], *threads]
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, st, files, errors = _run(tmp_path, "faulty", argv, monkeypatch,
                                     spec, caplog)
    assert rc == 0 and errors == []
    assert any(marker in r.getMessage() for r in caplog.records)
    got = st["device_stats"] if threads else K.DEVICE_STATS.snapshot()
    if counter == "dispatch_retries":
        assert got[counter] == 2
    else:
        assert got[counter] >= 1
    assert _records(tmp_path / "faulty" / "out.bam") == inputs["jax_clean"]


@pytest.mark.parametrize("threads", [[], ["--threads", "3"]],
                         ids=["inline", "threads3"])
@pytest.mark.parametrize("spec", ["device.dispatch:raise:1.0",
                                  "device.dispatch:oom:1.0"],
                         ids=["raise", "oom"])
def test_unbounded_dispatch_fault_exits_3(tmp_path, monkeypatch, caplog,
                                          inputs, spec, threads):
    """The departure from the JAX package (whose host engine finishes the
    batch and exits 0): exit 3, one error line, nothing published."""
    argv = [*SIMPLEX, "-i", inputs["longtail"], *threads]
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, _, files, errors = _run(tmp_path, "faulty", argv, monkeypatch,
                                    spec, caplog)
    assert rc == 3
    assert files == []
    assert len(errors) == 1 and "injected" in errors[0]


def test_split_depth_bounded(tmp_path, monkeypatch, caplog, inputs):
    """FGUMI_TPU_MAX_SPLITS=0: an out-of-memory cannot halve, exit 3."""
    monkeypatch.setenv("FGUMI_TPU_MAX_SPLITS", "0")
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, _, files, errors = _run(
            tmp_path, "faulty", [*SIMPLEX, "-i", inputs["longtail"]],
            monkeypatch, "device.dispatch:oom:1.0:1", caplog)
    assert rc == 3 and files == [] and len(errors) == 1
    assert not any("halving" in r.getMessage() for r in caplog.records)


ROUTES = {
    "device_filter": [*SIMPLEX, "--device-filter", "--filter-min-reads", "3",
                      "--filter-min-mean-base-quality", "30",
                      "--filter-min-base-quality", "20"],
    "duplex": ["duplex"],
    "codec": ["codec", "--min-reads", "1"],
    "packed2": ["simplex"],
}
ROUTE_INPUT = {"device_filter": "longtail", "duplex": "duplex",
               "codec": "codec", "packed2": "quals"}


@pytest.mark.parametrize("spec", ["device.dispatch:raise:1.0:2",
                                  "device.dispatch:oom:1.0:1"],
                         ids=["retry", "oom_split"])
@pytest.mark.parametrize("route", sorted(ROUTES))
def test_route_fault_recovered_identical(tmp_path, monkeypatch, caplog,
                                         inputs, route, spec):
    argv = [*ROUTES[route], "-i", inputs[ROUTE_INPUT[route]]]
    rc, clean, _, _ = _run(tmp_path, "clean", argv, monkeypatch)
    assert rc == 0
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, st, _, errors = _run(tmp_path, "faulty", argv, monkeypatch, spec,
                                 caplog)
    assert rc == 0 and errors == []
    want = _records(tmp_path / "clean" / "out.bam")
    assert want and _records(tmp_path / "faulty" / "out.bam") == want
    marker = "retry" if "raise" in spec else "halving"
    assert any(marker in r.getMessage() for r in caplog.records)
    if route == "duplex" and "oom" in spec:
        # the split K1-r batch joined its halves' resident arrays: its
        # strand combine ran on K5 as the clean run's did
        assert K.DEVICE_STATS.snapshot()["batch_splits"] >= 1
        assert st["combine_device_rows"] == clean["combine_device_rows"] > 0
        assert st["combine_host_rows"] == clean["combine_host_rows"]
        assert st["launches"]["duplex_combine"] == \
            clean["launches"]["duplex_combine"]
        assert K.LIVE_RESIDENTS == 0
    if route == "device_filter" and "oom" in spec:
        assert st["packed2_columns_batches"] == 0


def _batch(n_fam=40, fam=4, L=48, seed=3):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    return codes, quals, np.arange(n_fam + 1, dtype=np.int64) * fam


def _stub_full(monkeypatch, fail):
    """K1's wrapper raising ``fail(call index)`` (or running) per call."""
    real = cuda_kernel.consensus_wire_full
    calls = []

    def stub(*args):
        calls.append(len(calls))
        exc = fail(len(calls) - 1)
        if exc is not None:
            raise exc
        return real(*args)

    monkeypatch.setattr(cuda_kernel, "consensus_wire_full", stub)
    return calls


def test_real_oom_halves_with_equal_columns(monkeypatch):
    """A ``torch.cuda.OutOfMemoryError`` from the dispatch is kept in the
    handle; the resolve halves the batch, re-dispatches both halves and
    concatenates columns equal to the unsplit dispatch's."""
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    want = kern.resolve_segments_wire(
        kern.device_call_segments_wire(codes, quals, starts), codes, quals,
        starts)
    calls = _stub_full(monkeypatch, lambda i: torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 MiB") if i == 0
        else None)
    K.DEVICE_STATS.reset()
    handle = kern.device_call_segments_wire(codes, quals, starts)
    assert handle.failure is not None and K.DEVICE_STATS.in_flight == 0
    got = kern.resolve_segments_wire(handle, codes, quals, starts)
    assert len(calls) == 3
    assert K.DEVICE_STATS.snapshot()["batch_splits"] == 1
    assert K.DEVICE_STATS.in_flight == 0
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_failed_dispatch_frees_its_tensors(monkeypatch):
    """The handle keeps the out-of-memory without its traceback, so the
    tensors the failed attempt allocated are freed before the halves
    allocate theirs."""
    import weakref

    held = []

    def stub(*args):
        partial = torch.empty(1024)
        held.append(weakref.ref(partial))
        raise torch.cuda.OutOfMemoryError("CUDA out of memory.")

    monkeypatch.setattr(cuda_kernel, "consensus_wire_full", stub)
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    handle = kern.device_call_segments_wire(codes, quals, starts)
    assert handle.failure is not None
    assert handle.failure.__traceback__ is None
    assert held and held[0]() is None


def test_split_resident_batch_joins_halves(monkeypatch):
    """An out-of-memory of a K1-r dispatch: the halves' resident arrays
    and suspect masks come back joined, equal to the unsplit dispatch's,
    in one handle (the halves' handles released)."""
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch()
    *want, want_x = kern.resolve_segments_wire(
        kern.device_call_segments_wire(codes, quals, starts,
                                       resident_thresholds=(2, 10)),
        codes, quals, starts, want_extras=True)
    real = cuda_kernel.consensus_wire_resident
    calls = []

    def stub(*args):
        calls.append(1)
        if len(calls) == 1:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory.")
        return real(*args)

    monkeypatch.setattr(cuda_kernel, "consensus_wire_resident", stub)
    live = K.LIVE_RESIDENTS
    *got, got_x = kern.resolve_segments_wire(
        kern.device_call_segments_wire(codes, quals, starts,
                                       resident_thresholds=(2, 10)),
        codes, quals, starts, want_extras=True)
    assert len(calls) == 3
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got_x["suspect"], want_x["suspect"])
    for a, b in zip(got_x["resident"].arrays, want_x["resident"].arrays):
        assert torch.equal(a, b)
    # the joined handle is the only one the split left live
    assert K.LIVE_RESIDENTS == live + 1
    got_x["resident"].release()
    want_x["resident"].release()
    assert K.LIVE_RESIDENTS == live - 1


def test_real_oom_of_one_family_reraises(monkeypatch):
    kern = K.ConsensusKernel(quality_tables(45, 40), "cpu")
    codes, quals, starts = _batch(n_fam=1)
    _stub_full(monkeypatch, lambda i: torch.cuda.OutOfMemoryError("oom"))
    handle = kern.device_call_segments_wire(codes, quals, starts)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        kern.resolve_segments_wire(handle, codes, quals, starts)


@pytest.mark.parametrize("exc,rc,line", [
    (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 MiB\nmore detail"), 4,
     "device memory exhausted: CUDA out of memory. Tried to allocate "
     "20.00 MiB"),
    (torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered\nmore detail"),
     1, "device K1 dispatch failed on attempt 1 of 4: AcceleratorError: "
        "CUDA error: an illegal memory access was encountered")],
    ids=["oom", "cuda_error"])
def test_real_device_error_exits_one_line(tmp_path, monkeypatch, caplog,
                                          inputs, exc, rc, line):
    """A device failure no retry or split can absorb: the exit code of its
    class, one error line, nothing published."""
    calls = _stub_full(monkeypatch, lambda i: exc)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        got, _, files, errors = _run(
            tmp_path, "faulty", [*SIMPLEX, "-i", inputs["longtail"]],
            monkeypatch, None, caplog)
    assert got == rc
    assert files == []
    assert errors == [line]
    # a CUDA error is not retried; an out-of-memory halves to the limit
    assert len(calls) == (1 if rc == 1 else 2 ** 5 - 1)


class _FaultyFetch(torch.Tensor):
    """A result whose fetch raises the CUDA error of a kernel that faulted
    after its launch returned."""

    def cpu(self, *args, **kwargs):
        raise torch.AcceleratorError(
            "CUDA error: an illegal memory access was encountered\nmore")


def _faulty_results(monkeypatch, module, name):
    real = getattr(module, name)

    def stub(*args, **kwargs):
        return tuple(t.as_subclass(_FaultyFetch)
                     for t in real(*args, **kwargs))

    monkeypatch.setattr(module, name, stub)


@pytest.mark.parametrize("route,what", [("simplex", "K1"), ("duplex", "K5")])
def test_cuda_error_at_fetch_exits_one_line(tmp_path, monkeypatch, caplog,
                                            inputs, route, what):
    """A kernel's CUDA error that surfaces at the fetch of its results
    (a launch is asynchronous) exits 1 with one line naming the dispatch,
    and publishes nothing."""
    if route == "simplex":
        _faulty_results(monkeypatch, cuda_kernel, "consensus_wire_full")
        argv = [*SIMPLEX, "-i", inputs["longtail"]]
    else:
        _faulty_results(monkeypatch, K.C, "duplex_combine")
        argv = ["duplex", "-i", inputs["duplex"]]
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, _, files, errors = _run(tmp_path, "faulty", argv, monkeypatch,
                                    None, caplog)
    assert rc == 1
    assert files == []
    assert errors == [f"device {what} fetch failed: AcceleratorError: CUDA "
                      "error: an illegal memory access was encountered"]


def test_cuda_error_elsewhere_exits_one_line(tmp_path, monkeypatch, caplog,
                                             inputs):
    """A CUDA error outside the consensus kernels' dispatches and fetches
    (here in K4's distance call) exits 1 with one line."""
    from fgumi_tpu_torch.umi import assigners

    def fail(*args, **kwargs):
        raise torch.AcceleratorError("CUDA error: unspecified launch failure")

    # every position group takes the device function
    monkeypatch.setattr(assigners, "DEVICE_THRESHOLD", 1)
    monkeypatch.setattr(assigners, "umi_hamming", fail)
    with caplog.at_level(logging.WARNING, logger=LOGGER):
        rc, _, files, errors = _run(
            tmp_path, "faulty", ["group", "-i", inputs["mapped"],
                                 "-s", "adjacency"], monkeypatch, None,
            caplog)
    assert rc == 1
    assert files == []
    assert errors == ["device error: AcceleratorError: CUDA error: "
                      "unspecified launch failure"]


def test_retry_is_bounded_and_counted(monkeypatch):
    """The budget: FGUMI_TPU_DEVICE_RETRIES retries after the first
    attempt, each counted; ``device.wedge`` fires once a dispatch."""
    monkeypatch.setenv("FGUMI_TPU_DEVICE_RETRIES", "2")
    monkeypatch.setenv("FGUMI_TPU_FAULT", "device.dispatch:raise:1.0")
    faults.reset()
    K.DEVICE_STATS.reset()
    with pytest.raises(faults.InjectedFault):
        K.device_retry_call(lambda: 1, "K1")
    assert faults.snapshot()["device.dispatch"] == 3
    assert K.DEVICE_STATS.snapshot()["dispatch_retries"] == 2
    monkeypatch.setenv("FGUMI_TPU_FAULT",
                       "device.wedge:raise:1.0:1,device.dispatch:raise:1.0:1")
    faults.reset()
    with pytest.raises(faults.InjectedFault, match="device.wedge"):
        K.device_retry_call(lambda: 1, "K1")
    assert K.device_retry_call(lambda: 7, "K1") == 7
    assert faults.snapshot() == {"device.wedge": 1, "device.dispatch": 1}
