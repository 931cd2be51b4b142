#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (fgumi_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (any failed check exits nonzero; nothing is caught and passed over):

1. setup: the card's name and power limit (nvidia-smi); the three input
   BAMs are simulated in worker processes while the main process builds,
   in parallel, the CUDA kernels (``nvcc`` on ``fgumi_tpu_torch/csrc``) and
   the native host library (``g++`` on ``fgumi_tpu_torch/native``), both
   timed;
2. kernels at the test shapes: K1 ``consensus_wire_full`` and K1-f
   ``consensus_wire_filter`` against their plain PyTorch versions on the
   card (K1: depth/errors exact, winner/qual exact where neither side is
   suspect, every plane exact after the f64 oracle patch and equal to the
   oracle on sampled families; K1-f: depth/errors exact, the per-read
   suspect flags equal, stats columns 0-5 and fb/fq within the read length
   exact on rows neither side flags, and every row equal to the host twin
   over the oracle-patched columns once the suspect rows went through
   ``filter_resolve_suspect_rows`` and the host filter pass); both also at
   their tiling edges (reads of 1-300 rows, L 4-2048, Q0-class
   observations, 1, 37 and 40,000 reads; K1 also three 600-row families),
   each check line with the kernel's launch geometry (grid, warps per
   block, shared bytes, blocks per SM) and registers;
3. end to end through the port's CLI, each case's cuda run between a reset
   and a read of the launch counts, its records equal to the ``--device
   cpu`` run's:
   - ``fixed5_1M``: BASELINE config 1 at full size, 1,000,000 reads
     (100,000 families x 5 templates, paired, 150 bp, seed 42), fast engine
     ``simplex`` and ``simplex --device-filter`` (the options of the JAX
     package's device-filter tests);
   - ``longtail_200k``: ~200,000 longtail reads (18,000 families, seed 43),
     the same two runs;
   - ``classic_50k``: 50,000 reads (5,000 families x 5, seed 42) on the
     ``--classic`` engine;
4. kernels at the main-path shapes the fast runs reported (their largest
   batch), checked as in phase 2 and then timed beside the bound and the
   plain version's time: device time per launch from torch.profiler over
   25 calls, CUDA-event time per call over 25 back-to-back calls, and the
   median CUDA-event time of one call with its host launch path;
5. the ``kernels`` JSON line, the nvidia-smi line and, last, the device
   line.

Exits 2 without a result when CUDA is unavailable or the port is missing.
"""

import concurrent.futures as cf
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
KERNEL_SOURCE = "fgumi_tpu_torch/csrc/consensus_wire.cu"
REPLACES_FULL = "fgumi_tpu/ops/pallas_kernel.py:240"
REPLACES_FILTER = "fgumi_tpu/ops/pallas_kernel.py:459"
# the fused filter's options, as the JAX package's device-filter tests use
FILTER_OPTS = ["--filter-min-reads", "3", "--filter-min-mean-base-quality",
               "30", "--filter-min-base-quality", "20"]
# consensus thresholds of the kernel-level K1-f checks
MIN_READS_C, MIN_QUAL_C = 1, 40

INPUTS = {
    "fixed5_1M": dict(num_families=100000, family_size=5, read_length=150,
                      paired=True, seed=42),
    "longtail_200k": dict(num_families=18000, family_size=5,
                          family_size_distribution="longtail",
                          read_length=150, paired=True, seed=43),
    "classic_50k": dict(num_families=5000, family_size=5, read_length=150,
                        paired=True, seed=42),
}


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond, msg: str):
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ inputs

def random_batch(n_fam: int, fam: int, L: int, seed: int, q0: bool = False):
    """Uniform random codes (N included) and quals: the test shapes.
    ``q0`` adds Q0-class observations (a -inf dictionary entry)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    starts = (np.arange(n_fam + 1) * fam).astype(np.int64)
    return codes, quals, starts


def ragged_batch(sizes, L: int, seed: int, q0: bool = False):
    """As ``random_batch`` with reads of the given row counts."""
    rng = np.random.default_rng(seed)
    N = int(np.sum(sizes))
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(N, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    starts = np.concatenate(([0], np.cumsum(sizes))).astype(np.int64)
    return codes, quals, starts


def family_batch(sizes, L: int, seed: int):
    """Main-path-like families: one truth per family, 1% substitutions,
    quals 30-40 (the simulator's defaults), ragged 3' ends."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int64)
    N = int(sizes.sum())
    starts = np.concatenate(([0], np.cumsum(sizes)))
    truth = rng.integers(0, 4, size=(len(sizes), L), dtype=np.uint8)
    codes = np.repeat(truth, sizes, axis=0)
    errs = rng.random((N, L)) < 0.01
    codes[errs] = (codes[errs] + rng.integers(1, 4, int(errs.sum()),
                                               dtype=np.uint8)) % 4
    quals = rng.integers(30, 41, size=(N, L), dtype=np.uint8)
    lens = L - rng.integers(0, 12, size=N)
    tail = np.arange(L)[None, :] >= lens[:, None]
    codes[tail] = 4
    quals[tail] = 0
    return codes, quals, starts


def longtail_sizes(n_fam: int, seed: int):
    rng = np.random.default_rng(seed)
    return np.minimum(50, 1 + (rng.pareto(1.3, n_fam) * 2.5).astype(np.int64))


def main_path_batch(shape, longtail: bool, seed: int):
    """A batch at a main-path shape (rows N, columns L, segments J): J
    consensus reads over about N rows (family sizes N/J, or the longtail
    mix), ragged consensus lengths up to L."""
    N, L, J = shape
    sizes = (longtail_sizes(J, seed) if longtail
             else np.full(J, max(N // J, 1), dtype=np.int64))
    codes, quals, starts = family_batch(sizes, L, seed)
    lens = (L - np.random.default_rng(seed).integers(0, 4, size=J)).astype(
        np.int32)
    return codes, quals, starts, lens


# ----------------------------------------------------------------- timing

def _call_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median CUDA-event time of one call, host launch overhead included:
    the events bracket the wrapper, so the device waits for the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, reps: int = 25) -> float:
    """CUDA-event time of ``reps`` back-to-back calls over ``reps``: the
    device's time per call when it, not the host's launch path, is the
    slower side."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 25, kernel: str = None):
    """Device time of one call from torch.profiler over ``reps`` calls:
    with ``kernel``, the mean GPU time of the launches whose name holds it
    (and how many the profiler saw); else the summed GPU time of every
    kernel the calls launched, over ``reps``. None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    seen = 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if kernel is None:
            total_us += t
        elif kernel in ev.key and t > 0:
            total_us += t
            seen += ev.count
    if kernel is None:
        seen = reps
    if total_us <= 0 or not seen:
        return None, seen
    return total_us / seen / 1e3, seen


def _time(res, run_kernel, run_plain, counter: str, symbol: str):
    """Kernel and plain timings into ``res``; the timing launches are not
    the main path's, so the wrapper's count is restored afterwards."""
    from fgumi_tpu_torch.ops import cuda_kernel

    launches0 = getattr(cuda_kernel, counter)
    res["device_ms"], res["profiled_launches"] = device_ms(
        run_kernel, kernel=symbol)
    res["plain_device_ms"], _ = device_ms(run_plain)
    res["loop_ms"] = loop_ms(run_kernel)
    res["plain_loop_ms"] = loop_ms(run_plain)
    res["call_ms"] = _call_ms(run_kernel)
    res["plain_call_ms"] = _call_ms(run_plain)
    setattr(cuda_kernel, counter, launches0)
    # the kernel's own time where the profiler saw the device, else the
    # event time of back-to-back calls
    res["ms"] = res["device_ms"] or res["loop_ms"]
    res["plain_ms"] = res["plain_device_ms"] or res["plain_loop_ms"]
    bytes_ms = res["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = res["f32_ops"] / F32_OPS_PER_S * 1e3
    res["bound_ms"] = max(bytes_ms, ops_ms)
    res["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"


# ----------------------------------------------------------------- kernels

def wire_on_device(kern, codes, quals, starts, dev, name):
    import torch

    from fgumi_tpu_torch.ops import wire as W

    w = W.build_wire(torch.from_numpy(codes), torch.from_numpy(quals),
                     kern._delta94)
    check(w is not None, f"{name}: batch unexpectedly needs packed2")
    J = len(starts) - 1
    counts = torch.from_numpy(np.diff(starts)).to(dev)
    seg_ids = torch.repeat_interleave(torch.arange(J, device=dev), counts)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    return w[0].to(dev), w[1].to(dev), starts_d, seg_ids


def check_wire_kernel(name, codes, quals, starts, dev, timed: bool):
    """K1 vs its plain version on one batch; returns a result dict."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, oracle, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    tables = quality_tables(45, 40)
    kern = ConsensusKernel(tables, dev)
    J = len(starts) - 1
    N, L = codes.shape
    wire, dict64, starts_d, seg_ids = wire_on_device(kern, codes, quals,
                                                      starts, dev, name)
    pre = kern._pre

    def run_kernel():
        return cuda_kernel.consensus_wire_full(wire, starts_d, dict64, pre)

    def run_plain():
        return W.wire_full(wire, seg_ids, dict64, pre, J, J)

    launches0 = cuda_kernel.LAUNCHES
    got = [t.cpu().numpy() for t in run_kernel()]
    torch.cuda.synchronize()
    check(cuda_kernel.LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    cuda_kernel.LAUNCHES = launches0
    ref = [t.cpu().numpy() for t in run_plain()]
    sides = []
    for qs, wp, d, e in (got, ref):
        win, qual, sus = W.unpack_result_split(qs, wp, J)
        sides.append((win, qual, sus, d.view(np.uint16).astype(np.int64),
                      e.view(np.uint16).astype(np.int64)))
    (wk, qk, sk, dk, ek), (wr, qr, sr, dr, er) = sides
    check(np.array_equal(dk, dr), f"{name}: depth differs")
    check(np.array_equal(ek, er), f"{name}: errors differs")
    clean = ~sk & ~sr
    check(np.array_equal(wk[clean], wr[clean]),
          f"{name}: winner differs on non-suspect positions")
    check(np.array_equal(qk[clean], qr[clean]),
          f"{name}: qual differs on non-suspect positions")
    err = max(int(np.abs(dk - dr).max(initial=0)),
              int(np.abs(ek - er).max(initial=0)),
              int(np.abs(wk[clean].astype(int) - wr[clean]).max(initial=0)),
              int(np.abs(qk[clean].astype(int) - qr[clean]).max(initial=0)))
    # both sides through the host completion (oracle patch)
    resolved = []
    for qs, wp, d, e in (got, ref):
        resolved.append(kern._complete_wire_columns(
            qs, wp, d.view(np.uint16), e.view(np.uint16), codes, quals,
            starts))
    for plane, a, b in zip("wqde", resolved[0], resolved[1]):
        check(np.array_equal(a, b), f"{name}: plane {plane} differs after "
                                    "the oracle patch")
    # the resolved planes are the f64 oracle's answer (sampled families)
    rng = np.random.default_rng(J)
    for f in rng.choice(J, size=min(J, 16), replace=False):
        rows = slice(starts[f], starts[f + 1])
        want = oracle.call_family(codes[rows], quals[rows], tables)
        for plane, a, b in zip("wqde", resolved[0], want):
            check(np.array_equal(a[f], b), f"{name}: family {f} plane "
                                           f"{plane} differs from the oracle")
    res = {"kernel": "consensus_wire_full", "name": name, "rows": N, "L": L,
           "families": J, "suspect_kernel": int(sk.sum()),
           "suspect_plain": int(sr.sum()),
           "suspect_only_kernel": int((sk & ~sr).sum()),
           "suspect_only_plain": int((sr & ~sk).sum()), "max_abs_err": err,
           "geometry": cuda_kernel.full_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_full_kernel")}
    if timed:
        # each input read once, each output written once
        res["bytes"] = (N * L + (J + 1) * 4 + 64 * 4
                        + J * L * (1 + 2 + 2) + J * (L // 4))
        # f32 work: 4 lane adds per valid observation, ~48 ops per column
        # (winner, posterior, two-trials, Phred, guard band)
        res["f32_ops"] = 4 * int((codes != 4).sum()) + 48 * J * L
        _time(res, run_kernel, run_plain, "LAUNCHES",
              "consensus_wire_full_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


class _Opts:
    """Consensus options the filter stage reads."""
    min_reads = MIN_READS_C
    min_consensus_base_quality = MIN_QUAL_C
    produce_per_base_tags = True


def filter_stage(f_min_reads: int, min_base_q: int):
    from fgumi_tpu_torch.consensus.device_filter import SimplexFilterStage
    from fgumi_tpu_torch.consensus.filter import FilterConfig

    cfg = FilterConfig.new([f_min_reads], [0.025], [0.08],
                           min_base_quality=min_base_q,
                           min_mean_base_quality=25.0)
    return SimplexFilterStage(cfg, _Opts())


def check_filter_kernel(name, codes, quals, starts, lens, dev, timed: bool,
                        f_min_reads: int = 3, min_base_q: int = 25):
    """K1-f vs its plain version on one batch; returns a result dict."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, oracle, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    kern = ConsensusKernel(quality_tables(45, 40), dev)
    stage = filter_stage(f_min_reads, min_base_q)
    fp = stage.dev_params
    J = len(starts) - 1
    N, L = codes.shape
    wire, dict64, starts_d, seg_ids = wire_on_device(kern, codes, quals,
                                                      starts, dev, name)
    lens_d = torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(dev)
    emin = torch.from_numpy(fp.emin_tab.astype(np.int32)).to(dev)
    pre = kern._pre
    args = (pre, MIN_READS_C, MIN_QUAL_C, lens_d, fp.min_reads, emin,
            fp.min_base_q, fp.per_base)

    def run_kernel():
        return cuda_kernel.consensus_wire_filter(wire, starts_d, dict64,
                                                 *args)

    def run_plain():
        return W.wire_filter(wire, seg_ids, dict64, *args, J, J)

    launches0 = cuda_kernel.FILTER_LAUNCHES
    got_d = run_kernel()
    torch.cuda.synchronize()
    check(cuda_kernel.FILTER_LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    cuda_kernel.FILTER_LAUNCHES = launches0
    ref_d = run_plain()
    got = [t.cpu().numpy() for t in got_d]
    ref = [t.cpu().numpy() for t in ref_d]
    for k, plane in ((3, "depth"), (4, "errors")):
        check(np.array_equal(got[k], ref[k]), f"{name}: {plane} differs")
    sus_k = got[0][:, W.S_SUSPECT] != 0
    sus_p = ref[0][:, W.S_SUSPECT] != 0
    check(np.array_equal(sus_k, sus_p), f"{name}: suspect flags differ "
          f"(kernel {int(sus_k.sum())}, plain {int(sus_p.sum())})")
    clean = ~sus_k & ~sus_p
    in_len = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    err = 0
    for k, plane in ((1, "fb"), (2, "fq")):
        a = np.where(in_len[clean], got[k][clean], 0).astype(np.int64)
        b = np.where(in_len[clean], ref[k][clean], 0).astype(np.int64)
        check(np.array_equal(a, b), f"{name}: {plane} differs on clean rows")
        err = max(err, int(np.abs(a - b).max(initial=0)))
    a = got[0][clean, :W.S_SUSPECT].astype(np.int64)
    b = ref[0][clean, :W.S_SUSPECT].astype(np.int64)
    check(np.array_equal(a, b), f"{name}: stats differ on clean rows")
    err = max(err, int(np.abs(a - b).max(initial=0)))

    # the host twin over the oracle-patched columns
    w, q, d, e = kern._complete_wire_columns(
        got[5], got[6], got[3].view(np.uint16), got[4].view(np.uint16),
        codes, quals, starts)
    tb, tq = oracle.apply_consensus_thresholds(w, q, d, MIN_READS_C,
                                               MIN_QUAL_C)
    fb_h, fq_h, st_h = stage.host_filter_columns(tb, tq, d, e, lens)
    # each side as the fused route resolves it: clean rows from the device
    # stats and masked columns, suspect rows through the raw-column gather,
    # the ordinary host completion and the host filter pass
    for side, outs, dev_outs in (("kernel", got, got_d),
                                 ("plain", ref, ref_d)):
        st = outs[0].astype(np.int64)
        fb = outs[1].copy()
        fq = outs[2].copy()
        rows = np.nonzero(st[:, W.S_SUSPECT] != 0)[0]
        if len(rows):
            rw, rq, rd, re_ = kern.filter_resolve_suspect_rows(
                dev_outs[1:], rows, starts, codes, quals)
            b2, q2 = oracle.apply_consensus_thresholds(rw, rq, rd,
                                                       MIN_READS_C,
                                                       MIN_QUAL_C)
            fb[rows], fq[rows], st[rows] = stage.host_filter_columns(
                b2, q2, rd, re_, np.asarray(lens)[rows])
        check(np.array_equal(st[:, :W.S_SUSPECT], st_h[:, :W.S_SUSPECT]),
              f"{name}: {side} stats differ from the host twin")
        for plane, x, y in (("fb", fb, fb_h), ("fq", fq, fq_h)):
            check(np.array_equal(np.where(in_len, x, 0),
                                 np.where(in_len, y, 0)),
                  f"{name}: {side} {plane} differs from the host twin")
    res = {"kernel": "consensus_wire_filter", "name": name, "rows": N,
           "L": L, "reads": J, "suspect_rows": int(sus_k.sum()),
           "max_abs_err": err,
           "geometry": cuda_kernel.filter_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_filter_kernel")}
    if timed:
        d16 = np.minimum(got[3].view(np.uint16), 32767)
        touched = len(np.unique(d16[in_len & (d16 > 0)]))
        # each input read once, each output written once: wire, starts,
        # dictionary, lens, the emin entries this data touches; fb, fq, qs
        # (1 B), depth, errors (2 B), wp (1/4 B) per column; a 28 B row
        res["bytes"] = (N * L + 4 * (J + 1) + 256 + 4 * J + 4 * touched
                        + int(J * L * 7.25) + 28 * J)
        # K1's f32 work plus ~12 integer compares/selects per column
        res["f32_ops"] = 4 * int((codes != 4).sum()) + 60 * J * L
        _time(res, run_kernel, run_plain, "FILTER_LAUNCHES",
              "consensus_wire_filter_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def kernel_phase_test_shapes(dev):
    for n_fam, fam, L in ((7, 3, 48), (65, 3, 100), (129, 2, 48), (4, 40, 32)):
        codes, quals, starts = random_batch(n_fam, fam, L, seed=n_fam + L)
        check_wire_kernel(f"k1_test_{n_fam}x{fam}x{L}", codes, quals,
                          starts, dev, timed=False)
    # K1-f at the JAX package's fused-filter test shapes, ragged lengths,
    # per-base masks and the quality mask; the last also has Q0-class
    # observations (a -inf dictionary entry)
    for n_fam, fam, q0 in ((7, 3, False), (8, 4, False), (9, 5, False),
                           (65, 3, True)):
        L = 48
        codes, quals, starts = random_batch(n_fam, fam, L,
                                            seed=n_fam * 7 + fam, q0=q0)
        lens = np.random.default_rng(fam).integers(L - 7, L + 1,
                                                   size=n_fam)
        check_filter_kernel(f"k1f_test_{n_fam}x{fam}x{L}"
                            + ("_q0" if q0 else ""), codes, quals, starts,
                            lens.astype(np.int32), dev, timed=False,
                            f_min_reads=fam)
    # the tiling edges of both kernels: reads of 1-300 rows in one batch at
    # widths from 4 to 2048 (staged whole or in 32-column strips of row
    # chunks; from 336 on the byte table and the slices of a block pass 48
    # KB of shared memory), Q0-class observations in ragged reads, fewer
    # reads than the persistent grid has warps, and more than one pass of
    # it; K1 also three 600-row families at L 16 (the strip path's chunks)
    ragged = (5, 300, 1, 50, 2, 5, 1, 50, 300, 2)
    cases = [(f"ragged_x{L}", ragged, L, False, False)
             for L in (4, 36, 152, 304, 336, 380, 2048)]
    cases += [("ragged_x152_q0", ragged, 152, True, False),
              ("1read_x152", (3,), 152, False, False),
              ("37reads_x152", tuple(np.arange(37) % 7 + 1), 152, False,
               False),
              ("40000reads_x152", tuple(np.random.default_rng(4).integers(
                  1, 9, size=40000)), 152, False, True),
              ("deep_3x600_x16", (600, 600, 600), 16, False, False)]
    for name, sizes, L, q0, family in cases:
        seed = len(sizes) + L
        if family:
            codes, quals, starts = family_batch(sizes, L, seed)
        else:
            codes, quals, starts = ragged_batch(sizes, L, seed, q0=q0)
        check_wire_kernel(f"k1_{name}", codes, quals, starts, dev,
                          timed=False)
        if name.startswith("deep"):
            continue
        lens = np.random.default_rng(seed).integers(
            max(L - 7, 0), L + 1, size=len(sizes)).astype(np.int32)
        check_filter_kernel(f"k1f_{name}", codes, quals, starts, lens, dev,
                            timed=False)


def kernel_phase_main_path(dev, shapes):
    """K1 and K1-f at the fast engine's largest batch of each main-path
    run, checked and timed."""
    out = {}
    for key, kernel, shape, longtail in (
            ("k1_fixed", "full", shapes["fixed5_1M"]["fast"], False),
            ("k1_longtail", "full", shapes["longtail_200k"]["fast"], True),
            ("k1f_fixed", "filter", shapes["fixed5_1M"]["fused"], False),
            ("k1f_longtail", "filter", shapes["longtail_200k"]["fused"],
             True)):
        codes, quals, starts, lens = main_path_batch(shape, longtail,
                                                     seed=len(key))
        name = (f"main_{key}_{len(starts) - 1}seg_{codes.shape[0]}rows"
                f"_x{codes.shape[1]}")
        if kernel == "full":
            out[key] = check_wire_kernel(name, codes, quals, starts, dev,
                                         timed=True)
        else:
            out[key] = check_filter_kernel(name, codes, quals, starts, lens,
                                           dev, timed=True)
    return out


# -------------------------------------------------------------- end to end

def records(path):
    from fgumi_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        return [rec.data for rec in r]


def run_simplex(inp: str, out: str, device: str, flags):
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    rc = cli.main(["simplex", "-i", inp, "-o", out, "--device", device,
                   "--stats-json", stats_path, *flags])
    check(rc == 0, f"simplex --device {device} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        return json.load(f)


def e2e_case(name, inp, work, flags, fused: bool):
    """cuda run (every count zeroed just before, read just after) + cpu
    run of the same command; records must be identical."""
    from fgumi_tpu_torch.ops import cuda_kernel, wire as W

    out_gpu = os.path.join(work, f"{name}.cuda.bam")
    out_cpu = os.path.join(work, f"{name}.cpu.bam")
    cuda_kernel.LAUNCHES = 0
    cuda_kernel.FILTER_LAUNCHES = 0
    W.PACKED2_LAUNCHES = 0
    st = run_simplex(inp, out_gpu, "cuda", flags)
    k1 = cuda_kernel.LAUNCHES
    k1f = cuda_kernel.FILTER_LAUNCHES
    packed2 = W.PACKED2_LAUNCHES
    check(st["device_batches"] > 0, f"{name}: no device batch")
    if fused:
        check(st["fused_batches"] > 0, f"{name}: no fused device batch")
        check(k1f >= st["fused_batches"],
              f"{name}: {k1f} K1-f launches < {st['fused_batches']} fused "
              "batches")
    else:
        check(k1 > 0, f"{name}: K1 was never launched")
        check(k1 + packed2 >= st["device_batches"],
              f"{name}: {k1} K1 launches < {st['device_batches']} device "
              "batches")
    st_cpu = run_simplex(inp, out_cpu, "cpu", flags)
    a, b = records(out_gpu), records(out_cpu)
    check(len(a) > 0, f"{name}: no consensus records")
    check(a == b, f"{name}: cuda and cpu records differ")
    wall = st["wall_s"]
    shapes = st["batch_shapes"]
    summary = {
        "case": name, "engine": st["engine"], "flags": flags,
        "input_reads": st["input_reads"],
        "consensus_reads": st["consensus_reads"],
        "records_written": st["records_written"],
        "reads_per_s": st["input_reads"] / wall, "wall_s": wall,
        "host_s": st["host_s"], "device_s": st["device_s"],
        "oracle_patch_s": st["oracle_patch_s"],
        "device_batches": st["device_batches"],
        "fused_batches": st["fused_batches"],
        "packed2_columns_batches": st["packed2_columns_batches"],
        "launches": {"consensus_wire_full": k1,
                     "consensus_wire_filter": k1f, "packed2_full": packed2},
        "stats_bytes_fetched": st["stats_bytes_fetched"],
        "rows_gathered": st["rows_gathered"],
        "suspect_positions": st["suspect_positions"],
        "total_positions": st["total_positions"],
        "largest_batch": max(shapes, key=lambda s: s[0]) if shapes else None,
        "cpu_wall_s": st_cpu["wall_s"],
        "cpu_reads_per_s": st_cpu["input_reads"] / st_cpu["wall_s"],
        "records_identical": True,
    }
    print("e2e " + json.dumps(summary), flush=True)
    return summary


def e2e_phase(paths, work):
    out = {}
    for case in ("fixed5_1M", "longtail_200k"):
        out[case] = {
            "fast": e2e_case(f"{case}_fast", paths[case], work, [], False),
            "fused": e2e_case(f"{case}_fused", paths[case], work,
                              ["--min-reads", "1", "--device-filter",
                               *FILTER_OPTS], True),
        }
    out["classic_50k"] = {"classic": e2e_case(
        "classic_50k", paths["classic_50k"], work, ["--classic"], False)}
    return out


def _simulate(path, kw):
    """Worker-process body: one simulated input BAM."""
    from fgumi_tpu_torch.simulate import simulate_grouped_bam

    t0 = time.monotonic()
    n = simulate_grouped_bam(path, **kw)
    return n, time.monotonic() - t0


# -------------------------------------------------------------------- main

def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _timed_build(build):
    t0 = time.monotonic()
    build(force=True)
    return time.monotonic() - t0


def ptxas_registers(kernel: str):
    """Registers a thread of ``kernel`` uses, from the last build's
    ``-Xptxas -v`` report (None when the build log does not say)."""
    from fgumi_tpu_torch.ops import cuda_kernel

    current = None
    for line in cuda_kernel.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif current and kernel in current and "registers" in line:
            return int(line.split("Used")[1].split("registers")[0])
    return None


def kernel_entry(name, res, launches, replaces):
    return {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": replaces, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": None}


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU", 2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from fgumi_tpu_torch import native
        from fgumi_tpu_torch.ops import cuda_kernel
    except ImportError as e:
        fail(f"the fgumi_tpu_torch package is missing: {e}", 2)
    t_start = time.monotonic()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work, \
            cf.ProcessPoolExecutor(
                max_workers=len(INPUTS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
        paths = {k: os.path.join(work, f"{k}.bam") for k in INPUTS}
        sims = {k: pool.submit(_simulate, paths[k], kw)
                for k, kw in INPUTS.items()}
        with cf.ThreadPoolExecutor(max_workers=2) as builders:
            t_cuda = builders.submit(_timed_build, cuda_kernel.build)
            t_native = builders.submit(_timed_build, native.build)
            print(f"built {KERNEL_SOURCE} in {t_cuda.result():.1f}s and "
                  f"the native host library in {t_native.result():.1f}s "
                  "(in parallel)", flush=True)
        for line in cuda_kernel.BUILD_LOG.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("ptxas: " + line.strip(), flush=True)
        dev = torch.device("cuda", 0)

        kernel_phase_test_shapes(dev)
        for k, fut in sims.items():
            n, dt = fut.result()
            print(f"simulated {k}: {n} records in {dt:.1f}s", flush=True)
        e2e = e2e_phase(paths, work)

    shapes = {case: {kind: s["largest_batch"] for kind, s in runs.items()}
              for case, runs in e2e.items()}
    main_k = kernel_phase_main_path(dev, shapes)

    kernels = {"kernels": [
        kernel_entry("consensus_wire_full", main_k["k1_fixed"],
                     e2e["fixed5_1M"]["fast"]["launches"][
                         "consensus_wire_full"], REPLACES_FULL),
        kernel_entry("consensus_wire_filter", main_k["k1f_fixed"],
                     e2e["fixed5_1M"]["fused"]["launches"][
                         "consensus_wire_filter"], REPLACES_FILTER)]}
    print(f"total {time.monotonic() - t_start:.1f}s", flush=True)
    print(json.dumps(kernels), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
