"""The CUDA kernels (the wire kernels K1, the fused consensus→filter K1-f,
K1-r, K1 with the duplex combine's resident arrays, and K1-p2, K1 over the
packed2 layout of batches with more than 63 distinct quals, the UMI Hamming
kernel K4, and the strand combines K5 and K6) against their plain PyTorch
versions, and K5 and K6 also against their numpy twins, on the card.

Marked ``gpu``: each test decides at run time whether a CUDA device is
present and skips otherwise. On a machine with one (and ``nvcc``), without
JAX installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

The wire kernels run one design (a warp per consensus read on a
persistent grid, rows staged whole or in 32-column strips of row chunks),
so each tiling edge is a case of one test for all three; K1-r's lane counts
are also held against a numpy count of the rows at 600-row families (the
strip path's chunks). K1-p2 is held with its code spans at every 16-byte
phase (L 100; the planes also at other offsets of their buffers), at reads
of 0-300 rows at L 4-2,048 (staged whole and in strips), all-N rows and
quals of 0 and 94-255. K4 is held at its tiling edges:
one row on either side; L 1 to 71 on either side of 4, 16 and 32 (the bit
planes hold 32 columns, then the byte path); M of every residue mod 8 (the
16-byte stores' row offsets); fewer output tiles than the persistent grid's
blocks; an 8,191 x 8,191 matrix and 8,191 x 9; all 256 byte values, one
repeated byte, all-equal and all-different rows; the bytes of paired
UMIs. K6 is held at T 1, 15, 16 and 17 (its 4-position groups,
16-position planes and the scalar tail) and at ``codec_320k``'s largest
combine, 2,678,850 positions; K5 at 1 and 11,757 rows (``duplex_240k``'s
largest combine, over 23,724 resident rows) at widths 4, 128 and 152 with
lengths 0 to Lp + 8; a misaligned K6 view raises. Eight K1 (and K1-r)
dispatches of ``ConsensusKernel`` kept in flight and resolved in reverse
order equal the serial dispatch-and-resolve outputs bit for bit (the
pinned staging pool under overlap). The last tests also drive
``python -m fgumi_tpu_torch simplex`` (the fast engine, with and without
``--device-filter``, and on an input that takes the >63-distinct-quals
packed2 route), ``group`` (both engines), and ``extract``, ``sort`` and
``pipeline`` (fused, ``--no-fuse`` and ``--device-filter``; an input of
about 2,400 distinct UMIs so the group stage reaches K4), ``duplex``
(both engines, and ``--device-filter`` against ``duplex | filter``; the
fast engine through K1-r and K5) and ``codec`` (both engines, K1 and K6)
on the card; ``dedup`` (both engines, K4 once a position group) against
``--device cpu``, an injected out-of-memory on the K1 and K1-f routes
(one halving, both halves launched, the clean run's records), and the
mapped front half (``correct`` and ``zipper`` on both engines, ``fastq``,
``chip_smoke.stand_in_align``, ``sort``, ``group``) ending in ``simplex``
on the card against ``--device cpu``.

Tolerances: depth and errors exact; winner and qual (K1), and the stats
columns 0-5 and the masked columns within the read length (K1-f), exact
where neither side is suspect (the f32 sums run in different orders, so the
suspect sets may differ); every plane exact after the f64 oracle patch, and
every K1-f row equal to the host filter twin over the patched columns.
K1-r's obs exact, its tb/tq exact where neither side is suspect. K4, K5,
K6 and ``group`` are integer-exact.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fgumi_tpu_torch.consensus.codec import combine_arrays
from fgumi_tpu_torch.consensus.device_filter import SimplexFilterStage
from fgumi_tpu_torch.consensus.fast_duplex import combine_rows_host
from fgumi_tpu_torch.consensus.filter import FilterConfig
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.ops import combine as C
from fgumi_tpu_torch.ops import cuda_kernel, oracle, umi_hamming
from fgumi_tpu_torch.ops import wire as W
from fgumi_tpu_torch.ops.kernel import (STAGING_DEPTH, ConsensusKernel,
                                        codec_combine_device)
from fgumi_tpu_torch.ops.tables import quality_tables

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("n_fam,fam,L", [(7, 3, 48), (65, 3, 100),
                                         (129, 2, 48), (4, 40, 32),
                                         (4000, 5, 160)])
def test_kernel_matches_plain(cuda_dev, n_fam, fam, L):
    rng = np.random.default_rng(n_fam + fam + L)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    _hold_full_kernel(cuda_dev, codes, quals, np.full(n_fam, fam))


@pytest.mark.parametrize("resident", [None, (1, 40)], ids=["k1", "k1r"])
def test_overlapping_dispatches_resolve_in_any_order(cuda_dev, resident):
    """Eight batches dispatched through ConsensusKernel before any is
    resolved, then resolved in reverse order, give bit-identical outputs
    to dispatching and resolving each in turn: with the stage runner's
    dispatches in flight, a pinned staging buffer is never written again
    before the copy that reads it has run (eight uploads a slot against a
    pool of STAGING_DEPTH buffers, batches of growing size)."""
    batches = []
    for i in range(8):
        rng = np.random.default_rng(100 + i)
        n_fam, fam, L = 2000 + 1500 * i, 2 + i % 3, 100 + 4 * (i % 2)
        codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
        quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
        batches.append((codes, quals, np.arange(n_fam + 1) * fam))

    def outputs(kern, handle, batch):
        out = kern.resolve_segments_wire(handle, *batch, want_extras=True)
        extras = out[-1]
        if extras["resident"] is not None:
            extras["resident"].release()
        return [*out[:-1], extras["suspect"]]

    serial = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    want = [outputs(serial, serial.device_call_segments_wire(
        *b, resident_thresholds=resident), b) for b in batches]
    kern = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    handles = [kern.device_call_segments_wire(
        *b, resident_thresholds=resident) for b in batches]
    got = {i: outputs(kern, handles[i], batches[i])
           for i in reversed(range(8))}
    for i, w in enumerate(want):
        for a, b in zip(got[i], w):
            np.testing.assert_array_equal(a, b)
    assert kern.batches == 8
    assert all(len(pool) <= STAGING_DEPTH
               for pool in kern._staging.values())


def test_full_kernel_deep_family(cuda_dev):
    """Three 600-row families at L 16 (the CPU parity case deep_600's
    shape): more rows than a tile takes, so the strip path."""
    codes, quals, _ = _random_reads((600, 600, 600), 16, seed=600)
    _hold_full_kernel(cuda_dev, codes, quals, np.full(3, 600))


def _hold_full_kernel(cuda_dev, codes, quals, counts):
    """K1 against W.wire_full on one batch: depth/errors exact,
    winner/qual exact where neither side is suspect, every plane exact
    after the oracle patch."""
    counts = np.asarray(counts, dtype=np.int64)
    n_fam = len(counts)
    starts = np.concatenate(([0], np.cumsum(counts)))
    kern = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    wire, dict64 = W.build_wire(torch.from_numpy(codes),
                                torch.from_numpy(quals), kern._delta94)
    wire, dict64 = wire.to(cuda_dev), dict64.to(cuda_dev)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(cuda_dev)
    seg_ids = torch.repeat_interleave(
        torch.arange(n_fam, device=cuda_dev),
        torch.from_numpy(counts).to(cuda_dev))
    launches = cuda_kernel.LAUNCHES
    got = [t.cpu().numpy() for t in cuda_kernel.consensus_wire_full(
        wire, starts_d, dict64, kern._pre)]
    torch.cuda.synchronize()
    assert cuda_kernel.LAUNCHES == launches + 1
    ref = [t.cpu().numpy() for t in W.wire_full(wire, seg_ids, dict64,
                                                kern._pre, n_fam, n_fam)]
    (wk, qk, sk), (wr, qr, sr) = (W.unpack_result_split(o[0], o[1], n_fam)
                                  for o in (got, ref))
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    clean = ~sk & ~sr
    np.testing.assert_array_equal(wk[clean], wr[clean])
    np.testing.assert_array_equal(qk[clean], qr[clean])
    resolved = [kern._complete_wire_columns(
        o[0], o[1], o[2].view(np.uint16), o[3].view(np.uint16), codes, quals,
        starts) for o in (got, ref)]
    for a, b in zip(*resolved):
        np.testing.assert_array_equal(a, b)


def _at_offset(t, offset: int):
    """A contiguous copy of ``t`` that starts ``offset`` bytes into a
    larger buffer (the kernel then reads its spans at other phases)."""
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def _hold_packed2_kernel(cuda_dev, codes, quals, counts, code_offset=0,
                         qual_offset=0):
    """K1-p2 against W.packed2_full on the card: depth/errors exact,
    winner/qual exact where neither side is suspect, every plane exact
    after the oracle patch. The packed planes may start ``code_offset``
    and ``qual_offset`` bytes into their buffers."""
    counts = np.asarray(counts, dtype=np.int64)
    J = len(counts)
    starts = np.concatenate(([0], np.cumsum(counts)))
    kern = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    cp, q = W.pack_codes2(torch.from_numpy(codes), torch.from_numpy(quals))
    cp = _at_offset(cp.to(cuda_dev), code_offset)
    q = _at_offset(q.to(cuda_dev), qual_offset)
    ct, et = kern._device_tables()
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(cuda_dev)
    seg_ids = torch.repeat_interleave(
        torch.arange(J, device=cuda_dev), torch.from_numpy(counts).to(
            cuda_dev))
    launches = cuda_kernel.PACKED2_LAUNCHES
    plain = W.PACKED2_LAUNCHES
    got = [t.cpu().numpy() for t in cuda_kernel.consensus_wire_packed2(
        cp, q, starts_d, ct, et, kern._pre)]
    torch.cuda.synchronize()
    assert cuda_kernel.PACKED2_LAUNCHES == launches + 1
    assert W.PACKED2_LAUNCHES == plain
    n = int(starts[-1])
    ref = [t.cpu().numpy() for t in W.packed2_full(
        cp[:n], q[:n], seg_ids, ct, et, kern._pre, J, J)]
    (wk, qk, sk), (wr, qr, sr) = (W.unpack_result_split(o[0], o[1], J)
                                  for o in (got, ref))
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[3], ref[3])
    clean = ~sk & ~sr
    np.testing.assert_array_equal(wk[clean], wr[clean])
    np.testing.assert_array_equal(qk[clean], qr[clean])
    resolved = [kern._complete_wire_columns(
        o[0], o[1], o[2].view(np.uint16), o[3].view(np.uint16), codes, quals,
        starts) for o in (got, ref)]
    for a, b in zip(*resolved):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("L", [4, 36, 100, 152, 304, 2048])
def test_packed2_kernel_tiling_edges(cuda_dev, L):
    """K1-p2 at reads of 0-300 rows (more than one 255-row count chunk),
    quals 2-93 and 94-255 (clamped), all-N rows, Q0-class entries."""
    counts = [1, 2, 0, 3, 5, 37, 0, 300, 17, 255, 256, 1]
    rng = np.random.default_rng(L)
    N = sum(counts)
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 94, size=(N, L)).astype(np.uint8)
    quals[::7] = rng.integers(94, 256, size=quals[::7].shape)
    quals[5::11, ::9] = 0
    codes[3::13] = 4
    _hold_packed2_kernel(cuda_dev, codes, quals, counts)


@pytest.mark.parametrize("n_fam,fam,L", [(3998, 5, 100), (1, 1, 4),
                                         (40000, 1, 152)])
def test_packed2_kernel_matches_plain(cuda_dev, n_fam, fam, L):
    """K1-p2 at many_quals_20k's batch (3,998 reads x 5 rows, L 100), one
    row, and 40,000 one-row reads."""
    rng = np.random.default_rng(n_fam + L)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 94, size=(n_fam * fam, L)).astype(np.uint8)
    _hold_packed2_kernel(cuda_dev, codes, quals, np.full(n_fam, fam))


@pytest.mark.parametrize("code_offset,qual_offset", [(0, 0), (3, 4),
                                                     (8, 8), (13, 12)])
def test_packed2_kernel_code_phases(cuda_dev, code_offset, qual_offset):
    """At L 100 a code row is 25 bytes, so the reads' code spans start at
    every 16-byte phase (reads from odd and even rows 0-47, each staged
    whole), also with the planes placed at other offsets of their
    buffers."""
    L = 100
    counts = [1] * 32 + [2, 3, 0, 5, 16, 1, 4]
    rng = np.random.default_rng(code_offset + qual_offset)
    N = sum(counts)
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 94, size=(N, L)).astype(np.uint8)
    _hold_packed2_kernel(cuda_dev, codes, quals, counts, code_offset,
                         qual_offset)


@pytest.mark.parametrize("L", [4, 36, 152, 304, 2048])
def test_packed2_kernel_row_edges(cuda_dev, L):
    """Reads of 0, 1, 255, 256 and 300 rows (one or two 255-row count
    chunks; at L 4 the 255-row read is staged whole), a 17-row read (too
    large for the slice from L 152 on: the strip path), all-N rows,
    Q0-class quals and quals of 94-255 other than 127 (clamped to 93's
    entry)."""
    counts = [0, 1, 255, 17, 256, 0, 300, 2]
    rng = np.random.default_rng(L + 1)
    N = sum(counts)
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 94, size=(N, L)).astype(np.uint8)
    high = rng.random((N, L)) < 0.1
    v = rng.integers(94, 255, size=int(high.sum()))
    quals[high] = v + (v >= 127)
    quals[rng.random((N, L)) < 0.02] = 0
    codes[[1, 300, N - 1]] = 4
    _hold_packed2_kernel(cuda_dev, codes, quals, counts)


def test_packed2_launch_geometry(cuda_dev):
    """16 rows of 1.25 L bytes a warp's slice (2 KB at least), 64 spare
    bytes a slice beside the static table, and 4 resident blocks a SM at L
    100 and 152 (the table and the slices pass 48 KB from L 152 on)."""
    for L, slice_bytes in ((100, 2048), (152, 3040)):
        geo = cuda_kernel.packed2_launch_geometry(L, 3998, cuda_dev)
        assert geo["warps_per_block"] == 8 and geo["blocks_per_sm"] >= 4
        assert 1 <= geo["grid"] <= geo["sms"] * geo["blocks_per_sm"]
        assert geo["slice_bytes"] == slice_bytes
        assert geo["shared_bytes"] == 8 * (slice_bytes + 64)


def _hold_resident_kernel(cuda_dev, codes, quals, counts, min_reads=2,
                          min_qual=30):
    """K1-r against W.wire_resident on one batch: K1's planes as
    _hold_full_kernel holds them, obs exact and equal to a numpy count of
    the rows, tb/tq exact where neither side is suspect. Returns the
    kernel's (tb, tq, obs) on the card and the batch's starts."""
    counts = np.asarray(counts, dtype=np.int64)
    n_fam = len(counts)
    starts = np.concatenate(([0], np.cumsum(counts)))
    kern = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    wire, dict64 = W.build_wire(torch.from_numpy(codes),
                                torch.from_numpy(quals), kern._delta94)
    wire, dict64 = wire.to(cuda_dev), dict64.to(cuda_dev)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(cuda_dev)
    seg_ids = torch.repeat_interleave(
        torch.arange(n_fam, device=cuda_dev),
        torch.from_numpy(counts).to(cuda_dev))
    launches = cuda_kernel.RESIDENT_LAUNCHES
    got_d = cuda_kernel.consensus_wire_resident(wire, starts_d, dict64,
                                                kern._pre, min_reads,
                                                min_qual)
    torch.cuda.synchronize()
    assert cuda_kernel.RESIDENT_LAUNCHES == launches + 1
    got = [t.cpu().numpy() for t in got_d]
    ref = [t.cpu().numpy() for t in W.wire_resident(
        wire, seg_ids, dict64, kern._pre, min_reads, min_qual, n_fam,
        n_fam)]
    (wk, qk, sk), (wr, qr, sr) = (W.unpack_result_split(o[0], o[1], n_fam)
                                  for o in (got, ref))
    for k in (2, 3, 6):
        np.testing.assert_array_equal(got[k], ref[k])
    valid = codes != 4
    lanes = np.stack([np.add.reduceat((valid & (codes == b)).astype(
        np.int64), starts[:-1], axis=0) for b in range(4)], axis=-1)
    np.testing.assert_array_equal(got[6], lanes)
    clean = ~sk & ~sr
    for a, b in ((wk, wr), (qk, qr), (got[4], ref[4]), (got[5], ref[5])):
        np.testing.assert_array_equal(a[clean], b[clean])
    resolved = [kern._complete_wire_columns(
        o[0], o[1], o[2].view(np.uint16), o[3].view(np.uint16), codes, quals,
        starts) for o in (got, ref)]
    for a, b in zip(*resolved):
        np.testing.assert_array_equal(a, b)
    return got_d[4:], starts


def test_resident_kernel_deep_family(cuda_dev):
    """Three 600-row families at L 16: the lane counts summed across the
    strip path's row chunks equal the rows' own counts."""
    codes, quals, _ = _random_reads((600, 600, 600), 16, seed=601)
    _hold_resident_kernel(cuda_dev, codes, quals, np.full(3, 600))


@pytest.mark.parametrize("kind", ["uniform_3x128", "two_row_128"])
def test_resident_kernel_batches(cuda_dev, kind):
    """Uniform random bases and quals 2-40 (almost every column with a
    disagreement) and two-row families of main-path data (most columns'
    combine takes the full branch): the CPU parity cases' shapes at 4,000
    reads."""
    if kind == "two_row_128":
        counts = np.full(4000, 2)
        codes, quals, _ = _family_reads(counts, 128, seed=2)
    else:
        counts = np.full(4000, 3)
        codes, quals, _ = _random_reads(counts, 128, seed=3)
    _hold_resident_kernel(cuda_dev, codes, quals, counts)


@pytest.mark.parametrize("counts,L", [((3,) * 4000, 128),
                                      ((600, 2, 600, 5, 1), 48)],
                         ids=["3x4000_L128", "deep_L48"])
def test_duplex_combine_on_card_matches_host(cuda_dev, counts, L):
    """K5 on the card over K1-r's resident arrays equals the numpy
    combine over the fetched tb/tq and the source rows, exactly."""
    counts = np.asarray(counts)
    codes, quals, _ = _family_reads(counts, L, seed=len(counts))
    (tb, tq, obs), starts = _hold_resident_kernel(cuda_dev, codes, quals,
                                                  counts)
    rng = np.random.default_rng(L)
    K = 3 * len(counts)
    a = rng.integers(0, len(counts), size=K).astype(np.int32)
    b = rng.integers(0, len(counts), size=K).astype(np.int32)
    lens = rng.integers(0, L + 1, size=K).astype(np.int32)
    launches = C.DUPLEX_COMBINE_LAUNCHES
    idx = [torch.from_numpy(x).to(cuda_dev) for x in (a, b, lens)]
    got = [t.cpu().numpy() for t in C.duplex_combine(tb, tq, obs, *idx)]
    assert C.DUPLEX_COMBINE_LAUNCHES == launches + 1
    want = combine_rows_host(tb.cpu().numpy(), tq.cpu().numpy(), codes,
                             starts, a, b, lens)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_codec_combine_on_card_matches_host(cuda_dev):
    """K6 on the card equals combine_arrays, exactly."""
    rng = np.random.default_rng(6)
    T = 300000
    bases = np.frombuffer(b"ACGTNn", np.uint8)
    b1 = rng.choice(bases, size=T, p=[0.22] * 4 + [0.04, 0.08])
    b2 = np.where(rng.random(T) < 0.8, b1, rng.choice(bases, size=T))
    q1, q2 = (rng.integers(0, 94, size=T).astype(np.uint8) for _ in "ab")
    d1, d2 = (rng.integers(0, 32768, size=T).astype(np.int32)
              for _ in "ab")
    e1, e2 = ((d * rng.random(T)).astype(np.int32) for d in (d1, d2))
    ops = (b1, b2, q1, q2, d1, d2, e1, e2)
    launches = C.CODEC_COMBINE_LAUNCHES
    got = [t.cpu().numpy() for t in C.codec_combine(
        *(torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
          for x in ops))]
    assert C.CODEC_COMBINE_LAUNCHES == launches + 1
    for g, w in zip(got, combine_arrays(*ops)):
        np.testing.assert_array_equal(g, np.asarray(w))


def _codec_ops(T, seed):
    """K6 inputs of every class: ASCII bases with N and the n pad, quals
    0-93 (Q2 and ties among them), depths and errors around I16_MAX."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTNn", np.uint8)
    b1 = rng.choice(bases, size=T, p=[0.22] * 4 + [0.04, 0.08])
    b2 = np.where(rng.random(T) < 0.8, b1, rng.choice(bases, size=T))
    q1, q2 = (rng.integers(0, 94, size=T).astype(np.uint8) for _ in "ab")
    tie = rng.random(T) < 0.1
    q2[tie] = q1[tie]
    d1, d2 = (rng.integers(0, 40000, size=T).astype(np.int32)
              for _ in "ab")
    e1, e2 = ((d * rng.random(T)).astype(np.int32) for d in (d1, d2))
    return (b1, b2, q1, q2, d1, d2, e1, e2)


@pytest.mark.parametrize("T", [1, 15, 16, 17, 2678850])
def test_codec_combine_kernel_matches_plain(cuda_dev, T):
    """K6 against its plain version on the card, plane by plane, one
    launch counted a call; also into one packed ``out`` buffer, and
    ``codec_combine_device`` (one upload, one fetch) equal to the CPU
    route."""
    ops = _codec_ops(T, seed=T)
    dev_ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
               for x in ops]
    launches = C.CODEC_COMBINE_LAUNCHES
    got = C.codec_combine(*dev_ops)
    torch.cuda.synchronize()
    assert C.CODEC_COMBINE_LAUNCHES == launches + 1
    want = C.codec_combine_plain(*dev_ops)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (T,)
        assert torch.equal(g, w)
    out = torch.empty(C.plane_bytes(T, C.CODEC_OUT), dtype=torch.uint8,
                      device=cuda_dev)
    packed = C.codec_combine(*dev_ops, out=out)
    assert C.CODEC_COMBINE_LAUNCHES == launches + 2
    for g, w in zip(packed, want):
        assert torch.equal(g, w)
    on_card = codec_combine_device(cuda_dev, *ops)
    assert C.CODEC_COMBINE_LAUNCHES == launches + 3
    for g, w in zip(on_card, codec_combine_device("cpu", *ops)):
        np.testing.assert_array_equal(g, w)


def test_codec_combine_misaligned_view_raises(cuda_dev):
    """A view that does not start on a 16-byte boundary raises before the
    launch (no scalar fallback kernel)."""
    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(cuda_dev)
           for x in _codec_ops(65, seed=3)]
    for i in (0, 5):
        bad = list(ops)
        wide = torch.cat((ops[i][:1], ops[i]))
        bad[i] = wide[1:]
        assert bad[i].is_contiguous() and bad[i].data_ptr() % 16
        launches = C.CODEC_COMBINE_LAUNCHES
        with pytest.raises(ValueError, match="16-byte aligned"):
            C.codec_combine(*bad)
        assert C.CODEC_COMBINE_LAUNCHES == launches


def _duplex_ops(J, Lp, K, seed):
    """Resident-like tb/tq/obs and K output rows with lengths 0..Lp+8."""
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 5, size=(J, Lp), dtype=np.uint8)
    tq = rng.integers(0, 94, size=(J, Lp), dtype=np.uint8)
    tq[rng.random((J, Lp)) < 0.1] = 2
    obs = rng.integers(0, 5, size=(J, Lp, 4)).astype(np.int32)
    a = rng.integers(0, J, size=K).astype(np.int32)
    b = rng.integers(0, J, size=K).astype(np.int32)
    lens = rng.integers(0, Lp + 9, size=K).astype(np.int32)
    lens[:min(K, 3)] = (0, Lp, Lp + 8)[:min(K, 3)]
    return (tb, tq, obs, a, b, lens)


@pytest.mark.parametrize("K,J", [(1, 5), (11757, 23724)])
@pytest.mark.parametrize("Lp", [4, 128, 152])
def test_duplex_combine_kernel_matches_plain(cuda_dev, K, J, Lp):
    """K5 against its plain version on the card, plane by plane, one
    launch counted a call."""
    dev_ops = [torch.from_numpy(x).to(cuda_dev)
               for x in _duplex_ops(J, Lp, K, seed=K + Lp)]
    launches = C.DUPLEX_COMBINE_LAUNCHES
    got = C.duplex_combine(*dev_ops)
    torch.cuda.synchronize()
    assert C.DUPLEX_COMBINE_LAUNCHES == launches + 1
    want = C.duplex_combine_plain(*dev_ops)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (K, Lp)
        assert torch.equal(g, w)


def test_strand_combine_launch_geometry(cuda_dev):
    """A block of 256 threads, at least one resident a SM, a grid capped by
    the work (a warp a K5 row, a thread a K6 group of 4) and by the
    card."""
    for kernel, work, want in (("duplex_combine", 11757, -(-11757 // 8)),
                               ("duplex_combine", 1, 1),
                               ("codec_combine", 17, 1),
                               ("codec_combine", 2678850,
                                -(-2678850 // (4 * 256)))):
        geo = C.launch_geometry(kernel, work, cuda_dev)
        assert geo["threads"] == 256 and geo["blocks_per_sm"] >= 1
        assert geo["grid"] == min(want, geo["sms"] * geo["blocks_per_sm"])


class _Opts:
    min_reads = 1
    min_consensus_base_quality = 40
    produce_per_base_tags = True


@pytest.mark.parametrize("n_fam,fam,per_base,min_base_q,q0", [
    (7, 3, True, -1, False), (8, 4, False, 25, False),
    (9, 5, True, 25, False), (65, 3, True, 25, True),
    (7000, 5, True, 25, False)])
def test_filter_kernel_matches_plain(cuda_dev, n_fam, fam, per_base,
                                     min_base_q, q0):
    L = 152
    rng = np.random.default_rng(n_fam * 7 + fam)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    lens = rng.integers(L - 7, L + 1, size=n_fam).astype(np.int32)
    _hold_filter_kernel(cuda_dev, codes, quals, np.full(n_fam, fam), lens,
                        fam, per_base, min_base_q)


def _random_reads(counts, L, seed, q0=False):
    rng = np.random.default_rng(seed)
    N = int(np.sum(counts))
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(N, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    lens = rng.integers(max(L - 7, 0), L + 1, size=len(counts))
    return codes, quals, lens.astype(np.int32)


def _family_reads(counts, L, seed):
    """One truth per read, 1% substitutions, quals 30-40, ragged 3' ends:
    the main path's kind of data (few suspect positions)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(counts, dtype=np.int64)
    truth = rng.integers(0, 4, size=(len(counts), L), dtype=np.uint8)
    codes = np.repeat(truth, counts, axis=0)
    errs = rng.random(codes.shape) < 0.01
    codes[errs] = (codes[errs] + rng.integers(1, 4, int(errs.sum()),
                                               dtype=np.uint8)) % 4
    quals = rng.integers(30, 41, size=codes.shape, dtype=np.uint8)
    tail = np.arange(L)[None, :] >= (L - rng.integers(0, 12, len(codes)))[
        :, None]
    codes[tail] = 4
    quals[tail] = 0
    lens = (L - rng.integers(0, 4, size=len(counts))).astype(np.int32)
    return codes, quals, lens


# reads of 1, 2, 5, 50 and 300 rows in one batch: at every width some read
# is staged whole and the longer ones in 32-column strips of row chunks
# (the 300-row one in several chunks); from L = 336 on the byte table and
# the slices of a block take more than 48 KB of shared memory
RAGGED = (5, 300, 1, 50, 2, 5, 1, 50, 300, 2)
KERNELS = ("full", "filter", "resident")
GEOMETRY = {"full": cuda_kernel.full_launch_geometry,
            "filter": cuda_kernel.filter_launch_geometry,
            "resident": cuda_kernel.resident_launch_geometry}


def _hold(kernel, cuda_dev, codes, quals, counts, lens):
    """K1, K1-f (per-base masks and the quality mask on) or K1-r against
    its plain version on one batch."""
    if kernel == "full":
        _hold_full_kernel(cuda_dev, codes, quals, counts)
    elif kernel == "resident":
        _hold_resident_kernel(cuda_dev, codes, quals, counts)
    else:
        _hold_filter_kernel(cuda_dev, codes, quals, counts, lens, 3, True,
                            25)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L", [4, 36, 152, 304, 336, 380, 2048])
def test_kernel_ragged_reads(cuda_dev, kernel, L):
    codes, quals, lens = _random_reads(RAGGED, L, seed=L)
    _hold(kernel, cuda_dev, codes, quals, RAGGED, lens)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_ragged_q0(cuda_dev, kernel):
    """Q0-class observations (a -inf dictionary entry) in ragged reads."""
    codes, quals, lens = _random_reads(RAGGED, 152, seed=11, q0=True)
    _hold(kernel, cuda_dev, codes, quals, RAGGED, lens)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("J", [1, 3, 37])
def test_kernel_fewer_reads_than_warps(cuda_dev, kernel, J):
    """J = 1 and J below the persistent grid's warp count: the grid shrinks
    to the reads and idle warps write nothing."""
    geo = GEOMETRY[kernel](152, J, cuda_dev)
    assert geo["grid"] == -(-J // geo["warps_per_block"])
    counts = np.arange(J) % 7 + 1
    codes, quals, lens = _random_reads(counts, 152, seed=J)
    _hold(kernel, cuda_dev, codes, quals, counts, lens)


@pytest.mark.parametrize("kernel", KERNELS)
def test_kernel_many_reads(cuda_dev, kernel):
    """40,000 reads: more than one pass of the persistent grid."""
    J = 40000
    geo = GEOMETRY[kernel](152, J, cuda_dev)
    assert geo["grid"] == geo["sms"] * geo["blocks_per_sm"]
    assert geo["grid"] * geo["warps_per_block"] < J
    counts = np.random.default_rng(4).integers(1, 9, size=J)
    codes, quals, lens = _family_reads(counts, 152, seed=4)
    _hold(kernel, cuda_dev, codes, quals, counts, lens)


@pytest.mark.parametrize("kernel", KERNELS)
def test_launch_geometry(cuda_dev, kernel):
    """The launch's geometry: 8 warps a block, a slice of 2-6 KB a warp
    (K1-r: and its 928 B staging of a chunk's narrow planes), resident
    blocks from the occupancy query, the dynamic shared memory above 48 KB
    at wide rows."""
    geometry = GEOMETRY[kernel]
    stage = 928 if kernel == "resident" else 0
    for L, slice_bytes in ((4, 2048), (152, 2432), (336, 5376), (380, 6080),
                           (2048, 6144)):
        geo = geometry(L, 10 ** 6, cuda_dev)
        assert geo["warps_per_block"] == 8
        assert geo["slice_bytes"] == slice_bytes
        assert geo["shared_bytes"] == 8 * (slice_bytes + 16 + stage)
        assert geo.get("scratch_bytes", 0) == 8 * stage
        assert geo["blocks_per_sm"] >= 1
        assert geo["grid"] == geo["sms"] * geo["blocks_per_sm"]
    assert geometry(2048, 1, cuda_dev)["shared_bytes"] > 48 * 1024


def _hold_filter_kernel(cuda_dev, codes, quals, counts, lens, f_min_reads,
                        per_base, min_base_q):
    """K1-f against W.wire_filter on one batch: depth/errors exact, stats
    and masked columns exact on rows neither side flags, every row equal to
    the host twin after the suspect-row completion."""
    counts = np.asarray(counts, dtype=np.int64)
    n_fam, L = len(counts), codes.shape[1]
    starts = np.concatenate(([0], np.cumsum(counts)))
    opts = _Opts()
    opts.produce_per_base_tags = per_base
    stage = SimplexFilterStage(FilterConfig.new(
        [f_min_reads], [0.025], [0.08], min_base_quality=(
            None if min_base_q < 0 else min_base_q),
        min_mean_base_quality=25.0), opts)
    fp = stage.dev_params
    kern = ConsensusKernel(quality_tables(45, 40), cuda_dev)
    wire, dict64 = W.build_wire(torch.from_numpy(codes),
                                torch.from_numpy(quals), kern._delta94)
    wire, dict64 = wire.to(cuda_dev), dict64.to(cuda_dev)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(cuda_dev)
    seg_ids = torch.repeat_interleave(
        torch.arange(n_fam, device=cuda_dev),
        torch.from_numpy(counts).to(cuda_dev))
    args = (kern._pre, 1, 40, torch.from_numpy(lens).to(cuda_dev),
            fp.min_reads, torch.from_numpy(fp.emin_tab).to(cuda_dev),
            fp.min_base_q, fp.per_base)
    launches = cuda_kernel.FILTER_LAUNCHES
    got_d = cuda_kernel.consensus_wire_filter(wire, starts_d, dict64, *args)
    torch.cuda.synchronize()
    assert cuda_kernel.FILTER_LAUNCHES == launches + 1
    ref_d = W.wire_filter(wire, seg_ids, dict64, *args, n_fam, n_fam)
    got = [t.cpu().numpy() for t in got_d]
    ref = [t.cpu().numpy() for t in ref_d]
    np.testing.assert_array_equal(got[3], ref[3])
    np.testing.assert_array_equal(got[4], ref[4])
    np.testing.assert_array_equal(got[0][:, W.S_SUSPECT] != 0,
                                  ref[0][:, W.S_SUSPECT] != 0)
    clean = (got[0][:, W.S_SUSPECT] == 0) & (ref[0][:, W.S_SUSPECT] == 0)
    np.testing.assert_array_equal(got[0][clean, :W.S_SUSPECT],
                                  ref[0][clean, :W.S_SUSPECT])
    in_len = np.arange(L)[None, :] < lens[:, None]
    for k in (1, 2):
        np.testing.assert_array_equal(np.where(in_len, got[k], 0)[clean],
                                      np.where(in_len, ref[k], 0)[clean])
    # every row, as the fused route resolves it, equals the host twin over
    # the oracle-patched columns
    w, q, d, e = kern._complete_wire_columns(
        got[5], got[6], got[3].view(np.uint16), got[4].view(np.uint16),
        codes, quals, starts)
    tb, tq = oracle.apply_consensus_thresholds(w, q, d, 1, 40)
    fb_h, fq_h, st_h = stage.host_filter_columns(tb, tq, d, e, lens)
    for outs, dev_outs in ((got, got_d), (ref, ref_d)):
        st = outs[0].astype(np.int64)
        fb, fq = outs[1].copy(), outs[2].copy()
        rows = np.nonzero(st[:, W.S_SUSPECT] != 0)[0]
        if len(rows):
            rw, rq, rd, re_ = kern.filter_resolve_suspect_rows(
                dev_outs[1:], rows, starts, codes, quals)
            b2, q2 = oracle.apply_consensus_thresholds(rw, rq, rd, 1, 40)
            fb[rows], fq[rows], st[rows] = stage.host_filter_columns(
                b2, q2, rd, re_, lens[rows])
        np.testing.assert_array_equal(st[:, :W.S_SUSPECT],
                                      st_h[:, :W.S_SUSPECT])
        np.testing.assert_array_equal(np.where(in_len, fb, 0),
                                      np.where(in_len, fb_h, 0))
        np.testing.assert_array_equal(np.where(in_len, fq, 0),
                                      np.where(in_len, fq_h, 0))


def _run_cli(tmp_path, *args):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    subprocess.run([sys.executable, "-m", "fgumi_tpu_torch", *args],
                   check=True, env=env, cwd=str(tmp_path), timeout=600)


def _cuda_vs_cpu(tmp_path, flags):
    recs = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, "simplex", "-i", "in.bam", "-o", f"{dev}.bam",
                 "--device", dev, "--stats-json", f"{dev}.json", *flags)
        with BamReader(str(tmp_path / f"{dev}.bam")) as r:
            recs[dev] = [rec.data for rec in r]
    assert recs["cuda"] and recs["cuda"] == recs["cpu"]
    return json.loads((tmp_path / "cuda.json").read_text())


def test_simplex_module_entry_point_on_cuda(cuda_dev, tmp_path):
    """``python -m fgumi_tpu_torch simplex`` on the card (fast engine): the
    kernel ran (launch counts in --stats-json) and the records equal
    --device cpu's."""
    _run_cli(tmp_path, "simulate", "grouped-reads", "-o", "in.bam",
             "--num-families", "300", "--family-size-distribution",
             "longtail", "--read-length", "150")
    stats = _cuda_vs_cpu(tmp_path, [])
    assert stats["engine"] == "fast"
    assert stats["device_batches"] >= 1
    assert stats["launches"]["consensus_wire_full"] >= stats["device_batches"]


def test_device_filter_entry_point_on_cuda(cuda_dev, tmp_path):
    """``simplex --device-filter`` on the card: every fused batch went
    through K1-f and the records equal --device cpu's."""
    _run_cli(tmp_path, "simulate", "grouped-reads", "-o", "in.bam",
             "--num-families", "300", "--family-size-distribution",
             "longtail", "--read-length", "150")
    stats = _cuda_vs_cpu(tmp_path, [
        "--min-reads", "1", "--device-filter", "--filter-min-reads", "3",
        "--filter-min-mean-base-quality", "30", "--filter-min-base-quality",
        "20"])
    assert stats["fused_batches"] >= 1
    assert stats["launches"]["consensus_wire_filter"] >= \
        stats["fused_batches"]
    assert stats["filter"]["failed"] > 0


def _run_group_cuda_vs_cpu(tmp_path, inp, flags):
    recs = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, "group", "-i", inp, "-o", f"g.{dev}.bam",
                 "--device", dev, "--stats-json", f"g.{dev}.json", "-M",
                 f"m.{dev}", *flags)
        with BamReader(str(tmp_path / f"g.{dev}.bam")) as r:
            recs[dev] = [rec.data for rec in r]
    assert recs["cuda"] and recs["cuda"] == recs["cpu"]
    for kind in ("family_sizes", "grouping_metrics", "position_group_sizes"):
        assert (tmp_path / f"m.cuda.{kind}.txt").read_bytes() == \
            (tmp_path / f"m.cpu.{kind}.txt").read_bytes()
    return json.loads((tmp_path / "g.cuda.json").read_text())


def test_packed2_entry_point_on_cuda(cuda_dev, tmp_path):
    """``simplex`` on an input whose batches hold more than 63 distinct
    quals (quality decay plus overlap sums): the packed2 route on the card,
    records equal to --device cpu's."""
    _run_cli(tmp_path, "simulate", "grouped-reads", "-o", "in.bam",
             "--num-families", "400", "--base-quality", "40",
             "--qual-slope", "0.3", "--insert-size-mean", "150",
             "--insert-size-sd", "30")
    stats = _cuda_vs_cpu(tmp_path, [])
    assert stats["launches"]["consensus_wire_packed2"] >= 1
    assert stats["launches"]["packed2_full"] == 0  # no plain version
    assert (stats["launches"]["consensus_wire_packed2"]
            + stats["launches"]["consensus_wire_full"]
            >= stats["device_batches"])


def _hamming_mats(n, m, L, seed, alphabet=b"ACGTN"):
    rng = np.random.default_rng(seed)
    sym = np.frombuffer(alphabet, np.uint8)
    return rng.choice(sym, size=(n, L)), rng.choice(sym, size=(m, L))


HAMMING_CASES = {
    "n1": (1, 5000, 8), "m1": (2000, 1, 8), "n1_m1": (1, 1, 9),
    "L1": (300, 257, 1), "L3": (129, 1000, 3), "L8": (1030, 2000, 8),
    "L9": (1500, 1500, 9), "L71": (700, 1100, 71), "L33": (65, 129, 33),
    "big": (8191, 8191, 8),
    # M = 1,024-1,031: every row offset mod 8 of the 16-byte stores
    **{f"m_mod8_{j}": (130, 1024 + j, 8) for j in range(8)},
    # either side of 4, 16 and 32: the bit planes' 32 columns, the bytes
    **{f"L{L}_words": (129, 300, L) for L in (4, 5, 15, 16, 17, 32, 33)},
    "few_tiles": (100, 300, 8), "n8191_m9": (8191, 9, 8),
}


@pytest.mark.parametrize("case", sorted(HAMMING_CASES))
def test_hamming_kernel_matches_plain(cuda_dev, case):
    n, m, L = HAMMING_CASES[case]
    a, b = _hamming_mats(n, m, L, seed=n + m + L,
                         alphabet=b"ACGTN-:" if L == 71 else b"ACGTN")
    _hold_hamming(cuda_dev, a, b)


@pytest.mark.parametrize("kind", ["all_equal", "all_different"])
def test_hamming_kernel_extremes(cuda_dev, kind):
    a = np.full((1100, 71), ord("A"), np.uint8)
    b = np.full((130, 71), ord("A" if kind == "all_equal" else "C"),
                np.uint8)
    got = _hold_hamming(cuda_dev, a, b)
    assert (got == (0 if kind == "all_equal" else 71)).all()


@pytest.mark.parametrize("L", [8, 15, 32])
@pytest.mark.parametrize("alphabet", ["all_bytes", "ACGT", "one_byte"])
def test_hamming_kernel_byte_values(cuda_dev, L, alphabet):
    """The bit planes at every mask: all 256 byte values (8 planes), ACGT
    (4) and one repeated byte (none: every distance 0)."""
    sym = {"all_bytes": bytes(range(256)), "ACGT": b"ACGT",
           "one_byte": b"\xff"}[alphabet]
    a, b = _hamming_mats(700, 1029, L, seed=L, alphabet=sym)
    got = _hold_hamming(cuda_dev, a, b)
    assert (got == 0).all() == (alphabet == "one_byte")


def test_hamming_kernel_paired_umi_bytes(cuda_dev):
    """Paired UMIs as group builds them: ``aa:ACGT-bb:TTGA`` and the
    reversed forms, bytes from ``ACGTab:-``."""
    rng = np.random.default_rng(15)
    halves = rng.choice(list("ACGT"), size=(3000, 8))
    fwd = ["aa:" + "".join(h[:4]) + "-bb:" + "".join(h[4:]) for h in halves]
    rev = ["bb:" + "".join(h[4:]) + "-aa:" + "".join(h[:4]) for h in halves]
    mat = np.frombuffer("".join(fwd).encode(), np.uint8).reshape(3000, -1)
    rmat = np.frombuffer("".join(rev).encode(), np.uint8).reshape(3000, -1)
    _hold_hamming(cuda_dev, rmat.copy(), mat.copy())


def _hold_hamming(cuda_dev, a, b):
    """K4 against its plain version and numpy, exactly; one counted
    launch, and the launch geometry covers the output."""
    ad = torch.from_numpy(np.ascontiguousarray(a)).to(cuda_dev)
    bd = torch.from_numpy(np.ascontiguousarray(b)).to(cuda_dev)
    launches = umi_hamming.HAMMING_LAUNCHES
    got = umi_hamming.umi_hamming(ad, bd)
    torch.cuda.synchronize()
    assert umi_hamming.HAMMING_LAUNCHES == launches + 1
    plain = umi_hamming.hamming_plain(ad, bd)
    got = got.cpu().numpy()
    np.testing.assert_array_equal(got, plain.cpu().numpy())
    want = (a[:, None, :] != b[None, :, :]).sum(axis=2, dtype=np.int16) \
        if a.shape[0] * b.shape[0] <= 4_000_000 else None
    if want is not None:
        np.testing.assert_array_equal(got, want)
    (n, L), m = a.shape, b.shape[0]
    geo = umi_hamming.launch_geometry(n, m, L, cuda_dev)
    assert geo["tiles"] == (-(-n // geo["tile_rows"])
                            * -(-m // geo["tile_cols"]))
    assert geo["grid"] == min(geo["tiles"], geo["sms"] * geo["blocks_per_sm"])
    assert geo["bit_planes"] == (L <= 32)
    assert geo["l_chunks"] == -(-L // 32)
    return got


def test_hamming_launch_geometry(cuda_dev):
    """The persistent grid: 32 x 256 output tiles, 8 warps a block, at
    least 4 blocks (32 warps) resident a SM on the bit planes (3 on the
    byte path past L = 32); fewer tiles than that launch one block a tile,
    more launch the full grid."""
    few = umi_hamming.launch_geometry(100, 300, 8, cuda_dev)
    assert (few["tile_rows"], few["tile_cols"], few["threads"]) == (32, 256,
                                                                     256)
    assert few["blocks_per_sm"] >= 4
    assert few["grid"] == few["tiles"] == 8
    big = umi_hamming.launch_geometry(5583, 5583, 8, cuda_dev)
    assert big["tiles"] == 175 * 22 and big["bit_planes"] == 1
    assert big["grid"] == big["sms"] * big["blocks_per_sm"] < big["tiles"]
    wide = umi_hamming.launch_geometry(700, 1100, 71, cuda_dev)
    assert wide["bit_planes"] == 0 and wide["l_chunks"] == 3
    assert wide["blocks_per_sm"] >= 3


def test_group_entry_point_on_cuda(cuda_dev, tmp_path):
    """``group --classic`` on the card: one amplicon position with more
    than 1,024 distinct UMIs, so K4 launched; records equal --device
    cpu's for adjacency and paired."""
    import chip_smoke

    inp = str(tmp_path / "amp.bam")
    chip_smoke.amplicon_bam(inp, positions=2, molecules=900, copies=3,
                            read_length=60, seed=3)
    stats = _run_group_cuda_vs_cpu(tmp_path, inp, ["--classic", "--strategy",
                                                   "adjacency"])
    assert stats["launches"]["umi_hamming"] >= 2
    assert stats["device_span"]["largest"][0] >= 1024
    pinp = str(tmp_path / "amp_paired.bam")
    chip_smoke.amplicon_bam(pinp, positions=1, molecules=900, copies=3,
                            read_length=60, seed=4, paired_umis=True)
    stats = _run_group_cuda_vs_cpu(tmp_path, pinp, ["--classic",
                                                    "--strategy", "paired"])
    assert stats["launches"]["umi_hamming"] == 2


@pytest.mark.parametrize("strategy", ["adjacency", "edit", "paired"])
def test_fast_group_entry_point_on_cuda(cuda_dev, tmp_path, strategy):
    """``group`` on the card (the fast engine, the default): two amplicon
    positions of more than 1,024 distinct UMIs each, so K4 launched once a
    position group (twice for paired); records and metrics files equal
    --device cpu's, and the records equal ``--classic``'s."""
    import chip_smoke

    inp = str(tmp_path / "amp.bam")
    chip_smoke.amplicon_bam(inp, positions=2, molecules=900, copies=3,
                            read_length=60, seed=5,
                            paired_umis=strategy == "paired")
    stats = _run_group_cuda_vs_cpu(tmp_path, inp, ["--strategy", strategy])
    assert stats["engine"] == "fast"
    per_group = 2 if strategy == "paired" else 1
    assert stats["launches"]["umi_hamming"] == 2 * per_group
    assert stats["device_span"]["largest"][0] >= 1024
    _run_cli(tmp_path, "group", "-i", inp, "-o", "classic.bam", "--classic",
             "--device", "cpu", "--strategy", strategy)
    with BamReader(str(tmp_path / "classic.bam")) as r, \
            BamReader(str(tmp_path / "g.cuda.bam")) as f:
        assert [rec.data for rec in r] == [rec.data for rec in f]


def _records(path):
    with BamReader(str(path)) as r:
        return [rec.data for rec in r]


@pytest.mark.parametrize("engine", [[], ["--classic"]],
                         ids=["batch", "classic"])
def test_dedup_entry_point_on_cuda(cuda_dev, tmp_path, engine):
    """``dedup`` on the card: two amplicon positions of more than 1,024
    distinct UMIs, so K4 launched once a position group; records and the
    ``-m``/``-H`` files equal --device cpu's."""
    import chip_smoke

    inp = str(tmp_path / "amp.bam")
    chip_smoke.amplicon_bam(inp, positions=2, molecules=900, copies=3,
                            read_length=60, seed=6)
    files = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, "dedup", "-i", inp, "-o", f"d.{dev}.bam",
                 "--device", dev, "-m", f"m.{dev}.tsv", "-H", f"h.{dev}.tsv",
                 "--stats-json", f"d.{dev}.json", *engine)
        files[dev] = (_records(tmp_path / f"d.{dev}.bam"),
                      (tmp_path / f"m.{dev}.tsv").read_bytes(),
                      (tmp_path / f"h.{dev}.tsv").read_bytes())
    assert files["cuda"][0] and files["cuda"] == files["cpu"]
    stats = json.loads((tmp_path / "d.cuda.json").read_text())
    assert stats["launches"]["umi_hamming"] == 2
    assert stats["device_span"]["largest"][0] >= 1024


@pytest.mark.parametrize("flags", [[], ["--device-filter"]],
                         ids=["k1", "k1f"])
def test_injected_oom_halves_on_cuda(cuda_dev, tmp_path, flags):
    """``device.dispatch:oom:1.0:1`` on the card: the first batch halves
    (one split), both halves launch, and the records equal the clean
    run's."""
    _run_cli(tmp_path, "simulate", "grouped-reads", "-o", "in.bam",
             "--num-families", "300", "--family-size-distribution",
             "longtail", "--read-length", "150")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, fault in (("clean", None), ("oom", "device.dispatch:oom:1.0:1")):
        env = dict(os.environ, PYTHONPATH=root)
        if fault:
            env["FGUMI_TPU_FAULT"] = fault
        subprocess.run([sys.executable, "-m", "fgumi_tpu_torch", "simplex",
                        "-i", "in.bam", "-o", f"{name}.bam", "--min-reads",
                        "1", "--stats-json", f"{name}.json", *flags],
                       check=True, env=env, cwd=str(tmp_path), timeout=600)
    clean, oom = (json.loads((tmp_path / f"{n}.json").read_text())
                  for n in ("clean", "oom"))
    assert oom["device_stats"]["batch_splits"] == 1
    launched = sum(oom["launches"].values())
    assert launched == sum(clean["launches"].values()) + 1
    # the halves go through K1 on either route
    assert oom["launches"]["consensus_wire_full"] >= 2
    assert _records(tmp_path / "oom.bam") == _records(tmp_path / "clean.bam")


def test_injected_oom_duplex_joins_residents_on_cuda(cuda_dev, tmp_path):
    """``device.dispatch:oom:1.0:1`` on a duplex K1-r batch: its halves'
    resident arrays are joined on the card, so the strand combine runs on
    K5 over as many rows as in the clean run, and the records are equal."""
    _run_cli(tmp_path, "simulate", "duplex-reads", "-o", "in.bam",
             "--num-molecules", "2000", "--reads-per-strand", "3",
             "--read-length", "100", "--seed", "4")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, fault in (("clean", None), ("oom", "device.dispatch:oom:1.0:1")):
        env = dict(os.environ, PYTHONPATH=root)
        if fault:
            env["FGUMI_TPU_FAULT"] = fault
        subprocess.run([sys.executable, "-m", "fgumi_tpu_torch", "duplex",
                        "-i", "in.bam", "-o", f"{name}.bam", "--stats-json",
                        f"{name}.json"],
                       check=True, env=env, cwd=str(tmp_path), timeout=600)
    clean, oom = (json.loads((tmp_path / f"{n}.json").read_text())
                  for n in ("clean", "oom"))
    assert oom["device_stats"]["batch_splits"] == 1
    assert oom["launches"]["consensus_wire_resident"] == \
        clean["launches"]["consensus_wire_resident"] + 1
    assert oom["launches"]["duplex_combine"] == \
        clean["launches"]["duplex_combine"] > 0
    assert oom["combine_device_rows"] == clean["combine_device_rows"] > 0
    assert oom["combine_host_rows"] == clean["combine_host_rows"]
    assert _records(tmp_path / "oom.bam") == _records(tmp_path / "clean.bam")


_PIPE = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]


@pytest.fixture
def fastq_pair(cuda_dev, tmp_path):
    """2,500 families x 4 pairs of FASTQ: one all-unmapped position group
    of ~2,400 distinct 8-base UMIs, inside K4's dense range."""
    _run_cli(tmp_path, "simulate", "fastq-reads", "-1", "r1.fq.gz", "-2",
             "r2.fq.gz", "--num-families", "2500", "--family-size", "4",
             "--seed", "7")
    return tmp_path


def test_extract_and_sort_entry_points_on_cuda(fastq_pair):
    """``extract`` and template-coordinate ``sort`` (the native engine,
    spilling at 2,000 records a run) on the card's machine: the sorted
    output passes ``sort --verify`` and holds every extracted record."""
    d = fastq_pair
    _run_cli(d, "extract", "-i", "r1.fq.gz", "r2.fq.gz", "-o", "u.bam",
             *_PIPE)
    _run_cli(d, "sort", "-i", "u.bam", "-o", "s.bam",
             "--max-records-in-ram", "2000")
    _run_cli(d, "sort", "-i", "s.bam", "--verify")
    assert sorted(_records(d / "u.bam")) == sorted(_records(d / "s.bam"))
    assert len(_records(d / "s.bam")) == 20000


@pytest.mark.parametrize("flags", [[], ["--no-fuse"], ["--device-filter"]],
                         ids=["fused", "staged", "device_filter"])
def test_pipeline_entry_point_on_cuda(fastq_pair, flags):
    """``pipeline`` FASTQ to filtered consensus on the card: the group
    stage launched K4 and simplex K1 (K1-f under --device-filter), and the
    records equal --device cpu's and the fused run's."""
    d = fastq_pair
    for dev in ("cuda", "cpu"):
        _run_cli(d, "pipeline", "-i", "r1.fq.gz", "r2.fq.gz", *_PIPE, "-o",
                 f"p.{dev}.bam", "--device", dev, "--stats-json",
                 f"p.{dev}.json", *flags)
    got = _records(d / "p.cuda.bam")
    assert got and got == _records(d / "p.cpu.bam")
    st = json.loads((d / "p.cuda.json").read_text())
    assert st["fused"] == ("--no-fuse" not in flags)
    assert st["launches"]["umi_hamming"] >= 1
    kernel = ("consensus_wire_filter" if "--device-filter" in flags
              else "consensus_wire_full")
    assert st["launches"][kernel] >= 1
    for stage in ("extract", "sort", "group", "simplex"):
        assert st[f"pipeline.stage.{stage}.wall_s"] > 0
    if flags:
        _run_cli(d, "pipeline", "-i", "r1.fq.gz", "r2.fq.gz", *_PIPE, "-o",
                 "p.fused.bam", "--device", "cpu")
        assert got == _records(d / "p.fused.bam")


def _duplex_cuda_vs_cpu(tmp_path, flags):
    recs = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, "duplex", "-i", "dup.bam", "-o", f"d.{dev}.bam",
                 "--device", dev, "--stats-json", f"d.{dev}.json", *flags)
        recs[dev] = _records(tmp_path / f"d.{dev}.bam")
    assert recs["cuda"] and recs["cuda"] == recs["cpu"]
    return recs["cuda"], json.loads((tmp_path / "d.cuda.json").read_text())


@pytest.mark.parametrize("flags", [[], ["--classic"],
                                   ["--min-reads", "2", "1", "0"]],
                         ids=["fast", "classic", "min_reads_2_1_0"])
def test_duplex_entry_point_on_cuda(cuda_dev, tmp_path, flags):
    """``duplex`` on the card (both engines, a strand-biased input with
    single-strand molecules): every stage-1 batch launched K1 (classic) or
    K1-r (fast, whose eligible rows took K5) and the records equal
    --device cpu's."""
    _run_cli(tmp_path, "simulate", "duplex-reads", "-o", "dup.bam",
             "--num-molecules", "2000", "--strand-bias-alpha", "2",
             "--strand-bias-beta", "2", "--ba-fraction", "0.9")
    recs, st = _duplex_cuda_vs_cpu(tmp_path, flags)
    classic = "--classic" in flags
    assert st["engine"] == ("classic" if classic else "fast")
    assert st["device_batches"] >= 1
    k1 = ("consensus_wire_full" if classic else "consensus_wire_resident")
    assert st["launches"][k1] >= 1
    assert st["launches"][k1] + st["launches"]["consensus_wire_packed2"] \
        >= st["device_batches"]
    assert st["launches"]["packed2_full"] == 0
    if not classic:
        assert st["combine_device_rows"] > 0
        assert st["launches"]["duplex_combine"] >= 1


def test_duplex_device_filter_entry_point_on_cuda(cuda_dev, tmp_path):
    """``duplex --device-filter`` on the card equals ``duplex | filter``."""
    _run_cli(tmp_path, "simulate", "duplex-reads", "-o", "dup.bam",
             "--num-molecules", "1500")
    recs, st = _duplex_cuda_vs_cpu(tmp_path, ["--device-filter",
                                              "--filter-min-reads", "6,3,3"])
    _run_cli(tmp_path, "duplex", "-i", "dup.bam", "-o", "plain.bam")
    _run_cli(tmp_path, "filter", "-i", "plain.bam", "-o", "f.bam", "-M",
             "6,3,3")
    assert recs == _records(tmp_path / "f.bam")
    assert st["launches"]["consensus_wire_resident"] >= 1


@pytest.mark.parametrize("flags", [[], ["--classic"], ["--per-base-tags"]],
                         ids=["fast", "classic", "per_base_tags"])
def test_codec_entry_point_on_cuda(cuda_dev, tmp_path, flags):
    """``codec`` on the card: the records equal --device cpu's, stage 1
    launched K1 and the batch engine's combine K6."""
    _run_cli(tmp_path, "simulate", "codec-reads", "-o", "codec_in.bam",
             "--num-molecules", "2000", "--pairs-per-molecule", "2")
    recs = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, "codec", "-i", "codec_in.bam", "-o",
                 f"c.{dev}.bam", "--device", dev, "--stats-json",
                 f"c.{dev}.json", *flags)
        recs[dev] = _records(tmp_path / f"c.{dev}.bam")
    assert len(recs["cuda"]) == 2000 and recs["cuda"] == recs["cpu"]
    st = json.loads((tmp_path / "c.cuda.json").read_text())
    assert st["launches"]["consensus_wire_full"] >= 1
    classic = "--classic" in flags
    assert st["engine"] == ("classic" if classic else "fast")
    assert (st["launches"]["codec_combine"] >= 1) == (not classic)


def _meth_inputs(tmp_path, duplex: bool):
    """A seeded FASTA (ref.fa) and an EM-Seq library over it (in.bam /
    dup.bam), as chip_smoke.py makes them."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    ref = dict(contigs=2, length=20000, seed=49)
    chip_smoke.meth_reference(str(tmp_path / "ref.fa"), **ref)
    chip_smoke.methylation_bam(
        str(tmp_path / ("dup.bam" if duplex else "in.bam")), "em-seq",
        400 if duplex else 800, chip_smoke.meth_reference_seqs(**ref),
        duplex=duplex, templates=3 if duplex else 5, seed=3)


@pytest.mark.parametrize("mode", ["--em-seq", "--taps"])
def test_simplex_methylation_entry_point_on_cuda(cuda_dev, tmp_path, mode):
    """``simplex --em-seq|--taps --ref`` on the card: every group on the
    per-group path through K1, the records equal --device cpu's and carry
    MM/cu/ct."""
    _meth_inputs(tmp_path, duplex=False)
    stats = _cuda_vs_cpu(tmp_path, [mode, "--ref", "ref.fa",
                                    "--min-reads", "1"])
    assert stats["device_batches"] >= 1
    assert stats["launches"]["consensus_wire_full"] \
        + stats["launches"]["consensus_wire_packed2"] \
        >= stats["device_batches"]
    recs = _records(tmp_path / "cuda.bam")
    assert any(b"MMZ" in r for r in recs) and all(b"cuBs" in r
                                                  for r in recs)


@pytest.mark.parametrize("flags", [[], ["--classic"]],
                         ids=["fast", "classic"])
def test_duplex_methylation_entry_point_on_cuda(cuda_dev, tmp_path, flags):
    """``duplex --methylation-mode em-seq --ref`` on the card: the fast
    engine's per-molecule path (the host oracle) and ``--classic`` (K1)
    write the same records as --device cpu."""
    _meth_inputs(tmp_path, duplex=True)
    recs, st = _duplex_cuda_vs_cpu(tmp_path, [
        "--methylation-mode", "em-seq", "--ref", "ref.fa", "--min-reads",
        "1", *flags])
    if flags:
        assert st["launches"]["consensus_wire_full"] >= 1
    assert any(b"amZ" in r for r in recs)


@pytest.mark.parametrize("command", ["simplex", "duplex"])
def test_rejects_entry_point_on_cuda(cuda_dev, tmp_path, command):
    """``--rejects`` on the card: records and rejects equal --device
    cpu's."""
    if command == "simplex":
        _run_cli(tmp_path, "simulate", "grouped-reads", "-o", "in.bam",
                 "--num-families", "400", "--family-size-distribution",
                 "longtail")
    else:
        _run_cli(tmp_path, "simulate", "duplex-reads", "-o", "in.bam",
                 "--num-molecules", "400", "--ba-fraction", "0.9")
    got = {}
    for dev in ("cuda", "cpu"):
        _run_cli(tmp_path, command, "-i", "in.bam", "-o", f"{dev}.bam",
                 "--device", dev, "--min-reads", "2", "--rejects",
                 f"{dev}.r.bam")
        got[dev] = (_records(tmp_path / f"{dev}.bam"),
                    _records(tmp_path / f"{dev}.r.bam"))
    assert got["cuda"] == got["cpu"] and got["cuda"][0] and got["cuda"][1]


def test_mapped_front_half_entry_points_on_cuda(cuda_dev, tmp_path):
    """The mapped front half on the card: ``simulate correct-reads`` and
    ``fastq-reads`` from its list, ``extract``, ``correct`` (batch engine
    and ``--classic``: records, rejects and metrics identical), ``fastq``,
    ``chip_smoke.stand_in_align``, ``zipper`` (both engines identical),
    template-coordinate ``sort``, ``group`` on ``cuda`` and ``simplex`` on
    ``cuda`` (K1 launched) against ``--device cpu``."""
    import chip_smoke

    _run_cli(tmp_path, "simulate", "correct-reads", "-o", "cr.bam", "-i",
             "list.txt", "-n", "3000", "--num-umis", "200")
    got = {}
    for engine in ([], ["--classic"]):
        tag = "classic" if engine else "fast"
        _run_cli(tmp_path, "correct", "-i", "cr.bam", "-o", f"c.{tag}.bam",
                 "-U", "list.txt", "-r", f"r.{tag}.bam", "-m",
                 f"m.{tag}.tsv", *engine)
        got[tag] = (_records(tmp_path / f"c.{tag}.bam"),
                    _records(tmp_path / f"r.{tag}.bam"),
                    (tmp_path / f"m.{tag}.tsv").read_bytes())
    assert got["fast"][0] and got["fast"] == got["classic"]
    _run_cli(tmp_path, "simulate", "fastq-reads", "-1", "r1.fq.gz", "-2",
             "r2.fq.gz", "--num-families", "400", "--includelist",
             "list.txt")
    _run_cli(tmp_path, "extract", "-i", "r1.fq.gz", "r2.fq.gz", "-r",
             "8M+T", "+T", "--sample", "s", "--library", "l", "-o", "u.bam")
    _run_cli(tmp_path, "correct", "-i", "u.bam", "-o", "uc.bam", "-U",
             "list.txt")
    _run_cli(tmp_path, "fastq", "-i", "uc.bam", "-o", "reads.fq")
    chip_smoke.stand_in_align(str(tmp_path / "reads.fq"),
                              str(tmp_path / "aligned.bam"))
    for engine in ([], ["--classic"]):
        _run_cli(tmp_path, "zipper", "-i", "aligned.bam", "-u", "uc.bam",
                 "-o", f"z{len(engine)}.bam", *engine)
    assert _records(tmp_path / "z0.bam") == _records(tmp_path / "z1.bam")
    _run_cli(tmp_path, "sort", "-i", "z0.bam", "-o", "s.bam", "--order",
             "template-coordinate")
    _run_cli(tmp_path, "group", "-i", "s.bam", "-o", "in.bam", "-s",
             "adjacency", "--device", "cuda")
    stats = _cuda_vs_cpu(tmp_path, ["--min-reads", "1"])
    assert stats["launches"]["consensus_wire_full"] >= 1
