"""The CUDA wire kernels (K1 and the fused consensus→filter K1-f) against
their plain PyTorch versions, on the card.

Marked ``gpu``: each test decides at run time whether a CUDA device is
present and skips otherwise. On a machine with one (and ``nvcc``), without
JAX installed:

    python -m pytest --noconftest tests/test_torch_cuda.py

Both kernels run one design (a warp per consensus read on a persistent
grid, rows staged whole or in 32-column strips of row chunks), so each
tiling edge is a case of one test for both. The last tests also drive
``python -m fgumi_tpu_torch simplex`` (the fast engine, with and without
``--device-filter``) on the card.

Tolerances: depth and errors exact; winner and qual (K1), and the stats
columns 0-5 and the masked columns within the read length (K1-f), exact
where neither side is suspect (the f32 sums run in different orders, so the
suspect sets may differ); every plane exact after the f64 oracle patch, and
every K1-f row equal to the host filter twin over the patched columns.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fgumi_tpu_torch.consensus.device_filter import SimplexFilterStage
from fgumi_tpu_torch.consensus.filter import FilterConfig
from fgumi_tpu_torch.io.bam import BamReader
from fgumi_tpu_torch.ops import cuda_kernel, oracle
from fgumi_tpu_torch.ops import wire as W
from fgumi_tpu_torch.ops.kernel import ConsensusKernel
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
KERNELS = ("full", "filter")
GEOMETRY = {"full": cuda_kernel.full_launch_geometry,
            "filter": cuda_kernel.filter_launch_geometry}


def _hold(kernel, cuda_dev, codes, quals, counts, lens):
    """K1 or K1-f (per-base masks and the quality mask on) against its
    plain version on one batch."""
    if kernel == "full":
        _hold_full_kernel(cuda_dev, codes, quals, counts)
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
    """The launch's geometry: 8 warps a block, a slice of 2-6 KB a warp,
    resident blocks from the occupancy query, the dynamic shared memory
    above 48 KB at wide rows."""
    geometry = GEOMETRY[kernel]
    for L, slice_bytes in ((4, 2048), (152, 2432), (336, 5376), (380, 6080),
                           (2048, 6144)):
        geo = geometry(L, 10 ** 6, cuda_dev)
        assert geo["warps_per_block"] == 8
        assert geo["slice_bytes"] == slice_bytes
        assert geo["shared_bytes"] == 8 * (slice_bytes + 16)
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
