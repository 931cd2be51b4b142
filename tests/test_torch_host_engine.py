"""The port's native f64 host engine (``fgumi_tpu_torch/ops/host_kernel.py``
over ``native/fgumi_native.cc`` ``fgumi_consensus_segments``) against the
JAX package's engine and the f64 oracle, exactly.

Each case is a ragged batch of read rows; the port's engine must give the
JAX package's (winner, qual, depth, errors) and slow-position count, and
every family must equal the port's oracle ``call_family``: depth-1 and
depth-2 pileups (the lookup tables), saturated columns (the quick-path
constant), the borderline band around the saturation gap, ties, Q0
observations (the Kahan -inf/NaN flows), and a batch with more slow
positions than the first buffers hold (the ``slow_cap`` retry). The JAX
package's native library is built from its source into a pytest temporary
directory (``tests/jax_native_build.py``)."""

import numpy as np
import pytest

import fgumi_tpu.native.batch as jax_nb
from fgumi_tpu.ops.host_kernel import HostConsensusEngine as JaxEngine
from fgumi_tpu.ops.tables import quality_tables as jax_tables
from fgumi_tpu_torch.native import batch as port_nb
from fgumi_tpu_torch.ops import oracle
from fgumi_tpu_torch.ops.host_kernel import HostConsensusEngine
from fgumi_tpu_torch.ops.tables import quality_tables

from jax_native_build import build_jax_native, use_jax_native


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    return build_jax_native(tmp_path_factory.mktemp("host_engine_native"))


@pytest.fixture(autouse=True)
def _jax_native(monkeypatch, jax_lib):
    use_jax_native(monkeypatch, jax_lib)


def _segments(counts, L, rng, pool=None, codes_hi=5):
    counts = np.asarray(counts, dtype=np.int64)
    starts = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
    n = int(starts[-1])
    codes = rng.integers(0, codes_hi, size=(n, L)).astype(np.uint8)
    if pool is None:
        quals = rng.integers(0, 94, size=(n, L)).astype(np.uint8)
    else:
        quals = np.asarray(pool, np.uint8)[rng.integers(0, len(pool),
                                                        size=(n, L))]
    return codes, quals, starts


def _depth1():
    b = np.repeat(np.arange(4, dtype=np.uint8), 94)[:, None]
    q = np.tile(np.arange(94, dtype=np.uint8), 4)[:, None]
    return b, q, np.arange(377, dtype=np.int64)


def _depth2():
    pairs = [(b1, q1, b2, q2) for b1 in range(4) for b2 in range(4)
             for q1 in (1, 2, 17, 40, 93) for q2 in (1, 30, 93)]
    codes = np.array([[p[0], p[2]] for p in pairs],
                     dtype=np.uint8).reshape(-1, 1)
    quals = np.array([[p[1], p[3]] for p in pairs],
                     dtype=np.uint8).reshape(-1, 1)
    return codes, quals, (np.arange(len(pairs) + 1) * 2).astype(np.int64)


def _saturated():
    # unanimous high-quality families: every column takes the quick path
    rng = np.random.default_rng(11)
    codes, quals, starts = _segments([5, 8, 12, 3], 30, rng,
                                     pool=[35, 38, 40])
    for lo, hi in zip(starts[:-1], starts[1:]):
        codes[lo:hi] = codes[lo]
    return codes, quals, starts


def _borderline():
    # unanimous low quals at depths 2..6 straddle the saturation gap
    segs = [(d, q) for d in range(2, 7) for q in range(2, 30)]
    starts = np.concatenate(([0], np.cumsum([d for d, _ in segs])))
    codes = np.zeros((int(starts[-1]), 3), dtype=np.uint8)
    quals = np.concatenate([np.full((d, 3), q, dtype=np.uint8)
                            for d, q in segs])
    return codes, quals, starts.astype(np.int64)


def _tie():
    # two bases at equal quality and count: the first-max rule, no-call
    rows = []
    for q in (10, 20, 30, 40):
        rows += [(0, q), (1, q), (2, q), (3, q)]
        rows += [(1, q), (2, q)]
        rows += [(0, q), (0, q), (3, q), (3, q)]
    codes = np.array([b for b, _ in rows], dtype=np.uint8)[:, None]
    quals = np.array([q for _, q in rows], dtype=np.uint8)[:, None]
    counts = [4, 2, 4] * 4
    return codes, quals, np.concatenate(([0], np.cumsum(counts))).astype(
        np.int64)


def _q0():
    layouts = [[(0, 0), (0, 30)], [(0, 30), (0, 0)],
               [(0, 30), (0, 0), (0, 30)], [(0, 0), (0, 0)],
               [(0, 0), (1, 30), (2, 30)], [(1, 30), (0, 0), (1, 35)]]
    codes = np.array([b for lay in layouts for b, _ in lay],
                     dtype=np.uint8)[:, None]
    quals = np.array([q for lay in layouts for _, q in lay],
                     dtype=np.uint8)[:, None]
    counts = [len(x) for x in layouts]
    return codes, quals, np.concatenate(([0], np.cumsum(counts))).astype(
        np.int64)


def _slow_cap_overflow():
    # 5,000 two-read Q0 columns: every position slow, past the first
    # buffers' max(4096, J*L/8) entries, so the wrapper retries larger
    codes = np.zeros((2, 5000), dtype=np.uint8)
    codes[1] = 1
    quals = np.zeros((2, 5000), dtype=np.uint8)
    return codes, quals, np.array([0, 2], dtype=np.int64)


def _adversarial():
    rng = np.random.default_rng(7)
    return _segments(rng.integers(1, 9, size=11), 37, rng,
                     pool=[0, 0, 1, 1, 2, 3, 5, 10, 20, 30, 40, 60, 93, 94,
                           255])


CASES = {"depth1": _depth1, "depth2": _depth2, "saturated": _saturated,
         "borderline": _borderline, "tie": _tie, "q0": _q0,
         "slow_cap_overflow": _slow_cap_overflow,
         "adversarial": _adversarial}


@pytest.mark.parametrize("rates", [(45, 40), (30, 10), (93, 93)],
                         ids=lambda r: f"{r[0]}-{r[1]}")
@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_equals_jax_engine_and_oracle(case, rates):
    codes, quals, starts = CASES[case]()
    port = HostConsensusEngine(quality_tables(*rates))
    jax = JaxEngine(jax_tables(*rates))
    got = port.call_segments_counted(codes, quals, starts)
    want = jax.call_segments_counted(codes, quals, starts)
    for name, a, b in zip(("winner", "qual", "depth", "errors", "slow"),
                          got, want):
        np.testing.assert_array_equal(a, b, err_msg=f"{case}: {name}")
    assert got[2].dtype == np.int32 and got[3].dtype == np.int32
    for f in range(len(starts) - 1):
        lo, hi = starts[f], starts[f + 1]
        ow, oq, od, oe = oracle.call_family(codes[lo:hi], quals[lo:hi],
                                            port.tables)
        for name, a, b in zip(("winner", "qual", "depth", "errors"),
                              got[:4], (ow, oq, od, oe)):
            np.testing.assert_array_equal(a[f], b,
                                          err_msg=f"{case} family {f}")
    if case in ("borderline", "q0", "slow_cap_overflow"):
        assert got[4] > 0
    if case == "slow_cap_overflow":
        assert got[4] == 5000 > 4096


def test_native_export_equals_jax_native():
    """``consensus_segments`` (the wrapper and its C export) against the
    JAX package's: the resolved columns and the slow positions' sums and
    counts, bit for bit."""
    rng = np.random.default_rng(5)
    codes, quals, starts = _segments(rng.integers(1, 7, size=9), 24, rng)
    t = quality_tables(45, 40)
    eng = HostConsensusEngine(t)
    eng._build_tables()
    args = (codes, quals, starts, t.adjusted_correct,
            t.adjusted_error_per_alt, eng.g_sat, eng.qual_const, 2,
            eng._tab1[0], eng._tab1[1], eng._tab2[0], eng._tab2[1])
    got = port_nb.consensus_segments(*args)
    want = jax_nb.consensus_segments(*args)
    # the slow positions' columns are left for the oracle epilogue (not
    # written by the export): compare the resolved ones and the slow lists
    for a, b in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(a, b)
    resolved = np.ones(got[0].size, dtype=bool)
    resolved[got[4]] = False
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a.ravel()[resolved],
                                      b.ravel()[resolved])
    assert len(got[4]) > 0 and resolved.any()
