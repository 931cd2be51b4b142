"""Kernel-level parity of the PyTorch port's wire consensus with the JAX package.

Each numpy-seeded batch goes through (a) the port's plain ``wire_full`` (the
function the CUDA kernel computes, here on the CPU), (b) the JAX package's
XLA ``_consensus_segments_wire_full_jit`` and (c) its Pallas kernel in
interpret mode, with the same f32 dictionary on every side.

Tolerances, and why:

- depth and errors are integer lane counts: exact everywhere. The one
  exception is (b) at cells holding a nonfinite (Q0-class) dictionary entry:
  XLA's all-lane NaN picks a different pre-patch winner there, while the
  port and Pallas zero the entry and poison the cell. All sides flag those
  cells suspect.
- winner and qual are exact where neither side is suspect. The f32 lane sums
  are taken in a different order on each side, so the suspect SETS may
  differ, but the guard band holds for any summation order.
- after each side's f64 oracle patch (the port's ``_complete_wire_columns``
  vs ``ConsensusKernel._complete_wire_columns`` of the JAX package) all four
  planes are exact everywhere.

The >63-distinct-quals batch takes the packed2 layout instead, compared
with the JAX package's XLA ``_consensus_segments_packed2_full_jit`` (the
route has no Pallas kernel).
"""

import numpy as np
import pytest
import torch

from fgumi_tpu.ops import kernel as jk
from fgumi_tpu.ops import pallas_kernel as pk
from fgumi_tpu.ops.tables import quality_tables as jax_quality_tables
from fgumi_tpu_torch.ops import cuda_kernel, tables as ptables
from fgumi_tpu_torch.ops import wire as W
from fgumi_tpu_torch.ops.kernel import ConsensusKernel, pad_segments

JT = jax_quality_tables(45, 40)
PT = ptables.from_numpy(JT.adjusted_correct, JT.adjusted_error_per_alt,
                        JT.ln_error_pre_umi, 45, 40, JT.single_input_quals)


def _uniform(n_fam, fam, L, seed=None):
    rng = np.random.default_rng(n_fam * 7 + fam + L if seed is None
                                else seed)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    return codes, quals, np.full(n_fam, fam, dtype=np.int64)


def _stack(fams, L):
    codes = np.concatenate([c for c, _ in fams])
    quals = np.concatenate([q for _, q in fams])
    counts = np.array([c.shape[0] for c, _ in fams], dtype=np.int64)
    return codes, quals, counts


def _near_ties():
    """Half/half split votes with tiny qual jitter at several depths
    (tests/test_guard_band.py near-tie construction)."""
    rng = np.random.default_rng(0)
    fams = []
    for R in (2, 4, 16, 64):
        for _ in range(3):
            codes = np.zeros((R, 16), dtype=np.uint8)
            codes[R // 2:] = 1
            quals = np.full((R, 16), 30, dtype=np.uint8)
            for _ in range(int(rng.integers(0, 3))):
                r = int(rng.integers(R))
                quals[r] = np.clip(30 + rng.integers(-2, 3, size=16), 2, 93)
            fams.append((codes, quals))
    return _stack(fams, 16)


def _deep():
    """Depth-600 mixed pileups: the depth-aware band at its widest."""
    rng = np.random.default_rng(2)
    fams = []
    for frac_err in (0.0, 0.3, 0.49):
        truth = rng.integers(0, 4, size=(1, 16))
        codes = np.broadcast_to(truth, (600, 16)).copy()
        errs = rng.random((600, 16)) < frac_err
        codes[errs] = (codes[errs] + 1) % 4
        quals = rng.integers(8, 41, size=(600, 16)).astype(np.uint8)
        fams.append((codes.astype(np.uint8), quals))
    return _stack(fams, 16)


def _boundary_mix():
    """Noisy families with quals 5-44: Phred values near integer
    boundaries (tests/test_guard_band.py mining population)."""
    rng = np.random.default_rng(1)
    fams = []
    for _ in range(24):
        R = int(rng.integers(2, 12))
        truth = rng.integers(0, 4, size=(1, 32))
        codes = np.broadcast_to(truth, (R, 32)).copy()
        errs = rng.random((R, 32)) < 0.15
        codes[errs] = rng.integers(0, 4, size=int(errs.sum()))
        quals = rng.integers(5, 45, size=(R, 32)).astype(np.uint8)
        fams.append((codes.astype(np.uint8), quals))
    return _stack(fams, 32)


def _q0():
    """A Q0 observation: its dictionary entry is -inf."""
    codes, quals, counts = _uniform(9, 4, 32, seed=11)
    quals[::5, ::7] = 0
    return codes, quals, counts


def _many_quals():
    """> 63 distinct quals: the packed2 layout."""
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 5, size=(60, 48), dtype=np.uint8)
    quals = rng.integers(2, 94, size=(60, 48), dtype=np.uint8)
    return codes, quals, np.array([1, 3, 5, 7, 9, 11, 24], dtype=np.int64)


CASES = {
    "uniform_7x3x48": lambda: _uniform(7, 3, 48),
    "uniform_65x3x100": lambda: _uniform(65, 3, 100),
    "uniform_129x2x48": lambda: _uniform(129, 2, 48),
    "uniform_4x40x32": lambda: _uniform(4, 40, 32),
    "near_ties": _near_ties,
    "deep_600": _deep,
    "boundary_mix": _boundary_mix,
    "q0_neg_inf_entry": _q0,
}


def _dev_planes(qs, wp, d, e, J):
    """Raw (pre-patch) planes from a full-column fetch."""
    winner, qual, suspect = W.unpack_result_split(np.asarray(qs),
                                                  np.asarray(wp), J)
    return (winner, qual, suspect,
            np.asarray(d).view(np.uint16).astype(np.int64),
            np.asarray(e).view(np.uint16).astype(np.int64))


def _port_full(codes, quals, starts):
    kern = ConsensusKernel(PT, "cpu")
    w = W.build_wire(torch.from_numpy(codes), torch.from_numpy(quals),
                     kern._delta94)
    assert w is not None
    wire, dict64 = w
    J = len(starts) - 1
    out = cuda_kernel.consensus_wire_full(
        wire, torch.from_numpy(starts.astype(np.int32)), dict64, kern._pre)
    return kern, wire.numpy(), dict64.numpy(), [t.numpy() for t in out]


def _jax_resolve(fetched, codes, quals, starts):
    kern = jk.ConsensusKernel(JT)
    qs, wp, d, e = (np.asarray(a) for a in fetched)
    return kern._complete_wire_columns(qs, wp, d, e, codes, quals, starts)


def _assert_raw(port, other, starts, label, poisoned=None):
    pw, pq, ps, pd, pe = port
    ow, oq, osus, od, oe = other
    np.testing.assert_array_equal(pd, od, err_msg=f"{label}: depth")
    exact_e = np.ones_like(pe, dtype=bool) if poisoned is None else ~poisoned
    np.testing.assert_array_equal(pe[exact_e], oe[exact_e],
                                  err_msg=f"{label}: errors")
    if poisoned is not None:
        assert ps[poisoned].all() and osus[poisoned].all()
    clean = ~ps & ~osus
    np.testing.assert_array_equal(pw[clean], ow[clean],
                                  err_msg=f"{label}: winner")
    np.testing.assert_array_equal(pq[clean], oq[clean],
                                  err_msg=f"{label}: qual")


def _assert_resolved(a, b, label):
    for name, x, y in zip("wqde", a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{label}: plane {name}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_wire_full_matches_xla_and_pallas(case):
    _hold_against_jax(*CASES[case]())


# ragged reads of 1-80 rows (the patterns of test_torch_wire_filter.py) at
# L 36 (several 32-column strips, the last 4 wide) and 152 (the main
# path's), with Q0-class observations on one pattern
RAGGED = [(1, 2, 5), (80, 1, 3), (2, 50, 7, 1), (33, 4, 64, 2),
          (1, 1, 1, 79), (5, 17, 41, 80, 3)]
RAGGED_CASES = [(counts, L, counts == RAGGED[3])
                for counts in RAGGED for L in (36, 152)]


@pytest.mark.parametrize(
    "counts,L,q0", RAGGED_CASES,
    ids=[f"rows{'-'.join(map(str, c))}_L{L}" + ("_q0" if q0 else "")
         for c, L, q0 in RAGGED_CASES])
def test_wire_full_ragged_matches_xla_and_pallas(counts, L, q0):
    counts = np.asarray(counts, dtype=np.int64)
    rng = np.random.default_rng(int(counts.sum()) * 31 + L)
    N = int(counts.sum())
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(15, 41, size=(N, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    _hold_against_jax(codes, quals, counts)


def _hold_against_jax(codes, quals, counts):
    """The port's K1 route (its wrapper on CPU tensors: the plain version)
    against XLA and Pallas-interpret on one batch."""
    codes, quals, starts = pad_segments(codes, quals, counts)
    J = len(counts)
    launches = cuda_kernel.LAUNCHES
    kern, wire, dict64, port_out = _port_full(codes, quals, starts)
    assert cuda_kernel.LAUNCHES == launches  # the plain route
    port_raw = _dev_planes(*port_out, J)
    seg_ids = np.repeat(np.arange(J, dtype=np.int32), counts)

    # the dictionaries are the same f32 values on both sides
    j_wire, j_dict = jk.build_wire(codes, quals,
                                   jk.ConsensusKernel(JT)._delta94)
    np.testing.assert_array_equal(wire, j_wire)
    np.testing.assert_array_equal(dict64, j_dict)

    xla = [np.asarray(a) for a in jk._consensus_segments_wire_full_jit(
        wire, seg_ids, dict64, np.float32(JT.ln_error_pre_umi), J, J)]
    prep = pk._prepare(wire, seg_ids, dict64, J)
    fn = pk._full_jit(J, prep.s_tiles, prep.w_tiles, True)
    pallas = [np.asarray(a) for a in fn(
        prep.wire_p, prep.seg2d, prep.base, prep.cnt, prep.dictbits,
        pk._prebits(np.float32(JT.ln_error_pre_umi)))]

    # XLA's NaN differs pre-patch only at cells holding a Q0 observation
    obs_q0 = (quals == 0) & (codes != 4)
    poisoned = np.add.reduceat(obs_q0.astype(np.int32), starts[:-1],
                               axis=0) > 0
    _assert_raw(port_raw, _dev_planes(*xla, J), starts, "vs xla",
                poisoned if poisoned.any() else None)
    _assert_raw(port_raw, _dev_planes(*pallas, J), starts, "vs pallas")

    port_res = kern._complete_wire_columns(
        port_out[0], port_out[1], port_out[2].view(np.uint16),
        port_out[3].view(np.uint16), codes, quals, starts)
    _assert_resolved(port_res, _jax_resolve(xla, codes, quals, starts),
                     "resolved vs xla")
    _assert_resolved(port_res, _jax_resolve(pallas, codes, quals, starts),
                     "resolved vs pallas")


def test_packed2_matches_xla():
    """>63 distinct quals: the port's packed2 route vs the XLA one, and
    the full dispatch path takes it."""
    codes, quals, counts = _many_quals()
    codes, quals, starts = pad_segments(codes, quals, counts)
    J = len(counts)
    assert W.build_wire(torch.from_numpy(codes), torch.from_numpy(quals),
                        torch.zeros(94)) is None
    seg_ids = np.repeat(np.arange(J, dtype=np.int32), counts)
    cp, qsent = W.pack_codes2(torch.from_numpy(codes),
                              torch.from_numpy(quals))
    j_cp, j_q = jk.pack_codes2(codes, quals)
    np.testing.assert_array_equal(cp.numpy(), j_cp)
    np.testing.assert_array_equal(qsent.numpy(), j_q)
    correct = torch.from_numpy(np.asarray(PT.adjusted_correct, np.float32))
    err = torch.from_numpy(np.asarray(PT.adjusted_error_per_alt, np.float32))
    port = [t.numpy() for t in W.packed2_full(
        cp, qsent, torch.from_numpy(seg_ids).long(), correct, err,
        np.float32(PT.ln_error_pre_umi), J, J)]
    xla = [np.asarray(a) for a in jk._consensus_segments_packed2_full_jit(
        j_cp, j_q, seg_ids, correct.numpy(), err.numpy(),
        np.float32(JT.ln_error_pre_umi), J, J)]
    _assert_raw(_dev_planes(*port, J), _dev_planes(*xla, J), starts,
                "packed2 vs xla")
    kern = ConsensusKernel(PT, "cpu")
    dev = kern.device_call_segments_wire(codes, quals, starts)
    port_res = kern.resolve_segments_wire(dev, codes, quals, starts)
    _assert_resolved(port_res, _jax_resolve(xla, codes, quals, starts),
                     "packed2 resolved vs xla")


def test_tables_conversion_is_identity():
    """from_numpy of the JAX package's tables gives the port's own tables:
    identical f64 arrays and the identical f32 dictionary source."""
    own = ptables.quality_tables(45, 40)
    np.testing.assert_array_equal(own.adjusted_correct, PT.adjusted_correct)
    np.testing.assert_array_equal(own.adjusted_error_per_alt,
                                  PT.adjusted_error_per_alt)
    np.testing.assert_array_equal(own.single_input_quals,
                                  JT.single_input_quals)
    assert own.ln_error_pre_umi == JT.ln_error_pre_umi
    np.testing.assert_array_equal(ptables.delta94(own),
                                  jk.ConsensusKernel(JT)._delta94)
