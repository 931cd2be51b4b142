"""The duplex device strand combine: K1-r's plain version and K5 against the
JAX package, and ``duplex`` records with rows routed to each combine.

- K1-r (``ops/wire.wire_resident``, through its wrapper on CPU tensors)
  against the JAX package's XLA ``_wire_resident_fn``: depth, errors and
  obs exact everywhere; winner, qual, tb and tq exact where neither side
  is suspect (the f32 lane sums are taken in another order on each side,
  so the suspect sets may differ; the guard band holds for any order), and
  tb/tq equal the consensus thresholds over the port's own planes
  everywhere.
- K5 (``ops/combine.duplex_combine``) against the JAX package's
  ``_duplex_combine_jit`` and the port's numpy ``combine_rows_host`` on the
  same rows: exact (integer arithmetic), including the error recount from
  obs against the host recount over the source rows at a depth of 600
  rows.
- ``duplex --device cpu`` against ``fgumi_tpu duplex --devices 1`` with
  rows on both routes: suspect positions and single-read strands (host),
  a packed2 batch (no resident arrays: host), a 65,539-read strand family
  (K1 with the host recount: host), the rest through K5; every resident
  handle released at the end.
"""

import json

import numpy as np
import pytest
import torch

import fgumi_tpu.native as jax_native
import fgumi_tpu.native.batch as jax_native_batch
from fgumi_tpu.cli import main as jax_main
from fgumi_tpu.ops import kernel as jk
from fgumi_tpu.ops.tables import quality_tables as jax_quality_tables
from fgumi_tpu_torch.cli import main as port_main
from fgumi_tpu_torch.consensus.fast_duplex import combine_rows_host
from fgumi_tpu_torch.constants import MIN_PHRED, N_CODE
from fgumi_tpu_torch.io import bgzf as BG
from fgumi_tpu_torch.io.bam import BamReader, BamWriter
from fgumi_tpu_torch.ops import combine as C
from fgumi_tpu_torch.ops import cuda_kernel, kernel as pk_mod
from fgumi_tpu_torch.ops import tables as ptables
from fgumi_tpu_torch.ops import wire as W
from fgumi_tpu_torch.ops.kernel import ConsensusKernel, pad_segments
from fgumi_tpu_torch.simulate import simulate_duplex_bam

JT = jax_quality_tables(45, 40)
PT = ptables.from_numpy(JT.adjusted_correct, JT.adjusted_error_per_alt,
                        JT.ln_error_pre_umi, 45, 40, JT.single_input_quals)


@pytest.fixture(autouse=True)
def no_jax_native(monkeypatch):
    """The JAX package's native library is never loaded here."""
    monkeypatch.setattr(jax_native, "get_lib", lambda: None)
    monkeypatch.setattr(jax_native_batch, "get_lib", lambda: None)


# ------------------------------------------------------------------- K1-r

def _batch(counts, L, seed, q0=False, qlo=15, err_rate=0.2):
    counts = np.asarray(counts, dtype=np.int64)
    rng = np.random.default_rng(seed)
    N = int(counts.sum())
    # families near a truth, so most positions call a base and some fall
    # below the thresholds
    truth = rng.integers(0, 4, size=(len(counts), L))
    codes = np.repeat(truth, counts, axis=0).astype(np.uint8)
    err = rng.random((N, L)) < err_rate
    codes[err] = rng.integers(0, 5, size=int(err.sum()))
    quals = rng.integers(qlo, 41, size=(N, L)).astype(np.uint8)
    if q0:
        quals[::5, ::7] = 0
    return pad_segments(codes, quals, counts)


def _resident(codes, quals, starts, min_reads, min_qual):
    kern = ConsensusKernel(PT, "cpu")
    wire, dict64 = W.build_wire(torch.from_numpy(codes),
                                torch.from_numpy(quals), kern._delta94)
    launches = cuda_kernel.RESIDENT_LAUNCHES
    out = cuda_kernel.consensus_wire_resident(
        wire, torch.from_numpy(starts.astype(np.int32)), dict64, kern._pre,
        min_reads, min_qual)
    assert cuda_kernel.RESIDENT_LAUNCHES == launches  # the plain route
    return wire.numpy(), dict64.numpy(), kern, [t.numpy() for t in out]


def _planes(qs, wp, d, e, J):
    winner, qual, suspect = W.unpack_result_split(np.asarray(qs),
                                                  np.asarray(wp), J)
    return (winner, qual, suspect,
            np.asarray(d).view(np.uint16).astype(np.int64),
            np.asarray(e).view(np.uint16).astype(np.int64))


RESIDENT_CASES = [
    ("uniform_40x3x128", [3] * 40, 128, False, 1, 40),
    ("ragged_L36", [1, 2, 5, 80, 3, 33, 4, 64, 2], 36, False, 2, 30),
    ("min_reads_3", [2, 3, 4, 5, 6, 3, 2], 48, False, 3, 45),
    ("q0_entries", [4] * 9, 32, True, 1, 40),
    ("deep_600", [600, 600, 300], 16, False, 1, 40),
    # uniform random bases and quals 2-40 (almost every column with a
    # disagreement), and two-row families of main-path data (most columns'
    # combine takes the full branch)
    ("uniform_3x128", [3] * 40, 128, False, 1, 30),
    ("two_row_128", [2] * 60, 128, False, 2, 40),
]
# _batch's data where a case is not a family near a truth with quals 15-40
# (0-40 with Q0 entries)
RESIDENT_DATA = {"uniform_3x128": dict(err_rate=1.0, qlo=2),
                 "two_row_128": dict(err_rate=0.01, qlo=30)}


@pytest.mark.parametrize("name,counts,L,q0,min_reads,min_qual",
                         RESIDENT_CASES, ids=[c[0] for c in RESIDENT_CASES])
def test_wire_resident_matches_xla(name, counts, L, q0, min_reads,
                                   min_qual):
    codes, quals, starts = _batch(
        counts, L, seed=len(name) + L, q0=q0,
        **RESIDENT_DATA.get(name, dict(qlo=0 if q0 else 15)))
    J = len(counts)
    wire, dict64, _, port = _resident(codes, quals, starts, min_reads,
                                      min_qual)
    seg_ids = np.repeat(np.arange(J, dtype=np.int32), counts)
    xla = [np.asarray(a) for a in jk._consensus_segments_wire_resident_jit(
        wire, seg_ids, dict64, np.float32(JT.ln_error_pre_umi), min_reads,
        min_qual, J, J)]
    pw, pq, ps, pd, pe = _planes(*port[:4], J)
    xw, xq, xs, xd, xe = _planes(*xla[:4], J)
    np.testing.assert_array_equal(pd, xd)
    np.testing.assert_array_equal(port[6], xla[6])  # obs
    assert port[6].dtype == np.int32 and port[6].shape == (J, L, 4)
    np.testing.assert_array_equal(port[6].sum(-1), pd)
    # XLA's all-lane NaN moves its pre-patch winner at Q0 cells (both
    # sides flag them)
    poisoned = np.add.reduceat(((quals == 0) & (codes != 4)).astype(int),
                               starts[:-1], axis=0) > 0
    np.testing.assert_array_equal(pe[~poisoned], xe[~poisoned])
    clean = ~ps & ~xs
    assert clean.mean() > 0.75
    for a, b in ((pw, xw), (pq, xq), (port[4], xla[4]), (port[5], xla[5])):
        np.testing.assert_array_equal(a[clean], b[clean])
    # tb/tq are the thresholds over the port's own pre-patch planes (the
    # packed winner cannot say N, so tb is checked where it is known)
    low_d, low_q = pd < min_reads, pq < min_qual
    low = low_d | low_q
    known = ~ps & (pd > 0)
    np.testing.assert_array_equal(port[4][known],
                                  np.where(low, N_CODE, pw)[known])
    np.testing.assert_array_equal(port[4][low], N_CODE)
    np.testing.assert_array_equal(
        port[5], np.where(low_d, 0, np.where(low_q, MIN_PHRED, pq)))
    assert (~low).any() and (low.any() or name == "deep_600")
    # K1's planes are K1-r's first four
    full = [t.numpy() for t in cuda_kernel.consensus_wire_full(
        torch.from_numpy(wire), torch.from_numpy(starts.astype(np.int32)),
        torch.from_numpy(dict64), np.float32(PT.ln_error_pre_umi))]
    for a, b in zip(full, port[:4]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- K5

def _combine_inputs(counts, L, seed, K):
    codes, quals, starts = _batch(counts, L, seed)
    _, _, _, port = _resident(codes, quals, starts, 1, 30)
    rng = np.random.default_rng(seed)
    J = len(counts)
    a = rng.integers(0, J, size=K).astype(np.int32)
    b = rng.integers(0, J, size=K).astype(np.int32)
    lens = rng.integers(0, L + 1, size=K).astype(np.int32)
    lens[:3] = (L, 0, 1)
    return codes, starts, port, a, b, lens


@pytest.mark.parametrize("counts,L,K", [
    ([3] * 60, 128, 90), ([2, 5, 1, 7, 3, 3, 40, 2], 48, 31),
    ([600, 2, 600, 300], 16, 12)], ids=["3x60_L128", "ragged_L48",
                                        "deep_600_L16"])
def test_duplex_combine_matches_jax_and_host(counts, L, K):
    codes, starts, port, a, b, lens = _combine_inputs(counts, L,
                                                      seed=K + L, K=K)
    tb, tq, obs = port[4], port[5], port[6]
    launches = C.DUPLEX_COMBINE_LAUNCHES
    got = [t.numpy() for t in C.duplex_combine(
        torch.from_numpy(tb), torch.from_numpy(tq), torch.from_numpy(obs),
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(lens))]
    assert C.DUPLEX_COMBINE_LAUNCHES == launches  # CPU tensors
    assert [g.dtype for g in got] == [np.uint8, np.uint8, np.int32]
    want = [np.asarray(x) for x in jk._duplex_combine_jit(
        tb, tq, obs, a, b, lens, K)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    host = combine_rows_host(tb, tq, codes, starts, a, b, lens)
    for g, h in zip(got, host):
        np.testing.assert_array_equal(g, h)
    assert (got[2] > 0).any() and (got[0] == N_CODE).any()
    # the dispatch helper: index upload, combine, fetch
    res = pk_mod.ResidentHandles(tuple(torch.from_numpy(x)
                                       for x in (tb, tq, obs)))
    live = pk_mod.LIVE_RESIDENTS
    for g, d in zip(got, pk_mod.duplex_combine_device(res, a, b, lens)):
        np.testing.assert_array_equal(g, d)
    res.release()
    res.release()
    assert pk_mod.LIVE_RESIDENTS == live - 1


@pytest.mark.parametrize("lens_kind", ["zero", "past_Lp", "mixed"])
def test_duplex_combine_edges_match_jax(lens_kind):
    """K5's length edges against ``_duplex_combine_jit``, exactly: rows of
    length 0 are 0 in every output, and a length past the resident width
    (up to Lp + 8) combines the whole row, as length Lp does."""
    L, K = 32, 60
    codes, starts, port, a, b, lens = _combine_inputs([3] * 40, L, seed=5,
                                                      K=K)
    tb, tq, obs = port[4], port[5], port[6]
    k = np.arange(K)
    full = np.full(K, L, dtype=np.int32)
    if lens_kind == "zero":
        lens = np.zeros(K, dtype=np.int32)
    elif lens_kind == "past_Lp":
        lens = (L + 1 + k % 8).astype(np.int32)
    else:
        lens = np.where(k % 3 == 0, 0, np.where(k % 3 == 1, L + 8, lens))
        lens = lens.astype(np.int32)
    def port(lens):
        return [t.numpy() for t in C.duplex_combine(*(
            torch.from_numpy(x) for x in (tb, tq, obs, a, b, lens)))]

    got = port(lens)
    want = [np.asarray(x) for x in jk._duplex_combine_jit(
        tb, tq, obs, a, b, lens, K)]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    whole = port(full)
    for g, w in zip(got, whole):
        zero = lens == 0
        np.testing.assert_array_equal(g[zero], 0)
        np.testing.assert_array_equal(g[lens > L], w[lens > L])
    if lens_kind != "zero":
        assert (got[2] > 0).any() and (got[0] == N_CODE).any()


# ------------------------------------------------------------ end to end

def _records(path):
    with BamReader(path) as r:
        return r.header.text, [rec.data for rec in r]


def _no_pg(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


def _run_pair(inp, tmp_path, flags):
    """Both CLIs on ``inp`` (the port's fast engine on CPU tensors):
    the port's stats."""
    ref = str(tmp_path / "jax.bam")
    got = str(tmp_path / "port.bam")
    assert jax_main(["duplex", "-i", inp, "-o", ref, "--devices", "1",
                     *flags]) == 0
    stats = tmp_path / "stats.json"
    live = pk_mod.LIVE_RESIDENTS
    assert port_main(["duplex", "-i", inp, "-o", got, "--device", "cpu",
                      "--stats-json", str(stats), *flags]) == 0
    assert pk_mod.LIVE_RESIDENTS == live
    h_ref, r_ref = _records(ref)
    h_got, r_got = _records(got)
    assert r_got == r_ref and len(r_got) > 0
    assert _no_pg(h_got) == _no_pg(h_ref)
    return json.loads(stats.read_text())


@pytest.fixture(scope="module")
def duplex_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("resident")
    plain = str(d / "plain.bam")
    simulate_duplex_bam(plain, num_molecules=500, reads_per_strand=3,
                        seed=21)
    bias = str(d / "bias.bam")
    simulate_duplex_bam(bias, num_molecules=200, reads_per_strand=3,
                        seed=22, ba_fraction=0.9, strand_bias_alpha=2.0,
                        strand_bias_beta=2.0)
    # molecules 0-9 with quals drawn from 2-93: their batch has more than
    # 63 distinct quals and takes the packed2 layout
    many = str(d / "many_quals.bam")
    rng = np.random.default_rng(23)
    with BamReader(plain) as r:
        header = r.header
        recs = [x for x in r]
    with BamWriter(many, header) as w:
        for i, rec in enumerate(recs):
            data = bytearray(rec.data)
            if i < 120:
                o = rec._qual_off()
                data[o:o + rec.l_seq] = rng.integers(
                    2, 94, size=rec.l_seq).astype(np.uint8).tobytes()
            w.write_record_bytes(bytes(data))
    return {"plain": plain, "bias": bias, "many_quals": many}


def test_suspect_rows_take_the_host_combine(duplex_inputs, tmp_path):
    st = _run_pair(duplex_inputs["plain"], tmp_path, [])
    assert st["suspect_positions"] > 0
    assert st["combine_device_rows"] > 0 and st["combine_host_rows"] > 0
    # 2 combined rows a 3 + 3 molecule, except the last batch's last
    # molecule, which the carry sends to the per-molecule path
    assert st["combine_device_rows"] + st["combine_host_rows"] == 998


def test_single_read_strands_take_the_host_combine(duplex_inputs, tmp_path):
    st = _run_pair(duplex_inputs["bias"], tmp_path,
                   ["--min-reads", "2", "1", "0"])
    assert st["combine_device_rows"] > 0
    assert st["combine_host_rows"] > st["suspect_positions"]


def test_packed2_batch_takes_the_host_combine(duplex_inputs, tmp_path,
                                              monkeypatch):
    monkeypatch.setattr(BG.BgzfReader.__init__, "__defaults__",
                        (256, False, None))
    st = _run_pair(duplex_inputs["many_quals"], tmp_path,
                   ["--batch-bytes", "65536"])
    assert st["launches"]["packed2_full"] == 0  # CPU tensors
    assert st["device_batches"] >= 3
    assert st["combine_device_rows"] > 0
    assert st["combine_host_rows"] >= 20  # molecules 0-9 at least


def _rename(data, name):
    ln = data[8]
    n = name + b"\0"
    return data[:8] + bytes([len(n)]) + data[9:32] + n + data[32 + ln:]


def test_65539_read_family_takes_the_host_combine(tmp_path):
    one = str(tmp_path / "one.bam")
    simulate_duplex_bam(one, num_molecules=2, reads_per_strand=3,
                        read_length=40, seed=5)
    with BamReader(one) as r:
        header = r.header
        recs = [x.data for x in r]
    big = str(tmp_path / "big.bam")
    with BamWriter(big, header) as w:
        for i in range(65536):
            w.write_record_bytes(_rename(recs[2 * (i % 3)], b"mol0:x%d" % i))
        for d in recs:
            w.write_record_bytes(d)
    st = _run_pair(big, tmp_path, ["--consensus-call-overlapping-bases",
                                   "false", "--batch-bytes",
                                   str(64 << 20)])
    assert max(s[0] for s in st["batch_shapes"]) >= 65536
    # molecule 0's two rows; molecule 1, the last, rides the carry
    assert st["combine_device_rows"] == 0 and st["combine_host_rows"] == 2


def test_no_resident_handle_outlives_a_run(duplex_inputs, tmp_path,
                                           monkeypatch):
    """Handles made by every batch (small batches, the device filter tap)
    are all released."""
    made = []
    real = pk_mod.ResidentHandles.__init__

    def counting(self, arrays):
        made.append(1)
        real(self, arrays)

    monkeypatch.setattr(pk_mod.ResidentHandles, "__init__", counting)
    live = pk_mod.LIVE_RESIDENTS
    out = str(tmp_path / "o.bam")
    assert port_main(["duplex", "-i", duplex_inputs["plain"], "-o", out,
                      "--device", "cpu", "--batch-bytes", "200000",
                      "--device-filter", "--filter-min-reads",
                      "6,3,3"]) == 0
    assert len(made) >= 3
    assert pk_mod.LIVE_RESIDENTS == live
