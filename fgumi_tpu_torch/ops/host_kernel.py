"""f64 host consensus engine: the offload router's host route.

The JAX package's twin (fgumi_tpu/ops/host_kernel.py), with the port's
imports. The offload router (ops/router.py) sends a consensus batch here
under ``FGUMI_TPU_ROUTE=host``, ``FGUMI_TPU_HOST_ENGINE=1`` or the opt-in
hybrid cost model, and the result sentinel (ops/sentinel.py) re-executes
its audited dispatches here. A native C++ pass (native/fgumi_native.cc
``fgumi_consensus_segments``) that is *bit-exact with the f64 oracle by
construction*:

  * Kahan lane sums use the identical IEEE op sequence on the identical f64
    tables -> bit-identical accumulations;
  * saturated positions (min loser gap >= g_sat) provably take the oracle's
    two-trials quick path, whose result is a constant precomputed HERE by the
    oracle (`qual_const`); the winner is an exact argmax of bit-identical
    sums. Derivation: the mathematical consensus error is
    <= ln 3 - g_min (sum of <= 3 loser terms exp(-gap)), and the oracle's
    computed value exceeds the mathematical one by at most a few f64 ulps, so
    g_min >= ln 3 - ln_pre + 6 + 1e-9 forces the oracle's computed
    `hi - lo >= 6.0` branch (ops/phred.py ln_error_prob_two_trials) to fire,
    making its output exactly `ln_error_pre_umi`;
  * depth-1/depth-2 positions are resolved by lookup tables generated by
    running the oracle on every (base, qual[, base, qual]) pileup — the
    depth-2 lane sums are single IEEE adds, which are commutative, so one
    table covers both observation orders (Q0 observations are excluded: their
    -inf/NaN Kahan flows are order-dependent, so they take the slow path);
  * every remaining position returns its bit-exact sums + counts to Python
    and is finished by oracle.call_full itself.

No transcendental function is ever evaluated in C++, so there is no
libm-vs-NumPy ulp surface at all: every output integer is either produced by
the oracle or forced by exact comparisons on bit-identical sums.
"""

import threading

import numpy as np

from ..constants import MIN_PHRED
from . import oracle
from . import phred as P
from .tables import LN_3, QualityTables

# margin by which the saturation test over-covers the oracle's computed
# quick-path condition (see module docstring derivation); dwarfs any f64
# evaluation error in the oracle's ln-chain while excluding essentially no
# real positions (the gap per matching Q20+ observation is >= 4.5).
_SAT_MARGIN = 1e-9


class HostConsensusEngine:
    """Per-QualityTables native consensus engine (see module docstring)."""

    def __init__(self, tables: QualityTables):
        self.tables = tables
        self.g_sat = LN_3 - tables.ln_error_pre_umi + 6.0 + _SAT_MARGIN
        self.qual_const = int(
            P.ln_prob_to_phred(np.float64(tables.ln_error_pre_umi)))
        self._tab1 = None
        self._tab2 = None
        # resolves run concurrently (resolve workers and the audit thread
        # share one engine via ConsensusKernel)
        self._lock = threading.Lock()
        self.slow_positions = 0
        self.total_positions = 0

    # ------------------------------------------------------------- tables
    def _single_obs_likelihoods(self):
        """(376, 4) f64 lane sums for every single-observation pileup
        (index = base * 94 + qual), exactly as one oracle Kahan step leaves
        them (sum == value, since the compensation starts at 0)."""
        t = self.tables
        idx = np.arange(376)
        b = idx // 94
        q = idx % 94
        lanes = np.arange(4)
        ll = np.where(lanes[None, :] == b[:, None],
                      t.adjusted_correct[q][:, None],
                      t.adjusted_error_per_alt[q][:, None])
        obs = (lanes[None, :] == b[:, None]).astype(np.int64)
        return ll, obs

    def _build_tables(self):
        with self._lock:
            if self._tab1 is not None:  # lost the build race: nothing to do
                return
            ll1, obs1 = self._single_obs_likelihoods()
            w1, q1, _, _ = oracle.call_full(ll1, obs1, self.tables)
            # depth-2: sums are ll1[i] + ll1[k] (single IEEE adds, so this
            # numpy add is bit-identical to the C++ accumulation for q >= 1
            # pileups)
            i2 = np.repeat(np.arange(376), 376)
            k2 = np.tile(np.arange(376), 376)
            w2, q2, _, _ = oracle.call_full(
                ll1[i2] + ll1[k2], obs1[i2] + obs1[k2], self.tables)
            self._tab2 = (np.ascontiguousarray(w2), np.ascontiguousarray(q2))
            # _tab1 is the build guard: assign it last
            self._tab1 = (np.ascontiguousarray(w1), np.ascontiguousarray(q1))

    # -------------------------------------------------------------- call
    def call_segments_counted(self, codes2d: np.ndarray, quals2d: np.ndarray,
                              starts: np.ndarray):
        """call_segments + the number of oracle-finished (slow) positions."""
        from ..native import batch as nb

        if self._tab1 is None:
            self._build_tables()
        t = self.tables
        winner, qual, depth, errors, slow_idx, slow_ll, slow_obs = \
            nb.consensus_segments(
                codes2d, quals2d, starts, t.adjusted_correct,
                t.adjusted_error_per_alt, self.g_sat, self.qual_const,
                MIN_PHRED, self._tab1[0], self._tab1[1], self._tab2[0],
                self._tab2[1])
        with self._lock:
            self.total_positions += winner.size
            self.slow_positions += len(slow_idx)
        n_slow = len(slow_idx)
        if n_slow:
            w, q, d, e = oracle.call_full(
                slow_ll, slow_obs.astype(np.int64), t)
            winner.ravel()[slow_idx] = w
            qual.ravel()[slow_idx] = q
            depth.ravel()[slow_idx] = d.astype(np.int32)
            errors.ravel()[slow_idx] = e.astype(np.int32)
        # depth/errors stay int32 (the native layer's dtype): every consumer
        # is dtype-agnostic and the serializer wants int32 blocks, so the
        # whole-(J,L) int64 round trip was pure memory traffic
        return winner, qual, depth, errors, n_slow

    def call_segments(self, codes2d: np.ndarray, quals2d: np.ndarray,
                      starts: np.ndarray):
        """Consensus over ragged segments of dense (N, L) read rows.

        Same contract as ConsensusKernel.resolve_segments: returns
        (winner, qual, depth, errors) as (J, L) arrays (depth/errors int32),
        bit-exact with oracle.call_family on each segment.
        """
        return self.call_segments_counted(codes2d, quals2d, starts)[:4]

    def call_family(self, codes: np.ndarray, quals: np.ndarray):
        """One (R, L) family: call_segments with a single segment."""
        R, L = codes.shape
        starts = np.array([0, R], dtype=np.int64)
        w, q, d, e = self.call_segments(codes, quals, starts)
        return w[0], q[0], d[0], e[0]
