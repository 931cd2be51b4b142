"""UMI assignment strategies (the reference's fgumi-umi assigner.rs).

- MoleculeId {None, Single, PairedA, PairedB} rendered "42" / "42/A" / "42/B";
- identity: exact match on uppercased strings, ids in sorted order;
- edit: transitive single-linkage within the Hamming distance; components get
  ids in order of their smallest member;
- adjacency: the UMI-tools directed graph — count-descending (tie: string)
  order, BFS capture of unassigned children with child_count <=
  parent_count/2 + 1 within the distance;
- paired: adjacency over canonicalized dual UMIs (A-B vs B-A), /A-/B strand
  ids by orientation against the root.

Invalid UMIs (non-ACGT, >32 bases per segment) never join a valid molecule;
each distinct (uppercased) invalid string gets its own Single id.

Distances. Below ``DEVICE_THRESHOLD`` distinct UMIs the all-pairs Hamming
matrix is a numpy expression on the host, whatever the device; at or above
it the device function runs: the CUDA kernel K4 (``ops/umi_hamming.py``) on
``cuda``, its plain PyTorch version on ``cpu``. The device is explicit:
``make_assigner(..., device=...)`` hands it to ``build_neighbor_graph`` and
``pairwise_distances``. The route globals (``DEVICE_THRESHOLD``,
``SPARSE_THRESHOLD``, ``_NATIVE_BFS_THRESHOLD``) are read at call time, so
tests can force a route by setting them.

Native routes, as the JAX package takes them: candidate pairs come from
the native pigeonhole search (``native.batch.umi_neighbor_pairs``) at n >=
``SPARSE_THRESHOLD``, and the directed BFS runs natively
(``native.batch.adjacency_bfs``) at n >= ``_NATIVE_BFS_THRESHOLD``. The
port's native library is required (a failed build raises). The Python
routes (``_pigeonhole_pairs``, the scalar BFS loop) stay beside them: the
tests hold each native route to its Python twin.
"""

import time
from collections import Counter, deque
from dataclasses import dataclass

import numpy as np
import torch

from ..native import batch as nb
from ..ops.umi_hamming import umi_hamming

# Unique-UMI count at which the pairwise distance matrix moves to the device.
DEVICE_THRESHOLD = 1024
# Unique-UMI count at which candidate pairs come from pigeonhole chunk
# indexing instead of the dense matrix (exact-match on one of d+1 chunks is
# necessary for Hamming distance <= d, the reference's NgramIndex).
SPARSE_THRESHOLD = 8192
# Unique-UMI count at which the directed BFS runs natively.
_NATIVE_BFS_THRESHOLD = 512


@dataclass(frozen=True)
class MoleculeId:
    """kind: '' (none), 'S' (single), 'A'/'B' (paired strands)."""

    kind: str
    id: int = -1

    def render(self) -> str:
        if self.kind == "S":
            return str(self.id)
        if self.kind in ("A", "B"):
            return f"{self.id}/{self.kind}"
        return ""


NONE_ID = MoleculeId("")


def render_mis_array(mols) -> np.ndarray:
    """Vectorized MoleculeId.render over a list: one S-dtype numpy array
    (itemsize covers the longest value). Assigners return ONE MoleculeId
    object per molecule, so the attribute reads run on the identity-deduped
    uniques and the full-size result is a single gather."""
    n = len(mols)
    obj = np.fromiter(map(id, mols), np.int64, n)
    _uniq, first, inverse = np.unique(obj, return_index=True,
                                      return_inverse=True)
    umols = [mols[int(i)] for i in first]
    m = len(umols)
    ids = np.fromiter((mo.id for mo in umols), np.int64, m)
    kinds = np.fromiter((ord(mo.kind) if mo.kind else 0 for mo in umols),
                        np.uint8, m)
    s = ids.astype("S20")
    out = np.where(kinds == 0, np.bytes_(b""), s)
    ab = (kinds == ord("A")) | (kinds == ord("B"))
    if ab.any():
        suffix = np.where(kinds == ord("A"), np.bytes_(b"/A"),
                          np.bytes_(b"/B"))
        out = np.where(ab, np.char.add(s, suffix), out)
    return out[inverse]


_VALID_SET = frozenset("ACGTacgt")


def _is_encodable(umi: str) -> bool:
    """BitEnc-encodable: every dash-separated segment is ACGT (case-folded), <=32."""
    for seg in umi.split("-"):
        # strip orientation prefix ("aa:"/"bb:") if present
        seg = seg.rsplit(":", 1)[-1]
        if len(seg) > 32:
            return False
        if not _VALID_SET.issuperset(seg):
            return False
    return True


def _umi_matrix(umis) -> np.ndarray:
    """(N, L) uint8 byte matrix of equal-length strings."""
    return np.frombuffer("".join(umis).encode(), dtype=np.uint8).reshape(len(umis), -1)


def set_index_threshold(n):
    """--index-threshold mapping (group.rs:860-863): below the threshold the
    neighbor graph is built by the dense pairwise scan, at/above it by the
    indexed candidate search. 0 = always dense; None restores the default."""
    global SPARSE_THRESHOLD
    SPARSE_THRESHOLD = (8192 if n is None
                        else (1 << 62) if int(n) == 0 else int(n))


class NeighborGraph:
    """Match-graph adjacency: neighbors(i) -> ascending indices j != i.

    Dense mode wraps a boolean within-matrix (small groups); sparse mode
    holds per-node neighbor lists from pigeonhole candidate generation."""

    def __init__(self, n, within=None, lists=None):
        self.n = n
        self._within = within
        self._lists = lists

    def neighbors(self, i: int) -> np.ndarray:
        if self._within is not None:
            row = np.nonzero(self._within[i])[0]
            return row[row != i]
        return self._lists[i]

    def flat(self):
        """(nbr_flat, nbr_start) arrays for the native BFS: the neighbours
        of i are nbr_flat[nbr_start[i]:nbr_start[i+1]], ascending."""
        lists = (self._lists if self._lists is not None
                 else [self.neighbors(i) for i in range(self.n)])
        starts = np.zeros(self.n + 1, dtype=np.int64)
        np.cumsum([len(x) for x in lists], out=starts[1:])
        flat = (np.concatenate(lists).astype(np.int64)
                if self.n else np.empty(0, np.int64))
        return flat, starts


def build_neighbor_graph(mat: np.ndarray, max_mismatches: int,
                         rev_mat: np.ndarray = None,
                         device="cuda") -> NeighborGraph:
    """Graph of pairs with hamming(mat[i], mat[j]) <= d (or, with rev_mat,
    additionally hamming(rev_mat[i], mat[j]) <= d — the paired-UMI cross
    condition, symmetric because strand reversal is an involution)."""
    n = mat.shape[0]
    # pigeonhole completeness needs d+1 disjoint chunks: with d+1 > L a pair
    # can differ everywhere yet still be within distance d, so stay dense
    if n < SPARSE_THRESHOLD or max_mismatches + 1 > mat.shape[1]:
        within = pairwise_distances(mat, device=device) <= max_mismatches
        if rev_mat is not None:
            within |= pairwise_distances(rev_mat, mat,
                                         device=device) <= max_mismatches
        return NeighborGraph(n, within=within)
    pair_sets = [nb.umi_neighbor_pairs(mat, None, max_mismatches)]
    if rev_mat is not None:
        pair_sets.append(nb.umi_neighbor_pairs(rev_mat, mat, max_mismatches))
    return _lists_from_pairs(n, pair_sets)


def _pigeonhole_pairs(A: np.ndarray, B: np.ndarray, d: int, device="cuda"):
    """Candidate (i, j) index arrays with hamming(A[i], B[j]) <= d, i != j.

    Split columns into d+1 chunks; any pair within distance d agrees exactly
    on at least one chunk, so exact-match buckets per chunk generate a
    complete candidate set which is then distance-verified in bulk."""
    _n, L = A.shape
    out_i = []
    out_j = []
    chunks = np.array_split(np.arange(L), min(d + 1, L))
    same = A is B
    for cols in chunks:
        if len(cols) == 0:
            continue
        kb = np.ascontiguousarray(B[:, cols])
        key_b = kb.view([("", np.uint8, kb.shape[1])]).ravel()
        order_b = np.argsort(key_b, kind="stable")
        sb = key_b[order_b]
        bounds = np.flatnonzero(np.concatenate(
            ([True], sb[1:] != sb[:-1], [True])))
        if same:
            for s, e in zip(bounds[:-1], bounds[1:]):
                if e - s < 2:
                    continue
                idxs = np.sort(order_b[s:e])
                dm = pairwise_distances(np.ascontiguousarray(B[idxs]),
                                        device=device)
                ii, jj = np.nonzero(dm <= d)
                keep = ii < jj
                out_i.append(idxs[ii[keep]])
                out_j.append(idxs[jj[keep]])
        else:
            ka = np.ascontiguousarray(A[:, cols])
            key_a = ka.view([("", np.uint8, ka.shape[1])]).ravel()
            order_a = np.argsort(key_a, kind="stable")
            sa = key_a[order_a]
            a_bounds = np.flatnonzero(np.concatenate(
                ([True], sa[1:] != sa[:-1], [True])))
            # probe B buckets by key bytes (void-dtype ordering comparisons
            # are unreliable; equality via bytes is exact)
            b_index = {sb[bounds[k]].tobytes(): (bounds[k], bounds[k + 1])
                       for k in range(len(bounds) - 1)}
            for s, e in zip(a_bounds[:-1], a_bounds[1:]):
                got = b_index.get(sa[s].tobytes())
                if got is None:
                    continue
                ai = order_a[s:e]
                bj = order_b[got[0]:got[1]]
                dm = pairwise_distances(np.ascontiguousarray(A[ai]),
                                        np.ascontiguousarray(B[bj]),
                                        device=device)
                ii, jj = np.nonzero(dm <= d)
                gi, gj = ai[ii], bj[jj]
                keep = gi != gj
                out_i.append(gi[keep])
                out_j.append(gj[keep])
    if not out_i:
        return (np.empty(0, np.int64), np.empty(0, np.int64))
    return (np.concatenate(out_i).astype(np.int64),
            np.concatenate(out_j).astype(np.int64))


def _lists_from_pairs(n: int, pair_sets) -> NeighborGraph:
    """Symmetrize + dedupe pair arrays into sorted per-node neighbor lists."""
    i = np.concatenate([p for p, _ in pair_sets])
    j = np.concatenate([q for _, q in pair_sets])
    # undirected: add both directions, dedupe on i*n+j
    enc = np.unique(np.concatenate([i, j]) * n + np.concatenate([j, i]))
    src = enc // n
    dst = enc % n
    splits = np.searchsorted(src, np.arange(1, n))
    return NeighborGraph(n, lists=np.split(dst, splits))


def pairwise_distances(mat_a: np.ndarray, mat_b: np.ndarray = None,
                       device="cuda") -> np.ndarray:
    """All-pairs Hamming distances between byte matrices, (n, m) int16:
    the host expression below ``DEVICE_THRESHOLD``, the device function
    (:func:`_device_pairwise`) at or above it."""
    if mat_b is None:
        mat_b = mat_a
    n, m = mat_a.shape[0], mat_b.shape[0]
    if max(n, m) >= DEVICE_THRESHOLD:
        return _device_pairwise(mat_a, mat_b, device)
    return (mat_a[:, None, :] != mat_b[None, :, :]).sum(axis=2, dtype=np.int16)


class DeviceSpan:
    """Host-clock split of the device function's calls: upload, kernel
    (launch to completion) and fetch, the calls and the largest shape."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.calls = 0
        self.upload_s = 0.0
        self.kernel_s = 0.0
        self.fetch_s = 0.0
        self.fetch_bytes = 0
        self.largest = None  # (n, m, L) of the largest n * m

    def as_dict(self) -> dict:
        return {"calls": self.calls, "upload_s": self.upload_s,
                "kernel_s": self.kernel_s, "fetch_s": self.fetch_s,
                "fetch_bytes": self.fetch_bytes,
                "largest": list(self.largest) if self.largest else None}


#: the device function's span over the process (reset by the caller)
DEVICE_SPAN = DeviceSpan()


def _as_tensor(mat: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(mat, np.uint8, ["C", "W"])).to(dev)


def _device_pairwise(mat_a: np.ndarray, mat_b: np.ndarray,
                     device) -> np.ndarray:
    """The device function: upload, K4 (or its plain version on ``cpu``),
    fetch of the whole (n, m) int16 matrix."""
    from ..observe.trace import span as trace_span

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    t0 = time.perf_counter()
    # K4's upload and launch (this route synchronises, so the span also
    # holds the kernel's run), then the fetch of the matrix
    with trace_span("device.dispatch", what="K4", attempt=0):
        a = _as_tensor(mat_a, dev)
        b = a if mat_b is mat_a else _as_tensor(mat_b, dev)
        if on_card:
            torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        dist = umi_hamming(a, b)
        if on_card:
            torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    with trace_span("device.fetch", what="K4"):
        out = dist.cpu().numpy()
    t3 = time.perf_counter()
    span = DEVICE_SPAN
    span.calls += 1
    span.upload_s += t1 - t0
    span.kernel_s += t2 - t1
    span.fetch_s += t3 - t2
    span.fetch_bytes += out.nbytes
    n, m = out.shape
    if span.largest is None or n * m > span.largest[0] * span.largest[1]:
        span.largest = (n, m, mat_a.shape[1])
    return out


def _assert_uniform_length(lengths) -> None:
    it = iter(lengths)
    first = next(it, None)
    if first is None:
        return
    for ln in it:
        if ln != first:
            raise ValueError(f"Multiple UMI lengths: {ln} vs {first}")


class _Counter:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def next_id(self) -> int:
        v = self.value
        self.value += 1
        return v


def _with_invalid_fallback(umis, resolve, counter):
    """Per-input ids with a per-distinct-invalid-string fallback (assigner.rs:692-707)."""
    invalid_to_id = {}
    out = []
    for i, umi in enumerate(umis):
        mid = resolve(i, umi)
        if mid is None:
            key = umi.upper()
            if key not in invalid_to_id:
                invalid_to_id[key] = MoleculeId("S", counter.next_id())
            mid = invalid_to_id[key]
        out.append(mid)
    return out


class IdentityUmiAssigner:
    """Exact-match grouping; IDs assigned over sorted unique uppercased UMIs."""

    def __init__(self):
        self.counter = _Counter()

    def split_by_orientation(self) -> bool:
        return True

    def assign(self, raw_umis):
        if not raw_umis:
            return []
        canon = [u.upper() for u in raw_umis]
        mapping = {c: MoleculeId("S", self.counter.next_id()) for c in sorted(set(canon))}
        return [mapping[c] for c in canon]


class SimpleErrorUmiAssigner:
    """Transitive single-linkage clustering within ``max_mismatches`` (edit strategy)."""

    def __init__(self, max_mismatches: int = 1, device="cuda"):
        self.max_mismatches = max_mismatches
        self.device = device
        self.counter = _Counter()

    def split_by_orientation(self) -> bool:
        return True

    def assign(self, raw_umis):
        if not raw_umis:
            return []
        upper = [u.upper() for u in raw_umis]
        valid = sorted({u for u in set(upper) if _is_encodable(u)})
        _assert_uniform_length(len(u) for u in valid)
        umi_to_id = {}
        if valid:
            mat = _umi_matrix(valid)
            graph = build_neighbor_graph(mat, self.max_mismatches,
                                         device=self.device)
            # connected components = transitive closure of the match graph
            n = len(valid)
            comp = np.full(n, -1, dtype=np.int64)
            n_comp = 0
            for i in range(n):
                if comp[i] >= 0:
                    continue
                stack = [i]
                comp[i] = n_comp
                while stack:
                    j = stack.pop()
                    nbrs = graph.neighbors(j)
                    for k in nbrs[comp[nbrs] < 0]:
                        comp[k] = n_comp
                        stack.append(int(k))
                n_comp += 1
            # components ordered by smallest member (valid is sorted, so the
            # first occurrence order IS smallest-member order)
            comp_ids = {}
            for i, u in enumerate(valid):
                c = comp[i]
                if c not in comp_ids:
                    comp_ids[c] = MoleculeId("S", self.counter.next_id())
                umi_to_id[u] = comp_ids[c]
        return _with_invalid_fallback(upper, lambda _i, u: umi_to_id.get(u), self.counter)


def _count_sorted_unique(keys):
    """(unique_key, count) sorted by (-count, key)."""
    return sorted(Counter(keys).items(), key=lambda kv: (-kv[1], kv[0]))


def _adjacency_bfs(unique, counts, graph: NeighborGraph):
    """UMI-tools directed BFS (assigner.rs:1480-1548).

    unique/counts sorted by (-count, string); graph.neighbors(i) = ascending
    candidate matches. Returns (roots, root_of) where root_of[i] is the
    component root index.
    """
    n = len(unique)
    counts_arr = np.asarray(counts)
    if n >= _NATIVE_BFS_THRESHOLD:
        flat, starts = graph.flat()
        root_of = nb.adjacency_bfs(flat, starts, counts_arr.astype(np.int64))
        # roots in discovery order == ascending root index (each root is
        # its own first-assigned node), the scalar loop's order
        return np.unique(root_of).tolist(), root_of
    assigned = np.zeros(n, dtype=bool)
    root_of = np.full(n, -1, dtype=np.int64)
    roots = []
    for root in range(n):
        if assigned[root]:
            continue
        roots.append(root)
        assigned[root] = True
        root_of[root] = root
        queue = deque([root])
        while queue:
            idx = queue.popleft()
            max_child = counts[idx] // 2 + 1
            nbrs = graph.neighbors(idx)
            cand = nbrs[~assigned[nbrs] & (counts_arr[nbrs] <= max_child)]
            for child in cand:
                child = int(child)
                assigned[child] = True
                root_of[child] = root_of[idx]
                queue.append(child)
    return roots, root_of


class AdjacencyUmiAssigner:
    """UMI-tools directed adjacency strategy."""

    # above this many input strings the per-read Python loops (upper,
    # Counter, fallback dict walk) dominate; the vectorized path does
    # uppercase/unique/count/map-back as numpy passes and runs Python only
    # per DISTINCT UMI, with the scalar path's ids exactly
    _VEC_THRESHOLD = 2048

    def __init__(self, max_mismatches: int = 1, device="cuda"):
        self.max_mismatches = max_mismatches
        self.device = device
        self.counter = _Counter()

    def split_by_orientation(self) -> bool:
        return True

    def _assign_uniques(self, unique, counts):
        """Molecule ids for (-count, string)-sorted valid unique UMIs,
        aligned with `unique`; ids are minted in BFS-root order (the shared
        contract of the scalar and vectorized assign paths)."""
        if len(unique) == 1:
            return [MoleculeId("S", self.counter.next_id())]
        mat = _umi_matrix(unique)
        graph = build_neighbor_graph(mat, self.max_mismatches,
                                     device=self.device)
        roots, root_of = _adjacency_bfs(unique, counts, graph)
        root_ids = {r: MoleculeId("S", self.counter.next_id()) for r in roots}
        return [root_ids[int(root_of[i])] for i in range(len(unique))]

    def assign(self, raw_umis):
        if not raw_umis:
            return []
        if len(raw_umis) >= self._VEC_THRESHOLD:
            return self._assign_vectorized(raw_umis)
        upper = [u.upper() for u in raw_umis]
        # count first, validate per DISTINCT string; the filtered list keeps
        # the (-count, umi) order _count_sorted_unique establishes
        counted = [(u, c) for u, c in _count_sorted_unique(upper)
                   if _is_encodable(u)]
        if not counted:
            return _with_invalid_fallback(upper, lambda *_: None, self.counter)
        _assert_uniform_length(len(u) for u, _ in counted)
        unique = [u for u, _ in counted]
        counts = [c for _, c in counted]
        umi_to_id = dict(zip(unique, self._assign_uniques(unique, counts)))
        return _with_invalid_fallback(upper, lambda _i, u: umi_to_id.get(u), self.counter)

    def _assign_vectorized(self, raw_umis):
        """Large-group assign: numpy passes over the input, Python per
        distinct UMI only. Semantics identical to the scalar path:

        - valid uniques sorted by (-count, string) — np.unique returns
          string-ascending uniques, so a stable sort by -count reproduces
          _count_sorted_unique's order;
        - valid molecule ids minted first (BFS-root order), then one id per
          distinct invalid string in first-occurrence input order, exactly
          as _with_invalid_fallback's forward walk mints them."""
        arr = np.char.upper(np.asarray(raw_umis, dtype=np.str_))
        uniq, first_idx, inverse, ucounts = np.unique(
            arr, return_index=True, return_inverse=True, return_counts=True)
        valid_mask = np.fromiter((_is_encodable(u) for u in uniq),
                                 bool, len(uniq))
        mids_u = np.empty(len(uniq), dtype=object)
        valid_idx = np.nonzero(valid_mask)[0]
        if len(valid_idx):
            order = np.argsort(-ucounts[valid_idx], kind="stable")
            sorted_idx = valid_idx[order]
            unique = [str(uniq[i]) for i in sorted_idx]
            _assert_uniform_length(len(u) for u in unique)
            counts = ucounts[sorted_idx].tolist()
            for i, mid in zip(sorted_idx,
                              self._assign_uniques(unique, counts)):
                mids_u[i] = mid
        invalid_idx = np.nonzero(~valid_mask)[0]
        if len(invalid_idx):
            for i in invalid_idx[np.argsort(first_idx[invalid_idx],
                                            kind="stable")]:
                mids_u[i] = MoleculeId("S", self.counter.next_id())
        return list(mids_u[inverse])


class PairedUmiAssigner:
    """Dual-UMI (duplex) strategy: A-B and B-A group together with /A-/B strand ids."""

    def __init__(self, max_mismatches: int = 1, device="cuda"):
        self.max_mismatches = max_mismatches
        self.device = device
        self.counter = _Counter()
        prefix_len = max_mismatches + 1
        self.lower_prefix = "a" * prefix_len
        self.higher_prefix = "b" * prefix_len

    def split_by_orientation(self) -> bool:
        return False

    @staticmethod
    def _split(umi: str):
        parts = umi.split("-")
        if len(parts) != 2:
            raise ValueError(f"UMI {umi!r} is not a valid paired UMI (expected 'A-B')")
        return parts[0], parts[1]

    @classmethod
    def _reverse(cls, umi: str) -> str:
        a, b = cls._split(umi)
        return f"{b}-{a}"

    @classmethod
    def _canonical(cls, umi: str) -> str:
        a, b = cls._split(umi)
        return umi if a <= b else f"{b}-{a}"

    def assign(self, raw_umis):
        if not raw_umis:
            return []
        upper = [u.upper() for u in raw_umis]
        # structure-validate, BitEnc-validate and canonicalize per DISTINCT
        # string; counts aggregate per canonical form
        counted_all = _count_sorted_unique(upper)
        for u, _ in counted_all:
            self._split(u)  # validates exactly one '-'
        dvalid = {u for u, _ in counted_all if _is_encodable(u)}
        canon_counts = {}
        for u, c in counted_all:
            if u in dvalid:
                k = self._canonical(u)
                canon_counts[k] = canon_counts.get(k, 0) + c
        counted = sorted(canon_counts.items(), key=lambda kv: (-kv[1], kv[0]))
        if not counted:
            return _with_invalid_fallback(upper, lambda *_: None, self.counter)

        def underlying_len(u):
            a, b = self._split(u)
            return len(a.rsplit(":", 1)[-1]) + len(b.rsplit(":", 1)[-1])

        _assert_uniform_length(underlying_len(u) for u, _ in counted)
        unique = [u for u, _ in counted]
        counts = [c for _, c in counted]

        umi_to_id = {}
        if len(unique) == 1:
            mid = self.counter.next_id()
            ab, ba = MoleculeId("A", mid), MoleculeId("B", mid)
            u = unique[0]
            umi_to_id[u] = ab
            umi_to_id[self._reverse(u)] = ba
        else:
            mat = _umi_matrix(unique)
            rev_mat = _umi_matrix([self._reverse(u) for u in unique])
            graph = build_neighbor_graph(mat, self.max_mismatches,
                                         rev_mat=rev_mat, device=self.device)
            roots, root_of = _adjacency_bfs(unique, counts, graph)
            root_mid = {r: self.counter.next_id() for r in roots}
            for i, u in enumerate(unique):
                root = int(root_of[i])
                mid = root_mid[root]
                ab, ba = MoleculeId("A", mid), MoleculeId("B", mid)
                if i == root:
                    umi_to_id[u] = ab
                    umi_to_id[self._reverse(u)] = ba
                else:
                    root_umi = unique[root]
                    d_fwd = sum(x != y for x, y in zip(root_umi, u))
                    d_rev = sum(x != y for x, y in zip(root_umi, self._reverse(u)))
                    if d_fwd < d_rev:
                        umi_to_id[u] = ab
                        umi_to_id[self._reverse(u)] = ba
                    else:
                        umi_to_id[u] = ba
                        umi_to_id[self._reverse(u)] = ab
        return _with_invalid_fallback(
            upper, lambda i, u: umi_to_id.get(u) if u in dvalid else None,
            self.counter)


def make_assigner(strategy: str, edits: int = 1, device="cuda"):
    """Strategy factory (group.rs Strategy enum); ``device`` is where the
    distance matrices of large groups are computed."""
    if strategy == "identity":
        return IdentityUmiAssigner()
    if strategy == "edit":
        return SimpleErrorUmiAssigner(edits, device)
    if strategy == "adjacency":
        return AdjacencyUmiAssigner(edits, device)
    if strategy == "paired":
        return PairedUmiAssigner(edits, device)
    raise ValueError(f"unknown UMI strategy: {strategy}")
