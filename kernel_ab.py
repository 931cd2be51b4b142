#!/usr/bin/env python3
"""Same-card A/B of two builds of one of the port's kernel sources, plus a
static SASS estimate of the wire kernels' instructions per column.

Run from the repository root on a machine with one NVIDIA H100, with the
other source unpacked into the gitignored ``_base/`` (for example the
parent commit's: ``git show <commit>:fgumi_tpu_torch/csrc/consensus_wire.cu
> _base/consensus_wire.cu``); the source's name picks the kernels:

    python3 kernel_ab.py --base _base/consensus_wire.cu [--sass-out DIR]
    python3 kernel_ab.py --base _base/umi_hamming.cu
    python3 kernel_ab.py --base _base/strand_combine.cu
    python3 kernel_ab.py --base _base/canary.cu
    python3 kernel_ab.py --base _base/tune_combine.cu

For ``consensus_wire.cu`` (K1, K1-f, K1-r and K1-p2; K1-r and K1-p2 only
where both builds have them):

1. builds ``--base`` and this tree's source in parallel with the port's
   nvcc flags and prints each build's ptxas register and spill lines;
2. makes each kernel's main-path batches as ``chip_smoke.py`` makes them:
   for K1, the subject, the largest fast batches of ``fixed5_1M`` and
   ``longtail_200k`` (56,780 rows x 152 over 11,356 reads; 35,649 rows
   over 6,634 longtail reads of up to 50 rows); for K1-f, the control, the
   largest fused batches (the same shapes, made from other seeds: the
   longtail one has 36,938 rows); for K1-r, ``duplex_240k``'s largest
   stage-1 batch (71,172 rows x 128 over 23,724 three-row strand
   families), ``k1r_uniform`` (the same shape, uniform random bases and
   quals 2-40: almost every column with a disagreement) and ``k1r_two_row``
   (71,172 rows over 35,586 two-row families of the main path's data: most
   columns' combine takes the full branch), where both builds have K1-r (a
   source from before it is A/B'd on K1 and K1-f alone); for K1-p2,
   ``many_quals_20k``'s largest batch (19,990 rows x 100 over 3,998 reads,
   quals 2-93: the packed2 layout) and ``fixed5_p2`` (K1's ``fixed5``
   rows, 56,780 x 152 over 11,356 reads, with quals 2-93), where both
   builds have K1-p2;
3. calls each build through the port's own wrappers
   (``cuda_kernel.consensus_wire_full`` for K1,
   ``consensus_wire_filter`` for K1-f, ``consensus_wire_resident`` for
   K1-r, ``consensus_wire_packed2`` for K1-p2) and requires every output
   bit-identical between the builds (all 7 of K1-r's);
4. times each kernel of each build in turns (base, new, new, base, twice):
   torch.profiler device time per launch over 25 launches, and CUDA-event
   time per launch over 25 back-to-back launches, beside the byte bound
   (K1, K1-r and K1-p2);
5. estimates from ``cuobjdump -sass`` each kernel's executed instructions
   per column at its first batch (see ``per_column_estimate``; every branch
   counted as if it ran; K1-p2 only where it reads its rows from shared
   memory) and the
   issue-rate bound that implies (4 warp instructions per clock per SM at
   the card's maximum SM clock);
6. prints one JSON line per result and, last, a JSON summary.

(``ncu``, which would count executed instructions, is in the card
machine's toolkit but cannot load its counter library there.)

For ``umi_hamming.cu`` (K4): builds both sources as above, binds only the
launch export ``fgumi_umi_hamming`` of each (with its scratch-size export
where the build has one; an older build's launch takes no scratch), calls
each build on the same input and output pointers at the judged shapes (5,583
x 5,583 x 8, 4,235 x 4,235 x 15, 8,191 x 8,191 x 8) and the edges (2,000 x 1
x 8, 1 x 5,000 x 8, 1,500 x 1,500 x 9), requires bit-identical int16
outputs, and times both in turns as above (the device time of every kernel a
call launches) beside the shape's byte bound.

For ``strand_combine.cu`` with ``--codec-tree DIR`` (another checkout of
the repository, for example the parent commit's ``git archive`` unpacked
into ``_base/tree``), first: ``codec --min-reads 1`` (the batch engine, on
the card) on ``chip_smoke.py``'s ``codec_320k`` input, run in turns in
DIR and in this tree (base, new, new, base, twice; each tree's kernels
and native library built beforehand, outside the runs), prints each run's
``combine_s``, ``device_s``, ``host_s``, wall and K6 launches from
``--stats-json``, and requires the two trees' records identical.

For ``strand_combine.cu`` (K5 and K6): builds both sources as above, binds
each build's exports with ``ops/combine.bind`` and calls it through the
port's own wrappers (``combine.duplex_combine``, ``combine.codec_combine``)
at the two main-path shapes ``chip_smoke.py`` times them at: K5 over
11,757 rows of ``duplex_240k``'s resident width 128 (23,724 resident rows,
each read by one output row, lengths 92-100), K6 over ``codec_320k``'s
2,678,850 positions; requires
every output bit-identical between the builds, and times both in turns as
above (each kernel's own device time) beside the byte bound.

For ``canary.cu`` (K7, the device canary's int32 sum): builds both sources
as above, binds each build's exports with ``ops/canary.bind`` and calls it
through the port's wrapper (``canary.canary_sum``, the module's ``_LIB``
swapped) on the health monitor's 1 MiB payload (zeros and seeded random
bytes) and on 1 MiB + 13 bytes (the tail path); requires equal sums, and
times both in turns beside the byte bound (a launch's latency sets K7's
time at this size).

For ``tune_combine.cu`` (K8, the tuner's elementwise combine): builds both
sources as above, binds each build's exports with ``ops/tune_combine.bind``
and calls it through the port's wrapper (``tune_combine.tune_combine``,
the module's ``_LIB`` swapped) on ``chip_smoke.py``'s inputs at the sweep's
two shapes, (512, 100) and (4096, 150) (``chip_smoke.tune_combine_inputs``:
the chooser bench's arrays, random bytes, the uint8 wrap, an unaligned
view); requires byte-identical outputs, and times both in turns on the
bench's arrays beside the 3-byte-a-cell bound.
"""

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

import chip_smoke as S

# kernel: (symbol, {batch: (shape (rows, L, reads), data, seed)}), each
# main-path batch as chip_smoke's main-path phase makes it for that kernel
# (data "family" or "longtail": chip_smoke.main_path_batch; "uniform":
# chip_smoke.uniform_batch); K1-r also at uniform bases and quals (almost
# every column with a disagreement) and at 2-row families (most columns'
# combine takes the full branch)
KERNELS = {
    "K1": ("consensus_wire_full_kernel", {
        "fixed5": ((56780, 152, 11356), "family", len("k1_fixed")),
        "longtail": ((52974, 152, 6634), "longtail", len("k1_longtail"))}),
    "K1-f": ("consensus_wire_filter_kernel", {
        "fixed5": ((56780, 152, 11356), "family", len("k1f_fixed")),
        "longtail": ((52974, 152, 6634), "longtail", len("k1f_longtail"))}),
    "K1-r": ("consensus_wire_resident_kernel", {
        "duplex": ((71172, 128, 23724), "family", len("k1r_duplex")),
        "k1r_uniform": ((71172, 128, 23724), "uniform", len("k1r_uniform")),
        "k1r_two_row": ((71172, 128, 35586), "family", len("k1r_two_row"))}),
    # the seed is the batch's rows, as chip_smoke's main-path checks make
    # them
    "K1-p2": ("consensus_wire_packed2_kernel", {
        "many_quals": ((19990, 100, 3998), "packed2", 19990),
        "fixed5_p2": ((56780, 152, 11356), "packed2", 56780)}),
}
# kernels that not every build of consensus_wire.cu has: the launch export
# an A/B needs in both builds, and its binder
OPTIONAL = {"K1-r": "fgumi_consensus_wire_resident",
            "K1-p2": "fgumi_consensus_wire_packed2"}
# each kernel's bytes a column, for the byte bound (K1-f's also counts its
# stats rows and table entries: chip_smoke.py gives its bound)
COL_BYTES = {"K1": S.FULL_COL_BYTES, "K1-r": S.RESIDENT_COL_BYTES}
TURNS = 2
# K4's A/B shapes (n, m, L): the three it is judged at, then the edges
K4_SHAPES = ((5583, 5583, 8), (4235, 4235, 15), (8191, 8191, 8),
             (2000, 1, 8), (1, 5000, 8), (1500, 1500, 9))


def make_call(kernel: str, shape, data: str, seed: int, dev):
    """The kernel's wrapper call on one batch and the batch's (rows per
    read, reads, L)."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    if data == "uniform":
        codes, quals, starts = S.uniform_batch(shape, seed)
        lens = None
    elif data == "packed2":
        codes, _, starts, _ = S.main_path_batch(shape, False, seed)
        quals = S.packed2_quals(codes, seed)
    else:
        codes, quals, starts, lens = S.main_path_batch(
            shape, data == "longtail", seed)
    kern = ConsensusKernel(quality_tables(45, 40), dev)
    J = len(starts) - 1
    if kernel == "K1-p2":
        from fgumi_tpu_torch.ops import wire as W

        cp, q = (t.to(dev) for t in W.pack_codes2(torch.from_numpy(codes),
                                                  torch.from_numpy(quals)))
        ct, et = kern._device_tables()
        starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)

        def call():
            return cuda_kernel.consensus_wire_packed2(cp, q, starts_d, ct, et,
                                                      kern._pre)
        return call, (codes.shape[0] / J, J, codes.shape[1])
    wire, dict64, starts_d, _ = S.wire_on_device(kern, codes, quals, starts,
                                                 dev, "kernel_ab")
    if kernel == "K1":
        def call():
            return cuda_kernel.consensus_wire_full(wire, starts_d, dict64,
                                                   kern._pre)
    elif kernel == "K1-r":
        def call():
            return cuda_kernel.consensus_wire_resident(
                wire, starts_d, dict64, kern._pre, 1, 40)
    else:
        fp = S.filter_stage(3, 25).dev_params
        lens_d = torch.from_numpy(lens).to(dev)
        emin = torch.from_numpy(fp.emin_tab.astype(np.int32)).to(dev)

        def call():
            return cuda_kernel.consensus_wire_filter(
                wire, starts_d, dict64, kern._pre, S.MIN_READS_C,
                S.MIN_QUAL_C, lens_d, fp.min_reads, emin, fp.min_base_q,
                fp.per_base)
    return call, (codes.shape[0] / J, J, codes.shape[1])


def bind_hamming(path: str):
    """Build ``path``'s K4 launch export, declared as that build has it:
    with the scratch buffer of the bit planes, or (a build from before it)
    without."""
    import torch

    from fgumi_tpu_torch.ops import umi_hamming

    lib = ctypes.CDLL(path)
    if hasattr(lib, "fgumi_umi_hamming_scratch_words"):
        umi_hamming.bind(lib)
        return lambda a, b, out: umi_hamming.launch(lib, a, b, out)
    lib.fgumi_umi_hamming.restype = ctypes.c_int
    lib.fgumi_umi_hamming.argtypes = ([ctypes.c_void_p] * 2
                                      + [ctypes.c_int] * 3
                                      + [ctypes.c_void_p] * 2)

    def launch(a, b, out):
        (n, L), m = a.shape, b.shape[0]
        return lib.fgumi_umi_hamming(
            a.data_ptr(), b.data_ptr(), n, m, L, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    return launch


def hamming_call(launch, ad, bd, out):
    """One K4 launch of a build (``launch`` from ``bind_hamming``) on
    ``ad`` x ``bd`` into ``out``, on PyTorch's current stream."""
    def call():
        rc = launch(ad, bd, out)
        S.check(rc == 0, f"umi_hamming launch failed (cudaError {rc})")
        return out
    return call


def k4_ab(launches, dev, summary):
    """K4 of both builds at ``K4_SHAPES``: bit-identical, timed in turns."""
    import torch

    for n, m, L in K4_SHAPES:
        a, b = S.hamming_mats(n, m, L, seed=n + m, alphabet=b"ACGT")
        ad = torch.from_numpy(a).to(dev)
        bd = torch.from_numpy(b).to(dev)
        runs = {k: hamming_call(launch, ad, bd, torch.empty(
            (n, m), dtype=torch.int16, device=dev))
            for k, launch in launches.items()}
        got = {k: run() for k, run in runs.items()}
        torch.cuda.synchronize()
        key = f"{n}x{m}x{L}"
        S.check(torch.equal(got["base"], got["new"]),
                f"K4 {key}: output differs between the builds")
        print(f"K4 {key}: outputs bit-identical between base and new",
              flush=True)
        times = {"base": [], "new": []}
        for _ in range(TURNS):
            for kind in ("base", "new", "new", "base"):
                # every kernel the call launches (the new build: its bit
                # planes pass and the tile kernel)
                ms, seen = S.device_ms(runs[kind])
                times[kind].append({"device_ms": ms, "profiled": seen,
                                    "loop_ms": S.loop_ms(runs[kind])})
        bound_ms = ((n + m) * L + 2 * n * m) / S.HBM_BYTES_PER_S * 1e3
        print("ab " + json.dumps({"shape": key, "kernel": "K4",
                                  "bound_ms": bound_ms, **times}), flush=True)
        summary["times"][f"K4 {key}"] = {
            kind: [t["device_ms"] for t in ts] for kind, ts in times.items()}


def on(lib, call, module=None):
    """``call`` with the wrappers of ``module`` (default: the wire
    kernels' ``ops/cuda_kernel``) bound to the build ``lib``."""
    from fgumi_tpu_torch.ops import cuda_kernel

    module = module or cuda_kernel

    def run():
        module._LIB = lib
        return call()
    return run


def combine_ab(libs, dev, summary):
    """K5 and K6 of both builds at their main-path shapes: bit-identical,
    timed in turns."""
    import torch

    from fgumi_tpu_torch.ops import combine as C

    J, L, K = 23724, 128, 11757
    ops = S.duplex_ops(J, L, K, seed=K, lens_lo=92, lens_hi=100,
                       distinct=True)
    duplex = [torch.from_numpy(x).to(dev) for x in ops]
    T = 2678850
    codec = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in S.codec_strands(T, seed=T)]
    cases = (("K5", "duplex_combine_kernel", lambda: C.duplex_combine(*duplex),
              S.duplex_bytes(ops[3], ops[4], ops[5], J, L), f"{K}x{L}"),
             ("K6", "codec_combine_kernel", lambda: C.codec_combine(*codec),
              32 * T, f"{T}pos"))
    for kernel, symbol, call, nbytes, key in cases:
        runs = {k: on(lib, call, C) for k, lib in libs.items()}
        a = [t.clone() for t in runs["base"]()]
        b = [t.clone() for t in runs["new"]()]
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(a, b)):
            S.check(torch.equal(x, y), f"{kernel} {key}: output {i} differs "
                                       "between the builds")
        print(f"{kernel} {key}: outputs bit-identical between base and new",
              flush=True)
        times = {"base": [], "new": []}
        for _ in range(TURNS):
            for kind in ("base", "new", "new", "base"):
                ms, seen = S.device_ms(runs[kind], kernel=symbol)
                times[kind].append({"device_ms": ms, "profiled": seen,
                                    "loop_ms": S.loop_ms(runs[kind])})
        print("ab " + json.dumps({
            "shape": key, "kernel": kernel,
            "bound_ms": nbytes / S.HBM_BYTES_PER_S * 1e3, **times}),
            flush=True)
        summary["times"][f"{kernel} {key}"] = {
            kind: [t["device_ms"] for t in ts] for kind, ts in times.items()}


def canary_ab(libs, dev, summary):
    """K7 of both builds on the canary's payloads: equal sums, timed in
    turns."""
    import torch

    from fgumi_tpu_torch.ops import canary

    rng = np.random.default_rng(7)
    n = 1 << 20
    cases = {"zeros_1MiB": torch.zeros(n, dtype=torch.uint8, device=dev),
             "random_1MiB": torch.from_numpy(rng.integers(
                 0, 256, n, dtype=np.uint8)).to(dev),
             "random_1MiB_tail": torch.from_numpy(rng.integers(
                 0, 256, n + 13, dtype=np.uint8)).to(dev)}
    for key, x in cases.items():
        runs = {k: on(lib, lambda x=x: canary.canary_sum(x), canary)
                for k, lib in libs.items()}
        a, b = int(runs["base"]()), int(runs["new"]())
        S.check(a == b == int(x.to(torch.int64).sum()),
                f"K7 {key}: sums {a} (base) and {b} (new)")
        print(f"K7 {key}: sums equal between base and new", flush=True)
        times = {"base": [], "new": []}
        for _ in range(TURNS):
            for kind in ("base", "new", "new", "base"):
                ms, seen = S.device_ms(runs[kind],
                                       kernel="canary_sum_kernel")
                times[kind].append({"device_ms": ms, "profiled": seen,
                                    "loop_ms": S.loop_ms(runs[kind])})
        print("ab " + json.dumps({
            "shape": key, "kernel": "K7",
            "bound_ms": (x.numel() + 4) / S.HBM_BYTES_PER_S * 1e3,
            **times}), flush=True)
        summary["times"][f"K7 {key}"] = {
            kind: [t["device_ms"] for t in ts] for kind, ts in times.items()}


def tune_combine_ab(libs, dev, summary):
    """K8 of both builds on the tune phase's inputs: byte-identical
    outputs, timed in turns on the chooser bench's arrays."""
    import torch

    from fgumi_tpu_torch.ops import tune_combine as TC

    for n, L in S.TUNE_SHAPES:
        inputs = S.tune_combine_inputs(n, L, dev)
        for name, (x, y) in inputs.items():
            runs = {k: on(lib, lambda x=x, y=y: TC.tune_combine(x, y), TC)
                    for k, lib in libs.items()}
            a, b = runs["base"](), runs["new"]()
            torch.cuda.synchronize()
            S.check(torch.equal(a, b), f"K8 {name} {n}x{L}: outputs differ "
                                       "between the builds")
        print(f"K8 {n}x{L}: outputs byte-identical between base and new on "
              f"{', '.join(inputs)}", flush=True)
        x, y = inputs["sweep"]
        runs = {k: on(lib, lambda: TC.tune_combine(x, y), TC)
                for k, lib in libs.items()}
        times = {"base": [], "new": []}
        for _ in range(TURNS):
            for kind in ("base", "new", "new", "base"):
                ms, seen = S.device_ms(runs[kind],
                                       kernel="tune_combine_kernel")
                times[kind].append({"device_ms": ms, "profiled": seen,
                                    "loop_ms": S.loop_ms(runs[kind])})
        key = f"{n}x{L}"
        print("ab " + json.dumps({
            "shape": key, "kernel": "K8",
            "bound_ms": 3 * n * L / S.HBM_BYTES_PER_S * 1e3, **times}),
            flush=True)
        summary["times"][f"K8 {key}"] = {
            kind: [t["device_ms"] for t in ts] for kind, ts in times.items()}


CODEC_STATS = ("wall_s", "combine_s", "device_s", "host_s")
_BUILD_ALL = ("from fgumi_tpu_torch import native; "
              "from fgumi_tpu_torch.ops import cuda_kernel; "
              "native.build(); cuda_kernel.build()")


def codec_e2e_ab(base_tree: str, summary):
    """``codec`` on ``codec_320k`` in turns in ``base_tree`` and this
    tree, each in its own process: the ``--stats-json`` spans, and the
    records identical between the trees."""
    trees = {"base": os.path.abspath(base_tree),
             "new": os.path.dirname(os.path.abspath(__file__))}
    runs = {"base": [], "new": []}
    recs = {}
    with tempfile.TemporaryDirectory(prefix="codec_ab_") as tmp:
        inp = os.path.join(tmp, "codec_320k.bam")
        n, _ = S._simulate_codec(inp, S.CODEC["codec_320k"])
        for tree in trees.values():
            subprocess.run([sys.executable, "-c", _BUILD_ALL], cwd=tree,
                           env={**os.environ, "PYTHONPATH": tree},
                           check=True)
        for i, kind in enumerate(("base", "new", "new", "base") * TURNS):
            out = os.path.join(tmp, f"{kind}{i}.bam")
            proc = subprocess.run(
                [sys.executable, "-m", "fgumi_tpu_torch", "codec", "-i", inp,
                 "-o", out, "--min-reads", "1", "--stats-json",
                 out + ".json"], cwd=trees[kind],
                env={**os.environ, "PYTHONPATH": trees[kind]},
                capture_output=True, text=True)
            S.check(proc.returncode == 0, f"codec in the {kind} tree exited "
                                          f"{proc.returncode}: {proc.stderr}")
            with open(out + ".json") as f:
                st = json.load(f)
            run = {k: st[k] for k in CODEC_STATS}
            run["k6_launches"] = st["launches"]["codec_combine"]
            run["combine_positions"] = st["combine_positions"]
            runs[kind].append(run)
            recs.setdefault(kind, S.records(out))
            print("codec_ab " + json.dumps({"tree": kind, "turn": i,
                                            "reads": n, **run}), flush=True)
    S.check(recs["base"] == recs["new"],
            "codec records differ between the trees")
    print("codec_ab: records identical between the trees", flush=True)
    summary["codec_e2e"] = runs


# ------------------------------------------------------------------- SASS

_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.+?)\s*;")


def sass_functions(lib_path: str, save: str = None):
    """{mangled name: [(address, instruction text), ...]} from
    ``cuobjdump -sass`` (whose listing goes to ``save`` when given)."""
    out = subprocess.run(["cuobjdump", "-sass", lib_path],
                         capture_output=True, text=True, check=True).stdout
    if save:
        with open(save, "w") as f:
            f.write(out)
    funcs, cur = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = _INSN.search(line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def per_column_estimate(insns, rows_per_read: float, L: int,
                        loads_per_obs: int = 1):
    """Estimated executed thread instructions per output column from one
    kernel's static SASS. A row loop is an innermost loop with row loads
    inside a loop that stores to device memory, its column loop the
    smallest such loop around it; of the row loops with the most loads the
    one of the smallest column loop is taken (the path that stages a whole
    read before its column loop, not inside it). Per column ~ rows per read
    x the row loop's instructions per observation + the column loop's other
    instructions per column (each branch counted as if it ran). A kernel
    that stages rows in shared memory gives a lane one column and one
    observation per byte load (``LDS.U8``); one that reads 4-byte row words
    (``LDG``) gives a thread 4 columns, 4 observations a load, and blocks of
    round_up(L/4, 32) threads (at most 256); ``loads_per_obs`` such loads
    make one observation (K1-p2: its qual byte and its code byte). Also
    returns the share of lanes that work."""
    if any(re.search(r"\bLDS\.U8\b", t) for _, t in insns):
        load, per_load = r"\bLDS\.U8\b", 1
        lane_use = L / (32 * -(-L // 32))
    else:
        load, per_load = r"\bLDG\b", 4
        lane_use = (L // 4) / min(256, 32 * -(-(L // 4) // 32))
    index = {a: i for i, (a, _) in enumerate(insns)}
    loops = []  # (first, last) index of each backward branch's body
    for i, (_, text) in enumerate(insns):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)", text)
        if m and index.get(int(m.group(1), 16), i + 1) <= i:
            loops.append((index[int(m.group(1), 16)], i))

    def count(ab, pat):
        return sum(bool(re.search(pat, insns[k][1]))
                   for k in range(ab[0], ab[1] + 1))

    def around(ab):
        return [(a, b) for a, b in loops if a <= ab[0] and ab[1] <= b
                and (a, b) != ab and count((a, b), r"\bSTG\b")]

    rows = [ab for ab in loops if count(ab, load) and around(ab) and not any(
        ab[0] <= c and d <= ab[1] and (c, d) != ab for c, d in loops)]
    if not rows:
        return {"lane_use": lane_use}

    def column(ab):
        return min(around(ab), key=lambda cd: cd[1] - cd[0])

    row = max(rows, key=lambda ab: (count(ab, load),
                                    column(ab)[0] - column(ab)[1]))
    col = column(row)
    row_size = row[1] - row[0] + 1
    per_obs = row_size * loads_per_obs / (count(row, load) * per_load)
    per_col = (col[1] - col[0] + 1 - row_size) / per_load
    return {"lane_use": lane_use, "static_insns": len(insns),
            "row_loop_insns": row_size, "row_loop_loads": count(row, load),
            "column_loop_insns": col[1] - col[0] + 1,
            "per_observation": per_obs, "per_column_outside_rows": per_col,
            "per_column": per_obs * rows_per_read + per_col}


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    return float(out.stdout.strip().splitlines()[0])


# ------------------------------------------------------------------- main

def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="the other consensus_wire.cu, umi_hamming.cu, "
                         "strand_combine.cu or canary.cu to build and "
                         "compare")
    ap.add_argument("--sass-out", metavar="DIR",
                    help="write each build's cuobjdump -sass listing here")
    ap.add_argument("--codec-tree", metavar="DIR",
                    help="with strand_combine.cu: also run codec on "
                         "codec_320k in turns in this other checkout and "
                         "here")
    args = ap.parse_args()

    import torch

    from fgumi_tpu_torch.ops import cuda_kernel

    if not torch.cuda.is_available():
        S.fail("torch.cuda.is_available() is false: this needs a GPU", 2)
    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    base_name = os.path.basename(args.base)
    name = next((n for n in ("umi_hamming", "strand_combine", "canary",
                             "tune_combine")
                 if base_name.startswith(n)), "consensus_wire")
    hamming = name == "umi_hamming"
    srcs = {"base": args.base, "new": cuda_kernel.SOURCES[name]}
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        paths = {k: os.path.join(tmp, f"{k}.so") for k in srcs}
        with cf.ThreadPoolExecutor(2) as ex:
            logs = dict(zip(srcs, ex.map(cuda_kernel.compile_source,
                                         srcs.values(), paths.values())))
        for kind, log in logs.items():
            for line in log.splitlines():
                if "registers" in line or "spill" in line or \
                        "Compiling" in line:
                    print(f"ptxas {kind}: {line.strip()}", flush=True)
        summary = {"card": smi, "times": {}}
        if hamming:
            k4_ab({k: bind_hamming(p) for k, p in paths.items()}, dev,
                  summary)
            print(json.dumps(summary), flush=True)
            return
        if name == "canary":
            from fgumi_tpu_torch.ops import canary

            canary_ab({k: canary.bind(ctypes.CDLL(p))
                       for k, p in paths.items()}, dev, summary)
            print(json.dumps(summary), flush=True)
            return
        if name == "tune_combine":
            from fgumi_tpu_torch.ops import tune_combine

            tune_combine_ab({k: tune_combine.bind(ctypes.CDLL(p))
                             for k, p in paths.items()}, dev, summary)
            print(json.dumps(summary), flush=True)
            return
        if name == "strand_combine":
            from fgumi_tpu_torch.ops import combine

            if args.codec_tree:
                codec_e2e_ab(args.codec_tree, summary)
            combine_ab({k: combine.bind(ctypes.CDLL(p))
                        for k, p in paths.items()}, dev, summary)
            print(json.dumps(summary), flush=True)
            return
        libs = {k: cuda_kernel.bind(ctypes.CDLL(p)) for k, p in paths.items()}
        binders = {"K1-r": cuda_kernel.bind_resident,
                   "K1-p2": cuda_kernel.bind_packed2}
        both = {k for k, export in OPTIONAL.items()
                if all(hasattr(lib, export) for lib in libs.values())}
        for k in both:
            for lib in libs.values():
                binders[k](lib)
        kernels = {k: v for k, v in KERNELS.items()
                   if k not in OPTIONAL or k in both}
        print("kernels in both builds: " + ", ".join(kernels), flush=True)
        firsts = {}  # each kernel's first batch: its SASS estimate's
        for kernel, (symbol, batches) in kernels.items():
            for key, (shape, data, seed) in batches.items():
                call, batch = make_call(kernel, shape, data, seed, dev)
                rows_per_read, J, L = batch
                firsts.setdefault(kernel, batch)
                runs = {k: on(lib, call) for k, lib in libs.items()}
                a = [t.clone() for t in runs["base"]()]
                b = [t.clone() for t in runs["new"]()]
                torch.cuda.synchronize()
                for i, (x, y) in enumerate(zip(a, b)):
                    S.check(torch.equal(x, y), f"{kernel} {key}: output {i} "
                                               "differs between the builds")
                print(f"{kernel} {key}: all {len(a)} outputs bit-identical "
                      "between base and new", flush=True)
                times = {"base": [], "new": []}
                for _ in range(TURNS):
                    for kind in ("base", "new", "new", "base"):
                        ms, seen = S.device_ms(runs[kind], kernel=symbol)
                        times[kind].append({"device_ms": ms,
                                            "profiled": seen,
                                            "loop_ms": S.loop_ms(runs[kind])})
                rep = {"shape": key, "kernel": kernel, "reads": J, "L": L,
                       "rows": round(rows_per_read * J), **times}
                if kernel in COL_BYTES:
                    rep["bound_ms"] = S.wire_kernel_bytes(
                        rep["rows"], L, J, COL_BYTES[kernel]) \
                        / S.HBM_BYTES_PER_S * 1e3
                elif kernel == "K1-p2":
                    rep["bound_ms"] = S.packed2_kernel_bytes(
                        rep["rows"], L, J) / S.HBM_BYTES_PER_S * 1e3
                print("ab " + json.dumps(rep), flush=True)
                summary["times"][f"{kernel} {key}"] = {
                    kind: [t["device_ms"] for t in ts]
                    for kind, ts in times.items()}

        clock = sm_clock_mhz()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for kind, path in paths.items():
            save = None
            if args.sass_out:
                os.makedirs(args.sass_out, exist_ok=True)
                save = os.path.join(args.sass_out, f"{kind}.sass")
            funcs = sass_functions(path, save)
            for kernel, (symbol, _) in kernels.items():
                rows_per_read, J, L = firsts[kernel]
                insns = funcs[next(k for k in funcs if symbol in k)]
                if kernel == "K1-p2" and not any(
                        re.search(r"\bLDS\.U8\b", t) for _, t in insns):
                    # K1-p2's first design: two byte loads an observation
                    # from global memory, not a shape the load rule reads
                    continue
                rep = {"build": kind, "kernel": kernel,
                       "method": "cuobjdump -sass, static estimate at the "
                                 "kernel's first batch; every branch counted "
                                 "as if it ran",
                       **per_column_estimate(
                           insns, rows_per_read, L,
                           2 if kernel == "K1-p2" else 1)}
                if "per_column" in rep:
                    warp_insns = (rep["per_column"] * J * L
                                  / (32 * rep["lane_use"]))
                    rep["warp_insns"] = warp_insns
                    rep["sm_clock_mhz"] = clock
                    rep["issue_bound_ms"] = (warp_insns
                                             / (sms * 4 * clock * 1e6) * 1e3)
                print("sass " + json.dumps(rep), flush=True)
                summary[f"sass_{kind}_{kernel}"] = rep
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
