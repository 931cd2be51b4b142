#!/usr/bin/env python3
"""Same-card A/B of two builds of the port's kernel source, plus a static
SASS estimate of each kernel's instructions per column.

Run from the repository root on a machine with one NVIDIA H100, with the
other source unpacked into the gitignored ``_base/`` (for example the
parent commit's: ``git show <commit>:fgumi_tpu_torch/csrc/consensus_wire.cu
> _base/consensus_wire.cu``):

    python3 kernel_ab.py --base _base/consensus_wire.cu [--sass-out DIR]

1. builds ``--base`` and this tree's source in parallel with the port's
   nvcc flags and prints each build's ptxas register and spill lines;
2. makes each kernel's main-path batches as ``chip_smoke.py`` makes them:
   for K1, the subject, the largest fast batches of ``fixed5_1M`` and
   ``longtail_200k`` (56,780 rows x 152 over 11,356 reads; 35,649 rows
   over 6,634 longtail reads of up to 50 rows); for K1-f, the control, the
   largest fused batches (the same shapes, made from other seeds: the
   longtail one has 36,938 rows);
3. calls each build through the port's own wrappers
   (``cuda_kernel.consensus_wire_full`` for K1,
   ``consensus_wire_filter`` for K1-f) and requires every output
   bit-identical between the builds;
4. times each kernel of each build in turns (base, new, new, base, twice):
   torch.profiler device time per launch over 25 launches, and CUDA-event
   time per launch over 25 back-to-back launches;
5. estimates from ``cuobjdump -sass`` each kernel's executed instructions
   per column at the fixed5 batch (see ``per_column_estimate``) and the
   issue-rate bound that implies (4 warp instructions per clock per SM at
   the card's maximum SM clock);
6. prints one JSON line per result and, last, a JSON summary.

(``ncu``, which would count executed instructions, is in the card
machine's toolkit but cannot load its counter library there.)
"""

import argparse
import concurrent.futures as cf
import ctypes
import json
import os
import re
import subprocess
import tempfile

import numpy as np

import chip_smoke as S

# kernel: (symbol, {batch: (shape (rows, L, reads), longtail sizes, seed)}),
# each batch as chip_smoke's main-path phase makes it for that kernel
KERNELS = {
    "K1": ("consensus_wire_full_kernel", {
        "fixed5": ((56780, 152, 11356), False, len("k1_fixed")),
        "longtail": ((52974, 152, 6634), True, len("k1_longtail"))}),
    "K1-f": ("consensus_wire_filter_kernel", {
        "fixed5": ((56780, 152, 11356), False, len("k1f_fixed")),
        "longtail": ((52974, 152, 6634), True, len("k1f_longtail"))}),
}
TURNS = 2


def make_call(kernel: str, shape, longtail: bool, seed: int, dev):
    """The kernel's wrapper call on one main-path batch, and the batch's
    (rows per read, reads, L)."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    codes, quals, starts, lens = S.main_path_batch(shape, longtail, seed)
    kern = ConsensusKernel(quality_tables(45, 40), dev)
    wire, dict64, starts_d, _ = S.wire_on_device(kern, codes, quals, starts,
                                                 dev, "kernel_ab")
    if kernel == "K1":
        def call():
            return cuda_kernel.consensus_wire_full(wire, starts_d, dict64,
                                                   kern._pre)
    else:
        fp = S.filter_stage(3, 25).dev_params
        lens_d = torch.from_numpy(lens).to(dev)
        emin = torch.from_numpy(fp.emin_tab.astype(np.int32)).to(dev)

        def call():
            return cuda_kernel.consensus_wire_filter(
                wire, starts_d, dict64, kern._pre, S.MIN_READS_C,
                S.MIN_QUAL_C, lens_d, fp.min_reads, emin, fp.min_base_q,
                fp.per_base)
    J = len(starts) - 1
    return call, codes.shape[0] / J, J, codes.shape[1]


def on(lib, call):
    """``call`` with the wrappers bound to the build ``lib``."""
    from fgumi_tpu_torch.ops import cuda_kernel

    def run():
        cuda_kernel._LIB = lib
        return call()
    return run


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


def per_column_estimate(insns, rows_per_read: float, L: int):
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
    round_up(L/4, 32) threads (at most 256). Also returns the share of
    lanes that work."""
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
    per_obs = row_size / (count(row, load) * per_load)
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
                    help="the other consensus_wire.cu to build and compare")
    ap.add_argument("--sass-out", metavar="DIR",
                    help="write each build's cuobjdump -sass listing here")
    args = ap.parse_args()

    import torch

    from fgumi_tpu_torch.ops import cuda_kernel

    if not torch.cuda.is_available():
        S.fail("torch.cuda.is_available() is false: this needs a GPU", 2)
    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    srcs = {"base": args.base, "new": cuda_kernel._SRC}
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
        libs = {k: cuda_kernel.bind(ctypes.CDLL(p)) for k, p in paths.items()}
        summary = {"card": smi, "times": {}}
        fixed = None
        for kernel, (symbol, batches) in KERNELS.items():
            for key, (shape, longtail, seed) in batches.items():
                call, rows_per_read, J, L = make_call(kernel, shape,
                                                      longtail, seed, dev)
                fixed = fixed or (rows_per_read, J, L)
                runs = {k: on(lib, call) for k, lib in libs.items()}
                a = [t.clone() for t in runs["base"]()]
                b = [t.clone() for t in runs["new"]()]
                torch.cuda.synchronize()
                for i, (x, y) in enumerate(zip(a, b)):
                    S.check(torch.equal(x, y), f"{kernel} {key}: output {i} "
                                               "differs between the builds")
                print(f"{kernel} {key}: outputs bit-identical between base "
                      "and new", flush=True)
                times = {"base": [], "new": []}
                for _ in range(TURNS):
                    for kind in ("base", "new", "new", "base"):
                        ms, seen = S.device_ms(runs[kind], kernel=symbol)
                        times[kind].append({"device_ms": ms,
                                            "profiled": seen,
                                            "loop_ms": S.loop_ms(runs[kind])})
                print("ab " + json.dumps({"shape": key, "kernel": kernel,
                                          "reads": J, "L": L, **times}),
                      flush=True)
                summary["times"][f"{kernel} {key}"] = {
                    kind: [t["device_ms"] for t in ts]
                    for kind, ts in times.items()}

        clock = sm_clock_mhz()
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        rows_per_read, J, L = fixed
        for kind, path in paths.items():
            save = None
            if args.sass_out:
                os.makedirs(args.sass_out, exist_ok=True)
                save = os.path.join(args.sass_out, f"{kind}.sass")
            funcs = sass_functions(path, save)
            for kernel, (symbol, _) in KERNELS.items():
                insns = funcs[next(k for k in funcs if symbol in k)]
                rep = {"build": kind, "kernel": kernel,
                       "method": "cuobjdump -sass, static estimate",
                       **per_column_estimate(insns, rows_per_read, L)}
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
