#!/usr/bin/env python3
"""Same-card A/B of the port's host path: another tree against this one.

Run from the repository root on a machine with one NVIDIA H100, with the
other tree (for example the parent commit's ``git archive``) unpacked in a
gitignored directory:

    python3 io_ab.py --base _base/tree

It builds both trees' native library and CUDA kernels (each in its own
``fgumi_tpu_torch/_build``, all at once), simulates ``chip_smoke.py``'s
``fixed5_1M``, ``duplex_240k`` and ``pipeline_400k`` inputs once, and runs
``simplex``, ``duplex`` (also ``--device-filter``: ``duplex_240k_df``) and
``pipeline`` on ``cuda`` in each tree, each in a
process of its own, serially and at ``--threads 4``, in turns (base, new,
new, base; ``--rounds N`` repeats the turns N times). ``--only
CASE:MODE,...`` (for example ``pipeline_400k:t4,duplex_240k:serial``) runs
those cells alone and simulates only their inputs; ``--trace`` runs each
command under the global ``--trace`` and adds the seconds of each span
name (summed over threads) to its line. Each run prints an ``ab`` line: its wall (``--stats-json``'s
``wall_s``) and process time, the stage busy seconds of its stage table
(``pipeline``: the simplex stage's, and each stage's wall), its launches
and a digest of its records, which must be equal across every run of a
case. The last lines are a summary of each tree's walls a case and mode,
and the card's name and power limit. Exits 2 without CUDA.
"""

import argparse
import concurrent.futures as cf
import hashlib
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time

import chip_smoke as cs

ROOT = os.path.dirname(os.path.abspath(__file__))
# case: (command, input, flags before -o)
CASES = {
    "fixed5_1M_fast": ("simplex", "fixed5_1M", []),
    "duplex_240k": ("duplex", "duplex_240k", []),
    "duplex_240k_df": ("duplex", "duplex_240k",
                       ["--device-filter", "--filter-min-reads", "6,3,3"]),
    "pipeline_400k": ("pipeline", "pipeline_400k", cs.PIPELINE_OPTS),
}
MODES = {"serial": [], "t4": ["--threads", "4"]}
ORDER = ("base", "new", "new", "base")

_BUILD = ("from fgumi_tpu_torch import native; "
          "from fgumi_tpu_torch.ops import cuda_kernel; "
          "native.build(); cuda_kernel.build()")


def build(tree: str) -> float:
    t0 = time.monotonic()
    subprocess.run([sys.executable, "-c", _BUILD], cwd=tree, check=True,
                   capture_output=True, timeout=600)
    return time.monotonic() - t0


def records_digest(path: str) -> str:
    from fgumi_tpu_torch.io.bam import BamReader

    h = hashlib.sha256()
    n = 0
    with BamReader(path) as r:
        for rec in r:
            h.update(len(rec.data).to_bytes(4, "little"))
            h.update(rec.data)
            n += 1
    return f"{n}:{h.hexdigest()[:16]}"


def span_seconds(path: str) -> dict:
    """Seconds of each span name in a Chrome trace, summed over threads."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    out = {}
    for e in events:
        if e.get("ph") == "X":
            out[e["name"]] = out.get(e["name"], 0.0) + e["dur"] / 1e6
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run(tree_name: str, tree: str, case: str, mode: str, inp, work: str,
        k: int, trace: bool = False) -> dict:
    command, _, flags = CASES[case]
    out = os.path.join(work, f"{case}.{mode}.{tree_name}.{k}.bam")
    stats_path = out + ".json"
    trace_path = out + ".trace.json"
    inputs = list(inp) if isinstance(inp, tuple) else [inp]
    argv = [sys.executable, "-m", "fgumi_tpu_torch",
            *(["--trace", trace_path] if trace else []), command, "-i",
            *inputs,
            *flags, "-o", out, "--device", "cuda", "--stats-json",
            stats_path, *MODES[mode]]
    t0 = time.monotonic()
    proc = subprocess.run(argv, cwd=tree, capture_output=True, text=True,
                          timeout=900)
    proc_s = time.monotonic() - t0
    cs.check(proc.returncode == 0,
             f"{tree_name} {case} {mode}: exit {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    with open(stats_path) as f:
        st = json.load(f)
    own = st["stages"]["simplex"] if command == "pipeline" else st
    line = {"tree": tree_name, "case": case, "mode": mode,
            "wall_s": st["wall_s"], "process_s": proc_s,
            "busy_s": own.get("stage_table", {}).get("busy_s"),
            "launches": {k: v for k, v in st["launches"].items() if v},
            "records": records_digest(out)}
    if command == "pipeline":
        line["stage_wall_s"] = {k.split(".")[2]: v for k, v in st.items()
                                if k.startswith("pipeline.stage.")}
    if trace:
        line["spans_s"] = span_seconds(trace_path)
        os.unlink(trace_path)
    print("ab " + json.dumps(line), flush=True)
    os.unlink(out)
    return line


def main():
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this A/B needs a GPU",
                2)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--base", required=True,
                    help="the other tree (a directory with fgumi_tpu_torch)")
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the turns (base, new, new, base) N times")
    ap.add_argument("--trace", action="store_true",
                    help="trace each run and add its span seconds")
    ap.add_argument("--only", default="",
                    help="CASE:MODE cells to run, comma-separated "
                         "(default: every case in every mode)")
    args = ap.parse_args()
    cells = [tuple(c.split(":", 1)) for c in args.only.split(",") if c] \
        or [(c, m) for c in CASES for m in MODES]
    for case, mode in cells:
        cs.check(case in CASES and mode in MODES,
                 f"--only: unknown cell {case}:{mode}")
    wanted = {CASES[c][1] for c, _ in cells}
    trees = {"base": os.path.abspath(args.base), "new": ROOT}
    for name, tree in trees.items():
        cs.check(os.path.isdir(os.path.join(tree, "fgumi_tpu_torch")),
                 f"{name} tree {tree} has no fgumi_tpu_torch")
    smi = cs.nvidia_smi_line()
    print(smi, flush=True)
    print(f"cpu_count {os.cpu_count()} affinity "
          f"{len(os.sched_getaffinity(0))}", flush=True)
    sims = {"fixed5_1M": (cs._simulate, cs.INPUTS["fixed5_1M"]),
            "duplex_240k": (cs._simulate_duplex, cs.DUPLEX["duplex_240k"]),
            "pipeline_400k": (cs._simulate_fastq,
                              cs.FASTQ["pipeline_400k"])}
    sims = {k: v for k, v in sims.items() if k in wanted}
    with tempfile.TemporaryDirectory(prefix="io_ab_") as work:
        paths = {"fixed5_1M": os.path.join(work, "fixed5_1M.bam"),
                 "duplex_240k": os.path.join(work, "duplex_240k.bam"),
                 "pipeline_400k": (os.path.join(work, "p.r1.fq.gz"),
                                   os.path.join(work, "p.r2.fq.gz"))}
        with cf.ProcessPoolExecutor(
                max_workers=len(sims),
                mp_context=multiprocessing.get_context("spawn")) as pool, \
                cf.ThreadPoolExecutor(max_workers=2) as builders:
            futs = {k: pool.submit(fn, paths[k], kw)
                    for k, (fn, kw) in sims.items()}
            built = {k: builders.submit(build, t) for k, t in trees.items()}
            for k, fut in built.items():
                print(f"built {k} in {fut.result():.1f}s", flush=True)
            for k, fut in futs.items():
                n, dt = fut.result()
                print(f"built input {k}: {n} records in {dt:.1f}s",
                      flush=True)
        summary = {}
        digests = {}
        for case, mode in cells:
            inp = CASES[case][1]
            for k, name in enumerate(ORDER * max(args.rounds, 1)):
                line = run(name, trees[name], case, mode, paths[inp],
                           work, k, args.trace)
                digests.setdefault(case, set()).add(line["records"])
                summary.setdefault(f"{case} {mode} {name}", []).append(
                    line["wall_s"])
        for case, got in digests.items():
            cs.check(len(got) == 1,
                     f"{case}: records differ between runs: {got}")
    print("summary " + json.dumps(summary), flush=True)
    print(smi, flush=True)


if __name__ == "__main__":
    main()
