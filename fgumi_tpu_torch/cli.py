"""Command line of the PyTorch/CUDA port: ``pipeline``, ``extract``,
``correct``, ``fastq``, ``zipper``, ``sort``, ``merge``, ``group``,
``dedup``, ``simplex``, ``duplex``, ``codec``, ``filter``, ``clip``,
``downsample``, ``review``, ``duplex-metrics``, ``simplex-metrics``,
``compare bams|metrics``, ``simulate grouped-reads|duplex-reads|
codec-reads|mapped-reads|fastq-reads|consensus-reads|correct-reads`` and
the job service: ``serve`` (a warm daemon running submitted commands, each
in its own telemetry scope, with the health canary K7 and the device
breaker; ``serve/``), ``submit``, ``jobs`` and ``stats``; and ``tune``,
the autotuner: it times the wire kernel K1 against the native f64 host
engine over a simulated matrix and the tuner's combine K8 against numpy,
and writes a deployment profile and a crossover atlas (``tune/``). The
global ``--profile`` (or ``FGUMI_TPU_PROFILE``) loads such a profile once
a process, before any other knob is read: it fills the ``FGUMI_TPU_*``
variables left unset and seeds the router's and the choosers' priors.

``correct``, ``fastq``, ``zipper``, ``merge``, ``clip``, ``downsample``,
``review``, ``duplex-metrics`` and ``simplex-metrics`` are host commands
(no ``--device``, as in the reference; nothing touches CUDA) with the
reference's options: ``correct`` and ``zipper`` run a batch engine unless
``--classic`` asks for the per-template one (``zipper`` also takes it for
``--restore-unconverted-bases`` and for a ``--tags-to-remove`` of a tag it
appends), ``merge`` merges each input's batch-extracted sort keys; the
other five run a record or a template at a time, as the reference does.

``simplex``, ``duplex``, ``codec``, ``group`` and ``dedup`` take
``--device {cuda,cpu}`` (default
``cuda``): ``cuda`` runs the hand-written CUDA kernels and exits 2 when no
CUDA device is present; ``cpu`` runs the kernels' plain PyTorch versions.
``simplex`` runs the fast (native-batch) engine unless ``--classic`` asks
for the per-record engine; ``--device-filter`` fuses the ``filter`` command
into it (kernel K1-f on the fast engine); ``--em-seq``/``--taps`` (with
``--ref``) call methylation-aware consensus, every group on the per-group
path, and ``--rejects`` writes the raw reads no consensus used. ``duplex``
runs its fast engine unless ``--classic``, ``--trim`` or ``--rejects`` asks
for the per-molecule one (``--methylation-mode`` keeps the fast engine and
takes every molecule down its per-molecule path); the
fast engine's single-strand consensus runs on kernel K1-r, which keeps the
strand combine's arrays on the device, and its eligible rows combine there
(K5), the classic engine's on K1; on both ``--device-filter`` filters the
records in process. ``codec`` runs its batch engine (K1, then the combine
K6 on the device) unless ``--classic`` or ``--rejects`` asks for the
per-molecule one. ``group`` runs the fast (native-batch)
engine unless ``--classic`` asks for the per-template engine; on either,
position groups of at least 1,024 distinct UMIs compute their distances
through kernel K4; ``dedup`` marks duplicates on the same assigners (its
batch engine unless ``--classic``). ``filter`` takes simplex and duplex
consensus records
and runs its batch engine unless ``--classic`` (or ``--ref``,
``--reverse-per-base-tags`` or ``--require-single-strand-agreement``) asks
for the per-record one; both take the EM-Seq/TAPS depth mask, and the
per-record one the reference-dependent methylation filters. A
corrupt or truncated input exits 2 with one line, as the reference's
does; so do its other exits: 1 on a broken output pipe, 3 on an injected
fault (``FGUMI_TPU_FAULT``), 4 on a full disk (``ENOSPC``) or another
exhausted resource, 5 on a refuted ``--audit-output`` and 130 on an
interrupt, each with at most one line and no traceback. A device batch
that its retries or out-of-memory halvings cannot finish exits 3
(injected), 4 (device memory) or 1 (a CUDA error): the reference finishes
it on a host engine, which the port does not have. The reference's
global options come before the command (``-v``, ``--log-level``,
``--no-atomic-output``, ``--audit-output``, ``--trace``, ``--run-report``,
``--heartbeat``, ``--flight-dump-dir``; ``observe/``), and the outermost
invocation owns the trace, the run report and the heartbeat; ``trace-merge``
stitches trace files. ``extract`` turns FASTQ
into unmapped BAM, ``sort`` orders BAM template-coordinate, coordinate
(with a BAI or CSI index) or queryname on the native sort engine, and
``pipeline`` chains extract ⇒ sort ⇒ group ⇒ simplex ⇒ filter in one
process (fused:
one thread a stage, in-memory channels between them; ``--no-fuse``:
intermediate BAM files), forwarding ``--device`` to group and simplex.

``--threads N`` runs the batch engines of ``simplex``, ``duplex``,
``codec`` and ``group`` on the stage runner (``pipeline.run_stages``): a
reader and a writer thread around the processing thread, with resolve
workers from N = 4 (on ``--device cuda`` at least two); ``--max-memory``
bounds the input batches it holds, ``--stats`` prints each stage's busy and
blocked time. Records do not depend on N. The reference's pipeline-tuning
flags (``--scheduler``, ``--deadlock-timeout``, ``--deadlock-recover``,
``--memory-per-thread``, ``--pipeline-stats``, ``--async-reader``) map as
the reference maps them. Options of the reference CLI this port does not
implement yet exit 2 with "not yet ported" instead of being ignored, and
so do their environment forms (``FGUMI_TPU_MESH`` and ``FGUMI_TPU_SP``
where they would shard, also a mesh a profile filled; a mesh value the
reference rejects gets its knob line). ``FGUMI_TPU_DEVICE_FILTER`` is read
as the reference reads it: ``1``/``true``/``on``/``force`` stand for
``--device-filter``, ``0``/``false``/``off`` keep the fused filter on
full columns (K1 in place of K1-f).
"""

import argparse
import contextvars
import errno
import json
import logging
import os
import sys
import time

from .io.errors import InputFormatError, OutputIntegrityError
from .utils.governor import GOVERNOR, ResourceExhausted

log = logging.getLogger("fgumi_tpu_torch")

PROGRAM_ID = "fgumi-tpu-torch"


def _parse_bool(s: str) -> bool:
    """fgbio-style boolean flag values, as the reference's CLI parses them
    (its later ``_parse_bool``, fgumi_tpu/cli.py, is the one its parsers
    call: ``y`` and ``n`` are refused)."""
    if isinstance(s, bool):
        return s
    if s.lower() in ("true", "t", "yes", "1"):
        return True
    if s.lower() in ("false", "f", "no", "0"):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {s!r}")


def _devices_arg(s: str):
    if s == "auto":
        return s
    try:
        return int(s)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected 'auto' or an integer device count, got {s!r}")


def _unmapped_consensus_header(read_group_id: str, argv):
    """Unmapped-consensus output header: no reference sequences, single RG,
    @PG capturing the command line (consensus_runner.rs:115+)."""
    from .io.bam import BamHeader

    return BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             f"@RG\tID:{read_group_id}\tSM:sample\n"
             f"@PG\tID:{PROGRAM_ID}\tPN:{PROGRAM_ID}\tCL:"
             + " ".join(argv) + "\n",
        ref_names=[], ref_lengths=[])


def _given(v) -> bool:
    return v is not None


# options of the reference `simplex` and `duplex` that the port does not
# implement
_NOT_PORTED = (
    ("devices", "--devices > 1", lambda v: v not in ("auto", 1)),
)


def _add_shard_opts(p):
    """The scatter sub-job option group of ``simplex`` and ``duplex``
    (``pipeline`` forwards it to its simplex stage): process only shard K
    of an N-way content-hash split of the grouped input
    (``core/sharding.py``), as the reference's ``_add_shard_opts``."""
    g = p.add_argument_group(
        "scatter sharding",
        "run as one shard of a scattered whale job (`balance --scatter` "
        "plans these): the grouped input streams through a deterministic "
        "content-hash family filter, and a sidecar manifest records the "
        "kept families' global ordinals for the byte-deterministic gather "
        "merge")
    g.add_argument("--shard", default=None, metavar="K/N",
                   help="keep only MI families hashing to slot K of an "
                        "N-way split (0-based; e.g. 1/4)")
    g.add_argument("--shard-by", choices=["umi", "coord"], default="umi",
                   help="shard axis: umi = numeric MI value hash, coord = "
                        "both-ends template position hash (default umi)")
    g.add_argument("--shard-manifest", default=None, metavar="PATH",
                   help="write the kept-family (ordinal, MI) manifest "
                        "sidecar here (required by the gather stage)")
    g.add_argument("--pg-argv", default=None, metavar="CMDLINE",
                   help="record THIS command line (shlex-quoted) in output "
                        "provenance (@PG CL) instead of the actual argv, so "
                        "shard outputs carry the whale job's provenance and "
                        "gather merges byte-identically")


def _shard_filter_from_args(args):
    """ShardFilter from the --shard option group, or None. Raises
    ValueError (the caller logs it and exits 2) on a malformed spec."""
    if not getattr(args, "shard", None):
        return None
    from .core.sharding import ShardFilter, parse_shard_arg

    spec = parse_shard_arg(args.shard, args.shard_by)
    return ShardFilter(spec, args.shard_manifest)


def _finish_shard(shard, args, command: str):
    """Write a shard run's manifest and log its tally."""
    if shard is None:
        return
    shard.write_manifest()
    log.info("%s shard %s: %d/%d families kept (%d records)", command,
             args.shard, len(shard.manifest()), shard.families_seen,
             shard.records_kept)

_DEFAULT_SCHEDULER = "balanced-chase-drain"
# the reference's 14 selectable strategies (scheduler/mod.rs:70-178): a
# known name is accepted and logged as a no-op, anything else exits 2 so a
# typo cannot silently change nothing
_KNOWN_SCHEDULERS = frozenset({
    "fixed-priority", "chase-bottleneck", "thompson-sampling", "ucb",
    "epsilon-greedy", "thompson-with-priors", "hybrid-adaptive",
    "backpressure-proportional", "two-phase", "sticky-work-stealing",
    "learned-affinity", "optimized-chase", "balanced-chase",
    "balanced-chase-drain"})

# nesting depth of main(): the staged pipeline re-enters it per stage
_MAIN_DEPTH = contextvars.ContextVar("fgumi_tpu_torch_main_depth",
                                     default=0)


def _add_pipeline_compat(p):
    """The reference's pipeline-tuning flags (common.rs:625-646,954). The
    stage runner has fixed roles in place of the reference's adaptive
    scheduler, so some have nothing to tune; they parse, and
    :func:`_apply_pipeline_compat` maps those that have a counterpart."""
    p.add_argument("--scheduler", default=_DEFAULT_SCHEDULER, metavar="NAME",
                   help="accepted for compatibility: the stage runner has "
                        "a fixed reader->process->writer schedule")
    p.add_argument("--pipeline-stats", action="store_true",
                   help="alias of --stats on the commands that print a "
                        "stage table")
    p.add_argument("--deadlock-timeout", type=float, default=60.0,
                   metavar="SECONDS",
                   help="stall-watchdog interval of a threaded run (0: off)")
    p.add_argument("--deadlock-recover", action="store_true",
                   help="double the queue and byte limits when the "
                        "watchdog sees a stall (reference deadlock.rs:409)")
    p.add_argument("--async-reader", action="store_true",
                   help="accepted for compatibility: the reader is a thread "
                        "of its own with --threads >= 2")
    p.add_argument("--memory-per-thread", default=None, metavar="SIZE",
                   help="working-set budget a thread; times the thread "
                        "count, it becomes --max-memory where the command "
                        "has one")


def _apply_pipeline_compat(args) -> int:
    """Map the flags of :func:`_add_pipeline_compat` onto the command's
    own knobs, once after parsing (a command without them is untouched).
    Returns 0, or 2 on a value the reference refuses."""
    if getattr(args, "memory_per_thread", None):
        from .utils.memory import parse_size

        try:
            per = parse_size(args.memory_per_thread)
        except ValueError as e:
            log.error("--memory-per-thread: %s", e)
            return 2
        # per worker times the workers (common.rs:954); without --threads
        # the reference counts the cores
        threads = int(getattr(args, "threads", 0) or 0)
        n = threads if threads > 0 else (os.cpu_count() or 1)
        mm = getattr(args, "max_memory", None)
        if mm is not None and str(mm).strip().lower() != "auto":
            log.info("--memory-per-thread: --max-memory %s set explicitly "
                     "and takes precedence", args.max_memory)
        elif hasattr(args, "max_memory"):
            # a byte suffix: a bare number means MiB to parse_size
            args.max_memory = f"{per * n}B"
        else:
            log.info("--memory-per-thread: no memory knob on this command; "
                     "ignored")
    if getattr(args, "scheduler", _DEFAULT_SCHEDULER) != _DEFAULT_SCHEDULER:
        if args.scheduler not in _KNOWN_SCHEDULERS:
            log.error("--scheduler %s: unknown strategy (the reference "
                      "accepts: %s)", args.scheduler,
                      ", ".join(sorted(_KNOWN_SCHEDULERS)))
            return 2
        log.info("--scheduler %s: accepted for compatibility; the stage "
                 "runner has a fixed reader->process->writer schedule",
                 args.scheduler)
    if getattr(args, "deadlock_recover", False):
        log.info("--deadlock-recover: the stall watchdog doubles the queue "
                 "and byte limits on each stall")
    if getattr(args, "max_memory", None) is not None:
        from .utils.memory import resolve_budget

        try:
            resolve_budget(args.max_memory)
        except ValueError as e:
            log.error("--max-memory: %s", e)
            return 2
    if getattr(args, "pipeline_stats", False):
        if hasattr(args, "stats"):
            args.stats = True
        else:
            log.info("--pipeline-stats: this command prints no stage "
                     "table; ignored")
    if getattr(args, "async_reader", False) \
            and int(getattr(args, "threads", 0) or 0) < 2:
        if hasattr(args, "threads"):
            log.info("--async-reader: accepted for compatibility; add "
                     "--threads >= 2 for a reader thread")
        else:
            log.info("--async-reader: accepted for compatibility (this "
                     "command reads inline)")
    return 0


def _add_threads(p, help_text: str):
    p.add_argument("--threads", type=int, default=0, help=help_text)


def _add_stats(p):
    p.add_argument("--stats", action="store_true",
                   help="print each stage's busy and blocked seconds, peak "
                        "RSS and the device dispatches")


def _add_max_memory(p):
    p.add_argument("--max-memory", default="auto",
                   help="working-set budget of the stage runner (MiB "
                        "count, human size or auto): half of it bounds the "
                        "queued input batches")


def _stage_kwargs(args) -> dict:
    """run_stages keywords from the shared flags: the input budget from
    --max-memory (reference QueueMemoryOptions, common.rs:759-993) and
    the watchdog's interval and recovery."""
    wi = getattr(args, "deadlock_timeout", None)
    kw = {"watchdog_interval": 120.0 if wi is None else wi,
          "deadlock_recover": getattr(args, "deadlock_recover", False)}
    mm = getattr(args, "max_memory", None)
    if mm is not None:
        from .utils.memory import resolve_budget

        # half the budget bounds the queued input batches; the rest covers
        # the process stage's padded arrays and the outputs in flight
        kw["max_bytes"] = max(resolve_budget(mm) // 2, 1 << 20)
        # a queued batch's working set: the inflated buffer, its decoded
        # columns and the padded gathers, about 3x the raw bytes
        kw["item_bytes"] = lambda b: 3 * b.buf.nbytes
    return kw


def _consensus_stage_kwargs(args) -> dict:
    """:func:`_stage_kwargs` plus the resolve pool of a consensus command
    on ``--device cuda``: at least two workers at any thread count >= 2,
    so a worker waiting on a fetch never holds up the chunk behind it (the
    reference's device-attached sizing)."""
    kw = _stage_kwargs(args)
    if args.device == "cuda":
        kw["resolve_workers"] = max(args.threads - 3, 2)
    return kw


def _stage_stats(args, stats) -> dict:
    """The ``--stats-json`` keys of the stage runner: the thread count,
    the stage table and the device accounting of the command (in a fused
    pipeline, of every stage so far)."""
    from .ops.kernel import DEVICE_STATS

    return {"threads": args.threads, "stage_table": stats.as_dict(),
            "device_stats": DEVICE_STATS.snapshot()}


def _print_stats(stats, wall_s=None):
    """--stats: the stage table and queue occupancy, the peak RSS, and the
    device accounting (dispatches, fetch wait, bytes, the per-dispatch
    timeline) when a consensus kernel dispatched in this run."""
    from .ops.kernel import DEVICE_STATS

    print(stats.format_table())
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM"):
                    print(f"peak RSS   {line.split()[1]} kB")
                    break
    except OSError:
        pass
    if not DEVICE_STATS.dispatches:
        return
    print(DEVICE_STATS.format_summary(wall_s))
    done = [t for t in DEVICE_STATS.timeline_snapshot() if "t_fetched" in t]
    if not done:
        return
    lats = sorted(t["t_fetched"] - t["t_dispatch"] for t in done)
    print(f"device timeline: {len(done)} dispatches resolved, latency p50 "
          f"{lats[len(lats) // 2]:.3f}s max {lats[-1]:.3f}s")
    for t in done[:12]:
        print(f"  t+{t['t_dispatch']:7.3f}s  up {t['up_bytes']:>9}B"
              f"  -> fetched t+{t['t_fetched']:7.3f}s"
              f"  down {t['down_bytes']:>8}B"
              f"  wait {t['fetch_wait_s']:.3f}s")
    if len(done) > 12:
        print(f"  ... {len(done) - 12} more")


def _add_compression_level(p):
    p.add_argument("--compression-level", type=int, default=1,
                   help="BGZF level of the output, 0-9 (default 1; the "
                        "reference's 10-12 are not yet ported)")


def _bad_level(args) -> bool:
    """Refuse a level outside 0-9 (exit 2): the reference's libdeflate
    levels 10-12 as not yet ported (never written at level 9 instead),
    anything else as out of the reference's range 0-12."""
    level = args.compression_level
    if 10 <= level <= 12:
        log.error("--compression-level %d: not yet ported to "
                  "fgumi_tpu_torch (libdeflate levels)", level)
        return True
    if not 0 <= level <= 12:
        log.error("--compression-level %d: must be 0-12", level)
        return True
    return False


def _refuse_unported(args, table, command: str) -> bool:
    for dest, name, given in table:
        if given(getattr(args, dest)):
            log.error("%s %s: not yet ported to fgumi_tpu_torch", command,
                      name)
            return True
    return False


def _add_device_filter_opts(p, description: str):
    """The ``--device-filter`` option group of the consensus commands (the
    same grammar and defaults as the ``filter`` command's options)."""
    f = p.add_argument_group("fused filtering", description)
    f.add_argument("--device-filter", action="store_true",
                   help="enable the fused consensus→filter stage")
    f.add_argument("--filter-min-reads", default="3",
                   help="filter --min-reads (1-3 comma-separated values)")
    f.add_argument("--filter-max-read-error-rate", default="0.025",
                   help="filter --max-read-error-rate")
    f.add_argument("--filter-max-base-error-rate", default="0.1",
                   help="filter --max-base-error-rate")
    f.add_argument("--filter-min-base-quality", type=int, default=None,
                   help="filter --min-base-quality")
    f.add_argument("--filter-min-mean-base-quality", type=float,
                   default=None, help="filter --min-mean-base-quality")
    f.add_argument("--filter-max-no-call-fraction", type=float, default=0.2,
                   help="filter --max-no-call-fraction")
    f.add_argument("--filter-by-template", nargs="?", const=True,
                   default=True, type=_parse_bool,
                   help="drop the whole template when any primary fails")


def _add_simplex(sub):
    p = sub.add_parser("simplex",
                       help="Call simplex consensus reads over MI groups")
    p.add_argument("-i", "--input", required=True, help="grouped BAM (MI tags)")
    p.add_argument("-o", "--output", required=True, help="output consensus BAM")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA consensus kernel; cpu: "
                        "its plain PyTorch version")
    p.add_argument("--tag", default="MI")
    p.add_argument("--read-name-prefix", default="fgumi")
    p.add_argument("--read-group-id", default="A")
    p.add_argument("--error-rate-pre-umi", type=int, default=45)
    p.add_argument("--error-rate-post-umi", type=int, default=40)
    p.add_argument("--min-input-base-quality", type=int, default=10)
    p.add_argument("--min-reads", type=int, default=1)
    p.add_argument("--max-reads", type=int, default=None)
    p.add_argument("--min-consensus-base-quality", type=int, default=40)
    p.add_argument("--trim", action="store_true")
    p.add_argument("--no-per-base-tags", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--allow-unmapped", action="store_true")
    p.add_argument("--consensus-call-overlapping-bases", type=_parse_bool,
                   nargs="?", const=True, default=True, metavar="true|false",
                   help="pre-correct R1/R2 insert-overlap bases before UMI "
                        "consensus (default true)")
    p.add_argument("--classic", action="store_true",
                   help="the per-record engine instead of the fast "
                        "(native-batch) engine")
    p.add_argument("--batch-groups", type=int, default=2000,
                   help="MI groups per device batch (classic engine)")
    p.add_argument("--batch-bytes", type=int, default=16 << 20,
                   help="decompressed bytes per record batch (fast engine)")
    _add_compression_level(p)
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (reads, batches, kernel "
                        "launches, suspect positions, fused-filter fetches, "
                        "time split) as JSON")
    _add_device_filter_opts(
        p, "fuse `filter` into this command: on the fast engine the "
           "consensus columns stay on the device, per-read verdicts come "
           "from the fused kernel's stats rows, and only surviving records "
           "are fetched (records identical to piping through `filter`)")
    p.add_argument("--rejects", default=None,
                   help="optional BAM for raw reads that contribute to no "
                        "consensus (the input header)")
    p.add_argument("--em-seq", action="store_true",
                   help="EM-Seq methylation-aware calling (requires --ref); "
                        "emits MM/ML and cu/ct tags (runs the groups on the "
                        "per-group path)")
    p.add_argument("--taps", action="store_true",
                   help="TAPS methylation-aware calling (requires --ref)")
    p.add_argument("--methylation-mode", choices=["em-seq", "taps"],
                   default=None,
                   help="the reference's spelling of --em-seq/--taps")
    p.add_argument("--ref", default=None,
                   help="reference FASTA (required for --em-seq/--taps)")
    _add_threads(p, ">= 2: reader and writer threads around the processing "
                    "thread, >= 4 also resolve workers (fast engine; "
                    "records unchanged); 0/1 runs inline")
    _add_stats(p)
    _add_max_memory(p)
    _add_pipeline_compat(p)
    _add_shard_opts(p)
    g = p.add_argument_group("not yet ported",
                             "reference options this port rejects (exit 2)")
    g.add_argument("--devices", default="auto", type=_devices_arg)
    p.set_defaults(func=cmd_simplex)


def _kernel_counters(extra=None):
    """Every kernel's launches so far: this command's own tally inside a
    telemetry scope (so two daemon jobs at once never count each other's),
    else the process-wide counters. ``extra``: more counters, name ->
    (module, counter)."""
    from .observe.scope import current_scope
    from .ops import combine, cuda_kernel, umi_hamming, wire

    counters = {
        "consensus_wire_full": (cuda_kernel, "LAUNCHES"),
        "consensus_wire_filter": (cuda_kernel, "FILTER_LAUNCHES"),
        "consensus_wire_resident": (cuda_kernel, "RESIDENT_LAUNCHES"),
        "consensus_wire_packed2": (cuda_kernel, "PACKED2_LAUNCHES"),
        "packed2_full": (wire, "PACKED2_LAUNCHES"),
        "duplex_combine": (combine, "DUPLEX_COMBINE_LAUNCHES"),
        "codec_combine": (combine, "CODEC_COMBINE_LAUNCHES"),
        "umi_hamming": (umi_hamming, "HAMMING_LAUNCHES"), **(extra or {})}
    scope = current_scope()
    if scope is None:
        return {name: getattr(m, c) for name, (m, c) in counters.items()}
    return {name: scope.launches(f"{m.__name__}.{c}")
            for name, (m, c) in counters.items()}


def _no_cuda(command: str, device: str) -> bool:
    """``--device cuda`` without a CUDA device: logged, and the caller
    exits 2 (no CPU carry-on)."""
    import torch

    if device == "cuda" and not torch.cuda.is_available():
        log.error("%s --device cuda: no CUDA device is available (pass "
                  "--device cpu to run the plain PyTorch version)", command)
        return True
    return False


def _log_filter_stats(stats, label: str):
    log.info("%s filter: %d records -> kept %d, rejected %d, masked %d "
             "bases", label, stats.total_records, stats.passed_records,
             stats.failed_records, stats.bases_masked)
    if stats.rejection_reasons:
        log.info("rejections (filter): %s",
                 dict(stats.rejection_reasons.most_common()))


def _output(args, header, sink):
    """The command's output: ``sink(header)`` in a fused pipeline, else a
    BAM file at ``args.output``."""
    from .io.bam import BamWriter

    if sink is not None:
        return sink(header)
    return BamWriter(args.output, header, level=args.compression_level)


def _run_fast(args, caller, oc_caller, filter_stage, out_header,
              source=None, sink=None, rejects=None, shard=None):
    """The fast engine on the stage runner: native batch decode,
    vectorized prep and one kernel dispatch per record batch in the
    process stage, the fetch, thresholds and native serializer in the
    resolve stage. ``source`` (a RecordBatch reader) replaces the input
    file, ``sink`` the output; ``rejects`` (a RejectsSink) takes the
    caller's rejected records after every batch; ``shard`` (a
    ShardFilter) cuts the batches down to its families first. Returns the
    StageTimes."""
    from .consensus.fast import FastSimplexCaller, resolve_chunk
    from .io.batch_reader import BamBatchReader
    from .pipeline import StageTimes, run_stages
    from .utils.memory import resolve_budget
    from .utils.progress import ProgressTracker

    fast = FastSimplexCaller(caller, args.tag.encode(),
                             overlap_caller=oc_caller,
                             filter_stage=filter_stage)
    # a queued item holds about 3x --batch-bytes (the inflated chunk and the
    # padded gathers); the two queues bound the working set
    budget = resolve_budget(args.max_memory)
    queue_items = int(max(1, min(8, budget // (6 * args.batch_bytes))))
    stats = StageTimes()
    progress = ProgressTracker("simplex")

    def process(batch):
        progress.add(batch.n)
        items = fast.process_batch(batch, args.allow_unmapped)
        if rejects is not None:
            rejects.drain(caller)
        return items

    with (BamBatchReader(args.input, target_bytes=args.batch_bytes)
          if source is None else source) as reader, \
            _output(args, out_header, sink) as writer:
        # the fetch, thresholds and serializer run as the resolve stage
        # (threads >= 4 or --device cuda with threads >= 2: a worker pool,
        # outputs reordered; 2-3 otherwise: on the writer thread), so they
        # overlap the next batch's host prep and dispatch
        src = iter(reader)
        process_fn, resolve_fn, sink = (process, resolve_chunk,
                                        writer.write_serialized)
        if shard is not None:
            src = shard.wrap_batches(src)
            process_fn, resolve_fn, sink = shard.wrap_stages(
                process_fn, resolve_fn, sink)
        run_stages(src, process_fn, sink,
                   threads=args.threads, queue_items=queue_items,
                   stats=stats, resolve_fn=resolve_fn,
                   **_consensus_stage_kwargs(args))
        for blob in fast.flush():
            sink(resolve_fn(blob))
        if shard is not None:
            shard.end_output()
        if rejects is not None:
            rejects.drain(caller)
    progress.finish()
    return stats


def _run_classic(args, caller, oc_caller, filter_tap, out_header,
                 rejects=None, shard=None):
    """The per-record engine; ``rejects`` and ``shard`` as
    :func:`_run_fast`'s."""
    from .consensus.device_filter import FilterTapWriter
    from .consensus.overlapping import apply_overlapping_consensus
    from .core.grouper import consensus_pregroup_keep, iter_mi_group_batches
    from .io.bam import BamReader, BamWriter

    with BamReader(args.input) as reader, \
            BamWriter(args.output, out_header,
                      level=args.compression_level) as bam_writer:
        writer = (bam_writer if filter_tap is None
                  else FilterTapWriter(bam_writer, filter_tap))
        allow_unmapped = args.allow_unmapped

        def pregroup(r):
            return consensus_pregroup_keep(r.flag, allow_unmapped)

        if shard is not None:
            # the shard gate runs FIRST (ShardFilter.record_gate)
            pregroup = shard.record_gate(pregroup)
            if filter_tap is not None:
                shard.keep_log = filter_tap.keep_log = []

        for batch in iter_mi_group_batches(reader, args.batch_groups,
                                           tag=args.tag.encode(),
                                           record_filter=pregroup):
            sizes = [len(recs) for _, recs in batch]
            if oc_caller is not None:
                batch = [(umi, apply_overlapping_consensus(recs, oc_caller))
                         for umi, recs in batch]
            if shard is None:
                for rec_bytes in caller.call_groups(batch):
                    writer.write_record_bytes(rec_bytes)
            else:
                shard.call_groups(caller.call_groups, batch, sizes,
                                  writer.write_record_bytes)
            if rejects is not None:
                rejects.drain(caller)
        if filter_tap is not None:
            writer.finish()


def _input_header(path: str):
    """The header of BAM ``path`` (the rejects BAM's, and the reference
    names methylation-aware calling maps reads with)."""
    from .io.bam import BamReader

    with BamReader(path) as r:
        return r.header


def _reference(path: str):
    """The FASTA at ``path`` as a ReferenceReader, or None (logged; the
    caller exits 2) when it cannot be read."""
    from .core.reference import ReferenceReader

    try:
        return ReferenceReader(path)
    except OSError as e:
        log.error("cannot read reference %s: %s", path, e)
        return None


def cmd_simplex(args, argv, source=None, sink=None):
    """``source``/``sink`` (the fused pipeline's channels) replace the
    input and output files; they need the fast engine."""
    if _refuse_unported(args, _NOT_PORTED, "simplex"):
        return 2
    if source is not None and args.classic:
        log.error("simplex: a fused chain needs the fast engine, not "
                  "--classic")
        return 2
    # mirrors the reference's argument validation (simplex.rs:521-526)
    if args.min_reads < 1:
        log.error("--min-reads must be >= 1 (a value of 0 admits empty groups)")
        return 2
    if args.max_reads is not None and args.max_reads < args.min_reads:
        log.error("--max-reads (%d) must be >= --min-reads (%d)",
                  args.max_reads, args.min_reads)
        return 2
    em_seq = args.em_seq or args.methylation_mode == "em-seq"
    taps = args.taps or args.methylation_mode == "taps"
    if em_seq and taps:
        log.error("--em-seq and --taps are mutually exclusive")
        return 2
    if (em_seq or taps) and args.ref is None:
        log.error("--ref is required with --em-seq/--taps")
        return 2
    if _bad_level(args):
        return 2
    try:
        shard = _shard_filter_from_args(args)
    except ValueError as e:
        log.error("%s", e)
        return 2
    if _no_cuda("simplex", args.device):
        return 2
    reference = None
    if em_seq or taps:
        reference = _reference(args.ref)
        if reference is None:
            return 2

    from .consensus.overlapping import OverlappingBasesConsensusCaller
    from .consensus.rejects import RejectsSink
    from .consensus.vanilla import VanillaConsensusCaller, VanillaOptions

    opts = VanillaOptions(
        tag=args.tag,
        error_rate_pre_umi=args.error_rate_pre_umi,
        error_rate_post_umi=args.error_rate_post_umi,
        min_input_base_quality=args.min_input_base_quality,
        min_reads=args.min_reads,
        max_reads=args.max_reads,
        produce_per_base_tags=not args.no_per_base_tags,
        seed=args.seed,
        trim=args.trim,
        min_consensus_base_quality=args.min_consensus_base_quality,
        methylation_mode="em-seq" if em_seq else ("taps" if taps else None),
    )
    from .consensus.device_filter import device_filter_requested

    device_filter = device_filter_requested(args)
    filter_stage = filter_tap = None
    if device_filter:
        from .consensus.device_filter import (HostFilterTap,
                                              SimplexFilterStage,
                                              filter_config_from_args)

        try:
            fcfg = filter_config_from_args(args)
        except ValueError as e:
            log.error("%s", e)
            return 2
        if args.classic:
            filter_tap = HostFilterTap(fcfg, args.filter_by_template)
        else:
            filter_stage = SimplexFilterStage(fcfg, opts,
                                              args.filter_by_template)
    oc_caller = None
    if args.consensus_call_overlapping_bases:
        oc_caller = OverlappingBasesConsensusCaller("consensus", "consensus")
    out_header = _unmapped_consensus_header(args.read_group_id, argv)
    if not args.classic:
        from .native import get_lib

        get_lib()  # build the native library before the clock starts
    counters0 = _kernel_counters()
    t0 = time.monotonic()
    in_header = None
    if reference is not None or args.rejects is not None:
        in_header = (source.header if source is not None
                     else _input_header(args.input))
    caller = VanillaConsensusCaller(
        args.read_name_prefix, args.read_group_id, opts, device=args.device,
        track_rejects=args.rejects is not None, reference=reference,
        ref_names=in_header.ref_names if reference is not None else None)
    stage_times = None
    with RejectsSink(args.rejects, in_header,
                     level=args.compression_level) as rejects:
        if args.classic:
            _run_classic(args, caller, oc_caller, filter_tap, out_header,
                         rejects, shard)
        else:
            stage_times = _run_fast(args, caller, oc_caller, filter_stage,
                                    out_header, source, sink, rejects,
                                    shard)
    _finish_shard(shard, args, "simplex")
    dt = time.monotonic() - t0
    if args.stats and stage_times is not None:
        _print_stats(stage_times, dt)
    s = caller.stats
    kern = caller.kernel
    engine = "classic" if args.classic else "fast"
    log.info("simplex[%s, %s]: %d input reads -> %d consensus reads in "
             "%.2fs (%.0f reads/s)", engine, args.device, s.input_reads,
             s.consensus_reads, dt, s.input_reads / dt if dt else 0)
    if oc_caller is not None and oc_caller.stats.overlapping_bases:
        ocs = oc_caller.stats
        log.info("overlap correction: %d overlapping bases, %d agree, "
                 "%d disagree, %d corrected", ocs.overlapping_bases,
                 ocs.bases_agreeing, ocs.bases_disagreeing,
                 ocs.bases_corrected)
    if s.rejected:
        log.info("rejections: %s", dict(sorted(s.rejected.items())))
    kf, kt = kern.fallback_positions, kern.total_positions
    if kt:
        log.info("kernel fallback rate: %.4f%% (%d/%d positions)",
                 100.0 * kf / kt, kf, kt)
    fstats = (filter_stage or filter_tap).stats if device_filter else None
    n_out = s.consensus_reads
    if fstats is not None:
        _log_filter_stats(fstats, "simplex")
        n_out -= fstats.failed_records
    if args.stats_json:
        counters = _kernel_counters()
        stats = {
            "device": args.device,
            "engine": engine,
            "input_reads": s.input_reads,
            "consensus_reads": s.consensus_reads,
            "records_written": n_out,
            "wall_s": dt,
            "device_batches": kern.batches,
            # batches the offload router sent to the native f64 engine
            "host_batches": kern.host_batches,
            "batch_shapes": kern.batch_shapes,
            "launches": {k: counters[k] - counters0[k] for k in counters},
            "fused_batches": kern.fused_batches,
            "packed2_columns_batches": kern.packed2_columns_batches,
            "stats_bytes_fetched": kern.stats_bytes,
            "rows_gathered": kern.gathered_rows,
            "suspect_positions": kf,
            "total_positions": kt,
            "device_s": kern.device_s,
            "oracle_patch_s": kern.patch_s,
            "host_s": dt - kern.device_s - kern.patch_s,
        }
        if stage_times is not None:
            stats.update(_stage_stats(args, stage_times))
        if fstats is not None:
            stats["filter"] = {"total": fstats.total_records,
                               "passed": fstats.passed_records,
                               "failed": fstats.failed_records,
                               "bases_masked": fstats.bases_masked}
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _add_duplex(sub):
    p = sub.add_parser("duplex", help="Call duplex consensus reads over "
                                      "/A+/B MI groups")
    p.add_argument("-i", "--input", required=True,
                   help="grouped BAM (MI tags with /A,/B)")
    p.add_argument("-o", "--output", required=True,
                   help="output consensus BAM")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA consensus kernel; cpu: "
                        "its plain PyTorch version")
    p.add_argument("--read-name-prefix", default="fgumi")
    p.add_argument("--read-group-id", default="A")
    p.add_argument("--error-rate-pre-umi", type=int, default=45)
    p.add_argument("--error-rate-post-umi", type=int, default=40)
    p.add_argument("--min-input-base-quality", type=int, default=10)
    p.add_argument("--min-reads", type=int, nargs="+", default=[1],
                   help="1-3 values: total [XY [YX]] (high to low)")
    p.add_argument("--max-reads-per-strand", type=int, default=None)
    p.add_argument("--trim", action="store_true",
                   help="quality-trim the reads (runs the classic engine)")
    p.add_argument("--no-per-base-tags", action="store_true")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--allow-unmapped", action="store_true")
    p.add_argument("--consensus-call-overlapping-bases", type=_parse_bool,
                   nargs="?", const=True, default=True, metavar="true|false",
                   help="pre-correct R1/R2 insert-overlap bases before UMI "
                        "consensus (default true)")
    p.add_argument("--classic", action="store_true",
                   help="the per-molecule engine instead of the fast "
                        "(native-batch) engine")
    p.add_argument("--batch-molecules", type=int, default=1000,
                   help="molecules per device batch (classic engine)")
    p.add_argument("--batch-bytes", type=int, default=16 << 20,
                   help="decompressed bytes per record batch (fast engine)")
    _add_compression_level(p)
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (reads, batches and their "
                        "shapes, kernel launches, suspect positions, time "
                        "split) as JSON")
    _add_device_filter_opts(
        p, "fuse `filter` into this command: consensus records are "
           "filtered in process before they are written (records identical "
           "to piping through `filter`)")
    p.add_argument("--rejects", default=None,
                   help="optional BAM for raw reads that contribute to no "
                        "consensus (the input header; runs the classic "
                        "engine)")
    p.add_argument("--methylation-mode", choices=["em-seq", "taps"],
                   default=None,
                   help="EM-Seq/TAPS methylation-aware duplex calling "
                        "(requires --ref): per-strand am/au/at and "
                        "bm/bu/bt, combined MM/ML and cu/ct tags (every "
                        "molecule on the per-molecule path)")
    p.add_argument("--ref", default=None,
                   help="reference FASTA (required with --methylation-mode)")
    _add_threads(p, ">= 2: reader and writer threads around the processing "
                    "thread, >= 4 also resolve workers (fast engine; "
                    "records unchanged); 0/1 runs inline")
    _add_stats(p)
    _add_pipeline_compat(p)
    _add_shard_opts(p)
    g = p.add_argument_group("not yet ported",
                             "reference options this port rejects (exit 2)")
    g.add_argument("--devices", default="auto", type=_devices_arg)
    p.set_defaults(func=cmd_duplex)


def _duplex_fast(args, caller, oc_caller, writer, shard=None):
    """The fast engine on the stage runner: native batch decode,
    vectorized prep and one K1-r dispatch per record batch in the process
    stage; the fetch, the strand combine (K5 on the device for eligible
    rows, the host for the rest) and the native serializer in the resolve
    stage. ``shard`` (a ShardFilter) cuts the batches down to its
    families first. Returns (the engine, for its combine counters; the
    StageTimes)."""
    from .consensus.fast import resolve_chunk
    from .consensus.fast_duplex import FastDuplexCaller
    from .io.batch_reader import BamBatchReader
    from .pipeline import StageTimes, run_stages
    from .utils.progress import ProgressTracker

    fast = FastDuplexCaller(caller, b"MI", overlap_caller=oc_caller)
    stats = StageTimes()
    progress = ProgressTracker("duplex")

    def process(batch):
        progress.add(batch.n)
        return fast.process_batch(batch, args.allow_unmapped)

    with BamBatchReader(args.input, target_bytes=args.batch_bytes) as reader:
        src = iter(reader)
        process_fn, resolve_fn, sink = (process, resolve_chunk,
                                        writer.write_serialized)
        if shard is not None:
            src = shard.wrap_batches(src)
            process_fn, resolve_fn, sink = shard.wrap_stages(
                process_fn, resolve_fn, sink)
        run_stages(src, process_fn, sink,
                   threads=args.threads, stats=stats,
                   resolve_fn=resolve_fn,
                   **_consensus_stage_kwargs(args))
    for blob in fast.flush():
        sink(resolve_fn(blob))
    if shard is not None:
        shard.end_output()
    progress.finish()
    return fast, stats


def _duplex_classic(args, caller, oc_caller, writer, rejects, shard=None):
    """The per-molecule engine; ``rejects`` (a RejectsSink) takes the
    caller's rejected records after every batch of molecules, and
    ``shard`` (a ShardFilter) gates every record first."""
    from .consensus.duplex import iter_duplex_groups
    from .consensus.overlapping import apply_overlapping_consensus
    from .core.grouper import consensus_pregroup_keep
    from .io.bam import BamReader

    allow_unmapped = args.allow_unmapped

    def pregroup(r):
        return consensus_pregroup_keep(r.flag, allow_unmapped)

    if shard is not None:
        # the shard gate first (ShardFilter.record_gate)
        pregroup = shard.record_gate(pregroup)

    def flush(batch, sizes):
        if shard is None:
            for rec_bytes in caller.call_groups(batch):
                writer.write_record_bytes(rec_bytes)
        else:
            shard.call_groups(caller.call_groups, batch, sizes,
                              writer.write_record_bytes)
        rejects.drain(caller)

    with BamReader(args.input) as reader:
        batch, sizes = [], []
        for group in iter_duplex_groups(reader, record_filter=pregroup):
            base_mi, a_recs, b_recs = group
            sizes.append(len(a_recs) + len(b_recs))
            # single-strand molecules skip correction: no duplex is
            # possible anyway (duplex.rs has_both_strands_raw)
            if oc_caller is not None and a_recs and b_recs:
                group = (base_mi,
                         apply_overlapping_consensus(a_recs, oc_caller),
                         apply_overlapping_consensus(b_recs, oc_caller))
            batch.append(group)
            if len(batch) >= args.batch_molecules:
                flush(batch, sizes)
                batch, sizes = [], []
        if batch:
            flush(batch, sizes)


def cmd_duplex(args, argv):
    if _refuse_unported(args, _NOT_PORTED, "duplex"):
        return 2
    if args.methylation_mode and args.ref is None:
        log.error("--ref is required with --methylation-mode")
        return 2
    if args.ref is not None and not args.methylation_mode:
        log.error("--ref requires --methylation-mode to be set")
        return 2
    if _bad_level(args):
        return 2
    try:
        shard = _shard_filter_from_args(args)
    except ValueError as e:
        log.error("%s", e)
        return 2
    if _no_cuda("duplex", args.device):
        return 2
    reference = None
    if args.methylation_mode:
        reference = _reference(args.ref)
        if reference is None:
            return 2

    from .consensus.device_filter import make_filter_tap, wrap_filter_writer
    from .consensus.duplex import DuplexConsensusCaller
    from .consensus.overlapping import OverlappingBasesConsensusCaller
    from .consensus.rejects import RejectsSink
    from .io.bam import BamWriter

    in_header = None
    if reference is not None or args.rejects is not None:
        in_header = _input_header(args.input)
    try:
        caller = DuplexConsensusCaller(
            args.read_name_prefix, args.read_group_id,
            min_reads=args.min_reads,
            min_input_base_quality=args.min_input_base_quality,
            produce_per_base_tags=not args.no_per_base_tags, trim=args.trim,
            max_reads_per_strand=args.max_reads_per_strand,
            error_rate_pre_umi=args.error_rate_pre_umi,
            error_rate_post_umi=args.error_rate_post_umi, seed=args.seed,
            device=args.device, track_rejects=args.rejects is not None,
            methylation_mode=args.methylation_mode, reference=reference,
            ref_names=in_header.ref_names if reference is not None
            else None)
        filter_tap = make_filter_tap(args)
    except ValueError as e:
        log.error("%s", e)
        return 2
    # the fast engine has no quality trimming, and the rejects stream runs
    # every molecule through the classic loop (the reference's use_fast)
    engine = "classic" if args.classic or args.trim \
        or args.rejects is not None else "fast"
    oc_caller = None
    if args.consensus_call_overlapping_bases:
        oc_caller = OverlappingBasesConsensusCaller("consensus", "consensus")
    out_header = _unmapped_consensus_header(args.read_group_id, argv)
    if engine == "fast":
        from .native import get_lib

        get_lib()  # build the native library before the clock starts
    counters0 = _kernel_counters()
    t0 = time.monotonic()
    try:
        with RejectsSink(args.rejects, in_header,
                         level=args.compression_level) as rejects, \
                BamWriter(args.output, out_header,
                          level=args.compression_level) as bam_writer:
            writer = wrap_filter_writer(bam_writer, filter_tap)
            if shard is not None and filter_tap is not None:
                shard.keep_log = filter_tap.keep_log = []
            fast = stage_times = None
            if engine == "fast":
                fast, stage_times = _duplex_fast(args, caller, oc_caller,
                                                 writer, shard)
            else:
                _duplex_classic(args, caller, oc_caller, writer, rejects,
                                shard)
            if filter_tap is not None:
                writer.finish()
    except InputFormatError:
        raise  # main's one-line exit 2
    except ValueError as e:
        # an input the callers refuse: an MI tag missing, or without its
        # /A or /B suffix (the reference's message)
        log.error("%s", e)
        return 2
    _finish_shard(shard, args, "duplex")
    dt = time.monotonic() - t0
    if args.stats and stage_times is not None:
        _print_stats(stage_times, dt)
    s = caller.merged_stats()
    kern = caller.kernel
    log.info("duplex[%s, %s]: %d input reads -> %d consensus reads in "
             "%.2fs (%.0f reads/s)", engine, args.device, s.input_reads,
             s.consensus_reads, dt, s.input_reads / dt if dt else 0)
    if oc_caller is not None and oc_caller.stats.overlapping_bases:
        ocs = oc_caller.stats
        log.info("overlap correction: %d overlapping bases, %d agree, "
                 "%d disagree, %d corrected", ocs.overlapping_bases,
                 ocs.bases_agreeing, ocs.bases_disagreeing,
                 ocs.bases_corrected)
    if s.rejected:
        log.info("rejections: %s", dict(sorted(s.rejected.items())))
    kf, kt = kern.fallback_positions, kern.total_positions
    if kt:
        log.info("kernel fallback rate: %.4f%% (%d/%d positions)",
                 100.0 * kf / kt, kf, kt)
    n_out = s.consensus_reads
    fstats = filter_tap.stats if filter_tap is not None else None
    if fstats is not None:
        _log_filter_stats(fstats, "duplex")
        n_out -= fstats.failed_records
    if args.stats_json:
        counters = _kernel_counters()
        stats = {
            "device": args.device,
            "engine": engine,
            "input_reads": s.input_reads,
            "consensus_reads": s.consensus_reads,
            "records_written": n_out,
            "rejected": dict(sorted(s.rejected.items())),
            "wall_s": dt,
            "device_batches": kern.batches,
            # batches the offload router sent to the native f64 engine
            "host_batches": kern.host_batches,
            "batch_shapes": kern.batch_shapes,
            "launches": {k: counters[k] - counters0[k] for k in counters},
            "suspect_positions": kf,
            "total_positions": kt,
            "device_s": kern.device_s,
            "oracle_patch_s": kern.patch_s,
            "host_s": dt - kern.device_s - kern.patch_s,
            # fast engine: the strand combine, device (K5) and host rows
            # together; its device span is also in device_s
            "combine_s": fast.combine_s if fast else None,
            "combine_device_rows": fast.combine_device_rows if fast else 0,
            "combine_host_rows": fast.combine_host_rows if fast else 0,
            "combine_device_largest":
                fast.combine_device_largest if fast else 0,
        }
        if stage_times is not None:
            stats.update(_stage_stats(args, stage_times))
        if fstats is not None:
            stats["filter"] = {"total": fstats.total_records,
                               "passed": fstats.passed_records,
                               "failed": fstats.failed_records,
                               "bases_masked": fstats.bases_masked,
                               "rejection_reasons":
                                   dict(fstats.rejection_reasons)}
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


# options of the reference `codec` that the port does not implement
_CODEC_NOT_PORTED = (
    ("devices", "--devices > 1", lambda v: v not in ("auto", 1)),
)


def _add_codec(sub):
    p = sub.add_parser(
        "codec",
        help="Call CODEC consensus (one read-pair covers both strands)")
    p.add_argument("-i", "--input", required=True,
                   help="grouped BAM (MI tags, no /A,/B suffixes)")
    p.add_argument("-o", "--output", required=True,
                   help="output consensus BAM")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA consensus kernel and the "
                        "combine on the card; cpu: their plain PyTorch "
                        "versions")
    p.add_argument("-r", "--rejects", default=None,
                   help="optional BAM for rejected records (runs the "
                        "classic engine)")
    p.add_argument("--tag", default="MI")
    p.add_argument("--read-name-prefix", default="fgumi")
    p.add_argument("--read-group-id", default="A")
    p.add_argument("--error-rate-pre-umi", type=int, default=45)
    p.add_argument("--error-rate-post-umi", type=int, default=40)
    p.add_argument("--min-input-base-quality", type=int, default=10)
    p.add_argument("-M", "--min-reads", type=int, default=1,
                   help="min read pairs per strand")
    p.add_argument("--max-reads", type=int, default=None,
                   help="max read pairs per strand (downsample)")
    p.add_argument("-d", "--min-duplex-length", type=int, default=1)
    p.add_argument("--single-strand-qual", type=int, default=None)
    p.add_argument("-Q", "--outer-bases-qual", type=int, default=None)
    p.add_argument("-O", "--outer-bases-length", type=int, default=5)
    p.add_argument("-x", "--max-duplex-disagreement-rate", type=float,
                   default=1.0)
    p.add_argument("-X", "--max-duplex-disagreements", type=int,
                   default=None)
    p.add_argument("--cell-tag", default=None,
                   help="cell barcode tag (e.g. CB)")
    p.add_argument("--per-base-tags", action="store_true",
                   help="emit ad/bd/ae/be/ac/bc/aq/bq tags")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--classic", action="store_true",
                   help="the per-molecule engine instead of the batch "
                        "engine")
    p.add_argument("--batch-groups", type=int, default=1000,
                   help="MI groups per device batch (classic engine)")
    p.add_argument("--batch-bytes", type=int, default=16 << 20,
                   help="decompressed bytes per record batch (batch "
                        "engine)")
    _add_compression_level(p)
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (reads, rejections, "
                        "batches, kernel and combine launches, time split) "
                        "as JSON")
    _add_device_filter_opts(
        p, "fuse `filter` into this command: consensus records are "
           "filtered in process before they are written (records identical "
           "to piping through `filter`)")
    _add_threads(p, ">= 2: reader and writer threads around the batch "
                    "engine (records unchanged); 0/1 runs inline")
    _add_stats(p)
    _add_pipeline_compat(p)
    g = p.add_argument_group("not yet ported",
                             "reference options this port rejects (exit 2)")
    g.add_argument("--devices", default="auto", type=_devices_arg)
    p.set_defaults(func=cmd_codec)


def _codec_fast(args, caller, writer):
    """The batch engine on the stage runner (no resolve stage): native
    batch decode, vectorized prep, one K1 dispatch and one K6 combine per
    record batch and the native serializer in the process stage. Returns
    (the engine, for its combine counters; the StageTimes)."""
    from .consensus.fast_codec import FastCodecCaller
    from .io.batch_reader import BamBatchReader
    from .pipeline import StageTimes, run_stages
    from .utils.progress import ProgressTracker

    fast = FastCodecCaller(caller, args.tag.encode())
    stats = StageTimes()
    progress = ProgressTracker("codec")

    def process(batch):
        progress.add(batch.n)
        return fast.process_batch(batch)

    with BamBatchReader(args.input, target_bytes=args.batch_bytes) as reader:
        run_stages(iter(reader), process, writer.write_serialized,
                   threads=args.threads, stats=stats, **_stage_kwargs(args))
    for blob in fast.flush():
        writer.write_serialized(blob)
    progress.finish()
    return fast, stats


def _codec_classic(args, caller, writer):
    """The per-molecule engine; rejected records go to ``--rejects``."""
    from .core.grouper import iter_mi_group_batches
    from .io.bam import BamReader, BamWriter

    with BamReader(args.input) as reader:
        rejects = None
        if args.rejects is not None:
            # rejects keep the input header
            rejects = BamWriter(args.rejects, reader.header,
                                level=args.compression_level)
        ok = False
        try:
            for batch in iter_mi_group_batches(reader, args.batch_groups,
                                               tag=args.tag.encode()):
                for rec_bytes in caller.call_groups(batch):
                    writer.write_record_bytes(rec_bytes)
                if rejects is not None and caller.rejected_reads:
                    for rec in caller.rejected_reads:
                        rejects.write_record(rec)
                    caller.rejected_reads.clear()
            ok = True
        finally:
            if rejects is not None:
                (rejects.close if ok else rejects.discard)()


def cmd_codec(args, argv):
    if _refuse_unported(args, _CODEC_NOT_PORTED, "codec"):
        return 2
    if args.min_reads < 1:
        log.error("--min-reads must be >= 1")
        return 2
    if args.max_reads is not None and args.max_reads < args.min_reads:
        log.error("--max-reads (%d) must be >= --min-reads (%d)",
                  args.max_reads, args.min_reads)
        return 2
    if _bad_level(args):
        return 2
    if _no_cuda("codec", args.device):
        return 2

    from .consensus.codec import CodecConsensusCaller, CodecOptions
    from .consensus.device_filter import make_filter_tap, wrap_filter_writer
    from .io.bam import BamWriter

    opts = CodecOptions(
        min_input_base_quality=args.min_input_base_quality,
        error_rate_pre_umi=args.error_rate_pre_umi,
        error_rate_post_umi=args.error_rate_post_umi,
        min_reads_per_strand=args.min_reads,
        max_reads_per_strand=args.max_reads,
        min_duplex_length=args.min_duplex_length,
        single_strand_qual=args.single_strand_qual,
        outer_bases_qual=args.outer_bases_qual,
        outer_bases_length=args.outer_bases_length,
        max_duplex_disagreements=args.max_duplex_disagreements,
        max_duplex_disagreement_rate=args.max_duplex_disagreement_rate,
        cell_tag=args.cell_tag,
        produce_per_base_tags=args.per_base_tags,
        seed=args.seed)
    try:
        filter_tap = make_filter_tap(args)
    except ValueError as e:
        log.error("%s", e)
        return 2
    # the batch engine cannot feed the rejects stream (its records stay
    # array-resident): --rejects takes the classic engine, as in the
    # reference
    engine = "classic" if args.classic or args.rejects is not None \
        else "fast"
    caller = CodecConsensusCaller(args.read_name_prefix, args.read_group_id,
                                  opts, track_rejects=args.rejects is not None,
                                  device=args.device)
    if engine == "classic" and (args.threads or args.stats):
        log.info("--threads/--stats apply to the batch engine only; this "
                 "run uses the classic per-molecule engine (%s)",
                 "--rejects set" if args.rejects is not None
                 else "--classic")
    out_header = _unmapped_consensus_header(args.read_group_id, argv)
    if engine == "fast":
        from .native import get_lib

        get_lib()  # build the native library before the clock starts
    counters0 = _kernel_counters()
    t0 = time.monotonic()
    fast = stage_times = None
    try:
        with BamWriter(args.output, out_header,
                       level=args.compression_level) as bam_writer:
            writer = wrap_filter_writer(bam_writer, filter_tap)
            if engine == "fast":
                fast, stage_times = _codec_fast(args, caller, writer)
            else:
                _codec_classic(args, caller, writer)
            if filter_tap is not None:
                writer.finish()
    except InputFormatError:
        raise  # main's one-line exit 2
    except ValueError as e:
        # an input the callers refuse (an MI tag missing)
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    if args.stats and stage_times is not None:
        _print_stats(stage_times, dt)
    s = caller.stats
    kern = caller.kernel
    n_out = s.consensus_reads_generated
    log.info("codec[%s, %s]: %d input reads -> %d consensus reads in %.2fs "
             "(%.0f reads/s)", engine, args.device, s.total_input_reads,
             n_out, dt, s.total_input_reads / dt if dt else 0)
    if s.rejection_reasons:
        log.info("rejections: %s", dict(sorted(s.rejection_reasons.items())))
    if s.consensus_duplex_bases_emitted:
        log.info("duplex disagreement rate: %.6f (%d/%d)",
                 s.duplex_disagreement_rate(),
                 s.duplex_disagreement_base_count,
                 s.consensus_duplex_bases_emitted)
    fstats = filter_tap.stats if filter_tap is not None else None
    if fstats is not None:
        _log_filter_stats(fstats, "codec")
        n_out -= fstats.failed_records
    if args.stats_json:
        counters = _kernel_counters()
        stats = {
            "device": args.device,
            "engine": engine,
            "input_reads": s.total_input_reads,
            "consensus_reads": s.consensus_reads_generated,
            "records_written": n_out,
            "rejected": dict(sorted(s.rejection_reasons.items())),
            "duplex_bases": s.consensus_duplex_bases_emitted,
            "duplex_disagreements": s.duplex_disagreement_base_count,
            "wall_s": dt,
            "device_batches": kern.batches,
            # batches the offload router sent to the native f64 engine
            "host_batches": kern.host_batches,
            "batch_shapes": kern.batch_shapes,
            "launches": {k: counters[k] - counters0[k] for k in counters},
            "suspect_positions": kern.fallback_positions,
            "total_positions": kern.total_positions,
            # device_s holds K1's spans and, on cuda, K6's (combine_s)
            "device_s": kern.device_s,
            "oracle_patch_s": kern.patch_s,
            "host_s": dt - kern.device_s - kern.patch_s,
            "combine_s": fast.combine_s if fast else None,
            "combine_positions": fast.combine_positions if fast else 0,
            "combine_largest": fast.combine_largest if fast else 0,
        }
        if stage_times is not None:
            stats.update(_stage_stats(args, stage_times))
        if fstats is not None:
            stats["filter"] = {"total": fstats.total_records,
                               "passed": fstats.passed_records,
                               "failed": fstats.failed_records,
                               "bases_masked": fstats.bases_masked,
                               "rejection_reasons":
                                   dict(fstats.rejection_reasons)}
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _add_filter(sub):
    p = sub.add_parser("filter", help="Filter and mask simplex and duplex "
                                      "consensus reads")
    p.add_argument("-i", "--input", required=True,
                   help="consensus BAM (queryname sorted or query grouped)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-M", "--min-reads", required=True,
                   help="1-3 comma-separated values [duplex,AB,BA]")
    p.add_argument("-E", "--max-read-error-rate", default="0.025",
                   help="1-3 comma-separated values")
    p.add_argument("-e", "--max-base-error-rate", default="0.1",
                   help="1-3 comma-separated values")
    p.add_argument("-N", "--min-base-quality", type=int, default=None)
    p.add_argument("-q", "--min-mean-base-quality", type=float, default=None)
    p.add_argument("-n", "--max-no-call-fraction", type=float, default=0.2,
                   help="<1.0: fraction of read length; >=1.0: absolute "
                        "count")
    p.add_argument("--filter-by-template", nargs="?", const=True,
                   default=True, type=_parse_bool)
    p.add_argument("--rejects", default=None,
                   help="BAM for the rejected records (masked like the "
                        "kept ones)")
    p.add_argument("-s", "--require-single-strand-agreement", nargs="?",
                   const=True, default=False, type=_parse_bool,
                   help="mask duplex positions where the two strands' "
                        "consensus bases differ (runs the per-record "
                        "engine)")
    p.add_argument("-r", "--ref", default=None,
                   help="reference FASTA: regenerate NM/UQ/MD after masking "
                        "(required for mapped input; runs the per-record "
                        "engine)")
    p.add_argument("-R", "--reverse-per-base-tags", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="re-orient a reverse-strand record's per-base tags "
                        "(runs the per-record engine)")
    p.add_argument("--min-methylation-depth", default=None,
                   help="EM-Seq/TAPS: mask bases whose methylation evidence "
                        "(cu+ct) is below this; 1-3 comma values "
                        "[duplex,AB,BA] (duplex also checks au+at / bu+bt)")
    p.add_argument("--require-strand-methylation-agreement", nargs="?",
                   const=True, default=False, type=_parse_bool,
                   help="mask both positions of a CpG when the top and "
                        "bottom strands' methylation calls disagree "
                        "(duplex; requires --ref)")
    p.add_argument("--min-conversion-fraction", type=float, default=None,
                   help="reject reads whose conversion fraction at non-CpG "
                        "ref-C positions is below this (requires --ref and "
                        "--methylation-mode)")
    p.add_argument("--methylation-mode", choices=["em-seq", "taps"],
                   default=None,
                   help="numerator of --min-conversion-fraction (em-seq: "
                        "converted, taps: unconverted)")
    p.add_argument("--classic", action="store_true",
                   help="the per-record engine instead of the batch "
                        "engine")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (engine, records kept "
                        "and rejected, bases masked, rejection reasons, "
                        "wall) as JSON")
    # a pipeline shard's filter stage: the keep flag of every record read,
    # in order (.npy), from which the shard's family counts are recounted
    p.add_argument("--keep-log", default=None, help=argparse.SUPPRESS)
    _add_compression_level(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_filter)


def _header_with_pg(header, command_line: str):
    """Copy a header, appending an @PG record chained to the last one."""
    from .io.bam import BamHeader

    lines = header.text.splitlines()
    pg_ids = set()
    last_pg = None
    for line in lines:
        if line.startswith("@PG"):
            fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                          if ":" in f)
            if "ID" in fields:
                pg_ids.add(fields["ID"])
                last_pg = fields["ID"]
    pg_id = PROGRAM_ID
    n = 1
    while pg_id in pg_ids:
        pg_id = f"{PROGRAM_ID}.{n}"
        n += 1
    pg = f"@PG\tID:{pg_id}\tPN:{PROGRAM_ID}"
    if last_pg is not None:
        pg += f"\tPP:{last_pg}"
    pg += f"\tCL:{command_line}"
    return BamHeader(text="\n".join(lines + [pg]) + "\n",
                     ref_names=header.ref_names,
                     ref_lengths=header.ref_lengths)


_FILTER_SORT_ERR = (
    "filter requires queryname-sorted or query-grouped input (@HD must "
    "advertise SO:queryname or GO:query)")


class _FilterWriters:
    """The output and the ``--rejects`` BAM of one filter run: both are
    closed on success and both discarded on failure."""

    def __init__(self, args, header):
        from .io.bam import BamWriter

        self.rejects = (BamWriter(args.rejects, header,
                                  level=args.compression_level)
                        if args.rejects else None)
        try:
            self.out = _output(args, header, None)
        except BaseException:
            if self.rejects is not None:
                self.rejects.discard()
            raise

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        for w in (self.out, self.rejects):
            if w is not None:
                w.__exit__(exc_type, exc, tb)


def _filter_fast(args, argv, config, source):
    """The batch engine; None when the input is not query grouped."""
    from .commands.fast_filter import FastFilter
    from .core.template import is_query_grouped
    from .io.batch_reader import BamBatchReader

    with (BamBatchReader(args.input) if source is None
          else source) as reader:
        if not is_query_grouped(reader.header.text):
            return None
        out_header = _header_with_pg(reader.header, " ".join(argv))
        with _FilterWriters(args, out_header) as w:
            ff = FastFilter(config, filter_by_template=args.filter_by_template)
            if args.keep_log:
                ff.keep_log = []
            emit_rej = (w.rejects.write_serialized
                        if w.rejects is not None else None)
            for batch in reader:
                ff.process_batch(batch, w.out.write_serialized, emit_rej)
            ff.flush(w.out.write_serialized, emit_rej)
    _write_keep_log(args, ff.keep_log)
    return ff.stats


def _filter_classic(args, argv, config, reference):
    """The per-record engine; None when the input is not query grouped.
    ``reference``: the --ref FASTA's ReferenceReader, or None."""
    from .commands.filter import run_filter
    from .core.template import is_query_grouped
    from .io.bam import BamReader

    with BamReader(args.input) as reader:
        # template filtering needs mates adjacent (filter.rs:343-349)
        if not is_query_grouped(reader.header.text):
            return None
        out_header = _header_with_pg(reader.header, " ".join(argv))
        keep_log = [] if args.keep_log else None
        with _FilterWriters(args, out_header) as w:
            stats = run_filter(reader, w.out, config,
                               filter_by_template=args.filter_by_template,
                               reverse_per_base=args.reverse_per_base_tags,
                               rejects_writer=w.rejects, reference=reference,
                               keep_log=keep_log)
    _write_keep_log(args, keep_log)
    return stats


def _write_keep_log(args, keep_log):
    """``filter --keep-log``: the keep flags, one a record read, in order."""
    if keep_log is None:
        return
    import numpy as np

    flags = [np.asarray(k, bool) for k in keep_log]
    with open(args.keep_log, "wb") as f:
        np.save(f, np.concatenate(flags) if flags else np.empty(0, bool),
                allow_pickle=False)


def cmd_filter(args, argv, source=None):
    """The batch engine (commands/fast_filter.py) unless ``--classic``,
    ``--ref``, ``--reverse-per-base-tags`` or
    ``--require-single-strand-agreement`` asks for the per-record one.
    ``source`` (the fused pipeline's channel, whose batches it masks in
    place) replaces the input file and takes the batch engine."""
    from .commands.fast_filter import _OddSubtype
    from .consensus.filter import FilterConfig

    if args.min_conversion_fraction is not None and not args.methylation_mode:
        log.error("--min-conversion-fraction requires --methylation-mode")
        return 2
    if (args.require_strand_methylation_agreement
            or args.min_conversion_fraction is not None) and not args.ref:
        log.error("--require-strand-methylation-agreement and "
                  "--min-conversion-fraction require --ref")
        return 2
    if _bad_level(args):
        return 2
    try:
        config = FilterConfig.new(
            [int(v) for v in args.min_reads.split(",")],
            [float(v) for v in args.max_read_error_rate.split(",")],
            [float(v) for v in args.max_base_error_rate.split(",")],
            min_base_quality=args.min_base_quality,
            min_mean_base_quality=args.min_mean_base_quality,
            max_no_call_fraction=args.max_no_call_fraction,
            require_ss_agreement=args.require_single_strand_agreement,
            methylation_depth=(args.min_methylation_depth.split(",")
                               if args.min_methylation_depth else None),
            require_strand_methylation_agreement=(
                args.require_strand_methylation_agreement),
            min_conversion_fraction=args.min_conversion_fraction,
            methylation_mode=args.methylation_mode)
    except ValueError as e:
        log.error("%s", e)
        return 2
    # the reference regeneration, the tag re-orientation and the
    # strand-agreement mask are the per-record engine's, as in the
    # reference (cli.py use_fast)
    classic = (args.classic or args.require_single_strand_agreement
               or bool(args.ref) or args.reverse_per_base_tags)
    if source is not None and classic:
        log.error("filter: a fused chain needs the batch engine")
        return 2
    t0 = time.monotonic()
    engine = "classic" if classic else "fast"
    rerun = False
    try:
        reference = None
        if args.ref:
            from .core.reference import ReferenceReader

            reference = ReferenceReader(args.ref)
        if engine == "fast":
            try:
                stats = _filter_fast(args, argv, config, source)
            except _OddSubtype:
                if source is not None:
                    # a channel cannot be read twice
                    log.error("filter: a per-base tag subtype that is not "
                              "16-bit on a pipeline stream (the per-record "
                              "re-run needs a file)")
                    return 2
                # the reference's own semantics: the whole input re-runs
                # on the per-record engine
                log.info("filter: a per-base tag subtype that is not "
                         "16-bit; re-running with the per-record engine")
                engine, rerun = "classic", True
        if engine == "classic":
            stats = _filter_classic(args, argv, config, reference)
        if stats is None:
            log.error("%s", _FILTER_SORT_ERR)
            return 2
    except (ValueError, OSError, KeyError) as e:
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    log.info("filter (%s): %d records -> kept %d, rejected %d, masked %d "
             "bases in %.2fs", engine, stats.total_records,
             stats.passed_records, stats.failed_records, stats.bases_masked,
             dt)
    if stats.rejection_reasons:
        log.info("rejections: %s", dict(stats.rejection_reasons.most_common()))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump({"engine": engine, "rerun_per_record": rerun,
                       "total": stats.total_records,
                       "passed": stats.passed_records,
                       "failed": stats.failed_records,
                       "bases_masked": stats.bases_masked,
                       "rejection_reasons": dict(stats.rejection_reasons),
                       "wall_s": dt}, f, indent=1)
    return 0


def _add_group(sub):
    p = sub.add_parser("group", help="Group reads by UMI (GroupReadsByUmi)")
    p.add_argument("-i", "--input", required=True,
                   help="template-coordinate sorted BAM with RX tags")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA UMI distance kernel; cpu: "
                        "its plain PyTorch version")
    p.add_argument("-s", "--strategy", default="adjacency",
                   choices=["identity", "edit", "adjacency", "paired"])
    p.add_argument("-e", "--edits", type=int, default=1)
    p.add_argument("-t", "--raw-tag", default="RX")
    p.add_argument("-T", "--assign-tag", default="MI")
    p.add_argument("-m", "--min-map-q", type=int, default=1)
    p.add_argument("-n", "--include-non-pf-reads", action="store_true")
    p.add_argument("--min-umi-length", type=int, default=None)
    p.add_argument("--no-umi", action="store_true")
    p.add_argument("--allow-unmapped", action="store_true")
    p.add_argument("--index-threshold", type=int, default=None,
                   help="minimum distinct UMIs per group before the "
                        "pigeonhole candidate search replaces the dense "
                        "pairwise scan; 0 = always dense (default 8192)")
    p.add_argument("--classic", action="store_true",
                   help="the per-template engine instead of the fast "
                        "(native-batch) engine")
    p.add_argument("-f", "--family-size-histogram", default=None,
                   help="TSV of the family size distribution (fgbio "
                        "format: count/fraction/cumulative)")
    p.add_argument("-g", "--grouping-metrics", default=None,
                   help="TSV of UMI grouping metrics (fgbio's 5-column "
                        "UmiGroupingMetric)")
    p.add_argument("-M", "--metrics", default=None, metavar="PREFIX",
                   help="write PREFIX.family_sizes.txt, "
                        "PREFIX.grouping_metrics.txt and "
                        "PREFIX.position_group_sizes.txt")
    p.add_argument("--family-size-out", default=None,
                   help="plain size/count TSV (deprecated: use "
                        "--family-size-histogram)")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (engine, records, wall, "
                        "the fast engine's read/process/write walls, kernel "
                        "launches, the distance function's device span) "
                        "as JSON")
    _add_compression_level(p)
    p.add_argument("--parallel-group-min-templates", default=None,
                   metavar="N|auto",
                   help="accepted for compatibility: the assigners pick "
                        "their vectorized or device route by group size")
    _add_threads(p, ">= 2: reader and writer threads around the fast "
                    "engine (records unchanged); 0/1 runs inline")
    _add_stats(p)
    _add_max_memory(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_group)


def _run_fast_group(args, reader, writer):
    """The fast engine on the stage runner (no resolve stage), then the
    grouper's flush. Returns the metrics dict, the busy wall of each stage
    (inline, ``process_s`` holds the writes too; the flush counts as
    process) and the StageTimes."""
    from .commands.fast_group import FastGrouper
    from .pipeline import StageTimes, run_stages
    from .umi.assigners import make_assigner
    from .utils.progress import ProgressTracker

    if args.no_umi and args.strategy == "paired":
        raise ValueError("--no-umi cannot be combined with the paired "
                         "strategy")
    grouper = FastGrouper(
        reader.header, make_assigner(args.strategy, args.edits, args.device),
        umi_tag=args.raw_tag.encode(), assigned_tag=args.assign_tag.encode(),
        min_mapq=args.min_map_q, include_non_pf=args.include_non_pf_reads,
        min_umi_length=args.min_umi_length, no_umi=args.no_umi,
        allow_unmapped=args.allow_unmapped)
    stats = StageTimes()
    progress = ProgressTracker("group")

    def process(batch):
        progress.add(batch.n)
        return grouper.process_batch(batch)

    try:
        run_stages(iter(reader), process, writer.write_serialized,
                   threads=args.threads, stats=stats, **_stage_kwargs(args))
        t = time.monotonic()
        for chunk in grouper.flush():
            writer.write_serialized(chunk)
        flush_s = time.monotonic() - t
    finally:
        progress.finish()
    busy = stats.busy
    walls = {"read_s": busy.get("read", 0.0),
             "process_s": busy.get("process", 0.0)
             + busy.get("process+write", 0.0) + flush_s,
             "write_s": busy.get("write", 0.0)}
    return grouper.result(), walls, stats


def _write_group_metrics(args, result):
    """The -f/-g/-M/--family-size-out files, as the reference writes them
    for either engine."""
    from .metrics import (size_distribution_fields, size_distribution_rows,
                          umi_grouping_metrics_row, write_family_size_histogram,
                          write_metrics)

    if args.family_size_out:
        write_family_size_histogram(result["family_sizes"],
                                    args.family_size_out)
    if not (args.family_size_histogram or args.grouping_metrics
            or args.metrics):
        return
    fam_fields = size_distribution_fields("family_size")
    fam_rows = size_distribution_rows(result["family_sizes"], "family_size")
    group_row = [umi_grouping_metrics_row(result["filter"])]
    if args.family_size_histogram:
        write_metrics(args.family_size_histogram, fam_rows,
                      fieldnames=fam_fields)
    if args.grouping_metrics:
        write_metrics(args.grouping_metrics, group_row)
    if args.metrics:
        write_metrics(args.metrics + ".family_sizes.txt", fam_rows,
                      fieldnames=fam_fields)
        write_metrics(args.metrics + ".grouping_metrics.txt", group_row)
        write_metrics(args.metrics + ".position_group_sizes.txt",
                      size_distribution_rows(result["position_group_sizes"],
                                             "position_group_size"),
                      fieldnames=size_distribution_fields(
                          "position_group_size"))


def cmd_group(args, argv, source=None, sink=None):
    """``source``/``sink`` (the fused pipeline's channels) replace the
    input and output files; they need the fast engine."""
    from .commands.group import run_group
    from .core.template import is_query_grouped, is_template_coordinate_sorted
    from .io.bam import BamHeader, BamReader
    from .io.batch_reader import BamBatchReader
    from .umi import assigners

    if source is not None and args.classic:
        log.error("group: a fused chain needs the fast engine, not "
                  "--classic")
        return 2
    if _bad_level(args):
        return 2
    if _no_cuda("group", args.device):
        return 2
    if args.index_threshold is not None:
        assigners.set_index_threshold(args.index_threshold)
    if not args.classic:
        from .native import get_lib

        get_lib()  # build the native library before the clock starts
    engine = "classic" if args.classic else "fast"
    walls = {}
    stage_times = None
    counters0 = _kernel_counters()
    assigners.DEVICE_SPAN.reset()
    t0 = time.monotonic()
    if source is not None:
        reader = source
    elif args.classic:
        reader = BamReader(args.input)
    else:
        reader = BamBatchReader(args.input)
    with reader:
        hdr_text = reader.header.text
        # classify_input_ordering (group.rs:470-500): template-coordinate,
        # or query-grouped under --allow-unmapped
        if not is_template_coordinate_sorted(hdr_text) and not (
                args.allow_unmapped and is_query_grouped(hdr_text)):
            log.error("group requires template-coordinate sorted input "
                      "(header must advertise SS:template-coordinate); "
                      "--allow-unmapped additionally accepts query-grouped "
                      "input (GO:query / SO:queryname)")
            return 2
        out_header = BamHeader(text=hdr_text,
                               ref_names=reader.header.ref_names,
                               ref_lengths=reader.header.ref_lengths)
        # a ValueError leaves the writer's block with the exception in
        # hand, so the partial output is discarded
        try:
            with _output(args, out_header, sink) as writer:
                if args.classic:
                    result = run_group(
                        reader, writer, strategy=args.strategy,
                        edits=args.edits, umi_tag=args.raw_tag.encode(),
                        assigned_tag=args.assign_tag.encode(),
                        min_mapq=args.min_map_q,
                        include_non_pf=args.include_non_pf_reads,
                        min_umi_length=args.min_umi_length,
                        no_umi=args.no_umi,
                        allow_unmapped=args.allow_unmapped,
                        device=args.device)
                else:
                    result, walls, stage_times = _run_fast_group(
                        args, reader, writer)
        except ValueError as e:
            log.error("%s", e)
            return 2
    dt = time.monotonic() - t0
    if args.stats and stage_times is not None:
        _print_stats(stage_times, dt)
    n_in = result["filter"].get("total_templates", 0)
    span = assigners.DEVICE_SPAN.as_dict()
    log.info("group[%s, %s, %s]: %d input reads -> %d records in %.2fs "
             "(%.0f reads/s); filter=%s", engine, args.strategy, args.device,
             n_in, result["records_out"], dt, n_in / dt if dt else 0,
             result["filter"])
    _write_group_metrics(args, result)
    if args.stats_json:
        counters = _kernel_counters()
        stats = {"device": args.device, "engine": engine,
                 "strategy": args.strategy, "input_reads": n_in,
                 "wall_s": dt, **walls,
                 "launches": {k: counters[k] - counters0[k]
                              for k in counters},
                 "device_span": span, **result}
        if stage_times is not None:
            stats.update(_stage_stats(args, stage_times))
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _add_dedup(sub):
    p = sub.add_parser("dedup",
                       help="Mark or remove PCR duplicates using UMIs")
    p.add_argument("-i", "--input", required=True,
                   help="template-coordinate sorted BAM (zipper + sort)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (default): the CUDA UMI distance kernel; cpu: "
                        "its plain PyTorch version")
    p.add_argument("-m", "--metrics", default=None, help="dedup metrics TSV")
    p.add_argument("-H", "--family-size-histogram", default=None)
    p.add_argument("-r", "--remove-duplicates", action="store_true",
                   help="drop duplicates instead of setting the 0x400 flag")
    p.add_argument("-q", "--min-map-q", type=int, default=0)
    p.add_argument("-n", "--include-non-pf-reads", action="store_true")
    p.add_argument("--include-unmapped", action="store_true",
                   help="emit no-mapped-read templates untouched instead of "
                        "dropping them")
    p.add_argument("-s", "--strategy", default="adjacency",
                   choices=["identity", "edit", "adjacency", "paired"])
    p.add_argument("-e", "--edits", type=int, default=1)
    p.add_argument("-l", "--min-umi-length", type=int, default=None)
    p.add_argument("--no-umi", action="store_true",
                   help="dedup by position only, orientation-agnostic "
                        "(Picard-like)")
    p.add_argument("--index-threshold", type=int, default=None,
                   help="minimum distinct UMIs per group before the "
                        "pigeonhole candidate search replaces the dense "
                        "pairwise scan; 0 = always dense (default 8192)")
    p.add_argument("--classic", action="store_true",
                   help="the per-template engine instead of the batch "
                        "engine")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (engine, records, wall, "
                        "the batch engine's read/process/write walls, "
                        "kernel launches, the distance function's device "
                        "span, the dedup metrics) as JSON")
    _add_compression_level(p)
    _add_threads(p, ">= 2: reader and writer threads around the batch "
                    "engine (records unchanged); 0/1 runs inline")
    _add_stats(p)
    _add_max_memory(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_dedup)


class _CountedReader:
    """A record reader that counts the records it yields (the per-template
    engine's input count)."""

    def __init__(self, reader):
        self.reader = reader
        self.header = reader.header
        self.n = 0

    def __iter__(self):
        for rec in self.reader:
            self.n += 1
            yield rec


def _run_fast_dedup(args, reader, writer):
    """The batch engine on the stage runner, then its flush. Returns the
    metrics, the family sizes, the input records, the busy wall of each
    stage and the StageTimes."""
    from .commands.fast_group import FastDedup
    from .pipeline import StageTimes, run_stages
    from .umi.assigners import make_assigner
    from .utils.progress import ProgressTracker

    strategy, edits = args.strategy, args.edits
    if args.no_umi:
        strategy, edits = "identity", 0
    dd = FastDedup(
        reader.header, make_assigner(strategy, edits, args.device),
        min_mapq=args.min_map_q, include_non_pf=args.include_non_pf_reads,
        min_umi_length=args.min_umi_length, no_umi=args.no_umi,
        include_unmapped=args.include_unmapped,
        remove_duplicates=args.remove_duplicates)
    stats = StageTimes()
    progress = ProgressTracker("dedup")
    n_in = [0]

    def process(batch):
        progress.add(batch.n)
        n_in[0] += batch.n
        return dd.process_batch(batch)

    try:
        run_stages(iter(reader), process, writer.write_serialized,
                   threads=args.threads, stats=stats, **_stage_kwargs(args))
        t = time.monotonic()
        for chunk in dd.flush():
            writer.write_serialized(chunk)
        flush_s = time.monotonic() - t
    finally:
        progress.finish()
    busy = stats.busy
    walls = {"read_s": busy.get("read", 0.0),
             "process_s": busy.get("process", 0.0)
             + busy.get("process+write", 0.0) + flush_s,
             "write_s": busy.get("write", 0.0)}
    metrics, family_sizes = dd.result()
    return metrics, family_sizes, n_in[0], walls, stats


def cmd_dedup(args, argv):
    """``dedup``: the batch engine (``FastDedup``) unless ``--classic``;
    position groups of at least 1,024 distinct UMIs compute their UMI
    distances on ``--device`` (K4 on ``cuda``)."""
    from .commands.dedup import (_METRIC_COLUMNS, run_dedup,
                                 write_family_size_histogram, write_metrics)
    from .core.template import is_template_coordinate_sorted
    from .io.bam import BamReader, BamWriter
    from .io.batch_reader import BamBatchReader
    from .umi import assigners

    if _bad_level(args) or _no_cuda("dedup", args.device):
        return 2
    if args.index_threshold is not None:
        assigners.set_index_threshold(args.index_threshold)
    # argument combinations are refused before the output is touched
    if args.strategy == "paired" and args.no_umi:
        log.error("--no-umi cannot be used with --strategy paired")
        return 2
    if args.strategy == "paired" and args.min_umi_length is not None:
        log.error("Paired strategy cannot be used with --min-umi-length")
        return 2
    if not args.classic:
        from .native import get_lib

        get_lib()  # build the native library before the clock starts
    engine = "classic" if args.classic else "fast"
    walls = {}
    stage_times = None
    counters0 = _kernel_counters()
    assigners.DEVICE_SPAN.reset()
    t0 = time.monotonic()
    try:
        reader = BamReader(args.input) if args.classic \
            else BamBatchReader(args.input)
        with reader:
            if not is_template_coordinate_sorted(reader.header.text):
                log.error("dedup requires template-coordinate sorted input "
                          "(header must advertise SS:template-coordinate). "
                          "Prepare with: fgumi-tpu zipper ... | fgumi-tpu "
                          "sort --order template-coordinate")
                return 2
            out_header = _header_with_pg(reader.header, " ".join(argv))
            with BamWriter(args.output, out_header,
                           level=args.compression_level) as writer:
                if args.classic:
                    counted = _CountedReader(reader)
                    metrics, family_sizes = run_dedup(
                        counted, writer, strategy=args.strategy,
                        edits=args.edits, min_mapq=args.min_map_q,
                        include_non_pf=args.include_non_pf_reads,
                        min_umi_length=args.min_umi_length,
                        no_umi=args.no_umi,
                        include_unmapped=args.include_unmapped,
                        remove_duplicates=args.remove_duplicates,
                        device=args.device)
                    n_in = counted.n
                else:
                    metrics, family_sizes, n_in, walls, stage_times = \
                        _run_fast_dedup(args, reader, writer)
    except (ValueError, OSError) as e:
        if isinstance(e, OSError) and e.errno == errno.ENOSPC:
            raise
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    if args.stats and stage_times is not None:
        _print_stats(stage_times, dt)
    log.info("dedup: %d templates (%d unique, %d duplicate, rate %.4f), "
             "%d reads in %.2fs",
             metrics.total_templates, metrics.unique_templates,
             metrics.duplicate_templates, metrics.duplicate_rate(),
             metrics.total_reads, dt)
    dropped = metrics.filter.as_dict()
    dropped.pop("total_templates", None)
    dropped.pop("accepted", None)
    if dropped:
        log.info("dedup: templates dropped by filtering: %s", dropped)
    if metrics.missing_tc_tag:
        log.warning("%d secondary/supplementary reads missing the tc tag "
                    "(run zipper before sort)", metrics.missing_tc_tag)
    if args.metrics:
        write_metrics(metrics, args.metrics)
    if args.family_size_histogram:
        write_family_size_histogram(family_sizes, args.family_size_histogram)
    if args.stats_json:
        counters = _kernel_counters()
        stats = {"device": args.device, "engine": engine,
                 "strategy": args.strategy, "input_reads": n_in,
                 "wall_s": dt, **walls,
                 "launches": {k: counters[k] - counters0[k]
                              for k in counters},
                 "device_span": assigners.DEVICE_SPAN.as_dict(),
                 "metrics": {**{c: getattr(metrics, c)
                                for c in _METRIC_COLUMNS
                                if c != "duplicate_rate"},
                             "duplicate_rate": metrics.duplicate_rate(),
                             "filter": metrics.filter.as_dict()},
                 "family_sizes": family_sizes}
        if stage_times is not None:
            stats.update(_stage_stats(args, stage_times))
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _add_compare(sub):
    p = sub.add_parser("compare",
                       help="Compare files for testing and validation")
    ps = p.add_subparsers(dest="compare_mode", required=True)
    b = ps.add_parser("bams", help="Compare two BAMs (exit 1 on mismatch)")
    b.add_argument("-a", required=True, help="first BAM")
    b.add_argument("-b", required=True, help="second BAM")
    b.add_argument("--mode", choices=["content", "grouping"], default=None,
                   help="content: exact record compare; grouping: "
                        "MI-invariant molecule equivalence (default: "
                        "content, or the --command preset's mode)")
    b.add_argument("--command", default=None, dest="preset",
                   choices=["extract", "zipper", "sort", "correct", "dedup",
                            "clip", "filter", "group", "simplex", "duplex",
                            "codec"],
                   help="the mode and ignore-order defaults for comparing "
                        "one pipeline stage's output (the reference's "
                        "CommandPreset): group -> grouping mode; sort -> "
                        "the sort-verify engine; every other -> exact "
                        "content. An explicit --mode/--ignore-order wins")
    b.add_argument("--ignore-order", type=_parse_bool, nargs="?",
                   const=True, default=None,
                   help="content mode: compare as multisets (true/false; "
                        "an explicit value overrides a --command preset in "
                        "either direction)")
    b.add_argument("--ignore-tags", nargs="*", default=[],
                   help="tags excluded from comparison")
    b.add_argument("--tag", default="MI",
                   help="grouping tag (grouping mode)")
    b.add_argument("--verify-sort", action="store_true",
                   help="also verify that each input satisfies its "
                        "header's declared sort order")
    b.set_defaults(func=cmd_compare_bams)
    m = ps.add_parser("metrics",
                      help="Compare two metric TSVs (exit 1 on mismatch)")
    m.add_argument("-a", required=True)
    m.add_argument("-b", required=True)
    m.add_argument("--float-tolerance", type=float, default=1e-5)
    m.set_defaults(func=cmd_compare_metrics)


def cmd_compare_bams(args, argv):
    from .commands.compare import run_compare_bams

    return run_compare_bams(args)


def cmd_compare_metrics(args, argv):
    from .commands.compare import run_compare_metrics

    return run_compare_metrics(args)


def _add_correct(sub):
    p = sub.add_parser("correct", help="Correct UMIs to a fixed whitelist")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-u", "--umis", nargs="*", default=[],
                   help="whitelist UMI sequences")
    p.add_argument("-U", "--umi-files", nargs="*", default=[],
                   help="files with one whitelist UMI per line")
    p.add_argument("-m", "--metrics", default=None, help="per-UMI metrics TSV")
    p.add_argument("-r", "--rejects", default=None,
                   help="BAM for records whose UMI could not be corrected")
    p.add_argument("--target", choices=["umi", "barcode"], default="umi",
                   help="umi: RX (original in OX); barcode: BC (original in ob)")
    p.add_argument("--max-mismatches", type=int, default=2)
    p.add_argument("--min-distance", type=int, default=2,
                   dest="min_distance_diff")
    p.add_argument("--dont-store-original", action="store_true")
    p.add_argument("--cache-size", type=int, default=100_000)
    p.add_argument("--min-corrected", type=float, default=None,
                   help="fail if kept/total falls below this fraction")
    p.add_argument("--revcomp", action="store_true",
                   help="reverse-complement observed UMIs before matching")
    p.add_argument("--classic", action="store_true",
                   help="the per-template engine (default: the batch "
                        "engine)")
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_correct)


def cmd_correct(args, argv):
    """The reference's ``correct`` (fgumi_tpu/cli.py cmd_correct): the
    whitelist sweep runs in numpy on the host, on either engine."""
    import contextlib

    from .commands.correct import (UmiMatcher, find_umi_pairs_within_distance,
                                   load_umi_sequences, run_correct,
                                   write_correction_metrics)
    from .io.bam import BamReader, BamWriter

    if args.min_corrected is not None and not 0.0 <= args.min_corrected <= 1.0:
        log.error("--min-corrected must be between 0 and 1")
        return 2
    try:
        umis, umi_length = load_umi_sequences(args.umis, args.umi_files)
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2
    log.info("correct: loaded %d whitelist UMIs of length %d", len(umis),
             umi_length)
    # ambiguity warning (fgbio uses min_distance_diff - 1; 0 reports nothing)
    if args.min_distance_diff > 0:
        pairs = find_umi_pairs_within_distance(umis,
                                               args.min_distance_diff - 1)
        for u1, u2, d in pairs:
            log.warning("whitelist UMIs within min-distance-diff: %s <-> %s "
                        "(distance %d) — may be ambiguous and fail to match",
                        u1, u2, d)
    matcher = UmiMatcher(umis, args.max_mismatches, args.min_distance_diff,
                         args.cache_size)
    if args.classic:
        _Reader, _run = BamReader, run_correct
    else:
        from .commands.fast_correct import run_correct_fast
        from .io.batch_reader import BamBatchReader

        _Reader, _run = BamBatchReader, run_correct_fast
    t0 = time.monotonic()
    try:
        with _Reader(args.input) as reader:
            out_header = _header_with_pg(reader.header, " ".join(argv))
            with contextlib.ExitStack() as stack:
                writer = stack.enter_context(BamWriter(args.output,
                                                       out_header))
                rejects_writer = None
                if args.rejects:
                    rejects_writer = stack.enter_context(
                        BamWriter(args.rejects, out_header))
                stats = _run(
                    reader, writer, matcher, umi_length, target=args.target,
                    revcomp=args.revcomp,
                    store_original=not args.dont_store_original,
                    rejects_writer=rejects_writer)
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    rejected = stats.missing_umis + stats.wrong_length + stats.mismatched
    total = stats.records_written + rejected
    log.info("correct: read %d records; kept %d, rejected %d "
             "(%d missing, %d wrong length, %d mismatched) in %.2fs",
             total, stats.records_written, rejected, stats.missing_umis,
             stats.wrong_length, stats.mismatched, dt)
    if stats.missing_umis or stats.wrong_length:
        log.error("%d records missing UMI attributes; %d had UMIs of "
                  "unexpected length", stats.missing_umis, stats.wrong_length)
    if args.metrics:
        write_correction_metrics(stats, umi_length, args.metrics)
    if args.min_corrected is not None and total:
        ratio = stats.records_written / total
        if ratio < args.min_corrected:
            log.error("Final ratio of reads kept / total was %.2f (minimum "
                      "%.2f); this could indicate a mismatch between library "
                      "preparation and the provided UMI whitelist",
                      ratio, args.min_corrected)
            return 1
    return 0


def _merge_zipper_headers(mapped, unmapped):
    """Mapped header plus @RG/@PG/@CO lines only the unmapped header carries
    (build_output_header, zipper.rs:232-278): the aligner often drops the @RG
    written by extract, which downstream library lookups need."""
    from .io.bam import BamHeader

    def ids(lines, kind):
        out = set()
        for line in lines:
            if line.startswith(kind):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                if "ID" in fields:
                    out.add(fields["ID"])
        return out

    mapped_lines = mapped.text.splitlines()
    extra = []
    for kind in ("@RG", "@PG"):
        have = ids(mapped_lines, kind)
        for line in unmapped.text.splitlines():
            if line.startswith(kind):
                fields = dict(f.split(":", 1) for f in line.split("\t")[1:]
                              if ":" in f)
                if fields.get("ID") not in have:
                    extra.append(line)
    mapped_co = {line for line in mapped_lines if line.startswith("@CO")}
    extra.extend(line for line in unmapped.text.splitlines()
                 if line.startswith("@CO") and line not in mapped_co)
    if not extra:
        return mapped
    return BamHeader(text="\n".join(mapped_lines + extra) + "\n",
                     ref_names=mapped.ref_names,
                     ref_lengths=mapped.ref_lengths)


def _add_zipper(sub):
    p = sub.add_parser("zipper", help="Zip unmapped BAM with aligned BAM")
    p.add_argument("-i", "--input", required=True,
                   help="mapped BAM from the aligner (queryname ordered)")
    p.add_argument("-u", "--unmapped", required=True,
                   help="unmapped BAM with tags to restore (same ordering)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--tags-to-remove", nargs="*", default=[])
    p.add_argument("--tags-to-reverse", nargs="*", default=[],
                   help="tags (or the 'Consensus' set) to reverse on "
                        "negative strand")
    p.add_argument("--tags-to-revcomp", nargs="*", default=[],
                   help="tags (or the 'Consensus' set) to revcomp on "
                        "negative strand")
    p.add_argument("--skip-tc-tags", nargs="?", const=True, default=False,
                   type=_parse_bool)
    p.add_argument("--exclude-missing-reads", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="drop unmapped-BAM reads the aligner omitted")
    p.add_argument("--restore-unconverted-bases", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="EM-Seq: rewrite converted bases back to the "
                        "unconverted reference form at aligned ref-C/ref-G "
                        "positions after bwameth re-alignment (uses the "
                        "bwameth YD strand tag; requires --ref)")
    p.add_argument("-r", "--ref", default=None,
                   help="reference FASTA (required with "
                        "--restore-unconverted-bases)")
    p.add_argument("-K", "--bwa-chunk-size", type=int, default=150000000,
                   help="accepted for compatibility (bwa -K stdin buffer "
                        "sizing hint; this reader sizes buffers adaptively)")
    p.add_argument("--classic", action="store_true",
                   help="the per-template engine (default: the batch "
                        "engine)")
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_zipper)


def cmd_zipper(args, argv):
    """The reference's ``zipper`` (fgumi_tpu/cli.py cmd_zipper): the batch
    engine unless ``--classic``, ``--restore-unconverted-bases`` (per
    record) or a ``--tags-to-remove`` of a tag the batch engine itself
    appends (MQ/MC/ms/AS/XS) asks for the per-template one."""
    from .commands.zipper import TagInfo, run_zipper
    from .core.template import is_query_grouped
    from .io.bam import BamReader, BamWriter
    from .io.batch_reader import BamBatchReader, BatchedRecordReader

    tag_info = TagInfo.from_options(
        remove=args.tags_to_remove, reverse=args.tags_to_reverse,
        revcomp=args.tags_to_revcomp)
    restore = None
    if args.restore_unconverted_bases:
        if args.ref is None:
            log.error("--restore-unconverted-bases requires --ref")
            return 2
        restore_ref = _reference(args.ref)
        if restore_ref is None:
            return 2
        with BamReader(args.input) as r:
            restore = (restore_ref, r.header.ref_names)
    use_fast = (not args.classic and restore is None
                and not (tag_info.remove & {"MQ", "MC", "ms", "AS", "XS"}))
    t0 = time.monotonic()
    try:
        _Reader = BamBatchReader if use_fast else BatchedRecordReader
        with _Reader(args.input) as mapped, _Reader(args.unmapped) as unmapped:
            for name, r in (("mapped", mapped), ("unmapped", unmapped)):
                if not is_query_grouped(r.header.text):
                    log.error("zipper requires queryname-sorted or "
                              "query-grouped %s input (@HD must advertise "
                              "SO:queryname or GO:query)", name)
                    return 2
            out_header = _header_with_pg(
                _merge_zipper_headers(mapped.header, unmapped.header),
                " ".join(argv))
            with BamWriter(args.output, out_header) as writer:
                if use_fast:
                    from .commands.fast_zipper import run_zipper_fast

                    n_templates, n_records, n_missing = run_zipper_fast(
                        mapped, unmapped, writer, tag_info,
                        skip_tc_tags=args.skip_tc_tags,
                        exclude_missing_reads=args.exclude_missing_reads)
                else:
                    n_templates, n_records, n_missing = run_zipper(
                        mapped, unmapped, writer, tag_info,
                        skip_tc_tags=args.skip_tc_tags,
                        exclude_missing_reads=args.exclude_missing_reads,
                        restore_unconverted=restore)
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    log.info("zipper: %d templates (%d records) in %.2fs (%.0f rec/s)",
             n_templates, n_records, dt, n_records / dt if dt else 0)
    if n_missing:
        verb = "excluded" if args.exclude_missing_reads else "passed through"
        log.info("zipper: %d templates not present in the aligned BAM (%s)",
                 n_missing, verb)
    return 0


def _add_fastq(sub):
    def _flags(s):
        return int(s, 16) if s.lower().startswith("0x") else int(s)

    p = sub.add_parser("fastq", help="BAM -> mate-paired interleaved FASTQ")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default="-",
                   help="output FASTQ (- for stdout)")
    p.add_argument("-n", "--no-read-suffix", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="don't append /1 and /2 to read names")
    p.add_argument("-F", "--exclude-flags", type=_flags, default=0x900,
                   help="exclude reads with ANY of these flags "
                        "(default 0x900 = secondary|supplementary)")
    p.add_argument("-f", "--require-flags", type=_flags, default=0,
                   help="only include reads with ALL of these flags")
    p.add_argument("-a", "-U", "--annotate-read-names", nargs="?", const=True,
                   default=False, type=_parse_bool,
                   help="append the UMI to the read name before any /1 "
                        "suffix (samtools fastq -U / DRAGEN layout)")
    p.add_argument("--umi-tag", default="RX,OX",
                   help="comma list of tags to read the UMI from, first "
                        "present wins")
    p.add_argument("--umi-name-delim", default=":",
                   help="delimiter between read name and UMI")
    p.add_argument("--umi-sep", default="+",
                   help="duplex-UMI half separator in the read name "
                        "(stored '-' is rewritten to this)")
    p.add_argument("-K", "--bwa-chunk-size", type=int, default=150000000,
                   help="accepted for compatibility (bwa -K output buffer "
                        "sizing hint)")
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_fastq)


def cmd_fastq(args, argv):
    """The reference's ``fastq`` (fgumi_tpu/cli.py cmd_fastq): mates
    interleaved through a map of pending reads, secondary and
    supplementary records (a non-default ``-F``) written as they come and
    never paired, orphans last in input order; a file output is published
    only when complete."""
    from .constants import reverse_complement_bytes
    from .io.bam import (FLAG_FIRST, FLAG_LAST, FLAG_PAIRED, FLAG_REVERSE,
                         FLAG_SECONDARY, FLAG_SUPPLEMENTARY, BamReader)
    from .utils.atomic import discard_output, open_output

    out = sys.stdout.buffer if args.output == "-" else open_output(args.output)
    n = 0
    umi_tags = [t.strip().encode() for t in args.umi_tag.split(",")
                if t.strip()]
    name_delim = args.umi_name_delim.encode()
    umi_sep = args.umi_sep
    exclude = args.exclude_flags
    require = args.require_flags

    def umi_of(rec):
        for tag in umi_tags:
            v = rec.get_str(tag)
            if v:
                # stored duplex UMIs use '-' between halves; aligner-facing
                # names use --umi-sep (DRAGEN/samtools '+')
                return v.replace("-", umi_sep).encode()
        return None

    def emit(rec):
        nonlocal n
        seq = rec.seq_bytes()
        quals = rec.quals()
        if rec.flag & FLAG_REVERSE:
            seq = reverse_complement_bytes(seq)
            quals = quals[::-1]
        name = rec.name
        if args.annotate_read_names:
            umi = umi_of(rec)
            if umi:
                name = name + name_delim + umi
        suffix = b""
        if not args.no_read_suffix:
            suffix = b"/1" if rec.flag & FLAG_FIRST else (
                b"/2" if rec.flag & FLAG_LAST else b"")
        out.write(b"@" + name + suffix + b"\n" + seq + b"\n+\n"
                  + (quals + 33).tobytes() + b"\n")
        n += 1

    pending = {}
    try:
        with BamReader(args.input) as reader:
            for rec in reader:
                if (rec.flag & exclude) or (rec.flag & require) != require:
                    continue
                if rec.flag & (FLAG_SECONDARY | FLAG_SUPPLEMENTARY) \
                        or not rec.flag & FLAG_PAIRED:
                    # a secondary or supplementary record (admitted by a
                    # non-default -F) never enters the mate pairing: a
                    # supplementary R1 would pair with its own primary
                    emit(rec)
                    continue
                mate = pending.pop(rec.name, None)
                if mate is None:
                    pending[rec.name] = rec
                else:
                    r1, r2 = ((rec, mate) if rec.flag & FLAG_FIRST
                              else (mate, rec))
                    emit(r1)
                    emit(r2)
        for rec in pending.values():  # orphaned mates, in input order
            emit(rec)
    except BaseException:
        if out is not sys.stdout.buffer:
            discard_output(out)
        raise
    else:
        out.flush()
        if out is not sys.stdout.buffer:
            out.close()
    log.info("fastq: wrote %d reads", n)
    return 0


def _add_merge(sub):
    p = sub.add_parser("merge", help="Merge same-order sorted BAMs")
    p.add_argument("-i", "--input", nargs="+", default=[])
    p.add_argument("--input-list", default=None,
                   help="file with one input BAM path per line (combined "
                        "with -i)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--order", default="template-coordinate",
                   choices=["coordinate", "queryname", "template-coordinate"])
    p.add_argument("--subsort", default="natural", choices=["natural", "lex"])
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_merge)


def cmd_merge(args, argv):
    """The reference's ``merge`` (fgumi_tpu/cli.py cmd_merge) on its
    batch-key route: each input's packed sort keys are extracted a batch
    at a time (sort/keys.py) and ``heapq`` merges them; memcmp order of
    the keys is the sort order, and ties keep the input order."""
    import heapq

    from .core.template import _hd_fields
    from .io.bam import BamHeader, BamReader, BamWriter
    from .sort.external import header_tags_for_order
    from .sort.keys import iter_keyed_records, make_batch_keys_fn

    if args.input_list:
        try:
            with open(args.input_list) as f:
                stripped = (line.strip() for line in f)
                args.input = list(args.input) + [
                    s for s in stripped if s and not s.startswith("#")]
        except OSError as e:
            log.error("cannot read --input-list %s: %s", args.input_list, e)
            return 2
        missing = [p for p in args.input if not os.path.exists(p)]
        if missing:
            log.error("--input-list names missing file(s): %s",
                      ", ".join(missing[:5]))
            return 2
    if not args.input:
        log.error("no inputs: pass -i and/or --input-list")
        return 2
    headers = []
    for path in args.input:
        with BamReader(path) as r:
            headers.append(r.header)
    first = headers[0]
    so, go, ss = header_tags_for_order(args.order, args.subsort)
    for path, h in zip(args.input, headers):
        if h.ref_names != first.ref_names \
                or h.ref_lengths != first.ref_lengths:
            log.error("merge: inputs have differing reference sequences")
            return 2
        hd = _hd_fields(h.text)
        ok = (hd.get("SO") == so and (go is None or hd.get("GO") == go)
              and (ss is None or hd.get("SS") == ss))
        if not ok:
            log.error("merge: %s is not sorted by the requested order "
                      "(--order %s needs SO:%s%s%s; header has %s)",
                      path, args.order, so, f" GO:{go}" if go else "",
                      f" SS:{ss}" if ss else "", hd)
            return 2
    # the union of the @RG/@PG/@CO lines of every input (first one wins)
    seen_lines = []
    seen_set = set()
    for h in headers:
        for line in h.text.splitlines():
            if line.startswith(("@RG", "@PG", "@CO")) \
                    and line not in seen_set:
                seen_set.add(line)
                seen_lines.append(line)
    base_lines = [line for line in first.text.splitlines()
                  if not line.startswith(("@RG", "@PG", "@CO"))]
    merged_text = "\n".join(base_lines + seen_lines) + "\n"
    out_header = BamHeader(text=_rewrite_hd(merged_text, so, go, ss),
                           ref_names=first.ref_names,
                           ref_lengths=first.ref_lengths)
    batch_keys_fn = make_batch_keys_fn(args.order, first, args.subsort)
    n = 0
    with BamWriter(args.output, out_header) as writer:
        streams = [((key, idx, data)
                    for key, data in iter_keyed_records(p, batch_keys_fn))
                   for idx, p in enumerate(args.input)]
        for _, _, data in heapq.merge(*streams):
            writer.write_record_bytes(data)
            n += 1
    log.info("merge: %d records from %d inputs", n, len(args.input))
    return 0


def _add_clip(sub):
    p = sub.add_parser("clip", help="Clip overlapping reads in BAM files")
    p.add_argument("-i", "--input", required=True,
                   help="queryname sorted/grouped BAM")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-r", "--reference", required=True,
                   help="reference FASTA (for NM/UQ/MD regeneration)")
    p.add_argument("-c", "--clipping-mode", default="hard",
                   choices=["soft", "soft-with-mask", "hard"])
    p.add_argument("--clip-overlapping-reads", action="store_true")
    p.add_argument("--clip-bases-past-mate", "--clip-extending-past-mate",
                   dest="clip_extending_past_mate", action="store_true")
    p.add_argument("--read-one-five-prime", type=int, default=0)
    p.add_argument("--read-one-three-prime", type=int, default=0)
    p.add_argument("--read-two-five-prime", type=int, default=0)
    p.add_argument("--read-two-three-prime", type=int, default=0)
    p.add_argument("-H", "--upgrade-clipping", action="store_true",
                   help="upgrade existing clipping to the configured mode")
    p.add_argument("-a", "--auto-clip-attributes", action="store_true",
                   help="hard-clip per-base tags matching read length")
    p.add_argument("-m", "--metrics", default=None)
    _add_compression_level(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_clip)


def cmd_clip(args, argv):
    """The reference's ``clip`` (fgumi_tpu/cli.py cmd_clip): a template at
    a time through ``core/clipper.RecordClipper``, mate info repaired and
    NM/UQ/MD regenerated against the FASTA."""
    from .commands.clip import ClipParams, run_clip, write_clip_metrics
    from .core.reference import ReferenceReader
    from .core.template import is_query_grouped
    from .io.bam import BamReader, BamWriter

    params = ClipParams(
        clipping_mode=args.clipping_mode,
        clip_overlapping_reads=args.clip_overlapping_reads,
        clip_extending_past_mate=args.clip_extending_past_mate,
        read_one_five_prime=args.read_one_five_prime,
        read_one_three_prime=args.read_one_three_prime,
        read_two_five_prime=args.read_two_five_prime,
        read_two_three_prime=args.read_two_three_prime,
        upgrade_clipping=args.upgrade_clipping,
        auto_clip_attributes=args.auto_clip_attributes)
    if not params.any_clipping():
        log.error("At least one clipping option is required")
        return 2
    if _bad_level(args):
        return 2
    t0 = time.monotonic()
    try:
        reference = ReferenceReader(args.reference)
        with BamReader(args.input) as reader:
            if not is_query_grouped(reader.header.text):
                log.error("clip requires queryname sorted or query grouped "
                          "input (@HD must advertise SO:queryname or "
                          "GO:query); sort with `fgumi-tpu sort --order "
                          "queryname` first")
                return 2
            out_header = _header_with_pg(reader.header, " ".join(argv))
            with BamWriter(args.output, out_header,
                           level=args.compression_level) as writer:
                metrics = run_clip(reader, writer, reference, params)
    except (ValueError, OSError, KeyError) as e:
        log.error("%s", e)
        return 2
    log.info("clip: %d templates (%d overlap-clipped, %d extend-clipped) "
             "in %.2fs", metrics.templates, metrics.overlap_clipped,
             metrics.extend_clipped, time.monotonic() - t0)
    if args.metrics:
        write_clip_metrics(metrics, args.metrics)
    return 0


def _add_downsample(sub):
    p = sub.add_parser("downsample", help="Downsample BAM by UMI family")
    p.add_argument("-i", "--input", required=True,
                   help="grouped BAM with MI tags (template-coordinate order)")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-f", "--fraction", type=float, required=True,
                   help="fraction of UMI families to keep, in (0.0, 1.0]")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--rejects", default=None)
    p.add_argument("--validate-mi-order", nargs="?", const=True,
                   default=True, type=_parse_bool)
    p.add_argument("--histogram-kept", default=None)
    p.add_argument("--histogram-rejected", default=None)
    _add_compression_level(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_downsample)


def cmd_downsample(args, argv):
    """The reference's ``downsample`` (fgumi_tpu/cli.py cmd_downsample):
    one draw of Python's ``random.Random(--seed)`` a family, so a seed
    keeps the reference's families."""
    from .commands.downsample import run_downsample
    from .io.bam import BamReader, BamWriter
    from .metrics import write_family_size_histogram

    if _bad_level(args):
        return 2
    t0 = time.monotonic()
    try:
        with BamReader(args.input) as reader:
            out_header = _header_with_pg(reader.header, " ".join(argv))
            rejects = (BamWriter(args.rejects, out_header,
                                 level=args.compression_level)
                       if args.rejects else None)
            ok = False
            try:
                with BamWriter(args.output, out_header,
                               level=args.compression_level) as writer:
                    stats = run_downsample(
                        reader, writer, args.fraction, seed=args.seed,
                        rejects_writer=rejects,
                        validate_mi_order=args.validate_mi_order)
                ok = True
            finally:
                if rejects is not None:
                    (rejects.close if ok else rejects.discard)()
    except (ValueError, OSError) as e:
        log.error("%s", e)
        return 2
    # family_size -> count, ascending (downsample.rs:286-297)
    for sizes, path in ((stats.kept_sizes, args.histogram_kept),
                        (stats.rejected_sizes, args.histogram_rejected)):
        if path:
            write_family_size_histogram(dict(sorted(sizes.items())), path)
    log.info("downsample: kept %d/%d families (%d/%d records) in %.2fs",
             stats.families_kept, stats.families_total, stats.records_kept,
             stats.records_total, time.monotonic() - t0)
    return 0


def _add_review(sub):
    p = sub.add_parser("review",
                       help="Extract data to review variant calls from "
                            "consensus reads")
    p.add_argument("-i", "--input", required=True,
                   help="VCF or interval list of variant positions")
    p.add_argument("-c", "--consensus-bam", required=True,
                   help="coordinate-sorted consensus BAM")
    p.add_argument("-g", "--grouped-bam", required=True,
                   help="coordinate-sorted grouped raw-read BAM")
    p.add_argument("-r", "--ref", default=None,
                   help="reference FASTA (required for interval-list input)")
    p.add_argument("-o", "--output", required=True,
                   help="output prefix (.consensus.bam/.grouped.bam/.txt)")
    p.add_argument("-s", "--sample", default=None,
                   help="sample name for VCF genotype extraction")
    p.add_argument("-N", "--ignore-ns", type=_parse_bool, nargs="?",
                   const=True, default=False, metavar="true|false",
                   help="ignore N bases in consensus reads")
    p.add_argument("-m", "--maf", type=float, default=0.05,
                   help="only review variants at or below this MAF")
    p.set_defaults(func=cmd_review)


def cmd_review(args, argv):
    """The reference's ``review``: an indexed consensus pass when a BAI or
    CSI no older than the BAM sits beside it, else a streaming one."""
    from .commands.review import run_review

    return run_review(args)


def _add_metrics_options(p, min_reads_help: dict):
    p.add_argument("-i", "--input", required=True,
                   help="grouped BAM (MI tags, template-coordinate order)")
    p.add_argument("-o", "--output", required=True,
                   help="output path prefix for metric files")
    p.add_argument("--intervals", default=None,
                   help="BED or Picard interval list restricting analysis")
    for flag, help_text in min_reads_help.items():
        p.add_argument(flag, type=int, default=1, help=help_text)


def _add_duplex_metrics(sub):
    p = sub.add_parser("duplex-metrics",
                       help="Collect QC metrics for duplex sequencing "
                            "(grouped BAM)")
    _add_metrics_options(p, {
        "--min-ab-reads": "min AB-strand reads for a family to count as "
                          "duplex",
        "--min-ba-reads": "min BA-strand reads for a family to count as "
                          "duplex"})
    p.add_argument("--duplex-umi-counts", action="store_true",
                   help="also write duplex UMI pair counts (memory "
                        "intensive)")
    p.add_argument("--description", default=None,
                   help="accepted and ignored, as in the reference: it "
                        "titles only the reference's optional R plots")
    p.set_defaults(func=cmd_duplex_metrics)


def cmd_duplex_metrics(args, argv):
    from .commands.duplex_metrics import run_duplex_metrics

    return run_duplex_metrics(args)


def _add_simplex_metrics(sub):
    p = sub.add_parser("simplex-metrics",
                       help="Collect QC metrics for simplex sequencing "
                            "(grouped BAM)")
    _add_metrics_options(p, {
        "--min-reads": "min family size counted toward "
                       "ss_consensus_families"})
    p.add_argument("--description", default=None,
                   help="accepted and ignored, as in the reference: it "
                        "titles only the reference's optional R plots")
    p.set_defaults(func=cmd_simplex_metrics)


def cmd_simplex_metrics(args, argv):
    from .commands.simplex_metrics import run_simplex_metrics

    return run_simplex_metrics(args)


def _add_pipeline(sub):
    p = sub.add_parser(
        "pipeline",
        help="FASTQ -> filtered consensus BAM: extract, sort, group, "
             "simplex, filter chained in one process")
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="FASTQ file per sequencing read (R1 [R2 ...])")
    p.add_argument("-r", "--read-structures", nargs="*", default=[],
                   help="one per FASTQ, e.g. 8M12S+T (default +T)")
    p.add_argument("-o", "--output", required=True,
                   help="filtered consensus BAM")
    p.add_argument("--sample", required=True)
    p.add_argument("--library", required=True)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="forwarded to group and simplex: cuda (default) "
                        "runs the CUDA kernels, cpu their plain PyTorch "
                        "versions")
    p.add_argument("-s", "--strategy", default="adjacency",
                   help="UMI assignment strategy (group -s)")
    p.add_argument("--consensus-min-reads", type=int, default=1,
                   help="simplex --min-reads")
    p.add_argument("--filter-min-reads", type=int, default=3,
                   help="filter --min-reads")
    p.add_argument("--keep-intermediates", default=None, metavar="DIR",
                   help="write the stage outputs here and keep them (runs "
                        "the staged chain)")
    p.add_argument("--no-fuse", action="store_true",
                   help="run the staged chain (intermediate BAMs in a temp "
                        "directory beside the output) instead of the fused "
                        "in-memory chain; the records are identical")
    p.add_argument("--device-filter", action="store_true",
                   help="fuse the filter stage into simplex (kernel K1-f): "
                        "records identical to the chained filter stage")
    p.add_argument("--compression-level", type=int, default=1,
                   help="BGZF level of the final output, 0-9 (default 1; "
                        "the reference's 10-12 are not yet ported); "
                        "intermediates are level 0")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="write the run's counters (each stage's wall as "
                        "pipeline.stage.<name>.wall_s, the total wall, "
                        "kernel launches, the fused channels) as JSON")
    _add_threads(p, "forwarded to the stages that take it: sort's spill "
                    "workers, group and simplex on the stage runner")
    _add_pipeline_compat(p)
    # forwarded to the simplex stage; the stages' own @PG lines are what the
    # output records, and they leave the shard options out, so a shard's
    # header equals the unsharded run's
    _add_shard_opts(p)
    p.set_defaults(func=cmd_pipeline)


def _pipeline_stage_argvs(args, j):
    """The stage argv lists of the FastqToConsensus chain, shared by the
    staged and fused chains (identical argv in both, so flag handling
    cannot drift between them). ``j(name)`` maps an intermediate file name
    to its path: a real path in staged mode, an unused placeholder in fused
    mode. Intermediates are level 0; the user's --compression-level applies
    to the final output. --threads reaches sort, group and simplex and
    --memory-per-thread every stage, as the reference forwards them. With
    --stats-json, group, simplex and filter write their own counters
    beside it (:func:`_stage_stats_path`)."""
    thr = ["--threads", str(args.threads)] if args.threads else []
    fwd = (["--memory-per-thread", args.memory_per_thread]
           if args.memory_per_thread else [])
    lvl0 = ["--compression-level", "0"]
    out_lvl = ["--compression-level", str(args.compression_level)]
    dev = ["--device", args.device]
    rs = (["-r"] + args.read_structures) if args.read_structures else []

    def st(name):
        return (["--stats-json", _stage_stats_path(args, name)]
                if args.stats_json else [])

    stages = [
        ("extract", ["extract", "-i"] + args.input + rs +
         ["-o", j("unmapped.bam"), "--sample", args.sample,
          "--library", args.library] + lvl0 + fwd),
        ("sort", ["sort", "-i", j("unmapped.bam"), "-o", j("sorted.bam"),
                  "--order", "template-coordinate"] + lvl0 + thr + fwd),
        ("group", ["group", "-i", j("sorted.bam"), "-o", j("grouped.bam"),
                   "-s", args.strategy, "--allow-unmapped"] + dev + lvl0
         + thr + fwd + st("group")),
    ]
    if args.device_filter:
        # the filter stage fuses into simplex, which writes the final output
        stages.append(
            ("simplex", ["simplex", "-i", j("grouped.bam"),
                         "-o", args.output,
                         "--min-reads", str(args.consensus_min_reads),
                         "--allow-unmapped", "--device-filter",
                         "--filter-min-reads", str(args.filter_min_reads)]
             + dev + out_lvl + thr + fwd + st("simplex")))
        return stages
    stages += [
        ("simplex", ["simplex", "-i", j("grouped.bam"), "-o", j("cons.bam"),
                     "--min-reads", str(args.consensus_min_reads),
                     "--allow-unmapped"] + dev + lvl0 + thr + fwd
         + st("simplex")),
        ("filter", ["filter", "-i", j("cons.bam"), "-o", args.output,
                    "--min-reads", str(args.filter_min_reads)] + out_lvl
         + fwd + st("filter")),
    ]
    return stages


def _pipeline_shard_argv(args, name: str) -> list:
    """The scatter options a pipeline forwards to its ``name`` stage: the
    simplex stage's, when the run is a shard. The front stages replicate
    the full deterministic stream on every shard (identical MI assignment
    and family ordinals everywhere) and the shard filter cuts the stream
    at the simplex stage, where families become independent. They are
    parsed, never recorded: the stage's @PG line is built from its argv
    without them. The filter stage of a shard that writes a manifest logs
    its keep flags (:func:`_shard_keep_log`)."""
    keep_log = _shard_keep_log(args)
    if name == "filter" and keep_log:
        return ["--keep-log", keep_log]
    if name != "simplex" or not args.shard:
        return []
    out = ["--shard", args.shard, "--shard-by", args.shard_by]
    if args.shard_manifest:
        out += ["--shard-manifest", args.shard_manifest]
    return out


def _shard_keep_log(args):
    """Where a pipeline shard's filter stage logs its keep flags, from which
    the simplex stage's family counts are recounted once the chain is done
    (None when the run is no shard with a manifest, or has no filter
    stage)."""
    if not args.shard or not args.shard_manifest or args.device_filter:
        return None
    return f"{args.shard_manifest}.keep"


def _pipeline_pg_lines(args):
    """With ``--pg-argv`` naming a pipeline command line (a scatter
    shard's: the whale's), the command line each stage's @PG records:
    that pipeline's own stage lines (the fused chain's placeholders for
    the intermediates), so every shard's header equals the unsharded
    run's. None without ``--pg-argv`` or when it names no pipeline
    command: the stages then record their own lines."""
    if not args.pg_argv:
        return None
    import contextlib
    import io
    import shlex

    words = shlex.split(args.pg_argv)[1:]
    if not words or words[0] != "pipeline":
        return None
    try:
        with contextlib.redirect_stderr(io.StringIO()):
            whale = build_parser().parse_args(words)
    except SystemExit:
        return None
    return {name: [PROGRAM_ID] + argv for name, argv in
            _pipeline_stage_argvs(whale, lambda name: f"<fused:{name}>")}


def _stage_stats_path(args, name: str) -> str:
    return f"{args.stats_json}.{name}.json"


def cmd_pipeline(args, argv):
    """FastqToConsensus in one process (the reference ships it as a
    Snakemake workflow over separate invocations, docs/FastqToConsensus-
    RnD.smk). Two modes with identical records:

    - **fused** (the default): one thread a stage, adjacent stages joined by
      byte-budgeted channels (``pipeline_chain``): no intermediate files,
      and the stages overlap (extract feeds the sort's ingest; the sort's
      merge is the natural barrier; group ⇒ simplex ⇒ filter stream).
    - **staged** (``--no-fuse`` or ``--keep-intermediates``): each stage
      re-enters :func:`main` and writes a level-0 intermediate BAM, deleted
      once the next stage has read it.

    The first stage in chain order that fails decides the exit code, and
    no final output is left behind.
    """
    if _bad_level(args):
        return 2
    if args.shard:
        # the simplex stage would refuse it only after the front stages
        from .core.sharding import parse_shard_arg

        try:
            parse_shard_arg(args.shard, args.shard_by)
        except ValueError as e:
            log.error("%s", e)
            return 2
    if _no_cuda("pipeline", args.device):
        return 2
    from .native import get_lib

    get_lib()  # build the native library before any stage starts
    counters0 = _kernel_counters()
    walls = {}
    t0 = time.monotonic()
    fused = not args.no_fuse and args.keep_intermediates is None
    stages = {}
    # the output's filesystem (the staged chain's intermediates too) is
    # watched against the disk watermarks for the whole run
    disk_token = GOVERNOR.watch_path(
        "output", os.path.dirname(os.path.abspath(args.output)))
    keep_log = _shard_keep_log(args)
    try:
        if fused:
            rc, chans = _pipeline_fused(args, walls)
        else:
            rc, chans = _pipeline_staged(args, walls), {}
        if not rc and keep_log:
            import numpy as np

            from .core.sharding import apply_keep_log

            apply_keep_log(args.shard_manifest,
                           np.load(keep_log, allow_pickle=False))
    finally:
        if keep_log and os.path.exists(keep_log):
            os.unlink(keep_log)
        GOVERNOR.unwatch_path(disk_token)
        for name in ("group", "simplex", "filter"):
            path = _stage_stats_path(args, name) if args.stats_json else None
            if path and os.path.exists(path):
                with open(path) as f:
                    stages[name] = json.load(f)
                os.unlink(path)
    dt = time.monotonic() - t0
    if rc:
        return rc
    log.info("pipeline: total %.2fs (%s) -> %s", dt,
             "fused" if fused else "staged", args.output)
    if args.stats_json:
        counters = _kernel_counters()
        stats = {"device": args.device, "fused": fused,
                 "device_filter": args.device_filter, "wall_s": dt,
                 **{f"pipeline.stage.{name}.wall_s": w
                    for name, w in walls.items()},
                 "launches": {k: counters[k] - counters0[k]
                              for k in counters},
                 "chain": chans, "stages": stages}
        with open(args.stats_json, "w") as f:
            json.dump(stats, f, indent=1)
    return 0


def _pipeline_fused(args, walls):
    """The fused chain: one thread a stage, adjacent stages joined
    by channels. A failing stage aborts its output channels and cancels
    its input channels, so the abort cascades both ways and every stage
    unwinds; the first stage in chain order with a real error decides the
    exit code. Returns (exit code, the channels' counters)."""
    import threading

    from .observe import heartbeat as _hb
    from .observe.metrics import METRICS
    from .observe.scope import spawn_thread
    from .pipeline_chain import (ChainAborted, ChainChannel,
                                 ChannelBamWriter, ChannelBatchReader)

    stages = _pipeline_stage_argvs(args, lambda name: f"<fused:{name}>")
    pg_lines = _pipeline_pg_lines(args) or {
        name: [PROGRAM_ID] + argv for name, argv in stages}
    parser = build_parser()
    pre = _forwarded_globals(args)
    ns = {name: parser.parse_args(
        pre + argv + _pipeline_shard_argv(args, name))
        for name, argv in stages}
    dfilt = args.device_filter
    c1 = ChainChannel("extract.sort")
    c2 = ChainChannel("sort.group")
    c3 = ChainChannel("group.simplex")
    c4 = None if dfilt else ChainChannel("simplex.filter")
    chans = [c for c in (c1, c2, c3, c4) if c is not None]

    def _sink(chan):
        return lambda header: ChannelBamWriter(chan, header)

    # writable=False where the consumer never writes its batches (sort
    # ingest copies into its pools, group builds fresh records); simplex's
    # overlap correction and filter's masks (native apply_masks, which
    # writes through the buffer's address) edit their batches in place
    calls = {
        "extract": lambda a, v: cmd_extract(a, v, sink=_sink(c1)),
        "sort": lambda a, v: cmd_sort(
            a, v, source=ChannelBatchReader(c1, writable=False),
            sink=_sink(c2)),
        "group": lambda a, v: cmd_group(
            a, v, source=ChannelBatchReader(c2, writable=False),
            sink=_sink(c3)),
        # --device-filter: simplex writes the final output itself
        "simplex": lambda a, v: cmd_simplex(
            a, v, source=ChannelBatchReader(
                c3, target_bytes=ns["simplex"].batch_bytes),
            sink=None if dfilt else _sink(c4)),
    }
    ins = {"extract": [], "sort": [c1], "group": [c2], "simplex": [c3]}
    outs = {"extract": [c1], "sort": [c2], "group": [c3],
            "simplex": [] if dfilt else [c4]}
    if not dfilt:
        calls["filter"] = lambda a, v: cmd_filter(
            a, v, source=ChannelBatchReader(c4))
        ins["filter"] = [c4]
        outs["filter"] = []

    results = {}
    lock = threading.Lock()
    active = set()

    def runner(name, argv):
        t0 = time.monotonic()
        rc = err = None
        aborted = False
        with lock:
            active.add(name)
        try:
            # each stage maps its compat flags, as main() does for a
            # staged stage
            rc = _apply_pipeline_compat(ns[name]) \
                or calls[name](ns[name], pg_lines[name])
        except ChainAborted:
            aborted = True  # a cascade victim: the root cause is elsewhere
        except BaseException as e:  # noqa: BLE001 - re-raised by the caller
            err = e
        finally:
            walls[name] = time.monotonic() - t0
            METRICS.inc(f"pipeline.stage.{name}.wall_s",
                        round(walls[name], 6))
            with lock:
                active.discard(name)
                results[name] = {"rc": rc, "error": err,
                                 "aborted": aborted}
            if rc == 0 and err is None and not aborted:
                for c in outs[name]:
                    c.close()  # backstop: the stage's writer closed it
                log.info("pipeline: %s done in %.2fs", name, walls[name])
            else:
                for c in outs[name]:
                    c.abort(f"pipeline stage {name} failed")
                for c in ins[name]:
                    c.cancel()

    METRICS.set("pipeline.chain.fused", 1)

    def running_stages():
        # for the heartbeat: the started stages past their input-header
        # wait (a stage waiting for the sort's merge is not running yet)
        with lock:
            started = [n for n, _ in stages if n in active]
        return {"stage": "+".join(
            n for n in started
            if all(c.has_header for c in ins[n])) or "-"}

    gauge_token = _hb.register_gauge(running_stages)
    # each stage thread runs in a copy of this context: its spans and
    # counters land in this command's telemetry scope
    threads = [spawn_thread(runner, args=(name, argv),
                            name=f"fgumi-chain-{name}")
               for name, argv in stages]
    try:
        for t in threads:
            t.start()
        try:
            for t in threads:
                while t.is_alive():
                    t.join(timeout=0.2)
        except BaseException:
            # KeyboardInterrupt (or anything else) on the calling thread:
            # tear the chain down so every stage unwinds, then re-raise
            for c in chans:
                c.abort("pipeline interrupted")
                c.cancel()
            for t in threads:
                t.join(timeout=10)
            raise
    finally:
        _hb.unregister_gauge(gauge_token)
        for c in chans:
            c.fold_metrics()
    chan_stats = {c.name: c.stats() for c in chans}
    for name, _ in stages:
        r = results[name]
        if r["error"] is not None:
            raise r["error"]
        if r["rc"] not in (0, None):
            log.error("pipeline: stage %s failed (rc=%d)", name, r["rc"])
            return r["rc"], chan_stats
    aborted = [n for n, _ in stages if results[n]["aborted"]]
    if aborted:
        log.error("pipeline: stage(s) %s aborted with no root cause "
                  "recorded", ",".join(aborted))
        return 1, chan_stats
    return 0, chan_stats


def _pipeline_staged(args, walls):
    """The staged chain: each stage re-enters :func:`main` and writes a
    level-0 intermediate BAM (in a temporary directory beside the output,
    or in --keep-intermediates), deleted as soon as the next stage has
    read it."""
    import shutil
    import tempfile

    keep = args.keep_intermediates
    if keep:
        tmp = keep
        os.makedirs(tmp, exist_ok=True)
    else:
        out_dir = os.path.dirname(os.path.abspath(args.output))
        tmp = tempfile.mkdtemp(prefix=".fgumi_pipeline_", dir=out_dir)

    def j(name):
        return os.path.join(tmp, name)

    from .observe import heartbeat as _hb
    from .observe.metrics import METRICS

    consumed = {"sort": "unmapped.bam", "group": "sorted.bam",
                "simplex": "grouped.bam", "filter": "cons.bam"}
    # each stage re-enters main(), which sets the atomic-commit and audit
    # flags from its own arguments: the outer ones travel with it
    from .observe.scope import command_argv

    pre = _forwarded_globals(args)
    pg_lines = _pipeline_pg_lines(args)
    current = {"stage": "-"}
    gauge_token = _hb.register_gauge(lambda: dict(current))
    try:
        for name, argv in _pipeline_stage_argvs(args, j):
            # a hard watermark stops the chain before its next stage
            GOVERNOR.check_hard()
            current["stage"] = name
            t0 = time.monotonic()
            # each stage records its own command line (without the shard
            # options), also inside a serve job, as the fused chain does
            with command_argv(pg_lines[name] if pg_lines
                              else [PROGRAM_ID] + pre + argv):
                rc = main(pre + argv + _pipeline_shard_argv(args, name))
            walls[name] = time.monotonic() - t0
            METRICS.inc(f"pipeline.stage.{name}.wall_s",
                        round(walls[name], 6))
            if rc:
                log.error("pipeline: stage %s failed (rc=%d)", name, rc)
                return rc
            log.info("pipeline: %s done in %.2fs", name, walls[name])
            prev = consumed.get(name)
            if prev and not keep:
                os.unlink(j(prev))
    finally:
        _hb.unregister_gauge(gauge_token)
        if not keep:
            shutil.rmtree(tmp, ignore_errors=True)
    return 0


def _forwarded_globals(args) -> list:
    """The global options a pipeline's stages inherit as arguments."""
    pre = ["--no-atomic-output"] if args.no_atomic_output else []
    if args.audit_output:
        pre.append("--audit-output")
    return pre


def _add_extract(sub):
    p = sub.add_parser("extract",
                       help="Extract UMIs from FASTQ into unmapped BAM")
    p.add_argument("-i", "--input", required=True, nargs="+",
                   help="FASTQ file per sequencing read (R1 [R2 I1 I2 ...])")
    p.add_argument("-o", "--output", required=True,
                   help="output unmapped BAM")
    p.add_argument("-r", "--read-structures", nargs="*", default=[],
                   help="one per FASTQ, e.g. 8M12S+T (default +T for 1-2 "
                        "inputs)")
    p.add_argument("-q", "--store-umi-quals", action="store_true")
    p.add_argument("-C", "--store-cell-quals", action="store_true")
    p.add_argument("-Q", "--store-sample-barcode-qualities",
                   action="store_true")
    p.add_argument("-n", "--extract-umis-from-read-names",
                   action="store_true")
    p.add_argument("-a", "--annotate-read-names", action="store_true")
    p.add_argument("-s", "--single-tag", default=None)
    p.add_argument("--read-group-id", default="A")
    p.add_argument("--sample", required=True)
    p.add_argument("--library", required=True)
    p.add_argument("-b", "--barcode", default=None)
    p.add_argument("--platform", default="illumina")
    p.add_argument("--platform-unit", default=None)
    p.add_argument("--platform-model", default=None)
    p.add_argument("--sequencing-center", default=None)
    p.add_argument("--predicted-insert-size", type=int, default=None)
    p.add_argument("--description", default=None)
    p.add_argument("--run-date", default=None)
    p.add_argument("--comment", nargs="*", default=[])
    _add_compression_level(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_extract)


def cmd_extract(args, argv, sink=None):
    """``sink`` (the fused pipeline's channel writer) replaces the output
    file."""
    from .commands.extract import ExtractOptions, run_extract

    if _bad_level(args):
        return 2
    opts = ExtractOptions(
        read_structures=args.read_structures, sample=args.sample,
        library=args.library, read_group_id=args.read_group_id,
        store_umi_quals=args.store_umi_quals,
        store_cell_quals=args.store_cell_quals,
        store_sample_barcode_quals=args.store_sample_barcode_qualities,
        extract_umis_from_read_names=args.extract_umis_from_read_names,
        annotate_read_names=args.annotate_read_names,
        single_tag=args.single_tag, barcode=args.barcode,
        platform=args.platform, platform_unit=args.platform_unit,
        platform_model=args.platform_model,
        sequencing_center=args.sequencing_center,
        predicted_insert_size=args.predicted_insert_size,
        description=args.description, run_date=args.run_date,
        comments=args.comment, command_line=" ".join(argv))
    t0 = time.monotonic()
    try:
        n_records, n_sets = run_extract(args.input, args.output, opts,
                                        sink=sink,
                                        level=args.compression_level)
    except (ValueError, OSError) as e:  # bad structure, FASTQ or I/O
        log.error("%s", e)
        return 2
    dt = time.monotonic() - t0
    log.info("extract: %d read sets -> %d records in %.2fs (%.0f reads/s)",
             n_sets, n_records, dt, n_records / dt if dt else 0)
    return 0


def _add_sort(sub):
    p = sub.add_parser("sort", help="Sort a BAM (coordinate, queryname or "
                                    "template-coordinate)")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", default=None,
                   help="output BAM (not needed with --verify)")
    p.add_argument("--verify", nargs="?", const=True, default=False,
                   type=_parse_bool,
                   help="verify the input satisfies --order (no output "
                        "written); exits 1 on the first out-of-order record")
    p.add_argument("--order", default="template-coordinate",
                   choices=["coordinate", "queryname", "template-coordinate"])
    p.add_argument("--subsort", default="natural", choices=["natural", "lex"],
                   help="queryname comparator: natural (digit runs compare "
                        "as numbers) or lex")
    p.add_argument("--write-index", type=_parse_bool, nargs="?", const=True,
                   default=True, metavar="true|false",
                   help="write an index beside coordinate-sorted output "
                        "(default true)")
    p.add_argument("--index-format", default="bai", choices=["bai", "csi"],
                   help="index format (csi handles references over "
                        "512 Mbp)")
    p.add_argument("--threads", type=int, default=0,
                   help="N > 1: N - 1 spill workers sort and write runs "
                        "while ingest goes on, and with N > 2 the merge "
                        "prefetches run frames (output unchanged)")
    p.add_argument("--sort-threads", type=int, default=None,
                   help="folded into --threads (the wider of the two)")
    p.add_argument("--merge-threads", type=int, default=None,
                   help="folded into --threads (the wider of the two)")
    p.add_argument("--max-memory", default="auto",
                   help="sort accumulation budget: MiB count, human size "
                        "(512M, 2G), or auto (cgroup-aware available minus "
                        "reserve); at least 64 MiB")
    p.add_argument("--memory-reserve", default="1G",
                   help="held back from auto-detected memory")
    p.add_argument("--max-records-in-ram", type=int, default=None,
                   help="optional record-count cap on the in-RAM chunk")
    p.add_argument("--tmp-dir", default=None)
    p.add_argument("--max-temp-files", type=int, default=None,
                   help="advisory cap on spill runs (the k-way merge "
                        "streams any run count; values < 2 are rejected)")
    p.add_argument("--temp-codec", default="deflate",
                   help="accepted for compatibility (deflate): spill runs "
                        "are stored frames here")
    p.add_argument("--temp-compression", type=int, default=1,
                   help="accepted for compatibility (0-9 validated)")
    p.add_argument("--key-types", default="full",
                   help="sort-key lanes: full (library+MI lanes, the only "
                        "layout built)")
    _add_compression_level(p)
    _add_pipeline_compat(p)
    p.set_defaults(func=cmd_sort)


def _rewrite_hd(text, so, go, ss):
    lines = text.splitlines()
    fields = {"VN": "1.6"}
    rest = []
    for line in lines:
        if line.startswith("@HD"):
            fields.update(f.split(":", 1) for f in line.split("\t")[1:]
                          if ":" in f)
        else:
            rest.append(line)
    fields["SO"] = so
    fields.pop("GO", None)
    fields.pop("SS", None)
    if go:
        fields["GO"] = go
    if ss:
        fields["SS"] = ss
    hd = "@HD\t" + "\t".join(f"{k}:{v}" for k, v in fields.items())
    return "\n".join([hd] + rest) + "\n"


def _index_builder(header, index_format: str):
    """The BAI or CSI builder of a coordinate-sorted output; CSI's depth
    covers the longest reference (htslib's rule)."""
    from .io.bai import BaiBuilder, CsiBuilder, depth_for_length

    if index_format == "csi":
        return CsiBuilder(len(header.ref_names), depth=depth_for_length(
            max(header.ref_lengths, default=0)))
    return BaiBuilder(len(header.ref_names))


def _write_indexed_chunks(sorter, writer, index):
    """Sorted chunks to ``writer``, each record's virtual offsets and
    reference span into ``index``."""
    import numpy as np

    from .io.bam import FLAG_UNMAPPED
    from .native import batch as nb

    for blob, lens in sorter.sorted_chunks_with_lens():
        starts = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=starts[1:])
        voffs = writer.write_indexed(blob, starts)
        f = nb.decode_fields(blob, starts[:-1])
        cigar_off = f["data_off"] + 32 + f["l_read_name"].astype(np.int64)
        ends = nb.ref_spans(blob, cigar_off, f["n_cigar"], f["pos"])
        index.add_many(f["ref_id"], f["pos"], ends, voffs[:-1], voffs[1:],
                       (f["flag"] & FLAG_UNMAPPED) == 0)


def cmd_sort(args, argv, source=None, sink=None):
    """``source``/``sink`` (the fused pipeline's channels) replace the
    input and output files; a coordinate sort into a file writes its index
    (``--write-index``, the default) beside it."""
    from .io.bam import BamHeader, BamReader
    from .io.batch_reader import BamBatchReader
    from .sort.external import NativeExternalSorter, header_tags_for_order
    from .sort.keys import make_batch_keys_fn, make_key_bytes_fn
    from .utils.memory import parse_size, resolve_budget
    from .utils.progress import ProgressTracker

    # the sort/merge thread knobs size the reference's one worker pool
    args.threads = max(args.threads, args.sort_threads or 0,
                       args.merge_threads or 0)
    if args.key_types.strip().lower() not in ("full", "library,mi",
                                              "library mi", "mi,library"):
        log.error("--key-types %s: the full library+MI key layout is the "
                  "only one built", args.key_types)
        return 2
    if args.temp_codec.strip().lower() not in ("deflate", "libdeflate"):
        log.error("--temp-codec %s: only deflate is accepted",
                  args.temp_codec)
        return 2
    if not 0 <= args.temp_compression <= 9:
        log.error("--temp-compression must be 0-9")
        return 2
    if args.max_temp_files is not None and args.max_temp_files < 2:
        log.error("--max-temp-files must be >= 2")
        return 2
    if args.verify:
        # verify-only mode (sort.rs:207-212): key monotonicity over the
        # packed byte keys of the requested order, no output written
        with BamReader(args.input) as reader:
            key_fn = make_key_bytes_fn(args.order, reader.header,
                                       args.subsort)
            prev = b""
            for i, rec in enumerate(reader):
                k = key_fn(rec)
                if k < prev:
                    log.error("sort --verify: record %d out of %s order",
                              i, args.order)
                    return 1
                prev = k
        log.info("sort --verify: input satisfies %s order", args.order)
        return 0
    if args.output is None and sink is None:
        log.error("-o/--output is required (unless --verify)")
        return 2
    if _bad_level(args):
        return 2
    try:
        budget = resolve_budget(args.max_memory,
                                parse_size(args.memory_reserve))
    except ValueError as e:
        log.error("%s", e)
        return 2
    t0 = time.monotonic()
    with (BamBatchReader(args.input) if source is None
          else source) as reader:
        in_header = reader.header
        batch_keys_fn = make_batch_keys_fn(args.order, in_header,
                                           args.subsort)
        out_header = BamHeader(
            text=_rewrite_hd(in_header.text,
                             *header_tags_for_order(args.order,
                                                    args.subsort)),
            ref_names=in_header.ref_names, ref_lengths=in_header.ref_lengths)
        index = (_index_builder(in_header, args.index_format)
                 if args.order == "coordinate" and args.write_index
                 and sink is None else None)
        # --threads N > 1: N - 1 spill workers (the merge prefetches with
        # two or more)
        progress = ProgressTracker("sort")
        wprogress = ProgressTracker("sort-write")
        with NativeExternalSorter(max_bytes=budget, tmp_dir=args.tmp_dir,
                                  max_records=args.max_records_in_ram,
                                  spill_workers=max(args.threads - 1, 0)) \
                as sorter:
            sorter.ingest_batches(iter(reader), batch_keys_fn, progress.add)
            progress.finish()
            runs = sorter.n_runs
            with _output(args, out_header, sink) as writer:
                if index is None:
                    for arr in sorter.iter_sorted_wire():
                        writer.write_serialized(arr)
                        # the reference counts the fused chain's blobs
                        if sink is not None:
                            wprogress.add()
                else:
                    _write_indexed_chunks(sorter, writer, index)
                if sink is None:
                    wprogress.add(sorter.n_records)
            wprogress.finish()
        if index is not None:
            index.write(args.output + "." + args.index_format)
    dt = time.monotonic() - t0
    log.info("sort: %d records (%s, budget %dMB, %d spill runs, %d spill "
             "workers) in %.2fs (%.0f rec/s)", sorter.n_records, args.order,
             budget >> 20, runs, max(args.threads - 1, 0), dt,
             sorter.n_records / dt if dt else 0)
    return 0


def _add_simulate(sub):
    p = sub.add_parser("simulate", help="Generate synthetic test data")
    ps = p.add_subparsers(dest="sim_mode", required=True)
    g = ps.add_parser("grouped-reads", help="MI-grouped BAM (simplex input)")
    g.add_argument("-o", "--output", required=True)
    g.add_argument("--num-families", type=int, default=100)
    g.add_argument("--family-size", type=int, default=5)
    g.add_argument("--family-size-distribution", default="fixed",
                   choices=["fixed", "lognormal", "longtail"],
                   help="longtail = Pareto-tailed 1-50 mixture")
    g.add_argument("--read-length", type=int, default=100)
    g.add_argument("--read-length-jitter", type=int, default=0,
                   help="per-read 3' truncation up to N bases")
    g.add_argument("--qual-slope", type=float, default=0.0,
                   help="per-position Phred decay along the read")
    g.add_argument("--insert-size-mean", type=int, default=None,
                   help="normal insert-size model (default: uniform "
                        "1.5-3x read length)")
    g.add_argument("--insert-size-sd", type=int, default=0)
    g.add_argument("--error-rate", type=float, default=0.01)
    g.add_argument("--base-quality", type=int, default=35)
    g.add_argument("--single-end", action="store_true")
    g.add_argument("--seed", type=int, default=42)
    g.set_defaults(func=cmd_simulate_grouped)
    d = ps.add_parser("duplex-reads",
                      help="duplex-grouped BAM (/A,/B MI tags; duplex "
                           "input)")
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--num-molecules", type=int, default=100)
    d.add_argument("--reads-per-strand", type=int, default=3)
    d.add_argument("--read-length", type=int, default=100)
    d.add_argument("--error-rate", type=float, default=0.01)
    d.add_argument("--base-quality", type=int, default=35)
    d.add_argument("--ba-fraction", type=float, default=1.0)
    d.add_argument("--strand-bias-alpha", type=float, default=None,
                   help="Beta(alpha, beta) A/B strand read split (PCR "
                        "amplification bias model); default: symmetric "
                        "fixed split")
    d.add_argument("--strand-bias-beta", type=float, default=None)
    d.add_argument("--seed", type=int, default=42)
    d.set_defaults(func=cmd_simulate_duplex)
    c = ps.add_parser("codec-reads",
                      help="CODEC-shaped BAM (overlapping FR pairs, MI "
                           "tags; codec input)")
    c.add_argument("-o", "--output", required=True)
    c.add_argument("--num-molecules", type=int, default=100)
    c.add_argument("--pairs-per-molecule", type=int, default=1)
    c.add_argument("--read-length", type=int, default=100)
    c.add_argument("--error-rate", type=float, default=0.01)
    c.add_argument("--base-quality", type=int, default=35)
    c.add_argument("--overlap-fraction", type=float, default=0.5)
    c.add_argument("--seed", type=int, default=42)
    c.set_defaults(func=cmd_simulate_codec)
    m = ps.add_parser("mapped-reads",
                      help="template-coordinate BAM with RX tags (group "
                           "input)")
    m.add_argument("-o", "--output", required=True)
    m.add_argument("--num-families", type=int, default=100)
    m.add_argument("--family-size", type=int, default=5)
    m.add_argument("--read-length", type=int, default=100)
    m.add_argument("--umi-length", type=int, default=8)
    m.add_argument("--umi-error-rate", type=float, default=0.02)
    m.add_argument("--paired-umis", action="store_true")
    m.add_argument("--seed", type=int, default=42)
    m.set_defaults(func=cmd_simulate_mapped)
    f = ps.add_parser("fastq-reads",
                      help="paired gzip FASTQ with UMI prefixes (extract "
                           "and pipeline input)")
    f.add_argument("-1", "--r1", required=True, dest="r1")
    f.add_argument("-2", "--r2", required=True, dest="r2")
    f.add_argument("--truth", default=None, help="truth TSV output")
    f.add_argument("--num-families", type=int, default=100)
    f.add_argument("--family-size", type=int, default=5)
    f.add_argument("--family-size-distribution", default="fixed",
                   choices=["fixed", "lognormal", "longtail"])
    f.add_argument("--read-length", type=int, default=100)
    f.add_argument("--umi-length", type=int, default=8)
    f.add_argument("--error-rate", type=float, default=0.0)
    f.add_argument("--base-quality", type=int, default=35)
    f.add_argument("--duplex", action="store_true",
                   help="UMI prefix on both reads (duplex extraction)")
    f.add_argument("--includelist", default=None,
                   help="sample UMIs from this file (one per line)")
    f.add_argument("--seed", type=int, default=42)
    f.set_defaults(func=cmd_simulate_fastq)
    cr = ps.add_parser("consensus-reads",
                       help="mapped BAM shaped like consensus output (filter "
                            "input)")
    cr.add_argument("-o", "--output", required=True)
    cr.add_argument("--truth", default=None)
    cr.add_argument("-n", "--num-reads", type=int, default=1000)
    cr.add_argument("-l", "--read-length", type=int, default=150)
    cr.add_argument("--min-depth", type=int, default=1)
    cr.add_argument("--max-depth", type=int, default=10)
    cr.add_argument("--depth-mean", type=float, default=5.0)
    cr.add_argument("--depth-stddev", type=float, default=2.0)
    cr.add_argument("--error-rate-mean", type=float, default=0.01)
    cr.add_argument("--no-per-base-tags", action="store_true")
    cr.add_argument("--seed", type=int, default=42)
    cr.set_defaults(func=cmd_simulate_consensus)
    co = ps.add_parser("correct-reads",
                       help="unmapped BAM + UMI includelist (correct input)")
    co.add_argument("-o", "--output", required=True)
    co.add_argument("-i", "--includelist", required=True,
                    help="includelist file to write")
    co.add_argument("--truth", default=None)
    co.add_argument("-n", "--num-reads", type=int, default=10000)
    co.add_argument("--num-umis", type=int, default=1000)
    co.add_argument("-u", "--umi-length", type=int, default=8)
    co.add_argument("-l", "--read-length", type=int, default=100)
    co.add_argument("--max-errors", type=int, default=2)
    co.add_argument("--seed", type=int, default=42)
    co.set_defaults(func=cmd_simulate_correct)


def cmd_simulate_consensus(args, argv):
    from .simulate import simulate_consensus_bam

    n = simulate_consensus_bam(
        args.output, truth_path=args.truth, num_reads=args.num_reads,
        read_length=args.read_length, min_depth=args.min_depth,
        max_depth=args.max_depth, depth_mean=args.depth_mean,
        depth_stddev=args.depth_stddev, error_rate_mean=args.error_rate_mean,
        per_base_tags=not args.no_per_base_tags, seed=args.seed)
    log.info("simulate: wrote %d consensus records to %s", n, args.output)
    return 0


def cmd_simulate_correct(args, argv):
    from .simulate import simulate_correct_reads

    n = simulate_correct_reads(
        args.output, args.includelist, truth_path=args.truth,
        num_reads=args.num_reads, num_umis=args.num_umis,
        umi_length=args.umi_length, read_length=args.read_length,
        max_errors=args.max_errors, seed=args.seed)
    log.info("simulate: wrote %d reads to %s (includelist %s)", n,
             args.output, args.includelist)
    return 0


def cmd_simulate_grouped(args, argv):
    from .simulate import simulate_grouped_bam

    n = simulate_grouped_bam(
        args.output, num_families=args.num_families,
        family_size=args.family_size,
        family_size_distribution=args.family_size_distribution,
        read_length=args.read_length, error_rate=args.error_rate,
        base_quality=args.base_quality, paired=not args.single_end,
        read_length_jitter=args.read_length_jitter,
        qual_slope=args.qual_slope,
        insert_size_mean=args.insert_size_mean,
        insert_size_sd=args.insert_size_sd, seed=args.seed)
    log.info("simulate: wrote %d records to %s", n, args.output)
    return 0


def cmd_simulate_duplex(args, argv):
    from .simulate import simulate_duplex_bam

    if args.strand_bias_beta is not None and args.strand_bias_alpha is None:
        log.error("--strand-bias-beta requires --strand-bias-alpha")
        return 2
    for name, v in (("--strand-bias-alpha", args.strand_bias_alpha),
                    ("--strand-bias-beta", args.strand_bias_beta)):
        if v is not None and v <= 0:
            log.error("%s must be > 0 (Beta distribution parameter)", name)
            return 2
    n = simulate_duplex_bam(
        args.output, num_molecules=args.num_molecules,
        reads_per_strand=args.reads_per_strand, read_length=args.read_length,
        error_rate=args.error_rate, base_quality=args.base_quality,
        ba_fraction=args.ba_fraction, seed=args.seed,
        strand_bias_alpha=args.strand_bias_alpha,
        strand_bias_beta=args.strand_bias_beta)
    log.info("simulate: wrote %d records to %s", n, args.output)
    return 0


def cmd_simulate_codec(args, argv):
    from .simulate import simulate_codec_bam

    n = simulate_codec_bam(
        args.output, num_molecules=args.num_molecules,
        pairs_per_molecule=args.pairs_per_molecule,
        read_length=args.read_length, error_rate=args.error_rate,
        base_quality=args.base_quality,
        overlap_fraction=args.overlap_fraction, seed=args.seed)
    log.info("simulate: wrote %d records to %s", n, args.output)
    return 0


def cmd_simulate_mapped(args, argv):
    from .simulate import simulate_mapped_bam

    n = simulate_mapped_bam(
        args.output, num_families=args.num_families,
        family_size=args.family_size, read_length=args.read_length,
        umi_length=args.umi_length, umi_error_rate=args.umi_error_rate,
        paired_umis=args.paired_umis, seed=args.seed)
    log.info("simulate: wrote %d records to %s", n, args.output)
    return 0


def cmd_simulate_fastq(args, argv):
    from .simulate import simulate_fastq_reads

    n = simulate_fastq_reads(
        args.r1, args.r2, truth_path=args.truth,
        num_families=args.num_families, family_size=args.family_size,
        family_size_distribution=args.family_size_distribution,
        read_length=args.read_length, umi_length=args.umi_length,
        error_rate=args.error_rate, base_quality=args.base_quality,
        duplex=args.duplex, includelist=args.includelist, seed=args.seed)
    log.info("simulate: wrote %d read pairs to %s / %s", n, args.r1, args.r2)
    return 0


def _add_trace_merge(sub):
    p = sub.add_parser(
        "trace-merge",
        help="Stitch several --trace files into one Perfetto timeline, "
             "clock-aligned on each file's wall-clock anchor")
    p.add_argument("traces", nargs="+", metavar="TRACE.json",
                   help="Chrome trace-event files to merge (each process's "
                        "--trace output)")
    p.add_argument("-o", "--output", required=True, metavar="PATH",
                   help="merged trace file to write")
    p.add_argument("--trace-id", default=None, metavar="HEX32",
                   help="keep only inputs stamped with this trace id; the "
                        "others are skipped (recorded under "
                        "otherData.skipped)")
    p.add_argument("--shift", action="append", default=None,
                   metavar="FILE=SECONDS", dest="shifts",
                   help="add SECONDS to FILE's timeline on top of the "
                        "anchor alignment (FILE matches the path or its "
                        "basename; repeat per file)")
    p.add_argument("--force", action="store_true",
                   help="merge even when the inputs carry different trace "
                        "ids (default: that is an error)")
    p.set_defaults(func=cmd_trace_merge)


def cmd_trace_merge(args, argv):
    from .observe.trace_merge import (MergeError, merge_traces,
                                      parse_shift_specs, write_merged)

    try:
        shifts = parse_shift_specs(args.shifts)
        merged = merge_traces(args.traces, trace_id=args.trace_id,
                              shifts=shifts, force=args.force)
        write_merged(merged, args.output)
    except MergeError as e:
        log.error("trace-merge: %s", e)
        return 2
    except OSError as e:
        log.error("trace-merge: cannot write %s: %s", args.output, e)
        return 2
    for skipped in merged["otherData"].get("skipped") or []:
        log.info("trace-merge: skipped %s (trace id %s)", skipped["path"],
                 skipped.get("trace_id"))
    log.info("trace-merge: merged %d file(s), %d event(s) -> %s",
             len(merged["otherData"]["merged_from"]),
             len(merged["traceEvents"]), args.output)
    return 0


def _add_tune(sub):
    p = sub.add_parser(
        "tune",
        help="Measure this host's device/host crossovers on a simulated "
             "workload matrix and write a deployment profile (tuned knobs "
             "+ measured router/chooser priors, loaded with "
             "--profile/FGUMI_TPU_PROFILE) plus a crossover atlas")
    p.add_argument("-o", "--output", default="deploy_profile.json",
                   metavar="PATH", help="deployment profile to write")
    p.add_argument("--atlas", default="TUNE_ATLAS.json", metavar="PATH",
                   help="crossover atlas to write ('' disables)")
    p.add_argument("--quick", action="store_true",
                   help="CI-sized sweep: the three fixed-depth crossover "
                        "cells only, small pileups (seconds, not minutes)")
    p.add_argument("--replay", action="append", default=None,
                   metavar="JSON", dest="replay",
                   help="derive the profile from recorded evidence instead "
                        "of sweeping: run-report JSONs (device.routing "
                        "EWMAs) and/or microbench JSONs (tune_cells); "
                        "repeat per file")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="the device side of the sweep: cuda (the wire "
                        "kernel K1 and the combine K8; exits 2 without "
                        "CUDA) or cpu (their plain PyTorch versions)")
    p.set_defaults(func=cmd_tune)


def cmd_tune(args, argv):
    from .ops import tune_combine
    from .ops.kernel import DEVICE_STATS
    from .tune.autotune import run_autotune
    from .tune.profile import ProfileError

    if _no_cuda("tune", args.device):
        return 2
    extra = {"tune_combine": (tune_combine, "TUNE_COMBINE_LAUNCHES")}
    counters0 = _kernel_counters(extra)
    try:
        rc = run_autotune(args.output, args.atlas or None, quick=args.quick,
                          replay_paths=args.replay, device=args.device)
    except ProfileError as e:
        log.error("%s", e)
        return 2
    if not args.replay:
        counters = _kernel_counters(extra)
        launched = {k: counters[k] - counters0[k]
                    for k in ("consensus_wire_full", "consensus_wire_packed2",
                              "tune_combine")}
        log.info("tune: %d wire dispatches on %s; launches %s",
                 DEVICE_STATS.snapshot()["dispatches"], args.device,
                 ", ".join(f"{k} {v}" for k, v in launched.items()))
    return rc


# ---------------------------------------------------------------- serving

def _add_serve(sub):
    p = sub.add_parser(
        "serve",
        help="Run the persistent job-service daemon (warm-kernel serving)")
    p.add_argument("--socket", default=None, metavar="PATH",
                   help="Unix-domain socket path to listen on (relative "
                        "job paths resolve against the daemon's working "
                        "directory). At least one of --socket/--tcp is "
                        "required")
    p.add_argument("--tcp", default=None, metavar="HOST:PORT",
                   help="additionally listen on TCP: per-connection "
                        "read/write deadlines (--io-timeout), a connection "
                        "cap (--conn-cap), and — for any non-loopback HOST "
                        "— a REQUIRED shared-secret handshake (--token-file "
                        "or FGUMI_TPU_SERVE_TOKEN; the wire protocol "
                        "executes submitted commands). Port 0 binds an "
                        "ephemeral port. A busy port exits 2 before the "
                        "device warm-up")
    p.add_argument("--token-file", default=None, metavar="PATH",
                   help="file holding the shared-secret handshake token "
                        "for TCP connections (surrounding whitespace "
                        "stripped; default: FGUMI_TPU_SERVE_TOKEN)")
    p.add_argument("--conn-cap", type=int, default=None, metavar="N",
                   help="max concurrent TCP connections; over-cap "
                        "connects are answered with one explicit error "
                        "frame and closed (default 64; 0 = unlimited)")
    p.add_argument("--io-timeout", type=float, default=None, metavar="S",
                   help="per-connection read/write deadline on TCP "
                        "connections (default 30; 0 = none)")
    p.add_argument("--workers", type=int, default=2,
                   help="concurrent job slots (bounded worker pool)")
    p.add_argument("--queue-limit", type=int, default=8,
                   help="queued jobs admitted beyond the running ones; "
                        "submissions past workers+queue-limit are rejected "
                        "with an explicit reason")
    p.add_argument("--max-per-client", type=int, default=0,
                   help="per-submitter admission quota: a `submit "
                        "--client ID` may hold at most this many active "
                        "(queued+running) jobs; over-quota submits are "
                        "rejected with an explicit reason (0 = unlimited; "
                        "anonymous submits are never limited)")
    p.add_argument("--report-dir", default=None, metavar="DIR",
                   help="write per-job run reports (<job>.report.json) and "
                        "on-request traces here (created if missing)")
    p.add_argument("--max-frame-bytes", type=int, default=None,
                   help="protocol frame size cap (default 1 MiB); larger "
                        "frames are rejected and the connection closed")
    p.add_argument("--no-warmup", action="store_true",
                   help="skip the startup warm-up (torch's CUDA context "
                        "and every kernel library built and loaded): the "
                        "first job pays the cold start, and a job with "
                        "--device cuda on a host without CUDA fails as it "
                        "does standalone")
    p.add_argument("--journal", default=None, metavar="PATH",
                   help="append-only job journal (JSONL WAL): submits and "
                        "state transitions are fsync'd here, and on "
                        "restart incomplete jobs are requeued in order. "
                        "Unset = in-memory only")
    p.add_argument("--journal-dir", default=None, metavar="DIR",
                   help="FLEET journaling: journal at DIR/<fleet-id>."
                        "journal with an fcntl lease held for the "
                        "daemon's lifetime. Daemons sharing DIR (one real "
                        "filesystem) take over a dead peer's journal "
                        "exactly once and requeue its incomplete jobs "
                        "under their original ids (daemons of the JAX "
                        "package too). Exclusive with --journal")
    p.add_argument("--fleet-id", default=None, metavar="NAME",
                   help="this daemon's identity in --journal-dir "
                        "([A-Za-z0-9._-], <=64 chars; job ids become "
                        "<fleet-id>-j-<n> so they are fleet-unique). "
                        "Default: derived from the socket basename or "
                        "the TCP port")
    p.add_argument("--lease-scan-period", type=float, default=2.0,
                   metavar="S",
                   help="how often the fleet lease scanner probes peer "
                        "journals for takeover (0 = never scan; the "
                        "daemon still recovers its own journal)")
    p.add_argument("--health-period", type=float, default=None,
                   metavar="S",
                   help="run a tiny device canary (kernel K7) every S "
                        "seconds feeding the device circuit breaker "
                        "(default: FGUMI_TPU_HEALTH_PERIOD_S, else off)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve Prometheus text-format /metrics and a "
                        "/healthz liveness endpoint on this loopback HTTP "
                        "port (0 = an ephemeral port, logged at startup; "
                        "unset = no listener). The scrape and the `stats` "
                        "protocol op read the same live snapshot")
    p.add_argument("--coalesce-window-ms", type=float, default=None,
                   metavar="MS",
                   help="cross-job dispatch coalescing window: while >= 2 "
                        "jobs are running, compatible device batches from "
                        "different jobs are held up to this long and "
                        "merged into one launch, split back per job at "
                        "resolve (byte-identical per job). 0 disables; "
                        "default: FGUMI_TPU_COALESCE_WINDOW_MS; unset "
                        "(and FGUMI_TPU_COALESCE unset), coalescing is "
                        "off")
    g = p.add_argument_group("JAX-only",
                             "reference options this port refuses (exit 2)")
    g.add_argument("--compile-cache", default=None, metavar="DIR",
                   help="persistent XLA compile cache (JAX-only)")
    p.set_defaults(func=cmd_serve)


def _serve_refusal(args):
    """The line refusing a ``serve`` option of a part the port lacks, or
    None: the XLA cache."""
    if args.compile_cache is not None:
        return ("--compile-cache: JAX-only (the persistent XLA compile "
                "cache; the port compiles its kernels once into _build/)")
    return None


def _default_fleet_id(args):
    """A stable default identity in --journal-dir: the socket basename
    (without extension) or the TCP port. Good enough for one-host fleets;
    multi-host fleets should pass --fleet-id explicitly. Returns None
    when no stable default exists (ephemeral --tcp port 0: every such
    daemon would collide on the same lease)."""
    import re

    if args.socket:
        base = os.path.basename(args.socket)
        base = base[:-5] if base.endswith(".sock") else base
        base = re.sub(r"[^A-Za-z0-9._-]", "-", base).strip("-.")
        if base:
            return base[:64]
    if args.tcp:
        port = args.tcp.rsplit(":", 1)[-1]
        if port != "0":
            return "tcp-" + port
    return None


def cmd_serve(args, argv):
    import signal

    from .ops.breaker import monitor_period_s
    from .serve import protocol as _proto
    from .serve import transport as transport_mod
    from .serve.daemon import JobService, SocketBusy
    from .serve.journal import LeaseHeld

    line = _serve_refusal(args)
    if line is not None:
        log.error("%s", line)
        return 2
    if not args.socket and not args.tcp:
        log.error("serve needs --socket and/or --tcp")
        return 2
    if args.workers < 1:
        log.error("--workers must be >= 1")
        return 2
    if args.queue_limit < 0:
        log.error("--queue-limit must be >= 0")
        return 2
    if args.max_per_client < 0:
        log.error("--max-per-client must be >= 0")
        return 2
    if args.max_frame_bytes is not None and args.max_frame_bytes < 1024:
        # a sub-1KiB cap cannot carry a realistic submit frame, and 0 or a
        # negative value would defeat the size limit entirely
        log.error("--max-frame-bytes must be >= 1024")
        return 2
    if args.metrics_port is not None \
            and not 0 <= args.metrics_port <= 65535:
        log.error("--metrics-port must be in 0..65535")
        return 2
    if args.journal and args.journal_dir:
        log.error("--journal and --journal-dir are exclusive")
        return 2
    if args.conn_cap is not None and args.conn_cap < 0:
        log.error("--conn-cap must be >= 0 (0 = unlimited)")
        return 2
    if args.coalesce_window_ms is not None:
        if args.coalesce_window_ms < 0:
            log.error("--coalesce-window-ms must be >= 0 (0 = off)")
            return 2
        # the coalescer reads the variable at each dispatch: the flag is
        # the daemon's spelling of FGUMI_TPU_COALESCE_WINDOW_MS
        os.environ["FGUMI_TPU_COALESCE_WINDOW_MS"] = \
            str(args.coalesce_window_ms)
    if args.report_dir:
        try:
            os.makedirs(args.report_dir, exist_ok=True)
        except OSError as e:
            log.error("cannot create --report-dir %s: %s", args.report_dir, e)
            return 2
    tcp = None
    if args.tcp:
        try:
            _, tcp = transport_mod.parse_address("tcp:" + args.tcp)
        except ValueError as e:
            log.error("--tcp: %s", e)
            return 2
    try:
        token = transport_mod.load_token(args.token_file)
    except (OSError, ValueError) as e:
        log.error("--token-file: %s", e)
        return 2
    health = args.health_period if args.health_period is not None \
        else monitor_period_s()
    if health < 0:
        log.error("--health-period must be >= 0")
        return 2
    fleet_id = None
    if args.journal_dir:
        fleet_id = args.fleet_id or _default_fleet_id(args)
        if fleet_id is None:
            log.error("--journal-dir with an ephemeral --tcp port has no "
                      "stable default identity; pass --fleet-id")
            return 2
    try:
        service = JobService(
            args.socket, workers=args.workers, queue_limit=args.queue_limit,
            report_dir=args.report_dir,
            max_frame_bytes=args.max_frame_bytes or _proto.MAX_FRAME_BYTES,
            journal_path=args.journal, health_period_s=health,
            max_per_client=args.max_per_client,
            metrics_port=args.metrics_port, tcp=tcp, auth_token=token,
            conn_cap=(args.conn_cap if args.conn_cap is not None
                      else transport_mod.DEFAULT_CONN_CAP),
            io_timeout_s=(args.io_timeout if args.io_timeout is not None
                          else transport_mod.DEFAULT_IO_TIMEOUT_S),
            journal_dir=args.journal_dir, fleet_id=fleet_id,
            lease_scan_period_s=args.lease_scan_period)
    except ValueError as e:
        log.error("%s", e)
        return 2
    # claim the listeners (and the fleet lease) BEFORE the device warm-up:
    # an accidental duplicate start must fail fast without touching the
    # card
    try:
        service.bind()
        service.acquire_lease()
    except (SocketBusy, LeaseHeld) as e:
        log.error("%s", e)
        service.close()
        return 2
    except ValueError as e:
        # a refused listener configuration (non-loopback TCP without a
        # handshake token)
        log.error("%s", e)
        service.close()
        return 2
    except OSError as e:
        if service._unix is not None and service._unix.sock is None:
            log.error("cannot bind %s: %s", args.socket, e)
        elif args.tcp and (service._tcp_listener is None
                           or service._tcp_listener.sock is None):
            log.error("cannot bind tcp %s: %s", args.tcp, e)
        else:
            log.error("cannot bind metrics port %s: %s",
                      args.metrics_port, e)
        service.close()
        return 2
    if not args.no_warmup:
        try:
            service.warm_up()
        except Exception as e:  # noqa: BLE001 - one line, then exit 2
            log.error("serve: warm-up failed: %s: %s", type(e).__name__,
                      str(e).strip().splitlines()[0] if str(e).strip()
                      else "")
            service.close()
            return 2
    service.start()

    def _on_signal(signum, frame):
        # SIGTERM drain contract: stop admitting, finish queued + running.
        # Event-set only — no locks or logging in signal context; the main
        # loop below performs (and logs) the actual drain
        service.request_shutdown()

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass  # not the main thread (in-process test harness)
    try:
        service.wait_until_shutdown()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        service.close()
    return 0


def _add_submit(sub):
    p = sub.add_parser(
        "submit",
        help="Submit a command to a running serve daemon (warm execution)")
    p.add_argument("--socket", required=True, metavar="ADDR",
                   help="daemon address: a Unix socket path (serve "
                        "--socket), unix:PATH, or tcp:HOST:PORT (serve "
                        "--tcp / a balance front end)")
    p.add_argument("--token-file", default=None, metavar="PATH",
                   help="shared-secret handshake token for TCP daemons "
                        "(default: FGUMI_TPU_SERVE_TOKEN)")
    p.add_argument("--priority", default="normal",
                   choices=["high", "normal", "low"],
                   help="scheduling class (FIFO within a class)")
    p.add_argument("--tag", default=None,
                   help="free-form label kept on the job record")
    p.add_argument("--job-trace", action="store_true",
                   help="ask the daemon for a per-job Perfetto trace next "
                        "to the job's run report (needs serve --report-dir)")
    p.add_argument("--dedupe", default=None, metavar="KEY",
                   help="idempotency key: resubmitting the same key "
                        "returns the original job (even across a daemon "
                        "restart with serve --journal) instead of running "
                        "it twice")
    p.add_argument("--client", default=None, metavar="ID",
                   help="submitter identity for the daemon's per-client "
                        "admission quota (serve --max-per-client); "
                        "omitted = anonymous, never quota-limited")
    p.add_argument("--no-wait", action="store_true",
                   help="return immediately after admission (poll later "
                        "with `jobs`)")
    p.add_argument("--timeout", type=float, default=None,
                   help="max seconds to wait for completion (with waiting)")
    p.add_argument("job_argv", nargs=argparse.REMAINDER, metavar="COMMAND",
                   help="the command to run, e.g. `submit --socket S "
                        "simplex -i in.bam -o out.bam` (everything after "
                        "the submit options, verbatim)")
    p.set_defaults(func=cmd_submit)


def _submit_with_shed_retry(client, submit_kwargs: dict, wait: bool,
                            timeout: float = None, sleep=time.sleep):
    """Submit, honoring the governor's resource-pressure hint.

    A shed (``resource_pressure`` with ``retry_after_s``) is not a
    failure when the caller intends to wait: sleep EXACTLY the daemon's
    hint and resubmit instead of hot-looping or giving up, bounded by
    the overall ``timeout``. Raises the final ShedError when not waiting
    or out of time. ``sleep`` is injectable for tests."""
    from .serve.client import ShedError

    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        try:
            return client.submit(**submit_kwargs)
        except ShedError as e:
            if not wait:
                raise
            hint = max(float(e.retry_after_s), 0.05)
            if deadline is not None:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise
                hint = min(hint, remaining)
            log.info("submit: daemon shedding under resource pressure; "
                     "retrying in %.1fs (%s)", hint, e)
            sleep(hint)


def _serve_client(args, label: str):
    """(client, rc) for the serve-client verbs: resolves the handshake
    token and the address; a config problem logs one line and returns
    (None, 2)."""
    from .serve import transport as transport_mod
    from .serve.client import ServeClient

    try:
        token = transport_mod.load_token(args.token_file)
        return ServeClient(args.socket, token=token), 0
    except (OSError, ValueError) as e:
        log.error("%s: %s", label, e)
        return None, 2


def cmd_submit(args, argv):
    from .serve.client import ServeError

    job_argv = list(args.job_argv)
    if job_argv and job_argv[0] == "--":
        job_argv = job_argv[1:]
    if not job_argv:
        log.error("submit: no command given (usage: %s submit --socket S "
                  "<command> [args...])", PROGRAM_ID)
        return 2
    client, rc = _serve_client(args, "submit")
    if client is None:
        return rc
    # ONE wall-clock budget for the whole command: shed-retry sleeps and
    # the completion wait share it, so --timeout 60 means 60, not 120
    deadline = None if args.timeout is None \
        else time.monotonic() + args.timeout
    try:
        job = _submit_with_shed_retry(
            client,
            dict(argv=job_argv, priority=args.priority, argv0=PROGRAM_ID,
                 tag=args.tag, trace=args.job_trace, dedupe=args.dedupe,
                 client=args.client),
            wait=not args.no_wait, timeout=args.timeout)
    except ServeError as e:
        log.error("submit: %s", e)
        return 2
    log.info("submitted %s (%s): %s", job["id"], job["state"],
             " ".join(job["argv"]))
    if args.no_wait:
        print(job["id"])
        return 0
    try:
        job = client.wait(
            job["id"],
            timeout=None if deadline is None
            else max(deadline - time.monotonic(), 0.0))
    except ServeError as e:
        log.error("submit: %s", e)
        return 2
    rc = job["exit_status"]
    if job["state"] == "done":
        log.info("job %s done in %.2fs", job["id"],
                 job["finished_unix"] - job["started_unix"])
        return 0
    if job["state"] == "cancelled":
        log.error("job %s was cancelled", job["id"])
        return 130
    log.error("job %s failed: %s", job["id"], job["error"])
    return rc if isinstance(rc, int) and rc else 1


def _add_stats_command(sub):
    p = sub.add_parser(
        "stats",
        help="Print a running serve daemon's live introspection snapshot "
             "(scheduler/quota/journal/breaker/governor/device/monitor "
             "state + latency histogram summaries) as JSON")
    p.add_argument("--socket", required=True, metavar="ADDR",
                   help="daemon address: a Unix socket path, unix:PATH, "
                        "or tcp:HOST:PORT")
    p.add_argument("--token-file", default=None, metavar="PATH",
                   help="shared-secret handshake token for TCP daemons "
                        "(default: FGUMI_TPU_SERVE_TOKEN)")
    p.add_argument("--section", default=None, metavar="KEY",
                   help="print only one top-level section of the snapshot "
                        "(e.g. latency, scheduler, breaker)")
    p.set_defaults(func=cmd_stats)


def cmd_stats(args, argv):
    from .serve.client import ServeError

    client, rc = _serve_client(args, "stats")
    if client is None:
        return rc
    try:
        stats = client.stats()
    except ServeError as e:
        # includes an old daemon's rejection ("unknown op 'stats' ...")
        # verbatim — the version-negotiation contract
        log.error("stats: %s", e)
        return 2
    if args.section is not None:
        if args.section not in stats:
            log.error("stats: no section %r (have: %s)", args.section,
                      ", ".join(sorted(stats)))
            return 2
        stats = {args.section: stats[args.section]}
    print(json.dumps(stats, indent=1, sort_keys=True))
    return 0


def _add_balance(sub):
    p = sub.add_parser(
        "balance",
        help="Run the fleet balancer: a health-routed front end over N "
             "serve daemons speaking the same wire protocol (host code: "
             "no CUDA context)")
    p.add_argument("--listen", required=True, metavar="ADDR",
                   help="front-end address: unix:PATH or tcp:HOST:PORT "
                        "(non-loopback TCP requires the handshake token, "
                        "like serve --tcp; port 0 = ephemeral)")
    p.add_argument("--backend", action="append", required=True,
                   metavar="ADDR", dest="backends",
                   help="one serve daemon address (repeat per backend): "
                        "unix:PATH or tcp:HOST:PORT")
    p.add_argument("--token-file", default=None, metavar="PATH",
                   help="shared-secret handshake token used BOTH for the "
                        "front listener and toward TCP backends — a fleet "
                        "shares one secret (default: "
                        "FGUMI_TPU_SERVE_TOKEN)")
    p.add_argument("--poll-period", type=float, default=1.0, metavar="S",
                   help="health/depth poll period: each backend's `stats` "
                        "op feeds queue-depth routing and the ejection "
                        "breaker")
    p.add_argument("--eject-failures", type=int, default=2, metavar="N",
                   help="consecutive probe/request failures that eject a "
                        "backend (closed -> open)")
    p.add_argument("--cooldown", type=float, default=5.0, metavar="S",
                   help="ejection cooldown before the half-open re-probe "
                        "(doubles per consecutive re-trip, capped 8x)")
    p.add_argument("--probes", type=int, default=2, metavar="N",
                   help="consecutive half-open probe successes that "
                        "re-admit a backend")
    p.add_argument("--conn-cap", type=int, default=None, metavar="N",
                   help="max concurrent front-end TCP connections "
                        "(default 64)")
    p.add_argument("--io-timeout", type=float, default=None, metavar="S",
                   help="per-connection read/write deadline on front-end "
                        "TCP connections (default 30; 0 = none)")
    p.add_argument("--backend-timeout", type=float, default=30.0,
                   metavar="S",
                   help="per-request timeout toward a backend")
    p.add_argument("--max-frame-bytes", type=int, default=None,
                   help="protocol frame size cap (default 1 MiB)")
    p.add_argument("--metrics-port", type=int, default=None, metavar="PORT",
                   help="serve the fleet Prometheus /metrics endpoint (+ a "
                        "/healthz that goes 503 when no backend is "
                        "routable) on this loopback HTTP port: fleet "
                        "rollups plus every backend's cached series "
                        "re-exported with a backend=\"ADDR\" label, from "
                        "the same health-poll snapshot the `stats` op "
                        "reports (0 = ephemeral; unset = no listener)")
    g = p.add_argument_group("whale scatter/gather")
    g.add_argument("--scatter", type=int, default=0, metavar="N",
                   help="split every submitted pipeline/simplex/duplex "
                        "job into N dedupe-keyed shard sub-jobs fanned "
                        "out across the backends, then k-way merge the "
                        "shard outputs into ONE BAM byte-identical to a "
                        "single-backend run (N >= 2; 0 = off; requires a "
                        "filesystem shared with the backends)")
    g.add_argument("--scatter-axis", default="umi",
                   choices=("umi", "coord"),
                   help="content-hash axis for the family split: the "
                        "UMI's MI value, or the template coordinate "
                        "(default umi; both are explicit hashes — "
                        "deterministic across hosts and Python hash "
                        "seeds)")
    g.add_argument("--scatter-wal", default=None, metavar="PATH",
                   help="fsync'd JSONL write-ahead log of whale/shard "
                        "state: a restarted balancer resumes in-flight "
                        "whales from it, resubmitting shards under their "
                        "idempotent dedupe keys (unset = whales do not "
                        "survive a balancer restart)")
    g.add_argument("--scatter-grace", type=float, default=20.0,
                   metavar="S",
                   help="how long a shard job may stay unknown "
                        "fleet-wide before the coordinator requeues it "
                        "under an attempt-suffixed dedupe key — keep "
                        "this LONGER than the daemons' lease-scan "
                        "period so a journal takeover wins the race "
                        "(default 20)")
    p.set_defaults(func=cmd_balance)


def cmd_balance(args, argv):
    import signal

    from .serve import protocol as _proto
    from .serve import transport as transport_mod
    from .serve.balancer import Balancer
    from .serve.daemon import SocketBusy

    if args.poll_period <= 0:
        log.error("--poll-period must be > 0")
        return 2
    if args.eject_failures < 1 or args.probes < 1:
        log.error("--eject-failures and --probes must be >= 1")
        return 2
    if args.max_frame_bytes is not None and args.max_frame_bytes < 1024:
        log.error("--max-frame-bytes must be >= 1024")
        return 2
    if args.metrics_port is not None \
            and not 0 <= args.metrics_port <= 65535:
        log.error("--metrics-port must be in 0..65535")
        return 2
    if args.scatter and args.scatter < 2:
        log.error("--scatter needs at least 2 shards (0 disables it)")
        return 2
    if args.scatter_grace <= 0:
        log.error("--scatter-grace must be > 0")
        return 2
    try:
        token = transport_mod.load_token(args.token_file)
        for addr in [args.listen] + args.backends:
            transport_mod.parse_address(addr)
        balancer = Balancer(
            args.listen, args.backends, token=token, backend_token=token,
            max_frame_bytes=args.max_frame_bytes or _proto.MAX_FRAME_BYTES,
            poll_period_s=args.poll_period,
            eject_failures=args.eject_failures, cooldown_s=args.cooldown,
            probe_successes=args.probes,
            conn_cap=(args.conn_cap if args.conn_cap is not None
                      else transport_mod.DEFAULT_CONN_CAP),
            io_timeout_s=(args.io_timeout if args.io_timeout is not None
                          else transport_mod.DEFAULT_IO_TIMEOUT_S),
            backend_timeout_s=args.backend_timeout,
            metrics_port=args.metrics_port,
            scatter_shards=args.scatter, scatter_axis=args.scatter_axis,
            scatter_wal=args.scatter_wal,
            scatter_grace_s=args.scatter_grace)
    except (OSError, ValueError) as e:
        log.error("balance: %s", e)
        return 2
    try:
        balancer.bind()
    except SocketBusy as e:
        log.error("%s", e)
        return 2
    except OSError as e:
        log.error("cannot bind %s: %s", args.listen, e)
        return 2
    balancer.start()

    def _on_signal(signum, frame):
        # SIGTERM drain contract: event-set only; the main loop below
        # does the drain (and its logging) outside signal context
        balancer.request_shutdown()

    old = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old[sig] = signal.signal(sig, _on_signal)
        except (ValueError, OSError):
            pass  # not the main thread (in-process test harness)
    try:
        balancer.wait_until_shutdown()
    finally:
        for sig, handler in old.items():
            signal.signal(sig, handler)
        balancer.close()
    return 0


def _add_jobs(sub):
    p = sub.add_parser(
        "jobs", help="Inspect or manage a serve daemon's job queue")
    p.add_argument("--socket", required=True, metavar="ADDR",
                   help="daemon address: a Unix socket path, unix:PATH, "
                        "or tcp:HOST:PORT")
    p.add_argument("--token-file", default=None, metavar="PATH",
                   help="shared-secret handshake token for TCP daemons "
                        "(default: FGUMI_TPU_SERVE_TOKEN)")
    g = p.add_mutually_exclusive_group()
    g.add_argument("--id", default=None, help="show one job as JSON")
    g.add_argument("--cancel", default=None, metavar="ID",
                   help="cancel a queued job")
    g.add_argument("--drain", action="store_true",
                   help="close admission (running/queued jobs finish; the "
                        "daemon keeps answering status)")
    g.add_argument("--shutdown", action="store_true",
                   help="drain, finish queued+running jobs, then exit")
    g.add_argument("--ping", action="store_true",
                   help="print daemon liveness/config as JSON")
    g.add_argument("--scatter", nargs="?", const="", default=None,
                   metavar="WHALE_ID",
                   help="print a `balance --scatter` front end's whale "
                        "scatter section as JSON (with WHALE_ID: that "
                        "whale's per-shard states); a daemon answers its "
                        "documented refusal")
    p.set_defaults(func=cmd_jobs)


def cmd_jobs(args, argv):
    from .serve.client import ServeError

    client, rc = _serve_client(args, "jobs")
    if client is None:
        return rc
    try:
        if args.ping:
            print(json.dumps(client.ping(), indent=1, sort_keys=True))
            return 0
        if args.scatter is not None:
            sc = client.scatter(args.scatter or None)
            print(json.dumps(sc, indent=1, sort_keys=True))
            return 0
        if args.id:
            print(json.dumps(client.job(args.id), indent=1, sort_keys=True))
            return 0
        if args.cancel:
            job = client.cancel(args.cancel)
            log.info("job %s cancelled", job["id"])
            return 0
        if args.drain:
            depth = client.drain()
            if "running" in depth:
                log.info("draining: %d running, %d queued",
                         depth["running"], depth["queued"])
            else:  # a balance front answers with its own (depthless) ack
                log.info("draining: balancer admission closed")
            return 0
        if args.shutdown:
            depth = client.shutdown()
            if "running" in depth:
                log.info("shutdown requested: %d running, %d queued to "
                         "finish", depth["running"], depth["queued"])
            else:
                log.info("shutdown requested: balancer draining and "
                         "exiting")
            return 0
        status = client.status()
        jobs = status["jobs"]
        if not jobs:
            print("no jobs")
            return 0
        print(f"{'id':<8} {'state':<10} {'prio':<7} {'rc':<4} command")
        for j in jobs:
            rc = "" if j["exit_status"] is None else str(j["exit_status"])
            print(f"{j['id']:<8} {j['state']:<10} {j['priority']:<7} "
                  f"{rc:<4} {' '.join(j['argv'])}")
        return 0
    except ServeError as e:
        log.error("jobs: %s", e)
        return 2


def _add_global_options(parser):
    """The reference's global options (fgumi_tpu/cli.py build_parser)."""
    parser.add_argument("-v", "--verbose", action="store_true",
                        help="alias for --log-level debug (an explicit "
                             "--log-level wins)")
    parser.add_argument(
        "--log-level", choices=["debug", "info", "warning", "error"],
        default=None,
        help="log verbosity (also FGUMI_TPU_LOG; default info); every line "
             "carries the elapsed time and the emitting thread's name")
    parser.add_argument(
        "--no-atomic-output", action="store_true",
        help="write outputs directly to their final names instead of a "
             "temporary file renamed on success (for FIFO outputs; also "
             "FGUMI_TPU_NO_ATOMIC=1)")
    parser.add_argument(
        "--audit-output", action="store_true",
        help="verify every written BAM end to end (each BGZF member's "
             "CRC32/ISIZE, the BAM structure, the record count and a digest "
             "of the records against the writer's own tallies) before the "
             "rename publishes it; a mismatch exits 5 and publishes nothing "
             "(also FGUMI_TPU_AUDIT_OUTPUT=1)")
    parser.add_argument(
        "--trace", default=None, metavar="PATH",
        help="record pipeline, I/O and device spans and write a Chrome "
             "trace-event JSON that Perfetto opens (also FGUMI_TPU_TRACE)")
    parser.add_argument(
        "--run-report", default=None, metavar="PATH",
        help="write a schema-versioned JSON run report (wall time, "
             "per-stage busy/blocked, queue occupancy, device and I/O "
             "counters, latency histograms, exit status) at command end "
             "(also FGUMI_TPU_RUN_REPORT)")
    parser.add_argument(
        "--heartbeat", type=float, default=None, metavar="SECONDS",
        help="log a one-line progress heartbeat (stage counters, queue "
             "depths, device activity, records/s and ETA, RSS) every N "
             "seconds (also FGUMI_TPU_HEARTBEAT_S; 0 = off, the default)")
    parser.add_argument(
        "--flight-dump-dir", default=None, metavar="DIR",
        help="write flight-recorder black boxes (recent events, every "
             "thread's stack, metrics and device snapshots) here on an "
             "unhandled exception, resource exhaustion, a refuted output "
             "audit and SIGTERM (also FGUMI_TPU_FLIGHT)")
    parser.add_argument(
        "--profile", default=None, metavar="PATH",
        help="load a deployment profile (tune output) once a process: its "
             "knob values fill the FGUMI_TPU_* variables not explicitly set "
             "(explicit variables and flags win) and its measured priors "
             "seed the router and the strand-combine choosers (also "
             "FGUMI_TPU_PROFILE); a window it fills does not arm the "
             "opt-in coalescer, and a mesh other than 'off' exits 2")
    g = parser.add_argument_group(
        "not yet ported / JAX-only",
        "reference options this port refuses (exit 2)")
    g.add_argument("--mesh", default=None, metavar="dpNxspM",
                   help="device mesh (not yet ported)")
    g.add_argument("--xla-profile", default=None, metavar="DIR",
                   help="jax.profiler capture (JAX-only)")
    g.add_argument("--shape-buckets", default=None, metavar="GROWTH[:CAP]",
                   help="XLA shape-bucket ladder (JAX-only)")


#: global options refused with exit 2: (dest, flag, reason)
_GLOBAL_REFUSED = (
    ("mesh", "--mesh", "not yet ported (multi-GPU)"),
    ("xla_profile", "--xla-profile",
     "JAX-only (a jax.profiler capture); use --trace"),
    ("shape_buckets", "--shape-buckets",
     "JAX-only (PyTorch compiles nothing per shape)"),
)


def _env_refusal():
    """The line refusing an environment form of a refused global option,
    or None. ``FGUMI_TPU_MESH`` parses as the reference parses it
    (``parallel/mesh.parse_mesh_spec``): the values that build no mesh
    there run here, a value it rejects gets its knob line, and ``auto`` or
    a mesh shape is not yet ported (a line that names the deployment
    profile when the profile filled the variable); ``FGUMI_TPU_SP`` above 1
    asks for a read-axis split (any other value is sp = 1 on the reference
    too)."""
    from .parallel import MeshConfigError
    from .parallel.mesh import parse_mesh_spec
    from .tune import profile as _profile

    spec = os.environ.get("FGUMI_TPU_MESH")
    try:
        mesh = parse_mesh_spec(spec)
    except MeshConfigError as e:
        return str(e)
    if mesh is not None:
        source = ""
        applied = _profile.applied_info()
        if applied is not None and "mesh" in applied["applied"]:
            source = f" (from profile {applied['path']})"
        return f"FGUMI_TPU_MESH={spec}{source}: not yet ported (multi-GPU)"
    sp = os.environ.get("FGUMI_TPU_SP", "1")
    if sp.isdigit() and int(sp) > 1:
        return f"FGUMI_TPU_SP={sp}: not yet ported (multi-GPU)"
    return None


def _refuse_globals(args) -> int:
    """Exit 2 with one line for a refused global option, its environment
    form or a fault spec the port cannot fire, before any output is
    opened; else 0. ``FGUMI_TPU_XLA_PROFILE`` and
    ``FGUMI_TPU_SHAPE_BUCKETS`` tune JAX alone and are not read."""
    for dest, flag, reason in _GLOBAL_REFUSED:
        if getattr(args, dest, None) is not None:
            log.error("%s: %s", flag, reason)
            return 2
    line = _env_refusal()
    if line is not None:
        log.error("%s", line)
        return 2
    from .utils import faults

    spec = faults.unported_spec()
    if spec is not None:
        log.error("FGUMI_TPU_FAULT %s: not yet ported", spec)
        return 2
    return 0


def build_parser():
    parser = argparse.ArgumentParser(
        prog=PROGRAM_ID,
        description="UMI consensus calling on PyTorch and CUDA")
    _add_global_options(parser)
    sub = parser.add_subparsers(dest="command", required=True)
    _add_pipeline(sub)
    _add_extract(sub)
    _add_sort(sub)
    _add_simplex(sub)
    _add_duplex(sub)
    _add_codec(sub)
    _add_filter(sub)
    _add_group(sub)
    _add_dedup(sub)
    _add_correct(sub)
    _add_zipper(sub)
    _add_fastq(sub)
    _add_merge(sub)
    _add_clip(sub)
    _add_downsample(sub)
    _add_review(sub)
    _add_duplex_metrics(sub)
    _add_simplex_metrics(sub)
    _add_compare(sub)
    _add_simulate(sub)
    _add_trace_merge(sub)
    _add_tune(sub)
    _add_serve(sub)
    _add_submit(sub)
    _add_stats_command(sub)
    _add_jobs(sub)
    _add_balance(sub)
    return parser


def _run_command(args, argv, command_line=None):
    """Dispatch to the subcommand under the reference's exit-code contract:
    2 on a diagnosed input problem, 3 on an injected fault, 4 on resource
    exhaustion (device memory too) or a full disk, 5 on a refuted output
    audit, 1 on a broken pipe or a CUDA error in a dispatch and 130 on an
    interrupt, each with at most one line. The command records
    ``command_line`` in its outputs' provenance (@PG CL), by default the
    program and ``argv``; a scatter sub-job's ``--pg-argv`` (the whale's
    command line, shlex-quoted) takes precedence over both, as on the
    reference, so shard outputs carry the whale's provenance."""
    from .observe.flight import FLIGHT
    from .utils.faults import InjectedFault

    pg = getattr(args, "pg_argv", None)
    if pg:
        import shlex

        try:
            command_line = shlex.split(pg)
        except ValueError as e:
            log.error("--pg-argv: %s", e)
            return 2
    try:
        return args.func(args, command_line or [PROGRAM_ID] + argv)
    except (InputFormatError, EOFError) as e:
        # a diagnosed input problem (a truncated or corrupt stream, a torn
        # record): one line with the path and offset, not a traceback
        log.error("%s", e)
        return 2
    except InjectedFault as e:
        # chaos testing: an injected fault that reached the top is a clean
        # failure with an exit code of its own
        log.error("%s", e)
        return 3
    except OutputIntegrityError as e:
        # --audit-output refuted the written file: the rename was aborted,
        # nothing was published, and the black box keeps the evidence
        FLIGHT.dump("output-integrity", exc=e)
        log.error("%s", e)
        return 5
    except ResourceExhausted as e:
        # a hard resource limit (a full disk, an RSS or disk watermark):
        # the error paths already removed the partial outputs and spills
        FLIGHT.dump("resource-exhausted", exc=e)
        log.error("%s", e)
        return 4
    except RuntimeError as e:
        rc = _device_failure(e)
        if rc is None:
            raise
        return rc
    except BrokenPipeError:
        # stdout's reader went away (before the OSError clause: it is
        # one). Point stdout at /dev/null so the interpreter's flush of the
        # still-buffered stream at exit prints nothing
        try:
            null = os.open(os.devnull, os.O_WRONLY)
            os.dup2(null, sys.stdout.fileno())
            os.close(null)
        except OSError:
            pass
        return 1
    except OSError as e:
        if e.errno == errno.ENOSPC:
            GOVERNOR.record_event("enospc", where="unhandled")
            log.error("disk full: %s", e)
            return 4
        raise
    except KeyboardInterrupt:
        log.error("interrupted")
        return 130


def _device_failure(e):
    """The exit code of a device failure that reached the top, logged as
    one line, or None for any other error. The reference finishes such a
    batch on its host engine; the port has none, so the command fails and
    publishes nothing: 4 for device memory that the batch split could not
    get under (a real ``torch.cuda.OutOfMemoryError``; an injected one
    exits 3 as every injected fault does), 1 for a CUDA error in a
    dispatch or a fetch (``ops.kernel.DeviceFailure``) or anywhere else."""
    from .observe.flight import FLIGHT

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(e, torch.cuda.OutOfMemoryError):
        FLIGHT.dump("resource-exhausted", exc=e)
        lines = str(e).strip().splitlines()
        log.error("device memory exhausted: %s",
                  lines[0] if lines else "out of memory")
        return 4
    kernel = sys.modules.get(__package__ + ".ops.kernel")
    if kernel is not None and isinstance(e, kernel.DeadlineExceeded):
        # a dispatch abandoned at its deadline: 3 when an injected hang
        # caused it (as every injected fault), 1 for a real wedge
        FLIGHT.dump("unhandled-exception", exc=e)
        log.error("%s", e)
        return 3 if e.injected else 1
    if kernel is not None and isinstance(e, kernel.DeviceFailure):
        FLIGHT.dump("unhandled-exception", exc=e)
        log.error("%s", e)
        return 1
    if kernel is not None and kernel._is_cuda_error(e):
        # a CUDA error outside the consensus kernels' dispatches and
        # fetches (a launch is asynchronous: it surfaces at the next call
        # that waits on the card)
        FLIGHT.dump("unhandled-exception", exc=e)
        log.error("device error: %s: %s", type(e).__name__,
                  kernel._first_line(e))
        return 1
    return None


def _telemetry_config(args):
    """(trace path, report path, heartbeat seconds) from the options and
    the environment."""
    trace_path = args.trace or os.environ.get("FGUMI_TPU_TRACE") or None
    report_path = (args.run_report
                   or os.environ.get("FGUMI_TPU_RUN_REPORT") or None)
    hb_s = args.heartbeat
    if hb_s is None:
        try:
            hb_s = float(os.environ.get("FGUMI_TPU_HEARTBEAT_S", "0") or 0)
        except ValueError:
            log.warning("FGUMI_TPU_HEARTBEAT_S=%s: not a number; heartbeat "
                        "off", os.environ["FGUMI_TPU_HEARTBEAT_S"])
            hb_s = 0.0
    return trace_path, report_path, hb_s


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    from .io.bam import set_audit_output
    from .observe.logs import setup_logging
    from .utils.atomic import set_atomic_enabled

    # a nested stage of the staged pipeline keeps the outer level unless
    # it carries a level of its own
    depth = _MAIN_DEPTH.get()
    if depth == 0 or args.log_level or args.verbose:
        setup_logging(args.log_level, args.verbose)
    # set both ways: a previous in-process invocation's flag must not leak
    # into this one (the staged pipeline forwards them to its stages)
    set_atomic_enabled(not args.no_atomic_output)
    set_audit_output(bool(args.audit_output))
    # the deployment profile (--profile / FGUMI_TPU_PROFILE), at depth 0
    # before the telemetry scope and before the refusals, so that every
    # later read of the environment (the mesh refusal's too) sees the knobs
    # it fills; process-once (a daemon job re-entering main must not
    # re-apply or re-warn). A bad profile exits 2 like any knob error.
    rc = _apply_profile(args) if depth == 0 else 0
    rc = rc or _refuse_globals(args) or _apply_pipeline_compat(args)
    if rc:
        return rc
    if depth > 0:
        # a nested stage: the outer invocation owns the telemetry, and the
        # staged chain names the stage's provenance line (command_argv)
        from .observe.scope import command_line_override

        return _run_command(args, argv, command_line_override())
    # each top-level invocation gets its own telemetry scope (metrics,
    # DeviceStats, tracer), so in-process commands run one after another
    # or at once never mix counters; nested stages accumulate into it
    from .observe.scope import (adopt_job_context, publish_to_global,
                                scoped_telemetry)

    with scoped_telemetry(args.command) as scope:
        adopt_job_context(scope)
        try:
            return _main_scoped(args, argv)
        finally:
            # the finished command's counters stay readable on the global
            # METRICS and DEVICE_STATS after main returns
            publish_to_global(scope)


def _apply_profile(args) -> int:
    """Load and apply the deployment profile named by ``--profile`` or
    ``FGUMI_TPU_PROFILE`` (``tune/profile.maybe_apply_from_env``); 2 with
    its one line on a bad profile, else 0."""
    from .tune import profile as _profile

    try:
        _profile.maybe_apply_from_env(args.profile)
    except _profile.ProfileError as e:
        log.error("%s", e)
        return 2
    return 0


def _main_scoped(args, argv):
    """The outermost invocation's body: the telemetry lifecycle (flight
    recorder, trace, heartbeat, run report) around the dispatch."""
    from .observe.flight import FLIGHT, install_signal_dump
    from .observe.scope import command_line_override
    from .tune import profile as _profile

    trace_path, report_path, hb_s = _telemetry_config(args)
    # the process's resource governor: budget rebalancing and the memory
    # and disk watermarks (idempotent: one thread a process;
    # FGUMI_TPU_GOVERNOR=0 keeps every budget static)
    GOVERNOR.maybe_start()
    # the profile's outcome into this invocation's scoped registry
    # (application itself is process-once)
    _profile.stamp_metrics()
    if args.flight_dump_dir:
        FLIGHT.configure(args.flight_dump_dir)
    FLIGHT.note("command.start", command=args.command)
    install_signal_dump()
    tracer = hb = None
    if trace_path:
        from .observe.scope import current_scope
        from .observe.trace import start_trace

        tracer = start_trace()
        scope = current_scope()
        if scope is not None and (scope.trace_id or scope.job_id):
            tracer.set_context(
                trace_id=scope.trace_id,
                parent_span_id=scope.parent_span_id,
                process_label=(f"backend {scope.job_id}" if scope.job_id
                               else None))
    if hb_s > 0:
        from .observe.heartbeat import Heartbeat

        hb = Heartbeat(hb_s)
    t0 = time.monotonic()
    t0_unix = time.time()
    rc = 1  # the report's value when an unmapped exception escapes
    token = _MAIN_DEPTH.set(_MAIN_DEPTH.get() + 1)
    try:
        # a serve job records its client's command line (observe.scope.
        # command_argv), so its outputs equal the standalone command's
        rc = _run_command(args, argv, command_line_override())
        return rc
    except Exception as e:
        # anything the exit-code contract does not map is a crash: freeze
        # a black box before unwinding (the report records exit 1)
        FLIGHT.dump("unhandled-exception", exc=e)
        raise
    finally:
        _MAIN_DEPTH.reset(token)
        if hb is not None:
            hb.stop()
        if tracer is not None:
            from .observe.trace import stop_trace, write_trace

            stop_trace()
            try:
                write_trace(trace_path, tracer)
                log.info("trace: %d spans -> %s (open in "
                         "https://ui.perfetto.dev)",
                         len(tracer.snapshot()), trace_path)
            except OSError as e:
                log.error("failed to write trace %s: %s", trace_path, e)
        # in-flight background audits reach their verdicts before the
        # command exits (a divergence must trip the breaker and land in
        # this run's report); the module is looked up, not imported
        sentinel = sys.modules.get(__package__ + ".ops.sentinel")
        if sentinel is not None and not sentinel.SENTINEL.drain():
            log.warning("audit sentinel: background audits still pending "
                        "at command exit; report may undercount")
        if report_path:
            from .observe.report import emit, fold_device_stats

            fold_device_stats()
            GOVERNOR.fold_metrics()
            report = emit(report_path, args.command, argv, t0_unix,
                          time.monotonic() - t0, rc, trace_path)
            if report is not None:
                log.info("run report -> %s", report_path)
