#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (fgumi_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --phase mapped`` runs the mapped phase below alone:
its inputs and ``fixed5_1M``, the ``fixed5_1M --device-filter`` run it
compares with, then K1-f and K1 at those runs' batches and the last lines.
``python3 chip_smoke.py --phase qc`` runs the qc phase alone: first its own
inputs, ``mapped_chain_400k`` and the fast ``group --strategy paired`` of
``amplicon_paired`` (``cuda`` and ``cpu``), then the phase, then K4 and K1
at those runs' largest launch and batch and the last lines.
``python3 chip_smoke.py --phase serve`` runs the serve phase alone, on its
two inputs, ``longtail_200k`` and ``pipeline_k4_50k``'s FASTQ pair, then
K7's entry and the last lines. ``python3 chip_smoke.py --phase fleet`` runs
the fleet phase alone, on its three inputs, ``longtail_200k``,
``duplex_240k`` and ``pipeline_k4_50k``'s FASTQ pair, after one standalone
run of each whale's argv here, then the last lines. ``python3 chip_smoke.py
--phase route`` runs the route phase alone, on its four inputs,
``longtail_200k``, ``duplex_240k``, ``many_quals_20k`` and ``fixed5_1M``,
after the ``cuda`` runs it holds its cases to, then the last lines.
``python3 chip_smoke.py --phase tune`` runs the tune phase alone: its two
inputs, ``longtail_200k`` and ``duplex_240k``, then the ``tune --quick``
child on an otherwise idle card, then the ``cuda`` runs it holds its
profile runs to (the simplex run with ``--run-report``, the replay's
evidence), then the phase, with each profile run also made without and
with the profile in turns (plain, profile, profile, plain: children one
at a time, their walls side by side), then K8's entry and the last
lines.)

Phases (any failed check exits nonzero; nothing is caught and passed over):

1. setup: the card's name and power limit (nvidia-smi); whether the card
   host has libdeflate's header and library (a probe: nothing links it);
   the input BAMs
   are simulated or built in worker processes (the host's cores but two,
   in the order the phases need them) while the main process builds, in
   parallel, the CUDA kernels (one ``nvcc`` per source in
   ``fgumi_tpu_torch/csrc``) and the native host library (``g++`` on
   ``fgumi_tpu_torch/native``), all timed; each phase waits only for its
   own inputs (the 1,000,000-read ``correct_1M`` simulation, needed last,
   runs on beside the phases before ``mapped``);
2. kernels at the test shapes: K4 ``umi_hamming`` against its plain version,
   exactly (one row on either side; L 1, 3, 8, 9, 71 and 4, 5, 15, 16, 17,
   32, 33 around the bit planes' 32 columns and the 4-byte words; M of every
   residue mod 8; fewer output tiles than the persistent grid's blocks;
   8,191 x 8,191 and 8,191 x 9; all 256 byte values, one repeated byte, all-
   equal and all-different rows; bytes from ``ACGTN-:``), each check line
   with its launch geometry (persistent grid, tiles, blocks per SM, bit
   planes or bytes, L chunks) and the registers of its kernels; the strand
   combines K6 ``codec_combine`` at T 1, 15, 16, 17 (its 4-position groups,
   16-position planes and the scalar tail) and 2,678,850 positions, and K5
   ``duplex_combine`` at 1 and 11,757 rows (over 23,724 resident rows) at
   widths 4, 128 and 152 with lengths 0 to L + 8, each exactly against its
   plain PyTorch version on the card, with its launch geometry (grid,
   threads, blocks per SM) and registers, and a misaligned K6 view
   refused; K1
   ``consensus_wire_full`` and K1-f ``consensus_wire_filter`` against their
   plain PyTorch versions on the card, and K1-r ``consensus_wire_resident``
   at the tiling edges below (K1's planes as K1's, its lane counts exact and
   equal to the rows' own counts, tb/tq exact where neither side is
   suspect) (K1: depth/errors exact, winner/qual
   exact where neither side is suspect, every plane exact after the f64
   oracle patch and equal to the oracle on sampled families; K1-f:
   depth/errors exact, the per-read suspect flags equal, stats columns 0-5
   and fb/fq within the read length exact on rows neither side flags, and
   every row equal to the host twin over the oracle-patched columns once the
   suspect rows went through ``filter_resolve_suspect_rows`` and the host
   filter pass); both also at their tiling edges (reads of 1-300 rows, L
   4-2048, Q0-class observations, 1, 37 and 40,000 reads; K1 also three
   600-row families), each check line with the kernel's launch geometry
   (grid, warps per block, shared bytes, blocks per SM) and registers;
   K1-p2 ``consensus_wire_packed2`` (the batches of more than 63 distinct
   quals) against its plain version as K1 is held, at reads of 0-300 rows
   in one batch at widths 4-2,048 with quals 2-93, quals of 94-255
   (clamped), all-N rows and Q0-class observations, at one read and at
   40,000 reads;
3. end to end through the port's CLI, each case's cuda run between a reset
   and a read of the launch counts, its records equal to the ``--device
   cpu`` run's; the phases run as their inputs are built: ``group``,
   ``pipeline``, ``filter``, ``sort``, duplex, codec and methylation first,
   then the simplex cases below (``fixed5_1M`` simulates longest) and the
   rest in the order listed:
   - ``fixed5_1M``: BASELINE config 1 at full size, 1,000,000 reads
     (100,000 families x 5 templates, paired, 150 bp, seed 42), fast engine
     ``simplex`` and ``simplex --device-filter`` (the options of the JAX
     package's device-filter tests);
   - ``longtail_200k``: ~200,000 longtail reads (18,000 families, seed 43),
     the same two runs;
   - ``classic_50k``: 50,000 reads (5,000 families x 5, seed 42) on the
     ``--classic`` engine;
   - ``many_quals_20k``: 20,000 reads whose batches hold more than 63
     distinct quals (quality decay and overlap sums), fast ``simplex``
     through the packed2 route: K1-p2 launched, its plain version never;
   - ``amplicon_group``: ``group --classic`` and then ``group`` (the fast
     engine) with ``--strategy adjacency`` and ``--strategy edit`` on 16
     amplicon positions x 4,000 molecules x 3 templates (paired, 100 bp,
     8-base UMIs, UMI error rate 0.02 a base): ~5,600 distinct UMIs a
     position group, so K4 at ~5,600 x 5,600 x 8 once a group;
   - ``amplicon_paired``: ``group --classic --strategy paired`` and then
     the fast engine on 8 positions x 3,000 molecules x 3 templates, 4+4
     paired UMIs, half BA (K4 twice a group);
   each group run also writes its ``-M`` metrics files, equal between
   ``cuda`` and ``cpu`` (the ``--classic`` adjacency and edit runs are
   made on ``cuda`` alone since PR 26: each is held to the fast engine's
   ``cuda`` run, which is held to its ``cpu`` run); the fast runs' records
   and metrics files must also equal the ``--classic`` run's, and their
   ``e2e`` line carries the busy wall of the read, process and write
   stages;
   - ``pipeline_400k``: ``pipeline`` from FASTQ to filtered consensus
     (extract ⇒ template-coordinate sort ⇒ group ⇒ simplex ⇒ filter) on the
     port's ``simulate fastq-reads`` output, 40,000 families x 5 pairs,
     100 bp, seed 7, ``-r 8M+T +T``: fused on ``cuda`` and on ``cpu``,
     ``--no-fuse`` on ``cuda``, ``--device-filter`` on ``cuda`` and on
     ``cpu``; every run's records identical, K1 launched on the fused and
     staged ``cuda`` runs and K1-f on the ``--device-filter`` one (the one
     unmapped position group holds ~35,000 distinct UMIs, the native
     pigeonhole route's, so no K4);
   - ``pipeline_k4_50k``: the same with 5,000 families (~4,800 distinct
     UMIs in the one group), fused on ``cuda`` and ``cpu``: K4 and K1
     launched, records identical;
   each pipeline run's ``e2e`` line carries reads/s, wall and the stage
   walls of ``--stats-json``, and every run without ``--device-filter``
   must have run its filter stage on the batch engine (``FastFilter``);
   the staged run keeps its intermediate BAMs (``--keep-intermediates``);
   - ``filter_400k``: ``filter`` (the batch engine) with ``--rejects`` on
     that staged run's consensus BAM (~80,000 records) with the pipeline's
     filter options, the kept records identical to the fused pipeline's
     output; then the batch engine and ``filter --classic`` (per record)
     on its first 20,000 records, cut at a template: records, rejects and
     counts identical between the engines, both walls printed;
   - ``sort_amplicon``: ``sort`` of ``amplicon_group``'s input (384,000
     mapped reads) with spill runs forced (``--max-records-in-ram
     40000``): ``--order coordinate --write-index`` at ``--threads 1`` and
     ``--threads 4`` (spill workers and the merge's frame prefetch), records
     and BAI files identical between them, and ``--order queryname
     --threads 4``; ``sort --verify`` accepts every output;
   - ``duplex_240k``: ``duplex`` (the fast engine) on the port's ``simulate
     duplex-reads`` output, 20,000 molecules x 3 pairs a strand, 100 bp,
     seed 47 (240,000 reads), on ``cuda`` and ``cpu``, records identical;
     ``filter --min-reads 6,3,3`` on the ``cuda`` output on the batch
     engine, and both engines on its first 10,000 records, cut at a
     template (records, rejects and counts identical; the classic engine
     is per record, host only); and
     ``duplex --device-filter --filter-min-reads 6,3,3`` on ``cuda``,
     identical to ``duplex | filter``;
   - ``duplex_bias_120k``: 10,000 molecules, Beta(2, 2) strand split, 90%
     with a B strand, seed 48 (single-read strands, single-strand
     molecules and ``InsufficientReads`` rejects), ``duplex --min-reads 2 1
     0`` on ``cuda`` and ``cpu``, identical, and ``filter --min-reads
     4,2,1`` on both engines as above, identical;
   - ``duplex_classic_24k``: 2,000 molecules, seed 47, ``duplex
     --classic`` on ``cuda``, identical to the fast engine's records;
   each duplex run's ``e2e`` line carries reads/s, wall, ``device_s``,
   ``oracle_patch_s``, the strand combine's seconds and its rows on the
   device (K5) and on the host (fast engine), the device share of the
   wall, its K1-r (fast) or K1 (``--classic``) launches and its largest
   stage-1 batch (rows, L, J); every fast ``cuda`` run must have combined
   rows through K5;
   - ``codec_320k``: ``codec --min-reads 1`` (the batch engine) on the
     port's ``simulate codec-reads --num-molecules 80000
     --pairs-per-molecule 2 --read-length 100 --seed 9`` output (320,000
     reads; BASELINE config 4 as ``bench.py`` builds it, at 4x its
     molecules), ``cuda`` and ``cpu``, records identical, K1 and K6
     launched; ``filter -M 4,2,2`` on both engines on the output as above
     (the batch engine on the whole, both on its first 10,000 records;
     records, rejects and counts identical);
   - ``codec_classic_24k``: 6,000 molecules, ``codec --classic`` against
     the batch engine, both ``cuda``, records identical;
   - ``emseq_simplex_50k``, ``taps_simplex_50k``: ``simplex --em-seq`` /
     ``--taps --ref --min-reads 1`` on 50,000 mapped reads (5,000 molecules
     x 5 paired templates, half from the bottom strand; CpG methylated
     with p 0.75, conversion p 0.995, 1% errors; ``methylation_bam``) over
     a seeded 4 x 250 kb reference (``meth_reference``, written by the
     port's ``write_fasta``); ``emseq_duplex_24k``: ``duplex
     --methylation-mode em-seq`` on 2,000 molecules x 2 strands x 3 pairs,
     on the fast engine and ``--classic``; records identical between
     ``cuda`` and ``cpu`` (and the engines) with their methylation tags;
     ``filter`` with each case's methylation options and ``--ref`` (the
     per-record engine) and with the depth mask alone (the batch engine),
     each against ``--classic``;
   - ``rejects``: ``simplex --min-reads 2 --rejects`` on ``longtail_200k``
     and ``duplex --min-reads 2 1 0 --rejects`` on ``duplex_rejects_24k``
     (``duplex_bias_120k``'s generator at 2,000 molecules), consensus
     records and rejects BAMs identical between ``cuda`` and ``cpu``;
   - ``staged``: the runs of :data:`STAGED_RUNS` on ``cuda`` through the
     stage runner (``pipeline.run_stages``): ``fixed5_1M`` fast at
     ``--threads 4``, again with 1 MiB batches (about 290 dispatches
     through the pinned staging pool, later ones uploaded while earlier
     ones are in flight) and with ``--max-memory 256M`` (its input bytes in
     flight within half the budget), ``fixed5_1M --device-filter``,
     ``many_quals_20k`` (K1-p2) and ``duplex_240k`` (K5 launched from the
     resolve workers) at ``--threads 4``, ``codec_320k`` at ``--threads
     3``, the fast ``group`` adjacency run (K4 in the process stage) and
     the fused ``pipeline_400k`` at ``--threads 4``; each run's records
     identical to the serial ``cuda`` run's, its launches (between a
     reset and a read) equal to that run's (more K1 launches at 1 MiB), and
     its ``staged`` line with reads/s beside the serial run's, the stage
     busy and blocked seconds, the queues and the device dispatches (the
     most in flight at once); then the ``io`` phase: ``fixed5_1M_fast``'s
     output BAM, inflated once, written again at one thread and at
     ``compress_threads()`` threads (bytes identical to each other and to
     the file the command wrote; ``write_indexed``'s virtual offsets
     identical) and inflated at both thread counts (bytes identical), its
     ``io`` line with the MB/s of each, ``os.cpu_count()`` and the CPUs
     this process may run on; then the ``observe`` phase: ``pipeline_400k``
     fused on ``cuda``, with and without ``--device-filter``, under
     ``--trace --run-report --heartbeat 1 --audit-output
     --flight-dump-dir`` (records and launches identical to the pipeline
     phase's plain runs; the trace valid Chrome JSON with one
     ``device.dispatch`` span a launch and spans on the chain stages' and
     the BGZF pool's threads; the report accepted by the port's validator,
     which the CPU tests hold equal to the JAX package's, its device
     section equal to the consensus launches; the output audited; no
     flight dump; an ``observe`` line with both walls and the span
     counts), ``pipeline_k4_50k`` under
     ``writer.compress:corrupt-bytes:1.0:1`` with ``--audit-output`` (exit
     5, nothing published, one flight dump), and ``fixed5_1M_fast`` at
     ``--threads 4`` and the fast ``group`` adjacency run traced (spans on
     the reader, worker, writer and BGZF threads; an ``observe_split``
     line splitting the process stage into the ``device.dispatch`` and
     ``device.fetch`` spans nested in it and the rest); each of these
     four commands is also run plain and with its options in turns
     (plain, observed, observed, plain; ``turns_*`` walls, ``overhead``
     the ratio of the medians less one); then the ``dedup`` phase:
     ``dedup -s adjacency -m -H`` on ``amplicon_group``'s input (384,000
     reads, 16 position groups), the batch engine on ``cuda`` and ``cpu``
     and at ``--threads 4``, and ``--classic`` on ``cuda``, each ``cuda``
     run with one K4 launch a position group; records and the ``-m``/``-H``
     files identical between the runs (``records()``, the files' bytes, and
     the port's ``compare bams`` and ``compare metrics`` in child
     processes); its ``dedup`` line with each run's reads/s beside fast
     ``group``'s; then the ``resilience`` phase, each run a child process on
     ``cuda`` whose ``resilience`` line names its fault:
     ``device.dispatch:raise:1.0:2`` (exit 0, records equal to the clean
     run's, 2 retries), ``device.dispatch:oom:1.0:1`` (exit 0, a halving,
     one more wire launch, records equal) and ``device.dispatch:raise:1.0``
     (exit 3, nothing published, one error line) on ``longtail_200k_fast``;
     ``device.dispatch:oom:1.0:1`` on ``longtail_200k_fused`` (K1-f, its
     halves through K1 as columns), ``duplex_bias_120k`` (K1-r: the split
     batch joins its halves' resident arrays, so K5 launches and the host
     combine's rows equal the clean run's) and ``many_quals_20k`` (K1-p2),
     each equal to its clean ``cuda`` run; and a real
     ``torch.cuda.OutOfMemoryError``: ``longtail_200k`` in 256 MiB record
     batches, uncapped, then under caching-allocator caps
     (``torch.cuda.set_per_process_memory_fraction``) of 0.65-0.95 of the
     largest batch's device bytes (its upload and its K1 outputs), one of which
     must halve on the real error, exit 0 and write the clean records;
   then the ``mapped`` phase, the front half of the reference's documented
   workflow, one run at a time so that no wall shares the host with another
   run of this script: ``correct_1M`` (the port's ``simulate correct-reads
   -n 1000000 --num-umis 1000 -u 8 -l 100 --max-errors 2 --seed 52``;
   ``correct -U <list> -m -r`` on the batch engine, then on the first
   100,000 reads (cut at a template) on the batch engine and ``--classic``,
   records, rejects and metrics of those identical; the share of reads
   whose corrected UMI is the truth table's), then ``mapped_chain_400k``
   (``simulate fastq-reads --num-families 40000 --family-size 5
   --read-length 100 --includelist <that list> --seed 53``,
   then ``extract -r 8M+T +T``, ``correct -U <list>``, ``fastq``, a stand-in
   aligner written here (:func:`stand_in_align`: ten families a position
   over four contigs, R1 forward, R2 reverse, a quarter soft-clipped, some
   supplementary records and unmapped mates; a query-grouped mapped BAM),
   ``zipper`` (the batch engine; ``--classic`` on the first 50,000 aligned
   records, cut at a template, equal to the batch engine's first records),
   ``sort --order
   template-coordinate`` of the whole and of each half, ``merge`` of the
   sorted halves (equal to the sorted whole), ``group -s adjacency``,
   ``simplex --min-reads 1`` on ``cuda`` (K1 launched) and then on ``cpu``
   (nothing launched), identical, and ``filter -M 1``; a ``mapped``
   line with each step's wall and records/s), then ``device_filter_env``:
   ``fixed5_1M`` under ``FGUMI_TPU_DEVICE_FILTER=1`` without
   ``--device-filter`` and ``=0`` with it, each with the ``fixed5_1M_fused``
   run's records and launches (K1-f: ``=0`` requests nothing, and the flag
   keeps the fused filter on the card); then the ``qc`` phase, the QC and
   post-consensus commands on inputs made above, one at a time, each timed
   on a ``qc`` line (host commands: every launch count stays 0 across it):
   ``clip -c soft --clip-overlapping-reads --clip-bases-past-mate -m`` on
   the first 40,000 records of the chain's query-grouped ``zipped.bam``
   (of 276,099; the reference a seeded FASTA of the stand-in aligner's
   four 1,000,000-base contigs, written with the port's ``write_fasta``)
   and ``clip -c hard -H -a --read-one-five-prime 3
   --read-two-three-prime 2 -m`` on its first 20,000 records, both cut at
   a template (:func:`split_at_template`), each with
   the records out the records in, name for name and in order, the
   templates the command counted the input's, and the soft run's
   overlap-clipped templates above 0; ``simplex-metrics --min-reads 3`` on
   the chain's ``grouped.bam``; ``duplex-metrics --duplex-umi-counts`` on
   the first 48,000 records (cut at a template) of the fast paired
   ``group`` output of ``amplicon_paired`` (144,000 reads, MI ``/A`` and
   ``/B``), plain and with a BED of half its 8 positions
   (fewer templates, not none; duplexes found); ``downsample -f 0.5 --seed
   7 --rejects --histogram-kept --histogram-rejected`` on ``grouped.bam``
   (kept and rejected records together the input, family by family; the
   histograms sum to its families) and ``-f 1.0`` (the input's records);
   ``review`` with ``-c`` the grouped BAM sorted by coordinate with its BAI
   (raw reads with MI standing in for a consensus), ``-g`` the grouped BAM
   and a VCF of 200 seeded SNV sites at covered positions with a sample
   column, run with the BAI beside the BAM (the indexed pass) and without
   it (the streaming pass), the three outputs identical; and, before the
   ``mapped`` phase, the ``serve`` phase: ``python -m fgumi_tpu_torch
   serve`` in a child process (``--workers 2 --health-period 1
   --metrics-port 0 --report-dir``; its warm-up — CUDA context, every
   kernel library loaded — timed from its log line), ``simplex`` on
   ``longtail_200k`` submitted twice (cold, then warm; records equal; both
   walls), then a ``pipeline`` on ``pipeline_k4_50k`` (K4, K1) and a fused
   ``simplex --device-filter`` on ``longtail_200k`` (K1-f) submitted at
   once, each output byte-identical to the port's standalone run of the
   same argv in this process and each job's own ``--stats-json`` (the
   daemon's per-command launch tallies) naming its kernels; ``stats``
   with at least 3 ``device.canary.ok`` after the last job and the
   breaker closed, ``/healthz`` 200 and ``/metrics``; ``jobs --shutdown``
   (the client's) and exit 0; the daemon also runs with ``--journal`` and
   ``--coalesce-window-ms 2`` (the coalescer's opt-in auto mode: its
   ``stats`` must show the window armed while the pipeline and the fused
   job run together, and disarmed for the single jobs, whose walls stay
   comparable); after the shutdown its ``<journal>.routing.json`` holds
   schema 1; a second daemon, started beside it, runs with
   ``--coalesce-window-ms 200`` under ``FGUMI_TPU_COALESCE=1`` (the window
   forced: the auto window is priced at the router's per-dispatch
   overhead, a few milliseconds at most on the card, so two jobs' batches
   rarely meet inside it), and two plain ``simplex`` jobs on
   ``longtail_200k`` submitted to it at once must merge at least one K1
   batch (``stats`` ``coalesce``), launch K1 fewer times together than
   twice a solo run, and each write the bytes of its standalone run; a
   ``serve`` line with the walls; then K7
   ``canary_sum`` against its plain version on the card, exactly (zeros,
   all-255 and random bytes at 1 MiB, 1, 17 and 1 MiB + 13 bytes), timed at
   1 MiB beside its bound, its plain version and ``torch.sum(x,
   dtype=torch.int32)``; its launches in the ``kernels`` line are the
   daemon's health monitor's (a fresh process, so every count starts at
   0), read from ``stats``; then the ``fleet`` phase (:func:`fleet_phase`):
   two journaled daemons ``serve --journal-dir --fleet-id a|b
   --lease-scan-period 1 --workers 1 --health-period 1``, each its own
   process and CUDA context on the one card, behind a host-only ``balance
   --scatter 3 --scatter-wal --metrics-port 0`` (no CUDA or torch library
   in its memory map); three whales through it, each the argv of an
   earlier run (e2e's ``simplex`` on ``longtail_200k``, K1; the duplex
   phase's ``duplex`` on ``duplex_240k``, K1-r and K5; the serve phase's
   ``pipeline`` on ``pipeline_k4_50k``, K4 and K1), each gathered BAM
   byte-identical to that run's output, every shard ``done`` and its own
   ``--stats-json`` (one a shard) naming its kernels, ``jobs --scatter``
   agreeing, the balancer's ``/healthz`` 200; then two ``simplex`` jobs
   (fast and fused) straight to ``b``, ``b`` SIGKILLed once the first
   runs: ``a`` shows both under their original ids within 3 s and
   finishes both byte-identically, ``b``'s journal is renamed
   ``.claimed`` and ``a``'s ``stats`` fleet section shows one takeover of
   two jobs; ``b`` restarted (``--no-warmup``) takes its lease and replays
   nothing; every process shut down, exit 0; a ``fleet`` line with the
   walls, and each kernel's fleet launches (the shards' tallies, ``a``'s
   K7 canaries) in the ``kernels`` line as ``fleet_launches``; then the
   ``route`` phase (:func:`route_phase`, in this process but R5, while the
   mapped inputs finish building): R1 ``FGUMI_TPU_AUDIT=all`` on
   ``longtail_200k_fast`` (K1), ``_fused`` (K1-f), ``duplex_240k`` (K1-r)
   and ``many_quals_20k`` (K1-p2): the sentinel samples every dispatch,
   none diverges, the records equal the earlier ``cuda`` run's; R2
   ``device.fetch:corrupt-result:1.0:1`` under ``all``: a divergence, the
   breaker's SDC trip, ``audit.divergence`` in the run report, exit 0 and
   the clean records (the inline repair); R3 ``FGUMI_TPU_ROUTE=host``: no
   wire launch, every batch a host batch, the same records, both walls;
   R4 ``FGUMI_TPU_HYBRID=1`` on ``fixed5_1M_fast``: the route counters,
   K1 launches plus host batches equal to the ``cuda`` run's batches, the
   same records; R5 a child with ``device.dispatch:hang:1.0:1``,
   ``FGUMI_TPU_FAULT_HANG_S=30`` and ``FGUMI_TPU_DISPATCH_DEADLINE_S=
   0.5:2``: exit 3 before the hang could end, its deadline line within 3
   s of the hang's start (the child's own log clock), no output; a
   ``route`` line; each kernel's R1 launches in the ``kernels`` line as
   ``audited_launches``; then the ``tune`` phase (:func:`tune_phase`):
   K8 ``tune_combine`` against its plain version and numpy's expression
   on the card, exactly, at the sweep's (512, 100) and (4096, 150) on the
   chooser bench's arrays, random bytes, bytes 250-255 half of them equal
   (``min + 3`` wraps) and a view 1 byte past a 16-byte boundary (the byte
   path), and at 37 x 99 (the 16-byte words' tail), each with its launch
   geometry and registers, timed at both shapes beside its 3-byte-a-cell
   bound and its plain version (no single PyTorch call computes it); the
   ``tune --quick --device cuda`` child started right after the kernels'
   build (beside the test shapes and the inputs' simulation) must have
   exited 0 with a profile and an atlas the port's validator accepts, the 3
   quick cells each with both rates and a winner, K1 launched on each of
   its 12 timed device calls and K8 4 times (its launch line); ``tune
   --replay`` of R4's run report, in this process, takes that report's
   ``device.routing`` values as its router priors; ``longtail_200k_fast``
   and ``duplex_240k``'s ``duplex`` run again under ``--profile`` (children
   at once) write their ``cuda`` runs' records, their run reports show the
   knobs applied, the router seeded and ``prior_source`` "profile", their
   kernels launched, and no "gate timed out" line; a ``tune`` line with
   each cell's rates and winner, the crossovers, the knobs (the feeder
   depth), the chooser and router priors (``link_mbps``: the feeder's
   staging copy and launch) and the walls;
4. kernels at the main-path shapes the runs reported (the fast runs' largest
   batch; the simplex stage's largest batch of each ``cuda`` pipeline run:
   K1 on fused and ``--no-fuse`` ``pipeline_400k`` and on
   ``pipeline_k4_50k``, K1-f on ``pipeline_400k --device-filter``; K1-r at
   ``duplex_240k``'s largest stage-1 batch, and at uniform random bases and
   quals 2-40 of that shape (almost every column with a disagreement), and
   K5
   over its resident arrays
   at that run's largest device combine (rows), held against the numpy
   combine; K1 at ``codec_320k``'s largest stage-1 batch and K6 at its
   largest combine (positions), held against ``combine_arrays``; K4 at the
   fast adjacency run's largest launch, and also at the paired run's, at
   the fused ``pipeline_k4_50k`` run's, at the batch ``dedup`` run's and at
   8,191 x 8,191 x 8, the largest
   dense launch), checked as in
   phase 2 and then timed beside the bound and the plain version's time:
   device time per launch from torch.profiler over 25 calls, CUDA-event time
   per call over 25 back-to-back calls, and the median CUDA-event time of
   one call with its host launch path (for K4 every kernel a call launches,
   and its tile kernel alone); K4 also its fetch to the host and the
   yardstick ``torch.cdist(a.float(), b.float(), p=0)``; K5 and K6 are also
   held against their plain versions on the card and K6 against
   ``codec_combine_device`` (its one upload and one fetch), and beside
   their times stands the numpy combine's host time (``host_ms``); K1-p2
   at ``many_quals_20k``'s largest batch and at ``fixed5_p2`` (the rows of
   ``fixed5_1M``'s largest fast batch with quals 2-93, the packed2 layout:
   where an unbinned sample would run it);
5. the ``kernels`` JSON line: one entry a kernel and path, its ``path`` the
   run whose shape it was checked and timed at and its ``launches`` that
   run's count, taken between a reset and a read (K1 ``fixed5_1M_fast``,
   ``pipeline_400k_fused`` and ``duplex_240k``, K1-f ``fixed5_1M_fused`` and
   ``pipeline_400k_device_filter``, K4 ``amplicon_group_adjacency_fast``,
   ``pipeline_k4_50k_fused`` and ``amplicon_dedup_adjacency_fast``, K1-r
   and K5 ``duplex_240k``, K1 and K6
   ``codec_320k``, K1-p2 ``many_quals_20k``, K1 ``mapped_chain_400k`` at
   that run's largest simplex batch, K7 ``serve_health_monitor``, K8
   ``tune_quick`` (its launches the ``tune`` child's own count, checked
   and timed at (512, 100), with ``full_ms``, ``full_plain_ms`` and
   ``full_bound_ms`` at (4096, 150)); an
   entry whose path has a staged run
   also with ``staged_path`` and ``staged_launches``, that run and its
   count; each entry with its registers
   and launch geometry; K1-r's also with ``uniform_ms``, its time at the
   uniform batch, and K1-p2's with ``fixed5_p2_ms``, ``fixed5_p2_plain_ms``
   and ``fixed5_p2_bound_ms``), the nvidia-smi line and, last, the device
   line.

Exits 2 without a result when CUDA is unavailable or the port is missing.
"""

import atexit
import concurrent.futures as cf
import json
import logging
import multiprocessing
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 rate outside the tensor cores
KERNEL_SOURCE = "fgumi_tpu_torch/csrc/consensus_wire.cu"
HAMMING_SOURCE = "fgumi_tpu_torch/csrc/umi_hamming.cu"
REPLACES_FULL = "fgumi_tpu/ops/pallas_kernel.py:240"
REPLACES_FILTER = "fgumi_tpu/ops/pallas_kernel.py:460"
REPLACES_HAMMING = "fgumi_tpu/umi/assigners.py:317"
REPLACES_RESIDENT = "fgumi_tpu/ops/kernel.py:1778"
REPLACES_DUPLEX_COMBINE = "fgumi_tpu/ops/kernel.py:1894"
REPLACES_CODEC_COMBINE = "fgumi_tpu/ops/kernel.py:1942"
REPLACES_PACKED2 = "fgumi_tpu/ops/kernel.py:2046"
COMBINE_SOURCE = "fgumi_tpu_torch/csrc/strand_combine.cu"
# the fused filter's options, as the JAX package's device-filter tests use
FILTER_OPTS = ["--filter-min-reads", "3", "--filter-min-mean-base-quality",
               "30", "--filter-min-base-quality", "20"]
# consensus thresholds of the kernel-level K1-f checks
MIN_READS_C, MIN_QUAL_C = 1, 40

# simulated grouped-reads inputs (simplex)
INPUTS = {
    "fixed5_1M": dict(num_families=100000, family_size=5, read_length=150,
                      paired=True, seed=42),
    "longtail_200k": dict(num_families=18000, family_size=5,
                          family_size_distribution="longtail",
                          read_length=150, paired=True, seed=43),
    "classic_50k": dict(num_families=5000, family_size=5, read_length=150,
                        paired=True, seed=42),
    "many_quals_20k": dict(num_families=2000, family_size=5,
                           base_quality=40, qual_slope=0.3,
                           insert_size_mean=150, insert_size_sd=30, seed=44),
}
# amplicon inputs (group), built here: every template of a position shares
# its ends, so each position is one group of thousands of distinct UMIs
AMPLICONS = {
    "amplicon_group": dict(positions=16, molecules=4000, copies=3, seed=45),
    "amplicon_paired": dict(positions=8, molecules=3000, copies=3, seed=46,
                            paired_umis=True),
}
GROUP_RUNS = (("amplicon_group", "adjacency"), ("amplicon_group", "edit"),
              ("amplicon_paired", "paired"))
# FASTQ inputs of the pipeline (simulate fastq-reads, 5 pairs a family)
FASTQ = {"pipeline_400k": 40000, "pipeline_k4_50k": 5000}
FASTQ_SIM = ["--family-size", "5", "--read-length", "100", "--seed", "7"]
PIPELINE_OPTS = ["-r", "8M+T", "+T", "--sample", "s", "--library", "l"]
# (label, device, flags) of each pipeline case; the first is the reference
PIPELINE_RUNS = {
    "pipeline_400k": (("fused", "cuda", []), ("fused", "cpu", []),
                      ("staged", "cuda", ["--no-fuse"]),
                      ("device_filter", "cuda", ["--device-filter"]),
                      ("device_filter", "cpu", ["--device-filter"])),
    "pipeline_k4_50k": (("fused", "cuda", []), ("fused", "cpu", [])),
}
STAGES = ("extract", "sort", "group", "simplex", "filter")
# simulated duplex-reads inputs (duplex): bench.py's duplex workload shape
# at 4x its molecules, a strand-biased input, and the classic engine's cut
DUPLEX = {
    "duplex_240k": dict(num_molecules=20000, reads_per_strand=3,
                        read_length=100, seed=47),
    "duplex_bias_120k": dict(num_molecules=10000, reads_per_strand=3,
                             strand_bias_alpha=2.0, strand_bias_beta=2.0,
                             ba_fraction=0.9, seed=48),
    "duplex_classic_24k": dict(num_molecules=2000, reads_per_strand=3,
                               read_length=100, seed=47),
    # duplex_bias_120k's generator cut to 2,000 molecules: the rejects
    # route is per molecule
    "duplex_rejects_24k": dict(num_molecules=2000, reads_per_strand=3,
                               strand_bias_alpha=2.0, strand_bias_beta=2.0,
                               ba_fraction=0.9, seed=48),
}
# the methylation inputs: a seeded random reference (4 contigs x 250 kb),
# written by the port's write_fasta, and EM-Seq/TAPS libraries over it
# (chip_smoke.methylation_bam): simplex 5,000 molecules x 5 paired
# templates (50,000 reads), duplex 2,000 molecules x 2 strands x 3 pairs
# (24,000 reads)
METH_REF = dict(contigs=4, length=250_000, seed=49)
METHYLATION = {
    "emseq_simplex_50k": dict(mode="em-seq", molecules=5000, templates=5,
                              seed=49),
    "taps_simplex_50k": dict(mode="taps", molecules=5000, templates=5,
                             seed=50),
    "emseq_duplex_24k": dict(mode="em-seq", molecules=2000, duplex=True,
                             templates=3, seed=51),
}
# (command, flags, filter flags) of each methylation case; REF: the FASTA
METH_RUNS = {
    "emseq_simplex_50k": ("simplex", ["--em-seq", "--min-reads", "1"], [
        "-M", "3", "--methylation-mode", "em-seq",
        "--min-methylation-depth", "3", "--min-conversion-fraction", "0.9"]),
    "taps_simplex_50k": ("simplex", ["--taps", "--min-reads", "1"], [
        "-M", "3", "--methylation-mode", "taps",
        "--min-methylation-depth", "3", "--min-conversion-fraction", "0.9"]),
    "emseq_duplex_24k": ("duplex", ["--methylation-mode", "em-seq",
                                    "--min-reads", "1"], [
        "-M", "6,3,3", "--min-methylation-depth", "4,2,2",
        "--require-strand-methylation-agreement", "--methylation-mode",
        "em-seq"]),
}
# the batch engine's methylation depth mask alone (no --ref): simplex and
# duplex (-n 0.95: the mask takes every position without C evidence)
METH_DEPTH_ONLY = {
    "simplex": ["-M", "3", "--min-methylation-depth", "3", "-n", "0.95",
                "--filter-by-template", "false"],
    "duplex": ["-M", "3,1,1", "--min-methylation-depth", "3,0,0", "-n",
               "0.95", "--filter-by-template", "false"],
}
DUPLEX_FILTER = {"duplex_240k": "6,3,3", "duplex_bias_120k": "4,2,1",
                 "codec_320k": "4,2,2"}
# simulated codec-reads inputs (codec): BASELINE config 4 as bench.py builds
# it, at 4x its molecules, and the classic engine's cut
CODEC = {
    "codec_320k": dict(num_molecules=80000, pairs_per_molecule=2,
                       read_length=100, seed=9),
    "codec_classic_24k": dict(num_molecules=6000, pairs_per_molecule=2,
                              read_length=100, seed=9),
}


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def check(cond, msg: str):
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ inputs

def random_batch(n_fam: int, fam: int, L: int, seed: int, q0: bool = False):
    """Uniform random codes (N included) and quals: the test shapes.
    ``q0`` adds Q0-class observations (a -inf dictionary entry)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 5, size=(n_fam * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(n_fam * fam, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    starts = (np.arange(n_fam + 1) * fam).astype(np.int64)
    return codes, quals, starts


def ragged_batch(sizes, L: int, seed: int, q0: bool = False):
    """As ``random_batch`` with reads of the given row counts."""
    rng = np.random.default_rng(seed)
    N = int(np.sum(sizes))
    codes = rng.integers(0, 5, size=(N, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(N, L), dtype=np.uint8)
    if q0:
        quals[::5, ::7] = 0
    starts = np.concatenate(([0], np.cumsum(sizes))).astype(np.int64)
    return codes, quals, starts


def family_batch(sizes, L: int, seed: int):
    """Main-path-like families: one truth per family, 1% substitutions,
    quals 30-40 (the simulator's defaults), ragged 3' ends."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, dtype=np.int64)
    N = int(sizes.sum())
    starts = np.concatenate(([0], np.cumsum(sizes)))
    truth = rng.integers(0, 4, size=(len(sizes), L), dtype=np.uint8)
    codes = np.repeat(truth, sizes, axis=0)
    errs = rng.random((N, L)) < 0.01
    codes[errs] = (codes[errs] + rng.integers(1, 4, int(errs.sum()),
                                               dtype=np.uint8)) % 4
    quals = rng.integers(30, 41, size=(N, L), dtype=np.uint8)
    lens = L - rng.integers(0, 12, size=N)
    tail = np.arange(L)[None, :] >= lens[:, None]
    codes[tail] = 4
    quals[tail] = 0
    return codes, quals, starts


def longtail_sizes(n_fam: int, seed: int):
    rng = np.random.default_rng(seed)
    return np.minimum(50, 1 + (rng.pareto(1.3, n_fam) * 2.5).astype(np.int64))


def amplicon_bam(path, positions: int, molecules: int, copies: int,
                 read_length: int = 100, umi_length: int = 8,
                 umi_error_rate: float = 0.02, paired_umis: bool = False,
                 seed: int = 0):
    """A template-coordinate BAM of amplicon positions: ``molecules`` true
    UMIs a position, ``copies`` paired templates each, every template of a
    position on the same two ends; each UMI base is wrong at
    ``umi_error_rate``. Paired UMIs are 4+4 ("ACGT-TTGA"), half of the
    templates from the BA strand (R1/R2 and the UMI halves swapped).
    Returns the records written."""
    from fgumi_tpu_torch.constants import CODE_TO_BASE
    from fgumi_tpu_torch.io.bam import (BamHeader, BamWriter, FLAG_FIRST,
                                        FLAG_LAST, FLAG_MATE_REVERSE,
                                        FLAG_PAIRED, FLAG_REVERSE)
    from fgumi_tpu_torch.simulate import _build_mapped_record

    rng = np.random.default_rng(seed)
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\t"
             "SS:unsorted:template-coordinate\n"
             "@SQ\tSN:chr1\tLN:10000000\n@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=["chr1"], ref_lengths=[10000000])
    true = rng.integers(0, 4, size=(positions, molecules, umi_length))
    shape = (positions, molecules, copies, umi_length)
    errs = rng.random(shape) < umi_error_rate
    obs = np.where(errs, (true[:, :, None, :] + rng.integers(1, 4, shape)) % 4,
                   true[:, :, None, :])
    umis = CODE_TO_BASE[obs.astype(np.uint8)].reshape(-1, umi_length)
    umis = [u.tobytes() for u in umis]
    ba = (rng.random(positions * molecules * copies) < 0.5) & paired_umis
    half = umi_length // 2
    quals = np.full(read_length, 35, dtype=np.uint8)
    cigar = [("M", read_length)]
    insert = 2 * read_length
    n = 0
    with BamWriter(path, header) as w:
        for p in range(positions):
            start = 100000 + 1000 * p
            r2_pos = start + insert - read_length
            seq1 = CODE_TO_BASE[rng.integers(0, 4, read_length)].tobytes()
            seq2 = CODE_TO_BASE[rng.integers(0, 4, read_length)].tobytes()
            for t in range(molecules * copies):
                k = p * molecules * copies + t
                u = umis[k]
                first, last = FLAG_FIRST, FLAG_LAST
                if paired_umis:
                    u = u[:half] + b"-" + u[half:]
                    if ba[k]:
                        u = u[half + 1:] + b"-" + u[:half]
                        first, last = FLAG_LAST, FLAG_FIRST
                tags = [(b"RG", "Z", b"A"), (b"RX", "Z", u)]
                name = f"a{p}:{t}".encode()
                w.write_record_bytes(_build_mapped_record(
                    name, FLAG_PAIRED | first | FLAG_MATE_REVERSE, 0, start,
                    60, cigar, seq1, quals, 0, r2_pos, insert, tags))
                w.write_record_bytes(_build_mapped_record(
                    name, FLAG_PAIRED | last | FLAG_REVERSE, 0, r2_pos, 60,
                    cigar, seq2, quals, 0, start, -insert, tags))
                n += 2
    return n


def meth_reference_seqs(contigs: int, length: int, seed: int) -> dict:
    """The seeded random reference of the methylation inputs: ``contigs``
    contigs ``chr1``... of ``length`` uniform ACGT bases."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    return {f"chr{i + 1}": acgt[rng.integers(0, 4, length)].tobytes()
            for i in range(contigs)}


def meth_reference(path, contigs: int, length: int, seed: int):
    """Write :func:`meth_reference_seqs` as a FASTA (+ .fai) through the
    port's ``core/reference.write_fasta``; returns the bases written."""
    from fgumi_tpu_torch.core.reference import write_fasta

    seqs = meth_reference_seqs(contigs, length, seed)
    write_fasta(path, seqs)
    return contigs * length


def _convert(frag, methylated, top: bool, mode: str, rng):
    """One strand's conversion of a molecule, in reference orientation:
    the top strand's cytosines (C -> T), the bottom strand's (G -> A).
    ``methylated`` marks the strand's methylated cytosines; EM-Seq
    converts the others, TAPS these, each with p 0.995."""
    base, into = (ord("C"), ord("T")) if top else (ord("G"), ord("A"))
    hit = (~methylated if mode == "em-seq" else methylated) & (frag == base)
    out = frag.copy()
    out[hit & (rng.random(len(frag)) < 0.995)] = into
    return out


def _mutate(seq, rng, rate: float = 0.01):
    """``seq`` with each base replaced by another at ``rate``."""
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    out = seq.copy()
    err = rng.random(len(seq)) < rate
    if err.any():
        idx = np.searchsorted(acgt, out[err])
        out[err] = acgt[(idx + rng.integers(1, 4, int(err.sum()))) % 4]
    return out


def methylation_bam(path, mode: str, molecules: int, ref: dict,
                    duplex: bool = False, templates: int = 5,
                    read_length: int = 100, seed: int = 0):
    """A grouped, mapped EM-Seq or TAPS input over ``ref`` (the bases of
    :func:`meth_reference_seqs`), paired ``read_length`` reads of inserts
    N(200, 30), 1% base errors, quals 25-37, MI and RG tags.

    Simplex (``duplex=False``): ``molecules`` molecules of ``templates``
    templates, half from the bottom strand (R1 reverse), MI ``n``. Duplex:
    each molecule's top strand (MI ``n/A``, R1 forward) and bottom strand
    (``n/B``) with ``templates`` templates each, converted independently
    over one methylation state a CpG site. Conversion is per strand
    molecule (its PCR copies share it, as in a library). Returns the
    records written."""
    from fgumi_tpu_torch.io.bam import (BamHeader, BamWriter, FLAG_FIRST,
                                        FLAG_LAST, FLAG_MATE_REVERSE,
                                        FLAG_PAIRED, FLAG_PROPER_PAIR,
                                        FLAG_REVERSE)
    from fgumi_tpu_torch.simulate import _build_mapped_record

    rng = np.random.default_rng(seed)
    names = list(ref)
    arrs = [np.frombuffer(ref[n], dtype=np.uint8) for n in names]
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             + "".join(f"@SQ\tSN:{n}\tLN:{len(ref[n])}\n" for n in names)
             + "@RG\tID:A\tSM:sample\tLB:lib\n",
        ref_names=names, ref_lengths=[len(ref[n]) for n in names])
    L = read_length
    cigar = [("M", L)]
    mc = (b"MC", "Z", f"{L}M".encode())
    fwd = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_MATE_REVERSE
    rev = FLAG_PAIRED | FLAG_PROPER_PAIR | FLAG_REVERSE
    n = 0
    with BamWriter(path, header) as w:
        for m in range(molecules):
            c = int(rng.integers(len(arrs)))
            contig = arrs[c]
            ins = int(np.clip(round(rng.normal(200, 30)), L, 2 * L + 100))
            s = int(rng.integers(1, len(contig) - ins - 1))
            frag = contig[s:s + ins]
            # a CpG site's state (p 0.75 methylated), held by its C on the
            # top strand and its G on the bottom: site k is the C at
            # reference position s - 1 + k
            site = rng.random(ins + 1) < 0.75
            meth = {True: (frag == ord("C")) & site[1:]
                    & (contig[s + 1:s + ins + 1] == ord("G")),
                    False: (frag == ord("G")) & site[:-1]
                    & (contig[s - 1:s + ins - 1] == ord("C"))}
            strands = ((True, f"{m}/A"), (False, f"{m}/B")) if duplex \
                else ((bool(rng.random() < 0.5), str(m)),)
            for top, mi in strands:
                conv = _convert(frag, meth[top], top, mode, rng)
                tags = [(b"MI", "Z", mi.encode()), (b"RG", "Z", b"A"), mc]
                left, right = s, s + ins - L
                for t in range(templates):
                    name = f"m{m}{'AB'[not top] if duplex else ''}t{t}" \
                        .encode()
                    seq_l = _mutate(conv[:L], rng).tobytes()
                    seq_r = _mutate(conv[ins - L:], rng).tobytes()
                    q_l = rng.integers(25, 38, L).astype(np.uint8)
                    q_r = rng.integers(25, 38, L).astype(np.uint8)
                    # top: R1 forward on the left end; bottom: R1 reverse
                    # on the right end
                    r1_left = top
                    recs = []
                    for is_r1 in (True, False):
                        on_left = is_r1 == r1_left
                        flag = (fwd if on_left else rev) | (
                            FLAG_FIRST if is_r1 else FLAG_LAST)
                        pos, mate = (left, right) if on_left \
                            else (right, left)
                        recs.append(_build_mapped_record(
                            name, flag, c, pos, 60, cigar,
                            seq_l if on_left else seq_r,
                            q_l if on_left else q_r, c, mate,
                            ins if on_left else -ins, tags))
                    for rec in recs:
                        w.write_record_bytes(rec)
                    n += 2
    return n


def main_path_batch(shape, longtail: bool, seed: int):
    """A batch at a main-path shape (rows N, columns L, segments J): J
    consensus reads over about N rows (family sizes N/J, or the longtail
    mix), ragged consensus lengths up to L."""
    N, L, J = shape
    sizes = (longtail_sizes(J, seed) if longtail
             else np.full(J, max(N // J, 1), dtype=np.int64))
    codes, quals, starts = family_batch(sizes, L, seed)
    lens = (L - np.random.default_rng(seed).integers(0, 4, size=J)).astype(
        np.int32)
    return codes, quals, starts, lens


def exact_rows_batch(shape, seed: int):
    """A batch of exactly N rows in J consensus reads (N // J rows each,
    one more in the first N % J) at L columns, ragged lengths up to L: the
    shape of a run whose families vary in size."""
    N, L, J = shape
    sizes = np.full(J, N // J, dtype=np.int64)
    sizes[:N % J] += 1
    codes, quals, starts = family_batch(sizes, L, seed)
    return codes, quals, starts


def check_k1_mapped(chain, dev):
    """K1 checked and timed at ``mapped_chain_400k``'s largest simplex
    batch, its rows exactly."""
    codes, quals, starts = exact_rows_batch(chain["largest_batch"], seed=17)
    return check_wire_kernel(
        f"main_k1_mapped_{len(starts) - 1}seg_{codes.shape[0]}rows_x"
        f"{codes.shape[1]}", codes, quals, starts, dev, timed=True)


def uniform_batch(shape, seed: int):
    """J reads of N // J rows each at L columns (``shape`` (N, L, J)),
    uniform random bases and quals 2-40: almost every column has a
    disagreement (unequal losing lanes)."""
    N, L, J = shape
    rng = np.random.default_rng(seed)
    fam = max(N // J, 1)
    codes = rng.integers(0, 4, size=(J * fam, L), dtype=np.uint8)
    quals = rng.integers(2, 41, size=(J * fam, L), dtype=np.uint8)
    return codes, quals, (np.arange(J + 1) * fam).astype(np.int64)


def wire_kernel_bytes(N: int, L: int, J: int, col_bytes: int) -> int:
    """A wire kernel's bytes, each input read once and each output written
    once: the wire, starts and dictionary, ``col_bytes`` a column (K1: qs
    1 B, depth and errors 2 B each; K1-r also tb, tq 1 B and obs 16 B) and
    the wp plane's quarter byte."""
    return N * L + (J + 1) * 4 + 64 * 4 + J * L * col_bytes + J * (L // 4)


# K1's and K1-r's bytes a column, the wp plane's aside
FULL_COL_BYTES = 1 + 2 + 2
RESIDENT_COL_BYTES = FULL_COL_BYTES + 1 + 1 + 16


# ----------------------------------------------------------------- timing

def _call_ms(fn, warmup: int = 3, reps: int = 25) -> float:
    """Median CUDA-event time of one call, host launch overhead included:
    the events bracket the wrapper, so the device waits for the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_ms(fn, reps: int = 25) -> float:
    """CUDA-event time of ``reps`` back-to-back calls over ``reps``: the
    device's time per call when it, not the host's launch path, is the
    slower side."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, reps: int = 25, kernel: str = None):
    """Device time of one call from torch.profiler over ``reps`` calls:
    with ``kernel``, the mean GPU time of the launches whose name holds it
    (and how many the profiler saw); else the summed GPU time of every
    kernel the calls launched, over ``reps``. None when the profiler
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    seen = 0
    for ev in prof.key_averages():
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0.0))
        if kernel is None:
            total_us += t
        elif kernel in ev.key and t > 0:
            total_us += t
            seen += ev.count
    if kernel is None:
        seen = reps
    if total_us <= 0 or not seen:
        return None, seen
    return total_us / seen / 1e3, seen


def _time(res, run_kernel, run_plain, module, counter: str, symbol: str):
    """Kernel and plain timings into ``res``; the timing launches are not
    the main path's, so the wrapper's count (``module.counter``) is
    restored afterwards. ``res["ops"]`` counts 32-bit operations, held
    against the card's f32 rate outside the tensor cores."""
    launches0 = getattr(module, counter)
    res["device_ms"], res["profiled_launches"] = device_ms(
        run_kernel, kernel=symbol)
    res["plain_device_ms"], _ = device_ms(run_plain)
    res["loop_ms"] = loop_ms(run_kernel)
    res["plain_loop_ms"] = loop_ms(run_plain)
    res["call_ms"] = _call_ms(run_kernel)
    res["plain_call_ms"] = _call_ms(run_plain)
    setattr(module, counter, launches0)
    # the kernel's own time where the profiler saw the device, else the
    # event time of back-to-back calls
    res["ms"] = res["device_ms"] or res["loop_ms"]
    res["plain_ms"] = res["plain_device_ms"] or res["plain_loop_ms"]
    bytes_ms = res["bytes"] / HBM_BYTES_PER_S * 1e3
    ops_ms = res["ops"] / F32_OPS_PER_S * 1e3
    res["bound_ms"] = max(bytes_ms, ops_ms)
    res["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"


# ----------------------------------------------------------------- kernels

def wire_on_device(kern, codes, quals, starts, dev, name):
    import torch

    from fgumi_tpu_torch.ops import wire as W

    w = W.build_wire(torch.from_numpy(codes), torch.from_numpy(quals),
                     kern._delta94)
    check(w is not None, f"{name}: batch unexpectedly needs packed2")
    J = len(starts) - 1
    counts = torch.from_numpy(np.diff(starts)).to(dev)
    seg_ids = torch.repeat_interleave(torch.arange(J, device=dev), counts)
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    return w[0].to(dev), w[1].to(dev), starts_d, seg_ids


def check_wire_kernel(name, codes, quals, starts, dev, timed: bool):
    """K1 vs its plain version on one batch; returns a result dict."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, oracle, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    tables = quality_tables(45, 40)
    kern = ConsensusKernel(tables, dev)
    J = len(starts) - 1
    N, L = codes.shape
    wire, dict64, starts_d, seg_ids = wire_on_device(kern, codes, quals,
                                                      starts, dev, name)
    pre = kern._pre

    def run_kernel():
        return cuda_kernel.consensus_wire_full(wire, starts_d, dict64, pre)

    def run_plain():
        return W.wire_full(wire, seg_ids, dict64, pre, J, J)

    launches0 = cuda_kernel.LAUNCHES
    got = [t.cpu().numpy() for t in run_kernel()]
    torch.cuda.synchronize()
    check(cuda_kernel.LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    cuda_kernel.LAUNCHES = launches0
    ref = [t.cpu().numpy() for t in run_plain()]
    sides = []
    for qs, wp, d, e in (got, ref):
        win, qual, sus = W.unpack_result_split(qs, wp, J)
        sides.append((win, qual, sus, d.view(np.uint16).astype(np.int64),
                      e.view(np.uint16).astype(np.int64)))
    (wk, qk, sk, dk, ek), (wr, qr, sr, dr, er) = sides
    check(np.array_equal(dk, dr), f"{name}: depth differs")
    check(np.array_equal(ek, er), f"{name}: errors differs")
    clean = ~sk & ~sr
    check(np.array_equal(wk[clean], wr[clean]),
          f"{name}: winner differs on non-suspect positions")
    check(np.array_equal(qk[clean], qr[clean]),
          f"{name}: qual differs on non-suspect positions")
    err = max(int(np.abs(dk - dr).max(initial=0)),
              int(np.abs(ek - er).max(initial=0)),
              int(np.abs(wk[clean].astype(int) - wr[clean]).max(initial=0)),
              int(np.abs(qk[clean].astype(int) - qr[clean]).max(initial=0)))
    # both sides through the host completion (oracle patch)
    resolved = []
    for qs, wp, d, e in (got, ref):
        resolved.append(kern._complete_wire_columns(
            qs, wp, d.view(np.uint16), e.view(np.uint16), codes, quals,
            starts))
    for plane, a, b in zip("wqde", resolved[0], resolved[1]):
        check(np.array_equal(a, b), f"{name}: plane {plane} differs after "
                                    "the oracle patch")
    # the resolved planes are the f64 oracle's answer (sampled families)
    rng = np.random.default_rng(J)
    for f in rng.choice(J, size=min(J, 16), replace=False):
        rows = slice(starts[f], starts[f + 1])
        want = oracle.call_family(codes[rows], quals[rows], tables)
        for plane, a, b in zip("wqde", resolved[0], want):
            check(np.array_equal(a[f], b), f"{name}: family {f} plane "
                                           f"{plane} differs from the oracle")
    res = {"kernel": "consensus_wire_full", "name": name, "rows": N, "L": L,
           "families": J, "suspect_kernel": int(sk.sum()),
           "suspect_plain": int(sr.sum()),
           "suspect_only_kernel": int((sk & ~sr).sum()),
           "suspect_only_plain": int((sr & ~sk).sum()), "max_abs_err": err,
           "geometry": cuda_kernel.full_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_full_kernel")}
    if timed:
        res["bytes"] = wire_kernel_bytes(N, L, J, FULL_COL_BYTES)
        # f32 work: 4 lane adds per valid observation, ~48 ops per column
        # (winner, posterior, two-trials, Phred, guard band)
        res["ops"] = 4 * int((codes != 4).sum()) + 48 * J * L
        _time(res, run_kernel, run_plain, cuda_kernel, "LAUNCHES",
              "consensus_wire_full_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def check_resident_kernel(name, codes, quals, starts, dev, timed: bool,
                          min_reads: int = 1, min_qual: int = 40):
    """K1-r vs its plain version on one batch: K1's planes as
    ``check_wire_kernel`` holds them, obs exact and equal to a numpy count
    of the rows, tb/tq exact where neither side is suspect. Returns a
    result dict; ``res["resident"]`` holds the kernel's (tb, tq, obs) on
    the card for the K5 check."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    kern = ConsensusKernel(quality_tables(45, 40), dev)
    J = len(starts) - 1
    N, L = codes.shape
    wire, dict64, starts_d, seg_ids = wire_on_device(kern, codes, quals,
                                                      starts, dev, name)
    pre = kern._pre

    def run_kernel():
        return cuda_kernel.consensus_wire_resident(wire, starts_d, dict64,
                                                   pre, min_reads, min_qual)

    def run_plain():
        return W.wire_resident(wire, seg_ids, dict64, pre, min_reads,
                               min_qual, J, J)

    launches0 = cuda_kernel.RESIDENT_LAUNCHES
    got_d = run_kernel()
    torch.cuda.synchronize()
    check(cuda_kernel.RESIDENT_LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    cuda_kernel.RESIDENT_LAUNCHES = launches0
    got = [t.cpu().numpy() for t in got_d]
    ref = [t.cpu().numpy() for t in run_plain()]
    for k, plane in ((2, "depth"), (3, "errors"), (6, "obs")):
        check(np.array_equal(got[k], ref[k]), f"{name}: {plane} differs")
    valid = codes[:starts[-1]] != 4
    lanes = np.stack([np.add.reduceat(
        (valid & (codes[:starts[-1]] == b)).astype(np.int32), starts[:-1],
        axis=0) for b in range(4)], axis=-1)
    check(np.array_equal(got[6], lanes),
          f"{name}: obs differs from the rows' own counts")
    (wk, qk, sk), (wr, qr, sr) = (W.unpack_result_split(o[0], o[1], J)
                                  for o in (got, ref))
    clean = ~sk & ~sr
    err = 0
    for plane, a, b in (("winner", wk, wr), ("qual", qk, qr),
                        ("tb", got[4], ref[4]), ("tq", got[5], ref[5])):
        check(np.array_equal(a[clean], b[clean]),
              f"{name}: {plane} differs on non-suspect positions")
        err = max(err, int(np.abs(a[clean].astype(int) - b[clean]).max(
            initial=0)))
    resolved = [kern._complete_wire_columns(
        o[0], o[1], o[2].view(np.uint16), o[3].view(np.uint16), codes,
        quals, starts) for o in (got, ref)]
    for plane, a, b in zip("wqde", *resolved):
        check(np.array_equal(a, b), f"{name}: plane {plane} differs after "
                                    "the oracle patch")
    # positions where tb or tq differ at all (suspect ones only: the
    # resident values there are pre-patch and those rows take the host
    # combine)
    differ = (got[4] != ref[4]) | (got[5] != ref[5])
    res = {"kernel": "consensus_wire_resident", "name": name, "rows": N,
           "L": L, "families": J, "suspect_kernel": int(sk.sum()),
           "suspect_plain": int(sr.sum()),
           "tb_tq_differ_suspect": int(differ.sum()), "max_abs_err": err,
           "geometry": cuda_kernel.resident_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_resident_kernel")}
    if timed:
        res["bytes"] = wire_kernel_bytes(N, L, J, RESIDENT_COL_BYTES)
        res["ops"] = 4 * int((codes != 4).sum()) + 52 * J * L
        _time(res, run_kernel, run_plain, cuda_kernel, "RESIDENT_LAUNCHES",
              "consensus_wire_resident_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    res["resident"] = got_d[4:]
    res["starts"] = starts
    return res


def _host_ms(run_host, reps: int = 5) -> float:
    """Median host-clock time of the numpy combine a kernel replaces."""
    times = []
    for _ in range(reps):
        t0 = time.monotonic()
        run_host()
        times.append((time.monotonic() - t0) * 1e3)
    return statistics.median(times)


def _equal_planes(name, got, want, planes, against: str) -> int:
    """Every plane of ``got`` equal to ``want``'s (host arrays); returns
    the largest absolute difference (0)."""
    err = 0
    for plane, g, w in zip(planes, got, want):
        w = np.asarray(w)
        check(g.shape == w.shape and np.array_equal(g, w),
              f"{name}: {plane} differs from {against}")
        err = max(err, int(np.abs(g.astype(np.int64) - w).max(initial=0)))
    return err


def _launch_once(name, run, C, counter: str):
    """One call of a strand-combine wrapper on the card: its results on
    the host, the launch counted once (and the count restored: a check's
    launch is not the main path's)."""
    import torch

    launches0 = getattr(C, counter)
    got = [t.cpu().numpy() for t in run()]
    torch.cuda.synchronize()
    check(getattr(C, counter) == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    setattr(C, counter, launches0)
    return got


DUPLEX_PLANES = ("bases", "quals", "errors")
CODEC_PLANES = ("base", "qual", "depth", "errors", "both", "disagree")


def duplex_bytes(a, b, lens, J: int, L: int) -> int:
    """K5's bytes, each input read once: of every resident row the output
    rows use, tb, tq (1 B) and obs (16 B) at the columns before the
    longest length it is used at; the three index vectors; the three
    planes (6 B a column) written."""
    cols = np.clip(lens, 0, L)
    need = np.zeros(J, dtype=np.int64)
    np.maximum.at(need, a, cols)
    np.maximum.at(need, b, cols)
    K = len(lens)
    return 18 * int(need.sum()) + 3 * 4 * K + 6 * K * L


def distinct_rows(J: int, K: int, rng):
    """a and b (K,) int32 drawing every resident row about equally often,
    each once where 2K <= J: the main path's pairing, in which an output
    row reads its molecule's own two strand rows."""
    rows = rng.permutation(np.resize(np.arange(J), 2 * K))
    return rows[:K].astype(np.int32), rows[K:].astype(np.int32)


def duplex_ops(J: int, L: int, K: int, seed: int, lens_lo: int = 0,
               lens_hi: int = None, distinct: bool = False):
    """K5's inputs as numpy: resident-like tb (codes 0-4), tq (0-93, one in
    ten Q2) and obs (0-4 a lane) of J rows x L, and K output rows pairing
    random rows (``distinct``: as :func:`distinct_rows`) with lengths in
    [lens_lo, lens_hi] (default L + 8; the first three rows 0, L and L + 8
    when that is the range)."""
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 5, size=(J, L), dtype=np.uint8)
    tq = rng.integers(0, 94, size=(J, L), dtype=np.uint8)
    tq[rng.random((J, L)) < 0.1] = 2
    obs = rng.integers(0, 5, size=(J, L, 4)).astype(np.int32)
    idx = (distinct_rows(J, K, rng) if distinct else
           [rng.integers(0, J, size=K).astype(np.int32) for _ in "ab"])
    hi = L + 8 if lens_hi is None else lens_hi
    lens = rng.integers(lens_lo, hi + 1, size=K).astype(np.int32)
    if lens_hi is None and lens_lo == 0:
        lens[:min(K, 3)] = (0, L, L + 8)[:min(K, 3)]
    return tb, tq, obs, idx[0], idx[1], lens


def check_duplex_edges(name, J, L, K, dev, seed):
    """K5 against its plain version on the card at one shape: random
    resident-like arrays and K rows with lengths 0..L+8."""
    import torch

    from fgumi_tpu_torch.ops import combine as C

    ops = [torch.from_numpy(x).to(dev) for x in duplex_ops(J, L, K, seed)]
    got = _launch_once(name, lambda: C.duplex_combine(*ops), C,
                       "DUPLEX_COMBINE_LAUNCHES")
    want = [t.cpu().numpy() for t in C.duplex_combine_plain(*ops)]
    res = {"kernel": "duplex_combine", "name": name, "rows": K, "L": L,
           "segments": J,
           "max_abs_err": _equal_planes(name, got, want, DUPLEX_PLANES,
                                        "the plain version"),
           "geometry": C.launch_geometry("duplex_combine", K, dev),
           "registers": ptxas_registers("duplex_combine_kernel")}
    print(f"kernel check {name}: " + json.dumps(res), flush=True)


def check_codec_edges(name, T, dev):
    """K6 against its plain version on the card at T positions, and a
    misaligned view refused before any launch."""
    import torch

    from fgumi_tpu_torch.ops import combine as C

    ops = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
           for x in codec_strands(T, seed=T, edges=True)]
    got = _launch_once(name, lambda: C.codec_combine(*ops), C,
                       "CODEC_COMBINE_LAUNCHES")
    want = [t.cpu().numpy() for t in C.codec_combine_plain(*ops)]
    res = {"kernel": "codec_combine", "name": name, "positions": T,
           "max_abs_err": _equal_planes(name, got, want, CODEC_PLANES,
                                        "the plain version"),
           "geometry": C.launch_geometry("codec_combine", T, dev),
           "registers": ptxas_registers("codec_combine_kernel")}
    bad = list(ops)
    bad[0] = torch.cat((ops[0][:1], ops[0]))[1:]
    launches0 = C.CODEC_COMBINE_LAUNCHES
    try:
        C.codec_combine(*bad)
        refused = False
    except ValueError:
        refused = True
    check(refused and C.CODEC_COMBINE_LAUNCHES == launches0,
          f"{name}: a misaligned view was not refused before the launch")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)


def combine_phase_test_shapes(dev):
    """K5 and K6 at their edges: K6 at T 1, 15, 16, 17 (the 4-position
    groups, the 16-position planes and the scalar tail) and at
    ``codec_320k``'s largest combine; K5 at 1 and 11,757 rows
    (``duplex_240k``'s largest combine, over 23,724 resident rows) at
    widths 4, 128 and 152."""
    for T in (1, 15, 16, 17, 2678850):
        check_codec_edges(f"k6_test_{T}pos", T, dev)
    for K, J in ((1, 5), (11757, 23724)):
        for L in (4, 128, 152):
            check_duplex_edges(f"k5_test_{K}rows_x{L}", J, L, K, dev,
                               seed=K + L)


def check_duplex_combine(name, k1r, codes, K, dev, L_out):
    """K5 on the card over K1-r's resident (tb, tq, obs) of one batch
    against its plain version on the card and the numpy combine on the
    fetched tb/tq and the source rows: every output exact. ``K`` output
    rows pair segs of the batch (each once where 2K <= J, as on the main
    path) with lengths up to ``L_out``. Returns a result dict, timed."""
    import torch

    from fgumi_tpu_torch.consensus.fast_duplex import combine_rows_host
    from fgumi_tpu_torch.ops import combine as C

    tb, tq, obs = k1r["resident"]
    starts = k1r["starts"]
    J, L = tb.shape
    rng = np.random.default_rng(K)
    a, b = distinct_rows(J, K, rng)
    lens = rng.integers(max(L_out - 8, 0), L_out + 1, size=K).astype(
        np.int32)
    idx = [torch.from_numpy(x).to(dev) for x in (a, b, lens)]

    def run_kernel():
        return C.duplex_combine(tb, tq, obs, *idx)

    def run_plain():
        return C.duplex_combine_plain(tb, tq, obs, *idx)

    got = _launch_once(name, run_kernel, C, "DUPLEX_COMBINE_LAUNCHES")
    tb_h, tq_h = tb.cpu().numpy(), tq.cpu().numpy()

    def run_host():
        return combine_rows_host(tb_h, tq_h, codes, starts, a, b, lens)

    err = _equal_planes(name, got, [t.cpu().numpy() for t in run_plain()],
                        DUPLEX_PLANES, "the plain version")
    err = max(err, _equal_planes(name, got, run_host(), DUPLEX_PLANES,
                                 "the numpy combine"))
    check((got[2] > 0).any(), f"{name}: no error counted")
    res = {"kernel": "duplex_combine", "name": name, "rows": K, "L": L,
           "segments": J, "max_abs_err": err,
           "geometry": C.launch_geometry("duplex_combine", K, dev),
           "registers": ptxas_registers("duplex_combine_kernel"),
           "bytes": duplex_bytes(a, b, lens, J, L),
           # ~40 integer ops a combined column (select/clip, the recount)
           "ops": 40 * int(np.clip(lens, 0, L).sum())}
    _time(res, run_kernel, run_plain, C, "DUPLEX_COMBINE_LAUNCHES",
          "duplex_combine_kernel")
    res["host_ms"] = _host_ms(run_host)
    res["library_ms"] = None
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def codec_strands(T: int, seed: int, edges: bool = False):
    """Two strands' concatenated positions as the codec batch engine
    builds them: ASCII bases (lowercase n pads), quals, depths and errors
    capped at I16_MAX. ``edges``: more N, pads and disagreements, quals
    from 0 (ties and Q2 among them), depths and errors around I16_MAX."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGTNn", np.uint8)
    p = ([0.2, 0.2, 0.2, 0.2, 0.08, 0.12] if edges
         else [0.245, 0.245, 0.245, 0.245, 0.005, 0.015])
    b1 = rng.choice(bases, size=T, p=p)
    b2 = np.where(rng.random(T) < (0.7 if edges else 0.98), b1,
                  rng.choice(bases, size=T, p=p))
    q1 = rng.integers(0 if edges else 2, 94, size=T).astype(np.uint8)
    q2 = rng.integers(0 if edges else 2, 94, size=T).astype(np.uint8)
    if edges:
        tie = rng.random(T) < 0.1
        q2[tie] = q1[tie]
        d1, d2 = (rng.integers(0, 40000, size=T).astype(np.int32)
                  for _ in "ab")
        e1, e2 = ((d * rng.random(T)).astype(np.int32) for d in (d1, d2))
        return b1, b2, q1, q2, d1, d2, e1, e2
    d1 = rng.integers(0, 5, size=T).astype(np.int32)
    d2 = rng.integers(0, 5, size=T).astype(np.int32)
    e1 = (d1 * (rng.random(T) < 0.05)).astype(np.int32)
    e2 = (d2 * (rng.random(T) < 0.05)).astype(np.int32)
    return b1, b2, q1, q2, d1, d2, e1, e2


def check_codec_combine(name, T, dev):
    """K6 on the card against its plain version on the card and
    ``consensus/codec.combine_arrays`` on the same T positions: every
    output exact; also ``codec_combine_device`` (the batch engine's one
    upload and one fetch). Returns a result dict, timed."""
    import torch

    from fgumi_tpu_torch.consensus.codec import combine_arrays
    from fgumi_tpu_torch.ops import combine as C
    from fgumi_tpu_torch.ops.kernel import codec_combine_device

    ops = codec_strands(T, seed=T)
    dev_ops = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
               for x in ops]

    def run_kernel():
        return C.codec_combine(*dev_ops)

    def run_plain():
        return C.codec_combine_plain(*dev_ops)

    def run_host():
        return combine_arrays(*ops)

    got = _launch_once(name, run_kernel, C, "CODEC_COMBINE_LAUNCHES")
    err = _equal_planes(name, got, [t.cpu().numpy() for t in run_plain()],
                        CODEC_PLANES, "the plain version")
    err = max(err, _equal_planes(name, got, run_host(), CODEC_PLANES,
                                 "combine_arrays"))
    launches0 = C.CODEC_COMBINE_LAUNCHES
    staged = codec_combine_device(dev, *ops)
    C.CODEC_COMBINE_LAUNCHES = launches0
    err = max(err, _equal_planes(name, list(staged), got, CODEC_PLANES,
                                 "codec_combine_device's"))
    res = {"kernel": "codec_combine", "name": name, "positions": T,
           "max_abs_err": err,
           "geometry": C.launch_geometry("codec_combine", T, dev),
           "registers": ptxas_registers("codec_combine_kernel"),
           # 8 inputs (4 x 1 B, 4 x 4 B) read once, 6 outputs (1, 1, 4, 4,
           # 1, 1 B) written once a position
           "bytes": T * (20 + 12),
           # ~60 integer ops a position (the select/clip chain)
           "ops": 60 * T}
    _time(res, run_kernel, run_plain, C, "CODEC_COMBINE_LAUNCHES",
          "codec_combine_kernel")
    res["host_ms"] = _host_ms(run_host)
    res["library_ms"] = None
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


class _Opts:
    """Consensus options the filter stage reads."""
    min_reads = MIN_READS_C
    min_consensus_base_quality = MIN_QUAL_C
    produce_per_base_tags = True


def filter_stage(f_min_reads: int, min_base_q: int):
    from fgumi_tpu_torch.consensus.device_filter import SimplexFilterStage
    from fgumi_tpu_torch.consensus.filter import FilterConfig

    cfg = FilterConfig.new([f_min_reads], [0.025], [0.08],
                           min_base_quality=min_base_q,
                           min_mean_base_quality=25.0)
    return SimplexFilterStage(cfg, _Opts())


def check_filter_kernel(name, codes, quals, starts, lens, dev, timed: bool,
                        f_min_reads: int = 3, min_base_q: int = 25):
    """K1-f vs its plain version on one batch; returns a result dict."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, oracle, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    kern = ConsensusKernel(quality_tables(45, 40), dev)
    stage = filter_stage(f_min_reads, min_base_q)
    fp = stage.dev_params
    J = len(starts) - 1
    N, L = codes.shape
    wire, dict64, starts_d, seg_ids = wire_on_device(kern, codes, quals,
                                                      starts, dev, name)
    lens_d = torch.from_numpy(np.asarray(lens, dtype=np.int32)).to(dev)
    emin = torch.from_numpy(fp.emin_tab.astype(np.int32)).to(dev)
    pre = kern._pre
    args = (pre, MIN_READS_C, MIN_QUAL_C, lens_d, fp.min_reads, emin,
            fp.min_base_q, fp.per_base)

    def run_kernel():
        return cuda_kernel.consensus_wire_filter(wire, starts_d, dict64,
                                                 *args)

    def run_plain():
        return W.wire_filter(wire, seg_ids, dict64, *args, J, J)

    launches0 = cuda_kernel.FILTER_LAUNCHES
    got_d = run_kernel()
    torch.cuda.synchronize()
    check(cuda_kernel.FILTER_LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    cuda_kernel.FILTER_LAUNCHES = launches0
    ref_d = run_plain()
    got = [t.cpu().numpy() for t in got_d]
    ref = [t.cpu().numpy() for t in ref_d]
    for k, plane in ((3, "depth"), (4, "errors")):
        check(np.array_equal(got[k], ref[k]), f"{name}: {plane} differs")
    sus_k = got[0][:, W.S_SUSPECT] != 0
    sus_p = ref[0][:, W.S_SUSPECT] != 0
    check(np.array_equal(sus_k, sus_p), f"{name}: suspect flags differ "
          f"(kernel {int(sus_k.sum())}, plain {int(sus_p.sum())})")
    clean = ~sus_k & ~sus_p
    in_len = np.arange(L)[None, :] < np.asarray(lens)[:, None]
    err = 0
    for k, plane in ((1, "fb"), (2, "fq")):
        a = np.where(in_len[clean], got[k][clean], 0).astype(np.int64)
        b = np.where(in_len[clean], ref[k][clean], 0).astype(np.int64)
        check(np.array_equal(a, b), f"{name}: {plane} differs on clean rows")
        err = max(err, int(np.abs(a - b).max(initial=0)))
    a = got[0][clean, :W.S_SUSPECT].astype(np.int64)
    b = ref[0][clean, :W.S_SUSPECT].astype(np.int64)
    check(np.array_equal(a, b), f"{name}: stats differ on clean rows")
    err = max(err, int(np.abs(a - b).max(initial=0)))

    # the host twin over the oracle-patched columns
    w, q, d, e = kern._complete_wire_columns(
        got[5], got[6], got[3].view(np.uint16), got[4].view(np.uint16),
        codes, quals, starts)
    tb, tq = oracle.apply_consensus_thresholds(w, q, d, MIN_READS_C,
                                               MIN_QUAL_C)
    fb_h, fq_h, st_h = stage.host_filter_columns(tb, tq, d, e, lens)
    # each side as the fused route resolves it: clean rows from the device
    # stats and masked columns, suspect rows through the raw-column gather,
    # the ordinary host completion and the host filter pass
    for side, outs, dev_outs in (("kernel", got, got_d),
                                 ("plain", ref, ref_d)):
        st = outs[0].astype(np.int64)
        fb = outs[1].copy()
        fq = outs[2].copy()
        rows = np.nonzero(st[:, W.S_SUSPECT] != 0)[0]
        if len(rows):
            rw, rq, rd, re_ = kern.filter_resolve_suspect_rows(
                dev_outs[1:], rows, starts, codes, quals)
            b2, q2 = oracle.apply_consensus_thresholds(rw, rq, rd,
                                                       MIN_READS_C,
                                                       MIN_QUAL_C)
            fb[rows], fq[rows], st[rows] = stage.host_filter_columns(
                b2, q2, rd, re_, np.asarray(lens)[rows])
        check(np.array_equal(st[:, :W.S_SUSPECT], st_h[:, :W.S_SUSPECT]),
              f"{name}: {side} stats differ from the host twin")
        for plane, x, y in (("fb", fb, fb_h), ("fq", fq, fq_h)):
            check(np.array_equal(np.where(in_len, x, 0),
                                 np.where(in_len, y, 0)),
                  f"{name}: {side} {plane} differs from the host twin")
    res = {"kernel": "consensus_wire_filter", "name": name, "rows": N,
           "L": L, "reads": J, "suspect_rows": int(sus_k.sum()),
           "max_abs_err": err,
           "geometry": cuda_kernel.filter_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_filter_kernel")}
    if timed:
        d16 = np.minimum(got[3].view(np.uint16), 32767)
        touched = len(np.unique(d16[in_len & (d16 > 0)]))
        # each input read once, each output written once: wire, starts,
        # dictionary, lens, the emin entries this data touches; fb, fq, qs
        # (1 B), depth, errors (2 B), wp (1/4 B) per column; a 28 B row
        res["bytes"] = (N * L + 4 * (J + 1) + 256 + 4 * J + 4 * touched
                        + int(J * L * 7.25) + 28 * J)
        # K1's f32 work plus ~12 integer compares/selects per column
        res["ops"] = 4 * int((codes != 4).sum()) + 60 * J * L
        _time(res, run_kernel, run_plain, cuda_kernel, "FILTER_LAUNCHES",
              "consensus_wire_filter_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def hamming_mats(n: int, m: int, L: int, seed: int, alphabet=b"ACGTN-:"):
    rng = np.random.default_rng(seed)
    sym = np.frombuffer(alphabet, np.uint8)
    return rng.choice(sym, size=(n, L)), rng.choice(sym, size=(m, L))


def check_hamming_kernel(name, a, b, dev, timed: bool):
    """K4 vs its plain version on one (n, L) x (m, L) pair, exactly;
    returns a result dict (timed: also its fetch and torch.cdist)."""
    import torch

    from fgumi_tpu_torch.ops import umi_hamming as H

    (n, L), m = a.shape, b.shape[0]
    ad = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    bd = torch.from_numpy(np.ascontiguousarray(b)).to(dev)

    def run_kernel():
        return H.umi_hamming(ad, bd)

    def run_plain():
        return H.hamming_plain(ad, bd)

    launches0 = H.HAMMING_LAUNCHES
    got = run_kernel()
    torch.cuda.synchronize()
    check(H.HAMMING_LAUNCHES == launches0 + 1,
          f"{name}: the wrapper did not count its launch")
    H.HAMMING_LAUNCHES = launches0
    g = got.cpu().numpy()
    r = run_plain().cpu().numpy()
    check(g.dtype == np.int16 and g.shape == (n, m),
          f"{name}: result {g.dtype} {g.shape}")
    err = int(np.abs(g.astype(np.int64) - r).max(initial=0))
    check(err == 0, f"{name}: K4 differs from its plain version by {err}")
    geo = H.launch_geometry(n, m, L, dev)
    tiles = "umi_hamming_kernel" if geo["bit_planes"] else \
        "umi_hamming_bytes_kernel"
    res = {"kernel": "umi_hamming", "name": name, "n": n, "m": m, "L": L,
           "max_abs_err": err, "geometry": geo,
           "registers": ptxas_registers(tiles),
           "planes_pass_registers": ptxas_registers(
               "umi_hamming_planes_kernel")}
    if timed:
        # the fetch as group makes it (into fresh pageable memory), and
        # into a reused pinned buffer; before the profiler runs
        pinned = torch.empty(got.shape, dtype=got.dtype, pin_memory=True)
        for key, fetch in (("fetch_ms", lambda: got.cpu()),
                           ("fetch_pinned_ms", lambda: pinned.copy_(got))):
            times = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fetch()
                times.append((time.perf_counter() - t0) * 1e3)
            res[key] = statistics.median(times)
        res["fetch_bytes"] = 2 * n * m
        # each input byte read once, each int16 output written once; a
        # 4-byte compare (and its count) per output and word
        res["bytes"] = (n + m) * L + 2 * n * m
        res["ops"] = 2 * n * m * -(-L // 4)
        # the device time of the call: every kernel it launches (for L <=
        # 32 the bit planes pass, its one-word memset and the tile kernel)
        _time(res, run_kernel, run_plain, H, "HAMMING_LAUNCHES", None)
        if geo["bit_planes"]:
            res["tile_kernel_ms"], _ = device_ms(
                run_kernel, kernel="umi_hamming_kernel")
            H.HAMMING_LAUNCHES = launches0
        af, bf = ad.float(), bd.float()
        lib = torch.cdist(af, bf, p=0)
        check(torch.equal(lib.to(torch.int16), got),
              f"{name}: torch.cdist(p=0) differs from K4")
        res["library_ms"], _ = device_ms(lambda: torch.cdist(af, bf, p=0))
        res["library_ms"] = res["library_ms"] or loop_ms(
            lambda: torch.cdist(af, bf, p=0))
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def hamming_phase_test_shapes(dev):
    """K4 at its tiling edges, exact against its plain version."""
    cases = (("n1", 1, 5000, 8), ("m1", 2000, 1, 8), ("n1_m1", 1, 1, 9),
             ("L1", 300, 257, 1), ("L3", 129, 1000, 3),
             ("L8", 1030, 2000, 8), ("L9", 1500, 1500, 9),
             ("L71", 700, 1100, 71), ("8191", 8191, 8191, 8),
             *((f"m_mod8_{j}", 130, 1024 + j, 8) for j in range(8)),
             *((f"L{L}_words", 129, 300, L) for L in (4, 5, 15, 16, 17, 32,
                                                      33)),
             ("few_tiles", 100, 300, 8), ("n8191_m9", 8191, 9, 8))
    for name, n, m, L in cases:
        a, b = hamming_mats(n, m, L, seed=n + m + L)
        check_hamming_kernel(f"k4_test_{name}_{n}x{m}x{L}", a, b, dev,
                             timed=False)
    # the bit planes at every mask: all 256 byte values, one repeated byte
    for name, L, alphabet in (("all_bytes", 32, bytes(range(256))),
                              ("all_bytes", 13, bytes(range(256))),
                              ("one_byte", 8, b"\xff")):
        a, b = hamming_mats(700, 1029, L, seed=L, alphabet=alphabet)
        check_hamming_kernel(f"k4_test_{name}_700x1029x{L}", a, b, dev,
                             timed=False)
    same = np.full((1100, 71), ord("A"), np.uint8)
    for name, fill in (("all_equal", "A"), ("all_different", "C")):
        other = np.full((130, 71), ord(fill), np.uint8)
        check_hamming_kernel(f"k4_test_{name}_1100x130x71", same, other,
                             dev, timed=False)


def kernel_phase_test_shapes(dev):
    for n_fam, fam, L in ((7, 3, 48), (65, 3, 100), (129, 2, 48), (4, 40, 32)):
        codes, quals, starts = random_batch(n_fam, fam, L, seed=n_fam + L)
        check_wire_kernel(f"k1_test_{n_fam}x{fam}x{L}", codes, quals,
                          starts, dev, timed=False)
    # K1-f at the JAX package's fused-filter test shapes, ragged lengths,
    # per-base masks and the quality mask; the last also has Q0-class
    # observations (a -inf dictionary entry)
    for n_fam, fam, q0 in ((7, 3, False), (8, 4, False), (9, 5, False),
                           (65, 3, True)):
        L = 48
        codes, quals, starts = random_batch(n_fam, fam, L,
                                            seed=n_fam * 7 + fam, q0=q0)
        lens = np.random.default_rng(fam).integers(L - 7, L + 1,
                                                   size=n_fam)
        check_filter_kernel(f"k1f_test_{n_fam}x{fam}x{L}"
                            + ("_q0" if q0 else ""), codes, quals, starts,
                            lens.astype(np.int32), dev, timed=False,
                            f_min_reads=fam)
    # the tiling edges of both kernels: reads of 1-300 rows in one batch at
    # widths from 4 to 2048 (staged whole or in 32-column strips of row
    # chunks; from 336 on the byte table and the slices of a block pass 48
    # KB of shared memory), Q0-class observations in ragged reads, fewer
    # reads than the persistent grid has warps, and more than one pass of
    # it; K1 also three 600-row families at L 16 (the strip path's chunks);
    # widths 36, 152, 304, 336 and 380 end on a partial 128-column chunk of
    # K1-r's staged planes
    ragged = (5, 300, 1, 50, 2, 5, 1, 50, 300, 2)
    cases = [(f"ragged_x{L}", ragged, L, False, False)
             for L in (4, 36, 152, 304, 336, 380, 2048)]
    cases += [("ragged_x152_q0", ragged, 152, True, False),
              ("1read_x152", (3,), 152, False, False),
              ("37reads_x152", tuple(np.arange(37) % 7 + 1), 152, False,
               False),
              ("40000reads_x152", tuple(np.random.default_rng(4).integers(
                  1, 9, size=40000)), 152, False, True),
              ("deep_3x600_x16", (600, 600, 600), 16, False, False)]
    for name, sizes, L, q0, family in cases:
        seed = len(sizes) + L
        if family:
            codes, quals, starts = family_batch(sizes, L, seed)
        else:
            codes, quals, starts = ragged_batch(sizes, L, seed, q0=q0)
        check_wire_kernel(f"k1_{name}", codes, quals, starts, dev,
                          timed=False)
        check_resident_kernel(f"k1r_{name}", codes, quals, starts, dev,
                              timed=False, min_reads=2, min_qual=30)
        if name.startswith("deep"):
            continue
        lens = np.random.default_rng(seed).integers(
            max(L - 7, 0), L + 1, size=len(sizes)).astype(np.int32)
        check_filter_kernel(f"k1f_{name}", codes, quals, starts, lens, dev,
                            timed=False)


def packed2_kernel_bytes(N: int, L: int, J: int) -> int:
    """K1-p2's bytes, each input read once and each output written once:
    1.25 B a position (a qual byte and a quarter code byte), the starts,
    the two (94,) f32 tables and K1's 5.25 B a column."""
    return (N * L + N * L // 4 + 4 * (J + 1) + 2 * 94 * 4
            + J * L * FULL_COL_BYTES + J * (L // 4))


def packed2_quals(codes, seed: int, lo: int = 2, hi: int = 94):
    """Quals drawn from [lo, hi) a position, 0 at N bases: more than 63
    distinct values, so the batch takes the packed2 layout."""
    rng = np.random.default_rng(seed)
    return np.where(codes == 4, 0, rng.integers(lo, hi, size=codes.shape)
                    ).astype(np.uint8)


def check_packed2_kernel(name, codes, quals, starts, dev, timed: bool):
    """K1-p2 (``cuda_kernel.consensus_wire_packed2``) against its plain
    version ``ops/wire.packed2_full`` on the card on one packed2 batch:
    depth and errors exact, winner and qual exact where neither side is
    suspect, every plane exact after each side's oracle patch and equal to
    the f64 oracle on sampled families; returns a result dict (timed:
    beside its byte bound and the plain version)."""
    import torch

    from fgumi_tpu_torch.ops import cuda_kernel, oracle, wire as W
    from fgumi_tpu_torch.ops.kernel import ConsensusKernel
    from fgumi_tpu_torch.ops.tables import quality_tables

    tables = quality_tables(45, 40)
    kern = ConsensusKernel(tables, dev)
    J = len(starts) - 1
    N, L = codes.shape
    codes_t, quals_t = torch.from_numpy(codes), torch.from_numpy(quals)
    check(W.build_wire(codes_t, quals_t, kern._delta94) is None,
          f"{name}: the batch fits the 1-byte wire")
    cp, q = (t.to(dev) for t in W.pack_codes2(codes_t, quals_t))
    ct, et = kern._device_tables()
    starts_d = torch.from_numpy(starts.astype(np.int32)).to(dev)
    seg_ids = torch.repeat_interleave(
        torch.arange(J, device=dev), torch.from_numpy(np.diff(starts)).to(
            dev))
    n = int(starts[-1])
    pre = kern._pre

    def run_kernel():
        return cuda_kernel.consensus_wire_packed2(cp, q, starts_d, ct, et,
                                                  pre)

    def run_plain():
        return W.packed2_full(cp[:n], q[:n], seg_ids, ct, et, pre, J, J)

    launches0 = cuda_kernel.PACKED2_LAUNCHES
    plain0 = W.PACKED2_LAUNCHES
    got = [t.cpu().numpy() for t in run_kernel()]
    torch.cuda.synchronize()
    check(cuda_kernel.PACKED2_LAUNCHES == launches0 + 1
          and W.PACKED2_LAUNCHES == plain0,
          f"{name}: the wrapper did not count its one launch")
    ref = [t.cpu().numpy() for t in run_plain()]
    cuda_kernel.PACKED2_LAUNCHES = launches0
    W.PACKED2_LAUNCHES = plain0
    sides = []
    for qs, wp, d, e in (got, ref):
        win, qual, sus = W.unpack_result_split(qs, wp, J)
        sides.append((win, qual, sus, d.view(np.uint16).astype(np.int64),
                      e.view(np.uint16).astype(np.int64)))
    (wk, qk, sk, dk, ek), (wr, qr, sr, dr, er) = sides
    check(np.array_equal(dk, dr), f"{name}: depth differs")
    check(np.array_equal(ek, er), f"{name}: errors differs")
    clean = ~sk & ~sr
    check(np.array_equal(wk[clean], wr[clean]),
          f"{name}: winner differs on non-suspect positions")
    check(np.array_equal(qk[clean], qr[clean]),
          f"{name}: qual differs on non-suspect positions")
    err = max(int(np.abs(dk - dr).max(initial=0)),
              int(np.abs(ek - er).max(initial=0)),
              int(np.abs(wk[clean].astype(int) - wr[clean]).max(initial=0)),
              int(np.abs(qk[clean].astype(int) - qr[clean]).max(initial=0)))
    resolved = [kern._complete_wire_columns(
        qs, wp, d.view(np.uint16), e.view(np.uint16), codes, quals, starts)
        for qs, wp, d, e in (got, ref)]
    for plane, a, b in zip("wqde", resolved[0], resolved[1]):
        check(np.array_equal(a, b), f"{name}: plane {plane} differs after "
                                    "the oracle patch")
    rng = np.random.default_rng(J)
    for f in rng.choice(J, size=min(J, 16), replace=False):
        rows = slice(starts[f], starts[f + 1])
        want = oracle.call_family(codes[rows], quals[rows], tables)
        for plane, a, b in zip("wqde", resolved[0], want):
            check(np.array_equal(a[f], b), f"{name}: family {f} plane "
                                           f"{plane} differs from the oracle")
    res = {"kernel": "consensus_wire_packed2", "name": name, "rows": N,
           "L": L, "families": J, "suspect_kernel": int(sk.sum()),
           "suspect_plain": int(sr.sum()),
           "suspect_only_kernel": int((sk & ~sr).sum()),
           "suspect_only_plain": int((sr & ~sk).sum()), "max_abs_err": err,
           "geometry": cuda_kernel.packed2_launch_geometry(L, J, dev),
           "registers": ptxas_registers("consensus_wire_packed2_kernel")}
    if timed:
        res["bytes"] = packed2_kernel_bytes(N, L, J)
        # f32 work: 4 lane adds per valid observation, ~48 ops per column
        res["ops"] = 4 * int((codes != 4).sum()) + 48 * J * L
        _time(res, run_kernel, run_plain, cuda_kernel, "PACKED2_LAUNCHES",
              "consensus_wire_packed2_kernel")
    print(f"kernel check {name}: " + json.dumps(res), flush=True)
    return res


def packed2_phase_test_shapes(dev):
    """K1-p2 at K1's tiling edges with quals 2-93: reads of 0-300 rows in
    one batch (more than one 255-row count chunk), widths 4 to 2,048,
    quals of 94 and over (clamped to the table's last entry), all-N rows,
    Q0-class observations, one read and 40,000 reads."""
    ragged = (5, 300, 0, 1, 50, 2, 256, 0, 5, 1, 50, 300, 2)
    cases = [(f"ragged_x{L}", ragged, L) for L in (4, 36, 100, 152, 304,
                                                   2048)]
    cases += [("1read_x152", (3,), 152),
              ("40000reads_x100", tuple(np.random.default_rng(4).integers(
                  1, 9, size=40000)), 100)]
    for name, sizes, L in cases:
        seed = len(sizes) + L
        codes, _, starts = ragged_batch(sizes, L, seed)
        quals = packed2_quals(codes, seed)
        rng = np.random.default_rng(seed + 1)
        if name.startswith("ragged"):
            # quals of 94-255 but 127 (the layout's no-observation mark)
            high = rng.random(quals.shape) < 0.05
            v = rng.integers(94, 255, size=int(high.sum()))
            quals[high] = v + (v >= 127)
            quals[rng.random(quals.shape) < 0.01] = 0  # Q0-class
            codes[rng.choice(codes.shape[0], size=3, replace=False)] = 4
            quals[codes == 4] = 0
        check_packed2_kernel(f"k1p2_{name}", codes, quals, starts, dev,
                             timed=False)


def kernel_phase_main_path(dev, shapes, k4_shapes, pipeline_shapes):
    """K1 and K1-f at the fast engine's largest batch of each main-path
    run in ``shapes`` ({case: {kind: shape}}) and at the simplex stage's
    largest batch of each ``cuda`` pipeline run (``pipeline_shapes``:
    {key: (kernel, shape)}), K4 at each of ``k4_shapes`` ({key: (n, m,
    L)}), checked and timed."""
    out = {}
    for key, (n, m, L) in k4_shapes.items():
        a, b = hamming_mats(n, m, L, seed=n + m, alphabet=b"ACGT")
        out[key] = check_hamming_kernel(f"main_{key}_{n}x{m}x{L}", a, b, dev,
                                        timed=True)
    for key, kernel, shape, longtail in (
            *((key, kernel, shapes[case][kind], longtail)
              for key, kernel, case, kind, longtail in (
                  ("k1_fixed", "full", "fixed5_1M", "fast", False),
                  ("k1_longtail", "full", "longtail_200k", "fast", True),
                  ("k1f_fixed", "filter", "fixed5_1M", "fused", False),
                  ("k1f_longtail", "filter", "longtail_200k", "fused", True))
              if kind in shapes.get(case, {})),
            *((key, kernel, shape, False)
              for key, (kernel, shape) in pipeline_shapes.items())):
        codes, quals, starts, lens = main_path_batch(shape, longtail,
                                                     seed=len(key))
        name = (f"main_{key}_{len(starts) - 1}seg_{codes.shape[0]}rows"
                f"_x{codes.shape[1]}")
        if kernel == "full":
            out[key] = check_wire_kernel(name, codes, quals, starts, dev,
                                         timed=True)
        elif kernel == "resident":
            out[key] = check_resident_kernel(name, codes, quals, starts, dev,
                                             timed=True)
            out[key]["codes"] = codes
            # uniform bases and quals at the same shape: almost every
            # column with a disagreement
            codes, quals, starts = uniform_batch(shape, seed=len(key))
            out[f"{key}_uniform"] = check_resident_kernel(
                f"main_{key}_uniform_{len(starts) - 1}seg_"
                f"{codes.shape[0]}rows_x{codes.shape[1]}", codes, quals,
                starts, dev, timed=True)
        else:
            out[key] = check_filter_kernel(name, codes, quals, starts, lens,
                                           dev, timed=True)
    return out


# -------------------------------------------------------------- end to end

def records(path):
    from fgumi_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        return [rec.data for rec in r]


def run_simplex(inp: str, out: str, device: str, flags):
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    rc = cli.main(["simplex", "-i", inp, "-o", out, "--device", device,
                   "--stats-json", stats_path, *flags])
    check(rc == 0, f"simplex --device {device} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        return json.load(f)


def reset_counts():
    """Every kernel's launch count to 0 (just before a main-path run)."""
    from fgumi_tpu_torch.ops import combine, cuda_kernel, umi_hamming
    from fgumi_tpu_torch.ops import wire as W

    cuda_kernel.LAUNCHES = 0
    cuda_kernel.FILTER_LAUNCHES = 0
    cuda_kernel.RESIDENT_LAUNCHES = 0
    cuda_kernel.PACKED2_LAUNCHES = 0
    W.PACKED2_LAUNCHES = 0
    combine.DUPLEX_COMBINE_LAUNCHES = 0
    combine.CODEC_COMBINE_LAUNCHES = 0
    umi_hamming.HAMMING_LAUNCHES = 0


def read_counts() -> dict:
    from fgumi_tpu_torch.ops import combine, cuda_kernel, umi_hamming
    from fgumi_tpu_torch.ops import wire as W

    return {"consensus_wire_full": cuda_kernel.LAUNCHES,
            "consensus_wire_filter": cuda_kernel.FILTER_LAUNCHES,
            "consensus_wire_resident": cuda_kernel.RESIDENT_LAUNCHES,
            "consensus_wire_packed2": cuda_kernel.PACKED2_LAUNCHES,
            "packed2_full": W.PACKED2_LAUNCHES,
            "duplex_combine": combine.DUPLEX_COMBINE_LAUNCHES,
            "codec_combine": combine.CODEC_COMBINE_LAUNCHES,
            "umi_hamming": umi_hamming.HAMMING_LAUNCHES}


def e2e_case(name, inp, work, flags, fused: bool, packed2_route=False):
    """cuda run (every count zeroed just before, read just after) + cpu
    run of the same command; records must be identical."""
    out_gpu = os.path.join(work, f"{name}.cuda.bam")
    out_cpu = os.path.join(work, f"{name}.cpu.bam")
    reset_counts()
    st = run_simplex(inp, out_gpu, "cuda", flags)
    counts = read_counts()
    k1 = counts["consensus_wire_full"]
    k1f = counts["consensus_wire_filter"]
    packed2 = counts["consensus_wire_packed2"]
    check(st["device_batches"] > 0, f"{name}: no device batch")
    check(counts["packed2_full"] == 0,
          f"{name}: the plain packed2 version ran on the card")
    if packed2_route:
        check(packed2 > 0, f"{name}: K1-p2 was never launched")
        check(k1 + packed2 >= st["device_batches"],
              f"{name}: {k1} K1 + {packed2} K1-p2 launches < "
              f"{st['device_batches']} device batches")
    elif fused:
        check(st["fused_batches"] > 0, f"{name}: no fused device batch")
        check(k1f >= st["fused_batches"],
              f"{name}: {k1f} K1-f launches < {st['fused_batches']} fused "
              "batches")
    else:
        check(k1 > 0, f"{name}: K1 was never launched")
        check(k1 + packed2 >= st["device_batches"],
              f"{name}: {k1} K1 launches < {st['device_batches']} device "
              "batches")
    st_cpu = run_simplex(inp, out_cpu, "cpu", flags)
    a, b = records(out_gpu), records(out_cpu)
    check(len(a) > 0, f"{name}: no consensus records")
    check(a == b, f"{name}: cuda and cpu records differ")
    wall = st["wall_s"]
    shapes = st["batch_shapes"]
    summary = {
        "case": name, "engine": st["engine"], "flags": flags,
        "input_reads": st["input_reads"],
        "consensus_reads": st["consensus_reads"],
        "records_written": st["records_written"],
        "reads_per_s": st["input_reads"] / wall, "wall_s": wall,
        "host_s": st["host_s"], "device_s": st["device_s"],
        "oracle_patch_s": st["oracle_patch_s"],
        "device_batches": st["device_batches"],
        "fused_batches": st["fused_batches"],
        "packed2_columns_batches": st["packed2_columns_batches"],
        "launches": counts,
        "stats_bytes_fetched": st["stats_bytes_fetched"],
        "rows_gathered": st["rows_gathered"],
        "suspect_positions": st["suspect_positions"],
        "total_positions": st["total_positions"],
        "largest_batch": max(shapes, key=lambda s: s[0]) if shapes else None,
        "cpu_wall_s": st_cpu["wall_s"],
        "cpu_reads_per_s": st_cpu["input_reads"] / st_cpu["wall_s"],
        # inline, one output is held in flight: two dispatches at once
        "in_flight_peak": st.get("device_stats", {}).get("in_flight_peak"),
        "records_identical": True,
    }
    print("e2e " + json.dumps(summary), flush=True)
    summary["out"] = out_gpu
    return summary


GROUP_METRICS = ("family_sizes", "grouping_metrics", "position_group_sizes")


def run_group(inp: str, out: str, device: str, strategy: str, engine: str):
    """One ``group`` run with its ``-M`` metrics files beside ``out`` (in
    this process, or in a worker of the inputs' pool)."""
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    flags = ["--classic"] if engine == "classic" else []
    rc = cli.main(["group", "-i", inp, "-o", out, "--device", device,
                   "--strategy", strategy, "--stats-json", stats_path, "-M",
                   out + ".m", *flags])
    check(rc == 0, f"group --device {device} --strategy {strategy} "
                   f"{' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    check(st["engine"] == engine, f"group ran the {st['engine']} engine, "
                                  f"not {engine}")
    return st


def metrics_files(out: str) -> dict:
    files = {}
    for kind in GROUP_METRICS:
        with open(f"{out}.m.{kind}.txt", "rb") as f:
            files[kind] = f.read()
    return files


def group_case(case, strategy, inp, work, engine, classic=None) -> dict:
    """``group`` on an amplicon input on cuda, between a reset and a read of
    the counts: K4 must have run once per position group (twice for
    paired: the forward and the strand-reversed matrix), so every group
    reached the device threshold. The fast engine's records and metrics
    files must also equal the ``--classic`` run's (``classic``: that
    case's summary). Returns the summary; :func:`group_cpu_check` then
    holds the cpu run to it and prints it."""
    name = f"{case}_{strategy}" + ("_fast" if engine == "fast" else "")
    out_gpu = os.path.join(work, f"{name}.cuda.bam")
    reset_counts()
    st = run_group(inp, out_gpu, "cuda", strategy, engine)
    counts = read_counts()
    k4 = counts["umi_hamming"]
    per_group = 2 if strategy == "paired" else 1
    check(k4 > 0, f"{name}: K4 was never launched")
    check(k4 == st["launches"]["umi_hamming"],
          f"{name}: {k4} K4 launches, the run counted "
          f"{st['launches']['umi_hamming']}")
    check(k4 == per_group * AMPLICONS[case]["positions"],
          f"{name}: {k4} K4 launches for {AMPLICONS[case]['positions']} "
          "position groups")
    check(len(records(out_gpu)) > 0, f"{name}: no records")
    if classic is not None:
        check(records(out_gpu) == records(classic["out"]),
              f"{name}: records differ from the --classic run's")
        check(metrics_files(out_gpu) == metrics_files(classic["out"]),
              f"{name}: metrics files differ from the --classic run's")
    span = st["device_span"]
    return {
        "case": name, "engine": engine, "strategy": strategy,
        "input_reads": st["input_reads"],
        "records_out": st["records_out"],
        "reads_per_s": st["input_reads"] / st["wall_s"],
        "wall_s": st["wall_s"],
        **{k: st[k] for k in ("read_s", "process_s", "write_s") if k in st},
        "device_span_s": span["upload_s"]
        + span["kernel_s"] + span["fetch_s"], "device_span": span,
        "launches": counts, "largest_launch": span["largest"],
        "molecule_ids": sum(int(k) * v
                            for k, v in st["family_sizes"].items()),
        "out": out_gpu, "cpu_args": (inp, os.path.join(
            work, f"{name}.cpu.bam"), "cpu", strategy, engine)}


def group_cpu_check(summary, st_cpu) -> dict:
    """The cpu run of a :func:`group_case` (``st_cpu``: its stats, from
    :func:`run_group` on ``summary["cpu_args"]``): its records, metrics and
    ``-M`` files identical to the cuda run's. Prints the summary (its
    ``e2e`` line) and returns it."""
    name, out_gpu, out_cpu = (summary["case"], summary["out"],
                              summary["cpu_args"][1])
    with open(out_gpu + ".json") as f:
        st = json.load(f)
    check(records(out_gpu) == records(out_cpu),
          f"{name}: cuda and cpu records differ")
    check(st["filter"] == st_cpu["filter"]
          and st["family_sizes"] == st_cpu["family_sizes"],
          f"{name}: cuda and cpu metrics differ")
    check(metrics_files(out_gpu) == metrics_files(out_cpu),
          f"{name}: cuda and cpu metrics files differ")
    summary.update(
        cpu_wall_s=st_cpu["wall_s"],
        cpu_reads_per_s=st_cpu["input_reads"] / st_cpu["wall_s"],
        cpu_device_span=st_cpu["device_span"], records_identical=True,
        metrics_files_identical=True)
    print("e2e " + json.dumps({k: v for k, v in summary.items()
                               if k not in ("out", "cpu_args")}), flush=True)
    return summary


def e2e_phase(paths, work):
    out = {}
    for case in ("fixed5_1M", "longtail_200k"):
        out[case] = {
            "fast": e2e_case(f"{case}_fast", paths[case], work, [], False),
            "fused": e2e_case(f"{case}_fused", paths[case], work,
                              ["--min-reads", "1", "--device-filter",
                               *FILTER_OPTS], True),
        }
    out["classic_50k"] = {"classic": e2e_case(
        "classic_50k", paths["classic_50k"], work, ["--classic"], False)}
    out["many_quals_20k"] = {"fast": e2e_case(
        "many_quals_20k", paths["many_quals_20k"], work, [], False,
        packed2_route=True)}
    return out


def group_phase(paths, work) -> tuple:
    """Each amplicon case on ``--classic`` and then on the fast engine
    (the default), which is held to the classic run; the fast runs also on
    cpu here. Returns (the summaries, those of the classic runs, whose cpu
    runs go to the inputs' pool later: :func:`group_classic_cpu`)."""
    out, classics = {}, []
    for case, strategy in GROUP_RUNS:
        classic = group_case(case, strategy, paths[case], work, "classic")
        out[f"{case}_{strategy}"] = classic
        classics.append(classic)
        fast = group_case(case, strategy, paths[case], work, "fast",
                          classic)
        out[f"{case}_{strategy}_fast"] = group_cpu_check(
            fast, run_group(*fast["cpu_args"]))
    return out, classics


def group_classic_cpu(pool, classics) -> list:
    """The classic runs' cpu runs in the inputs' pool (its workers are idle
    once the inputs are built), beside the phases in this process; pass
    the result to :func:`group_classic_cpu_finish`."""
    return [(s, pool.submit(run_group, *s["cpu_args"])) for s in classics]


def group_classic_cpu_finish(runs):
    for summary, future in runs:
        group_cpu_check(summary, future.result())


def intermediates_dir(case, work):
    """Where the staged run of ``case`` keeps its intermediate BAMs (the
    filter phase reads its consensus BAM, ``cons.bam``)."""
    return os.path.join(work, f"{case}_staged_intermediates")


def run_pipeline(case, label, device, flags, r1, r2, work):
    """One ``pipeline`` run, every count zeroed just before and read just
    after: (output path, its --stats-json, the counts). The staged run
    keeps its intermediates."""
    from fgumi_tpu_torch import cli

    out = os.path.join(work, f"{case}_{label}_{device}.bam")
    stats_path = out + ".json"
    if label == "staged":
        flags = [*flags, "--keep-intermediates", intermediates_dir(case,
                                                                   work)]
    reset_counts()
    rc = cli.main(["pipeline", "-i", r1, r2, *PIPELINE_OPTS, "-o", out,
                   "--device", device, "--stats-json", stats_path, *flags])
    counts = read_counts()
    check(rc == 0, f"pipeline {case} {label} --device {device} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    check(st["launches"] == counts,
          f"{case} {label} {device}: the run counted {st['launches']}, the "
          f"counters {counts}")
    return out, st, counts


def pipeline_case(case, fastq, reads, work):
    """Every run of ``case``: records identical to the first run's, the
    kernels of the path launched on ``cuda`` and nothing on ``cpu``."""
    r1, r2 = fastq
    ref = None
    out = {}
    for label, device, flags in PIPELINE_RUNS[case]:
        path, st, counts = run_pipeline(case, label, device, flags, r1, r2,
                                        work)
        recs = records(path)
        check(len(recs) > 0, f"{case} {label} {device}: no records")
        if ref is None:
            ref = recs
        check(recs == ref, f"{case} {label} {device}: records differ from "
                           "the fused cuda run's")
        if device == "cpu":
            check(not any(counts.values()),
                  f"{case} {label} cpu: a kernel launched: {counts}")
        elif label == "device_filter":
            check(counts["consensus_wire_filter"] > 0,
                  f"{case}: K1-f was never launched")
        else:
            check(counts["consensus_wire_full"] > 0,
                  f"{case} {label}: K1 was never launched")
        if case == "pipeline_k4_50k" and device == "cuda":
            check(counts["umi_hamming"] >= 1,
                  f"{case}: K4 was never launched")
        filt = st["stages"].get("filter")
        if label != "device_filter":
            check(filt is not None and filt["engine"] == "fast"
                  and not filt["rerun_per_record"],
                  f"{case} {label} {device}: the filter stage did not run "
                  f"the batch engine: {filt}")
            check(filt["passed"] == len(recs),
                  f"{case} {label} {device}: filter kept {filt['passed']}, "
                  f"the output holds {len(recs)}")
        wall = st["wall_s"]
        span = st["stages"]["group"]["device_span"]
        simplex_shapes = st["stages"]["simplex"]["batch_shapes"]
        group_dev = span["upload_s"] + span["kernel_s"] + span["fetch_s"]
        simplex_dev = st["stages"]["simplex"]["device_s"]
        summary = {
            "case": f"{case}_{label}", "device": device, "flags": flags,
            "input_reads": reads, "records_out": len(recs),
            "reads_per_s": reads / wall, "wall_s": wall,
            "stage_wall_s": {
                name: st[f"pipeline.stage.{name}.wall_s"] for name in STAGES
                if f"pipeline.stage.{name}.wall_s" in st},
            "group_process_s": st["stages"]["group"]["process_s"],
            "group_device_span_s": group_dev,
            "k4_largest_launch": span["largest"],
            "simplex_largest_batch": max(simplex_shapes, key=lambda s: s[0])
            if simplex_shapes else None,
            "simplex_device_s": simplex_dev,
            "simplex_oracle_patch_s": st["stages"]["simplex"][
                "oracle_patch_s"],
            # host clock around the device work of both stages: an upper
            # bound on the card's busy share of the run
            "device_span_share": (group_dev + simplex_dev) / wall,
            "launches": counts, "fused": st["fused"],
            # the filter stage's own wall (its --stats-json), beside the
            # stage wall above (which, fused, counts from the chain start)
            "filter_engine": filt["engine"] if filt else None,
            "filter_own_wall_s": filt["wall_s"] if filt else None,
            "records_identical": True}
        print("e2e " + json.dumps(summary), flush=True)
        out[f"{label}_{device}"] = dict(summary, out=path)
    return out


def pipeline_phase(paths, work):
    return {case: pipeline_case(case, paths[case], 10 * n, work)
            for case, n in FASTQ.items()}


def run_filter(cons, out, engine):
    """One ``filter`` run with the pipeline's filter-stage options:
    (its --stats-json, the command's wall on the host clock)."""
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    flags = ["--classic"] if engine == "classic" else []
    t0 = time.monotonic()
    rc = cli.main(["filter", "-i", cons, "-o", out, "--min-reads", "3",
                   "--rejects", out + ".rejects.bam", "--stats-json",
                   stats_path, *flags])
    wall = time.monotonic() - t0
    check(rc == 0, f"filter {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    check(st["engine"] == engine and not st["rerun_per_record"],
          f"filter ran the {st['engine']} engine, not {engine}")
    return st, wall


def filter_phase(p400, work):
    """``filter_400k``: the batch engine on the consensus BAM of
    ``pipeline_400k`` (the staged run's ``cons.bam``, whose records the
    fused run's simplex stage streams alike), its kept records identical
    to the pipeline's output; then the batch engine and ``--classic`` on
    its first ``FILTER_CLASSIC_RECORDS`` records (cut at a template):
    records, rejects and counts identical between the engines."""
    cons = os.path.join(intermediates_dir("pipeline_400k", work), "cons.bam")
    n_cons = len(records(cons))
    head = os.path.join(work, "filter_400k_head.bam")
    n_head = split_at_template(cons, head, None, cut=FILTER_CLASSIC_RECORDS)
    runs = {}
    for label, engine, src in (("fast", "fast", cons),
                               ("fast_head", "fast", head),
                               ("classic", "classic", head)):
        out = os.path.join(work, f"filter_400k_{label}.bam")
        st, wall = run_filter(src, out, engine)
        runs[label] = (out, st, wall)
    (fo, fs, fw), (ho, hs, _), (co, cs, cw) = \
        runs["fast"], runs["fast_head"], runs["classic"]
    kept = records(fo)
    check(records(ho) == records(co), "filter_400k: fast and --classic "
                                      "records differ")
    check(records(ho + ".rejects.bam") == records(co + ".rejects.bam"),
          "filter_400k: fast and --classic rejects differ")
    check({k: hs[k] for k in ("total", "passed", "failed", "bases_masked",
                              "rejection_reasons")}
          == {k: cs[k] for k in ("total", "passed", "failed", "bases_masked",
                                 "rejection_reasons")},
          "filter_400k: fast and --classic counts differ")
    check(fs["total"] == n_cons, f"filter_400k: {fs['total']} records "
                                 f"judged of {n_cons}")
    check(kept == records(p400["fused_cuda"]["out"]),
          "filter_400k: records differ from the fused pipeline's output")
    summary = {"case": "filter_400k", "consensus_records": n_cons,
               "kept": fs["passed"], "rejected": fs["failed"],
               "bases_masked": fs["bases_masked"],
               "fast_wall_s": fw, "fast_own_wall_s": fs["wall_s"],
               "classic_records": n_head,
               "classic_wall_s": cw, "classic_own_wall_s": cs["wall_s"],
               "fast_records_per_s": n_cons / fw,
               "classic_records_per_s": n_head / cw,
               "records_identical": True}
    print("e2e " + json.dumps(summary), flush=True)
    return summary


# filter_400k's --classic run (and the batch engine's run it is held to)
# takes its first records, cut at a template, to keep the script in its limit
FILTER_CLASSIC_RECORDS = 20_000
# sort_amplicon: (label, flags) of each run; spills forced so the spill
# workers and the merge's prefetch have runs to work on
SORT_SPILL = ["--max-records-in-ram", "40000"]
SORT_RUNS = (("coordinate_t1", ["--order", "coordinate", "--write-index",
                                "--threads", "1", *SORT_SPILL]),
             ("coordinate_t4", ["--order", "coordinate", "--write-index",
                                "--threads", "4", *SORT_SPILL]),
             ("queryname_t4", ["--order", "queryname", "--threads", "4",
                               *SORT_SPILL]))


def sort_phase(paths, work):
    """``sort_amplicon``: the amplicon BAM (384,000 mapped reads) sorted to
    coordinate order with its BAI at ``--threads`` 1 and 4, and to
    queryname order; the two coordinate runs' records and index files
    identical, and ``sort --verify`` accepting every output."""
    from fgumi_tpu_torch import cli

    inp = paths["amplicon_group"]
    n_in = len(records(inp))
    runs = {}
    for label, flags in SORT_RUNS:
        out = os.path.join(work, f"sort_amplicon_{label}.bam")
        t0 = time.monotonic()
        rc = cli.main(["sort", "-i", inp, "-o", out, *flags])
        wall = time.monotonic() - t0
        check(rc == 0, f"sort {' '.join(flags)} exited {rc}")
        t0 = time.monotonic()
        rc = cli.main(["sort", "-i", out, "--verify", *flags[:2]])
        verify = time.monotonic() - t0
        check(rc == 0, f"sort --verify {' '.join(flags[:2])} exited {rc} on "
                       "the sort's own output")
        runs[label] = (out, wall, verify)
    a, b = runs["coordinate_t1"][0], runs["coordinate_t4"][0]
    recs = records(a)
    check(len(recs) == n_in, f"sort_amplicon: {len(recs)} records of {n_in}")
    check(recs == records(b), "sort_amplicon: --threads 1 and 4 records "
                              "differ")
    with open(a + ".bai", "rb") as f1, open(b + ".bai", "rb") as f2:
        bai = f1.read()
        check(bai == f2.read(), "sort_amplicon: --threads 1 and 4 indexes "
                                "differ")
    check(len(records(runs["queryname_t4"][0])) == n_in,
          "sort_amplicon: queryname output lost records")
    summary = {"case": "sort_amplicon", "records": n_in,
               **{f"{label}_wall_s": w for label, (_, w, _) in runs.items()},
               **{f"{label}_verify_s": v for label, (_, _, v) in runs.items()},
               **{f"{label}_records_per_s": n_in / w
                  for label, (_, w, _) in runs.items()},
               "bai_bytes": len(bai), "records_identical": True,
               "index_identical": True}
    print("e2e " + json.dumps(summary), flush=True)
    return summary


def run_duplex(inp: str, out: str, device: str, flags):
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    rc = cli.main(["duplex", "-i", inp, "-o", out, "--device", device,
                   "--stats-json", stats_path, *flags])
    check(rc == 0, f"duplex --device {device} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        return json.load(f)


def duplex_run(name, inp, work, device, flags):
    """One ``duplex`` run; on ``cuda`` between a reset and a read of the
    launch counts, and K1-r (fast engine: its eligible rows through K5) or
    K1 (``--classic``) launched for every stage-1 batch. Prints its ``e2e``
    line and returns its summary (``out``: the output BAM)."""
    out = os.path.join(work, f"{name}.{device}.bam")
    reset_counts()
    st = run_duplex(inp, out, device, flags)
    counts = read_counts()
    key = ("consensus_wire_full" if st["engine"] == "classic"
           else "consensus_wire_resident")
    k1 = counts[key]
    if device == "cuda":
        check(st["device_batches"] > 0, f"{name}: no device batch")
        check(k1 > 0, f"{name}: {key} was never launched")
        check(k1 + counts["consensus_wire_packed2"]
              >= st["device_batches"] and counts["packed2_full"] == 0,
              f"{name}: {k1} {key} launches < {st['device_batches']} "
              "device batches, or the plain packed2 version ran")
        check(k1 == st["launches"][key],
              f"{name}: {k1} {key} launches, the run counted "
              f"{st['launches'][key]}")
        if st["engine"] == "fast":
            check(st["combine_device_rows"] > 0
                  and counts["duplex_combine"] > 0,
                  f"{name}: no row took the device combine (K5)")
            check(counts["duplex_combine"]
                  == st["launches"]["duplex_combine"],
                  f"{name}: {counts['duplex_combine']} K5 launches, the run "
                  f"counted {st['launches']['duplex_combine']}")
    shapes = st["batch_shapes"]
    wall = st["wall_s"]
    summary = {
        "case": name, "device": device, "engine": st["engine"],
        "flags": flags, "input_reads": st["input_reads"],
        "consensus_reads": st["consensus_reads"],
        "records_written": st["records_written"],
        "reads_per_s": st["input_reads"] / wall, "wall_s": wall,
        "host_s": st["host_s"], "device_s": st["device_s"],
        "oracle_patch_s": st["oracle_patch_s"],
        "combine_s": st["combine_s"],
        "combine_device_rows": st["combine_device_rows"],
        "combine_host_rows": st["combine_host_rows"],
        "combine_device_largest": st["combine_device_largest"],
        "device_share": st["device_s"] / wall,
        "device_batches": st["device_batches"], "launches": counts,
        "k1_launches": k1, "suspect_positions": st["suspect_positions"],
        "total_positions": st["total_positions"],
        "largest_batch": max(shapes, key=lambda s: s[0]) if shapes else None,
        "rejected": st["rejected"]}
    if "filter" in st:
        summary["filter"] = st["filter"]
    print("e2e " + json.dumps(summary), flush=True)
    summary["out"] = out
    return summary


def run_filter_duplex(inp, out, min_reads, engine):
    """``filter`` on duplex records: (records, rejects, its counts)."""
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    flags = ["--classic"] if engine == "classic" else []
    t0 = time.monotonic()
    rc = cli.main(["filter", "-i", inp, "-o", out, "--min-reads", min_reads,
                   "--rejects", out + ".rejects.bam", "--stats-json",
                   stats_path, *flags])
    wall = time.monotonic() - t0
    check(rc == 0, f"filter {min_reads} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    check(st["engine"] == engine, f"filter ran the {st['engine']} engine, "
                                  f"not {engine}")
    counts = {k: st[k] for k in ("total", "passed", "failed",
                                 "bases_masked", "rejection_reasons")}
    return records(out), records(out + ".rejects.bam"), counts, wall


# the per-record filter engine on a duplex or codec run's records takes
# their first records, cut at a template (host only; the batch engine
# filters the whole output)
DUPLEX_FILTER_CLASSIC_RECORDS = 10_000


def duplex_filter_check(case, cons, work):
    """Both filter engines on a duplex (or codec) run's records: the batch
    engine on the whole output, then both on its first
    ``DUPLEX_FILTER_CLASSIC_RECORDS`` records (cut at a template): records,
    rejects, counts and reason counts identical. Returns (the whole run's
    kept records, summary)."""
    min_reads = DUPLEX_FILTER[case]
    fk, _, fc, fw = run_filter_duplex(
        cons, os.path.join(work, f"{case}.filter_fast.bam"), min_reads,
        "fast")
    check(fc["failed"] > 0, f"{case}: filter --min-reads {min_reads} "
                            "rejected nothing")
    head = os.path.join(work, f"{case}.filter_head.bam")
    n_head = split_at_template(cons, head, None,
                               cut=DUPLEX_FILTER_CLASSIC_RECORDS)
    got = {}
    for engine in ("fast", "classic"):
        out = os.path.join(work, f"{case}.filter_head_{engine}.bam")
        got[engine] = run_filter_duplex(head, out, min_reads, engine)
    (hk, hr, hc, _), (ck, cr, cc, cw) = got["fast"], got["classic"]
    check(hk == ck, f"{case}: filter and filter --classic records differ")
    check(hr == cr, f"{case}: filter and filter --classic rejects differ")
    check(hc == cc, f"{case}: filter and filter --classic counts differ")
    summary = {"case": f"{case}_filter", "min_reads": min_reads, **fc,
               "fast_wall_s": fw, "classic_records": n_head,
               "classic_wall_s": cw, "records_identical": True}
    print("e2e " + json.dumps(summary), flush=True)
    return fk, summary


def duplex_strand_shapes(inp):
    """Molecules of an input with one strand only, and strands with one
    R1 read (the single-read host path)."""
    from fgumi_tpu_torch.io.bam import BamReader

    r1 = {}
    with BamReader(inp) as r:
        for rec in r:
            if rec.flag & 0x40:
                key = rec.get_str(b"MI")
                r1[key] = r1.get(key, 0) + 1
    mols = {}
    for mi, n in r1.items():
        mols.setdefault(mi[:-2], []).append(n)
    single_strand = sum(1 for v in mols.values() if len(v) == 1)
    single_read = sum(1 for n in r1.values() if n == 1)
    return single_strand, single_read


def duplex_phase(paths, work):
    """``duplex_240k``, ``duplex_bias_120k`` and ``duplex_classic_24k``:
    every cuda run's records equal the cpu run's (or the fast engine's),
    both filter engines agree on the duplex records, and ``duplex
    --device-filter`` writes exactly ``duplex | filter``'s records."""
    out = {}
    case = "duplex_240k"
    gpu = duplex_run(case, paths[case], work, "cuda", [])
    cpu = duplex_run(case, paths[case], work, "cpu", [])
    check(records(gpu["out"]) == records(cpu["out"]),
          f"{case}: cuda and cpu records differ")
    check(gpu["input_reads"] == 240000, f"{case}: {gpu['input_reads']} "
                                        "input reads")
    kept, _ = duplex_filter_check(case, gpu["out"], work)
    fused = duplex_run(f"{case}_device_filter", paths[case], work, "cuda",
                       ["--device-filter", "--filter-min-reads",
                        DUPLEX_FILTER[case]])
    check(records(fused["out"]) == kept,
          f"{case}: duplex --device-filter differs from duplex | filter")
    out[case] = {"cuda": gpu, "cpu": cpu, "device_filter": fused}

    case = "duplex_bias_120k"
    flags = ["--min-reads", "2", "1", "0"]
    gpu = duplex_run(case, paths[case], work, "cuda", flags)
    cpu = duplex_run(case, paths[case], work, "cpu", flags)
    check(records(gpu["out"]) == records(cpu["out"]),
          f"{case}: cuda and cpu records differ")
    single_strand, single_read = duplex_strand_shapes(paths[case])
    check(single_strand > 0 and single_read > 0,
          f"{case}: {single_strand} single-strand molecules, "
          f"{single_read} single-read strands")
    check(gpu["rejected"].get("InsufficientReads", 0) > 0,
          f"{case}: no InsufficientReads rejects")
    duplex_filter_check(case, gpu["out"], work)
    print("e2e " + json.dumps({"case": f"{case}_shapes",
                               "single_strand_molecules": single_strand,
                               "single_read_strands": single_read,
                               "rejected": gpu["rejected"]}), flush=True)
    out[case] = {"cuda": gpu, "cpu": cpu}

    case = "duplex_classic_24k"
    classic = duplex_run(case + "_classic", paths[case], work, "cuda",
                         ["--classic"])
    fast = duplex_run(case + "_fast", paths[case], work, "cuda", [])
    check(classic["engine"] == "classic" and fast["engine"] == "fast",
          f"{case}: engines {classic['engine']} / {fast['engine']}")
    check(records(classic["out"]) == records(fast["out"]),
          f"{case}: --classic records differ from the fast engine's")
    out[case] = {"classic": classic, "fast": fast}
    return out


def consensus_run(command, name, inp, work, device, flags,
                  on_device: bool = True):
    """One ``simplex`` or ``duplex`` run (``REJ`` in ``flags``: its rejects
    BAM); on ``cuda`` between a reset and a read of the launch counts, a
    wire kernel (K1, K1-r or K1-p2) launched for every device batch and
    the plain packed2 version never; on ``cpu`` no launch. ``on_device``
    False: a run whose engine routes every family to the host oracle (the
    fast duplex engine's per-molecule path, molecules of 64 rows or
    fewer), so no device batch either. Prints its ``e2e`` line and returns
    its summary (``out``, ``rejects``: its BAMs)."""
    out = os.path.join(work, f"{name}.{device}.bam")
    rej = out + ".rejects.bam"
    flags = [rej if f == "REJ" else f for f in flags]
    reset_counts()
    st = (run_simplex if command == "simplex" else run_duplex)(
        inp, out, device, flags)
    counts = read_counts()
    check(st["launches"] == counts,
          f"{name} {device}: the run counted {st['launches']}, the "
          f"counters {counts}")
    wire = (counts["consensus_wire_full"] + counts["consensus_wire_resident"]
            + counts["consensus_wire_packed2"])
    if device == "cuda" and on_device:
        check(st["device_batches"] > 0 and wire >= st["device_batches"],
              f"{name}: {wire} wire kernel launches for "
              f"{st['device_batches']} device batches")
        check(counts["packed2_full"] == 0,
              f"{name}: the plain packed2 version ran on the card")
    else:
        check(not any(counts.values()) and (on_device or not
                                            st["device_batches"]),
              f"{name} {device}: a kernel launched or a batch went to the "
              f"device: {counts}, {st['device_batches']} batches")
    wall = st["wall_s"]
    shapes = st["batch_shapes"]
    summary = {
        "case": name, "command": command, "device": device,
        "engine": st["engine"], "flags": flags,
        "input_reads": st["input_reads"],
        "consensus_reads": st["consensus_reads"],
        "records_written": st["records_written"],
        "reads_per_s": st["input_reads"] / wall, "wall_s": wall,
        "host_s": st["host_s"], "device_s": st["device_s"],
        "oracle_patch_s": st["oracle_patch_s"],
        "device_share": st["device_s"] / wall,
        "device_batches": st["device_batches"], "launches": counts,
        "largest_batch": max(shapes, key=lambda s: s[0]) if shapes else None}
    print("e2e " + json.dumps(summary), flush=True)
    summary["out"] = out
    summary["rejects"] = rej if rej in flags else None
    return summary


def run_filter_flags(inp, out, flags, classic: bool):
    """``filter`` with ``flags`` (and its rejects): (records, rejects,
    --stats-json, wall)."""
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    t0 = time.monotonic()
    rc = cli.main(["filter", "-i", inp, "-o", out, "--rejects",
                   out + ".rejects.bam", "--stats-json", stats_path, *flags,
                   *(["--classic"] if classic else [])])
    wall = time.monotonic() - t0
    check(rc == 0, f"filter {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    return records(out), records(out + ".rejects.bam"), st, wall


def filter_engines_check(case, cons, work, flags, engine):
    """``filter flags`` on ``cons`` by the command's own routing (engine
    ``engine``) and by ``--classic``: records, rejects and counts
    identical."""
    runs = {}
    for classic in (False, True):
        label = "classic" if classic else "default"
        runs[label] = run_filter_flags(
            cons, os.path.join(work, f"{case}.filter.{label}.bam"), flags,
            classic)
    (ka, ra, sa, wa), (kb, rb, sb, wb) = runs["default"], runs["classic"]
    check(sa["engine"] == engine, f"{case}: filter ran the {sa['engine']} "
                                  f"engine, not {engine}")
    check(ka == kb and ra == rb,
          f"{case}: filter records or rejects differ between the engines")
    keys = ("total", "passed", "failed", "bases_masked",
            "rejection_reasons")
    check(all(sa[k] == sb[k] for k in keys),
          f"{case}: filter counts differ between the engines")
    print("e2e " + json.dumps({
        "case": f"{case}_filter", "flags": flags, "engine": engine,
        "records": sa["total"], "kept": sa["passed"], "rejected":
        sa["failed"], "bases_masked": sa["bases_masked"],
        "rejection_reasons": sa["rejection_reasons"], "wall_s": wa,
        "classic_wall_s": wb, "identical": True}), flush=True)
    return ka


def methylation_phase(paths, work):
    """``emseq_simplex_50k`` and ``taps_simplex_50k`` (``simplex --em-seq``
    / ``--taps``) and ``emseq_duplex_24k`` (``duplex --methylation-mode
    em-seq``), each on ``cuda`` and ``cpu`` with records identical and
    methylation tags on them, and ``filter`` on the ``cuda`` records with
    the case's methylation options and ``--ref`` (the per-record engine)
    and with the depth mask alone (the batch engine), each against
    ``--classic``. The duplex case's fast engine takes every molecule down
    its per-molecule path, whose molecules (at most 64 rows) the reference
    routes to the host oracle: it reaches no kernel, so ``duplex
    --classic`` (batches of 1,000 molecules through K1) runs too, on both
    devices, its records identical to the fast engine's."""
    from fgumi_tpu_torch.io.bam import RawRecord

    ref = paths["meth_ref"]
    out = {}
    for case, (command, flags, fflags) in METH_RUNS.items():
        flags = [*flags, "--ref", ref]
        fast = command == "simplex"
        gpu = consensus_run(command, case, paths[case], work, "cuda", flags,
                            on_device=fast)
        cpu = consensus_run(command, case, paths[case], work, "cpu", flags,
                            on_device=fast)
        recs = records(gpu["out"])
        check(len(recs) > 0 and recs == records(cpu["out"]),
              f"{case}: cuda and cpu records differ")
        if not fast:
            for device in ("cuda", "cpu"):
                classic = consensus_run(command, f"{case}_classic",
                                        paths[case], work, device,
                                        [*flags, "--classic"])
                check(records(classic["out"]) == recs,
                      f"{case}: --classic {device} records differ from the "
                      "fast engine's")
        n_in = 24000 if command == "duplex" else 50000
        check(gpu["input_reads"] == n_in,
              f"{case}: {gpu['input_reads']} input reads")
        want = {b"MM", b"ML", b"cu", b"ct"} | (
            {b"am", b"au", b"at", b"bm", b"bu", b"bt"}
            if command == "duplex" else set())
        tags = set()
        for r in recs[:200]:
            tags |= {t for t, _, _ in RawRecord(r)._iter_tags()}
        check(want <= tags, f"{case}: methylation tags missing: "
                            f"{sorted(want - tags)}")
        filter_engines_check(case, gpu["out"], work,
                             [*fflags, "--ref", ref], "classic")
        filter_engines_check(f"{case}_depth", gpu["out"], work,
                             METH_DEPTH_ONLY[command], "fast")
        out[case] = {"cuda": gpu, "cpu": cpu}
    return out


def rejects_phase(paths, work):
    """``--rejects`` on ``cuda`` and ``cpu``: ``simplex --min-reads 2`` on
    ``longtail_200k`` (the fast engine's per-group scan) and ``duplex
    --min-reads 2 1 0`` on ``duplex_rejects_24k`` (the per-molecule
    engine): consensus records and rejects BAMs identical."""
    out = {}
    for case, inp, command, flags in (
            ("rejects_simplex_longtail_200k", "longtail_200k", "simplex",
             ["--min-reads", "2", "--rejects", "REJ"]),
            ("rejects_duplex_24k", "duplex_rejects_24k", "duplex",
             ["--min-reads", "2", "1", "0", "--rejects", "REJ"])):
        gpu = consensus_run(command, case, paths[inp], work, "cuda", flags)
        cpu = consensus_run(command, case, paths[inp], work, "cpu", flags)
        recs, rej = records(gpu["out"]), records(gpu["rejects"])
        check(len(recs) > 0 and recs == records(cpu["out"]),
              f"{case}: cuda and cpu records differ")
        check(len(rej) > 0 and rej == records(cpu["rejects"]),
              f"{case}: cuda and cpu rejects differ (or none)")
        print("e2e " + json.dumps({"case": f"{case}_rejects",
                                   "rejects": len(rej), "records": len(recs),
                                   "identical": True}), flush=True)
        out[case] = {"cuda": gpu, "cpu": cpu}
    return out


def run_codec(inp: str, out: str, device: str, flags):
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    rc = cli.main(["codec", "-i", inp, "-o", out, "--device", device,
                   "--stats-json", stats_path, *flags])
    check(rc == 0, f"codec --device {device} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        return json.load(f)


def codec_run(name, inp, work, device, flags):
    """One ``codec`` run; on ``cuda`` between a reset and a read of the
    launch counts, K1 launched for every stage-1 batch and, on the batch
    engine, K6 for its combines. Prints its ``e2e`` line and returns its
    summary (``out``: the output BAM)."""
    out = os.path.join(work, f"{name}.{device}.bam")
    reset_counts()
    st = run_codec(inp, out, device, flags)
    counts = read_counts()
    k1, k6 = counts["consensus_wire_full"], counts["codec_combine"]
    if device == "cuda":
        check(st["device_batches"] > 0, f"{name}: no device batch")
        check(k1 > 0 and k1 + counts["consensus_wire_packed2"]
              >= st["device_batches"] and counts["packed2_full"] == 0,
              f"{name}: {k1} K1 launches for {st['device_batches']} "
              "device batches, or the plain packed2 version ran")
        if st["engine"] == "fast":
            check(k6 > 0 and k6 == st["launches"]["codec_combine"],
                  f"{name}: {k6} K6 launches, the run counted "
                  f"{st['launches']['codec_combine']}")
    wall = st["wall_s"]
    shapes = st["batch_shapes"]
    summary = {
        "case": name, "device": device, "engine": st["engine"],
        "flags": flags, "input_reads": st["input_reads"],
        "consensus_reads": st["consensus_reads"],
        "records_written": st["records_written"],
        "reads_per_s": st["input_reads"] / wall, "wall_s": wall,
        "host_s": st["host_s"], "device_s": st["device_s"],
        "oracle_patch_s": st["oracle_patch_s"],
        "combine_s": st["combine_s"],
        "combine_positions": st["combine_positions"],
        "combine_largest": st["combine_largest"],
        "device_share": st["device_s"] / wall,
        "device_batches": st["device_batches"], "launches": counts,
        "k1_launches": k1, "k6_launches": k6,
        "suspect_positions": st["suspect_positions"],
        "total_positions": st["total_positions"],
        "largest_batch": max(shapes, key=lambda s: s[0]) if shapes else None,
        "rejected": st["rejected"]}
    print("e2e " + json.dumps(summary), flush=True)
    summary["out"] = out
    return summary


def codec_phase(paths, work):
    """``codec_320k``: ``codec --min-reads 1`` on ``cuda`` and ``cpu``
    (records identical), then both filter engines on the output;
    ``codec_classic_24k``: ``--classic`` against the batch engine, both on
    ``cuda``, records identical."""
    out = {}
    case = "codec_320k"
    flags = ["--min-reads", "1"]
    gpu = codec_run(case, paths[case], work, "cuda", flags)
    cpu = codec_run(case, paths[case], work, "cpu", flags)
    check(records(gpu["out"]) == records(cpu["out"]),
          f"{case}: cuda and cpu records differ")
    check(gpu["input_reads"] == 320000, f"{case}: {gpu['input_reads']} "
                                        "input reads")
    check(gpu["consensus_reads"] > 0, f"{case}: no consensus records")
    duplex_filter_check(case, gpu["out"], work)
    out[case] = {"cuda": gpu, "cpu": cpu}
    case = "codec_classic_24k"
    classic = codec_run(case + "_classic", paths[case], work, "cuda",
                        ["--classic"])
    fast = codec_run(case + "_fast", paths[case], work, "cuda", [])
    check(classic["engine"] == "classic" and fast["engine"] == "fast",
          f"{case}: engines {classic['engine']} / {fast['engine']}")
    check(records(classic["out"]) == records(fast["out"]),
          f"{case}: --classic records differ from the batch engine's")
    out[case] = {"classic": classic, "fast": fast}
    return out


# the staged phase: every run on cuda through the stage runner
# (pipeline.run_stages), its records held to those of the serial cuda run
# of the same input: (name, command, input, serial run, flags)
STAGED_RUNS = (
    ("fixed5_1M_fast_t4", "simplex", "fixed5_1M", "fixed5_1M_fast",
     ["--threads", "4"]),
    # 1 MiB batches: about 290 dispatches, every one through the staging
    # pool with later ones uploaded while earlier ones are in flight
    ("fixed5_1M_fast_t4_1MiB", "simplex", "fixed5_1M", "fixed5_1M_fast",
     ["--threads", "4", "--batch-bytes", "1048576"]),
    ("fixed5_1M_fast_t4_256M", "simplex", "fixed5_1M", "fixed5_1M_fast",
     ["--threads", "4", "--max-memory", "256M"]),
    ("fixed5_1M_fused_t4", "simplex", "fixed5_1M", "fixed5_1M_fused",
     ["--min-reads", "1", "--device-filter", *FILTER_OPTS, "--threads",
      "4"]),
    ("many_quals_20k_t4", "simplex", "many_quals_20k", "many_quals_20k",
     ["--threads", "4"]),
    ("duplex_240k_t4", "duplex", "duplex_240k", "duplex_240k",
     ["--threads", "4"]),
    ("codec_320k_t3", "codec", "codec_320k", "codec_320k",
     ["--min-reads", "1", "--threads", "3"]),
    ("amplicon_group_adjacency_fast_t4", "group", "amplicon_group",
     "amplicon_group_adjacency_fast",
     ["--strategy", "adjacency", "--threads", "4"]),
    ("pipeline_400k_fused_t4", "pipeline", "pipeline_400k",
     "pipeline_400k_fused", ["--threads", "4"]),
)
# the kernels each staged run must launch (the serial run's path)
STAGED_KERNELS = {
    "simplex": ("consensus_wire_full",),
    "fused": ("consensus_wire_filter",),
    "many_quals": ("consensus_wire_packed2",),
    "duplex": ("consensus_wire_resident", "duplex_combine"),
    "codec": ("consensus_wire_full", "codec_combine"),
    "group": ("umi_hamming",),
    "pipeline": ("consensus_wire_full",),
}


# the serial runs' records, read once for every staged run of their input
_SERIAL_RECORDS = {}


def staged_serial_runs(e2e, groups, pipes, duplexes, codecs) -> dict:
    """The serial cuda run of each staged run's input (its summary:
    ``out``, ``reads_per_s``, ``launches``)."""
    return {
        "fixed5_1M_fast": e2e["fixed5_1M"]["fast"],
        "fixed5_1M_fused": e2e["fixed5_1M"]["fused"],
        "many_quals_20k": e2e["many_quals_20k"]["fast"],
        "duplex_240k": duplexes["duplex_240k"]["cuda"],
        "codec_320k": codecs["codec_320k"]["cuda"],
        "amplicon_group_adjacency_fast":
            groups["amplicon_group_adjacency_fast"],
        "pipeline_400k_fused": pipes["pipeline_400k"]["fused_cuda"]}


def staged_run(name, command, inp, serial, flags, work):
    """One staged run on cuda between a reset and a read of the launch
    counts: records identical to the serial run's, the path's kernels
    launched (as often as in the serial run, whose batches are the same,
    unless the batch size differs), and its ``staged`` line with reads/s
    beside the serial run's, the stage busy and blocked seconds and the
    device dispatches. Returns the summary."""
    from fgumi_tpu_torch import cli

    out = os.path.join(work, f"{name}.cuda.bam")
    stats_path = out + ".json"
    if command == "pipeline":
        argv = ["pipeline", "-i", *inp, *PIPELINE_OPTS]
    else:
        argv = [command, "-i", inp]
    reset_counts()
    rc = cli.main([*argv, "-o", out, "--device", "cuda", "--stats-json",
                   stats_path, *flags])
    counts = read_counts()
    check(rc == 0, f"{name}: {command} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        st = json.load(f)
    if serial["out"] not in _SERIAL_RECORDS:
        _SERIAL_RECORDS[serial["out"]] = records(serial["out"])
    check(records(out) == _SERIAL_RECORDS[serial["out"]],
          f"{name}: records differ from the serial cuda run's")
    kind = ("fused" if "--device-filter" in flags else "many_quals"
            if name.startswith("many_quals") else command)
    for kernel in STAGED_KERNELS[kind]:
        check(counts[kernel] > 0, f"{name}: {kernel} was never launched")
    check(counts["packed2_full"] == 0,
          f"{name}: the plain packed2 version ran on the card")
    check(st["launches"] == counts,
          f"{name}: the run counted {st['launches']}, the counters "
          f"{counts}")
    if "--batch-bytes" in flags:
        check(counts["consensus_wire_full"]
              > serial["launches"]["consensus_wire_full"],
              f"{name}: no more K1 launches at 1 MiB batches")
    else:
        check(counts == serial["launches"],
              f"{name}: launches {counts}, the serial run's "
              f"{serial['launches']}")
    own = st["stages"]["simplex"] if command == "pipeline" else st
    threads = int(flags[flags.index("--threads") + 1])
    check(own["threads"] == threads, f"{name}: ran {own['threads']} threads")
    table = own["stage_table"]
    check({"read", "process", "write"} <= set(table["busy_s"]),
          f"{name}: stage table {table}")
    if "--max-memory" in flags:
        limit = (256 << 20) // 2  # half the budget bounds the input queue
        check(0 < table["peak_in_flight_bytes"] <= limit,
              f"{name}: {table['peak_in_flight_bytes']} input bytes in "
              f"flight, the limit {limit}")
    wall = st["wall_s"]
    reads = (10 * FASTQ["pipeline_400k"] if command == "pipeline"
             else st["input_reads"])
    summary = {
        "case": name, "command": command, "flags": flags,
        "input_reads": reads, "reads_per_s": reads / wall, "wall_s": wall,
        "serial_reads_per_s": serial["reads_per_s"],
        "serial_wall_s": serial["wall_s"],
        "serial_in_flight_peak": serial.get("in_flight_peak"),
        "busy_s": table["busy_s"], "blocked_s": table["blocked_s"],
        "queues": {k: table[k] for k in ("q_samples", "q_in_max",
                                         "q_out_max")},
        "peak_in_flight_bytes": table["peak_in_flight_bytes"],
        "device_stats": own["device_stats"], "launches": counts,
        "records_identical": True}
    print("staged " + json.dumps(summary), flush=True)
    return summary


def io_phase(bam: str) -> dict:
    """The parallel BGZF writer and reader on a main-path BAM: its data
    written at one thread and at ``compress_threads()`` threads (bytes
    identical to each other and to ``bam``, which the command wrote; the
    same ``write_indexed`` virtual offsets) and inflated at both (bytes
    identical), each timed once. Prints and returns the ``io`` line."""
    import io as _io

    from fgumi_tpu_torch.io import bgzf

    raw = open(bam, "rb").read()
    threads = bgzf.compress_threads()

    def inflate(t):
        """The data and the seconds spent in read_decoded (the copies
        out of its pieces not counted)."""
        r = bgzf.BgzfReader(_io.BytesIO(raw), threads=t)
        spent = 0.0
        parts = []
        while True:
            t0 = time.monotonic()
            a = r.read_decoded()
            spent += time.monotonic() - t0
            if not len(a):
                return b"".join(parts), spent
            parts.append(a.tobytes())

    def deflate(t, data):
        out = _io.BytesIO()
        w = bgzf.BgzfWriter(out, 1, threads=t)
        t0 = time.monotonic()
        w.write(data)
        w.close()
        return out.getvalue(), time.monotonic() - t0

    data, in_serial = inflate(1)
    data_par, in_par = inflate(threads)
    check(data_par == data, "io: the parallel inflate differs")
    serial, out_serial = deflate(1, data)
    par, out_par = deflate(threads, data)
    check(serial == raw, "io: the serial writer differs from the BAM the "
          "command wrote")
    check(par == serial, f"io: the writer at {threads} threads differs "
          "from the serial writer")
    starts = np.arange(0, len(data) + 1, 9973, dtype=np.int64)
    offs = []
    for t in (1, threads):
        w = bgzf.BgzfWriter(_io.BytesIO(), 1, threads=t)
        offs.append(w.write_indexed(data, starts))
    check(np.array_equal(offs[0], offs[1]),
          "io: write_indexed's virtual offsets differ across threads")
    mb = len(data) / 1e6
    line = {"bam": os.path.basename(bam), "data_mb": mb,
            "compressed_mb": len(raw) / 1e6, "threads": threads,
            "cpu_count": os.cpu_count(),
            "affinity": len(os.sched_getaffinity(0)),
            "deflate_mb_s": {"1": mb / out_serial,
                             str(threads): mb / out_par},
            "inflate_mb_s": {"1": mb / in_serial, str(threads): mb / in_par},
            "bytes_identical": True}
    print("io " + json.dumps(line), flush=True)
    return line


# the observe phase: the kernels' names in a trace's device.dispatch spans
SPAN_KERNELS = {"K1": "consensus_wire_full", "K1-f": "consensus_wire_filter",
                "K1-r": "consensus_wire_resident",
                "K1-p2": "consensus_wire_packed2", "K4": "umi_hamming",
                "K5": "duplex_combine", "K6": "codec_combine"}
# the kernels DeviceStats counts as consensus dispatches
DISPATCH_KERNELS = ("consensus_wire_full", "consensus_wire_filter",
                    "consensus_wire_resident", "consensus_wire_packed2")
# the global options of the traced pipeline runs
OBSERVE_OPTS = ("--trace", "--run-report", "--heartbeat", "--audit-output",
                "--flight-dump-dir")


def trace_summary(path: str, process_span: str = "pipeline.process"):
    """A ``--trace`` file checked as Chrome JSON and summed: span counts,
    the threads that recorded spans, the device.dispatch spans per kernel,
    and the split of ``process_span`` into the device.dispatch and
    device.fetch spans nested in it (same thread, inside its interval)
    and the rest, plus the fetch seconds outside it (resolve threads)."""
    with open(path) as f:
        obj = json.load(f)
    events = obj["traceEvents"]
    check(isinstance(events, list) and events, f"{path}: no traceEvents")
    names = {}
    spans = []
    for e in events:
        check({"name", "ph", "pid", "tid"} <= set(e),
              f"{path}: malformed event {e}")
        if e["ph"] == "M" and e["name"] == "thread_name":
            names[e["tid"]] = e["args"]["name"]
        elif e["ph"] == "X":
            check(e["dur"] >= 0 and "ts" in e, f"{path}: bad span {e}")
            spans.append(e)
    check(not any(e["name"] == "trace.truncated" for e in events),
          f"{path}: the trace was truncated")
    counts = {}
    for e in spans:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    dispatch = {}
    for e in spans:
        if e["name"] == "device.dispatch":
            k = SPAN_KERNELS[e["args"]["what"]]
            dispatch[k] = dispatch.get(k, 0) + 1
    # nesting: device spans inside a process span of the same thread
    proc = {}
    for e in spans:
        if e["name"] == process_span:
            proc.setdefault(e["tid"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    split = {"process_s": sum(b - a for v in proc.values()
                              for a, b in v) / 1e6,
             "dispatch_s": 0.0, "fetch_s": 0.0, "fetch_outside_s": 0.0,
             "dispatch_outside_s": 0.0}
    for e in spans:
        if e["name"] not in ("device.dispatch", "device.fetch"):
            continue
        kind = "dispatch" if e["name"] == "device.dispatch" else "fetch"
        inside = any(a <= e["ts"] and e["ts"] + e["dur"] <= b + 0.2
                     for a, b in proc.get(e["tid"], ()))
        split[f"{kind}_s" if inside else f"{kind}_outside_s"] += \
            e["dur"] / 1e6
    split["rest_s"] = split["process_s"] - split["dispatch_s"] \
        - split["fetch_s"]
    threads = sorted({names.get(e["tid"], "?") for e in spans})
    return {"spans": len(spans), "by_name": counts, "dispatch": dispatch,
            "threads": threads, "split": split}


def _threads_with(summary, prefixes):
    return {p: any(t.startswith(p) for t in summary["threads"])
            for p in prefixes}


def check_traced_run(name, counts, tr, report_path, prefixes):
    """A traced run's trace and run report against its launch counts: one
    device.dispatch span a launch of each kernel, spans on the threads of
    ``prefixes``, a report its validator accepts with a device section
    that agrees with the counts."""
    from fgumi_tpu_torch.observe.report import validate_report

    launched = {k: n for k, n in counts.items() if n and k in
                SPAN_KERNELS.values()}
    check(tr["dispatch"] == launched,
          f"{name}: device.dispatch spans {tr['dispatch']}, launches "
          f"{launched}")
    seen = _threads_with(tr, prefixes)
    check(all(seen.values()), f"{name}: no spans on {seen} "
                              f"(threads {tr['threads']})")
    with open(report_path) as f:
        report = json.load(f)
    errors = validate_report(report)
    check(errors == [], f"{name}: report refused: {errors}")
    check(report["exit_status"] == 0, f"{name}: exit {report['exit_status']}")
    consensus = sum(counts[k] for k in DISPATCH_KERNELS)
    dev = report.get("device", {})
    check(dev.get("dispatches", 0) == consensus,
          f"{name}: the report's device section has {dev.get('dispatches')} "
          f"dispatches, the kernels {consensus}")
    check(report["metrics"].get("device.dispatches", 0) == consensus,
          f"{name}: device.dispatches {report['metrics']}")
    return report


# the latency sums of an observed run's report that the options add
OPTION_COSTS = ("io.output_audit_s", "io.commit_s")


def observe_turns(name, argv, work, observed_opts):
    """The wall of ``argv`` (a command's own ``--stats-json`` wall) plain
    and under ``observed_opts`` in turns on cuda: plain, observed, observed,
    plain. Returns (plain walls, observed walls, the observed runs' report
    sums of :data:`OPTION_COSTS`)."""
    from fgumi_tpu_torch import cli

    walls = {"plain": [], "observed": []}
    costs = []
    for i, kind in enumerate(("plain", "observed", "observed", "plain")):
        base = os.path.join(work, f"turns_{name}_{i}")
        opts = [o.replace("BASE", base) for o in observed_opts] \
            if kind == "observed" else []
        rc = cli.main([*opts, *argv, "-o", base + ".bam", "--device", "cuda",
                       "--stats-json", base + ".json"])
        check(rc == 0, f"turns {name} {kind}: exited {rc}")
        with open(base + ".json") as f:
            walls[kind].append(json.load(f)["wall_s"])
        if kind == "observed":
            with open(base + ".report.json") as f:
                latency = json.load(f).get("latency", {})
            costs.append({k: latency[k]["sum"] for k in OPTION_COSTS
                          if k in latency})
    return walls["plain"], walls["observed"], costs


def observe_pipeline_run(label, plain, r1, r2, flags, work):
    """``pipeline_400k`` fused on cuda under every telemetry option, held
    to the plain run of the pipeline phase (same flags): records, launches,
    the trace and the report. Returns its summary."""
    from fgumi_tpu_torch import cli

    base = os.path.join(work, f"observe_{label}")
    out, tr_path = base + ".bam", base + ".trace.json"
    rpt, dumps = base + ".report.json", base + ".flight"
    reset_counts()
    t0 = time.monotonic()
    rc = cli.main(["--trace", tr_path, "--run-report", rpt, "--heartbeat",
                   "1", "--audit-output", "--flight-dump-dir", dumps,
                   "pipeline", "-i", r1, r2, *PIPELINE_OPTS, "-o", out,
                   "--device", "cuda", "--stats-json", out + ".json",
                   *flags])
    wall = time.monotonic() - t0
    counts = read_counts()
    check(rc == 0, f"observe {label}: pipeline exited {rc}")
    check(records(out) == records(plain["out"]),
          f"observe {label}: records differ from the plain run's")
    check(counts == plain["launches"],
          f"observe {label}: launches {counts}, the plain run's "
          f"{plain['launches']}")
    tr = trace_summary(tr_path)
    report = check_traced_run(f"observe {label}", counts, tr, rpt,
                              ("fgumi-chain-", "fgumi-bgzf"))
    check(not os.path.exists(dumps) or not os.listdir(dumps),
          f"observe {label}: a flight dump on a clean run")
    check(report["latency"]["io.output_audit_s"]["count"] == 1,
          f"observe {label}: the output was not audited")
    with open(out + ".json") as f:
        own_wall = json.load(f)["wall_s"]
    turns_plain, turns_observed, costs = observe_turns(
        f"pipeline_400k_{label}",
        ["pipeline", "-i", r1, r2, *PIPELINE_OPTS, *flags], work,
        ["--trace", "BASE.trace.json", "--run-report", "BASE.report.json",
         "--heartbeat", "1", "--audit-output", "--flight-dump-dir",
         "BASE.flight"])
    summary = {
        "case": f"pipeline_400k_{label}", "options": list(OBSERVE_OPTS),
        "wall_plain_s": plain["wall_s"], "wall_observed_s": own_wall,
        "main_wall_observed_s": wall,
        "turns_plain_s": turns_plain, "turns_observed_s": turns_observed,
        "turns_option_costs_s": costs,
        "stage_wall_plain_s": plain["stage_wall_s"],
        "stage_wall_observed_s": {k: v for k, v in report["stages"].items()
                                  if k in STAGES},
        "overhead": statistics.median(turns_observed)
        / statistics.median(turns_plain) - 1.0,
        "spans": tr["spans"], "by_name": tr["by_name"],
        "dispatch_spans": tr["dispatch"], "launches": counts,
        "threads": tr["threads"], "report_stages": sorted(report["stages"]),
        "report_records": report.get("records"),
        "records_identical": True}
    print("observe " + json.dumps(summary), flush=True)
    return summary


def observe_fault_run(fastq, work):
    """``writer.compress:corrupt-bytes:1.0:1`` under ``--audit-output``:
    exit 5, no output published, one flight dump."""
    from fgumi_tpu_torch import cli
    from fgumi_tpu_torch.observe import flight
    from fgumi_tpu_torch.observe.report import validate_report
    from fgumi_tpu_torch.utils import faults

    base = os.path.join(work, "observe_fault")
    out, rpt, dumps = base + ".bam", base + ".report.json", base + ".flight"
    flight.FLIGHT.reset()
    os.environ["FGUMI_TPU_FAULT"] = "writer.compress:corrupt-bytes:1.0:1"
    faults.reset()
    try:
        rc = cli.main(["--audit-output", "--flight-dump-dir", dumps,
                       "--run-report", rpt, "pipeline", "-i", *fastq,
                       *PIPELINE_OPTS, "-o", out, "--device", "cuda"])
    finally:
        del os.environ["FGUMI_TPU_FAULT"]
        faults.reset()
        flight.FLIGHT.reset()
    check(rc == 5, f"observe fault: exited {rc}, not 5")
    check(not os.path.exists(out), "observe fault: the output was published")
    left = [n for n in os.listdir(work) if n.startswith(".observe_fault")]
    check(left == [], f"observe fault: temporaries left: {left}")
    dump_files = os.listdir(dumps)
    check(len(dump_files) == 1 and "output-integrity" in dump_files[0],
          f"observe fault: flight dumps {dump_files}")
    with open(os.path.join(dumps, dump_files[0])) as f:
        dump = json.load(f)
    check(flight.validate_dump(dump) == [], "observe fault: bad dump")
    with open(rpt) as f:
        report = json.load(f)
    check(validate_report(report) == [] and report["exit_status"] == 5,
          f"observe fault: report {report.get('exit_status')}")
    summary = {"case": "pipeline_k4_50k_audit_fault", "exit": rc,
               "published": False, "flight_dump": dump_files[0],
               "exception": dump["exception"]["type"]}
    print("observe " + json.dumps(summary), flush=True)
    return summary


def observe_split_run(name, argv, serial, work, prefixes):
    """One traced, reported run on cuda for where the time goes: records
    and launches equal to ``serial``'s, the trace held to its launches,
    and the process stage split into dispatch, fetch and the rest."""
    from fgumi_tpu_torch import cli

    base = os.path.join(work, f"observe_{name}")
    out, tr_path, rpt = base + ".bam", base + ".trace.json", \
        base + ".report.json"
    reset_counts()
    t0 = time.monotonic()
    rc = cli.main(["--trace", tr_path, "--run-report", rpt, *argv, "-o",
                   out, "--device", "cuda"])
    wall = time.monotonic() - t0
    counts = read_counts()
    check(rc == 0, f"observe {name}: exited {rc}")
    if serial["out"] not in _SERIAL_RECORDS:
        _SERIAL_RECORDS[serial["out"]] = records(serial["out"])
    check(records(out) == _SERIAL_RECORDS[serial["out"]],
          f"observe {name}: records differ from the serial run's")
    check(counts == serial["launches"],
          f"observe {name}: launches {counts}, the serial run's "
          f"{serial['launches']}")
    tr = trace_summary(tr_path)
    report = check_traced_run(f"observe {name}", counts, tr, rpt, prefixes)
    turns_plain, turns_traced, _ = observe_turns(
        name, argv, work, ["--trace", "BASE.trace.json", "--run-report",
                           "BASE.report.json"])
    summary = {"case": name, "wall_s": wall,
               "serial_wall_s": serial["wall_s"],
               "turns_plain_s": turns_plain, "turns_traced_s": turns_traced,
               "overhead": statistics.median(turns_traced)
               / statistics.median(turns_plain) - 1.0,
               "spans": tr["spans"], "by_name": tr["by_name"],
               "threads": tr["threads"], "split": tr["split"],
               "stages": report["stages"], "launches": counts,
               "latency": {k: v for k, v in report["latency"].items()
                           if k.startswith(("device.", "io.bgzf"))},
               "records_identical": True}
    print("observe_split " + json.dumps(summary), flush=True)
    return summary


def observe_phase(paths, work, pipes, staged, serial_runs):
    """The telemetry layer on the card: ``pipeline_400k`` fused, with and
    without ``--device-filter``, under every telemetry option against the
    pipeline phase's plain runs; the audit fault; ``fixed5_1M_fast`` at
    ``--threads 4`` and the fast ``group`` adjacency run traced, with
    their process stage split."""
    r1, r2 = paths["pipeline_400k"]
    p400 = pipes["pipeline_400k"]
    out = {
        "fused": observe_pipeline_run("fused", p400["fused_cuda"], r1, r2,
                                      [], work),
        "device_filter": observe_pipeline_run(
            "device_filter", p400["device_filter_cuda"], r1, r2,
            ["--device-filter"], work),
        "fault": observe_fault_run(paths["pipeline_k4_50k"], work)}
    t4 = dict(serial_runs["fixed5_1M_fast"],
              launches=staged["fixed5_1M_fast_t4"]["launches"],
              wall_s=staged["fixed5_1M_fast_t4"]["wall_s"])
    out["fixed5_1M_fast_t4"] = observe_split_run(
        "fixed5_1M_fast_t4", ["simplex", "-i", paths["fixed5_1M"],
                              "--threads", "4"], t4, work,
        ("fgumi-reader", "fgumi-worker-", "fgumi-writer", "fgumi-bgzf"))
    out["group_fast"] = observe_split_run(
        "amplicon_group_adjacency_fast",
        ["group", "-i", paths["amplicon_group"], "--strategy", "adjacency"],
        serial_runs["amplicon_group_adjacency_fast"], work,
        ("MainThread", "fgumi-bgzf"))
    return out


# the dedup phase: amplicon_group's input (384,000 reads, 16 position
# groups of up to 5,583 distinct UMIs), dedup -s adjacency with its -m and
# -H files; (label, device, flags), the first the reference run
DEDUP_RUNS = (("fast", "cuda", []), ("fast_cpu", "cpu", []),
              ("classic", "cuda", ["--classic"]),
              ("fast_t4", "cuda", ["--threads", "4"]))


def _child_kwargs(env=None) -> dict:
    """A child process's cwd and environment: the repository root, on its
    ``PYTHONPATH`` too, with ``env`` added."""
    root = os.path.dirname(os.path.abspath(__file__))
    return {"cwd": root, "text": True,
            "env": dict(os.environ, PYTHONPATH=root, **(env or {}))}


def _child(argv, env=None, timeout=900):
    """``python -m fgumi_tpu_torch`` with ``argv`` in a child process,
    waited for."""
    return subprocess.run([sys.executable, "-m", "fgumi_tpu_torch", *argv],
                          capture_output=True, timeout=timeout,
                          **_child_kwargs(env))


def _error_lines(stderr: str) -> list:
    return [ln for ln in stderr.splitlines() if " ERROR " in ln]


def run_dedup(inp: str, out: str, device: str, flags):
    from fgumi_tpu_torch import cli

    stats_path = out + ".json"
    rc = cli.main(["dedup", "-i", inp, "-o", out, "--device", device,
                   "-s", "adjacency", "-m", out + ".m.tsv", "-H",
                   out + ".h.tsv", "--stats-json", stats_path, *flags])
    check(rc == 0, f"dedup --device {device} {' '.join(flags)} exited {rc}")
    with open(stats_path) as f:
        return json.load(f)


def dedup_phase(paths, work, group_fast):
    """``dedup`` on ``amplicon_group``'s input: the batch engine on cuda
    and cpu, ``--classic`` and the batch engine at ``--threads 4`` on cuda,
    each cuda run between a reset and a read of the counts with one K4
    launch a position group (16). Records and the ``-m``/``-H`` files must
    be identical between every run (``records()`` and the bytes here; the
    port's ``compare bams`` and ``compare metrics`` in child processes,
    started here and read by :func:`dedup_compare_finish`). Prints the
    ``dedup`` line; returns (the batch engine's cuda summary, the compare
    children)."""
    inp = paths["amplicon_group"]
    groups = AMPLICONS["amplicon_group"]["positions"]
    runs = {}
    for label, device, flags in DEDUP_RUNS:
        name = f"amplicon_dedup_adjacency_{label}"
        out = os.path.join(work, f"{name}.bam")
        reset_counts()
        st = run_dedup(inp, out, device, flags)
        counts = read_counts()
        check(st["engine"] == ("classic" if "--classic" in flags
                               else "fast"),
              f"{name}: ran the {st['engine']} engine")
        check(counts == st["launches"],
              f"{name}: the run counted {st['launches']}, the counters "
              f"{counts}")
        k4 = counts["umi_hamming"]
        check(k4 == (groups if device == "cuda" else 0),
              f"{name}: {k4} K4 launches for {groups} position groups")
        check(st["device_span"]["calls"] == groups,
              f"{name}: {st['device_span']['calls']} distance calls")
        runs[label] = {"name": name, "out": out, "stats": st,
                       "launches": counts}
    ref = runs["fast"]
    want = records(ref["out"])
    check(len(want) == ref["stats"]["input_reads"] == 384000,
          f"dedup: {len(want)} records of {ref['stats']['input_reads']}")
    files = {}
    for label, run in runs.items():
        for kind in ("m", "h"):
            with open(f"{run['out']}.{kind}.tsv", "rb") as f:
                files[(label, kind)] = f.read()
        if label != "fast":
            check(records(run["out"]) == want,
                  f"{run['name']}: records differ from the cuda batch "
                  "engine's")
            check(files[(label, "m")] == files[("fast", "m")]
                  and files[(label, "h")] == files[("fast", "h")],
                  f"{run['name']}: -m/-H files differ")
    procs = []
    for label, run in runs.items():
        if label == "fast":
            continue
        for kind, a, b in (("bams", ref["out"], run["out"]),
                           ("metrics", ref["out"] + ".m.tsv",
                            run["out"] + ".m.tsv"),
                           ("metrics", ref["out"] + ".h.tsv",
                            run["out"] + ".h.tsv")):
            procs.append((f"{label} {kind} {os.path.basename(b)}",
                          subprocess.Popen(
                              [sys.executable, "-m", "fgumi_tpu_torch",
                               "compare", kind, "-a", a, "-b", b],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              **_child_kwargs())))
    m = ref["stats"]["metrics"]
    summary = {
        "case": "amplicon_dedup_adjacency", "input_reads": len(want),
        "templates": m["total_templates"],
        "duplicate_rate": m["duplicate_rate"],
        "runs": {label: {
            "engine": r["stats"]["engine"], "device": r["stats"]["device"],
            "threads": r["stats"].get("threads", 0),
            "reads_per_s": r["stats"]["input_reads"] / r["stats"]["wall_s"],
            "wall_s": r["stats"]["wall_s"],
            **{k: r["stats"][k] for k in ("read_s", "process_s", "write_s")
               if k in r["stats"]},
            "k4_launches": r["launches"]["umi_hamming"],
            "device_span": r["stats"]["device_span"]}
            for label, r in runs.items()},
        "group_fast_reads_per_s": group_fast["reads_per_s"],
        "records_identical": True, "metrics_files_identical": True}
    print("dedup " + json.dumps(summary), flush=True)
    out = dict(summary, launches=ref["launches"],
               largest_launch=ref["stats"]["device_span"]["largest"])
    return out, procs


def dedup_compare_finish(procs):
    """Every ``compare`` child of the dedup phase exited 0 with its match
    line; prints the ``dedup_compare`` line."""
    results = {}
    for what, proc in procs:
        _, err = proc.communicate(timeout=900)
        last = err.strip().splitlines()[-1] if err.strip() else ""
        results[what] = {"rc": proc.returncode, "line": last}
        check(proc.returncode == 0 and "match" in last,
              f"dedup compare {what}: exit {proc.returncode}: {last}")
    print("dedup_compare " + json.dumps(results), flush=True)


# the resilience phase's injected faults, each in a child process on cuda:
# (name, command, input, flags, clean run, FGUMI_TPU_FAULT, exit code)
def resilience_cases(paths, e2e, duplexes):
    lt, ltf = e2e["longtail_200k"]["fast"], e2e["longtail_200k"]["fused"]
    fused = ["--min-reads", "1", "--device-filter", *FILTER_OPTS]
    return (
        ("longtail_200k_fast retry", "simplex", paths["longtail_200k"], [],
         lt, "device.dispatch:raise:1.0:2", 0),
        ("longtail_200k_fast oom", "simplex", paths["longtail_200k"], [], lt,
         "device.dispatch:oom:1.0:1", 0),
        ("longtail_200k_fast unbounded", "simplex", paths["longtail_200k"],
         [], lt, "device.dispatch:raise:1.0", 3),
        ("longtail_200k_fused oom", "simplex", paths["longtail_200k"], fused,
         ltf, "device.dispatch:oom:1.0:1", 0),
        ("duplex_bias_120k oom", "duplex", paths["duplex_bias_120k"],
         ["--min-reads", "2", "1", "0"], duplexes["duplex_bias_120k"]["cuda"],
         "device.dispatch:oom:1.0:1", 0),
        ("many_quals_20k oom", "simplex", paths["many_quals_20k"], [],
         e2e["many_quals_20k"]["fast"], "device.dispatch:oom:1.0:1", 0))


def fault_run(name, command, inp, flags, clean, spec, rc_want, work):
    """One injected-fault run in a child process: its exit code; at 0 its
    records equal to the clean cuda run's and the retry or split counted
    (an out-of-memory of the simplex wire route: one more K1 launch); at 3
    nothing published and one error line. Returns its summary."""
    out = os.path.join(work, "res_" + name.replace(" ", "_") + ".bam")
    stats_path = out + ".json"
    t0 = time.monotonic()
    p = _child([command, "-i", inp, "-o", out, "--device", "cuda",
                "--stats-json", stats_path, *flags],
               {"FGUMI_TPU_FAULT": spec})
    wall = time.monotonic() - t0
    errors = _error_lines(p.stderr)
    check(p.returncode == rc_want,
          f"{name} [{spec}]: exit {p.returncode}, want {rc_want}: "
          f"{p.stderr[-2000:]}")
    summary = {"case": name, "fault": spec, "exit": p.returncode,
               "child_wall_s": wall}
    if rc_want:
        base = os.path.basename(out)
        leftovers = [f for f in os.listdir(work)
                     if f.startswith((base, f".{base}"))]
        check(leftovers == [], f"{name} [{spec}]: published {leftovers}")
        check(len(errors) == 1, f"{name} [{spec}]: error lines {errors}")
        summary.update(error_line=errors[0], published=False)
        return summary
    check(errors == [], f"{name} [{spec}]: error lines {errors}")
    with open(stats_path) as f:
        st = json.load(f)
    dev = st["device_stats"]
    check(records(out) == records(clean["out"]),
          f"{name} [{spec}]: records differ from the clean cuda run's")
    launches = st["launches"]
    if "raise" in spec:
        check("retry" in p.stderr and dev.get("dispatch_retries") == 2,
              f"{name} [{spec}]: retries {dev.get('dispatch_retries')}")
        check(launches == clean["launches"],
              f"{name} [{spec}]: launches {launches}, the clean run's "
              f"{clean['launches']}")
    else:
        check("halving" in p.stderr and dev.get("batch_splits", 0) >= 1,
              f"{name} [{spec}]: splits {dev.get('batch_splits')}")
        if command == "simplex" and not flags:
            # the halves launch in place of the batch: one launch more
            # (a half of a packed2 batch with at most 63 distinct quals
            # takes K1)
            wire = ("consensus_wire_full", "consensus_wire_packed2")
            got = sum(launches[k] for k in wire)
            was = sum(clean["launches"][k] for k in wire)
            check(got == was + 1,
                  f"{name} [{spec}]: {got} K1 and K1-p2 launches, the clean "
                  f"run's {was}")
    if command == "duplex" and "oom" in spec:
        # the halves launch K1-r in place of the batch and their resident
        # arrays are joined: the strand combine runs on K5 as in the clean
        # run
        wire = ("consensus_wire_full", "consensus_wire_resident",
                "consensus_wire_packed2")
        got = sum(launches[k] for k in wire)
        was = sum(clean["launches"][k] for k in wire)
        check(got == was + 1,
              f"{name} [{spec}]: {got} wire launches, the clean run's {was}")
        for key in ("combine_device_rows", "combine_host_rows"):
            check(st[key] == clean[key],
                  f"{name} [{spec}]: {key} {st[key]}, the clean run's "
                  f"{clean[key]}")
        check(launches["duplex_combine"] == clean["launches"]["duplex_combine"],
              f"{name} [{spec}]: {launches['duplex_combine']} K5 launches, "
              f"the clean run's {clean['launches']['duplex_combine']}")
    summary.update(records_identical=True, launches=launches,
                   dispatch_retries=dev.get("dispatch_retries", 0),
                   batch_splits=dev.get("batch_splits", 0),
                   halving=[ln.split(": ", 1)[-1]
                            for ln in p.stderr.splitlines()
                            if "halving" in ln][:2])
    return summary


# a child that caps the caching allocator, runs the port's CLI and writes
# the peak reserved and allocated bytes: argv fraction, report path, then
# the CLI's arguments
_CAPPED_CHILD = """
import json, sys, torch
frac = float(sys.argv[1])
if frac > 0:
    torch.cuda.set_per_process_memory_fraction(frac, 0)
from fgumi_tpu_torch.cli import main
rc = main(sys.argv[3:])
with open(sys.argv[2], "w") as f:
    json.dump({"rc": rc, "max_reserved": torch.cuda.max_memory_reserved(),
               "max_allocated": torch.cuda.max_memory_allocated()}, f)
sys.exit(rc)
"""
# record batches of up to 256 MiB (the whole input in one or two): their
# tensors are past the caching allocator's 10 MiB mark, which it rounds to
# 2 MiB (smaller requests take 20 MiB segments, too coarse for a cap
# between half and all of a batch)
REAL_OOM_BATCH = ["--batch-bytes", str(256 << 20)]
REAL_OOM_FRACTIONS = (0.95, 0.85, 0.75, 0.65)


def capped_run(label, inp, work, cap_bytes):
    """``simplex`` on ``inp`` in a child whose allocator is capped at
    ``cap_bytes`` (0: no cap): (exit code, stderr, report, stats, out)."""
    import torch

    total = torch.cuda.get_device_properties(0).total_memory
    out = os.path.join(work, f"res_real_oom_{label}.bam")
    report = out + ".mem.json"
    p = subprocess.run(
        [sys.executable, "-c", _CAPPED_CHILD, repr(cap_bytes / total),
         report, "simplex", "-i", inp, "-o", out, "--device", "cuda",
         "--stats-json", out + ".json", *REAL_OOM_BATCH],
        capture_output=True, timeout=900, **_child_kwargs())
    rep = st = None
    if os.path.exists(report):
        with open(report) as f:
            rep = json.load(f)
    if p.returncode == 0:
        with open(out + ".json") as f:
            st = json.load(f)
    return p.returncode, p.stderr, rep, st, out


def real_oom_case(inp, work, clean_fast, pool):
    """A real ``torch.cuda.OutOfMemoryError``: ``longtail_200k``'s input in
    256 MiB record batches, first uncapped (its peak reserved and
    allocated bytes; the largest batch's device bytes from its wire upload
    and K1's outputs), then at caps of :data:`REAL_OOM_FRACTIONS` of those
    bytes at once. A cap passes when its run halved on a
    real out-of-memory, exited 0 and wrote the clean run's records; at
    least one must pass, else the phase fails. Returns its summary."""
    rc, err, rep, st, out = capped_run("clean", inp, work, 0)
    check(rc == 0, f"real_oom clean run exited {rc}: {err[-2000:]}")
    want = records(clean_fast["out"])
    check(records(out) == want,
          "real_oom: one batch's records differ from 16 MiB batches'")
    # the largest batch's device bytes: its wire upload and K1's outputs
    N, L, J = max(st["batch_shapes"], key=lambda s: s[0] * s[1])
    batch_bytes = wire_kernel_bytes(N, L, J, FULL_COL_BYTES)
    caps = [int(f * batch_bytes) for f in REAL_OOM_FRACTIONS]
    futs = {cap: pool.submit(capped_run, f"cap{cap}", inp, work, cap)
            for cap in caps}
    attempts, passed = [], None
    for cap, fut in futs.items():
        rc, err, rep_c, st_c, out_c = fut.result()
        halving = [ln.split(": ", 1)[-1] for ln in err.splitlines()
                   if "halving" in ln]
        real = any("CUDA out of memory" in h for h in halving)
        ok = (rc == 0 and real and st_c["device_stats"].get(
            "batch_splits", 0) >= 1 and records(out_c) == want)
        attempts.append({
            "cap_bytes": cap, "cap_of_batch": cap / batch_bytes, "exit": rc,
            "batch_splits": (st_c or {}).get("device_stats", {}).get(
                "batch_splits"), "real_oom": real, "passed": ok,
            "max_reserved": (rep_c or {}).get("max_reserved"),
            "last_error": (_error_lines(err) or [""])[-1][-300:],
            "halving": halving[:2]})
        if ok and passed is None:
            passed = attempts[-1]
    summary = {"case": "longtail_200k real_oom",
               "batches": st["batch_shapes"], "largest": [N, L, J],
               "batch_device_bytes": batch_bytes,
               "uncapped_max_reserved": rep["max_reserved"],
               "uncapped_max_allocated": rep["max_allocated"],
               "attempts": attempts, "passed": passed}
    check(passed is not None,
          f"real_oom: no cap raised a real out-of-memory that halved and "
          f"matched: {json.dumps(summary)}")
    return summary


def resilience_phase(paths, work, e2e, duplexes):
    """The device resilience of the port, every run a child process on
    cuda that names its fault in its ``resilience`` line: the injected
    faults of :func:`resilience_cases` and the real out-of-memory of
    :func:`real_oom_case`, run side by side (no time is read here)."""
    with cf.ThreadPoolExecutor(max_workers=8) as pool:
        futs = [pool.submit(fault_run, *case, work)
                for case in resilience_cases(paths, e2e, duplexes)]
        # its capped runs go to the same pool once the fault runs free it
        real_fut = pool.submit(real_oom_case, paths["longtail_200k"], work,
                               e2e["longtail_200k"]["fast"], pool)
        results = []
        for f in futs + [real_fut]:
            results.append(f.result())
            print("resilience " + json.dumps(results[-1]), flush=True)
    return results


# the mapped phase: the front half of the reference's documented workflow
# on the port's host commands (extract => correct => fastq => aligner =>
# zipper => sort/merge => group => simplex => filter), a stand-in aligner
# in this script in the aligner's place; and correct at a sample's size
CORRECT_SIM = ["-n", "1000000", "--num-umis", "1000", "-u", "8", "-l", "100",
               "--max-errors", "2", "--seed", "52"]
# correct_1M's --classic run (and the batch engine's run it is held to)
# takes its first reads, cut at a template, to keep the script in its limit
CORRECT_CLASSIC_READS = 100_000
# and the chain's zipper --classic run its first aligned records
ZIPPER_CLASSIC_RECORDS = 50_000
MAPPED_SIM = ["--num-families", "40000", "--family-size", "5",
              "--read-length", "100", "--seed", "53"]
# the stand-in aligner's reference: four contigs, ten families a position
# (a capture panel's targets), each pair's insert that of simulate
# fastq-reads (1.8 read lengths)
MAPPED_CONTIGS = 4
MAPPED_CONTIG_LEN = 1_000_000
FAMILIES_PER_POSITION = 10


def _cli_wall(argv, env=None) -> float:
    """One run of the port's CLI in this process: its wall (exit 0
    required); ``env`` is set around it."""
    from fgumi_tpu_torch import cli

    old = {k: os.environ.get(k) for k in (env or {})}
    os.environ.update(env or {})
    try:
        t0 = time.monotonic()
        rc = cli.main(argv)
        wall = time.monotonic() - t0
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    check(rc == 0, f"{' '.join(argv[:1])} {' '.join(argv[1:])} exited {rc}")
    return wall


def stand_in_align(fastq_path, out_bam, read_length: int = 100) -> int:
    """A stand-in aligner: reads the interleaved FASTQ of ``fastq`` (names
    ``fam{f}:r{r}/1`` and ``/2``) and writes a query-grouped mapped BAM in
    its order. Family f maps to position group f // 10 on one of four
    contigs: R1 forward at the group's start, R2 reverse at the end of a
    180-base insert (the simulator's), 100M, a quarter of either read
    soft-clipped 5 bases at its outer end (its unclipped 5' unchanged);
    R2 unmapped in one template of 97 families, and a supplementary R1
    (60S40M on the next contig) in one of 53. Returns records written."""
    from fgumi_tpu_torch.constants import reverse_complement_bytes
    from fgumi_tpu_torch.io.bam import BamHeader, BamWriter, RecordBuilder

    names = [f"chr{c + 1}" for c in range(MAPPED_CONTIGS)]
    header = BamHeader(
        text="@HD\tVN:1.6\tSO:unsorted\tGO:query\n"
             + "".join(f"@SQ\tSN:{n}\tLN:{MAPPED_CONTIG_LEN}\n"
                       for n in names)
             + "@PG\tID:stand-in\tPN:chip_smoke.stand_in_align\n",
        ref_names=names, ref_lengths=[MAPPED_CONTIG_LEN] * MAPPED_CONTIGS)
    insert = int(read_length * 1.8)
    n = 0
    with open(fastq_path, "rb") as f, BamWriter(out_bam, header) as w:
        lines = iter(f)
        for head1 in lines:
            seq1, _, q1 = next(lines)[:-1], next(lines), next(lines)[:-1]
            head2 = next(lines)
            seq2, _, q2 = next(lines)[:-1], next(lines), next(lines)[:-1]
            name = head1[1:-1].rsplit(b"/", 1)[0]
            check(head2[1:-1].rsplit(b"/", 1)[0] == name,
                  f"stand-in aligner: {name!r} has no adjacent mate")
            fam_s, r_s = name.decode().split(":")
            fam, r = int(fam_s[3:]), int(r_s[1:])
            g = fam // FAMILIES_PER_POSITION
            tid = g % MAPPED_CONTIGS
            base = 1000 + (g // MAPPED_CONTIGS) * 600
            quals1 = np.frombuffer(q1, np.uint8) - 33
            quals2 = np.frombuffer(q2, np.uint8) - 33
            r2_unmapped = fam % 97 == 5 and r == 0
            supp = fam % 53 == 7 and r == 1
            p2 = base + insert - read_length
            clip1 = r % 4 == 3
            cig1 = [("S", 5), ("M", read_length - 5)] if clip1 \
                else [("M", read_length)]
            f1 = 0x1 | 0x40 | (0x8 if r2_unmapped else 0x2 | 0x20)
            b = RecordBuilder().start_mapped(
                name, f1, tid, base + (5 if clip1 else 0), 60, cig1, seq1,
                quals1, tid, base if r2_unmapped else p2,
                0 if r2_unmapped else insert)
            b.tag_int(b"AS", read_length - 5 * clip1 - (r % 3))
            b.tag_int(b"NM", r % 3)
            if fam % 3 == 0:
                b.tag_int(b"XS", 20 + r)
            w.write_record_bytes(b.finish())
            n += 1
            if supp:
                b = RecordBuilder().start_mapped(
                    name, 0x1 | 0x40 | 0x800 | 0x20,
                    (tid + 1) % MAPPED_CONTIGS, base + 250, 30,
                    [("S", 60), ("M", read_length - 60)], seq1, quals1,
                    tid, p2, 0)
                b.tag_int(b"AS", read_length - 60)
                w.write_record_bytes(b.finish())
                n += 1
            if r2_unmapped:
                b = RecordBuilder().start_unmapped(name, 0x1 | 0x80 | 0x4,
                                                   seq2, quals2)
            else:
                clip2 = r % 4 == 1
                cig2 = [("M", read_length - 5), ("S", 5)] if clip2 \
                    else [("M", read_length)]
                b = RecordBuilder().start_mapped(
                    name, 0x1 | 0x2 | 0x80 | 0x10, tid, p2, 60, cig2,
                    reverse_complement_bytes(seq2), quals2[::-1], tid,
                    base + (5 if clip1 else 0), -insert)
                b.tag_int(b"AS", read_length - 5 * clip2)
                b.tag_int(b"NM", 0)
            w.write_record_bytes(b.finish())
            n += 1
    return n


def split_at_template(src, dst_a, dst_b, cut=None) -> int:
    """``src`` in two consecutive parts, cut between two templates at the
    first template boundary from record ``cut`` on (default: half the
    records); ``dst_b`` None writes the first part alone. Returns the
    records of the first."""
    from fgumi_tpu_torch.io.bam import BamReader, BamWriter

    with BamReader(src) as r:
        header, recs = r.header, []
        for rec in r:
            # the first part alone: stop at the first template past the cut
            if dst_b is None and len(recs) >= cut \
                    and rec.name != recs[-1][0]:
                break
            recs.append((rec.name, rec.data))
    cut = len(recs) // 2 if cut is None else min(cut, len(recs))
    while 0 < cut < len(recs) and recs[cut][0] == recs[cut - 1][0]:
        cut += 1
    for path, part in ((dst_a, recs[:cut]), (dst_b, recs[cut:])):
        if path is None:
            continue
        with BamWriter(path, header) as w:
            for _, data in part:
                w.write_record_bytes(data)
    return cut


def _tag_values(path, tag: bytes) -> dict:
    """{read name: the tag's string value} of every record of ``path``
    (the last record of a name wins)."""
    from fgumi_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        return {rec.name: rec.get_str(tag) for rec in r}


def correct_1m_case(paths, work) -> dict:
    """``correct -U <list> -m -r`` on ``correct_1M`` on the batch engine,
    then on its first ``CORRECT_CLASSIC_READS`` reads on the batch engine
    and ``--classic``: records, rejects and metrics of those two
    identical; the share of reads whose corrected UMI is the true one (the
    generator's truth table) over the whole. Prints the ``mapped``
    line."""
    inp, wl, _ = paths["correct_1M"]
    head = os.path.join(work, "correct_1M.head.bam")
    n_head = split_at_template(inp, head, None, cut=CORRECT_CLASSIC_READS)
    runs, walls = {}, {}
    for engine, src in (("fast", inp), ("fast_head", head),
                        ("classic", head)):
        runs[engine] = out = [os.path.join(work, f"correct_1M.{engine}.{x}")
                              for x in ("bam", "rej.bam", "tsv")]
        walls[engine] = _cli_wall(
            ["correct", "-i", src, "-o", out[0], "-r", out[1], "-m", out[2],
             "-U", wl] + (["--classic"] if engine == "classic" else []))
    fast, fast_head, classic = runs["fast"], runs["fast_head"], \
        runs["classic"]
    kept, rejected = records(fast[0]), records(fast[1])
    check(records(fast_head[0]) == records(classic[0]),
          "correct_1M: fast and --classic records differ")
    check(records(fast_head[1]) == records(classic[1]),
          "correct_1M: fast and --classic rejects differ")
    with open(fast_head[2], "rb") as a, open(classic[2], "rb") as b:
        check(a.read() == b.read(),
              "correct_1M: fast and --classic metrics differ")
    true_umi = {}
    with open(paths["correct_1M"][2]) as f:
        next(f)
        for line in f:
            name, umi, _, _ = line.split("\t")
            true_umi[name.encode()] = umi
    got = _tag_values(fast[0], b"RX")
    right = sum(1 for name, umi in got.items() if true_umi[name] == umi)
    n = len(true_umi)
    check(len(kept) + len(rejected) == n,
          f"correct_1M: {len(kept)} kept + {len(rejected)} rejected != {n}")
    summary = {"case": "correct_1M", "reads": n, "kept": len(kept),
               "rejected": len(rejected), "kept_true_umi": right,
               "true_umi_share": right / n,
               "kept_true_share": right / max(len(kept), 1),
               "fast_wall_s": walls["fast"],
               "fast_reads_per_s": n / walls["fast"],
               "classic_reads": n_head,
               "fast_head_wall_s": walls["fast_head"],
               "classic_wall_s": walls["classic"],
               "classic_reads_per_s": n_head / walls["classic"],
               "identical": True}
    print("mapped " + json.dumps(summary), flush=True)
    return summary


def mapped_chain_case(paths, work) -> dict:
    """``mapped_chain_400k``, one run at a time: extract, correct, fastq,
    the stand-in aligner, zipper (batch engine, then ``--classic`` on its
    first ``ZIPPER_CLASSIC_RECORDS`` aligned records: identical), sort template-coordinate of the whole and of each half and
    merge of the halves (equal to the whole), group, simplex on ``cuda``
    (K1 launched) and then on ``cpu`` (no launch; every count zeroed just
    before each, read just after), identical, and filter. Prints a
    ``mapped`` line with each step's wall and records/s; returns the
    summary with the ``cuda`` simplex run's largest batch."""
    r1, r2, wl = paths["mapped_chain_400k"]
    with open(wl, "rb") as a, open(paths["correct_1M"][1], "rb") as b:
        check(a.read() == b.read(), "mapped_chain_400k: its includelist is "
                                    "not correct_1M's")
    p = {k: os.path.join(work, f"mapped.{k}") for k in (
        "unmapped.bam", "corrected.bam", "reads.fq", "aligned.bam",
        "zipped.bam", "aligned_head.bam", "corrected_head.bam",
        "zipped_classic.bam", "half_a.bam", "half_b.bam",
        "sorted.bam", "sorted_a.bam", "sorted_b.bam", "merged.bam",
        "grouped.bam", "cons.cuda.bam", "cons.cpu.bam", "filtered.bam")}
    steps = {}

    def step(name, wall, n_in):
        steps[name] = {"wall_s": wall, "records": n_in,
                       "records_per_s": n_in / wall if wall else None}

    n_reads = 10 * int(MAPPED_SIM[MAPPED_SIM.index("--num-families") + 1])
    step("extract", _cli_wall(["extract", "-i", r1, r2, *PIPELINE_OPTS, "-o",
                               p["unmapped.bam"]]), n_reads)
    step("correct", _cli_wall(["correct", "-i", p["unmapped.bam"], "-o",
                               p["corrected.bam"], "-U", wl]), n_reads)
    n_corr = len(records(p["corrected.bam"]))
    step("fastq", _cli_wall(["fastq", "-i", p["corrected.bam"], "-o",
                             p["reads.fq"]]), n_corr)
    t0 = time.monotonic()
    n_aln = stand_in_align(p["reads.fq"], p["aligned.bam"])
    step("stand_in_align", time.monotonic() - t0, n_corr)
    step("zipper", _cli_wall(["zipper", "-i", p["aligned.bam"], "-u",
                              p["corrected.bam"], "-o", p["zipped.bam"]]),
         n_aln)
    zipped = records(p["zipped.bam"])
    check(len(zipped) == n_aln, f"mapped_chain_400k: zipper wrote "
                                f"{len(zipped)} of {n_aln} records")
    # --classic on the first ZIPPER_CLASSIC_RECORDS aligned records (cut at
    # a template) and those templates' unmapped records: equal to the
    # batch engine's records of the whole, which begin with them
    n_head = split_at_template(p["aligned.bam"], p["aligned_head.bam"], None,
                               cut=ZIPPER_CLASSIC_RECORDS)
    head_names = set(_names_in_order(p["aligned_head.bam"]))
    from fgumi_tpu_torch.io.bam import BamReader, BamWriter

    with BamReader(p["corrected.bam"]) as r, \
            BamWriter(p["corrected_head.bam"], r.header) as w:
        for rec in r:
            if rec.name in head_names:
                w.write_record(rec)
    step("zipper_classic", _cli_wall(
        ["zipper", "-i", p["aligned_head.bam"], "-u", p["corrected_head.bam"],
         "-o", p["zipped_classic.bam"], "--classic"]), n_head)
    check(records(p["zipped_classic.bam"]) == zipped[:n_head],
          "mapped_chain_400k: zipper fast and --classic records differ")
    split_at_template(p["zipped.bam"], p["half_a.bam"], p["half_b.bam"])
    tc = ["--order", "template-coordinate"]
    step("sort", _cli_wall(["sort", "-i", p["zipped.bam"], "-o",
                            p["sorted.bam"], *tc]), n_aln)
    for half in ("a", "b"):
        _cli_wall(["sort", "-i", p[f"half_{half}.bam"], "-o",
                   p[f"sorted_{half}.bam"], *tc])
    step("merge", _cli_wall(["merge", "-i", p["sorted_a.bam"],
                             p["sorted_b.bam"], "-o", p["merged.bam"], *tc]),
         n_aln)
    check(records(p["merged.bam"]) == records(p["sorted.bam"]),
          "mapped_chain_400k: merge of the sorted halves differs from the "
          "sorted whole")
    step("group", _cli_wall(["group", "-i", p["sorted.bam"], "-o",
                             p["grouped.bam"], "-s", "adjacency",
                             "--device", "cuda"]), n_aln)
    n_grouped = len(records(p["grouped.bam"]))
    reset_counts()
    st = run_simplex(p["grouped.bam"], p["cons.cuda.bam"], "cuda",
                     ["--min-reads", "1"])
    counts = read_counts()
    reset_counts()
    st_cpu = run_simplex(p["grouped.bam"], p["cons.cpu.bam"], "cpu",
                         ["--min-reads", "1"])
    cpu_counts = read_counts()
    check(counts["consensus_wire_full"] > 0,
          "mapped_chain_400k: K1 was never launched")
    check(counts["consensus_wire_full"] + counts["consensus_wire_packed2"]
          >= st["device_batches"],
          f"mapped_chain_400k: {counts} launches < {st['device_batches']} "
          "device batches")
    check(not any(cpu_counts.values()),
          f"mapped_chain_400k: the cpu run launched {cpu_counts}")
    cons = records(p["cons.cuda.bam"])
    check(cons and cons == records(p["cons.cpu.bam"]),
          "mapped_chain_400k: simplex cuda and cpu records differ")
    step("simplex", st["wall_s"], st["input_reads"])
    step("simplex_cpu", st_cpu["wall_s"], st_cpu["input_reads"])
    step("filter", _cli_wall(["filter", "-i", p["cons.cuda.bam"], "-o",
                              p["filtered.bam"], "-M", "1"]), len(cons))
    n_out = len(records(p["filtered.bam"]))
    check(n_out > 0, "mapped_chain_400k: filter kept nothing")
    shapes = st["batch_shapes"]
    summary = {"case": "mapped_chain_400k", "reads": n_reads,
               "corrected": n_corr, "aligned": n_aln, "grouped": n_grouped,
               "consensus": len(cons), "filtered": n_out,
               "launches": counts, "cpu_launches": cpu_counts,
               "largest_batch": max(shapes, key=lambda s: s[0]),
               "zipper_identical": True, "merge_equals_sort": True,
               "simplex_identical": True, "steps": steps,
               "chain_wall_s": sum(s["wall_s"] for k, s in steps.items()
                                   if k not in ("zipper_classic",
                                                "simplex_cpu"))}
    print("mapped " + json.dumps(summary), flush=True)
    return summary


def device_filter_env_case(inp, work, fused) -> dict:
    """``FGUMI_TPU_DEVICE_FILTER`` on ``fixed5_1M``: ``=1`` without
    ``--device-filter``, and ``=0`` with it, each write the records of the
    ``--device-filter`` run (``fused``) with its launches (K1-f). Counts
    zeroed just before each run, read just after."""
    base = ["--min-reads", "1", *FILTER_OPTS]
    want = records(fused["out"])
    out = {}
    for value, flags in (("1", base), ("0", base + ["--device-filter"])):
        path = os.path.join(work, f"fixed5_1M_env{value}.bam")
        stats = path + ".json"
        reset_counts()
        wall = _cli_wall(["simplex", "-i", inp, "-o", path, "--device",
                          "cuda", "--stats-json", stats, *flags],
                         {"FGUMI_TPU_DEVICE_FILTER": value})
        counts = read_counts()
        check(records(path) == want,
              f"device_filter_env ={value}: records differ from the "
              "--device-filter run's")
        check(counts == fused["launches"],
              f"device_filter_env ={value}: launches {counts}, the "
              f"--device-filter run's {fused['launches']}")
        with open(stats) as f:
            st = json.load(f)
        out[value] = {"wall_s": wall, "launches": counts,
                      "fused_batches": st["fused_batches"],
                      "records_written": st["records_written"]}
    summary = {"case": "device_filter_env", "input": "fixed5_1M",
               "records": len(want), "fused_launches": fused["launches"],
               "env": out, "identical": True}
    print("mapped " + json.dumps(summary), flush=True)
    return summary


def mapped_phase(paths, work, fused, correct=None) -> dict:
    """The mapped phase, one run at a time: ``correct_1M`` (or
    ``correct``: its summary's future, where it ran in the inputs' pool
    beside earlier phases), ``mapped_chain_400k``, then
    ``device_filter_env`` (``fused``: the ``fixed5_1M --device-filter``
    cuda run's output and launches)."""
    t0 = time.monotonic()
    out = {"correct_1M": correct_1m_case(paths, work) if correct is None
           else correct.result(),
           "mapped_chain_400k": mapped_chain_case(paths, work),
           "device_filter_env": device_filter_env_case(paths["fixed5_1M"],
                                                       work, fused)}
    print(f"mapped phase {time.monotonic() - t0:.1f}s", flush=True)
    return out


# ------------------------------------------------------------------ qc

# the qc phase's clip runs: (label, options, records of the input: None
# for the whole query-grouped BAM, else its first N cut at a template)
QC_CLIP_RUNS = (
    ("clip_soft", ["-c", "soft", "--clip-overlapping-reads",
                   "--clip-bases-past-mate"], 40_000),
    ("clip_hard", ["-c", "hard", "-H", "-a", "--read-one-five-prime", "3",
                   "--read-two-three-prime", "2"], 20_000))
QC_REF_SEED = 54  # the stand-in aligner's contigs as a seeded FASTA
QC_VCF_SITES, QC_VCF_SEED = 200, 55
# duplex-metrics' two runs take the first records of amplicon_paired's
# paired group output, cut at a template (its first positions: the BED of
# every other position still keeps some of them)
QC_DUPLEX_METRICS_RECORDS = 48_000


class _LogLines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _cli_logged(argv) -> tuple:
    """:func:`_cli_wall` with the port's log lines of the run: (wall,
    [message])."""
    handler = _LogLines()
    logger = logging.getLogger("fgumi_tpu_torch")
    logger.addHandler(handler)
    try:
        wall = _cli_wall(argv)
    finally:
        logger.removeHandler(handler)
    return wall, handler.lines


def _logged_ints(lines, pattern: str) -> tuple:
    """The integers of the first log line matching ``pattern`` (a regular
    expression with groups); fails when no line matches."""
    for line in lines:
        m = re.search(pattern, line)
        if m:
            return tuple(int(g) for g in m.groups())
    fail(f"no log line matches {pattern!r}")


def _names_in_order(path) -> list:
    from fgumi_tpu_torch.io.bam import BamReader

    with BamReader(path) as r:
        return [rec.name for rec in r]


def _tsv(path) -> list:
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f]
    return [dict(zip(rows[0], row)) for row in rows[1:]]


def qc_clip_case(label, flags, n_records, zipped, ref, work) -> dict:
    """``clip`` (``flags``, ``-m``) on the chain's query-grouped
    ``zipped`` BAM, or its first ``n_records`` cut at a template: the
    records out are the records in, name for name and in order; the
    templates the command counted are the input's; a soft overlap run
    clipped some templates."""
    inp = zipped
    if n_records is not None:
        inp = os.path.join(work, f"qc.{label}.in.bam")
        split_at_template(zipped, inp, None, cut=n_records)
    out = os.path.join(work, f"qc.{label}.bam")
    metrics = out + ".tsv"
    wall, lines = _cli_logged(["clip", "-i", inp, "-o", out, "-r", ref,
                               "-m", metrics, *flags])
    names = _names_in_order(inp)
    check(_names_in_order(out) == names,
          f"{label}: the records out are not the records in, in order")
    templates = sum(1 for k, n in enumerate(names)
                    if k == 0 or n != names[k - 1])
    got, overlap, extend = _logged_ints(
        lines, r"clip: (\d+) templates \((\d+) overlap-clipped, (\d+) "
               r"extend-clipped\)")
    check(got == templates, f"{label}: clip counted {got} templates, the "
                            f"input holds {templates}")
    rows = {r["read_type"]: r for r in _tsv(metrics)}
    check(set(rows) == {"fragment", "read_one", "read_two"},
          f"{label}: metrics rows {sorted(rows)}")
    if "--clip-overlapping-reads" in flags:
        check(overlap > 0, f"{label}: no template was overlap-clipped")
    summary = {"case": label, "records": len(names), "templates": templates,
               "overlap_clipped": overlap, "extend_clipped": extend,
               "bases_clipped_overlapping": sum(
                   int(r["bases_clipped_overlapping"]) for r in rows.values()),
               "reads_unmapped": sum(int(r["reads_unmapped"])
                                     for r in rows.values()),
               "wall_s": wall, "records_per_s": len(names) / wall}
    print("qc " + json.dumps(summary), flush=True)
    return summary


def qc_simplex_metrics_case(grouped, n_records, work) -> dict:
    """``simplex-metrics --min-reads 3`` on the chain's grouped BAM (of
    ``n_records`` records): 20 yield rows, the full fraction's read pairs
    all of the templates the command counted."""
    prefix = os.path.join(work, "qc.simplex_metrics")
    wall, lines = _cli_logged(["simplex-metrics", "-i", grouped, "-o",
                               prefix, "--min-reads", "3"])
    (templates,) = _logged_ints(lines, r"simplex-metrics: (\d+) templates")
    yields = _tsv(prefix + ".simplex_yield_metrics.txt")
    check(len(yields) == 20, f"simplex-metrics: {len(yields)} yield rows")
    full = yields[-1]
    check(int(full["read_pairs"]) == templates > 0,
          f"simplex-metrics: {full['read_pairs']} read pairs at fraction 1, "
          f"{templates} templates")
    sizes = _tsv(prefix + ".family_sizes.txt")
    summary = {"case": "simplex_metrics", "records": n_records,
               "templates": templates, "cs_families": int(
                   full["cs_families"]),
               "ss_families": int(full["ss_families"]),
               "ss_consensus_families": int(full["ss_consensus_families"]),
               "family_sizes": len(sizes), "wall_s": wall,
               "records_per_s": n_records / wall}
    print("qc " + json.dumps(summary), flush=True)
    return summary


def qc_duplex_metrics_case(paired, work) -> dict:
    """``duplex-metrics --duplex-umi-counts`` on the first
    ``QC_DUPLEX_METRICS_RECORDS`` records (cut at a template) of the fast
    ``group --strategy paired`` output of ``amplicon_paired``, plain and
    with a BED of half of its positions: duplexes found, the BED run's
    templates fewer but not none."""
    inp = os.path.join(work, "qc.duplex_metrics.in.bam")
    n_records = split_at_template(paired, inp, None,
                                  cut=QC_DUPLEX_METRICS_RECORDS)
    bed = os.path.join(work, "qc.half_positions.bed")
    with open(bed, "w") as f:
        for p in range(0, AMPLICONS["amplicon_paired"]["positions"], 2):
            start = 100000 + 1000 * p
            f.write(f"chr1\t{start}\t{start + 200}\n")
    runs = {}
    for label, extra in (("all", []), ("bed", ["--intervals", bed])):
        prefix = os.path.join(work, f"qc.duplex_metrics.{label}")
        wall, lines = _cli_logged(["duplex-metrics", "-i", inp, "-o",
                                   prefix, "--duplex-umi-counts", *extra])
        (templates,) = _logged_ints(lines,
                                    r"duplex-metrics: (\d+) templates")
        yields = _tsv(prefix + ".duplex_yield_metrics.txt")
        check(len(yields) == 20, f"duplex-metrics {label}: {len(yields)} "
                                 "yield rows")
        full = yields[-1]
        check(int(full["read_pairs"]) == templates > 0,
              f"duplex-metrics {label}: {full['read_pairs']} read pairs at "
              f"fraction 1, {templates} templates")
        check(int(full["ds_duplexes"]) > 0,
              f"duplex-metrics {label}: no duplex family")
        umis = _tsv(prefix + ".duplex_umi_counts.txt")
        check(len(umis) > 0, f"duplex-metrics {label}: no duplex UMI rows")
        runs[label] = {"templates": templates,
                       "ds_families": int(full["ds_families"]),
                       "ds_duplexes": int(full["ds_duplexes"]),
                       "ds_fraction_duplexes": float(
                           full["ds_fraction_duplexes"]),
                       "duplex_umis": len(umis), "wall_s": wall,
                       "records_per_s": n_records / wall}
    check(0 < runs["bed"]["templates"] < runs["all"]["templates"],
          f"duplex-metrics: the BED run counted {runs['bed']['templates']} "
          f"of {runs['all']['templates']} templates")
    summary = {"case": "duplex_metrics", "records": n_records, **runs}
    print("qc " + json.dumps(summary), flush=True)
    return summary


def _mi_blocks(recs) -> list:
    """[(MI value, records)] of the runs of consecutive records of one MI
    value (downsample's families)."""
    from fgumi_tpu_torch.io.bam import RawRecord

    blocks = []
    for data in recs:
        mi = RawRecord(data).get_str(b"MI")
        if not blocks or mi != blocks[-1][0]:
            blocks.append((mi, []))
        blocks[-1][1].append(data)
    return blocks


def qc_downsample_case(grouped, inp, work) -> dict:
    """``downsample`` on the chain's grouped BAM. ``group -s adjacency``
    merges families whose templates are not neighbours there, so an MI
    value comes in more than one run of records, and the default MI-order
    check refuses the input (exit 2, nothing written), as the reference's
    does. ``--validate-mi-order false`` then draws once a run: ``-f 0.5
    --seed 7`` with the rejects and both histograms (kept and rejected
    records together the input's records ``inp``, run by run; the
    histograms sum to its runs), and ``-f 1.0`` (the input's records)."""
    from fgumi_tpu_torch import cli

    blocks = _mi_blocks(inp)
    split = len(blocks) > len({mi for mi, _ in blocks})
    p = {k: os.path.join(work, f"qc.downsample.{k}")
         for k in ("refused.bam", "half.bam", "rejects.bam", "kept.tsv",
                   "rejected.tsv", "all.bam")}
    rc = cli.main(["downsample", "-i", grouped, "-o", p["refused.bam"], "-f",
                   "0.5", "--seed", "7"])
    check(rc == (2 if split else 0) and os.path.exists(p["refused.bam"])
          == (not split), f"downsample with the MI-order check: exit {rc} "
                          f"on {len(blocks)} MI runs")
    nocheck = ["--validate-mi-order", "false"]
    wall = _cli_wall(["downsample", "-i", grouped, "-o", p["half.bam"], "-f",
                      "0.5", "--seed", "7", "--rejects", p["rejects.bam"],
                      "--histogram-kept", p["kept.tsv"],
                      "--histogram-rejected", p["rejected.tsv"], *nocheck])
    kept, rejected = records(p["half.bam"]), records(p["rejects.bam"])
    ki = ri = kept_runs = 0
    for _, block in blocks:
        n = len(block)
        if kept[ki:ki + n] == block:
            ki += n
            kept_runs += 1
        elif rejected[ri:ri + n] == block:
            ri += n
        else:
            fail("downsample: kept and rejected records are not the "
                 "input's MI runs")
    check(ki == len(kept) and ri == len(rejected),
          "downsample: records beyond the input's")
    hist = sum(int(r["count"]) for path in (p["kept.tsv"], p["rejected.tsv"])
               for r in _tsv(path))
    check(hist == len(blocks), f"downsample: the histograms hold {hist} "
                               f"families, the input {len(blocks)} MI runs")
    wall_all = _cli_wall(["downsample", "-i", grouped, "-o", p["all.bam"],
                          "-f", "1.0", *nocheck])
    check(records(p["all.bam"]) == inp,
          "downsample -f 1.0: the records are not the input's")
    summary = {"case": "downsample", "records": len(inp),
               "mi_runs": len(blocks), "mi_split": split,
               "kept_runs": kept_runs, "kept_records": len(kept),
               "wall_s": wall, "records_per_s": len(inp) / wall,
               "all_wall_s": wall_all}
    print("qc " + json.dumps(summary), flush=True)
    return summary


def qc_vcf(path, cons, seed: int):
    """A VCF of ``QC_VCF_SITES`` SNV sites drawn with ``seed`` from the
    aligned bases of the coordinate-sorted ``cons``: the covering read's
    base as the reference base at two sites of three, another base at the
    rest; one sample column. Returns the sites."""
    from fgumi_tpu_torch.io.bam import BamReader

    rng = np.random.default_rng(seed)
    with BamReader(cons) as r:
        names = r.header.ref_names
        recs = [rec for rec in r
                if not rec.flag & 0x4 and rec.reference_length() > 0]
    sites = {}
    while len(sites) < QC_VCF_SITES:
        rec = recs[int(rng.integers(0, len(recs)))]
        cigar = rec.cigar()
        lead = cigar[0][1] if cigar[0][0] == "S" else 0
        off = int(rng.integers(0, rec.reference_length()))
        base = chr(rec.seq_bytes()[lead + off])
        if base not in "ACGT":
            continue
        key = (rec.ref_id, rec.pos + off + 1)
        if key not in sites:
            sites[key] = base if rng.random() < 2 / 3 \
                else "ACGT"[("ACGT".index(base) + 1) % 4]
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.2\n#CHROM\tPOS\tID\tREF\tALT\tQUAL\t"
                "FILTER\tINFO\tFORMAT\tsample\n")
        for (tid, pos), ref in sorted(sites.items()):
            alt = "ACGT"[("ACGT".index(ref) + 2) % 4]
            f.write(f"{names[tid]}\t{pos}\t.\t{ref}\t{alt}\t60\tPASS\t.\t"
                    f"GT:AD\t0/1:40,2\n")
    return len(sites)


def qc_review_case(grouped, n_records, work) -> dict:
    """``review``: ``-c`` the chain's grouped BAM sorted by coordinate with
    its BAI (raw reads with MI standing in for a realigned consensus),
    ``-g`` the grouped BAM, a seeded VCF of ``QC_VCF_SITES`` sites; run
    with the BAI beside the BAM (the indexed pass) and without it (the
    streaming pass): the three outputs identical."""
    cons = os.path.join(work, "qc.review.cons.bam")
    sort_wall = _cli_wall(["sort", "-i", grouped, "-o", cons, "--order",
                           "coordinate", "--write-index"])
    vcf = os.path.join(work, "qc.review.vcf")
    n_sites = qc_vcf(vcf, cons, QC_VCF_SEED)
    bare = os.path.join(work, "qc.review.cons_noindex.bam")
    os.link(cons, bare)
    runs = {}
    for label, bam in (("indexed", cons), ("streaming", bare)):
        prefix = os.path.join(work, f"qc.review.{label}")
        wall, lines = _cli_logged(["review", "-i", vcf, "-c", bam, "-g",
                                   grouped, "-o", prefix])
        used = any("consensus pass used the BAI index" in line
                   for line in lines)
        check(used == (label == "indexed"),
              f"review {label}: the BAI index was "
              f"{'not ' if not used else ''}used")
        cons_out, raw_out, rows = _logged_ints(
            lines, r"review: (\d+) consensus reads, (\d+) raw reads "
                   r"extracted; (\d+) detail rows")
        with open(prefix + ".txt", "rb") as f:
            txt = f.read()
        runs[label] = {"consensus_reads": cons_out, "raw_reads": raw_out,
                       "rows": rows, "wall_s": wall, "outputs": (
                           records(prefix + ".consensus.bam"),
                           records(prefix + ".grouped.bam"), txt)}
    a, b = runs["indexed"].pop("outputs"), runs["streaming"].pop("outputs")
    check(a == b, "review: the indexed and streaming passes' outputs differ")
    check(runs["indexed"]["rows"] > 0, "review: no detail row")
    summary = {"case": "review", "sites": n_sites,
               "records": n_records, "sort_wall_s": sort_wall,
               **runs, "identical": True}
    print("qc " + json.dumps(summary), flush=True)
    return summary


def qc_phase(zipped, grouped, paired, work) -> dict:
    """The qc phase, one command at a time: ``clip`` (twice), then
    ``simplex-metrics``, ``duplex-metrics`` (twice), ``downsample`` (twice)
    and ``review`` (indexed and streaming). ``zipped`` and ``grouped`` are
    the mapped chain's query-grouped and grouped BAMs, ``paired`` the fast
    ``group --strategy paired`` output of ``amplicon_paired``. Host
    commands: nothing here launches a kernel."""
    from fgumi_tpu_torch.core.reference import write_fasta

    t0 = time.monotonic()
    ref = os.path.join(work, "qc.ref.fa")
    write_fasta(ref, meth_reference_seqs(MAPPED_CONTIGS, MAPPED_CONTIG_LEN,
                                         QC_REF_SEED))
    reset_counts()
    out = {label: qc_clip_case(label, flags, n, zipped, ref, work)
           for label, flags, n in QC_CLIP_RUNS}
    grouped_recs = records(grouped)
    out["simplex_metrics"] = qc_simplex_metrics_case(
        grouped, len(grouped_recs), work)
    out["duplex_metrics"] = qc_duplex_metrics_case(paired, work)
    out["downsample"] = qc_downsample_case(grouped, grouped_recs, work)
    out["review"] = qc_review_case(grouped, len(grouped_recs), work)
    counts = read_counts()
    check(not any(counts.values()), f"qc: host commands launched {counts}")
    print(f"qc phase {time.monotonic() - t0:.1f}s", flush=True)
    return out


def libdeflate_probe() -> str:
    """Whether this host has libdeflate's header and shared library (the
    port links no compression library; this only looks)."""
    import glob

    heads = [p for d in ("/usr/include", "/usr/local/include")
             for p in glob.glob(os.path.join(d, "libdeflate.h"))]
    libs = sorted({p for d in ("/usr/lib", "/usr/lib64", "/usr/local/lib",
                               "/usr/lib/x86_64-linux-gnu")
                   for p in glob.glob(os.path.join(d, "libdeflate.so*"))})
    return (f"libdeflate probe: header {', '.join(heads) or 'absent'}; "
            f"library {', '.join(libs) or 'absent'}")


def staged_phase(paths, work, serial_runs):
    """Every run of :data:`STAGED_RUNS`; returns their summaries."""
    return {name: staged_run(name, command, paths[inp], serial_runs[ser],
                             flags, work)
            for name, command, inp, ser, flags in STAGED_RUNS}


#: simulation workers: the card host's cores but two, one for this process
#: (the builds, then the kernel checks) and one to spare
SIM_WORKERS = max(2, (os.cpu_count() or 8) - 2)


def _simulate_codec(path, kw):
    """Worker-process body: one simulated codec input BAM."""
    from fgumi_tpu_torch.simulate import simulate_codec_bam

    t0 = time.monotonic()
    n = simulate_codec_bam(path, **kw)
    return n, time.monotonic() - t0


def _simulate_duplex(path, kw):
    """Worker-process body: one simulated duplex input BAM."""
    from fgumi_tpu_torch.simulate import simulate_duplex_bam

    t0 = time.monotonic()
    n = simulate_duplex_bam(path, **kw)
    return n, time.monotonic() - t0


def _simulate_fastq(pair, n_families):
    """Worker-process body: one FASTQ pair through the port's ``simulate
    fastq-reads``; returns (reads, seconds)."""
    from fgumi_tpu_torch import cli

    t0 = time.monotonic()
    rc = cli.main(["simulate", "fastq-reads", "-1", pair[0], "-2",
                   pair[1], "--num-families", str(n_families),
                   *FASTQ_SIM])
    check(rc == 0, f"simulate fastq-reads exited {rc}")
    return 10 * n_families, time.monotonic() - t0


def _simulate_correct(paths, argv):
    """Worker-process body: ``correct_1M``'s reads, includelist and truth
    through the port's ``simulate correct-reads``."""
    from fgumi_tpu_torch import cli

    t0 = time.monotonic()
    bam, wl, truth = paths
    check(cli.main(["simulate", "correct-reads", "-o", bam, "-i", wl,
                    "--truth", truth, *argv]) == 0,
          "simulate correct-reads failed")
    return int(argv[argv.index("-n") + 1]), time.monotonic() - t0


def _simulate_mapped_fastq(paths, argv):
    """Worker-process body: ``mapped_chain_400k``'s FASTQ pair, its UMIs
    from ``correct_1M``'s includelist (the same seed's list, written here
    by ``simulate correct-reads -n 0``, so this input needs no wait)."""
    from fgumi_tpu_torch import cli

    t0 = time.monotonic()
    r1, r2, wl = paths
    check(cli.main(["simulate", "correct-reads", "-o", wl + ".bam", "-i", wl,
                    *CORRECT_SIM, "-n", "0"]) == 0,
          "simulate correct-reads -n 0 failed")
    check(cli.main(["simulate", "fastq-reads", "-1", r1, "-2", r2,
                    "--includelist", wl, *argv]) == 0,
          "simulate fastq-reads failed")
    return 10 * int(argv[argv.index("--num-families") + 1]), \
        time.monotonic() - t0


def _simulate(path, kw):
    """Worker-process body: one simulated input BAM."""
    from fgumi_tpu_torch.simulate import simulate_grouped_bam

    t0 = time.monotonic()
    n = simulate_grouped_bam(path, **kw)
    return n, time.monotonic() - t0


def _meth_reference(path, kw):
    """Worker-process body: the methylation inputs' FASTA."""
    t0 = time.monotonic()
    n = meth_reference(path, **kw)
    return n, time.monotonic() - t0


def _methylation(path, kw):
    """Worker-process body: one EM-Seq/TAPS input over the reference."""
    t0 = time.monotonic()
    n = methylation_bam(path, ref=meth_reference_seqs(**METH_REF), **kw)
    return n, time.monotonic() - t0


def _amplicon(path, kw):
    """Worker-process body: one amplicon input BAM."""
    t0 = time.monotonic()
    n = amplicon_bam(path, **kw)
    return n, time.monotonic() - t0


# ------------------------------------------------------------------ serve

REPLACES_CANARY = "fgumi_tpu/ops/kernel.py:1211"
CANARY_SOURCE = "fgumi_tpu_torch/csrc/canary.cu"
# the serve phase's inputs: a consensus job run cold and then warm, and two
# jobs at once, a pipeline through K4 and K1 and a fused simplex (K1-f)
SERVE_INPUTS = ("longtail_200k", "pipeline_k4_50k")
SERVE_START_S = 180  # bound on the daemon's start, its warm-up included
SERVE_JOB_S = 600
SERVE_CANARIES = 3
# the phase's daemon opts in to the coalescer's auto mode: the window
# opens at 2 running jobs, priced at the router's per-dispatch overhead
SERVE_AUTO_COALESCE_MS = "2"
# the coalesced pair runs on a second daemon whose merge window is forced
# (the priced window is a few milliseconds on the card, so two jobs'
# batches rarely meet inside it; at 50 ms 1-3 of the pair's 5 batch pairs
# merged, so 200 ms)
SERVE_COALESCE_MS = "200"


def _spawn_serve(sock, args, env=None):
    """``python -m fgumi_tpu_torch serve --socket sock *args`` in a child
    process, its stderr read by a :class:`_DaemonLog`."""
    kw = _child_kwargs(env)
    kw.pop("text")
    proc = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", "serve", "--socket", sock,
         *args], stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, **kw)
    return proc, _DaemonLog(proc)


def _stop_serve(proc, dlog):
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=60)
    dlog.join()


class _CoalescePoll:
    """``stats``' ``coalesce`` section polled on a thread while jobs run:
    whether the window was armed with 2 or more jobs running."""

    def __init__(self, sock, period=0.25):
        import threading

        from fgumi_tpu_torch.serve.client import ServeClient

        self.period = period
        self.armed_at = []
        self.polls = 0
        self._client = ServeClient(sock, timeout=30)
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                coal = self._client.stats()["coalesce"] or {}
            except Exception:  # noqa: BLE001 - a missed poll is no result
                coal = {}
            self.polls += 1
            if coal.get("armed"):
                self.armed_at.append(coal.get("active_jobs"))
            self._stop.wait(self.period)

    def stop(self):
        self._stop.set()
        self._t.join(timeout=30)


class _DaemonLog:
    """A serve (or balance) child's stderr, read on a thread: every line
    kept, and the warm-up seconds, the metrics port and the listening line
    picked out."""

    def __init__(self, proc):
        import threading

        self.lines = []
        self.warm_s = None
        self.metrics_port = None
        self.listening = threading.Event()
        self._t = threading.Thread(target=self._read, args=(proc,),
                                   daemon=True)
        self._t.start()

    def _read(self, proc):
        for line in proc.stderr:
            line = line.rstrip("\n")
            self.lines.append(line)
            m = re.search(r"serve: warm-up done in ([0-9.]+)s", line)
            if m:
                self.warm_s = float(m.group(1))
            m = re.search(r"serve: metrics on http://127\.0\.0\.1:(\d+)/",
                          line)
            if m:
                self.metrics_port = int(m.group(1))
            if "serve: listening on" in line \
                    or "balance: listening on" in line:
                self.listening.set()

    def join(self):
        self._t.join(timeout=30)

    def tail(self, n: int = 30) -> str:
        return "\n".join(self.lines[-n:])


def _serve_job(client, argv, timeout=SERVE_JOB_S) -> dict:
    """Submit ``argv`` to the daemon, wait for its end, require ``done``;
    the job's record with ``client_wall_s`` (submit to done, this side)."""
    t0 = time.monotonic()
    job = client.wait(client.submit(argv)["id"], timeout=timeout)
    check(job["state"] == "done",
          f"serve job {' '.join(argv)}: {job['state']}: {job['error']}")
    job["client_wall_s"] = time.monotonic() - t0
    job["run_s"] = job["finished_unix"] - job["started_unix"]
    return job


def _digest(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _standalone_digest(argv) -> str:
    """The port's standalone run of ``argv`` in this process (the same
    argv a serve job gets): its output's digest, the output removed."""
    from fgumi_tpu_torch import cli

    out = argv[argv.index("-o") + 1]
    check(cli.main(argv) == 0, f"standalone {' '.join(argv)} failed")
    digest = _digest(out)
    os.unlink(out)
    return digest


def _get_url(url: str):
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def check_canary_kernel(dev, n: int, timed: bool) -> dict:
    """K7 (``ops/canary.canary_sum``) against its plain version on the card,
    exactly, on zero, all-255 and seeded random payloads of ``n`` bytes;
    with ``timed`` also its times beside the bound, the plain version's
    and ``torch.sum(x, dtype=torch.int32)``'s (the library call). Launches
    made here are not the main path's: the count is restored."""
    import torch

    from fgumi_tpu_torch.ops import canary

    launches0 = canary.CANARY_LAUNCHES
    rng = np.random.default_rng(n)
    payloads = {"zeros": torch.zeros(n, dtype=torch.uint8, device=dev),
                "all_255": torch.full((n,), 255, dtype=torch.uint8,
                                      device=dev),
                "random": torch.from_numpy(rng.integers(
                    0, 256, n, dtype=np.uint8)).to(dev)}
    err = 0
    for name, x in payloads.items():
        got = canary.canary_sum(x)
        want = canary.canary_sum_plain(x)
        torch.cuda.synchronize()
        check(got.dtype == torch.int32 and got.shape == (),
              f"K7 {name} {n}: output {got.dtype} {tuple(got.shape)}")
        check(int(got) == int(want) == int(x.to(torch.int64).sum()),
              f"K7 {name} {n}: kernel {int(got)} != plain {int(want)}")
        err = max(err, abs(int(got) - int(want)))
    check(canary.CANARY_LAUNCHES == launches0 + len(payloads),
          "K7: a launch was not counted")
    canary.CANARY_LAUNCHES = launches0
    res = {"max_abs_err": err, "bytes": n + 4, "ops": n,
           "geometry": canary.launch_geometry(n),
           "registers": ptxas_registers("canary_sum_kernel")}
    print(f"check K7 canary_sum {n}B: exact on zeros, all-255 and random "
          f"bytes; geometry {res['geometry']}, {res['registers']} "
          "registers", flush=True)
    if timed:
        x = payloads["random"]
        _time(res, lambda: canary.canary_sum(x),
              lambda: canary.canary_sum_plain(x), canary, "CANARY_LAUNCHES",
              "canary_sum_kernel")
        lib = lambda: torch.sum(x, dtype=torch.int32)  # noqa: E731
        res["library_ms"] = device_ms(lib)[0] or loop_ms(lib)
        print("time K7 canary_sum " + json.dumps(
            {k: res[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms",
                                 "bound_by", "call_ms", "loop_ms")}),
            flush=True)
    return res


def serve_phase(paths, work, dev):
    """The job service on the card: ``serve`` in a child process (2
    workers, the health canary every second, ``/metrics`` and ``/healthz``
    on an ephemeral port, per-job reports), its warm-up timed; a consensus
    job cold and then warm; a ``pipeline`` (K4, K1) and a fused ``simplex
    --device-filter`` (K1-f) at once, each output byte-identical to the
    port's standalone run of the same argv and each job's own
    ``--stats-json`` launch counts (the daemon's per-command tallies)
    showing its kernels; ``stats`` with at least 3 ``device.canary.ok``
    and ``/healthz`` 200; a graceful shutdown (exit 0). Then K7 against
    its plain version and timed. Returns K7's ``kernels`` entry (its
    launches are the daemon's, a fresh process: every count 0 at its
    start, read from ``stats``) and the pipeline job's argv with its
    standalone digest (the fleet phase's pipeline whale reuses both)."""
    from fgumi_tpu_torch.serve.client import ServeClient

    t0 = time.monotonic()
    sock = os.path.join(work, "serve.sock")
    reports = os.path.join(work, "serve_reports")
    longtail = paths["longtail_200k"]
    r1, r2 = paths["pipeline_k4_50k"]
    out = {k: os.path.join(work, f"serve_{k}.bam")
           for k in ("cold", "warm", "pipeline", "fused", "pair_a",
                     "pair_b")}
    journal = os.path.join(work, "serve.journal")
    argvs = {
        "cold": ["simplex", "-i", longtail, "-o", out["cold"]],
        "warm": ["simplex", "-i", longtail, "-o", out["warm"]],
        "pipeline": ["pipeline", "-i", r1, r2, *PIPELINE_OPTS, "-o",
                     out["pipeline"], "--device", "cuda", "--stats-json",
                     out["pipeline"] + ".json"],
        "fused": ["simplex", "-i", longtail, "-o", out["fused"], "--device",
                  "cuda", "--min-reads", "1", "--device-filter",
                  *FILTER_OPTS, "--stats-json", out["fused"] + ".json"],
        **{k: ["simplex", "-i", longtail, "-o", out[k], "--device", "cuda",
               "--stats-json", out[k] + ".json"]
           for k in ("pair_a", "pair_b")}}
    proc, dlog = _spawn_serve(
        sock, ["--workers", "2", "--health-period", "1", "--metrics-port",
               "0", "--report-dir", reports, "--journal", journal,
               "--coalesce-window-ms", SERVE_AUTO_COALESCE_MS])
    t_spawn = time.monotonic()
    # the forced-window daemon for the coalesced pair, warming beside it
    co_sock = os.path.join(work, "serve_co.sock")
    co_proc, co_log = _spawn_serve(
        co_sock, ["--workers", "2", "--coalesce-window-ms",
                  SERVE_COALESCE_MS], {"FGUMI_TPU_COALESCE": "1"})
    try:
        # the standalone runs the jobs are held to, while the daemon warms
        standalone = {k: _standalone_digest(argvs[k])
                      for k in ("pipeline", "fused", "pair_a", "pair_b")}
        # a solo run's K1 launches: the standalone pair_a run's own tally
        with open(out["pair_a"] + ".json") as f:
            solo_k1 = json.load(f)["launches"]["consensus_wire_full"]
        t_std = time.monotonic() - t0
        up = dlog.listening.wait(SERVE_START_S)
        check(up and proc.poll() is None,
              f"serve did not start (rc {proc.poll()}):\n{dlog.tail()}")
        start_s = time.monotonic() - t_spawn
        check(dlog.warm_s is not None and dlog.metrics_port,
              f"serve: no warm-up or metrics line:\n{dlog.tail()}")
        client = ServeClient(sock, timeout=30)
        solo_poll = _CoalescePoll(sock)
        cold = _serve_job(client, argvs["cold"])
        warm = _serve_job(client, argvs["warm"])
        solo_poll.stop()
        check(records(out["cold"]) == records(out["warm"]),
              "serve: the cold and warm jobs' records differ")
        check(not solo_poll.armed_at and solo_poll.polls,
              f"serve: the coalescer armed for a single job "
              f"({solo_poll.armed_at})")
        before_auto = client.stats()["coalesce"] or {}
        t_pair = time.monotonic()
        auto_poll = _CoalescePoll(sock)
        ids = {k: client.submit(argvs[k])["id"] for k in ("pipeline",
                                                          "fused")}
        pair = {k: client.wait(jid, timeout=SERVE_JOB_S)
                for k, jid in ids.items()}
        pair_s = time.monotonic() - t_pair
        auto_poll.stop()
        auto = client.stats()["coalesce"] or {}
        check(any(n >= 2 for n in auto_poll.armed_at),
              f"serve: the opted-in coalescer never armed while two jobs "
              f"ran ({auto_poll.polls} polls): {auto}")
        launches = {}
        for k, job in pair.items():
            check(job["state"] == "done",
                  f"serve {k} job: {job['state']}: {job['error']}")
            check(_digest(out[k]) == standalone[k],
                  f"serve {k} job: output differs from the standalone run")
            with open(out[k] + ".json") as f:
                launches[k] = json.load(f)["launches"]
        p, fu = launches["pipeline"], launches["fused"]
        check(p["umi_hamming"] >= 1 and p["consensus_wire_full"] >= 1
              and not p["consensus_wire_filter"],
              f"serve pipeline job launches {p}")
        check(fu["consensus_wire_filter"] >= 1
              and not fu["umi_hamming"], f"serve fused job launches {fu}")
        # two plain simplex jobs at once on the forced-window daemon:
        # their K1 batches merge in the coalescer, each output
        # byte-identical to its standalone run
        up = co_log.listening.wait(SERVE_START_S)
        check(up and co_proc.poll() is None,
              f"serve (forced coalesce) did not start (rc "
              f"{co_proc.poll()}):\n{co_log.tail()}")
        co_client = ServeClient(co_sock, timeout=30)
        before = co_client.stats()["coalesce"] or {}
        t_co = time.monotonic()
        ids = {k: co_client.submit(argvs[k])["id"] for k in ("pair_a",
                                                             "pair_b")}
        co_jobs = {k: co_client.wait(jid, timeout=SERVE_JOB_S)
                   for k, jid in ids.items()}
        co_s = time.monotonic() - t_co
        co_k1 = 0
        for k, job in co_jobs.items():
            check(job["state"] == "done",
                  f"serve {k} job: {job['state']}: {job['error']}")
            check(_digest(out[k]) == standalone[k],
                  f"serve {k} job: output differs from the standalone run")
            with open(out[k] + ".json") as f:
                co_k1 += json.load(f)["launches"]["consensus_wire_full"]
        coal = co_client.stats()["coalesce"]
        merged = coal["merged_batches"] - before.get("merged_batches", 0)
        check(merged >= 1, f"serve coalesce: no merged batch: {coal}")
        check(co_k1 < 2 * solo_k1,
              f"serve coalesce: the pair launched K1 {co_k1} times, a solo "
              f"run {solo_k1}")
        co_client.shutdown()
        rc = co_proc.wait(timeout=120)
        check(rc == 0, f"serve (forced coalesce) exited {rc}:\n"
              f"{co_log.tail()}")
        # the canaries stand down while dispatches are in flight, and each
        # finished job replaces the daemon's flat counters: wait for three
        # after the last job
        deadline = time.monotonic() + 30
        stats = client.stats()
        while stats["metrics"].get("device.canary.ok", 0) < SERVE_CANARIES \
                and time.monotonic() < deadline:
            time.sleep(0.5)
            stats = client.stats()
        ok = stats["metrics"].get("device.canary.ok", 0)
        check(ok >= SERVE_CANARIES and not stats["metrics"].get(
            "device.canary.failed"), f"serve stats: {ok} canaries ok, "
            f"{stats['metrics'].get('device.canary.failed')} failed")
        check(stats["breaker"]["state"] == "closed",
              f"serve breaker {stats['breaker']}")
        status, body = _get_url(
            f"http://127.0.0.1:{dlog.metrics_port}/healthz")
        check(status == 200, f"serve /healthz {status}: {body}")
        status, text = _get_url(
            f"http://127.0.0.1:{dlog.metrics_port}/metrics")
        check(status == 200 and "fgumi_tpu_device_breaker_open 0" in text,
              f"serve /metrics {status}")
        k7_launches = stats["monitor"]["canary_launches"]
        check(k7_launches >= SERVE_CANARIES,
              f"serve: K7 launched {k7_launches} times")
        client.shutdown()
        rc = proc.wait(timeout=120)
        check(rc == 0, f"serve exited {rc}:\n{dlog.tail()}")
    finally:
        _stop_serve(co_proc, co_log)
        _stop_serve(proc, dlog)
    # the routing snapshot the daemon wrote on close
    with open(journal + ".routing.json") as f:
        snap = json.load(f)
    check(snap.get("schema_version") == 1 and "router" in snap,
          f"serve: routing snapshot {sorted(snap)}")
    summary = {
        "warm_up_s": dlog.warm_s, "start_s": start_s,
        "standalone_s": t_std,
        "cold": {k: cold[k] for k in ("run_s", "client_wall_s")},
        "warm": {k: warm[k] for k in ("run_s", "client_wall_s")},
        "pair_s": pair_s,
        "pair": {k: {"run_s": j["finished_unix"] - j["started_unix"],
                     "launches": {n: c for n, c in launches[k].items()
                                  if c}} for k, j in pair.items()},
        "canaries_ok": ok, "canaries": stats["monitor"]["canaries"],
        "k7_launches": k7_launches, "healthz": 200,
        # the opted-in auto window during the pipeline + fused pair
        "auto_coalesce": {
            "armed_polls": len(auto_poll.armed_at),
            "polls": auto_poll.polls,
            "priced_window_ms": auto.get("priced_window_ms"),
            **{k: auto.get(k, 0) - before_auto.get(k, 0)
               for k in ("merged_batches", "solo_flushes")}},
        "coalesce": {"pair_s": co_s, "merged_batches": merged,
                     "pair_k1": co_k1, "solo_k1": solo_k1,
                     "window_ms": coal["window_ms"],
                     "priced_window_ms": coal["priced_window_ms"],
                     "partners": coal["partners"],
                     "solo_flushes": coal["solo_flushes"],
                     "run_s": {k: j["finished_unix"] - j["started_unix"]
                               for k, j in co_jobs.items()}},
        "routing_snapshot": {"schema_version": snap["schema_version"],
                             "link_samples": snap["router"]["mesh"]["1"][
                                 "link_bps"]["samples"]},
        "phase_s": time.monotonic() - t0}
    print("serve " + json.dumps(summary), flush=True)
    k7 = check_canary_kernel(dev, 1 << 20, timed=True)
    for n in (1, 17, (1 << 20) + 13):
        check_canary_kernel(dev, n, timed=False)
    return (kernel_entry("canary_sum", k7, k7_launches, REPLACES_CANARY,
                         "serve_health_monitor", CANARY_SOURCE),
            (argvs["pipeline"], standalone["pipeline"]))


# ------------------------------------------------------------------ route

# the route phase (the offload router, the result sentinel and dispatch
# deadlines): in this process but R5, on inputs and cuda outputs the
# earlier phases built
ROUTE_INPUTS = ("longtail_200k", "duplex_240k", "many_quals_20k",
                "fixed5_1M")
ROUTE_DEADLINE = "0.5:2"   # R5's FGUMI_TPU_DISPATCH_DEADLINE_S
ROUTE_HANG_S = "30"        # R5's FGUMI_TPU_FAULT_HANG_S
# R5: the child exits 3 before the hang could have ended (a child needs
# ~8-11 s to reach its first dispatch on the card host), and its error line
# comes within the deadline's ceiling (+1 s) of the hang's start
ROUTE_EXIT_S = 25
WIRE_KERNELS = ("consensus_wire_full", "consensus_wire_filter",
                "consensus_wire_resident", "consensus_wire_packed2")


class _Env:
    """Environment variables set for one in-process run, restored after;
    the fault registry, the sentinel and the breaker start it clean and
    are left clean."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        from fgumi_tpu_torch.ops.breaker import BREAKER
        from fgumi_tpu_torch.ops.sentinel import SENTINEL
        from fgumi_tpu_torch.utils import faults

        self.old = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        faults.reset()
        SENTINEL.reset()
        BREAKER.reset()
        return self

    def __exit__(self, *exc):
        from fgumi_tpu_torch.ops.breaker import BREAKER
        from fgumi_tpu_torch.ops.sentinel import SENTINEL
        from fgumi_tpu_torch.utils import faults

        for k, v in self.old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        faults.reset()
        SENTINEL.reset()
        BREAKER.reset()
        return False


def route_run(label, command, inp, flags, work, env):
    """One in-process ``cuda`` run of ``command`` under ``env`` with a run
    report, between a reset and a read of the launch counts: its
    ``--stats-json``, its report, its counts, the sentinel's and the
    breaker's snapshots after it, and its output path."""
    from fgumi_tpu_torch import cli
    from fgumi_tpu_torch.ops.breaker import BREAKER
    from fgumi_tpu_torch.ops.sentinel import SENTINEL

    out = os.path.join(work, f"route_{label}.bam")
    rpt = out + ".report.json"
    with _Env(**env):
        reset_counts()
        t0 = time.monotonic()
        rc = cli.main(["--run-report", rpt, command, "-i", inp, "-o", out,
                       "--device", "cuda", "--stats-json", out + ".json",
                       *flags])
        wall = time.monotonic() - t0
        counts = read_counts()
        audit = SENTINEL.snapshot()
        breaker = BREAKER.snapshot()
    check(rc == 0, f"route {label}: exit {rc}")
    with open(out + ".json") as f:
        st = json.load(f)
    with open(rpt) as f:
        report = json.load(f)
    return {"st": st, "report": report, "counts": counts, "audit": audit,
            "breaker": breaker, "out": out, "wall_s": wall}


def route_phase(paths, work, clean) -> dict:
    """R1-R5 (the offload router, the result sentinel, deadlines).
    ``clean``: the earlier ``cuda`` run of each case, name -> (command,
    flags, summary with ``out``, its wire kernel)."""
    t0 = time.monotonic()
    out = {}
    # R5's child starts first and runs beside R1-R4 (its own process and
    # clock: a launch that hangs on the host, abandoned at its deadline)
    command, inp, flags, ref, kernel = clean["longtail_200k_fast"]
    res = os.path.join(work, "route_deadline.bam")
    r5 = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", command, "-i", inp, "-o",
         res, "--device", "cuda", *flags], stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, **_child_kwargs(
            {"FGUMI_TPU_FAULT": "device.dispatch:hang:1.0:1",
             "FGUMI_TPU_FAULT_HANG_S": ROUTE_HANG_S,
             "FGUMI_TPU_DISPATCH_DEADLINE_S": ROUTE_DEADLINE}))
    t1 = time.monotonic()
    r5_out = {}

    def r5_wait():
        try:
            r5_out["stderr"] = r5.communicate(timeout=120)[1]
        except subprocess.TimeoutExpired:
            r5.kill()
            r5_out["stderr"] = r5.communicate()[1]
        r5_out["end"] = time.monotonic()

    import threading

    r5_thread = threading.Thread(target=r5_wait, daemon=True)
    r5_thread.start()
    try:
        # R1: every dispatch audited inline against the f64 host engine
        r1 = {}
        for name in ("longtail_200k_fast", "longtail_200k_fused",
                     "duplex_240k", "many_quals_20k"):
            command, inp, flags, ref, kernel = clean[name]
            r = route_run(f"audit_{name}", command, inp, flags, work,
                          {"FGUMI_TPU_AUDIT": "all"})
            dispatches = r["st"]["device_stats"]["dispatches"]
            a = r["audit"]
            check(a["sampled"] == dispatches and dispatches > 0
                  and a["divergent"] == 0 and a["dropped"] == 0,
                  f"route R1 {name}: audit {a}, {dispatches} dispatches")
            check(r["counts"][kernel] > 0,
                  f"route R1 {name}: {kernel} never launched: {r['counts']}")
            check(records(r["out"]) == records(ref["out"]),
                  f"route R1 {name}: records differ from the cuda run's")
            r1[name] = {"kernel": kernel, "launches": r["counts"][kernel],
                        "dispatches": dispatches, "sampled": a["sampled"],
                        "clean": a["clean"], "divergent": 0,
                        "wall_s": r["wall_s"], "cuda_wall_s": ref["wall_s"]}
        out["R1"] = r1
        # R2: one corrupted fetch under AUDIT=all: caught, quarantined,
        # repaired
        command, inp, flags, ref, kernel = clean["longtail_200k_fast"]
        r = route_run("corrupt", command, inp, flags, work,
                      {"FGUMI_TPU_AUDIT": "all",
                       "FGUMI_TPU_FAULT": "device.fetch:corrupt-result:1.0:1"})
        a, b = r["audit"], r["breaker"]
        check(a["divergent"] >= 1, f"route R2: audit {a}")
        check(b.get("sdc_trips", 0) >= 1 and any(
            "silent data corruption" in t["reason"] for t in b["transitions"]),
            f"route R2: breaker {b}")
        check(r["report"].get("audit", {}).get("divergence"),
              "route R2: no audit.divergence in the run report")
        check(r["report"]["exit_status"] == 0, "route R2: exit status")
        check(records(r["out"]) == records(ref["out"]),
              "route R2: records differ from the clean run's")
        out["R2"] = {"divergent": a["divergent"], "sdc_trips": b["sdc_trips"],
                     "fields": a["divergence"][0]["fields"],
                     "families": a["divergence"][0]["families"],
                     "exit": 0, "wall_s": r["wall_s"]}
        # R3: every batch on the native f64 engine, the card idle
        r = route_run("host", command, inp, flags, work,
                      {"FGUMI_TPU_ROUTE": "host"})
        wire = {k: r["counts"][k] for k in WIRE_KERNELS}
        dev = r["st"]["device_stats"]
        check(not any(wire.values()), f"route R3: wire launches {wire}")
        check(r["st"]["host_batches"] > 0
              and dev.get("route_host") == r["st"]["host_batches"]
              and not dev.get("route_device"),
              f"route R3: {r['st']['host_batches']} host batches, routes "
              f"{dev}")
        check(records(r["out"]) == records(ref["out"]),
              "route R3: records differ from the cuda run's")
        out["R3"] = {"host_batches": r["st"]["host_batches"],
                     "route_host": dev.get("route_host"),
                     "wall_s": r["st"]["wall_s"], "cuda_wall_s": ref["wall_s"]}
        # R4: the opt-in hybrid cost model on fixed5_1M
        command, inp, flags, ref, kernel = clean["fixed5_1M_fast"]
        r = route_run("hybrid", command, inp, flags, work,
                      {"FGUMI_TPU_HYBRID": "1"})
        dev = r["st"]["device_stats"]
        k1 = r["counts"]["consensus_wire_full"]
        host = r["st"]["host_batches"]
        check(k1 + host == ref["device_batches"],
              f"route R4: {k1} K1 launches + {host} host batches != "
              f"{ref['device_batches']} batches")
        check(records(r["out"]) == records(ref["out"]),
              "route R4: records differ from the cuda run's")
        out["R4"] = {"route_device": dev.get("route_device", 0),
                     "route_host": dev.get("route_host", 0),
                     "probes": r["report"]["metrics"].get("device.route.probe",
                                                          0),
                     "k1_launches": k1, "host_batches": host,
                     "routing": r["report"].get("device", {}).get("routing"),
                     "report_path": r["out"] + ".report.json",
                     "wall_s": r["st"]["wall_s"], "cuda_wall_s": ref["wall_s"]}
    except BaseException:
        # a failed check above must not leave the child behind
        if r5.poll() is None:
            r5.kill()
        raise
    # R5: its child's end
    r5_thread.join(180)
    check("end" in r5_out, "route R5: the child did not end")
    stderr = r5_out["stderr"]
    child_s = r5_out["end"] - t1
    errors = _error_lines(stderr)
    check(r5.returncode == 3,
          f"route R5: exit {r5.returncode}: {stderr[-2000:]}")
    check(child_s < ROUTE_EXIT_S, f"route R5: the child took {child_s:.1f}s")
    # the child's own log clock (+seconds since its start): the hang began,
    # the deadline line came
    stamps = {}
    for ln in stderr.splitlines():
        m = re.search(r"\+([0-9.]+)s\]: (.*)$", ln)
        if m and "hanging" in m.group(2):
            stamps["hang"] = float(m.group(1))
        elif m and "did not complete within" in m.group(2):
            stamps["deadline"] = float(m.group(1))
    ceiling = float(ROUTE_DEADLINE.split(":")[1])
    check(len(stamps) == 2
          and stamps["deadline"] - stamps["hang"] < ceiling + 1.0,
          f"route R5: hang and deadline stamps {stamps}")
    base = os.path.basename(res)
    left = [f for f in os.listdir(work) if f.startswith((base, f".{base}"))]
    check(left == [], f"route R5: published {left}")
    check(len(errors) == 1 and "did not complete within" in errors[0],
          f"route R5: error lines {errors}")
    out["R5"] = {"exit": 3, "child_wall_s": child_s,
                 "hang_at_s": stamps["hang"],
                 "deadline_after_s": stamps["deadline"] - stamps["hang"],
                 "error_line": errors[0].split(": ", 1)[-1]}
    out["phase_s"] = time.monotonic() - t0
    print("route " + json.dumps(out), flush=True)
    return out


def route_clean_runs(paths, work, e2e, duplexes) -> dict:
    """The earlier cuda run of each route case: (command, input, flags,
    summary, the kernel the case holds)."""
    return {
        "longtail_200k_fast": ("simplex", paths["longtail_200k"], [],
                               e2e["longtail_200k"]["fast"],
                               "consensus_wire_full"),
        "longtail_200k_fused": ("simplex", paths["longtail_200k"],
                                ["--min-reads", "1", "--device-filter",
                                 *FILTER_OPTS],
                                e2e["longtail_200k"]["fused"],
                                "consensus_wire_filter"),
        "duplex_240k": ("duplex", paths["duplex_240k"], [],
                        duplexes["duplex_240k"]["cuda"],
                        "consensus_wire_resident"),
        "many_quals_20k": ("simplex", paths["many_quals_20k"], [],
                           e2e["many_quals_20k"]["fast"],
                           "consensus_wire_packed2"),
        "fixed5_1M_fast": ("simplex", paths["fixed5_1M"], [],
                           e2e["fixed5_1M"]["fast"], "consensus_wire_full")}


# ------------------------------------------------------------------ fleet

# the fleet phase: two journaled daemons on the one card behind a
# host-only balancer that scatters each whale into FLEET_SHARDS shards
FLEET_INPUTS = ("longtail_200k", "duplex_240k", "pipeline_k4_50k")
FLEET_SHARDS = 3
FLEET_SCAN_S = 1  # each daemon's --lease-scan-period
FLEET_TAKEOVER_S = 3  # bound on a dead peer's jobs reappearing on its peer
# the kernels every shard of a whale must launch (its own --stats-json)
FLEET_SHARD_KERNELS = {
    "simplex": ("consensus_wire_full",),
    "duplex": ("consensus_wire_resident", "duplex_combine"),
    "pipeline": ("umi_hamming", "consensus_wire_full")}


def fleet_argvs(paths, work, pipeline_argv=None) -> dict:
    """The argv of each fleet run: the e2e phase's ``longtail_200k`` simplex
    runs (fast and fused), the duplex phase's ``duplex_240k`` cuda run and
    the serve phase's pipeline job (``pipeline_argv``; built alike when the
    phase runs alone). The same argv, so those runs' outputs are the
    standalone references: a whale's @PG line is its submitted command
    line."""
    lt, dx = paths["longtail_200k"], paths["duplex_240k"]

    def simplex(name, flags):
        out = os.path.join(work, f"{name}.cuda.bam")
        return ["simplex", "-i", lt, "-o", out, "--device", "cuda",
                "--stats-json", out + ".json", *flags]

    dout = os.path.join(work, "duplex_240k.cuda.bam")
    if pipeline_argv is None:
        r1, r2 = paths["pipeline_k4_50k"]
        pout = os.path.join(work, "serve_pipeline.bam")
        pipeline_argv = ["pipeline", "-i", r1, r2, *PIPELINE_OPTS, "-o",
                         pout, "--device", "cuda", "--stats-json",
                         pout + ".json"]
    return {"simplex": simplex("longtail_200k_fast", []),
            "fused": simplex("longtail_200k_fused", [
                "--min-reads", "1", "--device-filter", *FILTER_OPTS]),
            "duplex": ["duplex", "-i", dx, "-o", dout, "--device", "cuda",
                       "--stats-json", dout + ".json"],
            "pipeline": pipeline_argv}


def fleet_runs_alone(paths, work) -> dict:
    """``--phase fleet``: each fleet argv run standalone here once, {name:
    (argv, digest, wall)}."""
    runs = {}
    for name, argv in fleet_argvs(paths, work).items():
        t0 = time.monotonic()
        digest = _standalone_digest(argv)
        runs[name] = (argv, digest, time.monotonic() - t0)
    return runs


def _fleet_spawn(argv, kw):
    proc = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", *argv],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, **kw)
    return proc, _DaemonLog(proc)


def _fleet_up(name, proc, dlog, timeout=SERVE_START_S):
    up = dlog.listening.wait(timeout)
    check(up and proc.poll() is None,
          f"fleet {name} did not start (rc {proc.poll()}):\n{dlog.tail()}")


def _fleet_whale(client, name, run):
    """One whale through the balancer: done, the gathered BAM's digest the
    standalone run's, every shard ``done`` and its own launch tally showing
    its kernels. Returns its summary."""
    argv, digest, standalone_s = run
    out = argv[argv.index("-o") + 1]
    t0 = time.monotonic()
    job = client.wait(client.submit(argv)["id"], timeout=SERVE_JOB_S)
    wall = time.monotonic() - t0
    check(job["state"] == "done",
          f"fleet {name} whale: {job['state']}: {job['error']}")
    check(_digest(out) == digest,
          f"fleet {name} whale: the gathered BAM differs from the "
          "standalone run's")
    shards = job["scatter"]["shards"]
    check([s["state"] for s in shards] == ["done"] * FLEET_SHARDS,
          f"fleet {name} whale: shards {shards}")
    stats = argv[argv.index("--stats-json") + 1]
    tallies = []
    for k in range(FLEET_SHARDS):
        with open(f"{stats}.s{k}of{FLEET_SHARDS}") as f:
            launches = json.load(f)["launches"]
        for kern in FLEET_SHARD_KERNELS[name]:
            check(launches[kern] >= 1, f"fleet {name} shard {k}: {kern} "
                                       f"launched {launches[kern]} times")
        tallies.append({k: n for k, n in launches.items() if n})
    return {"id": job["id"], "wall_s": wall,
            "run_s": job["finished_unix"] - job["started_unix"],
            "standalone_s": standalone_s,
            "shard_jobs": [s["job_id"] for s in shards],
            "shard_launches": tallies}


def _fleet_takeover(socks, jdir, runs, procs):
    """Two simplex jobs submitted straight to daemon ``b``, ``b`` SIGKILLed
    once the first runs: ``a`` must show both under their original ids
    within FLEET_TAKEOVER_S and finish both byte-identically; ``b``'s
    journal renamed ``.claimed``; ``a``'s fleet section one takeover of
    two jobs."""
    from fgumi_tpu_torch.serve.client import ServeClient, ServeError

    cb = ServeClient(socks["b"], timeout=30)
    names = ("simplex", "fused")
    ids = [cb.submit(runs[n][0])["id"] for n in names]
    deadline = time.monotonic() + SERVE_JOB_S
    while cb.job(ids[0])["state"] != "running":
        check(time.monotonic() < deadline, "fleet: b's first job never ran")
        time.sleep(0.01)
    states = [cb.job(i)["state"] for i in ids]
    proc_b = procs["b"][0]
    proc_b.kill()
    proc_b.wait(timeout=60)
    t_kill = time.monotonic()
    ca = ServeClient(socks["a"], timeout=30)
    while True:
        try:
            for jid in ids:
                ca.job(jid)
            break
        except ServeError:
            check(time.monotonic() - t_kill < FLEET_TAKEOVER_S,
                  f"fleet: a did not adopt {ids} within {FLEET_TAKEOVER_S}s")
            time.sleep(0.02)
    adopt_s = time.monotonic() - t_kill
    for n, jid in zip(names, ids):
        job = ca.wait(jid, timeout=SERVE_JOB_S)
        check(job["state"] == "done",
              f"fleet takeover {jid}: {job['state']}: {job['error']}")
        out = runs[n][0][runs[n][0].index("-o") + 1]
        check(_digest(out) == runs[n][1],
              f"fleet takeover {jid}: output differs from the standalone "
              "run's")
    done_s = time.monotonic() - t_kill
    check(os.path.exists(os.path.join(jdir, "b.journal.claimed"))
          and not os.path.exists(os.path.join(jdir, "b.journal")),
          f"fleet: b's journal not claimed: {sorted(os.listdir(jdir))}")
    stats = ca.stats()
    fleet = stats["fleet"]
    check(fleet["takeovers"] == 1 and fleet["takeover_jobs"] == 2,
          f"fleet: a's fleet section {fleet}")
    return {"ids": ids, "states_at_kill": states, "adopt_s": adopt_s,
            "done_s": done_s, "a_fleet": {k: fleet[k] for k in (
                "takeovers", "takeover_jobs", "takeover_skipped_dedupe")},
            "k7_launches_a": stats["monitor"]["canary_launches"]}


def fleet_phase(work, runs) -> dict:
    """Fleet operation on the card: daemons ``a`` and ``b`` (``serve
    --journal-dir --fleet-id a|b --lease-scan-period 1 --workers 1
    --health-period 1``, each its own process and CUDA context, warmed up
    side by side) behind a host-only ``balance --scatter 3 --scatter-wal
    --metrics-port 0`` (no CUDA library mapped); three whales (``runs``:
    simplex on ``longtail_200k``, duplex on ``duplex_240k``, the pipeline
    on ``pipeline_k4_50k``'s FASTQ pair) each gathered into the standalone
    run's bytes, every shard ``done`` with its own launch tally showing
    its kernels, ``jobs --scatter`` agreeing and the balancer's
    ``/healthz`` 200; then the takeover (:func:`_fleet_takeover`); ``b``
    restarted takes its lease and replays nothing; every process shut
    down gracefully, exit 0. Returns its summary, with the kernels'
    launches summed over the whales' shards and ``a``'s K7 canaries."""
    import contextlib
    import io

    from fgumi_tpu_torch import cli
    from fgumi_tpu_torch.serve.client import ServeClient

    t0 = time.monotonic()
    fdir = os.path.join(work, "fleet")
    jdir = os.path.join(fdir, "journals")
    os.makedirs(jdir)
    socks = {k: os.path.join(fdir, f"{k}.sock") for k in ("a", "b", "front")}
    kw = _child_kwargs()
    kw.pop("text")

    def serve(fid, warm):
        return _fleet_spawn(
            ["serve", "--socket", socks[fid], "--journal-dir", jdir,
             "--fleet-id", fid, "--lease-scan-period", str(FLEET_SCAN_S),
             "--workers", "1",
             *(["--health-period", "1"] if warm else ["--no-warmup"])], kw)

    procs = {}
    try:
        procs["a"], procs["b"] = serve("a", True), serve("b", True)
        for fid in ("a", "b"):
            _fleet_up(fid, *procs[fid])
        start_s = time.monotonic() - t0
        warm = {fid: procs[fid][1].warm_s for fid in ("a", "b")}
        check(all(warm.values()), f"fleet: warm-ups {warm}")
        procs["balance"] = _fleet_spawn(
            ["balance", "--listen", f"unix:{socks['front']}", "--backend",
             f"unix:{socks['a']}", "--backend", f"unix:{socks['b']}",
             "--scatter", str(FLEET_SHARDS), "--scatter-wal",
             os.path.join(fdir, "scatter.wal"), "--metrics-port", "0",
             "--poll-period", "0.5"], kw)
        bal, bal_log = procs["balance"]
        _fleet_up("balance", bal, bal_log, timeout=120)
        with open(f"/proc/{bal.pid}/maps") as f:
            maps = f.read()
        check("libcuda" not in maps and "libtorch" not in maps,
              "fleet: the balancer mapped a CUDA or torch library")
        client = ServeClient(socks["front"], timeout=30)
        whales = {name: _fleet_whale(client, name, runs[name])
                  for name in ("simplex", "duplex", "pipeline")}
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["jobs", "--socket", socks["front"], "--scatter"])
        check(rc == 0, f"fleet: jobs --scatter exited {rc}")
        section = {j["id"]: j for j in json.loads(buf.getvalue())["jobs"]}
        for name, w in whales.items():
            got = section.get(w["id"], {})
            check(got.get("state") == "done"
                  and got.get("shards") == {"done": FLEET_SHARDS},
                  f"fleet: jobs --scatter shows {name} as {got}")
        status, body = _get_url(
            f"http://127.0.0.1:{bal_log.metrics_port}/healthz")
        check(status == 200, f"fleet: balancer /healthz {status}: {body}")
        with open(f"/proc/{bal.pid}/maps") as f:
            maps = f.read()
        check("libcuda" not in maps and "libtorch" not in maps,
              "fleet: the balancer (and its gathers) mapped a CUDA or "
              "torch library")
        whales_s = time.monotonic() - t0 - start_s
        take = _fleet_takeover(socks, jdir, runs, procs)
        t_restart = time.monotonic()
        procs["b2"] = serve("b", False)
        _fleet_up("b (restarted)", *procs["b2"])
        journal = ServeClient(socks["b"], timeout=30).stats()["journal"]
        check(journal["replayed"] == 0 and journal["requeued"] == 0,
              f"fleet: the restarted b replayed {journal}")
        restart_s = time.monotonic() - t_restart
        for key, sock in (("balance", socks["front"]), ("a", socks["a"]),
                          ("b2", socks["b"])):
            ServeClient(sock, timeout=30).shutdown()
            rc = procs[key][0].wait(timeout=120)
            check(rc == 0, f"fleet: {key} exited {rc}:\n"
                           f"{procs[key][1].tail()}")
    finally:
        for proc, dlog in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
            dlog.join()
    launches = {}
    for w in whales.values():
        for tally in w["shard_launches"]:
            for kern, n in tally.items():
                launches[kern] = launches.get(kern, 0) + n
    launches["canary_sum"] = take["k7_launches_a"]
    summary = {"warm_up_s": warm, "start_s": start_s, "whales": whales,
               "whales_s": whales_s, "takeover": take,
               "restart_s": restart_s, "launches": launches,
               "phase_s": time.monotonic() - t0}
    print("fleet " + json.dumps(summary), flush=True)
    return summary


# -------------------------------------------------------------------- main

# ------------------------------------------------------------------- tune

# the tune phase: ``tune --quick`` in a child, ``tune --replay`` of an
# earlier cuda run's report, and two runs under the tuned profile
TUNE_INPUTS = ("longtail_200k", "duplex_240k")
TUNE_SOURCE = "fgumi_tpu_torch/csrc/tune_combine.cu"
REPLACES_TUNE_COMBINE = "fgumi_tpu/tune/autotune.py:207"
# K8's shapes: ``tune --quick``'s (512, 100) and the full sweep's (4096,
# 150); a small odd shape for the 16-byte path's tail
TUNE_SHAPES = ((512, 100), (4096, 150))
TUNE_TAIL_SHAPE = (37, 99)
TUNE_QUICK_CELLS = ("fixed3_L100", "fixed10_L100", "fixed30_L100")
# ``_timeit``: a warm-up and 3 timed calls of each side a cell, one K8
# call a timed call in the chooser bench
TUNE_CALLS = 4
TUNE_LAUNCH_LINE = re.compile(
    r"tune: (\d+) wire dispatches on cuda; launches consensus_wire_full "
    r"(\d+), consensus_wire_packed2 (\d+), tune_combine (\d+)")
ROUTER_PRIORS = ("link_mbps", "overhead_s", "dispatch_wall_s",
                 "host_mcells_per_s", "filter_keep_rate")


def tune_combine_inputs(n: int, L: int, dev) -> dict:
    """K8's inputs at (n, L), name -> (x, y) on ``dev``: ``sweep``, the
    chooser bench's own arrays (0-40 from seeds 5 and 6); ``bytes``,
    random bytes 0-255; ``wrap``, bytes 250-255, half the cells equal (min
    + 3 wraps past 255 at 253-255); ``unaligned``, the sweep's arrays 1
    byte past a 16-byte boundary of their buffers (the kernel's byte
    path)."""
    import torch

    rng = np.random.default_rng(n * L)
    sweep = tuple(np.random.default_rng(s).integers(0, 41, (n, L),
                                                    dtype=np.uint8)
                  for s in (5, 6))
    full = tuple(rng.integers(0, 256, (n, L), dtype=np.uint8)
                 for _ in range(2))
    wx = rng.integers(250, 256, (n, L), dtype=np.uint8)
    wy = np.where(rng.random((n, L)) < 0.5, wx,
                  rng.integers(250, 256, (n, L), dtype=np.uint8))
    out = {name: tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                       for a in pair)
           for name, pair in (("sweep", sweep), ("bytes", full),
                              ("wrap", (wx, wy.astype(np.uint8))))}

    def unaligned(a):
        buf = torch.empty(a.size + 16, dtype=torch.uint8, device=dev)
        view = buf[1:1 + a.size].view(n, L)
        view.copy_(torch.from_numpy(a).to(dev))
        return view

    out["unaligned"] = tuple(unaligned(a) for a in sweep)
    return out


def check_tune_combine_kernel(dev, shape, timed: bool) -> dict:
    """K8 (``ops/tune_combine.tune_combine``) against its plain version on
    the card and the chooser bench's numpy expression, exactly, on every
    input of :func:`tune_combine_inputs` at ``shape``; with ``timed`` also
    its times beside the bound and the plain version's (no single PyTorch
    call computes it: library "n/a"). Launches made here are not the main
    path's: the count is restored."""
    import torch

    from fgumi_tpu_torch.ops import tune_combine as TC

    n, L = shape
    launches0 = TC.TUNE_COMBINE_LAUNCHES
    inputs = tune_combine_inputs(n, L, dev)
    err = 0
    for name, (x, y) in inputs.items():
        got = TC.tune_combine(x, y)
        want = TC.tune_combine_plain(x, y)
        torch.cuda.synchronize()
        a, b = x.cpu().numpy(), y.cpu().numpy()
        ref = np.where(a == b, np.minimum(a, b) + 3,
                       np.maximum(a, b) - np.minimum(a, b))
        check(got.dtype == torch.uint8 and tuple(got.shape) == (n, L),
              f"K8 {name} {n}x{L}: output {got.dtype} {tuple(got.shape)}")
        diff = int((got.int() - want.int()).abs().max())
        check(diff == 0, f"K8 {name} {n}x{L}: kernel and plain differ "
                         f"(max |diff| {diff})")
        check(np.array_equal(got.cpu().numpy(), ref),
              f"K8 {name} {n}x{L}: kernel differs from numpy's expression")
        err = max(err, diff)
    wx, wy = inputs["wrap"]
    check(bool(((wx == wy) & (wx >= 253)).any()),
          f"K8 wrap {n}x{L}: no cell wraps")
    check(TC.TUNE_COMBINE_LAUNCHES == launches0 + len(inputs),
          "K8: a launch was not counted")
    TC.TUNE_COMBINE_LAUNCHES = launches0
    res = {"shape": [n, L], "max_abs_err": err, "bytes": 3 * n * L,
           # 32-bit lane operations: min, max, compare, add, subtract and
           # the select (and, and-not, or) a 4-cell word
           "ops": 2 * n * L, "geometry": TC.launch_geometry(n * L),
           "geometry_unaligned": TC.launch_geometry(n * L, vector=False),
           "registers": ptxas_registers("tune_combine_kernel")}
    print(f"check K8 tune_combine {n}x{L}: exact against plain and numpy "
          f"on {', '.join(inputs)}; geometry {res['geometry']}, unaligned "
          f"{res['geometry_unaligned']}, {res['registers']} registers",
          flush=True)
    if timed:
        x, y = inputs["sweep"]
        _time(res, lambda: TC.tune_combine(x, y),
              lambda: TC.tune_combine_plain(x, y), TC,
              "TUNE_COMBINE_LAUNCHES", "tune_combine_kernel")
        res["library_ms"] = None
        print(f"time K8 tune_combine {n}x{L} " + json.dumps(
            {k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "call_ms", "loop_ms", "plain_call_ms")}),
            flush=True)
    return res


def start_tune(work) -> dict:
    """``tune --quick --device cuda`` into ``work`` in a child process,
    waited for on a thread (so the phases in this process go on meanwhile);
    returns its handle for :func:`tune_phase`. The child's environment is
    this process's at the call with ``FGUMI_TPU_ROUTE=host``, which sends
    every routed batch to the native engine: the tuner's device column
    calls the wire dispatch itself, so K1 must still launch on each timed
    device call."""
    import threading

    paths = {k: os.path.join(work, f"tune_{k}.json")
             for k in ("profile", "atlas")}
    argv = ["tune", "--quick", "--device", "cuda", "-o", paths["profile"],
            "--atlas", paths["atlas"]]
    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-m", "fgumi_tpu_torch", *argv],
        stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, **_child_kwargs({"FGUMI_TPU_ROUTE": "host"}))
    # a check failing before the tune phase must not leave it behind
    atexit.register(lambda: proc.poll() is None and proc.kill())
    done = {}

    def wait():
        try:
            done["stderr"] = proc.communicate(timeout=600)[1]
        except subprocess.TimeoutExpired:
            proc.kill()
            done["stderr"] = proc.communicate()[1]
        done["wall_s"] = time.monotonic() - t0

    thread = threading.Thread(target=wait, daemon=True)
    thread.start()
    return {"proc": proc, "thread": thread, "done": done, "argv": argv,
            **paths}


def _tune_outputs(tune) -> dict:
    """The tune child's end: exit 0, both files valid under the port's
    validator, the 3 quick cells with both rates and a winner, K1 launched
    on every timed device call and K8 ``TUNE_CALLS`` times (its launch
    line). Returns the summary of the ``tune`` line."""
    import torch

    from fgumi_tpu_torch.tune.profile import load_profile

    tune["thread"].join(660)
    done = tune["done"]
    check("stderr" in done, "tune: the child did not end")
    stderr = done["stderr"]
    check(tune["proc"].returncode == 0,
          f"tune: exit {tune['proc'].returncode}: {stderr[-3000:]}")
    check("device feeder gate timed out" not in stderr,
          "tune: the feeder's gate timed out")
    m = TUNE_LAUNCH_LINE.search(stderr)
    check(m is not None, f"tune: no launch line: {stderr[-2000:]}")
    dispatches, k1, k1p2, k8 = (int(g) for g in m.groups())
    calls = TUNE_CALLS * len(TUNE_QUICK_CELLS)
    check(dispatches == k1 == calls and k1p2 == 0,
          f"tune: {dispatches} dispatches, K1 {k1}, K1-p2 {k1p2}: K1 must "
          f"launch on each of the {calls} timed device calls")
    check(k8 == TUNE_CALLS, f"tune: K8 launched {k8} times, not "
                            f"{TUNE_CALLS}")
    prof = load_profile(tune["profile"])
    with open(tune["atlas"]) as f:
        atlas = json.load(f)
    check(atlas.get("kind") == "fgumi-tpu-crossover-atlas"
          and atlas.get("schema_version") == 1, "tune: not an atlas")
    cells = atlas["cells"]
    check(tuple(c["name"] for c in cells) == TUNE_QUICK_CELLS,
          f"tune: atlas cells {[c['name'] for c in cells]}")
    for c in cells:
        check(c["device_rows_per_sec"] > 0 and c["host_rows_per_sec"] > 0
              and c["winner"] in ("device", "host"),
              f"tune: atlas cell {c}")
    fp = prof["fingerprint"]
    check(fp.get("torch_backend") == "cuda"
          and fp.get("device_count") == torch.cuda.device_count(),
          f"tune: fingerprint {fp}")
    check(prof["knobs"].get("mesh") == ("auto" if torch.cuda.device_count()
                                        > 1 else "off"),
          f"tune: mesh knob {prof['knobs']}")
    router = dict(prof["priors"]["router"])
    # the router's link EWMA: bytes uploaded over the feeder's staging
    # copy and launch of a dispatch, not PCIe alone
    router["link_mbps_is"] = "the feeder's staging copy and launch"
    return {
        "cells": {c["name"]: {k: c[k] for k in (
            "rows", "families", "device_rows_per_sec", "host_rows_per_sec",
            "device_vs_host", "winner")} for c in cells},
        "crossover": atlas["crossover"], "knobs": prof["knobs"],
        "choosers": prof["priors"].get("choosers"), "router": router,
        "dispatches": dispatches, "k1_launches": k1, "k8_launches": k8,
        "child_wall_s": done["wall_s"]}


def _tune_replay(work, report_path) -> dict:
    """``tune --replay`` of one earlier cuda run's report, in this process
    (it loads no profile and starts no kernel): its router priors must be
    that report's ``device.routing`` values."""
    from fgumi_tpu_torch import cli
    from fgumi_tpu_torch.tune.profile import load_profile

    out = os.path.join(work, "tune_replay.json")
    rc = cli.main(["tune", "--replay", report_path, "-o", out, "--atlas",
                   "", "--device", "cuda"])
    check(rc == 0, f"tune --replay: exit {rc}")
    prof = load_profile(out)
    with open(report_path) as f:
        routing = json.load(f)["device"]["routing"]
    want = {k: round(routing[k], 6) for k in ROUTER_PRIORS
            if isinstance(routing.get(k), (int, float)) and routing[k] > 0}
    check(prof["source"] == "replay" and prof["priors"]["router"] == want,
          f"tune --replay: priors {prof['priors']['router']}, the report's "
          f"routing {want}")
    return {"router": want, "knobs": prof["knobs"]}


def _profile_runs(prof_path, prof, refs, work) -> dict:
    """Each reference run's argv again under ``--profile``, in children at
    once: exit 0, the reference's records, the run report's ``profile``
    section (the knobs applied, the router seeded) and
    ``device.routing.prior_source`` "profile", the run's kernels launched,
    and no gate timeout in its log."""
    procs = {}
    for name, (command, inp, flags, ref) in refs.items():
        out = os.path.join(work, f"tune_profile_{name}.bam")
        argv = ["--profile", prof_path, "--run-report", out + ".report.json",
                command, "-i", inp, "-o", out, "--device", "cuda",
                "--stats-json", out + ".json", *flags]
        procs[name] = (out, subprocess.Popen(
            [sys.executable, "-m", "fgumi_tpu_torch", *argv],
            stdin=subprocess.DEVNULL, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, **_child_kwargs()))
    runs = {}
    for name, (out, proc) in procs.items():
        try:
            stderr = proc.communicate(timeout=600)[1]
        except subprocess.TimeoutExpired:
            for _, p in procs.values():
                p.kill()
            raise
        command, _, _, ref = refs[name]
        check(proc.returncode == 0,
              f"profile {name}: exit {proc.returncode}: {stderr[-2000:]}")
        check("gate timed out" not in stderr,
              f"profile {name}: the feeder's gate timed out")
        check(records(out) == records(ref["out"]),
              f"profile {name}: records differ from the cuda run's")
        with open(out + ".report.json") as f:
            report = json.load(f)
        with open(out + ".json") as f:
            st = json.load(f)
        sec = report.get("profile") or {}
        check(sec.get("path") == prof_path
              and sorted(sec.get("knobs_applied", [])) == sorted(
                  prof["knobs"]) and sec.get("seeded_router") is True,
              f"profile {name}: report section {sec}")
        routing = report.get("device", {}).get("routing", {})
        check(routing.get("prior_source") == "profile",
              f"profile {name}: prior source {routing.get('prior_source')}")
        kernels = ("consensus_wire_full",) if command == "simplex" else (
            "consensus_wire_resident", "duplex_combine")
        check(all(st["launches"][k] > 0 for k in kernels),
              f"profile {name}: launches {st['launches']}")
        runs[name] = {"wall_s": st["wall_s"], "ref_wall_s": ref["wall_s"],
                      "launches": {k: st["launches"][k] for k in kernels},
                      "knobs_applied": sec["knobs_applied"],
                      "fingerprint_mismatch": sec["fingerprint_mismatch"],
                      "records_identical": True}
    return runs


def _turns_profile(prof, prof_path, work) -> tuple:
    """The profile the turns run under: it must carry what a port-tuned
    profile changes, ``feeder_depth`` 2 (the port's default is 8) and a
    coalescer window. The derived one where it does; else a copy of it
    with those knobs (the window the derived one's, else the tuner's
    floor, 0.5 ms), written beside it. Returns (its path, its knobs, which
    one)."""
    from fgumi_tpu_torch.tune.profile import write_profile

    knobs = prof["knobs"]
    if knobs.get("feeder_depth") == 2 and knobs.get("coalesce_window_ms"):
        return prof_path, dict(knobs), "derived"
    doc = json.loads(json.dumps(prof))
    doc["knobs"].update(feeder_depth=2, coalesce_window_ms=knobs.get(
        "coalesce_window_ms") or 0.5)
    path = os.path.join(work, "tune_turns_profile.json")
    write_profile(path, doc)
    return path, dict(doc["knobs"]), "written"


def _profile_turns(prof_path, refs, work) -> dict:
    """Each reference run's argv in children one at a time, without and
    with ``--profile`` in turns (plain, profile, profile, plain): the
    records of every run equal the reference's; each run's own wall
    (``--stats-json``) and its child's."""
    turns = {}
    for name, (command, inp, flags, ref) in refs.items():
        walls = {"plain": [], "profile": []}
        for i, kind in enumerate(("plain", "profile", "profile", "plain")):
            out = os.path.join(work, f"tune_turn_{name}_{i}.bam")
            pre = ["--profile", prof_path, "--run-report",
                   out + ".report.json"] if kind == "profile" else []
            t0 = time.monotonic()
            proc = _child(pre + [command, "-i", inp, "-o", out, "--device",
                                 "cuda", "--stats-json", out + ".json",
                                 *flags], timeout=600)
            child_s = time.monotonic() - t0
            check(proc.returncode == 0 and "gate timed out" not in
                  proc.stderr, f"profile turns {name} {kind}: exit "
                  f"{proc.returncode}: {proc.stderr[-2000:]}")
            check(records(out) == records(ref["out"]),
                  f"profile turns {name} {kind}: records differ")
            if kind == "profile":
                with open(out + ".report.json") as f:
                    applied = json.load(f)["profile"]["knobs_applied"]
                check("feeder_depth" in applied,
                      f"profile turns {name}: feeder_depth not applied "
                      f"({applied})")
            with open(out + ".json") as f:
                walls[kind].append({"wall_s": json.load(f)["wall_s"],
                                    "child_s": child_s})
            os.unlink(out)
        turns[name] = walls
    return turns


def tune_refs(paths, e2e, duplexes) -> dict:
    """The cuda runs the tune phase's profile runs are held to: name ->
    (command, input, flags, its summary)."""
    return {"longtail_200k_fast": ("simplex", paths["longtail_200k"], [],
                                   e2e["longtail_200k"]["fast"]),
            "duplex_240k": ("duplex", paths["duplex_240k"], [],
                            duplexes["duplex_240k"]["cuda"])}


def tune_phase(work, tune, refs, report_path, dev, turns=False) -> tuple:
    """The tuner on the card: K8 against its plain version at both of the
    sweep's shapes (and an odd one for the 16-byte path's tail) and timed;
    the ``tune --quick`` child's end (:func:`_tune_outputs`); ``tune
    --replay`` of ``report_path`` (:func:`_tune_replay`); the ``refs`` runs
    under the tuned profile (:func:`_profile_runs`), and with ``turns``
    also each without and with it in turns (:func:`_profile_turns`).
    Prints the ``tune`` line; returns (its summary, K8's ``kernels``
    entry)."""
    t0 = time.monotonic()
    k8 = {shape: check_tune_combine_kernel(dev, shape, timed=True)
          for shape in TUNE_SHAPES}
    check_tune_combine_kernel(dev, TUNE_TAIL_SHAPE, timed=False)
    out = _tune_outputs(tune)
    out["replay"] = _tune_replay(work, report_path)
    from fgumi_tpu_torch.tune.profile import load_profile

    prof = load_profile(tune["profile"])
    out["feeder_depth"] = prof["knobs"].get("feeder_depth")
    out["profile_runs"] = _profile_runs(tune["profile"], prof, refs, work)
    if turns:
        path, knobs, which = _turns_profile(prof, tune["profile"], work)
        out["turns_profile"] = {"knobs": knobs, "which": which}
        out["profile_turns"] = _profile_turns(path, refs, work)
    out["phase_s"] = time.monotonic() - t0
    print("tune " + json.dumps(out), flush=True)
    quick, full = (k8[s] for s in TUNE_SHAPES)
    entry = kernel_entry(
        "tune_combine", quick, out["k8_launches"], REPLACES_TUNE_COMBINE,
        "tune_quick", TUNE_SOURCE, shape=quick["shape"],
        full_shape=full["shape"], full_ms=full["ms"],
        full_plain_ms=full["plain_ms"], full_bound_ms=full["bound_ms"])
    return out, entry


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def _timed_build(build):
    t0 = time.monotonic()
    build(force=True)
    return time.monotonic() - t0


def ptxas_registers(kernel: str):
    """Registers a thread of ``kernel`` uses, from the last build's
    ``-Xptxas -v`` report (None when the build log does not say)."""
    from fgumi_tpu_torch.ops import cuda_kernel

    current = None
    for line in cuda_kernel.BUILD_LOG.splitlines():
        if "Compiling entry function" in line:
            current = line
        elif current and kernel in current and "registers" in line:
            return int(line.split("Used")[1].split("registers")[0])
    return None


def kernel_entry(name, res, launches, replaces, path,
                 source=KERNEL_SOURCE, staged=None, **extra):
    """One entry of the ``kernels`` line: ``launches`` is the count of the
    run ``path``, whose shape ``res`` was checked and timed at; ``staged``
    (a staged run's summary) adds that run's name and its launches of the
    kernel; ``extra`` keys are added as they are."""
    if staged is not None:
        extra.update(staged_path=staged["case"],
                     staged_launches=staged["launches"][name])
    return {**extra, "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "path": path, "launches": launches,
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"],
            "library_ms": res.get("library_ms"),
            "registers": res.get("registers"),
            "geometry": res.get("geometry")}


def _mapped_inputs(work) -> tuple:
    """The mapped phase's inputs: ({name: (worker body, argument)},
    {name: paths})."""
    inputs = {"correct_1M": (_simulate_correct, CORRECT_SIM),
              "mapped_chain_400k": (_simulate_mapped_fastq, MAPPED_SIM)}
    paths = {"correct_1M": tuple(os.path.join(work, f"correct_1M.{x}")
                                 for x in ("bam", "list.txt", "truth.tsv")),
             "mapped_chain_400k": tuple(
                 os.path.join(work, f"mapped_chain_400k.{x}")
                 for x in ("r1.fq.gz", "r2.fq.gz", "list.txt"))}
    return inputs, paths


def _build_all(torch, native, cuda_kernel):
    with cf.ThreadPoolExecutor(max_workers=2) as builders:
        t_cuda = builders.submit(_timed_build, cuda_kernel.build)
        t_native = builders.submit(_timed_build, native.build)
        print(f"built {', '.join(cuda_kernel.SOURCES)} (one nvcc each) "
              f"in {t_cuda.result():.1f}s and the native host library "
              f"in {t_native.result():.1f}s (in parallel)", flush=True)
    for line in cuda_kernel.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("ptxas: " + line.strip(), flush=True)
    return torch.device("cuda", 0)


def earlier_kernel_entries(dev, e2e, groups, pipes, duplexes, codecs,
                           staged, dedup) -> list:
    """The ``kernels`` line's entries of the phases before ``mapped``: each
    kernel checked and timed at the shapes its runs reported."""
    shapes = {case: {kind: s["largest_batch"] for kind, s in runs.items()}
              for case, runs in e2e.items()}
    p400, pk4 = pipes["pipeline_400k"], pipes["pipeline_k4_50k"]
    main_k = kernel_phase_main_path(dev, shapes, {
        "k4_pipeline": pk4["fused_cuda"]["k4_largest_launch"],
        "k4_paired": groups["amplicon_paired_paired_fast"]["largest_launch"],
        "k4_dense_max": (8191, 8191, 8),
        "k4": groups["amplicon_group_adjacency_fast"]["largest_launch"],
        "k4_dedup": dedup["largest_launch"]}, {
        "k1_pipeline": ("full", p400["fused_cuda"]["simplex_largest_batch"]),
        "k1_pipeline_staged": (
            "full", p400["staged_cuda"]["simplex_largest_batch"]),
        "k1f_pipeline": (
            "filter", p400["device_filter_cuda"]["simplex_largest_batch"]),
        "k1_pipeline_k4": (
            "full", pk4["fused_cuda"]["simplex_largest_batch"]),
        "k1r_duplex": (
            "resident", duplexes["duplex_240k"]["cuda"]["largest_batch"]),
        "k1_codec": (
            "full", codecs["codec_320k"]["cuda"]["largest_batch"])})
    mq = e2e["many_quals_20k"]["fast"]
    N, L, J = mq["largest_batch"]
    codes, _, starts, _ = main_path_batch(mq["largest_batch"], False, seed=N)
    k1p2 = check_packed2_kernel(
        f"main_k1p2_many_quals_{J}seg_{N}rows_x{L}", codes,
        packed2_quals(codes, N), starts, dev, timed=True)
    # K1-p2 at a real sample's batch: fixed5_1M's largest, packed2 quals
    N, L, J = shapes["fixed5_1M"]["fast"]
    codes, _, starts, _ = main_path_batch((N, L, J), False, seed=N)
    k1p2_fixed5 = check_packed2_kernel(
        f"main_k1p2_fixed5_p2_{J}seg_{N}rows_x{L}", codes,
        packed2_quals(codes, N), starts, dev, timed=True)
    d240, c320 = duplexes["duplex_240k"]["cuda"], codecs["codec_320k"]["cuda"]
    k5 = check_duplex_combine(
        f"main_k5_duplex_{d240['combine_device_largest']}rows",
        main_k["k1r_duplex"], main_k["k1r_duplex"]["codes"],
        d240["combine_device_largest"], dev, 100)
    k6 = check_codec_combine(
        f"main_k6_codec_{c320['combine_largest']}pos", c320["combine_largest"],
        dev)

    # one entry a kernel and path: each launch count is that of the run
    # whose largest batch (or launch) the entry was checked and timed at
    return [
        kernel_entry("consensus_wire_full", main_k["k1_fixed"],
                     e2e["fixed5_1M"]["fast"]["launches"][
                         "consensus_wire_full"], REPLACES_FULL,
                     "fixed5_1M_fast", staged=staged["fixed5_1M_fast_t4"]),
        kernel_entry("consensus_wire_filter", main_k["k1f_fixed"],
                     e2e["fixed5_1M"]["fused"]["launches"][
                         "consensus_wire_filter"], REPLACES_FILTER,
                     "fixed5_1M_fused", staged=staged["fixed5_1M_fused_t4"]),
        kernel_entry("umi_hamming", main_k["k4"],
                     groups["amplicon_group_adjacency_fast"]["launches"][
                         "umi_hamming"], REPLACES_HAMMING,
                     "amplicon_group_adjacency_fast", HAMMING_SOURCE,
                     staged=staged["amplicon_group_adjacency_fast_t4"]),
        kernel_entry("consensus_wire_full", main_k["k1_pipeline"],
                     p400["fused_cuda"]["launches"]["consensus_wire_full"],
                     REPLACES_FULL, "pipeline_400k_fused",
                     staged=staged["pipeline_400k_fused_t4"]),
        kernel_entry("consensus_wire_filter", main_k["k1f_pipeline"],
                     p400["device_filter_cuda"]["launches"][
                         "consensus_wire_filter"], REPLACES_FILTER,
                     "pipeline_400k_device_filter"),
        kernel_entry("umi_hamming", main_k["k4_pipeline"],
                     pk4["fused_cuda"]["launches"]["umi_hamming"],
                     REPLACES_HAMMING, "pipeline_k4_50k_fused",
                     HAMMING_SOURCE),
        kernel_entry("umi_hamming", main_k["k4_dedup"],
                     dedup["launches"]["umi_hamming"], REPLACES_HAMMING,
                     "amplicon_dedup_adjacency_fast", HAMMING_SOURCE),
        kernel_entry("consensus_wire_resident", main_k["k1r_duplex"],
                     d240["launches"]["consensus_wire_resident"],
                     REPLACES_RESIDENT, "duplex_240k",
                     staged=staged["duplex_240k_t4"],
                     uniform_ms=main_k["k1r_duplex_uniform"]["ms"]),
        kernel_entry("duplex_combine", k5, d240["launches"]["duplex_combine"],
                     REPLACES_DUPLEX_COMBINE, "duplex_240k", COMBINE_SOURCE,
                     staged=staged["duplex_240k_t4"]),
        kernel_entry("consensus_wire_full", main_k["k1_codec"],
                     c320["launches"]["consensus_wire_full"], REPLACES_FULL,
                     "codec_320k", staged=staged["codec_320k_t3"]),
        kernel_entry("codec_combine", k6, c320["launches"]["codec_combine"],
                     REPLACES_CODEC_COMBINE, "codec_320k", COMBINE_SOURCE,
                     staged=staged["codec_320k_t3"]),
        kernel_entry("consensus_wire_packed2", k1p2,
                     mq["launches"]["consensus_wire_packed2"],
                     REPLACES_PACKED2, "many_quals_20k",
                     staged=staged["many_quals_20k_t4"],
                     fixed5_p2_ms=k1p2_fixed5["ms"],
                     fixed5_p2_plain_ms=k1p2_fixed5["plain_ms"],
                     fixed5_p2_bound_ms=k1p2_fixed5["bound_ms"]),
        ]


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU", 2)
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from fgumi_tpu_torch import native
        from fgumi_tpu_torch.ops import cuda_kernel
    except ImportError as e:
        fail(f"the fgumi_tpu_torch package is missing: {e}", 2)
    if sys.argv[1:] not in ([], ["--phase", "mapped"], ["--phase", "qc"],
                            ["--phase", "serve"], ["--phase", "fleet"],
                            ["--phase", "route"], ["--phase", "tune"]):
        fail(f"unknown arguments {sys.argv[1:]} (none, or --phase mapped, "
             "qc, serve, fleet, route or tune)", 2)
    # --phase mapped: the mapped phase alone, with fixed5_1M (whose
    # --device-filter run device_filter_env compares with); --phase qc: the
    # mapped chain and amplicon_paired's fast paired group, then the qc
    # phase; --phase serve: the serve phase and its two inputs; --phase
    # fleet: the fleet phase and its three inputs, each run standalone first
    every_phase = not sys.argv[1:]
    phase = sys.argv[2] if not every_phase else None
    t_start = time.monotonic()
    smi = nvidia_smi_line()
    print(smi, flush=True)
    print(libdeflate_probe(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # the inputs in the order the phases need them: the pool runs a few at
    # a time, so each phase's inputs are built before the later ones'
    if every_phase:
        inputs = {
            **{k: (_amplicon, kw) for k, kw in AMPLICONS.items()},
            **{k: (_simulate_fastq, n) for k, n in FASTQ.items()},
            "fixed5_1M": (_simulate, INPUTS["fixed5_1M"]),
            **{k: (_simulate_duplex, kw) for k, kw in DUPLEX.items()},
            **{k: (_simulate_codec, kw) for k, kw in CODEC.items()},
            "meth_ref": (_meth_reference, METH_REF),
            **{k: (_methylation, kw) for k, kw in METHYLATION.items()},
            **{k: (_simulate, kw) for k, kw in INPUTS.items()},
            **_mapped_inputs("")[0]}
    elif phase == "serve":
        inputs = {"longtail_200k": (_simulate, INPUTS["longtail_200k"]),
                  "pipeline_k4_50k": (_simulate_fastq,
                                      FASTQ["pipeline_k4_50k"])}
    elif phase == "fleet":
        inputs = {"longtail_200k": (_simulate, INPUTS["longtail_200k"]),
                  "duplex_240k": (_simulate_duplex, DUPLEX["duplex_240k"]),
                  "pipeline_k4_50k": (_simulate_fastq,
                                      FASTQ["pipeline_k4_50k"])}
    elif phase == "qc":
        inputs = {"amplicon_paired": (_amplicon, AMPLICONS["amplicon_paired"]),
                  **_mapped_inputs("")[0]}
    elif phase == "route":
        inputs = {k: (_simulate_duplex, DUPLEX[k]) if k in DUPLEX
                  else (_simulate, INPUTS[k]) for k in ROUTE_INPUTS}
    elif phase == "tune":
        inputs = {"longtail_200k": (_simulate, INPUTS["longtail_200k"]),
                  "duplex_240k": (_simulate_duplex, DUPLEX["duplex_240k"])}
    else:
        inputs = {"fixed5_1M": (_simulate, INPUTS["fixed5_1M"]),
                  **_mapped_inputs("")[0]}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work, \
            cf.ProcessPoolExecutor(
                max_workers=min(len(inputs), SIM_WORKERS),
                mp_context=multiprocessing.get_context("spawn")) as pool:
        paths = {k: os.path.join(work, f"{k}.bam") for k in inputs}
        paths.update({k: (os.path.join(work, f"{k}.r1.fq.gz"),
                          os.path.join(work, f"{k}.r2.fq.gz"))
                      for k in FASTQ})
        paths["meth_ref"] = os.path.join(work, "meth_ref.fa")
        paths.update(_mapped_inputs(work)[1])
        sims = {k: pool.submit(fn, paths[k], kw)
                for k, (fn, kw) in inputs.items()}
        dev = _build_all(torch, native, cuda_kernel)
        # the tuner's child beside the kernel checks at the test shapes and
        # the inputs' simulation (its checks are the tune phase's)
        tune = start_tune(work) if every_phase else None

        if every_phase:
            hamming_phase_test_shapes(dev)
            combine_phase_test_shapes(dev)
            kernel_phase_test_shapes(dev)
            packed2_phase_test_shapes(dev)
        print(f"test shapes done at {time.monotonic() - t_start:.1f}s",
              flush=True)
        built = set()

        def ready(*names):
            """Wait for the inputs ``names`` only: a phase starts as soon
            as its own inputs are built (the 1,000,000-read correct_1M
            simulation goes on beside the earlier phases)."""
            for k in names:
                if k not in built:
                    n, dt = sims[k].result()
                    built.add(k)
                    print(f"built input {k}: {n} records in {dt:.1f}s",
                          flush=True)
            print(f"inputs {', '.join(names)} ready at "
                  f"{time.monotonic() - t_start:.1f}s", flush=True)

        mapped_inputs = tuple(_mapped_inputs("")[0])
        if every_phase:
            # the phases in the order their inputs are built (fixed5_1M, the
            # longest simulation but correct_1M's, before the simplex cases)
            ready(*AMPLICONS)
            groups, classics = group_phase(paths, work)
            ready(*FASTQ)
            pipes = pipeline_phase(paths, work)
            filter_phase(pipes["pipeline_400k"], work)
            sort_phase(paths, work)
            ready(*DUPLEX)
            duplexes = duplex_phase(paths, work)
            ready(*CODEC)
            codecs = codec_phase(paths, work)
            ready(*METHYLATION, "meth_ref")
            methylation_phase(paths, work)
            ready(*INPUTS)
            e2e = e2e_phase(paths, work)
            rejects_phase(paths, work)
            staged = staged_phase(paths, work, staged_serial_runs(
                e2e, groups, pipes, duplexes, codecs))
            io_phase(e2e["fixed5_1M"]["fast"]["out"])
            observe_phase(paths, work, pipes, staged, staged_serial_runs(
                e2e, groups, pipes, duplexes, codecs))
            dedup, compares = dedup_phase(
                paths, work, groups["amplicon_group_adjacency_fast"])
            resilience_phase(paths, work, e2e, duplexes)
            dedup_compare_finish(compares)
            k7, pipeline_run = serve_phase(paths, work, dev)
            argvs = fleet_argvs(paths, work, pipeline_run[0])
            walls = {"simplex": e2e["longtail_200k"]["fast"]["wall_s"],
                     "fused": e2e["longtail_200k"]["fused"]["wall_s"],
                     "duplex": duplexes["duplex_240k"]["cuda"]["wall_s"],
                     "pipeline": None}
            fleet = fleet_phase(work, {
                name: (argv, pipeline_run[1] if name == "pipeline" else
                       _digest(argv[argv.index("-o") + 1]), walls[name])
                for name, argv in argvs.items()})
            # beside the route and tune phases, in the inputs' pool (idle
            # since the inputs were built): the classic group runs on cpu
            # and correct_1M, host-only runs
            ready(*mapped_inputs)
            classic_cpu = group_classic_cpu(pool, classics)
            correct = pool.submit(correct_1m_case, paths, work)
            route = route_phase(paths, work, route_clean_runs(
                paths, work, e2e, duplexes))
            _, k8 = tune_phase(work, tune, tune_refs(paths, e2e, duplexes),
                               route["R4"]["report_path"], dev)
            group_classic_cpu_finish(classic_cpu)
            fused = e2e["fixed5_1M"]["fused"]
            paired = groups["amplicon_paired_paired_fast"]
        elif phase == "mapped":
            ready("fixed5_1M")
            fused = e2e_case("fixed5_1M_fused", paths["fixed5_1M"], work,
                             ["--min-reads", "1", "--device-filter",
                              *FILTER_OPTS], True)
        elif phase == "serve":
            ready(*SERVE_INPUTS)
            k7, _ = serve_phase(paths, work, dev)
        elif phase == "fleet":
            ready(*FLEET_INPUTS)
            fleet = fleet_phase(work, fleet_runs_alone(paths, work))
        elif phase == "route":
            # the cuda runs the route cases are held to, then the phase
            ready(*ROUTE_INPUTS)
            e2e = {"longtail_200k": {
                "fast": e2e_case("longtail_200k_fast",
                                 paths["longtail_200k"], work, [], False),
                "fused": e2e_case("longtail_200k_fused",
                                  paths["longtail_200k"], work,
                                  ["--min-reads", "1", "--device-filter",
                                   *FILTER_OPTS], True)},
                "many_quals_20k": {"fast": e2e_case(
                    "many_quals_20k", paths["many_quals_20k"], work, [],
                    False, packed2_route=True)},
                "fixed5_1M": {"fast": e2e_case(
                    "fixed5_1M_fast", paths["fixed5_1M"], work, [],
                    False)}}
            duplexes = {"duplex_240k": {"cuda": duplex_run(
                "duplex_240k", paths["duplex_240k"], work, "cuda", [])}}
            route = route_phase(paths, work, route_clean_runs(
                paths, work, e2e, duplexes))
        elif phase == "tune":
            # the tuner alone on the card, then the cuda runs it is held
            # to (the simplex run's report is the replay's evidence)
            ready(*TUNE_INPUTS)
            tune = start_tune(work)
            tune["thread"].join(660)
            src = route_run("tune_source", "simplex", paths["longtail_200k"],
                            [], work, {})
            e2e = {"longtail_200k": {"fast": src}}
            duplexes = {"duplex_240k": {"cuda": duplex_run(
                "duplex_240k", paths["duplex_240k"], work, "cuda", [])}}
            _, k8 = tune_phase(work, tune, tune_refs(paths, e2e, duplexes),
                               src["out"] + ".report.json", dev, turns=True)
        if phase == "qc":
            ready(*sims)
            mapped = {"mapped_chain_400k": mapped_chain_case(paths, work)}
            paired = group_case("amplicon_paired", "paired",
                                paths["amplicon_paired"], work, "fast")
            group_cpu_check(paired, run_group(*paired["cpu_args"]))
        elif phase not in ("serve", "fleet", "route", "tune"):
            ready(*mapped_inputs)
            mapped = mapped_phase(paths, work, fused,
                                  correct if every_phase else None)
        if phase in (None, "qc"):
            # host commands alone, in the inputs' pool, beside the kernel
            # checks at the main path's shapes below
            qc = pool.submit(
                qc_phase, os.path.join(work, "mapped.zipped.bam"),
                os.path.join(work, "mapped.grouped.bam"), paired["out"],
                work)

        if every_phase:
            entries = earlier_kernel_entries(dev, e2e, groups, pipes,
                                             duplexes, codecs, staged, dedup)
        elif phase in ("serve", "fleet", "route", "tune"):
            entries = []
        elif phase == "qc":
            k4 = kernel_phase_main_path(
                dev, {}, {"k4_paired": paired["largest_launch"]}, {})
            entries = [kernel_entry(
                "umi_hamming", k4["k4_paired"],
                paired["launches"]["umi_hamming"], REPLACES_HAMMING,
                "amplicon_paired_paired_fast", HAMMING_SOURCE)]
        else:
            k1f = kernel_phase_main_path(
                dev, {"fixed5_1M": {"fused": fused["largest_batch"]}}, {}, {})
            entries = [kernel_entry(
                "consensus_wire_filter", k1f["k1f_fixed"],
                fused["launches"]["consensus_wire_filter"], REPLACES_FILTER,
                "fixed5_1M_fused")]
        if phase not in ("serve", "fleet", "route", "tune"):
            chain = mapped["mapped_chain_400k"]
            entries.append(kernel_entry(
                "consensus_wire_full", check_k1_mapped(chain, dev),
                chain["launches"]["consensus_wire_full"], REPLACES_FULL,
                "mapped_chain_400k"))
        if phase in (None, "serve"):
            entries.append(k7)
        if phase in (None, "tune"):
            entries.append(k8)
        if phase is None:
            # the fleet phase's launches beside each kernel's main-path
            # count: the whales' shards (each its own --stats-json) and
            # daemon a's K7; and the route phase's audited (R1) launches
            for e in entries:
                if e["name"] in fleet["launches"]:
                    e["fleet_launches"] = fleet["launches"][e["name"]]
                for case, r1 in route["R1"].items():
                    if r1["kernel"] == e["name"]:
                        e.setdefault("audited_launches", {})[case] = \
                            r1["launches"]
        if phase in (None, "qc"):
            qc.result()

    print(f"total {time.monotonic() - t_start:.1f}s", flush=True)
    print(json.dumps({"kernels": entries}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
