#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py      # needs one CUDA card
    python3 chip_smoke.py --slice-root DIR   # only the slice and fleet
                                             # phases, with the package
                                             # of checkout DIR
    python3 chip_smoke.py --ladder OUT       # only exp5's whole ladder
                                             # (180 CLI calls), pickles
                                             # to OUT
    python3 chip_smoke.py --stream           # only the stream phase
    python3 chip_smoke.py --serve            # only the serve phase
    python3 chip_smoke.py --fleet            # only the fleet phase
    python3 chip_smoke.py --capture          # only the capture phase and
                                             # the native schemes' check
    python3 chip_smoke.py --adapt            # only the adapt phase
    python3 chip_smoke.py --mesh             # only the mesh phase

Phases, each of which raises on failure (non-zero exit):

1. build the CUDA kernels from ``traceweaver_tpu_torch/ops/csrc`` with
   nvcc (one process per source, all at once), and beside them the C++
   Jaeger loader from ``traceweaver_tpu_torch/native/src`` with g++;
   print ptxas's register and spill report;
2. slice: config ``synth-async-8k`` (8192 requests, three chained
   endpoints) through ``WeaverTorch.FindAssignments`` on the card, once
   with the fused kernel and once with the plain Sinkhorn kernel, each
   with every launch counter reset just before and read just after (the
   assembly kernel must launch too, and the assembly's plain version
   must not run on the card); accuracy must reach
   ``ACCURACY_FLOOR``; a 256-request cut must give the same assignments
   on the card as on the CPU; then the fused run again with the
   assembly's plain version on the card, for its peak memory and wall
   beside the kernel's;
3. fleet: on a 256-request cut of config ``synth-fleet-8svc`` (eight
   services), ``solve_fleet`` on the card must agree with
   ``solve_fleet`` on the CPU and with per-service ``FindAssignments``
   on the card on >= 0.99 of every service's (endpoint, span) pairs;
   then the full config (8 x 8192 requests) through ``solve_fleet`` on
   the card, with each kernel, once pipelined (the default) and once
   with ``pipeline=False`` (the serial reference), each run with every
   launch counter reset just before and read just after, each with
   ``confidences=``: the two flows must give the same assignment on
   every pair of every service and the same confidence records, every
   service's accuracy must reach the JAX package's less one point
   (``FLEET_JAX_ACCURACY``), every incoming span must get one record,
   and no ``fault_*`` counter may move (a run that needed the
   supervisor fails). Then two pipelined rounds with the fused kernel
   and one ``PlanCache``: round 2 must hit the cache for all eight
   services, run no two-pass EM (``fused_em_applied`` 0), keep every
   accuracy floor and agree with round 1 on >= 0.99 of the pairs of
   every service but ``cache`` (reported only: its assignments hang on
   near ties); then the pipelined K1 run with the assembly's plain
   version, for its peak memory;
3b. precision: ``synth-async-8k`` at ``precision="bf16"`` with each
   kernel and ``synth-fleet-8svc`` at bf16 (K1, pipelined), every
   launch counter reset and read around each run, held to the JAX
   package's readings at ``TW_PRECISION=bf16`` (``BF16_JAX_ACCURACY``,
   ``FLEET_BF16_JAX_ACCURACY``), and ``synth-async-8k`` with
   ``score_gemm`` against ``TW_SCORE_GEMM=1`` (``GEMM_JAX_ACCURACY``),
   under :func:`check_accuracy`'s two-sided rule, but the bf16 fleet's
   ``cache`` service within ``CACHE_BF16_MAX_PT`` of JAX either way and,
   solved alone, K1 equal to the plain version on >= 99% of the rows of
   the windows that meet their marginals (``cache-check``); peak memory
   beside the f32 runs';
4. observability: one ``solve_fleet`` of the full ``synth-fleet-8svc``
   under ``torch.profiler`` (every thread, profiling enabled): the
   device's idle share over the call, its ten longest operations and
   ten longest idle gaps with the ``tw:*`` range the host was in, and
   ``tw:fleet:dispatch`` in the trace; one ``solve_fleet`` of a
   256-request cut with a ``FaultPlan`` that fails the first dispatch
   and an event sink installed: the supervisor retries, the metrics
   registry's ledger deltas equal the stats dict and the sink holds the
   ``fault_injected`` and ladder records;
5. executor: config ``alibaba-exp5-15000``: the port's synthesizer
   writes exp5's corpus (15 call graphs x 1000 traces, seed 10, replica
   table; it, ``alibaba-cg-8k``'s, the messy ladder's and the stream's
   are synthesized one after another in a process of their own beside
   the first card phases, ``CorpusJobs``) and the port's CLI ``main(argv)`` runs in this process once per
   graph with exp5's arguments (fix 5, compress 15000, predictors
   3,4,7,10, ``--execute_parallel 0``). Every CLI call must ingest with
   the C++ loader and launch K1; every line counts the call's windows
   and ill-posed windows (see the kernels phase). ``load_corpus`` with
   the C++ loader and with Python's ``json`` must give equal stores on
   graph 0 and on ``alibaba-cg-8k``. WAP5, FCFS and vPath must equal
   the JAX package's end-to-end accuracy on the CPU
   (``EXP5_JAX_ACCURACY``) and all five result-pickle families must
   exist for every graph. The flagship of every graph also runs on the
   CPU (``--device cpu``), in five worker processes started as this
   phase ends, beside the card phases that follow (the smoke's time
   leaves no room to run them after the card phases); the check is
   two-sided: a graph whose card run met no
   ill-posed window must read JAX's number within half a point either
   way with >= 99% of every service's pairs equal to the CPU run's, and
   a graph that met some must read JAX's number exactly on the CPU, and
   on the card within 7 points either way with >= 90% of every
   service's pairs equal to the CPU run's (``executor-card-vs-cpu``
   lines). The same 15 graphs then run the
   flagship with ground-truth-free DAG discovery (``--gt_free_dag 1``;
   in a spawned process of its own on the card, ``ExecutorSideJobs``,
   beside the ground-truth loop and the calls after it, and joined
   before ``alibaba-cg-8k``'s profiled call):
   the discovered edges, whether they equal the ground-truth DAG's and
   the JAX package's (``EXP5_GTFREE_JAX``), the flagship beside the
   ground-truth-DAG one, under the same two-sided rule against JAX's
   ground-truth-free reading, and within one point of the
   ground-truth-DAG flagship where no window was ill-posed (a graph
   whose card found other DAGs gets a ground-truth-free CPU run; one
   that found the ground-truth DAGs and assigned as the ground-truth run
   did is held to that run's CPU rerun). Then graph 0 with exp4's
   predictors 2,8,9,10 at compress 1, with ``--execute_parallel`` 0 and
   1: equal results, slot 2 equal to the JAX number and slots 8-10
   within half a point of it (``EXP4_JAX_ACCURACY``). Then one call
   with ``--events`` and ``--metrics_port 0``: ``GET /metrics`` on
   loopback must serve the fleet ledger and the fault ladder, and ``cli
   events`` must print the sink's records; ``cli query`` over graph 0's
   ``e2e_*`` pickle. Then config ``alibaba-cg-8k`` (call graph 0 of seed
   10 at 8192 traces, predictor 10) against ``CG8K_JAX_ACCURACY``, then
   ground-truth-free against ``CG8K_GTFREE_JAX_ACCURACY``, then that
   call again under the profiler, whose trace must hold
   ``tw:solve:dispatch`` and ``tw:fleet:dispatch``; ``alibaba-cg-8k``
   at ``--precision bf16`` against ``CG8K_BF16_JAX_ACCURACY`` and at f32
   with the assembly's plain version (peak memory); every call must
   launch the assembly kernel and run no plain assembly on the card
   (the GEMM form aside). Outside the exp5
   loops a method on the card reads JAX within half a point either way,
   or one point where its call met ill-posed windows. Then ``cli
   scorecard --traces 32`` on the card: its table and calibration
   verdict, K1 launched, the host baselines equal to the JAX package's
   table (``SCORECARD_JAX``) and the solver within one span per regime;
5b. ladder: the runner ``traceweaver_tpu_torch.runtime.ladder`` over
   exp5's compress 1000 and 10000 (``LADDER_RUNGS``; the top rung, 15000,
   is the executor phase's loop) on graphs ``LADDER_GRAPHS`` (0, 4, 5
   and 9, the graphs whose top rung met ill-posed windows, and the clean
   graph 3), then the messy corpus (``--messy``) on graph 9 at compress
   1000 and 4000 (``LADDER_HARD_GRAPHS``, ``LADDER_HARD_RUNGS``; 4000
   meets ill-posed windows): host baselines equal to JAX
   (``EXP5_LADDER_JAX``, ``EXP5_LADDER_HARD_JAX``), the flagship within
   half a point where the call met no ill-posed window, else held to a
   CPU rerun under the exp5 loop's ill-posed rule, the CPU run equal to
   JAX's reading, or where the port's CPU run is known to part from
   JAX's in the last bits (``LADDER_PORT_CPU``), equal to that reading;
   the figures are drawn where the machine has matplotlib. In the whole
   smoke the ladder runs on the card in a spawned process of its own
   (``ExecutorSideJobs``) beside the executor phase, which waits for it
   before ``alibaba-cg-8k``'s profiled call (so the executor phase's
   walls and kernel times before that call include the card's
   sharing). ``--ladder OUT`` runs the whole ladder of
   both corpora (15 graphs x 6 rungs each) alone under the same rule;
5c. stream: config ``stream-cg-8k`` (one call graph of seed 10 at 8192
   traces 20 ms apart, replayed with 50 ms of arrival jitter through
   20 s windows with 4 s of overlap and a 2 s watermark) through the
   port's ``cli stream`` in this process on the card, with a sink and a
   checkpoint every 2 windows, every launch counter reset just before the
   call and read just after; then, as a call of its own, the batch
   comparison ``--compare_batch`` prints (``cli.batch_accuracy``, the
   flagship on the stream's store). Spans emitted plus late-dropped
   must equal the events consumed, no window may be dead-lettered, K1
   and the assembly kernel must launch and the assembly's plain version
   must not run on the card; the window, late and shed counts must equal
   the JAX package's (``STREAM_JAX``) and the streamed accuracy read
   JAX's within half a point where no window was ill-posed, else the
   port's CPU stream (started in a process of its own before the first
   card phase, checked with the CPU reruns) must equal its recorded reading
   exactly (``STREAM_PORT_CPU``: it parts from JAX's in the last bits)
   and the card read JAX within 7 points with >= 90% of every service's
   pairs equal to the CPU run's. Then a second run stopped after half the
   windows (under the profiler: the ``profile`` line) is resumed from its
   checkpoint in a fresh service, and its sink must equal the first
   run's byte for byte (``stream-resume``);
5d. serve: config ``serve-cg-4t`` (four call graphs of seed 10 at 8192
   traces 20 ms apart, tenant ``t<i>`` posting graph ``i`` in bodies of
   256 traces in root start-time order; ``serve_bodies``) through the
   port's serve tier on the card with the serve CLI's defaults
   (continuous admission, two tickets in flight, the WAL with ``batch``
   sync, device-resident columns, f32) and the stream's geometry.
   1. the shared run: ``make_server`` on a thread, one client thread a
   tenant posting as fast as acks return (429s waited out), then
   ``POST /api/v1/flush`` and a wait for an empty backlog, every launch
   counter reset just before and read just after (the ``serve`` line:
   per tenant the POSTs, spans ingested, windows sealed, emitted,
   dead-lettered and shed, the seal-to-emit p99 and the sink's accuracy
   (``serve_sink_accuracy``) beside JAX's (``SERVE_JAX``); the shared
   solves, tenant batches, fleet dispatches, tickets and overlap; the
   ring, index and shipped bytes, host fallbacks, the rows appended to
   the column rings and their fill; wall, spans a second, launches,
   ill-posed windows and peak memory; ``serve-batches``: each fleet
   call's tenants and windows). 2. over the same server the trace list
   and one trace, both live queries, ``/metrics`` (the tenancy, devcols
   and WAL families, per-tenant and dispatch counters equal to
   ``/api/v1/stats``) and ``/readyz`` (200, then 503 after
   ``begin_drain``; ``serve-queries``). 3. tenant ``t0`` alone under the
   fixed pump (eight windows a pump), with device-resident columns and
   without, fresh rings each: the sinks must be byte-identical, and the
   sink must read JAX's within 7 points; then ``t0`` alone under a pump
   of one window (the run the CPU rerun repeats); then
   ``t0`` alone with the shared run's batches (its ticket submits and
   completes replayed in order): its rows must equal the shared run's on
   >= 99% of every service's rows outside ill-posed solver windows (the
   pump run's agreement with the shared run is reported beside JAX's
   own: the batches differ; ``serve-alone``). 4. beside step 3, ``cli
   serve --no-continuous`` in a subprocess: half of ``t0``'s bodies, SIGKILL
   after their acks, ``--resume``, the rest, a flush, SIGTERM (exit 0):
   the sink must equal the pump run's byte for byte (the WAL replay;
   ``serve-resume``). It fails on broken conservation (emitted +
   dead-lettered = sealed windows, spans emitted + late-dropped =
   ingested), any dead-lettered or shed window, no solve carrying two
   tenants' windows, a host fallback or no index bytes, more ring rows
   than spans ingested, K1 or the assembly kernel not launched or the
   assembly's plain version on the card, and accuracy: each tenant
   within half a point of JAX's shared reading where none of its
   windows was ill-posed, else within 7 points, with the port's CPU run
   of ``t0`` alone under a pump of one window (started in a process of
   its own before the first card phase) equal to JAX's reading and the card's
   same run within 7 points of it with >= 90% of every service's rows
   equal to the CPU run's. The CPU rerun is not the pump of eight: on the
   CPU it takes 1438 s on two threads, past the smoke's time, and its
   eight cold windows break exact-mass ties (ROADMAP C.3) that flip whole
   windows between any two roundings (``PERF.md`` section 6). The corpus is
   synthesized in a process of its own beside the first card phases;
5e. fleet: config ``fleet-cg-4t-2r``: ``serve-cg-4t``'s corpus and
   settings through the replica fleet tier, a ``FleetManager`` with its
   crash supervisor over two ``cli serve`` replica processes on the card
   (``ReplicaProcess``), every POST through the router over HTTP on
   loopback with its body index as ``X-TW-Seq``. 1. the shared run: each
   tenant's first body, then live migrations until each replica holds two
   tenants; four clients post the rest as fast as acks return (429s and
   503s waited out), ``t0`` live-migrated to the other replica after
   ``FLEET_MIGRATE_AT`` of its bodies, the replica holding ``t1`` SIGKILLed
   as ``t1`` posts body ``FLEET_KILL_AT`` and respawned by the supervisor
   (``--resume``, the WAL replayed); after the last POST a wait for every
   queue to drain, a rolling restart of both replicas, a flush, a wait
   for every trace to emit, a SIGTERM drain (the ``fleet`` line: per
   tenant the POSTs, traces ingested and emitted, the sink's traces and
   repeats, accuracy against ``SERVE_JAX``; per replica its K1, K2 and
   assembly launches, each process's ``kernels`` block banked before it
   stops; the router's counters, the respawn and failover seconds, wall
   and spans a second). The fleets run at the router's default
   ``migrate_timeout_s``: a POST held longer by a respawn is answered 503
   and waited out. Then ``t0`` alone in this process with the shared
   run's batches, read back from the replicas' event sinks
   (``fleet-replay``): the shared run's rows must equal the replay's on
   at least 0.99 of each service's rows outside ill-posed windows, as
   the serve phase holds its shared run. 2. ``t0`` alone under the
   kill/resume leg's settings (``--no-continuous``) on replica A for half
   its bodies, then moved to replica B by a live migration
   (``fleet-migrate``) or by a SIGKILL of A with no respawn budget, the
   survivor failover rebuilding it from A's disk (``fleet-failover``),
   the two fleets side by side: each sink must equal the serve phase's
   unmigrated ``t0`` bytes. 3. ``cli fleet campaign --mode subprocess`` at
   its defaults with its replicas on the card, beside legs 1 and 2, its
   artifact in the smoke's temporary directory (``fleet-campaign``: each
   rung's spans a second, conservation and chaos counters). It fails on a tenant not
   conserved or outside the serve rule (against the serve phase's
   per-tenant ill-posed windows; ``--fleet`` alone serves ``t0`` for its
   bytes and takes ``SERVE_ILL_POSED``), a replica that launched no K1 or
   fewer assembly kernels than K1 (a block built another way), no
   respawn, rows that part from the replay, a sink that parts, a
   replica's drain that exits non-zero and a campaign
   that fails its zero-loss gate or launches no K1 in a steady phase;
5f. capture: config ``capture-8k`` (the capture workload of
   ``traceweaver_tpu_torch.synth.capture``: 8192 frontend -> search
   HTTP/2 traces 10 ms apart, captured by ``strace -f -ttt`` on two hosts
   with their own clocks, one reconnect without close at trace 4096)
   through ``cli stream --source collector:<dir>`` on the card at
   ``stream-cg-8k``'s geometry, clean, under ``skew:1.0:max=1`` and under
   ``capture:0.04`` (fault seed 1; ``capture`` lines), every launch counter
   reset just before each call and read just after: the events, windows,
   loss counters, loss rate, re-keyed streams, confidence discount and
   detected skew (to 1 us) must equal the JAX package's
   (``CAPTURE_JAX``), K1 and the assembly kernel must launch in each leg,
   and the accuracy reads JAX's within half a point where no window was
   ill-posed, else within 7 points with >= 90% of the rows as the port's
   CPU run's (``CAPTURE_PORT_CPU``); then the capture posted as one
   ``{"sources": ...}`` bundle to a serve tenant over HTTP, once flushed
   and drained and once abandoned after the ack and recovered from its
   WAL: the sinks must be equal byte for byte (``capture-serve``). The
   native schemes run on ``alibaba-cg-8k``'s graph 0 in a process of
   their own beside the card phases: FCFS and vPath through
   ``native.run_scheme`` must equal the port's Python baselines on every
   service (``schemes``);
5g. adapt: configs ``adapt-burst-60`` and ``adapt-burst-60x1024`` (the
   shifted burst corpus: 60 bursts of 8 or 1024 requests 0.8 ms apart,
   call delay 150 -> 950 us at burst 30) through ``cli stream --source
   synth:adapt-burst...`` on the card, 1 s windows, no overlap, a 1 ms
   bound, drift window 64, each with ``--adapt`` (``--adapt`` alone runs
   each without it first, the control runs the whole smoke leaves out
   for its time) (``adapt`` lines: per-window accuracy, before the shift and in the last ten
   windows, drift alerts, refits, fallbacks, the final PSI), held to the
   JAX package's readings (``ADAPT_JAX``; at 1024 requests JAX does not
   recover, and neither may the port); the refits' own K1 and assembly
   launches are counted around ``maybe_adapt`` and must be more than 0;
5h. mesh: the multi-device tier and the campaign runner, each run with
   every launch counter reset just before and read just after; in the
   whole smoke on the card in a spawned process of its own beside the
   executor phase (``ExecutorSideJobs``, queued behind the ladder from
   the end of the ground-truth exp5 loop), so its walls include the
   card's sharing.
   ``mesh-fleet-8svc``: ``synth-fleet-8svc`` through ``solve_fleet``
   with no mesh, ``make_mesh(1)`` (the card) and the two-shard mesh
   ``["cuda:0"] * 2``: every item's outputs equal across the three
   (assignments through ``ops/compare.pair_agreement``), each sharded
   dispatch a power of two of rows a shard, ``d2h_bytes_flags`` equal to
   ``compact_windows_total`` with flag fetches, ``mesh_serialized_groups``
   counting every group of a mesh run, no ``devcols_fallbacks`` there, K1 and
   the assembly kernel launched and the assembly's plain version not on
   the card. ``mesh-async-8k``: ``FindAssignments`` on
   ``synth-async-8k`` with the two-shard mesh equals it without one.
   ``em-step-sharded``: ``em_step_sharded`` on the two-shard card mesh,
   on the JAX package's example batch ([256, 3, 64], ``EM_EXAMPLE``), has
   the assignments of the one-shard card mesh and its mixtures within
   ``EM_SHARDED_TOL`` (the share of pairs that part from the CPU run is
   printed over its first ``EM_CPU_WINDOWS`` windows: that batch is full
   of near ties), and on well-posed synthetic windows ([32, 3, 32], no near ties) the assignments of the port's CPU
   run of the same sharding and its mixtures within ``EM_SHARDED_TOL``. ``campaign-r100k``: ``cli
   campaign run`` on the default ladder's first rung (``R100K``: 15
   graphs x 1000 traces, gap 500 ms, seed 10; its corpus built beside
   the first phases, last of ``CorpusJobs``) with ``--devices 1 --slices 2
   --rounds 3 --warmup_max 5``: no kernel built in the steady rounds,
   the multislice slices agree, the end-to-end accuracy within half a
   point of the JAX package's CPU reading (``R100K_JAX``) when no window
   was ill-posed, else within ``ILL_POSED_MAX_PT``; ``campaign compare``
   of the artifact against itself passes and ``campaign report``
   prints. ``multislice-2p``: two spawned processes on the card form a
   gloo process group, each solves its ``partition_problems`` share of
   ``r100k`` and reduces the solved edge statistics through
   ``allreduce_stats_dist`` and the file transport: the transports and
   the ranks agree, and each service's accuracy equals a one-process
   solve of the whole rung (the ranks and that solve run in processes of
   their own, ``MultisliceJob``, beside capture and adapt in the whole
   smoke, and are checked before the kernels phase). The batch CLI with
   ``--mesh_devices 2`` (on this one-card machine) and ``3``, started
   as the phase starts, must each exit non-zero before any data loads;
6. kernels: each kernel against its plain PyTorch version on the card,
   on random blocks (ragged, all-masked, padded rows, skip-heavy, tol 0
   and 1e-3; rows not a multiple of the cluster size, fewer rows than
   CTAs in a cluster, one window, more windows than clusters run at
   once, an early tolerance exit, all-invalid padding windows) and on
   the score blocks captured from the slice run, from the fleet's
   chain group ([32, 1025, 2049]) and from the executor phase (the
   largest K1 block of the exp5 loop, of ground-truth-free discovery (a
   block of >= 256 windows, from the exp5 loop and ``alibaba-cg-8k``)
   and of ``alibaba-cg-8k``, and the stream's, the serve run's, the
   capture legs' and the adapt runs' largest, less their ill-posed
   windows: windows with an
   incoming span that has no feasible child and no skip room, whose
   plans are rounding noise);
   ``two-streams``: K1 and K2 launched
   from two host threads on two CUDA streams at once, on those two
   blocks and two small blocks of other shapes (so the threads' launches
   need different shared-memory limits), must equal their single-stream
   launches bit for bit; K1 and K2 on the bf16 blocks of the precision
   phase ([8, 1025, 2049] and [32, 1025, 2049]) against their plain bf16
   versions under the same rule; the assembly kernel against its plain
   version on every block of the first forward and backward sweeps of
   the slice's and the fleet's chains, of the capture's clean leg and of
   the adapt runs' refit, at f32 and bf16 (``score-check``
   lines: feasible counts and argmax exactly, the entries that differ
   and their largest difference, tolerance 1e-5 relative plus 1e-4
   absolute at f32 and one bf16 ulp at bf16); then each kernel's time,
   its plain version's time and its bound at both blocks, f32 and bf16,
   and the assembly's per sweep with the card's operations per
   endpoint step (``score-build`` lines).

``--mesh`` runs only the mesh phase (its corpus built in the phase).

``--stream`` runs only the stream phase and its K1 block's check (and
the CPU stream where the card met ill-posed windows); ``--serve`` the
same for the serve phase; ``--fleet`` only the fleet phase. ``--capture`` and ``--adapt`` run only their
phases, their K1 blocks' and assembly calls' checks, and for
``--capture`` the native schemes' check.

``--assembly`` runs only the assembly's check and timing, on the first
sweeps of one ``synth-async-8k`` and one ``synth-fleet-8svc`` solve,
and where its warps spend their cycles (a build of the kernel that
clocks its phases: ``score-build-phases`` lines).

``--slice-root`` runs the slice and fleet phases alone against another
checkout (one process per checkout, since both packages share a name),
so that two commits are compared on one card in turns, then times K1
and K2 on the slice's and the fleet's captured blocks (``kernel-ab``
lines: each block is the first of its solve, the same for every
checkout); its fleet phase needs a checkout whose ``solve_fleet`` has
the pipelined flow.

Lines: ``slice`` and ``fleet`` lines carry the wall time and the summed
device time of the path's kernel launches (CUDA events around each
launch on the launching thread's stream; ``kernel_ms`` on the slice
line, ``kernel_ms_summed`` on the fleet lines, where the flows' streams
overlap, so it is no share of the wall), the stage seconds,
``pipeline_groups`` and ``pipeline_depth``; ``fleet-warm`` lines carry
the plan-cache counters, plan-fit seconds, launches and accuracy of
each round; ``fleet-confidence`` lines the records and mean confidence
per service and the accuracy of the spans above and at or below
``CONF_LOW``; ``executor`` lines per CLI call the services solved,
their incoming spans, wall and stage seconds (``seconds``: ingest and
each method; on the ``alibaba-cg-8k`` line also ``prepare_s`` and
``solve_fleet``'s stages), fleet dispatches, K1 launches and summed
device ms, peak memory, end-to-end accuracy per method and the
flagship's accuracy per service, the ill-posed windows and windows
and the ingest front end (``executor-gtfree`` lines add the discovered
edges and discovery's seconds: deep copies, solves and pruning apart);
``ingest-front-ends`` lines the seconds of both front ends;
``profile`` lines the idle share over the traced call and, from the
same device-busy time, over the call's unprofiled wall (the profiler
slows the host); ``executor-phase`` the phase's wall; the ``stream``
line the stream's counts, accuracy (JAX's and the port's batch beside
it), wall, events per second, stage seconds (solve, emit, checkpoint),
launches, ill-posed windows, the unmet windows of its largest K1 block,
peak memory and the device idle share of the profiled half run;
``stream-resume`` the kill, the resume and the byte check.
The kernel-timing lines carry each kernel's cluster size and the three
terms of its bound.

The last lines are the launch counts (the ground-truth-free loops' and
the scorecard's apart), the kernel table as one JSON
object, the card's name and power limit, and the result object. In the
table, ``max_abs_err`` is, for the Sinkhorn kernel, the largest
absolute plan difference from the plain version; for the fused kernel,
whose outputs are indices, the largest plain-plan mass difference
between the kernel's and the plain column on rows where they differ
(0 when every row agrees).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

# JAX package on the CPU, same config: 0.9847412109375
# (tests/jax_reference_synth.py), less one point
ACCURACY_FLOOR = 0.9747
# JAX package on the CPU, config synth-fleet-8svc, per service
# (JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config
# synth-fleet-8svc); each service's floor is its number less one point
FLEET_JAX_ACCURACY = {
    "chain0": 0.9847412109375, "chain1": 0.9864501953125,
    "chain2": 0.9869384765625, "chain3": 0.9857177734375,
    "async": 0.5130615234375, "fanout": 0.1552734375, "seq": 1.0,
    "cache": 0.1636962890625}
FLEET_SMALL = 256
# JAX package on the CPU, end-to-end accuracy in percent per method, from
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-15000
# (exp5's corpus: 15 call graphs x 1000 traces of seed 10, compress 15000,
# predictors 3,4,7,10); the host baselines must equal them, the flagship
# reach them less one point
EXP5_JAX_ACCURACY = {
    "call_graph_0": {"WAP5": 0.0, "FCFS": 77.10000000000001, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 98.8},
    "call_graph_1": {"WAP5": 0.0, "FCFS": 46.6, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 91.9},
    "call_graph_2": {"WAP5": 0.0, "FCFS": 62.1, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 97.6},
    "call_graph_3": {"WAP5": 0.0, "FCFS": 99.0, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 100.0},
    "call_graph_4": {"WAP5": 0.0, "FCFS": 17.599999999999998, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 80.10000000000001},
    "call_graph_5": {"WAP5": 0.0, "FCFS": 49.3, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 86.6},
    "call_graph_6": {"WAP5": 0.0, "FCFS": 61.199999999999996, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 92.5},
    "call_graph_7": {"WAP5": 0.0, "FCFS": 32.1, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 92.5},
    "call_graph_8": {"WAP5": 0.0, "FCFS": 76.4, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 99.6},
    "call_graph_9": {"WAP5": 0.0, "FCFS": 25.8, "vPath": 0.0,
                     "MaxScoreBatchSubsetWithSkips": 66.5},
    "call_graph_10": {"WAP5": 0.0, "FCFS": 35.5, "vPath": 0.0,
                      "MaxScoreBatchSubsetWithSkips": 93.7},
    "call_graph_11": {"WAP5": 0.0, "FCFS": 83.7, "vPath": 0.0,
                      "MaxScoreBatchSubsetWithSkips": 99.2},
    "call_graph_12": {"WAP5": 0.0, "FCFS": 98.6, "vPath": 0.0,
                      "MaxScoreBatchSubsetWithSkips": 100.0},
    "call_graph_13": {"WAP5": 0.0, "FCFS": 43.2, "vPath": 0.0,
                      "MaxScoreBatchSubsetWithSkips": 95.6},
    "call_graph_14": {"WAP5": 12.2, "FCFS": 99.2, "vPath": 3.6999999999999997,
                      "MaxScoreBatchSubsetWithSkips": 99.6}}
# the same run, call_graph_0 with exp4's predictors 2,8,9,10 at compress 1
EXP4_JAX_ACCURACY = {"MaxScore": 100.0, "MaxScoreBatchParallelWithoutIterations": 100.0,
                     "MaxScoreBatchParallel": 100.0, "MaxScoreBatchSubsetWithSkips": 100.0}
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-cg-8k
# (call graph 0 of seed 10 at 8192 traces, compress 15000, predictor 10)
CG8K_JAX_ACCURACY = {"MaxScoreBatchSubsetWithSkips": 94.7998046875}
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config alibaba-exp5-gtfree
# (exp5's top rung, predictor 10, gt_free_dag): the flagship reading and
# each service's discovered edges per graph (on every graph the edges
# equal the ground-truth DAG's and the reading the ground-truth run's)
EXP5_GTFREE_JAX = {
    "call_graph_0": (98.8, {
        "MS_00002": [["MS_00017", "MS_00029"], ["MS_00017", "MS_00041"], ["MS_00029", "MS_00041"]],
        "MS_00017": [],
        "MS_00029": [],
        "MS_00041": [],
    }),
    "call_graph_1": (91.9, {
        "MS_00000": [["MS_00012", "MS_00055"], ["MS_00012", "MS_00029"], ["MS_00055", "MS_00029"]],
        "MS_00017": [],
        "MS_00037": [],
        "MS_00049": [["MS_00000", "MS_00037"]],
    }),
    "call_graph_2": (97.6, {
        "MS_00032": [["MS_00039", "MS_00014"]],
        "MS_00039": [],
    }),
    "call_graph_3": (100.0, {
        "MS_00036": [["MS_00041", "MS_00030"]],
        "MS_00057": [],
    }),
    "call_graph_4": (80.10000000000001, {
        "MS_00001": [],
        "MS_00030": [["MS_00010", "MS_00008"]],
        "MS_00050": [],
        "MS_00058": [["MS_00021", "MS_00017"]],
        "MS_00059": [["MS_00001", "MS_00050"]],
    }),
    "call_graph_5": (86.6, {
        "MS_00013": [["MS_00048", "MS_00016"]],
        "MS_00023": [],
        "MS_00031": [["MS_00023", "MS_00003"], ["MS_00023", "MS_00013"], ["MS_00003", "MS_00013"]],
        "MS_00047": [],
    }),
    "call_graph_6": (92.5, {
        "MS_00027": [["MS_00014", "MS_00058"]],
        "MS_00032": [["MS_00040", "MS_00027"]],
    }),
    "call_graph_7": (92.5, {
        "MS_00009": [],
        "MS_00016": [],
        "MS_00019": [],
        "MS_00021": [],
        "MS_00023": [],
        "MS_00024": [],
        "MS_00033": [["MS_00018", "MS_00006"]],
        "MS_00058": [["MS_00021", "MS_00019"], ["MS_00021", "MS_00023"], ["MS_00019", "MS_00023"]],
    }),
    "call_graph_8": (99.6, {
        "MS_00023": [],
        "MS_00042": [],
    }),
    "call_graph_9": (66.5, {
        "MS_00015": [["KcBEKanD0F0rPZkc-loop", "MS_00027"]],
        "MS_00027": [],
        "MS_00044": [["MS_00005", "HFuep88VxcA3iMwy-loop"]],
    }),
    "call_graph_10": (93.7, {
        "MS_00007": [],
        "MS_00008": [["MS_00009", "MS_00040"]],
        "MS_00009": [],
        "MS_00018": [["MS_00025", "MS_00006"]],
        "MS_00031": [["MS_00018", "MS_00049"]],
        "MS_00032": [],
        "MS_00040": [],
    }),
    "call_graph_11": (99.2, {
        "MS_00044": [["MS_00043", "MS_00001"]],
        "MS_00051": [],
    }),
    "call_graph_12": (100.0, {
        "MS_00018": [],
        "MS_00034": [],
    }),
    "call_graph_13": (95.6, {
        "MS_00014": [],
        "MS_00033": [],
        "MS_00052": [["MS_00057", "KcBEKanD0F0rPZkc-loop"]],
        "MS_00054": [],
        "MS_00055": [["MS_00033", "MS_00052"]],
        "MS_00058": [["MS_00054", "MS_00055"]],
    }),
    "call_graph_14": (99.6, {
        "MS_00017": [["MS_00008", "MS_00044"]],
    }),
}
# ... --config alibaba-cg-8k-gtfree (the discovered edges are the
# ground-truth DAG's)
CG8K_GTFREE_JAX_ACCURACY = {"MaxScoreBatchSubsetWithSkips": 94.7998046875}
# the JAX package's run_scorecard(seed=0, n_traces=32) on the CPU: per
# regime and method; its calibration verdict is "monotone-ish: OK"
SCORECARD_JAX = {
    "async": {"arrival_order": 0.375, "fcfs": 0.375, "vpath": 0.0, "wap5": 0.0,
              "weaver_exact": 0.4167, "weaver_tpu": 0.375},
    "fanout": {"arrival_order": 0.1875, "fcfs": 0.1875, "vpath": 0.0, "wap5": 0.0,
               "weaver_exact": 0.0833, "weaver_tpu": 0.1875},
    "sequential": {"arrival_order": 1.0, "fcfs": 1.0, "vpath": 1.0, "wap5": 1.0,
                   "weaver_exact": 1.0, "weaver_tpu": 1.0}}
# the same configs at TW_PRECISION=bf16 (the JAX package's bf16 score
# path): ... synth-async-8k, ... --config synth-fleet-8svc, ... --config
# alibaba-cg-8k, each with TW_PRECISION=bf16 in the environment
BF16_JAX_ACCURACY = 0.9847412109375
FLEET_BF16_JAX_ACCURACY = {
    "chain0": 0.9847412109375, "chain1": 0.9864501953125,
    "chain2": 0.9869384765625, "chain3": 0.985595703125,
    "async": 0.513427734375, "fanout": 0.1553955078125, "seq": 1.0,
    "cache": 0.354736328125}
CG8K_BF16_JAX_ACCURACY = {"MaxScoreBatchSubsetWithSkips": 94.81201171875}
# the bf16 fleet's `cache` service: the port on the CPU reads JAX's
# 35.4736328125% exactly, the card 25.2808% (five H100 runs alike). About a
# third of its K1 blocks are windows whose plan cannot meet its row
# marginals (unmet_windows), where the plain version in f32 and in f64
# part on most windows already; elsewhere K1 and the plain version assign
# alike but where a plan holds a near tie (cache_check). The card is held
# within this many points of JAX either way, set from those readings.
CACHE_BF16_MAX_PT = 12.0
# synth-async-8k with TW_SCORE_GEMM=1 (the GEMM score form)
GEMM_JAX_ACCURACY = 0.9847412109375
FLAGSHIP = "MaxScoreBatchSubsetWithSkips"
HOST_BASELINES = ("WAP5", "FCFS", "vPath", "MaxScore")
# ... --config alibaba-exp5-ladder and alibaba-exp5-ladder-hard (exp5's
# ladder, clean and messy corpus): end-to-end accuracy per compress
# factor and graph, in the order of LADDER_METHODS
LADDER_METHODS = ("WAP5", "FCFS", "vPath", FLAGSHIP)
EXP5_LADDER_JAX = {
    1: {
        "call_graph_0": [100.0, 100.0, 100.0, 100.0],
        "call_graph_1": [100.0, 100.0, 100.0, 100.0],
        "call_graph_2": [100.0, 100.0, 100.0, 100.0],
        "call_graph_3": [100.0, 100.0, 100.0, 100.0],
        "call_graph_4": [100.0, 100.0, 100.0, 100.0],
        "call_graph_5": [100.0, 100.0, 100.0, 100.0],
        "call_graph_6": [100.0, 100.0, 100.0, 100.0],
        "call_graph_7": [100.0, 100.0, 100.0, 100.0],
        "call_graph_8": [100.0, 100.0, 100.0, 100.0],
        "call_graph_9": [100.0, 100.0, 100.0, 100.0],
        "call_graph_10": [100.0, 100.0, 100.0, 100.0],
        "call_graph_11": [100.0, 100.0, 100.0, 100.0],
        "call_graph_12": [100.0, 100.0, 100.0, 100.0],
        "call_graph_13": [100.0, 100.0, 100.0, 100.0],
        "call_graph_14": [100.0, 100.0, 100.0, 100.0],
    },
    200: {
        "call_graph_0": [100.0, 100.0, 100.0, 100.0],
        "call_graph_1": [100.0, 100.0, 100.0, 100.0],
        "call_graph_2": [100.0, 100.0, 100.0, 100.0],
        "call_graph_3": [100.0, 100.0, 100.0, 100.0],
        "call_graph_4": [100.0, 100.0, 77.7, 100.0],
        "call_graph_5": [100.0, 100.0, 96.8, 100.0],
        "call_graph_6": [100.0, 100.0, 100.0, 100.0],
        "call_graph_7": [100.0, 100.0, 71.5, 100.0],
        "call_graph_8": [100.0, 100.0, 83.7, 100.0],
        "call_graph_9": [100.0, 100.0, 80.2, 100.0],
        "call_graph_10": [100.0, 100.0, 84.0, 100.0],
        "call_graph_11": [100.0, 100.0, 97.6, 100.0],
        "call_graph_12": [100.0, 100.0, 100.0, 100.0],
        "call_graph_13": [100.0, 100.0, 95.8, 100.0],
        "call_graph_14": [100.0, 100.0, 100.0, 100.0],
    },
    1000: {
        "call_graph_0": [75.0, 100.0, 52.7, 100.0],
        "call_graph_1": [60.6, 100.0, 33.1, 100.0],
        "call_graph_2": [27.900000000000002, 100.0, 21.7, 100.0],
        "call_graph_3": [100.0, 100.0, 56.49999999999999, 100.0],
        "call_graph_4": [1.0999999999999999, 99.6, 5.2, 100.0],
        "call_graph_5": [89.5, 100.0, 42.4, 100.0],
        "call_graph_6": [100.0, 100.0, 54.50000000000001, 100.0],
        "call_graph_7": [5.4, 100.0, 0.6, 100.0],
        "call_graph_8": [72.8, 100.0, 6.1, 100.0],
        "call_graph_9": [17.1, 100.0, 10.0, 100.0],
        "call_graph_10": [6.5, 100.0, 3.6999999999999997, 100.0],
        "call_graph_11": [100.0, 100.0, 25.0, 100.0],
        "call_graph_12": [100.0, 100.0, 51.300000000000004, 100.0],
        "call_graph_13": [49.6, 100.0, 13.700000000000001, 100.0],
        "call_graph_14": [100.0, 100.0, 100.0, 100.0],
    },
    4000: {
        "call_graph_0": [0.0, 100.0, 0.0, 100.0],
        "call_graph_1": [0.0, 97.8, 0.0, 99.8],
        "call_graph_2": [0.0, 98.6, 0.1, 99.8],
        "call_graph_3": [50.8, 100.0, 1.6, 100.0],
        "call_graph_4": [0.0, 85.7, 0.0, 99.4],
        "call_graph_5": [0.0, 98.8, 0.2, 99.8],
        "call_graph_6": [5.1, 100.0, 0.1, 100.0],
        "call_graph_7": [0.0, 97.0, 0.0, 99.6],
        "call_graph_8": [0.0, 100.0, 0.0, 100.0],
        "call_graph_9": [0.0, 88.2, 0.0, 99.6],
        "call_graph_10": [0.0, 97.2, 0.0, 100.0],
        "call_graph_11": [6.800000000000001, 100.0, 0.3, 100.0],
        "call_graph_12": [65.60000000000001, 100.0, 0.7000000000000001, 100.0],
        "call_graph_13": [0.0, 97.39999999999999, 0.0, 99.6],
        "call_graph_14": [99.8, 100.0, 73.3, 100.0],
    },
    10000: {
        "call_graph_0": [0.0, 92.2, 0.0, 98.6],
        "call_graph_1": [0.0, 71.8, 0.0, 96.2],
        "call_graph_2": [0.0, 79.4, 0.0, 97.0],
        "call_graph_3": [0.0, 100.0, 0.0, 100.0],
        "call_graph_4": [0.0, 35.8, 0.0, 89.8],
        "call_graph_5": [0.0, 74.6, 0.0, 98.0],
        "call_graph_6": [0.0, 81.39999999999999, 0.0, 99.2],
        "call_graph_7": [0.0, 61.0, 0.0, 97.0],
        "call_graph_8": [0.0, 91.4, 0.0, 100.0],
        "call_graph_9": [0.0, 47.0, 0.0, 93.8],
        "call_graph_10": [0.0, 62.4, 0.0, 96.39999999999999],
        "call_graph_11": [0.0, 95.6, 0.0, 100.0],
        "call_graph_12": [0.0, 100.0, 0.0, 100.0],
        "call_graph_13": [0.0, 67.0, 0.0, 99.4],
        "call_graph_14": [45.5, 100.0, 13.100000000000001, 100.0],
    },
    15000: {
        "call_graph_0": [0.0, 77.10000000000001, 0.0, 98.8],
        "call_graph_1": [0.0, 46.6, 0.0, 91.9],
        "call_graph_2": [0.0, 62.1, 0.0, 97.6],
        "call_graph_3": [0.0, 99.0, 0.0, 100.0],
        "call_graph_4": [0.0, 17.599999999999998, 0.0, 80.10000000000001],
        "call_graph_5": [0.0, 49.3, 0.0, 86.6],
        "call_graph_6": [0.0, 61.199999999999996, 0.0, 92.5],
        "call_graph_7": [0.0, 32.1, 0.0, 92.5],
        "call_graph_8": [0.0, 76.4, 0.0, 99.6],
        "call_graph_9": [0.0, 25.8, 0.0, 66.5],
        "call_graph_10": [0.0, 35.5, 0.0, 93.7],
        "call_graph_11": [0.0, 83.7, 0.0, 99.2],
        "call_graph_12": [0.0, 98.6, 0.0, 100.0],
        "call_graph_13": [0.0, 43.2, 0.0, 95.6],
        "call_graph_14": [12.2, 99.2, 3.6999999999999997, 99.6],
    },
}
EXP5_LADDER_HARD_JAX = {
    1: {
        "call_graph_0": [100.0, 0.11061946902654868, 0.0, 100.0],
        "call_graph_1": [100.0, 100.0, 100.0, 100.0],
        "call_graph_2": [100.0, 100.0, 100.0, 100.0],
        "call_graph_3": [100.0, 100.0, 100.0, 100.0],
        "call_graph_4": [100.0, 100.0, 100.0, 100.0],
        "call_graph_5": [100.0, 100.0, 100.0, 100.0],
        "call_graph_6": [100.0, 100.0, 100.0, 100.0],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [100.0, 100.0, 100.0, 100.0],
        "call_graph_9": [100.0, 100.0, 100.0, 100.0],
        "call_graph_10": [100.0, 100.0, 100.0, 100.0],
        "call_graph_11": [100.0, 100.0, 100.0, 100.0],
        "call_graph_12": [100.0, 100.0, 100.0, 100.0],
        "call_graph_13": [100.0, 100.0, 100.0, 100.0],
        "call_graph_14": [100.0, 100.0, 100.0, 100.0],
    },
    200: {
        "call_graph_0": [100.0, 0.11061946902654868, 0.0, 100.0],
        "call_graph_1": [100.0, 100.0, 100.0, 100.0],
        "call_graph_2": [100.0, 100.0, 100.0, 100.0],
        "call_graph_3": [100.0, 100.0, 100.0, 100.0],
        "call_graph_4": [100.0, 100.0, 99.66666666666667, 100.0],
        "call_graph_5": [81.89944134078212, 100.0, 87.70949720670392, 100.0],
        "call_graph_6": [100.0, 100.0, 95.97765363128492, 100.0],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [100.0, 100.0, 84.02234636871509, 100.0],
        "call_graph_9": [0.5599104143337066, 100.0, 55.5431131019037, 100.0],
        "call_graph_10": [100.0, 100.0, 100.0, 100.0],
        "call_graph_11": [100.0, 100.0, 100.0, 100.0],
        "call_graph_12": [100.0, 100.0, 93.56659142212189, 100.0],
        "call_graph_13": [100.0, 100.0, 100.0, 100.0],
        "call_graph_14": [100.0, 100.0, 97.50566893424036, 100.0],
    },
    1000: {
        "call_graph_0": [98.67256637168141, 0.11061946902654868, 1.2168141592920354, 100.0],
        "call_graph_1": [96.89578713968959, 100.0, 32.70509977827051, 100.0],
        "call_graph_2": [100.0, 100.0, 35.07214206437292, 100.0],
        "call_graph_3": [100.0, 100.0, 99.44506104328525, 100.0],
        "call_graph_4": [96.0, 100.0, 21.555555555555557, 100.0],
        "call_graph_5": [0.0, 100.0, 6.145251396648044, 100.0],
        "call_graph_6": [100.0, 100.0, 43.910614525139664, 100.0],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [1.1173184357541899, 100.0, 13.40782122905028, 100.0],
        "call_graph_9": [0.0, 94.40089585666294, 0.5599104143337066, 99.77603583426652],
        "call_graph_10": [100.0, 100.0, 100.0, 100.0],
        "call_graph_11": [63.85135135135135, 100.0, 28.265765765765767, 100.0],
        "call_graph_12": [96.83972911963883, 100.0, 21.557562076749438, 100.0],
        "call_graph_13": [97.29119638826185, 100.0, 44.01805869074492, 100.0],
        "call_graph_14": [26.190476190476193, 100.0, 4.195011337868481, 100.0],
    },
    4000: {
        "call_graph_0": [40.597345132743364, 0.22123893805309736, 7.964601769911504, 90.37610619469027],
        "call_graph_1": [1.2195121951219512, 100.0, 0.0, 100.0],
        "call_graph_2": [29.855715871254162, 100.0, 0.11098779134295228, 100.0],
        "call_graph_3": [87.0144284128746, 100.0, 34.62819089900111, 100.0],
        "call_graph_4": [0.8888888888888888, 100.0, 0.1111111111111111, 100.0],
        "call_graph_5": [0.0, 88.71508379888267, 0.0, 97.98882681564245],
        "call_graph_6": [4.916201117318435, 100.0, 0.11173184357541899, 100.0],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [0.0, 85.2513966480447, 0.0, 97.6536312849162],
        "call_graph_9": [0.0, 35.38633818589026, 0.0, 78.94736842105263],
        "call_graph_10": [88.01791713325868, 100.0, 63.26987681970885, 100.0],
        "call_graph_11": [0.11261261261261261, 98.1981981981982, 0.0, 100.0],
        "call_graph_12": [1.0158013544018059, 100.0, 0.1128668171557562, 100.0],
        "call_graph_13": [2.0316027088036117, 99.32279909706546, 0.4514672686230248, 2.2573363431151243],
        "call_graph_14": [0.0, 90.702947845805, 0.0, 97.95918367346938],
    },
    10000: {
        "call_graph_0": [0.33185840707964603, 0.4424778761061947, 3.0973451327433628, 61.283185840707965],
        "call_graph_1": [0.0, 88.470066518847, 0.0, 98.66962305986696],
        "call_graph_2": [0.11098779134295228, 98.00221975582686, 0.0, 100.0],
        "call_graph_3": [15.09433962264151, 98.44617092119867, 3.662597114317425, 10.876803551609324],
        "call_graph_4": [0.0, 97.55555555555556, 0.0, 100.0],
        "call_graph_5": [0.0, 36.424581005586596, 0.0, 83.0167597765363],
        "call_graph_6": [0.0, 95.41899441340782, 0.0, 98.65921787709497],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [0.0, 37.988826815642454, 0.0, 78.99441340782123],
        "call_graph_9": [0.0, 3.135498320268757, 0.0, 41.2094064949608],
        "call_graph_10": [16.7973124300112, 98.88017917133259, 21.612541993281077, 100.0],
        "call_graph_11": [0.0, 73.76126126126125, 0.0, 96.3963963963964],
        "call_graph_12": [0.0, 92.55079006772009, 0.0, 100.0],
        "call_graph_13": [0.0, 84.53724604966139, 0.0, 3.160270880361174],
        "call_graph_14": [0.0, 51.70068027210885, 0.0, 84.4671201814059],
    },
    15000: {
        "call_graph_0": [0.0, 0.7743362831858407, 0.8849557522123894, 43.584070796460175],
        "call_graph_1": [0.0, 68.07095343680709, 0.0, 97.11751662971176],
        "call_graph_2": [0.0, 91.56492785793563, 0.0, 100.0],
        "call_graph_3": [0.6659267480577136, 94.6725860155383, 0.776914539400666, 5.438401775804662],
        "call_graph_4": [0.0, 89.44444444444444, 0.0, 100.0],
        "call_graph_5": [0.0, 13.184357541899441, 0.0, 50.83798882681564],
        "call_graph_6": [0.0, 83.35195530726257, 0.0, 33.85474860335195],
        "call_graph_7": [0.0, 0.0, 0.0, 0.0],
        "call_graph_8": [0.0, 18.547486033519554, 0.0, 63.01675977653631],
        "call_graph_9": [0.0, 0.7838745800671892, 0.0, 18.81298992161254],
        "call_graph_10": [0.7838745800671892, 96.64053751399776, 8.3986562150056, 99.77603583426652],
        "call_graph_11": [0.0, 50.0, 0.0, 88.51351351351352],
        "call_graph_12": [0.0, 80.58690744920993, 0.0, 100.0],
        "call_graph_13": [0.0, 67.15575620767494, 0.0, 1.0158013544018059],
        "call_graph_14": [0.0, 28.2312925170068, 0.0, 65.75963718820861],
    },
}
# the smoke's ladder: two of the five lower rungs (the executor phase's
# exp5 loop is the top one) on the graphs whose top rung met ill-posed
# windows (0, 4, 5, 9) and one clean graph, and the messy corpus's graph
# 9 (LADDER_HARD_*). Compress 10000 is the rung that meets ill-posed
# windows on these graphs (0, 4 and 5); at 1, 200 and 4000 none did, and
# the flagship read 100 at 1 and 200 on all five. With those three rungs
# the smoke ran past its 1200 s on the card, so they are left to --ladder
LADDER_RUNGS = (1000, 10000)
LADDER_GRAPHS = (0, 3, 4, 5, 9)
# the messy corpus's graph 9 at compress 1000 and 4000: 4000 meets
# ill-posed windows (29 of 5021 on the card) and is one of the calls where
# the port's CPU run parts from JAX's (LADDER_PORT_CPU); its top two
# rungs' CPU reruns take 456 and 607 s on the card's machine, so they,
# its two lowest rungs and the other 14 graphs are left to --ladder
LADDER_HARD_GRAPHS = (9,)
LADDER_HARD_RUNGS = (1000, 4000)
# ladder calls where the port's CPU run reads another number than JAX's,
# with the reading it gives (the same on a CPU-only host and on the
# card's machine): the two compute the same f32 algorithm with other
# reduction orders, and on these messy-corpus calls the last bits decide
# assignments: at near-tied plan masses (graph 0 at 4000, pinned by
# tests/test_torch_ladder.py), after the refit between the two passes,
# whose parameters part by a few ulps from identical inputs (graph 9),
# or in a solve whose windows are mostly ill-posed (graph 0 at 10000 and
# 15000). A CPU rerun of such a call must equal this reading exactly
# (ROADMAP C.1); every other call's must equal JAX's.
LADDER_PORT_CPU = {
    ("alibaba-exp5-ladder-hard", "call_graph_0", 4000): 90.2654867256637,
    ("alibaba-exp5-ladder-hard", "call_graph_9", 4000): 78.49944008958568,
    ("alibaba-exp5-ladder-hard", "call_graph_0", 10000): 59.40265486725663,
    ("alibaba-exp5-ladder-hard", "call_graph_9", 10000): 41.097424412094064,
    ("alibaba-exp5-ladder-hard", "call_graph_0", 15000): 42.92035398230089,
    ("alibaba-exp5-ladder-hard", "call_graph_9", 15000): 19.148936170212767,
}
# an exp5 graph whose card run met ill-posed windows: the bounds on the
# card's flagship, set from the H100 readings in PERF.md §5 (worst: graph
# 5 reads 6.6 pt above JAX, graph 9 keeps 94% of one service's pairs)
ILL_POSED_MAX_PT = 7.0
ILL_POSED_MIN_PAIRS = 0.9
# config stream-cg-8k: one call graph of seed 10 at 8192 traces, 20 ms
# apart, replayed with 50 ms of arrival jitter through 20 s windows (4 s
# overlap, 2 s watermark, no grace, four pending windows)
STREAM_CORPUS = dict(n_graphs=1, traces_per_graph=8192, seed=10, base_gap_ms=20)
STREAM_QUERY = "fix=5&max_traces=8192&ooo_ms=50&seed=1"
STREAM_ARGS = ["--window_s", "20", "--overlap_s", "4", "--watermark_s", "2",
               "--grace_s", "0", "--max_pending", "4"]
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config stream-cg-8k
# (the JAX package's stream on the CPU, then its batch executor, predictor
# 10, on the same store; that batch reading is only reported: run alone,
# --config stream-cg-8k-batch, JAX reads 11.38916015625, PERF.md section 7)
STREAM_JAX = dict(consumed=106496, windows=14, micro_batches=14, spans_emitted=106496,
                  late_rerouted=0, late_dropped=0, shed_spilled=0, shed_dropped_windows=0,
                  deadletter_windows=0, streamed_e2e=96.435546875,
                  batch_e2e=68.76220703125)
# The port's CPU stream reads this instead (the CPU rerun must equal it
# exactly): from equal inputs the two part in one solver window of window
# 0's cold solve, at a K1 block where two rows score two columns alike and
# f32 rounding breaks the tie (the plans agree to 2e-6); the sweeps and
# the warm-started windows carry the swap on. The first three emitted
# windows of both sinks assign alike
# (tests/test_torch_stream_cg8k.py pins this; ROADMAP C.1).
STREAM_PORT_CPU = 96.42333984375
# config serve-cg-4t: four call graphs of seed 10 at 8192 traces, 20 ms
# apart, one tenant each (t0-t3), posted in root start-time order in
# bodies of 256 traces through the serve tier with the stream's geometry
SERVE_CORPUS = dict(n_graphs=4, traces_per_graph=8192, seed=10, base_gap_ms=20)
SERVE_BODY_TRACES = 256
SERVE_TENANTS = ("t0", "t1", "t2", "t3")
SERVE_SETTINGS = dict(fix=5, window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6,
                      grace_us=0.0, slo_p99_ms=2000.0, inflight=2, pump_windows=8)
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config serve-cg-4t
# (the JAX package's TenantService on the CPU, in process, the same bodies
# and settings; the sinks' accuracy by serve_sink_accuracy, in percent),
# with TW_DEVCOLS=0 in front: the host packer. "shared" is the four
# tenants under continuous admission, "alone" t0 alone under the fixed
# pump (eight windows a pump), "alone1" under a pump of one window. In both every tenant sealed and emitted 14 windows and every span,
# with no late, shed or dead-lettered window. The "*_resident" readings
# are the same runs on the JAX package's default resident columns, which
# read otherwise: its one global ring a partition kind is smaller than
# the working set of a pump or a ticket here, and its gathers then read
# evicted slots (PERF.md section 6). The port's resident path,
# which keeps a ring per tenant and service and checks its slots before
# a gather, equals its host path, so it is held to the host-packed
# readings. "shared_vs_alone_rows" is the share of t0's shared-run rows
# that its alone run assigns alike, per service, in the JAX package
# itself (resident): the two runs batch t0's windows differently, and the
# carried warm-start state follows the batches
SERVE_JAX = dict(
    shared=dict(
        t0=dict(e2e=95.556640625, per_service={
            "MS_00002": 98.61246744791667, "MS_00017": 99.9755859375,
            "MS_00029": 99.1943359375, "MS_00041": 98.6572265625}),
        t1=dict(e2e=99.15771484375, per_service={"MS_00048": 99.15771484375}),
        t2=dict(e2e=99.54833984375, per_service={"MS_00044": 99.774169921875,
                                                  "MS_00059": 100.0}),
        t3=dict(e2e=100.0, per_service={"MS_00012": 100.0, "MS_00042": 100.0})),
    shared_resident=dict(
        t0=dict(e2e=90.283203125), t1=dict(e2e=68.27392578125),
        t2=dict(e2e=99.6826171875), t3=dict(e2e=92.05322265625)),
    alone=dict(t0=dict(e2e=66.24755859375, per_service={
        "MS_00002": 74.89827473958333, "MS_00017": 99.98779296875,
        "MS_00029": 99.072265625, "MS_00041": 98.69384765625})),
    alone_resident=dict(t0=dict(e2e=64.3798828125)),
    alone1=dict(t0=dict(e2e=96.4599609375, per_service={
        "MS_00002": 98.85660807291667, "MS_00017": 99.9755859375,
        "MS_00029": 99.2919921875, "MS_00041": 98.9990234375})),
    shared_vs_alone_rows={"MS_00002": 0.7802327473958334, "MS_00017": 1.0,
                          "MS_00029": 0.9947509765625, "MS_00041": 0.9913330078125})
# The port's CPU run of t0 alone under a pump of one window reads this
# instead (the CPU rerun must equal it exactly; JAX reads 96.4599609375
# with and without its resident columns): the two assign windows 0-2
# alike, then the statistics each carries to window 3, refitted on the
# host from equal assignments, part in the last bits (2e-6 relative) and
# a few rows flip from there on (tests/test_torch_serve_cg4t_pump1.py
# pins this; ROADMAP C.1). Under the pump of eight the two part wholesale
# in four cold windows at exact-mass ties (66.50390625 against
# 66.24755859375; tests/test_torch_serve_cg4t.py, ROADMAP C.3), which no
# check reads: that CPU run takes 1438 s on the card's machine
SERVE_PORT_CPU = 96.56982421875
# config fleet-cg-4t-2r: serve-cg-4t's corpus and settings through the
# replica fleet tier, two `cli serve` replica processes on the card behind
# the router (the serve CLI's defaults and the stream's geometry)
FLEET_REPLICA_ARGS = ["--fix", "5", "--window_s", "20", "--overlap_s", "4",
                      "--watermark_s", "2", "--grace_s", "0"]
# the byte-identity legs: the kill/resume leg's settings (the fixed pump)
FLEET_PUMP_ARGS = FLEET_REPLICA_ARGS + ["--no-continuous"]
# t0's body after which it is live-migrated, t1's during which its
# replica is SIGKILLed
FLEET_MIGRATE_AT, FLEET_KILL_AT = 16, 20
# how long the phase waits for a migration, a recovery or a drain (the
# fleets themselves run at the router's defaults)
FLEET_WAIT_S = 600.0
# ill-posed service windows of each tenant in serve-cg-4t's shared run
# (the serve line of chip_smoke.py on an NVIDIA H100 80GB HBM3, 700 W):
# the accuracy rule of --fleet alone, which runs no serve phase
SERVE_ILL_POSED = dict(t0=12, t1=3, t2=5, t3=0)
# capture-8k: bench.py's capture workload (frontend -> search over HTTP/2,
# one reconnect without close mid-capture) at 8192 traces, through
# ``cli stream --source collector:<dir>`` at stream-cg-8k's geometry;
# three legs under fault seed 1, as the JAX package's capture leg
CAPTURE_TRACES = 8192
CAPTURE_ARGS = ["--window_s", "20", "--overlap_s", "4", "--watermark_s", "2",
                "--checkpoint_every", "10000"]
CAPTURE_LEGS = (("clean", None), ("skew", "skew:1.0:max=1"), ("lossy", "capture:0.04"))
CAPTURE_SERVE = dict(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6, grace_us=0.0)
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config capture-8k
CAPTURE_JAX = {
    "clean": dict(events=24576, windows=7, accuracy=100.0, loss={}, loss_rate=0.0,
                  rekeyed=1, skew_us={"frontend": 0.0, "search": -50.0}, conf_discount=1.0),
    "skew": dict(events=24576, windows=7, accuracy=100.0, loss={}, loss_rate=0.0,
                 rekeyed=1, skew_us={"frontend": 0.0, "search": -250050.0},
                 conf_discount=1.0),
    "lossy": dict(events=35, windows=3, accuracy=66.66666666666666,
                  loss={"dropped_chunk": 49092, "half_open": 18}, loss_rate=0.3396,
                  rekeyed=1, skew_us={"frontend": 0.0, "search": -50.0},
                  conf_discount=0.6604),
}
# the port's CPU run of each leg (``--device cpu``, the same argv): its
# accuracy equals JAX's; the digest of its sink's service rows
# (:func:`sink_rows_digest`) is what the card's rows are held to where a
# leg meets ill-posed windows. The clean and skewed legs' CPU rows are
# the ground truth (100%); the lossy leg's three rows are kept whole
CAPTURE_PORT_CPU = {"clean": "dfbd7c440af57817817c347330b00dc4663a2031", "skew": "70baebcdad3eec918593c5ba01a576bac0a1c734", "lossy": "a592c2f344a3504c1f74d8e7520995e4822144b1"}
CAPTURE_LOSSY_CPU_ROWS = [[107624999, {"frontend": {"search": []}}], [107625000, {"frontend": {"search": [[["t0000", "frontend/7.0.1s"], ["t0000", "frontend/9.0.1c"]], [["t0001", "frontend/7.0.3s"], ["t0001", "frontend/9.0.3c"]], [["t0002", "frontend/7.0.5s"], ["Skip", "Skip"]]]}}], [107625002, {}]]
# adapt-burst: bench.py's shifted burst corpus through ``cli stream``
# with and without ``--adapt`` (1 s windows, no overlap, a 1 ms bound,
# drift window 64); 60 bursts, the shift at 30, 8 or 1024 requests a burst
ADAPT_ARGS = ["--window_s", "1", "--overlap_s", "0", "--watermark_s", "0.001",
              "--conf_drift_window", "64", "--checkpoint_every", "10000"]
ADAPT_CONFIGS = (("adapt-burst-60", 8), ("adapt-burst-60x1024", 1024))
ADAPT_SHIFT, ADAPT_TAIL = 30, 10
# JAX_PLATFORMS=cpu python tests/jax_reference_synth.py --config adapt-burst-60
# [--n_req 1024]; the port's CPU runs read the same windows. At 1024
# requests a burst JAX does not recover: the aliased assignment is as
# confident as the right one, so no PSI excursion and no refit
_DEGRADED = [1.0] * 30 + [0.0] * 30
ADAPT_JAX = {
    ("adapt-burst-60", False): dict(window_acc=_DEGRADED, drift_alerts=2, refits=0,
                                    fallbacks=0, final_psi=0.1304068447400635),
    ("adapt-burst-60", True): dict(window_acc=[1.0] * 30 + [0.0] * 15 + [1.0] * 15,
                                   drift_alerts=2, refits=1, fallbacks=0,
                                   final_psi=0.1304068447400635),
    ("adapt-burst-60x1024", False): dict(window_acc=_DEGRADED, drift_alerts=0, refits=0,
                                         fallbacks=0, final_psi=0.0),
    ("adapt-burst-60x1024", True): dict(window_acc=_DEGRADED, drift_alerts=0, refits=0,
                                        fallbacks=0, final_psi=0.0),
}
# discovery solves a service's every window in a few launches; the
# flagship's fleet blocks hold tens of windows
DISCOVERY_MIN_WINDOWS = 256
# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# CUDA C++ programming guide, arithmetic instruction throughput, compute
# capability 9.0: 16 exponentials (special-function unit) per clock per SM
EXP_PER_CLOCK_PER_SM = 16

HERE = os.path.dirname(os.path.abspath(__file__))
TOPK = 5
MIN_MASS = 1e-3


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def exp_rate() -> tuple:
    """Exponentials per second of card 0 at its maximum SM clock
    (``nvidia-smi clocks.max.sm``), and that clock in MHz."""
    import torch

    props = torch.cuda.get_device_properties(0)
    mhz = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--id=0", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True, text=True,
            timeout=30).stdout.strip()
        mhz = float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        khz = getattr(props, "clock_rate", None)
        mhz = khz / 1e3 if khz else None
    if not mhz:
        raise RuntimeError("cannot read the card's SM clock for the exp bound")
    return EXP_PER_CLOCK_PER_SM * props.multi_processor_count * mhz * 1e6, mhz


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, CUDA events, after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def random_blocks(rng, B, W, M, *, row_frac=0.75, col_frac=0.75,
                  all_masked_cols=False, cap_max=4, cap_zero=False,
                  empty_windows=0):
    """B OT blocks in the solver's layout ([W+1, M+1] with the dummy row
    and the skip column), as numpy: scores, row/col marginals, row and
    column validity, skip capacity. The last ``empty_windows`` blocks are
    the fleet's padding windows: no valid row or column, zero skip
    capacity, so every marginal is zero."""
    import numpy as np

    S = rng.normal(scale=5.0, size=(B, W + 1, M + 1)).astype(np.float32)
    in_v = rng.random((B, W)) < row_frac
    in_v[:, 0] = True
    o_v = np.zeros((B, M), bool) if all_masked_cols else rng.random((B, M)) < col_frac
    cap = rng.integers(0, cap_max, size=B).astype(np.float32)
    if empty_windows:
        in_v[B - empty_windows:] = False
        o_v[B - empty_windows:] = False
        cap[B - empty_windows:] = 0.0
    n_rows = in_v.sum(1).astype(np.float32)
    n_cols = o_v.sum(1).astype(np.float32)
    cap_e = np.maximum(cap, np.maximum(n_rows - n_cols, 0.0))
    if cap_zero:
        cap_e[:] = 0.0
    row_marg = np.concatenate(
        [in_v.astype(np.float32),
         np.maximum(n_cols + cap_e - n_rows, 0.0)[:, None]], 1).astype(np.float32)
    col_marg = np.concatenate([o_v.astype(np.float32), cap_e[:, None]], 1)
    col_valid = np.concatenate([o_v, (cap_e > 0)[:, None]], 1)
    rows_ok = np.concatenate([in_v, np.ones((B, 1), bool)], 1)
    S = np.where(rows_ok[:, :, None] & col_valid[:, None, :], S, -1.0e9)
    return dict(S=S.astype(np.float32), row_marg=row_marg,
                col_marg=col_marg.astype(np.float32), in_v=in_v,
                col_valid=col_valid, cap=cap_e.astype(np.float32), n_rows=W)


def to_cuda(block):
    import torch

    out = {k: torch.as_tensor(v).cuda() if not isinstance(v, int) else v
           for k, v in block.items()}
    return out


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def ill_posed_windows(S, row_marg, col_marg):
    """[B] bool: windows with a live row whose every live column is
    masked. The log-domain Sinkhorn lifts such a row's potential to about
    -NEG, which cancels the mask of its entries in f32 (f32 values near
    1e9 are 64 apart), so the window's plan is rounding noise and two
    correct implementations that round differently disagree there (the
    plain version in f32 and in f64 do too)."""
    from traceweaver_tpu_torch.ops.sinkhorn import NEG

    feas = (S > NEG / 2) & (col_marg > 0)[:, None, :]
    return ((row_marg > 0) & ~feas.any(dim=2)).any(dim=1)


def check_case(name, blk, tol, n_iters=40, early_exit=False, posed_only=False):
    """Hold K2, round_topk and K1 against their plain versions on one
    batch of blocks; returns the numbers of the comparison. With
    ``early_exit`` every block must stop before ``n_iters``. With
    ``posed_only`` (blocks captured from a path) the ill-posed windows
    (:func:`ill_posed_windows`) are counted and left out, so at least one
    window must remain."""
    import numpy as np
    import torch

    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops.compare import assign_diff_report, topk_diff_report
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    n_ill = 0
    if posed_only:
        bad = ill_posed_windows(blk["S"], blk["row_marg"], blk["col_marg"])
        n_ill = int(bad.sum())
        keep = (~bad).nonzero().flatten()
        if keep.numel() == 0:
            raise AssertionError(f"{name}: every window is ill-posed")
        if n_ill:
            blk = {k: v[keep] if torch.is_tensor(v) else v for k, v in blk.items()}
    S, rm, cm = blk["S"], blk["row_marg"], blk["col_marg"]
    in_v, cv, cap, W = blk["in_v"], blk["col_valid"], blk["cap"], blk["n_rows"]
    kw = dict(epsilon=1.0, n_iters=n_iters, tol=tol)

    plan_p = sinkhorn_log(S, rm, cm, **kw)
    plan_k, k2_iters = K.sinkhorn_cuda(S, rm, cm, return_iters=True, **kw)
    torch.cuda.synchronize()
    if early_exit and not bool((k2_iters < n_iters).all()):
        raise AssertionError(f"{name}: no early exit, iterations {k2_iters.tolist()}")
    plan_err = float((plan_k - plan_p).abs().max()) if plan_p.numel() else 0.0
    if not torch.allclose(plan_k, plan_p, atol=1e-5, rtol=1e-4):
        raise AssertionError(f"{name}: K2 plan differs from plain (max abs {plan_err})")

    rk = dict(topk=TOPK, min_topk_mass=MIN_MASS)
    pp = plan_p[:, :W].contiguous()
    a_r, tk_r = K.round_topk_cuda(pp, in_v, cv, cap, **rk)
    a_rp, tk_rp = K.round_topk_plain(pp, in_v, cv, cap, **rk)
    if not (torch.equal(a_r, a_rp) and torch.equal(tk_r, tk_rp)):
        raise AssertionError(f"{name}: round_topk_cuda differs from the plain rounding")

    a_k, tk_k, st_k = K.fused_assign_cuda(S, rm, cm, cap, W, min_topk_mass=MIN_MASS,
                                          topk=TOPK, return_stats=True, **kw)
    if not torch.equal(st_k[:, 0], k2_iters):
        raise AssertionError(f"{name}: K1 and K2 ran different iterations")
    # K1 = K2's plan rounded by the same device code, bit for bit
    a_kk, tk_kk = K.round_topk_cuda(plan_k[:, :W].contiguous(), in_v, cv, cap, **rk)
    if not (torch.equal(a_k, a_kk) and torch.equal(tk_k, tk_kk)):
        raise AssertionError(f"{name}: fused kernel differs from K2 plan + rounding")
    a_p, tk_p = K.assign_topk_plain(S, rm, cm, in_v, cv, cap, W, topk=TOPK,
                                    min_topk_mass=MIN_MASS, **kw)

    valid = in_v.cpu().numpy()
    a_k_n, a_p_n = a_k.cpu().numpy(), a_p.cpu().numpy()
    plan_n = pp.cpu().numpy()
    st = assign_diff_report(a_k_n, a_p_n, plan_n)
    masked = np.where(cv.cpu().numpy()[:, None, :], plan_n, -1.0e9)
    tk_differ, tk_bad = topk_diff_report(tk_k.cpu().numpy(), tk_p.cpu().numpy(),
                                         masked, MIN_MASS)
    rows = int(valid.size)
    agree = 1.0 - (st["differ"] + tk_differ) / max(rows, 1)
    err = 0.0
    if st["differ"]:
        idx = np.argwhere(a_k_n != a_p_n)
        for b, i in idx:
            mk = plan_n[b, i, a_k_n[b, i]] if a_k_n[b, i] >= 0 else 0.0
            mp = plan_n[b, i, a_p_n[b, i]] if a_p_n[b, i] >= 0 else 0.0
            err = max(err, abs(float(mk) - float(mp)))
    B, R, C = S.shape
    line = dict(case=name, shape=[B, R, C], dtype=str(S.dtype).split(".")[-1],
                ill_posed_windows_left_out=n_ill, tol=tol, n_iters=n_iters,
                cluster=K.card_plan(B, R, C, S.device, S.element_size()).cluster,
                sinkhorn_iters=k2_iters.tolist() if B <= 8 else int(k2_iters.sum()),
                plan_max_abs_err=plan_err,
                k1_rows=rows, k1_assign_differ=st["differ"],
                k1_row_ties=st["row_tie"], k1_contention=st["contention"],
                k1_topk_differ=tk_differ, k1_agreement=agree)
    print("kernel-check " + json.dumps(line), flush=True)
    if agree < 0.999 or st["unexplained"] or tk_bad:
        raise AssertionError(f"{name}: fused kernel vs plain: {line}, "
                             f"unexplained assign rows {st['unexplained']}, "
                             f"unexplained top-k rows {tk_bad}")
    return dict(plan_err=plan_err, k1_err=err)


def kernel_phase(real_block, fleet_block, executor_blocks, bf16_blocks):
    import numpy as np

    rng = np.random.default_rng(0)
    cases = [
        ("main-shape", random_blocks(rng, 8, 1024, 2048), 1e-3),
        ("main-shape-tol0", random_blocks(rng, 2, 1024, 2048), 0.0),
        ("ragged", random_blocks(rng, 3, 36, 52), 1e-3),
        ("ragged-tol0", random_blocks(rng, 3, 36, 52), 0.0),
        ("all-masked", random_blocks(rng, 2, 9, 12, all_masked_cols=True), 0.0),
        ("all-masked-cap0", random_blocks(rng, 2, 9, 12, all_masked_cols=True,
                                          cap_zero=True), 0.0),
        ("padded-rows", random_blocks(rng, 4, 64, 128, row_frac=0.4), 1e-3),
        ("skip-heavy", random_blocks(rng, 4, 64, 16, col_frac=1.0, cap_max=40), 1e-3),
        # the cluster decomposition's edges
        ("rows-not-multiple", random_blocks(rng, 4, 100, 300), 1e-3),
        ("rows-below-cluster", random_blocks(rng, 3, 4, 20), 0.0),
        ("one-window", random_blocks(rng, 1, 1024, 2048), 1e-3),
        ("many-windows", random_blocks(rng, 40, 256, 512), 1e-3),
        ("tiles-of-4", random_blocks(rng, 2, 1024, 4096), 1e-3),
        ("tiles-of-1", random_blocks(rng, 1, 512, 8192), 1e-3),
        ("padding-windows", random_blocks(rng, 8, 64, 128, empty_windows=3), 1e-3),
    ]
    worst = dict(plan_err=0.0, k1_err=0.0)
    runs = [(name, blk, tol, {}) for name, blk, tol in cases]
    runs.append(("early-exit", random_blocks(rng, 3, 100, 200), 1e-2,
                 dict(n_iters=200, early_exit=True)))
    for name, blk, tol, extra in runs:
        r = check_case(name, to_cuda(blk), tol, **extra)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    for name, blk in (("slice-block", real_block), ("fleet-block", fleet_block)):
        r = check_case(name, blk, 1e-3)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    # the bf16 kernels on the bf16 path's blocks, against the plain bf16
    # versions (the same values read, so the f32 rule holds)
    worst_bf16 = dict(plan_err=0.0, k1_err=0.0)
    for name, blk in bf16_blocks.items():
        r = check_case(name, blk, 1e-3)
        for k in worst_bf16:
            worst_bf16[k] = max(worst_bf16[k], r[k])
    # the Alibaba corpus has windows where an incoming span has no
    # feasible child and no skip room: their plans are rounding noise
    for name, blk in executor_blocks.items():
        r = check_case(name, blk, 1e-3, posed_only=True)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    two_streams_check(real_block, fleet_block)
    return worst, worst_bf16


def two_streams_check(slice_blk, fleet_blk):
    """K1 and K2 launched from two host threads, each on a CUDA stream
    of its own, at once: thread 0 alternates the slice block with a
    small block, thread 1 the fleet block with a block of a third shape,
    so the two threads' launches need different shared-memory limits.
    Each output must equal the same launch made alone on the default
    stream, bit for bit. Events on both streams, timed from one event on
    the default stream, give the span in which both had kernels queued."""
    import numpy as np
    import torch

    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    kw = dict(epsilon=1.0, n_iters=40, tol=1e-3)
    rng = np.random.default_rng(1)
    blocks = {"slice": slice_blk, "fleet": fleet_blk,
              "small": to_cuda(random_blocks(rng, 3, 36, 52)),
              "mid": to_cuda(random_blocks(rng, 4, 100, 300))}
    kernels = {
        "k1": lambda b: K.fused_assign_cuda(b["S"], b["row_marg"], b["col_marg"], b["cap"],
                                            b["n_rows"], topk=TOPK, min_topk_mass=MIN_MASS,
                                            **kw),
        "k2": lambda b: (K.sinkhorn_cuda(b["S"], b["row_marg"], b["col_marg"], **kw),)}
    jobs = [[("k1", "slice"), ("k2", "small"), ("k2", "slice"), ("k1", "small")] * 3,
            [("k2", "fleet"), ("k1", "mid"), ("k1", "fleet"), ("k2", "mid")] * 3]
    alone = {job: kernels[job[0]](blocks[job[1]]) for stream_jobs in jobs
             for job in stream_jobs}
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    origin = torch.cuda.Event(enable_timing=True)
    origin.record()
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    barrier, got, spans, errors = threading.Barrier(2), [[], []], {}, []

    def worker(i):
        try:
            with torch.cuda.stream(streams[i]):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                barrier.wait(timeout=60)
                t0.record()
                for kernel, block in jobs[i]:
                    got[i].append(kernels[kernel](blocks[block]))
                t1.record()
                spans[i] = (t0, t1)
        except Exception as e:  # noqa: BLE001 — re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"two-streams launch failed: {errors}")
    torch.cuda.synchronize()
    differ = [f"{i}:{n}:{job[0]}-{job[1]}" for i in range(2)
              for n, (job, out) in enumerate(zip(jobs[i], got[i]))
              if not all(torch.equal(a, g) for a, g in zip(alone[job], out))]
    ms = [(origin.elapsed_time(t0), origin.elapsed_time(t1)) for t0, t1 in
          (spans[0], spans[1])]
    line = dict(case="two-streams", shapes={k: list(b["S"].shape) for k, b in blocks.items()},
                launches=sum(map(len, jobs)), bit_equal=not differ, differ=differ,
                stream_ms=ms,
                overlap_ms=max(0.0, min(ms[0][1], ms[1][1]) - max(ms[0][0], ms[1][0])))
    print("kernel-check " + json.dumps(line), flush=True)
    if differ:
        raise AssertionError(f"two-streams launches differ from single-stream ones: {differ}")


def kernel_timing(blk, tol=1e-3, n_iters=40):
    """Times and bounds of K1 and K2 at one main-path block."""
    import torch

    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    S, rm, cm = blk["S"], blk["row_marg"], blk["col_marg"]
    in_v, cv, cap, W = blk["in_v"], blk["col_valid"], blk["cap"], blk["n_rows"]
    B, R, C = S.shape
    kw = dict(epsilon=1.0, n_iters=n_iters, tol=tol)
    _, _, stats = K.fused_assign_cuda(S, rm, cm, cap, W, topk=TOPK,
                                      min_topk_mass=MIN_MASS, return_stats=True, **kw)
    _, k2_iters = K.sinkhorn_cuda(S, rm, cm, return_iters=True, **kw)
    item = S.element_size()
    plan = K.card_plan(B, R, C, S.device, item)
    iters = int(stats[:, 0].sum())
    k2_it = int(k2_iters.sum())
    rounds = int(stats[:, 1].sum())
    cells = R * C
    # f32 operations these inputs need besides the exponentials: per
    # Sinkhorn iteration and element a multiply, two adds, a max and an
    # accumulate in each of the row and column passes (10); forming the
    # plan once (6); per rounding round one compare per element of the
    # row and the column argmax (2 x rows x C); k compares per element
    # for the top-k peel
    sink_ops = 10.0 * iters * cells
    plan_ops = 6.0 * B * cells
    k1_ops = sink_ops + plan_ops + 2.0 * rounds * W * C + TOPK * B * W * C
    k2_ops = 10.0 * k2_it * cells + plan_ops
    # exponentials: one per element in each half-iteration, one per
    # element to form the plan once (the rounding can read that plan)
    k1_exps = 2.0 * iters * cells + B * cells
    k2_exps = 2.0 * k2_it * cells + B * cells
    in_bytes = item * B * cells + 4.0 * (B * R + B * C)
    k1_bytes = in_bytes + 4.0 * B + 4.0 * B * W * (1 + TOPK)
    k2_bytes = in_bytes + 4.0 * B * cells
    rate, mhz = exp_rate()

    def bound(nbytes, ops, exps):
        terms = dict(bytes=1e3 * nbytes / PEAK_BYTES_PER_S,
                     f32=1e3 * ops / PEAK_F32_OPS_PER_S,
                     exp=1e3 * exps / rate)
        term = max(terms, key=terms.get)
        return terms[term], ("bytes" if term == "bytes" else "operations"), term, terms

    k1_bound, k1_by, k1_term, k1_terms = bound(k1_bytes, k1_ops, k1_exps)
    k2_bound, k2_by, k2_term, k2_terms = bound(k2_bytes, k2_ops, k2_exps)
    reps = 5
    k1_ms = cuda_ms(lambda: K.fused_assign_cuda(S, rm, cm, cap, W, topk=TOPK,
                                                min_topk_mass=MIN_MASS, **kw), reps)
    k1_plain = cuda_ms(lambda: K.assign_topk_plain(S, rm, cm, in_v, cv, cap, W, topk=TOPK,
                                                   min_topk_mass=MIN_MASS, **kw), reps)
    k2_ms = cuda_ms(lambda: K.sinkhorn_cuda(S, rm, cm, **kw), reps)
    k2_plain = cuda_ms(lambda: sinkhorn_log(S, rm, cm, **kw), reps)
    detail = dict(shape=[B, R, C], dtype=str(S.dtype).split(".")[-1],
                  cluster=plan.cluster, rows_per_cta=plan.rows_per_cta,
                  tile_rows=plan.tile_rows,
                  smem_bytes=plan.smem_bytes, sinkhorn_iters=iters,
                  rounding_rounds=rounds, k2_sinkhorn_iters=k2_it,
                  exp_per_s=rate, sm_clock_mhz=mhz,
                  fused_assign_bound_terms_ms=k1_terms, fused_assign_bound_term=k1_term,
                  sinkhorn_bound_terms_ms=k2_terms, sinkhorn_bound_term=k2_term)
    print("kernel-timing " + json.dumps(detail), flush=True)
    return dict(
        fused_assign=dict(ms=k1_ms, plain_ms=k1_plain, bound_ms=k1_bound, bound_by=k1_by),
        sinkhorn=dict(ms=k2_ms, plain_ms=k2_plain, bound_ms=k2_bound, bound_by=k2_by))


# ---------------------------------------------------------------------------
# the block assembly
# ---------------------------------------------------------------------------

#: f32 tolerance of the assembly kernel against its plain version (bf16:
#: one bf16 ulp of the plain entry)
ASSEMBLY_TOL = dict(atol=1e-4, rtol=1e-5)
#: captured calls of one chain: its forward sweep and its first backward
#: sweep (three endpoints each in both configs' chains)
ASSEMBLY_CALLS = 6


@contextlib.contextmanager
def assembly_capture(kept, rows, cols, min_windows, n_calls=ASSEMBLY_CALLS):
    """The solver's ``assemble_block`` keeping the arguments of its first
    ``n_calls`` calls on one thread for [>= ``min_windows``, rows, cols]
    windows of one window count (not the GEMM form): the first sweeps of
    one chain, forward then backward."""
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt

    real, lock, owner = wt.assemble_block, threading.Lock(), []

    def keep(*args, precision="f32", gemm=False):
        B, n = args[4].shape
        with lock:
            if (len(kept) < n_calls and not gemm and n == rows
                    and args[7].shape[1] == cols and B >= min_windows
                    and (not owner or owner[0] == (threading.get_ident(), B))):
                owner[:] = [(threading.get_ident(), B)]
                kept.append(args)
        return real(*args, precision=precision, gemm=gemm)

    wt.assemble_block = keep
    try:
        yield kept
    finally:
        wt.assemble_block = real


@contextlib.contextmanager
def plain_assembly():
    """The assembly's plain version on the card too: the peak-memory and
    wall A/B."""
    from traceweaver_tpu_torch.ops import scores as SC

    real = SC.assemble_block_cuda

    def plain(*args, precision="f32"):
        return SC.assemble_block_plain(*args, precision=precision)

    SC.assemble_block_cuda = plain
    try:
        yield
    finally:
        SC.assemble_block_cuda = real


def _sweep_of(args) -> str:
    return "forward" if args[11] is None else "backward"


def _tolerance(want, precision):
    """Per-entry tolerance of an assembled block: 1e-5 relative plus 1e-4
    absolute at f32; one bf16 ulp of the plain entry at bf16."""
    import torch

    if precision == "bf16":
        _, e = torch.frexp(want)
        return torch.ldexp(torch.ones_like(want), e - 8)
    return ASSEMBLY_TOL["atol"] + ASSEMBLY_TOL["rtol"] * want.abs()


def block_diff(got, want, precision):
    """Kernel output ``got`` against the plain ``want`` (each ``(S_ot,
    feas_count, argmax)``): the S_ot entries that differ and those beyond
    the tolerance, their largest difference, the rows whose feasible
    count differs, and the rows whose argmax differs where the plain row's
    two largest entries are further apart than the tolerance and where
    they are not (a near tie)."""
    import torch

    S, S0 = got[0].float(), want[0].float()
    same = (S == S0) | (torch.isnan(S) & torch.isnan(S0))
    tol = _tolerance(S0, precision)
    beyond = ~same & ~((S - S0).abs() <= tol)
    both = ~same & torch.isfinite(S) & torch.isfinite(S0)
    W = want[1].shape[1]
    top2 = torch.topk(S0[:, :W], 2, dim=2).values
    clear = (top2[..., 0] - top2[..., 1]) > _tolerance(top2[..., 0], precision)
    arg = got[2] != want[2]
    return dict(entries=S.numel(), entries_differ=int((~same).sum()),
                entries_beyond_tolerance=int(beyond.sum()),
                max_abs_diff=float((S - S0)[both].abs().max()) if bool(both.any()) else 0.0,
                feas_count_differ=int((got[1] != want[1]).sum()),
                argmax_differ=int((arg & clear).sum()),
                argmax_differ_near_ties=int((arg & ~clear).sum()))


def assembly_check(name, calls):
    """The assembly kernel against its plain version on every captured
    call (forward and backward sweeps), at f32 and bf16: ``feas_count``
    exactly, the argmax exactly where a row's two largest entries are
    further apart than the tolerance, ``S_ot`` within the tolerance
    (:func:`_tolerance`); prints one ``score-check`` line per score type
    with the entries that differ. Returns the largest difference."""
    from traceweaver_tpu_torch.ops import scores as SC

    worst = 0.0
    for precision in ("f32", "bf16"):
        sums, sweeps = {}, {}
        for args in calls:
            d = block_diff(SC.assemble_block_cuda(*args, precision=precision),
                           SC.assemble_block_plain(*args, precision=precision), precision)
            for k, v in d.items():
                sums[k] = max(sums.get(k, 0.0), v) if k == "max_abs_diff" else sums.get(k, 0) + v
            sweeps[_sweep_of(args)] = sweeps.get(_sweep_of(args), 0) + 1
        B, W = calls[0][4].shape
        line = dict(case=name, precision=precision, shape=[B, W + 1, calls[0][7].shape[1] + 1],
                    calls=len(calls), sweeps=sweeps, **sums,
                    tolerance=("one bf16 ulp" if precision == "bf16"
                               else "1e-5 relative + 1e-4 absolute"))
        print("score-check " + json.dumps(line), flush=True)
        if (sums["entries_beyond_tolerance"] or sums["feas_count_differ"]
                or sums["argmax_differ"] or set(sweeps) != {"forward", "backward"}):
            raise AssertionError(f"{name} ({precision}): the assembly kernel parts from "
                                 f"its plain version: {line}")
        worst = max(worst, sums["max_abs_diff"])
    return worst


def device_ms(fn, reps: int, mhz: float) -> float:
    """The card's ms per ``fn()`` over ``reps`` calls, CUDA events, after
    a warm-up call: the calls are queued behind a spin kernel of 20 ms,
    so the card runs them back to back even where the host enqueues them
    slower than the card runs them (events around calls enqueued live
    would time the host)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(20e-3 * mhz * 1e6))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ops(fn) -> int:
    """The card's operations (kernels, copies, sets) of one ``fn()`` from
    a profiler trace, after a warm-up call. A trace may drop the last
    records before it stops, so spin kernels pad its tail; they are not
    counted."""
    import torch

    from traceweaver_tpu_torch.obs import profile as P

    fn()
    torch.cuda.synchronize()
    with P.trace() as prof:
        fn()
        for _ in range(64):
            torch.cuda._sleep(20000)
        torch.cuda.synchronize()
    return sum(1 for name, _, _ in P.trace_intervals(prof)[0] if "spin_kernel" not in name)


def assembly_bound(calls, precision, rate):
    """The least time for the assembly of ``calls`` on this card: the
    largest of the bytes (``S_ot`` written once in its type, feasible
    counts and argmax, every input read once) at the HBM rate, the f32
    operations at 67 TFLOP/s and the special functions (K exponentials
    and one logarithm per active pair and term) at ``rate``. Counted from
    this run's data: a term is active on a pair that is feasible, in a
    window where the term is active, on a row it does not mask; the
    plain formula costs 10 operations a live component (delay less mean,
    quotient, scale, FMA as 2, less log sqrt(2 pi), plus log w, max, less
    max, sum) and 3 a term (delay, plus max, group sum); a feasible pair
    4 more (the group sums and the row max), every pair 7 (feasibility
    and argmax) and at bf16 2 (centring)."""
    from traceweaver_tpu_torch.ops import scores as SC

    item = 2 if precision == "bf16" else 4
    nbytes = ops = sfu = 0.0
    for args in calls:
        root, preds, succs, ret, in_s, _, _, o_s, _, _, _, t_succ, _ = args
        B, W = in_s.shape
        M = o_s.shape[1]
        feas = SC.assemble_block_cuda(*args, precision=precision)[1].double()  # [B, W]
        nbytes += item * B * (W + 1) * (M + 1) + 8.0 * B * W
        nbytes += B * W * (4.0 * (3 + (t_succ is not None)) + 2) + B * M * 9.0
        ops += B * W * (M + 1) * (7.0 + 2.0 * (item == 2)) + 4.0 * float(feas.sum())
        for t in (root, *preds, *succs, ret):
            K = t.wt.shape[1]
            nbytes += B * (4.0 * W + 12.0 * K + 1 + (W if t.row_ok is not None else 0))
            on = t.active[:, None] if t.row_ok is None else t.active[:, None] & t.row_ok
            pairs = (feas * on).sum(dim=1)                       # [B]
            k = (t.wt > 0).sum(dim=1).double()
            sfu += float((pairs * (k + 1.0)).sum())
            ops += float((pairs * (10.0 * k + 3.0)).sum())
    terms = dict(bytes=1e3 * nbytes / PEAK_BYTES_PER_S, f32=1e3 * ops / PEAK_F32_OPS_PER_S,
                 sfu=1e3 * sfu / rate)
    return terms, dict(bytes=nbytes, f32_ops=ops, sfu_ops=sfu)


def assembly_timing(name, calls, card):
    """The ms of one sweep's assembly, forward and backward, with the
    kernel and with the plain version, at f32 and bf16: the card's time
    (``ms``, ``plain_ms``; :func:`device_ms`) and, for the kernel, the
    CUDA-event time of calls enqueued live, the host's enqueueing
    included (``stream_ms``); the bound of each (:func:`assembly_bound`,
    the term that binds it named); the launches of a sweep and the
    card's operations of one endpoint step, kernel and plain
    (:func:`device_ops`). Prints one ``score-build`` line per score
    type; returns them by type."""
    from traceweaver_tpu_torch.ops import scores as SC

    rate, mhz = exp_rate()
    out = {}
    for precision in ("f32", "bf16"):
        line = dict(case=name, precision=precision)
        for sweep in ("forward", "backward"):
            part = [a for a in calls if _sweep_of(a) == sweep]

            def kernel():
                return [SC.assemble_block_cuda(*a, precision=precision) for a in part]

            def plain():
                return [SC.assemble_block_plain(*a, precision=precision) for a in part]

            SC.reset_launches()
            kernel()
            launches = SC.LAUNCHES["assemble_block"]
            terms, counts = assembly_bound(part, precision, rate)
            term = max(terms, key=terms.get)
            line[sweep] = dict(endpoints=len(part), launches_per_sweep=launches,
                               ms=device_ms(kernel, 5, mhz), plain_ms=device_ms(plain, 2, mhz),
                               stream_ms=cuda_ms(kernel, 5), bound_ms=terms[term],
                               bound_by="bytes" if term == "bytes" else "operations",
                               bound_term=term, bound_terms_ms=terms, **counts)
        a = calls[0]
        ops = dict(kernel=device_ops(lambda: SC.assemble_block_cuda(*a, precision=precision)),
                   plain=device_ops(lambda: SC.assemble_block_plain(*a, precision=precision)))
        if ops["kernel"] < 1:  # the trace lost the call: not measured
            ops["kernel"] = None
        B, W = a[4].shape
        feas = float(SC.assemble_block_cuda(*a, precision=precision)[1].sum())
        line.update(shape=[B, W + 1, a[7].shape[1] + 1],
                    feasible_share=feas / (B * W * a[7].shape[1]),
                    device_ops_per_endpoint_step=ops, sm_clock_mhz=mhz, card=card)
        print("score-build " + json.dumps(line), flush=True)
        out[precision] = line
    return out


ASSEMBLY_PHASES = ("staging", "row_setup", "pass1_feasibility", "pass2_mixture",
                   "reductions_argmax", "pass3_store")


def assembly_phases(calls_by_case, card):
    """Where the assembly kernel's warps spend their cycles: builds
    ``csrc/scores.cu`` with ``-DTWA_PHASE_CLOCKS`` (each warp adds its
    clock cycles by phase into a device array) into the build directory,
    runs one forward sweep of each case at f32 and bf16 through it, and
    prints one ``score-build-phases`` line per case and type with each
    phase's share of the summed warp cycles."""
    import ctypes

    import torch

    from traceweaver_tpu_torch.ops import cuda_build
    from traceweaver_tpu_torch.ops import scores as SC

    lib_path = os.path.join(cuda_build.BUILD_DIR, "libtw_scores_phase_clocks.so")
    subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-DTWA_PHASE_CLOCKS", "-o",
                    lib_path, os.path.join(cuda_build.CSRC_DIR, "scores.cu")], check=True)
    real_build = SC.build
    SC.build, SC._LIB = (lambda verbose=False: lib_path), None
    try:
        lib = SC._lib()
        lib.tw_assemble_phase_clocks.argtypes = [ctypes.c_void_p]
        clocks = (ctypes.c_ulonglong * len(ASSEMBLY_PHASES))()
        for name, calls in calls_by_case.items():
            for precision in ("f32", "bf16"):
                lib.tw_assemble_phase_clocks(clocks)  # zeroes them
                for a in calls:
                    if _sweep_of(a) == "forward":
                        SC.assemble_block_cuda(*a, precision=precision)
                torch.cuda.synchronize()
                if lib.tw_assemble_phase_clocks(clocks) != 0:
                    raise RuntimeError("reading the phase clocks failed")
                total = float(sum(clocks))
                print("score-build-phases " + json.dumps(dict(
                    case=name, precision=precision, warp_cycles=total,
                    share={ph: c / total for ph, c in zip(ASSEMBLY_PHASES, clocks)},
                    card=card)), flush=True)
    finally:
        SC.build, SC._LIB = real_build, None


def assembly_only(card):
    """``--assembly``: one fused ``FindAssignments`` of ``synth-async-8k``
    and one ``solve_fleet`` of ``synth-fleet-8svc`` keeping their first
    sweeps' assembly calls, then :func:`assembly_check`,
    :func:`assembly_timing` and :func:`assembly_phases` on both."""
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k, synth_fleet_8svc

    slice_calls, fleet_calls = [], []
    with assembly_capture(slice_calls, 1024, 2048, 8):
        run_slice(synth_async_8k(), True)
    with assembly_capture(fleet_calls, 1024, 2048, 32):
        run_fleet(synth_fleet_8svc(), True)
    for name, calls in (("slice-score-build", slice_calls),
                        ("fleet-score-build", fleet_calls)):
        if len(calls) != ASSEMBLY_CALLS:
            raise AssertionError(f"{name}: kept {len(calls)} assembly calls")
        assembly_check(name, calls)
        assembly_timing(name, calls, card)
    assembly_phases({"slice-score-build": slice_calls, "fleet-score-build": fleet_calls},
                    card)


# ---------------------------------------------------------------------------
# slice
# ---------------------------------------------------------------------------

def run_slice(prob, fused: bool, device="cuda", **solver_kw):
    """``FindAssignments`` of one service (``solver_kw``: more
    ``WeaverTorch`` keywords, ``precision``, ``score_gemm``)."""
    import torch

    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service

    algo = WeaverTorch({}, {}, fused_kernel=fused, device=device, **solver_kw)
    base = 0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = algo.FindAssignments(
        "MaxScoreBatchSubsetWithSkips", prob["service"], prob["in_parts"],
        prob["out_parts"], False, [], prob["truth"], prob["dag"])
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    in_ids = [s.GetId() for s in next(iter(prob["in_parts"].values()))]
    for ep, amap in out[0].items():
        missing = [i for i in in_ids if i not in amap]
        if missing or any(len(out[1][ep][i]) > TOPK for i in in_ids):
            raise AssertionError(f"{ep}: {len(missing)} spans without an assignment "
                                 "or an over-long top-k list")
    acc = accuracy_for_service(out[0], prob["truth"], prob["in_parts"])
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else 0
    return out, acc, wall, peak, algo.stats


KERNEL_OF = {True: ("fused_assign", "fused_assign_cuda"),
             False: ("sinkhorn", "sinkhorn_cuda")}


def drive(run, fused: bool, captured=None, want=lambda S: True, largest=False,
          ill=None, counts=None):
    """Call ``run()`` with the path's kernel wrapper timed by CUDA events
    around each launch (on the launching thread's current stream) and,
    when ``captured`` is a dict, ``assign_topk`` keeping the first block
    ``want`` accepts (with ``largest``, the one of most elements, the
    first of them; a block already in ``captured`` competes too); when
    ``ill`` is a dict, ``assign_topk`` also counts every block's windows
    and ill-posed windows (:func:`ill_posed_windows`) into it: the
    latter as a device sum per block, read once after ``run()``, so the
    count adds no host sync to the timed call. Every
    launch counter is reset just before and read just after (all of
    them, the assembly kernel's too, into ``counts`` when it is a
    dict, with ``plain_assembly_on_card``: the calls of the assembly's
    plain version on CUDA tensors, not the GEMM form). Returns
    ``run()``'s result, the path kernel's launches, the other kernel's
    and the summed kernel device ms (summed over streams: under the
    pipelined fleet flow launches overlap)."""
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops import scores as SC

    key, wrapper = KERNEL_OF[fused]
    real_wrapper, real_assign_topk, events = getattr(K, wrapper), wt.assign_topk, []
    real_plain, plain_on_card = SC.assemble_block_plain, [0]
    lock, ill_sums = threading.Lock(), []
    if ill is not None:
        ill.update(ill_posed_windows=0, windows=0)

    def timed(*args, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real_wrapper(*args, **kw)
        t1.record()
        events.append((t0, t1))
        return out

    def recording(*args, **kw):
        n_ill = ill_posed_windows(*args[:3]).sum() if ill is not None else None
        # flow workers launch from several threads: check and set at once
        with lock:
            if ill is not None:
                ill_sums.append(n_ill)
                ill["windows"] += args[0].shape[0]
            held = captured.get("block") if captured is not None else None
            if captured is not None and want(args[0]) and (
                    held is None or largest and args[0].numel() > held["S"].numel()):
                S, rm, cm, in_v, cv, cap, W = args
                captured["block"] = dict(S=S, row_marg=rm, col_marg=cm, in_v=in_v,
                                         col_valid=cv, cap=cap, n_rows=W)
        return real_assign_topk(*args, **kw)

    def plain(*args, gemm=False, **kw):
        if args[4].is_cuda and not gemm:
            with lock:
                plain_on_card[0] += 1
        return real_plain(*args, gemm=gemm, **kw)

    if captured is not None or ill is not None:
        wt.assign_topk = recording
    setattr(K, wrapper, timed)
    SC.assemble_block_plain = plain
    try:
        K.reset_launches()
        SC.reset_launches()
        out = run()
        if ill_sums:
            torch.cuda.synchronize()  # the sums lie on the workers' streams
            ill["ill_posed_windows"] = int(torch.stack(ill_sums).sum())
        launches = K.LAUNCHES[key]
        other = K.LAUNCHES[KERNEL_OF[not fused][0]]
        if counts is not None:
            counts.update(K.LAUNCHES, **SC.LAUNCHES, plain_assembly_on_card=plain_on_card[0])
    finally:
        wt.assign_topk = real_assign_topk
        setattr(K, wrapper, real_wrapper)
        SC.assemble_block_plain = real_plain
    return out, launches, other, sum(t0.elapsed_time(t1) for t0, t1 in events)


def check_assembly(what, counts) -> None:
    """Fail a main-path run that launched no assembly kernel or called
    the assembly's plain version on the card (``counts`` from
    :func:`drive`)."""
    if counts["assemble_block"] <= 0:
        raise AssertionError(f"{what}: the main path launched no assembly kernel")
    if counts["plain_assembly_on_card"]:
        raise AssertionError(f"{what}: the assembly's plain version ran on the card "
                             f"{counts['plain_assembly_on_card']} times")


def slice_phase(card):
    """The slice phase (see the module docstring). Returns the launches,
    K1's block, two sweeps' assembly calls (captured, and A/B'd against the
    plain build) and the fused run's peak memory."""
    import torch

    from traceweaver_tpu_torch.metrics.synth import synth_async_8k

    # reference on a small input: the same cut on the card and on the CPU
    small = synth_async_8k(256)
    on_card = run_slice(small, True)[0][0]
    on_cpu = run_slice(small, True, device="cpu")[0][0]
    same = agreement(on_card, on_cpu)
    print(f"slice-small: 256 requests, card vs CPU identical pairs {same:.6f}", flush=True)
    if same < 0.99:
        raise AssertionError(f"card and CPU assignments agree on {same} < 0.99 of pairs")

    prob = synth_async_8k()
    launches, captured, sweep, lines = {}, {}, [], {}
    for fused in (True, False):
        key = KERNEL_OF[fused][0]
        counts = {}
        capture = (assembly_capture(sweep, 1024, 2048, 8) if fused
                   else contextlib.nullcontext())
        with capture:
            (_, acc, wall, peak, stats), launches[key], other, kernel_ms = drive(
                lambda: run_slice(prob, fused), fused, captured if fused else None,
                counts=counts)
        line = dict(config="synth-async-8k", fused_kernel=fused, accuracy=acc,
                    wall_s=wall, kernel=key, kernel_ms=kernel_ms,
                    kernel_share=kernel_ms / 1e3 / wall,
                    peak_mem_bytes=peak, launches=launches[key],
                    other_kernel_launches=other,
                    assembly_launches=counts["assemble_block"],
                    plain_assembly_on_card=counts["plain_assembly_on_card"],
                    fused_em_applied=stats.get("fused_em_applied", 0.0), card=card)
        print("slice " + json.dumps(line), flush=True)
        lines[fused] = line
        if launches[key] <= 0:
            raise AssertionError(f"main path (fused={fused}) launched no {key} kernel")
        check_assembly(f"slice (fused={fused})", counts)
        if acc < ACCURACY_FLOOR:
            raise AssertionError(f"accuracy {acc} < {ACCURACY_FLOOR} (fused={fused})")
    launches["assemble_block"] = lines[True]["assembly_launches"]
    with plain_assembly():
        (_, acc, wall, peak, _), _, _, _ = drive(lambda: run_slice(prob, True), True)
    print("slice-score-build " + json.dumps(dict(
        config="synth-async-8k", fused_kernel=True,
        peak_mem_bytes={"kernel": lines[True]["peak_mem_bytes"], "plain": peak},
        wall_s={"kernel": lines[True]["wall_s"], "plain": wall},
        accuracy={"kernel": lines[True]["accuracy"], "plain": acc},
        card=card)), flush=True)
    if len(sweep) != ASSEMBLY_CALLS:
        raise AssertionError(f"kept {len(sweep)} assembly calls of the slice's sweeps")
    torch.cuda.synchronize()
    return launches, captured["block"], sweep, lines[True]["peak_mem_bytes"]


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

def agreement(got, ref) -> float:
    """Share of ``ref``'s (endpoint, span) pairs that ``got`` assigns alike
    (``ops/compare.pair_agreement``, kept here so that ``--slice-root`` runs
    checkouts from before it)."""
    pairs = [(ep, i) for ep in ref for i in ref[ep]]
    if not pairs:
        return 1.0
    return sum(got.get(ep, {}).get(i) == ref[ep][i] for ep, i in pairs) / len(pairs)


def run_fleet(probs, fused: bool, device="cuda", **kw):
    """``solve_fleet`` over the services (``kw``: more of its keywords);
    returns the results, each service's accuracy, wall seconds, peak
    device bytes, the stats ledger and the quarantine list."""
    import torch

    from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet
    from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service

    items = [FleetItem(p["service"], p["in_parts"], p["out_parts"], p["truth"],
                       p["dag"]) for p in probs]
    stats, quarantined = {}, []
    base = 0
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    out = solve_fleet(items, stats=stats, quarantined=quarantined, device=device,
                      fused_kernel=fused, **kw)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    acc = {}
    for p, res in zip(probs, out):
        in_ids = [s.GetId() for s in next(iter(p["in_parts"].values()))]
        if res is None or len(res) != 6 or any(
                i not in amap for amap in res[0].values() for i in in_ids):
            raise AssertionError(f"{p['service']}: no complete FindAssignments result")
        acc[p["service"]] = accuracy_for_service(res[0], p["truth"], p["in_parts"])
    peak = torch.cuda.max_memory_allocated() - base if device == "cuda" else 0
    return out, acc, wall, peak, stats, quarantined


def fleet_phase(card):
    """The fleet phase (see the module docstring). Returns each kernel's
    launches on the full config, the first score block of the chain
    group, the config's services, the wall of its pipelined K1 run, one
    two sweeps' assembly calls of the chain group and that run's peak
    memory."""
    import torch

    from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc

    small = synth_fleet_8svc(FLEET_SMALL)
    on_card = run_fleet(small, True)[0]
    on_cpu = run_fleet(small, True, device="cpu")[0]
    per_service = [run_slice(p, True)[0] for p in small]
    vs_cpu = {p["service"]: agreement(c[0], h[0])
              for p, c, h in zip(small, on_card, on_cpu)}
    vs_service = {p["service"]: agreement(c[0], s[0])
                  for p, c, s in zip(small, on_card, per_service)}
    print("fleet-small " + json.dumps(dict(
        config="synth-fleet-8svc", requests_per_service=FLEET_SMALL,
        card_vs_cpu=vs_cpu, card_fleet_vs_per_service=vs_service)), flush=True)
    low = {k: v for d in (vs_cpu, vs_service) for k, v in d.items() if v < 0.99}
    if low:
        raise AssertionError(f"small fleet cut agrees on < 0.99 of pairs: {low}")

    probs = synth_fleet_8svc()
    floors = {k: v - 0.01 for k, v in FLEET_JAX_ACCURACY.items()}
    launches, captured, walls, sweep, peaks = {}, {}, {}, [], {}
    for fused in (True, False):
        key = KERNEL_OF[fused][0]
        runs = {}
        for pipeline in (True, False):
            confs = [None] * len(probs)
            capture = (assembly_capture(sweep, 1024, 2048, 32)
                       if fused and pipeline else contextlib.nullcontext())
            with capture:
                runs[pipeline], n, line = fleet_run(
                    "fleet", probs, fused, floors, card, captured if fused else None,
                    pipeline=pipeline, confidences=confs)
            walls[(fused, pipeline)] = line["wall_s"]
            if fused and pipeline:
                peaks["kernel"] = line["peak_mem_bytes"]
                launches["assemble_block"] = line["assembly_launches"]
            if pipeline:  # the default flow is the main path
                launches[key] = n
                confidence_line(probs, runs[pipeline][0], confs, fused, card)
            runs[pipeline] += (confs,)
        same = {p["service"]: agreement(a[0], b[0])
                for p, a, b in zip(probs, runs[True][0], runs[False][0])}
        print("fleet-pipelined-vs-serial " + json.dumps(dict(
            fused_kernel=fused, identical_pairs=same,
            identical_records=runs[True][-1] == runs[False][-1])), flush=True)
        if any(v != 1.0 for v in same.values()) or runs[True][-1] != runs[False][-1]:
            raise AssertionError(f"pipelined and serial flows differ (fused={fused}): "
                                 f"{same}")
    if "block" not in captured:
        raise AssertionError("no [>= 32, 1025, 2049] block in the fleet run")
    warm_rounds(probs, floors, card)
    if len(sweep) != ASSEMBLY_CALLS:
        raise AssertionError(f"kept {len(sweep)} assembly calls of the chain group")
    with plain_assembly():
        _, _, line = fleet_run("fleet-plain-score-build", probs, True, floors, card,
                               plain_build=True)
    peaks["plain"] = line["peak_mem_bytes"]
    print("fleet-score-build " + json.dumps(dict(
        config="synth-fleet-8svc", fused_kernel=True, pipeline=True,
        peak_mem_bytes=peaks, wall_s={"kernel": walls[(True, True)],
                                      "plain": line["wall_s"]}, card=card)),
          flush=True)
    torch.cuda.synchronize()
    return launches, captured["block"], probs, walls[(True, True)], sweep, peaks["kernel"]


def fleet_run(tag, probs, fused, floors, card, captured=None, ill=None,
              plain_build=False, **kw):
    """One full-size ``solve_fleet`` through :func:`drive`, its line
    printed under ``tag``; fails on a missing launch (the assembly
    kernel's too, and on a call of the assembly's plain version on the
    card, unless ``score_gemm`` or ``plain_build``, under
    :func:`plain_assembly`, takes its place), an
    accuracy below its floor, a moved ``fault_*`` counter or a
    quarantine. ``ill`` (a dict) gets the ill-posed window counts.
    Returns the :func:`run_fleet` tuple, the path kernel's launches and
    the line."""
    key = KERNEL_OF[fused][0]
    n_spans = sum(len(next(iter(p["in_parts"].values()))) for p in probs)
    counts = {}
    result, launches, other, kernel_ms = drive(
        lambda: run_fleet(probs, fused, **kw), fused, captured,
        want=lambda S: S.shape[0] >= 32 and S.shape[1:] == (1025, 2049), ill=ill,
        counts=counts)
    _, acc, wall, peak, stats, quarantined = result
    faults = {k: v for k, v in stats.items() if k.startswith("fault")}
    line = dict(
        config="synth-fleet-8svc", fused_kernel=fused,
        pipeline=kw.get("pipeline", True), precision=kw.get("precision", "f32"),
        wall_s=wall, spans_per_s=n_spans / wall, kernel=key, kernel_ms_summed=kernel_ms,
        launches=launches, other_kernel_launches=other,
        assembly_launches=counts["assemble_block"],
        plain_assembly_on_card=counts["plain_assembly_on_card"], peak_mem_bytes=peak,
        **{k: stats.get(k, 0.0) for k in (
            "pipeline_groups", "pipeline_depth", "fleet_dispatches",
            "fleet_services", "fused_em_applied", "fleet_dynamism_dispatches",
            "compact_windows_total", "compact_windows_redispatched",
            "plan_fit_s", "pack_s", "dispatch_s", "wait_s", "decode_s")},
        accuracy=acc, accuracy_floor=floors, faults=faults,
        quarantined=quarantined, card=card)
    print(f"{tag} " + json.dumps(line), flush=True)
    if launches <= 0:
        raise AssertionError(f"{tag} (fused={fused}) launched no {key} kernel")
    if not (plain_build or kw.get("score_gemm")):
        check_assembly(f"{tag} (fused={fused})", counts)
    below = {k: v for k, v in acc.items() if v < floors[k]}
    if below:
        raise AssertionError(f"{tag} accuracy below the floor (fused={fused}): {below}")
    if any(v for v in faults.values()) or quarantined:
        raise AssertionError(f"{tag} needed the supervisor: {faults}, "
                             f"quarantined {quarantined}")
    return result, launches, line


def confidence_line(probs, out, confs, fused, card):
    """The ``fleet-confidence`` line: records per service (one per
    incoming span, else fail), mean confidence, and the accuracy of the
    spans above and at or below ``CONF_LOW``."""
    from traceweaver_tpu_torch.metrics.accuracy import span_correctness
    from traceweaver_tpu_torch.obs.quality import CONF_LOW

    per = {}
    for p, res, recs in zip(probs, out, confs):
        ids = [s.GetId() for s in next(iter(p["in_parts"].values()))]
        if recs is None or sorted(recs) != sorted(ids):
            raise AssertionError(f"{p['service']}: {len(recs or {})} confidence "
                                 f"records for {len(ids)} incoming spans")
        right = span_correctness(res[0], p["truth"], p["in_parts"])
        low = [i for i in ids if recs[i]["conf"] <= CONF_LOW]
        high = [i for i in ids if recs[i]["conf"] > CONF_LOW]

        def acc(sel):
            return sum(right[i] for i in sel) / len(sel) if sel else None

        per[p["service"]] = dict(
            records=len(recs), spans=len(ids),
            mean_conf=sum(r["conf"] for r in recs.values()) / len(recs),
            n_low=len(low), accuracy_above_low=acc(high), accuracy_at_or_below_low=acc(low))
    print("fleet-confidence " + json.dumps(dict(
        config="synth-fleet-8svc", fused_kernel=fused, conf_low=CONF_LOW,
        services=per, card=card)), flush=True)


def warm_rounds(probs, floors, card):
    """Two pipelined rounds with the fused kernel and one plan cache."""
    from traceweaver_tpu_torch.algorithms.plancache import PlanCache

    cache, rounds = PlanCache(), []
    for r in (1, 2):
        result, _, line = fleet_run("fleet-warm-run", probs, True, floors, card,
                                    plan_cache=cache)
        rounds.append(result[0])
        counters = cache.counters()
        agree = ({p["service"]: agreement(b[0], a[0])
                  for p, a, b in zip(probs, rounds[0], rounds[1])} if r == 2 else None)
        print("fleet-warm " + json.dumps(dict(
            config="synth-fleet-8svc", round=r, plan_cache=counters,
            **{k: line[k] for k in ("wall_s", "plan_fit_s", "launches",
                                     "fused_em_applied", "fleet_dispatches",
                                     "peak_mem_bytes", "accuracy")},
            round2_vs_round1_pairs=agree, card=card)), flush=True)
    if counters["hits"] != len(probs) or line["fused_em_applied"] != 0.0:
        raise AssertionError(f"round 2 missed the plan cache: {counters}, "
                             f"fused_em_applied {line['fused_em_applied']}")
    low = {k: v for k, v in agree.items() if k != "cache" and v < 0.99}
    if low:
        raise AssertionError(f"round 2 agrees with round 1 on < 0.99 of pairs: {low}")


# ---------------------------------------------------------------------------
# precision: the bf16 score path and the GEMM score form
# ---------------------------------------------------------------------------

def precision_phase(card, probs, f32_peaks):
    """The precision phase (see the module docstring): ``synth-async-8k``
    at bf16 with each kernel and with ``score_gemm``, ``synth-fleet-8svc``
    at bf16; each held to its JAX reading under :func:`check_accuracy`'s
    rule. ``f32_peaks`` (config -> bytes) go on the lines beside the
    bf16 peaks. Returns the bf16 runs' launches and their K1 blocks."""
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k

    prob = synth_async_8k()
    launches, captured = {}, {}
    runs = [("bf16", fused, dict(precision="bf16")) for fused in (True, False)]
    runs.append(("gemm", True, dict(score_gemm=True)))
    for tag, fused, kw in runs:
        key = KERNEL_OF[fused][0]
        ill, counts = {}, {}
        (_, acc, wall, peak, _), n, other, ms = drive(
            lambda: run_slice(prob, fused, **kw), fused,
            captured if tag == "bf16" and fused else None, ill=ill, counts=counts)
        ref = BF16_JAX_ACCURACY if tag == "bf16" else GEMM_JAX_ACCURACY
        print("precision " + json.dumps(dict(
            config="synth-async-8k", run=tag, fused_kernel=fused, **kw, accuracy=acc,
            accuracy_jax_cpu=ref, wall_s=wall, kernel=key, launches=n,
            other_kernel_launches=other, assembly_launches=counts["assemble_block"],
            plain_assembly_on_card=counts["plain_assembly_on_card"],
            kernel_ms=ms, peak_mem_bytes=peak,
            peak_mem_bytes_f32=f32_peaks["synth-async-8k"], **ill, card=card)),
            flush=True)
        if n <= 0:
            raise AssertionError(f"{tag} slice (fused={fused}) launched no {key} kernel")
        if tag == "bf16":
            launches[key] = n
            check_assembly(f"{tag} slice (fused={fused})", counts)
            if fused:
                launches["assemble_block"] = counts["assemble_block"]
        check_accuracy(f"{tag} slice (fused={fused})", {"slice": 100.0 * acc},
                       {"slice": 100.0 * ref}, ill)
    # ``cache`` is held to CACHE_BF16_MAX_PT here and block by block in
    # cache_check
    ill, fleet_captured = {}, {}
    floors = {k: v - (0.01 if k != "cache" else CACHE_BF16_MAX_PT / 100)
              for k, v in FLEET_BF16_JAX_ACCURACY.items()}
    (_, acc, _, peak, _, _), n, line = fleet_run(
        "fleet-bf16", probs, True, floors, card, fleet_captured, ill=ill,
        precision="bf16")
    print("precision " + json.dumps(dict(
        config="synth-fleet-8svc", run="bf16", accuracy=acc,
        accuracy_jax_cpu=FLEET_BF16_JAX_ACCURACY, cache_max_pt=CACHE_BF16_MAX_PT,
        launches=n, peak_mem_bytes=peak,
        peak_mem_bytes_f32=f32_peaks["synth-fleet-8svc"], **ill, card=card)), flush=True)
    check_accuracy("fleet bf16", {k: 100.0 * v for k, v in acc.items() if k != "cache"},
                   {k: 100.0 * v for k, v in FLEET_BF16_JAX_ACCURACY.items()
                    if k != "cache"}, ill)
    gap = 100.0 * (acc["cache"] - FLEET_BF16_JAX_ACCURACY["cache"])
    if abs(gap) > CACHE_BF16_MAX_PT:
        raise AssertionError(f"fleet bf16 cache: {100.0 * acc['cache']} is not within "
                             f"{CACHE_BF16_MAX_PT} pt of JAX")
    cache_check(card, next(p for p in probs if p["service"] == "cache"), acc["cache"])
    launches["fleet_fused_assign"] = n
    launches["fleet_assemble_block"] = line["assembly_launches"]
    blocks = {"slice-block-bf16": captured["block"]}
    if "block" in fleet_captured:
        blocks["fleet-block-bf16"] = fleet_captured["block"]
    else:
        raise AssertionError("no [>= 32, 1025, 2049] block in the bf16 fleet run")
    return launches, blocks


def unmet_windows(plan, row_marg):
    """[B] bool: windows where the plain plan leaves a live row short of
    its mass by half a unit or more, so no plan on the mask's support
    meets the marginals. Their Sinkhorn potentials drift without bound
    (to about 1e4 on the ``cache`` service), so the plan is f32 rounding
    noise as in an ill-posed window (:func:`ill_posed_windows`, a case
    of this one)."""
    miss = (plan.sum(dim=2) - row_marg).abs() * (row_marg > 0)
    return miss.amax(dim=1) >= 0.5


def cache_check(card, prob, fleet_acc):
    """The bf16 fleet's ``cache`` service solved alone on the card (it
    must read what it read in the fleet), K1 held to the plain
    composition on each of its blocks: at least 99% of the live rows of
    the windows that meet their marginals assigned alike; the rows of
    the windows that do not (:func:`unmet_windows`) are counted. Of the
    windows that meet them and still differ, the line counts those whose
    plain plan holds a near tie (a live row's two largest masses within
    a relative 1e-5), which K1 may break otherwise. Prints a
    ``cache-check`` line."""
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    blocks, real = [], wt.assign_topk

    def keep(*args, **kw):
        out = real(*args, **kw)
        blocks.append((args, {k: v for k, v in kw.items() if k != "fused"}, out[0]))
        return out

    wt.assign_topk = keep
    try:
        _, acc, _, _, _, _ = run_fleet([prob], True, precision="bf16")
    finally:
        wt.assign_topk = real
    n = dict(windows=0, unmet_windows=0, rows_met=0, rows_met_differ=0,
             windows_met_differ=0, windows_met_differ_near_tie=0, rows_unmet=0,
             rows_unmet_differ=0)
    for (S, rm, cm, in_v, cv, cap, W), kw, got in blocks:
        plan = sinkhorn_log(S, rm, cm, epsilon=kw["epsilon"], n_iters=kw["n_iters"],
                            tol=kw["tol"])
        bad = unmet_windows(plan, rm)
        want = K.round_topk_plain(plan[:, :W].contiguous(), in_v, cv, cap,
                                  topk=kw["topk"], min_topk_mass=kw["min_topk_mass"])[0]
        live = in_v[:, :W]
        d = (got != want) & live
        top2 = plan[:, :W].topk(2, dim=2).values
        tie = ((top2[..., 0] - top2[..., 1] <= 1e-5 * top2[..., 0]) & live).any(dim=1)
        dw = d.any(dim=1) & ~bad
        n["windows"] += S.shape[0]
        n["unmet_windows"] += int(bad.sum())
        n["rows_met"] += int(live[~bad].sum())
        n["rows_met_differ"] += int(d[~bad].sum())
        n["windows_met_differ"] += int(dw.sum())
        n["windows_met_differ_near_tie"] += int((dw & tie).sum())
        n["rows_unmet"] += int(live[bad].sum())
        n["rows_unmet_differ"] += int(d[bad].sum())
    agree = 1.0 - n["rows_met_differ"] / max(n["rows_met"], 1)
    line = dict(service="cache", precision="bf16", accuracy=acc["cache"],
                accuracy_in_fleet=fleet_acc, accuracy_jax_cpu=FLEET_BF16_JAX_ACCURACY["cache"],
                k1_blocks=len(blocks), **n, met_rows_agree=agree, card=card)
    print("cache-check " + json.dumps(line), flush=True)
    if acc["cache"] != fleet_acc:
        raise AssertionError(f"cache alone reads {acc['cache']}, in the fleet {fleet_acc}")
    if agree < 0.99:
        raise AssertionError(f"cache: K1 and the plain version agree on {agree} < 0.99 "
                             "of the rows of windows that meet their marginals")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

def _run_cli_captured(argv):
    """The port's CLI ``main(argv)`` in this process; returns the
    ``ExperimentResults`` its ``run_experiment`` made (with
    ``flagship_pred``, the flagship's assignments per service) and the
    wall seconds. Touches no card."""
    from traceweaver_tpu_torch.runtime import cli
    from traceweaver_tpu_torch.runtime import executor as X

    real, made = X.run_experiment, []
    real_fleet, flagship = X._solve_fleet_method, {}

    def capture(cfg, store=None):
        made.append(real(cfg, store))
        return made[-1]

    def fleet_capture(*args, **kw):
        out = real_fleet(*args, **kw)
        flagship.update({r["process"]: r["pred"] for r in out})
        return out

    X.run_experiment, X._solve_fleet_method = capture, fleet_capture
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        X.run_experiment, X._solve_fleet_method = real, real_fleet
    wall = time.perf_counter() - t0
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"cli {argv} exited {rc}")
    made[0].flagship_pred = flagship
    return made[0], wall


def run_cli(argv):
    """:func:`_run_cli_captured` on the card: returns the results, peak
    device bytes (above what was allocated when the call began, like
    every ``peak_mem_bytes`` here: the blocks the smoke keeps for its
    kernel checks do not count) and wall seconds (after a synchronise)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res, _ = _run_cli_captured(argv)
    torch.cuda.synchronize()
    return (res, torch.cuda.max_memory_allocated() - base,
            time.perf_counter() - t0)


def _cpu_worker_init() -> None:
    """A CPU rerun process: one thread, so the workers share the cores."""
    import torch

    torch.set_num_threads(1)


def cpu_flagship(graph_dir, n, results, gt_free=False, compress=15000):
    """Worker: the flagship of one exp5 graph through the CLI on the CPU
    (``--device cpu``, ``--gt_free_dag`` with ``gt_free``, at
    ``compress``); returns its
    accuracy, per-service assignments, ill-posed windows and windows,
    discovered edges and wall seconds. Its printing is dropped."""
    import contextlib
    import io

    sys.path.insert(0, HERE)
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt

    real, windows = wt.assign_topk, [0, 0]

    def counting(*args, **kw):
        windows[0] += int(ill_posed_windows(*args[:3]).sum())
        windows[1] += args[0].shape[0]
        return real(*args, **kw)

    argv = (exp5_argv(graph_dir, n, results, compress=compress, predictors="10")
            + ["--device", "cpu"]
            + (["--gt_free_dag", "1"] if gt_free else []))
    wt.assign_topk = counting
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            res, wall = _run_cli_captured(argv)
    finally:
        wt.assign_topk = real
    return dict(accuracy=res.accuracy_overall[FLAGSHIP], pred=res.flagship_pred,
                ill_posed_windows=windows[0], windows=windows[1], wall_s=wall,
                edges={p: g.edges() for p, g in res.store.discovered_dags.items()})


class CpuReruns:
    """A pool of ``workers`` spawned processes for :func:`cpu_flagship`;
    :meth:`close` (or leaving the ``with`` block) stops every process."""

    def __init__(self, workers: int = 8):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)

    def submit(self, *args, **kw):
        return self.pool.submit(cpu_flagship, *args, **kw)

    def close(self, cancel=False):
        self.pool.shutdown(wait=True, cancel_futures=cancel)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        self.close(cancel=exc_type is not None)


def exp5_argv(graph_dir, n, results, compress=15000, predictors="3,4,7,10",
              execute_parallel=0, max_traces=1000):
    """exp5's arguments (``exps/common.sh run_executor``) for graph ``n``."""
    return ["--absolute_path", graph_dir, "--fix", "5", "--cache_rate", "0",
            "--test_name", f"alibaba_cg_{n}_load_multiple", "--load_level", "1",
            "--compress_factor", str(compress), "--repeat_factor", "1",
            "--execute_parallel", str(execute_parallel),
            "--results_directory", results, "--predictor_indices", predictors,
            "--max_traces", str(max_traces)]


def solved(res):
    """Services the flagship (else the first method) solved, and their
    incoming spans."""
    keys = {k for k, _ in res.accuracy_per_process}
    key = FLAGSHIP if FLAGSHIP in keys else sorted(keys)[0]
    procs = [p for k, p in res.accuracy_per_process if k == key]
    return len(procs), sum(len(res.store.in_spans_by_process[p]) for p in procs)


def executor_line(tag, res, peak, wall, launches, kernel_ms, ill, card, **extra):
    """Print the ``tag`` line of :func:`executor_record`; returns it."""
    line = executor_record(res, peak, wall, launches, kernel_ms, ill, card, **extra)
    print(f"{tag} " + json.dumps(line), flush=True)
    return line


def executor_record(res, peak, wall, launches, kernel_ms, ill, card, **extra):
    """One CLI run's line: services, spans, walls, launches, ill-posed
    windows, ingest front end, peak memory and accuracy, and ``extra``."""
    services, spans = solved(res)
    fleet = res.fleet_stats.get(FLAGSHIP, {})
    acc = {k: v for k, v in res.accuracy_overall.items() if not k.endswith("TopK")}
    per_service = {p: a for (k, p), a in res.accuracy_per_process.items() if k == FLAGSHIP}
    line = dict(services=services, incoming_spans=spans, wall_s=wall,
                seconds=res.seconds, fleet_dispatches=fleet.get("fleet_dispatches", 0.0),
                fused_assign_launches=launches, fused_assign_ms_summed=kernel_ms,
                ill_posed_windows=ill["ill_posed_windows"], windows=ill["windows"],
                ingest_front_end=res.store.ingest_front_end,
                peak_mem_bytes=peak, accuracy=acc, flagship_per_service=per_service,
                card=card, **extra)
    return line


def check_accuracy(tag, acc, jax_acc, ill):
    """Host baselines equal the JAX package's. Every other method (on
    the card) reads JAX's number within half a point either way when its
    run met no ill-posed window, else within one point either way (its
    plans there are rounding noise: ROADMAP C.1)."""
    for method, ref in jax_acc.items():
        got = acc[method]
        if method in HOST_BASELINES:
            if got != ref:
                raise AssertionError(f"{tag} {method}: {got} != JAX {ref}")
            continue
        bar = 0.5 if ill["ill_posed_windows"] == 0 else 1.0
        if abs(got - ref) > bar:
            raise AssertionError(f"{tag} {method}: {got} is not within {bar} pt of "
                                 f"JAX {ref} ({ill['ill_posed_windows']} ill-posed "
                                 "windows)")


def card_vs_cpu(tag, name, card_res, ill, ref, cpu, card, config="alibaba-exp5-15000",
                cpu_ref=None, **extra):
    """The two-sided flagship check of one exp5 graph against the port's
    own CPU run ``cpu`` (:func:`cpu_flagship`) and the JAX package's
    reading ``ref``: with no ill-posed window on the card, the card reads
    ``ref`` within half a point either way and assigns at least 99% of
    every service's pairs as the CPU run does; otherwise the CPU run must
    equal ``ref`` exactly (``cpu_ref``, a ``LADDER_PORT_CPU`` reading,
    where the port's CPU run is known to part from JAX's) and the card is
    held to the looser two-sided bounds ``ILL_POSED_MAX_PT`` and
    ``ILL_POSED_MIN_PAIRS``. Prints the ``executor-card-vs-cpu`` line and
    returns what failed ("" when nothing did)."""
    got = card_res.accuracy_overall[FLAGSHIP]
    pairs = {p: agreement(card_res.flagship_pred[p], pred)
             for p, pred in cpu["pred"].items()}
    clean = ill["ill_posed_windows"] == 0
    want_cpu = ref if cpu_ref is None else cpu_ref
    low = {p: v for p, v in pairs.items()
           if v < (0.99 if clean else ILL_POSED_MIN_PAIRS)}
    line = dict(config=config, run=tag, graph=name,
                flagship_card=got, flagship_cpu=cpu["accuracy"], flagship_jax_cpu=ref,
                flagship_cpu_recorded=cpu_ref,
                card_within_half_pt_of_jax=abs(got - ref) <= 0.5,
                card_ill_posed_windows=ill["ill_posed_windows"],
                card_windows=ill["windows"],
                cpu_ill_posed_windows=cpu["ill_posed_windows"],
                cpu_windows=cpu["windows"], cpu_wall_s=cpu["wall_s"],
                card_vs_cpu_pairs=pairs,
                rule="within 0.5 pt of JAX, >= 0.99 pairs" if clean
                else (f"CPU equals {'JAX' if cpu_ref is None else 'the recorded port CPU'}, "
                      f"card within {ILL_POSED_MAX_PT} pt of JAX, "
                      f">= {ILL_POSED_MIN_PAIRS} pairs"), card=card, **extra)
    print("executor-card-vs-cpu " + json.dumps(line), flush=True)
    if clean and (abs(got - ref) > 0.5 or low):
        return (f"{tag} {name}: card {got} vs JAX {ref}, pairs under 0.99 {low}, "
                "with no ill-posed window")
    if not clean and cpu["accuracy"] != want_cpu:
        return (f"{tag} {name}: the port on the CPU reads {cpu['accuracy']}, "
                f"not {want_cpu} (JAX {ref})")
    if not clean and (abs(got - ref) > ILL_POSED_MAX_PT or low):
        return (f"{tag} {name}: card {got} vs JAX {ref}, pairs under "
                f"{ILL_POSED_MIN_PAIRS} {low}, with {ill['ill_posed_windows']} "
                "ill-posed windows")
    return ""


def gt_dag_edges(store):
    """Each solvable service's invocation-DAG edges from ground truth."""
    from traceweaver_tpu_torch.ingest import build_service_problem, infer_invocation_dag
    from traceweaver_tpu_torch.metrics import get_ground_truth

    out = {}
    for svc in store.discovered_dags:
        prob = build_service_problem(store, svc)
        truth = get_ground_truth(prob.in_span_partitions, prob.out_span_partitions)
        out[svc] = infer_invocation_dag(prob.in_span_partitions,
                                        prob.out_span_partitions, truth, store).edges()
    return out


def ingest_compare(config, graph_dir, max_traces, card):
    """``load_corpus`` with the C++ loader and with Python's ``json`` on
    one corpus: equal trace ids in order, spans per service and
    malformed counts; prints both front ends' seconds."""
    import random

    from traceweaver_tpu_torch import native
    from traceweaver_tpu_torch.ingest import load_corpus

    stores, secs = {}, {}
    for front_end in ("native", "python"):
        random.seed(10)
        t0 = time.perf_counter()
        stores[front_end] = load_corpus(graph_dir, 5, max_traces=max_traces,
                                        native=front_end == "native")
        secs[front_end] = time.perf_counter() - t0
    a, b = stores["native"], stores["python"]

    def spans_by(store, attr):
        return {p: [s.GetId() for s in v] for p, v in getattr(store, attr).items()}

    same = dict(
        trace_ids=list(a.all_processes) == list(b.all_processes),
        spans=list(a.all_spans) == list(b.all_spans),
        in_spans=spans_by(a, "in_spans_by_process") == spans_by(b, "in_spans_by_process"),
        out_spans=spans_by(a, "out_spans_by_process") == spans_by(b, "out_spans_by_process"),
        malformed=a.ingest_malformed_spans == b.ingest_malformed_spans,
        counters=a.ingest_counters == b.ingest_counters)
    print("ingest-front-ends " + json.dumps(dict(
        config=config, files=len(os.listdir(graph_dir)), traces=len(a.all_processes),
        spans=len(a.all_spans), native_s=secs["native"], python_s=secs["python"],
        front_ends=[a.ingest_front_end, b.ingest_front_end], equal=same,
        loader=os.path.basename(native.build()), card=card)), flush=True)
    if a.ingest_front_end != "native" or not all(same.values()):
        raise AssertionError(f"{config}: native and Python stores differ: {same}")


def obs_cli_run(graph_dir, root, card):
    """One CLI call (graph 0's flagship) with ``--events`` and
    ``--metrics_port 0``: just before the exporter stops, ``GET
    /metrics`` over loopback must serve the fleet ledger and the fault
    ladder families; then ``cli events`` must print the event file's
    ``fault_injected`` and ladder records (which :func:`fault_run` wrote
    to the same file)."""
    import contextlib
    import io
    import urllib.request

    from traceweaver_tpu_torch.runtime import cli

    events = os.path.join(root, "events.jsonl")
    real_finish, scraped = cli._obs_finish, {}

    def finish(exporter, log):
        url = f"http://127.0.0.1:{exporter.port}/metrics"
        with urllib.request.urlopen(url, timeout=30) as resp:
            scraped.update(status=resp.status, body=resp.read().decode())
        real_finish(exporter, log)

    cli._obs_finish = finish
    try:
        res, _, wall = run_cli(exp5_argv(graph_dir, 0, os.path.join(root, "results-obs"),
                                         predictors="10")
                               + ["--events", events, "--metrics_port", "0"])
    finally:
        cli._obs_finish = real_finish
    body = scraped.get("body", "")
    families = {f: f"# TYPE {f} " in body for f in (
        "tw_fleet_ledger_total", "tw_fault_ladder_events_total", "tw_fleet_gauge",
        "tw_solver_ledger_total")}
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["events", events, "-n", "0"])
    lines = out.getvalue().splitlines()
    print("obs-cli " + json.dumps(dict(
        config="alibaba-exp5-15000", graph="call_graph_0", wall_s=wall,
        metrics_status=scraped.get("status"), metrics_bytes=len(body),
        families=families,
        fault_ladder_samples=[ln for ln in body.splitlines()
                              if ln.startswith("tw_fault_ladder_events_total{")],
        events_rc=rc, events_lines=lines, card=card)), flush=True)
    if scraped.get("status") != 200 or not all(families.values()):
        raise AssertionError(f"/metrics did not serve every family: {families}")
    if rc != 0 or not any("fault_injected/dispatch" in ln for ln in lines) \
            or not any("fault_ladder/retry" in ln for ln in lines):
        raise AssertionError(f"cli events printed {lines}")


def query_run(e2e_pickle, card):
    """``cli query`` over an ``e2e_*`` pickle this run wrote."""
    import contextlib
    import io

    from traceweaver_tpu_torch.runtime import cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(["query", e2e_pickle])
    lines = out.getvalue().splitlines()
    print("query " + json.dumps(dict(pickle=os.path.basename(e2e_pickle), rc=rc,
                                     lines=lines, card=card)), flush=True)
    if rc != 0 or not any(ln.startswith(FLAGSHIP + ":") for ln in lines):
        raise AssertionError(f"cli query printed {lines}")


def profiled(run):
    """``run()`` with profiling enabled under a ``torch.profiler`` trace
    of every thread, inside a ``tw:smoke:call`` range; returns its
    result, the wall seconds and the :func:`device_timeline` of the
    range, with the ``tw:*`` names the trace holds."""
    import torch

    from traceweaver_tpu_torch.obs import profile as P

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with P.profiling(), P.trace() as prof:
        with P.annotate("tw:smoke:call"):
            out = run()
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    device, ranges = P.trace_intervals(prof)
    (call,) = [r for r in ranges if r[0] == "tw:smoke:call"]
    report = P.device_timeline(device, ranges, call[1], call[2])
    report["names"] = sorted({r[0] for r in ranges})
    return out, wall, report


def profile_line(tag, config, report, wall, unprofiled_wall_s, card, **extra):
    """The ``profile`` line: the device's idle share of the traced call
    and, from the same busy time, of the call's unprofiled wall (the
    profiler slows the host; None where no unprofiled run did the same
    work)."""
    busy_s = report["device_busy"] / 1e6
    line = dict(config=config, call=tag, traced_wall_s=wall,
                traced_window_s=report["wall"] / 1e6, device_busy_s=busy_s,
                idle_share=report["idle_share"], unprofiled_wall_s=unprofiled_wall_s,
                idle_share_of_unprofiled_wall=(None if unprofiled_wall_s is None
                                               else 1.0 - busy_s / unprofiled_wall_s),
                device_ops=report["kernels"], longest_ops_us=report["longest_ops"],
                longest_gaps_us=report["longest_gaps"], names=report["names"],
                card=card, **extra)
    print("profile " + json.dumps(line), flush=True)
    if not report["kernels"]:
        raise AssertionError(f"{tag}: the trace holds no device operation")
    return line


def ledger_check(tag, before, after, stats):
    """The registry's ledger deltas over one ``solve_fleet`` call equal
    its stats dict (high-water marks go to the gauge instead), and the
    ladder counter's deltas its ``fault_ladder`` list."""
    import re

    def family(snap, name, labels):
        pat = re.compile(r"^%s\{%s\}$" % (name, ",".join(f'{k}="([^"]+)"' for k in labels)))
        return {m.groups() if len(labels) > 1 else m.group(1): v
                for k, v in snap.items() if (m := pat.match(k))}

    gauges = set(family(after, "tw_fleet_gauge", ["key"]))
    got = {k: v - family(before, "tw_fleet_ledger_total", ["key"]).get(k, 0.0)
           for k, v in family(after, "tw_fleet_ledger_total", ["key"]).items()}
    got = {k: v for k, v in got.items() if v}
    want = {k: v for k, v in stats.items() if isinstance(v, float) and v
            and k not in gauges}
    off = {k: (got.get(k), want.get(k)) for k in set(got) | set(want)
           if abs(got.get(k, 0.0) - want.get(k, 0.0))
           > 1e-9 + 1e-6 * abs(want.get(k, 0.0))}
    ladder_before = family(before, "tw_fault_ladder_events_total", ["key", "rung"])
    ladder = {k: v - ladder_before.get(k, 0.0) for k, v in family(
        after, "tw_fault_ladder_events_total", ["key", "rung"]).items()}
    want_ladder = {}
    for rung in stats.get("fault_ladder", []):
        want_ladder[("fault_ladder", rung)] = want_ladder.get(("fault_ladder", rung), 0) + 1
    ladder = {k: v for k, v in ladder.items() if v}
    if off or ladder != want_ladder:
        raise AssertionError(f"{tag}: registry deltas differ from the stats dict: "
                             f"{off}, ladder {ladder} vs {want_ladder}")
    return len(want), {"/".join(k): v for k, v in ladder.items()}


def fault_run(root, card):
    """One ``solve_fleet`` on a 256-request cut of ``synth-fleet-8svc`` on
    the card with a ``FaultPlan`` that fails the first dispatch, with an
    event sink installed: the supervisor retries, the results stay
    complete, the registry's deltas equal the stats dict, and the sink
    holds the ``fault_injected`` and ladder records."""
    from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc
    from traceweaver_tpu_torch.obs import events as E
    from traceweaver_tpu_torch.obs.registry import get_registry
    from traceweaver_tpu_torch.runtime.faults import parse_faults

    probs = synth_fleet_8svc(FLEET_SMALL)
    path = os.path.join(root, "events.jsonl")
    reg = get_registry()
    before = reg.snapshot()
    log = E.EventLog(path)
    E.install(log)
    try:
        _, acc, wall, _, stats, quarantined = run_fleet(
            probs, True, faults=parse_faults("dispatch:1.0:max=1", seed=0),
            retry_backoff_s=0.0)
    finally:
        E.install(None)
        log.close()
    n_keys, ladder = ledger_check("fault-run", before, reg.snapshot(), stats)
    with open(path) as f:
        records = [json.loads(ln) for ln in f]
    print("obs-fault " + json.dumps(dict(
        config="synth-fleet-8svc", requests_per_service=FLEET_SMALL, wall_s=wall,
        fault_ladder=stats.get("fault_ladder"), faults_injected=stats.get("faults_injected"),
        ledger_keys_equal=n_keys, ladder_counter_deltas=ladder,
        events=[(r["kind"], r["event"]) for r in records], quarantined=quarantined,
        accuracy=acc, card=card)), flush=True)
    if stats.get("fault_ladder") != ["retry"] or quarantined or \
            [(r["kind"], r["event"]) for r in records] != [
                ("fault_injected", "dispatch"), ("fault_ladder", "retry")]:
        raise AssertionError(f"fault run: ladder {stats.get('fault_ladder')}, "
                             f"records {records}, quarantined {quarantined}")


def fleet_profile(probs, unprofiled_wall, card):
    """One ``solve_fleet`` on the full ``synth-fleet-8svc`` (K1,
    pipelined) under the profiler: the device's idle share, its longest
    operations and idle gaps; the trace must hold ``tw:fleet:dispatch``."""
    (out, _, _, _, stats, _), wall, report = profiled(lambda: run_fleet(probs, True))
    profile_line("solve_fleet", "synth-fleet-8svc", report, wall, unprofiled_wall, card,
                 fleet_dispatches=stats.get("fleet_dispatches"))
    if "tw:fleet:dispatch" not in report["names"]:
        raise AssertionError(f"fleet trace holds {report['names']}")


def profiled_cli(argv, card, unprofiled):
    """The ground-truth-free ``alibaba-cg-8k`` CLI call again under the
    profiler: the trace must hold the per-service solves of discovery
    (``tw:solve:dispatch``) and the flagship's fleet dispatches
    (``tw:fleet:dispatch``), and the call must read what the unprofiled
    one read."""
    (res, _, _), wall, report = profiled(lambda: run_cli(argv))
    profile_line("cli", "alibaba-cg-8k", report, wall, unprofiled["wall_s"], card,
                 gt_free_dag=True, accuracy=res.accuracy_overall[FLAGSHIP])
    missing = {"tw:fleet:dispatch", "tw:solve:dispatch"} - set(report["names"])
    if missing or res.accuracy_overall[FLAGSHIP] != unprofiled["accuracy"][FLAGSHIP]:
        raise AssertionError(f"profiled CLI: missing ranges {missing}, accuracy "
                             f"{res.accuracy_overall[FLAGSHIP]} vs "
                             f"{unprofiled['accuracy'][FLAGSHIP]}")


# ---------------------------------------------------------------------------
# stream
# ---------------------------------------------------------------------------

def serve_bodies(graph_dir, per_body=SERVE_BODY_TRACES):
    """One synthesized call graph as POST bodies: its traces in root
    start-time order (a trace without a root last), ``per_body`` to a
    ``{"data": [...]}`` body, serialized once. Shared with
    ``tests/jax_reference_synth.py --config serve-cg-4t``."""
    traces = []
    for name in sorted(os.listdir(graph_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(graph_dir, name)) as f:
            for tr in json.load(f)["data"]:
                roots = [s["startTime"] for s in tr["spans"] if not s.get("references")]
                traces.append((min(roots) if roots else float("inf"), name, tr))
    traces.sort(key=lambda t: (t[0], t[1]))
    return [json.dumps({"data": [t[2] for t in traces[i:i + per_body]]}).encode()
            for i in range(0, len(traces), per_body)]


def serve_truth(graph_dir):
    """Ground truth of a call graph for :func:`serve_sink_accuracy`, in
    the ids the Alibaba ingest gives (a client span's id takes a
    ``.client`` suffix): ``(parent, children)`` where ``parent`` maps a
    client span to its incoming (server) span and ``children`` maps a
    server span to ``[(callee, self_call)]`` of its client spans."""
    parent, children = {}, {}
    for name in os.listdir(graph_dir):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(graph_dir, name)) as f:
            for tr in json.load(f)["data"]:
                for s in tr["spans"]:
                    kind = next((t.get("value") for t in s.get("tags", [])
                                 if t.get("key") == "span.kind"), None)
                    refs = s.get("references") or []
                    if kind != "client" or not refs:
                        continue
                    cid = (s["traceID"], s["spanID"] + ".client")
                    pid = (refs[0]["traceID"], refs[0]["spanID"])
                    parent[cid] = pid
                    children.setdefault(pid, []).append(
                        (s.get("callee"), s.get("caller") == s.get("callee")))
    return parent, children


def serve_sink_accuracy(sink_path, truth):
    """Accuracy of one tenant's stitched-trace sink (a serve tenant runs
    ungraded, so the reading comes from what it emitted). A sink record
    holds, per service and endpoint, ``[incoming span, outgoing span or
    NA]`` rows of the spans its window owns. A row is right when the
    outgoing span is a ground-truth child of the incoming one, or it is
    NA and the incoming span has no child at that endpoint (an endpoint
    named ``*-loop`` is a self-call's, whose name the ingest draws at
    random). Returns ``{"per_service": {service: percent}, "e2e":
    percent of traces whose every row is right, "rows": n, "traces":
    n}``, and, for row agreement between runs, ``"rows_by_key"``:
    ``{(service, endpoint, in id): out id}`` and ``"window_of"``:
    ``{(service, in id): owning window}``."""
    parent, children = truth
    right, total, trace_ok, keyed, window_of = {}, {}, {}, {}, {}
    with open(sink_path) as f:
        for line in f:
            rec = json.loads(line)
            for svc, eps in rec["services"].items():
                for ep, rows in eps.items():
                    loop = ep.endswith("-loop")
                    for (itid, isid), (otid, osid) in rows:
                        iid, oid = (itid, isid), (otid, osid)
                        if oid == ("NA", "NA"):
                            ok = not any(self_call if loop else callee == ep
                                         for callee, self_call in children.get(iid, ()))
                        else:
                            ok = parent.get(oid) == iid
                        right[svc] = right.get(svc, 0) + ok
                        total[svc] = total.get(svc, 0) + 1
                        trace_ok[itid] = trace_ok.get(itid, True) and ok
                        keyed[(svc, ep, iid)] = oid
                        window_of[(svc, iid)] = rec["window"]
    n_rows = sum(total.values())
    return dict(per_service={s: 100.0 * right[s] / total[s] for s in sorted(total)},
                e2e=(100.0 * sum(trace_ok.values()) / len(trace_ok)) if trace_ok else 0.0,
                rows=n_rows, traces=len(trace_ok), rows_by_key=keyed, window_of=window_of)


def _stream_cfg(**kw):
    """``STREAM_ARGS`` as a ``StreamConfig``."""
    from traceweaver_tpu_torch.stream import StreamConfig

    return StreamConfig(window_us=20e6, overlap_us=4e6, ooo_bound_us=2e6, grace_us=0.0,
                        max_pending=4, **kw)


def _stream_pred(svc):
    """A finished service's graded predictions, ``{service: {endpoint:
    {in id: out id}}}``."""
    return {p: by_ep for p, by_ep in svc.grader.pred.items()}


def stream_phase(card, root, corpora=None):
    """Config ``stream-cg-8k`` through ``cli stream`` in this process on
    the card, with a sink and a checkpoint every 2 windows, every launch
    counter reset just before the call and read just after; then, as a
    call of its own, the batch comparison that ``--compare_batch`` prints
    (``cli.batch_accuracy`` on the stream's store); then a second run
    stopped after half the windows (an odd count, so beyond a checkpoint)
    under the profiler, resumed from its checkpoint in a fresh service,
    whose sink must equal the first run's byte for byte. Checks
    conservation, no dead-lettered window, both kernels launched and no
    plain assembly on the card, and the streamed accuracy against
    ``STREAM_JAX`` where no window was ill-posed (else
    :func:`rerun_checks` holds it to a CPU run). ``corpora`` (a
    :class:`CorpusJobs`) holds the corpus when given. Returns the
    stream's launches, its largest K1 block and what :func:`rerun_checks`
    needs."""
    import io

    import torch

    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log
    from traceweaver_tpu_torch.runtime import cli
    from traceweaver_tpu_torch.stream import (
        StreamingReconstructor,
        TraceSink,
        parse_source_spec,
    )

    t_phase = time.perf_counter()
    (d,), synth_s = corpus_dirs(root, "stream", corpora)
    spec = f"replay:{d}?{STREAM_QUERY}"
    out = os.path.join(root, "stream-out")
    sink_a, sink_b = os.path.join(out, "run.jsonl"), os.path.join(out, "killed.jsonl")
    argv = (["stream", "--source", spec] + STREAM_ARGS
            + ["--out", sink_a, "--checkpoint", os.path.join(out, "run.ckpt"),
               "--checkpoint_every", "2"])
    real_run, runs = StreamingReconstructor.run, []

    def keep_service(self, *args, **kw):
        runs.append((self, real_run(self, *args, **kw)))
        return runs[-1][1]

    def call():
        StreamingReconstructor.run = keep_service
        try:
            with contextlib.redirect_stdout(io.StringIO()) as printed:
                rc = cli.main(argv)
        finally:
            StreamingReconstructor.run = real_run
        if rc != 0:
            raise AssertionError(f"cli {argv} exited {rc}")
        return printed.getvalue()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    captured, ill, c = {}, {}, {}
    t_call = time.perf_counter()
    printed, _, _, _ = drive(call, True, captured, largest=True, ill=ill, counts=c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_call
    peak = torch.cuda.max_memory_allocated() - base
    ((svc, s),) = runs
    st = s["stats"]
    t0 = time.perf_counter()
    batch_acc = cli.batch_accuracy(svc.source.store, 5, "cuda", s["precision"])
    batch_s = time.perf_counter() - t0
    blk = captured["block"]
    plan = sinkhorn_log(blk["S"], blk["row_marg"], blk["col_marg"], epsilon=1.0,
                        n_iters=40, tol=1e-3)
    unmet = int(unmet_windows(plan, blk["row_marg"]).sum())
    del plan
    card_acc, ill_s = s["accuracy"]["e2e"], ill["ill_posed_windows"]
    line = dict(
        config="stream-cg-8k", device=s["device"], precision=s["precision"],
        consumed=s["consumed"], windows=s["emitted_windows"],
        micro_batches=int(st.get("micro_batches", 0)),
        spans_emitted=int(st.get("spans_emitted", 0)),
        late_rerouted=s["late_rerouted"], late_dropped=s["late_dropped"],
        shed_spilled=s["shed_spilled"], shed_dropped_windows=s["shed_dropped_windows"],
        deadletter_windows=s["deadletter_windows"],
        streamed_e2e=card_acc, streamed_e2e_jax=STREAM_JAX["streamed_e2e"],
        batch_e2e_port=batch_acc, batch_e2e_jax=STREAM_JAX["batch_e2e"],
        delta_vs_port_batch=card_acc - batch_acc, per_service=s["accuracy"]["per_service"],
        wall_s=wall, events_per_s=s["consumed"] / wall,
        solve_s=st.get("solve_s", 0.0), emit_s=st.get("emit_s", 0.0),
        checkpoint_s=st.get("checkpoint_s", 0.0), consume_s=st.get("consume_s", 0.0),
        plan_fit_s=st.get("plan_fit_s", 0.0), checkpoints=int(st.get("checkpoints", 0)),
        fused_assign_launches=c["fused_assign"], assemble_block_launches=c["assemble_block"],
        launches_in_summary=s["launches"], plain_assembly_on_card=c["plain_assembly_on_card"],
        ill_posed_windows=ill_s, k1_windows=ill["windows"],
        unmet_windows_largest_block=unmet, largest_block=list(blk["S"].shape),
        plan_cache=s["plan_cache"], pipeline=s["pipeline"], peak_mem_bytes=peak,
        batch_wall_s=batch_s, synthesize_s=synth_s, card=card)
    # a second run stopped after half the windows (odd: beyond a
    # checkpoint), under the profiler for the idle share; resumed below
    kill_at = max(3, s["emitted_windows"] // 2 | 1)
    ckpt = os.path.join(out, "killed.ckpt")
    killed = StreamingReconstructor(parse_source_spec(spec),
                                    _stream_cfg(checkpoint_path=ckpt, checkpoint_every=2,
                                                verbose=False),
                                    sink=TraceSink(sink_b))
    partial, traced_wall, report = profiled(lambda: killed.run(max_windows=kill_at))
    killed.sink.close()
    profile_line("stream-killed", "stream-cg-8k", report, traced_wall, None, card,
                 windows=partial["emitted_windows"])
    line.update(idle_share_profiled_half=report["idle_share"],
                profiled_windows=partial["emitted_windows"])
    print("stream " + json.dumps(line), flush=True)
    if "[stream] win=" not in printed or "streamed end-to-end accuracy" not in printed:
        raise AssertionError(f"cli stream printed {printed[-2000:]}")
    failed = []
    if line["spans_emitted"] + s["late_dropped"] != s["consumed"]:
        failed.append(f"conservation: {line['spans_emitted']} emitted + "
                      f"{s['late_dropped']} dropped != {s['consumed']} consumed")
    if s["deadletter_windows"] or s["faults"]["poisoned_windows"]:
        failed.append(f"{s['deadletter_windows']} dead-lettered windows")
    if c["fused_assign"] <= 0 or c["assemble_block"] <= 0:
        failed.append(f"the stream launched K1 {c['fused_assign']} and the assembly "
                      f"kernel {c['assemble_block']} times")
    if c["plain_assembly_on_card"]:
        failed.append(f"the assembly's plain version ran on the card "
                      f"{c['plain_assembly_on_card']} times")
    if (c["fused_assign"], c["assemble_block"]) != (
            s["launches"]["fused_assign"], s["launches"]["assemble_block"]):
        failed.append(f"launch counts {c} and the summary's {s['launches']} part")
    for key in ("consumed", "windows", "late_rerouted", "late_dropped", "shed_spilled",
                "shed_dropped_windows"):
        if line[key] != STREAM_JAX[key]:
            failed.append(f"{key}: {line[key]} != JAX {STREAM_JAX[key]}")
    if ill_s == 0 and abs(card_acc - STREAM_JAX["streamed_e2e"]) > 0.5:
        failed.append(f"streamed {card_acc} is not within 0.5 pt of JAX "
                      f"{STREAM_JAX['streamed_e2e']} with no ill-posed window")

    # the stopped run resumed from its checkpoint in a fresh service
    t0 = time.perf_counter()
    resumed = StreamingReconstructor.resume(ckpt, parse_source_spec(spec))
    final = resumed.run()
    resumed.sink.close()
    resume_s = time.perf_counter() - t0
    with open(sink_a, "rb") as f:
        want = f.read()
    with open(sink_b, "rb") as f:
        got = f.read()
    resumed_pairs = {p: agreement(_stream_pred(resumed).get(p, {}), pred)
                     for p, pred in _stream_pred(svc).items()}
    print("stream-resume " + json.dumps(dict(
        config="stream-cg-8k", killed_after_windows=partial["emitted_windows"],
        checkpoints_before_kill=int(partial["stats"].get("checkpoints", 0)),
        resumed_windows=final["emitted_windows"], sink_bytes=len(want),
        sink_identical=got == want, accuracy_resumed=final["accuracy"]["e2e"],
        resume_wall_s=resume_s, card=card)), flush=True)
    if got != want:
        first = next((i for i, (x, y) in enumerate(zip(got, want)) if x != y),
                     min(len(got), len(want)))
        failed.append(f"the resumed sink parts from the uninterrupted run's at byte "
                      f"{first} of {len(want)} ({len(got)} written); pairs "
                      f"{resumed_pairs}")
    if failed:
        raise AssertionError("stream: " + "; ".join(failed))
    print(f"stream-phase: {time.perf_counter() - t_phase:.3f} s wall", flush=True)
    launches = dict(fused_assign=c["fused_assign"], assemble_block=c["assemble_block"])
    return launches, blk, (d, card_acc, _stream_pred(svc), ill_s)


def cpu_stream(graph_dir, threads):
    """Worker: ``stream-cg-8k`` through the port's stream on the CPU, on
    ``threads`` threads; returns its streamed accuracy, graded
    predictions and wall seconds. ``graph_dir`` None synthesizes the
    corpus first."""
    sys.path.insert(0, HERE)
    import torch

    import tempfile

    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.stream import StreamingReconstructor, parse_source_spec

    torch.set_num_threads(threads)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if graph_dir is None:
            (graph_dir,) = synthesize_corpus(tmp, **STREAM_CORPUS)
        svc = StreamingReconstructor(parse_source_spec(f"replay:{graph_dir}?{STREAM_QUERY}"),
                                     _stream_cfg(verbose=False), device="cpu")
        summary = svc.run()
    return dict(accuracy=summary["accuracy"]["e2e"], pred=_stream_pred(svc),
                wall_s=time.perf_counter() - t0)


class StreamRerun:
    """:func:`cpu_stream` in a spawned process of its own, on two threads
    (about 340 s beside the card phases), so that it runs while they
    leave cores idle. :meth:`result` waits for it; leaving the ``with``
    block stops the process."""

    def __init__(self, graph_dir, threads: int = 2):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.job = self.pool.apply_async(cpu_stream, (graph_dir, threads))

    def result(self):
        return self.job.get()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.pool.terminate()
        self.pool.join()


def stream_verdict(card, stream, cpu):
    """The C.1 rule for a stream whose card run met ill-posed windows:
    the port's CPU run equals its recorded reading (``STREAM_PORT_CPU``,
    where it parts from JAX's) exactly, and the card reads JAX within
    ``ILL_POSED_MAX_PT`` with >= ``ILL_POSED_MIN_PAIRS`` of every
    service's pairs equal to the CPU run's. Returns what failed."""
    _, card_acc, card_pred, ill_s = stream
    ref = STREAM_JAX["streamed_e2e"]
    pairs = {p: agreement(card_pred.get(p, {}), pred) for p, pred in cpu["pred"].items()}
    low = {p: v for p, v in pairs.items() if v < ILL_POSED_MIN_PAIRS}
    print("stream-card-vs-cpu " + json.dumps(dict(
        config="stream-cg-8k", streamed_card=card_acc, streamed_cpu=cpu["accuracy"],
        streamed_jax_cpu=ref, streamed_cpu_recorded=STREAM_PORT_CPU,
        card_ill_posed_windows=ill_s, cpu_wall_s=cpu["wall_s"],
        card_vs_cpu_pairs=pairs, rule=f"CPU equals the recorded port CPU, card within "
        f"{ILL_POSED_MAX_PT} pt of JAX, >= {ILL_POSED_MIN_PAIRS} pairs", card=card)),
        flush=True)
    if cpu["accuracy"] != STREAM_PORT_CPU:
        return (f"stream: the port on the CPU reads {cpu['accuracy']}, not its recorded "
                f"{STREAM_PORT_CPU} (JAX {ref})")
    if abs(card_acc - ref) > ILL_POSED_MAX_PT or low:
        return (f"stream: card {card_acc} vs JAX {ref}, pairs under "
                f"{ILL_POSED_MIN_PAIRS} {low}, with {ill_s} ill-posed windows")
    return ""


# ---------------------------------------------------------------------------
# serve-cg-4t: the multi-tenant serve tier
# ---------------------------------------------------------------------------

def _serve_cfg(state_dir, continuous, **kw):
    """``SERVE_SETTINGS`` as a ``ServeConfig`` (the serve CLI's defaults,
    the stream's geometry)."""
    from traceweaver_tpu_torch.serve import ServeConfig

    return ServeConfig(state_dir=state_dir, continuous=continuous, verbose=False,
                       **dict(SERVE_SETTINGS, **kw))


def _http(method, url, body=None, timeout=900, headers=None):
    """One request on loopback: ``(status, body bytes, headers)``."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(url, data=body, method=method)
    if body is not None:
        req.add_header("Content-Type", "application/json")
    for k, v in (headers or {}).items():
        req.add_header(k, v)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        return e.code, e.read(), e.headers


def _post_all(base, tenant, bodies, first=0):
    """A client: POST each body in order as fast as acks return, waiting
    out 429s by their ``Retry-After``. Returns the POSTs answered 200."""
    n = 0
    for i, body in enumerate(bodies):
        while True:
            code, out, hdr = _http("POST", f"{base}/api/v1/tenants/{tenant}/spans", body)
            if code != 429:
                break
            time.sleep(float(hdr.get("Retry-After", "0.1")))
        if code != 200:
            raise AssertionError(f"POST {tenant} body {first + i}: {code} {out[:300]!r}")
        n += 1
    return n


class ServeRows:
    """Which owned rows of which tenant windows met an ill-posed K1 block.

    While installed it wraps the fleet's ``_dispatch_packed`` (to learn
    each group's rows: tenant, window key, service, solver window) and
    ``solve_windows_fleet``/``solve_em_fleet`` (to know when a K1 block's
    rows are the group's, in order: a warm dispatch of the compacted flow
    or an uncompacted group), and ``assign_topk`` (the K1 blocks), whose
    ill-posed windows it keeps as device flags, read once at the end;
    the straggler redispatch's blocks (a subset of rows) are not read.
    :meth:`ids` gives ``{(window key, service): {in ids of ill-posed
    solver windows}}``."""

    def __init__(self):
        self.local = threading.local()
        self.lock = threading.Lock()
        self.pending = []
        self.spans = {}

    def __enter__(self):
        import traceweaver_tpu_torch.algorithms.fleet as F
        import traceweaver_tpu_torch.algorithms.weaver_torch as wt

        self.saved = (F._dispatch_packed, F.solve_windows_fleet, F.solve_em_fleet,
                      wt.assign_topk)
        real_disp, real_swf, real_sem, real_k1 = self.saved
        local = self.local

        def disp(pg, spec, st, run):
            rows = []
            for _, item, prep, packed, n_w in pg["per_item_pack"]:
                ids = prep["in_cols"].ids
                key = (item.trace_key, item.svc)
                with self.lock:
                    self.spans[key] = [ids[lo:hi] for lo, hi in packed.windows[:n_w]]
                rows.extend((key, b) for b in range(n_w))
            local.rows, local.full = rows, False
            try:
                return real_disp(pg, spec, st, run)
            finally:
                local.rows = None

        def solver(real):
            def run(*args, n_sweeps, **kw):
                rows = getattr(local, "rows", None)
                local.full = rows is not None and args[0].shape[0] == len(rows) and (
                    n_sweeps == 2 or len(rows) == 1)
                try:
                    return real(*args, n_sweeps=n_sweeps, **kw)
                finally:
                    local.full = False
            return run

        def k1(*args, **kw):
            if getattr(local, "full", False):
                flags = ill_posed_windows(*args[:3])
                with self.lock:
                    self.pending.append((local.rows, flags))
            return real_k1(*args, **kw)

        F._dispatch_packed = disp
        F.solve_windows_fleet = solver(real_swf)
        F.solve_em_fleet = solver(real_sem)
        wt.assign_topk = k1
        return self

    def __exit__(self, *exc):
        import traceweaver_tpu_torch.algorithms.fleet as F
        import traceweaver_tpu_torch.algorithms.weaver_torch as wt

        (F._dispatch_packed, F.solve_windows_fleet, F.solve_em_fleet,
         wt.assign_topk) = self.saved

    def ids(self):
        import torch

        if any(f.is_cuda for _, f in self.pending):
            torch.cuda.synchronize()
        out = {}
        for rows, flags in self.pending:
            for (key, b) in (rows[i] for i in flags.nonzero().flatten().tolist()):
                out.setdefault(key, set()).update(self.spans[key][b].tolist())
        return out


def rows_agreement(a, b, ill=(), tenant=None):
    """Per service, the share of run ``a``'s sink rows (from
    :func:`serve_sink_accuracy`) that run ``b`` assigns alike, leaving
    out rows whose incoming span sat in an ill-posed solver window of its
    owning window (``ill`` from :meth:`ServeRows.ids`, keyed by
    ``"<tenant>:<window>"``)."""
    eq, tot = {}, {}
    ka, kb, win = a["rows_by_key"], b["rows_by_key"], a["window_of"]
    for (svc, ep, iid), oid in ka.items():
        if ill and iid in ill.get((f"{tenant}:{win[(svc, iid)]}", svc), ()):
            continue
        tot[svc] = tot.get(svc, 0) + 1
        eq[svc] = eq.get(svc, 0) + (kb.get((svc, ep, iid)) == oid)
    return {svc: eq[svc] / tot[svc] for svc in sorted(tot)}


def serve_alone(bodies, state, device, devcols=True, plan=None,
                pump_windows=SERVE_SETTINGS["pump_windows"]):
    """Tenant ``t0`` alone in a fresh service with fresh column rings,
    in this process: its bodies through ``wal_ingest`` in order, then,
    under the fixed pump of ``pump_windows`` (``plan`` None), a flush;
    with ``plan`` (the shared run's ``[("submit", seq, [window k]) |
    ("complete", seq)]`` events of ``t0``), every window sealed first and
    then submitted, dispatched and completed in the shared run's order,
    so the tenant's batches are the shared run's. Returns ``(sink path,
    stats, wall s, batches)``."""
    from traceweaver_tpu_torch.ops import devcols as DC
    from traceweaver_tpu_torch.serve import TenantService

    DC.get_store().clear()
    svc = TenantService(_serve_cfg(state, False, devcols=devcols,
                                   pump_windows=pump_windows if plan is None else 1 << 30),
                        device=device)
    batches = _record_batches(svc)
    t0 = time.perf_counter()
    for body in bodies:
        svc.wal_ingest("t0", body, raw=body)
    if plan is None:
        svc.flush()
    else:
        t = svc.tenant("t0", create=False)
        with svc._lock:
            t.flush()
            by_k = {b.k: b for b in t.svc.scheduler.ready()}
        tickets = {}
        for ev in plan:
            if ev[0] == "submit":
                ticket = svc.submit_admitted([(t, [by_k[k] for k in ev[2]])])
                svc._ring_dispatch(ticket)
                tickets[ev[1]] = ticket
            else:
                svc.complete_ticket(tickets.pop(ev[1]))
        if tickets or svc.total_backlog():
            raise AssertionError(f"serve replay left {len(tickets)} tickets and "
                                 f"{svc.total_backlog()} windows")
    wall = time.perf_counter() - t0
    st = svc.stats()
    svc.drain()
    return os.path.join(state, "t0", "traces.jsonl"), st, wall, batches


_SHAPES = threading.local()


def _record_batches(svc, events=None):
    """Record each of ``svc``'s fleet calls' composition (``{tenant:
    [window k]}``, and under ``"shapes"`` its dispatch groups' padded
    ``[windows, E, W, M]``) and, into ``events``, ``t0``'s ticket submits
    and completes in order."""
    import traceweaver_tpu_torch.algorithms.fleet as F

    if not hasattr(F._make_spec, "recording"):
        real_spec = F._make_spec

        def spec(group, itemsize):
            out = real_spec(group, itemsize)
            shapes = getattr(_SHAPES, "shapes", None)
            if shapes is not None:
                shapes.append([sum(len(p[3]) for p in group), out.E_pad, out.W_pad,
                               out.M_pad])
            return out

        spec.recording = True
        F._make_spec = spec
    batches = []
    real_solve, real_submit, real_complete = (svc._solve_fleet, svc.submit_admitted,
                                              svc.complete_ticket)

    def solve(items, *args, **kw):
        comp = {}
        for it in items:
            k = int(it.trace_key.split(":")[1])
            if k not in comp.setdefault(it.tenant, []):
                comp[it.tenant].append(k)
        batches.append(comp)
        _SHAPES.shapes = comp["shapes"] = []
        try:
            return real_solve(items, *args, **kw)
        finally:
            _SHAPES.shapes = None

    def submit(plan):
        ticket = real_submit(plan)
        if ticket is not None and events is not None:
            ks = [b.k for t, bufs in ticket.taken if t.id == "t0" for b in bufs]
            if ks:
                events.append(("submit", ticket.seq, ks))
        return ticket

    def complete(ticket):
        n = real_complete(ticket)
        if events is not None and any(t.id == "t0" for t, _ in ticket.taken):
            events.append(("complete", ticket.seq))
        return n

    svc._solve_fleet, svc.submit_admitted, svc.complete_ticket = solve, submit, complete
    return batches


def _metric_samples(text, name):
    """``{frozenset(labels): value}`` of one family in a Prometheus text."""
    import re

    out = {}
    for line in text.splitlines():
        m = re.match(r"^" + name + r"\{(.*)\} (\S+)$", line)
        if m:
            labels = frozenset(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
            out[labels] = float(m.group(2))
    return out


def serve_queries(base, service, card):
    """Phase step 2 over the shared run's server: trace list and fetch,
    both live queries, ``/metrics`` (the tenancy, devcols and WAL
    families, per-tenant counters equal to ``/api/v1/stats``) and
    ``/readyz`` (200, then 503 after ``begin_drain``). Returns what
    failed."""
    failed = []
    code, out, _ = _http("GET", f"{base}/api/v1/tenants/t0/traces?limit=5")
    traces = json.loads(out)
    code2, rec, _ = _http("GET", f"{base}/api/v1/tenants/t0/traces/{traces['trace_ids'][-1]}")
    rec = json.loads(rec)
    code3, culprit, _ = _http("GET", f"{base}/api/v1/tenants/t0/query/delay_culprit"
                                     "?percentile=0.95")
    culprit = json.loads(culprit)
    code4, low, _ = _http("GET", f"{base}/api/v1/tenants/t0/query/low_confidence?limit=3")
    low = json.loads(low)
    code5, metrics, _ = _http("GET", f"{base}/metrics")
    metrics = metrics.decode()
    code6, stats, _ = _http("GET", f"{base}/api/v1/stats")
    stats = json.loads(stats)
    if {code, code2, code3, code4, code5, code6} != {200}:
        failed.append(f"queries answered {code} {code2} {code3} {code4} {code5} {code6}")
    if culprit["empty"] or not rec.get("spans"):
        failed.append(f"delay culprit {culprit} / trace {str(rec)[:200]}")
    tenant_total = _metric_samples(metrics, "tw_serve_tenant_total")
    dispatch_total = _metric_samples(metrics, "tw_serve_dispatch_total")
    mismatch = []
    for tid, t in stats["tenants"].items():
        for key in ("consumed", "emitted_windows", "solved_windows", "spans_emitted",
                    "deadletter_windows", "shed_dropped_windows"):
            got = tenant_total.get(frozenset({("tenant", tid), ("key", key)}))
            if got != float(t[key]):
                mismatch.append((tid, key, got, t[key]))
    for key, v in stats["dispatch"].items():
        if dispatch_total.get(frozenset({("kind", key)})) != float(v):
            mismatch.append(("dispatch", key, dispatch_total.get(frozenset({("kind", key)})), v))
    families = {f: f in metrics for f in (
        "tw_serve_tenant_total", "tw_serve_dispatch_total", "tw_serve_tenant_ledger_total",
        "tw_devcols_ring_fill", "tw_devcols_events_total", "tw_tenant_windows_total",
        'key="wal_appends"', "tw_serve_admission_total")}
    code7, ready, _ = _http("GET", f"{base}/readyz")
    service.begin_drain()
    code8, _, _ = _http("GET", f"{base}/readyz")
    print("serve-queries " + json.dumps(dict(
        config="serve-cg-4t", traces_listed=traces["n_traces"],
        trace_spans=rec.get("n_spans"), trace_complete=rec.get("complete"),
        delay_culprit=dict(worst_service=culprit["worst_service"],
                           n_bracket=culprit["n_bracket"]),
        low_confidence=dict(n_scored=low["n_scored"], n_low=low["n_low"]),
        metrics_families=families, metrics_vs_stats_mismatches=mismatch,
        readyz=[code7, json.loads(ready), code8], card=card)), flush=True)
    if mismatch:
        failed.append(f"/metrics and /api/v1/stats part: {mismatch[:5]}")
    if not all(families.values()):
        failed.append(f"/metrics lacks {[f for f, ok in families.items() if not ok]}")
    if (code7, code8) != (200, 503):
        failed.append(f"/readyz answered {code7} then {code8}")
    return failed


def serve_kill_resume(bodies, root, card):
    """Phase step 4: ``cli serve --no-continuous`` in a subprocess on the
    card; half of ``t0``'s bodies, SIGKILL after their acks, a restart
    with ``--resume``, the rest, a flush, SIGTERM. Returns the sink path
    and what failed."""
    import signal

    state = os.path.join(root, "serve-killed")
    argv = [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "serve",
            "--port", "0", "--state-dir", state, "--no-continuous", "--fix", "5",
            "--window_s", "20", "--overlap_s", "4", "--watermark_s", "2", "--grace_s", "0"]
    failed, half = [], len(bodies) // 2

    def start(extra):
        proc = subprocess.Popen(argv + extra, cwd=HERE, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        for line in proc.stdout:
            if "listening on http://" in line:
                url = line.split("listening on ")[1].split()[0]
                threading.Thread(target=proc.stdout.read, daemon=True).start()
                return proc, url
        proc.wait()
        raise AssertionError(f"cli serve exited {proc.returncode} before listening")

    t0 = time.perf_counter()
    proc, base = start([])
    try:
        _post_all(base, "t0", bodies[:half])
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait()
    proc, base = start(["--resume"])
    try:
        _post_all(base, "t0", bodies[half:], first=half)
        code, _, _ = _http("POST", f"{base}/api/v1/flush")
        if code != 200:
            failed.append(f"flush after resume answered {code}")
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    if rc != 0:
        failed.append(f"the resumed server's SIGTERM drain exited {rc}")
    return os.path.join(state, "t0", "traces.jsonl"), time.perf_counter() - t0, failed


def serve_phase(card, root, corpus=None):
    """Config ``serve-cg-4t`` through the port's serve tier on the card
    (see the module docstring, phase serve); ``corpus`` (a
    :class:`SynthJob`) is the corpus synthesized beside the earlier
    phases. Returns the shared run's launches, its largest K1 block and
    what :func:`rerun_checks` needs."""
    import torch

    from traceweaver_tpu_torch.ops import devcols as DC
    from traceweaver_tpu_torch.serve import TenantService, make_server

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    if corpus is None:
        with SynthJob(os.path.join(root, "serve")) as job:
            dirs, bodies, truths = job.result()
    else:
        dirs, bodies, truths = corpus.result()
    synth_s = time.perf_counter() - t0

    # 1. the shared run, over HTTP on loopback
    DC.get_store().clear()
    state = os.path.join(root, "serve-shared")
    service = TenantService(_serve_cfg(state, True), device="cuda")
    events = []
    batches = _record_batches(service, events)
    server = make_server(service, port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.port}"
    posts = {}

    def traffic():
        threads = []
        for i, tid in enumerate(SERVE_TENANTS):
            th = threading.Thread(target=lambda i=i, tid=tid: posts.__setitem__(
                tid, _post_all(base, tid, bodies[i])))
            threads.append(th)
            th.start()
        for th in threads:
            th.join()
        code, _, _ = _http("POST", f"{base}/api/v1/flush")
        if code != 200:
            raise AssertionError(f"flush answered {code}")
        while service.total_backlog() or service.in_flight_windows():
            time.sleep(0.02)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    captured, ill, c = {}, {}, {}
    t_run = time.perf_counter()
    with ServeRows() as rows_shared:
        drive(traffic, True, captured, largest=True, ill=ill, counts=c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_run
        ill_shared = rows_shared.ids()
    peak = torch.cuda.max_memory_allocated() - mem0
    if len(posts) != len(SERVE_TENANTS):
        raise AssertionError(f"serve: client threads posted {posts}")
    st = service.stats()
    rings = DC.get_store().rings()
    appended = sum(r.appended_rows for r in rings)
    failed = serve_queries(base, service, card)
    server.shutdown()
    server.server_close()
    service.drain()
    fleet = st["fleet"]
    accs, tenant_lines = {}, {}
    ingested = 0
    for i, tid in enumerate(SERVE_TENANTS):
        t = st["tenants"][tid]
        accs[tid] = serve_sink_accuracy(os.path.join(state, tid, "traces.jsonl"), truths[i])
        ill_t = sum(1 for (key, _) in ill_shared if key.startswith(tid + ":"))
        ingested += int(t["counters"].get("ingested_spans", 0))
        tenant_lines[tid] = dict(
            posts=posts[tid], spans_ingested=int(t["counters"].get("ingested_spans", 0)),
            windows_sealed=t["solved_windows"] + t["backlog"],
            windows_emitted=t["emitted_windows"], spans_emitted=t["spans_emitted"],
            traces_emitted=t["traces_emitted"], late_dropped=t["late_dropped"],
            deadletter_windows=t["deadletter_windows"],
            shed_dropped_windows=t["shed_dropped_windows"], shed_spilled=t["shed_spilled"],
            seal_emit_p99_ms=t["seal_emit_p99_ms"], e2e=accs[tid]["e2e"],
            e2e_jax=SERVE_JAX["shared"][tid]["e2e"],
            e2e_jax_resident=SERVE_JAX["shared_resident"][tid]["e2e"],
            per_service=accs[tid]["per_service"],
            ill_posed_service_windows=ill_t,
            packed=fleet.get("tenant_windows_packed", {}).get(tid),
            decoded=fleet.get("tenant_windows_decoded", {}).get(tid))
    line = dict(
        config="serve-cg-4t", device=st["device"], precision=st["precision"],
        tenants=tenant_lines, shared_solves=st["dispatch"]["shared_solves"],
        tenant_batches=st["dispatch"]["tenant_batches"],
        fleet_dispatches=st["dispatch"]["fleet_dispatches"],
        tickets_submitted=st["ring"]["submitted"], tickets_completed=st["ring"]["completed"],
        overlap_pct=st["ring"]["overlap_pct"],
        h2d_bytes_ring=fleet.get("h2d_bytes_ring", 0.0),
        h2d_bytes_index=fleet.get("h2d_bytes_index", 0.0),
        h2d_bytes_shipped=fleet.get("h2d_bytes_shipped", 0.0),
        devcols_fallbacks=fleet.get("devcols_fallbacks", 0.0),
        ring_rows_appended=appended, spans_ingested=ingested,
        rings=len(rings), ring_fill_max=max((r.live / r.cap for r in rings), default=0.0),
        wall_s=wall, spans_per_s=ingested / wall,
        fused_assign_launches=c["fused_assign"], assemble_block_launches=c["assemble_block"],
        plain_assembly_on_card=c["plain_assembly_on_card"],
        ill_posed_windows=ill["ill_posed_windows"], k1_windows=ill["windows"],
        largest_block=list(captured["block"]["S"].shape), peak_mem_bytes=peak,
        synthesize_s=synth_s, card=card)
    print("serve " + json.dumps(line), flush=True)
    print("serve-batches " + json.dumps(dict(
        config="serve-cg-4t", run="shared", solves=batches)), flush=True)
    for tid, t in tenant_lines.items():
        if t["windows_emitted"] + t["deadletter_windows"] != t["windows_sealed"]:
            failed.append(f"{tid}: {t['windows_emitted']} emitted + "
                          f"{t['deadletter_windows']} dead-lettered != {t['windows_sealed']}")
        if t["spans_emitted"] + t["late_dropped"] != t["spans_ingested"]:
            failed.append(f"{tid}: {t['spans_emitted']} spans emitted + {t['late_dropped']} "
                          f"late != {t['spans_ingested']} ingested")
        if t["deadletter_windows"] or t["shed_dropped_windows"]:
            failed.append(f"{tid}: {t['deadletter_windows']} dead-lettered, "
                          f"{t['shed_dropped_windows']} shed windows")
        if t["packed"] != t["decoded"]:
            failed.append(f"{tid}: tenant column packed {t['packed']} != decoded "
                          f"{t['decoded']}")
    if not line["tenant_batches"] > line["shared_solves"]:
        failed.append(f"no shared solve carried two tenants' windows: "
                      f"{line['tenant_batches']} batches in {line['shared_solves']} solves")
    if line["devcols_fallbacks"] or not line["h2d_bytes_index"] > 0:
        failed.append(f"devcols: {line['devcols_fallbacks']} fallbacks, "
                      f"{line['h2d_bytes_index']} index bytes")
    if appended > ingested:
        failed.append(f"the rings took {appended} rows for {ingested} spans ingested")
    if c["fused_assign"] <= 0 or c["assemble_block"] <= 0 or c["plain_assembly_on_card"]:
        failed.append(f"serving launched K1 {c['fused_assign']} and the assembly kernel "
                      f"{c['assemble_block']} times, the plain assembly "
                      f"{c['plain_assembly_on_card']} times on the card")

    # 4., started here to run beside step 3 (both under the fixed pump)
    from concurrent.futures import ThreadPoolExecutor

    beside = ThreadPoolExecutor(1)
    kill_resume = beside.submit(serve_kill_resume, bodies[0], root, card)
    beside.shutdown(wait=False)
    # 3. t0 alone under the fixed pump, devcols on then off; then under a
    # pump of one window, the run the CPU rerun repeats
    on_path, on_st, on_wall, on_batches = serve_alone(
        bodies[0], os.path.join(root, "serve-alone-on"), "cuda")
    off_path, off_st, off_wall, off_batches = serve_alone(
        bodies[0], os.path.join(root, "serve-alone-off"), "cuda", devcols=False)
    with open(on_path, "rb") as f:
        on_bytes = f.read()
    with open(off_path, "rb") as f:
        off_bytes = f.read()
    alone = serve_sink_accuracy(on_path, truths[0])
    one_path, one_st, one_wall, _ = serve_alone(
        bodies[0], os.path.join(root, "serve-alone-pump1"), "cuda", pump_windows=1)
    alone1 = serve_sink_accuracy(one_path, truths[0])
    # the same tenant with the shared run's batches, for shared-against-alone
    with ServeRows() as rows_replay:
        rep_path, rep_st, rep_wall, rep_batches = serve_alone(
            bodies[0], os.path.join(root, "serve-alone-replay"), "cuda", plan=events)
        ill_replay = rows_replay.ids()
    replay = serve_sink_accuracy(rep_path, truths[0])
    ill_t0 = {k: v | ill_replay.get(k, set()) for k, v in ill_shared.items()}
    for k, v in ill_replay.items():
        ill_t0.setdefault(k, v)
    shared_vs_replay = rows_agreement(accs["t0"], replay, ill_t0, "t0")
    shared_vs_pump = rows_agreement(accs["t0"], alone, ill_t0, "t0")
    print("serve-alone " + json.dumps(dict(
        config="serve-cg-4t", tenant="t0", pump_windows=SERVE_SETTINGS["pump_windows"],
        devcols_on=dict(e2e=alone["e2e"], per_service=alone["per_service"], wall_s=on_wall,
                        fleet_dispatches=on_st["dispatch"]["fleet_dispatches"],
                        devcols_fallbacks=on_st["fleet"].get("devcols_fallbacks", 0.0),
                        h2d_bytes_ring=on_st["fleet"].get("h2d_bytes_ring", 0.0),
                        h2d_bytes_shipped=on_st["fleet"].get("h2d_bytes_shipped", 0.0)),
        devcols_off=dict(wall_s=off_wall,
                         h2d_bytes_shipped=off_st["fleet"].get("h2d_bytes_shipped", 0.0)),
        sinks_identical=on_bytes == off_bytes, sink_bytes=len(on_bytes),
        e2e_jax=SERVE_JAX["alone"]["t0"]["e2e"],
        e2e_jax_resident=SERVE_JAX["alone_resident"]["t0"]["e2e"],
        pump1=dict(e2e=alone1["e2e"], per_service=alone1["per_service"], wall_s=one_wall,
                   fleet_dispatches=one_st["dispatch"]["fleet_dispatches"],
                   e2e_jax=SERVE_JAX["alone1"]["t0"]["e2e"]),
        replay_of_shared_batches=dict(e2e=replay["e2e"], wall_s=rep_wall),
        shared_vs_replay_rows=shared_vs_replay, shared_vs_pump_rows=shared_vs_pump,
        shared_vs_pump_rows_jax=SERVE_JAX["shared_vs_alone_rows"],
        rows_left_out_ill_posed=sum(len(v) for k, v in ill_t0.items()
                                    if k[0].startswith("t0:")),
        card=card)), flush=True)
    print("serve-batches " + json.dumps(dict(
        config="serve-cg-4t", run="t0-alone", solves=on_batches,
        replay_solves=rep_batches, replay_events=events)), flush=True)
    if on_bytes != off_bytes:
        failed.append("t0 alone: the devcols-on and devcols-off sinks part")
    if abs(alone["e2e"] - SERVE_JAX["alone"]["t0"]["e2e"]) > ILL_POSED_MAX_PT:
        failed.append(f"t0 alone: {alone['e2e']} not within {ILL_POSED_MAX_PT} pt of JAX "
                      f"{SERVE_JAX['alone']['t0']['e2e']}")
    low = {s: v for s, v in shared_vs_replay.items() if v < 0.99}
    if low:
        failed.append(f"t0 shared against alone (the same batches): rows under 0.99 {low}")

    # 4. hard death and WAL replay in a subprocess
    killed_path, kill_wall, kill_failed = kill_resume.result()
    failed += kill_failed
    with open(killed_path, "rb") as f:
        killed_bytes = f.read()
    print("serve-resume " + json.dumps(dict(
        config="serve-cg-4t", tenant="t0", killed_after_posts=len(bodies[0]) // 2,
        sink_bytes=len(killed_bytes), sink_identical=killed_bytes == on_bytes,
        wall_s=kill_wall, card=card)), flush=True)
    if killed_bytes != on_bytes:
        failed.append("the killed-and-resumed server's sink parts from t0 alone's")

    # 5. accuracy
    for tid in SERVE_TENANTS:
        ref = SERVE_JAX["shared"][tid]["e2e"]
        limit = ILL_POSED_MAX_PT if tenant_lines[tid]["ill_posed_service_windows"] else 0.5
        if abs(accs[tid]["e2e"] - ref) > limit:
            failed.append(f"{tid}: {accs[tid]['e2e']} not within {limit} pt of JAX {ref}")
    if failed:
        raise AssertionError("serve: " + "; ".join(failed))
    print(f"serve-phase: {time.perf_counter() - t_phase:.3f} s wall", flush=True)
    launches = dict(fused_assign=c["fused_assign"], assemble_block=c["assemble_block"])
    fleet_ref = dict(t0_bytes=on_bytes, ill={
        tid: tenant_lines[tid]["ill_posed_service_windows"] for tid in SERVE_TENANTS})
    return launches, captured["block"], (dirs[0], alone1, ill["ill_posed_windows"]), fleet_ref


def _synthesize_serve(out):
    sys.path.insert(0, HERE)
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    dirs = synthesize_corpus(out, **SERVE_CORPUS)
    return dirs, [serve_bodies(d) for d in dirs], [serve_truth(d) for d in dirs]


class SynthJob(StreamRerun):
    """``serve-cg-4t``'s corpus synthesized in a spawned process of its
    own; :meth:`result` waits for its graph directories, POST bodies and
    ground truths."""

    def __init__(self, out):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.job = self.pool.apply_async(_synthesize_serve, (out,))


# the corpora of the executor, ladder and stream phases, by the name of
# their directory under the smoke's root, in the order CorpusJobs makes
# them; None is the messy ladder corpus (ladder.ensure_corpus)
CORPORA = {
    "exp5": dict(n_graphs=15, traces_per_graph=1000, seed=10),
    "cg8k": dict(n_graphs=1, traces_per_graph=8192, seed=10),
    "exp5-hard": None,
    "stream": STREAM_CORPUS,
}


def synthesize(root, name):
    """Corpus ``name`` of ``CORPORA`` synthesized under ``root``; returns
    its graph directories and the seconds it took."""
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    out = os.path.join(root, name)
    if CORPORA[name] is None:
        from traceweaver_tpu_torch.runtime.ladder import ensure_corpus

        dirs = ensure_corpus(out, True)
    else:
        from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

        dirs = synthesize_corpus(out, **CORPORA[name])
    return dirs, time.perf_counter() - t0


class CorpusJobs(StreamRerun):
    """Every corpus of ``CORPORA`` synthesized under ``root``, one after
    another in a spawned process of their own beside the first card
    phases, then ``r100k`` built into the campaign cache ``root/campaign``
    (:func:`_build_r100k`); :meth:`get` waits for one."""

    def __init__(self, root):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.jobs = {name: self.pool.apply_async(synthesize, (root, name))
                     for name in CORPORA}
        self.jobs["r100k"] = self.pool.apply_async(
            _build_r100k, (os.path.join(root, "campaign"),))

    def get(self, name):
        return self.jobs[name].get()


def corpus_dirs(root, name, corpora=None):
    """:func:`synthesize`'s result for ``name``: from ``corpora`` (a
    :class:`CorpusJobs`) when given, else made here."""
    return corpora.get(name) if corpora is not None else synthesize(root, name)


def cpu_serve(graph_dir, threads):
    """Worker: tenant ``t0`` of ``serve-cg-4t`` alone under a pump of one
    window on the CPU, on ``threads`` threads; returns its sink accuracy
    and rows. ``graph_dir`` None synthesizes graph 0 first."""
    sys.path.insert(0, HERE)
    import tempfile

    import torch

    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    torch.set_num_threads(threads)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        if graph_dir is None:
            # graph 0 is the same graph whatever the graph count
            (graph_dir,) = synthesize_corpus(os.path.join(tmp, "corpus"),
                                             **dict(SERVE_CORPUS, n_graphs=1))
        path, _, _, _ = serve_alone(serve_bodies(graph_dir), os.path.join(tmp, "s"), "cpu",
                                    pump_windows=1)
        acc = serve_sink_accuracy(path, serve_truth(graph_dir))
    acc["wall_s"] = time.perf_counter() - t0
    return acc


class ServeRerun(StreamRerun):
    """:func:`cpu_serve` in a spawned process of its own, on two threads,
    like :class:`StreamRerun`."""

    def __init__(self, graph_dir, threads: int = 2):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.job = self.pool.apply_async(cpu_serve, (graph_dir, threads))


def serve_verdict(card, serve, cpu):
    """The C.1 rule for a serve run whose card met ill-posed windows: the
    port's CPU run of ``t0`` alone under a pump of one window equals
    JAX's (or the recorded ``SERVE_PORT_CPU``) exactly, and the card's
    same run reads JAX within ``ILL_POSED_MAX_PT`` with >=
    ``ILL_POSED_MIN_PAIRS`` of every service's rows equal to the CPU
    run's. Returns what failed."""
    _, card_alone, ill = serve
    ref = SERVE_JAX["alone1"]["t0"]["e2e"]
    want = SERVE_PORT_CPU if SERVE_PORT_CPU is not None else ref
    pairs = rows_agreement(cpu, card_alone)
    low = {s: v for s, v in pairs.items() if v < ILL_POSED_MIN_PAIRS}
    print("serve-card-vs-cpu " + json.dumps(dict(
        config="serve-cg-4t", tenant="t0", pump_windows=1, alone_card=card_alone["e2e"],
        alone_cpu=cpu["e2e"], alone_jax_cpu=ref, alone_cpu_recorded=SERVE_PORT_CPU,
        card_ill_posed_windows=ill, cpu_wall_s=cpu["wall_s"], card_vs_cpu_rows=pairs,
        rule=f"CPU equals {'the recorded port CPU' if SERVE_PORT_CPU else 'JAX'}, card "
             f"within {ILL_POSED_MAX_PT} pt of JAX, >= {ILL_POSED_MIN_PAIRS} rows",
        card=card)), flush=True)
    if cpu["e2e"] != want:
        return f"serve: the port on the CPU reads {cpu['e2e']}, not {want} (JAX {ref})"
    if abs(card_alone["e2e"] - ref) > ILL_POSED_MAX_PT or low:
        return (f"serve: t0 alone on the card {card_alone['e2e']} vs JAX {ref}, rows "
                f"under {ILL_POSED_MIN_PAIRS} {low}, with {ill} ill-posed windows")
    return ""


def _fleet_client(base, tenant, bodies, acked, before=None, first=0):
    """A fleet client: POST bodies ``first`` on in order through the
    router with each body's index as ``X-TW-Seq`` (a retry of a lost ack
    dedups), as fast as acks return, waiting out 429s and 503s (a replica
    being recovered) by their ``Retry-After``; ``before(i)`` runs before
    body ``i``."""
    url = f"{base}/api/v1/tenants/{tenant}/spans"
    for i in range(first, len(bodies)):
        if before is not None:
            before(i)
        while True:
            code, out, hdr = _http("POST", url, bodies[i], headers={"X-TW-Seq": str(i)})
            if code not in (429, 503):
                break
            time.sleep(min(5.0, float(hdr.get("Retry-After") or 1.0)))
        if code != 200:
            raise AssertionError(f"fleet POST {tenant} body {i}: {code} {out[:300]!r}")
        acked[tenant] = i + 1


def _start_replicas(root, args, n=2):
    """``n`` ``cli serve`` replica processes on the card, started at once,
    each slot's processes appending their events to ``r<i>.events.jsonl``
    in ``root``."""
    from concurrent.futures import ThreadPoolExecutor

    from traceweaver_tpu_torch.fleet_serve import ReplicaProcess

    reps = [ReplicaProcess(f"r{i}", os.path.join(root, f"r{i}"),
                           serve_args=args + ["--events",
                                              os.path.join(root, f"r{i}.events.jsonl")],
                           startup_timeout_s=300.0) for i in range(n)]
    with ThreadPoolExecutor(n) as pool:
        futs = [pool.submit(r.start) for r in reps]
        errors = [f.exception() for f in futs]
    if any(errors):
        for r in reps:
            r.stop(timeout_s=30.0)
        raise AssertionError(f"fleet: replicas failed to start: {errors}")
    return reps


def _fleet_stats(fleet):
    """Every replica's ``/api/v1/stats`` (the router's fan-out)."""
    st = fleet.router.fleet_stats(include_replicas=True)
    bad = {n: s["error"] for n, s in st["replica_stats"].items() if "error" in s}
    if bad:
        raise AssertionError(f"fleet: replica stats failed: {bad}")
    return st


def _fleet_wait(fleet, drained, timeout_s=600.0):
    """Poll the replicas until no window is queued or in flight (and,
    ``drained``, every ingested trace emitted); returns the last stats."""
    deadline = time.monotonic() + timeout_s
    while True:
        st = _fleet_stats(fleet)
        reps = st["replica_stats"].values()
        tenants = [t for s in reps for t in s["tenants"].values()]
        idle = all(s["total_backlog"] == 0 and s["ring"]["outstanding"] == 0 for s in reps)
        if idle and (not drained or all(
                t["traces_emitted"] == t["counters"].get("ingested_traces", 0)
                for t in tenants)):
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"fleet: not drained after {timeout_s:.0f} s")
        time.sleep(0.25)


class _Launches:
    """Each replica slot's kernel counters summed over its processes: a
    process's ``kernels`` block is banked before it stops (a SIGKILL, a
    rolling restart, the final drain)."""

    KEYS = ("fused_assign", "sinkhorn", "assemble_block")

    def __init__(self, fleet):
        self.fleet = fleet
        self.by = {name: dict.fromkeys(self.KEYS, 0) for name in fleet.replicas}

    def bank(self, name):
        from traceweaver_tpu_torch.fleet_serve.router import http_json

        code, st = http_json("GET", self.fleet.router.replicas[name].base_url
                             + "/api/v1/stats", timeout=300)
        if code != 200:
            raise AssertionError(f"fleet: {name} stats answered {code}")
        for k in self.KEYS:
            self.by[name][k] += int(st["kernels"][k])

    def bank_all(self):
        for name in self.by:
            self.bank(name)


def _fleet_balance(fleet):
    """Live-migrate tenants from the fuller replica until each holds the
    same count (the campaign's ``_rebalance``, to two tenants each)."""
    moved = []
    while True:
        place = {n: fleet.replica_tenants(n) for n in sorted(fleet.replicas)}
        full = max(place, key=lambda n: len(place[n]))
        empty = min(place, key=lambda n: len(place[n]))
        if len(place[full]) - len(place[empty]) < 2:
            return moved
        tid = sorted(place[full])[-1]
        fleet.migrate(tid, empty)
        moved.append((tid, empty))


def _sink_traces(path):
    """Trace ids of a sink's records, with repeats."""
    ids = []
    with open(path) as f:
        for line in f:
            ids.extend(json.loads(line)["traces"])
    return ids


def fleet_shared_run(card, root, bodies, truths, ill):
    """Leg 1 of the fleet phase (see the module docstring): returns the
    ``fleet`` line and what failed."""
    import signal

    from traceweaver_tpu_torch.fleet_serve import FleetManager

    t_leg = time.perf_counter()
    state = os.path.join(root, "fleet-shared")
    reps = _start_replicas(state, FLEET_REPLICA_ARGS)
    cold_s = time.perf_counter() - t_leg
    fleet = FleetManager(reps, router_port=0, supervise=True)
    base, acked, failed = fleet.base_url, {}, []
    launches = _Launches(fleet)
    migrated, killed = threading.Event(), {}
    try:
        t_run = time.perf_counter()
        for i, tid in enumerate(SERVE_TENANTS):
            _fleet_client(base, tid, bodies[i][:1], acked)
        # each replica holds two tenants before the clients start
        balanced = _fleet_balance(fleet)

        def t0_hook(i):
            if i == FLEET_MIGRATE_AT:
                src = fleet.router.owner("t0")
                dst = next(n for n in sorted(fleet.replicas) if n != src)
                killed["migration"] = fleet.migrate("t0", dst)
                migrated.set()

        def kill_t1():
            victim = fleet.router.owner("t1")
            launches.bank(victim)
            time.sleep(0.05)  # t1's body is on its way
            fleet.replicas[victim].proc.send_signal(signal.SIGKILL)
            killed.update(victim=victim, at=time.perf_counter() - t_run)

        def t1_hook(i):
            if i == FLEET_KILL_AT:
                migrated.wait(timeout=FLEET_WAIT_S)
                threading.Thread(target=kill_t1, daemon=True).start()

        hooks = dict(t0=t0_hook, t1=t1_hook)
        errors = {}

        def client(i, tid):
            try:
                _fleet_client(base, tid, bodies[i], acked, before=hooks.get(tid), first=1)
            except Exception as e:  # noqa: BLE001 - reported below
                errors[tid] = f"{type(e).__name__}: {e}"

        threads = [threading.Thread(target=client, args=(i, tid))
                   for i, tid in enumerate(SERVE_TENANTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        post_wall = time.perf_counter() - t_run
        if errors:
            raise AssertionError(f"fleet clients: {errors}")
        deadline = time.monotonic() + FLEET_WAIT_S
        while fleet.router.counters["respawns"] + fleet.router.counters["failovers"] < 1:
            if time.monotonic() > deadline:
                raise AssertionError("fleet: the killed replica was never recovered")
            time.sleep(0.2)
        _fleet_wait(fleet, drained=False)
        launches.bank_all()
        t_rr = time.perf_counter()
        fleet.rolling_restart()
        restart_s = time.perf_counter() - t_rr
        code, _, _ = _http("POST", base + "/api/v1/flush")
        if code != 200:
            failed.append(f"the fleet's flush answered {code}")
        st = _fleet_wait(fleet, drained=True)
        wall = time.perf_counter() - t_run
        launches.bank_all()
        owners = {tid: fleet.router.owner(tid) for tid in SERVE_TENANTS}
        counters = dict(fleet.router.counters)
        recoveries = list(fleet.recoveries)
    finally:
        fleet.stop()
    rcs = {r.name: r.proc.returncode for r in reps}
    if any(rcs.values()):
        failed.append(f"the replicas' SIGTERM drains exited {rcs}")
    tenants, ingested, accs = {}, 0, {}
    for i, tid in enumerate(SERVE_TENANTS):
        t = st["replica_stats"][owners[tid]]["tenants"][tid]
        path = os.path.join(state, owners[tid], tid, "traces.jsonl")
        acc = accs[tid] = serve_sink_accuracy(path, truths[i])
        ids = _sink_traces(path)
        spans = int(t["counters"].get("ingested_spans", 0))
        ingested += spans
        ref = SERVE_JAX["shared"][tid]["e2e"]
        limit = ILL_POSED_MAX_PT if ill[tid] else 0.5
        tenants[tid] = dict(
            replica=owners[tid], posts=acked.get(tid, 0),
            traces_ingested=int(t["counters"].get("ingested_traces", 0)),
            traces_emitted=t["traces_emitted"], spans_ingested=spans,
            spans_emitted=t["spans_emitted"], sink_traces=len(ids),
            sink_traces_repeated=len(ids) - len(set(ids)),
            deadletter_windows=t["deadletter_windows"],
            shed_dropped_windows=t["shed_dropped_windows"], late_dropped=t["late_dropped"],
            e2e=acc["e2e"], e2e_jax=ref, rule_pt=limit,
            serve_ill_posed_service_windows=ill[tid], per_service=acc["per_service"])
        n_traces = sum(len(json.loads(b)["data"]) for b in bodies[i])
        if len(set(ids)) != n_traces or len(ids) != n_traces:
            failed.append(f"{tid}: the sink holds {len(set(ids))} traces ({len(ids)} "
                          f"records) of {n_traces}")
        if (t["deadletter_windows"] or t["shed_dropped_windows"] or t["late_dropped"]
                or t["traces_emitted"] != n_traces or acked.get(tid) != len(bodies[i])):
            failed.append(f"{tid}: {tenants[tid]}")
        if abs(acc["e2e"] - ref) > limit:
            failed.append(f"{tid}: {acc['e2e']} not within {limit} pt of JAX {ref}")
    for name, k in launches.by.items():
        # each K1 launch solves a block the assembly kernel built: fewer
        # assembly launches than K1's would be blocks built another way
        if not k["assemble_block"] >= k["fused_assign"] > 0:
            failed.append(f"replica {name}: {k}")
    if counters["respawns"] < 1 or counters["migrations"] < 1 + len(balanced):
        failed.append(f"router counters {counters}")
    line = dict(
        config="fleet-cg-4t-2r", replicas=len(reps), tenants=tenants,
        replica_launches=launches.by, router=counters,
        balance_migrations=balanced, t0_migration=killed.get("migration"),
        killed=dict(replica=killed.get("victim"), at_s=killed.get("at")),
        recoveries=recoveries, respawn_s=[r["wall_s"] for r in recoveries
                                          if r["mode"] == "respawn"],
        failover_s=[r["wall_s"] for r in recoveries if r["mode"] == "failover"],
        cold_start_s=cold_s, post_wall_s=post_wall, rolling_restart_s=restart_s,
        wall_s=wall, spans_ingested=ingested, spans_per_s=ingested / wall,
        leg_wall_s=time.perf_counter() - t_leg, card=card)
    return line, failed, accs["t0"]


def fleet_t0_plan(state):
    """``t0``'s ring tickets in the shared run, from its replicas' event
    sinks, in time order, as :func:`serve_alone`'s plan (keyed by process
    and sequence). A window solved twice (in flight on the SIGKILLed
    process, solved again after the respawn's replay) keeps its last
    ticket, whose rows the sink holds; tickets left with no ``t0`` window,
    or never completed, are dropped. Returns the plan and the tickets'
    counts."""
    recs, torn = [], 0
    for name in sorted(os.listdir(state)):
        if not name.endswith(".events.jsonl"):
            continue
        with open(os.path.join(state, name)) as f:
            for ln in f:
                try:
                    r = json.loads(ln)
                except ValueError:
                    torn += 1  # a line cut by the SIGKILL
                    continue
                if r.get("event") in ("ring_ticket_submitted", "ring_ticket_completed") \
                        and r["windows"].get("t0"):
                    recs.append(r)
    recs.sort(key=lambda r: r["ts"])  # stable: a file's own order stands
    done = {(r["pid"], r["seq"]) for r in recs if r["event"] == "ring_ticket_completed"}
    subs = [r for r in recs if r["event"] == "ring_ticket_submitted"
            and (r["pid"], r["seq"]) in done]
    last = {k: i for i, r in enumerate(subs) for k in r["windows"]["t0"]}
    ks = {(r["pid"], r["seq"]): [k for k in r["windows"]["t0"] if last[k] == i]
          for i, r in enumerate(subs)}
    plan = []
    for r in recs:
        key = (r["pid"], r["seq"])
        if not ks.get(key):
            continue
        plan.append(("submit", f"{key[0]}:{key[1]}", ks[key])
                    if r["event"] == "ring_ticket_submitted" else
                    ("complete", f"{key[0]}:{key[1]}"))
    n_submitted = sum(1 for r in recs if r["event"] == "ring_ticket_submitted")
    tickets = dict(torn_lines=torn, completed=len(subs), kept=sum(map(bool, ks.values())),
                   never_completed=n_submitted - len(subs),
                   windows_solved_again=sum(len(r["windows"]["t0"]) for r in subs) - len(last))
    return plan, tickets


def fleet_replay(card, root, bodies, truths, fleet_t0):
    """``t0`` alone in this process with the fleet shared run's batches
    (:func:`fleet_t0_plan`), as the serve phase replays its shared run:
    the fleet's rows must equal the replay's on at least 0.99 of each
    service's rows outside ill-posed windows, so that the fleet's
    reading is the solver's on those batches, not a fault of a migration,
    a respawn or the rolling restart. Returns the ``fleet-replay`` line
    and what failed."""
    plan, tickets = fleet_t0_plan(os.path.join(root, "fleet-shared"))
    if not plan:
        return (dict(config="fleet-cg-4t-2r", tickets=tickets),
                ["fleet-replay: no t0 ticket in the replicas' events"])
    with ServeRows() as rows:
        path, _, wall, batches = serve_alone(bodies[0], os.path.join(root, "fleet-replay"),
                                             "cuda", plan=plan)
        ill = rows.ids()
    replay = serve_sink_accuracy(path, truths[0])
    agree = rows_agreement(fleet_t0, replay, ill, "t0")
    line = dict(config="fleet-cg-4t-2r", tenant="t0", tickets=tickets,
                solves=len(batches), e2e_fleet=fleet_t0["e2e"], e2e_replay=replay["e2e"],
                fleet_vs_replay_rows=agree,
                rows_left_out_ill_posed=sum(len(v) for v in ill.values()), wall_s=wall,
                card=card)
    low = {svc: v for svc, v in agree.items() if v < 0.99}
    return line, ([f"fleet-replay: t0's rows under 0.99 of the replay's {low}"]
                  if low else [])


def fleet_pin_leg(root, bodies, ref_bytes, failover):
    """Leg 2 of the fleet phase: ``t0`` alone under the kill/resume leg's
    settings on replica A for half its bodies, then moved to replica B by
    a live migration, or (``failover``) by a SIGKILL of A with no respawn
    budget, so the survivor failover rebuilds it from A's disk; the rest
    of its bodies, a flush. Returns the leg's line and what failed."""
    import signal

    from traceweaver_tpu_torch.fleet_serve import FleetManager

    t_leg = time.perf_counter()
    tag = "failover" if failover else "migrate"
    state = os.path.join(root, f"fleet-{tag}")
    reps = _start_replicas(state, FLEET_PUMP_ARGS)
    fleet = FleetManager(reps, router_port=0, supervise=failover, respawn_max=0)
    half, acked, failed = len(bodies) // 2, {}, []
    try:
        src = fleet.router.owner("t0")
        dst = next(n for n in sorted(fleet.replicas) if n != src)
        _fleet_client(fleet.base_url, "t0", bodies[:half], acked)
        # half its bodies acknowledged, none in flight: move it
        t_move = time.perf_counter()
        if failover:
            fleet.replicas[src].proc.send_signal(signal.SIGKILL)
            deadline = time.monotonic() + FLEET_WAIT_S
            while not fleet.failovers:
                if time.monotonic() > deadline:
                    raise AssertionError("fleet-failover: no failover")
                time.sleep(0.1)
            moved = fleet.failovers[0]
        else:
            moved = fleet.migrate("t0", dst)
        move_s = time.perf_counter() - t_move
        _fleet_client(fleet.base_url, "t0", bodies, acked, first=half)
        code, _, _ = _http("POST", fleet.base_url + "/api/v1/flush")
        if code != 200:
            failed.append(f"fleet-{tag}: flush answered {code}")
        owner = fleet.router.owner("t0")
        counters = dict(fleet.router.counters)
    finally:
        fleet.stop()
    with open(os.path.join(state, owner, "t0", "traces.jsonl"), "rb") as f:
        got = f.read()
    if owner != dst:
        failed.append(f"fleet-{tag}: t0 ended on {owner}, not {dst}")
    if got != ref_bytes:
        failed.append(f"fleet-{tag}: the sink parts from t0's unmigrated bytes")
    line = dict(config="fleet-cg-4t-2r", leg=tag, tenant="t0", moved_after_posts=half,
                src=src, dst=owner, move=moved, move_s=move_s, sink_bytes=len(got),
                sink_identical=got == ref_bytes, router=counters,
                wall_s=time.perf_counter() - t_leg)
    return line, failed


def fleet_campaign_start(root):
    """Leg 3 of the fleet phase, started: ``cli fleet campaign --mode
    subprocess`` at its defaults (rungs of 1 and 2 replicas, 6 s, 3
    tenants) with its replicas on the card, its artifact and output in
    ``root``. It runs beside legs 1 and 2."""
    out = os.path.join(root, "CAMPAIGN_fleet.json")
    log = open(os.path.join(root, "fleet-campaign.log"), "w+")
    proc = subprocess.Popen(
        [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "fleet", "campaign",
         "--mode", "subprocess", "--state-dir", os.path.join(root, "fleet-campaign"),
         "--out", out], cwd=HERE, stdout=log,
        stderr=subprocess.STDOUT, text=True, env={**os.environ, "PYTHONPATH": HERE})
    return proc, log, out, time.perf_counter()


def fleet_campaign_finish(card, started):
    """Wait for the campaign (:func:`fleet_campaign_start`). Returns the
    ``fleet-campaign`` line and what failed (its zero-loss gate fails the
    campaign, which then exits 1)."""
    proc, log, out, t0 = started
    try:
        rc = proc.wait(timeout=900)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    log.seek(0)
    text = log.read()
    log.close()
    if rc != 0 or not os.path.exists(out):
        tail = "\n".join(ln for ln in text.splitlines() if '" 200 -' not in ln)[-6000:]
        return dict(rc=rc, wall_s=wall), [f"fleet campaign exited {rc}: {tail}"]
    with open(out) as f:
        art = json.load(f)
    rungs, failed = [], []
    for r in art["rungs"]:
        fl = r["fleet"]
        rungs.append(dict(
            rung=r["rung"], spans_per_s=r["steady"]["spans_per_s"],
            spans=r["manifest"]["spans"], posts=r["manifest"]["posts"],
            e2e_pct=r["accuracy"]["e2e_pct"], zero_loss=fl["zero_loss"],
            steady_kernel_builds=r["steady"]["backend_compiles"],
            migrations=fl["migrations"], crash_kills=fl["crash_kills"],
            respawns=fl["respawns"], crash_failovers=fl["crash_failovers"],
            replicas_restarted=fl["replicas_restarted"],
            reset_midbody=fl["reset_midbody"], deduped_windows=fl["deduped_windows"],
            generator_503s=fl["generator_503s"], steady_wall_s=fl["steady_wall_s"],
            chaos_wall_s=fl["chaos_wall_s"], wall_s=fl["wall_s"],
            seal_emit_p99_ms=fl["seal_emit_p99_ms"], kernels_steady=fl["kernels_steady"]))
        if not fl["zero_loss"] or r["accuracy"]["e2e_pct"] != 100.0:
            failed.append(f"fleet campaign rung {r['rung']}: {rungs[-1]}")
        if not any(k.get("fused_assign", 0) > 0 for k in fl["kernels_steady"].values()):
            failed.append(f"fleet campaign rung {r['rung']}: no K1 launch in the steady phase")
    gate = "pass" if not failed else "fail"
    return dict(config="fleet-wire-campaign", rungs=rungs, gate=gate, wall_s=wall,
                artifact_wall_s=art["wall_s"], beside="legs 1 and 2", card=card), failed


def fleet_tier_phase(card, root, corpus=None, ref=None):
    """Config ``fleet-cg-4t-2r`` through the replica fleet tier on the card
    (see the module docstring, phase fleet). ``corpus`` is serve-cg-4t's
    (a :class:`SynthJob`), ``ref`` the serve phase's t0 bytes and
    per-tenant ill-posed windows (None: ``t0`` alone is served here for
    its bytes, and ``SERVE_ILL_POSED`` gives the rule). Returns the shared
    run's launches summed over its replicas."""
    t_phase = time.perf_counter()
    if corpus is None:
        with SynthJob(os.path.join(root, "fleet-corpus")) as job:
            _, bodies, truths = job.result()
    else:
        _, bodies, truths = corpus.result()
    if ref is None:
        path, _, _, _ = serve_alone(bodies[0], os.path.join(root, "fleet-alone"), "cuda")
        with open(path, "rb") as f:
            ref = dict(t0_bytes=f.read(), ill=dict(SERVE_ILL_POSED))
    # the campaign and the two byte-identity legs are fleets of their own:
    # the campaign runs beside the shared run, the legs side by side
    from concurrent.futures import ThreadPoolExecutor

    campaign = fleet_campaign_start(root)
    try:
        shared, failed, fleet_t0 = fleet_shared_run(card, root, bodies, truths, ref["ill"])
        print("fleet " + json.dumps(shared), flush=True)
        with ThreadPoolExecutor(3) as pool:
            legs = [pool.submit(fleet_pin_leg, root, bodies[0], ref["t0_bytes"], failover)
                    for failover in (False, True)]
            replay = pool.submit(fleet_replay, card, root, bodies, truths, fleet_t0)
            for failover, fut in zip((False, True), legs):
                line, f = fut.result()
                print(("fleet-failover " if failover else "fleet-migrate ")
                      + json.dumps(dict(line, card=card)), flush=True)
                failed += f
            line, f = replay.result()
            print("fleet-replay " + json.dumps(line), flush=True)
            failed += f
    finally:
        line, f = fleet_campaign_finish(card, campaign)
    print("fleet-campaign " + json.dumps(line), flush=True)
    failed += f
    if failed:
        raise AssertionError("fleet: " + "; ".join(failed))
    print(f"fleet-phase: {time.perf_counter() - t_phase:.3f} s wall", flush=True)
    by = shared["replica_launches"].values()
    return {k: sum(v[k] for v in by) for k in ("fused_assign", "sinkhorn", "assemble_block")}


def scorecard_phase(card):
    """``cli scorecard --traces 32`` on the card: its table and verdict
    printed, K1 launched, the host baselines equal to the JAX package's
    table and the solver within one span of it per regime."""
    import contextlib
    import io

    from traceweaver_tpu_torch.metrics import scorecard as SC
    from traceweaver_tpu_torch.runtime import cli

    real, cards, out = SC.run_scorecard, [], io.StringIO()

    def keep(*args, **kw):
        cards.append(real(*args, **kw))
        return cards[-1]

    SC.run_scorecard = keep
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc, k1, other, ms = drive(lambda: cli.main(["scorecard", "--traces", "32"]), True)
    finally:
        SC.run_scorecard = real
    wall = time.perf_counter() - t0
    for ln in out.getvalue().splitlines():
        print("scorecard | " + ln, flush=True)
    sc = cards[0]
    diff = {regime: {m: sc["per_regime"][regime][SC.SOLVER_METHOD if m == "weaver_tpu" else m]
                     - ref for m, ref in accs.items()}
            for regime, accs in SCORECARD_JAX.items()}
    print("scorecard " + json.dumps(dict(
        traces=32, device=sc["device"], wall_s=wall, fused_assign_launches=k1,
        per_regime=sc["per_regime"], calibration_monotone_ok=sc["calibration_monotone_ok"],
        jax_calibration_monotone_ok=True, minus_jax=diff, card=card)), flush=True)
    bad = {(r, m): d for r, ds in diff.items() for m, d in ds.items()
           if (d != 0.0 if m != "weaver_tpu" else abs(d) > 1 / 32 + 1e-9)}
    if rc != 0 or k1 <= 0 or bad:
        raise AssertionError(f"scorecard: rc {rc}, launches {k1}, off JAX {bad}")
    return k1


def drive_cli(argv, tally, captured=None, want=lambda S: True, plain=False):
    """One CLI run through :func:`drive` (the largest K1 block ``want``
    accepts into ``captured``), its assembly checked unless ``plain``
    and its launches added to ``tally``; the native ingest front end
    must have run. Returns the result, peak memory, wall, K1 launches,
    K1 device ms and the ill-posed count."""
    ill, counts = {}, {}
    (res, peak, wall), n, other, ms = drive(lambda: run_cli(argv), True, captured, want,
                                            largest=True, ill=ill, counts=counts)
    if not plain:
        check_assembly(f"cli {argv}", counts)
    tally["assemble_block"] = tally.get("assemble_block", 0) + counts["assemble_block"]
    tally["fused_assign"] += n
    tally["sinkhorn"] += other
    if res.store.ingest_front_end != "native":
        raise AssertionError(f"cli {argv}: ingest ran {res.store.ingest_front_end}")
    return res, peak, wall, n, ms, ill


def discovery_block(S):
    """Discovery's blocks: the flagship's are those the ground-truth loop
    already keeps."""
    return S.shape[0] >= DISCOVERY_MIN_WINDOWS


def _gtfree_worker(card, root, dirs):
    """Worker: exp5's ground-truth-free loop (``--gt_free_dag 1``, the
    flagship alone, every graph of ``dirs``) on the card in a process of
    its own. Returns, per graph, its ``executor-gtfree`` record without
    the two fields that compare it with the ground-truth-DAG run, its
    ill-posed count and the run cut to what the checks read; the loop's
    launches; and its largest discovery K1 block, on the CPU."""
    sys.path.insert(0, HERE)
    from types import SimpleNamespace

    import torch

    launches = {"fused_assign": 0, "sinkhorn": 0}
    captured, runs = {}, {}
    for n, d in enumerate(dirs):
        name = os.path.basename(d)
        res, peak, wall, k1, ms, ill = drive_cli(
            exp5_argv(d, n, os.path.join(root, "results-gtfree"), predictors="10")
            + ["--gt_free_dag", "1"], launches, captured, want=discovery_block)
        if k1 <= 0:
            raise AssertionError(f"gt-free {name}: no fused_assign launch")
        edges = {p: g.edges() for p, g in res.store.discovered_dags.items()}
        jax_acc, jax_edges = EXP5_GTFREE_JAX[name]
        line = executor_record(
            res, peak, wall, k1, ms, ill, card, config="alibaba-exp5-15000", graph=name,
            gt_free_dag=True, discovered_edges=edges,
            edges_equal_gt_dag=edges == gt_dag_edges(res.store),
            edges_equal_jax={p: [list(e) for e in v] for p, v in edges.items()}
            == jax_edges, flagship_jax_cpu=jax_acc,
            discovery={p: st for p, st in res.store.discovery_stats.items()})
        runs[name] = dict(line=line, ill=ill, res=SimpleNamespace(
            accuracy_overall=res.accuracy_overall, flagship_pred=res.flagship_pred))
    block = captured.get("block")
    if block is not None:
        block = {k: v.cpu() if torch.is_tensor(v) else v for k, v in block.items()}
    return runs, launches, block


class ExecutorSideJobs:
    """Card work beside the executor phase, in two spawned processes: the
    ladder (:func:`_ladder_worker`) then, from :meth:`start_mesh`, the
    mesh phase (:func:`_mesh_worker`) in one, exp5's ground-truth-free
    loop (:func:`_gtfree_worker`) in the other, each started once
    ``corpora`` (a :class:`CorpusJobs`) holds what it reads (loading
    writes nothing into a corpus, so the executor phase reads them at the
    same time). :meth:`join` waits for them and stops the processes, as
    leaving the ``with`` block does."""

    def __init__(self, card, root, corpora, em_job):
        import multiprocessing

        self.card, self.root, self.corpora, self.em_job = card, root, corpora, em_job
        ctx = multiprocessing.get_context("spawn")
        dirs, _ = corpus_dirs(root, "exp5", corpora)
        self.gtfree_pool = ctx.Pool(1)
        self.gtfree = self.gtfree_pool.apply_async(_gtfree_worker, (card, root, dirs))
        corpora.get("exp5-hard")
        self.ladder_pool = ctx.Pool(1)
        self.ladder = self.ladder_pool.apply_async(_ladder_worker, (card, root))
        self.mesh = None

    def start_mesh(self):
        """Queue the mesh phase behind the ladder once ``r100k`` is built
        and the CPU reference of ``em-step-sharded`` is in."""
        self.corpora.get("r100k")
        self.mesh = self.ladder_pool.apply_async(
            _mesh_worker, (self.card, self.root, self.em_job.result()))

    def join(self):
        """Returns the ladder's, the ground-truth-free loop's and the mesh
        phase's results."""
        try:
            return self.ladder.get(), self.gtfree.get(), self.mesh.get()
        finally:
            self.__exit__()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for pool in (self.gtfree_pool, self.ladder_pool):
            if pool is not None:
                pool.terminate()
                pool.join()
        self.gtfree_pool = self.ladder_pool = None


def executor_phase(card, root, corpora, side):
    """Config ``alibaba-exp5-15000`` through the CLI, graph by graph, with
    the ground-truth DAG and then without it, exp4's predictors on graph
    0 with and without the thread pool, the metrics and events run and
    the ``query`` subcommand, then config ``alibaba-cg-8k`` plainly and
    without ground truth, and that call under the profiler. Returns the
    K1 and K2 launches of the ground-truth runs and of the
    ground-truth-free ones, the largest K1 block of the exp5 loop, of
    ground-truth-free discovery and of ``alibaba-cg-8k``, and what
    :func:`rerun_checks` needs: the graphs, both loops' card results and
    the graphs whose ground-truth-free run needs its own CPU rerun; and
    the ladder's K1 launches and the ladder calls that need a CPU rerun.
    ``corpora`` (a :class:`CorpusJobs`) holds the exp5 and ``cg-8k``
    corpora. The ground-truth-free exp5 loop and the ladder run in
    ``side`` (an :class:`ExecutorSideJobs`) beside this phase's other
    runs, and so, from the end of the ground-truth loop, does the mesh
    phase; they are joined before ``alibaba-cg-8k``'s profiled call, so
    that no other process's work shares the card while the profiler
    traces it. Returns the mesh phase's launches too."""
    import torch

    from traceweaver_tpu_torch.runtime.executor import RESULT_FAMILIES

    t_phase = time.perf_counter()
    launches = {"fused_assign": 0, "sinkhorn": 0}
    gtfree_launches = {"fused_assign": 0, "sinkhorn": 0}
    blocks = {"executor-exp5-block": {}, "executor-gtfree-block": {},
              "executor-cg8k-block": {}}

    def driven(argv, captured=None, tally=launches, want=lambda S: True, plain=False):
        return drive_cli(argv, tally, captured, want, plain)

    results = os.path.join(root, "results")
    t0 = time.perf_counter()
    dirs, synth_s = corpus_dirs(root, "exp5", corpora)
    print(f"executor-corpus alibaba-exp5-15000: {len(dirs)} call graphs in "
          f"{synth_s:.3f} s, waited for {time.perf_counter() - t0:.3f} s", flush=True)
    names = [os.path.basename(d) for d in dirs]
    if names != list(EXP5_JAX_ACCURACY):
        raise AssertionError(f"corpus graphs {dirs}")
    ingest_compare("alibaba-exp5-15000", dirs[0], 1000, card)

    gt_runs = {}
    for n, (name, d) in enumerate(zip(names, dirs)):
        res, peak, wall, k1, ms, ill = driven(exp5_argv(d, n, results),
                                              blocks["executor-exp5-block"])
        line = executor_line("executor", res, peak, wall, k1, ms, ill, card,
                             config="alibaba-exp5-15000", graph=name)
        check_accuracy(f"exp5 {name}", line["accuracy"],
                       {k: v for k, v in EXP5_JAX_ACCURACY[name].items()
                        if k in HOST_BASELINES}, ill)
        if k1 <= 0:
            raise AssertionError(f"exp5 {name}: no fused_assign launch")
        gt_runs[name] = (res, ill)
    present = set(os.listdir(results))
    missing = [f"{kind}_alibaba_cg_{n}_load_multiple_1_15000_1_0.0.pickle"
               for n in range(len(dirs)) for kind in RESULT_FAMILIES]
    missing = [m for m in missing if m not in present]
    if missing:
        raise AssertionError(f"result pickles missing: {missing}")
    side.start_mesh()

    by_pool = {}
    for pool in (0, 1):
        res, peak, wall, k1, ms, ill = driven(exp5_argv(
            dirs[0], 0, os.path.join(root, f"exp4-{pool}"), compress=1,
            predictors="2,8,9,10", execute_parallel=pool))
        line = executor_line("executor", res, peak, wall, k1, ms, ill, card,
                             config="alibaba-exp5-15000", graph="call_graph_0",
                             predictors="2,8,9,10", compress=1, execute_parallel=pool)
        check_accuracy(f"exp4 execute_parallel={pool}", line["accuracy"],
                       EXP4_JAX_ACCURACY, ill)
        by_pool[pool] = (res.accuracy_overall, res.accuracy_per_process)
    if by_pool[0] != by_pool[1]:
        raise AssertionError(f"execute_parallel changes the results: {by_pool}")

    obs_cli_run(dirs[0], root, card)
    query_run(os.path.join(results, "e2e_alibaba_cg_0_load_multiple_1_15000_1_0.0.pickle"),
              card)

    (d,), synth_s = corpus_dirs(root, "cg8k", corpora)
    ingest_compare("alibaba-cg-8k", d, 8192, card)
    res, peak, wall, k1, ms, ill = driven(exp5_argv(
        d, 0, os.path.join(root, "results-8k"), predictors="10", max_traces=8192),
        blocks["executor-cg8k-block"])
    fleet = res.fleet_stats[FLAGSHIP]
    _, spans = solved(res)
    line = executor_line(
        "executor", res, peak, wall, k1, ms, ill, card, config="alibaba-cg-8k",
        synthesize_s=synth_s, spans_per_s=spans / res.seconds[FLAGSHIP],
        **{k: fleet.get(k, 0.0) for k in ("prepare_s", "plan_fit_s", "pack_s",
                                          "dispatch_s", "wait_s", "decode_s")})
    check_accuracy("cg-8k", line["accuracy"], CG8K_JAX_ACCURACY, ill)
    if k1 <= 0:
        raise AssertionError("cg-8k: no fused_assign launch")
    gt_flag = res.accuracy_overall[FLAGSHIP]
    # the same call at bf16, and at f32 with the assembly's plain version
    # on the card: peak memory
    peak_f32, wall_f32 = peak, wall
    bf16_launches = {"fused_assign": 0, "sinkhorn": 0}
    res, peak, wall, k1, ms, ill = driven(exp5_argv(
        d, 0, os.path.join(root, "results-8k-bf16"), predictors="10", max_traces=8192)
        + ["--precision", "bf16"], tally=bf16_launches)
    line = executor_line("executor", res, peak, wall, k1, ms, ill, card,
                         config="alibaba-cg-8k", precision="bf16",
                         peak_mem_bytes_f32=peak_f32)
    check_accuracy("cg-8k bf16", line["accuracy"], CG8K_BF16_JAX_ACCURACY, ill)
    if k1 <= 0:
        raise AssertionError("cg-8k bf16: no fused_assign launch")
    with plain_assembly():
        res, peak, wall, _, _, _ = driven(exp5_argv(
            d, 0, os.path.join(root, "results-8k-plain"), predictors="10",
            max_traces=8192), tally={"fused_assign": 0, "sinkhorn": 0}, plain=True)
    print("executor-score-build " + json.dumps(dict(
        config="alibaba-cg-8k", peak_mem_bytes={"kernel": peak_f32, "plain": peak},
        wall_s={"kernel": wall_f32, "plain": wall},
        accuracy={"kernel": gt_flag, "plain": res.accuracy_overall[FLAGSHIP]},
        card=card)), flush=True)
    argv = exp5_argv(d, 0, os.path.join(root, "results-8k-gtfree"), predictors="10",
                     max_traces=8192) + ["--gt_free_dag", "1"]
    res, peak, wall, k1, ms, ill = driven(argv, blocks["executor-gtfree-block"],
                                          tally=gtfree_launches, want=discovery_block)
    edges = {p: g.edges() for p, g in res.store.discovered_dags.items()}
    line = executor_line(
        "executor-gtfree", res, peak, wall, k1, ms, ill, card, config="alibaba-cg-8k",
        gt_free_dag=True, discovered_edges=edges,
        edges_equal_gt_dag=edges == gt_dag_edges(res.store), flagship_gt_dag=gt_flag,
        flagship_jax_cpu=CG8K_GTFREE_JAX_ACCURACY[FLAGSHIP],
        discovery={p: st for p, st in res.store.discovery_stats.items()})
    check_accuracy("cg-8k ground-truth-free", line["accuracy"],
                   CG8K_GTFREE_JAX_ACCURACY, ill)
    if ill["ill_posed_windows"] == 0 and abs(res.accuracy_overall[FLAGSHIP] - gt_flag) > 1.0:
        raise AssertionError(f"cg-8k ground-truth-free: {res.accuracy_overall[FLAGSHIP]} "
                             f"is not within 1 pt of the ground-truth-DAG {gt_flag}")

    t0 = time.perf_counter()
    ladder, (side_runs, side_launches, side_block), mesh_launches = side.join()
    print(f"executor-side-jobs: the ladder, the ground-truth-free exp5 loop and the "
          f"mesh phase waited for {time.perf_counter() - t0:.3f} s", flush=True)
    for k, v in side_launches.items():
        gtfree_launches[k] = gtfree_launches.get(k, 0) + v
    held = blocks["executor-gtfree-block"].get("block")
    # the exp5 loop's blocks came first: they win ties, as in one process
    if side_block is not None and (held is None
                                   or side_block["S"].numel() >= held["S"].numel()):
        blocks["executor-gtfree-block"]["block"] = {
            k: v.to("cuda") if torch.is_tensor(v) else v for k, v in side_block.items()}
    gtfree_runs, own_rerun = {}, []
    for name in names:
        run = side_runs[name]
        gt_res = gt_runs[name][0]
        same_as_gt_run = run["res"].flagship_pred == gt_res.flagship_pred
        print("executor-gtfree " + json.dumps(dict(
            run["line"], flagship_gt_dag=gt_res.accuracy_overall[FLAGSHIP],
            predictions_equal_gt_dag_run=same_as_gt_run)), flush=True)
        if not (run["line"]["edges_equal_gt_dag"] and same_as_gt_run):
            own_rerun.append(name)  # other DAGs: the CPU discovers its own
        gtfree_runs[name] = (run["res"], run["ill"])
    profiled_cli(argv, card, line)

    if not blocks["executor-gtfree-block"]:
        raise AssertionError("ground-truth-free runs: no discovery block of "
                             f">= {DISCOVERY_MIN_WINDOWS} windows")
    shapes = {k: list(v["block"]["S"].shape) for k, v in blocks.items()}
    print(f"executor-phase: {time.perf_counter() - t_phase:.3f} s wall, "
          f"launches {json.dumps(launches)}, ground-truth-free launches "
          f"{json.dumps(gtfree_launches)}, K1 blocks kept {json.dumps(shapes)}",
          flush=True)
    launches["bf16_fused_assign"] = bf16_launches["fused_assign"]
    launches["bf16_assemble_block"] = bf16_launches["assemble_block"]
    return (launches, gtfree_launches, {k: v["block"] for k, v in blocks.items()},
            (dirs, gt_runs, gtfree_runs, own_rerun), ladder, mesh_launches)


def rerun_submit(reruns, root, dirs, own_rerun):
    """Submit the flagship of every exp5 graph on the CPU to ``reruns`` (a
    :class:`CpuReruns`), ground-truth-free too where ``own_rerun`` names
    the graph; returns the two ``{graph: future}`` maps."""
    names = [os.path.basename(d) for d in dirs]
    cpu_gtfree = {name: reruns.submit(d, n, os.path.join(root, "cpu-gtfree", name),
                                      gt_free=True)
                  for n, (name, d) in enumerate(zip(names, dirs)) if name in own_rerun}
    cpu_gt = {name: reruns.submit(d, n, os.path.join(root, "cpu", name))
              for n, (name, d) in enumerate(zip(names, dirs))}
    return cpu_gt, cpu_gtfree


def rerun_checks(card, root, submitted, dirs, gt_runs, gtfree_runs, own_rerun,
                 ladder=(), ladder_futs=(), stream=None, stream_rerun=None, serve=None,
                 serve_rerun=None):
    """Wait for the CPU reruns (``submitted`` by :func:`rerun_submit`,
    ``ladder_futs`` by :func:`ladder_submit`), then the
    two-sided flagship checks of both exp5 loops against those runs, and
    the ground-truth-free flagship within one point of the
    ground-truth-DAG one on every graph with no ill-posed window;
    :func:`ladder_verdict` of every ladder call in ``ladder``; and, when
    the card's ``stream`` (from :func:`stream_phase`) met ill-posed
    windows, :func:`stream_verdict` against the CPU run of the stream
    that ``stream_rerun`` (a :class:`StreamRerun`) holds, and likewise
    :func:`serve_verdict` against ``serve_rerun`` (a
    :class:`ServeRerun`)."""
    t0 = time.perf_counter()
    names = [os.path.basename(d) for d in dirs]
    cpu_gt = {name: fut.result() for name, fut in submitted[0].items()}
    cpu_gtfree = {name: fut.result() for name, fut in submitted[1].items()}
    ladder_cpu = [f.result() for f in ladder_futs]
    stream_cpu = stream_rerun.result() if stream_rerun is not None else None
    serve_cpu = serve_rerun.result() if serve_rerun is not None else None
    failed = [ladder_verdict(card, r, c) for r, c in zip(ladder, ladder_cpu)]
    if stream_cpu is not None:
        failed.append(stream_verdict(card, stream, stream_cpu))
    if serve_cpu is not None:
        failed.append(serve_verdict(card, serve, serve_cpu))
    for name in names:
        failed.append(card_vs_cpu("gt-dag", name, gt_runs[name][0], gt_runs[name][1],
                                  EXP5_JAX_ACCURACY[name][FLAGSHIP],
                                  cpu_gt[name], card))
    for name in names:
        res, ill = gtfree_runs[name]
        jax_acc = EXP5_GTFREE_JAX[name][0]
        if name in cpu_gtfree:
            cpu = cpu_gtfree[name]
            source = "cpu ground-truth-free run"
        else:
            # the card discovered the ground-truth DAGs and assigned as the
            # ground-truth run did: the CPU flagship under those DAGs is
            # that run's rerun
            cpu = cpu_gt[name]
            source = "cpu run under the same DAGs"
        gt_flag = gt_runs[name][0].accuracy_overall[FLAGSHIP]
        got = res.accuracy_overall[FLAGSHIP]
        near_gt = abs(got - gt_flag) <= 1.0
        failed.append(card_vs_cpu("gt-free", name, res, ill, jax_acc, cpu, card,
                                  cpu_source=source, flagship_gt_dag=gt_flag,
                                  within_1_pt_of_gt_dag=near_gt))
        if ill["ill_posed_windows"] == 0 and not near_gt:
            failed.append(f"gt-free {name}: {got} is not within 1 pt of the "
                          f"ground-truth-DAG flagship {gt_flag}")
    print(f"executor-cpu-reruns: {len(cpu_gt) + len(cpu_gtfree) + len(ladder_cpu)} runs"
          f"{' and the stream' if stream_cpu is not None else ''}"
          f"{' and t0 served alone' if serve_cpu is not None else ''} waited for "
          f"{time.perf_counter() - t0:.3f} s after the card phases", flush=True)
    failed = [f for f in failed if f]
    if failed:
        raise AssertionError("; ".join(failed))


# ---------------------------------------------------------------------------
# exp5's ladder
# ---------------------------------------------------------------------------

def ladder_run(card, data, out, messy, graphs, rungs, table, reruns, keep=None):
    """The ladder runner (``traceweaver_tpu_torch.runtime.ladder``) on the
    card over ``graphs`` x ``rungs`` of the corpus in ``data`` (clean, or
    messy), each call through :func:`drive`: a ``ladder`` line a call;
    host baselines must equal ``table`` (JAX's readings) and the
    flagship read it within half a point where the call met no
    ill-posed window; the others go to ``reruns`` for the two-sided rule
    against a CPU run. Calls of a graph ``table`` lacks are reported
    only. Figures are drawn when this machine has matplotlib; ``keep``
    (a directory) receives the pickles the figures read. Returns the
    records and the K1 launches."""
    import importlib.util

    from traceweaver_tpu_torch.runtime import ladder as L

    corpus = "alibaba-exp5-ladder-hard" if messy else "alibaba-exp5-ladder"
    k1_total, failed = [0], []
    have_mpl = importlib.util.find_spec("matplotlib") is not None

    def call(argv):
        a = dict(zip(argv[0::2], argv[1::2]))
        name = os.path.basename(a["--absolute_path"])
        compress = int(a["--compress_factor"])
        ill = {}
        (res, peak, wall), k1, _, ms = drive(lambda: run_cli(argv), True, ill=ill)
        k1_total[0] += k1
        ref = (table or {}).get(compress, {}).get(name)
        acc = {k: v for k, v in res.accuracy_overall.items() if not k.endswith("TopK")}
        jax_acc = dict(zip(LADDER_METHODS, ref)) if ref else None
        print("ladder " + json.dumps(dict(
            config=corpus, graph=name, compress=compress, wall_s=wall, accuracy=acc,
            accuracy_jax_cpu=jax_acc, fused_assign_launches=k1, fused_assign_ms_summed=ms,
            ill_posed_windows=ill["ill_posed_windows"], windows=ill["windows"],
            peak_mem_bytes=peak, card=card)), flush=True)
        if k1 <= 0:
            failed.append(f"{corpus} {name} {compress}: no fused_assign launch")
        if jax_acc is None:
            return
        for m in LADDER_METHODS[:3]:
            if acc[m] != jax_acc[m]:
                failed.append(f"{corpus} {name} {compress} {m}: {acc[m]} != JAX {jax_acc[m]}")
        if ill["ill_posed_windows"] == 0:
            if abs(acc[FLAGSHIP] - jax_acc[FLAGSHIP]) > 0.5:
                failed.append(f"{corpus} {name} {compress}: flagship {acc[FLAGSHIP]} vs "
                              f"JAX {jax_acc[FLAGSHIP]} with no ill-posed window")
        else:
            reruns.append(dict(corpus=corpus, name=name, dir=a["--absolute_path"],
                               n=int(name.rsplit("_", 1)[1]), compress=compress,
                               res=res, ill=ill, ref=jax_acc[FLAGSHIP]))

    t0 = time.perf_counter()
    records = L.run_ladder(data, out, messy=messy, graphs=graphs, rungs=rungs,
                           call=call, draw=have_mpl)
    print(f"ladder-phase {corpus}: {len(records)} calls in "
          f"{time.perf_counter() - t0:.3f} s, K1 launches {k1_total[0]}, figures "
          f"{'drawn' if have_mpl else 'not drawn: no matplotlib on this machine'}",
          flush=True)
    if keep:
        os.makedirs(keep, exist_ok=True)
        for f in os.listdir(out):
            if f.startswith(("accuracy_", "confidence_scores_", "ladder.json", "fig6")):
                shutil.copy(os.path.join(out, f), keep)
    if failed:
        raise AssertionError("; ".join(failed))
    return records, k1_total[0]


def ladder_phase(card, root, corpora=None):
    """The smoke's ladder (see the module docstring): ``LADDER_RUNGS`` of
    the clean corpus the executor phase wrote, on ``LADDER_GRAPHS``, then
    the messy corpus's ``LADDER_HARD_RUNGS`` on ``LADDER_HARD_GRAPHS``
    (from ``corpora``, a :class:`CorpusJobs`, when given; else the runner
    synthesizes it). Returns the K1 launches and the calls that need a
    CPU rerun."""
    reruns = []
    if corpora is not None:
        corpora.get("exp5-hard")
    _, k1 = ladder_run(card, os.path.join(root, "exp5"), os.path.join(root, "ladder"),
                       False, LADDER_GRAPHS, LADDER_RUNGS, EXP5_LADDER_JAX, reruns)
    _, k1_hard = ladder_run(card, os.path.join(root, "exp5-hard"),
                            os.path.join(root, "ladder-hard"), True, LADDER_HARD_GRAPHS,
                            LADDER_HARD_RUNGS, EXP5_LADDER_HARD_JAX, reruns)
    return k1 + k1_hard, reruns


def _ladder_worker(card, root):
    """Worker: :func:`ladder_phase` on the card in a process of its own;
    returns its K1 launches and the calls that need a CPU rerun, each
    card result cut to what :func:`ladder_verdict` reads."""
    sys.path.insert(0, HERE)
    from types import SimpleNamespace

    k1, reruns = ladder_phase(card, root)
    return k1, [dict(r, res=SimpleNamespace(accuracy_overall=r["res"].accuracy_overall,
                                            flagship_pred=r["res"].flagship_pred))
                for r in reruns]


def ladder_submit(pool, root, r):
    """A ladder call's flagship on the CPU (:func:`cpu_flagship`)."""
    return pool.submit(r["dir"], r["n"],
                       os.path.join(root, "cpu-ladder", f"{r['corpus']}-{r['compress']}"),
                       compress=r["compress"])


def ladder_verdict(card, r, cpu):
    """A ladder call that met ill-posed windows: the flagship on the CPU
    must read JAX's number exactly (or the ``LADDER_PORT_CPU`` reading)
    and the card read JAX's within ``ILL_POSED_MAX_PT`` with
    ``ILL_POSED_MIN_PAIRS`` of every service's pairs equal to the CPU
    run's (:func:`card_vs_cpu`)."""
    return card_vs_cpu("ladder", r["name"], r["res"], r["ill"], r["ref"], cpu, card,
                       config=r["corpus"], compress=r["compress"],
                       cpu_ref=LADDER_PORT_CPU.get((r["corpus"], r["name"], r["compress"])))


def ladder_reruns(card, root, reruns):
    """:func:`ladder_verdict` of every call in ``reruns``; returns what
    failed."""
    pool, ok = CpuReruns(), False
    try:
        futs = [ladder_submit(pool, root, r) for r in reruns]
        cpu = [f.result() for f in futs]
        ok = True
    finally:
        pool.close(cancel=not ok)
    return [ladder_verdict(card, r, c) for r, c in zip(reruns, cpu)]


def ladder_main(card, out) -> None:
    """``--ladder OUT``: exp5's whole ladder, both corpora (15 graphs x 6
    rungs each, 180 calls), under :func:`ladder_run`'s rule, with the CPU
    reruns after; the pickles the figures read go to ``OUT/clean`` and
    ``OUT/hard``."""
    from traceweaver_tpu_torch.runtime.ladder import RUNGS

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        reruns, failed = [], []
        for messy, table in ((False, EXP5_LADDER_JAX), (True, EXP5_LADDER_HARD_JAX)):
            sub = "hard" if messy else "clean"
            try:
                ladder_run(card, os.path.join(tmp, f"data-{sub}"), os.path.join(tmp, sub),
                           messy, None, RUNGS, table, reruns, keep=os.path.join(out, sub))
            except AssertionError as e:
                failed.append(str(e))
        failed += ladder_reruns(card, tmp, reruns)
    print(f"ladder-main: {time.perf_counter() - t0:.3f} s, {len(reruns)} CPU reruns",
          flush=True)
    failed = [f for f in failed if f]
    if failed:
        raise AssertionError("; ".join(failed))


# ---------------------------------------------------------------------------
# capture-8k and adapt-burst: capture ingress and the drift-to-adapt ladder
# ---------------------------------------------------------------------------

def sink_rows(path):
    """A stream sink's service rows: ``[(window, services), ...]``."""
    with open(path) as f:
        return [(r["window"], r["services"]) for r in map(json.loads, f)]


def sink_rows_digest(rows) -> str:
    import hashlib

    return hashlib.sha1(json.dumps(rows, sort_keys=True).encode()).hexdigest()


def _row_pairs(rows):
    """``{(window, service, endpoint, in id): out id}`` of sink rows."""
    return {(w, svc, ep, tuple(i)): tuple(o) for w, services in rows
            for svc, eps in services.items() for ep, pairs in eps.items()
            for i, o in pairs}


@contextlib.contextmanager
def assembly_capture_first(kept, n_calls=ASSEMBLY_CALLS):
    """:func:`assembly_capture` for paths whose block shapes are not
    known in advance: the first ``n_calls`` calls of the first thread and
    window shape the path assembles (not the GEMM form)."""
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt

    real, lock, owner = wt.assemble_block, threading.Lock(), []

    def keep(*args, precision="f32", gemm=False):
        key = (threading.get_ident(), tuple(args[4].shape), args[7].shape[1])
        with lock:
            if not gemm and len(kept) < n_calls and (not owner or owner[0] == key):
                owner[:] = [key]
                kept.append(args)
        return real(*args, precision=precision, gemm=gemm)

    wt.assemble_block = keep
    try:
        yield kept
    finally:
        wt.assemble_block = real


def _cli_stream(argv, keep):
    """``cli.main(["stream", ...])`` in this process, output captured;
    appends ``(service, summary)`` to ``keep``. Returns what it printed."""
    import io

    from traceweaver_tpu_torch.runtime import cli
    from traceweaver_tpu_torch.stream import StreamingReconstructor

    real_run = StreamingReconstructor.run

    def keep_service(self, *args, **kw):
        keep.append((self, real_run(self, *args, **kw)))
        return keep[-1][1]

    StreamingReconstructor.run = keep_service
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = cli.main(["stream", *argv])
    finally:
        StreamingReconstructor.run = real_run
    if rc != 0:
        raise AssertionError(f"cli stream {argv} exited {rc}: {printed.getvalue()[-2000:]}")
    return printed.getvalue()


def _add(total, counts):
    for k in ("fused_assign", "assemble_block"):
        total[k] = total.get(k, 0) + counts.get(k, 0)


def capture_phase(card, root):
    """Config ``capture-8k``: the capture workload's strace logs (two
    hosts, one clock each) through ``cli stream --source
    collector:<dir>`` on the card, clean, under ``skew:1.0:max=1`` and
    under ``capture:0.04`` (fault seed 1), every launch counter reset
    just before each call and read just after; then the same capture
    posted as one ``{"sources": ...}`` bundle to a serve tenant over
    HTTP, abandoned after the ack (no drain, no checkpoint) and recovered
    from its WAL, whose sink must equal an uninterrupted tenant's byte
    for byte. Each leg's events, windows, loss counters, loss rate,
    detected skew (to 1 us), re-keyed streams and confidence discount
    must equal the JAX package's (``CAPTURE_JAX``); its accuracy reads
    JAX's within half a point where no window was ill-posed, else within
    ``ILL_POSED_MAX_PT`` with >= ``ILL_POSED_MIN_PAIRS`` of its rows as
    the port's CPU run's (``CAPTURE_PORT_CPU``). Returns the launches, the
    largest K1 block and the first assembly calls."""
    import torch

    from traceweaver_tpu_torch.synth.capture import capture_workload

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    logs = capture_workload(CAPTURE_TRACES)
    d = os.path.join(root, "capture-logs")
    os.makedirs(d, exist_ok=True)
    for name, text in logs.items():
        with open(os.path.join(d, f"{name}.log"), "w") as f:
            f.write(text)
    gen_s = time.perf_counter() - t0
    n_lines = sum(text.count("\n") + 1 for text in logs.values())
    launches, captured, calls, failed = {}, {}, [], []
    for leg, spec in CAPTURE_LEGS:
        sink = os.path.join(root, f"capture-{leg}.jsonl")
        argv = (["--source", f"collector:{d}", *CAPTURE_ARGS, "--out", sink]
                + (["--faults", spec, "--faults_seed", "1"] if spec else []))
        runs, ill, c = [], {}, {}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with assembly_capture_first(calls if leg == "clean" else []):
            printed, _, _, _ = drive(lambda: _cli_stream(argv, runs), True, captured,
                                     largest=True, ill=ill, counts=c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base
        ((svc, s),) = runs
        cap = s["capture"]
        rows = sink_rows(sink)
        confs, discount = [], None
        with open(sink) as f:
            for rec in map(json.loads, f):
                tw = rec.get("tw.confidence") or {}
                confs += [t["conf"] for t in (tw.get("traces") or {}).values() if t]
                if tw.get("capture") is not None:
                    discount = tw["capture"]["discount"]
        want = CAPTURE_JAX[leg]
        skews = [v for v in cap.get("skew_us", {}).values() if v]
        line = dict(
            config="capture-8k", leg=leg, faults=spec, fault_seed=1 if spec else None,
            device=s["device"], strace_lines=n_lines, events=s["consumed"],
            windows=s["emitted_windows"], accuracy=s["accuracy"]["e2e"],
            accuracy_jax=want["accuracy"], loss=cap["loss"], loss_rate=cap["loss_rate"],
            rekeyed=cap["rekeyed_streams"], skew_us=cap.get("skew_us"),
            skew_detected_us=max(skews, key=abs) if skews else None,
            conf_mean=sum(confs) / len(confs) if confs else None, conf_discount=discount,
            wall_s=wall, events_per_s=s["consumed"] / wall,
            solve_s=s["stats"].get("solve_s", 0.0),
            fused_assign_launches=c["fused_assign"],
            assemble_block_launches=c["assemble_block"],
            plain_assembly_on_card=c["plain_assembly_on_card"],
            ill_posed_windows=ill["ill_posed_windows"], k1_windows=ill["windows"],
            sink_rows_digest=sink_rows_digest(rows), peak_mem_bytes=peak,
            generate_s=gen_s if leg == "clean" else None, card=card)
        print("capture " + json.dumps(line), flush=True)
        _add(launches, c)
        tag = f"capture {leg}"
        for key, got in (("events", line["events"]), ("windows", line["windows"]),
                         ("loss", line["loss"]), ("loss_rate", line["loss_rate"]),
                         ("rekeyed", line["rekeyed"]), ("conf_discount", discount)):
            if got != want[key]:
                failed.append(f"{tag}: {key} {got} != JAX {want[key]}")
        for src, off in want["skew_us"].items():
            if abs(cap["skew_us"].get(src, 0.0) - off) > 1.0:
                failed.append(f"{tag}: skew of {src} {cap['skew_us'].get(src)} us is not "
                              f"within 1 us of JAX's {off}")
        if c["fused_assign"] <= 0 or c["assemble_block"] <= 0:
            failed.append(f"{tag}: K1 {c['fused_assign']} and the assembly kernel "
                          f"{c['assemble_block']} launches")
        if c["plain_assembly_on_card"]:
            failed.append(f"{tag}: the assembly's plain version ran on the card")
        if "[stream] capture:" not in printed:
            failed.append(f"{tag}: cli stream printed no capture line")
        acc = line["accuracy"]
        if ill["ill_posed_windows"] == 0:
            if abs(acc - want["accuracy"]) > 0.5:
                failed.append(f"{tag}: {acc} is not within 0.5 pt of JAX {want['accuracy']}")
        else:
            # the CPU run's rows: kept whole for the lossy leg, the ground
            # truth (a call carries its request's trace id) for the others
            same = line["sink_rows_digest"] == CAPTURE_PORT_CPU[leg]
            got = _row_pairs(rows)
            if leg == "lossy":
                ref = _row_pairs(CAPTURE_LOSSY_CPU_ROWS)
                hits = [got.get(k) == v for k, v in ref.items()]
            else:
                hits = [v[0] == k[3][0] for k, v in got.items()]
            pairs = 1.0 if same else sum(hits) / max(1, len(hits))
            print("capture-card-vs-cpu " + json.dumps(dict(
                leg=leg, ill_posed_windows=ill["ill_posed_windows"], rows_equal=same,
                card_vs_cpu_pairs=pairs, card=card)), flush=True)
            if abs(acc - want["accuracy"]) > ILL_POSED_MAX_PT or pairs < ILL_POSED_MIN_PAIRS:
                failed.append(f"{tag}: {acc} vs JAX {want['accuracy']}, {pairs} of the rows "
                              f"as the CPU run's, with ill-posed windows")
    if failed:
        raise AssertionError("capture: " + "; ".join(failed))
    serve_s = capture_serve_leg(logs, root, card, launches)
    print(f"capture-phase: {time.perf_counter() - t_phase:.3f} s wall "
          f"(serve leg {serve_s:.3f} s)", flush=True)
    return launches, captured["block"], calls


def capture_serve_leg(logs, root, card, launches):
    """The capture posted as one ``{"sources": ...}`` bundle to tenant
    ``cap`` of an in-process serve tier (``make_server``, the serve CLI's
    fixed pump) over HTTP: once flushed and drained, once abandoned right
    after the ack (its files closed, no drain, no checkpoint) and
    recovered by ``TenantService.resume`` from the WAL, then flushed and
    drained. The two sinks must be equal byte for byte, with the WAL's
    ``capture`` record replayed and no replay error."""
    import torch

    from traceweaver_tpu_torch.serve import ServeConfig, TenantService, make_server

    body = json.dumps({"sources": logs}).encode()

    def cfg(state):
        return ServeConfig(state_dir=state, continuous=False, verbose=False,
                           **CAPTURE_SERVE)

    def post(svc):
        server = make_server(svc, port=0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        try:
            code, out, _ = _http("POST", f"http://127.0.0.1:{server.port}"
                                 "/api/v1/tenants/cap/capture", body)
        finally:
            server.shutdown()
            server.server_close()
        if code != 200:
            raise AssertionError(f"capture serve: POST answered {code} {out[:300]!r}")
        return json.loads(out)

    t0 = time.perf_counter()
    whole = os.path.join(root, "capture-serve-whole")
    svc = TenantService(cfg(whole))
    ack, c = None, {}

    def run_whole():
        nonlocal ack
        ack = post(svc)
        svc.flush("cap")
        svc.drain()

    drive(run_whole, True, counts=c)
    _add(launches, c)
    killed = os.path.join(root, "capture-serve-killed")
    svc_k = TenantService(cfg(killed))
    post(svc_k)
    for t in svc_k.tenants.values():  # abandoned: nothing drained or checkpointed
        t.close()
    resumed = TenantService.resume(cfg(killed))
    t = resumed.tenants["cap"]
    replayed, errors = t.counters.get("wal_replayed", 0), t.counters.get("wal_replay_errors", 0)
    resumed.flush("cap")
    resumed.drain()
    torch.cuda.synchronize()
    with open(os.path.join(whole, "cap", "traces.jsonl"), "rb") as f:
        want = f.read()
    with open(os.path.join(killed, "cap", "traces.jsonl"), "rb") as f:
        got = f.read()
    wall = time.perf_counter() - t0
    print("capture-serve " + json.dumps(dict(
        config="capture-8k", bundle_bytes=len(body), ack=ack, wal_replayed=replayed,
        wal_replay_errors=errors, sink_bytes=len(want), sink_identical=got == want,
        fused_assign_launches=c["fused_assign"],
        assemble_block_launches=c["assemble_block"], wall_s=wall, card=card)), flush=True)
    if got != want or replayed != 1 or errors or not want:
        raise AssertionError(f"capture serve: recovered sink equal {got == want} "
                             f"({len(got)} of {len(want)} bytes), WAL replayed {replayed}, "
                             f"errors {errors}")
    if c["fused_assign"] <= 0 or c["assemble_block"] <= 0:
        raise AssertionError(f"capture serve: launches {c}")
    return wall


def adapt_phase(card, root, controls=True):
    """Configs ``adapt-burst-60`` and ``adapt-burst-60x1024`` through
    ``cli stream --source synth:adapt-burst...`` on the card, each with
    ``--adapt`` and, with ``controls``, first without it (the whole smoke
    leaves these control runs to ``--adapt`` for its time), every launch
    counter reset just before each call
    and read just after, and the refit's own launches counted around
    ``maybe_adapt``. Per-window accuracy (the JAX package's grading of the
    sink) before the shift and in the tail, drift alerts, refits,
    fallbacks and the final PSI are held to JAX's (``ADAPT_JAX``): with no
    ill-posed window the windows equal JAX's and the pre-shift and tail
    accuracies read within half a point, with some within
    ``ILL_POSED_MAX_PT`` and >= ``ILL_POSED_MIN_PAIRS`` of the windows
    equal (the port's CPU runs read JAX's windows). ``adapt-burst-60`` with
    ``--adapt`` must raise a drift alert and land a refit that launched K1
    and the assembly kernel. Returns the launches (and the refit's), the
    largest K1 block and the refit's first assembly calls."""
    import torch

    import traceweaver_tpu_torch.stream.service as S
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops import scores as SC
    from traceweaver_tpu_torch.synth.capture import adapt_window_accuracies

    t_phase = time.perf_counter()
    launches, refit_launches, captured, calls, failed = {}, {}, {}, [], []
    real_adapt = S.StreamingReconstructor.maybe_adapt

    def counted_adapt(self):
        before = (K.LAUNCHES["fused_assign"], SC.LAUNCHES["assemble_block"])
        with assembly_capture_first(calls):
            n = real_adapt(self)
        if n:
            refit_launches["fused_assign"] = refit_launches.get("fused_assign", 0) + \
                K.LAUNCHES["fused_assign"] - before[0]
            refit_launches["assemble_block"] = refit_launches.get("assemble_block", 0) + \
                SC.LAUNCHES["assemble_block"] - before[1]
            refit_launches["refits"] = refit_launches.get("refits", 0) + n
        return n

    for config, n_req in ADAPT_CONFIGS:
        for adapt_on in (False, True) if controls else (True,):
            sink = os.path.join(root, f"{config}-{int(adapt_on)}.jsonl")
            argv = ["--source", f"synth:adapt-burst?n_bursts=60&shift_at={ADAPT_SHIFT}"
                    f"&n_req={n_req}", *ADAPT_ARGS, "--out", sink] + (
                        ["--adapt"] if adapt_on else [])
            runs, ill, c = [], {}, {}
            run_refits = dict(refit_launches)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            S.StreamingReconstructor.maybe_adapt = counted_adapt
            try:
                printed, _, _, _ = drive(lambda: _cli_stream(argv, runs), True, captured,
                                         largest=True, ill=ill, counts=c)
            finally:
                S.StreamingReconstructor.maybe_adapt = real_adapt
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ((svc, s),) = runs
            with open(sink) as f:
                accs = adapt_window_accuracies(f, n_req)
            keys = sorted(accs)
            window_acc = [accs[k] for k in keys]
            pre = sum(accs[k] for k in keys if k < ADAPT_SHIFT) / ADAPT_SHIFT
            tail = sum(window_acc[-ADAPT_TAIL:]) / ADAPT_TAIL
            want = ADAPT_JAX[(config, adapt_on)]
            w_pre = sum(want["window_acc"][:ADAPT_SHIFT]) / ADAPT_SHIFT
            w_tail = sum(want["window_acc"][-ADAPT_TAIL:]) / ADAPT_TAIL
            ad = s["adapt"]
            psi = svc.drift.last_psi("frontend")
            line = dict(
                config=config, adapt=adapt_on, device=s["device"], events=s["consumed"],
                windows=len(keys), pre=pre, tail=tail, pre_jax=w_pre, tail_jax=w_tail,
                window_acc=window_acc,
                windows_equal_jax=sum(a == b for a, b in zip(window_acc, want["window_acc"])),
                drift_alerts=s["confidence"]["drift_alerts"],
                refits=ad.get("refits_done", 0), fallbacks=ad.get("fallbacks", 0),
                actions={k: ad[k] for k in ("refits_scheduled", "refits_done",
                                            "refits_failed", "fallbacks", "restores",
                                            "recoveries")} if ad.get("enabled") else None,
                final_psi=psi, final_psi_jax=want["final_psi"],
                gauge_rearmed=psi is not None and psi <= 0.25,
                wall_s=wall, events_per_s=s["consumed"] / wall,
                solve_s=s["stats"].get("solve_s", 0.0),
                fused_assign_launches=c["fused_assign"],
                assemble_block_launches=c["assemble_block"],
                plain_assembly_on_card=c["plain_assembly_on_card"],
                refit_launches={k: v - run_refits.get(k, 0)
                                for k, v in refit_launches.items()} if adapt_on else None,
                ill_posed_windows=ill["ill_posed_windows"], k1_windows=ill["windows"],
                card=card)
            print("adapt " + json.dumps(line), flush=True)
            _add(launches, c)
            tag = f"{config} adapt={adapt_on}"
            if c["fused_assign"] <= 0 or c["assemble_block"] <= 0 \
                    or c["plain_assembly_on_card"]:
                failed.append(f"{tag}: launches {c}")
            for key in ("drift_alerts", "refits", "fallbacks"):
                if line[key] != want[key]:
                    failed.append(f"{tag}: {key} {line[key]} != JAX {want[key]}")
            if ill["ill_posed_windows"] == 0:
                if window_acc != want["window_acc"] or abs(pre - w_pre) > 0.005 \
                        or abs(tail - w_tail) > 0.005:
                    failed.append(f"{tag}: windows {window_acc} != JAX {want['window_acc']}")
            elif (line["windows_equal_jax"] < ILL_POSED_MIN_PAIRS * len(keys)
                  or abs(pre - w_pre) * 100 > ILL_POSED_MAX_PT
                  or abs(tail - w_tail) * 100 > ILL_POSED_MAX_PT):
                failed.append(f"{tag}: windows {window_acc} vs JAX's with ill-posed windows")
            if adapt_on and "[stream] adapt:" not in printed:
                failed.append(f"{tag}: cli stream printed no adapt line")
    if refit_launches.get("refits", 0) < 1 or refit_launches.get("fused_assign", 0) <= 0 \
            or refit_launches.get("assemble_block", 0) <= 0:
        failed.append(f"adapt-burst-60: the refits launched {refit_launches}")
    if failed:
        raise AssertionError("adapt: " + "; ".join(failed))
    print(f"adapt-phase: {time.perf_counter() - t_phase:.3f} s wall", flush=True)
    launches["refit_fused_assign"] = refit_launches.get("fused_assign", 0)
    launches["refit_assemble_block"] = refit_launches.get("assemble_block", 0)
    return launches, captured["block"], calls


def schemes_check(graph_dir, card) -> dict:
    """The native schemes on ``alibaba-cg-8k``'s graph 0: FCFS and vPath
    through ``native.run_scheme`` must assign every span of every
    solvable service as the port's Python baselines do (as the JAX
    package's ``tests/test_native.py`` holds its own). Returns the
    ``schemes`` line."""
    import random

    import traceweaver_tpu_torch.algorithms as algos
    from traceweaver_tpu_torch import native
    from traceweaver_tpu_torch.ingest import build_service_problem, load_corpus

    t0 = time.perf_counter()
    random.seed(10)
    store = load_corpus(graph_dir, fix=5, max_traces=8192, cache=False)
    out, secs = {}, {"native": 0.0, "python": 0.0}
    for svc in sorted(store.out_spans_by_process):
        prob = build_service_problem(store, svc, deepcopy=False)
        if prob.skipped:
            continue
        for scheme, cls in (("fcfs", "FCFS"), ("vpath", "VPath")):
            t1 = time.perf_counter()
            got = native.scheme_assignments(scheme, prob.in_span_partitions,
                                            prob.out_span_partitions)
            t2 = time.perf_counter()
            exp = getattr(algos, cls)(store.all_spans, store.all_processes).FindAssignments(
                cls, svc, {k: list(v) for k, v in prob.in_span_partitions.items()},
                {k: list(v) for k, v in prob.out_span_partitions.items()}, False, [], {})
            secs["native"] += t2 - t1
            secs["python"] += time.perf_counter() - t2
            out[f"{svc}/{scheme}"] = all(got[ep] == dict(exp[ep])
                                         for ep in prob.out_span_partitions)
    line = dict(config="alibaba-cg-8k", graph=0, equal=out, seconds=secs,
                wall_s=time.perf_counter() - t0, card=card)
    if not out or not all(out.values()):
        raise AssertionError(f"schemes: native run_scheme parts from the baselines: {line}")
    return line


def _schemes_worker():
    """Worker: synthesize ``alibaba-cg-8k``'s graph 0 and run
    :func:`schemes_check` on it, off the card."""
    sys.path.insert(0, HERE)
    import tempfile

    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    with tempfile.TemporaryDirectory() as tmp:
        (d,) = synthesize_corpus(tmp, n_graphs=1, traces_per_graph=8192, seed=10)
        return schemes_check(d, nvidia_smi())


class SchemesJob(StreamRerun):
    """:func:`_schemes_worker` in a spawned process of its own, beside the
    card phases; :meth:`result` waits for it (it raises what failed)."""

    def __init__(self):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.job = self.pool.apply_async(_schemes_worker)


# ---------------------------------------------------------------------------
# the mesh phase: the multi-device tier and the campaign runner
# ---------------------------------------------------------------------------

#: the default ladder's first rung (``campaign/plan.py alibaba_ladder``):
#: the users' smallest real rung
R100K = dict(name="r100k", n_graphs=15, traces_per_graph=1000, gap_ms=500, seed=10,
             n_services=60, source="synthetic")
#: JAX package on the CPU, the same rung through its ``cli campaign run``
#: (``--plan`` of this rung, devices 1, slices 2, 3 timed rounds; 179,000
#: spans, 54 solvable services, all sequential): the steady rounds'
#: end-to-end accuracy (percent) and per-regime accuracies
R100K_JAX = dict(e2e_pct=100.0, per_regime={"sequential": 1.0})
#: the mixtures of ``em-step-sharded`` on the two-shard card mesh against
#: the one-shard card mesh and against the port's CPU run of the same
#: sharding: the f32 moment sums add in another order
EM_SHARDED_TOL = dict(rtol=1e-3, atol_w=1e-5, atol_us=1e-2)
#: the seed of the global ``random`` before a rung loads (``-loop``
#: service names draw from it), alike in every process that loads it
RUNG_RANDOM_SEED = 0


def _rung_spec():
    from traceweaver_tpu_torch.campaign.plan import RungSpec

    return RungSpec(**R100K)


def _load_r100k(cache):
    """``r100k`` built (synthesized, loaded, its manifest written) under
    the campaign cache ``cache``, with the global ``random`` seeded and
    restored around it; returns the corpus."""
    import random

    from traceweaver_tpu_torch.campaign.corpus import build_rung

    state = random.getstate()
    random.seed(RUNG_RANDOM_SEED)
    try:
        return build_rung(_rung_spec(), cache)
    finally:
        random.setstate(state)


def _build_r100k(cache):
    """Worker: :func:`_load_r100k`, so that the campaign finds it cached."""
    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    corpus = _load_r100k(cache)
    return corpus.manifest["spans"], time.perf_counter() - t0


def _same_outputs(got, ref):
    """Every item's 6-tuple equal, the assignments through
    ``ops/compare.pair_agreement``; returns the agreement per item."""
    from traceweaver_tpu_torch.ops.compare import pair_agreement

    agree = [pair_agreement(g[0], r[0]) for g, r in zip(got, ref)]
    same = [g == r for g, r in zip(got, ref)]
    return agree, all(a == 1.0 for a in agree) and all(same)


def mesh_fleet_runs(card):
    """``mesh-fleet-8svc``: ``synth-fleet-8svc`` through ``solve_fleet``
    with no mesh, ``make_mesh(1)`` and the two-shard mesh on the one
    card. Returns each run's launches."""
    import traceweaver_tpu_torch.algorithms.fleet as tf
    from traceweaver_tpu_torch.metrics.synth import synth_fleet_8svc
    from traceweaver_tpu_torch.parallel.mesh import make_mesh

    probs = synth_fleet_8svc()
    meshes = (("none", None), ("make_mesh(1)", make_mesh(1)),
              ("cuda:0 x2", make_mesh(devices=["cuda:0"] * 2)))
    real = tf._mesh_solve
    shard_rows = []

    def recording(arrs, pidx, *args):
        shard_rows.append(len(pidx) // args[-2].size)
        return real(arrs, pidx, *args)

    outs, launches, failed = {}, {}, []
    for tag, mesh in meshes:
        counts = {}
        shard_rows.clear()
        tf._mesh_solve = recording
        try:
            result, n_k1, _, kernel_ms = drive(
                lambda: run_fleet(probs, True, mesh=mesh), True, counts=counts)
        finally:
            tf._mesh_solve = real
        out, acc, wall, peak, stats, quarantined = result
        outs[tag] = out
        launches[tag] = dict(fused_assign=n_k1, sinkhorn=counts["sinkhorn"],
                             assemble_block=counts["assemble_block"])
        n_spans = sum(len(next(iter(p["in_parts"].values()))) for p in probs)
        line = dict(
            config="synth-fleet-8svc", mesh=tag, wall_s=wall, spans_per_s=n_spans / wall,
            kernel_ms_summed=kernel_ms, launches=launches[tag],
            plain_assembly_on_card=counts["plain_assembly_on_card"],
            shard_rows=sorted(set(shard_rows)), peak_mem_bytes=peak, accuracy=acc,
            quarantined=quarantined,
            **{k: stats.get(k) for k in (
                "fleet_dispatches", "pipeline_groups", "mesh_serialized_groups",
                "compact_windows_total", "compact_windows_redispatched",
                "d2h_bytes_flags", "d2h_flag_fetches", "devcols_fallbacks",
                "dispatch_s", "wait_s", "decode_s")},
            card=card)
        print("mesh-fleet-8svc " + json.dumps(line), flush=True)
        if n_k1 <= 0:
            failed.append(f"{tag}: no K1 launch")
        try:
            check_assembly(f"mesh-fleet-8svc {tag}", counts)
        except AssertionError as e:
            failed.append(str(e))
        if quarantined or any(v for k, v in stats.items() if k.startswith("fault")):
            failed.append(f"{tag}: the supervisor stepped in")
        if stats.get("d2h_flag_fetches", 0) <= 0 or \
                stats.get("d2h_bytes_flags") != stats.get("compact_windows_total"):
            failed.append(f"{tag}: flag ledger {stats.get('d2h_bytes_flags')} against "
                          f"compact_windows_total {stats.get('compact_windows_total')}")
        if mesh is not None:
            # the mesh places host tensors per shard: no resident path
            if "devcols_fallbacks" in stats:
                failed.append(f"{tag}: devcols_fallbacks {stats['devcols_fallbacks']}")
            if stats["compact_windows_total"] % mesh.size or not shard_rows or any(
                    r & (r - 1) for r in shard_rows):
                failed.append(f"{tag}: shard rows {sorted(set(shard_rows))}, "
                              f"compact_windows_total {stats['compact_windows_total']}")
            groups = stats.get("fleet_dispatches", 0)
            if groups > 1 and stats.get("mesh_serialized_groups") != groups:
                failed.append(f"{tag}: mesh_serialized_groups "
                              f"{stats.get('mesh_serialized_groups')} of {groups} groups")
    for tag, _ in meshes[1:]:
        agree, same = _same_outputs(outs[tag], outs["none"])
        print("mesh-fleet-equal " + json.dumps(dict(
            mesh=tag, identical=same,
            pair_agreement={p["service"]: a for p, a in zip(probs, agree)})), flush=True)
        if not same:
            failed.append(f"{tag}: outputs differ from the run without a mesh")
    if failed:
        raise AssertionError("mesh-fleet-8svc: " + "; ".join(failed))
    return launches


def mesh_async_run(card):
    """``mesh-async-8k``: ``FindAssignments`` on ``synth-async-8k`` with the
    two-shard mesh equals the run without one. Returns its launches."""
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k
    from traceweaver_tpu_torch.parallel.mesh import make_mesh

    prob = synth_async_8k()
    ref = run_slice(prob, True)
    counts = {}
    got, n_k1, _, kernel_ms = drive(
        lambda: run_slice(prob, True, mesh=make_mesh(devices=["cuda:0"] * 2)), True,
        counts=counts)
    agree, same = _same_outputs([got[0]], [ref[0]])
    line = dict(config="synth-async-8k", mesh="cuda:0 x2", identical=same,
                pair_agreement=agree[0], accuracy=got[1], wall_s=got[2],
                unsharded_wall_s=ref[2], kernel_ms=kernel_ms,
                launches=dict(fused_assign=n_k1, assemble_block=counts["assemble_block"]),
                plain_assembly_on_card=counts["plain_assembly_on_card"], card=card)
    print("mesh-async-8k " + json.dumps(line), flush=True)
    check_assembly("mesh-async-8k", counts)
    if not same or n_k1 <= 0:
        raise AssertionError(f"mesh-async-8k: {line}")
    return line["launches"]


def example_windows(B=32, W=32, E=3, M=32, K=5, seed=0, well_posed=True):
    """Synthetic windows of a chain of E endpoints: W incoming spans a
    window, one nested outgoing span each per endpoint around the
    per-edge means of the tables. ``well_posed=False`` is the example
    batch of the repo's ``__graft_entry__._example_arrays`` (copied, so
    this script loads nothing of the JAX package): spans 50-150 µs apart
    with 30 µs of jitter, where most windows hold near ties that two sum
    orders may break apart. ``well_posed=True`` spreads them out: 300-500
    µs apart, 10 µs of jitter, the return gap 1000 µs after the last call
    ends, so every span's own child is the only likely one."""
    import numpy as np

    rng = np.random.default_rng(seed)
    a = {}
    spacing, jitter = ((300, 500), 10.0) if well_posed else ((50, 150), 30.0)
    in_start = np.cumsum(rng.uniform(*spacing, size=(B, W)), axis=1).astype(np.float32)
    a["in_start"] = in_start
    if well_posed:
        a["in_end"] = (in_start + 300.0 * E + 200.0 + 1000.0
                       + rng.normal(0, jitter, size=(B, W)).astype(np.float32))
    else:
        a["in_end"] = in_start + rng.uniform(4000, 6000, size=(B, W)).astype(np.float32)
    a["in_valid"] = np.ones((B, W), dtype=bool)
    a["out_start"] = np.zeros((B, E, M), dtype=np.float32)
    a["out_end"] = np.zeros((B, E, M), dtype=np.float32)
    a["out_valid"] = np.zeros((B, E, M), dtype=bool)
    for e in range(E):
        starts = (in_start + 300.0 * (e + 1)
                  + rng.normal(0, jitter, size=(B, W)).astype(np.float32))
        a["out_start"][:, e, :W] = starts
        a["out_end"][:, e, :W] = starts + 200.0
        a["out_valid"][:, e, :W] = True
    a["skip_cap"] = np.zeros((B, E), dtype=np.float32)
    a["force_skip"] = np.zeros((B, E, W), dtype=bool)
    a["pred_mask"] = np.zeros((E, E), dtype=bool)
    for e in range(1, E):
        a["pred_mask"][e, e - 1] = True
    a["root_mask"] = np.arange(E) == 0
    a["is_last"] = np.arange(E) == E - 1

    def gaussians(means, shape):
        wt = np.zeros(shape + (K,), dtype=np.float32)
        mu = np.zeros(shape + (K,), dtype=np.float32)
        sd = np.ones(shape + (K,), dtype=np.float32)
        wt[..., 0], mu[..., 0], sd[..., 0] = 1.0, means, 50.0
        return wt, mu, sd

    a["in_wt"], a["in_mu"], a["in_sd"] = gaussians(
        np.array([300.0 * (e + 1) for e in range(E)], dtype=np.float32), (E,))
    a["ret_wt"], a["ret_mu"], a["ret_sd"] = gaussians(np.float32(1000.0), (E,))
    a["edge_wt"] = np.zeros((E, E, K), dtype=np.float32)
    a["edge_mu"] = np.zeros((E, E, K), dtype=np.float32)
    a["edge_sd"] = np.ones((E, E, K), dtype=np.float32)
    for e in range(1, E):
        # the gap between consecutive calls
        a["edge_wt"][e, e - 1, 0], a["edge_mu"][e, e - 1, 0] = 1.0, 100.0
        a["edge_sd"][e, e - 1, 0] = 50.0
    return a


#: the JAX package's example batch at the size the smoke shards
EM_EXAMPLE = dict(B=256, W=64, M=64, well_posed=False)
#: its windows that also run on the CPU (windows solve independently, so
#: these are the card run's first windows)
EM_CPU_WINDOWS = 64


def _mixture_errors(got, ref):
    """Per table, the largest absolute difference of two ``dists`` and
    whether it is within ``EM_SHARDED_TOL``."""
    import numpy as np

    errs, bad = {}, []
    for fam in ("in", "edge", "ret"):
        for name, g, c in zip(("w", "mu", "sd"), got[fam], ref[fam]):
            atol = EM_SHARDED_TOL["atol_w" if name == "w" else "atol_us"]
            errs[f"{fam}_{name}"] = float(np.max(np.abs(g - c)))
            if np.any(np.abs(g - c) > atol + EM_SHARDED_TOL["rtol"] * np.abs(c)):
                bad.append(f"{fam} {name}")
    return errs, bad


def _em_example_cpu(threads):
    """Worker: ``em_step_sharded``'s assignments of the first
    ``EM_CPU_WINDOWS`` windows of ``EM_EXAMPLE`` on two CPU shards, on
    ``threads`` threads."""
    sys.path.insert(0, HERE)
    import torch

    torch.set_num_threads(threads)
    from traceweaver_tpu_torch.parallel.mesh import BATCHED, em_step_sharded, make_mesh

    first = {k: v[:EM_CPU_WINDOWS] if k in BATCHED else v
             for k, v in example_windows(**EM_EXAMPLE).items()}
    return em_step_sharded(first, make_mesh(devices=["cpu"] * 2))[0]


class EmCpuJob(StreamRerun):
    """:func:`_em_example_cpu` in a spawned process of its own on one
    thread, started with the smoke so that it is done when the mesh
    phase needs it."""

    def __init__(self, threads: int = 1):
        import multiprocessing

        self.pool = multiprocessing.get_context("spawn").Pool(1)
        self.job = self.pool.apply_async(_em_example_cpu, (threads,))


def em_sharded_run(card, cpu_example):
    """``em-step-sharded``: ``em_step_sharded`` on the two-shard card mesh.
    On the JAX package's example batch (``EM_EXAMPLE``) against the
    one-shard card mesh ``["cuda:0"]``: the same launch plan, so the
    assignments are equal and the mixtures, whose moment sums add in
    another order, within ``EM_SHARDED_TOL``; its share of pairs that
    part from the port's CPU run over its first ``EM_CPU_WINDOWS``
    windows (``cpu_example``, from an :class:`EmCpuJob`) is reported. On
    the well-posed batch (``example_windows()``) against the port's CPU
    run of the same sharding: assignments equal, mixtures within
    ``EM_SHARDED_TOL``."""
    import numpy as np

    from traceweaver_tpu_torch.parallel.mesh import em_step_sharded, make_mesh
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops import scores as SC

    two = make_mesh(devices=["cuda:0"] * 2)
    example, posed = example_windows(**EM_EXAMPLE), example_windows()
    K.reset_launches()
    SC.reset_launches()
    t0 = time.perf_counter()
    assign, dists = em_step_sharded(example, two)
    wall = time.perf_counter() - t0
    launches = dict(fused_assign=K.LAUNCHES["fused_assign"],
                    assemble_block=SC.LAUNCHES["assemble_block"])
    posed_assign, posed_dists = em_step_sharded(posed, two)
    one_assign, one_dists = em_step_sharded(example, make_mesh(devices=["cuda:0"]))
    cpu_assign, cpu_dists = em_step_sharded(posed, make_mesh(devices=["cpu"] * 2))
    one_errs, one_bad = _mixture_errors(dists, one_dists)
    cpu_errs, cpu_bad = _mixture_errors(posed_dists, cpu_dists)
    n_cpu = cpu_example.shape[0]
    valid = example["in_valid"][:n_cpu, None, :].repeat(assign.shape[1], axis=1)
    line = dict(
        shape=list(example["out_start"].shape), wall_s=wall,
        vs_one_shard=dict(assign_equal=bool(np.array_equal(assign, one_assign)),
                          max_abs_err=one_errs),
        vs_cpu=dict(shape=list(posed["out_start"].shape),
                    assign_equal=bool(np.array_equal(posed_assign, cpu_assign)),
                    max_abs_err=cpu_errs),
        example_vs_cpu=dict(
            windows=n_cpu,
            pairs_differ_share=float((assign[:n_cpu] != cpu_example)[valid].mean()),
            windows_differ=int((assign[:n_cpu] != cpu_example).any(axis=(1, 2)).sum())),
        tolerance=EM_SHARDED_TOL, launches=launches, card=card)
    print("em-step-sharded " + json.dumps(line), flush=True)
    if not (line["vs_one_shard"]["assign_equal"] and line["vs_cpu"]["assign_equal"]) \
            or one_bad or cpu_bad or launches["fused_assign"] <= 0 \
            or launches["assemble_block"] <= 0:
        raise AssertionError(f"em-step-sharded: {one_bad} {cpu_bad} {line}")
    return launches


def campaign_r100k(card, root):
    """``campaign-r100k``: ``cli campaign run`` on ``r100k`` (devices 1,
    slices 2, 3 timed rounds, warm-up at most 5), then ``campaign
    compare`` of the artifact against itself and ``campaign report``.
    Returns the run's launches, the artifact and the cache root."""
    from traceweaver_tpu_torch.runtime import cli

    cache = os.path.join(root, "campaign")
    plan = os.path.join(root, "r100k-plan.json")
    with open(plan, "w") as f:
        json.dump({"name": "alibaba-ladder", "rungs": [R100K]}, f)
    out = os.path.join(root, "CAMPAIGN_r100k.json")
    argv = ["campaign", "run", "--plan", plan, "--devices", "1", "--slices", "2",
            "--rounds", "3", "--warmup_max", "5", "--out", out, "--cache", cache]
    counts, ill = {}, {}
    t0 = time.perf_counter()
    rc, n_k1, _, kernel_ms = drive(lambda: cli.main(argv), True, ill=ill, counts=counts)
    wall = time.perf_counter() - t0
    from traceweaver_tpu_torch.campaign import load_artifact

    art = load_artifact(out)
    r = art["rungs"][0]
    tol = 0.5 if ill["ill_posed_windows"] == 0 else ILL_POSED_MAX_PT
    line = dict(
        config="campaign-r100k", rc=rc, wall_s=wall, spans=r["manifest"]["spans"],
        corpus_cached=r["corpus_cached"], build_s=r["build_s"],
        steady_spans_per_s=r["steady"]["spans_per_s"],
        round_wall_s=r["steady"]["round_wall_s"],
        warmup_builds=r["warmup"]["backend_compiles"],
        steady_builds=r["steady"]["backend_compiles"], e2e_pct=r["accuracy"]["e2e_pct"],
        jax_cpu_e2e_pct=R100K_JAX["e2e_pct"], tolerance_pt=tol,
        per_regime=r["accuracy"]["per_regime"], multislice=r["multislice"],
        fleet=r["steady"]["fleet"], bytes=r["steady"]["bytes"],
        plan_cache=r["steady"]["plan_cache"], dispatch_seconds=r["steady"]["dispatch_seconds"],
        launches=dict(fused_assign=n_k1, assemble_block=counts["assemble_block"],
                      sinkhorn=counts["sinkhorn"]),
        plain_assembly_on_card=counts["plain_assembly_on_card"], kernel_ms_summed=kernel_ms,
        backend=art["backend"], devices_visible=art["devices_visible"], **ill, card=card)
    print("campaign-r100k " + json.dumps(line), flush=True)
    failed = []
    if rc != 0 or n_k1 <= 0:
        failed.append(f"rc {rc}, {n_k1} K1 launches")
    check_assembly("campaign-r100k", counts)
    if r["steady"]["backend_compiles"] != 0 or r["warmup"]["incomplete"]:
        failed.append("kernel builds in the steady rounds")
    if not (r["multislice"] and r["multislice"]["agree"]):
        failed.append(f"multislice {r['multislice']}")
    if abs(r["accuracy"]["e2e_pct"] - R100K_JAX["e2e_pct"]) > tol:
        failed.append(f"e2e {r['accuracy']['e2e_pct']} against JAX's "
                      f"{R100K_JAX['e2e_pct']} (tolerance {tol} pt)")
    if r["steady"]["quarantined"]:
        failed.append("quarantined services")
    if cli.main(["campaign", "compare", out, out]) != 0:
        failed.append("campaign compare of the artifact against itself")
    if cli.main(["campaign", "report", out]) != 0:
        failed.append("campaign report")
    if failed:
        raise AssertionError("campaign-r100k: " + "; ".join(failed))
    return line["launches"], art, cache


def _multislice_rank(pid, n, port, cache, rdv):
    """Worker: rank ``pid`` of ``n``: its ``partition_problems`` share of
    ``r100k`` through ``solve_fleet`` on the card, the solved edge
    statistics reduced through ``allreduce_stats_dist`` (gloo) and the
    file transport."""
    sys.path.insert(0, HERE)
    import datetime
    import hashlib

    import torch.distributed as dist

    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.campaign.runner import rung_items, slice_edge_stats
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.parallel import multislice as ms

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=n,
                            rank=pid, timeout=datetime.timedelta(seconds=300))
    try:
        corpus = _load_r100k(cache)
        mine = ms.partition_problems(len(corpus.problems), n, pid)
        t0 = time.perf_counter()
        outs = solve_fleet(rung_items(corpus, mine))
        wall = time.perf_counter() - t0
        by_index = dict(zip(mine, outs))
        stats = slice_edge_stats(corpus, by_index, n, pid)
        order = _edge_order(corpus)
        rows = ms.stats_to_rows(stats, order)
        dist_rows = ms.allreduce_stats_dist(rows)
        files = ms.stats_to_rows(ms.allreduce_stats_files(stats, rdv, pid, n), order)
        return dict(pid=pid, services=len(mine), wall_s=wall,
                    accs=_rung_accuracies(corpus, mine, outs),
                    launches=K.LAUNCHES["fused_assign"],
                    transports_equal=bool((dist_rows == files).all()),
                    dist_digest=hashlib.sha1(dist_rows.tobytes()).hexdigest())
    finally:
        dist.destroy_process_group()


def _rung_accuracies(corpus, idx, outs):
    from traceweaver_tpu_torch.metrics import accuracy_for_service

    return {"%d:%s" % (corpus.problems[i]["store"], corpus.problems[i]["svc"]):
            accuracy_for_service(o[0], corpus.problems[i]["true"],
                                 corpus.problems[i]["prob"].in_span_partitions)
            for i, o in zip(idx, outs)}


def _edge_order(corpus):
    return sorted({(m["svc"], ep) for m in corpus.problems
                   for ep in m["prob"].out_span_partitions})


def _one_process_solve(cache):
    """Worker: the whole of ``r100k`` through ``solve_fleet`` on the card
    in one process; returns each service's accuracy."""
    sys.path.insert(0, HERE)
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet
    from traceweaver_tpu_torch.campaign.runner import rung_items

    corpus = _load_r100k(cache)
    idx = list(range(len(corpus.problems)))
    return _rung_accuracies(corpus, idx, solve_fleet(rung_items(corpus, idx)))


class MultisliceJob(StreamRerun):
    """``multislice-2p``: two ranks on the card, each solving its share of
    ``r100k`` and reducing the edge statistics through both transports,
    and the one-process solve of the whole rung, each in a spawned
    process of its own beside the phases that follow the mesh phase
    (their corpus loads and CUDA contexts would otherwise hold the
    smoke's clock); :meth:`finish` waits for them and checks: the
    transports and the ranks agree, and each service's accuracy equals
    the one-process run's."""

    def __init__(self, root, cache):
        import multiprocessing
        import socket

        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        rdv = os.path.join(root, "multislice-rdv")
        self.t0 = time.perf_counter()
        self.pool = multiprocessing.get_context("spawn").Pool(3)
        self.ranks = [self.pool.apply_async(_multislice_rank, (p, 2, port, cache, rdv))
                      for p in range(2)]
        self.one = self.pool.apply_async(_one_process_solve, (cache,))

    def finish(self, card):
        ranks = [r.get(timeout=600) for r in self.ranks]
        one = self.one.get(timeout=600)
        accs = {k: v for r in ranks for k, v in r["accs"].items()}
        differ = {k: (v, one.get(k)) for k, v in accs.items() if one.get(k) != v}
        line = dict(config="multislice-2p", rung="r100k",
                    wall_s=time.perf_counter() - self.t0,
                    ranks=[{k: r[k] for k in ("pid", "services", "wall_s", "launches",
                                              "transports_equal")} for r in ranks],
                    ranks_agree=ranks[0]["dist_digest"] == ranks[1]["dist_digest"],
                    services=len(accs), one_process_services=len(one),
                    accuracy_differs=differ, card=card)
        print("multislice-2p " + json.dumps(line), flush=True)
        if (not all(r["transports_equal"] for r in ranks) or not line["ranks_agree"]
                or set(accs) != set(one) or differ or any(r["launches"] <= 0 for r in ranks)):
            raise AssertionError(f"multislice-2p: {line}")


def mesh_flag_refusals_start(root):
    """``--mesh_devices 2`` on this one-card machine and ``--mesh_devices
    3``: the batch CLI in two subprocesses at once (each pays a torch
    import), on a path that does not exist (loading it would fail
    otherwise, and differently). :func:`mesh_flag_refusals_finish` reads
    them."""
    import torch

    if torch.cuda.device_count() >= 2:
        raise AssertionError("--mesh_devices 2 is refused only on a one-card machine")
    procs = {}
    for n in (2, 3):
        res = os.path.join(root, f"mesh-refusal-{n}")
        procs[n] = (res, subprocess.Popen(
            [sys.executable, "-m", "traceweaver_tpu_torch.runtime.cli", "--absolute_path",
             os.path.join(root, "absent"), "--fix", "5", "--cache_rate", "0",
             "--results_directory", res, "--mesh_devices", str(n)],
            cwd=HERE, env={**os.environ, "PYTHONPATH": HERE}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    return procs


def mesh_flag_refusals_finish(procs):
    """Each refusal must exit non-zero, name the mesh and write no results:
    it failed before any data loaded."""
    out = {}
    for n, (res, p) in procs.items():
        try:
            _, err = p.communicate(timeout=300)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        out[n] = dict(rc=p.returncode, stderr=err.strip().splitlines()[-1:],
                      results_written=os.path.exists(res))
        if p.returncode == 0 or os.path.exists(res) or "mesh" not in err:
            raise AssertionError(f"--mesh_devices {n} was not refused before loading: "
                                 f"{out[n]} {err[-1000:]}")
    print("mesh-flag-refusals " + json.dumps(out), flush=True)


def mesh_phase(card, root, cpu_example):
    """The mesh phase (see the module docstring) but ``multislice-2p``
    (:class:`MultisliceJob`, which the caller starts): the multi-device
    tier and the campaign runner, with ``r100k`` read from the campaign
    cache ``root/campaign`` when built there, and the CPU reference of
    ``em-step-sharded`` in ``cpu_example`` (from an :class:`EmCpuJob`).
    Returns the launches of each of its runs."""
    import torch

    t_phase = time.perf_counter()
    refusals = mesh_flag_refusals_start(root)
    launches = {}
    launches["mesh_fleet"] = mesh_fleet_runs(card)
    launches["mesh_async"] = mesh_async_run(card)
    launches["em_sharded"] = em_sharded_run(card, cpu_example)
    launches["campaign"], _, _ = campaign_r100k(card, root)
    mesh_flag_refusals_finish(refusals)
    torch.cuda.synchronize()
    print(f"mesh-phase: {time.perf_counter() - t_phase:.3f} s wall", flush=True)
    return launches


def _mesh_worker(card, root, cpu_example):
    """Worker: :func:`mesh_phase` on the card in a process of its own."""
    sys.path.insert(0, HERE)
    return mesh_phase(card, root, cpu_example)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice-root", help="run only the slice and fleet phases, "
                    "importing traceweaver_tpu_torch from this checkout")
    ap.add_argument("--ladder", metavar="OUT", help="run only exp5's whole ladder of "
                    "both corpora; the pickles the figures read go to OUT")
    ap.add_argument("--assembly", action="store_true", help="run only the block "
                    "assembly's check and timing on the first sweeps of one "
                    "synth-async-8k and one synth-fleet-8svc solve")
    ap.add_argument("--stream", action="store_true", help="run only the stream "
                    "phase (stream-cg-8k) and its K1 block's check")
    ap.add_argument("--serve", action="store_true", help="run only the serve "
                    "phase (serve-cg-4t) and its K1 block's check")
    ap.add_argument("--fleet", action="store_true", help="run only the fleet phase "
                    "(fleet-cg-4t-2r: two replica processes, migration, crash "
                    "recovery, the wire campaign)")
    ap.add_argument("--capture", action="store_true", help="run only the capture "
                    "phase (capture-8k), its K1 block's and assembly calls' checks "
                    "and the native schemes' check")
    ap.add_argument("--adapt", action="store_true", help="run only the adapt phase "
                    "(adapt-burst-60, adapt-burst-60x1024) and its K1 block's and "
                    "refit's assembly calls' checks")
    ap.add_argument("--mesh", action="store_true", help="run only the mesh phase "
                    "(mesh-fleet-8svc, mesh-async-8k, em-step-sharded, campaign-r100k, "
                    "multislice-2p and the --mesh_devices refusals)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.slice_root) if args.slice_root else HERE)
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    card = nvidia_smi()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}", flush=True)
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    from concurrent.futures import ThreadPoolExecutor

    from traceweaver_tpu_torch.ops import scores as SC

    # one nvcc per source and g++ for the C++ loader, all at once
    with ThreadPoolExecutor(3) as pool:
        builds = [pool.submit(K.build, True), pool.submit(SC.build, True)]
        if not args.slice_root:
            from traceweaver_tpu_torch import native

            loader = pool.submit(native.build)
            print(f"loader: {os.path.basename(loader.result())}", flush=True)
        reports = [b.result() for b in builds]
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in "\n".join(reports).splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            print("ptxas " + ln.strip(), flush=True)

    if args.assembly:
        assembly_only(card)
        print(card, flush=True)
        return 0
    if args.stream:
        with tempfile.TemporaryDirectory() as tmp:
            _, blk, state = stream_phase(card, tmp)
            check_case("stream-block", blk, 1e-3, posed_only=True)
            if state[3]:
                failed = stream_verdict(card, state, cpu_stream(state[0], 8))
                if failed:
                    raise AssertionError(failed)
        print(card, flush=True)
        return 0
    if args.serve:
        with tempfile.TemporaryDirectory() as tmp:
            _, blk, state, _ = serve_phase(card, tmp)
            check_case("serve-block", blk, 1e-3, posed_only=True)
            if state[2]:
                failed = serve_verdict(card, state, cpu_serve(state[0], 8))
                if failed:
                    raise AssertionError(failed)
        print(card, flush=True)
        return 0
    if args.fleet:
        with tempfile.TemporaryDirectory() as tmp:
            fleet_tier_phase(card, tmp)
        print(card, flush=True)
        return 0
    if args.mesh:
        with tempfile.TemporaryDirectory() as tmp, EmCpuJob() as em_job:
            mesh_phase(card, tmp, em_job.result())
            with MultisliceJob(tmp, os.path.join(tmp, "campaign")) as multislice:
                multislice.finish(card)
        print(card, flush=True)
        return 0
    if args.capture or args.adapt:
        with tempfile.TemporaryDirectory() as tmp:
            if args.capture:
                _, blk, calls = capture_phase(card, tmp)
                check_case("capture-block", blk, 1e-3, posed_only=True)
                assembly_check("capture-score-build", calls)
                print("schemes " + json.dumps(_schemes_worker()), flush=True)
            if args.adapt:
                _, blk, calls = adapt_phase(card, tmp)
                check_case("adapt-block", blk, 1e-3, posed_only=True)
                assembly_check("adapt-refit-score-build", calls)
        print(card, flush=True)
        return 0
    if args.slice_root:
        print(f"package: {os.path.dirname(os.path.dirname(K.__file__))}", flush=True)
        _, real_block, _, _ = slice_phase(card)
        _, fleet_block, *_ = fleet_phase(card)
        for name, blk in (("slice-block", real_block), ("fleet-block", fleet_block)):
            print("kernel-ab " + json.dumps(dict(
                block=name, shape=list(blk["S"].shape), **kernel_timing(blk),
                package=os.path.dirname(os.path.dirname(K.__file__)), card=card)),
                flush=True)
        return 0
    if args.ladder:
        ladder_main(card, os.path.abspath(args.ladder))
        print(card, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    t_smoke = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as later:
        # The CPU reruns run beside the card phases: last, as they ran
        # before the serve phase came, the smoke would not end in its
        # time. The stream's and t0-served-alone's start now (their
        # corpora are synthesized in their processes), the exp5 loop's
        # and the ladder's as their card phases end; a phase's ill-posed
        # windows decide whether its rerun is read. The serve corpus is
        # synthesized beside the first card phases too.
        stream_rerun_any = later.enter_context(StreamRerun(None))
        serve_rerun_any = later.enter_context(ServeRerun(None))
        serve_corpus = later.enter_context(SynthJob(os.path.join(tmp, "serve")))
        schemes_job = later.enter_context(SchemesJob())
        corpora = later.enter_context(CorpusJobs(tmp))
        em_job = later.enter_context(EmCpuJob())
        launches, real_block, slice_sweep, slice_peak = slice_phase(card)
        fleet_launches, fleet_block, probs, fleet_wall, fleet_sweep, fleet_peak = \
            fleet_phase(card)
        bf16_launches, bf16_blocks = precision_phase(
            card, probs, {"synth-async-8k": slice_peak, "synth-fleet-8svc": fleet_peak})
        fleet_profile(probs, fleet_wall, card)
        del probs
        fault_run(tmp, card)
        print(f"phase-clock: first phases done at {time.perf_counter() - t_smoke:.1f} s",
              flush=True)
        side = later.enter_context(ExecutorSideJobs(card, tmp, corpora, em_job))
        executor_launches, gtfree_launches, executor_blocks, rerun_state, \
            (ladder_launches, ladder_reruns_needed), mesh_launches = \
            executor_phase(card, tmp, corpora, side)
        print(f"phase-clock: executor, ladder and mesh done at "
              f"{time.perf_counter() - t_smoke:.1f} s", flush=True)
        # five workers leave the card phases beside them a core more than
        # six did; the ladder's calls, the longest, go first
        reruns = later.enter_context(CpuReruns(workers=5))
        ladder_futs = [ladder_submit(reruns, tmp, r) for r in ladder_reruns_needed]
        submitted = rerun_submit(reruns, tmp, rerun_state[0], rerun_state[3])
        stream_launches, executor_blocks["stream-block"], stream_state = \
            stream_phase(card, tmp, corpora)
        stream_rerun = stream_rerun_any if stream_state[3] else None
        serve_launches, executor_blocks["serve-block"], serve_state, fleet_ref = \
            serve_phase(card, tmp, serve_corpus)
        serve_rerun = serve_rerun_any if serve_state[2] else None
        print(f"phase-clock: serve done at {time.perf_counter() - t_smoke:.1f} s", flush=True)
        fleet_serve_launches = fleet_tier_phase(card, tmp, serve_corpus, fleet_ref)
        del fleet_ref
        print(f"phase-clock: fleet done at {time.perf_counter() - t_smoke:.1f} s", flush=True)
        multislice = later.enter_context(MultisliceJob(tmp, os.path.join(tmp, "campaign")))
        capture_launches, executor_blocks["capture-block"], capture_calls = \
            capture_phase(card, tmp)
        adapt_launches, executor_blocks["adapt-block"], adapt_calls = adapt_phase(
            card, tmp, controls=False)
        print(f"phase-clock: capture and adapt done at {time.perf_counter() - t_smoke:.1f} s",
              flush=True)
        scorecard_launches = scorecard_phase(card)
        multislice.finish(card)
        K.reset_launches()
        worst, worst_bf16 = kernel_phase(real_block, fleet_block, executor_blocks,
                                         bf16_blocks)
        score_err = max(assembly_check("slice-score-build", slice_sweep),
                        assembly_check("fleet-score-build", fleet_sweep),
                        assembly_check("capture-score-build", capture_calls),
                        assembly_check("adapt-refit-score-build", adapt_calls))
        checks = dict(K.LAUNCHES)
        timing = kernel_timing(real_block)
        fleet_timing = kernel_timing(fleet_block)
        bf16_timing = kernel_timing(bf16_blocks["slice-block-bf16"])
        bf16_fleet_timing = kernel_timing(bf16_blocks["fleet-block-bf16"])
        score_time = assembly_timing("slice-score-build", slice_sweep, card)
        fleet_score_time = assembly_timing("fleet-score-build", fleet_sweep, card)
        del slice_sweep, fleet_sweep, bf16_blocks
        print(f"phase-clock: card phases done at {time.perf_counter() - t_smoke:.1f} s",
              flush=True)
        rerun_checks(card, tmp, submitted, *rerun_state, ladder=ladder_reruns_needed,
                     ladder_futs=ladder_futs, stream=stream_state,
                     stream_rerun=stream_rerun, serve=serve_state, serve_rerun=serve_rerun)
        print("schemes " + json.dumps(schemes_job.result()), flush=True)
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s after the build", flush=True)
    print("kernels: " + json.dumps({
        "fused_assign": launches["fused_assign"],
        "sinkhorn": launches["sinkhorn"],
        "fleet_fused_assign": fleet_launches["fused_assign"],
        "fleet_sinkhorn": fleet_launches["sinkhorn"],
        "executor_fused_assign": executor_launches["fused_assign"],
        "executor_sinkhorn": executor_launches["sinkhorn"],
        "gtfree_fused_assign": gtfree_launches["fused_assign"],
        "gtfree_sinkhorn": gtfree_launches["sinkhorn"],
        "scorecard_fused_assign": scorecard_launches,
        "ladder_fused_assign": ladder_launches,
        "stream_fused_assign": stream_launches["fused_assign"],
        "stream_assemble_block": stream_launches["assemble_block"],
        "serve_fused_assign": serve_launches["fused_assign"],
        "serve_assemble_block": serve_launches["assemble_block"],
        "fleet_serve_fused_assign": fleet_serve_launches["fused_assign"],
        "fleet_serve_sinkhorn": fleet_serve_launches["sinkhorn"],
        "fleet_serve_assemble_block": fleet_serve_launches["assemble_block"],
        "capture_fused_assign": capture_launches["fused_assign"],
        "capture_assemble_block": capture_launches["assemble_block"],
        "adapt_fused_assign": adapt_launches["fused_assign"],
        "adapt_assemble_block": adapt_launches["assemble_block"],
        "adapt_refit_fused_assign": adapt_launches["refit_fused_assign"],
        "adapt_refit_assemble_block": adapt_launches["refit_assemble_block"],
        "bf16_fused_assign": bf16_launches["fused_assign"],
        "bf16_sinkhorn": bf16_launches["sinkhorn"],
        "bf16_fleet_fused_assign": bf16_launches["fleet_fused_assign"],
        "bf16_executor_fused_assign": executor_launches["bf16_fused_assign"],
        **{f"{run}_{k}": v for run, counts in (
            ("mesh_fleet", mesh_launches["mesh_fleet"]["cuda:0 x2"]),
            ("mesh_async", mesh_launches["mesh_async"]),
            ("em_sharded", mesh_launches["em_sharded"]),
            ("campaign", mesh_launches["campaign"])) for k, v in counts.items()},
        "assemble_block": launches["assemble_block"],
        "fleet_assemble_block": fleet_launches["assemble_block"],
        "executor_assemble_block": executor_launches["assemble_block"],
        "gtfree_assemble_block": gtfree_launches["assemble_block"],
        "round_topk": checks["round_topk"]}), flush=True)
    src = "traceweaver_tpu_torch/ops/csrc/sinkhorn.cu"
    fleet_shape = list(fleet_block["S"].shape)

    def row(name, replaces, body, call, err):
        fleet = {f"fleet_{k}": v for k, v in fleet_timing[name].items()}
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    tpu_kernel_body=body, pallas_call=call, score_dtype="float32",
                    launches=launches[name], max_abs_err=worst[err],
                    library_ms=None, **timing[name],
                    fleet_launches=fleet_launches[name], fleet_shape=fleet_shape,
                    executor_launches=executor_launches[name],
                    gtfree_launches=gtfree_launches[name],
                    scorecard_launches=scorecard_launches if name == "fused_assign" else 0,
                    stream_launches=stream_launches.get(name, 0),
                    serve_launches=serve_launches.get(name, 0),
                    fleet_serve_launches=fleet_serve_launches[name],
                    capture_launches=capture_launches.get(name, 0),
                    adapt_launches=adapt_launches.get(name, 0),
                    adapt_refit_launches=adapt_launches.get(f"refit_{name}", 0),
                    mesh_launches=mesh_launches["mesh_fleet"]["cuda:0 x2"].get(name, 0),
                    mesh_async_launches=mesh_launches["mesh_async"].get(name, 0),
                    em_sharded_launches=mesh_launches["em_sharded"].get(name, 0),
                    campaign_launches=mesh_launches["campaign"].get(name, 0),
                    executor_shapes={k: list(v["S"].shape)
                                     for k, v in executor_blocks.items()},
                    **fleet)

    def bf16_row(name, replaces, body, call, err):
        fleet = {f"fleet_{k}": v for k, v in bf16_fleet_timing[name].items()}
        return dict(name=f"{name}_bf16", route="cuda", source=src, replaces=replaces,
                    tpu_kernel_body=body, pallas_call=call, score_dtype="bfloat16",
                    launches=bf16_launches[name], max_abs_err=worst_bf16[err],
                    library_ms=None, **bf16_timing[name],
                    fleet_launches=(bf16_launches["fleet_fused_assign"]
                                    if name == "fused_assign" else 0),
                    executor_launches=(executor_launches["bf16_fused_assign"]
                                       if name == "fused_assign" else 0),
                    **fleet)

    def score_row(precision):
        t, ft = score_time[precision]["forward"], fleet_score_time[precision]["forward"]
        return dict(name="assemble_block" + ("_bf16" if precision == "bf16" else ""),
                    route="cuda", source="traceweaver_tpu_torch/ops/csrc/scores.cu",
                    replaces="traceweaver_tpu/algorithms/weaver_tpu.py:224",
                    tpu_kernel_body=None, pallas_call=None,
                    note="no TPU kernel: XLA fuses the block assembly there",
                    score_dtype="bfloat16" if precision == "bf16" else "float32",
                    launches=(launches["assemble_block"] if precision == "f32"
                              else bf16_launches["assemble_block"]),
                    max_abs_err=score_err, ms=t["ms"], plain_ms=t["plain_ms"],
                    bound_ms=t["bound_ms"], bound_by=t["bound_by"],
                    bound_term=t["bound_term"], library_ms=None,
                    shape=score_time[precision]["shape"],
                    launches_per_sweep=t["launches_per_sweep"],
                    device_ops_per_endpoint_step=score_time[precision][
                        "device_ops_per_endpoint_step"],
                    backward_ms=score_time[precision]["backward"]["ms"],
                    fleet_launches=(fleet_launches["assemble_block"] if precision == "f32"
                                    else bf16_launches["fleet_assemble_block"]),
                    executor_launches=executor_launches[
                        "assemble_block" if precision == "f32" else "bf16_assemble_block"],
                    gtfree_launches=(gtfree_launches["assemble_block"]
                                     if precision == "f32" else 0),
                    stream_launches=(stream_launches["assemble_block"]
                                     if precision == "f32" else 0),
                    serve_launches=(serve_launches["assemble_block"]
                                    if precision == "f32" else 0),
                    fleet_serve_launches=(fleet_serve_launches["assemble_block"]
                                          if precision == "f32" else 0),
                    capture_launches=(capture_launches["assemble_block"]
                                      if precision == "f32" else 0),
                    adapt_launches=(adapt_launches["assemble_block"]
                                    if precision == "f32" else 0),
                    adapt_refit_launches=(adapt_launches["refit_assemble_block"]
                                          if precision == "f32" else 0),
                    **{f"{run}_launches": (counts["assemble_block"] if precision == "f32"
                                           else 0)
                       for run, counts in (
                           ("mesh", mesh_launches["mesh_fleet"]["cuda:0 x2"]),
                           ("mesh_async", mesh_launches["mesh_async"]),
                           ("em_sharded", mesh_launches["em_sharded"]),
                           ("campaign", mesh_launches["campaign"]))},
                    fleet_shape=fleet_score_time[precision]["shape"],
                    **{f"fleet_{k}": ft[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "launches_per_sweep")})

    pallas = "traceweaver_tpu/ops/pallas_sinkhorn.py"
    k1 = ("fused_assign", f"{pallas}:308", f"{pallas}:219 _fused_kernel",
          f"{pallas}:357", "k1_err")
    k2 = ("sinkhorn", f"{pallas}:140", f"{pallas}:80 _kernel", f"{pallas}:184",
          "plan_err")
    table = [row(*k1), bf16_row(*k1), row(*k2), bf16_row(*k2), score_row("f32"),
             score_row("bf16")]
    print(json.dumps({"kernels": table}), flush=True)
    torch.cuda.synchronize()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
