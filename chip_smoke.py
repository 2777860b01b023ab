#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py      # needs one CUDA card
    python3 chip_smoke.py --slice-root DIR   # only the slice and fleet
                                             # phases, with the package
                                             # of checkout DIR

Phases, each of which raises on failure (non-zero exit):

1. build the CUDA kernels from ``traceweaver_tpu_torch/ops/csrc`` with
   nvcc, and beside it the C++ Jaeger loader from
   ``traceweaver_tpu_torch/native/src`` with g++; print ptxas's register
   and spill report;
2. slice: config ``synth-async-8k`` (8192 requests, three chained
   endpoints) through ``WeaverTorch.FindAssignments`` on the card, once
   with the fused kernel and once with the plain Sinkhorn kernel, each
   with its launch counter reset just before and read just after;
   accuracy must reach ``ACCURACY_FLOOR``; a 256-request cut must give
   the same assignments on the card as on the CPU;
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
   near ties);
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
   table) and the port's CLI ``main(argv)`` runs in this process once per
   graph with exp5's arguments (fix 5, compress 15000, predictors
   3,4,7,10, ``--execute_parallel 0``). Every CLI call must ingest with
   the C++ loader and launch K1; every line counts the call's windows
   and ill-posed windows (see the kernels phase). ``load_corpus`` with
   the C++ loader and with Python's ``json`` must give equal stores on
   graph 0 and on ``alibaba-cg-8k``. WAP5, FCFS and vPath must equal
   the JAX package's end-to-end accuracy on the CPU
   (``EXP5_JAX_ACCURACY``) and all five result-pickle families must
   exist for every graph. The flagship of every graph also runs on the
   CPU (``--device cpu``), in worker processes once every card phase is
   done (so no timed phase shares the host with them); the check is
   two-sided: a graph whose card run met no
   ill-posed window must read JAX's number within half a point either
   way with >= 99% of every service's pairs equal to the CPU run's, and
   a graph that met some must read JAX's number exactly on the CPU, and
   on the card within 7 points either way with >= 90% of every
   service's pairs equal to the CPU run's (``executor-card-vs-cpu``
   lines). The same 15 graphs then run the
   flagship with ground-truth-free DAG discovery (``--gt_free_dag 1``):
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
   ``tw:solve:dispatch`` and ``tw:fleet:dispatch``. Outside the exp5
   loops a method on the card reads JAX within half a point either way,
   or one point where its call met ill-posed windows. Then ``cli
   scorecard --traces 32`` on the card: its table and calibration
   verdict, K1 launched, the host baselines equal to the JAX package's
   table (``SCORECARD_JAX``) and the solver within one span per regime;
6. kernels: each kernel against its plain PyTorch version on the card,
   on random blocks (ragged, all-masked, padded rows, skip-heavy, tol 0
   and 1e-3; rows not a multiple of the cluster size, fewer rows than
   CTAs in a cluster, one window, more windows than clusters run at
   once, an early tolerance exit, all-invalid padding windows) and on
   the score blocks captured from the slice run, from the fleet's
   chain group ([32, 1025, 2049]) and from the executor phase (the
   largest K1 block of the exp5 loop, of ground-truth-free discovery (a
   block of >= 256 windows, from the exp5 loop and ``alibaba-cg-8k``)
   and of ``alibaba-cg-8k``, less their ill-posed windows: windows with an
   incoming span that has no feasible child and no skip room, whose
   plans are rounding noise);
   ``two-streams``: K1 and K2 launched
   from two host threads on two CUDA streams at once, on those two
   blocks and two small blocks of other shapes (so the threads' launches
   need different shared-memory limits), must equal their single-stream
   launches bit for bit; then
   each kernel's time, its plain version's time and its bound at both
   blocks.

``--slice-root`` runs the slice and fleet phases alone against another
checkout (one process per checkout, since both packages share a name),
so that two commits are compared on one card in turns; its fleet phase
needs a checkout whose ``solve_fleet`` has the pipelined flow.

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
slows the host); ``executor-phase`` the phase's wall.
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
import json
import os
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
FLAGSHIP = "MaxScoreBatchSubsetWithSkips"
HOST_BASELINES = ("WAP5", "FCFS", "vPath", "MaxScore")
# an exp5 graph whose card run met ill-posed windows: the bounds on the
# card's flagship, set from the H100 readings in PERF.md §5 (worst: graph
# 5 reads 6.6 pt above JAX, graph 9 keeps 94% of one service's pairs)
ILL_POSED_MAX_PT = 7.0
ILL_POSED_MIN_PAIRS = 0.9
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
    line = dict(case=name, shape=[B, R, C], ill_posed_windows_left_out=n_ill,
                tol=tol, n_iters=n_iters,
                cluster=K.card_plan(B, R, C, S.device).cluster,
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


def kernel_phase(real_block, fleet_block, executor_blocks):
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
    # the Alibaba corpus has windows where an incoming span has no
    # feasible child and no skip room: their plans are rounding noise
    for name, blk in executor_blocks.items():
        r = check_case(name, blk, 1e-3, posed_only=True)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    two_streams_check(real_block, fleet_block)
    return worst


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
    plan = K.card_plan(B, R, C, S.device)
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
    in_bytes = 4.0 * (B * cells + B * R + B * C)
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
    detail = dict(shape=[B, R, C], cluster=plan.cluster, rows_per_cta=plan.rows_per_cta,
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
# slice
# ---------------------------------------------------------------------------

def run_slice(prob, fused: bool, device="cuda"):
    import torch

    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service

    algo = WeaverTorch({}, {}, fused_kernel=fused, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return out, acc, wall, peak, algo.stats


KERNEL_OF = {True: ("fused_assign", "fused_assign_cuda"),
             False: ("sinkhorn", "sinkhorn_cuda")}


def drive(run, fused: bool, captured=None, want=lambda S: True, largest=False,
          ill=None):
    """Call ``run()`` with the path's kernel wrapper timed by CUDA events
    around each launch (on the launching thread's current stream) and,
    when ``captured`` is a dict, ``assign_topk`` keeping the first block
    ``want`` accepts (with ``largest``, the one of most elements, the
    first of them; a block already in ``captured`` competes too); when
    ``ill`` is a dict, ``assign_topk`` also counts every block's windows
    and ill-posed windows (:func:`ill_posed_windows`) into it: the
    latter as a device sum per block, read once after ``run()``, so the
    count adds no host sync to the timed call. Every
    launch counter is reset just before and read just after. Returns
    ``run()``'s result, the path kernel's launches, the other kernel's
    and the summed kernel device ms (summed over streams: under the
    pipelined fleet flow launches overlap)."""
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    key, wrapper = KERNEL_OF[fused]
    real_wrapper, real_assign_topk, events = getattr(K, wrapper), wt.assign_topk, []
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

    if captured is not None or ill is not None:
        wt.assign_topk = recording
    setattr(K, wrapper, timed)
    try:
        K.reset_launches()
        out = run()
        if ill_sums:
            torch.cuda.synchronize()  # the sums lie on the workers' streams
            ill["ill_posed_windows"] = int(torch.stack(ill_sums).sum())
        launches = K.LAUNCHES[key]
        other = K.LAUNCHES[KERNEL_OF[not fused][0]]
    finally:
        wt.assign_topk = real_assign_topk
        setattr(K, wrapper, real_wrapper)
    return out, launches, other, sum(t0.elapsed_time(t1) for t0, t1 in events)


def slice_phase(card):
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
    launches, captured = {}, {}
    for fused in (True, False):
        key = KERNEL_OF[fused][0]
        (_, acc, wall, peak, stats), launches[key], other, kernel_ms = drive(
            lambda: run_slice(prob, fused), fused, captured if fused else None)
        line = dict(config="synth-async-8k", fused_kernel=fused, accuracy=acc,
                    wall_s=wall, kernel=key, kernel_ms=kernel_ms,
                    kernel_share=kernel_ms / 1e3 / wall,
                    peak_mem_bytes=peak, launches=launches[key],
                    other_kernel_launches=other,
                    fused_em_applied=stats.get("fused_em_applied", 0.0), card=card)
        print("slice " + json.dumps(line), flush=True)
        if launches[key] <= 0:
            raise AssertionError(f"main path (fused={fused}) launched no {key} kernel")
        if acc < ACCURACY_FLOOR:
            raise AssertionError(f"accuracy {acc} < {ACCURACY_FLOOR} (fused={fused})")
    torch.cuda.synchronize()
    return launches, captured["block"]


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------

def agreement(got, ref) -> float:
    """Share of ``ref``'s (endpoint, span) pairs that ``got`` assigns alike."""
    pairs = [(ep, i) for ep in ref for i in ref[ep]]
    return sum(got[ep][i] == ref[ep][i] for ep, i in pairs) / len(pairs)


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
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    return out, acc, wall, peak, stats, quarantined


def fleet_phase(card):
    """The fleet phase (see the module docstring). Returns each kernel's
    launches on the full config, the first score block of the chain
    group, the config's services and the wall of its pipelined K1 run."""
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
    launches, captured, walls = {}, {}, {}
    for fused in (True, False):
        key = KERNEL_OF[fused][0]
        runs = {}
        for pipeline in (True, False):
            confs = [None] * len(probs)
            runs[pipeline], n, line = fleet_run(
                "fleet", probs, fused, floors, card, captured if fused else None,
                pipeline=pipeline, confidences=confs)
            walls[(fused, pipeline)] = line["wall_s"]
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
    torch.cuda.synchronize()
    return launches, captured["block"], probs, walls[(True, True)]


def fleet_run(tag, probs, fused, floors, card, captured=None, **kw):
    """One full-size ``solve_fleet`` through :func:`drive`, its line
    printed under ``tag``; fails on a missing launch, an accuracy below
    its floor, a moved ``fault_*`` counter or a quarantine. Returns the
    :func:`run_fleet` tuple, the path kernel's launches and the line."""
    key = KERNEL_OF[fused][0]
    n_spans = sum(len(next(iter(p["in_parts"].values()))) for p in probs)
    result, launches, other, kernel_ms = drive(
        lambda: run_fleet(probs, fused, **kw), fused, captured,
        want=lambda S: S.shape[0] >= 32 and S.shape[1:] == (1025, 2049))
    _, acc, wall, peak, stats, quarantined = result
    faults = {k: v for k, v in stats.items() if k.startswith("fault")}
    line = dict(
        config="synth-fleet-8svc", fused_kernel=fused,
        pipeline=kw.get("pipeline", True), wall_s=wall,
        spans_per_s=n_spans / wall, kernel=key, kernel_ms_summed=kernel_ms,
        launches=launches, other_kernel_launches=other, peak_mem_bytes=peak,
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
    device bytes and wall seconds (after a synchronise)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res, _ = _run_cli_captured(argv)
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated(), time.perf_counter() - t0


def _cpu_worker_init() -> None:
    """A CPU rerun process: two threads, so the workers share the cores."""
    import torch

    torch.set_num_threads(2)


def cpu_flagship(graph_dir, n, results, gt_free=False):
    """Worker: the flagship of one exp5 graph through the CLI on the CPU
    (``--device cpu``, ``--gt_free_dag`` with ``gt_free``); returns its
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

    argv = (exp5_argv(graph_dir, n, results, predictors="10") + ["--device", "cpu"]
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
    """A pool of ``workers`` spawned processes for :func:`cpu_flagship`,
    started after the card phases so they do not slow the timed host
    work; :meth:`close` stops every process."""

    def __init__(self, workers: int = 4):
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor

        self.pool = ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            initializer=_cpu_worker_init)

    def submit(self, *args, **kw):
        return self.pool.submit(cpu_flagship, *args, **kw)

    def close(self, cancel=False):
        self.pool.shutdown(wait=True, cancel_futures=cancel)


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
    print(f"{tag} " + json.dumps(line), flush=True)
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


def card_vs_cpu(tag, name, card_res, ill, ref, cpu, card, **extra):
    """The two-sided flagship check of one exp5 graph against the port's
    own CPU run ``cpu`` (:func:`cpu_flagship`) and the JAX package's
    reading ``ref``: with no ill-posed window on the card, the card reads
    ``ref`` within half a point either way and assigns at least 99% of
    every service's pairs as the CPU run does; otherwise the CPU run must
    equal ``ref`` exactly and the card is held to the looser two-sided
    bounds ``ILL_POSED_MAX_PT`` and ``ILL_POSED_MIN_PAIRS``. Prints the
    ``executor-card-vs-cpu`` line and returns what failed ("" when
    nothing did)."""
    got = card_res.accuracy_overall[FLAGSHIP]
    pairs = {p: agreement(card_res.flagship_pred[p], pred)
             for p, pred in cpu["pred"].items()}
    clean = ill["ill_posed_windows"] == 0
    low = {p: v for p, v in pairs.items()
           if v < (0.99 if clean else ILL_POSED_MIN_PAIRS)}
    line = dict(config="alibaba-exp5-15000", run=tag, graph=name,
                flagship_card=got, flagship_cpu=cpu["accuracy"], flagship_jax_cpu=ref,
                card_within_half_pt_of_jax=abs(got - ref) <= 0.5,
                card_ill_posed_windows=ill["ill_posed_windows"],
                card_windows=ill["windows"],
                cpu_ill_posed_windows=cpu["ill_posed_windows"],
                cpu_windows=cpu["windows"], cpu_wall_s=cpu["wall_s"],
                card_vs_cpu_pairs=pairs,
                rule="within 0.5 pt of JAX, >= 0.99 pairs" if clean
                else (f"CPU equals JAX, card within {ILL_POSED_MAX_PT} pt of JAX, "
                      f">= {ILL_POSED_MIN_PAIRS} pairs"), card=card, **extra)
    print("executor-card-vs-cpu " + json.dumps(line), flush=True)
    if clean and (abs(got - ref) > 0.5 or low):
        return (f"{tag} {name}: card {got} vs JAX {ref}, pairs under 0.99 {low}, "
                "with no ill-posed window")
    if not clean and cpu["accuracy"] != ref:
        return f"{tag} {name}: the port on the CPU reads {cpu['accuracy']}, JAX {ref}"
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
    profiler slows the host)."""
    busy_s = report["device_busy"] / 1e6
    line = dict(config=config, call=tag, traced_wall_s=wall,
                traced_window_s=report["wall"] / 1e6, device_busy_s=busy_s,
                idle_share=report["idle_share"], unprofiled_wall_s=unprofiled_wall_s,
                idle_share_of_unprofiled_wall=1.0 - busy_s / unprofiled_wall_s,
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


def executor_phase(card, root):
    """Config ``alibaba-exp5-15000`` through the CLI, graph by graph, with
    the ground-truth DAG and then without it, exp4's predictors on graph
    0 with and without the thread pool, the metrics and events run and
    the ``query`` subcommand, then config ``alibaba-cg-8k`` plainly and
    without ground truth, and that call under the profiler. Returns the
    K1 and K2 launches of the ground-truth runs and of the
    ground-truth-free ones, the largest K1 block of the exp5 loop, of
    ground-truth-free discovery and of ``alibaba-cg-8k``, and what
    :func:`rerun_checks` needs: the graphs, both loops' card results and
    the graphs whose ground-truth-free run needs its own CPU rerun."""
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.runtime.executor import RESULT_FAMILIES

    t_phase = time.perf_counter()
    launches = {"fused_assign": 0, "sinkhorn": 0}
    gtfree_launches = {"fused_assign": 0, "sinkhorn": 0}
    blocks = {"executor-exp5-block": {}, "executor-gtfree-block": {},
              "executor-cg8k-block": {}}

    def driven(argv, captured=None, tally=launches, want=lambda S: True):
        ill = {}
        (res, peak, wall), n, other, ms = drive(lambda: run_cli(argv), True,
                                                captured, want, largest=True, ill=ill)
        tally["fused_assign"] += n
        tally["sinkhorn"] += other
        if res.store.ingest_front_end != "native":
            raise AssertionError(f"cli {argv}: ingest ran {res.store.ingest_front_end}")
        return res, peak, wall, n, ms, ill

    corpus, results = os.path.join(root, "exp5"), os.path.join(root, "results")
    t0 = time.perf_counter()
    dirs = synthesize_corpus(corpus, n_graphs=15, traces_per_graph=1000, seed=10)
    print(f"executor-corpus alibaba-exp5-15000: {len(dirs)} call graphs in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
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

    gtfree_runs, own_rerun = {}, []

    def discovery(S):
        """Discovery's blocks: the flagship's are those the ground-truth
        loop already keeps."""
        return S.shape[0] >= DISCOVERY_MIN_WINDOWS
    for n, (name, d) in enumerate(zip(names, dirs)):
        res, peak, wall, k1, ms, ill = driven(
            exp5_argv(d, n, os.path.join(root, "results-gtfree"), predictors="10")
            + ["--gt_free_dag", "1"], blocks["executor-gtfree-block"],
            tally=gtfree_launches, want=discovery)
        edges = {p: g.edges() for p, g in res.store.discovered_dags.items()}
        truth_edges = gt_dag_edges(res.store)
        jax_acc, jax_edges = EXP5_GTFREE_JAX[name]
        gt_res = gt_runs[name][0]
        same_as_gt_run = res.flagship_pred == gt_res.flagship_pred
        executor_line(
            "executor-gtfree", res, peak, wall, k1, ms, ill, card,
            config="alibaba-exp5-15000", graph=name, gt_free_dag=True,
            discovered_edges=edges, edges_equal_gt_dag=edges == truth_edges,
            edges_equal_jax={p: [list(e) for e in v] for p, v in edges.items()}
            == jax_edges, flagship_gt_dag=gt_res.accuracy_overall[FLAGSHIP],
            flagship_jax_cpu=jax_acc, predictions_equal_gt_dag_run=same_as_gt_run,
            discovery={p: st for p, st in res.store.discovery_stats.items()})
        if k1 <= 0:
            raise AssertionError(f"gt-free {name}: no fused_assign launch")
        if not (edges == truth_edges and same_as_gt_run):
            own_rerun.append(name)  # other DAGs: the CPU discovers its own
        gtfree_runs[name] = (res, ill)

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

    big = os.path.join(root, "cg8k")
    t0 = time.perf_counter()
    (d,) = synthesize_corpus(big, n_graphs=1, traces_per_graph=8192, seed=10)
    synth_s = time.perf_counter() - t0
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
    argv = exp5_argv(d, 0, os.path.join(root, "results-8k-gtfree"), predictors="10",
                     max_traces=8192) + ["--gt_free_dag", "1"]
    res, peak, wall, k1, ms, ill = driven(argv, blocks["executor-gtfree-block"],
                                          tally=gtfree_launches, want=discovery)
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
    profiled_cli(argv, card, line)

    if not blocks["executor-gtfree-block"]:
        raise AssertionError("ground-truth-free runs: no discovery block of "
                             f">= {DISCOVERY_MIN_WINDOWS} windows")
    shapes = {k: list(v["block"]["S"].shape) for k, v in blocks.items()}
    print(f"executor-phase: {time.perf_counter() - t_phase:.3f} s wall, "
          f"launches {json.dumps(launches)}, ground-truth-free launches "
          f"{json.dumps(gtfree_launches)}, K1 blocks kept {json.dumps(shapes)}",
          flush=True)
    return (launches, gtfree_launches, {k: v["block"] for k, v in blocks.items()},
            (dirs, gt_runs, gtfree_runs, own_rerun))


def rerun_checks(card, root, dirs, gt_runs, gtfree_runs, own_rerun):
    """The flagship of every exp5 graph on the CPU (:class:`CpuReruns`),
    ground-truth-free too where ``own_rerun`` names the graph, then the
    two-sided flagship checks of both exp5 loops against those runs, and
    the ground-truth-free flagship within one point of the
    ground-truth-DAG one on every graph with no ill-posed window."""
    t0 = time.perf_counter()
    names = [os.path.basename(d) for d in dirs]
    reruns = CpuReruns()
    ok = False
    try:
        cpu_gtfree = {name: reruns.submit(d, n, os.path.join(root, "cpu-gtfree", name),
                                          gt_free=True)
                      for n, (name, d) in enumerate(zip(names, dirs)) if name in own_rerun}
        cpu_gt = {name: reruns.submit(d, n, os.path.join(root, "cpu", name))
                  for n, (name, d) in enumerate(zip(names, dirs))}
        cpu_gt = {name: fut.result() for name, fut in cpu_gt.items()}
        cpu_gtfree = {name: fut.result() for name, fut in cpu_gtfree.items()}
        ok = True
    finally:
        reruns.close(cancel=not ok)
    failed = []
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
    print(f"executor-cpu-reruns: {len(cpu_gt) + len(cpu_gtfree)} runs in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    failed = [f for f in failed if f]
    if failed:
        raise AssertionError("; ".join(failed))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slice-root", help="run only the slice and fleet phases, "
                    "importing traceweaver_tpu_torch from this checkout")
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
    if args.slice_root:
        report = K.build(verbose=True)
    else:
        from concurrent.futures import ThreadPoolExecutor

        from traceweaver_tpu_torch import native

        # g++ builds the C++ loader while nvcc builds the kernels
        with ThreadPoolExecutor(1) as pool:
            loader = pool.submit(native.build)
            report = K.build(verbose=True)
            print(f"loader: {os.path.basename(loader.result())}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s", flush=True)
    for ln in report.splitlines():
        if "registers" in ln or "spill" in ln:
            print("ptxas " + ln.strip(), flush=True)

    if args.slice_root:
        print(f"package: {os.path.dirname(os.path.dirname(K.__file__))}", flush=True)
        slice_phase(card)
        fleet_phase(card)
        return 0
    launches, real_block = slice_phase(card)
    fleet_launches, fleet_block, probs, fleet_wall = fleet_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        fleet_profile(probs, fleet_wall, card)
        del probs
        fault_run(tmp, card)
        executor_launches, gtfree_launches, executor_blocks, rerun_state = \
            executor_phase(card, tmp)
        scorecard_launches = scorecard_phase(card)
        K.reset_launches()
        worst = kernel_phase(real_block, fleet_block, executor_blocks)
        checks = dict(K.LAUNCHES)
        timing = kernel_timing(real_block)
        fleet_timing = kernel_timing(fleet_block)
        # the CPU work last, so that no timed phase shares the host with it
        rerun_checks(card, tmp, *rerun_state)
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
        "round_topk": checks["round_topk"]}), flush=True)
    src = "traceweaver_tpu_torch/ops/csrc/sinkhorn.cu"
    fleet_shape = list(fleet_block["S"].shape)

    def row(name, replaces, body, call, err):
        fleet = {f"fleet_{k}": v for k, v in fleet_timing[name].items()}
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    tpu_kernel_body=body, pallas_call=call,
                    launches=launches[name], max_abs_err=worst[err],
                    library_ms=None, **timing[name],
                    fleet_launches=fleet_launches[name], fleet_shape=fleet_shape,
                    executor_launches=executor_launches[name],
                    gtfree_launches=gtfree_launches[name],
                    scorecard_launches=scorecard_launches if name == "fused_assign" else 0,
                    executor_shapes={k: list(v["S"].shape)
                                     for k, v in executor_blocks.items()},
                    **fleet)

    pallas = "traceweaver_tpu/ops/pallas_sinkhorn.py"
    table = [row("fused_assign", f"{pallas}:308", f"{pallas}:219 _fused_kernel",
                 f"{pallas}:357", "k1_err"),
             row("sinkhorn", f"{pallas}:140", f"{pallas}:80 _kernel",
                 f"{pallas}:184", "plan_err")]
    print(json.dumps({"kernels": table}), flush=True)
    torch.cuda.synchronize()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
