#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py      # needs one CUDA card
    python3 chip_smoke.py --slice-root DIR   # only the slice and fleet
                                             # phases, with the package
                                             # of checkout DIR

Phases, each of which raises on failure (non-zero exit):

1. build the CUDA kernels from ``traceweaver_tpu_torch/ops/csrc`` with
   nvcc and print ptxas's register and spill report;
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
4. executor: config ``alibaba-exp5-15000``: the port's synthesizer
   writes exp5's corpus (15 call graphs x 1000 traces, seed 10, replica
   table) and the port's CLI ``main(argv)`` runs in this process once per
   graph with exp5's arguments (fix 5, compress 15000, predictors
   3,4,7,10, ``--execute_parallel 0``); WAP5, FCFS and vPath must equal
   the JAX package's end-to-end accuracy on the CPU
   (``EXP5_JAX_ACCURACY``), the flagship reach it less one point, and
   all five result-pickle families must exist for every graph. A graph
   whose flagship reads other than JAX's runs the flagship again on the
   CPU (``--device cpu``), which must equal JAX's; the line gives the
   share of pairs the card assigns alike and the CPU run's ill-posed
   windows (see the kernels phase). Then
   graph 0 with exp4's predictors 2,8,9,10 at compress 1, with
   ``--execute_parallel`` 0 and 1: equal results, slot 2 equal to the
   JAX number and slots 8-10 at least it less one point
   (``EXP4_JAX_ACCURACY``). Then config ``alibaba-cg-8k`` (call graph 0
   of seed 10 at 8192 traces, predictor 10) against
   ``CG8K_JAX_ACCURACY`` less one point. Each CLI call runs with every
   launch counter reset just before and read just after, and must
   launch K1;
5. kernels: each kernel against its plain PyTorch version on the card,
   on random blocks (ragged, all-masked, padded rows, skip-heavy, tol 0
   and 1e-3; rows not a multiple of the cluster size, fewer rows than
   CTAs in a cluster, one window, more windows than clusters run at
   once, an early tolerance exit, all-invalid padding windows) and on
   the score blocks captured from the slice run, from the fleet's
   chain group ([32, 1025, 2049]) and from the executor phase (the
   largest K1 block of the exp5 loop and of ``alibaba-cg-8k``, less
   their ill-posed windows: windows with an incoming span that has no
   feasible child and no skip room, whose plans are rounding noise);
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
flagship's accuracy per service; ``executor-phase`` the phase's wall.
The kernel-timing lines carry each kernel's cluster size and the three
terms of its bound.

The last lines are the launch counts, the kernel table as one JSON
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
FLAGSHIP = "MaxScoreBatchSubsetWithSkips"
HOST_BASELINES = ("WAP5", "FCFS", "vPath", "MaxScore")
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


def drive(run, fused: bool, captured=None, want=lambda S: True, largest=False):
    """Call ``run()`` with the path's kernel wrapper timed by CUDA events
    around each launch (on the launching thread's current stream) and,
    when ``captured`` is a dict, ``assign_topk`` keeping the first block
    ``want`` accepts (with ``largest``, the one of most elements, the
    first of them; a block already in ``captured`` competes too); every
    launch counter is reset just before and read just after. Returns
    ``run()``'s result, the path kernel's launches, the other kernel's
    and the summed kernel device ms (summed over streams: under the
    pipelined fleet flow launches overlap)."""
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    key, wrapper = KERNEL_OF[fused]
    real_wrapper, real_assign_topk, events = getattr(K, wrapper), wt.assign_topk, []
    lock = threading.Lock()

    def timed(*args, **kw):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        out = real_wrapper(*args, **kw)
        t1.record()
        events.append((t0, t1))
        return out

    def recording(*args, **kw):
        # flow workers launch from several threads: check and set at once
        with lock:
            held = captured.get("block")
            if want(args[0]) and (held is None or largest
                                  and args[0].numel() > held["S"].numel()):
                S, rm, cm, in_v, cv, cap, W = args
                captured["block"] = dict(S=S, row_marg=rm, col_marg=cm, in_v=in_v,
                                         col_valid=cv, cap=cap, n_rows=W)
        return real_assign_topk(*args, **kw)

    if captured is not None:
        wt.assign_topk = recording
    setattr(K, wrapper, timed)
    try:
        K.reset_launches()
        out = run()
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
    launches on the full config and the first score block of the chain
    group."""
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
    launches, captured = {}, {}
    for fused in (True, False):
        key = KERNEL_OF[fused][0]
        runs = {}
        for pipeline in (True, False):
            confs = [None] * len(probs)
            runs[pipeline], n, _ = fleet_run(
                "fleet", probs, fused, floors, card, captured if fused else None,
                pipeline=pipeline, confidences=confs)
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
    return launches, captured["block"]


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

def run_cli(argv):
    """The port's CLI ``main(argv)`` in this process, on the card unless
    ``argv`` names another device; returns the ``ExperimentResults`` its
    ``run_experiment`` made (with ``flagship_pred``, the flagship's
    assignments per service), peak device bytes and wall seconds."""
    import torch

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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    X.run_experiment, X._solve_fleet_method = capture, fleet_capture
    t0 = time.perf_counter()
    try:
        rc = cli.main(argv)
    finally:
        X.run_experiment, X._solve_fleet_method = real, real_fleet
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if rc != 0 or len(made) != 1:
        raise AssertionError(f"cli {argv} exited {rc}")
    made[0].flagship_pred = flagship
    return made[0], torch.cuda.max_memory_allocated(), wall


def card_vs_cpu(graph_dir, n, root, card_res, card):
    """The flagship on the CPU through the CLI (``--device cpu``) for a
    graph whose card reading differs from the JAX package's: the CPU
    must equal JAX exactly; prints the share of each service's pairs the
    card assigns alike and the ill-posed windows of the CPU run."""
    import traceweaver_tpu_torch.algorithms.weaver_torch as wt

    name = os.path.basename(graph_dir)
    real_assign_topk, windows = wt.assign_topk, [0, 0]

    def counting(*args, **kw):
        windows[0] += int(ill_posed_windows(*args[:3]).sum())
        windows[1] += args[0].shape[0]
        return real_assign_topk(*args, **kw)

    wt.assign_topk = counting
    try:
        res, _, wall = run_cli(exp5_argv(graph_dir, n, os.path.join(root, "results-cpu"),
                                         predictors="10") + ["--device", "cpu"])
    finally:
        wt.assign_topk = real_assign_topk
    acc = res.accuracy_overall[FLAGSHIP]
    pairs = {p: agreement(card_res.flagship_pred[p], pred)
             for p, pred in res.flagship_pred.items()}
    print("executor-card-vs-cpu " + json.dumps(dict(
        config="alibaba-exp5-15000", graph=name, cpu_wall_s=wall,
        flagship_card=card_res.accuracy_overall[FLAGSHIP], flagship_cpu=acc,
        flagship_jax_cpu=EXP5_JAX_ACCURACY[name][FLAGSHIP],
        card_vs_cpu_pairs=pairs, ill_posed_windows=windows[0],
        windows=windows[1], card=card)), flush=True)
    if acc != EXP5_JAX_ACCURACY[name][FLAGSHIP]:
        raise AssertionError(f"exp5 {name}: the port on the CPU reads {acc}, "
                             f"JAX {EXP5_JAX_ACCURACY[name][FLAGSHIP]}")


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


def executor_line(tag, res, peak, wall, launches, kernel_ms, card, **extra):
    services, spans = solved(res)
    fleet = res.fleet_stats.get(FLAGSHIP, {})
    acc = {k: v for k, v in res.accuracy_overall.items() if not k.endswith("TopK")}
    per_service = {p: a for (k, p), a in res.accuracy_per_process.items() if k == FLAGSHIP}
    line = dict(services=services, incoming_spans=spans, wall_s=wall,
                seconds=res.seconds, fleet_dispatches=fleet.get("fleet_dispatches", 0.0),
                fused_assign_launches=launches, fused_assign_ms_summed=kernel_ms,
                peak_mem_bytes=peak, accuracy=acc, flagship_per_service=per_service,
                card=card, **extra)
    print(f"{tag} " + json.dumps(line), flush=True)
    return line


def check_accuracy(tag, acc, jax_acc, exact=HOST_BASELINES):
    """Host baselines equal the JAX package's; every other method reaches
    the JAX number less one point."""
    for method, ref in jax_acc.items():
        got = acc[method]
        if method in exact:
            if got != ref:
                raise AssertionError(f"{tag} {method}: {got} != JAX {ref}")
        elif got < ref - 1.0:
            raise AssertionError(f"{tag} {method}: {got} < JAX {ref} less one point")


def executor_phase(card, root):
    """Config ``alibaba-exp5-15000`` through the CLI, graph by graph, then
    exp4's predictors on graph 0 with and without the thread pool, then
    config ``alibaba-cg-8k``. Returns the K1 and K2 launches of the phase
    and the largest K1 block of the exp5 loop and of ``alibaba-cg-8k``,
    for the kernel phase to hold against the plain version."""
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.runtime.executor import RESULT_FAMILIES

    t_phase = time.perf_counter()
    launches = {"fused_assign": 0, "sinkhorn": 0}

    blocks = {"executor-exp5-block": {}, "executor-cg8k-block": {}}

    def driven(argv, captured=None):
        (res, peak, wall), n, other, ms = drive(lambda: run_cli(argv), True,
                                                captured, largest=True)
        launches["fused_assign"] += n
        launches["sinkhorn"] += other
        return res, peak, wall, n, ms

    corpus, results = os.path.join(root, "exp5"), os.path.join(root, "results")
    t0 = time.perf_counter()
    dirs = synthesize_corpus(corpus, n_graphs=15, traces_per_graph=1000, seed=10)
    print(f"executor-corpus alibaba-exp5-15000: {len(dirs)} call graphs in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    if [os.path.basename(d) for d in dirs] != list(EXP5_JAX_ACCURACY):
        raise AssertionError(f"corpus graphs {dirs}")
    for n, d in enumerate(dirs):
        res, peak, wall, k1, ms = driven(exp5_argv(d, n, results),
                                         blocks["executor-exp5-block"])
        line = executor_line("executor", res, peak, wall, k1, ms, card,
                             config="alibaba-exp5-15000", graph=os.path.basename(d))
        check_accuracy(f"exp5 {line['graph']}", line["accuracy"],
                       EXP5_JAX_ACCURACY[line["graph"]])
        if k1 <= 0:
            raise AssertionError(f"exp5 {line['graph']}: no fused_assign launch")
        if line["accuracy"][FLAGSHIP] != EXP5_JAX_ACCURACY[line["graph"]][FLAGSHIP]:
            card_vs_cpu(d, n, root, res, card)
    names = set(os.listdir(results))
    missing = [f"{kind}_alibaba_cg_{n}_load_multiple_1_15000_1_0.0.pickle"
               for n in range(len(dirs)) for kind in RESULT_FAMILIES]
    missing = [m for m in missing if m not in names]
    if missing:
        raise AssertionError(f"result pickles missing: {missing}")

    by_pool = {}
    for pool in (0, 1):
        res, peak, wall, k1, ms = driven(exp5_argv(
            dirs[0], 0, os.path.join(root, f"exp4-{pool}"), compress=1,
            predictors="2,8,9,10", execute_parallel=pool))
        line = executor_line("executor", res, peak, wall, k1, ms, card,
                             config="alibaba-exp5-15000", graph="call_graph_0",
                             predictors="2,8,9,10", compress=1, execute_parallel=pool)
        check_accuracy(f"exp4 execute_parallel={pool}", line["accuracy"],
                       EXP4_JAX_ACCURACY)
        by_pool[pool] = (res.accuracy_overall, res.accuracy_per_process)
    if by_pool[0] != by_pool[1]:
        raise AssertionError(f"execute_parallel changes the results: {by_pool}")

    big = os.path.join(root, "cg8k")
    t0 = time.perf_counter()
    (d,) = synthesize_corpus(big, n_graphs=1, traces_per_graph=8192, seed=10)
    synth_s = time.perf_counter() - t0
    res, peak, wall, k1, ms = driven(exp5_argv(
        d, 0, os.path.join(root, "results-8k"), predictors="10", max_traces=8192),
        blocks["executor-cg8k-block"])
    fleet = res.fleet_stats[FLAGSHIP]
    _, spans = solved(res)
    line = executor_line(
        "executor", res, peak, wall, k1, ms, card, config="alibaba-cg-8k",
        synthesize_s=synth_s, spans_per_s=spans / res.seconds[FLAGSHIP],
        **{k: fleet.get(k, 0.0) for k in ("prepare_s", "plan_fit_s", "pack_s",
                                          "dispatch_s", "wait_s", "decode_s")})
    check_accuracy("cg-8k", line["accuracy"], CG8K_JAX_ACCURACY)
    if k1 <= 0:
        raise AssertionError("cg-8k: no fused_assign launch")
    shapes = {k: list(v["block"]["S"].shape) for k, v in blocks.items()}
    print(f"executor-phase: {time.perf_counter() - t_phase:.3f} s wall, "
          f"launches {json.dumps(launches)}, K1 blocks kept {json.dumps(shapes)}",
          flush=True)
    return launches, {k: v["block"] for k, v in blocks.items()}


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
    report = K.build(verbose=True)
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
    fleet_launches, fleet_block = fleet_phase(card)
    with tempfile.TemporaryDirectory() as tmp:
        executor_launches, executor_blocks = executor_phase(card, tmp)
    K.reset_launches()
    worst = kernel_phase(real_block, fleet_block, executor_blocks)
    checks = dict(K.LAUNCHES)
    timing = kernel_timing(real_block)
    fleet_timing = kernel_timing(fleet_block)
    print("kernels: " + json.dumps({
        "fused_assign": launches["fused_assign"],
        "sinkhorn": launches["sinkhorn"],
        "fleet_fused_assign": fleet_launches["fused_assign"],
        "fleet_sinkhorn": fleet_launches["sinkhorn"],
        "executor_fused_assign": executor_launches["fused_assign"],
        "executor_sinkhorn": executor_launches["sinkhorn"],
        "round_topk": checks["round_topk"]}), flush=True)
    src = "traceweaver_tpu_torch/ops/csrc/sinkhorn.cu"
    fleet_shape = list(fleet_block["S"].shape)

    def row(name, replaces, err):
        fleet = {f"fleet_{k}": v for k, v in fleet_timing[name].items()}
        return dict(name=name, route="cuda", source=src, replaces=replaces,
                    launches=launches[name], max_abs_err=worst[err],
                    library_ms=None, **timing[name],
                    fleet_launches=fleet_launches[name], fleet_shape=fleet_shape,
                    executor_launches=executor_launches[name],
                    executor_shapes={k: list(v["S"].shape)
                                     for k, v in executor_blocks.items()},
                    **fleet)

    table = [row("fused_assign", "traceweaver_tpu/ops/pallas_sinkhorn.py:308", "k1_err"),
             row("sinkhorn", "traceweaver_tpu/ops/pallas_sinkhorn.py:140", "plan_err")]
    print(json.dumps({"kernels": table}), flush=True)
    torch.cuda.synchronize()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
