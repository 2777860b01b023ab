#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain versions.

    python3 chip_smoke.py      # needs one CUDA card

Phases, each of which raises on failure (non-zero exit):

1. build the CUDA kernels from ``traceweaver_tpu_torch/ops/csrc`` with
   nvcc and print ptxas's register and spill report;
2. slice: config ``synth-async-8k`` (8192 requests, three chained
   endpoints) through ``WeaverTorch.FindAssignments`` on the card, once
   with the fused kernel and once with the plain Sinkhorn kernel, each
   with its launch counter reset just before and read just after;
   accuracy must reach ``ACCURACY_FLOOR``; a 256-request cut must give
   the same assignments on the card as on the CPU;
3. kernels: each kernel against its plain PyTorch version on the card,
   on random blocks (ragged, all-masked, padded rows, skip-heavy, tol 0
   and 1e-3) and on a score block captured from the slice run; then
   each kernel's time, its plain version's time and its bound at the
   main-path block.

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
import time

# JAX package on the CPU, same config: 0.9847412109375
# (tests/jax_reference_synth.py), less one point
ACCURACY_FLOOR = 0.9747
# NVIDIA H100 SXM data sheet: HBM rate and f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

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
                  all_masked_cols=False, cap_max=4, cap_zero=False):
    """B OT blocks in the solver's layout ([W+1, M+1] with the dummy row
    and the skip column), as numpy: scores, row/col marginals, row and
    column validity, skip capacity."""
    import numpy as np

    S = rng.normal(scale=5.0, size=(B, W + 1, M + 1)).astype(np.float32)
    in_v = rng.random((B, W)) < row_frac
    in_v[:, 0] = True
    o_v = np.zeros((B, M), bool) if all_masked_cols else rng.random((B, M)) < col_frac
    cap = rng.integers(0, cap_max, size=B).astype(np.float32)
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

def check_case(name, blk, tol, n_iters=40):
    """Hold K2, round_topk and K1 against their plain versions on one
    batch of blocks; returns the numbers of the comparison."""
    import numpy as np
    import torch

    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.ops.compare import assign_diff_report, topk_diff_report
    from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

    S, rm, cm = blk["S"], blk["row_marg"], blk["col_marg"]
    in_v, cv, cap, W = blk["in_v"], blk["col_valid"], blk["cap"], blk["n_rows"]
    kw = dict(epsilon=1.0, n_iters=n_iters, tol=tol)

    plan_p = sinkhorn_log(S, rm, cm, **kw)
    plan_k = K.sinkhorn_cuda(S, rm, cm, **kw)
    torch.cuda.synchronize()
    plan_err = float((plan_k - plan_p).abs().max()) if plan_p.numel() else 0.0
    if not torch.allclose(plan_k, plan_p, atol=1e-5, rtol=1e-4):
        raise AssertionError(f"{name}: K2 plan differs from plain (max abs {plan_err})")

    rk = dict(topk=TOPK, min_topk_mass=MIN_MASS)
    pp = plan_p[:, :W].contiguous()
    a_r, tk_r = K.round_topk_cuda(pp, in_v, cv, cap, **rk)
    a_rp, tk_rp = K.round_topk_plain(pp, in_v, cv, cap, **rk)
    if not (torch.equal(a_r, a_rp) and torch.equal(tk_r, tk_rp)):
        raise AssertionError(f"{name}: round_topk_cuda differs from the plain rounding")

    a_k, tk_k = K.fused_assign_cuda(S, rm, cm, cap, W, min_topk_mass=MIN_MASS,
                                    topk=TOPK, **kw)
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
    line = dict(case=name, shape=list(S.shape), tol=tol, plan_max_abs_err=plan_err,
                k1_rows=rows, k1_assign_differ=st["differ"],
                k1_row_ties=st["row_tie"], k1_contention=st["contention"],
                k1_topk_differ=tk_differ, k1_agreement=agree)
    print("kernel-check " + json.dumps(line), flush=True)
    if agree < 0.999 or st["unexplained"] or tk_bad:
        raise AssertionError(f"{name}: fused kernel vs plain: {line}, "
                             f"unexplained assign rows {st['unexplained']}, "
                             f"unexplained top-k rows {tk_bad}")
    return dict(plan_err=plan_err, k1_err=err)


def kernel_phase(real_block):
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
    ]
    worst = dict(plan_err=0.0, k1_err=0.0)
    for name, blk, tol in cases:
        r = check_case(name, to_cuda(blk), tol)
        for k in worst:
            worst[k] = max(worst[k], r[k])
    r = check_case("slice-block", real_block, 1e-3)
    for k in worst:
        worst[k] = max(worst[k], r[k])
    return worst


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
    iters = int(stats[:, 0].sum())
    rounds = int(stats[:, 1].sum())
    cells = R * C
    # operations these inputs need: per Sinkhorn iteration and element
    # a multiply, two adds, an exp and a compare/accumulate in each of
    # the row and column passes (10); forming the plan once (6); per
    # rounding round one compare per element of the row and the column
    # argmax (2 x rows x C); k compares per element for the top-k peel
    sink_ops = 10.0 * iters * cells
    plan_ops = 6.0 * B * cells
    k1_ops = sink_ops + plan_ops + 2.0 * rounds * W * C + TOPK * B * W * C
    k2_ops = 10.0 * int(k2_iters.sum()) * cells + plan_ops
    in_bytes = 4.0 * (B * cells + B * R + B * C)
    k1_bytes = in_bytes + 4.0 * B + 4.0 * B * W * (1 + TOPK)
    k2_bytes = in_bytes + 4.0 * B * cells

    def bound(nbytes, ops):
        tb, to = nbytes / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S
        return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")

    k1_bound, k1_by = bound(k1_bytes, k1_ops)
    k2_bound, k2_by = bound(k2_bytes, k2_ops)
    reps = 5
    k1_ms = cuda_ms(lambda: K.fused_assign_cuda(S, rm, cm, cap, W, topk=TOPK,
                                                min_topk_mass=MIN_MASS, **kw), reps)
    k1_plain = cuda_ms(lambda: K.assign_topk_plain(S, rm, cm, in_v, cv, cap, W, topk=TOPK,
                                                   min_topk_mass=MIN_MASS, **kw), reps)
    k2_ms = cuda_ms(lambda: K.sinkhorn_cuda(S, rm, cm, **kw), reps)
    k2_plain = cuda_ms(lambda: sinkhorn_log(S, rm, cm, **kw), reps)
    detail = dict(shape=[B, R, C], sinkhorn_iters=iters, rounding_rounds=rounds,
                  k2_sinkhorn_iters=int(k2_iters.sum()))
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


def slice_phase(card):
    import torch

    import traceweaver_tpu_torch.algorithms.weaver_torch as wt
    from traceweaver_tpu_torch.metrics.synth import synth_async_8k
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    # reference on a small input: the same cut on the card and on the CPU
    small = synth_async_8k(256)
    on_card = run_slice(small, True)[0][0]
    on_cpu = run_slice(small, True, device="cpu")[0][0]
    pairs = [(ep, i) for ep in on_cpu for i in on_cpu[ep]]
    same = sum(on_card[ep][i] == on_cpu[ep][i] for ep, i in pairs) / len(pairs)
    print(f"slice-small: 256 requests, card vs CPU identical pairs {same:.6f}", flush=True)
    if same < 0.99:
        raise AssertionError(f"card and CPU assignments agree on {same} < 0.99 of pairs")

    prob = synth_async_8k()
    launches, captured = {}, {}
    real_assign_topk = wt.assign_topk

    def recording(*args, **kw):
        if "block" not in captured:
            S, rm, cm, in_v, cv, cap, W = args
            captured["block"] = dict(S=S, row_marg=rm, col_marg=cm, in_v=in_v,
                                     col_valid=cv, cap=cap, n_rows=W)
        return real_assign_topk(*args, **kw)

    for fused, key in ((True, "fused_assign"), (False, "sinkhorn")):
        wt.assign_topk = recording if fused else real_assign_topk
        try:
            K.reset_launches()
            _, acc, wall, peak, stats = run_slice(prob, fused)
            launches[key] = K.LAUNCHES[key]
            other = K.LAUNCHES["sinkhorn" if fused else "fused_assign"]
        finally:
            wt.assign_topk = real_assign_topk
        line = dict(config="synth-async-8k", fused_kernel=fused, accuracy=acc,
                    wall_s=wall, peak_mem_bytes=peak, launches=launches[key],
                    other_kernel_launches=other,
                    fused_em_applied=stats.get("fused_em_applied", 0.0), card=card)
        print("slice " + json.dumps(line), flush=True)
        if launches[key] <= 0:
            raise AssertionError(f"main path (fused={fused}) launched no {key} kernel")
        if acc < ACCURACY_FLOOR:
            raise AssertionError(f"accuracy {acc} < {ACCURACY_FLOOR} (fused={fused})")
    torch.cuda.synchronize()
    return launches, captured["block"]


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
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

    launches, real_block = slice_phase(card)
    K.reset_launches()
    worst = kernel_phase(real_block)
    checks = dict(K.LAUNCHES)
    timing = kernel_timing(real_block)
    print("kernels: " + json.dumps({
        "fused_assign": launches["fused_assign"],
        "sinkhorn": launches["sinkhorn"],
        "round_topk": checks["round_topk"]}), flush=True)
    src = "traceweaver_tpu_torch/ops/csrc/sinkhorn.cu"
    table = [
        dict(name="fused_assign", route="cuda", source=src,
             replaces="traceweaver_tpu/ops/pallas_sinkhorn.py:308",
             launches=launches["fused_assign"], max_abs_err=worst["k1_err"],
             library_ms=None, **timing["fused_assign"]),
        dict(name="sinkhorn", route="cuda", source=src,
             replaces="traceweaver_tpu/ops/pallas_sinkhorn.py:140",
             launches=launches["sinkhorn"], max_abs_err=worst["plan_err"],
             library_ms=None, **timing["sinkhorn"]),
    ]
    print(json.dumps({"kernels": table}), flush=True)
    torch.cuda.synchronize()
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
