"""Hopper kernels for the Sinkhorn solve and their plain versions (mirrors
``traceweaver_tpu/ops/pallas_sinkhorn.py``).

Two TPU kernels become two CUDA kernels in ``csrc/sinkhorn.cu``:

- :func:`fused_assign_cuda` (K1, replaces ``fused_assign_pallas``):
  Sinkhorn, greedy rounding and the top-k peel in one kernel, one CTA
  per window block;
- :func:`sinkhorn_cuda` (K2, replaces ``sinkhorn_log_pallas``): the same
  Sinkhorn loop, returning the plan.

:func:`round_topk_cuda` launches K1's rounding and peel code on a given
plan; it exists so that stage can be checked bit for bit against the
plain rounding on the card.

Plain versions live beside them: :func:`assign_topk_plain` (the
``sinkhorn -> greedy_round -> topk_peel`` composition, ``assign_topk_jnp``
in the JAX package), :func:`round_topk_plain` and
:func:`traceweaver_tpu_torch.ops.sinkhorn.sinkhorn_log`.

The dispatchers :func:`assign_topk` and :func:`sinkhorn` take the plain
version only for tensors on the CPU. For CUDA tensors they launch the
kernel or raise: there is no fallback. Each kernel wrapper counts its
launches in :data:`LAUNCHES`.

The kernels are built by ``nvcc`` for ``sm_90a`` from the sources in
``csrc/`` at first use, into ``traceweaver_tpu_torch/_build/``, and
bound through a plain C interface with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional

import torch

from traceweaver_tpu_torch.ops.rounding import (
    MAX_PEEL_K,
    NEG,
    greedy_round,
    topk_peel,
)
from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

#: kernel launch counters, one per wrapper (incremented only at a launch)
LAUNCHES: Dict[str, int] = {"fused_assign": 0, "sinkhorn": 0, "round_topk": 0}

#: dynamic shared memory one CTA may use on Hopper
MAX_SMEM_BYTES = 232448

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SOURCE = os.path.join(_PKG_DIR, "ops", "csrc", "sinkhorn.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on the card's "
                           "machine (CUDA toolkit under /usr/local/cuda)")
    return path


def build(verbose: bool = False) -> str:
    """Compile ``csrc/sinkhorn.cu`` (once per source content) and return
    the shared library's path. ``verbose`` adds ``-Xptxas -v`` and
    returns nvcc's report instead of the path."""
    with open(_SOURCE, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, f"libtw_sinkhorn_{digest}.so")
    if os.path.exists(lib) and not verbose:
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return proc.stderr if verbose else lib


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.tw_fused_assign.argtypes = [p, p, p, p, i, i, i, i, i, f, f, i,
                                            f, p, p, p, p]
            lib.tw_fused_assign.restype = i
            lib.tw_sinkhorn.argtypes = [p, p, p, i, i, i, i, f, f, p, p, p]
            lib.tw_sinkhorn.restype = i
            lib.tw_round_topk.argtypes = [p, p, p, p, i, i, i, i, f, p, p, p]
            lib.tw_round_topk.restype = i
            _LIB = lib
    return _LIB


def smem_bytes(rows: int, cols: int) -> int:
    """Dynamic shared memory of one CTA for an [rows, cols] block (the
    layout of ``csrc/sinkhorn.cu``: potentials, marginals and rounding
    state, never the block itself)."""
    return 4 * (5 * rows + 3 * cols) + 2 * rows + 3 * cols


def _check_block(rows: int, cols: int) -> None:
    need = smem_bytes(rows, cols)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"block [{rows}, {cols}] needs {need} bytes of shared memory; the "
            f"kernel's limit is {MAX_SMEM_BYTES} bytes per CTA")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def fused_assign_cuda(scores, row_marg, col_marg, skip_cap, n_rows: int, *,
                      epsilon: float, n_iters: int, tol: float, topk: int,
                      min_topk_mass: float, return_stats: bool = False):
    """K1: Sinkhorn -> greedy rounding -> top-k peel per block.

    scores [B, R, C] f32 (dummy row and skip column included, column
    C - 1 is the skip column), row_marg [B, R], col_marg [B, C], skip_cap
    [B] f32. Returns assign [B, n_rows] int32 (C - 1 = skip, -1 = none)
    and topk [B, n_rows, topk] int32 (-1 at plan mass <= min_topk_mass);
    with ``return_stats`` also [B, 2] int32 (Sinkhorn iterations run,
    rounding rounds)."""
    B, R, C = scores.shape
    _check("scores", scores, torch.float32, (B, R, C))
    _check("row_marg", row_marg, torch.float32, (B, R))
    _check("col_marg", col_marg, torch.float32, (B, C))
    _check("skip_cap", skip_cap, torch.float32, (B,))
    if not 0 <= n_rows <= R or not 1 <= topk <= min(MAX_PEEL_K, C):
        raise ValueError(f"n_rows={n_rows} (R={R}) or topk={topk} (C={C}) out of range")
    _check_block(R, C)
    dev = scores.device
    assign = torch.empty((B, n_rows), dtype=torch.int32, device=dev)
    tk = torch.empty((B, n_rows, topk), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B == 0:
        return (assign, tk, stats) if return_stats else (assign, tk)
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tw_fused_assign(
            scores.data_ptr(), row_marg.data_ptr(), col_marg.data_ptr(),
            skip_cap.data_ptr(), B, R, C, n_rows, n_iters, 1.0 / epsilon,
            tol / epsilon, topk, min_topk_mass, assign.data_ptr(),
            tk.data_ptr(), stats.data_ptr(), _stream(scores))
    _raise_on(err, "fused_assign launch")
    LAUNCHES["fused_assign"] += 1
    return (assign, tk, stats) if return_stats else (assign, tk)


def sinkhorn_cuda(scores, row_marg, col_marg, *, epsilon: float, n_iters: int,
                  tol: float = 0.0, return_iters: bool = False):
    """K2: the Sinkhorn plan [B, N, M] f32 of scores [B, N, M] under
    marginals [B, N] / [B, M]; ``return_iters`` adds the iterations run
    per block ([B] int32)."""
    B, N, M = scores.shape
    _check("scores", scores, torch.float32, (B, N, M))
    _check("row_marg", row_marg, torch.float32, (B, N))
    _check("col_marg", col_marg, torch.float32, (B, M))
    _check_block(N, M)
    dev = scores.device
    plan = torch.empty((B, N, M), dtype=torch.float32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return (plan, iters) if return_iters else plan
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tw_sinkhorn(
            scores.data_ptr(), row_marg.data_ptr(), col_marg.data_ptr(), B, N,
            M, n_iters, 1.0 / epsilon, tol / epsilon, plan.data_ptr(),
            iters.data_ptr(), _stream(scores))
    _raise_on(err, "sinkhorn launch")
    LAUNCHES["sinkhorn"] += 1
    return (plan, iters) if return_iters else plan


def round_topk_cuda(plan, row_valid, col_valid, skip_cap, *, topk: int,
                    min_topk_mass: float):
    """K1's rounding and peel on a given plan [B, N, C] f32 (last column
    = skip) with validity masks [B, N] / [B, C] bool and skip capacity
    [B] f32. Same outputs as :func:`round_topk_plain`."""
    B, N, C = plan.shape
    _check("plan", plan, torch.float32, (B, N, C))
    _check("row_valid", row_valid, torch.bool, (B, N))
    _check("col_valid", col_valid, torch.bool, (B, C))
    _check("skip_cap", skip_cap, torch.float32, (B,))
    if not 1 <= topk <= min(MAX_PEEL_K, C):
        raise ValueError(f"topk={topk} out of range for C={C}")
    _check_block(N, C)
    dev = plan.device
    assign = torch.empty((B, N), dtype=torch.int32, device=dev)
    tk = torch.empty((B, N, topk), dtype=torch.int32, device=dev)
    if B == 0:
        return assign, tk
    lib = _lib()
    with torch.cuda.device(dev):
        err = lib.tw_round_topk(
            plan.data_ptr(), row_valid.data_ptr(), col_valid.data_ptr(),
            skip_cap.data_ptr(), B, N, C, topk, min_topk_mass,
            assign.data_ptr(), tk.data_ptr(), _stream(plan))
    _raise_on(err, "round_topk launch")
    LAUNCHES["round_topk"] += 1
    return assign, tk


# ---------------------------------------------------------------------------
# plain versions and dispatch
# ---------------------------------------------------------------------------

def round_topk_plain(plan, row_valid, col_valid, skip_cap, *, topk: int,
                     min_topk_mass: float):
    """Greedy rounding and the mass-filtered top-k peel of a plan
    [B, N, C]: the plain version of :func:`round_topk_cuda`."""
    n = plan.shape[1]
    plan = plan.to(torch.float32)
    assign = greedy_round(plan, row_valid, col_valid,
                          skip_cap.to(torch.int32), n_steps=n)
    neg = torch.tensor(NEG, dtype=plan.dtype, device=plan.device)
    tk_mass, tk = topk_peel(torch.where(col_valid[:, None, :], plan, neg), topk)
    tk = torch.where(tk_mass > min_topk_mass, tk, torch.full_like(tk, -1))
    return assign, tk


def assign_topk_plain(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap,
                      n_rows: int, *, epsilon: float, n_iters: int, tol: float,
                      topk: int, min_topk_mass: float, plan_fn=None):
    """The ``sinkhorn -> greedy_round -> topk_peel`` composition over
    blocks [B, R, C]; ``plan_fn`` computes the plan (default: the plain
    :func:`sinkhorn_log`)."""
    plan_fn = plan_fn or sinkhorn_log
    plan = plan_fn(S_ot, row_marg, col_marg, epsilon=epsilon, n_iters=n_iters,
                   tol=tol)
    plan = plan.to(torch.float32)[:, :n_rows, :].contiguous()
    return round_topk_plain(plan, in_valid, col_valid, skip_cap, topk=topk,
                            min_topk_mass=min_topk_mass)


def sinkhorn(scores, row_marg, col_marg, *, epsilon: float = 1.0,
             n_iters: int = 50, tol: float = 0.0):
    """Sinkhorn plan: K2 for CUDA tensors, the plain version on the CPU."""
    if scores.device.type == "cpu":
        return sinkhorn_log(scores, row_marg, col_marg, epsilon=epsilon,
                            n_iters=n_iters, tol=tol)
    return sinkhorn_cuda(scores, row_marg, col_marg, epsilon=epsilon,
                         n_iters=n_iters, tol=tol)


def assign_topk(S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap,
                n_rows: int, *, epsilon: float, n_iters: int, tol: float,
                topk: int, min_topk_mass: float, fused: bool = True):
    """Hard assignment + top-k of blocks [B, R, C].

    On the CPU: the plain composition. On the card: K1 when ``fused``,
    else K2's plan rounded by the plain rounding (the JAX package's
    ``TW_PALLAS_FUSED=0`` path)."""
    if S_ot.device.type == "cpu":
        return assign_topk_plain(
            S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows,
            epsilon=epsilon, n_iters=n_iters, tol=tol, topk=topk,
            min_topk_mass=min_topk_mass)
    if fused:
        return fused_assign_cuda(
            S_ot, row_marg, col_marg, skip_cap, n_rows, epsilon=epsilon,
            n_iters=n_iters, tol=tol, topk=topk, min_topk_mass=min_topk_mass)
    return assign_topk_plain(
        S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows,
        epsilon=epsilon, n_iters=n_iters, tol=tol, topk=topk,
        min_topk_mass=min_topk_mass, plan_fn=sinkhorn_cuda)
