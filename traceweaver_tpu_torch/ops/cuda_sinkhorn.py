"""Hopper kernels for the Sinkhorn solve and their plain versions (mirrors
``traceweaver_tpu/ops/pallas_sinkhorn.py``).

Two TPU kernels become two CUDA kernels in ``csrc/sinkhorn.cu``, each a
template on the score type (f32, or bf16 for the bf16 score path):

- :func:`fused_assign_cuda` (K1, replaces ``fused_assign_pallas``):
  Sinkhorn, greedy rounding and the top-k peel in one kernel;
- :func:`sinkhorn_cuda` (K2, replaces ``sinkhorn_log_pallas``): the same
  Sinkhorn loop, returning the plan.

:func:`round_topk_cuda` launches K1's rounding and peel code on a given
plan; it exists so that stage can be checked bit for bit against the
plain rounding on the card.

Each window block runs on one thread-block cluster of 8 or 16 CTAs
(:func:`launch_plan`): every CTA owns a stripe of rows, and the column
reductions and the rounding's column argmaxes are merged through
distributed shared memory. The exponentials of the Sinkhorn loop bound
both kernels; spreading a window over a cluster puts 64 to 128 SMs to
work at 8 windows instead of 8. The three kernels use one plan for one
(B, R, C), so K1 equals K2's plan rounded by ``round_topk`` bit for bit.
The cluster size follows B, so a mesh shard, which launches part of a
batch, passes ``plan_b``, the unsharded batch's count: its windows then
sum in the order they sum on one device.

Plain versions live beside them: :func:`assign_topk_plain` (the
``sinkhorn -> greedy_round -> topk_peel`` composition, ``assign_topk_jnp``
in the JAX package), :func:`round_topk_plain` and
:func:`traceweaver_tpu_torch.ops.sinkhorn.sinkhorn_log`.

The dispatchers :func:`assign_topk` and :func:`sinkhorn` take the plain
version only for tensors on the CPU. For CUDA tensors they launch the
kernel or raise: there is no fallback, and a cluster that the card cannot
schedule raises. Each kernel wrapper counts its launches in
:data:`LAUNCHES`.

Under bf16 the kernels and their plain versions follow the Pallas
kernels (``pallas_sinkhorn.py:88-94``, ``:237-241``): the block stays
bf16 and each use upcasts it to f32 and scales it by ``1/epsilon``; the
potentials, plan and rounding state are f32. (The XLA ``sinkhorn_log``
of the JAX package stores ``bf16(f32(S) / epsilon)`` instead; at the
solver's ``epsilon = 1`` the two are the same numbers.)

The kernels are built by ``nvcc`` for ``sm_90a`` from the sources in
``csrc/`` at first use, into ``traceweaver_tpu_torch/_build/``
(:mod:`~traceweaver_tpu_torch.ops.cuda_build`), and bound through a
plain C interface with ``ctypes``.

Every launch first sets the kernel's dynamic shared-memory limit to the
size this block shape needs (``cudaFuncSetAttribute``), an attribute of
the function, not of the launch. The fleet's flow workers launch from
several threads at once, so each C entry point (attribute, then launch
or occupancy query) runs under :data:`_launch_lock`: otherwise a thread
could launch with the smaller limit another thread set in between, and
the launch fails with CUDA error 1 (invalid value). The attribute is set
inside ``torch.cuda.device`` of the launch's tensors, so on a mesh over
several cards each launch sets it on the card it runs on.
"""

from __future__ import annotations

import ctypes
import functools
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from traceweaver_tpu_torch.ops import cuda_build
from traceweaver_tpu_torch.ops.rounding import (
    MAX_PEEL_K,
    NEG,
    greedy_round,
    topk_peel,
)
from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

#: kernel launch counters, one per wrapper (incremented only at a launch,
#: under ``_lock``)
LAUNCHES: Dict[str, int] = {"fused_assign": 0, "sinkhorn": 0, "round_topk": 0}

#: dynamic shared memory one CTA may use: Hopper's 232448 bytes less
#: room for the kernels' static shared memory (under 3 KB)
MAX_SMEM_BYTES = 232448 - 4096
#: cluster sizes: 16 CTAs (a non-portable size) where the card runs all
#: of a launch's clusters at once, else 8 (the portable maximum)
CLUSTER_LARGE, CLUSTER_SMALL = 16, 8
#: threads of one CTA (TW_THREADS in ``csrc/sinkhorn.cu``)
THREADS_PER_CTA = 512
#: score types the kernels read, and their bytes
SCORE_DTYPES = {torch.float32: 4, torch.bfloat16: 2}

_lock = threading.Lock()
#: held around each C entry point, which sets a per-function attribute
#: and then launches (or queries occupancy) with it
_launch_lock = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_ACTIVE_CLUSTERS: Dict[Tuple[int, int, int, int, int], int] = {}


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count_launch(name: str) -> None:
    """One launch of ``name``, under the lock: the fleet's per-service
    fallback launches from several threads."""
    with _lock:
        LAUNCHES[name] += 1


def build(verbose: bool = False) -> str:
    """Compile ``csrc/sinkhorn.cu`` (once per source content) and return
    the shared library's path. ``verbose`` adds ``-Xptxas -v`` and
    returns nvcc's report instead of the path."""
    return cuda_build.build("sinkhorn.cu", "tw_sinkhorn", verbose)


def _lib() -> ctypes.CDLL:
    global _LIB
    with _lock:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.tw_max_active_clusters.argtypes = [i, i, i, i, i, p]
            lib.tw_max_active_clusters.restype = i
            lib.tw_fused_assign.argtypes = [p, p, p, p, i, i, i, i, i, f, f, i,
                                            f, p, p, p, i, i, i, p]
            lib.tw_fused_assign.restype = i
            lib.tw_sinkhorn.argtypes = [p, p, p, i, i, i, i, f, f, p, p, i, i, i, p]
            lib.tw_sinkhorn.restype = i
            lib.tw_round_topk.argtypes = [p, p, p, p, i, i, i, i, f, p, p, i, i,
                                          p]
            lib.tw_round_topk.restype = i
            _LIB = lib
    return _LIB


#: rows per tile of the Sinkhorn loop's shared-memory ring, largest first
TILE_ROWS = (8, 4, 2, 1)


def smem_bytes(rows: int, cols: int, cluster: int, tile_rows: int,
               itemsize: int = 4) -> int:
    """Dynamic shared memory of one CTA of a ``cluster``-CTA cluster for
    an [rows, cols] block of ``itemsize``-byte scores (the layout of
    ``csrc/sinkhorn.cu``: a ring of two ``tile_rows``-row tiles of the
    stored type, a full psi, the column partials and flags, the log
    column marginals of the CTA's merge slice, the stripe's potentials
    and rounding state, every row's skip mass; never the whole block)."""
    stripe, cslice = -(-rows // cluster), -(-cols // cluster)
    per16 = 16 // itemsize
    slot = -(-tile_rows * cols // per16) * per16 + per16
    return (2 * itemsize * slot + 15 * cols + 4 * cslice + 4 * rows
            + 18 * stripe)


@dataclass(frozen=True)
class LaunchPlan:
    """How one launch spreads B blocks of [rows, cols] over the card: a
    cluster of ``cluster`` CTAs per block, CTA r owning rows
    [r * rows_per_cta, (r + 1) * rows_per_cta) (clipped to ``rows``;
    trailing CTAs may own none) and streaming them through shared memory
    ``tile_rows`` rows at a time."""

    cluster: int
    rows_per_cta: int
    tile_rows: int
    smem_bytes: int

    def stripes(self, rows: int):
        """The row range each CTA of a cluster owns."""
        return [(min(r * self.rows_per_cta, rows),
                 min((r + 1) * self.rows_per_cta, rows))
                for r in range(self.cluster)]


def launch_plan(B: int, rows: int, cols: int, large_clusters: int,
                itemsize: int = 4) -> LaunchPlan:
    """The plan for B blocks of [rows, cols] of ``itemsize``-byte
    scores, given how many ``CLUSTER_LARGE`` clusters the card runs at
    once: the large size when all B fit together, else
    ``CLUSTER_SMALL``; the largest tile that fits in shared memory. K1,
    K2 and ``round_topk`` take the same plan for the same (B, rows,
    cols, itemsize)."""
    cluster = CLUSTER_LARGE if large_clusters >= B else CLUSTER_SMALL
    _check_block(rows, cols, cluster, itemsize)
    tile = next(t for t in TILE_ROWS
                if smem_bytes(rows, cols, cluster, t, itemsize) <= MAX_SMEM_BYTES)
    return LaunchPlan(cluster, -(-rows // cluster), tile,
                      smem_bytes(rows, cols, cluster, tile, itemsize))


def _check_block(rows: int, cols: int, cluster: int = CLUSTER_SMALL,
                 itemsize: int = 4) -> None:
    need = smem_bytes(rows, cols, cluster, TILE_ROWS[-1], itemsize)
    if need > MAX_SMEM_BYTES:
        raise ValueError(
            f"block [{rows}, {cols}] needs {need} bytes of shared memory per CTA "
            f"at a cluster of {cluster}; the kernel's limit is {MAX_SMEM_BYTES} "
            "bytes per CTA")


def _active_clusters(cluster: int, rows: int, cols: int, dev: torch.device,
                     itemsize: int = 4) -> int:
    """How many ``cluster``-CTA clusters of the kernels the card runs at
    once at the plan's shared memory (cached per card, shape and score
    type)."""
    key = (dev.index if dev.index is not None else torch.cuda.current_device(),
           cluster, rows, cols, itemsize)
    if key not in _ACTIVE_CLUSTERS:
        try:
            plan = launch_plan(1, rows, cols, 1 if cluster == CLUSTER_LARGE else 0,
                               itemsize)
        except ValueError:
            _ACTIVE_CLUSTERS[key] = 0
            return 0
        n, lib = ctypes.c_int(0), _lib()
        with torch.cuda.device(dev), _launch_lock:
            err = lib.tw_max_active_clusters(cluster, rows, cols, plan.tile_rows,
                                             itemsize, ctypes.addressof(n))
        _raise_on(err, f"occupancy query for a cluster of {cluster}")
        _ACTIVE_CLUSTERS[key] = n.value
    return _ACTIVE_CLUSTERS[key]


def card_plan(B: int, rows: int, cols: int, dev: torch.device,
              itemsize: int = 4) -> LaunchPlan:
    """:func:`launch_plan` on this card; raises when the card cannot run
    even one cluster of the chosen size."""
    plan = launch_plan(B, rows, cols,
                       _active_clusters(CLUSTER_LARGE, rows, cols, dev, itemsize),
                       itemsize)
    if _active_clusters(plan.cluster, rows, cols, dev, itemsize) < 1:
        raise RuntimeError(
            f"a cluster of {plan.cluster} CTAs of {THREADS_PER_CTA} threads with "
            f"{plan.smem_bytes} bytes of shared memory each cannot be scheduled "
            "on this card")
    return plan


def _check(name: str, t: torch.Tensor, dtype, shape) -> None:
    """``dtype``: one type, or a tuple of the types the kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
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
                      min_topk_mass: float, return_stats: bool = False,
                      plan_b: Optional[int] = None):
    """K1: Sinkhorn -> greedy rounding -> top-k peel per block, one
    cluster of :func:`card_plan` CTAs per block, planned for ``plan_b``
    blocks when given (a mesh shard's launch takes the plan of the
    unsharded batch, the tile and shared memory not depending on B).

    The Sinkhorn loop's exponentials bound it (one per element and
    half-iteration), and its block streams from L2/HBM twice per
    iteration; the cluster spreads both over 8 or 16 SMs per block.

    scores [B, R, C] f32 or bf16 (dummy row and skip column included,
    column C - 1 is the skip column), row_marg [B, R], col_marg [B, C],
    skip_cap [B] f32. Returns assign [B, n_rows] int32 (C - 1 = skip, -1 = none)
    and topk [B, n_rows, topk] int32 (-1 at plan mass <= min_topk_mass);
    with ``return_stats`` also [B, 2] int32 (Sinkhorn iterations run,
    rounding rounds)."""
    B, R, C = scores.shape
    _check("scores", scores, tuple(SCORE_DTYPES), (B, R, C))
    _check("row_marg", row_marg, torch.float32, (B, R))
    _check("col_marg", col_marg, torch.float32, (B, C))
    _check("skip_cap", skip_cap, torch.float32, (B,))
    if not 0 <= n_rows <= R or not 1 <= topk <= min(MAX_PEEL_K, C):
        raise ValueError(f"n_rows={n_rows} (R={R}) or topk={topk} (C={C}) out of range")
    item = SCORE_DTYPES[scores.dtype]
    _check_block(R, C, itemsize=item)
    dev = scores.device
    assign = torch.empty((B, n_rows), dtype=torch.int32, device=dev)
    tk = torch.empty((B, n_rows, topk), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    if B == 0:
        return (assign, tk, stats) if return_stats else (assign, tk)
    lib, plan = _lib(), card_plan(plan_b or B, R, C, dev, item)
    with torch.cuda.device(dev), _launch_lock:
        err = lib.tw_fused_assign(
            scores.data_ptr(), row_marg.data_ptr(), col_marg.data_ptr(),
            skip_cap.data_ptr(), B, R, C, n_rows, n_iters, 1.0 / epsilon,
            tol / epsilon, topk, min_topk_mass, assign.data_ptr(),
            tk.data_ptr(), stats.data_ptr(), plan.cluster, plan.tile_rows,
            item, _stream(scores))
    _raise_on(err, "fused_assign launch")
    _count_launch("fused_assign")
    return (assign, tk, stats) if return_stats else (assign, tk)


def sinkhorn_cuda(scores, row_marg, col_marg, *, epsilon: float, n_iters: int,
                  tol: float = 0.0, return_iters: bool = False,
                  plan_b: Optional[int] = None):
    """K2: the Sinkhorn plan [B, N, M] f32 of scores [B, N, M] (f32 or
    bf16) under marginals [B, N] / [B, M]; ``return_iters`` adds the
    iterations run per block ([B] int32). The same cluster design, bound
    and ``plan_b`` as K1, plus one write of the plan."""
    B, N, M = scores.shape
    _check("scores", scores, tuple(SCORE_DTYPES), (B, N, M))
    _check("row_marg", row_marg, torch.float32, (B, N))
    _check("col_marg", col_marg, torch.float32, (B, M))
    item = SCORE_DTYPES[scores.dtype]
    _check_block(N, M, itemsize=item)
    dev = scores.device
    plan = torch.empty((B, N, M), dtype=torch.float32, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    if B == 0:
        return (plan, iters) if return_iters else plan
    lib, lp = _lib(), card_plan(plan_b or B, N, M, dev, item)
    with torch.cuda.device(dev), _launch_lock:
        err = lib.tw_sinkhorn(
            scores.data_ptr(), row_marg.data_ptr(), col_marg.data_ptr(), B, N,
            M, n_iters, 1.0 / epsilon, tol / epsilon, plan.data_ptr(),
            iters.data_ptr(), lp.cluster, lp.tile_rows, item, _stream(scores))
    _raise_on(err, "sinkhorn launch")
    _count_launch("sinkhorn")
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
    lib, lp = _lib(), card_plan(B, N, C, dev)
    with torch.cuda.device(dev), _launch_lock:
        err = lib.tw_round_topk(
            plan.data_ptr(), row_valid.data_ptr(), col_valid.data_ptr(),
            skip_cap.data_ptr(), B, N, C, topk, min_topk_mass,
            assign.data_ptr(), tk.data_ptr(), lp.cluster, lp.tile_rows,
            _stream(plan))
    _raise_on(err, "round_topk launch")
    _count_launch("round_topk")
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
                topk: int, min_topk_mass: float, fused: bool = True,
                plan_b: Optional[int] = None):
    """Hard assignment + top-k of blocks [B, R, C].

    On the CPU: the plain composition. On the card: K1 when ``fused``,
    else K2's plan rounded by the plain rounding (the JAX package's
    ``TW_PALLAS_FUSED=0`` path), either planned for ``plan_b`` blocks
    when given (see :func:`fused_assign_cuda`)."""
    if S_ot.device.type == "cpu":
        return assign_topk_plain(
            S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows,
            epsilon=epsilon, n_iters=n_iters, tol=tol, topk=topk,
            min_topk_mass=min_topk_mass)
    if fused:
        return fused_assign_cuda(
            S_ot, row_marg, col_marg, skip_cap, n_rows, epsilon=epsilon,
            n_iters=n_iters, tol=tol, topk=topk, min_topk_mass=min_topk_mass,
            plan_b=plan_b)
    return assign_topk_plain(
        S_ot, row_marg, col_marg, in_valid, col_valid, skip_cap, n_rows,
        epsilon=epsilon, n_iters=n_iters, tol=tol, topk=topk,
        min_topk_mass=min_topk_mass,
        plan_fn=functools.partial(sinkhorn_cuda, plan_b=plan_b))
