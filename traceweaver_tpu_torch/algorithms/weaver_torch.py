"""The windowed Sinkhorn assignment solver in PyTorch (mirrors
``traceweaver_tpu/algorithms/weaver_tpu.py``, per-service path).

1. **Perfect-cut windowing** (host): incoming spans are cut wherever the
   running max of end times clears the next start, capped at
   ``max_window`` and padded to powers of two.
2. **Masked score blocks** (device): per window and per outgoing
   endpoint in DAG order, ``S[i, j] = log p(delay)`` under the learnt
   per-edge mixtures, masked by timing and DAG feasibility, plus a skip
   column and a dummy row.
3. **Entropic OT + rounding**: each block goes through
   :func:`traceweaver_tpu_torch.ops.cuda_sinkhorn.assign_topk` — on the
   card the fused CUDA kernel (or the plain Sinkhorn kernel followed by
   the plain rounding), on the CPU the plain composition.
4. **Gauss-Seidel sweeps**: sweep 0 conditions each endpoint on its
   predecessors; later sweeps on both neighbours, until the assignments
   reach a fixed point or ``n_sweeps`` runs out.
5. **Two-pass EM**: between the passes the per-edge delay GMMs are refit
   on the device (:func:`solve_em_packed`) when one dispatch covers the
   whole solve, else on the host.

The JAX ``vmap`` over windows is a leading batch axis; the sweep
``while_loop`` is a Python loop with one host sync per sweep and a
per-window done mask that freezes converged windows; the ``scan`` over
endpoints is a Python loop.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from traceweaver_tpu_torch.algorithms import packed_layout as _layout
from traceweaver_tpu_torch.algorithms import timing
from traceweaver_tpu_torch.algorithms.skips import water_fill_skip_caps
from traceweaver_tpu_torch.algorithms.timing import MAX_COMPONENTS, EdgeDist
from traceweaver_tpu_torch.dag import DAG
from traceweaver_tpu_torch.metrics.accuracy import get_out_eps_in_order
from traceweaver_tpu_torch.obs import profile as _obs_profile
from traceweaver_tpu_torch.obs import quality as _quality
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry
from traceweaver_tpu_torch.ops.cuda_sinkhorn import assign_topk
from traceweaver_tpu_torch.ops.gmm import fit_gmm_in_graph
from traceweaver_tpu_torch.ops.precision import score_itemsize, validate_precision
from traceweaver_tpu_torch.ops.scores import MixtureTerm, assemble_block
from traceweaver_tpu_torch.runtime.bucketing import pow2_bucket
from traceweaver_tpu_torch.spans import NA, SKIP, Span, SpanArray

NEG = -1.0e9
MIN_TOPK_MASS = 1e-3  # top-K fallback candidates need at least this plan mass
DEFAULT_MAX_WINDOW = 1024
DEFAULT_TOPK = 5
# per-dispatch element budget (f32 elements of [B, W, M] blocks live at once)
CHUNK_ELEMS = 1 << 26
# merge a smaller window size class into the next while the extra padded
# area stays under this many elements
MERGE_ELEMS = 1 << 24

#: argument order of the packed entry points (window tensors, then the
#: problem tables)
ARG_ORDER = (
    "in_start", "in_end", "in_valid", "out_start", "out_end", "out_valid",
    "skip_cap", "force_skip", "pred_mask", "root_mask", "is_last",
    "edge_wt", "edge_mu", "edge_sd", "in_wt", "in_mu", "in_sd",
    "ret_wt", "ret_mu", "ret_sd",
)


# ---------------------------------------------------------------------------
# Device solve (batched over windows)
# ---------------------------------------------------------------------------

def _neighbour_index(mask: torch.Tensor, n: int):
    """[B, E, n] indices of the mask-true entries first (stable, so in
    ascending endpoint order) and whether each is a real neighbour."""
    idx = torch.argsort((~mask).to(torch.int32), dim=2, stable=True)[:, :, :n]
    return idx, torch.gather(mask, 2, idx)


def _solve_windows_impl(
    in_start, in_end, in_valid,      # [B, W]
    out_start, out_end, out_valid,   # [B, E, M]
    skip_cap,                        # [B, E] f32
    force_skip,                      # [B, E, W] bool
    param_idx,                       # [B] int64 row into the [P, ...] tables
    pred_masks, root_masks, is_lasts,  # [P, E, E] / [P, E] / [P, E] bool
    edge_wts, edge_mus, edge_sds,    # [P, E, E, K]
    in_wts, in_mus, in_sds,          # [P, E, K]
    ret_wts, ret_mus, ret_sds,       # [P, E, K]
    *,
    epsilon: float,
    n_sinkhorn: int,
    topk: int,
    n_sweeps: int,
    sinkhorn_tol: float,
    max_preds: int = 0,
    max_succs: int = 0,
    precision: str = "f32",
    fused: bool = True,
    confidence: bool = False,
    score_gemm: bool = False,
    plan_b: Optional[int] = None,
):
    """Shared body of :func:`solve_windows` and the packed entry points.

    Returns ``(assign [B, E, W] int32, topk [B, E, W, topk] int32,
    not_best [B, E, W] bool, feas_count [B, E, W] int32, converged [B]
    bool)``. ``max_preds``/``max_succs`` (0 = no bound) cap the DAG
    neighbours each score block sums over; ``fused`` picks the fused
    kernel on the card, whose launch is planned for ``plan_b`` blocks
    when given (a mesh shard passes the unsharded batch's count, so a
    window's sums run in the order they run on one device).
    ``confidence`` adds, before ``converged``, the
    two quantized quality channels of
    :mod:`~traceweaver_tpu_torch.algorithms.packed_layout` ([B, E, W]
    int32 each): the top1-top2 margin of each row of the assembled block
    and the entropy of its ``softmax(S / epsilon)`` over feasible
    columns, both x ``CONF_SCALE``. They are plain tensor operations on
    the block, outside the kernels.

    The OT block of an endpoint, with its feasible counts and row
    argmax, comes from
    :func:`~traceweaver_tpu_torch.ops.scores.assemble_block` (on the
    card one launch of the assembly kernel; ``score_gemm`` the GEMM
    form, the JAX package's ``TW_SCORE_GEMM``, at every term as under
    its per-window ``vmap``). The scores sum in f32; under
    ``precision="bf16"`` each row of the assembled block is centred at
    its best feasible score and the block is stored in bf16 (JAX
    ``weaver_tpu.py:278-296``); the kernels, ``not_best``'s argmax and
    the confidence margins read that block, and the marginals and
    everything that accumulates stay f32.
    """
    precision = validate_precision(precision)
    B, E, M = out_start.shape
    W = in_start.shape[1]
    dev = in_start.device
    POS = -NEG
    n_pred = max_preds if 0 < max_preds < E else E
    n_succ = max_succs if 0 < max_succs < E else E
    bidx = torch.arange(B, device=dev)

    pred_mask = pred_masks[param_idx]                    # [B, E, E]
    root_mask, is_last = root_masks[param_idx], is_lasts[param_idx]
    edge_wt, edge_mu, edge_sd = (edge_wts[param_idx], edge_mus[param_idx],
                                 edge_sds[param_idx])    # [B, E, E, K]
    in_wt, in_mu, in_sd = in_wts[param_idx], in_mus[param_idx], in_sds[param_idx]
    ret_wt, ret_mu, ret_sd = (ret_wts[param_idx], ret_mus[param_idx],
                              ret_sds[param_idx])        # [B, E, K]
    pred_idx, pred_ok = _neighbour_index(pred_mask, n_pred)
    succ_idx, succ_ok = _neighbour_index(pred_mask.transpose(1, 2).contiguous(),
                                         n_succ)

    in_s, in_e, in_v = in_start, in_end, in_valid
    zero = torch.zeros((), dtype=in_s.dtype, device=dev)
    neg = torch.full((), NEG, dtype=in_s.dtype, device=dev)
    pos = torch.full((), POS, dtype=in_s.dtype, device=dev)

    def box(x):          # [B] -> [B, 1, 1]
        return x[:, None, None]

    def ep_step(e: int, chosen_end, chosen_start, backward: bool):
        pmask = pred_mask[:, e, :]                       # [B, E]
        smask = pred_mask[:, :, e]
        t_pred = torch.where(pmask[:, :, None], chosen_end, neg).amax(dim=1)
        t_prev = torch.where(pmask.any(dim=1)[:, None], t_pred, in_s)
        t_succ = (torch.where(smask[:, :, None], chosen_start, pos).amin(dim=1)
                  if backward else None)
        o_s, o_e, o_v = out_start[:, e], out_end[:, e], out_valid[:, e]

        # --- score block --------------------------------------------------
        root = MixtureTerm(in_s, o_s, in_wt[:, e], in_mu[:, e], in_sd[:, e],
                           root_mask[:, e])
        preds = []
        for j in range(n_pred):
            p = pred_idx[:, e, j]
            preds.append(MixtureTerm(chosen_end[bidx, p], o_s, edge_wt[bidx, e, p],
                                     edge_mu[bidx, e, p], edge_sd[bidx, e, p],
                                     pred_ok[:, e, j]))
        succs = []
        for j in range(n_succ):
            # edge (e -> u): delay succ_start_u - out_end_e
            u = succ_idx[:, e, j]
            cs = chosen_start[bidx, u]                   # [B, W]
            succs.append(MixtureTerm(cs, o_e, edge_wt[bidx, u, e], edge_mu[bidx, u, e],
                                     edge_sd[bidx, u, e], succ_ok[:, e, j] & backward,
                                     row_ok=cs < POS / 2, flip=True))
        ret = MixtureTerm(in_e, o_e, ret_wt[:, e], ret_mu[:, e], ret_sd[:, e],
                          is_last[:, e], flip=True)
        with _obs_profile.annotate("tw:solve:score"):
            S_ot, feas_count, row_argmax = assemble_block(
                root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v, t_prev,
                t_succ, force_skip[:, e], precision=precision, gemm=score_gemm)

        # --- marginals (dummy row absorbs surplus columns) ------------------
        f32 = in_s.dtype
        n_rows = in_v.sum(dim=1).to(f32)
        n_cols = o_v.sum(dim=1).to(f32)
        cap_e = torch.maximum(skip_cap[:, e], torch.clamp(n_rows - n_cols, min=0.0))
        row_marg = torch.cat(
            [in_v.to(f32), torch.clamp(n_cols + cap_e - n_rows, min=0.0)[:, None]],
            dim=1)
        col_marg = torch.cat([o_v.to(f32), cap_e[:, None]], dim=1)
        col_valid = torch.cat([o_v, (cap_e > 0)[:, None]], dim=1)
        assign, tk = assign_topk(
            S_ot, row_marg, col_marg, in_v, col_valid, cap_e, W,
            epsilon=epsilon, n_iters=n_sinkhorn, tol=sinkhorn_tol, topk=topk,
            min_topk_mass=MIN_TOPK_MASS, fused=fused, **plan_kw)

        # chosen completion: skip passes the predecessor time through
        real = (assign >= 0) & (assign < M)
        safe = torch.clamp(assign, 0, M - 1).to(torch.int64)
        chosen_end[:, e] = torch.where(real, torch.gather(o_e, 1, safe), t_prev)
        chosen_start[:, e] = torch.where(real, torch.gather(o_s, 1, safe), pos)
        not_best = (assign != row_argmax) & in_v
        if not confidence:
            return assign, tk, not_best, feas_count
        # the row conditional softmax(S / eps) is the Sinkhorn plan row
        # without the column potentials: its entropy is 0 for a one-hot row
        Sf = S_ot[:, :W].to(torch.float32)
        top2 = torch.topk(Sf, 2, dim=2).values
        margin = torch.clamp(top2[..., 0] - top2[..., 1], min=0.0)
        p = torch.softmax(torch.where(Sf > NEG / 2, Sf / epsilon, neg), dim=2)
        ent = -torch.where(p > 0.0, p * torch.log(p + 1e-30), zero).sum(dim=2)
        scale = _layout.CONF_SCALE
        margin_q = (torch.clamp(margin, max=2.0e6) * scale).to(torch.int32)
        ent_q = (torch.clamp(ent, min=0.0) * scale).to(torch.int32)
        return assign, tk, not_best, feas_count, margin_q, ent_q

    # unsharded solves plan for their own B: they pass no plan_b at all
    plan_kw = {} if plan_b is None else {"plan_b": plan_b}
    chosen_end = torch.zeros(B, E, W, dtype=in_s.dtype, device=dev)
    chosen_start = torch.full((B, E, W), POS, dtype=in_s.dtype, device=dev)
    outs = (torch.zeros(B, E, W, dtype=torch.int32, device=dev),
            torch.zeros(B, E, W, topk, dtype=torch.int32, device=dev),
            torch.zeros(B, E, W, dtype=torch.bool, device=dev),
            torch.zeros(B, E, W, dtype=torch.int32, device=dev))
    if confidence:
        outs = outs + tuple(torch.zeros(B, E, W, dtype=torch.int32, device=dev)
                            for _ in range(_layout.N_CONF))
    changed = torch.ones(B, dtype=torch.bool, device=dev)
    live = torch.ones(B, dtype=torch.bool, device=dev)  # sweep < n & changed
    for sweep in range(n_sweeps):
        if not bool(live.any()):
            break
        ce, cs = chosen_end.clone(), chosen_start.clone()
        new = [torch.empty_like(o) for o in outs]
        for e in range(E):
            for o, v in zip(new, ep_step(e, ce, cs, sweep > 0)):
                o[:, e] = v
        # a backward sweep that reproduces the previous assignments is a
        # Gauss-Seidel fixed point: later sweeps would change nothing
        ch = (new[0] != outs[0]).flatten(1).any(dim=1) | (sweep == 0)
        keep = live
        chosen_end = torch.where(box(keep), ce, chosen_end)
        chosen_start = torch.where(box(keep), cs, chosen_start)
        outs = tuple(torch.where(keep.view(B, *([1] * (o.dim() - 1))), n, o)
                     for n, o in zip(new, outs))
        changed = torch.where(keep, ch, changed)
        live = live & ch
    return outs + (~changed,)


def _single(tables):
    """Per-problem tables [E, ...] as the [1, E, ...] stacked form."""
    return [t[None] for t in tables]


def solve_windows(in_start, in_end, in_valid, out_start, out_end, out_valid,
                  skip_cap, force_skip, pred_mask, root_mask, is_last,
                  edge_wt, edge_mu, edge_sd, in_wt, in_mu, in_sd,
                  ret_wt, ret_mu, ret_sd, epsilon: float = 1.0,
                  n_sinkhorn: int = 40, topk: int = DEFAULT_TOPK,
                  n_sweeps: int = 5, sinkhorn_tol: float = 0.0,
                  max_preds: int = 0, max_succs: int = 0,
                  precision: str = "f32", fused: bool = True,
                  score_gemm: bool = False, plan_b: Optional[int] = None):
    """Solve every window of one problem by Gauss-Seidel sweeps
    (``plan_b``: see :func:`_solve_windows_impl`).

    Returns assign [B, E, W] int32 (M = skip, -1 = unassigned), topk
    [B, E, W, topk] int32, not_best [B, E, W] bool, feas_count
    [B, E, W] int32."""
    B = in_start.shape[0]
    outs = _solve_windows_impl(
        in_start, in_end, in_valid, out_start, out_end, out_valid,
        skip_cap, force_skip,
        torch.zeros(B, dtype=torch.int64, device=in_start.device),
        *_single((pred_mask, root_mask, is_last, edge_wt, edge_mu, edge_sd,
                  in_wt, in_mu, in_sd, ret_wt, ret_mu, ret_sd)),
        epsilon=epsilon, n_sinkhorn=n_sinkhorn, topk=topk, n_sweeps=n_sweeps,
        sinkhorn_tol=sinkhorn_tol, max_preds=max_preds, max_succs=max_succs,
        precision=precision, fused=fused, score_gemm=score_gemm, plan_b=plan_b)
    return outs[:4]


def _pack_solver_outputs(assign, tk, not_best, feas, *conf):
    """One int32 block ``[B, E, W, 3 + topk (+ 2)]`` in the channel order
    of :mod:`traceweaver_tpu_torch.algorithms.packed_layout`; ``conf``
    is the confidence variant's margin and entropy channels."""
    return torch.cat([assign[..., None], not_best[..., None].to(torch.int32),
                      feas[..., None], tk, *(c[..., None] for c in conf)], dim=-1)


def solve_windows_packed(*args, **kw):
    """:func:`solve_windows` with the outputs packed into one int32
    tensor ``[B, E, W, 3 + topk]``."""
    return _pack_solver_outputs(*solve_windows(*args, **kw))


def solve_windows_fleet(in_start, in_end, in_valid, out_start, out_end,
                        out_valid, skip_cap, force_skip, param_idx,
                        pred_masks, root_masks, is_lasts,
                        edge_wts, edge_mus, edge_sds, in_wts, in_mus, in_sds,
                        ret_wts, ret_mus, ret_sds, epsilon: float = 1.0,
                        n_sinkhorn: int = 40, topk: int = DEFAULT_TOPK,
                        n_sweeps: int = 5, sinkhorn_tol: float = 0.0,
                        max_preds: int = 0, max_succs: int = 0,
                        precision: str = "f32", fused: bool = True,
                        confidence: bool = False, score_gemm: bool = False,
                        plan_b: Optional[int] = None):
    """Multi-service solve: ``param_idx[b]`` picks window b's row of the
    stacked ``[P, ...]`` tables, so windows of every service of a fleet
    share one batch (endpoint axes padded to the fleet's widest; padded
    endpoints have no valid columns, assign nothing and pass predecessor
    times through).

    Returns ``(packed [B, E, W, 3 + topk] int32, converged [B] bool)``:
    the flags come apart from the block so the compacted flow can fetch
    B bytes alone. ``confidence`` appends the two quality channels."""
    outs = _solve_windows_impl(
        in_start, in_end, in_valid, out_start, out_end, out_valid,
        skip_cap, force_skip, param_idx.to(torch.int64),
        pred_masks, root_masks, is_lasts, edge_wts, edge_mus, edge_sds,
        in_wts, in_mus, in_sds, ret_wts, ret_mus, ret_sds,
        epsilon=epsilon, n_sinkhorn=n_sinkhorn, topk=topk, n_sweeps=n_sweeps,
        sinkhorn_tol=sinkhorn_tol, max_preds=max_preds, max_succs=max_succs,
        precision=precision, fused=fused, confidence=confidence,
        score_gemm=score_gemm, plan_b=plan_b)
    return _pack_solver_outputs(*outs[:-1]), outs[-1]


def em_family_samples(assign, in_start, in_end, in_valid,
                      out_start, out_end, pred_mask, root_mask):
    """Per-edge delay samples of the three refit families from hard
    assignments: (in -> e) for root endpoints, (p -> e) for DAG-primary
    edges, (e -> in) for every endpoint. Returns ``(samples, mask)``,
    both ``[E + E*E + E, B*W]``, rows in that family order."""
    B, E, W = assign.shape
    M = out_start.shape[2]
    safe = torch.clamp(assign, 0, M - 1).to(torch.int64)
    ch_start = torch.gather(out_start, 2, safe)                 # [B, E, W]
    ch_end = torch.gather(out_end, 2, safe)
    real = (assign >= 0) & (assign < M) & in_valid[:, None, :]
    rm = root_mask if root_mask.dim() == 2 else root_mask[None].expand(B, E)
    pm = pred_mask if pred_mask.dim() == 3 else pred_mask[None].expand(B, E, E)

    d_in = ch_start - in_start[:, None, :]
    m_in = real & rm[:, :, None]
    d_edge = ch_start[:, :, None, :] - ch_end[:, None, :, :]    # [B, E, Ep, W]
    m_edge = real[:, :, None, :] & real[:, None, :, :] & pm[:, :, :, None]
    d_ret = in_end[:, None, :] - ch_end
    m_ret = real

    def rows(d, m, ne):
        return (torch.movedim(d, 0, -2).reshape(ne, B * W),
                torch.movedim(m, 0, -2).reshape(ne, B * W))

    di, mi = rows(d_in, m_in, E)
    de, me = rows(d_edge.reshape(B, E * E, W), m_edge.reshape(B, E * E, W), E * E)
    dr, mr = rows(d_ret, m_ret, E)
    return torch.cat([di, de, dr], dim=0), torch.cat([mi, me, mr], dim=0)


def em_refit_tables(assign0, in_start, in_end, in_valid, out_start, out_end,
                    pred_mask, root_mask, is_last, edge_wt, edge_mu, edge_sd,
                    in_wt, in_mu, in_sd, ret_wt, ret_mu, ret_sd):
    """The refit between the two EM passes of one problem: the
    three-family delay samples of pass 0's assignments and the BIC-GMM
    refit (:func:`fit_gmm_in_graph`) with the current tables as priors.
    Returns the nine new tables in argument order (edge, in, return; w,
    mu, sd each)."""
    E = out_start.shape[1]
    K = in_wt.shape[1]
    samples, smask = em_family_samples(assign0, in_start, in_end, in_valid,
                                       out_start, out_end, pred_mask, root_mask)
    prior_w = torch.cat([in_wt, edge_wt.reshape(E * E, K), ret_wt])
    prior_mu = torch.cat([in_mu, edge_mu.reshape(E * E, K), ret_mu])
    prior_sd = torch.cat([in_sd, edge_sd.reshape(E * E, K), ret_sd])
    w, mu, sd = fit_gmm_in_graph(samples, smask, prior_w, prior_mu, prior_sd,
                                 max_k=K)
    edge = slice(E, E + E * E)
    ret = slice(E + E * E, None)
    return (w[edge].reshape(E, E, K), mu[edge].reshape(E, E, K),
            sd[edge].reshape(E, E, K), w[:E], mu[:E], sd[:E],
            w[ret], mu[ret], sd[ret])


def solve_em_packed(in_start, in_end, in_valid, out_start, out_end, out_valid,
                    skip_cap, force_skip, pred_mask, root_mask, is_last,
                    edge_wt, edge_mu, edge_sd, in_wt, in_mu, in_sd,
                    ret_wt, ret_mu, ret_sd, **kw):
    """Both EM passes on the device: pass 0, the refit of
    :func:`em_refit_tables`, pass 1. Returns pass 1's packed block."""
    windows = (in_start, in_end, in_valid, out_start, out_end, out_valid,
               skip_cap, force_skip)
    tables = (pred_mask, root_mask, is_last, edge_wt, edge_mu, edge_sd,
              in_wt, in_mu, in_sd, ret_wt, ret_mu, ret_sd)
    assign0 = solve_windows(*windows, *tables, **kw)[0]
    new = em_refit_tables(assign0, in_start, in_end, in_valid, out_start, out_end,
                          *tables)
    return solve_windows_packed(*windows, *tables[:3], *new, **kw)


def refit_fleet_params(assign0, in_start, in_end, in_valid, out_start, out_end,
                       param_idx, window_rows, window_valid, pred_masks,
                       root_masks, edge_wts, edge_mus, edge_sds,
                       in_wts, in_mus, in_sds, ret_wts, ret_mus, ret_sds):
    """Per-service three-family BIC-GMM refit from pass-0 assignments
    (JAX ``_fleet_refit_tables`` and its ``refit_fleet_params`` dispatch):
    the middle stage of :func:`solve_em_fleet` and the compacted fleet
    flow's refit between its passes.

    ``window_rows``/``window_valid`` ([P, Bmax]) list each service's
    window rows; the refit matrix ``[P*Ne, Bmax*W]`` gathers them, so a
    service's fit sees only its own windows. Returns the nine refit
    tables in ``[P, ...]`` layout (edge, in, return; w, mu, sd each)."""
    B, E, W = assign0.shape
    P, _, K = in_wts.shape
    Ne = E + E * E + E
    Bmax = window_rows.shape[1]
    pidx = param_idx.to(torch.int64)
    samples, smask = em_family_samples(assign0, in_start, in_end, in_valid,
                                       out_start, out_end, pred_masks[pidx],
                                       root_masks[pidx])        # [Ne, B*W]
    rows = window_rows.to(torch.int64)
    fs = samples.reshape(Ne, B, W)[:, rows, :]                  # [Ne, P, Bmax, W]
    fm = smask.reshape(Ne, B, W)[:, rows, :] & window_valid[None, :, :, None]
    fleet_samples = torch.movedim(fs, 1, 0).reshape(P * Ne, Bmax * W)
    fleet_mask = torch.movedim(fm, 1, 0).reshape(P * Ne, Bmax * W)

    def prior(t_in, t_edge, t_ret):
        return torch.cat([t_in, t_edge.reshape(P, E * E, K), t_ret],
                         dim=1).reshape(P * Ne, K)

    w, mu, sd = fit_gmm_in_graph(fleet_samples, fleet_mask,
                                 prior(in_wts, edge_wts, ret_wts),
                                 prior(in_mus, edge_mus, ret_mus),
                                 prior(in_sds, edge_sds, ret_sds), max_k=K)
    w, mu, sd = (a.reshape(P, Ne, K) for a in (w, mu, sd))
    edge = slice(E, E + E * E)
    ret = slice(E + E * E, None)
    return (w[:, edge].reshape(P, E, E, K), mu[:, edge].reshape(P, E, E, K),
            sd[:, edge].reshape(P, E, E, K),
            w[:, :E], mu[:, :E], sd[:, :E], w[:, ret], mu[:, ret], sd[:, ret])


def solve_em_fleet(in_start, in_end, in_valid, out_start, out_end, out_valid,
                   skip_cap, force_skip, param_idx, window_rows, window_valid,
                   pred_masks, root_masks, is_lasts,
                   edge_wts, edge_mus, edge_sds, in_wts, in_mus, in_sds,
                   ret_wts, ret_mus, ret_sds, **kw):
    """Both EM passes for a whole fleet in one call: pass 0 over every
    service's windows, :func:`refit_fleet_params`, pass 1. Returns
    ``(packed, converged)`` like :func:`solve_windows_fleet` (pass 1's
    flags; ``confidence`` applies to pass 1's block)."""
    confidence = kw.pop("confidence", False)
    windows = (in_start, in_end, in_valid, out_start, out_end, out_valid,
               skip_cap, force_skip, param_idx)
    structure = (pred_masks, root_masks, is_lasts)
    packed0, _ = solve_windows_fleet(
        *windows, *structure, edge_wts, edge_mus, edge_sds,
        in_wts, in_mus, in_sds, ret_wts, ret_mus, ret_sds, **kw)
    tables = refit_fleet_params(
        packed0[..., _layout.CH_ASSIGN], in_start, in_end, in_valid,
        out_start, out_end, param_idx, window_rows, window_valid,
        pred_masks, root_masks, edge_wts, edge_mus, edge_sds,
        in_wts, in_mus, in_sds, ret_wts, ret_mus, ret_sds)
    return solve_windows_fleet(*windows, *structure, *tables,
                               confidence=confidence, **kw)


# ---------------------------------------------------------------------------
# Host-side problem packing (columnar)
# ---------------------------------------------------------------------------

def in_columns(in_spans: List[Span]) -> SpanArray:
    return SpanArray.from_spans(in_spans)


def out_columns(out_span_partitions: Dict[str, List[Span]],
                out_eps: List[str]) -> Dict[str, SpanArray]:
    """Ascending-start columns per outgoing endpoint (stable sort)."""
    return {ep: SpanArray.from_spans(out_span_partitions[ep]).sorted_by_start()
            for ep in out_eps}


def perfect_cut_windows_cols(cols: SpanArray,
                             max_size: int) -> List[Tuple[int, int]]:
    """[start, end) windows of sorted spans: cut wherever the running max
    of earlier ends is <= the next start, then split each segment into
    ``max_size`` chunks."""
    n = len(cols)
    if n == 0:
        return []
    cut = np.zeros(n, dtype=bool)
    if n > 1:
        cut[1:] = np.maximum.accumulate(cols.end)[:-1] <= cols.start[1:]
    bounds = [0, *np.flatnonzero(cut).tolist(), n]
    windows: List[Tuple[int, int]] = []
    for a, b in zip(bounds[:-1], bounds[1:]):
        if a == b:
            continue
        for s in range(a, b, max_size):
            windows.append((s, min(s + max_size, b)))
    return windows


def scatter_window_span_stats(windows, not_best, feas,
                              span_not_best, span_cands) -> None:
    """Per-span reductions over a packed window batch, in place: "not
    best" if any endpoint's OT choice overrode the row argmax; candidate
    count = product of per-endpoint feasible counts."""
    if not windows:
        return
    w_of = np.concatenate(
        [np.full(hi - lo, b) for b, (lo, hi) in enumerate(windows)])
    i_of = np.concatenate([np.arange(hi - lo) for lo, hi in windows])
    pos = np.concatenate([np.arange(lo, hi) for lo, hi in windows])
    span_not_best[pos] = not_best[w_of, :, i_of].any(axis=1)
    span_cands[pos] = np.maximum(
        feas[w_of, :, i_of], 1).astype(np.int64).prod(axis=1)


def _bucket(n: int, minimum: int = 8) -> int:
    return pow2_bucket(n, minimum)


def _window_bounds(windows: List[Tuple[int, int]], start: np.ndarray,
                   end: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Per-window [first start, max end] bounds."""
    B = len(windows)
    los = np.fromiter((lo for lo, _ in windows), np.int64, B)
    his = np.fromiter((hi for _, hi in windows), np.int64, B)
    idx = np.empty(2 * B, dtype=np.int64)
    idx[0::2] = los
    idx[1::2] = his
    if idx[-1] >= start.shape[0]:
        seg = np.maximum.reduceat(end, idx[:-1])
    else:
        seg = np.maximum.reduceat(end, idx)
    return start[los], seg[0::2]


def candidate_ranges(in_cols: SpanArray, windows: List[Tuple[int, int]],
                     out_eps: List[str],
                     out_starts_np: Dict[str, np.ndarray]) -> np.ndarray:
    """[B, E, 2] candidate index ranges: per window and endpoint, the
    slice of the endpoint's start-sorted out-spans that start within the
    window's [first start, last end]."""
    if not windows:
        return np.zeros((0, len(out_eps), 2), dtype=np.int64)
    w_t0, w_t1 = _window_bounds(windows, in_cols.start, in_cols.end)
    ranges = np.zeros((len(windows), len(out_eps), 2), dtype=np.int64)
    for e, ep in enumerate(out_eps):
        starts = out_starts_np[ep]
        ranges[:, e, 0] = np.searchsorted(starts, w_t0, side="left")
        ranges[:, e, 1] = np.searchsorted(starts, w_t1, side="right")
    return ranges


class EndpointIds:
    """Decode-time id map of one endpoint of a packed batch: the sorted
    id table plus each window row's ``(r0, count)`` candidate range."""

    __slots__ = ("table", "r0", "count", "M")

    def __init__(self, table: np.ndarray, r0: np.ndarray, count: np.ndarray,
                 M: int) -> None:
        self.table = table
        self.r0 = r0
        self.count = count
        self.M = M

    def rows(self, n: int) -> "EndpointIds":
        """The first ``n`` window rows (the fleet packer's row cut)."""
        return EndpointIds(self.table, self.r0[:n], self.count[:n], self.M)

    def gather(self) -> np.ndarray:
        """The ``[B * M]`` id layout (None in empty slots)."""
        B, M = self.r0.shape[0], self.M
        j = np.arange(M)
        valid = j[None, :] < self.count[:, None]
        src = np.where(valid, self.r0[:, None] + j[None, :], 0)
        out = np.full((B, M), None, dtype=object)
        out[valid] = self.table[src[valid]]
        return out.reshape(B * M)


@dataclass
class PackedProblem:
    """Dense window tensors (numpy) + the id maps to decode device output.

    ``devcols`` (the fleet's device-resident path) replaces the six big
    window tensors with ring-slot index arrays and the owning column
    rings (:class:`~traceweaver_tpu_torch.ops.devcols.ColumnRing`): the window
    tensors are gathered on the device
    (:func:`traceweaver_tpu_torch.ops.devcols.assemble_windows`) and
    never exist in host memory; ``arrays`` then holds only the skip and
    force tensors and the problem tables."""

    arrays: Dict[str, np.ndarray]
    out_eps: List[str]
    windows: List[Tuple[int, int]]
    in_ids: np.ndarray
    out_ids: List[EndpointIds]
    n_in: int
    devcols: Optional[Dict] = None

    @property
    def M(self) -> int:
        if self.devcols is not None:
            return int(self.devcols["out_idx"].shape[2])
        return int(self.arrays["out_start"].shape[2])

    def out_id_array(self, e: int) -> np.ndarray:
        return self.out_ids[e].gather()

    def truncate_rows(self, n_rows: int) -> None:
        """Drop the power-of-two B padding from the id maps: the fleet
        packer slices every batch tensor to its exact window count, and
        decode's ``b * M + j`` indexing must follow."""
        self.out_ids = [col.rows(n_rows) for col in self.out_ids]


def _problem_tables(out_eps: List[str], E_pad: int,
                    dists: Dict[Tuple[str, str], EdgeDist], in_ep: str,
                    dag: Optional[DAG], parallel: bool) -> Dict[str, np.ndarray]:
    """DAG structure masks + distribution parameter tables of a problem."""
    E = len(out_eps)
    pred_mask = np.zeros((E_pad, E_pad), dtype=bool)
    root_mask = np.zeros((E_pad,), dtype=bool)
    is_last = np.zeros((E_pad,), dtype=bool)
    if parallel or dag is None:
        root_mask[:E] = True
    else:
        for e, ep in enumerate(out_eps):
            preds = timing.primary_pred_edges(dag, ep)
            if len(dag.in_edges(ep)) == 0 or in_ep in preds:
                root_mask[e] = True
            for p in preds:
                if p != in_ep and p in out_eps:
                    pred_mask[e, out_eps.index(p)] = True
        is_last[E - 1] = True

    K = MAX_COMPONENTS
    wide = EdgeDist.gaussian(0.0, 1e7)  # near-flat fallback for unseen edges

    def params_of(key) -> EdgeDist:
        return dists.get(key, wide)

    edge_wt = np.zeros((E_pad, E_pad, K), dtype=np.float32)
    edge_mu = np.zeros((E_pad, E_pad, K), dtype=np.float32)
    edge_sd = np.ones((E_pad, E_pad, K), dtype=np.float32)
    in_wt = np.zeros((E_pad, K), dtype=np.float32)
    in_mu = np.zeros((E_pad, K), dtype=np.float32)
    in_sd = np.ones((E_pad, K), dtype=np.float32)
    ret_wt = np.zeros((E_pad, K), dtype=np.float32)
    ret_mu = np.zeros((E_pad, K), dtype=np.float32)
    ret_sd = np.ones((E_pad, K), dtype=np.float32)
    for e, ep in enumerate(out_eps):
        d = params_of((in_ep, ep))
        in_wt[e], in_mu[e], in_sd[e] = d.weights, d.means, d.stds
        d = params_of((ep, in_ep))
        ret_wt[e], ret_mu[e], ret_sd[e] = d.weights, d.means, d.stds
        for p, pep in enumerate(out_eps):
            d = params_of((pep, ep))
            edge_wt[e, p], edge_mu[e, p], edge_sd[e, p] = d.weights, d.means, d.stds

    return dict(
        pred_mask=pred_mask, root_mask=root_mask, is_last=is_last,
        edge_wt=edge_wt, edge_mu=edge_mu, edge_sd=edge_sd,
        in_wt=in_wt, in_mu=in_mu, in_sd=in_sd,
        ret_wt=ret_wt, ret_mu=ret_mu, ret_sd=ret_sd,
    )


def dists_from_tables(out_eps: List[str], in_ep: str,
                      edge_wt, edge_mu, edge_sd, in_wt, in_mu, in_sd,
                      ret_wt, ret_mu, ret_sd) -> Dict[Tuple[str, str], EdgeDist]:
    """Inverse of :func:`_problem_tables`: one service's refit tables (the
    order :func:`refit_fleet_params` returns them) back into the
    ``{(parent_ep, child_ep): EdgeDist}`` dict.

    Every family row of the true endpoints is decoded, edges the refit
    saw no samples for included: :func:`fit_gmm_in_graph` keeps the
    prior for empty rows, so repacking the dict reproduces the device
    tables bit for bit (f32 -> f64 -> f32 is exact). That is what lets
    the plan cache admit a device refit and the next solve start from
    it unchanged."""
    def mk(w, m, s) -> EdgeDist:
        return EdgeDist(np.asarray(w, dtype=np.float64),
                        np.asarray(m, dtype=np.float64),
                        np.asarray(s, dtype=np.float64))

    dists: Dict[Tuple[str, str], EdgeDist] = {}
    for e, ep in enumerate(out_eps):
        dists[(in_ep, ep)] = mk(in_wt[e], in_mu[e], in_sd[e])
        dists[(ep, in_ep)] = mk(ret_wt[e], ret_mu[e], ret_sd[e])
        for p, pep in enumerate(out_eps):
            dists[(pep, ep)] = mk(edge_wt[e, p], edge_mu[e, p], edge_sd[e, p])
    return dists


def pack_problem(
    in_spans: List[Span],
    out_span_partitions: Dict[str, List[Span]],
    out_eps: List[str],
    dists: Dict[Tuple[str, str], EdgeDist],
    in_ep: str,
    dag: Optional[DAG],
    force_skip_ids: Optional[Dict[str, set]] = None,
    max_window: int = DEFAULT_MAX_WINDOW,
    parallel: bool = False,
    windows: Optional[List[Tuple[int, int]]] = None,
    pad_w: Optional[int] = None,
    pad_b: Optional[int] = None,
    pad_m: Optional[int] = None,
    pad_e: Optional[int] = None,
    ranges: Optional[np.ndarray] = None,
    skip_caps: Optional[np.ndarray] = None,
    in_cols: Optional[SpanArray] = None,
    out_cols: Optional[Dict[str, SpanArray]] = None,
) -> PackedProblem:
    """Dense [B, ...] window tensors (numpy, f32/bool) for the solve,
    filled by slicing and gathers over the partitions' columns.
    ``pad_*`` force the padded sizes (still rounded up to powers of
    two); padded endpoints carry no valid columns."""
    E = len(out_eps)
    E_pad = max(E, pad_e or E)
    if in_cols is None:
        in_cols = in_columns(in_spans)
    if out_cols is None:
        out_cols = out_columns(out_span_partitions, out_eps)
    if windows is None:
        windows = perfect_cut_windows_cols(in_cols, max_window)
    n_windows = len(windows)
    B = _bucket(max(n_windows, pad_b or 1), minimum=1)
    W = _bucket(max(max(hi - lo for lo, hi in windows), pad_w or 1))

    if ranges is None:
        out_starts_np = {ep: out_cols[ep].start for ep in out_eps}
        ranges = candidate_ranges(in_cols, windows, out_eps, out_starts_np)
    M = _bucket(max(int((ranges[:, :, 1] - ranges[:, :, 0]).max(initial=1)),
                    pad_m or 1))

    in_start = np.zeros((B, W), dtype=np.float32)
    in_end = np.zeros((B, W), dtype=np.float32)
    in_valid = np.zeros((B, W), dtype=bool)
    out_start = np.zeros((B, E_pad, M), dtype=np.float32)
    out_end = np.zeros((B, E_pad, M), dtype=np.float32)
    out_valid = np.zeros((B, E_pad, M), dtype=bool)
    skip_cap = np.zeros((B, E_pad), dtype=np.float32)
    force_skip = np.zeros((B, E_pad, W), dtype=bool)

    los = np.fromiter((lo for lo, _ in windows), np.int64, n_windows)
    his = np.fromiter((hi for _, hi in windows), np.int64, n_windows)
    n_w = his - los
    origins = in_cols.start[los]

    jw = np.arange(W)
    w_valid = jw[None, :] < n_w[:, None]
    w_src = np.where(w_valid, los[:, None] + jw[None, :], 0)
    in_start[:n_windows][w_valid] = (in_cols.start[w_src] - origins[:, None])[w_valid]
    in_end[:n_windows][w_valid] = (in_cols.end[w_src] - origins[:, None])[w_valid]
    in_valid[:n_windows] = w_valid

    jm = np.arange(M)
    r0 = ranges[:, :, 0]
    m_w = ranges[:, :, 1] - r0
    out_ids: List[EndpointIds] = []
    for e, ep in enumerate(out_eps):
        cols = out_cols[ep]
        c_valid = jm[None, :] < m_w[:, e][:, None]
        c_src = np.where(c_valid, r0[:, e][:, None] + jm[None, :], 0)
        out_start[:n_windows, e][c_valid] = (cols.start[c_src] - origins[:, None])[c_valid]
        out_end[:n_windows, e][c_valid] = (cols.end[c_src] - origins[:, None])[c_valid]
        out_valid[:n_windows, e] = c_valid
        r0_pad = np.zeros(B, dtype=np.int64)
        cnt_pad = np.zeros(B, dtype=np.int64)
        r0_pad[:n_windows] = r0[:, e]
        cnt_pad[:n_windows] = m_w[:, e]
        out_ids.append(EndpointIds(cols.ids, r0_pad, cnt_pad, M))

    # water-filled skip budget when given; the solver still grants
    # window-local slack max(rows - cols, 0) on the device
    if skip_caps is not None:
        skip_cap[:n_windows, :E] = skip_caps
    else:
        skip_cap[:n_windows, :E] = np.maximum(n_w[:, None] - m_w, 0)

    if force_skip_ids:
        in_ids_arr = in_cols.ids
        for e, ep in enumerate(out_eps):
            fs = force_skip_ids.get(ep, set())
            if not fs:
                continue
            for b in range(n_windows):
                lo, hi = int(los[b]), int(his[b])
                mask = np.fromiter((i in fs for i in in_ids_arr[lo:hi]),
                                   bool, hi - lo)
                n_forced = int(mask.sum())
                if n_forced:
                    force_skip[b, e, :hi - lo] = mask
                skip_cap[b, e] = max(skip_cap[b, e], n_forced)

    arrays = dict(
        in_start=in_start, in_end=in_end, in_valid=in_valid,
        out_start=out_start, out_end=out_end, out_valid=out_valid,
        skip_cap=skip_cap, force_skip=force_skip,
        **_problem_tables(out_eps, E_pad, dists, in_ep, dag, parallel),
    )
    return PackedProblem(arrays=arrays, out_eps=out_eps, windows=windows,
                         in_ids=in_cols.ids, out_ids=out_ids,
                         n_in=len(in_cols))


def _pack_problem_devcols(
    in_spans: List[Span],
    out_span_partitions: Dict[str, List[Span]],
    out_eps: List[str],
    dists: Dict[Tuple[str, str], EdgeDist],
    in_ep: str,
    dag: Optional[DAG],
    in_slots: np.ndarray,
    out_slots: Dict[str, np.ndarray],
    ring_in,
    ring_out,
    force_skip_ids: Optional[Dict[str, set]] = None,
    max_window: int = DEFAULT_MAX_WINDOW,
    parallel: bool = False,
    windows: Optional[List[Tuple[int, int]]] = None,
    pad_w: Optional[int] = None,
    pad_b: Optional[int] = None,
    pad_m: Optional[int] = None,
    pad_e: Optional[int] = None,
    ranges: Optional[np.ndarray] = None,
    skip_caps: Optional[np.ndarray] = None,
    in_cols: Optional[SpanArray] = None,
    out_cols: Optional[Dict[str, SpanArray]] = None,
) -> PackedProblem:
    """The device-resident body of :func:`pack_problem` (the fleet's
    ``devcols`` path; the JAX package's ``_pack_problem_devcols``): the
    same windows, candidate ranges, skip caps, id maps and problem
    tables, but in place of the six dense window tensors it emits int32
    ring-slot index arrays (``in_idx [B, W]``, ``out_idx [B, E, M]``, -1
    for no span) and each window's origin relative to each ring's epoch;
    the window tensors are gathered on the device at dispatch.

    ``in_slots`` / ``out_slots[ep]`` map each sorted partition position
    to its live ring slot (the slots of :meth:`ColumnRing.resolve`),
    resolved by the caller before packing."""
    E = len(out_eps)
    E_pad = max(E, pad_e or E)
    if in_cols is None:
        in_cols = in_columns(in_spans)
    if out_cols is None:
        out_cols = out_columns(out_span_partitions, out_eps)
    if windows is None:
        windows = perfect_cut_windows_cols(in_cols, max_window)
    n_windows = len(windows)
    B = _bucket(max(n_windows, pad_b or 1), minimum=1)
    W = _bucket(max(max(hi - lo for lo, hi in windows), pad_w or 1))

    if ranges is None:
        out_starts_np = {ep: out_cols[ep].start for ep in out_eps}
        ranges = candidate_ranges(in_cols, windows, out_eps, out_starts_np)
    M = _bucket(max(int((ranges[:, :, 1] - ranges[:, :, 0]).max(initial=1)),
                    pad_m or 1))

    skip_cap = np.zeros((B, E_pad), dtype=np.float32)
    force_skip = np.zeros((B, E_pad, W), dtype=bool)
    in_idx = np.full((B, W), -1, dtype=np.int32)
    out_idx = np.full((B, E_pad, M), -1, dtype=np.int32)
    origin_in = np.zeros(B, dtype=np.int32)
    origin_out = np.zeros(B, dtype=np.int32)

    los = np.fromiter((lo for lo, _ in windows), np.int64, n_windows)
    his = np.fromiter((hi for _, hi in windows), np.int64, n_windows)
    n_w = his - los
    origins = in_cols.start[los]
    origin_in[:n_windows] = ring_in.rel32(origins)
    origin_out[:n_windows] = ring_out.rel32(origins)

    jw = np.arange(W)
    w_valid = jw[None, :] < n_w[:, None]
    w_src = np.where(w_valid, los[:, None] + jw[None, :], 0)
    in_idx[:n_windows][w_valid] = in_slots[w_src][w_valid]

    jm = np.arange(M)
    r0 = ranges[:, :, 0]
    m_w = ranges[:, :, 1] - r0
    out_ids: List[EndpointIds] = []
    for e, ep in enumerate(out_eps):
        cols = out_cols[ep]
        c_valid = jm[None, :] < m_w[:, e][:, None]
        c_src = np.where(c_valid, r0[:, e][:, None] + jm[None, :], 0)
        out_idx[:n_windows, e][c_valid] = out_slots[ep][c_src][c_valid]
        r0_pad = np.zeros(B, dtype=np.int64)
        cnt_pad = np.zeros(B, dtype=np.int64)
        r0_pad[:n_windows] = r0[:, e]
        cnt_pad[:n_windows] = m_w[:, e]
        out_ids.append(EndpointIds(cols.ids, r0_pad, cnt_pad, M))

    if skip_caps is not None:
        skip_cap[:n_windows, :E] = skip_caps
    else:
        skip_cap[:n_windows, :E] = np.maximum(n_w[:, None] - m_w, 0)

    if force_skip_ids:
        in_ids_arr = in_cols.ids
        for e, ep in enumerate(out_eps):
            fs = force_skip_ids.get(ep, set())
            if not fs:
                continue
            for b in range(n_windows):
                lo, hi = int(los[b]), int(his[b])
                mask = np.fromiter((i in fs for i in in_ids_arr[lo:hi]),
                                   bool, hi - lo)
                n_forced = int(mask.sum())
                if n_forced:
                    force_skip[b, e, :hi - lo] = mask
                skip_cap[b, e] = max(skip_cap[b, e], n_forced)

    arrays = dict(
        skip_cap=skip_cap, force_skip=force_skip,
        **_problem_tables(out_eps, E_pad, dists, in_ep, dag, parallel),
    )
    return PackedProblem(
        arrays=arrays, out_eps=out_eps, windows=windows,
        in_ids=in_cols.ids, out_ids=out_ids, n_in=len(in_cols),
        devcols=dict(in_idx=in_idx, out_idx=out_idx, origin_in=origin_in,
                     origin_out=origin_out, ring_in=ring_in, ring_out=ring_out))


def plan_find_assignments(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    out_eps: List[str],
    dag: Optional[DAG],
    true_assignments,
    true_skips: bool = False,
    true_dist: bool = False,
    parallel_mode: bool = False,
    skip_fit: bool = False,
) -> Dict:
    """The solve plan: per-endpoint skip budgets, the dynamism flag,
    forced-skip rows of the true-skips oracle, initial distributions and
    the EM iteration count. ``skip_fit`` leaves ``dists`` empty for a
    caller that brings its own (a warm start or a plan-cache hit); the
    rest of the plan is the same."""
    in_ep = next(iter(in_span_partitions))
    n_in = len(in_span_partitions[in_ep])
    skip_budget = {ep: n_in - len(out_span_partitions[ep]) for ep in out_eps}
    dynamism = any(b > 0 for b in skip_budget.values())

    force_skip_ids = None
    if true_skips:
        force_skip_ids = {
            ep: {in_id for in_id, out_id in true_assignments[ep].items()
                 if tuple(out_id) == SKIP}
            for ep in out_eps
        }

    if skip_fit:
        dists = {}
    elif true_dist:
        dists = timing.true_distributions(
            in_span_partitions, out_span_partitions, out_eps, true_assignments)
    elif dynamism or dag is None:
        dists = timing.bootstrap_distributions(
            in_span_partitions, out_span_partitions, out_eps)
    else:
        dists = timing.estimate_edge_params(
            in_span_partitions, out_span_partitions, dag, 0, n_in)

    iterations = 1 if (parallel_mode or dynamism or true_dist) else 2
    return dict(skip_budget=skip_budget, dynamism=dynamism,
                force_skip_ids=force_skip_ids, dists=dists,
                iterations=iterations, n_in=n_in, in_ep=in_ep)


# ---------------------------------------------------------------------------
# The plugin-facing solver class
# ---------------------------------------------------------------------------

# every accumulating update of a solve's stats also lands in the metrics
# registry, so a scrape covers the per-service path too
_OBS_SOLVER = _get_registry().counter(
    "tw_solver_ledger_total",
    "per-service WeaverTorch solve ledger mirror (stage seconds)",
    labels=("key",))


def _stat_add(stats: Dict[str, float], key: str, val: float) -> None:
    _OBS_SOLVER.inc(val, key=key)
    stats[key] = stats.get(key, 0.0) + val


def resolve_device(device) -> torch.device:
    """``None`` means the card, and raises when there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("the port runs on the card and no CUDA device is "
                               "available; pass device='cpu' to run the plain "
                               "versions on the CPU")
        device = "cuda"
    return torch.device(device)


class WeaverTorch:
    """The TraceWeaverV3-capability solver behind the reconstructor
    plugin contract (``WeaverTPU`` in the JAX package).

    ``device=None`` means the card (``cuda``), and raises when there is
    none; tests pass ``device="cpu"``. The JAX package's ``TW_*`` knobs
    are constructor arguments here with the knobs' defaults;
    ``fused_kernel`` is the counterpart of ``TW_PALLAS_FUSED``,
    ``precision`` (``"f32"`` or ``"bf16"``) of ``TW_PRECISION``,
    ``score_gemm`` of ``TW_SCORE_GEMM`` and ``confidence`` of
    ``TW_CONFIDENCE``: with it, every ``FindAssignments`` leaves its
    per-span records (:mod:`traceweaver_tpu_torch.obs.quality`) in
    :attr:`per_span_confidence`.

    ``mesh`` (a :class:`~traceweaver_tpu_torch.parallel.mesh.Mesh`, whose
    size must be a power of two) shards every dispatch's window batch
    over its devices, each shard solved on its own device; the chunk
    budget scales by the mesh size and each chunk pads to a multiple of
    it. The solver's device is then the mesh's first, where the fused
    EM's refit gathers every shard's windows and the host refit's tensors
    live.
    """

    def __init__(self, all_spans, all_processes,
                 max_window: int = DEFAULT_MAX_WINDOW, epsilon: float = 1.0,
                 n_sinkhorn: int = 40, n_sweeps: int = 5,
                 sinkhorn_tol: float = 1e-3,
                 precision: str = "f32", topk: int = DEFAULT_TOPK,
                 fused_kernel: bool = True, device=None,
                 confidence: bool = True, score_gemm: bool = False, mesh=None):
        if mesh is not None:
            n_dev = mesh.size
            assert n_dev & (n_dev - 1) == 0, (
                "mesh size must be a power of two so padded window batches "
                "divide evenly across devices")
        self.mesh = mesh
        self.device = mesh.devices[0] if mesh is not None else resolve_device(device)
        self.all_spans = all_spans
        self.all_processes = all_processes
        self.max_window = max_window
        self.epsilon = epsilon
        self.n_sinkhorn = n_sinkhorn
        self.n_sweeps = n_sweeps
        self.sinkhorn_tol = sinkhorn_tol
        self.precision = validate_precision(precision)
        self.topk = topk
        self.fused_kernel = fused_kernel
        self.confidence = confidence
        self.score_gemm = score_gemm
        # per-solve stage seconds, populated by FindAssignments
        self.stats: Dict[str, float] = {}
        # {in span id: confidence record} of the last solve ({} when off)
        self.per_span_confidence: Dict = {}

    @staticmethod
    def _topo_out_eps(out_span_partitions, invocation_graph) -> List[str]:
        if invocation_graph is not None and len(invocation_graph) > 0:
            first_start = {
                ep: spans[0].start_mus if spans else 0
                for ep, spans in out_span_partitions.items()
            }
            return invocation_graph.lexicographical_topological_sort(
                key=lambda ep: first_start.get(ep, 0))
        return get_out_eps_in_order(out_span_partitions)

    def _solve_once(self, in_spans, out_span_partitions, out_eps, dists,
                    in_ep, dag, force_skip_ids, parallel, stats, fused=False):
        """Solve every perfect-cut window in as few dispatches as the
        JAX package makes (same size-class merging and chunk budget, so
        the same fused-EM decision). Returns ``[(packed, (assign, topk,
        not_best, feas))]`` with numpy outputs; stage seconds and
        ``fused_em_applied`` go into the call's own ``stats``."""
        E = max(1, len(out_eps))
        n_sweeps = 1 if E == 1 else self.n_sweeps

        in_cols = in_columns(in_spans)
        out_cols = out_columns(out_span_partitions, out_eps)
        all_windows = perfect_cut_windows_cols(in_cols, self.max_window)
        out_starts_np = {ep: out_cols[ep].start for ep in out_eps}
        ranges_all = candidate_ranges(in_cols, all_windows, out_eps, out_starts_np)
        skip_caps_all = water_fill_skip_caps(
            all_windows, ranges_all, len(in_spans),
            [len(out_span_partitions[ep]) for ep in out_eps])
        width_of = {
            w: int((ranges_all[i, :, 1] - ranges_all[i, :, 0]).max(initial=1))
            for i, w in enumerate(all_windows)
        }
        row_of = {w: i for i, w in enumerate(all_windows)}

        def est_m(wins: List[Tuple[int, int]]) -> int:
            return _bucket(max(width_of[w] for w in wins))

        # size classes merged upward while the extra padding stays small
        groups: Dict[int, List[Tuple[int, int]]] = {}
        for w in all_windows:
            groups.setdefault(_bucket(w[1] - w[0]), []).append(w)
        classes = sorted(groups)
        batches_spec: List[Tuple[int, List[Tuple[int, int]]]] = []
        carry: List[Tuple[int, int]] = []
        for idx, c in enumerate(classes):
            wins = carry + groups[c]
            if idx + 1 < len(classes):
                nxt = classes[idx + 1]
                extra = sum(nxt - _bucket(hi - lo) for lo, hi in wins)
                if extra * est_m(wins) * E <= MERGE_ELEMS:
                    carry = wins
                    continue
            batches_spec.append((c, wins))
            carry = []

        # per-dispatch byte budget of score blocks at the score precision;
        # on a mesh each device owns a contiguous slice of a chunk's
        # windows, so the budget (per-device memory) scales by its size
        n_dev = self.mesh.size if self.mesh is not None else 1
        itemsize = score_itemsize(self.precision)
        chunk_bytes = CHUNK_ELEMS * 4
        plan = []
        for wclass, wins in batches_spec:
            m_est = est_m(wins)
            per_chunk = max(1, chunk_bytes // (wclass * m_est * E * itemsize)) * n_dev
            # the batch of the unsharded chunk, which a mesh shard's
            # launches are planned for
            plan_b = _bucket(min(len(wins), per_chunk // n_dev), minimum=1)
            chunks = [wins[i:i + per_chunk] for i in range(0, len(wins), per_chunk)]
            for chunk in chunks:
                plan.append((wclass, m_est, per_chunk, len(chunks), plan_b, chunk))
        # the on-device EM refits from its own windows' samples, so it
        # equals the global refit only when one dispatch covers the solve
        use_fused = fused and len(plan) == 1
        if use_fused:
            stats["fused_em_applied"] = 1.0

        results = []
        for wclass, m_est, per_chunk, n_chunks, plan_b, chunk in plan:
            t0 = time.perf_counter()
            packed = pack_problem(
                in_spans, out_span_partitions, out_eps, dists, in_ep, dag,
                force_skip_ids=force_skip_ids, parallel=parallel,
                windows=chunk, pad_w=wclass,
                pad_b=(per_chunk if n_chunks > 1 else n_dev if n_dev > 1 else None),
                pad_m=m_est if n_chunks > 1 else None,
                ranges=ranges_all[[row_of[w] for w in chunk]],
                skip_caps=skip_caps_all[[row_of[w] for w in chunk]],
                in_cols=in_cols, out_cols=out_cols)
            _stat_add(stats, "pack_s", time.perf_counter() - t0)
            t0 = time.perf_counter()
            pm_np = packed.arrays["pred_mask"]
            mp = _bucket(max(1, int(pm_np.sum(axis=1).max(initial=0))), minimum=1)
            ms = _bucket(max(1, int(pm_np.sum(axis=0).max(initial=0))), minimum=1)
            kw = dict(epsilon=self.epsilon, n_sinkhorn=self.n_sinkhorn,
                      topk=self.topk, n_sweeps=n_sweeps,
                      sinkhorn_tol=self.sinkhorn_tol, max_preds=mp, max_succs=ms,
                      precision=self.precision, fused=self.fused_kernel,
                      score_gemm=self.score_gemm)
            with _obs_profile.annotate("tw:solve:dispatch"):
                if self.mesh is None:
                    solve_fn = solve_em_packed if use_fused else solve_windows_packed
                    o = solve_fn(*(torch.as_tensor(packed.arrays[k], device=self.device)
                                   for k in ARG_ORDER), **kw).cpu().numpy()
                else:
                    from traceweaver_tpu_torch.parallel.mesh import solve_packed_sharded

                    o = solve_packed_sharded(packed.arrays, self.mesh, use_fused,
                                             plan_b, **kw)
            _stat_add(stats, "solve_s", time.perf_counter() - t0)
            ch = _layout.split_packed(o, topk=self.topk)
            results.append((packed, (ch["assign"], ch["topk_cols"],
                                     ch["not_best"], ch["feas"])))
        return results

    @staticmethod
    def _decode(packed: PackedProblem, assign: np.ndarray,
                topk_cols: np.ndarray, all_assignments, all_topk):
        """Device column indices -> span-id assignment dicts (in place)."""
        B, E, W = assign.shape
        M = packed.M
        K = topk_cols.shape[3]
        skip_v = np.empty((), dtype=object)
        skip_v[()] = SKIP
        na_v = np.empty((), dtype=object)
        na_v[()] = NA

        w_of = np.concatenate(
            [np.full(hi - lo, b) for b, (lo, hi) in enumerate(packed.windows)])
        i_of = np.concatenate([np.arange(hi - lo) for lo, hi in packed.windows])
        pos = np.concatenate([np.arange(lo, hi) for lo, hi in packed.windows])
        span_ids = packed.in_ids[pos].tolist()

        for e, ep in enumerate(packed.out_eps):
            ids = packed.out_id_array(e)
            cols = assign[w_of, e, i_of]
            chosen = ids[w_of * M + np.clip(cols, 0, M - 1)]
            chosen[chosen == None] = na_v  # noqa: E711 — elementwise None test
            chosen[cols < 0] = na_v
            chosen[cols == M] = skip_v

            tk = topk_cols[w_of, e, i_of, :]
            tk_ids = ids[w_of[:, None] * M + np.clip(tk, 0, M - 1)]
            tk_ids[tk_ids == None] = na_v  # noqa: E711
            tk_ids[(tk < 0) | (tk > M)] = na_v
            tk_ids[tk == M] = skip_v

            amap = all_assignments[ep]
            tmap = all_topk[ep]
            chosen_l = chosen.tolist()
            tk_l = tk_ids.tolist()
            for j, in_id in enumerate(span_ids):
                out_id = chosen_l[j]
                tks = tk_l[j]
                if out_id in tks:
                    tks.remove(out_id)
                amap[in_id] = out_id
                tmap[in_id] = [out_id] + tks[: K - 1]

    @staticmethod
    def _resolve_cross_window_duplicates(all_assignments, all_topk, in_ids,
                                         skip_budget):
        """Restore one-to-one-ness across capped sub-windows: per
        contested out-span the earliest incoming span keeps it; the
        others take their best free top-K alternative, SKIP while the
        endpoint's global budget has room, else NA."""
        for ep, assign_map in all_assignments.items():
            claims: Dict = {}
            skips_used = 0
            for in_id in in_ids:
                out_id = assign_map.get(in_id)
                if out_id == SKIP:
                    skips_used += 1
                elif out_id is not None and out_id != NA:
                    claims.setdefault(out_id, []).append(in_id)
            used = set(claims)
            for out_id, claimants in claims.items():
                for in_id in claimants[1:]:
                    replacement = NA
                    for cand in all_topk.get(ep, {}).get(in_id, []):
                        if cand == SKIP:
                            if skips_used < skip_budget.get(ep, 0):
                                replacement = SKIP
                                skips_used += 1
                                break
                            continue
                        if cand != NA and cand not in used:
                            replacement = cand
                            break
                    assign_map[in_id] = replacement
                    if replacement not in (NA, SKIP):
                        used.add(replacement)
                    tk = all_topk.get(ep, {}).get(in_id)
                    if tk and replacement in tk:
                        tk.remove(replacement)
                        tk.insert(0, replacement)

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments, invocation_graph=None,
                        true_skips: bool = False, true_dist: bool = False):
        """Returns ``(assignments, topk, not_best_count, n_in,
        per_span_candidates, cnt_unassigned)`` like ``WeaverTPU``."""
        assert len(in_span_partitions) == 1
        in_ep, in_spans = next(iter(in_span_partitions.items()))
        in_spans = sorted(in_spans, key=lambda s: (s.start_mus, s.end_mus))
        out_eps = self._topo_out_eps(out_span_partitions, invocation_graph)
        parallel_mode = parallel or method == "MaxScoreBatchParallelWithoutIterations"

        plan = plan_find_assignments(
            in_span_partitions, out_span_partitions, out_eps,
            invocation_graph, true_assignments, true_skips=true_skips,
            true_dist=true_dist, parallel_mode=parallel_mode)
        n_in = plan["n_in"]
        skip_budget = plan["skip_budget"]
        dists = plan["dists"]
        iterations = plan["iterations"]

        # per-call state stays local until the call ends: the executor's
        # thread pool calls one instance from several threads at once
        stats: Dict[str, float] = {}
        per_span_confidence: Dict = {}
        all_assignments = all_topk = None
        not_best_count = 0
        per_span_candidates: Dict = {}
        in_ids = [s.GetId() for s in in_spans]
        it = 0
        while it < iterations:
            batches = self._solve_once(
                in_spans, out_span_partitions, out_eps, dists, in_ep,
                invocation_graph, plan["force_skip_ids"], parallel_mode,
                stats, fused=(iterations == 2 and it == 0))
            if stats.get("fused_em_applied"):
                iterations = 1  # the fused dispatch already ran both passes
            t0 = time.perf_counter()
            all_assignments = {ep: {} for ep in out_eps}
            all_topk = {ep: {} for ep in out_eps}
            span_not_best = np.zeros(n_in, dtype=bool)
            span_cands = np.ones(n_in, dtype=np.int64)
            conf_arrs = _quality.new_span_arrays(n_in) if self.confidence else None
            for packed, (assign, topk_cols, not_best, feas) in batches:
                self._decode(packed, assign, topk_cols, all_assignments, all_topk)
                scatter_window_span_stats(packed.windows, not_best, feas,
                                          span_not_best, span_cands)
                if self.confidence:
                    _quality.scatter_confidence(packed.windows, not_best, feas,
                                                topk_cols, conf_arrs)
            not_best_count = int(span_not_best.sum())
            per_span_candidates = {in_ids[i]: int(span_cands[i]) for i in range(n_in)}
            per_span_confidence = (_quality.confidence_records(
                in_ids, _quality.finish_confidence(conf_arrs))
                if self.confidence else {})
            self._resolve_cross_window_duplicates(
                all_assignments, all_topk, in_ids, skip_budget)
            _stat_add(stats, "decode_s", time.perf_counter() - t0)
            if it + 1 < iterations:
                t0 = time.perf_counter()
                dists = timing.refit_from_assignments(
                    in_span_partitions, out_span_partitions, invocation_graph,
                    all_assignments, self.all_spans, device=self.device)
                _stat_add(stats, "refit_s", time.perf_counter() - t0)
            it += 1

        cnt_unassigned = sum(
            1 for in_id in in_ids
            if any(all_assignments[ep][in_id] == NA for ep in out_eps))
        self.stats = stats
        self.per_span_confidence = per_span_confidence
        return (all_assignments, all_topk, not_best_count, n_in,
                per_span_candidates, cnt_unassigned)
