"""The plain reference: the solver's block assembly, Sinkhorn, rounding,
top-k peel and EM refit in plain PyTorch, f32, with no kernel.

Frozen copies, imported from nothing of the program:

- :func:`assemble_block` is ``traceweaver_tpu_torch/ops/scores.py``
  ``assemble_block_plain`` with ``mixture_logpdf``, ``_fma``,
  ``MixtureTerm.delta/mask/values`` and ``score_block_plain`` (lines
  62-301, the elementwise form only). A term is read by its fields
  (``row_t``, ``col_t``, ``wt``, ``mu``, ``sd``, ``active``, ``row_ok``,
  ``flip``), whatever class carries them.
- :func:`sinkhorn_log` is ``ops/sinkhorn.py`` (lines 23-84), returning
  also the iterations each block ran.
- :func:`greedy_round` and :func:`topk_peel` are ``ops/rounding.py``
  (lines 29-146), the rounding returning also the rounds each block ran;
  :func:`assign_topk` is ``ops/cuda_sinkhorn.py`` ``round_topk_plain`` and
  ``assign_topk_plain`` (lines 377-402).
- :func:`marginals` is the solver's marginals of one endpoint step
  (``algorithms/weaver_torch.py`` lines 218-226).
- :func:`fit_gmm_in_graph` is ``ops/gmm.py`` (``_em_fixed_k``,
  ``_fit_edge_z`` and ``fit_gmm_in_graph``, lines 35-118 and 219-270).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

NEG = -1.0e9
LOG_2PI = math.log(2.0 * math.pi)
SKIP_MARGIN = 4.0
SKIP_FLOOR = -60.0
#: the solver's sentinel assignments
SKIP = ("Skip", "Skip")
NA = ("NA", "NA")


# ---------------------------------------------------------------------------
# block assembly
# ---------------------------------------------------------------------------

def _fma(a, b, c):
    return (a.double() * b.double() + c.double()).to(a.dtype)


def mixture_logpdf(x, weights, means, stds):
    z = (x[..., None] - means) / stds
    comp = _fma(-0.5 * z, z, -torch.log(stds)) - 0.5 * LOG_2PI
    logw = torch.where(weights > 0, torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -math.inf))
    return torch.logsumexp(comp + logw, dim=-1)


def _term_values(t) -> torch.Tensor:
    delta = (t.row_t[:, :, None] - t.col_t[:, None, :] if t.flip
             else t.col_t[:, None, :] - t.row_t[:, :, None])
    sc = mixture_logpdf(delta, *(p[:, None, None, :] for p in (t.wt, t.mu, t.sd)))
    mask = t.active[:, None, None]
    if t.row_ok is not None:
        mask = mask & t.row_ok[:, :, None]
    return torch.where(mask, sc, torch.zeros((), dtype=sc.dtype, device=sc.device))


def _score_block(root, preds, succs, ret) -> torch.Tensor:
    S = _term_values(root)
    S = S + torch.stack([_term_values(t) for t in preds]).sum(dim=0)
    S = S + torch.stack([_term_values(t) for t in succs]).sum(dim=0)
    return S + _term_values(ret)


def assemble_block(root, preds: Sequence, succs: Sequence, ret, in_s, in_e, in_v,
                   o_s, o_e, o_v, t_prev, t_succ: Optional[torch.Tensor], force_skip,
                   precision: str = "f32"):
    """One endpoint's OT block ``[B, W+1, M+1]`` (feasibility mask, skip
    column, at ``"bf16"`` rows centred and rounded, a dummy row), its
    feasible counts ``[B, W]`` and its row argmax ``[B, W]``."""
    S = _score_block(root, preds, succs, ret)
    B, W, M = S.shape
    zero = torch.zeros((), dtype=S.dtype, device=S.device)
    neg = torch.full((), NEG, dtype=S.dtype, device=S.device)
    feas = (in_v[:, :, None] & o_v[:, None, :]
            & (in_s[:, :, None] <= o_s[:, None, :])
            & (o_e[:, None, :] <= in_e[:, :, None])
            & (t_prev[:, :, None] <= o_s[:, None, :])
            & ~force_skip[:, :, None])
    if t_succ is not None:
        feas = feas & (o_e[:, None, :] <= t_succ[:, :, None])
    S = torch.where(feas, S, neg)
    feas_count = feas.sum(dim=2, dtype=torch.int32)
    row_best = S.amax(dim=2)
    skip_score = torch.clamp(row_best - SKIP_MARGIN, min=SKIP_FLOOR)
    skip_score = torch.where(force_skip, zero, skip_score)
    skip_score = torch.where(in_v, skip_score, neg)
    Sfull = torch.cat([S, skip_score[:, :, None]], dim=2)
    if precision == "bf16":
        row_ref = torch.where(row_best > NEG / 2, row_best, zero)
        masked = Sfull <= NEG / 2
        Sfull = Sfull.sub_(row_ref[:, :, None]).masked_fill_(masked, NEG).to(
            torch.bfloat16)
    S_ot = torch.cat([Sfull, torch.zeros(B, 1, M + 1, dtype=Sfull.dtype,
                                         device=Sfull.device)], dim=1)
    return S_ot, feas_count, Sfull.argmax(dim=2).to(torch.int32)


# ---------------------------------------------------------------------------
# Sinkhorn, rounding, top-k
# ---------------------------------------------------------------------------

def _log_marginals(marg):
    marg = marg.to(torch.float32)
    return torch.where(marg > 0, torch.log(torch.clamp(marg, min=1e-30)),
                       torch.full_like(marg, NEG))


def sinkhorn_log(scores, row_marginals, col_marginals, epsilon: float = 1.0,
                 n_iters: int = 50, tol: float = 0.0):
    """Entropic OT plan ``[B, N, M]`` f32 and the iterations each block ran
    ([B] int64). With ``tol > 0`` a block stops once its largest live-row
    potential change is at most ``tol`` (that iteration's update kept)."""
    row_marginals = row_marginals.to(torch.float32)
    col_marginals = col_marginals.to(torch.float32)
    log_r = _log_marginals(row_marginals)
    log_c = _log_marginals(col_marginals)
    if scores.dtype == torch.bfloat16:
        logK = scores.to(torch.float32) * (1.0 / epsilon)
    else:
        logK = scores / epsilon
    neg_r = torch.full_like(log_r, NEG)
    neg_c = torch.full_like(log_c, NEG)
    row_live = row_marginals > 0
    col_live = col_marginals > 0

    def update(f, g):
        f = epsilon * (log_r - torch.logsumexp(logK + g[:, None, :] / epsilon, dim=2))
        f = torch.where(row_live, f, neg_r)
        g = epsilon * (log_c - torch.logsumexp(logK + f[:, :, None] / epsilon, dim=1))
        g = torch.where(col_live, g, neg_c)
        return f, g

    f = torch.zeros_like(log_r)
    g = torch.zeros_like(log_c)
    iters = torch.zeros(f.shape[0], dtype=torch.int64, device=f.device)
    if tol == 0.0:
        for _ in range(n_iters):
            f, g = update(f, g)
        iters += n_iters
    else:
        done = torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
        for _ in range(n_iters):
            f_new, g_new = update(f, g)
            delta = torch.where(row_live, (f_new - f).abs(),
                                torch.zeros_like(f)).amax(dim=1)
            f = torch.where(done[:, None], f, f_new)
            g = torch.where(done[:, None], g, g_new)
            iters += (~done).to(torch.int64)
            done = done | (delta <= tol)
            if bool(done.all()):
                break
    log_plan = logK + (f[:, :, None] + g[:, None, :]) / epsilon
    return torch.exp(torch.clamp(log_plan, -80.0, 80.0)), iters


def _cols_taken(commit_real, row_arg, c: int):
    hits = torch.zeros(commit_real.shape[0], c, dtype=torch.int32,
                       device=commit_real.device)
    hits.scatter_add_(1, row_arg, commit_real.to(torch.int32))
    return hits > 0


def greedy_round(plan, row_valid, col_valid, skip_capacity, n_steps: int):
    """Assignment ``[B, N]`` int32 (column a row, C - 1 = skip, -1 = none)
    by parallel mutual-best commits, and the rounds each block ran."""
    c = plan.shape[2]
    skip_col = c - 1
    plan = plan.to(torch.float32)
    mass = torch.where(row_valid[:, :, None] & col_valid[:, None, :], plan,
                       torch.tensor(NEG, dtype=plan.dtype, device=plan.device))
    B, n, _ = mass.shape
    dev = mass.device
    rows = torch.arange(n, device=dev)
    real_cols = torch.arange(c, device=dev) < skip_col
    neg = torch.tensor(NEG, dtype=mass.dtype, device=dev)
    cap = skip_capacity.to(torch.int32)
    assign = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    skip_used = torch.zeros(B, dtype=torch.int32, device=dev)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    for _ in range(n_steps):
        if not bool(running.any()):
            break
        rounds += running.to(torch.int64)
        live = torch.where(real_cols, mass, neg)
        row_val, row_arg = mass.max(dim=2)
        active = (assign == -1) & (row_val > NEG / 2)
        col_best_row = live.argmax(dim=1)
        picks_real = active & (row_arg < skip_col)
        mutual = torch.gather(col_best_row, 1, row_arg) == rows
        commit_real = picks_real & mutual & running[:, None]
        wants_skip = active & (row_arg == skip_col)
        skip_mass_col = mass[:, :, skip_col]
        contender = active & (skip_mass_col > NEG / 2)
        skip_mass = torch.where(contender, skip_mass_col, neg)
        beats = (skip_mass[:, None, :] > skip_mass[:, :, None]) | (
            (skip_mass[:, None, :] == skip_mass[:, :, None])
            & (rows[None, :] < rows[:, None]))
        rank = (beats & contender[:, None, :]).sum(dim=2, dtype=torch.int32)
        room = torch.clamp(cap - skip_used, min=0)
        commit_skip = wants_skip & (rank < room[:, None]) & running[:, None]
        commit = commit_real | commit_skip
        assign = torch.where(commit, row_arg.to(torch.int32), assign)
        skip_used = skip_used + commit_skip.sum(dim=1, dtype=torch.int32)
        mass = torch.where(commit[:, :, None], neg, mass)
        mass = torch.where(_cols_taken(commit_real, row_arg, c)[:, None, :], neg, mass)
        close = (skip_used >= cap) & running
        mass[:, :, skip_col] = torch.where(close[:, None], neg, mass[:, :, skip_col])
        running = running & commit.any(dim=1)
    return assign, rounds


def topk_peel(x, k: int):
    """Top-k by k argmax-and-mask passes (lower index first on ties; a pass
    whose masked maximum is -inf takes the first unpicked index)."""
    vals, idxs = [], []
    iota = torch.arange(x.shape[-1], device=x.device)
    picked = torch.zeros(x.shape, dtype=torch.bool, device=x.device)
    ninf = torch.tensor(-math.inf, dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    for step in range(k):
        masked = torch.where(picked, ninf, x)
        i = masked.argmax(dim=-1)
        if step > 0:
            mv = masked.amax(dim=-1)
            first_unpicked = (~picked).to(torch.int32).argmax(dim=-1)
            i = torch.where(torch.isneginf(mv), first_unpicked, i)
        sel = iota == i[..., None]
        vals.append(torch.where(sel, x, zero).sum(dim=-1))
        idxs.append(i)
        picked = picked | sel
    return torch.stack(vals, -1), torch.stack(idxs, -1).to(torch.int32)


def marginals(in_v, o_v, cap):
    """Row and column masses and column validity of one endpoint step: the
    dummy row takes the surplus columns, the skip column ``cap``."""
    f32 = torch.float32
    n_rows = in_v.sum(dim=1).to(f32)
    n_cols = o_v.sum(dim=1).to(f32)
    row_marg = torch.cat([in_v.to(f32),
                          torch.clamp(n_cols + cap - n_rows, min=0.0)[:, None]], dim=1)
    col_marg = torch.cat([o_v.to(f32), cap[:, None]], dim=1)
    col_valid = torch.cat([o_v, (cap > 0)[:, None]], dim=1)
    return row_marg, col_marg, col_valid


def assign_topk(S_ot, in_v, o_v, cap, n_rows: int, *, epsilon: float,
                n_iters: int, tol: float, topk: int, min_topk_mass: float):
    """``sinkhorn -> greedy_round -> topk_peel`` of blocks ``[B, R, C]``.
    Returns ``(assign [B, n_rows], topk [B, n_rows, topk], iters [B],
    rounds [B])``."""
    row_marg, col_marg, col_valid = marginals(in_v, o_v, cap)
    plan, iters = sinkhorn_log(S_ot, row_marg, col_marg, epsilon=epsilon,
                               n_iters=n_iters, tol=tol)
    plan = plan.to(torch.float32)[:, :n_rows, :].contiguous()
    assign, rounds = greedy_round(plan, in_v, col_valid, cap.to(torch.int32),
                                  n_steps=plan.shape[1])
    neg = torch.tensor(NEG, dtype=plan.dtype, device=plan.device)
    tk_mass, tk = topk_peel(torch.where(col_valid[:, None, :], plan, neg), topk)
    tk = torch.where(tk_mass > min_topk_mass, tk, torch.full_like(tk, -1))
    return assign, tk, iters, rounds


# ---------------------------------------------------------------------------
# the EM refit
# ---------------------------------------------------------------------------

def _em_fixed_k(z, mask, k: int, max_k: int, n_iters: int):
    E, N = z.shape
    n_valid = torch.clamp(mask.sum(dim=1).to(z.dtype), min=1.0)
    qs = (torch.arange(k, dtype=z.dtype, device=z.device) + 0.5) / k
    z_sorted = torch.sort(torch.where(mask, z, torch.full_like(z, math.inf)),
                          dim=1).values
    idx = torch.clamp((qs[None, :] * n_valid[:, None]).to(torch.int64), 0, N - 1)
    mu = torch.gather(z_sorted, 1, idx)
    var = torch.ones(E, k, dtype=z.dtype, device=z.device)
    w = torch.full((E, k), 1.0 / k, dtype=z.dtype, device=z.device)
    zk = z[:, :, None]
    mk = mask[:, :, None]

    def log_comp(mu, var, w):
        d = zk - mu[:, None, :]
        return (-0.5 * d * d / var[:, None, :]
                - 0.5 * torch.log(var)[:, None, :]
                - 0.5 * LOG_2PI
                + torch.log(torch.clamp(w, min=1e-30))[:, None, :])

    for _ in range(n_iters):
        lc = log_comp(mu, var, w)
        resp = torch.softmax(lc, dim=2)
        resp = torch.where(mk, resp, torch.zeros_like(resp))
        nj = torch.clamp(resp.sum(dim=1), min=1e-6)
        w = nj / n_valid[:, None]
        mu = (resp * zk).sum(dim=1) / nj
        d = zk - mu[:, None, :]
        var = (resp * d * d).sum(dim=1) / nj + 1e-6
    lc = log_comp(mu, var, w)
    ll = torch.where(mask, torch.logsumexp(lc, dim=2), torch.zeros_like(z)).sum(dim=1)
    pad = max_k - k
    return (torch.nn.functional.pad(w, (0, pad)), torch.nn.functional.pad(mu, (0, pad)),
            torch.nn.functional.pad(torch.sqrt(var), (0, pad), value=1.0), ll)


def _fit_edge_z(z, mask, nv, max_k: int, n_iters: int):
    bics, ws, mus, sds = [], [], [], []
    for k in range(1, max_k + 1):
        w, mu, sd, ll = _em_fixed_k(z, mask, k, max_k, n_iters)
        bic = -2.0 * ll + (3 * k - 1) * torch.log(nv)
        bics.append(torch.where(nv >= k, bic, torch.full_like(bic, math.inf)))
        ws.append(w)
        mus.append(mu)
        sds.append(sd)
    best = torch.stack(bics).argmin(dim=0)
    rows = torch.arange(z.shape[0], device=z.device)
    return (torch.stack(ws)[best, rows], torch.stack(mus)[best, rows],
            torch.stack(sds)[best, rows])


def fit_gmm_in_graph(samples, mask, prior_w, prior_mu, prior_sd, max_k: int = 5,
                     n_iters: int = 50) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BIC-selected Gaussian mixtures of each row of delay samples; rows of
    1-3 samples (or no spread) one Gaussian, rows with none the prior."""
    m = mask.to(samples.dtype)
    n = m.sum(dim=1)
    n1 = torch.clamp(n, min=1.0)
    mean = (samples * m).sum(dim=1) / n1
    d = (samples - mean[:, None]) * m
    var0 = (d * d).sum(dim=1) / n1
    scale = torch.sqrt(torch.clamp(var0, min=1e-12))
    z = torch.where(mask, d / scale[:, None], torch.zeros_like(d))
    w, mu_z, sd_z = _fit_edge_z(z, mask, n1, max_k, n_iters)
    mu = mean[:, None] + scale[:, None] * mu_z
    sd = torch.where(w > 0, torch.clamp(scale[:, None] * sd_z, min=1.0),
                     torch.ones_like(w))
    k0 = torch.zeros_like(prior_w)
    k0[:, 0] = 1.0
    mu0 = torch.zeros_like(prior_mu)
    mu0[:, 0] = mean
    sd0 = torch.ones_like(prior_sd)
    sd0[:, 0] = torch.clamp(torch.sqrt(torch.clamp(var0, min=0.0)), min=1e-3)
    few = ((n < 4) | (var0 <= 1e-12))[:, None]
    w = torch.where(few, k0, w)
    mu = torch.where(few, mu0, mu)
    sd = torch.where(few, sd0, sd)
    empty = (n < 1)[:, None]
    return (torch.where(empty, prior_w, w), torch.where(empty, prior_mu, mu),
            torch.where(empty, prior_sd, sd))
