"""Rounding a transport plan to a hard one-to-one assignment, plain
PyTorch and batched (mirrors ``traceweaver_tpu/ops/rounding.py``).

Greedy peel by parallel mutual-best commits: each round, every row whose
best column (first-occurrence argmax) also ranks that row as its best
commits at once. The last column is the skip column with capacity
``skip_capacity``; a row commits to skip only when its skip mass ranks
inside the remaining capacity among all active rows (ties by row index),
which keeps the result equal to the serial peel.

A batch of problems runs like the JAX package's vmapped ``while_loop``:
each problem stops on its own (no commit in a round, or ``n_steps``
rounds) and its state is frozen while its batchmates go on. One host
sync per round.
"""

from __future__ import annotations

import math

import torch

NEG = -1.0e9

# topk_peel refuses k above this (the k-pass peel is for small k)
MAX_PEEL_K = 16


def greedy_round_core(
    mass0: torch.Tensor,          # [B, N, C] pre-masked plan (NEG = unavailable)
    skip_capacity: torch.Tensor,  # [B] int32
    n_steps: int,
    skip_col: int,
) -> torch.Tensor:
    """Returns the assignment ``[B, N]`` int32 (-1 = none)."""
    B, n, c = mass0.shape
    dev = mass0.device
    rows = torch.arange(n, device=dev)
    real_cols = torch.arange(c, device=dev) < skip_col
    neg = torch.tensor(NEG, dtype=mass0.dtype, device=dev)
    cap = skip_capacity.to(torch.int32)

    mass = mass0.clone()
    assign = torch.full((B, n), -1, dtype=torch.int32, device=dev)
    skip_used = torch.zeros(B, dtype=torch.int32, device=dev)
    running = torch.ones(B, dtype=torch.bool, device=dev)
    for _ in range(n_steps):
        if not bool(running.any()):
            break
        live = torch.where(real_cols, mass, neg)
        row_val, row_arg = mass.max(dim=2)                       # [B, N]
        active = (assign == -1) & (row_val > NEG / 2)

        # mutual-best commits on real columns
        col_best_row = live.argmax(dim=1)                        # [B, C]
        picks_real = active & (row_arg < skip_col)
        mutual = torch.gather(col_best_row, 1, row_arg) == rows
        commit_real = picks_real & mutual & running[:, None]

        # skip commits ranked among all active contenders
        wants_skip = active & (row_arg == skip_col)
        skip_mass_col = mass[:, :, skip_col]
        contender = active & (skip_mass_col > NEG / 2)
        skip_mass = torch.where(contender, skip_mass_col, neg)
        beats = (skip_mass[:, None, :] > skip_mass[:, :, None]) | (
            (skip_mass[:, None, :] == skip_mass[:, :, None])
            & (rows[None, :] < rows[:, None]))                   # [B, i, i']
        rank = (beats & contender[:, None, :]).sum(dim=2, dtype=torch.int32)
        room = torch.clamp(cap - skip_used, min=0)
        commit_skip = wants_skip & (rank < room[:, None]) & running[:, None]

        commit = commit_real | commit_skip
        assign = torch.where(commit, row_arg.to(torch.int32), assign)
        skip_used = skip_used + commit_skip.sum(dim=1, dtype=torch.int32)

        mass = torch.where(commit[:, :, None], neg, mass)
        col_taken = _cols_taken(commit_real, row_arg, c)
        mass = torch.where(col_taken[:, None, :], neg, mass)
        close = (skip_used >= cap) & running
        mass[:, :, skip_col] = torch.where(close[:, None], neg,
                                           mass[:, :, skip_col])
        running = running & commit.any(dim=1)
    return assign


def _cols_taken(commit_real: torch.Tensor, row_arg: torch.Tensor,
                c: int) -> torch.Tensor:
    """[B, C] bool: columns picked by a committing row."""
    B = commit_real.shape[0]
    hits = torch.zeros(B, c, dtype=torch.int32, device=commit_real.device)
    hits.scatter_add_(1, row_arg, commit_real.to(torch.int32))
    return hits > 0


def greedy_round(
    plan: torch.Tensor,           # [B, N, M+1]: last column = skip
    row_valid: torch.Tensor,      # [B, N] bool
    col_valid: torch.Tensor,      # [B, M+1] bool
    skip_capacity: torch.Tensor,  # [B] int
    n_steps: int,
) -> torch.Tensor:
    """Assignment ``[B, N]`` int32: column per row, M = skip, -1 = none."""
    c = plan.shape[2]
    plan = plan.to(torch.float32)
    mass0 = torch.where(row_valid[:, :, None] & col_valid[:, None, :], plan,
                        torch.tensor(NEG, dtype=plan.dtype, device=plan.device))
    return greedy_round_core(mass0, skip_capacity, n_steps, skip_col=c - 1)


def topk_peel(x: torch.Tensor, k: int):
    """Exact top-k for small ``k`` by k argmax+mask passes over the last
    axis: equal values give the lower index first; a pass whose masked
    maximum is -inf takes the first unpicked index. Returns (values,
    indices int32)."""
    if not torch.is_floating_point(x):
        raise TypeError(f"topk_peel: floating dtype required, got {x.dtype}")
    if k > x.shape[-1]:
        raise ValueError(f"topk_peel: k={k} > last-axis size {x.shape[-1]}")
    if k > MAX_PEEL_K:
        raise ValueError(f"topk_peel: k={k} > MAX_PEEL_K={MAX_PEEL_K}")
    if k == 0:
        empty = x.shape[:-1] + (0,)
        return (torch.zeros(empty, dtype=x.dtype, device=x.device),
                torch.zeros(empty, dtype=torch.int32, device=x.device))
    return topk_peel_core(x, k)


def topk_peel_core(x: torch.Tensor, k: int):
    """Guard-free body of :func:`topk_peel` (k >= 1)."""
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
