"""Log-domain Sinkhorn, plain PyTorch (mirrors ``traceweaver_tpu/ops/sinkhorn.py``).

Entropic OT over masked score blocks, batched over a leading problem
axis: scores ``[B, N, M]`` (``NEG`` = masked), row/column marginals
``[B, N]``/``[B, M]`` (0 disables a row or column). This is the plain
version the CUDA kernels of :mod:`traceweaver_tpu_torch.ops.cuda_sinkhorn`
are held against, and what their wrappers run on CPU tensors.

bf16 scores follow the Pallas kernels (``pallas_sinkhorn.py:88-94``):
the block is upcast to f32 and scaled by ``1/epsilon`` on use, and the
potentials and the plan are f32. The JAX package's XLA ``sinkhorn_log``
(its CPU route) stores ``bf16(f32(S) / epsilon)`` instead; at
``epsilon = 1``, the solver's, the two give the same numbers.
"""

from __future__ import annotations

import torch

NEG = -1.0e9


def log_marginals(marg: torch.Tensor) -> torch.Tensor:
    """log of positive masses, NEG where the mass is 0."""
    marg = marg.to(torch.float32)
    return torch.where(marg > 0, torch.log(torch.clamp(marg, min=1e-30)),
                       torch.full_like(marg, NEG))


def sinkhorn_log(
    scores: torch.Tensor,         # [B, N, M] f32 or bf16 log-likelihoods
    row_marginals: torch.Tensor,  # [B, N]
    col_marginals: torch.Tensor,  # [B, M]
    epsilon: float = 1.0,
    n_iters: int = 50,
    tol: float = 0.0,
) -> torch.Tensor:
    """Entropic OT plan ``[B, N, M]`` (f32).

    ``tol == 0`` runs ``n_iters`` iterations. ``tol > 0`` stops a problem
    once its largest live-row potential change is <= ``tol``: the
    converging iteration's update is kept, then the problem freezes
    while its batchmates go on, so each result equals a solo run. Costs
    one host sync per iteration (the "all done" test).
    """
    row_marginals = row_marginals.to(torch.float32)
    col_marginals = col_marginals.to(torch.float32)
    log_r = log_marginals(row_marginals)
    log_c = log_marginals(col_marginals)
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
    if tol == 0.0:
        for _ in range(n_iters):
            f, g = update(f, g)
    else:
        done = torch.zeros(f.shape[0], dtype=torch.bool, device=f.device)
        for _ in range(n_iters):
            f_new, g_new = update(f, g)
            delta = torch.where(row_live, (f_new - f).abs(),
                                torch.zeros_like(f)).amax(dim=1)
            f = torch.where(done[:, None], f, f_new)
            g = torch.where(done[:, None], g, g_new)
            done = done | (delta <= tol)
            if bool(done.all()):
                break

    log_plan = logK + (f[:, :, None] + g[:, None, :]) / epsilon
    return torch.exp(torch.clamp(log_plan, -80.0, 80.0))
