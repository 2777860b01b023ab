"""Gaussian-mixture delay scores (mirrors ``traceweaver_tpu/ops/scores.py``,
elementwise form; the GEMM variant is not carried).

Mixture parameters ride as ``[..., K]`` rows (weight 0 = padding) and
broadcast against the delays, so one call scores a whole batch of
windows.
"""

from __future__ import annotations

import math

import torch

LOG_2PI = math.log(2.0 * math.pi)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` with the product exact (in f64), as a fused
    multiply-add computes it. XLA contracts this pattern into an FMA;
    matching it keeps the port's scores equal to the reference's where
    a one-ulp difference in a score of ~1e3 would flip a rounding tie."""
    return (a.double() * b.double() + c.double()).to(a.dtype)


def mixture_logpdf(x: torch.Tensor, weights: torch.Tensor,
                   means: torch.Tensor, stds: torch.Tensor) -> torch.Tensor:
    """Log-density of a Gaussian mixture; x: [...], params: [..., K]
    broadcastable against ``x[..., None]``."""
    z = (x[..., None] - means) / stds
    comp = _fma(-0.5 * z, z, -torch.log(stds)) - 0.5 * LOG_2PI
    logw = torch.where(weights > 0,
                       torch.log(torch.clamp(weights, min=1e-30)),
                       torch.full_like(weights, -math.inf))
    return torch.logsumexp(comp + logw, dim=-1)


def pair_scores(t_prev: torch.Tensor, out_start: torch.Tensor,
                weights: torch.Tensor, means: torch.Tensor,
                stds: torch.Tensor) -> torch.Tensor:
    """S[..., i, j] = log p(out_start[..., j] - t_prev[..., i]) under one
    edge's mixture. t_prev: [..., N]; out_start: [..., M]; params:
    [..., K] (one row per leading index)."""
    delta = out_start[..., None, :] - t_prev[..., :, None]      # [..., N, M]
    return mixture_logpdf(delta, weights[..., None, None, :],
                          means[..., None, None, :], stds[..., None, None, :])
