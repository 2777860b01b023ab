"""Batched 1-D Gaussian-mixture fits, the EM M-step (mirrors
``traceweaver_tpu/ops/gmm.py``).

Every edge's delay samples are padded into one ``[E, N]`` block; EM for
each component count 1..K runs over all edges at once (the JAX ``vmap``
is a leading batch axis here) and BIC picks the count per edge.

- :func:`fit_gmm_batched` standardizes each row on the host in f64, fits
  in z-space on the device, and transforms back in f64;
- :func:`fit_gmm_in_graph` stays on the device end to end (the fused
  two-pass EM), standardizing in f32 with the mean subtracted before
  squaring, keeping the prior parameters for empty rows and taking the
  closed-form single Gaussian for rows with fewer than 4 samples.

Component stds are floored at 1 µs after the back-transform.
"""

from __future__ import annotations

import math

import numpy as np
import torch

LOG_2PI = math.log(2.0 * math.pi)


def _em_fixed_k(z: torch.Tensor, mask: torch.Tensor, k: int, max_k: int,
                n_iters: int):
    """EM with k components for every row of standardized samples.

    z: [E, N] f32, mask: [E, N] bool. Returns (w, mu, sd, loglik), the
    params padded to ``max_k`` components (weight 0, std 1)."""
    E, N = z.shape
    n_valid = torch.clamp(mask.sum(dim=1).to(z.dtype), min=1.0)     # [E]

    # deterministic quantile init: means at evenly spaced quantiles
    qs = (torch.arange(k, dtype=z.dtype, device=z.device) + 0.5) / k
    z_sorted = torch.sort(torch.where(mask, z, torch.full_like(z, math.inf)),
                          dim=1).values
    idx = torch.clamp((qs[None, :] * n_valid[:, None]).to(torch.int64),
                      0, N - 1)
    mu = torch.gather(z_sorted, 1, idx)                              # [E, k]
    var = torch.ones(E, k, dtype=z.dtype, device=z.device)
    w = torch.full((E, k), 1.0 / k, dtype=z.dtype, device=z.device)
    zk = z[:, :, None]
    mk = mask[:, :, None]

    def log_comp(mu, var, w):
        d = zk - mu[:, None, :]                                      # [E, N, k]
        return (-0.5 * d * d / var[:, None, :]
                - 0.5 * torch.log(var)[:, None, :]
                - 0.5 * LOG_2PI
                + torch.log(torch.clamp(w, min=1e-30))[:, None, :])

    for _ in range(n_iters):
        lc = log_comp(mu, var, w)
        resp = torch.softmax(lc, dim=2)
        resp = torch.where(mk, resp, torch.zeros_like(resp))
        nj = torch.clamp(resp.sum(dim=1), min=1e-6)                  # [E, k]
        w = nj / n_valid[:, None]
        mu = (resp * zk).sum(dim=1) / nj
        d = zk - mu[:, None, :]
        var = (resp * d * d).sum(dim=1) / nj + 1e-6
    lc = log_comp(mu, var, w)
    ll = torch.where(mask, torch.logsumexp(lc, dim=2),
                     torch.zeros_like(z)).sum(dim=1)

    pad = max_k - k
    w = torch.nn.functional.pad(w, (0, pad))
    mu = torch.nn.functional.pad(mu, (0, pad))
    sd = torch.nn.functional.pad(torch.sqrt(var), (0, pad), value=1.0)
    return w, mu, sd, ll


def _fit_edge_z(z: torch.Tensor, mask: torch.Tensor, nv: torch.Tensor,
                max_k: int, n_iters: int):
    """BIC-selected GMM per row of standardized samples (z-space);
    ``nv`` [E] is each row's sample count (at least 1)."""
    bics, ws, mus, sds = [], [], [], []
    for k in range(1, max_k + 1):
        w, mu, sd, ll = _em_fixed_k(z, mask, k, max_k, n_iters)
        p = 3 * k - 1  # weights (k-1) + means (k) + vars (k)
        bic = -2.0 * ll + p * torch.log(nv)
        # k components need at least k samples to be identifiable
        bic = torch.where(nv >= k, bic, torch.full_like(bic, math.inf))
        bics.append(bic)
        ws.append(w)
        mus.append(mu)
        sds.append(sd)
    best = torch.stack(bics).argmin(dim=0)                          # [E]
    rows = torch.arange(z.shape[0], device=z.device)
    return (torch.stack(ws)[best, rows], torch.stack(mus)[best, rows],
            torch.stack(sds)[best, rows])


def _fit_gmm_z(z: torch.Tensor, mask: torch.Tensor, max_k: int = 5,
               n_iters: int = 50):
    """Device fit over pre-standardized samples; z-space params."""
    n_valid = torch.clamp(mask.sum(dim=1).to(z.dtype), min=1.0)
    return _fit_edge_z(z, mask, n_valid, max_k, n_iters)


def fit_gmm_batched(samples, mask, max_k: int = 5, n_iters: int = 50,
                    device="cuda"):
    """BIC-selected GMM fit for a batch of sample rows.

    samples: [E, N] (padded), mask: [E, N] bool, numpy. Returns (weights,
    means, stds), each [E, max_k] f64 numpy. The standardization runs on
    the host in f64 (large-microsecond delays keep their resolution);
    the fit runs on ``device`` in f32 on O(1) z values."""
    samples = np.asarray(samples, dtype=np.float64)
    mask_np = np.asarray(mask, dtype=bool)
    n_valid = np.maximum(mask_np.sum(axis=1).astype(np.float64), 1.0)
    mean = np.where(mask_np, samples, 0.0).sum(axis=1) / n_valid
    d = np.where(mask_np, samples - mean[:, None], 0.0)
    var0 = (d * d).sum(axis=1) / n_valid
    scale = np.sqrt(np.maximum(var0, 1e-12))
    z = np.where(mask_np, d / scale[:, None], 0.0).astype(np.float32)

    w, mu_z, sd_z = _fit_gmm_z(torch.as_tensor(z, device=device),
                               torch.as_tensor(mask_np, device=device),
                               max_k=max_k, n_iters=n_iters)
    w = w.cpu().numpy().astype(np.float64)
    mu = mean[:, None] + scale[:, None] * mu_z.cpu().numpy().astype(np.float64)
    sd = np.where(w > 0,
                  np.maximum(scale[:, None]
                             * sd_z.cpu().numpy().astype(np.float64), 1.0),
                  1.0)
    return w, mu, sd


def fit_gmm_in_graph(samples: torch.Tensor, mask: torch.Tensor,
                     prior_w: torch.Tensor, prior_mu: torch.Tensor,
                     prior_sd: torch.Tensor, max_k: int = 5,
                     n_iters: int = 50):
    """BIC-GMM refit that never leaves the device (the fused EM).

    samples/mask: [Ne, n]; prior_*: [Ne, max_k], kept for rows with no
    samples. Rows with 1-3 samples, or no spread, take the closed-form
    single Gaussian (std floor 1e-3); rows with >= 4 samples get the
    BIC-selected EM fit."""
    m = mask.to(samples.dtype)
    n = m.sum(dim=1)                                                 # [Ne]
    n1 = torch.clamp(n, min=1.0)
    mean = (samples * m).sum(dim=1) / n1
    d = (samples - mean[:, None]) * m
    var0 = (d * d).sum(dim=1) / n1
    scale = torch.sqrt(torch.clamp(var0, min=1e-12))
    z = torch.where(mask, d / scale[:, None], torch.zeros_like(d))

    w_z, mu_z, sd_z = _fit_edge_z(z, mask, n1, max_k, n_iters)
    w = w_z
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
    w = torch.where(empty, prior_w, w)
    mu = torch.where(empty, prior_mu, mu)
    sd = torch.where(empty, prior_sd, sd)
    return w, mu, sd
