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
  closed-form single Gaussian for rows with fewer than 4 samples;
- :func:`fit_gmm_sharded` fits rows whose samples are sharded over a
  mesh, every moment sum added over the shards on the mesh's first
  device (the JAX package's ``psum``).

Component stds are floored at 1 µs after the back-transform.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

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


def fit_gmm_sharded(samples: Sequence[torch.Tensor], mask: Sequence[torch.Tensor],
                    device, max_k: int = 5, n_iters: int = 50):
    """BIC-selected GMM fit with the sample axis sharded over a mesh (JAX
    ``fit_gmm_sharded``, the distributed M-step).

    ``samples`` and ``mask`` hold one ``[Ne, n_local]`` tensor a shard
    (f32 and bool, each on its shard's device). Responsibilities are
    computed per shard; every moment sum the JAX package reduces with
    ``psum`` (``n``, the mean and variance sums, ``n_j``, ``Σ r z``,
    ``Σ r z²``, the log-likelihood) is each shard's partial sum, moved
    to ``device`` (the mesh's first) and added there in shard order, and
    the parameters every shard uses next come from that one sum. Returns
    ``(w, mu, sd)``, each ``[Ne, max_k]`` on ``device``, in the sample
    domain with the 1 µs std floor.

    The JAX package's two deliberate departures from the single-device
    fit stay: the means start at fixed z-space offsets (global quantiles
    would need a distributed sort), and the standardization runs in f32
    on the reduced moments. So this equals the JAX package's sharded fit,
    not its batched one."""
    device = torch.device(device)

    def psum(parts):
        out = parts[0].to(device)
        for p in parts[1:]:
            out = out + p.to(device)
        return out

    def on_shards(t):
        placed = {}
        return [placed.setdefault(x.device, t.to(x.device)) for x in samples]

    ms = [m.to(x.dtype) for x, m in zip(samples, mask)]
    ne = samples[0].shape[0]
    dtype = samples[0].dtype
    n = torch.clamp(psum([m.sum(dim=1) for m in ms]), min=1.0)            # [Ne]
    mean = psum([(x * m).sum(dim=1) for x, m in zip(samples, ms)]) / n
    mean_s = on_shards(mean)
    ds = [(x - mu[:, None]) * m for x, mu, m in zip(samples, mean_s, ms)]
    var0 = psum([(d * d).sum(dim=1) for d in ds]) / n
    scale = torch.sqrt(torch.clamp(var0, min=1e-12))
    zs = [torch.where(mk, (x - mu[:, None]) / sc[:, None], torch.zeros_like(x))
          for x, mk, mu, sc in zip(samples, mask, mean_s, on_shards(scale))]

    def log_comp(z, w, mu, var):
        dd = z[:, :, None] - mu[:, None, :]                               # [Ne, n, k]
        return (-0.5 * dd * dd / var[:, None, :]
                - 0.5 * torch.log(var)[:, None, :]
                - 0.5 * LOG_2PI
                + torch.log(torch.clamp(w, min=1e-30))[:, None, :])

    outs = []
    for k in range(1, max_k + 1):
        # fixed spread init in z-space (z is standardized: mean 0, var 1)
        qs = (torch.arange(k, dtype=dtype, device=device) + 0.5) / k
        mu = (3.0 * (qs - 0.5)).expand(ne, k).contiguous()
        var = torch.ones(ne, k, dtype=dtype, device=device)
        w = torch.full((ne, k), 1.0 / k, dtype=dtype, device=device)
        for _ in range(n_iters):
            resp = [torch.softmax(log_comp(z, ws, mus, vs), dim=2) * m[:, :, None]
                    for z, m, ws, mus, vs in zip(zs, ms, on_shards(w), on_shards(mu),
                                                 on_shards(var))]
            nj = torch.clamp(psum([r.sum(dim=1) for r in resp]), min=1e-6)  # [Ne, k]
            w = nj / n[:, None]
            mu = psum([(r * z[:, :, None]).sum(dim=1) for r, z in zip(resp, zs)]) / nj
            s2 = psum([(r * z[:, :, None] ** 2).sum(dim=1)
                       for r, z in zip(resp, zs)]) / nj
            var = torch.clamp(s2 - mu * mu, min=1e-6)
        ll = psum([torch.where(mk, torch.logsumexp(log_comp(z, ws, mus, vs), dim=2),
                               torch.zeros_like(z)).sum(dim=1)
                   for z, mk, ws, mus, vs in zip(zs, mask, on_shards(w), on_shards(mu),
                                                 on_shards(var))])
        p = 3 * k - 1
        bic = torch.where(n >= k, -2.0 * ll + p * torch.log(n),
                          torch.full_like(n, math.inf))
        pad = max_k - k
        outs.append((bic, F.pad(w, (0, pad)), F.pad(mu, (0, pad)),
                     F.pad(torch.sqrt(var), (0, pad), value=1.0)))

    best = torch.argmin(torch.stack([o[0] for o in outs]), dim=0)          # [Ne]

    def pick(i):
        stacked = torch.stack([o[i] for o in outs])                        # [K, Ne, max_k]
        return torch.gather(stacked, 0, best[None, :, None].expand(1, ne, max_k))[0]

    w, mu_z, sd_z = pick(1), pick(2), pick(3)
    mu_out = mean[:, None] + scale[:, None] * mu_z
    sd_out = torch.where(w > 0, torch.clamp(scale[:, None] * sd_z, min=1.0),
                         torch.ones_like(sd_z))
    return w, mu_out, sd_out


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
