"""Port ops vs the JAX package's ops on the same numpy inputs (CPU).

Tolerances and why:
- mixture scores: rtol 1e-5, atol 1e-4 — XLA and torch take the
  log-sum-exp over components in different orders; -inf entries (all
  components at weight 0) must match exactly;
- Sinkhorn plans: atol 1e-5, rtol 1e-4 — the row/column log-sum-exps
  over hundreds of entries sum in different orders;
- rounding and top-k fed the SAME plan: exact — they only compare;
- GMM parameters: rtol 1e-3 (atol 1e-3 on weights) — 50 EM iterations
  in f32 over sums taken in different orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from traceweaver_tpu.ops import gmm as jgmm
from traceweaver_tpu.ops import rounding as jround
from traceweaver_tpu.ops import scores as jscores
from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as j_sinkhorn

from traceweaver_tpu_torch.ops import gmm as tgmm
from traceweaver_tpu_torch.ops import rounding as tround
from traceweaver_tpu_torch.ops import scores as tscores
from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log as t_sinkhorn

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

NEG = -1.0e9


def _mixture(rng, K=5, zero_rows=0, n=1):
    w = rng.random((n, K)).astype(np.float32)
    w[:, 3:] = 0.0
    w /= np.maximum(w.sum(-1, keepdims=True), 1e-9)
    w[:zero_rows] = 0.0
    mu = rng.normal(100.0, 50.0, (n, K)).astype(np.float32)
    sd = rng.uniform(5.0, 40.0, (n, K)).astype(np.float32)
    return w, mu, sd


def test_mixture_logpdf_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(100.0, 80.0, (6, 40)).astype(np.float32)
    w, mu, sd = _mixture(rng, n=6, zero_rows=1)
    wb, mub, sdb = (a[:, None, :] for a in (w, mu, sd))
    ref = np.asarray(jscores.mixture_logpdf(jnp.asarray(x), jnp.asarray(wb),
                                            jnp.asarray(mub), jnp.asarray(sdb)))
    got = tscores.mixture_logpdf(torch.as_tensor(x), torch.as_tensor(wb),
                                 torch.as_tensor(mub), torch.as_tensor(sdb)).numpy()
    assert np.array_equal(np.isneginf(ref), np.isneginf(got))
    assert np.isneginf(ref[0]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-4)


def test_pair_scores_matches_jax_batched():
    rng = np.random.default_rng(1)
    B, N, M = 3, 17, 23
    t_prev = rng.uniform(0, 500, (B, N)).astype(np.float32)
    o_s = rng.uniform(0, 700, (B, M)).astype(np.float32)
    w, mu, sd = _mixture(rng, n=B, zero_rows=1)
    got = tscores.pair_scores(torch.as_tensor(t_prev), torch.as_tensor(o_s),
                              torch.as_tensor(w), torch.as_tensor(mu),
                              torch.as_tensor(sd)).numpy()
    for b in range(B):
        ref = np.asarray(jscores.pair_scores(
            jnp.asarray(t_prev[b]), jnp.asarray(o_s[b]), jnp.asarray(w[b]),
            jnp.asarray(mu[b]), jnp.asarray(sd[b])))
        assert np.array_equal(np.isneginf(ref), np.isneginf(got[b]))
        fin = np.isfinite(ref)
        np.testing.assert_allclose(got[b][fin], ref[fin], rtol=1e-5, atol=1e-4)


def _ot_problem(rng, N, M, masked=True):
    S = rng.normal(scale=4.0, size=(N, M)).astype(np.float32)
    r = (rng.random(N) > 0.2).astype(np.float32) if masked else np.ones(N, np.float32)
    c = (rng.random(M) > 0.2).astype(np.float32) if masked else np.ones(M, np.float32)
    # balance the totals through the last row / column
    total = max(r.sum(), c.sum())
    r[-1] += total - r.sum()
    c[-1] += total - c.sum()
    S = np.where((r > 0)[:, None] & (c > 0)[None, :], S, NEG).astype(np.float32)
    return S, r, c


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_sinkhorn_log_matches_jax(tol):
    rng = np.random.default_rng(2)
    probs = [_ot_problem(rng, 19, 27) for _ in range(4)]
    S, r, c = (np.stack(a) for a in zip(*probs))
    got = t_sinkhorn(torch.as_tensor(S), torch.as_tensor(r), torch.as_tensor(c),
                     epsilon=1.0, n_iters=30, tol=tol).numpy()
    for b in range(len(probs)):
        ref = np.asarray(j_sinkhorn(jnp.asarray(S[b]), jnp.asarray(r[b]),
                                    jnp.asarray(c[b]), epsilon=1.0, n_iters=30,
                                    tol=tol))
        np.testing.assert_allclose(got[b], ref, atol=1e-5, rtol=1e-4)


def test_sinkhorn_tol_batch_freezes_each_problem():
    """Batched with tol: each problem equals its own solo run (the easy
    problem freezes while the hard one iterates on)."""
    rng = np.random.default_rng(3)
    easy = _ot_problem(rng, 12, 12, masked=False)
    hard = _ot_problem(rng, 12, 12)
    hard = (hard[0] * 6.0, hard[1], hard[2])
    S, r, c = (np.stack(a) for a in zip(easy, hard))
    kw = dict(epsilon=1.0, n_iters=50, tol=1e-3)
    both = t_sinkhorn(torch.as_tensor(S), torch.as_tensor(r), torch.as_tensor(c), **kw)
    for b in range(2):
        solo = t_sinkhorn(torch.as_tensor(S[b:b + 1]), torch.as_tensor(r[b:b + 1]),
                          torch.as_tensor(c[b:b + 1]), **kw)
        assert torch.equal(both[b], solo[0])
        ref = np.asarray(j_sinkhorn(jnp.asarray(S[b]), jnp.asarray(r[b]),
                                    jnp.asarray(c[b]), **kw))
        np.testing.assert_allclose(both[b].numpy(), ref, atol=1e-5, rtol=1e-4)


def _tie_plans(rng, B, N, C):
    """Plans with deliberate exact ties (quantized masses), a -inf row
    and a row of equal masses."""
    plan = (rng.integers(0, 6, size=(B, N, C)) / 8.0).astype(np.float32)
    plan[:, 1, :] = -np.inf
    plan[:, 2, :] = 0.25
    row_valid = rng.random((B, N)) > 0.15
    col_valid = rng.random((B, C)) > 0.15
    return plan, row_valid, col_valid


@pytest.mark.parametrize("caps", [(0, 0, 0), (1, 1, 1), (0, 1, 7)])
def test_greedy_round_matches_jax_exactly(caps):
    rng = np.random.default_rng(4 + sum(caps))
    B, N, C = 3, 14, 11
    plan, rv, cv = _tie_plans(rng, B, N, C)
    # skip-heavy problem: the skip column dominates several rows
    plan[2, :, -1] = np.linspace(0.9, 0.4, N, dtype=np.float32)
    cap = np.asarray(caps, np.int32)
    got = tround.greedy_round(torch.as_tensor(plan), torch.as_tensor(rv),
                              torch.as_tensor(cv), torch.as_tensor(cap),
                              n_steps=N).numpy()
    for b in range(B):
        ref = np.asarray(jround.greedy_round(
            jnp.asarray(plan[b]), jnp.asarray(rv[b]), jnp.asarray(cv[b]),
            jnp.asarray(cap[b]), n_steps=N))
        assert np.array_equal(got[b], ref), b


def test_greedy_round_batch_equals_solo():
    rng = np.random.default_rng(9)
    plan, rv, cv = _tie_plans(rng, 4, 9, 7)
    cap = np.array([0, 2, 5, 1], np.int32)
    args = [torch.as_tensor(a) for a in (plan, rv, cv, cap)]
    both = tround.greedy_round(*args, n_steps=9)
    for b in range(4):
        solo = tround.greedy_round(*(a[b:b + 1] for a in args), n_steps=9)
        assert torch.equal(both[b], solo[0])


@pytest.mark.parametrize("k", [1, 3, 5])
def test_topk_peel_matches_jax_exactly(k):
    rng = np.random.default_rng(5 + k)
    plan, _, cv = _tie_plans(rng, 3, 10, 8)
    plan[0, 3, :] = -np.inf
    plan[0, 3, 2] = 0.5  # one finite entry, then -inf fallbacks
    x = np.where(cv[:, None, :], plan, NEG).astype(np.float32)
    x[1, 4, :] = -np.inf
    vals, idx = tround.topk_peel(torch.as_tensor(x), k)
    rv, ri = jround.topk_peel(jnp.asarray(x), k)
    assert np.array_equal(idx.numpy(), np.asarray(ri))
    assert np.array_equal(vals.numpy(), np.asarray(rv))


def test_topk_peel_guards():
    x = torch.zeros(2, 4)
    with pytest.raises(ValueError):
        tround.topk_peel(x, 5)
    with pytest.raises(TypeError):
        tround.topk_peel(torch.zeros(2, 4, dtype=torch.int32), 2)
    assert tround.topk_peel(x, 0)[1].shape == (2, 0)


def _gmm_samples(rng):
    """Well-separated mixtures (one, two and three components), a short
    row and an empty row."""
    n = 256
    rows = [rng.normal(500.0, 20.0, n),
            np.concatenate([rng.normal(100.0, 5.0, n // 2),
                            rng.normal(400.0, 8.0, n // 2)]),
            np.concatenate([rng.normal(0.0, 3.0, 86), rng.normal(200.0, 4.0, 85),
                            rng.normal(900.0, 6.0, 85)])]
    x = np.zeros((5, n), np.float64)
    mask = np.zeros((5, n), bool)
    for i, r in enumerate(rows):
        x[i, :len(r)] = r
        mask[i, :len(r)] = True
    x[3, :3] = [10.0, 12.0, 11.0]
    mask[3, :3] = True
    return x, mask


def _sorted_params(w, mu, sd):
    order = np.argsort(np.where(w > 0, mu, np.inf), axis=1, kind="stable")
    return (np.take_along_axis(a, order, 1) for a in (w, mu, sd))


def test_fit_gmm_batched_matches_jax():
    x, mask = _gmm_samples(np.random.default_rng(6))
    x, mask = x[:3], mask[:3]
    got = tgmm.fit_gmm_batched(x, mask, max_k=5, device="cpu")
    ref = [np.asarray(a) for a in jgmm.fit_gmm_batched(x, mask, max_k=5)]
    assert np.array_equal(got[0] > 0, ref[0] > 0)  # same component counts
    g, r = _sorted_params(*got), _sorted_params(*ref)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)


def test_fit_gmm_in_graph_matches_jax():
    x, mask = _gmm_samples(np.random.default_rng(7))
    x32 = x.astype(np.float32)
    K = 5
    prior = [np.random.default_rng(8).random((5, K)).astype(np.float32)
             for _ in range(3)]
    got = [a.numpy() for a in tgmm.fit_gmm_in_graph(
        torch.as_tensor(x32), torch.as_tensor(mask),
        *(torch.as_tensor(p) for p in prior), max_k=K)]
    ref = [np.asarray(a) for a in jgmm.fit_gmm_in_graph(
        jnp.asarray(x32), jnp.asarray(mask), *(jnp.asarray(p) for p in prior),
        max_k=K)]
    # empty row keeps the prior exactly; the 3-sample row is closed form
    for a in got:
        assert np.isfinite(a).all()
    for a, p in zip(got, prior):
        assert np.array_equal(a[4], p[4])
    assert np.array_equal(got[0] > 0, ref[0] > 0)
    g, r = _sorted_params(*got), _sorted_params(*ref)
    for a, b in zip(g, r):
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-3)
