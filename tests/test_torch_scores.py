"""The port's score build against the JAX package's (CPU).

- the GEMM form (``mixture_logpdf_gemm``) against JAX's, in f32 and with
  a bf16 result, within the tolerance tests/test_ops.py:26 holds JAX's
  GEMM to the elementwise form (rtol 1e-3, atol 1e-2);
- per-window mixture rows ([B, 1, 1, K]) give each window's 1-D result;
- the block assembly takes its plain version on the CPU, whose score
  block sums the terms in the JAX solver's grouping, the kernel's
  wrapper refuses CPU tensors, and each term orients its delay as
  ``pair_scores`` and the solver's successor and return terms do;
- the solver with ``score_gemm`` against JAX at ``TW_SCORE_GEMM=1``:
  >= 99% equal assignments.

The assembly kernel's own tests, on the CPU and on the card, are in
tests/test_torch_block.py.
"""

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.ops import scores as ts

torch.set_num_threads(1)  # small tensors; the test workers share the cores

GEMM_TOL = dict(rtol=1e-3, atol=1e-2)


@pytest.fixture(scope="module")
def jscores():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.ops import scores

    return scores


def _mixtures(rng, n, K=5, scale=1.0):
    w = rng.uniform(0.1, 1.0, (n, K)).astype(np.float32)
    w[:, K - 2:] *= rng.random((n, 2)) < 0.5          # some padded components
    w /= w.sum(1, keepdims=True)
    mu = (rng.uniform(5.0, 60.0, (n, K)) * scale).astype(np.float32)
    sd = (rng.uniform(1.0, 15.0, (n, K)) * scale).astype(np.float32)
    return w, mu, sd


@pytest.mark.parametrize("case", ["delay-scale", "random"])
def test_gemm_matches_jax(case, jscores):
    import jax.numpy as jnp

    if case == "delay-scale":
        # tests/test_ops.py's matched-candidate regimes
        cases = [(np.array([5.0e5, 5.001e5, 4.999e5], np.float32),
                  np.array([1.0, 0.0, 0.0], np.float32),
                  np.array([5.001e5, 0.0, 0.0], np.float32),
                  np.array([50.0, 1.0, 1.0], np.float32)),
                 (np.array([1.0e6, 1.0001e6], np.float32),
                  np.array([0.4, 0.6, 0.0], np.float32),
                  np.array([1.0001e6, 1.00005e6, 0.0], np.float32),
                  np.array([20.0, 80.0, 1.0], np.float32))]
    else:
        rng = np.random.default_rng(0)
        cases = []
        for _ in range(4):
            w, mu, sd = _mixtures(rng, 1)
            cases.append((rng.normal(30.0, 25.0, (13, 17)).astype(np.float32),
                          w[0], mu[0], sd[0]))
    for x, w, mu, sd in cases:
        ref = np.asarray(jscores.mixture_logpdf_gemm(*map(jnp.asarray, (x, w, mu, sd))))
        elem = np.asarray(jscores.mixture_logpdf(*map(jnp.asarray, (x, w, mu, sd))))
        got = ts.mixture_logpdf_gemm(*map(torch.as_tensor, (x, w, mu, sd)))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), ref, **GEMM_TOL)
        np.testing.assert_allclose(got.numpy(), elem, **GEMM_TOL)


def test_gemm_bf16_result_matches_jax(jscores):
    """bf16 operands, f32 accumulation, bf16 result: within one bf16
    rounding of JAX's and within test_precision.py's 0.5 of the f32
    elementwise form."""
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    x = rng.normal(10.0, 20.0, (13, 17)).astype(np.float32)
    w = np.array([0.5, 0.3, 0.2], np.float32)
    mu = np.array([8.0, 15.0, 30.0], np.float32)
    sd = np.array([2.0, 5.0, 9.0], np.float32)
    ref = np.asarray(jscores.mixture_logpdf_gemm(*map(jnp.asarray, (x, w, mu, sd)),
                                                 out_dtype=jnp.bfloat16), np.float32)
    elem = np.asarray(jscores.mixture_logpdf(*map(jnp.asarray, (x, w, mu, sd))))
    got = ts.mixture_logpdf_gemm(*map(torch.as_tensor, (x, w, mu, sd)),
                                 out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.abs(got - elem).max() < 0.5
    # one bf16 ulp of the value (8 mantissa bits)
    assert np.all(np.abs(got - ref) <= np.abs(ref) * 2.0 ** -7 + 1e-6)


def test_gemm_per_window_rows_match_one_window_at_a_time():
    rng = np.random.default_rng(1)
    B, N, M = 3, 6, 9
    w, mu, sd = (torch.as_tensor(a) for a in _mixtures(rng, B))
    x = torch.as_tensor(rng.normal(30.0, 20.0, (B, N, M)).astype(np.float32))
    batched = ts.mixture_logpdf_gemm(x, w[:, None, None, :], mu[:, None, None, :],
                                     sd[:, None, None, :])
    for b in range(B):
        assert torch.equal(batched[b], ts.mixture_logpdf_gemm(x[b], w[b], mu[b], sd[b]))


def _terms(rng, B=3, N=7, M=11, K=5):
    def term(flip=False, row_ok=False):
        w, mu, sd = (torch.as_tensor(a) for a in _mixtures(rng, B, K))
        row_t = torch.as_tensor(rng.uniform(0.0, 100.0, (B, N)).astype(np.float32))
        col_t = torch.as_tensor(rng.uniform(0.0, 200.0, (B, M)).astype(np.float32))
        active = torch.as_tensor(rng.random(B) < 0.7)
        ok = torch.as_tensor(rng.random((B, N)) < 0.6) if row_ok else None
        return ts.MixtureTerm(row_t, col_t, w, mu, sd, active, row_ok=ok, flip=flip)

    return term(), [term(), term()], [term(flip=True, row_ok=True)], term(flip=True)


def test_score_terms_orient_the_delay_as_the_solver():
    rng = np.random.default_rng(2)
    root, preds, succs, ret = _terms(rng)
    zero = torch.zeros(())
    want = torch.where(root.active[:, None, None],
                       ts.pair_scores(root.row_t, root.col_t, root.wt, root.mu, root.sd),
                       zero)
    assert torch.equal(root.values(), want)
    t = succs[0]
    delta = t.row_t[:, :, None] - t.col_t[:, None, :]
    want = torch.where(t.active[:, None, None] & t.row_ok[:, :, None],
                       ts.mixture_logpdf(delta, *(p[:, None, None, :]
                                                  for p in (t.wt, t.mu, t.sd))), zero)
    assert torch.equal(t.values(), want)


def test_score_block_takes_the_plain_version_on_the_cpu(monkeypatch):
    """On the CPU the assembled block holds the plain score build, the
    terms summed in the JAX solver's grouping, and the kernel's wrapper
    refuses CPU tensors."""
    rng = np.random.default_rng(4)
    root, preds, succs, ret = _terms(rng)
    B, N = root.row_t.shape
    M = root.col_t.shape[1]
    o_s, o_e = root.col_t, succs[0].col_t
    for t in preds:
        t.col_t = o_s
    ret.col_t = o_e
    # every pair feasible: the block is the score build itself
    wide, valid = torch.full((B, N), 1e6), torch.ones(B, N, dtype=torch.bool)
    args = (root, preds, succs, ret, -wide, wide, valid, o_s, o_e,
            torch.ones(B, M, dtype=torch.bool), -wide, None, ~valid)

    def refuse(*a, **kw):
        raise AssertionError("the kernel wrapper was called on the CPU")

    monkeypatch.setattr(ts, "assemble_block_cuda", refuse)
    before = dict(ts.LAUNCHES)
    S_ot, feas, _ = ts.assemble_block(*args)
    assert ts.LAUNCHES == before
    assert torch.equal(feas, torch.full((B, N), M, dtype=torch.int32))
    want = (root.values() + (preds[0].values() + preds[1].values())
            + succs[0].values() + ret.values())
    assert torch.equal(ts.score_block_plain(root, preds, succs, ret), want)
    assert torch.equal(S_ot[:, :N, :M], want)
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA tensors"):
        ts.assemble_block_cuda(*args)


def test_solver_with_score_gemm_matches_jax(monkeypatch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    from test_precision import _consistent_problem

    from traceweaver_tpu.algorithms import weaver_tpu as jw

    monkeypatch.setenv("TW_SCORE_GEMM", "1")
    jax.clear_caches()  # the knob is read when the program is traced
    rng = np.random.default_rng(5)
    kw = dict(n_sinkhorn=20, n_sweeps=3, sinkhorn_tol=1e-3)
    total = agree = 0
    for _ in range(2):
        args = _consistent_problem(rng, B=2, E=2, W=20, M=20)
        got = tw.solve_windows(*(torch.as_tensor(np.asarray(a)) for a in args),
                               score_gemm=True, **kw)[0].numpy()
        ref = np.asarray(jw.solve_windows(*args, **kw)[0])
        total += got.size
        agree += int((got == ref).sum())
    jax.clear_caches()
    assert agree / total >= 0.99, (agree, total)
