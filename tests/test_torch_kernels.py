"""The kernels' dispatchers vs the JAX Pallas kernels (interpret mode) and
the JAX jnp composition, on the geometries of tests/test_fused_kernel.py.

On CPU tensors the port's ``assign_topk``/``sinkhorn`` run the plain
versions. Expected: exact ``assign``/``topk`` equality with both JAX
paths; a row may differ only where the test finds a near tie in the
JAX plan (top-2 masses within 1e-5 relative), since XLA and torch sum
the log-sum-exps in different orders. Plans: atol 1e-5, rtol 1e-4.

Tests marked ``gpu`` hold the CUDA kernels against the plain versions on
the card and skip without one. They need no JAX, so they also run where
JAX is not installed (the JAX package's conftest then has to stay out):

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_kernels.py
"""

from functools import partial
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

NEG = -1.0e9
REL_TIE = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's kernels and compositions (CPU, interpret mode)."""
    import jax
    import jax.numpy as jnp

    from traceweaver_tpu.ops import pallas_sinkhorn as ps
    from traceweaver_tpu.ops.sinkhorn import sinkhorn_log

    jax.config.update("jax_platforms", "cpu")
    return SimpleNamespace(jax=jax, jnp=jnp, assign_topk_jnp=ps.assign_topk_jnp,
                           fused_assign_pallas=ps.fused_assign_pallas,
                           sinkhorn_log_pallas=ps.sinkhorn_log_pallas,
                           sinkhorn=sinkhorn_log)


def _random_block(rng, W, M, all_masked_cols=False, some_invalid_rows=True):
    """tests/test_fused_kernel.py's block: [W+1, M+1] scores, marginals,
    validity masks, skip capacity."""
    S = rng.normal(scale=5.0, size=(W + 1, M + 1)).astype(np.float32)
    in_v = (rng.random(W) > 0.25) if some_invalid_rows else np.ones(W, bool)
    if not in_v.any():
        in_v[0] = True
    o_v = np.zeros(M, bool) if all_masked_cols else rng.random(M) > 0.25
    cap = float(rng.integers(0, 4))
    n_rows = float(in_v.sum())
    n_cols = float(o_v.sum())
    cap_e = max(cap, max(n_rows - n_cols, 0.0))
    row_marg = np.concatenate(
        [in_v.astype(np.float32),
         [max(n_cols + cap_e - n_rows, 0.0)]]).astype(np.float32)
    col_marg = np.concatenate([o_v.astype(np.float32), [cap_e]]).astype(np.float32)
    col_valid = np.concatenate([o_v, [cap_e > 0]])
    S = np.where(np.concatenate([in_v, [True]])[:, None]
                 & col_valid[None, :], S, NEG).astype(np.float32)
    return S, row_marg, col_marg, in_v, col_valid, np.float32(cap_e)


def _port(blocks, W, **kw):
    S, rm, cm, in_v, cv, cap = (torch.as_tensor(np.stack(a)) for a in zip(*blocks))
    a, tk = K.assign_topk(S, rm, cm, in_v, cv, cap, W, **kw)
    return a.numpy(), tk.numpy()


def _near_tie_rows(plan, rows):
    """Rows whose two largest plan masses are within REL_TIE."""
    top = np.sort(plan[rows], axis=-1)[:, ::-1]
    return np.abs(top[:, 0] - top[:, 1]) <= REL_TIE * np.maximum(top[:, 0], 1e-30)


def _assert_same(a, tk, a_ref, tk_ref, plan, what):
    diff = np.flatnonzero((a != a_ref) | (tk != tk_ref).any(-1))
    assert _near_tie_rows(plan, diff).all(), (what, diff)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_assign_topk_matches_jax_randomized(tol, jx):
    jnp = jx.jnp
    rng = np.random.default_rng(7)
    kw = dict(epsilon=1.0, n_iters=40, tol=tol, topk=5, min_topk_mass=1e-3)
    for trial in range(12):
        W = int(rng.integers(3, 24))
        M = int(rng.integers(6, 48))
        blk = _random_block(rng, W, M)
        S, rm, cm, in_v, cv, cap = blk
        j = [jnp.asarray(x) for x in blk]
        a_ref, tk_ref = (np.asarray(x) for x in jx.assign_topk_jnp(*j, W, **kw))
        a_pal, tk_pal = (np.asarray(x) for x in jx.fused_assign_pallas(
            j[0], j[1], j[2], j[5], W, interpret=True, **kw))
        a, tk = _port([blk], W, **kw)
        plan = np.asarray(jx.sinkhorn(j[0], j[1], j[2], epsilon=1.0,
                                      n_iters=40, tol=tol))[:W]
        _assert_same(a[0], tk[0], a_ref, tk_ref, plan, f"jnp trial {trial}")
        _assert_same(a[0], tk[0], a_pal, tk_pal, plan, f"pallas trial {trial}")


@pytest.mark.parametrize("cap_zero", [False, True])
def test_assign_topk_all_masked_endpoint(cap_zero, jx):
    jnp = jx.jnp
    rng = np.random.default_rng(3)
    W, M = 9, 12
    S, rm, cm, in_v, cv, cap = _random_block(rng, W, M, all_masked_cols=True)
    if cap_zero:
        cm[-1] = 0.0
        cv[-1] = False
        cap = np.float32(0.0)
    kw = dict(epsilon=1.0, n_iters=30, tol=0.0, topk=4, min_topk_mass=1e-3)
    blk = (S, rm, cm, in_v, cv, cap)
    a_ref, tk_ref = (np.asarray(x) for x in
                     jx.assign_topk_jnp(*(jnp.asarray(x) for x in blk), W, **kw))
    a, tk = _port([blk], W, **kw)
    assert np.array_equal(a[0], a_ref) and np.array_equal(tk[0], tk_ref)
    if cap_zero:
        assert (a == -1).all() and (tk == -1).all()


def test_assign_topk_batched_matches_per_window(jx):
    """One batched call equals each window's solo solve and the JAX
    vmapped interpret-mode kernel."""
    jnp = jx.jnp
    rng = np.random.default_rng(11)
    B, W, M = 5, 8, 10
    blocks = [_random_block(rng, W, M) for _ in range(B)]
    kw = dict(epsilon=1.0, n_iters=30, tol=1e-3, topk=3, min_topk_mass=1e-3)
    a, tk = _port(blocks, W, **kw)
    run = jx.jax.vmap(partial(jx.fused_assign_pallas, n_rows=W, interpret=True, **kw))
    stack = [jnp.asarray(np.stack(x)) for x in zip(*blocks)]
    a_pal, tk_pal = (np.asarray(x) for x in run(stack[0], stack[1], stack[2],
                                                stack[5]))
    for b, blk in enumerate(blocks):
        a1, tk1 = _port([blk], W, **kw)
        assert np.array_equal(a[b], a1[0]) and np.array_equal(tk[b], tk1[0])
        plan = np.asarray(jx.sinkhorn(*(jnp.asarray(x) for x in blk[:3]),
                                      epsilon=1.0, n_iters=30, tol=1e-3))[:W]
        _assert_same(a[b], tk[b], a_pal[b], tk_pal[b], plan, f"window {b}")


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_sinkhorn_matches_pallas_interpret(tol, jx):
    jnp = jx.jnp
    rng = np.random.default_rng(5)
    blocks = [_random_block(rng, 13, 21) for _ in range(3)]
    S, rm, cm = (np.stack(a) for a in list(zip(*blocks))[:3])
    got = K.sinkhorn(torch.as_tensor(S), torch.as_tensor(rm), torch.as_tensor(cm),
                     epsilon=1.0, n_iters=30, tol=tol).numpy()
    for b in range(3):
        ref = np.asarray(jx.sinkhorn_log_pallas(jnp.asarray(S[b]), jnp.asarray(rm[b]),
                                                jnp.asarray(cm[b]), epsilon=1.0,
                                                n_iters=30, tol=tol, interpret=True))
        np.testing.assert_allclose(got[b], ref, atol=1e-5, rtol=1e-4)


def test_wrappers_refuse_cpu_tensors_and_oversized_blocks():
    """A kernel wrapper never computes on the CPU: it raises; the shared
    memory limit is stated in the error."""
    S = torch.zeros(1, 4, 5)
    rm, cm, cap = torch.ones(1, 4), torch.ones(1, 5), torch.zeros(1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_assign_cuda(S, rm, cm, cap, 3, epsilon=1.0, n_iters=2, tol=0.0,
                            topk=2, min_topk_mass=1e-3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.sinkhorn_cuda(S, rm, cm, epsilon=1.0, n_iters=2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.round_topk_cuda(S, torch.ones(1, 4, dtype=torch.bool),
                          torch.ones(1, 5, dtype=torch.bool), cap, topk=2,
                          min_topk_mass=1e-3)
    K._check_block(1025, 2049)  # the main-path block fits
    K._check_block(4097, 8193)   # 1-row tiles at the widest blocks
    with pytest.raises(ValueError, match="shared memory"):
        K._check_block(8193, 16385)
    with pytest.raises(ValueError, match="shared memory"):
        K.launch_plan(8, 8193, 16385, large_clusters=16)


@pytest.mark.parametrize("B, R, C, large", [
    (8, 1025, 2049, 7),   # main path: 16-CTA clusters do not all fit
    (7, 1025, 2049, 7),
    (1, 1025, 2049, 7),
    (40, 257, 513, 7),    # more clusters than the card runs at once
    (3, 5, 21, 7),        # fewer rows than CTAs in a cluster
    (4, 101, 301, 0),     # rows not a multiple of the cluster size
    (2, 1025, 4097, 7),   # 4-row tiles
    (1, 4097, 8193, 7),   # 1-row tiles
])
def test_launch_plan_owns_every_row_once_and_fits(B, R, C, large):
    """The CPU half of the kernels' launch: the cluster size, the row
    stripes and the shared-memory bytes."""
    plan = K.launch_plan(B, R, C, large)
    assert plan.cluster == (K.CLUSTER_LARGE if large >= B else K.CLUSTER_SMALL)
    owned = [i for lo, hi in plan.stripes(R) for i in range(lo, hi)]
    assert owned == list(range(R))
    assert plan.smem_bytes == K.smem_bytes(R, C, plan.cluster, plan.tile_rows)
    assert plan.smem_bytes <= K.MAX_SMEM_BYTES
    bigger = [t for t in K.TILE_ROWS if t > plan.tile_rows]
    assert all(K.smem_bytes(R, C, plan.cluster, t) > K.MAX_SMEM_BYTES for t in bigger)
    # K1 and K2 see [R, C]; round_topk sees the same block without the
    # dummy row: one cluster size for all three
    assert K.launch_plan(B, R, C, large) == plan
    if R > 1:
        assert K.launch_plan(B, R - 1, C, large).cluster == plan.cluster


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_blocks(rng, B, W, M, **kw):
    blocks = [_random_block(rng, W, M, **kw) for _ in range(B)]
    return [torch.as_tensor(np.stack(a)).cuda() for a in zip(*blocks)]


@pytest.mark.gpu
@pytest.mark.parametrize("tol", [0.0, 1e-3])
@pytest.mark.parametrize("shape", [(3, 36, 52), (4, 64, 128), (2, 255, 511)])
def test_kernels_match_plain_on_card(card, tol, shape):
    """K2 plan allclose to the plain plan; K1 == K2 plan + the kernel's
    rounding (bit for bit); the kernel's rounding == the plain rounding
    on the same plan; K1 == the plain composition up to near ties."""
    S, rm, cm, in_v, cv, cap = _cuda_blocks(np.random.default_rng(sum(shape)), *shape)
    W = shape[1]
    kw = dict(epsilon=1.0, n_iters=40, tol=tol)
    rk = dict(topk=5, min_topk_mass=1e-3)
    plan_k = K.sinkhorn_cuda(S, rm, cm, **kw)
    plan_p = K.sinkhorn_log(S, rm, cm, **kw)
    torch.testing.assert_close(plan_k, plan_p, atol=1e-5, rtol=1e-4)
    a_k, tk_k = K.fused_assign_cuda(S, rm, cm, cap, W, **kw, **rk)
    a_r, tk_r = K.round_topk_cuda(plan_k[:, :W].contiguous(), in_v, cv, cap, **rk)
    assert torch.equal(a_k, a_r) and torch.equal(tk_k, tk_r)
    pp = plan_p[:, :W].contiguous()
    a_c, tk_c = K.round_topk_cuda(pp, in_v, cv, cap, **rk)
    a_p, tk_p = K.round_topk_plain(pp, in_v, cv, cap, **rk)
    assert torch.equal(a_c, a_p) and torch.equal(tk_c, tk_p)
    a_f, tk_f = K.assign_topk_plain(S, rm, cm, in_v, cv, cap, W, **kw, **rk)
    plan = pp.cpu().numpy()
    for b in range(shape[0]):
        _assert_same(a_k[b].cpu().numpy(), tk_k[b].cpu().numpy(),
                     a_f[b].cpu().numpy(), tk_f[b].cpu().numpy(), plan[b], b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, tol, n_iters", [
    ((4, 100, 300), 1e-3, 40),    # rows not a multiple of the cluster size
    ((3, 4, 20), 0.0, 40),        # fewer rows than CTAs in a cluster
    ((1, 1024, 2048), 1e-3, 40),  # one window
    ((40, 256, 512), 1e-3, 40),   # more clusters than the card runs at once
    ((3, 100, 200), 1e-2, 200),   # the tolerance ends every block early
    ((1, 512, 8192), 1e-3, 40),   # 1-row tiles
])
def test_cluster_edges_on_card(card, shape, tol, n_iters):
    """K2 allclose to the plain plan, K1 == K2's plan + round_topk bit for
    bit, round_topk == the plain rounding, at the edges of the cluster
    decomposition; K1 and K2 stop after the same iterations."""
    S, rm, cm, in_v, cv, cap = _cuda_blocks(np.random.default_rng(sum(shape)), *shape)
    W = shape[1]
    kw = dict(epsilon=1.0, n_iters=n_iters, tol=tol)
    rk = dict(topk=5, min_topk_mass=1e-3)
    plan_k, iters = K.sinkhorn_cuda(S, rm, cm, return_iters=True, **kw)
    torch.testing.assert_close(plan_k, K.sinkhorn_log(S, rm, cm, **kw),
                               atol=1e-5, rtol=1e-4)
    if n_iters == 200:
        assert bool((iters < n_iters).all()), iters
    a_k, tk_k, stats = K.fused_assign_cuda(S, rm, cm, cap, W, return_stats=True,
                                           **kw, **rk)
    assert torch.equal(stats[:, 0], iters)
    a_r, tk_r = K.round_topk_cuda(plan_k[:, :W].contiguous(), in_v, cv, cap, **rk)
    assert torch.equal(a_k, a_r) and torch.equal(tk_k, tk_r)
    a_p, tk_p = K.round_topk_plain(plan_k[:, :W].contiguous(), in_v, cv, cap, **rk)
    assert torch.equal(a_r, a_p) and torch.equal(tk_r, tk_p)


@pytest.mark.gpu
@pytest.mark.parametrize("lift", ["row", "column", "both"])
def test_lifted_potentials_follow_plain_on_card(card, lift):
    """A live row (or column) whose every entry is masked lifts its
    potential to about 1e9, where the masked entries of its row (column)
    come out of the f32 sums as values of order 64 (a stream window's
    tail rows and head columns): K2's plan still equals the plain
    version's within the usual tolerance, and K1 equals the plain
    composition up to near ties, as both form S + potential in natural
    units and subtract the max before the exponential."""
    rng = np.random.default_rng({"row": 3, "column": 4, "both": 5}[lift])
    blocks = [list(_random_block(rng, 64, 128, some_invalid_rows=False)) for _ in range(3)]
    for S, rm, cm, in_v, cv, cap in blocks:
        if lift in ("row", "both"):
            S[7, :] = NEG
        if lift in ("column", "both"):
            live = np.flatnonzero(cm[:-1] > 0)
            S[:, live[3]] = NEG
    S, rm, cm, in_v, cv, cap = (torch.as_tensor(np.stack(a)).cuda() for a in zip(*blocks))
    W = 64
    kw = dict(epsilon=1.0, n_iters=40, tol=1e-3)
    rk = dict(topk=5, min_topk_mass=1e-3)
    plan_p = K.sinkhorn_log(S, rm, cm, **kw)
    assert float(plan_p.sum()) > 0
    torch.testing.assert_close(K.sinkhorn_cuda(S, rm, cm, **kw), plan_p,
                               atol=1e-5, rtol=1e-4)
    a_k, tk_k = K.fused_assign_cuda(S, rm, cm, cap, W, **kw, **rk)
    a_f, tk_f = K.assign_topk_plain(S, rm, cm, in_v, cv, cap, W, **kw, **rk)
    plan = plan_p[:, :W].cpu().numpy()
    for b in range(3):
        _assert_same(a_k[b].cpu().numpy(), tk_k[b].cpu().numpy(),
                     a_f[b].cpu().numpy(), tk_f[b].cpu().numpy(), plan[b], b)


@pytest.mark.gpu
def test_all_masked_and_launch_counts_on_card(card):
    S, rm, cm, in_v, cv, cap = _cuda_blocks(np.random.default_rng(1), 2, 9, 12,
                                            all_masked_cols=True)
    before = dict(K.LAUNCHES)
    a, tk = K.assign_topk(S, rm, cm, in_v, cv, cap, 9, epsilon=1.0, n_iters=30,
                          tol=0.0, topk=4, min_topk_mass=1e-3)
    assert K.LAUNCHES["fused_assign"] == before["fused_assign"] + 1
    a_p, tk_p = K.assign_topk_plain(S, rm, cm, in_v, cv, cap, 9, epsilon=1.0,
                                    n_iters=30, tol=0.0, topk=4, min_topk_mass=1e-3)
    assert torch.equal(a, a_p) and torch.equal(tk, tk_p)
    K.assign_topk(S, rm, cm, in_v, cv, cap, 9, epsilon=1.0, n_iters=30, tol=0.0,
                  topk=4, min_topk_mass=1e-3, fused=False)
    assert K.LAUNCHES["sinkhorn"] == before["sinkhorn"] + 1


@pytest.mark.gpu
def test_launches_from_two_threads_with_different_shapes_on_card(card):
    """The fleet's flow workers launch from several threads at once, each
    on its own stream, with blocks of different shapes (so different
    shared-memory limits, a per-kernel attribute): every output equals
    the same launch made alone."""
    import threading

    rng = np.random.default_rng(11)
    blocks = [_cuda_blocks(rng, *shape) for shape in ((2, 255, 511), (3, 36, 52))]
    kw = dict(epsilon=1.0, n_iters=40, tol=1e-3, topk=5, min_topk_mass=1e-3)

    def k1(block):
        S, rm, cm, _, _, cap = block
        return K.fused_assign_cuda(S, rm, cm, cap, S.shape[1] - 1, **kw)

    alone = [k1(b) for b in blocks]
    torch.cuda.synchronize()
    got, errors = [[], []], []

    def worker(i):
        try:
            with torch.cuda.stream(torch.cuda.Stream()):
                for _ in range(40):
                    got[i].append(k1(blocks[i]))
                torch.cuda.current_stream().synchronize()
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for i in range(2):
        assert len(got[i]) == 40
        for a, tk in got[i]:
            assert torch.equal(a, alone[i][0]) and torch.equal(tk, alone[i][1])
