"""The port's bf16 score path against the JAX package's (CPU), mirroring
tests/test_precision.py.

- the precision spec, its aliases and ``score_itemsize``;
- the centred bf16 block (``Sfull``) of every OT call equals JAX's bit
  for bit on seeded well-posed windows;
- bf16 Sinkhorn plans are f32, within 0.05 of the f32 plan (the bound
  of test_precision.py:238) and close to JAX's bf16 plan;
- masked rows, forced skips and an all-masked endpoint assign exactly as
  under f32;
- the solver and the fleet at bf16 against JAX at ``TW_PRECISION=bf16``:
  >= 99% equal assignments and accuracy within 0.5 pt (test_precision.py:348
  holds bf16 to f32 at 0.95 agreement);
- the fleet's group costs count 2 bytes a score element, as JAX's do.

A ``gpu`` test holds K1 and K2 on bf16 blocks against their plain
versions on the card.
"""

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
from traceweaver_tpu_torch.ops.precision import (
    score_dtype,
    score_itemsize,
    validate_precision,
)
from traceweaver_tpu_torch.ops.sinkhorn import sinkhorn_log

torch.set_num_threads(1)  # small tensors; the test workers share the cores


@pytest.fixture(scope="module")
def jx():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.algorithms import weaver_tpu

    return weaver_tpu


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

def test_precision_spec_normalization_and_errors():
    assert validate_precision("f32") == "f32"
    assert validate_precision("FP32") == "f32"
    assert validate_precision(" float32 ") == "f32"
    assert validate_precision("") == "f32"
    assert validate_precision("bf16") == "bf16"
    assert validate_precision("BFLOAT16") == "bf16"
    for bad in ("bf61", "fp16", "f64", "half", "1"):
        with pytest.raises(ValueError):
            validate_precision(bad)


def test_score_dtype_and_itemsize():
    assert score_dtype("f32") == torch.float32
    assert score_dtype("bf16") == torch.bfloat16
    assert score_itemsize("f32") == 4
    assert score_itemsize("bf16") == 2
    from traceweaver_tpu.ops.precision import score_itemsize as j_itemsize

    for p in ("f32", "bf16", "bfloat16"):
        assert score_itemsize(p) == j_itemsize(p)


# ---------------------------------------------------------------------------
# seeded windows (tests/test_precision.py _consistent_problem)
# ---------------------------------------------------------------------------

def _problem(seed, B=2, E=2, W=24, M=24):
    from test_precision import _consistent_problem

    return _consistent_problem(np.random.default_rng(seed), B=B, E=E, W=W, M=M)


def _torch_args(args):
    return [torch.as_tensor(np.asarray(a)) for a in args]


def _capture_port(monkeypatch):
    """Every OT block the port's solver hands to assign_topk, per window."""
    blocks, real = [], tw.assign_topk

    def keep(S_ot, *a, **kw):
        blocks.extend(S_ot[b].clone() for b in range(S_ot.shape[0]))
        return real(S_ot, *a, **kw)

    monkeypatch.setattr(tw, "assign_topk", keep)
    return blocks


def _capture_jax(monkeypatch, jx):
    """Every OT block JAX's solver hands to assign_topk (a debug callback,
    called once per window under the solver's vmap)."""
    import jax

    blocks, real = [], jx.assign_topk

    def keep(S_ot, *a, **kw):
        jax.debug.callback(lambda s: blocks.append(np.asarray(s)), S_ot)
        return real(S_ot, *a, **kw)

    monkeypatch.setattr(jx, "assign_topk", keep)
    jax.clear_caches()  # trace anew, so the callback is in the program
    return blocks


def _as_sorted_bits(blocks):
    out = []
    for b in blocks:
        a = b.view(torch.int16).numpy() if torch.is_tensor(b) else \
            np.asarray(b).view(np.int16)
        if a.ndim == 3:  # a callback that got the whole batch
            out.extend(x.tobytes() for x in a)
        else:
            out.append(a.tobytes())
    return sorted(out)


@pytest.mark.parametrize("seed", [3, 7])
def test_bf16_block_equals_jax_bit_for_bit(seed, jx, monkeypatch):
    """The centred bf16 block of every endpoint of every window of one
    sweep equals the JAX package's, bit for bit."""
    args = _problem(seed)
    kw = dict(n_sinkhorn=20, n_sweeps=1, sinkhorn_tol=1e-3, precision="bf16")
    port_blocks = _capture_port(monkeypatch)
    tw.solve_windows(*_torch_args(args), **kw)
    jax_blocks = _capture_jax(monkeypatch, jx)
    jx.solve_windows(*args, **kw)
    assert port_blocks and all(b.dtype == torch.bfloat16 for b in port_blocks)
    assert len(port_blocks) == 2 * 2
    assert _as_sorted_bits(port_blocks) == _as_sorted_bits(jax_blocks)


def test_bf16_sinkhorn_plan_is_f32_and_close():
    """bf16 scores: the plan is f32, within 0.05 of the f32 plan, its row
    sums track f32's, and it equals the JAX package's XLA bf16 plan
    within the f32 plans' tolerance (at epsilon 1 the two routes agree)."""
    import jax.numpy as jnp
    from test_precision import _random_marg_block

    from traceweaver_tpu.ops.sinkhorn import sinkhorn_log as j_sinkhorn

    rng = np.random.default_rng(1)
    for tol in (0.0, 1e-3):
        for _ in range(4):
            n, m = int(rng.integers(3, 40)), int(rng.integers(3, 40))
            S, rm, cm = _random_marg_block(rng, n, m)
            args = (torch.as_tensor(rm)[None], torch.as_tensor(cm)[None])
            kw = dict(epsilon=1.0, n_iters=30, tol=tol)
            p32 = sinkhorn_log(torch.as_tensor(S)[None], *args, **kw)[0]
            pbf = sinkhorn_log(torch.as_tensor(S)[None].to(torch.bfloat16), *args, **kw)[0]
            assert pbf.dtype == torch.float32
            assert float((p32 - pbf).abs().max()) < 0.05
            live = rm > 0
            assert np.allclose(pbf.sum(1).numpy()[live], p32.sum(1).numpy()[live],
                               atol=0.02)
            ref = np.asarray(j_sinkhorn(jnp.asarray(S, jnp.bfloat16), jnp.asarray(rm),
                                        jnp.asarray(cm), **kw))
            np.testing.assert_allclose(pbf.numpy(), ref, atol=1e-5, rtol=1e-4)


def test_bf16_masked_rows_and_forced_skips_match_f32_exactly():
    args = list(_problem(4, W=16, M=16))
    in_valid = args[2].copy()
    in_valid[:, -4:] = False
    args[2] = in_valid
    out_valid = args[5].copy()
    out_valid[:, 1, :] = False
    args[5] = out_valid
    fskip = args[7].copy()
    fskip[:, 0, :3] = True
    args[7] = fskip
    kw = dict(n_sinkhorn=20, n_sweeps=3, sinkhorn_tol=1e-3)
    a32 = tw.solve_windows(*_torch_args(args), **kw)[0].numpy()
    abf = tw.solve_windows(*_torch_args(args), precision="bf16", **kw)[0].numpy()
    assert np.array_equal(a32[:, :, -4:], abf[:, :, -4:])
    assert np.array_equal(a32[:, 1, :], abf[:, 1, :])
    assert np.array_equal(a32[:, 0, :3], abf[:, 0, :3])


def test_bf16_solver_matches_jax_bf16(jx):
    """Randomized consistent geometries: the port at bf16 assigns >= 99%
    of the JAX package's bf16 assignments alike and reaches its ground
    truth accuracy within 0.5 pt; bf16 agrees with f32 on > 95%."""
    rng = np.random.default_rng(2)
    kw = dict(n_sinkhorn=20, n_sweeps=3, sinkhorn_tol=1e-3)
    total = agree = agree32 = gt_port = gt_jax = 0
    for _ in range(3):
        W = int(rng.integers(12, 28))
        args = _problem(int(rng.integers(1 << 30)), W=W, M=W)
        abf = tw.solve_windows(*_torch_args(args), precision="bf16", **kw)[0].numpy()
        a32 = tw.solve_windows(*_torch_args(args), **kw)[0].numpy()
        jbf = np.asarray(jx.solve_windows(*args, precision="bf16", **kw)[0])
        ident = np.arange(W)[None, None, :]
        total += abf.size
        agree += int((abf == jbf).sum())
        agree32 += int((abf == a32).sum())
        gt_port += int((abf == ident).sum())
        gt_jax += int((jbf == ident).sum())
    assert agree / total >= 0.99, (agree, total)
    assert abs(gt_port - gt_jax) / total <= 0.005
    assert agree32 / total > 0.95


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

def test_bf16_fleet_matches_jax_and_halves_the_score_bytes(monkeypatch):
    from test_torch_pipeline import (
        PORT_KW,
        agreement,
        jax_items,
        jax_solve,
        jax_three_services,
        port_items,
        three_services,
    )

    from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy
    from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy

    probs = three_services()
    st32, stbf, jst = {}, {}, {}
    tf.solve_fleet(port_items(probs), stats=st32, **PORT_KW)
    out = tf.solve_fleet(port_items(probs), stats=stbf, precision="bf16", **PORT_KW)
    jprobs = jax_three_services()
    ref = jax_solve(monkeypatch, jax_items(jprobs), env=dict(TW_PRECISION="bf16"),
                    stats=jst)
    for p, jp, o, r in zip(probs, jprobs, out, ref):
        assert agreement(o[0], r[0]) >= 0.99, p["service"]
        assert abs(t_accuracy(o[0], p["truth"], p["in_parts"])
                   - j_accuracy(r[0], jp["truth"], jp["in_parts"])) <= 0.005
    c32, cbf = st32["fleet_group_cost_total"], stbf["fleet_group_cost_total"]
    assert cbf == jst["fleet_group_cost_total"]
    assert 0.49 * c32 <= cbf <= 0.95 * c32, (c32, cbf)


def test_bf16_group_cost_counts_two_bytes_a_score_element():
    group = [(0, None, {"out_eps": ["a", "b"], "n_passes": 2}, [(0, 8)] * 3, None,
              None, 8, 16)]
    s32, sbf = tf._make_spec(group, 4), tf._make_spec(group, 2)
    score, refit = 3 * 2 * 8 * 16, 1 * (2 + 4 + 2) * 3 * 8
    assert s32.cost == 4 * score + 4 * refit
    assert sbf.cost == 2 * score + 4 * refit


def test_precision_reaches_every_solver_of_a_run(capsys):
    from traceweaver_tpu_torch.algorithms import make_predictors
    from traceweaver_tpu_torch.runtime import cli

    preds = make_predictors({}, {}, device="cpu", precision="bf16", score_gemm=True)
    for _, p in preds[8:]:
        assert p.precision == "bf16" and p.score_gemm
    assert all(not getattr(p, "score_gemm", False) for _, p in
               make_predictors({}, {}, device="cpu")[8:])
    rc = cli.main(["--absolute_path", "/nonexistent", "--fix", "5", "--cache_rate", "0",
                   "--results_directory", "/nonexistent/out", "--precision", "bf61",
                   "--device", "cpu"])
    assert rc == 2 and "bf61" in capsys.readouterr().err


@pytest.mark.parametrize("B, R, C, large", [
    (8, 1025, 2049, 7), (32, 1025, 2049, 7), (3, 5, 21, 7), (1, 4097, 8193, 7)])
def test_bf16_launch_plan_streams_half_the_bytes(B, R, C, large):
    """bf16 blocks: the ring holds 2-byte tiles, so a plan needs no more
    shared memory than f32's with tiles at least as tall; K1, K2 and the
    rounding still share one cluster size."""
    p32 = K.launch_plan(B, R, C, large)
    pbf = K.launch_plan(B, R, C, large, itemsize=2)
    assert pbf.cluster == p32.cluster and pbf.rows_per_cta == p32.rows_per_cta
    assert pbf.tile_rows >= p32.tile_rows
    assert pbf.smem_bytes == K.smem_bytes(R, C, pbf.cluster, pbf.tile_rows, 2)
    assert pbf.smem_bytes <= K.MAX_SMEM_BYTES
    assert K.smem_bytes(R, C, p32.cluster, p32.tile_rows, 2) < p32.smem_bytes
    with pytest.raises(ValueError, match="CUDA tensor"):
        K.fused_assign_cuda(torch.zeros(1, 4, 5, dtype=torch.bfloat16), torch.ones(1, 4),
                            torch.ones(1, 5), torch.zeros(1), 3, epsilon=1.0, n_iters=2,
                            tol=0.0, topk=2, min_topk_mass=1e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(3, 36, 52), (2, 255, 511), (1, 512, 8192)])
def test_bf16_kernels_match_plain_on_card(shape):
    """K2 on a bf16 block allclose to the plain bf16 plan (the same
    tolerance as f32: both read the same bf16 values); K1 equals K2's
    plan rounded by the kernel's rounding, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from test_torch_kernels import _cuda_blocks

    S, rm, cm, in_v, cv, cap = _cuda_blocks(np.random.default_rng(sum(shape)), *shape)
    S = S.to(torch.bfloat16)
    W = shape[1]
    kw = dict(epsilon=1.0, n_iters=40, tol=1e-3)
    rk = dict(topk=5, min_topk_mass=1e-3)
    plan_k, iters = K.sinkhorn_cuda(S, rm, cm, return_iters=True, **kw)
    torch.testing.assert_close(plan_k, sinkhorn_log(S, rm, cm, **kw),
                               atol=1e-5, rtol=1e-4)
    a_k, tk_k, stats = K.fused_assign_cuda(S, rm, cm, cap, W, return_stats=True,
                                           **kw, **rk)
    assert torch.equal(stats[:, 0], iters)
    a_r, tk_r = K.round_topk_cuda(plan_k[:, :W].contiguous(), in_v, cv, cap, **rk)
    assert torch.equal(a_k, a_r) and torch.equal(tk_k, tk_r)
