"""The benchmark's roofline counts equal ``chip_smoke.py``'s at the
fleet's [8, 1025, 2049] block: K1's bound terms of ``kernel_timing`` and
the assembly's counts of ``assembly_bound``, with the card's calls
replaced by stand-ins on the CPU."""

import json
import os
import sys
from types import SimpleNamespace

import pytest
import torch

from twbench import roofline, spec

B, W, M = 8, 1024, 2048
RATE = 4.3e12


@pytest.fixture
def smoke(monkeypatch):
    sys.path.insert(0, spec.ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(spec.ROOT)
    monkeypatch.setattr(chip_smoke, "exp_rate", lambda: (RATE, 1980.0))
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda fn, reps: 1.0)
    return chip_smoke


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_counts_equal_chip_smoke(smoke, monkeypatch, capsys, dtype):
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K

    iters = torch.tensor([7, 9, 12, 40, 3, 5, 8, 11], dtype=torch.int32)
    rounds = torch.tensor([30, 41, 22, 19, 57, 33, 28, 25], dtype=torch.int32)
    stats = torch.stack([iters, rounds], dim=1)
    monkeypatch.setattr(K, "fused_assign_cuda", lambda *a, **k: (None, None, stats))
    monkeypatch.setattr(K, "sinkhorn_cuda", lambda *a, **k: (None, iters))
    monkeypatch.setattr(K, "card_plan", lambda *a: SimpleNamespace(
        cluster=8, rows_per_cta=128, tile_rows=16, smem_bytes=0))
    blk = dict(S=torch.zeros(B, W + 1, M + 1, dtype=dtype), row_marg=None,
               col_marg=None, in_v=None, col_valid=None, cap=None, n_rows=W)
    smoke.kernel_timing(blk)
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("kernel-timing ")]
    terms = json.loads(line[-1].split(" ", 1)[1])["fused_assign_bound_terms_ms"]
    ours = roofline.k1_counts(B, W + 1, M + 1, W, float(iters.sum()), float(rounds.sum()),
                              torch.empty((), dtype=dtype).element_size())
    assert ours["bytes"] / roofline.PEAK_BYTES_PER_S * 1e3 == pytest.approx(terms["bytes"])
    assert ours["ops"] / roofline.PEAK_F32_OPS_PER_S * 1e3 == pytest.approx(terms["f32"])
    assert ours["exps"] / RATE * 1e3 == pytest.approx(terms["exp"])


def _assembly_call(gen):
    from traceweaver_tpu_torch.ops.scores import MixtureTerm

    def f(*shape):
        return torch.rand(*shape, generator=gen) * 1000.0

    K = 3
    o_s = torch.sort(f(B, M), dim=1).values
    o_e = o_s + 50.0
    in_s = torch.sort(f(B, W), dim=1).values - 100.0
    in_e = in_s + 400.0
    active = torch.tensor([True, False] * (B // 2))

    def term(row_t, col_t, flip=False, row_ok=None, act=None):
        wt = torch.rand(B, K, generator=gen)
        wt[:, -1] = 0.0
        return MixtureTerm(row_t, col_t, wt, f(B, K) / 10, f(B, K) / 100 + 1.0,
                           active if act is None else act, row_ok=row_ok, flip=flip)

    row_ok = torch.rand(B, W, generator=gen) > 0.3
    root = term(in_s, o_s, act=torch.ones(B, dtype=torch.bool))
    preds = [term(in_s + 5.0, o_s)]
    succs = [term(in_s + 200.0, o_e, flip=True, row_ok=row_ok)]
    ret = term(in_e, o_e, flip=True)
    in_v = torch.rand(B, W, generator=gen) > 0.1
    o_v = torch.rand(B, M, generator=gen) > 0.1
    return (root, preds, succs, ret, in_s, in_e, in_v, o_s, o_e, o_v, in_s + 1.0,
            in_e - 1.0, torch.zeros(B, W, dtype=torch.bool))


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_assembly_counts_equal_chip_smoke(smoke, monkeypatch, precision):
    from traceweaver_tpu_torch.ops import scores as SC

    args = _assembly_call(torch.Generator().manual_seed(3))
    monkeypatch.setattr(SC, "assemble_block_cuda",
                        lambda *a, precision: SC.assemble_block_plain(*a, precision=precision))
    _, counts = smoke.assembly_bound([args], precision, RATE)
    feas = SC.assemble_block_plain(*args, precision=precision)[1]
    root, preds, succs, ret = args[:4]
    ours = roofline.assembly_counts([root, *preds, *succs, ret], B, W, M, True, feas,
                                    2 if precision == "bf16" else 4)
    assert ours["bytes"] == pytest.approx(counts["bytes"])
    assert ours["ops"] == pytest.approx(counts["f32_ops"])
    assert ours["exps"] == pytest.approx(counts["sfu_ops"])


def test_bound_names_its_term():
    s, term = roofline.bound_s(3.35e12, 1.0, 1.0, RATE)
    assert (s, term) == (1.0, "bytes")
    assert roofline.bound_s(1.0, 1.0, 2 * RATE, RATE) == (2.0, "exp")
