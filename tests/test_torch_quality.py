"""The port's per-span confidence against the JAX package's (CPU).

- the reductions of ``obs/quality.py`` on the same packed blocks and
  records: equal;
- ``confidence_records`` of the port's ``solve_fleet`` against JAX's on
  the same items: ``cands``, ``support`` and ``not_best`` exact,
  ``conf`` within 1e-6; the same for the per-service fallback and for
  ``WeaverTorch.per_span_confidence`` against ``WeaverTPU``'s;
- the device channels (``conf_device``, JAX ``TW_CONF_DEVICE=1``) within
  one quantum of ``CONF_SCALE``, and they leave the assignments alone;
- a quarantined item gets zero-confidence records.

The services are ``test_torch_pipeline.py``'s three.
"""

import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    PORT_KW,
    identical,
    jax_items,
    jax_solve,
    jax_three_services,
    port_items,
    three_services,
)
from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.algorithms import packed_layout as layout
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.obs import quality
from traceweaver_tpu_torch.runtime import faults as tfaults

torch.set_num_threads(1)
QUANTUM = 1.0 / layout.CONF_SCALE


def _jax_quality():
    import jax

    jax.config.update("jax_platforms", "cpu")
    from traceweaver_tpu.obs import quality as jq

    return jq


def assert_records_match(got, ref, device=False):
    """Same span ids; integer fields exact, ``conf`` within 1e-6, the
    device fields within one quantum."""
    assert got is not None and ref is not None
    assert list(got) == list(ref)
    for sid, r in ref.items():
        g = got[sid]
        assert set(g) == set(r)
        assert (g["cands"], g["support"], g["not_best"]) == \
            (r["cands"], r["support"], r["not_best"]), sid
        assert abs(g["conf"] - r["conf"]) <= 1e-6, sid
        if device:
            for k in ("margin", "entropy"):
                assert abs(g[k] - r[k]) <= QUANTUM + 1e-9, (sid, k)


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------

def _random_block(rng, device, B=4, E=3, W=8, topk=5):
    C = layout.n_channels(topk, device)
    block = np.zeros((B, E, W, C), np.int32)
    block[..., layout.CH_ASSIGN] = rng.integers(-1, 9, (B, E, W))
    block[..., layout.CH_NOT_BEST] = rng.random((B, E, W)) < 0.3
    block[..., layout.CH_FEAS] = rng.integers(0, 6, (B, E, W))
    block[..., layout.CH_TOPK:layout.CH_TOPK + topk] = rng.integers(-1, 9, (B, E, W, topk))
    if device:
        block[..., layout.ch_margin(topk)] = rng.integers(0, 9000, (B, E, W))
        block[..., layout.ch_entropy(topk)] = rng.integers(0, 3000, (B, E, W))
    return block


@pytest.mark.parametrize("device", [False, True])
def test_reductions_match_jax(device):
    jq = _jax_quality()
    rng = np.random.default_rng(int(device))
    block = _random_block(rng, device)
    windows = [(0, 8), (8, 13), (13, 20), (20, 21)]
    got = quality.span_confidence_arrays(windows, block, 21, device=device)
    ref = jq.span_confidence_arrays(windows, block, 21, device=device)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    ids = [f"s{j}" for j in range(21)]
    recs = quality.confidence_records(ids, got)
    assert recs == jq.confidence_records(ids, ref)
    assert quality.zero_confidence() == jq.zero_confidence()
    assert quality.window_confidence_summary(recs) == jq.window_confidence_summary(recs)
    assert quality.window_confidence_summary({}) == {"n": 0}
    for span_ids in (ids[:5], ids[3:], ["ghost"]):
        assert quality.trace_confidence(span_ids, recs) == \
            jq.trace_confidence(span_ids, recs)


def test_scores_fall_with_support_override_and_margin():
    base = dict(not_best=np.array([False, False, True, False]),
                cands=np.array([1, 8, 8, 64]), support=np.array([1, 2, 2, 5]))
    conf = quality.confidence_scores(base)
    assert conf[0] == 1.0 and conf[3] < conf[1] < conf[0]
    assert conf[2] == pytest.approx(conf[1] / 2)
    dconf = quality.confidence_scores(dict(base, margin=np.array([5.0, 1.0, 1.0, 0.0]),
                                           entropy=np.zeros(4)))
    assert dconf[0] > dconf[1] > dconf[3] == 0.0
    assert dconf[2] == pytest.approx(dconf[1] / 2)


# ---------------------------------------------------------------------------
# the device channels
# ---------------------------------------------------------------------------

def test_device_channels_match_jax():
    """``solve_windows_fleet(confidence=True)`` of both packages on the
    same fleet tensors (two services, one with a padded endpoint): every
    base channel equal, the two quality channels within one quantum."""
    from test_torch_fleet import HYPERS, _fleet_tensors, _jax_args, _tables, _torch_args
    from traceweaver_tpu.algorithms import weaver_tpu as jw

    batch, params, pidx, _, _ = _fleet_tensors()
    ref, ref_conv = jw.solve_windows_fleet(*_jax_args(batch, pidx), *_tables(params, "jax"),
                                           n_sweeps=5, confidence=True, **HYPERS)
    got, conv = tw.solve_windows_fleet(*_torch_args(batch, pidx), *_tables(params, "torch"),
                                       n_sweeps=5, confidence=True, **HYPERS)
    ref, got = np.asarray(ref), got.numpy()
    topk = layout.topk_of(ref.shape[-1], confidence=True)
    assert got.shape == ref.shape and topk == 5
    assert np.array_equal(conv.numpy(), np.asarray(ref_conv))
    base = layout.ch_margin(topk)
    assert np.array_equal(got[..., :base], ref[..., :base])
    assert np.abs(got[..., base:] - ref[..., base:]).max() <= 1
    assert (got[..., layout.ch_entropy(topk)] > 0).any()
    plain, _ = tw.solve_windows_fleet(*_torch_args(batch, pidx), *_tables(params, "torch"),
                                      n_sweeps=5, **HYPERS)
    assert np.array_equal(plain.numpy(), got[..., :base])


# ---------------------------------------------------------------------------
# records of solve_fleet and WeaverTorch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_records():
    probs = three_services()
    confs = [None] * len(probs)
    out = tf.solve_fleet(port_items(probs), confidences=confs, **PORT_KW)
    return probs, out, confs


def test_every_span_gets_a_record(port_records):
    probs, out, confs = port_records
    for p, o, c in zip(probs, out, confs):
        ids = [s.GetId() for s in next(iter(p["in_parts"].values()))]
        assert set(c) == set(ids) and o[3] == len(ids)
        assert all(0.0 < r["conf"] <= 1.0 and r["support"] >= 1 for r in c.values())


def test_span_correctness_matches_jax(port_records):
    """The per-span truth column the card's confidence lines use."""
    import copy

    from traceweaver_tpu.metrics.accuracy import span_correctness as j_span_correctness
    from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service, span_correctness

    probs, out, _ = port_records
    for p, jp, o in zip(probs, jax_three_services(), out):
        got = span_correctness(copy.deepcopy(o[0]), p["truth"], p["in_parts"])
        assert got == j_span_correctness(copy.deepcopy(o[0]), jp["truth"], jp["in_parts"])
        assert sum(got.values()) / len(got) == accuracy_for_service(o[0], p["truth"],
                                                                    p["in_parts"])


def test_records_do_not_change_the_solve(port_records):
    probs, out, _ = port_records
    identical(tf.solve_fleet(port_items(probs), **PORT_KW), out)


def test_fleet_records_match_jax(port_records, monkeypatch):
    _, _, confs = port_records
    jconfs = [None] * 3
    jax_solve(monkeypatch, jax_items(jax_three_services()), confidences=jconfs)
    for got, ref in zip(confs, jconfs):
        assert_records_match(got, ref)


def test_device_tier_matches_jax_and_keeps_assignments(port_records, monkeypatch):
    probs, out, _ = port_records
    confs = [None] * 3
    dev_out = tf.solve_fleet(port_items(probs), confidences=confs, conf_device=True,
                             **PORT_KW)
    identical(dev_out, out)
    assert all("margin" in r and "entropy" in r for c in confs for r in c.values())
    assert any(r["entropy"] > 0 for c in confs for r in c.values())
    jconfs = [None] * 3
    jax_solve(monkeypatch, jax_items(jax_three_services()), env=dict(TW_CONF_DEVICE="1"),
              confidences=jconfs)
    for got, ref in zip(confs, jconfs):
        assert_records_match(got, ref, device=True)


def test_quarantined_item_scores_zero(monkeypatch):
    probs = three_services(16)
    confs, quarantined = [None] * 3, []
    out = tf.solve_fleet(port_items(probs), confidences=confs, quarantined=quarantined,
                         faults=tfaults.parse_faults("dispatch:1.0,host:1.0"),
                         retry_backoff_s=0.0, **PORT_KW)
    assert sorted(quarantined) == [0, 1, 2]
    for p, o, c in zip(probs, out, confs):
        ids = [s.GetId() for s in next(iter(p["in_parts"].values()))]
        assert o[5] == len(ids) and set(c) == set(ids)
        assert all(r == quality.zero_confidence() for r in c.values())


def test_fallback_item_carries_the_solver_records(port_records):
    probs, _, _ = port_records
    p = probs[1]
    item = port_items([p])[0]
    item.dag = None
    confs = [None]
    tf.solve_fleet([item], confidences=confs, **PORT_KW)
    algo = tw.WeaverTorch({}, {}, max_window=16, device="cpu")
    algo.FindAssignments("MaxScoreBatchSubsetWithSkips", p["service"], p["in_parts"],
                         p["out_parts"], False, [], p["truth"], None)
    assert confs[0] == algo.per_span_confidence and len(confs[0]) == len(
        next(iter(p["in_parts"].values())))


@pytest.mark.parametrize("index", [0, 1])
def test_per_span_confidence_matches_weaver_tpu(index):
    _jax_quality()
    from traceweaver_tpu.algorithms.weaver_tpu import WeaverTPU

    p, jp = three_services()[index], jax_three_services()[index]
    algo = tw.WeaverTorch({}, {}, device="cpu")
    ref_algo = WeaverTPU({}, {})
    for a, q in ((algo, p), (ref_algo, jp)):
        a.FindAssignments("MaxScoreBatchSubsetWithSkips", q["service"], q["in_parts"],
                          q["out_parts"], False, [], q["truth"], q["dag"])
    assert_records_match(algo.per_span_confidence, ref_algo.per_span_confidence)


def test_confidence_off_leaves_no_records():
    p = three_services(16)[0]
    algo = tw.WeaverTorch({}, {}, device="cpu", confidence=False)
    algo.FindAssignments("MaxScoreBatchSubsetWithSkips", p["service"], p["in_parts"],
                         p["out_parts"], False, [], p["truth"], p["dag"])
    assert algo.per_span_confidence == {}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_records_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = three_services(512)
    confs = [None] * 3
    out = tf.solve_fleet(port_items(probs), confidences=confs, device="cuda")
    torch.cuda.synchronize()
    for p, o, c in zip(probs, out, confs):
        assert len(c) == o[3] == len(next(iter(p["in_parts"].values())))
