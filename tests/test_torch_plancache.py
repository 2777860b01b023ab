"""The port's plan cache, warm starts and ``dists_from_tables`` against
the JAX package's (CPU).

- ``PlanCache`` counters, the ``state`` round trip, a disabled cache,
  ``admissible``;
- ``dists_from_tables`` equals the JAX package's on the same tables, and
  the refit tables of a solve, decoded and repacked, equal themselves
  bit for bit; the in-graph GMM fit keeps the prior of an empty row;
- a warm round (every service a cache hit, single-pass) equals the cold
  round bit for bit, targeted invalidation included, and so does a
  round on ``FleetItem.warm_dists``;
- the port's warm round against the JAX package's: the same hit, miss
  and admission counts, equal assignments up to near ties.

The services are ``test_torch_pipeline.py``'s three.
"""

import numpy as np
import pytest
import torch

from test_torch_pipeline import (
    N_TRACES,
    PORT_KW,
    agreement,
    identical,
    jax_items,
    jax_solve,
    jax_three_services,
    port_items,
    three_services,
)
from traceweaver_tpu_torch.algorithms import fleet as tf
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.algorithms.plancache import PlanCache, admissible
from traceweaver_tpu_torch.algorithms.timing import MAX_COMPONENTS
from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy
from traceweaver_tpu_torch.ops.gmm import fit_gmm_in_graph

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# the cache itself
# ---------------------------------------------------------------------------

def test_hit_miss_admit_invalidate_counting():
    pc = PlanCache()
    assert pc.lookup("svc") is None
    plan = {("in", "a"): "dists"}
    pc.admit("svc", plan)
    assert pc.lookup("svc") is plan and len(pc) == 1
    pc.invalidate("svc")
    assert pc.lookup("svc") is None
    pc.admit("svc", {})      # an empty or missing fit never enters
    pc.admit("svc", None)
    assert len(pc) == 0
    assert pc.counters() == dict(hits=1, misses=2, admissions=1,
                                 invalidations=1, entries=0)
    pc.admit("a", plan)
    pc.admit("b", plan)
    pc.invalidate()
    assert len(pc) == 0 and pc.counters()["invalidations"] == 2


def test_disabled_cache_is_inert():
    pc = PlanCache(enabled=False)
    pc.admit("svc", {("in", "a"): "x"})
    assert pc.lookup("svc") is None and len(pc) == 0
    assert pc.counters() == dict(hits=0, misses=0, admissions=0,
                                 invalidations=0, entries=0)


def test_state_round_trip():
    pc = PlanCache()
    plan = {("in", "a"): "dists"}
    pc.admit("svc", plan)
    pc.lookup("svc")
    pc.lookup("ghost")
    pc.invalidate("ghost")
    back = PlanCache.from_state(pc.state())
    assert back.counters() == pc.counters()
    assert back.lookup("svc") == plan
    assert PlanCache.from_state(None).counters()["entries"] == 0


def test_admissible():
    assert admissible(64) and admissible(1000)
    assert not admissible(63) and not admissible(0)
    assert admissible(8, min_samples=8) and not admissible(7, min_samples=8)


# ---------------------------------------------------------------------------
# dists_from_tables and the refit round trip
# ---------------------------------------------------------------------------

def _random_tables(rng, E, K=MAX_COMPONENTS):
    def f32(*shape, lo=0.0, hi=1.0):
        return rng.uniform(lo, hi, size=shape).astype(np.float32)

    return (f32(E, E, K), f32(E, E, K, lo=-5e4, hi=5e4), f32(E, E, K, lo=1.0, hi=900.0),
            f32(E, K), f32(E, K, lo=0.0, hi=1e5), f32(E, K, lo=1.0, hi=900.0),
            f32(E, K), f32(E, K, lo=0.0, hi=1e5), f32(E, K, lo=1.0, hi=900.0))


@pytest.mark.parametrize("E", [1, 3])
def test_dists_from_tables_matches_jax(E):
    from traceweaver_tpu.algorithms.weaver_tpu import dists_from_tables as j_dists

    tables = _random_tables(np.random.default_rng(E), E)
    out_eps = [f"ep{e}" for e in range(E)]
    got = tw.dists_from_tables(out_eps, "IN", *tables)
    ref = j_dists(out_eps, "IN", *tables)
    assert list(got) == list(ref) and len(got) == 2 * E + E * E
    for key in ref:
        for a in ("weights", "means", "stds"):
            g, r = getattr(got[key], a), getattr(ref[key], a)
            assert g.dtype == r.dtype == np.float64
            assert np.array_equal(g, r)


def test_gmm_keeps_the_prior_of_an_empty_row():
    """What the round trip depends on: a family row with no sample comes
    out of the in-graph fit as its prior, bit for bit."""
    rng = np.random.default_rng(0)
    K = MAX_COMPONENTS
    samples = torch.as_tensor(rng.normal(100.0, 10.0, (3, 64)).astype(np.float32))
    mask = torch.ones(3, 64, dtype=torch.bool)
    mask[1] = False
    prior = [torch.as_tensor(rng.uniform(1.0, 9.0, (3, K)).astype(np.float32))
             for _ in range(3)]
    w, mu, sd = fit_gmm_in_graph(samples, mask, *prior, max_k=K)
    for got, p in zip((w, mu, sd), prior):
        assert torch.equal(got[1], p[1])
        assert not torch.equal(got[0], p[0])


def test_repacked_refit_tables_equal_the_refit(monkeypatch):
    """Each two-pass service's admitted plan, repacked the way the next
    solve packs it, reproduces the refit tables of its group bit for bit,
    rows without samples included."""
    refits, real = [], tf.refit_fleet_params

    def recording(*args):
        out = real(*args)
        refits.append((args[-11].shape[1], [t.numpy().copy() for t in out]))
        return out

    monkeypatch.setattr(tf, "refit_fleet_params", recording)
    probs = three_services()
    pc = PlanCache()
    tf.solve_fleet(port_items(probs), plan_cache=pc, pipeline=False, **PORT_KW)
    # one single-service group each for chain0 (3 endpoints) and fanout (5)
    by_e = {len(p["out_parts"]): p for p in probs if p["service"] != "cache"}
    assert sorted(e for e, _ in refits) == sorted(by_e) == [3, 5]
    for E_pad, tables in refits:
        p = by_e[E_pad]
        out_eps = tw.WeaverTorch._topo_out_eps(p["out_parts"], p["dag"])
        in_ep = next(iter(p["in_parts"]))
        repacked = tw._problem_tables(out_eps, E_pad, pc.lookup(p["service"]),
                                      in_ep, p["dag"], parallel=False)
        for key, table in zip(tf._TABLE_KEYS[3:], tables):
            assert repacked[key].dtype == np.float32
            assert np.array_equal(repacked[key], table[0]), (p["service"], key)


# ---------------------------------------------------------------------------
# warm rounds
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cold():
    probs = three_services()
    pc = PlanCache()
    stats = {}
    out = tf.solve_fleet(port_items(probs), stats=stats, plan_cache=pc, **PORT_KW)
    return probs, pc, out, stats, pc.counters()


def test_cold_round_admits_every_service(cold):
    _, _, _, stats, c = cold
    assert c == dict(hits=0, misses=3, admissions=3, invalidations=0, entries=3)
    assert stats["plan_fit_s"] > 0 and stats["fused_em_applied"] == 2.0


def test_warm_round_equals_cold_round(cold):
    probs, pc, ref, _, _ = cold
    pc = PlanCache.from_state(pc.state())
    stats = {}
    warm = tf.solve_fleet(port_items(probs), stats=stats, plan_cache=pc, **PORT_KW)
    assert pc.counters()["hits"] == 3
    assert "fused_em_applied" not in stats
    assert stats["fleet_dynamism_dispatches"] == stats["fleet_dispatches"]
    identical(warm, ref)

    # a targeted invalidation refits that service alone
    pc.invalidate("fanout")
    again = tf.solve_fleet(port_items(probs), plan_cache=pc, **PORT_KW)
    c = pc.counters()
    assert c["hits"] == 5 and c["misses"] == 4 and c["admissions"] == 4, c
    identical(again, ref)


def test_warm_dists_bypass_the_cache(cold):
    probs, pc, ref, _, _ = cold
    items = port_items(probs)
    plans = pc.state()["dists"]
    for item in items:
        item.warm_dists = plans[item.svc]
    empty = PlanCache()
    out = tf.solve_fleet(items, plan_cache=empty, **PORT_KW)
    assert empty.counters() == dict(hits=0, misses=0, admissions=0,
                                    invalidations=0, entries=0)
    identical(out, ref)


def test_disabled_cache_solves_cold(cold):
    probs, _, ref, _, _ = cold
    off = PlanCache(enabled=False)
    for _ in range(2):
        identical(tf.solve_fleet(port_items(probs), plan_cache=off, **PORT_KW), ref)
    assert off.counters()["misses"] == 0 and len(off) == 0


def test_warm_round_matches_jax(cold, monkeypatch):
    from traceweaver_tpu.algorithms.plancache import PlanCache as JPlanCache
    from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy

    monkeypatch.setenv("TW_PLAN_CACHE", "1")
    probs, pc, _, _, _ = cold
    pc = PlanCache.from_state(pc.state())
    jprobs = jax_three_services()
    jpc = JPlanCache()
    jax_solve(monkeypatch, jax_items(jprobs), plan_cache=jpc)
    assert {k: v for k, v in jpc.counters().items()} == cold[4]
    ref = jax_solve(monkeypatch, jax_items(jprobs), plan_cache=jpc)
    out = tf.solve_fleet(port_items(probs), plan_cache=pc, **PORT_KW)
    assert pc.counters() == jpc.counters()
    for p, jp, o, r in zip(probs, jprobs, out, ref):
        assert o[3] == r[3] == N_TRACES
        assert agreement(o[0], r[0]) >= 0.99, p["service"]
        assert abs(t_accuracy(o[0], p["truth"], p["in_parts"])
                   - j_accuracy(r[0], jp["truth"], jp["in_parts"])) <= 0.005


def test_cache_and_fault_plan_count_exactly_under_threads():
    """The pipeline's flow workers share the cache and the fault plan:
    neither may lose a count."""
    import sys
    import threading

    from traceweaver_tpu_torch.runtime import faults as tfaults

    pc, n_threads, n_each = PlanCache(), 16, 500
    plan = tfaults.parse_faults("fetch:1.0:max=1000")
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(t):
            for k in range(n_each):
                pc.admit(f"svc{t}", {"plan": k})
                pc.lookup(f"svc{t}")
                pc.lookup(f"ghost{t}")
                plan.should_fail("fetch")

        threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    n = n_threads * n_each
    assert pc.counters() == dict(hits=n, misses=n, admissions=n, invalidations=0,
                                 entries=n_threads)
    assert plan.injected["fetch"] == 1000


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_warm_round_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    probs = three_services(512)
    pc = PlanCache()
    # windows of 256: every two-pass service compacts, so every one admits
    kw = dict(max_window=256, device="cuda")
    cold_out = tf.solve_fleet(port_items(probs), plan_cache=pc, **kw)
    stats = {}
    warm = tf.solve_fleet(port_items(probs), plan_cache=pc, stats=stats, **kw)
    torch.cuda.synchronize()
    assert pc.counters()["hits"] == 3 and "fused_em_applied" not in stats
    for p, c, w in zip(probs, cold_out, warm):
        assert agreement(w[0], c[0]) >= 0.99, p["service"]
