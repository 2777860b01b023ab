"""The KDE score mode of the port against the JAX package's (CPU).

- ``EdgeDist.from_samples_kde`` equals JAX's to 1e-12 on the same
  samples; for n <= K it is the Gaussian KDE exactly
  (``scipy.stats.gaussian_kde``), binned it tracks it (corr > 0.97), as
  ``tests/test_solver.py`` holds JAX's;
- ``fit_value_dists`` and the fits that thread ``score_mode`` through
  (bootstrap, oracle, refit) equal JAX's under ``"kde"``;
- ``WeaverTorch(score_mode="kde", device="cpu")`` against
  ``WeaverTPU(score_mode="kde")`` on a small synthesized service: two
  unfused passes with the host refit between them, >= 99% equal
  assignments and accuracy within 0.5 pt;
- ``solve_fleet(score_mode="kde")`` sends every item to the per-service
  path (no fleet dispatch) and equals the per-service runs; the
  executor keeps a KDE predictor off the fleet.
"""

import numpy as np
import pytest
import scipy.stats
import torch

import jax
import networkx as nx

from traceweaver_tpu.algorithms import timing as jtiming
from traceweaver_tpu.algorithms import weaver_tpu as jw
from traceweaver_tpu.metrics.accuracy import accuracy_for_service as j_accuracy
from traceweaver_tpu.metrics.scorecard import _make_service

from traceweaver_tpu_torch.algorithms import timing as ttiming
from traceweaver_tpu_torch.algorithms import weaver_torch as tw
from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet
from traceweaver_tpu_torch.metrics.accuracy import accuracy_for_service as t_accuracy
from traceweaver_tpu_torch.metrics.synth import chain_edges, make_service

jax.config.update("jax_platforms", "cpu")
torch.set_num_threads(1)  # small tensors; the test workers share the cores

METHOD = "MaxScoreBatchSubsetWithSkips"


def _both_services(n, burst, seed=0, n_eps=3, jitter_us=10.0):
    kw = dict(n_traces=n, n_eps=n_eps, spacing_us=6000.0, burst=burst,
              jitter_us=jitter_us)
    pj = _make_service("svc", rng=np.random.default_rng(seed), **kw)
    edges = chain_edges("svc", n_eps)
    dag = nx.DiGraph()
    dag.add_nodes_from(pj["out_parts"])
    dag.add_edges_from(edges)
    pj["dag"] = dag
    pt = make_service("svc", rng=np.random.default_rng(seed), dag_edges=edges, **kw)
    return pj, pt


def _same_dists(a, b, tol=1e-12):
    assert set(a) == set(b)
    for k in a:
        for f in ("weights", "means", "stds"):
            np.testing.assert_allclose(getattr(b[k], f), getattr(a[k], f),
                                       rtol=0, atol=tol)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 6, 40, 1000])
def test_from_samples_kde_equals_jax(n):
    rng = np.random.default_rng(n)
    x = np.concatenate([rng.normal(1000, 40, n - n // 3),
                        rng.normal(4000, 120, n // 3)])
    a = jtiming.EdgeDist.from_samples_kde(x)
    b = ttiming.EdgeDist.from_samples_kde(x)
    for f in ("weights", "means", "stds"):
        np.testing.assert_allclose(getattr(b, f), getattr(a, f), rtol=0, atol=1e-12)
    xs = np.linspace(0.0, 5000.0, 33)
    np.testing.assert_allclose(b.logpdf(xs), a.logpdf(xs), rtol=0, atol=1e-12)


def test_kde_degenerate_samples_equal_jax():
    for x in ([], [7.0], [5.0, 5.0, 5.0]):
        a = jtiming.EdgeDist.from_samples_kde(x)
        b = ttiming.EdgeDist.from_samples_kde(x)
        for f in ("weights", "means", "stds"):
            np.testing.assert_array_equal(getattr(b, f), getattr(a, f))


def test_kde_exact_for_few_samples():
    """n <= K: the mixture is the Gaussian KDE (a component a sample)."""
    samples = [100.0, 220.0, 370.0, 540.0]
    d = ttiming.EdgeDist.from_samples_kde(samples)
    kde = scipy.stats.gaussian_kde(samples)  # Scott's bandwidth, as ours
    xs = np.linspace(0.0, 700.0, 29)
    np.testing.assert_allclose(np.exp(d.logpdf(xs)), kde.evaluate(xs),
                               rtol=1e-6, atol=1e-12)


def test_kde_binned_approximates_scipy():
    rng = np.random.default_rng(3)
    samples = np.concatenate([rng.normal(1000, 40, 300),
                              rng.normal(4000, 120, 200)])
    d = ttiming.EdgeDist.from_samples_kde(samples)
    kde = scipy.stats.gaussian_kde(samples)
    xs = np.linspace(500, 4500, 41)
    assert np.corrcoef(np.exp(d.logpdf(xs)), kde.evaluate(xs))[0, 1] > 0.97


def test_fit_value_dists_score_modes_equal_jax():
    rng = np.random.default_rng(5)
    values = {("a", "b"): list(rng.normal(300, 30, 50)),
              ("b", "c"): list(rng.normal(900, 80, 3)),
              ("c", "a"): []}
    _same_dists(jtiming.fit_value_dists(values, "kde"),
                ttiming.fit_value_dists(values, "kde", device="cpu"))
    _same_dists(jtiming.fit_value_dists({k: v for k, v in values.items() if v}),
                ttiming.fit_value_dists({k: v for k, v in values.items() if v},
                                        device="cpu"))


@pytest.mark.parametrize("fit", ["bootstrap", "true", "refit"])
def test_kde_fits_threaded_through_equal_jax(fit):
    """The bootstrap, the oracle fit and the refit under ``score_mode=
    "kde"`` give JAX's binned KDEs on one service's spans."""
    pj, pt = _both_services(64, burst=16, seed=2)
    eps = list(pj["out_parts"])
    if fit == "bootstrap":
        a = jtiming.bootstrap_distributions(pj["in_parts"], pj["out_parts"], eps,
                                            score_mode="kde")
        b = ttiming.bootstrap_distributions(pt["in_parts"], pt["out_parts"], eps,
                                            score_mode="kde")
    elif fit == "true":
        a = jtiming.true_distributions(pj["in_parts"], pj["out_parts"], eps,
                                       pj["truth"], score_mode="kde")
        b = ttiming.true_distributions(pt["in_parts"], pt["out_parts"], eps,
                                       pt["truth"], score_mode="kde")
    else:
        a = jtiming.refit_from_assignments(pj["in_parts"], pj["out_parts"], pj["dag"],
                                           pj["truth"], {}, score_mode="kde")
        b = ttiming.refit_from_assignments(pt["in_parts"], pt["out_parts"], pt["dag"],
                                           pt["truth"], {}, device="cpu",
                                           score_mode="kde")
    assert a
    _same_dists(a, b)


def test_score_mode_is_checked():
    with pytest.raises(ValueError):
        tw.WeaverTorch({}, {}, device="cpu", score_mode="histogram")


def test_find_assignments_kde_matches_jax():
    """``score_mode="kde"`` end to end on a 256-request cut of
    synth-async-8k: two passes, the binned-KDE refit on the host."""
    pj, pt = _both_services(256, burst=256)
    args = (METHOD, "svc")
    jalgo = jw.WeaverTPU({}, {}, score_mode="kde")
    oj = jalgo.FindAssignments(*args, pj["in_parts"], pj["out_parts"], False, [],
                               pj["truth"], pj["dag"])
    talgo = tw.WeaverTorch({}, {}, device="cpu", score_mode="kde")
    ot = talgo.FindAssignments(*args, pt["in_parts"], pt["out_parts"], False, [],
                               pt["truth"], pt["dag"])
    assert not talgo.stats.get("fused_em_applied")
    assert not jalgo.stats.get("fused_em_applied")
    assert "refit_s" in talgo.stats
    pairs = [(ep, i) for ep in oj[0] for i in oj[0][ep]]
    assert len(pairs) == 3 * 256
    same = sum(ot[0][ep][i] == oj[0][ep][i] for ep, i in pairs) / len(pairs)
    assert same >= 0.99
    acc_j = j_accuracy(oj[0], pj["truth"], pj["in_parts"])
    acc_t = t_accuracy(ot[0], pt["truth"], pt["in_parts"])
    assert abs(acc_j - acc_t) <= 0.005
    assert ot[3] == oj[3] == 256


def _items(pt):
    return [FleetItem("svc", pt["in_parts"], pt["out_parts"], pt["truth"],
                      tw.DAG.from_edges(pt["out_parts"].keys(),
                                        chain_edges("svc", 3)))]


def test_solve_fleet_kde_takes_the_per_service_path():
    _, pt = _both_services(96, burst=24, seed=4)
    stats = {}
    out = solve_fleet(_items(pt), device="cpu", stats=stats, score_mode="kde")
    assert not stats.get("fleet_dispatches")
    assert not stats.get("fused_em_applied")
    algo = tw.WeaverTorch({}, {}, device="cpu", score_mode="kde")
    ref = algo.FindAssignments(METHOD, "svc", pt["in_parts"], pt["out_parts"], False,
                               [], pt["truth"], _items(pt)[0].dag)
    assert out[0][0] == ref[0]
    assert out[0][2:] == ref[2:]
    # the mixture solver of the same items rides the fleet dispatch
    stats = {}
    solve_fleet(_items(pt), device="cpu", stats=stats)
    assert stats.get("fleet_dispatches", 0) >= 1


def test_executor_keeps_a_kde_predictor_off_the_fleet(tmp_path, monkeypatch):
    """The flagship slot with a KDE solver goes service by service: no
    fleet ledger, and its per-service solves take two unfused passes."""
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
    from traceweaver_tpu_torch.runtime import executor as tx

    (d,) = synthesize_corpus(str(tmp_path), n_graphs=1, traces_per_graph=64,
                             seed=10)
    real = tx.make_predictors
    solvers = []

    def kde_predictors(*a, **k):
        preds = real(*a, **k)
        for _, p in preds:
            if isinstance(p, tw.WeaverTorch):
                p.score_mode = "kde"
                solvers.append(p)
        return preds

    monkeypatch.setattr(tx, "make_predictors", kde_predictors)
    res = tx.run_experiment(tx.ExecutorConfig(
        data_path=d, results_directory="", fix=5, cache_rate=0.0,
        test_name="kde", compress_factor=15000, execute_parallel=False,
        predictor_indices=[10], device="cpu"))
    assert not res.fleet_stats
    assert METHOD in res.accuracy_overall
    assert solvers and all(not p.stats.get("fused_em_applied") for p in solvers)
