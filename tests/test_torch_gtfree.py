"""Ground-truth-free invocation-DAG discovery: the port against the JAX
package on the CPU, and on the card.

- ``_adaptive_tol`` on the cases of
  ``tests/test_gt_free_dag.py::test_adaptive_tol_widens_on_bimodal_rates_only``;
- ``infer_dag_from_predictions`` gives JAX's ordered edge list on
  seeded predictions with noisy rows, NA and SKIP entries and cycles
  (pairwise orderings that close on themselves, so the weakest edge of
  the cycle networkx finds decides the result);
- ``DAG.find_cycle`` equals ``networkx.find_cycle`` (networkx only in
  this test) on random digraphs, and so does acyclicity;
- ``discover_invocation_dag`` with ``WeaverTorch(device="cpu")`` gives
  JAX's edges with ``WeaverTPU`` on every service of two small exp5
  graphs whose solves predict alike; on every service, JAX's pruning of
  the port's predictions gives the port's edges;
- the CLI with ``--gt_free_dag 1 --device cpu`` reads JAX's
  ``gt_free_dag`` accuracy on one graph within 0.5 pt.

The ``gpu`` test runs the ground-truth-free CLI on the card (run with
``--noconftest``: this module imports JAX only inside its CPU tests).
"""

import os
import random

import numpy as np
import pytest
import torch

from traceweaver_tpu_torch import spans as tspans
from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus
from traceweaver_tpu_torch.dag import DAG, NoCycle
from traceweaver_tpu_torch.ingest import order as torder
from traceweaver_tpu_torch.runtime import executor as tx

torch.set_num_threads(1)

N_GRAPHS, N_TRACES = 2, 100
FLAGSHIP = "MaxScoreBatchSubsetWithSkips"
gpu = pytest.mark.gpu


@pytest.mark.parametrize("rates,tol", [
    ([0.020, 0.135, 0.280, 0.782, 0.880, 0.988], 0.05),
    ([0.5, 0.9], 0.05),
    ([0.02, 0.40, 0.95], 0.05),
    ([0.2, 0.4, 0.45], 0.05),
    ([0.3], 0.05),
    ([], 0.05),
    ([0.0, 0.9], 0.5),
    ([0.1, float("nan"), 0.8], 0.05),
])
def test_adaptive_tol_equal(rates, tol):
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.ingest.order import _adaptive_tol

    assert torder._adaptive_tol(rates, tol) == _adaptive_tol(rates, tol)


def _predictions(seed: int, n_rows: int = 160, n_eps: int = 5):
    """Seeded spans and predicted assignments. Each row orders one pair
    of endpoints, taken from two cycles over the endpoints that share
    nodes (pairs that never meet in a row keep no ordering evidence, so
    both cycles survive the pruning and must be broken), or orders a
    longer run of them; some rows overlap at random (noise), and some
    entries are NA or SKIP."""
    rng = np.random.default_rng(seed)
    eps = [f"ep{i}" for i in rng.permutation(n_eps)]
    ring = list(rng.permutation(eps))
    one, two = ring[:3], [ring[1], ring[3], ring[4], ring[0]]
    orders = ([[c[i], c[(i + 1) % len(c)]] for c in (one, two) for i in range(len(c))]
              + [list(rng.permutation(eps)[:3])])
    recs, assign = [], {ep: {} for ep in eps}
    for i in range(n_rows):
        t = float(i * 10_000)
        in_id = (f"t{i}", "in")
        recs.append((in_id, t, 5000.0))
        order = orders[rng.integers(len(orders))]
        noisy = rng.random() < 0.04
        cursor = t + 10
        for ep in eps:
            r = rng.random()
            if ep not in order and r < 0.3:
                assign[ep][in_id] = tspans.NA
            elif ep not in order and r < 0.5:
                assign[ep][in_id] = tspans.SKIP
        for ep in order:
            dur = float(rng.integers(20, 60))
            start = t + 10 + float(rng.integers(0, 80)) if noisy else cursor
            cursor = start + dur + float(rng.integers(1, 20))
            sid = (f"t{i}", f"{ep}-{i}")
            recs.append((sid, start, dur))
            assign[ep][in_id] = sid
    return eps, recs, assign


def _problem(mod_spans, eps, recs, assign):
    store = mod_spans.TraceStore()
    in_spans, parts = [], {ep: [] for ep in eps}
    for (tid, sid), start, dur in recs:
        kind = "server" if sid == "in" else "client"
        span = mod_spans.Span(tid, sid, start, dur, None, [], "p", kind)
        if sid == "in":
            in_spans.append(span)
        else:
            store.all_spans[span.GetId()] = span
            parts[sid.split("-")[0]].append(span)
    return {"IN": in_spans}, parts, store


@pytest.mark.parametrize("seed", range(12))
@pytest.mark.parametrize("tol", [0.05, 0.0])
def test_infer_dag_from_predictions_equal(seed, tol):
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu import spans as jspans
    from traceweaver_tpu.ingest.order import infer_dag_from_predictions

    eps, recs, assign = _predictions(seed)
    j_in, j_parts, j_store = _problem(jspans, eps, recs, assign)
    jg = infer_dag_from_predictions(j_in, j_parts, assign, j_store, tol=tol)
    t_in, t_parts, t_store = _problem(tspans, eps, recs, assign)
    tg = torder.infer_dag_from_predictions(t_in, t_parts, assign, t_store, tol=tol)
    assert list(jg.nodes) == list(tg)
    assert [tuple(e) for e in jg.edges()] == tg.edges()
    assert tg.is_directed_acyclic_graph()


def test_predictions_make_cycles_to_break():
    """Not vacuous: without the cycle breaking, some seeds leave a cycle."""
    from traceweaver_tpu_torch.dag import DAG as TDAG

    real, cyclic = TDAG.find_cycle, []

    def spy(self):
        out = real(self)
        cyclic.append(out)
        return out

    TDAG.find_cycle = spy
    try:
        for seed in range(12):
            eps, recs, assign = _predictions(seed)
            t_in, t_parts, t_store = _problem(tspans, eps, recs, assign)
            torder.infer_dag_from_predictions(t_in, t_parts, assign, t_store)
    finally:
        TDAG.find_cycle = real
    assert cyclic


@pytest.mark.parametrize("seed", range(6))
def test_find_cycle_equals_networkx(seed):
    import networkx as nx

    rng = random.Random(seed)
    found = 0
    for _ in range(300):
        nodes = [f"n{i}" for i in rng.sample(range(30), rng.randint(1, 9))]
        p = rng.random() * 0.5
        edges = [(a, b) for a in nodes for b in nodes if a != b and rng.random() < p]
        rng.shuffle(edges)
        g = nx.DiGraph()
        g.add_nodes_from(nodes)
        g.add_edges_from(edges)
        d = DAG.from_edges(nodes, edges)
        try:
            ref = [tuple(e) for e in nx.find_cycle(g)]
        except nx.NetworkXNoCycle:
            ref = None
        try:
            got = d.find_cycle()
        except NoCycle:
            got = None
        assert got == ref
        assert d.is_directed_acyclic_graph() == nx.is_directed_acyclic_graph(g)
        found += ref is not None
    assert 50 < found < 300


def test_find_cycle_on_two_overlapping_cycles():
    """Two cycles through one node: the DFS order decides which one."""
    import networkx as nx

    for edges in ([("a", "b"), ("b", "c"), ("c", "a"), ("b", "d"), ("d", "a")],
                  [("b", "d"), ("d", "a"), ("a", "b"), ("b", "c"), ("c", "a")],
                  [("c", "a"), ("a", "b"), ("b", "d"), ("d", "c"), ("b", "c")]):
        for nodes in (["a", "b", "c", "d"], ["d", "c", "b", "a"]):
            g = nx.DiGraph()
            g.add_nodes_from(nodes)
            g.add_edges_from(edges)
            assert DAG.from_edges(nodes, edges).find_cycle() == \
                [tuple(e) for e in nx.find_cycle(g)]


@pytest.mark.parametrize("seed", range(4))
def test_fit_invocation_dag_equals_jax(seed):
    """The greedy constraint search adds JAX's edges, in JAX's order, to
    JAX's cost, on a seeded cost where some best edges would close a
    cycle (so the acyclicity test decides)."""
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.ingest import fit_invocation_dag as j_fit

    rng = np.random.default_rng(seed)
    eps = [f"ep{i}" for i in range(4)]
    weight = {(a, b): int(rng.integers(0, 6)) for a in eps for b in eps if a != b}

    def evaluate(dag):
        return 100 - sum(weight[tuple(e)] for e in dag.edges())

    parts = {ep: [] for ep in eps}
    jg, j_cost = j_fit(parts, evaluate)
    tg, t_cost = torder.fit_invocation_dag(parts, evaluate)
    assert [tuple(e) for e in jg.edges()] == tg.edges() and t_cost == j_cost
    assert tg.is_directed_acyclic_graph() and tg.edges()
    limited, _ = torder.fit_invocation_dag(parts, evaluate, max_edges=1)
    assert limited.number_of_edges() == 1


def test_solver_misfit_equals_jax():
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.algorithms.weaver_tpu import WeaverTPU
    from traceweaver_tpu.ingest import solver_misfit as j_misfit
    from traceweaver_tpu.metrics.scorecard import synth_labeled_corpus as j_corpus

    from traceweaver_tpu_torch.algorithms import FCFS
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.metrics.synth import synth_labeled_corpus as t_corpus

    jp, tp = j_corpus(0, 24)[2], t_corpus(0, 24)[2]  # fanout: 5 endpoints
    args = ("MaxScoreBatchSubsetWithSkips", "fanout")
    j_eval = j_misfit(WeaverTPU({}, {}), *args, jp["in_parts"], jp["out_parts"],
                      jp["truth"])
    t_eval = torder.solver_misfit(WeaverTorch({}, {}, device="cpu"), *args,
                                  tp["in_parts"], tp["out_parts"], tp["truth"])
    assert t_eval(tp["dag"]) == j_eval(jp["dag"])
    with pytest.raises(TypeError, match="invocation_graph"):
        torder.solver_misfit(FCFS({}, {}), *args, tp["in_parts"], tp["out_parts"],
                             tp["truth"])


# ---------------------------------------------------------------------------
# discovery on the exp5 corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("exp5")
    dirs = synthesize_corpus(str(root), n_graphs=N_GRAPHS,
                             traces_per_graph=N_TRACES, seed=10)
    table = tx.load_replica_table(os.path.join(root, "misc",
                                               "service_to_replica_new.pickle"))
    return dirs, table


class _Recording:
    """A solver that keeps each solve's predictions."""

    def __init__(self, solver):
        self.solver, self.preds = solver, []

    def FindAssignments(self, *args, **kw):
        out = self.solver.FindAssignments(*args, **kw)
        self.preds.append(out[0])
        return out


@pytest.mark.parametrize("graph", range(N_GRAPHS))
def test_discovery_equals_jax_where_predictions_agree(corpus, graph):
    import traceweaver_tpu.runtime.executor  # noqa: F401  (JAX package import order)
    from traceweaver_tpu.algorithms.weaver_tpu import WeaverTPU
    from traceweaver_tpu.ingest import build_service_problem as j_problem
    from traceweaver_tpu.ingest import discover_invocation_dag as j_discover
    from traceweaver_tpu.ingest import infer_dag_from_predictions as j_infer
    from traceweaver_tpu.ingest import jaeger as j_jaeger

    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch
    from traceweaver_tpu_torch.ingest import build_service_problem as t_problem
    from traceweaver_tpu_torch.ingest import jaeger as t_jaeger

    dirs, _ = corpus
    random.seed(10)
    js = j_jaeger.load_corpus(dirs[graph], 5, native="never", cache=False)
    random.seed(10)
    ts = t_jaeger.load_corpus(dirs[graph], 5, cache=False)
    agreed = solved = 0
    for svc in js.out_spans_by_process:
        jp, tp = j_problem(js, svc), t_problem(ts, svc)
        if jp.skipped:
            continue
        solved += 1
        j_solver = _Recording(WeaverTPU(js.all_spans, js.all_processes))
        t_solver = _Recording(WeaverTorch(ts.all_spans, ts.all_processes, device="cpu"))
        jg = j_discover(jp.in_span_partitions, jp.out_span_partitions, js, j_solver)
        tg = torder.discover_invocation_dag(tp.in_span_partitions,
                                            tp.out_span_partitions, ts, t_solver)
        # the pruning itself: JAX's on the port's last predictions
        last = j_infer(jp.in_span_partitions, jp.out_span_partitions,
                       t_solver.preds[-1], js)
        assert [tuple(e) for e in last.edges()] == torder.infer_dag_from_predictions(
            tp.in_span_partitions, tp.out_span_partitions, t_solver.preds[-1],
            ts).edges()
        if j_solver.preds == t_solver.preds:
            agreed += 1
            assert [tuple(e) for e in jg.edges()] == tg.edges(), svc
    assert solved and agreed


def test_cli_gt_free_reads_jax_accuracy(corpus, tmp_path, capsys):
    import traceweaver_tpu.runtime.executor as jx

    from traceweaver_tpu_torch.runtime import cli

    dirs, table = corpus
    cfg = jx.ExecutorConfig(
        data_path=dirs[0], results_directory="", fix=5, cache_rate=0.0,
        load_level=1, compress_factor=15000, execute_parallel=False,
        predictor_indices=[10], service_to_replica=table, gt_free_dag=True)
    j_acc = jx.run_experiment(cfg).accuracy_overall[FLAGSHIP]

    made, real = [], tx.run_experiment

    def keep(cfg, store=None):
        made.append(real(cfg, store))
        return made[-1]

    tx.run_experiment = keep
    try:
        rc = cli.main(["--absolute_path", dirs[0], "--fix", "5", "--cache_rate", "0",
                       "--load_level", "1", "--compress_factor", "15000",
                       "--execute_parallel", "0", "--predictor_indices", "10",
                       "--results_directory", str(tmp_path), "--gt_free_dag", "1",
                       "--device", "cpu"])
    finally:
        tx.run_experiment = real
    assert rc == 0
    res = made[0]
    assert abs(res.accuracy_overall[FLAGSHIP] - j_acc) <= 0.5
    # the DAGs came from discovery, once per solved service
    assert res.store.discovered_dags
    assert set(res.store.discovery_stats) == set(res.store.discovered_dags)
    assert all(s["solves"] >= 1 for s in res.store.discovery_stats.values())
    assert res.store.ingest_front_end == "native"


@gpu
def test_cli_gt_free_on_card(corpus, tmp_path):
    """The ground-truth-free CLI on the card (no ``--device``) launches
    K1, in discovery and in the flagship, and reads the CPU run's
    accuracy within half a point."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from traceweaver_tpu_torch.ops import cuda_sinkhorn as K
    from traceweaver_tpu_torch.runtime import cli

    dirs, _ = corpus
    made, real, launches = [], tx.run_experiment, {}

    def keep(cfg, store=None):
        made.append(real(cfg, store))
        return made[-1]

    tx.run_experiment = keep
    try:
        for device in ("cuda", "cpu"):
            K.reset_launches()
            argv = ["--absolute_path", dirs[0], "--fix", "5", "--cache_rate", "0",
                    "--load_level", "1", "--compress_factor", "15000",
                    "--execute_parallel", "0", "--predictor_indices", "10",
                    "--results_directory", str(tmp_path / device), "--gt_free_dag", "1"]
            assert cli.main(argv + (["--device", "cpu"] if device == "cpu" else [])) == 0
            launches[device] = K.LAUNCHES["fused_assign"]
    finally:
        tx.run_experiment = real
    card, cpu = made
    assert launches["cuda"] > 0 and card.store.discovered_dags
    assert abs(card.accuracy_overall[FLAGSHIP] - cpu.accuracy_overall[FLAGSHIP]) <= 0.5
