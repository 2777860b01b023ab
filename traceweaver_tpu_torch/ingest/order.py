"""Invocation-order (precedence DAG) inference over outgoing endpoints
(mirrors ``traceweaver_tpu/ingest/order.py``).

Given ground-truth assignments for a service, start from the complete
digraph over its downstream endpoints and delete every edge (a, b)
contradicted by a request in which a's span does not complete before b's
starts (the reference executor's ``G1`` graph). Without ground truth,
:func:`discover_invocation_dag` runs the same pruning on a solver's
predictions (:func:`infer_dag_from_predictions`, lines 94-321 of the JAX
module), and :func:`fit_invocation_dag` with :func:`solver_misfit`
searches edges greedily by a solver's misfit (lines 324-377). The graph
is the port's :class:`~traceweaver_tpu_torch.dag.DAG`, with networkx's
node, edge and cycle order.
"""

from __future__ import annotations

import copy
import inspect
import time
from typing import Dict, List

from traceweaver_tpu_torch.dag import DAG, NoCycle
from traceweaver_tpu_torch.spans import Span, TraceStore


def topological_sort_grouped(G: DAG) -> List[List]:
    """Kahn's algorithm, yielding antichains (groups of zero in-degree)."""
    indegree = {v: G.in_degree(v) for v in G if G.in_degree(v) > 0}
    zero = [v for v in G if G.in_degree(v) == 0]
    groups = []
    while zero:
        groups.append(zero)
        nxt = []
        for v in zero:
            for child in G.successors(v):
                indegree[child] -= 1
                if not indegree[child]:
                    nxt.append(child)
        zero = nxt
    return groups


def _complete_digraph(out_eps: List[str]) -> DAG:
    return DAG.complete(out_eps)


def _prune_contradicted_edges(G: DAG, per_request_rows) -> None:
    """Delete every edge (a, b) contradicted by a request in which a's
    span overlaps b's (a does not complete before b starts)."""
    for outgoing in per_request_rows:
        outgoing.sort(key=lambda x: x[0])
        for i, (xs, xd, xep) in enumerate(outgoing):
            for j, (ys, yd, yep) in enumerate(outgoing):
                if i == j:
                    continue
                if xs + xd > ys and G.has_edge(xep, yep):
                    G.remove_edge(xep, yep)
                if ys + yd > xs and G.has_edge(yep, xep):
                    G.remove_edge(yep, xep)


def infer_invocation_dag(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    true_assignments: Dict[str, Dict],
    store: TraceStore,
) -> DAG:
    """The endpoint precedence DAG from ground-truth assignments: edge
    (a, b) survives iff in no request does a's span overlap b's."""
    assert len(in_span_partitions) == 1
    _, in_spans = next(iter(in_span_partitions.items()))
    out_eps = list(out_span_partitions.keys())

    G = _complete_digraph(out_eps)
    rows = []
    for in_span in in_spans:
        outgoing = []
        for out_ep in out_eps:
            span = store.all_spans[true_assignments[out_ep][in_span.GetId()]]
            child = span.GetChildProcess(store.all_processes, store.all_spans)
            outgoing.append((span.start_mus, span.duration_mus, child))
        rows.append(outgoing)
    _prune_contradicted_edges(G, rows)
    return G


def _adaptive_tol(rates, tol: float,
                  min_gap: float = 0.3, max_low: float = 0.35) -> float:
    """Widen ``tol`` to the midpoint of the largest gap in the sorted
    contradiction-rate spectrum when the rates are clearly bimodal: the
    gap at least ``min_gap`` wide and the low cluster's maximum at most
    ``max_low``; otherwise ``tol``. Never returns less than ``tol``."""
    finite = sorted(r for r in rates if r == r)
    if len(finite) < 2:
        return tol
    width, low_max, mid = max(
        (finite[i + 1] - finite[i], finite[i],
         0.5 * (finite[i] + finite[i + 1]))
        for i in range(len(finite) - 1))
    if width >= min_gap and low_max <= max_low and mid > tol:
        return mid
    return tol


#: pairs seen in fewer rows are judged at the fixed tolerance only
MIN_SUPPORT = 20
#: a pair kept only by the widened tolerance needs forward support of at
#: least this share of its rows ...
MIN_DIR_SUPPORT = 0.7
#: ... or a reverse direction contradicted in at least this share
MIN_REVERSE_CONTRA = 0.98


def infer_dag_from_predictions(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    assignments: Dict[str, Dict],
    store: TraceStore,
    tol: float = 0.05,
) -> DAG:
    """The contradiction pruning, driven by PREDICTED assignments.

    NA and SKIP entries contribute no row for their endpoint; endpoint
    labels come from the partition keys. Against prediction noise:

    - endpoint pairs that never co-occur in a row keep neither direction,
      and remaining cycles are broken at their weakest-supported edge
      (the cycle :meth:`DAG.find_cycle` returns, as networkx's);
    - an edge is pruned only when contradicted in more than ``tol`` of
      its co-occurrence rows, where ``tol`` is widened by
      :func:`_adaptive_tol` over the rates of pairs with at least
      :data:`MIN_SUPPORT` rows (``tol=0``: strict, never widened);
    - a pair kept only by the widened tolerance also needs directional
      evidence (:data:`MIN_DIR_SUPPORT` forward support or a reverse
      direction contradicted in :data:`MIN_REVERSE_CONTRA` of its rows).

    The JAX docstring (``traceweaver_tpu/ingest/order.py:123-176``) gives
    the measurements behind each bar.
    """
    assert len(in_span_partitions) == 1
    _, in_spans = next(iter(in_span_partitions.items()))
    out_eps = list(out_span_partitions.keys())

    G = _complete_digraph(out_eps)
    rows = []
    for in_span in in_spans:
        outgoing = []
        for out_ep in out_eps:
            out_id = assignments.get(out_ep, {}).get(in_span.GetId())
            if out_id is None or not isinstance(out_id, tuple):
                continue
            span = store.all_spans.get(out_id)
            if span is None:  # NA / SKIP sentinels are 2-tuples too
                continue
            outgoing.append((span.start_mus, span.duration_mus, out_ep))
        if len(outgoing) > 1:
            rows.append(outgoing)

    cooccur: Dict[tuple, int] = {}
    contra: Dict[tuple, int] = {}
    support: Dict[tuple, int] = {}
    for outgoing in rows:
        outgoing.sort(key=lambda x: x[0])
        for i, (xs, xd, xep) in enumerate(outgoing):
            for j, (ys, yd, yep) in enumerate(outgoing):
                if i == j:
                    continue
                # every ordered pair once per row: contra and cooccur
                # count the same rows
                cooccur[(xep, yep)] = cooccur.get((xep, yep), 0) + 1
                if xs + xd <= ys:  # x completed before y started
                    support[(xep, yep)] = support.get((xep, yep), 0) + 1
                else:              # overlap contradicts edge (x -> y)
                    contra[(xep, yep)] = contra.get((xep, yep), 0) + 1

    rates = [contra.get(k, 0) / n
             for k, n in cooccur.items() if n >= MIN_SUPPORT]
    tol_eff = _adaptive_tol(rates, tol) if tol > 0 else 0.0
    for a in out_eps:
        for b in out_eps:
            if a == b or not G.has_edge(a, b):
                continue
            n = cooccur.get((a, b), 0)
            t_ab = tol_eff if n >= MIN_SUPPORT else tol
            c_ab = contra.get((a, b), 0)
            if n == 0 or c_ab > t_ab * n:
                G.remove_edge(a, b)
                continue
            if c_ab > tol * n:
                # kept only by the widened tolerance: demand directional
                # evidence for the pair
                sup_rate = support.get((a, b), 0) / n
                n_rev = cooccur.get((b, a), 0)
                rev_rate = (contra.get((b, a), 0) / n_rev) if n_rev else 0.0
                if (sup_rate < MIN_DIR_SUPPORT
                        and rev_rate < MIN_REVERSE_CONTRA):
                    G.remove_edge(a, b)
    while True:
        try:
            cycle = G.find_cycle()
        except NoCycle:
            break
        weakest = min(cycle, key=lambda e: (support.get(e, 0), e))
        G.remove_edge(*weakest)
    return G


def discover_invocation_dag(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    store: TraceStore,
    solver,
    method: str = "MaxScoreBatchSubsetWithSkips",
    max_iters: int = 3,
    stats: Dict[str, float] = None,
) -> DAG:
    """Ground-truth-free invocation-DAG discovery: solve with the
    unconstrained DAG, prune the edges the PREDICTED assignments
    contradict (:func:`infer_dag_from_predictions`), solve again under
    the pruned DAG, and repeat until the edge set stops changing (at
    most ``max_iters`` solves). No step reads ground truth: the solver
    gets an empty truth dict. Each solve gets deep copies of the
    partitions, as the JAX package's does. ``stats`` (a dict) receives
    the host seconds of the copies (``copy_s``), of the solves
    (``solve_s``) and of the pruning (``infer_s``), and ``solves``."""
    out_eps = list(out_span_partitions)
    empty_truth = {ep: {} for ep in out_eps}
    dag = DAG()
    dag.add_nodes_from(out_eps)
    st = stats if stats is not None else {}
    for key in ("copy_s", "solve_s", "infer_s", "solves"):
        st.setdefault(key, 0.0)

    prev_edges = None
    for _ in range(max_iters):
        t0 = time.perf_counter()
        parts = copy.deepcopy(in_span_partitions), copy.deepcopy(out_span_partitions)
        t1 = time.perf_counter()
        out = solver.FindAssignments(method, "gt-free-dag", *parts,
                                     False, [], empty_truth, dag)
        t2 = time.perf_counter()
        pred = out[0] if isinstance(out, tuple) else out
        new_dag = infer_dag_from_predictions(
            in_span_partitions, out_span_partitions, pred, store)
        st["copy_s"] += t1 - t0
        st["solve_s"] += t2 - t1
        st["infer_s"] += time.perf_counter() - t2
        st["solves"] += 1
        edges = frozenset(new_dag.edges())
        if edges == prev_edges:
            break
        prev_edges = edges
        dag = new_dag
    return dag


def fit_invocation_dag(out_span_partitions: Dict[str, List[Span]], evaluate,
                       max_edges: int = None):
    """Ground-truth-free constraint search (the reference's
    ``FindConstraintsUsingFit``): from the empty DAG, greedily add the
    one edge whose addition most lowers ``evaluate(dag)`` while keeping
    the graph acyclic, until no edge lowers it. Returns ``(dag,
    best_cost)``; :func:`solver_misfit` makes an ``evaluate``."""
    out_eps = list(out_span_partitions)
    G = DAG()
    G.add_nodes_from(out_eps)
    best = evaluate(G)
    limit = max_edges if max_edges is not None else len(out_eps) ** 2

    while G.number_of_edges() < limit:
        best_edge = None
        for a in out_eps:
            for b in out_eps:
                if a == b or G.has_edge(a, b):
                    continue
                G.add_edge(a, b)
                if G.is_directed_acyclic_graph():
                    cost = evaluate(G)
                    if cost < best:
                        best, best_edge = cost, (a, b)
                G.remove_edge(a, b)
        if best_edge is None:
            break
        G.add_edge(*best_edge)
    return G, best


def solver_misfit(solver, method: str, process: str, in_span_partitions,
                  out_span_partitions, true_assignments):
    """An ``evaluate`` for :func:`fit_invocation_dag` from a solver whose
    ``FindAssignments`` takes an ``invocation_graph``: the unassigned
    spans it reports (position 5 of its 6-tuple)."""
    params = inspect.signature(solver.FindAssignments).parameters
    if "invocation_graph" not in params:
        raise TypeError(
            f"{type(solver).__name__}.FindAssignments takes no "
            "invocation_graph — constraint search needs a DAG-aware solver"
        )

    def evaluate(dag) -> int:
        out = solver.FindAssignments(
            method, process,
            copy.deepcopy(in_span_partitions),
            copy.deepcopy(out_span_partitions),
            False, [], copy.deepcopy(true_assignments),
            invocation_graph=dag,
        )
        return int(out[5]) if isinstance(out, tuple) and len(out) > 5 else 0

    return evaluate
