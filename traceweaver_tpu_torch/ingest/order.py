"""Invocation-order (precedence DAG) inference over outgoing endpoints
(mirrors ``traceweaver_tpu/ingest/order.py``, its ground-truth part).

Given ground-truth assignments for a service, start from the complete
digraph over its downstream endpoints and delete every edge (a, b)
contradicted by a request in which a's span does not complete before b's
starts (the reference executor's ``G1`` graph). The graph is the port's
:class:`~traceweaver_tpu_torch.dag.DAG`, with networkx's node and edge
order.
"""

from __future__ import annotations

from typing import Dict, List

from traceweaver_tpu_torch.dag import DAG
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
