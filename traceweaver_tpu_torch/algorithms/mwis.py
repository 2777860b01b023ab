"""Exact maximum-weight independent set (CPU oracle) (mirrors
``traceweaver_tpu/algorithms/mwis.py``).

Branch-and-bound in the style of Mehrotra & Trick's column-generation
subproblem — the same algorithm family as the reference's license-free
fallback (reference traceweaver_v3.py:1305-1393 ``exact_MWIS``), standing in
for the Gurobi ILP (traceweaver_v3.py:1395-1419). Used to resolve
per-window conflicts among top-K candidate assignments in
:mod:`traceweaver_tpu_torch.algorithms.weaver_exact`, and as the correctness
oracle the windowed Sinkhorn solver is validated against on small windows.
"""

from __future__ import annotations

from typing import Dict, Hashable, List, Set, Tuple

EPS = 1e-9


def exact_mwis(adj: Dict[Hashable, Set[Hashable]],
               weight: Dict[Hashable, float]) -> Tuple[List[Hashable], float]:
    """Exact MWIS on an adjacency-set graph. Returns (nodes, total weight).

    Branch on the highest degree*weight node: either include it (dropping
    its neighbors) or exclude it, pruning branches whose optimistic bound
    (current score + sum of remaining weights) can't beat the incumbent.

    Nodes with non-positive weight are dropped upfront: removing such a node
    from any independent set keeps it independent without lowering the
    total, so none can belong to an optimal solution — and with all-positive
    weights the isolated-node inclusion and the optimistic bound are valid.
    """
    weight = {n: w for n, w in weight.items() if w > 0}
    adj = {n: {m for m in nbrs if m in weight}
           for n, nbrs in adj.items() if n in weight}
    best: Tuple[float, Tuple[Hashable, ...]] = (-float("inf"), ())

    def solve(nodes: Set[Hashable], score: float,
              chosen: Tuple[Hashable, ...]) -> None:
        nonlocal best
        ub = score + sum(weight[n] for n in nodes)
        if ub <= best[0] + EPS:
            return
        if not nodes:
            if score > best[0]:
                best = (score, chosen)
            return
        # isolated nodes are always taken
        isolated = [n for n in nodes if not (adj[n] & nodes)]
        if isolated:
            gain = sum(weight[n] for n in isolated)
            solve(nodes - set(isolated), score + gain,
                  chosen + tuple(isolated))
            return
        pivot = max(nodes, key=lambda n: len(adj[n] & nodes) * weight[n])
        # branch 1: include pivot
        solve(nodes - {pivot} - adj[pivot], score + weight[pivot],
              chosen + (pivot,))
        # branch 2: exclude pivot
        solve(nodes - {pivot}, score, chosen)

    solve(set(weight), 0.0, ())
    return list(best[1]), best[0]
