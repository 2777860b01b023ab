"""A small directed graph: the part of ``networkx.DiGraph`` the slice uses.

The JAX package keeps the invocation DAG as a ``networkx.DiGraph``;
networkx is not installed beside the port, so this class carries the
few operations the solver path reads, with networkx's ordering rules:

- nodes keep insertion order, and so do each node's edges;
- :meth:`lexicographical_topological_sort` breaks ties by ``key`` and
  then by insertion order (``weaver_tpu.py _topo_out_eps``);
- :meth:`all_simple_paths` with a ``cutoff`` (``timing.py
  has_longer_path``);
- :meth:`complete`, :meth:`has_edge`, :meth:`remove_edge` and
  :meth:`in_degree` for the invocation-DAG inference of
  ``traceweaver_tpu_torch.ingest.order``;
- :meth:`find_cycle` (``networkx.find_cycle``: the same start node,
  successor order and edge order, so the ground-truth-free inference
  breaks the same cycle) and :meth:`is_directed_acyclic_graph`.
"""

from __future__ import annotations

import heapq
from typing import Callable, Dict, Hashable, Iterable, Iterator, List, Optional, Tuple

Node = Hashable


class NoCycle(ValueError):
    """:meth:`DAG.find_cycle` found no cycle (``networkx.NetworkXNoCycle``)."""


class DAG:
    """Nodes with ordered successor and predecessor sets."""

    def __init__(self) -> None:
        self._succ: Dict[Node, Dict[Node, None]] = {}
        self._pred: Dict[Node, Dict[Node, None]] = {}

    @classmethod
    def from_edges(cls, nodes: Iterable[Node],
                   edges: Iterable[Tuple[Node, Node]]) -> "DAG":
        g = cls()
        g.add_nodes_from(nodes)
        for u, v in edges:
            g.add_edge(u, v)
        return g

    @classmethod
    def complete(cls, nodes: Iterable[Node]) -> "DAG":
        """Every ordered pair of distinct nodes as an edge, in node order."""
        nodes = list(nodes)
        return cls.from_edges(nodes, ((a, b) for a in nodes for b in nodes
                                      if a != b))

    def add_node(self, n: Node) -> None:
        if n not in self._succ:
            self._succ[n] = {}
            self._pred[n] = {}

    def add_nodes_from(self, nodes: Iterable[Node]) -> None:
        for n in nodes:
            self.add_node(n)

    def add_edge(self, u: Node, v: Node) -> None:
        self.add_node(u)
        self.add_node(v)
        self._succ[u][v] = None
        self._pred[v][u] = None

    def has_edge(self, u: Node, v: Node) -> bool:
        return u in self._succ and v in self._succ[u]

    def remove_edge(self, u: Node, v: Node) -> None:
        del self._succ[u][v]
        del self._pred[v][u]

    def edges(self) -> List[Tuple[Node, Node]]:
        return [(u, v) for u, succ in self._succ.items() for v in succ]

    def in_degree(self, n: Node) -> int:
        return len(self._pred[n])

    def number_of_edges(self) -> int:
        return sum(len(succ) for succ in self._succ.values())

    def find_cycle(self) -> List[Tuple[Node, Node]]:
        """The edges of one directed cycle, as ``networkx.find_cycle(G)``
        returns them: a depth-first edge walk from each unexplored node
        in node order, successors in insertion order; the first edge
        that closes on the active path ends it, and the edges before the
        cycle's first node are dropped. Raises :class:`NoCycle`."""
        explored = set()
        for start in self._succ:
            if start in explored:
                continue
            edges: List[Tuple[Node, Node]] = []
            seen = {start}
            active = {start}
            previous_head = None
            for tail, head in self._edge_dfs(start):
                if head in explored:
                    continue
                if previous_head is not None and tail != previous_head:
                    # backtracked: pop until the path ends at ``tail``
                    while True:
                        try:
                            popped = edges.pop()
                        except IndexError:
                            edges = []
                            active = {tail}
                            break
                        active.remove(popped[1])
                        if edges and tail == edges[-1][1]:
                            break
                edges.append((tail, head))
                if head in active:
                    cycle = edges
                    for i, (u, _) in enumerate(cycle):
                        if u == head:
                            return cycle[i:]
                seen.add(head)
                active.add(head)
                previous_head = head
            explored.update(seen)
        raise NoCycle("No cycle found.")

    def _edge_dfs(self, start: Node) -> Iterator[Tuple[Node, Node]]:
        """Every edge reachable from ``start`` once, depth first, in
        successor order (``networkx.edge_dfs``)."""
        visited_edges = set()
        visited_nodes = set()
        iters: Dict[Node, Iterator[Node]] = {}
        stack = [start]
        while stack:
            node = stack[-1]
            if node not in visited_nodes:
                iters[node] = iter(list(self._succ[node]))
                visited_nodes.add(node)
            nxt = next(iters[node], None)
            if nxt is None:
                stack.pop()
                continue
            if (node, nxt) not in visited_edges:
                visited_edges.add((node, nxt))
                stack.append(nxt)
                yield node, nxt

    def is_directed_acyclic_graph(self) -> bool:
        try:
            self.find_cycle()
        except NoCycle:
            return True
        return False

    def __len__(self) -> int:
        return len(self._succ)

    def __iter__(self) -> Iterator[Node]:
        return iter(self._succ)

    def __contains__(self, n: Node) -> bool:
        return n in self._succ

    def successors(self, n: Node) -> List[Node]:
        return list(self._succ[n])

    def predecessors(self, n: Node) -> List[Node]:
        return list(self._pred[n])

    def in_edges(self, n: Node) -> List[Tuple[Node, Node]]:
        return [(p, n) for p in self._pred[n]]

    def all_simple_paths(self, source: Node, target: Node,
                         cutoff: Optional[int] = None) -> Iterator[List[Node]]:
        """Paths from ``source`` to ``target`` with no repeated node and
        at most ``cutoff`` edges, depth first in edge order."""
        limit = len(self) - 1 if cutoff is None else cutoff
        if limit < 1 or source not in self or target not in self:
            return
        path = [source]

        def walk(node: Node) -> Iterator[List[Node]]:
            for nxt in self._succ[node]:
                if nxt in path:
                    continue
                if nxt == target:
                    yield path + [nxt]
                elif len(path) < limit:
                    path.append(nxt)
                    yield from walk(nxt)
                    path.pop()

        yield from walk(source)

    def lexicographical_topological_sort(
            self, key: Optional[Callable[[Node], object]] = None) -> List[Node]:
        """Kahn's algorithm over a heap of ``(key(n), insertion index, n)``
        — networkx's tie-breaking."""
        if key is None:
            def key(n):
                return n
        index = {n: i for i, n in enumerate(self._succ)}
        indegree = {n: len(p) for n, p in self._pred.items() if p}
        ready = [(key(n), index[n], n) for n, p in self._pred.items() if not p]
        heapq.heapify(ready)
        order: List[Node] = []
        while ready:
            _, _, node = heapq.heappop(ready)
            for child in self._succ[node]:
                indegree[child] -= 1
                if indegree[child] == 0:
                    heapq.heappush(ready, (key(child), index[child], child))
                    del indegree[child]
            order.append(node)
        if indegree:
            raise ValueError("graph contains a cycle")
        return order
