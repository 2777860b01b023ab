"""CPU reference solver: DFS top-K enumeration + windowed exact MWIS (mirrors
``traceweaver_tpu/algorithms/weaver_exact.py``).

A reimplementation of the reference's TraceWeaver V1/V2 solvers
(reference traceweaver_v1.py:363-527, traceweaver_v2.py:32-179) with the
Gurobi ILP replaced by the exact branch-and-bound MWIS of
:mod:`traceweaver_tpu_torch.algorithms.mwis`: the correctness oracle of
the windowed solver on small windows, and predictor indices 0-2
(``MaxScoreBatch`` / ``MaxScoreBatchParallel`` / ``MaxScore``).

Methods:
- ``MaxScore`` — per-span greedy argmax DFS, consuming spans on assignment
  (V1 semantics, traceweaver_v1.py:490-527);
- ``MaxScoreBatch`` / ``MaxScoreBatchParallel`` — top-K=5 candidate heaps
  per span; every 30 spans, a conflict graph over candidates is solved as
  exact MWIS (V2 semantics, traceweaver_v2.py:113-179; node weight
  10000+score as in traceweaver_v2.py:205).
"""

from __future__ import annotations

import heapq
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.stats

from traceweaver_tpu_torch.algorithms.mwis import exact_mwis
from traceweaver_tpu_torch.algorithms.timing import batch_means_params
from traceweaver_tpu_torch.metrics.accuracy import get_out_eps_in_order
from traceweaver_tpu_torch.spans import NA, Span

BATCH_SIZE_DIST = 100
BATCH_SIZE_MIS = 30
TOP_K = 5
MIS_WEIGHT_OFFSET = 10000.0


class WeaverExact:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes
        self.services_times: Dict[Tuple[str, str], Tuple[float, float]] = {}
        self.parallel = False
        self.instrumented_hops: List[int] = []
        self.true_assignments = None
        self.per_span_candidates: Dict = {}

    # -- distribution estimation (traceweaver_v1.py:47-108) ---------------
    def _estimate_dists(self, in_span_partitions, out_span_partitions,
                        out_eps, lo, hi):
        in_ep = next(iter(in_span_partitions))

        def est(ep1, ep2, t1, t2):
            mean, std = batch_means_params(sorted(t1)[lo:hi], sorted(t2)[lo:hi])
            self.services_times[(ep1, ep2)] = (mean, std)

        in_starts = [s.start_mus for s in in_span_partitions[in_ep]]
        in_ends = [s.end_mus for s in in_span_partitions[in_ep]]
        if self.parallel:
            for ep in out_eps:
                est(in_ep, ep, in_starts,
                    [s.start_mus for s in out_span_partitions[ep]])
        else:
            est(in_ep, out_eps[0], in_starts,
                [s.start_mus for s in out_span_partitions[out_eps[0]]])
            for a, b in zip(out_eps, out_eps[1:]):
                est(a, b, [s.end_mus for s in out_span_partitions[a]],
                    [s.start_mus for s in out_span_partitions[b]])
            est(out_eps[-1], in_ep,
                [s.end_mus for s in out_span_partitions[out_eps[-1]]], in_ends)

    def _edge_cost(self, ep1, ep2, t1, t2) -> float:
        mean, std = self.services_times[(ep1, ep2)]
        if std < 1e-12:
            std = 0.001
        return float(scipy.stats.norm.logpdf(t2 - t1, loc=mean, scale=std))

    # -- assignment scoring (traceweaver_v1.py:196-243) --------------------
    def _score_sequential(self, in_span, in_ep, out_eps, stack) -> float:
        cost = 0.0
        prev_ep, prev_t = in_ep, in_span.start_mus
        for ep, span in zip(out_eps, stack):
            cost += self._edge_cost(prev_ep, ep, prev_t, span.start_mus)
            prev_ep, prev_t = ep, span.end_mus
        cost += self._edge_cost(prev_ep, in_ep, prev_t, in_span.end_mus)
        return cost

    def _score_parallel(self, in_span, in_ep, out_eps, stack) -> float:
        return sum(
            self._edge_cost(in_ep, ep, float(in_span.start_mus), float(span.start_mus))
            for ep, span in zip(out_eps, stack)
        )

    # -- DFS top-K enumeration (traceweaver_v2.py:32-100) ------------------
    def _topk_assignments(self, in_span, in_ep, out_eps, out_span_partitions,
                          k) -> List[Tuple[float, List[Span]]]:
        heap: List[Tuple[float, int, List[Span]]] = []
        counter = [0]

        def dfs(stack: List[Span]):
            depth = len(stack)
            if depth == len(out_eps):
                self.per_span_candidates[in_span.GetId()] = (
                    self.per_span_candidates.get(in_span.GetId(), 0) + 1
                )
                score = (self._score_parallel(in_span, in_ep, out_eps, stack)
                         if self.parallel else
                         self._score_sequential(in_span, in_ep, out_eps, stack))
                counter[0] += 1
                heapq.heappush(heap, (score, counter[0], list(stack)))
                if len(heap) > k:
                    heapq.heappop(heap)
                return
            ep = out_eps[depth]
            last_end = (in_span.start_mus if depth == 0 or self.parallel
                        else stack[-1].end_mus)
            for s in out_span_partitions[ep]:
                if s.start_mus < in_span.start_mus:
                    continue
                if s.start_mus > in_span.end_mus:
                    break  # partitions sorted by start
                if s.end_mus > in_span.end_mus:
                    continue
                if not self.parallel and s.start_mus < last_end:
                    continue
                dfs(stack + [s])

        dfs([])
        return sorted(((sc, st) for sc, _, st in heap), key=lambda x: -x[0])

    # -- windowed MWIS conflict resolution (traceweaver_v2.py:187-241) -----
    @staticmethod
    def _resolve_mis(batch: List[List[Tuple[float, List[Span]]]]):
        adj: Dict[Tuple[int, int], set] = {}
        weight: Dict[Tuple[int, int], float] = {}
        used_by: Dict[Tuple, List[Tuple[int, int]]] = {}
        for i, cands in enumerate(batch):
            for c, (score, stack) in enumerate(cands):
                node = (i, c)
                adj[node] = set()
                weight[node] = MIS_WEIGHT_OFFSET + score
                for c0 in range(c):
                    adj[node].add((i, c0))
                    adj[(i, c0)].add(node)
                for span in stack:
                    used_by.setdefault(span.GetId(), []).append(node)
        for nodes in used_by.values():
            for a in nodes:
                for b in nodes:
                    if a[0] != b[0]:
                        adj[a].add(b)
                        adj[b].add(a)
        if not weight:
            return [None] * len(batch)
        chosen, _ = exact_mwis(adj, weight)
        result: List[Optional[List[Span]]] = [None] * len(batch)
        for (i, c) in chosen:
            result[i] = batch[i][c][1]
        return result

    # -- plugin entry ------------------------------------------------------
    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments, invocation_graph=None):
        assert len(in_span_partitions) == 1
        self.parallel = bool(parallel) or method == "MaxScoreBatchParallel"
        self.instrumented_hops = instrumented_hops
        self.true_assignments = true_assignments
        self.per_span_candidates = {
            key: 0 for ep in out_span_partitions
            for key in true_assignments[ep]
        }

        in_ep, in_spans = next(iter(in_span_partitions.items()))
        out_eps = get_out_eps_in_order(out_span_partitions)
        # working copies consumed as assignments commit
        pool = {ep: list(spans) for ep, spans in out_span_partitions.items()}

        all_assignments: Dict[str, Dict] = {ep: {} for ep in out_eps}
        not_best_count = 0
        cnt_unassigned = 0

        def commit(in_span, stack: Optional[List[Span]]):
            nonlocal cnt_unassigned
            if stack is None:
                for ep in out_eps:
                    all_assignments[ep][in_span.GetId()] = NA
                cnt_unassigned += 1
                return
            for ep, span in zip(out_eps, stack):
                all_assignments[ep][in_span.GetId()] = span.GetId()
                pool[ep].remove(span)

        if method == "MaxScore":
            # V1: per-span greedy argmax, spans consumed immediately
            for cnt, in_span in enumerate(in_spans):
                if cnt % BATCH_SIZE_DIST == 0:
                    self._estimate_dists(
                        in_span_partitions, out_span_partitions, out_eps,
                        cnt, min(len(in_spans), cnt + BATCH_SIZE_DIST))
                top = self._topk_assignments(in_span, in_ep, out_eps, pool, 1)
                commit(in_span, top[0][1] if top else None)
            return all_assignments

        # V2: top-K heaps + windowed exact MWIS
        batch: List[List[Tuple[float, List[Span]]]] = []
        batch_spans: List[Span] = []
        for cnt, in_span in enumerate(in_spans):
            if cnt % BATCH_SIZE_DIST == 0:
                self._estimate_dists(
                    in_span_partitions, out_span_partitions, out_eps,
                    cnt, min(len(in_spans), cnt + BATCH_SIZE_DIST))
            top = self._topk_assignments(in_span, in_ep, out_eps, pool, TOP_K)
            batch.append(top)
            batch_spans.append(in_span)
            if len(batch) == BATCH_SIZE_MIS or cnt == len(in_spans) - 1:
                resolved = self._resolve_mis(batch)
                for in_sp, cands, stack in zip(batch_spans, batch, resolved):
                    if stack is None or not cands:
                        not_best_count += 1
                    elif [s.GetId() for s in cands[0][1]] != [s.GetId() for s in stack]:
                        not_best_count += 1
                    commit(in_sp, stack)
                batch, batch_spans = [], []

        return (all_assignments, not_best_count, len(in_spans),
                self.per_span_candidates)
