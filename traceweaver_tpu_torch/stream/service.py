"""The streaming reconstruction service (mirrors
``traceweaver_tpu/stream/service.py``).

Wires source -> watermark -> windowing -> micro-batch scheduler (fleet
solve) -> stitching and emission, with carried per-service state,
periodic checkpoints and a stats surface.

The inner loop is the fleet path: each sealed window contributes one
``FleetItem`` per solvable service and a micro-batch of windows rides
one :func:`~traceweaver_tpu_torch.algorithms.fleet.solve_fleet` call on
the service's device, so on the card every micro-batch launches K1 (the
fused Sinkhorn, rounding and top-k kernel) and the block-assembly
kernel through the fleet's pipelined flows. The JAX package prints the
XLA compiles of each micro-batch; the port compiles nothing at run time,
so its verbose line and summary give each micro-batch's K1 and assembly
launches instead (``ops/cuda_sinkhorn.LAUNCHES``, ``ops/scores.LAUNCHES``).

The JAX package's knobs are constructor arguments: ``precision``
(``TW_PRECISION``), ``confidence`` (``TW_CONFIDENCE``), ``plan_cache``
(``TW_PLAN_CACHE``), ``adapt`` (``TW_ADAPT``: None, the default, is off;
an :class:`~traceweaver_tpu_torch.adapt.AdaptationController` carries
``TW_ADAPT_COOLDOWN_S``, ``TW_ADAPT_PROBATION`` and ``TW_ADAPT_LOW_RATE``)
and ``drift_window`` (``TW_CONF_DRIFT_WINDOW``); ``device=None`` means
the card and raises without one.

The drift-to-adapt ladder (:mod:`traceweaver_tpu_torch.adapt`) acts on
the drift watcher: a drifting service's retained window is refitted out
of band between pumps (:meth:`StreamingReconstructor.maybe_adapt`, one
``solve_fleet`` call of its own on the service's device), and a service
on the fallback rung solves under wide priors. A source that knows its
capture loss (a ``collector:`` source) or the serve tier's capture
ledger (``capture_quality_ext``) discounts every emitted confidence by
``1 - loss_rate`` and adds a ``capture`` block to the summary; the drift
watcher reads the undiscounted records, so capture loss never walks the
ladder. Not ported: the AOT warmup ledger and the per-record emission
path (``TW_WIRE_COLUMNAR=0``: the same bytes).
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from traceweaver_tpu_torch import adapt as _adapt
from traceweaver_tpu_torch.algorithms.plancache import PlanCache, admissible
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs import quality as _quality
from traceweaver_tpu_torch.obs import selftrace as _selftrace
from traceweaver_tpu_torch.obs.registry import stream_families
from traceweaver_tpu_torch.ops.precision import validate_precision
from traceweaver_tpu_torch.runtime import faults
from traceweaver_tpu_torch.spans import NA, SKIP, Span, SpanArray
from traceweaver_tpu_torch.stream.checkpoint import load_checkpoint, save_checkpoint
from traceweaver_tpu_torch.stream.scheduler import MicroBatchScheduler
from traceweaver_tpu_torch.stream.state import CarriedState, LiveTraceStore, StreamGrader
from traceweaver_tpu_torch.stream.watermark import WatermarkTracker
from traceweaver_tpu_torch.stream.window import WindowBuffer, WindowingEngine

# registry mirrors: every _bump also lands in the ledger family with its
# stats key as a label
_OBS = stream_families()
_OBS_STREAM = _OBS["ledger"]
_OBS_SOLVE_S = _OBS["solve_s"]
_OBS_SEAL_EMIT_S = _OBS["seal_emit_s"]
_OBS_SLO_BREACH = _OBS["slo_breach"]


@dataclass
class StreamConfig:
    """Streaming settings (all event-time values in microseconds)."""

    window_us: float = 60e6        # event-time window size
    overlap_us: float = 5e6        # shared margin between windows
    ooo_bound_us: float = 2e6      # watermark out-of-order allowance
    grace_us: float = 0.0          # allowed lateness past the watermark
    max_pending: int = 4           # in-flight sealed-window bound
    spill_max: int = 64            # spill queue bound (backpressure)
    warm_start: bool = True        # carry per-service dists between windows
    grade: bool = True             # ground-truth grading (replay only)
    checkpoint_path: Optional[str] = None
    checkpoint_every: int = 8      # emitted windows between checkpoints
    verbose: bool = True
    # seal→emit p99 SLO (ms): each excursion above it is counted and
    # evented (``slo_breaches``); None counts nothing
    slo_p99_ms: Optional[float] = None
    # dead-letter sidecar for poison windows (default
    # <sink>.deadletter.jsonl when a sink is set), the micro-batch
    # watchdog and its retry budget
    deadletter_path: Optional[str] = None
    solve_watchdog_s: Optional[float] = None
    solve_retries: int = 1


class TraceSink:
    """Append-only JSONL sink with a byte offset the checkpoints record.

    ``truncate(offset)`` rewinds to a checkpointed offset on resume, so
    re-solved windows re-emit over their earlier bytes.
    """

    def __init__(self, path: str) -> None:
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a+b")
        self._f.seek(0, os.SEEK_END)
        self.offset = self._f.tell()

    def write_line(self, line: str) -> None:
        self.write_lines([line])

    def write_lines(self, lines: List[str]) -> None:
        """One buffered write and one flush for a micro-batch's records."""
        if not lines:
            return
        data = "".join(line + "\n" for line in lines).encode("utf-8")
        self._f.write(data)
        self._f.flush()
        self.offset += len(data)

    def truncate(self, offset: int) -> None:
        self._f.truncate(offset)
        self._f.seek(offset)
        self.offset = offset

    def close(self) -> None:
        self._f.close()


@dataclass
class _WindowProblem:
    """One (window, service) solve request and its decode context;
    ``in_cols``/``out_cols`` are the sorted partitions' columns, handed to
    the fleet's packer."""

    service: str
    in_ep: str
    in_spans: List[Span]
    out_parts: Dict[str, List[Span]]
    truth: Dict[str, Dict]
    dag: object
    in_cols: object = None
    out_cols: object = None


@dataclass
class WindowResult:
    """One solved window ready for emission, or a poison window (its
    solve exhausted the supervisor or the watchdog) to dead-letter."""

    buf: WindowBuffer
    assignments: Dict[str, Dict[str, Dict]]  # svc -> ep -> {in: out}
    problems: List[_WindowProblem]
    traces: Dict[str, List]
    accuracy: Optional[float]
    n_rows: int = 0
    solve_share_s: float = 0.0
    poisoned: bool = False
    poison_reason: str = ""
    quarantined_services: Tuple[str, ...] = ()
    # svc -> {in span id: confidence record} (obs/quality.py)
    confidence: Optional[Dict[str, Dict]] = None


def _sid(span_id) -> List[str]:
    return [span_id[0], span_id[1]]


def _launch_counts() -> Dict[str, int]:
    """The kernels' launch counters (K1, K2, the assembly kernel)."""
    from traceweaver_tpu_torch.ops import cuda_sinkhorn, scores

    return dict(fused_assign=cuda_sinkhorn.LAUNCHES["fused_assign"],
                sinkhorn=cuda_sinkhorn.LAUNCHES["sinkhorn"],
                assemble_block=scores.LAUNCHES["assemble_block"])


class StreamingReconstructor:
    """Consume an unbounded span stream, emit stitched traces per window.

    ``device=None`` means the card and raises without one (tests pass
    ``device="cpu"``); ``precision`` is the score blocks' (``"f32"`` or
    ``"bf16"``), ``confidence=False`` turns the confidence records, the
    ``tw.confidence`` payload and the drift watcher off, and
    ``plan_cache=False`` refits every window's carried statistics.
    ``adapt`` (an :class:`~traceweaver_tpu_torch.adapt.AdaptationController`,
    None for off) arms the drift-to-adapt ladder; it needs the confidence
    records and is ignored without them. ``drift_window`` is the drift
    watcher's reference and rolling window (spans a key)."""

    def __init__(self, source, cfg: Optional[StreamConfig] = None,
                 sink: Optional[TraceSink] = None, device=None,
                 precision: str = "f32", confidence: bool = True,
                 plan_cache: bool = True, adapt=None,
                 drift_window: int = _quality.DRIFT_WINDOW) -> None:
        from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device

        self.device = resolve_device(device)
        self.precision = validate_precision(precision)
        self.source = source
        self.cfg = cfg or StreamConfig()
        self.sink = sink
        c = self.cfg
        self.watermark = WatermarkTracker(bound_us=c.ooo_bound_us)
        self.windower = WindowingEngine(
            c.window_us, overlap_us=c.overlap_us, grace_us=c.grace_us)
        self.scheduler = MicroBatchScheduler(
            self._solve_batch, max_pending=c.max_pending,
            spill_max=c.spill_max, watchdog_s=c.solve_watchdog_s,
            solve_retries=c.solve_retries, poison_fn=self._poison_batch)
        # dead-letter sidecar: the sink's offset/truncate resume rules, so
        # a kill/resume never records a poison window twice or loses one
        dlq_path = c.deadletter_path or (
            sink.path + ".deadletter.jsonl" if sink is not None else None)
        self.deadletter = TraceSink(dlq_path) if dlq_path else None
        self.live = LiveTraceStore()
        self.carried = CarriedState()
        self.grader = StreamGrader() if c.grade else None
        self.consumed = 0
        self.emitted_windows = 0
        self.stats: Dict[str, float] = {}
        self.fleet_stats: Dict[str, float] = {}
        self._since_checkpoint = 0
        # self-trace window keys are "<prefix><window k>"
        self.trace_prefix = ""
        self.confidence = bool(confidence)
        self.drift = (_quality.ConfidenceDrift(window=drift_window)
                      if self.confidence else None)
        # the drift-to-adapt controller acts on the drift watcher, so it
        # needs it: no signal, no control
        self.adapt = adapt if self.drift is not None else None
        # a cache hit skips the per-micro-batch refit of the carried
        # statistics; it rides the checkpoint, so a resumed run makes the
        # same refit-or-skip decisions as an uninterrupted one. The
        # controller's actuations invalidate exactly the drifting service
        self.plan_cache = PlanCache(enabled=plan_cache)
        if self.adapt is not None:
            self.adapt.invalidate_cb = self._plan_invalidate
        # per service, the most recently solved window problem: the
        # material of an out-of-band refit (bounded, one a service; it
        # regenerates after a resume and never rides a checkpoint)
        self.adapt_material: Dict[str, _WindowProblem] = {}
        # the serve tier's capture ledger of a tenant that posted captures
        # (a collector source reports its own): None is inert
        self.capture_quality_ext = None
        self._slo_breached = False
        # recent seal→emit latencies (s), the p99 the SLO is held to
        self.seal_emit_lat_s = deque(maxlen=512)

    # -- per-window problem construction ----------------------------------
    def _window_problems(self, buf: WindowBuffer) -> List[_WindowProblem]:
        from traceweaver_tpu_torch.ingest.order import infer_dag_from_predictions
        from traceweaver_tpu_torch.metrics import get_ground_truth

        by_service: Dict[str, Tuple[List[Span], List[Span]]] = {}
        for span in buf.spans:
            svc = self.live.service_of(span)
            if svc is None or span.span_kind not in ("server", "client"):
                self._bump("unresolved_spans")
                continue
            ins, outs = by_service.setdefault(svc, ([], []))
            (ins if span.span_kind == "server" else outs).append(span)

        problems = []
        for svc in sorted(by_service):
            ins, outs = by_service[svc]
            if not outs:
                continue  # leaf service: nothing to reconstruct
            in_parts: Dict[str, List[Span]] = {}
            for s in ins:
                ep = self.live.parent_service_of(s)
                if ep is None:
                    self._bump("unresolved_spans")
                    continue
                in_parts.setdefault(ep, []).append(s)
            out_parts: Dict[str, List[Span]] = {}
            for s in outs:
                ep = self.live.child_service_of(s)
                if ep is None:
                    self._bump("unresolved_spans")
                    continue
                out_parts.setdefault(ep, []).append(s)
            if len(in_parts) != 1 or not out_parts:
                # the batch executor's skip rule for service problems
                self._bump("skipped_service_windows")
                continue
            # the partition sort and the column build in one move: one
            # lexsort over the float columns a partition, the span lists
            # reordered by the same permutation
            in_cols = None
            out_cols = {}
            for parts, is_in in ((in_parts, True), (out_parts, False)):
                for ep, part in parts.items():
                    arr = SpanArray.from_spans(part)
                    order = np.lexsort((arr.end, arr.start))
                    if not np.array_equal(order, np.arange(len(part))):
                        parts[ep] = part = [part[i] for i in order]
                        arr = arr.take(order)
                    if is_in:
                        in_cols = arr
                    else:
                        out_cols[ep] = arr
            (in_ep, in_spans), = in_parts.items()
            truth = get_ground_truth(in_parts, out_parts)
            # strict (tol=0) pruning over the window's truth gives the
            # batch path's ground-truth DAG and tolerates split traces
            dag = infer_dag_from_predictions(
                in_parts, out_parts, truth, self.live, tol=0.0)
            problems.append(_WindowProblem(
                service=svc, in_ep=in_ep, in_spans=in_spans,
                out_parts=out_parts, truth=truth, dag=dag,
                in_cols=in_cols, out_cols=out_cols))
        return problems

    # -- solve ------------------------------------------------------------
    def prepare_batch_items(self, bufs: List[WindowBuffer], tenant=None):
        """The fleet items of a micro-batch: ``(per_buf, items, owners)``,
        the per-window problem lists, the flat ``FleetItem`` list and each
        item's window index. ``tenant`` tags the items with their tenant
        (the serve tier merges several tenants' batches into one shared
        ``solve_fleet`` call); the stream leaves it None."""
        from traceweaver_tpu_torch.algorithms.fleet import FleetItem

        per_buf: List[List[_WindowProblem]] = []
        items, owners = [], []
        for b, buf in enumerate(bufs):
            probs = self._window_problems(buf)
            per_buf.append(probs)
            for wp in probs:
                warm = (self.carried.get(wp.service)
                        if self.cfg.warm_start else None)
                if self.adapt is not None:
                    # the fallback rung: wide priors in place of the
                    # (possibly poisoned) carried statistics
                    warm = self.adapt.warm_dists(
                        self.trace_prefix + wp.service, warm)
                items.append(FleetItem(
                    wp.service, {wp.in_ep: wp.in_spans}, wp.out_parts,
                    wp.truth, wp.dag, store=self.live, warm_dists=warm,
                    in_cols=wp.in_cols, out_cols=wp.out_cols, tenant=tenant,
                    # the fleet's pack thread and flow workers stamp this
                    # window's self-trace through the item
                    trace_key=self._trace_key(buf.k)))
                owners.append(b)
        return per_buf, items, owners

    def _solve_batch(self, bufs: List[WindowBuffer]) -> List[WindowResult]:
        from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

        t0 = time.perf_counter()
        per_buf, items, owners = self.prepare_batch_items(bufs)
        outs = []
        quarantined: List[int] = []
        confidences: Optional[List[Optional[Dict]]] = (
            [None] * len(items) if self.confidence else None)
        if items:
            before = _launch_counts()
            outs = solve_fleet(items, all_spans=self.live.all_spans,
                               all_processes=self.live.all_processes,
                               stats=self.fleet_stats,
                               precision=self.precision,
                               quarantined=quarantined,
                               confidences=confidences,
                               faults=faults.active(), device=self.device)
            after = _launch_counts()
            k1 = after["fused_assign"] - before["fused_assign"]
            asm = after["assemble_block"] - before["assemble_block"]
            self._bump("micro_batches")
            self._bump("fused_assign_launches", k1)
            self._bump("assemble_block_launches", asm)
            if self.cfg.verbose:
                print("[stream] micro-batch %d [%s]: %d windows, %d items, "
                      "%d K1 launches, %d assembly launches"
                      % (self.stats["micro_batches"], self.precision,
                         len(bufs), len(items), k1, asm))
        solve_s = time.perf_counter() - t0
        self._bump("solve_s", solve_s)
        _OBS_SOLVE_S.observe(solve_s)
        return self.consume_batch_results(bufs, per_buf, owners, outs,
                                          quarantined, solve_s,
                                          confidences=confidences)

    def consume_batch_results(self, bufs: List[WindowBuffer], per_buf,
                              owners: List[int], outs,
                              quarantined: List[int], solve_s: float,
                              confidences=None) -> List[WindowResult]:
        """Decode one micro-batch's fleet results into
        :class:`WindowResult`\\ s, fold them into the carried statistics,
        the plan cache and the grader (quarantined items excepted), and
        stitch each window's traces. Host time lands in ``consume_s``."""
        from traceweaver_tpu_torch.algorithms import timing

        t_consume = time.perf_counter()
        results: List[WindowResult] = []
        by_buf_outs: List[List] = [[] for _ in bufs]
        by_buf_idx: List[List[int]] = [[] for _ in bufs]
        for idx, (b, out) in enumerate(zip(owners, outs)):
            by_buf_outs[b].append(out)
            by_buf_idx[b].append(idx)
        qset = set(quarantined)
        total_rows = max(1, sum(len(wp.in_spans)
                                for probs in per_buf for wp in probs))
        for buf, probs, buf_outs, buf_idx in zip(bufs, per_buf, by_buf_outs,
                                                 by_buf_idx):
            assignments: Dict[str, Dict[str, Dict]] = {}
            conf_by_svc: Dict[str, Dict] = {}
            n_rows = 0
            quarantined_svcs = tuple(
                wp.service for wp, idx in zip(probs, buf_idx) if idx in qset)
            for wp, out, idx in zip(probs, buf_outs, buf_idx):
                amap = out[0]
                assignments[wp.service] = amap
                n_rows += len(wp.in_spans)
                if confidences is not None and confidences[idx]:
                    conf_by_svc[wp.service] = confidences[idx]
                if idx in qset:
                    # an all-NA quarantined result warms nothing and is
                    # not graded: the window is dead-lettered
                    continue
                if self.adapt is not None:
                    self.adapt_material[wp.service] = wp
                akey = self.trace_prefix + wp.service
                on_fallback = (self.adapt is not None
                               and self.adapt.fallback_active(akey))
                in_excursion = (self.drift is not None
                                and self.drift.in_excursion(akey))
                if self.cfg.warm_start and (
                        on_fallback or in_excursion
                        or self.plan_cache.lookup(wp.service) is None):
                    # a hit means the carried plan is current; a service
                    # on the fallback rung re-teaches every window (what
                    # earns its restore), one in a drift excursion keeps
                    # refitting, and only a fit from a full window of
                    # evidence is admitted
                    t_fit = time.perf_counter()
                    dists = timing.refit_from_assignments(
                        {wp.in_ep: wp.in_spans}, wp.out_parts, wp.dag,
                        amap, self.live.all_spans, device=self.device)
                    self.carried.update(wp.service, dists)
                    self._bump("plan_fit_s", time.perf_counter() - t_fit)
                    if admissible(len(wp.in_spans)):
                        self.plan_cache.admit(wp.service, dists)
                if self.grader is not None and not quarantined_svcs:
                    owned = [s for s in wp.in_spans
                             if s.GetId() in buf.owned_ids]
                    self.grader.accumulate(wp.service, wp.in_ep, owned,
                                           wp.out_parts, amap)
            poisoned = bool(quarantined_svcs)
            acc = (self._window_accuracy(buf, probs, assignments)
                   if self.cfg.grade and not poisoned else None)
            results.append(WindowResult(
                buf=buf, assignments=assignments, problems=probs,
                traces=self._stitch(buf, assignments),
                accuracy=acc, n_rows=n_rows,
                solve_share_s=solve_s * n_rows / total_rows,
                poisoned=poisoned,
                poison_reason=("quarantined service(s): %s"
                               % ", ".join(quarantined_svcs)
                               if poisoned else ""),
                quarantined_services=quarantined_svcs,
                confidence=conf_by_svc or None))
        self._bump("consume_s", time.perf_counter() - t_consume)
        return results

    def _poison_batch(self, bufs: List[WindowBuffer],
                      err: Optional[BaseException]) -> List[WindowResult]:
        """Dead-letter constructor of a micro-batch that exhausted the
        scheduler's watchdog and retries: every window becomes a counted
        poison window instead of aborting the stream."""
        reason = f"{type(err).__name__}: {err}" if err else "solve failed"
        return [WindowResult(
            buf=buf, assignments={}, problems=[], traces={}, accuracy=None,
            poisoned=True, poison_reason=reason) for buf in bufs]

    def _window_accuracy(self, buf: WindowBuffer,
                         probs: List[_WindowProblem],
                         assignments) -> Optional[float]:
        """Fraction of the window's owned incoming spans whose service
        got every endpoint right."""
        total = correct = 0
        for wp in probs:
            amap = assignments.get(wp.service, {})
            for s in wp.in_spans:
                if s.GetId() not in buf.owned_ids:
                    continue
                total += 1
                ok = True
                for ep in wp.out_parts:
                    truth = wp.truth.get(ep, {}).get(s.GetId(), SKIP)
                    if amap.get(ep, {}).get(s.GetId(), NA) != truth:
                        ok = False
                        break
                correct += int(ok)
        return correct / total if total else None

    # -- stitching --------------------------------------------------------
    def _stitch(self, buf: WindowBuffer, assignments) -> Dict[str, List]:
        """Predicted traces from the window's owned roots: follow each
        service's predicted outgoing span to its server half downstream,
        through the window's assignments.

        One shared traversal interns every reachable node and its edges
        into CSR arrays, then one numpy BFS advances all roots' frontiers
        at once over ``(roots, nodes)`` boolean masks, so a subgraph that
        many roots reach is walked once. Collected ids are sorted at the
        end, so edge and visit order never show in the output."""
        t0 = time.perf_counter()
        traces = self._stitch_arrays(buf.roots, assignments)
        self._bump("stitch_s", time.perf_counter() - t0)
        return traces

    def _stitch_arrays(self, roots: List[Span], assignments) -> Dict[str, List]:
        if not roots:
            return {}
        idx: Dict = {}          # span id -> node index
        table: List = []        # node index -> span id
        span_of: Dict[int, Span] = {}

        def intern(sid) -> int:
            j = idx.get(sid)
            if j is None:
                j = len(table)
                idx[sid] = j
                table.append(sid)
            return j

        root_js: List[int] = []
        work: List[int] = []
        for s in roots:
            j = intern(s.GetId())
            root_js.append(j)
            if j not in span_of:
                span_of[j] = s
                work.append(j)
        # a node's outgoing edges depend on the node alone, so each is
        # computed once: coll rows are what the node adds to a collected
        # set (predicted out ids, present or not, plus their server
        # children), next rows the server children the walk goes through
        coll_map: Dict[int, List[int]] = {}
        next_map: Dict[int, List[int]] = {}
        while work:
            j = work.pop()
            span = span_of[j]
            by_ep = assignments.get(self.live.service_of(span))
            if not by_ep:
                continue
            sid = span.GetId()
            c_row: List[int] = []
            n_row: List[int] = []
            for ep_map in by_ep.values():
                out_id = ep_map.get(sid)
                if not isinstance(out_id, tuple) or out_id in (NA, SKIP):
                    continue
                c_row.append(intern(out_id))
                out_span = self.live.all_spans.get(out_id)
                if out_span is None:
                    continue
                for child_id in out_span.children_spans:
                    child = self.live.all_spans.get(child_id)
                    if child is not None and child.span_kind == "server":
                        cj = intern(child.GetId())
                        c_row.append(cj)
                        n_row.append(cj)
                        if cj not in span_of:
                            span_of[cj] = child
                            work.append(cj)
            if c_row:
                coll_map[j] = c_row
            if n_row:
                next_map[j] = n_row
        n = len(table)
        r = len(roots)
        coll_indptr = np.zeros(n + 1, np.int64)
        next_indptr = np.zeros(n + 1, np.int64)
        coll_flat: List[int] = []
        next_flat: List[int] = []
        for j in range(n):
            coll_flat.extend(coll_map.get(j, ()))
            next_flat.extend(next_map.get(j, ()))
            coll_indptr[j + 1] = len(coll_flat)
            next_indptr[j + 1] = len(next_flat)
        coll_cols = np.asarray(coll_flat, np.int64)
        next_cols = np.asarray(next_flat, np.int64)

        def gather(indptr, cols, fr_r, fr_n):
            # every edge out of every frontier node as (row, col) pairs
            counts = indptr[fr_n + 1] - indptr[fr_n]
            total = int(counts.sum())
            if not total:
                return (np.empty(0, np.int64),) * 2
            rows = np.repeat(fr_r, counts)
            cum = np.cumsum(counts)
            offs = np.arange(total, dtype=np.int64) \
                - np.repeat(cum - counts, counts)
            return rows, cols[np.repeat(indptr[fr_n], counts) + offs]

        visited = np.zeros((r, n), bool)
        collected = np.zeros((r, n), bool)
        fr_r = np.arange(r, dtype=np.int64)
        fr_n = np.asarray(root_js, np.int64)
        collected[fr_r, fr_n] = True
        while fr_r.size:
            visited[fr_r, fr_n] = True
            c_rows, c_cols = gather(coll_indptr, coll_cols, fr_r, fr_n)
            if c_rows.size:
                collected[c_rows, c_cols] = True
            n_rows, n_cols = gather(next_indptr, next_cols, fr_r, fr_n)
            if not n_rows.size:
                break
            keep = ~visited[n_rows, n_cols]
            n_rows, n_cols = n_rows[keep], n_cols[keep]
            if not n_rows.size:
                break
            _, uniq = np.unique(n_rows * n + n_cols, return_index=True)
            fr_r, fr_n = n_rows[uniq], n_cols[uniq]
        traces: Dict[str, List] = {}
        for i, span in enumerate(roots):
            traces[span.trace_id] = sorted(
                table[j] for j in np.nonzero(collected[i])[0])
        return traces

    # -- emission ---------------------------------------------------------
    def _deadletter(self, res: WindowResult) -> None:
        """Record a poison window: counted, and one JSONL record in the
        sidecar when one is configured. Every sealed and solved window is
        either emitted or dead-lettered."""
        buf = res.buf
        rec = dict(
            window=buf.k, start_us=buf.start_us, end_us=buf.end_us,
            n_spans=buf.n_spans, n_owned=buf.n_owned,
            reason=res.poison_reason,
            quarantined_services=sorted(res.quarantined_services),
        )
        line = json.dumps(rec, sort_keys=True)
        if self.deadletter is not None:
            self.deadletter.write_line(line)
            self._bump("deadletter_bytes", len(line) + 1)
        elif self.cfg.verbose:
            print("[stream] WARNING: no dead-letter path configured; "
                  "poison window %d counted but not persisted" % buf.k)
        self._bump("deadletter_windows")
        self._bump("deadletter_spans", buf.n_owned)
        tr = _selftrace.active()
        if tr is not None:
            tr.finish(self._trace_key(buf.k))
        self._since_checkpoint += 1
        if self.cfg.verbose:
            print("[stream] win=%d DEAD-LETTERED spans=%d owned=%d (%s)"
                  % (buf.k, buf.n_spans, buf.n_owned, res.poison_reason))

    def _conf_tenant(self) -> str:
        """Tenant label of the quality metrics ("default" here)."""
        return self.trace_prefix.rstrip(":") or "default"

    def _capture_quality(self) -> Optional[Dict]:
        """The capture ledger: a collector source's own
        ``capture_quality()``, else the serve tier's
        ``capture_quality_ext``; None on every other source."""
        fn = getattr(self.source, "capture_quality", None)
        if fn is None:
            fn = self.capture_quality_ext
        return fn() if fn is not None else None

    def window_confidence(self, res: WindowResult) -> Optional[Dict]:
        """The window's ``tw.confidence`` payload: the window summary and
        one summary per stitched trace (the min over its solved spans);
        None without confidence records.

        A captured stream discounts every confidence by ``1 - loss_rate``
        of its capture: a solver that never saw the dropped spans can be
        confident about a wrong containment. The rate and the discount
        ride the payload (``capture``), so consumers can tell solver doubt
        from capture doubt."""
        if not res.confidence:
            return None
        merged: Dict = {}
        for recs in res.confidence.values():
            merged.update(recs)
        out = dict(
            window=_quality.window_confidence_summary(merged),
            traces={tid: _quality.trace_confidence(ids, merged)
                    for tid, ids in sorted(res.traces.items())},
        )
        cap = self._capture_quality()
        if cap is not None:
            rate = float(cap.get("loss_rate", 0.0))
            disc = max(0.0, 1.0 - rate)
            if disc < 1.0:
                for tconf in out["traces"].values():
                    if tconf is not None:
                        tconf["conf"] = round(tconf["conf"] * disc, 4)
                        tconf["mean"] = round(tconf["mean"] * disc, 4)
                w = out["window"]
                for k in ("min", "mean"):
                    if k in w:
                        w[k] = round(w[k] * disc, 4)
            out["capture"] = dict(loss_rate=round(rate, 4),
                                  discount=round(disc, 4))
        return out

    def _observe_confidence(self, res: WindowResult,
                            conf: Optional[Dict]) -> None:
        """Land an emitted window's quality telemetry: per-trace histogram
        and low-confidence counter (from the payload's capture-discounted
        values), and the per-service drift watcher and the adaptation
        ladder (from the raw solver records, so capture loss cannot pass
        for score-model drift and walk the ladder into refits that cannot
        help it)."""
        if conf is None:
            return
        tenant = self._conf_tenant()
        n_low = 0
        for tconf in conf["traces"].values():
            if tconf is not None:
                n_low += _quality.observe_trace(tconf["conf"], tenant)
        if n_low:
            self._bump("low_confidence_traces", n_low)
        if self.drift is not None:
            for svc, recs in sorted(res.confidence.items()):
                vals = [r["conf"] for r in recs.values()]
                key = self.trace_prefix + svc
                stat = self.drift.update(key, vals)
                if self.adapt is not None and vals:
                    # the controller acts on the PSI only once the rolling
                    # window is full (a fresh reference against a handful
                    # of values is sampling noise), and on the window's
                    # low-confidence rate
                    self.adapt.observe(
                        key, psi=stat if self.drift.mature(key) else None,
                        low_rate=sum(v <= _quality.CONF_LOW for v in vals) / len(vals))

    def emit_batch(self, results: List[WindowResult]) -> None:
        """Emit one pump's window results: every record is rendered first
        and the batch lands in one sink write (dead-letter records keep
        their own writes). Wall time lands in ``emit_s``."""
        if not results:
            return
        t0 = time.perf_counter()
        lines: List[str] = []
        for res in results:
            self._emit(res, lines)
        if self.sink is not None:
            self.sink.write_lines(lines)
        self._bump("emit_s", time.perf_counter() - t0)

    def _emit(self, res: WindowResult, batch: List[str]) -> None:
        if res.poisoned:
            self._deadletter(res)
            return
        buf = res.buf
        conf = self.window_confidence(res)
        self._observe_confidence(res, conf)
        if self.sink is not None:
            services = {}
            for wp in res.problems:
                amap = res.assignments.get(wp.service, {})
                eps = {}
                for ep in sorted(wp.out_parts):
                    rows = []
                    for s in wp.in_spans:
                        if s.GetId() not in buf.owned_ids:
                            continue
                        out_id = amap.get(ep, {}).get(s.GetId(), NA)
                        rows.append([_sid(s.GetId()), _sid(out_id)])
                    rows.sort()
                    eps[ep] = rows
                services[wp.service] = eps
            rec = dict(
                window=buf.k, start_us=buf.start_us, end_us=buf.end_us,
                services=services,
                traces={tid: [_sid(x) for x in ids]
                        for tid, ids in sorted(res.traces.items())},
            )
            if conf is not None:
                # every emitted trace carries its confidence, so consumers
                # can leave out low-trust reconstructions
                rec["tw.confidence"] = conf
            batch.append(json.dumps(rec, sort_keys=True))
        self.emitted_windows += 1
        if buf.sealed_wall:
            # the SLO quantity: seal to emission (queue wait, solve, decode)
            lat = max(0.0, time.monotonic() - buf.sealed_wall)
            self.seal_emit_lat_s.append(lat)
            _OBS_SEAL_EMIT_S.observe(lat, tenant=self._conf_tenant())
            self._observe_slo()
        tr = _selftrace.active()
        if tr is not None:
            tr.finish(self._trace_key(buf.k))
        self._since_checkpoint += 1
        self._bump("spans_emitted", buf.n_owned)
        self._bump("traces_emitted", len(res.traces))
        if res.accuracy is not None:
            self.stats["last_window_acc"] = res.accuracy
        if self.cfg.verbose:
            acc = ("%.3f" % res.accuracy) if res.accuracy is not None \
                else "n/a"
            rate = (res.n_rows / res.solve_share_s
                    if res.solve_share_s > 0 else 0.0)
            print(
                "[stream] win=%d prec=%s spans=%d owned=%d traces=%d "
                "svc=%d acc=%s wm_delay=%.2fs late=%d/%d shed=%d "
                "backlog=%d %.1f spans/s"
                % (buf.k, self.precision, buf.n_spans, buf.n_owned,
                   len(res.traces), len(res.problems), acc,
                   buf.seal_delay_us / 1e6,
                   self.windower.late_rerouted, self.windower.late_dropped,
                   self.scheduler.shed_spilled
                   + self.scheduler.shed_dropped_windows,
                   self.scheduler.backlog, rate))

    def _observe_slo(self) -> None:
        """One counted and evented excursion when the rolling seal→emit
        p99 crosses the SLO, re-armed when it falls back under; inert
        without an SLO."""
        slo = self.cfg.slo_p99_ms
        if not slo:
            return
        p99 = self.seal_emit_p99_ms()
        if p99 is None:
            return
        if p99 > slo and not self._slo_breached:
            self._slo_breached = True
            tenant = self._conf_tenant()
            self._bump("slo_breaches")
            _OBS_SLO_BREACH.inc(1.0, tenant=tenant)
            _events.emit("slo_breach", "excursion", tenant=tenant,
                         p99_ms=round(p99, 2), slo_ms=slo)
        elif p99 <= slo:
            self._slo_breached = False

    def maybe_adapt(self) -> int:
        """Run the pending out-of-band refits of the adaptation ladder
        (:mod:`traceweaver_tpu_torch.adapt.refit`), off the hot pump: the
        stream calls it between pumps, the serve tier after a solve
        retires. Returns the refits that landed."""
        if self.adapt is None:
            return 0
        n = 0
        for key in self.adapt.pending_refits():
            if _adapt.refit.execute_refit(self, key):
                n += 1
                self._bump("adapt_refits")
        return n

    def _plan_invalidate(self, key: str) -> None:
        """The controller's actuation hook: a scheduled refit, a fallback
        or a failed refit voids exactly that service's cached plan.
        ``key`` is the controller's (``trace_prefix + service``)."""
        svc = key
        if self.trace_prefix and key.startswith(self.trace_prefix):
            svc = key[len(self.trace_prefix):]
        self.plan_cache.invalidate(svc)

    def _bump(self, key: str, n: float = 1) -> None:
        _OBS_STREAM.inc(n, key=key)
        self.stats[key] = self.stats.get(key, 0) + n

    def seal_emit_p99_ms(self) -> Optional[float]:
        """p99 of the recent seal→emit latencies (ms; None before the
        first emission)."""
        if not self.seal_emit_lat_s:
            return None
        return float(np.percentile(
            np.asarray(self.seal_emit_lat_s, dtype=np.float64), 99)) * 1e3

    # -- self-tracing hooks (no-ops without an installed tracer) ----------
    def _trace_key(self, k: int) -> str:
        return self.trace_prefix + str(k)

    def _trace_touch(self) -> None:
        """First sight of newly opened windows (the ingest stage's start)."""
        tr = _selftrace.active()
        if tr is None:
            return
        for k in self.windower.open:
            tr.touch(self._trace_key(k))

    def _trace_seal(self, sealed) -> None:
        """Sealed windows close their ingest stage and stamp the seal."""
        tr = _selftrace.active()
        if tr is None or not sealed:
            return
        now = _selftrace.now_us()
        for buf in sealed:
            tr.seal(self._trace_key(buf.k), now)

    # -- checkpointing ----------------------------------------------------
    def state_dict(self) -> Dict:
        """Everything a checkpoint holds to rebuild this service: offsets,
        windowing and watermark state (open window buffers included), the
        live span store, carried statistics, the plan cache, the grader
        and every counter. Host objects only: no tensor."""
        return dict(
            cfg=self.cfg,
            precision=self.precision,
            consumed=self.consumed,
            emitted_windows=self.emitted_windows,
            emit_offset=self.sink.offset if self.sink else 0,
            sink_path=self.sink.path if self.sink else None,
            deadletter_offset=(self.deadletter.offset
                               if self.deadletter else 0),
            deadletter_path=(self.deadletter.path
                             if self.deadletter else None),
            watermark=self.watermark,
            windower=self.windower,
            live=self.live,
            carried=self.carried,
            grader=self.grader,
            conf_drift=self.drift.state() if self.drift else None,
            adapt=self.adapt.state() if self.adapt else None,
            plan_cache=self.plan_cache.state(),
            stats=self.stats,
            fleet_stats=self.fleet_stats,
            pending=list(self.scheduler.pending),
            spill=list(self.scheduler.spill),
            scheduler_counters=(self.scheduler.shed_spilled,
                                self.scheduler.shed_dropped_windows,
                                self.scheduler.shed_dropped_spans,
                                self.scheduler.solved_windows,
                                self.scheduler.solve_timeouts,
                                self.scheduler.solve_retried,
                                self.scheduler.poisoned_windows),
        )

    def _checkpoint(self) -> None:
        if not self.cfg.checkpoint_path:
            return
        t0 = time.perf_counter()
        try:
            save_checkpoint(self.cfg.checkpoint_path, self.state_dict())
        except (OSError, RuntimeError) as e:
            if not (isinstance(e, (OSError, faults.FaultError))
                    or faults.is_transient_fault(e)):
                raise
            # the last good generation is still on disk: count, warn and
            # go on (the next cadence retries)
            self._bump("checkpoint_failures")
            if self.cfg.verbose:
                print("[stream] WARNING: checkpoint write failed "
                      "(%s: %s); continuing on the last good checkpoint"
                      % (type(e).__name__, e))
            return
        self._bump("checkpoint_s", time.perf_counter() - t0)
        self._bump("checkpoints")
        self._since_checkpoint = 0

    @classmethod
    def resume(cls, checkpoint_path: str, source,
               sink: Optional[TraceSink] = None, device=None,
               precision: str = "f32", confidence: bool = True,
               plan_cache: bool = True, adapt=None,
               drift_window: int = _quality.DRIFT_WINDOW
               ) -> "StreamingReconstructor":
        """Rebuild a service from its last checkpoint. ``source`` must be
        the deterministic source the killed run used; the sink (the
        checkpoint's when none is given) is truncated back to the
        checkpointed offset, so the resumed run's bytes splice in where
        the checkpoint left off. The checkpointed state is host material
        and precision-independent: resuming under another ``precision``
        or ``device`` is allowed, and said."""
        state = load_checkpoint(checkpoint_path)
        cfg: StreamConfig = state["cfg"]
        cfg.checkpoint_path = checkpoint_path
        if sink is None and state.get("sink_path"):
            sink = TraceSink(state["sink_path"])
        svc = cls(source, cfg, sink=sink, device=device, precision=precision,
                  confidence=confidence, plan_cache=plan_cache, adapt=adapt,
                  drift_window=drift_window)
        ckpt_precision = state.get("precision", "f32")
        if ckpt_precision != svc.precision and cfg.verbose:
            print("[stream] resume: checkpoint was written under "
                  "precision=%s, resuming under %s (carried state is "
                  "precision-independent)" % (ckpt_precision, svc.precision))
        if state.pop("_recovered_from_prev", False):
            # the primary was corrupt and the load fell back to .prev
            state["stats"]["checkpoint_recovered"] = (
                state["stats"].get("checkpoint_recovered", 0) + 1)
        svc.apply_state(state)
        return svc

    def apply_state(self, state: Dict) -> None:
        """Restore a :meth:`state_dict` onto this service, with the sink
        and dead-letter truncation splice."""
        self.consumed = state["consumed"]
        self.emitted_windows = state["emitted_windows"]
        self.watermark = state["watermark"]
        self.windower = state["windower"]
        self.live = state["live"]
        self.carried = state["carried"]
        self.grader = state["grader"]
        if state.get("conf_drift") and self.drift is not None:
            self.drift = _quality.ConfidenceDrift.from_state(state["conf_drift"])
        # the ladder survives a kill: probation counts, active fallbacks,
        # refit generations (cooldowns as remaining durations). A
        # checkpoint without the key keeps the fresh controller, and with
        # adaptation off the state is not restored
        if state.get("adapt") and self.adapt is not None:
            self.adapt = _adapt.AdaptationController.from_state(state["adapt"])
            self.adapt.invalidate_cb = self._plan_invalidate
        if state.get("plan_cache"):
            self.plan_cache = PlanCache.from_state(
                state["plan_cache"], enabled=self.plan_cache.enabled)
        self.stats = state["stats"]
        self.fleet_stats = state["fleet_stats"]
        # seal stamps are monotonic instants of the dead process: re-stamp
        # so the seal→emit latencies do not count the restart gap
        now = time.monotonic()
        for buf in list(state["pending"]) + list(state["spill"]):
            buf.sealed_wall = now
        self.scheduler.pending.extend(state["pending"])
        self.scheduler.spill.extend(state["spill"])
        (self.scheduler.shed_spilled, self.scheduler.shed_dropped_windows,
         self.scheduler.shed_dropped_spans, self.scheduler.solved_windows,
         self.scheduler.solve_timeouts, self.scheduler.solve_retried,
         self.scheduler.poisoned_windows) = state["scheduler_counters"]
        if self.sink is not None:
            self.sink.truncate(state["emit_offset"])
        if self.deadletter is None and state.get("deadletter_path"):
            self.deadletter = TraceSink(state["deadletter_path"])
        if self.deadletter is not None:
            self.deadletter.truncate(state.get("deadletter_offset", 0))

    # -- main loop --------------------------------------------------------
    def run(self, max_windows: Optional[int] = None) -> Dict:
        """Consume the source to exhaustion (or until ``max_windows``
        windows have been emitted, the kill hook) and return the summary.
        A resumed service continues from its checkpointed offset."""
        c = self.cfg
        it = self.source.events(skip=self.consumed)
        while True:
            try:
                # fault site "source": a failed read retries the same
                # position (the draw comes before next())
                faults.maybe_fail(faults.active(), "source")
                ev = next(it)
            except StopIteration:
                break
            except faults.FaultError:
                self._bump("source_read_retries")
                continue
            self.consumed += 1
            self.watermark.observe(ev.event_us)
            span = self.live.add(ev)
            self.windower.add(span, ev.event_us)
            self._trace_touch()
            sealed = self.windower.poll(self.watermark.value)
            self._trace_seal(sealed)
            for buf in sealed:
                self.scheduler.offer(buf)
            if self.scheduler.backlog:
                self.emit_batch(list(self.scheduler.pump()))
                # the refits run between pumps, never inside one
                self.maybe_adapt()
            if sealed:
                # retention horizon: two windows behind the watermark, and
                # never past a window behind the oldest window still
                # waiting, whose spans' parent/child context it needs
                oldest = min((b.start_us for b in self.scheduler.ready()),
                             default=self.watermark.value)
                horizon = min(self.watermark.value - 2 * c.window_us,
                              oldest - c.window_us) - c.grace_us
                self.live.prune(horizon)
            if self._since_checkpoint >= c.checkpoint_every:
                self._checkpoint()
            if max_windows is not None \
                    and self.emitted_windows >= max_windows:
                return self._summary(final=False)
        return self.finish()

    def finish(self) -> Dict:
        """End of stream: seal and solve what is left, emit, take the last
        checkpoint and, when grading, the end-to-end streamed accuracy."""
        flushed = self.windower.flush()
        self._trace_seal(flushed)
        for buf in flushed:
            self.scheduler.offer(buf)
        self.emit_batch(list(self.scheduler.pump()))
        self.maybe_adapt()
        self._checkpoint()
        self.scheduler.close()
        return self._summary(final=True)

    def _summary(self, final: bool) -> Dict:
        fs = self.fleet_stats
        out = dict(
            final=final,
            precision=self.precision,
            device=str(self.device),
            consumed=self.consumed,
            emitted_windows=self.emitted_windows,
            late_rerouted=self.windower.late_rerouted,
            late_dropped=self.windower.late_dropped,
            shed_spilled=self.scheduler.shed_spilled,
            shed_dropped_windows=self.scheduler.shed_dropped_windows,
            shed_dropped_spans=self.scheduler.shed_dropped_spans,
            deadletter_windows=int(self.stats.get("deadletter_windows", 0)),
            deadletter_spans=int(self.stats.get("deadletter_spans", 0)),
            deadletter_bytes=int(self.stats.get("deadletter_bytes", 0)),
            launches=dict(
                fused_assign=int(self.stats.get("fused_assign_launches", 0)),
                assemble_block=int(self.stats.get("assemble_block_launches", 0))),
            faults=dict(
                retries=int(fs.get("fault_retries", 0)),
                bisections=int(fs.get("fault_bisections", 0)),
                host_fallbacks=int(fs.get("fault_host_fallbacks", 0)),
                quarantined=int(fs.get("fault_quarantined", 0)),
                injected=int(fs.get("faults_injected", 0)),
                solve_timeouts=self.scheduler.solve_timeouts,
                solve_retried=self.scheduler.solve_retried,
                poisoned_windows=self.scheduler.poisoned_windows,
                checkpoint_failures=int(self.stats.get("checkpoint_failures", 0)),
                checkpoint_recovered=int(self.stats.get("checkpoint_recovered", 0)),
                source_read_retries=int(self.stats.get("source_read_retries", 0)),
            ),
            pruned_spans=self.live.n_pruned,
            watermark_max_skew_us=self.watermark.max_skew_us,
            confidence=dict(
                enabled=self.drift is not None,
                low_traces=int(self.stats.get("low_confidence_traces", 0)),
                drift_alerts=self.drift.alerts if self.drift else 0,
            ),
            adapt=(self.adapt.summary() if self.adapt is not None
                   else dict(enabled=False)),
            plan_cache=self.plan_cache.counters(),
            slo_breaches=int(self.stats.get("slo_breaches", 0)),
            stats=dict(self.stats),
            fleet=dict(fs),
            pipeline=dict(
                groups=int(fs.get("pipeline_groups", 0)),
                depth=int(fs.get("pipeline_depth", 0)),
                d2h_bytes_fetched=float(fs.get("d2h_bytes_fetched", 0.0)),
                d2h_bytes_flags=float(fs.get("d2h_bytes_flags", 0.0)),
                h2d_bytes_shipped=float(fs.get("h2d_bytes_shipped", 0.0)),
            ),
            seal_emit_p99_ms=self.seal_emit_p99_ms(),
        )
        cap = self._capture_quality()
        if cap is not None:
            # the capture ledger: loss and churn per source and the fitted
            # skew offsets, only when the stream is a capture
            out["capture"] = cap
        if final and self.grader is not None:
            out["accuracy"] = self.grader.finish()
        return out
