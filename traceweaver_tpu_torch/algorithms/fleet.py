"""Fleet solve: every service's windows in one dispatch per shape class
(mirrors ``traceweaver_tpu/algorithms/fleet.py``, single-device).

Window batches of several services are padded to shared ``[B, E, W, M]``
shape classes, each window tagged with ``param_idx``, the row of its
service's DAG-structure and distribution tables; each class runs as one
batch through :func:`~traceweaver_tpu_torch.algorithms.weaver_torch.solve_windows_fleet`,
both EM passes and the batched BIC-GMM refit between them included. So
the number of device solves drops from one per service to one per shape
class.

Dynamism (services with a positive skip budget, the cache-hit workloads)
rides the fleet too, as single-pass groups with bootstrap distributions
and water-filled per-window skip caps; the true-skips oracle ships its
forced rows as per-window force-skip tensors. Items without a DAG, or
with a method the fleet does not carry, fall back to a per-service
:class:`~traceweaver_tpu_torch.algorithms.weaver_torch.WeaverTorch` on
the same device.

Each solve pass runs compacted: a warm dispatch of ``sweep_warm`` sweeps,
a fetch of the ``[B]`` convergence flags alone, and a full redispatch of
only the unconverged windows (padded to a power of two with all-invalid
rows, from sweep 0), scattered back. A reproducing sweep is a
Gauss-Seidel fixed point, so this equals one full dispatch bit for bit
wherever a window's result does not depend on the batch it rides in (on
the CPU always; on the card the kernels' cluster size depends on the
batch size, so the straggler redispatch may sum in another order).

Every group runs under the solve supervisor: a transient failure (see
:func:`traceweaver_tpu_torch.runtime.faults.is_transient_fault`) walks
retry with exponential backoff, then bisection of the group, then the
per-service ``WeaverTorch`` on the same card, then quarantine (an
all-NA result and the item's index recorded). The JAX package's "xla"
rung, a redispatch with the Pallas kernel pinned off, has no
counterpart: the port allows no kernel-free path on the card.

The groups run pipelined by default (:func:`_solve_groups_pipelined`):
one pack thread builds the next group's host tensors while a pool of
``decode_workers`` flow workers each runs one group's dispatch,
compaction round trips, fetch, decode and ladder, each worker on its own
CUDA stream, so one group's host decode overlaps the next group's
device solve. The live-byte budget is the admission gate.
``pipeline=False`` is the serial reference flow; both give the same
output in input order.

A :class:`~traceweaver_tpu_torch.algorithms.plancache.PlanCache` passed
as ``plan_cache`` carries each service's fitted distributions to the
next solve: a hit skips the host fit and runs one warm pass instead of
the two-pass EM (the ``FleetItem.warm_dists`` contract). A list passed
as ``confidences`` receives each item's per-span confidence records
(:mod:`traceweaver_tpu_torch.obs.quality`), reduced from the block the
decode fetched; ``conf_device=True`` adds the margin and entropy
channels to every dispatch.

The JAX package's ``TW_*`` knobs are keyword arguments of
:func:`solve_fleet` with the knobs' defaults. Not ported yet:
device-resident columns, mesh sharding, AOT notes, tenancy and the
self-trace (none of them changes an output).

Every ``_Stats`` update also lands in the metrics registry
(:mod:`traceweaver_tpu_torch.obs.registry`: ``tw_fleet_ledger_total``,
``tw_fleet_gauge``, ``tw_fault_ladder_events_total``), each ladder rung
in the installed event sink, and the dispatch stages run inside
``tw:fleet:*`` profiler ranges (:mod:`traceweaver_tpu_torch.obs.profile`).
"""

from __future__ import annotations

import contextlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from traceweaver_tpu_torch.algorithms import packed_layout as _layout
from traceweaver_tpu_torch.algorithms.plancache import PlanCache
from traceweaver_tpu_torch.algorithms.skips import water_fill_skip_caps
from traceweaver_tpu_torch.algorithms.weaver_torch import (
    DEFAULT_MAX_WINDOW,
    DEFAULT_TOPK,
    WeaverTorch,
    _bucket,
    candidate_ranges,
    dists_from_tables,
    in_columns,
    out_columns,
    pack_problem,
    perfect_cut_windows_cols,
    plan_find_assignments,
    refit_fleet_params,
    resolve_device,
    scatter_window_span_stats,
    solve_em_fleet,
    solve_windows_fleet,
)
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs import profile as _profile
from traceweaver_tpu_torch.obs import quality as _quality
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry
from traceweaver_tpu_torch.ops.precision import validate_precision
from traceweaver_tpu_torch.runtime import faults as _faults
from traceweaver_tpu_torch.spans import NA

#: ``TW_FLEET_BUDGET``: f32 elements of one group's live blocks (score
#: block plus refit samples); a group past it solves per service
FLEET_BUDGET_ELEMS = 1 << 28
#: ``TW_FLEET_MERGE`` by device when not given: padded cells are real
#: core-seconds on the CPU (merge conservatively, as the JAX package does
#: there) and cheap next to a saved dispatch on an accelerator
MERGE_BUDGET = {"cpu": 1 << 20, "cuda": 1 << 24}

# window-axis keys of a packed fleet batch, dispatch argument order
_BATCH_KEYS = ("in_start", "in_end", "in_valid", "out_start", "out_end",
               "out_valid", "skip_cap", "force_skip")
# per-problem tables, dispatch argument order (after the batch keys)
_TABLE_KEYS = ("pred_mask", "root_mask", "is_last",
               "edge_wt", "edge_mu", "edge_sd",
               "in_wt", "in_mu", "in_sd",
               "ret_wt", "ret_mu", "ret_sd")


@dataclass(frozen=True)
class _Run:
    """One solve's settings, handed to every stage (the JAX package's
    ``hypers_common`` plus the knobs it reads at call time)."""

    hypers: Dict            # solve_windows_fleet keywords but n_sweeps
    n_sweeps: int
    device: torch.device
    compaction: bool
    sweep_warm: int
    retry_max: int
    retry_backoff_s: float
    budget_bytes: int
    faults: Optional[_faults.FaultPlan]
    plan_cache: Optional[PlanCache]


# registry mirrors of the stats ledger: every _Stats update also lands
# here, with the dict's key as a label
_OBS = _get_registry()
_OBS_LEDGER = _OBS.counter(
    "tw_fleet_ledger_total",
    "fleet solve ledger mirror (one series per _Stats counter key)",
    labels=("key",))
_OBS_GAUGE = _OBS.gauge(
    "tw_fleet_gauge",
    "fleet high-water marks (_Stats.record_max mirror)",
    labels=("key",))
_OBS_LADDER = _OBS.counter(
    "tw_fault_ladder_events_total",
    "solve-supervisor degradation-ladder rungs walked",
    labels=("key", "rung"))


class _Stats:
    """Lock-guarded accumulator over the caller's stats dict (the
    per-service fallback pool and the solve thread update it together);
    ``d is None`` makes every dict update a no-op. The registry mirror
    and the event sink see every update either way."""

    def __init__(self, d: Optional[Dict[str, float]]):
        self.d = d
        self._lock = threading.Lock()

    def add(self, key: str, val: float = 1.0) -> None:
        _OBS_LEDGER.inc(val, key=key)
        if self.d is None:
            return
        with self._lock:
            self.d[key] = self.d.get(key, 0.0) + val

    def record_max(self, key: str, val: float) -> None:
        _OBS_GAUGE.set_max(val, key=key)
        if self.d is None:
            return
        with self._lock:
            self.d[key] = max(self.d.get(key, 0.0), val)

    def merge(self, other: Dict[str, float]) -> None:
        for k, v in other.items():
            _OBS_LEDGER.inc(v, key=k)
        if self.d is None:
            return
        with self._lock:
            for k, v in other.items():
                self.d[k] = self.d.get(k, 0.0) + v

    def note(self, key: str, event: str) -> None:
        """Append to the ordered event list under ``key`` (the
        supervisor's ``fault_ladder``), count it in the ladder counter
        and emit it to the installed event sink."""
        _OBS_LADDER.inc(1.0, key=key, rung=event)
        _events.emit(key, event)
        if self.d is None:
            return
        with self._lock:
            self.d.setdefault(key, []).append(event)


def _as_stats(stats) -> _Stats:
    return stats if isinstance(stats, _Stats) else _Stats(stats)


def _fault_check(site: str, st: _Stats, plan) -> None:
    """Fault-injection hook, ledgered; no-op without a plan."""
    if plan is None:
        return
    try:
        _faults.maybe_fail(plan, site)
    except _faults.FaultError:
        st.add("faults_injected")
        st.add("faults_injected_" + site)
        raise


def _fetch(t, st: _Stats, plan, flag_fetch: bool = False,
           flow_wait: Optional[List[float]] = None) -> np.ndarray:
    """Blocking device-to-host fetch (it waits for the current stream
    only), billed to ``wait_s`` and the D2H byte ledger (flag fetches
    also to ``d2h_bytes_flags``). ``flow_wait`` (a list) collects this
    flow's own blocking times, so the flow's ``dispatch_s`` can leave
    them out while other flows bill ``wait_s`` at the same time."""
    _fault_check("fetch", st, plan)
    t0 = time.perf_counter()
    out = t.cpu().numpy()
    dt = time.perf_counter() - t0
    st.add("wait_s", dt)
    if flow_wait is not None:
        flow_wait.append(dt)
    st.add("d2h_bytes_fetched", float(out.nbytes))
    if flag_fetch:
        st.add("d2h_bytes_flags", float(out.nbytes))
    return out


class FleetItem:
    """One service's solve request (the FindAssignments argument set).

    ``store`` (anything with ``all_spans``/``all_processes``) feeds the
    per-service fallback's host refit. ``warm_dists`` (a carried
    ``{edge: EdgeDist}``) replaces the plan's fit and the refit pass: the
    item solves single-pass on them (unseen edges get the packer's
    near-flat Gaussian). ``plan_key`` is the item's plan-cache key (the
    service name when None; callers that solve several call graphs
    against one cache tell them apart with it)."""

    def __init__(self, svc, in_span_partitions, out_span_partitions,
                 true_assignments, dag=None,
                 method="MaxScoreBatchSubsetWithSkips", store=None,
                 warm_dists=None, plan_key=None):
        self.svc = svc
        self.in_span_partitions = in_span_partitions
        self.out_span_partitions = out_span_partitions
        self.true_assignments = true_assignments
        self.dag = dag
        self.method = method
        self.store = store
        self.warm_dists = warm_dists
        self.plan_key = plan_key


def _plan_key(item: FleetItem) -> str:
    return item.plan_key if item.plan_key is not None else item.svc


def _prepare(item: FleetItem, cached_dists=None):
    """Host preamble of FindAssignments for one item (sort, topological
    order, skip budget, distributions, pass count). None when the item
    needs the per-service path (no DAG, or a method the fleet does not
    carry).

    ``item.warm_dists``, else ``cached_dists`` (a plan-cache hit),
    replaces the fit, which is then skipped, and the refit pass: the
    item solves single-pass on them."""
    if item.dag is None or item.method not in (
            "MaxScoreBatchSubsetWithSkips", "MaxScoreBatchSubsetWithTrueSkips"):
        return None
    in_ep, in_spans = next(iter(item.in_span_partitions.items()))
    in_spans = sorted(in_spans, key=lambda s: (s.start_mus, s.end_mus))
    out_eps = WeaverTorch._topo_out_eps(item.out_span_partitions, item.dag)
    plan = plan_find_assignments(
        item.in_span_partitions, item.out_span_partitions, out_eps, item.dag,
        item.true_assignments,
        true_skips=(item.method == "MaxScoreBatchSubsetWithTrueSkips"),
        skip_fit=(item.warm_dists is not None or cached_dists is not None))
    dists, n_passes = plan["dists"], plan["iterations"]
    if item.warm_dists is not None:
        dists, n_passes = item.warm_dists, 1
    elif cached_dists is not None:
        dists, n_passes = cached_dists, 1
    return dict(in_ep=in_ep, in_spans=in_spans, out_eps=out_eps,
                skip_budget=plan["skip_budget"], dists=dists,
                n_in=plan["n_in"], n_passes=n_passes,
                force_skip_ids=plan["force_skip_ids"],
                in_cols=in_columns(in_spans),
                out_cols=out_columns(item.out_span_partitions, out_eps))


def _raw_cells(item: FleetItem, max_window: int) -> float:
    """Padded-cell count ``n_windows * W * M * E * n_passes`` of an item
    solved outside a fleet dispatch, from its raw partitions (the model
    the fleet plan records, so mixed workloads attribute on one scale)."""
    in_spans = sorted(next(iter(item.in_span_partitions.values())),
                      key=lambda s: (s.start_mus, s.end_mus))
    out_eps = list(item.out_span_partitions)
    in_cols = in_columns(in_spans)
    windows = perfect_cut_windows_cols(in_cols, max_window)
    out_cols = out_columns(item.out_span_partitions, out_eps)
    ranges = candidate_ranges(in_cols, windows, out_eps,
                              {ep: out_cols[ep].start for ep in out_eps})
    w_b = _bucket(max(hi - lo for lo, hi in windows))
    m_b = _bucket(int((ranges[:, :, 1] - ranges[:, :, 0]).max(initial=1)))
    n_in = len(in_spans)
    dynamism = any(n_in - len(item.out_span_partitions[ep]) > 0 for ep in out_eps)
    n_passes = 1 if (dynamism or item.method == "MaxScoreBatchSubsetWithTrueDist") else 2
    return float(len(windows) * w_b * m_b * max(1, len(out_eps)) * n_passes)


def _run_fallback(entries, results, all_spans, all_processes, solver_kwargs,
                  stats, confidences=None) -> None:
    """Per-service ``WeaverTorch`` solves (on the fleet's device) for
    items the fused dispatch cannot carry, overlapped through a thread
    pool; each solver's stage stats merge into the caller's, and its
    per-span confidence records into ``confidences`` when given."""
    st = _as_stats(stats)

    def run(entry):
        i, item = entry
        algo = WeaverTorch(item.store.all_spans if item.store else all_spans,
                           item.store.all_processes if item.store else all_processes,
                           confidence=confidences is not None, **solver_kwargs)
        kwargs = {}
        if item.method == "MaxScoreBatchSubsetWithTrueSkips":
            kwargs["true_skips"] = True
        elif item.method == "MaxScoreBatchSubsetWithTrueDist":
            kwargs["true_dist"] = True
        out = algo.FindAssignments(
            item.method, item.svc, item.in_span_partitions,
            item.out_span_partitions, False, [], item.true_assignments,
            item.dag, **kwargs)
        return i, out, algo.stats, algo.per_span_confidence

    with ThreadPoolExecutor(max_workers=max(1, len(entries))) as pool:
        for i, out, solver_stats, conf in pool.map(run, entries):
            results[i] = out
            if confidences is not None:
                confidences[i] = conf
            st.merge(solver_stats)


def solve_fleet(
    items: List[FleetItem],
    all_spans=None,
    all_processes=None,
    max_window: int = DEFAULT_MAX_WINDOW,
    epsilon: float = 1.0,
    n_sinkhorn: int = 40,
    n_sweeps: int = 5,
    sinkhorn_tol: float = 1e-3,
    stats: Optional[Dict[str, float]] = None,
    item_cells: Optional[List[float]] = None,
    precision: str = "f32",
    quarantined: Optional[List[int]] = None,
    confidences: Optional[List[Optional[Dict]]] = None,
    plan_cache: Optional[PlanCache] = None,
    *,
    fleet_budget_elems: int = FLEET_BUDGET_ELEMS,
    merge_budget: Optional[int] = None,
    compaction: bool = True,
    sweep_warm: int = 2,
    retry_max: int = 2,
    retry_backoff_s: float = 0.02,
    faults: Optional[_faults.FaultPlan] = None,
    pipeline: bool = True,
    decode_workers: int = 2,
    conf_device: bool = False,
    device=None,
    fused_kernel: bool = True,
) -> List[Tuple]:
    """Solve every item, fusing eligible ones into one dispatch per
    shape class. Returns one FindAssignments 6-tuple per item, in input
    order: ``(all_assignments, all_topk, not_best_count, n_spans,
    per_span_candidates, cnt_unassigned)``.

    ``device=None`` means the card and raises without one; tests pass
    ``device="cpu"``. ``fused_kernel`` picks K1 (else K2 and the plain
    rounding) on the card. ``precision`` accepts ``"f32"`` only.

    The keyword-only knobs are the JAX package's: ``fleet_budget_elems``
    (``TW_FLEET_BUDGET``), ``merge_budget`` (``TW_FLEET_MERGE``; None
    picks by device, :data:`MERGE_BUDGET`), ``compaction``
    (``TW_COMPACT``), ``sweep_warm`` (``TW_SWEEP_WARM``), ``retry_max``
    (``TW_RETRY_MAX``), ``retry_backoff_s`` (``TW_RETRY_BACKOFF_S``),
    ``faults`` (a :class:`~traceweaver_tpu_torch.runtime.faults.FaultPlan`
    in place of ``TW_FAULTS``), ``pipeline`` (``TW_PIPELINE``; False is
    the serial reference flow), ``decode_workers``
    (``TW_DECODE_WORKERS``, the pipeline's flow workers) and
    ``conf_device`` (``TW_CONF_DEVICE``).

    ``item_cells`` (a list sized to ``len(items)``) receives each item's
    padded-cell count; ``quarantined`` receives the indices of items the
    supervisor gave up on; ``confidences`` (a list sized to
    ``len(items)``; the JAX package's ``TW_CONFIDENCE=0`` is passing
    none) receives each item's ``{in span id: record}`` of
    :mod:`~traceweaver_tpu_torch.obs.quality`, zero-confidence records
    for a quarantined item. ``plan_cache`` is looked up before each
    item's fit (items with ``warm_dists`` bypass it); misses are
    admitted, a single-pass item's from its fit, a two-pass item's from
    its refit tables decoded after the compacted flow's dispatch. Host
    plan time, admissions included, is ``plan_fit_s``. ``stats`` gets
    the JAX package's ledger keys (``fleet_dispatches``,
    ``fleet_services``, ``fused_em_applied``,
    ``fleet_dynamism_dispatches``, ``compact_windows_*``,
    ``pipeline_groups``, ``pipeline_depth``, ``fault_*`` and the ordered
    ``fault_ladder`` list, stage seconds, byte counts).
    """
    dev = resolve_device(device)
    precision = validate_precision(precision)
    if merge_budget is None:
        merge_budget = MERGE_BUDGET["cpu" if dev.type == "cpu" else "cuda"]
    solver_kwargs = dict(max_window=max_window, epsilon=epsilon,
                         n_sinkhorn=n_sinkhorn, n_sweeps=n_sweeps,
                         sinkhorn_tol=sinkhorn_tol, precision=precision,
                         fused_kernel=fused_kernel, device=dev)
    results: List[Optional[Tuple]] = [None] * len(items)
    st = _as_stats(stats)

    prepared, fallback_entries = [], []
    t_plan = time.perf_counter()
    for i, item in enumerate(items):
        cached = (plan_cache.lookup(_plan_key(item))
                  if plan_cache is not None and item.warm_dists is None else None)
        prep = _prepare(item, cached_dists=cached)
        if prep is None:
            fallback_entries.append((i, item))
            if item_cells is not None:
                item_cells[i] = _raw_cells(item, max_window)
        else:
            if (plan_cache is not None and cached is None
                    and item.warm_dists is None and prep["n_passes"] == 1):
                # a single-pass miss has no refit to admit later: the
                # fit that just ran is the plan
                plan_cache.admit(_plan_key(item), prep["dists"])
            prepared.append((i, item, prep))
    st.add("plan_fit_s", time.perf_counter() - t_plan)
    if fallback_entries:
        _run_fallback(fallback_entries, results, all_spans, all_processes,
                      solver_kwargs, st, confidences=confidences)
    if not prepared:
        return results  # type: ignore[return-value]

    # --- per-item window plan and shape class ------------------------------
    t0 = time.perf_counter()
    plans = []
    for i, item, prep in prepared:
        in_cols, out_cols, out_eps = prep["in_cols"], prep["out_cols"], prep["out_eps"]
        windows = perfect_cut_windows_cols(in_cols, max_window)
        ranges = candidate_ranges(in_cols, windows, out_eps,
                                  {ep: out_cols[ep].start for ep in out_eps})
        skip_caps = water_fill_skip_caps(
            windows, ranges, len(prep["in_spans"]),
            [len(item.out_span_partitions[ep]) for ep in out_eps])
        w_b = _bucket(max(hi - lo for lo, hi in windows))
        m_b = _bucket(int((ranges[:, :, 1] - ranges[:, :, 0]).max(initial=1)))
        if item_cells is not None:
            item_cells[i] = (len(windows) * w_b * m_b * max(1, len(out_eps))
                             * prep["n_passes"])
        plans.append((i, item, prep, windows, ranges, skip_caps, w_b, m_b))
    st.add("pack_s", time.perf_counter() - t0)

    # --- group services into dispatch shape classes -------------------------
    # The class key holds the pass count (single- and two-pass services
    # run different programs) and the endpoint-count bucket; smaller
    # classes merge upward while the extra padded area stays under
    # ``merge_budget``.
    def shape_cost(group):
        w = max(p[6] for p in group)
        m = max(p[7] for p in group)
        e = max(len(p[2]["out_eps"]) for p in group)
        return sum(len(p[3]) for p in group) * w * m * e

    classes: Dict[Tuple[int, int, int, int], List] = {}
    for plan in plans:
        e_b = _bucket(len(plan[2]["out_eps"]), minimum=1)
        classes.setdefault((plan[2]["n_passes"], plan[6], plan[7], e_b), []).append(plan)
    ordered = sorted(classes, key=lambda k: (k[0], k[1] * k[2] * k[3]))
    groups: List[List] = []
    carry: List = []
    for idx, key in enumerate(ordered):
        wins = carry + classes[key]
        if idx + 1 < len(ordered) and ordered[idx + 1][0] == key[0]:
            nxt = wins + classes[ordered[idx + 1]]
            extra = (shape_cost(nxt) - shape_cost(wins)
                     - shape_cost(classes[ordered[idx + 1]]))
            if extra <= merge_budget:
                carry = wins
                continue
        groups.append(wins)
        carry = []
    if carry:
        groups.append(carry)

    # --- budget, then dispatch per group -------------------------------------
    run = _Run(hypers=dict(epsilon=epsilon, n_sinkhorn=n_sinkhorn,
                           sinkhorn_tol=sinkhorn_tol, precision=precision,
                           topk=DEFAULT_TOPK, fused=fused_kernel,
                           confidence=conf_device),
               n_sweeps=n_sweeps, device=dev, compaction=compaction,
               sweep_warm=sweep_warm, retry_max=retry_max,
               retry_backoff_s=retry_backoff_s,
               budget_bytes=fleet_budget_elems * 4, faults=faults,
               plan_cache=plan_cache)
    ctx = dict(all_spans=all_spans, all_processes=all_processes,
               solver_kwargs=solver_kwargs,
               quarantined=quarantined if quarantined is not None else [],
               confidences=confidences)
    specs: List[_GroupSpec] = []
    for group in groups:
        spec = _make_spec(group)
        if spec.cost > run.budget_bytes:
            # the padded group would stress device memory: per service
            _run_fallback([(p[0], p[1]) for p in group], results, all_spans,
                          all_processes, solver_kwargs, st, confidences=confidences)
            st.add("fleet_fallback_budget", 1.0)
            continue
        st.record_max("fleet_group_cost_max", float(spec.cost))
        st.add("fleet_group_cost_total", float(spec.cost))
        specs.append(spec)
    if pipeline and specs:
        _solve_groups_pipelined(specs, results, st, run, ctx, decode_workers)
    else:
        _solve_groups_serial(specs, results, st, run, ctx)
    return results  # type: ignore[return-value]


class _GroupSpec:
    """One shape-class dispatch group, its padded geometry and its cost
    in live bytes."""

    __slots__ = ("group", "W_pad", "M_pad", "E_pad", "bmax", "n_passes",
                 "cost")

    def __init__(self, group, W_pad, M_pad, E_pad, bmax, n_passes, cost):
        self.group = group
        self.W_pad = W_pad
        self.M_pad = M_pad
        self.E_pad = E_pad
        self.bmax = bmax
        self.n_passes = n_passes
        self.cost = cost


def _make_spec(group: List) -> _GroupSpec:
    """Padded geometry and f32 byte cost (score block plus the gathered
    ``[P*Ne, Bmax*W]`` refit samples of two-pass groups) of one group;
    shared by the grouping and the supervisor's bisection."""
    W_pad = max(p[6] for p in group)
    M_pad = max(p[7] for p in group)
    E_pad = max(len(p[2]["out_eps"]) for p in group)
    n_passes = group[0][2]["n_passes"]  # uniform within a class
    bmax = max(len(p[3]) for p in group)
    Ne = E_pad + E_pad * E_pad + E_pad
    score_elems = sum(len(p[3]) for p in group) * E_pad * W_pad * M_pad
    refit_elems = len(group) * Ne * bmax * W_pad if n_passes == 2 else 0
    return _GroupSpec(group, W_pad, M_pad, E_pad, bmax, n_passes,
                      4 * (score_elems + refit_elems))


# ---------------------------------------------------------------------------
# Solve supervisor: retry -> bisect -> per-service solver -> quarantine
# ---------------------------------------------------------------------------

def _attempt_group(pg, spec, results, st, run, ctx):
    """One supervised dispatch and decode of a packed group (host numpy,
    so every attempt places fresh device copies)."""
    _fault_check("dispatch", st, run.faults)
    pend = _dispatch_packed(pg, spec, st, run)
    _decode_group(pend, results, st, run, ctx)


def _enter_ladder(err, pg, spec, results, st, run, ctx):
    """Transient failures walk the degradation ladder; anything else
    propagates unchanged."""
    if not _faults.is_transient_fault(err):
        raise err
    st.add("fault_dispatch_errors")
    _degrade_group(err, pg, spec, results, st, run, ctx)


def _degrade_group(err, pg, spec, results, st, run, ctx):
    """The degradation ladder of one failed group:

    1. **retry**: up to ``retry_max`` redispatches, the k-th after
       ``retry_backoff_s * 2**k`` seconds;
    2. **bisect**: split the group in half and re-enter the ladder per
       half, so one poisoned service cannot take its class down;
    3. **host**: a singleton goes to the per-service ``WeaverTorch`` on
       the same device;
    4. **quarantine**: its slot gets an all-NA result and its index lands
       in ``ctx["quarantined"]``.

    Every rung is counted and appended to ``fault_ladder``."""
    for attempt in range(run.retry_max):
        if run.retry_backoff_s > 0:
            time.sleep(run.retry_backoff_s * (2 ** attempt))
        st.add("fault_retries")
        st.note("fault_ladder", "retry")
        try:
            _attempt_group(pg, spec, results, st, run, ctx)
            st.add("fault_recovered_retry")
            return
        except Exception as e:  # noqa: BLE001 — classified below
            if not _faults.is_transient_fault(e):
                raise
            err = e

    if len(spec.group) > 1:
        st.add("fault_bisections")
        st.note("fault_ladder", "bisect")
        mid = len(spec.group) // 2
        for half in (spec.group[:mid], spec.group[mid:]):
            half_spec = _make_spec(half)
            half_pg = _pack_group(half_spec, st)
            try:
                _attempt_group(half_pg, half_spec, results, st, run, ctx)
            except Exception as e:  # noqa: BLE001
                _enter_ladder(e, half_pg, half_spec, results, st, run, ctx)
        return

    plan = spec.group[0]
    st.add("fault_host_fallbacks")
    st.note("fault_ladder", "host")
    try:
        _fault_check("host", st, run.faults)
        _run_fallback([(plan[0], plan[1])], results, ctx["all_spans"],
                      ctx["all_processes"], ctx["solver_kwargs"], st,
                      confidences=ctx["confidences"])
        if results[plan[0]] is not None:
            return
    except Exception as e:  # noqa: BLE001
        if not _faults.is_transient_fault(e):
            raise

    st.add("fault_quarantined")
    st.note("fault_ladder", "quarantine")
    results[plan[0]] = _quarantine_result(plan)
    if ctx["confidences"] is not None:
        # an all-NA result has zero confidence, so queries can leave it out
        ctx["confidences"][plan[0]] = {s.GetId(): _quality.zero_confidence()
                                       for s in plan[2]["in_spans"]}
    ctx["quarantined"].append(plan[0])


def _quarantine_result(plan) -> Tuple:
    """A valid FindAssignments 6-tuple with every incoming span NA at
    every endpoint (``cnt_unassigned`` = the span count)."""
    prep = plan[2]
    in_ids = [s.GetId() for s in prep["in_spans"]]
    all_assignments = {ep: {iid: NA for iid in in_ids} for ep in prep["out_eps"]}
    all_topk = {ep: {iid: [] for iid in in_ids} for ep in prep["out_eps"]}
    return (all_assignments, all_topk, 0, prep["n_in"],
            {iid: 0 for iid in in_ids}, len(in_ids))


def _solve_groups_serial(specs, results, st, run, ctx):
    """The ``pipeline=False`` reference flow: pack and dispatch the
    groups in order on the calling thread (and its current stream); the
    live groups' bytes stay under one budget (decode drains them first).
    Failures enter the degradation ladder per group."""
    pending = []
    total_live = 0

    def finish(entry):
        spec, pg, pend = entry
        try:
            _decode_group(pend, results, st, run, ctx)
        except Exception as e:  # noqa: BLE001
            _enter_ladder(e, pg, spec, results, st, run, ctx)

    for spec in specs:
        if total_live + spec.cost > run.budget_bytes:
            for entry in pending:
                finish(entry)
            pending, total_live = [], 0
        total_live += spec.cost
        pg = _pack_group(spec, st)
        try:
            _fault_check("dispatch", st, run.faults)
            pend = _dispatch_packed(pg, spec, st, run)
        except Exception as e:  # noqa: BLE001
            _enter_ladder(e, pg, spec, results, st, run, ctx)
            continue
        pending.append((spec, pg, pend))
    for entry in pending:
        finish(entry)


def _solve_groups_pipelined(specs, results, st, run, ctx, workers: int):
    """Bounded pipeline over the dispatch groups (the JAX package's
    ``_solve_groups_pipelined``):

    - one pack thread builds the groups' host tensors in order (numpy
      only, no device work);
    - a pool of ``workers`` flow workers each runs one group's dispatch,
      compaction round trips, fetch, decode and, on a transient failure,
      the degradation ladder. On the card each worker runs its flows
      inside ``torch.cuda.stream`` on a stream of its own: kernels,
      copies and fetches of a flow queue on that stream alone, and a
      fetch waits for it alone, so one flow's host work overlaps another
      flow's device work. Every tensor of a flow is made and freed on
      its stream, so no ``record_stream`` is needed;
    - the live-byte budget is the admission gate: a group waits until
      the groups in flight leave room for it.

    The output is the serial flow's, in input order: every flow writes
    only its own items' slots. Non-transient errors propagate through
    ``fut.result()``; flows not yet started are then cancelled."""
    gate = threading.Condition()
    live_bytes = live_flows = 0  # guarded by ``gate``
    st.add("pipeline_groups", float(len(specs)))
    local = threading.local()

    def flow_stream():
        if run.device.type != "cuda":
            return contextlib.nullcontext()
        if getattr(local, "stream", None) is None:
            local.stream = torch.cuda.Stream(device=run.device)
        return torch.cuda.stream(local.stream)

    def flow(pg, spec):
        nonlocal live_bytes, live_flows
        try:
            with flow_stream():
                try:
                    _attempt_group(pg, spec, results, st, run, ctx)
                except Exception as e:  # noqa: BLE001 — classified by the ladder
                    _enter_ladder(e, pg, spec, results, st, run, ctx)
        finally:
            with gate:
                live_bytes -= spec.cost
                live_flows -= 1
                gate.notify_all()

    pack_pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="tw-fleet-pack")
    flow_pool = ThreadPoolExecutor(max_workers=max(1, workers),
                                   thread_name_prefix="tw-fleet-flow")
    ok = False
    try:
        pack_futs = [pack_pool.submit(_pack_group, spec, st) for spec in specs]
        flow_futs = []
        for spec, fut in zip(specs, pack_futs):
            pg = fut.result()
            with gate:
                # a lone over-budget group went to the per-service
                # fallback upstream, so an empty pipeline admits anything
                while live_bytes > 0 and live_bytes + spec.cost > run.budget_bytes:
                    gate.wait()
                live_bytes += spec.cost
                live_flows += 1
                st.record_max("pipeline_depth", float(live_flows))
            flow_futs.append(flow_pool.submit(flow, pg, spec))
        for fut in flow_futs:
            fut.result()
        ok = True
    finally:
        pack_pool.shutdown(wait=True, cancel_futures=not ok)
        flow_pool.shutdown(wait=True, cancel_futures=not ok)


def _pack_group(spec: _GroupSpec, st: _Stats):
    """Host packing of one group (numpy): concatenated window tensors
    (each item's rows cut to its exact window count), stacked tables,
    the refit row map and the group's neighbour bounds."""
    t0 = time.perf_counter()
    batch_parts: Dict[str, List[np.ndarray]] = {k: [] for k in _BATCH_KEYS}
    table_rows: Dict[str, List[np.ndarray]] = {k: [] for k in _TABLE_KEYS}
    per_item_pack = []
    param_idx: List[int] = []
    for p, (i, item, prep, windows, ranges, skip_caps, _, _) in enumerate(spec.group):
        packed = pack_problem(
            prep["in_spans"], item.out_span_partitions, prep["out_eps"],
            prep["dists"], prep["in_ep"], item.dag,
            force_skip_ids=prep["force_skip_ids"], parallel=False,
            windows=windows, pad_w=spec.W_pad, pad_m=spec.M_pad,
            pad_e=spec.E_pad, ranges=ranges, skip_caps=skip_caps,
            in_cols=prep["in_cols"], out_cols=prep["out_cols"])
        n_w = len(windows)
        for key in _BATCH_KEYS:
            batch_parts[key].append(packed.arrays[key][:n_w])
        packed.truncate_rows(n_w)
        for key in _TABLE_KEYS:
            table_rows[key].append(packed.arrays[key])
        param_idx.extend([p] * n_w)
        per_item_pack.append((i, item, prep, packed, n_w))

    batch = {k: np.concatenate(v, axis=0) for k, v in batch_parts.items()}
    params = {k: np.stack(v, axis=0) for k, v in table_rows.items()}
    # neighbour bounds over the whole group (power-of-two bucketed): the
    # score build gathers only real DAG edges
    pm_all = params["pred_mask"]
    max_preds = _bucket(max(1, int(pm_all.sum(axis=2).max(initial=0))), minimum=1)
    max_succs = _bucket(max(1, int(pm_all.sum(axis=1).max(initial=0))), minimum=1)
    # each service's contiguous window-row block, for the gathered refit
    window_rows = np.zeros((len(per_item_pack), spec.bmax), dtype=np.int32)
    window_valid = np.zeros((len(per_item_pack), spec.bmax), dtype=bool)
    row0 = 0
    for p, (*_, n_w) in enumerate(per_item_pack):
        window_rows[p, :n_w] = np.arange(row0, row0 + n_w, dtype=np.int32)
        window_valid[p, :n_w] = True
        row0 += n_w
    st.add("pack_s", time.perf_counter() - t0)
    st.add("fleet_dispatches", 1.0)
    st.add("fleet_services", float(len(per_item_pack)))
    st.add("fused_em_applied" if spec.n_passes == 2 else "fleet_dynamism_dispatches",
           1.0)
    return dict(batch=batch, params=params,
                pidx=np.asarray(param_idx, dtype=np.int32),
                window_rows=window_rows, window_valid=window_valid,
                per_item_pack=per_item_pack, max_preds=max_preds,
                max_succs=max_succs, n_rows=row0)


def _place(arrs: Dict[str, np.ndarray], pidx: np.ndarray, dev, st: _Stats):
    """Fresh device copies of the window tensors and the param index,
    billed to ``h2d_bytes_shipped``."""
    st.add("h2d_bytes_shipped", float(sum(arrs[k].nbytes for k in _BATCH_KEYS)))
    return (tuple(torch.as_tensor(arrs[k], device=dev) for k in _BATCH_KEYS)
            + (torch.as_tensor(pidx, device=dev),))


def _dispatch_packed(pg, spec: _GroupSpec, st: _Stats, run: _Run):
    """Run one packed group's device solve and return its decode ticket
    ``(per_item_pack, out, confidence)``: ``out`` is a host array from
    the compacted flow, else the packed device block; ``confidence``
    says whether it carries the confidence channels. With a plan cache,
    a two-pass group's refit tables are decoded and admitted here, after
    the dispatch time is taken (billed to ``plan_fit_s``)."""
    dev = run.device
    hypers = dict(run.hypers, max_preds=pg["max_preds"], max_succs=pg["max_succs"])
    use_compact = (run.compaction and run.sweep_warm < run.n_sweeps
                   and pg["n_rows"] > 1)
    flow_wait: List[float] = []
    refit_sink = [] if (run.plan_cache is not None and spec.n_passes == 2) else None
    t0 = time.perf_counter()
    # the JAX package opens this range on the uncompacted branch only;
    # here it spans the group's whole device solve, so the default
    # (compacted) flow shows it too, its stages nested inside
    with _profile.annotate("tw:fleet:dispatch"):
        if use_compact:
            out = _solve_group_compacted(
                pg["batch"], pg["pidx"], pg["params"], pg["window_rows"],
                pg["window_valid"], spec.n_passes, run.n_sweeps, run.sweep_warm,
                hypers, st, dev, run.faults, flow_wait=flow_wait,
                refit_sink=refit_sink)
        else:
            common = _place(pg["batch"], pg["pidx"], dev, st)
            tables = _tables_on(pg["params"], dev)
            if spec.n_passes == 2:
                out, _ = solve_em_fleet(
                    *common, torch.as_tensor(pg["window_rows"], device=dev),
                    torch.as_tensor(pg["window_valid"], device=dev), *tables,
                    n_sweeps=run.n_sweeps, **hypers)
            else:
                out, _ = solve_windows_fleet(*common, *tables,
                                             n_sweeps=run.n_sweeps, **hypers)
    st.add("dispatch_s", time.perf_counter() - t0 - sum(flow_wait))
    if refit_sink:
        # the device already fitted the next round's plan: keep it
        t_admit = time.perf_counter()
        tables9 = tuple(t.cpu().numpy() for t in refit_sink[0])
        for p, (_, item, prep, _, _) in enumerate(pg["per_item_pack"]):
            if item.warm_dists is None:
                run.plan_cache.admit(_plan_key(item), dists_from_tables(
                    prep["out_eps"], prep["in_ep"], *(t[p] for t in tables9)))
        st.add("plan_fit_s", time.perf_counter() - t_admit)
    return pg["per_item_pack"], out, hypers["confidence"]


def _tables_on(params: Dict[str, np.ndarray], dev) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.as_tensor(params[k], device=dev) for k in _TABLE_KEYS)


def _compacted_pass(batch, pidx, tables, n_sweeps, warm, hypers, stats, device,
                    faults=None, flow_wait=None) -> np.ndarray:
    """One solve pass as a warm dispatch of ``warm`` sweeps plus a full
    redispatch of only the unconverged windows. Returns the packed
    ``[B, E, W, 3 + topk]`` block on the host; ``batch``/``pidx`` are
    host numpy, ``tables`` numpy or tensors."""
    st = _as_stats(stats)
    tables = tuple(torch.as_tensor(t, device=device) for t in tables)
    with _profile.annotate("tw:fleet:warm-dispatch"):
        out_warm, flags = solve_windows_fleet(*_place(batch, pidx, device, st),
                                              *tables, n_sweeps=warm, **hypers)
    st.add("d2h_flag_fetches", 1.0)
    with _profile.annotate("tw:fleet:flag-fetch"):
        converged = _fetch(flags, st, faults, flag_fetch=True,
                           flow_wait=flow_wait).astype(bool)
    active = np.flatnonzero(~converged)
    st.add("compact_windows_total", float(converged.shape[0]))
    st.add("compact_windows_redispatched", float(active.size))
    if active.size == 0:
        return _fetch(out_warm, st, faults, flow_wait=flow_wait)
    # stragglers rerun from sweep 0, padded to a power of two with
    # all-invalid rows (no valid spans or columns: decoded by nobody)
    pad = _bucket(int(active.size), minimum=1) - int(active.size)
    gathered = {k: np.concatenate([batch[k][active],
                                   np.zeros((pad,) + batch[k].shape[1:],
                                            dtype=batch[k].dtype)])
                for k in _BATCH_KEYS}
    pidx_active = np.concatenate([np.asarray(pidx)[active],
                                  np.zeros(pad, dtype=np.asarray(pidx).dtype)])
    with _profile.annotate("tw:fleet:redispatch"):
        out_full, _ = solve_windows_fleet(*_place(gathered, pidx_active, device, st),
                                          *tables, n_sweeps=n_sweeps, **hypers)
    out = _fetch(out_warm, st, faults, flow_wait=flow_wait).copy()
    out[active] = _fetch(out_full, st, faults, flow_wait=flow_wait)[:active.size]
    return out


def _solve_group_compacted(batch, pidx, params, window_rows, window_valid,
                           n_passes, n_sweeps, warm, hypers, stats, device,
                           faults=None, flow_wait=None,
                           refit_sink=None) -> np.ndarray:
    """The compacted counterpart of one group dispatch: a compacted pass
    0, for two-pass groups :func:`refit_fleet_params` on pass 0's merged
    assignments (the refit :func:`solve_em_fleet` runs), then a
    compacted pass 1. ``refit_sink`` (a list) receives the refit tables
    for the plan cache."""
    st = _as_stats(stats)
    tables = _tables_on(params, device)
    out0 = _compacted_pass(batch, pidx, tables, n_sweeps, warm, hypers, st,
                           device, faults, flow_wait)
    if n_passes == 1:
        return out0

    def on(a):
        return torch.as_tensor(a, device=device)

    new_tables = refit_fleet_params(
        on(out0[..., _layout.CH_ASSIGN]),
        *(on(batch[k]) for k in ("in_start", "in_end", "in_valid",
                                 "out_start", "out_end")),
        on(pidx), on(window_rows), on(window_valid), *tables[:2], *tables[3:])
    if refit_sink is not None:
        refit_sink.append(new_tables)
    return _compacted_pass(batch, pidx, tables[:3] + tuple(new_tables), n_sweeps,
                           warm, hypers, st, device, faults, flow_wait)


def _decode_group(pend, results, st: _Stats, run: _Run, ctx) -> None:
    """Fetch one group's packed output (unless the compacted flow already
    did) and decode it per service into its input-order slot, with the
    item's confidence records when the caller asked for them."""
    per_item_pack, out, conf_device = pend
    confidences = ctx["confidences"]
    o = out if isinstance(out, np.ndarray) else _fetch(out, st, run.faults)
    t0 = time.perf_counter()
    row = 0
    for i, item, prep, packed, n_w in per_item_pack:
        rows = o[row:row + n_w]
        ch = _layout.split_packed(rows, confidence=conf_device)
        row += n_w
        out_eps = prep["out_eps"]
        in_ids = prep["in_cols"].ids.tolist()
        n_in = prep["n_in"]
        all_assignments = {ep: {} for ep in out_eps}
        all_topk = {ep: {} for ep in out_eps}
        WeaverTorch._decode(packed, ch["assign"], ch["topk_cols"],
                            all_assignments, all_topk)
        span_not_best = np.zeros(n_in, dtype=bool)
        span_cands = np.ones(n_in, dtype=np.int64)
        scatter_window_span_stats(packed.windows, ch["not_best"], ch["feas"],
                                  span_not_best, span_cands)
        if confidences is not None:
            arrs = _quality.span_confidence_arrays(packed.windows, rows, n_in,
                                                   device=conf_device)
            confidences[i] = _quality.confidence_records(in_ids, arrs)
        WeaverTorch._resolve_cross_window_duplicates(
            all_assignments, all_topk, in_ids, prep["skip_budget"])
        cnt_unassigned = sum(
            1 for in_id in in_ids
            if any(all_assignments[ep][in_id] == NA for ep in out_eps))
        results[i] = (all_assignments, all_topk, int(span_not_best.sum()), n_in,
                      {in_ids[j]: int(span_cands[j]) for j in range(n_in)},
                      cnt_unassigned)
    st.add("decode_s", time.perf_counter() - t0)
