"""Fleet solve: every service's windows in one dispatch per shape class
(mirrors ``traceweaver_tpu/algorithms/fleet.py``).

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
:func:`solve_fleet` with the knobs' defaults. The JAX package's AOT
notes have no counterpart (the port compiles no programs at run time).

Mesh sharding (``mesh=``, a :class:`~traceweaver_tpu_torch.parallel.mesh.Mesh`):
each group's batch rows pad on the host to a power of two a shard
(:func:`~traceweaver_tpu_torch.parallel.mesh.bucket_rows_per_shard`; the
padding rows are all-invalid windows of tenant -1, decoded by nobody),
each shard's contiguous rows solve on its own device, and the compacted
flow fetches the shards' convergence flags gathered onto the mesh's first
device in one transfer (``d2h_flag_fetches`` counts one a pass); its
straggler redispatch is bucketed per shard too. The two-pass EM's refit
sees every shard's windows: it runs on the first device, the solve's
device, on the whole gathered batch. Every shard launches with the
kernels' launch plan of the unsharded batch, so 1- and N-shard runs are
equal. Under a mesh the groups run in the serial flow (counted in
``mesh_serialized_groups`` when the pipeline was asked for and there is
more than one group), device-resident columns are off (the mesh places
host tensors per shard), and a mesh whose size is not a power of two
runs the per-service fallback items on its first device alone.

Device-resident columns (``devcols=True``, the default, as ``TW_DEVCOLS``
is in the JAX package; :mod:`traceweaver_tpu_torch.ops.devcols`): the
pack thread resolves each group's partitions onto the device's column
rings, appending only spans not resident yet (``h2d_bytes_ring``), and
packs int32 index arrays in place of the six window tensors; every
dispatch, compacted redispatch and refit gathers fresh window tensors
on the device from the rings (``h2d_bytes_index``, with the skip and
force tensors in ``h2d_bytes_shipped``). A group with any partition the
rings cannot hold exactly (non-integral µs, an origin outside the int32
epoch span, a partition larger than a ring) packs on the host instead,
counted in ``devcols_fallbacks``. The gathered tensors equal the host
packer's bit for bit, and the port pads neither the batch rows nor the
tables of a resident group (the JAX package pads both to powers of two
to bound its compiled shapes; the port compiles nothing), so both paths
hand the solver identical inputs. A ``devcols`` fault makes the
supervisor rebuild the rings from their host mirrors before it retries
(``devcols_ring_rebuilds``).

Tenancy (the serve tier's): ``FleetItem.tenant`` tags an item with its
tenant. The id column rides pack, compaction and decode on the host and
never reaches the device; it fills the per-tenant buckets
``tenant_windows_packed``, ``tenant_windows_redispatched`` and
``tenant_windows_decoded`` of the stats (packed equals decoded), which
untagged callers never see.

Every host stage of a round runs in one stage scope (``_Stats.stage``,
:func:`traceweaver_tpu_torch.obs.profile.annotate`): one ``perf_counter``
pair bills its stats key and stamps the round; with profiling on it is
the range ``tw:fleet:<stage>`` carrying the group's index in the round;
with a self-tracer installed it is stamped on the group's window keys
(``FleetItem.trace_key``). ``plan`` and ``plan-admit`` bill
``plan_fit_s``; ``window-plan`` and ``pack`` ``pack_s``; ``group``
(classes, merge, budget) nothing; ``dispatch`` ``dispatch_s``, with
``warm-dispatch``, ``flag-fetch`` (self-trace ``compact-fetch``) and
``redispatch`` inside; ``fetch`` ``wait_s``; ``decode`` ``decode_s``;
the rungs ``retry`` (its backoff), ``bisect``, ``host-fallback`` and
``quarantine`` nothing. ``wait_s`` and ``decode_s`` sum over the flow
workers. A round that launched a group also records ``fleet_lead_s``
(entry to the first dispatch), ``fleet_tail_s`` (the last fetch's end
to the return) and ``decode_wall_s`` (the decodes' union). The main
thread's waits on the pack futures and the budget gate open no range.

Every ``_Stats`` update also lands in the metrics registry
(:mod:`traceweaver_tpu_torch.obs.registry`: ``tw_fleet_ledger_total``,
``tw_fleet_gauge``, ``tw_fault_ladder_events_total``) and each ladder
rung in the installed event sink.
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
    _pack_problem_devcols,
    candidate_ranges,
    decode_service,
    dists_from_tables,
    in_columns,
    out_columns,
    pack_problem,
    perfect_cut_windows_cols,
    plan_find_assignments,
    refit_fleet_params,
    resolve_device,
    solve_em_fleet,
    solve_windows_fleet,
)
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs import profile as _profile
from traceweaver_tpu_torch.obs import quality as _quality
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry
from traceweaver_tpu_torch.obs.registry import serve_families as _serve_families
from traceweaver_tpu_torch.parallel.mesh import (
    Mesh,
    _pad_batch,
    bucket_rows_per_shard,
    coalesce_to_device0,
    put_sharded,
    replicate,
    shard_slices,
)
from traceweaver_tpu_torch.ops import devcols as _devcols
from traceweaver_tpu_torch.ops.precision import score_itemsize, validate_precision
from traceweaver_tpu_torch.runtime import faults as _faults
from traceweaver_tpu_torch.spans import NA

#: ``TW_FLEET_BUDGET``: f32 elements of one group's live blocks (score
#: block plus refit samples); a group past it solves per service. Group
#: costs are bytes, the score blocks at the score precision's item size
#: (bf16: 2), so a bf16 solve fits about twice the windows under it
FLEET_BUDGET_ELEMS = 1 << 28
#: ``TW_FLEET_MERGE`` by device when not given: padded cells are real
#: core-seconds on the CPU (merge conservatively, as the JAX package does
#: there) and cheap next to a saved dispatch on an accelerator
MERGE_BUDGET = {"cpu": 1 << 20, "cuda": 1 << 24}

# window-axis keys of a packed fleet batch, dispatch argument order
_BATCH_KEYS = ("in_start", "in_end", "in_valid", "out_start", "out_end",
               "out_valid", "skip_cap", "force_skip")
# the host-shipped part of a resident (devcols) group's batch
_DEVCOLS_BATCH_KEYS = ("skip_cap", "force_skip")
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
    devcols: bool = False
    ring_capacity: int = _devcols.RING_CAPACITY
    mesh: Optional[Mesh] = None


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
_OBS_TENANT = _serve_families()["tenant_windows"]
_OBS_DISPATCH_S = _serve_families()["dispatch_s"]


class _Stats:
    """Lock-guarded accumulator over the caller's stats dict (the
    per-service fallback pool and the solve thread update it together);
    ``d is None`` makes every dict update a no-op. The registry mirror
    and the event sink see every update either way. ``stamps`` collects
    every stage scope's ``(range name, t0, t1)``."""

    def __init__(self, d: Optional[Dict[str, float]]):
        self.d = d
        self._lock = threading.Lock()
        self.stamps: List[Tuple[str, float, float]] = []

    def stage(self, name: str, key: Optional[str] = None, *, group: Optional[int] = None,
              trace_keys=(), trace_stage: Optional[str] = None):
        """:func:`~traceweaver_tpu_torch.obs.profile.annotate` of the stage
        ``tw:fleet:<name>`` (self-trace stage ``trace_stage``, else ``name``)."""
        return _profile.annotate("tw:fleet:" + name, self.add, key, group=group,
                                 trace_keys=trace_keys, trace_stage=trace_stage or name,
                                 stamps=self.stamps)

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

    def bucket(self, key: str, subkey: str, val: float = 1.0) -> None:
        """Accumulate into the ``{subkey: count}`` dict under ``key`` (the
        per-tenant ledger, ``tenant_windows_packed`` and the rest);
        written only for tenant-tagged items, so untagged callers' stats
        are unchanged."""
        _OBS_TENANT.inc(val, key=key, tenant=subkey)
        if self.d is None:
            return
        with self._lock:
            d = self.d.setdefault(key, {})
            d[subkey] = d.get(subkey, 0.0) + val


def _as_stats(stats) -> _Stats:
    return stats if isinstance(stats, _Stats) else _Stats(stats)


def _round_structure(st: _Stats, t_entry: float) -> None:
    """The round's ``fleet_lead_s``, ``fleet_tail_s`` and
    ``decode_wall_s`` from its stage stamps; none without a dispatch."""
    t_exit = time.perf_counter()
    by: Dict[str, List[Tuple[float, float]]] = {}
    for name, t0, t1 in st.stamps:
        by.setdefault(name, []).append((t0, t1))
    if "tw:fleet:dispatch" not in by:
        return
    st.add("fleet_lead_s", min(by["tw:fleet:dispatch"])[0] - t_entry)
    if "tw:fleet:fetch" in by:
        st.add("fleet_tail_s", t_exit - max(t1 for _, t1 in by["tw:fleet:fetch"]))
    decode = _profile.union(by.get("tw:fleet:decode", []))
    st.add("decode_wall_s", sum(hi - lo for lo, hi in decode))


def _group_keys(group) -> List[str]:
    """The sorted self-trace keys of a group's items (its plans or its
    packed items, the item second in each)."""
    return sorted({p[1].trace_key for p in group if p[1].trace_key is not None})


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
           flow_wait: Optional[List[float]] = None,
           group: Optional[int] = None) -> np.ndarray:
    """Blocking device-to-host fetch (it waits for the current stream
    only), the stage ``fetch`` of group ``group`` (None: the enclosing
    stage's), billed to ``wait_s`` and the D2H byte ledger (flag fetches
    also to ``d2h_bytes_flags``). ``flow_wait`` (a list) collects this
    flow's own blocking times, so the flow's ``dispatch_s`` can leave
    them out while other flows bill ``wait_s`` at the same time."""
    _fault_check("fetch", st, plan)
    with st.stage("fetch", "wait_s", group=group) as sp:
        # a mesh solve's block comes back as one tensor a shard, in shard order
        out = (np.concatenate([x.cpu().numpy() for x in t]) if isinstance(t, list)
               else t.cpu().numpy())
    if flow_wait is not None:
        flow_wait.append(sp.seconds)
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
    against one cache tell them apart with it). ``in_cols``/``out_cols``
    are prebuilt columns of the sorted partitions (the stream hands its
    windows over so), used in place of a second build when they match.
    ``trace_key`` is the item's self-trace window key. ``tenant`` (the
    serve tier's) tags the item with its tenant: a host-side id column
    through pack, compaction and decode that fills the per-tenant stats
    buckets and keys the item's device-resident columns."""

    def __init__(self, svc, in_span_partitions, out_span_partitions,
                 true_assignments, dag=None,
                 method="MaxScoreBatchSubsetWithSkips", store=None,
                 warm_dists=None, plan_key=None, in_cols=None, out_cols=None,
                 trace_key=None, tenant=None):
        self.svc = svc
        self.in_span_partitions = in_span_partitions
        self.out_span_partitions = out_span_partitions
        self.true_assignments = true_assignments
        self.dag = dag
        self.method = method
        self.store = store
        self.warm_dists = warm_dists
        self.plan_key = plan_key
        self.in_cols = in_cols
        self.out_cols = out_cols
        self.trace_key = trace_key
        self.tenant = tenant


def _plan_key(item: FleetItem) -> str:
    return item.plan_key if item.plan_key is not None else item.svc


def _prepare(item: FleetItem, cached_dists=None, score_mode: str = "mixture"):
    """Host preamble of FindAssignments for one item (sort, topological
    order, skip budget, distributions, pass count). None when the item
    needs the per-service path (no DAG, KDE scoring, or a method the
    fleet does not carry).

    ``item.warm_dists``, else ``cached_dists`` (a plan-cache hit),
    replaces the fit, which is then skipped, and the refit pass: the
    item solves single-pass on them."""
    if item.dag is None or score_mode != "mixture" or item.method not in (
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
    in_cols = (item.in_cols if item.in_cols is not None
               and len(item.in_cols) == len(in_spans) else in_columns(in_spans))
    out_cols = (item.out_cols if item.out_cols is not None
                and all(ep in item.out_cols for ep in out_eps)
                else out_columns(item.out_span_partitions, out_eps))
    return dict(in_ep=in_ep, in_spans=in_spans, out_eps=out_eps,
                skip_budget=plan["skip_budget"], dists=dists,
                n_in=plan["n_in"], n_passes=n_passes,
                force_skip_ids=plan["force_skip_ids"],
                in_cols=in_cols, out_cols=out_cols)


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
    score_gemm: bool = False,
    devcols: bool = True,
    ring_capacity: int = _devcols.RING_CAPACITY,
    mesh: Optional[Mesh] = None,
    score_mode: str = "mixture",
) -> List[Tuple]:
    """Solve every item, fusing eligible ones into one dispatch per
    shape class. Returns one FindAssignments 6-tuple per item, in input
    order: ``(all_assignments, all_topk, not_best_count, n_spans,
    per_span_candidates, cnt_unassigned)``.

    ``device=None`` means the card and raises without one; tests pass
    ``device="cpu"``. ``mesh`` shards every group's window batch over
    its devices (see the module docstring); the solve's device is then
    the mesh's first and ``device`` is not read. ``fused_kernel`` picks K1 (else K2 and the plain
    rounding) on the card. ``precision`` is the score blocks' storage
    precision (``"f32"`` or ``"bf16"``, ``TW_PRECISION``) and
    ``score_gemm`` builds the scores in the GEMM form
    (``TW_SCORE_GEMM``). ``score_mode`` is the solver's
    (:class:`WeaverTorch`): the fused dispatch carries only
    ``"mixture"``, so under ``"kde"`` every item takes the per-service
    path.

    The keyword-only knobs are the JAX package's: ``fleet_budget_elems``
    (``TW_FLEET_BUDGET``), ``merge_budget`` (``TW_FLEET_MERGE``; None
    picks by device, :data:`MERGE_BUDGET`), ``compaction``
    (``TW_COMPACT``), ``sweep_warm`` (``TW_SWEEP_WARM``), ``retry_max``
    (``TW_RETRY_MAX``), ``retry_backoff_s`` (``TW_RETRY_BACKOFF_S``),
    ``faults`` (a :class:`~traceweaver_tpu_torch.runtime.faults.FaultPlan`
    in place of ``TW_FAULTS``), ``pipeline`` (``TW_PIPELINE``; False is
    the serial reference flow), ``decode_workers``
    (``TW_DECODE_WORKERS``, the pipeline's flow workers),
    ``conf_device`` (``TW_CONF_DEVICE``), ``devcols`` (``TW_DEVCOLS``:
    gather the window tensors on the device from the resident column
    rings, see the module docstring) and ``ring_capacity``
    (``TW_DEVCOLS_RING``, slots a ring).

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
    t_entry = time.perf_counter()
    dev = mesh.devices[0] if mesh is not None else resolve_device(device)
    precision = validate_precision(precision)
    if merge_budget is None:
        merge_budget = MERGE_BUDGET["cpu" if dev.type == "cpu" else "cuda"]
    # the fused path shards any mesh size (rows pad to a multiple); the
    # per-service fallback solver needs a power of two, so another size
    # runs the fallback items on the first device alone
    n_mesh = mesh.size if mesh is not None else 1
    fallback_mesh = mesh if n_mesh & (n_mesh - 1) == 0 else None
    solver_kwargs = dict(max_window=max_window, epsilon=epsilon,
                         n_sinkhorn=n_sinkhorn, n_sweeps=n_sweeps,
                         sinkhorn_tol=sinkhorn_tol, precision=precision,
                         fused_kernel=fused_kernel, device=dev,
                         score_gemm=score_gemm, mesh=fallback_mesh,
                         score_mode=score_mode)
    results: List[Optional[Tuple]] = [None] * len(items)
    st = _as_stats(stats)

    prepared, fallback_entries = [], []
    with st.stage("plan", "plan_fit_s"):
        for i, item in enumerate(items):
            cached = (plan_cache.lookup(_plan_key(item))
                      if plan_cache is not None and item.warm_dists is None else None)
            prep = _prepare(item, cached_dists=cached, score_mode=score_mode)
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
    if fallback_entries:
        _run_fallback(fallback_entries, results, all_spans, all_processes,
                      solver_kwargs, st, confidences=confidences)
    if not prepared:
        return results  # type: ignore[return-value]

    # --- per-item window plan and shape class ------------------------------
    plans = []
    with st.stage("window-plan", "pack_s"):
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

    with st.stage("group"):
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

        # --- budget, then dispatch per group ---------------------------------
        run = _Run(hypers=dict(epsilon=epsilon, n_sinkhorn=n_sinkhorn,
                               sinkhorn_tol=sinkhorn_tol, precision=precision,
                               topk=DEFAULT_TOPK, fused=fused_kernel,
                               confidence=conf_device, score_gemm=score_gemm),
                   n_sweeps=n_sweeps, device=dev, compaction=compaction,
                   sweep_warm=sweep_warm, retry_max=retry_max,
                   retry_backoff_s=retry_backoff_s,
                   budget_bytes=fleet_budget_elems * 4, faults=faults,
                   plan_cache=plan_cache,
                   # the mesh places host tensors per shard
                   devcols=bool(devcols) and mesh is None,
                   ring_capacity=int(ring_capacity), mesh=mesh)
        ctx = dict(all_spans=all_spans, all_processes=all_processes,
                   solver_kwargs=solver_kwargs,
                   quarantined=quarantined if quarantined is not None else [],
                   confidences=confidences)
        specs: List[_GroupSpec] = []
        itemsize = score_itemsize(precision)
        for index, group in enumerate(groups):
            spec = _make_spec(group, itemsize)
            spec.index = index
            if spec.cost > run.budget_bytes:
                # the padded group would stress device memory: per service
                _run_fallback([(p[0], p[1]) for p in group], results, all_spans,
                              all_processes, solver_kwargs, st, confidences=confidences)
                st.add("fleet_fallback_budget", 1.0)
                continue
            st.record_max("fleet_group_cost_max", float(spec.cost))
            st.add("fleet_group_cost_total", float(spec.cost))
            specs.append(spec)
    if pipeline and specs and mesh is None:
        _solve_groups_pipelined(specs, results, st, run, ctx, decode_workers)
    else:
        # a mesh's shards launch from the serial flow: the pipeline's
        # overlap is a single-device optimization (the JAX package
        # serializes its mesh groups because concurrent sharded launches
        # deadlock XLA's rendezvous)
        if mesh is not None and pipeline and len(specs) > 1:
            st.add("mesh_serialized_groups", float(len(specs)))
        _solve_groups_serial(specs, results, st, run, ctx)
    _round_structure(st, t_entry)
    return results  # type: ignore[return-value]


class _GroupSpec:
    """One shape-class dispatch group, its padded geometry, its cost in
    live bytes and its index in the round (a bisected half keeps its
    group's)."""

    __slots__ = ("group", "W_pad", "M_pad", "E_pad", "bmax", "n_passes",
                 "cost", "index")

    def __init__(self, group, W_pad, M_pad, E_pad, bmax, n_passes, cost):
        self.group = group
        self.W_pad = W_pad
        self.M_pad = M_pad
        self.E_pad = E_pad
        self.bmax = bmax
        self.n_passes = n_passes
        self.cost = cost
        self.index = 0


def _make_spec(group: List, itemsize: int) -> _GroupSpec:
    """Padded geometry and byte cost of one group: the score blocks at
    ``itemsize`` bytes an element plus the gathered ``[P*Ne, Bmax*W]``
    f32 refit samples of two-pass groups; shared by the grouping and the
    supervisor's bisection."""
    W_pad = max(p[6] for p in group)
    M_pad = max(p[7] for p in group)
    E_pad = max(len(p[2]["out_eps"]) for p in group)
    n_passes = group[0][2]["n_passes"]  # uniform within a class
    bmax = max(len(p[3]) for p in group)
    Ne = E_pad + E_pad * E_pad + E_pad
    score_elems = sum(len(p[3]) for p in group) * E_pad * W_pad * M_pad
    refit_elems = len(group) * Ne * bmax * W_pad if n_passes == 2 else 0
    return _GroupSpec(group, W_pad, M_pad, E_pad, bmax, n_passes,
                      itemsize * score_elems + 4 * refit_elems)


# ---------------------------------------------------------------------------
# Solve supervisor: retry -> bisect -> per-service solver -> quarantine
# ---------------------------------------------------------------------------

def _attempt_group(pg, spec, results, st, run, ctx):
    """One supervised dispatch and decode of a packed group (host numpy,
    so every attempt places fresh device copies)."""
    _fault_check("dispatch", st, run.faults)
    pend = _dispatch_packed(pg, spec, st, run)
    _decode_group(pend, results, st, run, ctx, spec.index)


def _enter_ladder(err, pg, spec, results, st, run, ctx):
    """Transient failures walk the degradation ladder; anything else
    propagates unchanged."""
    if not _faults.is_transient_fault(err):
        raise err
    st.add("fault_dispatch_errors")
    _degrade_group(err, pg, spec, results, st, run, ctx)


def _degrade_group(err, pg, spec, results, st, run, ctx):
    """The degradation ladder of one failed group:

    0. **ring-rebuild**: a ``devcols`` fault means the resident rings can
       no longer be trusted, and a poisoned ring would corrupt every
       later gather from it, so the group's rings are rebuilt from their
       host mirrors before every retry (:func:`_rebuild_rings`);
    1. **retry**: up to ``retry_max`` redispatches, the k-th after
       ``retry_backoff_s * 2**k`` seconds;
    2. **bisect**: split the group in half and re-enter the ladder per
       half, so one poisoned service cannot take its class down;
    3. **host**: a singleton goes to the per-service ``WeaverTorch`` on
       the same device;
    4. **quarantine**: its slot gets an all-NA result and its index lands
       in ``ctx["quarantined"]``.

    Every rung is counted, appended to ``fault_ladder`` and runs as a
    stage (the retry's is its backoff), stamped on the group's window
    self-traces."""
    rung_keys = _group_keys(spec.group)

    def maybe_rebuild(e: BaseException) -> None:
        dc = pg.get("devcols_items")
        if dc and _is_devcols_fault(e):
            _rebuild_rings([r for it in dc for r in (it["ring_in"], it["ring_out"])], st)

    maybe_rebuild(err)
    for attempt in range(run.retry_max):
        st.add("fault_retries")
        st.note("fault_ladder", "retry")
        with st.stage("retry", group=spec.index, trace_keys=rung_keys):
            if run.retry_backoff_s > 0:
                time.sleep(run.retry_backoff_s * (2 ** attempt))
        try:
            _attempt_group(pg, spec, results, st, run, ctx)
            st.add("fault_recovered_retry")
            return
        except Exception as e:  # noqa: BLE001 — classified below
            if not _faults.is_transient_fault(e):
                raise
            err = e
            maybe_rebuild(err)

    if len(spec.group) > 1:
        st.add("fault_bisections")
        st.note("fault_ladder", "bisect")
        with st.stage("bisect", group=spec.index, trace_keys=rung_keys):
            mid = len(spec.group) // 2
            halves = [_make_spec(half, score_itemsize(run.hypers["precision"]))
                      for half in (spec.group[:mid], spec.group[mid:])]
        for half_spec in halves:
            half_spec.index = spec.index
            half_pg = _pack_group(half_spec, st, run)
            try:
                _attempt_group(half_pg, half_spec, results, st, run, ctx)
            except Exception as e:  # noqa: BLE001
                _enter_ladder(e, half_pg, half_spec, results, st, run, ctx)
        return

    plan = spec.group[0]
    st.add("fault_host_fallbacks")
    st.note("fault_ladder", "host")
    try:
        with st.stage("host-fallback", group=spec.index, trace_keys=rung_keys):
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
    with st.stage("quarantine", group=spec.index, trace_keys=rung_keys):
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
            _decode_group(pend, results, st, run, ctx, spec.index)
        except Exception as e:  # noqa: BLE001
            _enter_ladder(e, pg, spec, results, st, run, ctx)

    for spec in specs:
        if total_live + spec.cost > run.budget_bytes:
            for entry in pending:
                finish(entry)
            pending, total_live = [], 0
        total_live += spec.cost
        pg = _pack_group(spec, st, run)
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
        pack_futs = [pack_pool.submit(_pack_group, spec, st, run) for spec in specs]
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


def _rebuild_rings(rings, st: _Stats) -> None:
    """The supervisor's ring-rebuild rung: each distinct ring's device
    buffer is rewritten from its host mirror, every slot where it was
    (:meth:`~traceweaver_tpu_torch.ops.devcols.ColumnRing.rebuild`), so
    the index arrays of groups in flight stay valid; the re-shipped
    arena is billed to ``h2d_bytes_ring`` and the rung lands in the
    ladder list, the ladder counter and the event sink."""
    seen = {id(r): r for r in rings}
    for ring in seen.values():
        st.add("h2d_bytes_ring", float(ring.rebuild()))
    if seen:
        st.add("devcols_ring_rebuilds", float(len(seen)))
        st.note("fault_ladder", "ring-rebuild")


def _is_devcols_fault(err: BaseException) -> bool:
    """Did the failure come from the ``devcols`` fault site? Only those
    implicate the rings' contents."""
    return isinstance(err, _faults.FaultError) and "'devcols'" in str(err)


def _resolve_group_devcols(group, st: _Stats, run: _Run):
    """Resolve every item of a group onto its (tenant, service) column
    rings on the device, appending only spans not resident yet. Returns
    one ``(in_slots, out_slots, ring_in, ring_out, live)`` a item
    (``live``: the lowest sequence the item names in each ring), or None
    when any partition cannot ride the resident path (non-integral µs, a
    window origin outside the rings' int32 epoch span, a partition
    larger than a ring) or a later item's appends evicted an earlier
    item's slots twice over: the whole group then packs on the host, so
    one group never mixes the two paths."""
    for _ in range(2):
        resolved = _resolve_items(group, st, run)
        if resolved is None:
            return None
        if all(r[2].is_live(r[4][0]) and r[3].is_live(r[4][1]) for r in resolved):
            return resolved
        # a re-epoch or the wrap evicted an earlier item's slots: once
        # more, on the settled epoch
        st.add("devcols_reresolves")
    return None


def _resolve_items(group, st: _Stats, run: _Run):
    store = _devcols.get_store()
    resolved = []
    for i, item, prep, windows, ranges, skip_caps, _, _ in group:
        in_cols, out_cols = prep.get("in_cols"), prep.get("out_cols")
        if in_cols is None or out_cols is None or not windows:
            return None
        ring_in = store.ring(item.tenant, item.svc, "in", run.device, run.ring_capacity)
        ring_out = store.ring(item.tenant, item.svc, "out", run.device, run.ring_capacity)
        scope = (item.tenant, item.svc)
        try:
            # fault site "devcols", resolve flavour: a failed append leaves
            # the ring untrusted, so the rings are rebuilt from their host
            # mirrors before the resolve goes on
            _fault_check("devcols", st, run.faults)
        except _faults.FaultError:
            _rebuild_rings((ring_in, ring_out), st)
        got = ring_in.resolve(in_cols, ledger=st.add, scope=scope)
        if got is None:
            return None
        in_slots, live_in = got
        out_slots, live_out = {}, _devcols._NO_SEQ
        for ep in prep["out_eps"]:
            got = ring_out.resolve(out_cols[ep], endpoint=ep, ledger=st.add,
                                       scope=scope)
            if got is None:
                return None
            out_slots[ep] = got[0]
            live_out = min(live_out, got[1])
        # the window origins must be representable against both rings'
        # epochs (the gathers subtract them in int32)
        origins = in_cols.start[[lo for lo, _ in windows]]
        for ring in (ring_in, ring_out):
            if ring.epoch is None:
                return None
            if np.any(np.abs(origins - ring.epoch) >= _devcols._INT32_SPAN):
                return None
        resolved.append((in_slots, out_slots, ring_in, ring_out, (live_in, live_out)))
    return resolved


def _pack_group(spec: _GroupSpec, st: _Stats, run: _Run):
    """Host packing of one group (numpy): concatenated window tensors
    (each item's rows cut to its exact window count), stacked tables,
    the refit row map, the group's neighbour bounds and the host-side
    tenancy column. With ``run.devcols`` the items are resolved onto the
    device's column rings first and pack index arrays
    (:func:`_pack_problem_devcols`); only the skip and force tensors
    concatenate on the host, and the dispatch gathers the window
    tensors. A group the rings cannot hold packs on the host
    (``devcols_fallbacks``)."""
    trace_keys = _group_keys(spec.group)
    with st.stage("pack", "pack_s", group=spec.index, trace_keys=trace_keys):
        table_rows: Dict[str, List[np.ndarray]] = {k: [] for k in _TABLE_KEYS}
        per_item_pack = []
        param_idx: List[int] = []
        # per-window tenant indices into a group-local table (never shipped)
        tenant_table = sorted({item.tenant for _, item, *_ in spec.group
                               if item.tenant is not None})
        tenant_of = {t: ti for ti, t in enumerate(tenant_table)}
        tenant_idx: List[int] = []
        dc_resolved = None
        if run.devcols:
            dc_resolved = _resolve_group_devcols(spec.group, st, run)
            if dc_resolved is None:
                st.add("devcols_fallbacks")
        batch_keys = _DEVCOLS_BATCH_KEYS if dc_resolved is not None else _BATCH_KEYS
        batch_parts: Dict[str, List[np.ndarray]] = {k: [] for k in batch_keys}
        devcols_items: List[Dict] = []
        for p, plan in enumerate(spec.group):
            i, item, prep, windows = plan[:4]
            if dc_resolved is not None:
                in_slots, out_slots, ring_in, ring_out, live = dc_resolved[p]
                packed = _pack_problem_devcols(
                    prep["in_spans"], item.out_span_partitions, prep["out_eps"],
                    prep["dists"], prep["in_ep"], item.dag, in_slots, out_slots,
                    ring_in, ring_out, **_pack_kw(plan, spec))
            else:
                packed = _host_pack(plan, spec)
            n_w = len(windows)
            for key in batch_keys:
                batch_parts[key].append(packed.arrays[key][:n_w])
            if dc_resolved is not None:
                dc = packed.devcols
                devcols_items.append(dict(
                    n_w=n_w, ring_in=dc["ring_in"], ring_out=dc["ring_out"], live=live,
                    in_idx=dc["in_idx"][:n_w], out_idx=dc["out_idx"][:n_w],
                    origin_in=dc["origin_in"][:n_w], origin_out=dc["origin_out"][:n_w]))
            packed.truncate_rows(n_w)
            for key in _TABLE_KEYS:
                table_rows[key].append(packed.arrays[key])
            param_idx.extend([p] * n_w)
            tenant_idx.extend([tenant_of.get(item.tenant, -1)] * n_w)
            if item.tenant is not None:
                st.bucket("tenant_windows_packed", item.tenant, float(n_w))
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

    st.add("fleet_dispatches", 1.0)
    st.add("fleet_services", float(len(per_item_pack)))
    st.add("fused_em_applied" if spec.n_passes == 2 else "fleet_dynamism_dispatches",
           1.0)
    return dict(batch=batch, params=params,
                pidx=np.asarray(param_idx, dtype=np.int32),
                window_rows=window_rows, window_valid=window_valid,
                per_item_pack=per_item_pack, max_preds=max_preds,
                max_succs=max_succs, n_rows=row0, trace_keys=trace_keys,
                tenant_table=tenant_table,
                tenant_col=np.asarray(tenant_idx, dtype=np.int32),
                devcols_items=devcols_items if dc_resolved is not None else None)


def _pack_kw(plan, spec: _GroupSpec) -> Dict:
    """The packer keywords of one planned item in its group's geometry."""
    _, _, prep, windows, ranges, skip_caps, _, _ = plan
    return dict(force_skip_ids=prep["force_skip_ids"], parallel=False,
                windows=windows, pad_w=spec.W_pad, pad_m=spec.M_pad,
                pad_e=spec.E_pad, ranges=ranges, skip_caps=skip_caps,
                in_cols=prep["in_cols"], out_cols=prep["out_cols"])


def _host_pack(plan, spec: _GroupSpec):
    """One planned item through the host packer."""
    _, item, prep = plan[:3]
    return pack_problem(prep["in_spans"], item.out_span_partitions, prep["out_eps"],
                        prep["dists"], prep["in_ep"], item.dag, **_pack_kw(plan, spec))


def _make_assembler(pg, spec: _GroupSpec, st: _Stats, run: _Run):
    """The device-assembly closure of one resident group:
    ``assemble(active, pad)`` returns the eight window tensors in
    ``_BATCH_KEYS`` order for the rows ``active`` (None: all, else
    ascending indices) plus ``pad`` all-invalid rows, in place of
    ``_place`` at every dispatch site (warm, redispatch, refit, retry).
    Each item gathers its rows from its own rings; each call gathers
    fresh tensors (a failed attempt's can never poison a retry) and
    ships only the int32 index arrays (``h2d_bytes_index``) and the skip
    and force tensors (``h2d_bytes_shipped``).

    When a gather finds its slots evicted since the resolve (the rings'
    working set outgrew them), the group packs on the host for this and
    every later call, counted in ``devcols_fallbacks``: the same tensors,
    shipped."""
    dc_items, batch = pg["devcols_items"], pg["batch"]
    bounds = np.cumsum([0] + [it["n_w"] for it in dc_items])
    host: Dict[str, np.ndarray] = {}

    def host_batch() -> Dict[str, np.ndarray]:
        if not host:
            st.add("devcols_fallbacks")
            parts: Dict[str, List[np.ndarray]] = {k: [] for k in _BATCH_KEYS}
            for plan in spec.group:
                packed = _host_pack(plan, spec)
                for k in _BATCH_KEYS:
                    parts[k].append(packed.arrays[k][:len(plan[3])])
            host.update({k: np.concatenate(v) for k, v in parts.items()})
        return host

    def pad_rows(arr, pad, fill):
        if not pad:
            return arr
        return np.concatenate([arr, np.full((pad,) + arr.shape[1:], fill, dtype=arr.dtype)])

    def assemble(active: Optional[np.ndarray], pad: int) -> Tuple:
        # fault site "devcols", gather flavour: it surfaces from the
        # dispatch attempt, and the ladder's first move for it is the
        # ring rebuild, so every retry gathers from trusted rings
        _fault_check("devcols", st, run.faults)
        if host:
            return _host_rows(host, active, pad, st, run.device)
        parts = []
        n_index = 0
        for it, r0, r1 in zip(dc_items, bounds[:-1], bounds[1:]):
            rows = (slice(None) if active is None
                    else active[(active >= r0) & (active < r1)] - r0)
            si, so = it["in_idx"][rows], it["out_idx"][rows]
            if si.shape[0] == 0:
                continue
            oi, oo = it["origin_in"][rows], it["origin_out"][rows]
            n_index += si.nbytes + so.nbytes + oi.nbytes + oo.nbytes
            got = _devcols.assemble_resident(it["ring_in"], it["ring_out"], si, so,
                                             oi, oo, live=it["live"])
            if got is None:
                host_batch()
                return _host_rows(host, active, pad, st, run.device)
            parts.append(got)
        st.add("h2d_bytes_index", float(n_index))
        outs = [torch.cat([p[k] for p in parts]) if len(parts) > 1 else parts[0][k]
                for k in range(6)]
        if pad:
            outs = [torch.cat([o, torch.zeros((pad,) + o.shape[1:], dtype=o.dtype,
                                              device=o.device)]) for o in outs]
        sel = slice(None) if active is None else active
        skip_cap = pad_rows(batch["skip_cap"][sel], pad, 0)
        force_skip = pad_rows(batch["force_skip"][sel], pad, False)
        st.add("h2d_bytes_shipped", float(skip_cap.nbytes + force_skip.nbytes))
        return tuple(outs) + (torch.as_tensor(skip_cap, device=run.device),
                              torch.as_tensor(force_skip, device=run.device))

    assemble.n_rows = int(bounds[-1])
    return assemble


def _host_rows(host: Dict[str, np.ndarray], active, pad: int, st: _Stats, dev) -> Tuple:
    """A host-packed batch's rows ``active`` plus ``pad`` all-invalid
    rows, shipped (``h2d_bytes_shipped``)."""
    arrs = {}
    for k in _BATCH_KEYS:
        a = host[k] if active is None else host[k][active]
        if pad:
            a = np.concatenate([a, np.zeros((pad,) + a.shape[1:], dtype=a.dtype)])
        arrs[k] = a
    st.add("h2d_bytes_shipped", float(sum(a.nbytes for a in arrs.values())))
    # twlint-torch: disable=TW003 — the batch's host-to-device copy, billed
    # above: a copy from pageable memory waits for its stream
    return tuple(torch.as_tensor(arrs[k], device=dev) for k in _BATCH_KEYS)


def _place(arrs: Dict[str, np.ndarray], pidx: np.ndarray, dev, st: _Stats):
    """Fresh device copies of the window tensors and the param index,
    billed to ``h2d_bytes_shipped``."""
    st.add("h2d_bytes_shipped", float(sum(arrs[k].nbytes for k in _BATCH_KEYS)))
    # twlint-torch: disable=TW003 — the window tensors' host-to-device copy,
    # billed above: a copy from pageable memory waits for its stream
    return (tuple(torch.as_tensor(arrs[k], device=dev) for k in _BATCH_KEYS)
            + (torch.as_tensor(pidx, device=dev),))


def _dispatch_packed(pg, spec: _GroupSpec, st: _Stats, run: _Run):
    """Run one packed group's device solve and return its decode ticket
    ``(per_item_pack, out, confidence)``: ``out`` is a host array from
    the compacted flow or a mesh, else the packed device block; ``confidence``
    says whether it carries the confidence channels. With a plan cache,
    a two-pass group's refit tables are decoded and admitted here, after
    the dispatch time is taken (billed to ``plan_fit_s``)."""
    dev, mesh = run.device, run.mesh
    hypers = dict(run.hypers, max_preds=pg["max_preds"], max_succs=pg["max_succs"])
    dc_items = pg.get("devcols_items")
    assemble = (_make_assembler(pg, spec, st, run)
                if dc_items is not None else None)
    # the tenancy column rides the ticket so the compacted flow can
    # attribute straggler redispatches per tenant
    tenant_table = pg.get("tenant_table") or None
    tenant_col = pg.get("tenant_col") if tenant_table else None
    use_compact = (run.compaction and run.sweep_warm < run.n_sweeps
                   and pg["n_rows"] > 1)
    batch, pidx = pg["batch"], pg["pidx"]
    if mesh is not None:
        # the rows pad on the host to a power of two a shard (fresh
        # arrays: a retry pads the packed group again)
        batch, true_b = _pad_batch(batch, bucket_rows_per_shard(pg["n_rows"], mesh.size))
        n_pad = batch["in_start"].shape[0] - true_b
        pidx = np.concatenate([pidx, np.zeros(n_pad, dtype=pidx.dtype)])
        if tenant_col is not None:
            # padding rows belong to no tenant
            tenant_col = np.concatenate([tenant_col,
                                         np.full(n_pad, -1, dtype=tenant_col.dtype)])
    flow_wait: List[float] = []
    refit_sink = [] if (run.plan_cache is not None and spec.n_passes == 2) else None
    trace_keys = pg.get("trace_keys") or ()
    # the JAX package opens this range on the uncompacted branch only;
    # here it spans the group's whole device solve, so the default
    # (compacted) flow shows it too, its stages nested inside
    with st.stage("dispatch", group=spec.index, trace_keys=trace_keys) as sp:
        if use_compact:
            out = _solve_group_compacted(
                batch, pidx, pg["params"], pg["window_rows"],
                pg["window_valid"], spec.n_passes, run.n_sweeps, run.sweep_warm,
                hypers, st, dev, run.faults, flow_wait=flow_wait,
                refit_sink=refit_sink, trace_keys=trace_keys, assemble=assemble,
                tenant_col=tenant_col, tenant_table=tenant_table, mesh=mesh,
                plan_rows=pg["n_rows"])
        elif mesh is not None:
            out = _solve_group_mesh(
                batch, pidx, pg["params"], pg["window_rows"], pg["window_valid"],
                spec.n_passes, run.n_sweeps, hypers, st, mesh, pg["n_rows"],
                run.faults, flow_wait=flow_wait, refit_sink=refit_sink)
        else:
            common = (_place(pg["batch"], pg["pidx"], dev, st) if assemble is None
                      else assemble(None, 0) + (torch.as_tensor(pg["pidx"], device=dev),))
            tables = _tables_on(pg["params"], dev)
            if spec.n_passes == 2:
                out, _ = solve_em_fleet(
                    *common, torch.as_tensor(pg["window_rows"], device=dev),
                    torch.as_tensor(pg["window_valid"], device=dev), *tables,
                    n_sweeps=run.n_sweeps, **hypers)
            else:
                out, _ = solve_windows_fleet(*common, *tables,
                                             n_sweeps=run.n_sweeps, **hypers)
    dispatch_s = sp.seconds - sum(flow_wait)
    st.add("dispatch_s", dispatch_s)
    _OBS_DISPATCH_S.observe(dispatch_s)
    if refit_sink:
        # the device already fitted the next round's plan: keep it
        with st.stage("plan-admit", "plan_fit_s", group=spec.index):
            # twlint-torch: disable=TW003 — the plan cache's admission: the
            # refit tables once a group, billed to plan_fit_s
            tables9 = tuple(t.cpu().numpy() for t in refit_sink[0])
            for p, (_, item, prep, _, _) in enumerate(pg["per_item_pack"]):
                if item.warm_dists is None:
                    run.plan_cache.admit(_plan_key(item), dists_from_tables(
                        prep["out_eps"], prep["in_ep"], *(t[p] for t in tables9)))
    return pg["per_item_pack"], out, hypers["confidence"]


def _tables_on(params: Dict[str, np.ndarray], dev) -> Tuple[torch.Tensor, ...]:
    # twlint-torch: disable=TW003 — the group's parameter tables (a few KB)
    # to the device: a copy from pageable memory waits for its stream
    return tuple(torch.as_tensor(params[k], device=dev) for k in _TABLE_KEYS)


def _shard_tables(tables, mesh: Mesh) -> List[Tuple[torch.Tensor, ...]]:
    """The tables (numpy or tensors) as one tuple a shard, copied once
    per distinct device."""
    per_table = [replicate(t, mesh) for t in tables]
    return [tuple(t[s] for t in per_table) for s in range(mesh.size)]


def _mesh_solve(arrs: Dict[str, np.ndarray], pidx: np.ndarray, tables, n_sweeps: int,
                hypers, st: _Stats, mesh: Mesh, plan_rows: int):
    """One ``solve_windows_fleet`` dispatch sharded over ``mesh``: each
    shard's contiguous rows of the host batch (a multiple of the mesh
    size) solve on its device with ``tables`` (one tuple a shard,
    :func:`_shard_tables`), its launches planned for ``plan_rows``
    blocks (the batch the unsharded flow launches). Returns the packed
    block as one tensor a shard and the convergence flags gathered onto
    the first device."""
    st.add("h2d_bytes_shipped", float(sum(arrs[k].nbytes for k in _BATCH_KEYS)))
    placed = put_sharded({k: arrs[k] for k in _BATCH_KEYS}, mesh)
    slices = shard_slices(len(pidx), mesh)
    outs, flags = [], []
    for s, (sl, dev) in enumerate(zip(slices, mesh.devices)):
        o, f = solve_windows_fleet(
            *(placed[k][s] for k in _BATCH_KEYS),
            torch.as_tensor(pidx[sl], device=dev), *tables[s],
            n_sweeps=n_sweeps, plan_b=plan_rows, **hypers)
        outs.append(o)
        flags.append(f)
    return outs, coalesce_to_device0(flags, mesh)


def _compacted_pass(batch, pidx, tables, n_sweeps, warm, hypers, stats, device,
                    faults=None, flow_wait=None, trace_keys=(), assemble=None,
                    tenant_col=None, tenant_table=None, mesh=None,
                    plan_rows=None) -> np.ndarray:
    """One solve pass as a warm dispatch of ``warm`` sweeps plus a full
    redispatch of only the unconverged windows. Returns the packed
    ``[B, E, W, 3 + topk]`` block on the host; ``batch``/``pidx`` are
    host numpy, ``tables`` numpy or tensors. With ``assemble`` (a
    resident group) both dispatches gather their window tensors from the
    rings; ``tenant_col`` attributes the redispatched windows per
    tenant (``tenant_windows_redispatched``).

    With ``mesh`` every dispatch is sharded (:func:`_mesh_solve`, planned
    for ``plan_rows`` blocks in the warm dispatch and for the unsharded
    redispatch's batch in the redispatch), the flags come back in one
    fetch from the first device, and the redispatch pads per shard."""
    st = _as_stats(stats)
    if mesh is None:
        tables = tuple(torch.as_tensor(t, device=device) for t in tables)
    else:
        tables = _shard_tables(tables, mesh)
    n_shards = mesh.size if mesh is not None else 1

    def rows_of(a, rows, pad):
        # the rows ``rows`` (None: all) plus ``pad`` all-invalid padding
        # rows: no valid spans or columns, decoded by nobody
        a = np.asarray(a)
        if rows is None:
            return a
        return np.concatenate([a[rows], np.zeros((pad,) + a.shape[1:], dtype=a.dtype)])

    def solve(rows, pad, sweeps, rows_unsharded):
        p = rows_of(pidx, rows, pad)
        if mesh is not None:
            return _mesh_solve({k: rows_of(batch[k], rows, pad) for k in _BATCH_KEYS}, p,
                               tables, sweeps, hypers, st, mesh, rows_unsharded)
        if assemble is not None:
            common = assemble(rows, pad) + (torch.as_tensor(p, device=device),)
        else:
            common = _place({k: rows_of(batch[k], rows, pad) for k in _BATCH_KEYS}, p,
                            device, st)
        return solve_windows_fleet(*common, *tables, n_sweeps=sweeps, **hypers)

    with st.stage("warm-dispatch"):
        out_warm, flags = solve(None, 0, warm, plan_rows)
    st.add("d2h_flag_fetches", 1.0)
    with st.stage("flag-fetch", trace_keys=trace_keys, trace_stage="compact-fetch"):
        converged = _fetch(flags, st, faults, flag_fetch=True,
                           flow_wait=flow_wait).astype(bool)
    active = np.flatnonzero(~converged)
    st.add("compact_windows_total", float(converged.shape[0]))
    st.add("compact_windows_redispatched", float(active.size))
    if tenant_col is not None and active.size:
        ids, counts = np.unique(np.asarray(tenant_col)[active], return_counts=True)
        for t_i, c in zip(ids.tolist(), counts.tolist()):
            if t_i >= 0:
                st.bucket("tenant_windows_redispatched", tenant_table[t_i], float(c))
    if active.size == 0:
        return _fetch(out_warm, st, faults, flow_wait=flow_wait)
    # stragglers rerun from sweep 0, padded with all-invalid rows to a
    # power of two (a shard)
    pad = bucket_rows_per_shard(int(active.size), n_shards) - int(active.size)
    with st.stage("redispatch", trace_keys=trace_keys):
        out_full, _ = solve(active, pad, n_sweeps, _bucket(int(active.size), minimum=1))
    out = _fetch(out_warm, st, faults, flow_wait=flow_wait).copy()
    out[active] = _fetch(out_full, st, faults, flow_wait=flow_wait)[:active.size]
    return out


def _solve_group_passes(run_pass, batch, pidx, params, window_rows, window_valid,
                        n_passes, device, refit_sink=None, assemble=None) -> np.ndarray:
    """One group's passes, each ``run_pass(tables)`` returning its packed
    block on the host: pass 0, for two-pass groups
    :func:`refit_fleet_params` on pass 0's assignments (the refit
    :func:`solve_em_fleet` runs) on ``device`` over the whole batch, then
    pass 1. ``refit_sink`` (a list) receives the refit tables for the
    plan cache. With ``assemble`` the refit's samples gather from the
    resident rings."""
    tables = _tables_on(params, device)
    out0 = run_pass(tables)
    if n_passes == 1:
        return out0

    def on(a):
        # twlint-torch: disable=TW003 — the refit's span columns to the
        # device (the host packer's groups): a pageable copy waits
        return torch.as_tensor(a, device=device)

    if assemble is not None:
        bi = dict(zip(_BATCH_KEYS, assemble(None, 0)))
    else:
        bi = {k: on(batch[k]) for k in ("in_start", "in_end", "in_valid",
                                        "out_start", "out_end")}
    new_tables = refit_fleet_params(
        on(out0[..., _layout.CH_ASSIGN]),
        *(bi[k] for k in ("in_start", "in_end", "in_valid", "out_start", "out_end")),
        on(pidx), on(window_rows), on(window_valid), *tables[:2], *tables[3:])
    if refit_sink is not None:
        refit_sink.append(new_tables)
    return run_pass(tables[:3] + tuple(new_tables))


def _solve_group_compacted(batch, pidx, params, window_rows, window_valid,
                           n_passes, n_sweeps, warm, hypers, stats, device,
                           faults=None, flow_wait=None,
                           refit_sink=None, trace_keys=(), assemble=None,
                           tenant_col=None, tenant_table=None, mesh=None,
                           plan_rows=None) -> np.ndarray:
    """The compacted counterpart of one group dispatch: a compacted pass
    0, for two-pass groups the refit, then a compacted pass 1
    (:func:`_solve_group_passes`). With ``assemble`` every dispatch and
    the refit's samples gather from the resident rings. With ``mesh`` the
    passes are sharded (:func:`_compacted_pass`) and the refit runs on
    ``device``, the mesh's first, over every shard's windows."""
    st = _as_stats(stats)

    def run_pass(tables):
        return _compacted_pass(batch, pidx, tables, n_sweeps, warm, hypers, st, device,
                               faults, flow_wait, trace_keys, assemble=assemble,
                               tenant_col=tenant_col, tenant_table=tenant_table,
                               mesh=mesh, plan_rows=plan_rows)

    return _solve_group_passes(run_pass, batch, pidx, params, window_rows, window_valid,
                               n_passes, device, refit_sink, assemble)


def _solve_group_mesh(batch, pidx, params, window_rows, window_valid, n_passes,
                      n_sweeps, hypers, st: _Stats, mesh: Mesh, plan_rows: int,
                      faults=None, flow_wait=None, refit_sink=None) -> np.ndarray:
    """A mesh's uncompacted group dispatch: each pass one full sharded
    dispatch of ``n_sweeps`` (:func:`_mesh_solve`) fetched to the host,
    with the refit between them on the mesh's first device over every
    shard's windows (:func:`_solve_group_passes`), where the one-device
    flow runs :func:`solve_em_fleet` on the device."""
    def run_pass(tables):
        out, _ = _mesh_solve(batch, pidx, _shard_tables(tables, mesh), n_sweeps, hypers,
                             st, mesh, plan_rows)
        return _fetch(out, st, faults, flow_wait=flow_wait)

    return _solve_group_passes(run_pass, batch, pidx, params, window_rows, window_valid,
                               n_passes, mesh.devices[0], refit_sink)


def _decode_group(pend, results, st: _Stats, run: _Run, ctx,
                  group: Optional[int] = None) -> None:
    """Fetch group ``group``'s packed output (unless the compacted flow
    already did) and decode it per service (:func:`decode_service`, which
    counts ``decode_answers`` and ``decode_contested``) into its
    input-order slot, with the item's confidence records when the caller
    asked for them."""
    per_item_pack, out, conf_device = pend
    confidences = ctx["confidences"]
    o = out if isinstance(out, np.ndarray) else _fetch(out, st, run.faults, group=group)
    with st.stage("decode", "decode_s", group=group,
                  trace_keys=_group_keys(per_item_pack)):
        row = 0
        for i, item, prep, packed, n_w in per_item_pack:
            rows = o[row:row + n_w]
            ch = _layout.split_packed(rows, confidence=conf_device)
            row += n_w
            if item.tenant is not None:
                # the tenancy column's decode end: packed equals decoded
                st.bucket("tenant_windows_decoded", item.tenant, float(n_w))
            in_ids = prep["in_cols"].ids.tolist()
            if confidences is not None:
                arrs = _quality.span_confidence_arrays(packed.windows, rows, prep["n_in"],
                                                       device=conf_device)
                confidences[i] = _quality.confidence_records(in_ids, arrs)
            results[i], counts = decode_service(
                [(packed, ch["assign"], ch["topk_cols"], ch["not_best"], ch["feas"])],
                prep["out_eps"], in_ids, prep["skip_budget"])
            st.merge(counts)
