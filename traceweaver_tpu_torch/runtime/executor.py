"""The experiment executor (mirrors ``traceweaver_tpu/runtime/executor.py``).

Load a trace corpus, run the selected predictors over every solvable
service (with load compression and cache-hit injection), aggregate
per-service and end-to-end accuracies, and write the five result-pickle
families the JAX package writes, under the same names::

    bin_acc_* accuracy_* e2e_* confidence_scores_* process_acc_*

each suffixed ``_{test}_{load}_{compress}_{repeat}_{cache}.pickle``.

The flagship (slot 10, ``MaxScoreBatchSubsetWithSkips``) solves all
services of a corpus in one :func:`~traceweaver_tpu_torch.algorithms.fleet.solve_fleet`
call; every other method solves service by service, on a thread pool
when ``execute_parallel``. ``device`` is where slots 8-10 run: None
means the card, and raises without one. With ``gt_free_dag`` each
service's invocation DAG is discovered from a ``WeaverTorch`` on that
device (``ingest.discover_invocation_dag``, once per service, memoized on
the store) instead of inferred from ground truth, which then only grades
(lines 84-90 and 135-150 of the JAX executor). ``precision`` and
``score_gemm`` (the JAX executor's ``TW_PRECISION`` and
``TW_SCORE_GEMM``) go to every ``WeaverTorch`` of the run, discovery's
too; a run at ``bf16`` says so in its log, as the JAX executor does
(its lines 276-284). ``mesh_devices`` (the JAX executor's, which its
CLI maps from ``TW_MESH_DEVICES``) shards the window batches of slots
8-10, the fleet route's included, over a mesh
(:func:`~traceweaver_tpu_torch.parallel.mesh.mesh_for`: the first N
cards, or N CPU shards when the device is the CPU), built before the
corpus loads, so a mesh the machine
cannot hold fails first. The JAX executor's AOT warmup has no
counterpart (the port compiles no programs at run time).
"""

from __future__ import annotations

import concurrent.futures
import math
import os
import pickle
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.algorithms import make_predictors
from traceweaver_tpu_torch.ingest import (
    build_service_problem,
    discover_invocation_dag,
    infer_invocation_dag,
    load_corpus,
)
from traceweaver_tpu_torch.metrics import (
    accuracy_end_to_end,
    accuracy_for_service,
    bin_accuracy_by_response_times,
    construct_end_to_end_traces,
    get_ground_truth,
    topk_accuracy_end_to_end,
    topk_accuracy_for_service,
)
from traceweaver_tpu_torch.obs.profile import annotate
from traceweaver_tpu_torch.ops.precision import score_itemsize
from traceweaver_tpu_torch.spans import TraceStore
from traceweaver_tpu_torch.synth import compress_spans, create_cache_hits

# method-name groups controlling dispatch, as in the JAX executor
SIX_TUPLE_METHODS = {
    "MaxScoreBatchSubsetWithSkips",
    "MaxScoreBatchSubsetWithTrueSkips",
    "MaxScoreBatchSubsetWithTrueDist",
    "MaxScoreBatchParallelWithoutIterations",
}
NEEDS_DAG_METHODS = SIX_TUPLE_METHODS | {"MaxScoreBatchParallel"}
# cache-hit injection applies to every method except these
NO_CACHE_METHODS = {"MaxScoreBatch", "MaxScoreBatchParallel", "FCFS",
                    "ArrivalOrder"}
CONFIDENCE_METHODS = {"MaxScoreBatch", "MaxScoreBatchSubsetWithSkips"}
FLEET_METHOD = "MaxScoreBatchSubsetWithSkips"

# create_cache_hits reseeds and draws from the global random generators:
# services prepared on the thread pool take turns there
_GLOBAL_RNG_LOCK = threading.Lock()


@dataclass
class ExecutorConfig:
    """The JAX executor's configuration; ``device`` is where slots 8-10
    run (None: the card). Unlike the JAX config it has no ``fleet``
    switch: slot 10 takes the fleet route unless ``parallel`` is set."""

    data_path: str
    results_directory: str
    fix: int
    cache_rate: float = 0.0
    load_level: int = 0
    test_name: str = "test"
    parallel: bool = False
    instrumented: bool = False
    repeat_factor: int = 1
    compress_factor: float = 1.0
    execute_parallel: bool = True
    clear_cache: bool = False
    compressed: bool = False
    predictor_indices: List[int] = field(default_factory=list)
    max_traces: int = 1000
    # malformed span records raise at ingest instead of skip-and-count
    strict_ingest: bool = False
    # replica table for compress-factor scaling (None: 1 replica each)
    service_to_replica: Optional[Dict[str, list]] = None
    device: Optional[str] = None
    # discover each service's invocation DAG without ground truth
    gt_free_dag: bool = False
    # score-block precision ("f32" or "bf16") and the GEMM score form
    precision: str = "f32"
    score_gemm: bool = False
    # devices of a 1-D mesh for slots 8-10 (0 = one device; else a power
    # of two)
    mesh_devices: int = 0

    def replica_count(self, process: str, store: TraceStore) -> int:
        table = self.service_to_replica
        if table is None:
            return 1
        if process in table:
            return len(table[process])
        if process.endswith("-loop") and process in store.service_loop_map:
            origin = store.service_loop_map[process]
            if origin in table:
                return len(table[origin])
        return 1


def load_replica_table(path: str) -> Optional[Dict[str, list]]:
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    return None


def _prepare_service(cfg: ExecutorConfig, store: TraceStore, method: str,
                     process: str):
    """Problem, ground truth, invocation DAG and the load and cache-hit
    transforms of one service; None when the service is skipped."""
    with annotate("tw:executor:prepare"):
        prob = build_service_problem(store, process)
        if prob.skipped:
            return None

        true_assignments = get_ground_truth(
            prob.in_span_partitions, prob.out_span_partitions
        )
        if cfg.gt_free_dag:
            invocation_graph = _discovered_dag(cfg, store, prob, process)
        else:
            invocation_graph = infer_invocation_dag(
                prob.in_span_partitions, prob.out_span_partitions,
                true_assignments, store,
            )

        if cfg.compress_factor > 1:
            replicas = cfg.replica_count(process, store)
            load_factor = max(1, math.ceil(cfg.compress_factor / replicas))
            compress_spans(prob.in_span_partitions, prob.out_span_partitions,
                           cfg.repeat_factor, load_factor)
            true_assignments = get_ground_truth(
                prob.in_span_partitions, prob.out_span_partitions
            )

        if process == "frontend" and method not in NO_CACHE_METHODS:
            with _GLOBAL_RNG_LOCK:
                true_assignments = create_cache_hits(
                    true_assignments, prob.in_span_partitions,
                    prob.out_span_partitions, cache_rate=cfg.cache_rate,
                )
        return dict(prob=prob, true=true_assignments, dag=invocation_graph)


def _discovered_dag(cfg: ExecutorConfig, store: TraceStore, prob, process: str):
    """The service's ground-truth-free DAG, discovered on the first call
    and kept on the store: discovery costs up to three solves and does
    not depend on the method, so a sweep over several methods pays it
    once. ``store.discovery_stats[process]`` gets its seconds."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import WeaverTorch

    dag = store.discovered_dags.get(process)
    if dag is None:
        stats: Dict[str, float] = {}
        t0 = time.perf_counter()
        with annotate("tw:executor:discovery"):
            dag = discover_invocation_dag(
                prob.in_span_partitions, prob.out_span_partitions, store,
                WeaverTorch(store.all_spans, store.all_processes,
                            device=cfg.device, precision=cfg.precision,
                            score_gemm=cfg.score_gemm),
                stats=stats)
        stats["seconds"] = time.perf_counter() - t0
        store.discovery_stats[process] = stats
        store.discovered_dags[process] = dag
    return dag


def _finish_service(prep, process: str, out, elapsed: float):
    """Decode a FindAssignments result into the per-service record."""
    prob, true_assignments = prep["prob"], prep["true"]
    pred_topk = not_best = num_spans = candidates = None
    if isinstance(out, tuple) and len(out) == 6:
        pred, pred_topk, not_best, num_spans, candidates, _unassigned = out
    elif isinstance(out, tuple) and len(out) == 4:
        pred, not_best, num_spans, candidates = out
    else:
        pred = out

    acc = accuracy_for_service(pred, true_assignments, prob.in_span_partitions)
    acc_topk = None
    if pred_topk is not None:
        acc_topk = topk_accuracy_for_service(
            pred_topk, true_assignments, prob.in_span_partitions
        )
    return dict(process=process, true=true_assignments, pred=pred,
                pred_topk=pred_topk, acc=acc, acc_topk=acc_topk,
                not_best=not_best, num_spans=num_spans,
                candidates=candidates, seconds=elapsed)


def _solve_service(cfg: ExecutorConfig, store: TraceStore, method: str,
                   predictor, process: str):
    """One service through ``predictor.FindAssignments``; None when the
    service is skipped."""
    prep = _prepare_service(cfg, store, method, process)
    if prep is None:
        return None
    prob, true_assignments = prep["prob"], prep["true"]

    parallel = cfg.parallel or method in (
        "MaxScoreBatchParallel", "MaxScoreBatchParallelWithoutIterations"
    )
    # always empty, as in the reference (--instrumented is parsed only)
    instrumented_hops: List[int] = []

    start = time.time()
    args = [method, process, prob.in_span_partitions,
            prob.out_span_partitions, parallel, instrumented_hops,
            true_assignments]
    kwargs = {}
    if method in NEEDS_DAG_METHODS:
        args.append(prep["dag"])
    if method == "MaxScoreBatchSubsetWithTrueSkips":
        kwargs = dict(true_skips=True)
    elif method == "MaxScoreBatchSubsetWithTrueDist":
        kwargs = dict(true_dist=True)
    out = predictor.FindAssignments(*args, **kwargs)
    elapsed = time.time() - start
    return _finish_service(prep, process, out, elapsed)


def _solve_fleet_method(cfg: ExecutorConfig, store: TraceStore, method: str,
                        predictor, services: List[str],
                        fleet_stats: Dict[str, float]):
    """Every service of the flagship in one ``solve_fleet`` call, on the
    predictor's device and kernel. ``fleet_stats`` receives the fleet's
    ledger and ``prepare_s``, the host seconds of the per-service
    preambles."""
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet

    t0 = time.perf_counter()
    preps = []
    for process in services:
        prep = _prepare_service(cfg, store, method, process)
        if prep is not None:
            preps.append((process, prep))
    fleet_stats["prepare_s"] = time.perf_counter() - t0
    if not preps:
        return []
    items = [
        FleetItem(process, prep["prob"].in_span_partitions,
                  prep["prob"].out_span_partitions, prep["true"],
                  prep["dag"], method=method, store=store)
        for process, prep in preps
    ]
    start = time.time()
    cells: List[float] = [1.0] * len(items)
    outs = solve_fleet(
        items, max_window=predictor.max_window, epsilon=predictor.epsilon,
        n_sinkhorn=predictor.n_sinkhorn, n_sweeps=predictor.n_sweeps,
        sinkhorn_tol=predictor.sinkhorn_tol, item_cells=cells,
        stats=fleet_stats, precision=predictor.precision,
        device=predictor.device, fused_kernel=predictor.fused_kernel,
        score_gemm=predictor.score_gemm, mesh=predictor.mesh,
    )
    elapsed = time.time() - start
    if predictor.precision != "f32":
        # a reduced-precision run must be unmistakable in the log
        print("[fleet] %s: score-path precision=%s (--precision; byte "
              "ledger accounts at %d B/elem)"
              % (method, predictor.precision, score_itemsize(predictor.precision)))
    print("[fleet] %s: %d dispatches for %d services"
          % (method, int(fleet_stats.get("fleet_dispatches", 0)), len(items)))
    total_w = fleet_stats.get("compact_windows_total", 0)
    if total_w:
        print("[fleet] %s: compaction redispatched %d/%d windows "
              "past the warm sweeps (%d B of flag fetches vs %.1f MB "
              "total D2H)"
              % (method, int(fleet_stats.get(
                  "compact_windows_redispatched", 0)), int(total_w),
                 int(fleet_stats.get("d2h_bytes_flags", 0)),
                 fleet_stats.get("d2h_bytes_fetched", 0.0) / 1e6))
    if fleet_stats.get("pipeline_groups"):
        print("[fleet] %s: pipelined %d dispatch groups at depth %d"
              % (method, int(fleet_stats["pipeline_groups"]),
                 int(fleet_stats.get("pipeline_depth", 0))))
    if fleet_stats.get("fault_retries") or fleet_stats.get("fault_quarantined"):
        print("[fleet] %s: solve supervisor engaged — %d retries, "
              "%d bisections, %d host fallbacks, %d QUARANTINED"
              % (method, int(fleet_stats.get("fault_retries", 0)),
                 int(fleet_stats.get("fault_bisections", 0)),
                 int(fleet_stats.get("fault_host_fallbacks", 0)),
                 int(fleet_stats.get("fault_quarantined", 0))))
    # per-service seconds: the call's wall shared out by padded cells
    total_cells = max(1.0, sum(cells))
    return [_finish_service(prep, process, out, elapsed * c / total_cells)
            for (process, prep), out, c in zip(preps, outs, cells)]


@dataclass
class ExperimentResults:
    accuracy_overall: Dict[str, float]
    accuracy_per_process: Dict[Tuple[str, str], float]
    accuracy_percentile_bins: Dict[str, list]
    traces_overall: Dict[str, list]
    confidence_scores: Dict[str, list]
    candidates_per_process: Dict[str, dict]
    store: TraceStore
    # host seconds: "ingest", then one entry per method key
    seconds: Dict[str, float] = field(default_factory=dict)
    # the solve_fleet ledger of each method key that took the fleet route
    fleet_stats: Dict[str, Dict[str, float]] = field(default_factory=dict)


def maybe_uncompress(data_path: str) -> None:
    """``--compressed``: extract ``<data_path>.tar.*`` next to the
    dataset before loading, unless the directory already holds traces."""
    import tarfile

    if os.path.isdir(data_path) and any(
        name.endswith(".json") for name in os.listdir(data_path)
    ):
        return
    for suffix in (".tar.lama", ".tar.lzma", ".tar.xz", ".tar.gz", ".tar"):
        archive = data_path + suffix
        if os.path.exists(archive):
            with tarfile.open(archive) as tf:
                tf.extractall(data_path + "/", filter="data")
            return
    raise FileNotFoundError(
        f"--compressed: no archive found at {data_path}.tar.*")


def _keyed(predictors):
    """``(result key, method, predictor)``: the registry holds one method
    name twice (slots 1 and 9); the last keeps the bare name, earlier
    ones get ``#k``."""
    total: Dict[str, int] = {}
    for method, _ in predictors:
        total[method] = total.get(method, 0) + 1
    seen: Dict[str, int] = {}
    keyed = []
    for method, predictor in predictors:
        seen[method] = seen.get(method, 0) + 1
        key = method if seen[method] == total[method] else f"{method}#{seen[method]}"
        keyed.append((key, method, predictor))
    return keyed


def run_experiment(cfg: ExecutorConfig,
                   store: Optional[TraceStore] = None) -> ExperimentResults:
    from traceweaver_tpu_torch.algorithms.weaver_torch import (
        WeaverTorch,
        resolve_device,
    )
    from traceweaver_tpu_torch.parallel.mesh import mesh_for

    # no card and no device, or a mesh the machine cannot hold: fail
    # before the corpus loads
    device = resolve_device(cfg.device)
    mesh = mesh_for(cfg.mesh_devices, device)
    seconds: Dict[str, float] = {}
    random.seed(10)
    if store is None:
        t0 = time.perf_counter()
        if cfg.compressed:
            maybe_uncompress(cfg.data_path)
        with annotate("tw:executor:ingest"):
            store = load_corpus(cfg.data_path, cfg.fix, max_traces=cfg.max_traces,
                                clear_cache=cfg.clear_cache,
                                strict=cfg.strict_ingest)
        seconds["ingest"] = time.perf_counter() - t0
    malformed = store.ingest_malformed_spans
    if malformed:
        print("[ingest] WARNING: %d malformed span record(s) skipped and "
              "dead-lettered (run with --strict to raise instead)"
              % malformed)

    predictors = make_predictors(store.all_spans, store.all_processes,
                                 device=device, precision=cfg.precision,
                                 score_gemm=cfg.score_gemm, mesh=mesh)
    if cfg.predictor_indices:
        bad = [i for i in cfg.predictor_indices
               if not 0 <= i < len(predictors)]
        if bad:
            raise ValueError(
                f"predictor indices out of range {bad}; valid: 0.."
                f"{len(predictors) - 1}"
            )
        predictors = [predictors[i] for i in cfg.predictor_indices]

    accuracy_overall: Dict[str, float] = {}
    accuracy_per_process: Dict[Tuple[str, str], float] = {}
    accuracy_percentile_bins: Dict[str, list] = {}
    traces_overall: Dict[str, list] = {}
    confidence_scores: Dict[str, list] = {}
    candidates_per_process: Dict[str, dict] = {}
    fleet_stats: Dict[str, Dict[str, float]] = {}

    for result_key, method, predictor in _keyed(predictors):
        random.seed(10)
        services = list(store.out_spans_by_process.keys())
        t0 = time.perf_counter()
        # --parallel scores parallel siblings in one iteration, which the
        # fleet does not carry: such runs go service by service
        use_fleet = (not cfg.parallel and method == FLEET_METHOD
                     and isinstance(predictor, WeaverTorch))
        if use_fleet:
            fleet_stats[result_key] = {}
            results = _solve_fleet_method(cfg, store, method, predictor,
                                          services, fleet_stats[result_key])
        elif cfg.execute_parallel:
            with concurrent.futures.ThreadPoolExecutor() as pool:
                futures = [
                    pool.submit(_solve_service, cfg, store, method, predictor, p)
                    for p in services
                ]
                # service order, whichever finishes first
                results = [fut.result() for fut in futures]
        else:
            results = [_solve_service(cfg, store, method, predictor, p)
                       for p in services]
        results = [r for r in results if r is not None]

        true_by = {r["process"]: r["true"] for r in results}
        pred_by = {r["process"]: r["pred"] for r in results}
        topk_by = {r["process"]: r["pred_topk"] for r in results
                   if r["pred_topk"] is not None}

        for r in results:
            accuracy_per_process[(result_key, r["process"])] = r["acc"]
            if method in CONFIDENCE_METHODS and r["not_best"] is not None:
                confidence_scores[r["process"]] = [
                    r["acc"], r["not_best"], r["num_spans"]
                ]
            if r["candidates"] is not None:
                candidates_per_process[r["process"]] = r["candidates"]

        trace_acc, acc_e2e = accuracy_end_to_end(
            pred_by, true_by, store.in_spans_by_process
        )
        accuracy_overall[result_key] = acc_e2e * 100
        accuracy_percentile_bins[result_key] = bin_accuracy_by_response_times(
            trace_acc, store.all_spans
        )
        if method == FLEET_METHOD and len(topk_by) == len(pred_by):
            trace_acc2, acc_e2e2 = topk_accuracy_end_to_end(
                topk_by, true_by, store.in_spans_by_process
            )
            accuracy_overall[result_key + "TopK"] = acc_e2e2 * 100
            accuracy_percentile_bins[result_key + "TopK"] = (
                bin_accuracy_by_response_times(trace_acc2, store.all_spans)
            )
        true_e2e, pred_e2e = construct_end_to_end_traces(
            pred_by, true_by, store.in_spans_by_process, store.all_spans
        )
        traces_overall[result_key] = [true_e2e, pred_e2e]
        seconds[result_key] = time.perf_counter() - t0
        print("End-to-end accuracy for method %s: %.3f%%"
              % (result_key, acc_e2e * 100))

    res = ExperimentResults(
        accuracy_overall=accuracy_overall,
        accuracy_per_process=accuracy_per_process,
        accuracy_percentile_bins=accuracy_percentile_bins,
        traces_overall=traces_overall,
        confidence_scores=confidence_scores,
        candidates_per_process=candidates_per_process,
        store=store,
        seconds=seconds,
        fleet_stats=fleet_stats,
    )
    if cfg.results_directory:
        write_result_pickles(cfg, res)
    return res


def result_suffix(cfg: ExecutorConfig) -> str:
    return "_%s_%s_%s_%s_%s.pickle" % (
        cfg.test_name, cfg.load_level, int(cfg.compress_factor),
        int(cfg.repeat_factor), cfg.cache_rate,
    )


RESULT_FAMILIES = ("bin_acc", "accuracy", "e2e", "confidence_scores",
                   "process_acc")


def write_result_pickles(cfg: ExecutorConfig, res: ExperimentResults) -> None:
    """The JAX executor's five families under its file names."""
    os.makedirs(cfg.results_directory or ".", exist_ok=True)
    objs = (res.accuracy_percentile_bins, res.accuracy_overall,
            res.traces_overall, res.confidence_scores,
            res.accuracy_per_process)
    for kind, obj in zip(RESULT_FAMILIES, objs):
        path = os.path.join(cfg.results_directory, kind + result_suffix(cfg))
        with open(path, "wb") as f:
            pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
