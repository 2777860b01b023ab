"""One run of one cell: build the deployment from the seed, warm up, drive
whole fleet rounds back to back for the window, then check what the
window produced.

The entry the window drives is
``traceweaver_tpu_torch.algorithms.fleet.solve_fleet`` over every solvable
service of the corpus, with one plan cache, one round in flight (a closed
loop). Set-up writes the corpus with the configuration's corpus step
(``twbench/corpora/<corpus>.py``), ingests it with the program's
``load_corpus`` (the configuration's ``fix``), builds each service's
problem as ``campaign/corpus.py build_rung`` does and its invocation DAG
with the configuration's DAG step (``twbench/dags/<dag>.py``; what each
step takes, and which configuration keys are read where, is in
:mod:`twbench.spec`), applies exp5's load transform with the benchmark's
copy, and runs warm-up rounds: a cold round, which
fits every service and fills the plan cache, then warm rounds until one
builds no kernel. Set-up ends with a full garbage collection and
``gc.freeze()``: what set-up built (the corpus, the problems, the plan
cache) lives for the whole run, and without the freeze every
full collection in the window walks it again (about a second, every third
round of exp5). A round reuses nothing from an earlier round's spans but
what the plan cache holds by design, the fitted delay mixtures of each
service.

A traced run (``trace``) reads every stage second and counter from the
untraced window, then runs a second window of whole rounds under the
profiler for the device's readings alone (:data:`TRACED_SHARE` of the
first window's length): the profiler slows the host, and the two
windows' median rounds give the slowdown.

After the window: end-to-end accuracy of the last timed round (graded by
:mod:`twbench.grade`), the decode check of that round, one more round with
the reference beside every endpoint step and the reference's own decode
(:mod:`twbench.checks`, :mod:`twbench.decode`), whose answers must equal
the last timed round's, and the reference's fit of the cold round's
refits.
"""

from __future__ import annotations

import contextlib
import gc
import random
import shutil
import statistics
import tempfile
import time
from typing import Callable, Dict, List, Optional

from twbench import checks, generator, grade, roofline, timeline
from twbench.spec import Cell

#: warm rounds at most after the cold round
WARMUP_MAX = 5
#: the traced window's length, as a share of the untraced window's
TRACED_SHARE = 0.5


class GcClock:
    """Seconds the garbage collector held the process, by generation
    (``gc.callbacks``), while registered."""

    def __init__(self):
        self.seconds = [0.0, 0.0, 0.0]
        self.count = [0, 0, 0]
        self._t0 = 0.0

    def __call__(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            g = int(info["generation"])
            self.seconds[g] += time.perf_counter() - self._t0
            self.count[g] += 1

    def __enter__(self) -> "GcClock":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


class Deployment:
    """The corpus of one run: stores, fleet items and the grading truth."""

    def __init__(self, stores, items, truth, spans: int, traces: int):
        self.stores = stores
        self.items = items
        self.truth = truth
        self.spans = spans
        self.traces = traces


def build_deployment(cell: Cell, seed: int, device, log: Callable[[str], None]) -> Deployment:
    """The corpus of ``cell`` from ``seed``: written by the configuration's
    corpus step, ingested, each service's problem with the DAG that the
    configuration's DAG step gives (on ``device``), under exp5's load
    transform, with its grading truth."""
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem
    from traceweaver_tpu_torch.ingest import build_service_problem, load_corpus
    from traceweaver_tpu_torch.metrics import get_ground_truth

    cfg, traffic = cell.config, cell.traffic
    counts = generator.graph_counts(traffic, int(cfg["n_graphs"]))
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="twbench-corpus-")
    try:
        dirs = cell.corpus(root, counts, seed, cfg)
        t1 = time.perf_counter()
        # the loader names self-call services from the global generator
        random.seed(seed)
        stores = [load_corpus(d, fix=int(cfg["fix"]), max_traces=max(counts) + 1,
                              cache=False) for d in dirs]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    t2 = time.perf_counter()
    services = [f"MS_{i:05d}" for i in range(int(cfg["n_services"]))]
    replicas = generator.replica_counts(services, int(cfg["corpus_seed"]),
                                        cfg["replica_dist"])
    items, truth = [], []
    for si, store in enumerate(stores):
        for svc in sorted(store.out_spans_by_process):
            prob = build_service_problem(store, svc, deepcopy=False)
            if prob.skipped:
                continue
            true0 = get_ground_truth(prob.in_span_partitions, prob.out_span_partitions)
            dag = cell.dag(prob, store, true0, device, cfg)
            factor = generator.load_factor(svc, float(cfg["compress"]), replicas,
                                           store.service_loop_map)
            in_parts, out_parts = generator.compress_problem(
                prob.in_span_partitions, prob.out_span_partitions, factor)
            items.append(FleetItem(svc, in_parts, out_parts,
                                   get_ground_truth(in_parts, out_parts), dag,
                                   method=cfg["method"], store=store,
                                   plan_key=f"{si}:{svc}"))
            truth.append(grade.truth(in_parts, out_parts))
    spans = sum(len(s.all_spans) for s in stores)
    traces = sum(len(s.all_processes) for s in stores)
    log(f"[twbench] corpus: {len(dirs)} call graphs, {traces} traces, {spans} spans, "
        f"{len(items)} services; synthesize {t1 - t0:.1f} s, load {t2 - t1:.1f} s, "
        f"problems {time.perf_counter() - t2:.1f} s")
    return Deployment(stores, items, truth, spans, traces)


def _kernel_builds() -> int:
    from traceweaver_tpu_torch.ops import cuda_build

    return len(cuda_build.BUILT)


def _launches() -> Dict[str, int]:
    from traceweaver_tpu_torch.ops import cuda_sinkhorn, scores

    return dict(k1=cuda_sinkhorn.LAUNCHES["fused_assign"],
                assembly=scores.LAUNCHES["assemble_block"])


def solve_round(dep: Deployment, plan_cache, device, solve_kw: Dict, stats: Dict):
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

    quarantined: List[int] = []
    outs = solve_fleet(dep.items, stats=stats, quarantined=quarantined,
                       plan_cache=plan_cache, device=device, **solve_kw)
    return outs, quarantined


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def accuracy_pct(dep: Deployment, outs) -> float:
    """End-to-end accuracy of one round, trace counts weighting the call
    graphs."""
    by_store: Dict[int, Dict] = {}
    for item, tr, out in zip(dep.items, dep.truth, outs):
        si = int(item.plan_key.split(":", 1)[0])
        slot = by_store.setdefault(si, dict(pred={}, true={}, ins={}))
        slot["pred"][item.svc] = out[0]
        slot["true"][item.svc] = tr
        slot["ins"][item.svc] = next(iter(item.in_span_partitions.values()))
    num = den = 0.0
    for si, slot in by_store.items():
        n = len(dep.stores[si].all_processes)
        num += 100.0 * grade.accuracy_end_to_end(slot["pred"], slot["true"], slot["ins"]) * n
        den += n
    return num / max(den, 1.0)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, solve_kw: Optional[Dict] = None,
             log: Callable[[str], None] = lambda s: None,
             dep: Optional[Deployment] = None, fit_control: bool = False) -> Dict:
    """One run; returns the readings every metric and check is made from.
    ``solve_kw`` adds ``solve_fleet`` arguments over the configuration's
    (the control passes ``precision="bf16"``); ``dep`` is a deployment
    already built from ``seed`` (several runs of one corpus in one
    process), else it is built here. ``fit_control`` reads the refit's
    control (:class:`~twbench.checks.Checker`)."""
    import torch

    from traceweaver_tpu_torch.algorithms.plancache import PlanCache
    from traceweaver_tpu_torch.obs import profile as obs_profile

    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    kw = dict(cell.config.get("solve", {}))
    kw.update(solve_kw or {})
    dep = build_deployment(cell, seed, dev, log) if dep is None else dep
    t_built = time.perf_counter()

    # --- warm-up: the cold round fills the plan cache ----------------------
    checker = checks.Checker(dep.items, fit_control=fit_control)
    plan_cache = PlanCache()
    builds = []
    with checker.fit_hooks():
        before = _kernel_builds()
        solve_round(dep, plan_cache, dev, kw, {})
        builds.append(_kernel_builds() - before)
    for _ in range(WARMUP_MAX):
        before = _kernel_builds()
        solve_round(dep, plan_cache, dev, kw, {})
        builds.append(_kernel_builds() - before)
        if builds[-1] == 0:
            break
    _sync(dev)
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - t_start
    log(f"[twbench] set-up {setup_s:.2f} s (warm-up rounds {time.perf_counter() - t_built:.2f} s), "
        f"kernel builds by round {builds}")

    # --- the window ---------------------------------------------------------
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cache0 = plan_cache.counters()
    launches0 = _launches()
    builds0 = _kernel_builds()
    with GcClock() as gc_clock:
        rounds, outs, window_s = _window(dep, plan_cache, dev, kw, seconds)
    builds_in_window = _kernel_builds() - builds0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches1 = _launches()
    cache1 = plan_cache.counters()
    reading = dict(
        setup_s=setup_s, window_s=window_s, rounds=rounds, spans=dep.spans,
        traces=dep.traces, services=len(dep.items),
        failed=sum(r["quarantined"] for r in rounds),
        spans_per_s=len(rounds) * dep.spans / window_s,
        peak_bytes=int(peak), builds=builds, builds_in_window=builds_in_window,
        launches={k: launches1[k] - launches0[k] for k in launches0},
        plan_cache=dict(before=cache0, after=cache1),
        round_median_s=statistics.median(r["wall"] for r in rounds),
        gc_s=gc_clock.seconds, gc_count=gc_clock.count)
    log(f"[twbench] window {window_s:.3f} s, {len(rounds)} rounds, "
        f"{reading['spans_per_s']:.1f} spans/s; round walls "
        f"{[round(r['wall'], 3) for r in rounds]}; garbage collections by generation "
        f"{gc_clock.count}, {[round(t, 3) for t in gc_clock.seconds]} s")
    if trace:
        with obs_profile.profiling(), timeline.trace() as prof:
            t_rounds, outs, t_window_s = _window(dep, plan_cache, dev, kw,
                                                 TRACED_SHARE * seconds)
        reading["trace"] = _read_trace(prof)
        reading["trace"]["slowdown"] = (statistics.median(r["wall"] for r in t_rounds)
                                        / reading["round_median_s"])
        reading["failed"] += sum(r["quarantined"] for r in t_rounds)
        reading["traced_rounds"] = len(t_rounds)
        log(f"[twbench] traced window {t_window_s:.3f} s, {len(t_rounds)} rounds; "
            f"median round {reading['trace']['slowdown']:.3f} x the untraced one")

    # --- after the window: grade and check ------------------------------------
    reading["accuracy_pct"] = accuracy_pct(dep, outs)
    decode_bad = sum(grade.decode_faults(out[0], item.in_span_partitions,
                                         item.out_span_partitions)
                     for item, out in zip(dep.items, outs))
    last = [out[0] for out in outs]
    del outs
    t_c0 = time.perf_counter()
    with checker.solver_hooks():
        check_outs, _ = solve_round(dep, plan_cache, dev, kw, {})
        _sync(dev)
    checker.compare_fits(dev)
    round_diff = sum(1 for a, b in zip(last, check_outs) if a != b[0])
    answers_diff, answers, unchecked = checker.decode.compare(
        [None if o is None else o[0] for o in check_outs])
    reading["check_s"] = time.perf_counter() - t_c0
    reading["checks"] = dict(
        block_gap=checker.block_gap, k1_rows_diff=checker.k1_rows_diff,
        decode_diff=answers_diff / max(1, answers),
        fit_gap=checker.fit_gap, decode_bad=float(decode_bad),
        round_diff=float(round_diff), accuracy_pct=reading["accuracy_pct"])
    reading["check_detail"] = dict(
        k1_gap=checker.k1_gap, rows=checker.rows, rows_diff=checker.rows_diff,
        answers=answers, answers_diff=answers_diff, services_unchecked=unchecked,
        launch_rows_unmatched=checker.decode.rows_unmatched,
        windows_sharing_a_key=checker.decode.keys_shared,
        fit_rows=checker.fit_rows,
        k1_launches=checker.k1_launches, assembly_launches=checker.assembly_launches)
    reading["counts"] = dict(k1=checker.k1_counts, assembly=checker.asm_counts)
    log(f"[twbench] check round {reading['check_s']:.1f} s: {reading['checks']}")
    gc.unfreeze()
    return reading


def _window(dep: Deployment, plan_cache, dev, kw: Dict, seconds: float):
    """Whole rounds back to back until ``seconds`` have passed; returns
    the rounds (wall, stage stats, services quarantined), the last round's
    answers and the window's length."""
    import torch

    rounds: List[Dict] = []
    t_w0 = time.perf_counter()
    while True:
        stats: Dict = {}
        t_r0 = time.perf_counter()
        with torch.profiler.record_function("tw:bench:round"):
            outs, quarantined = solve_round(dep, plan_cache, dev, kw, stats)
            _sync(dev)
        t_r1 = time.perf_counter()
        rounds.append(dict(wall=t_r1 - t_r0, stats=stats, quarantined=len(quarantined)))
        if t_r1 - t_w0 >= seconds:
            return rounds, outs, t_r1 - t_w0


def _read_trace(prof) -> Dict:
    """The traced window's device intervals and host ranges, cut to the
    first round's start and the last round's end."""
    kernels, ranges = timeline.trace_intervals(prof)
    rounds = [r for r in ranges if r[0] == "tw:bench:round"]
    t0 = min(r[1] for r in rounds)
    t1 = max(r[2] for r in rounds)
    tl = timeline.device_timeline(kernels, ranges, t0, t1)
    return dict(t0=t0, t1=t1, timeline=tl, by_name=timeline.by_name(kernels, t0, t1),
                rounds=len(rounds))


def kernel_share(reading: Dict, kind: str, marker: str) -> Optional[float]:
    """A kernel's share of its roofline in the traced window: the least
    time the checked round's launches need, times the window's rounds,
    over the device time of the kernels whose name holds ``marker``. None
    without a trace or a launch."""
    tr = reading.get("trace")
    counts = reading.get("counts", {}).get(kind) or []
    rate = reading.get("exp_rate")
    if tr is None or not counts or not rate:
        return None
    busy = sum(us for name, (us, _) in tr["by_name"].items() if marker in name)
    if busy <= 0:
        return None
    least = sum(roofline.bound_s(c["bytes"], c["ops"], c["exps"], rate)[0] for c in counts)
    return 100.0 * least * tr["rounds"] / (busy * 1e-6)

