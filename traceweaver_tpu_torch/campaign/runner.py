"""Campaign runner: sustained-throughput drive over the rung ladder
(mirrors ``traceweaver_tpu/campaign/runner.py``).

Per rung:

1. **materialize** the corpus (``campaign/corpus.py``: cached,
   deterministic, columnar at load) and build every solvable service's
   ``FleetItem`` once;
2. **warm up**: full-rung fleet solves repeat until a round builds no
   kernel (at most ``warmup_max``, ``TW_CAMPAIGN_WARMUP_MAX``). The
   port's counterpart of the JAX package's backend compiles is the
   kernel sources ``nvcc`` built at first use
   (``ops/cuda_build.BUILT``), counted under the artifact's
   ``backend_compiles``;
3. **measure**: ``rounds`` (``TW_CAMPAIGN_ROUNDS``) timed rounds through
   ``solve_fleet(mesh=)``: with ``devices >= 2`` every dispatch group's
   window axis is sharded over the mesh. Sustained spans/s, dispatch
   latency percentiles, the H2D/D2H byte split, kernel builds (which a
   steady round holds at zero; their sources are the artifact's
   ``aot_misses``) and the plan cache's counters are frozen;
4. **grade**: exact-match accuracy against the held-out ground truth,
   end to end per call graph and per regime bucket;
5. **allreduce** (``slices >= 2``): the rung's solved per-edge delay
   statistics shard across slices and merge through
   ``parallel/multislice.py``'s filesystem transport, checked identical
   on every slice.

The JAX runner sets its plan's knob profile as ``TW_*`` environment
variables; here the profile becomes arguments (``CampaignPlan.knob_args``)
and is recorded in the artifact under the same keys, ``TW_MESH_DEVICES``
pinned to the plan's device count, so either package's ``compare``
reads the other's artifact. On the card the artifact's ``backend`` is
``cuda`` and ``devices_visible`` the machine's CUDA devices; with
``device="cpu"`` they are ``cpu`` and the mesh's size, the counterpart
of the JAX package's CPU stand-in, which makes the plan's device count
of virtual devices.
"""

from __future__ import annotations

import tempfile
import time
from typing import Dict, List, Optional

from traceweaver_tpu_torch.campaign import corpus as _corpus
from traceweaver_tpu_torch.campaign import ledger as _ledger
from traceweaver_tpu_torch.campaign.plan import CampaignPlan

#: ``TW_CAMPAIGN_ROUNDS`` and ``TW_CAMPAIGN_WARMUP_MAX``'s defaults
ROUNDS = 3
WARMUP_MAX = 5


def knob_profile(plan: CampaignPlan) -> Dict[str, str]:
    """The knob profile the artifact records: the plan's own knobs, plus
    ``TW_MESH_DEVICES`` pinned to the plan's topology (unless the plan
    names it)."""
    profile = {k: str(v) for k, v in plan.knobs.items()}
    if plan.devices >= 2:
        profile = {"TW_MESH_DEVICES": str(plan.devices), **profile}
    return profile


def plan_mesh(plan: CampaignPlan, device):
    """The plan's mesh on ``device``'s kind, None below two devices
    (:func:`~traceweaver_tpu_torch.parallel.mesh.mesh_for`)."""
    from traceweaver_tpu_torch.parallel.mesh import mesh_for

    return mesh_for(plan.devices if plan.devices >= 2 else 0, device)


def _kernel_builds() -> int:
    from traceweaver_tpu_torch.ops import cuda_build

    return len(cuda_build.BUILT)


def _built_since(n: int) -> List[str]:
    from traceweaver_tpu_torch.ops import cuda_build

    return list(cuda_build.BUILT[n:])


def rung_items(corpus: _corpus.RungCorpus, idx: Optional[List[int]] = None) -> List:
    """The ``FleetItem`` of each of the rung's problems ``idx`` (all when
    None). ``plan_key`` tells apart services of one name in different
    call graphs, which share a plan cache."""
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem

    metas = corpus.problems if idx is None else [corpus.problems[i] for i in idx]
    return [FleetItem(m["svc"], m["prob"].in_span_partitions,
                      m["prob"].out_span_partitions, m["true"], m["dag"],
                      store=corpus.stores[m["store"]],
                      plan_key="%d:%s" % (m["store"], m["svc"]))
            for m in metas]


def _solve_round(items, mesh, stats: Dict, plan_cache, device, solve_kw):
    from traceweaver_tpu_torch.algorithms.fleet import solve_fleet

    quarantined: List[int] = []
    outs = solve_fleet(items, mesh=mesh, stats=stats, quarantined=quarantined,
                       plan_cache=plan_cache, device=device, **solve_kw)
    return outs, quarantined


def _grade(problems: List[Dict], outs) -> Dict:
    """Accuracy against the held-out ground truth: per-service exact
    match, span-weighted per regime, and end to end per call-graph store
    (trace counts weight the corpus-wide aggregate)."""
    from traceweaver_tpu_torch.metrics import accuracy_end_to_end, accuracy_for_service

    by_store: Dict[int, Dict[str, Dict]] = {}
    regime_n: Dict[str, float] = {}
    regime_hits: Dict[str, float] = {}
    svc_worst = (None, 1.0)
    for meta, out in zip(problems, outs):
        pred = out[0]
        acc = accuracy_for_service(pred, meta["true"], meta["prob"].in_span_partitions)
        n_in = len(next(iter(meta["prob"].in_span_partitions.values())))
        regime = meta["regime"]["regime"]
        regime_n[regime] = regime_n.get(regime, 0.0) + n_in
        regime_hits[regime] = regime_hits.get(regime, 0.0) + acc * n_in
        if svc_worst[0] is None or acc < svc_worst[1]:
            svc_worst = (meta["svc"], acc)
        slot = by_store.setdefault(meta["store"], dict(pred={}, true={}))
        slot["pred"][meta["svc"]] = pred
        slot["true"][meta["svc"]] = meta["true"]
    return dict(by_store=by_store, regime_n=regime_n, regime_hits=regime_hits,
                svc_worst=svc_worst, accuracy_end_to_end=accuracy_end_to_end)


def _accuracy_entry(corpus: _corpus.RungCorpus, outs) -> Dict:
    g = _grade(corpus.problems, outs)
    e2e_weighted = 0.0
    traces_total = 0
    for si, slot in sorted(g["by_store"].items()):
        store = corpus.stores[si]
        _, acc = g["accuracy_end_to_end"](slot["pred"], slot["true"],
                                          store.in_spans_by_process)
        n = len(store.all_processes)
        e2e_weighted += acc * 100.0 * n
        traces_total += n
    per_regime = {r: round(g["regime_hits"][r] / g["regime_n"][r], 4)
                  for r in sorted(g["regime_n"])}
    worst_svc, worst_acc = g["svc_worst"]
    return dict(
        e2e_pct=round(e2e_weighted / max(1, traces_total), 3),
        per_regime=per_regime,
        worst_service=worst_svc,
        worst_service_acc=round(worst_acc, 4),
    )


def slice_edge_stats(corpus: _corpus.RungCorpus, outs, n_slices: int, pid: int):
    """Slice ``pid``'s per-edge ``(n, Σd, Σd²)`` of the solved delays: the
    problems of its :func:`partition_problems` share, each edge's
    samples the start offsets of the assigned outgoing spans."""
    from traceweaver_tpu_torch.parallel.multislice import (
        edge_stats_from_samples,
        partition_problems,
    )

    samples: Dict = {}
    for i in partition_problems(len(corpus.problems), n_slices, pid):
        meta, out = corpus.problems[i], outs[i]
        prob = meta["prob"]
        in_spans = next(iter(prob.in_span_partitions.values()))
        by_id = {s.GetId(): s for spans in prob.out_span_partitions.values()
                 for s in spans}
        for ep, assign in out[0].items():
            vals = []
            for in_span in in_spans:
                s_out = by_id.get(assign.get(in_span.GetId()))
                if s_out is not None:
                    vals.append(float(s_out.start_mus) - float(in_span.start_mus))
            if vals:
                samples[(meta["svc"], ep)] = vals
    return edge_stats_from_samples(samples)


def _multislice_entry(corpus: _corpus.RungCorpus, outs, n_slices: int,
                      round_id: int) -> Dict:
    """The multi-process tier (``parallel/multislice.py``) on the rung:
    the solved per-edge delay statistics sharded across slices,
    allreduced through the filesystem transport, and every slice checked
    to end with the same corpus-wide statistics."""
    from concurrent.futures import ThreadPoolExecutor

    from traceweaver_tpu_torch.parallel.multislice import allreduce_stats_files

    locals_ = [slice_edge_stats(corpus, outs, n_slices, pid) for pid in range(n_slices)]
    with tempfile.TemporaryDirectory(prefix="tw-campaign-rdv-") as rdv:
        # the allreduce is a barrier (each call publishes its share, then
        # waits for every peer's), so the in-process slices run at once
        with ThreadPoolExecutor(max_workers=n_slices) as pool:
            merged = list(pool.map(
                lambda pid: allreduce_stats_files(locals_[pid], rdv, pid, n_slices,
                                                  round_id=round_id),
                range(n_slices)))
    agree = all(m == merged[0] for m in merged[1:])
    return dict(slices=n_slices, transport="files", edges=len(merged[0]),
                agree=bool(agree))


def run_campaign(plan: CampaignPlan, out_path: Optional[str] = None,
                 cache_root: Optional[str] = None, print_fn=None,
                 device=None) -> Dict:
    """Run the whole campaign; returns (and with ``out_path`` writes) the
    artifact dict. ``device`` is where the solves run: None means the
    card, and raises without one, before any corpus is built; tests pass
    ``"cpu"``. See the module docstring for the per-rung phases."""
    import torch

    from traceweaver_tpu_torch.algorithms.plancache import PlanCache
    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device

    plan.validate()
    device = resolve_device(device)
    t_run0 = time.perf_counter()
    cache_root = cache_root or _corpus.default_cache_root(out_path)
    profile = knob_profile(plan)
    solve_kw = plan.knob_args()
    rounds = solve_kw.pop("rounds", None)
    warmup_max = solve_kw.pop("warmup_max", None)
    solve_kw.pop("mesh_devices", None)
    rounds = plan.timed_rounds or rounds or ROUNDS
    warmup_max = plan.warmup_max or warmup_max or WARMUP_MAX
    mesh = plan_mesh(plan, device)
    _ledger.record_start(plan.name, plan.to_dict())
    if print_fn:
        print_fn("[campaign] %s: %d rung(s), devices=%d (mesh %s), slices=%d, "
                 "%d timed round(s) on %s"
                 % (plan.name, len(plan.rungs), plan.devices,
                    "on" if mesh is not None else "off", plan.slices, rounds,
                    device))

    rung_entries: List[Dict] = []
    scrape = None
    scrape_after = (len(plan.rungs) - 1) // 2
    registry = _ledger._get_registry()
    for ri, spec in enumerate(plan.rungs):
        t0 = time.perf_counter()
        corpus = _corpus.build_rung(spec, cache_root, print_fn=print_fn)
        items = rung_items(corpus)
        build_s = time.perf_counter() - t0

        # per-rung plan cache: the warm-up rounds fill it, and the timed
        # rounds measure the amortized steady state (single-pass, no host
        # fit)
        plan_cache = PlanCache()

        # --- warm-up: rounds until one builds no kernel ---------------------
        warmup_builds: List[int] = []
        for _ in range(warmup_max):
            before = _kernel_builds()
            _solve_round(items, mesh, {}, plan_cache, device, solve_kw)
            warmup_builds.append(_kernel_builds() - before)
            if warmup_builds[-1] == 0:
                break
        warmup_incomplete = warmup_builds[-1] != 0
        if print_fn:
            print_fn("[campaign] rung %s: warmup %s%s"
                     % (spec.name, warmup_builds,
                        " INCOMPLETE" if warmup_incomplete else ""))

        # --- timed steady state ----------------------------------------------
        snap_before = registry.snapshot()
        builds_before = _kernel_builds()
        acc_stats: Dict[str, float] = {}
        walls: List[float] = []
        quarantined_total = 0
        outs = None
        for _ in range(rounds):
            stats: Dict = {}
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t1 = time.perf_counter()
            outs, quarantined = _solve_round(items, mesh, stats, plan_cache, device,
                                             solve_kw)
            walls.append(time.perf_counter() - t1)
            _ledger.merge_stats(acc_stats, stats)
            quarantined_total += len(quarantined)
        steady_builds = _built_since(builds_before)
        snap_after = registry.snapshot()
        spans_per_s = round(corpus.spans / (sum(walls) / len(walls)), 1)

        accuracy = _accuracy_entry(corpus, outs)
        multislice = (_multislice_entry(corpus, outs, plan.slices, round_id=ri)
                      if plan.slices > 1 else None)
        dispatch_pct = _ledger.histogram_percentiles(snap_before, snap_after,
                                                     "tw_dispatch_seconds")
        entry = dict(
            rung=spec.name,
            manifest={k: v for k, v in corpus.manifest.items() if k != "per_service"},
            corpus_cached=corpus.cached,
            build_s=round(build_s, 3),
            warmup=dict(rounds=len(warmup_builds), backend_compiles=warmup_builds,
                        incomplete=warmup_incomplete),
            steady=dict(
                rounds=rounds,
                round_wall_s=[round(w, 4) for w in walls],
                spans_per_s=spans_per_s,
                solved_services=len(items),
                quarantined=quarantined_total,
                backend_compiles=len(steady_builds),
                # the port keeps no persistent compile cache
                persistent_cache_hits=0,
                aot_misses=sorted(set(steady_builds)),
                dispatch_seconds=dispatch_pct,
                bytes=_ledger.byte_ledger(acc_stats),
                fleet=dict(
                    dispatches=acc_stats.get("fleet_dispatches", 0.0),
                    compact_windows_total=acc_stats.get("compact_windows_total", 0.0),
                    compact_windows_redispatched=acc_stats.get(
                        "compact_windows_redispatched", 0.0),
                    pipeline_groups=acc_stats.get("pipeline_groups", 0.0),
                    plan_fit_s=round(acc_stats.get("plan_fit_s", 0.0), 4),
                ),
                plan_cache=plan_cache.counters(),
            ),
            accuracy=accuracy,
            multislice=multislice,
        )
        rung_entries.append(entry)
        _ledger.record_rung(plan.name, spec.name, spans_per_s, accuracy["e2e_pct"],
                            entry["steady"]["backend_compiles"],
                            len(entry["steady"]["aot_misses"]))
        if print_fn:
            print_fn("[campaign] rung %s: %.0f spans/s sustained (%d rounds), "
                     "e2e %.2f%%, steady compiles %d, aot misses %d"
                     % (spec.name, spans_per_s, rounds, accuracy["e2e_pct"],
                        entry["steady"]["backend_compiles"],
                        len(entry["steady"]["aot_misses"])))
        if ri == scrape_after:
            # the mid-run /metrics scrape, taken between rungs so it holds
            # live counters, not a drained end state
            scrape = _ledger.scrape_snapshot()

    if device.type == "cuda":
        backend, visible = "cuda", torch.cuda.device_count()
    else:
        backend, visible = "cpu", mesh.size if mesh is not None else 1
    artifact = _ledger.make_artifact(
        plan.name, dict(plan.to_dict(), applied_knobs=profile), backend, visible,
        rung_entries, scrape, time.perf_counter() - t_run0)
    if out_path:
        _ledger.write_artifact(out_path, artifact)
    _ledger.record_finish(plan.name, artifact["wall_s"], out_path)
    if print_fn and out_path:
        print_fn(f"[campaign] artifact -> {out_path}")
    return artifact
