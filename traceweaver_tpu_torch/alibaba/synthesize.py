"""Synthetic MSCallGraph generator — regenerates the exp5 input artifact (mirrors
``traceweaver_tpu/alibaba/synthesize.py``).

The reference release ships ``data/alibaba_microservices/call_graph_data``
only as a 134-byte git-LFS pointer and the upstream clusterdata CSVs are
external downloads (BASELINE.md artifact gaps), so exp5 cannot run from the
repo alone. This generator produces MSCallGraph-format call records for a
configurable number of service topologies — trees with Alibaba-like shape
(fan-out 1-3, depth 2-4, occasional self-calls that exercise the ``-loop``
remapping, executor.py:386-399) — and pushes them through the *real*
repair → convert → group pipeline so the output exercises the same code
paths real clusterdata would.

Usage::

    python -m traceweaver_tpu_torch.alibaba.synthesize --out DIR \
        [--n-graphs 15] [--traces-per-graph 1000] [--seed 10]
"""

from __future__ import annotations

import argparse
import random
from typing import Dict, List

from traceweaver_tpu_torch.alibaba.convert import repair_trace
from traceweaver_tpu_torch.alibaba.grouping import group_traces
from traceweaver_tpu_torch.alibaba.schema import CallRecord


def _random_topology(rng: random.Random, n_services: int,
                     multi_invoke_rate: float = 0.0):
    """A call tree as a list of (rpc_id, caller_idx, callee_idx).

    By default upholds the invariant the reference's signature-grouped
    Alibaba data holds (and its transforms/plugin contract assume,
    reference transforms.py:26-29): every service is the callee of AT
    MOST ONE call per trace, so each per-service partition carries
    exactly one span per trace. Self-calls (exercising the ``-loop``
    remap of the ingester, reference executor.py:386-399) are emitted
    only as childless leaves — the remapped ``svc-loop`` callee then has
    no outgoing spans and is skipped by the per-service partitioner
    rather than creating a multi-incoming grading ambiguity.

    ``multi_invoke_rate`` > 0 VIOLATES that invariant the way real
    MSCallGraph data does: with that probability an expansion step
    re-invokes an already-used service (as a leaf) instead of a fresh
    one. Such services carry several server spans per trace; the
    pipeline must respond exactly as the reference does on real data —
    services called from multiple distinct upstreams are skipped by the
    partitioner (reference executor.py:949-950), same-upstream repeats
    stay and are graded under the first-match ground-truth join
    (helpers/utils.py:22-32).
    """
    depth = rng.randint(2, 4)
    calls = []
    root_svc = 0
    available = [s for s in range(n_services) if s != root_svc]
    rng.shuffle(available)
    used = [root_svc]

    def expand(rpc_id: str, svc: int, level: int) -> None:
        if level >= depth:
            return
        fanout = rng.randint(1, 3) if level < depth - 1 else rng.randint(0, 2)
        self_called = False
        for i in range(fanout):
            child_id = f"{rpc_id}.{i + 1}"
            # occasional self-call (caller == callee) to exercise -loop
            # logic; always a leaf, at most one per service (see docstring)
            if rng.random() < 0.08 and not self_called:
                calls.append((child_id, svc, svc))
                self_called = True
                continue
            if (multi_invoke_rate > 0 and len(used) > 1
                    and rng.random() < multi_invoke_rate):
                # re-invoke an existing service (leaf, not this caller):
                # a multi-invocation callee
                again = rng.choice([u for u in used if u != svc] or [svc])
                if again != svc:
                    calls.append((child_id, svc, again))
                    continue
            if not available:
                return
            child_svc = available.pop()
            used.append(child_svc)
            calls.append((child_id, svc, child_svc))
            expand(child_id, child_svc, level + 1)

    calls.append(("0", -1, root_svc))
    expand("0", root_svc, 0)
    return calls


#: defect-injection profile for the "hard" corpus (VERDICT r4 #5): rates
#: are per-trace probabilities of each defect class real MSCallGraph data
#: exhibits (reference real-parser.py:134-187 missing-field fill,
#: :35-61 mirrored duplicates, :254-281 orphan/multi-root rejection).
MESSY_DEFAULT = {
    "multi_invoke": 0.15,  # service re-invoked within a trace (topology)
    "missing": 0.20,       # '(?)' caller/callee, neighbour-repairable
    "missing_hard": 0.03,  # '(?)' callee on a leaf — unrepairable, dropped
    "dup": 0.15,           # mirrored duplicate row with negative rt
    "orphan": 0.04,        # row under a nonexistent parent — dropped
    "multiroot": 0.03,     # second depth-0 row — dropped
}


def synthesize_corpus(
    out_root: str,
    n_graphs: int = 15,
    traces_per_graph: int = 1000,
    seed: int = 10,
    base_gap_ms: int = 2000,
    messy: Dict[str, float] = None,
    replica_dist: str = "loguniform-16-128",
    stats: Dict[str, int] = None,
    n_services: int = 60,
) -> List[str]:
    # base_gap_ms defaults to ~2s between trace arrivals: clusterdata traces
    # spread over hours, and exp5's compress_factor=15000 sweep only makes
    # sense if the compressed inter-arrival (gap/15000 ~ 130-260us) stays
    # above timestamp resolution while sitting far below the ms-scale edge
    # delays — the "hundreds of interleaved requests" regime the reference
    # stresses (exp5/run_experiment.sh:270-284). A 40ms gap would compress
    # to ~3us, under the per-edge jitter, making every method (including
    # the reference's V3) statistically unable to distinguish candidates.
    #
    # That floor is exactly why the reference's own executor divides the
    # compress factor by the service's REPLICA COUNT
    # (executor.py:922-929, loading data/misc/service_to_replica_new.pickle
    # — absent from the release, SURVEY §6 artifact gap): a 15000x corpus
    # load spread over ~a hundred replicas stresses each replica at
    # ~100-1000x, the "hard but physically identifiable" regime of fig6a.
    # This generator therefore also regenerates the replica-table artifact
    # (Alibaba-like log-uniform 16..128 replicas per microservice) next to
    # the corpus; without it every service defaults to 1 replica and the
    # top rungs measure an unidentifiability floor, not solver quality.
    """Generate, repair, convert, and group; returns the call_graph dirs.

    ``messy`` (a rate dict, see :data:`MESSY_DEFAULT`) injects the defect
    classes real clusterdata carries BEFORE the repair pipeline runs, so
    the corpus exercises ``convert.repair_trace`` the way real-parser.py
    faces real shards: repairable defects (fillable '(?)' fields,
    mirrored duplicates) must survive repair; structural corruption
    (orphans, multi-roots, unrepairable '(?)') must be rejected.
    ``stats`` (optional dict) receives emitted/repaired/dropped counters.
    ``replica_dist`` parameterizes the regenerated replica table
    (``loguniform-A-B`` or ``fixed-N``) — the exp5 top-rung absolute
    accuracies scale with this assumption (see BASELINE.md), so the knob
    exists to measure sensitivity.

    ``n_services`` sizes the cluster-wide microservice pool the call
    graphs sample from (default 60, the historical corpus). The campaign
    corpus ladder (``traceweaver_tpu/campaign/corpus.py``) widens it on
    the top rungs so service-count scaling is measured, not held fixed.
    """
    rng = random.Random(seed)
    messy = messy or {}
    services = [f"MS_{i:05d}" for i in range(n_services)]
    traces: Dict[str, List[CallRecord]] = {}
    counters = stats if stats is not None else {}
    counters.update(emitted=0, kept=0, dropped=0, defect_injected=0)

    t_now = 1_600_000_000_000  # epoch ms
    for g in range(n_graphs):
        # clamp to the pool: a narrow campaign rung (n_services < 12)
        # must not over-sample; the default 60-service pool draws the
        # historical randint(3, 12) sequence unchanged
        n_services = rng.randint(3, min(12, len(services)))
        svc_ids = rng.sample(range(len(services)), n_services)
        topology = _random_topology(
            rng, n_services,
            multi_invoke_rate=messy.get("multi_invoke", 0.0))
        # per-edge base latency in ms (int; the dataset is ms-resolution)
        edge_delay = {
            rpc_id: rng.randint(2, 25) for rpc_id, _, _ in topology
        }
        for t in range(traces_per_graph):
            tid = f"cg{g}_{t:06d}_{rng.randrange(1 << 32):08x}"
            t_now += rng.randint(base_gap_ms // 2, base_gap_ms * 2)
            records: List[CallRecord] = []

            def emit(rpc_id: str, caller: int, callee: int,
                     start_ms: int) -> int:
                """Returns the call's duration (ms)."""
                kids = [c for c in topology if
                        ".".join(c[0].split(".")[:-1]) == rpc_id]
                cursor = start_ms + edge_delay[rpc_id] + rng.randint(0, 4)
                child_total = 0
                for (kid_id, kc, kd) in kids:
                    dur = emit(kid_id, kc, kd, cursor)
                    cursor += dur + rng.randint(1, 6)
                    child_total = cursor - start_ms
                own = rng.randint(2, 12)
                total = max(edge_delay[rpc_id] + child_total + own, 1)
                records.append(CallRecord(
                    trace_id=tid,
                    timestamp_ms=start_ms,
                    rpc_id=rpc_id,
                    caller=services[svc_ids[caller]] if caller >= 0 else "USER",
                    rpc_type="rpc",
                    callee=services[svc_ids[callee]],
                    interface=f"if_{rpc_id}",
                    rt_ms=total,
                ))
                return total

            _, root_caller, root_callee = topology[0]
            emit("0", root_caller, root_callee, t_now)
            counters["emitted"] += 1
            counters["defect_injected"] += _inject_defects(
                rng, records, messy)
            repaired = repair_trace(records)
            if repaired is not None:
                traces[tid] = repaired
                counters["kept"] += 1
            else:
                counters["dropped"] += 1

    write_replica_table(out_root, services, seed, dist=replica_dist)
    return group_traces(traces, out_root, top_n=n_graphs, min_traces=2)


def _inject_defects(rng: random.Random, records, messy: Dict[str, float]) -> int:
    """Corrupt one emitted trace in place per the ``messy`` rate dict.

    Repairable classes (``missing``, ``dup``) must survive
    ``convert.repair_trace``; structural classes (``missing_hard``,
    ``orphan``, ``multiroot``) must be rejected by it — both asserted by
    tests/test_alibaba.py. Returns the number of defects injected.
    """
    from dataclasses import replace

    if not messy or len(records) < 2:
        return 0
    n = 0
    non_root = [r for r in records if r.rpc_id != "0"]
    with_children = [
        r for r in records
        if any(o.rpc_id.startswith(r.rpc_id + ".") for o in records)
    ]
    leaves = [r for r in non_root if r not in with_children]

    if non_root and rng.random() < messy.get("missing", 0.0):
        # repairable: caller fillable from the parent row's callee
        # (real-parser.py:134-177 checkNeighbours)
        replace_in = rng.choice(non_root)
        replace_in.caller = "(?)"
        n += 1
    if with_children and rng.random() < messy.get("missing", 0.0):
        # repairable: callee fillable from a child row's caller
        rec = rng.choice(with_children)
        if rec.rpc_id != "0":
            rec.callee = "(?)"
            n += 1
    if leaves and rng.random() < messy.get("missing_hard", 0.0):
        # unrepairable: a leaf's callee has no child to fill from —
        # the repairer must reject the whole trace
        rng.choice(leaves).callee = "(?)"
        n += 1
    if non_root and rng.random() < messy.get("dup", 0.0):
        # mirrored duplicate row with negative rt (fixDuplicates :35-61)
        rec = rng.choice(non_root)
        records.append(replace(rec, rt_ms=-abs(rec.rt_ms)))
        n += 1
    if leaves and rng.random() < messy.get("orphan", 0.0):
        # row under a nonexistent parent (orphan detection :254-281)
        rec = rng.choice(leaves)
        records.append(replace(rec, rpc_id=rec.rpc_id + ".7.7"))
        n += 1
    if rng.random() < messy.get("multiroot", 0.0):
        # a second depth-0 row — multi-rooted trace, rejected
        rec = records[-1]
        records.append(replace(rec, rpc_id="1"))
        n += 1
    return n


def replica_counts(services: List[str], seed: int = 10,
                   dist: str = "loguniform-16-128") -> Dict[str, int]:
    """Per-service replica counts under a named distribution.

    ``loguniform-A-B`` draws log-uniform in [A, B] (default 16..128 —
    Alibaba microservices run tens to hundreds of replicas); ``fixed-N``
    gives every service N replicas. The real artifact's contents are
    unknown (the release ships no ``data/misc/``), so the distribution
    is an ASSUMPTION the exp5 top-rung accuracies inherit — the knob
    exists so the sensitivity can be measured (see BASELINE.md).
    """
    import math

    rng = random.Random(seed + 1)
    kind, _, rest = dist.partition("-")
    if kind == "fixed":
        n = int(rest)
        return {svc: n for svc in services}
    if kind == "loguniform":
        lo, hi = (int(x) for x in rest.split("-"))
        return {
            svc: int(round(2 ** rng.uniform(math.log2(lo), math.log2(hi))))
            for svc in services
        }
    raise ValueError(f"unknown replica distribution {dist!r}")


def write_replica_table(out_root: str, services: List[str],
                        seed: int = 10,
                        dist: str = "loguniform-16-128") -> str:
    """Regenerate the ``service_to_replica_new.pickle`` artifact.

    The reference loads it unconditionally (executor.py:912) and scales
    each service's compress factor by its replica count (:922-929), but
    the release ships no ``data/misc/`` at all. Counts come from
    :func:`replica_counts`, deterministically from ``seed`` so the
    corpus and table regenerate together.

    Location: when ``out_root`` sits in the reference layout
    (``<data_root>/alibaba_microservices/call_graph_data``) the table
    goes to ``<data_root>/misc`` (the reference's path anchor,
    executor.py:912); for any other ``--out`` it stays INSIDE the output
    tree at ``<out_root>/misc`` — never above it. The CLI checks
    repo-root ``data/misc``, then ``<dataset>/../misc``, then
    ``<dataset>/../../../misc`` (runtime/cli.py).
    """
    import os
    import pickle

    counts = replica_counts(services, seed, dist)
    table = {
        svc: [f"{svc}.r{i}" for i in range(n)] for svc, n in counts.items()
    }
    root = os.path.abspath(out_root)
    parent = os.path.dirname(root)
    if (os.path.basename(root) == "call_graph_data"
            and os.path.basename(parent) == "alibaba_microservices"):
        misc = os.path.join(os.path.dirname(parent), "misc")
    else:
        misc = os.path.join(root, "misc")
    os.makedirs(misc, exist_ok=True)
    path = os.path.join(misc, "service_to_replica_new.pickle")
    with open(path, "wb") as f:
        pickle.dump(table, f, protocol=pickle.HIGHEST_PROTOCOL)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", required=True)
    p.add_argument("--n-graphs", type=int, default=15)
    p.add_argument("--traces-per-graph", type=int, default=1000)
    p.add_argument("--seed", type=int, default=10)
    p.add_argument("--messy", action="store_true",
                   help="inject the MESSY_DEFAULT defect profile (real-"
                        "clusterdata realism: multi-invocation callees, "
                        "'(?)' fields, mirrored dups, orphans, multi-roots)")
    p.add_argument("--replica-dist", default="loguniform-16-128",
                   help="replica-table distribution: loguniform-A-B or "
                        "fixed-N (sensitivity knob for the exp5 ladder)")
    args = p.parse_args(argv)
    stats: Dict[str, int] = {}
    dirs = synthesize_corpus(args.out, args.n_graphs, args.traces_per_graph,
                             args.seed,
                             messy=MESSY_DEFAULT if args.messy else None,
                             replica_dist=args.replica_dist, stats=stats)
    print(f"wrote {len(dirs)} call-graph datasets under {args.out} "
          f"({stats})")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
