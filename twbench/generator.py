"""The benchmark's traffic: Alibaba MSCallGraph-shaped call graphs written
as Jaeger JSON, and exp5's load transform.

Frozen copies, so that a change to the program cannot move the yardstick:

- :func:`synthesize` is ``traceweaver_tpu_torch/alibaba/synthesize.py``
  ``synthesize_corpus`` (lines 124-231, the clean corpus: no defect
  injection), with ``_random_topology`` (lines 28-95), the replica table of
  ``replica_counts`` (lines 301-325), ``alibaba/convert.py`` (``repair_trace``
  and the Jaeger writer, lines 36-168), ``alibaba/grouping.py``
  ``group_traces`` (lines 21-77) and ``alibaba/schema.py`` ``CallRecord``.
  Two changes: each call graph takes its own trace count (``counts``), and
  with ``corpus_seed`` the corpus (topologies, edge delays, arrivals,
  durations and the replica table) is the one that seed draws, while
  ``seed`` only relabels it: each graph's traces take trace ids in an order
  and with suffixes drawn from ``seed``. Every seed then gives the same
  work, in another order (the loader sorts by time, the solver breaks ties
  between equal times by trace id). With ``corpus_seed=None`` ``seed``
  draws the corpus and keeps its ids, so equal counts give the program's
  synthesizer's corpus byte for byte.
- :func:`compress_problem` is exp5's per-service load transform
  (``traceweaver_tpu_torch/runtime/executor.py`` lines 161-168 and
  ``synth/transforms.py compress_spans`` lines 44-95): each trace's arrival
  divided by ``ceil(compress / replicas)``, the trace shifted rigidly. It
  returns shifted copies of the spans and leaves the store's spans as they
  are.
"""

from __future__ import annotations

import copy
import hashlib
import json
import math
import os
import random
from collections import defaultdict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

MAX_TRACE_SPANS = 200


# ---------------------------------------------------------------------------
# counts a call graph from a traffic file
# ---------------------------------------------------------------------------

def graph_counts(traffic: Dict, n_graphs: int) -> List[int]:
    """Traces per call graph. ``uniform``: ``total // n_graphs`` each, the
    remainder to the first graphs."""
    kind = traffic["distribution"]
    total = int(traffic["total_traces"])
    if int(traffic["graphs"]) != n_graphs:
        raise ValueError(f"traffic is for {traffic['graphs']} call graphs, the "
                         f"configuration has {n_graphs}")
    if kind == "uniform":
        base, extra = divmod(total, n_graphs)
        return [base + (g < extra) for g in range(n_graphs)]
    raise ValueError(f"unknown trace distribution {kind!r}")


# ---------------------------------------------------------------------------
# MSCallGraph rows, repair, grouping and the Jaeger writer
# ---------------------------------------------------------------------------

@dataclass
class CallRecord:
    trace_id: str
    timestamp_ms: int
    rpc_id: str
    caller: str
    rpc_type: str
    callee: str
    interface: str
    rt_ms: int


MISSING_VALUES = ("(?)", "", "None", "nan")


def _is_missing(value: str) -> bool:
    return value in MISSING_VALUES


def _parent_rpc_id(rpc_id: str) -> str:
    return ".".join(rpc_id.split(".")[:-1])


def _rpc_depth(rpc_id: str) -> int:
    return len(rpc_id.split("."))


def _rpc_sort_key(rpc_id: str) -> Tuple:
    parts = []
    for p in rpc_id.split("."):
        try:
            parts.append(int(p))
        except ValueError:
            parts.append(0)
    return tuple(parts)


def _dedupe_mirrored(records: List[CallRecord]) -> List[CallRecord]:
    seen: Dict[Tuple, CallRecord] = {}
    out: List[CallRecord] = []
    for rec in records:
        key = (rec.trace_id, rec.rpc_id, rec.caller, rec.rpc_type, rec.callee)
        prev = seen.get(key)
        if prev is not None and (prev.rt_ms >= 0) != (rec.rt_ms >= 0):
            if prev.rt_ms < 0 <= rec.rt_ms:
                out[out.index(prev)] = rec
                seen[key] = rec
            continue
        seen[key] = rec
        out.append(rec)
    return out


def _fill_missing(records: List[CallRecord]) -> bool:
    by_rpc: Dict[str, List[CallRecord]] = {}
    for rec in records:
        by_rpc.setdefault(rec.rpc_id, []).append(rec)
    for rec in records:
        if _is_missing(rec.caller):
            parent = by_rpc.get(_parent_rpc_id(rec.rpc_id), [])
            siblings = [r for r in records
                        if _parent_rpc_id(r.rpc_id) == _parent_rpc_id(rec.rpc_id)
                        and r.rpc_id != rec.rpc_id]
            if parent and not _is_missing(parent[0].callee):
                rec.caller = parent[0].callee
            elif siblings and not _is_missing(siblings[0].caller):
                rec.caller = siblings[0].caller
            else:
                return False
        if _is_missing(rec.callee):
            children = [r for r in records if _parent_rpc_id(r.rpc_id) == rec.rpc_id]
            if children and not _is_missing(children[0].caller):
                rec.callee = children[0].caller
            else:
                return False
    return True


def _validate_tree(records: List[CallRecord]) -> bool:
    if not records:
        return False
    seen = set()
    root_depth = _rpc_depth(records[0].rpc_id)
    for i, rec in enumerate(records):
        if rec.rpc_id in seen:
            return False
        seen.add(rec.rpc_id)
        if i != 0:
            if _rpc_depth(rec.rpc_id) == root_depth:
                return False
            if _parent_rpc_id(rec.rpc_id) not in seen:
                return False
    return True


def repair_trace(records: List[CallRecord]) -> Optional[List[CallRecord]]:
    """Sort, dedupe, fill, validate. None when the trace is unusable."""
    records = sorted(records, key=lambda r: _rpc_sort_key(r.rpc_id))
    if len(records) > MAX_TRACE_SPANS:
        return None
    records = _dedupe_mirrored(records)
    if not _fill_missing(records):
        return None
    if not _validate_tree(records):
        return None
    return records


def _to_jaeger(records: List[CallRecord]) -> dict:
    """Jaeger JSON with a server and a client record a call."""
    root_rpc = records[0].rpc_id
    spans = []
    for rec in records:
        server = {
            "traceID": rec.trace_id,
            "startTime": rec.timestamp_ms * 1000,
            "spanID": rec.rpc_id,
            "caller": rec.caller,
            "requestType": rec.rpc_type,
            "callee": rec.callee,
            "interface": rec.interface,
            "duration": abs(rec.rt_ms) * 1000,
            "tags": [{"key": "span.kind", "value": "server"}],
            "references": [],
            "processID": rec.callee,
        }
        if rec.rpc_id != root_rpc:
            server["references"].append({
                "refType": "CHILD_OF",
                "traceID": rec.trace_id,
                "spanID": _parent_rpc_id(rec.rpc_id),
            })
        spans.append(server)
        if rec.rpc_id != root_rpc:
            client = dict(server)
            client["tags"] = [{"key": "span.kind", "value": "client"}]
            client["processID"] = rec.caller
            client["references"] = [dict(r) for r in server["references"]]
            spans.append(client)
    return {"data": [{"traceID": records[0].trace_id, "spans": spans}]}


def _write_jaeger(trace: dict, out_dir: str) -> None:
    path = os.path.join(out_dir, f"{trace['data'][0]['traceID']}.json")
    with open(path, "w", encoding="utf-8") as f:
        # json.dumps takes the C encoder (json.dump the Python one): the same bytes
        f.write(json.dumps(trace, ensure_ascii=False))


def _signature(records: List[CallRecord]) -> str:
    by_depth: Dict[int, List[str]] = defaultdict(list)
    for rec in records:
        by_depth[_rpc_depth(rec.rpc_id)].append(
            f"{rec.caller}->{rec.callee}:{rec.rpc_type}")
    parts = [f"{d}|" + ",".join(sorted(by_depth[d])) for d in sorted(by_depth)]
    return hashlib.md5(";".join(parts).encode()).hexdigest()


def group_traces(traces: Dict[str, List[CallRecord]], out_root: str,
                 top_n: int, min_traces: int = 2) -> List[str]:
    """Group traces by call-graph signature and write the ``top_n`` most
    common graphs as ``call_graph_<i>/`` Jaeger directories."""
    by_sig: Dict[str, List[str]] = defaultdict(list)
    for trace_id, records in traces.items():
        by_sig[_signature(records)].append(trace_id)
    ranked = [(sig, tids) for sig, tids in
              sorted(by_sig.items(), key=lambda kv: -len(kv[1]))
              if len(tids) >= min_traces][:top_n]
    out_dirs = []
    for i, (_sig, trace_ids) in enumerate(ranked):
        out_dir = os.path.join(out_root, f"call_graph_{i}")
        os.makedirs(out_dir, exist_ok=True)
        for tid in trace_ids:
            _write_jaeger(_to_jaeger(traces[tid]), out_dir)
        out_dirs.append(out_dir)
    return out_dirs


# ---------------------------------------------------------------------------
# the synthesizer
# ---------------------------------------------------------------------------

def _random_topology(rng: random.Random, n_services: int):
    """A call tree as ``(rpc_id, caller_idx, callee_idx)`` rows: every
    service the callee of at most one call a trace; self-calls only as
    leaves."""
    depth = rng.randint(2, 4)
    calls = []
    root_svc = 0
    available = [s for s in range(n_services) if s != root_svc]
    rng.shuffle(available)

    def expand(rpc_id: str, svc: int, level: int) -> None:
        if level >= depth:
            return
        fanout = rng.randint(1, 3) if level < depth - 1 else rng.randint(0, 2)
        self_called = False
        for i in range(fanout):
            child_id = f"{rpc_id}.{i + 1}"
            if rng.random() < 0.08 and not self_called:
                calls.append((child_id, svc, svc))
                self_called = True
                continue
            if not available:
                return
            child_svc = available.pop()
            calls.append((child_id, svc, child_svc))
            expand(child_id, child_svc, level + 1)

    calls.append(("0", -1, root_svc))
    expand("0", root_svc, 0)
    return calls


def replica_counts(services: Sequence[str], seed: int,
                   dist: str = "loguniform-16-128") -> Dict[str, int]:
    """Replicas a microservice: log-uniform in [A, B] (``loguniform-A-B``)
    or ``fixed-N``, drawn from ``seed + 1``."""
    rng = random.Random(seed + 1)
    kind, _, rest = dist.partition("-")
    if kind == "fixed":
        return {svc: int(rest) for svc in services}
    if kind == "loguniform":
        lo, hi = (int(x) for x in rest.split("-"))
        return {svc: int(round(2 ** rng.uniform(math.log2(lo), math.log2(hi))))
                for svc in services}
    raise ValueError(f"unknown replica distribution {dist!r}")


def synthesize(out_root: str, counts: Sequence[int], seed: int,
               corpus_seed: Optional[int] = None, base_gap_ms: int = 2000,
               n_services: int = 60) -> List[str]:
    """Write one ``call_graph_<i>/`` Jaeger directory a call graph under
    ``out_root``, ``counts[g]`` traces for graph ``g``; returns the
    directories. See the module docstring for the two seeds."""
    rng = random.Random(seed if corpus_seed is None else corpus_seed)
    relabel = None if corpus_seed is None else random.Random(seed)
    services = [f"MS_{i:05d}" for i in range(n_services)]
    traces: Dict[str, List[CallRecord]] = {}
    t_now = 1_600_000_000_000  # epoch ms
    for g, n_traces in enumerate(counts):
        n_svc = rng.randint(3, min(12, len(services)))
        svc_ids = rng.sample(range(len(services)), n_svc)
        topology = _random_topology(rng, n_svc)
        edge_delay = {rpc_id: rng.randint(2, 25) for rpc_id, _, _ in topology}
        children = defaultdict(list)
        for c in topology:
            children[_parent_rpc_id(c[0])].append(c)
        if relabel is not None:
            order = list(range(n_traces))
            relabel.shuffle(order)
            suffix = [relabel.randrange(1 << 32) for _ in range(n_traces)]
        for t in range(n_traces):
            tid = f"cg{g}_{t:06d}_{rng.randrange(1 << 32):08x}"
            if relabel is not None:
                tid = f"cg{g}_{order[t]:06d}_{suffix[t]:08x}"
            t_now += rng.randint(base_gap_ms // 2, base_gap_ms * 2)
            records: List[CallRecord] = []

            def emit(rpc_id: str, caller: int, callee: int, start_ms: int) -> int:
                cursor = start_ms + edge_delay[rpc_id] + rng.randint(0, 4)
                child_total = 0
                for (kid_id, kc, kd) in children[rpc_id]:
                    dur = emit(kid_id, kc, kd, cursor)
                    cursor += dur + rng.randint(1, 6)
                    child_total = cursor - start_ms
                own = rng.randint(2, 12)
                total = max(edge_delay[rpc_id] + child_total + own, 1)
                records.append(CallRecord(
                    trace_id=tid, timestamp_ms=start_ms, rpc_id=rpc_id,
                    caller=services[svc_ids[caller]] if caller >= 0 else "USER",
                    rpc_type="rpc", callee=services[svc_ids[callee]],
                    interface=f"if_{rpc_id}", rt_ms=total))
                return total

            _, root_caller, root_callee = topology[0]
            emit("0", root_caller, root_callee, t_now)
            repaired = repair_trace(records)
            if repaired is not None:
                traces[tid] = repaired
    return group_traces(traces, out_root, top_n=len(counts), min_traces=2)


# ---------------------------------------------------------------------------
# exp5's load transform
# ---------------------------------------------------------------------------

def load_factor(process: str, compress: float, replicas: Dict[str, int],
                loop_map: Dict[str, str]) -> int:
    """``max(1, ceil(compress / replicas))`` of one service; a ``-loop``
    service takes its origin's replicas, an unknown one 1."""
    n = replicas.get(process)
    if n is None and process.endswith("-loop"):
        n = replicas.get(loop_map.get(process, ""))
    return max(1, math.ceil(compress / (n or 1)))


def compress_problem(in_parts: Dict[str, list], out_parts: Dict[str, list],
                     factor: float) -> Tuple[Dict[str, list], Dict[str, list]]:
    """Shifted copies of a service's partitions: each trace's earliest
    incoming start divided by ``factor``, every span of the trace moved by
    the same amount; partitions sorted by trace id, then stably by
    ``(start, end)``."""
    if len(in_parts) != 1:
        raise ValueError("a service problem has one incoming partition")
    if factor == 1:
        return in_parts, out_parts

    def by_tid(parts):
        return {ep: sorted(spans, key=lambda s: s.trace_id) for ep, spans in parts.items()}

    in_parts, out_parts = by_tid(in_parts), by_tid(out_parts)
    anchor: Dict[str, float] = {}
    for s in next(iter(in_parts.values())):
        t = float(s.start_mus)
        if s.trace_id not in anchor or t < anchor[s.trace_id]:
            anchor[s.trace_id] = t
    delta = {tid: t0 / factor - t0 for tid, t0 in anchor.items()}

    def shifted(parts):
        out = {}
        for ep, spans in parts.items():
            moved = []
            for s in spans:
                if s.trace_id not in delta:
                    raise ValueError(f"span {s.trace_id}/{s.sid} has no incoming span "
                                     "in its trace")
                c = copy.copy(s)
                c.start_mus = s.start_mus + delta[s.trace_id]
                moved.append(c)
            moved.sort(key=lambda s: (s.start_mus, s.start_mus + s.duration_mus))
            out[ep] = moved
        return out

    return shifted(in_parts), shifted(out_parts)
