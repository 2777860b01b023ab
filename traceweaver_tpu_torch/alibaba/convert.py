"""Trace repair + Jaeger-JSON conversion for MSCallGraph traces (mirrors
``traceweaver_tpu/alibaba/convert.py``).

Clean-room equivalent of the reference's ``real-parser.py``
(reference alibaba-analysis/real-parser.py:35-359):

- sort a trace's rows by dotted rpc_id (version-style ordering);
- drop oversized traces (>200 spans);
- delete mirrored duplicate rows (the dataset logs some calls twice, once
  with negative rt — ``fixDuplicates``, :35-61);
- fill missing caller/callee ('(?)') from the parent / sibling / child
  rows when unambiguous (``checkNeighbours``/``fixMissingInSpan``,
  :134-187);
- validate the rpc_id hierarchy is a single-rooted tree
  (``buildCallGraph``, :283-306);
- emit Jaeger JSON with a synthetic server+client record pair per non-root
  call sharing the rpc_id as spanID, ``caller``/``callee``/``requestType``
  fields and ms→µs×1000 times (``convertToJaegerFormat``, :308-359).
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.alibaba.schema import (
    CallRecord,
    is_missing,
    parent_rpc_id,
    rpc_depth,
)

MAX_TRACE_SPANS = 200


def _rpc_sort_key(rpc_id: str) -> Tuple:
    parts = []
    for p in rpc_id.split("."):
        try:
            parts.append(int(p))
        except ValueError:
            parts.append(0)
    return tuple(parts)


def _dedupe_mirrored(records: List[CallRecord]) -> List[CallRecord]:
    """Drop the second of a mirrored pair: same (trace, rpc_id, caller,
    rpc_type, callee) logged twice, one side with negative rt."""
    seen: Dict[Tuple, CallRecord] = {}
    out: List[CallRecord] = []
    for rec in records:
        key = (rec.trace_id, rec.rpc_id, rec.caller, rec.rpc_type, rec.callee)
        prev = seen.get(key)
        if prev is not None and (prev.rt_ms >= 0) != (rec.rt_ms >= 0):
            # mirrored duplicate: keep the non-negative-rt side
            if prev.rt_ms < 0 <= rec.rt_ms:
                out[out.index(prev)] = rec
                seen[key] = rec
            continue
        seen[key] = rec
        out.append(rec)
    return out


def _fill_missing(records: List[CallRecord]) -> bool:
    """Fill '(?)' caller/callee fields from relatives; False if unfixable."""
    by_rpc: Dict[str, List[CallRecord]] = {}
    for rec in records:
        by_rpc.setdefault(rec.rpc_id, []).append(rec)

    for rec in records:
        if is_missing(rec.caller):
            parent = by_rpc.get(parent_rpc_id(rec.rpc_id), [])
            siblings = [
                r for r in records
                if parent_rpc_id(r.rpc_id) == parent_rpc_id(rec.rpc_id)
                and r.rpc_id != rec.rpc_id
            ]
            if parent and not is_missing(parent[0].callee):
                rec.caller = parent[0].callee
            elif siblings and not is_missing(siblings[0].caller):
                rec.caller = siblings[0].caller
            else:
                return False
        if is_missing(rec.callee):
            children = [
                r for r in records if parent_rpc_id(r.rpc_id) == rec.rpc_id
            ]
            if children and not is_missing(children[0].caller):
                rec.callee = children[0].caller
            else:
                return False
    return True


def _validate_tree(records: List[CallRecord]) -> bool:
    """rpc_ids must form a single-rooted tree with unique ids."""
    if not records:
        return False
    seen = set()
    root_depth = rpc_depth(records[0].rpc_id)
    for i, rec in enumerate(records):
        if rec.rpc_id in seen:
            return False
        seen.add(rec.rpc_id)
        if i != 0:
            if rpc_depth(rec.rpc_id) == root_depth:
                return False  # multiple roots
            if parent_rpc_id(rec.rpc_id) not in seen:
                return False  # orphan
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


def convert_trace_to_jaeger(records: List[CallRecord]) -> dict:
    """Jaeger-JSON dict with server+client record pairs per call."""
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
                "spanID": parent_rpc_id(rec.rpc_id),
            })
        spans.append(server)
        if rec.rpc_id != root_rpc:
            client = dict(server)
            client["tags"] = [{"key": "span.kind", "value": "client"}]
            client["processID"] = rec.caller
            client["references"] = [dict(r) for r in server["references"]]
            spans.append(client)
    return {"data": [{"traceID": records[0].trace_id, "spans": spans}]}


def write_jaeger_trace(trace: dict, out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    trace_id = trace["data"][0]["traceID"]
    path = os.path.join(out_dir, f"{trace_id}.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump(trace, f, ensure_ascii=False)
    return path
