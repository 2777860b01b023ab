"""Call-graph-signature grouping (mirrors
``traceweaver_tpu/alibaba/grouping.py``).

Clean-room equivalent of the reference's ``analysis.py``
(reference alibaba-analysis/analysis.py:99-126, 214-265): every trace gets
a hash signature over its depth-ordered service multiset; traces sharing a
signature form one call-graph dataset (the ``call_graph_0..14`` dirs exp5
sweeps).
"""

from __future__ import annotations

import hashlib
import os
import shutil
from collections import Counter, defaultdict
from typing import Dict, List

from traceweaver_tpu_torch.alibaba.schema import CallRecord, rpc_depth


def call_graph_signature(records: List[CallRecord]) -> str:
    """Hash of the depth-ordered sorted (caller, callee, rpc_type) multiset —
    stable under span reordering within a depth, sensitive to topology."""
    by_depth: Dict[int, List[str]] = defaultdict(list)
    for rec in records:
        by_depth[rpc_depth(rec.rpc_id)].append(
            f"{rec.caller}->{rec.callee}:{rec.rpc_type}"
        )
    parts = []
    for depth in sorted(by_depth):
        parts.append(f"{depth}|" + ",".join(sorted(by_depth[depth])))
    return hashlib.md5(";".join(parts).encode()).hexdigest()


def group_traces(
    traces: Dict[str, List[CallRecord]],
    out_root: str,
    top_n: int = 15,
    min_traces: int = 2,
    writer=None,
) -> List[str]:
    """Group repaired traces by signature; write the ``top_n`` most common
    call graphs as ``call_graph_<i>/`` Jaeger dirs under ``out_root``.

    ``writer(records, out_dir)`` defaults to Jaeger conversion+write.
    Returns the list of produced dirs.
    """
    from traceweaver_tpu_torch.alibaba.convert import (
        convert_trace_to_jaeger,
        write_jaeger_trace,
    )

    if writer is None:
        def writer(records, out_dir):
            write_jaeger_trace(convert_trace_to_jaeger(records), out_dir)

    by_sig: Dict[str, List[str]] = defaultdict(list)
    for trace_id, records in traces.items():
        by_sig[call_graph_signature(records)].append(trace_id)

    ranked = [
        (sig, tids) for sig, tids in
        sorted(by_sig.items(), key=lambda kv: -len(kv[1]))
        if len(tids) >= min_traces
    ][:top_n]

    out_dirs = []
    for i, (_sig, trace_ids) in enumerate(ranked):
        out_dir = os.path.join(out_root, f"call_graph_{i}")
        if os.path.isdir(out_dir):
            shutil.rmtree(out_dir)
        os.makedirs(out_dir, exist_ok=True)
        for tid in trace_ids:
            writer(traces[tid], out_dir)
        out_dirs.append(out_dir)
    return out_dirs
