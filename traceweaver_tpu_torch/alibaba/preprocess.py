"""Shard MSCallGraph CSVs per trace (mirrors
``traceweaver_tpu/alibaba/preprocess.py``).

Streaming splitter (reference alibaba-analysis/preprocess.py:27-113): read
each ``MSCallGraph_<k>.csv`` shard, group rows by trace id, and append each
trace's rows into its origin shard's directory. Rows of a trace can
straddle shard files; a bounded lookback resolves stragglers into the shard
where the trace first appeared (reference uses a 5-shard lookback).
"""

from __future__ import annotations

import csv
import os
from collections import defaultdict
from typing import Dict, Iterable, List

from traceweaver_tpu_torch.alibaba.schema import COL_TRACE_ID


def split_shard_csv(
    csv_path: str,
    out_root: str,
    shard_id: int,
    trace_origin: Dict[str, int],
    lookback: int = 5,
) -> int:
    """Split one shard CSV into per-trace CSV files.

    ``trace_origin`` maps trace ids to the shard where they first appeared;
    it is shared across calls so straddling rows land with their trace.
    Returns the number of traces touched.
    """
    groups: Dict[str, List[List[str]]] = defaultdict(list)
    with open(csv_path, newline="") as f:
        for row in csv.reader(f):
            if not row or row[COL_TRACE_ID] == "traceid":
                continue
            tid = row[COL_TRACE_ID]
            trace_origin.setdefault(tid, shard_id)
            groups[tid].append(row)

    for tid, rows in groups.items():
        origin = trace_origin[tid]
        if origin < shard_id - lookback:
            origin = shard_id  # beyond lookback: keep local (counted as error
            # in the reference, preprocess.py num_lookback_errors)
        shard_dir = os.path.join(out_root, f"shard{origin}")
        os.makedirs(shard_dir, exist_ok=True)
        with open(os.path.join(shard_dir, f"{tid}.csv"), "a", newline="") as f:
            csv.writer(f).writerows(rows)
    return len(groups)


def split_all(csv_paths: Iterable[str], out_root: str, lookback: int = 5) -> int:
    trace_origin: Dict[str, int] = {}
    total = 0
    for shard_id, path in enumerate(csv_paths):
        total += split_shard_csv(path, out_root, shard_id, trace_origin,
                                 lookback)
    return total
