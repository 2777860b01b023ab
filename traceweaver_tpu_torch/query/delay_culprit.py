"""Delay-culprit query over reconstructed traces (mirrors
``traceweaver_tpu/query/delay_culprit.py``, its ``e2e_*`` pickle form).

Over the ``e2e_*`` result pickles the executor writes::

    FOR   all end-to-end requests
    WHICH were in the top X %ile response-latency bracket AND
          were initiated after time Y,
    FIND  the worst performing hop AND its mean latency,

answered from the ground-truth traces and from the reconstruction, so
reconstruction quality is judged by whether the query answers agree. An
empty bracket is a counted zero-result (``empty: True``), not an error.
The JAX module's live form over emitted-trace records waits for the
serving layer.
"""

from __future__ import annotations

import argparse
import pickle
from typing import Dict, List, Optional, Tuple


def _e2e_latency(trace: List) -> float:
    return (trace[-1].start_mus + trace[-1].duration_mus) - trace[0].start_mus


def filter_traces(
    traces: Dict[str, List],
    percentile: float = 0.95,
    after_mus: Optional[float] = None,
) -> List[Tuple[str, List]]:
    """Traces in the top (1−percentile) latency bracket started after
    ``after_mus``."""
    complete = {
        tid: spans for tid, spans in traces.items()
        if spans and not any(s is None for s in spans)
    }
    ordered = sorted(complete.items(), key=lambda kv: _e2e_latency(kv[1]))
    cut = int(percentile * len(ordered))
    bracket = ordered[cut:]
    if after_mus is not None:
        bracket = [kv for kv in bracket if kv[1][0].start_mus > after_mus]
    return bracket


def extract_hop_latencies(traces: List[Tuple[str, List]]) -> Dict[int, List]:
    """Per-hop (position in the time-ordered trace) latency records
    ``(trace_id, sid, start, duration)``."""
    hops: Dict[int, List] = {}
    for _tid, spans in traces:
        for i, span in enumerate(spans):
            hops.setdefault(i, []).append(
                (span.trace_id, span.sid, span.start_mus, span.duration_mus)
            )
    return hops


def _worst_service(hops: Dict[int, List], all_spans=None):
    """Hop with the highest mean duration: (hop index, mean µs)."""
    best = (None, -1.0)
    for hop, records in hops.items():
        if not records:
            continue
        mean = sum(r[3] for r in records) / len(records)
        if mean > best[1]:
            best = (hop, mean)
    return best


def delay_culprit(
    e2e_pickle_path: str,
    percentile: float = 0.95,
    after_mus: Optional[float] = None,
    out_path: Optional[str] = None,
) -> Dict[str, dict]:
    """Run the query per method over an ``e2e_*`` result pickle.

    Returns, per method: the true/predicted per-hop latency records and the
    worst (hop, mean latency) pair under each. Optionally persists the
    reference-shaped ``query_latency`` pickle.
    """
    with open(e2e_pickle_path, "rb") as f:
        e2e_traces = pickle.load(f)

    results: Dict[str, dict] = {}
    query_latency: Dict[str, list] = {}
    for method, (true_traces, pred_traces) in e2e_traces.items():
        true_bracket = filter_traces(true_traces, percentile, after_mus)
        pred_bracket = [
            (tid, pred_traces[tid]) for tid, _ in true_bracket
            if tid in pred_traces
            and pred_traces[tid]
            and not any(s is None for s in pred_traces[tid])
        ]
        true_hops = extract_hop_latencies(true_bracket)
        pred_hops = extract_hop_latencies(pred_bracket)
        results[method] = {
            "true_hops": true_hops,
            "pred_hops": pred_hops,
            "worst_true": _worst_service(true_hops),
            "worst_pred": _worst_service(pred_hops),
            "n_true": len(true_bracket),
            "n_pred": len(pred_bracket),
            # counted zero-result marker: an empty bracket (no complete
            # traces, or a percentile/after filter that excludes all) is
            # a legal answer, not an error
            "empty": not true_bracket,
        }
        query_latency[method] = [
            [true_hops.get(i, []) for i in sorted(true_hops)],
            [pred_hops.get(i, []) for i in sorted(pred_hops)],
        ]

    if out_path:
        with open(out_path, "wb") as f:
            pickle.dump(query_latency, f, protocol=pickle.HIGHEST_PROTOCOL)
    return results


def main(argv=None) -> int:
    """``python -m traceweaver_tpu_torch.runtime.cli query E2E_PICKLE``."""
    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli query",
        description="Identify the hop contributing most delay to the hot "
                    "path, from reconstructed vs true traces (an e2e_* "
                    "result pickle).")
    p.add_argument("traces", metavar="e2e_pickle",
                   help="an e2e_* result pickle the executor wrote")
    p.add_argument("--percentile", type=float, default=0.95)
    p.add_argument("--after_mus", type=float, default=None)
    p.add_argument("--out", default=None, help="write query_latency pickle")
    args = p.parse_args(argv)

    results = delay_culprit(args.traces, args.percentile, args.after_mus,
                            args.out)
    if not results:
        print(f"{args.traces}: no methods in the result pickle — "
              "nothing to query")
        return 0
    for method, r in results.items():
        wt, wp = r["worst_true"], r["worst_pred"]
        if r.get("empty") or wt[0] is None:
            print(f"{method}: empty bracket "
                  f"[{r['n_pred']}/{r['n_true']} traces] — no culprit")
            continue
        agree = "AGREE" if wt[0] == wp[0] else "DISAGREE"
        wp_desc = (f"#{wp[0]} mean {wp[1]:.0f}µs" if wp[0] is not None
                   else "none (no reconstructed traces in bracket)")
        print(f"{method}: worst hop (true) #{wt[0]} mean {wt[1]:.0f}µs | "
              f"(pred) {wp_desc} -> {agree} "
              f"[{r['n_pred']}/{r['n_true']} traces reconstructed]")
    return 0
