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
The live form, :func:`live_delay_culprit`, answers the same question
over the serve tier's emitted-trace records (a tenant's ring, or a JSONL
file of them read by :func:`load_trace_records`).
"""

from __future__ import annotations

import argparse
import json
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


def live_delay_culprit(
    records: List[dict],
    percentile: float = 0.95,
    after_us: Optional[float] = None,
    min_confidence: Optional[float] = None,
) -> dict:
    """The live form of the query, over emitted-trace records.

    ``records`` are the serve layer's ring records
    (:func:`traceweaver_tpu_torch.serve.ring.build_trace_records`): one dict per
    reconstructed trace with ``e2e_us``, ``root_start_us``, and a
    time-ordered ``spans`` list whose entries carry ``service``, ``kind``,
    ``dur_us``, and ``self_us`` (duration minus children — the exclusive
    time that makes "worst service" mean the service that *spent* the
    latency, not the frontend that merely contained it).

    ``min_confidence`` excludes records whose ``tw.confidence`` summary
    (attached by the serve ring and the stream sink) falls
    below the bar — culprit attribution over inferred traces is only as
    good as the inference, so low-trust reconstructions can be kept out
    of the bracket entirely. Records carrying NO confidence (pre-quality
    emitters) pass the filter: they cannot be judged, and silently
    dropping them would empty legacy brackets. The count of excluded
    records ships as ``n_low_confidence_excluded``.

    Returns a counted zero-result (``empty: True``) for an empty bracket
    instead of crashing — the query surface must tolerate a tenant whose
    first window has not sealed yet.
    """
    usable = [r for r in records
              if r.get("spans") and r.get("complete", True)]
    n_low_excluded = 0
    if min_confidence is not None:
        kept = []
        for r in usable:
            conf = (r.get("tw.confidence") or {}).get("conf")
            if conf is not None and conf < min_confidence:
                n_low_excluded += 1
            else:
                kept.append(r)
        usable = kept
    ordered = sorted(usable, key=lambda r: float(r["e2e_us"]))
    cut = int(percentile * len(ordered))
    bracket = ordered[cut:]
    if after_us is not None:
        bracket = [r for r in bracket
                   if float(r["root_start_us"]) > after_us]

    per_service: Dict[str, List[float]] = {}
    hops: Dict[int, List[float]] = {}
    for rec in bracket:
        for i, s in enumerate(rec["spans"]):
            hops.setdefault(i, []).append(float(s["dur_us"]))
            if s.get("kind") == "server":
                per_service.setdefault(s["service"], []).append(
                    float(s.get("self_us", s["dur_us"])))

    service_means = {
        svc: sum(v) / len(v) for svc, v in per_service.items() if v
    }
    worst_svc = max(service_means, key=service_means.get) \
        if service_means else None
    hop_means = {h: sum(v) / len(v) for h, v in hops.items() if v}
    worst_hop = max(hop_means, key=hop_means.get) if hop_means else None
    return {
        "empty": not bracket,
        "n_traces": len(usable),
        "n_bracket": len(bracket),
        "percentile": percentile,
        "after_us": after_us,
        "min_confidence": min_confidence,
        "n_low_confidence_excluded": n_low_excluded,
        "worst_service": worst_svc,
        "worst_mean_self_us": (service_means[worst_svc]
                               if worst_svc is not None else 0.0),
        "per_service": {
            svc: {"mean_self_us": service_means[svc],
                  "n_spans": len(per_service[svc])}
            for svc in sorted(service_means)
        },
        "worst_hop": ([worst_hop, hop_means[worst_hop]]
                      if worst_hop is not None else [None, 0.0]),
    }


def load_trace_records(path: str) -> List[dict]:
    """Read a JSONL file of emitted-trace records (one per line — the
    serve ring's dump format), skipping blank lines."""
    records = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


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
                    "result pickle) or from an emitted-trace JSONL record "
                    "file (the serve ring's format).")
    p.add_argument("traces", metavar="e2e_pickle|records.jsonl",
                   help="an e2e_* result pickle the executor wrote, or a "
                        ".jsonl file of emitted-trace records")
    p.add_argument("--percentile", type=float, default=0.95)
    p.add_argument("--after_mus", type=float, default=None)
    p.add_argument("--min_confidence", type=float, default=None,
                   help="exclude records whose tw.confidence falls below "
                        "this bar (the JSONL form only)")
    p.add_argument("--out", default=None, help="write query_latency pickle")
    args = p.parse_args(argv)

    if args.traces.endswith((".jsonl", ".json")):
        res = live_delay_culprit(load_trace_records(args.traces),
                                 args.percentile, args.after_mus,
                                 min_confidence=args.min_confidence)
        if res["n_low_confidence_excluded"]:
            print(f"(excluded {res['n_low_confidence_excluded']} "
                  f"record(s) under confidence {args.min_confidence:g})")
        if res["empty"]:
            print(f"{args.traces}: empty bracket "
                  f"({res['n_traces']} traces, 0 in the "
                  f"p{args.percentile * 100:g} bracket) — no culprit")
            return 0
        print(f"worst service: {res['worst_service']} "
              f"(mean self {res['worst_mean_self_us']:.0f}µs over "
              f"{res['n_bracket']} traces in the "
              f"p{args.percentile * 100:g} bracket)")
        for svc, r in res["per_service"].items():
            print(f"  {svc}: mean self {r['mean_self_us']:.0f}µs "
                  f"({r['n_spans']} spans)")
        return 0

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
