"""Per-regime baseline scorecard and confidence calibration (mirrors
``traceweaver_tpu/metrics/scorecard.py``).

Every in-repo baseline (vPath, WAP5, FCFS, ArrivalOrder, WeaverExact)
and the solver run over the synthetic labelled corpus, one service per
regime (``metrics/synth.py synth_labeled_corpus``: sequential,
async-overlap, fan-out), and the scorecard gives the accuracy per
(method, regime) and the solver's confidence-decile calibration table,
which shows whether its per-span confidence predicts correctness.

The solver leg (``weaver_torch``) is the fleet path, ``solve_fleet``
with per-span confidence records, on ``device`` (None: the card, which
raises without one); the JAX package names that leg ``weaver_tpu``.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.metrics.accuracy import (
    accuracy_by_confidence_decile,
    accuracy_for_service,
    calibration_monotone,
    get_ground_truth,
    service_regime,
    span_correctness,
)
from traceweaver_tpu_torch.metrics.synth import synth_labeled_corpus

#: method keys: the five in-repo baselines, then the solver
BASELINE_METHODS = ("vpath", "wap5", "fcfs", "arrival_order", "weaver_exact")
SOLVER_METHOD = "weaver_torch"
ALL_METHODS = BASELINE_METHODS + (SOLVER_METHOD,)


def _corpus_tables(corpus: List[Dict]) -> Tuple[Dict, Dict]:
    """``(all_spans, all_processes)`` over the whole corpus."""
    all_spans: Dict = {}
    all_processes: Dict = {}
    for prob in corpus:
        for spans in list(prob["in_parts"].values()) \
                + list(prob["out_parts"].values()):
            for s in spans:
                all_spans[s.GetId()] = s
                all_processes.setdefault(s.trace_id, {})[s.process_id] = \
                    s.process_id
    return all_spans, all_processes


def _subset(prob: Dict, k: int) -> Tuple[Dict, Dict]:
    """The first ``k`` incoming spans of a service with their own ground
    truth: the exact DFS + MWIS path explodes on overlapping regimes, so
    it is graded on a capped slice."""
    in_ep = next(iter(prob["in_parts"]))
    spans = sorted(prob["in_parts"][in_ep],
                   key=lambda s: (s.start_mus, s.end_mus))[:k]
    sub_in = {in_ep: spans}
    return sub_in, get_ground_truth(sub_in, prob["out_parts"])


def _run_baseline(key: str, prob: Dict, all_spans, all_processes,
                  exact_traces: Optional[int] = None):
    """One baseline; returns ``(pred, in_parts, truth)``: the exact path
    solves and is graded on its capped subset, every other one on the
    whole service."""
    from traceweaver_tpu_torch.algorithms import (
        FCFS,
        WAP5,
        ArrivalOrder,
        VPath,
        WeaverExact,
    )

    cls, method = {
        "vpath": (VPath, "VPath"),
        "wap5": (WAP5, "WAP5"),
        "fcfs": (FCFS, "FCFS"),
        "arrival_order": (ArrivalOrder, "ArrivalOrder"),
        "weaver_exact": (WeaverExact, "MaxScoreBatch"),
    }[key]
    in_parts, truth = prob["in_parts"], prob["truth"]
    if key == "weaver_exact" and exact_traces is not None:
        in_parts, truth = _subset(prob, exact_traces)
    algo = cls(all_spans, all_processes)
    out = algo.FindAssignments(
        method, prob["service"], in_parts, prob["out_parts"],
        False, [], truth)
    return (out[0] if isinstance(out, tuple) else out), in_parts, truth


def run_scorecard(seed: int = 0, n_traces: int = 48,
                  methods: Tuple[str, ...] = ALL_METHODS,
                  nbins: int = 10, exact_traces: int = 12,
                  device=None, stats: Optional[Dict[str, float]] = None) -> Dict:
    """Every method over every regime service, and the solver's
    confidence calibration. Returns the artifact dict (JSON-ready).
    ``exact_traces`` caps the weaver_exact leg's incoming spans per
    service (``weaver_exact_subset_spans`` in the artifact); ``stats``
    receives the solver leg's ``solve_fleet`` ledger."""
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet
    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device

    device = resolve_device(device)
    corpus = synth_labeled_corpus(seed=seed, n_traces=n_traces)
    all_spans, all_processes = _corpus_tables(corpus)

    per_service: Dict[str, Dict] = {}
    for prob in corpus:
        per_service[prob["service"]] = dict(
            **service_regime(prob["in_parts"], prob["out_parts"]),
            n_spans=len(next(iter(prob["in_parts"].values()))),
            methods={},
        )

    for key in methods:
        if key == SOLVER_METHOD:
            continue
        for prob in corpus:
            pred, in_parts, truth = _run_baseline(
                key, prob, all_spans, all_processes,
                exact_traces=exact_traces)
            acc = accuracy_for_service(pred, truth, in_parts)
            per_service[prob["service"]]["methods"][key] = round(acc, 4)

    confidence: Dict = {}
    correct: Dict = {}
    if SOLVER_METHOD in methods:
        items = [FleetItem(prob["service"], prob["in_parts"],
                           prob["out_parts"], prob["truth"], prob["dag"])
                 for prob in corpus]
        confs: List[Optional[Dict]] = [None] * len(items)
        outs = solve_fleet(items, all_spans=all_spans,
                           all_processes=all_processes,
                           confidences=confs, device=device, stats=stats)
        for prob, out, conf in zip(corpus, outs, confs):
            pred = out[0]
            acc = accuracy_for_service(pred, prob["truth"], prob["in_parts"])
            per_service[prob["service"]]["methods"][SOLVER_METHOD] = round(acc, 4)
            correct.update(span_correctness(pred, prob["truth"],
                                            prob["in_parts"]))
            for sid, rec in (conf or {}).items():
                confidence[sid] = rec["conf"]

    # per-regime means over the services in each bucket
    per_regime: Dict[str, Dict] = {}
    for row in per_service.values():
        bucket = per_regime.setdefault(
            row["regime"], {m: [] for m in row["methods"]})
        for m, acc in row["methods"].items():
            bucket.setdefault(m, []).append(acc)
    per_regime = {
        regime: {m: round(sum(v) / len(v), 4)
                 for m, v in sorted(accs.items()) if v}
        for regime, accs in sorted(per_regime.items())
    }

    calibration = accuracy_by_confidence_decile(confidence, correct,
                                                nbins=nbins)
    monotone_ok, violations = calibration_monotone(calibration)
    return dict(
        seed=seed,
        n_traces=n_traces,
        device=str(device),
        weaver_exact_subset_spans=(exact_traces
                                   if "weaver_exact" in methods else None),
        methods=sorted(methods),
        per_service=per_service,
        per_regime=per_regime,
        calibration=calibration,
        calibration_monotone_ok=monotone_ok,
        calibration_violations=violations,
    )


def write_scorecard(card: Dict, path: str) -> None:
    with open(path, "w") as f:
        json.dump(card, f, indent=2, sort_keys=True)
        f.write("\n")


def format_scorecard(card: Dict) -> str:
    """One row per regime, one column per method, then the calibration
    deciles and the monotone-ish verdict."""
    methods = card["methods"]
    lines = ["scorecard (exact-match accuracy per regime; seed %d, %d "
             "traces/service)" % (card["seed"], card["n_traces"])]
    lines.append("%-12s" % "regime" + "".join("%14s" % m for m in methods))
    for regime, accs in card["per_regime"].items():
        lines.append("%-12s" % regime + "".join(
            "%14s" % (("%.3f" % accs[m]) if m in accs else "-")
            for m in methods))
    if card["calibration"]:
        lines.append("confidence calibration (%s, %d bins):"
                     % (SOLVER_METHOD, len(card["calibration"])))
        for row in card["calibration"]:
            lines.append(
                "  decile %2d  conf [%.3f, %.3f]  n=%-4d  acc %.3f"
                % (row["decile"], row["conf_lo"], row["conf_hi"],
                   row["n"], row["accuracy"]))
        lines.append("calibration monotone-ish: %s"
                     % ("OK" if card["calibration_monotone_ok"]
                        else "WARNING — " + "; ".join(
                            card["calibration_violations"])))
    return "\n".join(lines)


def main(argv=None) -> int:
    """``python -m traceweaver_tpu_torch.runtime.cli scorecard``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli scorecard",
        description="Per-regime accuracy scorecard: the five baselines and "
                    "the solver over a synthetic labelled corpus, with the "
                    "solver's confidence-decile calibration table.")
    p.add_argument("--traces", type=int, default=48,
                   help="traces per regime service (default 48)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--bins", type=int, default=10,
                   help="confidence calibration buckets (default 10)")
    p.add_argument("--exact-traces", type=int, default=12,
                   help="incoming-span cap of the weaver_exact leg")
    p.add_argument("--out", default=None,
                   help="write the scorecard artifact JSON here")
    p.add_argument("--device", default=None,
                   help="device of the solver leg (default: the CUDA card)")
    args = p.parse_args(argv)

    card = run_scorecard(seed=args.seed, n_traces=args.traces,
                         nbins=args.bins, exact_traces=args.exact_traces,
                         device=args.device)
    print(format_scorecard(card))
    if args.out:
        write_scorecard(card, args.out)
        print(f"scorecard artifact -> {args.out}")
    # a calibration warning is reported, not an exit failure
    return 0
