"""Campaign regression gate: diff two ``CAMPAIGN_*`` artifacts (mirrors
``traceweaver_tpu/campaign/compare.py``).

``compare_artifacts(baseline, candidate)`` answers "did the headline
number regress" (``ok`` False = a regression):

- **throughput**: a rung's sustained spans/s more than ``tol_pct``
  percent below the baseline's;
- **accuracy**: end-to-end accuracy more than ``tol_acc`` points below;
- **aot_misses**: kernel sources the candidate built inside a timed
  phase that the baseline did not (the port's counterpart of the JAX
  package's shapes escaping its ahead-of-time lattice);
- **steady compiles**: timed phases building kernels where the
  baseline's did not;
- **coverage**: a baseline rung missing from the candidate;
- **environment**: artifacts from another backend or device count are
  refused outright.

Improvements are reported, never flagged. The JAX package's
``TW_CAMPAIGN_TOL_PCT`` and ``TW_CAMPAIGN_TOL_ACC`` knobs are the
``tol_pct`` and ``tol_acc`` arguments, with the knobs' defaults (10.0
percent and 1.0 point) and their range (not negative). The tolerances
ride in the result, so a diff is self-describing.
"""

from __future__ import annotations

from typing import Dict, List

from traceweaver_tpu_torch.campaign.ledger import load_artifact

#: ``TW_CAMPAIGN_TOL_PCT`` and ``TW_CAMPAIGN_TOL_ACC``'s defaults
TOL_PCT = 10.0
TOL_ACC = 1.0


def _check_tolerance(name: str, value: float) -> float:
    value = float(value)
    if not value >= 0.0:
        raise ValueError(f"{name} {value} not in [0, inf)")
    return value


def _rungs_by_name(artifact: Dict) -> Dict[str, Dict]:
    return {r["rung"]: r for r in artifact.get("rungs", [])}


def compare_artifacts(baseline: Dict, candidate: Dict, tol_pct: float = TOL_PCT,
                      tol_acc: float = TOL_ACC) -> Dict:
    """Diff two artifact dicts (see the module docstring). Returns
    ``{ok, tolerances, rungs: [...], regressions: [...]}``, each
    regression naming its rung, field, both values and the tolerance it
    broke."""
    tol_pct = _check_tolerance("tol_pct", tol_pct)
    tol_acc = _check_tolerance("tol_acc", tol_acc)
    tolerances = dict(throughput_pct=tol_pct, accuracy_pts=tol_acc)
    regressions: List[Dict] = []
    rows: List[Dict] = []

    def flag(rung: str, field: str, base, cand, tolerance, detail=""):
        regressions.append(dict(rung=rung, field=field, baseline=base, candidate=cand,
                                tolerance=tolerance, detail=detail))

    # another backend or device count measures the hardware, not the change
    for field in ("backend", "devices_visible"):
        b_env, c_env = baseline.get(field), candidate.get(field)
        if b_env != c_env:
            flag("-", "environment_%s" % field, b_env, c_env, "identical environment",
                 "artifacts ran on different %s — comparison refused" % field)
    if regressions:
        return dict(ok=False, tolerances=tolerances, rungs=rows, regressions=regressions)

    cand_rungs = _rungs_by_name(candidate)
    for name, b in _rungs_by_name(baseline).items():
        c = cand_rungs.get(name)
        if c is None:
            flag(name, "missing_rung", True, False, None,
                 "baseline rung absent from candidate")
            continue
        b_tp = float(b["steady"]["spans_per_s"])
        c_tp = float(c["steady"]["spans_per_s"])
        tp_delta_pct = 100.0 * (c_tp - b_tp) / b_tp if b_tp else 0.0
        if b_tp and c_tp < b_tp * (1.0 - tol_pct / 100.0):
            flag(name, "spans_per_s", b_tp, c_tp, f"-{tol_pct}%",
                 f"throughput {tp_delta_pct:+.1f}%")
        b_acc = float(b["accuracy"]["e2e_pct"])
        c_acc = float(c["accuracy"]["e2e_pct"])
        if c_acc < b_acc - tol_acc:
            flag(name, "accuracy_e2e_pct", b_acc, c_acc, f"-{tol_acc} pts",
                 f"accuracy {c_acc - b_acc:+.2f} pts")
        new_misses = sorted(set(c["steady"].get("aot_misses", []))
                            - set(b["steady"].get("aot_misses", [])))
        if new_misses:
            flag(name, "aot_misses", b["steady"].get("aot_misses", []), new_misses,
                 "no new escapes", f"{len(new_misses)} new kernel build(s) in a timed phase")
        b_comp = int(b["steady"].get("backend_compiles", 0))
        c_comp = int(c["steady"].get("backend_compiles", 0))
        if c_comp > b_comp:
            flag(name, "steady_backend_compiles", b_comp, c_comp,
                 "no new steady-state compiles",
                 "timed rounds built kernels where the baseline ran warm")
        rows.append(dict(rung=name, spans_per_s_base=b_tp, spans_per_s_cand=c_tp,
                         throughput_delta_pct=round(tp_delta_pct, 2),
                         accuracy_delta_pts=round(c_acc - b_acc, 3)))
    return dict(ok=not regressions, tolerances=tolerances, rungs=rows,
                regressions=regressions)


def format_compare(result: Dict) -> str:
    lines = ["campaign compare (tolerances: throughput -%s%%, accuracy -%s pts)"
             % (result["tolerances"]["throughput_pct"],
                result["tolerances"]["accuracy_pts"])]
    lines.append("%-12s %14s %14s %9s %9s"
                 % ("rung", "base spans/s", "cand spans/s", "tp Δ%", "acc Δpts"))
    for row in result["rungs"]:
        lines.append("%-12s %14.1f %14.1f %+9.1f %+9.2f"
                     % (row["rung"], row["spans_per_s_base"], row["spans_per_s_cand"],
                        row["throughput_delta_pct"], row["accuracy_delta_pts"]))
    if result["ok"]:
        lines.append("OK — no regression past tolerance")
    else:
        for r in result["regressions"]:
            lines.append("REGRESSION %s/%s: baseline=%s candidate=%s (tolerance %s) %s"
                         % (r["rung"], r["field"], r["baseline"], r["candidate"],
                            r["tolerance"], r["detail"]))
    return "\n".join(lines)


def format_report(artifact: Dict) -> str:
    """One artifact's rung table with its steady-state gates."""
    lines = ["campaign %r: backend=%s devices_visible=%d wall %.1fs"
             % (artifact["name"], artifact["backend"], artifact["devices_visible"],
                artifact["wall_s"])]
    lines.append("%-12s %10s %12s %8s %9s %8s %8s"
                 % ("rung", "spans", "spans/s", "e2e%", "compiles", "misses", "quar"))
    for r in artifact["rungs"]:
        s = r["steady"]
        lines.append("%-12s %10d %12.1f %8.2f %9d %8d %8d"
                     % (r["rung"], r["manifest"]["spans"], s["spans_per_s"],
                        r["accuracy"]["e2e_pct"], s["backend_compiles"],
                        len(s["aot_misses"]), s["quarantined"]))
        mix = r["manifest"].get("regime_mix", {})
        per_regime = r["accuracy"].get("per_regime", {})
        if mix:
            lines.append("             regimes %s; accuracy %s" % (mix, per_regime))
        ms = r.get("multislice")
        if ms:
            lines.append("             multislice: %d slices, %d edges allreduced (%s), "
                         "agree=%s" % (ms["slices"], ms["edges"], ms["transport"],
                                       ms["agree"]))
    return "\n".join(lines)


def compare_paths(baseline_path: str, candidate_path: str, tol_pct: float = TOL_PCT,
                  tol_acc: float = TOL_ACC) -> Dict:
    return compare_artifacts(load_artifact(baseline_path), load_artifact(candidate_path),
                             tol_pct=tol_pct, tol_acc=tol_acc)
