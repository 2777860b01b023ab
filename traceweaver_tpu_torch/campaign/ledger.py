"""Campaign ledger: artifact assembly and the ``tw_campaign_*`` mirror
(mirrors ``traceweaver_tpu/campaign/ledger.py``).

A rung's measured numbers are assembled here, and every number that
lands in the ``CAMPAIGN_*.json`` artifact also lands on ``/metrics``
through a scrape-time collector over the same state dict (no second
counter path). Events (``kind="campaign"``: start, rung, finish) ride
the event sink (:mod:`traceweaver_tpu_torch.obs.events`), so ``cli
events --kind campaign`` tails a run.

The port compiles nothing at run time: its kernels are built by ``nvcc``
at their first use (``ops/cuda_build.py``). The JAX artifact's
``backend_compiles`` and ``aot_misses`` and the families
``tw_campaign_steady_compiles_total`` and ``tw_campaign_aot_miss_total``
keep their keys and count the port's counterpart: kernel builds at first
use observed inside a timed phase, a healthy campaign's being zero. The
artifact keeps the JAX package's shape, so the JAX package's
``campaign.compare`` reads the port's artifacts.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry

ARTIFACT_SCHEMA = 1

#: the fleet's byte-ledger keys frozen per timed phase; absent counters
#: report 0 so artifacts stay diffable
BYTE_KEYS = ("h2d_bytes_shipped", "h2d_bytes_ring", "h2d_bytes_index",
             "d2h_bytes_fetched", "d2h_bytes_flags", "d2h_bytes_resident",
             "d2h_flag_fetches")


# ---------------------------------------------------------------------------
# dispatch-latency percentiles from the tw_dispatch_seconds histogram
# ---------------------------------------------------------------------------

def _bucket_deltas(before: Dict[str, float], after: Dict[str, float],
                   name: str) -> List[Tuple[float, float]]:
    """Cumulative ``(le bound, count delta)`` rows of one histogram between
    two ``registry.snapshot()`` calls."""
    prefix = name + '_bucket{le="'
    rows = []
    for key, v_after in after.items():
        if not key.startswith(prefix):
            continue
        le = key[len(prefix):key.rindex('"')]
        bound = float("inf") if le == "+Inf" else float(le)
        rows.append((bound, v_after - before.get(key, 0.0)))
    rows.sort()
    return rows


def histogram_percentiles(before: Dict[str, float], after: Dict[str, float],
                          name: str, qs: Sequence[float] = (0.5, 0.9, 0.99),
                          ) -> Optional[Dict[str, float]]:
    """Prometheus-style percentile estimates (bucket upper bounds) of the
    observations one phase added to a cumulative histogram; None when the
    phase observed nothing. The +Inf bucket reads as the largest finite
    bound: every reported value is a declared bucket edge."""
    rows = _bucket_deltas(before, after, name)
    if not rows:
        return None
    total = rows[-1][1]
    if total <= 0:
        return None
    finite = [b for b, _ in rows if b != float("inf")]
    out = {}
    for q in qs:
        target = q * total
        chosen = finite[-1] if finite else 0.0
        for bound, cum in rows:
            if cum >= target:
                chosen = bound if bound != float("inf") else (finite[-1] if finite else 0.0)
                break
        out["p%g" % (q * 100)] = chosen
    return out


def byte_ledger(stats: Dict[str, float]) -> Dict[str, float]:
    return {k: float(stats.get(k, 0.0)) for k in BYTE_KEYS}


def merge_stats(acc: Dict[str, float], stats: Dict) -> None:
    """Accumulate one round's numeric fleet counters into ``acc`` (list
    and dict entries of the ledger have collectors of their own)."""
    for k, v in stats.items():
        if isinstance(v, (int, float)):
            acc[k] = acc.get(k, 0.0) + float(v)


# ---------------------------------------------------------------------------
# /metrics mirror: a scrape-time collector over the campaign state
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_STATE: Dict[str, object] = {
    "runs": 0.0,           # campaigns finished in this process
    "rungs": 0.0,          # rung phases completed
    "steady_compiles": 0.0,
    "aot_misses": 0.0,
    "per_rung": {},        # rung -> {"spans_per_s": .., "accuracy_e2e": ..}
}
_COLLECTOR_INSTALLED = False


def _collect():
    with _LOCK:
        st = dict(_STATE)
        per_rung = {k: dict(v) for k, v in _STATE["per_rung"].items()}
    fams = [
        ("tw_campaign_runs_total", "counter",
         "campaign runs finished in this process",
         [({}, float(st["runs"]))]),
        ("tw_campaign_rungs_total", "counter",
         "campaign rung phases completed",
         [({}, float(st["rungs"]))]),
        ("tw_campaign_steady_compiles_total", "counter",
         "kernel builds (nvcc at first use) observed inside timed steady "
         "phases (a healthy campaign holds this at zero)",
         [({}, float(st["steady_compiles"]))]),
        ("tw_campaign_aot_miss_total", "counter",
         "kernel sources found unbuilt inside timed phases (built at first "
         "use)",
         [({}, float(st["aot_misses"]))]),
    ]
    if per_rung:
        fams.append((
            "tw_campaign_spans_per_s", "gauge",
            "sustained reconstruction throughput per rung (last run)",
            [({"rung": r}, v["spans_per_s"]) for r, v in sorted(per_rung.items())]))
        fams.append((
            "tw_campaign_accuracy_e2e", "gauge",
            "end-to-end accuracy (%) per rung (last run)",
            [({"rung": r}, v["accuracy_e2e"]) for r, v in sorted(per_rung.items())]))
    return fams


def _install_collector() -> None:
    global _COLLECTOR_INSTALLED
    if _COLLECTOR_INSTALLED:
        return
    _get_registry().register_collector("campaign", _collect)
    _COLLECTOR_INSTALLED = True


def record_start(name: str, plan: Dict) -> None:
    _install_collector()
    _events.emit("campaign", "start", campaign=name,
                 rungs=[r["name"] for r in plan.get("rungs", [])],
                 devices=plan.get("devices"), slices=plan.get("slices"))


def record_rung(name: str, rung: str, spans_per_s: float, accuracy_e2e: float,
                steady_compiles: int, aot_misses: int) -> None:
    with _LOCK:
        _STATE["rungs"] = float(_STATE["rungs"]) + 1.0
        _STATE["steady_compiles"] = float(_STATE["steady_compiles"]) + steady_compiles
        _STATE["aot_misses"] = float(_STATE["aot_misses"]) + aot_misses
        _STATE["per_rung"][rung] = dict(spans_per_s=float(spans_per_s),
                                        accuracy_e2e=float(accuracy_e2e))
    _events.emit("campaign", "rung", campaign=name, rung=rung,
                 spans_per_s=round(spans_per_s, 1), accuracy_e2e=round(accuracy_e2e, 3),
                 steady_compiles=steady_compiles, aot_misses=aot_misses)


def record_finish(name: str, wall_s: float, out_path: Optional[str]) -> None:
    with _LOCK:
        _STATE["runs"] = float(_STATE["runs"]) + 1.0
    _events.emit("campaign", "finish", campaign=name, wall_s=round(wall_s, 2),
                 artifact=out_path)


def reset_for_tests() -> None:
    with _LOCK:
        _STATE.update(runs=0.0, rungs=0.0, steady_compiles=0.0, aot_misses=0.0,
                      per_rung={})


# ---------------------------------------------------------------------------
# the artifact
# ---------------------------------------------------------------------------

def scrape_snapshot(max_lines: int = 400) -> Dict[str, object]:
    """A bounded ``/metrics`` scrape of this process: sample lines only
    (HELP and TYPE dropped), capped, with the cap and the dropped-line
    count in the snapshot."""
    from traceweaver_tpu_torch.obs.exposition import render_metrics

    lines = [ln for ln in render_metrics().splitlines()
             if ln and not ln.startswith("#")]
    return dict(captured_unix=round(time.time(), 3), total_samples=len(lines),
                truncated=max(0, len(lines) - max_lines), samples=lines[:max_lines])


def make_artifact(name: str, plan: Dict, backend: str, devices_visible: int,
                  rungs: List[Dict], scrape: Optional[Dict], wall_s: float) -> Dict:
    return dict(
        schema=ARTIFACT_SCHEMA,
        kind="campaign",
        name=name,
        created_unix=round(time.time(), 3),
        backend=backend,
        devices_visible=devices_visible,
        plan=plan,
        rungs=rungs,
        metrics_scrape=scrape,
        wall_s=round(wall_s, 3),
    )


def write_artifact(path: str, artifact: Dict) -> str:
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_artifact(path: str) -> Dict:
    with open(path) as f:
        art = json.load(f)
    if not isinstance(art, dict) or art.get("kind") != "campaign":
        raise ValueError(f"{path}: not a campaign artifact")
    return art
