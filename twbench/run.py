"""Run one cell of the benchmark of ``traceweaver_tpu_torch`` on the card.

    python3 -m twbench.run --workload CELL --seed N --seconds S --trace 0|1

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted`` and ``failed`` (services solved and quarantined in the
rounds of the window, and of the traced window), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics, each read by
``twbench/metrics/<name>.py``), ``device`` and, traced, ``breakdown``; last,
``checks``: each number compared with its limit, also the last lines of
standard error. Exits non-zero, printing no result, without enough cards
or when JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional, Tuple

#: top-level module names the benchmark's process may not hold
FORBIDDEN = ("jax", "jaxlib", "flax", "traceweaver_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({name for name in list(sys.modules)
                   if name.split(".", 1)[0] in FORBIDDEN})


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_metrics(metrics: List[Dict], reading: Dict) -> Dict[str, Dict]:
    from twbench import spec

    out = {}
    for m in metrics:
        value = spec.reader(m["name"])(reading)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(trace: Dict, top: int = 10) -> Dict:
    """The device operations that took most time in the traced window (by
    name, summed), and its longest idle gaps, each named by the innermost
    ``tw:*`` host range open at its midpoint."""
    ops = sorted(trace["by_name"].items(), key=lambda kv: -kv[1][0])[:top]
    gaps = trace["timeline"]["longest_gaps"][:top]
    return dict(device_ops=[[name[:160], us * 1e-6] for name, (us, _) in ops],
                idle_gaps=[[g["host_range"], g["dur"] * 1e-6] for g in gaps])


def judge(checks: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict]:
    """Each compared number beside its limit (``limit``: at most;
    ``at_least``: at least), and whether every one holds."""
    table, ok = {}, True
    for k, lim in limits.items():
        table[k] = {"value": checks[k], **lim}
        if "at_least" in lim:
            ok = ok and checks[k] >= lim["at_least"]
        else:
            ok = ok and checks[k] <= lim["limit"]
    return ok, table


def main(argv: Optional[List[str]] = None) -> int:
    t_start = time.perf_counter()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from twbench import harness, roofline, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        _log(f"[twbench] {args.workload} needs {cell.chips} CUDA card(s); "
             f"available: {torch.cuda.is_available()}, "
             f"count: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    # the reference is plain f32: no TF32 in any product
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = dict(name=torch.cuda.get_device_name(0),
                power_limit_w=roofline.nvidia_smi("power.limit"))
    _log(f"[twbench] {args.workload} seed {args.seed} on {card['name']}, "
         f"power limit {card['power_limit_w']} W")
    reading = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                               device="cuda", t_start=t_start, log=_log)
    reading["exp_rate"], card["sm_clock_max_mhz"] = roofline.exp_rate()
    card["exp_per_s"] = reading["exp_rate"]

    metrics = read_metrics(cell.per_layer if args.trace else cell.end_to_end, reading)
    correct, table = judge(reading["checks"], spec.limits(cell.config))
    device = {"platform": "gpu", "kind": card["name"], "count": cell.chips,
              "memory_peak_bytes": reading["peak_bytes"]}
    result = {"correct": correct,
              "attempted": (len(reading["rounds"]) + reading.get("traced_rounds", 0))
              * reading["services"],
              "failed": reading["failed"], "metrics": metrics, "device": device}
    if args.trace:
        tl = reading["trace"]["timeline"]
        device["busy_s"] = tl["device_busy"] * 1e-6
        device["window_s"] = tl["wall"] * 1e-6
        result["breakdown"] = breakdown(reading["trace"])
        _log(f"[twbench] traced window: {reading['traced_rounds']} rounds, the median "
             f"round {reading['trace']['slowdown']:.3f} x the untraced window's; "
             f"idle {100.0 * tl['idle_share']:.2f}%")
    result["card"] = card
    result["checks"] = table

    found = forbidden_modules()
    if found:
        _log(f"[twbench] the process holds forbidden modules: {found}")
        return 4
    _log(f"[twbench] rounds {len(reading['rounds'])}, window {reading['window_s']:.3f} s, "
         f"check {reading['check_s']:.1f} s, kernel builds in the window "
         f"{reading['builds_in_window']}, detail {reading['check_detail']}")
    for name, row in table.items():
        bound = (f"at least {row['at_least']!r}" if "at_least" in row
                 else f"limit {row['limit']!r}")
        _log(f"[twbench] check {name} {row['value']!r} {bound}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
