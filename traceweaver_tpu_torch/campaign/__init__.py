"""Campaign harness: the Alibaba-scale sustained-throughput load test
(mirrors ``traceweaver_tpu/campaign``).

``cli campaign run|compare|report`` turns the throughput claim into a
durable, regression-gated load test:

- :mod:`~traceweaver_tpu_torch.campaign.corpus`: the 100k to 1M-span
  corpus ladder (the deterministic synthesizer ladder), cached, with a
  per-rung regime-mix manifest;
- :mod:`~traceweaver_tpu_torch.campaign.plan`: the declarative campaign
  spec (rung ladder x device topology x knob profile);
- :mod:`~traceweaver_tpu_torch.campaign.runner`: the fleet driven across
  the mesh, warm-up until no kernel builds, timed steady-state rounds,
  and the multislice allreduce tier;
- :mod:`~traceweaver_tpu_torch.campaign.ledger`: the ``CAMPAIGN_*.json``
  artifact, the ``tw_campaign_*`` ``/metrics`` mirror and the
  ``kind="campaign"`` events;
- :mod:`~traceweaver_tpu_torch.campaign.compare`: the regression gate
  between two artifacts.

The artifact has the JAX package's shape, so either package's
``compare`` reads the other's. The wire campaign of the replica fleet
(:mod:`traceweaver_tpu_torch.fleet_serve.campaign`) writes its artifact
through the same ledger. Importing this package loads no torch; ``run``
does, when it starts.

``run`` takes ``--plan``, ``--mini``, ``--devices``, ``--slices``,
``--rounds``, ``--warmup_max``, ``--cache`` (the JAX package's
``TW_CAMPAIGN_CACHE``), ``--out`` and ``--device`` (default: the card;
without one and without ``--device cpu`` it exits 2 before it loads
anything). ``compare`` takes ``--tol-pct`` and ``--tol-acc``
(``TW_CAMPAIGN_TOL_PCT``, ``TW_CAMPAIGN_TOL_ACC``).
"""

from __future__ import annotations

import sys
from typing import List, Optional

from traceweaver_tpu_torch.campaign.compare import (  # noqa: F401
    TOL_ACC,
    TOL_PCT,
    compare_artifacts,
    compare_paths,
    format_compare,
    format_report,
)
from traceweaver_tpu_torch.campaign.corpus import build_rung  # noqa: F401
from traceweaver_tpu_torch.campaign.ledger import (  # noqa: F401
    load_artifact,
    write_artifact,
)
from traceweaver_tpu_torch.campaign.plan import (  # noqa: F401
    CampaignPlan,
    PlanError,
    RungSpec,
    alibaba_ladder,
    from_dict,
    load_plan,
    mini_plan,
)
from traceweaver_tpu_torch.campaign.runner import run_campaign  # noqa: F401

PROG = "python -m traceweaver_tpu_torch.runtime.cli campaign"


def _build_run_parser():
    import argparse

    p = argparse.ArgumentParser(
        prog=f"{PROG} run",
        description="Run a sustained-throughput campaign over the Alibaba "
                    "corpus ladder.")
    p.add_argument("--plan", default=None,
                   help="campaign plan JSON (default: the built-in alibaba "
                        "ladder; --mini for the two-rung smoke)")
    p.add_argument("--mini", action="store_true",
                   help="run the built-in two-rung synthetic mini campaign")
    p.add_argument("--out", default=None,
                   help="write the CAMPAIGN_*.json artifact here")
    p.add_argument("--devices", type=int, default=None,
                   help="override the plan's mesh size (0/1 = one device; "
                        ">= 2, a power of two, shards the fleet)")
    p.add_argument("--slices", type=int, default=None,
                   help="override the plan's multislice tier count")
    p.add_argument("--rounds", type=int, default=None,
                   help="override the timed steady-state rounds (default 3)")
    p.add_argument("--warmup_max", type=int, default=None,
                   help="override the warm-up round cap (default 5)")
    p.add_argument("--cache", default=None,
                   help="corpus cache root (default: .campaign_corpus next "
                        "to --out)")
    p.add_argument("--device", default=None,
                   help="device of the solves (default: the CUDA card; 'cpu' "
                        "runs them on the CPU, a mesh there being CPU shards)")
    return p


def _run_main(argv: List[str]) -> int:
    """``campaign run``: the device and the plan are checked, and the
    mesh built, before any corpus is made or loaded."""
    args = _build_run_parser().parse_args(argv)
    try:
        if args.plan:
            plan = load_plan(args.plan)
        elif args.mini:
            plan = mini_plan()
        else:
            plan = alibaba_ladder()
        if args.devices is not None:
            plan.devices = args.devices
        if args.slices is not None:
            plan.slices = args.slices
        if args.rounds is not None:
            plan.timed_rounds = args.rounds
        if args.warmup_max is not None:
            plan.warmup_max = args.warmup_max
        plan.validate()
    except (PlanError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device
    from traceweaver_tpu_torch.campaign.runner import plan_mesh

    try:
        device = resolve_device(args.device)
        plan_mesh(plan, device)
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    run_campaign(plan, out_path=args.out, cache_root=args.cache, print_fn=print,
                 device=device)
    return 0


def _compare_main(argv: List[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(
        prog=f"{PROG} compare",
        description="Regression-gate one campaign artifact against a baseline "
                    "(exit 1 on regression).")
    p.add_argument("baseline")
    p.add_argument("candidate")
    p.add_argument("--tol-pct", type=float, default=TOL_PCT,
                   help="allowed throughput drop, percent (default %(default)s)")
    p.add_argument("--tol-acc", type=float, default=TOL_ACC,
                   help="allowed accuracy drop, points (default %(default)s)")
    args = p.parse_args(argv)
    result = compare_paths(args.baseline, args.candidate, tol_pct=args.tol_pct,
                           tol_acc=args.tol_acc)
    print(format_compare(result))
    return 0 if result["ok"] else 1


def _report_main(argv: List[str]) -> int:
    import argparse

    p = argparse.ArgumentParser(prog=f"{PROG} report",
                                description="Render one campaign artifact as a table.")
    p.add_argument("artifact")
    args = p.parse_args(argv)
    print(format_report(load_artifact(args.artifact)))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """``cli campaign <run|compare|report>``. ``compare`` and ``report``
    are host analytics and load no torch."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] not in ("run", "compare", "report"):
        print(f"usage: {PROG} {{run|compare|report}} ...", file=sys.stderr)
        return 2
    sub, rest = argv[0], argv[1:]
    if sub == "run":
        return _run_main(rest)
    if sub == "compare":
        return _compare_main(rest)
    return _report_main(rest)
