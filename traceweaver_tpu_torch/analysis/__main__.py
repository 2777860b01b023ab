"""``python -m traceweaver_tpu_torch.analysis`` — the port's lint CLI
(mirrors ``traceweaver_tpu/analysis/__main__.py``).

Exit status: 0 = clean (suppressed and baselined findings don't count),
1 = live findings, 2 = bad invocation or malformed baseline.
"""

from __future__ import annotations

import argparse
import sys

from traceweaver_tpu_torch.analysis import engine
from traceweaver_tpu_torch.analysis.rules import RULE_CLASSES


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.analysis",
        description="static analysis of the PyTorch port's ground rules and "
                    "its host-sync, lock, precision and launch contracts")
    p.add_argument("paths", nargs="*",
                   help="files/directories to scan, relative to the root "
                        "(default: traceweaver_tpu_torch/ and chip_smoke.py)")
    p.add_argument("--root", default=engine.REPO_ROOT,
                   help="repository root (default: the one holding the "
                        "package)")
    p.add_argument("--baseline", default=engine.DEFAULT_BASELINE,
                   help="baseline file of grandfathered findings")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline (report everything)")
    p.add_argument("--write-baseline", action="store_true",
                   help="print a baseline covering the current findings "
                        "to stdout (justifications left TODO) and exit 0")
    p.add_argument("--list-rules", action="store_true",
                   help="print the rule catalog and exit")
    return p


def main(argv=None) -> int:
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.list_rules:
        for cls in RULE_CLASSES:
            print(f"{cls.id}  {cls.title}")
        return 0
    baseline = None if args.no_baseline or args.write_baseline \
        else args.baseline
    try:
        report = engine.run(root=args.root, paths=args.paths or None,
                            baseline_path=baseline)
    except engine.BaselineError as e:
        print(f"{engine.TAG}: {e}", file=sys.stderr)
        return 2
    if args.write_baseline:
        sys.stdout.write(engine.format_baseline(report.findings))
        return 0
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
