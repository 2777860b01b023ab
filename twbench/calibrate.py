"""Readings that the limits of ``twbench/limits/`` are set from, many seeds
in one process (the benchmark's own runs never run this):

    python3 -m twbench.calibrate --workload CELL --seeds 1,2,3 \
        [--modes sound,control,stale,half,answer] [--seconds 2]

``sound`` runs the program as the configuration states; ``control`` with
its bf16 score path, and the reference's bf16 refit in place of its
refit; the other modes with a fault planted
(:mod:`twbench.faults`). Each seed's corpus is built once and every mode
runs on it from a fresh plan cache (a cold round, warm-up, the window and
the check). Prints one JSON line a seed and mode with every compared
number, the window's end-to-end metrics and the check's seconds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--modes", default="sound")
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)

    import torch

    from twbench import faults, harness, spec

    if not torch.cuda.is_available():
        print("[twbench] no CUDA card", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in ("sound", "control") + faults.FAULTS]
    if bad:
        p.error(f"unknown mode(s) {bad}")
    cell = spec.load_cell(args.workload)

    def log(s):
        print(s, file=sys.stderr, flush=True)

    for seed in (int(s) for s in args.seeds.split(",")):
        dep = harness.build_deployment(cell, seed, torch.device("cuda"), log)
        for mode in modes:
            t0 = time.perf_counter()
            plant = (faults.planted(mode) if mode in faults.FAULTS
                     else contextlib.nullcontext())
            with plant:
                r = harness.run_cell(cell, seed, args.seconds, False, device="cuda",
                                     t_start=t0, solve_kw=faults.solve_kw(mode), log=log,
                                     dep=dep, fit_control=mode == "control")
            print(json.dumps(dict(
                workload=args.workload, mode=mode, seed=seed, checks=r["checks"],
                detail=r["check_detail"], spans_per_s=r["spans_per_s"],
                accuracy_pct=r["accuracy_pct"], rounds=len(r["rounds"]),
                check_s=r["check_s"], peak_bytes=r["peak_bytes"],
                wall_s=time.perf_counter() - t0)), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
