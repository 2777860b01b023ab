"""exp5's compress ladder through the port (mirrors
``exps/exp5/run_experiment.sh`` and ``exps/exp5/run_experiment_hard.sh``).

The shell scripts run the JAX CLI over 15 Alibaba call graphs at
compress 1, 200, 1000, 4000, 10000 and 15000 (fix 5, predictors
3,4,7,10, test name ``alibaba_cg_<n>_load_multiple``), then draw fig6a
and fig6b with ``utils/plot_accuracy_vs_load_multiple_cgs.py`` and
``utils/plot_accuracy_vs_confidence_multiple_cgs.py``. This runner does
the same with the port's CLI::

    python -m traceweaver_tpu_torch.runtime.ladder --data DATA/call_graph_data \\
        --out OUT [--messy] [--device cpu] [--graphs 0,4] [--rungs 1,15000]

- ``--data`` holds ``call_graph_<n>`` (and ``misc/`` beside them, the
  synthesizer's layout); where it holds no ``call_graph_0`` the port's
  synthesizer writes exp5's corpus there first (15 graphs x 1000 traces,
  seed 10; ``--messy`` the hard corpus, ``MESSY_DEFAULT``), so no
  clusterdata is needed.
- The calls run one after another in this process: the shell scripts'
  background ``&`` would make them share the one card.
- Every pickle and both figures (``fig6a.pdf``, ``fig6b.pdf``; with
  ``--messy`` ``fig6a_hard.pdf``, ``fig6b_hard.pdf``) go to ``--out``;
  the plot scripts run unchanged, as subprocesses. ``ladder.json`` there
  holds each call's wall seconds and end-to-end accuracy per method.
- ``--figures 0`` leaves the figures out (the plot scripts need
  matplotlib, which a machine may lack); ``--plot_only`` draws them
  from the pickles already in ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

RUNGS = (1, 200, 1000, 4000, 10000, 15000)
N_GRAPHS = 15
PREDICTORS = "3,4,7,10"
SUFFIX = "load_multiple"
PLOTS = (("plot_accuracy_vs_load_multiple_cgs.py", "fig6a"),
         ("plot_accuracy_vs_confidence_multiple_cgs.py", "fig6b"))


def call_argv(graph_dir: str, n: int, out: str, compress: int,
              extra: Sequence[str] = ()) -> List[str]:
    """One call's CLI arguments, as ``exps/common.sh run_executor`` passes
    them for exp5 (load level 1, repeat 1, cache rate 0, no thread pool)."""
    return ["--absolute_path", graph_dir, "--compressed", "0", "--cache_rate", "0",
            "--fix", "5", "--test_name", f"alibaba_cg_{n}_{SUFFIX}",
            "--load_level", "1", "--compress_factor", str(compress),
            "--repeat_factor", "1", "--execute_parallel", "0",
            "--results_directory", out, "--clear_cache", "0",
            "--predictor_indices", PREDICTORS, *extra]


def accuracy_pickle(out: str, n: int, compress: int) -> str:
    """The accuracy pickle of graph ``n`` at ``compress`` (the name the
    plot scripts read)."""
    return os.path.join(out, f"accuracy_alibaba_cg_{n}_{SUFFIX}_1_{compress}_1_0.0.pickle")


def ensure_corpus(data: str, messy: bool, n_graphs: int = N_GRAPHS,
                  traces_per_graph: int = 1000) -> List[str]:
    """The graph directories under ``data``, synthesized first (seed 10)
    when ``call_graph_0`` is absent."""
    if not os.path.isdir(os.path.join(data, "call_graph_0")):
        from traceweaver_tpu_torch.alibaba.synthesize import (
            MESSY_DEFAULT,
            synthesize_corpus,
        )

        synthesize_corpus(data, n_graphs=n_graphs, traces_per_graph=traces_per_graph,
                          seed=10, messy=MESSY_DEFAULT if messy else None)
    return [os.path.join(data, f"call_graph_{n}") for n in range(n_graphs)
            if os.path.isdir(os.path.join(data, f"call_graph_{n}"))]


def _cli_call(argv: List[str]) -> None:
    from traceweaver_tpu_torch.runtime import cli

    rc = cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"cli {argv} exited {rc}")


def plot(out: str, messy: bool, root: Optional[str] = None) -> List[str]:
    """Both figures from the pickles in ``out`` by the unchanged plot
    scripts; returns the PDFs' paths."""
    from traceweaver_tpu_torch.runtime.cli import get_project_root

    utils = os.path.join(root or get_project_root(), "utils")
    out_dir = os.path.join(os.path.abspath(out), "")
    pdfs = []
    for script, fig in PLOTS:
        pdf = os.path.join(out_dir, f"{fig}{'_hard' if messy else ''}.pdf")
        proc = subprocess.run([sys.executable, os.path.join(utils, script), out_dir,
                               SUFFIX, pdf], capture_output=True, text=True,
                              env={**os.environ, "MPLBACKEND": "Agg"})
        if proc.returncode != 0 or not os.path.exists(pdf):
            raise RuntimeError(f"{script} failed ({proc.returncode}):\n{proc.stderr}")
        pdfs.append(pdf)
    return pdfs


def run_ladder(data: str, out: str, *, messy: bool = False,
               graphs: Optional[Sequence[int]] = None,
               rungs: Sequence[int] = RUNGS, extra: Sequence[str] = (),
               call: Callable[[List[str]], None] = _cli_call,
               draw: bool = True) -> List[Dict]:
    """Every rung over every graph (rung by rung, as the shell scripts),
    then the figures. ``call`` runs one CLI call (default: the port's
    CLI in this process). Returns one record a call: graph, compress,
    wall seconds and end-to-end accuracy per method."""
    dirs = ensure_corpus(data, messy)
    os.makedirs(out, exist_ok=True)
    records = []
    for compress in rungs:
        for n, d in enumerate(dirs):
            if graphs is not None and n not in graphs:
                continue
            t0 = time.perf_counter()
            call(call_argv(d, n, out, compress, extra))
            wall = time.perf_counter() - t0
            with open(accuracy_pickle(out, n, compress), "rb") as f:
                acc = pickle.load(f)
            records.append(dict(graph=os.path.basename(d), compress=compress,
                                wall_s=wall, accuracy=acc))
    with open(os.path.join(out, "ladder.json"), "w") as f:
        json.dump(records, f, indent=1)
    if draw:
        plot(out, messy)
    return records


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="exp5's compress ladder through the port")
    p.add_argument("--data", required=True,
                   help="call_graph_data directory (synthesized when empty)")
    p.add_argument("--out", required=True, help="directory of the pickles and figures")
    p.add_argument("--messy", action="store_true",
                   help="the hard corpus (run_experiment_hard.sh)")
    p.add_argument("--device", default=None, help="'cpu', or the card by default")
    p.add_argument("--graphs", default=None, help="comma-separated graph numbers")
    p.add_argument("--rungs", default=None, help="comma-separated compress factors")
    p.add_argument("--figures", type=int, default=1, choices=[0, 1],
                   help="draw fig6a/fig6b after the calls")
    p.add_argument("--plot_only", action="store_true",
                   help="only draw the figures from the pickles in --out")
    args = p.parse_args(argv)
    if args.plot_only:
        for pdf in plot(args.out, args.messy):
            print(pdf)
        return 0
    extra = ["--device", args.device] if args.device else []
    graphs = None if args.graphs is None else [int(g) for g in args.graphs.split(",")]
    rungs = RUNGS if args.rungs is None else [int(r) for r in args.rungs.split(",")]
    records = run_ladder(args.data, args.out, messy=args.messy, graphs=graphs,
                         rungs=rungs, extra=extra, draw=bool(args.figures))
    for r in records:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
