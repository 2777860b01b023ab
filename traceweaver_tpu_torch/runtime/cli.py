"""The command line of the port (mirrors ``traceweaver_tpu/runtime/cli.py``,
its batch path and its ``events``, ``query`` and ``scorecard``
subcommands).

The JAX CLI's 17 batch flags, so the ``exps/exp*`` argument lists run
unchanged, plus the flags that stand for the JAX CLI's environment
knobs (the port reads none): ``--device`` (default: the card; ``cpu``
runs slots 8-10 on the CPU), ``--precision`` (``TW_PRECISION``: ``f32``
or ``bf16`` score blocks), ``--score_gemm`` (``TW_SCORE_GEMM``: the GEMM
score form), ``--gt_free_dag`` (``TW_GT_FREE_DAG``),
``--metrics_port`` (``TW_METRICS_PORT``: a ``/metrics`` exporter on
loopback while the run lasts; 0 binds a free port) and ``--events``
(``TW_EVENTS``: the JSONL event sink)::

    python -m traceweaver_tpu_torch.runtime.cli \
        --absolute_path DATA/call_graph_0 --fix 5 --cache_rate 0 \
        --compress_factor 15000 --results_directory out/ \
        --predictor_indices 3,4,7,10 [--device cpu] [--gt_free_dag 1] \
        [--precision bf16] [--score_gemm 1] [--metrics_port 0] \
        [--events run.jsonl]
    python -m traceweaver_tpu_torch.runtime.cli events run.jsonl
    python -m traceweaver_tpu_torch.runtime.cli query out/e2e_....pickle
    python -m traceweaver_tpu_torch.runtime.cli scorecard --traces 32

With no card and no ``--device`` the batch run exits non-zero before
loading anything.
"""

from __future__ import annotations

import argparse
import os
import sys


def get_project_root() -> str:
    """The directory that holds the package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Map incoming and outgoing spans at each service.")
    p.add_argument("--relative_path", type=ascii, default=None,
                   help="relative location for directory with Jaeger-style spans")
    p.add_argument("--absolute_path", type=ascii, default=None,
                   help="absolute location for directory with Jaeger-style spans")
    p.add_argument("--compressed", type=int, default=0, choices=[0, 1],
                   help="is directory compressed?")
    p.add_argument("--load_level", type=int, default=0,
                   help="provide load level if static test")
    p.add_argument("--test_name", type=ascii, default="test",
                   help="custom name for tracing test")
    p.add_argument("--parallel", type=int, default=0, choices=[0, 1],
                   help="treat sibling relationships as parallel?")
    p.add_argument("--instrumented", type=int, default=0, choices=[0, 1],
                   help="treat some hops as instrumented?")
    p.add_argument("--cache_rate", type=float, required=True, default=0,
                   help="rate of artificial caching to apply if needed")
    p.add_argument("--fix", type=int, required=True, default=0,
                   help="do spans require format fixing?")
    p.add_argument("--repeat_factor", type=int, default=1,
                   help="factor by which spans are duplicated")
    p.add_argument("--compress_factor", type=float, default=1,
                   help="factor by which to reduce spacing between spans")
    p.add_argument("--execute_parallel", type=int, default=1,
                   help="run each service's reconstruction in parallel?")
    p.add_argument("--results_directory", type=ascii, required=True,
                   help="directory to store results")
    p.add_argument("--clear_cache", type=int, default=0,
                   help="clear cache of processed, time-ordered file names")
    p.add_argument("--predictor_indices", type=str, default="",
                   help="comma-separated list of algorithm indices to run")
    p.add_argument("--max_traces", type=int, default=1000,
                   help="trace ingestion cap (reference hardcodes 1000)")
    p.add_argument("--strict", type=int, default=0, choices=[0, 1],
                   help="malformed span records raise instead of the "
                        "default skip-and-count dead-letter behavior")
    p.add_argument("--gt_free_dag", type=int, default=0, choices=[0, 1],
                   help="discover each service's invocation DAG without "
                        "ground truth (the JAX CLI's TW_GT_FREE_DAG=1)")
    p.add_argument("--precision", default="f32",
                   help="score-block precision of predictors 8-10: f32 or bf16 "
                        "(the JAX CLI's TW_PRECISION)")
    p.add_argument("--score_gemm", type=int, default=0, choices=[0, 1],
                   help="build the scores in the GEMM form (the JAX CLI's "
                        "TW_SCORE_GEMM=1)")
    p.add_argument("--device", default=None,
                   help="device of predictors 8-10 (default: the CUDA card; "
                        "'cpu' runs their plain versions on the CPU)")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics on 127.0.0.1 at this port while the "
                        "run lasts (0: a free port; the JAX CLI's "
                        "TW_METRICS_PORT)")
    p.add_argument("--events", default=None,
                   help="append fault-ladder and injected-fault records to "
                        "this JSONL file (the JAX CLI's TW_EVENTS)")
    return p


def find_replica_table(data_path: str, root: str):
    """``service_to_replica_new.pickle``: ``<root>/data/misc`` first (the
    reference's location), then ``<dataset>/../misc`` (the synthesizer's
    ``--out`` layout), then ``<dataset>/../../../misc`` (the reference
    layout ``<data_root>/alibaba_microservices/call_graph_data/call_graph_N``)."""
    from traceweaver_tpu_torch.runtime.executor import load_replica_table

    here = os.path.abspath(data_path.rstrip("/"))
    d1 = os.path.dirname(here)
    d3 = os.path.dirname(os.path.dirname(d1))
    for misc in (os.path.join(root, "data", "misc"), os.path.join(d1, "misc"),
                 os.path.join(d3, "misc")):
        table = load_replica_table(os.path.join(misc, "service_to_replica_new.pickle"))
        if table is not None:
            return table
    return None


def _obs_setup(metrics_port, events_path):
    """The run's observability: a ``/metrics`` exporter on loopback
    (``metrics_port``; 0 binds a free port, printed on stderr) and the
    process-wide event sink (``events_path``). Returns ``(exporter,
    event_log)`` for :func:`_obs_finish`."""
    from traceweaver_tpu_torch.obs import events as obs_events

    exporter = None
    if metrics_port is not None:
        from traceweaver_tpu_torch.obs import profile as obs_profile
        from traceweaver_tpu_torch.obs.exposition import start_metrics_server

        exporter = start_metrics_server(
            metrics_port, extra_fn=obs_profile.device_memory_families)
        print(f"[obs] /metrics on http://127.0.0.1:{exporter.port}",
              file=sys.stderr)
    log = None
    if events_path:
        log = obs_events.EventLog(events_path)
        obs_events.install(log)
    return exporter, log


def _obs_finish(exporter, log) -> None:
    """Stop what :func:`_obs_setup` started: the exporter serves until
    the run's end, and the event sink is uninstalled and closed."""
    from traceweaver_tpu_torch.obs import events as obs_events

    if log is not None:
        if obs_events.active() is log:
            obs_events.install(None)
        log.close()
    if exporter is not None:
        exporter.shutdown()
        exporter.server_close()


#: subcommand -> (module, function) run with the remaining arguments
SUBCOMMANDS = {
    "events": ("traceweaver_tpu_torch.obs.events", "tail_main"),
    "query": ("traceweaver_tpu_torch.query.delay_culprit", "main"),
    "scorecard": ("traceweaver_tpu_torch.metrics.scorecard", "main"),
}


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv and argv[0] in SUBCOMMANDS:
        import importlib

        module, func = SUBCOMMANDS[argv[0]]
        return getattr(importlib.import_module(module), func)(argv[1:])
    args = build_parser().parse_args(argv)
    if args.relative_path is None and args.absolute_path is None:
        print("At least one of --relative_path and --absolute_path is required",
              file=sys.stderr)
        return 2

    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device
    from traceweaver_tpu_torch.ops.precision import validate_precision
    from traceweaver_tpu_torch.runtime.executor import ExecutorConfig, run_experiment

    try:
        precision = validate_precision(args.precision)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    try:
        device = str(resolve_device(args.device))
    except RuntimeError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    root = get_project_root()
    if args.absolute_path:
        data_path = args.absolute_path.strip("'")
    else:
        rel = args.relative_path.strip("'")
        data_path = rel if os.path.isdir(rel) else os.path.join(root, rel)

    try:
        indices = [int(x) for x in args.predictor_indices.split(",") if x != ""]
    except ValueError as e:
        print(f"Error converting predictor indices: {e}", file=sys.stderr)
        return 1

    cfg = ExecutorConfig(
        data_path=data_path,
        results_directory=args.results_directory.strip("'"),
        fix=args.fix,
        cache_rate=args.cache_rate,
        load_level=args.load_level,
        test_name=args.test_name.strip("'"),
        parallel=bool(args.parallel),
        instrumented=bool(args.instrumented),
        repeat_factor=args.repeat_factor,
        compress_factor=args.compress_factor,
        execute_parallel=bool(args.execute_parallel),
        clear_cache=bool(args.clear_cache),
        compressed=bool(args.compressed),
        predictor_indices=indices,
        max_traces=args.max_traces,
        strict_ingest=bool(args.strict),
        service_to_replica=find_replica_table(data_path, root),
        device=device,
        gt_free_dag=bool(args.gt_free_dag),
        precision=precision,
        score_gemm=bool(args.score_gemm),
    )
    exporter, log = _obs_setup(args.metrics_port, args.events)
    try:
        run_experiment(cfg)  # prints per-method accuracy as it goes
    finally:
        _obs_finish(exporter, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
