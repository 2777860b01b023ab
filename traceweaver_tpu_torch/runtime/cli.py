"""The command line of the port (mirrors ``traceweaver_tpu/runtime/cli.py``,
its batch path and its ``stream``, ``serve``, ``fleet``, ``campaign``,
``events``, ``query``, ``scorecard`` and ``lint`` subcommands).

The JAX CLI's 17 batch flags, so the ``exps/exp*`` argument lists run
unchanged, plus the flags that stand for the JAX CLI's environment
knobs (the port reads none): ``--device`` (default: the card; ``cpu``
runs slots 8-10 on the CPU), ``--precision`` (``TW_PRECISION``: ``f32``
or ``bf16`` score blocks), ``--score_gemm`` (``TW_SCORE_GEMM``: the GEMM
score form), ``--gt_free_dag`` (``TW_GT_FREE_DAG``),
``--mesh_devices`` (``TW_MESH_DEVICES``: 0, or a power of two; the
window batches of slots 8-10 shard over the first N cards, or over N CPU
shards with ``--device cpu``; a bad value, or more cards than the
machine has, exits 2 before any data loads), ``--metrics_port``
(``TW_METRICS_PORT``: a ``/metrics`` exporter on loopback while the run
lasts; 0 binds a free port) and ``--events`` (``TW_EVENTS``: the JSONL
event sink)::

    python -m traceweaver_tpu_torch.runtime.cli \
        --absolute_path DATA/call_graph_0 --fix 5 --cache_rate 0 \
        --compress_factor 15000 --results_directory out/ \
        --predictor_indices 3,4,7,10 [--device cpu] [--gt_free_dag 1] \
        [--precision bf16] [--score_gemm 1] [--metrics_port 0] \
        [--events run.jsonl]
    python -m traceweaver_tpu_torch.runtime.cli stream \
        --source 'replay:DATA/call_graph_0?fix=5&ooo_ms=50' --window_s 20 \
        --overlap_s 4 --out traces.jsonl [--checkpoint ck.pkl] \
        [--compare_batch] [--device cpu] [--precision bf16] \
        [--selftrace journey.json]
    python -m traceweaver_tpu_torch.runtime.cli stream \
        --source collector:CAPTURE_DIR --window_s 20 --overlap_s 4 \
        [--faults skew:1.0:max=1 --faults_seed 1]
    python -m traceweaver_tpu_torch.runtime.cli stream \
        --source 'synth:adapt-burst?n_bursts=60&shift_at=30' --window_s 1 \
        --overlap_s 0 --watermark_s 0.001 --conf_drift_window 64 --adapt
    python -m traceweaver_tpu_torch.runtime.cli serve --port 8321 \
        --state-dir state/ [--resume] [--no-continuous] [--device cpu] \
        [--adapt]
    python -m traceweaver_tpu_torch.runtime.cli fleet serve --replicas 2 \
        --port 8320 --state-dir fleet/ [-- --fix 2 --device cpu]
    python -m traceweaver_tpu_torch.runtime.cli fleet campaign --replicas 1,2 \
        --seconds 6 --state-dir campaign/ [--mode inproc] [--device cpu] \
        [--out CAMPAIGN_fleet.json]
    python -m traceweaver_tpu_torch.runtime.cli campaign run --mini \
        [--devices 2] [--slices 2] [--device cpu] [--out CAMPAIGN.json]
    python -m traceweaver_tpu_torch.runtime.cli campaign compare BASE CAND
    python -m traceweaver_tpu_torch.runtime.cli campaign report CAMPAIGN.json
    python -m traceweaver_tpu_torch.runtime.cli events run.jsonl
    python -m traceweaver_tpu_torch.runtime.cli query out/e2e_....pickle
    python -m traceweaver_tpu_torch.runtime.cli scorecard --traces 32
    python -m traceweaver_tpu_torch.runtime.cli lint [--list-rules]

With no card and no ``--device`` the batch run, ``stream``, ``serve``
and ``campaign run`` exit non-zero before loading anything (and so do ``fleet``'s
replicas: ``fleet serve`` exits 1, passing ``--device`` to its replicas
after ``--``). ``serve`` prints
``[serve] listening on http://HOST:PORT`` once bound (``--port 0`` binds
a free port) and drains on SIGTERM or SIGINT; the JAX CLI's persistent
XLA cache and AOT warmup have no counterpart. ``stream``'s ``--selftrace PATH``
(the JAX CLI's ``TW_SELFTRACE``) writes the windows' own journeys as
Jaeger JSON when the stream drains. ``stream``'s and ``serve``'s
``--adapt`` (``TW_ADAPT``) arms the drift-to-adapt ladder, with
``--adapt_cooldown_s``, ``--adapt_probation``, ``--adapt_low_rate`` and
``--conf_drift_window`` for its knobs; ``stream``'s ``--faults`` and
``--faults_seed`` (``TW_FAULTS``, ``TW_FAULTS_SEED``) put a fault plan in
force for the run (the ``capture`` and ``skew`` sites act on a
``collector:`` source).
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
    p.add_argument("--mesh_devices", type=int, default=0,
                   help="shard the window batches of predictors 8-10 over a "
                        "mesh of this many devices: 0 (one device) or a power "
                        "of two; the first N cards, or N CPU shards with "
                        "--device cpu (the JAX CLI's TW_MESH_DEVICES)")
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


def _obs_setup(metrics_port, events_path, selftrace_path=None):
    """The run's observability: a ``/metrics`` exporter on loopback
    (``metrics_port``; 0 binds a free port, printed on stderr), the
    process-wide event sink (``events_path``) and, with
    ``selftrace_path``, an installed self-tracer. Returns ``(exporter,
    event_log, tracer)`` for :func:`_obs_finish`."""
    from traceweaver_tpu_torch.obs import events as obs_events
    from traceweaver_tpu_torch.obs import selftrace as obs_selftrace

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
    tracer = None
    if selftrace_path:
        tracer = obs_selftrace.PipelineTracer()
        obs_selftrace.install(tracer)
    return exporter, log, tracer


def _obs_finish(exporter, log, tracer=None, selftrace_path=None) -> None:
    """Stop what :func:`_obs_setup` started: the exporter serves until
    the run's end, the event sink is uninstalled and closed, and the
    self-tracer is uninstalled after its payload is written (it loads
    back with ``--fix 6``)."""
    from traceweaver_tpu_torch.obs import events as obs_events
    from traceweaver_tpu_torch.obs import selftrace as obs_selftrace

    if tracer is not None:
        if obs_selftrace.active() is tracer:
            obs_selftrace.install(None)
        n = tracer.write(selftrace_path)
        print(f"[obs] self-trace: {n} window journey(s) -> {selftrace_path} "
              "(re-ingest with --fix 6)", file=sys.stderr)

    if log is not None:
        if obs_events.active() is log:
            obs_events.install(None)
        log.close()
    if exporter is not None:
        exporter.shutdown()
        exporter.server_close()


def build_stream_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli stream",
        description="Online windowed reconstruction over a span stream.")
    p.add_argument("--source", required=True,
                   help="source spec: replay:<corpus-dir>"
                        "[?fix=2&max_traces=200&ooo_ms=50&seed=0] replays "
                        "a recorded Jaeger corpus; "
                        "collector:<strace-log|dir|fifo>[?service=name] is "
                        "the capture ingress (strace/eBPF capture -> HTTP/2 "
                        "replay -> skew-corrected spans); "
                        "synth:adapt-burst?n_bursts=N&shift_at=K streams the "
                        "shifted burst corpus")
    p.add_argument("--fix", type=int, default=0,
                   help="dataset FIX mode for replay sources (overridden "
                        "by a ?fix= query in --source)")
    p.add_argument("--max_traces", type=int, default=1000,
                   help="replay trace cap (reference executor hardcap)")
    p.add_argument("--ooo_ms", type=float, default=0.0,
                   help="replay out-of-order arrival jitter (ms)")
    p.add_argument("--window_s", type=float, default=60.0,
                   help="event-time window size (seconds)")
    p.add_argument("--overlap_s", type=float, default=5.0,
                   help="window overlap (seconds)")
    p.add_argument("--watermark_s", type=float, default=2.0,
                   help="watermark out-of-order bound (seconds)")
    p.add_argument("--grace_s", type=float, default=0.0,
                   help="allowed lateness past the watermark (seconds)")
    p.add_argument("--max_pending", type=int, default=4,
                   help="in-flight sealed-window bound (backpressure)")
    p.add_argument("--spill_max", type=int, default=64,
                   help="spill queue bound before windows are dropped")
    p.add_argument("--out", default=None,
                   help="JSONL sink for stitched traces (one window per "
                        "line); omit to only print live stats")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file; pass with --resume to continue "
                        "a killed run without reprocessing/double-emit")
    p.add_argument("--checkpoint_every", type=int, default=8,
                   help="emitted windows between checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="resume from --checkpoint instead of starting over")
    p.add_argument("--deadletter", default=None,
                   help="dead-letter JSONL sidecar for poison windows "
                        "(default: <out>.deadletter.jsonl when --out is set)")
    p.add_argument("--watchdog_s", type=float, default=None,
                   help="micro-batch solve watchdog timeout (seconds); "
                        "a timed-out batch retries, then dead-letters")
    p.add_argument("--slo_p99_ms", type=float, default=None,
                   help="seal-to-emit p99 latency SLO (ms): count and "
                        "event each excursion above it (default off)")
    p.add_argument("--solve_retries", type=int, default=1,
                   help="micro-batch retry budget past the first attempt")
    p.add_argument("--strict", action="store_true",
                   help="malformed span records raise at ingest instead "
                        "of the default skip-and-count")
    p.add_argument("--no_warm", action="store_true",
                   help="disable carried-state warm start (two-pass EM "
                        "per window, the batch executor's shape)")
    p.add_argument("--no_grade", action="store_true",
                   help="disable ground-truth grading")
    p.add_argument("--compare_batch", action="store_true",
                   help="after the stream drains, run the batch executor "
                        "(predictor 10) on the same store and print the "
                        "accuracy delta")
    p.add_argument("--device", default=None,
                   help="device of the solve (default: the CUDA card; 'cpu' "
                        "runs the plain versions on the CPU)")
    p.add_argument("--precision", default="f32",
                   help="score-block precision: f32 or bf16 (the JAX CLI's "
                        "TW_PRECISION)")
    p.add_argument("--metrics_port", type=int, default=None,
                   help="serve /metrics on 127.0.0.1 at this port while the "
                        "stream runs (0: a free port)")
    p.add_argument("--events", default=None,
                   help="append fault-ladder, drift and SLO records to this "
                        "JSONL file")
    p.add_argument("--selftrace", default=None,
                   help="write the windows' own pipeline journeys to this "
                        "Jaeger-JSON file when the stream drains (the JAX "
                        "CLI's TW_SELFTRACE)")
    p.add_argument("--faults", default=None,
                   help="fault plan in force for the run, site:p[:max=N],... "
                        "(TW_FAULTS; the capture sites are capture and skew)")
    p.add_argument("--faults_seed", type=int, default=0,
                   help="the fault plan's RNG seed (TW_FAULTS_SEED)")
    _add_adapt_flags(p)
    return p


def _add_adapt_flags(p: argparse.ArgumentParser) -> None:
    """The drift-to-adapt flags of ``stream`` and ``serve``."""
    from traceweaver_tpu_torch.adapt import controller
    from traceweaver_tpu_torch.obs.quality import DRIFT_WINDOW

    p.add_argument("--adapt", action="store_true",
                   help="arm the drift-to-adapt ladder: refit, then wide-prior "
                        "fallback, with a cooldown (TW_ADAPT; off by default)")
    p.add_argument("--adapt_cooldown_s", type=float,
                   default=controller.ADAPT_COOLDOWN_S,
                   help="hysteresis between a key's actuations (TW_ADAPT_COOLDOWN_S)")
    p.add_argument("--adapt_probation", type=int,
                   default=controller.ADAPT_PROBATION,
                   help="windows a landed refit has to recover (TW_ADAPT_PROBATION)")
    p.add_argument("--adapt_low_rate", type=float,
                   default=controller.ADAPT_LOW_RATE,
                   help="low-confidence share of a window that is an excursion "
                        "(TW_ADAPT_LOW_RATE)")
    p.add_argument("--conf_drift_window", type=int, default=DRIFT_WINDOW,
                   help="the drift watcher's reference and rolling window, in "
                        "spans (TW_CONF_DRIFT_WINDOW)")


def _adapt_controller(args):
    """The stream's controller from the ``--adapt*`` flags (None: off)."""
    if not args.adapt:
        return None
    from traceweaver_tpu_torch.adapt import AdaptationController

    return AdaptationController(low_rate=args.adapt_low_rate,
                                probation=args.adapt_probation,
                                cooldown_s=args.adapt_cooldown_s)


def batch_accuracy(store, fix: int, device, precision: str) -> float:
    """``stream --compare_batch``: the batch executor's flagship
    (predictor 10) on the stream's whole store, end-to-end accuracy in
    percent."""
    from traceweaver_tpu_torch.runtime.executor import ExecutorConfig, run_experiment

    res = run_experiment(ExecutorConfig(
        data_path="", results_directory="", fix=fix, cache_rate=0.0,
        test_name="streamcmp", predictor_indices=[10], device=str(device),
        precision=precision), store=store)
    return res.accuracy_overall["MaxScoreBatchSubsetWithSkips"]


def stream_main(argv) -> int:
    """The ``stream`` subcommand; returns the exit code."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device
    from traceweaver_tpu_torch.ops.precision import validate_precision
    from traceweaver_tpu_torch.runtime import faults
    from traceweaver_tpu_torch.stream import (
        StreamingReconstructor,
        TraceSink,
        parse_source_spec,
    )

    args = build_stream_parser().parse_args(argv)
    try:
        precision = validate_precision(args.precision)
        device = resolve_device(args.device)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.resume and not (args.checkpoint and os.path.exists(args.checkpoint)):
        print(f"--resume: no checkpoint at {args.checkpoint!r}", file=sys.stderr)
        return 2
    try:
        plan = faults.parse_faults(args.faults or "", seed=args.faults_seed)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    # observability comes up before the source is built: a collector:
    # source emits its capture_loss, capture_churn and clock_skew records
    # while it parses the capture
    exporter, log, tracer = _obs_setup(args.metrics_port, args.events,
                                       args.selftrace)
    sink = None
    try:
        with faults.override_plan(plan):
            try:
                source = parse_source_spec(
                    args.source, fix=args.fix, max_traces=args.max_traces,
                    ooo_us=args.ooo_ms * 1000.0, strict=args.strict)
            except ValueError as e:
                print(f"error: {e}", file=sys.stderr)
                return 2
            cfg = _stream_config(args)
            sink = TraceSink(args.out) if args.out else None
            kw = dict(sink=sink, device=device, precision=precision,
                      adapt=_adapt_controller(args),
                      drift_window=args.conf_drift_window)
            if args.resume:
                service = StreamingReconstructor.resume(args.checkpoint, source, **kw)
            else:
                service = StreamingReconstructor(source, cfg, **kw)
            summary = service.run()
    finally:
        if sink is not None:
            sink.close()
        _obs_finish(exporter, log, tracer, args.selftrace)
    _print_stream_summary(summary)
    if "accuracy" in summary:
        streamed_acc = summary["accuracy"]["e2e"]
        print("[stream] streamed end-to-end accuracy: %.3f%%" % streamed_acc)
        if args.compare_batch:
            batch_acc = batch_accuracy(source.store, args.fix, device, precision)
            print("[stream] batch executor on identical input: %.3f%% "
                  "(streamed delta %+.3f pts)" % (batch_acc, streamed_acc - batch_acc))
    return 0


def _stream_config(args):
    from traceweaver_tpu_torch.stream import StreamConfig

    return StreamConfig(
        window_us=args.window_s * 1e6,
        overlap_us=args.overlap_s * 1e6,
        ooo_bound_us=args.watermark_s * 1e6,
        grace_us=args.grace_s * 1e6,
        max_pending=args.max_pending,
        spill_max=args.spill_max,
        warm_start=not args.no_warm,
        grade=not args.no_grade,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        deadletter_path=args.deadletter,
        solve_watchdog_s=args.watchdog_s,
        solve_retries=args.solve_retries,
        slo_p99_ms=args.slo_p99_ms,
    )


def _print_stream_summary(summary) -> None:
    print("[stream] done [%s]: %d events -> %d windows, %d spans emitted, "
          "late %d rerouted / %d dropped, shed %d spilled / %d dropped"
          % (summary["precision"], summary["consumed"],
             summary["emitted_windows"],
             summary["stats"].get("spans_emitted", 0),
             summary["late_rerouted"], summary["late_dropped"],
             summary["shed_spilled"], summary["shed_dropped_windows"]))
    st = summary["stats"]
    print("[stream] %d micro-batches on %s: %d K1 launches, %d assembly "
          "launches; solve %.3f s, emit %.3f s, checkpoint %.3f s"
          % (int(st.get("micro_batches", 0)), summary["device"],
             summary["launches"]["fused_assign"],
             summary["launches"]["assemble_block"], st.get("solve_s", 0.0),
             st.get("emit_s", 0.0), st.get("checkpoint_s", 0.0)))
    fl = summary["faults"]
    if any(fl.values()) or summary["deadletter_windows"]:
        print("[stream] faults: %d injected, %d retries, %d bisections, "
              "%d host fallbacks, %d quarantined; %d solve timeouts / %d "
              "batch retries; %d checkpoint failures / %d recovered; "
              "dead-letter %d windows (%d spans, %d bytes)"
              % (fl["injected"], fl["retries"], fl["bisections"],
                 fl["host_fallbacks"], fl["quarantined"],
                 fl["solve_timeouts"], fl["solve_retried"],
                 fl["checkpoint_failures"], fl["checkpoint_recovered"],
                 summary["deadletter_windows"], summary["deadletter_spans"],
                 summary["deadletter_bytes"]))
    cap = summary.get("capture")
    if cap is not None:
        # the capture ledger (collector: sources only), as /metrics has it
        print("[stream] capture: %d spans delivered (%d synthetic), loss "
              "rate %.2f%% %s; %d streams re-keyed; skew %s"
              % (cap.get("delivered_spans", 0), cap.get("synthetic_spans", 0),
                 100.0 * cap.get("loss_rate", 0.0),
                 dict(cap.get("loss", {})) or "{}",
                 cap.get("rekeyed_streams", 0),
                 {s: "%+.0fus" % v for s, v in cap.get("skew_us", {}).items()}
                 or "{}"))
    ad = summary.get("adapt", {})
    if ad.get("enabled"):
        print("[stream] adapt: %d refits scheduled, %d landed, %d failed; "
              "%d fallbacks, %d restores, %d recoveries; active fallbacks %s; "
              "%d drift alerts"
              % (ad["refits_scheduled"], ad["refits_done"], ad["refits_failed"],
                 ad["fallbacks"], ad["restores"], ad["recoveries"],
                 ad["active_fallbacks"] or "[]",
                 summary["confidence"]["drift_alerts"]))


def build_serve_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m traceweaver_tpu_torch.runtime.cli serve",
        description="Multi-tenant reconstruction service: HTTP Jaeger-JSON "
                    "span ingestion per tenant, shared fleet dispatches, live "
                    "delay-culprit queries.")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8321,
                   help="listen port (TW_SERVE_PORT; 0 = a free port)")
    p.add_argument("--state-dir", default=None,
                   help="per-tenant sinks, checkpoints and write-ahead logs; "
                        "with --resume, existing tenants resume from them")
    p.add_argument("--resume", action="store_true",
                   help="resume every tenant found in --state-dir")
    p.add_argument("--fix", type=int, default=5,
                   help="ingest FIX mode of posted payloads (5 = Alibaba "
                        "format, ingest every rooted trace)")
    p.add_argument("--window_s", type=float, default=60.0)
    p.add_argument("--overlap_s", type=float, default=5.0)
    p.add_argument("--watermark_s", type=float, default=2.0)
    p.add_argument("--grace_s", type=float, default=0.0)
    p.add_argument("--max-tenants", type=int, default=100,
                   help="tenant cap (TW_SERVE_MAX_TENANTS)")
    p.add_argument("--strict", action="store_true",
                   help="malformed span records -> HTTP 400 instead of the "
                        "skip-and-count default")
    p.add_argument("--continuous", dest="continuous", action="store_true",
                   default=True,
                   help="continuous-batching dispatch: event-driven admission "
                        "with a seal-to-emit SLO (the default, "
                        "TW_SERVE_CONTINUOUS)")
    p.add_argument("--no-continuous", dest="continuous", action="store_false",
                   help="the fixed threshold pump instead")
    p.add_argument("--slo-p99-ms", type=float, default=2000.0,
                   help="per-tenant seal-to-emit p99 SLO in ms "
                        "(TW_SERVE_SLO_P99_MS)")
    p.add_argument("--device", default=None,
                   help="device of the solves (default: the CUDA card; 'cpu' "
                        "runs the plain versions on the CPU)")
    p.add_argument("--precision", default="f32",
                   help="score-block precision: f32 or bf16 (TW_PRECISION)")
    p.add_argument("--events", default=None,
                   help="append serve, fault-ladder and SLO records to this "
                        "JSONL file")
    p.add_argument("--quiet", action="store_true")
    _add_adapt_flags(p)
    return p


def serve_main(argv) -> int:
    """The ``serve`` subcommand; returns the exit code."""
    from traceweaver_tpu_torch.algorithms.weaver_torch import resolve_device
    from traceweaver_tpu_torch.serve import ServeConfig, TenantService, run_server

    args = build_serve_parser().parse_args(argv)
    try:
        device = resolve_device(args.device)
        cfg = ServeConfig(
            window_us=args.window_s * 1e6, overlap_us=args.overlap_s * 1e6,
            ooo_bound_us=args.watermark_s * 1e6, grace_us=args.grace_s * 1e6,
            fix=args.fix, strict=args.strict, verbose=not args.quiet,
            state_dir=args.state_dir, max_tenants=args.max_tenants,
            continuous=args.continuous, slo_p99_ms=args.slo_p99_ms,
            precision=args.precision, adapt=args.adapt,
            adapt_cooldown_s=args.adapt_cooldown_s,
            adapt_probation=args.adapt_probation,
            adapt_low_rate=args.adapt_low_rate,
            conf_drift_window=args.conf_drift_window)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    if device.type == "cuda":
        # the card's context is made before the server announces itself:
        # made at the first solve it holds the interpreter for seconds while
        # /readyz goes unanswered, and a fleet router's probe takes the
        # replica out of routing
        import torch

        torch.zeros(1, device=device)
        torch.cuda.synchronize(device)
    if args.continuous and not args.quiet:
        print("[serve] continuous batching: event-driven admission, seal->emit "
              "p99 SLO %.0f ms (--no-continuous: the fixed pump)"
              % cfg.slo_p99_ms, flush=True)
    if args.resume:
        if not (args.state_dir and os.path.isdir(args.state_dir)):
            print(f"--resume: no state dir at {args.state_dir!r}", file=sys.stderr)
            return 2
        service = TenantService.resume(cfg, device=device)
        if not args.quiet and service.tenants:
            print("[serve] resumed %d tenant(s): %s"
                  % (len(service.tenants), ", ".join(sorted(service.tenants))),
                  flush=True)
    else:
        service = TenantService(cfg, device=device)
    # /metrics is on the serve port itself, so no exporter of its own
    _, log, _ = _obs_setup(None, args.events)
    try:
        run_server(service, args.host, args.port, verbose=not args.quiet)
    finally:
        _obs_finish(None, log)
    return 0


#: subcommand -> (module, function) run with the remaining arguments
SUBCOMMANDS = {
    "stream": ("traceweaver_tpu_torch.runtime.cli", "stream_main"),
    "serve": ("traceweaver_tpu_torch.runtime.cli", "serve_main"),
    "fleet": ("traceweaver_tpu_torch.fleet_serve", "main"),
    "events": ("traceweaver_tpu_torch.obs.events", "tail_main"),
    "query": ("traceweaver_tpu_torch.query.delay_culprit", "main"),
    "scorecard": ("traceweaver_tpu_torch.metrics.scorecard", "main"),
    "campaign": ("traceweaver_tpu_torch.campaign", "main"),
    # the port's static analysis: stdlib only, it loads no torch
    "lint": ("traceweaver_tpu_torch.analysis.__main__", "main"),
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
    from traceweaver_tpu_torch.parallel.mesh import mesh_for
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
    # a bad mesh fails here, before any data loads
    try:
        mesh_for(args.mesh_devices, device)
    except (ValueError, RuntimeError) as e:
        print(f"error: --mesh_devices: {e}", file=sys.stderr)
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
        mesh_devices=args.mesh_devices,
    )
    exporter, log, _ = _obs_setup(args.metrics_port, args.events)
    try:
        run_experiment(cfg)  # prints per-method accuracy as it goes
    finally:
        _obs_finish(exporter, log)
    return 0


if __name__ == "__main__":
    sys.exit(main())
