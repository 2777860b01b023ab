"""Jaeger-JSON ingestion, dataset repair, partitioning and invocation-DAG
inference, from ground truth or discovered without it (mirrors
``traceweaver_tpu/ingest``)."""

from traceweaver_tpu_torch.ingest.jaeger import (  # noqa: F401
    FIX_ROOT_OPS,
    MalformedSpan,
    load_corpus,
    parse_trace_file,
    parse_trace_payload,
    time_ordered_trace_files,
)
from traceweaver_tpu_torch.ingest.order import (  # noqa: F401
    discover_invocation_dag,
    fit_invocation_dag,
    infer_dag_from_predictions,
    infer_invocation_dag,
    solver_misfit,
    topological_sort_grouped,
)
from traceweaver_tpu_torch.ingest.partition import (  # noqa: F401
    ServiceProblem,
    build_service_problem,
    partition_spans_by_endpoint,
)
