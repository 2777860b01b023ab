"""Accuracy metrics and the synthetic labelled service of the port
(mirrors ``traceweaver_tpu/metrics``)."""

from traceweaver_tpu_torch.metrics.accuracy import (  # noqa: F401
    accuracy_end_to_end,
    accuracy_for_service,
    bin_accuracy_by_response_times,
    construct_end_to_end_traces,
    get_ground_truth,
    get_out_eps_in_order,
    topk_accuracy_end_to_end,
    topk_accuracy_for_service,
)
