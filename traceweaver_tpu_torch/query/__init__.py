"""Queries over reconstructed end-to-end traces (mirrors
``traceweaver_tpu/query``)."""

from traceweaver_tpu_torch.query.delay_culprit import (  # noqa: F401
    delay_culprit,
    extract_hop_latencies,
    filter_traces,
)
