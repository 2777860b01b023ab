"""Synthetic workload transforms of the port (mirrors
``traceweaver_tpu/synth``)."""

from traceweaver_tpu_torch.synth.transforms import (  # noqa: F401
    compress_spans,
    create_cache_hits,
    repeat_and_interleave_spans,
)
