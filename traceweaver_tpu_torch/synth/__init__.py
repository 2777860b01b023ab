"""Synthetic workload transforms of the port (mirrors
``traceweaver_tpu/synth``)."""
