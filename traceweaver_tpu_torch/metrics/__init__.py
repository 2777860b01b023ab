"""Accuracy metrics and the synthetic labelled service of the port
(mirrors ``traceweaver_tpu/metrics``)."""
