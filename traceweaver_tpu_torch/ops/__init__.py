"""Device ops of the port (mirrors ``traceweaver_tpu/ops``)."""
