"""Runtime helpers of the port (mirrors ``traceweaver_tpu/runtime``)."""
