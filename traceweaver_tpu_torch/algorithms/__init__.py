"""Solver algorithms of the port (mirrors ``traceweaver_tpu/algorithms``)."""
