"""The port's static analysis (mirrors ``traceweaver_tpu/analysis``).

A stdlib-``ast`` rule engine with per-line suppression and a checked-in
baseline that holds the port to its ground rules (no JAX, no ``TW_*``
read, no device gate or fallback) and to its host-sync, lock, bf16
accumulation, metric, ticket, ack and launch contracts::

    python -m traceweaver_tpu_torch.analysis             # the port
    python -m traceweaver_tpu_torch.analysis ops/        # one subtree
    python -m traceweaver_tpu_torch.runtime.cli lint     # CLI spelling

This ``__init__`` imports nothing, so the gate never loads torch:
the engine is :mod:`traceweaver_tpu_torch.analysis.engine`, the rule
catalog :mod:`traceweaver_tpu_torch.analysis.rules`.
"""
