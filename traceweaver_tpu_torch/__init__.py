"""PyTorch/CUDA port of the TraceWeaver reconstruction solver.

A second package beside ``traceweaver_tpu`` (the JAX reference). It
imports ``torch``, numpy and scipy, never ``jax`` and nothing of
``traceweaver_tpu``: every module it needs is carried here as its own
copy, and each module's docstring names the JAX module it mirrors.

Ported so far: the per-service plugin entry point
:meth:`traceweaver_tpu_torch.algorithms.weaver_torch.WeaverTorch.FindAssignments`
and the fleet solve
:func:`traceweaver_tpu_torch.algorithms.fleet.solve_fleet`, whose two TPU kernels (the fused Sinkhorn -> rounding -> top-k kernel and
the plain Sinkhorn kernel) are hand-written CUDA for Hopper under
``ops/csrc/``.
"""
