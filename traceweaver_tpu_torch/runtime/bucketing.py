"""Power-of-two bucketing (mirrors ``traceweaver_tpu/runtime/bucketing.py``).

Dispatch shapes are pow2-bucketed so the port packs exactly the tensor
shapes the JAX package packs.
"""

from __future__ import annotations


def pow2_bucket(n: int, minimum: int = 1) -> int:
    """Smallest power-of-two multiple of ``minimum`` that is >= ``n``
    (``minimum`` must be a power of two; n <= 0 buckets to ``minimum``)."""
    b = minimum
    while b < n:
        b *= 2
    return b
