"""Score-path precision (mirrors ``traceweaver_tpu/ops/precision.py``).

The port runs the f32 score path only; ``bf16`` (score blocks stored in
bfloat16, potentials/plan/margins f32) is validated and then refused
until its slice lands.
"""

from __future__ import annotations

import torch

PRECISIONS = ("f32", "bf16")

_ALIASES = {
    "": "f32",
    "f32": "f32",
    "fp32": "f32",
    "float32": "f32",
    "bf16": "bf16",
    "bfloat16": "bf16",
}


def validate_precision(precision: str) -> str:
    """Normalize a precision spec; raise on anything unknown and on the
    bf16 path, which this port does not carry yet."""
    norm = _ALIASES.get(str(precision).strip().lower())
    if norm is None:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    if norm == "bf16":
        raise NotImplementedError("bf16 score path: later slice")
    return norm


def score_dtype(precision: str) -> torch.dtype:
    """Torch dtype of the score blocks under ``precision``."""
    validate_precision(precision)
    return torch.float32
