"""Score-path precision (mirrors ``traceweaver_tpu/ops/precision.py``).

``f32`` (the default) stores the solver's score blocks in float32;
``bf16`` stores them in bfloat16, each row centred at its best feasible
score first, while the potentials, the plan, the marginals, the
rounding margins and the EM fit stay f32. The port reads no
``TW_PRECISION``: the solver, the fleet and the CLI take the precision
as an argument (``--precision``). Byte budgets count
:func:`score_itemsize` bytes a score element.
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
    """Normalize a precision spec; raise on anything unknown (a typo must
    fail, not run f32)."""
    norm = _ALIASES.get(str(precision).strip().lower())
    if norm is None:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {PRECISIONS}")
    return norm


def score_dtype(precision: str) -> torch.dtype:
    """Torch dtype of the score blocks under ``precision``."""
    return torch.bfloat16 if validate_precision(precision) == "bf16" else torch.float32


def score_itemsize(precision: str) -> int:
    """Bytes of one score-block element: the unit of the fleet's dispatch
    budget and the solver's chunking."""
    return 2 if validate_precision(precision) == "bf16" else 4
