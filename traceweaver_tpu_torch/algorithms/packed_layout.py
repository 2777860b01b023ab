"""Channel layout of the packed solver output block (mirrors
``traceweaver_tpu/algorithms/packed_layout.py``, base layout only).

    [B, E, W, N_FIXED + topk] int32
      CH_ASSIGN   (0)  column index per incoming span (M = skip, -1 = none)
      CH_NOT_BEST (1)  OT choice differs from the row argmax (bool)
      CH_FEAS     (2)  feasible candidates per row
      CH_TOPK..        plan-mass-ranked alternatives (-1 below the mass floor)
"""

from __future__ import annotations

from typing import Dict, Optional

CH_ASSIGN = 0
CH_NOT_BEST = 1
CH_FEAS = 2
CH_TOPK = 3
N_FIXED = 3


def split_packed(block, topk: Optional[int] = None) -> Dict[str, object]:
    """Named views of a packed block's channels (numpy or torch)."""
    if topk is None:
        topk = block.shape[-1] - N_FIXED
    return dict(
        assign=block[..., CH_ASSIGN],
        not_best=block[..., CH_NOT_BEST] != 0,
        feas=block[..., CH_FEAS],
        topk_cols=block[..., CH_TOPK:CH_TOPK + topk],
    )
