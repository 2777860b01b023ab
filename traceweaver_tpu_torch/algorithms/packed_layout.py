"""Channel layout of the packed solver output block (mirrors
``traceweaver_tpu/algorithms/packed_layout.py``).

Base layout::

    [B, E, W, N_FIXED + topk] int32
      CH_ASSIGN   (0)  column index per incoming span (M = skip, -1 = none)
      CH_NOT_BEST (1)  OT choice differs from the row argmax (bool)
      CH_FEAS     (2)  feasible candidates per row
      CH_TOPK..        plan-mass-ranked alternatives (-1 below the mass floor)

Confidence extension (``confidence=True``, the fleet's ``conf_device``
option; the base layout above is unchanged)::

    [..., N_FIXED + topk + N_CONF]
      ch_margin(topk)   top1-top2 row score margin x CONF_SCALE
      ch_entropy(topk)  entropy (nats) of the row's softmax(S / eps)
                        x CONF_SCALE
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

CH_ASSIGN = 0
CH_NOT_BEST = 1
CH_FEAS = 2
CH_TOPK = 3
N_FIXED = 3
#: extra trailing channels of the confidence variant
N_CONF = 2
#: fixed-point scale of the quantized confidence channels (int32 = value
#: x CONF_SCALE, truncated)
CONF_SCALE = 1000.0


def n_channels(topk: int, confidence: bool = False) -> int:
    """Last-axis width of the packed block."""
    return N_FIXED + topk + (N_CONF if confidence else 0)


def ch_margin(topk: int) -> int:
    return N_FIXED + topk


def ch_entropy(topk: int) -> int:
    return N_FIXED + topk + 1


def topk_of(block_channels: int, confidence: bool = False) -> int:
    """``topk`` of a block with ``block_channels`` channels."""
    return block_channels - N_FIXED - (N_CONF if confidence else 0)


def split_packed(block, confidence: bool = False,
                 topk: Optional[int] = None) -> Dict[str, object]:
    """Named views of a packed block's channels (numpy or torch):
    ``assign``, ``not_best`` (bool), ``feas``, ``topk_cols`` and, under
    the confidence variant, ``margin_q`` / ``entropy_q``."""
    if topk is None:
        topk = topk_of(block.shape[-1], confidence)
    out = dict(
        assign=block[..., CH_ASSIGN],
        not_best=block[..., CH_NOT_BEST] != 0,
        feas=block[..., CH_FEAS],
        topk_cols=block[..., CH_TOPK:CH_TOPK + topk],
    )
    if confidence:
        out["margin_q"] = block[..., ch_margin(topk)]
        out["entropy_q"] = block[..., ch_entropy(topk)]
    return out


def answer_rows(windows: Sequence[Tuple[int, int]]
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Where each answer of a window tiling sits: ``(w_of, i_of, pos)``,
    its window row, its row in the window and its span's position in the
    sorted incoming spans, in window order."""
    n_w = np.fromiter((hi - lo for lo, hi in windows), np.int64, len(windows))
    los = np.fromiter((lo for lo, _ in windows), np.int64, len(windows))
    w_of = np.repeat(np.arange(len(windows)), n_w)
    i_of = np.arange(int(n_w.sum())) - np.repeat(np.cumsum(n_w) - n_w, n_w)
    return w_of, i_of, i_of + np.repeat(los, n_w)
