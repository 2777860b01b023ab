"""Tie-aware comparison of two hard assignments of the same plan, and the
share of pairs two assignment maps agree on.

Two Sinkhorn implementations that sum their log-sum-exps in different
orders give plans that agree to float tolerance, not bit for bit, so the
greedy rounding and the top-k peel may break an exact-mass near tie the
other way. These helpers tell such differences from real ones; the
kernel checks of ``chip_smoke.py`` and the port-vs-JAX tests use them.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

#: two plan masses within this relative distance count as a near tie
REL_TIE = 1e-5


def assign_diff_report(a_x: np.ndarray, a_y: np.ndarray,
                       plan: np.ndarray) -> Dict[str, int]:
    """Rows where assignments ``a_x`` and ``a_y`` ([B, N] column indices,
    last plan column = skip, -1 = none) differ, split into row near ties
    (the two chosen columns' masses in ``plan`` [B, N, C] within
    :data:`REL_TIE`), contention (the row's column, or the skip column,
    is also held by another differing row) and unexplained rows."""
    C = plan.shape[-1]
    stats = dict(differ=0, row_tie=0, contention=0, unexplained=0)
    for b in range(a_x.shape[0]):
        diff = np.flatnonzero(a_x[b] != a_y[b])
        stats["differ"] += len(diff)
        held_x = {int(a_x[b, i]): i for i in diff}
        held_y = {int(a_y[b, i]): i for i in diff}
        skip_rows = [i for i in diff if a_x[b, i] == C - 1 or a_y[b, i] == C - 1]
        for i in diff:
            mx = plan[b, i, a_x[b, i]] if a_x[b, i] >= 0 else 0.0
            my = plan[b, i, a_y[b, i]] if a_y[b, i] >= 0 else 0.0
            if abs(mx - my) <= REL_TIE * max(mx, my):
                stats["row_tie"] += 1
            elif (held_x.get(int(a_y[b, i]), i) != i
                  or held_y.get(int(a_x[b, i]), i) != i
                  or (i in skip_rows and len(skip_rows) > 1)):
                stats["contention"] += 1
            else:
                stats["unexplained"] += 1
    return stats


def topk_diff_report(tk_x: np.ndarray, tk_y: np.ndarray, plan_masked: np.ndarray,
                     min_mass: float) -> Tuple[int, int]:
    """``(rows whose top-k lists differ, rows among them with no near tie
    at the first differing rank)``: a tie between the ranked masses of
    ``plan_masked`` [B, N, C] (invalid columns at a large negative
    value), or a mass at the ``min_mass`` floor."""
    bad = 0
    diff_rows = np.argwhere((tk_x != tk_y).any(-1))
    for b, i in diff_rows:
        v = np.sort(plan_masked[b, i])[::-1]
        s = int(np.flatnonzero(tk_x[b, i] != tk_y[b, i])[0])
        tie = s + 1 < len(v) and abs(v[s] - v[s + 1]) <= REL_TIE * max(v[s], 1e-30)
        floor = abs(v[s] - min_mass) <= REL_TIE * min_mass
        bad += not (tie or floor)
    return len(diff_rows), bad


def pair_agreement(got: Dict[str, Dict], ref: Dict[str, Dict]) -> float:
    """Share of ``ref``'s (endpoint, incoming span) pairs that ``got``
    assigns alike (``{endpoint: {in id: out id}}`` maps; 1.0 when ``ref``
    has no pair)."""
    pairs = [(ep, i) for ep in ref for i in ref[ep]]
    if not pairs:
        return 1.0
    return sum(got.get(ep, {}).get(i) == ref[ep][i] for ep, i in pairs) / len(pairs)
