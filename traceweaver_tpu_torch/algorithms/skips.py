"""Water-filling of the per-endpoint skip budget across windows (mirrors
``traceweaver_tpu/algorithms/skips.py``).

Each endpoint's global skip budget ``|in| - |out|`` is spread over the
solver's windows: windows with fewer candidate out-spans get skip slots
first, raising ``existing + skips`` toward one water level, each window
capped at ``expected - existing``. The level is found exactly (bisection)
and the integer remainder is spilled to the lowest windows with room.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


def water_fill(existing: np.ndarray, expected: np.ndarray,
               budget: float) -> np.ndarray:
    """Allocate ``budget`` skip slots over windows; returns [n] float."""
    n = len(existing)
    alloc = np.zeros(n)
    if budget <= 0 or n == 0:
        return alloc
    existing = np.asarray(existing, dtype=np.float64)
    expected = np.asarray(expected, dtype=np.float64)
    cap = np.maximum(expected - existing, 0.0)

    def spend(level: float) -> float:
        return float(np.minimum(np.maximum(level - existing, 0.0), cap).sum())

    hi = float((existing + cap).max())
    if spend(hi) <= budget:
        return cap.copy()
    lo = float(existing.min())
    for _ in range(64):
        mid = 0.5 * (lo + hi)
        if spend(mid) > budget:
            hi = mid
        else:
            lo = mid
    frac = np.minimum(np.maximum(lo - existing, 0.0), cap)
    alloc = np.floor(frac)

    remaining = int(budget - alloc.sum())
    if remaining > 0:
        level = existing + alloc
        headroom = alloc < cap
        order = np.argsort(level, kind="stable")
        for w in order:
            if remaining <= 0:
                break
            if headroom[w]:
                alloc[w] += 1
                remaining -= 1
    return alloc


def water_fill_skip_caps(
    windows: List[Tuple[int, int]],
    ranges: np.ndarray,          # [B, E, 2] candidate index ranges
    n_in: int,
    out_counts: List[int],       # per endpoint, |out|
) -> np.ndarray:
    """Per-(window, endpoint) skip capacities, [B, E] float32."""
    B = len(windows)
    E = len(out_counts)
    expected = np.array([hi - lo for lo, hi in windows], dtype=np.float64)
    caps = np.zeros((B, E), dtype=np.float32)
    for e in range(E):
        budget = n_in - out_counts[e]
        if budget <= 0:
            continue
        existing = (ranges[:, e, 1] - ranges[:, e, 0]).astype(np.float64)
        caps[:, e] = water_fill(existing, expected, float(budget))
    return caps
