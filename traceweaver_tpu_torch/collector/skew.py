"""Per-source clock-skew estimation over request/response event pairs.

A multi-host capture gives every source (captured process / host) its own
clock. The windowed solver assumes one event-time axis: the candidate
enumeration requires a parent span's interval to contain its children's,
and the watermark assumes bounded out-of-orderness — a few hundred
milliseconds of host skew violates both (a child "starting before" its
parent is simply never enumerated as a candidate). This module fits a
constant per-source offset from the capture's own request/response
geometry and the ingress (:mod:`traceweaver_tpu_torch.collector.source`)
subtracts it from every timestamp *before* watermarking.

The fit is the classic NTP exchange estimate. One cross-source exchange
gives four timestamps::

    t0  caller writes the request        (caller clock)
    t1  callee reads the request         (callee clock)
    t2  callee writes the response       (callee clock)
    t3  caller reads the response        (caller clock)

    theta = ((t1 - t0) + (t2 - t3)) / 2     # callee clock - caller clock

which cancels the symmetric part of the network delay; the residual
error is bounded by the delay asymmetry, far below the skews that break
containment. Per (caller, callee) edge the estimator keeps every
observed ``theta`` and takes the *median* (a single retransmitted or
half-captured exchange must not drag the fit), then anchors one
reference source at offset zero and walks the exchange graph breadth-
first, accumulating edge medians into absolute per-source offsets.

The reference is chosen deterministically: the alphabetically-first
source that only ever appears as a caller (the capture closest to the
external client), falling back to the alphabetically-first source
overall. Offsets are clamped to ``±max_us`` (the JAX package's ``TW_SKEW_MAX_US``) (a fit driven by a
corrupt capture must not fling a source's spans outside every window);
clamps are counted so the ingress can surface them as capture loss.

Mirrors ``traceweaver_tpu/collector/skew.py``; the port keeps its own copy.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Set, Tuple

#: ``TW_SKEW_MIN_PAIRS``: exchange pairs before the first fit
SKEW_MIN_PAIRS = 3
#: ``TW_SKEW_MAX_US``: the clamp on a fitted offset (microseconds)
SKEW_MAX_US = 30e6



class SkewEstimator:
    """Pairwise-offset fit over captured request/response exchanges."""

    def __init__(self, min_pairs: int = SKEW_MIN_PAIRS,
                 max_us: float = SKEW_MAX_US) -> None:
        self.min_pairs = int(min_pairs)
        self.max_us = float(max_us)
        # (caller, callee) -> observed thetas (callee clock - caller clock)
        self._pairs: Dict[Tuple[str, str], List[float]] = {}
        self._offsets: Dict[str, float] = {}
        self._sources: Set[str] = set()
        self._callees: Set[str] = set()
        self.n_pairs = 0
        self.fits = 0
        self.clamped = 0

    def register_source(self, source: str) -> None:
        """Make a source known even before (or without) any exchange
        pairs — it participates in the fit with offset 0."""
        self._sources.add(source)

    def observe_pair(self, caller: str, callee: str,
                     t0: float, t1: float, t2: float, t3: float) -> None:
        """Fold one cross-source exchange in (all four stamps in the
        respective source's *raw* capture clock, microseconds)."""
        if caller == callee:
            return
        theta = ((t1 - t0) + (t2 - t3)) / 2.0
        self._pairs.setdefault((caller, callee), []).append(theta)
        self._sources.update((caller, callee))
        self._callees.add(callee)
        self.n_pairs += 1

    def reference(self) -> Optional[str]:
        """Deterministic anchor: alphabetically-first caller-only source,
        else alphabetically-first source."""
        if not self._sources:
            return None
        caller_only = sorted(self._sources - self._callees)
        return caller_only[0] if caller_only else sorted(self._sources)[0]

    def ready(self) -> bool:
        """Enough exchange pairs for a trustworthy first fit?"""
        return self.n_pairs >= self.min_pairs

    def fit(self) -> Dict[str, float]:
        """(Re)fit absolute per-source offsets: median per edge, then a
        breadth-first walk from the reference source. Sources the
        exchange graph never reaches keep offset 0 (there is nothing to
        align them against). Returns the offset map; also retrievable
        per source via :meth:`offset_us`."""
        ref = self.reference()
        if ref is None:
            return {}
        edges: Dict[str, List[Tuple[str, float]]] = {}
        for (caller, callee), thetas in self._pairs.items():
            med = statistics.median(thetas)
            # offset[callee] - offset[caller] = median theta, both ways
            edges.setdefault(caller, []).append((callee, med))
            edges.setdefault(callee, []).append((caller, -med))
        offsets = {s: 0.0 for s in self._sources}
        seen = {ref}
        frontier = [ref]
        while frontier:
            nxt: List[str] = []
            for src in frontier:
                for other, delta in sorted(edges.get(src, ())):
                    if other in seen:
                        continue
                    seen.add(other)
                    val = offsets[src] + delta
                    if abs(val) > self.max_us:
                        self.clamped += 1
                        val = max(-self.max_us, min(self.max_us, val))
                    offsets[other] = val
                    nxt.append(other)
            frontier = nxt
        self._offsets = offsets
        self.fits += 1
        return dict(offsets)

    def offset_us(self, source: str) -> float:
        """The fitted offset of ``source``'s clock (0.0 before any fit
        reaches it)."""
        return self._offsets.get(source, 0.0)

    def correct(self, source: str, t_us: float) -> float:
        """Map a raw capture timestamp onto the reference clock."""
        return t_us - self.offset_us(source)

    def offsets(self) -> Dict[str, float]:
        return dict(self._offsets)
