"""Overlapping event-time windows with single-owner emission (mirrors
``traceweaver_tpu/stream/window.py``).

Windows are keyed by index ``k`` and cover the absolute event-time range
``[k*stride, k*stride + size)`` with ``stride = size - overlap``; with
``overlap = 0`` they are plain tumbling windows. A span at event time
``t`` joins *every* window covering ``t`` but is **owned** by exactly one
— ``k = floor(t / stride)``, the latest window starting at or before
``t``. Ownership decides emission: a sealed window's solve emits
assignments only for the incoming spans it owns, so overlapping windows
never double-emit. The overlap region gives spans near a boundary
candidate outgoing spans (and competing incoming rows) from the far side
— the cross-window candidates a hard cut would lose; the residual loss
is what the streamed-vs-batch accuracy delta measures.

Sealing is watermark-driven: window ``k`` seals once the watermark passes
``end(k) + grace_us``. A span whose owner window has already sealed is
*late*; it is rerouted — owned — into the earliest window still open (its
assignment is then solved with that window's context, usually a weak one,
but it is emitted exactly once), or counted in ``late_dropped`` when
nothing is open. Both outcomes are quantified (``late_rerouted`` /
``late_dropped``). ``grace_us`` is the allowed lateness *before* this
kicks in: a window outlives its watermark crossing by ``grace_us``, so
spans up to that late still land in their own window.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, List, Set, Tuple

from traceweaver_tpu_torch.spans import Span


@dataclass
class WindowBuffer:
    """Spans buffered for one window, with the owned subset marked."""

    k: int
    start_us: float
    end_us: float
    spans: List[Span] = field(default_factory=list)
    owned_ids: Set[Tuple[str, str]] = field(default_factory=set)
    # owned server-side roots, collected at add() time so emission-side
    # consumers (trace stitching) never re-scan the whole buffer to find
    # them — the columnar-host-path rule: per-span Python work happens
    # once, where the span already is in hand
    roots: List[Span] = field(default_factory=list)
    # stamped at seal time by the engine: watermark delay when sealed
    seal_delay_us: float = 0.0
    # wall clock (time.monotonic) at seal time: the start of the
    # seal→emit latency (StreamConfig.slo_p99_ms bounds its p99)
    sealed_wall: float = 0.0

    def add(self, span: Span, owned: bool) -> None:
        self.spans.append(span)
        if owned:
            self.owned_ids.add(span.GetId())
            if span.span_kind == "server" and span.IsRoot():
                self.roots.append(span)

    @property
    def n_spans(self) -> int:
        return len(self.spans)

    @property
    def n_owned(self) -> int:
        return len(self.owned_ids)


class WindowingEngine:
    """Buckets spans into overlapping windows and seals them in order."""

    def __init__(self, size_us: float, overlap_us: float = 0.0,
                 grace_us: float = 0.0) -> None:
        if size_us <= 0:
            raise ValueError(f"window size_us must be > 0, got {size_us}")
        if not 0 <= overlap_us < size_us:
            raise ValueError(
                f"overlap_us must be in [0, size_us), got {overlap_us}")
        self.size_us = float(size_us)
        self.stride_us = float(size_us) - float(overlap_us)
        self.grace_us = float(grace_us)
        self.open: Dict[int, WindowBuffer] = {}
        # watermark as of the last poll: the sealing frontier. A window k
        # is sealed iff end(k) + grace <= this (empty windows never
        # materialize a buffer but still count as sealed by time).
        self.sealed_frontier_us: float = float("-inf")
        self.late_rerouted = 0
        self.late_dropped = 0

    # -- geometry ---------------------------------------------------------
    def owner_of(self, t: float) -> int:
        return int(math.floor(t / self.stride_us))

    def covering(self, t: float) -> List[int]:
        """All window indices whose range contains t, ascending."""
        k_hi = self.owner_of(t)
        # k*stride + size > t  <=>  k > (t - size)/stride
        k_lo = int(math.floor((t - self.size_us) / self.stride_us)) + 1
        return list(range(max(k_lo, 0), k_hi + 1))

    def window_range(self, k: int) -> Tuple[float, float]:
        return k * self.stride_us, k * self.stride_us + self.size_us

    def _is_sealed(self, k: int) -> bool:
        _, end = self.window_range(k)
        return end + self.grace_us <= self.sealed_frontier_us

    def _buffer(self, k: int) -> WindowBuffer:
        buf = self.open.get(k)
        if buf is None:
            start, end = self.window_range(k)
            buf = self.open[k] = WindowBuffer(k, start, end)
        return buf

    # -- ingest -----------------------------------------------------------
    def add(self, span: Span, event_us: float) -> str:
        """Route one span. Returns "ok", "late_rerouted", or
        "late_dropped"."""
        owner = self.owner_of(event_us)
        cover = self.covering(event_us)
        if self._is_sealed(owner):
            # late span: its owner (and, with it, every earlier covering
            # window) already sealed. Route it — owned — into the earliest
            # window still open, so it is emitted exactly once, just from
            # a later window than its event time nominally maps to; drop
            # with accounting when nothing is open to take it.
            open_ks = sorted(k for k in self.open if not self._is_sealed(k))
            if open_ks:
                self._buffer(open_ks[0]).add(span, owned=True)
                self.late_rerouted += 1
                return "late_rerouted"
            self.late_dropped += 1
            return "late_dropped"
        for k in cover:
            if not self._is_sealed(k):
                self._buffer(k).add(span, owned=(k == owner))
        return "ok"

    # -- sealing ----------------------------------------------------------
    def poll(self, watermark_us: float) -> List[WindowBuffer]:
        """Advance the sealing frontier to ``watermark_us`` and pop every
        window now sealed, in window order."""
        self.sealed_frontier_us = max(self.sealed_frontier_us, watermark_us)
        sealed = []
        now = time.monotonic()
        for k in sorted(self.open):
            if self._is_sealed(k):
                buf = self.open.pop(k)
                buf.seal_delay_us = max(
                    0.0, self.sealed_frontier_us - buf.end_us)
                buf.sealed_wall = now
                sealed.append(buf)
        return sealed

    def flush(self) -> List[WindowBuffer]:
        """End of stream: seal every remaining window in order."""
        self.sealed_frontier_us = float("inf")
        out = [self.open.pop(k) for k in sorted(self.open)]
        now = time.monotonic()
        for buf in out:
            buf.seal_delay_us = 0.0
            buf.sealed_wall = now
        return out
