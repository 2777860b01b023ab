"""Event-time watermark tracking (mirrors ``traceweaver_tpu/stream/watermark.py``).

The watermark is the stream's completeness frontier: "no span with event
time below this should still be in flight". With collectors that deliver
at most ``bound_us`` late (the replay source's ``ooo_us`` models this),
``watermark = max(event_time seen) - bound_us`` is a correct frontier;
spans that violate it anyway are *late* and are handled by the windowing
engine (rerouted into a still-open window or counted as dropped).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class WatermarkTracker:
    """Monotone watermark over observed event times.

    ``bound_us`` is the allowed out-of-orderness. The tracker also keeps
    the lateness statistics the stats surface reports: how many events
    arrived behind the watermark (late), and the maximum skew between an
    event and the frontier at its arrival.
    """

    bound_us: float = 0.0
    max_event_us: float = field(default=float("-inf"), init=False)
    n_events: int = field(default=0, init=False)
    n_late: int = field(default=0, init=False)
    max_skew_us: float = field(default=0.0, init=False)

    @property
    def value(self) -> float:
        """Current watermark (-inf until the first event)."""
        if self.max_event_us == float("-inf"):
            return float("-inf")
        return self.max_event_us - self.bound_us

    def observe(self, event_us: float) -> bool:
        """Fold one event time in. Returns True when the event is late
        (behind the watermark as of *before* this observation)."""
        late = event_us < self.value
        if late:
            self.n_late += 1
        if self.max_event_us != float("-inf"):
            self.max_skew_us = max(self.max_skew_us,
                                   self.max_event_us - event_us)
        self.max_event_us = max(self.max_event_us, event_us)
        self.n_events += 1
        return late

    def delay_of(self, event_us: float) -> float:
        """How far behind the frontier an event time sits (0 if ahead)."""
        if self.max_event_us == float("-inf"):
            return 0.0
        return max(0.0, self.max_event_us - event_us)
