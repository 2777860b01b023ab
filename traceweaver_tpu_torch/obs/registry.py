"""Typed, thread-safe metrics registry (mirrors
``traceweaver_tpu/obs/registry.py``).

The fleet's ``_Stats`` ledger, the solver's stats and the fault ladder
keep their dicts (their field names are what callers read); every update
also lands here, so one scrape surface
(:mod:`traceweaver_tpu_torch.obs.exposition`, ``GET /metrics``) sees the
whole pipeline with labels.

- stdlib only: the fleet and the CLI import it for free;
- typed: :class:`Counter` (monotonic; a negative increment raises),
  :class:`Gauge` (set, set-if-greater) and :class:`Histogram` (fixed
  buckets, cumulative), each with a declared label schema; declaring a
  name again with another kind or label set raises :class:`MetricError`;
- thread-safe: the fleet's pack thread, flow workers and fallback pool
  update it at once, so every mutation runs under the registry's lock;
- bounded: past ``max_series`` label-value sets (a constructor argument,
  the JAX package's ``TW_METRICS_MAX_SERIES`` default of 512) a family's
  new sets collapse into one counted ``{overflow="1"}`` series;
- scrape-time collectors expose state that lives elsewhere, evaluated on
  every scrape.
"""

from __future__ import annotations

import math
import re
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: child key of a family's cardinality-overflow series (rendered as
#: ``{overflow="1"}``): once a family holds ``max_series`` distinct
#: label-value sets, updates for NEW sets collapse into this one counted
#: series instead of growing the registry unbounded
OVERFLOW_KEY = ("__overflow__",)

#: the JAX package's ``TW_METRICS_MAX_SERIES`` default
DEFAULT_MAX_SERIES = 512

#: default histogram buckets (seconds-flavored: 1 ms .. 60 s, then +Inf)
DEFAULT_BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0, 60.0)


class MetricError(ValueError):
    """A metric misuse (name/label schema conflict, negative counter
    increment, bad label set) — raised loudly instead of silently
    forking or corrupting a series."""


class _Family:
    """One metric family: a name, a kind, a label schema, and children
    keyed by label-value tuples. All mutation happens under the owning
    registry's lock (passed in — one lock per registry, so cross-family
    snapshots are consistent)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str],
                 lock: threading.RLock,
                 max_series: int = DEFAULT_MAX_SERIES) -> None:
        if not _NAME_RE.match(name):
            raise MetricError(f"invalid metric name {name!r}")
        for lab in labels:
            if not _LABEL_RE.match(lab):
                raise MetricError(
                    f"invalid label name {lab!r} on metric {name!r}")
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self.max_series = max_series
        self._lock = lock
        self._children: Dict[Tuple[str, ...], float] = {}

    def _key(self, labelkw: Dict[str, object]) -> Tuple[str, ...]:
        if set(labelkw) != set(self.labels):
            raise MetricError(
                f"metric {self.name!r} declared labels {self.labels}, "
                f"got {tuple(sorted(labelkw))}")
        return tuple(str(labelkw[lab]) for lab in self.labels)

    def _admit(self, key: Tuple[str, ...], table: Dict) -> Tuple[str, ...]:
        """Cardinality guard (caller holds the lock): an update for a
        label-value set the family already tracks passes through; a NEW
        set is admitted only while the family holds fewer than
        ``max_series`` distinct sets, else it lands on the
        single :data:`OVERFLOW_KEY` series — counted, never silently
        dropped, and the registry stays bounded under many tenants."""
        if key in table or not self.labels:
            return key
        n_real = len(table) - (1 if OVERFLOW_KEY in table else 0)
        if n_real >= self.max_series:
            return OVERFLOW_KEY
        return key

    def _sample_labels(self, key: Tuple[str, ...]) -> Dict[str, str]:
        if key == OVERFLOW_KEY:
            return {"overflow": "1"}
        return dict(zip(self.labels, key))

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """``[(labels_dict, value)]`` snapshot, label-sorted (stable
        exposition order; the overflow series, if any, rides along as
        ``{overflow="1"}``)."""
        with self._lock:
            items = sorted(self._children.items())
        return [(self._sample_labels(key), val) for key, val in items]


class Counter(_Family):
    """Monotonic counter. ``inc`` with a negative value raises — a
    decreasing 'counter' is a gauge wearing the wrong type."""

    kind = "counter"

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise MetricError(
                f"counter {self.name!r}: negative increment {value}")
        key = self._key(labels)
        with self._lock:
            key = self._admit(key, self._children)
            self._children[key] = self._children.get(key, 0.0) + value


class Gauge(_Family):
    """Point-in-time value; ``set_max`` is the ``_Stats.record_max``
    mirror (set-if-greater)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            key = self._admit(key, self._children)
            self._children[key] = float(value)

    def set_max(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            key = self._admit(key, self._children)
            self._children[key] = max(self._children.get(key, float(value)),
                                      float(value))


class Histogram(_Family):
    """Fixed-bucket cumulative histogram (Prometheus semantics: each
    bucket counts observations ≤ its bound, ``+Inf`` counts all)."""

    kind = "histogram"

    def __init__(self, name: str, help: str, labels: Sequence[str],
                 lock: threading.RLock, max_series: int = DEFAULT_MAX_SERIES,
                 buckets: Sequence[float] = DEFAULT_BUCKETS) -> None:
        super().__init__(name, help, labels, lock, max_series)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(math.isnan(b) for b in bounds):
            raise MetricError(
                f"histogram {name!r}: need at least one finite bucket")
        self.buckets = bounds
        # child value: [count_per_bucket..., +Inf count, sum]
        self._hchildren: Dict[Tuple[str, ...], List[float]] = {}

    def observe(self, value: float, **labels) -> None:
        key = self._key(labels)
        v = float(value)
        with self._lock:
            key = self._admit(key, self._hchildren)
            child = self._hchildren.get(key)
            if child is None:
                child = [0.0] * (len(self.buckets) + 2)
                self._hchildren[key] = child
            for i, bound in enumerate(self.buckets):
                if v <= bound:
                    child[i] += 1.0
            child[-2] += 1.0          # +Inf
            child[-1] += v            # sum

    def samples(self) -> List[Tuple[Dict[str, str], float]]:
        """Flattened exposition samples: ``_bucket{le=...}``, ``_sum``,
        ``_count`` per child (the exposition layer keys on the sample
        name suffixes)."""
        out: List[Tuple[Dict[str, str], float]] = []
        with self._lock:
            items = sorted(self._hchildren.items())
        for key, child in items:
            base = self._sample_labels(key)
            for i, bound in enumerate(self.buckets):
                out.append(({**base, "le": _fmt_bound(bound),
                             "__name__": self.name + "_bucket"}, child[i]))
            out.append(({**base, "le": "+Inf",
                         "__name__": self.name + "_bucket"}, child[-2]))
            out.append(({**base, "__name__": self.name + "_sum"}, child[-1]))
            out.append(({**base, "__name__": self.name + "_count"},
                        child[-2]))
        return out


def _fmt_bound(b: float) -> str:
    return repr(b) if b != int(b) else str(int(b))


#: a collector returns families as plain tuples so sources need no
#: registry objects: ``(name, kind, help, [(labels_dict, value), ...])``
CollectorFn = Callable[[], Iterable[Tuple[str, str, str,
                                          List[Tuple[Dict[str, str],
                                                     float]]]]]


class MetricsRegistry:
    """Family store + scrape-time collectors. One instance per process
    in practice (:func:`get_registry`); tests may build private ones."""

    def __init__(self, max_series: int = DEFAULT_MAX_SERIES) -> None:
        if max_series < 1:
            raise MetricError(f"max_series must be >= 1, got {max_series}")
        self.max_series = max_series
        self._lock = threading.RLock()
        self._families: Dict[str, _Family] = {}
        self._collectors: Dict[str, CollectorFn] = {}

    # -- declaration (idempotent; schema conflicts raise) -----------------
    def _declare(self, cls, name: str, help: str, labels: Sequence[str],
                 **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if type(fam) is not cls or fam.labels != tuple(labels):
                    raise MetricError(
                        f"metric {name!r} already declared as "
                        f"{fam.kind} with labels {fam.labels}; "
                        f"redeclaration as {cls.kind} with "
                        f"{tuple(labels)} would fork the series")
                return fam
            fam = cls(name, help, labels, self._lock, self.max_series, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._declare(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._declare(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._declare(Histogram, name, help, labels, buckets=buckets)

    def register_collector(self, key: str, fn: CollectorFn) -> None:
        """Register (or replace — idempotence under re-install) a
        scrape-time collector. Collectors are evaluated on every
        :meth:`collect`, so the exposed values ARE the source ledger's
        current values, never a mirrored copy that could drift."""
        with self._lock:
            self._collectors[key] = fn

    # -- read side ---------------------------------------------------------
    def collect(self, include_collectors: bool = True):
        """Yield ``(name, kind, help, samples)`` for every family (owned
        first, then collectors). Collector callbacks run OUTSIDE the
        registry lock — they read other subsystems' locked state and
        must not nest under ours."""
        with self._lock:
            owned = sorted(self._families.items())
            collectors = list(self._collectors.items())
        for name, fam in owned:
            yield (name, fam.kind, fam.help, fam.samples())
        for _, fn in sorted(collectors):
            for entry in fn():
                yield entry

    def snapshot(self, include_collectors: bool = False) -> Dict[str, float]:
        """Flat ``{'name{label="v",...}': value}`` view, the input of a
        ledger-delta check (histograms contribute their
        ``_sum``/``_count``/``_bucket`` samples)."""
        out: Dict[str, float] = {}
        for name, _kind, _help, samples in self.collect(include_collectors):
            for labels, value in samples:
                labels = dict(labels)
                sample_name = labels.pop("__name__", name)
                body = ",".join('%s="%s"' % (k, v)
                                for k, v in sorted(labels.items()))
                out[sample_name + ("{%s}" % body if body else "")] = value
        return out

    def reset(self) -> None:
        """Drop every family and collector (test isolation only)."""
        with self._lock:
            self._families.clear()
            self._collectors.clear()


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem mirrors into."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry()
    return _DEFAULT


def stream_families(registry: Optional[MetricsRegistry] = None) -> Dict[str, _Family]:
    """The streaming reconstructor's families (declared in the JAX
    package's ``stream/service.py`` and ``stream/scheduler.py``), keyed by
    their role: ``ledger`` (every stats-counter bump, labelled by key),
    ``solve_s`` (a micro-batch's solve wall), ``seal_emit_s`` (a window's
    seal-to-emit latency), ``slo_breach`` (seal-to-emit p99 excursions
    past the SLO), ``backpressure`` (sealed-window admissions: queued,
    spilled, dropped) and ``watchdog`` (micro-batch timeouts, retries,
    poisoned windows)."""
    reg = registry if registry is not None else get_registry()
    return dict(
        ledger=reg.counter(
            "tw_stream_ledger_total",
            "stream service ledger mirror (one series per stats counter key)",
            labels=("key",)),
        solve_s=reg.histogram(
            "tw_solve_seconds", "micro-batch solve wall time"),
        seal_emit_s=reg.histogram(
            "tw_seal_emit_seconds", "per-window seal-to-emit latency",
            labels=("tenant",)),
        slo_breach=reg.counter(
            "tw_slo_breach_total",
            "seal-to-emit p99 excursions past the SLO, one per excursion",
            labels=("tenant",)),
        backpressure=reg.counter(
            "tw_stream_backpressure_total",
            "sealed-window admission outcomes (queued/spilled/dropped)",
            labels=("outcome",)),
        watchdog=reg.counter(
            "tw_stream_watchdog_total",
            "micro-batch watchdog outcomes (timeouts/retries/poisoned windows)",
            labels=("outcome",)),
    )


def capture_families(registry: Optional[MetricsRegistry] = None) -> Dict[str, _Family]:
    """The capture ingress's families (declared in the JAX package's
    ``collector/source.py``), keyed by their role: ``loss`` (losses per
    source and reason), ``spans`` (spans delivered), ``rekeyed``
    (connections re-keyed mid-capture) and ``skew`` (the fitted clock
    offset of each source)."""
    reg = registry if registry is not None else get_registry()
    return dict(
        loss=reg.counter(
            "tw_capture_loss_total",
            "capture ingress losses per source and reason; the span-shaped "
            "reasons drive the per-source loss rate that discounts "
            "emitted-trace confidence",
            labels=("source", "reason")),
        spans=reg.counter(
            "tw_capture_spans_total",
            "spans the capture ingress delivered to the stream layer, per source",
            labels=("source",)),
        rekeyed=reg.counter(
            "tw_capture_rekeyed_total",
            "connections re-keyed mid-capture (fd reuse / reconnect without "
            "an observed close), per source",
            labels=("source",)),
        skew=reg.gauge(
            "tw_clock_skew_us",
            "fitted per-source clock offset vs the reference capture clock "
            "(subtracted from every timestamp before watermarking)",
            labels=("source",)),
    )


def adapt_families(registry: Optional[MetricsRegistry] = None) -> Dict[str, _Family]:
    """The adaptation controller's family (declared in the JAX package's
    ``adapt/controller.py``): ``actions``, one count per actuation of a
    key's ladder, labelled by key and rung."""
    reg = registry if registry is not None else get_registry()
    return dict(
        actions=reg.counter(
            "tw_adapt_actions_total",
            "adaptation-ladder actuations (refit scheduled/landed/failed, "
            "fallback enter/exit, recovery) per drifting service key",
            labels=("service", "rung")),
    )


def serve_families(registry: Optional[MetricsRegistry] = None) -> Dict[str, _Family]:
    """The serve tier's families (declared in the JAX package's
    ``serve/tenancy.py``, ``serve/continuous.py``, ``serve/http.py``,
    ``stream/wal.py``'s callers, ``ingest/wire.py`` and
    ``ops/devcols.py``), keyed by their role: ``tenant_ledger`` (every
    per-tenant counter bump), ``pump`` (the service's pump and ring
    ledger), ``dispatcher_degraded`` (1 while the continuous dispatcher is
    dead and serving runs the fixed pump), ``wire_ingest`` (span POSTs by
    parse path), ``wire_engine`` (columnar payloads by parse engine),
    ``inflight`` (dispatch-ring tickets outstanding), ``overlap``
    (percent of ring dispatch wall that overlapped another ticket),
    ``retry_after`` (the ``Retry-After`` seconds of 429 answers),
    ``admission`` (continuous admission outcomes), ``batch_fill``
    (windows a continuous dispatch), ``error_body`` (error replies by
    body source), ``ring_fill`` (a device-resident column ring's live
    share) and ``ring_events`` (column-ring appends, re-epochs, wrap
    gaps, rebuilds, ineligible partitions), ``tenant_windows`` (the
    fleet's per-tenant window buckets) and ``dispatch_s`` (a group's
    dispatch launch time)."""
    reg = registry if registry is not None else get_registry()
    return dict(
        tenant_ledger=reg.counter(
            "tw_serve_tenant_ledger_total",
            "per-tenant serve counters mirror (posts/ingest/quarantine/...)",
            labels=("tenant", "key")),
        pump=reg.counter(
            "tw_serve_pump_total",
            "tenancy pump ledger mirror (shared/isolated solves, windows, ...)",
            labels=("key",)),
        dispatcher_degraded=reg.gauge(
            "tw_serve_dispatcher_degraded",
            "1 while the continuous dispatcher thread has crashed and serve is "
            "degraded to the fixed inline pump"),
        wire_ingest=reg.counter(
            "tw_wire_ingest_total",
            "span POSTs by parse path: columnar (ingest/wire.py) or object "
            "(parse_trace_payload: strict mode, repair-shim fixes, converter "
            "payloads)",
            labels=("path",)),
        wire_engine=reg.counter(
            "tw_wire_parse_total",
            "columnar wire payloads parsed, by engine (native|python)",
            labels=("engine",)),
        inflight=reg.gauge(
            "tw_serve_inflight",
            "dispatch-ring tickets currently outstanding"),
        overlap=reg.gauge(
            "tw_serve_overlap_pct",
            "percent of ring device-dispatch wall that ran concurrently with "
            "another ticket (100*(1 - union/busy))"),
        retry_after=reg.histogram(
            "tw_serve_retry_after_seconds",
            "Retry-After seconds advertised on 429 backpressure responses",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)),
        admission=reg.counter(
            "tw_serve_admission_total",
            "continuous-batching admission outcomes (urgent/fill/deferred "
            "windows)",
            labels=("outcome",)),
        batch_fill=reg.histogram(
            "tw_serve_dispatch_fill_windows",
            "windows admitted per continuous dispatch"),
        error_body=reg.counter(
            "tw_serve_error_body_total",
            "error replies by body source: hit = cached bytes reused, "
            "render = json.dumps ran on the request thread",
            labels=("event",)),
        ring_fill=reg.gauge(
            "tw_devcols_ring_fill",
            "device-resident column ring occupancy (live entries / capacity)",
            labels=("ring",)),
        ring_events=reg.counter(
            "tw_devcols_events_total",
            "column-ring lifecycle events (appends/re-epochs/evictions/"
            "ineligible batches)",
            labels=("kind",)),
        tenant_windows=reg.counter(
            "tw_tenant_windows_total",
            "per-tenant fleet window buckets (packed/redispatched/decoded)",
            labels=("key", "tenant")),
        dispatch_s=reg.histogram(
            "tw_dispatch_seconds",
            "per-group fleet dispatch launch time (host side)"),
    )
