"""Per-span reconstruction confidence, reduced on the host from the packed
solver block (mirrors ``traceweaver_tpu/obs/quality.py``, the per-span
reductions and the trace and window summaries).

Two tiers, both read from the block the decode already fetched
(:mod:`traceweaver_tpu_torch.algorithms.packed_layout`):

- **base** (always): the OT-overrode-argmax flag, the feasible-candidate
  count and the plan's top-k support (top-k entries above the mass
  floor); ``conf = (0.5 if overridden else 1) / sqrt(max support over
  endpoints)``;
- **device** (the fleet's ``conf_device=True``): the quantized top1-top2
  row score margin and the entropy of ``softmax(S / eps)``;
  ``conf = (0.5 if overridden else 1) * (1 - exp(-min margin))``.

Endpoint reductions are weakest-link: a span is right only if every
endpoint is. The JAX package's ``TW_CONFIDENCE`` and ``TW_CONF_DEVICE``
knobs are arguments of the callers (``WeaverTorch(confidence=)``,
``solve_fleet(confidences=, conf_device=)``,
``StreamingReconstructor(confidence=)``); ``TW_CONF_LOW`` is
:data:`CONF_LOW` (the JAX package's ``low_threshold()``).

The stream's surface: :func:`observe_trace` lands each emitted trace's
confidence on the ``tw_trace_confidence`` histogram and the
``tw_low_confidence_traces_total`` counter, and :class:`ConfidenceDrift`
watches each service's confidence distribution for a shift with the
population-stability index (:func:`psi`), ground-truth-free; its window
and threshold (``TW_CONF_DRIFT_WINDOW``, ``TW_CONF_DRIFT_PSI``) are
constructor arguments.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from traceweaver_tpu_torch.algorithms import packed_layout as _layout
from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.registry import get_registry as _get_registry

#: ``TW_CONF_LOW``: spans and traces at or below it count as low confidence
CONF_LOW = 0.35
#: ``TW_CONF_DRIFT_WINDOW``: confidence values in the frozen reference and
#: in the rolling window of :class:`ConfidenceDrift`
DRIFT_WINDOW = 256
#: ``TW_CONF_DRIFT_PSI``: the PSI above which a key is drifting
DRIFT_PSI = 0.25

#: bucket edges of the trace-confidence histogram (the low tail resolved)
CONF_BUCKETS = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9, 0.99, 1.0)

_OBS = _get_registry()
_OBS_TRACE_CONF = _OBS.histogram(
    "tw_trace_confidence",
    "per-emitted-trace reconstruction confidence (min over the trace's "
    "solved spans)", labels=("tenant",), buckets=CONF_BUCKETS)
_OBS_LOW_CONF = _OBS.counter(
    "tw_low_confidence_traces_total",
    "emitted traces whose confidence is at or below CONF_LOW",
    labels=("tenant",))
_OBS_DRIFT = _OBS.gauge(
    "tw_confidence_drift_psi",
    "PSI of the rolling per-service confidence distribution against its "
    "frozen reference window", labels=("key",))
_OBS_DRIFT_MATURE = _OBS.gauge(
    "tw_confidence_drift_mature",
    "1 once the rolling window behind tw_confidence_drift_psi is full, "
    "0 while the PSI comes from a thin window", labels=("key",))


def _window_maps(windows: Sequence[Tuple[int, int]]):
    w_of = np.concatenate(
        [np.full(hi - lo, b) for b, (lo, hi) in enumerate(windows)])
    i_of = np.concatenate([np.arange(hi - lo) for lo, hi in windows])
    pos = np.concatenate([np.arange(lo, hi) for lo, hi in windows])
    return w_of, i_of, pos


def new_span_arrays(n_in: int, device: bool = False) -> Dict[str, np.ndarray]:
    """Per-span arrays that :func:`scatter_confidence` fills batch by
    batch before :func:`finish_confidence`."""
    out: Dict[str, np.ndarray] = dict(
        not_best=np.zeros(n_in, dtype=bool),
        cands=np.ones(n_in, dtype=np.int64),
        support=np.ones(n_in, dtype=np.int32),
    )
    if device:
        out["margin"] = np.zeros(n_in, dtype=np.float64)
        out["entropy"] = np.zeros(n_in, dtype=np.float64)
    return out


def scatter_confidence(windows: Sequence[Tuple[int, int]],
                       not_best: np.ndarray, feas: np.ndarray,
                       topk_cols: np.ndarray, arrs: Dict[str, np.ndarray],
                       margin_q: Optional[np.ndarray] = None,
                       entropy_q: Optional[np.ndarray] = None) -> None:
    """Scatter one packed batch's reductions into ``arrs`` at the
    windows' span positions: override = any endpoint, candidates =
    product, support = max, margin = min, entropy = max."""
    if not windows:
        return
    w_of, i_of, pos = _window_maps(windows)
    arrs["not_best"][pos] = not_best[w_of, :, i_of].any(axis=1)
    arrs["cands"][pos] = np.maximum(
        feas[w_of, :, i_of], 1).astype(np.int64).prod(axis=1)
    # top-k entries below the plan-mass floor come back -1: the rest
    # are the plan's credible alternatives for that endpoint
    tk = topk_cols[w_of, :, i_of, :]                     # [n, E, K]
    arrs["support"][pos] = np.maximum((tk >= 0).sum(axis=2), 1).max(axis=1)
    if margin_q is not None:
        scale = _layout.CONF_SCALE
        arrs["margin"][pos] = margin_q[w_of, :, i_of].min(axis=1) / scale
        arrs["entropy"][pos] = entropy_q[w_of, :, i_of].max(axis=1) / scale


def confidence_scores(arrs: Dict[str, np.ndarray]) -> np.ndarray:
    """One score in [0, 1] per span, monotone in every input: an OT
    override halves it; more credible alternatives (base tier) or a
    thinner margin (device tier) shrink it."""
    base = np.where(arrs["not_best"], 0.5, 1.0)
    if arrs.get("margin") is not None:
        conf = base * (1.0 - np.exp(-np.maximum(arrs["margin"], 0.0)))
    else:
        conf = base / np.sqrt(np.maximum(arrs["support"], 1))
    return np.clip(conf, 0.0, 1.0)


def finish_confidence(arrs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    arrs["conf"] = confidence_scores(arrs)
    return arrs


def span_confidence_arrays(windows: Sequence[Tuple[int, int]],
                           block: np.ndarray, n_in: int,
                           device: bool = False) -> Dict[str, np.ndarray]:
    """Per-span arrays (``not_best``, ``cands``, ``support``, ``conf``
    and, with ``device``, ``margin``, ``entropy``) of length ``n_in``
    from one item's rows ``[B, E, W, C]`` of a packed block; ``windows``
    tile ``[0, n_in)`` of its sorted incoming spans."""
    ch = _layout.split_packed(block, confidence=device)
    arrs = new_span_arrays(n_in, device=device)
    scatter_confidence(windows, ch["not_best"], ch["feas"], ch["topk_cols"],
                       arrs, margin_q=ch.get("margin_q"),
                       entropy_q=ch.get("entropy_q"))
    return finish_confidence(arrs)


def confidence_records(in_ids: Sequence, arrs: Dict[str, np.ndarray]
                       ) -> Dict[object, Dict]:
    """``{span id: record}`` for one solved item; plain JSON-ready dicts."""
    conf = arrs["conf"]
    has_margin = arrs.get("margin") is not None
    recs = {}
    for j in range(len(in_ids)):
        rec = dict(conf=round(float(conf[j]), 4),
                   not_best=bool(arrs["not_best"][j]),
                   cands=int(arrs["cands"][j]),
                   support=int(arrs["support"][j]))
        if has_margin:
            rec["margin"] = round(float(arrs["margin"][j]), 3)
            rec["entropy"] = round(float(arrs["entropy"][j]), 3)
        recs[in_ids[j]] = rec
    return recs


def zero_confidence() -> Dict:
    """The record of a quarantined (all-NA) span: zero confidence."""
    return dict(conf=0.0, not_best=True, cands=0, support=0)


def trace_confidence(span_ids: Sequence, conf_by_span: Dict) -> Optional[Dict]:
    """Summary of one stitched trace over its solved spans: the min (a
    trace is right only if every span is), the mean and the count; None
    when no span of the trace carries a record."""
    vals = [conf_by_span[sid]["conf"] for sid in span_ids if sid in conf_by_span]
    if not vals:
        return None
    return dict(conf=round(min(vals), 4), mean=round(sum(vals) / len(vals), 4),
                n_scored=len(vals))


def window_confidence_summary(conf_by_span: Dict,
                              low: float = CONF_LOW) -> Dict:
    """Summary of one window's solved spans: count, min, mean, how many
    are at or below ``low`` and how many the OT overrode."""
    vals = [r["conf"] for r in conf_by_span.values()]
    if not vals:
        return dict(n=0)
    return dict(
        n=len(vals),
        min=round(min(vals), 4),
        mean=round(sum(vals) / len(vals), 4),
        low=int(sum(v <= low for v in vals)),
        overridden=int(sum(r["not_best"] for r in conf_by_span.values())),
    )


def observe_trace(conf: float, tenant: str, low: float = CONF_LOW) -> bool:
    """Land one emitted trace's confidence on the histogram and, at or
    below ``low``, the low-confidence counter; returns whether it was low."""
    _OBS_TRACE_CONF.observe(conf, tenant=tenant)
    is_low = conf <= low
    if is_low:
        _OBS_LOW_CONF.inc(1.0, tenant=tenant)
    return is_low


#: PSI bin edges over [0, 1] (right-closed; the last edge catches 1.0)
PSI_EDGES = (0.2, 0.4, 0.6, 0.8, 1.0000001)
_PSI_SMOOTH = 1e-4


def psi(ref_counts: Sequence[float], cur_counts: Sequence[float]) -> float:
    """Population-stability index of two binned distributions,
    ``sum (p_cur - p_ref) * ln(p_cur / p_ref)`` with each share floored
    at 1e-4 (above 0.1 drifting, above 0.25 shifted)."""
    ref_n = max(1.0, float(sum(ref_counts)))
    cur_n = max(1.0, float(sum(cur_counts)))
    total = 0.0
    for r, c in zip(ref_counts, cur_counts):
        p_ref = max(r / ref_n, _PSI_SMOOTH)
        p_cur = max(c / cur_n, _PSI_SMOOTH)
        total += (p_cur - p_ref) * math.log(p_cur / p_ref)
    return total


def _bin_counts(values: Sequence[float]) -> List[float]:
    counts = [0.0] * len(PSI_EDGES)
    for v in values:
        for i, edge in enumerate(PSI_EDGES):
            if v <= edge:
                counts[i] += 1.0
                break
    return counts


class ConfidenceDrift:
    """Rolling per-key watcher of the confidence distribution.

    A key's first ``window`` values freeze as its reference; after that
    its latest ``window`` values are the rolling distribution, and every
    update recomputes the PSI between the two (``tw_confidence_drift_psi``).
    Crossing ``threshold`` emits one ``confidence_drift`` event per
    excursion; it re-arms when the PSI falls back under. The watcher reads
    the solver's own confidences, so it needs no ground truth."""

    def __init__(self, window: int = DRIFT_WINDOW,
                 threshold: float = DRIFT_PSI) -> None:
        self.window = int(window)
        self.threshold = float(threshold)
        self._ref: Dict[str, List[float]] = {}      # frozen bin counts
        self._ref_fill: Dict[str, List[float]] = {}  # values until frozen
        self._cur: Dict[str, List[float]] = {}      # rolling values
        self._alerted: Dict[str, bool] = {}
        self.alerts = 0

    def update(self, key: str, values: Sequence[float]) -> Optional[float]:
        """Fold one window's values for ``key``; returns the PSI once the
        reference is frozen, else None."""
        if not values:
            return self.last_psi(key)
        if key not in self._ref:
            fill = self._ref_fill.setdefault(key, [])
            fill.extend(float(v) for v in values)
            if len(fill) < self.window:
                return None
            self._ref[key] = _bin_counts(fill[:self.window])
            values = fill[self.window:]
            del self._ref_fill[key]
        cur = self._cur.setdefault(key, [])
        cur.extend(float(v) for v in values)
        del cur[:-self.window]
        if not cur:
            return None
        stat = psi(self._ref[key], _bin_counts(cur))
        _OBS_DRIFT.set(stat, key=key)
        _OBS_DRIFT_MATURE.set(1.0 if self.mature(key) else 0.0, key=key)
        if stat > self.threshold and not self._alerted.get(key):
            self._alerted[key] = True
            self.alerts += 1
            _events.emit("confidence_drift", "shift", key=key,
                         psi=round(stat, 4), threshold=self.threshold,
                         window=self.window)
        elif stat <= self.threshold:
            self._alerted[key] = False
        return stat

    def last_psi(self, key: str) -> Optional[float]:
        cur = self._cur.get(key)
        if key not in self._ref or not cur:
            return None
        return psi(self._ref[key], _bin_counts(cur))

    def in_excursion(self, key: str) -> bool:
        """Is ``key``'s alert armed (last PSI above the threshold)? The
        stream keeps refitting such a service instead of using its cached
        plan."""
        return bool(self._alerted.get(key))

    def mature(self, key: str) -> bool:
        """Is ``key``'s rolling window full? Before that its PSI is
        sampling noise."""
        return (key in self._ref
                and len(self._cur.get(key, ())) >= self.window)

    def state(self) -> Dict:
        """Plain pickle material for a checkpoint."""
        return dict(window=self.window, threshold=self.threshold,
                    ref=self._ref, ref_fill=self._ref_fill,
                    cur=self._cur, alerted=self._alerted,
                    alerts=self.alerts)

    @classmethod
    def from_state(cls, state: Dict) -> "ConfidenceDrift":
        d = cls(window=state["window"], threshold=state["threshold"])
        d._ref = state["ref"]
        d._ref_fill = state["ref_fill"]
        d._cur = state["cur"]
        d._alerted = state["alerted"]
        d.alerts = state["alerts"]
        return d
