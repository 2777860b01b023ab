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
``solve_fleet(confidences=, conf_device=)``); ``TW_CONF_LOW`` is
:data:`CONF_LOW`. The scrape surface, the drift watcher and the emitted
trace records belong to the streaming and serving layers, which the port
does not have yet.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from traceweaver_tpu_torch.algorithms import packed_layout as _layout

#: ``TW_CONF_LOW``: spans and traces at or below it count as low confidence
CONF_LOW = 0.35


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
