"""Plan cache: fitted per-service distributions carried across solves
(mirrors ``traceweaver_tpu/algorithms/plancache.py``).

A solve round's host stage fits every service's delay distributions
before the first dispatch. The fit is a function of the observed spans,
which change slowly, so :class:`PlanCache` keeps it:

- keyed per service (``FleetItem.plan_key``, else the service name);
- admitted from the fit that ran anyway: a single-pass item's bootstrap
  fit, or a two-pass item's refit tables decoded from the device
  (:func:`~traceweaver_tpu_torch.algorithms.weaver_torch.dists_from_tables`);
- consulted before the next fit: a hit skips the host fit and runs one
  warm pass instead of the two-pass EM;
- invalidated per service or all at once;
- checkpointed through :meth:`PlanCache.state` / :meth:`PlanCache.from_state`.

``PlanCache(enabled=False)`` is the JAX package's ``TW_PLAN_CACHE=0``:
every lookup misses and every admission is dropped, uncounted. The
``tw_plan_cache_total`` metric mirror is left out with the rest of the
metrics registry.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

#: ``TW_PLAN_MIN_SAMPLES``: the fewest window spans a frozen plan may be
#: fitted from
PLAN_MIN_SAMPLES = 64


def admissible(n_samples: int, min_samples: int = PLAN_MIN_SAMPLES) -> bool:
    """Is a plan fitted from ``n_samples`` spans enough to freeze? A
    small-sample fit held in place stops the warm start from tracking
    the window it serves, so only full windows of evidence amortize."""
    return int(n_samples) >= min_samples


class PlanCache:
    """Per-service fitted-plan store with hit, miss, admission and
    invalidation counters.

    Values are the solver's ``dists`` dicts (``{(parent_ep, child_ep):
    EdgeDist}``). A stored dict is never mutated: admission replaces the
    entry whole, so a reader of the old plan keeps a consistent one. Safe
    to share between threads (the fleet's flow workers admit into it)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._dists: Dict[str, Dict] = {}
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.invalidations = 0

    def lookup(self, key: str) -> Optional[Dict]:
        """The fitted dists for ``key``, or None (a miss, or disabled)."""
        if not self.enabled:
            return None
        with self._lock:
            dists = self._dists.get(key)
            if dists is None:
                self.misses += 1
            else:
                self.hits += 1
            return dists

    def admit(self, key: str, dists: Optional[Dict]) -> None:
        """Store a fitted plan (dropped when disabled or empty)."""
        if not self.enabled or not dists:
            return
        with self._lock:
            self._dists[key] = dists
            self.admissions += 1

    def invalidate(self, key: Optional[str] = None) -> None:
        """Drop one service's plan, or every plan when ``key`` is None;
        counted even when the key was absent."""
        with self._lock:
            if key is None:
                self._dists.clear()
            else:
                self._dists.pop(key, None)
            self.invalidations += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._dists)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(hits=self.hits, misses=self.misses,
                        admissions=self.admissions,
                        invalidations=self.invalidations,
                        entries=len(self._dists))

    def state(self) -> Dict:
        """Plain pickle material: the entries and the counters."""
        with self._lock:
            return dict(dists=dict(self._dists),
                        counters=dict(hits=self.hits, misses=self.misses,
                                      admissions=self.admissions,
                                      invalidations=self.invalidations))

    @classmethod
    def from_state(cls, state: Optional[Dict], enabled: bool = True) -> "PlanCache":
        cache = cls(enabled=enabled)
        if not state:
            return cache
        cache._dists = dict(state.get("dists", {}))
        c = state.get("counters", {})
        cache.hits = int(c.get("hits", 0))
        cache.misses = int(c.get("misses", 0))
        cache.admissions = int(c.get("admissions", 0))
        cache.invalidations = int(c.get("invalidations", 0))
        return cache
