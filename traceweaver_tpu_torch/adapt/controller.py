"""The adaptation controller: sensor → decision → evented actuation.

Import-light by design (stdlib, the obs registry and the event sink): the controller runs inside the stream emission path and the
serve pump, where a heavyweight import would tax every process that
never adapts. The actual refit EXECUTION (fleet dispatch + GMM refit)
lives in :mod:`traceweaver_tpu_torch.adapt.refit` and imports the solver
lazily.

One controller instance watches MANY keys (``"<tenant>:<service>"`` on
the serve path, the bare service name on the single-tenant stream), each
with its own rung walk:

``healthy`` → (PSI or low-confidence-rate excursion, outside cooldown)
→ ``refit_pending`` → (executor picks it up) → ``refitting`` →
``probation`` (the refit landed; recover within
``probation`` windows → ``healthy`` + cooldown) →
``fallback`` (still in excursion past probation: the score model runs
wide-prior until the excursion clears or the cooldown-spaced retry
schedules the next refit).

Every transition that ACTS (schedules a refit, lands one, enters or
leaves fallback, recovers) goes through :meth:`AdaptationController._act`
— the single evented ledger: one ``tw_adapt_actions_total{service,rung}``
increment plus one structured ``kind="adapt"`` record in the
event sink. No silent state transitions (the JAX package's twlint TW010 flags
actuation primitives outside ledgered functions).

Wall-clock state (cooldown deadlines, fallback retry timers) is stored
as monotonic instants in memory but checkpointed as REMAINING durations
and re-stamped on resume — the same convention as the stream's
``sealed_wall`` seal stamps, because a dead process's monotonic values
are meaningless in the next one.

Mirrors ``traceweaver_tpu/adapt/controller.py``; the port keeps its own copy.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from traceweaver_tpu_torch.obs import events as _events
from traceweaver_tpu_torch.obs.quality import DRIFT_PSI
from traceweaver_tpu_torch.obs.registry import adapt_families

_OBS_ACTIONS = adapt_families()["actions"]

#: ``TW_ADAPT_COOLDOWN_S``: the hysteresis between actuations of one key
ADAPT_COOLDOWN_S = 60.0
#: ``TW_ADAPT_PROBATION``: windows a landed refit has to recover
ADAPT_PROBATION = 6
#: ``TW_ADAPT_LOW_RATE``: the low-confidence share that is an excursion
ADAPT_LOW_RATE = 0.5

#: rung names (the state machine's vocabulary; checkpoints carry them)
HEALTHY = "healthy"
REFIT_PENDING = "refit_pending"
REFITTING = "refitting"
PROBATION = "probation"
FALLBACK = "fallback"


class _KeyState:
    """One key's position on the adaptation ladder."""

    __slots__ = ("rung", "fallback", "probation_left", "generation",
                 "cooldown_until", "retry_at", "last_psi", "last_low_rate")

    def __init__(self) -> None:
        self.rung = HEALTHY
        self.fallback = False      # wide priors in force (sticky through
        self.probation_left = 0    # a fallback-scheduled retry refit)
        self.generation = 0        # completed refits for this key
        self.cooldown_until = 0.0  # monotonic; healthy re-trigger gate
        self.retry_at = 0.0        # monotonic; fallback's next refit try
        self.last_psi: Optional[float] = None
        self.last_low_rate: Optional[float] = None


class AdaptationController:
    """Per-key adaptation ladder over the confidence drift sensors.

    The thresholds are the JAX package's knobs with their defaults: the
    PSI excursion threshold is the drift watcher's own
    (:data:`~traceweaver_tpu_torch.obs.quality.DRIFT_PSI`, so the
    controller acts on exactly the signal the operator sees), the
    low-confidence-rate threshold :data:`ADAPT_LOW_RATE`, and the
    probation and cooldown horizons :data:`ADAPT_PROBATION` and
    :data:`ADAPT_COOLDOWN_S`. ``clock`` is injectable for tests.
    """

    def __init__(self, psi_threshold: float = DRIFT_PSI,
                 low_rate: float = ADAPT_LOW_RATE,
                 probation: int = ADAPT_PROBATION,
                 cooldown_s: float = ADAPT_COOLDOWN_S,
                 clock=time.monotonic) -> None:
        self.psi_threshold = float(psi_threshold)
        self.low_rate = float(low_rate)
        self.probation = int(probation)
        self.cooldown_s = float(cooldown_s)
        self._clock = clock
        self._keys: Dict[str, _KeyState] = {}
        # action counters (the summary/checkpoint ledger; the registry
        # mirror is per-key — these are the cross-key totals)
        self.refits_scheduled = 0
        self.refits_done = 0
        self.refits_failed = 0
        self.fallbacks = 0
        self.restores = 0
        self.recoveries = 0
        # plan-cache invalidation hook (algorithms/plancache.py): the
        # owning service attaches a callable taking the controller key;
        # fired on the actuations that void a cached fitted plan. Never
        # rides state()/from_state (it closes over the live service) —
        # the resume path re-attaches it.
        self.invalidate_cb = None

    # -- the evented ledger: EVERY actuation passes through here ---------
    def _act(self, rung: str, key: str, **fields) -> None:
        """The single actuation ledger: one labelled counter increment
        plus one structured record per action in the event sink — the
        no-silent-state-transitions contract."""
        _OBS_ACTIONS.inc(1.0, service=key, rung=rung)
        _events.emit("adapt", rung, key=key, **fields)
        if self.invalidate_cb is not None and rung in (
                "refit", "fallback", "refit_failed"):
            # these rungs mean the fitted plan is suspect: a scheduled
            # refit (drift excursion), a drop to wide priors, or a refit
            # that failed to land — each voids the cached plan for
            # exactly this key (targeted, not cadence, invalidation)
            self.invalidate_cb(key)

    # -- sensor input -----------------------------------------------------
    def _excursion(self, psi: Optional[float],
                   low_rate: Optional[float]) -> bool:
        return ((psi is not None and psi > self.psi_threshold)
                or (low_rate is not None and low_rate > self.low_rate))

    def observe(self, key: str, psi: Optional[float] = None,
                low_rate: Optional[float] = None) -> str:
        """Fold one emitted window's drift signals for ``key`` and walk
        the ladder. ``psi`` is the drift watcher's current statistic
        (None while its reference is still filling); ``low_rate`` is
        the window's fraction of spans at or under ``TW_CONF_LOW``.
        Returns the key's rung after the update."""
        st = self._keys.setdefault(key, _KeyState())
        st.last_psi = psi
        st.last_low_rate = low_rate
        now = self._clock()
        excursion = self._excursion(psi, low_rate)

        if st.rung == HEALTHY:
            if excursion and now >= st.cooldown_until:
                st.rung = REFIT_PENDING
                self.refits_scheduled += 1
                self._act("refit", key, psi=_r(psi), low_rate=_r(low_rate),
                          generation=st.generation)
        elif st.rung == PROBATION:
            st.probation_left -= 1
            if not excursion:
                st.rung = HEALTHY
                st.cooldown_until = now + self.cooldown_s
                self.recoveries += 1
                self._act("recover", key, psi=_r(psi),
                          low_rate=_r(low_rate),
                          generation=st.generation)
            elif st.probation_left <= 0:
                st.rung = FALLBACK
                st.fallback = True
                st.retry_at = now + self.cooldown_s
                self.fallbacks += 1
                self._act("fallback", key, psi=_r(psi),
                          low_rate=_r(low_rate),
                          generation=st.generation)
        elif st.rung == FALLBACK:
            if not excursion:
                # the drift cleared under wide priors (the fallback
                # period's window-local assignments re-taught the
                # carried statistics): restore the learned score model
                st.rung = HEALTHY
                st.fallback = False
                st.cooldown_until = now + self.cooldown_s
                self.restores += 1
                self._act("restore", key, psi=_r(psi),
                          low_rate=_r(low_rate),
                          generation=st.generation)
            elif now >= st.retry_at:
                # cooldown-spaced ladder re-entry: schedule the next
                # refit attempt; wide priors stay in force until it
                # LANDS (refit_done), so the hot path never resumes
                # poisoned warm state early
                st.rung = REFIT_PENDING
                st.retry_at = now + self.cooldown_s
                self.refits_scheduled += 1
                self._act("refit", key, psi=_r(psi),
                          low_rate=_r(low_rate), retry=True,
                          generation=st.generation)
        # REFIT_PENDING / REFITTING: the executor owns the transition
        return st.rung

    # -- actuation plumbing (driven by adapt/refit.py) --------------------
    def pending_refits(self) -> List[str]:
        """Keys whose refit is scheduled but not yet begun, in key
        order (deterministic executor walks)."""
        return sorted(k for k, st in self._keys.items()
                      if st.rung == REFIT_PENDING)

    def begin_refit(self, key: str) -> bool:
        """``refit_pending`` → ``refitting``; False when the key is not
        pending (at-most-once begin — concurrent executors and resumed
        processes cannot double-run one scheduled refit)."""
        st = self._keys.get(key)
        if st is None or st.rung != REFIT_PENDING:
            return False
        st.rung = REFITTING
        return True

    def refit_done(self, key: str, ok: bool, **fields) -> None:
        """A refit attempt finished: on success the key enters
        probation with the FRESH statistics in force (warm overrides
        lift — fallback, if it was active, ends here); on failure the
        key falls back to wide priors until the cooldown-spaced retry."""
        st = self._keys.setdefault(key, _KeyState())
        if ok:
            st.rung = PROBATION
            st.fallback = False
            st.probation_left = self.probation
            st.generation += 1
            self.refits_done += 1
            self._act("refit_done", key, generation=st.generation,
                      probation=self.probation, **fields)
        else:
            st.rung = FALLBACK
            st.fallback = True
            st.retry_at = self._clock() + self.cooldown_s
            self.refits_failed += 1
            self.fallbacks += 1
            self._act("refit_failed", key, generation=st.generation,
                      **fields)

    def fallback_active(self, key: str) -> bool:
        """Wide priors are in force while a key sits on the fallback
        rung — and through the retry refit it schedules (the stale
        carried state must not resurface between retry and landing; the
        flag clears only when a refit LANDS, the excursion ends, or a
        restore fires). A first-ever refit scheduled from healthy has
        no fallback history: carried state keeps serving while the
        out-of-band refit runs."""
        st = self._keys.get(key)
        return st is not None and st.fallback

    def warm_dists(self, key: str, dists):
        """The hot path's warm-state override: the carried per-edge
        statistics pass through untouched unless the key's score model
        is on the wide-prior fallback rung, in which case EVERY edge
        scores under the packer's near-flat wide Gaussian (an empty
        carried dict — ``weaver_tpu.pack_problem``'s unseen-edge
        fallback — which also keeps the solve single-pass, so the
        fallback mints no new program shapes)."""
        if self.fallback_active(key):
            return {}
        return dists

    # -- introspection / checkpoints --------------------------------------
    def summary(self) -> Dict:
        return dict(
            enabled=True,
            refits_scheduled=self.refits_scheduled,
            refits_done=self.refits_done,
            refits_failed=self.refits_failed,
            fallbacks=self.fallbacks,
            restores=self.restores,
            recoveries=self.recoveries,
            active_fallbacks=sorted(
                k for k, st in self._keys.items() if st.fallback),
            rungs={k: st.rung for k, st in sorted(self._keys.items())},
            generations={k: st.generation
                         for k, st in sorted(self._keys.items())
                         if st.generation},
        )

    def state(self) -> Dict:
        """Checkpoint form. Monotonic deadlines become REMAINING
        durations; an in-flight ``refitting`` key saves as
        ``refit_pending`` (the refit never completed — the resumed
        process must run it, once)."""
        now = self._clock()
        keys = {}
        for k, st in self._keys.items():
            keys[k] = dict(
                rung=(REFIT_PENDING if st.rung == REFITTING else st.rung),
                fallback=st.fallback,
                probation_left=st.probation_left,
                generation=st.generation,
                cooldown_remaining_s=max(0.0, st.cooldown_until - now),
                retry_remaining_s=max(0.0, st.retry_at - now),
            )
        return dict(
            psi_threshold=self.psi_threshold,
            low_rate=self.low_rate,
            probation=self.probation,
            cooldown_s=self.cooldown_s,
            keys=keys,
            counters=(self.refits_scheduled, self.refits_done,
                      self.refits_failed, self.fallbacks, self.restores,
                      self.recoveries),
        )

    @classmethod
    def from_state(cls, state: Dict,
                   clock=time.monotonic) -> "AdaptationController":
        ctrl = cls(psi_threshold=state["psi_threshold"],
                   low_rate=state["low_rate"],
                   probation=state["probation"],
                   cooldown_s=state["cooldown_s"], clock=clock)
        now = clock()
        for k, kw in state["keys"].items():
            st = _KeyState()
            st.rung = kw["rung"]
            st.fallback = kw["fallback"]
            st.probation_left = kw["probation_left"]
            st.generation = kw["generation"]
            st.cooldown_until = now + kw["cooldown_remaining_s"]
            st.retry_at = now + kw["retry_remaining_s"]
            ctrl._keys[k] = st
        (ctrl.refits_scheduled, ctrl.refits_done, ctrl.refits_failed,
         ctrl.fallbacks, ctrl.restores, ctrl.recoveries) = state["counters"]
        return ctrl


def _r(v: Optional[float]) -> Optional[float]:
    return None if v is None else round(float(v), 4)
