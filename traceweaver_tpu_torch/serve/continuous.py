"""Continuous-batching dispatch scheduler for the multi-tenant service
(mirrors ``traceweaver_tpu/serve/continuous.py``).

The fixed pump checks the total backlog against ``pump_windows`` on
every POST and, past it, solves inline on the ingesting request's
thread, which couples dispatch to arrival patterns: a burst solves a
fat batch, a trickle waits for a flush, and a latency-sensitive tenant
behind a quiet period starves with its windows sealed but unsolved.

This module replaces the pump with event-driven admission
(``ServeConfig.continuous``; the serve CLI turns it on, as
``TW_SERVE_CONTINUOUS`` does in the JAX package): a dispatcher thread owns the solve loop and
admits sealed windows into the next fleet dispatch as the previous one
retires, trading a per-tenant seal→emit latency SLO
(``TW_SERVE_SLO_P99_MS``) against batch-fill efficiency:

- **SLO-at-risk windows jump the queue**: a window whose seal→now age
  approaches the SLO budget (minus the measured solve-time EWMA — the
  admission must land BEFORE the deadline, not start at it) is admitted
  immediately, whatever the batch fill looks like.
- **Batch-fill with adaptive size classes**: absent urgency, the
  scheduler waits for ``fill_target`` windows, and picks them by the
  LIVE window-size distribution — each window's power-of-two size class
  (:func:`~traceweaver_tpu_torch.runtime.bucketing.pow2_bucket` over its span
  count, the same bucketing every dispatch shape uses) feeds a rolling
  histogram, and the dominant class is admitted together while outlier
  classes wait for their own dispatch (or their SLO): co-batching a
  4096-span window with 64-span windows pays 64× padding for everyone,
  exactly the shape-class arbitration the fleet's merge budget does
  device-side, applied at admission time.
- **Fairness**: fill picks round-robin across tenants, oldest window
  first per tenant, so one tenant at 100× the rate cannot monopolize
  admission — and the SLO jump bounds every other tenant's worst case
  regardless.

The dispatcher serializes with ingest on the service's lock (the device
is a serially-dispatched resource; the fleet call pipelines
internally), but POSTs no longer run solves inline — ingest latency
decouples from dispatch cadence.

The JAX package quantizes each admission to a power-of-two window count
and keeps it to one size class so its compiled shapes stay few; the
port keeps both rules, so both packages admit the same batches from the
same queues.
"""

from __future__ import annotations

import threading
import time
from collections import Counter, deque
from typing import Dict, List, Optional, Tuple

from traceweaver_tpu_torch.obs.registry import serve_families
from traceweaver_tpu_torch.runtime.bucketing import pow2_bucket

_OBS_ADMIT = serve_families()["admission"]
_OBS_BATCH_FILL = serve_families()["batch_fill"]


class ContinuousDispatcher:
    """The continuous-batching solve loop over one
    :class:`~traceweaver_tpu_torch.serve.tenancy.TenantService`."""

    #: urgency floor: even with a pessimistic solve-time estimate a
    #: window is never held past this fraction of the SLO budget
    _MIN_HEADROOM_FRAC = 0.25
    #: solve-time EWMA smoothing (the admission deadline subtracts 2×
    #: the estimate so the solve lands inside the SLO, not starts at it)
    _EWMA = 0.3

    def __init__(self, service, slo_ms: Optional[float] = None,
                 fill_target: Optional[int] = None) -> None:
        self.service = service
        slo_ms = slo_ms if slo_ms is not None else service.cfg.slo_p99_ms
        self.slo_s = slo_ms / 1000.0
        self.fill_target = int(fill_target or service.cfg.pump_windows)
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.solve_ewma_s = 0.05
        self.dispatches = 0
        self.urgent_dispatches = 0
        self.crashed = False
        # rolling window-size histogram: pow2 class -> recent count
        # (bounded deque of classes; the distribution the adaptive
        # bucket pick reads)
        self._recent_classes: deque = deque(maxlen=256)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ContinuousDispatcher":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._loop, name="tw-serve-continuous", daemon=True)
            self._thread.start()
        return self

    def stop(self) -> None:
        """Stop admitting and JOIN the loop: an in-flight dispatch
        finishes its consume/emit before this returns, so drain can
        close sinks without racing a late emission."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=60.0)
            self._thread = None

    def kick(self) -> None:
        """Ingest-side nudge: new sealed windows may be admittable."""
        with self._cond:
            self._cond.notify_all()

    # -- admission --------------------------------------------------------
    def _fill_limit(self, n_ready: int) -> int:
        """Admission size cap for this dispatch: the base fill target,
        grown (pow2) up to 4× under a deep backlog — a backlog twice
        the target means admission is the bottleneck, and a fatter
        batch amortizes dispatch overhead without new shapes (counts
        stay on the quantized pow2 lattice; the SLO deadline still
        preempts via the urgency path)."""
        limit = self.fill_target
        while n_ready >= 2 * limit and limit < 4 * self.fill_target:
            limit *= 2
        return limit

    def _deadline_s(self) -> float:
        """Seal→now age past which a window jumps the queue: the SLO
        budget minus twice the solve-time estimate (the dispatch must
        FINISH inside the SLO), floored so a wild estimate can never
        hold windows forever."""
        return max(self.slo_s * self._MIN_HEADROOM_FRAC,
                   self.slo_s - 2.0 * self.solve_ewma_s)

    @staticmethod
    def _size_class(buf) -> int:
        return pow2_bucket(max(1, buf.n_spans))

    def _candidates(self) -> List[Tuple[object, object, float]]:
        """(tenant, buffer, seal-age seconds) of every sealed window
        awaiting solve, oldest first per tenant. Caller holds the
        service lock."""
        now = time.monotonic()
        cands = []
        for tid in sorted(self.service.tenants):
            t = self.service.tenants[tid]
            for buf in t.svc.scheduler.ready():
                sealed = getattr(buf, "sealed_wall", 0.0) or now
                cands.append((t, buf, now - sealed))
        return cands

    def _admit(self) -> Tuple[Optional[List], float]:
        """Pick the next dispatch's windows (or how long to wait).

        Returns ``(plan, wait_s)``: ``plan`` is a ``[(tenant, [bufs])]``
        batch list when a dispatch should run NOW, else None with the
        sleep until the earliest SLO deadline (or a new seal's kick).
        Caller holds the service lock."""
        cands = self._candidates()
        if not cands:
            return None, 0.25
        for _, buf, _ in cands:
            self._recent_classes.append(self._size_class(buf))
        deadline = self._deadline_s()
        urgent = [c for c in cands if c[2] >= deadline]
        if not urgent and len(cands) < self.fill_target:
            # not enough for a well-filled batch and nobody at risk:
            # wait for more seals or the earliest deadline
            wait = min(deadline - age for _, _, age in cands)
            return None, max(0.005, min(wait, 0.25))

        picked: List[Tuple[object, object]] = []
        picked_ids = set()

        def pick(t, buf, outcome):
            picked.append((t, buf))
            picked_ids.add(id(buf))
            _OBS_ADMIT.inc(outcome=outcome)

        # every dispatch is CLASS-COHERENT: one pow2 size class per
        # dispatch, so the device programs compile against the class
        # lattice itself, never against the combinatorics of class
        # MIXTURES (the fleet's shape-class merge would otherwise mint
        # a new merged-group shape per admission composition — the
        # steady state must run at zero compiles). The dispatch class
        # is the oldest urgent window's, else the dominant class of the
        # live size distribution.
        if urgent:
            self.urgent_dispatches += 1
            oldest = max(urgent, key=lambda c: c[2])
            batch_class = self._size_class(oldest[1])
            # other urgent classes dispatch on the immediately-following
            # loop iterations (wait 0 while any urgency remains)
            for t, buf, age in sorted(urgent, key=lambda c: -c[2]):
                if self._size_class(buf) == batch_class:
                    pick(t, buf, "urgent")
        else:
            hist = Counter(self._recent_classes)
            live = {self._size_class(buf) for _, buf, _ in cands}
            batch_class = max(live,
                              key=lambda c: (hist.get(c, 0), -c))
        # batch-fill within the class, round-robin across tenants
        # (fairness: a hot tenant fills at most its share per cycle),
        # oldest first within a tenant
        per_tenant: Dict[str, deque] = {}
        for t, buf, age in cands:
            if id(buf) not in picked_ids \
                    and self._size_class(buf) == batch_class:
                per_tenant.setdefault(t.id, deque()).append((t, buf))
        deferred = len(cands) - len(picked) \
            - sum(len(q) for q in per_tenant.values())
        limit = self._fill_limit(len(cands))
        order = sorted(per_tenant)
        while len(picked) < limit and any(
                per_tenant[tid] for tid in order):
            for tid in order:
                if len(picked) >= limit:
                    break
                if per_tenant[tid]:
                    pick(*per_tenant[tid].popleft(), "fill")
        if deferred:
            _OBS_ADMIT.inc(float(deferred), outcome="deferred")
        if not picked:
            # dominant class momentarily empty (e.g. every candidate is
            # a different class): fall back to the oldest window's class
            return None, 0.02
        return self._group_plan(self._quantize(picked)), 0.0

    @staticmethod
    def _quantize(picked: List) -> List:
        """Truncate an admission to a power-of-two window count (the
        oldest picks keep their slots). Together with class coherence
        this makes the (size class × admission count) pair — the whole
        of what admission timing can vary — a SMALL fixed lattice, so
        the dispatch shapes downstream stop depending on scheduler
        timing at all (the zero-steady-compiles contract)."""
        keep = 1 << (len(picked).bit_length() - 1)
        return picked[:keep]

    @staticmethod
    def _group_plan(picked: List[Tuple[object, object]]) -> List:
        """``[(tenant, buf)]`` admission picks -> the ``[(tenant,
        [bufs])]`` batch list :meth:`TenantService.solve_admitted`
        takes, grouped per tenant in admission order."""
        plan: List[Tuple[object, List]] = []
        by_tenant: Dict[str, int] = {}
        for t, buf in picked:
            if t.id not in by_tenant:
                by_tenant[t.id] = len(plan)
                plan.append((t, []))
            plan[by_tenant[t.id]][1].append(buf)
        return plan

    def drain_backlog(self) -> int:
        """Solve everything currently sealed, in admission-sized chunks
        (round-robin, oldest first) — the continuous-mode flush path.
        One giant catch-all dispatch would mint batch shapes the steady
        state never compiles (a 256-row flush program serves exactly one
        flush); fill-sized chunks keep every dispatch on the same
        bounded shape lattice the admission loop runs on.

        Barriers on the dispatch ring each pass: a flush that raced an
        in-flight ticket used to report drained while the ticket's
        windows were still mid-solve (undercounting emitted traces) —
        drained now means queues empty AND zero outstanding tickets."""
        total = 0
        while True:
            self.service.wait_idle(self.service.cfg.drain_timeout_s)
            with self.service._lock:
                cands = self._candidates()
                if not cands:
                    return total
                # class-coherent chunks here too (see _admit): the
                # oldest window's class drains first, fill-sized,
                # round-robin across tenants
                batch_class = self._size_class(
                    max(cands, key=lambda c: c[2])[1])
                per_tenant: Dict[str, deque] = {}
                for t, buf, _age in cands:
                    if self._size_class(buf) == batch_class:
                        per_tenant.setdefault(t.id, deque()).append(
                            (t, buf))
                picked: List[Tuple[object, object]] = []
                limit = self._fill_limit(len(cands))
                order = sorted(per_tenant)
                while len(picked) < limit and any(
                        per_tenant[tid] for tid in order):
                    for tid in order:
                        if len(picked) >= limit:
                            break
                        if per_tenant[tid]:
                            picked.append(per_tenant[tid].popleft())
                plan = self._group_plan(self._quantize(picked))
            total += self.service.solve_admitted(plan)

    # -- the loop ---------------------------------------------------------
    def _loop(self) -> None:
        # crash containment: an uncaught exception
        # here used to die silently with serve still accepting spans —
        # every tenant's sealed windows queued forever while POSTs kept
        # returning 200. Any escape now lands in the service's
        # dispatcher-death handler: counted, evented, the degraded
        # gauge flips on /metrics, and serve falls back to the fixed
        # inline pump so the seal→emit path keeps moving.
        try:
            self._run()
        except Exception as e:  # noqa: BLE001 — containment, not logic
            self.crashed = True
            self.service._on_dispatcher_death(e)

    def _run(self) -> None:
        while True:
            with self._cond:
                if self._stop:
                    return
            # a ring-worker error must crash THIS thread (containment
            # lives here): poll even when idle, so a worker death with
            # no further admissions still degrades serve
            self.service.ring_raise_pending()
            with self.service._lock:
                plan, wait = self._admit()
            if plan:
                if self.service.ring_enabled:
                    # overlapped drain (TW_SERVE_INFLIGHT > 1): submit
                    # takes the windows and launches the ticket on the
                    # worker pool, then THIS thread loops straight back
                    # to admitting batch N+1 while batch N executes —
                    # throttled to the ring bound. EWMA/fill bookkeeping
                    # arrives via note_solve when each ticket completes.
                    ticket = self.service.submit_admitted(plan)
                    if ticket is not None:
                        self.service.launch_ticket(ticket)
                        self.service.ring_throttle()
                    self.service.run_adaptations()
                    continue
                # serial path (TW_SERVE_INFLIGHT=1, the kill switch):
                # solve_admitted still drops the service lock around the
                # device dispatch — ingest keeps flowing while the fleet
                # executes (the throughput half of continuous batching;
                # the fixed pump solves inline on the ingesting
                # request's thread)
                t0 = time.perf_counter()
                n = self.service.solve_admitted(plan)
                if n:
                    self.note_solve(time.perf_counter() - t0, n)
                # the adaptation tick: refits that the retired solve's
                # emissions scheduled run now, as solves of their own,
                # before the next admission
                self.service.run_adaptations()
                continue
            with self._cond:
                if not self._stop:
                    self._cond.wait(timeout=wait)

    def note_solve(self, solve_s: float, n: int) -> None:
        """Fold one retired dispatch into the pacing model (EWMA solve
        wall, dispatch count, batch-fill histogram). The serial loop
        calls this inline; ring tickets call it from complete_ticket —
        under the ring the EWMA tracks per-ticket device wall, which is
        exactly what the admission deadline math needs (a ticket's wall
        is the lead time an SLO-at-risk window must be admitted by)."""
        if n <= 0:
            return
        self.solve_ewma_s = ((1 - self._EWMA) * self.solve_ewma_s
                             + self._EWMA * solve_s)
        self.dispatches += 1
        _OBS_BATCH_FILL.observe(float(n))

    # -- introspection ----------------------------------------------------
    def stats(self) -> Dict:
        return dict(
            slo_p99_ms=round(self.slo_s * 1000.0, 1),
            fill_target=self.fill_target,
            dispatches=self.dispatches,
            urgent_dispatches=self.urgent_dispatches,
            solve_ewma_ms=round(self.solve_ewma_s * 1000.0, 2),
        )
