"""Out-of-band warm-start refit execution (the ladder's first rung).

Why a refit helps: the streaming warm start is a feedback loop — each
window's assignments refit the carried per-edge GMMs that score the NEXT
window. Under a workload shift that loop can lock in wrongness: stale
priors produce a SELF-CONSISTENT wrong assignment whose delay samples
*reinforce* the stale priors (the slot-aliasing failure the
``adapt-burst`` corpus reproduces, :mod:`traceweaver_tpu_torch.synth.capture`:
a latency shift of about one inter-arrival puts
every call where the stale prior expects its neighbor's). Breaking the
loop means re-fitting WITHOUT the carried state — and without the
nearest-preceding-parent bootstrap, which the same aliasing fools.

The refit is one EM iteration seeded from scratch on a retained
post-shift window: (1) re-estimate every edge's delay from the
partitions' ORDER STATISTICS (``timing.estimate_edge_params`` — the
reference's cold estimator; sorted-vector batch means see the true
shifted delay no matter how the old equilibrium paired spans), (2)
re-solve the window as a warm-start dispatch under those estimates —
the SAME single-pass fleet solve the hot path already runs (on the card
K1 and the assembly kernel, on the service's device) — and (3) install the
assignment-refit BIC-GMMs (``timing.refit_from_assignments``, the same
statistics the per-window warm refresh produces) as the new carried
state. For services whose window has no inferred DAG the solve falls
back to the plan's own cold fit (``warm_dists=None`` — the two-pass EM
whose between-pass refit is ``refit_fleet_params``).

Out-of-band: the refit is its own ``solve_fleet`` call over ONE retained
window, never merged into the hot pump's shared dispatch — the serve
layer runs it from the continuous dispatcher's post-solve tick (and the
pump's tail), so SLO admission dispatches keep flowing at their own
cadence and never carry the two-pass load.

Every outcome lands in the controller's evented ledger
(:meth:`~traceweaver_tpu_torch.adapt.controller.AdaptationController
.refit_done`; the JAX package's twlint TW010 pins that its solver calls stay
inside ledgered functions). Transient solve failures walk the fleet
supervisor's own ladder first; if the refit still dies (or its window
quarantines), the key falls back to wide priors rather than keeping the
stale state in force.

Mirrors ``traceweaver_tpu/adapt/refit.py``; the port keeps its own copy.
"""

from __future__ import annotations

import time


def execute_refit(svc, key: str) -> bool:
    """Run one scheduled out-of-band refit on a stream service.

    ``svc`` is a :class:`~traceweaver_tpu_torch.stream.service
    .StreamingReconstructor` (the serve layer's tenants wrap one);
    ``key`` is the controller key (``"<trace_prefix><service>"``). The
    refit material is the service's most recently solved window problem
    (``svc.adapt_material``); with none retained yet — e.g. right after
    a checkpoint resume — the refit stays PENDING and re-runs once the
    next solved window supplies material (at-least-once across a
    kill/resume, at-most-once within a process via ``begin_refit``).

    Returns True when fresh statistics were installed.
    """
    ctrl = svc.adapt
    prefix = svc.trace_prefix
    service = key[len(prefix):] if prefix and key.startswith(prefix) \
        else key
    material = svc.adapt_material.get(service)
    if material is None:
        return False  # no window retained yet: stay pending
    if not ctrl.begin_refit(key):
        return False

    from traceweaver_tpu_torch.algorithms import timing
    from traceweaver_tpu_torch.algorithms.fleet import FleetItem, solve_fleet
    from traceweaver_tpu_torch.runtime import faults

    t0 = time.perf_counter()
    in_parts = {material.in_ep: material.in_spans}
    # EM iteration seed: per-edge order-statistics estimates from the
    # retained window itself (immune to the poisoned pairing — sorted
    # vectors know nothing about the old equilibrium). The slice bound
    # keeps the paired vectors equal-length under skips/dynamism.
    cold = None
    if material.dag is not None:
        hi = min([len(material.in_spans)]
                 + [len(p) for p in material.out_parts.values()])
        if hi > 0:
            cold = timing.estimate_edge_params(
                in_parts, material.out_parts, material.dag, 0, hi)
    item = FleetItem(service, in_parts, material.out_parts,
                     material.truth, material.dag, store=svc.live,
                     # warm-start from the fresh estimates (the hot
                     # path's own single-pass program — zero new
                     # compiles); no DAG → the plan's cold two-pass EM
                     warm_dists=cold,
                     in_cols=material.in_cols, out_cols=material.out_cols)
    quarantined = []
    try:
        outs = solve_fleet([item], all_spans=svc.live.all_spans,
                           all_processes=svc.live.all_processes,
                           stats=svc.fleet_stats, precision=svc.precision,
                           quarantined=quarantined, faults=faults.active(),
                           device=svc.device)
    except Exception as e:  # noqa: BLE001 — classified below
        if not faults.is_transient_fault(e):
            raise
        ctrl.refit_done(key, ok=False, error=type(e).__name__)
        return False
    if quarantined or outs[0] is None:
        ctrl.refit_done(key, ok=False, error="quarantined")
        return False
    dists = timing.refit_from_assignments(
        in_parts, material.out_parts, material.dag, outs[0][0],
        svc.live.all_spans, device=svc.device)
    if dists:
        # install the fresh statistics as the carried warm state: the
        # next window for this service solves under post-shift priors
        svc.carried.update(service, dists)
        # and re-admit the fresh plan (the drift excursion's scheduling
        # actuation invalidated the stale entry) when the retained
        # window carries enough evidence to freeze — the hot path's
        # per-window refit then stays skipped under post-shift
        # statistics; a thin window keeps re-teaching instead
        # (plancache.admissible)
        from traceweaver_tpu_torch.algorithms import plancache as _plancache
        if _plancache.admissible(len(material.in_spans)):
            svc.plan_cache.admit(service, dists)
    ctrl.refit_done(key, ok=bool(dists),
                    solve_s=round(time.perf_counter() - t0, 3),
                    n_spans=len(material.in_spans))
    return bool(dists)
