"""Online adaptation: the drift-to-adapt control loop (mirrors
``traceweaver_tpu/adapt/__init__.py``; the JAX package's ``TW_ADAPT``,
off by default, is the stream's and the serve tier's ``adapt`` argument).

The confidence sensors (per-trace confidence, the PSI drift watcher of
:mod:`traceweaver_tpu_torch.obs.quality`) raise an alert when a workload
shifts; this package acts on it. A per-service (per tenant on the serve
path) :class:`~traceweaver_tpu_torch.adapt.controller.AdaptationController`
consumes the drift watcher's PSI excursions and each window's
low-confidence rate and walks an adaptation ladder:

1. **refit**: an out-of-band refit of the drifting service
   (:mod:`traceweaver_tpu_torch.adapt.refit`): the retained last window is
   solved again through ``solve_fleet`` under fresh order-statistics
   estimates (or cold, by the two-pass EM, without a DAG), and the fresh
   per-edge statistics replace the stale carried state, off the hot pump;
2. **fallback**: if confidence does not recover within the probation
   windows, the service scores every edge under the wide prior
   (no confident-and-wrong assignments from poisoned priors); counted,
   evented, reversible;
3. **re-arm**: recovery and every fallback retry pass through a
   hysteresis cooldown (``cooldown_s``) so flapping drift cannot thrash
   refits.

Every actuation goes through the controller's evented ledger
(``tw_adapt_actions_total{service,rung}`` and one ``adapt`` record in the
event sink), and the controller's state (probation counts, active
fallbacks, refit generations) rides the stream and serve checkpoints, so
a kill and resume mid-adaptation neither repeats a landed refit nor loses
an active fallback. Off (the default) is inert: the sensors still alert,
nothing actuates, and the sinks are the same bytes.
"""

from traceweaver_tpu_torch.adapt import refit  # noqa: F401
from traceweaver_tpu_torch.adapt.controller import AdaptationController  # noqa: F401
