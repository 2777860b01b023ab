"""Multi-tenant reconstruction service, the network-facing layer
(mirrors ``traceweaver_tpu/serve``).

- :mod:`tenancy`: per-tenant reconstruction pipelines (watermark,
  windows, live store, carried warm-start state, sink and dead letters,
  emitted-trace ring, write-ahead log) multiplexed into shared
  ``solve_fleet`` calls on the card, with per-tenant backpressure,
  isolation and accounting;
- :mod:`continuous`: event-driven admission (SLO-aware, one size class
  a dispatch, round-robin across tenants) with tickets in flight;
- :mod:`http`: the stdlib HTTP front door (Jaeger-JSON span POSTs and
  ``strace`` capture POSTs per tenant, live queries over each tenant's ring, stats, ``/metrics``,
  ``/readyz``, graceful SIGTERM drain);
- :mod:`ring`: the bounded per-tenant ring of emitted traces.

CLI: ``python -m traceweaver_tpu_torch.runtime.cli serve --port 8321
--state-dir state/ [--device cpu]``.
"""

from traceweaver_tpu_torch.serve.ring import (  # noqa: F401
    TraceRing,
    build_trace_records,
)
from traceweaver_tpu_torch.serve.tenancy import (  # noqa: F401
    ServeConfig,
    TenancyError,
    Tenant,
    TenantService,
)
from traceweaver_tpu_torch.serve.http import (  # noqa: F401
    ReconstructionServer,
    make_server,
    run_server,
)
