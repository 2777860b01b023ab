"""Deterministic fault injection for the fleet's solve supervisor (mirrors
``traceweaver_tpu/runtime/faults.py``, for the sites the fleet uses).

The JAX package reads its plan from ``TW_FAULTS``; the port reads no
environment variable, so a caller builds a :class:`FaultPlan` with
:func:`parse_faults` (the same spec grammar) and hands it to
``solve_fleet(faults=...)``::

    parse_faults("dispatch:0.2,fetch:0.05")   # site:probability
    parse_faults("dispatch:1.0:max=3", seed=7)  # cap injections per site

Sites (anything else raises):

- ``dispatch`` — a fleet group's device dispatch;
- ``fetch``    — a blocking device-to-host fetch;
- ``host``     — the per-service fallback solve (the supervisor's last
  compute rung; injecting here is how tests force quarantine).

One seeded RNG is shared across sites, so a ``(spec, seed)`` pair gives
one fixed draw sequence.

:func:`is_transient_fault` decides which failures the supervisor's
ladder absorbs. On the card that is an injected :class:`FaultError` and
the CUDA caching allocator running out of memory, which can clear once
other work frees memory. A CUDA launch or kernel error (an illegal
address, a cluster the card cannot schedule, any error the kernel
wrappers raise) is not transient: a sticky error kills the CUDA context,
so a retry cannot help. Build errors and every other exception are bugs
and propagate too.
"""

from __future__ import annotations

import random
import threading
from typing import Dict, Optional

import torch

#: every legal injection site
SITES = ("dispatch", "fetch", "host")

#: what the CUDA caching allocator says when it runs out of memory
_ALLOCATOR_OOM = "CUDA out of memory"


class FaultError(RuntimeError):
    """An injected fault; classified as transient by
    :func:`is_transient_fault`, so it walks the supervisor's ladder as a
    real out-of-memory error would."""


class SiteSpec:
    __slots__ = ("p", "max")

    def __init__(self, p: float, max: Optional[int] = None) -> None:
        self.p = p
        self.max = max


class FaultPlan:
    """One parsed spec plus its live injection state."""

    def __init__(self, sites: Dict[str, SiteSpec], seed: int = 0) -> None:
        self.sites = sites
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.injected = {s: 0 for s in sites}

    def should_fail(self, site: str) -> bool:
        spec = self.sites.get(site)
        if spec is None:
            return False
        with self._lock:
            if spec.max is not None and self.injected[site] >= spec.max:
                return False
            if self._rng.random() < spec.p:
                self.injected[site] += 1
                return True
        return False


def parse_faults(spec: str, seed: int = 0) -> Optional[FaultPlan]:
    """Parse a ``site:probability[:max=N],...`` spec. A blank spec means
    no injection (None); unknown sites, bad probabilities and malformed
    options raise ``ValueError``."""
    spec = (spec or "").strip()
    if not spec:
        return None
    sites: Dict[str, SiteSpec] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(f"fault entry {entry!r}: expected site:probability")
        site = parts[0].strip()
        if site not in SITES:
            raise ValueError(f"fault entry {entry!r}: unknown site {site!r}; "
                             f"expected one of {SITES}")
        try:
            p = float(parts[1])
        except ValueError:
            raise ValueError(f"fault entry {entry!r}: probability {parts[1]!r} "
                             "is not a number") from None
        if not 0.0 <= p <= 1.0:
            raise ValueError(f"fault entry {entry!r}: probability {p} not in [0, 1]")
        max_n: Optional[int] = None
        for opt in parts[2:]:
            key, _, val = opt.partition("=")
            if key.strip() != "max":
                raise ValueError(f"fault entry {entry!r}: unknown option {opt!r}; "
                                 "expected max=N")
            try:
                max_n = int(val)
            except ValueError:
                raise ValueError(f"fault entry {entry!r}: max={val!r} is not an "
                                 "integer") from None
            if max_n < 0:
                raise ValueError(f"fault entry {entry!r}: max must be >= 0")
        if site in sites:
            raise ValueError(f"faults: duplicate site {site!r}")
        sites[site] = SiteSpec(p, max_n)
    return FaultPlan(sites, seed=seed)


def maybe_fail(plan: Optional[FaultPlan], site: str) -> None:
    """Raise :class:`FaultError` if ``plan`` draws a failure for
    ``site``; no-op without a plan. Each injection also lands in the
    installed event sink (:mod:`traceweaver_tpu_torch.obs.events`) as a
    ``fault_injected`` record."""
    if plan is not None and plan.should_fail(site):
        from traceweaver_tpu_torch.obs import events as _events

        _events.emit("fault_injected", site, n=plan.injected[site],
                     seed=plan.seed)
        raise FaultError(f"injected fault at site {site!r} "
                         f"(#{plan.injected[site]}, seed {plan.seed})")


def is_transient_fault(exc: BaseException) -> bool:
    """Should the supervisor walk its ladder for this exception? True for
    an injected fault and for the CUDA caching allocator's out-of-memory
    error; False for everything else (see the module docstring)."""
    if isinstance(exc, (FaultError, torch.cuda.OutOfMemoryError)):
        return True
    return isinstance(exc, RuntimeError) and _ALLOCATOR_OOM in str(exc)
