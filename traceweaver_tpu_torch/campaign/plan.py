"""Declarative campaign specs: rung ladder x device topology x knobs
(mirrors ``traceweaver_tpu/campaign/plan.py``).

A campaign is the standing heavy-traffic instrument: a rung ladder of
Alibaba-scale corpora (``campaign/corpus.py``) driven through the
fleet's compacted path, data-parallel across a mesh
(``campaign/runner.py``), with every sustained-throughput, accuracy and
byte-ledger number frozen into a ``CAMPAIGN_*.json`` artifact
(``campaign/ledger.py``) that ``campaign compare`` diffs against any
later run.

A plan is a JSON object; an unknown field is an error
(:class:`PlanError`), and every field that shapes the measured numbers
(seeds, rung sizes, device count, slice count, knob profile) is in the
artifact, so a compare always knows whether it compares like with like.

The JAX package's knob profile sets ``TW_*`` environment variables for
the run. The port reads none: the knobs a plan may name are the ones
:data:`KNOB_ARGS` maps onto an argument of the campaign's solve (or of
the runner), and a plan naming any other knob raises, as a plan naming
a knob unknown to the JAX package's registry raises there.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional


class PlanError(ValueError):
    """A malformed campaign plan (unknown field, bad topology, ...)."""


def _parse_bool(text: str) -> bool:
    low = str(text).strip().lower()
    if low in ("1", "true", "yes", "on"):
        return True
    if low in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"{text!r} is not a boolean")


#: knob -> (keyword, parser): the ``solve_fleet`` keyword each JAX knob a
#: plan may name becomes (``rounds``/``warmup_max`` are the runner's own;
#: ``TW_MESH_DEVICES`` is recorded, the mesh comes from ``devices``)
KNOB_ARGS = {
    "TW_COMPACT": ("compaction", _parse_bool),
    "TW_SWEEP_WARM": ("sweep_warm", int),
    "TW_PIPELINE": ("pipeline", _parse_bool),
    "TW_DECODE_WORKERS": ("decode_workers", int),
    "TW_FLEET_BUDGET": ("fleet_budget_elems", int),
    "TW_FLEET_MERGE": ("merge_budget", int),
    "TW_RETRY_MAX": ("retry_max", int),
    "TW_RETRY_BACKOFF_S": ("retry_backoff_s", float),
    "TW_CONF_DEVICE": ("conf_device", _parse_bool),
    "TW_DEVCOLS": ("devcols", _parse_bool),
    "TW_DEVCOLS_RING": ("ring_capacity", int),
    "TW_PRECISION": ("precision", str),
    "TW_SCORE_GEMM": ("score_gemm", _parse_bool),
    "TW_PALLAS_FUSED": ("fused_kernel", _parse_bool),
    "TW_CAMPAIGN_ROUNDS": ("rounds", int),
    "TW_CAMPAIGN_WARMUP_MAX": ("warmup_max", int),
    "TW_MESH_DEVICES": ("mesh_devices", int),
}


@dataclass
class RungSpec:
    """One rung of the corpus ladder (see ``campaign/corpus.py``).

    ``source``: ``auto`` (default) and ``synthetic`` use the synthesizer
    ladder; ``real`` names the reference's preprocessed Alibaba shards,
    which the port does not read (``campaign/corpus.py``).
    ``gap_ms``: mean inter-trace arrival gap, the load-intensity knob
    (small gaps interleave requests: the statistically hard regime).
    """

    name: str
    n_graphs: int = 15
    traces_per_graph: int = 1000
    gap_ms: int = 2000
    seed: int = 10
    n_services: int = 60
    source: str = "auto"

    def validate(self) -> None:
        if not self.name or "/" in self.name:
            raise PlanError(f"rung name {self.name!r} must be a non-empty "
                            "path-safe token")
        if self.n_graphs < 1 or self.traces_per_graph < 1:
            raise PlanError(f"rung {self.name!r}: n_graphs and "
                            "traces_per_graph must be >= 1")
        if self.gap_ms < 1:
            raise PlanError(f"rung {self.name!r}: gap_ms must be >= 1")
        if self.n_services < 3:
            raise PlanError(f"rung {self.name!r}: n_services must be >= 3")
        if self.source not in ("auto", "synthetic", "real"):
            raise PlanError(f"rung {self.name!r}: source must be "
                            "auto|synthetic|real")


@dataclass
class CampaignPlan:
    """The whole campaign: rung ladder x device topology x knob profile.

    ``devices``: mesh size for the fleet's sharded dispatch (0/1 = one
    device; >= 2 must be a power of two, ``TW_MESH_DEVICES``'s shape
    constraint). ``slices``: the corpus-level data-parallel tier
    exercised through ``parallel/multislice.py``: the rung's solved
    per-edge delay statistics are sharded per slice and allreduced
    through the filesystem transport, the merged statistics checked
    identical on every slice. ``knobs``: overrides of :data:`KNOB_ARGS`
    applied (and recorded) for the run. ``timed_rounds``/``warmup_max``:
    None takes ``TW_CAMPAIGN_ROUNDS``/``TW_CAMPAIGN_WARMUP_MAX``'s
    defaults (3 and 5) or the knob profile's values.
    """

    name: str = "campaign"
    rungs: List[RungSpec] = field(default_factory=list)
    devices: int = 0
    slices: int = 1
    timed_rounds: Optional[int] = None
    warmup_max: Optional[int] = None
    knobs: Dict[str, str] = field(default_factory=dict)

    def validate(self) -> None:
        if not self.rungs:
            raise PlanError("a campaign needs at least one rung")
        names = [r.name for r in self.rungs]
        if len(set(names)) != len(names):
            raise PlanError(f"duplicate rung names: {sorted(names)}")
        for rung in self.rungs:
            rung.validate()
        if self.devices < 0 or (self.devices > 1
                                and self.devices & (self.devices - 1)):
            raise PlanError(f"devices={self.devices} must be 0/1 or a "
                            "power of two (the mesh shape constraint)")
        if self.slices < 1:
            raise PlanError(f"slices={self.slices} must be >= 1")
        if self.timed_rounds is not None and self.timed_rounds < 1:
            raise PlanError("timed_rounds must be >= 1")
        if self.warmup_max is not None and self.warmup_max < 1:
            raise PlanError("warmup_max must be >= 1")
        for k, v in self.knobs.items():
            if k not in KNOB_ARGS:
                raise PlanError(
                    f"knob profile names unknown knob {k!r} (the knobs a "
                    f"campaign of the port applies: {sorted(KNOB_ARGS)})")
            try:
                KNOB_ARGS[k][1](v)
            except ValueError as e:
                raise PlanError(f"knob {k}={v!r}: {e}") from None

    def knob_args(self) -> Dict[str, object]:
        """The knob profile as keyword arguments (see :data:`KNOB_ARGS`)."""
        return {KNOB_ARGS[k][0]: KNOB_ARGS[k][1](v) for k, v in self.knobs.items()}

    def to_dict(self) -> Dict:
        return asdict(self)


_RUNG_FIELDS = {f for f in RungSpec.__dataclass_fields__}
_PLAN_FIELDS = {f for f in CampaignPlan.__dataclass_fields__}


def from_dict(raw: Dict) -> CampaignPlan:
    """Parse and validate a plan dict (the JSON file's object)."""
    if not isinstance(raw, dict):
        raise PlanError(f"plan must be a JSON object, got {type(raw).__name__}")
    unknown = set(raw) - _PLAN_FIELDS
    if unknown:
        raise PlanError(f"unknown plan field(s): {sorted(unknown)}")
    rungs = []
    for i, r in enumerate(raw.get("rungs") or []):
        if not isinstance(r, dict):
            raise PlanError(f"rungs[{i}] must be an object")
        bad = set(r) - _RUNG_FIELDS
        if bad:
            raise PlanError(f"rungs[{i}]: unknown field(s) {sorted(bad)}")
        rungs.append(RungSpec(**r))
    plan = CampaignPlan(**{**{k: v for k, v in raw.items() if k != "rungs"},
                           "rungs": rungs})
    plan.validate()
    return plan


def load_plan(path: str) -> CampaignPlan:
    with open(path) as f:
        try:
            raw = json.load(f)
        except json.JSONDecodeError as e:
            raise PlanError(f"{path}: not valid JSON ({e})") from None
    return from_dict(raw)


def alibaba_ladder(devices: int = 8, slices: int = 2,
                   seed: int = 10) -> CampaignPlan:
    """The default Alibaba-scale ladder: 100k to 1M-span rungs at
    tightening arrival gaps, data-parallel across the mesh. ``r100k``
    (15 graphs x 1000 traces, gap 500 ms) is the users' smallest real
    rung."""
    return CampaignPlan(
        name="alibaba-ladder",
        rungs=[
            RungSpec("r100k", n_graphs=15, traces_per_graph=1000,
                     gap_ms=500, seed=seed),
            RungSpec("r300k", n_graphs=24, traces_per_graph=2000,
                     gap_ms=200, seed=seed + 1, n_services=120),
            RungSpec("r1m", n_graphs=40, traces_per_graph=4000,
                     gap_ms=100, seed=seed + 2, n_services=240),
        ],
        devices=devices,
        slices=slices,
    )


def mini_plan(devices: int = 2, slices: int = 2, seed: int = 7,
              traces_per_graph: int = 40) -> CampaignPlan:
    """The two-rung synthetic mini campaign: small enough to run end to
    end on the CPU in a test, through every stage (synthesize, sharded
    fleet solve, multislice allreduce, ledger, artifact)."""
    return CampaignPlan(
        name="mini",
        rungs=[
            RungSpec("mini-a", n_graphs=2, traces_per_graph=traces_per_graph,
                     gap_ms=800, seed=seed, n_services=12,
                     source="synthetic"),
            RungSpec("mini-b", n_graphs=3, traces_per_graph=traces_per_graph,
                     gap_ms=400, seed=seed + 1, n_services=12,
                     source="synthetic"),
        ],
        devices=devices,
        slices=slices,
        timed_rounds=2,
    )
