"""Campaign corpus ladder: build, cache and characterize rung corpora
(mirrors ``traceweaver_tpu/campaign/corpus.py``).

Each :class:`~traceweaver_tpu_torch.campaign.plan.RungSpec` materializes
as one on-disk Alibaba-format corpus from the port's synthesizer
(``alibaba/synthesize.py``), keyed by its spec so repeated campaigns
reuse the bytes. The synthesizer is a pure function of its seed: the
same seed gives the JAX package's corpus byte for byte, and a manifest
equal to the JAX package's. The JAX package also reads the reference
release's preprocessed Alibaba shards when its machine carries them;
the port reads nothing outside the campaign's cache, so ``auto`` means
the synthesizer and ``real`` is refused.

Loading goes through the real ingest path (``load_corpus`` fix=5:
repair, convert, group) into a columnar store. The rung manifest is the
corpus's identity card, written next to the data and embedded in the
artifact: span, trace and service counts and the fan-out/async regime
mix of the classifier the scorecard grades with
(``metrics/accuracy.service_regime``).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from traceweaver_tpu_torch.campaign.plan import PlanError, RungSpec

MANIFEST_SCHEMA = 1


@dataclass
class RungCorpus:
    """One loaded rung: the stores plus the solver-ready problems."""

    spec: RungSpec
    root: str
    manifest: Dict
    stores: List = field(default_factory=list)
    #: one entry per solvable service problem:
    #: {store (index), svc, prob, true, dag, regime {...}}
    problems: List[Dict] = field(default_factory=list)
    cached: bool = False

    @property
    def spans(self) -> int:
        return int(self.manifest["spans"])


def _spec_fingerprint(spec: RungSpec) -> Dict:
    """The cache key: every spec field that shapes the corpus bytes."""
    return dict(name=spec.name, n_graphs=spec.n_graphs,
                traces_per_graph=spec.traces_per_graph, gap_ms=spec.gap_ms,
                seed=spec.seed, n_services=spec.n_services)


def _rung_dir(spec: RungSpec, cache_root: str) -> str:
    return os.path.join(cache_root, f"{spec.name}-seed{spec.seed}")


def _call_graph_dirs(root: str) -> List[str]:
    dirs = sorted((d for d in os.listdir(root) if d.startswith("call_graph_")),
                  key=lambda d: int(d.rsplit("_", 1)[1]))
    return [os.path.join(root, d) for d in dirs]


def _synthesize(spec: RungSpec, out_root: str, print_fn=None) -> List[str]:
    from traceweaver_tpu_torch.alibaba.synthesize import synthesize_corpus

    stats: Dict[str, int] = {}
    dirs = synthesize_corpus(
        out_root, n_graphs=spec.n_graphs,
        traces_per_graph=spec.traces_per_graph, seed=spec.seed,
        base_gap_ms=spec.gap_ms, n_services=spec.n_services, stats=stats)
    if print_fn:
        print_fn("[campaign] rung %s: synthesized %d call graphs (%s)"
                 % (spec.name, len(dirs), stats))
    return dirs


def _ensure_rung(spec: RungSpec, cache_root: str, print_fn=None):
    """The rung's corpus on disk under ``<cache_root>/<name>-seed<seed>``,
    synthesized unless a manifest whose spec fingerprint matches says
    the bytes are there. Returns the directory and whether it was
    cached."""
    if spec.source == "real":
        raise PlanError(f"rung {spec.name!r}: source=real names the reference's "
                        "preprocessed Alibaba shards, which the port does not read; "
                        "use source=synthetic or auto")
    root = _rung_dir(spec, cache_root)
    manifest_path = os.path.join(root, "manifest.json")
    cached = False
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f)
        cached = (old.get("schema") == MANIFEST_SCHEMA
                  and old.get("spec") == _spec_fingerprint(spec))
    if not cached:
        os.makedirs(root, exist_ok=True)
        _synthesize(spec, root, print_fn=print_fn)
    return root, cached


def build_rung(spec: RungSpec, cache_root: str, print_fn=None) -> RungCorpus:
    """Materialize and load one rung (cached under
    ``<cache_root>/<name>-seed<seed>``; ``corpus.cached`` says whether
    the bytes were reused)."""
    root, cached = _ensure_rung(spec, cache_root, print_fn)
    dirs = _call_graph_dirs(root)
    if not dirs:
        raise PlanError(f"rung {spec.name!r}: corpus at {root} holds no "
                        "call_graph_* dirs")
    corpus = _load_rung(spec, "synthetic", root, dirs)
    corpus.cached = cached
    _write_manifest(os.path.join(root, "manifest.json"), corpus.manifest)
    if print_fn:
        mix = corpus.manifest["regime_mix"]
        print_fn("[campaign] rung %s [%s%s]: %d spans / %d traces / "
                 "%d call graphs, %d solvable services, regime mix %s"
                 % (spec.name, "synthetic", " cached" if cached else "",
                    corpus.manifest["spans"], corpus.manifest["traces"],
                    len(dirs), corpus.manifest["services_solvable"], mix))
    return corpus


def _load_rung(spec: RungSpec, source: str, root: str,
               dirs: List[str]) -> RungCorpus:
    """Load every call-graph dir through the ingest path and build the
    solver-ready problems and the manifest."""
    from traceweaver_tpu_torch.ingest import (
        build_service_problem,
        infer_invocation_dag,
        load_corpus,
    )
    from traceweaver_tpu_torch.metrics import get_ground_truth
    from traceweaver_tpu_torch.metrics.accuracy import service_regime

    stores = []
    problems: List[Dict] = []
    spans = traces = services_total = 0
    regime_mix: Dict[str, int] = {}
    per_service: List[Dict] = []
    for si, d in enumerate(dirs):
        store = load_corpus(d, fix=5, max_traces=spec.traces_per_graph + 1,
                            cache=False)
        stores.append(store)
        spans += len(store.all_spans)
        traces += len(store.all_processes)
        services_total += len(store.out_spans_by_process)
        for svc in sorted(store.out_spans_by_process):
            # no deepcopy: the campaign changes no span in place, and a
            # 1M-span rung cannot afford a second span table
            prob = build_service_problem(store, svc, deepcopy=False)
            if prob.skipped:
                continue
            true = get_ground_truth(prob.in_span_partitions,
                                    prob.out_span_partitions)
            dag = infer_invocation_dag(prob.in_span_partitions,
                                       prob.out_span_partitions, true, store)
            regime = service_regime(prob.in_span_partitions,
                                    prob.out_span_partitions)
            regime_mix[regime["regime"]] = regime_mix.get(regime["regime"], 0) + 1
            n_in = len(next(iter(prob.in_span_partitions.values())))
            per_service.append(dict(store=si, svc=svc, n_in=n_in, **regime))
            problems.append(dict(store=si, svc=svc, prob=prob, true=true,
                                 dag=dag, regime=regime))
    manifest = dict(
        schema=MANIFEST_SCHEMA,
        spec=_spec_fingerprint(spec),
        source=source,
        root=os.path.abspath(root),
        spans=spans,
        traces=traces,
        call_graphs=len(dirs),
        services_total=services_total,
        services_solvable=len(problems),
        regime_mix=dict(sorted(regime_mix.items())),
        per_service=per_service,
        # the port's stores are always columnar (the JAX TW_COLUMNAR's
        # default)
        columnar=True,
    )
    return RungCorpus(spec=spec, root=root, manifest=manifest,
                      stores=stores, problems=problems)


def _write_manifest(path: str, manifest: Dict) -> None:
    # a name of this process's own: processes that load one rung at once
    # (the multislice ranks) each publish the same manifest
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=2, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)


def default_cache_root(out_path: Optional[str] = None,
                       cache: Optional[str] = None) -> str:
    """Corpus cache location: ``cache`` (the JAX package's
    ``TW_CAMPAIGN_CACHE``) when given, else ``.campaign_corpus`` next to
    the artifact (or in the working directory)."""
    if cache:
        return cache
    base = os.path.dirname(os.path.abspath(out_path)) if out_path else "."
    return os.path.join(base, ".campaign_corpus")
