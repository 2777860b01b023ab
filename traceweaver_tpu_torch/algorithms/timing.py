"""Per-edge delay-distribution estimation on the host (mirrors
``traceweaver_tpu/algorithms/timing.py``).

- :func:`batch_means_params` — order-statistics batch-means (mean, std);
- :func:`estimate_edge_params` — graph-aware batch means over the DAG;
- :func:`bootstrap_distributions` — nearest-preceding-parent bootstrap;
- :func:`refit_from_assignments` — EM refit, BIC-selected 1..5 component
  GMMs from a completed assignment pass;
- :func:`true_distributions` — the oracle fit of the true-dist ablation.

Distributions are :class:`EdgeDist` Gaussian mixtures padded to
``MAX_COMPONENTS``. ``score_mode="kde"`` (the reference's KDE score
branch) fits each edge as a binned Gaussian KDE
(:meth:`EdgeDist.from_samples_kde`) instead of a GMM. The GMM fit always
takes the batched device fit
(:func:`traceweaver_tpu_torch.ops.gmm.fit_gmm_batched`, the JAX default
``TW_JAX_GMM=1``). The JAX package's sklearn branch of
``EdgeDist.from_samples_gmm`` (``TW_JAX_GMM=0``) is not carried: the
card's machine has no sklearn.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from traceweaver_tpu_torch.dag import DAG
from traceweaver_tpu_torch.runtime.bucketing import pow2_bucket
from traceweaver_tpu_torch.spans import NA, SKIP, Span

MAX_COMPONENTS = 5
MIN_STD = 1e-3

EdgeKey = Tuple[str, str]


@dataclass
class EdgeDist:
    """Gaussian-mixture delay distribution for one call-graph edge."""

    weights: np.ndarray  # [MAX_COMPONENTS]
    means: np.ndarray    # [MAX_COMPONENTS]
    stds: np.ndarray     # [MAX_COMPONENTS]

    @classmethod
    def gaussian(cls, mean: float, std: float) -> "EdgeDist":
        w = np.zeros(MAX_COMPONENTS)
        m = np.zeros(MAX_COMPONENTS)
        s = np.full(MAX_COMPONENTS, 1.0)
        w[0] = 1.0
        m[0] = mean
        s[0] = max(float(std), MIN_STD)
        return cls(w, m, s)

    @classmethod
    def from_samples_kde(cls, samples: Sequence[float],
                         max_components: int = MAX_COMPONENTS) -> "EdgeDist":
        """Gaussian-KDE density as a fixed-shape mixture.

        A Gaussian KDE is an equal-weight mixture of n components at the
        samples with the bandwidth as std, so for n <= K this is exact.
        For n > K the samples are quantile-binned into K components with
        moment-matched stds (sqrt(h^2 + within-bin variance)): a binned
        KDE, fixed-shape for the device. The bandwidth is Scott's rule
        (h = sigma * n^(-1/5)), scipy's default.
        """
        x = np.asarray(samples, dtype=np.float64).ravel()
        if len(x) == 0:
            return cls.gaussian(0.0, MIN_STD)
        n = len(x)
        sigma = float(np.std(x, ddof=1)) if n > 1 else 0.0
        if sigma <= 0:
            return cls.gaussian(float(x[0]), MIN_STD)
        h = sigma * n ** (-1.0 / 5.0)
        K = max_components
        w = np.zeros(MAX_COMPONENTS)
        m = np.zeros(MAX_COMPONENTS)
        s = np.full(MAX_COMPONENTS, 1.0)
        if n <= K:
            w[:n] = 1.0 / n
            m[:n] = x
            s[:n] = max(h, 1.0)
        else:
            edges = np.quantile(x, np.linspace(0, 1, K + 1))
            idx = np.clip(np.searchsorted(edges, x, side="right") - 1, 0, K - 1)
            for k in range(K):
                sel = x[idx == k]
                if len(sel) == 0:
                    continue
                w[k] = len(sel) / n
                m[k] = float(np.mean(sel))
                s[k] = max(math.sqrt(h * h + float(np.var(sel))), 1.0)
        return cls(w, m, s)

    def logpdf(self, x: np.ndarray) -> np.ndarray:
        """Mixture log-density on the host (the solver's is
        ``ops/scores.py``)."""
        x = np.asarray(x, dtype=np.float64)[..., None]
        comp = (
            -0.5 * ((x - self.means) / self.stds) ** 2
            - np.log(self.stds)
            - 0.5 * math.log(2 * math.pi)
        )
        w = np.where(self.weights > 0, self.weights, 0.0)
        logw = np.where(w > 0, np.log(np.maximum(w, 1e-300)), -np.inf)
        return np.asarray(np.logaddexp.reduce(comp + logw, axis=-1))


def dists_from_numpy(dists: Dict) -> Dict[EdgeKey, EdgeDist]:
    """``{edge: dist}`` with numpy ``weights``/``means``/``stds`` (such as
    the JAX package's fitted ``EdgeDist``s) as the port's ``EdgeDist``s."""
    return {
        key: EdgeDist(np.asarray(d.weights, dtype=np.float64),
                      np.asarray(d.means, dtype=np.float64),
                      np.asarray(d.stds, dtype=np.float64))
        for key, d in dists.items()
    }


def fit_value_dists(values_by_edge: Dict[EdgeKey, List[float]],
                    score_mode: str = "mixture",
                    mixture_fit: str = "gaussian",
                    device="cuda") -> Dict[EdgeKey, EdgeDist]:
    """Per-edge samples -> :class:`EdgeDist`: binned-KDE mixtures when
    ``score_mode == "kde"``; otherwise single Gaussians, or
    (``mixture_fit == "gmm"``) batched BIC-GMMs on ``device``."""
    if score_mode == "kde":
        return {k: EdgeDist.from_samples_kde(v)
                for k, v in values_by_edge.items()}
    if mixture_fit == "gmm":
        return fit_edge_gmms(values_by_edge, device=device)
    return {
        k: EdgeDist.gaussian(float(np.mean(v)), float(np.std(v)))
        for k, v in values_by_edge.items()
    }


def batch_means_params(t1: Sequence[float], t2: Sequence[float],
                       nbatches: int = 10) -> Tuple[float, float]:
    """(mean, std) of the elementwise delay between two sorted time
    vectors; the std comes from the spread of batch means."""
    t1 = list(t1)
    t2 = list(t2)
    assert len(t1) == len(t2) and len(t1) > 0
    mean = (sum(t2) - sum(t1)) / len(t1)
    batch_size = math.ceil(float(len(t1)) / nbatches)
    batch_means = []
    for i in range(nbatches):
        lo, hi = i * batch_size, min(len(t1), (i + 1) * batch_size)
        if hi - lo > 0:
            batch_means.append((sum(t2[lo:hi]) - sum(t1[lo:hi])) / (hi - lo))
    if len(batch_means) >= 2:
        import scipy.stats

        std = math.sqrt(batch_size) * float(scipy.stats.tstd(batch_means))
        if math.isnan(std):
            std = MIN_STD
    else:
        std = MIN_STD
    return mean, std


def has_longer_path(dag: DAG, src: str, dst: str) -> bool:
    """True if ``src`` reaches ``dst`` by a path of more than one edge."""
    for path in dag.all_simple_paths(src, dst, cutoff=2):
        if len(path) - 1 > 1:
            return True
    return False


def primary_pred_edges(dag: DAG, out_ep: str) -> List[str]:
    """Direct predecessors of ``out_ep`` whose edge is not a shortcut."""
    return [
        p for p, _ in dag.in_edges(out_ep) if not has_longer_path(dag, p, out_ep)
    ]


def estimate_edge_params(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    dag: DAG,
    lo: int,
    hi: int,
) -> Dict[EdgeKey, EdgeDist]:
    """Graph-aware batch means over span index window [lo, hi): (in, e)
    for root endpoints, (p, e) for primary DAG edges, (e, in) for all."""
    in_ep = next(iter(in_span_partitions))
    dists: Dict[EdgeKey, EdgeDist] = {}

    def est(ep1: str, ep2: str, t1: List[float], t2: List[float]) -> None:
        mean, std = batch_means_params(sorted(t1)[lo:hi], sorted(t2)[lo:hi])
        dists[(ep1, ep2)] = EdgeDist.gaussian(mean, std)

    in_starts = [s.start_mus for s in in_span_partitions[in_ep]]
    in_ends = [s.start_mus + s.duration_mus for s in in_span_partitions[in_ep]]

    for out_ep, out_spans in out_span_partitions.items():
        starts = [s.start_mus for s in out_spans]
        ends = [s.start_mus + s.duration_mus for s in out_spans]
        preds = primary_pred_edges(dag, out_ep)
        if len(dag.in_edges(out_ep)) == 0:
            est(in_ep, out_ep, in_starts, starts)
        for p in preds:
            if p == in_ep:
                est(p, out_ep, in_starts, starts)
            else:
                p_ends = [s.start_mus + s.duration_mus for s in out_span_partitions[p]]
                est(p, out_ep, p_ends, starts)
        est(out_ep, in_ep, ends, in_ends)
    return dists


def bootstrap_distributions(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    out_eps: List[str],
    score_mode: str = "mixture",
) -> Dict[EdgeKey, EdgeDist]:
    """Unsupervised bootstrap: each span is attributed to its nearest
    plausible preceding parent in the merged time-sorted stream; each
    edge's delays fit a Gaussian, or a binned KDE when ``score_mode ==
    "kde"``."""
    in_ep = next(iter(in_span_partitions))
    tagged: List[Tuple[Span, str]] = []
    for span in in_span_partitions[in_ep]:
        tagged.append((span, in_ep))
    for out_ep in out_eps:
        for span in out_span_partitions[out_ep]:
            tagged.append((span, out_ep))
    tagged.sort(key=lambda t: t[0].start_mus)
    large_delay = max(s.duration_mus for s in in_span_partitions[in_ep])
    order = {ep: i for i, ep in enumerate(out_eps)}

    values: Dict[EdgeKey, List[float]] = {}

    for i, (span, ep) in enumerate(tagged):
        if span.span_kind == "client":
            sent = span.start_mus
            dur = span.duration_mus
            parent: Optional[Tuple[Span, str, str]] = None
            for j in range(i - 1, -1, -1):
                pspan, pep = tagged[j]
                if (sent + dur) - pspan.start_mus > large_delay:
                    break
                if pspan.span_kind == "server":
                    parent = (pspan, pep, "server")
                    break
                if (pspan.span_kind == "client"
                        and pspan.start_mus + pspan.duration_mus < span.start_mus
                        and order.get(pep, 1 << 30) < order.get(ep, 1 << 30)):
                    parent = (pspan, pep, "client")
                    break
            if parent is not None:
                pspan, pep, kind = parent
                delay = (sent - pspan.start_mus if kind == "server"
                         else sent - (pspan.start_mus + pspan.duration_mus))
                values.setdefault((pep, ep), []).append(delay)
        elif span.span_kind == "server":
            sent = span.start_mus
            dur = span.duration_mus
            parent = None
            for j in range(i - 1, -1, -1):
                pspan, pep = tagged[j]
                if (sent + dur) - pspan.start_mus > large_delay:
                    break
                if (pspan.span_kind == "client"
                        and pspan.start_mus + pspan.duration_mus < sent + dur):
                    parent = (pspan, pep, "client")
                    break
            if parent is not None:
                pspan, pep, _ = parent
                values.setdefault((pep, ep), []).append(
                    (sent + dur) - (pspan.start_mus + pspan.duration_mus)
                )
            values.setdefault((ep, ep), []).append(dur)

    return fit_value_dists(values, score_mode)


def refit_from_assignments(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    dag: Optional[DAG],
    assignments: Dict[str, Dict],
    all_spans: Dict,
    device="cuda",
    score_mode: str = "mixture",
) -> Dict[EdgeKey, EdgeDist]:
    """EM refit: per-edge delay samples from a completed assignment pass,
    fit as BIC-selected GMMs on ``device``, or as binned-KDE mixtures on
    the host when ``score_mode == "kde"``."""
    if dag is None:
        dag = DAG.from_edges(out_span_partitions.keys(), ())
    in_ep = next(iter(in_span_partitions))
    by_id = {
        ep: {s.GetId(): s for s in spans}
        for ep, spans in out_span_partitions.items()
    }

    def span_of(assign_map, in_span, ep):
        sid = assign_map.get(in_span.GetId())
        if sid is None or tuple(sid) in (NA, SKIP):
            return None
        sid = tuple(sid)
        return by_id[ep].get(sid) or all_spans.get(sid)

    samples_by_edge: Dict[EdgeKey, List[float]] = {}
    for out_ep in out_span_partitions:
        preds = primary_pred_edges(dag, out_ep)
        if len(dag.in_edges(out_ep)) == 0 or in_ep in preds:
            samples = []
            for in_span in in_span_partitions[in_ep]:
                out = span_of(assignments[out_ep], in_span, out_ep)
                if out is not None:
                    samples.append(out.start_mus - in_span.start_mus)
            samples_by_edge[(in_ep, out_ep)] = samples
        for p in preds:
            if p == in_ep:
                continue
            samples = []
            for in_span in in_span_partitions[in_ep]:
                p_out = span_of(assignments[p], in_span, p)
                out = span_of(assignments[out_ep], in_span, out_ep)
                if p_out is not None and out is not None:
                    samples.append(
                        out.start_mus - (p_out.start_mus + p_out.duration_mus)
                    )
            samples_by_edge[(p, out_ep)] = samples
        samples = []
        for in_span in in_span_partitions[in_ep]:
            out = span_of(assignments[out_ep], in_span, out_ep)
            if out is not None:
                samples.append(
                    (in_span.start_mus + in_span.duration_mus)
                    - (out.start_mus + out.duration_mus)
                )
        samples_by_edge[(out_ep, in_ep)] = samples
    return fit_value_dists(samples_by_edge, score_mode, mixture_fit="gmm",
                           device=device)


def fit_edge_gmms(samples_by_edge: Dict[EdgeKey, List[float]],
                  device="cuda") -> Dict[EdgeKey, EdgeDist]:
    """Every edge's delay GMM in one batched fit on ``device``; empty,
    constant or < 4-sample edges take the closed-form single Gaussian."""
    from traceweaver_tpu_torch.ops.gmm import fit_gmm_batched

    dists: Dict[EdgeKey, EdgeDist] = {}
    fit_keys: List[EdgeKey] = []
    fit_samples: List[np.ndarray] = []
    for key, v in samples_by_edge.items():
        arr = np.asarray(v, dtype=np.float64)
        if len(arr) == 0:
            dists[key] = EdgeDist.gaussian(0.0, MIN_STD)
        elif len(arr) < 4 or len(np.unique(arr)) == 1:
            dists[key] = EdgeDist.gaussian(float(np.mean(arr)),
                                           float(np.std(arr)))
        else:
            fit_keys.append(key)
            fit_samples.append(arr)
    if fit_keys:
        n_pad = pow2_bucket(max(len(a) for a in fit_samples))
        e_pad = pow2_bucket(len(fit_keys))
        x = np.zeros((e_pad, n_pad), dtype=np.float64)
        mask = np.zeros((e_pad, n_pad), dtype=bool)
        for i, a in enumerate(fit_samples):
            x[i, :len(a)] = a
            mask[i, :len(a)] = True
        w, mu, sd = fit_gmm_batched(x, mask, max_k=MAX_COMPONENTS,
                                    device=device)
        for i, key in enumerate(fit_keys):
            dists[key] = EdgeDist(w[i], mu[i], sd[i])
    return dists


def true_distributions(
    in_span_partitions: Dict[str, List[Span]],
    out_span_partitions: Dict[str, List[Span]],
    out_eps: List[str],
    true_assignments: Dict[str, Dict],
    score_mode: str = "mixture",
) -> Dict[EdgeKey, EdgeDist]:
    """Oracle distributions from ground truth (the true-dist ablation)."""
    in_ep = next(iter(in_span_partitions))
    by_id = {
        ep: {s.GetId(): s for s in spans}
        for ep, spans in out_span_partitions.items()
    }
    values: Dict[EdgeKey, List[float]] = {}
    for in_span in in_span_partitions[in_ep]:
        prev_span: Optional[Span] = None
        prev_ep: Optional[str] = None
        for out_ep in out_eps:
            sid = true_assignments[out_ep].get(in_span.GetId())
            if sid is None or tuple(sid) == SKIP:
                continue
            out = by_id[out_ep].get(tuple(sid))
            if out is None:
                continue
            if prev_span is None:
                values.setdefault((in_ep, out_ep), []).append(
                    out.start_mus - in_span.start_mus
                )
            else:
                values.setdefault((prev_ep, out_ep), []).append(
                    out.start_mus - (prev_span.start_mus + prev_span.duration_mus)
                )
            prev_span, prev_ep = out, out_ep
        if prev_span is not None:
            values.setdefault((prev_ep, in_ep), []).append(
                (in_span.start_mus + in_span.duration_mus)
                - (prev_span.start_mus + prev_span.duration_mus)
            )
    return fit_value_dists(values, score_mode)
