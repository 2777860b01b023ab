"""WAP5 statistical baseline (SOSP'05 lineage) (mirrors
``traceweaver_tpu/algorithms/wap5.py``).

Per-endpoint delay distributions are learnt from the nearest preceding
server span; each client span then picks its most likely parent by an
exponential log-pdf, with a ``magic_delay × mean`` spontaneous cutoff, each
parent used at most once. Output is parent→children oriented and padded with
("NA","NA") (reference: src/trace_reconstructor/ports/python/algorithms/
wap5.py:271-351).
"""

from __future__ import annotations

import statistics

import scipy.stats

from traceweaver_tpu_torch.spans import NA


class WAP5:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes
        self.distribution_values = {}
        self.large_delay = None
        self.magic_delay = 4
        self.all_assignments = {}
        self._already_picked = {}

    # -- distribution learning (wap5.py:271-288) --------------------------
    def _build_distributions(self, incoming_spans, outgoing_spans, out_ep):
        spans = sorted(incoming_spans + outgoing_spans, key=lambda s: s.start_mus)
        for i, span in enumerate(spans):
            if span.span_kind != "client":
                continue
            sent_mus = span.start_mus
            parent = None
            for preceding in reversed(spans[:i]):
                if sent_mus - preceding.start_mus > self.large_delay:
                    break
                if preceding.span_kind == "server":
                    parent = preceding
                    break
            if parent is not None:
                self.distribution_values.setdefault(out_ep, []).append(
                    sent_mus - parent.start_mus
                )

    @staticmethod
    def _logpdf(t, mean):
        return scipy.stats.expon.logpdf(t, scale=mean)

    # -- parent scoring (wap5.py:295-327) ---------------------------------
    def _score_parents(self, incoming_spans, outgoing_spans, out_ep):
        spans = sorted(incoming_spans + outgoing_spans, key=lambda s: s.start_mus)
        for span in spans:
            self._already_picked[span.GetId()] = False

        mean = statistics.mean(self.distribution_values[out_ep])
        for i, span in enumerate(spans):
            if span.span_kind != "client":
                continue
            sent_mus = span.start_mus
            candidates = []
            for preceding in reversed(spans[:i]):
                if sent_mus - preceding.start_mus > self.magic_delay * mean:
                    candidates.append(
                        ("Spontaneous", self._logpdf(self.magic_delay * mean, mean))
                    )
                    break
                if preceding.span_kind == "server" and not self._already_picked[preceding.GetId()]:
                    candidates.append(
                        (preceding, self._logpdf(sent_mus - preceding.start_mus, mean))
                    )
                    self._already_picked[preceding.GetId()] = True
            candidates.sort(key=lambda x: x[1])
            if candidates and candidates[-1][0] != "Spontaneous":
                parent = candidates[-1][0]
                self.all_assignments.setdefault(out_ep, {}).setdefault(
                    parent.GetId(), []
                ).append(span.GetId())

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments):
        incoming = [s for part in in_span_partitions.values() for s in part]
        self.large_delay = max(s.duration_mus for s in incoming)

        for out_ep, out_spans in out_span_partitions.items():
            self._build_distributions(incoming, out_spans, out_ep)
            self._score_parents(incoming, out_spans, out_ep)

        for out_ep in out_span_partitions:
            self.all_assignments.setdefault(out_ep, {})
            for in_span in incoming:
                if in_span.GetId() not in self.all_assignments[out_ep]:
                    self.all_assignments[out_ep][in_span.GetId()] = [NA]
        return self.all_assignments
