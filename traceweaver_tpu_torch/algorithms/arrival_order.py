"""Arrival-order baseline (mirrors
``traceweaver_tpu/algorithms/arrival_order.py``).

FCFS for the first endpoint; each subsequent endpoint's spans are matched in
the completion order of the previous endpoint's spans (reference:
src/trace_reconstructor/ports/python/algorithms/arrival_order.py:4-65).
"""

from __future__ import annotations

import numpy as np

from traceweaver_tpu_torch.spans import NA
from traceweaver_tpu_torch.metrics.accuracy import get_out_eps_in_order


class ArrivalOrder:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments):
        assert len(in_span_partitions) == 1
        all_assignments = {ep: {} for ep in out_span_partitions}
        in_eps = list(in_span_partitions.keys())
        out_eps = get_out_eps_in_order(out_span_partitions)
        in_spans = in_span_partitions[in_eps[0]]

        out_spans = None
        for i in range(1, len(out_span_partitions) + 1):
            if i == 1:
                out_spans = out_span_partitions[out_eps[0]]
                ep_key = out_eps[0]
            else:
                prev = out_spans
                target = out_span_partitions[out_eps[i - 1]]
                order = list(np.argsort([s.start_mus + s.duration_mus for s in prev]))
                if len(prev) <= len(target):
                    order = order[: len(target)]
                    order.extend(range(len(prev), len(target)))
                else:
                    order = [x for x in order if x < len(target)]
                out_spans = [target[j] for j in order]
                ep_key = out_eps[i - 1]

            for ind, in_span in enumerate(in_spans):
                if ind >= len(out_spans):
                    all_assignments[ep_key][in_span.GetId()] = NA
                else:
                    all_assignments[ep_key][in_span.GetId()] = out_spans[ind].GetId()
        return all_assignments
