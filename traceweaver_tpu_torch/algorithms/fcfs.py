"""First-come-first-serve baseline (mirrors
``traceweaver_tpu/algorithms/fcfs.py``).

The i-th incoming span maps to the i-th outgoing span at every endpoint
(reference: src/trace_reconstructor/ports/python/algorithms/fcfs.py:1-26).
"""

from __future__ import annotations

from traceweaver_tpu_torch.spans import NA


class FCFS:
    def __init__(self, all_spans, all_processes):
        self.all_spans = all_spans
        self.all_processes = all_processes
        self.instrumented_hops = []
        self.true_assignments = None

    def FindAssignments(self, method, process, in_span_partitions,
                        out_span_partitions, parallel, instrumented_hops,
                        true_assignments):
        assert len(in_span_partitions) == 1
        self.instrumented_hops = instrumented_hops
        self.true_assignments = true_assignments
        _, in_spans = next(iter(in_span_partitions.items()))
        all_assignments = {ep: {} for ep in out_span_partitions}
        for ind, in_span in enumerate(in_spans):
            for j, (ep, out_spans) in enumerate(out_span_partitions.items()):
                if ind >= len(out_spans):
                    all_assignments[ep][in_span.GetId()] = NA
                elif (j + 1) in instrumented_hops:
                    all_assignments[ep][in_span.GetId()] = true_assignments[ep][in_span.GetId()]
                else:
                    all_assignments[ep][in_span.GetId()] = out_spans[ind].GetId()
        return all_assignments
